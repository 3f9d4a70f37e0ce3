"""Reconstruction stages of the port that run on the device."""
