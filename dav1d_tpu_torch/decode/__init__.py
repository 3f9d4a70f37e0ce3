"""Frame-level decode of the port (pass 1, pass 2 + filter chain)."""
