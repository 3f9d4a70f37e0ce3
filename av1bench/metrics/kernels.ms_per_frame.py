"""Device ms of the program's kernels from the window's start on (the
profiler's intervals, by kernel name) over the frames decoded."""


def read(rec):
    k = rec["device"]["kernel_s"]
    if not k or not rec["frames_decoded"]:
        return None
    return sum(k.values()) * 1e3 / rec["frames_decoded"]
