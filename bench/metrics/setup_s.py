"""setup_s: process start to the first timed request (imports, CUDA
start, the program's set-up and warm-up, and a build where one runs)."""


def read(info):
    return info.setup_s
