"""setup_s: seconds from the process's start to the window's first instant
(the import, CUDA, the kernel library, the state from the seed, the cell's
shapes warmed)."""


def read(run):
    return run["setup_s"]
