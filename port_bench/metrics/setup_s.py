"""setup_s: seconds from the process's start to the end of the warm
request: imports, the CUDA context, the build, the start state, one
request."""


def read(run, trace):
    return run["setup_s"]
