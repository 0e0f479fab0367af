"""Set-up seconds: from the harness's start to the window's, the inputs
made, the program built and warmed up, kernels built where none were."""


def read(run):
    return run.setup_s
