"""setup_s (host clock): process start to the first due request: weights
made from the seed, the kernels built or loaded, the warm-up of the
cell's own shapes."""


def read(run):
    return run.setup_s
