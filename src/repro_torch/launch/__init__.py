"""Entry points of the port: the batch serving drive and the preemptible GEMM."""
