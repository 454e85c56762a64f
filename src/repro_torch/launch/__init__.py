"""Entry points of the port: the serving drive (batch and open-loop)
and the preemptible GEMM."""
