"""sparse_speedup: a dense pass (``batched_gemm`` on the same dense A,
cuBLAS) timed in the same run, over this cell's pass."""


def read(run):
    if not run.dense_pass_ms or not run.pass_ms > 0:
        return None
    return run.dense_pass_ms / run.pass_ms
