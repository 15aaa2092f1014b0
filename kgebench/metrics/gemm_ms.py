"""The device time a step of the kernels whose names mark a cuBLAS product
(gemm, gemv, xmma): the scores' einsums and their gradients."""

from kgebench.trace import total_us

MARKS = ("gemm", "gemv", "xmma", "Gemm", "GEMM", "Gemv")


def read(rec):
    if rec.trace is None:
        return None
    ops = rec.trace.by_name(*MARKS)
    return total_us(ops) / rec.trace.steps / 1e3 if ops else None
