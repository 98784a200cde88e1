"""Set-up seconds: from the process's start to the window's start (the
CUDA context, the kernels' build cache, the inputs and weights from the
seed, the program's own set-up and the warm-up of the cell's shapes)."""


def read(records):
    return records.get("setup_s")
