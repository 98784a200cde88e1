"""Analog program compiler, the ``synthesize``/``program`` subset of the JAX
package's ``repro.compile`` (paper Sec. IV-B, Fig. 11):

    prog = synthesize([w1, w2, ...])       # SVD factorization (Eq. 31)
    prog = program(prog, method="reck")    # or the kernel-backed "fit"
    err = program_error(prog)              # realized vs target, on B1

``quantize``, ``calibrate``, the ``lower*`` passes and the tiled programs
are not ported yet.
"""

from repro_torch.compile.passes import inv_softplus, logit, program, synthesize
from repro_torch.compile.program import (
    AnalogProgram,
    ProgramLayer,
    layer_matrix,
    program_error,
)

__all__ = ["AnalogProgram", "ProgramLayer", "inv_softplus", "layer_matrix",
           "logit", "program", "program_error", "synthesize"]
