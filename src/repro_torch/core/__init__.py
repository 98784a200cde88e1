"""Core library: the paper's RF analog processor as PyTorch modules."""

from repro_torch.core.cell import (
    TABLE_I_PHASES_DEG,
    TABLE_I_PHASES_RAD,
    cell_matrix,
    output_powers,
    output_voltages,
    s_parameters,
)
from repro_torch.core.mesh import (
    MeshPlan,
    apply_mesh,
    clements_plan,
    init_mesh_params,
    mesh_matrix,
    pack_cells_to_columns,
)
from repro_torch.core.quantize import (
    ste_quantize,
    table_i_codebook,
    uniform_codebook,
)
from repro_torch.core.hardware import (
    IDEAL,
    HardwareModel,
    apply_mesh_hw,
    detect_magnitude,
)
from repro_torch.core.analog_linear import AnalogLinear, AnalogUnitary
from repro_torch.core.decompose import (
    fit_program,
    random_unitary,
    reck_program,
    reconstruction_error,
)
from repro_torch.core.svd_synthesis import (
    SynthesizedMatrix,
    synthesis_error,
    synthesize,
)

__all__ = [
    "TABLE_I_PHASES_DEG", "TABLE_I_PHASES_RAD", "cell_matrix", "output_powers",
    "output_voltages", "s_parameters", "MeshPlan", "apply_mesh",
    "clements_plan", "init_mesh_params", "mesh_matrix", "pack_cells_to_columns",
    "ste_quantize", "table_i_codebook", "uniform_codebook",
    "IDEAL", "HardwareModel", "apply_mesh_hw", "detect_magnitude",
    "AnalogLinear", "AnalogUnitary", "fit_program", "random_unitary",
    "reck_program", "reconstruction_error", "SynthesizedMatrix",
    "synthesis_error", "synthesize",
]
