"""The measured prototype emulation (paper Sec. III).

The unit cell is emulated with the hardware model calibrated to the
prototype's reported behaviour: Fig. 6 shows measured peak |S| a bit over a
dB below the ideal 1/sqrt(2) (-3 dB) "due to the loss and phase deviation
coming from the imperfect circuit fabrication".  We use ~1 dB in-circuit
insertion loss per cell, 5% hybrid imbalance and ~2 deg phase error, which
lands the simulated peak |S21| within the measured band.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.hardware import HardwareModel

#: hardware model calibrated to the measured prototype
PROTOTYPE = HardwareModel(
    hybrid_imbalance=0.05,
    hybrid_phase_err=np.deg2rad(2.0),
    cell_loss_db=1.0,
    phase_sigma=np.deg2rad(1.5),
    detector_floor_dbm=-60.0,
    detector_sigma=0.01,
)

#: ideal-physics model (theory curves)
IDEAL_CELL = HardwareModel(
    hybrid_imbalance=0.0, hybrid_phase_err=0.0, cell_loss_db=0.0,
    phase_sigma=0.0, detector_floor_dbm=-300.0, detector_sigma=0.0)
