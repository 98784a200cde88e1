"""Plain reference of a compiled multi-layer tiled analog processor (the
paper's Sec. V scale-up, Eq. 31 per tile, the PROTOTYPE hardware model).

From the same seeded targets, keys and placements as the program it works
out again, in float64: each tile's SVD (Eq. 31), the analytic nulling
factorization of both unitaries into cells of the paper's Eq. 5 with an
input phase screen (Eqs. 27-30), the cells' packing into mesh columns (a
cell's fabrication draw belongs to its column slot), every physical
position's frozen phase-noise draws, the imperfect cells (lossy,
imbalanced hybrids), the yield scores of the physical positions and the
placement they give, and then each layer's realized logical matrix.  A
layer maps its input to the detected magnitudes ``|M x|``.

Imports nothing of the program: only NumPy and PyTorch (a CPU
``torch.Generator`` regenerates the standard normals that define a
position's fabrication noise).
"""

from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# inputs drawn from the seed (shared with the program)
# ---------------------------------------------------------------------------

def _rng(seed: int, purpose: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(seed,
                                                        spawn_key=(purpose,)))


def make_inputs(cfg: dict, seed: int) -> dict:
    """The targets, per-layer keys and seeded placements of one run."""
    depth, width, tile = cfg["layers"], cfg["width"], cfg["tile"]
    grid = width // tile
    rng = _rng(seed, 0)
    targets = []
    for l in range(depth):
        w = rng.normal(size=(width, width)) * cfg["target_scale"]
        if cfg["weak_last_tile_row"][l]:
            w[width - tile:] *= 1e-3
        targets.append(w)
    keys = [int(k) for k in _rng(seed, 1).integers(0, 2**62, size=depth)]
    prng = _rng(seed, 2)
    perms = [(tuple(int(v) for v in prng.permutation(grid)),
              tuple(int(v) for v in prng.permutation(grid)))
             for _ in range(depth)]
    return {"targets": targets, "keys": keys, "perms": perms}


def hardware(cfg: dict) -> dict:
    """The hardware model's numbers, angles in radians."""
    hw = cfg["hardware"]
    return {"hybrid_imbalance": hw["hybrid_imbalance"],
            "hybrid_phase_err": np.deg2rad(hw["hybrid_phase_err_deg"]),
            "cell_loss_db": hw["cell_loss_db"],
            "phase_sigma": np.deg2rad(hw["phase_sigma_deg"]),
            "detector_floor_dbm": hw["detector_floor_dbm"],
            "detector_sigma": hw["detector_sigma"]}


# ---------------------------------------------------------------------------
# cells and meshes
# ---------------------------------------------------------------------------

def ideal_cell(theta, phi) -> np.ndarray:
    """Eq. 5: j e^{-j th/2} [[e^{-j ph} sin, e^{-j ph} cos], [cos, -sin]]
    of half the angle; broadcasts, trailing (2, 2)."""
    theta, phi = np.broadcast_arrays(np.asarray(theta, np.float64),
                                     np.asarray(phi, np.float64))
    s, c = np.sin(0.5 * theta), np.cos(0.5 * theta)
    g = 1j * np.exp(-0.5j * theta)
    e = np.exp(-1j * phi)
    return g[..., None, None] * np.stack(
        [np.stack([e * s, e * c], -1), np.stack([c, -s], -1)], -2)


def imperfect_cell(theta, phi, hw: dict) -> np.ndarray:
    """Phi . H . Theta . H with the hardware model's lossy, imbalanced
    hybrid H (renormalized passive) and per-cell insertion loss."""
    e, perr = hw["hybrid_imbalance"], hw["hybrid_phase_err"]
    thru = (1.0 + e) * np.exp(1j * perr) * 1j
    coup = 1.0 - e
    m = np.array([[thru, coup], [coup, thru]])
    h = -m / np.sqrt(np.abs(thru) ** 2 + coup ** 2)
    gain = 10.0 ** (-hw["cell_loss_db"] / 20.0)

    def shifter(a):
        out = np.zeros(a.shape + (2, 2), np.complex128)
        out[..., 0, 0] = np.exp(-1j * a)
        out[..., 1, 1] = 1.0
        return out

    t = shifter(np.asarray(phi, np.float64)) @ h
    t = t @ shifter(np.asarray(theta, np.float64)) @ h
    return gain * t


def null_unitary(u: np.ndarray, atol: float = 1e-8):
    """Adjacent-pair nulling ``t^H_K ... t^H_1 U = D``.  Returns the cells
    ``(p, theta, phi)`` in physical order (the reverse of nulling order)
    and the input screen's phases ``alpha_in`` (``e^{-j alpha} = d``)."""
    v = np.array(u, np.complex128)
    n = v.shape[0]
    nulled = []
    for col in range(n - 1):
        for q in range(n - 1, col, -1):
            p = q - 1
            vp, vq = v[p, col], v[q, col]
            if abs(vq) < atol and abs(vp) < atol:
                continue
            theta = 2.0 * np.arctan2(abs(vp), abs(vq))
            phi = (float(np.angle(vq) - np.angle(vp))
                   if abs(vp) > atol and abs(vq) > atol else 0.0)
            th = ideal_cell(theta, phi).conj().T
            v[[p, q], :] = th @ v[[p, q], :]
            nulled.append((p, theta, phi))
    d = np.diag(v)
    return list(reversed(nulled)), -np.angle(d)


def pack_columns(n: int, cells, n_columns: int):
    """Greedy schedule of the ordered cells into columns (a cell takes the
    first column where both its channels are free), each column's cells
    sorted by channel into slots.  Returns the slot arrays ``top``,
    ``active``, ``theta``, ``phi`` of shape ``[n_columns, n // 2]``."""
    free = np.zeros(n, np.int64)
    placed: list = [[]]
    for p, th, ph in cells:
        col = int(max(free[p], free[p + 1]))
        while len(placed) <= col:
            placed.append([])
        placed[col].append((p, th, ph))
        free[p] = free[p + 1] = col + 1
    if len(placed) > n_columns:
        raise ValueError(f"{len(placed)} columns > {n_columns}")
    shape = (n_columns, n // 2)
    top, active = np.zeros(shape, np.int64), np.zeros(shape, bool)
    theta, phi = np.zeros(shape), np.zeros(shape)
    for c, cc in enumerate(placed):
        for k, (p, th, ph) in enumerate(sorted(cc)):
            top[c, k], active[c, k], theta[c, k], phi[c, k] = p, True, th, ph
    return top, active, theta, phi


def clements_slots(n: int):
    """The rectangular layout's slots: n columns alternating offsets."""
    top = np.zeros((n, n // 2), np.int64)
    active = np.zeros((n, n // 2), bool)
    for c in range(n):
        starts = np.arange(c % 2, n - 1, 2)
        top[c, :len(starts)] = starts
        active[c, :len(starts)] = True
    return top, active


def mesh_matrix(top, active, cells: np.ndarray, alpha_in=None) -> np.ndarray:
    """The n x n matrix of a mesh: the input screen, then every column's
    cells ``cells[c, k]`` (2x2) on channels ``(top, top + 1)`` of its
    active slots."""
    n = 2 * top.shape[1]
    m = np.eye(n, dtype=np.complex128)
    if alpha_in is not None:
        m = np.diag(np.exp(-1j * np.asarray(alpha_in, np.float64))) @ m
    for c in range(top.shape[0]):
        for k in range(top.shape[1]):
            if active[c, k]:
                p = top[c, k]
                m[[p, p + 1], :] = cells[c, k] @ m[[p, p + 1], :]
    return m


def frozen_normals(key: int, shapes, position: int, layer: int = 0):
    """The standard normals that define one physical position's phase
    noise: one CPU generator seeded from ``(key, position, layer)``, drawn
    in order theta, phi of each mesh."""
    seed = np.random.SeedSequence(int(key), spawn_key=(position, layer)) \
        .generate_state(1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(seed))
    return [torch.randn(s, generator=gen, dtype=torch.float32)
            .double().numpy() for s in shapes]


# ---------------------------------------------------------------------------
# the compiled cascade
# ---------------------------------------------------------------------------

def program_tile(block: np.ndarray) -> dict:
    """One tile: SVD (Eq. 31), both unitaries nulled and packed."""
    n = block.shape[0]
    u, s, vh = np.linalg.svd(block.astype(np.complex128))
    smax = float(s.max()) if s.max() > 0 else 1.0
    cols = max(1, 2 * n - 3)
    meshes = []
    for unitary in (vh, u):
        cells, alpha_in = null_unitary(unitary)
        meshes.append((*pack_columns(n, cells, cols), alpha_in))
    return {"v": meshes[0], "u": meshes[1], "atten": s / smax,
            "scale": smax, "mass": smax * float(np.sum(s / smax))}


def tile_matrix(t: dict, hw: dict, normals) -> np.ndarray:
    """The realized ``scale * U diag(atten) V`` of a tile under the
    hardware model and its position's normals (V theta, V phi, U theta,
    U phi)."""
    mats = []
    for (top, active, theta, phi, alpha_in), (zt, zp) in zip(
            (t["v"], t["u"]), (normals[:2], normals[2:])):
        cells = imperfect_cell(theta + hw["phase_sigma"] * zt,
                               phi + hw["phase_sigma"] * zp, hw)
        mats.append(mesh_matrix(top, active, cells, alpha_in))
    return t["scale"] * mats[1] @ np.diag(t["atten"]) @ mats[0]


def yield_scores(grid: int, tile: int, hw: dict, key: int) -> np.ndarray:
    """Each physical position's score: the relative L2 error of the
    detected output of a fixed probe tile (two Clements meshes, phases from
    a CPU generator seeded 0) under the position's draws against the ideal
    device, after the best digital gain; negated."""
    top, active = clements_slots(tile)
    gen = torch.Generator().manual_seed(0)
    probe = []
    for _ in range(2):
        th = torch.rand(top.shape, generator=gen, dtype=torch.float32)
        ph = torch.rand(top.shape, generator=gen, dtype=torch.float32)
        probe.append(((th * np.pi).double().numpy(),
                      (ph * 2 * np.pi).double().numpy()))

    def chain(cell_fn):
        m = np.eye(tile, dtype=np.complex128)
        for z, (th, ph) in zip((0, 2), probe):
            m = mesh_matrix(top, active, cell_fn(z, th, ph)) @ m
        return np.abs(m)

    ideal = chain(lambda z, th, ph: ideal_cell(th, ph))
    scores = np.zeros((grid, grid))
    for o in range(grid):
        for i in range(grid):
            zz = frozen_normals(key, [top.shape] * 4, o * grid + i)
            mag = chain(lambda z, th, ph: imperfect_cell(
                th + hw["phase_sigma"] * zz[z],
                ph + hw["phase_sigma"] * zz[z + 1], hw))
            gamma = (mag * ideal).sum() / max((mag * mag).sum(), 1e-12)
            err = (np.linalg.norm(gamma * mag - ideal)
                   / max(np.linalg.norm(ideal), 1e-12))
            scores[o, i] = -err
    return scores


def match_placement(sens: np.ndarray, scores: np.ndarray):
    """The most sensitive logical row on the best physical row, likewise
    for columns (stable order among equals): ``(row_perm, col_perm)`` with
    physical ``p`` hosting logical ``perm[p]``."""
    def match(sm, sc):
        phys = np.argsort(-sc, kind="stable")
        logi = np.argsort(-sm, kind="stable")
        perm = np.empty(len(phys), np.int64)
        perm[phys] = logi
        return tuple(int(v) for v in perm)

    return match(sens.sum(1), scores.sum(1)), match(sens.sum(0),
                                                     scores.sum(0))


def layer_matrices(cfg: dict, inputs: dict) -> list:
    """Each layer's realized logical ``[width, width]`` complex matrix."""
    hw = hardware(cfg)
    tile, width = cfg["tile"], cfg["width"]
    grid = width // tile
    mats = []
    for l, (w, key, perm) in enumerate(zip(inputs["targets"], inputs["keys"],
                                           inputs["perms"])):
        tiles = [[program_tile(w[o * tile:(o + 1) * tile,
                                 i * tile:(i + 1) * tile])
                  for i in range(grid)] for o in range(grid)]
        kind = cfg["placement"][l]
        if kind == "yield":
            sens = np.array([[t["mass"] for t in row] for row in tiles])
            rows, cols = match_placement(sens, yield_scores(grid, tile, hw,
                                                            key))
        elif kind == "seeded":
            rows, cols = perm
        else:
            rows, cols = tuple(range(grid)), tuple(range(grid))
        inv_r = {r: p for p, r in enumerate(rows)}
        inv_c = {c: p for p, c in enumerate(cols)}
        shapes = [tiles[0][0]["v"][2].shape] * 4
        m = np.zeros((width, width), np.complex128)
        for o in range(grid):
            for i in range(grid):
                pos = inv_r[o] * grid + inv_c[i]
                m[o * tile:(o + 1) * tile, i * tile:(i + 1) * tile] = \
                    tile_matrix(tiles[o][i], hw,
                                frozen_normals(key, shapes, pos))
        mats.append(m)
    return mats


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (nearest, ties even)."""
    bits = t.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & 0xFFFFE000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32)


def forward(mats, x: torch.Tensor, precision: str = "float64"
            ) -> torch.Tensor:
    """The cascade's detected outputs for real rows ``x [B, width]`` on
    x's device: float64 (the reference), or each layer's operands rounded
    to TF32 and multiplied in float32 (the control)."""
    if precision == "float64":
        h = x.to(torch.float64).to(torch.complex128)
        for m in mats:
            mt = torch.as_tensor(m.T, device=x.device)
            h = (h @ mt).abs().to(torch.complex128)
        return h.real
    if precision != "tf32":
        raise ValueError(precision)
    hr, hi = x.float(), torch.zeros_like(x, dtype=torch.float32)
    for m in mats:
        mr = round_tf32(torch.as_tensor(m.T.real, dtype=torch.float32,
                                        device=x.device))
        mi = round_tf32(torch.as_tensor(m.T.imag, dtype=torch.float32,
                                        device=x.device))
        ar, ai = round_tf32(hr), round_tf32(hi)
        yr = ar @ mr - ai @ mi
        yi = ar @ mi + ai @ mr
        hr, hi = torch.sqrt(yr * yr + yi * yi), torch.zeros_like(yr)
    return hr.double()


def relative_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    want = want.double()
    return float((got.double() - want).abs().max()
                 / want.abs().max().clamp_min(1e-300))
