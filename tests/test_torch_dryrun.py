"""The port's dry run (``launch/specs.py`` cells traced by
``launch/dryrun.py``) on a fake 256-rank group, against the JAX package's
``build_cell`` read in a subprocess with 256 placeholder devices (no
lowering).

  * TinyLlama-1.1B ``train_4k`` and ``decode_32k``: this rank's
    ``argument_bytes`` equal, to the byte, the sum over JAX's cell
    arguments of ``in_sharding.shard_shape(shape)`` x itemsize; every
    param, moment, cache and batch leaf resolves to JAX's spec (also in
    whisper-large-v3's ``decode_32k``, whose 20 MHA heads do not divide the
    model axis);
  * the pure-DP ``train_4k`` cell's per-rank FLOPs x 256 within 1% of the
    same step's FLOPs traced without a mesh;
  * the twin of ``tests/test_elastic_remesh.py::test_recovery_mesh_recompiles``:
    ``plan_recovery(140)``'s (8, 16) cell traces, with argument bytes > 0.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.device_mesh import init_device_mesh  # noqa: E402
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.runtime import plan_recovery  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH = "tinyllama-1.1b"
CELLS = [(ARCH, "train_4k"), (ARCH, "decode_32k"),
         ("whisper-large-v3", "decode_32k")]

_JAX_CELLS = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
import jax, numpy as np
from repro.launch import specs
from repro.launch.mesh import make_production_mesh


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: [list(a) if isinstance(a, tuple) else a
                     for a in tuple(tree.spec)]}


mesh = make_production_mesh()
out = {}
for arch, shape in json.loads(sys.argv[1]):
    cell = specs.build_cell(arch, shape, mesh, multi_pod=False)
    total = 0
    for a, s in zip(jax.tree.leaves(cell.args),
                    jax.tree.leaves(cell.in_shardings)):
        total += int(np.prod(s.shard_shape(a.shape))) * a.dtype.itemsize
    res = {"argument_bytes": total}
    if shape == "train_4k":
        state, batch = cell.in_shardings
        res.update(params=flat(state.params), m=flat(state.opt.m),
                   v=flat(state.opt.v), batch=flat(batch))
    else:
        res.update(params=flat(cell.in_shardings[0]),
                   cache=flat(cell.in_shardings[1]))
    out[f"{arch}/{shape}"] = res
print(json.dumps(out))
"""


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: [list(a) if isinstance(a, tuple) else a for a in tree]}


@pytest.fixture(scope="module")
def jax_cells():
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, "-c", _JAX_CELLS, json.dumps(CELLS)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _jax(proc):
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture
def fake256():
    dryrun.fake_group(256)
    try:
        yield make_production_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def _resolved(cell):
    """The port's resolved specs of a cell's arguments, flattened by
    path as the subprocess flattens JAX's."""
    model, rules, mesh = cell.model, cell.rules, cell.mesh
    if cell.shape_name == "train_4k":
        state, batch = cell.args
        opt = specs.AdamW().state_specs(model.param_specs())
        return {"params": specs.resolve_specs(mesh, rules, model.param_specs(),
                                              state.params),
                "m": specs.resolve_specs(mesh, rules, opt.m, state.opt.m),
                "v": specs.resolve_specs(mesh, rules, opt.v, state.opt.v),
                "batch": {k: rules.spec(*(("batch",) + (None,) * (t.dim() - 1)))
                          for k, t in batch.items()}}
    params, cache = cell.args[:2]
    return {"params": specs.resolve_specs(mesh, rules, model.param_specs(),
                                          params),
            "cache": specs.resolve_specs(mesh, rules, model.cache_specs(),
                                         cache)}


def test_cells_match_jax_bytes_and_specs(jax_cells, fake256):
    want = _jax(jax_cells)
    for arch, shape in CELLS:
        cell = specs.build_cell(arch, shape, fake256, multi_pod=False)
        ref = want[f"{arch}/{shape}"]
        if arch == ARCH:
            assert cell.argument_bytes() == ref["argument_bytes"], shape
        for part, tree in _resolved(cell).items():
            got = _flat(tree)
            assert got == ref[part], (arch, shape, part)
        # the cell's placements are the resolved specs'
        params_sh = (cell.in_shardings[0].params if shape == "train_4k"
                     else cell.in_shardings[0])
        resolved = _resolved(cell)["params"]
        specs._map_shardings(
            lambda s, spec: _same(s[1], sh.placements(fake256, spec)),
            params_sh, resolved)


def _same(a, b):
    assert a == b, (a, b)


def test_pure_dp_train_flops_per_rank(fake256):
    """``train_4k`` splits TinyLlama's batch over all 256 ranks with the
    params replicated: a rank's FLOPs are a 256th of the step's."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cell = specs.build_cell(ARCH, "train_4k", fake256, multi_pod=False)
    traced = cell.trace()
    assert traced["collectives"]["all-reduce"] > 0
    mode = FakeTensorMode(allow_non_fake_inputs=True)

    def fake(t):
        with mode:
            return torch.empty(t.shape, dtype=t.dtype)

    args = tuple(specs._map_shardings(lambda s, t: fake(t), s, a)
                 for a, s in zip(cell.args, cell.in_shardings))
    whole = specs.LocalReadings()
    with mode, whole:
        cell.fn(*args)
    ratio = traced["flops"] * 256 / whole.flops
    assert abs(ratio - 1) < 0.01, (traced["flops"], whole.flops)
    assert traced["peak_bytes"] is None
    assert traced["peak_error"] == specs.PEAK_UNREAD


def test_memtracker_misses_frees_after_a_redistribution(fake256):
    """Why ``Cell.trace`` reads no peak: after one redistribution, ten
    doublings of an 8 MiB shard leave one tensor alive, and MemTracker's
    peak counts far more than the two a doubling needs."""
    import gc
    import weakref

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        local = torch.empty(1, 1024, 1024)
    x = DTensor.from_local(local, fake256, [Shard(0), Shard(0)],
                           run_check=False, shape=torch.Size([256, 1024, 1024]),
                           stride=(1024 * 1024, 1024, 1))
    tracker, alive = MemTracker(), []
    with mode, tracker:
        y = x.redistribute(fake256, [Shard(0), Replicate()])
        for _ in range(10):
            y = y * 2.0
            alive.append(weakref.ref(y))
    gc.collect()
    assert sum(r() is not None for r in alive) == 1
    peak = sum(d["Total"] for d in tracker.get_tracker_snapshot("peak")
               .values())
    assert peak > 4 * 8 * 2**20, peak


def test_recovery_mesh_cell_traces():
    plan = plan_recovery(140)
    assert plan.mesh_shape == (8, 16), plan
    dist.init_process_group("fake", store=FakeStore(),
                            rank=plan.chips - 1, world_size=plan.chips)
    try:
        from torch._subclasses.fake_tensor import FakeTensorMode

        mesh = init_device_mesh("cpu", plan.mesh_shape,
                                mesh_dim_names=plan.mesh_axes)
        cell = specs.build_cell(ARCH, "train_4k", mesh, multi_pod=False)
        assert cell.argument_bytes() > 0
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        args = cell.fake_args(mode)
        with sh.use_mesh_and_rules(mesh, cell.rules), mode:
            state, metrics = cell.fn(*args)
        assert state.params["embed"]["table"].shape == (32000, 2048)
        assert metrics["loss"].shape == ()
    finally:
        dist.destroy_process_group()
