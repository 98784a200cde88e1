"""The port's spec trees, ``constrain``/``placements`` and
``launch/specs.py``'s rules and runtime configs against the JAX package's.

In this process: every ``spec_*`` tree, ``Model.param_specs``/
``cache_specs``, ``train.step.state_specs`` and ``AdamW.state_specs`` equal
the JAX package's tuple for tuple, for every family of
``tests/test_models.py::make_cfg`` and ``tests/test_rfnn_lm.py``'s ``CFG``
(the trees share their keys: ``repro_torch.interop`` carries params across
as they are), and every leaf's tuple has its tensor's rank (the twins of
``test_param_specs_match_structure`` and ``test_rfnn_lm_specs_match``);
``constrain`` with no mesh; ``rules_for`` and ``runtime_config`` on all of
``configs.grid()`` and the twin of ``test_runtime_profiles_resolve``.

``placements`` on a fake 512-rank group: for specs with a tuple of axes,
every rank's shard window (:func:`local_window`, which this test also holds
against DTensor's own reading on this rank) equals the index JAX's
``NamedSharding.devices_indices_map`` gives the device at the same mesh
coordinate, read in a subprocess with 512 placeholder devices.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.launch import specs as j_specs  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import ModelConfig as JConfig  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import encdec as j_encdec  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro.optim.adamw import AdamW as JAdamW  # noqa: E402
from repro.train import step as j_step  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.launch import specs as t_specs  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models import ModelConfig as TConfig  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import encdec as t_encdec  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402
from repro_torch.optim.adamw import AdamW as TAdamW  # noqa: E402
from repro_torch.parallel import sharding as t_sh  # noqa: E402
from repro_torch.train import step as t_step  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

SRC = Path(__file__).resolve().parents[1] / "src"
BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab_size=97, attn_chunk=16, dtype="float32")
EXTRA = {  # tests/test_models.py::make_cfg
    "dense": {},
    "moe": dict(n_experts=4, top_k=2, d_ff_expert=32, n_shared_experts=1,
                d_ff_shared=32, moe_interleave=2, capacity_factor=8.0),
    "ssm": dict(ssm_state=16, ssm_headdim=16, ssm_chunk=8),
    "hybrid": dict(ssm_state=16, ssm_headdim=16, ssm_chunk=8, attn_every=2),
    "vlm": dict(n_vis_tokens=8),
    "encdec": dict(n_enc_layers=2, enc_seq=24),
}
RFNN = dict(name="rfnn-lm", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=97, attn_chunk=16,
            dtype="float32", linear_impl="rfnn", rfnn_tile=16)
CASES = {name: dict(name=name, family=name, **BASE, **extra)
         for name, extra in EXTRA.items()}
CASES["rfnn"] = RFNN


def _is_spec(t):
    return isinstance(t, tuple) and all(isinstance(i, (str, type(None)))
                                        for i in t)


def _specs_equal(got, want, path=""):
    """Dicts by key (both packages' trees keep the same keys), dataclass
    states by field, leaves as tuples."""
    if _is_spec(want):
        assert got == want, (path, got, want)
        return
    if dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            _specs_equal(getattr(got, f.name), getattr(want, f.name),
                         f"{path}.{f.name}")
        return
    assert isinstance(got, dict) and got.keys() == want.keys(), path
    for k in want:
        _specs_equal(got[k], want[k], f"{path}/{k}")


def _ranks_match(params, specs, path=""):
    if isinstance(params, dict):
        assert isinstance(specs, dict) and params.keys() == specs.keys(), path
        for k in params:
            _ranks_match(params[k], specs[k], f"{path}/{k}")
        return
    assert _is_spec(specs) and len(specs) == params.dim(), (path, specs,
                                                             params.shape)


@pytest.mark.parametrize("name", list(CASES))
def test_param_and_cache_specs_match_jax(name):
    kw = CASES[name]
    jm, tm = JModel(JConfig(**kw)), TModel(TConfig(**kw))
    _specs_equal(tm.param_specs(), jm.param_specs())
    _specs_equal(tm.cache_specs(), jm.cache_specs())
    params = tm.init(torch.Generator().manual_seed(0), device="cpu")
    _ranks_match(params, tm.param_specs())
    _ranks_match(tm.init_cache(2, 8, device="cpu"), tm.cache_specs())


@pytest.mark.parametrize("name", list(CASES))
def test_state_specs_match_jax(name):
    kw = CASES[name]
    jm, tm = JModel(JConfig(**kw)), TModel(TConfig(**kw))
    want = j_step.state_specs(jm, JAdamW())
    got = t_step.state_specs(tm, TAdamW())
    assert got.opt.step == want.opt.step == ()
    _specs_equal(got.params, want.params)
    _specs_equal(got.opt.m, want.opt.m)
    _specs_equal(got.opt.v, want.opt.v)
    _specs_equal(TAdamW().state_specs(tm.param_specs()).m,
                 JAdamW().state_specs(jm.param_specs()).m)


@pytest.mark.parametrize("name", list(CASES))
def test_module_spec_trees_match_jax(name):
    jc, tc = JConfig(**CASES[name]), TConfig(**CASES[name])
    _specs_equal(t_layers.spec_rmsnorm(), j_layers.spec_rmsnorm())
    _specs_equal(t_layers.spec_embed(tc), j_layers.spec_embed(jc))
    _specs_equal(t_layers.spec_mlp(tc), j_layers.spec_mlp(jc))
    _specs_equal(t_layers.spec_mlp(), j_layers.spec_mlp())
    _specs_equal(t_attn.spec_attention(), j_attn.spec_attention())
    _specs_equal(t_attn.spec_cache(), j_attn.spec_cache())
    _specs_equal(t_ssm.spec_ssm(), j_ssm.spec_ssm())
    _specs_equal(t_ssm.spec_ssm_cache(), j_ssm.spec_ssm_cache())
    if tc.family == "moe":
        _specs_equal(t_moe.spec_moe(tc), j_moe.spec_moe(jc))
    if tc.family == "encdec":
        _specs_equal(t_encdec.spec_encdec(tc), j_encdec.spec_encdec(jc))
        _specs_equal(t_encdec.spec_dec_cache(tc), j_encdec.spec_dec_cache(jc))
    else:
        _specs_equal(t_lm.spec_lm(tc), j_lm.spec_lm(jc))
        _specs_equal(t_lm.spec_lm_cache(tc), j_lm.spec_lm_cache(jc))


def _imports(path):
    import ast

    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_new_modules_and_chip_smoke_import_neither_jax_nor_repro():
    """The import check of ``tests/test_torch_core.py`` walks the package;
    this one names this slice's modules and adds ``chip_smoke.py``, whose
    phases import the port inside their functions."""
    files = [SRC / "repro_torch" / "launch" / "specs.py",
             SRC / "repro_torch" / "launch" / "dryrun.py",
             SRC / "repro_torch" / "parallel" / "sharding.py",
             SRC.parent / "chip_smoke.py"]
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad


def test_constrain_without_mesh_returns_its_input():
    x = torch.randn(2, 3, 4)
    assert t_sh.constrain(x, "batch", "seq", "embed") is x
    with t_sh.use_mesh_and_rules(None, t_sh.default_rules()):
        assert t_sh.constrain(x, "batch", "seq", "embed") is x
    with t_sh.use_mesh_and_rules(object(), None):
        assert t_sh.constrain(x, "batch", None, None) is x
    # no rank check without a mesh, as the JAX package's
    assert t_sh.constrain(x, "batch") is x


# ---------------------------------------------------------------------------
# placements against PartitionSpec on 512 ranks
# ---------------------------------------------------------------------------

LAYOUT_SHAPE = (512, 6, 512)
LAYOUT_SPECS = [(("pod", "data"), None, "model"),
                (("pod", "data", "model"), None, None),
                (("data", "model"), None, None),
                ("model", None, ("pod", "data")),
                (None, None, ("data", "model")),
                ("data", None, None), ()]

_JAX_LAYOUT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
specs, shape = json.loads(sys.argv[1]), tuple(json.loads(sys.argv[2]))
mesh = jax.make_mesh((2, 16, 16), ("pod", "data", "model"))
out = []
for spec in specs:
    spec = [tuple(a) if isinstance(a, list) else a for a in spec]
    idx = NamedSharding(mesh, P(*spec)).devices_indices_map(shape)
    windows = {}
    for coord in np.ndindex(mesh.devices.shape):
        sl = idx[mesh.devices[coord]]
        windows[",".join(map(str, coord))] = [
            [s.start or 0, (s.stop if s.stop is not None else n)]
            for s, n in zip(sl, shape)]
    out.append(windows)
print(json.dumps(out))
"""


def _jax_windows():
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    run = subprocess.run(
        [sys.executable, "-c", _JAX_LAYOUT, json.dumps(LAYOUT_SPECS),
         json.dumps(LAYOUT_SHAPE)], capture_output=True, text=True, env=env,
        timeout=120)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


class _AtCoord:
    """A mesh stand-in at one coordinate: what :func:`local_window` reads."""

    def __init__(self, shape, coord):
        self._shape, self._coord = shape, coord

    def size(self, i):
        return self._shape[i]

    def get_local_rank(self, i):
        return self._coord[i]


def test_placements_of_axis_tuples_give_jax_layout():
    want = _jax_windows()
    dist.init_process_group("fake", store=FakeStore(), rank=511,
                            world_size=512)
    try:
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset

        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        for spec, windows in zip(LAYOUT_SPECS, want):
            pl = t_sh.placements(mesh, spec)
            size, off = t_sh.local_window(LAYOUT_SHAPE, mesh, pl)
            ref = compute_local_shape_and_global_offset(
                torch.Size(LAYOUT_SHAPE), mesh, pl)
            assert (tuple(size), tuple(off)) == (tuple(ref[0]),
                                                 tuple(ref[1])), spec
            for coord in np.ndindex(2, 16, 16):
                size, off = t_sh.local_window(
                    LAYOUT_SHAPE, _AtCoord((2, 16, 16), coord), pl)
                got = [[o, o + n] for o, n in zip(off, size)]
                assert got == windows[",".join(map(str, coord))], (spec,
                                                                    coord)
        assert t_sh.placements(mesh, (("pod", "data"), None, "model")) == (
            Shard(0), Shard(0), Shard(2))
        assert t_sh.placements(mesh, ()) == (Replicate(),) * 3
        _, pl = t_sh.named_sharding(mesh, t_sh.default_rules(True), "batch",
                                    "heads")
        assert pl == (Shard(0), Shard(0), Shard(1))
        with pytest.raises(ValueError, match="order"):
            t_sh.placements(mesh, (("data", "pod"),))
        with pytest.raises(ValueError, match="twice"):
            t_sh.placements(mesh, ("data", "data"))
        with t_sh.use_mesh_and_rules(mesh, t_sh.default_rules(True)):
            with pytest.raises(ValueError, match="rank"):
                t_sh.constrain(torch.zeros(2, 3), "batch")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# launch/specs.py against the JAX package's
# ---------------------------------------------------------------------------

def test_runtime_profiles_resolve():
    """The twin of ``tests/test_parallel.py::test_runtime_profiles_resolve``."""
    for arch in ("llama4-maverick-400b-a17b", "tinyllama-1.1b", "gemma-2b"):
        for shape in ("train_4k", "decode_32k"):
            cfg, _ = t_specs.runtime_config(arch, shape, False)
            assert cfg.vocab_size % 256 == 0 or cfg.vocab_real == 0
            if cfg.head_pad:
                assert (cfg.n_heads + cfg.head_pad) % 16 == 0


@pytest.mark.parametrize("multi_pod", [False, True])
def test_runtime_config_and_rules_match_jax_on_the_grid(multi_pod):
    assert t_configs.grid() == j_configs.grid()
    for arch, shape in j_configs.grid():
        jc, js = j_specs.runtime_config(arch, shape, multi_pod)
        tc, ts = t_specs.runtime_config(arch, shape, multi_pod)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), (arch, shape)
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
        assert t_specs.rules_for(arch, shape, multi_pod).rules == \
            j_specs.rules_for(arch, shape, multi_pod).rules, (arch, shape)
        jp, tp = j_specs.profile_for(arch), t_specs.profile_for(arch)
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)


def test_batch_specs_match_jax():
    for arch, shape in j_configs.grid():
        jc, js = j_specs.runtime_config(arch, shape, False)
        tc, ts = t_specs.runtime_config(arch, shape, False)
        want = j_specs.batch_specs(jc, js)
        got = t_specs.batch_specs(tc, ts)
        assert got.keys() == want.keys()
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, (arch, shape, k)
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
            assert got[k].device.type == "meta"
