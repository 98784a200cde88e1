"""Per-(arch x shape) cell construction for the dry run: the counterpart
of the JAX package's ``repro.launch.specs``.

Builds, without allocating anything on a device:
  * the runtime-adjusted ModelConfig (bf16, remat, expert groups, cache len,
    vocab and head padding);
  * the sharding rules profile for the shape kind (the long-context profile
    moves the DP axes from batch to the KV/cache sequence dim);
  * stand-ins for every input: meta tensors of the global shapes and
    dtypes (the JAX package's ``ShapeDtypeStruct``);
  * the resolved specs of inputs and outputs, from which DTensor placements
    follow (:func:`repro_torch.parallel.sharding.placements`);
  * the step function (train step / prefill / serve step).

:meth:`Cell.trace` stands where the JAX package's ``Cell.lower`` does: it
installs the mesh and rules and runs the step once on fake tensors laid out
as DTensors, reading FLOPs, collectives and memory on the way.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree

from repro_torch import configs
from repro_torch.models.api import Model
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel import sharding as sh
from repro_torch.train import step as train_step_lib


# ---------------------------------------------------------------------------
# per-arch runtime profiles (memory/perf knobs)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArchProfile:
    fsdp_params: bool = False        # shard param embed dims over data
    moment_dtype: str = "float32"
    grad_compression: bool = False
    accum_steps: int = 1
    remat: str = "full"              # train-time activation checkpointing
    #: train with pure data-parallelism over BOTH mesh axes (no TP): for
    #: models whose params and optimizer state fit on one device, the
    #: gradient all-reduce costs less than tensor parallelism's activation
    #: all-reduces.
    pure_dp_train: bool = False


PROFILES: dict[str, ArchProfile] = {
    # 400B: params cannot replicate over DP: FSDP the embed dims, compress
    # grads, bf16 moments.
    "llama4-maverick-400b-a17b": ArchProfile(
        fsdp_params=True, moment_dtype="bfloat16", grad_compression=True,
        accum_steps=4),
    "qwen2-moe-a2.7b": ArchProfile(fsdp_params=True),
    "tinyllama-1.1b": ArchProfile(
        pure_dp_train=True, moment_dtype="bfloat16", grad_compression=True,
        remat="outputs"),
}

_DEFAULT_PROFILE = ArchProfile()


def profile_for(arch: str) -> ArchProfile:
    return PROFILES.get(arch, _DEFAULT_PROFILE)


# ---------------------------------------------------------------------------
# rules per shape kind
# ---------------------------------------------------------------------------

def rules_for(arch: str, shape_name: str, multi_pod: bool) -> sh.ShardingRules:
    base = sh.default_rules(multi_pod).rules.copy()
    prof = profile_for(arch)
    kind = configs.SHAPES[shape_name].kind
    if prof.fsdp_params and kind != "decode":
        # parameters' embed dims shard over data (FSDP); decode keeps
        # inference weights replicated over data (no optimizer state, and
        # re-gathering them every token would cost more)
        base["mlp_embed"] = "data"
        base["embed"] = "data"
    if prof.pure_dp_train and kind == "train":
        gb = configs.SHAPES[shape_name].global_batch
        if multi_pod and gb % 512 == 0:
            dp_axes: tuple = ("pod", "data", "model")
        else:
            # a batch that does not divide 512 shards over 256 and
            # replicates across pods
            dp_axes = ("data", "model")
        for name in ("heads", "kv_heads", "ffn", "vocab", "experts",
                     "expert_ffn", "ssm_heads", "conv_dim"):
            base[name] = None
        base["batch"] = dp_axes
        base["expert_group"] = dp_axes
        base["fsdp"] = dp_axes
    if shape_name == "long_500k":
        base["batch"] = None
        base["expert_group"] = None
        base["kv_seq"] = ("pod", "data") if multi_pod else ("data",)
    elif kind == "decode":
        # batched decode: batch over the DP axes, the cache's sequence over
        # "model" (a distributed flash-decode); KV heads replicated
        base["kv_seq"] = "model"
        base["kv_heads"] = None
    return sh.ShardingRules(rules=base)


def runtime_config(arch: str, shape_name: str, multi_pod: bool):
    cfg = configs.get_config(arch)
    shape = configs.SHAPES[shape_name]
    prof = profile_for(arch)
    dp = 32 if multi_pod else 16
    upd: dict[str, Any] = {
        "dtype": "bfloat16",
        "expert_groups": max(1, min(dp, shape.global_batch)),
        "remat": prof.remat if shape.kind == "train" else "none",
        "max_cache_len": shape.seq_len if shape.kind == "decode" else 0,
    }
    if cfg.vocab_size % 256:
        # pad the vocab so its axis shards 16-way; the padded logits are
        # masked to -1e30 in unembed (vocab_real)
        upd["vocab_size"] = -(-cfg.vocab_size // 256) * 256
        upd["vocab_real"] = cfg.vocab_size
    if cfg.n_heads > 1 and cfg.n_heads % 16 and cfg.n_kv_heads < cfg.n_heads:
        # GQA/MQA only: pad q-heads with dead (masked, zero) heads so the
        # attention weights shard over the 16-way model axis; the real
        # heads keep their original KV grouping
        upd["head_pad"] = -(-cfg.n_heads // 16) * 16 - cfg.n_heads
    return dataclasses.replace(cfg, **upd), shape


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------

def _stand_in(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _tokens_seq_len(cfg, shape) -> int:
    if cfg.family == "vlm":
        return shape.seq_len - cfg.n_vis_tokens
    return shape.seq_len


def batch_specs(cfg, shape) -> dict:
    """Meta-tensor stand-ins for one global batch."""
    b = shape.global_batch
    s = _tokens_seq_len(cfg, shape)
    specs = {"tokens": _stand_in((b, s), torch.int32),
             "labels": _stand_in((b, s), torch.int32)}
    if cfg.family == "vlm":
        specs["vis_embed"] = _stand_in((b, cfg.n_vis_tokens, cfg.d_model),
                                       torch.bfloat16)
    if cfg.family == "encdec":
        specs["frames"] = _stand_in((b, cfg.enc_seq, cfg.d_model),
                                    torch.bfloat16)
    return specs


def batch_shardings(mesh, rules) -> dict:
    """``(mesh, placements)`` of every batch key."""
    return {"tokens": sh.named_sharding(mesh, rules, "batch", None),
            "labels": sh.named_sharding(mesh, rules, "batch", None),
            "vis_embed": sh.named_sharding(mesh, rules, "batch", None, None),
            "frames": sh.named_sharding(mesh, rules, "batch", None, None)}


def _axis_size(mesh, ax) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if isinstance(ax, tuple):
        n = 1
        for a in ax:
            n *= sizes[a]
        return n
    return sizes[ax]


def is_logical_leaf(t) -> bool:
    return isinstance(t, tuple) and all(
        isinstance(i, (str, type(None))) for i in t)


def _is_sharding(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[1], tuple)


def _map_tree(is_leaf, fn, tree, *trees):
    """``fn(leaf, *leaves)`` over ``tree`` (dicts and dataclass states,
    leaves where ``is_leaf``) and trees of the same structure, matched by
    key: dict order may differ."""
    if is_leaf(tree):
        return fn(tree, *trees)
    if isinstance(tree, dict):
        return {k: _map_tree(is_leaf, fn, v, *(t[k] for t in trees))
                for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{
            f.name: _map_tree(is_leaf, fn, getattr(tree, f.name),
                              *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(tree)})
    raise TypeError(f"unexpected tree node {tree!r}")


def _map_specs(fn, spec_tree, *trees):
    """Over a spec tree: tuples of logical names are its leaves."""
    return _map_tree(is_logical_leaf, fn, spec_tree, *trees)


def _map_shardings(fn, shardings, *trees):
    """Over a tree of ``(mesh, placements)`` pairs."""
    return _map_tree(_is_sharding, fn, shardings, *trees)


def resolve_specs(mesh, rules, spec_tree, shapes_tree):
    """Logical specs -> mesh-axis specs, dropping axes that don't divide.

    As the JAX package's: a logical assignment whose axis size does not
    divide the dimension (e.g. 24 heads on a 16-way model axis) falls back
    to replication on that dim, though DTensor would take uneven shards.
    """
    def leaf(t, like):
        p = rules.spec(*t)
        dims = like.shape
        return tuple(ax if (ax is None or dims[i] % _axis_size(mesh, ax) == 0)
                     else None
                     for i, ax in enumerate(
                         tuple(p) + (None,) * (len(dims) - len(p))))

    return _map_specs(leaf, spec_tree, shapes_tree)


def resolve_shardings(mesh, rules, spec_tree, shapes_tree):
    """:func:`resolve_specs` as ``(mesh, placements)`` pairs."""
    return _map_specs(lambda s: (mesh, sh.placements(mesh, s)),
                      resolve_specs(mesh, rules, spec_tree, shapes_tree))


def local_shape(shape, sharding) -> tuple:
    """This rank's shard shape of a ``shape`` tensor under ``(mesh,
    placements)``."""
    mesh, pl = sharding
    return tuple(sh.local_window(shape, mesh, pl)[0])


def shard_bytes(stand_ins, shardings) -> int:
    """Bytes this rank holds of every stand-in under its sharding."""
    sizes = []

    def one(s, t):
        n = 1
        for d in local_shape(t.shape, s):
            n *= d
        sizes.append(n * t.element_size())

    _map_shardings(one, shardings, stand_ins)
    return sum(sizes)


def distribute(tree, shardings):
    """Every tensor of ``tree`` as a DTensor with its ``(mesh, placements)``
    in ``shardings``: of a plain tensor (the same whole value on every rank)
    each rank keeps its own shard, no collective runs; a DTensor is
    redistributed."""
    from torch.distributed.tensor import distribute_tensor

    def one(s, t):
        if isinstance(t, DTensor):
            return t.redistribute(s[0], s[1])
        return distribute_tensor(t, s[0], s[1], src_data_rank=None)

    return _map_shardings(one, shardings, tree)


def _param_shapes(model: Model):
    """The params' stand-ins: ``model.init`` traced on fake tensors, its
    truncated-normal draws skipped (their rejection loop reads values; only
    shapes and dtypes are kept)."""
    from unittest import mock

    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(), mock.patch.object(
            torch.nn.init, "trunc_normal_", lambda t, *a, **k: t):
        params = model.init(torch.Generator(), device="cpu")
    return pytree.tree_map(lambda t: _stand_in(t.shape, t.dtype), params)


# ---------------------------------------------------------------------------
# cell: everything needed to trace one (arch x shape) on one mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    arch: str
    shape_name: str
    cfg: Any
    model: Model
    rules: sh.ShardingRules
    mesh: Any
    fn: Callable
    args: tuple
    in_shardings: tuple
    out_shardings: Any
    donate: tuple[int, ...]

    def argument_bytes(self) -> int:
        return sum(shard_bytes(a, s)
                   for a, s in zip(self.args, self.in_shardings))

    def fake_args(self, mode) -> tuple:
        """The stand-ins as DTensors of fake local shards (made in
        ``mode``, a ``FakeTensorMode``) on the mesh's device type."""
        dev = torch.device(self.mesh.device_type)

        def one(t, s):
            mesh, pl = s
            shape = local_shape(t.shape, s)
            with mode:
                local = torch.empty(shape, dtype=t.dtype, device=dev)
            return DTensor.from_local(local, mesh, pl, run_check=False,
                                      shape=t.shape, stride=t.stride())

        return tuple(_map_shardings(lambda s, t: one(t, s), s, a)
                     for a, s in zip(self.args, self.in_shardings))

    def trace(self) -> dict:
        """Install the mesh and rules and run ``fn`` on fake DTensor
        stand-ins, twice: the first run fills DTensor's sharding-propagation
        cache (a miss runs the op once more on global-shaped fakes, which a
        dispatch mode cannot tell from the local op), the second is read.

        Returns ``flops`` and ``collectives`` (this rank's, read on its
        local shards by :class:`LocalReadings`), ``output_bytes`` (this
        rank's shards of the outputs), ``seconds`` (both runs), the fake
        outputs (``out``), and ``peak_bytes`` ``None`` with the reason in
        ``peak_error``: no tracker reads a rank's peak here (see
        :data:`PEAK_UNREAD`)."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        t0 = time.perf_counter()
        with sh.use_mesh_and_rules(self.mesh, self.rules):
            warm = FakeTensorMode(allow_non_fake_inputs=True)
            args = self.fake_args(warm)
            with warm:
                self.fn(*args)
            mode = FakeTensorMode(allow_non_fake_inputs=True)
            args = self.fake_args(mode)
            readings = LocalReadings()
            with mode, readings:
                out = self.fn(*args)
        seconds = time.perf_counter() - t0
        out_bytes = 0
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                local = t.to_local() if isinstance(t, DTensor) else t
                out_bytes += local.numel() * local.element_size()
        return {"flops": readings.flops,
                "collectives": dict(readings.collectives),
                "output_bytes": out_bytes, "seconds": seconds, "out": out,
                "peak_bytes": None, "peak_error": PEAK_UNREAD}


#: Why the dry run reads no peak: ``torch.distributed._tools.mem_tracker.
#: MemTracker`` under ``FakeTensorMode`` misses the frees of the tensors a
#: rank makes after a DTensor redistribution (``tests/test_torch_dryrun.py``
#: holds the case), so its peak over a step is not a rank's.
PEAK_UNREAD = ("MemTracker misses the frees of tensors made after a DTensor "
               "redistribution under FakeTensorMode")


#: ``_c10d_functional`` op -> the JAX package's collective kind.
COLLECTIVE_KINDS = {"all_gather_into_tensor": "all-gather",
                    "all_reduce": "all-reduce",
                    "reduce_scatter_tensor": "reduce-scatter",
                    "all_to_all_single": "all-to-all"}


class LocalReadings:
    """A dispatch mode that reads the ops run on local tensors (each
    DTensor op's shards, below DTensor's dispatch): their FLOPs by
    ``torch.utils.flop_counter``'s formulas, and the functional
    collectives' output bytes by kind, in the JAX package's keys
    (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute`` and ``ops``).  It declines every DTensor op, so
    DTensor runs it and the local ops come back here: the counts are one
    rank's, as XLA's ``cost_analysis`` of a partitioned program is.
    ``FlopCounterMode`` entered on its own would see DTensor's global
    shapes."""

    def __init__(self):
        from torch.utils.flop_counter import FlopCounterMode
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = FlopCounterMode(display=False)
        self._counter = counter
        self.collectives = {"all-gather": 0, "all-reduce": 0,
                            "reduce-scatter": 0, "all-to-all": 0,
                            "collective-permute": 0, "ops": 0}
        readings = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **kwargs)
                packet = func._overloadpacket
                kind = COLLECTIVE_KINDS.get(packet.__name__)
                if kind is not None and "c10d" in packet._qualified_op_name:
                    readings.collectives[kind] += (out.numel()
                                                   * out.element_size())
                    readings.collectives["ops"] += 1
                else:
                    counter._count_flops(packet, out, args, kwargs)
                return out

        self._mode = _Mode()

    @property
    def flops(self) -> int:
        return int(self._counter.get_total_flops())

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def build_cell(arch: str, shape_name: str, mesh, *, multi_pod: bool) -> Cell:
    cfg, shape = runtime_config(arch, shape_name, multi_pod)
    rules = rules_for(arch, shape_name, multi_pod)
    prof = profile_for(arch)
    model = Model(cfg)

    pspec_tree = model.param_specs()
    param_shapes = _param_shapes(model)
    if shape.kind in ("prefill", "decode"):
        # serving holds bf16 weights: half the weight-read bytes of float32
        # training params
        param_shapes = pytree.tree_map(
            lambda t: _stand_in(t.shape, torch.bfloat16)
            if t.dtype == torch.float32 else t, param_shapes)
    param_sh = resolve_shardings(mesh, rules, pspec_tree, param_shapes)
    logit_sh = sh.named_sharding(mesh, rules, "batch", "vocab")

    def batch_sh():
        bs = batch_specs(cfg, shape)
        return {k: v for k, v in batch_shardings(mesh, rules).items()
                if k in bs}

    if shape.kind == "train":
        opt = AdamW(lr=1e-4, moment_dtype=getattr(torch, prof.moment_dtype),
                    grad_compression=prof.grad_compression)
        tstep = train_step_lib.make_train_step(model, opt,
                                               accum_steps=prof.accum_steps)
        opt_shapes = train_step_lib.OptState(
            step=_stand_in((), torch.int32),
            m=pytree.tree_map(lambda t: _stand_in(t.shape, opt.moment_dtype),
                              param_shapes),
            v=pytree.tree_map(lambda t: _stand_in(t.shape, opt.moment_dtype),
                              param_shapes))
        state_shapes = train_step_lib.TrainState(params=param_shapes,
                                                 opt=opt_shapes)
        state_sh = train_step_lib.TrainState(
            params=param_sh,
            opt=resolve_shardings(mesh, rules, opt.state_specs(pspec_tree),
                                  opt_shapes))
        return Cell(arch, shape_name, cfg, model, rules, mesh, tstep,
                    (state_shapes, batch_specs(cfg, shape)),
                    (state_sh, batch_sh()), (state_sh, None), (0,))

    cache_shapes = pytree.tree_map(
        lambda t: _stand_in(t.shape, t.dtype),
        _fake_cache(model, shape.global_batch, shape.seq_len))
    cache_sh = resolve_shardings(mesh, rules, model.cache_specs(),
                                 cache_shapes)

    if shape.kind == "prefill":
        def prefill_fn(params, batch):
            return model.prefill(params, batch, max_len=shape.seq_len)
        return Cell(arch, shape_name, cfg, model, rules, mesh, prefill_fn,
                    (param_shapes, batch_specs(cfg, shape)),
                    (param_sh, batch_sh()), (logit_sh, cache_sh), ())

    # decode: one new token against a seq_len cache
    def serve_step(params, cache, token, pos):
        return model.decode_step(params, token, cache, pos)

    b = shape.global_batch
    return Cell(arch, shape_name, cfg, model, rules, mesh, serve_step,
                (param_shapes, cache_shapes, _stand_in((b,), torch.int32),
                 _stand_in((), torch.int32)),
                (param_sh, cache_sh, sh.named_sharding(mesh, rules, "batch"),
                 (mesh, sh.placements(mesh, ()))),
                (logit_sh, cache_sh), (1,))


def _fake_cache(model: Model, batch: int, max_len: int):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return model.init_cache(batch, max_len, device="cpu")
