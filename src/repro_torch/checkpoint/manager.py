"""Checkpoint manager: atomic, shard-per-host, async, with retention.

The counterpart of the JAX package's ``repro.checkpoint.manager``, with
the same layout (one directory per step):

    ckpt_dir/
      step_000100/
        manifest.json          # tree paths, shapes/dtypes, data step,
                               # compression codec
        host_000.ckpt          # this host's leaves (headered, zstd- or
                               # zlib-compressed npz)
        ...
      LATEST                   # atomically updated pointer file

Fault-tolerance properties:
  * writes go to ``step_x.tmp`` then ``os.replace``: a crash mid-save never
    corrupts a restorable checkpoint;
  * the LATEST pointer is written last, after this host's shard;
  * ``save_async`` copies every leaf to host memory on the calling thread
    (``.detach()`` and a copy, so a later in-place update of a CUDA or CPU
    tensor cannot reach the snapshot) and serializes on a worker thread, so
    the train loop keeps stepping;
  * ``restore`` validates the manifest's tree paths against the expected
    structure and returns the deterministic data stream's ``data_step``;
  * ``keep`` retention deletes old steps only after a newer one is durable.

Tree paths come from ``torch.utils._pytree`` (``keystr``), so a tree of
nested dicts has the JAX package's paths; the port's ``TrainState`` and
``OptState`` are dataclass nodes (``.params['embed']...``), so a train
state saved here does not restore in JAX.  numpy has no bfloat16: a
bfloat16 leaf is stored as its 16-bit pattern (an ``int16`` view) and the
manifest records ``bfloat16``, which ``restore`` views back.

Compression: shards are zstd-compressed when ``zstandard`` is installed and
fall back to stdlib ``zlib`` otherwise.  Each shard carries the JAX
package's header (``RPCK`` and a 4-byte codec tag), and ``restore``
dispatches on it, so shards of either package's managers decode here.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import threading
import zlib
from pathlib import Path

import numpy as np
import torch
from torch.utils import _pytree as pytree

try:  # optional: a host may not ship zstandard
    import zstandard
except ImportError:  # pragma: no cover - depends on the environment
    zstandard = None

#: shard header: magic + 4-byte codec tag, then the compressed payload
_MAGIC = b"RPCK"
_CODECS = ("zstd", "zlib")


def _default_codec() -> str:
    return "zstd" if zstandard is not None else "zlib"


def _compress(data: bytes, codec: str) -> bytes:
    if codec == "zstd":
        if zstandard is None:
            raise RuntimeError("codec 'zstd' requested but zstandard is "
                               "not installed; use codec='zlib'")
        payload = zstandard.ZstdCompressor(level=3).compress(data)
    elif codec == "zlib":
        payload = zlib.compress(data, 6)
    else:
        raise ValueError(f"unknown checkpoint codec {codec!r}")
    return _MAGIC + codec.encode("ascii").ljust(4, b"\0") + payload


def _decompress(blob: bytes) -> bytes:
    if blob[:4] == _MAGIC:
        codec = blob[4:8].rstrip(b"\0").decode("ascii")
        payload = blob[8:]
    else:  # legacy shard written before the codec header existed
        codec, payload = "zstd", blob
    if codec == "zstd":
        if zstandard is None:
            raise RuntimeError("checkpoint shard is zstd-compressed but "
                               "zstandard is not installed")
        return zstandard.ZstdDecompressor().decompress(payload)
    if codec == "zlib":
        return zlib.decompress(payload)
    raise ValueError(f"unknown checkpoint codec {codec!r}")


def _flatten_with_paths(tree):
    flat, _ = pytree.tree_flatten_with_path(tree)
    return [(pytree.keystr(path), leaf) for path, leaf in flat]


def _snapshot(leaf):
    """A host copy that no later update of ``leaf`` can reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to store, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        name = str(leaf.dtype).removeprefix("torch.")
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy(), name
        return leaf.numpy(), name
    a = np.asarray(leaf)
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype: str, like):
    """A stored array back as ``like``'s kind: a tensor on ``like``'s device
    (bfloat16 viewed back from its 16-bit pattern), else the array."""
    if not isinstance(like, torch.Tensor):
        return a
    t = torch.from_numpy(np.array(a))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(like.device)


class CheckpointManager:
    def __init__(self, directory: str | Path, *, keep: int = 3,
                 host_id: int = 0, num_hosts: int = 1,
                 codec: str | None = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.codec = codec if codec is not None else _default_codec()
        if self.codec not in _CODECS:
            raise ValueError(f"unknown checkpoint codec {self.codec!r}")
        if self.codec == "zstd" and zstandard is None:
            # fail here: a late _compress error inside save_async's worker
            # thread would silently drop every checkpoint
            raise RuntimeError("codec 'zstd' requested but zstandard is "
                               "not installed; use codec='zlib'")
        self._worker: threading.Thread | None = None
        self._error: Exception | None = None

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    def save(self, step: int, tree, *, data_step: int | None = None):
        """Synchronous durable save of this host's shard."""
        self.wait()  # serialize against any in-flight async save
        self._write(step, pytree.tree_map(_snapshot, tree),
                    data_step if data_step is not None else step)

    def save_async(self, step: int, tree, *, data_step: int | None = None):
        """Snapshot to host memory now; serialize on a worker thread."""
        self.wait()  # one outstanding save at a time
        host_tree = pytree.tree_map(_snapshot, tree)
        ds = data_step if data_step is not None else step
        self._worker = threading.Thread(
            target=self._write_reporting, args=(step, host_tree, ds),
            daemon=True)
        self._worker.start()

    def wait(self):
        """Join the in-flight async save; re-raise what it raised."""
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("an asynchronous checkpoint save failed") \
                from err

    def _write_reporting(self, step, host_tree, data_step):
        try:
            self._write(step, host_tree, data_step)
        except Exception as e:  # noqa: BLE001 - re-raised by wait()
            self._error = e

    def _write(self, step: int, host_tree, data_step: int):
        final = self._step_dir(step)
        if final.exists():
            return  # this step is already durable
        tmp = final.with_suffix(".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)

        leaves = [(p,) + _to_numpy(v) for p, v in _flatten_with_paths(host_tree)]
        buf = io.BytesIO()
        np.savez(buf, **{f"leaf_{i}": a for i, (_, a, _) in enumerate(leaves)})
        payload = _compress(buf.getvalue(), self.codec)
        (tmp / f"host_{self.host_id:03d}.ckpt").write_bytes(payload)

        if self.host_id == 0:
            manifest = {
                "step": step,
                "data_step": data_step,
                "codec": self.codec,
                "num_hosts": self.num_hosts,
                "paths": [p for p, _, _ in leaves],
                "shapes": [list(a.shape) for _, a, _ in leaves],
                "dtypes": [d for _, _, d in leaves],
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest))

        os.replace(tmp, final)  # atomic publish
        if self.host_id == 0:
            latest_tmp = self.dir / "LATEST.tmp"
            latest_tmp.write_text(str(step))
            os.replace(latest_tmp, self.dir / "LATEST")
            self._apply_retention(step)

    def _apply_retention(self, newest_step: int):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep else []:
            if s != newest_step:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                      if p.is_dir() and not p.suffix)

    def latest_step(self) -> int | None:
        ptr = self.dir / "LATEST"
        if ptr.exists():
            s = int(ptr.read_text())
            if self._step_dir(s).exists():
                return s
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None, like):
        """Restore into the structure of ``like``; returns (tree, meta).

        A leaf comes back as a tensor on the device of ``like``'s leaf at
        that path, with the dtype it was saved in (a non-tensor ``like``
        leaf: the stored numpy array)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        manifest = json.loads((d / "manifest.json").read_text())
        shard = d / f"host_{self.host_id:03d}.ckpt"
        if not shard.exists():  # legacy checkpoints used a .zst suffix
            shard = d / f"host_{self.host_id:03d}.zst"
        raw = _decompress(shard.read_bytes())
        data = np.load(io.BytesIO(raw))

        expected = _flatten_with_paths(like)
        if [p for p, _ in expected] != manifest["paths"]:
            raise ValueError(
                "checkpoint tree mismatch:\n"
                f"  have {manifest['paths'][:4]}...\n"
                f"  want {[p for p, _ in expected][:4]}...")
        leaves = [_from_numpy(data[f"leaf_{i}"], manifest["dtypes"][i], lk)
                  for i, (_, lk) in enumerate(expected)]
        spec = pytree.tree_structure(like)
        return pytree.tree_unflatten(leaves, spec), {
            "step": manifest["step"], "data_step": manifest["data_step"]}
