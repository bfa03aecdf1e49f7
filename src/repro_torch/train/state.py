"""ZeRO++ checkpoints: per-rank shard files, an INT8 format, elastic restore
and the serving load.

The port's copy of the reference's ``train/state.py`` checkpoint format,
so that a checkpoint either side writes is one the other reads:

  * **Per-shard files** — each rank process writes ONLY its own world-shard
    of every flat buffer (``key@<rank>`` members of ``shard_<rank>.npz``)
    into one shared staging directory; rank 0 writes ``manifest.json``
    last (the ``ParamSpec`` layout, world, quantization block, step and
    ``meta``, every file's crc32) and publishes with one atomic rename.
    Host RAM a rank stays O(model / world) on save.
  * **INT8 format** — ``fmt="int8"`` stores every sharded float buffer as
    INT8 values and fp16 per-block scales (the second moment as
    ceil-rounded uint8 in the sqrt domain, ``v_hat >= v``), about 4x
    smaller; fp32 stays the exact default.  The quantizers are the
    reference's numpy, which divides (``absmax / 127``): not B1 and not
    ``core/quant.py``, which follow the jitted ``absmax * fl(1/qmax)``.
  * **Elastic restore** — a checkpoint written at world W loads at world
    W': the shards are glued into global buffers, re-padded to the new
    world's alignment (:func:`fit_to`: the logical prefix of a flat buffer
    never moves) and cut to this rank's shard (``partition.shard_of``).
    Every rank reads the global buffers (O(model) host RAM a rank on
    restore, as in the reference).
  * **Serving load** — :func:`load_serving_params`: params only, re-fit
    and cast to bf16, this rank's shard of each buffer on a mesh (the
    global buffers at world 1).

Where the port departs from the reference:

  * the reference runs every rank in one process ("process 0 writes every
    shard, one file"); here rank r writes ``shard_<r:05d>.npz``, a barrier
    follows, rank 0 gathers every file's crc32 and writes the manifest
    (``num_processes`` = world), and a last barrier ends :meth:`ZeroState.save`;
    a failure on any rank is shared with all of them, so that they retry
    or raise together (a cancelled save, :class:`SaveCancelled`, is
    shared as cancelled); the collectives of a save run on a group the
    caller names (the async writer's own), and at world > 1
    :meth:`ZeroState.restore_resilient` validates and quarantines on rank
    0 alone, then every rank loads the checkpoint rank 0 chose;
  * numpy has no bfloat16 here (no ``ml_dtypes``): bf16 goes to disk as its
    16-bit patterns (uint16, the reference's encoding, layout dtype
    ``"bfloat16"``) and loads widened to float32, which is exact;
  * the live state is torch tensors (this rank's shards, on the model's
    device), and :class:`ZeroState` takes no optimizer config (the port's
    AdamW state needs none to initialise).
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import shutil
import tempfile
import time
import zipfile
import zlib
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import numpy.lib.format as npy
import torch
import torch.distributed as dist

from repro_torch.core import collectives as cl
from repro_torch.core.partition import shard_of
from repro_torch.optim.adamw import init_opt_state

_SEP = "::"          # nesting separator in flattened state keys
_RANK = "@"          # key@rank marks one world-shard of a buffer
_SCALES = "#scales"  # key@rank#scales carries the fp16 quant scales

MANIFEST = "manifest.json"
FORMAT_FP32 = "fp32"
FORMAT_INT8 = "int8_blockwise"
_QMAX8 = 127.0


class CheckpointError(RuntimeError):
    """A checkpoint could not be written (after exhausting retries)."""


class SaveCancelled(Exception):
    """A save abandoned on purpose (raised from an io hook, e.g. the async
    writer's cancellation): shared with the peers as such, so that every
    rank of the world counts it as cancelled, never as a failed write, and
    not retried."""


class CheckpointCorruptError(CheckpointError):
    """A checkpoint on disk failed validation: truncated or bit-flipped
    shard (checksum mismatch / unreadable npz), missing shard, or an
    unparseable manifest.  The file exists but must not be trusted."""


class IOHooks:
    """Injection seam for checkpoint I/O.

    ``ZeroState.save`` calls these at fixed points of the commit protocol
    (``mid_shard`` and ``post_shard`` on every rank, the other two on rank
    0); any hook
    object only needs the methods it cares about.  Raising from a hook
    aborts the staged write exactly as a real I/O failure at that point
    would (OSError is retried, anything else propagates).
    """

    def mid_shard(self, path: str) -> None:
        """Between two members of a shard file being written (a cancelled
        write stops here instead of at the next stage)."""

    def post_shard(self, path: str) -> None:
        """After a shard file is written + fsynced, before its checksum."""

    def pre_manifest(self, staging: str) -> None:
        """After every shard, before the manifest is written."""

    def pre_publish(self, staging: str, final: str) -> None:
        """After the manifest fsync, before the atomic rename."""


def _call_hook(hooks: Any, name: str, *args) -> None:
    if hooks is None:
        return
    fn = getattr(hooks, name, None)
    if fn is not None:
        fn(*args)


def _c_order(x) -> np.ndarray:
    """``x`` as a C-contiguous array, a 0-d one kept 0-d (which
    ``np.ascontiguousarray`` would make 1-d)."""
    a = np.asarray(x)
    return a if a.flags.c_contiguous else np.ascontiguousarray(a)


def _write_npz(f, payload: Mapping[str, np.ndarray],
               between: Optional[Any] = None) -> None:
    """``np.savez(f, **payload)``, the same members byte for byte (an
    uncompressed zip64 archive of ``<key>.npy`` files), written a member at
    a time: each member's data goes to the archive whole, and
    ``between()`` (if given) runs before every member after the first."""
    with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for i, (key, arr) in enumerate(payload.items()):
            if i and between is not None:
                between()
            a = _c_order(arr)
            with zf.open(key + ".npy", "w", force_zip64=True) as fp:
                npy.write_array_header_1_0(fp, npy.header_data_from_array_1_0(a))
                fp.write(a.reshape(-1).view(np.uint8).data)


def _crc32_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


def _fsync_dir(path: str) -> None:
    """fsync a directory entry so renames/creates inside it are durable."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return               # platform without directory fds
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


# np.load failure modes for a truncated / bit-flipped npz: bad zip magic,
# bad zlib stream, short read, or numpy's "Failed to interpret" ValueError.
_SHARD_READ_ERRORS = (OSError, ValueError, EOFError,
                      zipfile.BadZipFile, zlib.error)


def model_param_layout(model) -> Dict[str, Any]:
    """JSON-able ``ParamSpec`` layout of every buffer group (manifest)."""
    out: Dict[str, Any] = {}
    for group, spec in (("embed", model.embed_spec),
                        ("blocks", model.period_spec),
                        ("experts", model.expert_spec),
                        ("rem", model.rem_spec),
                        ("head", model.head_spec),
                        ("unemb", model.unemb_spec)):
        if spec is not None:
            out[group] = {"entries": [[n, list(s)] for n, s in spec.entries],
                          "align": spec.align}
    return out


# ---------------------------------------------------------------------------
# tree flattening / dtype encoding
# ---------------------------------------------------------------------------

def flatten_state(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Flatten a pytree-of-dicts into {"a::b::c": leaf}."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            key = f"{prefix}{_SEP}{k}" if prefix else str(k)
            out.update(flatten_state(v, key))
    else:
        out[prefix] = tree
    return out


def unflatten_state(flat: Mapping[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _dtype_str(t: torch.Tensor) -> str:
    """The layout's dtype name of a tensor (numpy's names; "bfloat16")."""
    return str(t.dtype).removeprefix("torch.")


def _host(x: Any) -> np.ndarray:
    """A tensor (any device) or array as a numpy array to store: bf16 as
    its 16-bit patterns (uint16), which npz can hold."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(x)


def _np_dtype(name: str):
    """The host dtype a buffer of layout dtype ``name`` loads as (bf16:
    float32, see :func:`_decode`)."""
    return np.dtype(np.float32) if name == "bfloat16" else np.dtype(name)


def _decode(arr: np.ndarray, dtype_name: str) -> np.ndarray:
    """A stored buffer in its host dtype: bf16 bits widen to float32
    exactly (the bits in the top half of each word)."""
    if dtype_name == "bfloat16" and arr.dtype == np.uint16:
        return (arr.astype(np.uint32) << 16).view(np.float32)
    return arr


# ---------------------------------------------------------------------------
# blockwise INT8 payload (the reference's numpy, letter for letter)
# ---------------------------------------------------------------------------

def _fp16_scale(scale: np.ndarray, round_up: bool = False) -> np.ndarray:
    """Cast per-block scales to fp16 without breaking the quantizers'
    invariants: a positive scale must never flush to zero (dequantizing a
    whole block to exact 0), never become inf (dequantizing to nan), and —
    for the ceil-rounding sqrt encoder — never round DOWN (which would let
    ``v_hat < v`` through the clip at qmax)."""
    s16 = scale.astype(np.float16)
    tiny = np.float16(6e-08)          # smallest positive fp16 subnormal
    s16 = np.where((scale > 0) & (s16 == 0), tiny, s16)
    if round_up:
        lt = s16.astype(np.float32) < scale
        s16 = np.where(lt, np.nextafter(s16, np.float16(np.inf)), s16)
    # inf clamp LAST: round_up can nextafter max-finite into inf
    s16 = np.where(np.isinf(s16), np.float16(65504), s16)
    return s16.astype(np.float16)


def quantize_shard(x: np.ndarray, block: int) -> Tuple[np.ndarray, np.ndarray]:
    """Blockwise symmetric INT8 over the trailing dim; fp16 scales.

    Per-block scale = absmax/127 (a division), round-half-even; the stored
    scale is fp16 (clamped away from 0/inf, see :func:`_fp16_scale`) and
    the payload is computed AGAINST that stored scale, so the roundtrip
    error per element stays <= stored_scale/2 (+ the qmax clip slack of
    ~2^-11 · absmax when fp16 rounded the scale down).
    """
    lead, n = x.shape[:-1], x.shape[-1]
    nb = n // block
    xb = np.asarray(x, np.float32).reshape(*lead, nb, block)
    absmax = np.abs(xb).max(axis=-1, keepdims=True)
    scale = _fp16_scale(absmax / _QMAX8)
    s32 = scale.astype(np.float32)
    inv = np.where(s32 > 0, 1.0 / np.where(s32 > 0, s32, 1.0), 0.0)
    q = np.clip(np.round(xb * inv), -_QMAX8, _QMAX8).astype(np.int8)
    return q.reshape(*lead, n), scale.squeeze(-1)


def dequantize_shard(q: np.ndarray, scales: np.ndarray, block: int,
                     dtype=np.float32) -> np.ndarray:
    lead, n = q.shape[:-1], q.shape[-1]
    nb = n // block
    x = q.reshape(*lead, nb, block).astype(np.float32) \
        * scales[..., None].astype(np.float32)
    return x.reshape(*lead, n).astype(dtype)


_QMAXU8 = 255.0


def quantize_shard_sqrt(x: np.ndarray, block: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Unsigned sqrt-domain blockwise quantization for NONNEGATIVE buffers
    (the Adam second moment): store ``ceil(sqrt(v)/scale)`` in uint8.

    Two deliberate asymmetries vs :func:`quantize_shard`:
      * sqrt domain — v spans ~(max/block ratio)^2, sqrt halves the log
        range so small entries survive 8 bits;
      * ceil rounding — guarantees ``v_hat >= v``.  Adam divides by
        ``sqrt(v_hat)+eps``: an UNDERestimated second moment multiplies the
        step by up to 1/eps and detonates the restored run; overestimation
        merely damps the step by <= scale/sqrt(v).
    """
    lead, n = x.shape[:-1], x.shape[-1]
    nb = n // block
    u = np.sqrt(np.maximum(np.asarray(x, np.float32), 0.0)
                ).reshape(*lead, nb, block)
    # scales round UP into fp16: a scale that flushed to 0 or rounded
    # down would re-admit the v_hat < v underestimate this encoder bans
    scale = _fp16_scale(u.max(axis=-1, keepdims=True) / _QMAXU8,
                        round_up=True)
    s32 = scale.astype(np.float32)
    inv = np.where(s32 > 0, 1.0 / np.where(s32 > 0, s32, 1.0), 0.0)
    q = np.clip(np.ceil(u * inv), 0, _QMAXU8).astype(np.uint8)
    return q.reshape(*lead, n), scale.squeeze(-1)


def dequantize_shard_sqrt(q: np.ndarray, scales: np.ndarray, block: int,
                          dtype=np.float32) -> np.ndarray:
    lead, n = q.shape[:-1], q.shape[-1]
    nb = n // block
    u = q.reshape(*lead, nb, block).astype(np.float32) \
        * scales[..., None].astype(np.float32)
    return (u * u).reshape(*lead, n).astype(dtype)


# ---------------------------------------------------------------------------
# elastic re-fit
# ---------------------------------------------------------------------------

def fit_to(arr: np.ndarray, target_shape) -> np.ndarray:
    """Re-fit a flat (…, padded) buffer onto a different padding length.

    Elastic restart: world sizes (and hence alignments) differ between save
    and restore, so the trailing padded dim differs.  Real parameters occupy
    the leading ``spec.size`` elements and padding is zeros, so truncating
    or zero-extending the trailing dim is exact as long as the new padding
    is not smaller than the logical size (guaranteed: padding >= size for
    any world).
    """
    tgt = tuple(target_shape)
    assert arr.shape[:-1] == tgt[:-1], (arr.shape, tgt)
    cur, new = arr.shape[-1], tgt[-1]
    if cur == new:
        return arr
    if cur > new:
        return np.ascontiguousarray(arr[..., :new])
    pad = [(0, 0)] * (arr.ndim - 1) + [(0, new - cur)]
    return np.pad(arr, pad)


def fit_shard(arr: np.ndarray, target_shape, rank: int,
              world: int) -> np.ndarray:
    """``shard_of(fit_to(arr, target_shape), rank, world)`` without the
    re-fitted global buffer: a view of ``arr`` where the shard lies inside
    it, else a copy zero-extended past its end."""
    tgt = tuple(target_shape)
    assert arr.shape[:-1] == tgt[:-1], (arr.shape, tgt)
    assert tgt[-1] % world == 0, (tgt, world)
    per = tgt[-1] // world
    lo, hi, cur = rank * per, (rank + 1) * per, arr.shape[-1]
    if hi <= cur:
        return arr[..., lo:hi]
    out = np.zeros(arr.shape[:-1] + (per,), arr.dtype)
    if lo < cur:
        out[..., :cur - lo] = arr[..., lo:cur]
    return out


def copy_rows(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` one row of the trailing axis at a time: a shard
    cut on that axis is strided, and a strided copy between the host and
    the card goes through a host temporary, which the rows' contiguous
    copies skip."""
    if dst.dim() <= 1:
        dst.copy_(src)
        return
    for idx in itertools.product(*map(range, dst.shape[:-1])):
        dst[idx].copy_(src[idx])


def _on_device(x: np.ndarray, dev) -> torch.Tensor:
    """A tensor of its own on ``dev`` holding ``x`` (a view, maybe strided:
    on the card copied straight from it, row by row, with no host copy
    first)."""
    if torch.device(dev).type == "cpu":
        return torch.tensor(x)
    src = torch.from_numpy(x)
    out = torch.empty(src.shape, dtype=src.dtype, device=dev)
    copy_rows(out, src)
    return out


# ---------------------------------------------------------------------------
# checkpoint discovery
# ---------------------------------------------------------------------------

def _ckpt_step(name: str, prefix: str) -> Optional[int]:
    """Step number of a checkpoint entry name, or None for foreign files
    (non-integer suffixes must be skipped, not crash the sort)."""
    if not name.startswith(prefix):
        return None
    stem = name[len(prefix):]
    if stem.endswith(".npz"):
        stem = stem[:-4]
    try:
        return int(stem)
    except ValueError:
        return None


def latest_checkpoint(directory: str, prefix: str = "ckpt_") -> Optional[str]:
    """Newest complete checkpoint under ``directory``: either a per-shard
    manifest dir (``ckpt_<step>/manifest.json``) or a legacy ``.npz``.
    Foreign / partially-written entries are ignored."""
    if not directory or not os.path.isdir(directory):
        return None
    best: Tuple[int, str] = (-1, "")
    for name in os.listdir(directory):
        step = _ckpt_step(name, prefix)
        if step is None:
            continue
        full = os.path.join(directory, name)
        if os.path.isdir(full):
            if not os.path.exists(os.path.join(full, MANIFEST)):
                continue  # incomplete (crashed before the manifest rename)
        elif not name.endswith(".npz"):
            continue
        if step > best[0]:
            best = (step, full)
    return best[1] or None


def quarantine_checkpoint(path: str) -> str:
    """Move a corrupt checkpoint (dir or npz) aside as ``<path>.corrupt``.

    The suffix fails :func:`_ckpt_step`'s int() parse, so a quarantined
    checkpoint is never selected by :func:`latest_checkpoint` again, and
    the evidence stays on disk for a post-mortem instead of being deleted.
    """
    dst = path + ".corrupt"
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = f"{path}.corrupt{n}"
    os.rename(path, dst)
    return dst


# ---------------------------------------------------------------------------
# legacy single-file GLOBAL npz (train/checkpoint.py's original format)
# ---------------------------------------------------------------------------

def save_legacy_npz(path: str, step: int, state: Dict[str, Any],
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Atomic single-file save of GLOBAL buffers (tensors or arrays; compat
    path — O(model) host RAM; prefer :meth:`ZeroState.save`)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: _host(v) for k, v in flatten_state(state).items()}
    flat["__step__"] = np.asarray(step, np.int64)
    if meta:
        flat["__meta__"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)   # atomic on POSIX
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_legacy_npz(path: str, prefix: Optional[str] = None
                    ) -> Tuple[int, Dict[str, Any], Dict[str, Any]]:
    want = _key_filter(prefix)
    try:
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files
                    if k in ("__step__", "__meta__") or want(k)}
    except FileNotFoundError:
        raise
    except _SHARD_READ_ERRORS as e:
        raise CheckpointCorruptError(
            f"legacy checkpoint {path} is unreadable "
            f"(truncated or corrupted npz): {e}") from e
    step = int(flat.pop("__step__"))
    meta = {}
    if "__meta__" in flat:
        meta = json.loads(flat.pop("__meta__").tobytes().decode())
    return step, unflatten_state(flat), meta


# ---------------------------------------------------------------------------
# per-shard manifest format: load
# ---------------------------------------------------------------------------

def _key_filter(prefix: Optional[str]):
    if prefix is None:
        return lambda key: True
    return lambda key: key == prefix or key.startswith(prefix + _SEP)


def load_global(path: str, prefix: Optional[str] = None
                ) -> Tuple[int, Dict[str, Any], Dict[str, Any]]:
    """Load a checkpoint (per-shard dir or legacy npz) into GLOBAL numpy
    buffers.  Quantized payloads are dequantized to their logical dtype
    (bf16: float32, see :func:`_decode`).  ``prefix`` restricts loading to
    one state subtree (e.g. ``"params"`` for serving — the optimizer
    payload is then never read or dequantized).

    Returns (step, state_tree, meta).
    """
    if not os.path.isdir(path):
        return load_legacy_npz(path, prefix)
    man = read_manifest(path)
    world = int(man["world"])
    block = man.get("quant_block")
    sums = man.get("checksums") or {}
    want = _key_filter(prefix)
    raw: Dict[str, np.ndarray] = {}
    for fname in man["shard_files"]:
        full = os.path.join(path, fname)
        if not os.path.exists(full):
            raise CheckpointCorruptError(
                f"checkpoint {path} is missing shard file {fname}")
        want_crc = sums.get(fname)
        if want_crc is not None:
            got = _crc32_file(full)
            if got != int(want_crc):
                raise CheckpointCorruptError(
                    f"checkpoint {path}: shard {fname} checksum mismatch "
                    f"(manifest {int(want_crc):#010x}, file {got:#010x}) — "
                    f"truncated or corrupted on disk")
        try:
            with np.load(full) as z:
                for k in z.files:   # npz members load lazily — only wanted
                    if want(k.split(_RANK, 1)[0]):
                        raw[k] = z[k]
        except _SHARD_READ_ERRORS as e:
            raise CheckpointCorruptError(
                f"checkpoint {path}: shard {fname} is unreadable: {e}"
            ) from e
    flat: Dict[str, np.ndarray] = {}
    for key, info in man["layout"].items():
        if not want(key):
            continue
        dt = info["dtype"]
        if info["replicated"]:
            flat[key] = _decode(raw[key], dt)
            continue
        ranks = []
        for r in range(world):
            pk = f"{key}{_RANK}{r}"
            if pk not in raw:
                raise CheckpointCorruptError(
                    f"checkpoint {path} is missing shard {pk} "
                    f"(world={world}, files={man['shard_files']})")
            sk = pk + _SCALES
            if sk in raw:
                dq = dequantize_shard_sqrt \
                    if info.get("encoding") == "uint8_sqrt_blockwise" \
                    else dequantize_shard
                ranks.append(dq(raw[pk], raw[sk], block, _np_dtype(dt)))
            else:
                ranks.append(_decode(raw[pk], dt))
        # one shard (world 1) is the buffer: no copy
        flat[key] = ranks[0] if world == 1 else np.concatenate(ranks,
                                                               axis=-1)
    return int(man["step"]), unflatten_state(flat), man.get("meta", {})


def read_manifest(path: str) -> Dict[str, Any]:
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            return json.load(f)
    except json.JSONDecodeError as e:
        raise CheckpointCorruptError(
            f"checkpoint {path}: manifest is not valid JSON "
            f"(crashed mid-write?): {e}") from e


# ---------------------------------------------------------------------------
# ZeroState
# ---------------------------------------------------------------------------

def init_shards(model, seed: int) -> Dict[str, torch.Tensor]:
    """This rank's fp32 master shards: the GLOBAL buffers drawn from a
    generator seeded with ``seed`` (so every world starts from the same
    global parameters), then this rank's primary shard of each, cut on
    the trailing axis."""
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    params = model.init_params(gen, dtype=torch.float32)
    if model.world == 1:
        return params
    rank = cl.flat_rank(model.zcfg.group)
    return {k: shard_of(v, rank, model.world).clone()
            for k, v in params.items()}


def _share_failure(exc: Optional[BaseException], world: int,
                   group=None) -> list:
    """Every rank's outcome of one step of a save (None: it went through),
    gathered on every rank of ``group`` (the default group: None); the
    rank whose step failed re-raises its own exception, the others raise
    :class:`SaveCancelled` (a rank's save was cancelled), OSError (every
    failure was one: the save retries) or :class:`CheckpointError`.
    Returns what every rank sent on success (``exc`` None everywhere)."""
    if world == 1:
        if exc is not None:
            raise exc
        return [None]
    kind = ("cancelled" if isinstance(exc, SaveCancelled) else
            "os" if isinstance(exc, OSError) else "error")
    mine = None if exc is None else (kind, f"{type(exc).__name__}: {exc}")
    every = [None] * world
    dist.all_gather_object(every, mine, group=group)
    if exc is not None:
        raise exc
    bad = {r: m for r, m in enumerate(every) if m is not None}
    if bad:
        msg = "; ".join(f"rank {r}: {m[1]}" for r, m in bad.items())
        kinds = {m[0] for m in bad.values()}
        if "cancelled" in kinds:
            raise SaveCancelled(f"checkpoint write cancelled on {msg}")
        if kinds == {"os"}:
            raise OSError(f"checkpoint write failed on {msg}")
        raise CheckpointError(f"checkpoint write failed on {msg}")
    return every


@dataclasses.dataclass
class ZeroState:
    """This rank's share of the sharded ZeRO model state and everything
    needed to move it: ``(model, mesh)`` (a ``launch.mesh.Mesh`` of the
    model's world) and the live ``params``/``opt`` (this rank's shards as
    the trainer holds them: fp32 master buffers and AdamW's ``m``, ``v``
    and ``count``, on the model's device).  Provides the seeded init,
    per-shard checkpointing and elastic restore."""

    model: Any
    mesh: Any
    params: Optional[Dict[str, torch.Tensor]] = None
    opt: Optional[Dict[str, Any]] = None
    step: int = 0
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.model.world != self.mesh.world:
            raise ValueError(f"model of world {self.model.world} on a mesh "
                             f"of {self.mesh.world} ranks")

    @property
    def world(self) -> int:
        return self.mesh.world

    @property
    def rank(self) -> int:
        """This rank's index in the ZeRO world: its shard of every buffer."""
        return cl.flat_rank(self.model.zcfg.group) if self.world > 1 else 0

    # -------------------------------------------------------------- init

    def init(self, seed: int) -> "ZeroState":
        """Seeded fp32 init of (params, opt) into this rank's shards (the
        same global parameters at every world)."""
        self.params = init_shards(self.model, seed)
        self.opt = init_opt_state(self.params)
        return self

    def place_global(self, params: Mapping[str, np.ndarray],
                     opt: Optional[Mapping[str, Any]] = None
                     ) -> "ZeroState":
        """Adopt host-GLOBAL buffers: elastic re-fit each flat buffer onto
        this model's padding (see :func:`fit_to`) and keep this rank's
        shard of it, on the model's device.  This is the restore path minus
        the file I/O, shared with tests so checkpoint roundtrips can be
        proven bit-exact against it."""
        want = self.model.param_shapes()
        if set(params) != set(want):
            raise ValueError(f"buffers {sorted(params)} != the model's "
                             f"{sorted(want)}")
        dev, rank, world = self.model.device, self.rank, self.world

        def cut(tree):   # a copy: the trainer updates it in place
            return {k: _on_device(fit_shard(np.asarray(tree[k]), want[k],
                                            rank, world), dev)
                    for k in want}

        self.params = cut(params)
        if opt is not None:
            self.opt = {"m": cut(opt["m"]), "v": cut(opt["v"]),
                        "count": torch.tensor(int(np.asarray(opt["count"])),
                                              dtype=torch.int32, device=dev)}
        return self

    # -------------------------------------------------------------- save

    def save(self, ckpt_dir: str, step: Optional[int] = None,
             meta: Optional[Dict[str, Any]] = None,
             fmt: str = FORMAT_FP32,
             quant_block: Optional[int] = None,
             io_hooks: Optional[Any] = None,
             retries: int = 0,
             backoff: float = 0.05,
             group=None) -> str:
        """Per-shard atomic save to ``ckpt_dir/ckpt_<step>/``; every rank of
        the world calls it, and none returns before the checkpoint exists.
        Its collectives (the failure exchange and the checksum gather) run
        on ``group``, a group of the whole world (None: the default group):
        a save on a background thread needs a group of its own, so that its
        messages never interleave with the training step's.

        Commit protocol (what a crash at any point leaves behind):
          1. rank 0 sweeps a stale staging dir and makes a fresh one, then
             a barrier;
          2. every rank writes ``shard_<rank>.npz`` (its ``key@rank``
             members; rank 0 also the replicated ``opt::count``) into the
             shared ``.tmp`` staging dir, fsynced — a crash here leaves
             only ``.tmp`` debris that :func:`latest_checkpoint` never
             selects and the next save sweeps away;
          3. the ranks' crc32 checksums gathered (a barrier) into the
             manifest;
          4. ``manifest.json`` written + fsynced LAST (rank 0) — its
             presence is the commit record;
          5. atomic ``os.replace`` of staging onto the final name, then a
             directory fsync (rank 0); a previous checkpoint for the same
             step is moved aside first so there is never a window with
             neither; a last barrier.

        ``retries`` re-runs the staged write on OSError (on any rank: they
        retry together) with exponential ``backoff`` (the host payload is
        built once; only file I/O is retried); exhaustion raises
        :class:`CheckpointError`.  ``io_hooks`` is the fault-injection
        seam (see :class:`IOHooks`); a hook that raises
        :class:`SaveCancelled` ends the save on every rank at once, with no
        retry and nothing published.

        ``fmt="int8_blockwise"`` (alias ``"int8"``) stores every sharded
        float buffer as an 8-bit payload + fp16 per-block scales — the qwZ
        wire format applied to disk, ~4x smaller.  Params and first moments
        use symmetric INT8; the second moment uses the sqrt-domain uint8
        encoder (``v_hat >= v``, see :func:`quantize_shard_sqrt`).  fp32
        stays the exact default.
        """
        if fmt == "int8":
            fmt = FORMAT_INT8
        if fmt not in (FORMAT_FP32, FORMAT_INT8):
            raise ValueError(f"unknown checkpoint format {fmt!r}")
        if quant_block is None:
            quant_block = getattr(self.model.zcfg, "qwz_block", 256)
        step = self.step if step is None else step
        meta = dict(self.meta, **(meta or {}))
        world, rank = self.world, self.rank

        state: Dict[str, Any] = {"params": self.params}
        if self.opt is not None:
            state["opt"] = self.opt
        flat = flatten_state(state)

        # host payload first (one copy off the device) — retries redo file
        # I/O only
        payload: Dict[str, np.ndarray] = {}
        layout: Dict[str, Any] = {}
        v_prefix = f"opt{_SEP}v"
        for key, t in flat.items():
            sharded = t.dim() > 0          # opt::count is the replicated one
            a = _host(t)
            # the nonnegative second moment takes the sqrt-domain
            # encoder (see quantize_shard_sqrt for why)
            sqrt_domain = key == v_prefix \
                or key.startswith(v_prefix + _SEP)
            encoding = "raw"
            if not sharded:            # replicated: stored once, by rank 0
                if rank == 0:
                    payload[key] = a
            else:
                pk = f"{key}{_RANK}{rank}"
                if (fmt == FORMAT_INT8 and a.dtype.kind == "f"
                        and a.shape[-1] % quant_block == 0):
                    if sqrt_domain:
                        q, sc = quantize_shard_sqrt(a, quant_block)
                        encoding = "uint8_sqrt_blockwise"
                    else:
                        q, sc = quantize_shard(a, quant_block)
                        encoding = "int8_blockwise"
                    payload[pk] = q
                    payload[pk + _SCALES] = sc
                else:
                    payload[pk] = a
            shape = list(t.shape)
            if sharded:
                shape[-1] *= world
            layout[key] = {
                "shape": [int(d) for d in shape],
                "dtype": _dtype_str(t),
                "replicated": not sharded,
                "quantized": encoding != "raw",
                "encoding": encoding,
            }
        manifest = {
            "version": 1,
            "step": int(step),
            "world": world,
            "mesh": {a: int(s) for a, s in zip(self.mesh.axes,
                                               self.mesh.shape)},
            "format": fmt,
            "quant_block": quant_block if fmt == FORMAT_INT8 else None,
            "scale_dtype": "float16",
            "num_processes": world,
            "shard_files": [f"shard_{p:05d}.npz" for p in range(world)],
            "checksums": {},
            "layout": layout,
            "param_layout": model_param_layout(self.model),
            "meta": meta,
        }

        final = os.path.join(ckpt_dir, f"ckpt_{step}")
        os.makedirs(ckpt_dir, exist_ok=True)
        # deterministic SHARED staging dir: every rank writes its shard
        # file into the same place, rank 0 publishes.  The .tmp/.old
        # suffixed names fail latest_checkpoint's int() parse, so they are
        # never restored.
        staging = final + ".tmp"
        last_err: Optional[BaseException] = None
        for attempt in range(max(0, int(retries)) + 1):
            if attempt:
                time.sleep(backoff * (2 ** (attempt - 1)))
            try:
                return self._write_staged(ckpt_dir, final, staging,
                                          payload, manifest, io_hooks, group)
            except OSError as e:       # transient I/O — retry from scratch
                last_err = e
                if rank == 0:
                    shutil.rmtree(staging, ignore_errors=True)
        raise CheckpointError(
            f"checkpoint write to {final} failed after "
            f"{max(0, int(retries)) + 1} attempt(s): {last_err}"
        ) from last_err

    def _write_staged(self, ckpt_dir: str, final: str, staging: str,
                      payload: Dict[str, np.ndarray],
                      manifest: Dict[str, Any],
                      io_hooks: Optional[Any], group=None) -> str:
        """One attempt at the staged write + publish (see :meth:`save`);
        every step that can fail on one rank ends with every rank knowing
        (:func:`_share_failure`), so that the ranks leave together, and
        rank 0 then sweeps the staging dir (the other ranks have stopped
        writing into it)."""
        world, rank = self.world, self.rank
        err: Optional[BaseException] = None
        try:
            if rank == 0:   # alone: a peer's makedirs would race the sweep
                if os.path.isdir(staging):
                    shutil.rmtree(staging)  # stale leftover of a crashed save
                os.makedirs(staging, exist_ok=True)
        except Exception as e:            # shared below, then re-raised
            err = e
        try:
            # no rank writes before rank 0 has swept and made the staging dir
            _share_failure(err, world, group)
            shard_name = f"shard_{rank:05d}.npz"
            crc = None
            try:
                spath = os.path.join(staging, shard_name)
                with open(spath, "wb") as f:
                    _write_npz(f, payload, lambda: _call_hook(
                        io_hooks, "mid_shard", spath))
                    f.flush()
                    os.fsync(f.fileno())   # durable BEFORE the manifest
                _call_hook(io_hooks, "post_shard", spath)
                crc = _crc32_file(spath)
            except Exception as e:
                err = e
            if world > 1:
                crcs = [None] * world
                dist.all_gather_object(crcs, crc, group=group)
            else:
                crcs = [crc]
            _share_failure(err, world, group)
            try:
                if rank == 0:   # the manifest is rank 0's, written last
                    self._publish(ckpt_dir, final, staging, manifest, crcs,
                                  io_hooks)
            except Exception as e:
                err = e
            # no rank returns before the checkpoint is published
            _share_failure(err, world, group)
        finally:
            if rank == 0 and os.path.isdir(staging):
                shutil.rmtree(staging, ignore_errors=True)
        return final

    @staticmethod
    def _publish(ckpt_dir: str, final: str, staging: str,
                 manifest: Dict[str, Any], crcs: list,
                 io_hooks: Optional[Any]) -> None:
        """Rank 0's commit: the manifest with every shard's crc32, fsynced,
        then the atomic rename of the staging dir onto ``final``."""
        manifest = dict(manifest)
        manifest["checksums"] = {
            f"shard_{r:05d}.npz": c for r, c in enumerate(crcs)}
        _call_hook(io_hooks, "pre_manifest", staging)
        mpath = os.path.join(staging, MANIFEST)
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(staging)
        _call_hook(io_hooks, "pre_publish", staging, final)
        # publish: move any previous ckpt for this step ASIDE before the
        # rename — never a window with neither the old nor the new
        # checkpoint on disk
        old = final + ".old"
        if os.path.isdir(old):
            shutil.rmtree(old)
        if os.path.isdir(final):
            os.rename(final, old)
        os.replace(staging, final)   # atomic publish
        shutil.rmtree(old, ignore_errors=True)
        _fsync_dir(ckpt_dir)

    # ----------------------------------------------------------- restore

    @classmethod
    def restore(cls, model, mesh, ckpt: str) -> Optional["ZeroState"]:
        """Elastic restore: load the latest checkpoint under ``ckpt`` (or
        ``ckpt`` itself if it is a checkpoint path) onto (model, mesh) —
        the saved world size/alignment may differ from the current one.
        None when there is no checkpoint."""
        path = cls._resolve(ckpt)
        if path is None:
            return None
        step, tree, meta = load_global(path)
        st = cls(model, mesh, step=step, meta=meta)
        return st.place_global(tree["params"], tree.get("opt"))

    @classmethod
    def restore_resilient(cls, model, mesh, ckpt: str,
                          quarantine: bool = True,
                          max_fallbacks: int = 8,
                          group=None) -> Optional["ZeroState"]:
        """:meth:`restore` with quarantine-and-fall-back: a checkpoint that
        fails validation (:class:`CheckpointCorruptError`) is moved aside
        as ``.corrupt`` (see :func:`quarantine_checkpoint`) and the next
        older checkpoint is tried, until one loads or none remain (then
        returns None — the caller starts from scratch).  Beyond one rank,
        rank 0 alone validates and quarantines, then tells every rank of
        ``group`` (the default group: None) which checkpoint to load: one
        process moves a corrupt checkpoint aside, and every rank restores
        the same one."""
        world = mesh.world
        rank = cl.flat_rank(group) if world > 1 else 0
        found: Any = None
        err: Optional[BaseException] = None
        if rank == 0:
            try:
                found = cls._validated(ckpt, quarantine, max_fallbacks)
            except CheckpointCorruptError as e:   # shared, then re-raised
                err = e
        if world > 1:
            # the path (or None, or the error) to every rank
            box = [None if found is None else found[0], err is not None]
            dist.broadcast_object_list(box, src=0, group=group)
            if err is not None:
                raise err
            if box[1]:
                raise CheckpointCorruptError(
                    f"rank 0 could not restore from {ckpt}")
            if box[0] is None:
                return None
            if found is None:
                found = (box[0],) + load_global(box[0])
        elif err is not None:
            raise err
        if found is None:
            return None
        _, step, tree, meta = found
        st = cls(model, mesh, step=step, meta=meta)
        return st.place_global(tree["params"], tree.get("opt"))

    @classmethod
    def _validated(cls, ckpt: str, quarantine: bool, max_fallbacks: int):
        """(path, step, tree, meta) of the newest checkpoint under ``ckpt``
        that loads, quarantining each one that fails validation on the
        way; None when none remains."""
        tried = 0
        while True:
            path = cls._resolve(ckpt)
            if path is None:
                return None
            try:
                return (path,) + load_global(path)
            except CheckpointCorruptError as e:
                if not quarantine or tried >= max_fallbacks:
                    raise
                tried += 1
                q = quarantine_checkpoint(path)
                print(f"[state] corrupt checkpoint quarantined "
                      f"{path} -> {q}: {e}", flush=True)

    @staticmethod
    def _resolve(ckpt: str) -> Optional[str]:
        if ckpt and os.path.isdir(ckpt) \
                and os.path.exists(os.path.join(ckpt, MANIFEST)):
            return ckpt          # a checkpoint dir itself
        if ckpt and os.path.isfile(ckpt):
            return ckpt          # a legacy npz
        return latest_checkpoint(ckpt)


# ---------------------------------------------------------------------------
# serving load path (params only, bf16)
# ---------------------------------------------------------------------------

def load_serving_params(model, ckpt: str, dtype=torch.bfloat16,
                        expect_arch: Optional[str] = None, mesh=None
                        ) -> Dict[str, torch.Tensor]:
    """Params-only load for the serving stack: elastic re-fit onto
    ``model`` and cast to ``dtype`` (bf16 default — serving never needs
    the fp32 master or the optimizer moments), on the model's device.  On
    a ``mesh`` (``launch.mesh.Mesh``, world ``model.world``) the result is
    this rank's shard of every flat buffer, cut as :meth:`ZeroState.restore`
    places them (``partition.shard_of``), so a checkpoint saved at any
    world boots an engine of any world; without one (or at world 1) the
    global buffers.

    ``expect_arch`` guards engine boots: if the checkpoint's meta records
    an architecture name and it differs, fail loudly instead of fitting a
    foreign model's buffers into this one's layout (``fit_to`` would
    silently truncate/zero-extend them).  A manifest's meta is read before
    any shard."""
    world = 1 if mesh is None else mesh.world
    if world != model.world:
        raise ValueError(f"the model's flat layout is for world "
                         f"{model.world}, the mesh holds {world} ranks")
    rank = cl.flat_rank() if world > 1 else 0
    path = ZeroState._resolve(ckpt)
    if path is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt!r}")

    def check(meta):
        ck_arch = (meta or {}).get("arch")
        if expect_arch is not None and ck_arch is not None \
                and ck_arch != expect_arch:
            raise ValueError(
                f"checkpoint {path!r} was written for arch {ck_arch!r}, "
                f"engine expects {expect_arch!r}")

    if os.path.isdir(path):
        check(read_manifest(path).get("meta"))
    _, tree, meta = load_global(path, prefix="params")
    check(meta)
    want = model.param_shapes()
    out = {}
    for k, arr in tree["params"].items():
        out[k] = torch.tensor(shard_of(fit_to(np.asarray(arr), want[k]),
                                       rank, world),
                              device=model.device, dtype=dtype)
    return out
