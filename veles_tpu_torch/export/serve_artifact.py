"""Serve artifacts: the serving engines' programs exported ahead of time
into a package (counterpart of ``veles_tpu/export/serve_artifact.py``).

The paged engine's program surface is one prefill a bucket and the one
fixed-shape decode step; the O(1)-state lane's is its chunk scan and its
8-row decode tile. Each is a tensor function of (parameter tree, ids or
tokens, positions or lengths, page tables or the live mask, pool or
state rows) that returns the logits and the new rows, and is saved as a
``torch.export`` program:

    <pkg>/contents.json             format version 3 with a "serving"
                                    block: the artifact version, the
                                    torch version, the engine's signature
                                    and the program table
    <pkg>/serve_prefill_<B>.pt2     the prefill of bucket B
    <pkg>/serve_decode.pt2          the decode step
    <pkg>/serve_rscan.pt2           the lane's chunk scan (a recurrent
    <pkg>/serve_rstep.pt2           stack's artifact holds these two)

The parameters stay runtime inputs, so an artifact survives further
training; only shapes, knobs, the quantization policy and the device
type (positions, tables and constants are traced on the export device)
are committed, and the signature stamped at export catches any change.
On the card each prefill's attention is one node of the registered flash
forward op (``torch.ops.veles_tpu_torch.flash_attention_fwd``), launched
and counted like any other call.

Write one with ``python -m veles_tpu_torch export serve-artifact MODEL.py
--out DIR``; serve it with ``--serve-artifact DIR`` (or
``root.common.serving.artifact``). The port's programs are not
``jax.export`` blobs, so the artifact has a version of its own
(:data:`ARTIFACT_VERSION`) and the contents stamp ``torch_version``: the
reference's artifact, a corrupt program, another signature or a newer
version is refused by :func:`load_serve_programs`, which the engines turn
into their counted fallback to live serving.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, Optional, Tuple

import torch

from ..error import VelesError

#: the layout of the serving block and the programs' calling convention;
#: a reader refuses a newer artifact instead of guessing. v1: the paged
#: engine's prefill_<bucket> and decode, the lane's rscan and rstep.
ARTIFACT_VERSION = 1


def _stack_of(model, device):
    """The generation stack of ``model`` (a trained workflow's, through
    ``forwards_of``, or a stack as it is) on ``device``."""
    if getattr(model, "train_step", None) is not None:
        from ..nn.standard_workflow import forwards_of
        model = forwards_of(model)
    return model.to(device)


def _identity(model, signature) -> Tuple[str, str]:
    """(name, checksum) stamped in the contents: the workflow's, or for a
    bare stack a hash of its signature."""
    if callable(getattr(model, "checksum", None)):
        return str(model.name), model.checksum()
    digest = hashlib.sha256(json.dumps(signature, sort_keys=True).encode())
    return str(getattr(model, "name", "forwards")), digest.hexdigest()


def _save(program, path: str, fname: str) -> None:
    """Save one exported program; one that writes into an input would
    copy a whole pool each call, so it is refused."""
    mutated = program.graph_signature.user_inputs_to_mutate
    if mutated:
        raise VelesError("serve program %s mutates its inputs %s"
                         % (fname, sorted(mutated.values())))
    save_program(program, os.path.join(path, fname))


def save_program(program, path: str) -> None:
    """``torch.export.save`` without the example inputs the program was
    traced with: they are the parameters and the pool, which the program
    takes at run time and must not carry."""
    program.example_inputs = None
    torch.export.save(program, path)


def _export(prog, args, path: str, fname: str,
            seconds: Dict[str, float], label: str) -> str:
    t0 = time.perf_counter()
    with torch.no_grad():
        program = torch.export.export(prog, args)
    _save(program, path, fname)
    seconds[label] = time.perf_counter() - t0
    return fname


def _write_contents(model, path: str, signature, programs,
                    seconds) -> None:
    from .package import required_format_version
    name, checksum = _identity(model, signature)
    contents = {
        # a serving block is a v3 feature: v2 readers refuse
        "format_version": required_format_version(serving=True),
        "workflow": name,
        "checksum": checksum,
        # the parameters stay runtime inputs: no unit tensors ride along
        "units": [],
        "serving": {
            "artifact_version": ARTIFACT_VERSION,
            "torch_version": torch.__version__,
            "signature": signature,
            "programs": programs,
            "export_seconds": seconds,
        },
    }
    with open(os.path.join(path, "contents.json"), "w") as fout:
        json.dump(contents, fout, indent=2)


def export_serve_artifact(model, path: str,
                          max_slots: Optional[int] = None,
                          buckets=None,
                          max_context: Optional[int] = None,
                          decode_block: Optional[int] = None,
                          page_size: Optional[int] = None,
                          pages: Optional[int] = None,
                          quant_weights: Optional[bool] = None,
                          quant_kv: Optional[bool] = None,
                          device=None) -> str:
    """Export the serving programs of ``model`` (a trained workflow or a
    generation stack) into the package directory ``path``, traced on
    ``device`` — the card unless the caller passes ``device="cpu"``; the
    stack moves there. Knobs default as ``GenerationAPI``'s do
    (``root.common.serving``, ``root.common.quant``), so an artifact
    exported with the config a server boots with matches its signature.
    A transformer stack exports the paged engine's programs; a recurrent
    one (``Embedding`` → LSTM/RNN/SSM → ``LMHead``) the lane's."""
    from ..backends import device_for
    from ..config import root
    from ..serving.engine import ContinuousEngine, PrefillProgram, \
        StepProgram
    device = device_for(device)
    stack = _stack_of(model, device)
    cfg = root.common.serving
    knobs = {
        "max_slots": int(max_slots if max_slots is not None
                         else cfg.get("max_slots", 8)),
        "max_context": int(max_context if max_context is not None
                           else cfg.get("max_context", 640)),
        "decode_block": int(decode_block if decode_block is not None
                            else cfg.get("decode_block", 1)),
    }
    try:
        engine = ContinuousEngine(
            stack, buckets=(buckets if buckets is not None
                            else cfg.get("buckets", (16, 32, 64, 128))),
            page_size=page_size, pages=pages, quant_weights=quant_weights,
            quant_kv=quant_kv, name="serve_artifact_export", **knobs)
    except VelesError:
        from ..serving.recurrent import RecurrentEngine
        return _export_recurrent(
            RecurrentEngine(stack, page_size=page_size,
                            name="serve_artifact_export", **knobs),
            model, path)
    signature = engine.stack_signature()
    engine._prepare_params()
    engine._ensure_pool()
    tree = engine._tree
    dtype = engine.stack["stem"].table.dtype
    os.makedirs(path, exist_ok=True)
    programs: Dict[str, str] = {}
    seconds: Dict[str, float] = {}
    i64 = dict(dtype=torch.int64, device=engine.device)
    prefill = PrefillProgram(engine.stack, engine.quant_weights,
                             engine.quant_kv, dtype)
    for bucket in engine.buckets:
        label = "prefill_%d" % bucket
        programs[label] = _export(
            prefill, (tree, torch.zeros((1, bucket), **i64),
                      torch.zeros((1,), **i64)),
            path, "serve_prefill_%d.pt2" % bucket, seconds, label)
    slots = engine.max_slots
    programs["decode"] = _export(
        StepProgram(engine.stack, engine.quant_weights, dtype),
        (tree, torch.zeros((slots,), **i64), torch.zeros((slots,), **i64),
         torch.zeros((slots, engine.pages_per_slot), **i64),
         engine._caches),
        path, "serve_decode.pt2", seconds, "decode")
    _write_contents(model, path, signature, programs, seconds)
    return path


def _export_recurrent(engine, model, path: str) -> str:
    """Export the O(1)-state lane's two programs: the ``page_size``-token
    chunk scan (``rscan``) and the decode tile (``rstep``), both at
    :data:`~veles_tpu_torch.serving.recurrent.LANE_ROWS` rows over one
    tile's state rows, whatever the context length."""
    from ..serving.recurrent import LANE_ROWS, ScanProgram, TileStepProgram
    signature = engine.stack_signature()
    tree = engine._tree()
    engine._ensure_pool()
    states = [{k: v[:LANE_ROWS] for k, v in st.items()}
              for st in engine._states]
    i64 = dict(dtype=torch.int64, device=engine.device)
    os.makedirs(path, exist_ok=True)
    programs: Dict[str, str] = {}
    seconds: Dict[str, float] = {}
    programs["rscan"] = _export(
        ScanProgram(engine.stack),
        (tree, torch.zeros((LANE_ROWS, engine.page_size), **i64),
         torch.zeros((LANE_ROWS,), **i64), torch.zeros((1,), **i64),
         states),
        path, "serve_rscan.pt2", seconds, "rscan")
    programs["rstep"] = _export(
        TileStepProgram(engine.stack),
        (tree, torch.zeros((LANE_ROWS,), **i64),
         torch.zeros((LANE_ROWS,), dtype=torch.bool, device=engine.device),
         states),
        path, "serve_rstep.pt2", seconds, "rstep")
    _write_contents(model, path, signature, programs, seconds)
    return path


def _key_of(path: str, label: str):
    if label == "decode" or label == "rstep":
        return ("step", None)
    if label == "rscan":
        return ("scan", None)
    if label.startswith("prefill_"):
        return ("prefill", int(label[len("prefill_"):]))
    raise VelesError("serve-artifact %s: unknown program label %r"
                     % (path, label))


def load_serve_programs(path: str, expect_signature: Dict
                        ) -> Dict[Tuple[str, Optional[int]], object]:
    """Read an artifact directory and load every program, keyed as the
    engines key theirs (``("prefill", bucket)``, ``("step", None)``,
    ``("scan", None)``). The stored signature must equal
    ``expect_signature``, the loading engine's. Raises
    :class:`VelesError` on any problem: the engine turns it into its
    counted fallback."""
    # a loaded program calls the registered flash forward op
    from ..ops import flash_attention  # noqa: F401
    contents_path = os.path.join(path, "contents.json")
    try:
        with open(contents_path) as fin:
            contents = json.load(fin)
    except (OSError, ValueError) as e:
        raise VelesError("serve-artifact %s unreadable: %s"
                         % (contents_path, e)) from e
    serving = contents.get("serving")
    if not isinstance(serving, dict):
        raise VelesError(
            "package %s carries no serving block (format_version %s) — "
            "not a serve-artifact" % (path, contents.get("format_version")))
    if "torch_version" not in serving:
        raise VelesError(
            "serve-artifact %s holds no torch.export programs (exported "
            "by another package: %s)" % (path, sorted(serving)))
    version = int(serving.get("artifact_version", 0))
    if version > ARTIFACT_VERSION:
        raise VelesError("serve-artifact version %d is newer than this "
                         "reader (%d)" % (version, ARTIFACT_VERSION))
    stored = json.dumps(serving.get("signature"), sort_keys=True)
    expected = json.dumps(expect_signature, sort_keys=True)
    if stored != expected:
        raise VelesError(
            "serve-artifact %s was exported for another model, knob, "
            "quantization or device configuration — export it again "
            "(python -m veles_tpu_torch export serve-artifact)" % path)
    programs: Dict[Tuple[str, Optional[int]], object] = {}
    for label, fname in serving.get("programs", {}).items():
        key = _key_of(path, label)
        try:
            programs[key] = torch.export.load(
                os.path.join(path, fname)).module()
        except Exception as e:      # noqa: BLE001 — one fallback path
            raise VelesError("serve-artifact program %s corrupt: %s: %s"
                             % (fname, type(e).__name__, e)) from e
    if expect_signature.get("kind") == "recurrent":
        want = {("scan", None), ("step", None)}
    else:
        want = {("prefill", b) for b in expect_signature.get("buckets", ())}
        want.add(("step", None))
    missing = want - set(programs)
    if missing:
        raise VelesError("serve-artifact %s is missing programs: %s"
                         % (path, sorted(missing)))
    return programs
