"""Workflow package export and import (counterpart of
``veles_tpu/export/package.py``, in its format).

    <pkg>/contents.json       format version, workflow name and checksum,
                              the input spec, the ordered unit list (type,
                              config, parameter files, producers)
    <pkg>/<unit>_<param>.npy  parameter tensors (C order, native endian)
    <pkg>/forward.pt2         a ``torch.export`` program of the forward
                              DAG, parameters as its runtime inputs

A package is a directory, or a ``.zip``, ``.tgz`` or ``.tar.gz``
archive of one for transport (the C++ runtime reads the directory).

The reference stores a ``jax.export`` program under the contents key
``"stablehlo"``; the port stores its own under ``"torch_export"``, so
neither package mistakes the other's program, and the port's reader
ignores a ``forward.stablehlo``. Every other byte of the format is the
reference's: the same arrays, the same config keys, the same versions.
"""

from __future__ import annotations

import json
import os
import shutil
import zipfile
from typing import Any, Dict, List, Optional

import numpy
import torch

from ..error import VelesError

#: v2: per-unit "inputs" producer lists (DAG topologies); v3: per-unit
#: "quant" blocks (int8 tensors with scale sidecar files) and the
#: top-level "serving" block of serve artifacts. A package carrying
#: neither is still written as v2, so every v2 reader keeps working.
FORMAT_VERSION = 3

#: the contents key and file of the port's forward program
PROGRAM_KEY = "torch_export"
PROGRAM_FILE = "forward.pt2"


def required_format_version(quant: bool = False,
                            serving: bool = False) -> int:
    """The lowest format version whose readers understand what a package
    carries, the only version a writer may stamp."""
    if quant or serving:
        return 3
    return 2


def _write_zip(pkg_dir: str, path: str) -> None:
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        for fname in sorted(os.listdir(pkg_dir)):
            zf.write(os.path.join(pkg_dir, fname), fname)


def _write_tgz(pkg_dir: str, path: str) -> None:
    import tarfile
    with tarfile.open(path, "w:gz") as tf:
        for fname in sorted(os.listdir(pkg_dir)):
            tf.add(os.path.join(pkg_dir, fname), fname)


def _extract_zip(path: str, tmp: str) -> None:
    with zipfile.ZipFile(path) as zf:
        zf.extractall(tmp)


def _extract_tgz(path: str, tmp: str) -> None:
    import tarfile
    with tarfile.open(path) as tf:
        tf.extractall(tmp, filter="data")


#: suffix → (writer, extractor): one table for export and import
_ARCHIVES = ((".zip", _write_zip, _extract_zip),
             (".tgz", _write_tgz, _extract_tgz),
             (".tar.gz", _write_tgz, _extract_tgz))


def _archive_kind(path: str):
    for suffix, writer, extractor in _ARCHIVES:
        if path.endswith(suffix):
            return suffix, writer, extractor
    return None


#: unit config keys exported (the subset that defines inference); the C++
#: runtime reads them by these names
_EXPORT_KEYS = (
    "output_sample_shape", "n_kernels", "n_channels", "kx", "ky",
    "sliding", "padding", "include_bias", "factor", "alpha", "beta",
    "n", "k", "hidden_size", "return_sequences", "forget_bias",
    "n_heads", "n_kv_heads", "window", "norm", "ffn", "causal",
    "dropout_ratio",
    "n_experts", "hidden", "top_k", "capacity_factor", "ffn_hidden",
    "rope", "rope_base", "vocab_size", "dim",
)


def _config_of(fwd) -> Dict[str, Any]:
    """A unit's exported config: each key of :data:`_EXPORT_KEYS` the
    unit carries, tuples as lists. An attribute that is None (a block's
    unset ``window``) is left out, as the reference's unit does not
    carry it."""
    cfg = {}
    for key in _EXPORT_KEYS:
        val = getattr(fwd, key, None)
        if val is None:
            continue
        if isinstance(val, tuple):
            val = list(val)
        cfg[key] = val
    return cfg


def _unit_entry(fwd, pkg_dir: str, inputs: Optional[List[str]] = None,
                quant: Optional[str] = None) -> Dict[str, Any]:
    """Write one unit's arrays and return its ``contents.json`` entry.
    LoRA adapters are merged into the dense weights
    (``export_param_arrays``), so no reader sees them. Under ``quant``
    (a granularity) each eligible matmul weight is stored int8 with a
    float32 scale sidecar, counted as the quantizer counts it."""
    params = {}
    quant_meta: Dict[str, Any] = {}
    arrays = getattr(fwd, "export_param_arrays",
                     getattr(fwd, "param_arrays", dict))()
    for pname, arr in arrays.items():
        fname = "%s_%s.npy" % (fwd.name, pname)
        mem = numpy.ascontiguousarray(arr.map_read())
        if quant is not None:
            from ..quant import quantize_tensor
            qs = quantize_tensor(pname, mem, quant)
            if qs is not None:
                from ..telemetry.counters import inc
                q, scale = (t.cpu().numpy() for t in qs)
                sname = "%s_%s__scale.npy" % (fwd.name, pname)
                numpy.save(os.path.join(pkg_dir, fname), q)
                numpy.save(os.path.join(pkg_dir, sname), scale)
                params[pname] = fname
                quant_meta[pname] = {"scheme": "int8", "scale": sname,
                                     "granularity": quant,
                                     "dtype": str(mem.dtype)}
                inc("veles_quant_params_total")
                inc("veles_quant_bytes_saved_total",
                    max(0, mem.size * mem.dtype.itemsize
                        - (q.size + scale.size * 4)))
                continue
        numpy.save(os.path.join(pkg_dir, fname), mem)
        params[pname] = fname
    entry = {"name": fwd.name, "type": fwd.MAPPING,
             "config": _config_of(fwd), "params": params}
    if quant_meta:
        entry["quant"] = quant_meta
    if inputs is not None:
        entry["inputs"] = list(inputs)
    return entry


def _graph_inputs(units, graph) -> List[List[str]]:
    """Each unit's producer names: the explicit DAG when given, else the
    chain (the first unit reads ``"@input"``, each next the previous).
    A name that is not a preceding unit is refused: the executors need
    topological order."""
    if graph is None:
        return [["@input"] if i == 0 else [units[i - 1].name]
                for i in range(len(units))]
    seen = set()
    out = []
    for unit, ins in zip(units, graph):
        for nm in ins:
            if nm != "@input" and nm not in seen:
                raise VelesError(
                    "graph: unit %s input %r is not a preceding unit "
                    "(export order must be topological)" % (unit.name, nm))
        seen.add(unit.name)
        out.append(list(ins))
    return out


def _device_of(forwards):
    """The device the units' parameters live on (the program is traced
    there); the CPU for parameter-free chains."""
    for fwd in forwards:
        dev = getattr(fwd, "device", None)
        if dev is not None:
            return torch.device(dev)
    return torch.device("cpu")


def package_export(workflow, path: str,
                   input_shape: Optional[List[int]] = None,
                   with_program: bool = True,
                   graph: Optional[List[List[str]]] = None,
                   quant: bool = False) -> str:
    """Export the workflow's forward units (``workflow.forwards``) as a
    package at ``path`` (a directory, or an archive by its suffix);
    returns the path written.

    ``graph``: one producer list a forward unit (``"@input"`` = the
    workflow's input), in topological order, for fan-in topologies
    (``InputJoiner``); default the chain. ``quant``: eligible 2-D matmul
    weights int8 with per-channel scale sidecars (granularity from
    ``root.common.quant``), format version 3; import dequantizes.
    ``with_program``: also write ``forward.pt2``, the forward traced on
    the units' device at ``input_shape`` (a failed trace is a warning,
    the package stays valid without it)."""
    forwards = getattr(workflow, "forwards", None)
    if not forwards:
        raise VelesError("workflow %s has no forward chain to export"
                         % workflow.name)
    if graph is not None and len(graph) != len(forwards):
        raise VelesError("graph needs one producer list per forward "
                         "(%d != %d)" % (len(graph), len(forwards)))
    step = getattr(workflow, "train_step", None)
    if step is not None and step.params:
        step.sync_params_to_arrays()

    archive = _archive_kind(path)
    pkg_dir = path[:-len(archive[0])] if archive else path
    os.makedirs(pkg_dir, exist_ok=True)

    if input_shape is None:
        first = forwards[0]
        if first.input is None or not first.input:
            raise VelesError("cannot infer input shape; pass input_shape")
        input_shape = list(first.input.shape)

    granularity = None
    if quant:
        from ..quant.weights import granularity_from_config
        from ..resilience.faults import fire as fire_fault
        from ..telemetry.counters import inc
        fire_fault("quant.calibrate")
        granularity = granularity_from_config()
        inc("veles_quant_calibrations_total")
    in_names = _graph_inputs(forwards, graph)
    units = [_unit_entry(f, pkg_dir, inputs=ins, quant=granularity)
             for f, ins in zip(forwards, in_names)]
    quantized = any("quant" in u for u in units)
    contents = {
        "format_version": required_format_version(quant=quantized),
        "workflow": workflow.name,
        "checksum": workflow.checksum(),
        "input_shape": list(input_shape),
        "input_dtype": "float32",
        "units": units,
    }
    if quantized:
        contents["quant"] = {"granularity": granularity,
                             "params": sum(len(u.get("quant", {}))
                                           for u in units)}
    if with_program:
        try:
            contents[PROGRAM_KEY] = _export_program(
                forwards, input_shape, pkg_dir, in_names)
        except Exception as e:  # noqa: BLE001 - optional artifact
            workflow.warning("forward program export skipped: %s: %s",
                             type(e).__name__, e)
    with open(os.path.join(pkg_dir, "contents.json"), "w") as fout:
        json.dump(contents, fout, indent=2)

    if archive:
        archive[1](pkg_dir, path)
        shutil.rmtree(pkg_dir)
        return path
    return pkg_dir


def _apply(unit, params, xs):
    """One unit's forward in inference mode: a parameter-free fan-in
    (``InputJoiner``) takes its inputs alone."""
    if getattr(unit, "MAPPING", "") == "input_joiner":
        return unit.apply(*xs)
    return unit.apply(params, *xs)


class ForwardProgram(torch.nn.Module):
    """The forward DAG walk as a program, ``(params, x)`` → the last
    unit's output: ``params`` is one ``{param: tensor}`` dict a unit in
    package order, so the program holds no weight."""

    def __init__(self, units, in_names) -> None:
        super().__init__()
        self._units = list(units)
        self._in_names = [list(ins) for ins in in_names]

    def forward(self, params, x):
        env = {"@input": x}
        out = x
        for unit, p, ins in zip(self._units, params, self._in_names):
            out = _apply(unit, p, [env[nm] for nm in ins])
            env[unit.name] = out
        return out


def _export_program(forwards, input_shape, pkg_dir: str, in_names) -> str:
    """Trace the forward DAG with ``torch.export`` on the units' device
    (the parameters its runtime inputs) and save it as
    :data:`PROGRAM_FILE`. On the card each attention is one node of the
    registered flash forward op."""
    device = _device_of(forwards)
    params = [{k: torch.as_tensor(numpy.asarray(v.map_read()),
                                  device=device)
               for k, v in getattr(f, "export_param_arrays",
                                   getattr(f, "param_arrays", dict))().items()}
              for f in forwards]
    x = torch.zeros(tuple(input_shape), dtype=torch.float32, device=device)
    with torch.no_grad():
        program = torch.export.export(ForwardProgram(forwards, in_names),
                                      (params, x))
    from .serve_artifact import save_program
    save_program(program, os.path.join(pkg_dir, PROGRAM_FILE))
    return PROGRAM_FILE


def load_program(pkg_dir: str):
    """The package's ``forward.pt2`` as a callable ``(params, x)``, where
    ``params`` is :func:`program_params` of the imported package."""
    from ..ops import flash_attention  # noqa: F401 — registers the op
    return torch.export.load(os.path.join(pkg_dir, PROGRAM_FILE)).module()


def program_params(pkg, device) -> List[Dict[str, torch.Tensor]]:
    """The program's parameter input of an imported package: one
    ``{param: tensor}`` dict a unit, in package order, on ``device``."""
    return [{k: torch.as_tensor(v, device=device)
             for k, v in pkg["params"][unit["name"]].items()}
            for unit in pkg["contents"]["units"]]


def package_import(path: str) -> Dict[str, Any]:
    """Load a package directory or archive → ``{contents, params, dir}``
    (params: ``{unit: {param: ndarray}}``). A format newer than
    :data:`FORMAT_VERSION` is refused; v3 int8 tensors are dequantized on
    read. ``dir`` is None for an archive (its extraction is removed once
    the arrays are in memory)."""
    archive = _archive_kind(path)
    tmp = None
    if archive:
        import tempfile
        tmp = tempfile.mkdtemp(prefix="veles_pkg_")
        archive[2](path, tmp)
        path = tmp
    try:
        with open(os.path.join(path, "contents.json")) as fin:
            contents = json.load(fin)
        version = int(contents.get("format_version", 1))
        if version > FORMAT_VERSION:
            raise VelesError(
                "package format v%d is newer than this reader (v%d) — "
                "refusing to guess its semantics"
                % (version, FORMAT_VERSION))
        params: Dict[str, Dict[str, numpy.ndarray]] = {}
        for unit in contents["units"]:
            quant = unit.get("quant", {})
            uparams = {}
            for pname, fname in unit["params"].items():
                arr = numpy.load(os.path.join(path, fname))
                meta = quant.get(pname)
                if meta is not None:
                    if meta.get("scheme") != "int8":
                        raise VelesError(
                            "package %s: unknown quant scheme %r for "
                            "%s.%s" % (path, meta.get("scheme"),
                                       unit["name"], pname))
                    scale = numpy.load(os.path.join(path, meta["scale"]))
                    from ..ops.precision import dequantize_int8
                    arr = dequantize_int8(
                        arr, scale,
                        dtype=meta.get("dtype", "float32")).numpy()
                uparams[pname] = arr
            params[unit["name"]] = uparams
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
            path = None
    return {"contents": contents, "params": params, "dir": path}


def package_unit(unit: Dict[str, Any]):
    """A forward unit rebuilt from its package entry, without a
    workflow: the class the registry maps its type to, constructed with
    the entry's config where its constructor takes the key (so every
    other attribute gets its default), then each config value set as
    stored. Only its ``apply`` is used."""
    import importlib
    import inspect
    from ..units import UnitRegistry
    # a fresh process may have imported only this module: load the unit
    # library so the registry holds the package's types
    for mod in ("veles_tpu_torch.nn.standard_workflow",
                "veles_tpu_torch.input_joiner"):
        importlib.import_module(mod)
    cls = UnitRegistry.mapping.get(unit["type"])
    if cls is None:
        raise VelesError("package unit %s: type %r is not a unit of this "
                         "package" % (unit["name"], unit["type"]))
    cfg = {k: tuple(v) if isinstance(v, list) else v
           for k, v in unit["config"].items()}
    takes = inspect.signature(cls.__init__).parameters
    obj = cls(None, name=unit["name"],
              **{k: v for k, v in cfg.items() if k in takes})
    for k, v in cfg.items():
        try:
            setattr(obj, k, v)
        except AttributeError:      # a value the unit derives itself
            pass
    return obj


def run_package(path_or_pkg, batch, device=None) -> numpy.ndarray:
    """The port's executor for a package (either package's): each unit
    rebuilt from its type and config (:func:`package_unit`) runs its own
    ``apply`` on ``device`` — the card unless the caller passes
    ``device="cpu"`` — along the package's DAG. Returns the last unit's
    output on the host."""
    from ..backends import device_for
    device = device_for(device)
    pkg = (package_import(path_or_pkg) if isinstance(path_or_pkg, str)
           else path_or_pkg)
    x = torch.as_tensor(numpy.asarray(batch, dtype=numpy.float32),
                        device=device)
    env = {"@input": x}
    prev = "@input"
    with torch.no_grad():
        for unit in pkg["contents"]["units"]:
            obj = package_unit(unit)
            params = {k: torch.as_tensor(v, device=device)
                      for k, v in pkg["params"][unit["name"]].items()}
            # absent "inputs" (a v1 chain package): the previous unit
            ins = unit.get("inputs") or [prev]
            x = _apply(obj, params, [env[nm] for nm in ins])
            env[unit["name"]] = x
            prev = unit["name"]
    return x.cpu().numpy()
