"""Model export and the standalone inference runtimes (counterpart of
``veles_tpu/export/``).

A trained workflow exports to a self-describing package (``contents.json``
+ ``.npy`` parameter files + a ``torch.export`` program of the forward,
``forward.pt2``), in the reference's format, which runs in:

- the C++ runtime in ``native/`` (``libveles_infer.so``, built from the
  checkout by :mod:`.native` and bound with ``ctypes``), no Python;
- :func:`run_package`, the port's executor, on the card or the CPU;
- the reference's own ``package_import`` and ``run_package``;
- any ``torch.export`` loader, through ``forward.pt2``.

:mod:`.serve_artifact` exports the serving engines' programs (the paged
engine's prefills and decode step, the O(1)-state lane's chunk scan and
decode tile) for ``--serve-artifact``.
"""

from .package import package_export, package_import, run_package  # noqa
