"""PyTorch/CUDA port of ``veles_tpu``.

A second package beside the JAX one, with the same module names so a
reader finds each counterpart: ``nn/transformer.py`` here mirrors
``veles_tpu/nn/transformer.py`` there. Ported so far:

- the serving path of the transformer LM — HTTP request →
  :class:`restful_api.GenerationAPI` → :func:`nn.sampling.generate` →
  KV-cached prefill + decode over ``Embedding → TransformerBlock×N →
  LMHead`` — with prefill attention in a hand-written Hopper kernel
  (``csrc/flash_attention_fwd.cu``);
- training through the Workflow/Unit graph (``StandardWorkflow`` →
  ``Repeater`` → loader → ``TrainStep`` → ``DecisionGD``): MNIST, whose
  epochs run in the fused-FC SGD kernel (``csrc/fused_fc_sgd.cu``), and
  the transformer LM with adam, whose attention runs forward and
  backward in the flash kernels (``csrc/flash_attention_bwd.cu``).

- snapshots and resume (``snapshotter.py``, ``resilience/``) in the
  reference's file format, which either package reads; the mean/disp
  normalizer pipeline of BASELINE #2 (``mean_disp_normalizer.py``,
  ``normalization.py``, ``input_joiner.py``);
- the command line, ``python -m veles_tpu_torch MODEL.py [CONFIG]
  [root.x=y] [flags]`` (``__main__.py``, ``cmdline.py``,
  ``launcher.py``): train, resume, write results or serve a model file,
  with the reference's argv;
- classic REST serving of a trained classifier: a forward workflow
  ``Repeater → RestfulLoader → forwards → RESTfulAPI``
  (``restful_api.RESTfulAPI``, ``loader/stream.py``), and the image
  loaders (``loader/image.py``) with on-device augmentation.

The package imports ``torch`` and numpy, never ``jax`` and nothing of
``veles_tpu``. Entry points run on the CUDA card unless the caller
passes ``device="cpu"`` (:func:`backends.device_for`).
"""

__version__ = "0.1.0"

from .snapshotter import (Snapshotter, SnapshotterToDB,  # noqa: F401,E402
                          load_snapshot, resume)
from .mean_disp_normalizer import MeanDispNormalizer  # noqa: F401,E402
from .input_joiner import InputJoiner  # noqa: F401,E402
from . import normalization  # noqa: F401,E402
from .restful_api import GenerationAPI, RESTfulAPI  # noqa: F401,E402
