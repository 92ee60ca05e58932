"""Image loaders: directory scanning, decode and augmentation
(counterpart of ``veles_tpu/loader/image.py``).

``decode_image`` turns a path, raw encoded ``bytes`` or a ``.npy``/
``.npz`` array into HWC float32 in [0, 1] through the reference's codec
chain (PIL, then imageio, then matplotlib; each imported when a file
needs it, so a machine without Pillow still reads ``.npy`` trees). The
loaders materialise the whole (augmented) dataset as one full-batch
array: the host path pays the augmentation multiplicity (mirror ×
rotations × crops) at load time, drawing its random crops from the
loader's keyed stream, so a seed gives the reference's rows bit for bit.

``device_augmentation=True`` keeps one copy of each image instead and
hands ``TrainStep`` two torch functions, ``device_augment_fn(batch,
generator)`` (a random horizontal mirror per row with probability 0.5
and a random crop window per row) and ``device_eval_fn(batch)`` (the
center crop), applied on the device right after the step's gather. The
draws come from the explicit ``torch.Generator`` the step passes, never
from the global one.
"""

from __future__ import annotations

import glob
import hashlib
import importlib
import io
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy
import torch

from ..error import VelesError
from .base import TEST, VALID, TRAIN
from .file_loader import FileFilter, FileListScanner, auto_label
from .fullbatch import FullBatchLoader, FullBatchLoaderMSE, _stored

IMAGE_PATTERNS = ("*.png", "*.jpg", "*.jpeg", "*.bmp", "*.gif", "*.tiff",
                  "*.webp")


def decode_image(path, size: Optional[Tuple[int, int]] = None,
                 color: str = "RGB") -> numpy.ndarray:
    """A file, or raw encoded ``bytes`` (the serving path posts image
    payloads), as HWC float32 in [0, 1]: PIL, then imageio, then
    matplotlib; ``.npy``/``.npz`` arrays load directly (uint8-scaled
    ones are divided by 255). The fallback decoders have no resize, so
    ``size`` maps their output by nearest neighbour."""
    if isinstance(path, (bytes, bytearray)):
        path = io.BytesIO(bytes(path))
    if isinstance(path, str) and path.endswith((".npy", ".npz")):
        arr = numpy.load(path)
        if hasattr(arr, "files"):          # npz: its first member
            arr = arr[arr.files[0]]
        arr = numpy.asarray(arr, dtype=numpy.float32)
        if arr.max() > 1.5:
            arr /= 255.0
    else:
        arr = None
        errors = []
        try:
            from PIL import Image
            if hasattr(path, "seek"):
                path.seek(0)      # the chain may retry the stream
            with Image.open(path) as img:
                img = img.convert(color)
                if size is not None:
                    img = img.resize((size[1], size[0]), Image.BILINEAR)
                arr = numpy.asarray(img, dtype=numpy.float32) / 255.0
        except Exception as e:        # no Pillow, a missing codec, junk
            errors.append("PIL: %s" % e)
        if arr is None:
            for mod, fn in (("imageio", "imread"),
                            ("matplotlib.image", "imread")):
                try:
                    m = importlib.import_module(mod)
                    if hasattr(path, "seek"):
                        path.seek(0)
                    arr = numpy.asarray(getattr(m, fn)(path),
                                        dtype=numpy.float32)
                    if arr.max() > 1.5:
                        arr /= 255.0
                    arr = _convert_channels(arr, color)
                    break
                except Exception as e:
                    errors.append("%s: %s" % (mod, e))
        if arr is None:
            raise VelesError("cannot decode %s (%s)" %
                             (path, "; ".join(errors)))
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if size is not None and arr.shape[:2] != tuple(size):
        h, w = arr.shape[:2]
        yi = (numpy.arange(size[0]) * h // size[0]).clip(0, h - 1)
        xi = (numpy.arange(size[1]) * w // size[1]).clip(0, w - 1)
        arr = arr[yi][:, xi]
    return arr


def _convert_channels(arr: numpy.ndarray, color: str) -> numpy.ndarray:
    """A fallback decoder's output in the requested color mode, as PIL's
    ``convert`` gives it: ITU-R 601 luma for "L"/"I", grayscale
    repeated to RGB, alpha dropped."""
    if arr.ndim == 2:
        arr = arr[:, :, None]
    c = arr.shape[-1]
    if color in ("L", "I"):
        if c >= 3:
            arr = (arr[..., 0] * 0.299 + arr[..., 1] * 0.587
                   + arr[..., 2] * 0.114)[..., None]
        return arr[..., :1]
    if c == 1:
        return numpy.repeat(arr, 3, axis=-1)
    if c >= 4:
        return numpy.ascontiguousarray(arr[..., :3])
    return arr


def deterministic_split(paths: Sequence[str], valid_ratio: float = 0.0,
                        test_ratio: float = 0.0,
                        key: str = "split") -> Tuple[list, list, list]:
    """(train, valid, test) by a hash of each file's basename: the split
    does not depend on the machine, the run or the order, and a grown
    dataset keeps every earlier file in its set."""
    train, valid, test = [], [], []
    for p in sorted(paths):
        h = int.from_bytes(hashlib.sha1(
            (key + "/" + os.path.basename(p)).encode()).digest()[:8],
            "little") / 2.0 ** 64
        if h < test_ratio:
            test.append(p)
        elif h < test_ratio + valid_ratio:
            valid.append(p)
        else:
            train.append(p)
    return train, valid, test


def augment(arr: numpy.ndarray, mirror: bool = False,
            rotations: Sequence[int] = (0,),
            crop: Optional[Tuple[int, int]] = None,
            crop_number: int = 1, rand=None) -> list:
    """Every augmented variant of one HWC image: each rotation, its
    mirror, then ``crop_number`` crops of each (random windows drawn
    from ``rand``, else the center)."""
    variants = []
    for rot in rotations:
        v = numpy.rot90(arr, rot // 90) if rot else arr
        variants.append(v)
        if mirror:
            variants.append(v[:, ::-1])
    if crop is not None:
        ch, cw = crop
        cropped = []
        for v in variants:
            h, w = v.shape[:2]
            if h < ch or w < cw:
                raise VelesError("crop %s larger than image %s"
                                 % (crop, v.shape))
            for _ in range(crop_number):
                y = rand.randint(0, h - ch + 1) if rand else (h - ch) // 2
                x = rand.randint(0, w - cw + 1) if rand else (w - cw) // 2
                cropped.append(v[y:y + ch, x:x + cw])
        variants = cropped
    return [numpy.ascontiguousarray(v) for v in variants]


class ImageLoader(FullBatchLoader):
    """Directories (or files) of images per class, decoded, augmented
    and labelled.

    - ``train_paths``/``validation_paths``/``test_paths``: directories
      or files;
    - the label is the containing directory's name unless a subclass
      overrides ``get_label``;
    - augmentation, of the train class only: mirror, rotations, random
      crops (the evaluation classes take the center crop).
    """

    MAPPING = "image_loader"
    hide_from_registry = False

    def __init__(self, workflow, train_paths: Sequence[str] = (),
                 validation_paths: Sequence[str] = (),
                 test_paths: Sequence[str] = (),
                 size: Optional[Tuple[int, int]] = None,
                 color: str = "RGB", mirror: bool = False,
                 rotations: Sequence[int] = (0,),
                 crop: Optional[Tuple[int, int]] = None,
                 crop_number: int = 1,
                 device_augmentation: bool = False, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        self.scanner = FileListScanner(
            train_paths, validation_paths, test_paths,
            FileFilter(include=IMAGE_PATTERNS))
        self.size = size
        self.color = color
        self.mirror = mirror
        self.rotations = tuple(rotations)
        self.crop = crop
        self.crop_number = crop_number
        #: one stored copy a image; mirror and crop run in the train step
        self.device_augmentation = device_augmentation
        #: label string → index, and back
        self.labels_mapping: Dict[str, int] = {}
        self.label_names: Dict[int, str] = {}
        #: the source file of each dataset row (variants repeat theirs)
        self.row_paths: List[str] = []
        self.device_augment_fn = None
        self.device_eval_fn = None

    def get_label(self, path: str) -> str:
        return auto_label(path)

    def load_data(self) -> None:
        per_class = self.scanner.scan()
        names = sorted({self.get_label(p)
                        for files in per_class for p in files})
        self.labels_mapping = {n: i for i, n in enumerate(names)}
        self.label_names = {i: n for n, i in self.labels_mapping.items()}
        data, labels = [], []
        self.row_paths = []
        lengths = [0, 0, 0]
        for cls in (TEST, VALID, TRAIN):
            for path in per_class[cls]:
                arr = decode_image(path, self.size, self.color)
                if self.device_augmentation:
                    variants = [arr]
                elif cls == TRAIN:
                    variants = augment(
                        arr, self.mirror, self.rotations, self.crop,
                        self.crop_number, self.prng)
                elif self.crop is not None:
                    variants = augment(arr, crop=self.crop)
                else:
                    variants = [arr]
                label = self.labels_mapping[self.get_label(path)]
                data.extend(variants)
                labels.extend([label] * len(variants))
                self.row_paths.extend([path] * len(variants))
                lengths[cls] += len(variants)
        shapes = {v.shape for v in data}
        if len(shapes) != 1:
            raise VelesError(
                "images have differing shapes %s — pass size=(H, W) or "
                "crop=(H, W)" % sorted(shapes))
        self.create_originals(numpy.stack(data),
                              numpy.asarray(labels, dtype=numpy.int32))
        self.class_lengths = lengths
        if self.device_augmentation:
            self._build_device_augment()
        if self.validation_ratio and not lengths[VALID]:
            self.resize_validation(self.validation_ratio)

    def _build_device_augment(self) -> None:
        """``device_augment_fn`` and ``device_eval_fn`` for the train
        step. Rotations need the host's multiplicity and are refused."""
        if any(r % 360 for r in self.rotations):
            raise VelesError("device_augmentation supports mirror/crop; "
                             "rotations need the host path")
        mirror, crop = self.mirror, self.crop

        def eval_fn(batch):
            if crop is None:
                return batch
            ch, cw = crop
            h, w = batch.shape[1:3]
            y, x = (h - ch) // 2, (w - cw) // 2
            return batch[:, y:y + ch, x:x + cw, :]

        def train_fn(batch, generator):
            # the flips first, then the rows' y offsets, then their x
            # offsets, all drawn from ``generator`` on the batch's device
            if generator is None:
                return eval_fn(batch)
            b, dev = batch.shape[0], batch.device
            if mirror:
                flip = torch.rand(b, generator=generator, device=dev) < 0.5
                batch = torch.where(flip[:, None, None, None],
                                    batch.flip(2), batch)
            if crop is not None:
                ch, cw = crop
                h, w = batch.shape[1:3]
                ys = torch.randint(0, h - ch + 1, (b,), generator=generator,
                                   device=dev)
                xs = torch.randint(0, w - cw + 1, (b,), generator=generator,
                                   device=dev)
                rows = ys[:, None, None] + torch.arange(
                    ch, device=dev)[None, :, None]
                cols = xs[:, None, None] + torch.arange(
                    cw, device=dev)[None, None]
                batch = batch[torch.arange(b, device=dev)[:, None, None],
                              rows, cols]
            return batch

        self.device_augment_fn = train_fn
        self.device_eval_fn = eval_fn

    def sample_shape_after_augment(self) -> Tuple[int, ...]:
        """A sample's shape as the forwards see it: the crop's under
        device augmentation, else the stored rows'."""
        base = tuple(self.original_data.shape[1:])
        if self.device_augmentation and self.crop is not None:
            return tuple(self.crop) + base[2:]
        return base


class ClassImageLoader(ImageLoader):
    """A per-class directory tree (``root/daisy/001.png``, ...): the
    label is the first-level subdirectory, and each class's files split
    into train/valid/test by :func:`deterministic_split`."""

    MAPPING = "class_image_loader"

    def __init__(self, workflow, root_dir: str,
                 valid_ratio: float = 0.15, test_ratio: float = 0.0,
                 **kwargs) -> None:
        train, valid, test = [], [], []
        if not os.path.isdir(root_dir):
            raise VelesError("no such dataset root: %s" % root_dir)
        for cls_dir in sorted(os.listdir(root_dir)):
            full = os.path.join(root_dir, cls_dir)
            if not os.path.isdir(full):
                continue
            files = []
            for pat in IMAGE_PATTERNS + ("*.npy",):
                files += glob.glob(os.path.join(full, pat))
            tr, va, te = deterministic_split(files, valid_ratio,
                                             test_ratio, key=cls_dir)
            train += tr
            valid += va
            test += te
        super().__init__(workflow, train_paths=train,
                         validation_paths=valid, test_paths=test,
                         **kwargs)

    def get_label(self, path: str) -> str:
        return os.path.basename(os.path.dirname(path))


class FileListImageLoader(ImageLoader):
    """Images listed in index files: ``train_list``/``validation_list``/
    ``test_list`` hold one ``path[<whitespace>label]`` a line (blank
    lines and ``#`` comments skipped); a relative path resolves against
    the list file's directory, and a line without a label takes its
    directory's name."""

    MAPPING = "file_list_image_loader"

    def __init__(self, workflow, train_list: Optional[str] = None,
                 validation_list: Optional[str] = None,
                 test_list: Optional[str] = None, **kwargs) -> None:
        self._explicit_labels: Dict[str, str] = {}
        per_class = {}
        for key, list_path in (("train_paths", train_list),
                               ("validation_paths", validation_list),
                               ("test_paths", test_list)):
            per_class[key] = (self._parse_list(list_path)
                              if list_path else ())
        super().__init__(workflow, **per_class, **kwargs)

    def _parse_list(self, list_path: str) -> List[str]:
        if not os.path.exists(list_path):
            raise VelesError("no such list file: %s" % list_path)
        base = os.path.dirname(os.path.abspath(list_path))
        paths = []
        with open(list_path) as fin:
            for line in fin:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(None, 1)
                path = parts[0]
                if not os.path.isabs(path):
                    path = os.path.join(base, path)
                paths.append(path)
                if len(parts) == 2:
                    self._explicit_labels[path] = parts[1].strip()
        if not paths:
            raise VelesError("list file %s has no entries" % list_path)
        return paths

    def get_label(self, path: str) -> str:
        return self._explicit_labels.get(path) or auto_label(path)


class ImageLoaderMSE(ImageLoader, FullBatchLoaderMSE):
    """Each input image's regression target is an image of
    ``target_paths``, decoded with the inputs' size and color and never
    augmented:

    - ``target_by_label=True`` (default): one target a label, the one
      whose directory name is the label, stored once as a per-label
      table (``targets_by_label``) that the steps gather through the
      rows' labels;
    - ``target_by_label=False``: targets matched 1:1 by file basename,
      which needs geometrically untransformed inputs."""

    MAPPING = "image_mse_loader"

    def __init__(self, workflow, target_paths: Sequence[str] = (),
                 target_by_label: bool = True, **kwargs) -> None:
        super().__init__(workflow, **kwargs)
        if not target_paths:
            raise VelesError("ImageLoaderMSE needs target_paths")
        self.target_paths = list(target_paths)
        self.target_by_label = bool(target_by_label)
        if not self.target_by_label and (
                self.mirror or self.crop is not None
                or any(r % 360 for r in self.rotations)):
            raise VelesError(
                "basename-matched targets need geometrically "
                "untransformed inputs (set target_by_label=True for "
                "per-label targets, or drop mirror/rotations/crop)")

    def load_data(self) -> None:
        super().load_data()
        file_filter = FileFilter(include=IMAGE_PATTERNS + ("*.npy",))
        targets = []
        for path in self.target_paths:
            if os.path.isfile(path):
                targets.append(path)
            else:
                targets.extend(file_filter.scan(path))
        if not targets:
            raise VelesError("no target images under %s"
                             % self.target_paths)
        decoded = {p: decode_image(p, self.size, self.color)
                   for p in targets}
        if self.target_by_label:
            by_label = {}
            for p, arr in decoded.items():
                label = auto_label(p)
                if label in by_label:
                    raise VelesError(
                        "duplicate target for label %r" % label)
                by_label[label] = arr
            missing = set(self.labels_mapping) - set(by_label)
            if missing:
                raise VelesError("labels with no target image: %s"
                                 % sorted(missing))
            rows = [by_label[self.label_names[i]]
                    for i in range(len(self.label_names))]
            self.targets_by_label = True
        else:
            by_base: Dict[str, numpy.ndarray] = {}
            for p, arr in decoded.items():
                base = os.path.basename(p)
                if base in by_base:
                    raise VelesError(
                        "duplicate target basename %r across target "
                        "paths" % base)
                by_base[base] = arr
            missing = [p for p in self.row_paths
                       if os.path.basename(p) not in by_base]
            if missing:
                raise VelesError(
                    "inputs with no basename-matched target: %s"
                    % sorted(os.path.basename(p)
                             for p in missing)[:10])
            rows = [by_base[os.path.basename(p)]
                    for p in self.row_paths]
        shapes = {r.shape for r in rows}
        if len(shapes) != 1:
            raise VelesError("target images have differing shapes %s — "
                             "pass size=(H, W)" % sorted(shapes))
        self.original_targets.reset(_stored(numpy.stack(rows)))
