"""The port's image loaders (``loader/image.py``) and the train step's
hooks for them against the reference's, on the CPU:

- ``decode_image`` returns the reference's arrays exactly (PNG files and
  PNG bytes through Pillow, ``.npy``/``.npz`` in uint8 and float,
  grayscale and RGBA to RGB, resizes, the fallback decoders' channel
  conversion); ``deterministic_split`` its splits;
- ``ClassImageLoader``, ``FileListImageLoader`` and ``ImageLoaderMSE``
  (per-label and basename targets) load the reference's
  ``original_data`` bit for bit, host augmentation with random crops
  included (the same keyed stream, the same seed), with its labels,
  ``labels_mapping``, ``class_lengths``, ``row_paths`` and targets;
  every refusal raises the reference's message;
- the first two SGD steps of a ``StandardWorkflow`` on a host-augmented
  loader, and on the per-label target table, within 1e-4 relative of
  the reference's (the same initial weights from the same keyed
  streams);
- the reference's learning anchors (``tests/test_image_family.py``)
  hold on the port;
- device augmentation by its semantics (the reference's threefry bits
  cannot be drawn by torch): every row a window of its source or of its
  mirror, the mirrored share near a half, one key one draw, the
  evaluation crop equal to the reference's ``device_eval_fn`` exactly;
  the fused-FC kernel refuses it with the reference's reason.
"""
import base64
import io
import logging
import os

import numpy
import pytest
import torch

import veles_tpu as vt
from veles_tpu import loader as ref_loader
from veles_tpu import prng as ref_prng
from veles_tpu.config import root as ref_root
from veles_tpu.loader import image as ref_image
from veles_tpu_torch import loader, prng
from veles_tpu_torch.config import root
from veles_tpu_torch.error import VelesError
from veles_tpu_torch.loader import image
from veles_tpu_torch.loader.base import TRAIN, VALID
from veles_tpu_torch.nn.standard_workflow import StandardWorkflow

#: the first SGD steps of the two packages (float32 in another order)
STEP_RTOL = 1e-4


def _png(path, arr, mode=None):
    from PIL import Image
    Image.fromarray((arr * 255).astype(numpy.uint8), mode).save(path)


@pytest.fixture
def class_tree(tmp_path):
    """3 classes x 20 images of 12x12, each class a distinct mean color
    (the reference's ``tests/test_image_family.py`` tree)."""
    rng = numpy.random.RandomState(0)
    top = tmp_path / "flowers"
    for ci, cls in enumerate(["daisy", "rose", "tulip"]):
        d = top / cls
        d.mkdir(parents=True)
        for i in range(20):
            img = numpy.clip(rng.rand(12, 12, 3) * 0.3
                             + numpy.eye(3)[ci] * 0.7, 0, 1)
            _png(str(d / ("img%02d.png" % i)), img)
    return str(top)


def _pair(name, *args, seed=5, **kw):
    """The reference's and the port's loader ``name`` from the same
    arguments, each ``load_data``-ed under the same seed."""
    ref = getattr(ref_loader, name)(None, *args, name="img", **kw)
    port = getattr(loader, name)(None, *args, name="img", **kw)
    ref_prng.seed_all(seed)
    ref.load_data()
    prng.seed_all(seed)
    port.load_data()
    return ref, port


def _assert_same(ref, port):
    assert port.class_lengths == ref.class_lengths
    numpy.testing.assert_array_equal(port.original_data.mem,
                                     ref.original_data.mem)
    assert port.original_data.mem.dtype == ref.original_data.mem.dtype
    numpy.testing.assert_array_equal(port.original_labels.mem,
                                     ref.original_labels.mem)
    assert port.labels_mapping == ref.labels_mapping
    assert port.label_names == ref.label_names
    assert port.row_paths == ref.row_paths
    if getattr(ref, "original_targets", None):
        assert port.targets_by_label == ref.targets_by_label
        numpy.testing.assert_array_equal(port.original_targets.mem,
                                         ref.original_targets.mem)


# -- decode ------------------------------------------------------------------
def _decode_cases(tmp_path):
    rng = numpy.random.RandomState(1)
    rgb = rng.rand(9, 7, 3)
    gray = rng.rand(6, 5)
    rgba = rng.rand(5, 6, 4)
    paths = {}
    for name, arr, mode in (("rgb.png", rgb, None), ("gray.png", gray, "L"),
                            ("rgba.png", rgba, "RGBA")):
        paths[name] = str(tmp_path / name)
        _png(paths[name], arr, mode)
    f32 = rng.rand(8, 8, 3).astype(numpy.float32)
    for name, arr in (("f.npy", f32), ("u8.npy", (f32 * 255).astype("uint8")),
                      ("g.npy", f32[..., 0])):
        paths[name] = str(tmp_path / name)
        numpy.save(paths[name], arr)
    paths["z.npz"] = str(tmp_path / "z.npz")
    numpy.savez(paths["z.npz"], first=(f32 * 255).astype("uint8"),
                second=f32)
    return paths


@pytest.mark.parametrize("name, size, color", [
    ("rgb.png", None, "RGB"), ("rgb.png", (4, 5), "RGB"),
    ("rgb.png", None, "L"), ("gray.png", None, "RGB"),
    ("rgba.png", None, "RGB"), ("f.npy", None, "RGB"),
    ("u8.npy", None, "RGB"), ("g.npy", (4, 4), "RGB"),
    ("z.npz", (3, 5), "RGB"), ("rgb.png-bytes", (4, 4), "RGB")])
def test_decode_image_equals_reference(tmp_path, name, size, color):
    paths = _decode_cases(tmp_path)
    if name.endswith("-bytes"):
        with open(paths[name[:-6]], "rb") as f:
            src = f.read()
    else:
        src = paths[name]
    want = ref_image.decode_image(src, size, color)
    got = image.decode_image(src, size, color)
    assert got.dtype == want.dtype == numpy.float32
    numpy.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape, color", [
    ((5, 4), "RGB"), ((5, 4, 1), "RGB"), ((5, 4, 4), "RGB"),
    ((5, 4, 3), "L"), ((5, 4, 3), "RGB")])
def test_fallback_channel_conversion_equals_reference(shape, color):
    """What the imageio/matplotlib fallbacks' output goes through."""
    arr = numpy.random.RandomState(2).rand(*shape).astype(numpy.float32)
    numpy.testing.assert_array_equal(image._convert_channels(arr, color),
                                     ref_image._convert_channels(arr, color))


def test_undecodable_bytes_raise_as_the_reference():
    with pytest.raises(Exception) as want:
        ref_image.decode_image(b"junk")
    with pytest.raises(VelesError) as got:
        image.decode_image(b"junk")
    import re

    def plain(e):       # the stream's repr holds its address
        return re.sub(r" at 0x[0-9a-f]+", "", str(e.value))
    assert plain(got) == plain(want)
    assert plain(got).startswith("cannot decode <_io.BytesIO object> (PIL")


def test_deterministic_split_equals_reference():
    files = ["f%03d.png" % i for i in range(200)] + ["g/h%02d.jpg" % i
                                                     for i in range(40)]
    for ratios in ((0.2, 0.1), (0.0, 0.0), (0.5, 0.3)):
        for key in ("split", "daisy"):
            assert image.deterministic_split(files, *ratios, key=key) == \
                ref_image.deterministic_split(files, *ratios, key=key)


# -- loaders -----------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(valid_ratio=0.25),
    dict(valid_ratio=0.25, mirror=True, crop=(8, 8), crop_number=2),
    dict(valid_ratio=0.2, test_ratio=0.1, rotations=(0, 90), crop=(7, 9)),
    dict(valid_ratio=0.0, validation_ratio=0.3, mirror=True),
    dict(valid_ratio=0.25, device_augmentation=True, mirror=True,
         crop=(8, 8))])
def test_class_image_loader_equals_reference(class_tree, kw):
    """Host augmentation's random crops come from the loader's keyed
    stream: the reference's rows bit for bit."""
    ref, port = _pair("ClassImageLoader", root_dir=class_tree,
                      minibatch_size=10, **kw)
    _assert_same(ref, port)
    assert port.sample_shape_after_augment() == \
        ref.sample_shape_after_augment()


def test_file_list_image_loader_equals_reference(tmp_path):
    rng = numpy.random.RandomState(0)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i in range(8):
        _png(str(img_dir / ("im%d.png" % i)), rng.rand(6, 6, 3))
    train = tmp_path / "train.txt"
    train.write_text("# manifest\n\n" + "".join(
        "imgs/im%d.png %s\n" % (i, "even" if i % 2 == 0 else "odd")
        for i in range(5)) + "imgs/im5.png\n")
    valid = tmp_path / "valid.txt"
    valid.write_text("imgs/im6.png even\n%s odd\n"
                     % (img_dir / "im7.png"))
    ref, port = _pair("FileListImageLoader", train_list=str(train),
                      validation_list=str(valid), minibatch_size=2,
                      mirror=True)
    _assert_same(ref, port)
    assert sorted(port.labels_mapping) == ["even", "imgs", "odd"]


def _mse_tree(tmp_path, shape=(5, 5, 3)):
    rng = numpy.random.RandomState(1)
    for cls, level in (("a", 0.25), ("b", 0.75)):
        d = tmp_path / "train" / cls
        d.mkdir(parents=True)
        for i in range(6):
            _png(str(d / ("x%d.png" % i)), rng.rand(*shape))
        t = tmp_path / "targets" / cls
        t.mkdir(parents=True)
        _png(str(t / "ideal.png"), numpy.full(shape, level))
        (tmp_path / "pairs" / cls).mkdir(parents=True)
    (tmp_path / "tgt").mkdir()
    for i in range(6):
        x = rng.rand(*shape)
        _png(str(tmp_path / "pairs" / "a" / ("p%d.png" % i)), x)
        _png(str(tmp_path / "tgt" / ("p%d.png" % i)), 1.0 - x)
    return tmp_path


@pytest.mark.parametrize("by_label", [True, False])
def test_image_mse_loader_equals_reference(tmp_path, by_label):
    """Both target schemes, with a validation share carved from the
    train rows: the per-label table stays put, the row paths follow."""
    top = _mse_tree(tmp_path)
    kw = (dict(train_paths=[str(top / "train")],
               target_paths=[str(top / "targets")])
          if by_label else
          dict(train_paths=[str(top / "pairs")],
               target_paths=[str(top / "tgt")], target_by_label=False))
    ref, port = _pair("ImageLoaderMSE", validation_ratio=0.25,
                      minibatch_size=2, **kw)
    _assert_same(ref, port)
    assert port.original_targets.shape[0] == (2 if by_label else 6)
    port.create_minibatch_data()
    ref.create_minibatch_data()
    for ld in (ref, port):
        ld.minibatch_indices.reset(numpy.array([3, 5], dtype=numpy.int32))
        ld.minibatch_size = 2
        ld.fill_minibatch()
    numpy.testing.assert_array_equal(port.minibatch_targets.mem,
                                     ref.minibatch_targets.mem)
    numpy.testing.assert_array_equal(
        port.fetch_batch(numpy.array([1, 4]), 2)["targets"],
        ref.fetch_batch(numpy.array([1, 4]), 2)["targets"])


def _refusal_cases(top):
    (top / "odd" / "c").mkdir(parents=True)
    _png(str(top / "odd" / "c" / "big.png"),
         numpy.zeros((6, 6, 3)))
    _png(str(top / "odd" / "c" / "small.png"),
         numpy.zeros((4, 4, 3)))
    (top / "tgt2").mkdir()
    _png(str(top / "tgt2" / "p0.png"), numpy.zeros((5, 5, 3)))
    (top / "targets2" / "a").mkdir(parents=True)
    _png(str(top / "targets2" / "a" / "other.png"), numpy.zeros((5, 5, 3)))
    pairs = dict(train_paths=[str(top / "pairs")], target_by_label=False)
    return {
        "shapes": ("ImageLoader", dict(train_paths=[str(top / "odd")]),
                   True),
        "rotations": ("ClassImageLoader", dict(
            root_dir=str(top / "train"), rotations=(0, 90),
            device_augmentation=True), True),
        "basename_mirror": ("ImageLoaderMSE", dict(
            pairs, target_paths=[str(top / "tgt")], mirror=True), False),
        "basename_crop": ("ImageLoaderMSE", dict(
            pairs, target_paths=[str(top / "tgt")], crop=(3, 3)), False),
        "duplicate_label": ("ImageLoaderMSE", dict(
            train_paths=[str(top / "train")],
            target_paths=[str(top / "targets"), str(top / "targets2")]),
            True),
        "duplicate_basename": ("ImageLoaderMSE", dict(
            pairs, target_paths=[str(top / "tgt"), str(top / "tgt2")]),
            True),
        "missing_label": ("ImageLoaderMSE", dict(
            train_paths=[str(top / "train")],
            target_paths=[str(top / "targets" / "a")]), True),
        "missing_basename": ("ImageLoaderMSE", dict(
            pairs, target_paths=[str(top / "tgt" / "p0.png")]), True),
        "no_targets": ("ImageLoaderMSE", dict(
            train_paths=[str(top / "train")]), False),
        "no_root": ("ClassImageLoader", dict(
            root_dir=str(top / "nope")), False),
        "no_list": ("FileListImageLoader", dict(
            train_list=str(top / "nope.txt")), False),
    }


@pytest.mark.parametrize("case", [
    "shapes", "rotations", "basename_mirror", "basename_crop",
    "duplicate_label", "duplicate_basename", "missing_label",
    "missing_basename", "no_targets", "no_root", "no_list"])
def test_refusals_raise_the_reference_s_message(tmp_path, case):
    name, kw, at_load = _refusal_cases(_mse_tree(tmp_path))[case]
    messages = []
    for pkg in (ref_loader, loader):
        with pytest.raises(Exception) as e:
            ld = getattr(pkg, name)(None, name="bad", minibatch_size=2, **kw)
            assert at_load
            ld.load_data()
        messages.append(str(e.value))
    assert messages[1] == messages[0]
    assert isinstance(e.value, VelesError)


# -- training ----------------------------------------------------------------
def _workflow(port, loader_cls, loss, layers, seed=21, **kw):
    (prng if port else ref_prng).seed_all(seed)
    pkg = loader if port else ref_loader
    ld = getattr(pkg, loader_cls)(None, name="imgs", **kw)
    cls = StandardWorkflow if port else vt.nn.StandardWorkflow
    wf = cls(name="img", layers=layers, loader_unit=ld, loss_function=loss,
             decision_config=dict(max_epochs=1, fail_iterations=99))
    if port:
        wf.initialize(device="cpu")
    else:
        wf.initialize(device=vt.XLADevice(mesh_axes={"data": 1}))
    return wf


def _assert_steps_alike(ref, port, steps):
    assert ref.loader.class_lengths == port.loader.class_lengths
    assert -(-ref.loader.class_lengths[TRAIN]
             // ref.loader.max_minibatch_size) == steps
    import jax
    for name, params in ref.train_step.params.items():
        for k, v in params.items():
            want = numpy.asarray(jax.device_get(v))
            got = port.train_step.params[name][k].numpy()
            scale = max(float(numpy.abs(want).max()), 1e-6)
            assert float(numpy.abs(got - want).max()) <= STEP_RTOL * scale, \
                (name, k)
    for cls in (VALID, TRAIN):
        want = ref.decision.epoch_metrics[cls]
        numpy.testing.assert_allclose(port.decision.epoch_metrics[cls],
                                      want, rtol=STEP_RTOL, atol=1e-7)


def test_first_steps_on_host_augmented_images_match_reference(class_tree):
    """Mirror + random crops on the host, then two SGD steps of a
    tanh/softmax chain over the 8x8 crops."""
    layers = [{"type": "all2all_tanh", "output_sample_shape": 16,
               "learning_rate": 0.1},
              {"type": "softmax", "output_sample_shape": 3,
               "learning_rate": 0.1}]
    kw = dict(root_dir=class_tree, valid_ratio=0.25, mirror=True,
              crop=(8, 8), minibatch_size=48)
    pair = [_workflow(p, "ClassImageLoader", "softmax", layers, **kw)
            for p in (False, True)]
    numpy.testing.assert_array_equal(pair[1].loader.original_data.mem,
                                     pair[0].loader.original_data.mem)
    for wf in pair:
        wf.run()
    _assert_steps_alike(*pair, steps=2)


def test_first_steps_on_the_per_label_table_match_reference(tmp_path):
    """The per-label target table through the train step: row → label →
    template, gathered on the device."""
    top = _mse_tree(tmp_path)
    layers = [{"type": "conv", "n_kernels": 3, "kx": 1, "ky": 1,
               "learning_rate": 0.5}]
    kw = dict(train_paths=[str(top / "train")],
              target_paths=[str(top / "targets")], validation_ratio=0.25,
              minibatch_size=5)
    pair = [_workflow(p, "ImageLoaderMSE", "mse", layers, **kw)
            for p in (False, True)]
    assert pair[1].train_step.target_mode == "targets"
    assert pair[1].loader.original_targets.shape == (2, 5, 5, 3)
    dataset, targets = pair[1].train_step._dataset()
    assert isinstance(targets, tuple)
    for wf in pair:
        wf.run()
    _assert_steps_alike(*pair, steps=2)


def _anchor(loader_cls, loss, layers, epochs, **kw):
    prng.seed_all(1234)
    ld = getattr(loader, loader_cls)(None, name="anchor", **kw)
    wf = StandardWorkflow(
        name="anchor", layers=layers, loader_unit=ld, loss_function=loss,
        decision_config=dict(max_epochs=epochs, fail_iterations=epochs))
    wf.initialize(device="cpu")
    return wf


def test_device_augmentation_trains(class_tree):
    """``tests/test_image_family.py:77-99`` on the port: one stored copy
    a image, random mirror + crop in the train step, the center crop in
    evaluation; the color-coded classes are learned (best < 0.35)."""
    wf = _anchor("ClassImageLoader", "softmax",
                 [{"type": "all2all_tanh", "output_sample_shape": 16},
                  {"type": "softmax", "output_sample_shape": 3}], 8,
                 root_dir=class_tree, valid_ratio=0.25, minibatch_size=9,
                 mirror=True, crop=(8, 8), device_augmentation=True)
    assert wf.loader.original_data.shape == (60, 12, 12, 3)
    assert wf.loader.minibatch_data.shape[1:] == (8, 8, 3)
    wf.run()
    assert wf.decision.best_metric is not None
    assert wf.decision.best_metric < 0.35, wf.decision.epoch_metrics


def _write_pairs(tmp_path, n, shape, fn, seed):
    rng = numpy.random.RandomState(seed)
    (tmp_path / "in" / "c").mkdir(parents=True)
    (tmp_path / "tgt").mkdir()
    for i in range(n):
        x = rng.rand(*shape)
        _png(str(tmp_path / "in" / "c" / ("q%d.png" % i)), x)
        _png(str(tmp_path / "tgt" / ("q%d.png" % i)), fn(x))


def test_image_mse_trains_end_to_end(tmp_path):
    """``tests/test_image_family.py:243-270`` on the port: basename
    pairs x → 1 − x through a 1x1 conv, best rmse < 0.15."""
    _write_pairs(tmp_path, 16, (8, 8, 3), lambda x: 1.0 - x, 3)
    wf = _anchor("ImageLoaderMSE", "mse",
                 [{"type": "conv", "n_kernels": 3, "kx": 1, "ky": 1,
                   "learning_rate": 0.5}], 30,
                 train_paths=[str(tmp_path / "in")],
                 target_paths=[str(tmp_path / "tgt")],
                 target_by_label=False, validation_ratio=0.25,
                 minibatch_size=4)
    wf.run()
    res = wf.gather_results()
    assert res["best_rmse"] < 0.15, res


def test_image_mse_label_targets_train(tmp_path):
    """``tests/test_image_family.py:273-310`` on the port: class-coded
    inputs regress onto their class's template through the per-label
    table, best rmse < 0.06."""
    rng = numpy.random.RandomState(4)
    for cls, level, tgt in (("lo", 0.2, 0.25), ("hi", 0.8, 0.75)):
        d = tmp_path / "train" / cls
        d.mkdir(parents=True)
        for i in range(8):
            img = numpy.clip(level + 0.02 * rng.randn(6, 6, 3), 0, 1)
            _png(str(d / ("s%d.png" % i)), img)
        t = tmp_path / "targets" / cls
        t.mkdir(parents=True)
        _png(str(t / "ideal.png"), numpy.full((6, 6, 3), tgt))
    wf = _anchor("ImageLoaderMSE", "mse",
                 [{"type": "conv", "n_kernels": 3, "kx": 1, "ky": 1,
                   "learning_rate": 0.5}], 30,
                 train_paths=[str(tmp_path / "train")],
                 target_paths=[str(tmp_path / "targets")],
                 validation_ratio=0.25, minibatch_size=4)
    assert wf.loader.targets_by_label is True
    assert wf.loader.original_targets.shape[0] == 2
    wf.run()
    res = wf.gather_results()
    assert res["best_rmse"] < 0.06, res


# -- device augmentation -----------------------------------------------------
def _windows(src, ch, cw):
    """Every (ch, cw) window of each NHWC source row and of its mirror."""
    h, w = src.shape[1:3]
    out = []
    for row in src:
        wins = {}
        for flip in (False, True):
            img = row[:, ::-1] if flip else row
            for y in range(h - ch + 1):
                for x in range(w - cw + 1):
                    wins[(flip, y, x)] = img[y:y + ch, x:x + cw]
        out.append(wins)
    return out


def test_device_augmentation_semantics(class_tree):
    """Each augmented row is a crop window of its source or of its
    mirror; the mirrored share over 600 rows lies in 0.5 ± 0.1; one
    generator seed gives one draw and another seed another; the
    evaluation crop equals the reference's ``device_eval_fn``."""
    import jax.numpy as jnp
    ref, port = _pair("ClassImageLoader", root_dir=class_tree,
                      valid_ratio=0.25, minibatch_size=10, mirror=True,
                      crop=(8, 8), device_augmentation=True)
    src = port.original_data.mem[:20]
    rows = numpy.concatenate([src] * 30)
    batch = torch.from_numpy(rows)

    def draw(seed):
        gen = torch.Generator()
        gen.manual_seed(seed)
        return port.device_augment_fn(batch, gen).numpy()

    got = draw(7)
    assert got.shape == (600, 8, 8, 3)
    wins = _windows(src, 8, 8)
    flips = 0
    for i, row in enumerate(got):
        hits = [key for key, win in wins[i % 20].items()
                if numpy.array_equal(win, row)]
        assert hits, i
        # a window that equals a mirror window too (a symmetric image)
        # counts as unmirrored
        flips += all(key[0] for key in hits)
    assert 0.4 <= flips / 600 <= 0.6, flips
    numpy.testing.assert_array_equal(draw(7), got)
    assert not numpy.array_equal(draw(8), got)
    want = numpy.asarray(ref.device_eval_fn(jnp.asarray(src)))
    numpy.testing.assert_array_equal(
        port.device_eval_fn(torch.from_numpy(src)).numpy(), want)
    numpy.testing.assert_array_equal(
        port.device_augment_fn(torch.from_numpy(src), None).numpy(), want)


def test_train_step_draws_each_step_s_augmentation(class_tree):
    """The step's generator is keyed by its number: one step one draw,
    the next another; the evaluation step center-crops."""
    wf = _anchor("ClassImageLoader", "softmax",
                 [{"type": "all2all_tanh", "output_sample_shape": 8},
                  {"type": "softmax", "output_sample_shape": 3}], 1,
                 root_dir=class_tree, valid_ratio=0.25, minibatch_size=9,
                 mirror=True, crop=(8, 8), device_augmentation=True)
    step = wf.train_step
    batch = torch.from_numpy(wf.loader.original_data.mem[:9])
    assert torch.equal(step._augmented(batch, 3), step._augmented(batch, 3))
    assert not torch.equal(step._augmented(batch, 3),
                           step._augmented(batch, 4))
    assert step._augmented(batch, 3).shape == (9, 8, 8, 3)


def test_fused_gate_refuses_device_augmentation_as_reference(class_tree,
                                                             caplog):
    layers = [{"type": "all2all_tanh", "output_sample_shape": 8},
              {"type": "softmax", "output_sample_shape": 3}]
    kw = dict(root_dir=class_tree, valid_ratio=0.25, minibatch_size=9,
              mirror=True, crop=(8, 8), device_augmentation=True)
    saved = [(cfg, cfg.common.engine.get("fused_fc_scan", False))
             for cfg in (root, ref_root)]
    try:
        for cfg, _ in saved:
            cfg.common.engine.fused_fc_scan = True
        with caplog.at_level(logging.INFO):
            pair = [_workflow(p, "ClassImageLoader", "softmax", layers,
                              **kw) for p in (False, True)]
    finally:
        for cfg, v in saved:
            cfg.common.engine.fused_fc_scan = v
    assert all(wf.train_step._fused_fc is None for wf in pair)
    reasons = [r.getMessage() for r in caplog.records
               if "fused_fc_scan requested but ineligible" in r.getMessage()]
    assert len(reasons) == 2 and reasons[0] == reasons[1], reasons
    assert reasons[0].endswith("device-side augmentation not fused")


def test_image_payload_decodes_through_the_stream_loader(tmp_path):
    """The serving side's decode: a base64 PNG through
    ``RestfulImageLoader.parse_request`` equals the reference's."""
    arr = numpy.random.RandomState(3).rand(8, 8, 3)
    buf = io.BytesIO()
    from PIL import Image
    Image.fromarray((arr * 255).astype(numpy.uint8)).save(buf, format="PNG")
    body = {"image": base64.b64encode(buf.getvalue()).decode()}
    got = loader.RestfulImageLoader(None, sample_shape=(4, 4, 3),
                                    name="ri").parse_request(body)
    want = ref_loader.RestfulImageLoader(None, sample_shape=(4, 4, 3),
                                         name="ri").parse_request(body)
    numpy.testing.assert_array_equal(got, want)
    assert os.path.basename(image.__file__) == "image.py"
