"""The port's file loaders (loader/file_loader.py, pickles.py, hdf5.py,
saver.py, ensemble.py, sound.py, kv_store.py) against the reference's on
the same files and seed, on the CPU: ``original_data``, the labels and
``class_lengths`` equal the reference's exactly (the validation split
carved by ``validation_ratio`` too, from the same keyed stream); the
minibatch files cross between the packages both ways; HDF5 through the
installed ``h5py``; sound from a ``.wav`` the stdlib writes; HDFS text
from a local WebHDFS-shaped HTTP server; a missing ``lmdb`` raises a
VelesError naming it; the streaming loaders resolve through the loader
registry to their ported classes.
"""
import http.server
import json
import os
import pickle
import threading
import wave

import numpy
import pytest

from veles_tpu import loader as ref_loader
from veles_tpu import prng as ref_prng
from veles_tpu.loader import kv_store as ref_kv
from veles_tpu_torch import loader
from veles_tpu_torch import prng
from veles_tpu_torch.error import VelesError
from veles_tpu_torch.loader import kv_store


def _pair(name, *args, seed=3, **kw):
    """The reference's and the port's loader ``name`` from the same
    arguments, each ``load_data``-ed under the same seed."""
    ref = getattr(ref_loader, name)(None, *args, name="fl", **kw)
    port = getattr(loader, name)(None, *args, name="fl", **kw)
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
    if ref.original_labels:
        numpy.testing.assert_array_equal(port.original_labels.mem,
                                         ref.original_labels.mem)
    else:
        assert not port.original_labels


def _data(n, d=6, seed=0, classes=3):
    rng = numpy.random.RandomState(seed)
    return (rng.randn(n, d).astype(numpy.float32),
            rng.randint(0, classes, n).astype(numpy.int32))


@pytest.mark.parametrize("form", ["tuple", "dict", "array"])
@pytest.mark.parametrize("ratio", [None, 0.25])
def test_pickles_loader_equals_the_reference(tmp_path, form, ratio):
    files = [None]
    for i, n in enumerate((12, 40)):
        x, y = _data(n, seed=i)
        obj = {"tuple": (x, y), "dict": {"data": x, "labels": y},
               "array": x}[form]
        if ratio and i == 0:
            files.append(None)
            continue
        path = tmp_path / ("c%d.pickle" % i)
        with open(path, "wb") as fout:
            pickle.dump(obj, fout)
        files.append(str(path))
    ref, port = _pair("PicklesLoader", files=files, validation_ratio=ratio)
    _assert_same(ref, port)
    with pytest.raises(VelesError, match="test, validation, train"):
        loader.PicklesLoader(None, files=files[:2])


def test_hdf5_loader_equals_the_reference(tmp_path):
    h5py = pytest.importorskip("h5py")
    files = [None]
    for i, n in enumerate((10, 30)):
        x, y = _data(n, seed=i + 4)
        path = str(tmp_path / ("c%d.h5" % i))
        with h5py.File(path, "w") as fout:
            fout["data"] = x
            fout["labels"] = y
        files.append(path)
    ref, port = _pair("HDF5Loader", files=files)
    _assert_same(ref, port)
    ref, port = _pair("HDF5Loader", files=[None, None, files[2]],
                      validation_ratio=0.2)
    _assert_same(ref, port)
    bad = loader.HDF5Loader(None, files=files, data_key="nope")
    with pytest.raises(VelesError, match="nope"):
        bad.load_data()


def test_hdf5_loader_names_a_missing_h5py(monkeypatch, tmp_path):
    import builtins
    real = builtins.__import__

    def no_h5py(name, *args, **kw):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real(name, *args, **kw)
    monkeypatch.setattr(builtins, "__import__", no_h5py)
    ld = loader.HDF5Loader(None, files=[None, None, str(tmp_path / "x")])
    with pytest.raises(VelesError, match="h5py"):
        ld.load_data()


def _served(ld_cls, saver_cls, path, seed):
    """A loader of 3 classes served one whole epoch (host fill, no
    shuffle) through a MinibatchesSaver into ``path``."""
    def load_data(self):
        x, y = _data(47, seed=seed)
        self.create_originals(x, y)
        self.class_lengths = [7, 10, 30]
    src = type("Src", (ld_cls,), {"hide_from_registry": True,
                                  "load_data": load_data})(
        None, minibatch_size=8, shuffle_limit=-1, name="src")
    src.initialize()
    saver = saver_cls(None, file_name=str(path))
    saver.loader = src
    saver.initialize()
    while True:
        src.run()
        saver.run()
        if bool(src.epoch_ended):
            break
    saver.stop()
    return src


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_minibatch_files_cross_between_the_packages(tmp_path, writer):
    path = tmp_path / "mb.vtmb"
    if writer == "port":
        src = _served(loader.FullBatchLoader, loader.MinibatchesSaver,
                      path, 5)
    else:
        src = _served(ref_loader.FullBatchLoader,
                      ref_loader.MinibatchesSaver, path, 5)
    ref, port = _pair("MinibatchesLoader", file_name=str(path))
    _assert_same(ref, port)
    # served in offset order without a shuffle: the replay IS the source
    assert port.class_lengths == [7, 10, 30]
    numpy.testing.assert_array_equal(port.original_data.mem,
                                     src.original_data.mem)
    numpy.testing.assert_array_equal(port.original_labels.mem,
                                     src.original_labels.mem)
    bad = tmp_path / "bad.vtmb"
    import gzip
    with gzip.open(bad, "wb") as fout:
        fout.write(b"nope")
    with pytest.raises(VelesError, match="not a minibatches file"):
        loader.MinibatchesLoader(None, file_name=str(bad)).load_data()


def test_ensemble_loader_equals_the_reference(tmp_path):
    outs = []
    for i in range(3):
        p = numpy.random.RandomState(i).rand(40, 4).astype(numpy.float32)
        path = tmp_path / ("m%d.npy" % i)
        numpy.save(path, p)
        outs.append(str(path))
    numpy.save(tmp_path / "labels.npy", _data(40)[1])
    man = tmp_path / "outputs.json"
    man.write_text(json.dumps({"outputs": outs,
                               "labels": str(tmp_path / "labels.npy")}))
    ref, port = _pair("EnsembleLoader", manifest=str(man),
                      validation_ratio=0.25)
    _assert_same(ref, port)
    assert port.original_data.shape == (40, 12)
    man.write_text(json.dumps({"outputs": []}))
    with pytest.raises(VelesError, match="no member outputs"):
        loader.EnsembleLoader(None, manifest=str(man)).load_data()


def _wav(path, frames, channels=2, width=2, rate=8000, seed=0):
    rng = numpy.random.RandomState(seed)
    if width == 2:
        raw = (rng.randn(frames * channels) * 8000).astype("<i2")
    else:
        raw = rng.randint(0, 256, frames * channels).astype(numpy.uint8)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(raw.tobytes())
    return str(path)


def test_sound_loader_equals_the_reference(tmp_path):
    files = [_wav(tmp_path / "a.wav", 3000, seed=1),
             _wav(tmp_path / "b.wav", 2500, channels=1, width=1, seed=2)]
    ref, port = _pair("SoundFileLoader", files=files, labels=[4, 1],
                      window=256, stride=200)
    _assert_same(ref, port)
    assert port.sample_rate == ref.sample_rate == 8000
    for f in files:
        got, rate = loader.decode_audio(f)
        want, rate_ref = ref_loader.decode_audio(f)
        numpy.testing.assert_array_equal(got, want)
        assert rate == rate_ref
    short = _wav(tmp_path / "s.wav", 10)
    with pytest.raises(VelesError, match="shorter than window"):
        loader.SoundFileLoader(None, files=[short], window=256).load_data()
    other = _wav(tmp_path / "r.wav", 3000, rate=16000)
    with pytest.raises(VelesError, match="sample rate"):
        loader.SoundFileLoader(None, files=[files[0], other],
                               window=256).load_data()


def test_kv_records_equal_the_reference():
    sample = numpy.arange(12, dtype=numpy.float32).reshape(3, 4)
    rec = kv_store.encode_record(sample, 7)
    assert rec == ref_kv.encode_record(sample, 7)
    got, label = kv_store.decode_record(rec)
    numpy.testing.assert_array_equal(got, sample)
    assert label == 7
    line = "0.5\t-1.25\t3.0\t2\n"
    a, la = kv_store.parse_tsv_line(line)
    b, lb = ref_kv.parse_tsv_line(line)
    numpy.testing.assert_array_equal(a, b)
    assert la == lb == 2


def test_lmdb_loader_names_the_missing_package():
    ld = loader.LMDBLoader(None, databases=[None, None, "db"])
    try:
        import lmdb  # noqa: F401
        pytest.skip("lmdb is installed here")
    except ImportError:
        pass
    with pytest.raises(VelesError, match="lmdb"):
        ld.load_data()
    with pytest.raises(VelesError, match="test, validation, train"):
        loader.LMDBLoader(None, databases=["db"])


class _WebHDFS(http.server.BaseHTTPRequestHandler):
    files = {}

    def do_GET(self):
        path, _, query = self.path.partition("?")
        body = self.files.get(path[len("/webhdfs/v1"):])
        if body is None or query != "op=OPEN":
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


def test_hdfs_text_loader_equals_the_reference_over_http():
    rng = numpy.random.RandomState(8)

    def text(n):
        return "".join("\t".join("%.4f" % v for v in rng.randn(5))
                       + "\t%d\n" % rng.randint(3) for _ in range(n))
    _WebHDFS.files = {"/data/valid.tsv": text(9).encode(),
                      "/data/train.tsv": ("\n" + text(21)).encode()}
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _WebHDFS)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = "http://127.0.0.1:%d" % server.server_address[1]
        ref, port = _pair("HDFSTextLoader", namenode=url,
                          paths=[None, "/data/valid.tsv",
                                 "/data/train.tsv"])
        _assert_same(ref, port)
        assert port.class_lengths == [0, 9, 21]
        with pytest.raises(VelesError, match="namenode"):
            loader.HDFSTextLoader(None, paths=[None, None, "/x"]).load_data()
    finally:
        server.shutdown()
        server.server_close()


def test_file_scanning_equals_the_reference(tmp_path):
    for rel in ("cats/a.png", "cats/b.jpg", "dogs/c.png", "dogs/d.txt",
                "dogs/sub/e.png"):
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(b"x")
    flt = loader.FileFilter(include=("*.png", "*.jpg"), exclude=("b*",))
    ref_flt = ref_loader.FileFilter(include=("*.png", "*.jpg"),
                                    exclude=("b*",))
    assert flt.scan(str(tmp_path)) == ref_flt.scan(str(tmp_path))
    got = loader.FileListScanner([str(tmp_path / "cats")],
                                 [str(tmp_path / "dogs")],
                                 file_filter=flt).scan()
    want = ref_loader.FileListScanner([str(tmp_path / "cats")],
                                      [str(tmp_path / "dogs")],
                                      file_filter=ref_flt).scan()
    assert got == want and len(got[2]) == 1
    assert [loader.auto_label(f) for f in got[1]] == \
        [ref_loader.auto_label(f) for f in want[1]] == ["dogs", "sub"]
    with pytest.raises(VelesError, match="does not exist"):
        loader.FileListScanner([str(tmp_path / "nope")]).scan()


@pytest.mark.parametrize("name, want", [
    ("restful_loader", "RestfulLoader"), ("RestfulLoader", "RestfulLoader"),
    ("interactive_loader", "StreamLoader"),
    ("zeromq_loader", "ZeroMQLoader"), ("StreamLoader", "StreamLoader")])
def test_stream_loaders_resolve_to_ported_classes(name, want):
    """The streaming loaders' registry and class names resolve to the
    port's classes in ``loader/stream.py``, which the package exports
    as the reference's does."""
    from veles_tpu_torch.loader import stream
    cls = loader.loader_class(name)
    assert cls is getattr(stream, want) is getattr(loader, want)
    assert cls.__name__ == getattr(ref_loader, want).__name__
    assert cls.MAPPING == getattr(ref_loader, want).MAPPING
    assert loader.loader_class("pickles_loader") is loader.PicklesLoader
    assert os.path.basename(loader.__file__) == "__init__.py"
