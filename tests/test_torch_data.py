"""The port's data layer and its own copies of the host modules.

``prompt_tts_tpu_torch.data.dataset`` against ``prompt_tts_tpu.data.dataset``
on a tiny code tar written here, and the port's copies of ``config``,
``frontend``, ``utils.wav`` and ``utils.resample`` against the JAX
package's originals: the same inputs must give exactly the same outputs.
"""

import dataclasses
import io
import json
import tarfile

import numpy as np
import pytest

from prompt_tts_tpu import config as jax_config
from prompt_tts_tpu.data import dataset as jax_dataset
from prompt_tts_tpu.frontend.tokenizer import Tokenizer as JaxTokenizer
from prompt_tts_tpu.utils import resample as jax_resample
from prompt_tts_tpu.utils import wav as jax_wav
from prompt_tts_tpu_torch import config as port_config
from prompt_tts_tpu_torch.data import dataset as port_dataset
from prompt_tts_tpu_torch.frontend.tokenizer import Tokenizer
from prompt_tts_tpu_torch.utils import resample as port_resample
from prompt_tts_tpu_torch.utils import wav as port_wav

SENTENCES = [
    "Hello world.",
    "Printing, in the only sense with which we are at present concerned.",
    "Dr. Smith paid $3.50 for 2 apples on Jan 1st, 1999!",
    "Café naïve — résumé; \"quoted\" (parenthetical) text...",
    "",
    "a" * 700,
]


def _add(tf, name, data: bytes):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


@pytest.fixture(scope="module")
def code_tar(tmp_path_factory):
    """Five utterances in the generate_codes layout, two with a
    normalized transcript."""
    rng = np.random.default_rng(0)
    path = tmp_path_factory.mktemp("data") / "codes.tar"
    with tarfile.open(path, "w") as tf:
        for i, text in enumerate(SENTENCES[:5]):
            stem = f"utt{i:02d}"
            buf = io.BytesIO()
            np.save(buf, rng.integers(0, 1024, (8, 24)).astype(np.int64))
            _add(tf, stem + ".npy", buf.getvalue())
            _add(tf, stem + ".txt", text.encode())
            _add(tf, stem + ".len.txt", f"{20 + i}.0".encode())
            if i % 2:
                _add(tf, stem + ".normalized.txt", text.lower().encode())
    return str(path)


# The JAX package collates with its native C++ library when that is built;
# the compiler contracts its c * scale - 1 into one FMA, which rounds once
# where numpy rounds twice: at most one f32 ulp of 1.0 apart.
NATIVE_ATOL = 2.0 ** -23


def _assert_batches_equal(ours, theirs, codes_atol=0.0):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            if k == "codes" and codes_atol:
                np.testing.assert_allclose(a[k], b[k], rtol=0,
                                           atol=codes_atol)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("shuffle,drop_last", [(False, True), (True, True),
                                               (True, False)])
def test_code_dataset_batches_equal_jax(code_tar, shuffle, drop_last, native,
                                        monkeypatch):
    """Exactly the JAX package's numpy collate; within an ulp of its native
    one."""
    if native and jax_dataset.native.get_lib() is None:
        pytest.skip("the JAX package's native collate library is not built")
    if not native:
        monkeypatch.setattr(jax_dataset.native, "get_lib", lambda: None)
    ours = port_dataset.CodeDataset(code_tar, max_seq_length=64)
    theirs = jax_dataset.CodeDataset(code_tar, max_seq_length=64)
    assert len(ours) == len(theirs) == 5
    assert ours.texts == theirs.texts and ours.code_len == theirs.code_len
    kw = dict(batch_size=2, shuffle=shuffle, seed=3, drop_last=drop_last)
    _assert_batches_equal(ours.batches(**kw), theirs.batches(**kw),
                          NATIVE_ATOL if native else 0.0)


def test_synthetic_dataset_batches_equal_jax():
    kw = dict(n=10, frames=16, max_seq_length=32, seed=4)
    ours = port_dataset.SyntheticDataset(**kw)
    theirs = jax_dataset.SyntheticDataset(**kw)
    for shuffle in (False, True):
        _assert_batches_equal(ours.batches(4, shuffle=shuffle, seed=7),
                              theirs.batches(4, shuffle=shuffle, seed=7))


def test_collate_and_prefetch():
    codes = np.array([[[0, 1023], [511, 512]]], np.int16)    # [1, 2, 2]
    out = port_dataset.collate_codes(codes)
    assert out.shape == (1, 2, 2) and out.dtype == np.float32
    np.testing.assert_allclose(out[0], [[-1.0, 511 * 2 / 1023 - 1],
                                        [1.0, 512 * 2 / 1023 - 1]],
                               rtol=0, atol=1e-7)
    assert list(port_dataset.prefetch(iter(range(7)), depth=2)) == list(
        range(7))
    gen = port_dataset.prefetch(iter(range(100)), depth=1)
    assert next(gen) == 0
    gen.close()   # an abandoned consumer does not leak the worker


def test_prefetch_delivers_the_end_to_a_slow_consumer():
    """The producer finishes while the queue is full: the consumer still
    gets every item and then the end (it used to wait forever), and an
    error in the producer reaches the consumer."""
    import threading
    import time

    def consume(items):
        out = []
        for x in port_dataset.prefetch(items, depth=1):
            time.sleep(0.05)     # the producer is always ahead
            out.append(x)
        return out

    def boom():
        yield 1
        raise OSError("truncated tar")

    got = []
    t = threading.Thread(target=lambda: got.append(consume(iter(range(4)))),
                         daemon=True)
    t.start()
    t.join(timeout=20)
    assert not t.is_alive() and got == [[0, 1, 2, 3]]
    with pytest.raises(OSError, match="truncated"):
        consume(boom())


def test_tokenizer_copy_gives_the_same_ids():
    ours, theirs = Tokenizer(max_len=96), JaxTokenizer(max_len=96)
    for text in SENTENCES:
        a, b = ours.encode(text), theirs.encode(text)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=repr(text))
    a, b = ours.encode_batch(SENTENCES), theirs.encode_batch(SENTENCES)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_config_copy_round_trips(tmp_path):
    cfg = port_config.Config(
        model=port_config.ModelConfig(block_out_channels=(32, 64, 64, 64),
                                      cmu_seq_len=48),
        train=port_config.TrainConfig(batch_size=3, lr_scheduler="cosine"))
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    cfg.to_json(str(ours))
    jax_config.Config.from_json(str(ours)).to_json(str(theirs))
    assert json.loads(ours.read_text()) == json.loads(theirs.read_text())
    back = port_config.Config.from_json(str(theirs))
    assert dataclasses.asdict(back) == dataclasses.asdict(cfg)
    assert dataclasses.asdict(port_config.Config()) == dataclasses.asdict(
        jax_config.Config())


def test_wav_copy_writes_the_same_bytes(tmp_path):
    audio = np.random.default_rng(5).uniform(-1.1, 1.1, (480, 2)).astype(
        np.float32)
    ours, theirs = tmp_path / "ours.wav", tmp_path / "theirs.wav"
    port_wav.write_wav(str(ours), audio, 24000)
    jax_wav.write_wav(str(theirs), audio, 24000)
    assert ours.read_bytes() == theirs.read_bytes()
    a, b = port_wav.read_wav(str(ours)), jax_wav.read_wav(str(theirs))
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1] == 24000
    assert port_wav.pcm16_bytes(audio) == jax_wav.pcm16_bytes(audio)
    for n in (None, 480):
        assert port_wav.wav_header(n, 24000) == jax_wav.wav_header(n, 24000)


@pytest.mark.parametrize("orig_sr,shape", [(22050, (3001,)), (16000, (777, 2)),
                                           (48000, (960,)), (24000, (5,))])
def test_resample_copy_gives_the_same_samples(orig_sr, shape):
    """22.05 kHz (LJSpeech) up, 16 kHz up in two channels, 48 kHz down,
    and the identity."""
    audio = np.random.default_rng(orig_sr).uniform(-1, 1, shape).astype(
        np.float32)
    ours = port_resample.resample(audio, orig_sr, 24000)
    theirs = jax_resample.resample(audio, orig_sr, 24000)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)
