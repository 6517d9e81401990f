"""The port's streaming data path: ``data/native.py`` and
``data/streaming.py``.

The native library (built here with ``g++`` under ``build/native/``) and
its numpy fallbacks against ``tarfile`` and numpy; ``StreamingCodeDataset``
batches bit-equal to the port's in-RAM ``CodeDataset`` and to the JAX
package's ``StreamingCodeDataset`` (prompt crops included); both datasets'
per-process shards against the JAX package's; the streaming generator's
thread stops when it is closed;
``cli.train --streaming`` on the CPU.
"""

import io
import tarfile
import threading
import time

import numpy as np
import pytest

from prompt_tts_tpu.data import streaming as jax_streaming
from prompt_tts_tpu_torch.data import native
from prompt_tts_tpu_torch.data.dataset import CodeDataset
from prompt_tts_tpu_torch.data.streaming import StreamingCodeDataset

TEXTS = ["Hello world.", "Printing, in the only sense.", "One two three.",
         "The quick brown fox.", "A fifth one.", "Six.", "Seven and last."]


def _add(tf, name, data: bytes):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


@pytest.fixture(scope="module")
def corpus_tar(tmp_path_factory):
    """Seven utterances in the generate_codes layout: ragged lengths, two
    with a normalized transcript."""
    rng = np.random.default_rng(0)
    path = str(tmp_path_factory.mktemp("stream") / "corpus.tar")
    with tarfile.open(path, "w") as tf:
        for i, text in enumerate(TEXTS):
            stem = f"utt{i:02d}"
            buf = io.BytesIO()
            np.save(buf, rng.integers(0, 1024, (8, 60)).astype(np.int64))
            _add(tf, stem + ".npy", buf.getvalue())
            _add(tf, stem + ".txt", text.encode())
            _add(tf, stem + ".len.txt", f"{30 + 4 * i}.0".encode())
            if i % 3 == 1:
                _add(tf, stem + ".normalized.txt", text.lower().encode())
    return path


@pytest.fixture
def fallback(monkeypatch):
    """The port's native module with its numpy fallbacks."""
    monkeypatch.setattr(native, "get_lib", lambda: None)


def test_native_library_builds_and_loads():
    assert native.available()
    assert native.get_lib() is not None
    assert str(native.BUILD_DIR).endswith("build/native")


@pytest.mark.parametrize("lib", ["native", "fallback"])
def test_tar_index_and_read_match_tarfile(corpus_tar, lib, request):
    if lib == "fallback":
        request.getfixturevalue("fallback")
    index = native.tar_index(corpus_tar)
    with tarfile.open(corpus_tar) as tf:
        members = [m for m in tf.getmembers() if m.isfile()]
        assert [(m.name, m.offset_data, m.size) for m in members] == index
        for m in members:
            assert native.read_at(corpus_tar, m.offset_data, m.size) == \
                tf.extractfile(m).read()


@pytest.mark.parametrize("lib", ["native", "fallback"])
def test_npy_and_collate_match_numpy(lib, request):
    if lib == "fallback":
        request.getfixturevalue("fallback")
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 1024, (8, 75))
    for dtype in (np.int64, np.int32, np.int16):
        buf = io.BytesIO()
        np.save(buf, codes.astype(dtype))
        got = native.npy_to_i16(buf.getvalue())
        assert got.dtype == np.int16
        np.testing.assert_array_equal(got, codes)
    batch = rng.integers(0, 1024, (3, 8, 75)).astype(np.int16)
    want = np.ascontiguousarray(
        (batch.astype(np.float32) * (2.0 / 1023.0) - 1.0).transpose(0, 2, 1))
    np.testing.assert_array_equal(native.collate_codes(batch), want)


def _assert_same(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("lib", ["native", "fallback"])
@pytest.mark.parametrize("prompt_frames", [None, 16, 64])
@pytest.mark.parametrize("shuffle", [False, True])
def test_batches_equal_the_in_ram_dataset(corpus_tar, lib, prompt_frames,
                                          shuffle, request):
    if lib == "fallback":
        request.getfixturevalue("fallback")
    stream = StreamingCodeDataset(corpus_tar, max_seq_length=32,
                                  prompt_frames=prompt_frames)
    ram = CodeDataset(corpus_tar, max_seq_length=32,
                      prompt_frames=prompt_frames)
    assert len(stream) == len(ram) == 7
    kw = dict(batch_size=3, shuffle=shuffle, seed=5)
    _assert_same(stream.batches(**kw), ram.batches(**kw))


def _jax_in_order(monkeypatch):
    """The JAX streaming dataset's batches without its prefetch thread: the
    same batches in the same order.  That ``prefetch`` (``prompt_tts_tpu/
    data/dataset.py:51``) drops its end sentinel when its queue is full as
    the worker finishes, and its consumer then waits forever; the port's
    copy was repaired (``ROADMAP.md`` section 3), the JAX package stays as
    it is."""
    monkeypatch.setattr(jax_streaming, "prefetch",
                        lambda iterator, depth=2: iterator)


@pytest.mark.parametrize("prompt_frames", [None, 16])
def test_batches_equal_jax_streaming(corpus_tar, prompt_frames, monkeypatch):
    """Bit-equal to the JAX package's streaming dataset with its numpy
    collate (its native build may fuse the collate's multiply-add, which
    the port's build does not)."""
    monkeypatch.setattr(jax_streaming.native, "get_lib", lambda: None)
    _jax_in_order(monkeypatch)
    ours = StreamingCodeDataset(corpus_tar, max_seq_length=32,
                                prompt_frames=prompt_frames)
    theirs = jax_streaming.StreamingCodeDataset(
        corpus_tar, max_seq_length=32, prompt_frames=prompt_frames)
    kw = dict(batch_size=2, shuffle=True, seed=9)
    _assert_same(ours.batches(**kw), theirs.batches(**kw))


@pytest.mark.parametrize("prompt_frames", [None, 16])
@pytest.mark.parametrize("rank", [0, 1])
def test_process_shard_is_jax(corpus_tar, rank, prompt_frames, monkeypatch):
    """Rank ``rank`` of 2: the in-RAM and streaming datasets' shards are
    bit-equal to the JAX package's datasets under the same shard (prompt
    crops seeded by rank); without prompts, the ranks' rows concatenated
    are the whole batch."""
    from prompt_tts_tpu.data import dataset as jax_dataset
    monkeypatch.setattr(jax_streaming.native, "get_lib", lambda: None)
    _jax_in_order(monkeypatch)
    kw = dict(batch_size=2, shuffle=True, seed=9)
    shard = dict(kw, process_shard=(rank, 2))
    ram = CodeDataset(corpus_tar, max_seq_length=32,
                      prompt_frames=prompt_frames)
    stream = StreamingCodeDataset(corpus_tar, max_seq_length=32,
                                  prompt_frames=prompt_frames)
    jax_ram = jax_dataset.CodeDataset(corpus_tar, max_seq_length=32,
                                      prompt_frames=prompt_frames)
    jax_stream = jax_streaming.StreamingCodeDataset(
        corpus_tar, max_seq_length=32, prompt_frames=prompt_frames)
    _assert_same(ram.batches(**shard), jax_ram.batches(**shard))
    _assert_same(stream.batches(**shard), jax_stream.batches(**shard))
    _assert_same(stream.batches(**shard), ram.batches(**shard))
    if prompt_frames is None:
        whole = list(ram.batches(**kw))
        parts = [list(stream.batches(**dict(kw, process_shard=(r, 2))))
                 for r in (0, 1)]
        for b, p0, p1 in zip(whole, *parts):
            assert p0["codes"].shape[0] == 1
            for k in b:
                np.testing.assert_array_equal(
                    np.concatenate([p0[k], p1[k]]), b[k], err_msg=k)


def test_closing_the_generator_stops_its_thread(corpus_tar):
    stream = StreamingCodeDataset(corpus_tar, max_seq_length=32,
                                  prefetch_depth=1)
    before = threading.active_count()
    it = stream.batches(1)
    next(it)
    it.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


def test_cli_train_streaming_on_cpu(corpus_tar, tmp_path):
    """``cli.train --streaming`` takes the streaming dataset and logs the
    losses of the in-RAM run, step for step."""
    import json

    import torch

    from prompt_tts_tpu_torch.cli import train as cli
    from prompt_tts_tpu_torch.config import Config, ModelConfig, TrainConfig
    cfg = str(tmp_path / "cfg.json")
    Config(model=ModelConfig(
        block_out_channels=(16, 32, 32, 32), cross_attention_dim=32,
        attention_head_dim=16, text_encoder_layers=1, cmu_seq_len=32,
        sample_size=60, layers_per_block=1, unet_num_heads=2,
        norm_num_groups=8),
        train=TrainConfig(batch_size=3, num_train_epochs=1)).to_json(cfg)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        losses = {}
        for mode in ("ram", "stream"):
            log_dir = tmp_path / mode
            argv = ["--data_file", corpus_tar, "--config_file", cfg,
                    "--max_seq_length", "32", "--log_dir", str(log_dir),
                    "--device", "cpu"]
            torch.manual_seed(0)        # the text encoder's dropout
            trainer = cli.main(argv + (["--streaming"] if mode == "stream"
                                       else []))
            assert isinstance(trainer.dataset, StreamingCodeDataset) == (
                mode == "stream")
            with open(log_dir / "metrics.jsonl") as f:
                losses[mode] = [r["value"] for r in map(json.loads, f)
                                if r["tag"] == "Loss/train"]
    finally:
        torch.set_num_threads(n)
    assert len(losses["ram"]) == 2
    assert losses["stream"] == losses["ram"]
