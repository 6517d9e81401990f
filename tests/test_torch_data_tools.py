"""The port's data-preparation tools against the JAX package's.

The cases of ``tests/test_data_tools.py`` and ``tests/test_asr.py`` on the
port's copies (``data/{unigram,vad_cut}.py``, ``cli/{vad_cut,
extract_transcript,max_seq_len,generate_transcript}.py``), and each tool's
output against the JAX tool's on the same seeded input: the tar members
bit for bit, the ignore lists and the printed lines equal.  The ASR cases
run the tiny offline checkpoints that ``tests/test_asr.py`` builds, with
``--device cpu``.
"""

import io
import json
import os
import shutil
import tarfile

import numpy as np
import pytest
import torch

from prompt_tts_tpu.cli import extract_transcript as jax_extract
from prompt_tts_tpu.cli import generate_transcript as jax_asr
from prompt_tts_tpu.cli import max_seq_len as jax_max_seq_len
from prompt_tts_tpu.data.unigram import UnigramDecoder as JaxUnigram
from prompt_tts_tpu.data.vad_cut import cut_corpus as jax_cut_corpus
from prompt_tts_tpu_torch.cli import extract_transcript, generate_transcript
from prompt_tts_tpu_torch.cli import max_seq_len, vad_cut
from prompt_tts_tpu_torch.data.unigram import UnigramDecoder
from prompt_tts_tpu_torch.data.vad_cut import cut_corpus
from prompt_tts_tpu_torch.utils.wav import read_wav, write_wav


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _add_bytes(tf, name, data: bytes):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def _members(path):
    """{name: bytes} of a tar's files, in order."""
    with tarfile.open(path) as tf:
        return {m.name: tf.extractfile(m).read() for m in tf.getmembers()
                if m.isfile()}


def _twin(src, tmp_path):
    """Copies of ``src`` in ``jax/`` and ``port/`` under ``tmp_path``."""
    out = []
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir(exist_ok=True)
        out.append(str(shutil.copy(src, d / os.path.basename(src))))
    return out


def _printed(capsys, fn, argv, strip=()):
    fn(argv)
    out = capsys.readouterr().out
    for s in strip:
        out = out.replace(s, "<dir>")
    return out


class TestGenerateCodes:
    def test_roundtrip_to_dataset(self, tmp_path):
        """``cli.generate_codes --device cpu`` -> the port's
        ``CodeDataset`` (the CLI itself is held to JAX's in
        ``test_torch_encode.py``)."""
        from prompt_tts_tpu_torch.cli.generate_codes import main as gen_main
        from prompt_tts_tpu_torch.data.dataset import CodeDataset
        src = str(tmp_path / "corpus.tar")
        rng = np.random.default_rng(0)
        with tarfile.open(src, "w") as tf:
            for i in range(3):
                wav = (rng.normal(size=4800 * (i + 1)) * 0.1).astype(
                    np.float32)
                tmp = str(tmp_path / f"LJ00{i}.wav")
                write_wav(tmp, wav, 24000)
                tf.add(tmp, arcname=f"LJ00{i}.wav")
                _add_bytes(tf, f"LJ00{i}.txt", f"sample text {i}".encode())
                _add_bytes(tf, f"LJ00{i}.normalized.txt",
                           f"sample text {i}".encode())
        gen_main(["--input_file", src, "--batch_size", "2",
                  "--max_duration", "1", "--device", "cpu"])
        out = src.replace(".tar", "_processed.tar")
        names = set(_members(out))
        assert {"LJ000.npy", "LJ000.len.txt", "LJ000.normalized.txt"} <= names
        ds = CodeDataset(out, max_seq_length=64)
        assert len(ds) == 3
        batch = next(ds.batches(2))
        assert batch["codes"].shape == (2, 75, 8)
        assert batch["codes"].min() >= -1.0 and batch["codes"].max() <= 1.0
        assert sorted(ds.code_len) == [15, 30, 45]


class TestExtractTranscript:
    def test_ljspeech_metadata_as_jax(self, tmp_path, capsys):
        src = str(tmp_path / "lj.tar")
        with tarfile.open(src, "w") as tf:
            meta = ("LJ001-0001|Printing, in the only sense|"
                    "Printing, in the only sense\n"
                    "LJ001-0002|Second row|Second row normalized\n"
                    "LJ001-0003||Only normalized\n")
            _add_bytes(tf, "LJSpeech-1.1/metadata.csv", meta.encode())
            tmp = str(tmp_path / "w.wav")
            write_wav(tmp, np.random.default_rng(0).normal(size=100).astype(
                np.float32), 22050)
            tf.add(tmp, arcname="LJSpeech-1.1/wavs/LJ001-0001.wav")
        out = {}
        for side, fn in (("jax", jax_extract.main),
                         ("port", extract_transcript.main)):
            path = str(tmp_path / f"{side}.tar")
            said = _printed(capsys, fn, ["--input_file", src,
                                         "--output_file", path], [path])
            out[side] = (said, _members(path))
        assert out["port"] == out["jax"]
        said, members = out["port"]
        assert "3 transcripts" in said
        assert members["LJ001-0002.normalized.txt"] == b"Second row normalized"
        assert members["LJ001-0003.txt"] == b"Only normalized"
        assert any(n.endswith(".wav") for n in members)
        with pytest.raises(SystemExit, match="overwrite"):
            extract_transcript.main(["--input_file", src, "--output_file",
                                     src])


class TestMaxSeqLen:
    @pytest.mark.parametrize("kind", ["csv", "txt", "tar"])
    def test_printed_lengths_as_jax(self, kind, tmp_path, capsys):
        texts = ["Hello world.", "Printing, in the only sense with which we "
                 "are at present concerned.", "One two three, 42 dollars!"]
        path = str(tmp_path / f"corpus.{kind}")
        if kind == "csv":
            with open(path, "w") as f:
                f.writelines(f"LJ{i}|raw {t}|{t}\n" for i, t in
                             enumerate(texts))
        elif kind == "txt":
            with open(path, "w") as f:
                f.write("\n".join(texts + [""]))
        else:
            with tarfile.open(path, "w") as tf:
                for i, t in enumerate(texts):
                    _add_bytes(tf, f"u{i}.normalized.txt", t.encode())
                    _add_bytes(tf, f"u{i}.txt", b"ignored")
                    _add_bytes(tf, f"u{i}.len.txt", b"99")
        said = [_printed(capsys, fn, ["--input", path])
                for fn in (jax_max_seq_len.main, max_seq_len.main)]
        assert said[1] == said[0]
        assert "utterances: 3" in said[1]
        assert list(max_seq_len.iter_texts(path)) == list(
            jax_max_seq_len.iter_texts(path))

    def test_no_texts_exits(self, tmp_path):
        path = str(tmp_path / "empty.txt")
        open(path, "w").close()
        with pytest.raises(SystemExit, match="no texts"):
            max_seq_len.main(["--input", path])


def _books_tar(tmp_path):
    src = str(tmp_path / "books.tar")
    sr = 16000
    with tarfile.open(src, "w") as tf:
        for b in range(2):
            wav = np.sin(np.arange(sr * 30) * 0.05 * (b + 1)).astype(
                np.float32)
            tmp = str(tmp_path / "b.wav")
            write_wav(tmp, wav, sr)
            tf.add(tmp, arcname=f"spk/book{b}/chap.wav")
            meta = {"book_meta": {"id": f"book{b}"},
                    "voice_activity": [[0.0, 4.0], [5.0, 9.0],
                                       [10.0, 16.0], [17.0, 25.0]]}
            _add_bytes(tf, f"spk/book{b}/chap.json",
                       json.dumps(meta).encode())
    return src


class TestVadCut:
    def test_cut_sequence_and_resume(self, tmp_path, capsys):
        """The JAX case on the port's CLI: segments, valid 16 kHz wavs, and
        a second run that resumes to nothing."""
        src = _books_tar(tmp_path)
        state = str(tmp_path)
        said = _printed(capsys, vad_cut.main, [
            "--input_dir", src, "--n_workers", "2", "--state_dir", state])
        assert said == "segmented 2 items (0 errors)\n"
        seg_tars = [str(tmp_path / f"books_vad_{i}.tar") for i in range(2)]
        segs = {}
        for st in seg_tars:
            if os.path.exists(st):
                segs.update(_members(st))
        assert len(segs) >= 2
        audio, sr = read_wav(io.BytesIO(next(iter(segs.values()))))
        assert sr == 16000 and len(audio) > 0
        assert cut_corpus(src, n_workers=2, state_dir=state) == (0, 0)

    def test_segments_as_jax(self, tmp_path):
        """The same tar through both packages' ``cut_corpus``: the same
        counts, segment tars bit-equal member for member, the same ignore
        list (this process's string hash seeds both, as the worker's
        ``hash(meta_name)``)."""
        src = _books_tar(tmp_path)
        jsrc, psrc = _twin(src, tmp_path)
        got = [fn(s, n_workers=2, state_dir=os.path.dirname(s))
               for fn, s in ((jax_cut_corpus, jsrc), (cut_corpus, psrc))]
        assert got[0] == got[1] == (2, 0)
        for i in range(2):
            tars = [s.replace(".tar", f"_vad_{i}.tar") for s in (jsrc, psrc)]
            assert _members(tars[1]) == _members(tars[0])
        lists = [sorted(open(os.path.join(os.path.dirname(s),
                                          "ignore_list.txt")).readlines())
                 for s in (jsrc, psrc)]
        assert lists[0] == lists[1] and len(lists[1]) == 2

    def test_errors_are_listed_and_skipped(self, tmp_path):
        """A broken item goes to the error list (written by the parent) and
        is skipped on resume, as in JAX."""
        src = str(tmp_path / "bad.tar")
        with tarfile.open(src, "w") as tf:
            _add_bytes(tf, "spk/b/chap.json", json.dumps(
                {"voice_activity": [[0.0, 1.0]]}).encode())
        assert cut_corpus(src, n_workers=1, state_dir=str(tmp_path)) == (
            0, 1)
        assert open(tmp_path / "error_list.txt").read() == \
            "spk/b/chap.json\n"
        assert cut_corpus(src, n_workers=1, state_dir=str(tmp_path)) == (
            0, 0)


# --- ASR pseudo-labels (tests/test_asr.py's tiny offline checkpoints) ---

@pytest.fixture(scope="module")
def tiny_ctc_checkpoint(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny_wav2vec2")
    from transformers import (
        Wav2Vec2Config, Wav2Vec2CTCTokenizer, Wav2Vec2FeatureExtractor,
        Wav2Vec2ForCTC, Wav2Vec2Processor,
    )
    vocab = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4}
    for i, ch in enumerate("abcdefghijklmnopqrstuvwxyz"):
        vocab[ch] = 5 + i
    vocab_path = d / "vocab.json"
    vocab_path.write_text(json.dumps(vocab))
    tok = Wav2Vec2CTCTokenizer(str(vocab_path), unk_token="<unk>",
                               pad_token="<pad>", word_delimiter_token="|")
    fe = Wav2Vec2FeatureExtractor(feature_size=1, sampling_rate=16000,
                                  padding_value=0.0,
                                  return_attention_mask=False)
    Wav2Vec2Processor(feature_extractor=fe,
                      tokenizer=tok).save_pretrained(str(d))
    torch.manual_seed(0)
    cfg = Wav2Vec2Config(
        vocab_size=len(vocab), hidden_size=32, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=64,
        conv_dim=(32, 32), conv_stride=(4, 4), conv_kernel=(8, 8),
        num_feat_extract_layers=2, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=2, do_stable_layer_norm=False,
        architectures=["Wav2Vec2ForCTC"])
    Wav2Vec2ForCTC(cfg).save_pretrained(str(d))
    return str(d)


@pytest.fixture(scope="module")
def tiny_s2t_checkpoint(tmp_path_factory):
    """Speech2Text seq2seq with sentencepiece-style pieces in vocab.json, so
    decode goes through the unigram shim."""
    d = tmp_path_factory.mktemp("tiny_s2t")
    from transformers import (
        Speech2TextConfig, Speech2TextFeatureExtractor,
        Speech2TextForConditionalGeneration,
    )
    pieces = ["<s>", "<pad>", "</s>", "<unk>"] + [
        "▁the", "▁a", "▁and", "cat", "dog", "s",
        "▁quick", "brown", "ing", "ed", "▁fox",
    ]
    (d / "vocab.json").write_text(
        json.dumps({t: i for i, t in enumerate(pieces)}), encoding="utf-8")
    (d / "special_tokens_map.json").write_text(json.dumps({
        "bos_token": "<s>", "eos_token": "</s>",
        "pad_token": "<pad>", "unk_token": "<unk>"}))
    torch.manual_seed(0)
    cfg = Speech2TextConfig(
        vocab_size=len(pieces), d_model=32, encoder_layers=1,
        decoder_layers=1, encoder_attention_heads=2,
        decoder_attention_heads=2, encoder_ffn_dim=64, decoder_ffn_dim=64,
        num_conv_layers=1, conv_kernel_sizes=(5,), conv_channels=32,
        input_feat_per_channel=80, input_channels=1,
        max_source_positions=600, max_target_positions=32,
        pad_token_id=1, bos_token_id=0, eos_token_id=2,
        decoder_start_token_id=2, max_length=8,
        architectures=["Speech2TextForConditionalGeneration"])
    Speech2TextForConditionalGeneration(cfg).save_pretrained(str(d))
    Speech2TextFeatureExtractor(
        feature_size=80, num_mel_bins=80, sampling_rate=16000,
        padding_value=0.0).save_pretrained(str(d))
    return str(d)


@pytest.fixture()
def wav_tar(tmp_path):
    tar_path = tmp_path / "cut.tar"
    rng = np.random.default_rng(0)
    with tarfile.open(tar_path, "w") as tf:
        for i in range(3):
            wav = (rng.standard_normal(16000 // 4) * 0.1).astype(np.float32)
            tmp = tmp_path / f"u{i}.wav"
            write_wav(str(tmp), wav, 16000)
            tf.add(str(tmp), arcname=f"u{i}.wav")
    return str(tar_path)


class TestGenerateTranscript:
    def test_args(self):
        a = generate_transcript.parse_args(["--input_file", "x.tar",
                                            "--model_dir", "m"])
        assert a.batch_size == 8 and a.state_dir == "."
        assert a.device == "cuda"

    def test_missing_model_dir_exits(self, tmp_path):
        with pytest.raises(SystemExit):
            generate_transcript.main(["--input_file", "x.tar", "--model_dir",
                                      str(tmp_path / "nope")])

    @pytest.mark.parametrize("arch", ["ctc", "s2t"])
    def test_transcribe_and_resume_as_jax(self, arch, tiny_ctc_checkpoint,
                                          tiny_s2t_checkpoint, wav_tar,
                                          tmp_path, capsys):
        """Both architectures: the port with ``--device cpu`` writes the
        JAX tool's transcripts bit for bit and the same ignore list; a
        second run resumes to nothing.  (The s2t branch decodes through
        the sentencepiece-free unigram shim.)"""
        ckpt = tiny_ctc_checkpoint if arch == "ctc" else tiny_s2t_checkpoint
        out = {}
        for side, fn, extra in (("jax", jax_asr.main, []),
                                ("port", generate_transcript.main,
                                 ["--device", "cpu"])):
            d = tmp_path / side
            d.mkdir()
            src = str(shutil.copy(wav_tar, d / "cut.tar"))
            argv = ["--input_file", src, "--model_dir", ckpt,
                    "--batch_size", "2", "--state_dir", str(d)] + extra
            said = _printed(capsys, fn, argv, [str(d)])
            out[side] = (said, _members(src.replace(".tar", "_asr.tar")),
                         open(d / "asr_ignore_list.txt").read())
            if side == "port":
                assert _printed(capsys, fn, argv, [str(d)]) == \
                    "wrote <dir>/cut_asr.tar (0 transcripts)\n"
                assert len(_members(src.replace(".tar", "_asr.tar"))) == 3
        assert out["port"] == out["jax"]
        said, members, ignore = out["port"]
        assert said == "wrote <dir>/cut_asr.tar (3 transcripts)\n"
        assert sorted(members) == ["u0.txt", "u1.txt", "u2.txt"]
        assert ignore.count("\n") == 3
        for text in members.values():
            text = text.decode()
            assert "▁" not in text and "<" not in text


class TestUnigramDecoder:
    def test_decode_semantics(self, tiny_s2t_checkpoint):
        dec = UnigramDecoder(tiny_s2t_checkpoint)
        ids = [0, 4, 14, 9, 2, 10, 11, 1]
        assert dec.decode(ids) == "the foxs quickbrown"
        assert dec.batch_decode([ids, [2, 1]]) == ["the foxs quickbrown",
                                                   ""]
        jdec = JaxUnigram(tiny_s2t_checkpoint)
        assert dec.special_ids == jdec.special_ids
        assert dec.id_to_token == jdec.id_to_token
