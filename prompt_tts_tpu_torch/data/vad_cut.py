"""VAD-based corpus segmentation (LibriLight-style audiobooks).

The port's copy of ``prompt_tts_tpu/data/vad_cut.py`` (numpy and the
port's ``utils.wav``; nothing of the JAX package), the same code.

Equivalent of reference data_preparation/cut_by_vad.py:16-164: greedily
stitches voice-activity spans into ~10/20 s segments at 16 kHz and appends
them to per-worker output tars, resumable via ignore/error lists.

Differences from the reference, by design (SURVEY.md §7 known defects):
* the directory-mode path actually works (the reference's ``cut_book``
  calls ``cut_sequence`` with the wrong arity, cut_by_vad.py:78);
* ignore/error list writes are serialized through the parent process
  instead of racing appends from 32 workers (cut_by_vad.py:106-110);
* audio decode uses the built-in WAV reader; FLAC requires the optional
  ``soundfile`` package and fails with a clear message otherwise.
"""

import io
import json
import multiprocessing
import os
import pathlib
import random
import tarfile
import tempfile
from typing import List, Optional, Sequence, Tuple

import numpy as np

from prompt_tts_tpu_torch.utils.wav import read_wav, write_wav

TARGET_SR = 16000


def _read_audio(data: bytes, name: str) -> Tuple[np.ndarray, int]:
    if name.endswith(".wav"):
        audio, sr = read_wav(io.BytesIO(data))
        return audio[:, 0], sr
    if name.endswith(".flac"):
        try:
            import soundfile as sf
        except ImportError as e:
            raise RuntimeError(
                "FLAC input requires the optional 'soundfile' package; "
                "convert the corpus to wav or install soundfile") from e
        audio, sr = sf.read(io.BytesIO(data))
        if audio.ndim > 1:
            audio = audio[:, 0]
        return audio.astype(np.float32), sr
    raise ValueError(f"unsupported audio file {name}")


def cut_sequence(
    data: np.ndarray,
    samplerate: int,
    vad: Sequence[Tuple[float, float]],
    path_out: str,
    out_tar: str,
    rng: Optional[random.Random] = None,
) -> int:
    """Stitch VAD spans into segments and append them to ``out_tar``.

    Returns the number of segments written.  Greedy policy matches the
    reference (cut_by_vad.py:30-56): accumulate spans until the next span
    would exceed a random target of 10 or 20 s, then flush.
    """
    if data.ndim != 1:
        raise ValueError("expected mono audio")
    if samplerate != TARGET_SR:
        raise ValueError(f"expected {TARGET_SR} Hz audio, got {samplerate}")
    rng = rng or random.Random(0)

    to_stitch: List[np.ndarray] = []
    length_accumulated = 0.0
    index = 0
    target_len_sec = rng.choice([10, 20])
    for start, end in vad:
        chunk = data[int(start * samplerate): int(end * samplerate)]
        if length_accumulated + (end - start) > target_len_sec \
                and length_accumulated > 0:
            _save_segment(to_stitch, path_out, index, out_tar)
            index += 1
            to_stitch = []
            length_accumulated = 0.0
            target_len_sec = rng.choice([10, 20])
        to_stitch.append(chunk)
        length_accumulated += end - start
    if to_stitch:
        _save_segment(to_stitch, path_out, index, out_tar)
        index += 1
    return index


def _save_segment(chunks: List[np.ndarray], path_out: str, index: int,
                  out_tar: str) -> None:
    output = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    file_name = f"{str(path_out).replace('/', '_')}_{index:04d}.wav"
    with tempfile.TemporaryDirectory() as dirname:
        tmp = os.path.join(dirname, file_name)
        write_wav(tmp, output, TARGET_SR)
        with tarfile.open(out_tar, "a") as tf:
            tf.add(tmp, arcname=file_name)


def _worker(task):
    meta_name, dataset_path, tar_file, worker_id = task
    try:
        with tarfile.open(tar_file, "r") as tf:
            audio_name = meta_name.replace(".json", ".flac")
            if audio_name not in tf.getnames():
                audio_name = meta_name.replace(".json", ".wav")
            audio, sr = _read_audio(
                tf.extractfile(audio_name).read(), audio_name)
            meta = json.loads(tf.extractfile(meta_name).read())
        vad = meta["voice_activity"]
        book_id = meta.get("book_meta", {}).get("id", "book")
        speaker = pathlib.Path(audio_name).parent.parent.name or "spk"
        stem = pathlib.Path(meta_name).stem
        path_out = f"{speaker}/{book_id}/{stem}"
        out_tar = dataset_path.replace(".tar", f"_{worker_id}.tar")
        n = cut_sequence(audio, sr, vad, path_out, out_tar,
                         rng=random.Random(hash(meta_name) & 0xFFFF))
        return meta_name, None, n
    except Exception as e:  # noqa: BLE001 — per-item fault isolation
        return meta_name, repr(e), 0


def cut_corpus(input_tar: str, n_workers: int = 8,
               state_dir: str = ".") -> Tuple[int, int]:
    """Segment every (json, audio) pair in ``input_tar``.

    Resumable: items listed in ``<state_dir>/ignore_list.txt`` or
    ``error_list.txt`` are skipped; both lists are appended (serially, in
    the parent) as items complete.  Returns (n_ok, n_err).
    """
    ignore_path = os.path.join(state_dir, "ignore_list.txt")
    error_path = os.path.join(state_dir, "error_list.txt")
    done = set()
    for path in (ignore_path, error_path):
        if os.path.exists(path):
            with open(path) as f:
                done.update(line.strip() for line in f if line.strip())

    with tarfile.open(input_tar, "r") as tf:
        members = [m.name for m in tf.getmembers()
                   if m.name.endswith(".json") and m.name not in done]

    dataset_path = input_tar[:-4] + "_vad.tar"
    tasks = [(name, dataset_path, input_tar, i % n_workers)
             for i, name in enumerate(members)]

    n_ok = n_err = 0
    with open(ignore_path, "a") as ign, open(error_path, "a") as err, \
            multiprocessing.Pool(n_workers) as pool:
        for name, error, _n in pool.imap_unordered(_worker, tasks):
            if error is None:
                ign.write(name + "\n")
                ign.flush()
                n_ok += 1
            else:
                err.write(name + "\n")
                err.flush()
                n_err += 1
    return n_ok, n_err
