"""ASR pseudo-labeling of cut audio tars (optional tool):
``python -m prompt_tts_tpu_torch.cli.generate_transcript``.

The port's copy of ``prompt_tts_tpu/cli/generate_transcript.py`` (the
port's ``utils.wav`` and ``data/unigram.py``).  The ASR model runs on
``--device``, ``cuda`` by default like the port's other CLIs (the JAX tool
runs it on the CPU):

    python -m prompt_tts_tpu_torch.cli.generate_transcript \
        --input_file cut.tar --model_dir s2t-small-librispeech \
        [--device cpu]

Equivalent of reference data_preparation/asr/generate_transcript.py:44-70:
transcribes each wav in a tar with a local HF ASR checkpoint and appends
``<key>.txt`` members, resumable via ignore/error lists.  Requires a LOCAL
model directory (zero-egress environments cannot download).

Architectures: seq2seq Speech2Text (the reference's s2t-small-librispeech
path, generate_transcript.py:13-18) and, beyond the reference, CTC models
(wav2vec2-style) — auto-detected from the checkpoint config.
"""

import argparse
import io
import os
import tarfile


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ASR pseudo-labeling.")
    p.add_argument("--input_file", type=str, required=True,
                   help="Tar of 16 kHz wavs (vad_cut output).")
    p.add_argument("--model_dir", type=str, required=True,
                   help="Local Speech2Text checkpoint directory.")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--state_dir", type=str, default=".")
    p.add_argument("--device", type=str, default="cuda",
                   help="Where the ASR model runs (cpu, cuda, cuda:N).")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if not os.path.isdir(args.model_dir):
        raise SystemExit(
            f"--model_dir {args.model_dir} not found; this tool needs a "
            "local Speech2Text checkpoint (no network access assumed)")

    import torch
    from transformers import AutoConfig

    from prompt_tts_tpu_torch.utils.wav import read_wav

    cfg = AutoConfig.from_pretrained(args.model_dir)
    is_ctc = any(a.endswith("ForCTC") for a in (cfg.architectures or []))
    if is_ctc:
        from transformers import AutoModelForCTC, AutoProcessor
        model = AutoModelForCTC.from_pretrained(args.model_dir)
        processor = AutoProcessor.from_pretrained(args.model_dir)
    else:
        from transformers import Speech2TextForConditionalGeneration
        model = Speech2TextForConditionalGeneration.from_pretrained(
            args.model_dir)
        try:
            from transformers import Speech2TextProcessor
            processor = Speech2TextProcessor.from_pretrained(args.model_dir)
        except Exception:
            # the stock Speech2TextTokenizer needs the sentencepiece
            # wheel, but the ASR path only DECODES — fall back to the
            # in-repo decode-only unigram shim over the checkpoint's
            # vocab.json + the stock feature extractor (data/unigram.py)
            from transformers import Speech2TextFeatureExtractor
            from prompt_tts_tpu_torch.data.unigram import UnigramProcessor
            processor = UnigramProcessor(
                Speech2TextFeatureExtractor.from_pretrained(args.model_dir),
                args.model_dir)

    device = torch.device(args.device)
    model = model.to(device).eval()

    ignore_path = os.path.join(args.state_dir, "asr_ignore_list.txt")
    done = set()
    if os.path.exists(ignore_path):
        done = {l.strip() for l in open(ignore_path) if l.strip()}

    out_file = args.input_file.replace(".tar", "_asr.tar")
    n = 0
    with tarfile.open(args.input_file, "r") as tf, \
            tarfile.open(out_file, "a") as out_tf, \
            open(ignore_path, "a") as ign:
        wavs = [m for m in tf.getmembers()
                if m.name.endswith(".wav") and m.name not in done]
        for start in range(0, len(wavs), args.batch_size):
            chunk = wavs[start: start + args.batch_size]
            audios = []
            for m in chunk:
                a, sr = read_wav(io.BytesIO(tf.extractfile(m).read()))
                audios.append(a[:, 0])
            inputs = processor(audios, sampling_rate=16000,
                               return_tensors="pt", padding=True)
            inputs = {k: v.to(device) for k, v in inputs.items()}
            with torch.no_grad():
                if is_ctc:
                    ids = model(inputs["input_values"]).logits.argmax(-1)
                else:
                    ids = model.generate(
                        inputs["input_features"],
                        attention_mask=inputs.get("attention_mask"))
            ids = ids.cpu()
            texts = processor.batch_decode(ids, skip_special_tokens=True)
            for m, text in zip(chunk, texts):
                data = text.encode()
                info = tarfile.TarInfo(m.name.replace(".wav", ".txt"))
                info.size = len(data)
                out_tf.addfile(info, io.BytesIO(data))
                ign.write(m.name + "\n")
                n += 1
    print(f"wrote {out_file} ({n} transcripts)")


if __name__ == "__main__":
    main()
