"""Drive the PyTorch port (espnet_tpu_torch) on one NVIDIA card and check it.

Run from the repository root, with one card:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card's name and the nvidia-smi name and power limit line;
2. build: compiles the port's CUDA kernels from espnet_tpu_torch/csrc;
3. longform_data: the long-form data dirs, train_long and valid_long,
   each recording joining consecutive utterances of the train and valid
   dirs of phase 5 until it holds at least 1,100,000 samples (past 2048
   encoder frames after conv2d x4), and decode_long (valid_long and two
   train_long recordings): counts, samples, encoder frames, tokens;
4. kernel_checks: each kernel against its plain PyTorch version at the
   shapes of its path, with the stated tolerance: the attention forward
   at the decode shape (launched twice: the same bits, row statistics
   too), its backward at the train shape (with the real
   rel-pos + padding bias of the first conformer block, which needs a
   gradient; launched twice: the same bits) and on a small causal case
   with Tq != Tk, the log-mel on
   the decode batch (launched twice: the same bits) and on the first
   long-form train batch, the
   RNN-T lattice sweeps with their closed-form gradient on the
   transducer's real joint logits of its first train batch and on small
   cases (U+1 = 1, a ragged case, U+1 = 300: the path of a block of
   warps), equal to the plain sweeps to the bit and launched twice for
   the same bits, with their chain floor (tools/rnnt_chain.py: the
   longest sample's diagonals times one diagonal's dependent step, read
   on the card), and the banded attention forward and backward on the
   first Longformer block's q, k, v (the forward on the encoder's strided
   views) and valid frames of the long-form decode batch and of the first
   long-form train batch (each launched twice: the same bits, the
   forward's row statistics too, and the forward once more on copies of
   its views: the same bits), and on small ragged cases (T not a
   multiple of 64, W >= T, W = 0, a padded tail longer than W); each
   kernel is timed beside the plain version and, where one exists, one
   PyTorch library call (a yardstick only), the attention forwards also
   at their train shapes and the log-mel also on the long-form train
   batch, and torch.profiler names the device kernels, with their device
   times, behind the attention forwards, the log-mel, the RNN-T sweeps
   and their library calls at the decode shapes (the sweeps at the train
   batch's), and behind both attention backwards and SDPA's autograd
   backward at their train shapes (the wrappers' host time, ~25-35 us a
   call, is in the CUDA-event times); and the attention forward and
   backward at the Conformer separator's shapes, head size 32 (the first
   block's q, k, v and rel-pos bias of phase 36's decode batch, (10, 4,
   501, 32), and of an 8-mixture train batch, (8, 4, 501, 32); each
   against its plain version, launched twice for the same bits, timed
   and profiled beside SDPA);
5. main_path: the flagship hybrid CTC/attention Conformer
   (assets/synth_asr_flagship) built by Speech2Text on the card decodes the
   first 64 held-out SynthSpeechCorpus utterances in fp32 (beam 10, CTC
   weight 0.3): one warm-up decode, then the counted one and two more,
   all three timed; WER, CER, audio seconds per second and kernel launches;
6. train_path: 300 train and 50 valid SynthSpeechCorpus utterances
   written as Kaldi data dirs under a temporary directory, then the
   training entry point (espnet_tpu_torch.bin.asr_train.main) on the
   flagship config, initialised from the flagship's weights: batch 25,
   10 steps, validation, checkpoint. Per step: the losses, accuracy,
   gradient norm, skip flag and kernel launches; the median step time,
   the peak device memory, the validation loss and accuracy before and
   after, and a reload of the checkpoint that must give the same
   validation loss;
7. grad_check: one fixed batch through the flagship in eval mode, on the
   card (kernels) and on the CPU (plain versions): the loss and every
   parameter's gradient must agree; beside the check, a float64 backward
   on the CPU gives each fp32 leg's distance from float64 per parameter
   (the worst ten of each, and its seconds);
8. transducer_decode: the Conformer transducer
   (assets/synth_asr_transducer) built by Speech2TextTransducer on the
   card decodes the same 64 utterances (beam 5), as main_path does;
9. transducer_train: its entry point
   (espnet_tpu_torch.bin.asr_transducer_train.main) on the transducer
   config over the same data dirs, as train_path does;
10. transducer_grad_check: grad_check for the transducer;
11. longform_train: the training entry point on the long-form config
    (the flagship's, with a 6-block Longformer encoder at the flagship's
    widths and a +-64-frame band, natural padding), initialised as flax
    would from the seed: batch 4, sorted batches, 3 epochs (6 steps),
    validation, checkpoint, with train_path's records per step and at
    the end;
12. longform_grad_check: grad_check for the long-form model, on the
    first 2 train_long recordings;
13. longform_decode: the batch-decode CLI's inference() with the trained
    checkpoint over decode_long, batch 4, greedy CTC, after one warm-up
    run: launches per encode, the written 1best_recog/text, audio seconds
    per second, and the card's CTC log-probabilities and greedy tokens
    against the CPU's;
14. determinism: for each of the three models, two 3-step runs of its
    entry point from one seed (dropout and SpecAug on) must end with
    bit-identical parameters, and a run stopped after step 2 and resumed
    from its checkpoint must equal them at step 3; no CTC gradient may
    come from torch's CTC loss;
15. streaming_decode: the 100 held-out ("valid", 0..99) utterances
    written as 16-bit WAV data dirs and read back, pushed in 640 ms
    pieces in sorted key order through Speech2TextStreaming (greedy) on
    the CTC-only streaming asset (assets/synth_asr_streaming): WER and
    CER (limit: the JAX package's fp32 figure plus 0.5 points, at most
    3%), p50 / p95 latency per push after the first 4, launches; and one
    utterance streamed on the card and on the CPU: the encoder chunks
    within 1e-4 of their largest entry, the ids equal;
16. streaming_pool: StreamingSessionPool(max_sessions=8) over the first
    8 of those utterances, one more session opened each round; each
    round gives a piece to every open session and drains once, so that
    rows at different offsets share a batched step: each session's ids
    must equal its single session's, and some step must hold more than
    one row;
17. transducer_streaming_decode: the same 100 utterances through the
    recipe's loop built from the port's modules (GlobalMVN per window,
    stream_step, greedy_stream_step on the valid frames, umax 128; limit
    as phase 15) and through Speech2TextTransducerStreaming as the JAX
    package's class is (no MVN, the padded tail decoded; limit: the JAX
    class's figure plus 0.5 points);
18. transducer_batch_decode: the transducer CLI's inference() over the
    64 held-out test utterances at natural lengths, batch 16, beam 5,
    after a warm-up run: WER (limit: the JAX inference()'s plus 0.5
    points) and the launches of each batch (logmel 1, nothing else);
19. enh_separate: the enhancement recipe's stage 3 on the TCN separator
    (assets/synth_enh_tcn): the 50 SynthMixCorpus test mixtures (4 s)
    through SeparateSpeech(fs=16000) in batches of 10, each estimate
    scaled to a 0.95 peak past one and written as a 16-bit WAV, scored
    against the references and the mixture baseline: SI-SNR, SI-SNRi
    (limit: the JAX package's fp32 figure on the same input, from
    scripts/jax_enh_reference.py, less 0.05 dB), SDR; the first batch on
    the card and on the CPU (within 1e-4 of the largest sample); separated
    audio seconds per second (one batch, synchronised, median of three
    after a warm-up);
20. enh_cli: bin/enh_inference.py:inference() over the first 8 of those
    mixtures, read back from their WAVs; SeparateSpeech on the same
    mixtures one at a time must write the same WAVs and scores;
21. enh_train: the training entry point on the asset's config
    (steps_per_dispatch 8, run one step at a time) from its weights over
    40 train and 16 valid mixtures: batch 8, 10 steps (the warm-up's
    learning rate below 4e-5), per-step records, median step ms, peak
    memory, validation SI-SNR before and after (at most 0.1 dB lower),
    two runs from one seed and a resumed one bit-identical, and
    grad_check (the TCN's PReLU inputs and its mask ReLU pinned);
22. enh_streaming: SeparateSpeechStreaming(segment_size=1.0) over the
    50 mixtures in 640 ms pushes: the streamed SI-SNRi (limit: the JAX
    class's on the CPU, +-0.05 dB), p50 / p95 latency per push after the
    first 4, and one mixture on the card and on the CPU;
23. enh_s2t: the joint enhancement + ASR model built from the TCN asset
    and the flagship: main_path's 64 clean utterances decoded (beam 10,
    CTC 0.3; K1 and K2 launched; WER on the first 16 at most the JAX
    package's on the same rows plus 0.5 points, and its ids against the
    JAX package's), 6 train steps at batch 25 on the train dir with the
    clean utterance as the mixture and as speech_ref1 (launches 6 / 12 / 0
    per step: the frontend is differentiated, which K2 cannot be), and
    grad_check.
24. lm_perplexity: the LM recipe's 300 valid sentences
    (egs/synth_asr/lm1/run.py's stage-1 draw) through
    bin/lm_calc_perplexity.py on assets/synth_lm at batch 64 (limit: the
    JAX package's fp32 perplexity, scripts/jax_tts_lm_reference.py, within
    1e-4 relative), and the first batch's nll on the card against the
    CPU (1e-5 of its largest entry);
25. lm_fused_decode: the recipe's stage 4: the flagship Speech2Text on
    the first 64 test utterances padded to their bucket (base 4096,
    x1.3), beam 10, CTC 0.3, without the LM and with it fused at 0.3: WER
    (limit: the JAX package's + 0.5 points), ids equal to JAX's, audio
    seconds per second, launches (K1 and K2 in both), and, in a third
    decode, the LM step's time against the beam step's (CUDA events);
26. tts_vits: the VITS recipe's 50 valid texts (speaker 0, drawn without
    their waves, checked against the JAX recipe's keys and texts) through
    assets/synth_tts_vits at max_frames 640, text padded to 64, noise
    scales 0.333 and 0.667, z_p's noise numpy's RandomState(1000 + i);
    each wave padded to its bucket and transcribed alone by the flagship
    (beam 10, CTC 0.3): WER and CER (limit at 0.333: the JAX package's +
    0.5 points), durations, frames and ids equal to JAX's, synthesized
    audio seconds per second, peak memory, the ASR leg's launches (K1 6,
    K2 1 a decode); the card's waves against the CPU's on the first 8
    texts whose durations agree (1e-4 of the largest sample), the same
    bits twice, the flow's forward after its inverse (1e-5 of |z_p|);
    Text2Speech with its own torch.Generator at 0.333 over the 50 texts
    (WER beside RESULTS.json's, not gated); and the CLI
    (bin/tts_inference.py:main) on 4 texts, its WAVs equal to the API's.
27. vits_parity, vits_train, vits_train_checks: the VITS recipe's
    speaker-0 data (160 train, 60 valid utterances) and
    assets/synth_tts_vits, both parts, with dropout off and numpy draws
    (vits_draws): the first train batch's loss terms and the two turns of
    two GAN steps within 1e-4 relative of the JAX package's
    (scripts/jax_vits_train_reference.json), the MAS durations equal or
    each difference listed with its closest call (below 1e-3), the 60
    valid utterances' terms; then bin/gan_tts_train.py with the config as
    it is: 10 steps (per step every loss term, both gradient norms and
    skip flags, K2 launches, step ms, the alignment searches' ms by CUDA
    events), the valid loss before and after, a checkpoint reload to the
    same valid loss, peak memory; the round trip of phase 26 at noise
    scale 0.333 with the trained generator (its WER beside the asset's
    34.98%, no limit); two 3-step runs and a resumed one bit-identical;
    the grad check of both turns (leaky ReLU kinks, the +-7 clips and the
    alignment path pinned);
28. gan_vocoder_train: bin/gan_vocoder_train.py on the vocoder recipe's
    config (egs/synth_asr/tts1/run_tts_loop.py stage 4) from the seed
    over the same waves: 10 steps at batch 16 (finite, unskipped, K2 4 a
    step), the valid loss reloaded, determinism and the grad check as
    phase 27's.
29. diar_decode: assets/synth_diar through DiarizeSpeech on 50 test
    dialogs of 8 s (the recipe's build_dialog from RandomState(16), the
    recipe's hash(split) seed being lost), the recipe's eval (batch 8,
    sigmoid > 0.5, frame DER over min(label, output) frames): DER (limit:
    the JAX package's on the same dialogs, scripts/jax_a5_reference.json,
    + 0.5 points), the frames whose decision differs from the JAX
    package's CPU one, launches (K2 1 a batch; K2 at the decode batch's
    shape, (8, 128000), n_fft 512, hop 128, 40 mels, is checked in phase
    4 on its first 8 dialogs);
30. diar_train: bin/diar_train.py on the asset's config (batch 16, Adam
    1e-3, warm-up 500, clip 5) from its weights over 160 seeded train
    and 16 valid dialogs: 10 steps (K2 1 a step and valid batch), as
    train_path's records, grad_check, and determinism's three runs;
31. codec, codec_train: CodecCoder on the codec recipe's 50 test
    utterances (batch 8): SI-SNR and mel-L1 as egs/synth_asr/codec1/
    run.py scores them (limits: the JAX package's within 0.05 dB and 1e-3
    relative), the codes against the JAX package's (at least 99.9%
    equal, each difference at a near-tie of the CPU's distances, within
    1e-4 relative, or downstream of one); the mel loss through K2 on the
    first batch against the plain version's (K2 at its shape, (8, 74560),
    n_fft 256, hop 64, 40 mels, is checked in phase 4 on 8 held-out
    utterances); then bin/gan_codec_train.py on the
    asset's config (batch 8, Adam 3e-4, clip 5) over train_path's data:
    10 steps (K2 2 a step and valid batch), grad_check (the RVQ codes
    pinned as the ReLUs are) and determinism;
32. speechlm, speechlm_train: the SpeechLM recipe's 100 valid utterances
    tokenized by the port's codec (batch 32; against the JAX package's
    tokens as the codes are), perplexity and accuracy as
    egs/synth_asr/speechlm1/run.py computes them (batch 16, length 239)
    on the JAX package's tokens (limits: 1e-3 relative, 0.002) and on the
    port's, greedy generate_scan (temperature 0, 120 steps) from the JAX
    package's 4 prompts of 1 s (tokens equal), the port's own prompts,
    and the recipe's sampled continuations (top-k 30) decoded by the
    codec: how many are non-silent (no limit); then
    bin/speechlm_train.py on the asset's config (batch 16, Adam 3e-4)
    over 160 tokenized train utterances: 10 steps (no kernel), grad_check
    and determinism.
33. spk_verify: assets/synth_spk_ecapa through SpeakerEmbedding on the
    speaker recipe's held-out set (egs/synth_asr/spk1/run.py: the 200
    test utterances, its 600 trials from write_trials at seed 17), as
    its stage 3 embeds them (each cut and zero-padded to 74656 samples
    with its true length, batches of 25, zero rows filling the last):
    every trial's cosine within 1e-4 of the JAX package's fp32 CPU score
    (scripts/jax_spk_reference.json), the EER and minDCF equal to its
    figures (one trial at most deciding otherwise, at a score within
    1e-4 of the operating point), RESULTS.json's beside them, audio
    seconds per second, peak memory, no kernel launched (ECAPA's hop of
    160 does not divide its n_fft of 512); the CLIs spk_embed_extract
    and spk_inference.main on the first 8 test utterances, their .npy
    files equal to SpeakerEmbedding's and within 1e-4 of the JAX
    package's;
34. spk_train: bin/spk_train.py on the asset's config from its weights
    over 160 train and 100 valid utterances (the recipe's 1200 cut), its
    40-trial valid list on: 2 epochs of 5 steps, the margin 0.0 then
    0.06, the trial EER in each valid epoch and before, train_path's
    records, grad_check and determinism;
35. cls, cls_train: the cls1 recipe's model (egs/synth_asr/cls1/run.py,
    4-block Transformer, d=144) with seed_flat's weights on its 200 test
    keywords in one batch (as its stage 3): the logits on the card within
    1e-4 of the CPU's and of the JAX package's, the same predictions, K2
    once (K2 at that batch's shape, (200, 15216), n_fft 512, hop 128, 80
    mels, is checked in phase 4); cls_train for 10 steps over its 160
    train keywords (K2 1 a step and valid batch), run twice
    bit-identical, grad_check, determinism; the LID and ASVspoof entry
    points (bin/lid_train.py, bin/asvspoof_train.py: 3 steps; their
    inference CLIs on 8 test utterances).
36. enh_separators (run after phase 23): the single-channel STFT
    separators, each at its JAX class's default width in the TCN asset's
    config (DPRNN, TF-GridNet, BSRNN, DPTNet, SkiM with mem_type hc and
    id, DC-CRN, Transformer, Conformer, DPCL, DAN, DCCRN, DPCL-E2E) with
    seed_flat's weights: SeparateSpeech(fs=16000) on the card over the
    50 test mixtures in batches of 10 after a warm-up batch (separated
    audio seconds per second, peak memory, launches: K1 2 a batch for
    the Conformer, none for the others); the first 2 mixtures on the CPU
    (within 1e-4 of each estimate's largest sample); 32 samples of every
    estimate against the JAX package's
    (scripts/jax_enh_separators_reference.json, within 1e-4 of its
    largest sample); for DPCL and DAN, whose 10 Lloyd steps a near-tie
    can send another way, the k-means trace of the bins' embedding
    (every step's labels; the first 10 mixtures also on the CPU): the
    final labels at least 99.9% equal to the CPU's, each mixture's first
    step that differs differing only at near-ties of the CPU's distances
    (within 1e-4 relative; the later steps are downstream of them), the
    CPU's estimates from the card's labels (DPCL) or attractors (DAN)
    within 1e-4 of the card's; against JAX the embedding within 1e-4,
    the first 2 mixtures' labels at least 99.9% equal, and the slices
    held on the mixtures whose labels under the slice (DPCL) or whose
    label counts and first mixtures (DAN) are JAX's, at least 10 of them
    (the others' errors listed);
    K1 at the decode batch's (10, 4, 501, 32) and K1b at the train
    batch's (8, 4, 501, 32) are checked in phase 4;
37-38. enh_separator_train: bin/enh_train.py on phase 21's config with
    the Conformer (10 steps; K1 2 and K1b 4 launches a step), TF-GridNet
    (3 steps) and DPCL with loss_type dpcl (10 steps) from seed_flat's
    weights at batch 8: per-step records, a second run bit-identical,
    and grad_check for the Conformer and DPCL (TF-GridNet's is left out,
    see SEP_TRAIN).

Then the nvidia-smi line, one {"kernels": [...]} line (errors, times and
bounds of phase 4, launches from the paths that run each kernel; a bound
is the larger of the bytes at 3.35 TB/s and the operations at 67 TFLOP/s,
the fp32 rate of the CUDA cores, or for the attention kernels at 165
TFLOP/s, the tensor cores' fp32-accurate 3xTF32 rate, with the bound at
67 TFLOP/s beside it) and last
{"ok": true, "device": {...}}. Each phase's line carries elapsed_s, the
seconds since the script started. Without a card, or when any phase
fails, it exits non-zero and prints no result.
"""

from __future__ import annotations

import hashlib
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ASSET = ROOT / "assets" / "synth_asr_flagship"
TRANSDUCER = ROOT / "assets" / "synth_asr_transducer"
N_UTTS = 64
BEAM = 10
CTC_WEIGHT = 0.3
REPEATS = 2              # timed decodes after the counted one
MAX_WER = 0.03          # the JAX package's fp32 decode of this subset: 2.39%
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12      # H100 SXM fp32 outside the tensor cores
# fp32-accurate products on the tensor cores: 3xTF32 forms each fp32
# product from three TF32 products, at 495 TFLOP/s dense TF32
FP32_TC_FLOPS = 495e12 / 3
# fp32 with the sums taken in another order than the plain version: the
# attention output is a convex mix of v (|v| ~ 1), so 1e-4 is ~100x the
# expected rounding; the log-mel is compared in the log domain where the
# mel energy exceeds 1e-8 (below that, cancellation in the 512-term DFT
# sums leaves too few significant bits in the power for a log to compare)
K1_TOL = 1e-4
K2_TOL = 1e-3
K2_MIN_MEL = 1e-8
# the attention backward: sums over at most T = 145 terms in fp32, each
# gradient measured against its own largest entry (~1e-6 expected)
K1B_TOL = 2e-5
N_TRAIN, N_VALID = 300, 50
TRAIN_BATCH = 25
TRAIN_STEPS = 10
# warmup 600 keeps the LR under 4e-5 for 10 steps: the model barely
# moves, so validation accuracy may not fall by more than 1 point
ACC_MARGIN = 0.01
# a reload of the checkpoint runs the same kernels on the same batches
RELOAD_TOL = 1e-5
# card (kernels, cuBLAS) against CPU (plain versions) through 6 blocks
# and 3 decoder layers in fp32: each parameter's gradient within 1e-3 of
# its own largest entry; the key biases, whose gradient is zero in exact
# arithmetic (a shift of a row of scores does not change its softmax),
# against 1e-4 of the largest gradient of the model instead
GRAD_TOL = 1e-3
GRAD_BATCH = 8
# the RNN-T sweeps: the kernel and the plain version take the same fp32
# steps in the same order (a log-add per edge along one diagonal chain),
# so they should agree to ~1e-6 relative; nll, alpha and beta (inside
# each sample's lattice) against their largest entry, and the
# closed-form dlogits against its largest entry
K3_TOL = 1e-5
TRANSDUCER_BEAM = 5
# the JAX package's own fp32 decode of these 64 utterances (same
# padding, beam 5, its Speech2TextTransducer on a CPU): WER 4/335 =
# 1.194%; the port may be at most 0.5 points above it, and at most 3%
JAX_TRANSDUCER_WER = 4 / 335
MAX_TRANSDUCER_WER = min(JAX_TRANSDUCER_WER + 0.005, 0.03)
DETERMINISM_STEPS = 3
# the long-form slice: recordings of at least 68.75 s, so every one is
# past the JAX package's splash threshold (T' >= 2048 after conv2d x4);
# the Longformer encoder at the flagship's widths
LONG_MIN_SAMPLES = 1_100_000
LONG_ENCODER = {"output_size": 256, "attention_heads": 4,
                "linear_units": 1024, "num_blocks": 6,
                "attention_window": 64}
# 300 train and 50 valid utterances make 8 and 1 recordings: 2 batches
# of 4 an epoch, so 3 epochs for 6 steps
LONG_BATCH = 4
LONG_EPOCHS = 3
LONG_MIN_STEPS = 6
LONG_DECODE_TRAIN = 2    # train_long recordings in the decode set
LONG_MIN_FRAMES = 2048
# the banded attention: as K1 and K1b (sums over at most 2W + 1 = 129
# keys); the kernels and the plain versions give a row with no allowed
# key 0, so the forward is compared on every row. A gradient that is zero
# in exact arithmetic (dq and dk at W = 0, where each row attends itself
# alone, its largest plain entry below 1e-3 of the case's largest) keeps
# only fp32 rounding of do.v - D, and is measured against the case's
# largest gradient entry instead of its own
K4_TOL = 1e-4
K4B_TOL = 2e-5
# the long-form model's CTC log-probabilities, card (kernels, cuBLAS)
# against CPU (plain versions), through 6 blocks in fp32
LOGPROB_TOL = 1e-4
# streaming: the 100 held-out ("valid", 0..99) utterances written as
# 16-bit WAV and read back, pushed in 640 ms pieces in sorted key order,
# as egs/synth_asr/asr1/run_streaming.py pushes them; the first 4 pieces'
# latencies are dropped, as the recipe drops them
STREAMING = ROOT / "assets" / "synth_asr_streaming"
N_STREAM = 100
STREAM_CHUNK = 10240
LATENCY_SKIP = 4
# the JAX package's own fp32 figures on the same input, on a CPU
# (scripts/jax_streaming_reference.py): Speech2TextStreaming, greedy,
# 11/547 (the asset's RESULTS.json: 2.01%); the transducer recipe's loop
# (run_transducer_streaming.py:149-188, umax 128) 13/547 (RESULTS.json:
# 2.38%); Speech2TextTransducerStreaming as it is (no MVN, the padded
# tail decoded) 564/547; the transducer CLI, batch 16, beam 5, 4/335.
# The port may be at most 0.5 points above each, and at most 3% where
# the reference reaches it
JAX_STREAM_WER = 11 / 547
MAX_STREAM_WER = min(JAX_STREAM_WER + 0.005, 0.03)
JAX_TSTREAM_RECIPE_WER = 13 / 547
MAX_TSTREAM_RECIPE_WER = min(JAX_TSTREAM_RECIPE_WER + 0.005, 0.03)
JAX_TSTREAM_CLASS_WER = 564 / 547
MAX_TSTREAM_CLASS_WER = JAX_TSTREAM_CLASS_WER + 0.005
TSTREAM_UMAX = 128
POOL_SESSIONS = 8
CLI_BATCH = 16
JAX_CLI_WER = 4 / 335
MAX_CLI_WER = JAX_CLI_WER + 0.005
# the streaming encoder's chunks, card against CPU, through 6 blocks in
# fp32: within 1e-4 of the largest entry, as the long-form model's
# log-probabilities are held
STREAM_ENC_TOL = 1e-4
# enhancement (phases 19-22): the TCN asset, the recipe's 50 test mixtures
# of 4 s in batches of 10, estimates scaled to a 0.95 peak past one; the
# JAX package's fp32 figures on the same input from
# scripts/jax_enh_reference.py (run on the CPU, its output committed)
ENH = ROOT / "assets" / "synth_enh_tcn"
ENH_REFERENCE = ROOT / "scripts" / "jax_enh_reference.json"
N_MIX = 50
SEP_BATCH = 10
SEP_PEAK = 0.95
SI_SNRI_MARGIN = 0.05   # dB below (or, streamed, either side of) JAX's
SEP_TOL = 1e-4          # card against CPU, of the largest sample
N_CLI_MIX = 8
ENH_N_TRAIN, ENH_N_VALID = 40, 16
ENH_TRAIN_BATCH = 8
ENH_TRAIN_STEPS = 10
ENH_MAX_LR = 4e-5       # the asset's warm-up gives 3.3e-5 at step 10
ENH_VALID_DROP = 0.1    # dB of validation SI-SNR
# the joint model (phase 23): WER on the reference's first 16 utterances
# at most the JAX package's + 0.5 points; 6 train steps at batch 25
S2T_WER_MARGIN = 0.005
S2T_TRAIN_STEPS = 6
# the LM and VITS serving phases (24-26): assets/synth_lm's perplexity on
# the LM recipe's 300 valid sentences, the flagship with the LM fused,
# and the VITS -> ASR round trip; the JAX package's fp32 figures on the
# same input from scripts/jax_tts_lm_reference.py (run on the CPU, its
# output committed)
LM = ROOT / "assets" / "synth_lm"
TTS = ROOT / "assets" / "synth_tts_vits"
TTS_LM_REFERENCE = ROOT / "scripts" / "jax_tts_lm_reference.json"
N_VALID_LM = 300
PPL_BATCH = 64
PPL_REL_TOL = 1e-4      # of the JAX package's fp32 perplexity
LM_NLL_TOL = 1e-5       # card against CPU, of the batch's largest nll
LM_WEIGHT = 0.3
LM_WER_MARGIN = 0.005   # WER at most the JAX package's + 0.5 points
N_VALID_TTS = 60        # the VITS recipe's valid set; the first 50 keys
N_EVAL_TTS = 50
MAX_FRAMES = 640
TEXT_PAD = 64
NOISE_SCALES = (0.333, 0.667)
NOISE_SEED = 1000       # z_p's draw for text i: RandomState(1000 + i)
TTS_WER_MARGIN = 0.005  # at noise scale 0.333, against the JAX package's
TTS_CPU_UTTS = 8        # card against CPU waves on the first 8 texts
TTS_WAVE_TOL = 1e-4     # of the largest sample, at equal durations
FLOW_TOL = 1e-5         # the flow's forward after its inverse, of |z_p|
N_CLI_TTS = 4
# VITS training (phase 27) and the GAN vocoder (phase 28)
VITS_N_TRAIN = 160      # the recipe's speaker-0 corpus, cut to 10 batches
VITS_N_VALID = 60
VITS_STEPS = 10
VITS_DRAW_SEED = 2000   # the i-th batch's draws: RandomState(2000 + i)
VALID_DRAW_OFFSET = 100
VITS_REF = ROOT / "scripts" / "jax_vits_train_reference.json"
VITS_LOSS_TOL = 1e-4    # each loss term against the JAX package's, relative
MAS_MARGIN_TOL = 1e-3   # a duration may differ only at a closer call
VITS_GRAD_BATCH = 4
K2_MEL_LOSS_TOL = 1e-4  # the mel loss through K2 against its plain version
MEL_BATCH, MEL_SEG = 16, 8192   # the GAN mel loss's and featurize's batch
VOC_STEPS = 10
VOCODER = {"fs": 16000, "n_fft": 512, "hop_length": 128, "n_mels": 80,
           "generator_conf": {"channels": 128, "upsample_scales": [8, 4, 4],
                              "upsample_kernel_sizes": [16, 8, 8],
                              "kernel_size": 7,
                              "resblock_kernel_sizes": [3, 7],
                              "resblock_dilations": [[1, 3], [1, 3]]},
           "discriminator_conf": {"periods": [2, 3, 5], "scales": 2},
           "segment_size": 8192, "batch_size": 16, "steps_per_dispatch": 8,
           "keep_nbest_models": 2}

# phases 29-32: diarization, the codec and the SpeechLM (ROADMAP A.5)
DIAR = ROOT / "assets" / "synth_diar"
CODEC = ROOT / "assets" / "synth_codec"
SPEECHLM = ROOT / "assets" / "synth_speechlm"
A5_REFERENCE = ROOT / "scripts" / "jax_a5_reference.json"
N_DIALOGS = 50
# the recipe seeds each split with hash(split), which Python salts per
# process: the dialogs behind RESULTS.json's DER cannot be made again, so
# both packages build them from these seeds (build_dialog, in order)
DIAR_TEST_SEED = 16
DIAR_TRAIN_SEED = 17
DIAR_VALID_SEED = 18
DIAR_N_TRAIN = 160
DIAR_N_VALID = 16
DIAR_BATCH = 8          # the recipe's eval batch
DER_MARGIN = 0.005      # DER at most the JAX package's + 0.5 points
N_CODEC_UTTS = 50       # the codec recipe's test set
CODEC_BATCH = 8
SI_SNR_MARGIN = 0.05    # dB either side of the JAX package's
MEL_L1_REL = 1e-3
CODES_EQUAL_MIN = 0.999
NEAR_TIE_REL = 1e-4     # a code may differ where the two best distances
#                         are this close, relative to the best
N_SLM_VALID = 100       # the SpeechLM recipe's valid set
SLM_TOKEN_BATCH = 32    # the recipe's tokenization batch
SLM_BATCH = 16
SLM_LEN = 2 + (74656 // 320 + 3) + 1    # bos, tag, delayed codes, eos
PPL_REL = 1e-3
SLM_ACC_TOL = 0.002
N_PROMPTS = 4
PROMPT_SAMPLES = 16000  # 1 s prompts
GEN_STEPS = 120
SAMPLE_TOPK = 30
A5_STEPS = 10
SLM_N_TRAIN = 160       # train_path's first 160 train utterances

# phases 33-35: speaker verification, classification, LID and ASVspoof
SPK = ROOT / "assets" / "synth_spk_ecapa"
SPK_REFERENCE = ROOT / "scripts" / "jax_spk_reference.json"
SPK_N_TRAIN = 160       # the recipe's 1200 train utterances, cut
SPK_N_VALID = 100       # the recipe's valid and test sets
SPK_N_TEST = 200
SPK_TRIALS = 600        # write_trials(..., "test", 600), seed 17
SPK_VALID_TRIALS = 40
SPK_LEN = 74656         # stage 3: each utterance cut and padded to this
SPK_BATCH = 25          # in batches of 25, zero rows filling the last
SPK_EPOCHS = 2          # of 5 steps: the margin 0.0, then 0.06
SPK_STEPS_PER_EPOCH = 5
SCORE_TOL = 1e-4        # each trial's cosine against the JAX package's
N_SPK_CLI = 8
CLS_N_KEYWORDS = 30     # egs/synth_asr/cls1/run.py: one word of 30
CLS_N_TRAIN = 160       # the recipe's 1500, cut
CLS_N_VALID = 100
CLS_N_TEST = 200        # stage 3 scores all 200 in one batch
CLS_SEED = 0            # the classifier's weights: seed_flat(..., 0)
CLS_LOGIT_TOL = 1e-4    # of the largest |logit|
CLS_STEPS = 10
SHORT_STEPS = 3         # the LID and ASVspoof entry points
# the single-channel STFT separators (phases 36-38): each at the JAX
# class's default width (egs/synth_asr/enh1/run.py --separator NAME with
# no --separator_conf; SkiM also with mem_type id) in the TCN asset's
# config, weights seed_flat(..., SEP_SEED); the JAX package's figures on
# the same mixtures from scripts/jax_enh_separators_reference.py
SEP_REFERENCE = ROOT / "scripts" / "jax_enh_separators_reference.json"
SEPARATOR_CASES = (
    ("dprnn", "dprnn", {}), ("tfgridnet", "tfgridnet", {}),
    ("bsrnn", "bsrnn", {}), ("dptnet", "dptnet", {}), ("skim", "skim", {}),
    ("skim_id", "skim", {"mem_type": "id"}), ("dc_crn", "dc_crn", {}),
    ("transformer", "transformer", {}), ("conformer", "conformer", {}),
    ("dpcl", "dpcl", {}), ("dan", "dan", {}), ("dccrn", "dccrn", {}),
    ("dpcl_e2e", "dpcl_e2e", {}))
CLUSTERING = ("dpcl", "dan")      # k-means labels at inference
SEP_SEED = 0
SLICE_AT, SLICE_LEN = 24000, 32   # each estimate's samples held against JAX
EMBED_FRAMES = (100, 102)         # DPCL / DAN embedding of mixture 0, JSON
SLICE_FRAMES = (184, 191)         # STFT frames (hop 128) over the slice
N_LABEL_MIX = 2                   # mixtures whose labels the JSON holds
SEP_CPU_MIX = 2                   # mixtures separated on the CPU too
SEP_CPU_CLUSTER_MIX = 10          # DPCL / DAN: their k-means traces
LABELS_EQUAL_MIN = 0.999
# card training from seed_flat's weights over phase 21's data, each
# separator at its default width: steps, loss type and the grad check's
# batch. TF-GridNet has none: at this batch a Q-branch PReLU slope's
# gradient lands 1.5e-2 from float64 on the card and 3.0e-3 on the CPU,
# past GRAD_TOL on both (scripts/tfgridnet_grad_conditioning.py); its
# card-against-CPU gradients are held on 1 s in tests/test_torch_gpu.py
SEP_TRAIN = {"conformer": (10, "si_snr", GRAD_BATCH),
             "tfgridnet": (3, "si_snr", None),
             "dpcl": (10, "dpcl", GRAD_BATCH)}


def vits_config_dict(workdir: Path) -> dict:
    """The VITS asset's config (the recipe's), over the speaker-0 data dirs
    under workdir/data, its token list and both parts of its weights as
    init_param, writing to workdir/vits."""
    from espnet_tpu_torch.utils.config import load_yaml
    data = workdir / "data"
    return {**load_yaml(TTS / "config.yaml"),
            "output_dir": str(workdir / "vits"),
            "train_data_path_and_name_and_type": [
                f"{data}/train/text,text,text",
                f"{data}/train/wav.scp,speech,sound"],
            "valid_data_path_and_name_and_type": [
                f"{data}/valid/text,text,text",
                f"{data}/valid/wav.scp,speech,sound"],
            "token_list": str(TTS / "tokens.txt"), "init_param": str(TTS)}


def vits_draws(i: int, spec_lengths, n_frames: int, z: int = 192,
               seg: int = 64) -> dict:
    """The i-th batch's draws, numpy-made for both packages: the
    posterior's noise (B, n_frames, z) and the window starts (B,),
    randint(0, 2^30) % max(spec_length - seg, 1)."""
    import numpy as np
    rng = np.random.RandomState(VITS_DRAW_SEED + i)
    B = len(spec_lengths)
    noise = rng.randn(B, n_frames, z).astype(np.float32)
    starts = rng.randint(0, 2 ** 30, size=B) % np.maximum(
        np.asarray(spec_lengths) - seg, 1)
    return {"noise": noise, "starts": starts.astype(np.int32)}


START = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's carries the seconds since the start."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - START}
    print(json.dumps(obj), flush=True)


def seed_flat(shapes: dict, seed: int) -> dict:
    """Weights of a flax tree {key: shape} from numpy's RandomState(seed),
    key by key in sorted order, at init scale: kernels N(0, 1 / fan-in),
    LayerNorm scales 1 + N(0, 0.05^2), the rest N(0, 0.05^2)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    flat = {}
    for key in sorted(shapes):
        shape, name = tuple(shapes[key]), key.rsplit("/", 1)[-1]
        x = np.asarray(rng.randn(*shape))
        if name == "kernel":
            x = x / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.05 * x
        else:
            x = 0.05 * x
        flat[key] = x.astype(np.float32)
    return flat


def cls_config_dict(data: Path) -> dict:
    """egs/synth_asr/cls1/run.py's config over the data dirs under
    ``data`` (train, valid; ``label`` files of keyword ids)."""
    return {
        "n_classes": CLS_N_KEYWORDS,
        "frontend_conf": {"n_fft": 512, "hop_length": 128, "n_mels": 80},
        "encoder": "transformer",
        "encoder_conf": {"output_size": 144, "attention_heads": 4,
                         "linear_units": 576, "num_blocks": 4,
                         "input_layer": "conv2d"},
        "optim": "adam", "optim_conf": {"lr": 1e-3},
        "scheduler": "warmuplr", "scheduler_conf": {"warmup_steps": 300},
        "grad_clip": 5.0, "batch_type": "unsorted", "batch_size": 32,
        "keep_nbest_models": 2, "patience": None, "log_interval": 1,
        "steps_per_dispatch": 4,
        "train_data_path_and_name_and_type": [
            f"{data}/train/wav.scp,speech,sound",
            f"{data}/train/label,label,text_int"],
        "valid_data_path_and_name_and_type": [
            f"{data}/valid/wav.scp,speech,sound",
            f"{data}/valid/label,label,text_int"]}


def cls_data(corpus, write_wav, read_wav, bucket_length, data: Path,
             splits=(("train", CLS_N_TRAIN), ("valid", CLS_N_VALID),
                     ("test", CLS_N_TEST))):
    """The cls1 recipe's stage 1 (single-keyword 16-bit WAVs, keyword
    ids in ``label``) under ``data``, and its stage 3 batch: the test
    split read back, keys sorted, zero-padded to the bucket of the
    longest (base 4096, x1.3). The corpus and the file helpers are
    either package's. -> (keys, (B, L) speech, (B,) lengths, labels)."""
    import numpy as np
    word2id = {w: i for i, w in enumerate(corpus.words)}
    for split, n in splits:
        d = data / split
        (d / "wav").mkdir(parents=True, exist_ok=True)
        with open(d / "wav.scp", "w") as fw, open(d / "label", "w") as fl:
            for i in range(n):
                wave, text, _ = corpus.utterance(f"cls-{split}", i)
                uid = f"{split}_{i:05d}"
                write_wav(d / "wav" / f"{uid}.wav", 16000, wave)
                fw.write(f"{uid} {d / 'wav' / f'{uid}.wav'}\n")
                fl.write(f"{uid} {word2id[text]}\n")
    test = data / "test"
    wavs = dict(line.split() for line in open(test / "wav.scp"))
    labels = dict(line.split() for line in open(test / "label"))
    keys = sorted(wavs)
    audio = [read_wav(wavs[k])[1] for k in keys]
    L = bucket_length(max(len(a) for a in audio), base=4096, growth=1.3)
    speech = np.zeros((len(keys), L), np.float32)
    lens = np.zeros((len(keys),), np.int64)
    for j, a in enumerate(audio):
        speech[j, :len(a)] = a
        lens[j] = len(a)
    return keys, speech, lens, np.asarray([int(labels[k]) for k in keys])


def time_ms(torch, fn, iters: int = 20) -> float:
    """Mean device time of fn over iters launches, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def held_out_batch(corpus, n: int, min_len: int):
    import numpy as np
    utts = [corpus.utterance("test", i) for i in range(n)]
    S = max(min_len, max(len(w) for w, _, _ in utts))
    speech = np.zeros((n, S), np.float32)
    lengths = np.zeros((n,), np.int64)
    for j, (w, _, _) in enumerate(utts):
        speech[j, :len(w)] = w
        lengths[j] = len(w)
    return speech, lengths, [text for _, text, _ in utts]


def bound(kern, tensor_cores: bool = False):
    """The larger of bytes / HBM rate and operations / the rate of the
    units that can do them, in ms: the attention products at the tensor
    cores' fp32-accurate (3xTF32) rate, other work at the fp32 rate of the
    CUDA cores. The bound at the CUDA cores' rate stays beside it as
    bound_ms_fp32_cores."""
    t_bytes = kern["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = kern["flops"] / (FP32_TC_FLOPS if tensor_cores
                             else FP32_FLOPS) * 1e3
    kern["bound_ms"] = max(t_bytes, t_ops)
    kern["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    if tensor_cores:
        kern["bound_ms_fp32_cores"] = max(
            t_bytes, kern["flops"] / FP32_FLOPS * 1e3)


def device_times(torch, fns: dict) -> dict:
    """torch.profiler over 10 calls of each fn: every CUDA kernel it ran,
    with its mean device time per call in ms."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        out[name] = [
            {"kernel": e.key[:120],
             "ms": getattr(e, "device_time_total", 0.0) / 10 / 1e3}
            for e in prof.key_averages()
            if getattr(e, "device_time_total", 0.0) > 0]
    return out


def tf32_rna(torch, x):
    """fp32 x rounded to TF32 as cvt.rna.tf32.f32 does: 10 mantissa bits,
    halves away from zero."""
    return ((x.contiguous().view(torch.int32) + 0x1000)
            & -0x2000).view(torch.float32)


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def train_config(task, asset: Path, workdir: Path, name: str, **extra):
    """The asset's config with its data, token list, stats and initial
    weights pointed at this run's files, written to workdir/name.yaml."""
    from espnet_tpu_torch.utils.config import dump_yaml, resolve_config
    data = workdir / "data"
    cfg = resolve_config(task.default_config(), asset / "config.yaml", {
        "output_dir": str(workdir / name),
        "train_data_path_and_name_and_type": [
            f"{data}/train/wav.scp,speech,sound",
            f"{data}/train/text,text,text"],
        "valid_data_path_and_name_and_type": [
            f"{data}/valid/wav.scp,speech,sound",
            f"{data}/valid/text,text,text"],
        "train_shape_file": [], "valid_shape_file": [],
        "token_list": str(asset / "tokens.txt"),
        "stats_file": str(asset / "feats_stats.npz"),
        "init_param": str(asset / "params_f16.npz"),
        "batch_size": TRAIN_BATCH, "max_epoch": 1,
        "num_iters_per_epoch": TRAIN_STEPS, "log_interval": 1, **extra})
    dump_yaml(cfg, workdir / f"{name}.yaml")
    return cfg, workdir / f"{name}.yaml"


def longform_config(workdir: Path, name: str, **extra):
    """The long-form slice's config, written to workdir/name.yaml: the
    flagship's, with the Longformer encoder at the flagship's widths,
    batches padded to their longest recording (no collate_fixed_lengths),
    no initial weights (the entry point initialises as flax would, from
    the seed), over the long-form data dirs."""
    from espnet_tpu_torch.tasks.asr import ASRTask
    from espnet_tpu_torch.utils.config import (dump_yaml, load_yaml,
                                               resolve_config)
    base = load_yaml(ASSET / "config.yaml")
    base.pop("collate_fixed_lengths")
    data = workdir / "data"
    cfg = resolve_config(ASRTask.default_config(), overrides={
        **base, "encoder": "longformer", "encoder_conf": dict(LONG_ENCODER),
        "output_dir": str(workdir / name),
        "train_data_path_and_name_and_type": [
            f"{data}/train_long/wav.scp,speech,sound",
            f"{data}/train_long/text,text,text"],
        "valid_data_path_and_name_and_type": [
            f"{data}/valid_long/wav.scp,speech,sound",
            f"{data}/valid_long/text,text,text"],
        "train_shape_file": [], "valid_shape_file": [],
        "token_list": str(ASSET / "tokens.txt"),
        "stats_file": str(ASSET / "feats_stats.npz"), "init_param": None,
        "batch_size": LONG_BATCH, "max_epoch": LONG_EPOCHS,
        "num_iters_per_epoch": None, "log_interval": 1, **extra})
    dump_yaml(cfg, workdir / f"{name}.yaml")
    return cfg, workdir / f"{name}.yaml"


def encoder_frames(samples: int, hop: int) -> int:
    """Encoder frames of a recording: the frontend's frames, then
    conv2d x4's two (k=3, s=2) convolutions."""
    from espnet_tpu_torch.nn.subsampling import sub_out_len
    return sub_out_len(sub_out_len(samples // hop + 1, 3, 2), 3, 2)


def grad_errors(kern, plain) -> dict:
    """Each gradient's max abs error, and that error against its own
    largest plain entry, or against the case's largest gradient entry
    for a gradient that is zero in exact arithmetic (below 1e-3 of it)."""
    top = max(float(b.abs().max()) for b in plain)
    out = {}
    for name, a, b in zip(("dq", "dk", "dv"), kern, plain):
        own = float(b.abs().max())
        err = float((a - b).abs().max())
        out[name] = {"max_abs_err": err,
                     "rel_err": err / max(own if own >= 1e-3 * top else top,
                                          1e-30)}
    return out


def first_batch(iter_factory, device):
    """The first batch of epoch 1, collated and on ``device``."""
    from espnet_tpu_torch.train.trainer import to_device
    keys = iter_factory.epoch_batches(1)[0]
    _, batch = iter_factory.collate_fn([iter_factory.dataset[k]
                                        for k in keys])
    return to_device(batch, device)


def train_run(torch, _cuda, entry_main, cfg_path: Path, model_cls):
    """Train through an entry point with every launch count at 0 first.
    A forward pre-hook on the model notes the counts at each forward, so
    a train step's launches are the difference to the next forward (its
    backward and update lie between). -> the trainer, launches per step,
    all launches, wall seconds, peak device bytes."""
    snaps = []

    def note(module, args):
        if isinstance(module, model_cls):
            snaps.append((module.training, dict(_cuda.LAUNCHES)))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    handle = torch.nn.modules.module.register_module_forward_pre_hook(note)
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        _, trainer = entry_main(["--config", str(cfg_path)])
    finally:
        handle.remove()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    snaps.append((None, launches))
    per_step = [{n: nxt[n] - cur[n] for n in cur}
                for (training, cur), (_, nxt) in zip(snaps, snaps[1:])
                if training]
    return (trainer, per_step, launches, wall,
            torch.cuda.max_memory_allocated())


def check_steps(steps, per_step, want, loss_keys, n_steps=TRAIN_STEPS):
    """n_steps finite, unskipped steps with launches ``want`` each."""
    if len(steps) != n_steps or len(per_step) != n_steps:
        raise AssertionError(f"{len(steps)} train steps, not {n_steps}")
    for s, n in zip(steps, per_step):
        if not all(math.isfinite(s[k]) for k in loss_keys + ("grad_norm",)):
            raise AssertionError(f"a non-finite train step: {s}")
        if s["skipped"]:
            raise AssertionError(f"a train step was skipped: {s}")
        if n != want:
            raise AssertionError(f"launches per step {n}, not {want}")


def grad_check(torch, task, config: Path, model_file: Path, batch) -> dict:
    """One backward of ``task``'s model of (config, model_file) in eval
    mode on ``batch``, on the card and on the CPU: the loss and each
    parameter's gradient must agree within GRAD_TOL of its scale (the
    larger of its own largest entry and 1e-4 of the model's largest
    gradient).

    A ReLU has no derivative at 0, and fp32 rounding decides on which
    side of it a pre-activation within ~1e-7 of 0 falls: the two devices
    may then differ by a whole unit's term in the gradient of the weights
    before it, though both are right. So the CPU's backward takes the
    card's side at every ReLU (tools/grad_pin.py: its pre-activations
    where the signs differ are moved onto the card's side, with an
    identity gradient); how many units moved in each module and by how
    much, and the worst ratio without the move, are reported beside the
    check, and a move above grad_pin.MOVE_TOL of its module's largest
    |pre-activation| (more than rounding) fails it.

    Beside the check, a float64 backward of the same model on the CPU
    (the plain versions, the card's pins) is the reference of both
    fp32 legs: each parameter's distance from it on the same scale, for
    the card and for the CPU, the worst ten of each.

    The CPU legs also take the card's inputs of every rel-pos
    self-attention (grad_pin.pin_attention) and a joint model's
    separated estimates (grad_pin.pin_estimates), moves bounded as the
    ReLU pin's: a trained Conformer's scores reach ~1e3 with most rows on
    one key, where the gradients of q and k turn the forward's rounding
    into ~1e-3 of their scale (the joint model's 8 utterances on an
    H100: card against CPU 0.125 with no pin, 4.6e-4 with the pins);
    with one set of inputs each leg's attention backward is held to
    GRAD_TOL on its own, and a forward that differs by more than
    rounding fails the move bound."""
    from espnet_tpu_torch import convert
    from espnet_tpu_torch.tools import grad_pin
    from espnet_tpu_torch.train.trainer import to_device
    signs, moved = {}, {"cpu": {}, "cpu_float64": {}}
    losses, grads, seconds = {}, {}, {}
    for dev in ("cuda", "cpu_free", "cpu", "cpu_float64"):
        t0 = time.perf_counter()
        m, _ = task.build_model_from_file(config, model_file,
                                          dev.split("_")[0])
        if dev == "cpu_float64":
            grad_pin.to_float64(m)
        hooks = (grad_pin.pin_relus(grad_pin.relu_inputs(m), signs,
                                    moved.get(dev))
                 + grad_pin.pin_estimates(m, signs, moved.get(dev))
                 + grad_pin.pin_attention(m, signs, moved.get(dev))
                 + grad_pin.pin_codes(m, signs, moved.get(dev))
                 if dev != "cpu_free" else [])
        loss, _, _ = m(**to_device(batch, dev.split("_")[0]))
        loss.backward()
        for h in hooks:
            h.remove()
        losses[dev] = loss.item()
        grads[dev] = convert.state_dict_to_flax(m, grad=True)
        seconds[dev] = time.perf_counter() - t0
        del m, loss
    top = max(float(abs(g).max()) for g in grads["cpu"].values())
    top64 = max(float(abs(g).max()) for g in grads["cpu_float64"].values())

    def ratios(dev, ref, top_):
        return {n: float(abs(grads[dev][n] - g).max())
                / max(float(abs(g).max()), 1e-4 * top_)
                for n, g in grads[ref].items()}

    pinned, free = ratios("cuda", "cpu", top), ratios("cuda", "cpu_free",
                                                       top)
    card64 = ratios("cuda", "cpu_float64", top64)
    cpu64 = ratios("cpu", "cpu_float64", top64)
    worst = max(pinned, key=pinned.get)
    worst_free = max(free, key=free.get)

    def worst_ten(mine, other):
        return [[n, mine[n], other[n]]
                for n in sorted(mine, key=mine.get, reverse=True)[:10]]

    out = {"batch": len(next(iter(batch.values()))),
           "loss_card": losses["cuda"],
           "loss_cpu": losses["cpu"], "max_grad_ratio": pinned[worst],
           "worst_param": worst, "n_params": len(pinned), "tol": GRAD_TOL,
           "pins_moved": {"cpu": moved["cpu"],
                          "float64": moved["cpu_float64"],
                          "rows": "{pin: [entries moved, largest move, that "
                                  "over the pinned tensor's largest]}",
                          "tol": grad_pin.MOVE_TOL},
           "n_over_tol": sum(r > GRAD_TOL for r in pinned.values()),
           "max_grad_ratio_unmoved": free[worst_free],
           "worst_param_unmoved": worst_free,
           "float64": {
               "loss": losses["cpu_float64"],
               "seconds": seconds["cpu_float64"],
               "seconds_card": seconds["cuda"], "seconds_cpu": seconds["cpu"],
               "scale_of": ("max(own largest float64 entry, 1e-4 of the "
                            "model's largest float64 gradient)"),
               "max_card_vs_float64": max(card64.values()),
               "max_cpu_vs_float64": max(cpu64.values()),
               "worst_param": [worst, card64[worst], cpu64[worst]],
               "card_worst10": worst_ten(card64, cpu64),
               "cpu_worst10": worst_ten(cpu64, card64),
               "rows": "[param, this leg's distance, the other leg's]"}}
    far = {f"{leg}/{name}": row for leg, rows in moved.items()
           for name, row in rows.items()
           if not name.endswith(".codes") and not row[2] <= grad_pin.MOVE_TOL}
    if far:
        raise AssertionError(f"a pin moved entries by more than "
                             f"rounding: {far}")
    if not pinned[worst] <= GRAD_TOL:
        raise AssertionError(f"card and CPU gradients disagree: {worst} "
                             f"{pinned[worst]}; float64 leg {out['float64']}")
    if not abs(losses["cuda"] / losses["cpu"] - 1) <= GRAD_TOL:
        raise AssertionError(f"card and CPU losses disagree: {losses}")
    return out


def ctc_backward_nodes(loss) -> list:
    """Names of the autograd nodes under ``loss`` that belong to torch's
    own CTC loss."""
    seen, todo = set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None and fn not in seen:
            seen.add(fn)
            todo.extend(f for f, _ in fn.next_functions)
    return sorted({type(fn).__name__ for fn in seen
                   if "ctcloss" in type(fn).__name__.lower()})


def determinism(task, make_config, name: str) -> dict:
    """Two whole runs of DETERMINISM_STEPS steps (one per epoch) from one
    seed, and one stopped an epoch early and resumed: the three must end
    with bit-identical parameters. ``make_config(name, **extra)`` writes a
    config of the model and returns (cfg, path)."""
    import numpy as np
    from espnet_tpu_torch.train.checkpoint import load_checkpoint
    finals = {}
    for run_name, stops in (("a", [DETERMINISM_STEPS]),
                            ("b", [DETERMINISM_STEPS]),
                            ("resumed", [DETERMINISM_STEPS - 1,
                                         DETERMINISM_STEPS])):
        for i, max_epoch in enumerate(stops):
            cfg, path = make_config(
                f"det_{name}_{run_name}", num_iters_per_epoch=1,
                max_epoch=max_epoch, valid_data_path_and_name_and_type=[],
                resume=i > 0)
            task.main(argv=["--config", str(path)])
        finals[run_name] = load_checkpoint(Path(cfg["output_dir"])
                                           / "checkpoint")
    ref, _, ref_meta = finals["a"]
    out = {"steps": DETERMINISM_STEPS, "n_params": len(ref)}
    for run_name in ("b", "resumed"):
        flat, _, meta = finals[run_name]
        differ = sorted(k for k in ref if not np.array_equal(flat[k],
                                                             ref[k]))
        out[f"{run_name}_differs"] = differ[:5]
        out[f"{run_name}_n_differ"] = len(differ)
        if differ or meta["epoch"] != ref_meta["epoch"]:
            raise AssertionError(f"{name}: run {run_name} differs from run "
                                 f"a in {len(differ)} parameters, e.g. "
                                 f"{differ[:3]}")
    return out


def banded_checks(torch, lmodel, dspeech, dlens, tbatch) -> dict:
    """K4 and K4b against their plain versions: on the first Longformer
    block's q, k, v and valid frames of the long-form decode batch
    (forward) and of the first long-form train batch (backward, the
    output gradient zero on padded rows), and on small ragged cases; each
    timed beside its plain version and SDPA with the band as a float mask.
    -> {"checks": [...], "kernels": [...], "k4_err", "k4b_err"}."""
    import torch.nn.functional as F

    from espnet_tpu_torch.ops.banded_attention import (
        _launch_fwd, banded_allowed, banded_attention, banded_attention_bwd,
        banded_attention_bwd_plain, banded_attention_plain,
        banded_stats_plain)
    captured = {}
    lattn = lmodel.encoder_mod.layers[0].self_attn
    hook = lattn.register_forward_pre_hook(
        lambda module, args: captured.__setitem__("args", args))
    with torch.no_grad():
        lmodel.encode(dspeech, dlens)
        dargs = captured["args"]
        lq, lk, lv = lattn.qkv(*dargs[:3])
        band, lvalid = dargs[4], dargs[5]
        lmodel.encode(tbatch["speech"], tbatch["speech_lengths"])
        targs = captured["args"]
        # as the encoder hands them over: views of its projections
        tviews = lattn.qkv(*targs[:3])
        bq, bk, bv = (t.contiguous() for t in tviews)
        bvalid = targs[5]
    hook.remove()
    lscale = lattn.dk ** -0.5
    Bl, Hl, Tl, dl = lq.shape
    Bb, Hb, Tb, db = bq.shape
    g4 = torch.Generator(device="cuda").manual_seed(4)
    bdout = torch.randn(bq.shape, generator=g4, device="cuda") \
        * bvalid[:, None, :, None]

    def errors(q_, k_, v_, w_, valid_, scale, dout_):
        """Forward max abs error, and the gradients through autograd."""
        with torch.no_grad():
            fwd = float((banded_attention(q_, k_, v_, w_, valid_,
                                          sm_scale=scale)
                         - banded_attention_plain(q_, k_, v_, w_, valid_,
                                                  sm_scale=scale))
                        .abs().max())
        ins = [t.detach().clone().requires_grad_() for t in (q_, k_, v_)]
        kern = torch.autograd.grad(
            banded_attention(*ins, w_, valid_, sm_scale=scale), ins, dout_)
        plain = torch.autograd.grad(
            banded_attention_plain(*ins, w_, valid_, sm_scale=scale), ins,
            dout_)
        return fwd, grad_errors(kern, plain)

    k4_errs, k4b_errs = {}, {}
    with torch.no_grad():
        k4_errs["decode"] = float(
            (banded_attention(lq, lk, lv, band, lvalid, sm_scale=lscale)
             - banded_attention_plain(lq, lk, lv, band, lvalid,
                                      sm_scale=lscale)).abs().max())
    k4_errs["train"], k4b_errs["train"] = errors(bq, bk, bv, band, bvalid,
                                                 lscale, bdout)
    # T = 70 (not a multiple of 64) with a padded tail of 50 > W = 3;
    # W = 100 >= T = 50; W = 0 with 30 padded frames
    for name, (B_, H_, T_, d_, w_, lens_) in {
            "t70_w3_tail50": (2, 3, 70, 40, 3, (70, 20)),
            "w_ge_t": (2, 2, 50, 16, 100, (50, 7)),
            "w0": (1, 2, 130, 128, 0, (100,))}.items():
        rq, rk, rv, rdout = (torch.randn(B_, H_, T_, d_, generator=g4,
                                         device="cuda") for _ in range(4))
        rvalid = (torch.arange(T_, device="cuda")[None]
                  < torch.tensor(lens_, device="cuda")[:, None])
        k4_errs[name], k4b_errs[name] = errors(rq, rk, rv, w_, rvalid,
                                               d_ ** -0.5, rdout)
    with torch.no_grad():
        bout = banded_attention_plain(bq, bk, bv, band, bvalid,
                                      sm_scale=lscale)
        bstats = banded_stats_plain(bq, bk, band, bvalid, sm_scale=lscale)
    dmask = torch.where(banded_allowed(Tl, band, lvalid, "cuda"), 0.0,
                        -1e9)
    bmask = torch.where(banded_allowed(Tb, band, bvalid, "cuda"), 0.0,
                        -1e9)
    # the function's data-dependent work: the allowed (i, j) pairs of
    # these inputs' lengths, in every head
    d_pairs = Hl * float((dmask == 0).sum())
    b_pairs = Hb * float((bmask == 0).sum())
    blib_ins = [t.detach().clone().requires_grad_() for t in (bq, bk, bv)]
    blib_out = F.scaled_dot_product_attention(*blib_ins, attn_mask=bmask,
                                              scale=lscale)

    def k4b():
        return banded_attention_bwd(bq, bk, bv, bvalid, bout, bstats, bdout,
                                    window=band, sm_scale=lscale)

    def k4():
        return banded_attention(lq, lk, lv, band, lvalid, sm_scale=lscale)

    def k4_library():
        return F.scaled_dot_product_attention(lq, lk, lv, attn_mask=dmask,
                                              scale=lscale)

    with torch.no_grad():
        # two launches at the decode shape on the encoder's strided views,
        # and one on contiguous copies: the same bits, stats too
        k4_runs = [_launch_fwd(*qkv, lvalid, band, lscale, True)
                   for qkv in ((lq, lk, lv), (lq, lk, lv),
                               (lq.contiguous(), lk.contiguous(),
                                lv.contiguous()))]
        k4_same = all(torch.equal(a, b) for run in k4_runs[1:]
                      for a, b in zip(run, k4_runs[0]))
        del k4_runs
        k4_train = {
            "shape": [Bb, Hb, Tb, db],
            "valid_frames": bvalid.sum(1).tolist(),
            "ms": time_ms(torch, lambda: banded_attention(
                *tviews, band, bvalid, sm_scale=lscale)),
            "plain_ms": time_ms(torch, lambda: banded_attention_plain(
                *tviews, band, bvalid, sm_scale=lscale)),
            "library_ms": time_ms(torch, lambda: (
                F.scaled_dot_product_attention(*tviews, attn_mask=bmask,
                                               scale=lscale))),
            "flops": 4.0 * db * b_pairs,
            "bytes": 4.0 * 4 * Bb * Hb * Tb * db + Bb * Tb}
        bound(k4_train, tensor_cores=True)
        k4_profiled = device_times(torch, {"kernel": k4,
                                           "library": k4_library})

    def k4b_library():
        return torch.autograd.grad(blib_out, blib_ins, bdout,
                                   retain_graph=True)

    # two launches at the path's shape give the same bits
    k4b_same = all(torch.equal(a, b) for a, b in zip(k4b(), k4b()))
    try:
        k4b_library_ms, k4b_library_note = time_ms(torch, k4b_library), None
    except RuntimeError as e:   # a yardstick only: no backend may take it
        k4b_library_ms, k4b_library_note = None, str(e)[:300]
    profiled = device_times(torch, {"kernel": k4b} | (
        {"library": k4b_library} if k4b_library_ms is not None else {}))
    return {
        "k4_same": k4_same,
        "k4b_same": k4b_same,
        "k4_err": max(k4_errs.values()),
        "k4b_err": max(e["rel_err"] for case in k4b_errs.values()
                       for e in case.values()),
        "checks": [
            {"name": "banded_attn_fwd", "shape": [Bl, Hl, Tl, dl],
             "window": band, "valid_frames": lvalid.sum(1).tolist(),
             "tol": K4_TOL, "tol_of": "max abs err, every row",
             "same_bits_twice": k4_same, "cases": k4_errs},
            {"name": "banded_attn_bwd", "shape": [Bb, Hb, Tb, db],
             "window": band, "valid_frames": bvalid.sum(1).tolist(),
             "tol": K4B_TOL, "same_bits_twice": k4b_same,
             "tol_of": ("max abs err / max |plain| (the case's largest "
                        "gradient for a gradient zero in exact arithmetic)"),
             "cases": k4b_errs}],
        # the least work: 4 d operations per allowed (i, j) pair (q k^T
        # and P v) with q, k, v and out moved once; the backward's five
        # products (q k^T, do v^T, P^T do, dS^T q, dS k) with q, k, v, o,
        # do, the row statistics, dq, dk and dv moved once
        "kernels": [
            {"name": "banded_attn_fwd", "route": "cuda",
             "source": "espnet_tpu_torch/csrc/banded_attn.cu",
             "replaces": ("espnet_tpu/ops/attention_kernels.py:88 "
                          "(banded_attention -> _splash_banded_kernel :71, "
                          "splash _splash_attention_forward)"),
             "max_abs_err": k4_errs["decode"],
             "ms": time_ms(torch, k4),
             "plain_ms": time_ms(torch, lambda: banded_attention_plain(
                 lq, lk, lv, band, lvalid, sm_scale=lscale)),
             "library_ms": time_ms(torch, k4_library),
             "library_note": ("scaled_dot_product_attention with the band "
                              "and the valid keys as a float mask"),
             "at_train_shape": k4_train, "device_kernels": k4_profiled,
             "flops": 4.0 * dl * d_pairs,
             "bytes": 4.0 * 4 * Bl * Hl * Tl * dl + Bl * Tl},
            {"name": "banded_attn_bwd", "route": "cuda",
             "source": "espnet_tpu_torch/csrc/banded_attn_bwd.cu",
             "replaces": ("jax/experimental/pallas/ops/tpu/splash_attention/"
                          "splash_attention_kernel.py:2241 "
                          "(_splash_attention_bwd, reached from "
                          "espnet_tpu/ops/attention_kernels.py:116)"),
             "max_abs_err": max(e["max_abs_err"]
                                for e in k4b_errs["train"].values()),
             "ms": time_ms(torch, k4b),
             "plain_ms": time_ms(torch, lambda: banded_attention_bwd_plain(
                 bq, bk, bv, bvalid, bout, bstats, bdout, window=band,
                 sm_scale=lscale)),
             "library_ms": k4b_library_ms,
             "library_note": k4b_library_note or (
                 "autograd backward of scaled_dot_product_attention with "
                 "the band and the valid keys as a float mask"),
             "device_kernels": profiled,
             "flops": 10.0 * db * b_pairs,
             "bytes": 4.0 * (8 * Bb * Hb * Tb * db + 2 * Bb * Hb * Tb)
             + Bb * Tb}]}


def stream_pieces(audio):
    """[(piece, is_final)] of STREAM_CHUNK samples."""
    return [(audio[i:i + STREAM_CHUNK], i + STREAM_CHUNK >= len(audio))
            for i in range(0, len(audio), STREAM_CHUNK)]


def pool_round(pool, feeds) -> dict:
    """One piece to each session of ``feeds`` ({sid: (piece, final)}),
    then one drain of the pool: the sessions' windows share its batched
    steps. -> {sid: ids}; a final piece closes its session, as the
    pool's push does."""
    import numpy as np
    for sid, (piece, final) in feeds.items():
        pool._fes[sid].push(np.asarray(piece, np.float32), is_final=final)
        pool._final[sid] = final
    pool._drain()
    out = {sid: list(pool._hyps[sid]) for sid in feeds}
    for sid, (_, final) in feeds.items():
        if final:
            pool.close(sid)
    return out


def latency_ms(lats) -> dict:
    import numpy as np
    ms = 1e3 * np.asarray(lats[LATENCY_SKIP:])
    return {"p50": float(np.percentile(ms, 50)),
            "p95": float(np.percentile(ms, 95)),
            "mean": float(ms.mean()), "n": int(ms.size)}


def wer_cer(score_corpus, refs, hyps) -> dict:
    words = score_corpus(refs, hyps, "word")
    return {"wer": words["err_rate"],
            "cer": score_corpus(refs, hyps, "char")["err_rate"],
            "word_errors": words["sub"] + words["del"] + words["ins"],
            "ref_words": words["ref_len"]}


def streaming_phases(torch, _cuda, workdir: Path, smi: str) -> dict:
    """Phases 15-18: the streaming decoders and the transducer CLI on the
    card. -> the CLI's launches per batch."""
    from espnet_tpu_torch.bin.asr_inference_streaming import (
        Speech2TextStreaming, StreamingSessionPool)
    from espnet_tpu_torch.bin.asr_transducer_inference import (
        Speech2TextTransducerStreaming, inference)
    from espnet_tpu_torch.data.fileio import (SoundScpReader,
                                              read_2columns_text)
    from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
    from espnet_tpu_torch.decode.transducer_search import (
        greedy_stream_init, greedy_stream_step)
    from espnet_tpu_torch.frontends.streaming import (
        StreamingFeatureExtractor, subsample_window, subsampled_valid_len)
    from espnet_tpu_torch.nn.streaming_encoder import \
        StreamingConformerEncoder
    from espnet_tpu_torch.utils.scoring import score_corpus

    data = workdir / "stream_data"
    SynthSpeechCorpus().materialize(data, n_train=0, n_valid=N_STREAM,
                                    n_test=N_UTTS)
    reader = SoundScpReader(data / "valid" / "wav.scp")
    texts = read_2columns_text(data / "valid" / "text")
    keys = sorted(reader.keys())
    refs = [texts[k] for k in keys]
    audios = [reader[k][1] for k in keys]
    audio_s = sum(len(a) for a in audios) / 16000

    def stream_all(push):
        """Every utterance through push(piece, is_final) -> its last
        result; the latency of each push, synchronised."""
        outs, lats = [], []
        for audio in audios:
            for piece, final in stream_pieces(audio):
                t0 = time.perf_counter()
                res = push(piece, final)
                torch.cuda.synchronize()
                lats.append(time.perf_counter() - t0)
            outs.append(res)
        return outs, lats

    # 15. streaming CTC, greedy, one session
    s2t = Speech2TextStreaming(asr_train_config=STREAMING / "config.yaml",
                               asr_model_file=STREAMING)
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    res, lats = stream_all(lambda p, f: s2t(p, is_final=f))
    wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    single_ids = [r[0][2] for r in res]
    scores = wer_cer(score_corpus, refs, [r[0][0] for r in res])
    # one utterance on the card and on the CPU: the class's ids, and the
    # encoder chunks of its own encoder steps on the same windows
    cpu = Speech2TextStreaming(asr_train_config=STREAMING / "config.yaml",
                               asr_model_file=STREAMING, device="cpu")
    chunks, ids = {}, {}
    for dev, m in (("cuda", s2t), ("cpu", cpu)):
        for piece, final in stream_pieces(audios[0]):
            ids[dev] = m(piece, is_final=final)[0][2]
        with torch.no_grad():
            for piece, final in stream_pieces(audios[0]):
                m.fe.push(piece, is_final=final)
                m._encode_pending(final)
        chunks[dev] = torch.cat(m._enc_chunks).cpu()
        m.reset()
    enc_err = float((chunks["cuda"] - chunks["cpu"]).abs().max())
    enc_scale = float(chunks["cpu"].abs().max())
    emit({"phase": "streaming_decode", "asset": STREAMING.name,
          "n_utts": len(keys), "chunk_samples": STREAM_CHUNK,
          "window": [s2t.feat_window, s2t.feat_advance]} | scores
         | {"wer_limit": MAX_STREAM_WER, "jax_fp32_wer": JAX_STREAM_WER,
            "audio_seconds": audio_s, "wall_seconds": wall,
            "audio_s_per_s": audio_s / wall,
            "chunk_latency_ms": latency_ms(lats), "launches": launches,
            "card_vs_cpu": {"enc_frames": int(chunks["cpu"].shape[0]),
                            "enc_max_abs_err": enc_err,
                            "enc_scale": enc_scale, "tol": STREAM_ENC_TOL,
                            "ids_equal": ids["cuda"] == ids["cpu"],
                            "ids_equal_main_run":
                                ids["cuda"] == single_ids[0]},
            "nvidia_smi": smi,
            "examples": [[r, h[0][0]] for r, h in zip(refs[:3], res[:3])]})
    if not scores["wer"] <= MAX_STREAM_WER:
        raise AssertionError(f"streaming WER {scores['wer']} above "
                             f"{MAX_STREAM_WER}")
    if not (enc_err <= STREAM_ENC_TOL * enc_scale
            and ids["cuda"] == ids["cpu"] == single_ids[0]):
        raise AssertionError(f"streaming on the card and on the CPU "
                             f"disagree: {enc_err}, {ids}")
    del cpu

    # 16. the session pool: 8 utterances, one more session opened each
    # round; a round gives a piece to every open session and drains
    # once, so the sessions' windows share the batched steps; each
    # session's ids must equal its single session's
    pool = StreamingSessionPool(s2t, max_sessions=POOL_SESSIONS)
    plans = [stream_pieces(a) for a in audios[:POOL_SESSIONS]]
    sids, pool_ids, rounds, round_lats = {}, {}, 0, []
    # the rows that hold a window in each batched step (idle rows are
    # zeros)
    rows_per_step = []
    step = s2t.encoder_step

    def counted_step(feats, state):
        rows_per_step.append(int((feats != 0).any(axis=(1, 2)).sum()))
        return step(feats, state)

    s2t.encoder_step = counted_step
    t0 = time.perf_counter()
    while len(pool_ids) < POOL_SESSIONS:
        if rounds < POOL_SESSIONS:
            sids[rounds] = pool.open()
        feeds = {u: plans[u].pop(0) for u in sids if u not in pool_ids}
        t1 = time.perf_counter()
        ids = pool_round(pool, {sids[u]: f for u, f in feeds.items()})
        torch.cuda.synchronize()
        round_lats.append(time.perf_counter() - t1)
        for u in feeds:
            if not plans[u]:
                pool_ids[u] = ids[sids[u]]
        rounds += 1
    pool_wall = time.perf_counter() - t0
    s2t.encoder_step = step
    pool_audio = sum(len(a) for a in audios[:POOL_SESSIONS]) / 16000
    equal = [pool_ids[u] == single_ids[u] for u in range(POOL_SESSIONS)]
    emit({"phase": "streaming_pool", "max_sessions": POOL_SESSIONS,
          "rounds": rounds, "batched_steps": len(rows_per_step),
          "rows_per_step_mean": statistics.mean(rows_per_step),
          "rows_per_step_max": max(rows_per_step),
          "sessions_equal_single": sum(equal),
          "audio_seconds": pool_audio, "wall_seconds": pool_wall,
          "audio_s_per_s": pool_audio / pool_wall,
          "round_latency_ms": {
              "p50": 1e3 * statistics.median(round_lats),
              "max": 1e3 * max(round_lats)},
          "nvidia_smi": smi})
    if not all(equal):
        raise AssertionError(f"pool sessions differ from their single "
                             f"sessions: {equal}")
    if not max(rows_per_step) > 1:
        raise AssertionError("no batched step of the pool held two rows")
    del pool, s2t

    # 17. the streaming transducer: the recipe's loop from the port's
    # modules (GlobalMVN per window, stream_step, greedy_stream_step on
    # the valid frames, umax 128), then the port's class as it is
    s2tt = Speech2TextTransducerStreaming(
        train_config=TRANSDUCER / "config.yaml", model_file=TRANSDUCER)
    model = s2tt.model
    W, A = subsample_window(4, model.encoder_mod.chunk_size)
    fc = s2tt.cfg["frontend_conf"]

    # the greedy search's share: its seconds (synchronised around each
    # call) and its loop's steps (at batch 1, a frame or an emission each)
    search = {"seconds": 0.0, "steps": 0}

    def recipe(audio):
        fe = StreamingFeatureExtractor(
            n_fft=fc["n_fft"], hop_length=fc["hop_length"],
            n_mels=fc["n_mels"], device="cuda")
        enc_st = model.encoder_mod.init_stream_state(1, "cuda")
        dec_st = greedy_stream_init(model, 1, TSTREAM_UMAX, "cuda")
        frames, lats = 0, []
        with torch.no_grad():
            for piece, final in stream_pieces(audio):
                t0 = time.perf_counter()
                fe.push(piece, is_final=final)
                while (popped := fe.pop_one_window(
                        W, A, is_final=final, with_valid=True)):
                    win, n_valid = popped
                    f = torch.from_numpy(win[None]).cuda()
                    f, _ = model.normalize(f, torch.full(
                        (1,), W, dtype=torch.long, device="cuda"))
                    enc, enc_st = model.encoder_mod.stream_step(f, enc_st)
                    n_out = subsampled_valid_len(4, n_valid)
                    frames += n_out
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    dec_st = greedy_stream_step(
                        model, enc, torch.full((1,), n_out, device="cuda"),
                        dec_st)
                    torch.cuda.synchronize()
                    search["seconds"] += time.perf_counter() - t1
                torch.cuda.synchronize()
                lats.append(time.perf_counter() - t0)
        n = int(dec_st.n_tok[0])
        search["steps"] += frames + n
        toks = s2tt.converter.ids2tokens(dec_st.tokens[0, :n].tolist())
        return "".join(toks).replace("<space>", " ").strip(), lats

    t0 = time.perf_counter()
    outs = [recipe(a) for a in audios]
    rwall = time.perf_counter() - t0
    rscores = wer_cer(score_corpus, refs, [h for h, _ in outs])
    rlats = [x for _, lat in outs for x in lat]
    t0 = time.perf_counter()
    res, clats = stream_all(lambda p, f: s2tt(p, is_final=f))
    cwall = time.perf_counter() - t0
    cscores = wer_cer(score_corpus, refs, [r[0][0] for r in res])
    emit({"phase": "transducer_streaming_decode",
          "asset": TRANSDUCER.name, "n_utts": len(keys),
          "recipe_loop": rscores | {
              "wer_limit": MAX_TSTREAM_RECIPE_WER,
              "jax_fp32_wer": JAX_TSTREAM_RECIPE_WER, "umax": TSTREAM_UMAX,
              "wall_seconds": rwall, "audio_s_per_s": audio_s / rwall,
              "chunk_latency_ms": latency_ms(rlats),
              "search_seconds": search["seconds"],
              "search_steps": search["steps"],
              "search_ms_per_step": 1e3 * search["seconds"]
              / search["steps"],
              "examples": [[r, h] for r, (h, _) in zip(refs[:3], outs)]},
          "class": cscores | {
              "wer_limit": MAX_TSTREAM_CLASS_WER,
              "jax_fp32_wer": JAX_TSTREAM_CLASS_WER, "umax": s2tt.umax,
              "wall_seconds": cwall, "audio_s_per_s": audio_s / cwall,
              "chunk_latency_ms": latency_ms(clats),
              "examples": [[r, h[0][0]] for r, h in zip(refs[:3], res)]},
          "nvidia_smi": smi})
    if not rscores["wer"] <= MAX_TSTREAM_RECIPE_WER:
        raise AssertionError(f"streaming transducer WER {rscores['wer']} "
                             f"above {MAX_TSTREAM_RECIPE_WER}")
    if not cscores["wer"] <= MAX_TSTREAM_CLASS_WER:
        raise AssertionError(f"streaming transducer class WER "
                             f"{cscores['wer']} above "
                             f"{MAX_TSTREAM_CLASS_WER}")
    del s2tt, model

    # 18. the transducer batch-decode CLI over the 64 held-out utterances
    # at natural lengths, batch 16, beam 5: a warm-up run, then the
    # counted one; launches per batch from the counts at each encoder
    # forward (the log-mel runs before it, the search after launches none)
    cli_args = dict(
        data_path_and_name_and_type=[f"{data}/test/wav.scp,speech,sound"],
        train_config=str(TRANSDUCER / "config.yaml"),
        model_file=str(TRANSDUCER), batch_size=CLI_BATCH)
    inference(output_dir=str(workdir / "tcli_warm"), **cli_args)

    def note(module, args):
        if isinstance(module, StreamingConformerEncoder):
            snaps.append(dict(_cuda.LAUNCHES))

    _cuda.reset_launch_counts()
    snaps = [dict(_cuda.LAUNCHES)]
    handle = torch.nn.modules.module.register_module_forward_pre_hook(note)
    t0 = time.perf_counter()
    try:
        inference(output_dir=str(workdir / "tcli"), **cli_args)
    finally:
        handle.remove()
    torch.cuda.synchronize()
    cli_wall = time.perf_counter() - t0
    per_batch = [{n: b[n] - a[n] for n in a}
                 for a, b in zip(snaps, snaps[1:])]
    ctexts = read_2columns_text(data / "test" / "text")
    recog = read_2columns_text(workdir / "tcli" / "1best_recog" / "text")
    ckeys = sorted(ctexts)
    cli_scores = wer_cer(score_corpus, [ctexts[k] for k in ckeys],
                         [recog.get(k, "") for k in ckeys])
    cli_audio = sum(len(SoundScpReader(data / "test" / "wav.scp")[k][1])
                    for k in ckeys) / 16000
    emit({"phase": "transducer_batch_decode", "n_utts": len(ckeys),
          "batch_size": CLI_BATCH, "beam": 5} | cli_scores
         | {"wer_limit": MAX_CLI_WER, "jax_fp32_wer": JAX_CLI_WER,
            "audio_seconds": cli_audio,
            "wall_seconds_with_model_build": cli_wall,
            "launches_per_batch": per_batch, "nvidia_smi": smi})
    want = {n: int(n == "logmel_fwd") for n in _cuda.LAUNCHES}
    n_batches = -(-len(ckeys) // CLI_BATCH)
    if per_batch != [want] * n_batches:
        raise AssertionError(f"CLI launches per batch {per_batch}, not "
                             f"{want} in each of {n_batches}")
    if not (len(recog) == len(ckeys)
            and cli_scores["wer"] <= MAX_CLI_WER):
        raise AssertionError(f"transducer CLI WER {cli_scores['wer']} "
                             f"above {MAX_CLI_WER} ({len(recog)} written)")
    return per_batch[0]


def si_snr_db(est, ref, eps: float = 1e-8) -> float:
    """SI-SNR in dB in float64, both zero-mean first (as
    scripts/jax_enh_reference.py computes it)."""
    import numpy as np
    est = np.asarray(est, np.float64) - np.mean(est)
    ref = np.asarray(ref, np.float64) - np.mean(ref)
    s = np.dot(est, ref) * ref / (np.dot(ref, ref) + eps)
    e = est - s
    return float(10 * np.log10((np.dot(s, s) + eps) / (np.dot(e, e) + eps)))


def pit_si_snr(ests, refs) -> float:
    """The best speaker permutation's mean SI-SNR (two speakers)."""
    import numpy as np
    return max(np.mean([si_snr_db(ests[i], refs[p])
                        for i, p in enumerate(perm)])
               for perm in ((0, 1), (1, 0)))


def enh_config(workdir: Path, name: str, **extra):
    """The enhancement asset's config with this run's data dirs and the
    asset's weights as init_param, written to workdir/name.yaml."""
    from espnet_tpu_torch.tasks.enh import EnhancementTask
    from espnet_tpu_torch.utils.config import dump_yaml, resolve_config
    data = workdir / "enh_data"
    triples = {split: [f"{data}/{split}/wav.scp,speech_mix,sound",
                       f"{data}/{split}/spk1.scp,speech_ref1,sound",
                       f"{data}/{split}/spk2.scp,speech_ref2,sound"]
               for split in ("train", "valid")}
    cfg = resolve_config(EnhancementTask.default_config(),
                         ENH / "config.yaml", {
        "output_dir": str(workdir / name),
        "train_data_path_and_name_and_type": triples["train"],
        "valid_data_path_and_name_and_type": triples["valid"],
        "train_shape_file": [f"{data}/train/speech_mix_shape"],
        "valid_shape_file": [f"{data}/valid/speech_mix_shape"],
        "init_param": str(ENH / "params_f16.npz"),
        "batch_size": ENH_TRAIN_BATCH, "max_epoch": 1,
        "num_iters_per_epoch": ENH_TRAIN_STEPS, "log_interval": 1,
        **extra})
    dump_yaml(cfg, workdir / f"{name}.yaml")
    return cfg, workdir / f"{name}.yaml"


def seed_model_dir(workdir: Path, name: str, sep: str, conf: dict,
                   **extra):
    """A model dir for one separator case: config.yaml
    (``separator_config``) and seed.npz (seed_flat's weights over the
    port's parameter tree, SEP_SEED). -> (config path, weights path)."""
    import numpy as np

    from espnet_tpu_torch import convert
    from espnet_tpu_torch.tasks.enh import EnhancementTask
    from espnet_tpu_torch.utils.config import dump_yaml, resolve_config
    d = workdir / "separators" / name
    d.mkdir(parents=True, exist_ok=True)
    cfg = resolve_config(EnhancementTask.default_config(), overrides=(
        separator_config(sep, conf, **extra)))
    dump_yaml(cfg, d / "config.yaml")
    weights = d / "seed.npz"
    if not weights.exists():
        np.savez(weights, **seed_flat(
            {k: v.shape for k, v in convert.state_dict_to_flax(
                EnhancementTask.build_model(cfg)).items()}, SEP_SEED))
    return d / "config.yaml", weights


def separator_attention_checks(torch, workdir: Path) -> dict:
    """K1 and K1b at the Conformer separator's shapes, head size 32: its
    first block's q, k, v and rel-pos bias (no padding: every frame
    attends every frame) on the first 10 test mixtures (the decode batch
    of phase 36) and on 8 train mixtures of 4 s (phase 37's batch
    shape), through tools/kernel_times.py's rows: each against its plain
    version, launched twice for the same bits, timed by CUDA events and
    the profiler beside the plain version and SDPA; with its bound.
    -> {"fwd": row, "bwd": row}."""
    import numpy as np

    from espnet_tpu_torch.bin.enh_inference import SeparateSpeech
    from espnet_tpu_torch.data.synth_speech import SynthMixCorpus
    from espnet_tpu_torch.tools.kernel_times import (attention_bwd_row,
                                                     attention_fwd_row)
    cfg_path, weights = seed_model_dir(workdir, "conformer", "conformer", {})
    model = SeparateSpeech(cfg_path, weights, fs=16000).model
    attn = model.separator_mod.enc.layers[0].self_attn
    captured = {}
    hook = attn.register_forward_pre_hook(
        lambda module, args: captured.__setitem__("args", args))
    batches = {"decode": np.stack([SynthMixCorpus().mixture("test", i)[0]
                                   for i in range(SEP_BATCH)]),
               "train": np.stack([SynthMixCorpus(seconds=4.0).mixture(
                   "train", i)[0] for i in range(ENH_TRAIN_BATCH)])}
    ins = {}
    with torch.no_grad():
        for kind, x in batches.items():
            x = torch.from_numpy(x).cuda()
            model.forward_enhance(x, torch.full((len(x),), x.shape[1],
                                                device="cuda"))
            q, k, v, bias, scale = attn.kernel_inputs(*captured["args"])
            ins[kind] = (q.contiguous(), k.contiguous(), v.contiguous(),
                         bias.contiguous())
    hook.remove()
    del model
    fwd_row = attention_fwd_row(torch, *ins["decode"], scale)
    del ins["decode"]
    g = torch.Generator(device="cuda").manual_seed(36)
    dout = torch.randn(ins["train"][0].shape, generator=g, device="cuda")
    bwd_row = attention_bwd_row(torch, *ins["train"], dout, scale)
    fwd_row["tol"] = K1_TOL
    bwd_row |= {"tol": K1B_TOL, "tol_of": "max abs err / max |plain|"}
    for row in (fwd_row, bwd_row):
        bound(row, tensor_cores=True)
    d = fwd_row["shape"][3]
    if not (fwd_row["max_abs_err"] <= K1_TOL and fwd_row["same_bits_twice"]):
        raise AssertionError(f"flash_attn_fwd at d = {d}: error "
                             f"{fwd_row['max_abs_err']}, same bits "
                             f"{fwd_row['same_bits_twice']}")
    worst = max(e["rel_err"] for e in bwd_row["errors"].values())
    if not (worst <= K1B_TOL and bwd_row["same_bits_twice"]):
        raise AssertionError(f"flash_attn_bwd at d = {d}: "
                             f"{bwd_row['errors']}, same bits "
                             f"{bwd_row['same_bits_twice']}")
    return {"fwd": fwd_row, "bwd": bwd_row}


def separator_config(sep: str, conf: dict, **extra) -> dict:
    """The TCN asset's config with another separator at its JAX class's
    width (``conf`` overrides the defaults, as the recipe's
    --separator_conf does)."""
    from espnet_tpu_torch.utils.config import load_yaml
    cfg = load_yaml(ENH / "config.yaml")
    cfg.update(separator=sep, separator_conf=dict(conf), **extra)
    return cfg


def enhancement_phases(torch, _cuda, workdir: Path, smi: str, speech_np,
                       lengths_np, refs) -> dict:
    """Phases 19-23: separation, its CLI, training and streaming on the
    TCN asset, then the joint enhancement + ASR model. -> the joint
    model's launches per decode and per train step."""
    import numpy as np

    from espnet_tpu_torch import convert
    from espnet_tpu_torch.bin import enh_s2t_train, enh_train
    from espnet_tpu_torch.bin.enh_inference import (SeparateSpeech,
                                                    inference)
    from espnet_tpu_torch.bin.enh_inference_streaming import \
        SeparateSpeechStreaming
    from espnet_tpu_torch.bin.enh_scoring import score_pairs
    from espnet_tpu_torch.data.fileio import SoundScpReader, SoundScpWriter
    from espnet_tpu_torch.data.synth_speech import SynthMixCorpus
    from espnet_tpu_torch.decode.beam_search import (BeamSearchConfig,
                                                     batch_beam_search)
    from espnet_tpu_torch.models.enh.model import EnhancementModel
    from espnet_tpu_torch.models.enh_s2t import EnhS2TModel
    from espnet_tpu_torch.tasks.enh import EnhancementTask, EnhS2TTask
    from espnet_tpu_torch.text.tokenizer import (TokenIDConverter,
                                                 build_tokenizer)
    from espnet_tpu_torch.train.trainer import evaluate
    from espnet_tpu_torch.utils.config import dump_yaml
    from espnet_tpu_torch.utils.scoring import score_corpus

    ref = json.loads(ENH_REFERENCE.read_text(encoding="utf-8"))
    data = workdir / "enh_data"
    t0 = time.perf_counter()
    corpus = SynthMixCorpus()
    corpus.materialize(data, n_train=0, n_valid=0, n_test=N_MIX)
    SynthMixCorpus(seconds=4.0).materialize(data, n_train=ENH_N_TRAIN,
                                            n_valid=ENH_N_VALID, n_test=0)
    mixtures = [corpus.mixture("test", i) for i in range(N_MIX)]
    mixes = [m for m, _, _ in mixtures]
    data_s = time.perf_counter() - t0
    test_refs = [str(data / "test" / f"spk{s}.scp") for s in (1, 2)]

    # 19. the recipe's stage 3 on the card: batches of 10, estimates
    # scaled to a 0.95 peak past one, 16-bit WAVs, scored against the
    # references and the mixture baseline
    sep = SeparateSpeech(train_config=ENH / "config.yaml", model_file=ENH,
                         fs=16000)
    sep_dir = workdir / "separated"
    writers = [SoundScpWriter(sep_dir / f"spk{s}", sep_dir / f"spk{s}.scp")
               for s in (1, 2)]
    _cuda.reset_launch_counts()
    batch_s = []
    for b in range(0, N_MIX, SEP_BATCH):
        t1 = time.perf_counter()
        ests = sep(np.stack(mixes[b:b + SEP_BATCH]))
        batch_s.append(time.perf_counter() - t1)
        for j in range(len(ests[0])):
            for s in range(2):
                e = np.asarray(ests[s][j], np.float32)
                peak = np.abs(e).max()
                if peak > SEP_PEAK:
                    e = e * (SEP_PEAK / peak)
                writers[s][f"test_{b + j:05d}"] = (16000, e)
    sep_launches = dict(_cuda.LAUNCHES)
    for w in writers:
        w.close()
    enh = score_pairs(test_refs, [str(sep_dir / f"spk{s}.scp")
                                  for s in (1, 2)], sep_dir / "score")
    base = score_pairs(test_refs, [str(data / "test" / "wav.scp")] * 2)
    si_snri = enh["si_snr"] - base["si_snr"]
    # card against CPU on the first batch
    cpu_sep = SeparateSpeech(train_config=ENH / "config.yaml",
                             model_file=ENH, fs=16000, device="cpu")
    first = np.stack(mixes[:SEP_BATCH])
    card_ests, cpu_ests = sep(first), cpu_sep(first)
    sep_err = max(rel_err(torch.from_numpy(a), torch.from_numpy(b))
                  for a, b in zip(card_ests, cpu_ests))
    # separated audio seconds per second: one batch of 10, synchronised,
    # the median of three after a warm-up
    sep(first)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sep(first)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    jax_si_snri = ref["stage3"]["si_snri"]
    emit({"phase": "enh_separate", "asset": ENH.name, "n_mixtures": N_MIX,
          "batch_size": SEP_BATCH, "data_seconds": data_s,
          "si_snr": enh["si_snr"], "si_snr_mix": base["si_snr"],
          "si_snri": si_snri, "sdr": enh["sdr"], "snr": enh["snr"],
          "jax_fp32_si_snri": jax_si_snri,
          "results_json_si_snri": ref["stage3"]["results_json_si_snri"],
          "si_snri_limit": jax_si_snri - SI_SNRI_MARGIN,
          "card_vs_cpu_rel_err": sep_err, "tol": SEP_TOL,
          "batch_seconds": batch_s, "audio_s_per_s": SEP_BATCH * 4.0
          / statistics.median(walls), "timed_seconds": walls,
          "launches": sep_launches, "nvidia_smi": smi})
    if not si_snri >= jax_si_snri - SI_SNRI_MARGIN:
        raise AssertionError(f"SI-SNRi {si_snri} below the JAX package's "
                             f"{jax_si_snri} - {SI_SNRI_MARGIN}")
    if not sep_err <= SEP_TOL:
        raise AssertionError(f"separation on the card and the CPU "
                             f"disagree: {sep_err}")
    del cpu_sep

    # 20. the CLI's inference() on a data dir of the first 8 mixtures,
    # scored; the API on the same read-back mixtures, one at a time, must
    # write the same files
    cli_dir = data / "cli_test"
    cli_dir.mkdir()
    (cli_dir / "wav.scp").write_text("".join(
        (data / "test" / "wav.scp").read_text().splitlines(True)[:N_CLI_MIX]))
    inference(output_dir=str(workdir / "enh_cli"),
              data_path_and_name_and_type=[
                  f"{cli_dir}/wav.scp,speech_mix,sound"],
              train_config=str(ENH / "config.yaml"), model_file=str(ENH),
              fs=16000)
    reader = SoundScpReader(cli_dir / "wav.scp")
    api = [SoundScpWriter(workdir / "enh_api" / f"spk{s}",
                          workdir / "enh_api" / f"spk{s}.scp")
           for s in (1, 2)]
    for key in reader.keys():
        ests = sep(reader[key][1])
        for s in range(2):
            api[s][key] = (16000, ests[s][0])
    for w in api:
        w.close()
    scored = {}
    for name in ("enh_cli", "enh_api"):
        refs_8 = []
        for s in (1, 2):
            lines = (data / "test" / f"spk{s}.scp").read_text()
            (workdir / f"{name}_ref{s}.scp").write_text("".join(
                lines.splitlines(True)[:N_CLI_MIX]))
            refs_8.append(str(workdir / f"{name}_ref{s}.scp"))
        scored[name] = score_pairs(
            refs_8, [str(workdir / name / f"spk{s}.scp") for s in (1, 2)],
            workdir / name / "score")
    files_equal = all(
        (workdir / "enh_cli" / "score" / f).read_text()
        == (workdir / "enh_api" / "score" / f).read_text()
        for f in ("SI_SNR", "SDR", "SNR", "RESULTS"))
    wavs_equal = all(
        SoundScpReader(workdir / "enh_cli" / f"spk{s}.scp")[k][1].tobytes()
        == SoundScpReader(workdir / "enh_api" / f"spk{s}.scp")[k][1]
        .tobytes() for s in (1, 2) for k in reader.keys())
    emit({"phase": "enh_cli", "n_mixtures": N_CLI_MIX,
          "cli": scored["enh_cli"], "api": scored["enh_api"],
          "score_files_equal": files_equal, "wavs_equal": wavs_equal})
    if not (files_equal and wavs_equal):
        raise AssertionError("the CLI's files differ from the API's")

    # 21. training from the asset: its config (steps_per_dispatch 8 runs
    # one step at a time), batch 8, 10 steps, validation before and after
    # at the warm-up's low learning rate; two runs from one seed; one
    # backward card against CPU
    cfg, cfg_path = enh_config(workdir, "enh_train")
    valid_if = EnhancementTask.build_iter_factory(cfg, train=False)
    start_model, _ = EnhancementTask.build_model_from_file(
        ENH / "config.yaml", ENH)
    before = evaluate(start_model, valid_if, "cuda")
    del start_model
    trainer, per_step, enh_launches, enh_wall, enh_peak = train_run(
        torch, _cuda, enh_train.main, cfg_path, EnhancementModel)
    steps = trainer.step_stats
    after = trainer.reporter.stats[1]["valid"]
    opt = trainer.optimizer
    lr_last = opt.schedule(opt.count - 1)
    step_ms = [1e3 * s["train_time"] for s in steps]
    none = {n: 0 for n in _cuda.LAUNCHES}
    check_steps(steps, per_step, none, ("loss", "si_snr"),
                n_steps=ENH_TRAIN_STEPS)
    _, gbatch = valid_if.collate_fn([valid_if.dataset[k] for k in
                                     valid_if.epoch_batches(0)[0]
                                     [:GRAD_BATCH]])
    emit({"phase": "enh_train", "n_train": ENH_N_TRAIN,
          "n_valid": ENH_N_VALID, "batch_size": ENH_TRAIN_BATCH,
          "steps_per_dispatch_in_config": cfg["steps_per_dispatch"],
          "steps": [{k: s[k] for k in ("loss", "si_snr", "grad_norm",
                                       "skipped")} | {"ms": ms}
                    for s, ms in zip(steps, step_ms)],
          "step_ms_median_3_10": statistics.median(step_ms[2:]),
          "peak_memory_bytes": enh_peak, "wall_seconds": enh_wall,
          "launches": enh_launches, "lr_last": lr_last,
          "valid_before": before, "valid_after": after,
          "determinism": determinism(
              EnhancementTask, lambda n, **kw: enh_config(workdir, n, **kw),
              "enh"),
          "grad_check": grad_check(torch, EnhancementTask,
                                   ENH / "config.yaml", ENH, gbatch),
          "nvidia_smi": smi})
    if not lr_last < ENH_MAX_LR:
        raise AssertionError(f"learning rate {lr_last} not below "
                             f"{ENH_MAX_LR}")
    if not after["si_snr"] >= before["si_snr"] - ENH_VALID_DROP:
        raise AssertionError(f"validation SI-SNR fell: {before['si_snr']} "
                             f"-> {after['si_snr']}")

    # 22. streaming separation over the 50 mixtures in 640 ms pushes
    stream = SeparateSpeechStreaming(train_config=ENH / "config.yaml",
                                     model_file=ENH, segment_size=1.0,
                                     fs=16000)
    lats, gains, streamed = [], [], []
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    for mix, r1, r2 in mixtures:
        parts = [[], []]
        for piece, final in stream_pieces(mix):
            t1 = time.perf_counter()
            got = stream(piece, is_final=final)
            torch.cuda.synchronize()
            lats.append(time.perf_counter() - t1)
            for s, g in enumerate(got):
                parts[s].append(g)
        ests = [np.concatenate(p)[:len(mix)] for p in parts]
        streamed.append(ests)
        gains.append(pit_si_snr(ests, [r1, r2])
                     - np.mean([si_snr_db(mix, r) for r in (r1, r2)]))
    stream_wall = time.perf_counter() - t0
    stream_launches = dict(_cuda.LAUNCHES)
    cpu_stream = SeparateSpeechStreaming(
        train_config=ENH / "config.yaml", model_file=ENH, segment_size=1.0,
        fs=16000, device="cpu")
    parts = [[], []]
    for piece, final in stream_pieces(mixes[0]):
        for s, g in enumerate(cpu_stream(piece, is_final=final)):
            parts[s].append(g)
    stream_err = max(
        rel_err(torch.from_numpy(a),
                torch.from_numpy(np.concatenate(p)[:len(mixes[0])]))
        for a, p in zip(streamed[0], parts))
    stream_si_snri = float(np.mean(gains))
    jax_stream = ref["streaming"]["si_snri"]
    emit({"phase": "enh_streaming", "n_mixtures": N_MIX,
          "segment_size": 1.0, "chunk_samples": STREAM_CHUNK,
          "si_snri": stream_si_snri, "jax_fp32_si_snri": jax_stream,
          "si_snri_limit": [jax_stream - SI_SNRI_MARGIN,
                            jax_stream + SI_SNRI_MARGIN],
          "push_latency_ms": latency_ms(lats), "wall_seconds": stream_wall,
          "audio_s_per_s": N_MIX * 4.0 / stream_wall,
          "launches": stream_launches,
          "card_vs_cpu_rel_err": stream_err, "tol": SEP_TOL,
          "nvidia_smi": smi})
    if not abs(stream_si_snri - jax_stream) <= SI_SNRI_MARGIN:
        raise AssertionError(f"streamed SI-SNRi {stream_si_snri} not within "
                             f"{SI_SNRI_MARGIN} of {jax_stream}")
    if not stream_err <= SEP_TOL:
        raise AssertionError(f"streaming on the card and the CPU disagree: "
                             f"{stream_err}")
    del stream, cpu_stream, sep

    # 23. the joint model from the two assets: the flagship's 64 held-out
    # clean utterances decoded (beam 10, CTC 0.3); 6 train steps with the
    # clean utterance as the mixture and as speech_ref1; one backward
    # card against CPU
    jcfg = EnhS2TTask.config_from_assets(ENH, ASSET)
    init = workdir / "enh_s2t_init.npz"
    np.savez(init, **EnhS2TTask.weights_from_assets(ENH, ASSET))
    jmodel = convert.load_flax_params(EnhS2TTask.build_model(jcfg),
                                      convert.read_npz(init)).cuda().eval()
    speech = torch.from_numpy(speech_np).cuda()
    lengths = torch.from_numpy(lengths_np).cuda()
    search = BeamSearchConfig(beam_size=BEAM, ctc_weight=CTC_WEIGHT)
    conv = TokenIDConverter(list(jmodel.token_list))
    tok = build_tokenizer("char")

    def decode():
        with torch.no_grad():
            enc, enc_lens = jmodel.encode(speech, lengths)
            return [h[0][0] for h in batch_beam_search(jmodel, enc,
                                                       enc_lens, search)]

    decode()
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    ids = decode()
    torch.cuda.synchronize()
    dec_wall = time.perf_counter() - t0
    s2t_decode_launches = dict(_cuda.LAUNCHES)
    # the level of the first estimate, which the ASR branch reads,
    # against the clean utterance's
    with torch.no_grad():
        est = jmodel.enh.forward_enhance(speech, lengths)[0][0]
    level = [float(est[u, :n].norm() / speech[u, :n].norm())
             for u, n in enumerate(lengths_np.tolist())]
    hyps = [tok.tokens2text(conv.ids2tokens(i)) for i in ids]
    n_ref = ref["enh_s2t"]["n_utts"]
    first = wer_cer(score_corpus, refs[:n_ref], hyps[:n_ref])
    differ = [[u, ids[u], want] for u, want in
              enumerate(ref["enh_s2t"]["ids"]) if ids[u] != want]
    jax_wer = ref["enh_s2t"]["wer"]
    decode_out = {"n_utts": len(ids), "beam": BEAM,
                  "ctc_weight": CTC_WEIGHT,
                  "batch_shape": list(speech.shape)} \
        | wer_cer(score_corpus, refs, hyps) | {
        f"first_{n_ref}": first, f"jax_fp32_first_{n_ref}": {
            k: ref["enh_s2t"][k] for k in ("wer", "cer", "word_errors",
                                           "ref_words")},
        "wer_limit": jax_wer + S2T_WER_MARGIN,
        f"ids_equal_first_{n_ref}": n_ref - len(differ),
        "ids_differ": differ,
        "wall_seconds": dec_wall,
        "audio_s_per_s": float(lengths_np.sum()) / 16000 / dec_wall,
        "estimate_rms_over_input_rms": {"median": statistics.median(level),
                                        "min": min(level),
                                        "max": max(level)},
        "launches": s2t_decode_launches,
        "examples": [[r, h] for r, h in zip(refs[:3], hyps[:3])]}
    data_asr = workdir / "data" / "train"
    tcfg = dict(jcfg, output_dir=str(workdir / "enh_s2t"),
                train_data_path_and_name_and_type=[
                    f"{data_asr}/wav.scp,speech_mix,sound",
                    f"{data_asr}/text,text,text",
                    f"{data_asr}/wav.scp,speech_ref1,sound"],
                valid_data_path_and_name_and_type=[],
                init_param=str(init), batch_type="sorted",
                batch_size=TRAIN_BATCH, max_epoch=1,
                num_iters_per_epoch=S2T_TRAIN_STEPS, log_interval=1,
                optim="adam", optim_conf={"lr": 0.002},
                scheduler="warmuplr", scheduler_conf={"warmup_steps": 600},
                grad_clip=5.0, seed=0)
    tcfg_path = workdir / "enh_s2t.yaml"
    dump_yaml(tcfg, tcfg_path)
    trainer, per_step, s2t_launches, s2t_wall, s2t_peak = train_run(
        torch, _cuda, enh_s2t_train.main, tcfg_path, EnhS2TModel)
    steps = trainer.step_stats
    s2t_want = dict(none, logmel_fwd=1, flash_attn_fwd=6, flash_attn_bwd=12)
    check_steps(steps, per_step, s2t_want, ("loss", "asr_loss", "enh_loss"),
                n_steps=S2T_TRAIN_STEPS)
    # the grad check's batch: the first 8 valid utterances
    valid_asr = workdir / "data" / "valid"
    tif = EnhS2TTask.build_iter_factory(
        EnhS2TTask.default_config() | tcfg | {
            "valid_data_path_and_name_and_type": [
                f"{valid_asr}/wav.scp,speech_mix,sound",
                f"{valid_asr}/text,text,text",
                f"{valid_asr}/wav.scp,speech_ref1,sound"]}, train=False)
    _, gbatch = tif.collate_fn([tif.dataset[k] for k in
                                tif.epoch_batches(0)[0][:GRAD_BATCH]])
    step_ms = [1e3 * s["train_time"] for s in steps]
    emit({"phase": "enh_s2t", "assets": [ENH.name, ASSET.name],
          "decode": decode_out,
          "train": {"batch_size": TRAIN_BATCH,
                    "steps": [{k: s[k] for k in ("loss", "asr_loss",
                                                 "asr_loss_ctc",
                                                 "asr_loss_att", "enh_loss",
                                                 "grad_norm", "skipped")}
                              | {"ms": ms, "launches": n}
                              for s, ms, n in zip(steps, step_ms, per_step)],
                    "step_ms_median_3_6": statistics.median(step_ms[2:]),
                    "peak_memory_bytes": s2t_peak,
                    "wall_seconds": s2t_wall, "launches": s2t_launches},
          "grad_check": grad_check(torch, EnhS2TTask, tcfg_path, init,
                                   gbatch),
          "nvidia_smi": smi})
    if not (s2t_decode_launches["flash_attn_fwd"] > 0
            and s2t_decode_launches["logmel_fwd"] > 0):
        raise AssertionError(f"the joint decode launched "
                             f"{s2t_decode_launches}")
    if not first["wer"] <= jax_wer + S2T_WER_MARGIN:
        raise AssertionError(f"joint WER {first['wer']} on the first {n_ref} "
                             f"above the JAX package's {jax_wer} + "
                             f"{S2T_WER_MARGIN}")
    return s2t_decode_launches, s2t_want


def kmeans_trace(emb, n_clusters: int = 2, n_iter: int = 10):
    """kmeans_tf_bins's Lloyd steps (separators.lloyd_step) on bin
    embeddings (B, N, D), each step's labels and the gap of each bin's two
    nearest centers over the nearer one's distance -> (labels, gaps), each
    (n_iter + 1, B, N) numpy on the host, the last step's labels
    kmeans_tf_bins's, and its centers (B, K, D)."""
    import numpy as np
    import torch

    from espnet_tpu_torch.models.enh.separators import lloyd_step
    centers = emb[:, :n_clusters]
    labels, gaps = [], []
    for step in range(n_iter + 1):
        d, new = lloyd_step(emb, centers)
        two = torch.topk(d, 2, dim=-1, largest=False).values
        labels.append(d.argmin(-1).to(torch.uint8).cpu().numpy())
        gaps.append(((two[..., 1] - two[..., 0])
                     / two[..., 0].abs().clamp(min=1e-30)).cpu().numpy())
        if step < n_iter:
            centers = new
    return np.stack(labels), np.stack(gaps), centers


def trace_agreement(ours, theirs, gaps) -> dict:
    """Two k-means traces (kmeans_trace's labels) against each other, the
    reference's gaps beside them: the final labels' equal share, and for
    each mixture the first Lloyd step whose labels differ, where every
    difference must lie at a near-tie of the reference's distances (the
    centers up to there differ only by rounding); later steps' and the
    final differences are downstream of those."""
    import numpy as np
    differ = ours != theirs                       # (S, B, N)
    final = differ[-1]
    first_gaps, diverged = [], []
    for b in range(differ.shape[1]):
        steps = np.nonzero(differ[:, b].any(-1))[0]
        if len(steps):
            s0 = steps[0]
            first_gaps.extend(gaps[s0, b][differ[s0, b]].tolist())
            diverged.append([int(b), int(s0), int(final[b].sum())])
    ok_ties = bool(np.all(np.asarray(first_gaps) <= NEAR_TIE_REL))
    share = float(1 - final.mean())
    return {"n_bins": int(final.size), "n_differ": int(final.sum()),
            "equal_share": share,
            "mixtures_diverged": diverged,
            "rows": "[mixture, first Lloyd step that differs, final bins "
                    "that differ]",
            "first_step_flips": len(first_gaps),
            "first_step_largest_gaps": sorted(first_gaps)[-10:],
            "near_tie_tol": NEAR_TIE_REL,
            "first_steps_at_near_ties": ok_ties,
            "ok": bool(share >= LABELS_EQUAL_MIN and ok_ties)}


def separator_phases(torch, _cuda, workdir: Path, smi: str) -> dict:
    """Phases 36-38: the single-channel STFT separators, each at its JAX
    class's width from seed_flat's weights, separating the 50 test
    mixtures on the card; then the Conformer, TF-GridNet and DPCL
    training runs. -> the launches of the Conformer separator's path per
    decode batch and per train step."""
    import numpy as np

    from espnet_tpu_torch.bin import enh_train
    from espnet_tpu_torch.bin.enh_inference import SeparateSpeech
    from espnet_tpu_torch.data.synth_speech import SynthMixCorpus
    from espnet_tpu_torch.models.enh.model import EnhancementModel
    from espnet_tpu_torch.ops.stft import istft, stft
    from espnet_tpu_torch.tasks.enh import EnhancementTask
    from espnet_tpu_torch.train.checkpoint import load_checkpoint

    ref = json.loads(SEP_REFERENCE.read_text(encoding="utf-8"))
    corpus = SynthMixCorpus()
    mixtures = [corpus.mixture("test", i) for i in range(N_MIX)]
    mixes = np.stack([m for m, _, _ in mixtures])
    refs = [[r1, r2] for _, r1, r2 in mixtures]
    energy = [float(np.sum(np.square(m, dtype=np.float64))) for m in mixes]
    if not max(abs(a / b - 1) for a, b in zip(energy, ref["mix_energy"])) \
            <= 1e-6:
        raise AssertionError("the test mixtures differ from the JAX "
                             "reference's")
    none = {n: 0 for n in _cuda.LAUNCHES}
    paths = {"decode": {}, "train_step": {}}

    # 36. each separator through SeparateSpeech on the card, batches of
    # 10: a warm-up batch, then the 50 mixtures counted and timed; the
    # first SEP_CPU_MIX mixtures on the CPU; the estimates against the
    # JAX package's (scripts/jax_enh_separators_reference.json)
    def separated(ss, n):
        """(2, n, S): the first n mixtures through ss, batches of 10."""
        return np.concatenate([np.stack(ss(mixes[b:min(b + SEP_BATCH, n)]))
                               for b in range(0, n, SEP_BATCH)], axis=1)

    for name, sep, conf in SEPARATOR_CASES:
        cfg_path, weights = seed_model_dir(workdir, name, sep, conf)
        jref = ref["separators"][name]
        clustering = name in CLUSTERING
        embeds = {"cuda": [], "cpu": []}
        models = {}
        for dev in embeds:
            models[dev] = SeparateSpeech(cfg_path, weights, fs=16000,
                                         device=dev)
            if clustering:
                models[dev].model.separator_mod.embed.register_forward_hook(
                    lambda m, a, out, dev=dev: embeds[dev].append(
                        torch.tanh(out)))
        emb_D = getattr(models["cpu"].model.separator_mod, "emb_D", None)
        models["cuda"](mixes[:SEP_BATCH])
        embeds["cuda"].clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        card = separated(models["cuda"], N_MIX)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        # on the CPU the first 2 mixtures; the clustering cases' k-means
        # traces on 10: one that diverges moves a whole bin, or a DAN
        # attractor
        cpu = separated(models["cpu"], min(
            SEP_CPU_CLUSTER_MIX if clustering else SEP_CPU_MIX, N_MIX))
        del models
        card_emb, cpu_emb = embeds["cuda"], embeds["cpu"]
        n_cpu = cpu.shape[1]
        peaks = unpack(jref["peak"])[:, :N_MIX]
        jslice = unpack(jref["slice"])[:, :N_MIX]
        sl = card[:, :, SLICE_AT:SLICE_AT + SLICE_LEN]
        slice_err = np.abs(sl - jslice).max(-1) / peaks      # (2, N_MIX)
        row = {"separator": sep, "separator_conf": conf,
               "shape": list(card.shape), "finite": bool(
                   np.isfinite(card).all()),
               "pit_si_snr_mean": float(np.mean([
                   pit_si_snr([e[i] for e in card], refs[i])
                   for i in range(N_MIX)])),
               "jax_pit_si_snr_mean": float(np.mean(jref["pit_si_snr"])),
               "separated_audio_s_per_s": N_MIX * 4.0 / wall,
               "wall_seconds": wall, "peak_memory_bytes": peak,
               "launches": launches, "tol": SEP_TOL}
        # the estimates held against JAX's slices: a clustering case's
        # own where its labels agree with JAX's as far as the JSON shows
        # them, and every mixture's as below
        held = np.ones(N_MIX, bool)
        gated_err = slice_err
        if clustering:
            T_ = card_emb[0].shape[1]
            c_emb = torch.cat(card_emb).reshape(N_MIX, -1, emb_D)
            c_labs, _, c_centers = kmeans_trace(c_emb)
            p_emb = torch.cat(cpu_emb).reshape(n_cpu, -1, emb_D)
            p_labs, p_gaps, _ = kmeans_trace(p_emb)
            c_lab = c_labs[-1]
            n_bins = c_lab.shape[1]
            F_ = n_bins // T_
            jlab = np.unpackbits(unpack(jref["labels"]["first"]), axis=-1,
                                 count=n_bins)
            jemb = unpack(jref["embed_frames"])
            cemb = c_emb.reshape(N_MIX, T_, -1)[
                0, EMBED_FRAMES[0]:EMBED_FRAMES[1]].cpu().numpy()
            lo, hi = (f * F_ for f in SLICE_FRAMES)
            jframes = np.unpackbits(unpack(jref["labels"]["slice_frames"]),
                                    axis=-1, count=hi - lo)[:N_MIX]
            jones = np.asarray(jref["labels"]["ones_per_mixture"][:N_MIX])
            ones = c_lab.sum(-1)
            frames_equal = float((c_lab[:, lo:hi] == jframes).mean())
            x = torch.from_numpy(mixes)
            real, imag, _ = stft(x, None, n_fft=512, hop_length=128)
            if sep == "dpcl":
                # a DPCL estimate is the mixture under a hard mask: where
                # the card's labels under the slice differ from JAX's (a
                # k-means trace that diverged at a near-tie moves whole
                # bins), the card's estimate plus the iSTFT of those bins
                # moved to JAX's side
                held = (c_lab[:, lo:hi] == jframes).all(-1)
                delta = torch.zeros(N_MIX, n_bins)
                fixed = sl.copy()
                for s_ in range(2):
                    delta[:, lo:hi] = torch.from_numpy(
                        (jframes == s_).astype(np.float32)
                        - (c_lab[:, lo:hi] == s_))
                    d_ = delta.reshape(real.shape)
                    fixed[s_] += istft(real * d_, imag * d_, n_fft=512,
                                       hop_length=128, length=x.shape[1]
                                       )[:, SLICE_AT:SLICE_AT + SLICE_LEN
                                         ].numpy()
            else:
                # a DAN estimate is the mixture under the softmax of its
                # embeddings against the attractors, k-means centers, which
                # a trace that diverged moves: the card's embeddings
                # against JAX's attractors, every mixture
                held = ones == jones
                held[:N_LABEL_MIX] &= (c_lab[:N_LABEL_MIX] == jlab).all(-1)
                jatt = torch.from_numpy(unpack(jref["centers"])[:N_MIX]
                                        ).cuda().transpose(1, 2)
                m = torch.softmax(c_emb @ jatt, dim=-1).reshape(
                    *real.shape, 2).cpu()
                fixed = np.stack([istft(real * m[..., s_], imag * m[..., s_],
                                        n_fft=512, hop_length=128,
                                        length=x.shape[1])[
                    :, SLICE_AT:SLICE_AT + SLICE_LEN].numpy()
                    for s_ in range(2)])
                del m, jatt
            fixed_err = np.abs(fixed - jslice).max(-1) / peaks
            gated_err = np.maximum(fixed_err, np.where(held, slice_err, 0.0))
            row["slice_rel_err_with_jax_labels"] = float(fixed_err.max())
            jequal = float((c_lab[:N_LABEL_MIX] == jlab).mean())
            row["labels"] = {
                "card_vs_cpu": trace_agreement(c_labs[:, :n_cpu], p_labs,
                                               p_gaps),
                "card_vs_jax_first_mixtures": {
                    "n_bins": int(jlab.size), "equal_share": jequal,
                    "ok": jequal >= LABELS_EQUAL_MIN},
                "card_vs_jax_slice_frames": {
                    "n_bins": int(jframes.size),
                    "equal_share": frames_equal,
                    "ok": frames_equal >= LABELS_EQUAL_MIN},
                "sha256_equal_jax": hashlib.sha256(c_lab.astype(
                    np.uint8).tobytes()).hexdigest()
                == jref["labels"]["sha256"],
                "mixtures_ones_differ_from_jax": {
                    int(i): int(ones[i] - jones[i])
                    for i in np.nonzero(ones != jones)[0]}}
            row["embed_rel_err_from_jax"] = float(
                np.abs(cemb - jemb).max() / np.abs(jemb).max())
            # on the CPU, the estimates from the card's labels (DPCL) or
            # attractors (DAN)
            real, imag = real[:n_cpu], imag[:n_cpu]
            if sep == "dpcl":
                lab = torch.from_numpy(c_lab[:n_cpu].astype(np.int64)
                                       ).reshape(real.shape)
                masks = [(lab == s_).to(real.dtype) for s_ in range(2)]
            else:
                att = c_centers[:n_cpu].cpu().transpose(1, 2)
                m = torch.softmax(p_emb @ att, dim=-1).reshape(
                    *real.shape, 2)
                masks = [m[..., s_] for s_ in range(2)]
            cpu = np.stack([istft(real * mk, imag * mk, n_fft=512,
                                  hop_length=128, length=x.shape[1]).numpy()
                            for mk in masks])
            del c_emb
        cpu_err = float(max(np.abs(card[s, i] - cpu[s, i]).max()
                            / np.abs(cpu[s, i]).max()
                            for s in range(2) for i in range(n_cpu)))
        row["card_vs_cpu_rel_err"] = cpu_err
        row["mixtures_against_cpu"] = n_cpu
        row["slice_rel_err_from_jax"] = float(gated_err.max())
        row["mixtures_held_against_jax"] = int(held.sum())
        row["slice_rel_err_unheld"] = {int(i): float(slice_err[:, i].max())
                                       for i in np.nonzero(~held)[0]}
        emit({"phase": "enh_separators", "name": name, **row})
        want = (dict(none, flash_attn_fwd=2 * (N_MIX // SEP_BATCH))
                if sep == "conformer" else none)
        if not (row["finite"] and launches == want):
            raise AssertionError(f"{name}: finite {row['finite']}, launches "
                                 f"{launches}, not {want}")
        if not (cpu_err <= SEP_TOL and row["slice_rel_err_from_jax"]
                <= SEP_TOL):
            raise AssertionError(f"{name}: card against CPU {cpu_err}, "
                                 f"against JAX "
                                 f"{row['slice_rel_err_from_jax']}")
        if clustering and not (
                row["labels"]["card_vs_cpu"]["ok"]
                and row["labels"]["card_vs_jax_first_mixtures"]["ok"]
                and row["labels"]["card_vs_jax_slice_frames"]["ok"]
                and row["embed_rel_err_from_jax"] <= SEP_TOL):
            raise AssertionError(f"{name}: labels {row['labels']}, embedding "
                                 f"{row['embed_rel_err_from_jax']}")
        if sep == "conformer":
            paths["decode"]["enh_conformer"] = {
                n: v // (N_MIX // SEP_BATCH) for n, v in launches.items()}

    # 37-38. training from seed_flat's weights over phase 21's data: the
    # Conformer (K1, K1b), TF-GridNet and DPCL with the affinity loss;
    # each run twice to the same bits, and one backward card against CPU
    valid_if = None
    for sep, (n_steps, loss_type, n_grad) in SEP_TRAIN.items():
        name, conf = sep, {}
        model_cfg, weights = seed_model_dir(workdir, f"{name}_train", sep,
                                            conf, loss_type=loss_type)

        def make(run_name, **kw):
            return enh_config(workdir, f"sep_{name}_{run_name}",
                              separator=sep, separator_conf=conf,
                              loss_type=loss_type, init_param=str(weights),
                              num_iters_per_epoch=n_steps, **kw)

        cfg, cfg_path = make("a")
        if valid_if is None:
            valid_if = EnhancementTask.build_iter_factory(cfg, train=False)
        trainer, per_step, launches, wall, peak = train_run(
            torch, _cuda, enh_train.main, cfg_path, EnhancementModel)
        steps = trainer.step_stats
        want = (dict(none, flash_attn_fwd=2, flash_attn_bwd=4)
                if sep == "conformer" else none)
        keys = ("loss",) if loss_type == "dpcl" else ("loss", "si_snr")
        check_steps(steps, per_step, want, keys, n_steps=n_steps)
        _, again_path = make("b")
        enh_train.main(["--config", str(again_path)])
        first = load_checkpoint(Path(cfg["output_dir"]) / "checkpoint")[0]
        again = load_checkpoint(workdir / f"sep_{name}_b" / "checkpoint")[0]
        differ = sorted(k for k in first if not np.array_equal(first[k],
                                                               again[k]))
        gcheck = None
        if n_grad:
            _, gbatch = valid_if.collate_fn([valid_if.dataset[k] for k in
                                             valid_if.epoch_batches(0)[0]
                                             [:n_grad]])
            gcheck = grad_check(torch, EnhancementTask, model_cfg, weights,
                                gbatch)
        step_ms = [1e3 * s["train_time"] for s in steps]
        emit({"phase": "enh_separator_train", "name": name,
              "loss_type": loss_type, "batch_size": ENH_TRAIN_BATCH,
              "steps": [{k: s[k] for k in keys + ("grad_norm", "skipped")}
                        | {"ms": ms, "launches": n}
                        for s, ms, n in zip(steps, step_ms, per_step)],
              "step_ms_median": statistics.median(step_ms[1:] or step_ms),
              "peak_memory_bytes": peak, "wall_seconds": wall,
              "launches": launches,
              "valid_after": trainer.reporter.stats[1]["valid"],
              "rerun_n_differ": len(differ), "rerun_differs": differ[:5],
              "grad_check": gcheck, "nvidia_smi": smi})
        if differ:
            raise AssertionError(f"{name}: a second {n_steps}-step run "
                                 f"differs in {len(differ)} parameters, "
                                 f"e.g. {differ[:3]}")
        if sep == "conformer":
            paths["train_step"]["enh_conformer"] = per_step[0]
    return paths


def lm_sentences(corpus, n: int = N_VALID_LM):
    """[(key, sentence)]: the LM recipe's stage-1 draw of its valid set
    (egs/synth_asr/lm1/run.py), text only."""
    out = []
    for i in range(n):
        rng = corpus._rng_for("lmtext-valid", i)
        n_w = rng.randint(corpus.min_words, corpus.max_words + 1)
        widx = rng.choice(len(corpus.words), size=n_w, p=corpus.word_p)
        out.append((f"valid_{i:06d}",
                    " ".join(corpus.words[j] for j in widx)))
    return out


def write_text(path: Path, rows):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(f"{k} {t}\n" for k, t in rows),
                    encoding="utf-8")


def decode_batch(corpus, bucket_length, n: int = N_UTTS):
    """The LM recipe's stage-4 batch: the first n test utterances padded
    to their length bucket (base 4096, x1.3) -> (speech, lengths, refs)."""
    import numpy as np
    utts = [corpus.utterance("test", i) for i in range(n)]
    L = bucket_length(max(len(u[0]) for u in utts), base=4096, growth=1.3)
    speech = np.zeros((n, L), np.float32)
    lens = np.zeros((n,), np.int32)
    for j, (w, _, _) in enumerate(utts):
        speech[j, :len(w)] = w
        lens[j] = len(w)
    return speech, lens, [u[1] for u in utts]


def tts_keys(corpus):
    """The VITS recipe's round-trip texts: the first 50 sorted keys of its
    speaker-0 corpus's 60 valid utterances, drawn without their waves."""
    texts = {f"valid_{i:05d}": corpus.transcript("valid", i, [0])[0]
             for i in range(N_VALID_TTS)}
    keys = sorted(texts)[:N_EVAL_TTS]
    return keys, [texts[k] for k in keys]


def tts_noise(i: int):
    """z_p's standard normal draw for the i-th text, (1, 640, 192)."""
    import numpy as np
    return np.random.RandomState(NOISE_SEED + i).randn(
        1, MAX_FRAMES, 192).astype(np.float32)


def padded_ids(ids):
    import numpy as np
    t = np.zeros((1, TEXT_PAD), np.int64)
    t[0, :len(ids)] = ids
    return t


def wave_batch(wav, bucket_length):
    """One synthesized wave padded to its length bucket (base 4096, x1.3),
    as the VITS recipe transcribes it -> (speech (1, L), lengths)."""
    import numpy as np
    Lb = bucket_length(max(len(wav), 4096), base=4096, growth=1.3)
    return np.pad(wav, (0, Lb - len(wav)))[None], np.asarray([len(wav)])


class TimedLM:
    """An LM scorer that times each of its steps on the card (CUDA events),
    and the beam steps between them."""

    def __init__(self, torch, lm):
        self.torch, self.lm, self.events = torch, lm, []

    def init_carry(self, *args, **kwargs):
        return self.lm.init_carry(*args, **kwargs)

    def score_step(self, token, step, state):
        start = self.torch.cuda.Event(enable_timing=True)
        end = self.torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.lm.score_step(token, step, state)
        end.record()
        self.events.append((start, end))
        return out

    def select_state(self, state, idx):
        return self.lm.select_state(state, idx)

    def share(self) -> dict:
        """LM ms per step, beam-step ms (one LM start to the next), and the
        LM's share of the beam steps."""
        self.torch.cuda.synchronize()
        lm_ms = [s.elapsed_time(e) for s, e in self.events]
        step_ms = [a.elapsed_time(b) for (a, _), (b, _) in
                   zip(self.events, self.events[1:])]
        return {"steps": len(lm_ms),
                "lm_step_ms_median": statistics.median(lm_ms),
                "beam_step_ms_median": statistics.median(step_ms),
                "lm_share_of_beam_steps": sum(lm_ms[:-1]) / sum(step_ms)}


def lm_tts_phases(torch, _cuda, workdir: Path, smi: str):
    """Phases 24-26: the LM's perplexity, the flagship with the LM fused,
    and the VITS -> ASR round trip. -> the launches per decode of the
    fused decode and of the round trip's ASR leg."""
    import numpy as np

    from espnet_tpu_torch.bin import tts_inference
    from espnet_tpu_torch.bin.asr_inference import Speech2Text
    from espnet_tpu_torch.bin.lm_calc_perplexity import calc_perplexity
    from espnet_tpu_torch.data.batching import bucket_length
    from espnet_tpu_torch.data.fileio import SoundScpReader, SoundScpWriter
    from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
    from espnet_tpu_torch.models.tts.fastspeech2 import length_regulator
    from espnet_tpu_torch.tasks.gan_tts import GANTTSTask
    from espnet_tpu_torch.tasks.lm import LMTask
    from espnet_tpu_torch.utils.masks import make_non_pad_mask
    from espnet_tpu_torch.utils.scoring import score_corpus

    ref = json.loads(TTS_LM_REFERENCE.read_text(encoding="utf-8"))
    corpus = SynthSpeechCorpus()

    # 24. perplexity of the 300 valid sentences, batch 64, and one batch's
    # nll on the card against the CPU
    text_file = workdir / "lm" / "valid" / "text"
    sentences = lm_sentences(corpus)
    write_text(text_file, sentences)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ppl = calc_perplexity(train_config=str(LM / "config.yaml"),
                          model_file=str(LM),
                          data_path_and_name_and_type=[
                              f"{text_file},text,text"],
                          batch_size=PPL_BATCH)
    torch.cuda.synchronize()
    ppl_s = time.perf_counter() - t0
    nll = {}
    pre = LMTask.build_preprocess_fn({"token_list": str(LM / "tokens.txt")},
                                     train=False)
    ids = [pre(k, {"text": t})["text"] for k, t in sentences[:PPL_BATCH]]
    text = np.zeros((len(ids), max(map(len, ids))), np.int64)
    for i, x in enumerate(ids):
        text[i, :len(x)] = x
    lens = np.asarray([len(x) for x in ids])
    for dev in ("cuda", "cpu"):
        lm, _ = LMTask.build_model_from_file(LM / "config.yaml", LM, dev)
        with torch.no_grad():
            nll[dev] = lm.nll(torch.from_numpy(text).to(dev),
                              torch.from_numpy(lens).to(dev))[0].cpu()
    nll_err = rel_err(nll["cuda"], nll["cpu"])
    jax_ppl = ref["lm_perplexity"]["ppl"]
    n_tok = int(lens.sum() + len(lens))
    emit({"phase": "lm_perplexity", "asset": LM.name,
          "n_sentences": len(sentences), "batch_size": PPL_BATCH,
          "perplexity": ppl, "jax_fp32": jax_ppl,
          "rel_diff": abs(ppl / jax_ppl - 1), "rel_tol": PPL_REL_TOL,
          "asset_results_json": ref["lm_perplexity"]["asset_results_json"],
          "nll_card_vs_cpu_rel": nll_err, "nll_tol": LM_NLL_TOL,
          "wall_seconds": ppl_s, "first_batch_tokens": n_tok,
          "nvidia_smi": smi})
    if not abs(ppl / jax_ppl - 1) <= PPL_REL_TOL:
        raise AssertionError(f"perplexity {ppl} against the JAX package's "
                             f"{jax_ppl}")
    if not nll_err <= LM_NLL_TOL:
        raise AssertionError(f"LM nll, card against CPU: {nll_err}")

    # 25. the flagship on the LM recipe's stage-4 batch, beam 10, CTC 0.3,
    # without the LM and with it at 0.3
    speech_np, lens_np, refs = decode_batch(corpus, bucket_length)
    speech = torch.from_numpy(speech_np).cuda()
    lengths = torch.from_numpy(lens_np).long().cuda()
    audio_s = float(lens_np.sum()) / 16000
    fused = {}
    lm_launches = None
    for lw in (0.0, LM_WEIGHT):
        s2t = Speech2Text(
            asr_train_config=ASSET / "config.yaml", asr_model_file=ASSET,
            beam_size=BEAM, ctc_weight=CTC_WEIGHT,
            lm_train_config=(LM / "config.yaml") if lw else None,
            lm_file=LM if lw else None, lm_weight=lw)
        s2t(speech, lengths)
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        out = s2t(speech, lengths)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        ids = [list(map(int, n[0][2])) for n in out]
        want = ref["lm_fused_decode"][f"lm_weight_{lw}"]
        entry = wer_cer(score_corpus, refs, [n[0][0] for n in out]) | {
            "jax_fp32": {k: want[k] for k in ("wer", "cer", "word_errors",
                                              "ref_words")},
            "wer_limit": want["wer"] + LM_WER_MARGIN,
            "ids_equal_jax": sum(a == b for a, b in zip(ids, want["ids"])),
            "ids_differ": [[u, ids[u], want["ids"][u]]
                           for u in range(len(ids))
                           if ids[u] != want["ids"][u]],
            "wall_seconds": wall, "audio_s_per_s": audio_s / wall,
            "launches": launches}
        if lw:
            lm_launches = launches
            timed = TimedLM(torch, s2t.lm)
            s2t.lm = timed
            s2t(speech, lengths)
            entry["lm_step_timing"] = timed.share()
        fused[f"lm_weight_{lw}"] = entry
        if not entry["wer"] <= entry["wer_limit"]:
            raise AssertionError(f"LM weight {lw}: WER {entry['wer']} above "
                                 f"{entry['wer_limit']}")
        if not (launches["flash_attn_fwd"] > 0 and launches["logmel_fwd"] > 0):
            raise AssertionError(f"LM weight {lw}: launches {launches}")
        del s2t
    emit({"phase": "lm_fused_decode", "assets": [ASSET.name, LM.name],
          "n_utts": N_UTTS, "beam": BEAM, "ctc_weight": CTC_WEIGHT,
          "batch_shape": list(speech.shape), "audio_seconds": audio_s}
         | fused | {"nvidia_smi": smi})

    # 26. VITS -> ASR: the recipe's 50 texts at max_frames 640, text padded
    # to 64, z_p's noise from numpy, each wave transcribed alone
    keys, texts = tts_keys(corpus)
    tref = ref["tts_vits"]
    if keys != tref["keys"] or texts != tref["texts"]:
        raise AssertionError("the round trip's keys or texts differ from "
                             "the JAX recipe's")
    model, cfg = GANTTSTask.build_model_from_file(TTS / "config.yaml", TTS)
    hop = cfg["hop_length"]
    pre = GANTTSTask.build_preprocess_fn(cfg, train=False)
    text_ids = [pre(k, {"text": t, "speech": np.zeros(512, np.float32)})
                ["text"] for k, t in zip(keys, texts)]
    s2t = Speech2Text(asr_train_config=ASSET / "config.yaml",
                      asr_model_file=ASSET, beam_size=BEAM,
                      ctc_weight=CTC_WEIGHT)

    def synthesize(m, i, ns, dev):
        t = torch.from_numpy(padded_ids(text_ids[i])).to(dev)
        tl = torch.tensor([len(text_ids[i])], device=dev)
        with torch.no_grad():
            dur = m.generator.prior_and_durations(t, tl)[2]
            wav, olens = m.decode(t, tl, noise=torch.from_numpy(
                tts_noise(i)).to(dev), noise_scale=ns,
                max_frames=MAX_FRAMES)
        return wav[0, :int(olens[0]) * hop], dur[0, :len(text_ids[i])]

    synthesize(model, 0, NOISE_SCALES[0], "cuda")     # warm-up
    round_trip = {}
    waves = {}
    tts_launches = None
    for ns in NOISE_SCALES:
        want = tref[f"ns_{ns}"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        synth_s, durs, frames = 0.0, [], []
        for i in range(len(keys)):
            t0 = time.perf_counter()
            wav, dur = synthesize(model, i, ns, "cuda")
            torch.cuda.synchronize()
            synth_s += time.perf_counter() - t0
            waves[ns, i] = wav
            durs.append(dur.tolist())
            frames.append(len(wav) // hop)
        peak = torch.cuda.max_memory_allocated()
        synth_audio = sum(frames) * hop / cfg["fs"]
        s2t(*wave_batch(waves[ns, 0].cpu().numpy(), bucket_length))
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        outs = [s2t(*wave_batch(waves[ns, i].cpu().numpy(), bucket_length))
                for i in range(len(keys))]
        torch.cuda.synchronize()
        asr_s = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        ids = [list(map(int, o[0][0][2])) for o in outs]
        same_dur = [u for u in range(len(keys)) if durs[u] ==
                    want["durations"][u]]
        entry = wer_cer(score_corpus, texts, [o[0][0][0] for o in outs]) | {
            "jax_fp32": {k: want[k] for k in ("wer", "cer", "word_errors",
                                              "ref_words")},
            "durations_equal_jax": len(same_dur),
            "durations_differ": [[u, durs[u], want["durations"][u]]
                                 for u in range(len(keys))
                                 if u not in same_dur],
            "frames_equal_jax": sum(a == b for a, b in
                                    zip(frames, want["frames"])),
            "ids_equal_jax": sum(a == b for a, b in zip(ids, want["ids"])),
            "synth_seconds": synth_s, "synth_audio_seconds": synth_audio,
            "synth_audio_s_per_s": synth_audio / synth_s,
            "synth_peak_memory_bytes": peak,
            "asr_seconds": asr_s, "asr_launches": launches,
            "asr_launches_per_decode": {k: v / len(keys)
                                        for k, v in launches.items()}}
        if ns == NOISE_SCALES[0]:
            entry["wer_limit"] = want["wer"] + TTS_WER_MARGIN
            tts_launches = {k: v // len(keys) for k, v in launches.items()}
            if not entry["wer"] <= entry["wer_limit"]:
                raise AssertionError(f"round-trip WER {entry['wer']} above "
                                     f"{entry['wer_limit']}")
            if launches != {k: v * len(keys)
                            for k, v in tts_launches.items()} or not (
                    tts_launches["flash_attn_fwd"] > 0
                    and tts_launches["logmel_fwd"] > 0):
                raise AssertionError(f"round-trip ASR launches {launches}")
        round_trip[f"ns_{ns}"] = entry
        if ns == NOISE_SCALES[0]:
            first_durs = durs

    # the card against the CPU on the first texts whose durations agree;
    # the same bits twice; the flow's forward after its inverse
    cpu_model, _ = GANTTSTask.build_model_from_file(TTS / "config.yaml",
                                                    TTS, "cpu")
    ns = NOISE_SCALES[0]
    wave_err, compared = 0.0, 0
    for i in range(TTS_CPU_UTTS):
        wav, dur = synthesize(cpu_model, i, ns, "cpu")
        if dur.tolist() != first_durs[i]:
            continue
        compared += 1
        wave_err = max(wave_err, rel_err(waves[ns, i].cpu(), wav))
    again, _ = synthesize(model, 0, ns, "cuda")
    same_bits = bool(torch.equal(again, waves[ns, 0]))
    t = torch.from_numpy(padded_ids(text_ids[0])).cuda()
    tl = torch.tensor([len(text_ids[0])], device="cuda")
    gen = model.generator
    with torch.no_grad():
        m_p, logs_p, dur = gen.prior_and_durations(t, tl)
        m_f, total = length_regulator(m_p, dur, MAX_FRAMES)
        s_f, _ = length_regulator(logs_p, dur, MAX_FRAMES)
        mask = make_non_pad_mask(total.clamp(max=MAX_FRAMES), MAX_FRAMES)
        z_p = (m_f + torch.exp(s_f) * ns * torch.from_numpy(
            tts_noise(0)).cuda()) * mask[..., None]
        z_back = gen.flow(gen.flow(z_p, mask, reverse=True), mask)
    flow_err = rel_err(z_back, z_p)

    # Text2Speech with its own torch.Generator at 0.333 over the 50 texts,
    # transcribed as above (not gated: its noise is not the JAX run's)
    t2s = tts_inference.Text2Speech(train_config=TTS / "config.yaml",
                                    model_file=TTS, noise_scale=ns)
    hyps = [s2t(*wave_batch(t2s(text, out_len=MAX_FRAMES)["wav"],
                            bucket_length))[0][0][0] for text in texts]
    own = wer_cer(score_corpus, texts, hyps)

    # the CLI on 4 texts: its wavs equal the API's, written alike
    cli_text = workdir / "tts" / "text"
    write_text(cli_text, list(zip(keys, texts))[:N_CLI_TTS])
    tts_inference.main(["--output_dir", str(workdir / "tts" / "cli"),
                        "--data_path_and_name_and_type",
                        f"{cli_text},text,text",
                        "--train_config", str(TTS / "config.yaml"),
                        "--model_file", str(TTS)])
    api = tts_inference.Text2Speech(train_config=TTS / "config.yaml",
                                    model_file=TTS)
    with SoundScpWriter(workdir / "tts" / "api", workdir / "tts" /
                        "api.scp") as w:
        for k, text in zip(keys[:N_CLI_TTS], texts[:N_CLI_TTS]):
            w[k] = (api.fs, api(text)["wav"])
    cli = SoundScpReader(workdir / "tts" / "cli" / "wav.scp")
    api_r = SoundScpReader(workdir / "tts" / "api.scp")
    cli_equal = (list(cli.keys()) == keys[:N_CLI_TTS] and all(
        np.array_equal(cli[k][1], api_r[k][1]) for k in keys[:N_CLI_TTS]))
    emit({"phase": "tts_vits", "assets": [TTS.name, ASSET.name],
          "n_texts": len(keys), "max_frames": MAX_FRAMES,
          "text_pad": TEXT_PAD, "noise": f"RandomState({NOISE_SEED} + i)",
          "keys_and_texts_equal_jax_recipe": True}
         | round_trip | {
          "wave_card_vs_cpu_rel": wave_err, "wave_tol": TTS_WAVE_TOL,
          "wave_compared_texts": compared, "same_bits_twice": same_bits,
          "flow_round_trip_rel": flow_err, "flow_tol": FLOW_TOL,
          "text2speech_own_generator_ns_0.333": own,
          "asset_results_json_wer_ns_0.333":
              tref["asset_results_json"]["wer_ns0.333"],
          "cli_wavs_equal_api": cli_equal, "nvidia_smi": smi})
    if not (compared > 0 and wave_err <= TTS_WAVE_TOL):
        raise AssertionError(f"VITS card against CPU: {wave_err} over "
                             f"{compared} texts")
    if not (same_bits and cli_equal):
        raise AssertionError(f"VITS: same bits twice {same_bits}, CLI "
                             f"equal to the API {cli_equal}")
    if not flow_err <= FLOW_TOL:
        raise AssertionError(f"flow round trip {flow_err}")
    return lm_launches, tts_launches


class GANStepTimer:
    """Wraps train/gan_trainer.py's step factories: each train step's
    launches (the counts before and after it), its host ms (synchronised
    on both sides), and each valid batch's launches; and VITS.align, whose
    CUDA events give the alignment searches' ms in each train step."""

    def __init__(self, torch, _cuda):
        from espnet_tpu_torch.models.tts import vits
        from espnet_tpu_torch.train import gan_trainer
        self.torch, self._cuda = torch, _cuda
        self.steps, self.valid, self.mas = [], [], []
        self.in_step = False
        self.modules = {"gan_trainer": gan_trainer, "vits": vits}
        self.saved = (gan_trainer.make_gan_train_step,
                      gan_trainer.make_gan_eval_step, vits.VITS.align)

    def __enter__(self):
        torch, _cuda = self.torch, self._cuda
        gt, vits = self.modules["gan_trainer"], self.modules["vits"]
        make_train, make_eval, align = self.saved

        def timed_train(*args, **kwargs):
            step = make_train(*args, **kwargs)

            def run(*a, **kw):
                torch.cuda.synchronize()
                before = dict(_cuda.LAUNCHES)
                self.mas.append([])
                self.in_step = True
                t0 = time.perf_counter()
                out = step(*a, **kw)
                torch.cuda.synchronize()
                self.in_step = False
                ms = (time.perf_counter() - t0) * 1e3
                self.steps.append({
                    "ms": ms, "launches": {n: _cuda.LAUNCHES[n] - before[n]
                                           for n in before}})
                return out
            return run

        def timed_eval(*args, **kwargs):
            step = make_eval(*args, **kwargs)

            def run(*a, **kw):
                before = dict(_cuda.LAUNCHES)
                out = step(*a, **kw)
                self.valid.append({n: _cuda.LAUNCHES[n] - before[n]
                                   for n in before})
                return out
            return run

        def timed_align(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = align(*args)
            end.record()
            if self.in_step:
                self.mas[-1].append((start, end))
            return out

        gt.make_gan_train_step, gt.make_gan_eval_step = (timed_train,
                                                         timed_eval)
        vits.VITS.align = staticmethod(timed_align)
        return self

    def __exit__(self, *exc):
        gt, vits = self.modules["gan_trainer"], self.modules["vits"]
        gt.make_gan_train_step, gt.make_gan_eval_step, align = self.saved
        vits.VITS.align = staticmethod(align)

    def mas_ms(self):
        """The alignment searches' device ms in each step."""
        self.torch.cuda.synchronize()
        return [sum(a.elapsed_time(b) for a, b in ev) for ev in self.mas]


def gan_train_run(torch, _cuda, entry_main, cfg_path: Path):
    """Train a GAN through its entry point with the launch counts at 0
    first -> (the trainer, the timer, wall seconds, peak device bytes)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    with GANStepTimer(torch, _cuda) as timer:
        _, trainer = entry_main(["--config", str(cfg_path)])
    torch.cuda.synchronize()
    return (trainer, timer, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated())


def no_dropout(model):
    """Every dropout of ``model`` at 0: training mode with the JAX
    reference's deterministic forward."""
    import torch
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


def rel_diffs(ours: dict, ref: dict) -> dict:
    """Each loss term's relative distance from the reference's."""
    return {k: abs(ours[k] / ref[k] - 1) for k in ref if k.endswith("_loss")}


def mas_margins(neg_cent, path, tl: int, fl: int) -> list:
    """Per token of one utterance, the closest call the alignment search
    made on the path through it: the smallest |advance - stay| over the
    larger of the two, at the frames the path spends on the token (fp32
    scores redone in numpy, as the search does them)."""
    import numpy as np
    v = neg_cent[:tl, :fl].astype(np.float32)
    S = v.shape[0]
    neg = np.float32(-1e9)
    prev = np.where(np.arange(S) == 0, v[:, 0], neg).astype(np.float32)
    on = path[:tl, :fl].argmax(axis=0)
    margins = [float("inf")] * tl
    for t in range(1, fl):
        adv = np.concatenate([[neg], prev[:-1]]).astype(np.float32)
        s = int(on[t])
        gap = abs(float(adv[s]) - float(prev[s])) / max(
            abs(float(adv[s])), abs(float(prev[s])), 1e-30)
        margins[s] = min(margins[s], gap)
        prev = np.where(np.arange(S) <= t, np.maximum(prev, adv) + v[:, t],
                        neg).astype(np.float32)
    return margins


def gan_grad_check(torch, make_model, batch: dict, draws: dict) -> dict:
    """grad_check for a GAN model, one backward of each turn in eval mode
    on the card and on the CPU: the turn's loss and each gradient of its
    part within GRAD_TOL of its scale (the larger of its own largest entry
    and 1e-4 of the part's largest gradient). The CPU legs take the
    card's side of every ReLU and leaky ReLU (slope 0.1) and the card's
    region of every +-7 clip of a log-scale (grad_pin.pin_kinks; a move
    above MOVE_TOL fails the check), and VITS's alignment takes the
    card's path (pin_alignment: the frames moved are reported). A float64
    leg on the CPU, pinned alike, is the reference of both fp32 legs; an
    unpinned CPU leg is reported beside them."""
    from espnet_tpu_torch import convert
    from espnet_tpu_torch.tools import grad_pin
    from espnet_tpu_torch.train.trainer import to_device
    out = {}
    for gen_turn, part in ((True, "generator"), (False, "discriminator")):
        regions, signs, paths = {}, {}, {}
        moved = {"cpu": {}, "cpu_float64": {}}
        losses, grads, seconds = {}, {}, {}
        for dev in ("card", "cpu_free", "cpu", "cpu_float64"):
            t0 = time.perf_counter()
            dev_ = "cuda" if dev == "card" else "cpu"
            m = make_model(dev_)
            if dev == "cpu_float64":
                grad_pin.to_float64(m)
            hooks = [] if dev == "cpu_free" else (
                grad_pin.pin_kinks(grad_pin.kink_modules(m), regions,
                                   moved.get(dev))
                + grad_pin.pin_relus(grad_pin.relu_inputs(m), signs,
                                     moved.get(dev))
                + grad_pin.pin_alignment(m, paths, moved.get(dev)))
            loss, _, _ = m(**to_device(batch, dev_),
                           **to_device(draws, dev_),
                           forward_generator=gen_turn)
            loss.backward()
            for h in hooks:
                h.remove()
            losses[dev] = loss.item()
            grads[dev] = convert.state_dict_to_flax(getattr(m, part),
                                                    grad=True)
            seconds[dev] = time.perf_counter() - t0
            del m, loss
        top = max(float(abs(g).max()) for g in grads["cpu"].values())
        top64 = max(float(abs(g).max())
                    for g in grads["cpu_float64"].values())

        def ratios(dev, ref, top_):
            return {n: float(abs(grads[dev][n] - g).max())
                    / max(float(abs(g).max()), 1e-4 * top_)
                    for n, g in grads[ref].items()}

        pinned = ratios("card", "cpu", top)
        free = ratios("card", "cpu_free", top)
        card64 = ratios("card", "cpu_float64", top64)
        cpu64 = ratios("cpu", "cpu_float64", top64)
        worst = max(pinned, key=pinned.get)
        far = {f"{leg}/{k}": row for leg, rows in moved.items()
               for k, row in rows.items()
               if not k.endswith(".align")
               and not row[2] <= grad_pin.MOVE_TOL}
        out[part] = {
            "loss_card": losses["card"], "loss_cpu": losses["cpu"],
            "max_grad_ratio": pinned[worst], "worst_param": worst,
            "n_params": len(pinned), "tol": GRAD_TOL,
            "n_over_tol": sum(r > GRAD_TOL for r in pinned.values()),
            "over_tol": {n: r for n, r in pinned.items() if r > GRAD_TOL},
            "pins_moved": {
                "cpu": moved["cpu"], "float64": moved["cpu_float64"],
                "rows": "{pin#call: [entries moved, largest distance to "
                        "the kink, that over the input's largest]; "
                        "align: [frames on another token, utterances]}",
                "tol": grad_pin.MOVE_TOL},
            "max_grad_ratio_unpinned": max(free.values()),
            "float64": {
                "loss": losses["cpu_float64"],
                "max_card_vs_float64": max(card64.values()),
                "max_cpu_vs_float64": max(cpu64.values()),
                "worst_param": [worst, card64[worst], cpu64[worst]],
                "card_worst5": sorted(card64.items(), key=lambda kv: -kv[1])
                [:5]},
            "seconds": seconds}
        if far:
            raise AssertionError(f"{part} turn: a pin moved entries by "
                                 f"more than rounding: {far}")
        if not pinned[worst] <= GRAD_TOL:
            raise AssertionError(f"{part} turn: card and CPU gradients "
                                 f"disagree: {worst} {pinned[worst]}; "
                                 f"{out[part]}")
        if not abs(losses["card"] / losses["cpu"] - 1) <= GRAD_TOL:
            raise AssertionError(f"{part} turn: card and CPU losses "
                                 f"disagree: {losses}")
    return out


def gan_phases(torch, _cuda, workdir: Path, smi: str):
    """Phases 27-28: VITS training and the GAN vocoder. -> the K2 launches
    of a VITS train step, of a VITS valid batch and of a vocoder train
    step, and their entry in the kernels line's paths."""
    import numpy as np

    from espnet_tpu_torch import convert
    from espnet_tpu_torch.bin import gan_tts_train, gan_vocoder_train
    from espnet_tpu_torch.bin.asr_inference import Speech2Text
    from espnet_tpu_torch.data.batching import bucket_length
    from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
    from espnet_tpu_torch.tasks.gan_tts import GANTTSTask, GANVocoderTask
    from espnet_tpu_torch.train.checkpoint import load_checkpoint
    from espnet_tpu_torch.train.gan_trainer import (GANOptimizers,
                                                    make_gan_eval_step,
                                                    make_gan_train_step)
    from espnet_tpu_torch.train.optim import build_optimizer
    from espnet_tpu_torch.train.trainer import evaluate, to_device
    from espnet_tpu_torch.utils.config import dump_yaml, resolve_config
    from espnet_tpu_torch.utils.scoring import score_corpus

    ref = json.loads(VITS_REF.read_text(encoding="utf-8"))
    vdir = workdir / "gan"
    t0 = time.perf_counter()
    SynthSpeechCorpus().materialize(vdir / "data", n_train=VITS_N_TRAIN,
                                    n_valid=VITS_N_VALID, n_test=0,
                                    speaker_ids=[0])
    data_s = time.perf_counter() - t0

    def vits_cfg(name, **extra):
        cfg = resolve_config(GANTTSTask.default_config(), overrides={
            **vits_config_dict(vdir), "output_dir": str(vdir / name),
            "max_epoch": 1, "num_iters_per_epoch": VITS_STEPS,
            "log_interval": 1, **extra})
        dump_yaml(cfg, vdir / f"{name}.yaml")
        return cfg, vdir / f"{name}.yaml"

    cfg, _ = vits_cfg("parity")

    def asset_model(dev, dropout_off=True):
        m = GANTTSTask.build_model(cfg)
        GANTTSTask.load_pretrained(m, cfg["init_param"])
        m.to(dev)
        return no_dropout(m) if dropout_off else m

    train_if = GANTTSTask.build_iter_factory(cfg, train=True)
    valid_if = GANTTSTask.build_iter_factory(cfg, train=False)

    def batch_of(keys):
        return train_if.collate_fn([train_if.dataset[k] for k in keys])[1]

    def draws_of(b, i):
        return vits_draws(i, b["spec_lengths"], b["spec"].shape[1])

    # 27. first-batch parity: the asset, dropout off, numpy draws
    keys0 = train_if.epoch_batches(1)[0]
    if list(keys0) != ref["first_batch"]["keys"]:
        raise AssertionError("the first train batch's keys differ from "
                             "the JAX reference's")
    b0 = batch_of(keys0)
    d0 = draws_of(b0, 0)
    model = asset_model("cuda")
    model.train()
    captured = {}
    own_align = model.generator.align

    def capture(neg_cent, tl, fl):
        captured["neg_cent"] = neg_cent.detach().cpu().numpy()
        return own_align(neg_cent, tl, fl)

    model.generator.align = capture
    with torch.no_grad():
        tb, td = to_device(b0, "cuda"), to_device(d0, "cuda")
        gen = model.generator(tb["text"], tb["text_lengths"], tb["spec"],
                              tb["spec_lengths"], **td)
        _, gstats, _ = model(**tb, **td, forward_generator=True)
        _, dstats, _ = model(**tb, **td, forward_generator=False)
    del model.generator.align
    first = {k: float(v) for k, v in {**gstats, **dstats}.items()}
    first_rel = rel_diffs(first, ref["first_batch"]["stats"])
    path = gen["durations"].cpu().numpy()
    durs_differ = []
    tl_np, fl_np = b0["text_lengths"], b0["spec_lengths"]
    n_tokens = int(tl_np.sum())
    for u in range(len(tl_np)):
        ours = path[u, :tl_np[u]].astype(int).tolist()
        want = ref["first_batch"]["durations"][u]
        bad = [s for s in range(len(want)) if ours[s] != want[s]]
        if bad:
            with torch.no_grad():
                p_u = model.generator.align(
                    torch.from_numpy(captured["neg_cent"][u:u + 1]),
                    torch.tensor([int(tl_np[u])]),
                    torch.tensor([int(fl_np[u])]))[0].numpy()
            margin = mas_margins(captured["neg_cent"][u], p_u,
                                 int(tl_np[u]), int(fl_np[u]))
            durs_differ += [[u, s, ours[s], want[s], margin[s]]
                            for s in bad]

    # two GAN steps from the asset, dropout off, the same draws
    model = asset_model("cuda")
    opts = GANOptimizers(*(build_optimizer(
        dict(getattr(model, part).named_parameters()), cfg[f"optim{n}"],
        grad_clip=cfg["grad_clip"], **cfg[f"optim{n}_conf"])
        for part, n in (("generator", ""), ("discriminator", "2"))))
    step = make_gan_train_step(model, opts)
    two = []
    for i, keys in enumerate(train_if.epoch_batches(1)[:2]):
        b = batch_of(keys)
        stats, _ = step(to_device(b, "cuda"),
                        draws=to_device(draws_of(b, i), "cuda"))
        two.append({"stats": stats,
                    "rel": rel_diffs(stats, ref["steps"][i])})
    del model, opts, step

    # the 60 valid utterances at the asset, dropout off, numpy draws
    model = asset_model("cuda")
    model.eval()
    sums, n_valid = {}, 0
    with torch.no_grad():
        for j, (vkeys, vb) in enumerate(valid_if.build_iter(
                1, shuffle=False)):
            vd = draws_of(vb, VALID_DRAW_OFFSET + j)
            tb, td = to_device(vb, "cuda"), to_device(vd,
                                                             "cuda")
            _, gs, _ = model(**tb, **td, forward_generator=True)
            _, ds, _ = model(**tb, **td, forward_generator=False)
            for k, v in {**gs, **ds}.items():
                sums[k] = sums.get(k, 0.0) + float(v) * len(vkeys)
            n_valid += len(vkeys)
    valid_parity = {k: v / n_valid for k, v in sums.items()}
    valid_rel = rel_diffs(valid_parity, ref["valid"])
    del model
    worst_rel = max([*first_rel.values(), *valid_rel.values(),
                     *(v for t in two for v in t["rel"].values())])
    emit({"phase": "vits_parity", "asset": TTS.name,
          "reference": str(VITS_REF.relative_to(ROOT)),
          "data_seconds": data_s, "dropout": "off",
          "first_batch": {"stats": first, "rel_diff": first_rel,
                          "tokens": n_tokens,
                          "durations_differ": durs_differ,
                          "rows": "[utterance, token, ours, JAX's, the "
                                  "closest call on its path, relative]"},
          "two_steps": two, "valid": {"n_utts": n_valid,
                                      "stats": valid_parity,
                                      "rel_diff": valid_rel},
          "rel_tol": VITS_LOSS_TOL, "margin_tol": MAS_MARGIN_TOL,
          "nvidia_smi": smi})
    if not worst_rel <= VITS_LOSS_TOL:
        raise AssertionError(f"a VITS loss term differs from the JAX "
                             f"package's by {worst_rel} (relative)")
    if any(not row[4] < MAS_MARGIN_TOL for row in durs_differ):
        raise AssertionError(f"MAS durations differ at calls that are "
                             f"not close: {durs_differ}")

    # 27. the entry point, the config as it is: 10 steps, validation
    start = asset_model("cuda", dropout_off=False)
    before = evaluate(start, valid_if, "cuda", make_step=make_gan_eval_step)
    del start
    tcfg, tpath = vits_cfg("train")
    trainer, timer, wall, peak = gan_train_run(torch, _cuda,
                                               gan_tts_train.main, tpath)
    steps = trainer.step_stats
    mas = timer.mas_ms()
    after = trainer.reporter.stats[1]["valid"]
    fresh = GANTTSTask.build_model(tcfg)
    convert.load_flax_params(fresh, load_checkpoint(
        Path(tcfg["output_dir"]) / "checkpoint")[0])
    fresh.to("cuda")
    reloaded = evaluate(fresh, valid_if, "cuda",
                        make_step=make_gan_eval_step)
    keys_ = ("generator_loss", "generator_adv_loss", "generator_mel_loss",
             "generator_kl_loss", "generator_dur_loss",
             "generator_feat_match_loss", "discriminator_loss",
             "grad_norm_g", "grad_norm_d", "skipped", "skipped_d")
    per_step = [{k: s[k] for k in keys_}
                | {"logmel_fwd": t["launches"]["logmel_fwd"],
                   "ms": t["ms"], "mas_ms": m_}
                for s, t, m_ in zip(steps, timer.steps, mas)]
    vits_step = timer.steps[0]["launches"]
    vits_valid = timer.valid[0]
    med_ms = statistics.median(t["ms"] for t in timer.steps)
    med_mas = statistics.median(mas)
    emit({"phase": "vits_train", "batch_size": tcfg["batch_size"],
          "n_train": VITS_N_TRAIN, "n_valid": VITS_N_VALID,
          "steps": per_step, "median_step_ms": med_ms,
          "median_mas_ms": med_mas, "mas_share": med_mas / med_ms,
          "launches_per_step": vits_step,
          "launches_per_valid_batch": vits_valid,
          "valid_before": before, "valid_after": after,
          "valid_reloaded_loss": reloaded["loss"],
          "peak_memory_bytes": peak, "wall_seconds": wall,
          "nvidia_smi": smi})
    check_gan_steps(steps, timer, {"logmel_fwd": 2}, VITS_STEPS)
    if timer.valid[0] != {n: 2 * (n == "logmel_fwd") for n in _cuda.LAUNCHES
                          } or any(
            v != timer.valid[0] for v in timer.valid):
        raise AssertionError(f"VITS valid launches {timer.valid}")
    if not abs(reloaded["loss"] - after["loss"]) <= RELOAD_TOL * abs(
            after["loss"]):
        raise AssertionError(f"VITS reload: {reloaded['loss']} against "
                             f"{after['loss']}")

    # the round trip with the trained generator, noise scale 0.333
    tmodel = trainer.model.eval()
    hop = tcfg["hop_length"]
    keys, texts = tts_keys(SynthSpeechCorpus())
    pre = GANTTSTask.build_preprocess_fn(tcfg, train=False)
    s2t = Speech2Text(asr_train_config=ASSET / "config.yaml",
                      asr_model_file=ASSET, beam_size=BEAM,
                      ctc_weight=CTC_WEIGHT)
    hyps = []
    for i, (k, text) in enumerate(zip(keys, texts)):
        ids = pre(k, {"text": text, "speech": np.zeros(512, np.float32)})[
            "text"]
        t = torch.from_numpy(padded_ids(ids)).cuda()
        tl = torch.tensor([len(ids)], device="cuda")
        with torch.no_grad():
            wav, olens = tmodel.decode(t, tl, noise=torch.from_numpy(
                tts_noise(i)).cuda(), noise_scale=NOISE_SCALES[0],
                max_frames=MAX_FRAMES)
        wav = wav[0, :int(olens[0]) * hop].cpu().numpy()
        hyps.append(s2t(*wave_batch(wav, bucket_length))[0][0][0])
    trained_wer = wer_cer(score_corpus, texts, hyps)
    asset_wer = json.loads(TTS_LM_REFERENCE.read_text(encoding="utf-8"))[
        "tts_vits"][f"ns_{NOISE_SCALES[0]}"]["wer"]
    del tmodel, trainer, fresh, s2t

    # determinism: two 3-step runs from one seed and a resumed one
    vits_det = determinism(GANTTSTask, lambda n, **kw: vits_cfg(n, **kw),
                           "vits")

    # the grad check of both turns, on the trained checkpoint
    gb = batch_of(keys0)
    gb = {k: v[:VITS_GRAD_BATCH] for k, v in gb.items()}
    gd = {k: v[:VITS_GRAD_BATCH] for k, v in draws_of(b0, 0).items()}

    def trained(dev):
        m = GANTTSTask.build_model(tcfg)
        convert.load_flax_params(m, load_checkpoint(
            Path(tcfg["output_dir"]) / "checkpoint")[0])
        return m.to(dev).eval()

    vits_grads = gan_grad_check(torch, trained, gb, gd)
    emit({"phase": "vits_train_checks",
          "round_trip": {"n_texts": len(keys),
                         "noise_scale": NOISE_SCALES[0]} | trained_wer,
          "round_trip_wer_untrained_asset_jax": asset_wer,
          "determinism": vits_det, "grad_check": vits_grads,
          "nvidia_smi": smi})

    # 28. the GAN vocoder: the recipe's config from the seed, over the
    # same speaker-0 waves
    def voc_cfg(name, **extra):
        data = vdir / "data"
        c = resolve_config(GANVocoderTask.default_config(), overrides={
            **VOCODER, "output_dir": str(vdir / name), "max_epoch": 1,
            "num_iters_per_epoch": VOC_STEPS, "log_interval": 1,
            "train_data_path_and_name_and_type": [
                f"{data}/train/wav.scp,speech,sound"],
            "valid_data_path_and_name_and_type": [
                f"{data}/valid/wav.scp,speech,sound"], **extra})
        dump_yaml(c, vdir / f"{name}.yaml")
        return c, vdir / f"{name}.yaml"

    vcfg, vpath = voc_cfg("vocoder")
    vtrainer, vtimer, vwall, vpeak = gan_train_run(
        torch, _cuda, gan_vocoder_train.main, vpath)
    vsteps = vtrainer.step_stats
    vafter = vtrainer.reporter.stats[1]["valid"]
    vvalid_if = GANVocoderTask.build_iter_factory(vcfg, train=False)

    def voc_trained(dev):
        m = GANVocoderTask.build_model(vcfg)
        convert.load_flax_params(m, load_checkpoint(
            Path(vcfg["output_dir"]) / "checkpoint")[0])
        return m.to(dev).eval()

    vreloaded = evaluate(voc_trained("cuda"), vvalid_if, "cuda",
                         make_step=make_gan_eval_step)
    voc_step = vtimer.steps[0]["launches"]
    vkeys_ = ("generator_loss", "generator_adv_loss", "generator_mel_loss",
              "generator_feat_match_loss", "discriminator_loss",
              "grad_norm_g", "grad_norm_d", "skipped", "skipped_d")
    vtrain_if = GANVocoderTask.build_iter_factory(vcfg, train=True)
    vb = first_batch(vtrain_if, "cpu")
    vb = {"speech": vb["speech"][:VITS_GRAD_BATCH].numpy()}
    voc_det = determinism(GANVocoderTask, lambda n, **kw: voc_cfg(n, **kw),
                          "vocoder")
    voc_grads = gan_grad_check(torch, voc_trained, vb, {})
    emit({"phase": "gan_vocoder_train", "batch_size": vcfg["batch_size"],
          "segment_size": vcfg["segment_size"],
          "steps": [{k: s[k] for k in vkeys_}
                    | {"logmel_fwd": t["launches"]["logmel_fwd"],
                       "ms": t["ms"]}
                    for s, t in zip(vsteps, vtimer.steps)],
          "median_step_ms": statistics.median(t["ms"]
                                              for t in vtimer.steps),
          "launches_per_step": voc_step,
          "launches_per_valid_batch": vtimer.valid[0],
          "valid_after": vafter, "valid_reloaded_loss": vreloaded["loss"],
          "peak_memory_bytes": vpeak, "wall_seconds": vwall,
          "determinism": voc_det, "grad_check": voc_grads,
          "nvidia_smi": smi})
    check_gan_steps(vsteps, vtimer, {"logmel_fwd": 4}, VOC_STEPS)
    if not abs(vreloaded["loss"] - vafter["loss"]) <= RELOAD_TOL * abs(
            vafter["loss"]):
        raise AssertionError(f"vocoder reload: {vreloaded['loss']} "
                             f"against {vafter['loss']}")
    return vits_step, vits_valid, voc_step


def unpack(d: dict):
    """An array stored by scripts/jax_a5_reference.py:pack."""
    import base64
    import zlib

    import numpy as np
    return np.frombuffer(zlib.decompress(base64.b64decode(d["zlib_b64"])),
                         d["dtype"]).reshape(d["shape"])


def k2_at(torch, wave, *, fs: int, n_fft: int, hop_length: int,
          n_mels: int) -> dict:
    """K2 at one shape of a new path against its plain version (above
    K2_MIN_MEL), launched twice for the same bits, timed by CUDA events
    and by the profiler's device time beside the plain version and
    torch.stft + power + mel product, with its bound: the FFT, window,
    power and nonzero mel weights of each frame, the wave read and the
    log-mel written."""
    from espnet_tpu_torch.ops.logmel import fused_logmel, fused_logmel_plain
    from espnet_tpu_torch.ops.mel import mel_matrix
    kw = dict(fs=fs, n_fft=n_fft, hop_length=hop_length, n_mels=n_mels)
    wave = wave.float().contiguous()
    window = torch.hann_window(n_fft, device="cuda")
    melw = mel_matrix(fs, n_fft, n_mels, 0.0, None, False, "cuda:0")

    def kern():
        return fused_logmel(wave, **kw)

    def plain():
        return fused_logmel_plain(wave, **kw)

    def library():
        spec = torch.stft(wave, n_fft, hop_length, window=window,
                          center=True, pad_mode="reflect",
                          return_complex=True)
        power = spec.real.square() + spec.imag.square()
        return torch.log(torch.clamp(power.transpose(1, 2) @ melw,
                                     min=1e-10))

    with torch.no_grad():
        out, ref = kern(), plain()
        sel = ref > math.log(K2_MIN_MEL)
        B, S = wave.shape
        frames = B * (S // hop_length + 1)
        nnz = int((melw != 0).sum())
        nf = n_fft // 2 + 1
        row = {"shape": [B, S], "n_fft": n_fft, "hop_length": hop_length,
               "n_mels": n_mels, "max_abs_err": float(
                   (out - ref)[sel].abs().max()),
               "same_bits_twice": bool(torch.equal(out, kern())),
               "ms": time_ms(torch, kern), "plain_ms": time_ms(torch, plain),
               "library_ms": time_ms(torch, library),
               "library_note": "torch.stft, the power and the mel product",
               "flops": frames * (2.5 * n_fft * math.log2(n_fft) + n_fft
                                  + 3 * nf + 2 * nnz + n_mels),
               "bytes": 4.0 * (B * S + n_fft + nnz + frames * n_mels)}
        prof = device_times(torch, {"kernel": kern, "library": library})
    # None where the profiler listed none of the kernel's launches
    row["device_ms"] = (sum(k["ms"] for k in prof["kernel"])
                        if prof["kernel"] else None)
    row["library_device_ms"] = sum(k["ms"] for k in prof["library"])
    row["device_kernels"] = prof
    bound(row)
    if not (row["max_abs_err"] <= K2_TOL and row["same_bits_twice"]):
        raise AssertionError(f"logmel_fwd at {row['shape']}, n_fft {n_fft}:"
                             f" error {row['max_abs_err']}, same bits "
                             f"{row['same_bits_twice']}")
    return row


def a5_config(task, asset: Path, workdir: Path, name: str,
              weights: Path = None, **extra):
    """The asset's config with this run's data and output dir, 10 steps
    of one epoch from the asset's weights (or ``weights``), written to
    workdir/name.yaml."""
    from espnet_tpu_torch.utils.config import dump_yaml, resolve_config
    cfg = resolve_config(task.default_config(), asset / "config.yaml", {
        "output_dir": str(workdir / name), "train_shape_file": [],
        "valid_shape_file": [],
        "init_param": str(weights or asset / "params_f16.npz"),
        "max_epoch": 1, "num_iters_per_epoch": A5_STEPS, "log_interval": 1,
        **extra})
    dump_yaml(cfg, workdir / f"{name}.yaml")
    return cfg, workdir / f"{name}.yaml"


def a5_train(torch, _cuda, entry_main, task, model_cls, cfg, cfg_path,
             asset, want: dict, loss_keys, valid_if) -> dict:
    """An entry point's steps (10 of one epoch, or as ``cfg`` says) with
    train_path's records: the validation before (the asset) and after
    each epoch, a reload of the checkpoint to the same validation loss,
    the launches of one valid batch."""
    from espnet_tpu_torch import convert
    from espnet_tpu_torch.train.checkpoint import load_checkpoint
    from espnet_tpu_torch.train.trainer import evaluate, to_device
    model, _ = task.build_model_from_file(cfg_path, asset)
    before = evaluate(model, valid_if, "cuda")
    trainer, per_step, launches, wall, peak = train_run(
        torch, _cuda, entry_main, cfg_path, model_cls)
    steps = trainer.step_stats
    epochs = cfg["max_epoch"]
    after = trainer.reporter.stats[epochs]["valid"]
    flat, _, meta = load_checkpoint(Path(cfg["output_dir"]) / "checkpoint")
    fresh = convert.load_flax_params(task.build_model(cfg), flat).to("cuda")
    reloaded = evaluate(fresh, valid_if, "cuda")
    _, vb = valid_if.collate_fn([valid_if.dataset[k] for k in
                                 valid_if.epoch_batches(0)[0]])
    vb = to_device(vb, "cuda")
    fresh.eval()
    _cuda.reset_launch_counts()
    with torch.no_grad():
        fresh(**vb)
    valid_launches = dict(_cuda.LAUNCHES)
    step_ms = [1e3 * s["train_time"] for s in steps]
    full = {n: want.get(n, 0) for n in _cuda.LAUNCHES}
    check_steps(steps, per_step, full, loss_keys,
                n_steps=epochs * cfg["num_iters_per_epoch"])
    if valid_launches != full:
        raise AssertionError(f"launches per valid batch {valid_launches}, "
                             f"not {full}")
    if not abs(reloaded["loss"] / after["loss"] - 1) <= RELOAD_TOL:
        raise AssertionError(f"the reloaded checkpoint's validation loss "
                             f"{reloaded['loss']} != {after['loss']}")
    return {"steps": [{k: s[k] for k in (*loss_keys, "grad_norm",
                                         "skipped")}
                      | {"ms": ms, "launches": n}
                      for s, ms, n in zip(steps, step_ms, per_step)],
            "step_ms_median_3_10": statistics.median(step_ms[2:]),
            "peak_memory_bytes": peak, "wall_seconds": wall,
            "valid_before": before, "valid_after": after,
            "valid_per_epoch": {e: trainer.reporter.stats[e]["valid"]
                                for e in range(1, epochs + 1)},
            "valid_reloaded": reloaded, "checkpoint_epoch": meta["epoch"],
            "step_launches": full, "valid_batch_launches": valid_launches}


def code_margins(coder_cpu, wave):
    """The CPU's RVQ on (B, S): per stage the codes and the gap of the
    two best distances over |best| -> (codes (B, T, Q), margins
    (B, T, Q))."""
    import numpy as np
    import torch
    rvq = coder_cpu.model.rvq
    gaps = []
    own = rvq.nearest

    def nearest(q, r, cb):
        d = rvq.distances(r, cb)
        two = torch.topk(d, 2, dim=-1, largest=False).values
        gaps.append(((two[..., 1] - two[..., 0])
                     / two[..., 0].abs().clamp(min=1e-30)).numpy())
        return own(q, r, cb)

    rvq.nearest = nearest
    try:
        codes = coder_cpu.encode(wave)
    finally:
        del rvq.nearest
    return codes, np.stack(gaps, axis=-1)


def code_agreement(ours, theirs, margins) -> dict:
    """Codes of the card against the reference's: the equal share, and
    each difference at a near-tie of the CPU's distances, or in a later
    stage of a position whose first differing stage is one (its
    residual then differs)."""
    import numpy as np
    differ = ours != theirs
    first = np.argmax(differ, axis=-1)
    pos_differ = differ.any(-1)
    b, t = np.nonzero(pos_differ)
    first_gap = margins[b, t, first[b, t]]
    return {"n_codes": int(differ.size), "n_differ": int(differ.sum()),
            "equal_share": float(1 - differ.mean()),
            "positions_differ": int(pos_differ.sum()),
            "first_stage_gaps": sorted(float(g) for g in first_gap)[-10:],
            "near_tie_tol": NEAR_TIE_REL,
            "all_at_near_ties": bool((first_gap <= NEAR_TIE_REL).all())}


def a5_phases(torch, _cuda, workdir: Path, smi: str):
    """Phases 29-32: diarization, the codec and the SpeechLM. -> the
    launches of each new path per decode batch, train step and valid
    batch."""
    import hashlib

    import numpy as np

    from espnet_tpu_torch.bin import (diar_train, gan_codec_train,
                                      speechlm_train)
    from espnet_tpu_torch.bin.diar_inference import DiarizeSpeech, dialog_der
    from espnet_tpu_torch.bin.gan_codec_inference import (CodecCoder,
                                                          recon_scores)
    from espnet_tpu_torch.bin.speechlm_inference import SpeechLMInference
    from espnet_tpu_torch.data.fileio import NpyScpWriter, SoundScpReader
    from espnet_tpu_torch.data.speechlm import (build_example,
                                                write_dataset_json)
    from espnet_tpu_torch.data.synth_speech import (SynthSpeechCorpus,
                                                    dialogs,
                                                    materialize_dialogs)
    from espnet_tpu_torch.models.codec import CodecModel
    from espnet_tpu_torch.models.diar import DiarizationModel
    from espnet_tpu_torch.models.speechlm import SpeechLM
    from espnet_tpu_torch.tasks.speechlm import (SpeechLMTask,
                                                 build_vocab_from_cfg,
                                                 recipe_token_list)
    from espnet_tpu_torch.tasks.spk import DiarizationTask
    from espnet_tpu_torch.tasks.ssl import CodecTask

    ref = json.loads(A5_REFERENCE.read_text(encoding="utf-8"))
    paths = {"decode": {}, "train_step": {}, "valid_batch": {}}

    # 29. diar_decode: the seeded test dialogs, the recipe's eval
    t0 = time.perf_counter()
    waves, labels = dialogs("test", N_DIALOGS, DIAR_TEST_SEED)
    data_s = time.perf_counter() - t0
    # the labels to the bit; the waves' synthesis (scipy's filters) may
    # round otherwise under another numpy / scipy: their energies to 1e-6
    energy = np.asarray([np.sum(np.square(w, dtype=np.float64))
                         for w in waves])
    energy_rel = float(np.max(np.abs(energy / np.asarray(
        ref["diar"]["waves_energy"]) - 1)))
    waves_equal = hashlib.sha256(np.stack(waves).tobytes()).hexdigest() \
        == ref["diar"]["waves_sha256"]
    if hashlib.sha256(np.stack(labels).tobytes()).hexdigest() != \
            ref["diar"]["labels_sha256"] or not energy_rel <= 1e-6:
        raise AssertionError(f"the test dialogs differ from the JAX "
                             f"reference's (energy {energy_rel})")
    diar = DiarizeSpeech(DIAR / "config.yaml", DIAR)
    win = waves[0].shape[0]
    dialog_der(diar, waves[:DIAR_BATCH], labels[:DIAR_BATCH], win,
               DIAR_BATCH)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    der, acts = dialog_der(diar, waves, labels, win, DIAR_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    n_batches = -(-N_DIALOGS // DIAR_BATCH)
    per_batch = {n: v / n_batches for n, v in launches.items()}
    paths["decode"]["diar"] = per_batch
    jacts = unpack(ref["diar"]["decisions"])
    frames_differ = int((np.stack(acts) != jacts).any(-1).sum())
    emit({"phase": "diar_decode", "n_dialogs": N_DIALOGS,
          "seed": DIAR_TEST_SEED, "batch": DIAR_BATCH, "der": der,
          "der_jax": ref["diar"]["der"], "limit": ref["diar"]["der"]
          + DER_MARGIN, "der_results_json": ref["diar"]["results_json_der"],
          "frames_differ_from_cpu": frames_differ,
          "waves_bit_equal": waves_equal, "waves_energy_rel": energy_rel,
          "n_frames": int(jacts.shape[0] * jacts.shape[1]),
          "data_seconds": data_s, "wall_seconds": wall,
          "audio_s_per_s": N_DIALOGS * win / 16000 / wall,
          "launches": launches})
    if launches != {n: (n_batches if n == "logmel_fwd" else 0)
                    for n in launches}:
        raise AssertionError(f"diarization launches {launches} in "
                             f"{n_batches} batches")
    if not der <= ref["diar"]["der"] + DER_MARGIN:
        raise AssertionError(f"DER {der} above the JAX package's "
                             f"{ref['diar']['der']} + {DER_MARGIN}")

    # 30. diar_train: the asset's config over seeded dialogs
    ddir = workdir / "diar"
    for split, n, seed in (("train", DIAR_N_TRAIN, DIAR_TRAIN_SEED),
                           ("valid", DIAR_N_VALID, DIAR_VALID_SEED)):
        materialize_dialogs(ddir / "data", split, n, seed)

    def diar_cfg(name, **extra):
        d = ddir / "data"
        return a5_config(DiarizationTask, DIAR, ddir, name, **{
            "train_data_path_and_name_and_type": [
                f"{d}/train/wav.scp,speech,sound",
                f"{d}/train/labels.scp,spk_labels,npy"],
            "valid_data_path_and_name_and_type": [
                f"{d}/valid/wav.scp,speech,sound",
                f"{d}/valid/labels.scp,spk_labels,npy"], **extra})

    dcfg, dcfg_path = diar_cfg("train")
    dvalid_if = DiarizationTask.build_iter_factory(dcfg, train=False)
    rec = a5_train(torch, _cuda, diar_train.main, DiarizationTask,
                   DiarizationModel, dcfg, dcfg_path, DIAR,
                   {"logmel_fwd": 1}, ("loss", "frame_acc"), dvalid_if)
    paths["train_step"]["diar"] = rec["step_launches"]
    paths["valid_batch"]["diar"] = rec["valid_batch_launches"]
    _, gb = dvalid_if.collate_fn([dvalid_if.dataset[k] for k in
                                  dvalid_if.dataset.keys()[:GRAD_BATCH]])
    emit({"phase": "diar_train", "n_train": DIAR_N_TRAIN,
          "n_valid": DIAR_N_VALID, **rec,
          "grad_check": grad_check(torch, DiarizationTask, dcfg_path, DIAR,
                                   gb),
          "determinism": determinism(DiarizationTask, diar_cfg, "diar")})

    # 31. codec: the recipe's 50 test utterances, then training
    sdata = workdir / "stream_data"
    if not (sdata / "test" / "wav.scp").exists() or not (
            sdata / "valid" / "wav.scp").exists():
        SynthSpeechCorpus().materialize(sdata, n_train=0,
                                        n_valid=N_SLM_VALID,
                                        n_test=N_CODEC_UTTS)
    coder = CodecCoder(CODEC / "config.yaml", CODEC)
    coder_cpu = CodecCoder(CODEC / "config.yaml", CODEC, device="cpu")
    test = SoundScpReader(sdata / "test" / "wav.scp")
    keys = sorted(test.keys())[:N_CODEC_UTTS]
    utt = 74656
    si_all, mel_all, codes_all, margins_all, walls = [], [], [], [], []
    _cuda.reset_launch_counts()
    for i in range(0, len(keys), CODEC_BATCH):
        chunk = keys[i:i + CODEC_BATCH]
        w = np.zeros((CODEC_BATCH, utt), np.float32)
        for j, k in enumerate(chunk):
            a = test[k][1]
            w[j, :min(len(a), utt)] = a[:utt]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codes = coder.encode(w)
        recon = coder.decode(codes)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        recon = recon[:len(chunk)]
        refw = w[:len(chunk), :recon.shape[1]]
        si, mel = recon_scores(recon[:, :refw.shape[1]], refw)
        si_all.extend(si.tolist())
        mel_all.append(mel)
        codes_all.append(codes[:len(chunk)])
        margins_all.append(code_margins(coder_cpu, w)[1][:len(chunk)])
        if i == 0:
            first_pair = (torch.from_numpy(np.ascontiguousarray(
                recon[:, :coder.model.hop * (utt // coder.model.hop)])),
                torch.from_numpy(np.ascontiguousarray(
                    w[:, :coder.model.hop * (utt // coder.model.hop)])))
    codec_launches = dict(_cuda.LAUNCHES)
    if any(codec_launches.values()):
        raise AssertionError(f"a kernel ran in the codec's round trips: "
                             f"{codec_launches}")
    agree = code_agreement(np.concatenate(codes_all),
                           unpack(ref["codec"]["codes"]).astype(np.int32),
                           np.concatenate(margins_all))
    si_snr, mel_l1 = float(np.mean(si_all)), float(np.mean(mel_all))
    cref = ref["codec"]
    # the mel loss through K2 between the first batch's decoded waves and
    # the waves, cut to the hop, as the training loss takes them
    from espnet_tpu_torch.models.tts.hifigan import melspec
    mkw = dict(fs=16000, n_fft=256, hop_length=64, n_mels=40)
    with torch.no_grad():
        fake, real = first_pair[0].cuda(), first_pair[1].cuda()
        loss_kernel = float(torch.mean(torch.abs(melspec(fake, **mkw)
                                                 - melspec(real, **mkw))))
        from espnet_tpu_torch.ops.logmel import fused_logmel_plain
        loss_plain = float(torch.mean(torch.abs(
            fused_logmel_plain(fake, **mkw) - fused_logmel_plain(real,
                                                                 **mkw))))
    mel_loss = {"kernel": loss_kernel, "plain": loss_plain,
                "rel_diff": abs(loss_kernel / loss_plain - 1),
                "tol": K2_MEL_LOSS_TOL}
    emit({"phase": "codec", "n_utts": N_CODEC_UTTS, "batch": CODEC_BATCH,
          "si_snr_db": si_snr, "si_snr_db_jax": cref["si_snr_db"],
          "mel_l1": mel_l1, "mel_l1_jax": cref["mel_l1"],
          "results_json": cref["results_json"],
          "uncut_74656_jax": cref["uncut_74656"], "codes": agree,
          "mel_loss_through_k2": mel_loss,
          "batch_seconds": walls, "audio_s_per_s": sum(
              len(test[k][1][:utt]) for k in keys) / 16000 / sum(walls),
          "launches": codec_launches})
    if not abs(si_snr - cref["si_snr_db"]) <= SI_SNR_MARGIN:
        raise AssertionError(f"codec SI-SNR {si_snr} against JAX's "
                             f"{cref['si_snr_db']}")
    if not abs(mel_l1 / cref["mel_l1"] - 1) <= MEL_L1_REL:
        raise AssertionError(f"codec mel-L1 {mel_l1} against JAX's "
                             f"{cref['mel_l1']}")
    if not (agree["equal_share"] >= CODES_EQUAL_MIN
            and agree["all_at_near_ties"]):
        raise AssertionError(f"codes against JAX's: {agree}")
    if not mel_loss["rel_diff"] <= K2_MEL_LOSS_TOL:
        raise AssertionError("the codec's mel loss through K2 differs from "
                             "its plain version's")

    fdata = workdir / "data"

    def codec_cfg(name, **extra):
        return a5_config(CodecTask, CODEC, workdir / "codec", name, **{
            "train_data_path_and_name_and_type": [
                f"{fdata}/train/wav.scp,speech,sound"],
            "valid_data_path_and_name_and_type": [
                f"{fdata}/valid/wav.scp,speech,sound"], **extra})

    (workdir / "codec").mkdir(exist_ok=True)
    ccfg, ccfg_path = codec_cfg("train")
    cvalid_if = CodecTask.build_iter_factory(ccfg, train=False)
    rec = a5_train(torch, _cuda, gan_codec_train.main, CodecTask,
                   CodecModel, ccfg, ccfg_path, CODEC, {"logmel_fwd": 2},
                   ("loss", "recon_l1", "mel_l1", "commit"), cvalid_if)
    paths["train_step"]["codec"] = rec["step_launches"]
    paths["valid_batch"]["codec"] = rec["valid_batch_launches"]
    _, gb = cvalid_if.collate_fn([cvalid_if.dataset[k] for k in
                                  cvalid_if.dataset.keys()[:4]])
    emit({"phase": "codec_train", **rec,
          "grad_check": grad_check(torch, CodecTask, ccfg_path, CODEC, gb),
          "determinism": determinism(CodecTask, codec_cfg, "codec")})

    # 32. speechlm: the recipe's valid set tokenized by the port's codec
    sdir = workdir / "speechlm"
    (sdir / "data").mkdir(parents=True, exist_ok=True)
    tokens_txt = sdir / "data" / "tokens.txt"
    tokens_txt.write_text("\n".join(recipe_token_list()) + "\n",
                          encoding="utf-8")
    hop = coder.model.hop
    S = (utt // hop) * hop

    def tokenize(reader, keys_, split):
        codes_out, margins = [], []
        with NpyScpWriter(sdir / "data" / split / "codes",
                          sdir / "data" / split / "codes.scp") as wr:
            for i in range(0, len(keys_), SLM_TOKEN_BATCH):
                chunk = keys_[i:i + SLM_TOKEN_BATCH]
                w = np.zeros((SLM_TOKEN_BATCH, S), np.float32)
                for j, k in enumerate(chunk):
                    a = reader[k][1][:S]
                    w[j, :len(a)] = a
                codes = coder.encode(w)
                for j, k in enumerate(chunk):
                    wr[k] = codes[j]
                codes_out.append(codes[:len(chunk)])
                if split == "valid":
                    margins.append(code_margins(coder_cpu, w)[1][
                        :len(chunk)])
        write_dataset_json(
            sdir / "data" / f"{split}_continuation.json",
            "audio_continuation",
            [{"name": "audio1", "type": "npy",
              "path": str(sdir / "data" / split / "codes.scp")}], keys_)
        return np.concatenate(codes_out), margins

    vreader = SoundScpReader(sdata / "valid" / "wav.scp")
    vkeys = sorted(vreader.keys())[:N_SLM_VALID]
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    vcodes, vmargins = tokenize(vreader, vkeys, "valid")
    tok_s = time.perf_counter() - t0
    treader = SoundScpReader(fdata / "train" / "wav.scp")
    tokenize(treader, sorted(treader.keys())[:SLM_N_TRAIN], "train")
    sref = ref["speechlm"]
    jtoks = unpack(sref["tokens"]).astype(np.int32)
    tok_agree = code_agreement(vcodes, jtoks, np.concatenate(vmargins))

    def slm_cfg(name, **extra):
        return a5_config(SpeechLMTask, SPEECHLM, sdir, name, **{
            "multi_task_dataset": [
                str(sdir / "data" / "train_continuation.json")],
            "valid_multi_task_dataset": [
                str(sdir / "data" / "valid_continuation.json")],
            "text_token_list": str(tokens_txt), **extra})

    scfg, scfg_path = slm_cfg("train")
    lm, _ = SpeechLMTask.build_model_from_file(scfg_path, SPEECHLM)
    vocab, _ = build_vocab_from_cfg(scfg)

    def perplexity(codes_set):
        """speechlm1/run.py:181-209: full batches of 16 at 239."""
        tot_nll = tot_tok = tot_acc = 0.0
        n_full = len(codes_set) - len(codes_set) % SLM_BATCH
        with torch.no_grad():
            for i in range(0, n_full, SLM_BATCH):
                toks = np.full((SLM_BATCH, SLM_LEN, vocab.n_streams),
                               vocab.pad, np.int64)
                masks = np.zeros((SLM_BATCH, SLM_LEN), np.float32)
                for j, c in enumerate(codes_set[i:i + SLM_BATCH]):
                    ex = build_example("audio_continuation", {"audio1": c},
                                       vocab)
                    L = min(len(ex["tokens"]), SLM_LEN)
                    toks[j, :L] = ex["tokens"][:L]
                    masks[j, :L] = ex["loss_mask"][:L]
                _, stats, _ = lm(torch.from_numpy(toks).cuda(),
                                 torch.full((SLM_BATCH,), SLM_LEN,
                                            device="cuda"),
                                 loss_mask=torch.from_numpy(masks).cuda())
                n = float(masks.sum())
                tot_nll += float(stats["loss"]) * n
                tot_acc += float(stats["acc"]) * n
                tot_tok += n
        return float(np.exp(tot_nll / tot_tok)), tot_acc / tot_tok, tot_tok

    ppl, acc, n_tok = perplexity(jtoks)
    ppl_own, acc_own, _ = perplexity(vcodes)
    # greedy continuations of the JAX package's prompts, and the port's
    # own prompts of the same 1 s
    prompts = unpack(sref["prompts"]).astype(np.int64)
    jgreedy = unpack(sref["greedy"]).astype(np.int64)
    greedy, glens = [], []
    t0 = time.perf_counter()
    for p in prompts:
        g, gl = lm.generate_scan(
            torch.from_numpy(p[None]).cuda(),
            torch.tensor([p.shape[0]], device="cuda"), GEN_STEPS,
            temperature=0.0, topk=SAMPLE_TOPK, eos_id=vocab.eos)
        greedy.append(g[0].cpu().numpy())
        glens.append(int(gl[0]))
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    greedy = np.stack(greedy)
    inf = SpeechLMInference(scfg_path, SPEECHLM, CODEC / "config.yaml",
                            CODEC, topk=SAMPLE_TOPK)
    own_prompts = np.stack([inf.prompt("audio_continuation", speech=vreader[
        k][1][:PROMPT_SAMPLES])[0] for k in vkeys[:N_PROMPTS]])
    n_ok, rms = 0, []
    for k in vkeys[:N_PROMPTS]:
        res = inf("audio_continuation", speech=vreader[k][1][
            :PROMPT_SAMPLES], steps=GEN_STEPS)
        gen = np.asarray(res.get("wav", np.zeros(0)), np.float32)
        rms.append(float(np.sqrt(np.mean(gen ** 2))) if len(gen) else 0.0)
        n_ok += int(rms[-1] > 1e-3)
    slm_launches = dict(_cuda.LAUNCHES)
    emit({"phase": "speechlm", "n_utts": N_SLM_VALID,
          "tokenize_seconds": tok_s, "tokens": tok_agree,
          "ppl_on_jax_tokens": ppl, "ppl_jax": sref["ppl"],
          "acc_on_jax_tokens": acc, "acc_jax": sref["acc"],
          "n_scored_tokens": n_tok, "ppl_on_own_tokens": ppl_own,
          "acc_on_own_tokens": acc_own,
          "results_json": sref["results_json"],
          "greedy_differ": int((greedy != jgreedy).sum()),
          "greedy_lengths": glens,
          "greedy_lengths_jax": sref["greedy_lengths"],
          "greedy_seconds": gen_s,
          "greedy_frames_per_s": N_PROMPTS * GEN_STEPS / gen_s,
          "own_prompts_differ": int((own_prompts != prompts).sum()),
          "sampled_nonsilent": n_ok, "sampled_rms": rms,
          "sampled_nonsilent_jax": sref["n_continuations_nonsilent"],
          "launches": slm_launches})
    if any(slm_launches.values()):
        raise AssertionError(f"a kernel ran in the SpeechLM phase: "
                             f"{slm_launches}")
    if not abs(ppl / sref["ppl"] - 1) <= PPL_REL:
        raise AssertionError(f"perplexity {ppl} against JAX's "
                             f"{sref['ppl']}")
    if not abs(acc - sref["acc"]) <= SLM_ACC_TOL:
        raise AssertionError(f"accuracy {acc} against JAX's {sref['acc']}")
    if not (tok_agree["equal_share"] >= CODES_EQUAL_MIN
            and tok_agree["all_at_near_ties"]):
        raise AssertionError(f"tokens against JAX's: {tok_agree}")
    if (greedy != jgreedy).any() or glens != sref["greedy_lengths"]:
        raise AssertionError("greedy continuations differ from JAX's")
    if tok_agree["n_differ"] == 0 and (own_prompts != prompts).any():
        raise AssertionError("the port's prompts differ from JAX's")

    svalid_if = SpeechLMTask.build_iter_factory(scfg, train=False)
    rec = a5_train(torch, _cuda, speechlm_train.main, SpeechLMTask,
                   SpeechLM, scfg, scfg_path, SPEECHLM, {},
                   ("loss", "acc"), svalid_if)
    paths["train_step"]["speechlm"] = rec["step_launches"]
    _, gb = svalid_if.collate_fn([svalid_if.dataset[k] for k in
                                  svalid_if.dataset.keys()[:SLM_BATCH]])
    emit({"phase": "speechlm_train", **rec,
          "grad_check": grad_check(torch, SpeechLMTask, scfg_path, SPEECHLM,
                                   gb),
          "determinism": determinism(
              SpeechLMTask, lambda n, **kw: slm_cfg(
                  n, valid_multi_task_dataset=None, **kw), "speechlm")})
    return paths


def decisions_flipped(scores, ref_scores, threshold: float):
    """Trials that the scores decide otherwise than ``ref_scores`` at
    ``threshold`` -> [(trial, |ref score - threshold|)]."""
    import numpy as np
    flip = np.flatnonzero((scores > threshold) != (ref_scores > threshold))
    return [(int(i), float(abs(ref_scores[i] - threshold))) for i in flip]


def spk_cls_phases(torch, _cuda, workdir: Path, smi: str, cls_test):
    """Phases 33-35: speaker verification and its training, then
    classification with the LID and ASVspoof entry points. ``cls_test``:
    phase 4's cls1 test batch (keys, speech, lengths, labels), its data
    dirs under workdir/cls/data. -> the launches of each path per decode
    batch, train step and valid batch."""
    import numpy as np

    from espnet_tpu_torch import convert
    from espnet_tpu_torch.bin import (asvspoof_inference, asvspoof_train,
                                      cls_train, lid_inference, lid_train,
                                      spk_embed_extract, spk_inference,
                                      spk_train)
    from espnet_tpu_torch.bin.cls_inference import ClassifySpeech
    from espnet_tpu_torch.bin.spk_inference import (SpeakerEmbedding,
                                                    embed_utterances,
                                                    write_trials)
    from espnet_tpu_torch.data.fileio import SoundScpReader
    from espnet_tpu_torch.data.synth_speech import SynthSpeechCorpus
    from espnet_tpu_torch.models.cls import ClassificationModel
    from espnet_tpu_torch.models.spk import SpeakerModel
    from espnet_tpu_torch.tasks.misc import ASVSpoofTask
    from espnet_tpu_torch.tasks.spk import (ClassificationTask, LIDTask,
                                            SpeakerTask, read_trials,
                                            trial_scores)
    from espnet_tpu_torch.train.checkpoint import load_checkpoint
    from espnet_tpu_torch.utils.config import dump_yaml, resolve_config
    from espnet_tpu_torch.utils.eer import (compute_eer, compute_min_dcf,
                                            operating_points)

    ref = json.loads(SPK_REFERENCE.read_text(encoding="utf-8"))
    paths = {"decode": {}, "train_step": {}, "valid_batch": {}}

    # 33. spk_verify: the recipe's held-out trials, as its stage 3
    sdir = workdir / "spk"
    data = sdir / "data"
    t0 = time.perf_counter()
    SynthSpeechCorpus().materialize(data, n_train=SPK_N_TRAIN,
                                    n_valid=SPK_N_VALID, n_test=SPK_N_TEST)
    for split in ("train", "valid", "test"):
        with open(data / split / "utt2spkid", "w") as f:
            for line in open(data / split / "utt2spk"):
                u, spk_name = line.split()
                f.write(f"{u} {int(spk_name[3:])}\n")
    write_trials(data, "valid", SPK_VALID_TRIALS)
    test_trials = write_trials(data, "test", SPK_TRIALS)
    data_s = time.perf_counter() - t0
    sref = ref["spk"]
    if test_trials.read_text(encoding="utf-8") != sref["trials"]:
        raise AssertionError("the test trials differ from the JAX "
                             "reference's")
    trials = read_trials(test_trials)
    reader = SoundScpReader(data / "test" / "wav.scp")
    utt_ids = sorted({u for _, e, t in trials for u in (e, t)})
    waves = [reader[u][1] for u in utt_ids]
    energy_rel = max(abs(float(np.sum(np.square(w, dtype=np.float64))) / e
                         - 1) for w, e in zip(waves, sref["waves_energy"]))
    if not energy_rel <= 1e-6:
        raise AssertionError(f"the test utterances differ from the JAX "
                             f"reference's (energy {energy_rel})")
    se = SpeakerEmbedding(SPK / "config.yaml", SPK)
    embed_utterances(se, waves[:SPK_BATCH], SPK_LEN, SPK_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    embs = embed_utterances(se, waves, SPK_LEN, SPK_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    scores, labels = trial_scores(dict(zip(utt_ids, embs)), trials)
    jscores = unpack(sref["scores"])
    eer, thr = compute_eer(scores, labels)
    mdcf = compute_min_dcf(scores, labels)
    n_target = int(labels.sum())
    n_non = len(labels) - n_target
    eer_thr, dcf_thr = operating_points(jscores, labels)
    flips = decisions_flipped(scores, jscores, eer_thr)
    dcf_flips = decisions_flipped(scores, jscores, dcf_thr)
    # the embedding CLIs on the first 8 test utterances, each alone
    keys8 = sorted(reader.keys())[:N_SPK_CLI]
    cli_scp = sdir / "cli_wav.scp"
    cli_scp.write_text("".join(f"{k} {reader.data[k]}\n" for k in keys8),
                       encoding="utf-8")
    model_args = ["--train_config", str(SPK / "config.yaml"),
                  "--model_file", str(SPK)]
    spk_embed_extract.main(["--output_dir", str(sdir / "extract"),
                            "--wav_scp", str(cli_scp), *model_args])
    spk_inference.main(["--output_dir", str(sdir / "embed_cli"),
                        "--data_path_and_name_and_type",
                        f"{cli_scp},speech,sound", *model_args])
    spk_launches = dict(_cuda.LAUNCHES)
    own = np.stack([se(reader[k][1])[0] for k in keys8])
    extracted = np.stack([np.load(sdir / "extract" / f"{k}.npy")[0]
                          for k in keys8])
    written = np.stack([np.load(sdir / "embed_cli" / "embed" / f"{k}.npy")
                        for k in keys8])
    jcli = unpack(sref["cli_embeddings"])
    cli_rel = float(np.abs(own - jcli).max() / np.abs(jcli).max())
    audio_s = sum(min(len(w), SPK_LEN) for w in waves) / 16000
    one_trial_dcf = max(0.05 / n_target, 0.95 / n_non) / 0.05
    emit({"phase": "spk_verify", "n_trials": len(trials),
          "n_utts": len(utt_ids), "batch": SPK_BATCH, "length": SPK_LEN,
          "eer": eer, "eer_jax": sref["eer"], "threshold": thr,
          "threshold_jax": sref["threshold"], "min_dcf": mdcf,
          "min_dcf_jax": sref["min_dcf"],
          "results_json": sref["results_json"],
          "max_score_diff_from_jax_cpu": float(np.abs(scores
                                                      - jscores).max()),
          "score_tol": SCORE_TOL, "eer_operating_point_jax": eer_thr,
          "eer_flips": flips, "min_dcf_operating_point_jax": dcf_thr,
          "min_dcf_flips": dcf_flips,
          "waves_energy_rel": energy_rel, "data_seconds": data_s,
          "embed_seconds": wall, "audio_s_per_s": audio_s / wall,
          "peak_memory_bytes": peak,
          "cli_equal_to_api": bool(np.array_equal(extracted, own)
                                   and np.array_equal(written, own)),
          "cli_max_rel_from_jax": cli_rel, "launches": spk_launches,
          "nvidia_smi": smi})
    if any(spk_launches.values()):
        raise AssertionError(f"a kernel ran in the speaker phase: "
                             f"{spk_launches}")
    if not float(np.abs(scores - jscores).max()) <= SCORE_TOL:
        raise AssertionError("a trial's score is not within 1e-4 of the "
                             "JAX package's")
    for name, fl, ours, theirs, step in (
            ("EER", flips, eer, sref["eer"], 1 / n_target),
            ("minDCF", dcf_flips, mdcf, sref["min_dcf"], one_trial_dcf)):
        if len(fl) > 1 or any(gap > SCORE_TOL for _, gap in fl):
            raise AssertionError(f"{name}: trials decided otherwise than "
                                 f"the JAX package's: {fl}")
        if not abs(ours - theirs) <= len(fl) * step + 1e-12:
            raise AssertionError(f"{name} {ours} against JAX's {theirs}")
    if not (np.array_equal(extracted, own) and np.array_equal(written, own)):
        raise AssertionError("the embedding CLIs wrote other embeddings "
                             "than SpeakerEmbedding's")
    if not cli_rel <= SCORE_TOL:
        raise AssertionError(f"embeddings {cli_rel} from the JAX "
                             f"package's")
    paths["decode"]["spk"] = {n: v * SPK_BATCH / len(utt_ids)
                              for n, v in spk_launches.items()}

    # 34. spk_train: the asset's config from its weights, the margin
    # warm-up on and the trial EER in each valid epoch
    def spk_cfg(name, **extra):
        return a5_config(SpeakerTask, SPK, sdir, name, **{
            "train_data_path_and_name_and_type": [
                f"{data}/train/wav.scp,speech,sound",
                f"{data}/train/utt2spkid,spk_labels,text_int"],
            "valid_data_path_and_name_and_type": [
                f"{data}/valid/wav.scp,speech,sound",
                f"{data}/valid/utt2spkid,spk_labels,text_int"],
            "valid_trial": str(data / "valid" / "trials"),
            "valid_trial_scp": str(data / "valid" / "wav.scp"),
            "max_epoch": SPK_EPOCHS,
            "num_iters_per_epoch": SPK_STEPS_PER_EPOCH, **extra})

    scfg, scfg_path = spk_cfg("train")
    svalid_if = SpeakerTask.build_iter_factory(scfg, train=False)
    asset_model, _ = SpeakerTask.build_model_from_file(scfg_path, SPK)
    trials_before = SpeakerTask.build_extra_valid_fn(scfg)(
        asset_model, 0)
    del asset_model
    rec = a5_train(torch, _cuda, spk_train.main, SpeakerTask, SpeakerModel,
                   scfg, scfg_path, SPK, {}, ("loss", "acc", "margin"),
                   svalid_if)
    margins = [s["margin"] for s in rec["steps"]]
    want_margins = ([0.0] * SPK_STEPS_PER_EPOCH
                    + [float(np.float32(0.3 / 5))] * SPK_STEPS_PER_EPOCH)
    paths["train_step"]["spk"] = rec["step_launches"]
    paths["valid_batch"]["spk"] = rec["valid_batch_launches"]
    _, gb = svalid_if.collate_fn([svalid_if.dataset[k] for k in
                                  svalid_if.dataset.keys()[:GRAD_BATCH]])
    emit({"phase": "spk_train", "n_train": SPK_N_TRAIN,
          "n_valid": SPK_N_VALID, "n_valid_trials": SPK_VALID_TRIALS,
          "trials_before": trials_before, **rec,
          "grad_check": grad_check(torch, SpeakerTask, scfg_path, SPK, gb),
          "determinism": determinism(SpeakerTask, spk_cfg, "spk")})
    if margins != want_margins:
        raise AssertionError(f"margins {margins}, not {want_margins}")
    for e, valid in rec["valid_per_epoch"].items():
        if not ("eer" in valid and "min_dcf" in valid):
            raise AssertionError(f"no trial EER in valid epoch {e}")

    # 35. cls: the cls1 recipe's model from the seed's weights, its test
    # batch on the card and the CPU, training, LID and ASVspoof
    cdir = workdir / "cls"
    cdata = cdir / "data"
    keys, speech, lens, cls_labels = cls_test
    cref = ref["cls"]
    energy_rel = max(abs(float(np.sum(np.square(w, dtype=np.float64))) / e
                         - 1) for w, e in zip(speech, cref["waves_energy"]))
    if not (list(speech.shape) == cref["shape"] and energy_rel <= 1e-6):
        raise AssertionError(f"the cls test batch differs from the JAX "
                             f"reference's (energy {energy_rel})")
    ccfg0 = resolve_config(ClassificationTask.default_config(),
                           overrides=cls_config_dict(cdata))
    dump_yaml(ccfg0, cdir / "config.yaml")
    weights = cdir / "seed.npz"
    np.savez(weights, **seed_flat(
        {k: v.shape for k, v in convert.state_dict_to_flax(
            ClassificationTask.build_model(ccfg0)).items()}, CLS_SEED))
    cs = ClassifySpeech(cdir / "config.yaml", weights)
    cs.logits(speech, lens)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    logits = cs.logits(speech, lens)
    torch.cuda.synchronize()
    cls_wall = time.perf_counter() - t0
    decode_launches = dict(_cuda.LAUNCHES)
    logits_cpu = ClassifySpeech(cdir / "config.yaml", weights,
                                device="cpu").logits(speech, lens)
    jlogits = unpack(cref["logits"])
    err_cpu = rel_err(torch.from_numpy(logits), torch.from_numpy(logits_cpu))
    err_jax = rel_err(torch.from_numpy(logits), torch.from_numpy(jlogits))
    preds = logits.argmax(-1)
    emit({"phase": "cls", "n_utts": len(keys), "shape": list(speech.shape),
          "logits_max_rel_from_cpu": err_cpu,
          "logits_max_rel_from_jax_cpu": err_jax, "tol": CLS_LOGIT_TOL,
          "predictions_differ_from_cpu": int((preds != logits_cpu.argmax(
              -1)).sum()),
          "predictions_differ_from_jax": int((preds != np.asarray(
              cref["predictions"])).sum()),
          "accuracy_seed_weights": float((preds == cls_labels).mean()),
          "decode_seconds": cls_wall,
          "audio_s_per_s": float(lens.sum()) / 16000 / cls_wall,
          "launches": decode_launches})
    if decode_launches != {n: int(n == "logmel_fwd")
                           for n in decode_launches}:
        raise AssertionError(f"cls decode launches {decode_launches}")
    if not (err_cpu <= CLS_LOGIT_TOL and err_jax <= CLS_LOGIT_TOL):
        raise AssertionError(f"cls logits {err_cpu} from the CPU's, "
                             f"{err_jax} from JAX's")
    if (preds != logits_cpu.argmax(-1)).any():
        raise AssertionError("cls predictions differ from the CPU's")
    paths["decode"]["cls"] = decode_launches

    def cls_cfg(name, task=ClassificationTask, **extra):
        return a5_config(task, cdir, cdir, name, weights=weights,
                         **{"num_iters_per_epoch": CLS_STEPS, **extra})

    ccfg, ccfg_path = cls_cfg("train")
    cvalid_if = ClassificationTask.build_iter_factory(ccfg, train=False)
    rec = a5_train(torch, _cuda, cls_train.main, ClassificationTask,
                   ClassificationModel, ccfg, ccfg_path, weights,
                   {"logmel_fwd": 1}, ("loss", "acc"), cvalid_if)
    paths["train_step"]["cls"] = rec["step_launches"]
    paths["valid_batch"]["cls"] = rec["valid_batch_launches"]
    _, again_path = cls_cfg("train_again")
    cls_train.main(["--config", str(again_path)])
    first = load_checkpoint(Path(ccfg["output_dir"]) / "checkpoint")[0]
    again = load_checkpoint(cdir / "train_again" / "checkpoint")[0]
    differ = sorted(k for k in first if not np.array_equal(first[k],
                                                           again[k]))
    _, gb = cvalid_if.collate_fn([cvalid_if.dataset[k] for k in
                                  cvalid_if.dataset.keys()[:GRAD_BATCH]])
    # LID and ASVspoof through their own entry points: 3 steps each over
    # the recipe's train dir (ASVspoof: the keyword's parity as its two
    # classes), then each inference CLI over 8 test utterances
    (cdata / "train" / "label2").write_text("".join(
        f"{k} {int(v) % 2}\n" for k, v in (
            line.split() for line in open(cdata / "train" / "label"))),
        encoding="utf-8")
    test_scp = cdir / "test8.scp"
    test_scp.write_text("".join(open(cdata / "test" / "wav.scp").readlines()
                                [:8]), encoding="utf-8")
    short = {}
    for name, task, train_mod, infer_mod, label, n_cls in (
            ("lid", LIDTask, lid_train, lid_inference, "label",
             CLS_N_KEYWORDS),
            ("asvspoof", ASVSpoofTask, asvspoof_train, asvspoof_inference,
             "label2", 2)):
        tcfg, tpath = cls_cfg(name, task=task, n_classes=n_cls,
                              num_iters_per_epoch=SHORT_STEPS,
                              init_param=None,
                              valid_data_path_and_name_and_type=[],
                              train_data_path_and_name_and_type=[
                                  f"{cdata}/train/wav.scp,speech,sound",
                                  f"{cdata}/train/{label},label,text_int"])
        _cuda.reset_launch_counts()
        _, trainer = train_mod.main(["--config", str(tpath)])
        train_launches = dict(_cuda.LAUNCHES)
        _cuda.reset_launch_counts()
        infer_mod.main(["--output_dir", str(cdir / f"{name}_out"),
                        "--data_path_and_name_and_type",
                        f"{test_scp},speech,sound",
                        "--train_config", str(tpath), "--model_file",
                        str(Path(tcfg["output_dir"]) / "checkpoint")])
        infer_launches = dict(_cuda.LAUNCHES)
        predicted = [int(line.split()[1]) for line in open(
            cdir / f"{name}_out" / "prediction")]
        short[name] = {"n_classes": n_cls, "steps": [
            {k: s[k] for k in ("loss", "acc", "grad_norm", "skipped")}
            for s in trainer.step_stats], "train_launches": train_launches,
            "predictions": predicted, "inference_launches": infer_launches}
        if not (len(trainer.step_stats) == SHORT_STEPS and all(
                math.isfinite(s["loss"]) and not s["skipped"]
                for s in trainer.step_stats)):
            raise AssertionError(f"{name}: {trainer.step_stats}")
        if not (len(predicted) == 8 and all(0 <= c < n_cls
                                            for c in predicted)):
            raise AssertionError(f"{name} predictions {predicted}")
        if (train_launches["logmel_fwd"] != SHORT_STEPS
                or infer_launches["logmel_fwd"] != 8):
            raise AssertionError(f"{name} launches {train_launches}, "
                                 f"{infer_launches}")
    emit({"phase": "cls_train", **rec, "rerun_n_differ": len(differ),
          "rerun_differs": differ[:5],
          "grad_check": grad_check(torch, ClassificationTask, ccfg_path,
                                   weights, gb),
          "determinism": determinism(ClassificationTask, cls_cfg, "cls"),
          **short})
    if differ:
        raise AssertionError(f"a second 10-step cls run differs in "
                             f"{len(differ)} parameters, e.g. {differ[:3]}")
    return paths


def check_gan_steps(steps, timer, want: dict, n_steps: int):
    """n_steps finite, unskipped GAN steps, each with the launches
    ``want`` (the kernels it does not name at 0)."""
    if len(steps) != n_steps or len(timer.steps) != n_steps:
        raise AssertionError(f"{len(steps)} GAN steps, not {n_steps}")
    for s, t in zip(steps, timer.steps):
        losses = [v for k, v in s.items() if k.endswith("_loss")
                  or k.startswith("grad_norm")]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"a non-finite GAN step: {s}")
        if s["skipped"] or s["skipped_d"]:
            raise AssertionError(f"a GAN turn was skipped: {s}")
        if t["launches"] != {n: want.get(n, 0) for n in t["launches"]}:
            raise AssertionError(f"launches per GAN step {t['launches']}, "
                                 f"not {want}")


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        run(torch, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def run(torch, workdir: Path):
    import torch.nn.functional as F

    from espnet_tpu_torch import convert
    from espnet_tpu_torch.bin import asr_train, asr_transducer_train
    from espnet_tpu_torch.bin.asr_inference import (Speech2Text,
                                                    decode_batches,
                                                    inference)
    from espnet_tpu_torch.bin.asr_transducer_inference import \
        Speech2TextTransducer
    from espnet_tpu_torch.data.dataset import ESPnetDataset
    from espnet_tpu_torch.data.synth_speech import (SynthSpeechCorpus,
                                                    concat_data_dir)
    from espnet_tpu_torch.decode.ctc_greedy import ctc_greedy_decode
    from espnet_tpu_torch.models.asr import ASRModel
    from espnet_tpu_torch.models.transducer import TransducerModel
    from espnet_tpu_torch.nn.initialize import init_like_flax
    from espnet_tpu_torch.ops import _cuda, rnnt
    from espnet_tpu_torch.ops.attention import (_launch_fwd, fused_attention,
                                                fused_attention_bwd,
                                                fused_attention_bwd_plain,
                                                fused_attention_plain,
                                                softmax_stats_plain)
    from espnet_tpu_torch.ops.logmel import (fused_logmel,
                                             fused_logmel_plain)
    from espnet_tpu_torch.models.tts.hifigan import mel_spectrogram_loss
    from espnet_tpu_torch.ops.losses import ctc_loss
    from espnet_tpu_torch.ops.mel import mel_matrix
    from espnet_tpu_torch.tasks import asr_transducer
    from espnet_tpu_torch.tasks.abs_task import parse_triples
    from espnet_tpu_torch.tasks.asr import ASRTask, build_model
    from espnet_tpu_torch.tasks.asr_transducer import ASRTransducerTask
    from espnet_tpu_torch.tools import rnnt_chain
    from espnet_tpu_torch.train.checkpoint import load_checkpoint
    from espnet_tpu_torch.train.trainer import evaluate
    from espnet_tpu_torch.utils.scoring import score_corpus

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # 2. build
    t0 = time.perf_counter()
    so = _cuda.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": _cuda.BUILD_SECONDS is not None,
          "library": str(so.relative_to(ROOT))})

    # the main path's model and batch
    s2t = Speech2Text(asr_train_config=ASSET / "config.yaml",
                      asr_model_file=ASSET, beam_size=BEAM,
                      ctc_weight=CTC_WEIGHT)
    model = s2t.model
    speech_np, lengths_np, refs = held_out_batch(
        SynthSpeechCorpus(), N_UTTS,
        s2t.cfg["collate_fixed_lengths"]["speech"])
    speech = torch.from_numpy(speech_np).cuda()
    lengths = torch.from_numpy(lengths_np).cuda()
    fe = model.frontend

    # the train path's data, config and first batch
    t0 = time.perf_counter()
    SynthSpeechCorpus().materialize(workdir / "data", n_train=N_TRAIN,
                                    n_valid=N_VALID, n_test=0)
    data_s = time.perf_counter() - t0
    cfg, cfg_path = train_config(ASRTask, ASSET, workdir, "flagship")
    train_if = ASRTask.build_iter_factory(cfg, train=True)
    valid_if = ASRTask.build_iter_factory(cfg, train=False)
    train_batch = first_batch(train_if, "cuda")

    # the transducer's model, config and first train batch (same data)
    s2tt = Speech2TextTransducer(train_config=TRANSDUCER / "config.yaml",
                                 model_file=TRANSDUCER,
                                 beam_size=TRANSDUCER_BEAM)
    tmodel = s2tt.model
    tcfg, tcfg_path = train_config(ASRTransducerTask, TRANSDUCER, workdir,
                                   "transducer")
    ttrain_if = ASRTransducerTask.build_iter_factory(tcfg, train=True)
    tvalid_if = ASRTransducerTask.build_iter_factory(tcfg, train=False)
    ttrain_batch = first_batch(ttrain_if, "cuda")

    # 3. the long-form data: recordings joined from the same data dirs;
    # the decode set is valid_long and two train_long recordings
    t0 = time.perf_counter()
    data = workdir / "data"
    long_recs = {split: concat_data_dir(data / split, data / f"{split}_long",
                                        LONG_MIN_SAMPLES)
                 for split in ("train", "valid")}
    dec_dir = data / "decode_long"
    dec_dir.mkdir()
    n_dec_train = LONG_DECODE_TRAIN
    dec_recs = long_recs["valid"] + long_recs["train"][:n_dec_train]
    for fname in ("wav.scp", "text"):
        lines = []
        for split, n in (("valid", None), ("train", n_dec_train)):
            lines += (data / f"{split}_long" / fname).read_text(
                encoding="utf-8").splitlines()[:n]
        (dec_dir / fname).write_text("\n".join(lines) + "\n",
                                     encoding="utf-8")
    long_s = time.perf_counter() - t0
    lcfg, lcfg_path = longform_config(workdir, "longform")
    tokenize = ASRTask.build_preprocess_fn(lcfg, train=True)
    emit({"phase": "longform_data", "seconds": long_s,
          "min_samples": LONG_MIN_SAMPLES} | {
        split: {"n": len(recs), "samples": [n for _, n, _ in recs],
                "frames": [encoder_frames(n, fe.hop_length)
                           for _, n, _ in recs],
                "tokens": [len(tokenize(u, {"text": t})["text"])
                           for u, _, t in recs]}
        for split, recs in (("train_long", long_recs["train"]),
                            ("valid_long", long_recs["valid"]),
                            ("decode_long", dec_recs))})
    if not all(encoder_frames(n, fe.hop_length) >= LONG_MIN_FRAMES
               for recs in long_recs.values() for _, n, _ in recs):
        raise AssertionError("a long-form recording below 2048 frames")
    n_long_steps = LONG_EPOCHS * -(-len(long_recs["train"]) // LONG_BATCH)
    if n_long_steps < LONG_MIN_STEPS or len(dec_recs) > LONG_BATCH:
        raise AssertionError(f"long-form data too small: {n_long_steps} "
                             f"steps, {len(dec_recs)} decode recordings")
    ltrain_if = ASRTask.build_iter_factory(lcfg, train=True)
    lvalid_if = ASRTask.build_iter_factory(lcfg, train=False)
    ltrain_batch = first_batch(ltrain_if, "cuda")
    # the model the entry point starts from: flax's initialisers from the
    # seed (they set every parameter, whatever torch drew before)
    lmodel = init_like_flax(build_model(lcfg), torch.Generator().manual_seed(
        lcfg["seed"])).to("cuda").eval()
    dec_ds = ESPnetDataset(parse_triples([f"{dec_dir}/wav.scp,speech,sound"]))

    # 4. kernels against their plain versions, at the paths' shapes: the
    # wave batch, the first conformer block's attention inputs of the
    # decode batch, and those of the first train batch for the backward
    captured = {}

    def capture(module, args):
        captured["args"] = args

    attn = model.encoder_mod.layers[0].self_attn
    hook = attn.register_forward_pre_hook(capture)
    with torch.no_grad():
        model.encode(speech, lengths)
        q, k, v, bias, sm_scale = attn.kernel_inputs(*captured["args"])
        model.encode(train_batch["speech"], train_batch["speech_lengths"])
        tq, tk, tv, tbias, _ = attn.kernel_inputs(*captured["args"])
        tq, tk, tv = tq.contiguous(), tk.contiguous(), tv.contiguous()
    hook.remove()
    B, H, T, d = q.shape
    with torch.no_grad():
        def k1():
            return fused_attention(q, k, v, bias, sm_scale=sm_scale)

        def k1_plain():
            return fused_attention_plain(q, k, v, bias, sm_scale=sm_scale)

        def k1_library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                                  scale=sm_scale)

        k1_err = float((k1() - k1_plain()).abs().max())
        # two launches on the same input give the same bits, stats too
        o1, s1 = _launch_fwd(q, k, v, bias, False, sm_scale, True)
        o2, s2 = _launch_fwd(q, k, v, bias, False, sm_scale, True)
        k1_same = bool(torch.equal(o1, o2) and torch.equal(s1, s2))
        del o1, s1, o2, s2
        # why the scores stay fp32 FMA on the CUDA cores: against float64,
        # the plain version's own error, and that of the same attention
        # with its scores formed as 3xTF32 tensor-core products
        ref64 = fused_attention_plain(q.double(), k.double(), v.double(),
                                      bias.double(), sm_scale=sm_scale)
        qh, kh = tf32_rna(torch, q), tf32_rna(torch, k)
        ql, kl = tf32_rna(torch, q - qh), tf32_rna(torch, k - kh)
        s3 = (ql @ kh.transpose(-1, -2) + qh @ kl.transpose(-1, -2)
              + qh @ kh.transpose(-1, -2)) * sm_scale + bias
        k1_precision = {
            "max_abs_score": float((q @ k.transpose(-1, -2)).abs().max())
            * sm_scale,
            "plain_vs_float64": float((k1_plain() - ref64).abs().max()),
            "kernel_vs_float64": float((k1() - ref64).abs().max()),
            "tf32x3_scores_vs_plain": float(
                (torch.softmax(s3, dim=-1) @ v - k1_plain()).abs().max())}
        del ref64, qh, kh, ql, kl, s3
        logmel_kw = dict(fs=fe.fs, n_fft=fe.n_fft, hop_length=fe.hop_length,
                         n_mels=fe.n_mels)
        window = torch.hann_window(fe.n_fft, device="cuda")
        melw = mel_matrix(fe.fs, fe.n_fft, fe.n_mels, 0.0, None, False,
                          "cuda:0")

        def k2():
            return fused_logmel(speech, **logmel_kw)

        def k2_plain():
            return fused_logmel_plain(speech, **logmel_kw)

        def stft_mel(wave):
            spec = torch.stft(wave, fe.n_fft, fe.hop_length, window=window,
                              center=True, pad_mode="reflect",
                              return_complex=True)
            power = spec.real.square() + spec.imag.square()
            return torch.log(torch.clamp(power.transpose(1, 2) @ melw,
                                         min=1e-10))

        def k2_library():
            return stft_mel(speech)

        out2, ref2 = k2(), k2_plain()
        sel = ref2 > float(torch.log(torch.tensor(K2_MIN_MEL)))
        k2_err = float((out2 - ref2)[sel].abs().max())
        k2_same = bool(torch.equal(out2, k2()))

        # K2 on the first long-form train batch (~1.1 M samples a row)
        lwave = ltrain_batch["speech"].float().contiguous()
        lout, lref = (fused_logmel(lwave, **logmel_kw),
                      fused_logmel_plain(lwave, **logmel_kw))
        lsel = lref > float(torch.log(torch.tensor(K2_MIN_MEL)))
        k2_long_err = float((lout - lref)[lsel].abs().max())
        del lout, lref, lsel

        # K2 at the GAN mel loss's shape (16, 8192): 16 centred crops of
        # 8192 samples of the held-out utterances (the vocoder's valid
        # crop and its featurize batch), and the mel loss between them
        # and a perturbed copy, through the kernel and the plain version
        mwave = torch.stack([F.pad(
            speech[j, max((int(lengths_np[j]) - MEL_SEG) // 2, 0):][
                :MEL_SEG], (0, max(MEL_SEG - int(lengths_np[j]), 0)))
            for j in range(MEL_BATCH)]).contiguous()
        mfake = mwave + 0.01 * torch.randn(
            mwave.shape, device="cuda",
            generator=torch.Generator("cuda").manual_seed(0))
        mout, mref = (fused_logmel(mwave, **logmel_kw),
                      fused_logmel_plain(mwave, **logmel_kw))
        msel = mref > float(torch.log(torch.tensor(K2_MIN_MEL)))
        k2_mel_err = float((mout - mref)[msel].abs().max())
        k2_mel_same = bool(torch.equal(mout, fused_logmel(mwave,
                                                          **logmel_kw)))
        mel_loss_kernel = float(mel_spectrogram_loss(mfake, mwave,
                                                     **logmel_kw))
        mel_loss_plain = float((fused_logmel_plain(mfake, **logmel_kw)
                                - mref).abs().mean())
        k2_mel_loss_rel = abs(mel_loss_kernel / mel_loss_plain - 1)
        del mout, mref, msel

    # K1b: the kernel through autograd against the plain version's
    # autograd, with every input (the bias too) needing a gradient
    def backward_errors(q_, k_, v_, b_, causal, scale, seed):
        ins = [t.detach().clone().requires_grad_() for t in (q_, k_, v_, b_)]
        g = torch.Generator(device="cuda").manual_seed(seed)
        dout = torch.randn(q_.shape, generator=g, device="cuda")
        kern = torch.autograd.grad(
            fused_attention(*ins, causal=causal, sm_scale=scale), ins, dout)
        plain = torch.autograd.grad(
            fused_attention_plain(*ins, causal=causal, sm_scale=scale), ins,
            dout)
        return {name: {"max_abs_err": float((a - b).abs().max()),
                       "rel_err": rel_err(a, b)}
                for name, a, b in zip(("dq", "dk", "dv", "dbias"), kern,
                                      plain)}

    g = torch.Generator(device="cuda").manual_seed(0)
    cq, ck, cv = (torch.randn(2, 3, T_, 40, generator=g, device="cuda")
                  for T_ in (70, 50, 50))
    cbias = torch.randn(2, 3, 70, 50, generator=g, device="cuda")
    k1b_errs = {"train": backward_errors(tq, tk, tv, tbias, False, sm_scale,
                                         1),
                "causal_tq_ne_tk": backward_errors(cq, ck, cv, cbias, True,
                                                   40 ** -0.5, 2)}
    k1b_err = max(e["rel_err"] for case in k1b_errs.values()
                  for e in case.values())
    Bt, Ht, Tt, dt = tq.shape
    with torch.no_grad():
        tout = fused_attention_plain(tq, tk, tv, tbias, sm_scale=sm_scale)
        tstats = softmax_stats_plain(tq, tk, tbias, sm_scale=sm_scale)
        tdout = torch.randn(tq.shape, generator=g, device="cuda")

    def k1b():
        return fused_attention_bwd(tq, tk, tv, tbias, tout, tstats, tdout,
                                   sm_scale=sm_scale)

    def k1b_plain():
        return fused_attention_bwd_plain(tq, tk, tv, tbias, tout, tstats,
                                         tdout, sm_scale=sm_scale)

    lib_ins = [t.detach().clone().requires_grad_()
               for t in (tq, tk, tv, tbias)]
    lib_out = F.scaled_dot_product_attention(*lib_ins[:3],
                                             attn_mask=lib_ins[3],
                                             scale=sm_scale)

    def k1b_library():
        return torch.autograd.grad(lib_out, lib_ins, tdout,
                                   retain_graph=True)

    try:
        k1b_library_ms, k1b_library_note = time_ms(torch, k1b_library), None
    except RuntimeError as e:   # a yardstick only: no backend may take it
        k1b_library_ms, k1b_library_note = None, str(e)[:300]
    # two launches at the path's shape give the same bits
    k1b_same = all(torch.equal(a, b) for a, b in zip(k1b(), k1b()))

    # K3: the lattice sweeps on the transducer's joint logits of its first
    # train batch (real ragged T_b and U_b), and on a small ragged case
    # with U_b = 0 and T_b < T; nll, alpha, beta and the closed-form
    # dlogits against the plain sweeps plus the same assembly
    def k3_case(logits, labels, tl, ul):
        lat = rnnt.lattices(logits, labels, tl, ul)
        alpha, nll = rnnt.rnnt_alpha(*lat, tl, ul)
        beta = rnnt.rnnt_beta(*lat, tl, ul)
        alpha0, nll0 = rnnt.rnnt_alpha_plain(*lat, tl, ul)
        beta0 = rnnt.rnnt_beta_plain(*lat, tl, ul)
        grad = rnnt.rnnt_grad(logits, labels, *lat, alpha, beta, nll, tl,
                              ul)
        grad0 = rnnt.rnnt_grad(logits, labels, *lat, alpha0, beta0, nll0,
                               tl, ul)
        inside = alpha0 > rnnt.NEG_INF / 2
        if not (torch.equal(inside, alpha > rnnt.NEG_INF / 2)
                and torch.equal(inside, beta > rnnt.NEG_INF / 2)
                and torch.equal(inside, beta0 > rnnt.NEG_INF / 2)):
            raise AssertionError("rnnt sweeps: the lattices' extents differ")
        errs = {"nll": (nll, nll0), "alpha": (alpha[inside], alpha0[inside]),
                "beta": (beta[inside], beta0[inside]),
                "dlogits": (grad, grad0)}
        return lat, {key: {"max_abs_err": float((a - b).abs().max()),
                           "rel_err": rel_err(a, b)}
                     for key, (a, b) in errs.items()}

    with torch.no_grad():
        enc, enc_lens = tmodel.encode(ttrain_batch["speech"],
                                      ttrain_batch["speech_lengths"])
        text, text_lens = ttrain_batch["text"], ttrain_batch["text_lengths"]
        tlogits = tmodel.lattice_logits(enc, text)
        k3_errs = {}
        k3_lat, k3_errs["train"] = k3_case(tlogits, text, enc_lens,
                                           text_lens)
        g3 = torch.Generator(device="cuda").manual_seed(3)
        # U+1 = 1 (a cell a row), a small ragged case, and U+1 = 300, past
        # one warp's 256 cells: the path of a block of warps
        for name, (B_, T_, U1_, tl_, ul_) in {
                "u1_1": (3, 6, 1, [6, 0, 2], [0, 0, 0]),
                "ragged": (3, 7, 5, [7, 1, 4], [0, 4, 2]),
                "u1_300": (2, 9, 300, [9, 5], [299, 120])}.items():
            _, k3_errs[name] = k3_case(
                torch.randn(B_, T_, U1_, 6, generator=g3, device="cuda"),
                torch.randint(1, 6, (B_, U1_ - 1), generator=g3,
                              device="cuda"),
                torch.tensor(tl_, device="cuda"),
                torch.tensor(ul_, device="cuda"))
    k3_err = max(e["rel_err"] for case in k3_errs.values()
                 for e in case.values())
    # the sweeps take each cell's two terms in the plain sweeps' order:
    # nll, alpha, beta and so dlogits equal theirs to the bit
    k3_exact = all(e["max_abs_err"] == 0 for case in k3_errs.values()
                   for e in case.values())
    Bk, Tk3, U1k, Vk = tlogits.shape

    k3_args = (*k3_lat, enc_lens, text_lens)
    with torch.no_grad():
        k3_runs = [(*rnnt.rnnt_alpha(*k3_args), rnnt.rnnt_beta(*k3_args))
                   for _ in range(2)]
    k3_same = all(torch.equal(a, b) for a, b in zip(*k3_runs))
    del k3_runs
    # the chain floor: the longest sample's diagonals times the latency of
    # one diagonal's dependent step (a shuffle and one cell's log-add; a
    # lane's other cells are independent of it), read on this card by the
    # probe of tools/rnnt_chain.py, at the SM clock nvidia-smi reports as
    # the card's most
    k3_chain = rnnt_chain.measure()
    k3_diagonals = int((enc_lens.clamp(max=Tk3)
                        + text_lens.clamp(max=U1k - 1)).max())
    for sweep in ("alpha", "beta"):
        k3_chain[f"{sweep}_floor_ms"] = (
            k3_diagonals * k3_chain[f"{sweep}_cycles_per_diagonal"]
            / (k3_chain["clocks_max_sm_mhz"] * 1e3))
    k3_chain["diagonals"] = k3_diagonals
    # the cells inside each sample's lattice: the sweeps' data-dependent
    # work, ~9 operations each (two adds and a log-add)
    k3_cells = float(((enc_lens.clamp(max=Tk3))
                      * (text_lens.clamp(max=U1k - 1) + 1)).sum())
    # K4 and K4b, their tensors freed on return (the train phases' peak
    # memory would count them)
    _, dspeech, dlens, _ = next(decode_batches(dec_ds, dec_ds.keys(),
                                               LONG_BATCH))
    banded = banded_checks(torch, lmodel, torch.from_numpy(dspeech).cuda(),
                           torch.from_numpy(dlens).long().cuda(),
                           ltrain_batch)
    # K1 and K1b at the Conformer separator's shapes (head size 32)
    sep_attn = separator_attention_checks(torch, workdir)

    Bw, S = speech.shape
    nf, n_fft = fe.n_fft // 2 + 1, fe.n_fft
    mel_nnz = int((melw != 0).sum())

    # the least work of K1 and K2 at a shape: K1's two products of the
    # attention with q, k, v and the bias read and the output written; for
    # K2 an FFT (2.5 N log2 N per frame), the window, the power and only the
    # nonzero mel weights, with the wave read and the log-mel written
    def k1_work(q_, b_):
        B_, H_, T_, d_ = q_.shape
        return {"flops": 4.0 * B_ * H_ * T_ * T_ * d_,
                "bytes": 4.0 * (4 * B_ * H_ * T_ * d_ + b_.numel())}

    def k2_work(wave):
        B_, S_ = wave.shape
        frames = B_ * (S_ // fe.hop_length + 1)
        return {"flops": frames * (2.5 * n_fft * math.log2(n_fft) + n_fft
                                   + 3 * nf + 2 * mel_nnz + fe.n_mels),
                "bytes": 4.0 * (B_ * S_ + n_fft + mel_nnz
                                + frames * fe.n_mels)}

    with torch.no_grad():
        k1_train = {"shape": list(tq.shape), **k1_work(tq, tbias),
                    "ms": time_ms(torch, lambda: fused_attention(
                        tq, tk, tv, tbias, sm_scale=sm_scale)),
                    "plain_ms": time_ms(torch, lambda: fused_attention_plain(
                        tq, tk, tv, tbias, sm_scale=sm_scale)),
                    "library_ms": time_ms(torch, lambda: (
                        F.scaled_dot_product_attention(
                            tq, tk, tv, attn_mask=tbias, scale=sm_scale)))}
        k2_long = {"shape": list(lwave.shape), "max_abs_err": k2_long_err,
                   **k2_work(lwave),
                   "ms": time_ms(torch, lambda: fused_logmel(lwave,
                                                             **logmel_kw)),
                   "plain_ms": time_ms(torch, lambda: fused_logmel_plain(
                       lwave, **logmel_kw)),
                   "library_ms": time_ms(torch, lambda: stft_mel(lwave))}
        k2_mel = {"shape": list(mwave.shape), "max_abs_err": k2_mel_err,
                  "same_bits_twice": k2_mel_same,
                  "mel_loss": {"kernel": mel_loss_kernel,
                               "plain": mel_loss_plain,
                               "rel_diff": k2_mel_loss_rel,
                               "tol": K2_MEL_LOSS_TOL},
                  **k2_work(mwave),
                  "ms": time_ms(torch, lambda: fused_logmel(mwave,
                                                            **logmel_kw)),
                  "plain_ms": time_ms(torch, lambda: fused_logmel_plain(
                      mwave, **logmel_kw)),
                  "library_ms": time_ms(torch, lambda: stft_mel(mwave))}
        bound(k1_train, tensor_cores=True)
        bound(k2_long)
        bound(k2_mel)
        # the device kernels behind each time at the decode shapes: which
        # kernels SDPA and torch.stft run, and each one's device time
        profiled = device_times(torch, {
            "flash_attn_fwd": k1, "sdpa": k1_library,
            "logmel_fwd": k2, "stft_mel": k2_library,
            "rnnt_alpha": lambda: rnnt.rnnt_alpha(*k3_args),
            "rnnt_beta": lambda: rnnt.rnnt_beta(*k3_args)})
    # and behind the attention backward and SDPA's at the train shape
    profiled |= device_times(torch, {"flash_attn_bwd": k1b} | (
        {"sdpa_bwd": k1b_library} if k1b_library_ms is not None else {}))
    # K2 at the shapes of phases 29, 31 and 35 (checked and profiled here,
    # where the profiler sees the kernel: late in a run it listed none of
    # its launches): the diarization decode's first batch, 8 seeded test
    # dialogs, and the codec mel loss's (8, 74560), 8 held-out utterances
    # cut to the codec's hop
    import numpy as np

    from espnet_tpu_torch.data.synth_speech import dialogs
    from espnet_tpu_torch.utils.config import load_yaml
    dwaves, _ = dialogs("test", DIAR_BATCH, DIAR_TEST_SEED)
    a5_k2 = {
        "at_diar_decode_shape": k2_at(
            torch, torch.from_numpy(np.stack(dwaves)).cuda(), fs=16000,
            **load_yaml(DIAR / "config.yaml")["frontend_conf"]),
        "at_codec_mel_loss_shape": k2_at(
            torch, speech[:CODEC_BATCH, :(74656 // 320) * 320], fs=16000,
            n_fft=256, hop_length=64, n_mels=40)}
    # and at the cls1 recipe's test batch (phase 35): its 200 keywords
    # written as WAVs and read back, in one batch at the bucket of the
    # longest, the recipe's frontend
    from espnet_tpu_torch.data.batching import bucket_length
    from espnet_tpu_torch.data.fileio import read_wav, write_wav
    cls_test = cls_data(SynthSpeechCorpus(n_words=CLS_N_KEYWORDS,
                                          min_words=1, max_words=1),
                        write_wav, read_wav, bucket_length,
                        workdir / "cls" / "data")
    a5_k2["at_cls_shape"] = k2_at(
        torch, torch.from_numpy(cls_test[1]).cuda(), fs=16000, n_fft=512,
        hop_length=128, n_mels=80)

    checks = [
        {"name": "flash_attn_fwd", "shape": [B, H, T, d], "tol": K1_TOL,
         "same_bits_twice": k1_same, "score_precision": k1_precision},
        {"name": "flash_attn_bwd", "shape": [Bt, Ht, Tt, dt],
         "tol": K1B_TOL, "tol_of": "max abs err / max |plain|",
         "same_bits_twice": k1b_same, "cases": k1b_errs},
        {"name": "logmel_fwd", "shape": [Bw, S], "tol": K2_TOL,
         "min_mel": K2_MIN_MEL,
         "max_abs_err_all_frames": float((out2 - ref2).abs().max()),
         "same_bits_twice": k2_same,
         "long_form": {"shape": list(lwave.shape),
                       "max_abs_err": k2_long_err},
         "mel_loss_shape": {"shape": list(mwave.shape),
                            "max_abs_err": k2_mel_err,
                            "same_bits_twice": k2_mel_same,
                            "mel_loss_rel_diff": k2_mel_loss_rel}},
        {"name": "flash_attn_fwd+flash_attn_bwd at the Conformer "
                 "separator's shapes", "shape": sep_attn["fwd"]["shape"],
         "train_shape": sep_attn["bwd"]["shape"],
         "max_abs_err": sep_attn["fwd"]["max_abs_err"],
         "same_bits_twice": sep_attn["fwd"]["same_bits_twice"],
         "backward": sep_attn["bwd"]["errors"],
         "backward_same_bits_twice": sep_attn["bwd"]["same_bits_twice"]},
        {"name": "rnnt_alpha+rnnt_beta", "shape": [Bk, Tk3, U1k, Vk],
         "tol": K3_TOL, "tol_of": "max abs err / max |plain|",
         "bit_exact": k3_exact, "same_bits_twice": k3_same,
         "chain": k3_chain,
         "T_b": enc_lens.tolist(), "U_b": text_lens.tolist(),
         "cases": k3_errs},
        *banded["checks"],
    ]
    # the least work of each function, for its bound: K1 and K2 as above;
    # K1b's five products (q k^T, do v^T, P^T do, dS^T q, dS k) with q, k,
    # v, o, do and the bias read and dq, dk, dv and dbias written; for K3
    # the blank and emit entries inside each sample's lattice read, the
    # whole (B, T, U+1) lattice written
    kernels = [
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "espnet_tpu_torch/csrc/flash_attn.cu",
         "replaces": "espnet_tpu/ops/attention_kernels.py:31",
         "max_abs_err": k1_err,
         "ms": time_ms(torch, k1), "plain_ms": time_ms(torch, k1_plain),
         "library_ms": time_ms(torch, k1_library),
         "library_note": ("scaled_dot_product_attention with the float "
                          "bias as attn_mask"),
         **k1_work(q, bias), "at_train_shape": k1_train,
         "device_kernels": {"kernel": profiled["flash_attn_fwd"],
                            "library": profiled["sdpa"]}},
        {"name": "flash_attn_bwd", "route": "cuda",
         "source": "espnet_tpu_torch/csrc/flash_attn_bwd.cu",
         "replaces": ("jax/experimental/pallas/ops/tpu/flash_attention.py"
                      ":254 (_flash_attention_bwd, reached from "
                      "espnet_tpu/ops/attention_kernels.py:55)"),
         "max_abs_err": max(e["max_abs_err"] for e in
                            k1b_errs["train"].values()),
         "ms": time_ms(torch, k1b), "plain_ms": time_ms(torch, k1b_plain),
         "library_ms": k1b_library_ms,
         "library_note": k1b_library_note or (
             "autograd backward of scaled_dot_product_attention with the "
             "float bias needing a gradient"),
         "device_kernels": {"kernel": profiled["flash_attn_bwd"],
                            "library": profiled.get("sdpa_bwd")},
         "flops": 10.0 * Bt * Ht * Tt * Tt * dt,
         "bytes": 4.0 * (8 * Bt * Ht * Tt * dt + 2 * Bt * Ht * Tt * Tt)},
        {"name": "logmel_fwd", "route": "cuda",
         "source": "espnet_tpu_torch/csrc/logmel.cu",
         "replaces": "espnet_tpu/ops/pallas/logmel_kernel.py:35",
         "max_abs_err": k2_err,
         "ms": time_ms(torch, k2), "plain_ms": time_ms(torch, k2_plain),
         "library_ms": time_ms(torch, k2_library),
         "library_note": "torch.stft, the power and the mel product",
         **k2_work(speech), "at_long_form_train_batch": k2_long,
         "at_mel_loss_shape": k2_mel,
         "device_kernels": {"kernel": profiled["logmel_fwd"],
                            "library": profiled["stft_mel"]}},
        {"name": "rnnt_alpha", "route": "cuda",
         "source": "espnet_tpu_torch/csrc/rnnt.cu",
         "replaces": ("espnet_tpu/ops/pallas/rnnt_kernel.py:53 (_alpha_kernel"
                      ", launched by _sweep's pallas_call :118)"),
         "max_abs_err": max(k3_errs["train"][key]["max_abs_err"]
                            for key in ("alpha", "nll")),
         "ms": time_ms(torch, lambda: rnnt.rnnt_alpha(*k3_args)),
         "plain_ms": time_ms(torch, lambda: rnnt.rnnt_alpha_plain(*k3_args)),
         "chain_floor_ms": k3_chain["alpha_floor_ms"],
         "device_kernels": {"kernel": profiled["rnnt_alpha"]},
         "library_ms": None,
         "library_note": ("no PyTorch call computes the RNN-T loss "
                          "(torchaudio's rnnt_loss is not installed here)"),
         "flops": 9.0 * k3_cells,
         "bytes": 4.0 * (2 * k3_cells + Bk * Tk3 * U1k + Bk)},
        {"name": "rnnt_beta", "route": "cuda",
         "source": "espnet_tpu_torch/csrc/rnnt.cu",
         "replaces": ("espnet_tpu/ops/pallas/rnnt_kernel.py:75 (_beta_kernel"
                      ", launched by _sweep's pallas_call :118)"),
         "max_abs_err": k3_errs["train"]["beta"]["max_abs_err"],
         "ms": time_ms(torch, lambda: rnnt.rnnt_beta(*k3_args)),
         "plain_ms": time_ms(torch, lambda: rnnt.rnnt_beta_plain(*k3_args)),
         "chain_floor_ms": k3_chain["beta_floor_ms"],
         "device_kernels": {"kernel": profiled["rnnt_beta"]},
         "library_ms": None,
         "library_note": ("no PyTorch call computes the RNN-T loss "
                          "(torchaudio's rnnt_loss is not installed here)"),
         "flops": 9.0 * k3_cells,
         "bytes": 4.0 * (2 * k3_cells + Bk * Tk3 * U1k)},
        *banded["kernels"],
    ]
    for kern in kernels:
        bound(kern, tensor_cores="attn" in kern["name"])
    emit({"phase": "kernel_checks", "checks": checks})
    if not k1_err <= K1_TOL:
        raise AssertionError(f"flash_attn_fwd disagrees: {k1_err}")
    if not (k1_same and k2_same and k1b_same and banded["k4_same"]
            and banded["k4b_same"]):
        raise AssertionError("a second launch on the same input gave other "
                             f"bits: flash_attn_fwd {k1_same}, logmel_fwd "
                             f"{k2_same}, flash_attn_bwd {k1b_same}, "
                             f"banded_attn_fwd {banded['k4_same']}, "
                             f"banded_attn_bwd {banded['k4b_same']}")
    if not k2_long_err <= K2_TOL:
        raise AssertionError(f"logmel_fwd disagrees on the long-form "
                             f"batch: {k2_long_err}")
    if not (k2_mel_err <= K2_TOL and k2_mel_same
            and k2_mel_loss_rel <= K2_MEL_LOSS_TOL):
        raise AssertionError(f"logmel_fwd at the mel loss's shape: error "
                             f"{k2_mel_err}, same bits {k2_mel_same}, mel "
                             f"loss {k2_mel_loss_rel}")
    if not k1b_err <= K1B_TOL:
        raise AssertionError(f"flash_attn_bwd disagrees: {k1b_errs}")
    if not k2_err <= K2_TOL:
        raise AssertionError(f"logmel_fwd disagrees: {k2_err}")
    if not (k3_err <= K3_TOL and k3_exact):
        raise AssertionError(f"rnnt sweeps disagree: {k3_errs}")
    if not k3_same:
        raise AssertionError("rnnt sweeps: a second launch on the same "
                             "input gave other bits")
    if not banded["k4_err"] <= K4_TOL:
        raise AssertionError(f"banded_attn_fwd disagrees: "
                             f"{banded['checks'][0]}")
    if not banded["k4b_err"] <= K4B_TOL:
        raise AssertionError(f"banded_attn_bwd disagrees: "
                             f"{banded['checks'][1]}")

    # 5. main path: one warm-up decode, then the counted and timed one,
    # then REPEATS more timed ones for the spread
    s2t(speech, lengths)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    out = s2t(speech, lengths)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    decode_launches = dict(_cuda.LAUNCHES)
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        s2t(speech, lengths)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    # the share of the frontend and encoder, timed alone
    t0 = time.perf_counter()
    with torch.no_grad():
        model.encode(speech, lengths)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    hyps = [nbest[0][0] for nbest in out]
    words = score_corpus(refs, hyps, "word")
    wer = words["err_rate"]
    cer = score_corpus(refs, hyps, "char")["err_rate"]
    audio_s = float(lengths_np.sum()) / fe.fs
    emit({"phase": "main_path", "n_utts": N_UTTS, "beam": BEAM,
          "ctc_weight": CTC_WEIGHT, "batch_shape": list(speech.shape),
          "wer": wer, "cer": cer, "ref_words": words["ref_len"],
          "word_errors": words["sub"] + words["del"] + words["ins"],
          "audio_seconds": audio_s,
          "wall_seconds": walls, "encode_seconds": encode_s,
          "audio_s_per_s_median": audio_s / wall,
          "launches": decode_launches,
          "examples": [[r, h] for r, h in zip(refs[:3], hyps[:3])]})
    if len(out) != N_UTTS or not all(nbest and nbest[0][2]
                                     for nbest in out):
        raise AssertionError("an utterance decoded to nothing")
    for name in ("flash_attn_fwd", "logmel_fwd"):
        if decode_launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    if not wer <= MAX_WER:
        raise AssertionError(f"WER {wer} above {MAX_WER}")

    # 6. train path: the flagship's validation before, then the entry
    # point, then a reload of its checkpoint into a fresh model
    before = evaluate(model, valid_if, "cuda")
    trainer, per_step, train_launches, train_wall, peak_bytes = train_run(
        torch, _cuda, asr_train.main, cfg_path, ASRModel)
    steps = trainer.step_stats
    epochs = cfg["max_epoch"]
    after = trainer.reporter.stats[epochs]["valid"]
    flat, _, meta = load_checkpoint(Path(cfg["output_dir"]) / "checkpoint")
    fresh = convert.load_flax_params(build_model(cfg), flat).to("cuda")
    reloaded = evaluate(fresh, valid_if, "cuda")
    step_ms = [1e3 * s["train_time"] for s in steps]
    emit({"phase": "train_path", "n_train": N_TRAIN, "n_valid": N_VALID,
          "batch_size": TRAIN_BATCH, "data_seconds": data_s,
          "batch_shape": list(train_batch["speech"].shape),
          "steps": [{k: s[k] for k in ("loss", "loss_ctc", "loss_att",
                                       "acc", "grad_norm", "skipped")}
                    | {"ms": ms, "launches": n}
                    for s, ms, n in zip(steps, step_ms, per_step)],
          "step_ms_median_3_10": statistics.median(step_ms[2:]),
          "peak_memory_bytes": peak_bytes, "wall_seconds": train_wall,
          "launches": train_launches,
          "valid_before": before, "valid_after": after,
          "valid_reloaded": reloaded, "checkpoint_epoch": meta["epoch"]})
    want = {"flash_attn_fwd": 6, "flash_attn_bwd": 12, "logmel_fwd": 1,
            "rnnt_alpha": 0, "rnnt_beta": 0, "banded_attn_fwd": 0,
            "banded_attn_bwd": 0}
    check_steps(steps, per_step, want, ("loss", "loss_ctc", "loss_att"))
    if not after["acc"] >= before["acc"] - ACC_MARGIN:
        raise AssertionError(f"validation accuracy fell: {before['acc']} -> "
                             f"{after['acc']}")
    if not abs(reloaded["loss"] / after["loss"] - 1) <= RELOAD_TOL:
        raise AssertionError(f"the reloaded checkpoint's validation loss "
                             f"{reloaded['loss']} != {after['loss']}")

    # 7. one step's gradients, card against CPU, on a fixed batch
    _, batch = valid_if.collate_fn([valid_if.dataset[k] for k in
                                    valid_if.epoch_batches(0)[0][:GRAD_BATCH]])
    emit({"phase": "grad_check"} | grad_check(
        torch, ASRTask, ASSET / "config.yaml", ASSET, batch))

    # 8. the transducer's decode: as main_path
    s2tt(speech, lengths)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    tout = s2tt(speech, lengths)
    torch.cuda.synchronize()
    twalls = [time.perf_counter() - t0]
    tdecode_launches = dict(_cuda.LAUNCHES)
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        s2tt(speech, lengths)
        torch.cuda.synchronize()
        twalls.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    with torch.no_grad():
        tmodel.encode(speech, lengths)
    torch.cuda.synchronize()
    tencode_s = time.perf_counter() - t0
    thyps = [nbest[0][0] for nbest in tout]
    twords = score_corpus(refs, thyps, "word")
    emit({"phase": "transducer_decode", "n_utts": N_UTTS,
          "beam": TRANSDUCER_BEAM, "batch_shape": list(speech.shape),
          "wer": twords["err_rate"],
          "cer": score_corpus(refs, thyps, "char")["err_rate"],
          "ref_words": twords["ref_len"],
          "word_errors": twords["sub"] + twords["del"] + twords["ins"],
          "wer_limit": MAX_TRANSDUCER_WER,
          "wall_seconds": twalls, "encode_seconds": tencode_s,
          "audio_s_per_s_median": audio_s / statistics.median(twalls),
          "launches": tdecode_launches,
          "examples": [[r, h] for r, h in zip(refs[:3], thyps[:3])]})
    if len(tout) != N_UTTS or not all(nbest and nbest[0][2]
                                      for nbest in tout):
        raise AssertionError("an utterance decoded to nothing")
    want_decode = {"flash_attn_fwd": 0, "flash_attn_bwd": 0, "logmel_fwd": 1,
                   "rnnt_alpha": 0, "rnnt_beta": 0, "banded_attn_fwd": 0,
                   "banded_attn_bwd": 0}
    if tdecode_launches != want_decode:
        raise AssertionError(f"transducer decode launches {tdecode_launches}"
                             f", not {want_decode}")
    if not twords["err_rate"] <= MAX_TRANSDUCER_WER:
        raise AssertionError(f"transducer WER {twords['err_rate']} above "
                             f"{MAX_TRANSDUCER_WER}")

    # 9. the transducer's training: as train_path
    tbefore = evaluate(tmodel, tvalid_if, "cuda")
    ttrainer, tper_step, ttrain_launches, ttrain_wall, tpeak = train_run(
        torch, _cuda, asr_transducer_train.main, tcfg_path, TransducerModel)
    tsteps = ttrainer.step_stats
    tafter = ttrainer.reporter.stats[1]["valid"]
    flat, _, tmeta = load_checkpoint(Path(tcfg["output_dir"])
                                     / "checkpoint")
    fresh = convert.load_flax_params(asr_transducer.build_model(tcfg),
                                     flat).to("cuda")
    treloaded = evaluate(fresh, tvalid_if, "cuda")
    tstep_ms = [1e3 * s["train_time"] for s in tsteps]
    emit({"phase": "transducer_train", "batch_size": TRAIN_BATCH,
          "batch_shape": list(ttrain_batch["speech"].shape),
          "steps": [{k: s[k] for k in ("loss", "loss_rnnt", "loss_aux_ctc",
                                       "grad_norm", "skipped")}
                    | {"ms": ms, "launches": n}
                    for s, ms, n in zip(tsteps, tstep_ms, tper_step)],
          "step_ms_median_3_10": statistics.median(tstep_ms[2:]),
          "peak_memory_bytes": tpeak, "wall_seconds": ttrain_wall,
          "launches": ttrain_launches,
          "valid_before": tbefore, "valid_after": tafter,
          "valid_reloaded": treloaded, "checkpoint_epoch": tmeta["epoch"]})
    twant = {"flash_attn_fwd": 0, "flash_attn_bwd": 0, "logmel_fwd": 1,
             "rnnt_alpha": 1, "rnnt_beta": 1, "banded_attn_fwd": 0,
             "banded_attn_bwd": 0}
    check_steps(tsteps, tper_step, twant,
                ("loss", "loss_rnnt", "loss_aux_ctc"))
    if not abs(treloaded["loss"] / tafter["loss"] - 1) <= RELOAD_TOL:
        raise AssertionError(f"the reloaded transducer checkpoint's "
                             f"validation loss {treloaded['loss']} != "
                             f"{tafter['loss']}")

    # 10. the transducer's gradients, card against CPU
    _, batch = tvalid_if.collate_fn(
        [tvalid_if.dataset[k]
         for k in tvalid_if.epoch_batches(0)[0][:GRAD_BATCH]])
    emit({"phase": "transducer_grad_check"}
         | grad_check(torch, ASRTransducerTask, TRANSDUCER / "config.yaml",
                      TRANSDUCER, batch))

    # 11. the long-form model's training: as train_path, from the seed's
    # flax-default initialisation, over 3 epochs of the long recordings
    lbefore = evaluate(lmodel, lvalid_if, "cuda")
    ltrainer, lper_step, ltrain_launches, ltrain_wall, lpeak = train_run(
        torch, _cuda, asr_train.main, lcfg_path, ASRModel)
    lsteps = ltrainer.step_stats
    lafter = ltrainer.reporter.stats[LONG_EPOCHS]["valid"]
    lout = Path(lcfg["output_dir"])
    flat, _, lmeta = load_checkpoint(lout / "checkpoint")
    fresh = convert.load_flax_params(build_model(lcfg), flat).to("cuda")
    lreloaded = evaluate(fresh, lvalid_if, "cuda")
    del fresh
    lstep_ms = [1e3 * s["train_time"] for s in lsteps]
    # the closed-form CTC's share of a step, by the host clock: its
    # forward and backward alone (loops over the batch's T' frames) on the
    # first train batch's CTC logits, median of 3 after a warm-up
    with torch.no_grad():
        lenc, lenc_lens = lmodel.encode(ltrain_batch["speech"],
                                        ltrain_batch["speech_lengths"])
        ctc_logits = lmodel.ctc_logits(lenc)
    ctc_ms = []
    for _ in range(4):
        x = ctc_logits.clone().requires_grad_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctc_loss(x, lenc_lens, ltrain_batch["text"],
                 ltrain_batch["text_lengths"], lmodel.blank_id).backward()
        torch.cuda.synchronize()
        ctc_ms.append(1e3 * (time.perf_counter() - t0))
    ctc_ms = statistics.median(ctc_ms[1:])
    emit({"phase": "longform_train", "batch_size": LONG_BATCH,
          "epochs": LONG_EPOCHS,
          "batch_shape": list(ltrain_batch["speech"].shape),
          "encoder_frames_padded": banded["checks"][1]["shape"][2],
          "steps": [{k: s[k] for k in ("loss", "loss_ctc", "loss_att",
                                       "acc", "grad_norm", "skipped")}
                    | {"ms": ms, "launches": n}
                    for s, ms, n in zip(lsteps, lstep_ms, lper_step)],
          "step_ms_median_3_on": statistics.median(lstep_ms[2:]),
          "ctc_fwd_bwd_ms": ctc_ms,
          "ctc_share_of_step": ctc_ms / statistics.median(lstep_ms[2:]),
          "peak_memory_bytes": lpeak, "wall_seconds": ltrain_wall,
          "launches": ltrain_launches,
          "valid_before": lbefore, "valid_after": lafter,
          "valid_reloaded": lreloaded, "checkpoint_epoch": lmeta["epoch"]})
    lwant = {"flash_attn_fwd": 0, "flash_attn_bwd": 0, "logmel_fwd": 1,
             "rnnt_alpha": 0, "rnnt_beta": 0, "banded_attn_fwd": 6,
             "banded_attn_bwd": 12}
    check_steps(lsteps, lper_step, lwant, ("loss", "loss_ctc", "loss_att"),
                n_steps=n_long_steps)
    if not abs(lreloaded["loss"] / lafter["loss"] - 1) <= RELOAD_TOL:
        raise AssertionError(f"the reloaded long-form checkpoint's "
                             f"validation loss {lreloaded['loss']} != "
                             f"{lafter['loss']}")

    # 12. the long-form model's gradients, card against CPU, on the first
    # 2 recordings of train_long
    _, batch = ltrain_if.collate_fn(
        [ltrain_if.dataset[k] for k in ltrain_if.dataset.keys()[:2]])
    emit({"phase": "longform_grad_check"}
         | grad_check(torch, ASRTask, lout / "config.yaml",
                      lout / "checkpoint", batch))

    # 13. the batch-decode CLI with the trained checkpoint over the
    # decode set, greedy CTC: one warm-up run, then the counted one; and
    # the card's CTC log-probabilities and greedy tokens against the CPU's
    infer_kw = dict(
        data_path_and_name_and_type=[f"{dec_dir}/wav.scp,speech,sound"],
        asr_train_config=str(lout / "config.yaml"),
        asr_model_file=str(lout / "checkpoint"), batch_size=LONG_BATCH,
        ctc_weight=1.0)
    inference(output_dir=str(workdir / "decode_warmup"), **infer_kw)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    inference(output_dir=str(workdir / "decode_long"), **infer_kw)
    torch.cuda.synchronize()
    ldecode_launches = dict(_cuda.LAUNCHES)
    dstats = [json.loads(line) for line in (
        workdir / "decode_long" / "decode_stats.jsonl").read_text()
        .splitlines()]
    recog = workdir / "decode_long" / "1best_recog"
    written = dict(line.split(" ", 1) for line in (recog / "token_int")
                   .read_text().splitlines())
    duids, dspeech_np, dlens_np, dn = next(decode_batches(
        dec_ds, dec_ds.keys(), LONG_BATCH))
    logprobs, greedy = {}, {}
    for dev in ("cuda", "cpu"):
        m, _ = ASRTask.build_model_from_file(lout / "config.yaml",
                                             lout / "checkpoint", dev)
        with torch.no_grad():
            enc, enc_lens = m.encode(torch.from_numpy(dspeech_np).to(dev),
                                     torch.from_numpy(dlens_np).long()
                                     .to(dev))
            lp = torch.log_softmax(m.ctc_logits(enc), dim=-1)
            toks, n_tok = ctc_greedy_decode(lp, enc_lens, m.blank_id)
        frames_ok = (torch.arange(lp.shape[1], device=dev)[None]
                     < enc_lens[:, None])
        logprobs[dev] = (lp.cpu(), frames_ok.cpu(), enc_lens.cpu())
        greedy[dev] = [toks[b, :n_tok[b]].tolist() for b in range(dn)]
        del m
    lp_err = float((logprobs["cuda"][0] - logprobs["cpu"][0]).abs()
                   [logprobs["cpu"][1]].max())
    drefs = dict(line.split(" ", 1) for line in (dec_dir / "text")
                 .read_text(encoding="utf-8").splitlines())
    dhyps = dict(line.split(" ", 1) if " " in line else (line, "")
                 for line in (recog / "text").read_text(encoding="utf-8")
                 .splitlines())
    emit({"phase": "longform_decode", "n_recordings": len(dhyps),
          "batch_size": LONG_BATCH, "ctc_weight": 1.0,
          "batch_shape": list(dspeech_np.shape),
          "encoder_frames": logprobs["cpu"][2].tolist(),
          "launches": ldecode_launches, "decode_stats": dstats,
          "audio_s_per_s": sum(x["audio_secs"] for x in dstats)
          / sum(x["decode_secs"] for x in dstats),
          "logprob_max_abs_err": lp_err, "tol": LOGPROB_TOL,
          "greedy_equal_card_cpu": sum(a == b for a, b in zip(
              greedy["cuda"], greedy["cpu"])),
          "cer": score_corpus([drefs[u] for u in duids[:dn]],
                              [dhyps[u] for u in duids[:dn]],
                              "char")["err_rate"],
          "text": (recog / "text").read_text(encoding="utf-8")})
    ldwant = {"flash_attn_fwd": 0, "flash_attn_bwd": 0, "logmel_fwd": 1,
              "rnnt_alpha": 0, "rnnt_beta": 0, "banded_attn_fwd": 6,
              "banded_attn_bwd": 0}
    if ldecode_launches != ldwant or len(dstats) != 1:
        raise AssertionError(f"long-form decode launches {ldecode_launches}"
                             f" in {len(dstats)} batches, not {ldwant}")
    if not lp_err <= LOGPROB_TOL:
        raise AssertionError(f"card and CPU CTC log-probabilities "
                             f"disagree: {lp_err}")
    if [written[u].split() if written[u].strip() else []
            for u in duids[:dn]] != [list(map(str, t))
                                     for t in greedy["cuda"]]:
        raise AssertionError("inference() wrote other tokens than the "
                             "card's greedy CTC")

    # 14. determinism: runs of each entry point from one seed repeat
    # themselves bit for bit, resumed or not; and the CTC gradient is the
    # port's own closed form, not torch's CTC loss
    ctc_nodes = {}
    for name, m, b in (("flagship", model, train_batch),
                       ("transducer", tmodel, ttrain_batch),
                       ("longform", lmodel, ltrain_batch)):
        m.train()
        loss, _, _ = m(**b)
        ctc_nodes[name] = ctc_backward_nodes(loss)
        m.eval()
        del loss
    emit({"phase": "determinism", "ctc_loss_nodes": ctc_nodes,
          "flagship": determinism(ASRTask, lambda n, **kw: train_config(
              ASRTask, ASSET, workdir, n, **kw), "flagship"),
          "transducer": determinism(
              ASRTransducerTask, lambda n, **kw: train_config(
                  ASRTransducerTask, TRANSDUCER, workdir, n, **kw),
              "transducer"),
          "longform": determinism(ASRTask, lambda n, **kw: longform_config(
              workdir, n, **kw), "longform")})
    if any(ctc_nodes.values()):
        raise AssertionError(f"a CTC gradient from torch's CTC loss: "
                             f"{ctc_nodes}")

    # 15-18. streaming decode and the transducer CLI
    cli_batch_launches = streaming_phases(torch, _cuda, workdir, smi)

    # 19-23. enhancement and the joint enhancement + ASR model
    s2t_decode_launches, s2t_step_launches = enhancement_phases(
        torch, _cuda, workdir, smi, speech_np, lengths_np, refs)

    # 36-38. the single-channel STFT separators and their training (on
    # phase 21's data)
    sep_paths = separator_phases(torch, _cuda, workdir, smi)

    # 24-26. the LM's perplexity, LM fusion and the VITS -> ASR round trip
    lm_decode_launches, tts_decode_launches = lm_tts_phases(
        torch, _cuda, workdir, smi)

    # 27-28. VITS training and the GAN vocoder
    vits_step, vits_valid, voc_step = gan_phases(torch, _cuda, workdir, smi)

    # 29-32. diarization, the codec and the SpeechLM
    a5_paths = a5_phases(torch, _cuda, workdir, smi)

    # 33-35. speaker verification, classification, LID and ASVspoof
    spk_cls_paths = spk_cls_phases(torch, _cuda, workdir, smi, cls_test)

    print(smi, flush=True)
    # launches of each kernel per decode and per train step on the paths
    # that run it; "launches" is the count on its main path's run: the
    # flagship's decode (K1, K2), the flagship's train path (K1b), the
    # transducer's train path (K3), the long-form decode (K4) and the
    # long-form train path (K4b)
    paths = {"decode": {"flagship": decode_launches,
                        "transducer": tdecode_launches,
                        "longform": ldecode_launches,
                        "transducer_cli_batch": cli_batch_launches,
                        "enh_s2t": s2t_decode_launches,
                        "lm_fused": lm_decode_launches,
                        "tts_round_trip_asr": tts_decode_launches},
             "train_step": {"flagship": want, "transducer": twant,
                            "longform": lwant,
                            "enh_s2t": s2t_step_launches,
                            "vits": vits_step, "gan_vocoder": voc_step},
             "valid_batch": {"vits": vits_valid}}
    for kind_, per_model in (*a5_paths.items(), *spk_cls_paths.items(),
                             *sep_paths.items()):
        paths[kind_].update(per_model)
    next(k for k in kernels if k["name"] == "logmel_fwd").update(a5_k2)
    next(k for k in kernels if k["name"] == "flash_attn_fwd")[
        "at_separator_decode_shape"] = sep_attn["fwd"]
    next(k for k in kernels if k["name"] == "flash_attn_bwd")[
        "at_separator_train_shape"] = sep_attn["bwd"]
    main_runs = {"flash_attn_fwd": decode_launches,
                 "flash_attn_bwd": train_launches,
                 "logmel_fwd": decode_launches,
                 "rnnt_alpha": ttrain_launches, "rnnt_beta": ttrain_launches,
                 "banded_attn_fwd": ldecode_launches,
                 "banded_attn_bwd": ltrain_launches}
    for name, n in main_runs.items():
        if n[name] <= 0:
            raise AssertionError(f"{name} was not launched on its path")
    emit({"kernels": [
        {key: kern[key] for key in (
            "name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")}
        | {key: kern[key] for key in (
            "bound_ms_fp32_cores", "chain_floor_ms", "at_train_shape",
            "at_long_form_train_batch", "at_mel_loss_shape",
            "at_diar_decode_shape", "at_codec_mel_loss_shape",
            "at_cls_shape", "at_separator_decode_shape",
            "at_separator_train_shape", "device_kernels") if key in kern}
        | {"launches": main_runs[kern["name"]][kern["name"]]}
        | {f"launches_per_{kind_}": {
            model_: counts[kern["name"]]
            for model_, counts in per_model.items() if counts[kern["name"]]}
           for kind_, per_model in paths.items()}
        | ({"library_note": kern["library_note"]}
           if "library_note" in kern else {})
        for kern in kernels],
        "nvidia_smi": smi})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
