#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``audiojax_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:

1. Card: name and power limit from nvidia-smi.
2. Build: every ``audiojax_torch/csrc/*.cu`` with nvcc (sm_90a), one nvcc per
   source, and the native bridge (``native/audioio.cc`` with g++, into the
   package's ``_build``), all started together; phase 3 starts once B1/B2's
   source is built, beside the others; each one's build time.  A bridge
   that does not build fails the run with the compiler's message.
3. Kernels B1/B2: the STFT and ISTFT kernels against their plain PyTorch
   versions (1e-5 × max|ref|) and against a float64 numpy DFT (error at
   most 2 × the plain version's), at the MossFormerGAN, GTCRN and
   ZipEnhancer serving shapes, DFSMN's served synthesis (4, 96000) and
   GTCRN's stream step (8, 1280) 512/256 uncentred, UL-UNAS's (4 and 16,
   32000) 512/256 hann and its stream step (8, 1280) uncentred, NKF-AEC's
   far‖near (8 and 32, 32000) 1024/256 hann constant and its stream step
   (16, 1792) uncentred (the two new stream steps' B1 only: they synthesise
   with stream_istft), MossFormer2-SE's synthesis (4 and 16 windows of 246
   frames) 1920/384 symmetric Hamming uncentred, SDAEC's and Deep-Echo's
   near‖far (2 and 8, 160000) 319/160 constant (B2 also at the served exact
   out_length, the window), the DFSMN-AEC cascade's backend (8, 32000) and
   mask synthesis (4 and 16, 32000) 640/320 symmetric Hamming uncentred, the
   SDAEC and cascade stream steps' B1 (16, 799) and (16, 1439) uncentred,
   Mel-Band Roformer's (4, 8, 16 and 32, 88200) 2048/441 hann reflect (mono
   and stereo, 6 s and 30 s), H-GTCRN's both-microphone (8 and 32, 32000)
   512/256 hann reflect, and two further geometries (odd 319/160 constant,
   DFSMN 1920/960 uncentred), with
   kernel / plain / torch.stft-istft timings (B2 also as a sum of kernel
   times beside torch.istft's), the card's bound for the same function (an
   FFT's operations, or the bytes read and written, whichever takes longer)
   and the kernels' own FFT operations.
4. Kernels B4/B6: the depthwise conv1d and relu² attention kernels against
   their plain versions (1e-5 × max|ref|) and against float64 numpy
   references (error at most 2 × the plain version's), at the MossFormerGAN
   and ZipEnhancer serving shapes, with kernel / plain / library timings and
   the card's bound (f32 operations at 67 TFLOP/s or bytes at 3.35 TB/s).
   B4 is held also at DFSMN's FSMN memory (C 256, k 20, no pads) of a 6 s
   and a 30 s request and of a stream step, which are also the DFSMN-AEC
   cascade's mask-net shapes.
   B4 takes its weight as the model's (C, 1, k) seen through a (k, C) view,
   and is held also off the served paths: C = 66 (scalar path), dilation 3,
   and an x 4 bytes past a 16-byte boundary.
5. Serving GTCRN: ``Session`` for ``gtcrn`` at full width (random parameters
   from seed 0) answers three requests of about 1.3 s, 7 s and 30 s; the
   launch counters must show B1 and B2 on that path, and the 7 s answer must
   be within 40 dB SNR of the same port on the CPU.
6. Serving MossFormerGAN-SE: ``Session`` for ``mossformergan_se`` at full
   width and depth (random parameters from seed 0) answers a 6 s
   request; every forward must launch B1 and B2 once, B4 48 times and B6 24
   times; one 6 s request is profiled (top kernels, and each ported kernel's
   device time in that trace), and one 1.5 s fold through the module
   must be within 40 dB SNR of the same port on the CPU.
7. Kernel B3: the rel-pos attention-scores kernel against its plain version
   (1e-5 × max|ref|) and a float64 numpy reference (error at most 2 × the
   plain version's), at ZipEnhancer's six serving shapes, the 30 s request's
   two largest and one long row (S = 601) for its two-pass route, with kernel
   / plain timings and the card's bound.
8. Serving ZipEnhancer: ``Session`` for ``zipenhancer`` at full width and
   depth (random parameters from seed 0) answers a 6 s request;
   every forward must launch B1 and B2 once, B4 16 times, B3 8 times and B6
   never; one 6 s request is profiled (top kernels, idle share, and each
   ported kernel's device time in that trace), and one 1.5 s fold through the
   module must be within 40 dB SNR of the same port on the CPU.  That fold
   starts with 201 silent samples (its first frame's phase feature is
   otherwise the sign of rounding noise); without them, the card given the
   CPU's first STFT frame must pass the same gate.
9. Kernels B5/B4/B6 at the MossFormer2-SS serving shapes: the grouped
   2-in/1-out conv (B5) at a 6 s and a 30 s request's (B, 3999, 512→256),
   k39, dilation 2; B4 at the FLASH and FSMN depthwise shapes; B6 at the
   FLASH group attention (B·16, 256, K=128, V=2048).  Each against its plain
   version (1e-5 × max|ref|) and a float64 numpy reference on a few batch
   rows (error at most 2 × the plain version's), with kernel / plain /
   library (cuDNN's grouped or depthwise conv) timings and the card's bound.
10. Serving MossFormer2-SS: ``Session`` for ``mossformer2_ss`` at full width
   and depth (random parameters from seed 0; 2 s windows after an 8,000-sample
   head, two int16 sources out) answers a 6 s request (4 windows); every forward must launch B4 96 times, B5 24 times, B6 24 times
   and B1/B2/B3 never; one 6 s request is profiled, and one 2 s window through
   the module must be within 40 dB SNR of the same port on the CPU, each
   source.

11. Export and serve imported checkpoints: for each of the fifteen names at
   its default (full) width and depth, a synthetic upstream-layout state
   dict from a fixed seed (``tests/test_torch_ckpt_builders.py``) goes
   through ``export_artifact`` into a temporary directory, its smoke request
   on the card; the import report must show every key read.  The artifact
   loaded onto the card must equal ``params_from_numpy`` of the in-memory
   import tree bit for bit; then ``Session`` serves a 7 s (GTCRN, UL-UNAS) or
   6 s request on it once after a warm-up, its forward launching what phases
   5, 6, 8, 10, 12 and 15–23 launch, and one fold (or a window's first
   second) on the card must be within the family's gate (40 dB; H-GTCRN 20 dB) of the same artifact on
   the CPU, each source (ZipEnhancer's fold starts with 201 silent samples;
   MossFormerGAN-SE, MossFormer2-SS and MossFormer2-SR, whose CPU forwards
   take seconds, are held card against CPU in phases 6, 10 and 22 only).
   Prints import, export and load
   seconds and the request's latency beside the random-weight latency of
   the same family and request size from this run, then one JSON line.
12. Serving DFSMN (run before phase 11, which compares against its
   latency): ``Session`` for ``dfsmn`` at full width and depth (hidden 256,
   depth 9, lorder 20, 120 mels, 48 kHz; random parameters from seed 0)
   answers a 6 s request; every forward must launch B2 once, B4
   9 times and B1, B3, B5, B6 never; one 6 s request is profiled, and one
   2 s window must be within 40 dB SNR of the same port on the CPU.
13. Streaming: ``StreamingServer`` for ``gtcrn``, ``dfsmn``, ``ul_unas``,
   ``nkf_aec``, ``sdaec``, ``deep_echo`` and ``dfsmn_aec`` (8 lanes, 4-hop
   blocks) on the card with ``jit=True`` (one
   captured CUDA graph of the step, replayed every tick) and with
   ``jit=False``.  Eight clips (7 s GTCRN and UL-UNAS, 6 s DFSMN and NKF, 3 s the others; the
   echo cancellers' lanes push (near, far) pairs) go through ``push_many`` in
   irregular chunks, then each lane is flushed.  Each lane's output must be
   as long as its input, within 1 LSB of the eager server's and ≥ 40 dB
   against a CPU ``StreamingSession`` on the same clip (the eager server
   and the CPU sessions on 2 of the lanes and the clips' first 2 s (SDAEC's,
   Deep-Echo's and the cascade's 3 s clips: their first 0.5 s, one eager
   step profiled and one replay traced),
   held against a second graphed drive of the same, to 0 LSB); the captured
   step must launch B1 once (GTCRN, UL-UNAS, NKF,
   SDAEC, Deep-Echo), B4 9 times (DFSMN) or both (the cascade), the
   wrappers' counters must stay at 0
   over the graphed drive (a replay launches inside the graph: the path's
   launches are captured × replays) and count that many a step on the eager
   one; ``verify_lane_isolation()`` must pass on the card.  Prints the
   step's device and wall time, graph and eager, the launches a step, the
   tick's median wall time, the server's set-up with and without capture,
   the RTF a stream at 8 live lanes and ``latency_samples``; one trace of a
   few replays is held against the counting rule.

14. Kernels B4/B6 at the MossFormer2-SE serving shapes (a 6 s and a 30 s
   48 kHz request: 4 and 16 windows of 246 frames): B4 at the FLASH
   ``in_conv`` (B, 246, 2176) k17, the ``out_conv`` and FSMN ``uv_conv``
   (B, 246, 512) k17 and the FSMN memory (B, 246, 256) k39 pads 19; B6 at
   the FLASH group attention (B, 256, K 128, V 2048).  The same at the
   MossFormer2-SR serving shapes (a 6 s and a 30 s 16 kHz request: 8 and 32
   windows of 375 frames, two FLASH groups each).  Held and timed as in
   phase 9.
15. Serving MossFormer2-SE: ``Session`` for ``mossformer2_se`` at full width
   and depth (dim 512, 24 layers, 961 bins, 48 kHz; random parameters from
   seed 0; 2 s windows) answers a 6 s request (4 windows);
   every forward must launch B2 once, B4 96 times, B6 24 times and B1, B3,
   B5 never; one 6 s request is profiled, and one 2 s window must be within
   40 dB SNR of the same port on the CPU.
16. Serving UL-UNAS: the same for ``ul_unas`` (16 kHz, 2 s windows) on a 7 s
   request (its 30 s one launches the same work and is left out for time);
   every forward must launch B1 once and B2 once.
17. Serving NKF-AEC: the same for ``nkf_aec`` (16 kHz, 2 s windows, two
   inputs) on a 6 s (near, far) pair (no 30 s one, for time) through
   ``Session.process(near, far)``, near being speech plus a delayed,
   filtered copy of the far end; every forward must launch B1 once (far‖near
   stacked) and B2 once; the echo-return-loss gain on an echo-only pair is
   printed, with no gate (random weights).
18–20. Serving SDAEC, Deep-Echo and the DFSMN-AEC cascade (SDAEC backend):
   the same for ``sdaec`` and ``deep_echo`` (10 s windows of (near, far)) on
   a 6 s pair (their 30 s requests launch the same work and are left out for
   time) and ``dfsmn_aec`` (2 s windows) on a 6 s pair too; every
   forward must launch B1 once (near‖far) and B2 once (SDAEC, Deep-Echo), or
   B1 once, B2 twice and B4 9 times (the cascade); each also prints the
   module's RTF on one window from
   ``audiojax_torch.utils.profiling.measure_rtf``.
21. Serving Mel-Band Roformer: the same for ``melband_roformer`` and
   ``melband_roformer_stereo`` (dim 384, 6 axial layers, 60 mel bands,
   2048/441, 44.1 kHz; 2 s windows) on a 6 s request of a voice
   over a harmonic accompaniment (stereo: left and right differ), mono
   (n,) and stereo (2, n) out; every forward must launch B1 once (every
   window and channel) and B2 once.
22. Serving MossFormer2-SR: first its generator's two stride-8 transposed
   convs at a 6 s request's shapes, as the model runs them
   (``F.conv_transpose1d``) and as zeros stuffed into a forward conv, held
   against each other and timed; then ``mossformer2_sr`` (dim 512, 24
   layers, HiFi-GAN 1024 channels; 2 s windows of 16 kHz every 1.25 s,
   Hann-taper overlap-add, 48 kHz out, 3× the samples) on a 6 s request; every forward must launch B4 96 times and B6 24 times.
23. Serving H-GTCRN: ``h_gtcrn`` (two microphones of a voice through a
   reverberant tail and a noise source, 16 kHz, 2 s windows, mono out) on a
   6 s request (no 30 s one, for time); every forward must launch B1 once (both
   microphones) and B2 once; card against CPU at its 20 dB gate, with the
   two source energies' relative gap on the card and on the CPU.
24. Kernels in bf16: B3, B4, B5 and B6 in bfloat16 (the bf16 plans' kernel
   instances) at every shape of the three bf16 paths (their float32 shapes)
   and B4's and B5's off-path routes, each within one bf16 ulp of its plain
   version on every element (the count that differ printed) and within 2 ×
   the plain version's float64 error; the 6 s request's shapes timed beside cuDNN's
   bf16 conv (B4, B5), the bound from bf16 bytes and operations.
25. Serving the bf16 plans: ``mossformergan_se``, ``zipenhancer`` and
   ``mossformer2_ss`` with ``compute_dtype="bfloat16"`` on the requests of
   phases 6, 8 and 10; every forward must launch the bf16 instances (48 B4
   and 24 B6; 16 B4 and 8 B3; 96 B4, 24 B5 and 24 B6) and B1/B2 in float32;
   each median beside the float32 plan's, card bf16 against card float32
   at least 15 dB, and card against the CPU's bf16 plan at the gate measured
   (``GATE_DB``).
26. The native bridge and FLAC: every function of the bridge against the
   port's numpy code (bit for bit; RMS normalisation and OLA stitch within
   1 LSB), timed both ways on the host; a 7 s GTCRN request written as FLAC
   (``tests/flac_golden.py``), decoded by the bridge through ``read_audio``
   and served by ``Session`` on the card, equal bit for bit to the WAV
   request's answer; each whole request (read, serve, encode) timed.
27. The bf16 plans of MossFormer2-SE, Mel-Band Roformer (mono and stereo)
   and MossFormer2-SR: first B4 and B6 in bf16 at SE's and SR's serving
   shapes (phase 14's; B4 within one bf16 ulp of its plain twin, B6 with
   float32 out as the layers take it), then each family on the requests of
   phases 15, 21 and 22, as phase 25 serves its three: the bf16 launches, the
   medians beside the float32 plans', card bf16 against card float32 and
   against the CPU's bf16 plan at the gates measured (SR's output only at a
   6 dB sanity floor: its random generator is chaotic, so its bf16 mask net
   is held alone, card against CPU, at ``SR_MASKNET_BF16_GATE_DB``).
28. The plans through the artifact: Mel-Band Roformer exported from a
   synthetic checkpoint, optimized with q8f32, q8dyn and weight-only bf16,
   loaded and served on the card (1 B1, 1 B2 a forward); each 6 s median
   beside the float32 artifact's, its optimize_report.json, its weights'
   bytes on the card, one profiled request, card against card float32 (at
   ``PLAN_VS_F32_GATE_DB``) and against the CPU on the same artifact; then a GTCRN artifact under q8dyn
   with its GRU and dense leaves int8 (``min_size`` 256) streamed on 4 lanes,
   the captured CUDA graph equal to the eager server.
29. A JAX artifact: ``tests/data/jax_gtcrn_artifact`` (``params.msgpack``
   as the JAX package's ``save_artifact`` writes it, GTCRN at full width)
   read by the port's own decoder, served on the card and on the CPU on a
   6 s request, card against CPU at 40 dB; B1 and B2 must launch.
30. Graphs: ``export --aot``'s ``attach_graph`` on the card for
   ``mossformergan_se`` (float32), ``zipenhancer`` (bf16 plan) and
   ``mossformer2_ss`` (float32), and phase 33's ``gtcrn`` and ``sdaec``
   (their time loops traced as scan operators; ``graph.json`` must record
   ``"loops": "scan"``), at full width from random weights, each in a child
   process, the five in parallel; then a child process a graph that never
   imports ``audiojax_torch.models`` (asserted) loads it (the five in
   parallel) and serves a 6 s request through ``Session`` (one at a time),
   held against the eager module's answer at ≤ 1 LSB, and counts the
   kernels that the graph replays launched: B1, B2, B3 bf16, B4, B4 bf16,
   B5 and B6 must each be > 0.
   Prints export and load seconds, ``graph.pt2`` bytes and nodes (with the
   scan steps' own) and graph against
   eager latency; and the registered operators' host cost: B4's operator
   against its direct launcher a call, and the GAN's eager request with
   every routing point through the operators against the direct launchers.
31. The tools: ``utils.smoke`` over every registered model on the card
   (exit code 0) and ``utils.inspect_model --all`` (each of its fifteen
   lines parses, its ``gflops_per_chunk`` > 0), both while phase 30's
   exports run in other processes (nothing is timed then); after phase 30,
   ``utils.bench_streams`` for GTCRN at 8, 64 and 256 lanes.
32. The measurement and parity tools, each timing tool in a process of its
   own (started, to import torch and take the card, beside phase 30's
   exports; run one at a time after phase 31): ``utils.bench_all`` over
   DFSMN, MossFormerGAN-SE and Mel-Band
   Roformer with ``--quant q8f32 --iters 3`` (eight rows: three float32, two
   bf16, three q8f32; none an error, each with its RTF, GFLOP and MFU in
   [0, 100), the q8f32 rows with their SNR against float32), its rows
   rendered into a copy of README.md by ``utils.readme_tables`` (the port's
   ``torch-zoo-table`` headed by the card line); ``utils.gan_profile --iters
   3 --json`` (the ten stages, each stub run and the function it replaced
   never called; its table printed); ``utils.parity_suite`` on a GTCRN kit
   built here (a synthetic checkpoint, a 6 s input, the port's CPU answer as
   the ref) on the card at ≥ 40 dB, launching B1 and B2 (untimed: beside
   phase 30's exports).  Each one's launches join the kernels line as paths
   of their own.
33. Parallel serving: MossFormerGAN-SE (float32, full width) on a 6 s
   request through ``Session(mesh=make_mesh())`` (every card) and through a
   dp mesh of ``cuda:0`` twice, each within 1 LSB of the plain ``Session``
   and each dp row's forward launching phase 6's kernels; ``pp_stack_fn``
   over MossFormer2-SS's 24 full-width FLASH layers (B4 and B6 inside) in 2
   stages over the card's device list, 2 microbatches of the 6 s request's
   (4, 3999, 512), against the layers run in order within 1e-5 × max|ref|,
   each microbatch launching 2 B4 and 1 B6 a layer.  Its GTCRN and SDAEC
   graphs are served in phase 30's stages (above).

The windowed families serve no 30 s request, for time: the kernel phases
(3, 4, 7, 9, 14) still hold the kernels at the 30 s requests' shapes, and
GTCRN's phase 5 serves one.
Phases 6, 8, 10, 12, 15–23, 25, 27 and 28 print the launches of one forward,
all of them and the ported kernels'.  They run in the order 1–10, 24, 25,
12, 14–23, 26–28, 11, 13, 29–33 (phase 11 compares against the random-weight
latencies).  The last line is ``{"ok": true, "device": {...}}``; the line
before it lists every kernel as JSON, the bf16 instances as their own
entries (``dwconv1d_bf16`` …; its launches summed over the served paths,
phase 11's fifteen and the graphed stream paths, with the count of each path
beside it, and its times at its first serving shape), and the line before
that the card.  Without CUDA the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

# H100 SXM published peaks (NVIDIA data sheet): float32 and float64 outside
# the tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12
PEAK_BF16_FLOPS = 989e12  # dense, tensor cores
PEAK_HBM_BYTES = 3.35e12
# × max|ref|: B1/B2 against their plain versions (measured at most 2.33e-06
# at every shape held here, on the H100 80GB HBM3 at 700 W)
TOL_VS_PLAIN = 1e-5
# × max|ref|: B4/B6 against their plain versions, float32 sums of at most a few
# hundred terms in another order
TOL_B4_B6 = 1e-5
F64_ROWS = 64  # batch rows (evenly spaced) held against the float64 references
# the bf16 kernels against their plain versions: one bf16 ulp, |Δ| ≤ 2⁻⁷·|plain|
# (plus 1e-6 near zero); both round the same f32 sums once, so they part only
# where the two sums straddle a rounding boundary
BF16_ULP = 2.0 ** -7
# no bf16 instance runs on a float32 plan's path
NO_BF16 = {"dwconv1d_bf16": 0, "dwconv1d_tiled_bf16": 0, "quad_attention_bf16": 0,
           "relpos_scores_bf16": 0}
MIN_SNR_DB = 40.0
SR = 16000
SERVE_REPEATS = 3
# MossFormerGAN launches per forward: 4 depthwise convs (uv, FSMN memory, GAU
# in_conv and out_conv) and 2 GAU attentions (local, cross) per SyncANet path,
# 2 paths per block, 6 blocks
GAN_PER_FORWARD = {"stft_packed": 1, "istft_packed": 1, "dwconv1d": 48, "dwconv1d_tiled": 0,
                   "quad_attention": 24, "relpos_scores": 0, **NO_BF16}
# ZipEnhancer launches per forward: 8 Zipformer2 layers (4 encoders × a
# frequency and a time layer), each with one score stage (B3) and two conv
# modules (B4)
ZIP_PER_FORWARD = {"stft_packed": 1, "istft_packed": 1, "dwconv1d": 16, "dwconv1d_tiled": 0,
                   "quad_attention": 0, "relpos_scores": 8, **NO_BF16}
# MossFormer2-SS launches per forward: in each of 24 layers, 4 depthwise convs
# (FLASH in_conv and out_conv, FSMN uv_conv, the first memory level) on B4,
# the grouped 2-in/1-out second memory level on B5, the FLASH group attention
# on B6; no STFT
SS_PER_FORWARD = {"stft_packed": 0, "istft_packed": 0, "dwconv1d": 96, "dwconv1d_tiled": 24,
                  "quad_attention": 24, "relpos_scores": 0, **NO_BF16}
# DFSMN launches per forward: the synthesis ISTFT (B2) once and the 9 FSMN
# memories (B4); its analysis is a framed matrix product, no B1
DFSMN_PER_FORWARD = {"stft_packed": 0, "istft_packed": 1, "dwconv1d": 9, "dwconv1d_tiled": 0,
                     "quad_attention": 0, "relpos_scores": 0, **NO_BF16}
# MossFormer2-SE launches per forward: in each of 24 layers, 4 depthwise convs
# (FLASH in_conv and out_conv, FSMN uv_conv and its memory) on B4 and the
# FLASH group attention on B6; the synthesis on B2; its analysis is a framed
# matrix product, no B1
SE_PER_FORWARD = {"stft_packed": 0, "istft_packed": 1, "dwconv1d": 96, "dwconv1d_tiled": 0,
                  "quad_attention": 24, "relpos_scores": 0, **NO_BF16}
# UL-UNAS and NKF-AEC launches per forward: one STFT (NKF's over far‖near
# stacked) and one ISTFT; their 2-D convs run on cuDNN
UL_PER_FORWARD = {"stft_packed": 1, "istft_packed": 1, "dwconv1d": 0, "dwconv1d_tiled": 0,
                  "quad_attention": 0, "relpos_scores": 0, **NO_BF16}
NKF_PER_FORWARD = UL_PER_FORWARD
# SDAEC and Deep-Echo launches per forward: one STFT over near‖far stacked and
# one ISTFT; the DFSMN-AEC cascade (SDAEC backend) adds the mask synthesis on
# B2 and its 9 FSMN memories on B4 (its fbank and mask analysis are products)
AEC319_PER_FORWARD = UL_PER_FORWARD
CASCADE_PER_FORWARD = {**UL_PER_FORWARD, "istft_packed": 2, "dwconv1d": 9}
# Mel-Band Roformer (mono or stereo) and H-GTCRN launches per forward: one
# STFT over every window and channel (H-GTCRN: both microphones) and one
# ISTFT; their other work is products, cuDNN convs and ATen
MELBAND_PER_FORWARD = HGTCRN_PER_FORWARD = UL_PER_FORWARD
# MossFormer2-SR launches per forward: MossFormer2-SE's mask net (4 depthwise
# convs on B4 and the FLASH group attention on B6 in each of 24 layers); its
# mel analysis is a product and its generator, upsampler and crossover are
# cuDNN convs
SR_PER_FORWARD = {**SE_PER_FORWARD, "istft_packed": 0}


def bf16_plan(per_forward: dict) -> dict:
    """A family's launches a forward in its bf16 plan: B3–B6 as their bf16
    instances, B1/B2 (the float32 islands) as they are."""
    out = dict(per_forward)
    for k in ("dwconv1d", "dwconv1d_tiled", "quad_attention", "relpos_scores"):
        out[f"{k}_bf16"], out[k] = out[k], 0
    return out
# card against CPU, int16 SNR: 40 dB, but H-GTCRN's float32 WPE is
# ill-conditioned, and there the JAX package's own gate for the family holds
# (20 dB; the port and the JAX package part at 27.3–39.3 dB on the CPU); the
# bf16 plans, whose card and CPU round in other places, at the value measured
# on the H100 80GB HBM3, rounded down to the dB (GAN 24.46, ZipEnhancer
# 28.93, SS 35.71 at its lower source; never below 15 dB)
GATE_DB = {"h_gtcrn": 20.0, "mossformergan_se_bf16": 24.0, "zipenhancer_bf16": 28.0,
           "mossformer2_ss_bf16": 35.0,
           # the other bf16 plans and q8dyn, measured the same way (SE 35.00,
           # held at 34 below the print's precision; Mel-Band 36.76, stereo
           # 37.68; q8dyn 36.46, each row's int8 rounding of the activations on
           # the card and the CPU)
           "mossformer2_se_bf16": 34.0, "melband_roformer_bf16": 36.0,
           "melband_roformer_stereo_bf16": 37.0, "melband_roformer_q8dyn": 36.0,
           # SR's output only as a sanity floor (9.12 measured): its random
           # generator is chaotic and turns any rounding of the bf16 mask net
           # into a ~9 dB gap, so its output moves with the libraries'
           # algorithm choice; SR_MASKNET_BF16_GATE_DB holds the plan
           "mossformer2_sr_bf16": 6.0}
# the bf16 plan against the float32 plan on the card, int16 SNR: the JAX
# package's own bf16 gate
BF16_VS_F32_DB = 15.0
# … but where a family's measured distance lies below it: MossFormer2-SR's
# random-weight generator is chaotic, and amplifies the bf16 mask net's
# rounding in either package (the JAX package's own bf16 plan lies 11.26 dB
# from its float32 one at the test widths; 9.02 dB measured on the H100 80GB
# HBM3 at 700 W; ROADMAP §C), so its output is held only to a sanity floor
# with room below that reading, and its mask net alone carries the gate
BF16_VS_F32_GATE_DB = {"mossformer2_sr_bf16": 6.0}
# … so SR's bf16 mask net is held alone too, card against CPU on the same
# log-mel (float SNR of its output, before the generator): 33.85 dB measured
SR_MASKNET_BF16_GATE_DB = 33.0
# ~1 ms at the H100's clock: longer than the host takes to issue any timed call
SPIN_CYCLES = 2_000_000
GUARD_SPINS = 32


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    from audiojax_torch.device import card_line as line

    return line("cuda")


def spin_guard() -> None:
    """A short spin and GUARD_SPINS shorter ones, then a sync: launches a
    profiler trace may lose in place of the measured call's (every spin is
    left out of the rows by name)."""
    torch.cuda._sleep(1000)
    for _ in range(GUARD_SPINS):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()


# each kernel's name in a torch.profiler trace (a substring of its symbol); a
# bf16 instance's symbol also names its element type, bf16
PROFILE_KEYS = {"stft_packed": "::stft_kernel", "istft_packed": "::istft_kernel",
                "dwconv1d": "dwconv_kernel", "dwconv1d_tiled": "dwconv_grouped_kernel",
                "quad_attention": "quad_attention_kernel", "relpos_scores": "relpos"}


def is_kernel(counter: str, key: str) -> bool:
    """Whether a trace row named ``key`` is a launch of the wrapper counter
    ``counter`` (``dwconv1d`` the float32 instance, ``dwconv1d_bf16`` the
    bfloat16 one)."""
    bf16 = counter.endswith("_bf16")
    return PROFILE_KEYS[counter.removesuffix("_bf16")] in key and ("bf16" in key) == bf16


@dataclasses.dataclass
class KernelRow:
    """One device row of a trace: a kernel (or copy) name, its launches and
    their device µs, the fields of ``key_averages()``'s rows read here."""
    key: str
    count: int
    self_device_time_total: float


def device_rows(prof) -> list:
    """The device rows of a finished trace, but the spin kernels', from the
    profiler's raw events: what ``key_averages()`` gives for them, without
    the Python tree of every host op that it builds first (seconds a trace
    of the echo cancellers' tens of thousands of launches, far more than
    the request itself)."""
    rows = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        name = ev.name()
        if "spin_kernel" in name:
            continue
        row = rows.setdefault(name, [0, 0])
        row[0] += 1
        row[1] += ev.duration_ns()
    return [KernelRow(k, n, ns / 1e3) for k, (n, ns) in rows.items()]


def cuda_rows(fn, expect: dict[str, int], calls: int = 1) -> list:
    """torch.profiler's per-kernel rows (device side) for one call of ``fn``,
    which makes ``calls`` identical calls of the function measured;
    ``expect`` counts launches by the wrappers' counter names.

    The profiler has been seen to drop device records on the H100 (a whole
    trace, or most of one, or a few of ~12k), so a trace counts only when every
    kernel named in ``expect`` appears exactly that many times and the total
    launch count agrees with the previous attempt's, to a thousandth (exactly
    below 1,000 launches, where it must also be a multiple of ``calls``);
    otherwise it is taken again."""
    previous = None
    for _ in range(8):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # spins before and after the measured call, left out of the rows:
            # a trace has been seen to lose the first few launches (up to ~10
            # of a 19k-launch UL-UNAS request) and the one at the end
            spin_guard()
            fn()
            spin_guard()
        rows = device_rows(prof)
        launches = sum(e.count for e in rows)
        named = {k: sum(e.count for e in rows if is_kernel(k, e.key)) for k in expect}
        agrees = previous is not None and abs(launches - previous) <= launches // 1000
        if launches and named == expect and agrees and (launches >= 1000 or launches % calls == 0):
            return rows
        previous = launches
    fail(f"torch.profiler gave no two consistent traces ({named}, {launches} launches)")


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call: CUDA events around it, queued behind a spin
    kernel long enough for the host to issue the whole call before the card
    reaches it, so host gaps do not count.  Median over ``iters``.  Not for a
    call that waits on the host inside: the events would count the wait."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(iters):
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_sum_ms(fn, iters: int = 20) -> float:
    """Device time of one call as the sum of its kernels' device times in a
    torch.profiler trace of ``iters`` calls, for a call that waits on the host
    inside (torch.istft reads its window envelope's minimum back to check it),
    where CUDA events would count the wait.  Gaps between kernels do not count."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()

    rows = cuda_rows(run, {}, calls=iters)
    return sum(e.self_device_time_total for e in rows) / 1e3 / iters


def _ms(value, absent: str) -> str:
    return absent if value is None else f"{value:.4f}"


def bound(flops: float, nbytes: float, bf16_flops: float = 0.0) -> tuple[float, str]:
    """The least time (ms) of ``flops`` float32 and ``bf16_flops`` bfloat16
    operations (at their peaks) against ``nbytes`` at the memory rate."""
    t_ops = flops / PEAK_F32_FLOPS + bf16_flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def fft_flops(n: int) -> float:
    """Operations of one length-``n`` FFT, the classic 5/2·n·log2(n) count (an
    over-count for real input, which needs about half)."""
    return 2.5 * n * np.log2(n)


# operations of one butterfly of csrc/stft.cu's fixed radices, counted from
# the code (twiddle products apart)
BUTTERFLY_FLOPS = {2: 4, 3: 16, 4: 16, 5: 52, 8: 56}


def plan_flops(cfg) -> float:
    """Operations of the kernels' FFT of one frame, counted from its plan:
    each stage's m/R butterflies with R − 1 twiddle products (6 each) and the
    radix-R DFT (a generic radix 8·R·(R − 1)), the even-n_fft split (~10 a
    bin) and the window product."""
    from audiojax_torch.dsp.stft import fft_plan

    plan = fft_plan(cfg.n_fft)
    ops = sum(plan.m // r * (6 * (r - 1) + BUTTERFLY_FLOPS.get(r, 8 * r * (r - 1)))
              for r in plan.radices)
    return ops + (10 * cfg.f_bins if cfg.n_fft % 2 == 0 else 0) + cfg.n_fft


def istft_frames(cfg, b: int, n_t: int) -> int:
    """Frames B2 transforms at its wrapper's geometry, the halo frames that
    two neighbouring tiles both recompute included (``istft_kernel``'s
    t_lo..t_hi in csrc/stft.cu)."""
    from audiojax_torch.ops.stft_cuda import istft_launch

    g = istft_launch(cfg, b, n_t)
    total = 0
    for i in range(g.blocks // b):
        r0 = g.start // cfg.hop + i * g.rows
        p_lo, p_hi = max(r0 * cfg.hop, g.start), min((r0 + g.rows) * cfg.hop, g.end)
        t_lo = max(0, (p_lo - cfg.n_fft) // cfg.hop + 1)
        total += max(0, min(n_t - 1, (p_hi - 1) // cfg.hop) - t_lo + 1)
    return b * total


# ── float64 references, independent of the port's code ─────────────────────


def ref_stft64(x: np.ndarray, cfg, win: np.ndarray) -> np.ndarray:
    h = cfg.half
    mode = "reflect" if cfg.pad_mode == "reflect" else "constant"
    xp = np.pad(x, [(0, 0), (h, h)], mode=mode) if cfg.center else x
    frames = np.lib.stride_tricks.sliding_window_view(xp, cfg.n_fft, axis=-1)[:, :: cfg.hop]
    spec = np.fft.rfft(frames * win, axis=-1)
    return np.concatenate([spec.real, spec.imag], axis=-1)


def ref_istft64(packed: np.ndarray, cfg, win: np.ndarray) -> np.ndarray:
    fb = cfg.f_bins
    frames = np.fft.irfft(packed[..., :fb] + 1j * packed[..., fb:], n=cfg.n_fft, axis=-1) * win
    b, n_t, _ = frames.shape
    raw_len = cfg.n_fft + cfg.hop * (n_t - 1)
    raw = np.zeros((b, raw_len))
    env = np.zeros(raw_len)
    for t in range(n_t):
        raw[:, t * cfg.hop : t * cfg.hop + cfg.n_fft] += frames[:, t]
        env[t * cfg.hop : t * cfg.hop + cfg.n_fft] += win ** 2
    start = cfg.half if cfg.center else 0
    sl = slice(start, raw_len - start)
    env = env[sl]
    return raw[:, sl] * np.where(env == 0.0, 1.0, 1.0 / np.maximum(env, 1e-300))


def rel_err(a: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(a.astype(np.float64) - ref).max() / np.abs(ref).max())


# ── phase 3 ────────────────────────────────────────────────────────────────


def check_kernels(dev) -> dict:
    """Phase 3; returns each kernel's row at the MossFormerGAN 30 s serving shape."""
    from audiojax_torch.dsp.stft import StftConfig, _window_np, num_frames
    from audiojax_torch.models.dfsmn_aec import DfsmnAecConfig
    from audiojax_torch.models.h_gtcrn import HGtcrnConfig
    from audiojax_torch.models.melband_roformer import MelBandConfig
    from audiojax_torch.models.mossformer2_se import MossFormer2SeConfig
    from audiojax_torch.models.mossformergan_se import MossFormerGanConfig
    from audiojax_torch.models.nkf_aec import NkfConfig
    from audiojax_torch.models.sdaec import SdaecConfig
    from audiojax_torch.models.ul_unas import UlUnasConfig
    from audiojax_torch.models.zipenhancer import ZipEnhancerConfig
    from audiojax_torch.ops import stft_cuda as K

    ul_cfg, nkf_cfg, se_cfg = UlUnasConfig(), NkfConfig(), MossFormer2SeConfig()
    aec_cfg, cascade_cfg = SdaecConfig(), DfsmnAecConfig()
    mb_cfg, hg_cfg = MelBandConfig().stft, HGtcrnConfig().stft

    gtcrn = StftConfig(512, 256, window="hann_sqrt", pad_mode="reflect")
    gan = MossFormerGanConfig().stft
    gan_fold = MossFormerGanConfig().fold_window
    zip_cfg = ZipEnhancerConfig()
    cases = [  # (label, config, batch, length[, B2 held too: default True])
        # MossFormerGAN serving shapes: 30 s request (8 windows, 32 folds), 6 s (4 folds)
        ("mossformergan 400/100 hamming reflect", gan, 32, gan_fold),
        ("mossformergan 400/100 hamming reflect", gan, 4, gan_fold),
        ("gtcrn 512/256 hann_sqrt reflect", gtcrn, 16, 32000),  # serving shape, 30 s request
        ("gtcrn 512/256 hann_sqrt reflect", gtcrn, 4, 32000),   # 7 s request
        ("gtcrn 512/256 hann_sqrt reflect", gtcrn, 1, 32000),   # 1.3 s request
        # ZipEnhancer serving shapes: 30 s request (32 folds), 6 s (4 folds)
        ("zipenhancer 400/100 hann reflect", zip_cfg.stft, 32, zip_cfg.fold_window),
        ("zipenhancer 400/100 hann reflect", zip_cfg.stft, 4, zip_cfg.fold_window),
        ("odd 319/160 hamming constant", StftConfig(319, 160, window="hamming",
                                                    pad_mode="constant"), 4, 16000),
        # Mel-Band Roformer's serving shapes (2 s windows of 44.1 kHz): a 6 s
        # request's 4 windows (mono) or 8 rows (stereo), a 30 s request's 16
        # or 32 (B2 at the same rows, 201 frames)
        ("melband 2048/441 hann reflect", mb_cfg, 4, 88200),
        ("melband 2048/441 hann reflect", mb_cfg, 8, 88200),
        ("melband 2048/441 hann reflect", mb_cfg, 16, 88200),
        ("melband 2048/441 hann reflect", mb_cfg, 32, 88200),
        # H-GTCRN: both microphones of a 6 s request's 4 windows (its B2
        # synthesises mic 0's 4 rows, UL-UNAS's (4, 32000) row: the same
        # 512/256 hann reflect), and of a 30 s request's 16
        ("h_gtcrn 512/256 hann reflect", hg_cfg, 8, 32000),
        ("h_gtcrn 512/256 hann reflect", hg_cfg, 32, 32000),
        # radix 3 (1920 = 2^7·3·5), no centre padding
        ("dfsmn 1920/960 hamming_periodic uncentred",
         StftConfig(1920, 960, window="hamming_periodic", center=False), 2, 19200),
        # DFSMN's served synthesis shape: a 6 s request, 4 windows of 99 frames
        ("dfsmn 1920/960 hamming_periodic uncentred",
         StftConfig(1920, 960, window="hamming_periodic", center=False), 4, 96000),
        # GTCRN's stream step: 8 lanes of 4 hops after the 256-sample tail
        ("gtcrn stream 512/256 hann_sqrt uncentred",
         StftConfig(512, 256, window="hann_sqrt", pad_mode="reflect", center=False), 8, 1280),
        # UL-UNAS: a 7 s request (4 windows), a 30 s one (16) and its stream step
        ("ul_unas 512/256 hann reflect", ul_cfg.stft, 4, 32000),
        ("ul_unas 512/256 hann reflect", ul_cfg.stft, 16, 32000),
        ("ul_unas stream 512/256 hann uncentred",
         dataclasses.replace(ul_cfg.stft, center=False), 8, 1280, False),
        # NKF-AEC: far‖near of a 6 s request (2 × 4 windows), of a 30 s one
        # (2 × 16), and its stream step (near‖far of 8 lanes, 3 hops of tail)
        ("nkf_aec 1024/256 hann constant", nkf_cfg.stft, 8, 32000),
        ("nkf_aec 1024/256 hann constant", nkf_cfg.stft, 32, 32000),
        ("nkf_aec stream 1024/256 hann uncentred",
         dataclasses.replace(nkf_cfg.stft, center=False), 16, 1792, False),
        # MossFormer2-SE's synthesis at a 6 s and a 30 s request: 4 and 16
        # windows of 246 frames (its analysis is a product, as in JAX)
        ("mossformer2_se 1920/384 hamming_symmetric uncentred", se_cfg.frame_cfg, 4, 96000),
        ("mossformer2_se 1920/384 hamming_symmetric uncentred", se_cfg.frame_cfg, 16, 96000),
        # SDAEC and Deep-Echo: near‖far of a 6 s request (one 10 s window) and
        # of a 30 s one (3 → 4 windows), B2 at the served exact out_length
        # (the window); the DFSMN-AEC cascade's SDAEC backend at a 6 s request
        # (3 → 4 windows of 2 s); the two streams' steps (near‖far of 8
        # lanes: 4 hops of SDAEC, and 4 stage-2 hops = 8 backend hops of the
        # cascade, each after the 159-sample tail)
        ("sdaec 319/160 hamming constant", aec_cfg.stft, 2, 160000),
        ("sdaec 319/160 hamming constant", aec_cfg.stft, 8, 160000),
        ("dfsmn_aec backend 319/160 hamming constant", aec_cfg.stft, 8, 32000),
        ("sdaec stream 319/160 hamming uncentred",
         dataclasses.replace(aec_cfg.stft, center=False), 16, 799, False),
        ("dfsmn_aec stream 319/160 hamming uncentred",
         dataclasses.replace(aec_cfg.stft, center=False), 16, 1439, False),
        # the cascade's mask synthesis at a 6 s and a 30 s request: 4 and 16
        # windows of 99 frames (its analysis is a product, as in JAX)
        ("dfsmn_aec mask 640/320 hamming_symmetric uncentred", cascade_cfg.mask_cfg, 4, 32000),
        ("dfsmn_aec mask 640/320 hamming_symmetric uncentred", cascade_cfg.mask_cfg, 16, 32000),
    ]
    rng = np.random.default_rng(0)
    serving = {}
    for label, cfg, b, length, *synthesis in cases:
        # a stream step's geometry holds B1 only: its synthesis is
        # stream_istft, and an uncentred hann's envelope (sin⁴ at the first
        # samples) makes an offline ISTFT's first samples divide by ~1e-10
        with_b2 = not synthesis or synthesis[0]
        x64 = rng.standard_normal((b, length))
        x = torch.from_numpy(x64.astype(np.float32)).to(dev)
        win = _window_np(cfg)
        win_t = torch.from_numpy(win.astype(np.float32)).to(dev)
        n_t = num_frames(cfg, length)
        f2 = 2 * cfg.f_bins

        # B1: STFT
        ref = ref_stft64(x64.astype(np.float32).astype(np.float64), cfg, win)
        ker = K.stft_packed_cuda(x, cfg)
        plain = K.plain_stft_packed(x, cfg)
        torch.cuda.synchronize()
        k_np, p_np = ker.cpu().numpy(), plain.cpu().numpy()
        if k_np.shape != p_np.shape or not np.isfinite(k_np).all():
            fail(f"stft {label}: shape {k_np.shape} vs {p_np.shape} or non-finite")
        e_plain = float(np.abs(k_np - p_np).max() / np.abs(p_np).max())
        e64_k, e64_p = rel_err(k_np, ref), rel_err(p_np, ref)
        stft_row = {"err_vs_plain": e_plain, "max_abs_err": float(np.abs(k_np - p_np).max()),
                    "err64_kernel": e64_k, "err64_plain": e64_p}
        rows = {"stft_packed": stft_row}
        spec = ker

        if with_b2:
            # B2: ISTFT of the kernel's spectrum
            ref_i = ref_istft64(k_np.astype(np.float64), cfg, win)
            iker = K.istft_packed_cuda(spec, cfg)
            iplain = K.plain_istft_packed(spec, cfg)
            torch.cuda.synchronize()
            ik_np, ip_np = iker.cpu().numpy(), iplain.cpu().numpy()
            if ik_np.shape != ip_np.shape or not np.isfinite(ik_np).all():
                fail(f"istft {label}: shape {ik_np.shape} vs {ip_np.shape} or non-finite")
            ie_plain = float(np.abs(ik_np - ip_np).max() / np.abs(ip_np).max())
            ie64_k, ie64_p = rel_err(ik_np, ref_i), rel_err(ip_np, ref_i)
            rows["istft_packed"] = istft_row = {
                "err_vs_plain": ie_plain, "max_abs_err": float(np.abs(ik_np - ip_np).max()),
                "err64_kernel": ie64_k, "err64_plain": ie64_p}

            # out_length: the exact-length contract, at half a hop short and at
            # the input's length (what SDAEC and Deep-Echo ask for)
            for out_len in (length - cfg.hop // 2, length):
                ol_k = K.istft_packed_cuda(spec, cfg, out_length=out_len).cpu().numpy()
                ol_p = K.plain_istft_packed(spec, cfg, out_length=out_len).cpu().numpy()
                if (ol_k.shape != (b, out_len)
                        or np.abs(ol_k - ol_p).max() > TOL_VS_PLAIN * np.abs(ol_p).max()):
                    fail(f"istft out_length {out_len} {label}: {ol_k.shape}, err "
                         f"{np.abs(ol_k - ol_p).max()}")

        for name, row in rows.items():
            if not row["err_vs_plain"] <= TOL_VS_PLAIN:
                fail(f"{name} {label} ({b}, {length}): kernel vs plain {row['err_vs_plain']:.3e}")
            if not row["err64_kernel"] <= 2.0 * row["err64_plain"]:
                fail(f"{name} {label}: f64 error {row['err64_kernel']:.3e} > 2 × plain "
                     f"{row['err64_plain']:.3e}")

        # device time per call at this shape (kernel: the wrapper's whole call)
        stft_row["ms"] = device_ms(lambda: K.stft_packed_cuda(x, cfg))
        stft_row["plain_ms"] = device_ms(lambda: K.plain_stft_packed(x, cfg))
        stft_row["library_ms"] = device_ms(lambda: torch.stft(
            x, cfg.n_fft, cfg.hop, window=win_t, center=cfg.center, pad_mode=cfg.pad_mode,
            return_complex=True))
        # The least work of each function (float32 in, float32 out): per
        # frame one FFT plus the window product (and, for the ISTFT, the
        # overlap-add sum and the COLA scaling) at the float32 rate, against
        # its input read once and its output written once.  The kernels' own
        # FFT operations, counted from their plan, are printed apart at the
        # rate of the type each computes in (B1 float32, B2 float64).
        spec_bytes, win_bytes = 4.0 * b * n_t * f2, 4.0 * cfg.n_fft
        stft_row["bound_ms"], stft_row["bound_by"] = bound(
            b * n_t * (fft_flops(cfg.n_fft) + cfg.n_fft),
            4.0 * b * length + win_bytes + spec_bytes)
        frames = {"stft_packed": b * n_t}
        if with_b2:
            spec_c = torch.view_as_complex(
                torch.stack([spec[..., : cfg.f_bins], spec[..., cfg.f_bins:]], dim=-1)
            ).transpose(1, 2).contiguous()
            istft_row["ms"] = device_ms(lambda: K.istft_packed_cuda(spec, cfg))
            istft_row["plain_ms"] = device_ms(lambda: K.plain_istft_packed(spec, cfg))
            # torch.istft refuses a window whose overlap-add envelope reaches zero
            # (NOLA), as an uncentred hann_sqrt's does at its first sample
            envelope = np.zeros(cfg.n_fft + cfg.hop * (n_t - 1))
            for t in range(n_t):
                envelope[t * cfg.hop: t * cfg.hop + cfg.n_fft] += win ** 2
            envelope = envelope[cfg.half: -cfg.half] if cfg.center else envelope
            istft_row["library_ms"] = None
            if envelope.min() >= 1e-11:
                try:
                    istft_row["library_ms"] = kernel_sum_ms(lambda: torch.istft(
                        spec_c, cfg.n_fft, cfg.hop, window=win_t, center=cfg.center))
                except RuntimeError as e:  # the library's refusal, not the port's failure
                    print(f"torch.istft refuses {label} ({b}, {length}): {e}", flush=True)
            # the wrapper by the same method as the library, for a like-for-like comparison
            wrapper_sum_ms = kernel_sum_ms(lambda: K.istft_packed_cuda(spec, cfg))
            out_len_full = ik_np.shape[-1]
            istft_row["bound_ms"], istft_row["bound_by"] = bound(
                b * n_t * (fft_flops(cfg.n_fft) + 2 * cfg.n_fft) + b * out_len_full,
                spec_bytes + win_bytes + 4.0 * b * out_len_full)
            frames["istft_packed"] = istft_frames(cfg, b, n_t)

        for name, row in rows.items():
            peak, kind = (PEAK_F32_FLOPS, "f32") if name == "stft_packed" else (PEAK_F64_FLOPS,
                                                                                 "f64")
            plan_gflop = frames[name] * plan_flops(cfg) / 1e9
            if row["ms"] < row["bound_ms"]:  # faster than the card can be: a timing fault
                fail(f"{name} {label}: {row['ms']:.4f} ms is below its bound "
                     f"{row['bound_ms']:.4f} ms")
            print(f"kernel {name:12s} {label:43s} ({b:2d}, {length}): "
                  f"err/max|ref| vs plain {row['err_vs_plain']:.2e}, "
                  f"vs f64 kernel {row['err64_kernel']:.2e} plain {row['err64_plain']:.2e}; "
                  f"device ms: kernel (wrapper) {row['ms']:.4f}, "
                  f"plain {row['plain_ms']:.4f}, torch.{name.split('_')[0]} "
                  f"{_ms(row['library_ms'], 'refuses the window (NOLA)')}; bound {row['bound_ms'] * 1e3:.3f} us "
                  f"({row['bound_by']}); the kernel's FFTs, {frames[name]} frames, "
                  f"{plan_gflop:.4f} GFLOP ({plan_gflop * 1e15 / peak:.3f} us at the "
                  f"{kind} peak)", flush=True)
        if with_b2:
            print(f"kernel istft_packed {label:43s} ({b:2d}, {length}): device ms per call, "
                  f"CUDA events: kernel {istft_row['ms']:.4f}; sum of kernel device times: "
                  f"kernel {wrapper_sum_ms:.4f}, torch.istft "
                  f"{_ms(istft_row['library_ms'], 'refuses the window (NOLA)')}",
                  flush=True)
        else:
            print(f"kernel istft_packed {label:43s} ({b:2d}, {length}): not held here (the "
                  "stream step synthesises with stream_istft)", flush=True)
        if not serving:  # the first case
            serving = dict(rows)
    return serving


# ── phase 4 ────────────────────────────────────────────────────────────────


def ref_dwconv64(x: np.ndarray, w: np.ndarray, pads, dilation: int) -> np.ndarray:
    xp = np.pad(x, [(0, 0), tuple(pads), (0, 0)])
    t_out = xp.shape[1] - dilation * (w.shape[0] - 1)
    return sum(xp[:, i * dilation : i * dilation + t_out] * w[i] for i in range(w.shape[0]))


def ref_quad64(q: np.ndarray, k: np.ndarray, v: np.ndarray, scale: float,
               mask_diag: bool) -> np.ndarray:
    attn = np.square(np.maximum(np.matmul(q, np.swapaxes(k, 1, 2)) * scale, 0.0))
    if mask_diag:
        attn[:, np.arange(q.shape[1]), np.arange(q.shape[1])] = 0.0
    return np.matmul(attn, v)


# (label, (B, T, C), k, (lo, hi), dilation): the MossFormerGAN serving shapes
# at one 6 s window (4 folds of 241 frames, 101 sub-bands), the 30 s request's
# largest (32 folds); ZipEnhancer's conv modules (C=64, k31) at a 6 s window,
# whose ts0/ts3 shapes are the GAN's out_conv ones, on the downsampled
# encoders' ragged T, and at the 30 s request; one long dilated shape for B5's
# contract.
B4_CASES = [
    ("intra uv", (964, 98, 256), 31, (15, 15), 1),
    ("intra fsmn", (964, 98, 128), 39, (19, 19), 1),
    ("intra gau in_conv", (964, 101, 256), 31, (15, 15), 1),
    ("intra gau out_conv", (964, 101, 64), 31, (15, 15), 1),
    ("inter uv", (404, 238, 256), 31, (15, 15), 1),
    ("inter fsmn", (404, 238, 128), 39, (19, 19), 1),
    ("inter gau in_conv", (404, 241, 256), 31, (15, 15), 1),
    ("inter gau out_conv", (404, 241, 64), 31, (15, 15), 1),
    ("30 s intra gau in_conv", (7712, 101, 256), 31, (15, 15), 1),
    ("zip ts1 f conv", (484, 51, 64), 31, (15, 15), 1),
    ("zip ts1 t conv", (204, 121, 64), 31, (15, 15), 1),
    ("zip ts2 f conv", (244, 26, 64), 31, (15, 15), 1),
    ("zip ts2 t conv", (104, 61, 64), 31, (15, 15), 1),
    ("zip 30 s f conv", (7712, 101, 64), 31, (15, 15), 1),
    ("zip 30 s t conv", (3232, 241, 64), 31, (15, 15), 1),
    ("B5 dilated", (4, 4000, 256), 39, (38, 38), 2),
]
# DFSMN's FSMN memory (C 256, k 20, no pads: the lorder − 1 history frames
# lead each row): a 6 s request (4 windows of 99 frames), a 30 s request
# (16), and a stream step of 8 lanes of 4 frames.  The DFSMN-AEC cascade's
# mask net has the same memories at the same shapes: 16 kHz windows of 2 s
# are 99 frames of 320 (4 and 16 windows), and its stream step 4 frames.
B4_DFSMN_CASES = [
    ("dfsmn, dfsmn_aec fsmn", (4, 118, 256), 20, (0, 0), 1),
    ("dfsmn, dfsmn_aec 30 s fsmn", (16, 118, 256), 20, (0, 0), 1),
    ("dfsmn, dfsmn_aec stream fsmn", (8, 23, 256), 20, (0, 0), 1),
]
# (label, (B, T, C), k, (lo, hi), dilation, offset): B4 off the served paths,
# on the general routes: the scalar path (C % 4 != 0), dilation 3, and an x
# 4 bytes past a 16-byte boundary (scalar path at C = 256)
B4_OFFPATH_CASES = [
    ("scalar C=66", (964, 101, 66), 31, (15, 15), 1, 0),
    ("dilation 3", (404, 241, 128), 31, (45, 45), 3, 0),
    ("x at a 1-float offset", (964, 98, 256), 31, (15, 15), 1, 1),
]
# (label, N, S, mask_diag), K = V = 128
B6_CASES = [
    ("intra local", 964, 101, False),
    ("intra cross", 404, 241, True),
    ("inter local", 404, 241, False),
    ("inter cross", 964, 101, True),
    ("30 s intra local", 7712, 101, False),
    ("30 s intra cross", 3232, 241, True),
]


def _hold(name: str, label: str, ker: torch.Tensor, plain: torch.Tensor, ref64_fn,
          rows: torch.Tensor) -> dict:
    """Kernel vs plain on every element; both vs a float64 reference on ``rows``."""
    torch.cuda.synchronize()
    if ker.shape != plain.shape or not bool(torch.isfinite(ker).all()):
        fail(f"{name} {label}: shape {tuple(ker.shape)} vs {tuple(plain.shape)} or non-finite")
    diff = float((ker - plain).abs().max())
    e_plain = diff / float(plain.abs().max())
    ref = ref64_fn(rows)
    e64_k = rel_err(ker[rows].cpu().numpy(), ref)
    e64_p = rel_err(plain[rows].cpu().numpy(), ref)
    if not e_plain <= TOL_B4_B6:
        fail(f"{name} {label}: kernel vs plain {e_plain:.3e} > {TOL_B4_B6}")
    if not e64_k <= 2.0 * e64_p:
        fail(f"{name} {label}: f64 error {e64_k:.3e} > 2 × plain {e64_p:.3e}")
    return {"err_vs_plain": e_plain, "max_abs_err": diff, "err64_kernel": e64_k,
            "err64_plain": e64_p}


def _report(name: str, label: str, shape: str, row: dict) -> None:
    if row["ms"] is not None and row["ms"] < row["bound_ms"]:  # a timing fault
        fail(f"{name} {label}: {row['ms']:.4f} ms is below its bound {row['bound_ms']:.4f} ms")
    lib = "—" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
    differ = f" ({row['differ']})" if "differ" in row else ""
    times = ("untimed" if row["ms"] is None else f"kernel {row['ms']:.4f}, plain "
             f"{row['plain_ms']:.4f}, library {lib}")
    print(f"kernel {name:14s} {label:22s} {shape:32s}: err/max|ref| vs plain "
          f"{row['err_vs_plain']:.2e}{differ}, vs f64 kernel {row['err64_kernel']:.2e} plain "
          f"{row['err64_plain']:.2e}; device ms: {times}; bound {row['bound_ms']:.4f} "
          f"({row['bound_by']})", flush=True)


def _time(row: dict, timed: bool, run, plain, library=None) -> None:
    """The kernel's, the plain version's and the library call's device ms
    into ``row`` (None each, untimed)."""
    row["ms"] = device_ms(run) if timed else None
    row["plain_ms"] = device_ms(plain) if timed else None
    row["library_ms"] = device_ms(library) if timed and library is not None else None


def _f64_rows(n: int, count: int, dev) -> torch.Tensor:
    """``count`` evenly spaced batch rows of ``n`` (all of them if fewer)."""
    return torch.linspace(0, n - 1, min(n, count), device=dev).long().unique()


def _hold_bf16(name: str, label: str, ker: torch.Tensor, plain: torch.Tensor, ref64_fn,
               rows: torch.Tensor) -> dict:
    """A bf16 kernel vs its plain version within one bf16 ulp on every
    element; both vs a float64 reference of the same bf16 inputs on ``rows``,
    the kernel within 2× the plain version's error."""
    torch.cuda.synchronize()
    if (ker.shape != plain.shape or ker.dtype != torch.bfloat16 or plain.dtype != torch.bfloat16
            or not bool(torch.isfinite(ker).all())):
        fail(f"{name} bf16 {label}: {ker.dtype} {tuple(ker.shape)} vs {plain.dtype} "
             f"{tuple(plain.shape)}, or non-finite")
    kf, pf = ker.float(), plain.float()
    diff = (kf - pf).abs()
    over = int((diff > BF16_ULP * pf.abs() + 1e-6).sum())
    differ = int((diff > 0).sum())
    ref = ref64_fn(rows)
    e64_k = rel_err(kf[rows].cpu().numpy(), ref)
    e64_p = rel_err(pf[rows].cpu().numpy(), ref)
    if over:
        fail(f"{name} bf16 {label}: {over} elements part from plain by more than one bf16 ulp")
    if not e64_k <= 2.0 * e64_p:
        fail(f"{name} bf16 {label}: f64 error {e64_k:.3e} > 2 × plain {e64_p:.3e}")
    return {"err_vs_plain": float(diff.max()) / float(pf.abs().max()),
            "max_abs_err": float(diff.max()), "err64_kernel": e64_k, "err64_plain": e64_p,
            "differ": f"{differ} of {diff.numel()} elements differ, none by more than one ulp"}


def hold(name, label, ker, plain, ref64_fn, rows, dtype) -> dict:
    if dtype == torch.bfloat16:
        return _hold_bf16(name, label, ker, plain, ref64_fn, rows)
    return _hold(name, label, ker, plain, ref64_fn, rows)


def hold_b4(gen, dev, label: str, shape: tuple, k: int, pads: tuple, dil: int,
            f64_rows: int = F64_ROWS, offset: int = 0, dtype=torch.float32,
            timed: bool = True) -> dict:
    """B4 against plain and float64 at one shape, timed beside cuDNN.  w is
    the model's (C, 1, k) weight seen as (k, C), as ``nn/core.py`` passes it;
    x starts ``offset`` elements into a larger buffer; ``dtype`` float32 or
    bfloat16 (x and w drawn in float32 and rounded)."""
    import torch.nn.functional as F

    from audiojax_torch.ops import dwconv_cuda as D

    b, t, c = shape
    x = torch.randn((b * t * c + offset,), generator=gen, device=dev).to(dtype)[offset:]
    x = x.view(b, t, c)
    w = (torch.randn((c, 1, k), generator=gen, device=dev) / k ** 0.5).to(dtype)[:, 0, :].t()
    run = lambda: D.dwconv1d_cuda(x, w, pads=pads, dilation=dil)  # noqa: E731
    plain = lambda: D.dwconv1d_plain(x, w, pads=pads, dilation=dil)  # noqa: E731
    w64 = w.double().cpu().numpy()
    tag = "dwconv1d" if dtype == torch.float32 else "dwconv1d_bf16"
    row = hold(tag, label, run(), plain(), lambda r: ref_dwconv64(
        x[r].double().cpu().numpy(), w64, pads, dil), _f64_rows(b, f64_rows, dev), dtype)
    # cuDNN's depthwise conv on a contiguous (B, C, T) tensor (TF32 off; bf16
    # in bf16); the layout change is made before the timing and left out of it
    xt = F.pad(x.transpose(1, 2), pads).contiguous()
    wt = w.t().contiguous()[:, None, :]
    _time(row, timed, run, plain, lambda: F.conv1d(xt, wt, dilation=dil, groups=c))
    t_out = t + sum(pads) - dil * (k - 1)
    es = x.element_size()
    macs = 2.0 * b * t_out * c * k
    row["bound_ms"], row["bound_by"] = bound(
        macs if dtype == torch.float32 else 0.0, es * (b * t * c + k * c + b * t_out * c),
        bf16_flops=0.0 if dtype == torch.float32 else macs)
    _report(tag, label, f"({b}, {t}, {c}) k{k} pads {pads} d{dil}", row)
    return row


def hold_b6(gen, dev, label: str, n: int, s: int, mask: bool, dk: int = 128, dv: int = 128,
            f64_rows: int = F64_ROWS, dtype=torch.float32, timed: bool = True,
            out_dtype=None) -> dict:
    """B6 against plain and float64 at one shape, scale 1/S, in ``dtype``,
    the output in ``out_dtype`` (default ``dtype``; the bf16 plan's layers
    take float32)."""
    from audiojax_torch.ops import attention_cuda as A

    out_dtype = out_dtype or dtype
    q, kk = (torch.randn((n, s, dk), generator=gen, device=dev).to(dtype) for _ in range(2))
    v = torch.randn((n, s, dv), generator=gen, device=dev).to(dtype)
    kw = dict(scale=1.0 / s, mask_diag=mask, out_dtype=out_dtype)
    run = lambda: A.quad_attention_cuda(q, kk, v, **kw)  # noqa: E731
    plain = lambda: A.quad_attention_plain(q, kk, v, **kw)  # noqa: E731
    tag = "quad_attention" if dtype == torch.float32 else "quad_attention_bf16"
    row = hold(tag, label, run(), plain(), lambda r: ref_quad64(
        *(a[r].double().cpu().numpy() for a in (q, kk, v)), 1.0 / s, mask),
        _f64_rows(n, f64_rows, dev), out_dtype)
    _time(row, timed, run, plain)
    es, eo = q.element_size(), torch.tensor([], dtype=out_dtype).element_size()
    # bf16: every product of the function once, at the bf16 rate (any
    # implementation does at least those; a kernel's extra products, as the
    # split of the f32 scores into three bf16 terms, are its design's cost)
    ops = 2.0 * n * s * s * (dk + dv)
    row["bound_ms"], row["bound_by"] = bound(
        ops if dtype == torch.float32 else 0.0, es * n * s * (2 * dk + dv) + eo * n * s * dv,
        bf16_flops=0.0 if dtype == torch.float32 else ops)
    shape = f"({n}, {s}, {dk})" if dk == dv else f"({n}, {s}, K{dk}, V{dv})"
    out = " → f32" if out_dtype != dtype else ""
    _report(tag, label, shape + (" mask" if mask else "") + out, row)
    return row


def check_gan_kernels(dev) -> dict:
    """Phase 4; returns each kernel's row at its first serving shape."""
    gen = torch.Generator(device=dev).manual_seed(0)
    serving = {}
    for label, shape, k, pads, dil in B4_CASES:
        serving.setdefault("dwconv1d", hold_b4(gen, dev, label, shape, k, pads, dil))
    for label, shape, k, pads, dil in B4_DFSMN_CASES:
        hold_b4(gen, dev, label, shape, k, pads, dil)
    for label, shape, k, pads, dil, offset in B4_OFFPATH_CASES:
        hold_b4(gen, dev, label, shape, k, pads, dil, offset=offset)
    for label, n, s, mask in B6_CASES:
        serving.setdefault("quad_attention", hold_b6(gen, dev, label, n, s, mask))
    return serving


# ── phase 5 ────────────────────────────────────────────────────────────────


def noisy_speech(n: int, seed: int, pitch: float = 140.0, rate: float = 3.0,
                 sr: int = SR) -> np.ndarray:
    """Synthetic speech-band int16 audio at ``sr`` Hz: a gliding harmonic voice
    (around ``pitch`` Hz) under a syllable-rate envelope (``rate`` Hz), plus
    white noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    f0 = pitch + 30.0 * np.sin(2 * np.pi * 0.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = sum(np.sin(k * phase) / k for k in range(1, 11))
    voiced *= (0.5 + 0.5 * np.sin(2 * np.pi * rate * t)) ** 2
    x = 0.3 * voiced / np.abs(voiced).max() + 0.05 * rng.standard_normal(n)
    return np.clip(np.round(x * 32767), -32768, 32767).astype(np.int16)


def speech_mix(n: int, seed: int, sr: int = SR) -> np.ndarray:
    """Two synthetic voices (140 Hz at 3 syllables/s, 230 Hz at 4.3/s), each
    with its own noise, mixed at equal level: a separation request."""
    a = noisy_speech(n, seed, sr=sr).astype(np.int32)
    b = noisy_speech(n, seed + 1000, pitch=230.0, rate=4.3, sr=sr).astype(np.int32)
    return ((a + b) // 2).astype(np.int16)


def music_mix(n: int, seed: int, sr: int = 44100, channels: int = 1) -> np.ndarray:
    """A vocal-separation request: a voice (220 Hz at 3 syllables/s) over a
    harmonic accompaniment (110 Hz at 0.5/s), int16 (n,); stereo (2, n) pans
    the voice left and a second accompaniment line (165 Hz at 0.7/s) right,
    so the channels differ."""
    voice = noisy_speech(n, seed, pitch=220.0, sr=sr).astype(np.int32)
    bass = noisy_speech(n, seed + 7, pitch=110.0, rate=0.5, sr=sr).astype(np.int32)
    if channels == 1:
        return ((voice + bass) // 2).astype(np.int16)
    line = noisy_speech(n, seed + 8, pitch=165.0, rate=0.7, sr=sr).astype(np.int32)
    return np.stack([(3 * voice + bass) // 4, (voice + 2 * bass + line) // 4]).astype(np.int16)


def stereo_mix(n: int, seed: int, sr: int = 44100) -> np.ndarray:
    return music_mix(n, seed, sr=sr, channels=2)


def two_mic(n: int, seed: int, sr: int = SR) -> np.ndarray:
    """A two-microphone request, int16 (2, n): a voice through a 50 ms
    decaying reverberant tail plus a white noise source; the voice reaches
    microphone 1 3 samples after microphone 0, the noise 2 samples before."""
    rng = np.random.default_rng(seed + 900)
    tail = 0.3 * rng.standard_normal(800) * np.exp(-np.arange(800) / 160.0)
    tail[0] = 1.0
    wet = np.convolve(noisy_speech(n, seed, sr=sr).astype(np.float64), tail)[:n]
    noise = 1600.0 * rng.standard_normal(n)
    mics = np.stack([wet + noise, np.roll(wet, 3) + np.roll(noise, -2)])
    return np.clip(np.round(mics), -32768, 32767).astype(np.int16)


def echo_pair(n: int, seed: int, sr: int = SR, local: bool = True) -> tuple:
    """An echo-cancellation request (near, far): the far end is a voice
    (230 Hz at 4.3 syllables/s); the near end is a local voice (140 Hz at
    3/s) plus the far end through an echo path (2.5 ms late, a decaying
    four-tap response, −6 dB), or the echo alone (``local=False``)."""
    far = noisy_speech(n, seed + 500, pitch=230.0, rate=4.3, sr=sr)
    path = np.r_[np.zeros(40), 0.5, 0.25, -0.125, 0.0625]
    near = np.convolve(far.astype(np.float64), path)[:n]
    if local:
        near = near + noisy_speech(n, seed, sr=sr)
    return np.clip(np.round(near), -32768, 32767).astype(np.int16), far


def _inputs(audio) -> tuple:
    """A request's model inputs: one clip, or a tuple of them (near, far)."""
    return audio if isinstance(audio, tuple) else (audio,)


def snr_db(ref: np.ndarray, out: np.ndarray) -> float:
    ref, out = ref.astype(np.float64), out.astype(np.float64)
    err = float(np.sum((ref - out) ** 2))
    return float("inf") if err == 0.0 else 10.0 * np.log10(float(np.sum(ref * ref)) / err)


def kernel_modules() -> tuple:
    from audiojax_torch.ops import attention_cuda, dwconv_cuda, stft_cuda

    return stft_cuda, dwconv_cuda, attention_cuda


def serve(card: str, latency: dict) -> dict:
    """Phase 5; returns the kernels' launch counts over the measured requests
    and puts the 7 s request's median latency (ms) into ``latency``."""
    from audiojax_torch.ops import stft_cuda as K
    from audiojax_torch.runtime import registry
    from audiojax_torch.runtime.session import Session

    spec = registry.get("gtcrn")
    cfg = spec.make_config()
    manifest = spec.make_manifest(cfg)
    session = Session(spec.make_module(spec.init_params(0, cfg, "cuda"), cfg), manifest,
                      device="cuda")
    requests = [("1.3 s", noisy_speech(20800, 1)), ("7 s", noisy_speech(7 * SR, 2)),
                ("30 s", noisy_speech(30 * SR, 3))]
    session.process(requests[0][1])  # warm-up: cuDNN and allocator set-up

    for mod in kernel_modules():
        mod.reset_launches()
    runs = {label: [] for label, _ in requests}
    for _ in range(SERVE_REPEATS):  # the three requests in turn, SERVE_REPEATS times
        for label, audio in requests:
            runs[label].append(session.process(audio))
    counts = {name: n for mod in kernel_modules() for name, n in mod.launches.items()}
    for name in K.launches:
        if counts[name] <= 0:
            fail(f"serving did not launch {name}")

    for label, audio in requests:
        for r in runs[label]:
            if r.audio.dtype != np.int16 or r.audio.shape != audio.shape:
                fail(f"request {label}: {r.audio.dtype} {r.audio.shape}, expected int16 "
                     f"{audio.shape}")
            if not np.any(r.audio):
                fail(f"request {label}: all-zero output")
        ms = sorted(r.elapsed_s * 1e3 for r in runs[label])
        med = float(np.median(ms))
        dur = runs[label][0].audio_duration_s
        print(f"serve gtcrn {label:6s} ({audio.size} samples, {-(-audio.size // 32000)} windows): "
              f"elapsed ms median {med:.3f} (min {ms[0]:.3f}, max {ms[-1]:.3f}, "
              f"n={len(ms)}), RTF median {med / 1e3 / dur:.6f}  [{card}]", flush=True)
    print(f"serve gtcrn launches over {SERVE_REPEATS} x 3 requests: {counts}", flush=True)

    label, audio = requests[1]
    elapsed_ms = latency["gtcrn"] = float(np.median([r.elapsed_s * 1e3 for r in runs[label]]))
    rows = cuda_rows(lambda: session.process(audio), {"stft_packed": 1, "istft_packed": 1})
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"profile gtcrn {label}: {sum(e.count for e in rows)} device launches, device busy "
          f"{busy_ms:.3f} ms of {elapsed_ms:.3f} ms median elapsed unprofiled (idle share "
          f"{1.0 - busy_ms / elapsed_ms:.4f})  [{card}]", flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}", flush=True)

    cpu_model = spec.make_module(spec.init_params(0, cfg, "cpu"), cfg)
    cpu = Session(cpu_model, manifest, device="cpu").process(audio)
    snr = snr_db(cpu.audio, runs[label][0].audio)
    print(f"serve gtcrn {label} card vs CPU: SNR {snr:.2f} dB", flush=True)
    if not snr >= MIN_SNR_DB:
        fail(f"card vs CPU SNR {snr:.2f} dB < {MIN_SNR_DB}")
    return counts


# ── phases 6, 8 and 10 ────────────────────────────────────────────────────────


def serve_windowed(card: str, name: str, per_forward: dict, seeds: tuple, latency: dict,
                   lead_silence: int = 0, clip=noisy_speech, seconds: tuple = (6,),
                   rtf: bool = False, energies=None, dtype: str = "float32",
                   inner=None) -> dict:
    """Phases 6, 8, 10, 12 and 15–23: serve ``name`` at full width and depth
    on its manifest's windows (the GAN's and ZipEnhancer's 6 s windows are
    each folded into 1.5 s fold windows); returns the kernels' launch counts
    over the measured requests of ``seconds``, whose audio ``clip(n, seed,
    sr=rate)`` makes at the manifest's input rate (DFSMN's and SE's 48 kHz,
    Mel-Band's 44.1 kHz; a tuple of clips for a two-input model, a (2, n)
    clip for a two-channel one), and puts the first request's median latency
    (ms) into ``latency``.  Every output source is checked against the shape
    the manifest gives: the input's length times its scale (SR's 3), with
    its output channels.  The clip held card against CPU (one fold window;
    where the model does not fold, one window in a bf16 plan or with
    ``energies``, else a window's first second) starts with ``lead_silence``
    zero samples, and must reach the family's gate (``GATE_DB``, else 40 dB).
    An echo canceller also prints its echo-return-loss gain; with ``rtf`` the
    module's real-time factor on one window comes from
    ``audiojax_torch.utils.profiling.measure_rtf``; ``energies(model, x)``
    gives H-GTCRN's two source energies, whose relative gap on the card and
    on the CPU is printed beside its gate (a near tie may pick different
    sources); ``inner(model, cpu_model, x)`` holds a part of the network card
    against CPU on the window ``x`` (SR's bf16 mask net).  With
    ``dtype="bfloat16"`` it serves the family's bf16 plan
    (path ``<name>_bf16``, phase 25): each request's median beside the
    float32 plan's from the same run, the first request's output held
    against the float32 plan's (``BF16_VS_F32_DB``), and the card held
    against the CPU's bf16 plan at ``GATE_DB[<name>_bf16]``."""
    from audiojax_torch.runtime import registry
    from audiojax_torch.runtime.session import Session

    spec = registry.get(name)
    bf16 = dtype != "float32"
    path = f"{name}_bf16" if bf16 else name
    cfg = spec.make_config(compute_dtype=dtype) if bf16 else spec.make_config()
    manifest = spec.make_manifest(cfg)
    window = manifest.input_audio_length
    fold = getattr(cfg, "fold_window", 0)
    head = manifest.pad_head
    sr = manifest.in_sample_rate
    model = spec.make_module(spec.init_params(0, cfg, "cuda"), cfg)  # casts a bf16 plan's tree
    session = Session(model, manifest, device="cuda")
    requests = [(f"{sec} s", _inputs(clip(sec * sr, seed, sr=sr)))
                for sec, seed in zip(seconds, seeds)]
    t0 = time.perf_counter()
    session.process(*requests[0][1])  # warm-up: cuBLAS, cuDNN and allocator set-up
    print(f"serve {path} warm-up ({requests[0][0]} request): "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms  [{card}]", flush=True)

    for mod in kernel_modules():
        mod.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    runs = {label: [] for label, _ in requests}
    for _ in range(SERVE_REPEATS):  # the two requests in turn, SERVE_REPEATS times
        for label, ins in requests:
            runs[label].append(session.process(*ins))
    counts = {k: n for mod in kernel_modules() for k, n in mod.launches.items()}
    forwards = SERVE_REPEATS * len(requests)  # one forward per request
    expect = {k: forwards * n for k, n in per_forward.items()}
    if counts != expect:
        fail(f"{path} serving launched {counts}, expected {expect}")

    for label, ins in requests:
        audio = ins[0]
        n = audio.shape[-1]
        want = expected_shape(manifest, n)
        for r in runs[label]:
            if len(r.outputs) != manifest.output_sources:
                fail(f"request {label}: {len(r.outputs)} sources, expected "
                     f"{manifest.output_sources}")
            for i, out in enumerate(r.outputs):
                if out.dtype != np.int16 or out.shape != want:
                    fail(f"request {label} source {i}: {out.dtype} {out.shape}, expected int16 "
                         f"{want}")
                if not np.any(out):
                    fail(f"request {label} source {i}: all-zero output")
        ms = sorted(r.elapsed_s * 1e3 for r in runs[label])
        med = latency[f"{path} {label}"] = float(np.median(ms))
        beside = (f"; float32 plan {latency[f'{name} {label}']:.3f} ms (same run)"
                  if bf16 and f"{name} {label}" in latency else "")
        _, _, n_win, bucket = session._window_geometry(n + head)
        folds = f", {window // fold * bucket} folds" if fold else ""
        print(f"serve {path} {label:5s} ({n} samples"
              f"{f' × {audio.shape[0]} channels' if audio.ndim > 1 else ''}"
              f"{f' × {len(ins)} inputs' if len(ins) > 1 else ''}"
              f"{f' + {head} head' if head else ''}"
              f", {n_win} windows → {bucket}{folds}; {manifest.output_sources} source(s)): "
              f"elapsed ms median {med:.3f} (min {ms[0]:.3f}, max {ms[-1]:.3f}, n={len(ms)}), "
              f"RTF median {med / 1e3 / runs[label][0].audio_duration_s:.6f}{beside}  [{card}]",
              flush=True)
    print(f"serve {path} launches over {SERVE_REPEATS} x {len(requests)} requests: "
          f"{counts}; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)

    label, ins = requests[0]
    elapsed_ms = latency[path] = float(np.median([r.elapsed_s * 1e3 for r in runs[label]]))
    if bf16:  # the bf16 plan against the float32 plan on the card, the same request
        f32_cfg = spec.make_config()
        f32 = Session(spec.make_module(spec.init_params(0, f32_cfg, "cuda"), f32_cfg), manifest,
                      device="cuda").process(*ins)
        snrs = [snr_db(a, b) for a, b in zip(f32.outputs, runs[label][0].outputs)]
        gate32 = BF16_VS_F32_GATE_DB.get(path, BF16_VS_F32_DB)
        print(f"serve {path} {label} card bf16 vs card float32: SNR "
              f"{', '.join(f'{v:.2f}' for v in snrs)} dB (gate {gate32:g})", flush=True)
        if not min(snrs) >= gate32:
            fail(f"{path} bf16 vs float32 SNR {min(snrs):.2f} dB < {gate32}")
        del f32
    rows = cuda_rows(lambda: session.process(*ins), per_forward)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"profile {path} {label}: {sum(e.count for e in rows)} device launches, "
          f"device busy {busy_ms:.3f} ms of {elapsed_ms:.3f} ms median elapsed unprofiled "
          f"(idle share {1.0 - busy_ms / elapsed_ms:.4f})  [{card}]", flush=True)
    # one request is one forward: every launch of the trace, beside the ported kernels'
    print(f"profile {path} {label}: launches a forward {sum(e.count for e in rows)} in all, "
          + ", ".join(f"{k} {n}" for k, n in per_forward.items() if n), flush=True)
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}", flush=True)
    for k, n in per_forward.items():
        if not n:
            continue
        mine = [e for e in rows if is_kernel(k, e.key)]
        print(f"profile {path} {label}: {k} "
              f"{sum(e.self_device_time_total for e in mine) / 1e3:.3f} ms device time over "
              f"{sum(e.count for e in mine)} launches (same trace)", flush=True)

    # card vs CPU through the module on one fold window, or on a window's
    # first second where the float32 plan's gate has the room (40 dB against
    # readings of 70 dB and more): the CPU forward of a whole window took up
    # to 20 s (SS); the bf16 gates and H-GTCRN's stand at their readings and
    # keep their whole window
    length = fold or (window if bf16 or energies else min(window, sr))
    clips = _inputs(clip(length, seeds[2], sr=sr))
    for c in clips:
        c[..., :lead_silence] = 0
    xs = [torch.from_numpy(c[None]) for c in clips]
    cpu_model = spec.make_module(spec.init_params(0, cfg, "cpu"), cfg)
    with torch.inference_mode():
        card_out = model(*[x.cuda() for x in xs])
        t0 = time.perf_counter()
        cpu_out = cpu_model(*xs)
        cpu_s = time.perf_counter() - t0
        gap = ("" if energies is None else "; source energy gap card "
               + ", ".join(f"{energy_gap(energies(m, x)):.4f}"
                           for m, x in ((model, xs[0].cuda()), (cpu_model, xs[0])))
               + " / CPU")
    hold_card_vs_cpu(f"serve {path} {length / sr:g} s {'fold' if fold else 'window'}", path,
                     card_out, cpu_out, f"(CPU forward {cpu_s:.1f} s){gap}")
    if inner is not None:
        inner(model, cpu_model, xs[0])
    if lead_silence and not bf16:
        frame0_witness(name, model, cpu_model, clip(length, seeds[2], sr=sr))
    if manifest.task == "aec":  # no gate: the weights are random
        near, far = clip(seconds[0] * sr, seeds[2] + 1, sr=sr, local=False)
        out = session.process(near, far).audio.astype(np.float64)
        erle = 10.0 * np.log10(np.sum(near.astype(np.float64) ** 2) / max(np.sum(out ** 2), 1.0))
        print(f"serve {path} echo-only {seconds[0]} s pair: echo-return-loss gain {erle:.2f} dB "
              "(random weights, no gate)", flush=True)
    if rtf:
        from audiojax_torch.utils.profiling import measure_rtf

        xs = [torch.from_numpy(c[None]).cuda() for c in _inputs(clip(window, seeds[0], sr=sr))]
        r = measure_rtf(lambda _, x: model(x, *xs[1:]), None, xs[0], sample_rate=sr, iters=3,
                        settle=1)
        print(f"serve {path} measure_rtf on one {window / sr:g} s window (passes chained "
              f"through the first input, CUDA events; 3 timed after a warm-up and 1 settle): "
              f"{r['latency_s'] * 1e3:.3f} ms a pass, RTF {r['rtf']:.6f}  [{card}]", flush=True)
    return counts


def expected_shape(manifest, n: int) -> tuple:
    """An output source's shape for an input of ``n`` samples: its length
    times the manifest's scale, with the manifest's output channels."""
    n_out = int(round(n * manifest.input_to_output_scale))
    return (n_out,) if manifest.output_channels == 1 else (manifest.output_channels, n_out)


def energy_gap(e: torch.Tensor) -> float:
    """Relative gap of a window's two source energies (B = 1)."""
    e = e.double().cpu()[0]
    return float((e[0] - e[1]).abs() / e.max())


def hold_card_vs_cpu(tag: str, name: str, card_out, cpu_out, note: str) -> list:
    """Each output source's int16 SNR, card against CPU, held at the family's
    gate; returns the SNRs."""
    if not isinstance(card_out, tuple):
        card_out, cpu_out = (card_out,), (cpu_out,)
    gate = GATE_DB.get(name, MIN_SNR_DB)
    snrs = [snr_db(h.numpy(), c.cpu().numpy()) for c, h in zip(card_out, cpu_out)]
    print(f"{tag} card vs CPU: SNR {', '.join(f'{v:.2f}' for v in snrs)} dB (gate {gate:g}) "
          f"{note}", flush=True)
    if not min(snrs) >= gate:
        fail(f"{name} card vs CPU SNR {min(snrs):.2f} dB < {gate}")
    return snrs


def time_sr_upsampling(card: str, dev) -> None:
    """Phase 22: the generator's two stride-8 transposed convs at a 6 s
    request's 8 windows, as the model runs them (``F.conv_transpose1d`` on
    the stored forward kernel) and as the JAX package's form does (zeros
    stuffed between the inputs, then a forward conv: 8× the products), held
    against each other and timed by CUDA events."""
    import torch.nn.functional as F

    from audiojax_torch.models.mossformer_sr import MossFormerSrConfig, _conv_transpose

    cfg = MossFormerSrConfig()
    gen = torch.Generator(device=dev).manual_seed(5)
    ch, t = cfg.gen_channels, 375
    for i, (r, k) in enumerate(zip(cfg.gen_up_rates[:2], cfg.gen_up_kernels[:2])):
        x = torch.randn((8, ch, t), generator=gen, device=dev)
        p = {"w": torch.randn((ch // 2, ch, k), generator=gen, device=dev) / (ch * k) ** 0.5,
             "b": torch.randn((ch // 2,), generator=gen, device=dev)}
        pad = (k - r) // 2

        def stuffed():
            z = x.new_zeros((x.shape[0], ch, (t - 1) * r + 1))
            z[..., ::r] = x
            return F.conv1d(z, p["w"], p["b"], padding=k - 1 - pad)

        ours, ref = _conv_transpose(p, x, stride=r, padding=pad), stuffed()
        err = float((ours - ref).abs().max() / ref.abs().max())
        if ours.shape != ref.shape or not err <= TOL_B4_B6:
            fail(f"sr up{i}: conv_transpose1d vs zero-stuffed {tuple(ours.shape)} "
                 f"{tuple(ref.shape)}, err {err:.3e}")
        gflop = 2.0 * x.shape[0] * t * ch * (ch // 2) * k / 1e9  # each input × k × outputs
        print(f"sr up{i} (8, {ch}, {t}) → (8, {ch // 2}, {ours.shape[-1]}) stride {r} k{k}: "
              f"err/max|ref| {err:.2e}; device ms: conv_transpose1d (served) "
              f"{device_ms(lambda: _conv_transpose(p, x, stride=r, padding=pad)):.4f}, zero-"
              f"stuffed conv1d {device_ms(stuffed):.4f}; {gflop:.1f} GFLOP of products (stuffed "
              f"{gflop * r:.1f})  [{card}]", flush=True)
        ch, t = ch // 2, ours.shape[-1]


def frame0_witness(name: str, model, cpu_model, clip_np: np.ndarray) -> None:
    """The fold without its leading silence: card and CPU may part at the first
    STFT frame only, whose phase feature is the sign of rounding noise
    (``tests/test_torch_zipenhancer.py``).  With the CPU's frame 0 put into its
    own STFT, the card must pass the SNR gate."""
    mod = sys.modules[type(model).__module__]
    kernel_stft, cpu_frame0, swap = mod.fast_stft_packed, [], [False]

    def stft(x, stft_cfg):
        pk = kernel_stft(x, stft_cfg)
        if not pk.is_cuda:
            cpu_frame0.append(pk[:, 0].clone())
        elif swap[0]:
            pk[:, 0] = cpu_frame0[0].to(pk.device)
        return pk

    clip = torch.from_numpy(clip_np[None])
    mod.fast_stft_packed = stft
    try:
        with torch.inference_mode():
            cpu_out = cpu_model(clip).numpy()
            card_out = model(clip.cuda()).cpu().numpy()
            swap[0] = True
            swapped = model(clip.cuda()).cpu().numpy()
    finally:
        mod.fast_stft_packed = kernel_stft
    snr, snr_swapped = snr_db(cpu_out, card_out), snr_db(cpu_out, swapped)
    print(f"serve {name} 1.5 s fold without the silence: card vs CPU SNR {snr:.2f} dB; "
          f"card with the CPU's frame 0 {snr_swapped:.2f} dB", flush=True)
    if not snr_swapped >= MIN_SNR_DB:
        fail(f"{name} card with the CPU's frame 0 vs CPU SNR {snr_swapped:.2f} dB < {MIN_SNR_DB}")


# ── phase 7 ────────────────────────────────────────────────────────────────


def ref_relpos64(q: np.ndarray, k: np.ndarray, pp: np.ndarray, pe: np.ndarray) -> np.ndarray:
    h, n_pos = pe.shape[:2]
    n, s, hd = q.shape
    qh = q.reshape(n, s, h, hd // h).transpose(0, 2, 1, 3)
    kh = k.reshape(n, s, h, hd // h).transpose(0, 2, 3, 1)
    pph = pp.reshape(n, s, h, -1)[..., :n_pos]
    scores = np.matmul(qh, kh) + np.einsum("nihp,hpij->nhij", pph, pe, optimize=True)
    e = np.exp(scores - scores.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


# (label, N, S): ZipEnhancer's serving shapes at one 6 s window (4 folds of
# 241 frames, 101 bins after the encoder's strided conv; encoder 1 pools 2×2,
# encoder 2 4×4), the 30 s request's two largest (32 folds), and one row
# longer than 256 keys for the two-pass route.  H = 4, D = 32, P = 4 (stride 8).
B3_CASES = [
    ("ts0/ts3 f path", 964, 101),
    ("ts0/ts3 t path", 404, 241),
    ("ts1 f path", 484, 51),
    ("ts1 t path", 204, 121),
    ("ts2 f path", 244, 26),
    ("ts2 t path", 104, 61),
    ("30 s f path", 7712, 101),
    ("30 s t path", 3232, 241),
    ("two-pass", 16, 601),
]


def hold_b3(gen, dev, label: str, n: int, s: int, dtype=torch.float32) -> dict:
    """B3 against plain and float64 at one ZipEnhancer shape, in ``dtype``
    (bf16: pe and the probabilities too).  H = 4, D = 32, P = 4 (stride 8)."""
    from audiojax_torch.ops import attention_cuda as A

    h, d, n_pos = 4, 32, 4
    stride = A.pos_stride(n_pos)
    # q, k and pp as lane slices of one packed projection, as the model has them
    proj = (0.5 * torch.randn((n, s, 2 * h * d + h * stride), generator=gen, device=dev)).to(dtype)
    q, k, pp = proj[..., : h * d], proj[..., h * d : 2 * h * d], proj[..., 2 * h * d :]
    pe = (0.5 * torch.randn((h, n_pos, s, s), generator=gen, device=dev)).to(dtype)
    rows = torch.linspace(0, n - 1, min(n, F64_ROWS), device=dev).long().unique()
    run = lambda: A.relpos_scores_cuda(q, k, pp, pe, num_heads=h)  # noqa: E731
    plain = lambda: A.relpos_scores_plain(q, k, pp, pe, num_heads=h)  # noqa: E731
    pe64 = pe.double().cpu().numpy()
    tag = "relpos_scores" if dtype == torch.float32 else "relpos_scores_bf16"
    row = hold(tag, label, run(), plain(), lambda r: ref_relpos64(
        *(a[r].double().cpu().numpy() for a in (q, k, pp)), pe64), rows, dtype)
    _time(row, True, run, plain)
    # per probability: D-term dot product, P-term bias, max, subtract, exp,
    # sum, divide (bf16: the dot products' bf16 operands at the bf16 rate);
    # bytes: q, k, the P used terms of pp (not its padded slots) and pe read
    # once, probs written once
    es = proj.element_size()
    dots = n * h * s * s * (2.0 * d + 2.0 * n_pos)
    rest = n * h * s * s * 5.0
    row["bound_ms"], row["bound_by"] = bound(
        rest + (dots if dtype == torch.float32 else 0.0),
        es * (n * s * h * (2 * d + n_pos) + h * n_pos * s * s + n * h * s * s),
        bf16_flops=0.0 if dtype == torch.float32 else dots)
    _report(tag, label, f"({n}, {s}) H{h} D{d} P{n_pos}", row)
    return row


def check_zip_kernels(dev) -> dict:
    """Phase 7; returns B3's row at its first serving shape."""
    gen = torch.Generator(device=dev).manual_seed(1)
    serving = {}
    for label, n, s in B3_CASES:
        serving.setdefault("relpos_scores", hold_b3(gen, dev, label, n, s))
    return serving


# ── phase 9 ────────────────────────────────────────────────────────────────


def ref_grouped64(x: np.ndarray, w: np.ndarray, pads, dilation: int) -> np.ndarray:
    """x (B, T, M·G), w (k, M, G): group g reads the interleaved lanes g·M + m."""
    k, m, _ = w.shape
    xp = np.pad(x, [(0, 0), tuple(pads), (0, 0)])
    t_out = xp.shape[1] - dilation * (k - 1)
    return sum(xp[:, i * dilation : i * dilation + t_out, r::m] * w[i, r]
               for i in range(k) for r in range(m))


# MossFormer2-SS at its serving shapes: a 6 s request is 4 windows of 3999
# frames, a 30 s request 16.  (label, (B, T, 2G), k, (lo, hi), dilation) for
# B5, the FSMN's second memory level; the B4 and B6 shapes of a layer.
B5_SS_CASES = [
    ("ss mem_stack[1]", (4, 3999, 512), 39, (38, 38), 2),
    ("ss 30 s mem_stack[1]", (16, 3999, 512), 39, (38, 38), 2),
]
B4_SS_CASES = [
    ("ss flash in_conv", (4, 3999, 2176), 17, (8, 8), 1),
    ("ss out_conv, uv_conv", (4, 3999, 512), 17, (8, 8), 1),
    ("ss mem_stack[0]", (4, 3999, 256), 39, (19, 19), 1),
    ("ss 30 s flash in_conv", (16, 3999, 2176), 17, (8, 8), 1),
    ("ss 30 s out_conv, uv_conv", (16, 3999, 512), 17, (8, 8), 1),
    ("ss 30 s mem_stack[0]", (16, 3999, 256), 39, (19, 19), 1),
]
B6_SS_CASES = [("ss flash group", 64, 256), ("ss 30 s flash group", 256, 256)]  # K 128, V 2048
# (label, (B, T, 2G), k, (lo, hi), dilation, offset): B5 bf16 off its served
# route: an x 2 bytes past a 16-byte boundary takes the FFMA kernel's bf16
# instance (ops/dwconv_cuda.py:mma_route)
B5_OFFPATH_CASES = [("ss mem_stack[1], x at a 1-element offset", (4, 3999, 512), 39, (38, 38), 2,
                     1)]
SS_F64_ROWS = 4  # float64 on the host is slow at T = 3999 and V = 2048


# MossFormer2-SE at its serving shapes: a 6 s 48 kHz request is 4 windows of
# 246 frames, a 30 s request 16.  (label, (B, T, C), k, (lo, hi), dilation)
# for B4; (label, N, S) for B6 (one FLASH group of 256 a window, K 128, V 2048)
B4_SE_CASES = [
    ("se flash in_conv", (4, 246, 2176), 17, (8, 8), 1),
    ("se out_conv, uv_conv", (4, 246, 512), 17, (8, 8), 1),
    ("se fsmn memory", (4, 246, 256), 39, (19, 19), 1),
    ("se 30 s flash in_conv", (16, 246, 2176), 17, (8, 8), 1),
    ("se 30 s out_conv, uv_conv", (16, 246, 512), 17, (8, 8), 1),
    ("se 30 s fsmn memory", (16, 246, 256), 39, (19, 19), 1),
]
B6_SE_CASES = [("se flash group", 4, 256), ("se 30 s flash group", 16, 256)]
# MossFormer2-SR at its serving shapes: a 2 s window of 16 kHz is 375 mel
# frames, a 6 s request 5 windows bucketed to 8, a 30 s request 24 to 32;
# the FLASH groups pad 375 frames to two of 256
B4_SR_CASES = [
    ("sr flash in_conv", (8, 375, 2176), 17, (8, 8), 1),
    ("sr out_conv, uv_conv", (8, 375, 512), 17, (8, 8), 1),
    ("sr fsmn memory", (8, 375, 256), 39, (19, 19), 1),
    ("sr 30 s flash in_conv", (32, 375, 2176), 17, (8, 8), 1),
    ("sr 30 s out_conv, uv_conv", (32, 375, 512), 17, (8, 8), 1),
    ("sr 30 s fsmn memory", (32, 375, 256), 39, (19, 19), 1),
]
B6_SR_CASES = [("sr flash group", 16, 256), ("sr 30 s flash group", 64, 256)]


def check_se_kernels(dev) -> None:
    """Phase 14: B4 and B6 at the MossFormer2-SE and MossFormer2-SR serving shapes."""
    gen = torch.Generator(device=dev).manual_seed(3)
    for label, shape, k, pads, dil in B4_SE_CASES + B4_SR_CASES:
        hold_b4(gen, dev, label, shape, k, pads, dil, f64_rows=SS_F64_ROWS)
    for label, n, s in B6_SE_CASES + B6_SR_CASES:
        hold_b6(gen, dev, label, n, s, False, dk=128, dv=2048, f64_rows=SS_F64_ROWS)


def hold_b5(gen, dev, label: str, shape: tuple, k: int, pads: tuple, dil: int,
            dtype=torch.float32, offset: int = 0, timed: bool = True) -> dict:
    """B5 against plain and float64 at one MossFormer2-SS shape, timed beside
    cuDNN's grouped conv, in ``dtype``; x starts ``offset`` elements into a
    larger buffer."""
    import torch.nn.functional as F

    from audiojax_torch.ops import dwconv_cuda as D

    b, t, c = shape
    g = c // 2
    x = torch.randn((b * t * c + offset,), generator=gen, device=dev).to(dtype)[offset:]
    x = x.view(b, t, c)
    # the model's (G, 2, k) weight seen as (k, 2, G), as nn/core.py passes it
    w = (torch.randn((g, 2, k), generator=gen, device=dev) / (2 * k) ** 0.5).to(dtype)
    w = w.permute(2, 1, 0)
    run = lambda: D.dwconv1d_grouped_cuda(x, w, pads=pads, dilation=dil)  # noqa: E731
    plain = lambda: D.dwconv1d_grouped_plain(x, w, pads=pads, dilation=dil)  # noqa: E731
    w64 = w.double().cpu().numpy()
    tag = "dwconv1d_tiled" if dtype == torch.float32 else "dwconv1d_tiled_bf16"
    row = hold(tag, label, run(), plain(), lambda r: ref_grouped64(
        x[r].double().cpu().numpy(), w64, pads, dil), _f64_rows(b, SS_F64_ROWS, dev), dtype)
    # cuDNN's grouped conv (groups=G, two input channels a group) on a
    # contiguous (B, 2G, T) tensor, the layout change left out of the timing
    xt = F.pad(x.transpose(1, 2), pads).contiguous()
    wt = w.permute(2, 1, 0).contiguous()
    _time(row, timed, run, plain, lambda: F.conv1d(xt, wt, dilation=dil, groups=g))
    t_out = t + sum(pads) - dil * (k - 1)
    es = x.element_size()
    macs = 2.0 * b * t_out * g * 2 * k
    row["bound_ms"], row["bound_by"] = bound(
        macs if dtype == torch.float32 else 0.0, es * (b * t * c + k * c + b * t_out * g),
        bf16_flops=0.0 if dtype == torch.float32 else macs)
    _report(tag, label, f"({b}, {t}, {c}→{g}) k{k} pads {pads} d{dil}", row)
    return row


def check_ss_kernels(dev) -> dict:
    """Phase 9; returns B5's row at its first serving shape."""
    gen = torch.Generator(device=dev).manual_seed(2)
    serving = {}
    for label, shape, k, pads, dil in B5_SS_CASES:
        serving.setdefault("dwconv1d_tiled", hold_b5(gen, dev, label, shape, k, pads, dil))
    for label, shape, k, pads, dil in B4_SS_CASES:
        hold_b4(gen, dev, label, shape, k, pads, dil, f64_rows=SS_F64_ROWS)
    for label, n, s in B6_SS_CASES:
        hold_b6(gen, dev, label, n, s, False, dk=128, dv=2048, f64_rows=SS_F64_ROWS)
    return serving


# ── phases 24 and 25 ───────────────────────────────────────────────────────


def six_s(cases: list) -> list:
    """The cases of a 6 s request (and the off-request ones): the bf16 plans
    serve no 30 s request."""
    return [c for c in cases if "30 s" not in c[0]]


def check_bf16_kernels(dev) -> dict:
    """Phase 24: B3, B4, B5 and B6 in bfloat16 at every shape of the bf16
    serving paths (ZipEnhancer, MossFormerGAN-SE and MossFormer2-SS: their
    float32 shapes of a 6 s request, B3_CASES, B4_CASES, B5_SS_CASES,
    B4_SS_CASES, B6_CASES, B6_SS_CASES; B4's and B5's off-path routes too),
    each within one bf16 ulp of its plain version (B6 as the layers take it,
    float32 out: within TOL_B4_B6)
    and within 2× its float64 error; timed at the serving shapes (cuDNN's
    bf16 conv beside B4 and B5), the off-path ones held only; returns each
    bf16 instance's row at its first serving shape."""
    gen = torch.Generator(device=dev).manual_seed(24)
    bf, f32 = torch.bfloat16, torch.float32
    serving = {}
    for label, shape, k, pads, dil in six_s(B4_CASES):
        serving.setdefault("dwconv1d_bf16", hold_b4(gen, dev, label, shape, k, pads, dil,
                                                    dtype=bf))
    for label, shape, k, pads, dil in six_s(B4_SS_CASES):
        hold_b4(gen, dev, label, shape, k, pads, dil, f64_rows=SS_F64_ROWS, dtype=bf)
    for label, shape, k, pads, dil, offset in B4_OFFPATH_CASES:  # C % 8 != 0 in bf16 too
        hold_b4(gen, dev, label, shape, k, pads, dil, offset=offset, dtype=bf, timed=False)
    for label, shape, k, pads, dil in six_s(B5_SS_CASES):
        serving.setdefault("dwconv1d_tiled_bf16", hold_b5(gen, dev, label, shape, k, pads, dil,
                                                          dtype=bf))
    for label, shape, k, pads, dil, offset in B5_OFFPATH_CASES:  # the FFMA kernel's route
        hold_b5(gen, dev, label, shape, k, pads, dil, dtype=bf, offset=offset, timed=False)
    # B6 as the bf16 layers take it, its f32 sums out in f32; the Pallas
    # contract's bf16 output (one rounding of the same sums) at one shape
    for label, n, s, mask in six_s(B6_CASES):
        serving.setdefault("quad_attention_bf16", hold_b6(gen, dev, label, n, s, mask, dtype=bf,
                                                          out_dtype=f32))
    for label, n, s in six_s(B6_SS_CASES):
        hold_b6(gen, dev, label, n, s, False, dk=128, dv=2048, f64_rows=SS_F64_ROWS, dtype=bf,
                out_dtype=f32)
    hold_b6(gen, dev, B6_CASES[0][0], *B6_CASES[0][1:], dtype=bf, timed=False)
    for label, n, s in six_s(B3_CASES):
        serving.setdefault("relpos_scores_bf16", hold_b3(gen, dev, label, n, s, dtype=bf))
    return serving


def serve_bf16(card: str, latency: dict) -> dict:
    """Phase 25: the bf16 plans of MossFormerGAN-SE, ZipEnhancer and
    MossFormer2-SS, on the 6 s requests of phases 6, 8 and 10 (their seeds;
    their 30 s ones launch what the 6 s ones do, and are left out for time)."""
    return {f"{name}_bf16": serve_windowed(card, name, bf16_plan(per_forward), seeds, latency,
                                          dtype="bfloat16", seconds=(6,), **kw)
            for name, per_forward, seeds, kw in (
                ("mossformergan_se", GAN_PER_FORWARD, (11, 12, 13), {}),
                ("zipenhancer", ZIP_PER_FORWARD, (21, 22, 23), {"lead_silence": 201}),
                ("mossformer2_ss", SS_PER_FORWARD, (31, 32, 33), {"clip": speech_mix}))}


# ── phase 11 ───────────────────────────────────────────────────────────────

# GTCRN launches per forward: one STFT and one ISTFT over the window batch
GTCRN_PER_FORWARD = {"stft_packed": 1, "istft_packed": 1, "dwconv1d": 0, "dwconv1d_tiled": 0,
                     "quad_attention": 0, "relpos_scores": 0, **NO_BF16}
# (family, request seconds, launches a forward, seed, clip, leading silence of
# the clip held card against CPU)
IMPORTED = [
    ("gtcrn", 7, GTCRN_PER_FORWARD, 41, noisy_speech, 0),
    ("mossformergan_se", 6, GAN_PER_FORWARD, 42, noisy_speech, 0),
    ("zipenhancer", 6, ZIP_PER_FORWARD, 43, noisy_speech, 201),
    ("mossformer2_ss", 6, SS_PER_FORWARD, 44, speech_mix, 0),
    ("dfsmn", 6, DFSMN_PER_FORWARD, 45, noisy_speech, 0),
    ("mossformer2_se", 6, SE_PER_FORWARD, 46, noisy_speech, 0),
    ("ul_unas", 7, UL_PER_FORWARD, 47, noisy_speech, 0),
    ("nkf_aec", 6, NKF_PER_FORWARD, 48, echo_pair, 0),
    ("sdaec", 6, AEC319_PER_FORWARD, 49, echo_pair, 0),
    ("deep_echo", 6, AEC319_PER_FORWARD, 50, echo_pair, 0),
    ("dfsmn_aec", 6, CASCADE_PER_FORWARD, 51, echo_pair, 0),
    ("melband_roformer", 6, MELBAND_PER_FORWARD, 52, music_mix, 0),
    ("melband_roformer_stereo", 6, MELBAND_PER_FORWARD, 53, stereo_mix, 0),
    ("mossformer2_sr", 6, SR_PER_FORWARD, 54, noisy_speech, 0),
    ("h_gtcrn", 6, HGTCRN_PER_FORWARD, 55, two_mic, 0),
]
IMPORTED_REPEATS = 1  # requests a family after its warm-up (its launches are checked exactly)


def load_builders():
    """``tests/test_torch_ckpt_builders.py`` (torch, numpy and the port only)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "tests" / "test_torch_ckpt_builders.py"
    spec = importlib.util.spec_from_file_location("test_torch_ckpt_builders", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, f"{path}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, f"{path}/{i}")]
    return [(path, tree)]


# the families whose CPU forward of a fold or window takes seconds, and whose
# own phase (6, 10, 22) holds the same code card against CPU at the same
# gate: phase 11 checks their artifact (bit for bit), launches and latency
CPU_HELD_IN_OWN_PHASE = ("mossformergan_se", "mossformer2_ss", "mossformer2_sr")


def serve_imported(card: str, random_ms: dict) -> dict:
    """Phase 11; returns each family's kernel launch counts over its measured
    request, by path name."""
    import tempfile
    from pathlib import Path

    from audiojax_torch.importers import import_checkpoint
    from audiojax_torch.params import params_from_numpy
    from audiojax_torch.runtime import registry
    from audiojax_torch.runtime.checkpoint import load_artifact
    from audiojax_torch.runtime.export import export_artifact
    from audiojax_torch.runtime.session import Session

    builders = load_builders()
    by_path, summary = {}, []
    for name, seconds, per_forward, seed, clip, lead_silence in IMPORTED:
        spec = registry.get(name)
        cfg = spec.make_config()
        t0 = time.perf_counter()
        sd = builders.BUILDERS[name](cfg, seed=seed)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tree = import_checkpoint(name, sd, **builders.import_kwargs(name, cfg))
        import_s = time.perf_counter() - t0
        with tempfile.TemporaryDirectory(prefix=f"artifact_{name}_") as tmp:
            t0 = time.perf_counter()
            report = export_artifact(name, sd, tmp, cfg=cfg, device="cuda")
            export_s = time.perf_counter() - t0
            audit = json.loads((Path(tmp) / "import_report.json").read_text())
            if (audit["unconsumed"] or audit["checkpoint_keys"] != len(sd)
                    or audit["consumed"] + len(audit["ignored_buffers"]) != len(sd)):
                fail(f"{name} import report: {audit}")
            t0 = time.perf_counter()
            params, manifest = load_artifact(tmp, device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            cpu_params, _ = load_artifact(tmp, device="cpu")
        got, want = _leaves(params), _leaves(params_from_numpy(tree, "cuda"))
        if [p for p, _ in got] != [p for p, _ in want]:
            fail(f"{name} artifact keys differ from the import tree's")
        for (path, a), (_, b) in zip(got, want):
            if not (a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)):
                fail(f"{name} artifact leaf {path} differs from the import tree's")
        del want, sd
        print(f"imported {name}: {audit['checkpoint_keys']} checkpoint keys "
              f"({len(audit['ignored_buffers'])} step counters ignored) → {len(got)} tensors, "
              f"{sum(t.numel() for _, t in got)} parameters; build {build_s:.3f} s, import "
              f"{import_s:.3f} s, export {export_s:.3f} s (import, params.pt, card smoke: "
              f"{report['smoke']}), load onto the card {load_s:.3f} s; artifact == import "
              f"tree bit for bit", flush=True)

        model = spec.make_module(params, cfg)
        session = Session(model, manifest, device="cuda")
        sr = manifest.in_sample_rate
        ins = _inputs(clip(seconds * sr, seed, sr=sr))
        audio = ins[0]
        session.process(*ins)  # warm-up: this model's first request
        for mod in kernel_modules():
            mod.reset_launches()
        runs = [session.process(*ins) for _ in range(IMPORTED_REPEATS)]
        counts = {k: n for mod in kernel_modules() for k, n in mod.launches.items()}
        expect = {k: IMPORTED_REPEATS * n for k, n in per_forward.items()}
        if counts != expect:
            fail(f"imported {name} serving launched {counts}, expected {expect}")
        by_path[f"{name} (imported)"] = counts
        want = expected_shape(manifest, audio.shape[-1])
        for r in runs:
            if len(r.outputs) != manifest.output_sources:
                fail(f"imported {name}: {len(r.outputs)} sources")
            for out in r.outputs:
                if out.dtype != np.int16 or out.shape != want or not np.any(out):
                    fail(f"imported {name}: {out.dtype} {out.shape}, expected int16 "
                         f"{want}, not all zero")
        ms = sorted(r.elapsed_s * 1e3 for r in runs)
        med = float(np.median(ms))
        print(f"imported {name} {seconds} s request: elapsed ms median {med:.3f} (min "
              f"{ms[0]:.3f}, max {ms[-1]:.3f}, n={len(ms)}); random weights, same request "
              f"size, this run: {random_ms[name]:.3f}; launches a forward "
              f"{ {k: n for k, n in per_forward.items() if n} }  [{card}]", flush=True)

        # card vs CPU through the module on one fold window, or on the first
        # second of one window: the CPU forward of a whole window of the
        # larger families took seconds each (each family's own phase holds
        # a whole one)
        length = getattr(cfg, "fold_window", 0) or min(manifest.input_audio_length, sr)
        clips = _inputs(clip(length, seed + 100, sr=sr))
        for c in clips:
            c[..., :lead_silence] = 0
        xs = [torch.from_numpy(c[None]) for c in clips]
        if name in CPU_HELD_IN_OWN_PHASE:
            snrs = []
            print(f"imported {name}: card vs CPU left to its own phase, for time", flush=True)
        else:
            with torch.inference_mode():
                card_out = model(*[x.cuda() for x in xs])
                t0 = time.perf_counter()
                cpu_out = spec.make_module(cpu_params, cfg)(*xs)
            cpu_s = time.perf_counter() - t0
            snrs = hold_card_vs_cpu(f"imported {name} {length / sr:g} s", name, card_out,
                                    cpu_out, f"(CPU forward {cpu_s:.1f} s)")
        summary.append({"model": name, "import_s": round(import_s, 3),
                        "export_s": round(export_s, 3), "load_s": round(load_s, 3),
                        "latency_ms": round(med, 3), "random_latency_ms": round(random_ms[name], 3),
                        "card_vs_cpu_db": [round(v, 2) for v in snrs]})
        del model, session, params, cpu_params
    print(json.dumps({"imported": summary}), flush=True)
    return by_path


# ── phase 13 ───────────────────────────────────────────────────────────────

STREAM_LANES, STREAM_BLOCK_HOPS = 8, 4
NO_LAUNCHES = {"stft_packed": 0, "istft_packed": 0, "dwconv1d": 0, "dwconv1d_tiled": 0,
               "quad_attention": 0, "relpos_scores": 0, **NO_BF16}
# (model, clip seconds, the ported kernels' launches a step, first clip seed,
# the eager check): GTCRN's and UL-UNAS's steps analyse their block on B1
# (their synthesis is a matrix product and an overlap-add), NKF's, SDAEC's
# and Deep-Echo's their near‖far blocks in one B1 call; DFSMN's runs its 9
# FSMN memories on B4 (its analysis and synthesis are matrix products), and
# the DFSMN-AEC cascade both (its SDAEC backend's B1, its mask net's B4).
# The eager check: None drives the eager server and the CPU sessions over
# every lane and the whole clip, and profiles 10 eager steps and 5 replays;
# (lanes, seconds) drives them, and a second graphed drive to hold against
# them, over that many lanes and the clips' first seconds, and profiles 2
# eager steps and 2 replays (SDAEC's step issues ~9.7k launches, and the
# profiler's post-processing of such traces takes tens of seconds; GTCRN's
# and UL-UNAS's eager drives and CPU sessions over every lane took most of
# this phase).  The graph must equal the eager server to the LSB (within 1
# LSB with no short check).  The echo cancellers' checks cover the clips'
# first second: their eager steps (~120 ms each) and CPU sessions took most of
# their 45–52 s at 2 s, and 3 s clips instead saved nothing measurable (nor
# did 3 s lanes in place of 6–7 s ones: 28.4 against 29.5 s for SDAEC).
# DFSMN's and NKF-AEC's checks cover 2 lanes × 2 s as GTCRN's do, for time.
STREAMS = [
    ("gtcrn", 7, {**NO_LAUNCHES, "stft_packed": 1}, 60, (2, 2)),
    ("dfsmn", 6, {**NO_LAUNCHES, "dwconv1d": 9}, 70, (2, 2)),
    ("ul_unas", 7, {**NO_LAUNCHES, "stft_packed": 1}, 80, (2, 2)),
    ("nkf_aec", 6, {**NO_LAUNCHES, "stft_packed": 1}, 90, (2, 2)),
    ("sdaec", 3, {**NO_LAUNCHES, "stft_packed": 1}, 100, (2, 0.5)),
    ("deep_echo", 3, {**NO_LAUNCHES, "stft_packed": 1}, 110, (2, 0.5)),
    ("dfsmn_aec", 3, {**NO_LAUNCHES, "stft_packed": 1, "dwconv1d": 9}, 120, (2, 0.5)),
]
TIMED_STEPS = 50  # steps timed apart from the drive, each way (eager: 10 with a short check)
TRACED_REPLAYS = 5


def launch_counts() -> dict:
    return {k: n for mod in kernel_modules() for k, n in mod.launches.items()}


def drive_streams(server, clips: list, seed: int) -> tuple:
    """Open a lane per clip (a tuple of one clip per model input), push all
    clips through ``push_many`` in irregular chunks (sizes from ``seed``, each
    lane its own), then flush each lane.  Returns the lanes' outputs, each
    tick's wall seconds and the drive's."""
    ticks, inner = [], server._tick

    def timed(ready):
        t0 = time.perf_counter()
        out = inner(ready)
        ticks.append(time.perf_counter() - t0)
        return out

    server._tick = timed
    rng = np.random.default_rng(seed)
    sids = [server.open() for _ in clips]
    outs = {sid: [] for sid in sids}
    pos = [0] * len(clips)
    t0 = time.perf_counter()
    while any(p < c[0].size for p, c in zip(pos, clips)):
        pushes = {}
        for i, (sid, clip) in enumerate(zip(sids, clips)):
            if pos[i] < clip[0].size:
                size = int(rng.integers(1, 3 * server.block))
                pushes[sid] = tuple(c[pos[i]:pos[i] + size] for c in clip)
                pos[i] += size
        for sid, out in server.push_many(pushes).items():
            outs[sid].append(out)
    for sid in sids:
        outs[sid].append(server.flush(sid))
    total = time.perf_counter() - t0
    del server._tick  # the class's own again
    for sid in sids:
        server.close(sid)
    return [np.concatenate(outs[sid]) for sid in sids], np.array(ticks), total


def graph_trace(card: str, name: str, server, per_step: dict,
                replays: int = TRACED_REPLAYS) -> None:
    """torch.profiler traces of a few replays of the server's graph, held
    against the counting rule (launches = captured × replays).  The profiler
    there has dropped device records at times, so a trace is taken again (up
    to 4 times) until it agrees; a trace with fewer launches is reported,
    not failed, and one with more fails."""
    want = {k: n * replays for k, n in per_step.items()}
    for attempt in range(1, 5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            spin_guard()
            for _ in range(replays):
                server._graph.replay()
            spin_guard()
        rows = device_rows(prof)
        seen = {k: sum(e.count for e in rows if is_kernel(k, e.key)) for k in per_step}
        if any(seen[k] > want[k] for k in want):
            fail(f"stream {name}: a trace shows {seen}, more than captured × replays {want}")
        if seen == want:
            break
    if not rows:
        print(f"stream {name} graph trace: no device records over {replays} replays "
              "(the counting rule stands unchecked by the profiler here)", flush=True)
        return
    busy = sum(e.self_device_time_total for e in rows) / 1e3 / replays
    n = sum(e.count for e in rows)
    print(f"stream {name} graph trace over {replays} replays (attempt {attempt}): {n} "
          f"device launches ({n / replays:g} a replay), device busy {busy:.4f} ms a "
          f"replay; ported kernels {seen}, captured × replays {want}: "
          f"{'agree' if seen == want else 'fewer (records dropped)'}  [{card}]", flush=True)


def serve_streams(card: str) -> dict:
    """Phase 13; returns each graphed stream path's kernel launches
    (captured × replays)."""
    from audiojax_torch.runtime import registry
    from audiojax_torch.runtime.streaming import StreamingServer, StreamingSession

    by_path = {}
    for name, seconds, per_step, seed, check in STREAMS:
        t_model = time.perf_counter()
        spec = registry.get(name)
        cfg = spec.make_config()
        sr = spec.make_manifest(cfg).in_sample_rate
        params = spec.init_params(0, cfg, "cuda")
        if spec.make_manifest(cfg).num_audio_inputs == 2:
            clips = [echo_pair(seconds * sr, seed + i, sr=sr) for i in range(STREAM_LANES)]
        else:
            clips = [(noisy_speech(seconds * sr, seed + i, pitch=110.0 + 20.0 * i, sr=sr),)
                     for i in range(STREAM_LANES)]
        # the clips held graph against eager and against the CPU
        held = (clips if check is None
                else [tuple(c[:int(check[1] * sr)] for c in clip) for clip in clips[:check[0]]])
        servers, build_s = {}, {}
        for jit in (True, False):
            t0 = time.perf_counter()
            servers[jit] = StreamingServer(spec, params, cfg, max_streams=STREAM_LANES,
                                           block_hops=STREAM_BLOCK_HOPS, jit=jit, device="cuda")
            torch.cuda.synchronize()
            build_s[jit] = time.perf_counter() - t0
        graph, eager = servers[True], servers[False]
        if graph.captured_launches != per_step:
            fail(f"stream {name}: the captured step launches {graph.captured_launches}, "
                 f"expected {per_step}")

        runs = {}
        for jit, srv in servers.items():
            for mod in kernel_modules():
                mod.reset_launches()
            srv.replays = 0
            runs[jit] = drive_streams(srv, clips if jit else held, seed)
            counts, n_ticks = launch_counts(), len(runs[jit][1])
            if jit:
                # a replay launches in the graph, not through the wrappers
                if any(counts.values()) or srv.replays != n_ticks:
                    fail(f"stream {name} graph: wrapper counts {counts} (expected none), "
                         f"{srv.replays} replays for {n_ticks} ticks")
                by_path[f"{name}_stream"] = {k: n * srv.replays
                                             for k, n in srv.captured_launches.items()}
            elif counts != {k: n * n_ticks for k, n in per_step.items()}:
                fail(f"stream {name} eager: {counts} over {n_ticks} steps, expected {per_step} "
                     "a step")
        (outs_g, ticks_g, drive_g), (outs_e, ticks_e, drive_e) = runs[True], runs[False]
        for i, clip in enumerate(clips):
            g = outs_g[i]
            if g.dtype != np.int16 or g.shape != clip[0].shape or not np.any(g):
                fail(f"stream {name} lane {i}: {g.dtype} {g.shape}, expected int16 "
                     f"{clip[0].shape}, not all zero")
        if check is not None:  # the graph again, on the held lanes and seconds
            outs_g = drive_streams(graph, held, seed)[0]

        cpu_params = spec.init_params(0, cfg, "cpu")
        worst_lsb, snrs = 0, []
        threads = torch.get_num_threads()
        torch.set_num_threads(1)  # the CPU steps are loops of small ops: faster on one
        for i, clip in enumerate(held):
            g, e = outs_g[i], outs_e[i]
            if e.shape != clip[0].shape or g.shape != e.shape:
                fail(f"stream {name} lane {i}: {g.shape} / {e.shape}, expected {clip[0].shape}")
            worst_lsb = max(worst_lsb, int(np.abs(g.astype(np.int32) - e).max()))
            cpu = StreamingSession(spec, cpu_params, cfg, block_hops=STREAM_BLOCK_HOPS,
                                   jit=False, device="cpu")
            snrs.append(snr_db(np.concatenate([cpu.push(*clip), cpu.flush()]), g))
        torch.set_num_threads(threads)
        held_s = held[0][0].size / sr
        print(f"stream {name} {STREAM_LANES} lanes × {seconds} s (block {graph.block} samples, "
              f"irregular pushes): out length == in length; on {len(held)} lanes × "
              f"{held_s:g} s, graph vs eager on the card max {worst_lsb} LSB, graph vs CPU "
              f"StreamingSession SNR min {min(snrs):.2f} dB (lanes "
              f"{', '.join(f'{v:.2f}' for v in snrs)})", flush=True)
        if worst_lsb > (1 if check is None else 0):
            fail(f"stream {name}: graph and eager differ by {worst_lsb} LSB")
        if not min(snrs) >= MIN_SNR_DB:
            fail(f"stream {name}: card vs CPU SNR {min(snrs):.2f} dB < {MIN_SNR_DB}")
        graph.verify_lane_isolation()
        print(f"stream {name}: verify_lane_isolation() passed on the card", flush=True)

        # the step alone, all lanes active on distinct blocks
        rng = np.random.default_rng(seed)
        blocks = [torch.from_numpy(rng.integers(-8000, 8000, (STREAM_LANES, graph.block))
                                   .astype(np.int16)).cuda() for _ in range(graph.n_inputs)]
        active = torch.ones(STREAM_LANES, dtype=torch.bool, device="cuda")
        graph._active.copy_(active)
        for static, b in zip(graph._blocks, blocks):
            static.copy_(b)
        graph_ms = device_ms(graph._graph.replay, iters=TIMED_STEPS)
        calls = 10 if check is None else 1
        rows = cuda_rows(lambda: [eager._masked_step(active, *blocks) for _ in range(calls)],
                         {}, calls=calls)
        step_launches = sum(e.count for e in rows) / calls
        eager_busy = sum(e.self_device_time_total for e in rows) / 1e3 / calls
        walls = {}
        for jit, srv in servers.items():
            run = srv._graph.replay if jit else (lambda: srv._masked_step(active, *blocks))
            t = []
            for _ in range(TIMED_STEPS if jit or check is None else 10):
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                t.append(time.perf_counter() - t0)
            walls[jit] = float(np.median(t)) * 1e3
        graph_trace(card, name, graph, per_step, TRACED_REPLAYS if check is None else 1)
        print(f"stream {name} eager step, top kernels (device ms a step, launches a step):",
              flush=True)
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"  {e.self_device_time_total / 1e3 / calls:9.4f} ms {e.count / calls:7g}x  "
                  f"{e.key[:90]}", flush=True)
        audio_ms = graph.block / sr * 1e3
        print(f"stream {name} step ({STREAM_LANES} × {graph.block} samples = {audio_ms:g} ms of "
              f"audio a lane): graph device {graph_ms:.4f} ms (CUDA events, median of "
              f"{TIMED_STEPS}), wall {walls[True]:.4f} ms; eager device busy {eager_busy:.4f} "
              f"ms (sum of its kernels over {calls} steps), wall {walls[False]:.4f} ms "
              f"(median of {TIMED_STEPS if check is None else 10}); launches a step "
              f"{step_launches:g} (eager trace), ported {per_step}; captured "
              f"{graph.captured_launches}  [{card}]", flush=True)
        eager_lanes = f" on {len(held)} lanes × {held_s:g} s" if check is not None else ""
        print(f"stream {name} tick (push_many, copies in and out included), median of "
              f"{len(ticks_g)} / {len(ticks_e)}: graph {np.median(ticks_g) * 1e3:.4f} ms, eager "
              f"{np.median(ticks_e) * 1e3:.4f} ms{eager_lanes}; RTF a stream at "
              f"{STREAM_LANES} live lanes: graph {drive_g / seconds:.6f}, eager "
              f"{drive_e / held_s:.6f}{eager_lanes}; server set-up (with warm-up and capture) "
              f"{build_s[True]:.3f} s, without capture {build_s[False]:.3f} s; latency_samples "
              f"{graph.latency_samples} = {graph.latency_samples / sr * 1e3:g} ms  [{card}]",
              flush=True)
        del servers, graph, eager
        print(f"stream {name} in {time.perf_counter() - t_model:.1f} s", flush=True)
    return by_path


def h_gtcrn_energies(model, x: torch.Tensor) -> torch.Tensor:
    from audiojax_torch.models.h_gtcrn import source_energies

    return source_energies(x, model.cfg)


def serve_melband(card: str, latency: dict) -> dict:
    """Phase 21: Mel-Band Roformer, mono and stereo."""
    return {name: serve_windowed(card, name, MELBAND_PER_FORWARD, seeds, latency, clip=clip)
            for name, seeds, clip in (("melband_roformer", (91, 92, 93), music_mix),
                                      ("melband_roformer_stereo", (94, 95, 96), stereo_mix))}


def serve_sr(card: str, dev, latency: dict) -> dict:
    """Phase 22: MossFormer2-SR, and its two stride-8 upsamplings both ways."""
    time_sr_upsampling(card, dev)
    return serve_windowed(card, "mossformer2_sr", SR_PER_FORWARD, (97, 98, 99), latency)


# ── phases 26, 27 and 28 ───────────────────────────────────────────────────


def load_flac_golden():
    """``tests/flac_golden.py``: a FLAC encoder in numpy alone, written from
    the format's specification."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "tests" / "flac_golden.py"
    spec = importlib.util.spec_from_file_location("flac_golden", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class numpy_route:
    """Within it the port takes its numpy code where it would call the native
    bridge (``native.available()`` reads False)."""

    def __enter__(self):
        from audiojax_torch.runtime import native

        self.native, self.available = native, native.available
        native.available = lambda: False

    def __exit__(self, *exc):
        self.native.available = self.available


def host_ms(fn, iters: int = 5) -> float:
    """Median host milliseconds of ``fn()`` (host code, no device)."""
    t = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        t.append(time.perf_counter() - t0)
    return float(np.median(t)) * 1e3


def build_native() -> float:
    """Phase 2's native build: ``native/audioio.cc`` with g++ into the
    package's ``_build``; fails with the compiler's message."""
    from audiojax_torch.runtime import native

    t0 = time.perf_counter()
    if not native.available():
        fail(f"the native bridge did not build: {native.build_error()}")
    return time.perf_counter() - t0


def check_native(card: str) -> dict:
    """Phase 26: every function of the native bridge against the port's numpy
    code on the same inputs (bit for bit; the RMS normalisation and the OLA
    stitch within 1 LSB, their float sums in another order), each timed both
    ways on the host; then a 7 s GTCRN request written as FLAC, decoded by
    the bridge through ``read_audio`` and served by ``Session`` on the card,
    equal bit for bit to the same request read from WAV, each whole request
    (read, serve, encode the answer) timed on the host's clock.  Returns the
    requests' kernel launches."""
    import io
    import tempfile
    import wave
    from pathlib import Path

    from audiojax_torch.runtime import audio_io, native, registry
    from audiojax_torch.runtime.manifest import Manifest
    from audiojax_torch.runtime.session import Session

    flac = load_flac_golden()
    rng = np.random.default_rng(26)
    print(f"native: {native.library_path()} (g++ {' '.join(native.GXX_FLAGS)})", flush=True)

    def held(what, ours, ref, lsb: int = 0, times=None):
        ours, ref = np.asarray(ours), np.asarray(ref)
        if ours.shape != ref.shape or ours.dtype != ref.dtype:
            fail(f"native {what}: {ours.dtype} {ours.shape} vs {ref.dtype} {ref.shape}")
        worst = int(np.abs(ours.astype(np.int64) - ref.astype(np.int64)).max())
        if worst > lsb:
            fail(f"native {what}: {worst} LSB from the numpy code (limit {lsb})")
        t = "" if times is None else f"; host ms native {times[0]:.3f}" + (
            "" if len(times) < 2 else f", numpy {times[1]:.3f}")
        print(f"native {what}: {ours.dtype} {ours.shape}, max {worst} LSB from the numpy code "
              f"(limit {lsb}){t}", flush=True)

    with tempfile.TemporaryDirectory(prefix="native_") as tmp:
        tmp = Path(tmp)
        stereo = (rng.standard_normal((2, 6 * 48000)) * 9000).astype(np.int16)
        with numpy_route():
            wav_p = audio_io.write_wav(tmp / "s.wav", stereo, 48000)
            ref_wav = audio_io.read_wav(wav_p)[0]
        held("read_wav_mono16 (6 s 48 kHz stereo)", native.read_wav_mono16(wav_p)[0],
             audio_io.to_mono(ref_wav))
        buf = io.BytesIO()
        with wave.open(buf, "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(48000)
            w.writeframes(stereo.T.astype("<i2").tobytes())
        blob = native.encode_wav_pcm16(stereo, 48000)
        if blob != buf.getvalue():
            fail("native encode_wav_pcm16: the bytes differ from the stdlib wave module's")
        print(f"native encode_wav_pcm16 (6 s 48 kHz stereo): {len(blob)} bytes, equal to the "
              "stdlib wave module's", flush=True)

        req = noisy_speech(30 * SR, 261)
        for window, stride, head, num in ((32000, 20000, 0, 32), (32000, 32000, 8000, 16)):
            ours = native.slice_windows(req, window, stride, head, num)
            padded = np.concatenate([np.zeros(head, np.int16), req,
                                     np.zeros((num - 1) * stride + window, np.int16)])
            ref = np.stack([padded[s:s + window] for s in range(0, num * stride, stride)])
            held(f"slice_windows (30 s, window {window}, stride {stride}, head {head})", ours,
                 ref, times=(host_ms(lambda: native.slice_windows(req, window, stride, head,
                                                                    num)),
                             host_ms(lambda: np.stack([padded[s:s + window] for s in
                                                       range(0, num * stride, stride)]))))
        for rin, rout in ((48000, 16000), (16000, 48000), (44100, 16000)):
            x = stereo[:, : 6 * rin]
            ours = audio_io.resample_np(x, rin, rout)
            with numpy_route():
                ref = audio_io.resample_np(x, rin, rout)
                t_np = host_ms(lambda: audio_io.resample_np(x, rin, rout))
            held(f"resample_linear {rin} → {rout} (6 s stereo)", ours, ref,
                 times=(host_ms(lambda: audio_io.resample_np(x, rin, rout)), t_np))
        quiet = (req // 16).astype(np.int16)
        with numpy_route():
            ref = audio_io.normalise_rms(quiet, 4096.0)
            t_np = host_ms(lambda: audio_io.normalise_rms(quiet, 4096.0))
        held("normalise_rms (30 s)", native.normalise_rms(quiet, 4096.0), ref, lsb=1,
             times=(host_ms(lambda: native.normalise_rms(quiet, 4096.0)), t_np))
        # SR's 30 s output: 32 windows of 96,000 samples at a 60,000 stride
        wins = (rng.standard_normal((32, 96000)) * 9000).astype(np.int16)
        manifest = Manifest(model_name="ola", task="super_resolution", model_family="ola",
                            in_sample_rate=16000, out_sample_rate=48000,
                            model_sample_rate=48000, input_audio_length=32000,
                            overlap_length=12000)
        stitcher = Session(torch.nn.Identity(), manifest, device="cpu")
        with numpy_route():
            ref = stitcher._stitch(wins, 20000, 3.0)
            t_np = host_ms(lambda: stitcher._stitch(wins, 20000, 3.0), iters=3)
        held("ola_stitch (32 × 96000, stride 60000)", native.ola_stitch(wins, 60000), ref,
             lsb=1, times=(host_ms(lambda: native.ola_stitch(wins, 60000), iters=3), t_np))
        for label, pcm, kw in (("7 s mono fixed order 2", req[None, : 7 * SR], {}),
                               ("6 s stereo mid-side", stereo[:, : 6 * 16000],
                                {"stereo": "mid_side"})):
            data = flac.encode_flac(pcm, 16000, **kw)
            out, rate = native.decode_flac(data)
            if rate != 16000:
                fail(f"native decode_flac {label}: rate {rate}")
            held(f"decode_flac ({label}, {len(data)} bytes)", out, pcm,
                 times=(host_ms(lambda: native.decode_flac(data)),))

        # a 7 s GTCRN request, as FLAC and as WAV, through read_audio and Session
        pcm = noisy_speech(7 * SR, 262)
        (tmp / "r.flac").write_bytes(flac.encode_flac(pcm[None], SR))
        audio_io.write_wav(tmp / "r.wav", pcm, SR)
        spec = registry.get("gtcrn")
        cfg = spec.make_config()
        session = Session(spec.make_module(spec.init_params(0, cfg, "cuda"), cfg),
                          spec.make_manifest(cfg), device="cuda")
        session.process(pcm)  # warm-up

        def request(path):
            """One whole request: read, serve on the card, encode the answer."""
            t0 = time.perf_counter()
            audio, rate = audio_io.read_audio(path)
            if rate != SR or not np.array_equal(audio[0], pcm):
                fail(f"read_audio {path.name}: not the request written")
            res = session.process(audio[0])
            audio_io.write_wav(tmp / f"out_{path.name}.wav", res.audio, SR)
            return res, (time.perf_counter() - t0) * 1e3

        for mod in kernel_modules():
            mod.reset_launches()
        (r_flac, ms_flac), (r_wav, ms_wav) = request(tmp / "r.flac"), request(tmp / "r.wav")
        counts = launch_counts()
    if counts != {k: 2 * n for k, n in GTCRN_PER_FORWARD.items()}:
        fail(f"native gtcrn requests launched {counts}")
    if (r_flac.audio.shape != pcm.shape or not np.any(r_flac.audio)
            or not np.array_equal(r_flac.audio, r_wav.audio)):
        fail("the FLAC request's answer differs from the WAV request's")
    print(f"native gtcrn 7 s request decoded from FLAC by the bridge and served on the card: "
          f"equal bit for bit to the WAV request's answer; whole request ms (read, serve, "
          f"encode) FLAC {ms_flac:.3f}, WAV {ms_wav:.3f}; elapsed ms "
          f"{r_flac.elapsed_s * 1e3:.3f} / {r_wav.elapsed_s * 1e3:.3f}  [{card}]", flush=True)
    return counts


def check_bf16_se_sr_kernels(dev) -> None:
    """Phase 27's kernels: B4 and B6 in bfloat16 at the MossFormer2-SE and
    MossFormer2-SR 6 s serving shapes (phase 14's; the bf16 plans serve no
    30 s request), B4 within one bf16 ulp
    of its plain version, B6 as the layers take it (float32 out, within
    TOL_B4_B6), each within 2× the plain version's float64 error; timed
    beside cuDNN's bf16 conv (B4), the bound from bf16 bytes and operations."""
    gen = torch.Generator(device=dev).manual_seed(27)
    for label, shape, k, pads, dil in six_s(B4_SE_CASES + B4_SR_CASES):
        hold_b4(gen, dev, label, shape, k, pads, dil, f64_rows=SS_F64_ROWS,
                dtype=torch.bfloat16)
    for label, n, s in six_s(B6_SE_CASES + B6_SR_CASES):
        hold_b6(gen, dev, label, n, s, False, dk=128, dv=2048, f64_rows=SS_F64_ROWS,
                dtype=torch.bfloat16, out_dtype=torch.float32)


def sr_masknet_card_vs_cpu(model, cpu_model, x: torch.Tensor) -> None:
    """SR's mask net alone, card against CPU on the CPU's log-mel of ``x``
    (the float32 upsampler and mel analysis), its float output's SNR at
    ``SR_MASKNET_BF16_GATE_DB``: the generator after it is chaotic on random
    weights and amplifies any rounding difference."""
    from audiojax_torch.models.mossformer_sr import sr_log_mel, sr_masknet, upsample_sinc

    cfg = model.cfg
    with torch.inference_mode():
        mel = sr_log_mel(upsample_sinc(x, cfg), cfg)
        card = sr_masknet(model.params, mel.cuda(), cfg).cpu().numpy()
        cpu = sr_masknet(cpu_model.params, mel, cfg).numpy()
    snr = snr_db(cpu, card)
    print(f"serve mossformer2_sr_bf16 mask net alone, card vs CPU on one window's log-mel: "
          f"SNR {snr:.2f} dB (gate {SR_MASKNET_BF16_GATE_DB:g})", flush=True)
    if not snr >= SR_MASKNET_BF16_GATE_DB:
        fail(f"mossformer2_sr_bf16 mask net card vs CPU SNR {snr:.2f} dB < "
             f"{SR_MASKNET_BF16_GATE_DB}")


def serve_bf16_rest(card: str, dev, latency: dict) -> dict:
    """Phase 27: the bf16 plans of MossFormer2-SE, Mel-Band Roformer (mono and
    stereo) and MossFormer2-SR on the 6 s requests of phases 15, 21 and 22
    (their seeds; no 30 s ones, for time), after their bf16 kernels at those
    shapes."""
    check_bf16_se_sr_kernels(dev)
    return {f"{name}_bf16": serve_windowed(card, name, bf16_plan(per_forward), seeds, latency,
                                          dtype="bfloat16", seconds=(6,), **kw)
            for name, per_forward, seeds, kw in (
                ("mossformer2_se", SE_PER_FORWARD, (54, 55, 56), {}),
                ("melband_roformer", MELBAND_PER_FORWARD, (91, 92, 93), {"clip": music_mix}),
                ("melband_roformer_stereo", MELBAND_PER_FORWARD, (94, 95, 96),
                 {"clip": stereo_mix}),
                ("mossformer2_sr", SR_PER_FORWARD, (97, 98, 99),
                 {"inner": sr_masknet_card_vs_cpu}))}


# the plans through the artifact (phase 28): Mel-Band Roformer's (the JAX
# package's plan_for gives it q8f32), and its path names in the kernels line
PLAN_PATHS = {"q8f32": "melband_roformer_q8f32", "q8dyn": "melband_roformer_q8dyn",
              "bf16": "melband_roformer_bf16_weights"}
# each plan's answer against the float32 artifact's on the card, int16 SNR,
# at the value measured on the H100 80GB HBM3 at 700 W rounded down to the
# dB (q8f32 39.69, q8dyn 35.15, weight-only bf16 44.29): the card-vs-CPU
# check runs the same quantization and layout code on both sides, so a
# fault in it that shows only at full width shows here
PLAN_VS_F32_GATE_DB = {"q8f32": 39.0, "q8dyn": 35.0, "bf16": 44.0}
STREAM_Q8_LANES, STREAM_Q8_SECONDS = 4, 3


def _buffer_bytes(model) -> dict:
    """A module's parameter bytes on the device, by dtype."""
    out = {}
    for t in model.buffers():
        key = str(t.dtype).removeprefix("torch.")
        out[key] = out.get(key, 0) + t.numel() * t.element_size()
    return out


def serve_plans(card: str) -> dict:
    """Phase 28: Mel-Band Roformer at full width and depth from a synthetic
    checkpoint (``tests/test_torch_ckpt_builders.py``) goes export →
    ``optimize_artifact`` with q8f32, q8dyn and weight-only bf16 → load onto
    the card → ``Session`` (``wrap_forward``); each plan's 6 s request median
    beside the float32 artifact's, its optimize_report.json, the weights'
    bytes on the card, one profiled request, card plan against card float32
    (``PLAN_VS_F32_GATE_DB``), and card against the CPU port on the same artifact (one window, the
    family's gate).  Then a GTCRN artifact under q8dyn with ``min_size=256``
    (its GRU and dense leaves int8) streams through ``StreamingServer``: the
    captured CUDA graph against the eager server.  Returns each path's
    kernel launches."""
    import tempfile
    import warnings
    from pathlib import Path

    from audiojax_torch.runtime import registry
    from audiojax_torch.runtime.checkpoint import load_artifact
    from audiojax_torch.runtime.export import export_artifact
    from audiojax_torch.runtime.optimize import (PLANS, Plan, materialize_params,
                                                 optimize_artifact, wrap_forward)
    from audiojax_torch.runtime.session import Session
    from audiojax_torch.runtime.streaming import StreamingServer

    builders = load_builders()
    name = "melband_roformer"
    spec = registry.get(name)
    cfg = spec.make_config()
    by_path, latency, answers = {}, {}, {}
    with tempfile.TemporaryDirectory(prefix="plans_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        export_artifact(name, builders.BUILDERS[name](cfg, seed=28), tmp / "float32", cfg=cfg,
                        smoke=False)
        arts, reports = {"float32": tmp / "float32"}, {}
        print(f"plans {name}: float32 artifact exported in {time.perf_counter() - t0:.3f} s",
              flush=True)
        for plan in PLAN_PATHS:
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                arts[plan] = optimize_artifact(arts["float32"], tmp / plan, PLANS[plan])
            reports[plan] = json.loads((arts[plan] / "optimize_report.json").read_text())
            if PLANS[plan].experimental != any("EXPERIMENTAL" in str(w.message) for w in caught):
                fail(f"plans {plan}: the experimental warning was not given as the plan says")
            print(f"plans {name} {plan}: optimize_artifact {time.perf_counter() - t0:.3f} s, "
                  f"report {json.dumps({k: v for k, v in reports[plan].items() if k != 'plan'})}",
                  flush=True)

        sr = spec.make_manifest(cfg).in_sample_rate
        ins = (music_mix(6 * sr, 281, sr=sr),)
        window = (music_mix(spec.make_manifest(cfg).input_audio_length, 282, sr=sr)[None],)
        for plan, art in arts.items():
            params, manifest = load_artifact(art, device="cuda")
            cpu_params, _ = load_artifact(art, device="cpu")
            model = wrap_forward(spec.make_module(params, cfg), manifest)
            session = Session(model, manifest, device="cuda")
            session.process(*ins)  # warm-up
            for mod in kernel_modules():
                mod.reset_launches()
            runs = [session.process(*ins) for _ in range(SERVE_REPEATS)]
            counts = launch_counts()
            expect = {k: SERVE_REPEATS * n for k, n in MELBAND_PER_FORWARD.items()}
            if counts != expect:
                fail(f"plans {plan} serving launched {counts}, expected {expect}")
            if plan in PLAN_PATHS:
                by_path[PLAN_PATHS[plan]] = counts
            for r in runs:
                if r.audio.dtype != np.int16 or r.audio.shape != ins[0].shape or not np.any(
                        r.audio):
                    fail(f"plans {plan}: {r.audio.dtype} {r.audio.shape}, expected int16 "
                         f"{ins[0].shape}, not all zero")
            ms = sorted(r.elapsed_s * 1e3 for r in runs)
            latency[plan] = med = float(np.median(ms))
            answers[plan] = runs[0].audio
            beside = ""
            if plan != "float32":
                vs32 = snr_db(answers["float32"], runs[0].audio)
                beside = (f"; float32 artifact {latency['float32']:.3f} ms (same run), card "
                          f"{plan} vs card float32 SNR {vs32:.2f} dB (gate "
                          f"{PLAN_VS_F32_GATE_DB[plan]:g}); compression "
                          f"{reports[plan].get('compression', '—')}")
                if not vs32 >= PLAN_VS_F32_GATE_DB[plan]:
                    fail(f"plans {plan} vs float32 SNR {vs32:.2f} dB < "
                         f"{PLAN_VS_F32_GATE_DB[plan]}")
            print(f"plans {name} {plan} 6 s request: elapsed ms median {med:.3f} (min "
                  f"{ms[0]:.3f}, max {ms[-1]:.3f}, n={len(ms)}); weights on the card by dtype "
                  f"{_buffer_bytes(model)} bytes{beside}  [{card}]", flush=True)
            rows = cuda_rows(lambda: session.process(*ins), MELBAND_PER_FORWARD)
            busy = sum(e.self_device_time_total for e in rows) / 1e3
            print(f"profile plans {plan} 6 s: {sum(e.count for e in rows)} device launches, "
                  f"device busy {busy:.3f} ms of {med:.3f} ms median elapsed unprofiled (idle "
                  f"share {1.0 - busy / med:.4f})  [{card}]", flush=True)
            for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
                print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:6d}x  {e.key[:90]}",
                      flush=True)
            cpu_model = wrap_forward(spec.make_module(cpu_params, cfg), manifest)
            with torch.inference_mode():
                card_out = model(torch.from_numpy(window[0]).cuda())
                t0 = time.perf_counter()
                cpu_out = cpu_model(torch.from_numpy(window[0]))
            hold_card_vs_cpu(f"plans {name} {plan} 2 s window", PLAN_PATHS.get(plan, name),
                             card_out, cpu_out, f"(CPU forward {time.perf_counter() - t0:.1f} s, "
                             "the same artifact)")
            del model, session, params, cpu_params, cpu_model

        # a q8dyn stream: GTCRN with its GRU and dense leaves int8
        gspec = registry.get("gtcrn")
        gcfg = gspec.make_config()
        export_artifact("gtcrn", builders.BUILDERS["gtcrn"](gcfg, seed=29), tmp / "gtcrn",
                        smoke=False)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            art = optimize_artifact(tmp / "gtcrn", tmp / "gtcrn_q8dyn",
                                    Plan("q8dyn_256", quantize="q8dyn", q8_min_size=256,
                                         experimental=True))
        report = json.loads((art / "optimize_report.json").read_text())
        params, manifest = load_artifact(art, device="cuda")
    served = materialize_params(params, manifest)  # q8dyn: as it is
    n_int8 = sum(1 for _, t in _leaves(served) if t.dtype == torch.int8)
    clips = [(noisy_speech(STREAM_Q8_SECONDS * SR, 290 + i, pitch=110.0 + 20.0 * i),)
             for i in range(STREAM_Q8_LANES)]
    per_step = {**NO_LAUNCHES, "stft_packed": 1}
    outs = {}
    for jit in (True, False):
        server = StreamingServer(gspec, served, gcfg, max_streams=STREAM_Q8_LANES,
                                 block_hops=STREAM_BLOCK_HOPS, jit=jit, device="cuda")
        for mod in kernel_modules():
            mod.reset_launches()
        server.replays = 0
        outs[jit], ticks, total = drive_streams(server, clips, 29)
        counts = launch_counts()
        if jit:
            if server.captured_launches != per_step or any(counts.values()):
                fail(f"q8dyn stream graph: captured {server.captured_launches}, wrapper counts "
                     f"{counts}")
            by_path["gtcrn_q8dyn_stream"] = {k: n * server.replays
                                             for k, n in server.captured_launches.items()}
            graph_ms = float(np.median(ticks)) * 1e3
            graph_rtf = total / STREAM_Q8_SECONDS
        elif counts != {k: n * len(ticks) for k, n in per_step.items()}:
            fail(f"q8dyn stream eager: {counts} over {len(ticks)} steps")
        else:
            eager_ms = float(np.median(ticks)) * 1e3
            active = torch.ones(STREAM_Q8_LANES, dtype=torch.bool, device="cuda")
            blocks = [torch.zeros((STREAM_Q8_LANES, server.block), dtype=torch.int16,
                                  device="cuda")]
            rows = cuda_rows(lambda: server._masked_step(active, *blocks), {})
            int8 = [e for e in rows if "int8" in e.key.lower() or "s8" in e.key.lower()
                    or "imma" in e.key.lower() or "i8" in e.key.lower()]
        del server
    worst = max(int(np.abs(g.astype(np.int32) - e).max()) for g, e in zip(outs[True],
                                                                         outs[False]))
    for g, (clip,) in zip(outs[True], clips):
        if g.dtype != np.int16 or g.shape != clip.shape or not np.any(g):
            fail(f"q8dyn stream: {g.dtype} {g.shape}, expected int16 {clip.shape}")
    print(f"plans gtcrn q8dyn stream (min_size 256: {report['leaves_quantized']} leaves int8, "
          f"{n_int8} int8 tensors on the card; {STREAM_Q8_LANES} lanes × {STREAM_Q8_SECONDS} s, "
          f"irregular pushes): graph vs eager max {worst} LSB; tick median graph "
          f"{graph_ms:.4f} ms, eager {eager_ms:.4f} ms; RTF a stream graph {graph_rtf:.6f}; "
          f"eager step {sum(e.count for e in rows)} launches, its int8 GEMM rows "
          f"{[(e.key[:60], e.count) for e in int8]}  [{card}]", flush=True)
    if worst > 0:
        fail(f"q8dyn stream: graph and eager differ by {worst} LSB")
    return by_path


# ── phases 29, 30 and 31 ───────────────────────────────────────────────────

JAX_ARTIFACT = "tests/data/jax_gtcrn_artifact"
# the three graphed families: (path, name, compute dtype, clip, the numpy init
# of their random weights in the JAX package's layout, which an artifact holds)
GRAPHS = (("graph_mossformergan_se", "mossformergan_se", "float32", "noisy_speech",
           "mossformergan_se:init_mossformergan_numpy"),
          ("graph_zipenhancer_bf16", "zipenhancer", "bfloat16", "noisy_speech",
           "zipenhancer:init_zipenhancer_numpy"),
          ("graph_mossformer2_ss", "mossformer2_ss", "float32", "speech_mix",
           "mossformer2_ss:init_mossformer2_ss_numpy"))
# phase 33's graphs of the loop families (their time loops traced as scan
# operators), exported, loaded and served in phase 30's stages beside those
# (families without a compute-dtype knob: dtype None)
LOOP_GRAPHS = (("graph_gtcrn", "gtcrn", None, "noisy_speech", "gtcrn:init_gtcrn_numpy"),
               ("graph_sdaec", "sdaec", None, "echo_pair", "sdaec:init_sdaec_numpy"))
# the kernels that the graphs, between them, must launch through a graph
GRAPH_KERNELS = ("stft_packed", "istft_packed", "relpos_scores_bf16", "dwconv1d",
                 "dwconv1d_bf16", "dwconv1d_tiled", "quad_attention")


def serve_jax_artifact(card: str) -> dict:
    """Phase 29: the JAX package's GTCRN artifact served on the card and the
    CPU; returns the card's launch counts."""
    from audiojax_torch.runtime import registry
    from audiojax_torch.runtime.checkpoint import load_artifact
    from audiojax_torch.runtime.session import Session

    art = Path(__file__).resolve().parent / JAX_ARTIFACT
    if not (art / "params.msgpack").is_file():
        fail(f"{art} holds no params.msgpack")
    t0 = time.perf_counter()
    params, manifest = load_artifact(art, "cuda")
    load_s = time.perf_counter() - t0
    spec = registry.get(manifest.model_name)
    cfg = registry.config_from_manifest(spec, manifest)
    audio = noisy_speech(6 * SR, 91)
    session = Session(spec.make_module(params, cfg), manifest, device="cuda")
    session.process(audio)  # warm-up
    for mod in kernel_modules():
        mod.reset_launches()
    card_out = session.process(audio)
    counts = {k: n for mod in kernel_modules() for k, n in mod.launches.items()}
    if counts["stft_packed"] <= 0 or counts["istft_packed"] <= 0:
        fail(f"the JAX artifact's request launched {counts}")
    cpu_params, _ = load_artifact(art, "cpu")
    cpu_out = Session(spec.make_module(cpu_params, cfg), manifest, device="cpu").process(audio)
    snr = snr_db(cpu_out.audio, card_out.audio)
    print(f"jax artifact {JAX_ARTIFACT} ({manifest.model_name}, params.msgpack "
          f"{(art / 'params.msgpack').stat().st_size} bytes, read in {load_s:.3f} s): 6 s request "
          f"{card_out.elapsed_s * 1e3:.3f} ms on the card, card vs CPU SNR {snr:.2f} dB, "
          f"launches {counts}  [{card}]", flush=True)
    if card_out.audio.shape != audio.shape or not snr >= MIN_SNR_DB:
        fail(f"jax artifact: shape {card_out.audio.shape}, card vs CPU SNR {snr:.2f} dB")
    return counts


def _median_ms(session, ins, n: int = 3) -> tuple:
    """(median ms of ``n`` requests after one warm-up, the last result)."""
    session.process(*ins)
    runs = [session.process(*ins) for _ in range(n)]
    return float(np.median([r.elapsed_s * 1e3 for r in runs])), runs[-1]


def op_host_cost(card: str) -> None:
    """Phase 30's host cost of a registered operator: B4 a call through
    ``torch.ops.audiojax_torch.dwconv1d`` against its direct launcher, at a
    shape whose kernel takes far less than the host's call."""
    from audiojax_torch.ops import dwconv_cuda as D

    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((4, 64, 64), generator=gen, device="cuda")
    w = torch.randn((7, 64), generator=gen, device="cuda")
    calls = {"direct": lambda: D.dwconv1d_cuda(x, w, pads=(3, 3)),
             "operator": lambda: torch.ops.audiojax_torch.dwconv1d(x, w, 3, 3, 1)}
    us = {}
    for name, fn in list(calls.items()) * 2:  # interleaved, the second pass kept
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            fn()
        us[name] = (time.perf_counter() - t0) / 500 * 1e6
        torch.cuda.synchronize()
    print(f"op host cost: B4 at (4, 64, 64) k7, host µs a call: direct launcher "
          f"{us['direct']:.2f}, registered operator {us['operator']:.2f} (+"
          f"{us['operator'] - us['direct']:.2f})  [{card}]", flush=True)


def _spawn(log: str, *args: str) -> subprocess.Popen:
    """This script again in a child process (phase 30's stages), its stderr
    into the file ``log``."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    with open(log, "w") as err:
        return subprocess.Popen([sys.executable, __file__, *args], stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, stderr=err, text=True, env=env)


def _last_json(proc: subprocess.Popen, what: str, log: str) -> dict:
    """The child's last stdout line as JSON, once it has exited 0."""
    out, _ = proc.communicate(timeout=600)
    if proc.returncode != 0:
        fail(f"{what} failed ({proc.returncode}):\n{Path(log).read_text()[-4000:]}")
    return json.loads(out.strip().splitlines()[-1])


def serve_graphs(card: str, beside=None, graphs=GRAPHS + LOOP_GRAPHS) -> dict:
    """Phase 30, with phase 33's loop graphs; returns the launch counts of
    each graphed path.

    Three stages, each family's work in a process of its own within a stage:
    the eager answers here, one after another (timed, nothing else running);
    the exports on the card, in parallel, while ``beside()`` runs here
    (untimed work: phase 31's tools); then the graph hosts, which load in
    parallel and, once all have loaded, serve one at a time, so that no
    request is timed beside another process's work.  The children run torch
    on one intra-op thread: their work is Python, and the stages share the
    host's cores."""
    import importlib
    import shutil
    import tempfile

    from audiojax_torch.ops._build import registered_ops
    from audiojax_torch.runtime import aot, registry
    from audiojax_torch.runtime.checkpoint import load_artifact, save_artifact
    from audiojax_torch.runtime.session import Session

    op_host_cost(card)
    root = tempfile.mkdtemp(prefix="chip_smoke_graphs_")
    arts, eager_ms = {}, {}
    try:
        for path, name, dtype, clip, init in graphs:
            spec = registry.get(name)
            cfg = spec.make_config(**({} if dtype is None else {"compute_dtype": dtype}))
            manifest = spec.make_manifest(cfg)
            extra = {"config": dataclasses.asdict(cfg)}
            if dtype not in (None, "float32"):
                extra["activation_compute_dtype"] = dtype
            manifest = dataclasses.replace(manifest, extra={**manifest.extra, **extra})
            art = arts[path] = f"{root}/{path}"
            module, fn = init.split(":")
            init_np = getattr(importlib.import_module(f"audiojax_torch.models.{module}"), fn)
            save_artifact(art, init_np(0, cfg), manifest)
            params, manifest = load_artifact(art, "cuda")
            session = Session(spec.make_module(params, cfg), manifest, device="cuda")
            sr = manifest.in_sample_rate
            ins = _inputs(globals()[clip](6 * sr, 95, sr=sr))
            eager_ms[path], ref = _median_ms(session, ins)
            if name == "mossformergan_se":  # every routing point through its operator
                with registered_ops():
                    op_ms, op_ref = _median_ms(session, ins)
                eager_again, _ = _median_ms(session, ins)
                same = all(np.array_equal(a, b) for a, b in zip(ref.outputs, op_ref.outputs))
                print(f"op host cost: {path} eager 6 s request median {eager_ms[path]:.3f} ms "
                      f"with the direct launchers ({eager_again:.3f} ms again after), "
                      f"{op_ms:.3f} ms with every routing point through its registered "
                      f"operator; answers equal: {same}  [{card}]", flush=True)
                if not same:
                    fail(f"{path}: the operators' answer differs from the direct launchers'")
            np.savez(f"{art}/request.npz", *ins)
            np.savez(f"{art}/eager.npz", *ref.outputs)
            del session, params
            torch.cuda.empty_cache()
        exports = {path: _spawn(f"{art}.export.log", "--graph-export", art)
                   for path, art in arts.items()}
        if beside is not None:
            beside()
        exported = {path: _last_json(p, f"the {path} export", f"{arts[path]}.export.log")
                    for path, p in exports.items()}
        hosts = {path: _spawn(f"{art}.host.log", "--graph-child", art)
                 for path, art in arts.items()}
        loaded = {path: p.stdout.readline() for path, p in hosts.items()}  # all loaded
        result = {}
        for path, p in hosts.items():  # then one serves at a time
            if not loaded[path].startswith("loaded"):
                p.kill()
                fail(f"the {path} graph host did not load:\n"
                     f"{Path(arts[path] + '.host.log').read_text()[-4000:]}")
            p.stdin.write("go\n")
            p.stdin.flush()
            result[path] = _last_json(p, f"the {path} graph host", f"{arts[path]}.host.log")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    by_path = {}
    loop_paths = [g[0] for g in LOOP_GRAPHS]
    for path in arts:
        r, e = result[path], exported[path]
        if e["batch_mode"] != "poly":
            fail(f"{path}: the symbolic batch fell back: {e['symbolic_fallback_error']}")
        if e["loops"] != "scan":
            fail(f"{path}: graph.json records loops {e['loops']!r}")
        print(f"graph {path}{' (phase 33)' if path in loop_paths else ''}: export "
              f"{e['export_s']:.2f} s (beside the other exports), load {r['load_s']:.2f} s, "
              f"{aot.GRAPH_FILE} {e['graph_bytes']} bytes ({r['nodes']} nodes, "
              f"{sum(e['nodes'].values())} with the scan steps' own); 6 s request "
              f"median graph {r['ms']:.3f} ms vs eager {eager_ms[path]:.3f} ms; graph vs eager "
              f"max {r['max_lsb']} LSB; launches "
              f"{ {k: n for k, n in r['launches'].items() if n} }  [{card}]", flush=True)
        if r["max_lsb"] > 1:
            fail(f"{path}: graph vs eager {r['max_lsb']} LSB")
        by_path[path] = r["launches"]
    missing = [k for k in GRAPH_KERNELS if not any(c[k] for c in by_path.values())]
    if missing:
        fail(f"no graph launched {missing}")
    return by_path


def graph_export(art: str) -> int:
    """Phase 30's export stage: the artifact's module, as the CLI builds it,
    exported into it on the card; prints one JSON line."""
    from audiojax_torch.runtime import aot, registry
    from audiojax_torch.runtime.checkpoint import load_artifact

    params, manifest = load_artifact(art, "cuda")
    spec = registry.get(manifest.model_name)
    model = spec.make_module(params, registry.config_from_manifest(spec, manifest))
    t0 = time.perf_counter()
    aot.attach_graph(art, model, manifest)
    export_s = time.perf_counter() - t0
    meta = json.loads((Path(art) / aot.GRAPH_META).read_text())
    print(json.dumps({"export_s": export_s, "graph_bytes": (Path(art) / aot.GRAPH_FILE).stat().st_size,
                      "batch_mode": meta["batch_mode"], "loops": meta["loops"],
                      "nodes": meta["nodes"],
                      "symbolic_fallback_error": meta["symbolic_fallback_error"]}))
    return 0


def graph_child(art: str) -> int:
    """Phase 30's graph host: load the graph artifact with ``runtime`` and
    ``ops`` alone, say so, and when told to on stdin (one host serves at a
    time), serve its request; prints one JSON line."""
    from audiojax_torch.runtime import aot
    from audiojax_torch.runtime.checkpoint import load_artifact
    from audiojax_torch.runtime.session import Session

    t0 = time.perf_counter()
    params, manifest = load_artifact(art, "cuda")
    model = aot.load_compiled(art, aot.prepare_for_graph(params, art))
    load_s = time.perf_counter() - t0
    with np.load(f"{art}/request.npz") as z:
        ins = [z[k] for k in sorted(z.files)]
    with np.load(f"{art}/eager.npz") as z:
        ref = [z[k] for k in sorted(z.files)]
    session = Session(model, manifest, device="cuda")
    print("loaded", flush=True)
    if sys.stdin.readline().strip() != "go":
        return 1
    session.process(*ins)  # warm-up
    for mod in kernel_modules():
        mod.reset_launches()
    runs = [session.process(*ins) for _ in range(SERVE_REPEATS)]
    launches = {k: n for mod in kernel_modules() for k, n in mod.launches.items()}
    worst = max(int(np.max(np.abs(a.astype(np.int32) - b.astype(np.int32))))
                for r in runs for a, b in zip(r.outputs, ref))
    loaded = sorted(m for m in sys.modules if m.startswith("audiojax_torch.models"))
    if loaded:
        raise AssertionError(f"the graph host imported {loaded}")
    print(json.dumps({"load_s": load_s, "launches": launches, "max_lsb": worst,
                      "nodes": sum(len(g.graph.nodes) for g in model.graphs.values()),
                      "ms": float(np.median([r.elapsed_s * 1e3 for r in runs]))}))
    return 0


def run_tools(card: str):
    """Phase 31's untimed part, run beside phase 30's exports (in other
    processes): ``utils.smoke`` over every registered model and
    ``utils.inspect_model --all``, on the card; fails unless smoke exits 0
    and each of inspect_model's fifteen lines parses with its
    ``gflops_per_chunk`` > 0.  Returns nothing to wait for."""
    import contextlib
    import io

    from audiojax_torch.utils import inspect_model, smoke

    t0 = time.perf_counter()
    rc = smoke.main([])
    print(f"tools: utils.smoke over every registered model: exit {rc} in "
          f"{time.perf_counter() - t0:.1f} s (beside phase 30's exports)  [{card}]", flush=True)
    if rc != 0:
        fail(f"utils.smoke exited {rc}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = inspect_model.main(["--all"])
    lines = [json.loads(line) for line in buf.getvalue().splitlines()]
    for r in lines:
        print(f"tools: inspect_model {json.dumps(r)}", flush=True)
    print(f"tools: inspect_model --all: exit {rc}, {len(lines)} lines in "
          f"{time.perf_counter() - t0:.1f} s (beside phase 30's exports)  [{card}]", flush=True)
    if rc != 0 or len(lines) != 15 or not all(r.get("gflops_per_chunk", 0) > 0 for r in lines):
        fail("inspect_model --all: a model failed or counted no operation")


def bench_stream_lanes(card: str) -> None:
    """Phase 31's timed part: ``utils.bench_streams`` for GTCRN at 8, 64 and
    256 lanes, the card to itself."""
    from audiojax_torch.utils import bench_streams

    for lanes in (8, 64, 256):
        print(f"tools: bench_streams {json.dumps(bench_streams.bench_streams('gtcrn', lanes))}  "
              f"[{card}]", flush=True)


# ── phase 33 ───────────────────────────────────────────────────────────────

# × max|ref|: the pipelined FLASH stack against the same layers run in order
# (float32 sums of the same terms; only cuBLAS's choice of GEMM kernel for
# the microbatch's rows against the whole batch's may differ)
PP_RTOL = 1e-5


def serve_mesh(card: str) -> dict:
    """Phase 33's mesh: MossFormerGAN-SE (float32, full width) on a 6 s
    request through ``Session(mesh=make_mesh())`` (every card) and through a
    dp mesh of ``["cuda:0", "cuda:0"]`` (two rows on one card), each within
    1 LSB of the plain ``Session``, each forward (one a dp row) launching
    what phase 6's does; returns each mesh path's launch counts."""
    from audiojax_torch.parallel import make_mesh
    from audiojax_torch.runtime import registry
    from audiojax_torch.runtime.session import Session

    spec = registry.get("mossformergan_se")
    cfg = spec.make_config()
    manifest = spec.make_manifest(cfg)
    model = spec.make_module(spec.init_params(0, cfg, "cuda"), cfg)
    ins = _inputs(noisy_speech(6 * SR, 96))
    plain_ms, ref = _median_ms(Session(model, manifest, device="cuda"), ins)
    by_path = {}
    for path, mesh in (("gan_mesh_all_cards", make_mesh()),
                       ("gan_mesh_dp2_one_card", make_mesh(devices=["cuda:0"] * 2))):
        session = Session(model, manifest, mesh=mesh)
        session.process(*ins)  # warm-up
        for mod in kernel_modules():
            mod.reset_launches()
        ms, out = _median_ms(session, ins)
        counts = {k: n for mod in kernel_modules() for k, n in mod.launches.items()}
        forwards = 4 * mesh.shape["dp"]  # _median_ms: a warm-up and 3 requests
        want = {k: n * forwards for k, n in GAN_PER_FORWARD.items()}
        got = {k: counts[k] for k in want}
        lsb = max(int(np.max(np.abs(a.astype(np.int32) - b.astype(np.int32))))
                  for a, b in zip(out.outputs, ref.outputs))
        print(f"mesh {path}: {mesh!r}, 6 s request median {ms:.3f} ms vs the plain Session "
              f"{plain_ms:.3f} ms; vs plain max {lsb} LSB; launches {got} over 4 requests "
              f"of {mesh.shape['dp']} dp rows  [{card}]", flush=True)
        if lsb > 1 or got != want:
            fail(f"{path}: {lsb} LSB from the plain Session, launches {got} (want {want})")
        by_path[path] = counts
    return by_path


def check_pp_stack(card: str) -> dict:
    """Phase 33's pipeline: ``pp_stack_fn`` over MossFormer2-SS's 24
    full-width FLASH layers (B4 and B6 inside), 2 stages over the card's
    device list (``cuda:0`` twice on one card), 2 microbatches of the 6 s
    request's 4 windows of 3999 frames, against the layers run in order on
    the whole batch: within ``PP_RTOL`` × max|ref|; returns its launches."""
    from functools import partial

    from audiojax_torch.models.mossformer2_ss import MossFormer2SsConfig, init_mossformer2_ss
    from audiojax_torch.nn.mossformer import flash_layer
    from audiojax_torch.parallel import pp_stack_fn, stack_layer_params
    from audiojax_torch.parallel.sharding import Mesh

    cfg = MossFormer2SsConfig()
    params = init_mossformer2_ss(0, cfg, "cuda")
    per_layer = [params[f"flash{i}"] for i in range(cfg.depth)]
    layer = partial(flash_layer, group_size=cfg.group_size, qk_dim=cfg.qk_dim,
                    rot_dim=cfg.rot_dim)
    cards = torch.cuda.device_count()
    mesh = Mesh(np.array([f"cuda:{i % cards}" for i in range(2)], dtype=object), ("pp",))
    staged = stack_layer_params(per_layer, 2)
    run = pp_stack_fn(layer, mesh)
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((4, 3999, cfg.dim), generator=gen, device="cuda")
    with torch.inference_mode():
        ref = x
        for p in per_layer:
            ref = layer(p, ref)
        run(staged, x)  # warm-up
        for mod in kernel_modules():
            mod.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(staged, x)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = {k: n for mod in kernel_modules() for k, n in mod.launches.items()}
        t0 = time.perf_counter()
        seq = x
        for p in per_layer:
            seq = layer(p, seq)
        torch.cuda.synchronize()
        seq_ms = (time.perf_counter() - t0) * 1e3
    err = float((out - ref).abs().max() / ref.abs().max())
    want = {"quad_attention": 2 * cfg.depth, "dwconv1d": 4 * cfg.depth}
    got = {k: counts[k] for k in want}
    print(f"pp_stack: MossFormer2-SS's {cfg.depth} FLASH layers (dim {cfg.dim}) over {mesh!r}, "
          f"2 microbatches of {(x.shape[0] // 2, *x.shape[1:])}: {ms:.3f} ms vs {seq_ms:.3f} ms in order on "
          f"the batch; max |Δ| / max|ref| {err:.3g} (gate {PP_RTOL}); launches {got}  [{card}]",
          flush=True)
    if not err <= PP_RTOL or got != want:
        fail(f"pp_stack: error {err:.3g} × max|ref|, launches {got} (want {want})")
    return {"pp_stack_ss_flash": counts}


def check_parallel(card: str) -> dict:
    """Phase 33's mesh and pipeline; its loop graphs are phase 30's."""
    by_path = serve_mesh(card)
    by_path.update(check_pp_stack(card))
    return by_path


# ── phase 32 ───────────────────────────────────────────────────────────────

# utils.bench_all over three families, each with its bf16 variant where it
# has one and the q8f32 plan: DFSMN (no bf16 knob; GTCRN, whose leaves all
# lie under the q8 plan's 4,096-element floor, would make an error row),
# MossFormerGAN-SE and Mel-Band Roformer
BENCH_ARGS = ("--models", "dfsmn,mossformergan_se,melband_roformer", "--quant", "q8f32",
              "--iters", "3")
BENCH_ROWS = ["dfsmn", "dfsmn+q8f32", "mossformergan_se", "mossformergan_se+bfloat16",
              "mossformergan_se+q8f32", "melband_roformer", "melband_roformer+bfloat16",
              "melband_roformer+q8f32"]
GAN_STAGES = ["stft", "istft", "sync_paths", "mossformer_gau", "triple_attention", "se_layer",
              "uni_fsmn", "ffconvm", "dense_fsmn", "decoders"]
KIT_SECONDS = 6


def tool_child(name: str, *args: str) -> int:
    """Phase 32's child: imports ``audiojax_torch.utils.<name>``, takes the
    card and loads the kernels, says ``ready``; when told ``go`` on stdin,
    runs the tool's ``main`` (its output as it prints it), then prints one
    JSON line of the launches its run made."""
    import importlib

    from audiojax_torch.device import resolve_device
    from audiojax_torch.ops import _build

    tool = importlib.import_module(f"audiojax_torch.utils.{name}")
    torch.zeros(1, device=resolve_device("cuda"))
    for src in sorted(_build.CSRC.glob("*.cu")):
        _build.load(src.stem)
    print("ready", flush=True)
    if sys.stdin.readline().strip() != "go":
        return 1
    rc = tool.main(list(args))
    print(json.dumps({"launches": {k: n for mod in kernel_modules()
                                   for k, n in mod.launches.items()}}), flush=True)
    return rc


def start_tool(name: str, *args: str) -> tuple:
    """``tool_child`` started in a process of its own, to get ready beside
    untimed work (phase 30's exports) and run later, the card to itself."""
    import tempfile

    log = tempfile.mktemp(prefix=f"chip_smoke_{name}_", suffix=".log")
    return name, args, _spawn(log, "--tool", name, *args), log


def _tool(started: tuple) -> tuple:
    """Runs a started tool; returns (its output lines before the launches
    line, the launches)."""
    name, args, proc, log = started
    if proc.stdout.readline().strip() != "ready":
        proc.kill()
        fail(f"utils.{name} did not get ready:\n{Path(log).read_text()[-4000:]}")
    proc.stdin.write("go\n")
    proc.stdin.flush()
    out, _ = proc.communicate(timeout=600)
    if proc.returncode != 0:
        fail(f"utils.{name} {' '.join(args)} exited {proc.returncode}:\n"
             f"{Path(log).read_text()[-4000:]}")
    Path(log).unlink(missing_ok=True)
    lines = out.strip().splitlines()
    return lines[:-1], json.loads(lines[-1])["launches"]


def check_bench_all(card: str, started: tuple) -> dict:
    """Phase 32's ``utils.bench_all``: eight rows without an error, each with
    its RTF, operation count and MFU, the q8f32 rows with their SNR against
    float32; its rows rendered into a copy of README.md by
    ``utils.readme_tables``."""
    import shutil
    import tempfile

    from audiojax_torch.utils import readme_tables

    root = tempfile.mkdtemp(prefix="chip_smoke_bench_")
    try:
        rows_file = started[1][-1]
        lines, launches = _tool(started)
        for line in lines:
            print(f"tools: bench_all {line}", flush=True)
        file_card, rows = readme_tables.read_rows(rows_file)
        if file_card != card:
            fail(f"bench_all recorded the card as {file_card!r}, not {card!r}")
        if [r["model"] for r in rows] != BENCH_ROWS:
            fail(f"bench_all rows {[r['model'] for r in rows]}, not {BENCH_ROWS}")
        for r in rows:
            bad = ("error" in r or not r["rtf"] > 0 or not r.get("gflops", 0) > 0
                   or not 0 <= r.get("mfu_pct", -1) < 100
                   or ("+q8" in r["model"]) != ("snr_vs_f32_db" in r))
            if bad:
                fail(f"bench_all row {r}")
        readme = f"{root}/README.md"
        shutil.copy(Path(__file__).resolve().parent / "README.md", readme)
        readme_tables.main(["--readme", readme, "--zoo", rows_file])
        text = Path(readme).read_text()
        zoo = text[text.index(f"<!-- {readme_tables.ZOO_TAG}:begin -->"):
                   text.index(f"<!-- {readme_tables.ZOO_TAG}:end -->")]
        quant = text[text.index(f"<!-- {readme_tables.QUANT_TAG}:begin -->"):
                     text.index(f"<!-- {readme_tables.QUANT_TAG}:end -->")]
        if (f"Card: {card}" not in zoo or zoo.count("\n| ") != 1 + 3
                or "| MossFormerGAN-SE (f32 / bf16) |" not in zoo or quant.count("| q8f32 |") != 3):
            fail(f"readme_tables rendered:\n{zoo}\n{quant}")
        print(f"tools: readme_tables {readme_tables.ZOO_TAG}:{zoo.split('-->', 1)[1]}", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def check_gan_profile(card: str, started: tuple) -> dict:
    """Phase 32's ``utils.gan_profile --iters 3 --json``: the ten stages, each
    stub run and the function it replaced never called."""
    lines, launches = _tool(started)
    report = json.loads(lines[-1])
    names = [r["name"] for r in report["stages"]]
    if names != GAN_STAGES or report["config"]["chip"] != card:
        fail(f"gan_profile stages {names}, chip {report['config']['chip']!r}")
    for r in report["stages"]:
        if r["stub_calls"] <= 0 or r["original_calls"] != 0:
            fail(f"gan_profile stage {r}")
    from audiojax_torch.utils.zip_profile import to_markdown

    for line in to_markdown(report).splitlines():
        print(f"tools: gan_profile {line}", flush=True)
    return launches


def check_parity_kit(card: str) -> dict:
    """Phase 32's ``utils.parity_suite``: a GTCRN kit built here (a synthetic
    checkpoint from ``tests/test_torch_ckpt_builders.py``, a 6 s input, the
    port's own CPU answer as its ref) run on the card, at ≥ 40 dB; returns
    the card run's launches, where B1 and B2 must show."""
    import shutil
    import tempfile

    from audiojax_torch.runtime.audio_io import write_wav
    from audiojax_torch.runtime.export import export_artifact
    from audiojax_torch.utils import parity, parity_suite

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_kit_"))
    try:
        mdir = root / "kit" / "gtcrn"
        (mdir / "inputs").mkdir(parents=True)
        (mdir / "ref").mkdir()
        torch.save(load_builders().build_gtcrn_state_dict(seed=7), mdir / "checkpoint.pt")
        write_wav(mdir / "inputs" / "case0.wav", noisy_speech(KIT_SECONDS * SR, 97), SR)
        export_artifact("gtcrn", mdir / "checkpoint.pt", root / "cpu_art", smoke=False)
        session = parity.load_session("gtcrn", root / "cpu_art", device="cpu")
        ref = session.process(*parity.read_inputs([mdir / "inputs" / "case0.wav"],
                                                  session.manifest))
        write_wav(mdir / "ref" / "case0.wav", ref.audio, SR)
        for mod in kernel_modules():
            mod.reset_launches()
        t0 = time.perf_counter()
        report = parity_suite.run_kit(root / "kit", workdir=root / "work")
        elapsed = time.perf_counter() - t0
        launches = {k: n for mod in kernel_modules() for k, n in mod.launches.items()}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    (m,) = report["models"]
    print(f"tools: parity_suite on a GTCRN kit ({KIT_SECONDS} s input, ref the port's CPU "
          f"answer): {json.dumps(m)} in {elapsed:.1f} s, launches "
          f"{ {k: n for k, n in launches.items() if n} }  [{card}]", flush=True)
    if not report["passed"] or m["min_snr_db"] < MIN_SNR_DB:
        fail(f"parity_suite on the card: {report}")
    if launches["stft_packed"] <= 0 or launches["istft_packed"] <= 0:
        fail(f"parity_suite's card request launched {launches}")
    return launches


def start_measure_tools(card: str, kit: dict) -> dict:
    """Phase 32's untimed part, beside phase 30's exports: its two timing
    tools started (each gets ready in a process of its own, then waits), and
    the parity kit run on the card (its launches into ``kit``).  Returns the
    started tools."""
    import tempfile

    rows_file = tempfile.mktemp(prefix="chip_smoke_bench_", suffix=".jsonl")
    started = {"bench_all": start_tool("bench_all", *BENCH_ARGS, "--json-out", rows_file),
               "gan_profile": start_tool("gan_profile", "--iters", "3", "--json")}
    kit["tools_parity_kit"] = check_parity_kit(card)
    return started


def check_measure_tools(card: str, started: dict) -> dict:
    """Phase 32's timed part: bench_all with readme_tables, then gan_profile,
    one at a time; returns each one's launches by path."""
    try:
        return {"tools_bench_all": check_bench_all(card, started["bench_all"]),
                "tools_gan_profile": check_gan_profile(card, started["gan_profile"])}
    finally:
        Path(started["bench_all"][1][-1]).unlink(missing_ok=True)
        for _, _, proc, _ in started.values():
            if proc.poll() is None:
                proc.kill()


def build_all() -> None:
    """Every kernel source built, one nvcc each, all started together."""
    start_builds()()


def start_builds():
    """Phase 2: ``build_all``'s builds and the native bridge's, started
    together; waits for B1/B2's source (all that phase 3 needs) and returns a
    function that waits for the rest, so that they build while phase 3 runs."""
    from audiojax_torch.ops import _build

    def one(name: str) -> float:
        t0 = time.perf_counter()
        _build.load(name)
        return time.perf_counter() - t0

    names = [src.stem for src in sorted(_build.CSRC.glob("*.cu"))]
    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(len(names) + 1)
    futures = {name: pool.submit(one, name) for name in names}
    native = pool.submit(build_native)  # g++, beside the nvcc builds
    futures["stft"].result()

    def finish() -> None:
        for name, future in futures.items():
            print(f"build: csrc/{name}.cu in {future.result():.2f} s", flush=True)
        print(f"build: native/audioio.cc (g++) in {native.result():.2f} s", flush=True)
        pool.shutdown()
        print(f"build: {len(names)} sources in {time.perf_counter() - t0:.2f} s into "
              f"{_build.BUILD_DIR}", flush=True)

    return finish


def main() -> int:
    if sys.argv[1:2] == ["--graph-export"]:  # phase 30's stages
        return graph_export(*sys.argv[2:])
    if sys.argv[1:2] == ["--graph-child"]:
        return graph_child(*sys.argv[2:])
    if sys.argv[1:2] == ["--tool"]:  # phase 32's children
        return tool_child(*sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from audiojax_torch.device import resolve_device

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    def phase(n: int, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        print(f"phase {n} in {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    finish_builds = phase(2, start_builds)
    rows = phase(3, check_kernels, dev)
    phase("2, the rest of the builds", finish_builds)
    rows.update(phase(4, check_gan_kernels, dev))
    latency = {}
    by_path = {"gtcrn": phase(5, serve, card, latency)}
    by_path["mossformergan_se"] = phase(6, serve_windowed, card, "mossformergan_se",
                                        GAN_PER_FORWARD, (11, 12, 13), latency)
    rows.update(phase(7, check_zip_kernels, dev))
    # the first frame of a reflect-padded fold window is symmetric and its
    # phase feature the sign of rounding noise: the clip held card against CPU
    # starts with that frame's 201 samples silent (frame0_witness holds the
    # cause on the same clip without them)
    by_path["zipenhancer"] = phase(8, serve_windowed, card, "zipenhancer", ZIP_PER_FORWARD,
                                   (21, 22, 23), latency, lead_silence=201)
    rows.update(phase(9, check_ss_kernels, dev))
    by_path["mossformer2_ss"] = phase(10, serve_windowed, card, "mossformer2_ss",
                                      SS_PER_FORWARD, (31, 32, 33), latency, clip=speech_mix)
    # the bf16 plans: their kernels, then the three families beside phases 6, 8, 10
    rows.update(phase(24, check_bf16_kernels, dev))
    by_path.update(phase(25, serve_bf16, card, latency))
    # phases 12 and 14–20 before phase 11, which compares against their latency
    by_path["dfsmn"] = phase(12, serve_windowed, card, "dfsmn", DFSMN_PER_FORWARD,
                             (51, 52, 53), latency)
    phase(14, check_se_kernels, dev)
    by_path["mossformer2_se"] = phase(15, serve_windowed, card, "mossformer2_se",
                                      SE_PER_FORWARD, (54, 55, 56), latency)
    # the host-bound families' 30 s requests (UL-UNAS, NKF-AEC, SDAEC, Deep-Echo,
    # the cascade, H-GTCRN) launch what their 6 s ones do, and are left out for time
    by_path["ul_unas"] = phase(16, serve_windowed, card, "ul_unas", UL_PER_FORWARD,
                               (57, 58, 59), latency, seconds=(7,))
    by_path["nkf_aec"] = phase(17, serve_windowed, card, "nkf_aec", NKF_PER_FORWARD,
                               (61, 62, 63), latency, clip=echo_pair, seconds=(6,))
    by_path["sdaec"] = phase(18, serve_windowed, card, "sdaec", AEC319_PER_FORWARD,
                             (64, 65, 66), latency, clip=echo_pair, rtf=True, seconds=(6,))
    by_path["deep_echo"] = phase(19, serve_windowed, card, "deep_echo", AEC319_PER_FORWARD,
                                 (67, 68, 69), latency, clip=echo_pair, rtf=True, seconds=(6,))
    by_path["dfsmn_aec"] = phase(20, serve_windowed, card, "dfsmn_aec", CASCADE_PER_FORWARD,
                                 (71, 72, 73), latency, clip=echo_pair, rtf=True, seconds=(6,))
    by_path.update(phase(21, serve_melband, card, latency))
    by_path["mossformer2_sr"] = phase(22, serve_sr, card, dev, latency)
    by_path["h_gtcrn"] = phase(23, serve_windowed, card, "h_gtcrn", HGTCRN_PER_FORWARD,
                               (81, 82, 83), latency, clip=two_mic, energies=h_gtcrn_energies,
                               seconds=(6,))
    # the native bridge and FLAC; the other families' bf16 plans beside phases
    # 15, 21 and 22; the q8 and weight-only bf16 plans through the artifact
    by_path["gtcrn_flac"] = phase(26, check_native, card)
    by_path.update(phase(27, serve_bf16_rest, card, dev, latency))
    by_path.update(phase(28, serve_plans, card))
    by_path.update(phase(11, serve_imported, card, latency))
    by_path.update(phase(13, serve_streams, card))
    # a JAX artifact, the graph artifacts, the tools
    by_path["gtcrn_jax_artifact"] = phase(29, serve_jax_artifact, card)
    # phase 31's smoke and inspect_model run beside phase 30's exports
    # phase 31's smoke and inspect_model, and phase 32's parity kit and its
    # tools' start, run beside phase 30's exports
    beside = {}

    def untimed() -> None:
        run_tools(card)
        beside["tools"] = start_measure_tools(card, by_path)

    by_path.update(phase("30 (and 31's smoke and inspect_model, 32's kit)", serve_graphs, card,
                         beside=untimed))
    phase(31, bench_stream_lanes, card)
    # the measurement tools, one at a time
    by_path.update(phase(32, check_measure_tools, card, beside["tools"]))
    # the mesh and the pipeline (its loop graphs ran in phase 30's stages)
    by_path.update(phase(33, check_parallel, card))

    sources = {
        "stft_packed": ("audiojax_torch/csrc/stft.cu", "audiojax/ops/stft_pallas.py:207"),
        "istft_packed": ("audiojax_torch/csrc/stft.cu", "audiojax/ops/stft_pallas.py:361"),
        "dwconv1d": ("audiojax_torch/csrc/dwconv.cu", "audiojax/ops/dwconv_pallas.py:52"),
        "dwconv1d_tiled": ("audiojax_torch/csrc/dwconv.cu", "audiojax/ops/dwconv_pallas.py:120"),
        "quad_attention": ("audiojax_torch/csrc/quad_attention.cu",
                           "audiojax/ops/attention_pallas.py:61"),
        "relpos_scores": ("audiojax_torch/csrc/relpos_scores.cu",
                          "audiojax/ops/attention_pallas.py:195"),
    }
    # the bf16 instances (the bf16 plans' path), beside the float32 ones: the
    # served bf16 shapes of B3, B4, B5 and B6 run on their tensor-core kernels
    sources.update({
        "dwconv1d_bf16": ("audiojax_torch/csrc/dwconv_bf16.cu", "audiojax/ops/dwconv_pallas.py:52"),
        "dwconv1d_tiled_bf16": ("audiojax_torch/csrc/dwconv_bf16.cu",
                                "audiojax/ops/dwconv_pallas.py:120"),
        "quad_attention_bf16": ("audiojax_torch/csrc/quad_attention_bf16.cu",
                                "audiojax/ops/attention_pallas.py:61"),
        "relpos_scores_bf16": ("audiojax_torch/csrc/relpos_scores_bf16.cu",
                               "audiojax/ops/attention_pallas.py:195"),
    })
    kernels = []
    for name, (source, replaces) in sources.items():
        row = rows[name]
        paths = {path: counts[name] for path, counts in by_path.items()}
        if not any(paths.values()):
            fail(f"{name} was launched on no served path")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": sum(paths.values()),
                        "launches_by_path": paths,
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
