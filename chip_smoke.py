#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no failure is caught and carried past):
  1. print the card's name and power limit; build the CUDA kernels from
     ``src/repro_torch/csrc`` with nvcc, one process per source, and print
     the build time;
  2. hold each kernel against its plain PyTorch version on the card at
     shapes beyond the BoW path's (phase 15 repeats it on the path's tensors;
     `bow_quantize_hist` bit for bit, unnormalised and normalised, with the
     valids and with fractional weights, two runs bit-identical, at N = 32,
     45, 100 and K = 5 to 1300, one to eight CTAs a cluster; `gbdt_score`
     bit for bit and one launch at 16, 40 and 64 trees, 10 and 33 classes,
     B = 1, 7, 256 and 1024, with x == thr at every level of tree 0 in the
     first rows, and a 655,360-byte leaf table, 64 trees of depth 8);
     each chain runs under the kernel `mode=None` resolves to and under the
     window kernel; then the chains fixed-size tables once refused
     (`table_phase`): even taps (2x2, 4x4, 6/6 separable, odd x even) and
     four 13x13 filters (676 weights), 33 stages, 9 resolution levels, 17
     output bands and 5 remaps, on a 600x700 u8 image and its f32 copy, in
     every mode, one launch each, bit-equal to the plain version; nine
     pyrDowns on the same image run plain and are refused by both kernels
     with the limit that binds (the stride product 512, shared memory);
  3. the training path on the card, once per head (SVM, GBDT): 1000
     ImageStream images at 32x32, a 250-word dictionary, the §4.5 config,
     k-means seeded from a CPU generator at seed 0.  Each training launches
     `stencil_stream` once (the preprocess chain), `stencil_chain` once (the
     octave, on planes no larger than its halo) and `bow_assign` 21 times
     (20 k-means iterations + the histograms), and calls no plain version.
     Both heads are also trained on the CPU from the same seed, for the
     accuracy check of 4;
  4. the predict path on the card, once per head: 4 requests of 256 test
     images through `pipeline.predict`, each launching its head's kernels
     (SVM: stencil_stream, stencil_chain, bow_quantize_hist, linear_score;
     GBDT: the same with gbdt_score) and no plain version; accuracy above
     0.15 and within 0.05 of the CPU-trained model's, labels identical
     across two runs and within 1% of a CPU plain `predict` of the same model;
  5. the paper's filter2D / erode image path through `kernels.ops`,
     `cv.imgproc` and `fused_chain`: gaussian_filter2d at 1080p and 4K u8,
     k = 3..13; erode at 1080p, 4K and 8K u8, r = 1..3; the acceptance
     chain gaussian(5) -> erode(1) -> threshold(100) on (8, 512, 512, 3) u8;
     the BoW preprocess chain on the same batch in f32; one octave ladder
     (without its next base) on a 512x512 f32 plane.  Each shape runs in every mode (None, window,
     streaming, tiled2d), one launch of the named kernel each and no plain
     call, max_abs_err 0 against the plain version, and the three kernel
     modes bit-identical; a full-width streaming plan over the
     shared-memory budget must raise `ValueError`.  Then `stencil_stream`
     and `stencil_chain` are timed on each shape (all 24 in window mode), the
     plain version on the 4K shapes, and `conv2d` as the library call for
     gaussian_filter2d k = 5 and 13;
  6. the fused-vs-staged-vs-seed pipeline benchmark (`pipeline_phase`):
     the seed kernels against their plain versions (512x512, 1081x1919,
     37x53, 511x513, a 300x1 plane and a 37x53 plane at an odd address,
     blur k = 1..31, erode r = 0-3, 7, 12, 32 and the thresholds of the
     seed's table on all but the first two), max_abs_err 0; then `scripts/torch_pipeline_bench.py` `run`:
     the chain gaussian(5) -> erode(1) -> threshold(100) on (8, 512, 512,
     3) u8 fused in every mode (one launch each, bit-identical to the plain
     version), staged (72 stencil launches) and seed (24 launches of each
     seed kernel, no plain call), the seed equal to its plain version and
     to the staged path, the fused interior equal to the staged one, and
     the host wall of each form (best and median of 5); and its
     `run_octave`: the octave with its next base on a 512x512 f32 plane in
     every mode (one launch, every band bit-identical to the plain
     version; full-width streaming must raise) and staged (8 launches);
     `ops.pyr_down` at 1080p and 4K u8 in every mode; the strided geometry
     at odd sizes with several tiles and segments; each octave kernel's
     device time with and without the next base; and each seed kernel's
     device time (a CUDA graph of 100 calls replayed), plain time, bound
     and library call (`conv2d` for the blur, `max_pool2d` of the negated
     plane for the erode, checked equal to it, `torch.where` for the
     threshold), beside the launch floor (a graph of 100 one-element
     in-place adds);
  7. the geometric path (`geometric_phase`): `imgproc.warp_affine` (a
     1-degree rotation about the centre and a (4, -3) translation),
     `imgproc.remap` (an identity map plus a smooth field), `resize_half`,
     `ops.sobel`, sobel -> grad_mag and gaussian(3) -> resize2(tap=0) at
     1080p and 4K u8, and again at 1081x1919 u8 and 37x53 f32 with several
     window tiles, column tiles and row segments, each in every mode (one
     launch, every band equal to the plain version in dtype, shape and
     bits, the three kernel modes bit-identical; over-budget full-width
     streaming must raise); `run_warp` of the benchmark (the warp -> ladder
     chain of `align_and_detect` on a 512x512 f32 plane, one launch in each
     mode that fits against 8 staged launches, its interior equal to the
     staged one, host walls and graph-replay device times);
     `features.align_and_detect` on the same plane against a `mode="ref"`
     run on the card (keypoints equal but at counted near-ties); then each
     1080p / 4K shape's and the warp chain's kernel times (both kernels),
     plain time, bound and library call (`grid_sample` for the gathers,
     `avg_pool2d` for resize_half, `conv2d` for sobel);
  8. the multi-octave pyramid path (`pyramid_phase`): `ops.pyr_up` at
     1080p and 4K u8 (outputs 2160x3840 and 4320x7680) and the chains
     pyrDown -> pyrUp, gaussian(5) -> pyrDown -> erode(1), resize2 ->
     gaussian(3) and pyrUp -> gaussian(3) at 1080p u8 and at 1081x1919 u8
     and 37x53 f32 with several window tiles, column tiles and row
     segments, each in every mode (one launch, every band equal to the
     plain version in dtype, shape and bits; over-budget full-width
     streaming must raise); `features.sift_pyramid` with 4 octaves on
     512x512, 1080p and 4K gray f32 (exactly 4 launches and no plain call,
     every band bit-equal to the plain version, keypoints equal to a
     `mode="ref"` run on the card but at counted near-ties); BoW `train` and
     `predict` with both heads at `PipelineConfig(preprocess=True,
     n_octaves=3, max_kp=32)` on phase 3's images (`stencil_stream` once,
     `stencil_chain` three times, then `bow_assign` x21 or
     `bow_quantize_hist` and the head's kernel; labels identical across two
     runs and within 1% of a plain CPU predict); `run_pyramid` of the
     benchmark (4 launches in each mode that fits against 31 staged, host
     walls and graph-replay device times); then pyr_up's times (both
     kernels, plain, `conv_transpose2d`, bound) and each pyramid link's
     mode, time, plain time and bound;
  9. measured routing (`routing_phase`): `autotune.measure_chain` (n = 3)
     on each of phase 5's 24 shapes and `measure_pyramid` on a 512x512
     pyramid's 4 links, the plan table in a temporary directory; per shape
     the fit rule's mode, the measured winner and their times; then
     ``fused_chain(mode=None)`` / ``chained_launches(mode=None)`` launch
     each winner's kernel (exact launch counts, no plain call) bit-equal to
     the winner's explicit mode, from the cache and again from the table
     read back under ``REPRO_TORCH_AUTOTUNE_CACHE_READ=1``; last one
     injected ``lowering_error`` under the ladder ("streaming", "window"):
     exactly one event, injected, and one `stencil_chain` launch; then the
     benchmark's `run_small_kernel_routing`.  Every phase ends with an
     empty degradation log and no fault armed;
 10. the CV serving engine (`serve_phase`): `serve.cv_engine.CvEngine` at
     full width (buckets 32², 64², 128², 256², ``max_batch=64``, phase 3's
     config and models, K = 250): 512 requests (384 u8 RGB and 124 f32
     gray frames of sides 24-256, two of 320x320, one of bad rank, one of
     bad dtype), every well-formed one served with no retry, on
     "streaming" or, where its full-width rings do not fit (the 256²
     bucket, the 320² frames), on "tiled2d" after one recorded move, no
     other rung change, `stencil_stream` twice a batch (three after such a
     move) and no plain version, descriptors bit-equal to
     `extract_features` at the batch's rung and
     keypoints equal to a `mode="ref"` run on the card but at counted
     near-ties; both heads' predictions equal to `pipeline.predict`
     (`bow_quantize_hist` and the head's kernel once a batch); one fault
     spec at a time (``lowering_error``, ``nan_input``, ``bucket_miss``,
     ``measure_timeout`` on ``warm``, ``shard_oom`` and ``device_loss``
     through virtual devices on the card), each with exactly its expected
     events; a ladder to "ref" refused before any launch; then the host
     wall of a 512-request `submit`, requests a second, each bucket's mean
     batch latency, and `erode_vanherk` against `ops.erode` at 1080p u8;
 11. the LM serving path (`lm_phase`), once for each ported arch (`LM_RUNS`):
     gemma-7b, starcoder2-7b (36 query heads over 4 KV heads, LayerNorm,
     biases), h2o-danube-3-4b (32 over 8 of head dim 120, a 4096-position
     window) at full width and depth, qwen2-72b (64 over 8, QKV biases)
     at full width cut to 8 of its 80 layers (~9.5 B parameters),
     arctic-480b (56 over 8, a 128-expert top-2 MoE FFN beside a dense one)
     cut to 2 of its 35 layers (~27.7 B parameters; its f32 check on a
     1-layer model, `F32_LAYERS`) and deepseek-v3-671b (MLA: 128 heads, q
     and k of 192 channels, v of 128 padded to 192 on the kernel route; a
     256-expert top-8 MoE FFN with a shared expert) cut to 4 of its 61
     layers, 3 dense and 1 MoE (~15.1 B); each MoE arch prints its
     prefill's ``moe_drop_frac`` and expert-load range per layer, and its
     kernel and plain runs are compared on the sequences whose routing
     agrees, changed choices counted as near-ties (`judge_routes`);
     zamba2-2.7b (54 Mamba2 layers, ~2.4 B parameters, and one shared
     attention block of 32 heads of 80 after each run of 6: the kernel on
     the q, k, v of each of the 9 applications and 9 launches a
     `generate`) and xlstm-125m (mLSTM / sLSTM blocks: no attention, no
     launch, no plain call) at full depth, each also with its f32-widened
     decode steps within 2e-3 of a full-sequence walk at 1024 + 32 and on
     prompts of 2 tokens + 8 (the conv tail under its 3 taps); the
     cross-attention archs at full depth, their gates set to `GATE` (0.5;
     JAX's init of 0 makes a gated layer the identity) and their context
     input drawn as `launch.serve.make_extras` draws it: llama-3.2-vision-11b
     (~8.0 B parameters; JAX's blocks: 24 self-attention layers of 32 over
     8 heads of 128 and 8 gated cross-attention layers over ``image_embeds``
     (8, 1600, 4096)) and seamless-m4t-large-v2 (~1.6 B; a 24-layer
     bidirectional encoder over ``audio_frames`` (8, 1024, 1024), then 24
     decoder layers of causal self-attention and cross-attention over the
     encoder's output, 16 heads of 64): every application checked at its
     own mask (cross-attention and the encoder at ``causal=False``), a
     decode step's cross-attention (S = 1) in bf16 and f32, 32 + 8 x 31 =
     280 and 72 + 24 x 31 = 816 launches a `generate` (one a prefill
     application, one a cross-attention layer each decode step), the
     f32-widened decode steps within 2e-3 of a full-sequence walk over the
     same context, and the kernel, plain and SDPA (``is_causal`` at the
     call's mask) timed on the first application of each kind.  Below,
     gemma-7b's numbers (28 layers, d 3072, 16 heads of 256, bf16, ~8.5 B
     parameters); the other archs run the same checks at their own shapes
     and layer counts, without the JAX test shapes and the head-dim
     timings.  Each model is built on the card
     from a seeded generator; `flash_attention` held against its plain
     version within `kernels.attention.AGREE` (one rounding to the output
     dtype apart: rtol 2^-7 + atol 1e-4 in bf16, 2e-4 in f32) on every
     layer's q, k, v of the prefill (8 x 1024 x 16 x 256, bf16), on an f32
     copy of layer 0's and on the JAX kernel test's shapes; greedy
     `generate` of 8 requests x 1024 prompt tokens + 32 new tokens,
     launching `flash_attention` exactly 28 times (the prefill; decode runs
     `dense_attention`) and no plain version; tokens identical across two
     runs, and each the argmax of a `mode="ref"` (plain) teacher-forced
     prefill + decode but at counted near-ties (at random init the argmax
     is the token fed in, so these two cannot see a kernel fault); then the
     kernel, its plain version and SDPA (`is_causal=True`, the yardstick),
     the prefill and a decode step are timed, with the kernel's bound
     (q.k and two 16-bit p.v passes at the tensor cores' rate) and the
     earlier price of the same work (p.v at the f32 rate); last, the same weights
     widened to f32: the kernel and plain paths' final hidden states at
     every prompt position within 2e-4 and last-token logits within 2e-3,
     and the bf16 paths' logits within twice the bf16 model's own error.
     Then `flash_attention` at query offsets (`flash_offset_phase`: a
     rank's slice of the queries under the sequence-parallel layout),
     bf16 and f32, at gemma-7b's (8, 1024, 16, 256) layer sliced over 2 and
     16 ranks and at a GQA shape off the 128-row tiles: each slice bit for
     bit the whole launch's rows, offset 0 bit for bit the call without
     one, each within `AGREE` (16-bit: `OFF_PLAIN_SHARE`) of the plain
     version at its offset.  Then its log-sum-exp output
     (`flash_lse_phase`): at gemma-7b's prefill layer in bf16 and f32 and at
     a decode step's cross-attention over llama-3.2-vision-11b's 1600 and
     seamless-m4t-large-v2's 1024 context rows, every output bit for bit
     the launch's without it, the log-sum-exp within 1e-5 of the plain
     version's, and 2 and 16 context slices merged by it (split-K decode):
     f32 within `AGREE` of the whole launch, bf16 within its parts'
     roundings of the f32 plain version's.
     Then h2o-danube-3-4b's long request (`long_prompt_phase`): 1 x 8704
     prompt tokens + 8, past 8192 positions and past its window, so the
     prefill runs `blockwise_attention` (no kernel launch, no plain call)
     and decode reads the 4096-slot ring that holds the prompt's last 4096
     positions; widened to f32, every step's logits within 2e-3 of one
     full-sequence walk's at that position;
 12. the LM training path (`train_phase`): gemma-7b at full width (d 3072,
     16 heads of 256, d_ff 24576, vocab 256000, bf16, remat on), 4 x 1024
     tokens a step through `train.loop.train`: (a) 8 of 28 layers with
     AdamW, 4 steps on a repeated batch at warmup 1, the loss falling, 16
     `flash_attention` launches a step (8 forward, 8 recomputed under
     remat) and 8 plain backward calls (`counters.BACKWARD_CALLS`), no
     plain forward; step times, tokens a second, peak memory, a profiled
     step's device time with the kernel's and the plain backward's
     shares, and one layer's kernel output against its plain version
     within `AGREE`; (b) all 28 layers with Adafactor, 2 steps, peak
     memory and step time; (c) at 2 layers in f32, the loss and every
     gradient against the plain route (`mode="ref"`), w_q / w_k / w_v
     gradients non-zero, and the same in bf16 at bf16's bounds; (d) one
     step of each arch's reduced config in f32 against the plain route,
     each route at the launches the config's attention layers imply;
     a checkpoint round trip (preempted at step 2, resumed, against an
     unbroken run);
 13. the sharded LM stack (`shard_phase`, in a process of its own, so that
     no process group lives in this one): (a) one rank, NCCL, a (1, 1)
     ("data", "model") mesh: phase 12 (a)'s model trained through the
     launcher's code (`launch.train.main --model-parallel 1`) for 2 steps
     of 4 x 1024 tokens, its losses within phase 12's bf16 bound (2^-10)
     of the same steps unsharded, 16 `flash_attention` launches a step and
     no plain call, step times and peak memory; then gemma-7b's 28 layers
     generating 8 x 1024 + 8 tokens with ``mesh=``, the tokens identical to
     the unsharded `generate`'s but at counted near-ties, 28 launches and
     no plain call; (b) two gloo ranks on the one card (NCCL takes one rank
     a card), a (2, 1) mesh, reduced deepseek-v3-671b in f32 on 4 x 32
     tokens: the all-to-all MoE path taken, the logits within 1e-4 and
     every gradient within 1e-3 of one rank's unsharded run; (c) two gloo
     ranks on the one card, a (1, 2) mesh: the model axis split as JAX's
     hints lay it out (`sharding.rules.model_layout`), gemma-7b at full
     width and 4 layers ("tp": 8 heads of 256 a rank, the FFN hidden and
     the vocabulary split) and h2o-danube-3-4b at 8 of 24 layers ("sp": the sequence
     split, rank 1's queries on the kernel at offset 512), each a bf16
     prefill of 2 x 1024 against the same rank's unsharded prefill (the
     last position's logits and the rank's slots of layer 0's K cache: at most
     `OFF_PLAIN_SHARE` of the entries outside `AGREE`), one launch a layer
     and no plain call; then one f32 AdamW step of each layout's reduced
     config (gemma-7b at 16 q and 16 KV heads, qwen2-72b) against the same
     step unsharded: logits within 1e-4, the loss within 1e-5, every
     parameter within 1e-4; (d) the same mesh, decode over the model axis
     (`sharding.rules.decode_layout`: each rank's slots of the cache,
     split-K; "tp" heads and FFN; the MoE experts where they lie):
     gemma-7b "tp" (4 layers), h2o-danube-3-4b (8 layers, split-K alone, a
     4352-token prompt whose 4096-slot ring wraps over both ranks' 2048
     slots), seamless-m4t-large-v2 "tp" (full depth, the cross-attention
     on the kernel with its log-sum-exp over the rank's 512 encoder rows)
     prefilled and decoded 16 steps teacher-forced in bf16 against rank
     0's unsharded decode by (c)'s RMS rule, deepseek-v3-671b "tp" (4
     layers, 128 of 256 experts a rank) widened to f32 on both sides within
     2e-3 on the rows whose routing agrees; each step's time, each rank's
     peak above its model's parts (below one whole expert stack's bytes),
     the launches and no plain call; then each one's f32 reduced twin
     within 1e-4; (e) the same mesh, the Mamba2 mixer's SSD heads over the
     model axis and ZeRO-1's optimizer state: zamba2-2.7b at full width
     and 6 layers (40 of 80 SSD heads a rank, ``out_proj`` its rows), a
     bf16 prefill of 2 x 1024 decoded 8 steps teacher-forced by (d)'s
     rule, then 2 AdamW steps within (a)'s loss bound of the same steps
     unsharded; deepseek-v3-671b at full width, one MLA and one MLA-MoE
     layer, 2 Adafactor steps in bf16, each rank's peak below its
     parameters, gradients and state plus one whole expert stack; every
     rank's state `opt_bytes_zero1`; each one's f32 reduced twin against
     the same steps unsharded (logits 1e-4, losses 1e-5, parameters 1e-4);
     the launches and no plain call;
 14. the dry run and the roofline (`dryrun_phase`): (a) gemma-7b's
     decode_32k cell and its long_500k skip cell through
     ``python -m repro_torch.launch.dryrun --cell``, each in a process of
     its own on a fake process group of 256 ranks (no card), their roofline
     rows printed; (b) phase 12 (a)'s train step traced on the meta device
     and run on the card, each under `roofline.cost.CostMode`: the flops,
     bytes and `flash_attention` calls (16) equal, no link bytes; the
     roofline's three terms and step time beside a measured step, the
     predicted peak beside `torch.cuda.max_memory_allocated`;
 15. on the paths' own tensors (the first request, the training
     descriptors and final centroids), hold each kernel against its plain
     version again, count the device activities of one `bow_quantize_hist`
     call with torch.profiler (exactly its kernel: no memset, cast or
     normalising launch), then time each kernel, its plain version and (for
     `linear_score`) one PyTorch call computing the same function;
 16. print the window arithmetic of the request's octave with its frames
     cut and full (`window_floor_ms`) beside `stencil_chain`'s time, then
     the ``kernels`` JSON line (all ten kernels, the port of all eleven TPU
     kernels; `stencil_stream` at the 4K u8 gaussian_filter2d k = 13 under
     mode=None, `flash_attention` at gemma-7b's prefill layer 0, with each
     attention arch's first application under ``by_arch`` and, for the
     cross-attention archs, the first of each kind of call (self-attention,
     bidirectional, cross-attention) under its ``by_call``, the seed kernels
     on one 512x512 u8 plane, `gbdt_score`'s graph time beside the launch
     floor),
     then the card line and the device line.

Each path is driven with the launch counters set to 0 just before it and
read just after; a kernel's ``launches`` in the JSON line sums the paths'.
Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository.  Results also go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import collections
import copy
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s, fp32
# FLOP/s on the CUDA cores, and bf16 / f16 FLOP/s on the tensor cores (with
# f32 accumulation), the rate of a product whose operands are bf16 or f16
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

PREDICT_BATCH = 256
N_REQUESTS = 4
N_TRAIN = 1000
DICT_SIZE = 250
HEADS = ("svm", "gbdt")
HEAD_KERNEL = {"svm": "linear_score", "gbdt": "gbdt_score"}
# the image-path shape whose stencil_stream numbers go on the kernels line
STREAM_ENTRY = "gaussian_filter2d k=13 4K u8"
# the LM serving path: each ported arch at full width, 8 requests of 1024 + 32
# tokens; (arch, layers kept): qwen2-72b's 80 layers (~145 GB in bf16) do not
# fit the card's 80 GB, so its run keeps 8 (~19 GB, 38 GB widened to f32);
# arctic-480b keeps 2 of 35 (~27.2 GB a layer: 55.4 GB with the embedding and
# the head) and deepseek-v3-671b 4 of 61 (its 3 dense MLA layers and one
# MLA-MoE layer, ~30.2 GB; 60.4 GB widened); the cross-attention archs run
# whole (llama-3.2-vision-11b ~16 GB, 32 GB widened; seamless-m4t-large-v2
# ~3.3 GB)
LM_RUNS = (("gemma-7b", None), ("starcoder2-7b", None), ("h2o-danube-3-4b", None),
           ("qwen2-72b", 8), ("arctic-480b", 2), ("deepseek-v3-671b", 4),
           ("zamba2-2.7b", None), ("xlstm-125m", None),
           ("llama-3.2-vision-11b", None), ("seamless-m4t-large-v2", None))
# the f32-widened check of an arch whose widened model does not fit the card
# runs on a model of fewer layers, built after the bf16 one is freed:
# arctic-480b at 2 layers would take ~111 GB in f32, at 1 ~55 GB
F32_LAYERS = {"arctic-480b": 1}
LM_ARCH = LM_RUNS[0][0]  # the arch whose layer 0 goes on the kernels line
LM_BATCH, LM_PROMPT, LM_GEN = 8, 1024, 32
# h2o-danube-3-4b's long request: past 8192 positions (blockwise attention)
# and past its 4096-position window (the decode ring adopts the last 4096)
LONG_ARCH, LONG_PROMPT, LONG_GEN = "h2o-danube-3-4b", 8704, 8
# the recurrent archs' short request: a prompt under the conv's K - 1 = 3
# taps, the port's fourth departure from JAX (models/ssm.py)
SHORT_PROMPT, SHORT_GEN = 2, 8
# the training path (`train_phase`): gemma-7b at full width, 4 x 1024 tokens a
# step; (a) 8 of its 28 layers with AdamW (~3.0 B parameters, ~36 GB with the
# f32 moments), 4 steps on a repeated batch at warmup 1 and peak lr 1e-4 (a
# smaller step leaves most bf16 weights unchanged: 1e-4 is ~1/180 of a weight
# of the init's 1 / sqrt(3072), bf16's ulp is 1/128 to 1/256 of a value);
# (b) all 28 with Adafactor (~8.5 B, ~34 GB of weights and gradients), 2
# steps, else the most layers of the fallbacks that fit; (c) the gradient
# check at 2 layers, 2 x 1024 tokens, in f32 (loss within 1e-5 relative, every
# gradient within 1e-3 in relative L2 of the plain route) and in bf16 (loss
# within 2^-10, every gradient within 2^-6 in relative L2, the card test's
# bound: an H100 read 6.8e-6 and 0.18-0.40%); (d) one step of each arch's
# reduced config in f32, 2 x 128 tokens
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ = "gemma-7b", 4, 1024
TRAIN_LAYERS, TRAIN_STEPS, TRAIN_LR = 8, 4, 1e-4
TRAIN_FULL_STEPS, TRAIN_FALLBACK_LAYERS = 2, (28, 20, 14)
GRAD_LAYERS, GRAD_BATCH, GRAD_LOSS_RTOL, GRAD_RTOL = 2, 2, 1e-5, 1e-3
GRAD_BF16_LOSS_RTOL, GRAD_BF16_RTOL = 2.0**-10, 2.0**-6
REDUCED_BATCH, REDUCED_SEQ = 2, 128
# the sharded LM stack (`shard_phase`): (a) phase 12 (a)'s model and batch,
# SHARD_STEPS steps through the launcher on a one-rank NCCL mesh, and gemma-7b
# generating LM_BATCH x LM_PROMPT + SHARD_GEN tokens; (b) SHARD_RANKS gloo
# ranks on the one card, reduced deepseek-v3-671b in f32 on SHARD_B x SHARD_S
# tokens, within JAX's bounds for its all-to-all path (tests/test_moe.py)
SHARD_STEPS, SHARD_GEN, SHARD_RANKS = 2, 8, 2
SHARD_B, SHARD_S, SHARD_LOGITS_TOL, SHARD_GRAD_TOL = 4, 32, 1e-4, 1e-3
# (c) the model axis split as JAX's hints lay it out (`sharding.rules.
# model_layout`), a (1, 2) ("data", "model") mesh of two gloo ranks on the one
# card: (arch, layers kept, its layout) at full width, bf16, a prefill of
# SHARD_AXIS_B x SHARD_AXIS_S tokens (gemma-7b: 8 heads of 256 a rank, 4
# layers so that two ranks' copies fit; h2o-danube-3-4b at 8 of 24 layers,
# for the phase's time: its 8 KV heads do not pass the 16-way test, so the
# sequence splits and rank 1's queries take the kernel at offset 512); then
# one f32 train step of each layout's reduced
# config (SHARD_AXIS_TRAIN: 16 q and 16 KV heads for "tp") on
# SHARD_AXIS_TRAIN_B x SHARD_AXIS_TRAIN_S tokens, at (b)'s bounds (logits,
# the loss's gradients) and the training parity bounds (losses 1e-5,
# parameters 1e-4)
SHARD_AXIS_RUNS = (("gemma-7b", 4, "tp"), ("h2o-danube-3-4b", 8, "sp"))
SHARD_AXIS_B, SHARD_AXIS_S = 2, 1024
# the bf16 prefills' logits against the unsharded ones: "sp" at most
# OFF_PLAIN_SHARE of entries outside AGREE (the same sums in the same order a
# row); both layouts' RMS distance within SHARD_AXIS_RMS x the unsharded bf16
# logits' RMS distance to the f32-widened model's (two bf16 roundings of one
# function, each at that error, lie at most ~sqrt 2 of it apart; "tp" rounds
# w_o's and w_down's partial sums before it adds them, so about half of its
# logits fall outside AGREE).  Reduced on two CPU ranks: sound "tp" 0.89 of
# it, "sp" 0; rank 1's w_o partial sums x (1 + 2^-4) 5.2, the query offset
# one short 24.7 (mutated copies)
SHARD_AXIS_RMS = 2.0**0.5
SHARD_AXIS_TRAIN = (("gemma-7b", {"n_heads": 16, "n_kv_heads": 16, "head_dim": 8}, "tp"),
                    ("qwen2-72b", {}, "sp"))
SHARD_AXIS_TRAIN_B, SHARD_AXIS_TRAIN_S, SHARD_LOSS_TOL, SHARD_PARAM_TOL = 2, 64, 1e-5, 1e-4
# (d): decode over the model axis (`sharding.rules.decode_layout`) on the same
# (1, 2) mesh: (arch, layers kept (None: all), the decode layout, prompt
# tokens, rows) at full width, bf16, prefilled and decoded SHARD_DECODE_STEPS
# steps teacher-forced, against the same model's unsharded decode and its
# f32-widened one (the bf16 model's own error) on rank 0, by (c)'s RMS rule;
# gemma-7b "tp" at 4 layers; h2o-danube-3-4b at 8 layers, split-K alone (8 KV
# heads), its prompt past the 4096-slot window, so that the ring wraps over
# both ranks' 2048 slots; seamless-m4t-large-v2 "tp" at full depth, its
# cross-attention on the kernel over the rank's 512 of the 1024 encoder rows,
# merged by the log-sum-exp; deepseek-v3-671b "tp" at 4 layers (3 MLA + 1
# MLA-MoE, 128 of its 256 experts a rank), widened to f32 on both sides
# (in bf16 its top-8 of 256 routing flips on near-ties in every row: 29 of
# the 4 x 64 prompt tokens, chip run 3) and held within SHARD_DECODE_F32_TOL
# (JAX's f32 decode-consistency bound, tests/test_decode_consistency.py) on
# the rows whose routing agrees at every call (`judge_routes`).  Then each
# one's f32 reduced twin (SHARD_DECODE_TWINS: "tp" at 16 q and 16 KV heads)
# within SHARD_LOGITS_TOL
SHARD_DECODE_RUNS = (("gemma-7b", 4, "tp", 1024, 2), ("h2o-danube-3-4b", 8, "splitk", 4352, 2),
                     ("seamless-m4t-large-v2", None, "tp", 1024, 2),
                     ("deepseek-v3-671b", 4, "tp", 64, 4))
SHARD_DECODE_STEPS, SHARD_DECODE_F32_TOL = 16, 2e-3
SHARD_DECODE_TWINS = (("gemma-7b", {"n_heads": 16, "n_kv_heads": 16, "head_dim": 8}, "tp", 12),
                      ("h2o-danube-3-4b", {}, "splitk", 40),
                      ("seamless-m4t-large-v2", {"n_heads": 16, "n_kv_heads": 16, "head_dim": 8},
                       "tp", 12),
                      ("deepseek-v3-671b", {"n_heads": 16, "n_kv_heads": 16}, "tp", 12))
# (e): the Mamba2 mixer's SSD heads over "model" (JAX's "ssm_heads",
# `sharding.rules.ssm_heads`) and the optimizer state in ZeRO-1's layout
# (`sharding.rules.opt_state_specs`) on the same (1, 2) mesh.  zamba2-2.7b at
# full width, its first SHARD_SSM_LAYERS layers (a run of Mamba2 layers and
# its shared block; 40 of the 80 SSD heads a rank, `out_proj` the rank's rows),
# a bf16 prefill of SHARD_SSM_B x SHARD_SSM_S tokens decoded SHARD_SSM_STEPS
# steps teacher-forced, against rank 0's unsharded and f32-widened decodes by
# (d)'s rule ((c)'s RMS bound; the prefill's last logits too), then
# SHARD_TRAIN_STEPS AdamW steps of the same batch at (a)'s peak lr TRAIN_LR
# against the same steps unsharded (the losses within GRAD_BF16_LOSS_RTOL,
# (a)'s rule; at 1e-3, ten times TRAIN_LR, the third loss, after the first
# step that moves the weights, read 1.35e-3 off on an H100).
# deepseek-v3-671b at full width, SHARD_MOE_BLOCKS (one MLA and one MLA-MoE
# layer, 128 of its 256 experts a rank), SHARD_TRAIN_STEPS Adafactor steps of
# SHARD_MOE_B x SHARD_MOE_S tokens in bf16 (in f32 the two ranks' parameters and
# gradients alone take ~107 GB of the card's 80), unsharded nowhere: at full
# width this run checks memory only (each rank's peak below its parameters,
# gradients and optimizer state plus one whole expert stack: a leaf gathered
# whole would be that stack and its gradient; its state `opt_bytes_zero1`;
# finite losses), and the numbers of the sharded MoE Adafactor update are
# held by the f32 reduced twin below.  Then their f32 reduced twins against the same
# steps unsharded (SHARD_SSM_TWIN_S tokens: the decode's logits within
# SHARD_LOGITS_TOL, the losses within SHARD_LOSS_TOL, every parameter within
# SHARD_PARAM_TOL, the loss's gradients whole within SHARD_GRAD_TOL; deepseek's
# aux loss weighted 0, since the all-to-all path takes it per shard, as JAX's)
SHARD_SSM_LAYERS, SHARD_SSM_B, SHARD_SSM_S, SHARD_SSM_STEPS = 6, 2, 1024, 8
SHARD_MOE_BLOCKS, SHARD_MOE_B, SHARD_MOE_S = (("mla", 1), ("mla_moe", 1)), 4, 64
SHARD_TRAIN_STEPS, SHARD_SSM_TWIN_S = 3, 32
# the twins' peak lr: AdamW's step is ~lr g / (|g| + eps), so a component whose
# gradient is at f32's rounding noise (B and C's in_proj columns sum both
# ranks' heads in another order) may step +lr on one side and -lr on the
# other (ROADMAP, "f32 noise"); at 1e-4 such a flip stays within
# SHARD_PARAM_TOL unless its gradient exceeds AdamW's eps
SHARD_TWIN_LR = 1e-4
# `flash_attention`'s query offsets (a rank's slice of the queries under the
# sequence-parallel layout), on the card after the LM phase: (B, T, H, Hkv,
# hd, rows, offsets): gemma-7b's prefill layer sliced over 2 and over 16
# ranks of "model", and h2o-danube-3-4b's GQA heads (hd 120, padded to 128)
# at offsets off the 128-row tiles; each slice the whole launch's rows bit
# for bit, and the kernel against its plain version
FLASH_OFFSETS = ((8, 1024, 16, 16, 256, 512, (0, 512)), (8, 1024, 16, 16, 256, 64, (960,)),
                 (4, 1024, 32, 8, 120, 100, (0, 300, 924)))
# `flash_attention`'s log-sum-exp output (`flash_lse_phase`), after the offsets:
# (label, B, S, T, H, Hkv, hd, causal, dtypes, slice counts): gemma-7b's
# prefill layer in bf16 and f32, and a decode step's cross-attention (S = 1)
# over llama-3.2-vision-11b's 1600 image rows and seamless-m4t-large-v2's 1024
# encoder rows, whose context slices (a rank's of 2 or 16 under split-K
# decode) are merged by their log-sum-exp (`models.attention.merge_lse`): in
# f32 within `AGREE` of the whole launch; in bf16 each slice's output is
# rounded before the merge, so the merge is held to the f32 plain version
# within the roundings of its parts, FLASH_LSE_ATOL + 2^-8 x (the weighted
# sum of the slices' |outputs| + |merged|) (2^-8: bf16's unit roundoff).
# Every output bit for bit the same launch's without the log-sum-exp, which
# is within FLASH_LSE_TOL of the plain version's
FLASH_LSE = (("gemma-7b prefill layer", 8, 1024, 1024, 16, 16, 256, True,
              ("bfloat16", "float32"), ()),
             ("llama-3.2-vision-11b cross-attention decode", 8, 1, 1600, 32, 8, 128, False,
              ("bfloat16", "float32"), (2, 16)),
             ("seamless-m4t-large-v2 cross-attention decode", 8, 1, 1024, 16, 16, 64, False,
              ("bfloat16", "float32"), (2, 16)))
FLASH_LSE_TOL, FLASH_LSE_ATOL = 1e-5, 1e-4
# the dry run (`dryrun_phase`): (a) a full-size pod cell whose trace is short
# (a decode) and a skip cell, each through the command line; (b) phase 12
# (a)'s step traced on the meta device and run on the card
DRYRUN_CELLS = ("gemma-7b:decode_32k:pod", "gemma-7b:long_500k:pod")
# the cross-attention archs' gates after the seeded init (JAX's init: 0, so
# that a gated layer is the identity and no check could see it)
GATE = 0.5


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, *, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, from CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def near_tie_mask(descs, cents, ulps: int = 4):
    """(M,) descriptors whose best and second-best s = -2 d.c + |c|^2 lie
    within `ulps` f32 ulps (s recomputed in f64)."""
    import torch

    d = descs.reshape(-1, descs.shape[-1]).double()
    c = cents.double()
    s = -2.0 * d @ c.T + (c * c).sum(1)[None]
    two = torch.topk(s, 2, dim=1, largest=False).values
    best = two[:, 0].float().abs()
    ulp = torch.nextafter(best, torch.full_like(best, math.inf)) - best
    return (two[:, 1] - two[:, 0]) <= ulps * ulp.double()


def chain_flops(stages) -> float:
    """FLOP per input pixel of a chain (the image domain, halo excluded):
    each stage's count per pixel of its own input, times that input's area
    against the chain's (a quarter past a stride, four times past a pyrUp)."""
    from repro_torch.kernels.stencil import chain_levels, resolve_chain

    lv = chain_levels(stages)
    total = 0
    for k, (s, (_op, mode, *_rest)) in enumerate(zip(stages, resolve_chain(stages))):
        area = 1.0
        for _o, (sy, sx), (uy, ux) in lv.steps[lv.lv_in[k]]:
            area *= uy * ux / (sy * sx)
        total += area * stage_flops(s, mode)
    return total


def stage_flops(s, mode: str) -> float:
    """FLOP per input pixel of one stage."""
    if s.op == "filter2d":
        return 2 * s.weights[0].numel()  # a product and a sum per tap
    elif s.op == "sep_filter":
        return 2 * (s.weights[0].numel() + s.weights[1].numel())
    elif s.op in ("erode", "dilate"):
        return 2 * (2 * s.static[0])  # separable min / max: row + column compares
    elif s.op == "box":
        return 2 * (2 * s.static[0]) + 1  # row + column sums, one scaling
    elif s.op == "threshold":
        return 1
    elif s.op == "affine":
        return 2
    elif s.op == "grad_mag" and mode == "reduce":
        return 3  # 2 squares, 1 add (+ sqrt)
    elif s.op == "grad_mag":
        return 7  # 2 sub, 2 scale, 2 square, 1 add (+ sqrt)
    elif s.op == "pyr_down":
        # 5 row taps at the even columns of every row, 5 column taps at
        # the even (row, column) pairs: 2 * (5/2 + 5/4) per input pixel
        return 7.5
    elif s.op == "resize2":
        return 1  # 3 adds and a scaling per 2x2 block
    elif s.op == "sobel":
        return 13  # 3 column differences, 2 column sums (2 adds, 1 doubling), dx 3, dy 1
    elif s.op == "warp_affine":
        return 19  # coordinates 4 mul + 4 add, 2 fracs, 3 lerps of 3
    elif s.op == "remap":
        return 11  # 2 fracs, 3 lerps of 3
    elif s.op == "pyr_up":
        # per output pixel 4.5 (a row phase per output row and source
        # column: even 4, odd 2, so 3 per pair of rows, 1.5 an output;
        # then its column phase, 3 on average): 4 outputs an input
        return 18
    raise ValueError(f"chain_flops: no count for stage op {s.op!r}")


def as_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


RES = {"1080p": (1080, 1920), "4K": (2160, 3840), "8K": (4320, 7680)}


def image_path_cases(dev, ops, imgproc, features, stencil, ref, ImageStream) -> list:
    """The third slice's shapes: the paper's filter2D (Tables 1-3) and erode
    (Tables 4-6) benches at their sizes, the acceptance chain of
    benchmarks/pipeline_bench.py, the BoW preprocess chain and one octave
    ladder.  Images come from `ImageStream().image`, seeded per image; the
    plain version is timed on the 4K shapes, `conv2d` for the Gaussian
    filter2D at k = 5 and 13."""
    import torch

    stream = ImageStream()
    cases = []

    def add(name, img, chain, call, lib=None):
        cases.append({"name": name, "img": img, "chain": chain, "call": call, "lib": lib,
                      "plain": " 4K " in name})

    for res in ("1080p", "4K"):
        img = stream.image(RES[res], seed=0).to(dev)
        for k in (3, 5, 7, 9, 11, 13):
            k1 = ref.gaussian_kernel1d(k)
            chain = (stencil.filter_stage(torch.outer(k1, k1)),)
            add(f"gaussian_filter2d k={k} {res} u8", img, chain,
                lambda mode, img=img, k=k: ops.gaussian_filter2d(img, k, mode=mode),
                "conv2d" if k in (5, 13) else None)
    for res in ("1080p", "4K", "8K"):
        img = stream.image(RES[res], seed=1).to(dev)
        for r in (1, 2, 3):
            add(f"erode r={r} {res} u8", img, (stencil.erode_stage(r),),
                lambda mode, img=img, r=r: ops.erode(img, r, mode=mode))
    batch = torch.stack([stream.image((512, 512), channels=3, seed=b) for b in range(8)]).to(dev)
    acc = (stencil.gaussian_stage(5), stencil.erode_stage(1), stencil.threshold_stage(100.0))
    add("acceptance (8,512,512,3) u8", batch, acc,
        lambda mode: stencil.fused_chain(batch, acc, mode=mode))
    pre = (stencil.gaussian_stage(5), stencil.erode_stage(1), stencil.grad_stage())
    fbatch = batch.float()
    add("preprocess (8,512,512,3) f32", fbatch, pre,
        lambda mode: imgproc.preprocess_bow(fbatch, mode=mode))
    plane = stream.image((512, 512), seed=2).to(dev).float()
    add("octave (512,512) f32", plane, features.octave_chain(4, with_next_base=False),
        lambda mode: tuple(features.gaussian_octave(
            plane[None], with_next_base=False, mode=mode)[0][0].unbind(0)))
    return cases


def table_chains(stencil, hw, dev) -> dict:
    """Chains the TPU kernels take that fixed-size step tables on the card
    once refused (ROADMAP Queue 2), for an (H, W) image on `dev`:
    even taps (2x2, 4x4 filters, 6/6 separable, odd x even mixes, taps
    beside a map) and chains past the old tables: four 13x13 filters (676
    weights), 33 stages, 9 resolution levels (pyrDown / pyrUp x 4, then a
    pyrDown), 17 output bands, 5 remaps.  Taps are seeded, positive and
    sum to 1, so a u8 chain stays in range (tests/test_torch_stencil.py
    `table_chain` builds the same chains)."""
    import numpy as np
    import torch

    def taps(seed, *shape):
        w = np.random.default_rng(seed).random(shape, dtype=np.float32) + np.float32(0.25)
        return torch.from_numpy((w / w.sum()).astype(np.float32))

    def sep(nx, ny, seed, **kw):
        return stencil.sep_filter_stage(taps(seed, nx), taps(seed + 1, ny), **kw)

    h, w = hw
    remaps = []
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    # displacements under a pixel; each remap budgets the halo the later
    # ones read (out-of-image lookups clamp to the map's edge)
    for i, e in enumerate((15, 7, 3, 1, 0)):
        mx = (xx + (0.3 + 0.05 * i) * torch.cos(yy / 5.0)).contiguous()
        my = (yy + (0.45 - 0.05 * i) * torch.sin(xx / 7.0)).contiguous()
        remaps.append(stencil.remap_stage(mx, my, extend=(e, e)))
    ops3 = (lambda: stencil.gaussian_stage(3), lambda: stencil.affine_stage(0.9375, 3.0),
            lambda: stencil.erode_stage(1))
    return {
        "even 2x2": (stencil.filter_stage(taps(1, 2, 2)),),
        "even 4x4": (stencil.filter_stage(taps(2, 4, 4)),),
        "even sep 6/6": (sep(6, 6, 3),),
        "odd x even": (stencil.filter_stage(taps(4, 3, 4)), sep(5, 2, 5),
                       stencil.filter_stage(taps(6, 4, 5))),
        "even taps beside a map": (stencil.gaussian_stage(3), sep(4, 6, 7, tap=0),
                                   stencil.erode_stage(1), stencil.filter_stage(taps(8, 2, 6)),
                                   sep(2, 2, 9, tap=-2)),
        "676 weights": tuple(stencil.filter_stage(taps(10 + i, 13, 13)) for i in range(4)),
        "33 stages": tuple(ops3[i % 3]() for i in range(33)),
        "9 levels": tuple(stencil.pyr_down_stage() if i % 2 == 0 else stencil.pyr_up_stage()
                          for i in range(8)) + (stencil.pyr_down_stage(),),
        "17 bands": tuple(stencil.gaussian_stage(3 + 2 * (i % 3), tap=0) for i in range(16)),
        "5 remaps": tuple(remaps),
    }


TABLE_HW = (600, 700)


def table_cases(dev, stencil, ImageStream) -> list:
    """`table_chains` on a 600x700 u8 image and its f32 copy, in the
    image-path case format: the 9-level chain with 32-row steps (its stride
    product is 32), the 17-band chain with 4-row steps (17 rings)."""
    from repro_torch.core.device import LaunchConfig

    img = ImageStream().image(TABLE_HW, seed=21).to(dev)
    cases = []
    for dt, x in (("u8", img), ("f32", img.float())):
        for name, chain in table_chains(stencil, TABLE_HW, dev).items():
            lc = LaunchConfig(stream_rows={"9 levels": 32, "17 bands": 4}.get(name, 8))
            cases.append({"name": f"{name} 600x700 {dt}", "img": x, "chain": chain, "lc": lc,
                          "plain": False, "lib": None,
                          "call": lambda mode, x=x, chain=chain, lc=lc:
                          stencil.fused_chain(x, chain, mode=mode, lc=lc)})
    return cases


def check_modes(case, counters, stencil, ref, path_counts: dict, max_err: dict) -> tuple:
    """One image-path shape in every mode (None, window, streaming,
    tiled2d): one launch of the kernel the mode names and no plain call,
    every band equal to the plain version's in dtype, shape and bits, and
    the three kernel modes bit-identical; an explicit full-width streaming
    plan over the shared-memory budget must raise.  -> (the plain version's
    bands, the planes, the mode None resolves to)."""
    import torch

    name, img, chain, call = case["name"], case["img"], case["chain"], case["call"]
    want = as_tuple(stencil.fused_chain(img, chain, mode="ref"))
    planes = ref.to_planes(img)
    if "lc" in case:
        resolved = stencil.resolve_mode(chain, planes.shape, img.dtype, case["lc"])
    else:
        resolved = stencil.resolve_mode(chain, planes.shape, img.dtype)
    outs = {}
    for mode in (None, "window", "streaming", "tiled2d"):
        kernel = "stencil_chain" if (mode or resolved) == "window" else "stencil_stream"
        what = f"{name} mode={mode}"
        if mode == "streaming" and resolved == "tiled2d":
            # full-width rings over the budget: the explicit plan must refuse
            counters.reset()
            try:
                call("streaming")
                raised = None
            except ValueError as e:
                raised = str(e)
            check(raised is not None, f"{what}: over-budget streaming did not raise")
            expect_counts(what, counters.snapshot(), {})
            print(f"check {what}: ValueError as required ({raised})")
            continue
        got, snap = counted(counters, lambda: as_tuple(call(mode)))
        torch.cuda.synchronize()
        expect_counts(what, snap, {kernel: 1})
        path_counts[what] = snap
        check(len(got) == len(want), f"{what}: {len(got)} bands, want {len(want)}")
        err = 0.0
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype, f"{what}: shape or dtype")
            err = max(err, float((g.float() - w.float()).abs().max()))
        check(err == 0.0, f"{what}: max_abs_err {err} against the plain version")
        max_err[kernel] = max(max_err[kernel], err)
        outs[mode] = got
        print(f"check {what} ({kernel}, {mode or resolved}): launches={snap['launches'][kernel]} "
              f"max_abs_err={err} bands={[(tuple(g.shape), str(g.dtype)) for g in got]}")
    for mode in ("streaming", "tiled2d"):
        if mode in outs:
            same = all(torch.equal(a, b) for a, b in zip(outs[mode], outs["window"]))
            check(same, f"{name}: {mode} differs from window")
    print(f"check {name}: window, streaming and tiled2d bit-identical "
          f"({'streaming over budget' if 'streaming' not in outs else 'all three ran'})")
    return want, planes, resolved


def table_phase(dev, counters, stencil, ref, ImageStream, max_err: dict, results: dict) -> None:
    """Phase 2's chains that fixed-size tables once refused (`table_cases`):
    each in every mode, one launch and bit-equal to the plain version
    (`check_modes`); then nine pyrDowns on a 600x700 u8 plane, which the
    plain version runs and both kernels refuse by `ValueError` naming the
    limit that binds: a tile and a step must be multiples of the stride
    product 512, and a 512-row tile's window is far over a block's shared
    memory."""
    import torch

    from repro_torch.core.device import LaunchConfig

    counts = {}
    for case in table_cases(dev, stencil, ImageStream):
        check_modes(case, counters, stencil, ref, counts, max_err)
        results["checks"][f"table chain {case['name']}"] = {"max_abs_err": 0.0}
    img = ImageStream().image(TABLE_HW, seed=22).to(dev)
    nine = tuple(stencil.pyr_down_stage() for _ in range(9))
    want = stencil.fused_chain(img, nine, mode="ref")
    check(tuple(want.shape) == (2, 2), f"nine pyrDowns: plain shape {tuple(want.shape)}")
    for mode, lc, limit in (("window", LaunchConfig(), "stride product"),
                            ("window", LaunchConfig(tile_rows=512, tile_cols=512), "shared memory"),
                            ("streaming", LaunchConfig(stream_rows=64), "stride product"),
                            ("tiled2d", LaunchConfig(stream_rows=64), "stride product")):
        counters.reset()
        try:
            stencil.fused_chain(img, nine, mode=mode, lc=lc)
            raised = None
        except ValueError as e:
            raised = str(e)
        check(raised is not None and limit in raised,
              f"nine pyrDowns {mode}: want a ValueError naming the {limit}, got {raised}")
        check(sum(counters.LAUNCHES.values()) == 0, f"nine pyrDowns {mode}: launched")
        print(f"check nine pyrDowns 600x700 u8 {mode}: ValueError as required "
              f"({(raised or '')[:120]})")
    torch.cuda.synchronize()
    results["checks"]["nine pyrDowns 600x700 u8"] = "refused by the stride product and shared memory"


def window_floor_ms(stages, shape, dtype) -> dict:
    """The arithmetic `stencil_chain`'s windows do for (N, H, W) planes
    (`exec_window.window_flops` at the launch's tile), with the frames cut
    and with every frame full, and each at the f32 rate."""
    import dataclasses

    from repro_torch.core.device import DEFAULT
    from repro_torch.kernels.stencil import exec_window

    prog = exec_window.compile_chain(stages, dtype)
    th, tw, _ = exec_window.pick_tile(prog, DEFAULT, shape)
    full = dataclasses.replace(prog, frames=tuple(
        f | {"ly": exec_window.UNCUT, "lx": exec_window.UNCUT} for f in prog.frames), _memo={})
    out = {}
    for tag, p in (("cut", prog), ("full", full)):
        flops = shape[0] * exec_window.window_flops(p, th, tw, tuple(shape[1:]))
        out[tag] = {"flops": flops, "ms": flops / PEAK_FP32_FLOPS * 1e3}
    return out


def time_image_case(case, planes, resolved, want) -> dict:
    """Times of one image-path shape on its planes: `stencil_stream` (tiled
    as `mode=None` resolves it; a halo-free chain, which resolves to the
    window kernel, streams full width or, over the budget, tiled) and
    `stencil_chain`, each the faster of two CUDA-event means of 20 calls,
    `ms` the kernel `mode=None` takes; the plain version where the case
    asks for it (``case["plain"]``); the library call ``case["lib"]``
    names (`library_call`).  Bound: the input read once, every band (and
    a remap's map planes) moved once, or the chain's FLOP at the f32 rate."""
    from repro_torch.kernels.stencil import exec_streaming, exec_window

    chain = case["chain"]
    tiled = resolved == "tiled2d"
    if resolved == "window":
        try:
            exec_streaming.stencil_stream(planes, chain)
        except ValueError:
            tiled = True
    run = lambda: exec_streaming.stencil_stream(planes, chain, tiled=tiled)  # noqa: E731
    win = lambda: exec_window.stencil_chain(planes, chain)  # noqa: E731
    plain = lambda: exec_streaming.stencil_stream_plain(planes, chain)  # noqa: E731
    p1 = time_ms(plain, iters=3, warmup=1) if case.get("plain") else None
    s1, w1 = time_ms(run, iters=20), time_ms(win, iters=20)
    s2, w2 = time_ms(run, iters=20), time_ms(win, iters=20)
    p2 = time_ms(plain, iters=3, warmup=1) if case.get("plain") else None
    lib = None
    if case.get("lib"):
        lib = time_ms(library_call(case["lib"], chain, planes, want), iters=20)
    n_bytes = planes.numel() * planes.element_size() + sum(
        w.numel() * w.element_size() for w in want)
    n_bytes += sum(4 * w.numel() for s in chain if s.op == "remap" for w in s.weights)
    n_flops = planes.numel() * chain_flops(chain)
    bms, by = bound_ms(n_bytes, n_flops)
    k1, k2 = (w1, w2) if resolved == "window" else (s1, s2)
    return {
        "resolved": resolved,
        "ms": min(k1, k2),
        "ms_runs": [k1, k2],
        "stream_ms": min(s1, s2),
        "stream_runs": [s1, s2],
        "stream_tiled": tiled,
        "window_ms": min(w1, w2),
        "window_runs": [w1, w2],
        "plain_ms": None if p1 is None else min(p1, p2),
        "plain_runs": None if p1 is None else [p1, p2],
        "library": case.get("lib"),
        "library_ms": lib,
        "bound_ms": bms,
        "bound_by": by,
        "stream_share": bms / min(s1, s2),
        "window_share": bms / min(w1, w2),
        "bytes": n_bytes,
        "flops": n_flops,
    }


def load_bench():
    """`scripts/torch_pipeline_bench.py`, the pipeline benchmark whose
    `run` and `run_octave` the pipeline phase drives."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_pipeline_bench", ROOT / "scripts" / "torch_pipeline_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (thresh, thresh cast to u8): the seed threshold's table
SEED_THRESHOLDS = (0, 100.5, 254.5, 255.9, 255.99999999, 256, -0.5, -1, -5, 300, 511.7, -256)


def pipeline_phase(dev, card: str, max_err: dict, path_counts: dict, results: dict) -> dict:
    """The fused-vs-staged-vs-seed pipeline benchmark (the fifth slice):
    the seed kernels against their plain versions at odd sizes; the
    pipeline path (fused in every mode, staged, seed) and the octave with
    its next base through `scripts/torch_pipeline_bench.py` `run` and
    `run_octave`, which check them, count each path and take the host
    walls; `ops.pyr_down` and the strided geometry at odd sizes; each
    octave kernel's device time with and without the next base; then each
    seed kernel's device time, plain time, bound and library call.
    Returns the seed kernels' timings."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.device import LaunchConfig
    from repro_torch.cv import features
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.kernels import counters, ops, ref, stencil, unfused
    from repro_torch.kernels.stencil import exec_streaming, exec_window

    bench = load_bench()
    gen = torch.Generator(device=dev).manual_seed(16)

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)

    def exact(kernel, what, got, want):
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype, f"{what}: shape or dtype")
        err = float((got.float() - want.float()).abs().max()) if got.numel() else 0.0
        check(err == 0.0, f"{what}: max_abs_err {err} against the plain version")
        max_err[kernel] = max(max_err[kernel], err)
        return err

    # -- the seed kernels against their plain versions -------------------------
    # the odd sizes, a width-1 plane and a plane at an odd address (a slice of
    # a larger buffer at an element offset) take every radius and threshold
    flat = u8(37 * 53 + 16)
    for name, x in (("512x512", u8(512, 512)), ("1081x1919", u8(1081, 1919)),
                    ("37x53", u8(37, 53)), ("511x513", u8(511, 513)), ("300x1", u8(300, 1)),
                    ("37x53 at byte offset 3", flat[3:3 + 37 * 53].view(37, 53))):
        small = name not in ("512x512", "1081x1919")
        for k in range(1, 32, 2) if small else (5,):
            exact("seed_gaussian_blur", f"seed blur k={k} {name}",
                  unfused.seed_gaussian_blur_2d(x, k), unfused.seed_gaussian_blur_2d(x, k, mode="ref"))
        for r in (0, 1, 2, 3, 7, 12, 32) if small else (1,):
            exact("seed_erode", f"seed erode r={r} {name}",
                  unfused.seed_erode_2d(x, r), unfused.seed_erode_2d(x, r, mode="ref"))
        for t in SEED_THRESHOLDS if small else (100.0,):
            exact("seed_threshold", f"seed threshold {t} {name}",
                  unfused.seed_threshold_2d(x, t), unfused.seed_threshold_2d(x, t, mode="ref"))
        print(f"check seed kernels {name} u8: max_abs_err 0 (blur k={'1..31' if small else 5}, "
              f"erode r={(0, 1, 2, 3, 7, 12, 32) if small else 1}, thresholds "
              f"{SEED_THRESHOLDS if small else (100.0,)})")

    # -- the pipeline path and the octave with its next base, by the bench -------
    row, rec = bench.run(dev)
    o_row, o_rec = bench.run_octave(dev)
    for r in (rec, o_rec):
        path_counts.update(r.paths)
        for k, e in r.max_err.items():
            max_err[k] = max(max_err[k], e)
    print(f"check pipeline ({row['batch']}) u8: fused one launch in each mode, bit-identical "
          f"to the plain version; staged {row['pallas_calls_staged']} stencil launches "
          f"{snap_nonzero(rec.paths['pipeline staged'])}; seed "
          f"{snap_nonzero(rec.paths['pipeline seed'])}, no plain call, equal to its plain "
          f"version; seed vs staged: "
          f"{row['seed_pixels_differing_from_staged']} pixels differ (predicted 0); fused interior "
          f"equals staged: {row['interior_bitexact']}")
    print(f"check octave+next base {o_row['image']} f32: one launch in each mode that fits, every "
          f"band bit-identical to the plain version (next base {o_row['next_base']}); staged "
          f"{o_row['pallas_calls_staged']} launches {snap_nonzero(o_rec.paths['octave staged'])}")
    for name, r in (("pipeline", row), ("octave", o_row)):
        walls = "; ".join(f"{k} {v * 1e3:.4f} ms" for k, v in r.items()
                          if k.endswith("_s") and not k.endswith("median_s"))
        graphs = "; ".join(f"{k} {v:.5f}" for k, v in r.items() if k.endswith("_graph_ms"))
        ratios = " ".join(f"{k}={v:.3f}" for k, v in r.items() if k.startswith("fused_speedup"))
        print(f"time {name} (host wall, best of {bench.RUNS}): {walls}; best mode "
              f"{r['fused_mode']}; {ratios}; device (graph replay): {graphs} card={card}")

    # -- ops.pyr_down at 1080p and 4K, and the strided geometry at odd sizes ----
    stream = ImageStream()
    g = stream.image((512, 512), channels=1, seed=0).to(dev).float()
    oct_nb = features.octave_chain(bench.N_SCALES)
    for res in ("1080p", "4K"):
        x = stream.image(RES[res], seed=3).to(dev)
        p_res = stencil.resolve_mode((stencil.pyr_down_stage(),), (1, *RES[res]), x.dtype)
        p_want = ops.pyr_down(x, mode="ref")
        for mode in (None, "window", "streaming", "tiled2d"):
            what = f"pyr_down {res} u8 mode={mode}"
            if mode == "streaming" and p_res == "tiled2d":
                counters.reset()
                try:
                    ops.pyr_down(x, mode=mode)
                    raised = False
                except ValueError:
                    raised = True
                check(raised, f"{what}: over-budget streaming did not raise")
                continue
            kernel = "stencil_chain" if (mode or p_res) == "window" else "stencil_stream"
            got, snap = counted(counters, lambda: ops.pyr_down(x, mode=mode))
            expect_counts(what, snap, {kernel: 1})
            path_counts[what] = snap
            exact(kernel, what, got, p_want)
        print(f"check pyr_down {res} u8 -> {tuple(p_want.shape)}: every mode one launch, "
              f"bit-identical to the plain version (mode None -> {p_res})")
    geoms = [
        ("octave+next base (301, 97) f32 streaming", g[:301, :97], oct_nb, "streaming",
         LaunchConfig(row_segments=3)),
        ("octave+next base (301, 203) f32 tiled2d", g[:301, :203], oct_nb, "tiled2d",
         LaunchConfig(tile2d_cols=64, row_segments=3)),
        ("octave+next base (301, 203) f32 window", g[:301, :203], oct_nb, "window",
         LaunchConfig(tile_rows=16, tile_cols=16)),
        ("pyr_down (1081, 1919) u8 tiled2d", stream.image((1081, 1919), seed=4).to(dev),
         (stencil.pyr_down_stage(),), "tiled2d", LaunchConfig(tile2d_cols=64, row_segments=5)),
    ]
    for what, x, chain, mode, lc in geoms:
        x = x.contiguous()
        planes = ref.to_planes(x)
        if mode != "window":
            prog, _ = exec_streaming.program(chain, lc.stream_rows, x.dtype, dev)
            geo = exec_streaming.stream_geometry(prog, tuple(planes.shape), lc,
                                                 tiled=mode == "tiled2d")
            check(geo.n_seg >= 2 and (mode == "streaming" or geo.n_tiles >= 2),
                  f"{what}: {geo.n_tiles} tiles, {geo.n_seg} segments")
        kernel = "stencil_chain" if mode == "window" else "stencil_stream"
        got = as_tuple(stencil.fused_chain(x, chain, mode=mode, lc=lc))
        for a, b in zip(got, as_tuple(stencil.fused_chain(x, chain, mode="ref")), strict=True):
            exact(kernel, what, a, b)
        print(f"check {what}: bit-identical to the plain version, bands "
              f"{[tuple(a.shape) for a in got]}")

    # -- times ------------------------------------------------------------------
    o_ms = {}
    planes = ref.to_planes(g)
    for name, chain in (("next base", oct_nb),
                        ("no next base", features.octave_chain(4, with_next_base=False))):
        o_ms[f"stencil_chain {name}"] = time_ms(
            lambda chain=chain: exec_window.stencil_chain(planes, chain), iters=20)
        o_ms[f"stencil_stream tiled2d {name}"] = time_ms(
            lambda chain=chain: exec_streaming.stencil_stream(planes, chain, tiled=True), iters=20)
    print("time octave 512x512 f32 (device): " + "; ".join(
        f"{k} {v:.5f} ms" for k, v in o_ms.items()) + f" card={card}")

    batch = torch.stack([stream.image((512, 512), channels=3, seed=b) for b in range(8)]).to(dev)
    plane = batch[0, :, :, 0].contiguous()
    n_px = plane.numel()
    k1 = ref.gaussian_kernel1d(bench.BLUR_K).to(dev)
    hk = bench.BLUR_K // 2
    xpad = ref.pad_replicate(plane.float(), hk, hk)[None, None].contiguous()
    wt = torch.outer(k1, k1)[None, None].contiguous()
    conv = torch.clamp(torch.round(F.conv2d(xpad, wt)[0, 0]), 0, 255)
    lib_diff = float((conv - unfused.seed_gaussian_blur_2d(plane, bench.BLUR_K).float()).abs().max())
    check(lib_diff <= 1.0, f"conv2d differs from the seed blur by {lib_diff}")
    t8 = unfused.to_u8(bench.THRESH)
    hi, lo = (torch.tensor(v, dtype=torch.uint8, device=dev) for v in (255, 0))
    check(torch.equal(torch.where(plane > t8, hi, lo), unfused.seed_threshold_2d(plane, bench.THRESH)),
          "torch.where differs from the seed threshold")
    # the erode's library call: a max filter of the negated plane, widened to
    # f32 and edge-padded outside the timed call, as the blur's conv2d is
    rr = bench.ERODE_R
    xneg = (-ref.pad_replicate(plane.float(), rr, rr))[None, None].contiguous()
    pooled = (-F.max_pool2d(xneg, 2 * rr + 1, stride=1))[0, 0].to(torch.uint8)
    check(torch.equal(pooled, unfused.seed_erode_2d(plane, rr)),
          "-max_pool2d(-x) differs from the seed erode")
    # the launch floor: a graph of 100 launches of the shortest kernel
    # PyTorch has, a one-element in-place add; no bound, the time a kernel
    # as short as a launch takes
    one = torch.zeros(1, device=dev)
    floor = [bench.graph_ms(lambda: one.add_(1), reps=100) for _ in range(2)]
    print(f"time launch floor (one.add_(1), graph replay of 100 calls): "
          f"{floor[0]:.5f}/{floor[1]:.5f} ms card={card}")
    seeds = {
        "seed_gaussian_blur": (lambda: unfused.seed_gaussian_blur_2d(plane, bench.BLUR_K),
                               lambda: unfused.seed_gaussian_blur_2d(plane, bench.BLUR_K, mode="ref"),
                               lambda: F.conv2d(xpad, wt), 2 * 2 * bench.BLUR_K),
        "seed_erode": (lambda: unfused.seed_erode_2d(plane, bench.ERODE_R),
                       lambda: unfused.seed_erode_2d(plane, bench.ERODE_R, mode="ref"),
                       lambda: F.max_pool2d(xneg, 2 * rr + 1, stride=1), 2 * 2 * bench.ERODE_R),
        "seed_threshold": (lambda: unfused.seed_threshold_2d(plane, bench.THRESH),
                           lambda: unfused.seed_threshold_2d(plane, bench.THRESH, mode="ref"),
                           lambda: torch.where(plane > t8, hi, lo), 1),
    }
    # Each call is a few microseconds of device work behind tens of host
    # work, so the kernel, its plain version and the library call are each
    # timed as the replay of a CUDA graph of 100 calls (plain, kernel,
    # kernel, plain); `issued_ms` is the kernel issued from Python.
    timings = {}
    for name, (run, plain, lib, flops_px) in seeds.items():
        p1 = bench.graph_ms(plain, reps=100)
        k_1 = bench.graph_ms(run, reps=100)
        k_2 = bench.graph_ms(run, reps=100)
        p2 = bench.graph_ms(plain, reps=100)
        lib_ms = bench.graph_ms(lib, reps=100) if lib else None
        issued = time_ms(run, iters=100)
        n_bytes = 2 * n_px  # the u8 plane read once and written once
        bms, by = bound_ms(n_bytes, n_px * flops_px)
        timings[name] = {"ms_runs": [k_1, k_2], "plain_runs": [p1, p2], "library_ms": lib_ms,
                         "issued_ms": issued, "bound_ms": bms, "bound_by": by,
                         "bytes": n_bytes, "flops": n_px * flops_px}
        print(f"time {name} (one 512x512 u8 plane, graph replay): ms={k_1:.5f}/{k_2:.5f} "
              f"plain_ms={p1:.4f}/{p2:.4f} library_ms={lib_ms} issued_ms={issued:.5f} "
              f"bound_ms={bms:.6f} ({by}; {n_bytes} B, {n_px * flops_px} FLOP) card={card}")
    results["pipeline"] = {"bench": row, "octave": o_row, "octave_ms": o_ms, "seed_times": timings,
                           "launch_floor_ms": floor}
    return timings


def rot_about_centre(hw, deg: float = 1.0, shift=(4.0, -3.0)) -> list:
    """Inverse map of a `deg` rotation about the image centre plus an (x, y)
    translation: src = R (dst - c) + c + shift."""
    h, w = hw
    cy, cx = (h - 1) / 2, (w - 1) / 2
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    return [[c, -s, cx - c * cx + s * cy + shift[0]], [s, c, cy - s * cx - c * cy + shift[1]]]


def smooth_maps(hw, dev) -> tuple:
    """An identity map plus a smooth field (tests/test_stencil.py:516), f32
    (H, W) on the card: (map_x, map_y)."""
    import torch

    yy, xx = torch.meshgrid(torch.arange(hw[0], dtype=torch.float32, device=dev),
                            torch.arange(hw[1], dtype=torch.float32, device=dev), indexing="ij")
    return xx + 1.2 * torch.cos(yy / 5.0), yy + 1.5 * torch.sin(xx / 7.0)


def geometric_cases(dev, imgproc, ops, stencil, ImageStream) -> list:
    """The sixth slice's image-op shapes at 1080p and 4K u8: warp_affine (a
    1-degree rotation about the centre and a (4, -3) translation), remap
    (an identity map plus a smooth field), resize_half, sobel, sobel ->
    grad_mag and gaussian(3) -> resize2(tap=0); then the same bodies at
    odd sizes with several window tiles, column tiles and row segments,
    where a gather origin off by a row or a column shows."""
    from repro_torch.core.device import LaunchConfig

    stream = ImageStream()
    cases = []

    def add(name, img, chain, call, lib=None):
        cases.append({"name": name, "img": img, "chain": chain, "call": call, "lib": lib,
                      "plain": True})

    def shapes(tag, img, lc=None):
        hw = tuple(img.shape[-2:])
        kw = {} if lc is None else {"lc": lc}
        M = rot_about_centre(hw)
        warp = (stencil.warp_affine_stage(M, shape=hw),)
        mx, my = smooth_maps(hw, dev)
        remap = (stencil.remap_stage(mx, my),)
        sob, sob_grad = (stencil.sobel_stage(),), (stencil.sobel_stage(), stencil.grad_stage())
        res, g_res = (stencil.resize2_stage(),), (stencil.gaussian_stage(3),
                                                  stencil.resize2_stage(tap=0))
        add(f"warp_affine {tag}", img, warp,
            lambda mode: stencil.fused_chain(img, warp, mode=mode, **kw)
            if lc else imgproc.warp_affine(img, M, mode=mode), "grid_sample")
        add(f"remap {tag}", img, remap,
            lambda mode: stencil.fused_chain(img, remap, mode=mode, **kw)
            if lc else imgproc.remap(img, mx, my, mode=mode), "grid_sample")
        add(f"resize_half {tag}", img, res,
            lambda mode: imgproc.resize_half(img, mode=mode, **kw), "avg_pool2d")
        add(f"sobel {tag}", img, sob, lambda mode: ops.sobel(img, mode=mode, **kw),
            "conv2d")
        add(f"sobel->grad_mag {tag}", img, sob_grad,
            lambda mode: stencil.fused_chain(img, sob_grad, mode=mode, **kw))
        add(f"gaussian(3)->resize2(tap=0) {tag}", img, g_res,
            lambda mode: stencil.fused_chain(img, g_res, mode=mode, **kw))

    for res in ("1080p", "4K"):
        shapes(f"{res} u8", stream.image(RES[res], seed=5).to(dev))
    odd = LaunchConfig(tile_rows=16, tile_cols=16, tile2d_cols=224, row_segments=7)
    shapes("1081x1919 u8 (16x16 tiles, 224 columns, 7 segments)",
           stream.image((1081, 1919), seed=6).to(dev), odd)
    small = LaunchConfig(tile_rows=8, tile_cols=8, tile2d_cols=16, row_segments=3, stream_rows=4)
    shapes("37x53 f32 (8x8 tiles, 16 columns, 3 segments)",
           stream.image((37, 53), seed=7).to(dev).float(), small)
    return cases


def library_call(kind: str, chain, planes, want):
    """The PyTorch call that computes a case's function, as a time
    yardstick: `grid_sample` (bilinear, border, align_corners) on the
    gather's coordinates precomputed as a grid, `avg_pool2d` for
    resize_half, `conv2d` with the filter2D taps or the (2, 1, 3, 3) Sobel
    weight on the edge-padded plane, `conv_transpose2d` for pyrUp; inputs
    widened and padded to f32 outside the timed call (TF32 off).  Checked within 1 of the plain
    version's first band (its rounding is not the reference's).  -> the
    call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref

    x = planes.float()[:, None].contiguous()
    N, H, W = planes.shape
    if kind == "grid_sample":
        yy, xx = torch.meshgrid(torch.arange(H, device=planes.device),
                                torch.arange(W, device=planes.device), indexing="ij")
        s = chain[0]
        if s.op == "warp_affine":
            sy, sx = ref.affine_coords(s.static, yy, xx)
        else:
            sx, sy = s.weights
        grid = torch.stack([sx / (W - 1) * 2 - 1, sy / (H - 1) * 2 - 1], dim=-1)
        grid = grid[None].expand(N, H, W, 2).contiguous()

        def call():
            return F.grid_sample(x, grid, mode="bilinear", padding_mode="border",
                                 align_corners=True)
        out = call()[:, 0]
    elif kind == "avg_pool2d":
        def call():
            return F.avg_pool2d(x, 2)
        out = call()[:, 0]
    elif kind == "conv_transpose2d":
        # pyrUp: the plane edge-padded by one, transposed-convolved at stride
        # 2 with 4 k (x) k (k the 5-tap [1,4,6,4,1]/16), rows and columns
        # [4, 4 + 2H) of the result
        k1 = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], device=planes.device) / 16.0
        wt = (4.0 * torch.outer(k1, k1))[None, None].contiguous()
        xp = ref.pad_replicate(x, 1, 1).contiguous()

        def call():
            return F.conv_transpose2d(xp, wt, stride=2)
        out = call()[:, 0, 4:4 + 2 * H, 4:4 + 2 * W]
    else:  # conv2d: the filter2D taps, or the (2, 1, 3, 3) Sobel pair
        if chain[0].op == "filter2d":
            wt = chain[0].weights[0].to(planes.device)[None, None].contiguous()
        else:
            wt = torch.tensor([[[[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]]],
                               [[[-1.0, -2.0, -1.0], [0.0, 0.0, 0.0], [1.0, 2.0, 1.0]]]],
                              device=planes.device)
        h = wt.shape[-1] // 2
        xp = ref.pad_replicate(x, h, h).contiguous()

        def call():
            return F.conv2d(xp, wt)
        out = call()[:, 0]
    diff = float((out - want[0].float()).abs().max())
    check(diff <= 1.0, f"library call {kind} differs from the plain version by {diff}")
    return call


def geometric_phase(dev, card: str, max_err: dict, path_counts: dict, results: dict) -> None:
    """The geometric path (the sixth slice): the image-op shapes of
    `geometric_cases` in every mode (`check_modes`); `run_warp` of
    `scripts/torch_pipeline_bench.py` (the warp -> ladder chain fused in
    every mode that fits against 8 staged launches, with its checks and
    walls); `features.align_and_detect` on the benchmark's plane against a
    `mode="ref"` run on the card, keypoints equal but at counted near-ties;
    then each shape's kernel times (the kernel `mode=None` takes and the
    other one, CUDA-event means), plain time, bound and library call."""
    import torch
    from repro_torch.cv import features, imgproc
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.kernels import counters, ops, ref, stencil

    cases = geometric_cases(dev, imgproc, ops, stencil, ImageStream)
    timed = []
    for case in cases:
        want, planes, resolved = check_modes(case, counters, stencil, ref, path_counts, max_err)
        results["checks"][f"geometric {case['name']}"] = {"resolved": resolved, "max_abs_err": 0.0}
        if " 4K " in case["name"] or " 1080p " in case["name"]:
            timed.append((case, want, planes, resolved))

    # -- run_warp, by the benchmark -------------------------------------------
    bench = load_bench()
    row, rec = bench.run_warp(dev)
    path_counts.update(rec.paths)
    for k, e in rec.max_err.items():
        max_err[k] = max(max_err[k], e)
    walls = "; ".join(f"{k} {v * 1e3:.4f} ms" for k, v in row.items()
                      if k.endswith("_s") and not k.endswith("median_s"))
    print(f"check warp chain {row['image']} f32 (halo {row['halo']}): one launch in each mode that "
          f"fits, every band bit-identical to the plain version; staged "
          f"{row['pallas_calls_staged']} launches {snap_nonzero(rec.paths['warp staged'])}; fused "
          f"interior equals staged: {row['interior_bitexact']}")
    print(f"time warp chain (host wall, best of {bench.RUNS}): {walls}; best mode "
          f"{row['fused_mode']}; fused_speedup={row['fused_speedup']:.3f}; device (graph replay): "
          + " ".join(f"{k} {v:.5f}" for k, v in row.items() if k.endswith("_graph_ms"))
          + f" ms card={card}")

    # -- align_and_detect on the benchmark's plane ----------------------------
    plane = ImageStream().image((512, 512), channels=1, seed=0).to(dev).float()[None]
    M = bench.warp_matrix()
    chain = features.aligned_octave_chain(M, (512, 512), n_scales=bench.N_SCALES)
    a_res = stencil.resolve_mode(chain, (1, 512, 512), plane.dtype)
    a_kernel = "stencil_chain" if a_res == "window" else "stencil_stream"
    det, snap = counted(counters, lambda: features.align_and_detect(plane, M, max_kp=64))
    expect_counts("align_and_detect", snap, {a_kernel: 1})
    path_counts["align_and_detect"] = snap
    want = features.align_and_detect(plane, M, max_kp=64, mode="ref")
    torch.cuda.synchronize()
    check(torch.equal(det["gray"], want["gray"]), "align_and_detect: warped gray differs")
    off = ((det["xy"] != want["xy"]).any(-1) | (det["scale"] != want["scale"]))[0]
    resp = want["resp"][0]
    ulp = torch.nextafter(resp.abs(), torch.full_like(resp, math.inf)) - resp.abs()
    gap = torch.minimum(torch.cat([resp[:-1] - resp[1:], resp[-1:]]),
                       torch.cat([resp[:1], resp[:-1] - resp[1:]]))
    near = gap <= 4 * ulp
    n_off = int(off.sum())
    check(bool((near[off]).all()), "align_and_detect: a keypoint differs off a near-tie")
    print(f"check align_and_detect 512x512 f32 ({a_kernel}, {a_res}): one launch, "
          f"{int(det['valid'].sum())} valid keypoints; {n_off} of {off.numel()} differ from the "
          f"mode='ref' run, each at a near-tie (resp within 4 ulp of a neighbour; "
          f"{int(near.sum())} near-ties in all)")
    results["geometric"] = {"warp_bench": row, "align_and_detect": {
        "resolved": a_res, "keypoints_differing": n_off, "near_ties": int(near.sum())}}

    # -- times ----------------------------------------------------------------
    times = {}
    g = plane[0]
    timed.append(({"name": "warp chain 512x512 f32", "chain": chain, "plain": True},
                  as_tuple(stencil.fused_chain(g, chain, mode="ref")), ref.to_planes(g),
                  stencil.resolve_mode(chain, (1, 512, 512), g.dtype)))
    for case, want, planes, resolved in timed:
        name = case["name"]
        t = times[name] = time_image_case(case, planes, resolved, want)
        print(f"time {name}: ms={t['ms']:.5f} ({resolved}) stream_ms={t['stream_ms']:.5f} "
              f"({'tiled2d' if t['stream_tiled'] else 'streaming'}) window_ms={t['window_ms']:.5f} "
              f"plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']} ({t['library']}) "
              f"bound_ms={t['bound_ms']:.5f} ({t['bound_by']}; {t['bytes']} B, {t['flops']} FLOP) "
              f"card={card}")
    results["geometric"]["times"] = times


def level_cases(dev, ops, stencil, ImageStream) -> list:
    """The seventh slice's shapes: `ops.pyr_up` at 1080p and 4K u8 (outputs
    2160x3840 and 4320x7680, `conv_transpose2d` as the library call), and
    the chains with a resolution change before their last stage, pyrDown ->
    pyrUp, gaussian(5) -> pyrDown -> erode(1), resize2 -> gaussian(3) and
    pyrUp -> gaussian(3), at 1080p u8 and again at 1081x1919 u8 and 37x53
    f32 with several window tiles, column tiles and row segments, where a
    frame or phase off by one row or column shows."""
    from repro_torch.core.device import LaunchConfig

    stream = ImageStream()
    cases = []
    up = (stencil.pyr_up_stage(),)
    chains = {
        "pyr_down->pyr_up": (stencil.pyr_down_stage(), stencil.pyr_up_stage()),
        "gaussian(5)->pyr_down->erode(1)": (stencil.gaussian_stage(5), stencil.pyr_down_stage(),
                                            stencil.erode_stage(1)),
        "resize2->gaussian(3)": (stencil.resize2_stage(), stencil.gaussian_stage(3)),
        "pyr_up->gaussian(3)": (stencil.pyr_up_stage(), stencil.gaussian_stage(3)),
    }
    for res in ("1080p", "4K"):
        img = stream.image(RES[res], seed=8).to(dev)
        cases.append({"name": f"pyr_up {res} u8", "img": img, "chain": up, "plain": True,
                      "lib": "conv_transpose2d",
                      "call": lambda mode, img=img: ops.pyr_up(img, mode=mode)})
    shapes = [
        ("1080p u8", stream.image(RES["1080p"], seed=9).to(dev), None),
        ("1081x1919 u8 (16x16 tiles, 224 columns, 7 segments)",
         stream.image((1081, 1919), seed=10).to(dev),
         LaunchConfig(tile_rows=16, tile_cols=16, tile2d_cols=224, row_segments=7)),
        ("37x53 f32 (8x8 tiles, 16 columns, 3 segments)",
         stream.image((37, 53), seed=11).to(dev).float(),
         LaunchConfig(tile_rows=8, tile_cols=8, tile2d_cols=16, row_segments=3, stream_rows=4)),
    ]
    for tag, img, lc in shapes:
        kw = {} if lc is None else {"lc": lc}
        for name, chain in chains.items():
            cases.append({"name": f"{name} {tag}", "img": img, "chain": chain, "plain": False,
                          "lib": None, "call": lambda mode, img=img, chain=chain, kw=kw:
                          stencil.fused_chain(img, chain, mode=mode, **kw)})
    return cases


def blob_image(hw, dev, seed: int, cell: int = 64):
    """An (H, W) f32 image of Gaussian blobs on a dim ramp, one blob in each
    `cell` x `cell` square (sigma 1.5 to 16 pixels, centre and amplitude
    jittered, from a CPU generator at `seed`), each summed over its own and
    the neighbouring squares: structure at every octave's scale, apart
    enough that each octave of a 4-octave pyramid holds keypoints."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    h, w = hw
    ny, nx = -(-h // cell), -(-w // cell)
    p = torch.rand((ny, nx, 4), generator=gen).to(dev)
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    iy0, ix0 = (yy // cell).long(), (xx // cell).long()
    img = 20.0 + 10.0 * xx / w
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            iy, ix = iy0 + dy, ix0 + dx
            inside = ((iy >= 0) & (iy < ny) & (ix >= 0) & (ix < nx)).float()
            iy, ix = iy.clamp(0, ny - 1), ix.clamp(0, nx - 1)
            q = p[iy, ix]
            s = 1.5 + 14.5 * q[..., 0]
            cy = (iy.float() + 0.25 + 0.5 * q[..., 1]) * cell
            cx = (ix.float() + 0.25 + 0.5 * q[..., 2]) * cell
            img = img + inside * (40.0 + 80.0 * q[..., 3]) * torch.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    return img / img.max() * 255.0


def keypoints_equal_but_near_ties(what: str, got: dict, want: dict, keys) -> tuple:
    """Per image, the keypoints of `got` equal `want`'s on `keys` except
    where `want`'s response lies within 4 ulps of a neighbour's; -> (the
    keypoints differing, the near-ties)."""
    import torch

    n_off = n_near = 0
    for i in range(want["resp"].shape[0]):
        off = torch.zeros_like(want["valid"][i])
        for k in keys:
            d = got[k][i] != want[k][i]
            off |= d.any(-1) if d.ndim > 1 else d
        resp = want["resp"][i]
        ulp = torch.nextafter(resp.abs(), torch.full_like(resp, math.inf)) - resp.abs()
        gap = torch.minimum(torch.cat([resp[:-1] - resp[1:], resp[-1:]]),
                           torch.cat([resp[:1], resp[:-1] - resp[1:]]))
        near = gap <= 4 * ulp
        check(bool(near[off].all()), f"{what}: a keypoint differs off a near-tie")
        n_off, n_near = n_off + int(off.sum()), n_near + int(near.sum())
    return n_off, n_near


def pyramid_phase(dev, card: str, max_err: dict, path_counts: dict, results: dict,
                  train_set: tuple, test_imgs) -> None:
    """The multi-octave pyramid path (the seventh slice): `level_cases` in
    every mode (`check_modes`); `features.sift_pyramid` with 4 octaves (16
    keypoints an octave, 64 in all) on 512x512, 1080p and 4K gray f32
    images of Gaussian blobs at every octave's scale (`blob_image`; 4
    launches, no plain call, every band
    bit-equal to the plain version, keypoints equal to a `mode="ref"` run
    on the card but at counted near-ties); BoW `train` and `predict` with
    both heads at `PipelineConfig(preprocess=True, n_octaves=3, max_kp=32)`
    on the fourth slice's images (1 `stencil_stream` for the preprocess
    chain and 3 `stencil_chain`, one an octave: the 32, 16 and 8 pixel
    planes are no larger than the 36-pixel halo), labels identical across
    two runs and within 1% of a plain predict on the CPU; `run_pyramid` of
    the benchmark; then the times of pyr_up (both kernels, plain,
    `conv_transpose2d`, bound) and of each 1080p pyramid link."""
    import torch
    from repro_torch.cv import classify, features, pipeline
    from repro_torch.cv.config import PipelineConfig
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.kernels import counters, ops, ref, stencil

    timed = []
    for case in level_cases(dev, ops, stencil, ImageStream):
        want, planes, resolved = check_modes(case, counters, stencil, ref, path_counts, max_err)
        results["checks"][f"pyramid path {case['name']}"] = {"resolved": resolved,
                                                             "max_abs_err": 0.0}
        if case["name"].startswith("pyr_up "):
            timed.append((case, want, planes, resolved))

    # -- sift_pyramid, 4 octaves, at three sizes --------------------------------
    chains = features.pyramid_chains(4)
    pyr = {}
    for name, hw in (("512x512", (512, 512)), ("1080p", RES["1080p"]), ("4K", RES["4K"])):
        g = blob_image(hw, dev, seed=12)[None]
        plan = stencil.pyramid_plan(chains, hw)
        kernels = ["stencil_chain" if p["mode"] == "window" else "stencil_stream" for p in plan]
        launches = {k: kernels.count(k) for k in set(kernels)}
        # 16 a octave: the merge then keeps each octave's best, not only octave 0's
        det, snap = counted(counters, lambda: features.sift_pyramid(g, n_octaves=4, max_kp=64,
                                                                    kp_per_octave=16))
        expect_counts(f"sift_pyramid {name}", snap, launches)
        path_counts[f"sift_pyramid {name}"] = snap
        want = features.sift_pyramid(g, n_octaves=4, max_kp=64, kp_per_octave=16, mode="ref")
        gn = features._normalize_gray(g)[..., None]
        (outs, _), snap_b = counted(counters, lambda: stencil.chained_launches(gn, chains))
        expect_counts(f"chained_launches {name}", snap_b, launches)
        path_counts[f"chained_launches {name}"] = snap_b
        ref_outs, _ = stencil.chained_launches(gn, chains, mode="ref")
        torch.cuda.synchronize()
        for o, (a, b) in enumerate(zip(outs, ref_outs, strict=True)):
            for x, y in zip(a, b, strict=True):
                check(x.shape == y.shape and torch.equal(x, y),
                      f"sift_pyramid {name}: octave {o} band differs from the plain version")
        n_off, n_near = keypoints_equal_but_near_ties(f"sift_pyramid {name}", det, want,
                                                      ("xy", "octave", "scale", "valid"))
        per_octave = [int(((det["octave"][0] == o) & det["valid"][0]).sum()) for o in range(4)]
        print(f"check sift_pyramid {name} f32: {snap_nonzero(snap)} (links "
              f"{[p['mode'] for p in plan]}), every band bit-equal to the plain version; "
              f"{int(det['valid'].sum())} valid keypoints {per_octave} by octave; {n_off} differ "
              f"from mode='ref', each at a near-tie ({n_near} near-ties)")
        pyr[name] = {"links": plan, "launches": snap_nonzero(snap), "keypoints_differing": n_off,
                     "near_ties": n_near, "per_octave": per_octave, "g": gn, "outs": outs}

    # -- BoW train + predict at n_octaves=3, both heads --------------------------
    imgs, labels = train_set
    batches = test_imgs.split(PREDICT_BATCH)
    bow = {}
    for head in HEADS:
        cfg = PipelineConfig(preprocess=True, n_octaves=3, max_kp=32, head=head)
        model, snap = counted(counters, lambda cfg=cfg: pipeline.train(
            imgs, labels, cfg, dict_size=DICT_SIZE, generator=torch.Generator().manual_seed(0),
            device=dev))
        expect_counts(f"train {head} n_octaves=3", snap,
                      {"stencil_stream": 1, "stencil_chain": 3, "bow_assign": 21})
        path_counts[f"train {head} n_octaves=3"] = snap
        preds = []
        path = {"launches": dict.fromkeys(counters.KERNELS, 0), "plain_calls": {}}
        for i, xb in enumerate(batches):
            pb, snap = counted(counters, lambda xb=xb, cfg=cfg: pipeline.predict(
                model, xb, cfg, device=dev))
            expect_counts(f"predict {head} n_octaves=3 request {i}", snap,
                          {"stencil_stream": 1, "stencil_chain": 3, "bow_quantize_hist": 1,
                           HEAD_KERNEL[head]: 1})
            for k, v in snap["launches"].items():
                path["launches"][k] += v
            preds.append(pb)
        path_counts[f"predict {head} n_octaves=3"] = path
        pred = torch.cat(preds).cpu()
        again = torch.cat([pipeline.predict(model, xb, cfg, device=dev) for xb in batches]).cpu()
        check(torch.equal(pred, again), f"{head} n_octaves=3: labels differ between two runs")
        plan_cpu = classify.build_plan(copy.deepcopy(model).cpu(), cfg, device="cpu")
        feats = pipeline.extract_features(test_imgs, cfg, device="cpu")
        scores = plan_cpu.scores(plan_cpu.histograms(feats["desc"], feats["valid"]))
        mism = int((scores.argmax(1).to(torch.int32) != pred).sum())
        print(f"check BoW {head} n_octaves=3: train {snap_nonzero(path_counts[f'train {head} n_octaves=3'])}, "
              f"predict {len(batches)} requests {snap_nonzero(path)}; labels identical across two "
              f"runs; {mism} of {len(pred)} differ from a plain CPU predict (limit 1%)")
        check(mism <= 0.01 * len(pred), f"{head} n_octaves=3: card and CPU predictions disagree")
        bow[head] = {"mismatches_vs_cpu": mism}

    # -- run_pyramid, by the benchmark -------------------------------------------
    bench = load_bench()
    row, rec = bench.run_pyramid(dev)
    path_counts.update(rec.paths)
    for k, e in rec.max_err.items():
        max_err[k] = max(max_err[k], e)
    walls = "; ".join(f"{k} {v * 1e3:.4f} ms" for k, v in row.items()
                      if k.endswith("_s") and not k.endswith("median_s"))
    print(f"check pyramid {row['image']} f32, {row['n_octaves']} octaves (links "
          f"{row['link_modes']}): {row['pallas_calls_fused']} launches in each mode that fits, "
          f"every band bit-identical to the plain version; staged {row['pallas_calls_staged']} "
          f"launches {snap_nonzero(rec.paths['pyramid staged'])}")
    print(f"time pyramid (host wall, best of {bench.RUNS}): {walls}; best mode "
          f"{row['fused_mode']}; fused_speedup={row['fused_speedup']:.3f}; device (graph replay): "
          + " ".join(f"{k} {v:.5f}" for k, v in row.items() if k.endswith("_graph_ms"))
          + f" ms card={card}")

    # -- times ----------------------------------------------------------------
    times = {}
    for case, want, planes, resolved in timed:
        name = case["name"]
        t = times[name] = time_image_case(case, planes, resolved, want)
        print(f"time {name}: ms={t['ms']:.5f} ({resolved}) stream_ms={t['stream_ms']:.5f} "
              f"({'tiled2d' if t['stream_tiled'] else 'streaming'}) window_ms={t['window_ms']:.5f} "
              f"plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']} ({t['library']}) "
              f"bound_ms={t['bound_ms']:.5f} ({t['bound_by']}; {t['bytes']} B, {t['flops']} FLOP) "
              f"card={card}")
    links = {}
    for name, p in pyr.items():
        base = p.pop("g")  # (1, H, W, 1): the normalised gray; then each next base
        del p["outs"]
        total = {"ms": 0.0, "bytes": 0, "flops": 0.0}
        for k, (chain, link) in enumerate(zip(chains, p["links"])):
            want = as_tuple(stencil.fused_chain(base, chain, mode="ref"))
            mode = link["mode"]
            run = lambda base=base, chain=chain, mode=mode: stencil.fused_chain(  # noqa: E731
                base, chain, mode=mode)
            plain = lambda base=base, chain=chain: stencil.fused_chain(  # noqa: E731
                base, chain, mode="ref")
            ms = min(time_ms(run, iters=10), time_ms(run, iters=10))
            pms = time_ms(plain, iters=2, warmup=1)
            n_bytes = 4 * (base.numel() + sum(w.numel() for w in want))
            n_flops = base.numel() * chain_flops(chain)
            bms, by = bound_ms(n_bytes, n_flops)
            links[f"{name} link {k}"] = {"shape": link["shape"], "mode": mode, "ms": ms,
                                         "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                                         "bytes": n_bytes, "flops": n_flops}
            print(f"time sift_pyramid {name} link {k} {link['shape']} ({mode}): ms={ms:.5f} "
                  f"plain_ms={pms:.4f} bound_ms={bms:.5f} ({by}; {n_bytes} B, {n_flops} FLOP) "
                  f"card={card}")
            total["ms"] += ms
            total["bytes"] += n_bytes
            total["flops"] += n_flops
            base = want[-1]
        bms, by = bound_ms(total["bytes"], total["flops"])
        links[f"{name} all links"] = {"ms": total["ms"], "bound_ms": bms, "bound_by": by,
                                      "bytes": total["bytes"], "flops": total["flops"]}
        print(f"time sift_pyramid {name} 4 links: ms={total['ms']:.5f} bound_ms={bms:.6f} ({by}; "
              f"{total['bytes']} B) card={card}")
    results["pyramid"] = {"times": times, "links": links, "sift_pyramid": pyr, "bow": bow,
                          "bench": row}


def phase_clean(what: str) -> None:
    """Each phase ends with an empty degradation log and no fault armed (a
    rung change that was not injected fails the run), and the next starts
    with an empty mode cache."""
    from repro_torch.core import autotune, faultinject

    log = faultinject.degradation_log()
    check(not log, f"{what}: degradation events {log}")
    check(faultinject.registry() is None, f"{what}: a fault is armed")
    autotune.clear_mode_cache()


ROUTING_LADDER = ("streaming", "window")


def refused(fn) -> str:
    """The `ValueError` message of `fn()`, or "" when it did not raise one."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def resolve_us(case: dict, n: int = 2000) -> float:
    """Host microseconds a call of `stencil.resolve_mode` takes for `case`,
    as `fused_chain(mode=None)` asks it."""
    from repro_torch.kernels import ref, stencil

    img, chain = case["img"], case["chain"]
    planes, shape = ref.to_planes(img).shape, tuple(img.shape)
    stencil.resolve_mode(chain, planes, img.dtype, img_shape=shape, device=img.device)
    t0 = time.perf_counter()
    for _ in range(n):
        stencil.resolve_mode(chain, planes, img.dtype, img_shape=shape, device=img.device)
    return (time.perf_counter() - t0) / n * 1e6


def routing_phase(dev, card: str, cases: list, path_counts: dict, results: dict) -> None:
    """Measured routing (`core.autotune`): `measure_chain` with n = 3 on each
    of the 24 image-path shapes and `measure_pyramid` on the 512x512
    pyramid's 4 links, the plan table in a temporary directory; then
    ``fused_chain(mode=None)`` / ``chained_launches(mode=None)`` must launch
    each winner's kernel (by the launch counters) with every band bit-equal
    to the winner's explicit mode, from the in-process cache and again from
    the table read back under ``REPRO_TORCH_AUTOTUNE_CACHE_READ=1``; no
    plain version is called.  Last, one injected ``lowering_error`` under the
    explicit ladder ("streaming", "window") must record exactly one event,
    injected, and launch `stencil_chain` once: the only event of the run.
    Then the benchmark's `run_small_kernel_routing`."""
    import os
    import tempfile

    import torch
    from repro_torch.core import autotune, faultinject
    from repro_torch.cv import features
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.kernels import counters, ref, stencil

    t0 = time.perf_counter()

    def kernel(mode):
        return "stencil_chain" if mode == "window" else "stencil_stream"

    g = ImageStream().image((512, 512), channels=1, seed=0).to(dev).float()[None, ..., None]
    chains = features.pyramid_chains(4)
    saved = {k: os.environ.get(k) for k in (autotune.CACHE_ENV, autotune.CACHE_READ_ENV)}
    rows, winners = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        table = os.path.join(tmp, "chain_autotune.json")
        os.environ[autotune.CACHE_ENV] = table
        os.environ.pop(autotune.CACHE_READ_ENV, None)
        autotune.clear_mode_cache()
        counters.reset()
        try:
            for case in cases:
                img, chain = case["img"], case["chain"]
                planes = ref.to_planes(img)
                fit = stencil.fit_mode(chain, planes.shape, img.dtype)
                e = autotune.measure_chain(img, chain, n=3)
                check(fit in e["times"], f"routing {case['name']}: the fit rule's {fit} not timed")
                winners[case["name"]] = e["mode"]
                rows[case["name"]] = {"fit": fit, "winner": e["mode"], "times_s": e["times"]}
                print(f"routing {case['name']}: fit rule {fit} "
                      f"{e['times'][fit] * 1e3:.5f} ms, measured winner {e['mode']} "
                      f"{e['times'][e['mode']] * 1e3:.5f} ms; "
                      + " ".join(f"{m}={t * 1e3:.5f}" for m, t in e["times"].items())
                      + f" ms card={card}")
            links = autotune.measure_pyramid(g, chains, n=3)
            base = g
            for k, (chain, e) in enumerate(zip(chains, links, strict=True)):
                planes = ref.to_planes(base)
                fit = stencil.fit_mode(chain, planes.shape, base.dtype)
                name = f"pyramid 512x512 link {k} {tuple(planes.shape[1:])}"
                rows[name] = {"fit": fit, "winner": e["mode"], "times_s": e["times"]}
                print(f"routing {name}: fit rule {fit} "
                      + (f"{e['times'][fit] * 1e3:.5f} ms" if fit in e["times"] else "(not timed)")
                      + f", measured winner {e['mode']} {e['times'][e['mode']] * 1e3:.5f} ms; "
                      + " ".join(f"{m}={t * 1e3:.5f}" for m, t in e["times"].items())
                      + f" ms card={card}")
                base = stencil.fused_chain(base, chain, mode=e["mode"])[-1]
            snap = counters.snapshot()
            check(not any(snap["plain_calls"].values()), f"measure: plain calls {snap}")
            check(len(json.loads(Path(table).read_text())) == len(cases) + len(chains),
                  "routing: the plan table does not hold every measurement")

            def route(tag):
                for case in cases:
                    img, chain, w = case["img"], case["chain"], winners[case["name"]]
                    got, snap = counted(counters, lambda: stencil.fused_chain(img, chain))
                    expect_counts(f"routing {tag} {case['name']} mode=None", snap, {kernel(w): 1})
                    want = stencil.fused_chain(img, chain, mode=w)
                    torch.cuda.synchronize()
                    check(all(torch.equal(a, b) for a, b in zip(as_tuple(got), as_tuple(want),
                                                              strict=True)),
                          f"routing {tag} {case['name']}: mode None differs from {w}")
                    path_counts[f"routing {tag} {case['name']}"] = snap
                kernels = [kernel(e["mode"]) for e in links]
                (outs, _), snap = counted(counters, lambda: stencil.chained_launches(g, chains))
                expect_counts(f"routing {tag} pyramid mode=None", snap,
                              {k: kernels.count(k) for k in set(kernels)})
                path_counts[f"routing {tag} pyramid"] = snap
                base = g
                for k, (chain, e) in enumerate(zip(chains, links, strict=True)):
                    want = as_tuple(stencil.fused_chain(base, chain, mode=e["mode"]))
                    torch.cuda.synchronize()
                    bands = want if k == len(chains) - 1 else want[:-1]  # less the carry
                    check(len(outs[k]) == len(bands) and all(
                        torch.equal(a, b) for a, b in zip(outs[k], bands)),
                          f"routing {tag} pyramid link {k}: differs from {e['mode']}")
                    base = want[-1]

            route("measured")
            wins = sum(r["winner"] == "window" for n, r in rows.items() if "link" not in n)
            lookup_us = {"hit": resolve_us(cases[0])}
            # the table read back routes the same way
            autotune.clear_mode_cache()
            os.environ[autotune.CACHE_READ_ENV] = "1"
            for case in cases:
                hit = autotune.cached_chain_mode(case["chain"], case["img"].shape,
                                                 case["img"].dtype, device=dev)
                check(hit == winners[case["name"]], f"read back {case['name']}: {hit}")
            route("read back")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            autotune.clear_mode_cache()

    lookup_us["nothing measured"] = resolve_us(cases[0])
    print("time resolve_mode (mode=None's lookup, host) per call: "
          + ", ".join(f"{k} {v:.3f} us" for k, v in lookup_us.items()) + f" card={card}")

    # one injected rung change under an explicit ladder: the run's only event
    case = next(c for c in cases if c["name"].startswith("acceptance"))
    # the plain version is never a rung on the card: a ladder that moves to
    # it, or a process-default mode "ref", raises before anything runs
    counters.reset()
    prev = stencil.set_default_chain_mode("ref")
    try:
        refusals = [refused(lambda: stencil.fused_chain(case["img"], case["chain"]))]
    finally:
        stencil.set_default_chain_mode(prev)
    refusals.append(refused(lambda: stencil.fused_chain(case["img"], case["chain"], mode="window",
                                                        ladder=("window", "ref"))))
    snap = counters.snapshot()
    check(all(refusals), f"'ref' on the card: not refused ({refusals})")
    check(not any(snap["launches"].values()) and not any(snap["plain_calls"].values()),
          f"'ref' on the card: something ran before the refusal {snap}")
    print(f"check 'ref' on the card: default mode refused ({refusals[0]}); ladder refused "
          f"({refusals[1]}); nothing launched")
    check(stencil.fit_mode(case["chain"], ref.to_planes(case["img"]).shape,
                           case["img"].dtype) == "streaming", "the acceptance chain must stream")
    with faultinject.inject("lowering_error:count=1"):
        got, snap = counted(counters, lambda: stencil.fused_chain(
            case["img"], case["chain"], mode="streaming", ladder=ROUTING_LADDER))
    expect_counts("injected lowering_error under the ladder", snap, {"stencil_chain": 1})
    path_counts["routing injected lowering_error"] = snap
    check(torch.equal(got, stencil.fused_chain(case["img"], case["chain"], mode="window")),
          "the ladder's window rung differs from mode window")
    log = faultinject.degradation_log()
    check(len(log) == 1 and log[0].injected and (log[0].from_plan, log[0].to_plan)
          == ROUTING_LADDER, f"injected lowering_error: events {log}")
    print(f"check injected lowering_error under ladder {ROUTING_LADDER}: one event "
          f"({log[0].stage}: {log[0].from_plan} -> {log[0].to_plan}, injected, {log[0].reason}), "
          f"{snap_nonzero(snap)}")
    faultinject.clear_degradation_log()  # the one event the run allows

    # the benchmark's own routing check (3x3 filter2D, erode r = 3)
    bench_rows, rec = load_bench().run_small_kernel_routing(dev)
    path_counts.update(rec.paths)
    for r in bench_rows:
        times = " ".join(f"{k}={v * 1e3:.5f}" for k, v in r.items() if k.endswith("_s"))
        print(f"check run_small_kernel_routing {r['case']} ({r['batch']} u8): mode None launched "
              f"the measured winner {r['routed_mode']} once, bit-equal; ms: {times} card={card}")
    autotune.clear_mode_cache()
    n_img = len(cases)
    wall = time.perf_counter() - t0
    print(f"routing: the window kernel measured fastest on {wins} of {n_img} image-path shapes "
          f"(the fit rule picks it on "
          f"{sum(r['fit'] == 'window' for n, r in rows.items() if 'link' not in n)}); "
          f"mode None launched every winner, bit-equal, from the cache and from the table read "
          f"back; phase wall {wall:.2f} s card={card}")
    results["routing"] = {"rows": rows, "window_wins": wins, "wall_s": wall,
                          "resolve_us": lookup_us,
                          "small_kernel_routing": bench_rows,
                          "event": {f: getattr(log[0], f) for f in
                                    ("stage", "from_plan", "to_plan", "reason", "injected")}}


SERVE_SEED = 25
SERVE_SIDES = (24, 256)  # frame sides drawn from this range (inclusive)


def serve_workload(n_rgb: int = 384, n_gray: int = 124, n_big: int = 2, bad: bool = True,
                   seed: int = SERVE_SEED, sides: tuple = SERVE_SIDES) -> list:
    """The serving phase's requests, made on the host from a seed: crops of
    `ImageStream` images as u8 RGB frames and as f32 gray frames (sides drawn
    from `SERVE_SIDES`), frames of 320x320 (larger than every bucket: the
    exact-shape path), then one frame of bad rank and one of bad dtype."""
    import numpy as np
    from repro_torch.data.synthetic import ImageStream

    n_src = 64
    src = ImageStream(res=sides[1]).batch(n_src, split=seed)[0].numpy()
    big = ImageStream(res=320).batch(max(n_big, 1), split=seed + 1)[0].numpy()
    rng = np.random.default_rng(seed)
    work = []
    for i in range(n_rgb + n_gray):
        h, w = (int(v) for v in rng.integers(sides[0], sides[1] + 1, 2))
        y0, x0 = int(rng.integers(0, sides[1] - h + 1)), int(rng.integers(0, sides[1] - w + 1))
        crop = src[i % n_src, y0:y0 + h, x0:x0 + w]
        work.append(np.ascontiguousarray(crop) if i < n_rgb
                    else crop.astype(np.float32).mean(axis=-1))
    work += [big[i] for i in range(n_big)]
    if bad:
        work += [np.zeros((8, 8, 2), np.uint8), np.zeros((32, 32), np.int32)]
    return work


def served_batches(work: list, res: list, max_batch: int) -> list:
    """The request indices of each batch the engine ran, in its order:
    admitted requests grouped by (bucket, canonical shape, dtype) in order of
    first appearance, each group split by `max_batch` (`CvEngine.submit`)."""
    groups = {}
    for i, r in enumerate(res):
        if r.ok:
            shape = tuple(r.bucket) + work[i].shape[2:]
            groups.setdefault((tuple(r.bucket), shape, str(work[i].dtype)), []).append(i)
    return [idx[lo:lo + max_batch] for idx in groups.values()
            for lo in range(0, len(idx), max_batch)]


def serve_phase(dev, card: str, cfgs: dict, models: dict, path_counts: dict,
                results: dict) -> None:
    """The CV serving engine (`serve.cv_engine.CvEngine`) on the card at full
    width: the default buckets 32², 64², 128², 256², ``max_batch=64``,
    phase 3's `PipelineConfig(preprocess=True, max_kp=32)` and models (K =
    250).  Extract: 512 requests (`serve_workload`: 384 u8 RGB and 124 f32
    gray frames of sides 24-256, two of 320x320, one of bad rank, one of bad
    dtype): every well-formed request served with no retry, the two
    malformed ones refused; each batch on "streaming", or, where the
    streaming rung cannot plan it (the f32 octave's full-width rings over a
    block's shared memory: the 256² bucket and the 320² frames), on
    "tiled2d" after one recorded move; no other rung change (the log holds
    those moves and the two "frame larger than every bucket" events);
    `stencil_stream` twice a batch (three where the octave's streaming plan
    refused after the preprocess chain ran) and no plain version;
    descriptors bit-equal to `extract_features` on the captured batches at
    each batch's rung, and keypoints equal to an explicit mode "ref" run on
    the card but at counted near-ties (the descriptors of every image whose
    keypoints are equal bit-equal).  Classify, both heads: predictions
    equal to `pipeline.predict` on the captured batches at the same rung,
    `bow_quantize_hist` and the head's kernel once a batch.  Faults, one spec at a time: ``lowering_error``
    (``max_retries=0``: one injected event streaming -> tiled2d, that batch
    bit-equal to a mode "tiled2d" run), ``nan_input`` (one sanitized event),
    ``bucket_miss`` (one exact-shape batch), ``measure_timeout`` on
    ``warm((32, 32))`` (None, one event), ``shard_oom`` and ``device_loss``
    through a `ShardDispatcher(devices=["v0", "v1"])` on the card (outputs
    equal to the fault-free run); each gives exactly its expected events.
    Then a ladder to "ref" on the card must raise before any launch, and
    the times: a 512-request `submit` (host wall, best of 3 after a warm
    one), requests a second, each bucket's mean batch latency, and
    `erode_vanherk` against `ops.erode` at 1080p u8, r = 1-3."""
    import numpy as np
    import torch
    from repro_torch.core import faultinject
    from repro_torch.cv import features, imgproc, pipeline
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.kernels import counters, ops
    from repro_torch.kernels.stencil import exec_streaming
    from repro_torch.serve.cv_engine import CvEngine
    from repro_torch.serve.shard_dispatch import ShardDispatcher

    cfg = cfgs["svm"]
    mb = 64
    out = {}
    work = serve_workload()
    n_ok, n_big = len(work) - 2, 2
    octave = features.octave_chain(with_next_base=False)

    def engine(model=None, head: str = "svm", **kw):
        return CvEngine(model, config=cfgs[head], max_batch=mb, device=dev, **kw)

    def events(*, expected: int, what: str) -> list:
        log = faultinject.degradation_log()
        check(len(log) == expected, f"serve {what}: {len(log)} events, expected {expected}: {log}")
        faultinject.clear_degradation_log()
        return log

    def sift_at(batch, mode: str) -> dict:
        """`extract_features` at `mode`, with the detector's keypoints."""
        x = torch.as_tensor(batch).to(dev).float()
        c = cfg.replace(mode=mode)
        if x.ndim == 3:
            x = imgproc.preprocess_bow(x[..., None], mode=mode)[..., 0]
        else:
            x = imgproc.preprocess_bow(x, mode=mode)
        return features.sift(x, c)

    # -- extract -----------------------------------------------------------------
    eng = engine(capture_frames=True)
    check(eng.ladder == ("streaming", "tiled2d", "window"), f"serve: ladder {eng.ladder}")
    faultinject.clear_degradation_log()
    prog, _ = exec_streaming.program(octave, cfg.lc.stream_rows, torch.float32,
                                     torch.device("cpu"))

    def over_budget(batches, captured) -> list:
        """Per batch: does the streaming rung refuse it (the octave's
        full-width rings over a block's shared memory, by the planner's own
        figures)?"""
        return [prog.layout.smem_bytes(b.shape[2]) + prog.table_smem > cfg.lc.smem_budget
                for _, b in captured]

    def check_rungs(what, res, batches, over) -> None:
        """Each batch on streaming with no retry, or, where the streaming rung
        cannot plan it, on tiled2d after one recorded move; the degradation
        log holds those moves and the oversized frames' events, no other."""
        for idx, o in zip(batches, over, strict=True):
            want = ("tiled2d", True) if o else ("streaming", False)
            check(all((res[i].plan, res[i].degraded) == want and res[i].retries == 0 for i in idx),
                  f"serve {what}: a batch of {len(idx)} not served on {want[0]}")
        log = events(expected=sum(over) + n_big, what=what)
        moves = [e for e in log if e.from_plan == "streaming"]
        check(len(moves) == sum(over) and all(
            e.to_plan == "tiled2d" and e.reason.startswith("rung cannot plan this batch")
            and not e.injected for e in moves), f"serve {what}: events {log}")
        check(sum(e.reason == "frame larger than every bucket" for e in log) == n_big,
              f"serve {what}: events {log}")

    res, snap = counted(counters, lambda: eng.extract(work))
    torch.cuda.synchronize()
    batches = served_batches(work, res, mb)
    check(len(batches) == len(eng.captured), "serve: batch bookkeeping differs from the engine's")
    check(sum(r.ok for r in res) == n_ok, f"serve: {sum(r.ok for r in res)} of {n_ok} served")
    check([r.error.split(":")[0] for r in res[-2:]] == ["bad_rank", "bad_dtype"],
          f"serve: malformed frames {[r.error for r in res[-2:]]}")
    over = over_budget(batches, eng.captured)
    check_rungs("extract", res, batches, over)
    # a batch the streaming rung refuses has launched its preprocess chain
    # at streaming before the octave's plan refused: 3 launches, not 2
    expect_counts("serve extract", snap, {"stencil_stream": 2 * len(batches) + sum(over)})
    path_counts["serve extract"] = snap
    n_off = n_near = n_kp = 0
    for (bucket, b), idx, o in zip(eng.captured, batches, over, strict=True):
        rung = "tiled2d" if o else "streaming"
        want = pipeline.extract_features(b, cfg.replace(mode=rung), device=dev, validate=False)
        det = sift_at(b, rung)
        ref_det = sift_at(b, "ref")
        wd, wv = want["desc"].cpu().numpy(), want["valid"].cpu().numpy()
        for k, i in enumerate(idx):
            check(np.array_equal(res[i].desc, wd[k]) and np.array_equal(res[i].valid, wv[k]),
                  f"serve: request {i} differs from extract_features at mode {rung}")
        check(torch.equal(det["desc"], want["desc"]), "serve: sift_at differs from extract_features")
        off, near = keypoints_equal_but_near_ties(f"serve {bucket}", det, ref_det, ("xy", "valid"))
        n_off, n_near, n_kp = n_off + off, n_near + near, n_kp + int(det["valid"].sum())
        same = [j for j in range(len(idx)) if torch.equal(det["xy"][j], ref_det["xy"][j])
                and torch.equal(det["valid"][j], ref_det["valid"][j])]
        check(all(torch.equal(det["desc"][j], ref_det["desc"][j]) for j in same),
              f"serve {bucket}: descriptors differ from mode ref at equal keypoints")
    per_bucket = collections.Counter(tuple(b) for b, _ in eng.captured)
    n_tiled = sum(len(idx) for idx, o in zip(batches, over) if o)
    print(f"check serve extract: {len(work)} requests, {n_ok} served with no retry, "
          f"{n_ok - n_tiled} on streaming, {n_tiled} in {sum(over)} batches on tiled2d (the "
          f"streaming rung cannot plan them: full-width rings over the shared memory), 2 refused; "
          f"{len(batches)} batches {dict(per_bucket)}; {snap_nonzero(snap)}; descriptors "
          f"bit-equal to extract_features at each batch's rung; {n_kp} keypoints, {n_off} differ "
          f"from mode='ref' on the card, each at a near-tie ({n_near} near-ties)")
    out["extract"] = {"batches": len(batches), "per_bucket": {str(k): v for k, v in per_bucket.items()},
                      "batches_on_tiled2d": sum(over), "requests_on_tiled2d": n_tiled,
                      "launches": snap_nonzero(snap), "keypoints": n_kp,
                      "keypoints_differing": n_off, "near_ties": n_near}
    extract_res = res

    # -- classify, both heads -------------------------------------------------------
    good = work[:-2]
    for head in HEADS:
        ceng = engine(models[head], head, capture_frames=True)
        res, snap = counted(counters, lambda ceng=ceng: ceng.classify(good))
        torch.cuda.synchronize()
        batches = served_batches(good, res, mb)
        n = len(batches)
        check(all(r.ok for r in res), f"serve classify {head}: a request failed")
        cover = over_budget(batches, ceng.captured)
        check_rungs(f"classify {head}", res, batches, cover)
        expect_counts(f"serve classify {head}", snap,
                      {"stencil_stream": 2 * n + sum(cover), "bow_quantize_hist": n,
                       HEAD_KERNEL[head]: n})
        path_counts[f"serve classify {head}"] = snap
        for (_, b), idx, o in zip(ceng.captured, batches, cover, strict=True):
            c = cfgs[head].replace(mode="tiled2d" if o else "streaming", classify_mode="fused")
            want = pipeline.predict(models[head], b, c, device=dev, validate=False).cpu()
            check([res[i].pred for i in idx] == want.tolist(),
                  f"serve classify {head}: predictions differ from pipeline.predict")
        labels = collections.Counter(r.pred for r in res)
        print(f"check serve classify {head}: {len(good)} requests in {n} batches, {snap_nonzero(snap)}; "
              f"predictions equal to pipeline.predict at each batch's rung; labels {dict(labels)}")
        out[f"classify {head}"] = {"batches": n, "launches": snap_nonzero(snap)}

    # -- faults on the card, one spec at a time -------------------------------------------
    # sides up to 128 (buckets to 128², where the streaming rung plans every
    # batch), so each event is the fault's
    fwork = serve_workload(n_rgb=48, n_gray=16, n_big=0, bad=False, seed=SERVE_SEED + 7,
                           sides=(24, 128))
    base = engine().extract(fwork)
    faultinject.clear_degradation_log()

    feng = engine(max_retries=0, capture_frames=True)
    with faultinject.inject("lowering_error:count=1"):
        res = feng.extract(fwork)
    (ev,) = events(expected=1, what="lowering_error")
    check((ev.stage, ev.from_plan, ev.to_plan, ev.injected) == ("serve", "streaming", "tiled2d", True),
          f"serve lowering_error: event {ev}")
    batches = served_batches(fwork, res, mb)
    (_, b0), idx0 = feng.captured[0], batches[0]
    want = pipeline.extract_features(b0, cfg.replace(mode="tiled2d"), device=dev, validate=False)
    check(all(res[i].plan == "tiled2d" and res[i].degraded for i in idx0)
          and all(r.plan == "streaming" for i, r in enumerate(res) if i not in idx0),
          "serve lowering_error: plans")
    wd = want["desc"].cpu().numpy()
    check(all(np.array_equal(res[i].desc, wd[k]) for k, i in enumerate(idx0)),
          "serve lowering_error: the degraded batch differs from mode tiled2d")
    print(f"check serve lowering_error:count=1: one injected event streaming -> tiled2d; its batch "
          f"of {len(idx0)} bit-equal to mode tiled2d, the rest on streaming")

    with faultinject.inject("nan_input:count=1"):
        res = engine().extract(fwork)
    (ev,) = events(expected=1, what="nan_input")
    first_f32 = next(i for i, f in enumerate(fwork) if f.dtype == np.float32)
    check(ev.to_plan == "sanitized" and ev.injected and ev.detail == f"request {first_f32}"
          and res[first_f32].ok and res[first_f32].events == [ev] and all(r.ok for r in res),
          f"serve nan_input: {ev}")
    print(f"check serve nan_input:count=1: request {first_f32} (f32) sanitized with one event, "
          "all served")

    with faultinject.inject("bucket_miss:count=1"):
        res = engine().extract(fwork)
    (ev,) = events(expected=1, what="bucket_miss")
    h, w = fwork[0].shape[:2]
    check(ev.to_plan == "exact-shape" and ev.injected and res[0].bucket == (h, w)
          and all(r.ok and r.plan == "streaming" for r in res),
          f"serve bucket_miss: {ev}, bucket {res[0].bucket}")
    print(f"check serve bucket_miss:count=1: request 0 served at its exact shape {h}x{w}")

    weng = engine()
    with faultinject.inject("measure_timeout:count=1"):
        table = weng.warm((32, 32))
    (ev,) = events(expected=1, what="measure_timeout")
    check(table is None and ev.to_plan == "heuristic" and ev.injected, f"serve warm: {ev}")
    print("check serve measure_timeout:count=1: warm((32, 32)) -> None with one event")

    # two batches (buckets 64² and 128²), so the lost device stays quarantined throughout
    src = ImageStream(res=128).batch(32, split=SERVE_SEED + 8)[0].numpy()
    dwork = [src[i, :48, :60] for i in range(16)] + [src[i, :100, :128] for i in range(16, 32)]
    local = engine().extract(dwork)
    faultinject.clear_degradation_log()
    for spec, want_ev in (("shard_oom:count=1", [("dispatch", "streaming", "tiled2d")]),
                          ("device_loss:count=1", [("health", "healthy", "quarantined"),
                                                   ("dispatch", "v0", "v1")])):
        disp = ShardDispatcher(devices=["v0", "v1"], device=dev)
        deng = engine(dispatcher=disp)
        with faultinject.inject(spec):
            res = deng.extract(dwork)
        log = events(expected=len(want_ev), what=spec)
        check([(e.stage, e.from_plan, e.to_plan) for e in log] == want_ev
              and all(e.injected for e in log), f"serve {spec}: events {log}")
        check(all(r.ok for r in res) and all(np.array_equal(a.desc, b.desc)
                                             and np.array_equal(a.valid, b.valid)
                                             for a, b in zip(res, local)),
              f"serve {spec}: outputs differ from the fault-free run")
        print(f"check serve {spec} (virtual devices v0, v1 on the card): {len(res)} requests in "
              f"{deng.stats['sharded_batches']} sharded batches, events "
              f"{[(e.stage, e.from_plan, e.to_plan) for e in log]}, outputs equal to the "
              f"fault-free run; dispatcher {disp.stats}")

    counters.reset()
    msg = refused(lambda: CvEngine(ladder=("window", "ref"), device=dev))
    check("plain version" in msg and not any(counters.LAUNCHES.values()),
          f"serve: a ladder to ref on the card was not refused before any launch ({msg!r})")
    print(f"check serve refusal: CvEngine(ladder=('window', 'ref')) on the card -> ValueError "
          f"({msg[:60]}...), nothing launched")

    # -- times ---------------------------------------------------------------------
    teng = engine()
    teng.extract(work)  # warm
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = teng.extract(work)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    faultinject.clear_degradation_log()
    lat = collections.defaultdict(set)
    for r in res:
        if r.ok:
            lat[tuple(r.bucket)].add(r.latency_s)
    per_bucket = {f"{b[0]}x{b[1]}": 1e3 * sum(v) / len(v) for b, v in sorted(lat.items())}
    best = min(walls)
    print(f"time serve extract, {len(work)} requests (host wall, best of 3 after a warm one): "
          f"{best:.4f} s ({walls}); {len(work) / best:.1f} requests/s; mean batch latency ms "
          + ", ".join(f"{k} {v:.3f}" for k, v in per_bucket.items()) + f" card={card}")
    out["times"] = {"submit_s": walls, "requests_per_s": len(work) / best,
                    "batch_latency_ms": per_bucket}
    hd = RES["1080p"]
    x = torch.randint(0, 256, hd, dtype=torch.uint8, generator=torch.Generator().manual_seed(3)).to(dev)
    vh = {}
    for r in (1, 2, 3):
        check(torch.equal(imgproc.erode_vanherk(x, r), ops.erode(x, r)),
              f"erode_vanherk r={r} differs from ops.erode")
        t_vh = time_ms(lambda r=r: imgproc.erode_vanherk(x, r), iters=20)
        t_er = time_ms(lambda r=r: ops.erode(x, r), iters=20)
        vh[r] = {"vanherk_ms": t_vh, "erode_ms": t_er}
        print(f"time erode 1080p u8 r={r}: erode_vanherk (plain PyTorch) ms={t_vh:.5f}, ops.erode "
              f"(mode None) ms={t_er:.5f}, equal; card={card}")
    out["vanherk"] = vh
    results["serve"] = out


def snap_nonzero(snap: dict) -> dict:
    return {k: v for k, v in snap["launches"].items() if v}


def flash_bound(q, k, causal: bool = True, v_dim: int | None = None) -> dict:
    """The least time one flash-attention call could take on the card: q, k,
    v read once and o written once, over the memory rate; or its operations
    over the rate of the units that do them, counting 2 FLOP per (query, key,
    channel) of a product over the (query, key) pairs the mask keeps.  In f16
    / bf16 q.k and two 16-bit p.v passes (p_hi.v + p_lo.v) run on the tensor
    cores; in f32 both products run as f32 FMAs.  v and o have `v_dim`
    channels (None: q's head dim; MLA: 128 against q's 192, the zero channels
    the call pads v with being no work of the function).  `bound_ms_f32_pv`
    is the earlier price of the same call, kept for comparison: q.k at the
    tensor-core rate, one p.v at the f32 rate."""
    import torch

    B, S, H, hd = q.shape
    T, G = k.shape[1], k.shape[2]
    hdv = v_dim or hd
    pairs = sum(min(i + 1, T) for i in range(S)) if causal else S * T
    qk, pv = 2 * B * H * hd * pairs, 2 * B * H * hdv * pairs
    n_bytes = q.element_size() * (q.numel() + k.numel() + B * T * G * hdv + B * S * H * hdv)
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    if q.dtype == torch.float32:
        flops, rate, qk_rate = qk + pv, PEAK_FP32_FLOPS, PEAK_FP32_FLOPS
    else:
        flops, rate, qk_rate = qk + 2 * pv, PEAK_BF16_FLOPS, PEAK_BF16_FLOPS
    t_ops = flops / rate * 1e3
    t_f32_pv = (qk / qk_rate + pv / PEAK_FP32_FLOPS) * 1e3
    return {"bytes": n_bytes, "flops": flops, "flops_one_pv": qk + pv,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_ms_f32_pv": max(t_bytes, t_f32_pv),
            "bound_ms_all_f32": max(t_bytes, (qk + pv) / PEAK_FP32_FLOPS * 1e3)}


# each block kind's calls of `models.attention.attention`, in order
CALLS = {"enc": ("bidirectional self-attention",), "xattn": ("cross-attention",),
         "dec": ("self-attention", "cross-attention")}


def walk_prefill(model, tokens, *, context=None, mode=None, visit=None, metrics=None):
    """The prefill's layers over `tokens` (`lm.prefill`'s loop: an
    encoder-decoder's encoder over ``context["audio_frames"]`` first, its
    blocks one by one; Zamba's shared block after every run of layers) ->
    the final-normed hidden states at every position, (B, S, D).  `context`
    holds a cross-attention arch's context input (`configs.extra_inputs`).
    `visit(i, what, q, k, v, causal)` sees the i-th attention application,
    before it runs, with the tensors `models.attention.attention` gets there
    (MLA's v padded as `mla_attn` pads it): every self-attention layer,
    every encoder layer, each cross-attention (an ``xattn`` layer's one, a
    ``dec`` layer's second, `CALLS`) and each shared-block application;
    `what` names it (``layer 3 (dec) cross-attention``, ``encoder layer 0
    (enc) bidirectional self-attention``, ``shared application 2 (attn)
    self-attention``).  The state layers (Mamba2, xLSTM) have none.  The
    list `metrics` receives each MoE layer's metrics (``moe_drop_frac``,
    ``expert_load``, ...)."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import blocks, lm
    from repro_torch.models.layers import apply_norm

    cfg = model.cfg
    norm = dict(kind=cfg.norm, eps=cfg.norm_eps, gemma_style=cfg.gemma_norm)
    route = attn_mod.attention
    at = {"i": 0, "block": None, "j": 0}

    def attend(q, k, v, **kw):
        what, kind = at["block"]
        visit(at["i"], f"{what} {CALLS.get(kind, ('self-attention',))[at['j']]}", q, k, v,
              kw.get("causal", True))
        at["i"] += 1
        at["j"] += 1
        return route(q, k, v, **kw)

    def apply(kind, p, what, h, ctx=None):
        at.update(block=(what, kind), j=0)
        h, _, m = blocks.apply_block(kind, p, h, cfg, ctx=ctx, mode=mode)
        if metrics is not None and m:
            metrics.append(m)
        return h

    if visit is not None:
        attn_mod.attention = attend
    try:
        ctx = None
        if cfg.encdec:
            hc = context["audio_frames"].to(model.embed.dtype)
            for n, p in enumerate(model.encoder["blocks"]):
                hc = apply("enc", p, f"encoder layer {n} (enc)", hc)
            ctx = apply_norm(hc, model.encoder["final_norm"], **norm)
        elif lm.context_input(cfg):
            ctx = context["image_embeds"].to(model.embed.dtype)
        h = lm._embed(model, tokens)
        layer = 0
        for gi, (kind, layers) in enumerate(model.groups()):
            for p in layers:
                h = apply(kind, p, f"layer {layer} ({kind})", h, ctx)
                layer += 1
            if cfg.shared_attn_every:
                h = apply("attn", model.shared_block, f"shared application {gi} (attn)", h)
    finally:
        attn_mod.attention = route
    return apply_norm(h, model.final_norm, **norm)


def set_gates(model) -> int:
    """Set every gate of a cross-attention arch (``xattn``'s
    ``attn.gate_attn`` and ``gate_mlp``; JAX initialises them to 0, which
    makes a gated layer the identity) to `GATE` -> how many."""
    import torch

    gates = [p for name, p in model.named_parameters() if name.endswith(("gate_attn", "gate_mlp"))]
    with torch.no_grad():
        for p in gates:
            p.fill_(GATE)
    return len(gates)


def cross_applications(cfg) -> int:
    """Cross-attention layers: one `flash_attention` call each a decode step
    (``xattn``, ``dec``; decode's self-attention runs `dense_attention`)."""
    from repro_torch.models import blocks

    return sum(c for k, c in cfg.blocks if k in blocks.CONTEXT_ENTRIES)


def attention_applications(cfg) -> int:
    """`flash_attention` calls of one prefill: every attention layer (a
    ``dec`` layer's self- and cross-attention two), every encoder layer, and
    each application of Zamba's shared block (one after every run of
    layers); 0 for an arch of state layers only."""
    from repro_torch.models import blocks

    n = sum(c for k, c in cfg.blocks if k not in blocks.STATE_KINDS)
    n += sum(c for k, c in cfg.blocks if k == "dec") + cfg.n_enc_layers
    return n + (len(cfg.blocks) if cfg.shared_attn_every else 0)


def kernel_applications(cfg, seq: int) -> int:
    """The attention applications of one forward of `cfg` over `seq`
    positions from 0 (`attention_applications`) that take the flash kernel,
    by `models.attention.kernel_route`'s rules worked out on the config
    alone: the head dim (MLA's qk_nope + qk_rope, v padded to it) a multiple
    of 8 in [8, MAX_HEAD_DIM], no ``attn_scale``; self-attention (the
    encoder's over its ``min(seq, 4096)`` frames too) also no soft cap and
    no window or one that covers the sequence; MLA and cross-attention take
    neither."""
    from repro_torch.kernels.attention import MAX_HEAD_DIM
    from repro_torch.models import blocks

    if cfg.attn_scale is not None:
        return 0

    def fits(hd: int) -> bool:
        return hd % 8 == 0 and 8 <= hd <= MAX_HEAD_DIM

    def self_ok(n: int) -> bool:
        return (fits(cfg.head_dim) and cfg.attn_soft_cap is None
                and (cfg.window is None or n <= cfg.window))

    n_self = sum(c for k, c in cfg.blocks
                 if k not in blocks.STATE_KINDS + blocks.MLA_KINDS and k != "xattn")
    n_self += len(cfg.blocks) if cfg.shared_attn_every else 0
    n_mla = sum(c for k, c in cfg.blocks if k in blocks.MLA_KINDS)
    n = n_self * self_ok(seq) + cfg.n_enc_layers * self_ok(min(seq, 4096))
    n += cross_applications(cfg) * fits(cfg.head_dim)
    if n_mla:
        n += n_mla * fits(cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim)
    return n


def train_kernel_calls(cfg, seq: int) -> int:
    """`flash_attention` calls of one train step over `seq` positions: the
    forward's (`kernel_applications`) and, under remat, the layers' again
    in the backward (Zamba's shared block runs outside the remat'd layers,
    once)."""
    n = kernel_applications(cfg, seq)
    shared = n - kernel_applications(cfg.replace(shared_attn_every=0), seq)
    return n + (n - shared if cfg.remat else 0)


def decode_vs_walk(model, cfg, prompts, tokens, context=None) -> tuple[list, float]:
    """With `model`'s weights in f32 (`cfg` its f32 config): the logits of
    the prefill's last position and of each decode step fed `tokens`
    (B, n; n - 1 steps), each against the logits one full-sequence walk
    over the prompt and those tokens (`walk_prefill` plus the head, over the
    same `context`) gives at that position -> (each step's max |difference|,
    max |logit|)."""
    import torch
    from repro_torch.models import lm
    from repro_torch.serve import cv_engine

    B, S = prompts.shape
    n = tokens.shape[1]
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    with torch.inference_mode():
        lg, pc = lm.prefill(model, prompts, extras=context)
        ctx_len = lm.context_len(cfg, context, B)
        cache = cv_engine._adopt_prefill(
            lm.init_cache(cfg, B, S + n, ctx_len=ctx_len, device=prompts.device), pc, cfg)
        del pc
        steps = [lg]
        for t in range(n - 1):
            lg, cache = lm.decode_step(model, tokens[:, t : t + 1], cache)
            steps.append(lg)
        del cache
        seq = torch.cat([prompts, tokens[:, : n - 1].to(prompts.dtype)], dim=1)
        full = walk_prefill(model, seq, context=context)[:, S - 1 :] @ head
    return [float((a - full[:, i]).abs().max()) for i, a in enumerate(steps)], float(full.abs().max())


class RouteRecorder:
    """While active, records every MoE routing call (`models.moe._route`):
    its selection scores (B, S, E) and chosen experts (B, S, k)."""

    def __enter__(self):
        from repro_torch.models import moe

        self.calls, self._moe, self._route = [], moe, moe._route

        def route(p, x, m):
            out = self._route(p, x, m)
            self.calls.append((moe.selection_scores(p, x, m)[2], out[1]))
            return out

        moe._route = route
        return self

    def __exit__(self, *exc):
        self._moe._route = self._route


def judge_routes(a: list, b: list, k: int, what: str, judge=check):
    """Two runs' routing calls, in order (`RouteRecorder.calls`) -> (the
    sequences with the same choices at every call (B,) bool, near-tie
    tokens).  Top-k may choose another expert where the k-th and (k+1)-th
    scores lie closer than the runs' rounding apart, and a changed choice
    moves the slot ranks of its sequence's later tokens; so every changed
    token must be a near-tie: run b's gap between its k-th and (k+1)-th
    scores at most twice the largest score difference of the call's tokens
    whose choices agree (on sequences with no change so far), the gap
    printed.  Outputs are compared on the sequences with no change."""
    import torch

    clean, n_ties, gaps = None, 0, []
    for (sa, ia), (sb, ib) in zip(a, b, strict=True):
        if clean is None:
            clean = torch.ones(ia.shape[0], dtype=torch.bool, device=ia.device)
        changed = (ia.sort(-1).values != ib.sort(-1).values).any(-1)  # (B, S)
        agree = ~changed & clean[:, None]
        delta = float((sa - sb).abs()[agree].max()) if bool(agree.any()) else 0.0
        top = torch.topk(sb, k + 1, dim=-1).values
        gap = top[..., k - 1] - top[..., k]
        off = changed & clean[:, None]
        judge(bool((gap[off] <= 2 * delta).all()),
              f"{what}: a routing change off a near-tie (gaps {gap[off].tolist()[:8]}, "
              f"twice the largest score difference {2 * delta:.3g})")
        n_ties += int(off.sum())
        gaps.append(2 * delta)
        clean &= ~changed.any(-1)
    if clean is None:  # no MoE layer
        return None, 0
    print(f"routing {what}: {n_ties} near-tie tokens (changed choices, each within its call's "
          f"stated gap, max {max(gaps):.3g}); {int((~clean).sum())} of {clean.numel()} "
          f"sequences set aside")
    return clean, n_ties


def lm_phase(dev, cfg, *, batch: int, prompt_len: int, gen_len: int, max_err: dict,
             judge=check, timed: bool = True, jax_shapes: bool = True,
             f32_layers: int | None = None) -> dict:
    """The LM serving path: build `cfg`'s model on the card from a seeded
    generator (a cross-attention arch's gates then set to `GATE`, its
    context input drawn as `launch.serve.make_extras` draws it); hold
    `flash_attention` against its plain version within `AGREE` (and, in
    bf16, `OFF_PLAIN_SHARE`) on the path's own tensors (every attention
    application's q, k, v of the bf16 prefill: self-attention, encoder and
    cross-attention, each at its own mask; an f32 copy of the first's; a
    decode step's cross-attention, S = 1, in bf16 and f32) and, with
    `jax_shapes`, on the JAX kernel test's shapes; greedy-generate `batch` x
    `prompt_len` + `gen_len` tokens (one launch per prefill application and
    one per cross-attention layer a decode step, no plain call); check the
    tokens (identical across two runs; teacher-forced through a
    `mode="ref"` prefill, each the plain path's argmax but at counted
    near-ties); time the kernel, its plain version, SDPA (at the call's
    mask), on the first application of each kind (`CALLS`), the prefill and
    a decode step (when `timed`; with `jax_shapes` also the kernel at head
    dims 64 and 128); last, widen the
    weights to f32 and hold the kernel path's hidden states at every prompt
    position, and its last-token logits, against the plain path's (with
    `f32_layers`, on a model of that many layers, seeded alike, built after
    this one is freed).  MLA layers take q, k, v from the MLA projections, v
    padded with zeros to q's head dim as `mla_attn` pads it.  An MoE arch
    prints each prefill layer's ``moe_drop_frac`` and expert-load range, and
    its hidden states and logits are compared only on sequences whose
    routing agrees between the two runs (`judge_routes`).
    An arch with state layers (Mamba2, xLSTM) launches the kernel once a
    shared-block application (zamba2-2.7b: 9), or never (xlstm-125m); its
    f32-widened decode steps are held within 2e-3 of a full-sequence walk
    (`decode_vs_walk`), on the phase's prompts and on prompts of
    `SHORT_PROMPT` tokens; a cross-attention arch's too, on the phase's
    prompts and context.
    `judge(ok, msg)` takes each check's verdict: `check` raises at the
    first failure, scripts/torch_flash_faults.py records them all."""
    import numpy as np
    import torch
    from repro_torch.kernels import attention as kattn
    from repro_torch.kernels import counters
    from repro_torch.configs import cut_layers
    from repro_torch.models import blocks, lm
    from repro_torch.launch.serve import make_extras
    from repro_torch.serve import cv_engine

    heads = f"{cfg.n_heads}/{cfg.n_kv_heads}, {cfg.head_dim}"
    v_dim = None
    if cfg.mla is not None:
        m = cfg.mla
        v_dim = m.v_dim
        heads = (f"{cfg.n_heads}/{cfg.n_heads}, {m.qk_nope_dim + m.qk_rope_dim}; v {v_dim} "
                 f"padded to {m.qk_nope_dim + m.qk_rope_dim}")
    n_attn, n_cross = attention_applications(cfg), cross_applications(cfg)
    recurrent = any(k in blocks.STATE_KINDS for k, _ in cfg.blocks)
    out: dict = {"config": cfg.name, "batch": batch, "prompt_len": prompt_len, "gen_len": gen_len,
                 "n_layers": cfg.n_layers, "blocks": cfg.blocks, "config_heads": heads,
                 "attention_applications": n_attn, "cross_applications": n_cross}
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = lm.LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize(dev)
    out["init_s"] = time.perf_counter() - t0
    out["params"] = sum(p.numel() for p in model.parameters())
    out["weights_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"lm {cfg.name}: {cfg.n_layers} layers {cfg.blocks}, d {cfg.d_model}, heads {heads} "
          f"over {cfg.n_kv_heads} KV heads, window {cfg.window}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, moe {cfg.moe}, mla {cfg.mla}, ssm {cfg.ssm}, "
          f"xlstm {cfg.xlstm}, shared block after every run: {bool(cfg.shared_attn_every)}, "
          f"encoder layers {cfg.n_enc_layers}, {cfg.dtype}: "
          f"params={out['params']} weights={out['weights_bytes']} B init_s={out['init_s']:.2f} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated(dev)}")
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, prompt_len))).to(dev)
    context = make_extras(cfg, batch, prompt_len, generator=torch.Generator(dev).manual_seed(3),
                          device=dev)
    ctx_len = lm.context_len(cfg, context, batch)
    gates = set_gates(model)
    if context:
        shapes = ", ".join(f"{n} {tuple(t.shape)} {t.dtype}" for n, t in context.items())
        gated = (f"{gates} gates (JAX's init: 0, which makes a gated layer the identity) set to "
                 f"{GATE}" if gates else "no gate")
        print(f"lm {cfg.name}: context input {shapes}; {gated}; {n_attn} kernel calls a prefill, "
              f"{n_cross} a decode step")

    # -- the kernel against its plain version --------------------------------
    # held to kattn.AGREE (one rounding to the output dtype apart); the JAX
    # kernel test's looser rtol = atol (tests/test_kernels_attention.py:20,
    # :29) is reported beside it
    jax_test_tol = {torch.float32: 2e-4, torch.float16: 3e-2, torch.bfloat16: 3e-2}
    checks = {}

    def check_flash(name, q, k, v, causal):
        got = kattn.flash_attention(q, k, v, causal=causal)
        want = kattn.flash_attention(q, k, v, causal=causal, mode="ref")
        torch.cuda.synchronize(dev)
        judge(got.shape == q.shape and got.dtype == q.dtype, f"flash {name}: shape or dtype")
        judge(bool(torch.isfinite(got).all()), f"flash {name}: non-finite output")
        rtol, atol = kattn.AGREE[q.dtype]
        jt = jax_test_tol[q.dtype]
        w = want.float()
        diff = (got.float() - w).abs()
        err = float(diff.max())
        # the largest |got - want| / (atol + rtol |want|): over 1 fails
        excess = float((diff / (atol + rtol * w.abs())).max())
        excess_jax = float((diff / (jt + jt * w.abs())).max())
        print(f"check flash_attention {name} {tuple(q.shape)} T={k.shape[1]} {q.dtype} "
              f"causal={causal}: max_abs_err={err:.3g} share of the tolerance={excess:.3g} "
              f"(rtol {rtol:.3g}, atol {atol:.3g}); at the JAX test's {jt}: {excess_jax:.3g}")
        judge(excess <= 1.0, f"flash {name} {q.dtype}: {excess:.3g} times its tolerance")
        entry = {"max_abs_err": err, "share_of_tol": excess, "share_of_jax_test_tol": excess_jax}
        if q.dtype != torch.float32:
            # AGREE passes one 16-bit pass of p too: the p_hi + p_lo split
            # shows in the share of outputs off the plain version's
            off = float((got != want).float().mean())
            print(f"  outputs off the plain version's: {off:.5f} (limit {kattn.OFF_PLAIN_SHARE})")
            judge(off <= kattn.OFF_PLAIN_SHARE,
                  f"flash {name} {q.dtype}: {off:.3g} of its outputs off the plain version's")
            entry["off_plain"] = off
        checks[f"{name} {tuple(q.shape)} {q.dtype} causal={causal}"] = entry
        max_err["flash_attention"] = max(max_err["flash_attention"], err)

    with torch.inference_mode():
        firsts = {}  # the first application of each kind of call: its q, k, v and mask

        def visit(i, what, q, k, v, causal):
            check_flash(f"{what} of the prefill", q, k, v, causal)
            firsts.setdefault(what.split(") ")[-1], (q, k, v, causal))

        moe_metrics = []
        torch.cuda.reset_peak_memory_stats(dev)
        walk_prefill(model, prompts, context=context, visit=visit, metrics=moe_metrics)
        out["walk_max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        if moe_metrics:
            out["moe"] = [{"moe_drop_frac": float(mm["moe_drop_frac"]),
                           "expert_load_min": float(mm["expert_load"].min()),
                           "expert_load_max": float(mm["expert_load"].max()),
                           "moe_aux": float(mm["moe_aux"])} for mm in moe_metrics]
            for i, mm in enumerate(out["moe"]):
                print(f"moe layer {i} of the {cfg.name} prefill ({batch} x {prompt_len}, capacity "
                      f"factor {cfg.moe.capacity_factor}): moe_drop_frac={mm['moe_drop_frac']:.5f} "
                      f"expert_load (tokens' share, sums to top_k {cfg.moe.top_k}) "
                      f"min={mm['expert_load_min']:.5f} max={mm['expert_load_max']:.5f} "
                      f"moe_aux={mm['moe_aux']:.4f}")
        q, k, v, causal = next(iter(firsts.values()), (None,) * 4)
        if n_attn:
            check_flash("the first attention application of the prefill, f32 copy", q.float(),
                        k.float(), v.float(), causal)
        if "cross-attention" in firsts:
            # a decode step's call: one query row (of the 16-bit body's 128-row
            # tile) over the context's K / V
            qx, kx, vx, _ = firsts["cross-attention"]
            q1 = qx[:, :1].contiguous()
            for dt in (torch.bfloat16, torch.float32):
                check_flash("a decode step's cross-attention (S = 1)", q1.to(dt), kx.to(dt),
                            vx.to(dt), False)
            del qx, kx, vx, q1
        if not n_attn:
            print(f"lm {cfg.name}: no attention layer; the path launches no kernel and calls no "
                  "plain version")
        g = torch.Generator(dev).manual_seed(1)
        jax_test_shapes = [(1, 128, 128, 1, 64), (2, 200, 200, 4, 64), (1, 300, 300, 2, 128),
                      (1, 257, 257, 2, 64), (2, 100, 160, 2, 16), (1, 150, 70, 2, 256)]
        for (b, s, t, h, hd) in jax_test_shapes if jax_shapes else ():
            for dt in (torch.float32, torch.bfloat16):
                qq, kk, vv = (torch.randn((b, n, h, hd), generator=g, device=dev).to(dt)
                              for n in (s, t, t))
                for causal in (True, False):
                    check_flash("JAX test shape", qq, kk, vv, causal)
    out["checks"] = checks

    # -- generate: one flash launch per prefill application and per decode
    # step's cross-attention layer, no plain call ------------------------------
    def run_generate():
        return cv_engine.generate(model, prompts, steps=gen_len, extras=context, device=dev)

    t0 = time.perf_counter()
    tokens, snap = counted(counters, run_generate)
    torch.cuda.synchronize(dev)
    wall1 = time.perf_counter() - t0
    expect_counts(f"generate {cfg.name}", snap,
                  {"flash_attention": n_attn + (gen_len - 1) * n_cross}, judge)
    judge(tokens.shape == (batch, gen_len), f"generate: shape {tuple(tokens.shape)}")
    t0 = time.perf_counter()
    again = run_generate()
    torch.cuda.synchronize(dev)
    wall2 = time.perf_counter() - t0
    judge(torch.equal(tokens, again), "generate: tokens differ between two runs on the card")
    out["generate"] = {"counters": snap, "wall_s": [wall1, wall2],
                       "max_memory_allocated": torch.cuda.max_memory_allocated(dev)}
    print(f"generate {cfg.name}: {batch} x {prompt_len} + {gen_len} tokens, "
          f"launches={snap['launches']} plain_calls={snap['plain_calls']} "
          f"wall_s={wall1:.3f}/{wall2:.3f} (first / second) identical across runs; "
          f"max_memory_allocated={out['generate']['max_memory_allocated']}")
    print(f"generate {cfg.name}: first request's tokens {tokens[0].tolist()}")
    if recurrent:  # a prompt under the conv's taps, checked in f32 below
        short = prompts[:, :SHORT_PROMPT]
        short_tok = cv_engine.generate(model, short, steps=SHORT_GEN, device=dev)
        print(f"generate {cfg.name}: {batch} x {SHORT_PROMPT} + {SHORT_GEN} tokens, the first "
              f"request's {short_tok[0].tolist()}")

    # -- teacher-forced through the kernel path and the plain path -----------
    # At random init these checks cannot see a kernel fault: the tied
    # embedding, scaled by sqrt(d), dominates the residual stream, so every
    # step's argmax is the token fed in, whatever attention returns.  The
    # checks that depend on attention are the per-layer one above and the
    # f32 hidden states at every position below.  Decode takes no mode: its
    # cross-attention runs the kernel on both paths.
    def forced(mode):
        with torch.inference_mode():
            lg, pc = lm.prefill(model, prompts, extras=context, mode=mode)
            cache = lm.init_cache(cfg, batch, prompt_len + gen_len, ctx_len=ctx_len, device=dev)
            cache = cv_engine._adopt_prefill(cache, pc, cfg)
            del pc
            steps = [lg.float()]
            for t in range(gen_len - 1):
                lg, cache = lm.decode_step(model, tokens[:, t : t + 1], cache)
                steps.append(lg.float())
            return torch.stack(steps, dim=1)  # (B, gen_len, V)

    lk = forced(None)
    judge(torch.equal(lk.argmax(-1).to(tokens.dtype), tokens),
          "teacher-forced kernel path does not reproduce generate's tokens")
    lp = forced("ref")
    diff = float((lk - lp).abs().max())
    top2 = torch.topk(lp, 2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    off = lp.argmax(-1).to(tokens.dtype) != tokens
    n_off = int(off.sum())
    print(f"teacher-forced: {n_off} of {off.numel()} tokens are not the plain path's argmax; "
          f"each a near-tie (plain top-2 margin <= {diff:.4g}, the largest logit difference)")
    judge(bool((margin[off] <= diff).all()), "a token differs from the plain path off a near-tie")
    out["tokens"] = {"max_logit_diff": diff, "not_plain_argmax": n_off, "of": off.numel()}
    del lk, lp

    # -- times ---------------------------------------------------------------
    if timed:
        by_call = {what: time_flash(*qkv[:3], v_dim=v_dim, causal=qkv[3])
                   for what, qkv in firsts.items()}
        if by_call:
            out["flash"] = next(iter(by_call.values()))
        if len(by_call) > 1:
            out["flash_by_call"] = by_call
        if jax_shapes:
            # the same call at head dims 64 and 128 (width 4096): a tile's tensor
            # work grows with hd and its softmax does not
            g = torch.Generator(dev).manual_seed(2)
            out["flash_head_dims"] = {
                hd: time_flash(*(torch.randn(q.shape[:2] + (4096 // hd, hd), generator=g,
                                             device=dev).to(q.dtype) for _ in range(3)))
                for hd in (64, 128)}
        lm_times(model, prompts, tokens, out, context)
    del q, k, v, firsts

    # -- the same weights in f32: every position, and the last-token logits --
    # The kernel changes an attention output by a bf16 rounding at most, and
    # 28 layers carry such changes to the logits, as they carry every other
    # bf16 rounding.  So the bf16 tolerance is the bf16 model's own error,
    # e = max |plain bf16 - plain f32| on the same weights, and the kernel
    # path must be as accurate: |kernel - f32| <~ e, so by the triangle
    # inequality |kernel - plain| <= 2e.  The f32 model takes the kernel
    # through every layer at f32 rounding: its kernel and plain paths agree
    # within 2e-3 on the logits (tests/test_decode_consistency.py), and
    # within the kernel's own f32 tolerance on the final-normed hidden
    # states at every prompt position.
    #
    # An MoE arch's routing may change between two runs at near-ties (a
    # changed choice moves its sequence's later slot ranks): the kernel and
    # plain runs are compared on the sequences whose routing agrees.
    if f32_layers is not None:
        del model
        torch.cuda.empty_cache()
        cfg = cut_layers(cfg, f32_layers)
        n_attn = attention_applications(cfg)
        torch.cuda.reset_peak_memory_stats(dev)
        model = lm.LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
        print(f"f32 check of {cfg.name} on a model of {f32_layers} of its layers {cfg.blocks} "
              f"(the widened model of all of them does not fit the card)")
    top_k = cfg.moe.top_k if cfg.moe is not None else 0

    def last_logits(mode):
        """The prefill's last-token logits from a walk (as `lm.prefill`'s),
        its final hidden states and its routing calls."""
        head = model.embed.T if cfg.tie_embeddings else model.lm_head
        with torch.inference_mode(), RouteRecorder() as routes:
            h = walk_prefill(model, prompts, context=context, mode=mode)
            return (h[:, -1] @ head).float(), h, routes.calls

    (pre_k, _, rk16), (pre_p, _, rp16) = last_logits(None), last_logits("ref")
    model.float()  # widens the bf16 weights exactly
    (l32k, hk, rk32), snap = counted(counters, lambda: last_logits(None))
    expect_counts("f32 prefill", snap, {"flash_attention": n_attn}, judge)
    l32p, hp, rp32 = last_logits("ref")
    out["max_memory_allocated_f32"] = torch.cuda.max_memory_allocated(dev)
    clean32, ties32 = judge_routes(rk32, rp32, top_k, f"{cfg.name} f32 kernel vs plain", judge)
    clean16, ties16 = judge_routes(rk16, rp16, top_k, f"{cfg.name} bf16 kernel vs plain", judge)
    # the model's own bf16 error, not a kernel check: printed, not judged
    _, ties_w = judge_routes(rp16, rp32, top_k, f"{cfg.name} bf16 plain vs f32 plain",
                             lambda ok, msg: None)
    del rk16, rp16, rk32, rp32
    every = torch.ones(batch, dtype=torch.bool, device=dev)
    clean32 = every if clean32 is None else clean32
    clean16 = every if clean16 is None else clean16
    out["routing"] = {"near_tie_tokens": {"f32 kernel vs plain": ties32,
                                          "bf16 kernel vs plain": ties16,
                                          "bf16 plain vs f32 plain": ties_w},
                      "sequences_compared": {"f32": int(clean32.sum()), "bf16": int(clean16.sum())}}
    judge(bool(clean32.any()), "f32: every sequence's routing changed between kernel and plain")
    hk, hp = hk[clean32], hp[clean32]
    rtol, atol = kattn.AGREE[torch.float32]
    h_share = float(((hk - hp).abs() / (atol + rtol * hp.abs())).max())
    h_err = float((hk - hp).abs().max())
    print(f"f32 hidden states at all {batch} x {prompt_len} positions of {int(clean32.sum())} "
          f"sequences (max |h| {float(hp.abs().max()):.4g}): kernel vs plain max={h_err:.4g} "
          f"share of the tolerance={h_share:.4g} (rtol = atol = {rtol}); "
          f"max_memory_allocated={out['max_memory_allocated_f32']}")
    judge(h_share <= 1.0, f"f32 hidden states: kernel vs plain {h_share:.3g} times the tolerance")
    out["hidden_f32"] = {"max": h_err, "share_of_tol": h_share}
    del hk, hp
    gaps = {"f32 kernel vs plain": (l32k[clean32], l32p[clean32]),
            "bf16 kernel vs plain": (pre_k[clean16], pre_p[clean16]),
            "bf16 plain vs f32 plain": (pre_p, l32p), "bf16 kernel vs f32 plain": (pre_k, l32p)}
    gaps = {name: {"sequences": a.shape[0],
                   "max": float((a - b).abs().max()) if a.numel() else 0.0,
                   "rms": float((a - b).square().mean().sqrt()) if a.numel() else 0.0,
                   "share_differing": float((a != b).float().mean()) if a.numel() else 0.0}
            for name, (a, b) in gaps.items()}
    print(f"prefill last-token logits (max |logit| {float(l32p.abs().max()):.4g}): "
          + "; ".join(f"{k} ({v['sequences']} of {batch} sequences) max={v['max']:.4g} "
                      f"rms={v['rms']:.4g} differing={v['share_differing']:.4f}"
                      for k, v in gaps.items()))
    err32, pre_err = gaps["f32 kernel vs plain"]["max"], gaps["bf16 kernel vs plain"]["max"]
    bf16_err = gaps["bf16 plain vs f32 plain"]["max"]
    judge(err32 <= 2e-3, f"f32 prefill logits: kernel and plain paths differ by {err32}")
    judge(pre_err <= 2 * bf16_err,
          f"bf16 prefill logits: kernel vs plain {pre_err} > twice the bf16 error {bf16_err}")
    out["prefill_logits"] = gaps
    del l32k, l32p
    if recurrent or n_cross:
        # the chunked scans (SSD, mLSTM) against their step recurrences, and
        # decode's cross-attention (S = 1) against the prefill's, at full
        # width: each decode step against a full-sequence walk, in f32; then
        # a recurrent arch's prompt under the conv's taps (the port's
        # departure from JAX)
        cfg32 = cfg.replace(dtype="float32")
        runs = [("", *decode_vs_walk(model, cfg32, prompts, tokens, context),
                 (batch, prompt_len, gen_len))]
        if recurrent:
            runs.append((" short prompt", *decode_vs_walk(model, cfg32, short, short_tok),
                         (batch, SHORT_PROMPT, SHORT_GEN)))
        for what, e, t, (b, n, g) in runs:
            print(f"{cfg.name}{what} f32, {b} x {n} + {g}: each step's logits against the "
                  f"full-sequence walk at its position (max |logit| {t:.4g}): max_abs_err "
                  f"max={max(e):.4g} {[round(x, 7) for x in e[:8]]}... (limit 2e-3)")
            judge(max(e) <= 2e-3, f"{cfg.name}{what}: decode logits {max(e)} off the full walk's")
            out["f32_step_errs_short" if what else "f32_step_errs"] = e
    del model
    torch.cuda.empty_cache()
    return out


class RepeatedBatch:
    """A data stream whose every step is `stream`'s step 0, with `extras`
    (a context input) beside the tokens: the repeated batch of JAX's
    test_loss_decreases, on which the loss must fall."""

    def __init__(self, stream, extras: dict | None = None):
        self.batch = stream.batch_at(0) | (extras or {})

    def batch_at(self, step: int) -> dict:
        return self.batch


def flash_offset_phase(dev, card: str, max_err: dict, judge=check) -> dict:
    """`flash_attention` at query offsets (`FLASH_OFFSETS`), bf16 and f32:
    each slice of the queries at its offset bit-equal to the whole launch's
    rows (a row walks the same 64-key tiles in the same order either way,
    and a tile past its position adds exactly 0), and within `AGREE`
    (16-bit: and `OFF_PLAIN_SHARE`) of the plain version at that offset.
    The whole launch at offset 0 against an older checkout's kernel, bit
    for bit: scripts/torch_flash_offset_compare.py."""
    import torch
    from repro_torch.kernels import attention as kattn

    out = {}
    g = torch.Generator(dev).manual_seed(11)
    for (B, T, H, G, hd, rows, offs) in FLASH_OFFSETS:
        base = [torch.randn((B, T, n, hd), generator=g, device=dev) for n in (H, G, G)]
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (t.to(dt) for t in base)
            whole = kattn.flash_attention(q, k, v)
            for off in offs:
                qs = q[:, off:off + rows].contiguous()
                got = kattn.flash_attention(qs, k, v, q_off=off)
                plain = kattn.flash_attention(qs, k, v, q_off=off, mode="ref")
                torch.cuda.synchronize(dev)
                same = torch.equal(got, whole[:, off:off + rows])
                rtol, atol = kattn.AGREE[dt]
                diff = (got.float() - plain.float()).abs()
                err = float(diff.max())
                excess = float((diff / (atol + rtol * plain.float().abs())).max())
                off_plain = float((got != plain).float().mean())
                name = f"{tuple(qs.shape)} over T={T}, {G} KV heads, q_off={off}, {dt}"
                print(f"check flash_attention offset {name}: the whole launch's rows bit for bit: "
                      f"{same}; against the plain version max_abs_err={err:.3g} share of the "
                      f"tolerance={excess:.3g}, outputs off it {off_plain:.5f} card={card}")
                judge(same, f"flash offset {name}: the slice differs from the whole launch's rows")
                judge(excess <= 1.0, f"flash offset {name}: {excess:.3g} times its tolerance")
                if dt != torch.float32:
                    judge(off_plain <= kattn.OFF_PLAIN_SHARE,
                          f"flash offset {name}: {off_plain:.3g} of its outputs off the plain's")
                out[name] = {"bit_equal_rows": same, "max_abs_err": err, "share_of_tol": excess,
                             "off_plain": off_plain}
                max_err["flash_attention"] = max(max_err["flash_attention"], err)
    return out


class Stacked:
    """`sharding.comm.Over` over slices stacked on a leading dimension of
    one process: max / sum over that dimension, kept."""

    def max(self, x):
        return x.amax(0, keepdim=True)

    def sum(self, x):
        return x.sum(0, keepdim=True)


def flash_lse_phase(dev, card: str, judge=check) -> dict:
    """`flash_attention`'s log-sum-exp (`FLASH_LSE`): each launch's output
    bit for bit the one without it, the log-sum-exp within `FLASH_LSE_TOL`
    of the plain version's, and the cross-attention decode's context
    slices merged by it, in f32 within `AGREE` of the whole launch, in
    bf16 within its parts' roundings of the f32 plain version's.  The
    kernel without it against an older checkout's, bit for bit:
    scripts/torch_flash_offset_compare.py."""
    import torch
    from repro_torch.kernels import attention as kattn
    from repro_torch.models import attention as attn_mod

    out = {}
    g = torch.Generator(dev).manual_seed(13)
    for (label, B, S, T, H, G, hd, causal, dtypes, slices) in FLASH_LSE:
        base = [torch.randn(shape, generator=g, device=dev)
                for shape in ((B, S, H, hd), (B, T, G, hd), (B, T, G, hd))]
        for dt in dtypes:
            q, k, v = (t.to(getattr(torch, dt)) for t in base)
            whole = kattn.flash_attention(q, k, v, causal=causal)
            got, lse = kattn.flash_attention(q, k, v, causal=causal, lse=True)
            _, plain = kattn.flash_attention(q, k, v, causal=causal, mode="ref", lse=True)
            torch.cuda.synchronize(dev)
            same = torch.equal(got, whole)
            lse_err = float((lse - plain).abs().max())
            name = f"{label} {tuple(q.shape)} over T={T}, {G} KV heads, {dt}"
            row = {"bit_equal_without": same, "lse_max_abs_err": lse_err, "merged": {}}
            merged_txt = []
            exact = None
            for n in slices:
                parts = [kattn.flash_attention(q, kk.contiguous(), vv.contiguous(), causal=False,
                                               lse=True)
                         for kk, vv in zip(k.chunk(n, dim=1), v.chunk(n, dim=1))]
                outs = torch.stack([o for o, _ in parts])
                lses = torch.stack([lg for _, lg in parts])
                merged = attn_mod.merge_lse(outs, lses, Stacked())[0].float()
                diff = (merged - whole.float()).abs()
                if q.dtype == torch.float32:
                    rtol, atol = kattn.AGREE[q.dtype]
                    what = "AGREE of the whole launch"
                    excess = float((diff / (atol + rtol * whole.float().abs())).max())
                else:
                    if exact is None:
                        exact = kattn.flash_attention(*(t.float() for t in (q, k, v)),
                                                      causal=False, mode="ref")
                    w = torch.softmax(lses, dim=0).transpose(-1, -2)[..., None]
                    mag = (w * outs.float().abs()).sum(0)
                    bound = FLASH_LSE_ATOL + 2.0**-8 * (mag + merged.abs())
                    what = "its parts' roundings of the f32 plain version's"
                    excess = float(((merged - exact).abs() / bound).max())
                row["merged"][n] = {"max_abs_err_whole": float(diff.max()),
                                    "share_of_tol": excess}
                merged_txt.append(f"{n} slices merged by it {float(diff.max()):.3g} off the whole "
                                  f"launch, {excess:.3g} of the tolerance ({what})")
                judge(excess <= 1.0, f"flash lse {name}: {n} slices merged {excess:.3g} x {what}")
            print(f"check flash_attention log-sum-exp {name}: outputs bit for bit the launch's "
                  f"without it: {same}; within {lse_err:.3g} of the plain version's (bound "
                  f"{FLASH_LSE_TOL}); {'; '.join(merged_txt) or 'causal: not sliced'} "
                  f"card={card}")
            judge(same, f"flash lse {name}: the outputs differ with the log-sum-exp asked")
            judge(lse_err <= FLASH_LSE_TOL, f"flash lse {name}: {lse_err} off the plain version's")
            out[name] = row
    return out


def rel_l2(a, b) -> float:
    """|a - b| / |b| in f32 (|a| where b is 0)."""
    den = float(b.float().norm())
    diff = float((a.float() - b.float()).norm())
    return diff / den if den else diff


def loss_and_grads(model, batch: dict, mode=None) -> tuple:
    """One `train.step.loss_fn` and its backward -> (loss, metrics, {name:
    a copy of the gradient}); the model's gradients are cleared after."""
    import torch
    from repro_torch.train import step as tstep

    model.zero_grad(set_to_none=True)
    loss, metrics = tstep.loss_fn(model, batch, mode=mode)
    loss.backward()
    grads = {n: p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p)
             for n, p in model.named_parameters() if p.requires_grad}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), {k: v.detach() for k, v in metrics.items()}, grads


def profile_step(step_fn, state: dict, batch: dict) -> dict:
    """One train step under torch.profiler: the device time of every
    activity on the card, of the flash kernel's launches, and of the plain
    backward (its ``flash_attention_backward`` range); the host wall of
    the step (with the profiler's own cost)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step_fn(state, batch)  # warm-up: cuBLAS handles, the allocator's pools
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step_fn(state, batch)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    # the device's activities; the range's mirror on the device timeline
    # (a user annotation, not an activity) would count the backward twice
    dev_us = [(e.name, e.time_range.elapsed_us()) for e in events
              if e.device_type == cuda and e.name != "flash_attention_backward"]
    busy = sum(t for _, t in dev_us) / 1e3
    flash = sum(t for n, t in dev_us if "flash_attn" in n) / 1e3

    def device_total(e):
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)

    bwd = sum(device_total(e) for e in events
              if e.name == "flash_attention_backward" and e.device_type != cuda) / 1e3
    return {"device_ms": busy, "flash_kernel_ms": flash, "plain_backward_ms": bwd,
            "wall_ms": wall_ms, "activities": len(dev_us),
            "flash_share": flash / busy if busy else None,
            "plain_backward_share": bwd / busy if busy else None}


def train_phase(dev, card: str, path_counts: dict, results: dict) -> dict:
    """The training path (`train.loop.train`, `train.step`, the optimizers,
    `lm.forward` with remat, `flash_attention` under autograd):
    (a) `TRAIN_ARCH` at full width cut to `TRAIN_LAYERS` layers, AdamW (the
        launcher's default), bf16, remat on, `TRAIN_BATCH` x `TRAIN_SEQ`
        tokens, `TRAIN_STEPS` steps on a repeated batch at warmup 1 and
        peak lr `TRAIN_LR`: the loss finite and falling, 2 kernel launches
        a layer a step (the forward and the recompute) and one plain
        backward, no plain forward; step times, tokens a second, peak
        memory; then, in a process of its own (`train_profile_main`), a
        warm-up step and a step under torch.profiler (the kernel's and the
        plain backward's shares of its device time); and one layer's
        attention: the kernel's output held to its plain version within
        `kernels.attention.AGREE`, the plain backward timed beside SDPA's;
    (b) the same at full depth with Adafactor, `TRAIN_FULL_STEPS` steps
        (the most layers of `TRAIN_FALLBACK_LAYERS` that fit);
    (c) at `GRAD_LAYERS` layers in f32, the loss and every gradient of the
        kernel route against `mode="ref"` (within `GRAD_LOSS_RTOL` and
        `GRAD_RTOL`), w_q / w_k / w_v gradients non-zero; in bf16 the same
        within `GRAD_BF16_LOSS_RTOL` and `GRAD_BF16_RTOL`;
    (d) one train step of each arch's reduced config in f32, kernel against
        `mode="ref"` (loss and grad norm within (c)'s bounds), each route
        calling the kernel, or its plain version, and the plain backward as
        often as `kernel_applications` works out from the config;
    and a checkpoint round trip of reduced gemma-7b in f32: a 4-step run
    preempted after step 2 (SIGTERM, as JAX's test), resumed from its
    checkpoint, against an unbroken run.  (a) and (b) go into
    `path_counts`; (c), (d) and the round trip compare and do not."""
    import gc
    import os
    import signal
    import statistics
    import tempfile

    import torch
    import torch.nn.functional as F
    from repro_torch.configs import ARCHS, get_config, reduced_config
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import attention as kattn
    from repro_torch.kernels import counters
    from repro_torch.launch.serve import make_extras
    from repro_torch.models import lm
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import loop
    from repro_torch.train import step as tstep

    out: dict = {}
    gc.collect()
    torch.cuda.empty_cache()

    def device_batch(batch):
        return {k: v.to(dev) for k, v in batch.items()}

    def run(cfg, steps, optimizer, tag):
        stream = RepeatedBatch(TokenStream(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                           global_batch=TRAIN_BATCH))
        torch.cuda.reset_peak_memory_stats(dev)
        counters.reset()
        state, hist = loop.train(cfg, stream, steps=steps, optimizer=optimizer,
                                 peak_lr=TRAIN_LR, warmup=1, log_every=1, async_save=False,
                                 device=dev, log=lambda m: print(f"{tag}: {m}"))
        snap = counters.snapshot()
        n_attn = attention_applications(cfg)
        expect_counts(tag, snap, {"flash_attention": 2 * n_attn * steps})
        check(snap["backward_calls"]["flash_attention"] == n_attn * steps,
              f"{tag}: plain backward calls {snap['backward_calls']} != {n_attn * steps}")
        losses = [h["loss"] for h in hist]
        times = [h["seconds"] for h in hist]
        check(all(math.isfinite(x) for x in losses), f"{tag}: loss not finite: {losses}")
        n_params = sum(p.numel() for p in state["model"].parameters())
        tokens = TRAIN_BATCH * TRAIN_SEQ
        res = {"layers": cfg.n_layers, "optimizer": optimizer, "params": n_params,
               "losses": losses, "step_s": times, "tokens_per_s": tokens / min(times[1:]),
               "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
               "max_memory_reserved": torch.cuda.max_memory_reserved(dev),
               "counters": snap}
        print(f"{tag}: {n_params / 1e9:.3f} B parameters, losses={losses}, step_s={times}, "
              f"tokens_per_s={res['tokens_per_s']:.1f} (best step after the first), "
              f"max_memory_allocated={res['max_memory_allocated']} "
              f"max_memory_reserved={res['max_memory_reserved']}, launches="
              f"{snap_nonzero(snap)} backward_calls={snap['backward_calls']} card={card}")
        path_counts[tag] = snap
        return state, res

    # -- (a) full width, TRAIN_LAYERS layers, AdamW -----------------------------
    cfg_a = get_config(TRAIN_ARCH, n_layers=TRAIN_LAYERS)
    tag = f"train {cfg_a.name} x{TRAIN_LAYERS} adamw"
    state, res = run(cfg_a, TRAIN_STEPS, "adamw", tag)
    check(res["losses"][-1] < res["losses"][0],
          f"{tag}: the loss did not fall on a repeated batch: {res['losses']}")
    out["a"] = res
    del state
    gc.collect()
    torch.cuda.empty_cache()
    # the profiled step runs in a process of its own (`train_profile_main`):
    # on an H100, a second torch.profiler run in one process (phase 13's
    # device-activity check) recorded no activity of the card
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--train-profile"],
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0 and proc.stdout.strip(),
          f"{tag}: the profiled step failed ({proc.returncode}): {proc.stderr[-3000:]}")
    res["profile"] = prof = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"{tag}: one step under torch.profiler (its own process, after a warm-up step): "
          f"device_ms={prof['device_ms']:.3f} ({prof['activities']} activities) "
          f"flash_kernel_ms={prof['flash_kernel_ms']:.3f} (share {prof['flash_share']}) "
          f"plain_backward_ms={prof['plain_backward_ms']:.3f} (share "
          f"{prof['plain_backward_share']}) wall_ms={prof['wall_ms']:.3f} card={card}")

    # one layer's attention of (a): the kernel forward, the plain backward and
    # SDPA's forward + backward (the yardstick), on the same bf16 tensors
    g = torch.Generator(dev).manual_seed(3)
    shape = (TRAIN_BATCH, TRAIN_SEQ, cfg_a.n_heads, cfg_a.head_dim)
    q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    o = kattn.flash_attention(q, k, v)
    want = kattn.flash_attention_plain(q, k, v, causal=True)
    rtol, atol = kattn.AGREE[q.dtype]
    diff = (o.float() - want.float()).abs()
    excess = float((diff / (atol + rtol * want.float().abs())).max())
    off = float((o != want).float().mean())
    print(f"check flash_attention train layer {shape} bf16 causal: max_abs_err="
          f"{float(diff.max()):.3g} share of the tolerance={excess:.3g} (rtol {rtol:.3g}, atol "
          f"{atol:.3g}); outputs off the plain version's: {off:.5f} (limit {kattn.OFF_PLAIN_SHARE})")
    check(excess <= 1.0 and off <= kattn.OFF_PLAIN_SHARE,
          f"flash_attention train layer: {excess:.3g} times its tolerance, {off:.3g} off plain")
    del want, diff
    bwd = [time_ms(lambda: kattn.flash_attention_backward(q, k, v, o, do), iters=5)
           for _ in range(2)]
    fwd = [time_ms(lambda: kattn.flash_attention(q, k, v), iters=20) for _ in range(2)]
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    dot = do.transpose(1, 2)
    sdpa = time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), (qt, kt, vt), dot), iters=20)
    b = flash_bound(q, k)
    # the backward's work: q.k recomputed, then dV, dP, dQ and dK, five
    # products of the forward's q.k size, at the tensor cores' rate; q, k,
    # v, o and dO read once, dq, dk and dv written once
    bwd_bytes = 8 * q.numel() * q.element_size()
    bwd_bound = max(bwd_bytes / PEAK_BYTES_PER_S, 5 * b["flops_one_pv"] / 2 / PEAK_BF16_FLOPS) * 1e3
    out["attention_layer"] = {"shape": list(shape), "forward_ms": min(fwd),
                              "plain_backward_ms": min(bwd), "plain_backward_runs": bwd,
                              "backward_bound_ms": bwd_bound, "sdpa_fwd_bwd_ms": sdpa}
    print(f"time flash_attention train layer {shape} bf16 causal: kernel forward ms={fwd} "
          f"plain backward ms={bwd} (bound {bwd_bound:.5f}, operations) SDPA forward+backward "
          f"ms={sdpa:.5f} card={card}")
    del q, k, v, do, o, qt, kt, vt, dot

    # -- (b) full depth, Adafactor ------------------------------------------------
    for layers in TRAIN_FALLBACK_LAYERS:
        cfg_b = get_config(TRAIN_ARCH, n_layers=layers)
        tag = f"train {cfg_b.name} x{layers} adafactor"
        try:
            state, res = run(cfg_b, TRAIN_FULL_STEPS, "adafactor", tag)
        except torch.cuda.OutOfMemoryError as e:
            print(f"{tag}: does not fit the card ({str(e).splitlines()[0]}); fewer layers")
            state = None
            gc.collect()
            torch.cuda.empty_cache()
            continue
        break
    check(state is not None, f"train {TRAIN_ARCH} adafactor: no depth of "
          f"{TRAIN_FALLBACK_LAYERS} fits the card")
    out["b"] = res
    del state
    gc.collect()
    torch.cuda.empty_cache()

    # -- (c) the gradients of the kernel route against the plain route ---------
    batch = device_batch(TokenStream(vocab_size=cfg_a.vocab_size, seq_len=TRAIN_SEQ,
                                     global_batch=GRAD_BATCH).batch_at(0))
    out["c"] = {}
    for dtype in ("float32", "bfloat16"):
        cfg_c = get_config(TRAIN_ARCH, n_layers=GRAD_LAYERS).replace(dtype=dtype)
        model = lm.make_trainable(lm.LM(cfg_c, device=dev,
                                        generator=torch.Generator(dev).manual_seed(0)))
        counters.reset()
        lk, _, gk = loss_and_grads(model, batch)
        snap_k = counters.snapshot()
        counters.reset()
        lr_, _, gr = loss_and_grads(model, batch, mode="ref")
        snap_r = counters.snapshot()
        n_attn = attention_applications(cfg_c)
        expect_counts(f"grad check {dtype} kernel route", snap_k, {"flash_attention": 2 * n_attn})
        check(snap_r["plain_calls"]["flash_attention"] == 2 * n_attn
              and not any(snap_r["launches"].values()),
              f"grad check {dtype} plain route: {snap_r}")
        dist = {n: rel_l2(gk[n], gr[n]) for n in gk}
        qkv = {n: float(gk[n].float().norm()) for n in gk if n.endswith(("w_q", "w_k", "w_v"))}
        loss_rel = abs(lk - lr_) / abs(lr_)
        worst = max(dist, key=dist.get)
        out["c"][dtype] = {"loss": lk, "loss_ref": lr_, "loss_rel": loss_rel, "grad_rel_l2": dist,
                           "qkv_grad_norms": qkv}
        print(f"grad check {cfg_c.name} x{GRAD_LAYERS} {dtype} {GRAD_BATCH}x{TRAIN_SEQ}: loss "
              f"{lk} vs plain route {lr_} (rel {loss_rel:.3g}); gradient rel L2 max "
              f"{dist[worst]:.3g} ({worst}), median {statistics.median(dist.values()):.3g}; "
              f"w_q/w_k/w_v gradient norms {qkv} card={card}")
        check(all(v > 0 for v in qkv.values()), f"grad check {dtype}: a zero q/k/v gradient")
        loss_tol, grad_tol = ((GRAD_LOSS_RTOL, GRAD_RTOL) if dtype == "float32" else
                              (GRAD_BF16_LOSS_RTOL, GRAD_BF16_RTOL))
        check(loss_rel <= loss_tol, f"grad check {dtype}: loss off by {loss_rel}")
        check(dist[worst] <= grad_tol, f"grad check {dtype}: {worst} off by {dist[worst]}")
        del model, gk, gr
        gc.collect()
        torch.cuda.empty_cache()

    # -- (d) one step of each reduced config, kernel against the plain route ----
    out["d"] = {}
    for arch in ARCHS:
        cfg_d = reduced_config(arch).replace(dtype="float32")

        def one_step(mode):
            state = tstep.init_state(cfg_d, device=dev,
                                     generator=torch.Generator(dev).manual_seed(0))
            if lm.context_input(cfg_d):
                set_gates(state["model"])
            extras = make_extras(cfg_d, REDUCED_BATCH, REDUCED_SEQ,
                                 generator=torch.Generator(dev).manual_seed(1), device=dev)
            batch = device_batch(TokenStream(vocab_size=cfg_d.vocab_size, seq_len=REDUCED_SEQ,
                                             global_batch=REDUCED_BATCH).batch_at(0)) | extras
            counters.reset()
            _, m = tstep.make_train_step(cfg_d, peak_lr=1e-3, warmup=1, mode=mode)(state, batch)
            return {k: float(m[k]) for k in ("loss", "grad_norm")}, counters.snapshot()

        mk, sk = one_step(None)
        mr, sr = one_step("ref")
        want = kernel_applications(cfg_d, REDUCED_SEQ)
        expect_counts(f"train step {arch} reduced", sk, {"flash_attention": want})
        check(sr["plain_calls"]["flash_attention"] == want and not any(sr["launches"].values()),
              f"train step {arch} reduced plain route: {snap_nonzero(sr)} != {want} plain calls")
        check(sk["backward_calls"] == sr["backward_calls"] == {"flash_attention": want},
              f"train step {arch} reduced: backward calls {sk['backward_calls']} / "
              f"{sr['backward_calls']} != {want}")
        rel = {k: abs(mk[k] - mr[k]) / abs(mr[k]) for k in mk}
        out["d"][arch] = {"kernel": mk, "plain": mr, "rel": rel, "launches": want}
        print(f"train step {arch} reduced f32 {REDUCED_BATCH}x{REDUCED_SEQ}: loss {mk['loss']} / "
              f"{mr['loss']} (rel {rel['loss']:.3g}), grad_norm {mk['grad_norm']} / "
              f"{mr['grad_norm']} (rel {rel['grad_norm']:.3g}), {want} launches "
              f"(of {attention_applications(cfg_d)} attention applications)")
        check(rel["loss"] <= GRAD_LOSS_RTOL and rel["grad_norm"] <= GRAD_RTOL,
              f"train step {arch} reduced: kernel and plain routes differ: {rel}")

    # -- the checkpoint round trip --------------------------------------------
    cfg_r = reduced_config(TRAIN_ARCH).replace(dtype="float32")
    stream_r = TokenStream(vocab_size=cfg_r.vocab_size, seq_len=REDUCED_SEQ, global_batch=4)
    kw = dict(steps=4, peak_lr=1e-3, warmup=1, log_every=1, device=dev)
    quiet = lambda m: None  # noqa: E731
    full, h_full = loop.train(cfg_r, stream_r, log=quiet, async_save=False, **kw)

    def preempt_after_step_1(msg):
        if msg.startswith("[train] step 1 "):
            os.kill(os.getpid(), signal.SIGTERM)

    with tempfile.TemporaryDirectory() as d:
        part, _ = loop.train(cfg_r, stream_r, ckpt_dir=d, ckpt_every=100,
                             log=preempt_after_step_1, **kw)
        check(part["step"] == 2 and ckpt.latest_step(d) == 2,
              f"round trip: preempted at step {part['step']}, checkpoint {ckpt.latest_step(d)}")
        saved = {k: t.detach().clone() for k, t in tstep.state_tensors(part).items()}
        back, _ = ckpt.restore(d, tstep.state_tensors(part))
        exact = all(torch.equal(back[k], saved[k]) for k in saved)
        resumed, h_res = loop.train(cfg_r, stream_r, ckpt_dir=d, ckpt_every=2, log=quiet, **kw)
    check(exact, "round trip: a restored tensor differs from the one saved")
    pf = {n: p.detach() for n, p in full["model"].named_parameters()}
    num = sum(float((p.detach() - pf[n]).float().norm()) ** 2
              for n, p in resumed["model"].named_parameters())
    den = sum(float(p.float().norm()) ** 2 for p in pf.values())
    params_rel = (num / den) ** 0.5
    loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(h_res, h_full[2:]))
    out["round_trip"] = {"restored_bit_equal": exact, "params_rel_l2": params_rel,
                         "loss_rel": loss_rel, "resumed_steps": [h["step"] for h in h_res]}
    print(f"checkpoint round trip {cfg_r.name} reduced f32: preempted after step 2, restored "
          f"bit-equal={exact}, resumed steps {[h['step'] for h in h_res]}, losses within "
          f"{loss_rel:.3g} and parameters within {params_rel:.3g} (rel L2) of an unbroken run")
    check(resumed["step"] == 4 and [h["step"] for h in h_res] == [2, 3],
          f"round trip: resumed at {[h['step'] for h in h_res]}")
    check(loss_rel <= GRAD_LOSS_RTOL and params_rel <= GRAD_RTOL,
          f"round trip: the resumed run differs from the unbroken one ({loss_rel}, {params_rel})")
    results["train"] = out
    return out


def sdpa_takes_gqa(torch) -> bool:
    """`scaled_dot_product_attention` takes `enable_gqa` from torch 2.5 on."""
    return tuple(int(x) for x in re.findall(r"\d+", torch.__version__)[:2]) >= (2, 5)


def long_prompt_phase(dev, cfg, *, prompt_len: int, gen_len: int, judge=check) -> dict:
    """One request of `prompt_len` tokens past 8192 positions and past the
    window of `cfg` (a sliding-window arch): `generate` runs every prefill
    layer through `blockwise_attention` (no `flash_attention` launch, no
    plain call) and decodes against the window's ring, which holds the
    prompt's last `window` positions (`cv_engine._adopt_prefill`).  Then,
    with the weights widened to f32, each teacher-forced step's logits (the
    prefill's last position, then every decode step fed generate's tokens)
    must lie within 2e-3 of the logits one full-sequence walk over the prompt
    and those tokens (`walk_prefill` plus the head) gives at that position."""
    import numpy as np
    import torch
    from repro_torch.kernels import counters
    from repro_torch.models import lm
    from repro_torch.serve import cv_engine

    out: dict = {"config": cfg.name, "prompt_len": prompt_len, "gen_len": gen_len,
                 "window": cfg.window}
    model = lm.LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    rng = np.random.default_rng(1)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, prompt_len))).to(dev)

    def run_generate():
        return cv_engine.generate(model, prompts, steps=gen_len, device=dev)

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    tokens, snap = counted(counters, run_generate)
    torch.cuda.synchronize(dev)
    out["wall_s"] = time.perf_counter() - t0
    expect_counts(f"generate {cfg.name} {prompt_len} + {gen_len}", snap, {}, judge)
    judge(tokens.shape == (1, gen_len), f"long generate: shape {tuple(tokens.shape)}")
    out["counters"] = snap
    print(f"generate {cfg.name}: 1 x {prompt_len} + {gen_len} tokens (blockwise prefill, a ring "
          f"of {cfg.window} slots) launches={snap_nonzero(snap)} wall_s={out['wall_s']:.3f} "
          f"tokens {tokens[0].tolist()}")

    model.float()  # widens the bf16 weights exactly
    cfg32 = cfg.replace(dtype="float32")
    ring = lm.init_cache(cfg32, 1, prompt_len + gen_len, device=dev)["groups"][0]["k"].shape[2]
    errs, top = decode_vs_walk(model, cfg32, prompts, tokens)
    print(f"long prompt, f32: ring of {ring} slots; each step's logits against the full-sequence "
          f"walk at its position (max |logit| {top:.4g}): max_abs_err "
          f"{[round(e, 7) for e in errs]} (limit 2e-3)")
    judge(ring == cfg.window, f"long prompt: a ring of {ring} slots, not {cfg.window}")
    judge(max(errs) <= 2e-3, f"long prompt: decode logits {max(errs)} off the full walk's")
    out["f32_step_errs"] = errs
    del model
    torch.cuda.empty_cache()
    return out


def sdpa_backends(qt, kt, vt, **kw) -> list:
    """The SDPA backends that take this call (each tried alone)."""
    import torch
    import torch.nn.functional as F

    try:
        from torch.nn.attention import SDPBackend, sdpa_kernel
    except ImportError:
        return ["unknown (no torch.nn.attention)"]
    names = []
    for b in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
              SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([b]):
                F.scaled_dot_product_attention(qt, kt, vt, **kw)
            torch.cuda.synchronize()
            names.append(b.name)
        except RuntimeError:
            pass
    return names


def time_flash(q, k, v, v_dim: int | None = None, causal: bool = True) -> dict:
    """The kernel, its plain version and SDPA (``is_causal=causal``, the
    yardstick) on one call, and its bound.  With fewer KV heads than
    query heads SDPA runs with `enable_gqa=True` where the installed torch
    takes it, else on K and V repeated to the query heads outside the timed
    call (`library_form` says which).  `v_dim` (MLA): v holds that many real
    channels, padded with zeros to q's head dim for the kernel; SDPA gets
    the unpadded v and `library_form` lists the backends that take it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import attention as kattn

    hdv = v_dim or v.shape[-1]
    run = lambda: kattn.flash_attention(q, k, v, causal=causal)  # noqa: E731
    plain = lambda: kattn.flash_attention(q, k, v, causal=causal, mode="ref")  # noqa: E731
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v[..., :hdv].contiguous()))
    gqa = {"is_causal": causal}
    form = "MHA"
    if k.shape[2] != q.shape[2]:
        if sdpa_takes_gqa(torch):
            gqa, form = gqa | {"enable_gqa": True}, "enable_gqa=True"
        else:
            n_rep = q.shape[2] // k.shape[2]
            kt, vt = (a.repeat_interleave(n_rep, dim=1) for a in (kt, vt))
            form = "K and V repeated outside the timed call"
    if hdv != q.shape[-1]:
        form += f", v at {hdv} channels; backends that take it: {sdpa_backends(qt, kt, vt, **gqa)}"
        if hasattr(torch, "_fused_sdp_choice"):
            from torch.nn.attention import SDPBackend

            choice = SDPBackend(torch._fused_sdp_choice(qt, kt, vt, **gqa)).name
            form += f"; the default dispatch runs {choice}"
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, **gqa)  # noqa: E731
    want = plain()[..., :hdv].float()
    lib_err = float((sdpa().transpose(1, 2).float() - want).abs().max())
    check(lib_err <= 3e-2 * (1 + float(want.abs().max())),
          f"SDPA disagrees with the plain version by {lib_err}")
    del want
    p1 = time_ms(plain, iters=3, warmup=1)
    k1 = time_ms(run, iters=10)
    k2 = time_ms(run, iters=10)
    p2 = time_ms(plain, iters=3, warmup=1)
    lib = time_ms(sdpa, iters=20)
    t = {"ms_runs": [k1, k2], "plain_runs": [p1, p2], "library_ms": lib,
         "library_form": form, "sdpa_max_abs_diff": lib_err, "causal": causal,
         "shape": f"{tuple(q.shape)} over {tuple(k.shape)} {q.dtype}"} | flash_bound(
             q, k, causal=causal, v_dim=hdv)
    best = min(k1, k2)
    print(f"time flash_attention ({tuple(q.shape)} over {k.shape[2]} KV heads of T={k.shape[1]} "
          f"{q.dtype} causal={causal}; "
          f"SDPA {form}): ms={k1:.5f}/{k2:.5f} "
          f"plain_ms={p1:.3f}/{p2:.3f} sdpa_ms={lib:.5f} bound_ms={t['bound_ms']:.5f} "
          f"({t['bound_by']}: q.k + p_hi.v + p_lo.v on the tensor cores; {t['bytes']} B, "
          f"{t['flops']} FLOP) share of the bound={t['bound_ms'] / best:.4f}; "
          f"p.v-at-f32 bound_ms={t['bound_ms_f32_pv']:.5f} (share {t['bound_ms_f32_pv'] / best:.4f}); "
          f"all-f32 bound_ms={t['bound_ms_all_f32']:.4f}; SDPA share of the bound="
          f"{t['bound_ms'] / lib:.4f}, kernel / SDPA={best / lib:.3f}; kernel "
          f"{t['flops'] / best / 1e9:.1f} TFLOP/s of q.k + 2 p.v, SDPA "
          f"{t['flops_one_pv'] / lib / 1e9:.1f} of q.k + p.v")
    return t


def lm_times(model, prompts, tokens, out: dict, context=None) -> None:
    """The prefill (three runs) and each decode step of `tokens`, over the
    context input `context` of a cross-attention arch, into `out`."""
    import torch
    from repro_torch.models import lm
    from repro_torch.serve import cv_engine

    cfg, dev = model.cfg, prompts.device
    batch, prompt_len = prompts.shape
    gen_len = tokens.shape[1]
    with torch.inference_mode():
        t_pre = []
        for _ in range(3):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            _, pc = lm.prefill(model, prompts, extras=context)
            torch.cuda.synchronize(dev)
            t_pre.append(time.perf_counter() - t0)
        ctx_len = lm.context_len(cfg, context, batch)
        cache = cv_engine._adopt_prefill(
            lm.init_cache(cfg, batch, prompt_len + gen_len, ctx_len=ctx_len, device=dev), pc, cfg)
        del pc
        t_dec = []
        for t in range(gen_len - 1):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            _, cache = lm.decode_step(model, tokens[:, t : t + 1], cache)
            torch.cuda.synchronize(dev)
            t_dec.append(time.perf_counter() - t0)
        del cache
    pre_s, dec_s = min(t_pre), sorted(t_dec)[len(t_dec) // 2]
    out["prefill_s"], out["decode_step_s"] = t_pre, t_dec
    out["prefill_tok_s"] = batch * prompt_len / pre_s
    out["decode_tok_s"] = batch / dec_s
    print(f"time prefill {batch} x {prompt_len}: s={[round(x, 4) for x in t_pre]} "
          f"({out['prefill_tok_s']:.0f} tok/s at the fastest); decode step (median of "
          f"{len(t_dec)}): {dec_s * 1e3:.3f} ms ({out['decode_tok_s']:.1f} tok/s)")


def flash_times(t: dict) -> dict:
    """A `time_flash` result's numbers for the ``kernels`` line."""
    return {"ms": min(t["ms_runs"]), "plain_ms": min(t["plain_runs"]), "bound_ms": t["bound_ms"],
            "library_ms": t["library_ms"], "library_form": t["library_form"],
            "causal": t["causal"]}


def counted(counters, fn):
    """Run `fn` with the counters set to 0 just before; -> (its result, the
    launches and plain calls it made)."""
    counters.reset()
    out = fn()
    return out, counters.snapshot()


def expect_counts(what: str, snap: dict, launches: dict, judge=check) -> None:
    """Exactly `launches` (every other kernel 0) and no plain call."""
    want = {k: launches.get(k, 0) for k in snap["launches"]}
    judge(snap["launches"] == want, f"{what}: launches {snap['launches']} != {want}")
    judge(not any(snap["plain_calls"].values()), f"{what}: plain ran: {snap['plain_calls']}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch under {ROOT}; run it in a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.configs import get_config
    from repro_torch.cv import classify, features, imgproc, pipeline
    from repro_torch.cv.config import PipelineConfig
    from repro_torch.cv.gbdt import GbdtModel
    from repro_torch.data.synthetic import ImageStream
    from repro_torch.kernels import _build, counters, ref
    from repro_torch.kernels import bow as kbow
    from repro_torch.kernels import gbdt as kgbdt
    from repro_torch.kernels import ops, stencil

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {"card": None, "checks": {}, "timing": {}, "train": {}, "predict": {}}

    # -- 1. card and build ---------------------------------------------------
    card = card_line()
    results["card"] = card
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} {torch.cuda.get_device_name(0)}")
    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t_build = _build.build_all()
    print(f"build: {t_build:.2f} s (nvcc, sm_90a, {len(sources)} sources: {sources})")
    for name in sources:
        for line in _build.build_log(name).splitlines():
            entry = re.search(r"(flash_attn_(?:wgmma|simt)_kernel)I(\w+?)Li(\d+)E", line)
            if "Compiling entry" in line and entry:  # name each flash body's report
                print(f"ptxas[{name}]: {entry.group(1)}<{entry.group(2)}, {entry.group(3)}>")
            if "registers" in line or "spill" in line or "C75" in line:
                print(f"ptxas[{name}]: {line.strip()}")
    results["build_s"] = t_build

    pre_chain = (stencil.gaussian_stage(5), stencil.erode_stage(1), stencil.grad_stage())
    oct_chain = features.octave_chain(4, with_next_base=False)
    max_err = {k: 0.0 for k in counters.KERNELS}

    # -- 2. each kernel against its plain version on the card -----------------
    def check_chain(name, x, chain):
        """The chain under the kernel `mode=None` resolves to, and under the
        window kernel, each against the plain version."""
        want = stencil.fused_chain(x, chain, mode="ref")
        want = want if isinstance(want, tuple) else (want,)
        resolved = stencil.resolve_mode(chain, ref.to_planes(x).shape, x.dtype)
        for mode in dict.fromkeys((resolved, "window")):
            kernel = "stencil_chain" if mode == "window" else "stencil_stream"
            got = stencil.fused_chain(x, chain, mode=mode)
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            check(len(got) == len(want), f"{name}: band count {len(got)} != {len(want)}")
            err = 0.0
            for g, w in zip(got, want):
                check(g.shape == w.shape, f"{name}: shape {tuple(g.shape)} != {tuple(w.shape)}")
                check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
                # the repo's f32 oracle tolerance (tests/test_pyramid.py)
                ok = torch.abs(g - w) <= 2e-3 + 2e-5 * torch.abs(w)
                check(bool(ok.all()), f"{name}: {int((~ok).sum())} pixels off tolerance")
                err = max(err, float((g - w).abs().max()))
            print(f"check {kernel} ({mode}) {name} {tuple(x.shape)}: bands={len(got)} "
                  f"max_err={err:.3g}")
            results["checks"][f"{kernel} {mode} {name}"] = err
            max_err[kernel] = max(max_err[kernel], err)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev) * 255.0

    check_chain("preprocess", uniform(64, 256, 256, 3), pre_chain)
    check_chain("octave", uniform(256, 256, 256, 1), oct_chain)
    check_chain("octave planes<=halo", uniform(1024, 32, 32, 1), oct_chain)
    table_phase(dev, counters, stencil, ref, ImageStream, max_err, results)

    def check_hist(name, descs, valids, cents):
        """The cluster kernel against its plain version bit for bit,
        unnormalised and normalised, with the valids as they are and as
        fractional weights (whose sums depend on their order); two runs
        bit-identical."""
        B, N, D = descs.shape
        g = torch.Generator(device=dev).manual_seed(B * N + cents.shape[0])
        frac = torch.rand((B, N), generator=g, device=dev) * valids
        err = 0.0
        for what, w in (("valids", valids), ("fractional weights", frac)):
            for normalize in (False, True):
                got = kbow.bow_quantize_hist(descs, w, cents, normalize=normalize)
                again = kbow.bow_quantize_hist(descs, w, cents, normalize=normalize)
                want = kbow.quantize_hist_plain(descs, w, cents, normalize=normalize)
                torch.cuda.synchronize()
                tag = f"bow_quantize_hist {name} {what} normalize={normalize}"
                check(torch.equal(got, again), f"{tag}: two runs differ")
                e = float((got - want).abs().max())
                check(e == 0.0, f"{tag}: max_abs_err {e} against the plain version")
                err = max(err, e)
        print(
            f"check bow_quantize_hist {name} ({B},{N},{D}) K={cents.shape[0]} "
            f"({kbow.hist_ranks(cents.shape[0])} CTAs a cluster): max_abs_err={err:.3g} "
            "(unnormalised and normalised, valids and fractional weights; two runs bit-identical)"
        )
        max_err["bow_quantize_hist"] = max(max_err["bow_quantize_hist"], err)
        results["checks"][f"bow_quantize_hist {name}"] = {"max_abs_err": err}

    def hist_device_activities(descs, valids, cents):
        """The device activities of one `bow_quantize_hist` call, by
        torch.profiler: the kernel alone, no memset, cast or normalising
        launches."""
        from torch.profiler import ProfilerActivity, profile

        kbow.bow_quantize_hist(descs, valids, cents)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            kbow.bow_quantize_hist(descs, valids, cents)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        K = cents.shape[0]
        held = _build.library("bow").quantize_hist_max_clusters(K)
        print(f"check bow_quantize_hist device activities a call (torch.profiler): {names}; "
              f"{descs.shape[0]} clusters of {kbow.hist_ranks(K)} CTAs, the card holds {held} "
              "at once")
        check(len(names) == 1 and "quantize_hist_kernel" in names[0],
              f"bow_quantize_hist: a call ran {names} on the device, not one kernel")

    def check_score(name, h, w, b):
        got = kbow.linear_score(h, w, b)
        want = kbow.linear_score_plain(h, w, b)
        ulp = torch.nextafter(want.abs(), torch.full_like(want, math.inf)) - want.abs()
        ok = (got - want).abs() <= 4 * ulp + 1e-30
        check(bool(ok.all()), f"linear_score {name}: off by > 4 ulp")
        err = float((got - want).abs().max())
        print(f"check linear_score {name} {tuple(h.shape)} C={w.shape[0]}: max_abs_err={err:.3g}")
        max_err["linear_score"] = max(max_err["linear_score"], err)
        results["checks"][f"linear_score {name}"] = err

    def check_assign(name, desc, cents):
        got_i, got_d2 = kbow.bow_assign(desc, cents)
        want_i, want_d2 = kbow.bow_assign_plain(desc, cents)
        torch.cuda.synchronize()
        err = max(
            float((got_i - want_i).abs().max()), float((got_d2 - want_d2).abs().max())
        )
        ties = int(near_tie_mask(desc, cents).sum())
        print(
            f"check bow_assign {name} {tuple(desc.shape)} K={cents.shape[0]}: "
            f"max_abs_err={err:.3g} (idx and d2) near_ties={ties}"
        )
        check(err == 0.0, f"bow_assign {name}: differs from its plain version")
        max_err["bow_assign"] = max(max_err["bow_assign"], err)
        results["checks"][f"bow_assign {name}"] = {"max_abs_err": err, "near_ties": ties}
        return got_i

    def check_gbdt(name, x, m):
        counters.reset()
        got_s, got_li = kgbdt.gbdt_score(x, m.feat, m.thr, m.leaf, m.base)
        check(counters.LAUNCHES["gbdt_score"] == 1, f"gbdt_score {name}: not one launch")
        want_s, want_li = kgbdt.gbdt_score_plain(x, m.feat, m.thr, m.leaf, m.base)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got_s).all()), f"gbdt_score {name}: non-finite scores")
        err = max(
            float((got_s - want_s).abs().max()), float((got_li - want_li).abs().max())
        )
        print(
            f"check gbdt_score {name} {tuple(x.shape)} trees={tuple(m.feat.shape)} "
            f"C={m.leaf.shape[2]}: max_abs_err={err:.3g} (scores and leaf indices)"
        )
        check(err == 0.0 and torch.equal(got_li, want_li) and torch.equal(got_s, want_s),
              f"gbdt_score {name}: differs from its plain version")
        max_err["gbdt_score"] = max(max_err["gbdt_score"], err)
        results["checks"][f"gbdt_score {name}"] = err
        return got_li

    def unit_rows(*shape):
        t = torch.rand(shape, generator=gen, device=dev)
        return t / t.norm(dim=-1, keepdim=True)

    B, N, D, K, C = 1024, 32, 128, DICT_SIZE, 10
    descs = unit_rows(B, N, D)
    valids = torch.rand((B, N), generator=gen, device=dev) < 0.9
    cents = unit_rows(K, D)
    check_hist("random", descs, valids, cents)
    # rows over one tile of 32 (N = 45, 100), one to eight ranks (K = 5, 33,
    # 250, 700, 1300: at 1300 ranks 0-2 walk two word tiles), a single image
    for b_, n_, k_ in ((1, 32, 250), (3, 45, 5), (2, 100, 33), (2, 100, 700), (5, 45, 250),
                       (2, 40, 1300)):
        check_hist(f"B={b_} N={n_} K={k_}", unit_rows(b_, n_, D),
                   torch.rand((b_, n_), generator=gen, device=dev) < 0.9, unit_rows(k_, D))
    h = kbow.normalize_hist(kbow.quantize_hist_plain(descs, valids, cents))
    w = torch.randn((C, K), generator=gen, device=dev)
    b = torch.randn((C,), generator=gen, device=dev)
    check_score("random", h, w, b)

    # bow_assign at N = 32768, K = 250 (the last codebook tile has 26 words
    # and 6 pad rows): word 249 duplicates word 3 and 64 descriptors sit on
    # it, so their best two words tie exactly and the lower index must win
    desc = unit_rows(32 * 1024, D)
    cents_t = cents.clone()
    cents_t[K - 1] = cents_t[3]
    desc[:64] = cents_t[3] + 1e-4 * unit_rows(64, D)
    idx = check_assign("random+ties", desc, cents_t)
    check(bool((idx[:64] == 3).all()), "bow_assign: a tie did not go to the lower word")

    # gbdt_score at B = 1024, F = 250, 16 trees of depth 3, 10 classes; the
    # first 8 rows hold x == thr at every level of tree 0 (goes left: leaf 0)
    T, depth = 16, 3
    feat = torch.randint(0, K, (T, depth), generator=gen, device=dev, dtype=torch.int32)
    feat[0] = torch.arange(depth, dtype=torch.int32, device=dev)
    gm = GbdtModel(
        feat,
        torch.rand((T, depth), generator=gen, device=dev) * 0.02,
        torch.randn((T, 2**depth, C), generator=gen, device=dev),
        torch.randn((C,), generator=gen, device=dev),
        C,
    )
    xg = kbow.normalize_hist(kbow.quantize_hist_plain(descs, valids, cents))
    xg[:8, :depth] = gm.thr[0]
    li = check_gbdt("random+boundary", xg.contiguous(), gm)
    check(bool((li[:8, 0] == 0).all()), "gbdt_score: x == thr did not go left")

    def gbdt_model(T, depth, C):
        """A random model over the K words, tree 0's levels on words 0.. ."""
        feat = torch.randint(0, K, (T, depth), generator=gen, device=dev, dtype=torch.int32)
        feat[0] = torch.arange(depth, dtype=torch.int32, device=dev) % K
        return GbdtModel(feat, torch.rand((T, depth), generator=gen, device=dev) * 0.02,
                         torch.randn((T, 2**depth, C), generator=gen, device=dev),
                         torch.randn((C,), generator=gen, device=dev), C)

    # past a warp's 32 lanes in trees and in classes, one row, a row count
    # that is no multiple of the block's 4, and a 655,360-byte leaf table
    # (64 trees of depth 8, 10 classes), over one block's shared memory
    for name, b_, (T_, d_, C_) in (("T=40", 256, (40, 3, 10)), ("C=33", 256, (16, 3, 33)),
                                   ("B=1", 1, (16, 3, 10)), ("B=7", 7, (16, 3, 10)),
                                   ("64 trees depth 8", 256, (64, 8, 10))):
        m = gbdt_model(T_, d_, C_)
        x = xg[:b_].clone()
        x[: min(b_, 2), :d_] = m.thr[0]
        li = check_gbdt(name, x.contiguous(), m)
        check(bool((li[: min(b_, 2), 0] == 0).all()), f"gbdt_score {name}: x == thr went right")

    phase_clean("phase 2")

    # -- 3. the training path on the card, once per head -----------------------
    stream = ImageStream(res=32)
    # integer splits: `hash` of a string is salted per process, of an int not
    imgs, labels = stream.batch(N_TRAIN, split=0)
    test_imgs, test_labels = stream.batch(N_REQUESTS * PREDICT_BATCH, split=1)
    cfgs = {h: PipelineConfig(preprocess=True, n_octaves=1, max_kp=32, head=h) for h in HEADS}
    path_counts = {}
    models, models_cpu = {}, {}
    for head, cfg in cfgs.items():
        timing = {}
        t0 = time.perf_counter()
        model, snap = counted(
            counters,
            lambda: pipeline.train(
                imgs,
                labels,
                cfg,
                dict_size=DICT_SIZE,
                generator=torch.Generator().manual_seed(0),
                device=dev,
                timing=timing,
            ),
        )
        wall = time.perf_counter() - t0
        expect_counts(
            f"train {head}", snap, {"stencil_chain": 1, "stencil_stream": 1, "bow_assign": 21}
        )
        path_counts[f"train {head}"] = snap
        check(bool(torch.isfinite(model.centroids).all()), f"train {head}: non-finite centroids")
        stages = {k: round(v, 4) for k, v in timing.items()}
        print(
            f"train {head} (card): {N_TRAIN} images, K={DICT_SIZE}, wall_s={wall:.3f} "
            f"stages_s={stages} launches={snap['launches']}"
        )
        t0 = time.perf_counter()
        model_cpu = pipeline.train(
            imgs,
            labels,
            cfg,
            dict_size=DICT_SIZE,
            generator=torch.Generator().manual_seed(0),
            device="cpu",
        )
        t_cpu = time.perf_counter() - t0
        print(f"train {head} (CPU, same seed): {t_cpu:.1f} s")
        models[head], models_cpu[head] = model, model_cpu
        results["train"][head] = {"wall_s": wall, "stages_s": timing, "cpu_s": t_cpu}

    phase_clean("phase 3")

    # -- 4. the predict path on the card, once per head -------------------------
    batches = test_imgs.split(PREDICT_BATCH)
    test_feats_cpu = pipeline.extract_features(test_imgs, cfgs["svm"], device="cpu")

    def cpu_scores(model, cfg):
        """What `pipeline.predict(model, test_imgs, device="cpu")` computes,
        from the CPU features taken once."""
        plan = classify.build_plan(copy.deepcopy(model).cpu(), cfg, device="cpu")
        return plan.scores(plan.histograms(test_feats_cpu["desc"], test_feats_cpu["valid"]))

    for head, cfg in cfgs.items():
        model = models[head]
        preds, per_batch, walls = [], [], []
        path = {"launches": dict.fromkeys(counters.KERNELS, 0), "plain_calls": {}}
        for i, xb in enumerate(batches):
            timing = {}
            t0 = time.perf_counter()
            pb, snap = counted(
                counters, lambda: pipeline.predict(model, xb, cfg, device=dev, timing=timing)
            )
            walls.append(time.perf_counter() - t0)
            expect_counts(
                f"predict {head} request {i}",
                snap,
                {
                    "stencil_chain": 1,
                    "stencil_stream": 1,
                    "bow_quantize_hist": 1,
                    HEAD_KERNEL[head]: 1,
                },
            )
            for k, v in snap["launches"].items():
                path["launches"][k] += v
            per_batch.append({"counters": snap, "timing": timing})
            preds.append(pb)
            stages_s = {k: round(v, 5) for k, v in timing.items()}
            print(
                f"predict {head} request {i}: launches={snap['launches']} "
                f"plain_calls={snap['plain_calls']} stages_s={stages_s} wall_s={walls[i]:.4f}"
            )
        path_counts[f"predict {head}"] = path
        pred = torch.cat(preds).cpu()
        check(pred.shape == (len(test_labels),), f"predict {head}: shape {tuple(pred.shape)}")
        acc = float((pred.long() == test_labels.long()).float().mean())
        acc_cpu = float(
            (cpu_scores(models_cpu[head], cfg).argmax(1) == test_labels.long()).float().mean()
        )
        print(
            f"accuracy {head}: card-trained {acc:.4f}, CPU-trained {acc_cpu:.4f} on "
            f"{len(pred)} test images (chance 0.1; required > 0.15 and within 0.05)"
        )
        check(acc > 0.15, f"accuracy {head} {acc} not above 0.15")
        check(abs(acc - acc_cpu) <= 0.05, f"accuracy {head}: card {acc} vs CPU-trained {acc_cpu}")

        again = torch.cat([pipeline.predict(model, xb, cfg, device=dev) for xb in batches]).cpu()
        check(torch.equal(pred, again), f"{head}: labels differ between two runs on the card")
        print(f"determinism {head}: labels identical across two runs on the card")

        scores = cpu_scores(model, cfg)
        cpu_pred = scores.argmax(1).to(torch.int32)
        mism = torch.nonzero(cpu_pred != pred).flatten().tolist()
        for i in mism:
            gap = float(scores[i, cpu_pred[i]] - scores[i, pred[i]])
            print(f"mismatch {head} image {i}: card={int(pred[i])} cpu={int(cpu_pred[i])} "
                  f"cpu_gap={gap:.3g}")
        # the card and the CPU run the same arithmetic except f32 atan2/sqrt in
        # the descriptors, whose last ulp can move an orientation bin: allow 1%
        print(f"card vs CPU plain predict {head}: {len(mism)} of {len(pred)} labels differ "
              "(limit 1%)")
        check(len(mism) <= 0.01 * len(pred), f"{head}: card and CPU predictions disagree")
        results["predict"][head] = {
            "accuracy": acc,
            "accuracy_cpu_trained": acc_cpu,
            "mismatches_vs_cpu": len(mism),
            "batches": per_batch,
            "wall_s": walls,
        }
    phase_clean("phase 4")

    # -- 5. the paper's filter2D / erode image path, every mode --------------
    slice_cases = image_path_cases(dev, ops, imgproc, features, stencil, ref, ImageStream)
    slice_times = {}
    for case in slice_cases:
        name = case["name"]
        want, planes, resolved = check_modes(case, counters, stencil, ref, path_counts, max_err)
        results["checks"][f"image path {name}"] = {"resolved": resolved, "max_abs_err": 0.0}
        slice_times[name] = time_image_case(case, planes, resolved, want)
        t = slice_times[name]
        print(f"time {name}: mode None -> {resolved}, ms={t['ms']:.5f} "
              f"stream_ms={t['stream_ms']:.5f} "
              f"({'tiled2d' if t['stream_tiled'] else 'streaming'}, "
              f"{100 * t['stream_share']:.2f}% of bound) window_ms={t['window_ms']:.5f} "
              f"({100 * t['window_share']:.2f}% of bound) "
              f"plain_ms={t['plain_ms']} library_ms={t['library_ms']} bound_ms={t['bound_ms']:.5f} "
              f"({t['bound_by']}; {t['bytes']} B, {t['flops']} FLOP) card={card}")
    wins = sum(t["stream_ms"] < t["window_ms"] for t in slice_times.values())
    print(f"image path: stencil_stream faster than stencil_chain on {wins} of {len(slice_times)} "
          f"shapes; mode None -> {sorted(collections.Counter(t['resolved'] for t in slice_times.values()).items())}")
    results["image_path"] = slice_times

    phase_clean("phase 5")

    # -- 6. the fused-vs-staged-vs-seed pipeline benchmark ---------------------
    seed_times = pipeline_phase(dev, card, max_err, path_counts, results)
    phase_clean("phase 6")

    # -- 7. the geometric path -------------------------------------------------
    geometric_phase(dev, card, max_err, path_counts, results)
    phase_clean("phase 7")

    # -- 8. the multi-octave pyramid path ---------------------------------------
    pyramid_phase(dev, card, max_err, path_counts, results, (imgs, labels), test_imgs)
    phase_clean("phase 8")

    # -- 9. measured routing ------------------------------------------------------
    routing_phase(dev, card, slice_cases, path_counts, results)
    phase_clean("phase 9")

    # -- 10. the CV serving engine ---------------------------------------------------
    serve_phase(dev, card, cfgs, models, path_counts, results)
    phase_clean("phase 10")

    # -- 11. the LM serving path -----------------------------------------------
    lm_outs = {}
    for arch, layers in LM_RUNS:
        lm_out = lm_phase(dev, get_config(arch, n_layers=layers), batch=LM_BATCH,
                          prompt_len=LM_PROMPT, gen_len=LM_GEN, max_err=max_err,
                          jax_shapes=arch == LM_ARCH, f32_layers=F32_LAYERS.get(arch))
        path_counts[f"generate {arch}"] = lm_out["generate"]["counters"]
        lm_outs[arch] = lm_out
    results["flash_offsets"] = flash_offset_phase(dev, card, max_err)
    results["flash_lse"] = flash_lse_phase(dev, card)
    long_out = long_prompt_phase(dev, get_config(LONG_ARCH), prompt_len=LONG_PROMPT,
                                 gen_len=LONG_GEN)
    path_counts[f"generate {LONG_ARCH} {LONG_PROMPT} + {LONG_GEN}"] = long_out["counters"]
    results["lm"], results["lm_long"] = lm_outs, long_out
    lm_out = lm_outs[LM_ARCH]
    phase_clean("phase 11")

    # -- 12. the LM training path ----------------------------------------------
    train_out = train_phase(dev, card, path_counts, results)
    phase_clean("phase 12")

    # -- 13. the sharded LM stack (its own process) -----------------------------
    shard_phase(card, path_counts, results)
    phase_clean("phase 13")

    # -- 14. the dry run and the roofline ------------------------------------------
    dryrun_phase(dev, card, path_counts, results)
    phase_clean("phase 14")

    main_launches = {
        k: sum(p["launches"][k] for p in path_counts.values()) for k in counters.KERNELS
    }
    results["path_counts"] = path_counts
    print(f"main-path launches (training x2 + predict x2 + image path + pipeline benchmark + "
          f"geometric path + pyramid path + measured routing + CV serving + generate x "
          f"{len(LM_RUNS)} archs + the long prompt + LM training x2 + the sharded stack + the dry "
          f"run's train step x2): "
          f"{main_launches}")
    check(all(v > 0 for v in main_launches.values()), f"a kernel never ran: {main_launches}")

    # -- 15. the kernels on the paths' own tensors, then timing -----------------
    xb = batches[0].to(dev).float()
    gray = features._normalize_gray(imgproc.preprocess_bow(xb))
    det = features.detect_keypoints(imgproc.preprocess_bow(xb), max_kp=cfgs["svm"].max_kp)
    d = features.describe_keypoints(det)
    qd, qv = d["desc"].contiguous(), d["valid"]
    m_svm, m_gbdt = models["svm"], models["gbdt"].gbdt
    cents_g = models["svm"].centroids.contiguous()
    hist = kbow.bow_quantize_hist(qd, qv, cents_g)
    hist_g = kbow.bow_quantize_hist(qd, qv, models["gbdt"].centroids.contiguous())
    wg, bg = m_svm.w.contiguous(), m_svm.b.contiguous()
    train_desc = pipeline.extract_features(imgs, cfgs["svm"], device=dev)["desc"]
    train_desc = train_desc.reshape(-1, train_desc.shape[-1]).contiguous()
    # each kernel against its plain version on the paths' own tensors
    check_chain("preprocess main path", xb, pre_chain)
    check_chain("octave main path", gray[..., None], oct_chain)
    check_hist("main path", qd, qv, cents_g)
    hist_device_activities(qd, qv, cents_g)
    check_score("main path", hist, wg, bg)
    check_assign("training descriptors", train_desc, cents_g)
    check_gbdt("main path", hist_g, m_gbdt)
    f32 = 4
    n_oct = ref.to_planes(gray[..., None]).numel()
    n_tr, k_w = train_desc.shape[0], cents_g.shape[0]
    g_out = hist_g.shape[0] * (m_gbdt.leaf.shape[2] + m_gbdt.feat.shape[0])
    kernels = [
        {
            "name": "stencil_chain",
            "source": "src/repro_torch/csrc/stencil_chain.cu",
            "replaces": "src/repro/kernels/stencil/exec_window.py:427",
            # what a request launches it for: the octave on 32x32 planes
            # (no larger than the ladder's 34-pixel halo)
            "run": lambda: stencil.fused_chain(gray[..., None], oct_chain),
            "plain": lambda: stencil.fused_chain(gray[..., None], oct_chain, mode="ref"),
            "library": None,
            # also as device time: a CUDA graph of 100 calls replayed (a
            # call's event time includes the host's planning)
            "graph": True,
            # the input read once, every band written once
            "bytes": f32 * n_oct * (1 + len(oct_chain)),
            "flops": n_oct * chain_flops(oct_chain),
            "shape": f"octave of a request of {PREDICT_BATCH} images",
        },
        {
            "name": "stencil_stream",
            "source": "src/repro_torch/csrc/stencil_stream.cu",
            "replaces": "src/repro/kernels/stencil/exec_streaming.py:89",
            "measured": slice_times[STREAM_ENTRY],
            "shape": f"{STREAM_ENTRY}, mode=None ({slice_times[STREAM_ENTRY]['resolved']})",
        },
        {
            "name": "bow_quantize_hist",
            "source": "src/repro_torch/csrc/bow.cu",
            "replaces": "src/repro/kernels/bow.py:135",
            "run": lambda: kbow.bow_quantize_hist(qd, qv, cents_g),
            "plain": lambda: kbow.quantize_hist_plain(qd, qv, cents_g, normalize=True),
            "library": None,
            "graph": True,
            # descriptors, valids (in their own dtype) and codebook read once,
            # the histograms written once
            "bytes": f32 * (qd.numel() + cents_g.numel() + hist.numel())
            + qv.numel() * qv.element_size(),
            "flops": 2 * qd.shape[0] * qd.shape[1] * cents_g.shape[0] * qd.shape[2],
            "shape": f"request of {PREDICT_BATCH} images",
        },
        {
            "name": "linear_score",
            "source": "src/repro_torch/csrc/bow.cu",
            "replaces": "src/repro/kernels/bow.py:227",
            "run": lambda: kbow.linear_score(hist, wg, bg),
            "plain": lambda: kbow.linear_score_plain(hist, wg, bg),
            "library": lambda: torch.addmm(bg, hist, wg.T),
            # also as device time: a CUDA graph of 100 calls replayed, as
            # for the seed kernels (a call's event time is host-bound here)
            "graph": True,
            "bytes": f32 * (hist.numel() + wg.numel() + bg.numel() + hist.shape[0] * wg.shape[0]),
            "flops": 2 * hist.shape[0] * wg.shape[0] * wg.shape[1],
            "shape": f"request of {PREDICT_BATCH} images",
        },
        {
            "name": "bow_assign",
            "source": "src/repro_torch/csrc/bow.cu",
            "replaces": "src/repro/kernels/bow.py:55",
            "run": lambda: kbow.bow_assign(train_desc, cents_g),
            "plain": lambda: kbow.bow_assign_plain(train_desc, cents_g),
            "library": None,
            "graph": True,
            # descriptors and codebook read once; word index (i32) and d2 written once
            "bytes": f32 * (train_desc.numel() + cents_g.numel() + 2 * n_tr),
            "flops": 2 * n_tr * k_w * train_desc.shape[1],
            "shape": f"one assignment of the {n_tr} training descriptors",
        },
        {
            "name": "gbdt_score",
            "source": "src/repro_torch/csrc/gbdt.cu",
            "replaces": "src/repro/kernels/gbdt.py:42",
            "run": lambda: kgbdt.gbdt_score(
                hist_g, m_gbdt.feat, m_gbdt.thr, m_gbdt.leaf, m_gbdt.base
            ),
            "plain": lambda: kgbdt.gbdt_score_plain(
                hist_g, m_gbdt.feat, m_gbdt.thr, m_gbdt.leaf, m_gbdt.base
            ),
            "library": None,
            # also as device time: a CUDA graph of 100 calls replayed (a
            # call's event time is host-bound)
            "graph": True,
            "bytes": f32
            * (
                hist_g.numel()
                + sum(t.numel() for t in (m_gbdt.feat, m_gbdt.thr, m_gbdt.leaf, m_gbdt.base))
                + g_out
            ),
            # one compare per (row, tree, level), one add per (row, tree, class) + the base
            "flops": hist_g.shape[0]
            * (m_gbdt.feat.numel() + m_gbdt.leaf.shape[0] * m_gbdt.leaf.shape[2] + m_gbdt.leaf.shape[2]),
            "shape": f"request of {PREDICT_BATCH} images",
        },
        {
            "name": "flash_attention",
            "source": "src/repro_torch/csrc/flash_attn.cu",
            "replaces": "src/repro/kernels/attention.py:31",
            "measured": lm_out["flash"],
            "shape": f"layer 0 of the {LM_ARCH} prefill, ({LM_BATCH}, {LM_PROMPT}, 16, 256) bf16",
            # the first attention application of each arch's prefill: its
            # kernel, plain, bound and SDPA times; a cross-attention arch's
            # first application of each kind of call (`CALLS`) under "by_call"
            "by_arch": {
                arch: {"shape": f"({LM_BATCH}, {LM_PROMPT}, {o['config_heads']}) bf16",
                       "launches": o["generate"]["counters"]["launches"]["flash_attention"],
                       **flash_times(o["flash"]),
                       **({"by_call": {what: {"shape": t["shape"], **flash_times(t)}
                                       for what, t in o["flash_by_call"].items()}}
                          if "flash_by_call" in o else {})}
                for arch, o in lm_outs.items() if "flash" in o
            },
            # the training path: its launches a step, one layer's kernel
            # forward and plain backward, a profiled step's shares
            "train": {
                "launches_per_step": train_out["a"]["counters"]["launches"]["flash_attention"]
                / TRAIN_STEPS,
                "plain_backward_calls_per_step":
                train_out["a"]["counters"]["backward_calls"]["flash_attention"] / TRAIN_STEPS,
                **train_out["attention_layer"],
                "profiled_step": train_out["a"]["profile"],
            },
        },
        *(
            {
                "name": name,
                "source": "src/repro_torch/csrc/unfused.cu",
                "replaces": f"benchmarks/unfused_baseline.py:{line}",
                "measured": seed_times[name],
                "shape": "one 512x512 u8 plane of the pipeline batch",
            }
            for name, line in (("seed_gaussian_blur", 51), ("seed_erode", 65),
                               ("seed_threshold", 80))
        ),
    ]
    lib_check = torch.addmm(bg, hist, wg.T)
    ok = torch.allclose(lib_check, kbow.linear_score(hist, wg, bg), rtol=1e-5, atol=1e-5)
    check(bool(ok), "linear_score disagrees with torch.addmm")
    line = []
    for k in kernels:
        if "measured" in k:  # timed in phase 5, 6, 7 or 9 on its path's shape
            t = k["measured"]
            (k1, k2), (p1, p2), lib = t["ms_runs"], t["plain_runs"], t["library_ms"]
            bms, by = t["bound_ms"], t["bound_by"]
            k["bytes"], k["flops"] = t["bytes"], t["flops"]
        else:
            # plain, kernel, kernel, plain: the two versions alternate on one card
            p1 = time_ms(k["plain"], iters=5)
            k1 = time_ms(k["run"], iters=50)
            k2 = time_ms(k["run"], iters=50)
            p2 = time_ms(k["plain"], iters=5)
            lib = time_ms(k["library"], iters=50) if k["library"] else None
            bms, by = bound_ms(k["bytes"], k["flops"])
        entry = {
            "name": k["name"],
            "route": "cuda",
            "source": k["source"],
            "replaces": k["replaces"],
            "launches": main_launches[k["name"]],
            "max_abs_err": max_err[k["name"]],
            "ms": min(k1, k2),
            "plain_ms": min(p1, p2),
            "bound_ms": bms,
            "bound_by": by,
            "library_ms": lib,
        }
        for extra in ("by_arch", "train"):
            if extra in k:
                entry[extra] = k[extra]
        if k.get("graph"):
            graph_ms = load_bench().graph_ms
            k_g = [graph_ms(k["run"], reps=100) for _ in range(2)]
            entry |= {"graph_ms": min(k_g)}
            if k["name"] == "gbdt_score":  # a kernel as short as a launch: its floor beside it
                entry |= {"launch_floor_ms": min(results["pipeline"]["launch_floor_ms"])}
            lib_txt = ""
            if k["library"]:
                lib_g = [graph_ms(k["library"], reps=100) for _ in range(2)]
                entry |= {"library_graph_ms": min(lib_g)}
                lib_txt = f" library_ms={lib_g[0]:.5f}/{lib_g[1]:.5f}"
            floor_txt = (f" launch_floor_ms={entry['launch_floor_ms']:.5f}"
                         if "launch_floor_ms" in entry else "")
            print(f"time {k['name']} graph replay of 100 calls: ms={k_g[0]:.5f}/{k_g[1]:.5f}"
                  f"{lib_txt} bound_ms={bms:.7f}{floor_txt} card={card}")
        if k["name"] == "stencil_chain":
            floor = window_floor_ms(oct_chain, tuple(ref.to_planes(gray[..., None]).shape),
                                    torch.float32)
            results["window_floor"] = floor
            print(f"window arithmetic of the octave of a request: cut frames "
                  f"{floor['cut']['flops']:.0f} FLOP ({floor['cut']['ms']:.5f} ms at 67 TFLOP/s), "
                  f"full windows {floor['full']['flops']:.0f} FLOP ({floor['full']['ms']:.5f} ms) "
                  f"card={card}")
        line.append(entry)
        print(
            f"time {k['name']} ({k['shape']}): ms={k1:.5f}/{k2:.5f} "
            f"plain_ms={p1:.4f}/{p2:.4f} "
            f"library_ms={lib} bound_ms={bms:.5f} ({by}; {k['bytes']} B, {k['flops']} FLOP) "
            f"card={card}"
        )
        results["timing"][k["name"]] = entry | {"ms_runs": [k1, k2], "plain_runs": [p1, p2]}

    phase_clean("phase 15")

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1, default=str))

    print(json.dumps({"kernels": line}))
    print(f"card: {card_line()}")
    device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }
    print(json.dumps({"ok": True, "device": device}))
    return 0


def dryrun_phase(dev, card: str, path_counts: dict, results: dict) -> dict:
    """Phase 14, the dry run and the roofline (`launch.dryrun`, `roofline`):
    (a) each of `DRYRUN_CELLS` through ``python -m repro_torch.launch.dryrun
    --cell``, in a process of its own on a fake process group of 256 ranks
    (the meta device, no card): the decode cell "ok" with its parameters
    counted, the skip cell "skip" with its arch's reason, their roofline
    rows printed; (b) phase 12 (a)'s step (`TRAIN_ARCH` at `TRAIN_LAYERS`
    layers, `TRAIN_BATCH` x `TRAIN_SEQ` tokens, AdamW) traced on the meta
    device, then run on the card under the same recorder: flops, bytes and
    each kernel's calls equal, no link bytes, one `flash_attention` launch
    a layer and one in its recompute; the roofline's three terms and step
    time beside a second step timed outside the recorder, the predicted peak
    beside `torch.cuda.max_memory_allocated`.  The card's two steps go into
    `path_counts`."""
    import gc
    import os

    import torch
    from repro_torch.configs import cell_status, get_config
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import counters
    from repro_torch.launch import dryrun
    from repro_torch.models import lm
    from repro_torch.models.config import ShapeConfig
    from repro_torch.roofline import analyze
    from repro_torch.roofline.cost import CostMode
    from repro_torch.train import step as tstep

    out = {"cells": {}}
    # -- (a) two cells of the production mesh, each in its own process ---------
    art = ROOT / "chiprun_out" / "dryrun_smoke"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH", "")) if p))
    rows = []
    for cell in DRYRUN_CELLS:
        arch, shape, mesh = cell.split(":")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-W", "ignore", "-m", "repro_torch.launch.dryrun",
                               "--cell", cell, "--out", str(art)],
                              capture_output=True, text=True, timeout=600, env=env)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"dryrun {cell} failed ({proc.returncode}): "
                                    f"{proc.stdout[-1000:]} {proc.stderr[-3000:]}")
        rec = json.loads((art / f"{arch}__{shape}__{dryrun.MESHES[mesh][0]}.json").read_text())
        cfg = get_config(arch)
        reason = cell_status(cfg, shape)
        if reason:
            check(rec["status"] == "skip" and rec["reason"] == reason,
                  f"dryrun {cell}: {rec['status']} {rec.get('reason')!r}, expected skip {reason!r}")
        else:
            leaves = lm.param_leaves(lm.LM(cfg, device="meta", generator=torch.Generator()))
            check(rec["status"] == "ok", f"dryrun {cell}: {rec['status']} {rec.get('error')}")
            check(rec["params_total"] == dryrun.count_params(leaves, False, cfg)
                  and rec["ranks"] == 256 and rec["cost"]["flops"] > 0,
                  f"dryrun {cell}: params {rec['params_total']}, ranks {rec['ranks']}, "
                  f"flops {rec['cost']['flops']}")
        row = analyze.analyze_cell(rec)
        rows.append(row)
        out["cells"][cell] = {"status": rec["status"], "wall_s": wall,
                              "seconds_trace": rec.get("seconds_trace"), "row": row}
        print(f"dryrun {cell}: {rec['status']} {rec.get('reason', '')} (wall {wall:.1f} s, "
              f"trace {rec.get('seconds_trace', 0):.1f} s, 256 fake ranks, no card)")
    print(analyze.table(rows, "16x16"))

    # -- (b) phase 12 (a)'s step: traced on meta, then run on the card ------------
    cfg = get_config(TRAIN_ARCH, n_layers=TRAIN_LAYERS)
    sh = ShapeConfig(f"train_{TRAIN_SEQ}", TRAIN_SEQ, TRAIN_BATCH, "train")
    rec = dryrun.trace_cell(cfg, sh)
    row = analyze.analyze_cell(rec)
    meta = rec["cost"]
    gc.collect()
    torch.cuda.empty_cache()
    state = tstep.init_state(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    # the dry run's inputs are int32 (`dryrun.input_specs`)
    batch = {k: v.to(dev, torch.int32) for k, v in stream.batch_at(0).items()}
    step_fn = tstep.make_train_step(cfg, optimizer="adamw")
    counters.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cm = CostMode()
    with cm:
        step_fn(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    recorded = counters.snapshot()
    t0 = time.perf_counter()
    step_fn(state, batch)  # outside the recorder
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    path_counts[f"dry run (b): train {TRAIN_ARCH} x{TRAIN_LAYERS} adamw x2"] = counters.snapshot()
    real = cm.summary()
    launches = 2 * TRAIN_LAYERS  # a layer's forward and its recompute
    check(real["flops"] == meta["flops"] and real["matmul_flops"] == meta["matmul_flops"],
          f"dry run (b): card flops {real['flops']} ({real['matmul_flops']} in products) "
          f"against the meta trace's {meta['flops']} ({meta['matmul_flops']})")
    check(real["hbm_bytes"] == meta["hbm_bytes"] and real["n_ops"] == meta["n_ops"],
          f"dry run (b): card bytes {real['hbm_bytes']} over {real['n_ops']} ops against "
          f"{meta['hbm_bytes']} over {meta['n_ops']}")
    check(real["by_kernel"] == meta["by_kernel"]
          and meta["by_kernel"]["flash_attention"]["launches"] == launches,
          f"dry run (b): kernel calls {real['by_kernel']} against {meta['by_kernel']}")
    check(recorded["launches"]["flash_attention"] == launches
          and not any(recorded["plain_calls"].values()),
          f"dry run (b): counters {recorded}")
    check(real["link_bytes"] == 0 and meta["link_bytes"] == 0,
          f"dry run (b): link bytes {real['link_bytes']} / {meta['link_bytes']}")
    mem = rec["memory"]
    out["train"] = {"meta": meta, "card": real, "row": row, "step_s": step_s,
                    "max_memory_allocated": peak, "memory": mem}
    print(f"dry run (b) {TRAIN_ARCH} x{TRAIN_LAYERS} {TRAIN_BATCH}x{TRAIN_SEQ} adamw: meta trace "
          f"= card step: {meta['flops']:.6e} FLOP ({meta['matmul_flops']:.6e} in products), "
          f"{meta['hbm_bytes']:.6e} B over {meta['n_ops']} ops, flash_attention "
          f"{meta['by_kernel']['flash_attention']['launches']} calls; roofline (989 TFLOP/s, "
          f"3.35 TB/s): t_compute {row['t_compute']:.4f} s, t_memory {row['t_memory']:.4f} s, "
          f"t_collective {row['t_collective']:.4f} s, step {row['est_step_time']:.4f} s against "
          f"a measured step of {step_s:.4f} s; peak {mem['peak_bytes']} B predicted "
          f"(arguments {mem['argument_bytes']}) against max_memory_allocated {peak} card={card}")
    del state, batch, cm
    gc.collect()
    torch.cuda.empty_cache()
    results["dryrun"] = out
    return out


def first_gap(model, prompts, tokens, row: int, t: int) -> tuple[float, float]:
    """`model`'s (unsharded) top-two logit gap and top logit for `row` at
    greedy step `t`, teacher-forced with `tokens`' first t steps."""
    import torch
    from repro_torch.models import lm
    from repro_torch.serve import cv_engine

    cfg = model.cfg
    B, S = prompts.shape
    with torch.inference_mode():
        lg, pc = lm.prefill(model, prompts)
        cache = cv_engine._adopt_prefill(
            lm.init_cache(cfg, B, S + t + 1, device=prompts.device), pc, cfg)
        for i in range(t):
            lg, cache = lm.decode_step(model, tokens[:, i : i + 1], cache)
    top = torch.topk(lg[row].float(), 2).values
    return float(top[0] - top[1]), float(top[0])


def shard_phase(card: str, path_counts: dict, results: dict) -> dict:
    """Phase 13, the sharded LM stack, in a process of its own
    (`shard_phase_main`, one NCCL rank by torchrun's environment on
    ``tcp://127.0.0.1``; its (b) spawns two more): its report lines
    printed, its counters added to the main path's."""
    import gc
    import os

    import torch
    from repro_torch.launch.mesh import free_port

    gc.collect()
    torch.cuda.empty_cache()
    env = dict(os.environ, WORLD_SIZE="1", RANK="0", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()))
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--shard-phase"],
                          capture_output=True, text=True, timeout=900, env=env)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line)
    check(proc.returncode == 0 and bool(lines),
          f"the sharded phase failed ({proc.returncode}): {proc.stderr[-3000:]}")
    out = json.loads(lines[-1])
    a = out["a"]
    path_counts[f"train {TRAIN_ARCH} x{TRAIN_LAYERS} adamw sharded (1, 1)"] = a["train"]["counters"]
    path_counts[f"generate {LM_ARCH} sharded (1, 1)"] = a["generate"]["counters"]
    path_counts[f"forward + backward deepseek-v3-671b reduced sharded (2, 1) gloo"] = (
        out["b"]["counters"])
    for tag, run in out["c"].items():
        path_counts[f"{tag} sharded (1, 2) gloo"] = run["counters"]
    for part in ("d", "e"):
        for tag, run in out[part].items():
            path_counts[f"{tag} sharded (1, 2) gloo"] = run["counters"]
    results["shard"] = out
    return out


def shard_phase_main() -> int:
    """``chip_smoke.py --shard-phase`` (run by `shard_phase`): (a) to (e),
    their lines printed, then one JSON line."""
    import os

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    os.environ["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    out = {"a": shard_one(torch.device("cuda"), card), "b": shard_two(card),
           "c": shard_axis(card), "d": shard_decode(card), "e": shard_ssm(card)}
    print(json.dumps(out, default=str))
    return 0


def shard_one(dev, card: str) -> dict:
    """(a): one NCCL rank, a (1, 1) mesh: training through the launcher
    against the same steps unsharded, then `generate` with ``mesh=``."""
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.kernels import counters
    from repro_torch.launch import train as launch_train
    from repro_torch.models import lm
    from repro_torch.serve.cv_engine import generate
    from repro_torch.train import loop

    out: dict = {}
    cfg = get_config(TRAIN_ARCH, n_layers=TRAIN_LAYERS)
    n_attn = attention_applications(cfg)
    tag = f"train {cfg.name} x{TRAIN_LAYERS} adamw sharded"
    argv = ["--arch", TRAIN_ARCH, "--layers", str(TRAIN_LAYERS), "--steps", str(SHARD_STEPS),
            "--seq", str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH), "--lr", str(TRAIN_LR),
            "--warmup", "1", "--model-parallel", "1"]
    torch.cuda.reset_peak_memory_stats(dev)
    counters.reset()
    state, hist = launch_train.main(argv)
    snap = counters.snapshot()
    mesh = state["model"].mesh
    check(dist.get_backend() == "nccl" and tuple(mesh.shape) == (1, 1)
          and mesh.mesh_dim_names == ("data", "model"),
          f"{tag}: mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} over {dist.get_backend()}")
    check(type(state["model"].embed).__name__ == "DTensor", f"{tag}: the parameters are no DTensors")
    expect_counts(tag, snap, {"flash_attention": 2 * n_attn * SHARD_STEPS})
    check(snap["backward_calls"]["flash_attention"] == n_attn * SHARD_STEPS,
          f"{tag}: plain backward calls {snap['backward_calls']}")
    peak = torch.cuda.max_memory_allocated(dev)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    # the same steps unsharded: phase 12 (a)'s code path on the launcher's stream
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats(dev)
    state, ref = loop.train(cfg, stream, steps=SHARD_STEPS, peak_lr=TRAIN_LR, warmup=1,
                            log_every=1, async_save=False, device=dev, log=lambda m: None)
    peak_ref = torch.cuda.max_memory_allocated(dev)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    losses, losses_ref = [h["loss"] for h in hist], [h["loss"] for h in ref]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, losses_ref))
    out["train"] = {"losses": losses, "losses_unsharded": losses_ref, "loss_rel": rel,
                    "step_s": [h["seconds"] for h in hist],
                    "step_s_unsharded": [h["seconds"] for h in ref],
                    "max_memory_allocated": peak, "max_memory_allocated_unsharded": peak_ref,
                    "counters": snap}
    print(f"{tag} (1, 1) NCCL through launch.train: losses={losses} against unsharded "
          f"{losses_ref} (rel {rel:.3g}, bound {GRAD_BF16_LOSS_RTOL:.3g}); step_s="
          f"{out['train']['step_s']} (unsharded {out['train']['step_s_unsharded']}); "
          f"max_memory_allocated={peak} (unsharded {peak_ref}); launches={snap_nonzero(snap)} "
          f"backward_calls={snap['backward_calls']} card={card}")
    check(rel <= GRAD_BF16_LOSS_RTOL, f"{tag}: the sharded losses differ by {rel}")

    # generate with mesh= on the published model, against the unsharded generate
    cfg_g = get_config(LM_ARCH)
    model = lm.LM(cfg_g, device=dev, generator=torch.Generator(dev).manual_seed(0))
    rng = np.random.default_rng(5)
    prompts = torch.from_numpy(rng.integers(0, cfg_g.vocab_size, (LM_BATCH, LM_PROMPT))).to(dev)
    want = generate(model, prompts, steps=SHARD_GEN, device=dev)
    lm.shard_model(model, mesh)
    counters.reset()
    t0 = time.perf_counter()
    got = generate(model, prompts, steps=SHARD_GEN, device=dev, mesh=mesh)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    snap = counters.snapshot()
    expect_counts(f"generate {LM_ARCH} sharded", snap,
                  {"flash_attention": attention_applications(cfg_g)})
    rows = [int(r) for r in torch.nonzero((got != want).any(1)).flatten()]
    gaps = []
    if rows:  # the unsharded weights are the sharded ones' local parts: a one-rank mesh
        ref_model = lm.LM(cfg_g, device="meta")
        ref_model.load_state_dict({n: p.to_local() for n, p in model.state_dict().items()},
                                  assign=True)
        for r in rows:
            t = int(torch.nonzero(got[r] != want[r])[0])
            gap, top = first_gap(ref_model, prompts, want, r, t)
            gaps.append(gap)
            check(gap <= 4 * 2.0**-8 * abs(top),
                  f"generate {LM_ARCH} sharded: row {r} differs at step {t} off a near-tie "
                  f"(gap {gap}, top logit {top})")
    out["generate"] = {"rows_differing": rows, "near_tie_gaps": gaps, "wall_s": wall,
                       "counters": snap}
    print(f"generate {LM_ARCH} sharded (1, 1) {LM_BATCH} x {LM_PROMPT} + {SHARD_GEN}: "
          f"{len(rows)} of {LM_BATCH} rows differ from the unsharded generate (near-ties, gaps "
          f"{gaps}); wall_s={wall:.3f} (first call); launches={snap_nonzero(snap)} card={card}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    return out


def shard_two(card: str) -> dict:
    """(b): `SHARD_RANKS` gloo ranks on the one card (`shard_two_rank`)."""
    import tempfile

    import torch.multiprocessing as mp
    from repro_torch.launch.mesh import free_port

    with tempfile.TemporaryDirectory() as d:
        mp.spawn(shard_two_rank, args=(d, free_port(), card), nprocs=SHARD_RANKS)
        return json.loads(Path(d, "b.json").read_text())


def shard_two_rank(rank: int, d: str, port: int, card: str) -> None:
    """One rank of (b): reduced deepseek-v3-671b in f32 on a (2, 1) mesh of
    two gloo ranks on the one card, against one rank's unsharded run."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import reduced_config
    from repro_torch.kernels import counters
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm, moe
    from repro_torch.sharding import comm, rules
    from repro_torch.train import step as tstep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=SHARD_RANKS, timeout=datetime.timedelta(seconds=300))
    dev = torch.device("cuda", 0)
    mesh = make_mesh((SHARD_RANKS, 1), ("data", "model"), device=dev, backend="gloo")
    cfg = reduced_config("deepseek-v3-671b").replace(dtype="float32")
    model = lm.make_trainable(lm.LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0)))
    g = torch.Generator(dev).manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (SHARD_B, SHARD_S), generator=g, device=dev)
             for k in ("tokens", "labels")}
    with torch.no_grad():
        logits_1, _ = lm.forward(model, batch["tokens"])
    loss_1, _ = tstep.loss_fn(model, batch)
    loss_1.backward()
    grads_1 = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    lm.shard_model(model, mesh)
    hint = rules.make_hint(mesh, cfg)
    plan = moe._a2a_plan(mesh, cfg, (SHARD_B, SHARD_S, cfg.d_model), None)
    check(plan is not None and plan["a2a_axes"] == ("data", "model") and plan["n_ep"] == 2,
          f"shard (b): the all-to-all plan is {plan}")
    counters.reset()
    logits, _ = lm.forward(model, batch["tokens"], hint=hint)
    loss, _ = tstep.loss_fn(model, batch, hint=hint)
    (loss / SHARD_RANKS).backward()
    torch.cuda.synchronize(dev)
    snap = counters.snapshot()
    logits = comm.all_gather(logits.detach(), 0, comm.axes_group(mesh, ("data",)))
    logits_err = float((logits - logits_1).abs().max())
    grad_err, worst = 0.0, None
    for n, p in model.named_parameters():
        if p.grad is not None:
            # the port's own gather: DTensor's (`full_tensor`) crashed with
            # SIGSEGV over gloo on CUDA tensors (torch 2.11 on an H100)
            full = comm.full(p.grad.to_local(), mesh, p.grad.placements)
            e = float((full - grads_1[n]).abs().max())
            if e >= grad_err:
                grad_err, worst = e, n
    if rank == 0:
        res = {"logits_err": logits_err, "grad_err": grad_err, "worst": worst,
               "plan": {k: plan[k] for k in ("a2a_axes", "L", "C", "n_ep")}, "counters": snap}
        print(f"forward + backward {cfg.name} reduced f32 sharded (2, 1) over {SHARD_RANKS} gloo "
              f"ranks on one card, {SHARD_B} x {SHARD_S}: all-to-all plan {res['plan']}; logits "
              f"within {logits_err:.3g} (bound {SHARD_LOGITS_TOL}), gradients within "
              f"{grad_err:.3g} ({worst}; bound {SHARD_GRAD_TOL}) of one rank's; launches="
              f"{snap_nonzero(snap)} card={card}", flush=True)
        Path(d, "b.json").write_text(json.dumps(res, default=str))
    check(logits_err <= SHARD_LOGITS_TOL and grad_err <= SHARD_GRAD_TOL,
          f"shard (b): logits off by {logits_err}, gradients by {grad_err} ({worst})")
    dist.barrier()
    dist.destroy_process_group()



def shard_axis(card: str) -> dict:
    """(c): the model axis on a (1, 2) mesh of two gloo ranks on the one
    card (`shard_axis_rank`)."""
    import tempfile

    import torch.multiprocessing as mp
    from repro_torch.launch.mesh import free_port

    with tempfile.TemporaryDirectory() as d:
        mp.spawn(shard_axis_rank, args=(d, free_port(), card), nprocs=2)
        return json.loads(Path(d, "c.json").read_text())


def rms(t) -> float:
    return float(t.float().pow(2).mean().sqrt())


def share_off(got, want) -> tuple[float, float]:
    """(the share of `got`'s entries outside `AGREE` of `want`'s at
    `want`'s dtype, the largest |got - want|)."""
    from repro_torch.kernels import attention as kattn

    rtol, atol = kattn.AGREE[want.dtype]
    w = want.float()
    diff = (got.float() - w).abs()
    return float((diff > atol + rtol * w.abs()).float().mean()), float(diff.max())


def shard_axis_rank(rank: int, d: str, port: int, card: str, device: str = "cuda") -> None:
    """One rank of (c): each of `SHARD_AXIS_RUNS` at full width, its bf16
    prefill sharded against this rank's unsharded prefill of the same model:
    the rank's slots of layer 0's K cache (at most `OFF_PLAIN_SHARE` of entries outside
    `AGREE`), the last position's logits (their RMS distance within
    `SHARD_AXIS_RMS` x the unsharded's to the same weights widened to f32;
    "sp": at most `OFF_PLAIN_SHARE` outside `AGREE`; "tp" rounds a
    row-parallel product's partial sums to bf16 before it adds them, so its
    logits are another bf16 rounding of the same function), their largest
    error against the f32 model within twice the unsharded's, the attention
    layers' launches and no plain call; then each of `SHARD_AXIS_TRAIN`'s
    f32 models against the same model unsharded: the logits, the loss's
    gradients (whole), and one AdamW step's loss and parameters.  `device`
    "cpu" rehearses it on the CPU."""
    import datetime
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels import attention as kattn
    from repro_torch.kernels import counters
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.sharding import comm, rules
    from repro_torch.train import step as tstep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=300))
    mesh = make_mesh((1, 2), ("data", "model"), device=dev, backend="gloo")
    res: dict = {}
    for arch, layers, layout in SHARD_AXIS_RUNS:
        cfg = get_config(arch, n_layers=layers)
        tag = (f"prefill {arch} x{cfg.n_layers} {cfg.dtype} {SHARD_AXIS_B} x {SHARD_AXIS_S} "
               f"{layout}")
        check(rules.model_layout(cfg, mesh, SHARD_AXIS_S) == layout, f"{tag}: the layout")
        model = lm.LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
        rng = np.random.default_rng(7)
        prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                (SHARD_AXIS_B, SHARD_AXIS_S))).to(dev)
        with torch.inference_mode():
            want, cache_1 = lm.prefill(model, prompts)
        k_1 = cache_1["groups"][0]["k"][0].clone()
        del cache_1
        lm.shard_model(model, mesh)
        hint = rules.make_hint(mesh, cfg)
        torch.cuda.synchronize(dev)
        counters.reset()
        t0 = time.perf_counter()
        with torch.inference_mode():
            got, cache = lm.prefill(model, prompts, hint=hint)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        snap = counters.snapshot()
        # the rank's slots of layer 0's K (`rules.cache_specs`: time over "model")
        k_got = cache["groups"][0]["k"][0]
        n = k_got.shape[1]
        k_off, k_err = share_off(k_got, k_1.narrow(1, hint.model_rank * n, n))
        n_attn = attention_applications(cfg)
        expect_counts(tag, snap, {"flash_attention": n_attn})
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        del model, cache, k_1
        gc.collect()
        torch.cuda.empty_cache()
        # the same weights widened to f32, unsharded: the bf16 model's own error
        model = lm.LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0)).float()
        with torch.inference_mode():
            ref, _ = lm.prefill(model, prompts)
        l_off, l_err = share_off(got, want)
        l_rms, own_rms = rms(got.float() - want.float()), rms(want.float() - ref)
        err = float((got.float() - ref).abs().max())
        own = float((want.float() - ref).abs().max())
        check(bool(torch.isfinite(got).all()) and l_rms <= SHARD_AXIS_RMS * own_rms
              and (layout != "sp" or l_off <= kattn.OFF_PLAIN_SHARE)
              and k_off <= kattn.OFF_PLAIN_SHARE and err <= 2 * own,
              f"{tag}: logits {l_rms:.3g} RMS off the unsharded's (its own {own_rms:.3g} off "
              f"the f32 model's), {l_off:.3g} outside AGREE (max_abs_err {l_err:.3g}); "
              f"{err:.3g} off the f32 model's (the unsharded's own {own:.3g}); {k_off:.3g} of "
              f"layer 0's K off the unsharded")
        res[tag] = {"logits_rms": l_rms, "own_rms_f32": own_rms, "logits_off": l_off,
                    "logits_max_abs_err": l_err, "logits_err_f32": err, "own_err_f32": own,
                    "k_off": k_off, "k_max_abs_err": k_err, "wall_s": wall, "counters": snap,
                    "max_memory_allocated": peak}
        if rank == 0:
            print(f"{tag} sharded (1, 2) over 2 gloo ranks on one card: last-position logits "
                  f"{l_rms:.4g} RMS off the unsharded's (bound {SHARD_AXIS_RMS:.4f} x its own "
                  f"{own_rms:.4g} off the f32-widened model's), {l_off:.5f} outside AGREE of "
                  f"them (max_abs_err {l_err:.3g}; limit {kattn.OFF_PLAIN_SHARE} for sp), "
                  f"{err:.3g} max off the f32-widened model's (the unsharded bf16's own "
                  f"{own:.3g}; bound twice that), layer 0's K {k_off:.5f} "
                  f"outside AGREE of the unsharded "
                  f"(max_abs_err {k_err:.3g}; limit {kattn.OFF_PLAIN_SHARE}); wall_s={wall:.3f} "
                  f"max_memory_allocated={peak} launches={snap_nonzero(snap)} card={card}",
                  flush=True)
        del model, want, got, ref
        gc.collect()
        torch.cuda.empty_cache()
    g = torch.Generator(dev).manual_seed(2)
    for arch, kw, layout in SHARD_AXIS_TRAIN:
        cfg = reduced_config(arch).replace(dtype="float32", **kw)
        tag = f"train {arch} reduced f32 {SHARD_AXIS_TRAIN_B} x {SHARD_AXIS_TRAIN_S} {layout}"
        check(rules.model_layout(cfg, mesh, SHARD_AXIS_TRAIN_S) == layout, f"{tag}: the layout")
        batch = {k: torch.randint(0, cfg.vocab_size, (SHARD_AXIS_TRAIN_B, SHARD_AXIS_TRAIN_S),
                                  generator=g, device=dev) for k in ("tokens", "labels")}

        def one_step(mesh_):
            model = lm.LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
            state = tstep.init_state(cfg, device=dev, model=model, mesh=mesh_)
            hint = None if mesh_ is None else rules.make_hint(mesh_, cfg)
            with torch.no_grad():
                logits, _ = lm.forward(model, batch["tokens"], hint=hint)
            # the loss's gradients, whole: AdamW's first step is ~lr sign(g),
            # blind to a gradient counted m times over the model axis
            loss, _ = tstep.loss_fn(model, batch, hint=hint)
            (loss / (1 if mesh_ is None else dist.get_world_size())).backward()
            grads = {n: (comm.full(p.grad.to_local(), mesh_, p.grad.placements)
                         if mesh_ is not None else p.grad).detach().clone()
                     for n, p in model.named_parameters() if p.grad is not None}
            model.zero_grad(set_to_none=True)
            fn = tstep.make_train_step(cfg, mesh_, peak_lr=1e-3, warmup=1)
            counters.reset()
            state, m = fn(state, batch)
            torch.cuda.synchronize(dev)
            snap = counters.snapshot()
            with torch.no_grad():
                params = {n: (comm.full(p.to_local(), mesh_, p.placements) if mesh_ is not None
                              else p).detach() for n, p in state["model"].named_parameters()}
            return logits, grads, float(m["loss"]), params, snap

        logits_1, grads_1, loss_1, params_1, _ = one_step(None)
        logits, grads, loss, params, snap = one_step(mesh)
        l_err = float((logits - logits_1).abs().max())
        check(grads.keys() == grads_1.keys(), f"{tag}: the gradients' leaves")
        g_err, worst = max((float((grads[n] - grads_1[n]).abs().max()), n) for n in grads_1)
        p_err = max(float((params[n] - params_1[n]).abs().max()) for n in params_1)
        # the forward, and again under remat
        n_attn = attention_applications(cfg) * (2 if cfg.remat else 1)
        expect_counts(tag, snap, {"flash_attention": n_attn})
        check(l_err <= SHARD_LOGITS_TOL and g_err <= SHARD_GRAD_TOL
              and abs(loss - loss_1) <= SHARD_LOSS_TOL and p_err <= SHARD_PARAM_TOL,
              f"{tag}: logits {l_err}, gradients {g_err} ({worst}), loss {abs(loss - loss_1)}, "
              f"parameters {p_err} off")
        res[tag] = {"logits_err": l_err, "grad_err": g_err, "grad_worst": worst, "loss": loss,
                    "loss_unsharded": loss_1, "param_err": p_err, "counters": snap}
        if rank == 0:
            print(f"{tag} sharded (1, 2) over 2 gloo ranks on one card, one AdamW step: logits "
                  f"within {l_err:.3g} (bound {SHARD_LOGITS_TOL}), the loss's gradients within "
                  f"{g_err:.3g} ({worst}; bound {SHARD_GRAD_TOL}), loss {loss:.7f} against "
                  f"{loss_1:.7f} (bound {SHARD_LOSS_TOL}), parameters within {p_err:.3g} (bound "
                  f"{SHARD_PARAM_TOL}); launches={snap_nonzero(snap)} "
                  f"backward_calls={snap['backward_calls']} card={card}", flush=True)
    if rank == 0:
        Path(d, "c.json").write_text(json.dumps(res, default=str))
    dist.barrier()
    dist.destroy_process_group()


def shard_decode(card: str) -> dict:
    """(d): decode over the model axis on a (1, 2) mesh of two gloo ranks on
    the one card (`shard_decode_rank`)."""
    import tempfile

    import torch.multiprocessing as mp
    from repro_torch.launch.mesh import free_port

    with tempfile.TemporaryDirectory() as d:
        mp.spawn(shard_decode_rank, args=(d, free_port(), card), nprocs=2)
        return json.loads(Path(d, "d.json").read_text())


def decode_logits(model, cfg, prompts, tokens, extras=None, mesh=None, times=None, first=None):
    """`model` prefilled with `prompts` and decoded teacher-forced with
    `tokens` (B, n), on `mesh` (a `shard_model` model: every rank's rows
    over the model axis) or unsharded -> each step's logits (n, B, V) in
    the model's dtype; each step's time appended to `times`, the prefill's
    last logits (B, V) to `first`."""
    import torch
    from repro_torch.models import lm
    from repro_torch.serve import cv_engine
    from repro_torch.sharding import rules

    B, S = prompts.shape
    n = tokens.shape[1]
    dev = prompts.device
    hint = rules.make_hint(mesh, cfg) if mesh is not None else None
    with torch.inference_mode():
        last, pc = lm.prefill(model, prompts, extras=extras, hint=hint)
        if first is not None:
            first.append(last)
        cache = lm.init_cache(cfg, B, S + n, ctx_len=lm.context_len(cfg, extras, B), device=dev,
                              mesh=mesh)
        cache = cv_engine._adopt_prefill(cache, pc, cfg, mesh=mesh)
        del pc
        out = []
        for t in range(n):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            lg, cache = lm.decode_step(model, tokens[:, t : t + 1], cache, hint=hint)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            if times is not None:
                times.append(time.perf_counter() - t0)
            out.append(lg)
    return torch.stack(out)


def gather_prefill_routes(calls: list, group) -> list:
    """A sharded run's routing calls with each prefill call's slices of the
    sequence (S > 1: the all-to-all path's) gathered over the model axis."""
    from repro_torch.sharding import comm

    return [(s, i) if i.shape[1] == 1 else
            (comm.all_gather(s, 1, group), comm.all_gather(i, 1, group)) for s, i in calls]


def widen_parts(model) -> None:
    """Each DTensor parameter's local part widened to f32, in place, one
    at a time."""
    import torch
    from torch.distributed.tensor import DTensor

    for mod in model.modules():
        for name, p in list(mod._parameters.items()):
            mod._parameters[name] = torch.nn.Parameter(DTensor.from_local(
                p.to_local().float(), p.device_mesh, p.placements, run_check=False),
                requires_grad=False)


def shard_decode_rank(rank: int, d: str, port: int, card: str, device: str = "cuda") -> None:
    """One rank of (d): each of `SHARD_DECODE_RUNS` at full width, its bf16
    decode sharded against rank 0's unsharded and f32-widened decodes of
    the same model (rank 1 waits while rank 0 runs them, and the ranks
    draw the model to shard one at a time, so that a whole model fits
    beside nothing but the other rank's parts): every step's logits RMS
    within `SHARD_AXIS_RMS` x the unsharded's own distance to the
    f32-widened model's, their largest error against it within twice the
    unsharded's; an MoE arch widened to f32 on both sides, within
    `SHARD_DECODE_F32_TOL` on its rows whose routing agrees at every call
    (`judge_routes`); the kernel's launches (the prefill's attention
    applications, then one a cross-attention layer a step) and no plain
    call, each step's time and each rank's peak memory above its model's
    parts (below one whole expert stack's bytes for the MoE arch); then each
    of `SHARD_DECODE_TWINS` in f32 within `SHARD_LOGITS_TOL`.  `device`
    "cpu" rehearses it on the CPU."""
    import datetime
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels import attention as kattn
    from repro_torch.kernels import counters
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import make_extras
    from repro_torch.models import lm
    from repro_torch.sharding import comm, rules

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=900))
    mesh = make_mesh((1, 2), ("data", "model"), device=dev, backend="gloo")
    seq = comm.axes_group(mesh, ("model",))
    res: dict = {}

    def free():
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    for arch, layers, layout, S, B in SHARD_DECODE_RUNS:
        cfg = get_config(arch, n_layers=layers) if layers else get_config(arch)
        n = SHARD_DECODE_STEPS
        tag = f"decode {arch} x{cfg.n_layers} {cfg.dtype} {B} x ({S} + {n}) {layout}"
        check(rules.decode_layout(cfg, mesh) == layout, f"{tag}: the layout")
        rng = np.random.default_rng(9)
        prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(dev)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, n))).to(dev)
        extras = (make_extras(cfg, B, S, generator=torch.Generator(dev).manual_seed(3),
                              device=dev) if lm.context_input(cfg) else None)

        def build():
            model = lm.LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
            set_gates(model)
            return model

        widen = cfg.moe is not None
        run_cfg = cfg.replace(dtype="float32") if widen else cfg
        times_one: list = []
        if rank == 0:  # the unsharded bf16 decode, then the same weights widened to f32
            model = build()
            if not widen:
                want = decode_logits(model, cfg, prompts, tokens, extras, times=times_one)
            model.float()
            with RouteRecorder() as r_f32:
                ref = decode_logits(model, cfg.replace(dtype="float32"), prompts, tokens,
                                    extras).float()
            del model
            free()
        dist.barrier()
        for r in range(2):  # one rank at a time draws the whole model and keeps its parts
            if rank == r:
                model = build()
                lm.shard_model(model, mesh)
                if widen:
                    widen_parts(model)
                free()
            dist.barrier()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
        counters.reset()
        times: list = []
        with RouteRecorder() as r_got:
            got = decode_logits(model, run_cfg, prompts, tokens, extras, mesh=mesh, times=times)
        snap = counters.snapshot()
        peak = torch.cuda.max_memory_allocated(dev) - base if dev.type == "cuda" else 0
        expect_counts(tag, snap, {"flash_attention": kernel_applications(cfg, S)
                                  + n * cross_applications(cfg)})
        stack = (cfg.moe.n_experts * cfg.d_model * cfg.moe.d_ff_expert
                 * run_cfg.param_dtype.itemsize if widen else None)
        if stack is not None:
            check(peak < stack, f"{tag}: rank {rank}'s decode peaks {peak} B above its model, "
                                f"a whole expert stack is {stack} B")
        got_calls = gather_prefill_routes(r_got.calls, seq)
        peaks = [None, None]
        dist.all_gather_object(peaks, peak)
        del model
        free()
        if rank == 0 and widen:
            keep, _ = judge_routes(r_f32.calls, got_calls, cfg.moe.top_k,
                                   f"{tag} f32-widened, sharded against unsharded")
            check(bool(keep.any()), f"{tag}: no row's routing agrees")
            err = float((got[:, keep].float() - ref[:, keep]).abs().max())
            check(bool(torch.isfinite(got).all()) and err <= SHARD_DECODE_F32_TOL,
                  f"{tag}: f32 logits {err:.3g} off the unsharded's")
            res[tag] = {"logits_err_f32": err, "rows_compared": int(keep.sum()), "step_s": times,
                        "decode_peak_bytes": peaks, "counters": snap}
            print(f"{tag} widened to f32, sharded (1, 2) over 2 gloo ranks on one card, {n} "
                  f"teacher-forced steps: logits within {err:.3g} of the unsharded f32 decode's "
                  f"(bound {SHARD_DECODE_F32_TOL}) on the {int(keep.sum())} of {B} rows whose "
                  f"routing agrees; step_s={[round(t, 5) for t in times]} card={card}; peak above "
                  f"the model's parts {peaks} B a rank (a whole expert stack {stack} B); "
                  f"launches={snap_nonzero(snap)}", flush=True)
            del ref
        elif rank == 0:
            l_off, l_err = share_off(got, want)
            l_rms, own_rms = rms(got.float() - want.float()), rms(want.float() - ref)
            err = float((got.float() - ref).abs().max())
            own = float((want.float() - ref).abs().max())
            check(bool(torch.isfinite(got).all()) and l_rms <= SHARD_AXIS_RMS * own_rms
                  and err <= 2 * own,
                  f"{tag}: logits {l_rms:.3g} RMS off the unsharded's (its own {own_rms:.3g} off "
                  f"the f32 model's), {err:.3g} off the f32 model's (the unsharded's own "
                  f"{own:.3g})")
            res[tag] = {"logits_rms": l_rms, "own_rms_f32": own_rms, "logits_off": l_off,
                        "logits_max_abs_err": l_err, "logits_err_f32": err, "own_err_f32": own,
                        "step_s": times, "step_s_unsharded": times_one,
                        "decode_peak_bytes": peaks, "counters": snap}
            print(f"{tag} sharded (1, 2) over 2 gloo ranks on one card, {n} teacher-forced "
                  f"steps: logits {l_rms:.4g} RMS off the unsharded's (bound "
                  f"{SHARD_AXIS_RMS:.4f} x its own {own_rms:.4g} off the f32-widened model's), "
                  f"{l_off:.5f} outside AGREE of them (max_abs_err {l_err:.3g}), {err:.3g} max "
                  f"off the f32-widened model's (the unsharded bf16's own {own:.3g}; bound twice "
                  f"that); step_s={[round(t, 5) for t in times]} (unsharded "
                  f"{[round(t, 5) for t in times_one]}) card={card}; peak above the "
                  f"model's parts {peaks} B a rank; launches={snap_nonzero(snap)}", flush=True)
            del want, ref
        del got
        free()
        dist.barrier()
    for arch, kw, layout, S in SHARD_DECODE_TWINS:
        cfg = reduced_config(arch).replace(dtype="float32", **kw)
        n = SHARD_DECODE_STEPS
        tag = f"decode {arch} reduced f32 2 x ({S} + {n}) {layout}"
        check(rules.decode_layout(cfg, mesh) == layout, f"{tag}: the layout")
        g = torch.Generator(dev).manual_seed(4)
        prompts = torch.randint(0, cfg.vocab_size, (2, S), generator=g, device=dev)
        tokens = torch.randint(0, cfg.vocab_size, (2, n), generator=g, device=dev)
        extras = (make_extras(cfg, 2, S, generator=torch.Generator(dev).manual_seed(3),
                              device=dev) if lm.context_input(cfg) else None)
        model = lm.LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
        want = decode_logits(model, cfg, prompts, tokens, extras)
        lm.shard_model(model, mesh)
        counters.reset()
        got = decode_logits(model, cfg, prompts, tokens, extras, mesh=mesh)
        snap = counters.snapshot()
        expect_counts(tag, snap, {"flash_attention": kernel_applications(cfg, S)
                                  + n * cross_applications(cfg)})
        err = float((got - want).abs().max())
        check(err <= SHARD_LOGITS_TOL, f"{tag}: logits {err} off the unsharded's")
        res[tag] = {"logits_err": err, "counters": snap}
        if rank == 0:
            print(f"{tag} sharded (1, 2) over 2 gloo ranks on one card, {n} teacher-forced "
                  f"steps: logits within {err:.3g} of the unsharded's (bound {SHARD_LOGITS_TOL}); "
                  f"launches={snap_nonzero(snap)} card={card}", flush=True)
        del model
        free()
    if rank == 0:
        Path(d, "d.json").write_text(json.dumps(res, default=str))
    dist.barrier()
    dist.destroy_process_group()


def shard_ssm(card: str) -> dict:
    """(e): the SSD heads and ZeRO-1 on a (1, 2) mesh of two gloo ranks on
    the one card (`shard_ssm_rank`)."""
    import tempfile

    import torch.multiprocessing as mp
    from repro_torch.launch.mesh import free_port

    with tempfile.TemporaryDirectory() as d:
        mp.spawn(shard_ssm_rank, args=(d, free_port(), card), nprocs=2)
        return json.loads(Path(d, "e.json").read_text())


def ssm_run_config():
    """(e)'s zamba2-2.7b: full width, its first `SHARD_SSM_LAYERS` layers."""
    from repro_torch.configs import get_config

    return get_config("zamba2-2.7b", n_layers=SHARD_SSM_LAYERS)


def moe_run_config():
    """(e)'s deepseek-v3-671b: full width, `SHARD_MOE_BLOCKS`."""
    from repro_torch.configs import get_config

    return get_config("deepseek-v3-671b").replace(
        n_layers=sum(c for _, c in SHARD_MOE_BLOCKS), blocks=SHARD_MOE_BLOCKS)


def zero1_bytes(state: dict, cfg, mesh, optimizer: str) -> tuple[int, float]:
    """(this rank's optimizer-state bytes, `launch.dryrun.opt_bytes_zero1`)."""
    from repro_torch.launch import dryrun
    from repro_torch.models import lm
    from repro_torch.sharding import rules
    from repro_torch.train import step as tstep

    leaves = lm.param_leaves(state["model"])
    held = sum(t.numel() * t.element_size() for _, t, _ in tstep._opt_entries(state, leaves))
    return held, dryrun.opt_bytes_zero1(leaves, rules.param_specs(leaves, cfg, mesh), mesh,
                                        optimizer)


def shard_ssm_rank(rank: int, d: str, port: int, card: str, device: str = "cuda") -> None:
    """One rank of (e), the constants' comment above `SHARD_SSM_LAYERS`:
    zamba2-2.7b's bf16 prefill and decode sharded against rank 0's
    unsharded and f32-widened decodes (the ranks draw the model to shard
    one at a time), every Mamba2 scan over the rank's heads; its AdamW
    steps against rank 0's unsharded steps; deepseek-v3-671b's Adafactor
    steps and each rank's peak; each optimizer state's bytes; the
    launches and no plain call; then the f32 reduced twins.  `device`
    "cpu" rehearses it on the CPU (the run configs replaced)."""
    import dataclasses
    import datetime
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import reduced_config
    from repro_torch.kernels import counters
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm, ssm
    from repro_torch.sharding import comm, rules
    from repro_torch.train import step as tstep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=900))
    mesh = make_mesh((1, 2), ("data", "model"), device=dev, backend="gloo")
    res: dict = {}
    cuda = dev.type == "cuda"

    def free():
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def one_at_a_time(build):
        """Each rank in turn draws the whole model and keeps its parts."""
        model = None
        for r in range(2):
            if rank == r:
                model = lm.shard_model(build(), mesh)
                free()
            dist.barrier()
        return model

    def full(p):
        return comm.full(p.to_local(), mesh, p.placements).detach()

    def train(cfg, model, batch, optimizer, mesh_, peak_lr=TRAIN_LR):
        """`SHARD_TRAIN_STEPS` steps -> (losses, step seconds, the state)."""
        state = tstep.init_state(cfg, optimizer=optimizer, device=dev, model=model, mesh=mesh_)
        fn = tstep.make_train_step(cfg, mesh_, optimizer=optimizer, peak_lr=peak_lr, warmup=1)
        losses, secs = [], []
        for _ in range(SHARD_TRAIN_STEPS):
            sync()
            t0 = time.perf_counter()
            state, m = fn(state, batch)
            sync()
            secs.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
        return losses, secs, state

    # -- zamba2-2.7b: the SSD heads over "model" ---------------------------------
    cfg = ssm_run_config()
    B, S, n = SHARD_SSM_B, SHARD_SSM_S, SHARD_SSM_STEPS
    tag = f"prefill + decode {cfg.name} x{cfg.n_layers} {cfg.dtype} {B} x ({S} + {n}) ssm_heads"
    layout = rules.model_layout(cfg, mesh, S)
    check(rules.ssm_heads(cfg, mesh, layout), f"{tag}: the SSD heads do not split ({layout})")
    rng = np.random.default_rng(11)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).to(dev)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, n))).to(dev)

    def build():
        return lm.LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))

    if rank == 0:  # the unsharded bf16 decode, then the same weights widened to f32
        model = build()
        first_1, times_1 = [], []
        want = decode_logits(model, cfg, prompts, tokens, times=times_1, first=first_1)
        model.float()
        first_f32 = []
        ref = decode_logits(model, cfg.replace(dtype="float32"), prompts, tokens,
                            first=first_f32).float()
        del model
        free()
    dist.barrier()
    model = one_at_a_time(build)
    mixer = lm._at(model.blocks[0], rules.make_hint(mesh, cfg).at(S))["mixer"]
    rows = tuple(mixer["out_proj"].shape)
    del mixer
    check(rows == (cfg.ssm.d_inner // 2, cfg.d_model), f"{tag}: out_proj read as {rows}")
    scan, heads = ssm.ssd_scan, []

    def scanned(x, *args, **kwargs):  # the heads of every scan this rank runs
        heads.append(x.shape[2])
        return scan(x, *args, **kwargs)

    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev) if cuda else 0
    counters.reset()
    ssm.ssd_scan = scanned
    times, first = [], []
    try:
        got = decode_logits(model, cfg, prompts, tokens, mesh=mesh, times=times, first=first)
    finally:
        ssm.ssd_scan = scan
    snap = counters.snapshot()
    peak = torch.cuda.max_memory_allocated(dev) - base if cuda else 0
    n_mamba = sum(c for k, c in cfg.blocks if k == "mamba")
    check(heads == [cfg.ssm.n_heads // 2] * n_mamba,
          f"{tag}: the prefill's scans ran over {heads} heads")
    expect_counts(tag, snap, {"flash_attention": kernel_applications(cfg, S)})
    peaks = [None, None]
    dist.all_gather_object(peaks, peak)
    if rank == 0:
        stats = {}
        for what, g, w, r in (("prefill", first[0][None], first_1[0][None], first_f32[0]),
                              ("decode", got, want, ref)):
            l_off, l_err = share_off(g, w)
            l_rms, own_rms = rms(g.float() - w.float()), rms(w.float() - r.float())
            err, own = float((g.float() - r.float()).abs().max()), float(
                (w.float() - r.float()).abs().max())
            check(bool(torch.isfinite(g).all()) and l_rms <= SHARD_AXIS_RMS * own_rms
                  and err <= 2 * own,
                  f"{tag}: {what} logits {l_rms:.3g} RMS off the unsharded's (its own "
                  f"{own_rms:.3g} off the f32 model's), {err:.3g} off the f32 model's (the "
                  f"unsharded's own {own:.3g})")
            stats[what] = {"logits_rms": l_rms, "own_rms_f32": own_rms, "logits_off": l_off,
                           "logits_max_abs_err": l_err, "logits_err_f32": err,
                           "own_err_f32": own}
        res[tag] = {**stats, "scan_heads": heads, "out_proj": rows, "step_s": times,
                    "step_s_unsharded": times_1, "peak_bytes": peaks, "counters": snap}
        print(f"{tag} sharded (1, 2) over 2 gloo ranks on one card, {n} teacher-forced steps: "
              + "; ".join(f"{w} logits {v['logits_rms']:.4g} RMS off the unsharded's (bound "
                          f"{SHARD_AXIS_RMS:.4f} x its own {v['own_rms_f32']:.4g} off the "
                          f"f32-widened model's), {v['logits_off']:.5f} outside AGREE, "
                          f"{v['logits_err_f32']:.3g} max off the f32 model's (the unsharded's "
                          f"own {v['own_err_f32']:.3g}; bound twice that)"
                          for w, v in stats.items())
              + f"; every scan over {heads[0]} of {cfg.ssm.n_heads} heads, out_proj {rows}; "
              f"step_s={[round(t, 5) for t in times]} (unsharded "
              f"{[round(t, 5) for t in times_1]}) card={card}; peak above the model's parts "
              f"{peaks} B a rank; launches={snap_nonzero(snap)}", flush=True)
        del want, ref
    del got, model
    free()
    dist.barrier()

    # -- zamba2-2.7b: AdamW steps, ZeRO-1 ------------------------------------------
    tag = f"train {cfg.name} x{cfg.n_layers} {cfg.dtype} {B} x {S} adamw ssm_heads"
    batch = {"tokens": prompts, "labels": torch.roll(prompts, -1, dims=1)}
    if rank == 0:
        losses_1, secs_1, state = train(cfg, build(), batch, "adamw", None)
        del state
        free()
    dist.barrier()
    model = one_at_a_time(build)
    counters.reset()
    losses, secs, state = train(cfg, model, batch, "adamw", mesh)
    snap = counters.snapshot()
    held, zero1 = zero1_bytes(state, cfg, mesh, "adamw")
    del state, model
    free()
    n_attn = train_kernel_calls(cfg, S) * SHARD_TRAIN_STEPS
    expect_counts(tag, snap, {"flash_attention": n_attn})
    check(held == zero1, f"{tag}: rank {rank} holds {held} B of optimizer state, ZeRO-1 {zero1}")
    if rank == 0:
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, losses_1))
        check(all(np.isfinite(losses)) and rel <= GRAD_BF16_LOSS_RTOL,
              f"{tag}: losses {losses} against unsharded {losses_1} (rel {rel})")
        res[tag] = {"losses": losses, "losses_unsharded": losses_1, "loss_rel": rel,
                    "step_s": secs, "step_s_unsharded": secs_1, "opt_bytes": held,
                    "opt_bytes_zero1": zero1, "counters": snap}
        print(f"{tag} sharded (1, 2) over 2 gloo ranks on one card: losses={losses} against "
              f"unsharded {losses_1} (rel {rel:.3g}, bound {GRAD_BF16_LOSS_RTOL:.3g}); "
              f"step_s={[round(t, 4) for t in secs]} (unsharded {[round(t, 4) for t in secs_1]}) "
              f"card={card}; optimizer state {held} B a rank = opt_bytes_zero1; "
              f"launches={snap_nonzero(snap)} backward_calls={snap['backward_calls']}", flush=True)
    dist.barrier()

    # -- deepseek-v3-671b: Adafactor steps, ZeRO-1, no leaf gathered whole ---------
    cfg = moe_run_config()
    B, S = SHARD_MOE_B, SHARD_MOE_S
    tag = (f"train {cfg.name} x{cfg.n_layers} ({'+'.join(k for k, _ in cfg.blocks)}) "
           f"{cfg.dtype} {B} x {S} adafactor")
    g = torch.Generator(dev).manual_seed(6)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)
             for k in ("tokens", "labels")}
    model = lm.make_trainable(one_at_a_time(
        lambda: lm.LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))))
    params = sum(p.to_local().numel() * p.to_local().element_size() for p in model.parameters())
    grads = sum(p.to_local().numel() * p.to_local().element_size()
                for p in model.parameters() if p.requires_grad)
    stack = cfg.moe.n_experts * cfg.d_model * cfg.moe.d_ff_expert * cfg.param_dtype.itemsize
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    counters.reset()
    losses, secs, state = train(cfg, model, batch, "adafactor", mesh)
    snap = counters.snapshot()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    held, zero1 = zero1_bytes(state, cfg, mesh, "adafactor")
    del state, model
    free()
    bound = params + grads + held + stack
    n_attn = train_kernel_calls(cfg, S) * SHARD_TRAIN_STEPS
    expect_counts(tag, snap, {"flash_attention": n_attn})
    check(all(np.isfinite(losses)), f"{tag}: losses {losses}")
    check(held == zero1, f"{tag}: rank {rank} holds {held} B of optimizer state, ZeRO-1 {zero1}")
    check(not cuda or peak < bound,
          f"{tag}: rank {rank} peaks at {peak} B, its parameters {params} + gradients {grads} "
          f"+ state {held} + a whole expert stack {stack} = {bound}")
    peaks = [None, None]
    dist.all_gather_object(peaks, peak)
    if rank == 0:
        res[tag] = {"losses": losses, "step_s": secs, "peak_bytes": peaks, "param_bytes": params,
                    "grad_bytes": grads, "opt_bytes": held, "opt_bytes_zero1": zero1,
                    "expert_stack_bytes": stack, "counters": snap}
        print(f"{tag} sharded (1, 2) over 2 gloo ranks on one card: losses={losses}; "
              f"step_s={[round(t, 4) for t in secs]} card={card}; peak {peaks} B a rank against "
              f"its parameters {params} + gradients {grads} + state {held} (= opt_bytes_zero1) "
              f"+ one whole expert stack {stack}; launches={snap_nonzero(snap)} "
              f"backward_calls={snap['backward_calls']}", flush=True)
    dist.barrier()

    # -- the f32 reduced twins, against the same steps unsharded --------------------
    twins = (("zamba2-2.7b", {}, "adamw"), ("deepseek-v3-671b", {}, "adafactor"))
    for arch, kw, optimizer in twins:
        cfg = reduced_config(arch).replace(dtype="float32", **kw)
        if cfg.moe is not None:
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, aux_loss_weight=0.0))
        S, n = SHARD_SSM_TWIN_S, SHARD_SSM_STEPS
        tag = f"{arch} reduced f32 2 x {S} {optimizer}"
        g = torch.Generator(dev).manual_seed(8)
        batch = {k: torch.randint(0, cfg.vocab_size, (2, S), generator=g, device=dev)
                 for k in ("tokens", "labels")}

        def build_twin():
            return lm.LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))

        out = {}
        if cfg.ssm is not None:
            check(rules.ssm_heads(cfg, mesh, rules.model_layout(cfg, mesh, S)),
                  f"{tag}: the SSD heads do not split")
            tokens = torch.randint(0, cfg.vocab_size, (2, n), generator=g, device=dev)
            want = decode_logits(build_twin(), cfg, batch["tokens"], tokens)
            got = decode_logits(lm.shard_model(build_twin(), mesh), cfg, batch["tokens"],
                                tokens, mesh=mesh)
            out["decode_err"] = float((got - want).abs().max())
            check(out["decode_err"] <= SHARD_LOGITS_TOL,
                  f"{tag}: decode logits {out['decode_err']} off the unsharded's")
        # the loss's gradients, whole: AdamW's step is ~lr sign(g), blind to a
        # gradient counted m times over the model axis
        grads = []
        for mesh_ in (None, mesh):
            model = lm.make_trainable(build_twin() if mesh_ is None
                                      else lm.shard_model(build_twin(), mesh))
            loss, _ = tstep.loss_fn(model, batch,
                                    hint=None if mesh_ is None else rules.make_hint(mesh_, cfg))
            (loss / (1 if mesh_ is None else dist.get_world_size())).backward()
            grads.append({name: (full(p.grad) if mesh_ is not None else p.grad).detach()
                          for name, p in model.named_parameters() if p.grad is not None})
            del model
        check(grads[0].keys() == grads[1].keys(), f"{tag}: the gradients' leaves")
        out["grad_err"], out["grad_worst"] = max(
            (float((grads[1][k] - grads[0][k]).abs().max()), k) for k in grads[0])
        check(out["grad_err"] <= SHARD_GRAD_TOL,
              f"{tag}: gradients {out['grad_err']} ({out['grad_worst']}) off")
        losses_1, _, state_1 = train(cfg, build_twin(), batch, optimizer, None, SHARD_TWIN_LR)
        counters.reset()
        losses, _, state = train(cfg, build_twin(), batch, optimizer, mesh, SHARD_TWIN_LR)
        snap = counters.snapshot()
        n_attn = train_kernel_calls(cfg, S) * SHARD_TRAIN_STEPS
        expect_counts(tag, snap, {"flash_attention": n_attn})
        with torch.no_grad():
            p_err, worst = max((float((full(p) - p_1).abs().max()), name) for (name, p), p_1 in zip(
                state["model"].named_parameters(), state_1["model"].parameters()))
        l_err = max(abs(a - b) for a, b in zip(losses, losses_1))
        held, zero1 = zero1_bytes(state, cfg, mesh, optimizer)
        check(l_err <= SHARD_LOSS_TOL and p_err <= SHARD_PARAM_TOL and held == zero1,
              f"{tag}: losses {l_err}, parameters {p_err} off; state {held} B against {zero1}")
        out |= {"loss_err": l_err, "param_err": p_err, "param_worst": worst, "opt_bytes": held,
                "opt_bytes_zero1": zero1, "counters": snap}
        res[tag] = out
        if rank == 0:
            print(f"{tag} sharded (1, 2) over 2 gloo ranks on one card, {SHARD_TRAIN_STEPS} "
                  f"steps against unsharded: "
                  + (f"decode logits within {out['decode_err']:.3g}, " if "decode_err" in out
                     else "")
                  + f"the loss's gradients within {out['grad_err']:.3g} ({out['grad_worst']}; "
                  f"bound {SHARD_GRAD_TOL}), losses within {l_err:.3g} (bound {SHARD_LOSS_TOL}), "
                  f"parameters within "
                  f"{p_err:.3g} ({worst}; bound {SHARD_PARAM_TOL}); state {held} B a rank = "
                  f"opt_bytes_zero1; launches={snap_nonzero(snap)} card={card}", flush=True)
        del state, state_1
        free()
    if rank == 0:
        Path(d, "e.json").write_text(json.dumps(res, default=str))
    dist.barrier()
    dist.destroy_process_group()


def train_profile_main() -> int:
    """``chip_smoke.py --train-profile`` (run by `train_phase`): one
    profiled train step of phase 12 (a)'s model and batch, after a warm-up
    step, printed as one JSON line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.train import step as tstep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config(TRAIN_ARCH, n_layers=TRAIN_LAYERS)
    state = tstep.init_state(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0))
    batch = TokenStream(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                        global_batch=TRAIN_BATCH).batch_at(0)
    step_fn = tstep.make_train_step(cfg, optimizer="adamw", peak_lr=TRAIN_LR, warmup=1,
                                    total_steps=TRAIN_STEPS)
    print(json.dumps(profile_step(step_fn, state, {k: v.to(dev) for k, v in batch.items()})))
    return 0


if __name__ == "__main__":
    ENTRIES = {"--train-profile": train_profile_main, "--shard-phase": shard_phase_main}
    sys.exit(ENTRIES[sys.argv[1]]() if sys.argv[1:2] and sys.argv[1] in ENTRIES else main())
