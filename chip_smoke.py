#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repo root; needs one CUDA device

Phases (any failed check raises, and the script exits nonzero):

1. device and build: the card's name and power limit (``nvidia-smi``), then
   the Hopper kernels built from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all started together), with each one's registers, shared memory
   and spills;
2. kernels against their plain versions on the card: ``ops.matmul`` — f32
   and bf16 at 4096^3, the ragged (96, 160, 224) and (5, 96, 20), K < 32
   and N = 4 in (64, 20, 4), rows not 16-byte aligned in (33, 131, 21) (K
   and N not multiples of 4), and at the SUMMA
   round's batched shape (16 ranks x 4096^3, f32), timed beside the plain
   version and ``torch.matmul``, with both products' errors against a
   float64 product on 2 of the 16 panels (the kernel's may be at most 2x
   ``torch.matmul``'s); its NT and TN layouts (a product's gradients)
   against the plain version at the qwen3-0.6b training step's shapes,
   timed beside ``torch.matmul`` with both products' errors against a
   float64 product, and ``ops.matmul``'s backward against
   autograd's f32 product with one launch a layout; ``ops.q4_matmul`` —
   (4, 64, 16), the ragged
   (5, 96, 20), bf16 ``a`` at (96, 256, 224), all group 32, and the lossy
   ``ag_matmul`` chunk's batched shape (8 ranks x 2048 x 7168 x 5120),
   timed beside the plain version with its share of the bound; every
   timed row prints its bound, and an f32 product row both: 3 x FLOP at the
   495 TFLOP/s TF32 tensor-core rate (3xTF32, the least time) and FLOP at
   the 67 TFLOP/s fp32 FMA rate; then the non-finite rule (csrc/tf32x3.cuh)
   for matmul (f32, bf16), q4_matmul and flash attention: infinite, NaN and
   near-max entries, each kernel against its plain version by class and
   value, with the tiles it recomputed;
3. collectives: every primitive over ``default_matrix()`` at 2^20 f32
   elements per rank — values agree across schemes, the traffic record
   prices to each scheme's ``links()``, and the measured resident result
   bytes per node give naive/shared = ranks_per_node (C1);
4. SUMMA: N = 16384 f32 on the 4x4 grid, all four schemes through the
   kernel, each within rel_err 1e-5 of ``torch.matmul``;
5. BPMF: the 2x4 grid at the MovieLens-1M shape (6040 users x 3704 items,
   4.5% observed, D = 16, 10 sweeps) — naive and hybrid give identical
   predictions and the held-out RMSE beats the zero predictor;
6. lossy collectives: ``traffic.check_lossy`` over ``default_matrix()`` at
   2^20 f32 elements per rank — every quantized wire format prices to its
   ``links()``, stays within its error bound, keeps each rank's own pod
   region exact and ``q4_shared`` one copy per node; each row's bridge
   bytes print beside its exact parent's;
7. lossy ``ag_matmul`` at the width of ``mistral-nemo-12b``'s MLP
   down-projection (K = d_ff = 14336, N = d_model = 5120) on the 1x8
   cluster: ``precision="lossy", use_kernel=True`` within rel_err 1e-5 of
   ``x @ dequantize_q4(quantize_q4(w))``, timed beside the exact
   ``ag_matmul``, with the gathered bytes of both;
8. serve: ``qwen3-0.6b`` at full width and depth (28 layers, f32, random
   weights drawn on the card from a seed) — (a) the continuous-batching
   scheduler, 8 slots, s_max 4096, 32 requests from ``SyntheticLM`` with
   prompt lengths uniform in 64-2048 and 32 new tokens each: tokens/s,
   decode step and request e2e percentiles, prefill ms per bucket, the
   flash-attention launches and the KV pages' C1 (as device bytes); (b) 4
   requests' streams against their solo ``greedy_generate`` runs: tokens,
   log-probs and every step's last-position logits row; (c) a
   2048-token prefill through the first 2 units on the card (the kernel)
   against the CPU (its plain version), last-token logits within 1e-4
   relative, then two decode steps from each side's cache, logits within
   1e-4 relative;
9. serve: ``recurrentgemma-9b`` at full width and depth (38 layers:
   ``rglru, rglru, local`` x 12 + ``rglru, rglru``, f32, 9.4e9 random
   params drawn on the card from a seed, after phase 8's model is freed) —
   (a) the scheduler, 8 slots, s_max 4096, 16 requests from ``SyntheticLM``
   with prompts of 512, 1024, 2048 and 3072 tokens (four each, shuffled),
   32 new tokens each, exact-length buckets: the same serving metrics, the
   lru_scan and flash launches (26 and 12 per prefill group) and the pages'
   C1 (ring k / v plus the recurrent ``h`` / ``conv`` state); (b) 4
   streams against their solo runs, as in phase 8, and each slot's
   ``h`` / ``conv`` state after its last step against the solo run's;
   (c) one pattern unit, a 2304-token
   prefill on the card against the CPU: last-token logits, both ``h``
   states and the ring k within 1e-4 relative; then two decode steps from
   each side's cache: logits and both blocks' ``h`` / ``conv`` within 1e-4
   relative;
10. collectives bench (run after phase 7, before phase 8, while the card
   holds no model): (a) ``repro_torch.bench``'s quick sweep over
   ``default_matrix()`` (the six collective families at 1024 and 2^20
   elements per rank, f32 and bf16, 5 reps, every body captured in a CUDA
   graph and its replays timed with CUDA events): validation OK with its
   check count, per topology the allgather naive / hier / shared medians
   at 2^20 and the measured C1 ratio (must equal ``chips``); the sweep
   folded into a table in a temporary directory and self-checked, and the
   committed ``src/repro_torch/artifacts/TUNING_h100.json`` held to the
   fresh sweep by the staleness gate (tol 3.0); (b) on each topology at
   2^20 ``auto`` resolves every family from measurement to the committed
   table's exact winner, and the ``auto`` allgather's values equal the
   naive one's; (c) ``allgather_async(...).resolve()`` equal to
   ``allgather(scheme="shared").read()`` on each topology at 2^20, a store
   between issue and resolve raising ``WindowEpochError``, and on 2x4 at
   2^22 issue / ``ops.matmul`` f32 4096^3 (the panel kernel) / resolve
   timed against gather plus matmul run serially (printed, not gated);
   (d) the step graph on 2x4: one allreduce per leaf of ``qwen3-0.6b``'s
   stacked per-layer parameter tree (440,466,432 elements, 1.76 GB per
   rank) plus loss / count / norm, ``rec.run()`` equal to the per-leaf
   eager allreduce, messages and bytes before and after, the bucket count,
   schedule against eager time, and the schedule gate.  Phase 8 runs its
   scheduler with a ``LiveTuner`` and prints its EWMA and overlay size.

Phase 2 also holds ``ops.flash_attention`` to its plain version (f32 and
bf16: ``tests/test_kernels.py``'s shapes, windows 16 and 64, non-causal,
hd 256) and times it at the model's prefill shape (8 x 16 heads, 8 kv
heads, 2048 tokens, hd 128, f32, causal) beside the plain version and
``scaled_dot_product_attention``, and at ``recurrentgemma-9b``'s local
layer in phase 9's largest prefill group (4 x 16 heads, 1 kv head, 3071
tokens, hd 256, window 2048) beside the plain version and
``scaled_dot_product_attention`` with the causal window as a boolean mask;
and
``ops.lru_scan`` to its plain version (``tests/test_kernels.py``'s shapes
in f32 and bf16, the a = 1 carry against ``cumsum``), timed f32 at phase
9's prefill groups (4, 511 / 1023 / 2047 / 3071, 4096), then at (8, 2048,
4096) and (1, 3072, 4096), beside the plain version and, for orientation,
``torch.cumsum``.  It holds the flash backward kernel
(``kernels.flash_attention_bwd``) to the plain version's autograd (f32 2e-4
and bf16 2e-2 of the largest gradient, 9 shapes: masks, GQA, one kv head
with the q heads split over CTAs, q_offset with rows that see no key,
ragged lengths, both layouts), two launches on the same inputs to the same
bits, and times it f32 at qwen3-0.6b's training shape as phase 11 (a)
launches it (4 x 16 heads, 8 kv heads, 2048, hd 128, causal), at the
global 8 x 2048 and at the hybrid's windowed hd-256 layer, beside the
plain backward and SDPA's f32 backward, with its share of the 3xTF32 bound
and SDPA's time over its own; then its non-finite classes (8 cases) and
its recompute rule on finite operands whose dk overflows.  It holds the
lru_scan backward kernel (``kernels.lru_scan_bwd``) to its plain version
(f32 2e-4, bf16 5e-2 of the largest gradient; ragged T and C not a
multiple of its 64 channels; the a = 1 case against the reversed
``cumsum``), checks that ``ops.lru_scan`` with grad launches it, and
times it f32 at phase 18's training shape (4, 2048, 4096) and at phase
9's prefill groups beside the plain version, its bound and, for
orientation, ``torch.cumsum`` of the flipped cotangent.

11. training (after phase 9): ``qwen3-0.6b`` at full width, f32, seeded
   random weights, on the 2x4 cluster, 8 x 2048 tokens a step — (a) hier
   at full depth, 3 steps: step ms, tokens/s, the training state's bytes,
   the flash forward / backward launches and the panel matmul's, exactly
   NN 576 / NT 288 / TN 288 a step (every product, forward and backward);
   (b) hier against naive at 2
   layers, 2 steps: losses, gnorms, m, v and the params agree, and the
   state's C1 naive/hier per node equals ``chips``; (c) one hier step at 2
   layers, 8 x 128, card against CPU.
12. training with tensor parallelism, on the factored cluster ``2x(2x2)``
   (each node's 4 ranks = 2 store ranks x 2 tp ranks): (a) ``qwen3-0.6b``
   at full width and depth in ``head_tp`` (kv heads tp-sharded), hier, 8 x
   2048, phase 11 (a)'s seed, lr, clip and batches, 3 steps: step ms,
   tokens/s, the state's bytes, losses and gnorms equal to phase 11 (a)'s
   (the same model split over 2 tp ranks) and the loss falling from step 1
   to step 3, the flash launches
   equal to phase 11 (a)'s (336 / 168: the tp ranks fold into the
   kernel's batch), and every layout of the panel matmul launched; (b) hier against naive at 2 layers, 2 steps, phase
   11 (b)'s tolerances, and C1 naive/hier = 2.0 exactly for params, m, v
   and grads (the store size: the tp ranks hold different shards); (c)
   one hier step at 2 layers, 8 x 128, card against CPU; (d) one step of
   ``starcoder2-7b`` (36 heads: tp 8 takes context-parallel attention) cut
   to 2 layers on ``1x(1x8)``, 2 x 2048: the loss, and the flash launches
   one a tp rank a layer at the shapes phase 2 checked (Tq 256 at its
   q_offset against Tkv 2048).

13. the train runtime (after phase 12), every op deterministic
   (``torch.use_deterministic_algorithms``, cuBLAS's workspace fixed
   before CUDA starts): (a) ``train_elastic``'s runtime on ``qwen3-0.6b``
   at full width cut to 2 layers, hier on 2x4 with the step graph, 8 x
   2048, saves every 2 steps, pod 1 lost at step 3 of 6 — one recovery 2x4
   -> 1x4 restored at step 2, the retune sources, the state held once per
   node before and after (C1), the trajectory from step 2 ``==``
   ``reference_run`` on 1x4 from step 2, and a save and restore of the
   final state timed (bytes, ms) and restored bit for bit; (b) phase 11
   (a)'s step at 14 of its 28 layers, 3 steps each under ``()``,
   ``prefetch``,
   ``overlap`` and ``stepgraph``: step ms and tokens/s, prefetch and
   stepgraph losses and gnorms ``==`` eager's, overlap's within rtol 2e-4
   / 5e-3; (c) ``python -m repro_torch.bench --families step_time`` on 2x4
   and ``2x(2x2)``: every case's link record (the warm-up and each timed
   rep) equal to its inventory, the median per step per scheme; (d) the
   launcher's ``--ckpt`` at 2 layers: 4 steps straight, then 2 steps and
   a resumed run to 4 whose steps 3-4 losses ``==`` the straight run's.

14. serving on the stacked cluster (after phase 13): ``qwen3-0.6b`` at
   full width and 14 of its 28 layers, f32, seeded weights,
   ``serve_fsdp`` (every serve
   weight once per node in the window store), run once per memory domain
   — (a) hier on 2x4: 8 prompts of 224-2016 tokens prefilled once per node
   (the flash kernel; 2 x 14 x 8 launches), then 32 decode steps at
   per-slot positions with ``model.decode_fn`` (sync) and with
   ``RecordedDecoder``: every step's logits and the final cache
   ``torch.equal``, one schedule with one gather per fsdp leaf, step p50 /
   p99 and tokens/s, prefill ms, the stored weights (one copy per node)
   and a recorded step's peak bytes against the node buffers; the serve
   layout read back by ``materialize_params_on_mesh`` (exact, no bridge
   bytes), and the single-device decode on those params giving the same
   tokens (and ``greedy_generate``'s for prompt 0) with logits within 1e-4
   relative; (b) the same on ``2x(2x2)`` (tp 2: head_tp prefill into the
   T-sharded cache, split-K decode), its tokens equal (a)'s, logits within
   1e-4 relative, one profiled step's tp collectives; (c) naive against
   hier on 2x4 at s_max 1024: weight bytes per node C1 = 4.0 exactly and
   two decode steps' logits agree; (d) 2 layers, card against CPU on 2x4
   and ``2x(2x2)``: prefill and two decode steps within 1e-4 relative;
   (e) ``python -m repro_torch.bench --families serving`` over
   ``default_matrix()``: 10 cases, every link record (warm-up and each
   timed rep) equal to its inventory, the load model's tokens/s and p50 /
   p99 printed as traffic-check output; (f) ``materialize_params_on_mesh``
   on 2x4, 4x2 and ``2x(2x2)``: the node buffer exact, no slow-link bytes.

15. the MoE family (after phase 14): ``granite-moe-3b-a800m`` at full
   width (d 1536, 24 q / 8 kv heads x 64, 40 experts top 8, d_ff_expert
   512, vocab 49155), f32, seeded weights, capacity 1.25 — (a) hier on
   2x4 at 16 of its 32 layers with ``serve_fsdp``: phase 14's 8 prompts
   prefilled once per node (2 x 16 x 8 flash launches), 32 greedy decode
   steps with
   the sync decode (the dropped share of the routing assignments counted
   each step) and ``RecordedDecoder``: ``torch.equal`` logits and cache,
   one gather per node-stored leaf (the experts' d_ff windows included),
   the stored weights 2.00 node copies, p50 / p99 and tokens/s, one
   profiled step's MoE block parts; (b) 2 layers, card against CPU: the
   routing tables first (flipped rows, the smallest top-k margin; if any
   flip, the card again on the CPU's routing), then a prefill and 4
   decode steps within 1e-4 relative and one hier train step under
   ``PERF.md`` §2's rule; (c) naive against hier on 2x4 at 4 layers:
   weight bytes per node C1 = 4.0 exactly; (d) ``make_cluster_train_step``
   hier, 8 x 2048, 3 steps on 2x4 (ep 1) and ``2x(2x2)`` (ep 2) at 8
   layers (the deepest depth whose state fits is printed), the
   ``moe_gather`` entries launched 32 / 32 / 16 / 16 times a step
   (batched capacity tables: b 4 on 2x4, 2 tp ranks x 2 members on
   2x(2x2)), one profiled step each (tp collectives with the MoE
   reduce-scatter, the MoE block's parts), then the training C1 at 2
   layers (4.0 on 2x4 with hier vs naive under §2's rule, 2.0 on
   ``2x(2x2)``).

16. the xLSTM family (after phase 15): ``xlstm-1.3b`` at full width (d
   2048, 4 heads of 1024, d_inner 4096, 6 units of 7 mLSTM + 1 sLSTM,
   vocab 50304), f32, seeded weights; its blocks reach no Pallas kernel in
   the reference and launch no hand-written kernel here (every kernel
   count is zeroed before each run and must read 0 after it) — (a) hier
   on 2x4 at 1 of its 6 units with ``serve_fsdp``: phase 14's 8 prompts
   (none a
   whole number of 128-token mLSTM chunks) prefilled once per node, the
   decode state's bytes, 32 greedy decode steps with the sync decode and
   ``RecordedDecoder``: ``torch.equal`` logits and state, one gather per
   node-stored leaf, the stored weights 2.00 node copies, p50 / p99 and
   tokens/s, one profiled step's ``xlstm::*`` split; (b) one pattern unit
   (8 layers), card against CPU on 1x4: a 130-token prefill of 2 prompts
   and 4 decode steps within 1e-4 relative, and one hier train step under
   ``PERF.md`` §2's rule; (c) naive against hier on 2x4 at 8 layers:
   weight C1 = 4.0 exactly; (d) the sLSTM loop alone at a training
   domain's shape (ms and device activities a step, forward and
   backward), then ``make_cluster_train_step`` hier, 8 x 1024, 2 steps on
   2x4 and ``2x(2x2)`` at one unit (the whole units whose state fits are
   printed with their bytes; the peak allocated is printed), the
   loop's share of the step, then the training C1 at 8 layers (4.0 on
   2x4 with hier vs naive under §2's rule, 2.0 on ``2x(2x2)``), the 2x4
   hier bundle profiling one step of 8 x 256 (2 mLSTM chunks: the parts,
   the tp collectives); (e) the
   head groups: one train step on ``1x(1x8)`` (tp 8 over 4 heads, g 2) at
   8 layers against the single-device step under §2's rule.

17. the frontends and the production-mesh entry points (after phase 16),
   f32, seeded weights — (a) ``internvl2-1b`` (``vit``: 256 patches of
   1024 in place of a row's first token embeddings; 14 q / 2 kv heads of
   64) at full width and depth through ``runtime.steps.make_train_step``
   on ``small_topo(2, 2, 2)`` (``launch.mesh.make_mesh_from_topo``), hier,
   8 x 2048, 3 steps over ``data.synthetic.FrontendLM``: step ms, masked
   tokens/s, the state's bytes, the flash launches (a layer's one a node
   run: 7 q / 1 kv heads a tp rank folded into the batch), and C1
   naive/hier = 2.0 exactly; hier against naive at 2 layers (8 x 512) and
   card against CPU (4 x 288), one step each under §2's rule; (b) hier
   serving on 2x4 with ``serve_fsdp``: phase 14's prompts each led by its
   256 patches, 32 greedy decode steps, the sync decode ``torch.equal`` to
   ``RecordedDecoder`` (one gather per node-stored leaf), stored weights 2
   node copies, weight C1 naive/hier = 4.0 exactly; then
   ``make_serve_steps`` on ``1x(1x8)``: 32 decode steps of 8 rows from an
   empty cache with the ``decode2d`` opt ((g_h, g_s) = (2, 4)) against
   the 1-D decode within rtol / atol 2e-4; (c) ``musicgen-medium``
   (``encodec``: 128-wide frames, 24 q / 24 kv heads of 64): hier serving
   on 2x4 at full depth, a 512-frame prefill and 8 frame decode steps
   against the 520-frame prefill within 1e-4 relative; card against CPU
   at 2 layers (prefill, 2 decode steps, one ``make_train_step`` step
   under §2's rule); ``make_train_step`` hier on 2x4, 8 x 2048 frames, 2
   steps at the deepest whole number of layers whose state fits; (d)
   ``repro_torch.apps.quickstart``, ``serve_lm`` and ``train_100m`` as
   processes of their own with ``--device cuda``, side by side: the loss
   below ln V - 0.5, 5 of 5 streams equal their solo runs and the live
   tuner's line, and ``train_100m`` stopped after its step-2 checkpoint
   and resumed (``resumed_from`` 2).
18. hybrid training (after phase 17): ``recurrentgemma-9b`` at full width
   (d 4096, d_rnn 4096, 16 heads x 256 with 1 kv head, d_ff 12288, vocab
   256000 tied; f32, seeded weights) at one pattern unit (``rglru, rglru,
   local``, ~1.7e9 params) through ``make_cluster_train_step`` in hier on
   one 1x4 node, 4 x 2048 tokens, 3 steps: finite losses, step ms and
   tokens/s from step 2, the peak memory, the state per node against
   naive's reckoned 4 copies (C1), and the lru_scan forward / backward
   and flash forward / backward launches a step.
19. dropless MoE training (after phase 18): ``granite-moe-3b-a800m`` as
   the benchmark's granite cell runs it (8 of 32 layers, the four
   published multipliers, the tied embedding at 12, the softmax over the
   published vocabulary, dropless top 8 of 40), ``make_cluster_train_step``
   hier on 2x4, 8 x 2048 tokens, 3 steps: step 1's routing keeps every
   assignment, finite losses, step ms and tokens/s from step 2, and the
   grouped entry of ``csrc/matmul.cu`` launched 64 / 32 / 32 times a step
   (NN / NT / TN); then that entry at the run's shapes (65,536 routed rows
   in the segments of layer 0's routing, and with two segments emptied;
   w_in K 1536 N 1024, w_out K 512 N 1536; NN, NT and TN) within 1e-5 of
   its plain version's largest |C| (a TF32 product, shown, misses that),
   against float64 too, timed beside the plain version with its bound.
   The steps launch the ``moe_gather`` entries (``csrc/moe_gather.cu``)
   32 / 32 / 16 / 16 times a step (dispatch, combine, combine_bwd,
   dispatch_bwd); each entry at layer 0's routing (M 8192, k 8, d 1536)
   equals its plain version bit for bit (the gates' gradient within 1e-6
   of float64) and run to run, timed beside the plain version and its
   byte bound at 3.35 TB/s; and the same checks on phase 15 (d)'s
   capacity tables (layer 0's routing of each training run: a leading b,
   dropped slots, other groups' experts and empty cells).

Phase 11 (a) also prints the dry run of its own step
(``launch.dryrun.trace_cell`` on meta tensors: the same config, cluster,
shape and dtype) — its roofline terms per rank, its kernel calls, which
must equal the launches, and the measured step's share of the 8 ranks'
compute term on the card.

Phase 2 holds the flash forward and backward kernels at phase 12's shapes
too: (8, 2048, 8 q / 4 kv, 128) and (2, 256, 36 q / 4 kv, 128) against
2048 keys at q_offset 256 and 1792; and at phase 15's (hd 64): the
training forward and backward (4, 2048, 24 q / 8 kv, 64) and one
2016-token prompt's forward, each timed beside SDPA and its bound; and at
phase 17's (a GQA group of 7): (4, 2048, 14 q / 2 kv, 64) and the head_tp
rank's (8, 2048, 7 q / 1 kv, 64), forward and backward, with the
backward's ``head_splits``.

Kernel launch counts are zeroed just before each main path (phases 3-7,
phase 10, then phase 8's and phase 9's serving runs, phase 11 (a), phase
12 (a), each of phase 13's runs, phase 14's prefills, phase 15's
prefills and training runs (for the moe_gather entries too), phase
16's runs, which launch none, phase 17's training runs and prefills, phase 18's training run, and
phase 19's steps 2-3 for the grouped and moe_gather entries) and read
just after; the JSON's flash, scan, grouped and moe_gather rows sum the
main paths that launch them.
The recompute counters (the non-finite rule's, and the flash backward's)
are zeroed before phase 3 and must read 0 after phase 19.
The line
before the last is a JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import dataclasses
import gc
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

# phase 9's requests: HYBRID_PER_LENGTH prompts of each length.  The
# exact-length buckets make each length one prefill group of
# HYBRID_PER_LENGTH slots over length - 1 tokens, the shapes at which
# phase 2 checks and times lru_scan and the flash kernel's windowed case.
HYBRID_LENGTHS, HYBRID_PER_LENGTH = (512, 1024, 2048, 3072), 4


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up
    (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def check_close(got, want, dtype, K: int, what: str) -> float:
    """The reference kernel tests' tolerance (F32 2e-4 / BF16 2e-2, rtol
    K-scaled, atol x8), compared in fp32; returns max |err|."""
    import torch
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    rtol, atol = tol * max(1, K // 256 + 1), tol * 8
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bad = (err > atol + rtol * w.abs()).sum().item()
    if bad or not torch.isfinite(g).all():
        raise AssertionError(f"{what}: {bad} elements outside rtol={rtol} "
                             f"atol={atol} (max |err| {err.max().item()})")
    return err.max().item()


def check_flash(got, want, dtype, what: str) -> float:
    """The reference kernel tests' flash tolerance (F32 2e-4 / BF16 2e-2,
    rtol and atol), compared in fp32; returns max |err|."""
    import torch
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bad = (err > tol + tol * w.abs()).sum().item()
    if bad or not torch.isfinite(g).all() or got.shape != want.shape:
        raise AssertionError(f"{what}: {bad} elements outside {tol} "
                             f"(max |err| {err.max().item()})")
    return err.max().item()


def check_lru(got, want, dtype, what: str) -> float:
    """The reference lru_scan test's tolerance (f32 2e-4; bf16 rtol = atol
    = 5e-2), compared in fp32; returns max |err|."""
    import torch
    tol = 2e-4 if dtype == torch.float32 else 5e-2
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bad = (err > tol + tol * w.abs()).sum().item()
    if bad or not torch.isfinite(g).all() or got.shape != want.shape \
            or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {bad} elements outside {tol} "
                             f"(max |err| {err.max().item()})")
    return err.max().item()


def check_classes(got, want, bound, tol: float, what: str) -> dict:
    """The non-finite rule's check: ``got`` non-finite exactly where
    ``want`` is, with its class (NaN, +inf, -inf); the finite values within
    ``tol * (1 + bound)``.  Returns the count of each class."""
    import torch
    g, w = got.float(), want.float()
    counts = {}
    for name, kind in (("nan", torch.isnan), ("+inf", torch.isposinf),
                       ("-inf", torch.isneginf)):
        miss = int((kind(g) != kind(w)).sum())
        if miss:
            raise AssertionError(f"{what}: {name} differs from the plain "
                                 f"version at {miss} places")
        counts[name] = int(kind(w).sum())
    fin = torch.isfinite(w)
    bad = int(((g - w).abs() > tol * (1 + bound))[fin].sum())
    if bad:
        raise AssertionError(f"{what}: {bad} finite values outside "
                             f"{tol} * (1 + bound)")
    return counts


def rel_err(got, want) -> float:
    """max |got - want| / max |want| (got moved to want's device)."""
    return ((got.to(want.device) - want).abs().max()
            / want.abs().max()).item()


def pct(xs, q):
    """The launcher's percentile (``repro_torch.launch.serve``)."""
    import math
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))] if s \
        else 0.0


def bound(flops: float, moved: float, route: str) -> tuple[float, str]:
    """The least time the card could take (ms) by ``route``: the larger of
    ``moved`` bytes at the HBM rate and ``flops`` at the route's dense
    peak — an fp32-accurate product as 3xTF32 on the tensor cores (three
    TF32 products per FLOP), as fp32 FMA on the CUDA cores, or a bf16
    product on the tensor cores — and which.  The H100 constants are
    ``repro_torch.analysis.roofline``'s (3.35 TB/s; 495 / 3, 67 and 989
    TFLOP/s), the dry run's too."""
    from repro_torch.analysis.roofline import HBM_BW, PEAK
    ops_ms, bytes_ms = flops / PEAK[route] * 1e3, moved / HBM_BW * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def f32_bounds(flops: float, moved: float) -> dict:
    """An f32 product's bounds: the least time (3xTF32 tensor cores) and
    the fp32 FMA one beside it, which only the printed rows carry."""
    ms, by = bound(flops, moved, "3xtf32")
    return {"bound_ms": ms, "bound_by": by,
            "bound_fma_ms": bound(flops, moved, "fma")[0]}


def least(b: dict) -> dict:
    """The kernels record's bound keys: the least time and what sets it."""
    return {"bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}


def bounds_text(b: dict) -> str:
    return (f"bound {b['bound_ms']:.3f} ms ({b['bound_by']}, 3xTF32 at "
            f"495 TFLOP/s; fp32 FMA at 67 TFLOP/s {b['bound_fma_ms']:.3f} ms)")


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} \
        if isinstance(tree, dict) else fn(tree)


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


def slot_state(cache, slot: int) -> dict:
    """Copies of one slot's recurrent state: every cache leaf but the
    attention k / v (slot axis 1 under ``units``, 0 under ``rem``)."""
    out = {}
    for part, axis in (("units", 1), ("rem", 0)):
        for key, blk in cache.get(part, {}).items():
            for name, a in blk.items():
                if name not in ("k", "v"):
                    out[f"{part} {key} {name}"] = a.select(axis, slot).clone()
    return out


class SoloRecorder:
    """A model, keeping each step's last-position logits row and top-2
    log-prob gap, and the recurrent state after step ``snap_at`` (the
    solo run's step that has consumed what the scheduler's last decode
    step has)."""

    def __init__(self, m, snap_at: int):
        self.m, self.device, self.snap_at = m, m.device, snap_at
        self.rows, self.gaps, self.state = [], [], None

    def _note(self, out):
        import torch
        row = out[1][0, -1].float()
        top = torch.log_softmax(row, dim=-1).topk(2).values
        self.gaps.append((top[0] - top[1]).item())
        self.rows.append(row.clone())
        if len(self.rows) - 1 == self.snap_at:
            self.state = slot_state(out[0], 0)
        return out

    def prefill_fn(self, *a):
        return self._note(self.m.prefill_fn(*a))

    def decode_fn(self, *a):
        return self._note(self.m.decode_fn(*a))


class StreamRecorder:
    """The scheduler's decode step, keeping each request's last-position
    logits row at every step and its slot's recurrent state after its last
    step.  Set ``sched`` to the scheduler it serves before the first
    step."""

    def __init__(self, m):
        self.m, self.sched = m, None
        self.rows, self.state = {}, {}

    def decode_fn(self, params, cache, tok, pos):
        out = self.m.decode_fn(params, cache, tok, pos)
        s = self.sched
        rows = out[1][:, -1].clone()      # one device copy, no sync
        for slot in map(int, s.active.nonzero()[0]):
            rid = int(s.rid[slot])
            self.rows.setdefault(rid, []).append(rows[slot])
            if s.remaining[slot] == 1:
                self.state[rid] = slot_state(out[0], slot)
        return out


def run_closed_batch(sched, prompts, max_new: int):
    """Submit every prompt at t = 0 and step the scheduler until all are
    done: (request ids, elapsed s, {rid: s from the start to its end})."""
    rids = [sched.queue.submit(p, max_new) for p in prompts]
    done_at = {}
    t0 = time.perf_counter()
    while len(sched.results) < len(prompts):
        if not sched.step():
            raise AssertionError("the scheduler went idle with requests "
                                 "outstanding")
        now = time.perf_counter() - t0
        for rid in sched.results:
            done_at.setdefault(rid, now)
    return rids, time.perf_counter() - t0, done_at


def report_serving(sched, prompts, lengths, elapsed, done_at, cfg, *,
                   slots: int, s_max: int, max_new: int) -> dict:
    """Print the serving metrics and prefill ms per bucket, check every
    stream's form; returns {bucket: [(group size, ms), ...]}."""
    import numpy as np
    n_tok = sum(r.tokens.size for r in sched.results.values())
    step_us = [s_.decode_us for s_ in sched.stats if s_.active]
    e2e_ms = [1e3 * t for t in done_at.values()]
    print(f"[serve] {len(prompts)} requests (prompts {min(lengths)}-"
          f"{max(lengths)} tokens, {max_new} new each), {slots} slots, "
          f"s_max {s_max}: {n_tok} tokens in {elapsed:.2f} s = "
          f"{n_tok / elapsed:.1f} tokens/s;  decode step us p50 "
          f"{pct(step_us, 0.5):.0f} p99 {pct(step_us, 0.99):.0f} "
          f"({len(step_us)} steps, mean batch "
          f"{np.mean([s_.active + s_.finished for s_ in sched.stats]):.2f});"
          f"  request e2e ms p50 {pct(e2e_ms, 0.5):.1f} p99 "
          f"{pct(e2e_ms, 0.99):.1f}")
    by_bucket = {}
    for s_ in sched.stats:
        if s_.admitted:
            by_bucket.setdefault(s_.bucket, []).append(
                (s_.admitted, s_.prefill_us / 1e3))
    for tb in sorted(by_bucket):
        groups = by_bucket[tb]
        print(f"[serve] prefill bucket {tb}: {len(groups)} groups "
              f"(sizes {[n for n, _ in groups]}), ms "
              f"{[round(ms, 2) for _, ms in groups]}")
    for r in sched.results.values():
        if r.tokens.shape != (1, max_new) \
                or not np.isfinite(r.logprobs).all() \
                or (r.tokens < 0).any() \
                or (r.tokens >= cfg.vocab_padded).any():
            raise AssertionError("a request's stream is malformed")
    return by_bucket


def check_streams(model, params, sched, rec, prompts, rids, *,
                  max_new: int, s_max: int) -> None:
    """Each request's stream against its solo ``greedy_generate`` run
    (``rec``: the ``StreamRecorder`` that ran the scheduler's decode).
    Tokens identical unless the solo run's top-2 gap is <= 1e-3 (a near
    tie, after which the streams may part); up to there, log-probs within
    1e-4 + 1e-4 relative and each step's last-position logits row within
    1e-4 relative; when every token agrees, the slot's recurrent state
    after its last step within 1e-4 relative of the solo run's (each
    leaf)."""
    from repro_torch.serving.engine import greedy_generate
    for rid in rids:
        solo_rec = SoloRecorder(model, snap_at=max_new - 1)
        solo = greedy_generate(solo_rec, params, prompts[rid][None],
                               max_new=max_new, s_max=s_max)
        got = sched.results[rid]
        agree, row_err = 0, 0.0
        for i in range(max_new):
            if got.tokens[0, i] != solo.tokens[0, i]:
                if solo_rec.gaps[i] > 1e-3:
                    raise AssertionError(
                        f"request {rid}: token {i} differs from its solo "
                        f"run with a top-2 gap of {solo_rec.gaps[i]:.3g}")
                break                 # a near tie: the streams part here
            d_lp = abs(got.logprobs[0, i] - solo.logprobs[0, i])
            if d_lp > 1e-4 + 1e-4 * abs(solo.logprobs[0, i]):
                raise AssertionError(f"request {rid}: log-prob {i} differs "
                                     f"from its solo run by {d_lp:.3g}")
            e = rel_err(rec.rows[rid][i].float(), solo_rec.rows[i])
            if not e <= 1e-4:
                raise AssertionError(f"request {rid}: step {i}'s logits "
                                     f"differ from its solo run's by "
                                     f"rel_err {e:.3g}")
            row_err = max(row_err, e)
            agree += 1
        state = "no recurrent state"
        if agree < max_new and solo_rec.state:
            state = "recurrent state not compared (the streams parted)"
        elif solo_rec.state:
            errs = {n: rel_err(a, solo_rec.state[n])
                    for n, a in rec.state[rid].items()}
            if rec.state[rid].keys() != solo_rec.state.keys() \
                    or not max(errs.values()) <= 1e-4:
                raise AssertionError(f"request {rid}: recurrent state after "
                                     f"its last step vs its solo run: "
                                     f"{errs}")
            worst = max(errs, key=errs.get)
            state = (f"recurrent state after the last step ({len(errs)} "
                     f"leaves) rel_err <= {errs[worst]:.2e} ({worst})")
        print(f"[serve] request {rid} ({prompts[rid].size} prompt tokens): "
              f"{agree}/{max_new} tokens agree with its solo greedy_generate "
              f"run (smallest top-2 gap {min(solo_rec.gaps[:max_new]):.3g}),"
              f" logits rows rel_err <= {row_err:.2e}, {state}")


def decode_both(m_g, m_c, p_g, p_c, cache_g, cache_c, logits_g, pos: int,
                state: list) -> dict:
    """Two greedy decode steps on the card (``m_g``) and on the CPU
    (``m_c``) from their prefill caches, both fed the card's tokens: each
    step's logits and, after the last, the named unit-0 ``state`` leaves
    ("b0 h") within 1e-4 relative.  Returns the errors."""
    import torch
    errs = {}
    tok = logits_g[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    for step in range(2):
        cache_g, lg = m_g.decode_fn(p_g, cache_g, tok, pos + step)
        cache_c, lc = m_c.decode_fn(p_c, cache_c, tok.cpu(), pos + step)
        if not torch.isfinite(lg).all():
            raise AssertionError(f"decode step {step}: non-finite logits")
        errs[f"logits step {step}"] = rel_err(lg, lc)
        tok = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    for name in state:
        blk, leaf = name.split()
        errs[name] = rel_err(cache_g["units"][blk][leaf][0],
                             cache_c["units"][blk][leaf][0])
    if not max(errs.values()) <= 1e-4:
        raise AssertionError(f"card vs CPU decode: {errs}")
    return errs


# phase 14's prompts: 8 lengths 224 .. 2016 (256 k - 32), so 32 decode
# steps end at position 2047 of an s_max of 2048; even, so tp 2 splits them
SERVE_CLUSTER_LENGTHS = tuple(256 * k - 32 for k in range(1, 9))
# phase 14 serves qwen3-0.6b at 14 of its 28 layers: its decode is
# host-bound, and the script's time limit holds phase 17 too
SERVE_CLUSTER_LAYERS = 14
SERVE_CLUSTER_SMAX, SERVE_CLUSTER_STEPS = 2048, 32


def serve_cluster_phase(dev, scratch: str) -> int:
    """Phase 14: serving on the stacked cluster (``ClusterModel``), at
    ``qwen3-0.6b``'s full width and depth.  Returns the flash-attention
    launches of its runs (each zeroed just before and read just after)."""
    import math
    import numpy as np
    import torch
    from repro_torch.analysis import traffic
    from repro_torch.analysis.profile import TP_RANGES, profile_run
    from repro_torch.bench import __main__ as bench_cli
    from repro_torch.comm import Communicator, SharedWindow
    from repro_torch.configs import get_config
    from repro_torch.core import tree as T
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.models import ParallelCtx, build
    from repro_torch.runtime.steps import cluster_ctx
    from repro_torch.models.domains import NodeCache
    from repro_torch.serving.engine import (greedy_generate,
                                            materialize_params_on_mesh)
    from repro_torch.serving.recorded import RecordedDecoder
    from repro_torch.substrate import VirtualCluster
    from repro_torch.substrate.cluster import P
    from repro_torch.substrate.collectives import recording

    cfg = dataclasses.replace(get_config("qwen3-0.6b"),
                              n_layers=SERVE_CLUSTER_LAYERS)
    lengths, S, steps = (SERVE_CLUSTER_LENGTHS, SERVE_CLUSTER_SMAX,
                         SERVE_CLUSTER_STEPS)
    nb = len(lengths)
    single = build(cfg, ParallelCtx.single(), device=dev)
    params = single.init_params(14)
    w_bytes = sum(t.numel() * t.element_size() for t in T.leaves(params))
    rows = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=max(lengths),
                                  global_batch=nb, seed=5)).next_batch()[
        "tokens"]
    prompts = [rows[i, :n].astype(np.int32) for i, n in enumerate(lengths)]
    launches = 0

    def model_on(vc, mode="hier", c=cfg):
        ctx = cluster_ctx(vc, mode=mode, opts=("serve_fsdp",))
        sizes = dict(zip(vc.axis_names, vc.axis_shapes))
        return build(c, ctx, data=math.prod(sizes[a] for a in
                                            ctx.fsdp_axes), device=dev)

    def specs(m, serve):
        ctx = m.ctx
        return m.param_specs(serve=serve, tp_axis=ctx.tp_axis,
                             fsdp_axis=ctx.fsdp_axes[0] if ctx.fsdp_axes
                             else None)

    def clone(cache):
        return NodeCache(T.tree_map(lambda t: t.clone(), dict(cache)),
                         cache.domains)

    def prefill_slots(m, vc, p, ps):
        """Every prompt through the cluster prefill (one run per domain,
        the flash kernel), into its slot of one NodeCache; the first
        tokens and the prefill ms."""
        cache = m.cache_init(nb, S)
        first = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, pr in enumerate(ps):
            toks = torch.from_numpy(np.concatenate([pr, pr[-1:]])[None])
            c, lg = m.prefill_fn(p, {"tokens": vc.layout(toks, P())}, S)
            cache.copy_row(c, 0, i)
            first.append(lg[0, 0, 0])
            del c
        torch.cuda.synchronize()
        return cache, torch.stack(first), (time.perf_counter() - t0) * 1e3

    def decode_loop(decode, p, cache, vc, first, n):
        """``n`` greedy decode steps of every slot at its own position;
        every step's logits rows (cloned), the step times (ms)."""
        tok, pos = first.argmax(-1), torch.tensor(lengths)
        out, ms = [], []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache, lg = decode(p, cache, vc.layout(tok[:, None].int(), P()),
                               vc.layout(pos, P()))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            out.append(lg[0, :, 0].clone())
            tok, pos = out[-1].argmax(-1), pos + 1
        return out, ms, cache

    def report(label, ms):
        tail = ms[1:]
        print(f"[serve-cluster] {label}: decode step p50 "
              f"{1e3 * pct(tail, 0.5):.0f} us p99 {1e3 * pct(tail, 0.99):.0f}"
              f" us (steps 2-{len(ms)}; step 1 {ms[0]:.1f} ms), "
              f"{nb * len(tail) / sum(tail) * 1e3:.1f} tokens/s")

    def serve_on(label):
        """(a) / (b): prefill, then the sync and the recorded decode from
        the same cache, on one cluster; returns what (a) and (b) compare."""
        nonlocal launches
        vc = VirtualCluster.from_label(label, device=dev)
        m = model_on(vc)
        with vc.bind():
            train = vc.layout(params, specs(m, False))
            kflash.launches = 0
            cache, first, pre_ms = prefill_slots(m, vc, train, prompts)
            fl = kflash.launches
            del train
            want_fl = vc.pods * cfg.n_layers * nb
            print(f"[serve-cluster] {label} hier: prefill of {nb} prompts "
                  f"({lengths[0]}-{lengths[-1]} tokens, one run per node) "
                  f"{pre_ms:.1f} ms; flash_attention launches {fl} "
                  f"({vc.pods} nodes x {cfg.n_layers} layers x {nb})")
            if fl != want_fl:
                raise AssertionError(f"prefill launches {fl} != {want_fl}")
            launches += fl
            base = traffic.device_bytes(dev)
            serve = vc.layout(params, specs(m, True))
            stored = traffic.device_bytes(dev) - base
            # one copy per node; at tp > 1 the serve layout replicates the
            # attention weights over the tp ranks (every head on each)
            tp = m.ctx.tp if m.ctx.tp_axis else 1
            want_stored = vc.pods * sum(
                t.numel() * t.element_size() * (tp if mt.tp_dim is None
                                                else 1)
                for t, mt in zip(T.leaves(params), T.leaves(m.serve_defs)))
            sync, s_ms, c_sync = decode_loop(m.decode_fn, serve,
                                             clone(cache), vc, first, steps)
            report(f"{label} sync", s_ms)
            dec = RecordedDecoder(m)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
            rec, r_ms, c_rec = decode_loop(dec, serve, cache, vc, first,
                                           steps)
            peak = torch.cuda.max_memory_allocated(dev) - held
            report(f"{label} recorded", r_ms)
            same = all(torch.equal(a, b) for a, b in zip(sync, rec)) and \
                all(torch.equal(a, b) for a, b in zip(
                    T.leaves(dict(c_sync)), T.leaves(dict(c_rec))))
            (sched,) = dec.schedules.values()
            n_g = sum(n.family == "gather" for n in sched.graph.nodes)
            n_fsdp = sum(mt.fsdp_dim is not None
                         for mt in T.leaves(m.serve_defs))
            print(f"[serve-cluster] {label}: recorded == sync (every "
                  f"step's logits and the final cache, torch.equal) {same};"
                  f" schedule built once, replayed {steps - 1} times, "
                  f"gathers {n_g} (fsdp leaves {n_fsdp})")
            print(f"[serve-cluster] {label}: stored weights "
                  f"{stored / 1e9:.3f} GB ({stored / w_bytes:.2f} x "
                  f"{w_bytes / 1e9:.3f} GB: one copy per node"
                  f"{', attention per tp rank' if tp > 1 else ''}); a "
                  f"recorded step's peak above the held state "
                  f"{peak / 1e9:.3f} GB (the node buffers: "
                  f"{want_stored / 1e9:.3f} GB; a copy per rank would be "
                  f"{vc.num_devices * w_bytes / 1e9:.3f} GB)")
            if not same or n_g != n_fsdp or len(dec.schedules) != 1:
                raise AssertionError(f"{label}: recorded differs from sync "
                                     f"or gathers {n_g} != {n_fsdp}")
            if stored != want_stored or peak > want_stored + 2 ** 30:
                raise AssertionError(f"{label}: stored {stored}, recorded "
                                     f"step peak {peak}")
            tp_ms = None
            if m.ctx.tp_axis:
                c_p = clone(c_rec)
                tok = vc.layout(rec[-1].argmax(-1)[:, None].int(), P())
                pos = vc.layout(torch.tensor(lengths) + steps - 1, P())
                r = profile_run(lambda: m.decode_fn(serve, c_p, tok, pos),
                                ranges=TP_RANGES)
                tp_ms = sum(r["ranges"].values())
                print(f"[serve-cluster] {label}: one sync decode step "
                      f"profiled: wall {r['wall_ms']:.1f} ms, device busy "
                      f"{r['busy_ms']:.1f} ms ({100 * r['busy_share']:.1f}"
                      f"%); tp collectives {tp_ms:.3f} ms "
                      f"({ {k: round(v, 3) for k, v in r['ranges'].items()} })")
                del c_p
            del serve, cache, c_sync, c_rec
        gc.collect()
        torch.cuda.empty_cache()
        return sync, first

    t_a = time.perf_counter()
    logits_a, first_a = serve_on("2x4")
    tokens_a = torch.stack([r.argmax(-1) for r in logits_a])

    # (a) against the single-device decode on materialize_params_on_mesh's
    # params (the serve layout's windows read back on the cluster)
    vc = VirtualCluster(pods=2, chips=4, device=dev)
    m = model_on(vc)
    comm = Communicator.from_cluster(vc)
    with vc.bind():
        lay = vc.layout(params, specs(m, True))
    flat, metas = T.leaves(lay), T.leaves(m.serve_defs)
    units = [k_ == "units" for k_ in sorted(lay) for _ in T.leaves(lay[k_])]
    win_leaves = []
    for t, mt, u in zip(flat, metas, units):
        ax = mt.fsdp_dim + int(u)     # the rank-major stack along the axis
        glob = t.movedim(0, ax).flatten(ax, ax + 1)
        win_leaves.append(SharedWindow(comm, glob, axis=ax, epoch=1))
    del lay, flat
    with recording() as rec_m:
        mat = materialize_params_on_mesh(T.unflatten(params, win_leaves),
                                         vc)
    del win_leaves
    exact = all(torch.equal(a, b) for a, b in zip(T.leaves(mat),
                                                  T.leaves(params)))
    fast, slow = traffic.link_bytes(rec_m)
    print(f"[serve-cluster] materialize_params_on_mesh of the 2x4 serve "
          f"layout: node buffers == the params {exact}; link bytes per "
          f"chip fast {fast:.0f} slow {slow:.0f}")
    if not exact or slow != 0:
        raise AssertionError("materialize_params_on_mesh is not exact or "
                             "crossed the bridge")
    cache1 = single.cache_init(nb, S)
    first1 = []
    for i, pr in enumerate(prompts):
        toks = torch.from_numpy(np.concatenate([pr, pr[-1:]])[None]).to(dev)
        c, lg = single.prefill_fn(mat, {"tokens": toks}, S)
        for a, b in zip(T.leaves(cache1), T.leaves(c)):
            a.select(1, i).copy_(b.select(1, 0))
        first1.append(lg[0, 0])
        del c
    first1 = torch.stack(first1)
    tok, pos, worst = first1.argmax(-1), torch.tensor(lengths, device=dev), \
        rel_err(first_a, first1)
    toks1 = []
    for i in range(steps):
        cache1, lg = single.decode_fn(mat, cache1, tok[:, None].int(), pos)
        row = lg[:, 0]
        worst = max(worst, rel_err(logits_a[i], row))
        toks1.append(row.argmax(-1))
        tok, pos = toks1[-1], pos + 1
    same_tok = torch.equal(torch.stack(toks1).cpu(), tokens_a.cpu())
    gen = greedy_generate(single, mat, prompts[0][None], max_new=steps,
                          s_max=S)
    gen_ok = np.array_equal(gen.tokens[0][1:],
                            tokens_a[:-1, 0].cpu().numpy())
    print(f"[serve-cluster] 2x4 vs the single-device decode on those "
          f"params: tokens equal {same_tok} (greedy_generate of prompt 0: "
          f"{gen_ok}); logits rel_err <= {worst:.3g} (prefill and "
          f"{steps} steps)")
    if not (same_tok and gen_ok) or worst > 1e-4:
        raise AssertionError("the cluster decode differs from the "
                             "single-device one")
    del mat, cache1
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the factored cluster: tp 2, head_tp prefill, split-K decode
    logits_b, _ = serve_on("2x(2x2)")
    tokens_b = torch.stack([r.argmax(-1) for r in logits_b])
    worst_b = max(rel_err(a, b) for a, b in zip(logits_b, logits_a))
    print(f"[serve-cluster] 2x(2x2) vs 2x4: tokens equal "
          f"{torch.equal(tokens_a, tokens_b)}, logits rel_err <= "
          f"{worst_b:.3g}")
    if not torch.equal(tokens_a, tokens_b) or worst_b > 1e-4:
        raise AssertionError("tp 2 serving differs from tp 1")
    print(f"[phase] serve cluster (a)-(b) {time.perf_counter() - t_a:.1f} s")

    # (c) naive against hier on 2x4 at s_max 1024: weight C1 and decode
    vc = VirtualCluster(pods=2, chips=4, device=dev)
    pos = torch.arange(nb)
    tok = torch.from_numpy(rows[:, :1].astype(np.int32))
    got, held = {}, {}
    for mode in ("hier", "naive"):
        m = model_on(vc, mode)
        with vc.bind():
            base = traffic.device_bytes(dev)
            lay = vc.layout(params, specs(m, True))
            held[mode] = (traffic.device_bytes(dev) - base) / vc.pods
            cache = m.cache_init(nb, 1024)
            outs = []
            for i in range(2):
                cache, lg = m.decode_fn(lay, cache, vc.layout(tok, P()),
                                        vc.layout(pos + i, P()))
                outs.append(lg[0].clone())
                tok = lg[0, :, 0].argmax(-1)[:, None].int().cpu()
            got[mode] = (outs, cache.domains.count)
            tok = torch.from_numpy(rows[:, :1].astype(np.int32))
            del lay, cache
        gc.collect()
        torch.cuda.empty_cache()
    c1 = held["naive"] / held["hier"]
    worst_c = max(rel_err(a, b) for a, b in zip(got["naive"][0],
                                                got["hier"][0]))
    print(f"[serve-cluster] naive vs hier on 2x4, s_max 1024: weight bytes "
          f"per node {held['naive'] / 1e9:.3f} / {held['hier'] / 1e9:.3f} "
          f"GB, C1 naive/hier {c1} (chips {vc.chips}); caches "
          f"{got['naive'][1]} / {got['hier'][1]} (one per rank / per "
          f"node); 2 decode steps' logits rel_err {worst_c:.3g}")
    if c1 != vc.chips or worst_c > 1e-4:
        raise AssertionError(f"serving C1 {c1} != {vc.chips} or naive "
                             f"differs from hier")

    # (d) card against CPU at 2 layers, hier on 2x4 and 2x(2x2): a check
    # run, so its flash launches stay out of the main path's count
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    p2 = {k_: v for k_, v in params.items() if k_ != "units"}
    p2["units"] = T.tree_map(lambda t: t[:2], params["units"])
    toks2 = torch.from_numpy(rows[1:3, :257].astype(np.int32))
    for label in ("2x4", "2x(2x2)"):
        res = []                        # the card's logits, then the CPU's
        for d_ in (dev, torch.device("cpu")):
            vc = VirtualCluster.from_label(label, device=d_)
            ctx = cluster_ctx(vc, opts=("serve_fsdp",))
            sizes = dict(zip(vc.axis_names, vc.axis_shapes))
            m = build(cfg2, ctx, data=sizes[ctx.fsdp_axes[0]], device=d_)
            pp = T.tree_map(lambda t: t.to(d_), p2)
            kflash.launches = 0
            with vc.bind():
                cache, lg = m.prefill_fn(vc.layout(pp, specs(m, False)),
                                         {"tokens": vc.layout(toks2, P())},
                                         512)
                sp = vc.layout(pp, specs(m, True))
                outs, pos = [lg[0].cpu()], torch.tensor([256, 256])
                for _ in range(2):
                    tok = outs[-1][:, 0].argmax(-1)[:, None].int()
                    cache, lg = m.decode_fn(sp, cache, vc.layout(tok, P()),
                                            vc.layout(pos, P()))
                    outs.append(lg[0].cpu())
                    pos = pos + 1
            if d_.type == "cuda":
                card_fl = kflash.launches
            res.append(outs)
            del cache, sp, pp
        errs = [rel_err(a, b) for a, b in zip(*res)]
        print(f"[serve-cluster] card vs CPU, {label} hier, 2 layers: "
              f"prefill 2 x 256 and 2 decode steps, logits rel_err "
              f"{[f'{e:.3g}' for e in errs]}; the card run's "
              f"flash_attention launches {card_fl} (not in the kernels "
              f"line)")
        if max(errs) > 1e-4:
            raise AssertionError(f"{label}: card differs from the CPU")
        if card_fl != vc.pods * cfg2.n_layers:
            raise AssertionError(f"{label}: card prefill launches {card_fl}"
                                 f" != {vc.pods * cfg2.n_layers}")
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the serving bench family over default_matrix(): a traffic check
    out = os.path.join(scratch, "serving.json")
    if bench_cli.main(["--families", "serving", "--reps", "5",
                       "--out", out]) != 0:
        raise AssertionError("the serving bench failed")
    with open(out) as f:
        rep = json.load(f)
    if len(rep["cases"]) != 10:
        raise AssertionError(f"{len(rep['cases'])} serving cases, not 10")
    for c_ in rep["cases"]:
        names = {ch["name"] for ch in c_["checks"]}
        if not {"link/fast", "link/slow", "link/fast/timed",
                "link/slow/timed"} <= names or not c_["ok"] or \
                c_["timing"]["mode"] != "eager":
            raise AssertionError(f"serving case {c_['name']}")
        sv = c_["serving"]
        print(f"[serve-cluster] serving {c_['topology']} {c_['scheme']}: "
              f"link bytes per chip fast "
              f"{c_['record']['fast_link_bytes_per_chip']:.0f} slow "
              f"{c_['record']['slow_link_bytes_per_chip']:.0f} == the "
              f"inventory (warm-up and {c_['timing']['reps']} timed reps); "
              f"traffic-check output, not results: median "
              f"{c_['timing']['median_us']:.1f} us, load model "
              f"{sv['tokens_per_s']:.1f} tokens/s, p50 / p99 "
              f"{sv['p50_token_ms']:.3f} / {sv['p99_token_ms']:.3f} ms")

    # (f) materialize_params_on_mesh on 2x4, 4x2 and 2x(2x2) on the card
    for label in ("2x4", "4x2", "2x(2x2)"):
        vc = VirtualCluster.from_label(label, device=dev)
        comm = Communicator.from_cluster(vc)
        emb = params["embed"]
        w = torch.cat([emb] * vc.pods)          # pod-replicated windows
        buf = torch.arange(24.0, device=dev).reshape(8, 3)
        with recording() as rec_f:
            got_f = materialize_params_on_mesh(
                {"embed": SharedWindow(comm, w, axis=0, epoch=1),
                 "toy": SharedWindow(comm, torch.cat([buf] * vc.pods),
                                     axis=0, epoch=1)}, vc)
        fast, slow = traffic.link_bytes(rec_f)
        ok = torch.equal(got_f["embed"], emb) and \
            torch.equal(got_f["toy"], buf)
        print(f"[serve-cluster] materialize_params_on_mesh {label}: node "
              f"buffers exact {ok} (embed {tuple(emb.shape)}, a toy "
              f"(8, 3)); link bytes per chip fast {fast:.0f} slow {slow:.0f}")
        if not ok or slow != 0:
            raise AssertionError(f"materialize_params_on_mesh {label}")
        del w, got_f
    del params, single
    gc.collect()
    torch.cuda.empty_cache()
    return launches


MOE_NAME = "granite-moe-3b-a800m"
# phase 15 serves at 16 of the model's 32 layers and trains at 8 (of the
# 16 whose state fits): the script's time limit holds phase 17 too
MOE_SERVE_LAYERS, MOE_TRAIN_LAYERS = 16, 8


def moe_phase(dev) -> tuple:
    """Phase 15: the MoE family at ``granite-moe-3b-a800m``'s full width
    (d 1536, 24 q / 8 kv heads x 64, 40 experts top 8, d_ff_expert 512,
    f32, seeded weights, ``capacity_factor`` 1.25).  Returns the flash
    forward / backward launches of its main-path runs (each zeroed just
    before and read just after), and (d)'s ``moe_gather`` launches with
    each training run's first routing (label, idx, e0, n_local, capacity),
    which phase 19 checks the entries on."""
    import math
    import numpy as np
    import torch
    from repro_torch.analysis import traffic
    from repro_torch.analysis.profile import (MOE_RANGES, TP_RANGES,
                                              profile_run)
    from repro_torch.analysis.state_rule import state_close
    from repro_torch.configs import get_config
    from repro_torch.core import tree as T
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import flash_attention_bwd as kbwd
    from repro_torch.kernels import moe_gather as kmoe
    from repro_torch.models import ParallelCtx, build, moe
    from repro_torch.models.domains import NodeCache
    from repro_torch.models.meta import store_dim
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime.steps import (cluster_ctx,
                                           make_cluster_train_step)
    from repro_torch.serving.recorded import RecordedDecoder
    from repro_torch.substrate import VirtualCluster
    from repro_torch.substrate.cluster import P

    cfg = get_config(MOE_NAME)
    launches = {"flash_attention": 0, "flash_attention_bwd": 0}
    lengths, S, steps = (SERVE_CLUSTER_LENGTHS, SERVE_CLUSTER_SMAX,
                         SERVE_CLUSTER_STEPS)
    nb = len(lengths)
    rows = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=max(lengths),
                                  global_batch=nb, seed=15)).next_batch()[
        "tokens"]
    prompts = [rows[i, :n].astype(np.int32) for i, n in enumerate(lengths)]
    cpu = torch.device("cpu")

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in T.leaves(tree))

    def model_on(vc, c, mode="hier", opts=("serve_fsdp",), d_=dev):
        ctx = cluster_ctx(vc, mode=mode, opts=opts)
        sizes = dict(zip(vc.axis_names, vc.axis_shapes))
        return build(c, ctx, data=math.prod(sizes[a] for a in
                                            ctx.fsdp_axes), device=d_)

    def specs(m, serve):
        ctx = m.ctx
        return m.param_specs(serve=serve, tp_axis=ctx.tp_axis,
                             fsdp_axis=ctx.fsdp_axes[0] if ctx.fsdp_axes
                             else None)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def flips(a, b):
        """Token rows whose top-k expert sets differ between two route
        records (call order), and the rows compared."""
        n = tot = 0
        for x, y in zip(a["idx"], b["idx"]):
            xs = x.cpu().sort(-1)[0]
            ys = y.cpu().sort(-1)[0]
            n += int((xs != ys).any(-1).sum())
            tot += xs[..., 0].numel()
        return n, tot

    def margin(rt):
        return min(float(m_) for m_ in rt["margin"])

    print(f"[moe] {cfg.name}: d {cfg.d_model}, {cfg.n_heads} q / "
          f"{cfg.n_kv} kv heads x {cfg.head_dim}, {cfg.moe.num_experts} "
          f"experts top {cfg.moe.top_k}, d_ff_expert "
          f"{cfg.moe.d_ff_expert}, vocab {cfg.vocab} (padded "
          f"{cfg.vocab_padded}), {cfg.n_layers} layers, capacity_factor "
          f"{cfg.moe.capacity_factor}, f32")

    # (a) hier serving on 2x4 at MOE_SERVE_LAYERS, serve_fsdp: phase 14's
    # workload, the sync decode and RecordedDecoder
    t_a = time.perf_counter()
    vc = VirtualCluster(pods=2, chips=4, device=dev)
    cfgA = dataclasses.replace(cfg, n_layers=MOE_SERVE_LAYERS)
    m = model_on(vc, cfgA)
    params = m.init_params(15)
    w_bytes = nbytes(params)
    print(f"[moe] serving at {cfgA.n_layers} of {cfg.n_layers} layers: "
          f"parameters {sum(t.numel() for t in T.leaves(params))} "
          f"({w_bytes / 1e9:.3f} GB of f32, vocab padding included; "
          f"config.param_count() {cfgA.param_count()})")
    with vc.bind():
        train = vc.layout(params, specs(m, False))
        cache = m.cache_init(nb, S)
        first = []
        kflash.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pr in prompts:
            toks = torch.from_numpy(np.concatenate([pr, pr[-1:]])[None])
            c, lg = m.prefill_fn(train, {"tokens": vc.layout(toks, P())}, S)
            cache.copy_row(c, 0, len(first))
            first.append(lg[0, 0, 0])
            del c
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        fl = kflash.launches
        launches["flash_attention"] += fl
        first = torch.stack(first)
        del train
        free()
        want_fl = vc.pods * cfgA.n_layers * nb
        print(f"[moe] 2x4 hier: prefill of {nb} prompts ({lengths[0]}-"
              f"{lengths[-1]} tokens, one run per node) {pre_ms:.1f} ms; "
              f"flash_attention launches {fl} ({vc.pods} nodes x "
              f"{cfgA.n_layers} layers x {nb})")
        if fl != want_fl:
            raise AssertionError(f"moe prefill launches {fl} != {want_fl}")
        base = traffic.device_bytes(dev)
        serve = vc.layout(params, specs(m, True))
        stored = traffic.device_bytes(dev) - base
        del params
        free()

        def decode_loop(decode, cache_, count):
            tok, pos = first.argmax(-1), torch.tensor(lengths)
            out, ms, drop = [], [], []
            for _ in range(steps):
                with (moe.routes() if count
                      else contextlib.nullcontext()) as dr:
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    cache_, lg_ = decode(serve, cache_,
                                         vc.layout(tok[:, None].int(), P()),
                                         vc.layout(pos, P()))
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t1) * 1e3)
                if count:
                    assigned, kept = moe.drops(dr)
                    drop.append(1 - kept / assigned)
                out.append(lg_[0, :, 0].clone())
                tok, pos = out[-1].argmax(-1), pos + 1
            return out, ms, cache_, drop

        def report(label, ms):
            tail = ms[1:]
            print(f"[moe] 2x4 {label}: decode step p50 "
                  f"{1e3 * pct(tail, 0.5):.0f} us p99 "
                  f"{1e3 * pct(tail, 0.99):.0f} us (steps 2-{len(ms)}; "
                  f"step 1 {ms[0]:.1f} ms), "
                  f"{nb * len(tail) / sum(tail) * 1e3:.1f} tokens/s")

        c_sync = NodeCache(T.tree_map(lambda t: t.clone(), dict(cache)),
                           cache.domains)
        sync, s_ms, c_sync, drop = decode_loop(m.decode_fn, c_sync, True)
        report("sync (routes recorded: a top-k and 2 reductions a layer)",
               s_ms)
        print(f"[moe] 2x4: dropped share of the routing assignments per "
              f"decode step (capacity {cfg.moe.capacity_factor} over the "
              f"node's gathered 4 x {nb} tokens): "
              f"{[round(x, 4) for x in drop]}")
        dec = RecordedDecoder(m)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        rec, r_ms, c_rec, _ = decode_loop(dec, cache, False)
        peak = torch.cuda.max_memory_allocated(dev) - held
        report("recorded", r_ms)
        same = all(torch.equal(a, b) for a, b in zip(sync, rec)) and all(
            torch.equal(a, b) for a, b in zip(T.leaves(dict(c_sync)),
                                              T.leaves(dict(c_rec))))
        (sched,) = dec.schedules.values()
        n_g = sum(n.family == "gather" for n in sched.graph.nodes)
        n_store = sum(store_dim(mt) is not None
                      for mt in T.leaves(m.serve_defs))
        print(f"[moe] 2x4: recorded == sync (every step's logits and the "
              f"final cache, torch.equal) {same}; schedule built once, "
              f"replayed {steps - 1} times, gathers {n_g} (node-stored "
              f"leaves {n_store}, the experts' w_in / w_out along their "
              f"d_ff included)")
        print(f"[moe] 2x4: stored weights {stored / 1e9:.3f} GB "
              f"({stored / w_bytes:.2f} x {w_bytes / 1e9:.3f} GB: one copy "
              f"per node, expert leaves included); a recorded step's peak "
              f"above the held state {peak / 1e9:.3f} GB (the node "
              f"buffers: {stored / 1e9:.3f} GB)")
        if not same or n_g != n_store or len(dec.schedules) != 1:
            raise AssertionError(f"moe: recorded differs from sync or "
                                 f"gathers {n_g} != {n_store}")
        if stored != vc.pods * w_bytes or peak > stored + 2 ** 31:
            raise AssertionError(f"moe: stored {stored}, recorded step "
                                 f"peak {peak}")
        if not all(torch.isfinite(x).all() for x in sync):
            raise AssertionError("moe: non-finite decode logits")
        # one sync decode step under the profiler: the MoE block's parts
        c_p = NodeCache(T.tree_map(lambda t: t.clone(), dict(c_rec)),
                        cache.domains)
        tok = vc.layout(rec[-1].argmax(-1)[:, None].int(), P())
        pos = vc.layout(torch.tensor(lengths) + steps, P())
        r = profile_run(lambda: m.decode_fn(serve, c_p, tok, pos),
                        ranges=MOE_RANGES)
        moe_ms = sum(r["ranges"].values())
        print(f"[moe] 2x4: one sync decode step profiled: wall "
              f"{r['wall_ms']:.1f} ms, device busy {r['busy_ms']:.1f} ms "
              f"({100 * r['busy_share']:.1f}%); MoE block parts "
              f"{moe_ms:.3f} ms ({100 * moe_ms / r['busy_ms']:.1f}% of busy:"
              f" { {k: round(v, 3) for k, v in r['ranges'].items()} })")
        del serve, cache, c_sync, c_rec, c_p, sync, rec
    free()
    print(f"[phase] moe (a) {time.perf_counter() - t_a:.1f} s")

    # (b) card against CPU at 2 layers, full width: the routing tables
    # first (flips and the smallest top-k margin); where any differs, the
    # card run again on the CPU's routing
    t_b = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    p2 = T.tree_map(lambda t: t.cpu(), model_on(
        VirtualCluster(pods=2, chips=4, device=dev), cfg2).init_params(16))
    toks2 = torch.from_numpy(rows[1:3, :257].astype(np.int32))
    feed = torch.from_numpy(rows[1:3, 257:261].astype(np.int32))

    def serve2(d_, replay=None):
        vc_d = VirtualCluster(pods=2, chips=4, device=d_)
        m2 = model_on(vc_d, cfg2, d_=d_)
        pp = T.tree_map(lambda t: t.to(d_), p2)
        with vc_d.bind(), moe.routes(replay) as rt:
            cache, lg = m2.prefill_fn(vc_d.layout(pp, specs(m2, False)),
                                      {"tokens": vc_d.layout(toks2, P())},
                                      512)
            sp = vc_d.layout(pp, specs(m2, True))
            outs = [lg[0].cpu()]
            for i in range(4):
                cache, lg = m2.decode_fn(
                    sp, cache, vc_d.layout(feed[:, i:i + 1], P()),
                    vc_d.layout(torch.tensor([256 + i] * 2), P()))
                outs.append(lg[0].cpu())
        return outs, {k: [t.cpu() for t in v] for k, v in rt.items()
                      if k != "replay"}

    def compare_serve(replay):
        card, rt_card = serve2(dev, replay)
        errs = [rel_err(a, b) for a, b in zip(card, want)]
        return card, rt_card, errs

    want, rt_cpu = serve2(cpu)
    card, rt_card, errs = compare_serve(None)
    n_flip, n_rows = flips(rt_card, rt_cpu)
    line = (f"[moe] card vs CPU, 2x4 hier, 2 layers: prefill 2 x 256 and "
            f"4 decode steps; routing tables: {n_flip} of {n_rows} token "
            f"rows flipped, smallest top-{cfg.moe.top_k} margin "
            f"{margin(rt_cpu):.3g}; logits rel_err "
            f"{[f'{e:.3g}' for e in errs]}")
    if n_flip:
        card, _, errs = compare_serve(rt_cpu["idx"])
        line += f"; on the CPU's routing {[f'{e:.3g}' for e in errs]}"
    print(line)
    if max(errs) > 1e-4:
        raise AssertionError(f"moe serving card vs CPU: {errs}")

    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=128,
                                   global_batch=8, seed=7)).next_batch()

    def train2(d_, replay=None):
        vc_d = VirtualCluster(pods=2, chips=4, device=d_)
        bundle = make_cluster_train_step(cfg2, vc_d, mode="hier",
                                         global_batch=8)
        pp = T.tree_map(lambda t: t.to(d_), p2)
        m_, v_ = adamw_init(pp)
        state = bundle.layout_state({"params": pp, "m": m_, "v": v_,
                                     "step": torch.zeros(
                                         (), dtype=torch.int32)})
        with moe.routes(replay) as rt:
            state, mt = bundle.step(state, bundle.layout_batch(batch))
        glob = bundle.unlayout_state(state)
        out = (float(mt["loss"][0]), float(mt["gnorm"][0]),
               T.tree_map(lambda t: t.cpu(), {g_: glob[g_] for g_ in
                                              ("params", "m", "v")}))
        return out, {k: [t.cpu() for t in v] for k, v in rt.items()
                     if k != "replay"}

    t_cpu, rt_cpu = train2(cpu)
    t_card, rt_card = train2(dev)
    n_flip, n_rows = flips(rt_card, rt_cpu)
    line = (f"[moe] card vs CPU, hier 2x4, 2 layers, 8 x 128, one train "
            f"step: routing tables {n_flip} of {n_rows} token rows flipped "
            f"(forward and remat), smallest top-{cfg.moe.top_k} margin "
            f"{margin(rt_cpu):.3g}")
    if n_flip:
        t_card, _ = train2(dev, rt_cpu["idx"])
        line += "; compared on the CPU's routing"
    (lg_, gg, sg), (lc, gc_, sc) = t_card, t_cpu
    if not (abs(lg_ - lc) <= 2e-4 * abs(lc) and abs(gg - gc_) <= 5e-3 * gc_):
        raise AssertionError(f"moe train card vs CPU: loss {lg_} / {lc}, "
                             f"gnorm {gg} / {gc_}")
    excused, total, worst = state_close(sg, sc, 1, "moe card vs CPU")
    print(line + f": loss {lg_:.6f} vs {lc:.6f}, gnorm {gg:.6f} vs "
          f"{gc_:.6f}, m and v per leaf within rtol 2e-4 atol 2e-5 of the "
          f"leaf's largest (worst m {worst['m']:.3g}, v {worst['v']:.3g} of "
          f"that tolerance), updated params within rtol 2e-4 atol 2e-5 but "
          f"{excused} of {total} elements where AdamW's update is "
          f"ill-conditioned")
    del p2, want, card, t_cpu, t_card
    free()
    print(f"[phase] moe (b) {time.perf_counter() - t_b:.1f} s")

    # (c) the weight C1 of MoE serving: naive against hier on 2x4, 4 layers
    t_c = time.perf_counter()
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    vc = VirtualCluster(pods=2, chips=4, device=dev)
    p4 = model_on(vc, cfg4).init_params(17)
    held, got = {}, {}
    tok0 = torch.from_numpy(rows[:, :1].astype(np.int32))
    for mode in ("hier", "naive"):
        m4 = model_on(vc, cfg4, mode)
        with vc.bind():
            base = traffic.device_bytes(dev)
            lay = vc.layout(p4, specs(m4, True))
            held[mode] = (traffic.device_bytes(dev) - base) / vc.pods
            cache = m4.cache_init(nb, 1024)
            tok, outs = tok0, []
            with moe.routes() as dr:
                for i in range(2):
                    cache, lg = m4.decode_fn(lay, cache, vc.layout(tok, P()),
                                             vc.layout(torch.arange(nb) + i,
                                                       P()))
                    outs.append(lg[0].clone())
                    tok = lg[0, :, 0].argmax(-1)[:, None].int().cpu()
            assigned, kept = moe.drops(dr)
            got[mode] = (outs, cache.domains.count, 1 - kept / assigned)
            del lay, cache
        free()
    c1 = held["naive"] / held["hier"]
    err_c = max(rel_err(a, b) for a, b in zip(got["naive"][0],
                                              got["hier"][0]))
    print(f"[moe] naive vs hier on 2x4, 4 layers, serve_fsdp: weight bytes "
          f"per node {held['naive'] / 1e9:.3f} / {held['hier'] / 1e9:.3f} GB,"
          f" C1 naive/hier {c1} (chips {vc.chips}); caches "
          f"{got['naive'][1]} / {got['hier'][1]}; 2 decode steps' logits "
          f"rel_err {err_c:.3g} (dropped share naive {got['naive'][2]:.4f},"
          f" hier {got['hier'][2]:.4f}: naive's capacity counts its rank's "
          f"{nb} tokens, hier's the node's 4 x {nb}, as in the reference)")
    if c1 != vc.chips or not all(torch.isfinite(x).all()
                                 for x in got["naive"][0] + got["hier"][0]):
        raise AssertionError(f"moe serving C1 {c1} != {vc.chips}")
    del p4, got
    free()
    print(f"[phase] moe (c) {time.perf_counter() - t_c:.1f} s")

    # (d) training with make_cluster_train_step, 8 x 2048 tokens, hier, on
    # 2x4 (ep 1) and 2x(2x2) (ep 2, tp_ff 1), at the deepest depth whose
    # state (params, m, v, grads: 2 node copies each) and a domain's
    # gradient fit beside 16 GiB of transients
    t_d = time.perf_counter()
    one = build(dataclasses.replace(cfg, n_layers=1), ParallelCtx.single(),
                device="meta")
    lay1 = one.abstract_params(one.param_specs())
    per_layer = 4 * sum(t.numel() for t in T.leaves(lay1["units"]))
    rest = 4 * sum(t.numel() for k_, v_ in lay1.items() if k_ != "units"
                   for t in T.leaves({k_: v_}))
    free_b = torch.cuda.mem_get_info(dev)[0]
    fit = min(cfg.n_layers, int((free_b - 16 * 2 ** 30 - 9 * rest)
                                // (9 * per_layer)))
    L = min(fit, MOE_TRAIN_LAYERS)
    cfgL = dataclasses.replace(cfg, n_layers=L)
    print(f"[moe] training depth {L} of {cfg.n_layers} ({fit} fit): per node "
          f"{(rest + L * per_layer) / 1e9:.3f} GB of params ({per_layer / 1e9:.3f}"
          f" GB a layer), state x 2 node copies x (params, m, v, grads) "
          f"{8 * (rest + L * per_layer) / 1e9:.2f} GB of "
          f"{free_b / 1e9:.1f} GB free (full depth would need "
          f"{8 * (rest + cfg.n_layers * per_layer) / 1e9:.1f} GB)")
    batches = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=2048,
                                     global_batch=8, seed=7))
    batches = [batches.next_batch() for _ in range(3)]
    train_rows = {}
    # each step: dispatch and combine in each layer's forward and its
    # recompute, combine_bwd and dispatch_bwd in its backward, 2 node runs
    rows_per_step = {"dispatch": 4 * L, "combine": 4 * L,
                     "combine_bwd": 2 * L, "dispatch_bwd": 2 * L}
    gathers = {"launches": 0, "routings": []}
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    for label in ("2x4", "2x(2x2)"):
        vc = VirtualCluster.from_label(label, device=dev)
        bundle = make_cluster_train_step(cfgL, vc, mode="hier",
                                         global_batch=8)
        state = bundle.init_layout_state(18)
        nb_ = {g_: nbytes(state[g_]) for g_ in ("params", "m", "v")}
        ctx = bundle.model.ctx
        tp = ctx.tp
        kflash.launches = kbwd.launches = 0
        kmoe.launches.update(dict.fromkeys(kmoe.ENTRIES, 0))
        ms, losses, drop = [], [], None
        for i, b_ in enumerate(batches):
            laid = bundle.layout_batch(b_)
            with (moe.routes() if i == 0
                  else contextlib.nullcontext()) as dr:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                state, mt = bundle.step(state, laid)
                loss, gnorm = float(mt["loss"][0]), float(mt["gnorm"][0])
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t1) * 1e3)
            if i == 0:
                assigned, kept = moe.drops(dr)
                drop = 1 - kept / assigned
                # layer 0's routing in the first node run, and its tables'
                # parameters as moe_block derives them
                r_idx = dr["idx"][0]
                ep, tp_ff = cfg.moe.ep_tp(tp)
                e0 = ((torch.arange(tp, device=dev) // tp_ff
                       * (E // ep)).reshape(-1, 1) if ctx.tp_axis else 0)
                gathers["routings"].append((
                    label, r_idx, e0, E // ep,
                    int(r_idx.shape[-2] * k / E * cfg.moe.capacity_factor)
                    + 1))
            if not (np.isfinite(loss) and np.isfinite(gnorm)):
                raise AssertionError(f"moe train {label}: loss {loss}")
            losses.append(loss)
            print(f"[train] {cfg.name} {L} layers hier {label} 8x2048 step "
                  f"{i + 1}: loss {loss:.6f} gnorm {gnorm:.6f} step "
                  f"{ms[-1]:.1f} ms {8 * 2048 / ms[-1] * 1e3:.1f} tokens/s")
        fl = {"flash_attention": kflash.launches,
              "flash_attention_bwd": kbwd.launches}
        for k_, v_ in fl.items():
            launches[k_] += v_
            if v_ <= 0:
                raise AssertionError(f"moe train {label} never launched {k_}")
        got_rows = dict(kmoe.launches)
        want_rows = {k_: 3 * v_ for k_, v_ in rows_per_step.items()}
        if got_rows != want_rows:
            raise AssertionError(f"moe train {label}: moe_gather launches "
                                 f"{got_rows}, want {want_rows}")
        gathers["launches"] += sum(got_rows.values())
        nb_["grads"] = bundle.stats["grad_bytes"]
        print(f"[moe] train {label} (tp {tp}, ep x tp_ff "
              f"{cfg.moe.ep_tp(tp)}): steps 2-3 "
              f"{sum(ms[1:]) / 2:.1f} ms, "
              f"{8 * 2048 * 2 / sum(ms[1:]) * 1e3:.1f} tokens/s; dropped "
              f"share of the assignments in step 1 {drop:.4f}; state "
              + ", ".join(f"{k_} {v_ / 1e9:.3f} GB" for k_, v_ in nb_.items())
              + f"; peak allocated {torch.cuda.max_memory_allocated(dev) / 1e9:.1f}"
              f" GB; launches flash_attention (forward) "
              f"{fl['flash_attention']}, flash_attention_bwd "
              f"{fl['flash_attention_bwd']}, moe_gather {got_rows}")
        r = profile_run(lambda: bundle.step(state, laid),
                        ranges=TP_RANGES + MOE_RANGES)
        tp_ms = sum(v_ for k_, v_ in r["ranges"].items()
                    if k_.startswith(TP_RANGES))
        moe_ms = {k_: round(v_, 2) for k_, v_ in r["ranges"].items()
                  if k_.startswith(MOE_RANGES)}
        print(f"[moe] train {label}: one step profiled: wall "
              f"{r['wall_ms']:.1f} ms, device busy {r['busy_ms']:.1f} ms "
              f"({100 * r['busy_share']:.1f}%); tp collectives (the MoE "
              f"reduce-scatter included) {tp_ms:.2f} ms "
              f"({100 * tp_ms / r['busy_ms']:.1f}%); MoE block parts "
              f"{sum(moe_ms.values()):.2f} ms "
              f"({100 * sum(moe_ms.values()) / r['busy_ms']:.1f}%: {moe_ms})")
        train_rows[label] = sum(ms[1:]) / 2
        del bundle, state, laid
        free()
        torch.cuda.reset_peak_memory_stats(dev)

    # the training C1 at 2 layers: naive against hier on 2x4 under PERF.md
    # §2's rule, each of 2 steps from a common state (hier's after step
    # 1), so the rule's conditioning test (the final v) is the step's own;
    # the routing tables compared first: hier runs a node's 4 ranks' rows
    # in one batch, naive each rank's alone, so their products round apart
    # and a near-tie top 8 may flip, after which naive is held on hier's
    # routing; then the state bytes on 2x(2x2)
    vc = VirtualCluster(pods=2, chips=4, device=dev)

    def one_step(mode, i, start, replay=None):
        """Step ``i`` of ``mode`` from the global state ``start`` (None:
        the seeded init): the metrics, the state bytes, the updated
        global state on the CPU, the routing ids."""
        bundle = make_cluster_train_step(cfg2, vc, mode=mode, global_batch=8)
        state = bundle.init_layout_state(19) if start is None else \
            bundle.layout_state(T.tree_map(lambda t: t.to(dev), start))
        nb_ = {g_: nbytes(state[g_]) for g_ in ("params", "m", "v")}
        with moe.routes(replay) as rt:
            state, mt = bundle.step(state, bundle.layout_batch(batches[i]))
        nb_["grads"] = bundle.stats["grad_bytes"]
        glob = T.tree_map(lambda t: t.cpu(), bundle.unlayout_state(state))
        del bundle, state
        free()
        return ((float(mt["loss"][0]), float(mt["gnorm"][0])), nb_, glob,
                rt["idx"])

    def per_rank(calls_idx):
        """hier's routes (a node's members folded) in naive's call order
        (a domain per rank, each member's rows alone)."""
        n = len(calls_idx) // vc.pods
        return [calls_idx[d * n + j][m_:m_ + 1] for d in range(vc.pods)
                for m_ in range(vc.chips) for j in range(n)]

    start, rows_hvn, n_flip, n_rows, excused, total = None, [], 0, 0, 0, 0
    worst = {"m": 0.0, "v": 0.0}
    for i in range(2):
        h_ = one_step("hier", i, start)
        n_ = one_step("naive", i, start)
        want = per_rank(h_[3])
        f_, t_ = flips({"idx": n_[3]}, {"idx": want})
        n_flip, n_rows = n_flip + f_, n_rows + t_
        if f_:
            n_ = one_step("naive", i, start, want)
        (lh, gh), (ln, gn) = h_[0], n_[0]
        if not (abs(lh - ln) <= 2e-4 * abs(ln) and abs(gh - gn) <= 5e-3 * gn):
            raise AssertionError(f"moe hier vs naive step {i + 1}: loss "
                                 f"{lh} / {ln}, gnorm {gh} / {gn}")
        ex, tot, w_ = state_close(n_[2], h_[2], i + 1,
                                  f"moe hier vs naive step {i + 1}")
        excused, total = excused + ex, total + tot
        worst = {k_: max(worst[k_], w_[k_]) for k_ in worst}
        rows_hvn.append((lh, ln))
        c1 = {g_: n_[1][g_] / h_[1][g_] for g_ in h_[1]}
        start = h_[2]
        del h_, n_
    del start
    c1_tp = {}
    vc_tp = VirtualCluster.from_label("2x(2x2)", device=dev)
    for mode in ("hier", "naive"):
        bundle = make_cluster_train_step(cfg2, vc_tp, mode=mode,
                                         global_batch=8)
        state = bundle.init_layout_state(19)
        c1_tp[mode] = {g_: nbytes(state[g_]) for g_ in ("params", "m", "v")}
        del bundle, state
        free()
    c1_tp = {g_: c1_tp["naive"][g_] / c1_tp["hier"][g_] for g_ in c1_tp["hier"]}
    print(f"[moe] hier vs naive, 2x4, 2 layers, 2 steps of 8 x 2048, each "
          f"from hier's state: routing tables {n_flip} of {n_rows} token "
          f"rows flipped{' (naive held on hier routing)' if n_flip else ''}"
          f"; loss (hier, naive) {rows_hvn}, m and v within the rule (worst "
          f"m {worst['m']:.3g}, v {worst['v']:.3g}), params but {excused} "
          f"of {total} ill-conditioned; C1 naive/hier by group {c1} on 2x4 "
          f"(chips 4), {c1_tp} on 2x(2x2) (store 2)")
    if set(c1.values()) != {4.0} or set(c1_tp.values()) != {2.0}:
        raise AssertionError(f"moe training C1 {c1} / {c1_tp}")
    free()
    print(f"[phase] moe (d) {time.perf_counter() - t_d:.1f} s")
    return launches, gathers


XLSTM_NAME = "xlstm-1.3b"
#: device bytes kept free for a training step's activations beside its
#: state: one unit's recompute and backward at 4 x 2048 tokens a domain (7
#: mLSTM layers' chunk states and intermediates, the sLSTM loop's
#: carries).  A one-unit step on 2x(2x2) peaked 43.4 GB above its 19.5 GB
#: of state on an H100 (2x4: 38.3 GB); this keeps ~6 GB more
XLSTM_TRAIN_TRANSIENTS = 46 * 2 ** 30
# phase 16 (a) serves at 1 of xlstm-1.3b's 6 units and (d) trains one unit
# at 8 x 1024 tokens: the sLSTM time loop makes both host-bound (~6,400
# launches a decode step, ~68 device activities a training time step), and
# the script's time limit holds phases 17 and 18 too, on a slow host as well
XLSTM_SERVE_UNITS, XLSTM_TRAIN_T = 1, 1024


def xlstm_phase(dev, cfg=None) -> dict:
    """Phase 16: the xLSTM family at ``xlstm-1.3b``'s full width (d 2048,
    4 heads of 1024, d_inner 4096, conv 4, vocab 50304; 6 units of 7 mLSTM
    + 1 sLSTM), f32, seeded weights.  The blocks reach no Pallas kernel in
    the reference; here their products that fill the card take the panel
    matmul (``ParallelCtx.mm``) and nothing else is hand-written: returns
    the kernel launches of its main-path runs (zeroed just before each,
    read just after), which must be 0 for every kernel but ``matmul``.
    ``cfg`` stands in for the full-width config (a reduced one rehearses
    the phase on the CPU)."""
    import math
    import numpy as np
    import torch
    from repro_torch.analysis import traffic
    from repro_torch.analysis.profile import (TP_RANGES, XLSTM_RANGES,
                                              profile_run)
    from repro_torch.analysis.state_rule import state_close
    from repro_torch.configs import get_config
    from repro_torch.core import tree as T
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import flash_attention_bwd as kbwd
    from repro_torch.kernels import lru_scan as klru
    from repro_torch.kernels import lru_scan_bwd as klrub
    from repro_torch.kernels import matmul as kmatmul
    from repro_torch.kernels import quant as kquant
    from repro_torch.models import ParallelCtx, build, meta
    from repro_torch.models.domains import NodeCache
    from repro_torch.models.meta import store_dim
    from repro_torch.models.transformer import MLSTM_CHUNK
    from repro_torch.models.xlstm import slstm_block
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime.steps import (cluster_ctx,
                                           make_cluster_train_step)
    from repro_torch.serving.recorded import RecordedDecoder
    from repro_torch.substrate import VirtualCluster
    from repro_torch.substrate.cluster import P

    cfg = cfg or get_config(XLSTM_NAME)
    kernels = {"matmul": kmatmul, "q4_matmul": kquant,
               "flash_attention": kflash, "flash_attention_bwd": kbwd,
               "lru_scan": klru, "lru_scan_bwd": klrub}
    launches = dict.fromkeys(kernels, 0)

    def zero():
        for k_ in kernels.values():
            k_.launches = 0

    def read(what):
        got = {n: k_.launches for n, k_ in kernels.items()}
        for n, v in got.items():
            launches[n] += v
        if any(v for n, v in got.items() if n != "matmul"):
            raise AssertionError(f"xlstm {what} launched {got}: the xLSTM "
                                 f"path has no hand-written kernel but the "
                                 f"panel matmul")

    lengths, S, steps = (SERVE_CLUSTER_LENGTHS, SERVE_CLUSTER_SMAX,
                         SERVE_CLUSTER_STEPS)
    nb = len(lengths)
    rows = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=max(lengths),
                                  global_batch=nb, seed=24)).next_batch()[
        "tokens"]
    prompts = [rows[i, :n].astype(np.int32) for i, n in enumerate(lengths)]
    cpu = torch.device("cpu")
    hd = cfg.d_inner // cfg.n_heads

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in T.leaves(tree))

    def model_on(vc, c, mode="hier", opts=("serve_fsdp",), d_=dev):
        ctx = cluster_ctx(vc, mode=mode, opts=opts)
        sizes = dict(zip(vc.axis_names, vc.axis_shapes))
        return build(c, ctx, data=math.prod(sizes[a] for a in
                                            ctx.fsdp_axes), device=d_)

    def specs(m, serve):
        ctx = m.ctx
        return m.param_specs(serve=serve, tp_axis=ctx.tp_axis,
                             fsdp_axis=ctx.fsdp_axes[0] if ctx.fsdp_axes
                             else None)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def sync():
        torch.cuda.synchronize()

    print(f"[xlstm] {cfg.name}: d {cfg.d_model}, {cfg.n_heads} heads x "
          f"{hd} (d_inner {cfg.d_inner}), conv {cfg.conv_kernel}, vocab "
          f"{cfg.vocab} (padded {cfg.vocab_padded}), {cfg.n_layers} layers "
          f"= {cfg.n_units} units of {cfg.pattern.count('mlstm')} mLSTM + "
          f"{cfg.pattern.count('slstm')} sLSTM, f32")

    # (a) hier serving on 2x4 at full depth, serve_fsdp: phase 14's 8
    # prompts (none a multiple of the 128-token chunk: the ragged chunk),
    # 32 greedy decode steps, sync and recorded
    t_a = time.perf_counter()
    vc = VirtualCluster(pods=2, chips=4, device=dev)
    cfgA = dataclasses.replace(cfg, n_layers=XLSTM_SERVE_UNITS
                               * len(cfg.pattern))
    m = model_on(vc, cfgA)
    params = m.init_params(24)
    w_bytes = nbytes(params)
    print(f"[xlstm] serving at {cfgA.n_units} of {cfg.n_units} units "
          f"({cfgA.n_layers} layers): parameters "
          f"{sum(t.numel() for t in T.leaves(params))} ({w_bytes / 1e9:.3f} "
          f"GB of f32, vocab padding included; config.param_count() "
          f"{cfgA.param_count()})")
    with vc.bind():
        train = vc.layout(params, specs(m, False))
        cache = m.cache_init(nb, S)
        first = []
        zero()
        sync()
        t0 = time.perf_counter()
        for pr in prompts:
            toks = torch.from_numpy(np.concatenate([pr, pr[-1:]])[None])
            c, lg = m.prefill_fn(train, {"tokens": vc.layout(toks, P())}, S)
            cache.copy_row(c, 0, len(first))
            first.append(lg[0, 0, 0])
            del c
        sync()
        pre_ms = (time.perf_counter() - t0) * 1e3
        read("prefill")
        first = torch.stack(first)
        per_node = nbytes(dict(cache)) / vc.pods
        by_kind = {}
        for key, leaves in cache["units"].items():
            kind = cfg.pattern[int(key[1:])]
            by_kind[kind] = by_kind.get(kind, 0) + nbytes(leaves) / vc.pods
        print(f"[xlstm] 2x4 hier: prefill of {nb} prompts ({lengths[0]}-"
              f"{lengths[-1]} tokens, one run per node) {pre_ms:.1f} ms "
              f"({vc.pods * sum(lengths) / pre_ms * 1e3:.1f} tokens/s over "
              f"both nodes' runs); decode state {per_node / 1e9:.3f} GB per "
              f"node for {nb} rows (mLSTM {by_kind['mlstm'] / 1e9:.3f} GB: "
              f"C / n / m / conv of "
              f"{cfgA.n_units * cfg.pattern.count('mlstm')}"
              f" layers, sLSTM {by_kind['slstm'] / 1e9:.4f} GB)")
        del train
        free()
        base = traffic.device_bytes(dev)
        serve = vc.layout(params, specs(m, True))
        stored = traffic.device_bytes(dev) - base
        del params
        free()

        def decode_loop(decode, cache_):
            tok, pos = first.argmax(-1), torch.tensor(lengths)
            out, ms = [], []
            for _ in range(steps):
                sync()
                t1 = time.perf_counter()
                cache_, lg_ = decode(serve, cache_,
                                     vc.layout(tok[:, None].int(), P()),
                                     vc.layout(pos, P()))
                sync()
                ms.append((time.perf_counter() - t1) * 1e3)
                out.append(lg_[0, :, 0].clone())
                tok, pos = out[-1].argmax(-1), pos + 1
            return out, ms, cache_

        def report(label, ms):
            tail = ms[1:]
            print(f"[xlstm] 2x4 {label}: decode step p50 "
                  f"{1e3 * pct(tail, 0.5):.0f} us p99 "
                  f"{1e3 * pct(tail, 0.99):.0f} us (steps 2-{len(ms)}; "
                  f"step 1 {ms[0]:.1f} ms), "
                  f"{nb * len(tail) / sum(tail) * 1e3:.1f} tokens/s (phase "
                  f"16 (a) at {time.perf_counter() - t_a:.1f} s)")

        c_sync = NodeCache(T.tree_map(lambda t: t.clone(), dict(cache)),
                           cache.domains)
        zero()
        sync_out, s_ms, c_sync = decode_loop(m.decode_fn, c_sync)
        report("sync", s_ms)
        dec = RecordedDecoder(m)
        sync()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        rec, r_ms, c_rec = decode_loop(dec, cache)
        peak = torch.cuda.max_memory_allocated(dev) - held
        report("recorded", r_ms)
        read("decode")
        same = all(torch.equal(a, b) for a, b in zip(sync_out, rec)) and all(
            torch.equal(a, b) for a, b in zip(T.leaves(dict(c_sync)),
                                              T.leaves(dict(c_rec))))
        (sched,) = dec.schedules.values()
        n_g = sum(n.family == "gather" for n in sched.graph.nodes)
        n_store = sum(store_dim(mt) is not None
                      for mt in T.leaves(m.serve_defs))
        print(f"[xlstm] 2x4: recorded == sync (every step's logits and the "
              f"final state, torch.equal) {same}; schedule built once, "
              f"replayed {steps - 1} times, gathers {n_g} (node-stored "
              f"leaves {n_store})")
        print(f"[xlstm] 2x4: stored weights {stored / 1e9:.3f} GB "
              f"({stored / w_bytes:.2f} x {w_bytes / 1e9:.3f} GB: one copy "
              f"per node); a recorded step's peak above the held state "
              f"{peak / 1e9:.3f} GB (the node buffers: {stored / 1e9:.3f} GB)")
        if not same or n_g != n_store or len(dec.schedules) != 1:
            raise AssertionError(f"xlstm: recorded differs from sync or "
                                 f"gathers {n_g} != {n_store}")
        if stored != vc.pods * w_bytes or peak > stored + 2 ** 31:
            raise AssertionError(f"xlstm: stored {stored}, recorded step "
                                 f"peak {peak}")
        if not all(torch.isfinite(x).all() for x in sync_out):
            raise AssertionError("xlstm: non-finite decode logits")
        # one sync decode step under the profiler: the blocks' parts
        c_p = NodeCache(T.tree_map(lambda t: t.clone(), dict(c_rec)),
                        cache.domains)
        tok = vc.layout(rec[-1].argmax(-1)[:, None].int(), P())
        pos = vc.layout(torch.tensor(lengths) + steps, P())
        zero()
        r = profile_run(lambda: m.decode_fn(serve, c_p, tok, pos),
                        ranges=XLSTM_RANGES)
        read("profiled decode")
        x_ms = sum(r["ranges"].values())
        print(f"[xlstm] 2x4: one sync decode step profiled: wall "
              f"{r['wall_ms']:.1f} ms, device busy {r['busy_ms']:.1f} ms "
              f"({100 * r['busy_share']:.1f}%), {r['launches']} device "
              f"activities; xLSTM parts {x_ms:.3f} ms "
              f"({100 * x_ms / r['busy_ms']:.1f}% of busy: "
              f"{ {k: round(v, 3) for k, v in r['ranges'].items()} }; host "
              f"{ {k: round(v, 1) for k, v in r['ranges_wall'].items()} } "
              f"ms)")
        del serve, cache, c_sync, c_rec, c_p, sync_out, rec
    free()
    print(f"[phase] xlstm (a) {time.perf_counter() - t_a:.1f} s")

    # (b) one pattern unit (8 layers) at full width, card against CPU, hier
    # on one node (1x4): a 130-token prefill (a ragged second chunk) of 2
    # prompts and 4 decode steps, then one train step of 8 x 32 tokens
    t_b = time.perf_counter()
    cfg8 = dataclasses.replace(cfg, n_layers=len(cfg.pattern))
    p8 = T.tree_map(lambda t: t.cpu(), model_on(
        VirtualCluster(pods=2, chips=4, device=dev), cfg8).init_params(25))
    toks2 = torch.from_numpy(rows[1:3, :131].astype(np.int32))
    feed = torch.from_numpy(rows[1:3, 131:135].astype(np.int32))

    def serve8(d_):
        vc_d = VirtualCluster(pods=1, chips=4, device=d_)
        m8 = model_on(vc_d, cfg8, d_=d_)
        pp = T.tree_map(lambda t: t.to(d_), p8)
        with vc_d.bind():
            cache, lg = m8.prefill_fn(vc_d.layout(pp, specs(m8, False)),
                                      {"tokens": vc_d.layout(toks2, P())},
                                      512)
            sp = vc_d.layout(pp, specs(m8, True))
            outs = [lg[0].cpu()]
            for i in range(4):
                cache, lg = m8.decode_fn(
                    sp, cache, vc_d.layout(feed[:, i:i + 1], P()),
                    vc_d.layout(torch.tensor([130 + i] * 2), P()))
                outs.append(lg[0].cpu())
        return outs

    zero()
    card = serve8(dev)
    read("card-vs-CPU serving")
    errs = [rel_err(a, b) for a, b in zip(card, serve8(cpu))]
    print(f"[xlstm] card vs CPU, 1x4 hier, {cfg8.n_layers} layers: prefill "
          f"2 x 130 and 4 decode steps, logits rel_err "
          f"{[f'{e:.3g}' for e in errs]}")
    if max(errs) > 1e-4:
        raise AssertionError(f"xlstm serving card vs CPU: {errs}")

    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                   global_batch=8, seed=7)).next_batch()

    def train8(d_):
        vc_d = VirtualCluster(pods=1, chips=4, device=d_)
        bundle = make_cluster_train_step(cfg8, vc_d, mode="hier",
                                         global_batch=8)
        pp = T.tree_map(lambda t: t.to(d_), p8)
        m_, v_ = adamw_init(pp)
        state = bundle.layout_state({"params": pp, "m": m_, "v": v_,
                                     "step": torch.zeros(
                                         (), dtype=torch.int32)})
        state, mt = bundle.step(state, bundle.layout_batch(batch))
        glob = bundle.unlayout_state(state)
        return (float(mt["loss"][0]), float(mt["gnorm"][0]),
                T.tree_map(lambda t: t.cpu(), {g_: glob[g_] for g_ in
                                               ("params", "m", "v")}))

    zero()
    (lg_, gg, sg) = train8(dev)
    read("card-vs-CPU training")
    (lc, gc_, sc) = train8(cpu)
    if not (abs(lg_ - lc) <= 2e-4 * abs(lc) and abs(gg - gc_) <= 5e-3 * gc_):
        raise AssertionError(f"xlstm train card vs CPU: loss {lg_} / {lc}, "
                             f"gnorm {gg} / {gc_}")
    excused, total, worst = state_close(sg, sc, 1, "xlstm card vs CPU")
    print(f"[xlstm] card vs CPU, hier 1x4, {cfg8.n_layers} layers, 8 x 32, "
          f"one train step: loss {lg_:.6f} vs {lc:.6f}, gnorm {gg:.6f} vs "
          f"{gc_:.6f}, m and v per leaf within rtol 2e-4 atol 2e-5 of the "
          f"leaf's largest (worst m {worst['m']:.3g}, v {worst['v']:.3g} of "
          f"that tolerance), updated params within rtol 2e-4 atol 2e-5 but "
          f"{excused} of {total} elements where AdamW's update is "
          f"ill-conditioned")
    if excused > 1e-5 * total:
        raise AssertionError(f"xlstm card vs CPU: {excused} excused")
    del card, sg, sc
    free()
    print(f"[phase] xlstm (b) {time.perf_counter() - t_b:.1f} s")

    # (c) naive against hier on 2x4 at 8 layers: the serving weight C1 and
    # two decode steps
    t_c = time.perf_counter()
    vc = VirtualCluster(pods=2, chips=4, device=dev)
    pd8 = T.tree_map(lambda t: t.to(dev), p8)
    held, got = {}, {}
    tok0 = torch.from_numpy(rows[:, :1].astype(np.int32))
    zero()
    for mode in ("hier", "naive"):
        m8 = model_on(vc, cfg8, mode)
        with vc.bind():
            base = traffic.device_bytes(dev)
            lay = vc.layout(pd8, specs(m8, True))
            held[mode] = (traffic.device_bytes(dev) - base) / vc.pods
            cache = m8.cache_init(nb, 1024)
            tok, outs = tok0, []
            for i in range(2):
                cache, lg = m8.decode_fn(lay, cache, vc.layout(tok, P()),
                                         vc.layout(torch.arange(nb) + i,
                                                   P()))
                outs.append(lg[0].clone())
                tok = lg[0, :, 0].argmax(-1)[:, None].int().cpu()
            got[mode] = (outs, cache.domains.count)
            del lay, cache
        free()
    read("naive-vs-hier serving")
    c1 = held["naive"] / held["hier"]
    err_c = max(rel_err(a, b) for a, b in zip(got["naive"][0],
                                              got["hier"][0]))
    print(f"[xlstm] naive vs hier on 2x4, {cfg8.n_layers} layers, "
          f"serve_fsdp: weight bytes per node {held['naive'] / 1e9:.3f} / "
          f"{held['hier'] / 1e9:.3f} GB, C1 naive/hier {c1} (chips "
          f"{vc.chips}); states {got['naive'][1]} / {got['hier'][1]} (one "
          f"per rank / per node); 2 decode steps' logits rel_err "
          f"{err_c:.3g}")
    if c1 != vc.chips or err_c > 1e-4:
        raise AssertionError(f"xlstm serving C1 {c1} != {vc.chips} or "
                             f"naive differs from hier ({err_c})")
    del got, pd8
    free()
    print(f"[phase] xlstm (c) {time.perf_counter() - t_c:.1f} s")

    # (d) training, 8 x XLSTM_TRAIN_T tokens, hier, on 2x4 and 2x(2x2).
    # First the sLSTM loop alone at a training domain's shape (4 x
    # XLSTM_TRAIN_T: a node's 4 ranks' rows): ms a step and device
    # activities a step (kernels, copies), forward and forward + backward
    t_d = time.perf_counter()
    sdefs = meta.block_defs("slstm", cfg, 1, False)["slstm"]
    gs = torch.Generator(device=dev).manual_seed(28)
    ps = {k_: (torch.randn(m_.shape, generator=gs, device=dev) * 0.02)
          .requires_grad_(True) for k_, m_ in sdefs.items()}
    single = ParallelCtx.single()

    def slstm_run(T_, backward):
        xs = torch.randn((4, T_, cfg.d_model), generator=gs, device=dev,
                         requires_grad=backward)
        with torch.set_grad_enabled(backward):
            y = slstm_block(xs, ps, sdefs, single, cfg)
            if backward:
                torch.autograd.grad((y * y).sum(), [xs] + list(ps.values()))

    loop = {}
    for bw in (False, True):
        slstm_run(64, bw)
        sync()
        t1 = time.perf_counter()
        slstm_run(XLSTM_TRAIN_T, bw)
        sync()
        ms_ = (time.perf_counter() - t1) * 1e3
        r = profile_run(lambda bw=bw: slstm_run(128, bw))
        loop[bw] = (ms_, r["launches"] / 128)
    # a train step's share: 2 domains x (forward, then the remat's forward
    # and the backward)
    loop_ms = 2 * (loop[False][0] + loop[True][0])
    print(f"[xlstm] the sLSTM loop alone, one block at (4, {XLSTM_TRAIN_T}, d "
          f"{cfg.d_model}) f32: forward {loop[False][0]:.1f} ms "
          f"({1e3 * loop[False][0] / XLSTM_TRAIN_T:.1f} us a step, "
          f"{loop[False][1]:.1f} device activities a step at T 128); "
          f"forward + backward {loop[True][0]:.1f} ms "
          f"({1e3 * loop[True][0] / XLSTM_TRAIN_T:.1f} us a step, "
          f"{loop[True][1]:.1f} device activities a step)")
    del ps

    # then the train step at the deepest whole number of units whose state
    # fits (params, m, v, grads: 2 node copies each, and a domain's
    # gradient, beside one unit's recompute), 2 steps on each topology
    one = build(cfg8, ParallelCtx.single(), device="meta")
    lay1 = one.abstract_params(one.param_specs())
    per_unit = 4 * sum(t.numel() for t in T.leaves(lay1["units"]))
    rest = 4 * sum(t.numel() for k_, v_ in lay1.items() if k_ != "units"
                   for t in T.leaves({k_: v_}))
    free_b = torch.cuda.mem_get_info(dev)[0]
    fit = max(0, min(cfg.n_units, int((free_b - XLSTM_TRAIN_TRANSIENTS
                                       - 9 * rest) // (9 * per_unit))))
    if fit < 1:
        raise AssertionError("xlstm: not one unit's training state fits")
    # one unit: the host-bound sLSTM loop costs every unit's step seconds
    # (ROADMAP Queue 2), and the script's time limit holds phase 17 too
    U = 1
    cfgU = dataclasses.replace(cfg, n_layers=U * len(cfg.pattern))
    print(f"[xlstm] training state: {fit} of {cfg.n_units} units fit "
          f"({cfgU.n_layers} layers: per node "
          f"{(rest + U * per_unit) / 1e9:.3f} GB of params, "
          f"{per_unit / 1e9:.3f} GB a unit; 2 node copies x (params, m, v, "
          f"grads) {8 * (rest + U * per_unit) / 1e9:.2f} GB of "
          f"{free_b / 1e9:.1f} GB free beside "
          f"{XLSTM_TRAIN_TRANSIENTS / 2 ** 30:.0f} GiB for a unit's "
          f"activations; full depth would need "
          f"{8 * (rest + cfg.n_units * per_unit) / 1e9:.1f} GB); run at "
          f"{U} unit, 2 steps: the host-bound sLSTM loop (ROADMAP Queue 2) "
          f"costs every unit's step ~{loop_ms / 1e3:.1f} s")
    batches = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=XLSTM_TRAIN_T,
                                     global_batch=8, seed=7))
    batches = [batches.next_batch() for _ in range(2)]
    for label in ("2x4", "2x(2x2)"):
        vc = VirtualCluster.from_label(label, device=dev)
        bundle = make_cluster_train_step(cfgU, vc, mode="hier",
                                         global_batch=8)
        state = bundle.init_layout_state(26)
        nb_ = {g_: nbytes(state[g_]) for g_ in ("params", "m", "v")}
        torch.cuda.reset_peak_memory_stats(dev)
        zero()
        ms = []
        for i, b_ in enumerate(batches):
            laid = bundle.layout_batch(b_)
            sync()
            t1 = time.perf_counter()
            state, mt = bundle.step(state, laid)
            loss, gnorm = float(mt["loss"][0]), float(mt["gnorm"][0])
            sync()
            ms.append((time.perf_counter() - t1) * 1e3)
            if not (np.isfinite(loss) and np.isfinite(gnorm)):
                raise AssertionError(f"xlstm train {label}: loss {loss}")
            print(f"[train] {cfg.name} {cfgU.n_layers} layers hier {label} "
                  f"8x{XLSTM_TRAIN_T} step {i + 1}: loss {loss:.6f} "
                  f"gnorm {gnorm:.6f} "
                  f"step {ms[-1]:.1f} ms "
                  f"{8 * XLSTM_TRAIN_T / ms[-1] * 1e3:.1f} "
                  f"tokens/s")
        read(f"training on {label}")
        nb_["grads"] = bundle.stats["grad_bytes"]
        tp = bundle.model.ctx.tp
        print(f"[xlstm] train {label} (tp {tp}, {cfgU.n_layers} layers): "
              f"step 2 {ms[1]:.1f} ms, {8 * XLSTM_TRAIN_T / ms[1] * 1e3:.1f} "
              f"tokens/s; state "
              + ", ".join(f"{k_} {v_ / 1e9:.3f} GB" for k_, v_ in nb_.items())
              + f"; peak allocated "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.1f} GB")
        print(f"[xlstm] train {label}: the sLSTM loop (timed alone above, "
              f"x {U} units) {U * loop_ms / 1e3:.2f} s of a "
              f"{ms[1] / 1e3:.2f} s step ({100 * U * loop_ms / ms[1]:.1f}%)")
        del bundle, state, laid
        free()

    # one step of 8 x 256 tokens at one unit under the profiler, on 2x4:
    # 2 mLSTM chunks, so the prefix loop runs (an 8 x 2048 step's
    # trace holds ~400k device activities, minutes to read back).  The
    # parts' device and host ms, the tp collectives
    prof_batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=256,
                                        global_batch=8, seed=9)).next_batch()

    def profile_step(bundle, state, label):
        laid = bundle.layout_batch(prof_batch)
        t1 = time.perf_counter()
        zero()
        r = profile_run(lambda: bundle.step(state, laid),
                        ranges=TP_RANGES + XLSTM_RANGES)
        read(f"profiled training on {label}")
        tp_ms = sum(v_ for k_, v_ in r["ranges"].items()
                    if k_.startswith(TP_RANGES))
        x_ms = {k_: round(v_, 2) for k_, v_ in r["ranges"].items()
                if k_.startswith(XLSTM_RANGES)}
        x_wall = {k_: round(v_, 1) for k_, v_ in r["ranges_wall"].items()
                  if k_.startswith(XLSTM_RANGES)}
        print(f"[xlstm] train {label}: one step of 8 x 256 ("
              f"{256 // MLSTM_CHUNK} mLSTM chunks), {cfg8.n_layers} layers, "
              f"profiled: wall {r['wall_ms']:.1f} ms, device busy "
              f"{r['busy_ms']:.1f} ms ({100 * r['busy_share']:.1f}%), "
              f"{r['launches']} device activities; tp collectives "
              f"{tp_ms:.2f} ms ({100 * tp_ms / r['busy_ms']:.1f}%); xLSTM "
              f"parts (forwards and the remat's recompute) device "
              f"{sum(x_ms.values()):.2f} ms "
              f"({100 * sum(x_ms.values()) / r['busy_ms']:.1f}%: {x_ms}), "
              f"host {x_wall} ms (the sLSTM loop's forwards "
              f"{100 * x_wall.get('xlstm::slstm_loop', 0) / r['wall_ms']:.1f}"
              f"% of the wall; its backward runs outside the range); "
              f"warm-up, profile and read-back "
              f"{time.perf_counter() - t1:.1f} s")

    # the training C1 at 8 layers: hier against naive on 2x4, one step of
    # 8 x 128 tokens from a common state under PERF.md §2's rule, and the
    # state bytes on 2x(2x2); the 2x4 hier bundle's profiled step
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=128,
                                   global_batch=8, seed=8)).next_batch()
    vc = VirtualCluster(pods=2, chips=4, device=dev)
    res = {}
    for mode in ("hier", "naive"):
        bundle = make_cluster_train_step(cfg8, vc, mode=mode, global_batch=8)
        pp = T.tree_map(lambda t: t.to(dev), p8)
        m_, v_ = adamw_init(pp)
        state = bundle.layout_state({"params": pp, "m": m_, "v": v_,
                                     "step": torch.zeros(
                                         (), dtype=torch.int32)})
        del pp, m_, v_
        nb_ = {g_: nbytes(state[g_]) for g_ in ("params", "m", "v")}
        zero()
        state, mt = bundle.step(state, bundle.layout_batch(batch))
        read(f"{mode} training")
        nb_["grads"] = bundle.stats["grad_bytes"]
        glob = T.tree_map(lambda t: t.cpu(), bundle.unlayout_state(state))
        res[mode] = (float(mt["loss"][0]), float(mt["gnorm"][0]), nb_, glob)
        if mode == "hier":
            profile_step(bundle, state, "2x4")
        del bundle, state
        free()
    (lh, gh, bh, sh), (ln, gn, bn, sn) = res["hier"], res["naive"]
    if not (abs(lh - ln) <= 2e-4 * abs(ln) and abs(gh - gn) <= 5e-3 * gn):
        raise AssertionError(f"xlstm hier vs naive: loss {lh} / {ln}, "
                             f"gnorm {gh} / {gn}")
    ex, tot, w_ = state_close(sn, sh, 1, "xlstm hier vs naive")
    c1 = {g_: bn[g_] / bh[g_] for g_ in bh}
    c1_tp = {}
    vc_tp = VirtualCluster.from_label("2x(2x2)", device=dev)
    for mode in ("hier", "naive"):
        bundle = make_cluster_train_step(cfg8, vc_tp, mode=mode,
                                         global_batch=8)
        state = bundle.init_layout_state(27)
        c1_tp[mode] = {g_: nbytes(state[g_]) for g_ in ("params", "m", "v")}
        del bundle, state
        free()
    c1_tp = {g_: c1_tp["naive"][g_] / c1_tp["hier"][g_]
             for g_ in c1_tp["hier"]}
    print(f"[xlstm] hier vs naive, 2x4, {cfg8.n_layers} layers, one step of "
          f"8 x 128: loss {lh:.6f} / {ln:.6f}, m and v within the rule "
          f"(worst m {w_['m']:.3g}, v {w_['v']:.3g}), params but {ex} of "
          f"{tot} ill-conditioned; C1 naive/hier by group {c1} on 2x4 "
          f"(chips 4), {c1_tp} on 2x(2x2) (store 2)")
    if set(c1.values()) != {4.0} or set(c1_tp.values()) != {2.0}:
        raise AssertionError(f"xlstm training C1 {c1} / {c1_tp}")
    del res, sh, sn
    free()
    print(f"[phase] xlstm (d) {time.perf_counter() - t_d:.1f} s")

    # (e) the head-group path: tp 8 over 4 heads (g 2: two tp ranks share a
    # head, each with half its v columns) on 1x(1x8), one step of 8 x 128
    # at 8 layers, against the card's own single-device (1x1) step of the
    # same model and batch
    t_e = time.perf_counter()
    res = []
    zero()
    for label in ("1x(1x8)", "1x1"):
        vc = VirtualCluster.from_label(label, device=dev)
        bundle = make_cluster_train_step(cfg8, vc, mode="hier",
                                         global_batch=8)
        pp = T.tree_map(lambda t: t.to(dev), p8)
        m_, v_ = adamw_init(pp)
        state = bundle.layout_state({"params": pp, "m": m_, "v": v_,
                                     "step": torch.zeros(
                                         (), dtype=torch.int32)})
        del pp, m_, v_
        sync()
        t1 = time.perf_counter()
        state, mt = bundle.step(state, bundle.layout_batch(batch))
        sync()
        res.append((float(mt["loss"][0]), float(mt["gnorm"][0]),
                    T.tree_map(lambda t: t.cpu(),
                               bundle.unlayout_state(state)),
                    (time.perf_counter() - t1) * 1e3, bundle.model.ctx.tp))
        del bundle, state
        free()
    read("head-group training")
    (l8, g8, s8, ms8, tp8), (l1, g1, s1, ms1, _) = res
    if not (abs(l8 - l1) <= 2e-4 * abs(l1) and abs(g8 - g1) <= 5e-3 * g1):
        raise AssertionError(f"xlstm head groups: loss {l8} / {l1}, gnorm "
                             f"{g8} / {g1}")
    ex, tot, w_ = state_close(s8, s1, 1, "xlstm head groups 1x(1x8) vs 1x1")
    print(f"[xlstm] head groups: 1x(1x8) (tp {tp8} over {cfg.n_heads} heads,"
          f" {tp8 // cfg.n_heads} ranks a head) vs the single-device step, "
          f"{cfg8.n_layers} layers, 8 x 128: loss {l8:.6f} / {l1:.6f}, gnorm "
          f"{g8:.6f} / {g1:.6f}, m and v within the rule (worst m "
          f"{w_['m']:.3g}, v {w_['v']:.3g}), params but {ex} of {tot} "
          f"ill-conditioned; step {ms8:.1f} / {ms1:.1f} ms (first steps)")
    if ex > 1e-5 * tot:
        raise AssertionError(f"xlstm head groups: {ex} excused")
    del res, s8, s1, p8
    free()
    print(f"[phase] xlstm (e) {time.perf_counter() - t_e:.1f} s")
    return launches


FRONTEND_VLM, FRONTEND_AUDIO = "internvl2-1b", "musicgen-medium"
# activations beside the training state of a musicgen-medium domain run
# (4 x 2048 frames, d 1536: the layers' remat checkpoints, one layer's
# recompute, the streamed loss): the depth rule of phase 17 (c)
FRONTEND_TRAIN_TRANSIENTS = 16 * 2 ** 30


def frontends_phase(dev, scratch: str) -> dict:
    """Phase 17: the ``vit`` / ``encodec`` frontends and the production-
    mesh entry points at ``internvl2-1b``'s and ``musicgen-medium``'s full
    width (f32, seeded weights), then the three apps.  Returns the flash
    forward / backward launches of its main-path runs (each zeroed just
    before and read just after)."""
    import math
    import numpy as np
    import torch
    from repro_torch.analysis import traffic
    from repro_torch.analysis.state_rule import state_close
    from repro_torch.configs import get_config
    from repro_torch.core import tree as T
    from repro_torch.core.topology import MeshTopology
    from repro_torch.data.synthetic import DataConfig, FrontendLM
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import flash_attention_bwd as kbwd
    from repro_torch.launch.mesh import make_mesh_from_topo, small_topo
    from repro_torch.models import ParallelCtx, build, meta
    from repro_torch.models.domains import NodeCache
    from repro_torch.models.meta import store_dim
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.runtime.steps import cluster_ctx, make_serve_steps, \
        make_train_step
    from repro_torch.serving.recorded import RecordedDecoder
    from repro_torch.substrate import VirtualCluster
    from repro_torch.substrate.cluster import P

    launches = {"flash_attention": 0, "flash_attention_bwd": 0}
    cpu = torch.device("cpu")

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in T.leaves(tree))

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def sync():
        torch.cuda.synchronize(dev)

    def zero():
        kflash.launches = kbwd.launches = 0

    def read(what):
        fl, bw = kflash.launches, kbwd.launches
        launches["flash_attention"] += fl
        launches["flash_attention_bwd"] += bw
        print(f"[frontends] flash launches in {what}: forward {fl}, "
              f"backward {bw}")
        return fl, bw

    def stream(cfg, seq, batch, seed):
        return FrontendLM(cfg, DataConfig(vocab=cfg.vocab, seq_len=seq,
                                          global_batch=batch, seed=seed))

    def common_state(bundle, params):
        """The state of ``params`` (global, any device) laid out on the
        bundle's cluster, zero moments."""
        pp = T.tree_map(lambda t: t.to(bundle.vc.device), params)
        m_, v_ = adamw_init(pp)
        return bundle.layout_state({"params": pp, "m": m_, "v": v_,
                                    "step": torch.zeros((),
                                                        dtype=torch.int32)})

    def one_step(cfg, topo, d_, mode, params, batch):
        """One make_train_step step from ``params``: loss, gnorm, the
        global updated state on the CPU."""
        vc = make_mesh_from_topo(topo, device=d_)
        bundle = make_train_step(cfg, topo, vc, mode=mode,
                                 compute_dtype=torch.float32)
        state = common_state(bundle, params)
        state, mt = bundle.step(state, bundle.layout_batch(batch))
        glob = bundle.unlayout_state(state)
        out = (float(mt["loss"][0]), float(mt["gnorm"][0]),
               T.tree_map(lambda t: t.cpu(), {g_: glob[g_] for g_ in
                                              ("params", "m", "v")}))
        del bundle, state, glob
        free()
        return out

    def held(a, b, what):
        """Two one-step runs under PERF.md §2's rule."""
        (la, ga, sa), (lb, gb, sb) = a, b
        if not (abs(la - lb) <= 2e-4 * abs(lb)
                and abs(ga - gb) <= 5e-3 * gb):
            raise AssertionError(f"{what}: loss {la} / {lb}, gnorm {ga} / "
                                 f"{gb}")
        ex, tot, w_ = state_close(sa, sb, 1, what)
        return (f"loss {la:.6f} / {lb:.6f}, gnorm {ga:.6f} / {gb:.6f}, m "
                f"and v within the rule (worst m {w_['m']:.3g}, v "
                f"{w_['v']:.3g}), params but {ex} of {tot} ill-conditioned")

    def specs(m, serve):
        ctx = m.ctx
        return m.param_specs(serve=serve, tp_axis=ctx.tp_axis,
                             fsdp_axis=ctx.fsdp_axes[0] if ctx.fsdp_axes
                             else None)

    def model_on(vc, c, mode="hier", d_=dev):
        ctx = cluster_ctx(vc, mode=mode, opts=("serve_fsdp",))
        sizes = dict(zip(vc.axis_names, vc.axis_shapes))
        return build(c, ctx, data=math.prod(sizes[a] for a in
                                            ctx.fsdp_axes), device=d_)

    vlm, audio = get_config(FRONTEND_VLM), get_config(FRONTEND_AUDIO)
    for c in (vlm, audio):
        print(f"[frontends] {c.name}: {c.frontend} frontend (d_frontend "
              f"{c.d_frontend}" + (f", {c.n_prefix} patches a row"
                                   if c.n_prefix else "")
              + f"), d {c.d_model}, {c.n_heads} q / {c.n_kv} kv heads x "
              f"{c.head_dim}, d_ff {c.d_ff}, vocab {c.vocab}, "
              f"{c.n_layers} layers, {c.param_count() / 1e9:.3f} B params "
              f"({4 * c.param_count() / 1e9:.2f} GB f32)")

    # (a) internvl2-1b training through make_train_step on small_topo(2, 2,
    # 2) (2 pods x (2 data x 2 model)), hier, 8 x 2048 tokens (the first 256
    # of a row its patches), full depth, 3 steps
    t_a = time.perf_counter()
    topo = small_topo(2, 2, 2)
    vc = make_mesh_from_topo(topo, device=dev)
    bundle = make_train_step(vlm, topo, vc, mode="hier",
                             compute_dtype=torch.float32)
    state = bundle.init_layout_state(31)
    nb_h = {g_: nbytes(state[g_]) for g_ in ("params", "m", "v")}
    data = stream(vlm, 2048, 8, 17)
    torch.cuda.reset_peak_memory_stats(dev)
    zero()
    ms = []
    for i in range(3):
        laid = bundle.layout_batch(data.next_batch())
        sync()
        t1 = time.perf_counter()
        state, mt = bundle.step(state, laid)
        loss, gnorm = float(mt["loss"][0]), float(mt["gnorm"][0])
        n_tok = float(mt["tokens"][0])
        sync()
        ms.append((time.perf_counter() - t1) * 1e3)
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"internvl train: loss {loss}")
        print(f"[train] {vlm.name} full depth make_train_step hier "
              f"{vc.label} 8x2048 (256 patches a row) step {i + 1}: loss "
              f"{loss:.6f} gnorm {gnorm:.6f} step {ms[-1]:.1f} ms; "
              f"{n_tok:.0f} masked tokens, {n_tok / ms[-1] * 1e3:.1f} "
              f"masked tokens/s ({8 * 2048 / ms[-1] * 1e3:.1f} positions/s)")
    fl, bw = read("internvl2-1b training")
    want_bw = vc.pods * vlm.n_layers * 3
    if bw != want_bw or fl != 2 * bw:
        raise AssertionError(f"internvl train launches {fl} / {bw}, want "
                             f"{2 * want_bw} / {want_bw}")
    if n_tok != 8 * (2048 - vlm.n_prefix + 1):
        raise AssertionError(f"internvl masked tokens {n_tok}")
    nb_h["grads"] = bundle.stats["grad_bytes"]
    print(f"[frontends] internvl2-1b train {vc.label} (tp "
          f"{bundle.model.ctx.tp}, head_tp: {vlm.n_heads // 2} q / "
          f"{vlm.n_kv // 2} kv heads a rank): steps 2-3 "
          f"{sum(ms[1:]) / 2:.1f} ms; state "
          + ", ".join(f"{k_} {v_ / 1e9:.3f} GB" for k_, v_ in nb_h.items())
          + f" (2 node copies of each of 2 tp shards); peak allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.1f} GB")
    del bundle, state, laid
    free()
    naive = make_train_step(vlm, topo, vc, mode="naive",
                            compute_dtype=torch.float32)
    state = naive.init_layout_state(31)
    c1 = {g_: nbytes(state[g_]) / nb_h[g_] for g_ in ("params", "m", "v")}
    del naive, state
    free()
    print(f"[frontends] internvl2-1b training C1 naive/hier by group on "
          f"{vc.label}: {c1} (the store size 2)")
    if set(c1.values()) != {2.0}:
        raise AssertionError(f"internvl training C1 {c1}")
    # hier against naive at 2 layers on the card (8 x 512: 256 patches and
    # 256 tokens a row), and card against CPU (4 x 288)
    vlm2 = dataclasses.replace(vlm, n_layers=2)
    one = build(vlm2, ParallelCtx.single(), device=dev)
    p2 = T.tree_map(lambda t: t.cpu(), one.init_params(32))
    del one
    b512 = stream(vlm, 512, 8, 18).next_batch()
    line = held(one_step(vlm2, topo, dev, "hier", p2, b512),
                one_step(vlm2, topo, dev, "naive", p2, b512),
                "internvl hier vs naive")
    print(f"[frontends] internvl2-1b hier vs naive, {vc.label}, 2 layers, "
          f"one step of 8 x 512: {line}")
    b288 = stream(vlm, 288, 4, 19).next_batch()
    line = held(one_step(vlm2, topo, dev, "hier", p2, b288),
                one_step(vlm2, topo, cpu, "hier", p2, b288),
                "internvl card vs CPU")
    print(f"[frontends] internvl2-1b card vs CPU, hier {vc.label}, 2 "
          f"layers, one step of 4 x 288: {line}")
    del p2
    free()
    print(f"[phase] frontends (a) {time.perf_counter() - t_a:.1f} s")

    # (b) internvl2-1b serving: hier on 2x4 with serve_fsdp, phase 14's
    # prompts each led by its 256 patches, the sync decode against
    # RecordedDecoder and the weight C1; then make_serve_steps on 1x(1x8):
    # decode2d against the 1-D decode
    t_b = time.perf_counter()
    lengths = [vlm.n_prefix + n for n in SERVE_CLUSTER_LENGTHS]
    S, steps, nb = (max(lengths) + SERVE_CLUSTER_STEPS,
                    SERVE_CLUSTER_STEPS, len(lengths))
    src = stream(vlm, max(lengths), nb, 20).next_batch()
    vc = VirtualCluster(pods=2, chips=4, device=dev)
    m = model_on(vc, vlm)
    params = m.init_params(33)
    w_bytes = nbytes(params)
    with vc.bind():
        train = vc.layout(params, specs(m, False))
        cache = m.cache_init(nb, S)
        first = []
        zero()
        sync()
        t0 = time.perf_counter()
        for i, n in enumerate(lengths):
            row = src["tokens"][i:i + 1, :n]
            batch = {"tokens": np.concatenate([row, row[:, -1:]], 1),
                     "patches": src["patches"][i:i + 1]}
            c, lg = m.prefill_fn(train, {k: vc.layout(torch.from_numpy(v),
                                                      P())
                                         for k, v in batch.items()}, S)
            cache.copy_row(c, 0, len(first))
            first.append(lg[0, 0, 0])
            del c
        sync()
        pre_ms = (time.perf_counter() - t0) * 1e3
        fl, _ = read("internvl2-1b prefills")
        if fl != vc.pods * vlm.n_layers * nb:
            raise AssertionError(f"internvl prefill launches {fl}")
        first = torch.stack(first)
        del train
        free()
        base = traffic.device_bytes(dev)
        serve = vc.layout(params, specs(m, True))
        stored = traffic.device_bytes(dev) - base

        def decode_loop(decode, cache_):
            tok, pos = first.argmax(-1), torch.tensor(lengths)
            out, ms_ = [], []
            for _ in range(steps):
                sync()
                t1 = time.perf_counter()
                cache_, lg_ = decode(serve, cache_,
                                     vc.layout(tok[:, None].int(), P()),
                                     vc.layout(pos, P()))
                sync()
                ms_.append((time.perf_counter() - t1) * 1e3)
                out.append(lg_[0, :, 0].clone())
                tok, pos = out[-1].argmax(-1), pos + 1
            return out, ms_, cache_

        c_sync = NodeCache(T.tree_map(lambda t: t.clone(), dict(cache)),
                           cache.domains)
        sync_out, s_ms, c_sync = decode_loop(m.decode_fn, c_sync)
        dec = RecordedDecoder(m)
        rec_out, r_ms, c_rec = decode_loop(dec, cache)
        same = all(torch.equal(a, b) for a, b in zip(sync_out, rec_out)) \
            and all(torch.equal(a, b) for a, b in zip(
                T.leaves(dict(c_sync)), T.leaves(dict(c_rec))))
        (sched,) = dec.schedules.values()
        n_g = sum(n_.family == "gather" for n_ in sched.graph.nodes)
        n_store = sum(store_dim(mt_) is not None
                      for mt_ in T.leaves(m.serve_defs))
        for label, t_ in (("sync", s_ms), ("recorded", r_ms)):
            tail = t_[1:]
            print(f"[frontends] internvl2-1b 2x4 {label}: decode step p50 "
                  f"{1e3 * pct(tail, 0.5):.0f} us p99 "
                  f"{1e3 * pct(tail, 0.99):.0f} us (steps 2-{len(t_)}), "
                  f"{nb * len(tail) / sum(tail) * 1e3:.1f} tokens/s")
        print(f"[frontends] internvl2-1b 2x4 hier serve_fsdp: prefill of "
              f"{nb} prompts ({lengths[0]}-{lengths[-1]} positions, the "
              f"first {vlm.n_prefix} patches) {pre_ms:.1f} ms; recorded == "
              f"sync (every step's logits and the final cache, "
              f"torch.equal) {same}; gathers {n_g} (node-stored leaves "
              f"{n_store}); stored weights {stored / 1e9:.3f} GB "
              f"({stored / w_bytes:.2f} x {w_bytes / 1e9:.3f} GB)")
        if not same or n_g != n_store or stored != vc.pods * w_bytes:
            raise AssertionError(f"internvl serving: recorded == sync "
                                 f"{same}, gathers {n_g} / {n_store}, "
                                 f"stored {stored}")
        if not all(torch.isfinite(x).all() for x in sync_out):
            raise AssertionError("internvl: non-finite decode logits")
        del serve, cache, c_sync, c_rec, sync_out, rec_out
        free()
        # the weight C1: the naive serve layout's bytes over hier's, and
        # one decode step of each from an empty cache agreeing
        outs, w_b = {}, {}
        tok = vc.layout(first.argmax(-1)[:, None].int(), P())
        for mode in ("hier", "naive"):
            mm = model_on(vc, vlm, mode=mode)
            base = traffic.device_bytes(dev)
            sp = vc.layout(params, specs(mm, True))
            w_b[mode] = traffic.device_bytes(dev) - base
            _, lg = mm.decode_fn(sp, mm.cache_init(nb, 64), tok,
                                 vc.layout(torch.zeros(nb, dtype=torch.long),
                                           P()))
            outs[mode] = lg[0].clone()
            del sp, mm
            free()
    c1w = w_b["naive"] / w_b["hier"]
    err = rel_err(outs["hier"], outs["naive"])
    print(f"[frontends] internvl2-1b naive vs hier on 2x4: weight bytes "
          f"per node C1 naive/hier {c1w} (chips 4); a decode step's logits "
          f"rel_err {err:.3g}")
    if c1w != 4.0 or err > 1e-4:
        raise AssertionError(f"internvl weight C1 {c1w}, rel_err {err}")
    del params
    free()

    # make_serve_steps on 1x(1x8) (tp 8: internvl2-1b's (g_h, g_s) = (2,
    # 4)): 32 decode steps from an empty cache, the 2-D layout against the
    # 1-D one on the same weights and tokens, every step's logits within
    # 2e-4
    topo8 = MeshTopology({"data": 1, "model": 8})
    vc8 = make_mesh_from_topo(topo8, device=dev)
    B8, S8 = 8, 64
    feed = torch.from_numpy(stream(vlm, S8, B8, 21).next_batch()["tokens"])
    base_p = build(vlm, ParallelCtx.single(), device=dev).init_params(34)
    res = {}
    for opts in ((), ("decode2d",)):
        sb = make_serve_steps(vlm, topo8, vc8, global_batch=B8, s_max=S8,
                              opts=opts, compute_dtype=torch.float32)
        pp = meta.decode2d_params(base_p, vlm, 8) if opts else base_p
        lay = sb.layout_params(pp)
        del pp
        cache = sb.cache_init()
        out, ms_ = [], []
        for t in range(SERVE_CLUSTER_STEPS):
            sync()
            t1 = time.perf_counter()
            cache, lg = sb.decode(lay, cache,
                                  sb.layout_tokens(feed[:, t:t + 1]), t)
            sync()
            ms_.append((time.perf_counter() - t1) * 1e3)
            out.append(sb.unlayout_logits(lg).cpu())
        res[bool(opts)] = (out, ms_, nbytes(lay),
                           nbytes(dict(cache)) if opts else None)
        del sb, lay, cache
        free()
    g_h, g_s = meta.decode2d_groups(vlm, 8)
    worst = 0.0
    for a, b in zip(res[True][0], res[False][0]):
        worst = max(worst, float(((a - b).abs() / (2e-4 + 2e-4 * b.abs()))
                                 .max()))
    print(f"[frontends] internvl2-1b make_serve_steps 1x(1x8), decode2d "
          f"(g_h, g_s) = ({g_h}, {g_s}) against the 1-D decode, "
          f"{SERVE_CLUSTER_STEPS} steps of {B8} rows from an empty cache "
          f"(s_max {S8}): worst |diff| / (2e-4 + 2e-4 |1-D|) {worst:.3g}; "
          f"step p50 {pct(res[True][1][1:], 0.5):.1f} ms (2-D) / "
          f"{pct(res[False][1][1:], 0.5):.1f} ms (1-D); serve weights "
          f"{res[True][2] / 1e9:.3f} / {res[False][2] / 1e9:.3f} GB")
    if not worst <= 1.0:
        raise AssertionError(f"decode2d vs 1-D: {worst}")
    del base_p, res
    free()
    print(f"[phase] frontends (b) {time.perf_counter() - t_b:.1f} s")

    # (c) musicgen-medium: hier serving on 2x4 at full depth (a prefill of
    # frames, then frame decode against a longer prefill), card against
    # CPU at 2 layers, then make_train_step at the deepest depth whose
    # state fits
    t_c = time.perf_counter()
    T0, n_dec = 512, 8
    fr = stream(audio, T0 + n_dec, 2, 22).next_batch()
    m = model_on(vc, audio)
    params = m.init_params(35)
    with vc.bind():
        train = vc.layout(params, specs(m, False))
        zero()

        def pre(n):
            b_ = {k: vc.layout(torch.from_numpy(np.ascontiguousarray(
                v[:, :n])), P()) for k, v in fr.items()}
            return m.prefill_fn(train, b_, T0 + n_dec)
        sync()
        t1 = time.perf_counter()
        cache, _ = pre(T0)
        sync()
        pre_ms = (time.perf_counter() - t1) * 1e3
        _, want = pre(T0 + n_dec)
        del train
        free()
        serve = vc.layout(params, specs(m, True))
        ms_ = []
        for i in range(n_dec):
            frame = torch.from_numpy(np.ascontiguousarray(
                fr["frames"][:, T0 + i:T0 + i + 1]))
            sync()
            t1 = time.perf_counter()
            cache, lg = m.decode_fn(serve, cache, vc.layout(frame, P()),
                                    vc.layout(torch.tensor(T0 + i), P()))
            sync()
            ms_.append((time.perf_counter() - t1) * 1e3)
        fl, _ = read("musicgen-medium prefills")
        del serve, cache
        free()
    err = rel_err(lg[0], want[0])
    print(f"[frontends] musicgen-medium 2x4 hier serve_fsdp, full depth: "
          f"prefill of 2 x {T0} frames {pre_ms:.1f} ms, then {n_dec} frame "
          f"decode steps (p50 {pct(ms_[1:], 0.5):.1f} ms) against the "
          f"prefill of {T0 + n_dec} frames: last logits rel_err {err:.3g}")
    if err > 1e-4 or fl != 2 * vc.pods * audio.n_layers:
        raise AssertionError(f"musicgen decode vs prefill {err}, launches "
                             f"{fl}")
    del params
    free()
    # card against CPU at 2 layers: prefill and 2 decode steps on 2x4, and
    # one make_train_step step
    au2 = dataclasses.replace(audio, n_layers=2)
    one = build(au2, ParallelCtx.single(), device=dev)
    p2 = T.tree_map(lambda t: t.cpu(), one.init_params(36))
    del one

    def serve2(d_):
        vc_d = VirtualCluster(pods=2, chips=4, device=d_)
        m2 = model_on(vc_d, au2, d_=d_)
        pp = T.tree_map(lambda t: t.to(d_), p2)
        with vc_d.bind():
            c_, lg_ = m2.prefill_fn(vc_d.layout(pp, specs(m2, False)), {
                k: vc_d.layout(torch.from_numpy(np.ascontiguousarray(
                    v[:, :256])), P()) for k, v in fr.items()}, 512)
            sp = vc_d.layout(pp, specs(m2, True))
            outs = [lg_[0].cpu()]
            for i in range(2):
                frame = torch.from_numpy(np.ascontiguousarray(
                    fr["frames"][:, 256 + i:257 + i]))
                c_, lg_ = m2.decode_fn(sp, c_, vc_d.layout(frame, P()),
                                       vc_d.layout(torch.tensor(256 + i),
                                                   P()))
                outs.append(lg_[0].cpu())
        return outs

    errs = [rel_err(a, b) for a, b in zip(serve2(dev), serve2(cpu))]
    topo24 = MeshTopology({"pod": 2, "data": 4, "model": 1})
    b128 = stream(audio, 128, 8, 23).next_batch()
    line = held(one_step(au2, topo24, dev, "hier", p2, b128),
                one_step(au2, topo24, cpu, "hier", p2, b128),
                "musicgen card vs CPU")
    print(f"[frontends] musicgen-medium card vs CPU, 2x4 hier, 2 layers: "
          f"prefill 2 x 256 frames and 2 decode steps, logits rel_err "
          f"{[f'{e:.3g}' for e in errs]}; one make_train_step step of 8 x "
          f"128 frames: {line}")
    if max(errs) > 1e-4:
        raise AssertionError(f"musicgen card vs CPU {errs}")
    del p2
    free()
    # make_train_step on 2x4 ({pod 2, data 4, model 1}), hier, 8 x 2048
    # frames, at the deepest whole number of layers whose state fits
    # (params, m, v, grads: 2 node copies each, and a domain's gradient,
    # beside a domain run's activations)
    one = build(dataclasses.replace(audio, n_layers=1), ParallelCtx.single(),
                device="meta")
    lay1 = one.abstract_params(one.param_specs())
    per_layer = 4 * sum(t.numel() for t in T.leaves(lay1["units"]))
    rest = 4 * sum(t.numel() for k_, v_ in lay1.items() if k_ != "units"
                   for t in T.leaves({k_: v_}))
    free_b = torch.cuda.mem_get_info(dev)[0]
    L = max(0, min(audio.n_layers, int((free_b - FRONTEND_TRAIN_TRANSIENTS
                                        - 9 * rest) // (9 * per_layer))))
    if L < 1:
        raise AssertionError("musicgen: not one layer's training state "
                             "fits")
    cfgL = dataclasses.replace(audio, n_layers=L)
    print(f"[frontends] musicgen-medium training state: {L} of "
          f"{audio.n_layers} layers fit (per node "
          f"{(rest + L * per_layer) / 1e9:.3f} "
          f"GB of params, {per_layer / 1e9:.3f} GB a layer; 2 node copies x "
          f"(params, m, v, grads) {8 * (rest + L * per_layer) / 1e9:.2f} GB "
          f"of {free_b / 1e9:.1f} GB free beside "
          f"{FRONTEND_TRAIN_TRANSIENTS / 2 ** 30:.0f} GiB for a domain "
          f"run's activations; full depth would need "
          f"{8 * (rest + audio.n_layers * per_layer) / 1e9:.1f} GB)")
    vc24 = make_mesh_from_topo(topo24, device=dev)
    bundle = make_train_step(cfgL, topo24, vc24, mode="hier",
                             compute_dtype=torch.float32)
    state = bundle.init_layout_state(37)
    nb_ = {g_: nbytes(state[g_]) for g_ in ("params", "m", "v")}
    data = stream(audio, 2048, 8, 24)
    torch.cuda.reset_peak_memory_stats(dev)
    zero()
    ms = []
    for i in range(2):
        laid = bundle.layout_batch(data.next_batch())
        sync()
        t1 = time.perf_counter()
        state, mt = bundle.step(state, laid)
        loss, gnorm = float(mt["loss"][0]), float(mt["gnorm"][0])
        sync()
        ms.append((time.perf_counter() - t1) * 1e3)
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"musicgen train: loss {loss}")
        print(f"[train] {audio.name} {L} layers make_train_step hier "
              f"{vc24.label} 8x2048 frames step {i + 1}: loss {loss:.6f} "
              f"gnorm {gnorm:.6f} step {ms[-1]:.1f} ms "
              f"{8 * 2048 / ms[-1] * 1e3:.1f} tokens/s")
    fl, bw = read("musicgen-medium training")
    nb_["grads"] = bundle.stats["grad_bytes"]
    print(f"[frontends] musicgen-medium train {vc24.label} ({L} layers): "
          f"step 2 {ms[1]:.1f} ms; state "
          + ", ".join(f"{k_} {v_ / 1e9:.3f} GB" for k_, v_ in nb_.items())
          + f" (2 node copies); peak allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.1f} GB")
    if bw != vc24.pods * L * 2 or fl != 2 * bw:
        raise AssertionError(f"musicgen train launches {fl} / {bw}")
    del bundle, state, laid
    free()
    print(f"[phase] frontends (c) {time.perf_counter() - t_c:.1f} s")

    # (d) the three apps, each a process of its own on the card, run side
    # by side: quickstart, serve_lm, and train_100m stopped after its
    # checkpoint at step 2 and then resumed to step 4
    t_d = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    ck = os.path.join(scratch, "train_100m")

    started = []

    def app(name, *args):
        started.append(subprocess.Popen(
            [sys.executable, "-m", f"repro_torch.apps.{name}", "--device",
             "cuda", *args], cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
        return started[-1]

    def done(p, name):
        out, _ = p.communicate(timeout=600)
        if p.returncode:
            raise AssertionError(f"{name} exited {p.returncode}: "
                                 f"{out[-2000:]}")
        return out

    t100 = ["--steps", "2", "--save-every", "2", "--ckpt", ck]
    try:
        procs = {"train_100m": app("train_100m", *t100),
                 "quickstart": app("quickstart"),
                 "serve_lm": app("serve_lm")}
        outs = {"train_100m": done(procs.pop("train_100m"), "train_100m")}
        t100[1] = "4"
        resume = app("train_100m", *t100)       # beside the other two
        outs.update({k: done(p, k) for k, p in procs.items()})
        resumed = done(resume, "train_100m (resumed)")
    finally:
        for p in started:                   # none outlives the phase
            if p.poll() is None:
                p.kill()
                p.wait()
    qs = [ln for ln in outs["quickstart"].splitlines()
          if ln.startswith("final loss")]
    solo = outs["serve_lm"].count("== solo run")
    tuner = [ln for ln in outs["serve_lm"].splitlines()
             if ln.startswith("live tuner")]
    stop = [ln for ln in outs["train_100m"].splitlines()
            if "resumed_from=" in ln]
    last = [ln for ln in resumed.splitlines() if "resumed_from=" in ln]
    print(f"[frontends] apps on the card (3 processes side by side, the "
          f"resume after train_100m's first run): quickstart {qs}; "
          f"serve_lm {solo} of 5 streams == "
          f"their solo runs, {tuner}; train_100m stopped at 2 "
          f"{stop}"
          f", resumed {last}; {time.perf_counter() - t_d:.1f} s")
    if not qs or "structure learned: True" not in qs[0] or solo != 5 \
            or not tuner or not last \
            or int(last[0].split("resumed_from=")[1]) <= 0:
        raise AssertionError("an app failed its check: "
                             + "\n".join(outs.values()) + resumed)
    shutil.rmtree(ck, ignore_errors=True)
    print(f"[phase] frontends (d) {time.perf_counter() - t_d:.1f} s")
    return launches


HYBRID_NAME = "recurrentgemma-9b"
# phase 18 trains one pattern unit (rglru, rglru, local: 3 of 38 layers) at
# full width: ~1.7e9 params, 27.3 GB of params, m, v and grads for the one
# node copy
HYBRID_TRAIN_LAYERS, HYBRID_TRAIN_STEPS = 3, 3


def hybrid_train_phase(dev) -> dict:
    """Phase 18: ``recurrentgemma-9b`` trained at full width (d 4096, d_rnn
    4096, 16 heads x 256 with 1 kv head, d_ff 12288, vocab 256000 tied;
    f32, seeded weights) at one pattern unit, through
    ``make_cluster_train_step`` in hier on one 1x4 node, 4 x 2048 tokens,
    ``HYBRID_TRAIN_STEPS`` steps: the lru_scan kernel forward (twice a step
    under the remat) and its backward kernel, the flash kernel forward and
    backward.  Returns the four kernels' launches over the run (zeroed just
    before it, read just after)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.analysis import traffic
    from repro_torch.configs import get_config
    from repro_torch.core import tree as T
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import flash_attention_bwd as kbwd
    from repro_torch.kernels import lru_scan as klru
    from repro_torch.kernels import lru_scan_bwd as klrub
    from repro_torch.runtime.steps import make_cluster_train_step
    from repro_torch.substrate import VirtualCluster

    cfg = dataclasses.replace(get_config(HYBRID_NAME),
                              n_layers=HYBRID_TRAIN_LAYERS)
    vc = VirtualCluster(pods=1, chips=4, device=dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    bundle = make_cluster_train_step(cfg, vc, mode="hier", lr=3e-4,
                                     clip=1.0, global_batch=4)
    torch.cuda.synchronize(dev)
    base = traffic.device_bytes(dev)
    state = bundle.init_layout_state(seed=41)     # drawn on the card
    torch.cuda.synchronize(dev)
    held = traffic.device_bytes(dev) - base       # params, m, v (and step)
    logical = sum(t.numel() * t.element_size() for t in T.leaves(
        bundle.model.abstract_params(bundle.state_specs["params"])))
    batches = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=2048,
                                     global_batch=4, seed=43))
    kernels = {"lru_scan": klru, "lru_scan_bwd": klrub,
               "flash_attention": kflash, "flash_attention_bwd": kbwd}
    for k_ in kernels.values():
        k_.launches = 0
    rows = []
    for i in range(HYBRID_TRAIN_STEPS):
        batch = bundle.layout_batch(batches.next_batch())
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, mt = bundle.step(state, batch)
        loss, gnorm = float(mt["loss"][0]), float(mt["gnorm"][0])
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"hybrid training step {i + 1}: loss {loss} "
                                 f"gnorm {gnorm}")
        rows.append({"loss": loss, "gnorm": gnorm, "ms": ms})
        print(f"[train] {cfg.name} {cfg.n_layers} layers (one unit) hier "
              f"1x4 4x2048 step {i + 1}: loss {loss:.6f} gnorm "
              f"{gnorm:.6f} step {ms:.1f} ms {4 * 2048 / ms * 1e3:.1f} "
              f"tokens/s")
    launches = {n: k_.launches for n, k_ in kernels.items()}
    grads = bundle.stats["grad_bytes"]
    per_step = {n: v / HYBRID_TRAIN_STEPS for n, v in launches.items()}
    tail = rows[1:]
    step_ms = sum(r["ms"] for r in tail) / len(tail)
    # naive keeps a private replica of params, m, v and grads on each of
    # the node's 4 ranks: 4 logical copies (~110 GB), which the card cannot
    # hold, so it is reckoned, not run
    naive = vc.chips * 4 * logical
    hier = held + grads
    print(f"[train] {cfg.name} one unit: steps 2-{HYBRID_TRAIN_STEPS} "
          f"{step_ms:.1f} ms a step, {4 * 2048 / step_ms * 1e3:.1f} tokens/s "
          f"(4 x 2048 tokens); losses {[r['loss'] for r in rows]}; "
          f"peak allocated {torch.cuda.max_memory_allocated(dev) / 1e9:.1f} "
          f"GB; launches a step {per_step}")
    print(f"[train] {cfg.name} state per node (1 node copy, measured): "
          f"params + m + v {held / 1e9:.3f} GB, grads {grads / 1e9:.3f} GB, "
          f"total {hier / 1e9:.3f} GB ({hier / (4 * logical):.5f} of the "
          f"logical params / m / v / grads, the step counter and the "
          f"allocator's rounding the rest); naive (4 private copies, "
          f"reckoned: 4 x params / m / v / grads of {logical / 1e9:.3f} GB "
          f"each) {naive / 1e9:.3f} GB; C1 naive/hier {naive / hier:.4f}")
    if not 3.99 <= naive / hier <= 4.0:
        raise AssertionError(f"hybrid training state C1 {naive / hier}: "
                             f"hier holds more than one node copy")
    for n, v in launches.items():
        if v <= 0:
            raise AssertionError(f"phase 18 never launched {n}")
    del bundle, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# phase 19 trains the granite benchmark cell's configuration: 8 of the 32
# layers as published (multipliers, tied embedding at 12, dropless top 8 of
# 40), hier on 2x4, 8 x 2048 tokens
DROPLESS_LAYERS, DROPLESS_STEPS = 8, 3
#: the grouped entry's largest error against its plain version (cuBLAS f32,
#: TF32 off), as a share of the plain product's largest |entry|: 3xTF32
#: keeps near f32's ~1e-7; a TF32 product misses it (checked below)
GROUPED_REL = 1e-5


def dropless_moe_phase(dev, capacity=None) -> tuple:
    """Phase 19: ``granite-moe-3b-a800m`` as the benchmark's granite cell
    runs it (``DROPLESS_LAYERS`` layers, the four published multipliers,
    the tied embedding at 12, the softmax over the published vocabulary,
    dropless top 8 of 40 on the grouped entry of ``csrc/matmul.cu``),
    through ``make_cluster_train_step`` in hier on 2x4, 8 x 2048 tokens,
    ``DROPLESS_STEPS`` steps: the first step's routing keeps every
    assignment, and each later step launches the grouped entry 64 / 32 / 32
    times (NN / NT / TN: 8 layers x 2 node runs x 2 products, the forward
    and its recompute, then dX and dW).  Then the grouped entry at that
    run's shapes against its plain version and float64: the segments of
    the first layer's routing of one node run (4 x 2048 tokens x 8 = 65,536
    rows), and the same with two experts' rows moved to their neighbours
    (two empty segments); NN, NT and TN for w_in (K 1536, N 1024) and
    w_out (K 512, N 1536), timed beside the plain version with the bound.
    Each later step also launches the ``moe_gather`` entries 32 / 32 / 16 /
    16 times (dispatch and combine in the forward and its recompute,
    combine_bwd and dispatch_bwd in the backward), and they run at that
    routing too (``moe_gather_rows``), and on ``capacity``'s routings
    (phase 15's: its ``moe_gather`` launches and each training run's first
    routing; None: none).  Returns the grouped entry's kernels record and
    moe_gather's, their launches the runs'."""
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MoESpec
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.kernels import matmul as kmatmul
    from repro_torch.kernels import moe_gather as kmoe
    from repro_torch.models import moe
    from repro_torch.runtime.steps import make_cluster_train_step
    from repro_torch.substrate import VirtualCluster

    base = get_config("granite-moe-3b-a800m")
    cfg = dataclasses.replace(
        base, n_layers=DROPLESS_LAYERS, tie_embeddings=True,
        embed_scale=12.0, residual_scale=0.22, attn_scale=1 / 64,
        logit_scale=6.0, mask_vocab_pad=True,
        moe=MoESpec(num_experts=40, top_k=8, d_ff_expert=512,
                    capacity_factor=None))
    E, k, d, dff = (cfg.moe.num_experts, cfg.moe.top_k, cfg.d_model,
                    cfg.moe.d_ff_expert)
    vc = VirtualCluster(pods=2, chips=4, device=dev)
    bundle = make_cluster_train_step(cfg, vc, mode="hier", global_batch=8)
    state = bundle.init_layout_state(19)
    stream = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=2048,
                                    global_batch=8, seed=19))
    batches = [bundle.layout_batch(stream.next_batch())
               for _ in range(DROPLESS_STEPS)]
    per_step = {"nn": 64, "nt": 32, "tn": 32}
    rows_per_step = {"dispatch": 32, "combine": 32, "combine_bwd": 16,
                     "dispatch_bwd": 16}
    ms, losses = [], []
    for i, batch in enumerate(batches):
        if i == 1:
            kmatmul.grouped_launches_by_layout.update(
                dict.fromkeys(kmatmul.LAYOUTS, 0))
            kmoe.launches.update(dict.fromkeys(kmoe.ENTRIES, 0))
        with (moe.routes() if i == 0 else contextlib.nullcontext()) as rec:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, mt = bundle.step(state, batch)
            loss = float(mt["loss"][0])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
        if i == 0:
            assigned, kept = moe.drops(rec)
            idx = rec["idx"][0]
            if kept != assigned or assigned != len(rec["idx"]) * idx.numel():
                raise AssertionError(f"dropless step kept {kept} of "
                                     f"{assigned} assignments")
        if not math.isfinite(loss):
            raise AssertionError(f"dropless granite step {i + 1}: loss {loss}")
        losses.append(loss)
    n_later = DROPLESS_STEPS - 1
    got = dict(kmatmul.grouped_launches_by_layout)
    want = {k_: v_ * n_later for k_, v_ in per_step.items()}
    got_rows = dict(kmoe.launches)
    want_rows = {k_: v_ * n_later for k_, v_ in rows_per_step.items()}
    step_ms = sum(ms[1:]) / n_later
    print(f"[train] {cfg.name} as published, {cfg.n_layers} layers hier 2x4 "
          f"8x2048, dropless: steps 2-{DROPLESS_STEPS} {step_ms:.1f} ms a "
          f"step, {8 * 2048 / step_ms * 1e3:.1f} tokens/s; losses {losses}; "
          f"step 1 kept {kept} of {assigned} assignments; grouped launches "
          f"in steps 2-{DROPLESS_STEPS} {got} (want {want}); moe_gather "
          f"launches {got_rows} (want {want_rows}); peak allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.1f} GB")
    if got != want:
        raise AssertionError(f"grouped launches {got}, want {want}")
    if got_rows != want_rows:
        raise AssertionError(f"moe_gather launches {got_rows}, want "
                             f"{want_rows}")
    launches = sum(got.values())
    del bundle, state, batches
    gc.collect()
    torch.cuda.empty_cache()

    order, counts, offsets = moe.segment_tables(idx, E)
    del order
    R = int(offsets[-1])
    moved = counts.clone()
    for e in (0, E // 2):
        moved[e + 1] += moved[e]
        moved[e] = 0
    variants = {"routed": offsets, "two empty": torch.cat(
        [moved.new_zeros(1), moved.cumsum(0)]).to(torch.int32)}
    g = torch.Generator(device=dev).manual_seed(19)
    print(f"[kernel] grouped_matmul segments of layer 0's routing (one node "
          f"run, {R} rows = 4 x 2048 x {k}): {E} experts, rows a segment "
          f"{int(counts.min())}..{int(counts.max())} (mean {R / E:.0f})")
    record = None
    for label, off in variants.items():
        for layout, site, (K, N) in (("nn", "w_in", (d, 2 * dff)),
                                     ("nn", "w_out", (dff, d)),
                                     ("nt", "w_in dX", (2 * dff, d)),
                                     ("nt", "w_out dX", (d, dff)),
                                     ("tn", "w_in dW", (d, 2 * dff)),
                                     ("tn", "w_out dW", (dff, d))):
            a = torch.randn((R, K), generator=g, device=dev)
            b = torch.randn((R, N) if layout == "tn" else
                            (E, N, K) if layout == "nt" else (E, K, N),
                            generator=g, device=dev)
            out = kmatmul.grouped_matmul_cuda(a, b, off, layout)
            plain = kmatmul.grouped_matmul_plain(a, b, off, layout)
            f64 = kmatmul.grouped_matmul_plain(a.double(), b.double(), off,
                                               layout)
            top = f64.abs().max()
            rel = ((out - plain).abs().max() / plain.abs().max()).item()
            rel64 = [((c.double() - f64).abs().max() / top).item()
                     for c in (out, plain)]
            abs_err = (out - plain).abs().max().item()
            if layout == "tn":
                empty = (off[1:] == off[:-1]).nonzero().flatten().tolist()
                if any(out[e].any() for e in empty):
                    raise AssertionError(f"grouped tn {site} {label}: an "
                                         f"empty segment's dW is not 0")
            del plain, f64
            if not rel <= GROUPED_REL or not torch.isfinite(out).all():
                raise AssertionError(
                    f"grouped {layout} {site} {label}: max|err| {rel:.3g} "
                    f"of the plain product's largest |C| > {GROUPED_REL}")
            k_ms = cuda_ms(lambda: kmatmul.grouped_matmul_cuda(
                a, b, off, layout), 3)
            p_ms = cuda_ms(lambda: kmatmul.grouped_matmul_plain(
                a, b, off, layout), 1)
            flops = 2.0 * R * K * N
            outs = E * K * N if layout == "tn" else R * N
            ins = R * K + (R * N if layout == "tn" else E * K * N)
            bnd = f32_bounds(flops, 4.0 * (ins + outs))
            print(f"[kernel] grouped_matmul f32 {layout} {site}, {label} "
                  f"segments: R {R} K {K} N {N}: against the plain version "
                  f"{rel:.3g}, against float64 kernel {rel64[0]:.3g} plain "
                  f"{rel64[1]:.3g} of the largest |C|  kernel {k_ms:.3f} ms "
                  f"({flops / k_ms / 1e9:.1f} TFLOP/s)  plain {p_ms:.3f} ms "
                  f"({flops / p_ms / 1e9:.1f} TFLOP/s)  " + bounds_text(bnd))
            if record is None:
                record = {"max_abs_err": abs_err, "ms": k_ms,
                          "plain_ms": p_ms, **least(bnd)}
            del a, b, out
    # the rule is one a TF32 product misses: cuBLAS on TF32 operands at
    # the largest segment of w_in's forward
    e = int(counts.argmax())
    a = torch.randn((int(counts[e]), d), generator=g, device=dev)
    b = torch.randn((d, 2 * dff), generator=g, device=dev)
    f32 = torch.matmul(a, b)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    rel_tf32 = ((tf32 - f32).abs().max() / f32.abs().max()).item()
    print(f"[kernel] grouped_matmul rule: a TF32 product of the largest "
          f"segment ({a.shape[0]} x {d} x {2 * dff}) is off by {rel_tf32:.3g} "
          f"of the largest |C|, over the rule's {GROUPED_REL}")
    if not rel_tf32 > GROUPED_REL:
        raise AssertionError(f"a TF32 product meets the grouped rule "
                             f"({rel_tf32:.3g})")
    del a, b, f32, tf32
    gc.collect()
    torch.cuda.empty_cache()
    capacity = capacity or {"launches": 0, "routings": ()}
    rows = moe_gather_rows(dev, idx, E, g,
                           sum(got_rows.values()) + capacity["launches"],
                           capacity["routings"])
    return {"name": "grouped_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/matmul.cu",
            "replaces": "src/repro/models/moe.py:72", "launches": launches,
            **record, "library_ms": None}, rows


#: the gates' gradient (a dot product of d terms in the kernel's fixed
#: order) against a float64 one, of its largest |entry|
MOE_GATHER_DG_REL = 1e-6


def moe_gather_operands(dev, g, idx, E: int, tables=None, d: int = 1536
                        ) -> dict:
    """The four ``moe_gather`` entries' operands on the routing ``idx``
    (..., N, k), d wide, f32: the dropless tables (``segment_tables``, b 1,
    every cell one slot) or, with ``tables`` = (e0, n_local, capacity), the
    capacity path's as ``moe_block`` builds them (``dispatch_tables``, b the
    leading dims: dropped slots and other groups' experts a sentinel in inv,
    cells no slot reaches one in table and back); seeded rows and gates.
    Returns entry -> its arguments."""
    import torch
    from repro_torch.models import moe
    k = idx.shape[-1]
    if tables is None:
        N = idx.numel() // k
        slot = moe.segment_tables(idx, E)[0].reshape(1, 1, N * k)
        table = slot // k
    else:
        e0, n_local, capacity = tables
        N = idx.shape[-2]
        table, slot = moe.dispatch_tables(idx, e0=e0, n_local=n_local,
                                          capacity=capacity)
    inv, perm, back = moe.combine_tables(slot, N, k)
    b, S = inv.numel() // (N * k), table.shape[-2] * table.shape[-1]
    # contiguous, as ``ops.MoeDispatch`` / ``MoeCombine`` hand them over
    table, back = (t.reshape(b, S).contiguous() for t in (table, back))
    inv, perm = (t.reshape(b, N, k).contiguous() for t in (inv, perm))
    x, dy = (torch.randn((b, N, d), generator=g, device=dev)
             for _ in range(2))
    src, d_buf = (torch.randn((b, S, d), generator=g, device=dev)
                  for _ in range(2))
    gate = torch.softmax(torch.randn((b, N, k), generator=g, device=dev), -1)
    gs = torch.gather(gate, -1, perm)
    return {"dispatch": (x, table, inv), "combine": (src, gs, inv),
            "combine_bwd": (dy, gs, inv, src, back),
            "dispatch_bwd": (d_buf, inv)}


def moe_gather_check(entry: str, args: tuple) -> tuple:
    """One ``moe_gather`` entry's kernel on ``args`` against its plain
    version, bit for bit, and against a second run of itself; combine_bwd's
    d_g against a float64 dot product instead, within
    ``MOE_GATHER_DG_REL`` of its largest |entry|.  Returns the largest
    |kernel - reference| over the entry's outputs and d_g's error relative
    to that largest entry (None for the other entries)."""
    import torch
    from repro_torch.kernels import moe_gather as kmoe
    kern = getattr(kmoe, f"{entry}_cuda")
    got, again, want = (r if isinstance(r, tuple) else (r,) for r in (
        kern(*args), kern(*args), getattr(kmoe, f"{entry}_plain")(*args)))
    rel = None
    if entry == "combine_bwd":
        dy, _, inv, src, _ = args
        want = (want[0], (dy.double()[:, :, None, :]
                          * kmoe.gather_rows(src.double(), inv)).sum(-1))
        rel = ((got[1].double() - want[1]).abs().max()
               / want[1].abs().max()).item()
        if not rel <= MOE_GATHER_DG_REL:
            raise AssertionError(f"moe_gather combine_bwd: d_g off by "
                                 f"{rel:.3g} of float64's largest")
    err = max((a.double() - w).abs().max().item() if a.numel() else 0.0
              for a, w in zip(got, want))
    bits = all(torch.equal(a, w) for a, w in zip(got, want)
               if w.dtype == a.dtype)
    if not (bits and all(torch.equal(a, b) for a, b in zip(got, again))):
        raise AssertionError(f"moe_gather {entry}: the kernel is not the "
                             f"plain version's bits, or not run to run")
    return err, rel


def moe_gather_rows(dev, idx, E: int, g, launches: int,
                    capacity_routings=()) -> dict:
    """Phase 19's row movements: the four ``moe_gather`` entries on the
    tables of ``idx`` (a node run's dropless routing, M tokens x k), d 1536
    f32, against their plain versions (the padded-gather and k-term
    composition they replace; ``moe_gather_check``), each timed beside the
    plain version and its bound (each input byte read once, each output
    written once, at 3.35 TB/s); then checked alone on each of
    ``capacity_routings`` (label, idx, e0, n_local, capacity: phase 15's
    routings), batched and with sentinels.  Returns the kernels record (ms:
    the four summed; max_abs_err the largest of every check's; dg_rel d_g's
    largest relative error)."""
    import torch
    from repro_torch.analysis.roofline import HBM_BW
    from repro_torch.kernels import moe_gather as kmoe
    k, d = idx.shape[-1], 1536
    M = idx.numel() // k
    rows, words = 4.0 * M * d, 8.0 * M * k     # a (M, d) f32; an index table
    moved = {
        "dispatch": rows + 2 * words + k * rows,
        "combine": k * rows + words + 4 * M * k + rows,
        "combine_bwd": rows + 4 * M * k + 2 * words + 2 * k * rows
        + 4 * M * k,
        "dispatch_bwd": k * rows + words + rows,
    }
    record = {"max_abs_err": 0.0, "dg_rel": 0.0, "ms": 0.0, "plain_ms": 0.0,
              "bound_ms": 0.0}

    def checked(entry, args):
        err, rel = moe_gather_check(entry, args)
        record["max_abs_err"] = max(record["max_abs_err"], err)
        if rel is not None:
            record["dg_rel"] = max(record["dg_rel"], rel)
        return ("bit-identical, run to run" if rel is None else
                f"d_src bit-identical, run to run, d_g against float64 "
                f"{rel:.3g} of its largest")

    cases = moe_gather_operands(dev, g, idx, E, d=d)
    for entry, args in cases.items():
        note = checked(entry, args)
        kern = getattr(kmoe, f"{entry}_cuda")
        plain = getattr(kmoe, f"{entry}_plain")
        k_ms = cuda_ms(lambda: kern(*args), 10)
        p_ms = cuda_ms(lambda: plain(*args), 3)
        bnd = moved[entry] / HBM_BW * 1e3
        print(f"[kernel] moe_gather {entry} f32 M {M} k {k} d {d} (layer 0's "
              f"routing): {note}  kernel {k_ms:.3f} ms "
              f"({moved[entry] / k_ms / 1e6:.0f} GB/s)  plain {p_ms:.3f} ms "
              f" bound {bnd:.3f} ms (bytes {moved[entry] / 1e9:.3f} GB at "
              f"3.35 TB/s; {100 * bnd / k_ms:.1f}% of it)")
        record["ms"] += k_ms
        record["plain_ms"] += p_ms
        record["bound_ms"] += bnd
    print(f"[kernel] moe_gather the four entries: kernel {record['ms']:.3f} "
          f"ms, plain {record['plain_ms']:.3f} ms, bound "
          f"{record['bound_ms']:.3f} ms")
    del cases
    gc.collect()
    torch.cuda.empty_cache()
    sentinel = empty = False
    for label, r_idx, e0, n_local, capacity in capacity_routings:
        cases = moe_gather_operands(dev, g, r_idx, E,
                                    (e0, n_local, capacity), d)
        _, table, inv = cases["dispatch"]
        b, S = table.shape
        N = inv.shape[1]
        drop, hole = int((inv == S).sum()), int((table == N).sum())
        sentinel, empty = sentinel or drop > 0, empty or hole > 0
        notes = {entry: checked(entry, args) for entry, args in cases.items()}
        print(f"[kernel] moe_gather on phase 15's {label} capacity routing "
              f"(b {b}, N {N}, k {k}, {n_local} local experts x capacity "
              f"{capacity}, d {d} f32): {drop} sentinel slots, {hole} empty "
              f"cells; {notes}")
        del cases, table, inv
        gc.collect()
        torch.cuda.empty_cache()
    if capacity_routings and not (sentinel and empty):
        raise AssertionError(f"phase 15's capacity routings left moe_gather "
                             f"no sentinel slot ({sentinel}) or no empty "
                             f"cell ({empty}) to check")
    print(f"[kernel] moe_gather record: max |kernel - reference| "
          f"{record['max_abs_err']:.3g} (d_g against float64), d_g "
          f"{record['dg_rel']:.3g} of its largest")
    return {"name": "moe_gather", "route": "cuda",
            "source": "src/repro_torch/csrc/moe_gather.cu",
            "replaces": "src/repro/models/moe.py:112", "launches": launches,
            **record, "bound_by": "bytes", "library_ms": None}


def collectives_bench(dev, g, *, sweep_elems, elems: int, big: int,
                      mm: int, tree: dict, table_path: str) -> None:
    """Phase 10: (a) the quick bench sweep, validated, folded into a table
    and held against the committed one; (b) ``auto`` resolving from that
    table; (c) async gathers against eager ones, the torn-handle rule and
    the overlap of a gather with the panel kernel; (d) the step graph on a
    gradient record of ``tree`` (leaf path -> per-rank shape) on 2x4."""
    import torch
    from repro_torch.analysis import traffic
    from repro_torch.bench import __main__ as bench_cli
    from repro_torch.bench import gates, report, suites
    from repro_torch.comm import (Communicator, WindowEpochError, registry,
                                  tuning)
    from repro_torch.comm.tuning import TuningTable
    from repro_torch.kernels import ops
    from repro_torch.substrate import collectives as coll
    from repro_torch.substrate import default_matrix

    matrix = default_matrix(device=dev)
    # (a) the quick sweep over the matrix
    t0 = time.perf_counter()
    cases = suites.build_cases(clusters=matrix, elems=sweep_elems,
                               dtypes=suites.DTYPES, on_skip=lambda m: None)
    suite = suites.run_suite(cases, reps=5)       # raises on any mismatch
    rep = report.to_report(suite, quick=True, reps=5,
                           families=suites.COLLECTIVE_FAMILIES,
                           elems=sweep_elems, dtypes=suites.DTYPES,
                           device=dev)
    eager = [c["name"] for c in rep["cases"]
             if dev.type == "cuda" and c["timing"]["mode"] != "graph"]
    print(f"[bench] quick sweep: {len(cases)} cases in "
          f"{time.perf_counter() - t0:.1f} s, validation OK, "
          f"{rep['validation']['num_checks']} checks; timed eagerly: "
          f"{len(eager)} {eager[:4]}")
    med = {(c["topology"], c["family"], c["scheme"], c["elems"],
            c["dtype"]): c["timing"]["median_us"] for c in rep["cases"]}
    c1 = {ch["name"]: ch["measured"] for ch in rep["cross_checks"]}
    for vc in matrix:
        ag = {s: med.get((vc.label, "allgather", s, elems, "float32"))
              for s in ("naive", "hier", "shared")}
        ratio = c1.get(f"C1/allgather/{vc.label}/e{elems}")
        print(f"[bench] {vc.label} allgather e{elems} f32 median us: "
              + "  ".join(f"{s} {v:.1f}" for s, v in ag.items())
              + f"  C1 naive/shared {ratio}")
        if ratio != vc.chips:
            raise AssertionError(f"C1 {vc.label}: {ratio} != {vc.chips}")
    with tempfile.TemporaryDirectory() as tmp:
        fresh = os.path.join(tmp, "bench.json")
        report.write_report(rep, fresh)
        if bench_cli.emit_tuning_table(fresh, os.path.join(tmp, "t.json"),
                                       log=lambda m: None):
            raise AssertionError("the fresh table failed its self-check")
    with open(table_path) as f:
        committed = json.load(f)
    errs = gates.schema_errors(committed)
    rows, stale = gates.staleness_failures(committed, rep, 3.0)
    if errs or stale:
        raise AssertionError(f"committed table {table_path}: "
                             f"{(errs + stale)[:5]}")
    print(f"[bench] fresh table self-checked; committed table "
          f"({committed['meta'].get('nvidia_smi')}) not stale at tol 3.0 "
          f"over {len(rows)} cells")

    # (b) auto resolves from the committed table
    table = TuningTable.from_dict(committed)
    picks = []
    for vc in matrix:
        comm = Communicator.from_cluster(vc)
        for family in traffic.FAMILIES:
            res = tuning.resolve_for(comm, family, elems=elems)
            entry = table.lookup(family, tuning.signature_for(comm),
                                 "float32", elems * 4)
            want = next(ch.scheme for ch in entry.ranking
                        if registry.get_scheme(ch.scheme).precision
                        == "exact")
            if res.source != "measured" or res.scheme != want:
                raise AssertionError(f"auto {vc.label}/{family}: {res} != "
                                     f"measured {want}")
            picks.append(f"{family}={res.scheme}")
        with vc.bind():
            x = torch.randn((vc.num_devices, elems), generator=g, device=dev)
            auto = traffic._full("allgather", comm.allgather(x), comm)
            naive = comm.allgather(x, scheme="naive")
            if not torch.equal(auto, naive):
                raise AssertionError(f"auto allgather {vc.label}: values "
                                     "differ from naive")
        print(f"[auto] {vc.label} e{elems}: measured " + " ".join(picks[-6:])
              + "; allgather values == naive")

    # (c) async handles
    for vc in matrix:
        comm = Communicator.from_cluster(vc)
        with vc.bind():
            x = torch.randn((vc.num_devices, elems), generator=g, device=dev)
            h = comm.allgather_async(x)
            got = h.resolve()
            if not torch.equal(got, comm.allgather(x, scheme="shared")
                               .read()):
                raise AssertionError(f"async {vc.label}: != eager")
            h = comm.allgather_async(x)
            torn = dataclasses.replace(h, window=h.window.store(x))
            try:
                torn.resolve()
            except WindowEpochError:
                pass
            else:
                raise AssertionError(f"async {vc.label}: a store between "
                                     "issue and resolve did not raise")
    print(f"[async] allgather_async(...).resolve() == allgather(shared)"
          f".read() on {len(matrix)} topologies at e{elems}; a store "
          f"between issue and resolve raises WindowEpochError")
    vc = next(v for v in matrix if v.label == "2x4")
    comm = Communicator.from_cluster(vc)
    a = torch.randn((mm, mm), generator=g, device=dev)
    b = torch.randn((mm, mm), generator=g, device=dev)
    with vc.bind():
        x = torch.randn((vc.num_devices, big), generator=g, device=dev)

        def serial():
            comm.allgather(x, scheme="shared").read()
            ops.matmul(a, b)

        def overlapped():
            h = comm.allgather_async(x, scheme="shared")
            ops.matmul(a, b)
            h.resolve()

        t_gather = cuda_ms(lambda: comm.allgather(x, scheme="shared")
                           .read(), 3)
        t_mm = cuda_ms(lambda: ops.matmul(a, b), 3)
        t_serial, t_async = cuda_ms(serial, 3), cuda_ms(overlapped, 3)
    print(f"[async] 2x4 e{big}: issue, ops.matmul f32 {mm}^3, resolve "
          f"{t_async:.3f} ms against serial {t_serial:.3f} ms (gather "
          f"{t_gather:.3f} + matmul {t_mm:.3f})")
    del a, b, x

    # (d) the step graph on a gradient record
    R = vc.num_devices
    grads = {k: torch.randn((R,) + s, generator=g, device=dev)
             for k, s in tree.items()}
    for k in ("loss", "count", "norm"):
        grads[k] = torch.randn((R,), generator=g, device=dev)
    n_elems = sum(t[0].numel() for t in grads.values())
    with vc.bind():
        rec = comm.record()
        refs = {k: rec.allreduce(v, axes=comm.axes, scheme="naive", key=k)
                for k, v in grads.items()}
        res = rec.run()
        for k, v in grads.items():
            if not torch.equal(res[refs[k]], coll.psum(v, comm.axes)):
                raise AssertionError(f"step graph: {k} != eager allreduce")
        r = res.report()
        del res

        def eager():
            for v in grads.values():
                comm.allreduce(v, scheme="naive")

        t_eager = cuda_ms(eager, 2)
        t_sched = cuda_ms(rec.run, 2)
    ar = r["allreduce"]
    r.update(config="qwen3-0.6b units + loss/count/norm",
             topology=vc.label, pods=vc.pods, chips=vc.chips, elems=n_elems)
    bad = gates.schedule_failures({"schema": r["schema"], "reports": [r]})
    if bad:
        raise AssertionError(f"schedule gate: {bad}")
    print(f"[stepgraph] {vc.label}, {n_elems} elements per rank "
          f"({n_elems * 4 / 1e9:.2f} GB; {n_elems * 4 * R / 1e9:.1f} GB a "
          f"copy): rec.run() == per-leaf eager allreduce (torch.equal); "
          f"messages {ar['before_messages']} -> {ar['after_messages']} "
          f"({len(r['buckets'])} buckets, {r['singles']} singles), bytes "
          f"{ar['before_bytes']} -> {ar['after_bytes']}; schedule "
          f"{t_sched:.3f} ms against eager {t_eager:.3f} ms; schedule gate "
          f"OK")
    del grads, rec


def main() -> int:
    # phase 13 runs under deterministic algorithms; cuBLAS needs its
    # workspace fixed before CUDA starts for that
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    import numpy as np
    from repro_torch.analysis import traffic
    from repro_torch.analysis.state_rule import state_close
    from repro_torch.apps import bpmf, summa
    from repro_torch.bench import suites
    from repro_torch.comm import Communicator, tuning
    from repro_torch.comm.quantize import dequantize_q4, quantize_q4
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import flash_attention_bwd as kbwd
    from repro_torch.kernels import lru_scan as klru
    from repro_torch.kernels import lru_scan_bwd as klrub
    from repro_torch.kernels import matmul as kmatmul
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant as kquant
    from repro_torch.kernels import ref as kref
    from repro_torch.models import ParallelCtx, build
    from repro_torch.models import meta
    from repro_torch.models.attention import attn_flops
    from repro_torch.bench import __main__ as bench_cli
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as train_cli
    from repro_torch.runtime.elastic import (ElasticRuntime, FaultEvent,
                                             FaultPlan, reference_run)
    from repro_torch.runtime.steps import make_cluster_train_step
    from repro_torch.serving.live_tuning import LiveTuner
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler
    from repro_torch.substrate import VirtualCluster, default_matrix
    from repro_torch.substrate.collectives import recording

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)

    # -- 1. device and build ---------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    libs = _cuda.build_all()
    print(f"[build] {len(libs)} sources in {time.perf_counter() - t0:.1f} s")
    for lib in libs.values():
        print(f"[build] {lib.path.name}: nvcc {lib.build_seconds:.1f} s")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    kmatmul.library()
    kquant.library()
    kflash.library()
    kbwd.library()
    klru.library()
    klrub.library()

    # -- 2. kernel vs its plain version ----------------------------------------
    t_phase = time.perf_counter()
    # 4096^3, then ragged edges, K < 32, N = 4 and rows whose K and N are
    # not multiples of 4 (the kernel's element-wise load path)
    for dtype in (torch.float32, torch.bfloat16):
        for M, K, N in ((4096, 4096, 4096), (96, 160, 224), (5, 96, 20),
                        (64, 20, 4), (33, 131, 21)):
            a = torch.randn((M, K), generator=g, device=dev).to(dtype)
            b = torch.randn((K, N), generator=g, device=dev).to(dtype)
            got = ops.matmul(a, b)
            torch.cuda.synchronize()
            err = check_close(got, kmatmul.matmul_plain(a, b), dtype, K,
                              f"matmul {dtype} {M}x{K}x{N}")
            line = f"[kernel] {str(dtype)[6:]:8s} {M}x{K}x{N}: " \
                   f"max|err| {err:.3g}"
            if M == 4096:
                flops = 2.0 * M * K * N
                moved = (M * K + K * N + M * N) * a.element_size()
                if dtype == torch.float32:
                    b_txt = bounds_text(f32_bounds(flops, moved))
                else:
                    b_ms, b_by = bound(flops, moved, "bf16")
                    b_txt = (f"bound {b_ms:.3f} ms ({b_by}, bf16 tensor "
                             f"cores)")
                line += (f"  kernel {cuda_ms(lambda: ops.matmul(a, b), 5):.3f}"
                         f" ms  plain "
                         f"{cuda_ms(lambda: kmatmul.matmul_plain(a, b), 5):.3f}"
                         f" ms  torch.matmul "
                         f"{cuda_ms(lambda: torch.matmul(a, b), 5):.3f} ms  "
                         + b_txt)
            print(line)
    # the main path's shape: one SUMMA round = 16 rank panels of 4096^3 f32
    B, M = summa.NODES * summa.CORES, 4096
    a = torch.randn((B, M, M), generator=g, device=dev)
    b = torch.randn((B, M, M), generator=g, device=dev)
    got = ops.matmul(a, b)
    torch.cuda.synchronize()
    main_err = check_close(got, kmatmul.matmul_plain(a, b), torch.float32,
                           M, "matmul f32 16x4096^3")
    # accuracy against a float64 product on 2 of the 16 panels, the kernel
    # and torch.matmul side by side (max |err|, and over max |C|)
    want64 = torch.matmul(a[:2].double(), b[:2].double())
    f64 = {}
    for name, c in (("kernel", got[:2]), ("torch.matmul",
                                           torch.matmul(a[:2], b[:2]))):
        e = (c.double() - want64).abs().max().item()
        f64[name] = (e, e / want64.abs().max().item())
    del got, want64
    print(f"[kernel] f32 {B}x{M}^3 (SUMMA round), 2 panels against float64: "
          + "  ".join(f"{n} max|err| {e:.4g} (rel {r:.3g})"
                      for n, (e, r) in f64.items()))
    if not f64["kernel"][0] <= 2 * f64["torch.matmul"][0]:
        raise AssertionError(f"matmul f64 error {f64['kernel'][0]} above 2x "
                             f"torch.matmul's {f64['torch.matmul'][0]}")
    k_ms = cuda_ms(lambda: ops.matmul(a, b), 3)
    plain_ms = cuda_ms(lambda: kmatmul.matmul_plain(a, b), 3)
    lib_ms = cuda_ms(lambda: torch.matmul(a, b), 3)
    flops = 2.0 * B * M * M * M
    moved = 3.0 * B * M * M * 4                 # A, B read once, C written
    mm_bounds = f32_bounds(flops, moved)
    print(f"[kernel] f32 {B}x{M}^3 (SUMMA round): max|err| {main_err:.3g}  "
          f"kernel {k_ms:.3f} ms ({flops / k_ms / 1e9:.1f} TFLOP/s)  plain "
          f"{plain_ms:.3f} ms  torch.matmul {lib_ms:.3f} ms  "
          + bounds_text(mm_bounds))
    del a, b
    # the layouts at the qwen3-0.6b training step's shapes (a 2x4 node's 4
    # ranks of 2048 rows folded): w_in's forward (NN), dX (NT) and dW
    # (TN), w_out's dW (TN: 192 tiles, 1.45 waves), the unembedding
    # chunk's dX (NT) and dW (TN); torch.matmul on the same operands as
    # they lie (its transposed views)
    for layout, site, (M, N, K) in (
            ("nn", "w_in", (8192, 6144, 1024)),
            ("nt", "w_in dX", (8192, 1024, 6144)),
            ("tn", "w_in dW", (1024, 6144, 8192)),
            ("tn", "w_out dW", (3072, 1024, 8192)),
            ("nt", "unembedding dX", (2048, 1024, 151936)),
            ("tn", "unembedding dW", (1024, 151936, 2048))):
        a = torch.randn((K, M) if layout == "tn" else (M, K), generator=g,
                        device=dev)
        b = torch.randn((N, K) if layout == "nt" else (K, N), generator=g,
                        device=dev)
        ta, tb = (a.mT if layout == "tn" else a), (b.mT if layout == "nt"
                                                   else b)
        got = kmatmul.matmul_cuda(a, b, layout)
        lay_err = check_close(got, kmatmul.matmul_plain(a, b, layout),
                              torch.float32, K, f"matmul {layout} {site}")
        f64 = ta.double() @ tb.double()
        top = f64.abs().max()
        rel64 = [((c.double() - f64).abs().max() / top).item()
                 for c in (got, torch.matmul(ta, tb))]
        del got, f64
        lay_ms = cuda_ms(lambda: kmatmul.matmul_cuda(a, b, layout), 3)
        lay_lib = cuda_ms(lambda: torch.matmul(ta, tb), 3)
        flops = 2.0 * M * N * K
        print(f"[kernel] f32 {layout} {M}x{N}x{K} (qwen3-0.6b training, "
              f"{site}): max|err| {lay_err:.3g}, against float64 kernel "
              f"{rel64[0]:.3g} torch.matmul {rel64[1]:.3g} of the largest "
              f"|C|  kernel {lay_ms:.3f} ms "
              f"({flops / lay_ms / 1e9:.1f} TFLOP/s)  torch.matmul "
              f"{lay_lib:.3f} ms ({flops / lay_lib / 1e9:.1f} TFLOP/s)  "
              + bounds_text(f32_bounds(flops, 4.0 * (M * K + K * N
                                                     + M * N))))
        del a, b, ta, tb

    # q4_matmul against its plain version (group 32), then at the lossy
    # ag_matmul chunk's shape: 8 ranks x 2048 tokens x K 7168 x N 5120
    def q4_case(batch, M, K, N, dtype):
        a = torch.randn(batch + (M, K), generator=g, device=dev).to(dtype)
        w = torch.randn(batch + (K, N), generator=g, device=dev)
        packed, scales = quantize_q4(w, group=32)
        del w
        got = ops.q4_matmul(a, packed, scales, group=32)
        torch.cuda.synchronize()
        want = kquant.q4_matmul_plain(a, packed, scales, 32)
        err = check_close(got, want, dtype, K,
                          f"q4_matmul {dtype} {batch}x{M}x{K}x{N}")
        return a, packed, scales, err

    for batch, M, K, N, dtype in (((), 4, 64, 16, torch.float32),
                                  ((), 5, 96, 20, torch.float32),
                                  ((), 96, 256, 224, torch.bfloat16)):
        err = q4_case(batch, M, K, N, dtype)[-1]
        print(f"[kernel] q4_matmul {str(dtype)[6:]:8s} {M}x{K}x{N} g32: "
              f"max|err| {err:.3g}")
    QB, QM, QK, QN = 8, 2048, 7168, 5120
    a, packed, scales, q4_err = q4_case((QB,), QM, QK, QN, torch.float32)
    q4_ms = cuda_ms(lambda: ops.q4_matmul(a, packed, scales, group=32), 3)
    q4_plain_ms = cuda_ms(
        lambda: kquant.q4_matmul_plain(a, packed, scales, 32), 3)
    dense = dequantize_q4(packed, scales, group=32)
    dense_ms = cuda_ms(lambda: torch.matmul(a, dense), 3)
    del dense
    q4_flops = 2.0 * QB * QM * QK * QN
    q4_moved = QB * (QM * QK * 4 + QK // 2 * QN + QK // 32 * QN * 4
                     + QM * QN * 4)
    q4_bounds = f32_bounds(q4_flops, q4_moved)
    print(f"[kernel] q4_matmul f32 {QB}x{QM}x{QK}x{QN} g32 (lossy ag_matmul "
          f"chunk): max|err| {q4_err:.3g}  kernel {q4_ms:.3f} ms "
          f"({q4_flops / q4_ms / 1e9:.1f} TFLOP/s, "
          f"{q4_bounds['bound_ms'] / q4_ms:.2f} of the bound)  plain "
          f"{q4_plain_ms:.3f} ms  {bounds_text(q4_bounds)} "
          f"({q4_flops:.3g} FLOP, "
          f"{q4_moved / 1e9:.3f} GB)  library: none "
          f"computes this function (for orientation only, a different "
          f"function: torch.matmul on the pre-dequantized dense weight "
          f"{dense_ms:.3f} ms)")
    del a, packed, scales

    # flash attention against its plain version: tests/test_kernels.py's
    # shapes (q at the end of the keys), windows, non-causal, hd 256
    flash_cases = [(1, 4, 4, 128, 128, 64, True, None),
                   (2, 8, 2, 128, 128, 64, True, None),
                   (1, 4, 1, 64, 256, 32, True, None),
                   (1, 3, 3, 96, 96, 16, True, None),
                   (2, 4, 2, 256, 256, 64, True, None),
                   (1, 2, 2, 128, 128, 32, True, 16),
                   (1, 2, 2, 128, 128, 32, True, 64),
                   (1, 2, 2, 64, 64, 32, False, None),
                   (1, 8, 1, 200, 200, 256, True, None)]
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, KV, Tq, Tkv, hd, causal, window in flash_cases:
            q = torch.randn((B, H, Tq, hd), generator=g, device=dev).to(dtype)
            k = torch.randn((B, KV, Tkv, hd), generator=g,
                            device=dev).to(dtype)
            v = torch.randn((B, KV, Tkv, hd), generator=g,
                            device=dev).to(dtype)
            kw = dict(causal=causal, window=window, q_offset=Tkv - Tq)
            got = ops.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            err = check_flash(got, kflash.flash_attention_plain(q, k, v, **kw),
                              dtype, f"flash_attention {dtype} "
                              f"{(B, H, KV, Tq, Tkv, hd)} {kw}")
            print(f"[kernel] flash_attention {str(dtype)[6:]:8s} B{B} H{H} "
                  f"KV{KV} Tq{Tq} Tkv{Tkv} hd{hd} causal={causal} "
                  f"window={window}: max|err| {err:.3g}")
    # the model's prefill shape (one layer, a full 8-slot group at the
    # largest bucket), in the model's (B, T, heads, hd) layout
    FB, FH, FKV, FT, FD = 8, 16, 8, 2048, 128
    q = torch.randn((FB, FT, FH, FD), generator=g, device=dev)
    k = torch.randn((FB, FT, FKV, FD), generator=g, device=dev)
    v = torch.randn((FB, FT, FKV, FD), generator=g, device=dev)
    got = ops.flash_attention(q, k, v, layout="bthd")
    torch.cuda.synchronize()
    flash_err = check_flash(got, kflash.flash_attention_plain(
        q, k, v, layout="bthd"), torch.float32, "flash_attention model shape")
    del got
    flash_ms = cuda_ms(lambda: ops.flash_attention(q, k, v, layout="bthd"), 5)
    flash_plain_ms = cuda_ms(lambda: kflash.flash_attention_plain(
        q, k, v, layout="bthd"), 3)
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flash_lib_ms = cuda_ms(lambda: sdpa(qs, ks, vs, is_causal=True,
                                        enable_gqa=True), 5)
    del qs, ks, vs
    flash_flops = attn_flops(FB, FT, FT, FH, FD, causal=True, window=None)
    flash_moved = 4 * (2 * q.numel() + 2 * k.numel())   # q, k, v read, o
    flash_bounds = f32_bounds(flash_flops, flash_moved)
    print(f"[kernel] flash_attention f32 B{FB} H{FH} KV{FKV} T{FT} hd{FD} "
          f"causal (one layer's prefill, 8 slots at the 2048 bucket): "
          f"max|err| {flash_err:.3g}  kernel {flash_ms:.3f} ms "
          f"({flash_flops / flash_ms / 1e9:.1f} TFLOP/s)  plain "
          f"{flash_plain_ms:.3f} ms  scaled_dot_product_attention "
          f"{flash_lib_ms:.3f} ms  {bounds_text(flash_bounds)} "
          f"({flash_flops:.4g} FLOP, {flash_moved / 1e9:.3f} GB)")
    del q, k, v
    # recurrentgemma-9b's local layer: 16 heads, 1 kv head x 256, window
    # 2048, at the hybrid serving run's largest prefill group (4 x 3071)
    HB, HH, HT, HD, HW = (HYBRID_PER_LENGTH, 16, max(HYBRID_LENGTHS) - 1,
                          256, 2048)
    q = torch.randn((HB, HT, HH, HD), generator=g, device=dev)
    k = torch.randn((HB, HT, 1, HD), generator=g, device=dev)
    v = torch.randn((HB, HT, 1, HD), generator=g, device=dev)
    got = ops.flash_attention(q, k, v, window=HW, layout="bthd")
    torch.cuda.synchronize()
    err = check_flash(got, kflash.flash_attention_plain(
        q, k, v, window=HW, layout="bthd"), torch.float32,
        "flash_attention hybrid shape")
    del got
    h_ms = cuda_ms(lambda: ops.flash_attention(q, k, v, window=HW,
                                               layout="bthd"), 5)
    h_plain_ms = cuda_ms(lambda: kflash.flash_attention_plain(
        q, k, v, window=HW, layout="bthd"), 2)
    # the library yardstick (timed only): SDPA with the causal band of the
    # window as a boolean mask, GQA over the one kv head
    qpos = torch.arange(HT, device=dev)
    band = (qpos[None, :] <= qpos[:, None]) \
        & (qpos[:, None] - qpos[None, :] < HW)
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    h_lib_ms = cuda_ms(lambda: sdpa(qs, ks, vs, attn_mask=band,
                                    enable_gqa=True), 3)
    del qs, ks, vs, band
    # the (q, k) pairs this causal window needs: min(q + 1, W) per row
    pairs = HB * (HW * (HW + 1) // 2 + (HT - HW) * HW)
    h_flops = 4.0 * pairs * HH * HD
    h_bounds = f32_bounds(h_flops, 4 * (2 * q.numel() + 2 * k.numel()))
    print(f"[kernel] flash_attention f32 B{HB} H{HH} KV1 T{HT} hd{HD} "
          f"window {HW} (recurrentgemma-9b's local layer, {HB} slots at {HT}): "
          f"max|err| {err:.3g}  kernel {h_ms:.3f} ms "
          f"({h_flops / h_ms / 1e9:.1f} TFLOP/s)  plain {h_plain_ms:.3f} ms"
          f"  scaled_dot_product_attention (band mask) {h_lib_ms:.3f} ms  "
          f"{bounds_text(h_bounds)} ({h_flops:.4g} FLOP)")
    del q, k, v

    # the non-finite rule (csrc/tf32x3.cuh): infinite, NaN and near-max
    # entries (the largest f32 rounds to inf in TF32), and an exact column
    # of 1.0 in the matmul's b; each kernel against its plain version by
    # class and, where finite, within tol * (1 + a bound on the magnitudes
    # summed), with the tiles it recomputed
    special = (float("inf"), float("-inf"), float("nan"),
               torch.finfo(torch.float32).max, -3.4e38)

    def plant(x, where):
        for idx, val in zip(where, special):
            x[idx] = val

    def recomputed(mod, what, tiles):
        n = mod.recomputes.read()
        mod.recomputes.reset()
        if not 0 < n <= tiles:
            raise AssertionError(f"{what}: {n} tiles recomputed")
        return f"{n} of {tiles} tiles recomputed"

    for m_ in (kmatmul, kquant, kflash, kbwd):
        m_.recomputes.reset()
    for dtype in (torch.float32, torch.bfloat16):
        a = torch.randn((2, 200, 96), generator=g, device=dev)
        b = torch.randn((2, 96, 300), generator=g, device=dev)
        b[..., 0] = 1.0
        plant(a, [(0, 3 + 40 * i, 5 + i) for i in range(5)])
        plant(b, [(1, 7 + i, 2 + 60 * i) for i in range(5)])
        a, b = a.to(dtype), b.to(dtype)
        what = f"matmul {str(dtype)[6:]} 2x200x96x300"
        counts = check_classes(ops.matmul(a, b), kmatmul.matmul_plain(a, b),
                               a.double().abs() @ b.double().abs(),
                               2e-4 if dtype == torch.float32 else 2e-2,
                               what)
        print(f"[nonfinite] {what}, {special} in a and in b: classes as the "
              f"plain version's {counts}, "
              + recomputed(kmatmul, what, 2 * 2 * 3))
    a = torch.randn((2, 160, 128), generator=g, device=dev)
    packed, scales = quantize_q4(torch.randn((2, 128, 200), generator=g,
                                             device=dev), group=32)
    plant(a, [(0, 3 + 30 * i, 5 + i) for i in range(5)])
    plant(scales, [(1, i % 4, 7 + 40 * i) for i in range(5)])
    what = "q4_matmul f32 2x160x128x200 g32"
    w = dequantize_q4(packed, scales, group=32)
    counts = check_classes(ops.q4_matmul(a, packed, scales, group=32),
                           kquant.q4_matmul_plain(a, packed, scales, 32),
                           a.double().abs() @ w.double().abs(), 2e-4, what)
    print(f"[nonfinite] {what}, {special} in a and in the scales: classes as "
          f"the plain version's {counts}, "
          + recomputed(kquant, what, 2 * 2 * 2))
    for B, H, KV, T, hd, window in ((1, 4, 2, 128, 64, None),
                                    (1, 8, 1, 200, 256, 16)):
        q, k, v = (torch.randn((B, n_, T, hd), generator=g, device=dev)
                   for n_ in (H, KV, KV))
        q[0, 1, 10, 3], q[0, 2, 70, 5] = special[0], special[3]
        k[0, 0, 20, 7], k[0, KV - 1, 40, 9] = special[1], special[3]
        for v_too in (False, True):
            if v_too:
                v[0, KV - 1, 50, 11], v[0, 0, 30, 12] = special[0], special[3]
            vmax = torch.where(torch.isfinite(v), v.abs(), 0).amax(2, True)
            what = (f"flash_attention f32 B{B} H{H} KV{KV} T{T} hd{hd} "
                    f"window={window}, specials in q, k"
                    + (", v" if v_too else ""))
            counts = check_classes(
                ops.flash_attention(q, k, v, window=window),
                kflash.flash_attention_plain(q, k, v, window=window),
                vmax.repeat_interleave(H // KV, 1), 2e-4, what)
            print(f"[nonfinite] {what}: classes as the plain version's "
                  f"{counts}, " + recomputed(kflash, what, B * H * -(-T // 64)))
    del a, b, packed, scales, w, q, k, v

    # the flash backward kernel against the autograd of the plain version:
    # the forward with lse gives the same output bits, its lse matches the
    # plain log-sum-exp, two launches give the same bits, and dq / dk / dv
    # agree (f32 2e-4, bf16 2e-2 of the largest gradient) over masks, GQA
    # (one kv head: the dk / dv pass splits the q heads), q_offset (rows
    # with no visible key included), ragged lengths and both layouts
    def bwd_check(q, k, v, do, dtype, what, **kw):
        o0 = kflash.flash_attention_cuda(q, k, v, **kw)
        o, lse = kflash.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        if not torch.equal(o0, o):
            raise AssertionError(f"{what}: the forward with lse is not "
                                 "bit-identical to the forward without it")
        q4, k4 = kflash._bhtd(q, kw["layout"]), kflash._bhtd(k, kw["layout"])
        want_lse = kref.attention_lse(q4, k4, causal=kw["causal"],
                                      window=kw["window"],
                                      q_offset=kw["q_offset"])
        seen = torch.isfinite(want_lse)
        lse_err = (lse[seen] - want_lse[seen]).abs().max().item()
        if not lse_err <= 1e-4 * (1 + want_lse[seen].abs().max().item()):
            raise AssertionError(f"{what}: lse off by {lse_err}")
        got = kbwd.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
        again = kbwd.flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a_, b_) for a_, b_ in zip(got, again)):
            raise AssertionError(f"{what}: two launches on the same inputs "
                                 "gave different bits")
        del again
        want = kbwd.flash_attention_bwd_plain(q, k, v, do, **kw)
        tol = 2e-4 if dtype == torch.float32 else 2e-2
        errs, abs_err = [], 0.0
        for name, a_, b_ in zip(("dq", "dk", "dv"), got, want):
            diff = (a_.float() - b_.float()).abs().max().item()
            e = diff / b_.float().abs().max().item()
            if not e <= tol:
                raise AssertionError(f"{what}: {name} rel err {e} > {tol}")
            errs.append(e)
            abs_err = max(abs_err, diff)
        return o, lse, errs, abs_err

    bwd_cases = [(2, 4, 2, 100, 100, 16, True, None, 0, "bhtd"),
                 (1, 4, 1, 70, 90, 32, True, 16, 0, "bhtd"),
                 (1, 2, 2, 50, 40, 64, True, 8, 30, "bhtd"),
                 (1, 2, 1, 40, 40, 128, True, None, -10, "bhtd"),
                 (1, 2, 1, 40, 60, 128, False, None, 0, "bthd"),
                 (1, 4, 2, 130, 130, 256, True, 64, 0, "bthd"),
                 (1, 2, 1, 40, 20, 16, False, 4, 10, "bhtd"),
                 (1, 8, 1, 130, 130, 256, True, 64, 0, "bhtd"),
                 (2, 16, 1, 200, 260, 128, True, None, 60, "bthd")]
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, KV, Tq, Tkv, hd, causal, window, qo, layout in bwd_cases:
            shp = (lambda n, T_: (B, n, T_, hd)) if layout == "bhtd" else (
                lambda n, T_: (B, T_, n, hd))
            q, do = (torch.randn(shp(H, Tq), generator=g,
                                 device=dev).to(dtype) for _ in range(2))
            k, v = (torch.randn(shp(KV, Tkv), generator=g,
                                device=dev).to(dtype) for _ in range(2))
            kw = dict(causal=causal, window=window, q_offset=qo,
                      layout=layout)
            what = (f"flash_attention_bwd {str(dtype)[6:]} B{B} H{H} KV{KV} "
                    f"Tq{Tq} Tkv{Tkv} hd{hd} causal={causal} "
                    f"window={window} q_offset={qo} {layout}")
            errs = bwd_check(q, k, v, do, dtype, what, **kw)[2]
            print(f"[kernel] {what}: forward with lse bit-identical, two "
                  f"launches bit-identical, rel err dq {errs[0]:.2e} dk "
                  f"{errs[1]:.2e} dv {errs[2]:.2e}")
    # timed at the training shapes: qwen3-0.6b's attention layer as phase
    # 11 (a) launches it (hier on 2x4 runs the model once per node, on its
    # 4 ranks' sequences folded: 4 x 2048, 16 heads, 8 kv heads, hd 128,
    # causal), the same layer at the global batch of 8 sequences, and the
    # hybrid's windowed hd-256 layer of the flash row above
    def plain_bwd_ms(q, k, v, do, **kw):
        """The plain version's backward alone: its forward once, then
        ``autograd.grad`` with the graph retained, as SDPA's is timed."""
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
            out = kflash.flash_attention_plain(*leaves, **kw)
            t = cuda_ms(lambda: torch.autograd.grad(out, leaves, do,
                                                    retain_graph=True), 1)
        del out, leaves
        return t

    bwd_rows = {}
    for name, (B, H, KV, T, hd, window) in (
            ("qwen3-0.6b train, per node", (4, 16, 8, 2048, 128, None)),
            ("qwen3-0.6b train, global batch", (8, 16, 8, 2048, 128, None)),
            ("recurrentgemma-9b local", (HYBRID_PER_LENGTH, 16, 1,
                                         max(HYBRID_LENGTHS) - 1, 256,
                                         2048))):
        q, do = (torch.randn((B, T, H, hd), generator=g, device=dev)
                 for _ in range(2))
        k, v = (torch.randn((B, T, KV, hd), generator=g, device=dev)
                for _ in range(2))
        kw = dict(causal=True, window=window, q_offset=0, layout="bthd")
        what = f"flash_attention_bwd f32 {name} {(B, H, KV, T, hd, window)}"
        o, lse, errs, abs_err = bwd_check(q, k, v, do, torch.float32, what,
                                          **kw)
        ms = cuda_ms(lambda: kbwd.flash_attention_bwd_cuda(q, k, v, o, do,
                                                           lse, **kw), 3)
        plain = plain_bwd_ms(q, k, v, do, **kw)
        # the library yardstick, timed only: SDPA's f32 backward (causal, or
        # the causal window as a boolean mask), GQA over the kv heads
        qs, ks, vs, dos = (x.transpose(1, 2).contiguous().requires_grad_(
            x is not do) for x in (q, k, v, do))
        if window is None:
            out = sdpa(qs, ks, vs, is_causal=True, enable_gqa=True)
        else:
            pos = torch.arange(T, device=dev)
            band = (pos[None, :] <= pos[:, None]) \
                & (pos[:, None] - pos[None, :] < window)
            out = sdpa(qs, ks, vs, attn_mask=band, enable_gqa=True)
        lib = cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), dos,
                                                  retain_graph=True), 3)
        del out, qs, ks, vs, dos
        # the (q, k) pairs the causal (window) mask leaves: 5 products of
        # 2 hd FLOP each, 2.5 times the forward's
        flops = 2.5 * attn_flops(B, T, T, H, hd, causal=True, window=window)
        moved = 4 * (4 * q.numel() + 4 * k.numel() + lse.numel())
        bnd = f32_bounds(flops, moved)
        bwd_rows[name] = {"err": abs_err, "ms": ms, "plain_ms": plain,
                          "library_ms": lib, **bnd,
                          "of_bound": bnd["bound_ms"] / ms,
                          "library_over_kernel": lib / ms}
        print(f"[kernel] {what}: rel err dq {errs[0]:.2e} dk {errs[1]:.2e} "
              f"dv {errs[2]:.2e}, max |err| {abs_err:.3g}  kernel {ms:.3f} "
              f"ms ({flops / ms / 1e9:.1f} TFLOP/s)  plain (autograd of "
              f"flash_attention_plain, backward alone) {plain:.3f} ms  "
              f"scaled_dot_product_attention backward {lib:.3f} ms  "
              f"{bounds_text(bnd)} ({flops:.4g} FLOP, {moved / 1e9:.3f} GB)"
              f"; of the 3xTF32 bound {bnd['bound_ms'] / ms:.3f}, SDPA / "
              f"kernel {lib / ms:.3f}")
        del q, k, v, do, o, lse
        gc.collect()
        torch.cuda.empty_cache()
    bwd_top = bwd_rows["qwen3-0.6b train, per node"]   # the main path's shape
    # phase 12's shapes, forward and backward against the plain versions:
    # qwen3-0.6b in head_tp at tp 2 as phase 12 (a) launches it (a node's
    # 4 sequences x its 2 tp ranks folded into the batch, 8 q / 4 kv heads
    # a rank) and starcoder2-7b in cp at tp 8 as phase 12 (d) launches it
    # (a rank's 256-query chunk at its q_offset against the gathered 2048
    # keys, 36 q / 4 kv heads), ranks 1 and 7
    tp_shapes = set()
    for name, (B, H, KV, Tq, Tkv, qo) in (
            ("qwen3-0.6b head_tp, tp 2", (8, 8, 4, 2048, 2048, 0)),
            ("starcoder2-7b cp, tp 8, rank 1", (2, 36, 4, 256, 2048, 256)),
            ("starcoder2-7b cp, tp 8, rank 7", (2, 36, 4, 256, 2048, 1792))):
        q, do = (torch.randn((B, Tq, H, 128), generator=g, device=dev)
                 for _ in range(2))
        k, v = (torch.randn((B, Tkv, KV, 128), generator=g, device=dev)
                for _ in range(2))
        kw = dict(causal=True, window=None, q_offset=qo, layout="bthd")
        what = (f"flash_attention f32 {name}: q {tuple(q.shape)} k "
                f"{tuple(k.shape)} q_offset {qo}")
        fwd_err = check_flash(ops.flash_attention(q, k, v, **kw),
                              kflash.flash_attention_plain(q, k, v, **kw),
                              torch.float32, what)
        o, lse, errs, _ = bwd_check(q, k, v, do, torch.float32, what, **kw)
        fwd_ms = cuda_ms(lambda: kflash.flash_attention_cuda(q, k, v, **kw),
                         3)
        b_ms = cuda_ms(lambda: kbwd.flash_attention_bwd_cuda(
            q, k, v, o, do, lse, **kw), 3)
        tp_shapes.add((B, Tq, H, Tkv, KV, qo > 0))
        print(f"[kernel] {what}: forward max|err| {fwd_err:.3g} "
              f"{fwd_ms:.3f} ms; backward rel err dq {errs[0]:.2e} dk "
              f"{errs[1]:.2e} dv {errs[2]:.2e}, {b_ms:.3f} ms")
        del q, k, v, do, o, lse
    # granite-moe-3b-a800m's heads (24 q / 8 kv at hd 64: the 64-row kv
    # tiles, 32 streamed rows in the backward) at phase 15's shapes: the
    # training forward and backward as a 2x4 node's run launches them (4
    # folded sequences x 2048) and one 2016-token prompt's prefill; each
    # against its plain version, timed beside SDPA and the bound
    for name, (B, T, bwd) in (
            ("granite-moe-3b-a800m train, per node", (4, 2048, True)),
            ("granite-moe-3b-a800m prefill, one prompt", (1, 2016, False))):
        H, KV, hd = 24, 8, 64
        q, do = (torch.randn((B, T, H, hd), generator=g, device=dev)
                 for _ in range(2))
        k, v = (torch.randn((B, T, KV, hd), generator=g, device=dev)
                for _ in range(2))
        kw = dict(causal=True, window=None, q_offset=0, layout="bthd")
        what = f"flash_attention f32 {name} {(B, H, KV, T, hd)}"
        f_err = check_flash(ops.flash_attention(q, k, v, **kw),
                            kflash.flash_attention_plain(q, k, v, **kw),
                            torch.float32, what)
        f_ms = cuda_ms(lambda: kflash.flash_attention_cuda(q, k, v, **kw), 5)
        f_plain = cuda_ms(lambda: kflash.flash_attention_plain(q, k, v,
                                                               **kw), 3)
        qs, ks, vs, dos = (x.transpose(1, 2).contiguous().requires_grad_(
            x is not do) for x in (q, k, v, do))
        f_lib = cuda_ms(lambda: sdpa(qs.detach(), ks.detach(), vs.detach(),
                                     is_causal=True, enable_gqa=True), 5)
        flops = attn_flops(B, T, T, H, hd, causal=True, window=None)
        f_bnd = f32_bounds(flops, 4 * (2 * q.numel() + 2 * k.numel()))
        print(f"[kernel] {what}: max|err| {f_err:.3g}  kernel {f_ms:.3f} ms "
              f"({flops / f_ms / 1e9:.1f} TFLOP/s)  plain {f_plain:.3f} ms  "
              f"scaled_dot_product_attention {f_lib:.3f} ms  "
              f"{bounds_text(f_bnd)} ({flops:.4g} FLOP); of the 3xTF32 "
              f"bound {f_bnd['bound_ms'] / f_ms:.3f}, SDPA / kernel "
              f"{f_lib / f_ms:.3f}")
        if bwd:
            what = f"flash_attention_bwd f32 {name} {(B, H, KV, T, hd)}"
            o, lse, errs, abs_err = bwd_check(q, k, v, do, torch.float32,
                                              what, **kw)
            b_ms = cuda_ms(lambda: kbwd.flash_attention_bwd_cuda(
                q, k, v, o, do, lse, **kw), 3)
            b_plain = plain_bwd_ms(q, k, v, do, **kw)
            with torch.enable_grad():
                out = sdpa(qs, ks, vs, is_causal=True, enable_gqa=True)
                b_lib = cuda_ms(lambda: torch.autograd.grad(
                    out, (qs, ks, vs), dos, retain_graph=True), 3)
            del out
            moved = 4 * (4 * q.numel() + 4 * k.numel() + lse.numel())
            b_bnd = f32_bounds(2.5 * flops, moved)
            print(f"[kernel] {what}: rel err dq {errs[0]:.2e} dk "
                  f"{errs[1]:.2e} dv {errs[2]:.2e}, max |err| {abs_err:.3g}"
                  f"  kernel {b_ms:.3f} ms ({2.5 * flops / b_ms / 1e9:.1f} "
                  f"TFLOP/s)  plain (backward alone) {b_plain:.3f} ms  "
                  f"scaled_dot_product_attention backward {b_lib:.3f} ms  "
                  f"{bounds_text(b_bnd)} ({2.5 * flops:.4g} FLOP); of the "
                  f"3xTF32 bound {b_bnd['bound_ms'] / b_ms:.3f}, SDPA / "
                  f"kernel {b_lib / b_ms:.3f}")
            del o, lse
        del q, k, v, do, qs, ks, vs, dos
        gc.collect()
        torch.cuda.empty_cache()
    # internvl2-1b's heads (14 q / 2 kv at hd 64: a GQA group of 7) at
    # phase 17's training shapes: a 2x4 node's run (4 folded sequences x
    # 2048, every head) and a 2x(2x2) node's head_tp run (its 4 sequences
    # x 2 tp ranks folded into the batch, 7 q / 1 kv heads a rank); each
    # forward and backward against its plain version, timed beside SDPA
    # and the bound, with the backward's head split (a power of 2 capped
    # at the group: unequal shares of 7)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, (B, H, KV) in (
            ("internvl2-1b train, 2x4 node", (4, 14, 2)),
            ("internvl2-1b train, 2x(2x2) node, head_tp rank", (8, 7, 1))):
        T, hd = 2048, 64
        q, do = (torch.randn((B, T, H, hd), generator=g, device=dev)
                 for _ in range(2))
        k, v = (torch.randn((B, T, KV, hd), generator=g, device=dev)
                for _ in range(2))
        kw = dict(causal=True, window=None, q_offset=0, layout="bthd")
        splits = kbwd.head_splits(B, KV, T, hd, H // KV, sms)
        what = f"flash_attention f32 {name} {(B, H, KV, T, hd)}"
        f_err = check_flash(ops.flash_attention(q, k, v, **kw),
                            kflash.flash_attention_plain(q, k, v, **kw),
                            torch.float32, what)
        f_ms = cuda_ms(lambda: kflash.flash_attention_cuda(q, k, v, **kw), 5)
        f_plain = cuda_ms(lambda: kflash.flash_attention_plain(q, k, v,
                                                               **kw), 3)
        qs, ks, vs, dos = (x.transpose(1, 2).contiguous().requires_grad_(
            x is not do) for x in (q, k, v, do))
        f_lib = cuda_ms(lambda: sdpa(qs.detach(), ks.detach(), vs.detach(),
                                     is_causal=True, enable_gqa=True), 5)
        flops = attn_flops(B, T, T, H, hd, causal=True, window=None)
        f_bnd = f32_bounds(flops, 4 * (2 * q.numel() + 2 * k.numel()))
        print(f"[kernel] {what}: max|err| {f_err:.3g}  kernel {f_ms:.3f} ms "
              f"({flops / f_ms / 1e9:.1f} TFLOP/s)  plain {f_plain:.3f} ms  "
              f"scaled_dot_product_attention {f_lib:.3f} ms  "
              f"{bounds_text(f_bnd)} ({flops:.4g} FLOP); of the 3xTF32 "
              f"bound {f_bnd['bound_ms'] / f_ms:.3f}, SDPA / kernel "
              f"{f_lib / f_ms:.3f}")
        what = f"flash_attention_bwd f32 {name} {(B, H, KV, T, hd)}"
        o, lse, errs, abs_err = bwd_check(q, k, v, do, torch.float32, what,
                                          **kw)
        b_ms = cuda_ms(lambda: kbwd.flash_attention_bwd_cuda(
            q, k, v, o, do, lse, **kw), 3)
        b_plain = plain_bwd_ms(q, k, v, do, **kw)
        with torch.enable_grad():
            out = sdpa(qs, ks, vs, is_causal=True, enable_gqa=True)
            b_lib = cuda_ms(lambda: torch.autograd.grad(
                out, (qs, ks, vs), dos, retain_graph=True), 3)
        del out
        moved = 4 * (4 * q.numel() + 4 * k.numel() + lse.numel())
        b_bnd = f32_bounds(2.5 * flops, moved)
        print(f"[kernel] {what}: head_splits {splits} of a group of "
              f"{H // KV} (shares of {-(-(H // KV) // splits)}); rel err dq "
              f"{errs[0]:.2e} dk {errs[1]:.2e} dv {errs[2]:.2e}, max |err| "
              f"{abs_err:.3g}  kernel {b_ms:.3f} ms "
              f"({2.5 * flops / b_ms / 1e9:.1f} TFLOP/s)  plain (backward "
              f"alone) {b_plain:.3f} ms  scaled_dot_product_attention "
              f"backward {b_lib:.3f} ms  {bounds_text(b_bnd)} "
              f"({2.5 * flops:.4g} FLOP); of the 3xTF32 bound "
              f"{b_bnd['bound_ms'] / b_ms:.3f}, SDPA / kernel "
              f"{b_lib / b_ms:.3f}")
        del q, k, v, do, qs, ks, vs, dos, o, lse
        gc.collect()
        torch.cuda.empty_cache()
    # the backward's non-finite classes, as the forward's above, with dO too
    for B, H, KV, T, hd, window in ((1, 4, 2, 128, 64, None),
                                    (1, 8, 1, 200, 256, 16)):
        for where in ("q, k", "q, k, v", "q, k, do", "v, do near max"):
            q, k, v, do = (torch.randn((B, n_, T, hd), generator=g,
                                       device=dev) for n_ in (H, KV, KV, H))
            if where.startswith("q, k"):
                q[0, 1, 10, 3], q[0, 2, 70, 5] = special[0], special[3]
                k[0, 0, 20, 7], k[0, KV - 1, 40, 9] = special[1], special[4]
            if where == "q, k, v":
                v[0, KV - 1, 50, 11], v[0, 0, 30, 12] = special[0], special[2]
            if where == "q, k, do":
                do[0, 1, 60, 3], do[0, 0, 90, 4] = special[0], special[2]
            if where == "v, do near max":
                v[0, 0, 30, 12], do[0, 1, 60, 3] = special[3], special[4]
            o, lse = kflash.flash_attention_cuda(q, k, v, window=window,
                                                 return_lse=True)
            got = kbwd.flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                                window=window)
            want = kbwd.flash_attention_bwd_plain(q, k, v, do, window=window)
            counts = {}
            for name, a_, b_ in zip(("dq", "dk", "dv"), got, want):
                top = torch.where(torch.isfinite(b_), b_.abs(), 0).max()
                counts[name] = check_classes(
                    a_, b_, top, 2e-4,
                    f"flash_attention_bwd {name} T{T} hd{hd} {where}")
            print(f"[nonfinite] flash_attention_bwd f32 B{B} H{H} KV{KV} "
                  f"T{T} hd{hd} window={window}, specials in {where}: "
                  f"classes as the plain version's autograd {counts}")
    # finite operands whose dk overflows (ref.bwd_overflow_inputs): the fast
    # path's non-finite gradients are counted and recomputed on the exact
    # path, with the plain autograd's classes (at most 12 CTAs check their
    # outputs: 4 dq, up to 4 dk / dv and 4 of the partials' sum)
    kbwd.recomputes.reset()
    q, k, v, do = kref.bwd_overflow_inputs(g, dev)
    o, lse = kflash.flash_attention_cuda(q, k, v, return_lse=True)
    got = kbwd.flash_attention_bwd_cuda(q, k, v, o, do, lse)
    want = kbwd.flash_attention_bwd_plain(q, k, v, do)
    counts = {}
    for name, a_, b_ in zip(("dq", "dk", "dv"), got, want):
        top = torch.where(torch.isfinite(b_), b_.abs(), 0).max()
        counts[name] = check_classes(a_, b_, top, 2e-4,
                                     f"flash_attention_bwd overflow {name}")
    print(f"[nonfinite] flash_attention_bwd f32 B1 H4 KV2 T64 hd32, finite "
          f"operands whose dk overflows: classes as the plain version's "
          f"autograd {counts}, "
          + recomputed(kbwd, "flash_attention_bwd overflow", 12))
    del q, k, v, do, o, lse, got, want
    kflash.recomputes.reset()
    # ops.matmul's gradients come from the panel kernel's NT and TN
    # layouts, against autograd's f32 product; the q4 kernel has no
    # backward and refuses a grad-carrying call (no silent detach)
    x_ = torch.randn((2, 300, 200), generator=g, device=dev,
                     requires_grad=True)
    w_ = torch.randn((2, 200, 260), generator=g, device=dev,
                     requires_grad=True)
    gc_ = torch.randn((2, 300, 260), generator=g, device=dev)
    before = dict(kmatmul.launches_by_layout)
    got = torch.autograd.grad(ops.matmul(x_, w_), (x_, w_), gc_)
    by_layout = {k_: kmatmul.launches_by_layout[k_] - before[k_]
                 for k_ in kmatmul.LAYOUTS}
    want = torch.autograd.grad(torch.matmul(x_, w_), (x_, w_), gc_)
    rel = [((u - v).abs().max() / v.abs().max()).item()
           for u, v in zip(got, want)]
    if max(rel) > 1e-5 or by_layout != {"nn": 1, "nt": 1, "tn": 1}:
        raise AssertionError(f"ops.matmul backward: rel err {rel}, "
                             f"launches {by_layout}")
    try:
        ops.q4_matmul(x_[0], *quantize_q4(torch.ones((200, 8), device=dev),
                                          group=8), group=8)
    except NotImplementedError:
        pass
    else:
        raise AssertionError("ops.q4_matmul returned a result without a "
                             "gradient for an input that requires grad")
    print(f"[kernel] ops.matmul backward against autograd's f32 product: "
          f"rel err dA {rel[0]:.3g} dB {rel[1]:.3g}, launches {by_layout}; "
          f"ops.q4_matmul refuses a grad-carrying call (no backward kernel)")
    del x_, w_, gc_, got, want

    # lru_scan against its plain version: tests/test_kernels.py's shapes,
    # decays in U(0.5, 0.999) (the RG-LRU regime)
    def lru_inputs(shape, dtype):
        a = torch.rand(shape, generator=g, device=dev) * 0.499 + 0.5
        x = torch.randn(shape, generator=g, device=dev)
        return a.to(dtype), x.to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((1, 256, 128), (2, 512, 64), (1, 100, 48)):
            a, x = lru_inputs(shape, dtype)
            got = ops.lru_scan(a, x)
            torch.cuda.synchronize()
            err = check_lru(got, klru.lru_scan_plain(a, x), dtype,
                            f"lru_scan {dtype} {shape}")
            print(f"[kernel] lru_scan {str(dtype)[6:]:8s} {shape}: max|err| "
                  f"{err:.3g}")
    ones = torch.ones((1, 1000, 96), device=dev)
    err = (ops.lru_scan(ones, ones) - ones.cumsum(1)).abs().max().item()
    print(f"[kernel] lru_scan a = 1 carry over 1000 steps vs cumsum: "
          f"max|err| {err:.3g}")
    if err:
        raise AssertionError(f"lru_scan a = 1: max |err| {err} vs cumsum")
    # timed: one rglru layer's prefill at each of phase 9's prefill groups
    # (the main path's shapes), then 8 slots at 2048 tokens and a lone
    # 3072-token prompt (an exact-length bucket of one)
    C = get_config("recurrentgemma-9b").rnn_width
    main_shapes = [(HYBRID_PER_LENGTH, n - 1, C) for n in HYBRID_LENGTHS]
    lru_rows = []
    for B, T, C in main_shapes + [(8, 2048, C), (1, 3072, C)]:
        a, x = lru_inputs((B, T, C), torch.float32)
        got = ops.lru_scan(a, x)
        torch.cuda.synchronize()
        err = check_lru(got, klru.lru_scan_plain(a, x), torch.float32,
                        f"lru_scan ({B}, {T}, {C})")
        del got
        row = {"shape": (B, T, C), "err": err,
               "ms": cuda_ms(lambda: ops.lru_scan(a, x), 20),
               "plain_ms": cuda_ms(lambda: klru.lru_scan_plain(a, x), 2),
               "cumsum_ms": cuda_ms(lambda: torch.cumsum(x, 1), 20)}
        moved = 3.0 * B * T * C * 4          # a, x read once, h written
        row["bound_ms"], row["bound_by"] = bound(2.0 * B * T * C, moved,
                                                 "fma")
        print(f"[kernel] lru_scan f32 ({B}, {T}, {C}): max|err| {err:.3g}  "
              f"kernel {row['ms']:.3f} ms ({moved / row['ms'] / 1e6:.1f} "
              f"GB/s)  plain {row['plain_ms']:.3f} ms  bound "
              f"{row['bound_ms']:.3f} ms ({row['bound_by']}; "
              f"{moved / 1e9:.3f} GB)  library: none computes it (for "
              f"orientation only, the a = 1 case: torch.cumsum "
              f"{row['cumsum_ms']:.3f} ms)")
        lru_rows.append(row)
        del a, x
    lru_main = [r for r in lru_rows if r["shape"] in main_shapes]
    lru_main_ms = sum(r["ms"] for r in lru_main)
    lru_main_bound = sum(r["bound_ms"] for r in lru_main)
    print(f"[kernel] lru_scan over phase 9's prefill groups "
          f"{[r['shape'] for r in lru_main]}, one rglru layer each: kernel "
          f"{lru_main_ms:.3f} ms  bound {lru_main_bound:.3f} ms "
          f"({lru_main_bound / lru_main_ms:.2f} of bound)")
    lru_top = lru_main[-1]         # the largest main-path launch

    # the lru_scan backward kernel against its plain version (the reverse
    # scan dx = g, da = g h_{t-1}; f32 2e-4, bf16 5e-2 of the largest
    # gradient): tests/test_kernels.py's shapes, ragged T and C not a
    # multiple of the 64-channel block, then at the training shape as phase
    # 18 launches it (a 1x4 node's 4 folded sequences x 2048, d_rnn 4096)
    # and at phase 9's prefill groups, timed beside the plain version, the
    # a = 1 case (a reversed cumsum) and the bound
    def lru_bwd_check(shape, dtype, what):
        a, x = lru_inputs(shape, dtype)
        h = ops.lru_scan(a, x)
        gh = torch.randn(shape, generator=g, device=dev).to(dtype)
        got = klrub.lru_scan_bwd_cuda(a, h, gh)
        torch.cuda.synchronize()
        want = klrub.lru_scan_bwd_plain(a, h, gh)
        tol = 2e-4 if dtype == torch.float32 else 5e-2
        errs, abs_err = [], 0.0
        for name, u, w in zip(("dx", "da"), got, want):
            diff = (u.float() - w.float()).abs().max().item()
            e = diff / w.float().abs().max().item()
            if not (e <= tol and torch.isfinite(u).all()
                    and u.dtype == w.dtype and u.shape == w.shape):
                raise AssertionError(f"{what}: {name} rel err {e} > {tol}")
            errs.append(e)
            abs_err = max(abs_err, diff)
        return a, h, gh, errs, abs_err

    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((1, 256, 128), (2, 512, 64), (1, 100, 48),
                      (2, 129, 70), (3, 1000, 200)):
            what = f"lru_scan_bwd {str(dtype)[6:]} {shape}"
            errs = lru_bwd_check(shape, dtype, what)[3]
            print(f"[kernel] {what}: rel err dx {errs[0]:.2e} da "
                  f"{errs[1]:.2e}")
    ones = torch.ones((1, 1000, 96), device=dev)
    dx_, da_ = klrub.lru_scan_bwd_cuda(ones, ops.lru_scan(ones, ones), ones)
    err = (dx_ - ones.flip(1).cumsum(1).flip(1)).abs().max().item()
    if err or da_[:, 0].abs().max().item():
        raise AssertionError(f"lru_scan_bwd a = 1: max |err| {err} vs the "
                             "reversed cumsum")
    print("[kernel] lru_scan_bwd a = 1 carry over 1000 steps vs the "
          "reversed cumsum: max|err| 0, da at t = 0 is 0")
    # ops.lru_scan with grad: the forward kernel, then the backward kernel
    a, x = (t.requires_grad_(True) for t in lru_inputs((2, 300, 70),
                                                       torch.float32))
    before = (klru.launches, klrub.launches)
    h = ops.lru_scan(a, x)
    gh = torch.randn(h.shape, generator=g, device=dev)
    da_, dx_ = torch.autograd.grad(h, (a, x), gh)
    if (klru.launches - before[0], klrub.launches - before[1]) != (1, 1):
        raise AssertionError("ops.lru_scan with grad did not launch the "
                             "forward and backward kernels once each")
    want = klrub.lru_scan_bwd_plain(a.detach(), h.detach(), gh)
    for u, w in zip((dx_, da_), want):
        if not (u - w).abs().max().item() <= 2e-4 * w.abs().max().item():
            raise AssertionError("ops.lru_scan's gradient differs from "
                                 "lru_scan_bwd_plain")
    print("[kernel] ops.lru_scan with grad: one lru_scan and one "
          "lru_scan_bwd launch, gradients as lru_scan_bwd_plain's")
    del a, x, h, gh, da_, dx_, ones
    bwd_lru_rows = {}
    for B, T, C in [(4, 2048, C)] + main_shapes:
        what = f"lru_scan_bwd f32 ({B}, {T}, {C})"
        a, h, gh, errs, abs_err = lru_bwd_check((B, T, C), torch.float32,
                                                what)
        row = {"err": abs_err,
               "ms": cuda_ms(lambda: klrub.lru_scan_bwd_cuda(a, h, gh), 20),
               "plain_ms": cuda_ms(
                   lambda: klrub.lru_scan_bwd_plain(a, h, gh), 2),
               "cumsum_ms": cuda_ms(
                   lambda: torch.cumsum(gh.flip(1), 1), 20)}
        moved = 5.0 * B * T * C * 4     # a, h, gh read once; dx, da written
        row["bound_ms"], row["bound_by"] = bound(3.0 * B * T * C, moved,
                                                 "fma")
        print(f"[kernel] {what}: rel err dx {errs[0]:.2e} da {errs[1]:.2e}"
              f", max|err| {abs_err:.3g}  kernel {row['ms']:.3f} ms "
              f"({moved / row['ms'] / 1e6:.1f} GB/s, "
              f"{row['bound_ms'] / row['ms']:.2f} of the bound)  plain "
              f"{row['plain_ms']:.3f} ms  bound {row['bound_ms']:.3f} ms "
              f"({row['bound_by']}; {moved / 1e9:.3f} GB)  library: none "
              f"computes it (for orientation only, the a = 1 case: "
              f"torch.cumsum of the flipped gh {row['cumsum_ms']:.3f} ms)")
        bwd_lru_rows[(B, T, C)] = row
        del a, h, gh
    lrub_top = bwd_lru_rows[(4, 2048, C)]    # phase 18's launch shape
    print(f"[phase] kernel {time.perf_counter() - t_phase:.1f} s")

    # -- main path: zero the counts, drive phases 3-7, read them -----------------
    kmatmul.launches = 0
    kquant.launches = 0
    for m_ in (kmatmul, kquant, kflash, kbwd):    # read after phase 11
        m_.recomputes.reset()

    # -- 3. collectives over the topology matrix --------------------------------
    t_phase = time.perf_counter()
    for vc in default_matrix(device=dev):
        rows = traffic.check_matrix(vc, elems=2 ** 20)
        ratios = traffic.c1_ratios(rows)
        for fam in ("allgather", "broadcast", "psum"):
            if vc.chips > 1 and ratios[(vc.label, fam)] != vc.chips:
                raise AssertionError(f"C1 {vc.label}/{fam}: naive/shared "
                                     f"{ratios[(vc.label, fam)]} != "
                                     f"{vc.chips}")
        ag = {r.scheme: r.node_bytes for r in rows
              if r.family == "allgather"}
        print(f"[collectives] {vc.label}: {len(rows)} cases agree, traffic "
              f"== links(); allgather result bytes/node naive "
              f"{ag['naive']:.0f} shared {ag['shared']:.0f} (ratio "
              f"{ratios[(vc.label, 'allgather')]:g})")
    torch.cuda.synchronize()
    print(f"[phase] collectives {time.perf_counter() - t_phase:.1f} s")

    # -- 4. SUMMA -----------------------------------------------------------------
    t_phase = time.perf_counter()
    n = 16384
    A = torch.randn((n, n), generator=g, device=dev)
    Bm = torch.randn((n, n), generator=g, device=dev)
    want = torch.matmul(A, Bm)
    scale = want.abs().max()
    resolved = summa.tuning.resolve_for(
        summa.ROW_COMM, "psum", elems=(n // summa.NODES) * (n // summa.CORES))
    for scheme in summa.SCHEMES:
        before = kmatmul.launches
        got = summa.summa(A, Bm, scheme=scheme, use_kernel=True, chunks=2)
        rel = ((got - want).abs().max() / scale).item()
        grew = kmatmul.launches - before
        del got
        torch.cuda.synchronize()        # the second run is the timed one
        t0 = time.perf_counter()
        summa.summa(A, Bm, scheme=scheme, use_kernel=True, chunks=2)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        print(f"[summa] {scheme:9s}: {ms:9.1f} ms  rel_err={rel:.2e}  "
              f"kernel launches {grew}  "
              f"{summa.traffic_line(scheme, n, resolved.scheme)}")
        if not rel <= 1e-5:
            raise AssertionError(f"SUMMA {scheme}: rel_err {rel} > 1e-5")
        if grew <= 0:
            raise AssertionError(f"SUMMA {scheme}: the kernel never ran")
        copies = summa.round_traffic(scheme, n, resolved.scheme).fast_bytes
        if scheme in ("hybrid", "pipelined") and copies:
            raise AssertionError(f"SUMMA {scheme}: {copies} intra-node "
                                 "copy bytes per round, expected 0")
    del A, Bm, want
    print(f"[phase] summa {time.perf_counter() - t_phase:.1f} s")

    # -- 5. BPMF ------------------------------------------------------------------
    t_phase = time.perf_counter()
    r_obs, mask, r, test = bpmf.synthetic(6040, 3704, 0.045, 0, dev)
    base = bpmf.rmse(torch.zeros_like(r), r, test)
    preds = {}
    for scheme in bpmf.SCHEMES:
        preds[scheme] = bpmf.bpmf(r_obs, mask, scheme, iters=10, seed=0)
        torch.cuda.synchronize()        # the second run is the timed one
        t0 = time.perf_counter()
        again = bpmf.bpmf(r_obs, mask, scheme, iters=10, seed=0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        err = bpmf.rmse(preds[scheme], r, test)
        print(f"[bpmf] {scheme:6s}: {ms:9.1f} ms  RMSE {err:.4f} "
              f"(zero predictor {base:.4f})")
        if not err < base or not torch.isfinite(preds[scheme]).all():
            raise AssertionError(f"BPMF {scheme}: RMSE {err} not below "
                                 f"the baseline {base}")
        if not torch.equal(again, preds[scheme]):
            raise AssertionError(f"BPMF {scheme}: a rerun with the same "
                                 "seed gave other predictions")
        del again
    if not torch.equal(preds["naive"], preds["hybrid"]):
        raise AssertionError("BPMF: naive and hybrid predictions differ")
    print(f"[phase] bpmf {time.perf_counter() - t_phase:.1f} s")

    # -- 6. lossy collectives over the topology matrix ---------------------------
    t_phase = time.perf_counter()
    for vc in default_matrix(device=dev):
        rows = traffic.check_lossy(vc, elems=2 ** 20)
        for r in rows:
            print(f"[lossy] {vc.label} {r.family}/{r.scheme}{r.opts or ''}: "
                  f"slow-tier bytes {r.slow_bytes:.0f} ({r.parent} "
                  f"{r.parent_slow:.0f})  max|err| {r.error:.4g} <= bound "
                  f"{r.bound:.4g}"
                  + ("  own pod region exact" if r.own_region_exact else "")
                  + f"  result bytes/node {r.node_bytes:.0f}")
        if not rows:
            raise AssertionError(f"lossy {vc.label}: nothing ran")
    torch.cuda.synchronize()
    print(f"[phase] lossy collectives {time.perf_counter() - t_phase:.1f} s")

    # -- 7. lossy ag_matmul at mistral-nemo-12b width ------------------------------
    # the MLP down-projection w_out (src/repro/models/layers.py:210) of
    # src/repro/configs/mistral_nemo_12b.py: K = d_ff, N = d_model
    t_phase = time.perf_counter()
    d_model, d_ff, tokens, n_chunks = 5120, 14336, 2048, 2
    vc = VirtualCluster(pods=1, chips=8, device=dev)
    comm = Communicator.from_cluster(vc)
    w = torch.randn((d_ff, d_model), generator=g, device=dev)
    x = torch.randn((vc.num_devices, tokens, d_ff), generator=g, device=dev)
    w_shard = w.reshape(vc.chips, d_ff // vc.chips, d_model)
    want = torch.matmul(x, dequantize_q4(*quantize_q4(w, group=32),
                                         group=32))
    del w
    times, gathered = {}, {}
    with vc.bind():
        for precision in ("lossy", "exact"):
            def run(precision=precision):
                return comm.ag_matmul(x, w_shard, n_chunks=n_chunks,
                                      use_kernel=True, precision=precision,
                                      q4_group=32)
            before = kquant.launches
            with recording() as rec:
                got = run()
            torch.cuda.synchronize()
            if precision == "lossy":
                grew = kquant.launches - before
                rel = ((got - want).abs().max()
                       / want.abs().max()).item()
                if not rel <= 1e-5 or not torch.isfinite(got).all():
                    raise AssertionError(f"lossy ag_matmul: rel_err {rel} "
                                         "> 1e-5")
                if grew <= 0:
                    raise AssertionError("lossy ag_matmul never launched "
                                         "the q4 kernel")
            del got
            t0 = time.perf_counter()        # the second run is the timed one
            run()
            torch.cuda.synchronize()
            times[precision] = (time.perf_counter() - t0) * 1e3
            gathered[precision] = sum(r.out_bytes for r in rec) / n_chunks
    print(f"[ag_matmul] mistral-nemo-12b w_out on 1x8 ({tokens} tokens/rank, "
          f"K {d_ff}, N {d_model}, {n_chunks} chunks, group 32): lossy "
          f"{times['lossy']:.1f} ms  rel_err={rel:.2e}  q4 launches {grew}  "
          f"exact {times['exact']:.1f} ms;  gathered bytes/rank/chunk: "
          f"packed+scales {gathered['lossy']:.0f}  f32 "
          f"{gathered['exact']:.0f}")
    del x, w_shard, want
    print(f"[phase] ag_matmul {time.perf_counter() - t_phase:.1f} s")
    launches = {"matmul": kmatmul.launches, "q4_matmul": kquant.launches}

    # -- 10. collectives bench (while the card holds no model) -----------------
    t_phase = time.perf_counter()
    kmatmul.launches = 0            # the bench phase's own path
    cfg = get_config("qwen3-0.6b")
    tree = {}                       # the stacked per-layer parameter tree
    meta.map_defs(lambda path, m: tree.setdefault(
        "/".join(path), (cfg.n_units,) + m.shape) if path[0] == "units"
        else None, meta.model_defs(cfg, 1, 1, "hier"))
    collectives_bench(dev, g, sweep_elems=suites.QUICK_ELEMS, elems=2 ** 20,
                      big=2 ** 22, mm=4096, tree=tree,
                      table_path=str(tuning.default_table_path()))
    if kmatmul.launches <= 0:
        raise AssertionError("the bench phase never launched the panel "
                             "kernel")
    launches["matmul"] += kmatmul.launches
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[phase] collectives bench {time.perf_counter() - t_phase:.1f} s")

    # -- 8. serve qwen3-0.6b at full width --------------------------------------
    t_phase = time.perf_counter()
    cfg = get_config("qwen3-0.6b")
    ctx = ParallelCtx.single()
    model = build(cfg, ctx, device=dev)
    t0 = time.perf_counter()
    params = model.init_params(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _tensors(params))
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} q / {cfg.n_kv} kv heads x {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab} (padded {cfg.vocab_padded}); "
          f"{n_params} params f32 drawn on the card in "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    SLOTS, S_MAX, N_REQ, MAX_NEW = 8, 4096, 32, 32
    lm = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=2048,
                                global_batch=N_REQ, seed=0))
    tokens = lm.next_batch()["tokens"]
    lengths = np.random.default_rng(0).integers(64, 2049, size=N_REQ)
    prompts = [tokens[i, :lengths[i]].astype(np.int32)
               for i in range(N_REQ)]
    mem0 = traffic.device_bytes(dev)
    rec = StreamRecorder(model)
    tuner = LiveTuner(min_count=1)
    sched = ContinuousBatchingScheduler(model, params, slots=SLOTS,
                                        s_max=S_MAX, decode_fn=rec.decode_fn,
                                        tuner=tuner)
    rec.sched = sched
    page_bytes = traffic.device_bytes(dev) - mem0
    c1 = sched.pages.assert_c1()
    if page_bytes != c1["logical_bytes"]:
        raise AssertionError(f"KV pages: {page_bytes} device bytes "
                             f"allocated vs {c1['logical_bytes']} for one "
                             "copy")
    print(f"[serve] KV pages: {c1} (device bytes allocated {page_bytes})")
    kflash.launches = 0            # main path 2: the serving run
    rids, elapsed, done_at = run_closed_batch(sched, prompts, MAX_NEW)
    flash_launches = {"qwen3-0.6b": kflash.launches}
    by_bucket = report_serving(sched, prompts, lengths, elapsed, done_at,
                               cfg, slots=SLOTS, s_max=S_MAX,
                               max_new=MAX_NEW)
    key = sched._tuner_key
    ewma = tuner.estimate("serving", tuning.topo_signature(1, 1), "float32",
                          key["nbytes"], key["scheme"])
    print(f"[serve] live tuner: serving/{key['scheme']} EWMA {ewma:.0f} us "
          f"over {len(sched.stats)} decode steps; overlay has "
          f"{len(tuner.overlay().entries)} entries")
    print(f"[serve] flash_attention launches in the serving run: "
          f"{flash_launches['qwen3-0.6b']} "
          f"({sum(len(v_) for v_ in by_bucket.values())} prefills x "
          f"{cfg.n_layers} layers)")

    # (b) streams against each request's solo greedy_generate run
    check_streams(model, params, sched, rec, prompts, rids[:4],
                  max_new=MAX_NEW, s_max=S_MAX)

    # (c) the first 2 units: a 2048-token prefill on the card vs the CPU
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    p2 = {k_: v_ for k_, v_ in params.items() if k_ != "units"}
    p2["units"] = _map(lambda a: a[:2], params["units"])
    batch = {"tokens": torch.from_numpy(tokens[:1, :2049].astype(np.int32))}
    before = kflash.launches
    m_g, m_c = build(cfg2, ctx, device=dev), build(cfg2, ctx, device="cpu")
    p2_c = _map(lambda a: a.cpu(), p2)
    cache_g, logits_g = m_g.prefill_fn(p2, batch, 2048 + 2)  # room to decode
    card_launches = kflash.launches - before
    t0 = time.perf_counter()
    cache_c, logits_c = m_c.prefill_fn(p2_c, batch, 2048 + 2)
    cpu_s = time.perf_counter() - t0
    rel = ((logits_g.cpu() - logits_c).abs().max()
           / logits_c.abs().max()).item()
    k_rel = ((cache_g["units"]["b0"]["k"].cpu() - cache_c["units"]["b0"]["k"])
             .abs().max() / cache_c["units"]["b0"]["k"].abs().max()).item()
    print(f"[serve] 2-unit prefill of 2048 tokens, card (flash kernel, "
          f"{card_launches} launches) vs CPU (plain, {cpu_s:.1f} s): "
          f"last-token logits rel_err {rel:.2e}, k cache rel_err {k_rel:.2e}")
    if not rel <= 1e-4 or not torch.isfinite(logits_g).all() \
            or logits_g.shape != (1, 1, cfg.vocab_padded):
        raise AssertionError(f"card vs CPU prefill: rel_err {rel} > 1e-4")
    errs = decode_both(m_g, m_c, p2, p2_c, cache_g, cache_c, logits_g, 2048,
                       [])
    print(f"[serve] 2 decode steps from those caches, card vs CPU: rel_err "
          + ", ".join(f"{k_} {v_:.2e}" for k_, v_ in errs.items()))
    del sched, rec, params, p2, p2_c, cache_g, cache_c, model, m_g, m_c
    print(f"[phase] serve {time.perf_counter() - t_phase:.1f} s")

    # -- 9. serve recurrentgemma-9b at full width ------------------------------
    t_phase = time.perf_counter()
    gc.collect()                   # the scheduler <-> recorder cycle
    torch.cuda.empty_cache()
    mem0 = traffic.device_bytes(dev)
    cfg = get_config("recurrentgemma-9b")
    model = build(cfg, ctx, device=dev)
    t0 = time.perf_counter()
    params = model.init_params(0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _tensors(params))
    mem1 = traffic.device_bytes(dev)
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers ({' '.join(cfg.pattern)}"
          f" x {cfg.n_units} + {' '.join(cfg.remainder_kinds)}), d "
          f"{cfg.d_model}, {cfg.n_heads} q / {cfg.n_kv} kv heads x "
          f"{cfg.head_dim}, window {cfg.window}, d_rnn {cfg.rnn_width}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}; {n_params} params f32 drawn on "
          f"the card in {(time.perf_counter() - t0) * 1e3:.1f} ms; device "
          f"bytes allocated {mem0} before, {mem1} after")
    SLOTS, S_MAX, MAX_NEW = 8, 4096, 32
    lengths = np.random.default_rng(0).permutation(
        np.repeat(HYBRID_LENGTHS, HYBRID_PER_LENGTH))
    lm = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=int(lengths.max()),
                                global_batch=lengths.size, seed=0))
    tokens = lm.next_batch()["tokens"]
    prompts = [tokens[i, :lengths[i]].astype(np.int32)
               for i in range(lengths.size)]
    mem0 = traffic.device_bytes(dev)
    rec = StreamRecorder(model)
    sched = ContinuousBatchingScheduler(model, params, slots=SLOTS,
                                        s_max=S_MAX, decode_fn=rec.decode_fn)
    rec.sched = sched
    page_bytes = traffic.device_bytes(dev) - mem0
    c1 = sched.pages.assert_c1()
    if page_bytes != c1["logical_bytes"]:
        raise AssertionError(f"pages: {page_bytes} device bytes allocated "
                             f"vs {c1['logical_bytes']} for one copy")
    leaf_bytes = {}
    for tree in sched.pages.cache.values():
        for blk in tree.values():
            for n, a in blk.items():
                leaf_bytes[n] = leaf_bytes.get(n, 0) + a.nbytes
    print(f"[serve] pages: {c1} (device bytes allocated {page_bytes}; by "
          f"leaf {leaf_bytes})")
    klru.launches = 0              # main path 3: the hybrid serving run
    kflash.launches = 0
    rids, elapsed, done_at = run_closed_batch(sched, prompts, MAX_NEW)
    launches["lru_scan"] = klru.launches
    flash_launches[cfg.name] = kflash.launches
    by_bucket = report_serving(sched, prompts, lengths, elapsed, done_at,
                               cfg, slots=SLOTS, s_max=S_MAX,
                               max_new=MAX_NEW)
    n_groups = sum(len(v_) for v_ in by_bucket.values())
    groups = {tb: [n for n, _ in v_] for tb, v_ in by_bucket.items()}
    if groups != {n - 1: [HYBRID_PER_LENGTH] for n in HYBRID_LENGTHS}:
        raise AssertionError(f"the hybrid serving run's prefill groups "
                             f"{groups} are not the shapes phase 2 timed")
    kinds = cfg.block_kinds
    print(f"[serve] launches in the serving run: lru_scan "
          f"{launches['lru_scan']}, flash_attention "
          f"{flash_launches[cfg.name]} ({n_groups} prefill groups x "
          f"{kinds.count('rglru')} rglru / {kinds.count('local')} local "
          f"layers)")
    if launches["lru_scan"] != kinds.count("rglru") * n_groups \
            or flash_launches[cfg.name] != kinds.count("local") * n_groups:
        raise AssertionError("the hybrid serving run's launches do not "
                             "match its prefill groups")

    # (b) streams against each request's solo greedy_generate run
    check_streams(model, params, sched, rec, prompts, rids[:4],
                  max_new=MAX_NEW, s_max=S_MAX)

    # (c) one pattern unit (rglru, rglru, local): a prefill past the
    # window on the card vs the CPU
    T3 = 2304
    cfg3 = dataclasses.replace(cfg, n_layers=len(cfg.pattern))
    p3 = {k_: v_ for k_, v_ in params.items() if k_ != "units"}
    p3["units"] = _map(lambda a: a[:1], params["units"])
    batch = {"tokens": torch.from_numpy(tokens[:1, :T3 + 1].astype(
        np.int32))}
    before = (klru.launches, kflash.launches)
    m_g, m_c = build(cfg3, ctx, device=dev), build(cfg3, ctx, device="cpu")
    p3_c = _map(lambda a: a.cpu(), p3)
    cache_g, logits_g = m_g.prefill_fn(p3, batch, T3 + 2)  # room to decode
    card_launches = (klru.launches - before[0], kflash.launches - before[1])
    t0 = time.perf_counter()
    cache_c, logits_c = m_c.prefill_fn(p3_c, batch, T3 + 2)
    cpu_s = time.perf_counter() - t0
    u_g, u_c = cache_g["units"], cache_c["units"]
    errs = {"logits": rel_err(logits_g, logits_c),
            "h b0": rel_err(u_g["b0"]["h"], u_c["b0"]["h"]),
            "h b1": rel_err(u_g["b1"]["h"], u_c["b1"]["h"]),
            "ring k b2": rel_err(u_g["b2"]["k"], u_c["b2"]["k"])}
    print(f"[serve] 1-unit prefill of {T3} tokens (window {cfg.window}), "
          f"card (kernels: {card_launches[0]} lru_scan, {card_launches[1]} "
          f"flash launches) vs CPU (plain, {cpu_s:.1f} s): rel_err "
          + ", ".join(f"{k_} {v_:.2e}" for k_, v_ in errs.items()))
    if not max(errs.values()) <= 1e-4 or not torch.isfinite(logits_g).all() \
            or logits_g.shape != (1, 1, cfg.vocab_padded) \
            or card_launches != (2, 1):
        raise AssertionError(f"card vs CPU unit prefill: {errs}, launches "
                             f"{card_launches}")
    errs = decode_both(m_g, m_c, p3, p3_c, cache_g, cache_c, logits_g, T3,
                       [f"{b_} {n_}" for b_ in ("b0", "b1")
                        for n_ in ("h", "conv")])
    print(f"[serve] 2 decode steps from those caches, card vs CPU: rel_err "
          + ", ".join(f"{k_} {v_:.2e}" for k_, v_ in errs.items()))
    del sched, rec, params, p3, p3_c, cache_g, cache_c, model, m_g, m_c
    print(f"[phase] serve hybrid {time.perf_counter() - t_phase:.1f} s")
    launches["flash_attention"] = sum(flash_launches.values())

    # -- 11. training: qwen3-0.6b's cluster train step ---------------------------
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    tcfg = get_config("qwen3-0.6b")

    def train_setup(cfg, vc, mode, params, opts=()):
        """The bundle and its laid-out state from global ``params``, with
        the device bytes of params / m / v as the card's allocator reports
        them (``traffic.device_bytes``)."""
        bundle = make_cluster_train_step(cfg, vc, mode=mode, lr=3e-4,
                                         clip=1.0, global_batch=8,
                                         opts=opts)
        specs = bundle.state_specs
        on_card = vc.device.type == "cuda"
        mem = (lambda: traffic.device_bytes(dev)) if on_card \
            else (lambda: 0)
        if on_card:
            torch.cuda.synchronize()
        nbytes, state = {}, {}
        for grp in ("params", "m", "v"):
            base = mem()
            state[grp] = vc.layout(params, specs["params"]) \
                if grp == "params" else _map(torch.zeros_like,
                                             state["params"])
            nbytes[grp] = mem() - base
        state["step"] = vc.layout(torch.zeros((), dtype=torch.int32),
                                  specs["step"])
        return bundle, state, nbytes

    def train_batches(cfg, T, n):
        stream = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=T,
                                        global_batch=8, seed=7))
        return [stream.next_batch() for _ in range(n)]

    def run_steps(bundle, state, batches, what):
        rows = []
        for i, batch in enumerate(batches):
            laid = bundle.layout_batch(batch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, mt = bundle.step(state, laid)
            loss, gnorm = float(mt["loss"][0]), float(mt["gnorm"][0])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            tokens = batch["tokens"].shape[0] * (batch["tokens"].shape[1]
                                                 - 1)
            if not (np.isfinite(loss) and np.isfinite(gnorm)):
                raise AssertionError(f"{what}: step {i + 1} loss {loss} "
                                     f"gnorm {gnorm}")
            print(f"[train] {what} step {i + 1}: loss {loss:.6f} gnorm "
                  f"{gnorm:.6f} step {ms:.1f} ms "
                  f"{tokens / ms * 1e3:.1f} tokens/s")
            rows.append({"loss": loss, "gnorm": gnorm, "ms": ms})
        return state, rows

    def close(got, want, rtol, atol, what):
        got, want = got.to(want.device).float(), want.float()
        bad = ((got - want).abs() > atol + rtol * want.abs()).sum().item()
        if bad:
            raise AssertionError(f"{what}: {bad} of {want.numel()} elements "
                                 f"outside rtol {rtol} atol {atol}")

    # (a) the main path: full width and depth, hier on 2x4, 8 x 2048
    vc = VirtualCluster(pods=2, chips=4, device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    model_defs = meta.model_defs(tcfg, 1, 1, "hier")
    params = meta.init_params(model_defs, tcfg, gen, dev)
    bundle, state, nbytes = train_setup(tcfg, vc, "hier", params)
    del params
    batches = train_batches(tcfg, 2048, 3)
    kflash.launches = kbwd.launches = kmatmul.launches = 0
    kmatmul.launches_by_layout.update(dict.fromkeys(kmatmul.LAYOUTS, 0))
    state, rows = run_steps(bundle, state, batches,
                            "qwen3-0.6b full depth hier 2x4 8x2048")
    train_launches = {"flash_attention (forward)": kflash.launches,
                      "flash_attention_bwd": kbwd.launches,
                      **{f"matmul {k_}": v_ for k_, v_ in
                         kmatmul.launches_by_layout.items()}}
    # every f32 product of the step on the panel kernel: per node run, 28
    # layers x 5 products x (forward, remat forward, dX, dW), and 4 per
    # cross-entropy chunk (512 tokens a rank, the 4 ranks folded: 4 chunks
    # of 2048 rows), two node runs a step
    want_mm = {f"matmul {k_}": v_ * len(rows)
               for k_, v_ in (("nn", 576), ("nt", 288), ("tn", 288))}
    got_mm = {k_: train_launches[k_] for k_ in want_mm}
    if got_mm != want_mm or kmatmul.launches != sum(want_mm.values()):
        raise AssertionError(f"panel matmul launches in the training run "
                             f"{got_mm} (all {kmatmul.launches}), want "
                             f"{want_mm}")
    nbytes["grads"] = bundle.stats["grad_bytes"]
    print(f"[train] training state on the card (2 node copies): "
          + ", ".join(f"{k_} {v_ / 1e9:.3f} GB" for k_, v_ in nbytes.items())
          + f", total {sum(nbytes.values()) / 1e9:.3f} GB; peak allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.1f} GB")
    print(f"[train] launches in the training run ({len(rows)} steps): "
          + ", ".join(f"{k_} {v_}" for k_, v_ in train_launches.items())
          + " (matmul: NN 576, NT 288, TN 288 a step)")
    for k_, v_ in train_launches.items():
        if v_ <= 0:
            raise AssertionError(f"the training run never launched {k_}")
    train_row = {"ms": sum(r["ms"] for r in rows[1:]) / (len(rows) - 1),
                 "tokens": 8 * 2048}
    train_rows = rows
    # the dry run of the same step (launch.dryrun.trace_cell on meta
    # tensors: the same config, cluster, shape, mode and dtype) beside it:
    # its roofline terms, per rank; the card runs all 8 ranks, so the
    # step's least compute time here is 8 ranks' compute terms
    t_dr = time.perf_counter()
    dr = dryrun.trace_cell(tcfg, ShapeSpec("train_2k", 2048, 8, "train"),
                           VirtualCluster(pods=2, chips=4, device="meta"),
                           mode="hier", compute_dtype=torch.float32)
    r_, R_ = dr["roofline"], dr["cost"]["ranks"]
    dr_calls = {k_: v_["calls"] for k_, v_ in dr["cost"]["kernels"].items()}
    card_ms = r_["compute_s"] * R_ * 1e3
    routes = {k_: float(f"{v_ / R_:.4g}")
              for k_, v_ in dr["cost"]["flops_by_route"].items()}
    print(f"[train] dry run of the same step (launch.dryrun.trace_cell on "
          f"meta, {time.perf_counter() - t_dr:.1f} s; H100 constants of "
          f"analysis.roofline): per rank {r_['hlo_flops']:.4g} FLOP (by "
          f"route {routes}), {r_['hlo_bytes'] / 1e9:.2f} GB; terms compute "
          f"{r_['compute_s'] * 1e3:.1f} ms, memory "
          f"{r_['memory_s'] * 1e3:.1f} ms, collective "
          f"{r_['collective_s'] * 1e3:.1f} ms (NVLink 4 "
          f"{r_['fast_coll_s'] * 1e3:.1f}, NDR {r_['slow_coll_s'] * 1e3:.1f}"
          f"), dominant {r_['dominant']}, useful FLOP "
          f"{r_['useful_flops_ratio']:.3f}; kernel calls a step {dr_calls}; "
          f"on one card the 8 ranks' compute term is {card_ms:.1f} ms, "
          f"{card_ms / train_row['ms']:.3f} of the measured "
          f"{train_row['ms']:.1f} ms step")
    for k_, v_ in (("flash_attention", "flash_attention (forward)"),
                   ("flash_attention_bwd", "flash_attention_bwd")):
        if dr_calls[k_] * len(rows) != train_launches[v_]:
            raise AssertionError(f"the dry run counts {dr_calls[k_]} {k_} "
                                 f"calls a step; the card launched "
                                 f"{train_launches[v_]} in {len(rows)}")
    del bundle, state, batches
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the paper's comparison: hier against naive, 2 layers (naive's 8
    # replicas of the full depth would need ~96 GB), same params and
    # tokens, 2 steps
    cfg2 = dataclasses.replace(tcfg, n_layers=2)
    params = meta.init_params(meta.model_defs(cfg2, 1, 1, "hier"), cfg2,
                              torch.Generator(device=dev).manual_seed(12),
                              dev)
    batches = train_batches(cfg2, 2048, 2)
    out = {}
    for mode in ("hier", "naive"):
        bundle, state, nb = train_setup(cfg2, vc, mode, params)
        state, rows = run_steps(bundle, state, batches,
                                f"qwen3-0.6b 2 layers {mode} 2x4 8x2048")
        nb["grads"] = bundle.stats["grad_bytes"]
        glob = bundle.unlayout_state(state)
        out[mode] = {"rows": rows, "bytes": nb,
                     "state": _map(lambda t: t.cpu(), {
                         g_: glob[g_] for g_ in ("params", "m", "v")})}
        del glob
        del bundle, state
        gc.collect()
        torch.cuda.empty_cache()
    h, n_ = out["hier"], out["naive"]
    for r_h, r_n in zip(h["rows"], n_["rows"]):
        close(torch.tensor(r_n["loss"]), torch.tensor(r_h["loss"]), 2e-4, 0,
              "hier vs naive loss")
        close(torch.tensor(r_n["gnorm"]), torch.tensor(r_h["gnorm"]), 5e-3, 0,
              "hier vs naive gnorm")
    excused, total, worst = state_close(n_["state"], h["state"],
                                        len(batches),
                                        "hier vs naive")
    per_node = {m_: sum(o_["bytes"].values()) / vc.pods
                for m_, o_ in out.items()}
    c1 = per_node["naive"] / per_node["hier"]
    print(f"[train] hier vs naive, 2x4, 2 layers, 2 steps: loss "
          f"{[r['loss'] for r in h['rows']]} vs "
          f"{[r['loss'] for r in n_['rows']]}, gnorm "
          f"{[r['gnorm'] for r in h['rows']]} vs "
          f"{[r['gnorm'] for r in n_['rows']]}, m and v per leaf within "
          f"rtol 2e-4 atol 2e-5 of the leaf's largest (worst m "
          f"{worst['m']:.3g}, v {worst['v']:.3g} of that tolerance), "
          f"updated params within rtol 2e-4 atol 2e-5 but {excused} of "
          f"{total} elements where AdamW's update is ill-conditioned; "
          f"training state per node (params, m, v, "
          f"grads as the allocator reports them): hier "
          f"{per_node['hier'] / 1e9:.4f} GB naive "
          f"{per_node['naive'] / 1e9:.4f} GB, C1 naive/hier {c1} "
          f"(chips {vc.chips})")
    if c1 != vc.chips:
        raise AssertionError(f"training-state C1 {c1} != chips {vc.chips}")
    del out, h, n_

    # (c) card against CPU: one hier step on 2x4, full width, 2 layers,
    # 8 x 128 tokens, from the same params
    batch = train_batches(cfg2, 128, 1)
    res = {}
    for d_ in (dev, torch.device("cpu")):
        vc_d = VirtualCluster(pods=2, chips=4, device=d_)
        bundle, state, _ = train_setup(cfg2, vc_d, "hier",
                                       _map(lambda t: t.to(d_), params))
        state, mt = bundle.step(state, bundle.layout_batch(batch[0]))
        glob = bundle.unlayout_state(state)
        res[d_.type] = (float(mt["loss"][0]), float(mt["gnorm"][0]),
                        _map(lambda t: t.cpu(), {
                            g_: glob[g_] for g_ in ("params", "m", "v")}))
        del glob
        del bundle, state
        gc.collect()
    close(torch.tensor(res["cuda"][0]), torch.tensor(res["cpu"][0]), 2e-4,
          0, "card vs CPU loss")
    close(torch.tensor(res["cuda"][1]), torch.tensor(res["cpu"][1]), 5e-3,
          0, "card vs CPU gnorm")
    excused, total, worst = state_close(res["cuda"][2], res["cpu"][2], 1,
                                        "card vs CPU")
    print(f"[train] card vs CPU, hier 2x4, 2 layers, 8 x 128, one step: "
          f"loss {res['cuda'][0]:.6f} vs {res['cpu'][0]:.6f}, gnorm "
          f"{res['cuda'][1]:.6f} vs {res['cpu'][1]:.6f}, m and v per leaf "
          f"within rtol 2e-4 atol 2e-5 of the leaf's largest (worst m "
          f"{worst['m']:.3g}, v {worst['v']:.3g} of that tolerance), "
          f"updated params within rtol 2e-4 atol 2e-5 but {excused} of "
          f"{total} elements where AdamW's update is ill-conditioned")
    del params, res
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[phase] train {time.perf_counter() - t_phase:.1f} s")
    launches["flash_attention_bwd"] = train_launches["flash_attention_bwd"]
    launches["matmul"] += sum(want_mm.values())

    # -- 12. training with tensor parallelism: the factored cluster -----------
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    vc_tp = VirtualCluster.from_label("2x(2x2)", device=dev)
    torch.cuda.reset_peak_memory_stats(dev)

    # (a) the main path: qwen3-0.6b full width and depth, hier on 2x(2x2)
    # (per node 2 store ranks x 2 tp ranks: head_tp, kv heads sharded),
    # 8 x 2048, the seed, lr and clip of phase 11 (a)
    params = meta.init_params(model_defs, tcfg,
                              torch.Generator(device=dev).manual_seed(11),
                              dev)
    bundle, state, nbytes = train_setup(tcfg, vc_tp, "hier", params)
    del params
    if meta.attn_mode_for(tcfg, bundle.model.ctx.tp) != "head_tp":
        raise AssertionError("qwen3-0.6b at tp 2 is not head_tp")
    batches = train_batches(tcfg, 2048, 3)
    kflash.launches = kbwd.launches = 0
    kmatmul.launches_by_layout.update(dict.fromkeys(kmatmul.LAYOUTS, 0))
    state, rows = run_steps(bundle, state, batches,
                            "qwen3-0.6b full depth hier 2x(2x2) 8x2048")
    tp_launches = {"flash_attention (forward)": kflash.launches,
                   "flash_attention_bwd": kbwd.launches}
    tp_mm = dict(kmatmul.launches_by_layout)
    nbytes["grads"] = bundle.stats["grad_bytes"]
    print(f"[train] tp training state on the card (2 node copies, each tp "
          f"shard once per node): "
          + ", ".join(f"{k_} {v_ / 1e9:.3f} GB" for k_, v_ in nbytes.items())
          + f", total {sum(nbytes.values()) / 1e9:.3f} GB; peak allocated "
          f"in phase 12 (a) {torch.cuda.max_memory_allocated(dev) / 1e9:.1f} "
          f"GB")
    print(f"[train] launches in the tp training run: "
          + ", ".join(f"{k_} {v_}" for k_, v_ in tp_launches.items())
          + " (one a layer a node run, the tp ranks folded into the batch; "
          "the forward twice: the remat); panel matmul "
          + ", ".join(f"{k_} {v_}" for k_, v_ in tp_mm.items()))
    if not all(tp_mm.values()):
        raise AssertionError(f"the tp training run left a layout of the "
                             f"panel matmul unused: {tp_mm}")
    if tp_launches != {k_: train_launches[k_] for k_ in tp_launches}:
        raise AssertionError(f"tp launches {tp_launches} != phase 11 (a)'s "
                             f"{train_launches}")
    # the same params and batches as phase 11 (a): the same model split
    # over 2 tp ranks gives the same losses and gnorms, within §2's
    # tolerances; and the loss falls over the 3 steps (step 3's batch
    # scores above step 2's in both runs)
    losses = [r["loss"] for r in rows]
    for i, (r_t, r_1) in enumerate(zip(rows, train_rows)):
        close(torch.tensor(r_t["loss"]), torch.tensor(r_1["loss"]), 2e-4, 0,
              f"tp vs phase 11 (a) step {i + 1} loss")
        close(torch.tensor(r_t["gnorm"]), torch.tensor(r_1["gnorm"]), 5e-3,
              0, f"tp vs phase 11 (a) step {i + 1} gnorm")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"tp training loss did not fall: {losses}")
    tp_row = {"ms": sum(r["ms"] for r in rows[1:]) / (len(rows) - 1)}
    print(f"[train] tp step (steps 2-3) {tp_row['ms']:.1f} ms against phase "
          f"11 (a)'s {train_row['ms']:.1f} ms "
          f"({8 * 2048 / tp_row['ms'] * 1e3:.1f} against "
          f"{8 * 2048 / train_row['ms'] * 1e3:.1f} tokens/s); losses and "
          f"gnorms equal phase 11 (a)'s within rtol 2e-4 / 5e-3, the loss "
          f"{losses[0]:.6f} -> {losses[-1]:.6f}")
    del bundle, state, batches
    gc.collect()
    torch.cuda.empty_cache()

    # (b) hier against naive on 2x(2x2), 2 layers, 2 steps: per node hier
    # holds each tp shard once, naive once per store rank, so C1 is the
    # store size, 2, for every group
    params = meta.init_params(meta.model_defs(cfg2, 1, 1, "hier"), cfg2,
                              torch.Generator(device=dev).manual_seed(12),
                              dev)
    batches = train_batches(cfg2, 2048, 2)
    out = {}
    for mode in ("hier", "naive"):
        bundle, state, nb = train_setup(cfg2, vc_tp, mode, params)
        state, rows = run_steps(bundle, state, batches,
                                f"qwen3-0.6b 2 layers {mode} 2x(2x2) 8x2048")
        nb["grads"] = bundle.stats["grad_bytes"]
        glob = bundle.unlayout_state(state)
        out[mode] = {"rows": rows, "bytes": nb,
                     "state": _map(lambda t: t.cpu(), {
                         g_: glob[g_] for g_ in ("params", "m", "v")})}
        del glob, bundle, state
        gc.collect()
        torch.cuda.empty_cache()
    h, n_ = out["hier"], out["naive"]
    for r_h, r_n in zip(h["rows"], n_["rows"]):
        close(torch.tensor(r_n["loss"]), torch.tensor(r_h["loss"]), 2e-4, 0,
              "tp hier vs naive loss")
        close(torch.tensor(r_n["gnorm"]), torch.tensor(r_h["gnorm"]), 5e-3, 0,
              "tp hier vs naive gnorm")
    excused, total, worst = state_close(n_["state"], h["state"],
                                        len(batches),
                                        "tp hier vs naive")
    c1 = {g_: n_["bytes"][g_] / h["bytes"][g_] for g_ in h["bytes"]}
    print(f"[train] hier vs naive, 2x(2x2), 2 layers, 2 steps: loss "
          f"{[r['loss'] for r in h['rows']]} vs "
          f"{[r['loss'] for r in n_['rows']]}, gnorm "
          f"{[r['gnorm'] for r in h['rows']]} vs "
          f"{[r['gnorm'] for r in n_['rows']]}, m and v per leaf within "
          f"rtol 2e-4 atol 2e-5 of the leaf's largest (worst m "
          f"{worst['m']:.3g}, v {worst['v']:.3g} of that tolerance), "
          f"updated params within rtol 2e-4 atol 2e-5 but {excused} of "
          f"{total} elements where AdamW's update is ill-conditioned; "
          f"state per node hier "
          f"{sum(h['bytes'].values()) / vc_tp.pods / 1e9:.4f} GB naive "
          f"{sum(n_['bytes'].values()) / vc_tp.pods / 1e9:.4f} GB, C1 "
          f"naive/hier by group {c1} (the store size 2, not chips "
          f"{vc_tp.chips})")
    if any(v_ != 2.0 for v_ in c1.values()):
        raise AssertionError(f"tp training-state C1 {c1} != 2.0")
    del out, h, n_

    # (c) card against CPU: one hier step on 2x(2x2), 2 layers, 8 x 128
    batch = train_batches(cfg2, 128, 1)
    res = {}
    for d_ in (dev, torch.device("cpu")):
        vc_d = VirtualCluster.from_label("2x(2x2)", device=d_)
        bundle, state, _ = train_setup(cfg2, vc_d, "hier",
                                       _map(lambda t: t.to(d_), params))
        state, mt = bundle.step(state, bundle.layout_batch(batch[0]))
        glob = bundle.unlayout_state(state)
        res[d_.type] = (float(mt["loss"][0]), float(mt["gnorm"][0]),
                        _map(lambda t: t.cpu(), {
                            g_: glob[g_] for g_ in ("params", "m", "v")}))
        del glob, bundle, state
        gc.collect()
    close(torch.tensor(res["cuda"][0]), torch.tensor(res["cpu"][0]), 2e-4,
          0, "tp card vs CPU loss")
    close(torch.tensor(res["cuda"][1]), torch.tensor(res["cpu"][1]), 5e-3,
          0, "tp card vs CPU gnorm")
    excused, total, worst = state_close(res["cuda"][2], res["cpu"][2], 1,
                                        "tp card vs CPU")
    print(f"[train] card vs CPU, hier 2x(2x2), 2 layers, 8 x 128, one step: "
          f"loss {res['cuda'][0]:.6f} vs {res['cpu'][0]:.6f}, gnorm "
          f"{res['cuda'][1]:.6f} vs {res['cpu'][1]:.6f}, m and v per leaf "
          f"within rtol 2e-4 atol 2e-5 of the leaf's largest (worst m "
          f"{worst['m']:.3g}, v {worst['v']:.3g} of that tolerance), "
          f"updated params within rtol 2e-4 atol 2e-5 but {excused} of "
          f"{total} elements where AdamW's update is ill-conditioned")
    del params, res
    gc.collect()
    torch.cuda.empty_cache()

    # (d) context-parallel attention at full width: starcoder2-7b (36
    # heads, so tp 8 takes cp) cut to 2 layers on one node's 1x8 fast tier
    # factored (1, 8), 2 x 2048 tokens, one hier step
    scfg = dataclasses.replace(get_config("starcoder2-7b"), n_layers=2)
    vc_cp = VirtualCluster.from_label("1x(1x8)", device=dev)
    params = meta.init_params(meta.model_defs(scfg, 1, 1, "hier"), scfg,
                              torch.Generator(device=dev).manual_seed(13),
                              dev)
    bundle = make_cluster_train_step(scfg, vc_cp, mode="hier", lr=3e-4,
                                     clip=1.0, global_batch=2)
    ctx_cp = bundle.model.ctx
    T_cp = 2048
    if meta.attn_mode_for(scfg, ctx_cp.tp) != "cp" or \
            (2, T_cp // ctx_cp.tp, scfg.n_heads, T_cp, scfg.n_kv, True) \
            not in tp_shapes:
        raise AssertionError("phase 2 did not check the cp step's flash "
                             "shapes")
    state = {"params": vc_cp.layout(params, bundle.state_specs["params"])}
    del params
    state["m"] = _map(torch.zeros_like, state["params"])
    state["v"] = _map(torch.zeros_like, state["params"])
    state["step"] = vc_cp.layout(torch.zeros((), dtype=torch.int32),
                                 bundle.state_specs["step"])
    stream = SyntheticLM(DataConfig(vocab=scfg.vocab, seq_len=T_cp,
                                    global_batch=2, seed=7))
    kflash.launches = kbwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, mt = bundle.step(state, bundle.layout_batch(stream.next_batch()))
    loss, gnorm = float(mt["loss"][0]), float(mt["gnorm"][0])
    torch.cuda.synchronize()
    cp_ms = (time.perf_counter() - t0) * 1e3
    cp_launches = (kflash.launches, kbwd.launches)
    want_cp = (2 * scfg.n_layers * ctx_cp.tp, scfg.n_layers * ctx_cp.tp)
    print(f"[train] starcoder2-7b 2 layers cp (tp {ctx_cp.tp}) hier on "
          f"{vc_cp.label}, 2 x {T_cp}, one step: loss {loss:.6f} gnorm "
          f"{gnorm:.6f} step {cp_ms:.1f} ms; flash_attention launches "
          f"{cp_launches[0]}, flash_attention_bwd {cp_launches[1]} (one a "
          f"tp rank a layer, q (2, {T_cp // ctx_cp.tp}, {scfg.n_heads}, "
          f"128) at q_offset rank x {T_cp // ctx_cp.tp} against k, v (2, "
          f"{T_cp}, {scfg.n_kv}, 128))")
    if not (np.isfinite(loss) and np.isfinite(gnorm)) or \
            cp_launches != want_cp:
        raise AssertionError(f"cp step: loss {loss} gnorm {gnorm}, "
                             f"launches {cp_launches} (want {want_cp})")
    del bundle, state, mt
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[phase] train tp {time.perf_counter() - t_phase:.1f} s")
    launches["flash_attention"] += (
        train_launches["flash_attention (forward)"]
        + tp_launches["flash_attention (forward)"])
    launches["flash_attention_bwd"] += tp_launches["flash_attention_bwd"]

    # -- 13. the train runtime: elastic recovery, schedules, bench, --ckpt ----
    # every op of these runs deterministic (torch raises on one that is
    # not), so a recovered or resumed run can be held bit for bit
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(True)
    rt_launches = {"flash_attention": 0, "flash_attention_bwd": 0}

    def take_launches(what, fwd=None, bwd=None):
        fwd = kflash.launches if fwd is None else fwd
        bwd = kbwd.launches if bwd is None else bwd
        print(f"[runtime] {what}: flash_attention launches {fwd}, "
              f"flash_attention_bwd {bwd}")
        if fwd <= 0 or bwd <= 0:
            raise AssertionError(f"{what} never launched the flash kernels")
        rt_launches["flash_attention"] += fwd
        rt_launches["flash_attention_bwd"] += bwd

    cfg13 = dataclasses.replace(tcfg, n_layers=2)
    scratch = tempfile.mkdtemp(prefix="chip_smoke_runtime_")
    try:
        # (a) a pod lost at step 3 of 6, saves every 2 steps: qwen3-0.6b at
        # full width, 2 layers, hier 2x4 with the step graph, 8 x 2048
        el_kw = dict(opts=("stepgraph",), global_batch=8, seq=2048,
                     lr=3e-4, save_every=2, seed=11)
        ck_el = os.path.join(scratch, "elastic")
        vc = VirtualCluster(pods=2, chips=4, device=dev)
        kflash.launches = kbwd.launches = 0
        t0 = time.perf_counter()
        rt = ElasticRuntime(cfg13, vc, ckpt_dir=ck_el, plan=FaultPlan(
            (FaultEvent.pod_loss(3, pod=1),)), **el_kw)
        rep = rt.run(6)
        torch.cuda.synchronize()
        el_s = time.perf_counter() - t0
        take_launches("elastic run")
        if len(rep.recoveries) != 1:
            raise AssertionError(f"{len(rep.recoveries)} recoveries")
        rec = rep.recoveries[0]
        if (rec.old_label, rec.new_label, rec.restored_step) != \
                ("2x4", "1x4", 2) or sorted(rep.losses) != list(range(6)):
            raise AssertionError(f"recovery {rec} losses {rep.losses}")
        print(f"[runtime] elastic: qwen3-0.6b 2 layers hier stepgraph 8 x "
              f"2048, pod 1 lost at step 3: {rec.old_label} -> "
              f"{rec.new_label} (signature {rec.old_signature} -> "
              f"{rec.new_signature}), restored step {rec.restored_step}, "
              f"stale saves dropped {list(rec.stale_dropped)}; retune "
              f"sources {rec.retune.sources}: "
              + ", ".join(f"{f_} e{e_} -> {r_.scheme} ({r_.source})"
                          for f_, e_, r_ in rec.retune.rows)
              + f"; 6 steps + recovery in {el_s:.1f} s")
        # C1: every laid-out state holds the logical state once per node
        logical = sum(t_.numel() * t_.element_size() for g_ in (
            "params", "m", "v") for t_ in _tensors(
            rt.bundle.abstract_state()[g_]))
        copies = {label: b_ / (logical * VirtualCluster.from_label(
            label, device="cpu").pods) for label, b_ in rep.layouts}
        print(f"[runtime] state per node over the logical state (params, "
              f"m, v: {logical / 1e9:.4f} GB): {copies}")
        if any(c_ != 1.0 for c_ in copies.values()):
            raise AssertionError(f"state copies per node {copies} != 1.0")
        # the oracle: a run that starts on 1x4 at the restored step
        ref = reference_run(cfg13, vc.without_pod(1), ckpt_dir=ck_el,
                            from_step=rec.restored_step, steps=6, **el_kw)
        same = [rep.losses[i_] == ref.losses[i_] for i_ in sorted(
            ref.losses)]
        print(f"[runtime] recovered losses "
              f"{[rep.losses[i_] for i_ in sorted(rep.losses)]}; "
              f"reference_run on 1x4 from step 2 "
              f"{[ref.losses[i_] for i_ in sorted(ref.losses)]}: "
              f"bit-identical {all(same)}")
        if sorted(ref.losses) != [2, 3, 4, 5] or not all(same):
            raise AssertionError("the recovered trajectory is not "
                                 "bit-identical to reference_run's")
        del ref
        # save and restore of the final state (1x4), timed, bit for bit
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rt.ckpt.save(100, rt.bundle.host_state(rep.state), blocking=True,
                     copy=False)
        save_ms = (time.perf_counter() - t0) * 1e3
        ck_bytes = os.path.getsize(os.path.join(ck_el, "step_00000100",
                                                "shard_0.npz"))
        t0 = time.perf_counter()
        back, _ = rt.ckpt.restore(rt.bundle.abstract_state(), step=100,
                                  layout=rt.bundle.layout_state)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        if not all(torch.equal(a_, b_) for a_, b_ in zip(
                _tensors(back), _tensors(rep.state))):
            raise AssertionError("restored state differs from the saved")
        print(f"[runtime] checkpoint of the 1x4 state: {ck_bytes} bytes "
              f"({ck_bytes / 1e9:.3f} GB); save {save_ms:.0f} ms (device "
              f"to host and write, blocking), restore {restore_ms:.0f} ms "
              f"(read and lay out); restored state bit-identical")
        del rt, rep, back
        shutil.rmtree(ck_el)
        gc.collect()
        torch.cuda.empty_cache()

        # (b) phase 11 (a)'s step under each schedule, at half its depth
        # (the script's time limit)
        hcfg = dataclasses.replace(tcfg, n_layers=tcfg.n_layers // 2)
        params = meta.init_params(meta.model_defs(hcfg, 1, 1, "hier"), hcfg,
                                  torch.Generator(device=dev).manual_seed(
                                      11), dev)
        batches = train_batches(hcfg, 2048, 3)
        sched = {}
        for opts in ((), ("prefetch",), ("overlap",), ("stepgraph",)):
            name = "+".join(opts) or "eager"
            bundle, state, _ = train_setup(hcfg, vc, "hier", params,
                                           opts=opts)
            kflash.launches = kbwd.launches = 0
            state, rows = run_steps(bundle, state, batches,
                                    f"qwen3-0.6b {hcfg.n_layers} layers hier "
                                    f"2x4 8x2048 {name}")
            take_launches(f"{name} run")
            sched[name] = rows
            del bundle, state
            gc.collect()
            torch.cuda.empty_cache()
        del params, batches
        for name, rows in sched.items():
            ms = sum(r_["ms"] for r_ in rows[1:]) / (len(rows) - 1)
            print(f"[runtime] schedule {name}: step (steps 2-3) {ms:.1f} ms "
                  f"{8 * 2048 / ms * 1e3:.1f} tokens/s, losses "
                  f"{[r_['loss'] for r_ in rows]}")
            for r_, e_ in zip(rows, sched["eager"]):
                if name in ("prefetch", "stepgraph") and (
                        r_["loss"] != e_["loss"]
                        or r_["gnorm"] != e_["gnorm"]):
                    raise AssertionError(f"{name} is not bit-identical to "
                                         f"eager: {r_} vs {e_}")
                close(torch.tensor(r_["loss"]), torch.tensor(e_["loss"]),
                      2e-4, 0, f"{name} vs eager loss")
                close(torch.tensor(r_["gnorm"]), torch.tensor(e_["gnorm"]),
                      5e-3, 0, f"{name} vs eager gnorm")
        print("[runtime] prefetch and stepgraph losses and gnorms == "
              "eager's; overlap within rtol 2e-4 / 5e-3")

        # (c) the step_time bench family on 2x4 and 2x(2x2)
        st_out = os.path.join(scratch, "step_time.json")
        if bench_cli.main(["--families", "step_time", "--topologies",
                           "2x4,2x(2x2)-pod.dp.tp", "--reps", "5",
                           "--out", st_out]) != 0:
            raise AssertionError("the step_time bench failed")
        with open(st_out) as f:
            st_rep = json.load(f)
        for c_ in st_rep["cases"]:
            names = {ch["name"] for ch in c_["checks"]}
            if not {"link/fast", "link/slow", "link/fast/timed",
                    "link/slow/timed"} <= names or not c_["ok"] or \
                    c_["timing"]["mode"] != "eager":
                raise AssertionError(f"step_time case {c_['name']}")
            print(f"[runtime] step_time {c_['topology']} e{c_['elems']} "
                  f"{c_['scheme']}: median {c_['timing']['median_us']:.1f} "
                  f"us (iqr {c_['timing']['iqr_us']:.1f}, "
                  f"{c_['timing']['reps']} eager reps, CUDA events); link "
                  f"bytes per chip fast "
                  f"{c_['record']['fast_link_bytes_per_chip']:.0f} slow "
                  f"{c_['record']['slow_link_bytes_per_chip']:.0f} == the "
                  f"inventory")

        # (d) the launcher's --ckpt loop: 4 steps straight, and 2 steps
        # then a resumed run to 4
        ckpt_launches = [0, 0]

        def launch(steps, ck):
            """One launcher run (it zeroes the launch counts first)."""
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = train_cli.main([
                    "--arch", "qwen3-0.6b", "--layers", "2", "--seq",
                    "2048", "--steps", str(steps), "--save-every", "2",
                    "--seed", "11", "--ckpt", ck])
            out = buf.getvalue()
            if rc != 0:
                raise AssertionError(f"launcher rc {rc}: {out}")
            ckpt_launches[0] += kflash.launches
            ckpt_launches[1] += kbwd.launches
            return out, {ln.split()[2]: float(ln.split()[4])
                         for ln in out.splitlines()
                         if ln.startswith("[train] step ")}

        _, whole = launch(4, os.path.join(scratch, "whole"))
        shutil.rmtree(os.path.join(scratch, "whole"))
        _, first = launch(2, os.path.join(scratch, "resumed"))
        out, second = launch(4, os.path.join(scratch, "resumed"))
        take_launches("--ckpt runs", *ckpt_launches)
        print(f"[runtime] --ckpt: uninterrupted losses {whole}; stopped "
              f"at 2 {first}, resumed ('resumed from step 2' "
              f"{'[train] resumed from step 2' in out}) {second}")
        if sorted(second) != ["3", "4"] or any(
                second[k_] != whole[k_] for k_ in second) or \
                "[train] resumed from step 2" not in out:
            raise AssertionError("the resumed --ckpt run differs from the "
                                 "uninterrupted one")
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(scratch, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[phase] train runtime {time.perf_counter() - t_phase:.1f} s")
    launches["flash_attention"] += rt_launches["flash_attention"]
    launches["flash_attention_bwd"] += rt_launches["flash_attention_bwd"]

    # -- 14. serving on the stacked cluster ------------------------------------
    t_phase = time.perf_counter()
    scratch = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    try:
        sc_launches = serve_cluster_phase(dev, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    print(f"[serve-cluster] flash_attention launches in phase 14: "
          f"{sc_launches}")
    launches["flash_attention"] += sc_launches
    print(f"[phase] serve cluster {time.perf_counter() - t_phase:.1f} s")

    # -- 15. the MoE family: granite-moe-3b-a800m ---------------------------
    t_phase = time.perf_counter()
    moe_launches, moe_gathers = moe_phase(dev)
    print(f"[moe] flash launches in phase 15: {moe_launches}")
    for k_, v_ in moe_launches.items():
        launches[k_] += v_
    print(f"[phase] moe {time.perf_counter() - t_phase:.1f} s")

    # -- 16. the xLSTM family: xlstm-1.3b -----------------------------------
    t_phase = time.perf_counter()
    xl_launches = xlstm_phase(dev)
    print(f"[xlstm] kernel launches in phase 16's runs: {xl_launches} (the "
          f"reference's mLSTM / sLSTM reach no Pallas kernel; the products "
          f"take the panel matmul)")
    for k_, v_ in xl_launches.items():     # its matmuls: the line above
        if k_ != "matmul":
            launches[k_] = launches.get(k_, 0) + v_
    print(f"[phase] xlstm {time.perf_counter() - t_phase:.1f} s")

    # -- 17. the frontends and the production-mesh entry points ------------
    t_phase = time.perf_counter()
    scratch = tempfile.mkdtemp(prefix="chip_smoke_frontends_")
    try:
        fe_launches = frontends_phase(dev, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    print(f"[frontends] flash launches in phase 17: {fe_launches}")
    for k_, v_ in fe_launches.items():
        if v_ <= 0:
            raise AssertionError(f"phase 17 never launched {k_}")
        launches[k_] += v_
    print(f"[phase] frontends {time.perf_counter() - t_phase:.1f} s")

    # -- 18. hybrid training: recurrentgemma-9b through the scan kernels ---
    t_phase = time.perf_counter()
    hy_launches = hybrid_train_phase(dev)
    print(f"[train] kernel launches in phase 18: {hy_launches}")
    for k_, v_ in hy_launches.items():
        launches[k_] = launches.get(k_, 0) + v_
    print(f"[phase] hybrid train {time.perf_counter() - t_phase:.1f} s")

    # -- 19. dropless MoE training: the grouped entry on the main path -----
    t_phase = time.perf_counter()
    grouped, rows = dropless_moe_phase(dev, moe_gathers)
    launches["grouped_matmul"] = grouped["launches"]
    launches["moe_gather"] = rows["launches"]
    print(f"[phase] dropless moe {time.perf_counter() - t_phase:.1f} s")

    for name, n in list(launches.items()) + list(flash_launches.items()):
        if n <= 0:
            raise AssertionError(f"the main path never launched {name}")
    recomputes = {name: m_.recomputes.read() for name, m_ in (
        ("matmul", kmatmul), ("q4_matmul", kquant),
        ("flash_attention", kflash), ("flash_attention_bwd", kbwd))}
    print(f"[nonfinite] tiles recomputed over phases 3-19: {recomputes}")
    if any(recomputes.values()):
        raise AssertionError("the non-finite rule recomputed tiles of "
                             "finite main-path products")
    print(json.dumps({"kernels": [{
        "name": "matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul.py:33",
        "launches": launches["matmul"], "max_abs_err": main_err, "ms": k_ms,
        "plain_ms": plain_ms, **least(mm_bounds), "library_ms": lib_ms}, {
        "name": "q4_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/q4_matmul.cu",
        "replaces": "src/repro/kernels/quant.py:53",
        "launches": launches["q4_matmul"], "max_abs_err": q4_err,
        "ms": q4_ms, "plain_ms": q4_plain_ms, **least(q4_bounds),
        "library_ms": None}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:71",
        "launches": launches["flash_attention"], "max_abs_err": flash_err,
        "ms": flash_ms, "plain_ms": flash_plain_ms, **least(flash_bounds),
        "library_ms": flash_lib_ms}, {
        "name": "lru_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/lru_scan.cu",
        "replaces": "src/repro/kernels/lru_scan.py:38",
        "launches": launches["lru_scan"], "max_abs_err": lru_top["err"],
        "ms": lru_top["ms"], "plain_ms": lru_top["plain_ms"],
        **least(lru_top), "library_ms": None}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:71",
        "launches": launches["flash_attention_bwd"],
        "max_abs_err": bwd_top["err"], "ms": bwd_top["ms"],
        "plain_ms": bwd_top["plain_ms"], **least(bwd_top),
        "library_ms": bwd_top["library_ms"],
        "of_bound": bwd_top["of_bound"],
        "library_over_kernel": bwd_top["library_over_kernel"]}, {
        "name": "lru_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/lru_scan_bwd.cu",
        "replaces": "src/repro/kernels/lru_scan.py:38",
        "launches": launches["lru_scan_bwd"], "max_abs_err": lrub_top["err"],
        "ms": lrub_top["ms"], "plain_ms": lrub_top["plain_ms"],
        **least(lrub_top), "library_ms": None}, grouped, rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
