#!/usr/bin/env python3
"""Drive the PyTorch port (flash_attention_tpu_torch) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1, no result line):

  1. device   — requires a CUDA card; prints its name and power limit and
                the torch, CUDA and nvcc versions.
  2. build    — builds the CUDA kernels and the native scheduler from the
                repository's sources, and prints the build seconds.
  3. kernels  — K1 (flash_fwd_sm90.cu: wgmma on TMA-fed tiles in bf16 /
                fp16) at the serving path's shapes (the chunk's K / V the
                whole dense cache of distinct random slots, the slot read
                by ``kv_batch``, at slots 3 and 7; fp32's body too) and at phase 14's
                training shape, and K6 (decode.cu: the kv split over
                blocks, merged in the launch), in bf16, against their plain
                PyTorch versions and the fp32 oracle (K6 also row by row and
                its LSE), bit-identical over two calls (K6 also under a CUDA
                graph's replay), with their grids (K1: blocks, q rows a
                block, SMs; K6: kv split and blocks) and CUDA-event times of
                kernel, plain, SDPA and bound; then every dtype / head_dim
                instantiation at ragged shapes. Then K1q and K1r
                (``cache_attention`` on chunk_fwd_sm90.cu: a GQA group's
                rows in one block, the walk over a cluster; the chunk over a
                slot of 11a's quantized dense cache in each payload, slots 3
                and 7, kv_end 256 / 1024 / 2048, and of 17a's 4352-row ring
                at kv_end 256 to 9000, with 0 and 4 sinks, softcap 50 once,
                an int8 ring; then ``CHUNK_EDGES``: T 1 / 37 / 255 / 256,
                shares left empty, sinks on a share's boundary, a group of
                1, head_dim 64, fp16 queries, every payload on both forms)
                against their plain versions (the rows copied out in
                position order and dequantized; past the window with sinks,
                two passes merged) and the fp32 oracle over the positions
                the chunk sees, their LSE, bit-identical over two calls, no
                copy allocated, K1q bit for bit equal to the body's 16-bit
                instantiation over the dequantized copy; the fp32 body of
                both.
  4. tiny     — a tiny fp32 model served on the card (through the kernels)
                and on the CPU (through the plain versions): the greedy
                tokens must be identical. On the card after ``warmup()``
                (``replayed_tokens``): every prefill chunk and every decode
                block of the run is a replay of a CUDA graph built there,
                none captured in the run.
  5. full     — ModelConfig() at full width, bf16, random weights from a
                seed; ServingEngine serves 10 greedy requests on 8 slots;
                every completion must have 32 tokens, the logits must be
                finite, and both kernels must have been launched by the run.
                Before it, phase 5's prompts with one new token each on the
                fresh engine (cold prefill: each (T, kv_end) prefill
                program's first chunk eager, then captured) and again after
                ``warmup()`` (warm: every chunk a replay, none captured, the
                same first tokens), both timed. After it,
                ``hold_prefill_programs``: every built prefill program
                replayed at two slots against its eager body from identical
                copies of the caches, the logits and every cache tensor
                bit-identical, one replay traced (its kernel records equal
                to the launches it counted; no cache gather or dequant
                operation, at most one strided bf16 copy a layer: wo is
                read through its [H * D, M] view). Then ``hold_programs``: the
                engine's k=16 block, greedy and
                sampled, replayed (one CUDA graph) against its eager body
                from identical copies of the caches, the tokens and every
                cache tensor bit-identical; the greedy replay traced, its
                kernel records equal to the launches it added to the counts
                (a replay runs no wrapper: it adds what its capture counted);
                the sampled replay counts one S1 launch a step. Then sampling
                on the card: S1 (csrc/sampling.cu) in its detail mode at
                phase 5's 8 edge seeds x 8 edge positions x 32,000, its
                noise bit-equal to the CPU's gumbel_noise; then the sweep
                (vocab 1, 7, 128, 32,000, 50,257, 128,256 and 256,000 x
                batch 1, 8, 32 x normal, tied and peaked logits) against the
                plain version on the card: the noise bit for bit, the greedy
                picks and kth exactly, thresh exactly or (printed) with the
                exact mass rule holding at S1's boundary to within 1e-6 of
                top_p, the tokens where thresh agrees, and bit-identical over
                two calls and a graph replay; then sample_tokens (S1) on one
                decode step's logits at temperature > 0 with top-k and
                top-p, under the sync debug mode "error", equal to the plain
                version on the card and on the CPU; S1 timed as a call,
                alone in a CUDA graph and as host us beside plain and its
                bound; one decode step of 8 slots timed greedy and sampled.
  6. paged    — K7 (decode.cu, paged), K8 (flash_fwd_sm90.cu, paged: the
                body counter must show the tensor-core body) and K9/K10
                (paged_write.cu) at the paged path's shapes in bf16 over a
                shuffled page table, against their plain versions (K9/K10
                bit-exact, the new lengths of a slot at capacity and one on
                the dump page, one launch a call) and the fp32 oracle, the
                outputs also row by row relative to the row's largest value
                (K7 with its kv split, bit-identical over two calls); then
                every dtype / head_dim instantiation at ragged shapes and
                two page sizes, and K8 on the tensor-core body at the
                chunk / page edges (fp16 / bf16 x head_dim 32 / 64 / 128 x
                groups 1 / 4 / 16 x pages of 64 / 128 rows, chunks of 1-256
                rows ending at page edges +-1), each bit-identical over two
                calls.
  7. tiny paged — the tiny fp32 model through PagedServingEngine on the
                card and on the CPU: tokens identical to each other and to
                the dense engine's; the prefix cache gives the same tokens.
  8. full paged — PagedServingEngine at full width on phase 5's weights:
                phase 5's requests, then requests sharing a 1024-token
                prefix through the prefix cache; K7, K8 and K10 launched,
                K1 and K6 not, and every K8 launch on the tensor-core body
                (its body counter); cold and warm prefill as in phase 5;
                then ``hold_programs`` and ``hold_prefill_programs``.
  9. quant    — the quantized kernels with bf16 queries, for int8, fp8
                e4m3 and fp8 e5m2 caches whose rows are scaled one by one:
                K6q and K7q at phase 3's and 6's shapes and at 32 slots x
                8192 rows, K8q at kv_end 256 / 1024 / 2048, K9q/K10q (32
                layers x 8 slots, bit-equal to plain, payload and scales);
                each against its plain version, the fp32 oracle on the
                dequantized cache and, as information, the oracle on the
                unquantized rows. K6q and K7q at 8192 rows must allocate
                under 1 % of a bf16 copy of the cache; K6 over every finite
                code of each payload type must return the codes exactly;
                K6q and K7q print their kv split and are bit-identical over
                two calls, K9q and K10q make one launch a call; K8q's body
                counter must show the tensor-core body. Then every (query
                dtype, payload, head_dim) instantiation of K6q, K7q, K8q and
                K9q/K10q at ragged shapes, and K8q at phase 6's chunk /
                page edges (the payloads in turn).
 10. tiny quant — the tiny fp32 model with each kv_quant mode and with int8
                weights through both engines on the card and on the CPU:
                each engine's tokens identical on both; paged and dense
                agree on every prefill token (after it, over a quantized
                cache, the paged engine merges the current token at full
                precision and the dense one attends it quantized, as in the
                JAX package; where they part is printed); prefix cache on
                == off. The card's runs as in phase 4, after ``warmup()``.
 11. full quant — phase 5's weights at full width: ServingEngine with int8
                weights and an int8 cache on phase 5's requests, and
                PagedServingEngine with an fp8_e4m3 cache on phase 8's runs;
                K1q, K6q, K7q, K8q and K10q launched, K1, K6, K7, K8 and
                K10 not; K1q and K8q on the tensor-core body; cold and warm prefill,
                ``hold_programs`` and ``hold_prefill_programs`` on both.
 12. backward — K3, K4, K5 and K5's split sum K5s (flash_bwd_sm90.cu:
                wgmma on TMA-fed tiles in bf16 / fp16; flash_bwd.cu's FMA
                bodies in fp32) in bf16 through
                flash_attention's autograd Function (whose card output must
                carry it): K4 + K5 at q [1,32,2048,128] over kv
                [1,8,2048,128] and at q_len 256 end-aligned, K3 at
                [1,32,2048,128] causal and not; dq, dk and dv within 0.1 of
                autograd through the fp32 oracle and row by row within
                REL_BAR of flash_attention_bwd_plain; K4 and K5, and K3's dk
                and dv, bit-identical over two calls; kernel, plain,
                SDPA-backward and bound times, TFLOP/s, share of 989 and the
                route over SDPA (K4 + K5 beside K3 at the MHA shape, for
                information); K5s alone, exactly its plain version. Then
                every (dtype, head_dim) instantiation at lengths 1, 63, 129
                and 1000, and across the 128- and 64-row tile edges
                (lengths 127-257, GQA groups 1-8, q_len < kv_len, K5 split
                and not, batch 2); then the tensor-core forward and K3
                across their tile edges in fp16 and bf16 (lengths 1-1000,
                groups 1/4/8, q_len < kv_len, batch 2, windows 1/63/65/1000,
                softcap, documents), each bit-identical over two calls.
 13. tiny train — the tiny fp32 model, GQA (K1, K4, K5) and MHA (K1, K3):
                loss and every parameter's gradient on the card equal the
                CPU's within 1e-4 of each leaf's largest gradient.
 14. full train — ModelConfig() on phase 5's weights at B=1, T=2048: three
                steps of forward + backward with finite loss and gradients
                and no all-zero weight gradient, then an SGD step along -g
                that lowers the loss; exactly K1, K4, K5 and K5s launched. Then
                ModelConfig(num_kv_heads=32, num_layers=4) one step, K1
                and K3 launched. Step ms, training tokens/s, peak memory.
 15. masked   — the masked kernels in bf16 against their plain versions
                (row-relative), the fp32 oracle with the same masks and
                their LSE: K1 with window 4096 (q 256 end-aligned over kv
                9216) and with softcap 50; K2 (window 64) beside K1 at the
                JAX band's window 128 (K2 on the tensor-core body: its body
                counter must show it); K6 over a dense window, a ring of
                4352 rows and a ring with 4 sinks, lengths past the ring,
                K6q int8 on the ring; K7 and K8 with window 4096 and 4
                sinks over a shuffled paged ring whose rolled-out logical
                pages alias live ones (K6, K7 and K8 bit-identical over two
                calls). Then every (dtype, head_dim) instantiation at
                windows 1, 63, 64, 65 and 1000, and K8 over a paged ring
                with 3 sinks and K2 at phase 6's chunk / page edges; then
                the
                split-edge sweep: K6 / K6q / K7 / K7q for every (query
                dtype, payload, head_dim), groups 1/4/16, batch 1 and 32,
                lengths 0, 1 and the split edges +-1, over a dense window,
                a ring, a ring with 3 sinks and a paged ring of 64- and
                128-row pages, each against plain, the oracle and its LSE.
 16. tiny masked — the tiny fp32 model on the card and the CPU, identical
                tokens, through a dense window (96, and 48: K2), the rolling
                cache and rolling + 32 sinks (K1r), softcap 30, the paged ring and
                paged + sinks; rolling == dense window == paged ring, and
                paged sinks == rolling sinks. The card's runs as in phase
                4, after ``warmup()``.
 17. full masked — ModelConfig(mlp_dim=14336, sliding_window=4096)
                (Mistral-7B v0.1's shape, tied embedding), bf16, seed 0:
                prompts of {1, 255, 1024, 4095, 4096, 4097, 6000, 9000}
                tokens, 32 new each, through (a) the rolling ServingEngine
                (4352-row ring, K1r and K6 only), (b) the same without the
                ring at max_seq 9216 (last-chunk logits within LOGIT_BAR of
                (a)), (c) PagedServingEngine with 4 sinks (at most 37 pages a
                slot, the pool full again after; K7, K8, K10 only) and (d)
                softcap 50 on phase 5's requests; every forward launch on
                the tensor-core body; ``hold_programs`` and
                ``hold_prefill_programs`` on (a) (over the keys its run's
                chunks used, the ring's device-slot writes among them; its
                prefill tok/s includes any capture the run made) and
                (c); (c) also cold and warm prefill-only runs around the
                whole ``warmup()``.
 18. masked backward — K1d (the forward's segment ids) and the masked
                K3, K4 and K5 (K3m, K4m and K5m in flash_bwd_sm90.cu, K1d in
                flash_fwd_sm90.cu; K4m, K5m and K3m's dk and dv bit-identical
                over two calls) in bf16 through
                flash_attention's autograd Function, each call launching
                exactly its route's kernels: gradients row by row within
                REL_BAR of flash_attention_bwd_plain and within 0.1 of
                autograd through the fp32 oracle with the same masks, at
                windows 1, 63, 64 (K2's forward), 65, 1000 and 4096, softcap
                5 with q x 32 (so 1 - tanh^2 spans most of (0, 1]), packed
                documents, a (q_ids, kv_ids) pair with kv_len > q_len, a q
                id absent from kv (finite, zero gradient rows) and all three
                together, GQA and MHA; then at the training shapes (q
                [1,32,8192,128] kv [1,8,8192,128], window 4096, unpacked and
                packed as documents {5000, 1800, 900, 492}; for K3m q = kv
                [1,32,8192,128] packed, as phase 20d runs it, and
                [1,32,4096,128] at window 1024) the
                forward and backward held against plain and the oracle
                a few kv heads at a time and timed beside plain, SDPA with the
                equivalent boolean mask and the unwindowed causal K4 / K5.
                Then every (dtype, head_dim) instantiation at ragged
                shapes and windows 1-129 and 1000.
 19. tiny masked train — the tiny fp32 model with window 24 and softcap
                30, packed and not, GQA and MHA: loss and every gradient on
                the card equal the CPU's within 1e-4 of each leaf's largest.
 20. full masked train — ModelConfig(mlp_dim=14336, sliding_window=4096)
                (Mistral-7B's shape, 32 layers) at B=1, T=8192 after phase
                17's engines are released: (a) three steps and the SGD
                check, exactly K1, K4m, K5m; (b) one packed step, exactly
                K1d, K4m, K5m; (c) softcap 50, one step; (d) the MHA route
                at 4 layers, one packed step, exactly K1d and K3m. Losses,
                step ms, tokens/s, peak memory, the attention kernels' share
                of (a)'s step and (b)'s attention over (a)'s.
 21. probes   — P1-P6 (csrc/probes.cu: body T, warp-specialised wgmma +
                TMA, for P1, P3, P4; body S, wgmma with each row's scores
                split over a thread-block cluster, for P2, P5, P6) through
                each tool's ``run`` on a shortened sweep (P1 at seq 2048
                over the four tile shapes and at 8192 over one; P2, P5, P6
                at 512 and 1024; P3 at 1024 over four tiles and 8192 over
                two; P4 at 8192 over one), 32 heads, head_dim 128: every
                variant within its tool's row-relative bar of its plain
                version and, where it computes attention, within 0.1 of the
                fp32 oracle, timed beside its plain version, bound and SDPA;
                each probe's run launches exactly its body (P5 also K1).
                Then the edge cases (``probe_edges``, 4 heads): body S at
                seq 128, 512 and 1024, hb 1 and 2, and masked at hb 1; body
                T at every tile shape (fp32 skip + cond, bf16 skip + always,
                unmasked q-tile-major), each within its bar of plain and 0.1
                of the oracle and bit-identical over two calls. The whole
                sweeps run from ``python3 -m
                flash_attention_tpu_torch.tools.<probe>``.
 22. parallel — the parallel layer (parallel/) in four gloo processes that
                share the card (each on cuda:0; NCCL refuses two ranks on one
                device; the ring's rotation goes through pinned host buffers,
                since gloo sends only host memory): the ring at Mistral-7B's
                training shape (q [1,32,8192,128], kv [1,8,8192,128], bf16,
                causal, 2048 rows a rank) forward and backward, contiguous
                and zigzag through make_ring_attention and
                ring_flash_attention on zigzag-layout shards; the MHA ring
                (32 / 32 heads: K3); context-parallel K1 (non-causal, the KV
                over the 4 ranks); head-sharded K1 (model 4); sharded decode
                at BASELINE config 4 (32 slots x 8192 rows, data 2 x model
                2) over bf16, int8 and e4m3 caches. Rank 0 holds every
                gathered result against the single-process kernels on the
                whole tensors (row-relative REL_BAR, gradients too; the LSE
                within LSE_BAR) and the fp32 oracle (ORACLE_BAR); each rank's
                counts must show exactly its route's kernels, the forward on
                the tensor cores; each rank's ring forward + backward is timed
                (information: the ranks share one card). Then every factory
                over NCCL at world size 1 through initialize_distributed,
                bit-identical to the single-process call (ring gradients
                too); decode_attention_split at config 4 (int8, e4m3: the
                asked split, against plain and the oracle, under 1 % of a
                cache copy allocated) and auto_split where the gate fires;
                K1 timed at the ring's step shape; and the checkpoints:
                ModelConfig() served by ServingEngine, its caches saved and
                loaded into a fresh engine's, and a PagedServingEngine's
                pool likewise, each bit-equal and resuming the greedy decode
                token for token.
 23. sharded serving — tensor-parallel serving behind both engines'
                shard_caches (parallel.sharding.make_cache_sharding): (a)
                one NCCL rank, ModelConfig() on phase 5's weights: the dense
                and paged engines on a one-rank mesh give phase 5's and
                phase 8's tokens, and their models' logits (a 1,024-token
                prefill, 8 decode steps, dense and paged) are the
                single-process model's bit for bit, both replaying their
                decode blocks, and each engine's save_kv_cache file its
                caches bit for bit, loading into a fresh sharded engine's;
                (b) four gloo ranks sharing the card at full width (their
                decode blocks issued step by step: a model axis of more
                than one rank is not captured), each building the global
                weights in turn and keeping its shards: the dense engine on
                data 2 x model 2 and the paged one on model 4 serve phase
                5's requests (tokens the same on every rank; agreement with
                phases 5 / 8 printed, with the step where a request parts);
                each layer's attention and MLP outputs of the model-4 shards
                on the single-process model's own input to that layer within
                REL_BAR of the single-process model's; the 32 layers' logits
                of the model-2 shards (dense path) and the model-4 shards
                (dense and paged paths) no farther from the same weights in
                fp32 than TP_FP32_SLACK times the single-process bf16
                model's distance on the same path, the same bits on every
                rank; (c) tests/test_sharded_serving.py's fp32 config on
                eight gloo ranks (data 2 x model 4), token-identical to the
                unsharded engines on the card; (d) K1 and K6 at a model-2
                shard's shapes (16 q / 4 kv heads, the dense engine's 4
                local slots) and K1, K6, K7 and K8 at a model-4 shard's (8 q
                / 2 kv heads) against plain, the oracle and the LSE, timed
                beside plain, SDPA and the bound, each shape its own entry
                with rank 0's launches at that shard in (b).
                Each part's wall time and each rank's launches are printed.
 24. warmup and profiles — (a) two fresh processes (``first_run_child``)
                each build ModelConfig() in bf16 from phase 5's seed and
                serve phase 5's 10 requests on 8 slots x 2048, one cold,
                one after ``warmup()`` (timed; exactly K1 and K6 launched;
                the counters zero after it): both runs give phase 5's tokens
                and launch only K1 and K6; each run's wall time, its
                first prefill chunk alone with the launches it counted, and
                its prefill and decode tok/s are printed; the warm engine's
                ``warmup()`` builds all ten decode programs and all eight
                prefill programs (each capture timed, the pool's bytes
                printed) and its run captures none and replays every block
                and every chunk; (b) phase 8's paged
                engine serves run A (phase 8's tokens), then ``warmup()``
                (K7, K8 and K9/K10 only) leaves its free page count, prefix
                table and prefix cache switch as they were and every
                program built; (c) in a fresh process (``profiles_child``),
                ``utils/profiling.profile_op`` over one decode step plus the
                sampler at 8 slots x 1,024 rows on the dense and on the
                paged cache, over the engines' replayed k=16 sampled block
                at the same shape, and over phase 14's forward + backward at B=1,
                T=2048 (no update; through ``trace``): traced and
                untraced wall time, device busy share, the top five device
                operations; the replayed block's kernel records equal to
                the launches a replay counts; (d)
                ``calibrate_overhead_s()``. 24(c) also profiles the replayed
                greedy k=16 block of both engines: a dense step must run at
                most STEP_OPS_BAR device operations and a paged one at most
                STEP_COPY_BAR ``direct_copy`` kernels; every operation type
                of the greedy step is printed.
 25. fused glue — the decode step's glue kernels (csrc/fused.cu: F1
                add_rms_norm, F2 rope with the dense row write, F3
                swiglu_act; F4, K7's in-launch self term in csrc/decode.cu)
                at ModelConfig()'s widths (F3 also at Mistral's MLP 14336),
                in bf16, fp16 and fp32, against their plain versions on the
                card: F1's x_new and F2's rotated rows and every cache row
                (payload, scales, lengths; dense, a slot at capacity, the
                4352-row ring, the ring with 4 sinks, int8 / e4m3 / e5m2)
                bit-identical, F1's h and F3 within 1 ulp (1e-6 row-relative
                for F1 in fp32; the share of elements that differ printed);
                F2's chunk form F2c (rope_chunk_kernel: a prefill chunk's
                RoPE and cache write) at q [1,32,256,128] with 8 kv heads
                (ModelConfig()'s and Mistral-7B's attention widths) over
                every cache form (CHUNK_KINDS: dense, int8 / e4m3 / e5m2,
                the ring with a chunk that wraps its end, with 4 sinks, and
                pages of 128 and 64 rows, quantized, and 17c's paged ring)
                at slots 0 and 7 by device scalar: q, rows, scales, table
                and lengths bit-identical to plain, q to F2's rotation;
                F1 and F3 also timed at a chunk's rows ([1,256,4096],
                [1,256,11008 / 14336]);
                F4 over phase 24(c)'s pool (plain, window, softcap, window +
                sinks, int8 and e4m3 pools, fp16, fp32, a slot of length 0)
                within REL_BAR of plain, ORACLE_BAR of the fp32 oracle,
                LSE_BAR, bit-identical over two calls and a graph replay;
                each timed as a call, alone in a CUDA graph and as host µs,
                beside plain, the library call (F1: F.rms_norm) and the
                bound; every counter must rise. Their launches in the
                kernels line are the main paths': phase 5's F1-F3, phase
                8's K7 launches (each with the self term: every serving
                phase of the paged engine checks the K7 / K7q self counter
                equals its K7 / K7q launches), 17a's F3 at MLP 14336.

Every serving phase (4-11, 16, 17, 23, 24) launches F1, F2 and F3 (GLUE)
beside its attention kernels: the norms, RoPE (with the dense cache's row
write) and the SwiGLU gate of every step and chunk run no gradient. Every
engine run also launches F2c, each prefill chunk's RoPE and cache write
(one a layer a chunk: phases 5, 8, 11, 17 and 23 count it, and a traced
replayed chunk holds one F2c record a layer and none of the write as plain
PyTorch), and S1 (SERVED): each request's first token is
picked by sample_tokens, and every step of a sampled decode block. 24(c)
bars a replayed sampled step at SAMPLER_OPS_BAR device operations more
than a greedy one. S1's row in the kernels line counts phases 5's and 8's
main paths.

Every phase prints kernel, plain-version, library-call and bound times
(the bound: the larger of the bytes over 3.35 TB/s and the operations over
989 TFLOP/s, from this run's shapes) with the card's name and power limit.
The last lines of standard output are one JSON object describing the
kernels, the card's name and power limit, then {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import re
import shutil
import statistics
import subprocess
import time

# The JAX package's name. The kernels' report labels each CUDA kernel with
# the file:line of the TPU kernel it replaces, under that package's
# directory; the script reads nothing there.
REFERENCE = "flash_attention_tpu"
ORACLE_BAR = 0.1  # the repository's pass bar against the fp32 oracle
PLAIN_BAR = 1e-2  # kernel vs plain in bf16: the same fp32 math in another order
FP32_PLAIN_BAR = 1e-4  # kernel vs plain in fp32 (the paged sweeps' fp32 bar)
# Base-2 LSE, fp32, kernel vs plain and oracle: measured within 2e-6 on the
# H100; one row dropped from 2048 moves it by log2(2048/2047) = 7e-4.
LSE_BAR = 1e-4
# The paged kernels' outputs, row by row (one query row of one head):
# max|kernel - ref| / max|ref| in the row. Two roundings of nearly equal
# fp32 values differ by at most one unit in the last place, 2^-7 of the
# element in bf16, 2^-10 in fp16; an output of means over thousands of
# rows is smaller than any absolute bar worth having, so the bar is relative.
REL_BAR = {"float32": 1e-3, "float16": 1e-2, "bfloat16": 1e-2}
TINY_CFG = dict(
    vocab_size=128, model_dim=128, num_layers=2, num_q_heads=4,
    num_kv_heads=2, head_dim=32, mlp_dim=256, dtype="float32",
)
FULL_PROMPT_LENS = (1, 37, 255, 256, 257, 600, 1024, 1100, 1500, 1791)
FULL_NEW_TOKENS = 32
# The served phases' warmup prompt: one prefill chunk. The prefill chunks are
# not programs, and the prefill-only runs before have loaded their kernels;
# the warmup is there for the decode programs.
WARMUP_PROMPT = 256
PAGED_LENGTHS = (0, 1, 127, 128, 129, 1000, 2047, 2048)  # phase 6, K7; slot 0 on the dump page
QUANT_MODES = ("int8", "fp8_e4m3", "fp8_e5m2")
LONG = dict(slots=32, rows=8192)  # BASELINE config 4: 32 slots x 8192 rows, 32 q / 8 kv heads, head_dim 128
PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
PEAK_FP32 = 67e12  # H100 SXM fp32 rate off the tensor cores
# The decode step's glue kernels (csrc/fused.cu): every serving path with no
# gradient launches them beside its attention kernels; training does not.
GLUE = ("F1", "F2", "F3")
# What every engine run launches beside its attention kernels: the glue, F2's chunk form F2c (each prefill chunk's
# RoPE and cache write, one launch a layer), and S1 (csrc/sampling.cu), which picks each request's first token and
# every token of a sampled decode step.
SERVED = (*GLUE, "F2c", "S1")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, warmup: int = 5, iters: int = 20) -> float:
    """Median CUDA-event time of ``fn`` in milliseconds."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take (ms), and what bounds it."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def causal_pairs(q_len: int, kv_len: int) -> int:
    """(query, key) pairs an end-aligned causal mask leaves visible."""
    return sum(min(kv_len, i + kv_len - q_len + 1) for i in range(q_len))


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    from flash_attention_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True, text=True, check=True)
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> float:
    from flash_attention_tpu_torch import native
    from flash_attention_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.kernels()
    native.load()
    secs = time.perf_counter() - t0
    log(f"[build] CUDA kernels + native scheduler built and loaded in {secs:.1f} s")
    return secs


def _max_diff(a, b) -> float:
    import torch

    finite = torch.isfinite(a) & torch.isfinite(b)
    if not torch.equal(torch.isfinite(a), torch.isfinite(b)) or not torch.equal(a[~finite], b[~finite]):
        return float("inf")  # non-finite entries (the -inf LSE of an empty row) must agree exactly
    return float((a[finite].float() - b[finite].float()).abs().max()) if finite.any() else 0.0


def _rel_diff(a, b, floor: float = 0.0) -> float:
    """max over rows (all dims but the last) of max|a - b| / max|b| in the
    row, that max taken no smaller than ``floor``; a row where b is all 0 (an
    empty slot's) must be 0 in a as well."""
    import torch

    a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
    err, scale = (a - b).abs().amax(1), b.abs().amax(1).clamp(min=floor)
    empty = torch.where(err > 0, torch.full_like(err, float("inf")), torch.zeros_like(err))
    rel = torch.where(scale > 0, err / scale.clamp(min=1e-30), empty)
    return float(rel.max()) if rel.numel() else 0.0


def _fwd_grid(q, k) -> str:
    """K1's grid on this card for q [B, Hq, Sq, D] (the tensor-core body in
    bf16 / fp16): blocks of ``fwd_q_tile`` rows against the SMs."""
    import torch

    from flash_attention_tpu_torch.ops.flash_attention import fwd_q_tile

    b, hq, q_len, _ = q.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tile = fwd_q_tile(b, hq, q_len, sms)
    return f"{-(-q_len // tile) * b * hq} blocks of {tile} q rows on {sms} SMs"


def phase_k1(card: str) -> dict:
    """K1 at the chunked-prefill shapes (q [1,32,256,128] against kv_len
    rows of one slot of the dense engine's [8, 8, 2048, 128] cache, in the
    main path's form: K / V the whole cache's first kv_len rows and the slot
    read from device memory by ``kv_batch``, at slots 3 and 7), the one-shot
    prefill shape (Sq = Skv = 512) and phase 14's training shape (q
    [1,32,2048,128] kv [1,8,2048,128]), each with its LSE, twice on the same
    inputs (bit-identical), against its plain version and the fp32 oracle
    on the slot's rows. Returns the kernels' line entries of the chunk at kv
    2048 ("K1") and the training shape ("K1t")."""
    import torch
    import torch.nn.functional as F

    from flash_attention_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from flash_attention_tpu_torch.ops.reference import reference_attention_with_lse
    from flash_attention_tpu_torch.utils.testing import make_qkv

    dev = torch.device("cuda")
    scale = 1.0 / 128**0.5
    worst_plain, rep = 0.0, {}
    # Every slot of the cache holds distinct random rows, so a kernel that
    # read another slot than kv_batch's disagrees with the plain version.
    _, k_cache, v_cache = make_qkv(3, 8, 1, 1, 128, num_kv_heads=8, kv_seq=2048, dtype=torch.bfloat16, device=dev)
    cases = [(256, kv, slot) for kv in (256, 1024, 2048) for slot in (3, 7)]
    cases += [(512, 512, None), (TRAIN_TOKENS, TRAIN_TOKENS, None)]
    for q_len, kv_len, slot in cases:
        q, k, v = make_qkv(1, 1, 32, q_len, 128, num_kv_heads=8, kv_seq=kv_len, dtype=torch.bfloat16, device=dev)
        kv_in, kw, form = (k, v), {}, ""
        if slot is not None:
            # The main path's operands: strided views of the whole cache's
            # visible rows, the slot a device int32; k, v are the slot's
            # rows, which the plain version and the oracle read.
            k, v = k_cache[slot:slot + 1, :, :kv_len], v_cache[slot:slot + 1, :, :kv_len]
            kv_in = (k_cache[:, :, :kv_len], v_cache[:, :, :kv_len])
            kw = dict(kv_batch=torch.tensor([slot], dtype=torch.int32, device=dev))
            form = f" (slot {slot} of the [8,8,2048,128] cache by kv_batch)"

        def call():
            return flash_attention(q, *kv_in, causal=True, save_residuals=True, **kw)

        out, lse = call()
        _same_twice(f"K1 q_len={q_len} kv_len={kv_len}{form}", call)
        p_out, p_lse = flash_attention_plain(q, k, v, causal=True, sm_scale=scale, save_residuals=True)
        o_out, o_lse = reference_attention_with_lse(q, k, v, causal=True)
        torch.cuda.synchronize()
        d_oracle, d_plain = _max_diff(out, o_out), _max_diff(out, p_out)
        d_rel = max(_rel_diff(out, p_out), _rel_diff(out, o_out))
        d_lse = max(_max_diff(lse, p_lse), _max_diff(lse, o_lse))
        del p_out, p_lse, o_out, o_lse
        timing = ""
        if slot != 3:  # the first slot of a shape is held, not timed
            ms = cuda_ms(call)
            plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=True, sm_scale=scale,
                                                             save_residuals=True))
            # The library yardstick: one SDPA call with the end-aligned mask.
            mask = (torch.arange(kv_len, device=dev)[None, :]
                    <= torch.arange(q_len, device=dev)[:, None] + (kv_len - q_len))
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True))
            flops = 4 * 128 * 32 * causal_pairs(q_len, kv_len)
            nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse.numel()
            bound_ms, bound_by = bound(flops, nbytes)
            timing = (f"; kernel {ms:.4f} ms ({_rates(flops, ms)}), plain {plain_ms:.4f} ms, SDPA (library) "
                      f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.2f} GFLOP, "
                      f"{nbytes / 1e6:.1f} MB)")
            del mask
        log(
            f"[K1] q [1,32,{q_len},128] kv [1,8,{kv_len},128]{form} bf16 causal+lse, {_fwd_grid(q, k)}: "
            f"|out-oracle| {d_oracle:.3e} (bar {ORACLE_BAR}), |out-plain| {d_plain:.3e} (bar {PLAIN_BAR}), "
            f"row-relative vs plain and oracle {d_rel:.3e} (bar {REL_BAR['bfloat16']}), "
            f"|lse| {d_lse:.3e} (bar {LSE_BAR}), bit-identical over two calls{timing} ({card})"
        )
        if not (d_oracle < ORACLE_BAR and d_plain < PLAIN_BAR and d_rel < REL_BAR["bfloat16"] and d_lse < LSE_BAR):
            raise RuntimeError(f"K1 disagrees at q_len={q_len} kv_len={kv_len}{form}")
        worst_plain = max(worst_plain, d_plain)
        if (q_len, kv_len) in ((256, 2048), (TRAIN_TOKENS, TRAIN_TOKENS)) and slot != 3:
            rep[q_len] = {"max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by}
        del q, k, v, out, lse, kv_in
    # The fp32 body (csrc/flash_fwd.cu) reads kv_batch as an offset: the
    # slot's rows at a length off its tiles, against the plain version.
    _, k_cache, v_cache = make_qkv(4, 8, 1, 1, 128, num_kv_heads=8, kv_seq=512, dtype=torch.float32, device=dev)
    q = make_qkv(5, 1, 32, 64, 128, num_kv_heads=8, kv_seq=300, dtype=torch.float32, device=dev)[0]
    for slot in (2, 7):
        out, lse = flash_attention(q, k_cache[:, :, :300], v_cache[:, :, :300], causal=True, save_residuals=True,
                                   kv_batch=torch.tensor([slot], dtype=torch.int32, device=dev))
        p_out, p_lse = flash_attention_plain(q, k_cache[slot:slot + 1, :, :300], v_cache[slot:slot + 1, :, :300],
                                             causal=True, sm_scale=scale, save_residuals=True)
        d_plain, d_lse = _max_diff(out, p_out), _max_diff(lse, p_lse)
        log(f"[K1] fp32 q [1,32,64,128] kv 300 rows of slot {slot} of an [8,8,512,128] cache by kv_batch: "
            f"|out-plain| {d_plain:.3e} (bar {FP32_PLAIN_BAR}), |lse| {d_lse:.3e} (bar {LSE_BAR})")
        if not (d_plain < FP32_PLAIN_BAR and d_lse < LSE_BAR):
            raise RuntimeError(f"K1 (fp32 body) disagrees at slot {slot} by kv_batch")
    del k_cache, v_cache, q, out, lse, p_out, p_lse
    rep[256]["max_abs_err"] = worst_plain
    entry = {"route": "cuda", "source": "flash_attention_tpu_torch/csrc/flash_fwd_sm90.cu",
             "replaces": f"{REFERENCE}/ops/flash_attention.py:57"}
    return {"K1": {"name": "fwd_kernel, wgmma + TMA (K1)", **entry, **rep[256]},
            "K1t": {"name": f"fwd_kernel, wgmma + TMA (K1), training shape T={TRAIN_TOKENS}", **entry,
                    **rep[TRAIN_TOKENS]}}


# Phase 3's K1q and K1r cases (csrc/flash_fwd_sm90.cu reading a prefill chunk's cache where it lies): 11a's
# dense [8, 8, 2048, 128] cache in each payload, and 17a's ring of RING_ROWS rows (with 4 sinks, 128 rows more).
CACHE_KV_ENDS = (256, 1024, 2048)
RING_KV_ENDS = (256, 4096, 4352, 4608, 9000)


def _ring_oracle(q, k, v, slot: int, kv_end: int, *, window: int, sinks: int, softcap=None):
    """fp32 attention of the chunk q [1, Hq, T, D] at positions [kv_end - T,
    kv_end) over the ring k, v [slots, Hkv, rows, D] of ``slot``: the
    positions it can see (its window's and the sinks') gathered by
    ``_ring_row``, under the explicit causal / window / sinks mask. Returns
    (out, base-2 LSE, the visible pairs, the rows read)."""
    import torch

    t, rows = q.shape[2], k.shape[2]
    positions = sorted(set(range(max(0, kv_end - t - window + 1), kv_end)) | set(range(min(sinks, kv_end))))
    idx = torch.tensor([_ring_row(p, rows, sinks) for p in positions], device=k.device)
    pos = torch.tensor(positions, device=k.device)[None, :]
    row = torch.arange(t, device=k.device)[:, None] + (kv_end - t)
    mask = (pos <= row) & ((pos > row - window) | (pos < sinks))
    k_g, v_g = (x[slot:slot + 1, :, idx] for x in (k, v))
    out, lse = _oracle_mask(q, k_g, v_g, mask, sm_scale=q.shape[-1] ** -0.5, softcap=softcap)
    return out, lse, int(mask.sum()), len(positions)


def _ring_row_mask(*, t: int, rows: int, kv_end: int, window: int, sinks: int, device):
    """[T, rows] bool: which rows of a ring a chunk of T queries at
    positions [kv_end - T, kv_end) sees, each row at the newest position
    written to it below kv_end (``_ring_row``'s layout; the rows between the
    sinks and their 128-row pad hold none): causal, in the window or a
    sink."""
    import torch

    spad = -(-sinks // 128) * 128 if sinks else 0
    ring_mod = rows - spad
    r = torch.arange(rows, device=device)
    j = r - spad
    band = sinks + j + ring_mod * torch.div(kv_end - 1 - sinks - j, ring_mod, rounding_mode="floor")
    pos = torch.where(r < sinks, r, torch.where(r >= spad, band, -1))
    held = (pos >= 0) & (pos < kv_end) & ((r < sinks) | (pos >= sinks))
    row = torch.arange(t, device=device)[:, None] + (kv_end - t)
    return held[None, :] & (pos[None, :] <= row) & ((pos[None, :] > row - window) | (pos[None, :] < sinks))


def _chunk_body_16bit(q, k, v, kv_end: int):
    """csrc/chunk_fwd_sm90.cu's own 16-bit dense instantiation through its C
    entry (``cache_attention`` sends a 16-bit dense slot to K1): q [1, Hq,
    T, D] over slot 0 of k, v [1, Hkv, kv_end, D] in q's dtype, causal, the
    walk split as ``cache_attention`` splits it. Returns (out, base-2 LSE)."""
    import torch

    from flash_attention_tpu_torch.ops import _build
    from flash_attention_tpu_torch.ops.common import LOG2E, sm_count
    from flash_attention_tpu_torch.ops.flash_attention import chunk_splits

    _, hq, t, d = q.shape
    hkv = k.shape[1]
    splits = chunk_splits(hkv, t, hq // hkv, sm_count(q.device))
    k, v = k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((1, hq, t), dtype=torch.float32, device=q.device)
    slot = torch.zeros(1, dtype=torch.int32, device=q.device)
    err = _build.kernels().fat_chunk_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, out.data_ptr(), lse.data_ptr(), slot.data_ptr(), 1, hq,
        hkv, t, kv_end, kv_end, d, q.stride(1), q.stride(2), *k.stride()[:3], *v.stride()[:3],
        _build.int64_array([0] * 6), d ** -0.5 * LOG2E, 0, 0, 0, 0, 0.0, _build.DTYPE_CODES[q.dtype],
        _build.DTYPE_CODES[q.dtype], _build.current_stream(q.device), splits)
    _build.check(err, "the chunk body's 16-bit dense instantiation")
    return out, lse


def chunk_edge_cases(card: str) -> None:
    """Phase 3's edges of csrc/chunk_fwd_sm90.cu (``CHUNK_EDGES``): chunk
    lengths T 1 / 37 / 255 / 256, a kv_end whose walks are shorter than the
    split (shares left empty), sinks on a share's boundary, groups of 1, 3,
    8 and 32, head_dim 64, fp16 queries and every payload, over slot 3 or 7 of caches
    whose slots all hold distinct rows; each twice on the same inputs
    (bit-identical), allocating its output alone, against its plain version
    and the fp32 oracle (the payload dequantized and rounded to the query's
    type as the plain version does) at the bars of the main cases:
    ORACLE_BAR, REL_BAR row-relative of plain and oracle, LSE_BAR."""
    import torch

    from flash_attention_tpu_torch.ops.common import slot_index, sm_count
    from flash_attention_tpu_torch.ops.flash_attention import (
        cache_attention, cache_attention_plain, chunk_q_tiles, chunk_shares, chunk_splits, chunk_walk,
    )
    from flash_attention_tpu_torch.ops.quant import payload_dtype, quantize_values

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(33)
    for i, (label, t, kv_end, form, mode, dtype, d, hq, hkv, sinks, window) in enumerate(CHUNK_EDGES):
        qdt, group = getattr(torch, dtype), hq // hkv
        q = (torch.rand((1, hq, t, d), generator=gen, device=dev) - 0.5).to(qdt)
        rows = {"dense": 2048, "ring": RING_ROWS, "ring64": 384}[form] + (128 if sinks else 0)
        shape = (8, hkv, rows, d)
        if mode is None:
            k, v = ((torch.rand(shape, generator=gen, device=dev) - 0.5).to(qdt) for _ in range(2))
            k_sc = v_sc = None
        else:
            (k, k_sc), (v, v_sc) = (quantize_values(scaled_rows(shape, gen), payload_dtype(mode)) for _ in range(2))
        ring = form != "dense"
        kw = dict(k_scales=k_sc, v_scales=v_sc, ring=ring, sinks=sinks, sliding_window=window)
        slot = (3, 7)[i % 2]
        st = slot_index(slot, 8, dev)
        splits = chunk_splits(hkv, t, group, sm_count(dev))
        what = (f"[K1{'r' if ring else 'q'} edge] {label}: {form} {tuple(shape)}{f', {sinks} sinks' if sinks else ''}"
                f"{f', window {window}' if window else ''}, {mode or dtype}, q {dtype} [1,{hq},{t},{d}], slot {slot}, "
                f"kv_end {kv_end}, {splits} splits")
        walks = [chunk_walk(m0, t, group, kv_end, window=window, sinks=sinks, ring=ring)
                 for m0 in range(0, chunk_q_tiles(t, group) * 128, 128)]
        shares = [chunk_shares(w, splits) for w in walks]
        if "empty" in label and not any([] in sh for sh in shares):
            raise RuntimeError(f"{what}: no share is empty")
        if "boundary" in label and not any(sh[0] and sh[0][-1] < sinks and sh[1] and sh[1][0] >= sinks
                                           for sh in shares):
            raise RuntimeError(f"{what}: no first share ends at the sink tile")

        def call():
            return cache_attention(q, k, v, st, kv_end, save_residuals=True, **kw)

        out, lse = call()
        _same_twice(what, call)
        _no_copy(what, call, out.numel() * out.element_size() + lse.numel() * 4, 2 * hkv * kv_end * d * 2)
        p_out, p_lse = cache_attention_plain(q, k, v, st, kv_end, sm_scale=d ** -0.5, save_residuals=True, **kw)
        kf, vf = (k, v) if mode is None else ((x.float() * sc).to(qdt) for x, sc in ((k, k_sc), (v, v_sc)))
        o_out, o_lse, _, _ = _ring_oracle(q, kf, vf, slot, kv_end, window=window or kv_end, sinks=sinks)
        d_plain, d_rel, d_lse = _hold(what, out, p_out, o_out, lse, p_lse, o_lse, dtype=dtype)
        log(f"{what}: |out-plain| {d_plain:.3e}, |out-oracle| {_max_diff(out, o_out):.3e} (bar {ORACLE_BAR}), "
            f"row-relative vs plain and oracle {d_rel:.3e} (bar {REL_BAR[dtype]}), |lse| {d_lse:.3e} (bar "
            f"{LSE_BAR}), bit-identical over two calls, no copy ({card})")
        del q, k, v, k_sc, v_sc, out, lse, p_out, p_lse, o_out, o_lse, kf, vf


def phase_cache_kernels(card: str) -> dict:
    """Phase 3's K1q and K1r (``ops.flash_attention.cache_attention``): a
    prefill chunk, q [1,32,256,128] bf16, over one slot of a cache read
    where it lies, twice on the same inputs (bit-identical), against its
    plain version (the slot's rows copied out in position order and
    dequantized, then ``flash_attention_plain``; with sinks past the window
    the band and sink passes merged by ``merge_two``) and the fp32 oracle on
    the positions the chunk sees (a payload dequantized as the plain version
    and the JAX package dequantize it: code times scale in fp32, rounded to
    bf16). K1q: 11a's [8, 8, 2048, 128] cache of scaled rows in each
    payload, slots 3 and 7, kv_end 256 / 1024 / 2048. K1r:
    17a's ring of RING_ROWS rows (window 4096) at kv_end RING_KV_ENDS, with
    no sinks and with 4 (a ring of 128 rows more), softcap 50 once, and an
    int8 ring; every slot holds distinct rows; K1q also equal, output and
    LSE bit for bit, to csrc/chunk_fwd_sm90.cu's own 16-bit dense
    instantiation over the plain version's dequantized copy
    (``_chunk_body_16bit``). Then the body's edges (``chunk_edge_cases``),
    and the fp32 body (csrc/flash_fwd.cu) at small shapes against the plain
    version. Each call allocates its output alone (no copy of the cache).
    Returns the
    kernels' line entries "K1q" (int8, kv_end 2048) and "K1r" (kv_end 9000,
    no sinks; its library call SDPA over the slot's ring under a boolean
    mask of its rows)."""
    import torch
    import torch.nn.functional as F

    from flash_attention_tpu_torch.ops.common import slot_index
    from flash_attention_tpu_torch.ops.flash_attention import cache_attention, cache_attention_plain
    from flash_attention_tpu_torch.ops.quant import payload_dtype, quantize_values
    from flash_attention_tpu_torch.ops.reference import reference_attention_with_lse

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)
    scale = 128 ** -0.5
    q = (torch.rand((1, 32, 256, 128), generator=gen, device=dev) - 0.5).to(torch.bfloat16)
    rep = {}

    def run(what, k, v, slot, kv_end, **kw):
        """The kernel twice, its plain version, and both timed."""
        st = slot_index(slot, k.shape[0], dev)

        def call():
            return cache_attention(q_in, k, v, st, kv_end, save_residuals=True, **kw)

        q_in = kw.pop("q", q)
        out, lse = call()
        _same_twice(what, call)
        _no_copy(what, call, out.numel() * out.element_size() + lse.numel() * 4, 2 * k.shape[1] * kv_end * 128 * 2)
        p_out, p_lse = cache_attention_plain(q_in, k, v, st, kv_end, sm_scale=q_in.shape[-1] ** -0.5,
                                             save_residuals=True, **kw)
        return call, out, lse, p_out, p_lse

    # K1q: 11a's dense cache, each payload.
    for mode in QUANT_MODES:
        k_x, v_x = scaled_rows((8, 8, 2048, 128), gen), scaled_rows((8, 8, 2048, 128), gen)
        (kp, ks), (vp, vs) = (quantize_values(x, payload_dtype(mode)) for x in (k_x, v_x))
        del k_x, v_x
        for slot in (3, 7):
            for kv_end in CACHE_KV_ENDS:
                what = f"[K1q] {mode} slot {slot} of [8,8,2048,128], kv_end {kv_end}"
                call, out, lse, p_out, p_lse = run(what, kp, vp, slot, kv_end, k_scales=ks, v_scales=vs)
                k_f, v_f = ((x[slot:slot + 1, :, :kv_end].float() * sc[slot:slot + 1, :, :kv_end])
                            .to(torch.bfloat16).float() for x, sc in ((kp, ks), (vp, vs)))
                o_out, o_lse = reference_attention_with_lse(q.float(), k_f, v_f, causal=True)
                d_plain, d_oracle, d_rel, d_lse = _hold_quant(what, out, p_out, o_out, lse, p_lse, o_lse)
                # The widen rounds each dequantized row as the plain version does, so the body's 16-bit dense
                # instantiation over that copy reads the same tiles on the same split: its output and LSE must
                # be K1q's bit for bit.
                k_b, v_b = (x.to(torch.bfloat16) for x in (k_f, v_f))
                b_out, b_lse = _chunk_body_16bit(q, k_b, v_b, kv_end)
                if not (torch.equal(b_out, out) and torch.equal(b_lse, lse)):
                    raise RuntimeError(f"{what}: the body's 16-bit instantiation over the dequantized copy differs "
                                       f"from K1q")
                del b_out, b_lse
                timing = ""
                if mode == "int8" and slot == 7 and kv_end == 2048:
                    ms = cuda_ms(call)
                    plain_ms = cuda_ms(lambda: cache_attention_plain(
                        q, kp, vp, slot_index(slot, 8, dev), kv_end, sm_scale=scale, k_scales=ks, v_scales=vs))
                    flops = 4 * 128 * 32 * causal_pairs(256, kv_end)
                    nbytes = 2 * (2 * q.numel()) + 4 * lse.numel() + 2 * 8 * kv_end * (128 + 4)
                    bound_ms, bound_by = bound(flops, nbytes)
                    rep["K1q"] = {"max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                                  "bound_ms": bound_ms, "bound_by": bound_by}
                    timing = (f"; kernel {ms:.4f} ms ({_rates(flops, ms)}), plain {plain_ms:.4f} ms, library none, "
                              f"bound {bound_ms:.4f} ms by {bound_by}")
                log(f"{what}: |out-plain| {d_plain:.3e}, |out-oracle| {d_oracle:.3e} (bar {ORACLE_BAR}), "
                    f"row-relative vs plain and oracle {d_rel:.3e} (bar {REL_BAR['bfloat16']}), |lse| "
                    f"{d_lse:.3e} (bar {LSE_BAR}), bit-identical over two calls{timing} ({card})")
                del out, lse, p_out, p_lse, o_out, o_lse, k_f, v_f
        del kp, ks, vp, vs

    # K1r: 17a's ring, with and without sinks; softcap once; an int8 ring.
    cases = [(sinks, kv_end, None, None) for sinks in (0, SINKS) for kv_end in RING_KV_ENDS]
    cases += [(0, 9000, 50.0, None), (SINKS, 9000, None, "int8")]
    rings = {}
    for i, (sinks, kv_end, softcap, mode) in enumerate(cases):
        rows = RING_ROWS + (128 if sinks else 0)
        if (sinks, mode) not in rings:
            rings.clear()
            if mode is None:
                rings[sinks, mode] = [(torch.rand((8, 8, rows, 128), generator=gen, device=dev) - 0.5)
                                      .to(torch.bfloat16) for _ in range(2)]
            else:
                rings[sinks, mode] = [x for _ in range(2)
                                      for x in quantize_values(scaled_rows((8, 8, rows, 128), gen), payload_dtype(mode))]
        kw = dict(ring=True, sinks=sinks, sliding_window=WINDOW, logit_softcap=softcap)
        if mode:
            k, k_sc, v, v_sc = rings[sinks, mode]
            kw.update(k_scales=k_sc, v_scales=v_sc)
        else:
            k, v = rings[sinks, mode]
        slot = (3, 7)[i % 2]
        what = (f"[K1r] ring of {rows} rows{f', {sinks} sinks' if sinks else ''}"
                f"{f', softcap {softcap:g}' if softcap else ''}{f', {mode}' if mode else ''}, slot {slot}, "
                f"kv_end {kv_end}")
        call, out, lse, p_out, p_lse = run(what, k, v, slot, kv_end, **kw)
        kf, vf = (k, v) if mode is None else ((x.float() * sc).to(torch.bfloat16) for x, sc in ((k, k_sc), (v, v_sc)))
        o_out, o_lse, pairs, n_rows = _ring_oracle(q, kf, vf, slot, kv_end, window=WINDOW, sinks=sinks,
                                                   softcap=softcap)
        if mode:
            d_plain, d_oracle, d_rel, d_lse = _hold_quant(what, out, p_out, o_out, lse, p_lse, o_lse)
        else:
            d_plain, d_rel, d_lse = _hold(what, out, p_out, o_out, lse, p_lse, o_lse)
            d_oracle = _max_diff(out, o_out)
        timing = ""
        if kv_end == 9000 and mode is None and softcap is None:
            ms = cuda_ms(call)
            plain_ms = cuda_ms(lambda: cache_attention_plain(q, k, v, slot_index(slot, 8, dev), kv_end, sm_scale=scale,
                                                             **kw))
            # The library call: SDPA over the slot's ring as it lies, under a boolean mask of the ring's rows
            # (attention does not depend on the keys' order), built outside the timed call.
            mask = _ring_row_mask(t=q.shape[2], rows=rows, kv_end=kv_end, window=WINDOW, sinks=sinks, device=dev)
            k_s, v_s = k[slot:slot + 1], v[slot:slot + 1]

            def sdpa():
                return F.scaled_dot_product_attention(q, k_s, v_s, attn_mask=mask, enable_gqa=True)

            d_lib = _max_diff(sdpa(), o_out)
            if not d_lib < ORACLE_BAR:
                raise RuntimeError(f"{what}: SDPA over the ring's row mask is {d_lib:.3e} from the oracle")
            lib_ms = cuda_ms(sdpa)
            flops = 4 * 128 * 32 * pairs
            nbytes = 2 * (2 * q.numel()) + 4 * lse.numel() + 2 * 2 * 8 * n_rows * 128
            bound_ms, bound_by = bound(flops, nbytes)
            if sinks == 0:
                rep["K1r"] = {"max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                              "bound_ms": bound_ms, "bound_by": bound_by}
            timing = (f"; kernel {ms:.4f} ms ({_rates(flops, ms)}), plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms "
                      f"(SDPA, boolean mask over the ring's rows; |sdpa-oracle| {d_lib:.3e}), bound "
                      f"{bound_ms:.4f} ms by {bound_by} ({pairs} pairs, {n_rows} rows)")
            del mask
        log(f"{what}: |out-plain| {d_plain:.3e}, |out-oracle| {d_oracle:.3e} (bar {ORACLE_BAR}), row-relative vs "
            f"plain and oracle {d_rel:.3e} (bar {REL_BAR['bfloat16']}), |lse| {d_lse:.3e} (bar {LSE_BAR}), "
            f"bit-identical over two calls{timing} ({card})")
        del out, lse, p_out, p_lse, o_out, o_lse, kf, vf
    rings.clear()
    chunk_edge_cases(card)

    # The fp32 body (csrc/flash_fwd.cu): K1q over an int8 cache, K1r over a ring with 32 sinks, window 96.
    qf = torch.rand((1, 4, 64, 32), generator=gen, device=dev) - 0.5
    (kp, ks), (vp, vs) = (quantize_values(scaled_rows((3, 2, 192, 32), gen), torch.int8) for _ in range(2))
    ring_k, ring_v = (torch.rand((3, 2, 384, 32), generator=gen, device=dev) - 0.5 for _ in range(2))
    for what, k, v, kv_end, kw in (
            ("[K1q] fp32, int8 slot 2 of [3,2,192,32], kv_end 150", kp, vp, 150, dict(k_scales=ks, v_scales=vs)),
            ("[K1r] fp32, ring of 384 rows, 32 sinks, window 96, slot 2, kv_end 700", ring_k, ring_v, 700,
             dict(ring=True, sinks=32, sliding_window=96))):
        out, lse = cache_attention(qf, k, v, 2, kv_end, save_residuals=True, **kw)
        p_out, p_lse = cache_attention_plain(qf, k, v, slot_index(2, 3, dev), kv_end, sm_scale=32 ** -0.5,
                                             save_residuals=True, **kw)
        d_plain, d_lse = _max_diff(out, p_out), _max_diff(lse, p_lse)
        log(f"{what}: |out-plain| {d_plain:.3e} (bar {FP32_PLAIN_BAR}), |lse| {d_lse:.3e} (bar {LSE_BAR})")
        if not (d_plain < FP32_PLAIN_BAR and d_lse < LSE_BAR):
            raise RuntimeError(f"{what} (fp32 body) disagrees")
    entry = {"route": "cuda", "source": "flash_attention_tpu_torch/csrc/chunk_fwd_sm90.cu",
             "replaces": f"{REFERENCE}/ops/flash_attention.py:57"}
    return {"K1q": {"name": "chunk_fwd_kernel, a GQA group's rows over a slot of a dense int8 cache in place, the "
                            "walk over a cluster (K1q)", **entry, **rep["K1q"]},
            "K1r": {"name": f"chunk_fwd_kernel, a GQA group's rows over a slot of a {RING_ROWS}-row ring in place, "
                            f"the walk over a cluster (K1r)", **entry, **rep["K1r"]}}


def phase_k6(card: str) -> dict:
    """K6 at the decode shape: q [8,32,128] against a [8,8,2048,128] cache,
    its kv split printed; output and LSE held against plain (also row by
    row) and the oracle, bit-identical over two calls and under a CUDA
    graph's replay."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from flash_attention_tpu_torch.ops.decode import decode_attention, decode_attention_plain
    from flash_attention_tpu_torch.ops.reference import reference_attention_with_lse

    dev = torch.device("cuda")
    rng = np.random.default_rng(6)

    def uniform(shape):
        return torch.from_numpy(rng.uniform(-0.5, 0.5, shape).astype(np.float32)).to(dev, torch.bfloat16)

    q = uniform((8, 32, 128))
    k_cache, v_cache = uniform((8, 8, 2048, 128)), uniform((8, 8, 2048, 128))
    lengths = torch.tensor([0, 1, 255, 256, 1000, 2047, 2048, 7], dtype=torch.int32, device=dev)
    (out, lse), grid = _twice("K6", decode_attention, lambda: decode_attention(q, k_cache, v_cache, lengths,
                                                                               save_residuals=True))
    p_out, p_lse = decode_attention_plain(q, k_cache, v_cache, lengths, sm_scale=1.0 / 128**0.5, save_residuals=True)
    o_out, o_lse = reference_attention_with_lse(q[:, :, None, :], k_cache, v_cache, kv_length=lengths)
    o_out, o_lse = o_out[:, :, 0], o_lse[:, :, 0]
    torch.cuda.synchronize()
    d_oracle, d_plain = _max_diff(out, o_out), _max_diff(out, p_out)
    d_rel = max(_rel_diff(out, p_out), _rel_diff(out, o_out))
    d_lse = max(_max_diff(lse, p_lse), _max_diff(lse, o_lse))
    if not bool((out[0] == 0).all()):
        raise RuntimeError("K6: an empty slot (length 0) must give output 0")
    same = _graph_replays(lambda: decode_attention(q, k_cache, v_cache, lengths, save_residuals=True), (out, lse))
    ms = cuda_ms(lambda: decode_attention(q, k_cache, v_cache, lengths))
    plain_ms = cuda_ms(lambda: decode_attention_plain(q, k_cache, v_cache, lengths, sm_scale=1.0 / 128**0.5))
    # The library yardstick: one SDPA call with a length mask (the empty
    # slot's row comes out NaN there; it is timed, not compared).
    mask = (torch.arange(2048, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], k_cache, v_cache, attn_mask=mask, enable_gqa=True))
    rows = int(lengths.sum())
    flops = 4 * 128 * 32 * rows
    nbytes = 2 * (2 * rows * 8 * 128) + 2 * (2 * q.numel()) + 4 * lengths.numel()  # K+V rows, q+out, bf16
    bound_ms, bound_by = bound(flops, nbytes)
    log(
        f"[K6] q [8,32,128] cache [8,8,2048,128] bf16 lengths {lengths.tolist()}, {grid}: "
        f"|out-oracle| {d_oracle:.3e} (bar {ORACLE_BAR}), |out-plain| {d_plain:.3e} (bar {PLAIN_BAR}), row-relative "
        f"vs plain and oracle {d_rel:.3e} (bar {REL_BAR['bfloat16']}), |lse| {d_lse:.3e} (bar {LSE_BAR}); "
        f"bit-identical over two calls, CUDA graph replay equal to the call: {same}; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA (library) {lib_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB) ({card})"
    )
    if not (d_oracle < ORACLE_BAR and d_plain < PLAIN_BAR and d_rel < REL_BAR["bfloat16"] and d_lse < LSE_BAR
            and same):
        raise RuntimeError("K6 disagrees")
    return {
        "name": "decode (K6)", "route": "cuda",
        "source": "flash_attention_tpu_torch/csrc/decode.cu",
        "replaces": f"{REFERENCE}/ops/decode.py:56",
        "max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms,
        "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
    }


def _twice(what: str, wrapper, call):
    """``call`` (a decode wrapper's call returning (out, lse)) run twice:
    the two results must be bit-identical (the kv split merges in a fixed
    order). Returns the first result and the split count and blocks of its
    launch (``wrapper.last_grid``) as text."""
    import torch

    first, second = call(), call()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise RuntimeError(f"{what}: two calls on the same inputs differ")
    splits, blocks = wrapper.last_grid
    return first, f"kv split {splits}, {blocks} blocks"


def _graph_replays(call, want) -> bool:
    """Whether ``call`` captured in a CUDA graph and replayed twice gives
    ``want`` (its direct result) both times: the split merge's ticket
    counters reset themselves."""
    import torch

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = call()
    same = True
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        same = same and all(torch.equal(a, b) for a, b in zip(got, want))
    return same


def phase_kernel_sweep() -> None:
    """Every (dtype, head_dim) instantiation of both kernels at ragged
    shapes: Sq and Skv off the 64-row tiles, causal and not, GQA groups of
    1, 4 and 16 (K6 spreads a group over 8-row blocks)."""
    import torch

    from flash_attention_tpu_torch.ops.decode import decode_attention, decode_attention_plain
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from flash_attention_tpu_torch.ops.reference import reference_attention
    from flash_attention_tpu_torch.utils.testing import make_qkv

    plain_bar = {torch.float32: 1e-4, torch.float16: PLAIN_BAR, torch.bfloat16: PLAIN_BAR}
    worst = 0.0
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        for d in (32, 64, 128):
            for hq, hkv in ((4, 4), (4, 1), (16, 1)):
                q, k, v = make_qkv(d, 2, hq, 100, d, num_kv_heads=hkv, kv_seq=130, dtype=dtype, device="cuda")
                for causal in (True, False):
                    out = flash_attention(q, k, v, causal=causal)
                    plain = flash_attention_plain(q, k, v, causal=causal, sm_scale=d**-0.5, save_residuals=False)
                    d_oracle = _max_diff(out, reference_attention(q, k, v, causal=causal))
                    d_plain = _max_diff(out, plain)
                    if not (d_oracle < ORACLE_BAR and d_plain < plain_bar[dtype]):
                        raise RuntimeError(f"K1 {dtype} d={d} {hq}/{hkv} causal={causal}: {d_oracle} {d_plain}")
                    worst = max(worst, d_plain / plain_bar[dtype])
                lengths = torch.tensor([0, 130], dtype=torch.int32, device="cuda")
                out = decode_attention(q[:, :, 0], k, v, lengths)
                plain = decode_attention_plain(q[:, :, 0], k, v, lengths, sm_scale=d**-0.5)
                want = reference_attention(q[:, :, :1], k, v, kv_length=lengths)[:, :, 0]
                d_oracle, d_plain = _max_diff(out, want), _max_diff(out, plain)
                if not (d_oracle < ORACLE_BAR and d_plain < plain_bar[dtype]):
                    raise RuntimeError(f"K6 {dtype} d={d} {hq}/{hkv}: {d_oracle} {d_plain}")
                worst = max(worst, d_plain / plain_bar[dtype])
    log(
        "[sweep] K1 and K6 at fp32/fp16/bf16 x head_dim 32/64/128 x groups 1/4/16, ragged shapes: "
        f"all within 0.1 of the oracle; worst |kernel-plain| at {worst:.3f} of its bar "
        f"(fp32 1e-4, fp16/bf16 {PLAIN_BAR})"
    )


def _tensors(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples (NamedTuples: caches,
    QuantizedTensors), skipping None."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _tensors(sub)]
    return [] if tree is None else [tree]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    if isinstance(tree, tuple):  # a QuantizedTensor
        return type(tree)(*(_to_device(v, device) for v in tree))
    return tree.to(device)


def _registry():
    """``ops.counters``, every kernel wrapper's module imported so that each
    has registered its counters: a wrapper counts the launches over an
    unquantized cache as K6, K7, ... and those over a quantized one as K6q,
    K7q, ...; the forward counts K1d (segment ids) apart, the backward
    launchers their masked instantiations (K3m, K4m, K5m: a window, softcap or
    segment ids), and K5's split sum counts as K5s; the probes' bodies T and S
    count as PT and PS. The forward wrappers count their launches by body as
    well: csrc/flash_fwd_sm90.cu's tensor cores, or csrc/flash_fwd.cu's FMA
    body (fp32)."""
    import flash_attention_tpu_torch.ops.paged  # noqa: F401  (imports the other ops wrappers)
    import flash_attention_tpu_torch.tools.probes  # noqa: F401
    from flash_attention_tpu_torch.ops import counters

    return counters


def zero_counts() -> None:
    _registry().zero()


def read_counts() -> dict:
    return _registry().read()


def read_bodies() -> dict:
    """The forward launches since zero_counts by wrapper and body."""
    return _registry().read_bodies()


# CUPTI drops a few device records a trace (about one in 10^4 in the profiles of PR 16 runs 9 and 10, of any
# kernel), and the same record of the same sequence each time (24(c)'s paged block: 511 of 512 K7 records in
# five traces of run 10). So a trace short of the counted launches is taken again, at most this many times,
# each time behind a few more padding launches, which moves the sequence's records against the drops.
TRACE_ATTEMPTS = 5
TRACE_PAD = 3  # padding launches (an add to a one-element tensor) added before each further attempt


def traced_launches(what: str, replay, names: list | None = None):
    """``replay()`` (one replay of a decode program, and whatever resets its
    inputs) under torch.profiler, device activity only, synchronised before
    and after: the kernel records of the trace, by group of kernels that run
    the same CUDA functions (``ops.counters.traced``), must equal the
    launches that the replay added to the counts. A replay runs no wrapper:
    it adds what its capture counted, and this holds that against what the
    card ran. A trace can lack a record that CUPTI dropped but holds none
    that did not run, so no attempt may trace more than was counted, and one
    of TRACE_ATTEMPTS must trace all of it, attempt i behind TRACE_PAD * (i -
    1) padding launches. Returns the last attempt's result, the launches by
    group and the attempts taken; ``names``, when given, receives the
    device records' names of the attempt that traced all of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    registry, short = _registry(), []
    pad = torch.zeros(1, device="cuda")
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        before = read_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_PAD * (attempt - 1)):
                pad.add_(1)
            out = replay()
            torch.cuda.synchronize()
        gained = {name: n - before[name] for name, n in read_counts().items()}
        # The profiler's raw records: building its FunctionEvents for a block's ~60,000 records takes seconds.
        records = [e.name() for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA]
        traced = registry.traced(records)
        counted = {kernels: sum(gained[k] for k in kernels) for kernels in traced}
        parted = {"/".join(k): (traced[k], counted[k]) for k in traced if traced[k] != counted[k]}
        if any(traced[k] > counted[k] for k in traced):
            raise RuntimeError(f"{what}: more kernel records in the device trace than counted launches, (traced, "
                               f"counted) by kernels: {parted}")
        if not parted:
            if names is not None:
                names[:] = records
            return out, {"/".join(k): n for k, n in traced.items() if n}, attempt
        short.append(parted)
    raise RuntimeError(f"{what}: every one of {TRACE_ATTEMPTS} device traces lacks counted launches, (traced, counted) "
                       f"by kernels: {short}")


def check_tensor_cores(what: str, bodies: dict, wrapper: str | None = None) -> None:
    """Every bf16 / fp16 forward launch counted in ``bodies`` (``read_bodies``)
    ran the tensor-core body, none the FMA body, and every K1q / K1r launch
    csrc/chunk_fwd_sm90.cu over a cluster (at every chunk of the main paths,
    64 or fewer (kv head, q tile) blocks, ``chunk_splits`` cuts the walk
    over 2 or more blocks on an H100); with ``wrapper`` ("K1/K1d/K2",
    "K1q/K1r" or "K8/K8q"), that wrapper launched at least once."""
    fma = {k: n for k, n in bodies.items() if k.endswith(" fma") and n}
    if fma or (wrapper is not None and bodies[f"{wrapper} tensor_core"] < 1):
        raise RuntimeError(f"{what}: forward launches by body {bodies}; want the tensor-core body only")
    if bodies["K1q/K1r cluster"] != bodies["K1q/K1r tensor_core"]:
        raise RuntimeError(f"{what}: forward launches by body {bodies}; want every K1q / K1r launch over a cluster")


def check_launches(what: str, launches: dict, used) -> None:
    """The path launched every kernel in ``used`` and no other."""
    missing = [k for k in used if launches[k] < 1]
    stray = [k for k, n in launches.items() if n and k not in used]
    if missing or stray:
        raise RuntimeError(f"{what}: kernels {missing} not launched, {stray} launched: {launches}")


def check_self_term(what: str, launches: dict, bodies: dict) -> None:
    """Every K7 / K7q launch of a deferred paged decode path merged the
    current token's self term in the launch (F4: ``self_kv``), and some did."""
    paged = launches["K7"] + launches["K7q"]
    if not paged or bodies["K7/K7q self"] != paged:
        raise RuntimeError(f"{what}: {bodies['K7/K7q self']} K7 / K7q launches with the self term of {paged}")


def counting_chunks(eng, run):
    """``run()`` with the prefill chunks this process runs on ``eng``
    counted (each call of ``_prefill_chunk_step``): (its result, the count)."""
    inner, ran = eng._prefill_chunk_step, [0]

    def step(*args):
        ran[0] += 1
        return inner(*args)

    eng._prefill_chunk_step = step
    try:
        return run(), ran[0]
    finally:
        eng._prefill_chunk_step = inner


def check_chunk_rope(what: str, launches: dict, layers: int, chunks: int) -> None:
    """Each prefill chunk of the run launched F2's chunk form (F2c: RoPE and
    the cache write) once a layer, and the decode form F2 none for it."""
    if not chunks or launches["F2c"] != layers * chunks:
        raise RuntimeError(f"{what}: {launches['F2c']} F2c launches for {chunks} prefill chunks of {layers} layers; "
                           "want one a layer a chunk")


def replayed_tokens(what: str, eng, reqs) -> dict:
    """``eng.run(reqs)``'s tokens by id, the launch counts set to 0 just
    before the run. On the card ``warmup()`` first, so that every prefill
    chunk and every decode block of the run replays a program built there:
    the run must capture none and replay one a chunk and one a block."""
    card = eng.device.type == "cuda"
    programs = {"prefill": (eng.prefill_programs, "chunk"), "decode": (eng.programs, "decode")}
    if card:
        eng.warmup()
        before = {name: (progs.captures, progs.replays) for name, (progs, _) in programs.items()}
    zero_counts()
    done = eng.run(reqs)
    if card:
        for name, (progs, event) in programs.items():
            runs = sum(1 for e in eng.events if e[0] == event)
            got = (progs.mode, progs.captures - before[name][0], progs.replays - before[name][1])
            if not runs or got != ("graph", 0, runs):
                raise RuntimeError(f"{what}: {name} programs (mode, captures, replays) in the run {got}, want "
                                   f"('graph', 0, {runs}): one replay a {event}")
    return {rid: c.tokens for rid, c in done.items()}


def _bits_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a.reshape(-1).view(torch.uint8),
                                                                     b.reshape(-1).view(torch.uint8))


def _cache_tensors(eng) -> list:
    """Every tensor of the engine's caches once (a dense engine's layers
    share one lengths tensor; a paged pool's layer views are the pool)."""
    return list({id(t): t for t in _tensors(eng.caches)}.values())


def hold_programs(label: str, eng, w1_per_step: int | None = None) -> None:
    """The engine's k = decode_block_steps block replayed against its eager
    body (``DecodePrograms.block``) from identical copies of the caches,
    greedy and sampled: the tokens, the last-token buffer and every cache
    tensor bit-identical. Every slot active, at lengths from max_seq - k
    down by 131 rows a slot; a paged engine's table first set to distinct
    pages of the pool a slot (a ring laid out as the engine lays it); the
    sampled block at phase 5's sampling rows. The greedy replay, the main
    paths' key, is traced: its kernel records must equal the launches it
    added to the counts (``traced_launches``; a trace of a block's ~60,000
    records costs ~16 s of post-processing, so the sampled one is not; it
    must count one S1 launch a step). With ``w1_per_step``, the traced
    greedy block must hold exactly that many W1 launches a step (an
    int8-weight model: one group launch for q / k / v, one for gate / up,
    wo and w_down a layer, and the unembed's).
    Called after the main path: it leaves the caches as the eager block
    wrote them."""
    import numpy as np
    import torch

    progs, slots, k = eng.programs, eng.max_slots, eng.decode_block_steps
    if progs.mode != "graph":
        raise RuntimeError(f"[{label}] decode programs in mode {progs.mode!r}, want 'graph'")
    rng = np.random.default_rng(16)
    cfg = eng.cfg
    if hasattr(eng, "page_size"):
        n_ring = eng.pages_per_slot
        if cfg.sliding_window is not None:
            n_ring = -(-(cfg.sliding_window + eng.chunk) // eng.page_size) + 2
        table, _ = _ring_table(rng, slots, eng.pages_per_slot, n_ring, sinks=bool(cfg.attention_sinks))
        eng.caches.page_table.copy_(torch.from_numpy(table))
    lengths = np.maximum(1, eng.max_seq - k - 131 * np.arange(slots)).astype(np.int32)
    eng._lengths_of(eng.caches).copy_(torch.from_numpy(lengths))
    live = _cache_tensors(eng)
    start = [t.clone() for t in live]
    last = rng.integers(0, cfg.vocab_size, slots).astype(np.int32)
    rows = {key: np.resize(t.numpy(), slots) for key, t in _sampling_inputs(0).items()}
    t0 = time.perf_counter()
    for greedy in (True, False):
        temps = np.zeros(slots, np.float32) if greedy else rows["temperature"]

        def reset():
            for t, s0 in zip(live, start):
                t.copy_(s0)
            progs.upload(last, np.ones(slots, bool), temps, rows["top_k"], rows["top_p"], rows["seeds"])

        if (k, greedy) not in progs.built():
            reset()
            progs.run(k, greedy)  # the key's eager block, then its capture

        def replay(greedy=greedy, reset=reset):
            reset()
            replays = progs.replays
            toks = progs.run(k, greedy).clone()
            if progs.replays != replays + 1:
                raise RuntimeError(f"[{label}] the k={k} block (greedy={greedy}) did not replay")
            return toks

        if greedy:
            toks, traced, attempts = traced_launches(f"[{label}] the replayed k={k} greedy block", replay)
            if w1_per_step is not None and traced.get("W1", 0) != k * w1_per_step:
                raise RuntimeError(f"[{label}] the replayed k={k} greedy block traced {traced.get('W1', 0)} W1 "
                                   f"launches, want {w1_per_step} a step")
        else:
            s1 = read_counts()["S1"]
            toks = replay()
            if read_counts()["S1"] - s1 != k:
                raise RuntimeError(f"[{label}] the replayed k={k} sampled block counted {read_counts()['S1'] - s1} S1 "
                                   f"launches, want one a step")
        replayed = [toks, progs.last.clone()] + [t.clone() for t in live]
        reset()
        eager = [progs.block(k, greedy), progs.last] + live
        if not all(_bits_equal(a, b) for a, b in zip(replayed, eager)):
            parted = [i for i, (a, b) in enumerate(zip(replayed, eager)) if not _bits_equal(a, b)]
            raise RuntimeError(f"[{label}] the replayed k={k} block (greedy={greedy}) differs from its eager body in "
                               f"tensors {parted} (0: tokens, 1: last tokens, then the caches')")
        del replayed, eager
    torch.cuda.synchronize()
    log(f"[{label}] decode programs: the k={k} block replayed == its eager body, greedy and sampled, tokens and "
        f"{len(live)} cache tensors ({_nbytes(live) / 1e9:.3f} GB) bit for bit; mode {progs.mode}, {progs.captures} "
        f"programs, {progs.replays} replays so far; the sampled replay counted one S1 launch a step; kernel records in "
        f"the greedy replay's device trace == the launches it counted, {traced} (traces taken {attempts}); the hold "
        f"took {time.perf_counter() - t0:.1f} s")


def hold_prefill_programs(label: str, eng, keys=None) -> None:
    """Each prefill program the engine built (``PrefillPrograms``, one a
    (T, kv_end) key), or each of ``keys``, replayed against its eager body
    (``PrefillPrograms.chunk``) from identical copies of the caches, at two
    slots, so at least one is not the slot its key was captured at: the
    logits and every cache tensor, the lengths included, bit-identical. The
    chunk's tokens are random; a paged engine's table first gets distinct
    pages of the pool a slot (a ring laid out as the engine lays it), so
    every slot reads and writes pages of its own. One replay, the largest
    key's, is traced: its kernel records must equal the launches it added to
    the counts (``traced_launches``), and it must hold no device operation
    of a cache read as plain PyTorch (``smoke_cases.CHUNK_GROUPS``' "cache
    gathers and dequant": the kernels read the cache in place), one F2c
    record a layer (RoPE and the cache write), no F2 record and none of the
    write's operations as plain PyTorch (``smoke_cases.WRITE_OPS``: the
    positions' arange, the index assignments, the lengths' index_fill_, the
    quantizer's abs and round), and at most
    one strided bf16 copy a layer (o's transpose: ``wo`` is read through its
    [H * D, M] view, not permuted into a copy); over a quantized dense cache
    or the ring in bf16 / fp16 its attention is one csrc/chunk_fwd_sm90.cu
    record a layer (K1q, K1r) and no csrc/flash_fwd_sm90.cu one. Called
    after the main path: it leaves the caches as the last eager chunk wrote
    them."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.tools.smoke_cases import WRITE_OPS, chunk_group

    progs, slots = eng.prefill_programs, eng._slot_hi - eng._slot_lo
    keys = sorted(progs.built() if keys is None else keys, key=lambda key: (key[1], key[0]))
    if progs.mode != "graph" or not keys or not progs.built().issuperset(keys):
        raise RuntimeError(f"[{label}] prefill programs in mode {progs.mode!r}, {len(progs.built())} built, "
                           f"{len(keys)} to hold; want 'graph' and every key to hold built")
    rng = np.random.default_rng(21)
    cfg = eng.cfg
    if hasattr(eng, "page_size"):
        n_ring = eng.pages_per_slot
        if cfg.sliding_window is not None:
            n_ring = -(-(cfg.sliding_window + eng.chunk) // eng.page_size) + 2
        table, _ = _ring_table(rng, slots, eng.pages_per_slot, n_ring, sinks=bool(cfg.attention_sinks))
        eng.caches.page_table.copy_(torch.from_numpy(table))
    live = _cache_tensors(eng)
    start = [t.clone() for t in live]
    pair = (1 % slots, slots - 1)
    t0 = time.perf_counter()
    traced, names = None, []
    for key in keys:
        t, kv_end = key
        tokens = rng.integers(0, cfg.vocab_size, (1, t)).astype(np.int32)
        for slot in pair:
            def replay(slot=slot, tokens=tokens, kv_end=kv_end, key=key):
                for x, x0 in zip(live, start):
                    x.copy_(x0)
                replays = progs.replays
                logits = progs.run(tokens, slot, kv_end).clone()
                if progs.replays != replays + 1:
                    raise RuntimeError(f"[{label}] the prefill program {key} did not replay")
                return logits

            if key == keys[-1] and slot == pair[-1]:
                logits, traced, attempts = traced_launches(f"[{label}] the replayed prefill chunk {key}", replay,
                                                           names)
            else:
                logits = replay()
            replayed = [logits] + [x.clone() for x in live]
            for x, x0 in zip(live, start):
                x.copy_(x0)
            progs.slot.fill_(slot)
            eager = [progs.chunk(t, kv_end)] + live
            if not all(_bits_equal(a, b) for a, b in zip(replayed, eager)):
                parted = [i for i, (a, b) in enumerate(zip(replayed, eager)) if not _bits_equal(a, b)]
                raise RuntimeError(f"[{label}] the prefill program {key} replayed at slot {slot} differs from its "
                                   f"eager body in tensors {parted} (0: logits, then the caches')")
            del replayed, eager
    torch.cuda.synchronize()
    groups = [chunk_group(name) for name in names]
    reads, copies = groups.count("cache gathers and dequant"), groups.count("strided bf16 copies")
    chunk_body = sum(1 for name in names if re.search(r"(?:^|[\s:])chunk_fwd_kernel<", name))
    old_body = sum(1 for name in names if re.search(r"(?:^|[\s:])fwd_kernel<", name))
    if not hasattr(eng, "page_size") and cfg.dtype in ("bfloat16", "float16") and (cfg.rolling or
                                                                                    cfg.kv_quant != "none"):
        if chunk_body != cfg.num_layers or old_body:
            raise RuntimeError(f"[{label}] the replayed {keys[-1]} chunk ran {chunk_body} chunk_fwd_kernel and "
                               f"{old_body} fwd_kernel records; want one chunk_fwd_kernel (K1q / K1r) a layer")
    writes = sorted({n[:100] for n in names if any(op in n for op in WRITE_OPS)})
    if traced.get("F2c", 0) != cfg.num_layers or traced.get("F2", 0) or writes:
        raise RuntimeError(f"[{label}] the replayed {keys[-1]} chunk traced {traced.get('F2c', 0)} F2c and "
                           f"{traced.get('F2', 0)} F2 records and the write operations {writes}; want one F2c a "
                           "layer (RoPE and the cache write) and nothing else of the write")
    if reads or copies > cfg.num_layers:
        raise RuntimeError(f"[{label}] the replayed {keys[-1]} chunk ran {reads} cache gather or dequant operations "
                           f"(want 0) and {copies} strided bf16 copies (want at most one a layer, o's transpose): "
                           f"{sorted({n[:100] for n, g in zip(names, groups) if g in ('cache gathers and dequant', 'strided bf16 copies')})}")
    log(f"[{label}] prefill programs: {len(keys)} (T, kv_end) keys {keys[0]}..{keys[-1]}, each replayed at slots "
        f"{pair} == its eager body, logits and {len(live)} cache tensors ({_nbytes(live) / 1e9:.3f} GB) bit for bit; "
        f"mode {progs.mode}, {progs.captures} programs, {progs.replays} replays so far; kernel records in the replayed "
        f"{keys[-1]} chunk's device trace == the launches it counted, {traced} ({sum(traced.values())} launches a "
        f"chunk; traces taken {attempts}), with {reads} cache gather or dequant operations and {copies} strided bf16 "
        f"copies for {cfg.num_layers} layers, attention records {chunk_body} chunk_fwd_kernel and {old_body} "
        f"fwd_kernel; the hold took {time.perf_counter() - t0:.1f} s")


def prefill_only(label: str, eng, prompts, cold=None) -> tuple[list, float]:
    """One run of ``prompts`` with one new token each (prefill and the
    first-token pick), timed by the wall clock, synchronised: the tokens by
    request and the seconds. With ``cold`` (the tokens of the engine's first
    such run), the run comes after ``warmup()``: it must give those tokens,
    capture no prefill program and replay one a chunk."""
    import torch

    from flash_attention_tpu_torch.serving.engine import Request

    progs = eng.prefill_programs
    captures, replays, n_events = progs.captures, progs.replays, len(eng.events)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run([Request(id=i, prompt=p, max_new_tokens=1) for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    tokens = [done[i].tokens for i in range(len(prompts))]
    if any(len(t) != 1 for t in tokens):
        raise RuntimeError(f"[{label}] prefill-only run: every request must give exactly one token")
    if cold is not None:
        chunks = sum(1 for e in eng.events[n_events:] if e[0] == "chunk")
        got = (progs.mode, progs.captures - captures, progs.replays - replays)
        if got != ("graph", 0, chunks) or tokens != cold:
            raise RuntimeError(f"[{label}] the warm prefill-only run: prefill programs (mode, captures, replays) "
                               f"{got}, want ('graph', 0, {chunks}); first tokens {tokens}, the cold run's {cold}")
    return tokens, seconds


def tiny_requests():
    from flash_attention_tpu_torch.serving.engine import Request

    return [
        Request(id=1, prompt=(5, 9, 2), max_new_tokens=6),
        Request(id=2, prompt=(100, 3, 44, 8, 21, 60, 7), max_new_tokens=9),
        Request(id=3, prompt=(64,), max_new_tokens=4),
        Request(id=4, prompt=(11, 12, 13, 14), max_new_tokens=5),
        Request(id=5, prompt=(90, 2), max_new_tokens=3),
    ]


def phase_tiny() -> dict:
    """The same tiny fp32 params served on the card and on the CPU; returns
    the card's tokens."""
    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params
    from flash_attention_tpu_torch.serving.engine import ServingEngine

    cfg = ModelConfig(**TINY_CFG)
    params = init_model_params(torch.Generator().manual_seed(0), cfg)
    reqs = tiny_requests()
    results = {}
    for device in ("cuda", "cpu"):
        eng = ServingEngine(_to_device(params, device), cfg, max_slots=3, max_seq=64, prefill_chunk=16)
        results[device] = replayed_tokens("[tiny]", eng, reqs)
    log(f"[tiny] fp32 engine, 5 greedy requests on 3 slots: card {results['cuda']}")
    if results["cuda"] != results["cpu"]:
        raise RuntimeError(f"card and CPU tokens differ: {results['cuda']} vs {results['cpu']}")
    log("[tiny] card tokens (after warmup(): every decode block a replayed CUDA graph) == CPU tokens")
    return results["cuda"]


def phase_full(card: str):
    """ModelConfig() at full width, bf16, on 8 slots x 2048 positions.
    Returns the launch counts of the served run, the params and the
    engine's numbers."""
    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params

    cfg = ModelConfig()
    t0 = time.perf_counter()
    params = init_model_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _tensors(params))
    log(f"[full] ModelConfig() bf16: {n_params / 1e9:.3f} B params initialised on the card in {time.perf_counter() - t0:.1f} s")
    launches, numbers = serve_full_dense(card, "full", cfg, params, used=("K1", "K6", *SERVED))
    return launches, params, numbers


# Phase 5's sweep of S1: every vocab and batch against the plain version on the card. 128,256 is Llama 3's
# vocab and 256,000 Gemma's: the first no longer fits one block's shared memory whole, the second not even a
# cluster's (its slices are re-read from device memory each pass).
SAMPLER_VOCABS = (1, 7, 128, 32000, 50257, 128256, 256000)
SAMPLER_BATCHES = (1, 8, 32)
# thresh where S1 and the plain version part: S1 sums the probabilities exactly, so the exact mass rule must hold
# at its boundary to within this of top_p. The plain version's boundary is where its fp32 cumsum crosses top_p,
# held to the error bound of an fp32 cumsum of V probabilities, V * 2^-24 (on the card the cumsum adds in fp32).
THRESH_BAR = 1e-6
# S1's bound: operations a drawn element (threefry2x32's ~110 integer operations and the two logs' ~60 fp32
# ones) and an element of a sampled row (exp, two divisions, four passes of the radix selects), each one
# operation at the fp32 rate off the tensor cores.
S1_OPS_DRAWN, S1_OPS_ROW = 170, 40


def _mass_gap(logits, temperature, top_p, thresh) -> tuple[float, float, float]:
    """For one row (CPU fp32 tensors): the exact (float64) mass of
    softmax((logits - max) / T) above ``thresh`` and at or above it, and how
    far top_p lies outside [above, at or above] (0 inside: thresh is where
    the exact mass rule puts the boundary)."""
    import torch

    t = float(temperature) if float(temperature) > 0 else 1.0
    z = logits / torch.tensor(t, dtype=torch.float32)
    e = torch.exp((z - z.max()).double())
    probs = e / e.sum()
    above = float(probs[logits > thresh].sum())
    at_or_above = float(probs[logits >= thresh].sum())
    return above, at_or_above, max(0.0, above - float(top_p), float(top_p) - at_or_above)


def _hold_s1(what: str, logits, rows: dict) -> list:
    """S1's detail mode against the plain version on the same card tensors:
    the noise bit for bit, the greedy picks and kth exactly, thresh exactly
    or with the exact mass rule holding at S1's boundary to within
    THRESH_BAR of top_p (and at the plain version's to within its fp32
    cumsum's V * 2^-24), the tokens exactly where thresh agrees, and the
    tokens of an ordinary launch equal to the detail mode's. Returns a line
    for each row whose thresh parted: the boundaries' masses beside top_p."""
    import torch

    from flash_attention_tpu_torch.serving.sampling import _plain_parts, sample_tokens, sample_tokens_detail

    got = sample_tokens_detail(logits, **rows)
    want = _plain_parts(logits, **rows)
    tokens = sample_tokens(logits, **rows)
    if not _bits_equal(got["noise"], want["noise"]):
        bad = int((got["noise"].view(torch.int32) != want["noise"].view(torch.int32)).sum())
        raise RuntimeError(f"[sampling] {what}: S1's noise differs from gumbel_noise in {bad} elements")
    for key in ("greedy", "kth"):
        if not torch.equal(got[key], want[key]):
            raise RuntimeError(f"[sampling] {what}: S1's {key} {got[key].tolist()} != plain {want[key].tolist()}")
    if not torch.equal(tokens, got["tokens"]):
        raise RuntimeError(f"[sampling] {what}: S1's tokens {tokens.tolist()} != its detail mode's "
                           f"{got['tokens'].tolist()}")
    parted = (got["thresh"] != want["thresh"]).nonzero().flatten().tolist()
    lines = []
    for r in parted:
        cpu = {key: t[r].cpu() for key, t in rows.items()}
        row = logits[r].float().cpu()
        s1, plain = (_mass_gap(row, cpu["temperature"], cpu["top_p"], src["thresh"][r].cpu()) for src in (got, want))
        line = (f"{what} row {r}: thresh S1 {float(got['thresh'][r])!r} plain {float(want['thresh'][r])!r}, top_p "
                f"{float(cpu['top_p'])!r}, exact mass above / at or above S1's {s1[0]!r} / {s1[1]!r} "
                f"(gap {s1[2]:.3g}), "
                f"the plain version's {plain[0]!r} / {plain[1]!r} (gap {plain[2]:.3g}); tokens S1 "
                f"{int(got['tokens'][r])} plain {int(want['tokens'][r])}")
        if s1[2] > THRESH_BAR or plain[2] > logits.shape[1] * 2.0**-24:
            raise RuntimeError(f"[sampling] {line}: a boundary farther from top_p than S1's {THRESH_BAR} or the "
                               f"plain cumsum's {logits.shape[1] * 2.0**-24:.3g}")
        lines.append(line)
    agree = torch.ones_like(got["tokens"], dtype=torch.bool)
    agree[parted] = False
    if not torch.equal(got["tokens"][agree], want["tokens"][agree]):
        raise RuntimeError(f"[sampling] {what}: tokens S1 {got['tokens'].tolist()} != plain "
                           f"{want['tokens'].tolist()}")
    return lines


def _sweep_rows(rng, batch: int, vocab: int) -> dict:
    """Sampling rows for the sweep as CUDA tensors: temperatures with 0 among
    them, top_k across 0, 1 and past the vocab, top_p with 1 among them,
    seeds and positions over the whole int32 range."""
    import numpy as np
    import torch

    rows = dict(
        temperature=rng.choice(np.array([0.0, 0.5, 0.7, 1.0, 1.3, 2.0], np.float32), batch),
        top_k=rng.choice(np.array([0, 0, 1, 5, 40, 1000, vocab, vocab + 5], np.int32), batch),
        top_p=rng.choice(np.array([1.0, 1.0, 0.99, 0.9, 0.5, 0.05], np.float32), batch),
        seeds=rng.integers(-2**31, 2**31, batch, dtype=np.int64).astype(np.int32),
        positions=rng.integers(0, 2**31, batch, dtype=np.int64).astype(np.int32))
    return {key: torch.from_numpy(v).cuda() for key, v in rows.items()}


def _sweep_logits(style: str, batch: int, vocab: int, gen):
    """[batch, vocab] fp32 logits: "normal" (N(0, 3)), "ties" (N(0, 2)
    rounded to quarters: tie groups at every threshold) or "peak" (-17
    everywhere but one 0 a row: a top_p == 1 row's fp32 cumsum reaches 1.0
    before its end)."""
    import torch

    x = torch.randn((batch, vocab), generator=gen, device="cuda")
    if style == "normal":
        return x * 3
    if style == "ties":
        return torch.round(x * 8) / 4
    out = torch.full((batch, vocab), -17.0, device="cuda")
    out[torch.arange(batch, device="cuda"), (x[:, 0].abs() * 1000).long() % vocab] = 0.0
    return out


def sampler_sweep() -> None:
    """S1 at every vocab in SAMPLER_VOCABS and batch in SAMPLER_BATCHES, each
    with the three logit styles of ``_sweep_logits`` (``_hold_s1``), then
    bit-identical over two calls and a CUDA graph's replay."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.serving.sampling import sample_tokens_detail

    rng = np.random.default_rng(20)
    gen = torch.Generator(device="cuda").manual_seed(20)
    held, parted, at_one = 0, [], 0
    for vocab in SAMPLER_VOCABS:
        for batch in SAMPLER_BATCHES:
            for style in ("normal", "ties", "peak"):
                rows = _sweep_rows(rng, batch, vocab)
                parted += _hold_s1(f"V={vocab} B={batch} {style}", _sweep_logits(style, batch, vocab, gen), rows)
                held += batch
    below_one = [line for line in parted if "top_p 1.0," not in line]
    for line in parted[:3] + below_one[:10]:
        log(f"[sampling] thresh parted: {line}")
    at_one = len(parted) - len(below_one)
    rows = _sweep_rows(rng, 8, 32000)
    logits = _sweep_logits("normal", 8, 32000, gen)
    first, second = sample_tokens_detail(logits, **rows), sample_tokens_detail(logits, **rows)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = sample_tokens_detail(logits, **rows)
    graph.replay()
    torch.cuda.synchronize()
    if not all(_bits_equal(first[k], second[k]) and _bits_equal(first[k], replayed[k]) for k in first):
        raise RuntimeError("[sampling] S1 differs between two calls or a CUDA graph's replay")
    log(f"[sampling] S1 sweep: vocab {SAMPLER_VOCABS} x batch {SAMPLER_BATCHES} x logits normal / ties / peak, "
        f"{held} rows: noise == gumbel_noise bit for bit, greedy picks and kth == plain, thresh == plain in all but "
        f"{len(parted)} rows ({at_one} of them top_p == 1; S1's boundary within {THRESH_BAR} of top_p in each; the "
        f"first three printed and those below top_p 1), tokens == plain where thresh agrees; bit-identical over "
        f"two calls and a graph replay")


def phase_sampling(card: str, params) -> dict:
    """Phase 5's sampling on the card, ModelConfig() on phase 5's weights.
    S1's noise at phase 5's edge seeds x positions bit-equal to
    ``gumbel_noise`` on the CPU (which the CPU tests hold to jax.random's
    bits), and ``sampler_sweep``; then, on the logits of one decode step of
    8 slots at phase 5's sampling rows, ``sample_tokens`` (S1) under the
    sync debug mode "error" (no host sync), its tokens equal to the plain
    version's on the card and on the CPU. Then S1 timed as a call, alone in
    a CUDA graph and as host us, beside the plain version and its bound, and
    the decode step timed with the greedy pick and with sampling. Returns
    S1's row of the kernels line (its launches filled in by main())."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig, decode_step_logits, init_caches
    from flash_attention_tpu_torch.serving.sampling import (
        _plain_parts,
        gumbel_noise,
        sample_tokens,
        sample_tokens_detail,
        sample_tokens_plain,
    )

    cfg, slots, length = ModelConfig(), 8, 1024
    sampling = _sampling_inputs(length + 1)
    edges = torch.tensor([0, 1, 2, 1000, 2047, 4096, 2**31 - 1, length + 1], dtype=torch.int32)
    seeds, positions = sampling["seeds"].repeat_interleave(8), edges.repeat(8)
    noise = gumbel_noise(seeds, positions, cfg.vocab_size)
    if not torch.equal(gumbel_noise(seeds.cuda(), positions.cuda(), cfg.vocab_size).cpu(), noise):
        raise RuntimeError("[sampling] the card's plain Gumbel noise differs from the CPU's")
    edge_rows = {key: t.repeat(8).cuda() for key, t in sampling.items()}
    edge_rows.update(seeds=seeds.cuda(), positions=positions.cuda())
    logits64 = torch.randn((64, cfg.vocab_size), generator=torch.Generator(device="cuda").manual_seed(5),
                           device="cuda")
    if not torch.equal(sample_tokens_detail(logits64, **edge_rows)["noise"].cpu(), noise):
        raise RuntimeError("[sampling] S1's noise at phase 5's edge seeds and positions differs from the CPU's "
                           "gumbel_noise")
    for line in _hold_s1("phase 5 edge seeds x positions", logits64, edge_rows):
        log(f"[sampling] thresh parted: {line}")
    t0 = time.perf_counter()
    sampler_sweep()
    sweep_s = time.perf_counter() - t0

    on_card = {key: t.cuda() for key, t in sampling.items()}
    caches = [c._replace(lengths=torch.full((slots,), length, dtype=torch.int32, device="cuda"))
              for c in init_caches(cfg, slots, 2048, device="cuda")]
    tok = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (slots, 1))).to("cuda", torch.int32)
    with torch.no_grad():
        logits, _ = decode_step_logits(params, cfg, tok, caches)
        torch.cuda.synchronize()
        launched = sample_tokens.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            card_tok = sample_tokens(logits, **on_card)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if sample_tokens.launches != launched + 1:
            raise RuntimeError("[sampling] sample_tokens on the card did not launch S1 once")
        plain_tok = sample_tokens_plain(logits, **on_card)
        cpu_tok = sample_tokens(logits.cpu(), **sampling)
        if not (torch.equal(card_tok.cpu(), cpu_tok) and torch.equal(plain_tok.cpu(), cpu_tok)):
            raise RuntimeError(f"[sampling] S1 tokens {card_tok.tolist()}, the card's plain version's "
                               f"{plain_tok.tolist()}, the CPU's {cpu_tok.tolist()}: not all equal")
        for line in _hold_s1("phase 5 decode logits", logits, on_card):
            log(f"[sampling] thresh parted: {line}")
        ms, alone, host_us = _three_times(lambda: sample_tokens(logits, **on_card))
        plain_ms = cuda_ms(lambda: sample_tokens_plain(logits, **on_card))
        greedy_ms = cuda_ms(lambda: torch.argmax(decode_step_logits(params, cfg, tok, caches)[0], dim=-1))
        sampled_ms = cuda_ms(lambda: sample_tokens(decode_step_logits(params, cfg, tok, caches)[0], **on_card))
        noise_ms = cuda_ms(lambda: gumbel_noise(on_card["seeds"], on_card["positions"], cfg.vocab_size))
        parts = _plain_parts(logits, **on_card)
    sampled_rows = on_card["temperature"] > 0
    kept = ((logits >= parts["kth"][:, None]) & (logits >= parts["thresh"][:, None]))[sampled_rows]
    drawn = int(kept.sum())
    ops = S1_OPS_DRAWN * drawn + S1_OPS_ROW * int(sampled_rows.sum()) * cfg.vocab_size
    nbytes = logits.numel() * 4 + slots * (5 * 4 + 4)
    bound_ms = max(ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3)
    bound_by = "operations" if ops / PEAK_FP32 >= nbytes / PEAK_BYTES else "bytes"
    del caches
    torch.cuda.empty_cache()
    log(f"[sampling] S1 noise at phase 5's 8 seeds x 8 positions x {cfg.vocab_size} == CPU gumbel_noise bit for bit; "
        f"sample_tokens (S1, temperature > 0, top-k, top-p) on the decode logits == the card's plain version == "
        f"the CPU's, no host sync; tokens {card_tok.tolist()}; the sweep took {sweep_s:.1f} s")
    log(f"[sampling] S1 at {slots} x {cfg.vocab_size}: {ms:.4f} ms as a call, {alone:.4f} ms alone in a CUDA graph, "
        f"host {host_us:.1f} us a call; plain {plain_ms:.4f} ms (gumbel_noise alone {noise_ms:.4f} ms); library "
        f"none; bound {bound_ms:.5f} ms ({bound_by}: {drawn} elements drawn, {ops / 1e6:.1f} M operations at "
        f"{PEAK_FP32 / 1e12:.0f} TFLOP/s, {nbytes / 1e6:.3f} MB) ({card})")
    log(f"[sampling] ModelConfig() decode step, {slots} slots at {length} positions: greedy (argmax) {greedy_ms:.4f} ms, "
        f"sampled (S1) {sampled_ms:.4f} ms ({sampled_ms / greedy_ms:.3f}x) ({card})")
    return {"name": "sample_kernel (S1)", "route": "cuda", "source": "flash_attention_tpu_torch/csrc/sampling.cu",
            "replaces": f"{REFERENCE}/serving/sampling.py:55", "launches": 0, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def serve_full_dense(card: str, label: str, cfg, params, *, used, ref: dict | None = None,
                     w1_per_step: int | None = None):
    """ServingEngine over ``cfg`` / ``params`` at full width: a prefill-only
    run (cold), ``warmup()`` and the prefill-only run again (warm,
    ``prefill_only``), then the main path (phase 5's 10 requests on 8 slots
    x 2048 positions) with every launch count set to 0 just before and read
    just after; it must launch the kernels in ``used`` and no other. Then
    ``hold_programs`` (with ``w1_per_step``) and ``hold_prefill_programs``.
    ``ref``: the bf16 run's numbers of this call, printed beside these.
    Returns the launch counts and the engine's numbers."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.models.transformer import decode_step_logits, init_caches, prefill
    from flash_attention_tpu_torch.serving.engine import Request, ServingEngine

    rng = np.random.default_rng(0)
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab_size, n)) for n in FULL_PROMPT_LENS]
    eng = ServingEngine(params, cfg, max_slots=8, max_seq=2048, prefill_chunk=256)

    # Prefill-only runs (one token per request): the engine's first (cold:
    # first uses, and each prefill program's eager chunk and capture), then
    # the same after warmup() (warm: every chunk a replay).
    first, prefill_s = prefill_only(label, eng, prompts)
    n_prompt = sum(FULL_PROMPT_LENS)
    eng.warmup()  # every program built: the main path captures none
    _, warm_s = prefill_only(label, eng, prompts, cold=first)

    # The main path: counters to 0, serve, read the counters.
    eng.steps, eng.decode_tokens, eng.decode_time_s = 0, 0, 0.0
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done, chunks = counting_chunks(eng, lambda: eng.run([Request(id=100 + i, prompt=p, max_new_tokens=FULL_NEW_TOKENS)
                                                         for i, p in enumerate(prompts)]))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    bodies = read_bodies()
    log(f"[{label}] 10 requests on 8 slots: kernel launches {launches}, forward launches by body {bodies}; decode "
        f"steps {eng.steps}; prefill chunks {chunks}")
    check_chunk_rope(f"[{label}] the main path", launches, cfg.num_layers, chunks)
    check_tensor_cores(f"[{label}] the main path", bodies, "K1q/K1r" if "K1q" in used else "K1/K1d/K2")
    for i in range(len(prompts)):
        toks = done[100 + i].tokens
        if len(toks) != FULL_NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in toks):
            raise RuntimeError(f"request {100 + i}: {len(toks)} tokens, want {FULL_NEW_TOKENS} in vocab")
        if toks[0] != first[i][0]:
            raise RuntimeError(f"request {100 + i}: first greedy token differs between runs")
    check_launches(f"[{label}] the main path", launches, used)
    numbers = {
        "prefill_tok_s": n_prompt / prefill_s, "prefill_warm_tok_s": n_prompt / warm_s,
        "decode_tok_s": eng.decode_tokens / eng.decode_time_s,
        "peak_gib": peak / 2**30, "cache_gb": _nbytes([(c.k, c.v, c.k_scales, c.v_scales) for c in eng.caches]) / 1e9,
        "weights_gb": _nbytes(params) / 1e9, "tokens": {rid: c.tokens for rid, c in done.items()},
    }
    decode_tokens, decode_s = eng.decode_tokens, eng.decode_time_s
    log(f"[{label}] programs of the main path: decode mode {eng.programs.mode}, {eng.programs.captures} built, "
        f"{eng.programs.replays} replays; prefill mode {eng.prefill_programs.mode}, {eng.prefill_programs.captures} "
        f"built, {eng.prefill_programs.replays} replays")
    hold_programs(label, eng, w1_per_step)
    hold_prefill_programs(label, eng)
    del eng

    # Logits of the same model, straight from the model functions: finite
    # and of the expected shape, one-shot prefill (K1) then one decode step.
    caches = init_caches(cfg, 1, 2048, device="cuda")
    toks = torch.as_tensor(prompts[5], device="cuda")[None]
    logits, caches = prefill(params, cfg, toks, caches)
    step_logits, _ = decode_step_logits(params, cfg, logits[:, -1:].argmax(-1).to(torch.int32), caches)
    if logits.shape != (1, len(prompts[5]), cfg.vocab_size) or step_logits.shape != (1, cfg.vocab_size):
        raise RuntimeError(f"logits shapes {tuple(logits.shape)} {tuple(step_logits.shape)}")
    if not (bool(torch.isfinite(logits).all()) and bool(torch.isfinite(step_logits).all())):
        raise RuntimeError("non-finite logits at full width")
    del caches, logits, step_logits

    def beside(key: str, fmt: str = ".1f") -> str:
        return "" if ref is None else f" (bf16, phase 5: {ref[key]:{fmt}})"

    n_gen = sum(len(c.tokens) for c in done.values())
    log(
        f"[{label}] prefill: {n_prompt} prompt tokens in {prefill_s:.3f} s = {numbers['prefill_tok_s']:.1f} tok/s"
        f"{beside('prefill_tok_s')} cold (the engine's first run), {warm_s:.3f} s = "
        f"{numbers['prefill_warm_tok_s']:.1f} tok/s{beside('prefill_warm_tok_s')} warm (after warmup(): every chunk "
        f"a replay) (max_new_tokens=1 runs, wall clock) ({card})"
    )
    log(
        f"[{label}] decode: {decode_tokens} tokens in {decode_s:.3f} s of decode section = "
        f"{numbers['decode_tok_s']:.1f} tok/s{beside('decode_tok_s')}; whole run {n_gen} tokens in {run_s:.3f} s ({card})"
    )
    log(
        f"[{label}] allocated: weights {numbers['weights_gb']:.3f} GB{beside('weights_gb', '.3f')}, KV cache with its "
        f"scales {numbers['cache_gb']:.4f} GB{beside('cache_gb', '.4f')}; peak device memory (max_memory_allocated) "
        f"{numbers['peak_gib']:.2f} GiB{beside('peak_gib', '.2f')} ({card})"
    )
    return launches, numbers


def _shuffled_table(rng, num_slots: int, pages_per_slot: int, num_pages: int, *, dump_slot: bool = True):
    """The slots' page tables as a random permutation of pages 1..num_pages-1,
    so a kernel reading pages in order fails; with ``dump_slot``, slot 0's
    row is all dump page 0, like a released slot's."""
    import numpy as np

    table = rng.permutation(np.arange(1, num_pages))[: num_slots * pages_per_slot]
    table = table.reshape(num_slots, pages_per_slot).astype(np.int32)
    if dump_slot:
        table[0] = 0
    return table


def _dense_from_pages(pages, table):
    """[slots, kv_heads, pages_per_slot * page_size, D] gathered from the
    pages here, independently of the port's own gather."""
    x = pages[table.long()]  # [S, n, H, page, D]
    s, n, h, page, d = x.shape
    return x.permute(0, 2, 1, 3, 4).reshape(s, h, n * page, d)


def _filled_cache(num_layers, *, num_pages, num_slots, pages_per_slot, kv_heads, head_dim, dtype, gen, page_size=128):
    """A PagedModelCache whose pools hold U(-0.5, 0.5)."""
    from flash_attention_tpu_torch.ops.paged import init_paged_model_cache

    cache = init_paged_model_cache(
        num_layers, num_pages=num_pages, num_slots=num_slots, pages_per_slot=pages_per_slot,
        kv_heads=kv_heads, page_size=page_size, head_dim=head_dim, dtype=dtype, device="cuda",
    )
    for pool in (cache.k_pool, cache.v_pool):
        pool.copy_(torch_uniform(pool.shape, dtype, gen))
    return cache


def torch_uniform(shape, dtype, gen):
    import torch

    return (torch.rand(shape, generator=gen, device="cuda") - 0.5).to(dtype)


def phase_paged_kernels(card: str):
    """K7, K8 and K9/K10 at the paged path's shapes, bf16, over one layer's
    pool [129, 8, 128, 128] (K10: 32 layers) with shuffled page tables."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.ops.paged import (
        PagedModelCache,
        paged_decode_attention,
        paged_decode_attention_plain,
        paged_prefill_attention,
        paged_prefill_attention_plain,
        paged_write_tokens,
        paged_write_tokens_multi,
        paged_write_tokens_plain,
    )
    from flash_attention_tpu_torch.ops.reference import reference_attention, reference_attention_with_lse

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    rel_bar = REL_BAR["bfloat16"]
    rng = np.random.default_rng(7)
    gen = torch.Generator(device=dev).manual_seed(7)
    scale = 1.0 / 128**0.5
    cache = _filled_cache(1, num_pages=129, num_slots=8, pages_per_slot=16, kv_heads=8, head_dim=128, dtype=bf16,
                          gen=gen).layers()[0]
    table = torch.from_numpy(_shuffled_table(rng, 8, 16, 129)).to(dev)
    cache.page_table.copy_(table)
    lengths = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device=dev)
    cache = cache._replace(lengths=lengths)
    k_dense, v_dense = _dense_from_pages(cache.k_pages, table), _dense_from_pages(cache.v_pages, table)

    # K7: decode with LSE through the page table.
    q = torch_uniform((8, 32, 128), bf16, gen)
    (out, lse), grid = _twice("K7", paged_decode_attention, lambda: paged_decode_attention(q, cache, save_residuals=True))
    p_out, p_lse = paged_decode_attention_plain(q, cache, sm_scale=scale, save_residuals=True)
    o_out, o_lse = reference_attention_with_lse(q[:, :, None], k_dense, v_dense, kv_length=lengths)
    torch.cuda.synchronize()
    d_oracle, d_plain = _max_diff(out, o_out[:, :, 0]), _max_diff(out, p_out)
    d_rel = max(_rel_diff(out, o_out[:, :, 0]), _rel_diff(out, p_out))
    d_lse = max(_max_diff(lse, p_lse), _max_diff(lse, o_lse[:, :, 0]))
    if not (bool((out[0] == 0).all()) and bool(torch.isneginf(lse[0]).all())):
        raise RuntimeError("K7: the dump-page slot of length 0 must give output 0 and LSE -inf")
    ms = cuda_ms(lambda: paged_decode_attention(q, cache, save_residuals=True))
    plain_ms = cuda_ms(lambda: paged_decode_attention_plain(q, cache, sm_scale=scale, save_residuals=True))
    rows = sum(PAGED_LENGTHS)
    pages_read = sum(-(-n // 128) for n in PAGED_LENGTHS)
    nbytes = 2 * (2 * rows * 8 * 128) + 2 * (2 * q.numel()) + 4 * (lse.numel() + lengths.numel() + pages_read)
    bound_ms, bound_by = bound(4 * 128 * 32 * rows, nbytes)
    log(
        f"[K7] q [8,32,128] pages [129,8,128,128] bf16, shuffled table [8,16], lengths {list(PAGED_LENGTHS)}, "
        f"{grid}, bit-identical over two calls: "
        f"|out-oracle| {d_oracle:.3e} (bar {ORACLE_BAR}), |out-plain| {d_plain:.3e} (bar {PLAIN_BAR}), "
        f"row-relative vs plain and oracle {d_rel:.3e} (bar {rel_bar}), |lse| {d_lse:.3e} (bar {LSE_BAR}); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library none, "
        f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB) ({card})"
    )
    if not (d_oracle < ORACLE_BAR and d_plain < PLAIN_BAR and d_rel < rel_bar and d_lse < LSE_BAR):
        raise RuntimeError("K7 disagrees")
    k7 = {
        "name": "paged_decode (K7)", "route": "cuda",
        "source": "flash_attention_tpu_torch/csrc/decode.cu",
        "replaces": f"{REFERENCE}/ops/paged.py:980",
        "max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }

    # K8: a 256-row chunk at [kv_end - 256, kv_end) of slot 7 (16 pages).
    worst_plain = 0.0
    zero_counts()
    for kv_end in (256, 1024, 2048):
        qc = torch_uniform((1, 32, 256, 128), bf16, gen)
        out = paged_prefill_attention(qc, cache, 7, kv_end, chunk_len=256)
        p_out = paged_prefill_attention_plain(qc, cache, 7, kv_end, sm_scale=scale)
        o_out = reference_attention(qc, k_dense[7:8, :, :kv_end], v_dense[7:8, :, :kv_end], causal=True)
        torch.cuda.synchronize()
        d_oracle, d_plain = _max_diff(out, o_out), _max_diff(out, p_out)
        d_rel = max(_rel_diff(out, o_out), _rel_diff(out, p_out))
        ms = cuda_ms(lambda: paged_prefill_attention(qc, cache, 7, kv_end, chunk_len=256))
        plain_ms = cuda_ms(lambda: paged_prefill_attention_plain(qc, cache, 7, kv_end, sm_scale=scale))
        flops = 4 * 128 * 32 * causal_pairs(256, kv_end)
        nbytes = 2 * (2 * qc.numel() + 2 * kv_end * 8 * 128) + 4 * (kv_end // 128)
        bound_ms, bound_by = bound(flops, nbytes)
        log(
            f"[K8] q [1,32,256,128] over slot 7's pages to kv_end {kv_end}, bf16: |out-oracle| {d_oracle:.3e} "
            f"(bar {ORACLE_BAR}), |out-plain| {d_plain:.3e} (bar {PLAIN_BAR}), row-relative vs plain and "
            f"oracle {d_rel:.3e} (bar {rel_bar}); kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, library none, bound {bound_ms:.4f} ms by {bound_by} ({card})"
        )
        if not (d_oracle < ORACLE_BAR and d_plain < PLAIN_BAR and d_rel < rel_bar):
            raise RuntimeError(f"K8 disagrees at kv_end={kv_end}")
        worst_plain = max(worst_plain, d_plain)
    bodies = read_bodies()
    check_tensor_cores("[K8] bf16", bodies, "K8/K8q")
    log(f"[K8] bf16: launches by body {bodies} (the tensor-core body, csrc/flash_fwd_sm90.cu)")
    k8 = {
        "name": "fwd_kernel, wgmma + TMA, paged (K8)", "route": "cuda",
        "source": "flash_attention_tpu_torch/csrc/flash_fwd_sm90.cu",
        "replaces": f"{REFERENCE}/ops/paged.py:580",
        "max_abs_err": worst_plain, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    del cache, k_dense, v_dense

    # K10: one token row per slot into 32 layers. Slot 0 is a released slot
    # (dump-page table, frozen length 37), slot 1 is at capacity.
    num_layers = 32
    cache = _filled_cache(num_layers, num_pages=129, num_slots=8, pages_per_slot=16, kv_heads=8, head_dim=128,
                          dtype=bf16, gen=gen)
    w_table = torch.from_numpy(_shuffled_table(rng, 8, 16, 129)).to(dev)
    cache.page_table.copy_(w_table)
    w_lengths = torch.tensor([37, 2048, 5, 127, 128, 129, 1000, 2047], dtype=torch.int32, device=dev)
    cache = cache._replace(lengths=w_lengths)
    slots = torch.arange(8, device=dev)
    k_new, v_new = torch_uniform((num_layers, 8, 8, 128), bf16, gen), torch_uniform((num_layers, 8, 8, 128), bf16, gen)
    # The plain version writes into a copy of the pools.
    plain = PagedModelCache(cache.k_pool.clone(), cache.v_pool.clone(), w_table.clone(), w_lengths.clone())
    written = paged_write_tokens_multi(cache, k_new, v_new, slots)
    valid = paged_write_tokens_plain(plain, k_new, v_new, slots)
    torch.cuda.synchronize()
    same = torch.equal(cache.k_pool, plain.k_pool) and torch.equal(cache.v_pool, plain.v_pool)
    want_lengths = w_lengths + valid
    dumped = torch.equal(cache.k_pool[:, 0, :, 37], k_new[:, 0])
    if not (same and dumped and valid.tolist() == [1, 0, 1, 1, 1, 1, 1, 1]
            and torch.equal(written.lengths, want_lengths) and cache.lengths.tolist()[1] == 2048):
        raise RuntimeError("K10 disagrees with its plain version (bit-exact), or advanced lengths wrongly")
    launches10 = _launches_a_call(lambda: paged_write_tokens_multi(cache, k_new, v_new, slots))
    ms = cuda_ms(lambda: paged_write_tokens_multi(cache, k_new, v_new, slots))
    plain_ms = cuda_ms(lambda: paged_write_tokens_plain(plain, k_new, v_new, slots))
    # The library yardstick: index_put_ of the valid rows into the K and the
    # V pool ([L, pages, heads, page, D] indexed by layer, page, head, row).
    ok = valid.bool()
    pos = w_lengths[ok].long()
    idx = (
        torch.arange(num_layers, device=dev)[:, None, None],
        w_table[slots[ok], pos // 128].long()[None, :, None],
        torch.arange(8, device=dev)[None, None, :],
        (pos % 128)[None, :, None],
    )
    rows_k, rows_v = k_new[:, ok], v_new[:, ok]
    lib_ms = cuda_ms(lambda: (plain.k_pool.index_put_(idx, rows_k), plain.v_pool.index_put_(idx, rows_v)))
    n_valid = int(ok.sum())
    nbytes = 2 * (2 * num_layers * n_valid * 8 * 128 * 2) + 4 * 4 * 8  # rows read + written; lengths, table, slots, valid
    bound_ms, bound_by = bound(0, nbytes)
    log(
        f"[K10] 32 layers x 8 slots x rows [8,128] bf16 into pools [32,129,8,128,128], one slot at capacity, "
        f"one on the dump page: bit-equal to plain, lengths advanced where valid {valid.tolist()} (new lengths "
        f"{written.lengths.tolist()}), {launches10} launch a call; "
        f"wrapper {ms:.4f} ms, plain {plain_ms:.4f} ms, index_put_ K and V (library) {lib_ms:.4f} ms, "
        f"bound {bound_ms:.5f} ms by {bound_by} ({nbytes / 1e6:.2f} MB) ({card})"
    )
    k10 = {
        "name": "paged_write (K9/K10)", "route": "cuda",
        "source": "flash_attention_tpu_torch/csrc/paged_write.cu",
        "replaces": f"{REFERENCE}/ops/paged.py:257",
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }

    # K9: the same kernel with one layer, writing new rows into layer 0.
    k_one, v_one = torch_uniform((8, 8, 128), bf16, gen), torch_uniform((8, 8, 128), bf16, gen)
    plain_one = PagedModelCache(plain.k_pool[:1], plain.v_pool[:1], plain.page_table, plain.lengths)
    layer0 = cache.layers()[0]
    one = paged_write_tokens(layer0, k_one, v_one, slots)
    paged_write_tokens_plain(plain_one, k_one[None], v_one[None], slots)
    torch.cuda.synchronize()
    if not (torch.equal(cache.k_pool, plain.k_pool) and torch.equal(cache.v_pool, plain.v_pool)
            and torch.equal(cache.k_pool[0, 0, :, 37], k_one[0]) and torch.equal(one.lengths, want_lengths)):
        raise RuntimeError("K9 (one layer) disagrees with its plain version")
    launches9 = _launches_a_call(lambda: paged_write_tokens(layer0, k_one, v_one, slots))
    ms9 = cuda_ms(lambda: paged_write_tokens(layer0, k_one, v_one, slots))
    plain9 = cuda_ms(lambda: paged_write_tokens_plain(plain_one, k_one[None], v_one[None], slots))
    idx9 = idx[1][0], idx[2][0], idx[3][0]  # [page, head, row] of the valid rows in one layer
    rows9_k, rows9_v = k_one[ok], v_one[ok]
    lib9 = cuda_ms(lambda: (plain.k_pool[0].index_put_(idx9, rows9_k), plain.v_pool[0].index_put_(idx9, rows9_v)))
    bound9, by9 = bound(0, 2 * (2 * n_valid * 8 * 128 * 2) + 4 * 4 * 8)
    log(
        f"[K9] one layer: bit-equal to plain, new lengths {one.lengths.tolist()}, {launches9} launch a call; "
        f"wrapper {ms9:.4f} ms, plain {plain9:.4f} ms, index_put_ K and V "
        f"(library) {lib9:.4f} ms, bound {bound9:.5f} ms by {by9} ({card})"
    )
    return k7, k8, k10


# The runtime calls that put one operation on the device, as a torch.profiler
# trace records them on the host side (its device-side records can come back
# empty for a trace this short).
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def launches_a_call(call) -> int:
    """The device operations (kernels, copies, memsets) one ``call`` puts on
    the device, counted from the launch calls in a torch.profiler trace of
    one call after a warm-up."""
    import torch

    call()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return sum(e.name in LAUNCH_CALLS for e in prof.events())


def _launches_a_call(call) -> int:
    """``launches_a_call``, which must be 1: the page write is one launch."""
    n = launches_a_call(call)
    if n != 1:
        raise RuntimeError(f"the page write made {n} device operations a call, want 1")
    return n


PREFILL_CHUNKS = (1, 63, 64, 65, 100, 256)  # chunk lengths across the tensor-core walk's 64- and 128-row tiles
PREFILL_DIMS = (32, 64, 128)
PREFILL_GROUPS = ((4, 4), (4, 1), (16, 1))  # (q heads, kv heads): groups 1, 4 and 16


def _page_edges(page: int, chunk: int) -> tuple[int, ...]:
    """kv_end one row before, at and after a page edge past the chunk."""
    edge = max(2, -(-chunk // page) + 1) * page
    return edge - 1, edge, edge + 1


def _prefill_edge(what: str, cache, slot: int, qc, kv_end: int, k_log, v_log, *, dtype: str, window=None,
                  sinks: int = 0, softcap=None) -> float:
    """One chunk of K8 (or K8q) at [kv_end - T, kv_end) of ``slot``: two
    calls bit-identical, row by row within REL_BAR of plain and the fp32
    oracle on the slot's logical rows ``k_log`` / ``v_log`` (dequantized
    for K8q) under the same masks, within ORACLE_BAR of the oracle. Returns
    the row-relative difference over its bar."""
    import torch

    from flash_attention_tpu_torch.ops.paged import paged_prefill_attention, paged_prefill_attention_plain

    t, d = qc.shape[2], qc.shape[3]
    kw = dict(sliding_window=window, attention_sinks=sinks, logit_softcap=softcap)
    out = paged_prefill_attention(qc, cache, slot, kv_end, chunk_len=t, **kw)
    _same_twice(what, lambda: paged_prefill_attention(qc, cache, slot, kv_end, chunk_len=t, **kw))
    plain = paged_prefill_attention_plain(qc, cache, slot, kv_end, sm_scale=d**-0.5, **kw)
    col = torch.arange(kv_end, device="cuda")[None, :]
    row = torch.arange(t, device="cuda")[:, None] + kv_end - t
    mask = col <= row
    if window is not None:
        mask &= (col > row - window) | (col < sinks)
    oracle, _ = _oracle_mask(qc, k_log[slot:slot + 1, :, :kv_end], v_log[slot:slot + 1, :, :kv_end], mask,
                             sm_scale=d**-0.5, softcap=softcap)
    return _hold(what, out, plain, oracle, dtype=dtype)[1] / REL_BAR[dtype]


def _prefill_edge_sweep(kind: str) -> str:
    """K8 on the tensor-core body at the walk's edges, bf16 / fp16 x head_dim
    32 / 64 / 128 x groups 1 / 4 / 16 x pages of 64 and 128 rows: chunks of
    PREFILL_CHUNKS rows ending one row before, at and after a page edge, each
    by ``_prefill_edge``. ``kind``: "paged" (shuffled pages), "quant" (K8q,
    the payloads in turn) or "masked" (the paged ring with 3 sinks at
    windows 1, 63 and 100, a softcap at 63; then K2 at the same
    chunk edges on dense K / V at windows 1, 48 and 64, with its LSE, also
    with K / V one slot of a cache read by ``kv_batch``). Every
    launch must run the tensor-core body. Returns a line for the log."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from flash_attention_tpu_torch.ops.reference import reference_attention_with_lse
    from flash_attention_tpu_torch.utils.testing import make_qkv

    rng = np.random.default_rng(31)
    gen = torch.Generator(device="cuda").manual_seed(31)
    gen_slots = torch.Generator(device="cuda").manual_seed(32)  # K2's other cache slots
    worst, cases, i = 0.0, 0, 0
    zero_counts()
    for dtype in (torch.float16, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for d in PREFILL_DIMS:
            for hq, hkv in PREFILL_GROUPS:
                for page in (64, 128):
                    per_slot = 1024 // page
                    what = f"[{kind} edges] {name} d={d} {hq}/{hkv} page {page}"
                    window, sinks, softcap = None, 0, None
                    if kind == "quant":
                        mode = QUANT_MODES[i % len(QUANT_MODES)]
                        what += f" {mode}"
                        cache, _ = _quant_pages(mode, 1, 1 + 2 * per_slot, 2, per_slot, gen, rng, kv_heads=hkv,
                                                head_dim=d, page_size=page)
                        cache = cache.layers()[0]
                        k_log, v_log = (_dense_from_pages(_dequant_pool(x, s), cache.page_table) for x, s in
                                        ((cache.k_pages, cache.k_scales), (cache.v_pages, cache.v_scales)))
                    else:
                        if kind == "masked":
                            window = (1, 63, 100)[i % 3]
                            sinks, softcap = 3, (BITE_CAP if window == 63 else None)
                            n_ring = -(-(window + 256) // page) + 1
                            table, num_pages = _ring_table(rng, 2, per_slot, n_ring, sinks=True)
                        else:
                            num_pages = 1 + 2 * per_slot
                            table = _shuffled_table(rng, 2, per_slot, num_pages)
                        cache = _filled_cache(1, num_pages=num_pages, num_slots=2, pages_per_slot=per_slot,
                                              kv_heads=hkv, head_dim=d, dtype=dtype, gen=gen, page_size=page).layers()[0]
                        cache.page_table.copy_(torch.from_numpy(table).cuda())
                        k_log, v_log = (_dense_from_pages(x, cache.page_table) for x in (cache.k_pages, cache.v_pages))
                        what += f" window {window}" if window else ""
                    for chunk in PREFILL_CHUNKS:
                        qc = torch_uniform((1, hq, chunk, d), dtype, gen)
                        if softcap is not None:
                            qc = (qc.float() * BITE_Q).to(dtype)
                        for kv_end in _page_edges(page, chunk):
                            worst = max(worst, _prefill_edge(f"{what} chunk {chunk} kv_end {kv_end}", cache, 1, qc,
                                                             kv_end, k_log, v_log, dtype=name, window=window,
                                                             sinks=sinks, softcap=softcap))
                            cases += 1
                    i += 1
                    del cache, k_log, v_log
                if kind != "masked":
                    continue
                for window in (1, 48, 64):  # K2 at the same chunk edges
                    for chunk in PREFILL_CHUNKS:
                        for kv_len in (chunk, *_page_edges(64, chunk)):
                            q, k, v = make_qkv(cases, 1, hq, chunk, d, num_kv_heads=hkv, kv_seq=kv_len, dtype=dtype,
                                               device="cuda")
                            kw = dict(causal=True, sliding_window=window)
                            what = f"[masked edges] K2 {name} d={d} {hq}/{hkv} window {window} q {chunk} kv {kv_len}"
                            out, lse = flash_attention(q, k, v, save_residuals=True, **kw)
                            _same_twice(what, lambda: flash_attention(q, k, v, save_residuals=True, **kw))
                            p_out, p_lse = flash_attention_plain(q, k, v, sm_scale=d**-0.5, save_residuals=True, **kw)
                            o_out, o_lse = reference_attention_with_lse(q, k, v, **kw)
                            worst = max(worst, _hold(what, out, p_out, o_out, lse, p_lse, o_lse, dtype=name)[1]
                                        / REL_BAR[name])
                            # The dense engine's form: K / V one slot of a
                            # 3-slot cache whose other slots hold other rows,
                            # the slot read from device memory (kv_batch).
                            s = 1 + cases % 2
                            k3, v3 = (torch_uniform((3, hkv, kv_len, d), dtype, gen_slots) for _ in range(2))
                            k3[s], v3[s] = k[0], v[0]
                            kv_batch = torch.tensor([s], dtype=torch.int32, device="cuda")
                            b_out, b_lse = flash_attention(q, k3, v3, save_residuals=True, kv_batch=kv_batch, **kw)
                            worst = max(worst, _hold(f"{what} slot {s} of 3 by kv_batch", b_out, p_out, o_out, b_lse,
                                                     p_lse, o_lse, dtype=name)[1] / REL_BAR[name])
                            cases += 1
    torch.cuda.synchronize()
    bodies = read_bodies()
    check_tensor_cores(f"[{kind} edges]", bodies, "K8/K8q")
    if kind == "masked":
        check_tensor_cores("[masked edges] K2", bodies, "K1/K1d/K2")
    return (f"[{kind} edges] {cases} chunk / page-edge cases on the tensor-core body (fp16/bf16 x head_dim 32/64/128 "
            f"x groups 1/4/16 x pages of 64/128 rows, chunks {list(PREFILL_CHUNKS)} ending at page edges +-1), each "
            f"bit-identical over two calls, within {ORACLE_BAR} of the oracle; worst row-relative difference at "
            f"{worst:.3f} of its bar; launches by body {bodies}")


def phase_paged_sweep() -> None:
    """Every (dtype, head_dim) instantiation of K7, K8 and K9/K10 at ragged
    shapes: kv lengths off the 64-row tiles, GQA groups of 1, 4 and 16,
    pages of 64 and 128 rows (64-row chunks on the 64-row pages), a
    dump-page slot and a slot at capacity."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.ops.paged import (
        PagedModelCache,
        paged_decode_attention,
        paged_decode_attention_plain,
        paged_prefill_attention,
        paged_prefill_attention_plain,
        paged_write_tokens_multi,
        paged_write_tokens_plain,
    )
    from flash_attention_tpu_torch.ops.reference import reference_attention, reference_attention_with_lse

    rng = np.random.default_rng(8)
    gen = torch.Generator(device="cuda").manual_seed(8)
    plain_bar = {torch.float32: 1e-4, torch.float16: PLAIN_BAR, torch.bfloat16: PLAIN_BAR}
    worst, worst_rel = 0.0, 0.0
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        rel_bar = REL_BAR[str(dtype).removeprefix("torch.")]
        for d in (32, 64, 128):
            for hq, hkv in ((4, 4), (4, 1), (16, 1)):
                for page in (64, 128):
                    what = f"{dtype} d={d} {hq}/{hkv} page {page}"
                    per_slot = 256 // page
                    cache = _filled_cache(2, num_pages=1 + 3 * per_slot, num_slots=3, pages_per_slot=per_slot,
                                          kv_heads=hkv, head_dim=d, dtype=dtype, gen=gen, page_size=page)
                    table = torch.from_numpy(_shuffled_table(rng, 3, per_slot, 1 + 3 * per_slot)).cuda()
                    cache.page_table.copy_(table)
                    lengths = torch.tensor([0, 37, 200], dtype=torch.int32, device="cuda")
                    c = cache._replace(lengths=lengths).layers()[0]
                    k_dense, v_dense = _dense_from_pages(c.k_pages, table), _dense_from_pages(c.v_pages, table)
                    q = torch_uniform((3, hq, d), dtype, gen)
                    out, lse = paged_decode_attention(q, c, save_residuals=True)
                    p_out, p_lse = paged_decode_attention_plain(q, c, sm_scale=d**-0.5, save_residuals=True)
                    o_out, o_lse = reference_attention_with_lse(q[:, :, None], k_dense, v_dense, kv_length=lengths)
                    d_oracle, d_plain = _max_diff(out, o_out[:, :, 0]), _max_diff(out, p_out)
                    d_rel = max(_rel_diff(out, o_out[:, :, 0]), _rel_diff(out, p_out))
                    d_lse = max(_max_diff(lse, p_lse), _max_diff(lse, o_lse[:, :, 0]))
                    if not (d_oracle < ORACLE_BAR and d_plain < plain_bar[dtype] and d_rel < rel_bar
                            and d_lse < LSE_BAR):
                        raise RuntimeError(f"K7 {what}: {d_oracle} {d_plain} {d_rel} {d_lse}")
                    worst = max(worst, d_plain / plain_bar[dtype])
                    worst_rel = max(worst_rel, d_rel / rel_bar)
                    chunk = min(page, 128)
                    qc = torch_uniform((1, hq, chunk, d), dtype, gen)
                    out = paged_prefill_attention(qc, c, 2, 200, chunk_len=chunk)
                    p_out = paged_prefill_attention_plain(qc, c, 2, 200, sm_scale=d**-0.5)
                    o_out = reference_attention(qc, k_dense[2:3, :, :200], v_dense[2:3, :, :200], causal=True)
                    d_oracle, d_plain = _max_diff(out, o_out), _max_diff(out, p_out)
                    d_rel = max(_rel_diff(out, o_out), _rel_diff(out, p_out))
                    if not (d_oracle < ORACLE_BAR and d_plain < plain_bar[dtype] and d_rel < rel_bar):
                        raise RuntimeError(f"K8 {what}: {d_oracle} {d_plain} {d_rel}")
                    worst = max(worst, d_plain / plain_bar[dtype])
                    worst_rel = max(worst_rel, d_rel / rel_bar)
                    w_lengths = torch.tensor([5, 127, 256], dtype=torch.int32, device="cuda")  # slot 2 at capacity
                    cache = cache._replace(lengths=w_lengths)
                    k_new, v_new = torch_uniform((2, 3, hkv, d), dtype, gen), torch_uniform((2, 3, hkv, d), dtype, gen)
                    copy = PagedModelCache(cache.k_pool.clone(), cache.v_pool.clone(), table, w_lengths)
                    slots = torch.tensor([2, 0, 1], device="cuda")
                    written = paged_write_tokens_multi(cache, k_new, v_new, slots)
                    valid = paged_write_tokens_plain(copy, k_new, v_new, slots)
                    if not (torch.equal(cache.k_pool, copy.k_pool) and torch.equal(cache.v_pool, copy.v_pool)
                            and valid.tolist() == [0, 1, 1] and written.lengths.tolist() == [6, 128, 256]):
                        raise RuntimeError(f"K10 {what}: not bit-equal to plain")
    torch.cuda.synchronize()
    log(
        "[paged sweep] K7, K8 and K9/K10 at fp32/fp16/bf16 x head_dim 32/64/128 x groups 1/4/16 x pages of "
        "64/128 rows, lengths {0 (dump page), 37, 200}, chunk rows [72, 200) and [136, 200): all within 0.1 of "
        f"the oracle, writes bit-equal; worst |kernel-plain| at {worst:.3f} of its bar (fp32 1e-4, fp16/bf16 "
        f"{PLAIN_BAR}), worst row-relative difference at {worst_rel:.3f} of its bar {REL_BAR}"
    )
    log(_prefill_edge_sweep("paged"))


def phase_tiny_paged(dense_tokens: dict) -> None:
    """The tiny fp32 params through PagedServingEngine on the card and on
    the CPU: tokens identical to each other and to the dense engine's on
    the card; then a shared 256-token prefix through the prefix cache."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params
    from flash_attention_tpu_torch.serving.engine import Request
    from flash_attention_tpu_torch.serving.paged_engine import PagedServingEngine

    cfg = ModelConfig(**TINY_CFG)
    params = init_model_params(torch.Generator().manual_seed(0), cfg)
    results = {}
    for device in ("cuda", "cpu"):
        eng = PagedServingEngine(_to_device(params, device), cfg, max_slots=3, num_pages=16, pages_per_slot=2, page_size=128)
        results[device] = replayed_tokens("[tiny paged]", eng, tiny_requests())
    log(f"[tiny paged] fp32 paged engine, 5 greedy requests on 3 slots: card {results['cuda']}")
    if not results["cuda"] == results["cpu"] == dense_tokens:
        raise RuntimeError(f"paged card / paged CPU / dense card tokens differ: {results} vs {dense_tokens}")
    rng = np.random.default_rng(23)
    prefix = tuple(int(t) for t in rng.integers(0, cfg.vocab_size, 256))
    reqs = [
        Request(id=10 + i, prompt=prefix + tuple(int(t) for t in rng.integers(0, cfg.vocab_size, 40)), max_new_tokens=8)
        for i in range(3)
    ]
    on_card = _to_device(params, "cuda")
    tokens, hits = {}, {}
    for cached in (False, True):
        eng = PagedServingEngine(on_card, cfg, max_slots=2, num_pages=16, pages_per_slot=4, page_size=128,
                                 prefill_chunk=128, prefix_cache=cached)
        tokens[cached] = {r.id: eng.run([r])[r.id].tokens for r in reqs}  # one at a time: later ones hit
        hits[cached] = eng.prefix_hits
    log(f"[tiny paged] shared 256-token prefix: prefix_hits {hits[True]}; tokens with cache == without")
    if hits[True] <= 0 or tokens[True] != tokens[False]:
        raise RuntimeError(f"prefix cache: hits {hits[True]}, tokens {tokens[True]} vs {tokens[False]}")
    log("[tiny paged] paged card tokens (every decode block replayed) == paged CPU tokens == dense card tokens")


def serve_full_paged(card: str, label: str, cfg, params, *, used, dense: dict, ref: dict | None = None):
    """PagedServingEngine over ``cfg`` / ``params`` at full width (phase 8;
    the dense engine and its caches are gone): cold and warm prefill-only
    runs around ``warmup()``, then the main path, runs A and B, with every
    launch count set to 0 just before and read just after; it must launch
    the kernels in ``used`` and no other; then ``hold_programs`` and
    ``hold_prefill_programs``. ``dense``: the dense run's numbers of the
    same weights and cache type; ``ref``: the bf16 paged run's. Returns the
    launch counts and the engine's numbers."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.models.transformer import decode_step_logits_paged, prefill_chunk_paged
    from flash_attention_tpu_torch.serving.engine import Request
    from flash_attention_tpu_torch.serving.paged_engine import PagedServingEngine

    torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab_size, n)) for n in FULL_PROMPT_LENS]  # phase 5's
    eng = PagedServingEngine(params, cfg, max_slots=8, num_pages=129, pages_per_slot=16, page_size=128,
                             prefill_chunk=256, prefix_cache=True)
    pc = eng.caches
    pool_gb = _nbytes((pc.k_pool, pc.v_pool, pc.k_scales, pc.v_scales)) / 1e9

    # Prefill-only runs with the prefix cache off (nothing registered): the
    # engine's first (cold), then the same after warmup() (warm: replays).
    eng.prefix_cache_enabled = False
    first, prefill_s = prefill_only(label, eng, prompts)
    eng.warmup()  # every program built: the main path captures none
    _, warm_s = prefill_only(label, eng, prompts, cold=first)
    eng.prefix_cache_enabled = True

    # The paged main path: counters to 0, runs A and B, read the counters.
    eng.steps, eng.decode_tokens, eng.decode_time_s = 0, 0, 0.0
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_a, chunks = counting_chunks(eng, lambda: eng.run([Request(id=100 + i, prompt=p, max_new_tokens=FULL_NEW_TOKENS)
                                                          for i, p in enumerate(prompts)]))
    torch.cuda.synchronize()
    a_s = time.perf_counter() - t0
    a_decode = (eng.decode_tokens, eng.decode_time_s)
    shared = tuple(int(t) for t in rng.integers(0, cfg.vocab_size, 1024))
    tails = [tuple(int(t) for t in rng.integers(0, cfg.vocab_size, 200)) for _ in range(9)]
    hits_before = eng.prefix_hits
    (solo, group), chunks_b = counting_chunks(eng, lambda: (
        eng.run([Request(id=200, prompt=shared + tails[0], max_new_tokens=FULL_NEW_TOKENS)]),
        eng.run([Request(id=201 + i, prompt=shared + tails[1 + i], max_new_tokens=FULL_NEW_TOKENS) for i in range(8)])))
    torch.cuda.synchronize()
    launches = read_counts()
    check_chunk_rope(f"[{label}] the paged main path", launches, cfg.num_layers, chunks + chunks_b)
    peak = torch.cuda.max_memory_allocated()
    hits_b = eng.prefix_hits - hits_before
    log(f"[{label}] runs A and B: kernel launches {launches}; decode steps {eng.steps}; prefix_hits in run B {hits_b}")
    for rid, c in {**run_a, **solo, **group}.items():
        if len(c.tokens) != FULL_NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in c.tokens):
            raise RuntimeError(f"paged request {rid}: {len(c.tokens)} tokens, want {FULL_NEW_TOKENS} in vocab")
    if any(run_a[100 + i].tokens[0] != first[i][0] for i in range(len(prompts))):
        raise RuntimeError("paged run A: first greedy token differs from the prefill-only run")
    if hits_b != 8 * 1024 // 128:
        raise RuntimeError(f"run B: prefix_hits {hits_b}, want 64 (8 requests x 8 shared pages)")
    check_launches(f"[{label}] the paged main path", launches, used)
    bodies = read_bodies()
    log(f"[{label}] runs A and B: forward launches by body {bodies}")
    check_tensor_cores(f"[{label}] the paged main path", bodies, "K8/K8q")
    check_self_term(f"[{label}] the paged main path", launches, bodies)

    # The same 8 prompts without the prefix cache: the same first tokens.
    eng.prefix_cache_enabled = False
    cold = eng.run([Request(id=301 + i, prompt=shared + tails[1 + i], max_new_tokens=1) for i in range(8)])
    eng.prefix_cache_enabled = True
    if any(group[201 + i].tokens[0] != cold[301 + i].tokens[0] for i in range(8)):
        raise RuntimeError("run B: a first token through shared pages differs from the one without the cache")

    # Logits straight from the paged model functions: finite, of the
    # expected shape, and the 256-token prompt's greedy token is the engine's.
    pages = eng.alloc.acquire(2)
    row = torch.zeros(16, dtype=torch.int32, device="cuda")
    row[:2] = torch.tensor(pages, dtype=torch.int32)
    eng.caches.page_table[0] = row
    toks = torch.as_tensor(prompts[3], device="cuda")[None]  # 256 tokens: one chunk
    logits, caches = prefill_chunk_paged(params, cfg, toks, eng.caches, 0, 0, 256)
    step_logits, _ = decode_step_logits_paged(params, cfg, torch.zeros((8, 1), dtype=torch.int32, device="cuda"), caches)
    eng.caches.page_table[0] = 0
    eng.alloc.release(pages)
    if logits.shape != (1, 256, cfg.vocab_size) or step_logits.shape != (8, cfg.vocab_size):
        raise RuntimeError(f"paged logits shapes {tuple(logits.shape)} {tuple(step_logits.shape)}")
    if not (bool(torch.isfinite(logits).all()) and bool(torch.isfinite(step_logits).all())):
        raise RuntimeError("non-finite paged logits at full width")
    if int(logits[0, -1].argmax()) != first[3][0]:
        raise RuntimeError("paged prefill logits disagree with the engine's first token")

    n_prompt = sum(FULL_PROMPT_LENS)
    numbers = {"prefill_tok_s": n_prompt / prefill_s, "prefill_warm_tok_s": n_prompt / warm_s,
               "decode_tok_s": a_decode[0] / a_decode[1], "peak_gib": peak / 2**30, "cache_gb": pool_gb,
               "tokens": {rid: c.tokens for rid, c in run_a.items()}}

    def beside(key: str, fmt: str = ".1f") -> str:
        also = "" if ref is None else f"; bf16 paged, phase 8: {ref[key]:{fmt}}"
        return f" (bf16 dense, phase 5: {dense[key]:{fmt}}{also})"

    log(
        f"[{label}] PagedServingEngine(max_slots=8, num_pages=129, pages_per_slot=16, page_size=128, "
        f"prefill_chunk=256, prefix_cache=True), pool with its scales {pool_gb:.4f} GB{beside('cache_gb', '.4f')} ({card})"
    )
    log(
        f"[{label}] prefill: {n_prompt} prompt tokens in {prefill_s:.3f} s = {numbers['prefill_tok_s']:.1f} tok/s"
        f"{beside('prefill_tok_s')} cold, {warm_s:.3f} s = {numbers['prefill_warm_tok_s']:.1f} tok/s"
        f"{beside('prefill_warm_tok_s')} warm (after warmup()) ({card})"
    )
    log(
        f"[{label}] decode, run A: {a_decode[0]} tokens in {a_decode[1]:.3f} s of decode section = "
        f"{numbers['decode_tok_s']:.1f} tok/s{beside('decode_tok_s')}; run A whole {a_s:.3f} s ({card})"
    )
    log(
        f"[{label}] peak device memory (max_memory_allocated) over runs A and B {numbers['peak_gib']:.2f} GiB"
        f"{beside('peak_gib', '.2f')}; prefix_hits {eng.prefix_hits} ({card})"
    )
    log(f"[{label}] programs: decode mode {eng.programs.mode}, {eng.programs.captures} built, "
        f"{eng.programs.replays} replays; prefill mode {eng.prefill_programs.mode}, {eng.prefill_programs.captures} "
        f"built, {eng.prefill_programs.replays} replays")
    hold_programs(label, eng)
    hold_prefill_programs(label, eng)
    return launches, numbers


def scaled_rows(shape, gen):
    """fp32 rows U(-0.5, 0.5), each multiplied by its own 2^U(-4, 4): the
    quantization scales of neighbouring rows differ by up to 2^8, so a kernel
    that applied another row's scale would fail any bar."""
    import torch

    x = torch.rand(shape, generator=gen, device="cuda") - 0.5
    return x * torch.exp2(torch.rand((*shape[:-1], 1), generator=gen, device="cuda") * 8 - 4)


def _hold_quant(what: str, out, plain, oracle, lse=None, p_lse=None, o_lse=None, *, dtype: str = "bfloat16"):
    """A quantized kernel's output against its plain version and the fp32
    oracle on the dequantized cache: row by row relative to the row's largest
    value (rows span 2^8 in scale, so an absolute bar says little;
    REL_BAR[dtype]), within ORACLE_BAR of the oracle, and the base-2 LSE
    within LSE_BAR of both. Returns (|out - plain|, |out - oracle|,
    row-relative, |lse|)."""
    d_plain, d_oracle = _max_diff(out, plain), _max_diff(out, oracle)
    d_rel = max(_rel_diff(out, plain), _rel_diff(out, oracle))
    d_lse = 0.0 if lse is None else max(_max_diff(lse, p_lse), _max_diff(lse, o_lse))
    if not (d_oracle < ORACLE_BAR and d_rel < REL_BAR[dtype] and d_lse < LSE_BAR):
        raise RuntimeError(f"{what} disagrees: |out-oracle| {d_oracle:.3e}, row-relative {d_rel:.3e}, |lse| {d_lse:.3e}")
    return d_plain, d_oracle, d_rel, d_lse


def _no_copy(what: str, fn, out_bytes: int, copy_bytes: int) -> int:
    """``fn`` (one kernel call) allocates its outputs and less than 1 % of a
    bf16 copy of the cache it reads (``copy_bytes``) besides: the payload is
    read in place, not dequantized into a copy. Returns the bytes ``fn``
    asked the allocator for beyond what was held before it, at its peak.
    Counted as requested, not as the blocks handed out: the caching allocator
    may hand a 2 MiB output a cached block up to 1 MiB larger, unsplit."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_stats()["requested_bytes.all.current"]
    fn()
    torch.cuda.synchronize()
    extra = torch.cuda.memory_stats()["requested_bytes.all.peak"] - base
    if extra - out_bytes >= 0.01 * copy_bytes:
        raise RuntimeError(f"{what} allocated {extra} bytes beside {out_bytes} of output: a dequantized copy?")
    return extra


def _quant_decode_case(card: str, what: str, mode: str, q, k_x, v_x, lengths, *, no_copy: bool = False) -> dict:
    """K6q over the fp32 rows k_x, v_x [B, 8, S, 128] quantized to ``mode``."""
    import torch
    import torch.nn.functional as F

    from flash_attention_tpu_torch.ops.decode import decode_attention, decode_attention_plain
    from flash_attention_tpu_torch.ops.quant import dequantize, payload_dtype, quantize_values
    from flash_attention_tpu_torch.ops.reference import reference_attention, reference_attention_with_lse

    scale = 128**-0.5
    kq, vq = quantize_values(k_x, payload_dtype(mode)), quantize_values(v_x, payload_dtype(mode))
    (out, lse), grid = _twice(f"K6q {mode} {what}", decode_attention,
                              lambda: decode_attention(q, kq, vq, lengths, save_residuals=True))
    p_out, p_lse = decode_attention_plain(q, kq, vq, lengths, sm_scale=scale, save_residuals=True)
    kd, vd = dequantize(kq), dequantize(vq)
    o_out, o_lse = reference_attention_with_lse(q[:, :, None], kd, vd, kv_length=lengths)
    d_plain, d_oracle, d_rel, d_lse = _hold_quant(f"K6q {mode} {what}", out, p_out, o_out[:, :, 0], lse, p_lse, o_lse[:, :, 0])
    d_quant = _max_diff(out, reference_attention(q[:, :, None], k_x, v_x, kv_length=lengths)[:, :, 0])
    del p_out, o_out
    batch, hq, d = q.shape
    copy_bytes = 2 * kd.numel() * 2
    extra = _no_copy(f"K6q {mode} {what}", lambda: decode_attention(q, kq, vq, lengths, save_residuals=True),
                     out.numel() * out.element_size() + lse.numel() * 4, copy_bytes) if no_copy else None
    ms = cuda_ms(lambda: decode_attention(q, kq, vq, lengths, save_residuals=True))
    plain_ms = cuda_ms(lambda: decode_attention_plain(q, kq, vq, lengths, sm_scale=scale, save_residuals=True))
    # Context, not a yardstick: no single PyTorch call reads a quantized
    # cache; SDPA on a bf16 cache of the same (dequantized) values.
    kb, vb = kd.to(torch.bfloat16), vd.to(torch.bfloat16)
    del kd, vd
    mask = (torch.arange(kb.shape[2], device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kb, vb, attn_mask=mask, enable_gqa=True))
    bf16_ms = cuda_ms(lambda: decode_attention(q, kb, vb, lengths, save_residuals=True))  # K6 on the same values
    del kb, vb
    rows, hkv = int(lengths.sum()), k_x.shape[1]
    item = kq.values.element_size()
    nbytes = 2 * rows * hkv * (d * item + 4) + 2 * 2 * q.numel() + 4 * (lse.numel() + batch)
    bound_ms, bound_by = bound(4 * d * hq * rows + 2 * 2 * d * hkv * rows, nbytes)
    log(
        f"[K6q] {mode} {what}, {grid}, bit-identical over two calls: |out-plain| {d_plain:.3e}, |out-oracle| "
        f"{d_oracle:.3e} (bar {ORACLE_BAR}), "
        f"row-relative {d_rel:.3e} (bar {REL_BAR['bfloat16']}), |lse| {d_lse:.3e} (bar {LSE_BAR}); quantization "
        f"error |out - oracle on unquantized rows| {d_quant:.3e} (information)"
        + ("" if extra is None else f"; allocated {extra / 1e6:.3f} MB in the call (a bf16 copy: {copy_bytes / 1e6:.0f} MB)")
        + f"; kernel {ms:.4f} ms (K6 on a bf16 copy {bf16_ms:.4f} ms), plain {plain_ms:.4f} ms, library none (SDPA on "
        f"a bf16 copy {sdpa_ms:.4f} ms), bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB) ({card})"
    )
    return {"max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _quant_pages(mode: str, num_layers: int, num_pages: int, num_slots: int, pages_per_slot: int, gen, rng,
                 *, kv_heads: int = 8, head_dim: int = 128, dump_slot: bool = True, page_size: int = 128):
    """A quantized PagedModelCache (pages of 128 rows unless ``page_size``
    says otherwise) filled from scaled fp32 rows over a shuffled table; and
    the fp32 rows (pools [L, P, kv_heads, page_size, head_dim]) it was
    quantized from."""
    import torch

    from flash_attention_tpu_torch.ops.paged import init_paged_model_cache
    from flash_attention_tpu_torch.ops.quant import bits, quantize_values

    cache = init_paged_model_cache(num_layers, num_pages=num_pages, num_slots=num_slots, pages_per_slot=pages_per_slot,
                                   kv_heads=kv_heads, page_size=page_size, head_dim=head_dim, kv_quant=mode,
                                   device="cuda")
    rows = []
    for pool, scales in ((cache.k_pool, cache.k_scales), (cache.v_pool, cache.v_scales)):
        x = scaled_rows(tuple(pool.shape), gen)
        qt = quantize_values(x, pool.dtype)
        bits(pool).copy_(bits(qt.values))
        scales.copy_(qt.scales[..., 0])
        rows.append(x)
    table = torch.from_numpy(_shuffled_table(rng, num_slots, pages_per_slot, num_pages, dump_slot=dump_slot)).cuda()
    cache.page_table.copy_(table)
    return cache, rows


def _dequant_pool(pages, scales):
    return pages.float() * scales[..., None]


def _quant_paged_decode_case(card: str, what: str, mode: str, layer, x_rows, q, *, no_copy: bool = False) -> dict:
    """K7q over one layer's quantized pages (PagedKVCache ``layer``, its
    lengths and table set), made from the fp32 pools ``x_rows``."""
    import torch

    from flash_attention_tpu_torch.ops.paged import paged_decode_attention, paged_decode_attention_plain
    from flash_attention_tpu_torch.ops.reference import reference_attention, reference_attention_with_lse

    scale = 128**-0.5
    table, lengths = layer.page_table, layer.lengths
    (out, lse), grid = _twice(f"K7q {mode} {what}", paged_decode_attention,
                              lambda: paged_decode_attention(q, layer, save_residuals=True))
    p_out, p_lse = paged_decode_attention_plain(q, layer, sm_scale=scale, save_residuals=True)
    kd = _dense_from_pages(_dequant_pool(layer.k_pages, layer.k_scales), table)
    vd = _dense_from_pages(_dequant_pool(layer.v_pages, layer.v_scales), table)
    o_out, o_lse = reference_attention_with_lse(q[:, :, None], kd, vd, kv_length=lengths)
    del kd, vd
    d_plain, d_oracle, d_rel, d_lse = _hold_quant(f"K7q {mode} {what}", out, p_out, o_out[:, :, 0], lse, p_lse, o_lse[:, :, 0])
    del p_out, o_out
    ku, vu = (_dense_from_pages(x, table) for x in x_rows)
    d_quant = _max_diff(out, reference_attention(q[:, :, None], ku, vu, kv_length=lengths)[:, :, 0])
    del ku, vu
    if not (bool((out[lengths == 0] == 0).all()) and bool(torch.isneginf(lse[lengths == 0]).all())):
        raise RuntimeError(f"K7q {mode} {what}: a slot of length 0 must give output 0 and LSE -inf")
    slots, hq, d = q.shape
    rows = int(lengths.sum())
    copy_bytes = 2 * rows * 8 * d * 2
    extra = _no_copy(f"K7q {mode} {what}", lambda: paged_decode_attention(q, layer, save_residuals=True),
                     out.numel() * out.element_size() + lse.numel() * 4, copy_bytes) if no_copy else None
    ms = cuda_ms(lambda: paged_decode_attention(q, layer, save_residuals=True))
    plain_ms = cuda_ms(lambda: paged_decode_attention_plain(q, layer, sm_scale=scale, save_residuals=True))
    # K7 over bf16 pages of the same values, for comparison.
    bf16_pages = [_dequant_pool(layer.k_pages, layer.k_scales).to(torch.bfloat16),
                  _dequant_pool(layer.v_pages, layer.v_scales).to(torch.bfloat16)]
    as_bf16 = layer._replace(k_pages=bf16_pages[0], v_pages=bf16_pages[1], k_scales=None, v_scales=None)
    bf16_ms = cuda_ms(lambda: paged_decode_attention(q, as_bf16, save_residuals=True))
    del bf16_pages, as_bf16
    pages_read = sum(-(-n // 128) for n in lengths.tolist())
    item = layer.k_pages.element_size()
    nbytes = 2 * rows * 8 * (d * item + 4) + 2 * 2 * q.numel() + 4 * (lse.numel() + slots + pages_read)
    bound_ms, bound_by = bound(4 * d * hq * rows + 2 * 2 * d * 8 * rows, nbytes)
    log(
        f"[K7q] {mode} {what}, {grid}, bit-identical over two calls: |out-plain| {d_plain:.3e}, |out-oracle| "
        f"{d_oracle:.3e} (bar {ORACLE_BAR}), "
        f"row-relative {d_rel:.3e} (bar {REL_BAR['bfloat16']}), |lse| {d_lse:.3e} (bar {LSE_BAR}); quantization "
        f"error {d_quant:.3e} (information)"
        + ("" if extra is None else f"; allocated {extra / 1e6:.3f} MB in the call (a bf16 copy: {copy_bytes / 1e6:.0f} MB)")
        + f"; kernel {ms:.4f} ms (K7 on bf16 pages {bf16_ms:.4f} ms), plain {plain_ms:.4f} ms, library none, "
        f"bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB) ({card})"
    )
    return {"max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _widen_exact() -> None:
    """T1's counterpart: K6 with fp32 queries, length 1 and scale 1 over V
    rows that hold every finite code of each payload type returns the codes
    exactly (one row's softmax weight is exactly 1), which pins the widen."""
    import torch

    from flash_attention_tpu_torch.ops.decode import decode_attention
    from flash_attention_tpu_torch.ops.quant import QuantizedTensor, payload_dtype

    for mode in QUANT_MODES:
        payload = payload_dtype(mode)
        every = torch.arange(256, dtype=torch.int32).to(torch.uint8)
        codes = every[torch.isfinite(every.view(payload).float())]  # int8: all 256; fp8: not NaN or inf
        n = codes.numel()
        padded = torch.zeros(2 * 128, dtype=torch.uint8)
        padded[:n] = codes
        v = padded.view(payload).reshape(2, 1, 1, 128).cuda()
        k = torch.zeros_like(v)
        ones = torch.ones((2, 1, 1, 1), dtype=torch.float32, device="cuda")
        q = torch.ones((2, 1, 128), dtype=torch.float32, device="cuda")
        out = decode_attention(q, QuantizedTensor(k, ones), QuantizedTensor(v, ones),
                               torch.ones(2, dtype=torch.int32, device="cuda"))
        want = v.float().reshape(2, 1, 128)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            bad = (out != want).nonzero()[:4].tolist()
            raise RuntimeError(f"K6 widen of {mode}: output differs from the codes at {bad}")
        log(f"[quant] K6 widen, {mode}: all {n} finite codes returned exactly (fp32 queries, one row, scale 1)")


def phase_quant_kernels(card: str):
    """Phase 9: K6q, K7q, K8q and K9q/K10q with bf16 queries for every
    payload type, over caches whose rows are scaled one by one; queries are
    scaled by 8 so the softmax is peaked. Returns the report entries of K6q
    (int8), K7q, K8q and K10q (fp8 e4m3): the types the phase-11 paths use."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.ops.paged import (
        PagedModelCache,
        paged_prefill_attention,
        paged_prefill_attention_plain,
        paged_write_tokens,
        paged_write_tokens_multi,
        paged_write_tokens_plain,
    )
    from flash_attention_tpu_torch.ops.quant import bits
    from flash_attention_tpu_torch.ops.reference import reference_attention

    bf16 = torch.bfloat16
    rng = np.random.default_rng(9)
    gen = torch.Generator(device="cuda").manual_seed(9)
    report = {}
    _widen_exact()

    # K6q at phase 3's shape and lengths, then at 32 slots x 8192 rows.
    lengths = torch.tensor([0, 1, 255, 256, 1000, 2047, 2048, 7], dtype=torch.int32, device="cuda")
    q = (torch_uniform((8, 32, 128), torch.float32, gen) * 8).to(bf16)
    for mode in QUANT_MODES:
        k_x, v_x = scaled_rows((8, 8, 2048, 128), gen), scaled_rows((8, 8, 2048, 128), gen)
        entry = _quant_decode_case(card, "q [8,32,128] cache [8,8,2048,128], phase 3's lengths", mode, q, k_x, v_x, lengths)
        if mode == "int8":
            report["K6q"] = entry
    slots, rows = LONG["slots"], LONG["rows"]
    q = (torch_uniform((slots, 32, 128), torch.float32, gen) * 8).to(bf16)
    lengths = torch.full((slots,), rows, dtype=torch.int32, device="cuda")
    for mode in QUANT_MODES:
        k_x, v_x = scaled_rows((slots, 8, rows, 128), gen), scaled_rows((slots, 8, rows, 128), gen)
        _quant_decode_case(card, f"q [{slots},32,128] cache [{slots},8,{rows},128], every slot full", mode, q, k_x, v_x,
                           lengths, no_copy=True)
        del k_x, v_x

    # K7q at phase 6's shape and lengths (slot 0 on the dump page), then at
    # 32 slots x 64 pages of 128 rows; K8q over phase 6's cache.
    q = (torch_uniform((8, 32, 128), torch.float32, gen) * 8).to(bf16)
    for mode in QUANT_MODES:
        cache, x_rows = _quant_pages(mode, 1, 129, 8, 16, gen, rng)
        layer = cache._replace(lengths=torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device="cuda")).layers()[0]
        x_rows = [x[0] for x in x_rows]
        entry = _quant_paged_decode_case(card, f"q [8,32,128] pages [129,8,128,128], lengths {list(PAGED_LENGTHS)}",
                                         mode, layer, x_rows, q)
        if mode == "fp8_e4m3":
            report["K7q"] = entry
        kd = _dense_from_pages(_dequant_pool(layer.k_pages, layer.k_scales), layer.page_table)
        vd = _dense_from_pages(_dequant_pool(layer.v_pages, layer.v_scales), layer.page_table)
        ku, vu = (_dense_from_pages(x, layer.page_table)[7:8] for x in x_rows)
        zero_counts()
        for kv_end in (256, 1024, 2048):
            qc = (torch_uniform((1, 32, 256, 128), torch.float32, gen) * 8).to(bf16)
            out = paged_prefill_attention(qc, layer, 7, kv_end, chunk_len=256)
            p_out = paged_prefill_attention_plain(qc, layer, 7, kv_end, sm_scale=128**-0.5)
            o_out = reference_attention(qc, kd[7:8, :, :kv_end], vd[7:8, :, :kv_end], causal=True)
            d_plain, d_oracle, d_rel, _ = _hold_quant(f"K8q {mode} kv_end {kv_end}", out, p_out, o_out)
            d_quant = _max_diff(out, reference_attention(qc, ku[:, :, :kv_end], vu[:, :, :kv_end], causal=True))
            copy_bytes = 2 * kv_end * 8 * 128 * 2
            extra = _no_copy(f"K8q {mode} kv_end {kv_end}", lambda: paged_prefill_attention(qc, layer, 7, kv_end, chunk_len=256),
                             out.numel() * out.element_size(), copy_bytes)
            ms = cuda_ms(lambda: paged_prefill_attention(qc, layer, 7, kv_end, chunk_len=256))
            plain_ms = cuda_ms(lambda: paged_prefill_attention_plain(qc, layer, 7, kv_end, sm_scale=128**-0.5))
            item = layer.k_pages.element_size()
            nbytes = 2 * (2 * qc.numel()) + 2 * kv_end * 8 * (128 * item + 4) + 4 * (kv_end // 128)
            bound_ms, bound_by = bound(4 * 128 * 32 * causal_pairs(256, kv_end) + 2 * 2 * 128 * 8 * kv_end, nbytes)
            log(
                f"[K8q] {mode} q [1,32,256,128] over slot 7's pages to kv_end {kv_end}: |out-plain| {d_plain:.3e}, "
                f"|out-oracle| {d_oracle:.3e} (bar {ORACLE_BAR}), row-relative {d_rel:.3e} (bar "
                f"{REL_BAR['bfloat16']}); quantization error {d_quant:.3e} (information); allocated "
                f"{extra / 1e6:.3f} MB in the call, its output "
                f"{out.numel() * 2 / 1e6:.3f} MB; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library none, "
                f"bound {bound_ms:.4f} ms by {bound_by} ({card})"
            )
            if mode == "fp8_e4m3" and kv_end == 2048:
                report["K8q"] = {"max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                                 "bound_ms": bound_ms, "bound_by": bound_by}
        bodies = read_bodies()
        check_tensor_cores(f"[K8q] {mode}", bodies, "K8/K8q")
        log(f"[K8q] {mode}, bf16 queries: launches by body {bodies} (the tensor-core body, csrc/flash_fwd_sm90.cu)")
        del cache, layer, x_rows, kd, vd, ku, vu
    q = (torch_uniform((slots, 32, 128), torch.float32, gen) * 8).to(bf16)
    pages_per_slot = rows // 128
    for mode in QUANT_MODES:
        cache, x_rows = _quant_pages(mode, 1, 1 + slots * pages_per_slot, slots, pages_per_slot, gen, rng, dump_slot=False)
        layer = cache._replace(lengths=torch.full((slots,), rows, dtype=torch.int32, device="cuda")).layers()[0]
        _quant_paged_decode_case(card, f"q [{slots},32,128] pages [{1 + slots * pages_per_slot},8,128,128], "
                                 f"every slot {rows} rows", mode, layer, [x[0] for x in x_rows], q, no_copy=True)
        del cache, layer, x_rows

    # K10q: one bf16 row per slot quantized into 32 layers; slot 0 is a
    # released slot (dump-page table, frozen length 37), slot 1 at capacity.
    num_layers = 32
    for mode in QUANT_MODES:
        cache, _ = _quant_pages(mode, num_layers, 129, 8, 16, gen, rng)
        w_lengths = torch.tensor([37, 2048, 5, 127, 128, 129, 1000, 2047], dtype=torch.int32, device="cuda")
        cache = cache._replace(lengths=w_lengths)
        slots8 = torch.arange(8, device="cuda")
        k_new = scaled_rows((num_layers, 8, 8, 128), gen).to(bf16)
        v_new = scaled_rows((num_layers, 8, 8, 128), gen).to(bf16)
        plain = PagedModelCache(*(t.clone() for t in cache))
        written = paged_write_tokens_multi(cache, k_new, v_new, slots8)
        valid = paged_write_tokens_plain(plain, k_new, v_new, slots8)
        torch.cuda.synchronize()

        def same() -> bool:
            return (all(torch.equal(bits(a), bits(b)) for a, b in ((cache.k_pool, plain.k_pool), (cache.v_pool, plain.v_pool)))
                    and torch.equal(cache.k_scales, plain.k_scales) and torch.equal(cache.v_scales, plain.v_scales))

        if not (same() and valid.tolist() == [1, 0, 1, 1, 1, 1, 1, 1] and torch.equal(written.lengths, w_lengths + valid)):
            raise RuntimeError(f"K10q {mode}: payload or scales not bit-equal to plain, or lengths advanced wrongly")
        ms = cuda_ms(lambda: paged_write_tokens_multi(cache, k_new, v_new, slots8))
        plain_ms = cuda_ms(lambda: paged_write_tokens_plain(plain, k_new, v_new, slots8))
        n_valid = int(valid.sum())
        item = cache.k_pool.element_size()
        nbytes = 2 * num_layers * n_valid * 8 * (128 * 2 + 128 * item + 4) + 4 * 4 * 8
        bound_ms, bound_by = bound(0, nbytes)
        # K9q: the same kernel with one layer, new rows into layer 0.
        k_one, v_one = scaled_rows((8, 8, 128), gen).to(bf16), scaled_rows((8, 8, 128), gen).to(bf16)
        plain_one = PagedModelCache(*(None if t is None else t[:1] if t.dim() > 2 else t for t in plain))
        layer0 = cache.layers()[0]
        paged_write_tokens(layer0, k_one, v_one, slots8)
        paged_write_tokens_plain(plain_one, k_one[None], v_one[None], slots8)
        torch.cuda.synchronize()
        if not same():
            raise RuntimeError(f"K9q {mode} (one layer): not bit-equal to plain")
        launches = (_launches_a_call(lambda: paged_write_tokens_multi(cache, k_new, v_new, slots8)),
                    _launches_a_call(lambda: paged_write_tokens(layer0, k_one, v_one, slots8)))
        ms9 = cuda_ms(lambda: paged_write_tokens(layer0, k_one, v_one, slots8))
        plain9 = cuda_ms(lambda: paged_write_tokens_plain(plain_one, k_one[None], v_one[None], slots8))
        bound9, by9 = bound(0, 2 * n_valid * 8 * (128 * 2 + 128 * item + 4) + 4 * 4 * 8)
        log(
            f"[K10q] {mode}: 32 layers x 8 slots x bf16 rows [8,128] quantized into pools [32,129,8,128,128], one "
            f"slot at capacity, one on the dump page: payload and scales bit-equal to plain, lengths advanced where "
            f"valid {valid.tolist()}; K10q and K9q {launches} launch a call; wrapper {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library none, bound "
            f"{bound_ms:.5f} ms by {bound_by} ({nbytes / 1e6:.2f} MB); K9q (one layer) bit-equal, wrapper "
            f"{ms9:.4f} ms, plain {plain9:.4f} ms, bound {bound9:.6f} ms by {by9} ({card})"
        )
        if mode == "fp8_e4m3":
            report["K10q"] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                              "bound_ms": bound_ms, "bound_by": bound_by}
        del cache, plain, plain_one
    torch.cuda.empty_cache()
    source = "flash_attention_tpu_torch/csrc/"
    names = {
        "K6q": ("decode_quant (K6q)", "decode.cu", "ops/decode.py:56"),
        "K7q": ("paged_decode_quant (K7q)", "decode.cu", "ops/paged.py:980"),
        "K8q": ("fwd_kernel, wgmma + TMA, paged, 1-byte payload (K8q)", "flash_fwd_sm90.cu", "ops/paged.py:580"),
        "K10q": ("paged_write_quant (K9q/K10q)", "paged_write.cu", "ops/paged.py:257"),
    }
    return {key: {"name": names[key][0], "route": "cuda", "source": source + names[key][1],
                  "replaces": f"{REFERENCE}/{names[key][2]}", **entry} for key, entry in report.items()}


def phase_quant_sweep() -> None:
    """Every (query dtype, payload, head_dim) instantiation of K6q, K7q, K8q
    and K9q/K10q at ragged shapes: lengths off the 64-row tiles, GQA groups
    of 1 and 16, an empty slot on the dump page, a slot at capacity."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.ops.decode import decode_attention, decode_attention_plain
    from flash_attention_tpu_torch.ops.paged import (
        PagedModelCache,
        paged_decode_attention,
        paged_decode_attention_plain,
        paged_prefill_attention,
        paged_prefill_attention_plain,
        paged_write_tokens_multi,
        paged_write_tokens_plain,
    )
    from flash_attention_tpu_torch.ops.quant import bits, dequantize, payload_dtype, quantize_values
    from flash_attention_tpu_torch.ops.reference import reference_attention, reference_attention_with_lse

    rng = np.random.default_rng(10)
    gen = torch.Generator(device="cuda").manual_seed(10)
    worst = 0.0
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for d in (32, 64, 128):
            for hq, hkv in ((4, 4), (16, 1)):
                for mode in QUANT_MODES:
                    what = f"{mode} {dtype} d={d} {hq}/{hkv}"

                    def hold(kernel, *outs):
                        return _hold_quant(f"{kernel} {what}", *outs, dtype=name)[2] / REL_BAR[name]

                    # K6q over a dense [2, hkv, 130, d] cache, lengths {0, 130}.
                    kq, vq = (quantize_values(scaled_rows((2, hkv, 130, d), gen), payload_dtype(mode)) for _ in range(2))
                    q = (torch_uniform((2, hq, d), torch.float32, gen) * 8).to(dtype)
                    lengths = torch.tensor([0, 130], dtype=torch.int32, device="cuda")
                    out, lse = decode_attention(q, kq, vq, lengths, save_residuals=True)
                    p_out, p_lse = decode_attention_plain(q, kq, vq, lengths, sm_scale=d**-0.5, save_residuals=True)
                    o_out, o_lse = reference_attention_with_lse(q[:, :, None], dequantize(kq), dequantize(vq), kv_length=lengths)
                    worst = max(worst, hold("K6q", out, p_out, o_out[:, :, 0], lse, p_lse, o_lse[:, :, 0]))
                    # K7q, K8q and K10q over two layers of 3 slots x 2 pages.
                    cache, _ = _quant_pages(mode, 2, 7, 3, 2, gen, rng, kv_heads=hkv, head_dim=d)
                    layer = cache._replace(lengths=torch.tensor([0, 37, 200], dtype=torch.int32, device="cuda")).layers()[0]
                    kd = _dense_from_pages(_dequant_pool(layer.k_pages, layer.k_scales), layer.page_table)
                    vd = _dense_from_pages(_dequant_pool(layer.v_pages, layer.v_scales), layer.page_table)
                    q = (torch_uniform((3, hq, d), torch.float32, gen) * 8).to(dtype)
                    out, lse = paged_decode_attention(q, layer, save_residuals=True)
                    p_out, p_lse = paged_decode_attention_plain(q, layer, sm_scale=d**-0.5, save_residuals=True)
                    o_out, o_lse = reference_attention_with_lse(q[:, :, None], kd, vd, kv_length=layer.lengths)
                    worst = max(worst, hold("K7q", out, p_out, o_out[:, :, 0], lse, p_lse, o_lse[:, :, 0]))
                    qc = (torch_uniform((1, hq, 128, d), torch.float32, gen) * 8).to(dtype)
                    out = paged_prefill_attention(qc, layer, 2, 200, chunk_len=128)
                    p_out = paged_prefill_attention_plain(qc, layer, 2, 200, sm_scale=d**-0.5)
                    o_out = reference_attention(qc, kd[2:3, :, :200], vd[2:3, :, :200], causal=True)
                    worst = max(worst, hold("K8q", out, p_out, o_out))
                    cache = cache._replace(lengths=torch.tensor([5, 127, 256], dtype=torch.int32, device="cuda"))
                    k_new, v_new = (scaled_rows((2, 3, hkv, d), gen).to(dtype) for _ in range(2))
                    plain = PagedModelCache(*(t.clone() for t in cache))
                    slots = torch.tensor([2, 0, 1], device="cuda")
                    written = paged_write_tokens_multi(cache, k_new, v_new, slots)
                    valid = paged_write_tokens_plain(plain, k_new, v_new, slots)
                    if not (all(torch.equal(bits(a), bits(b)) for a, b in zip(cache, plain))
                            and valid.tolist() == [0, 1, 1] and written.lengths.tolist() == [6, 128, 256]):
                        raise RuntimeError(f"K10q {what}: not bit-equal to plain")
    torch.cuda.synchronize()
    log(
        "[quant sweep] K6q, K7q, K8q and K9q/K10q at fp32/fp16/bf16 queries x int8/e4m3/e5m2 payloads x head_dim "
        "32/64/128 x groups 1/16, lengths {0 (dump page), 37, 200 | 130}: all within 0.1 of the oracle on the "
        f"dequantized cache, LSE within {LSE_BAR}, writes bit-equal (payload and scales); worst row-relative "
        f"difference at {worst:.3f} of its bar {REL_BAR}"
    )
    log(_prefill_edge_sweep("quant"))


def phase_tiny_quant() -> None:
    """Phase 10: the tiny fp32 model with each kv_quant mode and with int8
    weights through both engines on the card and on the CPU (with int8
    weights every product on W1, none without)."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params
    from flash_attention_tpu_torch.serving.engine import Request, ServingEngine
    from flash_attention_tpu_torch.serving.paged_engine import PagedServingEngine

    rng = np.random.default_rng(23)
    prefix = tuple(int(t) for t in rng.integers(0, TINY_CFG["vocab_size"], 256))
    shared = [Request(id=10 + i, prompt=prefix + tuple(int(t) for t in rng.integers(0, TINY_CFG["vocab_size"], 40)),
                      max_new_tokens=8) for i in range(3)]
    for variant in [{"kv_quant": m} for m in QUANT_MODES] + [{"weight_quant": "int8"}]:
        cfg = ModelConfig(**TINY_CFG, **variant)
        params = init_model_params(torch.Generator().manual_seed(0), cfg)
        tokens = {}
        for device in ("cuda", "cpu"):
            on = _to_device(params, device)
            dense = ServingEngine(on, cfg, max_slots=3, max_seq=64, prefill_chunk=16)
            paged = PagedServingEngine(on, cfg, max_slots=3, num_pages=16, pages_per_slot=2, page_size=128)
            for name, eng in (("dense", dense), ("paged", paged)):
                tokens[name, device] = replayed_tokens(f"[tiny quant] {name}", eng, tiny_requests())
                # fp32 activations: every product with an int8 weight on W1's FMA body, none widened.
                w8 = {key: read_counts()[key] for key in ("W1", "W2")}
                if device == "cuda" and (w8["W2"] or bool(w8["W1"]) != ("weight_quant" in variant)):
                    raise RuntimeError(f"[tiny quant] {variant}, {name}: W8A16 launches {w8}")
        label = ", ".join(f"{k}={v}" for k, v in variant.items())
        for name in ("dense", "paged"):
            if tokens[name, "cuda"] != tokens[name, "cpu"]:
                raise RuntimeError(f"[tiny quant] {label}, {name}: card tokens {tokens[name, 'cuda']} != CPU "
                                   f"{tokens[name, 'cpu']}")
        # Over a quantized cache the paged engine merges the current token's
        # self term at full precision and the dense engine attends it as
        # stored, quantized, as in the JAX package, whose two engines diverge
        # on this model too: the engines must agree on the prefill's token
        # and the rest is information. Over an unquantized cache they agree.
        dense, paged = tokens["dense", "cuda"], tokens["paged", "cuda"]
        if ("kv_quant" not in variant and paged != dense) or any(paged[r][0] != dense[r][0] for r in dense):
            raise RuntimeError(f"[tiny quant] {label}: paged tokens {paged} vs dense {dense}")
        diverge = {rid: next((i for i, (a, b) in enumerate(zip(dense[rid], paged[rid])) if a != b), None) for rid in dense}
        on_card = _to_device(params, "cuda")
        hits, with_cache = {}, {}
        for cached in (False, True):
            eng = PagedServingEngine(on_card, cfg, max_slots=2, num_pages=16, pages_per_slot=4, page_size=128,
                                     prefill_chunk=128, prefix_cache=cached)
            with_cache[cached] = {r.id: eng.run([r])[r.id].tokens for r in shared}
            hits[cached] = eng.prefix_hits
        if hits[True] <= 0 or with_cache[True] != with_cache[False]:
            raise RuntimeError(f"[tiny quant] {label}: prefix cache hits {hits[True]}, tokens "
                               f"{with_cache[True]} vs {with_cache[False]}")
        log(
            f"[tiny quant] {label}: both engines' tokens on the card (every decode block replayed) == on the CPU; "
            f"paged vs dense, first "
            f"differing token per request {diverge} (None: identical); shared 256-token prefix: prefix_hits "
            f"{hits[True]}, tokens with cache == without"
        )


def phase_full_quant(card: str, params, dense: dict, paged: dict) -> dict:
    """Phase 11: phase 5's weights at full width, (a) int8 weights and an
    int8 cache through ServingEngine on phase 5's requests (every product
    with an int8 weight on W1 or W2, csrc/w8.cu), (b) an fp8_e4m3 cache
    through PagedServingEngine on phase 8's runs. Returns the launch counts
    of both main paths."""
    from flash_attention_tpu_torch.models.transformer import ModelConfig, quantize_model_weights

    params_w8 = quantize_model_weights(params)
    cfg_a = ModelConfig(kv_quant="int8", weight_quant="int8")
    launches_a, numbers_a = serve_full_dense(card, "full quant a", cfg_a, params_w8,
                                             used=("K1q", "K6q", "W1", "W2", *SERVED),
                                             ref=dense, w1_per_step=4 * cfg_a.num_layers + 1)
    del params_w8
    # Phase 5's bf16 weights stay allocated through 11a; less them, 11a's peak is its own (W1 / W2 read the int8
    # weights: no 16-bit copy of one is made).
    own = numbers_a["peak_gib"] - _nbytes(params) / 2**30
    log(f"[full quant a] peak device memory less phase 5's bf16 weights (allocated throughout): {own:.2f} GiB; phase "
        f"5's peak {dense['peak_gib']:.2f} GiB ({card})")
    if own >= dense["peak_gib"]:
        raise RuntimeError(f"[full quant a] peak device memory {own:.2f} GiB of its own, not below phase 5's "
                           f"{dense['peak_gib']:.2f}")
    launches_b, _ = serve_full_paged(card, "full quant b", ModelConfig(kv_quant="fp8_e4m3"), params,
                                     used=("K7q", "K8q", "K9q/K10q", *SERVED), dense=dense, ref=paged)
    return {"K1q": launches_a["K1q"], "K6q": launches_a["K6q"], "K7q": launches_b["K7q"], "K8q": launches_b["K8q"], "K10q": launches_b["K9q/K10q"],
            "W1": launches_a["W1"], "W2": launches_a["W2"]}


# The backward kernels' cases at the training path's shapes: (hq, hkv,
# q_len, kv_len, causal). ModelConfig() trains through K4 + K5 (32 q over 8
# kv heads); an MHA model (LLaMA-2-7B's 32 heads over 32) through K3.
BWD_CASES = (
    (32, 8, 2048, 2048, True),
    (32, 8, 256, 2048, True),
    (32, 32, 2048, 2048, True),
    (32, 32, 2048, 2048, False),
)
# Gradients, row by row against the plain version: max|kernel - plain| in
# the row over the row's largest |plain|, as REL_BAR does for the forward.
# A row whose largest value is under GRAD_FLOOR of the largest value of the
# three gradients is held to that floor instead: its terms cancel (the first
# causal row's dq is 0 up to rounding, and with a single key dq and dk are 0
# everywhere), so it has no scale of its own.
GRAD_FLOOR = 1e-3
TRAIN_TOKENS = 2048  # the training sequence of the JAX package's benchmark (bench.py:483)
SGD_LRS = (1.0, 0.3, 0.1, 0.03)  # the SGD check's steps, largest first


def _bwd_inputs(seed: int, hq: int, hkv: int, q_len: int, kv_len: int, d: int, dtype, *, strided_do: bool = True,
                batch: int = 1):
    """U(-0.5, 0.5) q, k, v and an N(0, 1) cotangent dO. With ``strided_do``
    dO is a [B, S, H, D] buffer seen as [B, H, S, D] (unit last stride,
    strided heads and rows), as a cotangent coming back through the output
    projection's einsum may be."""
    import torch

    from flash_attention_tpu_torch.utils.testing import make_qkv

    q, k, v = make_qkv(seed, batch, hq, q_len, d, num_kv_heads=hkv, kv_seq=kv_len, dtype=dtype, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if strided_do:
        do = torch.randn((batch, q_len, hq, d), generator=gen, device="cuda").to(dtype).transpose(1, 2)
    else:
        do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    return q, k, v, do


def _splits(batch: int, hq: int, hkv: int, kv_len: int, dtype) -> int:
    """The blocks K5 splits a kv tile's GQA group over on this card: 1 in
    fp32 (the FMA body), ``dkv_splits`` in bf16 / fp16."""
    import torch

    from flash_attention_tpu_torch.ops.attention_bwd import TENSOR_CORE_DTYPES, dkv_splits

    if dtype not in TENSOR_CORE_DTYPES:
        return 1
    return dkv_splits(batch, hkv, kv_len, hq // hkv, torch.cuda.get_device_properties(0).multi_processor_count)


def _route(hq: int, hkv: int, q_len: int, kv_len: int, window=None, softcap=None, segment_ids=None, *, dtype=None,
           batch: int = 1) -> tuple:
    """The kernels one causal-or-not call under grad launches: its forward
    (K1d with segment ids, K2 for a window of at most 64, else K1) and its
    backward (K3 for MHA self-attention, else K4 + K5; K3m, K4m, K5m, their
    masked instantiations, with any mask; and K5s, K5's split sum, where
    ``_splits`` of a bf16 / fp16 call is above 1)."""
    if segment_ids is not None:
        fwd = "K1d"
    else:
        fwd = "K2" if window is not None and window <= 64 else "K1"
    bwd = ("K3",) if hq == hkv and q_len == kv_len else ("K4", "K5")
    masked = window is not None or softcap is not None or segment_ids is not None
    split = ("K5s",) if bwd != ("K3",) and _splits(batch, hq, hkv, kv_len, dtype) > 1 else ()
    return (fwd, *(name + "m" if masked else name for name in bwd), *split)


def _hold_bwd(what: str, q, k, v, do, causal: bool = True, *, rel_bar: float, window=None, softcap=None,
              segment_ids=None):
    """The card's gradients through flash_attention's autograd Function (the
    forward with LSE, then K3 or K4 + K5), under an optional window, softcap
    and segment ids, against flash_attention_bwd_plain on the same
    residuals (row by row, ``rel_bar``) and autograd through the fp32
    oracle with the same masks (ORACLE_BAR), both ``_by_kv_head``; the call
    must launch exactly its route's kernels (``_route``). Returns (the
    grads, the residuals, |g - plain|, row-relative, |g - oracle|)."""
    import torch

    from flash_attention_tpu_torch.ops.attention_bwd import flash_attention_bwd_plain
    from flash_attention_tpu_torch.ops.common import segment_pair
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention
    from flash_attention_tpu_torch.ops.reference import reference_attention

    scale = q.shape[-1] ** -0.5
    masks = dict(sliding_window=window, logit_softcap=softcap, segment_ids=segment_ids)
    segments = segment_pair(segment_ids, q.shape[0], q.shape[2], k.shape[2])
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    zero_counts()
    out = flash_attention(*leaves, causal=causal, **masks)
    if type(out.grad_fn).__name__ != "FlashAttentionFunctionBackward":
        raise RuntimeError(f"{what}: the card's output has grad_fn {out.grad_fn}, not the port's autograd Function")
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    check_launches(what, read_counts(), _route(q.shape[1], k.shape[1], q.shape[2], k.shape[2], window, softcap,
                                               segment_ids, dtype=q.dtype, batch=q.shape[0]))
    del leaves, out
    with torch.no_grad():
        out_r, lse = flash_attention(q, k, v, causal=causal, save_residuals=True, **masks)
        plain = _by_kv_head(lambda qh, oh, lh, dh, kh, vh: flash_attention_bwd_plain(
            qh, kh, vh, oh, lh, dh, causal=causal, sm_scale=scale, window=window, softcap=softcap, segments=segments),
            (q, out_r, lse, do), (k, v))

    def oracle_grads(qh, dh, kh, vh):
        inputs = [x.detach().float().requires_grad_() for x in (qh, kh, vh)]
        return torch.autograd.grad(reference_attention(*inputs, causal=causal, **masks), inputs, dh.float())

    oracle = _by_kv_head(oracle_grads, (q, do), (k, v))
    torch.cuda.synchronize()
    d_plain = max(_max_diff(g, w) for g, w in zip(grads, plain))
    floor = GRAD_FLOOR * max(float(w.abs().max()) for w in plain if w.numel())
    d_rel = max(_rel_diff(g, w, floor) for g, w in zip(grads, plain))
    d_oracle = max(_max_diff(g, w) for g, w in zip(grads, oracle))
    if not (d_oracle < ORACLE_BAR and d_rel < rel_bar):
        raise RuntimeError(f"{what}: |grad-oracle| {d_oracle:.3e} (bar {ORACLE_BAR}), row-relative to plain "
                           f"{d_rel:.3e} (bar {rel_bar})")
    return grads, (out_r, lse), d_plain, d_rel, d_oracle


def _same_twice(what: str, fn) -> None:
    """Two calls of ``fn`` on the same inputs return bit-identical tensors."""
    import torch

    first, second = fn(), fn()
    first = first if isinstance(first, tuple) else (first,)
    second = second if isinstance(second, tuple) else (second,)
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise RuntimeError(f"{what}: two calls on the same inputs differ")


def _rates(flops: float, ms: float) -> str:
    return f"{flops / ms / 1e9:.1f} TFLOP/s, {100 * flops / ms / 1e9 / (PEAK_FLOPS / 1e12):.1f} % of 989"


def phase_bwd_kernels(card: str) -> dict:
    """Phase 12: K3, K4 and K5 in bf16 at BWD_CASES, each through the
    autograd path and against its plain version and the oracle; kernel,
    plain, SDPA-backward and bound times, each kernel's TFLOP/s and share
    of the 989 TFLOP/s peak, the route's kernels over SDPA's backward (at
    the MHA cases K4 + K5 timed beside K3 for information); K4 and K5, and
    K3's dk and dv, twice on the same inputs, bit-identical (K5 split and
    not); then K5's split sum (K5s) alone on the T=2048 case's workspace
    against its plain version. Returns the report entries."""
    import torch
    import torch.nn.functional as F

    from flash_attention_tpu_torch.ops.attention_bwd import (
        _delta,
        _guard_lse,
        bwd_route,
        dkv_split_sum_plain,
        flash_attention_bwd_plain,
        launch_dkv,
        launch_dkv_sum,
        launch_dq,
        launch_fused,
    )
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention

    bf16, d = torch.bfloat16, 128
    report = {}
    for hq, hkv, q_len, kv_len, causal in BWD_CASES:
        route = bwd_route(hq, hkv, q_len, kv_len)
        shape = f"q [1,{hq},{q_len},{d}] kv [1,{hkv},{kv_len},{d}] bf16 {'causal' if causal else 'non-causal'}"
        q, k, v, do = _bwd_inputs(12, hq, hkv, q_len, kv_len, d, bf16)
        _, (out, lse), d_plain, d_rel, d_oracle = _hold_bwd(f"backward {shape}", q, k, v, do, causal,
                                                            rel_bar=REL_BAR["bfloat16"])
        args = (q, k, v, do, _guard_lse(lse).contiguous(), _delta(out, do).contiguous())
        kw = dict(causal=causal, sm_scale=d**-0.5)
        kernels = {"K3": launch_fused} if route == "fused" else {"K4": launch_dq, "K5": launch_dkv}
        for name, fn in kernels.items():
            # K3's dq adds its tiles' partials in a run-dependent order; its dk and dv are written once.
            _same_twice(f"backward {shape} {name}", lambda fn=fn: fn(*args, **kw)[1:] if name == "K3" else fn(*args, **kw))
        times = {name: cuda_ms(lambda fn=fn: fn(*args, **kw)) for name, fn in kernels.items()}
        # K4 + K5 on the MHA inputs, for information: the route stays K3.
        beside = "" if route != "fused" else (
            f"; K4 + K5 on the same inputs {cuda_ms(lambda: (launch_dq(*args, **kw), launch_dkv(*args, **kw))):.4f} ms "
            "(not the route)")
        # The forward of the same autograd call (K1 with its LSE), for the step's breakdown.
        fwd_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal, save_residuals=True))
        plain_ms = cuda_ms(lambda: flash_attention_bwd_plain(q, k, v, out, lse, do, **kw), warmup=2, iters=5)
        # The library yardstick: the backward of one SDPA call over the same dO.
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        if causal and q_len != kv_len:  # SDPA's is_causal aligns the mask at the top
            mask = torch.arange(kv_len, device="cuda")[None, :] <= torch.arange(q_len, device="cuda")[:, None] + (kv_len - q_len)
            lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, enable_gqa=hq != hkv)
        else:
            lib_out = F.scaled_dot_product_attention(*leaves, is_causal=causal, enable_gqa=hq != hkv)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True))
        del leaves, lib_out
        pairs = causal_pairs(q_len, kv_len) if causal else q_len * kv_len
        q_bytes, kv_bytes = 2 * q.numel(), 2 * k.numel()
        in_bytes = 2 * q_bytes + 2 * kv_bytes + 2 * 4 * hq * q_len  # q, dO, k, v, lse, delta
        products = {"K3": 5, "K4": 3, "K5": 4}
        outs = {"K3": q_bytes + 2 * kv_bytes, "K4": q_bytes, "K5": 2 * kv_bytes}
        parts = []
        for name, ms in times.items():
            flops = 2 * d * pairs * hq * products[name]
            bound_ms, bound_by = bound(flops, in_bytes + outs[name])
            parts.append(f"{name} {ms:.4f} ms ({_rates(flops, ms)}; bound {bound_ms:.4f} ms by {bound_by})")
            if (hq, hkv, q_len, kv_len, causal) in (BWD_CASES[0], BWD_CASES[2]):
                report[name] = {"max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                "bound_ms": bound_ms, "bound_by": bound_by}
        split = _splits(1, hq, hkv, kv_len, bf16)
        ratio = f"{sum(times.values()) / lib_ms:.3f}"
        log(
            f"[backward] {shape}, {route}: |grad-oracle| {d_oracle:.3e} (bar {ORACLE_BAR}), |grad-plain| "
            f"{d_plain:.3e}, row-relative to plain {d_rel:.3e} (bar {REL_BAR['bfloat16']}); "
            + ", ".join(parts) + (f" (K5 over {split} split(s), its sum included)" if route != "fused" else "")
            + f"; {' + '.join(times)} over SDPA's backward {ratio}{beside}; plain (dq, dk, dv) {plain_ms:.4f} ms, SDPA "
            f"backward (library, dq, dk, dv) {lib_ms:.4f} ms; its forward, K1 with LSE, {fwd_ms:.4f} ms ({card})"
        )
        del q, k, v, do, out, lse, args
    # K5s alone, at the T=2048 case's workspace [2, 1, 8, splits, 2048, 128].
    hq, hkv, q_len, kv_len, _ = BWD_CASES[0]
    splits = _splits(1, hq, hkv, kv_len, bf16)
    gen = torch.Generator(device="cuda").manual_seed(12)
    ws = torch.randn((2, 1, hkv, splits, kv_len, d), generator=gen, device="cuda")
    dk, dv = (torch.empty((1, hkv, kv_len, d), dtype=bf16, device="cuda") for _ in range(2))
    launch_dkv_sum(ws, dk, dv)
    plain = dkv_split_sum_plain(ws, bf16)
    err = max(_max_diff(a, b) for a, b in zip((dk, dv), plain))
    if err != 0.0:
        raise RuntimeError(f"K5s: |sum - plain| {err} (the same additions in the same order must agree exactly)")
    sum_ms = cuda_ms(lambda: launch_dkv_sum(ws, dk, dv))
    sum_plain_ms = cuda_ms(lambda: dkv_split_sum_plain(ws, bf16))
    # fp32 adds off the tensor cores (67 TFLOP/s) against the bytes.
    sum_ops_ms, sum_bytes_ms = ws.numel() / PEAK_FP32 * 1e3, (4 * ws.numel() + 2 * 2 * dk.numel()) / PEAK_BYTES * 1e3
    sum_bound, sum_by = (sum_ops_ms, "operations") if sum_ops_ms >= sum_bytes_ms else (sum_bytes_ms, "bytes")
    log(f"[backward] K5s (K5's split sum) over workspace {list(ws.shape)} fp32: {sum_ms:.4f} ms, plain {sum_plain_ms:.4f} "
        f"ms, bound {sum_bound:.4f} ms by {sum_by}; |sum - plain| {err} ({card})")
    report["K5s"] = {"max_abs_err": err, "ms": sum_ms, "plain_ms": sum_plain_ms, "library_ms": None,
                     "bound_ms": sum_bound, "bound_by": sum_by}
    del ws, dk, dv, plain
    torch.cuda.empty_cache()
    sm90 = "flash_attention_tpu_torch/csrc/flash_bwd_sm90.cu"
    names = {"K3": ("dkv_kernel<FUSED>, wgmma + TMA (K3)", 594, sm90),
             "K4": ("dq_kernel, wgmma + TMA (K4)", 65, sm90), "K5": ("dkv_kernel, wgmma + TMA (K5)", 317, sm90),
             "K5s": ("split_sum_kernel, K5's split sum (K5s)", 317, sm90)}
    return {key: {"name": names[key][0], "route": "cuda", "source": names[key][2],
                  "replaces": f"{REFERENCE}/ops/attention_bwd.py:{names[key][1]}", **report[key]} for key in names}


# Phase 12's sweep across the tensor-core bodies' tile edges (64 and 128
# rows): lengths, GQA groups and q_len < kv_len end-aligned.
EDGE_LENGTHS = (127, 128, 129, 255, 257)
EDGE_GROUPS = (1, 2, 4, 8)


def phase_bwd_sweep() -> None:
    """Every (dtype, head_dim) instantiation of K3, K4 and K5 at ragged
    lengths (1, 63, 129, 1000): MHA self-attention causal and not (K3),
    GQA group 4 self-attention and group 2 with q_len < kv_len end-aligned
    (K4 + K5), MHA cross-length (K4 + K5); a cotangent with a strided last
    dimension (copied by the wrapper) on the fp32 cases. Then across the
    tensor-core tiles' edges: lengths EDGE_LENGTHS at GQA groups 2, 4 and 8
    of 8 q heads (self-attention, K5 split over every q head) and q_len <
    kv_len end-aligned at groups EDGE_GROUPS (group 1 is K4 + K5 without a
    split); one case of 64 q over 8 kv heads at T=1100, where K5 splits the
    group of 8 over 4 blocks of 2 heads; one of batch 2. Every case within
    ORACLE_BAR of the oracle's gradients and REL_BAR of plain."""
    import torch

    worst, n = 0.0, 0
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for d in (32, 64, 128):
            for length in (1, 63, 129, 1000):
                short = min(length, 63)
                cases = [(4, 4, length, length, True), (4, 4, length, length, False), (4, 1, length, length, True),
                         (4, 2, short, length, True), (4, 4, short, length, False)]
                for hq, hkv, q_len, kv_len, causal in cases:
                    what = f"backward {name} d={d} {hq}/{hkv} q {q_len} kv {kv_len} causal={causal}"
                    q, k, v, do = _bwd_inputs(n, hq, hkv, q_len, kv_len, d, dtype, strided_do=False)
                    if dtype == torch.float32:
                        do = do.transpose(-1, -2).contiguous().transpose(-1, -2)  # last stride q_len
                    _, _, _, d_rel, _ = _hold_bwd(what, q, k, v, do, causal, rel_bar=REL_BAR[name])
                    worst = max(worst, d_rel / REL_BAR[name])
                    n += 1
    log(
        f"[backward sweep] K3, K4 and K5 at fp32/fp16/bf16 x head_dim 32/64/128 x lengths 1/63/129/1000, MHA, "
        f"GQA 4 and 2, cross-length, {n} cases: all within {ORACLE_BAR} of the oracle's gradients; worst "
        f"row-relative difference to plain at {worst:.3f} of its bar {REL_BAR}"
    )
    worst, n0 = 0.0, n
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for d in (32, 64, 128):
            for length in EDGE_LENGTHS:
                cases = [(8, 8 // g, length, length, True) for g in EDGE_GROUPS[1:]]
                cases += [(8, 8 // g, length - 66, length, True) for g in EDGE_GROUPS]
                cases.append((8, 2, length, length, False))
                for hq, hkv, q_len, kv_len, causal in cases:
                    what = f"backward edges {name} d={d} {hq}/{hkv} q {q_len} kv {kv_len} causal={causal}"
                    q, k, v, do = _bwd_inputs(n, hq, hkv, q_len, kv_len, d, dtype)
                    _, _, _, d_rel, _ = _hold_bwd(what, q, k, v, do, causal, rel_bar=REL_BAR[name])
                    worst = max(worst, d_rel / REL_BAR[name])
                    n += 1
            for hq, hkv, length, batch in ((64, 8, 1100, 1), (8, 2, 300, 2)):
                what = f"backward edges {name} d={d} batch {batch} {hq}/{hkv} T {length}"
                q, k, v, do = _bwd_inputs(n, hq, hkv, length, length, d, dtype, batch=batch)
                _, _, _, d_rel, _ = _hold_bwd(what, q, k, v, do, True, rel_bar=REL_BAR[name])
                worst = max(worst, d_rel / REL_BAR[name])
                n += 1
    log(
        f"[backward sweep] across the tile edges: lengths {list(EDGE_LENGTHS)}, groups {list(EDGE_GROUPS)}, q_len < "
        f"kv_len end-aligned, non-causal, 64/8 heads at T=1100 (K5 over {_splits(1, 64, 8, 1100, torch.bfloat16)} "
        f"splits of the group of 8), batch 2, at fp32/fp16/bf16 x head_dim 32/64/128, {n - n0} cases: all within "
        f"{ORACLE_BAR} of the oracle's gradients; worst row-relative difference to plain at {worst:.3f} of its bar"
    )


# The tensor-core forward's and K3's sweep across their 64- and 128-row tile
# edges (csrc/flash_fwd_sm90.cu, csrc/flash_bwd_sm90.cu's fused body).
TC_LENGTHS = (1, 63, 64, 65, 127, 128, 129, 255, 256, 257, 1000)
TC_MASK_LENGTHS = (129, 257, 1000)
TC_WINDOWS = (1, 63, 65, 1000)


def _three_docs(length: int, batch: int):
    """Segment ids [batch, length] of three documents a row, split
    differently in each row."""
    import torch

    a, b = length // 2, length // 3
    docs = [(a, b, length - a - b), (length - a - b, a, b)]
    return torch.cat([_packed_ids(docs[i % 2]) for i in range(batch)])


def _hold_fwd(what: str, q, k, v, *, causal: bool, window=None, softcap=None, segment_ids=None) -> float:
    """K1 (K2, K1d) with its LSE, twice on the same inputs (bit-identical),
    launching exactly its route's kernel, against flash_attention_plain and
    the fp32 oracle (``_hold``); returns its row-relative error over
    REL_BAR."""
    import torch

    from flash_attention_tpu_torch.ops.common import segment_pair
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from flash_attention_tpu_torch.ops.reference import reference_attention_with_lse

    name = str(q.dtype).removeprefix("torch.")
    kw = dict(causal=causal, sliding_window=window, logit_softcap=softcap)
    zero_counts()
    out, lse = flash_attention(q, k, v, save_residuals=True, segment_ids=segment_ids, **kw)
    torch.cuda.synchronize()
    want = "K1d" if segment_ids is not None else "K2" if window is not None and window <= 64 else "K1"
    check_launches(what, read_counts(), (want,))
    _same_twice(what, lambda: flash_attention(q, k, v, save_residuals=True, segment_ids=segment_ids, **kw))
    segments = segment_pair(segment_ids, q.shape[0], q.shape[2], k.shape[2])
    p_out, p_lse = flash_attention_plain(q, k, v, sm_scale=q.shape[-1] ** -0.5, save_residuals=True,
                                         segments=segments, **kw)
    o_out, o_lse = reference_attention_with_lse(q, k, v, segment_ids=segment_ids, **kw)
    return _hold(what, out, p_out, o_out, lse, p_lse, o_lse, dtype=name)[1] / REL_BAR[name]


def phase_tensor_core_sweep() -> None:
    """K1 / K1d and K3 / K3m's tensor-core bodies in fp16 and bf16 at
    head_dim 32, 64 and 128 across their 64- and 128-row tile edges: the
    forward (``_hold_fwd``) at lengths TC_LENGTHS, self-attention causal at
    GQA groups 1, 4 and 8 (8 q heads), q_len < kv_len end-aligned at group
    4 and non-causal at group 8; K3 through the autograd Function
    (``_hold_bwd``; its dk and dv bit-identical over two calls) at the same
    lengths, MHA causal and not; then at lengths TC_MASK_LENGTHS, batch 2,
    windows TC_WINDOWS (softcap BITE_CAP with q x BITE_Q at 65, three
    documents a row at 63 and 1000; windows 1 and 63 without ids take K2's
    forward), the forward at group 4 and K3m."""
    import torch

    from flash_attention_tpu_torch.ops.attention_bwd import _delta, _guard_lse, launch_fused
    from flash_attention_tpu_torch.utils.testing import make_qkv

    worst_f, worst_b, nf, nb = 0.0, 0.0, 0, 0
    for dtype in (torch.float16, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for d in (32, 64, 128):
            for length in TC_LENGTHS:
                short = max(1, length - 66)
                for hq, hkv, q_len, causal in ((8, 8, length, True), (8, 2, length, True), (8, 1, length, True),
                                               (8, 2, short, True), (8, 1, length, False)):
                    q, k, v = make_qkv(nf, 1, hq, q_len, d, num_kv_heads=hkv, kv_seq=length, dtype=dtype,
                                       device="cuda")
                    what = f"[tensor-core sweep] K1 {name} d={d} {hq}/{hkv} q {q_len} kv {length} causal={causal}"
                    worst_f = max(worst_f, _hold_fwd(what, q, k, v, causal=causal))
                    nf += 1
                for causal in (True, False):
                    q, k, v, do = _bwd_inputs(nb, 4, 4, length, length, d, dtype)
                    what = f"[tensor-core sweep] K3 {name} d={d} T {length} causal={causal}"
                    _, (out, lse), _, d_rel, _ = _hold_bwd(what, q, k, v, do, causal, rel_bar=REL_BAR[name])
                    args = (q, k, v, do, _guard_lse(lse).contiguous(), _delta(out, do).contiguous())
                    _same_twice(what, lambda: launch_fused(*args, causal=causal, sm_scale=d**-0.5)[1:])
                    worst_b = max(worst_b, d_rel / REL_BAR[name])
                    nb += 1
            for length in TC_MASK_LENGTHS:
                for window in TC_WINDOWS:
                    softcap = BITE_CAP if window == 65 else None
                    ids = _three_docs(length, 2) if window in (63, 1000) else None
                    masks = dict(window=window, softcap=softcap, segment_ids=ids)
                    q, k, v = make_qkv(nf, 2, 8, length, d, num_kv_heads=2, dtype=dtype, device="cuda")
                    q = (q.float() * (BITE_Q if softcap else 4)).to(dtype)
                    what = f"[tensor-core sweep] forward {name} d={d} batch 2 8/2 T {length} masks {window}, {softcap}, " \
                           f"{'3 documents' if ids is not None else 'no ids'}"
                    worst_f = max(worst_f, _hold_fwd(what, q, k, v, causal=True, window=window, softcap=softcap,
                                                     segment_ids=ids))
                    nf += 1
                    q, k, v, do = _bwd_inputs(nb, 4, 4, length, length, d, dtype, batch=2)
                    q = (q.float() * (BITE_Q if softcap else 4)).to(dtype)
                    what = what.replace("forward", "K3m").replace("8/2", "4/4")
                    _, _, _, d_rel, _ = _hold_bwd(what, q, k, v, do, rel_bar=REL_BAR[name], **masks)
                    worst_b = max(worst_b, d_rel / REL_BAR[name])
                    nb += 1
    log(f"[tensor-core sweep] fp16/bf16 x head_dim 32/64/128 across the 64- and 128-row tile edges: the forward (K1, "
        f"K1d; K2 at windows 1 and 63 without ids) over lengths {list(TC_LENGTHS)}, groups 1/4/8, q_len < kv_len, "
        f"non-causal, and batch 2 with windows {list(TC_WINDOWS)}, softcap and documents at {list(TC_MASK_LENGTHS)}: "
        f"{nf} cases, each bit-identical over two calls, worst row-relative at {worst_f:.3f} of REL_BAR; K3 / K3m "
        f"through the autograd Function, {nb} cases (dk, dv bit-identical): all within {ORACLE_BAR} of the oracle's "
        f"gradients, worst row-relative at {worst_b:.3f} of REL_BAR")


def _lm_loss(logits, targets):
    import torch.nn.functional as F

    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(), targets.reshape(-1))


def _tiny_train(label: str, seed: int, runs, **masks) -> None:
    """The tiny fp32 model (``masks``: ModelConfig fields) on the card and on
    the CPU, for each (kv heads, segment ids of tokens [2, 100] or None,
    kernels the card launches) of ``runs``: the loss and every parameter's
    gradient agree within 1e-4 of the leaf's largest gradient (fp32 sums in
    another order, and K3's atomics in a run-dependent one), and the card
    launched exactly the kernels of its route."""
    import dataclasses

    import numpy as np
    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params, train_forward

    tokens = torch.from_numpy(np.random.default_rng(seed).integers(0, TINY_CFG["vocab_size"], (2, 101)))
    for kv_heads, seg, used in runs:
        cfg = dataclasses.replace(ModelConfig(**{**TINY_CFG, "num_kv_heads": kv_heads}), **masks)
        params = init_model_params(torch.Generator().manual_seed(0), cfg)
        result = {}
        for device in ("cuda", "cpu"):
            params_d = _to_device(params, device)
            leaves = _tensors(params_d)
            for t in leaves:
                t.requires_grad_()
            toks = tokens.to(device)
            zero_counts()
            ids = None if seg is None else seg.to(device)
            loss = _lm_loss(train_forward(params_d, cfg, toks[:, :-1], segment_ids=ids), toks[:, 1:])
            grads = torch.autograd.grad(loss, leaves)
            result[device] = (float(loss.detach()), [g.cpu() for g in grads], read_counts())
        what = f"{label} {kv_heads} kv heads{', packed' if seg is not None else ''}"
        check_launches(f"{what}, on the card", result["cuda"][2], used)
        worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                    for a, b in zip(result["cuda"][1], result["cpu"][1]))
        d_loss = abs(result["cuda"][0] - result["cpu"][0])
        zero = [i for i, g in enumerate(result["cuda"][1]) if not bool(g.abs().max() > 0)]
        log(f"{what}, 2 x 100 tokens: loss card {result['cuda'][0]:.6f} CPU {result['cpu'][0]:.6f}; worst leaf |grad "
            f"card - grad CPU| / max|grad CPU| {worst:.3e} (bar 1e-4) over {len(result['cpu'][1])} leaves; kernels {used}")
        if not (d_loss < 1e-5 and worst < 1e-4) or zero:
            raise RuntimeError(f"{what}: loss diff {d_loss}, grads {worst}, all-zero leaves {zero}")


def phase_tiny_train() -> None:
    """Phase 13: the tiny fp32 model, GQA (K4 + K5) and MHA (K3), on the card
    and on the CPU (``_tiny_train``)."""
    _tiny_train("[tiny train] fp32, 4 q /", 13, ((2, None, ("K1", "K4", "K5")), (4, None, ("K1", "K3"))))


def _check_grads(what: str, params) -> None:
    """Every gradient finite, and no weight matrix's all zero."""
    import torch

    leaves = _tensors(params)
    finite = torch.stack([torch.isfinite(t.grad).all() for t in leaves])
    nonzero = torch.stack([t.grad.abs().amax() > 0 for t in leaves if t.ndim >= 2])
    if not bool(finite.all()) or not bool(nonzero.all()):
        raise RuntimeError(f"{what}: {int((~finite).sum())} leaves with non-finite gradients, "
                           f"{int((~nonzero).sum())} weight matrices with an all-zero gradient")


def _train_step(params, cfg, tokens, segment_ids=None) -> float:
    """One forward + backward of the next-token loss; returns the loss.
    With ``segment_ids`` (the ids of ``tokens[:, :-1]``) the batch is packed."""
    from flash_attention_tpu_torch.models.transformer import train_forward

    for t in _tensors(params):
        t.grad = None
    loss = _lm_loss(train_forward(params, cfg, tokens[:, :-1], segment_ids=segment_ids), tokens[:, 1:])
    loss.backward()
    return float(loss.detach())


def _sgd_check(label: str, params, cfg, tokens, loss: float, segment_ids=None) -> None:
    """SGD along -g (the gradients of the last step, on ``tokens``), in the
    script: the largest step of SGD_LRS must lower the loss, from the weights
    as they were; the weights are put back after each try."""
    import torch

    from flash_attention_tpu_torch.models.transformer import train_forward

    leaves = _tensors(params)
    g2 = float(sum((t.grad.float() ** 2).sum() for t in leaves))
    kept = [t.detach().clone() for t in leaves]
    with torch.no_grad():
        for lr in SGD_LRS:
            for t in leaves:
                t.sub_(t.grad, alpha=lr)
            after = float(_lm_loss(train_forward(params, cfg, tokens[:, :-1], segment_ids=segment_ids), tokens[:, 1:]))
            for t, w in zip(leaves, kept):
                t.copy_(w)
            log(f"{label} SGD lr {lr}: loss {loss:.4f} -> {after:.4f} (first order: -{lr * g2:.4f}; |g|^2 {g2:.4e})")
            if after < loss:
                return
    raise RuntimeError(f"{label} no SGD step along -g lowered the loss")


def _train_steps(card: str, label: str, params, cfg, batches, *, used, segment_ids=None) -> dict:
    """Forward + backward steps of ``cfg`` on ``batches`` ([1, T + 1] tokens
    each), every launch count set to 0 just before and read just after; the
    steps must launch exactly ``used``, with finite losses and gradients.
    Returns the losses, step times, launches and peak memory."""
    import numpy as np
    import torch

    for t in _tensors(params):
        t.requires_grad_()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times, losses = [], []
    for tokens in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(_train_step(params, cfg, tokens, segment_ids))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if not np.isfinite(losses[-1]):
            raise RuntimeError(f"{label} non-finite loss {losses[-1]}")
        _check_grads(label, params)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check_launches(f"{label} steps", launches, used)
    step_s = statistics.median(times)
    n_tok = batches[0].shape[1] - 1
    log(f"{label} B=1, T={n_tok}, {len(batches)} step(s) of forward + backward: losses {[round(x, 4) for x in losses]}, "
        f"step {[round(t * 1e3, 1) for t in times]} ms, median {step_s * 1e3:.1f} ms = {n_tok / step_s:.1f} training "
        f"tokens/s; peak device memory (max_memory_allocated) {peak / 2**30:.2f} GiB; kernel launches {launches} "
        f"({card})")
    return {"losses": losses, "step_s": step_s, "launches": launches, "peak_gib": peak / 2**30}


def phase_full_train(card: str, params) -> dict:
    """Phase 14: ModelConfig() trained at full width and depth on phase 5's
    weights (the engines and caches of phases 5-11 are released): three
    steps of forward + backward at B=1, T=2048 with next-token cross
    entropy, then one SGD step in the script that must lower the loss on the
    last batch; then ModelConfig(num_kv_heads=32, num_layers=4), the MHA
    route, one step. Returns the launch counts of the GQA steps and of the
    MHA step."""
    import gc

    import numpy as np
    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params

    gc.collect()
    torch.cuda.empty_cache()
    cfg = ModelConfig()
    rng = np.random.default_rng(14)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, TRAIN_TOKENS + 1))).cuda() for _ in range(3)]
    used = _route(cfg.num_q_heads, cfg.num_kv_heads, TRAIN_TOKENS, TRAIN_TOKENS, dtype=torch.bfloat16)
    gqa = _train_steps(card, f"[full train] ModelConfig() bf16, weights {_nbytes(params) / 1e9:.3f} GB and their "
                       "gradients as much,", params, cfg, batches, used=used)
    _sgd_check("[full train]", params, cfg, batches[-1], gqa["losses"][-1])
    for t in _tensors(params):
        t.grad = None
        t.requires_grad_(False)
    gc.collect()
    torch.cuda.empty_cache()

    cfg_mha = ModelConfig(num_kv_heads=32, num_layers=4)
    p_mha = init_model_params(torch.Generator(device="cuda").manual_seed(1), cfg_mha)
    mha = _train_steps(card, "[full train] ModelConfig(num_kv_heads=32, num_layers=4) bf16, first step (warm kernels),",
                       p_mha, cfg_mha, batches[:1], used=("K1", "K3"))
    del p_mha
    torch.cuda.empty_cache()
    return {"gqa": gqa["launches"], "mha": mha["launches"]}


# Masked serving (phases 15-17). Mistral-7B v0.1's shape (config.json:
# hidden 4096, 32 layers, 32 q / 8 kv heads, head_dim 128, intermediate 14336,
# vocab 32000, rope_theta 10000, sliding_window 4096) with the repository's
# tied embedding.
MISTRAL = dict(mlp_dim=14336, sliding_window=4096)
WINDOW = 4096
SINKS = 4  # StreamingLLM's four sink tokens
RING_ROWS = 4352  # rolling_buffer_len at window 4096 and chunk 256: ceil128(4096 + 256)

# Phase 3's edges of csrc/chunk_fwd_sm90.cu (K1q, K1r): (label, T, kv_end, cache form, payload or None, query
# dtype, head_dim, q heads, kv heads, sinks, window). "dense": an [8, Hkv, 2048, D] cache; "ring": RING_ROWS rows
# (128 more with sinks), window WINDOW; "ring64": a window of 64 over 384 ring rows after the sinks' 128, so that a
# block's walk is the sink tile and two or three band tiles and the first share ends at the sink tile.
CHUNK_EDGES = (
    ("T 1", 1, 2048, "dense", "int8", "bfloat16", 128, 32, 8, 0, None),
    ("T 37", 37, 1000, "dense", "fp8_e4m3", "bfloat16", 128, 32, 8, 0, None),
    ("T 255", 255, 2048, "dense", "fp8_e5m2", "bfloat16", 128, 32, 8, 0, None),
    ("T 256, kv_end 256: shares left empty", 256, 256, "dense", "int8", "bfloat16", 128, 32, 8, 0, None),
    ("T 64, kv_end 64: one tile over 8 shares", 64, 64, "dense", "fp8_e4m3", "bfloat16", 128, 32, 8, 0, None),
    ("T 1", 1, 9000, "ring", None, "bfloat16", 128, 32, 8, 0, WINDOW),
    ("T 37", 37, 4400, "ring", "fp8_e4m3", "bfloat16", 128, 32, 8, SINKS, WINDOW),
    ("T 255", 255, 9000, "ring", "fp8_e5m2", "bfloat16", 128, 32, 8, 0, WINDOW),
    ("T 64, kv_end 64: shares left empty", 64, 64, "ring", None, "bfloat16", 128, 32, 8, SINKS, WINDOW),
    ("sinks on a share's boundary", 256, 1000, "ring64", None, "bfloat16", 128, 32, 8, SINKS, 64),
    ("sinks on a share's boundary", 256, 1000, "ring64", "int8", "bfloat16", 128, 32, 8, SINKS, 64),
    ("group 1 (32 kv heads)", 256, 2048, "dense", "int8", "bfloat16", 128, 32, 32, 0, None),
    ("group 1 (32 kv heads)", 256, 9000, "ring", None, "bfloat16", 128, 32, 32, SINKS, WINDOW),
    ("group 8", 256, 2048, "dense", "fp8_e4m3", "bfloat16", 128, 32, 4, 0, None),
    ("group 3 (24 q heads), a row's heads across blocks", 255, 9000, "ring", "int8", "bfloat16", 128, 24, 8,
     SINKS, WINDOW),
    ("group 32 (one kv head)", 37, 2048, "dense", "int8", "bfloat16", 128, 32, 1, 0, None),
    ("D 64", 256, 2048, "dense", "fp8_e5m2", "bfloat16", 64, 32, 8, 0, None),
    ("D 64", 256, 9000, "ring", "int8", "bfloat16", 64, 32, 8, SINKS, WINDOW),
    ("fp16 queries", 256, 2048, "dense", "int8", "float16", 128, 32, 8, 0, None),
    ("fp16 queries", 256, 9000, "ring", None, "float16", 128, 32, 8, SINKS, WINDOW),
)

DENSE_LENGTHS = (0, 1, 100, 4095, 4096, 4097, 9000, 9216)  # K6 dense window over 9216 rows; K7's logical rows
RING_LENGTHS = (0, 1, 4095, 4096, 4352, 4353, 9000, 20000)  # K6 over the ring: lengths pass its rows
MASKED_PROMPT_LENS = (1, 255, 1024, 4095, 4096, 4097, 6000, 9000)  # phase 17, run A
SWEEP_WINDOWS = (1, 63, 64, 65, 1000)
# Phase 18's sweep: also the windows either side of the tensor-core bodies' 128-row tiles.
BWD_SWEEP_WINDOWS = (1, 63, 64, 65, 127, 128, 129, 1000)


def _ring_row(p: int, rows: int, sinks: int = 0) -> int:
    """The row of a rolling cache of ``rows`` rows that holds position p, as
    the cache writes it: p % rows; with sinks, p below them and sinks_pad +
    (p - sinks) % (rows - sinks_pad) above (sinks_pad = sinks rounded up to
    128)."""
    if not sinks:
        return p % rows
    spad = -(-sinks // 128) * 128
    return p if p < sinks else spad + (p - sinks) % (rows - spad)


def _visible_positions(length: int, window: int, sinks: int = 0) -> list[int]:
    """The positions a decode query at ``length`` attends: the window's and
    the sinks'."""
    return sorted(set(range(max(0, length - window), length)) | set(range(min(sinks, length))))


def _oracle_rows(q, k, v, rows_per_seq, *, softcap=None):
    """fp32 oracle of single-token decode over the cache rows each sequence
    sees: the rows gathered, then reference_attention_with_lse with the
    count as kv_length. Returns (out [B, Hq, D], lse [B, Hq]) and the
    boolean [B, rows] mask of those rows (for the library call)."""
    import torch

    from flash_attention_tpu_torch.ops.reference import reference_attention_with_lse

    batch, hkv, rows, d = k.shape
    n = max(1, max(len(r) for r in rows_per_seq))
    idx = torch.zeros((batch, n), dtype=torch.long)
    mask = torch.zeros((batch, rows), dtype=torch.bool)
    for b, r in enumerate(rows_per_seq):
        idx[b, : len(r)] = torch.tensor(r, dtype=torch.long)
        mask[b, r] = True
    idx, mask = idx.to(k.device), mask.to(k.device)
    gather = lambda x: torch.gather(x.float(), 2, idx[:, None, :, None].expand(batch, hkv, n, d))  # noqa: E731
    counts = torch.tensor([len(r) for r in rows_per_seq], device=k.device)
    out, lse = reference_attention_with_lse(q[:, :, None].float(), gather(k), gather(v), kv_length=counts,
                                            logit_softcap=softcap)
    return out[:, :, 0], lse[:, :, 0], mask


def _oracle_mask(q, k, v, mask, *, sm_scale, softcap=None):
    """fp32 attention of q [B, Hq, Sq, D] over k, v [B, Hkv, Skv, D] under an
    explicit boolean mask [Sq, Skv]: (out, base-2 LSE), 0 and -inf where a
    row sees nothing."""
    import torch

    from flash_attention_tpu_torch.ops.common import LOG2E

    group = q.shape[1] // k.shape[1]
    kf, vf = (x.float().repeat_interleave(group, dim=1) for x in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * sm_scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s2 = torch.where(mask, s * LOG2E, -torch.inf)
    m = s2.amax(-1, keepdim=True)
    live = torch.isfinite(m)
    p = torch.exp2(s2 - torch.where(live, m, 0.0))
    l = p.sum(-1, keepdim=True)
    out = torch.where(live, torch.einsum("bhqk,bhkd->bhqd", p, vf) / torch.where(live, l, 1.0), 0.0)
    lse = torch.where(live, m + torch.log2(torch.where(live, l, 1.0)), -torch.inf)[..., 0]
    return out, lse


def _window_pairs(q_len: int, kv_len: int, window: int | None) -> int:
    """(query, key) pairs an end-aligned causal mask with a window leaves."""
    diag = kv_len - q_len
    return sum(min(kv_len, i + diag + 1) - (0 if window is None else max(0, i + diag - window + 1)) for i in range(q_len))


def _visible_pairs(q_len: int, kv_len: int, window: int | None, segments=None) -> int:
    """(query, key) pairs a batch row's causal mask leaves, with the window
    and, for segment ids (a (q_ids, kv_ids) pair of one batch row), only the
    pairs of equal ids: what this run's data needs."""
    if segments is None:
        return _window_pairs(q_len, kv_len, window)
    from flash_attention_tpu_torch.ops.common import visible_mask

    return int(visible_mask(q_len, kv_len, segments[0].device, causal=True, window=window, segments=segments).sum())


SCORES_BUDGET = 2**30  # bytes of fp32 [B, heads, Sq, Skv] scores a plain or oracle call may hold


def _by_kv_head(fn, q_like, kv_like):
    """``fn(*q_like, *kv_like)`` over as many kv heads (with their q heads) at
    a time as keep one call's fp32 scores under SCORES_BUDGET: q_like are
    tensors [B, Hq, Sq, ...], kv_like [B, Hkv, Skv, ...], and each output is
    concatenated along dimension 1 (q heads or kv heads). The same function;
    at T=8192 the plain versions' and the oracle's [Sq, Skv] intermediates
    of all 32 heads at once would not fit beside the rest."""
    import torch

    batch, hq, q_len = q_like[0].shape[:3]
    hkv, kv_len = kv_like[0].shape[1], kv_like[0].shape[2]
    group = hq // hkv
    step = max(1, SCORES_BUDGET // (4 * batch * group * q_len * kv_len))
    if step >= hkv:
        return fn(*q_like, *kv_like)
    parts = [fn(*(x[:, h * group:(h + step) * group] for x in q_like), *(x[:, h:h + step] for x in kv_like))
             for h in range(0, hkv, step)]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=1)
    return tuple(torch.cat(group_parts, dim=1) for group_parts in zip(*parts))


def _hold(what: str, out, plain, oracle, lse=None, p_lse=None, o_lse=None, *, dtype: str = "bfloat16"):
    """Row by row within REL_BAR of plain and oracle, within ORACLE_BAR of
    the oracle, the LSE within LSE_BAR of both; returns (|out - plain|,
    row-relative, |lse|)."""
    d_plain, d_oracle = _max_diff(out, plain), _max_diff(out, oracle)
    d_rel = max(_rel_diff(out, plain), _rel_diff(out, oracle))
    d_lse = 0.0 if lse is None else max(_max_diff(lse, p_lse), _max_diff(lse, o_lse))
    if not (d_oracle < ORACLE_BAR and d_rel < REL_BAR[dtype] and d_lse < LSE_BAR):
        raise RuntimeError(f"{what} disagrees: |out-oracle| {d_oracle:.3e} (bar {ORACLE_BAR}), row-relative "
                           f"{d_rel:.3e} (bar {REL_BAR[dtype]}), |lse| {d_lse:.3e} (bar {LSE_BAR})")
    return d_plain, d_rel, d_lse


def _k1_masked(card: str, what: str, q, k, v, *, window=None, softcap=None, segment_ids=None, lib_mask=None,
               want="K1") -> dict:
    """K1 (or K2, or K1d with segment ids) with a window, softcap and / or
    segment ids, causal, end-aligned, with its LSE, twice on the same
    inputs (bit-identical): against
    flash_attention_plain and the fp32 oracle with the same masks (a few kv
    heads at a time at long sequences, ``_by_kv_head``); kernel, plain,
    library and bound times."""
    import torch
    import torch.nn.functional as F

    from flash_attention_tpu_torch.ops.common import segment_pair
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from flash_attention_tpu_torch.ops.reference import reference_attention_with_lse

    scale = q.shape[-1] ** -0.5
    kw = dict(causal=True, sliding_window=window, logit_softcap=softcap, segment_ids=segment_ids)
    segments = segment_pair(segment_ids, q.shape[0], q.shape[2], k.shape[2])
    zero_counts()
    out, lse = flash_attention(q, k, v, save_residuals=True, **kw)
    torch.cuda.synchronize()
    check_launches(f"[masked] {what}", read_counts(), (want,))
    _same_twice(f"[masked] {want} {what}", lambda: flash_attention(q, k, v, save_residuals=True, **kw))

    def plain():
        return _by_kv_head(lambda qh, kh, vh: flash_attention_plain(
            qh, kh, vh, sm_scale=scale, save_residuals=True, causal=True, sliding_window=window,
            logit_softcap=softcap, segments=segments), (q,), (k, v))

    p_out, p_lse = plain()
    o_out, o_lse = _by_kv_head(lambda qh, kh, vh: reference_attention_with_lse(qh, kh, vh, **kw), (q,), (k, v))
    d_plain, d_rel, d_lse = _hold(f"{want} {what}", out, p_out, o_out, lse, p_lse, o_lse)
    del p_out, p_lse, o_out, o_lse
    ms = cuda_ms(lambda: flash_attention(q, k, v, save_residuals=True, **kw))
    plain_ms = cuda_ms(plain, warmup=2, iters=5)
    lib_ms = None
    if lib_mask is not None:
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask, enable_gqa=True))
    b, hq, q_len, d = q.shape
    hkv, kv_len = k.shape[1], k.shape[2]
    pairs = _visible_pairs(q_len, kv_len, window, segments)
    first = 0 if window is None else max(0, kv_len - q_len - window + 1)
    nbytes = 2 * 2 * q.numel() + 4 * lse.numel() + 2 * 2 * b * hkv * (kv_len - first) * d
    bound_ms, bound_by = bound(4 * d * hq * b * pairs, nbytes)
    log(
        f"[masked] {want} {what}: |out-plain| {d_plain:.3e}, row-relative vs plain and oracle {d_rel:.3e} (bar "
        f"{REL_BAR['bfloat16']}), |lse| {d_lse:.3e} (bar {LSE_BAR}), bit-identical over two calls; kernel {ms:.4f} ms "
        f"({_rates(4 * d * hq * b * pairs, ms)}), plain {plain_ms:.4f} ms, library "
        + ("none" if lib_ms is None else f"{lib_ms:.4f} ms (SDPA, boolean band mask)")
        + f", bound {bound_ms:.4f} ms by {bound_by} ({pairs} visible pairs a head) ({card})"
    )
    return {"max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _k6_masked(card: str, what: str, q, k, v, lengths, *, ring: bool, sinks: int = 0, window=WINDOW,
               softcap=None, want="K6") -> dict:
    """K6 (K6q for a QuantizedTensor cache) with a window over a dense or
    ring cache, with or without sinks: against decode_attention_plain and
    the oracle over the rows holding the visible positions."""
    import torch
    import torch.nn.functional as F

    from flash_attention_tpu_torch.ops.decode import decode_attention, decode_attention_plain
    from flash_attention_tpu_torch.ops.quant import QuantizedTensor, dequantize

    quant = isinstance(k, QuantizedTensor)
    kd, vd = (dequantize(x) if quant else x for x in (k, v))
    rows = kd.shape[2]
    kw = dict(sliding_window=window, logit_softcap=softcap, ring_buffer=ring, attention_sinks=sinks)
    zero_counts()
    (out, lse), grid = _twice(f"{want} {what}", decode_attention,
                              lambda: decode_attention(q, k, v, lengths, save_residuals=True, **kw))
    torch.cuda.synchronize()
    check_launches(f"[masked] {want} {what}", read_counts(), (want,))
    p_out, p_lse = decode_attention_plain(q, k, v, lengths, sm_scale=q.shape[-1] ** -0.5, save_residuals=True, **kw)
    row_of = (lambda p: _ring_row(p, rows, sinks)) if ring else (lambda p: p)
    seen = [[row_of(p) for p in _visible_positions(n, window, sinks)] for n in lengths.tolist()]
    o_out, o_lse, mask = _oracle_rows(q, kd, vd, seen, softcap=softcap)
    d_plain, d_rel, d_lse = _hold(f"{want} {what}", out, p_out, o_out, lse, p_lse, o_lse)
    empty = lengths == 0
    if not (bool((out[empty] == 0).all()) and bool(torch.isneginf(lse[empty]).all())):
        raise RuntimeError(f"{want} {what}: a sequence of length 0 must give output 0 and LSE -inf")
    ms = cuda_ms(lambda: decode_attention(q, k, v, lengths, save_residuals=True, **kw))
    plain_ms = cuda_ms(lambda: decode_attention_plain(q, k, v, lengths, sm_scale=q.shape[-1] ** -0.5,
                                                      save_residuals=True, **kw))
    lib_ms = None
    if not quant and softcap is None:
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kd, vd, attn_mask=mask[:, None, None],
                                                                enable_gqa=True))
    batch, hq, d = q.shape
    hkv = kd.shape[1]
    n_rows = sum(len(r) for r in seen)
    row_bytes = d * (k.values.element_size() if quant else 2) + (4 if quant else 0)
    nbytes = 2 * n_rows * hkv * row_bytes + 2 * 2 * q.numel() + 4 * (lse.numel() + batch)
    bound_ms, bound_by = bound(4 * d * hq * n_rows, nbytes)
    log(
        f"[masked] {want} {what}, lengths {lengths.tolist()}, {grid}, bit-identical over two calls: |out-plain| "
        f"{d_plain:.3e}, row-relative "
        f"{d_rel:.3e} (bar {REL_BAR['bfloat16']}), |lse| {d_lse:.3e} (bar {LSE_BAR}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library " + ("none" if lib_ms is None else f"{lib_ms:.4f} ms (SDPA, boolean mask)")
        + f", bound {bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB) ({card})"
    )
    return {"max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _ring_table(rng, num_slots: int, pages_per_slot: int, n_ring: int, *, sinks: bool):
    """The paged ring's table over a shuffled pool: slot b owns n_ring pages
    (one more, pinned as logical page 0, with sinks) and maps logical page
    lp onto them modulo their count, as PagedServingEngine does; returns
    the table and the pool's page count (page 0 the dump page)."""
    import numpy as np

    owned = n_ring + (1 if sinks else 0)
    perm = rng.permutation(np.arange(1, 1 + num_slots * owned)).reshape(num_slots, owned)
    table = np.zeros((num_slots, pages_per_slot), np.int32)
    for b in range(num_slots):
        if sinks:
            table[b, 0] = perm[b, 0]
            table[b, 1:] = [perm[b, 1 + (lp - 1) % n_ring] for lp in range(1, pages_per_slot)]
        else:
            table[b] = [perm[b, lp % n_ring] for lp in range(pages_per_slot)]
    return table, 1 + num_slots * owned


def phase_masked_kernels(card: str) -> dict:
    """Phase 15: the masked kernels at the masked serving path's shapes in
    bf16, each against its plain version (row-relative, REL_BAR), the fp32
    oracle with the same masks (ORACLE_BAR) and its LSE (LSE_BAR). Returns
    the report entries."""
    return {**masked_k1_cases(card), **masked_k6_cases(card), **masked_paged_cases(card)}


def masked_k1_cases(card: str) -> dict:
    """K1 with window 4096 and with softcap 50; K2 beside K1 at the JAX
    band's window."""
    import torch

    from flash_attention_tpu_torch.utils.testing import make_qkv

    bf16, dev = torch.bfloat16, torch.device("cuda")
    report = {}
    # K1, window 4096: a 256-row chunk end-aligned at kv 9216.
    q, k, v = make_qkv(15, 1, 32, 256, 128, num_kv_heads=8, kv_seq=9216, dtype=bf16, device=dev)
    col, row = torch.arange(9216, device=dev)[None, :], torch.arange(256, device=dev)[:, None] + 8960
    band = (col <= row) & (col > row - WINDOW)
    report["K1w"] = _k1_masked(card, "window 4096, q [1,32,256,128] kv [1,8,9216,128]", q, k, v, window=WINDOW,
                               lib_mask=band)
    # K1, softcap 50 at phase 3's shape; q scaled up so the scores reach the cap.
    q, k, v = make_qkv(16, 1, 32, 256, 128, num_kv_heads=8, kv_seq=2048, dtype=bf16, device=dev)
    q = (q.float() * 256).to(bf16)
    report["K1c"] = _k1_masked(card, "softcap 50, q [1,32,256,128] x 256, kv [1,8,2048,128]", q, k, v, softcap=50.0)
    # K2: window 64 (the port's kv tile) against window 128 (the JAX band's block, K1).
    q, k, v = make_qkv(17, 1, 32, 2048, 128, num_kv_heads=32, dtype=bf16, device=dev)
    for window, want in ((128, "K1"), (64, "K2")):
        col, row = torch.arange(2048, device=dev)[None, :], torch.arange(2048, device=dev)[:, None]
        entry = _k1_masked(card, f"window {window}, q, kv [1,32,2048,128]", q, k, v, window=window,
                           lib_mask=(col <= row) & (col > row - window), want=want)
        if want == "K2":
            report["K2"] = entry
            bodies = read_bodies()
            check_tensor_cores("[masked] K2 bf16", bodies, "K1/K1d/K2")
            log(f"[masked] K2 bf16: launches by body {bodies} (the tensor-core body, csrc/flash_fwd_sm90.cu)")
    return report


def masked_k6_cases(card: str) -> dict:
    """K6 over a dense window, the ring and the ring with sinks; K6q int8 on
    the ring."""
    import torch

    from flash_attention_tpu_torch.ops.quant import payload_dtype, quantize_values

    bf16, dev = torch.bfloat16, torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    report = {}
    # K6: a dense window over 9216 rows, the ring of 4352 rows and the ring
    # with 4 sinks in front (4480 rows), lengths past the ring's rows.
    q = torch_uniform((8, 32, 128), bf16, gen)
    k, v = torch_uniform((8, 8, 9216, 128), bf16, gen), torch_uniform((8, 8, 9216, 128), bf16, gen)
    lengths = torch.tensor(DENSE_LENGTHS, dtype=torch.int32, device=dev)
    _k6_masked(card, "dense window 4096, cache [8,8,9216,128]", q, k, v, lengths, ring=False)
    lengths = torch.tensor(RING_LENGTHS, dtype=torch.int32, device=dev)
    ring_k, ring_v = k[:, :, :RING_ROWS].contiguous(), v[:, :, :RING_ROWS].contiguous()
    report["K6r"] = _k6_masked(card, f"ring of {RING_ROWS} rows, window 4096", q, ring_k, ring_v, lengths, ring=True)
    rows = RING_ROWS + 128
    _k6_masked(card, f"ring of {rows} rows with {SINKS} sinks, window 4096", q, k[:, :, :rows].contiguous(),
               v[:, :, :rows].contiguous(), lengths, ring=True, sinks=SINKS)
    _k6_masked(card, f"ring of {RING_ROWS} rows, window 4096, softcap 50", q, ring_k, ring_v, lengths, ring=True,
               softcap=50.0)
    kx, vx = scaled_rows((8, 8, RING_ROWS, 128), gen), scaled_rows((8, 8, RING_ROWS, 128), gen)
    kq, vq = quantize_values(kx, payload_dtype("int8")), quantize_values(vx, payload_dtype("int8"))
    _k6_masked(card, f"int8 ring of {RING_ROWS} rows, window 4096", q, kq, vq, lengths, ring=True, want="K6q")
    return report


def masked_paged_cases(card: str) -> dict:
    """K7 and K8 with window 4096 and 4 sinks over a shuffled paged ring."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.ops.paged import (
        paged_decode_attention,
        paged_decode_attention_plain,
        paged_prefill_attention,
        paged_prefill_attention_plain,
    )

    bf16, dev = torch.bfloat16, torch.device("cuda")
    rng = np.random.default_rng(15)
    gen = torch.Generator(device=dev).manual_seed(16)
    q = torch_uniform((8, 32, 128), bf16, gen)
    report = {}
    # K7 and K8 over the paged ring with 4 sinks: 8 slots of 72 logical pages
    # over 36 + 1 physical pages each, shuffled; rolled-out logical pages
    # alias live ones.
    page, per_slot = 128, 72
    n_ring = -(-(WINDOW + 256) // page) + 2
    table, num_pages = _ring_table(rng, 8, per_slot, n_ring, sinks=True)
    cache = _filled_cache(1, num_pages=num_pages, num_slots=8, pages_per_slot=per_slot, kv_heads=8, head_dim=128,
                          dtype=bf16, gen=gen).layers()[0]
    table = torch.from_numpy(table).to(dev)
    cache.page_table.copy_(table)
    lengths = torch.tensor(DENSE_LENGTHS, dtype=torch.int32, device=dev)
    cache = cache._replace(lengths=lengths)
    k_log, v_log = _dense_from_pages(cache.k_pages, table), _dense_from_pages(cache.v_pages, table)
    kw = dict(sliding_window=WINDOW, attention_sinks=SINKS)
    zero_counts()
    (out, lse), grid = _twice("K7 paged ring", paged_decode_attention,
                              lambda: paged_decode_attention(q, cache, save_residuals=True, **kw))
    torch.cuda.synchronize()
    check_launches("[masked] K7", read_counts(), ("K7",))
    p_out, p_lse = paged_decode_attention_plain(q, cache, sm_scale=128**-0.5, save_residuals=True, **kw)
    seen = [_visible_positions(n, WINDOW, SINKS) for n in DENSE_LENGTHS]
    o_out, o_lse, _ = _oracle_rows(q, k_log, v_log, seen)
    d_plain, d_rel, d_lse = _hold("K7 paged ring, window 4096, 4 sinks", out, p_out, o_out, lse, p_lse, o_lse)
    ms = cuda_ms(lambda: paged_decode_attention(q, cache, save_residuals=True, **kw))
    plain_ms = cuda_ms(lambda: paged_decode_attention_plain(q, cache, sm_scale=128**-0.5, save_residuals=True, **kw))
    n_rows = sum(len(r) for r in seen)
    nbytes = 2 * n_rows * 8 * 128 * 2 + 2 * 2 * q.numel() + 4 * (lse.numel() + 8 + 8 * 36)
    bound_ms, bound_by = bound(4 * 128 * 32 * n_rows, nbytes)
    log(
        f"[masked] K7 q [8,32,128] over the paged ring ({n_ring} + 1 pinned pages a slot of 128 rows, table [8,{per_slot}] "
        f"shuffled), window 4096, {SINKS} sinks, lengths {list(DENSE_LENGTHS)}, {grid}, bit-identical over two "
        f"calls: |out-plain| {d_plain:.3e}, row-relative "
        f"{d_rel:.3e}, |lse| {d_lse:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library none, bound "
        f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.1f} MB) ({card})"
    )
    report["K7s"] = {"max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                     "bound_ms": bound_ms, "bound_by": bound_by}
    slot, kv_end = 6, 9000
    qc = torch_uniform((1, 32, 256, 128), bf16, gen)
    zero_counts()
    out = paged_prefill_attention(qc, cache, slot, kv_end, chunk_len=256, **kw)
    torch.cuda.synchronize()
    check_launches("[masked] K8", read_counts(), ("K8",))
    p_out = paged_prefill_attention_plain(qc, cache, slot, kv_end, sm_scale=128**-0.5, **kw)
    col = torch.arange(kv_end, device=dev)[None, :]
    row = torch.arange(256, device=dev)[:, None] + kv_end - 256
    mask = (col <= row) & ((col > row - WINDOW) | (col < SINKS))
    o_out, _ = _oracle_mask(qc, k_log[slot:slot + 1, :, :kv_end], v_log[slot:slot + 1, :, :kv_end], mask,
                            sm_scale=128**-0.5)
    d_plain, d_rel, _ = _hold("K8 paged ring, window 4096, 4 sinks", out, p_out, o_out)
    _same_twice(f"[masked] K8 paged ring, window {WINDOW}, {SINKS} sinks",
                lambda: paged_prefill_attention(qc, cache, slot, kv_end, chunk_len=256, **kw))
    bodies = read_bodies()
    check_tensor_cores("[masked] K8 bf16", bodies, "K8/K8q")
    ms = cuda_ms(lambda: paged_prefill_attention(qc, cache, slot, kv_end, chunk_len=256, **kw))
    plain_ms = cuda_ms(lambda: paged_prefill_attention_plain(qc, cache, slot, kv_end, sm_scale=128**-0.5, **kw),
                       warmup=2, iters=5)
    pairs = int(mask.sum())
    kv_rows = kv_end - (kv_end - 256 - WINDOW + 1) + SINKS
    nbytes = 2 * 2 * qc.numel() + 2 * 2 * kv_rows * 8 * 128 + 4 * (kv_rows // page + 2)
    bound_ms, bound_by = bound(4 * 128 * 32 * pairs, nbytes)
    log(
        f"[masked] K8 q [1,32,256,128] over slot {slot}'s paged ring to kv_end {kv_end}, window 4096, {SINKS} sinks: "
        f"|out-plain| {d_plain:.3e}, row-relative {d_rel:.3e}, bit-identical over two calls, launches by body "
        f"{bodies}; kernel {ms:.4f} ms "
        f"({4 * 128 * 32 * pairs / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, library none, bound "
        f"{bound_ms:.4f} ms by {bound_by} ({card})"
    )
    report["K8s"] = {"max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                     "bound_ms": bound_ms, "bound_by": bound_by}
    del cache, k_log, v_log
    torch.cuda.empty_cache()
    return report


def phase_masked_sweep() -> None:
    """Every (dtype, head_dim) instantiation of the masked bodies at ragged
    shapes and windows 1, 63, 64, 65 and 1000: K1 / K2 (q 100 end-aligned
    over kv 1100, GQA 2; a softcap on window 65), K6 over a dense window and
    over a ring (with 3 sinks at the odd windows), K7 and K8 over a paged
    ring of 64-row pages with 3 sinks."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.ops.decode import decode_attention, decode_attention_plain
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from flash_attention_tpu_torch.ops.paged import (
        paged_decode_attention,
        paged_decode_attention_plain,
        paged_prefill_attention,
        paged_prefill_attention_plain,
    )
    from flash_attention_tpu_torch.ops.reference import reference_attention_with_lse
    from flash_attention_tpu_torch.utils.testing import make_qkv

    rng = np.random.default_rng(16)
    gen = torch.Generator(device="cuda").manual_seed(16)
    worst, n = 0.0, 0
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for d in (32, 64, 128):
            q, k, v = make_qkv(n, 2, 4, 100, d, num_kv_heads=2, kv_seq=1100, dtype=dtype, device="cuda")
            q = (q.float() * 4).to(dtype)
            qd = q[:, :, -1].contiguous()
            lengths = torch.tensor([37, 1100], dtype=torch.int32, device="cuda")
            page_rows = 64
            table, num_pages = _ring_table(rng, 2, 1152 // page_rows, 6, sinks=True)
            cache = _filled_cache(1, num_pages=num_pages, num_slots=2, pages_per_slot=1152 // page_rows, kv_heads=2,
                                  head_dim=d, dtype=dtype, gen=gen, page_size=page_rows).layers()[0]
            cache.page_table.copy_(torch.from_numpy(table).cuda())
            cache = cache._replace(lengths=lengths)
            k_log, v_log = (_dense_from_pages(x, cache.page_table) for x in (cache.k_pages, cache.v_pages))
            for window in SWEEP_WINDOWS:
                what = f"{name} d={d} window {window}"
                softcap = BITE_CAP if window == 65 else None
                kw = dict(causal=True, sliding_window=window, logit_softcap=softcap)
                out, lse = flash_attention(q, k, v, save_residuals=True, **kw)
                p_out, p_lse = flash_attention_plain(q, k, v, sm_scale=d**-0.5, save_residuals=True, **kw)
                o_out, o_lse = reference_attention_with_lse(q, k, v, **kw)
                worst = max(worst, _hold(f"K1/K2 {what}", out, p_out, o_out, lse, p_lse, o_lse, dtype=name)[1] / REL_BAR[name])
                # K6: the dense window, then a ring holding the window (256
                # rows; 128 + 256 with 3 sinks at the odd windows).
                cases = [(k, v, False, 0)]
                if window <= 256:
                    sinks = 3 if window % 2 else 0
                    rows = 256 + (128 if sinks else 0)
                    cases.append((k[:, :, :rows].contiguous(), v[:, :, :rows].contiguous(), True, sinks))
                for kc, vc, ring, sinks in cases:
                    dkw = dict(sliding_window=window, logit_softcap=softcap, ring_buffer=ring, attention_sinks=sinks)
                    out, lse = decode_attention(qd, kc, vc, lengths, save_residuals=True, **dkw)
                    p_out, p_lse = decode_attention_plain(qd, kc, vc, lengths, sm_scale=d**-0.5, save_residuals=True, **dkw)
                    row_of = (lambda p, r=kc.shape[2], s=sinks: _ring_row(p, r, s)) if ring else (lambda p: p)
                    seen = [[row_of(p) for p in _visible_positions(L, window, sinks)] for L in lengths.tolist()]
                    o_out, o_lse, _ = _oracle_rows(qd, kc, vc, seen, softcap=softcap)
                    worst = max(worst, _hold(f"K6 {what} ring={ring} sinks={sinks}", out, p_out, o_out, lse, p_lse,
                                             o_lse, dtype=name)[1] / REL_BAR[name])
                # K7 and K8 over the paged ring with 3 sinks.
                pkw = dict(sliding_window=window, logit_softcap=softcap, attention_sinks=3)
                out, lse = paged_decode_attention(qd, cache, save_residuals=True, **pkw)
                p_out, p_lse = paged_decode_attention_plain(qd, cache, sm_scale=d**-0.5, save_residuals=True, **pkw)
                seen = [_visible_positions(L, window, 3) for L in lengths.tolist()]
                o_out, o_lse, _ = _oracle_rows(qd, k_log, v_log, seen, softcap=softcap)
                worst = max(worst, _hold(f"K7 {what}", out, p_out, o_out, lse, p_lse, o_lse, dtype=name)[1] / REL_BAR[name])
                qc = q[1:, :, :64].contiguous()
                out = paged_prefill_attention(qc, cache, 1, 1000, chunk_len=64, **pkw)
                p_out = paged_prefill_attention_plain(qc, cache, 1, 1000, sm_scale=d**-0.5, **pkw)
                col, row = torch.arange(1000, device="cuda")[None, :], torch.arange(64, device="cuda")[:, None] + 936
                mask = (col <= row) & ((col > row - window) | (col < 3))
                o_out, _ = _oracle_mask(qc, k_log[1:, :, :1000], v_log[1:, :, :1000], mask, sm_scale=d**-0.5,
                                        softcap=softcap)
                worst = max(worst, _hold(f"K8 {what}", out, p_out, o_out, dtype=name)[1] / REL_BAR[name])
            n += 1
    torch.cuda.synchronize()
    log(
        f"[masked sweep] K1/K2, K6 (dense window, ring, ring + 3 sinks), K7 and K8 (paged ring, 3 sinks) at "
        f"fp32/fp16/bf16 x head_dim 32/64/128 x windows {list(SWEEP_WINDOWS)} (softcap 5 at 65), ragged lengths: all "
        f"within {ORACLE_BAR} of the masked oracle, LSE within {LSE_BAR}; worst row-relative difference at {worst:.3f} "
        f"of its bar {REL_BAR}"
    )
    log(_prefill_edge_sweep("masked"))


TINY_MASKED = {  # phase 16: (label, engine, ModelConfig fields, the kernels the card run launches)
    "dense window 96": ("dense", dict(sliding_window=96), ("K1", "K6", *SERVED)),
    "dense window 48": ("dense", dict(sliding_window=48), ("K2", "K6", *SERVED)),
    "rolling": ("dense", dict(sliding_window=96, rolling=True), ("K1r", "K6", *SERVED)),
    "rolling + sinks 32": ("dense", dict(sliding_window=96, rolling=True, attention_sinks=32), ("K1r", "K6", *SERVED)),
    "softcap 30": ("dense", dict(logit_softcap=30.0), ("K1", "K6", *SERVED)),
    "paged ring": ("paged", dict(sliding_window=96), ("K7", "K8", "K9/K10", *SERVED)),
    "paged + sinks 32": ("paged", dict(sliding_window=96, attention_sinks=32), ("K7", "K8", "K9/K10", *SERVED)),
}
# Phase 16's pairs that must give the same tokens (the JAX package's
# tests/test_rolling.py:334-444): the ring changes memory, not numbers.
TINY_MASKED_EQUAL = (("rolling", "dense window 96"), ("paged ring", "dense window 96"),
                     ("paged + sinks 32", "rolling + sinks 32"))


SPLIT_WINDOW = 1000  # the split-edge sweep's window: spans of about four 256-row splits


def _split_edges(walk_rows: int, unit: int, splits: int, lo: int = 0) -> list[int]:
    """Lengths at the edges of the kv split over live rows [lo, walk_rows):
    each split boundary and each unit edge of the first split, minus one,
    at and plus one."""
    units = -(-(walk_rows - lo) // unit)
    per = -(-units // splits)
    edges = {lo + k * per * unit for k in range(1, splits + 1)} | {lo + k * unit for k in range(1, per + 1)}
    return sorted({e + i for e in edges for i in (-1, 0, 1)})


def phase_split_sweep() -> None:
    """Phase 15, last: K6, K6q, K7 and K7q across the edges of the kv split,
    for every (query dtype, payload, head_dim): GQA groups 1, 4 and 16 (4,
    2 and 1 kv heads), batch 1 (the most splits) and 32, lengths 0, 1 and
    each split and unit edge -1 / 0 / +1, over the dense window, the ring,
    the ring with 3 sinks and the paged ring (3 sinks) of 64- and 128-row
    pages; each held against plain (row-relative, REL_BAR), the fp32 oracle
    (ORACLE_BAR) and its LSE (LSE_BAR), bit-identical over two calls."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.ops.decode import decode_attention, decode_attention_plain
    from flash_attention_tpu_torch.ops.paged import (
        PagedKVCache,
        init_paged_model_cache,
        paged_decode_attention,
        paged_decode_attention_plain,
    )
    from flash_attention_tpu_torch.ops.quant import bits, dequantize, payload_dtype, quantize_values

    t0 = time.perf_counter()
    rng = np.random.default_rng(21)
    gen = torch.Generator(device="cuda").manual_seed(21)
    w = SPLIT_WINDOW
    kinds = ("dense window", "ring", "ring + 3 sinks", "paged ring, 64-row pages", "paged ring, 128-row pages")
    groups = ((1, 4), (4, 2), (16, 1))  # (GQA group, kv heads)
    worst, n, splits_seen = 0.0, 0, set()
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for mode in (None, *QUANT_MODES):
            for d in (32, 64, 128):
                for batch in (32, 1):
                    i = n
                    n += 1
                    kind = kinds[i % len(kinds)]
                    group, hkv = groups[i % len(groups)]
                    what = f"{kind}, {name} q, {mode or name} cache, d={d}, group {group}, batch {batch}"
                    q = (torch_uniform((batch, group * hkv, d), torch.float32, gen) * 4).to(dtype)

                    def rows_of(shape):
                        x = scaled_rows(shape, gen) if mode else torch_uniform(shape, dtype, gen)
                        return quantize_values(x, payload_dtype(mode)) if mode else x

                    if kind.startswith("paged"):
                        page = 64 if "64" in kind else 128
                        per_slot, n_ring = 2048 // page, -(-(w + page) // page) + 2
                        table, num_pages = _ring_table(rng, batch, per_slot, n_ring, sinks=True)
                        pool = init_paged_model_cache(1, num_pages=num_pages, num_slots=batch, pages_per_slot=per_slot,
                                                      kv_heads=hkv, page_size=page, head_dim=d, dtype=dtype,
                                                      kv_quant=mode or "none", device="cuda")
                        for dst, scales in ((pool.k_pool, pool.k_scales), (pool.v_pool, pool.v_scales)):
                            x = rows_of(tuple(dst.shape))
                            bits(dst).copy_(bits(x.values if mode else x))
                            if mode:
                                scales.copy_(x.scales[..., 0])
                        pool.page_table.copy_(torch.from_numpy(table).cuda())
                        edges = _split_edges(per_slot * page, page, 4, 0)
                        cap = per_slot * page
                    else:
                        ring, sinks = kind != "dense window", 3 if "sinks" in kind else 0
                        rows = 1500 if not ring else 1152 + (128 if sinks else 0)
                        kc, vc = rows_of((batch, hkv, rows, d)), rows_of((batch, hkv, rows, d))
                        edges = _split_edges(rows, 64, 4, 128 if sinks else 0) + [rows + 1, w - 1, w, w + 1]
                        cap = rows if not ring else 3 * rows
                    lengths = sorted({0, 1, *(e for e in edges if 0 <= e <= cap)})
                    lengths = lengths[:batch] + [cap] * (batch - len(lengths)) if batch > 1 else [lengths[i % len(lengths)]]
                    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
                    if kind.startswith("paged"):
                        layer = pool._replace(lengths=lengths).layers()[0]
                        kw = dict(sliding_window=w, attention_sinks=3)
                        call = lambda: paged_decode_attention(q, layer, save_residuals=True, **kw)  # noqa: E731
                        (out, lse), _ = _twice(f"K7 {what}", paged_decode_attention, call)
                        grid = paged_decode_attention.last_grid
                        p_out, p_lse = paged_decode_attention_plain(q, layer, sm_scale=d**-0.5, save_residuals=True, **kw)
                        kd, vd = ((_dequant_pool(x, sc) if mode else x) for x, sc in
                                  ((layer.k_pages, layer.k_scales), (layer.v_pages, layer.v_scales)))
                        kd, vd = (_dense_from_pages(x, layer.page_table) for x in (kd, vd))
                        seen = [_visible_positions(L, w, 3) for L in lengths.tolist()]
                    else:
                        kw = dict(sliding_window=w, ring_buffer=ring, attention_sinks=sinks)
                        call = lambda: decode_attention(q, kc, vc, lengths, save_residuals=True, **kw)  # noqa: E731
                        (out, lse), _ = _twice(f"K6 {what}", decode_attention, call)
                        grid = decode_attention.last_grid
                        p_out, p_lse = decode_attention_plain(q, kc, vc, lengths, sm_scale=d**-0.5, save_residuals=True,
                                                              **kw)
                        kd, vd = (dequantize(x) if mode else x for x in (kc, vc))
                        row_of = (lambda p: _ring_row(p, rows, sinks)) if ring else (lambda p: p)  # noqa: E731
                        seen = [[row_of(p) for p in _visible_positions(L, w, sinks)] for L in lengths.tolist()]
                    o_out, o_lse, _ = _oracle_rows(q, kd, vd, seen)
                    worst = max(worst, _hold(f"split sweep {what}", out, p_out, o_out, lse, p_lse, o_lse,
                                             dtype=name)[1] / REL_BAR[name])
                    splits_seen.add(grid[0])
    torch.cuda.synchronize()
    if max(splits_seen) < 2:
        raise RuntimeError(f"split sweep: no case split the kv rows ({splits_seen})")
    log(
        f"[split sweep] K6 / K6q (dense window {w} over 1500 rows, ring of 1152, ring + 3 sinks) and K7 / K7q (paged "
        f"ring, 3 sinks, pages of 64 and 128) at fp32/fp16/bf16 queries x bf16-or-own/int8/e4m3/e5m2 caches x "
        f"head_dim 32/64/128 x batch 32 and 1, groups 1/4/16, lengths 0, 1 and the split edges +-1: {n} cases, kv "
        f"splits {sorted(splits_seen)}, each bit-identical over two calls, within {ORACLE_BAR} of the oracle, LSE "
        f"within {LSE_BAR}, worst row-relative difference at {worst:.3f} of its bar {REL_BAR}; "
        f"{time.perf_counter() - t0:.1f} s"
    )


def phase_tiny_masked() -> int:
    """Phase 16: the tiny fp32 model with each mask through its engine on
    the card and on the CPU, greedy tokens identical; prompts of 700, 150
    and 40 tokens, so windows and rings roll. Returns K2's launches in the
    window-48 run."""
    import dataclasses

    import numpy as np
    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params
    from flash_attention_tpu_torch.serving.engine import Request, ServingEngine
    from flash_attention_tpu_torch.serving.paged_engine import PagedServingEngine

    rng = np.random.default_rng(16)
    reqs = [Request(id=i, prompt=tuple(int(t) for t in rng.integers(0, TINY_CFG["vocab_size"], n)), max_new_tokens=m)
            for i, (n, m) in enumerate(((700, 24), (150, 24), (40, 16)))]
    base = ModelConfig(**TINY_CFG)
    params = init_model_params(torch.Generator().manual_seed(0), base)
    tokens, k2 = {}, 0
    for label, (kind, fields, used) in TINY_MASKED.items():
        cfg = dataclasses.replace(base, **fields)
        got = {}
        for device in ("cuda", "cpu"):
            on = _to_device(params, device)
            if kind == "dense":
                eng = ServingEngine(on, cfg, max_slots=2, max_seq=1024, prefill_chunk=64)
            else:
                eng = PagedServingEngine(on, cfg, max_slots=2, num_pages=16, pages_per_slot=8, page_size=128,
                                         prefill_chunk=128)
            got[device] = replayed_tokens(f"[tiny masked] {label}", eng, reqs)
            if device == "cuda":
                launches = read_counts()
                check_launches(f"[tiny masked] {label}, on the card", launches, used)
                k2 += launches["K2"]
            if kind == "paged" and eng.alloc.free_count != 15:
                raise RuntimeError(f"[tiny masked] {label}: {eng.alloc.free_count} pages free after the run, want 15")
        if got["cuda"] != got["cpu"]:
            raise RuntimeError(f"[tiny masked] {label}: card tokens {got['cuda']} != CPU {got['cpu']}")
        if any(len(got["cuda"][r.id]) != r.max_new_tokens for r in reqs):
            raise RuntimeError(f"[tiny masked] {label}: completions of the wrong length")
        tokens[label] = got["cuda"]
        log(f"[tiny masked] {label} ({kind} engine): card tokens (every decode block replayed) == CPU tokens; "
            f"kernels {used}")
    for a, b in TINY_MASKED_EQUAL:
        if tokens[a] != tokens[b]:
            raise RuntimeError(f"[tiny masked] {a} tokens {tokens[a]} != {b} tokens {tokens[b]}")
    log("[tiny masked] rolling == dense window, paged ring == dense window, paged sinks == rolling sinks: "
        "tokens identical")
    return k2


LOGIT_BAR = 0.1  # phase 17: last-chunk logits, ring vs dense cache, row by row relative to the row's largest


def _serve_masked(card: str, label: str, eng, prompts, *, used, new_tokens: int = FULL_NEW_TOKENS,
                  programs: str | None = None) -> dict:
    """One served run of ``prompts`` (greedy, ``new_tokens`` each) on
    ``eng``, every launch count set to 0 just before and read just after; it
    must launch exactly ``used``. The prefill chunks are timed one by one
    (synchronised) and the logits of each request's last chunk are kept.
    With ``programs`` "decode", ``warmup(prompt_len=WARMUP_PROMPT)`` before
    the run (every decode program; the prefill programs past the first chunk
    position are built by the run, their first eager runs and captures
    timed with the chunks) and ``hold_programs`` and
    ``hold_prefill_programs`` (over the keys the run's chunks used) after it. With
    "all", a prefill-only run of the prompts first (cold) and the whole
    ``warmup()``, then the prefill-only run again (warm: it captures
    nothing); the served run then replays every program, and
    ``hold_programs`` and ``hold_prefill_programs`` follow. Returns tokens,
    logits, launches and the run's numbers."""
    import torch

    from flash_attention_tpu_torch.serving.engine import Request

    cold = warm = None
    if programs == "decode":
        eng.warmup(prompt_len=WARMUP_PROMPT)
    elif programs == "all":
        first, cold = prefill_only(label, eng, prompts)
        eng.warmup()
        _, warm = prefill_only(label, eng, prompts, cold=first)
    chunk_s, last, used_keys = [], {}, set()
    inner = eng._prefill_chunk_step

    def step(tokens, slot, start, kv_end):
        used_keys.add((kv_end - start, kv_end))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = inner(tokens, slot, start, kv_end)
        torch.cuda.synchronize()
        chunk_s.append(time.perf_counter() - t0)
        st = eng._prefills[slot]
        if kv_end >= len(st.padded):
            last[st.req.id] = logits[0, : len(st.req.prompt) - start].cpu()
        return logits

    eng._prefill_chunk_step = step
    captures = eng.prefill_programs.captures
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    done = eng.run([Request(id=i, prompt=p, max_new_tokens=new_tokens) for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, bodies = read_counts(), read_bodies()
    peak = torch.cuda.max_memory_allocated()
    tokens = {rid: c.tokens for rid, c in done.items()}
    bad = [rid for rid, t in tokens.items() if len(t) != new_tokens]
    if bad or not all(bool(torch.isfinite(x).all()) for x in last.values()) or len(last) != len(prompts):
        raise RuntimeError(f"[{label}] requests {bad} without {new_tokens} tokens, or non-finite prefill logits")
    check_launches(f"[{label}] the main path", launches, used)
    check_chunk_rope(f"[{label}] the main path", launches, eng.cfg.num_layers, len(chunk_s))
    check_tensor_cores(f"[{label}] the main path", bodies)
    if "K7" in used:
        check_self_term(f"[{label}] the main path", launches, bodies)
    n_prompt = sum(len(p) for p in prompts)
    numbers = {"prefill_tok_s": n_prompt / sum(chunk_s), "decode_tok_s": eng.decode_tokens / eng.decode_time_s,
               "peak_gib": peak / 2**30}
    captures = eng.prefill_programs.captures - captures
    if cold is not None:
        numbers.update(prefill_cold_tok_s=n_prompt / cold, prefill_warm_tok_s=n_prompt / warm)
        log(f"[{label}] prefill-only runs: {n_prompt} prompt tokens in {cold:.3f} s = {n_prompt / cold:.1f} tok/s cold "
            f"(the engine's first run), {warm:.3f} s = {n_prompt / warm:.1f} tok/s warm (after warmup(): every chunk a "
            f"replay) (wall clock) ({card})")
    log(
        f"[{label}] {len(prompts)} requests, {n_prompt} prompt tokens: prefill {numbers['prefill_tok_s']:.1f} tok/s "
        f"({len(chunk_s)} chunks in {sum(chunk_s):.3f} s, each synchronised, the first eager run and the capture "
        f"of the {captures} prefill programs this run built included), decode {eng.decode_tokens} tokens in "
        f"{eng.decode_time_s:.3f} s of decode section = {numbers['decode_tok_s']:.1f} tok/s, whole run {run_s:.3f} s; "
        f"peak device memory (max_memory_allocated) {numbers['peak_gib']:.2f} GiB; kernel launches {launches}, "
        f"forward launches by body {bodies}; programs: decode mode {eng.programs.mode}, {eng.programs.captures} "
        f"built, {eng.programs.replays} replays; prefill mode {eng.prefill_programs.mode}, "
        f"{eng.prefill_programs.captures} built, {eng.prefill_programs.replays} replays ({card})"
    )
    if programs:
        hold_programs(label, eng)
        hold_prefill_programs(label, eng, None if programs == "all" else used_keys)
    return {"tokens": tokens, "last": last, "launches": launches, **numbers}


def phase_full_masked(card: str) -> dict:
    """Phase 17: ModelConfig(mlp_dim=14336, sliding_window=4096) (Mistral-7B
    v0.1's shape, tied embedding), bf16, weights from seed 0. (a) the
    rolling dense engine, (b) the same without the ring at max_seq 9216,
    (c) the paged ring with 4 sinks, each on run A's 8 requests; (d) a
    softcap of 50 on phase 5's requests. Returns each run's launches."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig, decode_step_logits, init_model_params
    from flash_attention_tpu_torch.serving.engine import ServingEngine
    from flash_attention_tpu_torch.serving.paged_engine import PagedServingEngine

    gc.collect()
    torch.cuda.empty_cache()
    cfg = ModelConfig(**MISTRAL)
    t0 = time.perf_counter()
    params = init_model_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _tensors(params))
    log(f"[full masked] ModelConfig(mlp_dim=14336, sliding_window=4096) bf16: {n_params / 1e9:.3f} B params "
        f"({_nbytes(params) / 1e9:.3f} GB) initialised on the card in {time.perf_counter() - t0:.1f} s ({card})")
    rng = np.random.default_rng(17)
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab_size, n)) for n in MASKED_PROMPT_LENS]
    runs = {}

    def cache_gb(eng) -> float:
        return _nbytes([(c.k, c.v, c.k_scales, c.v_scales) for c in eng.caches]) / 1e9

    # (a) the rolling dense engine: a ring of window + one chunk of rows.
    rolling = dataclasses.replace(cfg, rolling=True)
    eng = ServingEngine(params, rolling, max_slots=8, max_seq=16384, prefill_chunk=256)
    if eng.caches[0].k.shape[2] != RING_ROWS:
        raise RuntimeError(f"rolling cache of {eng.caches[0].k.shape[2]} rows, want {RING_ROWS}")
    log(f"[full masked a] ServingEngine(max_slots=8, max_seq=16384, prefill_chunk=256), rolling: {RING_ROWS} rows a "
        f"slot, KV cache {cache_gb(eng):.4f} GB ({card})")
    runs["a"] = _serve_masked(card, "full masked a", eng, prompts, used=("K1r", "K6", *SERVED), programs="decode")
    step_logits, _ = decode_step_logits(params, rolling, torch.zeros((8, 1), dtype=torch.int32, device="cuda"), eng.caches)
    if not bool(torch.isfinite(step_logits).all()):
        raise RuntimeError("[full masked a] non-finite decode logits over the ring")
    del eng, step_logits
    torch.cuda.empty_cache()

    # (b) the same model without the ring, at the 9216 positions run A needs.
    eng = ServingEngine(params, cfg, max_slots=8, max_seq=9216, prefill_chunk=256)
    log(f"[full masked b] ServingEngine(max_slots=8, max_seq=9216, prefill_chunk=256), no ring: KV cache "
        f"{cache_gb(eng):.4f} GB ({card})")
    runs["b"] = _serve_masked(card, "full masked b", eng, prompts, used=("K1", "K6", *SERVED))
    del eng
    torch.cuda.empty_cache()
    worst = max(_rel_diff(runs["a"]["last"][i], runs["b"]["last"][i]) for i in range(len(prompts)))
    part = {len(prompts[i]): next((j for j, (x, y) in enumerate(zip(runs["a"]["tokens"][i], runs["b"]["tokens"][i]))
                                   if x != y), None) for i in range(len(prompts))}
    log(f"[full masked] ring vs no ring: last-chunk prefill logits row-relative {worst:.3e} (bar {LOGIT_BAR}); first "
        f"differing greedy token by prompt length {part} (None: all {FULL_NEW_TOKENS} equal; bf16 flips argmax ties)")
    if worst >= LOGIT_BAR:
        raise RuntimeError(f"[full masked] ring and dense logits differ by {worst:.3e} row-relative")

    # (c) the paged ring with StreamingLLM's 4 sinks.
    sinks = dataclasses.replace(cfg, attention_sinks=SINKS)
    eng = PagedServingEngine(params, sinks, max_slots=8, num_pages=297, pages_per_slot=72, page_size=128,
                             prefill_chunk=256)
    owned = []
    admit = eng._admit_one

    def admit_one(req, slot):
        ok = admit(req, slot)
        if ok:
            owned.append(len(eng.slot_pages[slot]))
        return ok

    eng._admit_one = admit_one
    pc = eng.caches
    pool_gb = _nbytes((pc.k_pool, pc.v_pool)) / 1e9
    runs["c"] = _serve_masked(card, "full masked c", eng, prompts, used=("K7", "K8", "K9/K10", *SERVED), programs="all")
    if max(owned) > 37 or eng.alloc.free_count != 296:
        raise RuntimeError(f"[full masked c] pages owned {owned} (at most 37), {eng.alloc.free_count} free after the run")
    log(f"[full masked c] PagedServingEngine(max_slots=8, num_pages=297, pages_per_slot=72, page_size=128, "
        f"prefill_chunk=256), attention_sinks=4: pool {pool_gb:.4f} GB, pages owned per slot {owned} (at most "
        f"37), all 296 back in the pool after the run ({card})")
    del eng, pc
    torch.cuda.empty_cache()

    # (d) a logit softcap of 50 on phase 5's requests.
    capped = dataclasses.replace(cfg, logit_softcap=50.0)
    rng5 = np.random.default_rng(0)  # phase 5's prompts
    prompts5 = [tuple(int(t) for t in rng5.integers(0, cfg.vocab_size, n)) for n in FULL_PROMPT_LENS]
    eng = ServingEngine(params, capped, max_slots=8, max_seq=2048, prefill_chunk=256)
    runs["d"] = _serve_masked(card, "full masked d", eng, prompts5, used=("K1", "K6", *SERVED))
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return {key: run["launches"] for key, run in runs.items()}


# Masked training (phases 18-20): Mistral-7B's window at twice its length,
# so the window masks half the rows, and one packed row of four documents.
TRAIN_T = 8192
PACKED_DOCS = (5000, 1800, 900, 492)  # one packed 8192-token row
CAP = 50.0  # Gemma-2's attention logit cap
# A cap the kernel cases can see: make_qkv's scaled scores have a standard
# deviation of 1/12, so with q scaled x32 they reach |s| / cap of about 0.5
# and 1 - tanh^2 spans most of (0, 1]. (At cap 50 they would need scores of
# about 50, whose bf16 gradients would outgrow the oracle's absolute bar.)
BITE_CAP, BITE_Q = 5.0, 32


def _packed_ids(docs, device="cuda"):
    """Segment ids [1, sum(docs)] int32: document i's tokens carry id i."""
    import torch

    return torch.cat([torch.full((n,), i, dtype=torch.int32) for i, n in enumerate(docs)])[None].to(device)


def masked_bwd_cases() -> None:
    """Phase 18's correctness cases in bf16 at small shapes: K4m + K5m (GQA
    8/2) and K3m (MHA 4/4) at windows 1, 63, 64 (K2's forward), 65, 1000 and
    4096; a softcap that bites (BITE_CAP with q scaled by BITE_Q); packed
    documents; a (q_ids, kv_ids) pair with kv_len > q_len; a q id absent
    from kv, whose gradient rows must be finite and exactly 0; all three
    masks together."""
    import torch

    bf16, d, bar = torch.bfloat16, 128, REL_BAR["bfloat16"]
    cases = []
    for hq, hkv in ((8, 2), (4, 4)):
        for window in SWEEP_WINDOWS:
            cases.append((f"{hq}/{hkv} heads, T 1024, window {window}", hq, hkv, 1024, 1024, dict(window=window)))
        cases.append((f"{hq}/{hkv} heads, T 4608, window 4096", hq, hkv, 4608, 4608, dict(window=WINDOW)))
        cases.append((f"{hq}/{hkv} heads, T 1024, softcap {BITE_CAP}, q x {BITE_Q}", hq, hkv, 1024, 1024,
                      dict(softcap=BITE_CAP)))
        cases.append((f"{hq}/{hkv} heads, T 1024, documents (500, 300, 150, 74)", hq, hkv, 1024, 1024,
                      dict(segment_ids=_packed_ids((500, 300, 150, 74)))))
        cases.append((f"{hq}/{hkv} heads, T 1024, window 300 + softcap {BITE_CAP}, q x {BITE_Q} + documents "
                      "(500, 300, 150, 74)", hq, hkv, 1024, 1024,
                      dict(window=300, softcap=BITE_CAP, segment_ids=_packed_ids((500, 300, 150, 74)))))
    kv_ids = _packed_ids((600, 424))
    cases.append(("8/2 heads, q 256 over kv 1024, (q_ids, kv_ids) pair", 8, 2, 256, 1024,
                  dict(segment_ids=(kv_ids[:, -256:].contiguous(), kv_ids))))
    absent = kv_ids[:, -256:].clone()
    absent[:, 100:140] = 7  # no kv row has id 7
    cases.append(("8/2 heads, q 256 over kv 1024, q rows 100-139 of an id absent from kv", 8, 2, 256, 1024,
                  dict(segment_ids=(absent, kv_ids), window=700)))
    for n, (what, hq, hkv, q_len, kv_len, masks) in enumerate(cases):
        q, k, v, do = _bwd_inputs(180 + n, hq, hkv, q_len, kv_len, d, bf16)
        if masks.get("softcap"):
            q = (q.float() * BITE_Q).to(bf16)
        grads, _, d_plain, d_rel, d_oracle = _hold_bwd(f"[masked backward] {what}", q, k, v, do, **masks,
                                                       rel_bar=bar)
        if "absent" in what:
            if not (bool(torch.isfinite(grads[0]).all()) and bool((grads[0][:, :, 100:140] == 0).all())):
                raise RuntimeError(f"[masked backward] {what}: the absent id's dq rows are not finite zeros")
        route = _route(hq, hkv, q_len, kv_len, **masks, dtype=bf16)
        log(f"[masked backward] {what}: {route}; |grad-oracle| {d_oracle:.3e} (bar {ORACLE_BAR}), |grad-plain| "
            f"{d_plain:.3e}, row-relative to plain {d_rel:.3e} (bar {bar})")
        del q, k, v, do, grads
    torch.cuda.empty_cache()


def _bwd_bound(name: str, d: int, hq: int, pairs: int, q, k) -> tuple[float, str]:
    """K3's, K4's or K5's bound from the visible pairs and its bytes (q, dO,
    k, v, lse and delta read once, its outputs written once)."""
    products = {"K3m": 5, "K4m": 3, "K5m": 4}
    q_bytes, kv_bytes = 2 * q.numel(), 2 * k.numel()
    in_bytes = 2 * q_bytes + 2 * kv_bytes + 2 * 4 * q.numel() // d
    outs = {"K3m": q_bytes + 2 * kv_bytes, "K4m": q_bytes, "K5m": 2 * kv_bytes}
    return bound(2 * d * pairs * hq * products[name], in_bytes + outs[name])


def _time_bwd(card: str, label: str, q, k, v, do, *, window=None, softcap=None, segment_ids=None,
              lib_mask=None) -> dict:
    """The masked backward kernels of one call's route at the main path's
    shape: held against plain and the oracle (``_by_kv_head``), then
    timed alone on the forward's residuals, beside the plain backward and
    SDPA's backward under the equivalent boolean mask (k and v repeated to
    the q heads outside the timed call, so SDPA takes its memory-efficient
    kernel). Returns report entries by kernel."""
    import torch
    import torch.nn.functional as F

    from flash_attention_tpu_torch.ops.attention_bwd import (
        BwdMasks,
        _delta,
        _guard_lse,
        flash_attention_bwd_plain,
        launch_dkv,
        launch_dq,
        launch_fused,
    )
    from flash_attention_tpu_torch.ops.common import segment_pair

    b, hq, q_len, d = q.shape
    hkv, kv_len = k.shape[1], k.shape[2]
    scale = d**-0.5
    _, (out, lse), d_plain, d_rel, d_oracle = _hold_bwd(
        f"[masked backward] {label}", q, k, v, do, window=window, softcap=softcap, segment_ids=segment_ids,
        rel_bar=REL_BAR["bfloat16"])
    segments = segment_pair(segment_ids, b, q_len, kv_len)
    masks = BwdMasks(window, softcap, segments, q.device)
    args = (q, k, v, do, _guard_lse(lse).contiguous(), _delta(out, do).contiguous())
    kw = dict(causal=True, sm_scale=scale, masks=masks)
    fns = {"K3m": launch_fused, "K4m": launch_dq, "K5m": launch_dkv}
    route = [name for name in _route(hq, hkv, q_len, kv_len, window, softcap, segment_ids) if name in fns]
    for name in route:
        # K3 adds dq in a run-dependent order; its dk and dv are written once.
        _same_twice(f"[masked backward] {label} {name}",
                    lambda fn=fns[name]: fn(*args, **kw)[1:] if name == "K3m" else fn(*args, **kw))
    times = {name: cuda_ms(lambda fn=fns[name]: fn(*args, **kw)) for name in route}
    plain_ms = cuda_ms(lambda: _by_kv_head(lambda qh, oh, lh, dh, kh, vh: flash_attention_bwd_plain(
        qh, kh, vh, oh, lh, dh, causal=True, sm_scale=scale, window=window, softcap=softcap, segments=segments),
        (q, out, lse, do), (k, v)), warmup=1, iters=3)
    lib_ms = None
    if lib_mask is not None:
        group = hq // hkv
        leaves = [x.detach().clone().requires_grad_() for x in
                  (q, k.repeat_interleave(group, dim=1), v.repeat_interleave(group, dim=1))]
        lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=lib_mask)
        lib_ms = cuda_ms(lambda: torch.autograd.grad(lib_out, leaves, do, retain_graph=True))
        del leaves, lib_out
    pairs = _visible_pairs(q_len, kv_len, window, None if segments is None else (segments[0][0:1], segments[1][0:1]))
    report, parts = {}, []
    for name, ms in times.items():
        bound_ms, bound_by = _bwd_bound(name, d, hq, pairs, q, k)
        flops = 2 * d * pairs * hq * {"K3m": 5, "K4m": 3, "K5m": 4}[name]
        parts.append(f"{name} {ms:.4f} ms ({_rates(flops, ms)}; bound {bound_ms:.4f} ms by {bound_by})")
        report[name] = {"max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by}
    ratio = "" if lib_ms is None else f", {' + '.join(times)} over it {sum(times.values()) / lib_ms:.3f}"
    log(f"[masked backward] {label}: |grad-oracle| {d_oracle:.3e}, |grad-plain| {d_plain:.3e}, row-relative "
        f"{d_rel:.3e}; " + ", ".join(parts) + f"; plain (dq, dk, dv) {plain_ms:.4f} ms, SDPA backward (library) "
        + ("none" if lib_ms is None else f"{lib_ms:.4f} ms") + ratio + f"; {pairs} visible pairs a head ({card})")
    return report


def phase_masked_bwd(card: str) -> dict:
    """Phase 18: the masked backward kernels and K1d. First the correctness
    cases (``masked_bwd_cases``); then, at the training path's shapes in
    bf16 (q [1,32,8192,128], kv [1,8,8192,128], window 4096; the same
    packed as documents PACKED_DOCS; MHA q = kv [1,32,8192,128] packed, as
    phase 20d runs it, and [1,32,4096,128] at window 1024): the forward
    (K1, K1d) and the backward (K4m + K5m, K3m) held
    against plain and the oracle, and timed beside the plain versions, SDPA
    with the equivalent boolean mask, the unwindowed causal K4 and K5 at
    T=8192, and their bounds. Returns the report entries and the times the
    step breakdown of phase 20 reads."""
    import torch

    from flash_attention_tpu_torch.ops.attention_bwd import _delta, _guard_lse, launch_dkv, launch_dq
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention

    masked_bwd_cases()
    bf16, d, dev = torch.bfloat16, 128, torch.device("cuda")
    q, k, v, do = _bwd_inputs(18, 32, 8, TRAIN_T, TRAIN_T, d, bf16)
    col, row = torch.arange(TRAIN_T, device=dev)[None, :], torch.arange(TRAIN_T, device=dev)[:, None]
    band = (col <= row) & (col > row - WINDOW)
    ids = _packed_ids(PACKED_DOCS)
    same_doc = ids[0][:, None] == ids[0][None, :]
    shape = f"q [1,32,{TRAIN_T},128] kv [1,8,{TRAIN_T},128]"
    fwd = {"window": _k1_masked(card, f"window {WINDOW}, {shape}", q, k, v, window=WINDOW, lib_mask=band),
           "packed": _k1_masked(card, f"window {WINDOW} + documents {PACKED_DOCS}, {shape}", q, k, v, window=WINDOW,
                                segment_ids=ids, lib_mask=band & same_doc, want="K1d")}
    bwd = {"window": _time_bwd(card, f"window {WINDOW}, {shape}", q, k, v, do, window=WINDOW, lib_mask=band),
           "packed": _time_bwd(card, f"window {WINDOW} + documents {PACKED_DOCS}, {shape}", q, k, v, do,
                               window=WINDOW, segment_ids=ids, lib_mask=band & same_doc)}
    # The same shape unwindowed (causal only, the unmasked K4 and K5): what
    # the window's tile skip saves.
    with torch.no_grad():
        out, lse = flash_attention(q, k, v, causal=True, save_residuals=True)
    args = (q, k, v, do, _guard_lse(lse).contiguous(), _delta(out, do).contiguous())
    causal_ms = {name: cuda_ms(lambda fn=fn: fn(*args, causal=True, sm_scale=d**-0.5))
                 for name, fn in (("K4", launch_dq), ("K5", launch_dkv))}
    log(f"[masked backward] {shape} causal, no window (K4, K5 unmasked): K4 {causal_ms['K4']:.4f} ms, K5 "
        f"{causal_ms['K5']:.4f} ms; window {WINDOW}: K4m {bwd['window']['K4m']['ms']:.4f} ms "
        f"({bwd['window']['K4m']['ms'] / causal_ms['K4']:.3f} of causal), K5m {bwd['window']['K5m']['ms']:.4f} ms "
        f"({bwd['window']['K5m']['ms'] / causal_ms['K5']:.3f}); visible pairs {_window_pairs(TRAIN_T, TRAIN_T, WINDOW)} "
        f"of {_window_pairs(TRAIN_T, TRAIN_T, None)} ({card})")
    del q, k, v, do, out, lse, args
    torch.cuda.empty_cache()
    # K3m at phase 20d's shape: MHA, q = kv [1,32,8192,128], window 4096, packed.
    q, k, v, do = _bwd_inputs(20, 32, 32, TRAIN_T, TRAIN_T, d, bf16)
    mha = _time_bwd(card, f"window {WINDOW} + documents {PACKED_DOCS}, q = kv [1,32,{TRAIN_T},128] (MHA)", q, k, v,
                    do, window=WINDOW, segment_ids=ids, lib_mask=band & same_doc)
    del q, k, v, do, band, same_doc
    torch.cuda.empty_cache()
    # K3m at T=4096, window 1024.
    q, k, v, do = _bwd_inputs(19, 32, 32, 4096, 4096, d, bf16)
    col, row = torch.arange(4096, device=dev)[None, :], torch.arange(4096, device=dev)[:, None]
    _time_bwd(card, "window 1024, q = kv [1,32,4096,128] (MHA)", q, k, v, do, window=1024,
              lib_mask=(col <= row) & (col > row - 1024))
    del q, k, v, do
    torch.cuda.empty_cache()
    report = {"K1d": fwd["packed"], "K3m": mha["K3m"], "K4m": bwd["window"]["K4m"], "K5m": bwd["window"]["K5m"]}
    step = {"window": fwd["window"]["ms"] + bwd["window"]["K4m"]["ms"] + bwd["window"]["K5m"]["ms"],
            "packed": fwd["packed"]["ms"] + bwd["packed"]["K4m"]["ms"] + bwd["packed"]["K5m"]["ms"]}
    log(f"[masked backward] attention kernels a layer at T={TRAIN_T}: window {step['window']:.4f} ms (K1 + K4m + "
        f"K5m), packed {step['packed']:.4f} ms (K1d + K4m + K5m), packed / window {step['packed'] / step['window']:.3f} "
        f"({card})")
    return report, step


def phase_masked_bwd_sweep() -> None:
    """Every (dtype, head_dim) instantiation of the masked K3, K4 and K5 (and
    K1d's forward) at ragged shapes: windows BWD_SWEEP_WINDOWS (at 65
    softcap BITE_CAP with q scaled by BITE_Q, else q x 4), MHA
    self-attention (K3m), GQA 4/2 and 8/1 self-attention and q 100
    end-aligned over kv 300 (K4m + K5m); segment ids of three documents at
    windows 63 and 1000."""
    import torch

    worst, n = 0.0, 0
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        for d in (32, 64, 128):
            for window in BWD_SWEEP_WINDOWS:
                softcap = BITE_CAP if window == 65 else None
                for hq, hkv, q_len, kv_len in ((4, 4, 300, 300), (4, 2, 300, 300), (8, 1, 300, 300), (4, 2, 100, 300)):
                    ids = None
                    if window in (63, 1000):
                        kv_ids = _packed_ids((130, 101, 69))
                        ids = kv_ids if q_len == kv_len else (kv_ids[:, -q_len:].contiguous(), kv_ids)
                    what = f"[masked backward sweep] {name} d={d} {hq}/{hkv} q {q_len} kv {kv_len} window {window}"
                    q, k, v, do = _bwd_inputs(n, hq, hkv, q_len, kv_len, d, dtype, strided_do=False)
                    q = (q.float() * (BITE_Q if softcap else 4)).to(dtype)
                    _, _, _, d_rel, _ = _hold_bwd(what, q, k, v, do, window=window, softcap=softcap,
                                                  segment_ids=ids, rel_bar=REL_BAR[name])
                    worst = max(worst, d_rel / REL_BAR[name])
                    n += 1
    log(f"[masked backward sweep] K3m, K4m and K5m (forward K1, K2 or K1d) at fp32/fp16/bf16 x head_dim 32/64/128 x "
        f"windows {list(BWD_SWEEP_WINDOWS)} (softcap {BITE_CAP} with q x {BITE_Q} at 65, three documents at 63 and 1000), "
        f"MHA, GQA, cross-length, {n} cases: all within {ORACLE_BAR} of the masked oracle's gradients; worst "
        f"row-relative difference to plain at {worst:.3f} of its bar {REL_BAR}")


def phase_tiny_train_masked() -> None:
    """Phase 19: the tiny fp32 model with a window of 24 and softcap 30 on
    the card and on the CPU (``_tiny_train``): packed (three documents a
    row, then two) through K1d and K4m + K5m (GQA) or K3m (MHA), and
    unpacked through K2 and K4m + K5m."""
    import torch

    ids = torch.cat([_packed_ids((40, 35, 25), "cpu"), _packed_ids((70, 30), "cpu")])
    runs = ((2, ids, ("K1d", "K4m", "K5m")), (4, ids, ("K1d", "K3m")), (2, None, ("K2", "K4m", "K5m")))
    _tiny_train("[tiny train masked] window 24, softcap 30, 4 q /", 19, runs, sliding_window=24, logit_softcap=30.0)


def phase_full_train_masked(card: str, attn_ms: dict) -> dict:
    """Phase 20: ModelConfig(mlp_dim=14336, sliding_window=4096) (Mistral-7B
    v0.1's shape) trained at full width and depth, bf16, weights from seed
    0, B=1, T=8192 (phase 17's engines released): (a) three steps and the
    SGD check, exactly K1, K4m and K5m; (b) one step of one packed row of
    documents PACKED_DOCS on the same weights, exactly K1d, K4m and K5m;
    (c) softcap 50 added, one step; (d) the MHA route,
    ModelConfig(mlp_dim=14336, sliding_window=4096, num_kv_heads=32,
    num_layers=4), one packed step, exactly K1d and K3m. Prints the
    attention kernels' share of (a)'s step from phase 18's kernel times
    (``attn_ms``, one layer's forward + backward kernels at these shapes)
    and (b)'s attention over (a)'s. Returns each run's launches."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params

    gc.collect()
    torch.cuda.empty_cache()
    cfg = ModelConfig(**MISTRAL)
    params = init_model_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    n_params = sum(t.numel() for t in _tensors(params))
    log(f"[full train masked] ModelConfig(mlp_dim=14336, sliding_window=4096) bf16: {n_params / 1e9:.3f} B params, "
        f"{_nbytes(params) / 1e9:.3f} GB and their gradients as much ({card})")
    rng = np.random.default_rng(20)
    batches = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, TRAIN_T + 1))).cuda() for _ in range(3)]
    ids = _packed_ids(PACKED_DOCS)
    runs = {}
    runs["a"] = _train_steps(card, "[full train masked a] window 4096", params, cfg, batches,
                                    used=("K1", "K4m", "K5m"))
    share = cfg.num_layers * attn_ms["window"] / (runs["a"]["step_s"] * 1e3)
    log(f"[full train masked a] attention kernels (K1 + K4m + K5m, phase 18's times at this shape) "
        f"{cfg.num_layers} x {attn_ms['window']:.2f} ms = {cfg.num_layers * attn_ms['window']:.1f} ms, "
        f"{share:.3f} of the median step ({card})")
    _sgd_check("[full train masked a]", params, cfg, batches[-1], runs["a"]["losses"][-1])
    runs["b"] = _train_steps(card, f"[full train masked b] window 4096, packed {PACKED_DOCS}", params, cfg,
                                    batches[:1], used=("K1d", "K4m", "K5m"), segment_ids=ids)
    log(f"[full train masked b] attention kernels packed / unpacked (phase 18, K1d + K4m + K5m over K1 + K4m + K5m): "
        f"{attn_ms['packed'] / attn_ms['window']:.3f}; step packed / unpacked "
        f"{runs['b']['step_s'] / runs['a']['step_s']:.3f} ({card})")
    runs["c"] = _train_steps(card, f"[full train masked c] window 4096, softcap {CAP}", params,
                                    dataclasses.replace(cfg, logit_softcap=CAP), batches[:1],
                                    used=("K1", "K4m", "K5m"))
    for t in _tensors(params):
        t.grad = None
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg_mha = ModelConfig(**MISTRAL, num_kv_heads=32, num_layers=4)
    p_mha = init_model_params(torch.Generator(device="cuda").manual_seed(1), cfg_mha)
    runs["d"] = _train_steps(card, f"[full train masked d] ModelConfig(mlp_dim=14336, sliding_window=4096, "
                                    f"num_kv_heads=32, num_layers=4), packed {PACKED_DOCS}", p_mha, cfg_mha,
                                    batches[:1], used=("K1d", "K3m"), segment_ids=ids)
    del p_mha
    gc.collect()
    torch.cuda.empty_cache()
    return {key: run["launches"] for key, run in runs.items()}

# Phase 21: each probe tool's shortened sweep, its variant that stands for it
# in the kernels' line, and the kernels its run must launch.
PROBES = (
    ("P1", "softmax_probe", "SMOKE_SWEEP", "softmax_probe.py:29", (8192, "c=1 128x64 f32"), ("PT",)),
    ("P2", "mfu_probe", "SEQS", "mfu_probe.py:36", (1024, "full"), ("PS",)),
    ("P3", "grid_probe", "SMOKE_SWEEP", "grid_probe.py:23", (8192, "128x128 par"), ("PT",)),
    ("P4", "causal_probe", "SMOKE_TILES", "causal_probe.py:28", (8192, "128x128 skip=1 mask=cond"), ("PT",)),
    ("P5", "gap_probe", "SEQS", "gap_probe.py:27", (1024, "bare S"), ("PS", "K1")),
    ("P6", "epilogue_probe", "SEQS", "epilogue_probe.py:25", (1024, "after_pv"), ("PS",)),
)


def phase_probes(card: str) -> list:
    """Phase 21: the probes P1-P6 (csrc/probes.cu, bodies T and S) through
    their tools' ``run`` on a shortened sweep: every variant's output on the
    card against its plain version, row by row within the bar its tool
    states (``tools/probes.py``: PLAIN_BAR, BF16_BAR), and, where it
    computes attention, within ORACLE_BAR of the fp32 oracle; each timed
    beside its plain version, its bound and SDPA. Each probe's run starts
    with every launch count at 0 and must launch exactly its kernels (P5's
    real rows also K1). Returns the kernels' line entries, one a probe."""
    import importlib

    import torch

    entries = []
    t0 = time.perf_counter()
    for probe, module, sweep, replaces, (seq, variant), used in PROBES:
        tool = importlib.import_module(f"flash_attention_tpu_torch.tools.{module}")
        t_probe = time.perf_counter()
        zero_counts()
        rows = tool.run(getattr(tool, sweep), quick=True, log=lambda line: log(f"[probes] {line}"))
        launches = read_counts()
        check_launches(f"[probes] {probe}", launches, used)
        timed = [r for r in rows if "ms" in r]
        rep = next(r for r in timed if r["seq"] == seq and r["variant"] == variant)
        log(f"[probes] {probe} ({module}): {len(timed)} variants within their bars, worst row-relative "
            f"{max(r['rel_plain'] / r['bar'] for r in timed):.3f} of its bar, worst |kernel - oracle| "
            f"{max((r['oracle_err'] for r in timed if r['oracle_err'] is not None), default=0.0):.3e}; "
            f"launches {launches}; {time.perf_counter() - t_probe:.1f} s ({card})")
        body = "T" if used[0] == "PT" else "S"
        entries.append({
            "name": f"probe {probe}, body {body}: {variant} at seq {seq}", "route": "cuda",
            "source": "flash_attention_tpu_torch/csrc/probes.cu", "replaces": f"tools/{replaces}",
            "launches": launches[used[0]], "max_abs_err": max(r["abs_plain"] for r in timed),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["sdpa_ms"],
        })
        del rows, timed
        torch.cuda.empty_cache()
    probe_edges(card)
    log(f"[probes] phase 21 took {time.perf_counter() - t0:.1f} s ({card})")
    return entries


# Phase 21's edge cases: body S at each seq and hb (the full stage) and with
# the mask (hb 1), body T at every tile shape, 4 heads.
PROBE_EDGE_SEQS = (128, 512, 1024)
PROBE_EDGE_T_SEQ = 1024
PROBE_EDGE_T = (  # (arith, skip, mask, grid, causal)
    ("f32", True, "cond", "head", True),
    ("bf16", True, "always", "head", True),
    ("f32", False, "none", "qtile", False),
)


def probe_edges(card: str) -> None:
    """Body S (csrc/probes.cu, clusters of 2 hb blocks) at seq 128, 512 and
    1024, hb 1 and 2, and with the causal mask at hb 1; body T at each of
    the four tile shapes in fp32 with skip + cond, in bf16 with skip +
    always and unmasked under the q-tile-major order, at seq 1024. Each is
    held row by row to its plain version within its tool's bar, within
    ORACLE_BAR of the fp32 oracle, and to itself over two calls, bit for
    bit (the partial outputs and sums add in rank order)."""
    import math

    import torch

    from flash_attention_tpu_torch.ops.common import LOG2E
    from flash_attention_tpu_torch.tools import probes

    t0 = time.perf_counter()
    heads, sm_scale = 4, 1.0 / math.sqrt(probes.HEAD_DIM)
    scale2 = sm_scale * LOG2E
    worst, cases = 0.0, 0

    def hold(what: str, call, plain, bar: float, want) -> None:
        nonlocal worst, cases
        got, again = call(), call()
        torch.cuda.synchronize()
        rel, err = probes.rel_err(got, plain()), probes.max_abs(got, want)
        if not (rel < bar and err < ORACLE_BAR and torch.equal(got, again)):
            raise RuntimeError(f"[probes] {what}: row-relative {rel:.3e} (bar {bar}), |kernel - oracle| {err:.3e}, "
                               f"two calls equal: {torch.equal(got, again)}")
        worst, cases = max(worst, rel / bar), cases + 1

    for seq in PROBE_EDGE_SEQS:
        q, k, v = probes.make_inputs(heads, seq, seed=seq)
        wants = {c: probes.oracle_out(q, k, v, causal=c, sm_scale=sm_scale) for c in (False, True)}
        for hb, mask in ((1, False), (2, False), (1, True)):
            hold(f"body S seq {seq} hb {hb} mask {mask}",
                 lambda: probes.probe_single(q, k, v, scale2, mask=mask, hb=hb),
                 lambda: probes.single_plain(q, k, v, scale2, mask=mask), probes.PLAIN_BAR, wants[mask])
    seq = PROBE_EDGE_T_SEQ
    q, k, v = probes.make_inputs(heads, seq, seed=7)
    qs = (q.float() * scale2).to(q.dtype)
    wants = {(c, x): probes.oracle_out(q, k, v, causal=c, sm_scale=sm_scale if x else math.log(2))
             for c in (False, True) for x in (False, True)}
    for bm, bn in probes.TILES:
        for arith, skip, mask, grid, causal in PROBE_EDGE_T:
            qq = qs if arith == "bf16" else q  # the bf16 softmax takes q scaled, as P1 does
            kw = dict(bm=bm, bn=bn, arith=arith, skip=skip, mask=mask)
            hold(f"body T {bm}x{bn} {arith} skip {skip} mask {mask} grid {grid}",
                 lambda: probes.probe_tiled(qq, k, v, grid=grid, **kw), lambda: probes.tiled_plain(qq, k, v, **kw),
                 probes.BF16_BAR if arith == "bf16" else probes.PLAIN_BAR, wants[(causal, arith == "bf16")])
    log(f"[probes] edge cases: {cases} (body S at seq {PROBE_EDGE_SEQS} x hb 1 / 2 and masked; body T at "
        f"{len(probes.TILES)} tile shapes x {len(PROBE_EDGE_T)} variants, seq {PROBE_EDGE_T_SEQ}), {heads} heads, each "
        f"within its bar of plain (worst at {worst:.3f} of it), within {ORACLE_BAR} of the oracle and bit-identical over "
        f"two calls; {time.perf_counter() - t0:.1f} s ({card})")


# Phase 22: the parallel layer, the split-decode API and the KV-cache
# checkpoints. Four gloo ranks share the card (NCCL refuses two ranks on one
# device), each on cuda:0; the rendezvous is a file in a temporary directory.
PAR_RANKS = 4
PAR_SEED = 22
CTX_SPEC = (None, None, "context", None)  # a [B, H, S, D] tensor's sequence over the context axis
CKPT_PROMPTS = (37, 255, 600, 900)  # phase 22's checkpoint: one prompt a slot of 4 x 1024 positions
CKPT_BEFORE, CKPT_AFTER = 4, 8  # greedy tokens served before the checkpoint, and decoded after it


def _ring_reference(q, k, v, do, causal: bool = True):
    """The single-process kernels on the whole tensors: K1's output and LSE,
    the gradients of flash_attention's autograd Function (K1, then K3 or
    K4 + K5) for the cotangent ``do``, and the fp32 oracle's output."""
    import torch

    from flash_attention_tpu_torch.ops.flash_attention import flash_attention
    from flash_attention_tpu_torch.ops.reference import reference_attention

    with torch.no_grad():
        out, lse = flash_attention(q, k, v, causal=causal, save_residuals=True)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    grads = torch.autograd.grad(flash_attention(*leaves, causal=causal), leaves, do)
    oracle = _by_kv_head(lambda qh, kh, vh: reference_attention(qh, kh, vh, causal=causal), (q,), (k, v))
    return out, lse, grads, oracle


def _hold_ring(what: str, ref, out, grads=None, lse=None) -> dict:
    """A ring's gathered output (and gradients, LSE) against ``_ring_reference``:
    row by row within REL_BAR of the single-process kernels (gradients with
    GRAD_FLOOR of their largest as the row floor), the output within
    ORACLE_BAR of the fp32 oracle, the LSE within LSE_BAR."""
    r_out, r_lse, r_grads, oracle = ref
    err = {"out rel": _rel_diff(out, r_out), "out oracle": _max_diff(out, oracle)}
    if grads is not None:
        floor = GRAD_FLOOR * max(float(w.abs().max()) for w in r_grads)
        err.update({f"{name} rel": _rel_diff(g, w, floor) for name, g, w in zip(("dq", "dk", "dv"), grads, r_grads)})
    if lse is not None:
        err["lse"] = _max_diff(lse, r_lse)
    bar = REL_BAR["bfloat16"]
    if not (all(err.get(f"{x} rel", 0.0) < bar for x in ("out", "dq", "dk", "dv")) and err["out oracle"] < ORACLE_BAR
            and err.get("lse", 0.0) < LSE_BAR):
        raise RuntimeError(f"[parallel] {what} disagrees with the single-process kernels: {err}")
    return err


def _ring_run(what: str, fn, q, k, v, do, mesh, used, *, perm=None, lse_zigzag=None) -> dict:
    """``fn`` (a ring callable) on this rank's context shards of q, k, v
    (first permuted by ``perm``: the zigzag layout) under autograd with the
    cotangent's shard: once to warm up, then timed (forward + backward, host
    clock to a synchronise) with every launch count at 0 before and read
    after, which must show exactly ``used`` on the tensor-core forward.
    Returns the time, the step's peak allocation above what the rank held
    before it (MB), launches and the gathered output and gradients in
    global order; with ``lse_zigzag`` (the layout of the shards) also the
    ring's LSE from its own forward (``_ring_forward``; the public callables
    return the output alone)."""
    import torch
    import torch.distributed as dist

    from flash_attention_tpu_torch.parallel.mesh import gather, shard
    from flash_attention_tpu_torch.parallel.ring import _ring_forward, inverse_permutation

    local = [shard(x if perm is None else x[:, :, perm.to(x.device)], mesh, CTX_SPEC) for x in (q, k, v, do)]

    def step():
        leaves = [x.detach().requires_grad_() for x in local[:3]]
        out = fn(*leaves)
        return out.detach(), torch.autograd.grad(out, leaves, local[3])

    step()
    dist.barrier()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    out, grads = step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak_mb = (torch.cuda.max_memory_allocated() - held) / 1e6
    launches, bodies = read_counts(), read_bodies()
    check_launches(f"[parallel] rank {dist.get_rank()} {what}", launches, used)
    check_tensor_cores(f"[parallel] rank {dist.get_rank()} {what}", bodies, "K1/K1d/K2")
    res = [out, *grads]
    if lse_zigzag is not None:
        with torch.no_grad():
            lse = _ring_forward(*local[:3], mesh.get_group("context"), True, q.shape[-1] ** -0.5, lse_zigzag)[1]
        res.append(lse[..., None])
    res = [gather(x, mesh, CTX_SPEC) for x in res]
    if perm is not None:
        inv = inverse_permutation(perm).to(q.device)
        res = [x[:, :, inv] for x in res]
    return {"ms": ms, "peak_mb": peak_mb, "launches": {k: n for k, n in launches.items() if n}, "out": res[0],
            "grads": res[1:4], "lse": res[4][..., 0] if lse_zigzag is not None else None}


def _parallel_rank(card: str) -> dict:
    """One of phase 22's PAR_RANKS gloo ranks, every one on cuda:0. Each
    rank builds the global inputs from the seed, takes its shards, and runs
    the ring (contiguous and zigzag through make_ring_attention, and
    ring_flash_attention on zigzag-layout shards) at Mistral-7B's training
    shape forward and backward, the MHA ring (32 / 32 heads), the
    context-parallel and head-sharded forwards, and sharded decode at
    BASELINE config 4 over bf16, int8 and e4m3 caches; rank 0 holds every
    gathered result against the single-process kernels on the whole tensors
    and the fp32 oracle. Returns the rank's times, launches and transport."""
    import functools

    import numpy as np
    import torch
    import torch.distributed as dist

    from flash_attention_tpu_torch.ops.decode import decode_attention
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention
    from flash_attention_tpu_torch.ops.quant import QuantizedTensor, dequantize, payload_dtype, quantize_values
    from flash_attention_tpu_torch.ops.reference import reference_attention
    from flash_attention_tpu_torch.parallel.mesh import gather, host_staged, make_mesh, shard
    from flash_attention_tpu_torch.parallel.ring import make_ring_attention, ring_flash_attention, zigzag_data_layout
    from flash_attention_tpu_torch.parallel.sharding import (
        make_context_parallel_attention,
        make_sharded_decode_attention,
        make_sharded_flash_attention,
    )

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, bf16 = dist.get_rank(), torch.bfloat16
    ring, heads, grid = make_mesh(1, 1, PAR_RANKS), make_mesh(1, PAR_RANKS, 1), make_mesh(2, 2, 1)
    group = ring.get_group("context")
    staged = host_staged(group, torch.empty(1, device="cuda"))
    report = {"rank": rank, "transport": f"{dist.get_backend(group)}: the ring's rotation through pinned host buffers "
              f"{staged}, all_reduce and all_gather on the card's tensors", "ms": {}, "peak MB": {}, "launches": {}, "errors": {}}
    t = TRAIN_T // PAR_RANKS

    def route(hq, hkv, rows):
        return set(_route(hq, hkv, t, t, dtype=bf16)) | set(_route(hq, hkv, rows, rows, dtype=bf16))

    # The ring at Mistral-7B's training shape, GQA 32 / 8 heads, causal.
    q, k, v, do = _bwd_inputs(PAR_SEED, 32, 8, TRAIN_T, TRAIN_T, 128, bf16, strided_do=False)
    ref = _ring_reference(q, k, v, do) if rank == 0 else None
    idx, _ = zigzag_data_layout(TRAIN_T, PAR_RANKS)
    cases = {  # name: (callable, the shards' permutation, the ring's layout for its LSE, kernels)
        "contiguous": (make_ring_attention(ring, causal=True), None, False, route(32, 8, t)),
        "zigzag": (make_ring_attention(ring, causal=True, zigzag=True), None, None, route(32, 8, t // 2)),
        "zigzag layout, ring_flash_attention": (
            functools.partial(ring_flash_attention, group=group, causal=True, zigzag=True), idx, True,
            route(32, 8, t // 2)),
    }
    for name, (fn, perm, lse_zigzag, used) in cases.items():
        run = _ring_run(f"ring {name}", fn, q, k, v, do, ring, used, perm=perm, lse_zigzag=lse_zigzag)
        report["ms"][f"ring {name}"], report["launches"][f"ring {name}"] = run["ms"], run["launches"]
        report["peak MB"][f"ring {name}"] = run["peak_mb"]
        if rank == 0:
            report["errors"][f"ring {name}"] = _hold_ring(f"ring {name}", ref, run["out"], run["grads"], run["lse"])
        del run

    # Context parallel (non-causal, the KV sharded over the ring's ranks),
    # then head-sharded K1 (model 4: 8 q and 2 kv heads a rank).
    fn = make_context_parallel_attention(ring)
    local = [shard(x, ring, s) for x, s in zip((q, k, v), fn.in_specs)]
    zero_counts()
    with torch.no_grad():
        out = gather(fn(*local), ring, fn.out_spec)
    report["launches"]["context parallel"] = {n: c for n, c in read_counts().items() if c}
    check_launches(f"[parallel] rank {rank} context parallel", read_counts(), ("K1",))
    check_tensor_cores(f"[parallel] rank {rank} context parallel", read_bodies(), "K1/K1d/K2")
    if rank == 0:
        with torch.no_grad():
            nc = (flash_attention(q, k, v, causal=False, save_residuals=True),
                  _by_kv_head(lambda qh, kh, vh: reference_attention(qh, kh, vh), (q,), (k, v)))
        report["errors"]["context parallel"] = _hold_ring("context parallel", (*nc[0], ref[2], nc[1]), out)
        del nc
    fn = make_sharded_flash_attention(heads, causal=True)
    local = [shard(x, heads, s) for x, s in zip((q, k, v), fn.in_specs)]
    zero_counts()
    with torch.no_grad():
        out = gather(fn(*local), heads, fn.out_spec)
    check_launches(f"[parallel] rank {rank} head-sharded", read_counts(), ("K1",))
    check_tensor_cores(f"[parallel] rank {rank} head-sharded", read_bodies(), "K1/K1d/K2")
    report["launches"]["head-sharded"] = {n: c for n, c in read_counts().items() if c}
    if rank == 0:
        report["errors"]["head-sharded"] = _hold_ring("head-sharded", ref, out)
        report["errors"]["head-sharded"]["bit-identical"] = bool(torch.equal(out, ref[0]))
    del q, k, v, do, ref, local, out

    # The MHA ring (32 / 32 heads): its pairs take K3.
    q, k, v, do = _bwd_inputs(PAR_SEED + 1, 32, 32, TRAIN_T, TRAIN_T, 128, bf16, strided_do=False)
    ref = _ring_reference(q, k, v, do) if rank == 0 else None
    run = _ring_run("MHA ring contiguous", make_ring_attention(ring, causal=True), q, k, v, do, ring,
                    route(32, 32, t), lse_zigzag=False)
    report["ms"]["MHA ring contiguous"], report["launches"]["MHA ring contiguous"] = run["ms"], run["launches"]
    report["peak MB"]["MHA ring contiguous"] = run["peak_mb"]
    if rank == 0:
        report["errors"]["MHA ring contiguous"] = _hold_ring("MHA ring contiguous", ref, run["out"], run["grads"],
                                                             run["lse"])
    del q, k, v, do, ref, run

    # Sharded decode at BASELINE config 4 (32 slots x 8192 rows), data 2 x model 2.
    gen = torch.Generator(device="cuda").manual_seed(PAR_SEED)
    slots, rows = LONG["slots"], LONG["rows"]
    qd = (torch_uniform((slots, 32, 128), torch.float32, gen) * 8).to(bf16)
    lengths = torch.from_numpy(np.random.default_rng(PAR_SEED).integers(1, rows + 1, slots)).to("cuda", torch.int32)
    lengths[:3] = torch.tensor([1, rows, rows - 1])
    fn = make_sharded_decode_attention(grid)
    for mode in ("bf16", "int8", "fp8_e4m3"):
        k_x, v_x = scaled_rows((slots, 8, rows, 128), gen), scaled_rows((slots, 8, rows, 128), gen)
        if mode == "bf16":
            kc, vc = k_x.to(bf16), v_x.to(bf16)
        else:
            kc, vc = (quantize_values(x, payload_dtype(mode)) for x in (k_x, v_x))
        del k_x, v_x
        local = [shard(x, grid, s) for x, s in zip((qd, kc, vc, lengths), fn.in_specs)]
        zero_counts()
        out = gather(fn(*local), grid, fn.out_spec)
        want = ("K6",) if mode == "bf16" else ("K6q",)
        check_launches(f"[parallel] rank {rank} sharded decode {mode}", read_counts(), want)
        report["launches"][f"sharded decode {mode}"] = {n: c for n, c in read_counts().items() if c}
        if rank == 0:
            single = decode_attention(qd, kc, vc, lengths)
            kd, vd = (dequantize(x) if isinstance(x, QuantizedTensor) else x for x in (kc, vc))
            oracle = reference_attention(qd[:, :, None], kd, vd, kv_length=lengths)[:, :, 0]
            err = {"out rel": _rel_diff(out, single), "out oracle": _max_diff(out, oracle),
                   "bit-identical": bool(torch.equal(out, single))}
            if not (err["out rel"] < REL_BAR["bfloat16"] and err["out oracle"] < ORACLE_BAR):
                raise RuntimeError(f"[parallel] sharded decode {mode} disagrees: {err}")
            report["errors"][f"sharded decode {mode}"] = err
            del single, kd, vd, oracle
        del kc, vc, local, out
    return report


def _nccl_rank(card: str) -> dict:
    """Every factory over NCCL at world size 1 (``spawn_ranks`` initialises
    through initialize_distributed): each output, and the ring's gradients,
    bit-identical to the single-process call on the same tensors (K1, K4 +
    K5, K6q)."""
    import torch
    import torch.distributed as dist

    from flash_attention_tpu_torch.ops.decode import decode_attention
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention
    from flash_attention_tpu_torch.ops.quant import quantize_kv
    from flash_attention_tpu_torch.parallel.mesh import make_mesh
    from flash_attention_tpu_torch.parallel.ring import make_ring_attention
    from flash_attention_tpu_torch.parallel.sharding import (
        make_context_parallel_attention,
        make_sharded_decode_attention,
        make_sharded_flash_attention,
    )

    torch.cuda.set_device(0)
    mesh = make_mesh()
    q, k, v, do = _bwd_inputs(PAR_SEED, 32, 8, TRAIN_T, TRAIN_T, 128, torch.bfloat16, strided_do=False)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad(out, leaves, do)
    same = {}
    with torch.no_grad():
        same["make_sharded_flash_attention"] = torch.equal(make_sharded_flash_attention(mesh, causal=True)(q, k, v),
                                                           out)
        same["make_context_parallel_attention"] = torch.equal(make_context_parallel_attention(mesh)(q, k, v),
                                                              flash_attention(q, k, v))
    for zigzag in (False, True):
        ring_leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        ring_out = make_ring_attention(mesh, causal=True, zigzag=zigzag)(*ring_leaves)
        ring_grads = torch.autograd.grad(ring_out, ring_leaves, do)
        same[f"make_ring_attention(zigzag={zigzag}) forward and backward"] = (
            torch.equal(ring_out, out) and all(torch.equal(a, b) for a, b in zip(ring_grads, grads)))
    gen = torch.Generator(device="cuda").manual_seed(PAR_SEED)
    qd = (torch_uniform((LONG["slots"], 32, 128), torch.float32, gen) * 8).to(torch.bfloat16)
    kq, vq = quantize_kv(*(scaled_rows((LONG["slots"], 8, LONG["rows"], 128), gen) for _ in range(2)), "int8")
    lengths = torch.full((LONG["slots"],), LONG["rows"] - 5, dtype=torch.int32, device="cuda")
    same["make_sharded_decode_attention (int8)"] = torch.equal(make_sharded_decode_attention(mesh)(qd, kq, vq, lengths),
                                                               decode_attention(qd, kq, vq, lengths))
    return {"backend": dist.get_backend(mesh.get_group("context")), "same": same}


def phase_split_api(card: str) -> dict:
    """decode_attention_split at BASELINE config 4 (q [32,32,128] bf16 over an
    int8 and an e4m3 cache [32,8,8192,128], rows scaled one by one, ragged
    lengths): one K6q launch with the asked kv split, against
    ``decode_split_plain`` and the fp32 oracle on the dequantized cache
    (``_hold_quant``), allocating under 1 % of a bf16 copy of the cache;
    then ``decode_attention(auto_split=True)`` where the gate fires (q
    [1,32,128] over [1,8,16384,128] bf16): the larger of the gate's and the
    kernel's own split, within the bars of the unsplit call and the plain
    version, timed beside the unsplit call and the gate's count alone.
    Returns the int8 split's kernels' line entry."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.ops.decode import (
        DECODE_RUN,
        decode_attention,
        decode_attention_split,
        decode_split_plain,
        should_split_decode,
    )
    from flash_attention_tpu_torch.ops.quant import dequantize, payload_dtype, quantize_values
    from flash_attention_tpu_torch.ops.reference import reference_attention_with_lse

    bf16, scale, splits = torch.bfloat16, 128**-0.5, 4
    gen = torch.Generator(device="cuda").manual_seed(PAR_SEED + 2)
    slots, rows = LONG["slots"], LONG["rows"]
    q = (torch_uniform((slots, 32, 128), torch.float32, gen) * 8).to(bf16)
    lengths = torch.from_numpy(np.random.default_rng(PAR_SEED + 2).integers(0, rows + 1, slots)).to("cuda", torch.int32)
    entry = None
    for mode in ("int8", "fp8_e4m3"):
        kq, vq = (quantize_values(scaled_rows((slots, 8, rows, 128), gen), payload_dtype(mode)) for _ in range(2))
        zero_counts()
        out = decode_attention_split(q, kq, vq, lengths, num_splits=splits)
        launches = read_counts()
        check_launches(f"[split] decode_attention_split {mode}", launches, ("K6q",))
        if decode_attention.last_grid[0] != splits:
            raise RuntimeError(f"[split] K6q ran {decode_attention.last_grid[0]} splits, asked {splits}")
        plain = decode_split_plain(q, kq, vq, lengths, splits, sm_scale=scale)
        kd, vd = dequantize(kq), dequantize(vq)
        oracle = reference_attention_with_lse(q[:, :, None], kd, vd, kv_length=lengths)[0][:, :, 0]
        d_plain, d_oracle, d_rel, _ = _hold_quant(f"[split] decode_attention_split {mode}", out, plain, oracle)
        del kd, vd, plain, oracle
        copy_bytes = 2 * slots * 8 * rows * 128 * 2
        extra = _no_copy(f"[split] decode_attention_split {mode}",
                         lambda: decode_attention_split(q, kq, vq, lengths, num_splits=splits),
                         out.numel() * out.element_size(), copy_bytes)
        ms = cuda_ms(lambda: decode_attention_split(q, kq, vq, lengths, num_splits=splits))
        own_ms = cuda_ms(lambda: decode_attention(q, kq, vq, lengths))
        own_splits = decode_attention.last_grid[0]
        plain_ms = cuda_ms(lambda: decode_split_plain(q, kq, vq, lengths, splits, sm_scale=scale), warmup=1, iters=3)
        n_rows = int(lengths.sum())
        nbytes = 2 * n_rows * 8 * (128 * kq.values.element_size() + 4) + 2 * 2 * q.numel() + 4 * slots
        bound_ms, bound_by = bound(4 * 128 * 32 * n_rows, nbytes)
        log(f"[split] decode_attention_split {mode}, q [{slots},32,128] cache [{slots},8,{rows},128], {splits} splits "
            f"(the kernel's own count: {own_splits}), lengths 0-{rows}: |out-plain| {d_plain:.3e}, |out-oracle| "
            f"{d_oracle:.3e} (bar {ORACLE_BAR}), row-relative {d_rel:.3e} (bar {REL_BAR['bfloat16']}); allocated "
            f"{extra / 1e6:.3f} MB in the call (a bf16 copy: {copy_bytes / 1e6:.0f} MB); kernel {ms:.4f} ms "
            f"({own_splits} splits: {own_ms:.4f} ms), plain {plain_ms:.4f} ms, library none, bound {bound_ms:.4f} ms "
            f"by {bound_by} ({nbytes / 1e6:.1f} MB) ({card})")
        if mode == "int8":
            entry = {"name": f"decode_attention_split, K6q int8, {splits} splits, config 4", "route": "cuda",
                     "source": "flash_attention_tpu_torch/csrc/decode.cu", "replaces": f"{REFERENCE}/ops/decode.py:56",
                     "launches": launches["K6q"], "max_abs_err": d_plain, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
        del kq, vq, out

    q1 = (torch_uniform((1, 32, 128), torch.float32, gen) * 8).to(bf16)
    k1, v1 = (torch_uniform((1, 8, 16384, 128), bf16, gen) for _ in range(2))
    len1 = torch.tensor([15000], dtype=torch.int32, device="cuda")
    gate = should_split_decode(1, 8, 16384, DECODE_RUN)
    auto = decode_attention(q1, k1, v1, len1, auto_split=True)
    auto_splits = decode_attention.last_grid[0]
    unsplit = decode_attention(q1, k1, v1, len1, auto_split=False)
    own = decode_attention.last_grid[0]
    gated = decode_attention_split(q1, k1, v1, len1, num_splits=gate)
    plain = decode_split_plain(q1, k1, v1, len1, gate, sm_scale=scale)
    d_rel = max(_rel_diff(auto, unsplit), _rel_diff(auto, plain), _rel_diff(gated, plain))
    auto_ms = cuda_ms(lambda: decode_attention(q1, k1, v1, len1, auto_split=True))
    own_ms = cuda_ms(lambda: decode_attention(q1, k1, v1, len1, auto_split=False))
    gate_ms = cuda_ms(lambda: decode_attention_split(q1, k1, v1, len1, num_splits=gate))
    log(f"[split] decode_attention(auto_split=True), q [1,32,128] cache [1,8,16384,128] bf16, length 15000: ran "
        f"{auto_splits} splits (the larger of the gate's {gate} and the kernel's own {own}) in {auto_ms:.4f} ms; "
        f"auto_split=False ({own} splits) {own_ms:.4f} ms; the gate's {gate} splits alone (decode_attention_split) "
        f"{gate_ms:.4f} ms; row-relative to the unsplit call and plain {d_rel:.3e} (bar {REL_BAR['bfloat16']}) ({card})")
    if auto_splits != max(gate, own) or d_rel >= REL_BAR["bfloat16"]:
        raise RuntimeError("[split] auto_split did not take the larger of the gate's and the kernel's splits, "
                           "or disagrees")
    return entry


def _greedy(step, params, cfg, tok, caches, n: int) -> list:
    """``n`` greedy decode steps (``step``: decode_step or decode_step_paged)
    from the tokens ``tok`` [S, 1]; the tokens of each step."""
    out = []
    for _ in range(n):
        tok, caches = step(params, cfg, tok, caches)
        out.append(tok[:, 0].tolist())
    return out


def _check_restored(what: str, saved, restored) -> None:
    """Every leaf of ``restored`` has ``saved``'s device and bytes."""
    import torch

    from flash_attention_tpu_torch.utils.checkpoint import _leaves

    a, b = _leaves(saved), _leaves(restored)
    if len(a) != len(b) or not all(x.device == y.device and torch.equal(x.view(torch.uint8), y.view(torch.uint8))
                                   for x, y in zip(a, b)):
        raise RuntimeError(f"[checkpoint] {what}: the restored cache differs from the saved one")


def phase_checkpoint(card: str) -> None:
    """ModelConfig() at full width, bf16, weights from seed 0: ServingEngine
    serves one prompt a slot (4 x 1024 positions, CKPT_BEFORE greedy tokens),
    its caches go to a file (save_kv_cache) and come back into a fresh
    engine's template (load_kv_cache), bit for bit on the card; CKPT_AFTER
    greedy decode steps from the restored caches give the tokens of the same
    steps from the live ones. Then the same for a PagedServingEngine's pool,
    filled through the engine's allocator and the model's paged prefill."""
    import gc
    import pathlib
    import tempfile

    import numpy as np
    import torch

    from flash_attention_tpu_torch.models.transformer import (
        ModelConfig,
        decode_step,
        decode_step_paged,
        init_model_params,
        prefill_paged,
    )
    from flash_attention_tpu_torch.serving.engine import Request, ServingEngine
    from flash_attention_tpu_torch.serving.paged_engine import PagedServingEngine
    from flash_attention_tpu_torch.utils.checkpoint import load_kv_cache, save_kv_cache

    gc.collect()
    torch.cuda.empty_cache()
    cfg = ModelConfig()
    params = init_model_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    rng = np.random.default_rng(PAR_SEED)
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab_size, n)) for n in CKPT_PROMPTS]
    with tempfile.TemporaryDirectory(prefix="fat_ckpt.") as tmp, torch.no_grad():
        # One decode step a block, not pipelined: a slot's cache ends at its
        # prompt and the tokens written (all but the last), which tell its request.
        eng = ServingEngine(params, cfg, max_slots=len(prompts), max_seq=1024, prefill_chunk=256,
                            decode_block_steps=1, pipeline_decode=False)
        done = eng.run([Request(id=i, prompt=p, max_new_tokens=CKPT_BEFORE) for i, p in enumerate(prompts)])
        by_length = {len(p) + CKPT_BEFORE - 1: done[i].tokens[-1] for i, p in enumerate(prompts)}
        tok = torch.tensor([[by_length[n]] for n in eng.caches[0].lengths.tolist()], dtype=torch.int32, device="cuda")
        path = pathlib.Path(tmp) / "dense.npz"
        t0 = time.perf_counter()
        save_kv_cache(path, eng.caches)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = load_kv_cache(path, ServingEngine(params, cfg, max_slots=len(prompts), max_seq=1024).caches)
        t_load = time.perf_counter() - t0
        _check_restored("dense", eng.caches, restored)
        live = _greedy(decode_step, params, cfg, tok, eng.caches, CKPT_AFTER)
        resumed = _greedy(decode_step, params, cfg, tok, restored, CKPT_AFTER)
        log(f"[checkpoint] ServingEngine, ModelConfig(), {len(prompts)} slots x 1024: {path.stat().st_size / 1e6:.1f} MB "
            f"saved in {t_save:.2f} s, loaded into a fresh engine's caches in {t_load:.2f} s, every leaf bit-equal; "
            f"{CKPT_AFTER} greedy steps resumed == uninterrupted: {resumed == live} ({card})")
        if resumed != live:
            raise RuntimeError(f"[checkpoint] dense: resumed tokens {resumed} != uninterrupted {live}")
        del eng, restored
        gc.collect()

        page, per_slot = 128, 1024 // 128
        peng = PagedServingEngine(params, cfg, max_slots=len(prompts), num_pages=len(prompts) * per_slot + 1,
                                  pages_per_slot=per_slot, page_size=page)
        pool, toks = peng.caches, []
        for slot, p in enumerate(prompts):
            n_pages = -(-(len(p) + CKPT_BEFORE + CKPT_AFTER) // page)
            pool.page_table[slot, :n_pages] = torch.tensor(peng.alloc.acquire(n_pages), dtype=torch.int32)
            padded = torch.zeros((1, -(-len(p) // page) * page), dtype=torch.int64, device="cuda")
            padded[0, :len(p)] = torch.tensor(p)
            logits, pool = prefill_paged(params, cfg, padded, pool, slot, len(p))
            toks.append(int(torch.argmax(logits[0, len(p) - 1])))
        tok = torch.tensor(toks, dtype=torch.int32, device="cuda")[:, None]
        for _ in range(CKPT_BEFORE - 1):
            tok, pool = decode_step_paged(params, cfg, tok, pool)
        path = pathlib.Path(tmp) / "paged.npz"
        save_kv_cache(path, pool)
        fresh = PagedServingEngine(params, cfg, max_slots=len(prompts), num_pages=len(prompts) * per_slot + 1,
                                   pages_per_slot=per_slot, page_size=page)
        restored = load_kv_cache(path, fresh.caches)
        _check_restored("paged", pool, restored)
        live = _greedy(decode_step_paged, params, cfg, tok, pool, CKPT_AFTER)
        resumed = _greedy(decode_step_paged, params, cfg, tok, restored, CKPT_AFTER)
        log(f"[checkpoint] PagedServingEngine's pool, {len(prompts)} slots x {per_slot} pages of {page}: "
            f"{path.stat().st_size / 1e6:.1f} MB, every leaf bit-equal on reload; {CKPT_AFTER} greedy steps resumed == "
            f"uninterrupted: {resumed == live} ({card})")
        if resumed != live:
            raise RuntimeError(f"[checkpoint] paged: resumed tokens {resumed} != uninterrupted {live}")
    del params, peng, fresh, pool, restored
    gc.collect()
    torch.cuda.empty_cache()


def phase_parallel(card: str) -> list:
    """Phase 22: the four-rank run (``_parallel_rank``) and the NCCL
    world-size-1 run (``_nccl_rank``), each in processes of its own
    (``spawn_ranks``; the kernels are built already, so each rank loads
    them), then the split-decode API and the checkpoints in this process.
    Prints each rank's ring times (forward + backward, information: the four
    ranks share one card) and peak allocations. Returns the kernels' line entries: K1 at the
    ring's step shape and the int8 split decode."""
    import gc

    import torch
    import torch.nn.functional as F

    from flash_attention_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from flash_attention_tpu_torch.utils.distributed import spawn_ranks
    from flash_attention_tpu_torch.utils.testing import make_qkv

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reports = spawn_ranks(_parallel_rank, PAR_RANKS, card, backend="gloo", timeout_s=900)
    log(f"[parallel] {PAR_RANKS} gloo ranks on one card ({reports[0]['transport']}); ring q [1,32,{TRAIN_T},128] "
        f"kv [1,8,{TRAIN_T},128] bf16 causal, {TRAIN_T // PAR_RANKS} rows a rank; {time.perf_counter() - t0:.1f} s")
    for name, err in reports[0]["errors"].items():
        log(f"[parallel] {name} against the single-process kernels and the fp32 oracle: "
            + ", ".join(f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}" for k, v in err.items())
            + f" (bars: row-relative {REL_BAR['bfloat16']}, oracle {ORACLE_BAR}, lse {LSE_BAR})")
    for r in reports:
        log(f"[parallel] rank {r['rank']} forward + backward ms (information, ranks share the card): "
            + ", ".join(f"{k} {v:.2f}" for k, v in r["ms"].items()) + "; the step's peak allocation above what the "
            "rank held, MB: " + ", ".join(f"{k} {v:.1f}" for k, v in r["peak MB"].items())
            + f"; launches {r['launches']} ({card})")
    t0 = time.perf_counter()
    nccl = spawn_ranks(_nccl_rank, 1, card, backend="nccl", timeout_s=300)[0]
    log(f"[parallel] world size 1 over {nccl['backend']}: bit-identical to the single-process call: {nccl['same']}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not all(nccl["same"].values()):
        raise RuntimeError(f"[parallel] a factory at world size 1 differs from its single-process call: {nccl['same']}")

    # K1 at the ring's off-diagonal step: q [1,32,2048,128] against a kv chunk [1,8,2048,128], non-causal, with LSE.
    s = TRAIN_T // PAR_RANKS
    q, k, v = make_qkv(PAR_SEED, 1, 32, s, 128, num_kv_heads=8, dtype=torch.bfloat16, device="cuda")
    out, lse = flash_attention(q, k, v, save_residuals=True)
    p_out, p_lse = flash_attention_plain(q, k, v, causal=False, sm_scale=128**-0.5, save_residuals=True)
    d_plain, d_rel = _max_diff(out, p_out), _rel_diff(out, p_out)
    if d_rel >= REL_BAR["bfloat16"] or _max_diff(lse, p_lse) >= LSE_BAR:
        raise RuntimeError("[parallel] K1 at the ring's step shape disagrees with its plain version")
    ms = cuda_ms(lambda: flash_attention(q, k, v, save_residuals=True))
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, causal=False, sm_scale=128**-0.5, save_residuals=True))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True))
    flops, nbytes = 4 * 128 * 32 * s * s, 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse.numel()
    bound_ms, bound_by = bound(flops, nbytes)
    launches = sum(n.get("K1", 0) for key, n in reports[0]["launches"].items() if "ring" in key and "MHA" not in key)
    log(f"[parallel] K1 at the ring's step, q [1,32,{s},128] kv [1,8,{s},128] non-causal + lse: |out-plain| "
        f"{d_plain:.3e}, row-relative {d_rel:.3e}; kernel {ms:.4f} ms ({_rates(flops, ms)}), plain {plain_ms:.4f} ms, "
        f"SDPA (library) {lib_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}; rank 0 launched K1 {launches} times "
        f"in the GQA rings ({card})")
    ring_entry = {"name": f"fwd_kernel, wgmma + TMA (K1), ring step q [1,32,{s},128] kv [1,8,{s},128]",
                  "route": "cuda", "source": "flash_attention_tpu_torch/csrc/flash_fwd_sm90.cu",
                  "replaces": f"{REFERENCE}/ops/flash_attention.py:57", "launches": launches, "max_abs_err": d_plain,
                  "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}
    del q, k, v, out, lse, p_out, p_lse
    split_entry = phase_split_api(card)
    phase_checkpoint(card)
    return [ring_entry, split_entry]


# Phase 23: tensor-parallel serving behind both engines' shard_caches. (a) one
# NCCL rank; (b) four gloo ranks sharing the card at full width; (c) the JAX
# package's sharded-serving test config on eight gloo ranks; (d) the kernels
# at a model-4 shard's shapes.
TP_SEED = 23
TP_PREFILL, TP_DECODE = 1024, 8  # (b)'s logits: one prefill, then decode steps on fixed tokens
TP_RANKS = 4
JAX_TEST_CFG = dict(vocab_size=128, model_dim=128, num_layers=2, num_q_heads=4, num_kv_heads=4, head_dim=32,
                    mlp_dim=256, dtype="float32")  # tests/test_sharded_serving.py:18-23
JAX_TEST_REQS = (((5, 9, 2), 5), ((100, 3, 44, 8), 6), ((64, 7), 4), ((11, 12), 3))
DENSE_ENGINE = dict(max_slots=8, max_seq=2048, prefill_chunk=256)  # phase 5's
PAGED_ENGINE = dict(max_slots=8, num_pages=129, pages_per_slot=16, page_size=128, prefill_chunk=256,
                    prefix_cache=True)  # phase 8's


def _full_requests(cfg):
    """Phase 5's main-path requests (ids 100..109, seed 0's prompts)."""
    import numpy as np

    from flash_attention_tpu_torch.serving.engine import Request

    rng = np.random.default_rng(0)
    prompts = [tuple(int(t) for t in rng.integers(0, cfg.vocab_size, n)) for n in FULL_PROMPT_LENS]
    return [Request(id=100 + i, prompt=p, max_new_tokens=FULL_NEW_TOKENS) for i, p in enumerate(prompts)]


def _serve_logits(params, cfg, path: str, group=None):
    """The model over a fresh one-slot cache of ``cfg``'s heads, dense or
    paged (``path``; nine pages through a table of pages 1..9): a
    TP_PREFILL-token prefill (dense: one call, K1; paged: the paged
    engine's 256-row chunks, K8), then TP_DECODE decode steps (K6 / K7 and
    K10) on fixed tokens from TP_SEED; every row's logits
    [TP_PREFILL + TP_DECODE, vocab], fp32."""
    import functools

    import numpy as np
    import torch

    from flash_attention_tpu_torch.models import transformer as tm

    toks = np.random.default_rng(TP_SEED).integers(0, cfg.vocab_size, (1, TP_PREFILL + TP_DECODE))
    toks = torch.from_numpy(toks).to("cuda", torch.int32)
    if path == "dense":
        cache = tm.init_caches(cfg, 1, 2048, device="cuda")
        prefill, step = tm.prefill, tm.decode_step_logits
    else:
        pages = -(-(TP_PREFILL + TP_DECODE) // 128)
        cache = tm.init_paged_caches(cfg, num_pages=pages + 1, num_slots=1, pages_per_slot=pages, page_size=128,
                                     device="cuda")
        cache.page_table.copy_(torch.arange(1, pages + 1, dtype=torch.int32, device="cuda")[None])
        prefill = functools.partial(_chunked_paged_prefill, tm.prefill_chunk_paged)
        step = tm.decode_step_logits_paged
    with torch.no_grad():
        logits, cache = prefill(params, cfg, toks[:, :TP_PREFILL], cache, tp_group=group)
        rows = [logits[0]]
        for i in range(TP_DECODE):
            logits, cache = step(params, cfg, toks[:, TP_PREFILL + i, None], cache, tp_group=group)
            rows.append(logits)
    return torch.cat(rows)


def _chunked_paged_prefill(prefill_chunk_paged, params, cfg, tokens, cache, *, tp_group):
    """Slot 0's prompt ``tokens`` [1, T] through ``prefill_chunk_paged`` in
    PAGED_ENGINE's chunks: (logits [1, T, vocab], cache)."""
    import torch

    chunk, rows = PAGED_ENGINE["prefill_chunk"], []
    for lo in range(0, tokens.shape[1], chunk):
        hi = min(lo + chunk, tokens.shape[1])
        logits, cache = prefill_chunk_paged(params, cfg, tokens[:, lo:hi], cache, 0, lo, hi, tp_group=tp_group)
        rows.append(logits)
    return torch.cat(rows, 1), cache


def _cast(tree, dtype):
    """A param tree with every tensor in ``dtype`` (the same values)."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


def _reference_logits(params, cfg) -> dict:
    """``_serve_logits`` of the single-process model, dense and paged, and
    of the same weights in fp32 (the dense path): the references the
    tensor-parallel logits are held to."""
    import dataclasses

    import torch

    want = {path: _serve_logits(params, cfg, path) for path in ("dense", "paged")}
    wide = _cast(params, torch.float32)
    want["fp32"] = _serve_logits(wide, dataclasses.replace(cfg, dtype="float32"), "dense")
    del wide
    return want


def _layer_outputs(params, cfg, group=None, inputs=None):
    """The prefill of ``_serve_logits``' first TP_PREFILL tokens, layer by
    layer as the model's trunk runs it: each layer's input (the residual
    stream) and its two outputs, attention and MLP, each the sum of a
    row-parallel projection under ``group``. With ``inputs`` every layer
    takes the given input, not its predecessor's output, so a layer's
    outputs hold its own rounding only."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.models.attention import attention_prefill, init_kv_cache
    from flash_attention_tpu_torch.models.transformer import rms_norm, swiglu

    acfg = cfg.attention_config()
    toks = np.random.default_rng(TP_SEED).integers(0, cfg.vocab_size, (1, TP_PREFILL + TP_DECODE))[:, :TP_PREFILL]
    x = params["embed"][torch.from_numpy(toks).to("cuda")].to(cfg.torch_dtype)
    ins, outs = [], []
    with torch.no_grad():
        for i, lp in enumerate(params["layers"]):
            x = x if inputs is None else inputs[i]
            cache = init_kv_cache(acfg, 1, TP_PREFILL, device="cuda")
            a, _ = attention_prefill(lp["attn"], acfg, rms_norm(x, lp["attn_norm"], cfg.norm_eps), cache, tp_group=group)
            y = x + a
            m = swiglu(rms_norm(y, lp["mlp_norm"], cfg.norm_eps), lp["mlp"], group)
            ins.append(x)
            outs.append((a, m))
            x = y + m
    return ins, outs


def _engine_logits(eng, path: str):
    """``_serve_logits`` through an engine's params, model config and model
    group (a tensor-parallel engine's: its shards over a cache of its
    heads)."""
    return _serve_logits(eng.params, eng.model_cfg, path, eng.tp_group)


def _served(eng, reqs, used, what: str) -> tuple[dict, dict, float]:
    """``eng`` serves ``reqs`` with every count at 0 before and read after:
    (tokens by id, the launches, seconds). It must launch the kernels in
    ``used`` and no other."""
    import torch

    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done, chunks = counting_chunks(eng, lambda: eng.run(reqs))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts()
    check_launches(what, launches, used)
    check_chunk_rope(what, launches, eng.cfg.num_layers, chunks)
    return {rid: c.tokens for rid, c in done.items()}, {n: c for n, c in launches.items() if c}, secs


def _sharded_checkpoint(make, reqs, path) -> bool:
    """A sharded engine (``make()``) serves ``reqs``; its ``save_kv_cache``
    file read back through the global caches' layout (``.global_shapes``: at
    world size 1 the engine's own) holds the engine's caches bit for bit,
    and loaded into a fresh sharded engine's caches gives them the same
    bits, still carrying their sharding."""
    from flash_attention_tpu_torch.utils.checkpoint import _leaves, load_kv_cache, save_kv_cache

    eng, fresh = make(), make()
    eng.run(reqs)
    save_kv_cache(path, eng.caches)
    whole = load_kv_cache(path, eng.caches.sharding.global_shapes(eng.caches), device_put=False)
    fresh.caches = load_kv_cache(path, fresh.caches)
    mine = _leaves(eng.caches)
    return (len(_leaves(whole)) == len(mine) and fresh.caches.sharding is not None
            and all(_bits_equal(a.cpu(), b) for a, b in zip(mine, _leaves(whole)))
            and all(_bits_equal(a, b) for a, b in zip(mine, _leaves(fresh.caches))))


def _tp_nccl_rank(card: str, dense_tokens: dict, paged_tokens: dict) -> dict:
    """(a): one NCCL rank, ModelConfig() at full width on seed 0's weights,
    both engines through make_cache_sharding on a one-rank mesh: phase 5's
    and phase 8's tokens, the model's logits bit-identical to the
    single-process model's, and each engine's checkpoint
    (``_sharded_checkpoint``, on engines of 2 slots x 512 rows serving
    phase 5's first four prompts, 8 new tokens each)."""
    import dataclasses
    import pathlib
    import tempfile

    import torch
    import torch.distributed as dist

    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params
    from flash_attention_tpu_torch.parallel.mesh import make_mesh
    from flash_attention_tpu_torch.parallel.sharding import make_cache_sharding
    from flash_attention_tpu_torch.serving.engine import ServingEngine
    from flash_attention_tpu_torch.serving.paged_engine import PagedServingEngine

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig()
    params = init_model_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    sharding = make_cache_sharding(make_mesh())
    reqs = _full_requests(cfg)
    out = {"backend": dist.get_backend(sharding.mesh.get_group("model")), "launches": {}, "s": {}}
    tmp = tempfile.TemporaryDirectory(prefix="fat_tp_ckpt.")
    eng = ServingEngine(params, cfg, **DENSE_ENGINE, shard_caches=sharding)
    got, out["launches"]["dense"], out["s"]["dense"] = _served(eng, reqs, ("K1", "K6", *SERVED), "[sharded] (a) dense")
    out["dense equal"] = got == dense_tokens
    out["modes"] = [eng.programs.mode, eng.prefill_programs.mode]
    ckpt_reqs = [dataclasses.replace(r, max_new_tokens=8) for r in reqs[:4]]  # small engines: the files' I/O
    out["dense checkpoint"] = _sharded_checkpoint(
        lambda: ServingEngine(params, cfg, max_slots=2, max_seq=512, shard_caches=sharding), ckpt_reqs,
        pathlib.Path(tmp.name) / "dense.npz")
    out["dense logits bit-identical"] = torch.equal(_engine_logits(eng, "dense"), _serve_logits(params, cfg, "dense"))
    del eng
    eng = PagedServingEngine(params, cfg, **PAGED_ENGINE, shard_caches=sharding)
    got, out["launches"]["paged"], out["s"]["paged"] = _served(eng, reqs, ("K7", "K8", "K9/K10", *SERVED),
                                                               "[sharded] (a) paged")
    out["paged equal"] = got == paged_tokens
    out["modes"] += [eng.programs.mode, eng.prefill_programs.mode]
    out["paged checkpoint"] = _sharded_checkpoint(
        lambda: PagedServingEngine(params, cfg, max_slots=2, num_pages=9, pages_per_slot=4, page_size=128,
                                   shard_caches=sharding), ckpt_reqs, pathlib.Path(tmp.name) / "paged.npz")
    out["paged logits bit-identical"] = torch.equal(_engine_logits(eng, "paged"), _serve_logits(params, cfg, "paged"))
    out["peak MB"] = torch.cuda.max_memory_allocated() / 2**20
    tmp.cleanup()
    return out


def _bits_digest(t) -> str:
    """A digest of a tensor's bytes: equal digests, equal bits."""
    import hashlib

    import torch

    return hashlib.blake2b(t.contiguous().view(torch.uint8).cpu().numpy().tobytes(), digest_size=16).hexdigest()


def _parting(got: dict, want: dict) -> tuple[int, dict]:
    """Tokens equal position by position (of every request's), and the step
    at which each request that parts first differs."""
    same = sum(a == b for rid in want for a, b in zip(got[rid], want[rid]))
    parts = {rid: next(i for i, (a, b) in enumerate(zip(got[rid], want[rid])) if a != b)
             for rid in want if got[rid] != want[rid]}
    return same, parts


# (b)'s tensor-parallel logits runs: name -> (engine, path). The dense engine's shards are model 2's, the paged
# engine's model 4's; each run's logits are held to the fp32 model's, beside the single-process bf16 model's on the
# same path.
TP_LOGITS = {"model 2, dense": ("dense", "dense"), "model 4, dense": ("paged", "dense"),
             "model 4, paged": ("paged", "paged")}
TP_FP32_SLACK = 1.5  # a tensor-parallel run's distance from the fp32 model, over the single-process bf16 model's


def _tp_gloo_rank(card: str, dense_tokens: dict, paged_tokens: dict) -> dict:
    """(b): one of TP_RANKS gloo ranks on cuda:0. One rank at a time (a
    barrier between), each builds ModelConfig()'s global params from seed 0
    and its two engines (the dense one on data 2 x model 2, the paged one on
    model 4), which take their shards, and frees the global tree; rank 0
    first keeps the references (``_reference_logits``). Then every rank
    serves phase 5's requests through both engines, and each engine's
    tensor-parallel model gives the TP_LOGITS runs' logits, held by rank 0
    against the references and hashed on every rank."""
    import gc

    import torch
    import torch.distributed as dist

    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params
    from flash_attention_tpu_torch.parallel.mesh import make_mesh
    from flash_attention_tpu_torch.parallel.sharding import make_cache_sharding
    from flash_attention_tpu_torch.serving.engine import ServingEngine
    from flash_attention_tpu_torch.serving.paged_engine import PagedServingEngine

    torch.cuda.set_device(0)
    torch.set_num_threads(1)  # four ranks share the host's cores with their gloo threads
    torch.backends.cuda.matmul.allow_tf32 = False
    rank, cfg = dist.get_rank(), ModelConfig()
    grid, heads = make_cache_sharding(make_mesh(2, 2)), make_cache_sharding(make_mesh(1, TP_RANKS))
    out = {"rank": rank, "launches": {}, "s": {}, "logits": {}, "same bits": {}}
    t0 = time.perf_counter()
    want = None
    for turn in range(TP_RANKS):
        if turn == rank:
            params = init_model_params(torch.Generator(device="cuda").manual_seed(0), cfg)
            layer_in, layer_out = _layer_outputs(params, cfg)
            if rank == 0:
                want = _reference_logits(params, cfg)
                out["reference peak MB"] = torch.cuda.max_memory_allocated() / 2**20
            else:
                del layer_out
            engines = {"dense": ServingEngine(params, cfg, **DENSE_ENGINE, shard_caches=grid),
                       "paged": PagedServingEngine(params, cfg, **PAGED_ENGINE, shard_caches=heads)}
            del params
            gc.collect()
            torch.cuda.empty_cache()
            out["held MB"] = torch.cuda.memory_allocated() / 2**20
            out["modes"] = {name: (eng.programs.mode, eng.prefill_programs.mode) for name, eng in engines.items()}
        dist.barrier()
    out["s"]["build"] = time.perf_counter() - t0
    reqs = _full_requests(cfg)
    for name, used in (("dense", ("K1", "K6", *SERVED)), ("paged", ("K7", "K8", "K9/K10", *SERVED))):
        out[name], out["launches"][name], out["s"][name] = _served(engines[name], reqs, used,
                                                                   f"[sharded] (b) rank {rank} {name}")
    for run, (engine, path) in TP_LOGITS.items():
        zero_counts()
        t0 = time.perf_counter()
        logits = _engine_logits(engines[engine], path)
        torch.cuda.synchronize()
        out["s"][f"logits {run}"] = time.perf_counter() - t0
        launches = read_counts()
        check_launches(f"[sharded] (b) rank {rank} logits {run}", launches,
                       ("K1", "K6", *GLUE) if path == "dense" else ("K7", "K8", "K9/K10", *GLUE, "F2c"))
        out["launches"][f"logits {run}"] = {n: c for n, c in launches.items() if c}
        digests = [None] * TP_RANKS
        dist.all_gather_object(digests, _bits_digest(logits))
        out["same bits"][run] = len(set(digests)) == 1
        if rank == 0:
            out["logits"][run] = {"vs fp32": _rel_diff(logits, want["fp32"]), "vs bf16": _rel_diff(logits, want[path]),
                                  "finite": bool(torch.isfinite(logits).all())}
    paged = engines["paged"]
    _, tp_out = _layer_outputs(paged.params, paged.model_cfg, paged.tp_group, inputs=layer_in)
    if rank == 0:
        out["single-process vs fp32"] = {path: _rel_diff(want[path], want["fp32"]) for path in ("dense", "paged")}
        errs = [max(_rel_diff(a, ra), _rel_diff(m, rm)) for (a, m), (ra, rm) in zip(tp_out, layer_out)]
        out["layer rel"] = (max(errs), errs.index(max(errs)))
        out["dense agree"], out["paged agree"] = _parting(out["dense"], dense_tokens), _parting(out["paged"], paged_tokens)
    out["peak MB"] = torch.cuda.max_memory_allocated() / 2**20
    return out


def _tp_tiny_rank(want_dense: dict, want_paged: dict, want_w8: dict) -> dict:
    """(c): one of eight gloo ranks on cuda:0: tests/test_sharded_serving.py's
    fp32 config and requests through both engines on its data 2 x model 4
    mesh (the pools over model 4, replicas over data), then the dense engine
    on the same weights quantized to int8 (W1 on the rank's column shards
    and its row-parallel fp32 partials)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params, quantize_model_weights
    from flash_attention_tpu_torch.parallel.mesh import make_mesh
    from flash_attention_tpu_torch.parallel.sharding import make_cache_sharding
    from flash_attention_tpu_torch.serving.engine import Request, ServingEngine
    from flash_attention_tpu_torch.serving.paged_engine import PagedServingEngine

    torch.cuda.set_device(0)
    torch.set_num_threads(1)
    cfg = ModelConfig(**JAX_TEST_CFG)
    params = _to_device(init_model_params(torch.Generator().manual_seed(0), cfg), "cuda")
    sharding = make_cache_sharding(make_mesh(2, 4))
    reqs = [Request(id=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(JAX_TEST_REQS)]
    out = {"rank": dist.get_rank(), "launches": {}, "s": {}}
    eng = ServingEngine(params, cfg, max_slots=4, max_seq=64, shard_caches=sharding)
    got, out["launches"]["dense"], out["s"]["dense"] = _served(eng, reqs, ("K1", "K6", *SERVED), "[sharded] (c) dense")
    out["dense equal"], out["dense kv"] = got == want_dense, tuple(eng.caches[0].k.shape)
    eng = PagedServingEngine(params, cfg, max_slots=4, num_pages=16, pages_per_slot=2, page_size=128,
                             shard_caches=sharding)
    got, out["launches"]["paged"], out["s"]["paged"] = _served(eng, reqs, ("K7", "K8", "K9/K10", *SERVED),
                                                               "[sharded] (c) paged")
    out["paged equal"], out["paged kv"] = got == want_paged, tuple(eng.caches.k_pool.shape)
    eng = ServingEngine(quantize_model_weights(params), dataclasses.replace(cfg, weight_quant="int8"), max_slots=4,
                        max_seq=64, shard_caches=sharding)
    got, out["launches"]["dense w8"], out["s"]["dense w8"] = _served(eng, reqs, ("K1", "K6", "W1", *SERVED),
                                                                     "[sharded] (c) dense, int8 weights")
    out["w8 equal"] = got == want_w8
    return out


# (d)'s shard shapes: name -> (q heads, kv heads, dense cache slots, kernels). Model 2 is (b)'s dense engine's
# (8 slots over data 2), model 4 its paged engine's (and the dense path of its logits run).
TP_SHARDS = {"model 2": (16, 4, 4, ("K1", "K6")), "model 4": (8, 2, 8, ("K1", "K6", "K7", "K8"))}


def _shard_kernels(card: str, launches: dict) -> list:
    """(d): the kernels of each TP_SHARDS shape in bf16 at the shapes a shard
    of ModelConfig() gives them, against their plain versions
    (row-relative), the fp32 oracle and the LSE, timed beside plain, SDPA
    where it computes the same, and the bound. ``launches``: rank 0's counts
    in (b) by shard (``_sharded_gloo``). Returns the kernels' entries."""
    entries = []
    for shard, (hq, hkv, slots, kernels) in TP_SHARDS.items():
        entries += _shard_kernels_at(card, shard, hq, hkv, slots, kernels, launches[shard])
    return entries


def _shard_kernels_at(card: str, shard: str, hq: int, hkv: int, slots: int, kernels, launches: dict) -> list:
    """``_shard_kernels`` at one shard: ``kernels`` of K1 (a 256-row chunk
    over 2048 cached rows), K6 (``slots`` ragged slots), K7 and K8 (one
    layer's pool of 129 pages) with ``hq`` q over ``hkv`` kv heads."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from flash_attention_tpu_torch.ops.decode import decode_attention, decode_attention_plain
    from flash_attention_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain
    from flash_attention_tpu_torch.ops.paged import (
        paged_decode_attention,
        paged_decode_attention_plain,
        paged_prefill_attention,
        paged_prefill_attention_plain,
    )
    from flash_attention_tpu_torch.ops.reference import reference_attention_with_lse

    dev, bf16, d, label = torch.device("cuda"), torch.bfloat16, 128, shard.replace(" ", "-") + " shard"
    scale, rel_bar = d**-0.5, REL_BAR["bfloat16"]
    gen = torch.Generator(device=dev).manual_seed(TP_SEED)
    rng = np.random.default_rng(TP_SEED)
    entries = []

    def hold(what, name, source, replaces, out, plain, oracle, lse=None, p_lse=None, o_lse=None, *, call, plain_call,
             lib_call, flops, nbytes, key):
        d_plain, d_oracle = _max_diff(out, plain), _max_diff(out, oracle)
        d_rel = max(_rel_diff(out, plain), _rel_diff(out, oracle))
        d_lse = 0.0 if lse is None else max(_max_diff(lse, p_lse), _max_diff(lse, o_lse))
        ms, plain_ms = cuda_ms(call), cuda_ms(plain_call)
        lib_ms = None if lib_call is None else cuda_ms(lib_call)
        bound_ms, bound_by = bound(flops, nbytes)
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        log(f"[sharded] (d) {label}, {what}: |out-plain| {d_plain:.3e} (bar {PLAIN_BAR}), |out-oracle| {d_oracle:.3e} (bar "
            f"{ORACLE_BAR}), row-relative vs plain and oracle {d_rel:.3e} (bar {rel_bar}), |lse| {d_lse:.3e} (bar "
            f"{LSE_BAR}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA (library) {lib}, bound {bound_ms:.4f} ms "
            f"by {bound_by}; launched {launches.get(key, 0)} times by rank 0 at this shard in (b) ({card})")
        if not (d_plain < PLAIN_BAR and d_oracle < ORACLE_BAR and d_rel < rel_bar and d_lse < LSE_BAR):
            raise RuntimeError(f"[sharded] (d) {label}, {what} disagrees")
        entries.append({"name": name, "route": "cuda", "source": f"flash_attention_tpu_torch/csrc/{source}",
                        "replaces": f"{REFERENCE}/{replaces}", "launches": launches.get(key, 0), "max_abs_err": d_plain,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": lib_ms})

    # K1: a 256-row chunk at the end of 2048 cached rows, the cache one slot of a [slots, hkv, 2048, 128] cache.
    q = torch_uniform((1, hq, 256, d), bf16, gen)
    k_cache, v_cache = (torch_uniform((slots, hkv, 2048, d), bf16, gen) for _ in range(2))
    k, v = k_cache[3:4], v_cache[3:4]
    out, lse = flash_attention(q, k, v, causal=True, save_residuals=True)
    p_out, p_lse = flash_attention_plain(q, k, v, causal=True, sm_scale=scale, save_residuals=True)
    o_out, o_lse = reference_attention_with_lse(q, k, v, causal=True)
    mask = torch.arange(2048, device=dev)[None, :] <= torch.arange(256, device=dev)[:, None] + (2048 - 256)
    hold(f"K1 q [1,{hq},256,{d}] kv [1,{hkv},2048,{d}] causal + LSE, {_fwd_grid(q, k)}",
         f"fwd_kernel, wgmma + TMA (K1), {label} q [1,{hq},256,{d}] kv [1,{hkv},2048,{d}]",
         "flash_fwd_sm90.cu", "ops/flash_attention.py:57", out, p_out, o_out, lse, p_lse, o_lse,
         call=lambda: flash_attention(q, k, v, causal=True, save_residuals=True),
         plain_call=lambda: flash_attention_plain(q, k, v, causal=True, sm_scale=scale, save_residuals=True),
         lib_call=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True),
         flops=4 * d * hq * causal_pairs(256, 2048), nbytes=2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse.numel(),
         key="K1")

    # K6: the slots against the cache, ragged lengths.
    qd = torch_uniform((slots, hq, d), bf16, gen)
    lengths = torch.tensor([0, 1, 255, 256, 1000, 2047, 2048, 7][::8 // slots], dtype=torch.int32, device=dev)
    out, lse = decode_attention(qd, k_cache, v_cache, lengths, save_residuals=True)
    p_out, p_lse = decode_attention_plain(qd, k_cache, v_cache, lengths, sm_scale=scale, save_residuals=True)
    o_out, o_lse = reference_attention_with_lse(qd[:, :, None], k_cache, v_cache, kv_length=lengths)
    dmask = (torch.arange(2048, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
    rows = int(lengths.sum())
    hold(f"K6 q [{slots},{hq},{d}] cache [{slots},{hkv},2048,{d}] lengths {lengths.tolist()}",
         f"decode (K6), {label} q [{slots},{hq},{d}] cache [{slots},{hkv},2048,{d}]", "decode.cu", "ops/decode.py:56",
         out, p_out, o_out[:, :, 0], lse, p_lse, o_lse[:, :, 0],
         call=lambda: decode_attention(qd, k_cache, v_cache, lengths),
         plain_call=lambda: decode_attention_plain(qd, k_cache, v_cache, lengths, sm_scale=scale),
         lib_call=lambda: F.scaled_dot_product_attention(qd[:, :, None], k_cache, v_cache, attn_mask=dmask,
                                                          enable_gqa=True),
         flops=4 * d * hq * rows, nbytes=2 * (2 * rows * hkv * d) + 2 * (2 * qd.numel()) + 4 * lengths.numel(), key="K6")
    del k_cache, v_cache
    if "K7" not in kernels:
        return entries

    # K7 and K8 over one layer's pool [129, 2, 128, 128] through a shuffled table (slot 0 on the dump page).
    cache = _filled_cache(1, num_pages=129, num_slots=8, pages_per_slot=16, kv_heads=hkv, head_dim=d, dtype=bf16,
                          gen=gen).layers()[0]
    table = torch.from_numpy(_shuffled_table(rng, 8, 16, 129)).to(dev)
    cache.page_table.copy_(table)
    lengths = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device=dev)
    cache = cache._replace(lengths=lengths)
    k_dense, v_dense = _dense_from_pages(cache.k_pages, table), _dense_from_pages(cache.v_pages, table)
    out, lse = paged_decode_attention(qd, cache, save_residuals=True)
    p_out, p_lse = paged_decode_attention_plain(qd, cache, sm_scale=scale, save_residuals=True)
    o_out, o_lse = reference_attention_with_lse(qd[:, :, None], k_dense, v_dense, kv_length=lengths)
    rows = sum(PAGED_LENGTHS)
    hold(f"K7 q [8,{hq},{d}] pages [129,{hkv},128,{d}], lengths {list(PAGED_LENGTHS)}",
         f"paged_decode (K7), {label} q [8,{hq},{d}] pages [129,{hkv},128,{d}]", "decode.cu",
         "ops/paged.py:980", out, p_out, o_out[:, :, 0], lse, p_lse, o_lse[:, :, 0],
         call=lambda: paged_decode_attention(qd, cache, save_residuals=True),
         plain_call=lambda: paged_decode_attention_plain(qd, cache, sm_scale=scale, save_residuals=True),
         lib_call=None, flops=4 * d * hq * rows,
         nbytes=2 * (2 * rows * hkv * d) + 2 * (2 * qd.numel()) + 4 * (lse.numel() + lengths.numel()
                                                                      + sum(-(-n // 128) for n in PAGED_LENGTHS)),
         key="K7")
    qc = torch_uniform((1, hq, 256, d), bf16, gen)
    out = paged_prefill_attention(qc, cache, 7, 2048, chunk_len=256)
    p_out = paged_prefill_attention_plain(qc, cache, 7, 2048, sm_scale=scale)
    o_out, _ = reference_attention_with_lse(qc, k_dense[7:8], v_dense[7:8], causal=True)
    hold(f"K8 q [1,{hq},256,{d}] over slot 7's pages to kv_end 2048",
         f"fwd_kernel, wgmma + TMA, paged (K8), {label} q [1,{hq},256,{d}] pages [129,{hkv},128,{d}]",
         "flash_fwd_sm90.cu", "ops/paged.py:580", out, p_out, o_out,
         call=lambda: paged_prefill_attention(qc, cache, 7, 2048, chunk_len=256),
         plain_call=lambda: paged_prefill_attention_plain(qc, cache, 7, 2048, sm_scale=scale), lib_call=None,
         flops=4 * d * hq * causal_pairs(256, 2048), nbytes=2 * (2 * qc.numel() + 2 * 2048 * hkv * d) + 4 * 16, key="K8")
    return entries


def _sharded_one_rank(card: str, dense_tokens: dict, paged_tokens: dict) -> None:
    """Phase 23 (a): ``_tp_nccl_rank`` in a process of its own."""
    from flash_attention_tpu_torch.utils.distributed import spawn_ranks

    t0 = time.perf_counter()
    a = spawn_ranks(_tp_nccl_rank, 1, card, dense_tokens, paged_tokens, backend="nccl", timeout_s=600)[0]
    log(f"[sharded] (a) world size 1 over {a['backend']}, ModelConfig() bf16: dense engine (phase 5's config) tokens "
        f"== phase 5's: {a['dense equal']}, paged engine (phase 8's) tokens == phase 8's run A: {a['paged equal']}; "
        f"logits of a {TP_PREFILL}-token prefill and {TP_DECODE} decode steps bit-identical to the single-process "
        f"model's, dense: {a['dense logits bit-identical']}, paged: {a['paged logits bit-identical']}; served in {a['s']['dense']:.2f} / {a['s']['paged']:.2f} s, launches "
        f"{a['launches']}, peak {a['peak MB']:.0f} MB; (decode, prefill) program modes {a['modes']}; each engine's "
        f"save_kv_cache file is its caches bit for bit and loads into a fresh sharded engine's, dense: "
        f"{a['dense checkpoint']}, "
        f"paged: {a['paged checkpoint']}; (a) took {time.perf_counter() - t0:.1f} s ({card})")
    if not (a["dense equal"] and a["paged equal"] and a["dense logits bit-identical"]
            and a["paged logits bit-identical"] and a["dense checkpoint"] and a["paged checkpoint"]
            and a["modes"] == ["graph"] * 4):
        raise RuntimeError(f"[sharded] (a) the one-rank sharded engines differ from the single-process ones: {a}")


def _sharded_gloo(card: str, dense_tokens: dict, paged_tokens: dict) -> dict:
    """Phase 23 (b): TP_RANKS ``_tp_gloo_rank`` processes. Returns rank 0's
    launches by shard: model 2's (the dense engine's run and its logits
    run) and model 4's (the paged engine's run and its logits runs)."""
    from flash_attention_tpu_torch.models.transformer import ModelConfig
    from flash_attention_tpu_torch.utils.distributed import spawn_ranks

    t0 = time.perf_counter()
    b = spawn_ranks(_tp_gloo_rank, TP_RANKS, card, dense_tokens, paged_tokens, backend="gloo", timeout_s=900)
    r0 = b[0]
    log(f"[sharded] (b) {TP_RANKS} gloo ranks on one card, ModelConfig() bf16, dense on data 2 x model 2, paged on "
        f"model 4; (b) took {time.perf_counter() - t0:.1f} s; rank 0's peak while it held the bf16 and fp32 "
        f"references {r0['reference peak MB']:.0f} MB; (decode, prefill) program modes {r0['modes']} (a model axis "
        f"of more than one rank issues its blocks and chunks step by step)")
    if any(r["modes"] != {"dense": ("issued", "issued"), "paged": ("issued", "issued")} for r in b):
        raise RuntimeError(f"[sharded] (b) program modes {[r['modes'] for r in b]}, want issued on a model axis of "
                           f"more than one rank")
    for r in b:
        log(f"[sharded] (b) rank {r['rank']}: held {r['held MB']:.0f} MB after its build, peak {r['peak MB']:.0f} MB; "
            f"seconds {', '.join(f'{k} {v:.2f}' for k, v in r['s'].items())} (information: the ranks share the card); "
            f"launches {r['launches']} ({card})")
    (layer_rel, layer), sp = r0["layer rel"], r0["single-process vs fp32"]
    log(f"[sharded] (b) each layer's attention and MLP outputs of the tensor-parallel model (model 4) on the "
        f"single-process model's own layer inputs ({TP_PREFILL}-token prefill), row-relative to the single-process "
        f"model's: worst {layer_rel:.3e} at layer {layer} (bar {REL_BAR['bfloat16']})")
    ok_logits = layer_rel < REL_BAR["bfloat16"]
    for run, (_, path) in TP_LOGITS.items():
        got = r0["logits"][run]
        bar = TP_FP32_SLACK * sp[path]
        log(f"[sharded] (b) logits of the whole {ModelConfig().num_layers} layers ({TP_PREFILL}-token prefill, then "
            f"{TP_DECODE} decode steps), {run}: row-relative to the same weights in fp32 {got['vs fp32']:.3e} (bar "
            f"{TP_FP32_SLACK} x the single-process bf16 model's {sp[path]:.3e} on the {path} path = {bar:.3e}); to "
            f"the single-process bf16 model's {got['vs bf16']:.3e} (information); finite {got['finite']}; the same "
            f"bits on every rank: {all(r['same bits'][run] for r in b)}")
        ok_logits = (ok_logits and got["vs fp32"] <= bar and got["finite"]
                     and all(r["same bits"][run] for r in b))
    for engine, want in (("dense", dense_tokens), ("paged", paged_tokens)):
        same, parts = r0[f"{engine} agree"]
        log(f"[sharded] (b) {engine} greedy tokens against phase {5 if engine == 'dense' else 8}'s: {same} of "
            f"{sum(len(t) for t in want.values())} agree; requests that part, at step: {parts}")
    ok_tokens = all(r[e] == r0[e] for r in b for e in ("dense", "paged")) and all(
        len(t) == FULL_NEW_TOKENS for e in ("dense", "paged") for t in r0[e].values())
    if not (ok_logits and ok_tokens):
        raise RuntimeError("[sharded] (b) tensor-parallel logits or tokens out of bounds, or ranks disagree")
    counts = r0["launches"]

    def total(*runs):
        return {k: sum(counts[run].get(k, 0) for run in runs) for k in ("K1", "K6", "K7", "K8")}

    return {"model 2": total("dense", "logits model 2, dense"),
            "model 4": total("paged", "logits model 4, dense", "logits model 4, paged")}


def _sharded_jax_config(card: str) -> None:
    """Phase 23 (c): the unsharded engines on the card, then eight
    ``_tp_tiny_rank`` processes held to their tokens."""
    import dataclasses

    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params, quantize_model_weights
    from flash_attention_tpu_torch.serving.engine import Request, ServingEngine
    from flash_attention_tpu_torch.serving.paged_engine import PagedServingEngine
    from flash_attention_tpu_torch.utils.distributed import spawn_ranks

    t0 = time.perf_counter()
    cfg = ModelConfig(**JAX_TEST_CFG)
    params = _to_device(init_model_params(torch.Generator().manual_seed(0), cfg), "cuda")
    reqs = [Request(id=i, prompt=p, max_new_tokens=n) for i, (p, n) in enumerate(JAX_TEST_REQS)]
    want_dense = {rid: c.tokens for rid, c in ServingEngine(params, cfg, max_slots=4, max_seq=64).run(reqs).items()}
    want_paged = {rid: c.tokens for rid, c in PagedServingEngine(
        params, cfg, max_slots=4, num_pages=16, pages_per_slot=2, page_size=128).run(reqs).items()}
    want_w8 = {rid: c.tokens for rid, c in ServingEngine(
        quantize_model_weights(params), dataclasses.replace(cfg, weight_quant="int8"), max_slots=4,
        max_seq=64).run(reqs).items()}
    c = spawn_ranks(_tp_tiny_rank, 8, want_dense, want_paged, want_w8, backend="gloo", timeout_s=600)
    log(f"[sharded] (c) tests/test_sharded_serving.py's fp32 config on 8 gloo ranks (data 2 x model 4): dense tokens "
        f"== the unsharded engine's on the card on every rank: {all(r['dense equal'] for r in c)} (local cache "
        f"{c[0]['dense kv']}), paged: {all(r['paged equal'] for r in c)} (local pools {c[0]['paged kv']}), dense with "
        f"int8 weights (W1 on the shards): {all(r['w8 equal'] for r in c)}; tokens {want_dense}, int8 weights "
        f"{want_w8}; launches a rank {[r['launches'] for r in c]}; (c) took {time.perf_counter() - t0:.1f} s ({card})")
    if not all(r["dense equal"] and r["paged equal"] and r["w8 equal"] for r in c):
        raise RuntimeError("[sharded] (c) a rank's tokens differ from the unsharded engine's")


def phase_sharded_serving(card: str, dense_tokens: dict, paged_tokens: dict) -> list:
    """Phase 23: tensor-parallel serving. ``dense_tokens`` / ``paged_tokens``:
    phases 5's and 8's main-path tokens of phase 5's requests (ids 100..109).
    (a) one NCCL rank, (b) TP_RANKS gloo ranks sharing the card, (c) the
    JAX package's test config on eight gloo ranks, (d) the kernels at the
    model-2 and model-4 shards' shapes; the wall time of each. Returns (d)'s
    entries."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    _sharded_one_rank(card, dense_tokens, paged_tokens)
    launches = _sharded_gloo(card, dense_tokens, paged_tokens)
    _sharded_jax_config(card)
    t0 = time.perf_counter()
    entries = _shard_kernels(card, launches)
    log(f"[sharded] (d) took {time.perf_counter() - t0:.1f} s; phase 23 took {time.perf_counter() - t_phase:.1f} s "
        f"({card})")
    return entries


# Phase 24: warmup, the profiler and the launch floor.
FIRST_RUN_TAG = "FIRST_RUN "  # the line a first-run child prints its numbers on
DENSE_ENGINE_BLOCK = 16  # the engines' default decode_block_steps
PROFILE_ROWS = 1024  # PERF.md section 5's decode shape: 8 slots at ~1,024 rows


def first_run_child(warm: bool) -> None:
    """Phase 24(a), in a fresh process that imports only the port:
    ModelConfig() in bf16 from phase 5's seed serves phase 5's 10 requests on
    8 slots x 2048 (the engine's first run), after ``warmup()`` when
    ``warm``. Prints one line, FIRST_RUN_TAG + JSON: the warmup's and the
    run's wall seconds, the run's first prefill chunk's (synchronised
    around it) and the launches it counted, the launch counts of the
    warmup and the run, the run's decode section and tokens, the counters
    just after warmup, and the prefill and decode programs built before the
    run and built and replayed in it."""
    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params
    from flash_attention_tpu_torch.serving.engine import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False  # as phase_device sets it
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig()
    params = init_model_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    eng = ServingEngine(params, cfg, max_slots=8, max_seq=2048, prefill_chunk=256)
    out = {"warm": warm}
    chunk_step = eng._prefill_chunk_step

    def first_chunk_timed(*args):
        # The run's first prefill chunk, timed alone: where first-use costs land.
        eng._prefill_chunk_step = chunk_step
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = chunk_step(*args)
        torch.cuda.synchronize()
        out["first_chunk_s"] = time.perf_counter() - t0
        out["first_chunk_launches"] = {k: n - before[k] for k, n in read_counts().items() if n != before[k]}
        return result

    if warm:
        zero_counts()
        torch.cuda.synchronize()
        allocated, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        eng.warmup()
        torch.cuda.synchronize()
        out["warmup_s"] = time.perf_counter() - t0
        out["warmup_launches"] = read_counts()
        out["counters"] = [eng.steps, eng.decode_tokens, eng.decode_time_s, len(eng.events)]
        out["pool_bytes"] = [torch.cuda.memory_allocated() - allocated, torch.cuda.memory_reserved() - reserved]
        out["capture_s"] = {f"k={k}{' greedy' if g else ' sampled'}": t for (k, g), t in eng.programs.capture_s.items()}
        out["prefill_capture_s"] = {f"{t},{kv_end}": s for (t, kv_end), s in eng.prefill_programs.capture_s.items()}
    pre = eng.prefill_programs
    out["captures_before"], replays = eng.programs.captures, eng.programs.replays
    out["prefill_captures_before"], prefill_replays = pre.captures, pre.replays
    eng._prefill_chunk_step = first_chunk_timed
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(_full_requests(cfg))
    torch.cuda.synchronize()
    out.update(run_s=time.perf_counter() - t0, launches=read_counts(), decode_tokens=eng.decode_tokens,
               decode_s=eng.decode_time_s, tokens={rid: c.tokens for rid, c in done.items()},
               captures=eng.programs.captures - out["captures_before"], replays=eng.programs.replays - replays,
               blocks=sum(1 for event in eng.events if event[0] == "decode"), mode=eng.programs.mode,
               prefill_captures=pre.captures - out["prefill_captures_before"],
               prefill_replays=pre.replays - prefill_replays, prefill_mode=pre.mode,
               chunks=sum(1 for event in eng.events if event[0] == "chunk"))
    print(FIRST_RUN_TAG + json.dumps(out), flush=True)


def _first_run(warm: bool) -> dict:
    """``first_run_child(warm)`` in a fresh interpreter; its output echoed,
    its numbers returned (token ids as ints)."""
    import os
    import sys

    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-c", f"import chip_smoke; chip_smoke.first_run_child({warm})"],
                          cwd=root, capture_output=True, text=True, timeout=600)
    lines = proc.stdout.splitlines()
    for line in lines:
        if not line.startswith(FIRST_RUN_TAG):
            log(f"  [first run] {line}")
    if proc.returncode or not lines or not lines[-1].startswith(FIRST_RUN_TAG):
        raise RuntimeError(f"[first run] child (warm={warm}) exited {proc.returncode}: {proc.stderr[-4000:]}")
    out = json.loads(lines[-1][len(FIRST_RUN_TAG):])
    out["tokens"] = {int(rid): toks for rid, toks in out["tokens"].items()}
    return out


def _first_runs(card: str, dense_tokens: dict) -> None:
    """Phase 24(a): the cold and the warm process (``first_run_child``); both
    runs give phase 5's tokens and launch only K1 and K6, the warmup too,
    and the warm engine's counters are zero after its warmup."""
    n_prompt = sum(FULL_PROMPT_LENS)
    runs = {warm: _first_run(warm) for warm in (False, True)}
    warm = runs[True]
    if warm["counters"] != [0, 0, 0.0, 0]:
        raise RuntimeError(f"[first run] counters after warmup (steps, decode tokens, decode s, events): "
                           f"{warm['counters']}, want zeros")
    keys = 2 * (DENSE_ENGINE_BLOCK.bit_length())  # greedy and sampled at k = B, B/2, ..., 1
    if (warm["mode"], warm["captures_before"], warm["captures"], warm["replays"]) != ("graph", keys, 0, warm["blocks"]):
        raise RuntimeError(f"[first run] the warm engine's programs: mode {warm['mode']}, {warm['captures_before']} "
                           f"built by warmup() (want {keys}), {warm['captures']} captured by the run (want 0), "
                           f"{warm['replays']} replays for {warm['blocks']} blocks")
    chunk_keys = DENSE_ENGINE["max_seq"] // DENSE_ENGINE["prefill_chunk"]  # (256, 256), (256, 512), ..., (256, 2048)
    got = (warm["prefill_mode"], warm["prefill_captures_before"], warm["prefill_captures"], warm["prefill_replays"])
    if got != ("graph", chunk_keys, 0, warm["chunks"]):
        raise RuntimeError(f"[first run] the warm engine's prefill programs (mode, built by warmup(), captured by the "
                           f"run, replays): {got}, want ('graph', {chunk_keys}, 0, {warm['chunks']}): one replay a "
                           f"chunk")
    check_launches("[first run] warmup", warm["warmup_launches"], ("K1", "K6", *SERVED))
    for key, run in runs.items():
        label = "warm" if key else "cold"
        check_launches(f"[first run] {label} run", run["launches"], ("K1", "K6", *SERVED))
        if run["tokens"] != dense_tokens:
            parted = sorted(rid for rid in dense_tokens if run["tokens"].get(rid) != dense_tokens[rid])
            raise RuntimeError(f"[first run] the {label} run's tokens differ from phase 5's for requests {parted}")
        outside = run["run_s"] - run["decode_s"]
        log(f"[first run] {label}{' (after warmup())' if key else ''}: phase 5's 10 requests in {run['run_s']:.3f} s "
            f"wall; prefill {n_prompt} prompt tokens in {outside:.3f} s outside the decode section = "
            f"{n_prompt / outside:.1f} tok/s; decode {run['decode_tokens']} tokens in {run['decode_s']:.3f} s = "
            f"{run['decode_tokens'] / run['decode_s']:.1f} tok/s; its first prefill chunk alone "
            f"{run['first_chunk_s'] * 1e3:.1f} ms, counting the launches {run['first_chunk_launches']}; launches K1 "
            f"{run['launches']['K1']}, K6 {run['launches']['K6']}; prefill programs built before the run "
            f"{run['prefill_captures_before']}, captured in it {run['prefill_captures']}, replayed "
            f"{run['prefill_replays']} for {run['chunks']} chunks ({card})")
    log(f"[first run] warmup() took {warm['warmup_s']:.3f} s (K1 {warm['warmup_launches']['K1']}, K6 "
        f"{warm['warmup_launches']['K6']} launches); counters zero after it; cold and warm tokens == phase 5's "
        f"({card})")
    capture_s = ", ".join(f"{key} {t:.3f}" for key, t in warm["capture_s"].items())
    prefill_s = ", ".join(f"({key}) {t:.3f}" for key, t in warm["prefill_capture_s"].items())
    log(f"[first run] warmup() built {keys} decode programs (CUDA graphs), the warm run captured none and replayed "
        f"{warm['replays']} blocks (the cold run captured {runs[False]['captures']}); capture seconds by key: "
        f"{capture_s}; and {chunk_keys} prefill programs, capture seconds by (T, kv_end): {prefill_s}; the graphs' "
        f"pool: memory_allocated {warm['pool_bytes'][0] / 2**20:.1f} MiB more after warmup() than before, "
        f"memory_reserved {warm['pool_bytes'][1] / 2**20:.1f} MiB ({card})")


def _paged_warmup(card: str, params, cfg, paged_tokens: dict) -> None:
    """Phase 24(b): phase 8's PagedServingEngine (prefix cache on) serves
    phase 8's run A (phase 8's tokens), then ``warmup()``: it launches K7,
    K8 and K9/K10 only, and leaves the free page count, the prefix table,
    the prefix cache switch and the counters as a served run would find
    them."""
    import copy

    import torch

    from flash_attention_tpu_torch.serving.paged_engine import PagedServingEngine

    eng = PagedServingEngine(params, cfg, max_slots=8, num_pages=129, pages_per_slot=16, page_size=128,
                             prefill_chunk=256, prefix_cache=True)
    got = {rid: c.tokens for rid, c in eng.run(_full_requests(cfg)).items()}
    if got != paged_tokens:
        raise RuntimeError("[paged warmup] run A's tokens differ from phase 8's")
    free, table = eng.alloc.free_count, copy.deepcopy(eng._prefix)
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counts()
    check_launches("[paged warmup] warmup", launches, ("K7", "K8", "K9/K10", *SERVED))
    counters = (eng.steps, eng.decode_tokens, eng.decode_time_s, len(eng.events))
    keys = {(1 << i, greedy) for i in range(eng.decode_block_steps.bit_length()) for greedy in (True, False)}
    if eng.programs.built() != keys:
        raise RuntimeError(f"[paged warmup] programs built after warmup(): {sorted(eng.programs.built())}, want "
                           f"{sorted(keys)}")
    if (eng.alloc.free_count, eng._prefix, eng.prefix_cache_enabled, counters) != (free, table, True, (0, 0, 0.0, 0)):
        raise RuntimeError(f"[paged warmup] free pages {free} -> {eng.alloc.free_count}, prefix table "
                           f"{'kept' if eng._prefix == table else 'changed'}, prefix cache "
                           f"{eng.prefix_cache_enabled}, counters {counters}")
    log(f"[paged warmup] phase 8's engine after run A (its tokens == phase 8's): warmup() {secs:.3f} s, launches K7 "
        f"{launches['K7']}, K8 {launches['K8']}, K9/K10 {launches['K9/K10']}; free pages {free} and the prefix table "
        f"({len(table)} pages) unchanged, prefix cache on, counters zero; every (k, greedy) program built "
        f"({len(keys)}) ({card})")


def _sampling_inputs(position: int) -> dict:
    """Phase 5's sampling parameters of 8 slots (temperature > 0, top-k,
    top-p, seeds at the edges of int32) as CPU tensors, every slot's token
    at ``position``."""
    import torch

    return dict(
        temperature=torch.tensor([0.7, 1.0, 1.3, 0.5, 1.0, 2.0, 0.9, 1.0]),
        top_k=torch.tensor([0, 40, 0, 5, 1000, 0, 50, 0], dtype=torch.int32),
        top_p=torch.tensor([1.0, 1.0, 0.9, 0.95, 0.8, 1.0, 0.5, 0.99]),
        seeds=torch.tensor([0, 1, 7, 12345, 2**31 - 1, -1, -2**31, 99], dtype=torch.int32),
        positions=torch.full((8,), position, dtype=torch.int32))


def _log_profile(card: str, what: str, prof: dict, untraced_s: float) -> None:
    """``profile_op``'s summary, beside ``untraced_s``, the same call's
    seconds with no profiler on (``time_fn``): what the trace costs, and
    the busy share the traced device time gives over the untraced wall."""
    top = "; ".join(f"{op['name'][:70]} x{op['count']:g} {op['device_s_per_call'] * 1e3:.4f} ms"
                    for op in prof["device_ops"][:5])
    device_s = sum(op["device_s_per_call"] for op in prof["device_ops"])
    wall = prof["wall_s_per_call"]
    busy_s = prof["device_busy_share"] * wall
    log(f"[profile] {what}: traced wall {wall * 1e3:.3f} ms a call, device busy share {prof['device_busy_share']:.4f} "
        f"({busy_s * 1e3:.3f} ms busy), device ops {sum(op['count'] for op in prof['device_ops']):g} a call summing "
        f"{device_s * 1e3:.3f} ms; untraced {untraced_s * 1e3:.3f} ms a call (the trace adds "
        f"{(wall - untraced_s) * 1e3:.3f} ms), busy over it {busy_s / untraced_s:.4f}; peak "
        f"{prof['memory_analysis']['peak_bytes'] / 2**30:.3f} GiB over the arguments' "
        f"{prof['memory_analysis']['argument_bytes'] / 2**30:.3f} GiB ({card})")
    log(f"[profile] {what}, top five device ops: {top}")


# A replayed greedy decode step at 8 slots (ModelConfig(), 32 layers): at most this many device operations
# (dense), and at most this many ``direct_copy`` kernels (paged), once the glue is the fused kernels.
STEP_OPS_BAR = 800
STEP_COPY_BAR = 32
# A replayed sampled step runs at most this many device operations more than a greedy one: S1 and the position's
# add where the greedy step runs argmax and its cast.
SAMPLER_OPS_BAR = 8


def _glue_left(card: str, what: str, sampled: dict, greedy: dict) -> None:
    """What a replayed step runs beside the kernels, from ``profile_op``'s
    one-block traces of the k = DENSE_ENGINE_BLOCK sampled and greedy
    programs: device operations and ``direct_copy`` kernels a step, and every
    operation type of the greedy step by name. The greedy step must stay
    within STEP_OPS_BAR operations (dense) and STEP_COPY_BAR copies (paged),
    and the sampled one within SAMPLER_OPS_BAR operations of the greedy one
    (both engines)."""
    def per_step(prof):
        ops = {op["name"]: op["count"] / DENSE_ENGINE_BLOCK for op in prof["device_ops"]}
        return ops, sum(ops.values()), sum(n for name, n in ops.items() if "direct_copy" in name)

    ops, total, copies = per_step(greedy)
    _, s_total, s_copies = per_step(sampled)
    names = "; ".join(f"{name[:90]} x{n:g}" for name, n in sorted(ops.items(), key=lambda kv: -kv[1]))
    log(f"[profile] {what} replayed step, greedy: {total:g} device operations, {copies:g} direct_copy (sampled: "
        f"{s_total:g} and {s_copies:g}, the sampler's included) ({card})")
    log(f"[profile] {what} replayed greedy step, every device operation a step: {names}")
    if (what == "dense" and total > STEP_OPS_BAR) or (what == "paged" and copies > STEP_COPY_BAR):
        raise RuntimeError(f"[profile] {what} replayed greedy step: {total:g} device operations (bar {STEP_OPS_BAR} "
                           f"dense), {copies:g} direct_copy (bar {STEP_COPY_BAR} paged)")
    if s_total - total > SAMPLER_OPS_BAR:
        raise RuntimeError(f"[profile] {what} replayed sampled step: {s_total - total:g} device operations more than a "
                           f"greedy one (bar {SAMPLER_OPS_BAR})")


def _profiles(card: str, params, cfg) -> None:
    """Phase 24(c): ``utils/profiling.profile_op`` (3 warm-up and 10 timed
    calls, a private device-only trace) over one decode step plus the sampler
    at 8 slots x PROFILE_ROWS rows on the dense and on the paged cache, and
    (through ``trace`` into a temporary directory, host level 2; 1 + 3 calls)
    one forward + backward of phase 14's training step at B=1, T=2048 with
    no update; each also untraced through ``time_fn`` (3 runs of 10 decode
    steps, 2 runs of 3 training steps), the least run kept. Inputs are left
    unchanged between calls: a decode step writes the same row each time
    and its new lengths are dropped."""
    import os
    import tempfile

    import numpy as np
    import torch

    from flash_attention_tpu_torch.models.transformer import (
        decode_step_logits,
        decode_step_logits_paged,
        init_caches,
        init_paged_caches,
        train_forward,
    )
    from flash_attention_tpu_torch.serving.engine import ServingEngine
    from flash_attention_tpu_torch.serving.paged_engine import PagedServingEngine
    from flash_attention_tpu_torch.serving.sampling import sample_tokens
    from flash_attention_tpu_torch.utils.benchmarking import time_fn
    from flash_attention_tpu_torch.utils.profiling import profile_op

    slots = 8
    sampling = {key: t.cuda() for key, t in _sampling_inputs(PROFILE_ROWS + 1).items()}
    tok = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (slots, 1))).to("cuda", torch.int32)
    lengths = torch.full((slots,), PROFILE_ROWS, dtype=torch.int32, device="cuda")
    caches = [c._replace(lengths=lengths) for c in init_caches(cfg, slots, 2048, device="cuda")]
    paged = init_paged_caches(cfg, num_pages=129, num_slots=slots, pages_per_slot=16, page_size=128)
    paged.page_table.copy_(1 + torch.arange(slots * 16, dtype=torch.int32, device="cuda").view(slots, 16))
    paged = paged._replace(lengths=lengths)

    def step(decode, params, tok, cache, sampling):
        with torch.no_grad():
            return sample_tokens(decode(params, cfg, tok, cache)[0], **sampling)

    for what, decode, cache in (("dense decode step + sampler", decode_step_logits, caches),
                                ("paged decode step + sampler", decode_step_logits_paged, paged)):
        zero_counts()
        prof = profile_op(step, decode, params, tok, cache, sampling)
        launches = {k: n for k, n in read_counts().items() if n}
        untraced = min(time_fn(step, decode, params, tok, cache, sampling, warmup=1, iters=10, runs=3))
        _log_profile(card, f"{what}, {slots} slots x {PROFILE_ROWS} rows", prof, untraced)
        log(f"[profile] {what}: kernel launches in profile_op's 14 calls {launches}")
    del caches, paged
    torch.cuda.empty_cache()

    # The same steps as a replayed decode block: the engine's k=16 sampled program, every slot active at
    # PROFILE_ROWS rows (reset before each block), the paged table the straight one above.
    rows = {key: t.numpy() for key, t in _sampling_inputs(0).items()}
    for what, make in (("dense", lambda: ServingEngine(params, cfg, max_slots=slots, max_seq=2048)),
                       ("paged", lambda: PagedServingEngine(params, cfg, max_slots=slots, num_pages=129,
                                                            pages_per_slot=16, page_size=128))):
        eng = make()
        if what == "paged":
            eng.caches.page_table.copy_(1 + torch.arange(slots * 16, dtype=torch.int32, device="cuda").view(slots, 16))
        lengths = eng._lengths_of(eng.caches)
        eng.programs.upload(tok[:, 0].cpu().numpy(), np.ones(slots, bool), rows["temperature"], rows["top_k"],
                            rows["top_p"], rows["seeds"])

        def block(eng=eng, lengths=lengths):
            lengths.fill_(PROFILE_ROWS)
            return eng.programs.run(DENSE_ENGINE_BLOCK, False)

        def greedy(eng=eng, lengths=lengths):
            lengths.fill_(PROFILE_ROWS)
            return eng.programs.run(DENSE_ENGINE_BLOCK, True)

        # One timed block of each key: the profiler's reading of each device
        # operation costs host time.
        zero_counts()
        prof = profile_op(block, warmup=2, iters=1)
        launches = {k: n for k, n in read_counts().items() if n}
        _, traced, attempts = traced_launches(f"[profile] {what} replayed block", block)
        untraced = min(time_fn(block, warmup=1, iters=3, runs=2))
        label = f"{what} decode block, {DENSE_ENGINE_BLOCK} steps + sampler, replayed, {slots} slots x {PROFILE_ROWS} rows"
        _log_profile(card, label, prof, untraced)
        log(f"[profile] {label}: {untraced * 1e3 / DENSE_ENGINE_BLOCK:.3f} ms a step untraced; {eng.programs.captures} "
            f"capture ({eng.programs.capture_s[DENSE_ENGINE_BLOCK, False]:.3f} s), {eng.programs.replays} replays; "
            f"kernel launches in profile_op's 4 blocks (2 warm-up, 1 timed, 1 for memory) {launches}; a replay's "
            f"kernel records in its device trace == the launches it counted, {traced} (traces taken {attempts}) "
            f"({card})")
        _glue_left(card, what, prof, profile_op(greedy, warmup=2, iters=1))
        del eng, lengths, block, greedy
        torch.cuda.empty_cache()

    leaves = _tensors(params)
    for t in leaves:
        t.requires_grad_()
    tokens = torch.from_numpy(np.random.default_rng(14).integers(0, cfg.vocab_size, (1, TRAIN_TOKENS + 1))).cuda()

    def train_step(params, tokens):
        for t in leaves:
            t.grad = None
        loss = _lm_loss(train_forward(params, cfg, tokens[:, :-1]), tokens[:, 1:])
        loss.backward()
        return loss.detach()

    with tempfile.TemporaryDirectory() as tmp:
        prof = profile_op(train_step, params, tokens, warmup=1, iters=3, log_dir=tmp)
        (trace_file,) = os.listdir(tmp)
        trace_mb = os.path.getsize(os.path.join(tmp, trace_file)) / 1e6
    untraced = min(time_fn(train_step, params, tokens, warmup=0, iters=3, runs=2))
    for t in leaves:
        t.grad = None
        t.requires_grad_(False)
    _log_profile(card, f"training step forward + backward, B=1, T={TRAIN_TOKENS}", prof, untraced)
    log(f"[profile] training step: trace() wrote a {trace_mb:.1f} MB Chrome trace (host level 2)")


def profiles_child(card: str) -> None:
    """Phase 24(c) in a fresh process: ``_profiles`` on ModelConfig() in bf16
    from phase 5's seed."""
    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params

    torch.backends.cuda.matmul.allow_tf32 = False  # as phase_device sets it
    torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig()
    _profiles(card, init_model_params(torch.Generator(device="cuda").manual_seed(0), cfg), cfg)


def _profiles_fresh(card: str) -> None:
    """``profiles_child`` in a fresh interpreter, its output echoed. Its traces
    need a process that has traced little: late in this script's process
    CUPTI lost records of a replayed block in every trace (PR 17 runs 4 and 5:
    6-11 of its ~2,576 registered launches, the same numbers five times),
    where the same profiles after only phases 5 and 8 traced complete (run 7)."""
    import os
    import sys

    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-c", f"import chip_smoke; chip_smoke.profiles_child({card!r})"],
                          cwd=root, capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines():
        log(line)
    if proc.returncode:
        raise RuntimeError(f"[profile] child exited {proc.returncode}: {proc.stderr[-4000:]}")


def phase_warmup_profiles(card: str, dense_tokens: dict, paged_tokens: dict) -> None:
    """Phase 24: (a) cold and warm first runs in fresh processes, (b) the
    paged engine's warmup, (c) profiles of the decode and training steps,
    (d) ``calibrate_overhead_s``."""
    import gc

    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig, init_model_params
    from flash_attention_tpu_torch.utils.benchmarking import calibrate_overhead_s

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    _first_runs(card, dense_tokens)
    log(f"[warmup] (a) took {time.perf_counter() - t_phase:.1f} s")
    cfg = ModelConfig()
    params = init_model_params(torch.Generator(device="cuda").manual_seed(0), cfg)
    _paged_warmup(card, params, cfg, paged_tokens)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[warmup] (a) and (b) took {time.perf_counter() - t_phase:.1f} s")
    _profiles_fresh(card)
    log(f"[overhead] calibrate_overhead_s(): {calibrate_overhead_s() * 1e6:.2f} us a trivial launch ([8, 128] fp32 "
        f"x + 1.0 through time_fn, the least of 3 runs of 5) ({card})")
    log(f"[warmup] phase 24 took {time.perf_counter() - t_phase:.1f} s ({card})")


FUSED_POSITIONS = (0, 1, 8191, 70000, 1024, 2047, 2048, 5000)  # phase 25's decode positions, one a slot


def _ordered(x):
    """x's bits as integers ordered like the values (for ulp distances)."""
    import torch

    width = {2: (torch.int16, 0xFFFF, 0x8000, 0x7FFF), 4: (torch.int32, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF)}
    view, full, sign, mag = width[x.element_size()]
    u = x.contiguous().view(view).to(torch.int64) & full
    return torch.where((u & sign) != 0, -(u & mag), u & mag)


def _ulp_report(a, b) -> tuple[int, float]:
    """(the most units in the last place a and b differ by, the share of
    elements that differ)."""
    d = (_ordered(a) - _ordered(b)).abs()
    return int(d.max()) if d.numel() else 0, float((d > 0).float().mean()) if d.numel() else 0.0


def _three_times(call, calls: int = 10) -> tuple[float, float, float]:
    """``call`` timed as a wrapper call (CUDA events), alone in a CUDA graph
    of ``calls`` calls replayed, and as the wrapper's host µs a call (200
    calls enqueued unsynchronised): (ms, graph ms, host µs)."""
    import torch

    ms = cuda_ms(call)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            call()
    alone = cuda_ms(graph.replay) / calls
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        call()
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    return ms, alone, host_us


def _fused_row(card: str, key: str, name: str, source: str, replaces: str, call, plain, nbytes: float, *, err: float,
               library=None) -> dict:
    """A phase-25 kernel's line: timed beside its plain version (and the
    library call), against its bound (bytes over 3.35 TB/s)."""
    ms, alone, host_us = _three_times(call)
    plain_ms = cuda_ms(plain)
    lib_ms = None if library is None else cuda_ms(library)
    bound_ms, bound_by = bound(0.0, nbytes)
    log(f"[fused] {key} {name}: kernel {ms:.4f} ms as a call, {alone:.4f} ms alone in a CUDA graph, host {host_us:.1f} "
        f"us a call; plain {plain_ms:.4f} ms; library {'none' if lib_ms is None else f'{lib_ms:.4f} ms'}; bound "
        f"{bound_ms:.5f} ms ({bound_by}, {nbytes / 1e6:.3f} MB) ({card})")
    return {"name": f"{name} ({key})", "route": "cuda", "source": source, "replaces": f"{REFERENCE}/{replaces}",
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}


def _timed_line(card: str, key: str, name: str, call, plain, nbytes: float) -> None:
    """A kernel timed as ``_fused_row`` times it, printed, not reported."""
    ms, alone, host_us = _three_times(call)
    plain_ms = cuda_ms(plain)
    bound_ms, bound_by = bound(0.0, nbytes)
    log(f"[fused] {key} {name}: kernel {ms:.4f} ms as a call, {alone:.4f} ms alone in a CUDA graph, host "
        f"{host_us:.1f} us a call; plain {plain_ms:.4f} ms; bound {bound_ms:.5f} ms ({bound_by}, {nbytes / 1e6:.3f} "
        f"MB) ({card})")


def _fused_norm_act(card: str, gen) -> dict:
    """F1 and F3 in the three dtypes against their plain versions on the
    card: F1's x_new bit-identical and h within 1 ulp in 16 bits (1e-6 of
    the row's largest in fp32), F3 within 1 ulp; the share of elements that
    differ printed."""
    import torch
    import torch.nn.functional as F

    from flash_attention_tpu_torch.ops.fused import add_rms_norm, add_rms_norm_plain, swiglu_act, swiglu_act_plain

    rows = {}
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for shape in ((8, 1, 4096), (1, 256, 4096), (8, 1, 256)):
            x, delta = (torch_uniform(shape, dtype, gen) * 4 for _ in range(2))
            weight = 1 + torch_uniform(shape[-1:], dtype, gen)
            for d in (delta, None):
                x_new, h = add_rms_norm(x, d, weight, 1e-5)
                p_new, p_h = add_rms_norm_plain(x, d, weight, 1e-5)
                ulps, share = _ulp_report(h, p_h)
                rel = _rel_diff(h, p_h)
                if not _bits_equal(x_new, p_new) or (ulps > 1 if dtype != torch.float32 else rel > 1e-6):
                    raise RuntimeError(f"[fused] F1 {dtype} {shape} delta={d is not None}: x_new equal "
                                       f"{_bits_equal(x_new, p_new)}, h {ulps} ulp, row-relative {rel:.3e}")
                rows.setdefault("F1", []).append((str(dtype)[6:], shape, ulps, share))
        for width in (11008, 14336):
            gate, up = (torch_uniform((8, 1, width), dtype, gen) * 8 for _ in range(2))
            ulps, share = _ulp_report(swiglu_act(gate, up), swiglu_act_plain(gate, up))
            if ulps > 1:
                raise RuntimeError(f"[fused] F3 {dtype} width {width}: {ulps} ulp from plain")
            rows.setdefault("F3", []).append((str(dtype)[6:], width, ulps, share))
    for key, cases in rows.items():
        log(f"[fused] {key} against plain on the card, (dtype, shape, ulps, share of elements that differ): {cases}")

    x, delta = (torch_uniform((8, 1, 4096), torch.bfloat16, gen) * 4 for _ in range(2))
    weight = 1 + torch_uniform((4096,), torch.bfloat16, gen)
    x_new = x + delta
    f1 = _fused_row(card, "F1", "add_rms_norm_kernel, residual add + RMSNorm, [8,1,4096] bf16", "csrc/fused.cu",
                    "models/transformer.py:86", lambda: add_rms_norm(x, delta, weight, 1e-5),
                    lambda: add_rms_norm_plain(x, delta, weight, 1e-5), (4 * x.numel() + 4096) * 2,
                    err=float((add_rms_norm(x, delta, weight, 1e-5)[1].float()
                               - add_rms_norm_plain(x, delta, weight, 1e-5)[1].float()).abs().max()),
                    library=lambda: F.rms_norm(x_new, (4096,), weight, 1e-5))
    out = {"F1": f1}
    for width, label in ((11008, "F3"), (14336, "F3m")):
        gate, up = (torch_uniform((8, 1, width), torch.bfloat16, gen) * 8 for _ in range(2))
        out[label] = _fused_row(
            card, label, f"swiglu_act_kernel, silu(gate) * up, [8,1,{width}] bf16", "csrc/fused.cu",
            "models/transformer.py:103", lambda: swiglu_act(gate, up), lambda: swiglu_act_plain(gate, up),
            3 * gate.numel() * 2,
            err=float((swiglu_act(gate, up).float() - swiglu_act_plain(gate, up).float()).abs().max()))
    # At a prefill chunk's rows: F1 runs twice a layer and once at the final norm, F3 once a layer.
    x, delta = (torch_uniform((1, CHUNK_T, 4096), torch.bfloat16, gen) * 4 for _ in range(2))
    _timed_line(card, "F1", "add_rms_norm_kernel at a chunk's rows, [1,256,4096] bf16",
                lambda: add_rms_norm(x, delta, weight, 1e-5), lambda: add_rms_norm_plain(x, delta, weight, 1e-5),
                (4 * x.numel() + 4096) * 2)
    for width in (11008, 14336):
        gate, up = (torch_uniform((1, CHUNK_T, width), torch.bfloat16, gen) * 8 for _ in range(2))
        _timed_line(card, "F3", f"swiglu_act_kernel at a chunk's rows, [1,256,{width}] bf16",
                    lambda: swiglu_act(gate, up), lambda: swiglu_act_plain(gate, up), 3 * gate.numel() * 2)
    return out


def _rope_cache(kind: str, dtype, gen):
    """A dense [8, 8, rows, 128] KVCache of phase 25's kind, filled, with
    (ring, sinks) for the write."""
    import torch

    from flash_attention_tpu_torch.models.attention import KVCache
    from flash_attention_tpu_torch.ops.quant import PAYLOADS, quantize_values

    rows = {"dense": 2048, "rolling": RING_ROWS, "rolling + sinks": RING_ROWS + 128}.get(kind, 2048)
    ring, sinks = kind.startswith("rolling"), SINKS if kind == "rolling + sinks" else 0
    shape = (8, 8, rows, 128)
    if kind in PAYLOADS:
        bufs = []
        for _ in range(2):
            qt = quantize_values(scaled_rows(shape, gen), PAYLOADS[kind])
            bufs += [qt.values, qt.scales]
        cache = KVCache(bufs[0], bufs[2], torch.zeros(8, dtype=torch.int32, device="cuda"), bufs[1], bufs[3])
    else:
        cache = KVCache(torch_uniform(shape, dtype, gen), torch_uniform(shape, dtype, gen),
                        torch.zeros(8, dtype=torch.int32, device="cuda"))
    return cache, ring, sinks


def _clone_cache(cache):
    return type(cache)(*(None if t is None else t.clone() for t in cache))


def _fused_rope(card: str, gen) -> dict:
    """F2 in the three dtypes: q / k rotated at FUSED_POSITIONS (decode, q a
    strided view as the projection gives it) and over a 256-row chunk from
    position 70000, and the row write into every cache kind (a slot at
    capacity; the 4352-row ring; the ring with 4 sinks; int8, e4m3 and e5m2
    payloads with their scales), each against the plain version on the
    card: the rotated rows, every cache tensor (payload and scales) and the
    lengths bit-identical."""
    import torch

    from flash_attention_tpu_torch.ops.fused import rope, rope_plain

    positions = torch.tensor(FUSED_POSITIONS, dtype=torch.int32, device="cuda")[:, None, None]
    kinds = ("dense", "rolling", "rolling + sinks", "int8", "fp8_e4m3", "fp8_e5m2")
    done = []
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        q = torch_uniform((8, 1, 32, 128), dtype, gen).transpose(1, 2)  # [8, 32, 1, 128], the projection's view
        k, v = (torch_uniform((8, 1, 8, 128), dtype, gen).transpose(1, 2) for _ in range(2))
        got, want = rope(q, k, positions), rope_plain(q, k, positions)
        qc, kc = torch_uniform((1, 32, 256, 128), dtype, gen), torch_uniform((1, 8, 256, 128), dtype, gen)
        chunk_pos = 70000 + torch.arange(256, device="cuda")[None, None, :]
        got, want = got + rope(qc, kc, chunk_pos), want + rope_plain(qc, kc, chunk_pos)
        if not all(_bits_equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError(f"[fused] F2 {dtype}: rotated q / k differ from plain")
        for kind in kinds:
            cache, ring, sinks = _rope_cache(kind, dtype, gen)
            full = cache.k.shape[2]
            pos = positions if ring else torch.where(positions == 5000, full, positions.clamp(max=full - 1))
            pos = pos.clone()
            pos[7] = full if not ring else pos[7]  # a slot at capacity: its write is dropped
            a, b = _clone_cache(cache), _clone_cache(cache)
            qa, ka, a = rope(q, k, pos, cache=a, v=v, ring=ring, sinks=sinks)
            qb, kb, b = rope_plain(q, k, pos, cache=b, v=v, ring=ring, sinks=sinks)
            same = [_bits_equal(x, y) for x, y in zip((qa, ka, *a), (qb, kb, *b)) if x is not None]
            if not all(same):
                raise RuntimeError(f"[fused] F2 {dtype} {kind}: q, k, cache K, V, lengths(, scales) equal to plain "
                                   f"{same}")
            done.append(f"{str(dtype)[6:]} {kind}")
    log(f"[fused] F2 rotated rows (decode at {FUSED_POSITIONS}, a 256-row chunk from 70000) and the row write, "
        f"bit-identical to plain on the card, payload, scales and lengths included: {done}")

    dtype = torch.bfloat16
    q = torch_uniform((8, 1, 32, 128), dtype, gen).transpose(1, 2)
    k, v = (torch_uniform((8, 1, 8, 128), dtype, gen).transpose(1, 2) for _ in range(2))
    cache, _, _ = _rope_cache("dense", dtype, gen)
    lengths = torch.full((8, 1, 1), PROFILE_ROWS, dtype=torch.int32, device="cuda")
    nbytes = (2 * 32 + 2 * 8 + 8 + 2 * 8) * 128 * 8 * 2 + 8 * 8  # q, k read + written, v read, K / V rows, lengths
    row = _fused_row(card, "F2", "rope_kernel, RoPE + the dense row write, q [8,32,1,128] bf16", "csrc/fused.cu",
                     "models/rope.py:19", lambda: rope(q, k, lengths, cache=cache, v=v),
                     lambda: rope_plain(q, k, lengths, cache=cache, v=v), nbytes, err=0.0)
    return {"F2": row}


CHUNK_T = 256  # the served phases' prefill chunk
# Phase 25's chunk-form caches: (rows a slot or page size, the chunk's start, ring, sinks, kv_quant, paged). The
# ring kinds start where the chunk wraps the ring's end (4352 rows; with 4 sinks, 128 sink rows before a ring of
# 4352); "ring + sinks from 0" straddles the sinks; the paged ring lays its table out as phase 17c's engine does.
CHUNK_KINDS = {
    "dense": (2048, 1792, False, 0, "none", False),
    "int8": (2048, 1024, False, 0, "int8", False),
    "fp8_e4m3": (2048, 256, False, 0, "fp8_e4m3", False),
    "fp8_e5m2": (2048, 0, False, 0, "fp8_e5m2", False),
    "ring": (RING_ROWS, RING_ROWS - 128, True, 0, "none", False),
    "ring int8": (RING_ROWS, 2 * RING_ROWS - 64, True, 0, "int8", False),
    "ring + sinks": (RING_ROWS + 128, SINKS + RING_ROWS - 128, True, SINKS, "none", False),
    "ring + sinks from 0": (RING_ROWS + 128, 0, True, SINKS, "none", False),
    "paged 128": (128, 1024, False, 0, "none", True),
    "paged 64": (64, 1088, False, 0, "none", True),
    "paged int8": (128, 512, False, 0, "int8", True),
    "paged fp8_e4m3": (128, 1792, False, 0, "fp8_e4m3", True),
    "paged fp8_e5m2": (64, 0, False, 0, "fp8_e5m2", True),
    "paged ring + sinks": (128, 8960, False, 0, "none", True),
}


def _chunk_cache(kind: str, dtype, gen, rng):
    """A filled cache of 8 slots, 8 kv heads, head_dim 128 of CHUNK_KINDS'
    ``kind``: dense [8, 8, rows, 128], or one layer of a page pool over a
    shuffled table (16 pages a slot, or 72 over 37 ring pages a slot with
    the sinks' page); a quantized one from scaled rows. Returns (cache,
    start, ring, sinks)."""
    import torch

    from flash_attention_tpu_torch.models.attention import KVCache
    from flash_attention_tpu_torch.ops.paged import init_paged_model_cache
    from flash_attention_tpu_torch.ops.quant import PAYLOADS, bits, quantize_values

    rows, start, ring, sinks, mode, paged = CHUNK_KINDS[kind]
    if paged:
        per_slot = 72 if "ring" in kind else 16 * 128 // rows
        table, pages = (_ring_table(rng, 8, per_slot, 36, sinks=True) if "ring" in kind else
                        (_shuffled_table(rng, 8, per_slot, 1 + 8 * per_slot, dump_slot=False), 1 + 8 * per_slot))
        model = init_paged_model_cache(1, num_pages=pages, num_slots=8, pages_per_slot=per_slot, kv_heads=8,
                                       page_size=rows, head_dim=128, dtype=dtype, kv_quant=mode, device="cuda")
        model.page_table.copy_(torch.from_numpy(table))
        bufs = [(model.k_pool, model.k_scales), (model.v_pool, model.v_scales)]
    else:
        shape = (8, 8, rows, 128)
        payload = PAYLOADS.get(mode, dtype)
        scales = [torch.ones((*shape[:3], 1), device="cuda") if mode in PAYLOADS else None for _ in range(2)]
        cache = KVCache(torch.empty(shape, dtype=payload, device="cuda"), torch.empty(shape, dtype=payload,
                                                                                     device="cuda"),
                        torch.arange(8, dtype=torch.int32, device="cuda") * 100, *scales)
        bufs = [(cache.k, cache.k_scales), (cache.v, cache.v_scales)]
    for buf, sc in bufs:
        if sc is None:
            buf.copy_(torch_uniform(buf.shape, dtype, gen))
        else:
            qt = quantize_values(scaled_rows(tuple(buf.shape), gen), buf.dtype)
            bits(buf).copy_(bits(qt.values))
            sc.copy_(qt.scales.reshape(sc.shape))
    if paged:
        model.lengths.copy_(torch.arange(8, dtype=torch.int32, device="cuda") * 100)
        cache = model.layers()[0]
    return cache, start, ring, sinks


def _chunk_inputs(dtype, gen):
    """A chunk's q [1, 32, 256, 128] and k, v [1, 8, 256, 128] as the
    projection gives them ([B, T, H, D] transposed); k and v rows of scaled
    magnitudes, so a row quantized with another's scale shows."""
    q = torch_uniform((1, CHUNK_T, 32, 128), dtype, gen).transpose(1, 2)
    k, v = (scaled_rows((1, CHUNK_T, 8, 128), gen).to(dtype).transpose(1, 2) for _ in range(2))
    return q, k, v


def _fused_rope_chunk(card: str, gen) -> dict:
    """F2's chunk form (F2c, ``rope_chunk``) at ModelConfig()'s and
    Mistral-7B's attention widths (q [1, 32, 256, 128], 8 kv heads) in the
    three dtypes, over every CHUNK_KINDS cache at slots 0 and 7, each a
    device scalar, against its plain version on the card: q, every cache
    tensor (rows, scales, table) and the lengths bit for bit, q also bit
    for bit with F2's decode form's rotation (``rope`` at the chunk's
    positions); then timed (a call, alone in a CUDA graph, host µs) at
    phase 5's chunk, and at 11a's, 17a's and 17c's forms, beside plain and
    the bound. Returns F2c's kernels line."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.ops.fused import rope, rope_chunk, rope_chunk_plain

    rng = np.random.default_rng(24)
    done = []
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        q, k, v = _chunk_inputs(dtype, gen)
        for kind in CHUNK_KINDS:
            cache, start, ring, sinks = _chunk_cache(kind, dtype, gen, rng)
            positions = start + torch.arange(CHUNK_T, device="cuda")[None, None, :]
            q_decode_form = rope(q, k, positions)[0]
            for slot in (0, 7):
                slot_t = torch.full((1,), slot, dtype=torch.int32, device="cuda")
                a, b = _clone_cache(cache), _clone_cache(cache)
                qa, a = rope_chunk(q, k, v, a, slot_t, start, ring=ring, sinks=sinks)
                qb, b = rope_chunk_plain(q, k, v, b, slot_t, start, ring=ring, sinks=sinks)
                same = [_bits_equal(x, y) for x, y in zip((qa, *a), (qb, *b)) if x is not None]
                if not all(same) or not _bits_equal(qa, q_decode_form):
                    raise RuntimeError(f"[fused] F2c {dtype} {kind} slot {slot}: q, cache tensors, lengths equal to "
                                       f"plain {same}; q equal to F2's rotation {_bits_equal(qa, q_decode_form)}")
                if int(a.lengths[slot]) != start + CHUNK_T or a.lengths is cache.lengths:
                    raise RuntimeError(f"[fused] F2c {dtype} {kind} slot {slot}: lengths {a.lengths.tolist()}")
            done.append(f"{str(dtype)[6:]} {kind}")
            del cache, a, b
    log(f"[fused] F2c (RoPE + the chunk's cache write) at q [1,32,256,128], 8 kv heads, slots 0 and 7 by device scalar, "
        f"bit-identical to plain on the card (q, rows, scales, table, lengths) and q to F2's rotation: {done}")

    q, k, v = _chunk_inputs(torch.bfloat16, gen)
    slot_t = torch.full((1,), 7, dtype=torch.int32, device="cuda")
    nbytes = (2 * 32 + 2 * 8 + 2 * 8) * CHUNK_T * 128 * 2 + 2 * 8 * 4 + 64 * 4  # q in + out, k, v in, K / V rows out
    row = None
    for kind, label in (("dense", "phase 5"), ("int8", "phase 11a"), ("ring", "phase 17a"),
                        ("paged ring + sinks", "phase 17c")):
        cache, start, ring, sinks = _chunk_cache(kind, torch.bfloat16, gen, rng)
        quant = cache.k_scales is not None
        form_bytes = nbytes - (2 * 8 * CHUNK_T * 128 * (1 if quant else 0)) + (2 * 8 * CHUNK_T * 4 if quant else 0)

        def call(cache=cache, start=start, ring=ring, sinks=sinks):
            return rope_chunk(q, k, v, cache, slot_t, start, ring=ring, sinks=sinks)

        def plain(cache=cache, start=start, ring=ring, sinks=sinks):
            return rope_chunk_plain(q, k, v, cache, slot_t, start, ring=ring, sinks=sinks)

        name = f"rope_chunk_kernel, RoPE + the chunk's cache write ({kind}), q [1,32,256,128] bf16"
        if row is None:
            row = _fused_row(card, "F2c", name, "csrc/fused.cu", "models/attention.py:363", call, plain,
                             form_bytes, err=0.0)
        else:
            _timed_line(card, "F2c", f"{name}, {label}'s form", call, plain, form_bytes)
        del cache
    return {"F2c": row}


def _fused_self_term(card: str, gen) -> dict:
    """F4, K7's self term (``paged_decode_attention(self_kv=...)``) at phase
    24(c)'s pool ([129, 8, 128, 128], 8 slots over a shuffled table, lengths
    PAGED_LENGTHS with slot 0 at 0): plain, window (4096, the deferred
    4095), softcap 50, window + 4 sinks, int8 and e4m3 pools, and the three
    query dtypes; each within REL_BAR row by row of the plain version (K7's
    plain version then ``merge_self_plain``), ORACLE_BAR of the fp32 oracle
    over the visible rows and the self row, LSE_BAR of both LSEs,
    bit-identical over two calls and under a CUDA graph's replay."""
    import numpy as np
    import torch

    from flash_attention_tpu_torch.ops.paged import (
        merge_self_plain,
        paged_decode_attention,
        paged_decode_attention_plain,
    )

    rng = np.random.default_rng(25)
    lengths = torch.tensor((0,) + PAGED_LENGTHS[1:], dtype=torch.int32, device="cuda")
    cases = [("plain", "bf16", None, None, 0), ("window", "bf16", WINDOW, None, 0),
             ("softcap 50", "bf16", None, 50.0, 0), ("window + sinks", "bf16", WINDOW, None, SINKS),
             ("int8 pool", "int8", None, None, 0), ("e4m3 pool", "fp8_e4m3", None, None, 0),
             ("fp16", "fp16", None, None, 0), ("fp32", "fp32", None, None, 0)]
    dtypes = {"fp16": torch.float16, "fp32": torch.float32}
    worst, timed = [], None
    for label, kind, window, softcap, sinks in cases:
        qdt = dtypes.get(kind, torch.bfloat16)
        if kind in QUANT_MODES:
            model, _ = _quant_pages(kind, 1, 129, 8, 16, gen, rng)
            dense = [_dense_from_pages(_dequant_pool(p[0], s[0]), model.page_table)
                     for p, s in ((model.k_pool, model.k_scales), (model.v_pool, model.v_scales))]
        else:
            model = _filled_cache(1, num_pages=129, num_slots=8, pages_per_slot=16, kv_heads=8, head_dim=128,
                                  dtype=qdt, gen=gen)
            model.page_table.copy_(torch.from_numpy(_shuffled_table(rng, 8, 16, 129)).cuda())
            dense = [_dense_from_pages(p[0].float(), model.page_table) for p in (model.k_pool, model.v_pool)]
        cache = model.layers()[0]._replace(lengths=lengths)
        q = torch_uniform((8, 32, 128), qdt, gen)
        k_new, v_new = (torch_uniform((8, 8, 128), qdt, gen) for _ in range(2))
        win = None if window is None else window - 1  # the deferred window: lengths exclude the current token
        masks = dict(sliding_window=win, logit_softcap=softcap, attention_sinks=sinks)

        def call(q=q, cache=cache, k_new=k_new, v_new=v_new, masks=masks):
            return paged_decode_attention(q, cache, save_residuals=True, self_kv=(k_new, v_new), **masks)

        zero_counts()
        (out, lse), grid = _twice(f"F4 {label}", paged_decode_attention, call)
        if read_bodies()["K7/K7q self"] < 1:
            raise RuntimeError(f"[fused] F4 {label}: the self-term counter did not rise")
        if not _graph_replays(call, (out, lse)):
            raise RuntimeError(f"[fused] F4 {label}: a CUDA graph's replay differs from the direct call")
        p_out, p_lse = merge_self_plain(q, *paged_decode_attention_plain(q, cache, sm_scale=128**-0.5,
                                                                         save_residuals=True, **masks),
                                        k_new, v_new, sm_scale=128**-0.5, logit_softcap=softcap)
        rows_per_seq = [_visible_positions(int(n), win if win is not None else 10**9, sinks) + [2048]
                        for n in lengths.tolist()]
        k_full, v_full = (torch.cat([d, n.float()[:, :, None]], dim=2) for d, n in zip(dense, (k_new, v_new)))
        o_out, o_lse, _ = _oracle_rows(q, k_full, v_full, rows_per_seq, softcap=softcap)
        rel, d_oracle = _rel_diff(out, p_out), _max_diff(out, o_out)
        d_lse = max(_max_diff(lse, p_lse), _max_diff(lse, o_lse))
        if not (rel < REL_BAR[str(qdt)[6:]] and d_oracle < ORACLE_BAR and d_lse < LSE_BAR):
            raise RuntimeError(f"[fused] F4 {label}: row-relative {rel:.3e}, oracle {d_oracle:.3e}, LSE {d_lse:.3e}")
        if not torch.equal(out[0].float(), v_new[0].float().repeat_interleave(4, dim=0)):
            raise RuntimeError(f"[fused] F4 {label}: the slot of length 0 did not return its v_new")
        worst.append((label, f"{rel:.2e}", f"{d_oracle:.2e}", f"{d_lse:.2e}", grid))
        if label == "plain":
            live = sum(int(n) for n in lengths.tolist())
            nbytes = 2 * live * 8 * 128 * 2 + 2 * 8 * 32 * 128 * 2 + 2 * 8 * 8 * 128 * 2 + 8 * 32 * 4
            timed = _fused_row(card, "F4", "paged_decode (K7) with the self term, q [8,32,128] over [129,8,128,128] "
                               "bf16", "csrc/decode.cu", "models/attention.py:595", call,
                               lambda: merge_self_plain(q, *paged_decode_attention_plain(
                                   q, cache, sm_scale=128**-0.5, save_residuals=True), k_new, v_new,
                                   sm_scale=128**-0.5), nbytes, err=d_oracle)
    log(f"[fused] F4 (K7 + the self term) against plain (row-relative), the fp32 oracle and the LSEs, bit-identical "
        f"over two calls and a graph replay, a slot of length 0 returning v_new: {worst}")
    return {"F4": timed}


def phase_fused(card: str) -> dict:
    """Phase 25: the decode step's glue kernels (csrc/fused.cu, and K7's self
    term) at ModelConfig()'s widths against their plain versions, timed, each
    counter rising where its kernel launched. Returns the kernels' lines by
    key (their launches filled in by main from the main paths)."""
    import torch

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(25)
    zero_counts()
    out = _fused_norm_act(card, gen)
    out.update(_fused_rope(card, gen))
    out.update(_fused_rope_chunk(card, gen))
    counts = read_counts()
    if any(counts[key] < 1 for key in (*GLUE, "F2c")):
        raise RuntimeError(f"[fused] a glue kernel's counter did not rise: {counts}")
    out.update(_fused_self_term(card, gen))
    log(f"[fused] phase 25 took {time.perf_counter() - t0:.1f} s ({card})")
    return out


# Phase 26: ModelConfig()'s W8A16 products, (weight shape, contract axes, scale on the output), and the
# tensor-parallel shards the engines run (a model axis of 2 and 4: column shards as strided views, and the
# row-parallel w_down shard with an fp32 output).
W8_WEIGHTS = {
    "wq": ((4096, 32, 128), 0, False), "wk": ((4096, 8, 128), 0, False), "wo": ((32, 128, 4096), (0, 1), False),
    "w_gate": ((4096, 11008), 0, False), "w_down": ((11008, 4096), 0, False), "unembed": ((32000, 4096), 1, True),
}
W8_SHARDS = {  # name: (full weight, dimension split, ranks, fp32 output)
    "wq / 4": ("wq", 1, 4, False), "w_gate / 2": ("w_gate", 1, 2, False), "w_gate / 4": ("w_gate", 1, 4, False),
    "w_down / 4 (row-parallel)": ("w_down", 0, 4, True), "wo / 2 (row-parallel)": ("wo", 0, 2, True),
}
# The weights that read one x, one W1 launch a group (ops/quant.w8_matmul_group): a layer's q / k / v and gate /
# up, whole and as a model-4 rank's column shards (strided views).
W8_GROUPS = {"q / k / v": ("wq", "wk", "wv"), "gate / up": ("w_gate", "w_up"),
             "q / k / v / 4": ("wq / 4", "wk / 4", "wv / 4"), "gate / up / 4": ("w_gate / 4", "w_up / 4")}
W8_GROUP_SHARDS = {"wk / 4": ("wk", 1, 4, False), "wv / 4": ("wv", 1, 4, False), "w_up / 4": ("w_up", 1, 4, False)}
W1_ROWS = (1, 8, 32)  # decode: live slots (8 in the phases; 32 in an engine of 32 slots, on W2 past 16)
W2_ROWS = (64, 256, 1024)  # prefill chunks
W8_TIMED = (("W1", 8), ("W2", 256), ("W2", 1024))
COLD_BYTES = 100e6  # a cold-L2 replay walks distinct copies of a weight summing past this (the L2 holds 50 MB)


def _w8_weights(gen) -> dict:
    """Phase 26's int8 weights at ModelConfig()'s widths (init_model_params'
    scales), quantized by the port, wv and w_up beside wk and w_gate for the
    groups, and their shards."""
    import math

    import torch

    from flash_attention_tpu_torch.ops.quant import QuantizedTensor, quantize_weight

    out = {}
    shapes = {**W8_WEIGHTS, "wv": W8_WEIGHTS["wk"], "w_up": W8_WEIGHTS["w_gate"]}
    for name, (shape, axes, _) in shapes.items():
        fan_in = shape[0] * (shape[1] if isinstance(axes, tuple) else 1) if name != "unembed" else shape[1]
        w = torch.randn(shape, generator=gen, device="cuda") / math.sqrt(fan_in)
        out[name] = quantize_weight(w, contract_axes=axes)
    for label, (name, dim, ranks, _) in {**W8_SHARDS, **W8_GROUP_SHARDS}.items():
        qt = out[name]
        size = qt.values.shape[dim] // ranks
        values = qt.values.narrow(dim, size, size)  # rank 1's block
        scales = qt.scales if dim == 0 else qt.scales.narrow(dim, size, size)
        out[label] = QuantizedTensor(values, scales)
    return out


def _w8_oracle(x, w, scale_on_output: bool):
    """The fp32 oracle of a W8A16 product: the scales applied to the fp32 codes, no bf16 widen."""
    k = x.shape[-1]
    if scale_on_output:
        return (x.float() @ w.values.float().t()) * w.scales.reshape(-1).float()
    return x.float() @ (w.values.float() * w.scales).reshape(k, -1)


def _w8_case(what: str, x, w, *, out_dtype, scale_on_output: bool, kernel: str) -> tuple[float, float]:
    """One W8A16 product on the card: launched on ``kernel`` (W1 / W2) and
    nothing else, bit-identical over two calls, within PLAIN_BAR (REL_BAR in
    fp32) row-relative of the plain version and ORACLE_BAR of the fp32
    oracle (the scales applied to the fp32 codes, no bf16 widen). Returns
    (row-relative error, oracle error)."""
    import torch

    from flash_attention_tpu_torch.ops.quant import w8_matmul, w8_matmul_plain

    before = read_counts()
    try:
        got = w8_matmul(x, w, out_dtype=out_dtype, scale_on_output=scale_on_output)
        again = w8_matmul(x, w, out_dtype=out_dtype, scale_on_output=scale_on_output)
        torch.cuda.synchronize()
    except RuntimeError as err:
        raise RuntimeError(f"[w8] {what}: {err}") from err
    gained = {k: n - before[k] for k, n in read_counts().items() if n != before[k]}
    if gained != {kernel: 2}:
        raise RuntimeError(f"[w8] {what}: launches {gained}, want {{'{kernel}': 2}}")
    if not _bits_equal(got, again):
        raise RuntimeError(f"[w8] {what}: two calls on the same inputs differ")
    plain = w8_matmul_plain(x, w, out_dtype=out_dtype, scale_on_output=scale_on_output)
    oracle = _w8_oracle(x, w, scale_on_output)
    rel = _rel_diff(got.reshape(plain.shape), plain)
    d_oracle = _max_diff(got.reshape(oracle.shape).float(), oracle)
    bar = REL_BAR["float32"] if x.dtype == torch.float32 else PLAIN_BAR
    if not (rel < bar and d_oracle < ORACLE_BAR):
        raise RuntimeError(f"[w8] {what}: row-relative to plain {rel:.3e} (bar {bar}), oracle {d_oracle:.3e}")
    return rel, d_oracle


def _w8_group_case(what: str, x, ws, *, out_dtype) -> tuple[float, float]:
    """A group of weights that read one x (``w8_matmul_group``): one W1
    launch for the group, two calls bit-identical, a CUDA graph's replay
    equal to the direct call, each product within PLAIN_BAR row-relative of
    its plain version and ORACLE_BAR of its fp32 oracle, and one-hot rows of
    x the widened weights' rows bit for bit. Returns the worst (row-relative
    error, oracle error)."""
    import torch

    from flash_attention_tpu_torch.ops.quant import w8_dequant, w8_matmul_group, w8_matmul_plain

    before = read_counts()
    try:
        got = w8_matmul_group(x, ws, out_dtype=out_dtype)
        again = w8_matmul_group(x, ws, out_dtype=out_dtype)
        torch.cuda.synchronize()
    except RuntimeError as err:
        raise RuntimeError(f"[w8] {what}: {err}") from err
    gained = {k: n - before[k] for k, n in read_counts().items() if n != before[k]}
    if gained != {"W1": 2}:
        raise RuntimeError(f"[w8] {what}: launches {gained}, want {{'W1': 2}} (one a group)")
    if not all(_bits_equal(a, b) for a, b in zip(got, again)):
        raise RuntimeError(f"[w8] {what}: two calls on the same inputs differ")
    if not _graph_replays(lambda: w8_matmul_group(x, ws, out_dtype=out_dtype), got):
        raise RuntimeError(f"[w8] {what}: a CUDA graph's replay differs from the direct call")
    worst = [0.0, 0.0]
    for out, w in zip(got, ws):
        plain = w8_matmul_plain(x, w, out_dtype=out_dtype)
        oracle = _w8_oracle(x, w, False)
        worst = [max(worst[0], _rel_diff(out.reshape(plain.shape), plain)),
                 max(worst[1], _max_diff(out.reshape(oracle.shape).float(), oracle))]
    if not (worst[0] < PLAIN_BAR and worst[1] < ORACLE_BAR):
        raise RuntimeError(f"[w8] {what}: row-relative to plain {worst[0]:.3e} (bar {PLAIN_BAR}), oracle "
                           f"{worst[1]:.3e}")
    m, k = x.shape
    ks = torch.linspace(0, k - 1, m, device="cuda").long()
    hot = torch.zeros((m, k), dtype=x.dtype, device="cuda")
    hot[torch.arange(m, device="cuda"), ks] = 1
    for out, w in zip(w8_matmul_group(hot, ws, out_dtype=out_dtype), ws):
        want = w8_dequant(w).to(x.dtype).reshape(k, -1)[ks].to(out_dtype)
        if not _bits_equal(out.reshape(m, -1).contiguous(), want.contiguous()):
            raise RuntimeError(f"[w8] {what}: one-hot rows differ from the widened weight's rows")
    return worst[0], worst[1]


def _w8_one_hot(what: str, w, k: int, dtype, m: int, *, out_dtype, scale_on_output: bool) -> None:
    """Rows e_k of x (k spread over K) return the widened weight's rows
    k bit for bit (the unembed: the code times the row's scale in fp32)."""
    import torch

    from flash_attention_tpu_torch.ops.quant import w8_dequant, w8_matmul

    ks = torch.linspace(0, k - 1, m, device="cuda").long()
    x = torch.zeros((m, k), dtype=dtype, device="cuda")
    x[torch.arange(m, device="cuda"), ks] = 1
    got = w8_matmul(x, w, out_dtype=out_dtype, scale_on_output=scale_on_output).reshape(m, -1)
    if scale_on_output:
        want = w.values[:, ks].t().float() * w.scales.reshape(1, -1)
    else:
        want = w8_dequant(w).to(dtype).reshape(k, -1)[ks].to(out_dtype)
    if not _bits_equal(got.contiguous(), want.contiguous()):
        raise RuntimeError(f"[w8] {what}: one-hot rows differ from the widened weight's rows "
                           f"({int((got != want).sum())} elements)")


def _w8_k(w, axes, scale_on_output: bool) -> int:
    """x's columns for a weight of phase 26: the [N, K] unembed's K, else
    the product of the contracted leading axes."""
    import math

    return w.values.shape[1] if scale_on_output else math.prod(w.values.shape[:2 if axes == (0, 1) else 1])


def _cold_ms(make, nbytes: float, calls: int = 10) -> float:
    """ms a call of ``make(i)``'s callable (i indexes a distinct copy of the
    operands ``make`` prepared) alone in a CUDA graph that walks the copies
    in turn, at least ``calls`` calls and at least COLD_BYTES of them, so
    that each call finds its weight out of the 50 MB L2, as a decode step
    does."""
    import math

    import torch

    copies = max(2, math.ceil(COLD_BYTES / nbytes))
    fns = [make(i) for i in range(copies)]
    n = max(calls, copies)
    for fn in fns:
        fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fns[i % copies]()
    ms = cuda_ms(graph.replay) / n
    del graph, fns
    return ms


def _weight_copies(w, nbytes: float) -> list:
    """Distinct copies of a QuantizedTensor (values strided as ``w``'s, a
    shard's view included) summing past COLD_BYTES, ``w`` itself first."""
    import math

    import torch

    from flash_attention_tpu_torch.ops.quant import QuantizedTensor

    copies = [w]
    base = w.values._base if w.values._base is not None else w.values
    for _ in range(max(2, math.ceil(COLD_BYTES / nbytes)) - 1):
        whole = base.clone()
        values = torch.as_strided(whole, w.values.shape, w.values.stride(),
                                  w.values.storage_offset() - base.storage_offset())
        copies.append(QuantizedTensor(values, w.scales.clone()))
    return copies


def _w8_row(card: str, key: str, what: str, x, w, *, out_dtype, scale_on_output: bool, err: float) -> dict:
    """A timed W8A16 product: the wrapper call, the kernel alone in a CUDA
    graph (the weight in L2) and the host µs (``_three_times``), the kernel
    alone with a cold L2 (``_cold_ms``); the plain version; cuBLAS on the
    weight widened beforehand (``library_ms``, as a call, and alone with a
    cold L2, the same protocol); and the path before W1 / W2 (the widen to a
    bf16 copy, then cuBLAS), against the bound (the int8 weight, its scales,
    x and the output once; 2 M N K at 989 TFLOP/s)."""
    import torch

    from flash_attention_tpu_torch.ops.quant import w8_dequant, w8_matmul, w8_matmul_plain

    m, k = x.shape
    n = w.values.shape[0] if scale_on_output else w.values.numel() // k
    ms, alone, host_us = _three_times(lambda: w8_matmul(x, w, out_dtype=out_dtype, scale_on_output=scale_on_output))
    copies = _weight_copies(w, k * n)
    cold = _cold_ms(lambda i: lambda: w8_matmul(x, copies[i], out_dtype=out_dtype, scale_on_output=scale_on_output),
                    k * n)
    del copies
    plain_ms = cuda_ms(lambda: w8_matmul_plain(x, w, out_dtype=out_dtype, scale_on_output=scale_on_output))
    if scale_on_output:
        wide = w.values.to(x.dtype)
        library_ms = cuda_ms(lambda: torch.mm(x, wide.t(), out_dtype=torch.float32))
        wides = [wide] + [wide.clone() for _ in range(max(2, -(-int(COLD_BYTES) // (2 * k * n))) - 1)]
        lib_cold = _cold_ms(lambda i: lambda: torch.mm(x, wides[i].t(), out_dtype=torch.float32), 2 * k * n)
        before_ms = cuda_ms(lambda: torch.matmul(x, w.values.to(x.dtype).t()).float() * w.scales[:, 0])
    else:
        wide = w8_dequant(w).to(x.dtype).reshape(k, n)
        library_ms = cuda_ms(lambda: torch.matmul(x, wide))
        wides = [wide] + [wide.clone() for _ in range(max(2, -(-int(COLD_BYTES) // (2 * k * n))) - 1)]
        lib_cold = _cold_ms(lambda i: lambda: torch.matmul(x, wides[i]), 2 * k * n)
        before_ms = cuda_ms(lambda: torch.matmul(x, w8_dequant(w).to(x.dtype).reshape(k, n)))
    del wide, wides
    out_bytes = 4 if out_dtype == torch.float32 else 2
    nbytes = k * n + 4 * n + m * k * x.element_size() + m * n * out_bytes
    bound_ms, bound_by = bound(2.0 * m * n * k, nbytes)
    log(f"[w8] {key} {what}: kernel {ms:.4f} ms as a call, {alone:.4f} ms alone in a CUDA graph, {cold:.4f} ms alone "
        f"with a cold L2, host {host_us:.1f} us a call; plain {plain_ms:.4f} ms; cuBLAS on the widened weight "
        f"{library_ms:.4f} ms as a call, {lib_cold:.4f} ms alone with a cold L2 (kernel / cuBLAS {cold / lib_cold:.3f}); "
        f"the widen + cuBLAS path before W1 / W2 {before_ms:.4f} ms; bound {bound_ms:.5f} ms ({bound_by}, "
        f"{nbytes / 1e6:.2f} MB, {2.0 * m * n * k / 1e9:.2f} GFLOP), {bound_ms / alone:.3f} of it alone, "
        f"{bound_ms / cold:.3f} cold ({card})")
    return {"name": f"{'w8_gemv_group_kernel' if key == 'W1' else 'w8_gemm_kernel'} ({key}), {what}", "route": "cuda",
            "source": "flash_attention_tpu_torch/csrc/w8.cu", "replaces": f"{REFERENCE}/ops/quant.py:124",
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "alone_ms": alone, "cold_ms": cold,
            "library_cold_ms": lib_cold, "host_us": host_us}


def _w8_group_row(card: str, label: str, x, ws) -> dict:
    """A timed W1 group (``w8_matmul_group``): the wrapper call, alone in a
    CUDA graph, alone with a cold L2 and the host µs, beside its weights'
    single launches (``w8_matmul`` one after another, cold) and cuBLAS on
    the widened weights (cold), against the group's bound (its weights,
    scales, x once and the outputs, over 3.35 TB/s)."""
    import torch

    from flash_attention_tpu_torch.ops.quant import w8_dequant, w8_matmul, w8_matmul_group

    m, k = x.shape
    ns = [w.values.numel() // k for w in ws]
    wbytes = sum(k * n for n in ns)
    ms, alone, host_us = _three_times(lambda: w8_matmul_group(x, ws))
    copies = [_weight_copies(w, wbytes) for w in ws]
    cold = _cold_ms(lambda i: lambda: w8_matmul_group(x, [c[i] for c in copies]), wbytes)
    singles = _cold_ms(lambda i: lambda: [w8_matmul(x, c[i]) for c in copies], wbytes)
    del copies
    single_host = _three_times(lambda: [w8_matmul(x, w) for w in ws])[2]
    wides = [[w8_dequant(w).to(x.dtype).reshape(k, -1) for w in ws]]
    wides += [[t.clone() for t in wides[0]] for _ in range(max(2, -(-int(COLD_BYTES) // (2 * wbytes))) - 1)]
    lib_cold = _cold_ms(lambda i: lambda: [torch.matmul(x, t) for t in wides[i]], 2 * wbytes)
    del wides
    nbytes = wbytes + 4 * sum(ns) + m * k * 2 + m * sum(ns) * 2
    bound_ms, bound_by = bound(2.0 * m * k * sum(ns), nbytes)
    log(f"[w8] W1 group {label} (N {ns}, K {k}), x [{m}, {k}] bf16: one launch {ms:.4f} ms as a call, {alone:.4f} ms "
        f"alone in a CUDA graph, {cold:.4f} ms alone with a cold L2, host {host_us:.1f} us a call (the single calls "
        f"one after another: {singles:.4f} ms cold, host {single_host:.1f} us); cuBLAS on the widened weights "
        f"{lib_cold:.4f} ms cold; bound {bound_ms:.5f} ms ({bound_by}, {nbytes / 1e6:.2f} MB), {bound_ms / cold:.3f} "
        f"of it cold, {bound_ms / alone:.3f} alone ({card})")
    return {"ms": ms, "alone_ms": alone, "cold_ms": cold, "singles_cold_ms": singles, "host_us": host_us,
            "singles_host_us": single_host, "library_ms": lib_cold, "bound_ms": bound_ms}


def phase_w8(card: str) -> dict:
    """Phase 26: W1 and W2 (csrc/w8.cu) at ModelConfig()'s weights (wq, wk,
    wo over (H, D), w_gate, w_down, the [32000, 4096] unembed with its
    scale on the fp32 output) and the engines' tensor-parallel shards
    (strided column views; the row-parallel partials in fp32), each at
    W1_ROWS (W1) and W2_ROWS (W2) rows in bf16 and fp16, and at W1_ROWS in
    fp32 (W1's FMA body): every product held by ``_w8_case`` and its one-hot
    rows by ``_w8_one_hot``; the W8_GROUPS (q / k / v, gate / up, whole and
    model-4 shards) as one W1 launch each at 1, 8 and W1_MAX_ROWS rows by
    ``_w8_group_case``;
    a split W1 (wo, w_down) and W2 replayed in a CUDA graph equal to the
    direct call; an odd shape (K 100, N 72) on W1's byte-wise loads. Then
    the W8_TIMED rows at every layout in bf16, timed (``_w8_row``), and the
    groups at 8 rows (``_w8_group_row``). Returns W1's and W2's lines
    (w_gate at 8 and 256 rows) and the timed numbers by row."""
    import torch

    from flash_attention_tpu_torch.ops.quant import W1_MAX_ROWS, quantize_weight, w8_matmul

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(26)
    weights = _w8_weights(gen)
    worst, cases = {"W1": [0.0, 0.0], "W2": [0.0, 0.0], "W1 groups": [0.0, 0.0]}, 0
    layouts = {**{name: (axes, on_output, False) for name, (_, axes, on_output) in W8_WEIGHTS.items()},
               **{label: (W8_WEIGHTS[name][1], False, f32) for label, (name, _, _, f32) in W8_SHARDS.items()}}
    for name, (axes, on_output, f32_out) in layouts.items():
        w = weights[name]
        k = _w8_k(w, axes, on_output)
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            out_dtype = torch.float32 if on_output or f32_out else dtype
            for m in W1_ROWS + (W2_ROWS if dtype != torch.float32 else ()):
                kernel = "W1" if m <= W1_MAX_ROWS or dtype == torch.float32 else "W2"
                x = torch_uniform((m, k), dtype, gen) * 2
                rel, d_oracle = _w8_case(f"{name} {str(dtype)[6:]} M={m}", x, w, out_dtype=out_dtype,
                                         scale_on_output=on_output, kernel=kernel)
                worst[kernel] = [max(worst[kernel][0], rel), max(worst[kernel][1], d_oracle)]
                cases += 1
            for m in (8, 64) if dtype != torch.float32 else (8,):
                _w8_one_hot(f"{name} {str(dtype)[6:]} M={m}", w, k, dtype, m, out_dtype=out_dtype,
                            scale_on_output=on_output)
    groups = 0
    for label, names in W8_GROUPS.items():
        ws = [weights[name] for name in names]
        for dtype in (torch.bfloat16, torch.float16):
            for m in sorted({1, 8, W1_MAX_ROWS}):
                x = torch_uniform((m, 4096), dtype, gen) * 2
                rel, d_oracle = _w8_group_case(f"group {label} {str(dtype)[6:]} M={m}", x, ws, out_dtype=dtype)
                worst["W1 groups"] = [max(worst["W1 groups"][0], rel), max(worst["W1 groups"][1], d_oracle)]
                groups += 1
    log(f"[w8] {cases} products held (launched on W1 at <= {W1_MAX_ROWS} rows or fp32, else W2; two calls "
        f"bit-identical; one-hot rows bit-exact at 8 and 64 rows) and {groups} groups (one W1 launch a group, two "
        f"calls bit-identical, replay == call, one-hot rows bit-exact): worst row-relative to plain and oracle error "
        f"W1 {worst['W1'][0]:.3e} / {worst['W1'][1]:.3e}, W2 {worst['W2'][0]:.3e} / {worst['W2'][1]:.3e}, groups "
        f"{worst['W1 groups'][0]:.3e} / {worst['W1 groups'][1]:.3e} ({card})")

    # A CUDA graph's replay equals the direct call.
    for name, m in (("wo", 8), ("w_down", 1), ("w_down / 4 (row-parallel)", 32), ("w_gate", 256), ("unembed", 8),
                    ("unembed", 1024), ("wq", 64)):
        w, on_output = weights[name], name == "unembed"
        k = _w8_k(w, (0, 1) if name == "wo" else 0, on_output)
        x = torch_uniform((m, k), torch.bfloat16, gen)
        out_dtype = torch.float32 if on_output or "row" in name else torch.bfloat16

        def call(x=x, w=w, out_dtype=out_dtype, on_output=on_output):
            return (w8_matmul(x, w, out_dtype=out_dtype, scale_on_output=on_output),)

        if not _graph_replays(call, call()):
            raise RuntimeError(f"[w8] {name} M={m}: a CUDA graph's replay differs from the direct call")
    # An odd shape: W1's byte-wise loads (K and N off 16), W2's shapes falling back to W1.
    odd = quantize_weight(torch.randn((100, 72), generator=gen, device="cuda") / 10, contract_axes=0)
    odd_e = quantize_weight(torch.randn((72, 100), generator=gen, device="cuda") / 10, contract_axes=1)
    for dtype in (torch.bfloat16, torch.float16):
        for m in (3, 40):
            x = torch_uniform((m, 100), dtype, gen) * 2
            _w8_case(f"odd [100, 72] {str(dtype)[6:]} M={m}", x, odd, out_dtype=dtype, scale_on_output=False,
                     kernel="W1")
            _w8_case(f"odd unembed [72, 100] {str(dtype)[6:]} M={m}", x, odd_e, out_dtype=torch.float32,
                     scale_on_output=True, kernel="W1")
    log(f"[w8] CUDA graph replays == direct calls (split W1, W2, the unembed); odd shapes (K 100, N 72) on W1 "
        f"held ({card})")

    rows, timed = {}, {}
    for key, m in W8_TIMED:
        for name in ("wq", "wk", "wo", "w_gate", "w_down", "unembed"):
            w, on_output = weights[name], name == "unembed"
            k = 11008 if name == "w_down" else 4096
            x = torch_uniform((m, k), torch.bfloat16, gen) * 2
            out_dtype = torch.float32 if on_output else torch.bfloat16
            _, d_oracle = _w8_case(f"timed {name} M={m}", x, w, out_dtype=out_dtype, scale_on_output=on_output,
                                   kernel=key)
            row = _w8_row(card, key, f"{name} {tuple(w.values.shape)}, x [{m}, {k}] bf16", x, w, out_dtype=out_dtype,
                          scale_on_output=on_output, err=d_oracle)
            timed[f"{key} {name} M={m}"] = {k2: row.pop(k2) for k2 in ("alone_ms", "cold_ms", "library_cold_ms",
                                                                       "host_us")}
            timed[f"{key} {name} M={m}"].update(ms=row["ms"], library_ms=row["library_ms"], bound_ms=row["bound_ms"])
            if name == "w_gate" and m in (8, 256):
                rows[key] = row
    for label in ("q / k / v", "gate / up"):
        x = torch_uniform((8, 4096), torch.bfloat16, gen) * 2
        timed[f"W1 group {label} M=8"] = _w8_group_row(card, label, x, [weights[n] for n in W8_GROUPS[label]])
    log(f"[w8] phase 26 took {time.perf_counter() - t0:.1f} s ({card})")
    return {"rows": rows, "timed": timed}


def main() -> None:
    import torch

    from flash_attention_tpu_torch.models.transformer import ModelConfig

    t_start = time.perf_counter()
    laps = [t_start]

    def lap(phases: str) -> None:
        laps.append(time.perf_counter())
        log(f"[time] phases {phases}: {laps[-1] - laps[-2]:.1f} s")

    card = phase_device()
    phase_build()
    lap("1-2")
    fwd = phase_k1(card)
    k1, k1t = fwd["K1"], fwd["K1t"]
    cache = phase_cache_kernels(card)
    k6 = phase_k6(card)
    phase_kernel_sweep()
    lap("3")
    dense_tiny = phase_tiny()
    lap("4")
    launches, params, dense = phase_full(card)
    k1["launches"], k6["launches"] = launches["K1"], launches["K6"]
    glue_launches = {key: launches[key] for key in (*GLUE, "F2c")}
    s1 = phase_sampling(card, params)
    s1["launches"] = launches["S1"]
    lap("5")
    k7, k8, k10 = phase_paged_kernels(card)
    phase_paged_sweep()
    lap("6")
    phase_tiny_paged(dense_tiny)
    lap("7")
    launches, paged = serve_full_paged(card, "full paged", ModelConfig(), params, used=("K7", "K8", "K9/K10", *SERVED),
                                       dense=dense)
    k7["launches"], k8["launches"], k10["launches"] = launches["K7"], launches["K8"], launches["K9/K10"]
    glue_launches["F4"] = launches["K7"]  # every one with the self term (check_self_term)
    s1["launches"] += launches["S1"]
    lap("8")
    quant = phase_quant_kernels(card)
    phase_quant_sweep()
    lap("9")
    phase_tiny_quant()
    lap("10")
    w8_launches = phase_full_quant(card, params, dense, paged)
    for key in ("K6q", "K7q", "K8q", "K10q"):
        quant[key]["launches"] = w8_launches[key]
    cache["K1q"]["launches"] = w8_launches["K1q"]
    lap("11")
    bwd = phase_bwd_kernels(card)
    phase_bwd_sweep()
    phase_tensor_core_sweep()
    lap("12")
    phase_tiny_train()
    train = phase_full_train(card, params)
    lap("13-14")
    bwd["K3"]["launches"] = train["mha"]["K3"]
    k1t["launches"] = train["gqa"]["K1"]
    bwd["K4"]["launches"], bwd["K5"]["launches"] = train["gqa"]["K4"], train["gqa"]["K5"]
    bwd["K5s"]["launches"] = train["gqa"]["K5s"]
    del params  # phase 17 brings its own model, and its peak memory is its own
    masked = phase_masked_kernels(card)
    phase_masked_sweep()
    phase_split_sweep()
    lap("15")
    masked["K2"]["launches"] = phase_tiny_masked()
    lap("16")
    full = phase_full_masked(card)
    lap("17")
    masked["K1w"]["launches"], masked["K1c"]["launches"] = full["b"]["K1"], full["d"]["K1"]
    cache["K1r"]["launches"] = full["a"]["K1r"]
    masked["K6r"]["launches"] = full["a"]["K6"]
    glue_launches["F3m"] = full["a"]["F3"]
    masked["K7s"]["launches"], masked["K8s"]["launches"] = full["c"]["K7"], full["c"]["K8"]
    train_masked, attn_ms = phase_masked_bwd(card)
    phase_masked_bwd_sweep()
    phase_tiny_train_masked()
    runs = phase_full_train_masked(card, attn_ms)
    lap("18-20")
    for key in train_masked:
        train_masked[key]["launches"] = sum(run[key] for run in runs.values())
    source = "flash_attention_tpu_torch/csrc/"
    names = {
        "K2": ("fwd_kernel, wgmma + TMA, window <= 64 (K2)", "flash_fwd_sm90.cu", "ops/flash_attention.py:795"),
        "K1w": ("fwd_kernel, wgmma + TMA, window 4096 (K1)", "flash_fwd_sm90.cu", "ops/flash_attention.py:57"),
        "K1c": ("fwd_kernel, wgmma + TMA, softcap 50 (K1)", "flash_fwd_sm90.cu", "ops/flash_attention.py:57"),
        "K6r": ("decode, ring of 4352 rows (K6)", "decode.cu", "ops/decode.py:56"),
        "K7s": ("paged_decode, window + sinks (K7)", "decode.cu", "ops/paged.py:980"),
        "K8s": ("fwd_kernel, wgmma + TMA, paged ring + sinks (K8)", "flash_fwd_sm90.cu", "ops/paged.py:580"),
        "K1d": ("fwd_kernel, wgmma + TMA, segment ids (K1d)", "flash_fwd_sm90.cu", "ops/flash_attention.py:61"),
        "K3m": ("dkv_kernel<FUSED>, wgmma + TMA, masked (K3)", "flash_bwd_sm90.cu", "ops/attention_bwd.py:594"),
        "K4m": ("dq_kernel, wgmma + TMA, masked (K4)", "flash_bwd_sm90.cu", "ops/attention_bwd.py:65"),
        "K5m": ("dkv_kernel, wgmma + TMA, masked (K5)", "flash_bwd_sm90.cu", "ops/attention_bwd.py:317"),
    }
    masked.update(train_masked)
    masked = [{"name": names[key][0], "route": "cuda", "source": source + names[key][1],
               "replaces": f"{REFERENCE}/{names[key][2]}", **masked[key]} for key in names]
    probes = phase_probes(card)
    lap("21")
    parallel = phase_parallel(card)
    lap("22")
    sharded = phase_sharded_serving(card, dense["tokens"], paged["tokens"])
    lap("23")
    phase_warmup_profiles(card, dense["tokens"], paged["tokens"])
    lap("24")
    fused = phase_fused(card)
    for key, row in fused.items():
        row["launches"] = glue_launches[key]
    lap("25")
    w8 = phase_w8(card)["rows"]
    for key, row in w8.items():
        row["launches"] = w8_launches[key]
    lap("26")
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k1t, *cache.values(), k6, k7, k8, k10, *quant.values(), *bwd.values(), *masked, *probes,
                                  *parallel, *sharded, *fused.values(), *w8.values(), s1]}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    if shutil.which("nvidia-smi") is None:
        raise SystemExit("chip_smoke: nvidia-smi not found; this script needs a CUDA card")
    main()
