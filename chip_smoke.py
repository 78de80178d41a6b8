"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py

At the paper's scale — ``make_population(FULL, 96)``: 96 DIMMs (768 chips)
of 512x512 mats, 16 mats and 8 subarrays — it

  1. prints the card (nvidia-smi name and power limit) and builds every CUDA
     kernel from ``src/repro_torch/kernels/csrc`` (one nvcc per source,
     started together);
  2. holds the ``fail_prob`` kernel against its plain PyTorch version on the
     card bit for bit (``torch.equal``) at the main path's shape, with
     ``open_bitline=False``, at a ragged shape and at shapes on the edges of
     the kernel's tiling (R not a multiple of 32 rows, C in {5, 7, 96,
     1000}, D = 1, M = 1); checks the kernel's fast divisions against IEEE
     division on every float32 operand of their ranges for the population's
     divisors; times kernel and plain version;
  3. characterizes the population (``row_error_lambda``, tRP at 7.5 ns; one
     ``fail_prob_rows`` launch per subarray and pattern) and holds the first 4 DIMMs
     against the port run on the CPU (rtol 1e-5: the card sums in another
     order);
  4. DIVA-profiles all 96 DIMMs and conventionally profiles 8 (at 96 its
     eager temporaries would be ~6.4 GB each), holds the DIVA tables of the
     first 8 DIMMs against the CPU port (identical), and prints the mean
     read/write latency reduction beside the paper's 35.1% / 57.8%;
  5. holds the SECDED encode / syndrome and shuffle kernels against their
     plain versions (``torch.equal``) on seeded 0/1 bits at the DIVA
     Shuffling path's shapes — syndrome (3,072,000, 72), encode (8,388,608,
     64), shuffle (192,000, 576) for the DIVA, unshuffled, inverse and codec
     permutations — and at ragged N in {1, 1000003}, and times kernel, plain
     version and, for the shuffle, ``torch.index_select``;
  6. runs Fig 17 on the profiled population: burst-bit profiles of the 96
     DIMMs (8 ``fail_prob`` launches), then the SECDED outcome with and
     without DIVA Shuffling over 2000 accesses each (2 ``diva_shuffle`` + 1
     ``secded_syndrome`` launches); holds the profiles of 2 DIMMs against the
     CPU port (rtol 1e-5) and the counts of 8 DIMMs against the CPU port fed
     the card's profiles (identical);
  7. runs Fig 17 on the synthetic stripe profiles of the ``fig17_shuffling``
     figure (72 DIMMs, 400 accesses): counts identical to the CPU port's;
  8. protects a 64 MiB blob with the codec, flips 1,000 8-bit runs, recovers
     it: the data must come back exactly with every flipped bit corrected,
     and the first 1 MiB's lanes must equal the CPU port's;
  9. the Fig 19 memory system: holds both ``bank_sched`` walk kernels (the
     fast one the wrapper picks for memsim's traces, and the general one)
     against the plain walk (``torch.equal`` on latency and hit in service
     order) on base + the 96 DIVA tables x 12 workloads at n = 2,000 for four
     configurations, and at n = 1, 5 and Q = 32, and the general one, which
     the wrapper picks there, on a trace with a decreasing arrival and on 40
     banks; times the fast one at n = 20,000 (ns and SM cycles a step, the
     SM clock from nvidia-smi), in order (Q = 1) and the general one at the
     same shape; then drives Fig 19 at n = 20,000 — FR-FCFS on the whole-DIMM tables,
     FR-FCFS on 4-bank-group tables profiled from the same 96 DIMMs, the
     in-order walker on the whole-DIMM tables, and the in-order grid behind
     ``speedup_summary`` at 1/2/4/8 cores (4 ``bank_sched`` launches) — and
     holds the integer totals of base + 8 whole-DIMM and base + 4 per-bank
     tables, and the in-order grid, against the port run on the CPU; all 4
     launches must take the fast kernel;
 10. holds the ``fail_prob_op`` kernel against its plain version bit for bit
     (``torch.equal``) for all four (voltage, retention) flag pairs at (96,
     16, 512, 512) on the Fig 7 operating point's coefficients, at a ragged
     shape, at phase 2's tiling-edge shapes and with ``open_bitline=False``,
     and with both flags off against the ``fail_prob`` kernel; times kernel
     and plain version with both flags on;
 11. holds the ``bit_signature`` kernel against its plain version
     (``torch.equal``) at the blind-discovery shape (768, 512), at nbits 1
     and 12 and N in {1, 100,003}; times kernel, plain version and the
     ``torch.matmul`` yardstick at (262,144, 512);
 12. operating points of the 96 DIMMs (``operating_points_population``: the
     timing table, min-safe supply and max-safe refresh interval with the
     retention channel) and the 4-point operating grid — no kernel launch,
     as in the reference — held against the CPU port on 8 DIMMs;
 13. the fleet error summary at an operating point (tRAS 25 ns, 85 C,
     256 ms, 1.20 V, retention; chunks of 40: 3 ``fail_prob_op`` launches)
     and at nominal supply without retention (3 ``fail_prob``), a ragged
     stream of 8 DIMMs held against the CPU port;
 14. blind discovery: ``campaign_counts`` (tRP 10 / 7.5 / 5 ns, 96
     ``fail_prob_rows`` launches), ``BlindDiva.discover`` (6 ``bit_signature``
     launches) and ``blind_vs_oracle``; the expectations of 4 DIMMs, every
     discovery decision on the same counts and the blind tables of 8 DIMMs
     held against the CPU port;
 15. checks the ``rc_transient`` kernel's fast divisions against IEEE
     division on every float32 operand of their ranges, for the divisors of
     each circuit the port launches it with (8 segments, 4, and 16 at dt
     0.004 ns); holds the kernel against its plain version bit for bit
     (``torch.equal``) on the sense map of one 512x512 mat (262,144 cells,
     every warp on one shared tap), at ragged N in {1, 130, 100,003} (mixed
     taps), with uncharged cells (``sense_t`` all ``inf``), with ``n_seg=4``,
     ``t_pre_ns=12`` and with 16 segments; prints the cells rerun with IEEE
     divisions and each case's tap route; times kernel and plain version;
 16. the Appendix B circuit path: ``fit_latency_coefficients``, the
     ``appB_spice`` restore run and the mat's sense map (1 ``rc_transient``
     launch), held against the CPU port (coefficients and sense times on the
     same step, 4,096 map cells within phase 15's bound);
 17. the lifetime lifecycle (Sec 6.1, no kernel launch, as in the
     reference): ``fig_lifetime`` on the 96 DIMMs (ages 0-10 in 6 epochs,
     55 C, diagnostics), per-bank (4 banks) on 16, Fig 18's ``ALDRAM`` beside
     ``diva_profile`` at 55/85 C and a ``DivaProfiler`` over 4 epochs; the
     lifecycle of 4 DIMMs (timings and stale decisions identical, ECC
     exposure within rtol 1e-3) and the served tables held against the CPU
     port;
 18. holds the ``wkv6`` kernel against its plain version (``y`` and the final
     state within rtol = atol = 3e-4 for float32 inputs, 2e-3 for float16,
     the reference's kernel-against-scan bounds) at the rwkv6-1.6b prefill
     shape (8, 512, 32, 64) from a zero and from a nonzero state, the decode
     shape (8, 1, 32, 64) from a nonzero state, the reference's sweep shapes
     (1,64,1,8), (2,96,2,16), (3,130,4,32), (2,64,2,64), float16 inputs,
     sequence lengths around the kernel's 12-step chunk (11, 12, 13, 25) and
     the serving path's dtypes (``k``/``v`` bfloat16, ``r``/``wlog``
     float32); times kernel and plain version at both serving shapes, and at
     the decode shape also the kernel alone (200 launches queued back to back
     between one pair of CUDA events) and the wrapper's host time per call;
 19. RWKV-6 serving at full width: ``rwkv6-1.6b`` (24 layers, d_model 2048,
     vocab 65536, bfloat16 compute) with random parameters from a seed,
     ``generate`` of 8 prompts of 512 tokens (``make_batch``) and 32 new
     tokens (``wkv6`` launched exactly 24 x 32 = 768 times, no other kernel);
     then, on the card at full width in float32 compute, decode held against
     teacher-forced ``forward`` (prefill 6 tokens, decode 4; the reference's
     2e-3 / 5e-3 bounds), and the card held against the port on the CPU at
     full width cut to 2 layers, float32 compute, one set of host parameters
     on both: prefill and 4 decode steps' logits within 1e-4, greedy tokens
     identical; and the same 2 layers in bfloat16 compute, teacher-forced on
     one token sequence: the card's logits held to the CPU's by their max
     and mean |difference| (0.07 / 0.010), and two faulty ports (the whole
     model in float32; ``r`` in bfloat16) must fall outside those bounds;
 20. the DIMM-fleet timing-table service (``FleetServer``, Sec 6.1's online
     DIVA Profiling as a service) on ``synthetic_fleet(512, FULL)`` in chunks
     of 128: ingest (the campaign's row lambdas, 32 ``fail_prob_rows`` launches a
     campaign point, plus as many in a chunk that founds generations;
     ``bit_signature`` for signatures and scramble recovery), 100,000
     queries, the serve bench's oracle gate (the HIT / DISCOVER tables of
     the first 64 DIMMs equal to the dense DIVA sweep, up to 8 CONVENTIONAL
     ones to the every-row sweep, bit for bit), a tick at the fleet's
     smallest re-profile horizon, and a checkpoint (``secded_encode`` and
     ``diva_shuffle`` a leaf) with one 8-bit run flipped in a leaf's lanes,
     restored into a fresh server (``diva_shuffle`` and ``secded_syndrome``
     a leaf) that must serve identical tables, labels, paths and deadlines;
 21. the service on the reference test's fleet (128 TINY DIMMs, chunks of
     64) on the card and on the CPU, both fed the card's campaign counts:
     stats, state and founding stats identical; the draws that differ when
     each host samples its own lambdas are counted; then the serving CLI
     (``launch.serve.main --fleet 256 --chunk 128`` with a checkpoint, a
     metrics file and a trace) on the card;
 22. the streamed scans over the 96 DIMMs in chunks of 40 (the last one
     ragged) against the dense card results: ``stream_profile_population``
     against phase 4's DIVA tables, ``stream_operating_grid`` against phase
     12's grid, ``stream_lifetime_population`` against phase 17's lifecycle,
     ``stream_shuffling_gain`` against phase 6's counts,
     ``stream_bit_signature`` against the dense signatures of phase 14's
     counts, ``stream_secded_scrub`` over phase 8's flipped codewords
     against its decode, and ``stream_discover_generations`` on
     ``synthetic_fleet(512, FULL)`` at chunk sizes 128 and 100;
 23. holds the ``wkv6_bwd`` kernel (the VJP of the recurrence) against its
     plain version (float32 gradients within rtol = atol = 1e-3, gradients
     stored in bfloat16 within rtol 8e-3, atol 1e-3) at the training shape
     (8, 512, 32, 64) in float32, with the training path's dtypes (``k``/``v``
     bfloat16) and with a start state and a final-state cotangent, and at
     edge shapes (S = 1, S around the kernel's 8-step chunk, dh 8 to 64, a
     single cluster, an odd H); checks that two runs give the same bits;
     prints the kernel's blocks and clusters resident per SM and card and
     its registers, and fails if ptxas or the runtime report a spill; times
     kernel and plain version;
 24. RWKV-6 training at full width and depth: ``launch.train.main`` on
     ``rwkv6-1.6b`` (24 layers, d_model 2048, 1.48B random float32
     parameters, bfloat16 compute, per-layer remat, AdamW), 8 steps of 8 x
     512 tokens (exactly 48 ``wkv6``, 24 ``wkv6_bwd`` and 1 ``adamw``
     launches a step, no other kernel); prints the step times, tokens/s,
     the memory peak and the losses, which must be finite; then one more
     step under
     ``torch.profiler``: its kernel time by group (matmuls, float32 ones
     among them, ``wkv6``, ``wkv6_bwd``, the rest) and the device's idle
     share; then the card against the port on the
     CPU at full width cut to 2 layers, float32 compute, batch 2 x 128, one
     set of host parameters on both: the loss (rtol 1e-5), the gradients'
     global norm (rtol 1e-4) and every gradient leaf (within 1e-3 of the
     leaf's largest |CPU gradient|);
 25. the DIVA path with the DIMM axis split over a mesh (``mesh=``): on
     ``DimmMesh([cuda:0] * N)`` for N = 1, 2, 5 (5 pads the 96 DIMMs to 100
     with clones of the last), and on ``dimm_mesh()`` when more than one card
     is visible, each entry point beside its unsharded run:
     ``row_error_lambda`` (tRP 7.5 ns) against phase 3, the DIVA profile
     against phase 4, ``burst_bit_profile_population`` +
     ``shuffling_gain_population`` against phase 6, FR-FCFS
     ``system_speedup_population`` on the whole-DIMM tables at n = 20,000
     against phase 9's totals, ``stream_error_summary`` at the operating
     point and at nominal in chunks of 40 against phase 13,
     ``bit_signature_population`` + ``recover_mapping_population`` on phase
     14's counts against the unsharded call, and ``lifetime_population``
     over 2 epochs at N = 2 against phase 17's first 2.  Tables, decisions,
     counts, signatures, mappings, Fig 19 totals and hot cells identical;
     lambdas, fleet lambdas and ECC exposure within rtol 1e-5, burst-bit
     profiles within phase 6's bounds, the fleet cell-sum (the shards'
     float32 partials added in mesh order) within rtol 1e-6; a sharded run
     launches each kernel exactly N times as often as the unsharded one.
     Prints the seconds of every run, sharded and not, the launches and the
     largest float gap.  A repeated card measures the cost of the split and
     the gather, not a speed-up across cards;
 26. the dense and MoE families serving, bfloat16 compute, random parameters
     from seed 0 (no port kernel: every run must launch none):
     ``qwen2-0.5b`` at full width and depth (24 layers, d_model 896, 14 / 2
     heads, vocab 151,936, tied embeddings, QKV bias) and ``qwen2.5-3b`` (36
     layers, head_dim 128, 16 / 2 heads), each ``generate`` of 8 prompts of
     512 tokens and 32 new tokens (prefill s, decode s, tok/s, memory peak);
     ``qwen2-0.5b`` with the int8 KV cache (its bytes against the bfloat16
     cache's, the share of greedy tokens that agree with the bfloat16 run,
     reported, not gated); a 4096-token prompt, batch 1, 8 new tokens, whose
     prefill takes blockwise attention, and on one layer's q, k, v at that
     length ``blockwise_attention`` held to ``full_attention`` (float32:
     rtol = atol = 1e-5; bfloat16: 2**-7 |full| + 2**-8 max |v|); then
     ``moonshot-v1-16b-a3b`` at full width (64 experts, top 6, d_ff 1408,
     vocab 163,840) cut to 4 of its 48 layers, the same 8 x 512 + 32, with
     the assignments its capacity drops; decode against teacher-forced
     ``forward`` in float32 on the card (prefill 8, decode 4; 2e-4 / 2e-3);
     and the card against the CPU port at full width cut to 2 layers,
     float32, batch 2 x 64, one set of host parameters, for ``qwen2-0.5b``
     and moonshot: prefill and 4 decode steps' logits and the caches within
     1e-4, greedy tokens and ``generate`` identical, every routing call's
     expert ids, positions and kept assignments identical;
 27. dense training at full width and depth: ``launch.train.main`` on
     ``qwen2-0.5b`` (float32 master weights, bfloat16 compute, per-layer
     remat, AdamW), 8 steps of 8 x 512 tokens (no port kernel but the
     optimizer's: an ``adamw`` launch a step): step times,
     tokens/s, memory peak, finite losses; one more step under
     ``torch.profiler`` (kernel time by group, idle share); the card against
     the CPU port at 2 layers in float32, batch 2 x 128 (phase 24's bounds);
     then 2 steps of moonshot at full width cut to 2 layers (1.81B
     parameters): finite losses, a nonzero aux loss, the memory peak;
 28. the hybrid, vlm and audio families serving, bfloat16 compute, random
     parameters from seed 0 (no port kernel: every run must launch none):
     ``jamba-1.5-large-398b`` cut to one period-8 block (8 of 72 layers: 7
     Mamba + 1 attention sublayer, 4 dense + 4 MoE FFNs) at full width with
     4 of its 16 experts (top 2; 16.2B parameters, 32.5 GB: all 16 experts
     do not fit), ``generate`` of 8 prompts of 512 tokens and 32 new
     (prefill s, decode s, tok/s, memory peak, the share of the prefill's
     assignments its capacity drops); ``paligemma-3b`` at full width and
     depth, 8 x (256 patches + 256 text tokens) + 32 new; ``whisper-medium``
     at full width and depth, 8 x (1500 frames + 384 text tokens) + 32 new;
     decode against teacher-forced ``forward`` in float32 on the card,
     paligemma and whisper at full width cut to 2 layers (whisper 2 + 2;
     prefill 8 text tokens, decode 4; 2e-4 / 2e-3); and the card against the
     CPU port in float32, one set of host parameters: paligemma and whisper
     at full width cut to 2 layers, batch 2 x 64 text tokens plus all
     patches / frames, and Jamba at its smoke widths with a 2 x 256 prompt
     (the Mamba scan's chunked path): prefill and 4 decode steps' logits and
     the caches within 1e-4, greedy tokens and ``generate`` identical, every
     routing call's expert ids, positions and kept assignments identical;
 29. the families training: ``launch.train.main`` on ``whisper-medium`` at
     full width and depth (float32 master weights, bfloat16 compute,
     per-layer remat, AdamW), 8 steps of 8 x 448 decoder tokens with 1500
     frames each: step times, tokens/s, memory peak, finite losses; one more
     step under ``torch.profiler``; ``paligemma-3b`` at full width cut to 8
     of 18 layers (18 do not fit with AdamW), 3 steps of 8 x 512 positions;
     Jamba at its smoke widths in bfloat16 under Adafactor, 3 steps of 8 x
     512 tokens (the scan's chunked path under the block's remat): finite
     losses, a nonzero aux loss; the card against the CPU port in float32
     (phase 24's bounds) for whisper cut to 2 + 2 layers at 2 x 128 and
     Jamba at smoke widths at 2 x 256;
 30. the training mesh over NCCL: a one-rank NCCL process group (a
     ``HashStore``, no port) and ``make_host_mesh()`` on it (1 x 1, its
     groups real: every collective of the sharded step runs through NCCL);
     ``qwen2-0.5b`` at full width and depth, 3 sharded steps of 8 x 512
     (``make_sharded_train_step``) against 3 unsharded steps from the same
     seed: metrics and parameters within rel 1e-5 (bit-identical reported);
     ``moonshot-v1-16b-a3b`` at full width cut to 1 of 48 layers, the ep and
     a2a paths' float32 logits on 4 x 512 tokens against the local path's
     (rtol = atol = 2e-5, ``tests/test_sharding_moe.py``'s bounds), routing
     identical, then 2 sharded steps of each in bfloat16 compute (finite, a
     nonzero aux loss), each of these runs counted from 0 (no kernel but the
     optimizer's may launch: an ``adamw`` launch a sharded AdamW step);
     ``rwkv6-1.6b`` at full width cut to 4 of 24 layers,
     2 sharded steps of 8 x 512 (exactly 16 ``wkv6``, 8 ``wkv6_bwd`` and 2
     ``adamw`` launches, counted into the ``kernels`` line), losses equal to 2
     unsharded steps'; ``compress_grads`` over qwen's gradients on the card
     against the CPU (q, scales and residuals identical); a sharded save of
     a moonshot smoke state trained one step on the mesh, restored with
     ``shardings=`` from its shards, bit for bit, the codec's launches
     counted (``secded_encode`` and ``diva_shuffle`` a leaf to save,
     ``diva_shuffle`` and ``secded_syndrome`` a leaf to restore, into the
     ``kernels`` line); each step's seconds sharded and unsharded,
     the memory peaks and the bytes of the gathered copies; the group is
     destroyed at the end;
 31. the dry run and the roofline (``launch/dryrun.py``; no new kernel):
     (a) three cells traced in the fake world of the production meshes on
     the host's CPU, ``qwen2-0.5b train_4k`` and ``rwkv6-1.6b train_4k`` on
     (16, 16) (48 ``wkv6`` and 24 ``wkv6_bwd`` calls counted by the kernels'
     formulas) and ``jamba-1.5-large-398b long_500k`` on (2, 16, 16), each
     with its per-rank FLOPs, bytes, collectives, memory peak and the three
     H100 roofline terms; (b) predicted against measured on the 1 x 1 mesh:
     the sharded ``qwen2-0.5b`` train step at 8 x 512 (phase 30's step),
     ``rwkv6-1.6b`` sharded prefill at 8 x 512 and one sharded train step of
     ``rwkv6-1.6b`` cut to 4 layers at 8 x 512, each dry-run on fake tensors
     and then run on the card under the same counter (the kernels counted by
     the same formulas), fresh: the FLOPs by dtype identical, the predicted
     peak within 15% of ``max_memory_allocated`` (above what the card held
     before), the ``wkv6`` / ``wkv6_bwd`` launches equal to the calls the dry
     run counted; each step then timed without the counter beside its three
     roofline terms (exactly 64 ``wkv6``, 8 ``wkv6_bwd`` and 4 ``adamw``
     launches over the phase, into the ``kernels`` line);
 32. the optimizer phase's kernels (``kernels/adamw.py``) at rwkv6-1.6b's
     19 float32 leaves (1.48B elements): ``grad_sq_norm`` within 1e-6 of its
     plain version and the same bits twice, ``adamw_update`` at that scale
     against its plain version bit for bit, leaf by leaf, and at odd
     bfloat16 leaves (one 1-d, so without decay) bit for bit; each timed beside
     its bytes bound (4 and 28 bytes an element), the plain clip and update
     timed, and PyTorch's ``torch._fused_adamw_`` on the same leaves as a
     yardstick of speed (another formula).

Every training step launches the optimizer's kernels: ``adamw`` once a
table of up to 32 leaves a step under AdamW, and ``make_train_step``'s norm
``grad_sq_norm`` once a table and once more (the sharded step sums its own
norm); each training path's expected counts include them.

Every phase prints one JSON line.  The launch counts are set to 0 just before
each path (phases 3-4, 6, 7, 8, 9, 12, 13, 14, 16, 17, 19, 20 (ingest; tick
and checkpoint), 21, each scan of 22, 24, each run of 25, and each serving
and training run of 26-29, 30's rwkv6 sharded run, and 31(b)) and read just
after it;
every kernel of a path must have launched (26-29: none but the
optimizer's may), and the ``kernels`` line sums the paths' counts.
Any failed check raises; the last line is ``{"ok": true, "device": {...}}``
only when all passed.  Exits non-zero, printing no result, when no CUDA
device is available.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.registry import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.geometry import FULL, TINY  # noqa: E402
from repro_torch.core.latency import (  # noqa: E402
    DEFAULT_PATTERNS, PATTERN_STRESS, access_vdd_shift, retention_stress)
from repro_torch.core.packing import unpack_bool  # noqa: E402
from repro_torch.core.population import (  # noqa: E402
    make_population, synthetic_fleet)
from repro_torch.core.profiling import (  # noqa: E402
    ALDRAM, DivaProfiler, conventional_profile, diva_profile,
    latency_reduction)
from repro_torch.core.shuffling import design_stripe_profiles  # noqa: E402
from repro_torch.core.spice import (  # noqa: E402
    CircuitParams, fit_latency_coefficients, n_steps, restored_voltage,
    sense_time, simulate, step_phases, step_times)
from repro_torch.core.streaming import (  # noqa: E402
    PopulationStream, hash_poisson_counts, stream_bit_signature,
    stream_discover_generations, stream_error_summary,
    stream_lifetime_population, stream_operating_grid,
    stream_profile_population, stream_secded_scrub, stream_shuffling_gain)
from repro_torch.core.substrate import (  # noqa: E402
    DimmBatch, _geom_consts, _pack_coeffs, _pack_op_coeffs,
    burst_bit_profile_population, condition_adders, lifetime_population,
    operating_grid_arrays, operating_points_population,
    profile_population_arrays, row_error_lambda, shuffling_gain_population)
from repro_torch.core.timing import OperatingPoint, TimingParams  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.discovery.blind import (  # noqa: E402
    BlindDiva, blind_vs_oracle, campaign_counts)
from repro_torch.discovery.recover import (  # noqa: E402
    recover_mapping_population)
from repro_torch.discovery.signatures import (  # noqa: E402
    bit_signature_population)
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.adamw import (  # noqa: E402
    MAX_LEAVES as ADAMW_MAX_LEAVES, adamw_update, adamw_update_ref, adamw_update_work,
    grad_sq_norm, grad_sq_norm_ref, grad_sq_norm_work)
from repro_torch.kernels.bank_sched import (  # noqa: E402
    ROUTES, memsim_walk, memsim_walk_ref, walk_route)
from repro_torch.kernels.bank_sched import _launch as bank_sched_launch  # noqa: E402
from repro_torch.kernels.bit_signature import (  # noqa: E402
    bit_signature, bit_signature_ref)
from repro_torch.kernels.fail_prob import (  # noqa: E402
    division_check, fail_prob, fail_prob_op, fail_prob_op_ref, fail_prob_ref)
from repro_torch.kernels.rc_transient import (  # noqa: E402
    launch_divisors, rc_transient, rc_transient_ref, reset_route_counts,
    route_counts)
from repro_torch.kernels.rc_transient import (  # noqa: E402
    division_check as rc_division_check)
from repro_torch.kernels.secded import (  # noqa: E402
    encode_checks, encode_checks_ref, syndrome, syndrome_ref)
from repro_torch.kernels.shuffle import (  # noqa: E402
    _perm_tensor, apply_shuffle, apply_shuffle_ref, shuffle_permutation)
from repro_torch.kernels.wkv6 import DH as WKV_DH  # noqa: E402
from repro_torch.kernels.wkv6 import (  # noqa: E402
    wkv6, wkv6_bwd, wkv6_bwd_ref, wkv6_bwd_resources, wkv6_bwd_work, wkv6_ref,
    wkv6_work)
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.counting import WorkCounter  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.roofline import roofline_terms  # noqa: E402
from repro_torch.sharding import counting_mesh, reset_collectives  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.steps import (abstract_state, make_sharded_train_step,  # noqa: E402
                                      make_train_step, state_shardings)
from repro_torch.runtime.compression import compress_grads, init_compression_state  # noqa: E402
from repro_torch.launch.train import build_state  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import cache as model_cache  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.layers import apply_norm  # noqa: E402
from repro_torch.obs import REGISTRY  # noqa: E402
from repro_torch.memsim import sim as memsim  # noqa: E402
from repro_torch.optim import clip_scale, global_norm  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten  # noqa: E402
from repro_torch.memsys.codec import (  # noqa: E402
    corrupt_run, interleave_permutation, protect_blob, recover_blob)
from repro_torch.sharding import (DimmMesh, dimm_mesh, gather_tree, shard_tree,  # noqa: E402
                                  use_mesh)
from repro_torch.serve import (  # noqa: E402
    PATH_CONVENTIONAL, PATH_DISCOVER, PATH_HIT, FleetConfig, FleetServer,
    take_batch)

N_DIMMS = 96
N_CONVENTIONAL = 8
PAPER_READ, PAPER_WRITE = 0.351, 0.578   # Sec 6.1 / Fig 18 (quickstart.py)
KERNEL_ATOL = 1e-6   # tests/test_fail_prob_substrate.py's kernel-vs-oracle bound
LAMBDA_RTOL = 1e-5
# H100 SXM (NVIDIA's data sheet): HBM3 rate, fp32 rate outside the tensor
# cores; int32 rate: 64 int32 lanes per SM per clock x 132 SMs x 1.98 GHz
PEAK_BYTES_PER_S, PEAK_FP32_FLOPS, PEAK_INT32_OPS = 3.35e12, 67e12, 16.7e12
# fp32 operations fail_prob needs per cell, whatever the kernel does: the
# terms of t that depend only on the row, the column or the mat are paid per
# row, column or mat, so a cell costs its 3 adds of t and the two-channel
# mixture, 54 (each channel 25: the subtraction, 2 divisions, |x|, the
# reciprocal's product, sum and division, 9 for the polynomial, x*x, the
# negation, exp (one op), its product, 1 - ..., the sign's select and
# product, 1 + ..., 0.5*...; then t + outlier_ns and the two weighted terms)
FAIL_PROB_FLOPS_PER_CELL = 57
# shapes at the edges of the kernel's tiling (32-row tiles, 4 x 128 columns
# a block): (D, M, R, C, open_bitline)
FP_EDGES = ((1, 1, 33, 5, True), (1, 2, 70, 96, False), (2, 1, 40, 1000, True),
            (2, 3, 31, 1000, False), (1, 1, 65, 7, True))
# DIVA Shuffling path (Fig 17) and codec
N_ACCESSES = 2000                 # accesses per DIMM, profiled population
PROB_RTOL, PROB_ATOL = 1e-5, 1e-7
N_COUNT_CHECK = 8                 # DIMMs whose counts the CPU port re-derives
PAPER_GAIN, PAPER_RECOVERED = 0.26, 0.925   # benchmarks/paper_figures.py:285,308
SYN_ROWS = 2 * N_DIMMS * N_ACCESSES * 8     # both layouts' codewords: 3,072,000
SHUFFLE_ROWS = N_DIMMS * N_ACCESSES         # bursts per shuffle: 192,000
BLOB_BYTES = 64 << 20             # a checkpoint leaf (checkpoint/manager.py:87)
ENCODE_ROWS = BLOB_BYTES // 8               # its codewords: 8,388,608
CHECK_BYTES = 1 << 20             # prefix whose lanes the CPU port re-derives
N_RUNS, RUN_BITS = 1000, 8
RAGGED = (1, 1000003)
# Fig 19 memory system (memsim)
MEMSIM_N = 20000                  # requests per workload trace (the default)
MEMSIM_PLAIN_N = 2000             # n of the kernel-vs-plain checks and plain time
MEMSIM_CPU_DIMMS, MEMSIM_CPU_BANK_DIMMS = 8, 4   # re-derived on the CPU
PAPER_SPEEDUP = {1: 0.092, 2: 0.147, 4: 0.137, 8: 0.138}   # Sec 6.3, Fig 19
# int32 operations counted from csrc/bank_sched.cu with the bus and the
# activation window on: per queued candidate (21 + 5 for tRRD/tFAW + 2 for the
# bus) and per step (the winner's reductions, the state update, output, refill)
BANK_SCHED_CANDIDATE_OPS, BANK_SCHED_STEP_OPS = 28, 48
# operating points: fp32 operations the voltage shift (t + shift) and the
# retention channel add to fail_prob's per cell: the slowness's 3 adds,
# margin = ret_base - ret_k*slow (2), its negation, the mixture (54) and the
# add to p
OP_VOLTAGE_FLOPS, OP_RETENTION_FLOPS = 1, 61
OP_FLAGS = ((False, False), (True, False), (False, True), (True, True))
OP_PARAM, OP_T, OP_TEMP, OP_REFRESH, OP_VDD = "tras", 25.0, 85.0, 256.0, 1.20
OP_CHUNK, OP_CPU_DIMMS, OP_CPU_CHUNK = 40, 8, 5
# tests/test_operating_point.py's grid
OP_POINTS = [OperatingPoint(), OperatingPoint(vdd=1.05),
             OperatingPoint(refresh_ms=256.0, temp_C=75.0),
             OperatingPoint(timing=TimingParams(10.0, 25.0, 10.0, 10.0),
                            vdd=1.20)]
# blind discovery: 96 DIMMs x 8 subarrays of 512 rows per signature pass
SIG_PATH_ROWS, SIG_ROWS, SIG_NBITS = N_DIMMS * 8, 262144, 9
SIG_RAGGED, SIG_NBITS_EXTRA = (1, 100003), (1, 12)
BLIND_CPU_EXPECTED_DIMMS, BLIND_CPU_TABLE_DIMMS = 4, 8
# Appendix B circuit model: the sense map of one mat at the benchmark width
MAT = 512
RC_RAGGED = (1, 130, 100003)
RC_CPU_STRIDE = 64                # every 64th map cell re-derived on the CPU
# every circuit the port's paths and tests launch rc_transient with (16
# segments need the shorter step for the Euler stability bound)
RC_CIRCUITS = {"n_seg8": CircuitParams(), "n_seg4": CircuitParams(n_seg=4),
               "n_seg16_dt004": CircuitParams(n_seg=16, dt_ns=0.004)}
# repro.core.spice on a CPU (fit_latency_coefficients and the appB_spice
# restore run; tests/test_torch_spice.py holds the CPU port to repro's)
APPB_REFERENCE = dict(t0_ns=7.63, k_bl_ns=1.044, k_wl_ns=0.180,
                      restore_loss_far_mV=30.35)
# lifetime (Sec 6.1): fig_lifetime's schedule, at FULL scale
LIFE_AGES = np.linspace(0.0, 10.0, 6).astype(np.float32)
LIFE_TEMP, LIFE_BANK_DIMMS, LIFE_CPU_DIMMS, PROFILER_EPOCHS = 55.0, 16, 4, 4
# The ECC exposure sums multi-bit tails, 1-(1-q)^72 - 72q(1-q)^71, whose two
# terms (~72q) cancel to ~2556q^2: an ulp of expm1/log1p is amplified by
# ~0.03/q.  The float32 sums sit ~1e-4 (relative) from a float64 evaluation
# of the same formula (tests/test_torch_lifetime.py), and the card's
# expm1f/log1pf are not the CPU's (card vs CPU measured up to 2.4e-4 on an
# H100).  Timings and stale decisions stay identical.
ECC_RTOL = 1e-3
# RWKV-6 serving (rwkv6-1.6b): the kernel at the serving path's shapes, the
# reference's kernel-against-scan bounds (tests/test_kernels.py:59-68)
ARCH = "rwkv6-1.6b"
WKV_PREFILL, WKV_DECODE = (8, 512, 32, 64), (8, 1, 32, 64)
WKV_SWEEP = ((1, 64, 1, 8), (2, 96, 2, 16), (3, 130, 4, 32), (2, 64, 2, 64))
WKV_TOL = {torch.float32: 3e-4, torch.float16: 2e-3}
# sequence lengths around the kernel's chunk of 12 steps (kT, csrc/wkv6.cu)
WKV_CHUNK = 12
WKV_AROUND_CHUNK = (WKV_CHUNK - 1, WKV_CHUNK, WKV_CHUNK + 1, 2 * WKV_CHUNK + 1)
WKV_DECODE_RUN = 200   # decode-shape launches timed back to back
SERVE_SEED, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 0, 8, 512, 32
# decode against teacher-forced forward (tests/test_models.py:69-82's bounds)
TF_PROMPT, TF_DECODE, TF_PREFILL_TOL, TF_DECODE_TOL = 6, 4, 2e-3, 5e-3
# the card against the port on the CPU: full width cut to 2 layers, float32
CPU_LAYERS, CPU_BATCH, CPU_PROMPT, CPU_DECODE, CARD_CPU_TOL = 2, 2, 16, 4, 1e-4
# the same in the config's bfloat16 compute: max and mean |card - CPU| of the
# logits (on an H100: 0.0547 / 0.0082), bounds between that reading and two
# faulty ports' (the whole model in float32: 0.118 / 0.0178; r in bfloat16,
# i.e. ``wr`` cast with the other weights: 0.078 / 0.0123)
BF16_CARD_CPU_MAX, BF16_CARD_CPU_MEAN = 0.07, 0.010
# the DIMM-fleet timing-table service (serve/server.py: Sec 6.1's online DIVA
# Profiling as a service) on a synthetic fleet at the benchmark geometry
FLEET_GEOM, FLEET_DIMMS, FLEET_CHUNK = FULL, 512, 128
FLEET_ORACLE_DIMMS, FLEET_ORACLE_CONV = 64, 8   # serve_bench.py:54's gate
FLEET_QUERIES = 100_000
FLEET_FLIP_LEAF, FLEET_FLIP_LANE, FLEET_FLIP_BITS = "fleet_table", 100, 8
# the service on the card against the CPU port: tests/test_serve.py:24's fleet
TWIN_GEOM, TWIN_DIMMS, TWIN_CHUNK = TINY, 128, 64
CLI_FLEET, CLI_CHUNK = 256, 128   # launch/serve.py --fleet, its CI leg
# the streamed scans against the dense results of phases 4-17
SCAN_CHUNK = 40                   # 96 = 40 + 40 + 16: a ragged last chunk
SCRUB_CHUNK = 1 << 20             # codewords a scrub chunk
DISCOVER_DIMMS, DISCOVER_CHUNKS = 512, (128, 100)
# RWKV-6 training: the backward kernel at the training shape, against its
# plain version (it sums in another order): float32 gradients within rtol =
# atol = 1e-3, gradients stored in bfloat16 within 2 of its ulps (rtol 8e-3)
# and atol 1e-3 (tests/test_torch_train_cuda.py)
WKV_TRAIN = (8, 512, 32, 64)
WKV_BWD_TOL = {torch.float32: (1e-3, 1e-3), torch.bfloat16: (8e-3, 1e-3)}
# S = 1 and S around the kernel's 8-step chunk (kC, csrc/wkv6_bwd.cu); a
# (b, h) is a cluster of 2 blocks (32 rows each at dh = 64, 16 at dh = 32),
# one block at dh <= 16: S not a multiple of 8 at dh = 64, a single cluster
# (B*H = 1), an odd H, S = 1 at each cluster size
WKV_BWD_EDGES = ((1, 1, 2, 64), (2, 7, 3, 8), (2, 9, 3, 16), (2, 17, 3, 32),
                 (2, 130, 2, 64), (1, 21, 1, 64), (3, 13, 5, 64), (1, 37, 1, 32),
                 (2, 1, 3, 32), (1, 1, 1, 16), (3, 1, 1, 8))
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 8
# the card against the port on the CPU: full width cut to 2 layers, float32
# compute; float32 sums in other orders (cuBLAS, the kernels) on the card
TRAIN_CPU_LAYERS, TRAIN_CPU_BATCH, TRAIN_CPU_SEQ = 2, 2, 128
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_GRAD_TOL = 1e-5, 1e-4, 1e-3
# the DIVA path on a DIMM-axis mesh (phase 25): meshes that repeat the card,
# 5 padding the 96 DIMMs to 100; the lifecycle over its first 2 epochs at 2
SHARD_SIZES = (1, 2, 5)
SHARD_LIFE_EPOCHS, SHARD_LIFE_SIZE = 2, 2
# the fleet cell-sum adds the shards' float32 partials in mesh order: the
# reference's bound for its sharded sum (tests/test_streaming.py)
GRID_SUM_RTOL = 1e-6
# the dense and MoE families (phases 26-27): qwen2-0.5b, the reference's
# default arch, and qwen2.5-3b at full width and depth; moonshot-v1-16b-a3b
# at full width, its 48 layers cut to 4 (serving) and 2 (training: ~29 GB of
# float32 parameters, gradients and AdamW moments)
DENSE_ARCH, DENSE_3B, MOE_ARCH = "qwen2-0.5b", "qwen2.5-3b", "moonshot-v1-16b-a3b"
MOE_SERVE_LAYERS, MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 4, 2, 2
# a prompt past the reference's 2048-token full-attention threshold: its
# prefill takes blockwise attention over chunks of 2048 keys
LONG_PROMPT, LONG_NEW = 4096, 8
# blockwise against full attention on one layer's q, k, v at LONG_PROMPT:
# float32 sums the same 4096 weighted values in two chunks with a rescale
# (1e-6 at outputs of order 1); in bfloat16, full_attention rounds its
# weights to bfloat16 before the second product (at most 2**-9 of each
# weight: 2**-9 of max |v| over the sum) and both round the output (2**-8
# of it), so |blockwise - full| <= 2**-7 |full| + 2**-8 max |v|
BLOCKWISE_F32_TOL = 1e-5
BLOCKWISE_BF16_RTOL, BLOCKWISE_BF16_VTOL = 2.0 ** -7, 2.0 ** -8
# decode against teacher-forced forward in float32 (tests/test_models.py:52-66)
DENSE_TF_PROMPT, DENSE_TF_DECODE = 8, 4
DENSE_TF_PREFILL_TOL, DENSE_TF_DECODE_TOL = 2e-4, 2e-3
# the card against the CPU port: full width cut to 2 layers, float32
DENSE_CPU_BATCH, DENSE_CPU_PROMPT = 2, 64
# the hybrid, vlm and audio families (phases 28-29).  jamba-1.5-large-398b:
# one period-8 block (8 of its 72 layers) at full width (d_model 8192,
# d_inner 16384, 64 / 8 heads, d_ff 24576, vocab 65536) with 4 of its 16
# experts, top 2 kept so that routing still decides: 16.2B parameters, 32.5
# GB in its bfloat16 (with all 16 experts 45.2B, ~90 GB: over the card).
# Init draws each leaf in float32 and scales it in place: the largest, the
# block's 4 MoE sublayers' experts (1, 4, 4, 8192, 24576), 3.2B elements,
# holds a 12.9 GB float32 temporary, a peak of ~45 GB
JAMBA, PALIGEMMA, WHISPER = "jamba-1.5-large-398b", "paligemma-3b", "whisper-medium"
JAMBA_LAYERS, JAMBA_EXPERTS = 8, 4
# paligemma-3b serves 8 x (256 patches + 256 text tokens): SERVE_PROMPT
# positions; whisper-medium 8 x (1500 frames + 384 text tokens), + 32 new
# within its 448-token text context, and trains on 8 x 448
WHISPER_PROMPT, WHISPER_TRAIN_SEQ = 384, 448
# paligemma trains at full width cut to 8 of 18 layers: AdamW costs ~29.5
# bytes a parameter in this port (moonshot at 2 layers: 1.81B -> 53.5 GB), so 18
# layers (2.51B) need ~74 GB beside the 257,216-wide logits; 8 layers
# (1.41B) ~42 GB and ~10 GB of logits and their gradients.  Jamba trains at
# its smoke widths: a full-width block does not fit at any expert count
# that still routes (its bfloat16 parameters, gradients and new values,
# plus Adafactor's float32 temporaries, ~13 GB each over a 3.2B-element
# expert leaf)
PALIGEMMA_TRAIN_LAYERS, FAMILY_TRAIN_STEPS = 8, 3
# the card against the CPU port in float32: paligemma and whisper at full
# width cut to 2 layers (whisper 2 + 2), 2 x 64 text tokens and all patches
# or frames; Jamba at smoke widths with 2 x 256 tokens, past the scan's
# 128-step chunk (training the same at 2 x 256)
FAMILY_CPU_LAYERS, FAMILY_CPU_PROMPT, JAMBA_CPU_PROMPT = 2, 64, 256
# the training mesh (phase 30) at world size 1 over NCCL: qwen2-0.5b whole
# (3 steps, sharded against unsharded), moonshot at full width cut to 1 of 48
# layers (1.25B parameters: AdamW's ~29.5 bytes a parameter plus the
# gathered copy of the parameters, ~42 GB), 4 x 512 tokens; rwkv6-1.6b at
# full width cut to 4 of 24 layers, 2 steps of 8 x 512
MESH_STEPS, MESH_MOE_LAYERS, MESH_MOE_BATCH, MESH_MOE_STEPS = 3, 1, 4, 2
MESH_RWKV_LAYERS, MESH_RWKV_STEPS = 4, 2
MESH_RTOL, MOE_PATH_TOL = 1e-5, 2e-5
# the dry run and the roofline (phase 31): three cells in the fake world,
# then three steps predicted against the card on the 1 x 1 mesh, each run
# twice on the card (counted, then timed): rwkv6-1.6b prefill (24 wkv6
# launches a run) and its 4-layer train step (4 layers: forward and the
# remat's recompute, 8 wkv6 and 4 wkv6_bwd launches a run)
DRYRUN_CELLS = (("qwen2-0.5b", "train_4k", False), ("rwkv6-1.6b", "train_4k", False),
                ("jamba-1.5-large-398b", "long_500k", True))
PREDICT_BATCH, PREDICT_SEQ, PREDICT_RWKV_LAYERS = 8, 512, 4
PREDICT_WKV6, PREDICT_WKV6_BWD = 2 * (24 + 2 * PREDICT_RWKV_LAYERS), 2 * PREDICT_RWKV_LAYERS
PEAK_RTOL = 0.15
# the optimizer phase (phase 32): runs of each timing, and its edge: odd
# leaves in bfloat16, one 1-d (no decay)
ADAMW_REPS, ADAMW_PLAIN_REPS = 20, 5
ADAMW_EDGE = ((3, 5, 7), (1001,), (2, 3, 33))
# phases 3-17 keep the dense results that phases 22 and 25 hold the scans and
# the sharded runs to
DENSE: dict = {}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, reps: int, warm_up: bool = True) -> float:
    """Median milliseconds of ``fn`` on the card over ``reps`` runs (CUDA
    events), after one warm-up run unless the caller has just run it."""
    if warm_up:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def grid_exact(kernel_fn, plain_fn, row_src, d_mat, coeffs, **kw) -> float:
    """A fail_prob or fail_prob_op grid against its plain version on the same
    inputs: finite and equal bit for bit, or raise.  Returns max |kernel -
    plain| (0.0)."""
    k = kernel_fn(row_src, d_mat, coeffs, **kw)
    r = plain_fn(row_src, d_mat, coeffs, **kw)
    torch.cuda.synchronize()
    if k.shape != r.shape or not torch.isfinite(k).all() or not torch.equal(k, r):
        raise AssertionError(
            f"{kernel_fn.__name__} differs from its plain version at "
            f"{tuple(k.shape)} ({kw}): max |diff| "
            f"{float((k - r).abs().max()) if k.shape == r.shape else None}")
    return float((k - r).abs().max())


def edge_inputs(D, M, R, coeffs, d_mat, seed):
    """Seeded row sources (D, R) in [0, R), the first D coefficient rows with
    the t terms jittered, and the first M mat delays, on the card."""
    rng = np.random.default_rng(seed)
    dev = coeffs.device
    rows = torch.as_tensor(rng.integers(0, R, (D, R)), dtype=torch.int32, device=dev)
    cf = coeffs[:D].clone()
    cf[:, :6] += torch.as_tensor(rng.normal(0, 0.05, (D, 6)), dtype=torch.float32,
                                 device=dev)
    return rows, d_mat[:M].contiguous(), cf


def bits(rows: int, width: int, dev, seed: int) -> torch.Tensor:
    """Seeded 0/1 int32 (rows, width) on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 2, (rows, width), generator=gen, device=dev,
                         dtype=torch.int32)


def exact(kernel_fn, plain_fn, x, what: str) -> float:
    """Kernel against its plain version on ``x``: equal bit for bit, or
    raise.  Returns max |kernel - plain| (0.0)."""
    k, r = kernel_fn(x), plain_fn(x)
    torch.cuda.synchronize()
    if k.shape != r.shape or not torch.equal(k, r):
        raise AssertionError(f"{what} differs from its plain version at "
                             f"{tuple(x.shape)}")
    return float((k - r).abs().max()) if k.numel() else 0.0


def int_kernels_vs_plain(dev) -> dict:
    """Phase 5: the three integer kernels against their plain versions at
    the Fig 17 / codec shapes and ragged N; times of kernel, plain version
    and library call.  Returns {kernel name: its ``kernels``-line fields}."""
    bw, flops = PEAK_BYTES_PER_S, PEAK_FP32_FLOPS
    out = {}
    for name, kern, plain, rows, width in (
            ("secded_syndrome", syndrome, syndrome_ref, SYN_ROWS, 72),
            ("secded_encode", encode_checks, encode_checks_ref, ENCODE_ROWS, 64)):
        x = bits(rows, width, dev, seed=width)
        err = exact(kern, plain, x, name)
        for n in RAGGED:
            exact(kern, plain, bits(n, width, dev, seed=n), name)
        n_bytes = rows * width * 4 + rows * 8 * 4
        n_ops = rows * width * 8 * 2   # the (N, W) @ (W, 8) product it replaces
        fields = dict(ms=cuda_ms(lambda: kern(x), 20),
                      plain_ms=cuda_ms(lambda: plain(x), 20),
                      bytes_ms=n_bytes / bw * 1e3, ops_ms=n_ops / flops * 1e3,
                      library_ms=None, max_abs_err=err)
        emit("kernel_vs_plain", kernel=name, shape=[rows, width],
             ragged=list(RAGGED), equal=True, bytes=n_bytes, operations=n_ops,
             **fields)
        out[name] = fields
        del x

    x = bits(SHUFFLE_ROWS, 576, dev, seed=576)
    perms = {"diva": dict(shuffle=True), "unshuffled": dict(shuffle=False),
             "diva_inverse": dict(shuffle=True, inverse=True),
             "codec": dict(perm=interleave_permutation()),
             "codec_inverse": dict(perm=interleave_permutation(), inverse=True)}
    err = 0.0
    for label, kw in perms.items():
        perm = kw.get("perm", shuffle_permutation(kw.get("shuffle", True)))
        index = _perm_tensor(np.asarray(perm, np.int32).tobytes(),
                             kw.get("inverse", False), x.device)
        plain = lambda t, index=index: apply_shuffle_ref(t, index)
        kern = lambda t, kw=kw: apply_shuffle(t, **kw)
        err = max(err, exact(kern, plain, x, f"diva_shuffle ({label})"))
        for n in RAGGED:
            exact(kern, plain, bits(n, 576, dev, seed=n), f"diva_shuffle ({label})")
    index = _perm_tensor(shuffle_permutation(True).tobytes(), False, x.device)
    n_bytes = 2 * SHUFFLE_ROWS * 576 * 4
    fields = dict(ms=cuda_ms(lambda: apply_shuffle(x, shuffle=True), 20),
                  plain_ms=cuda_ms(lambda: apply_shuffle_ref(x, index), 20),
                  library_ms=cuda_ms(lambda: torch.index_select(x, 1, index), 20),
                  bytes_ms=n_bytes / bw * 1e3, ops_ms=0.0, max_abs_err=err)
    emit("kernel_vs_plain", kernel="diva_shuffle", shape=[SHUFFLE_ROWS, 576],
         permutations=sorted(perms), ragged=list(RAGGED), equal=True,
         bytes=n_bytes, operations=0, **fields)
    out["diva_shuffle"] = fields
    return out


def counted(expected: dict) -> dict:
    """Launch counts since the last reset; raise unless each kernel in
    ``expected`` launched exactly that often and no other kernel did."""
    got = ops.launch_counts()
    want = {name: expected.get(name, 0) for name in got}
    if got != want:
        raise AssertionError(f"launches {got}, expected {want}")
    return got


def optimizer_launches(cfg, steps: int, own_norm: bool) -> dict:
    """The launches of ``steps`` train steps' optimizer phase on ``cfg``:
    under AdamW one ``adamw`` a table of up to 32 leaves a step; with
    ``make_train_step``'s norm (``own_norm``; the sharded step sums its
    own) one ``grad_sq_norm`` a table and one more a step, whatever the
    optimizer."""
    n_leaves = len(tree_leaves(abstract_state(cfg)["params"]))
    tables = -(-n_leaves // ADAMW_MAX_LEAVES)
    out = {"grad_sq_norm": (tables + 1) * steps} if own_norm else {}
    if cfg.optimizer == "adamw":
        out["adamw"] = tables * steps
    return out


def summary(gain: dict) -> dict:
    """Fig 17 means over the DIMMs that saw errors."""
    active = gain["total"] > 0
    mean = lambda k: float(np.mean(gain[k][active])) if active.any() else 0.0
    unc_ns = int(gain["uncorrectable_no_shuffle"].sum())
    unc_s = int(gain["uncorrectable_shuffle"].sum())
    return dict(dimms_with_errors=int(active.sum()),
                mean_gain=mean("gain"),
                mean_frac_no_shuffle=mean("frac_no_shuffle"),
                mean_frac_shuffle=mean("frac_shuffle"),
                errors=int(gain["total"].sum()),
                uncorrectable_words_no_shuffle=unc_ns,
                uncorrectable_words_shuffle=unc_s,
                uncorrectable_words_recovered=(1 - unc_s / unc_ns) if unc_ns else None,
                undetected_words_no_shuffle=int(gain["undetected_no_shuffle"].sum()),
                undetected_words_shuffle=int(gain["undetected_shuffle"].sum()),
                paper_gain=PAPER_GAIN, paper_recovered=PAPER_RECOVERED)


def same_counts(got: dict, want: dict, what: str) -> None:
    for k in want:
        if not np.array_equal(got[k], want[k]):
            raise AssertionError(f"{what}: {k} differs on the card and the CPU")


def fig17_profiled(batch, pop) -> dict:
    """Phase 6: Fig 17 on the profiled population; returns its launches."""
    g = batch.geom
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probs = burst_bit_profile_population(batch, "trp", 7.5, refresh_ms=256.0)
    profile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gain = shuffling_gain_population(probs, seeds=batch.serial,
                                     n_accesses=N_ACCESSES, device=batch.device)
    gain_s = time.perf_counter() - t0
    launches = counted({"fail_prob": g.chips, "diva_shuffle": 2,
                        "secded_syndrome": 1})
    if probs.shape != (batch.n_dimms, 9, 64) or not np.isfinite(probs).all():
        raise AssertionError(f"burst-bit profiles {probs.shape}, non-finite?")
    probs_cpu = burst_bit_profile_population(
        DimmBatch.from_population(pop[:2], "cpu"), "trp", 7.5, refresh_ms=256.0)
    np.testing.assert_allclose(probs[:2], probs_cpu, rtol=PROB_RTOL,
                               atol=PROB_ATOL)
    prob_rel = float(np.max(np.abs(probs[:2] - probs_cpu)
                            / np.maximum(np.abs(probs_cpu), 1e-30)))
    k = N_COUNT_CHECK
    gain_cpu = shuffling_gain_population(
        probs[:k], seeds=batch.serial[:k].cpu(), n_accesses=N_ACCESSES,
        device="cpu")
    same_counts({key: v[:k] for key, v in gain.items()}, gain_cpu,
                "Fig 17 (profiled)")
    DENSE.update(fig17_probs=probs, fig17_gain=gain)
    emit("fig17_profiled", dimms=batch.n_dimms, param="trp", t_op=7.5,
         refresh_ms=256.0, n_accesses=N_ACCESSES, profile_seconds=profile_s,
         shuffling_seconds=gain_s, launches=launches,
         probs_mean=float(probs.mean()), probs_max=float(probs.max()),
         probs_cpu_dimms=2, probs_max_rel_err_vs_cpu=prob_rel,
         probs_rtol=PROB_RTOL, probs_atol=PROB_ATOL,
         counts_equal_cpu_dimms=k, **summary(gain))
    return launches


def fig17_synthetic(dev) -> dict:
    """Phase 7: the fig17_shuffling configuration; returns its launches."""
    probs = design_stripe_profiles(72, seed=7)
    seeds = np.arange(72)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gain = shuffling_gain_population(probs, seeds=seeds, n_accesses=400,
                                     device=dev)
    gain_s = time.perf_counter() - t0
    launches = counted({"diva_shuffle": 2, "secded_syndrome": 1})
    gain_cpu = shuffling_gain_population(probs, seeds=seeds, n_accesses=400,
                                         device="cpu")
    same_counts(gain, gain_cpu, "Fig 17 (synthetic)")
    emit("fig17_synthetic", dimms=72, n_accesses=400, seconds=gain_s,
         launches=launches, counts_equal_cpu_dimms=72, **summary(gain))
    return launches


def codec_blob(dev) -> dict:
    """Phase 8: the codec on a 64 MiB blob; returns its launches."""
    rng = np.random.default_rng(12)
    data = rng.integers(0, 256, BLOB_BYTES, dtype=np.uint8).tobytes()
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lanes = protect_blob(data, device=dev)
    protect_s = time.perf_counter() - t0
    bursts = rng.choice(lanes.shape[0], N_RUNS, replace=False)
    starts = rng.integers(0, lanes.shape[1], N_RUNS)
    bad = lanes.copy()
    for b, s in zip(bursts, starts):
        bad[b:b + 1] = corrupt_run(bad[b:b + 1], burst=0, start_lane=int(s),
                                   n_bits=RUN_BITS)
    # interleaved: each run puts one error into each of up to 8 codewords
    flipped = int(np.minimum(RUN_BITS, lanes.shape[1] - starts).sum())
    t0 = time.perf_counter()
    out, stats = recover_blob(bad, len(data), device=dev)
    recover_s = time.perf_counter() - t0
    launches = counted({"secded_encode": 1, "diva_shuffle": 2,
                        "secded_syndrome": 1})
    if out != data:
        raise AssertionError("the codec did not give the 64 MiB blob back")
    if stats.corrected != flipped or stats.uncorrectable:
        raise AssertionError(f"codec stats {stats}, expected {flipped} "
                             f"corrected and 0 uncorrectable")
    head = CHECK_BYTES // 64
    if not np.array_equal(lanes[:head], protect_blob(data[:CHECK_BYTES],
                                                     device="cpu")):
        raise AssertionError("codec lanes differ on the card and the CPU")
    DENSE.update(codec_lanes=lanes, codec_bad=bad, codec_bursts=bursts,
                 codec_corrected=stats.corrected)
    emit("codec", blob_bytes=BLOB_BYTES, bursts=int(lanes.shape[0]),
         codewords=stats.codewords, runs=N_RUNS, run_bits=RUN_BITS,
         corrected=stats.corrected, uncorrectable=stats.uncorrectable,
         protect_seconds=protect_s, recover_seconds=recover_s,
         launches=launches, lanes_equal_cpu_bytes=CHECK_BYTES)
    return launches


def walk_vs_plain(traces, tc, cfg, what: str, routes=ROUTES) -> float:
    """The bank_sched kernels against the plain walk: the wrapper's choice and
    each of ``routes`` forced, equal, or raise.  Returns max |kernel - plain|
    over latency and hit (0.0)."""
    kw = memsim._walk_kw(cfg)
    want = memsim_walk_ref(traces, tc, **kw)
    runs = {"wrapper": memsim_walk(traces, tc, **kw)}
    args = {k: v for k, v in kw.items() if k != "queue"}
    for route in routes:
        runs[route] = bank_sched_launch(traces, tc, min(cfg.queue, traces.shape[1]),
                                        route=route, **args)
    torch.cuda.synchronize()
    err = 0.0
    for label, got in runs.items():
        for g, w, name in zip(got, want, ("latency", "hit")):
            if g.shape != w.shape or not torch.equal(g, w):
                raise AssertionError(f"bank_sched ({label}) {name} differs from "
                                     f"the plain walk ({what}, {tuple(traces.shape)})")
            err = max(err, float((g - w).abs().max()) if g.numel() else 0.0)
    return err


def sm_clock_mhz() -> float:
    """The SM clock nvidia-smi reads now (MHz)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0])


def memsim_phase(dev, batch, diva) -> tuple[dict, dict]:
    """Phase 9: the Fig 19 memory system; returns (its launches, the
    bank_sched ``kernels``-line fields)."""
    cfgs = {"default": memsim.MemSimConfig(),
            "one_channel_one_rank": memsim.MemSimConfig(channels=1, ranks=1),
            "queue4_no_bus": memsim.MemSimConfig(queue=4, bus=False),
            "inorder": memsim.inorder_config(16)}
    base = memsim.STANDARD
    tc = torch.as_tensor(np.stack([memsim.timing_cycles_banks(t, 16)
                                   for t in [base, *diva]]), device=dev)
    traces = memsim._stack_traces(MEMSIM_PLAIN_N, 16, 0, dev)
    err = max(walk_vs_plain(traces, tc, cfg, name)
              for name, cfg in cfgs.items())
    kw = memsim._walk_kw(cfgs["default"])
    plain_ms = cuda_ms(lambda: memsim_walk_ref(traces, tc, **kw), 3,
                       warm_up=False)                  # warmed by the check
    kernel_ms_plain_n = cuda_ms(lambda: memsim_walk(traces, tc, **kw), 20)
    for n in (1, 5):
        err = max(err, walk_vs_plain(memsim._stack_traces(n, 16, 0, dev), tc,
                                     cfgs["default"], f"n = {n}"))
    err = max(err, walk_vs_plain(memsim._stack_traces(500, 16, 0, dev), tc,
                                 memsim.MemSimConfig(queue=32), "Q = 32"))
    # what only the general kernel takes: a decreasing arrival, 40 banks
    dec = memsim._stack_traces(500, 16, 0, dev).clone()
    dec[:, 250, 3] = dec[:, 249, 3] - 7
    tc40 = torch.as_tensor(np.stack([memsim.timing_cycles_banks(t, 40)
                                     for t in [base, *diva[:3]]]), device=dev)
    general_cases = {
        "decreasing_arrival": (dec, tc, cfgs["default"]),
        "banks_40": (memsim._stack_traces(500, 40, 0, dev), tc40,
                     memsim.MemSimConfig(banks=40))}
    for label, (tr, tcx, cfg) in general_cases.items():
        if walk_route(tr, tcx.shape[1], cfg.ranks, cfg.channels) != "general":
            raise AssertionError(f"bank_sched: {label} did not take the general "
                                 f"kernel")
        err = max(err, walk_vs_plain(tr, tcx, cfg, label, routes=("general",)))
    full = memsim._stack_traces(MEMSIM_N, 16, 0, dev)
    if walk_route(full, 16, cfgs["default"].ranks,
                  cfgs["default"].channels) != "fast":
        raise AssertionError("bank_sched: the Fig 19 traces did not take the "
                             "fast kernel")
    ms = cuda_ms(lambda: memsim_walk(full, tc, **kw), 20)
    mhz = sm_clock_mhz()
    kw1 = memsim._walk_kw(cfgs["inorder"])
    inorder_ms = cuda_ms(lambda: memsim_walk(full, tc, **kw1), 20)
    general_ms = cuda_ms(lambda: bank_sched_launch(
        full, tc, 8, route="general",
        **{k: v for k, v in kw.items() if k != "queue"}), 5)
    T, W = tc.shape[0], full.shape[0]
    Q = cfgs["default"].queue
    n_ops = T * W * MEMSIM_N * (Q * BANK_SCHED_CANDIDATE_OPS
                                + BANK_SCHED_STEP_OPS)
    n_bytes = full.numel() * 4 + tc.numel() * 4 + T * W * MEMSIM_N * 8
    fields = dict(ms=ms, plain_ms=plain_ms, bytes_ms=n_bytes / PEAK_BYTES_PER_S * 1e3,
                  ops_ms=n_ops / PEAK_INT32_OPS * 1e3, library_ms=None,
                  max_abs_err=err)
    step_ns = ms * 1e6 / MEMSIM_N
    emit("kernel_vs_plain", kernel="bank_sched", grid=[T, W],
         configurations=sorted(cfgs), n=MEMSIM_PLAIN_N, ragged_n=[1, 5],
         ragged_queue=32, routes_checked=list(ROUTES),
         general_only_cases=sorted(general_cases), equal=True,
         kernel_n=MEMSIM_N, kernel_ms_at_plain_n=kernel_ms_plain_n,
         plain_n=MEMSIM_PLAIN_N, ns_per_step=step_ns, sm_clock_mhz=mhz,
         cycles_per_step=step_ns * mhz * 1e-3, inorder_ms=inorder_ms,
         inorder_ns_per_step=inorder_ms * 1e6 / MEMSIM_N,
         general_kernel_ms=general_ms,
         bytes=n_bytes, operations=n_ops, peak_int32_ops=PEAK_INT32_OPS,
         **fields)

    # ---- the Fig 19 path, counted
    ops.reset_launches()
    torch.cuda.synchronize()
    secs = {}
    t0 = time.perf_counter()
    whole = memsim.system_speedup_population(diva, n_requests=MEMSIM_N,
                                             device=dev)
    DENSE["fig19_whole"] = whole
    secs["frfcfs_whole"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pb = profile_population_arrays(batch, banks=4, multibit_only=True)
    secs["profile_banks4"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    per_bank = memsim.system_speedup_population(pb, n_requests=MEMSIM_N,
                                                device=dev)
    secs["frfcfs_per_bank"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    inorder = memsim.system_speedup_population(
        diva, n_requests=MEMSIM_N, scheduler="inorder", device=dev)
    secs["inorder_whole"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ipcs = memsim.evaluate_system_grid([base, diva[0]], n_requests=MEMSIM_N,
                                       device=dev)
    cores = {c: memsim.speedup_summary(TimingParams(*map(float, diva[0])),
                                       base, cores=c, ipcs=ipcs)
             for c in PAPER_SPEEDUP}
    secs["inorder_summary"] = time.perf_counter() - t0
    launches = counted({"bank_sched": 4})
    routes = dict(memsim_walk.route_launches)
    if routes != {"fast": 4, "general": 0}:
        raise AssertionError(f"the Fig 19 paths' bank_sched routes: {routes}")

    # ---- checks against the port on the CPU
    D = len(diva)
    for name, res in (("whole", whole), ("per_bank", per_bank),
                      ("inorder", inorder)):
        sp = res["per_dimm_speedup"]
        if sp.shape != (D,) or not np.isfinite(sp).all() \
                or res["total_latency_cycles"].shape != (D + 1, W):
            raise AssertionError(f"Fig 19 {name}: speedups {sp.shape}, "
                                 f"non-finite?")
    if pb.shape != (D, 4, 4) or not np.array_equal(pb.max(axis=1), diva):
        raise AssertionError("per-bank tables are not (D, 4, 4) with the "
                             "whole-DIMM tables as their envelope")
    k, kb = min(MEMSIM_CPU_DIMMS, D), min(MEMSIM_CPU_BANK_DIMMS, D)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)     # the plain walk's tiny ops run best on one
    t0 = time.perf_counter()
    cpu = memsim._grid_totals([base, *diva[:k], *pb[:kb]],
                              memsim.MemSimConfig(), MEMSIM_N, 0, "cpu")
    cpu_ipcs = memsim.evaluate_system_grid([base, diva[0]],
                                           n_requests=MEMSIM_N, device="cpu")
    cpu_s = time.perf_counter() - t0
    torch.set_num_threads(threads)
    if not (np.array_equal(whole["total_latency_cycles"][:k + 1], cpu[:k + 1])
            and np.array_equal(per_bank["total_latency_cycles"][0], cpu[0])
            and np.array_equal(per_bank["total_latency_cycles"][1:kb + 1],
                               cpu[k + 1:])
            and np.array_equal(ipcs, cpu_ipcs)):
        raise AssertionError("Fig 19 latency totals differ on the card and "
                             "the CPU")
    # speedups are scored on the host from the totals: identical to the CPU's
    if not np.array_equal(memsim._speedups(cpu[:k + 1], MEMSIM_N)
                          ["per_dimm_workload_speedup"],
                          whole["per_dimm_workload_speedup"][:k]):
        raise AssertionError("Fig 19 speedups differ on the card and the CPU")
    slack = int((pb < diva[:, None, :]).any(axis=(1, 2)).sum())
    stat = lambda res: {key: res[key] for key in (
        "mean_speedup", "median_speedup", "min_speedup", "max_speedup")}
    emit("fig19_memsim", dimms=D, workloads=W, n_requests=MEMSIM_N,
         config=dataclasses.asdict(cfgs["default"]),
         seconds=secs, launches=launches, bank_sched_route_launches=routes,
         frfcfs_whole=stat(whole), frfcfs_per_bank=stat(per_bank),
         inorder_whole=stat(inorder),
         per_bank_dimms_with_bank_slack=slack,
         per_bank_at_least_whole_dimms=int(
             (per_bank["per_dimm_speedup"] >= whole["per_dimm_speedup"]).sum()),
         inorder_summary_table=diva[0].tolist(),
         speedup_by_cores={c: (s["mean_singlecore_speedup"] if c == 1
                               else s["mean_weighted_speedup"]) - 1.0
                           for c, s in cores.items()},
         paper_speedup_by_cores=PAPER_SPEEDUP,
         totals_equal_cpu=dict(whole_tables=1 + k, per_bank_tables=1 + kb,
                               inorder_grid=2),
         speedups_equal_cpu_dimms=k, cpu_check_seconds=cpu_s)
    return launches, fields


def op_kernel_vs_plain(batch) -> dict:
    """Phase 10: ``fail_prob_op`` against its plain version; returns its
    ``kernels``-line fields."""
    g, dev = batch.geom, batch.device
    adder = torch.as_tensor(condition_adders(batch, OP_TEMP, OP_REFRESH),
                            device=dev)
    shift = access_vdd_shift(batch.vdd_coef.cpu().numpy(), OP_VDD)
    coeffs = _pack_op_coeffs(batch, 1, OP_T, PATTERN_STRESS["0101"], adder, 0,
                             0, shift, retention_stress(OP_TEMP, OP_REFRESH,
                                                        OP_VDD))
    row_src = batch.row_src[:, 0].contiguous()
    d_mat = torch.as_tensor(_geom_consts(g)[1], device=dev)
    C = g.cols_per_mat
    rng = np.random.default_rng(1)
    rag_rows = torch.as_tensor(rng.integers(0, 100, (3, 100)),
                               dtype=torch.int32, device=dev)
    rag_cf = coeffs[:3].clone()
    rag_cf[:, :6] += torch.as_tensor(rng.normal(0, 0.05, (3, 6)),
                                     dtype=torch.float32, device=dev)
    errs = {}

    def check(rs, dm, cf, cols, open_bitline, voltage, retention):
        return grid_exact(fail_prob_op, fail_prob_op_ref, rs, dm, cf, cols=cols,
                          open_bitline=open_bitline, voltage=voltage,
                          retention=retention)

    for voltage, retention in OP_FLAGS:
        key = f"voltage={voltage},retention={retention}"
        errs[key] = check(row_src, d_mat, coeffs, C, True, voltage, retention)
        errs[key + ",ragged"] = check(rag_rows, d_mat[:5], rag_cf, 96, True,
                                      voltage, retention)
        for i, (De, Me, Re, Ce, ob) in enumerate(FP_EDGES):
            rs, dm, cf = edge_inputs(De, Me, Re, coeffs, d_mat, seed=20 + i)
            errs[key + f",{De}x{Me}x{Re}x{Ce}" + ("" if ob else "_closed")] = check(
                rs, dm, cf, Ce, ob, voltage, retention)
    errs["closed_bitline"] = check(row_src, d_mat, coeffs, C, False, True, True)
    off = fail_prob_op(row_src, d_mat, coeffs, cols=C)
    if not torch.equal(off, fail_prob(row_src, d_mat,
                                      coeffs[:, :9].contiguous(), cols=C)):
        raise AssertionError("fail_prob_op with both flags off is not "
                             "fail_prob bit for bit")
    del off
    kw = dict(cols=C, voltage=True, retention=True)
    ms = cuda_ms(lambda: fail_prob_op(row_src, d_mat, coeffs, **kw), 20)
    plain_ms = cuda_ms(lambda: fail_prob_op_ref(row_src, d_mat, coeffs, **kw), 5)
    cells = batch.n_dimms * g.mats_x * g.rows_per_mat * C
    n_bytes = row_src.numel() * 4 + d_mat.numel() * 4 + coeffs.numel() * 4 \
        + cells * 4
    n_ops = cells * (FAIL_PROB_FLOPS_PER_CELL + OP_VOLTAGE_FLOPS
                     + OP_RETENTION_FLOPS)
    fields = dict(ms=ms, plain_ms=plain_ms,
                  bytes_ms=n_bytes / PEAK_BYTES_PER_S * 1e3,
                  ops_ms=n_ops / PEAK_FP32_FLOPS * 1e3, library_ms=None,
                  max_abs_err=max(errs.values()))
    emit("kernel_vs_plain", kernel="fail_prob_op",
         shape=[batch.n_dimms, g.mats_x, g.rows_per_mat, C],
         max_abs_err_by_case=errs, ragged_shape=[3, 5, 100, 96],
         edge_shapes=[list(e) for e in FP_EDGES], equal="torch.equal",
         flags_off_equal_fail_prob=True,
         timed_flags=dict(voltage=True, retention=True), bytes=n_bytes,
         flops=n_ops, **fields)
    return fields


def counts_rows(n: int, nbits: int, dev, seed: int) -> torch.Tensor:
    """Seeded (n, 2**nbits) int32 counts in [0, 1000) on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 1000, (n, 2 ** nbits), generator=gen, device=dev,
                         dtype=torch.int32)


def sig_kernel_vs_plain(dev) -> dict:
    """Phase 11: ``bit_signature`` against its plain version; returns its
    ``kernels``-line fields."""
    kern = lambda x, nb=SIG_NBITS: bit_signature(x, nbits=nb)
    plain = lambda x, nb=SIG_NBITS: bit_signature_ref(x, nbits=nb)
    err = exact(kern, plain, counts_rows(SIG_PATH_ROWS, SIG_NBITS, dev, 1),
                "bit_signature")
    for nb in SIG_NBITS_EXTRA:
        exact(lambda x: kern(x, nb), lambda x: plain(x, nb),
              counts_rows(4099, nb, dev, nb), f"bit_signature (nbits {nb})")
    for n in SIG_RAGGED:
        exact(kern, plain, counts_rows(n, SIG_NBITS, dev, n), "bit_signature")
    x = counts_rows(SIG_ROWS, SIG_NBITS, dev, 2)
    R = x.shape[1]
    r = torch.arange(R, device=dev)
    signs = ((((r[:, None] >> torch.arange(SIG_NBITS, device=dev)) & 1) * 2
              - 1).to(torch.float32))                          # (R, nbits)
    torch.backends.cuda.matmul.allow_tf32 = False
    library = lambda: torch.matmul(x.float(), signs)
    # exact while every |sum| < 2**24: the counts are below 1000
    if not torch.equal(library().to(torch.int32), kern(x)):
        raise AssertionError("the matmul yardstick does not compute the "
                             "signatures")
    n_bytes = x.numel() * 4 + SIG_ROWS * SIG_NBITS * 4
    n_ops = x.numel() * SIG_NBITS * 2        # a +-1 product and an add each
    fields = dict(ms=cuda_ms(lambda: kern(x), 20),
                  plain_ms=cuda_ms(lambda: plain(x), 5),
                  library_ms=cuda_ms(library, 20),
                  bytes_ms=n_bytes / PEAK_BYTES_PER_S * 1e3,
                  ops_ms=n_ops / PEAK_INT32_OPS * 1e3, max_abs_err=err)
    emit("kernel_vs_plain", kernel="bit_signature",
         shape=[SIG_PATH_ROWS, R], timed_shape=[SIG_ROWS, R],
         nbits_extra=list(SIG_NBITS_EXTRA), ragged=list(SIG_RAGGED),
         equal=True, bytes=n_bytes, operations=n_ops,
         library="torch.matmul(counts.float(), signs), allow_tf32=False",
         **fields)
    return fields


def op_points_phase(batch, pop) -> dict:
    """Phase 12: operating points and the operating grid; returns its
    launches (none: the reference's dense operating-point path runs no
    kernel either)."""
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pts = operating_points_population(batch, temp_C=55.0, multibit_only=True)
    pts_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    grid = operating_grid_arrays(batch, OP_POINTS)
    grid_s = time.perf_counter() - t0
    launches = counted({})
    k = OP_CPU_DIMMS
    cpu = DimmBatch.from_population(pop[:k], "cpu")
    t0 = time.perf_counter()
    pts_cpu = operating_points_population(cpu, temp_C=55.0, multibit_only=True)
    grid_cpu = operating_grid_arrays(cpu, OP_POINTS)
    cpu_s = time.perf_counter() - t0
    if [p.as_dict() for p in pts[:k]] != [p.as_dict() for p in pts_cpu]:
        raise AssertionError("operating points differ on the card and the CPU")
    if not np.array_equal(grid["fails"][:k], grid_cpu["fails"]):
        raise AssertionError("operating-grid fails differ on the card and "
                             "the CPU")
    np.testing.assert_allclose(grid["lam"][:k], grid_cpu["lam"],
                               rtol=LAMBDA_RTOL)
    if grid["lam"].shape != (batch.n_dimms, len(OP_POINTS)) \
            or not np.isfinite(grid["lam"]).all():
        raise AssertionError(f"operating grid lam {grid['lam'].shape}, "
                             f"non-finite?")
    lam_rel = float(np.max(np.abs(grid["lam"][:k] - grid_cpu["lam"])
                           / np.maximum(np.abs(grid_cpu["lam"]), 1e-30)))
    DENSE["op_grid"] = grid
    emit("operating_points", dimms=batch.n_dimms, temp_C=55.0,
         multibit_only=True, seconds=pts_s, grid_seconds=grid_s,
         launches=launches,
         mean_safe_vdd=float(np.mean([p.vdd for p in pts])),
         mean_safe_refresh_ms=float(np.mean([p.refresh_ms for p in pts])),
         mean_read_reduction=float(np.mean([latency_reduction(p.timing)
                                            ["read_reduction"] for p in pts])),
         first_points=[p.as_dict() for p in pts[:2]],
         grid_points=[p.as_dict() for p in OP_POINTS],
         grid_fail_share=grid["fails"].mean(axis=0).tolist(),
         cpu_dimms=k, equal_cpu=True, grid_lam_max_rel_err_vs_cpu=lam_rel,
         rtol=LAMBDA_RTOL, cpu_check_seconds=cpu_s)
    return launches


def _op_coeffs_cpu(pop, k):
    cpu = DimmBatch.from_population(pop[:k], "cpu")
    adder = torch.as_tensor(condition_adders(cpu, OP_TEMP, OP_REFRESH))
    shift = access_vdd_shift(cpu.vdd_coef.numpy(), OP_VDD)
    return cpu, _pack_op_coeffs(cpu, 1, OP_T, PATTERN_STRESS["0101"], adder,
                                0, 0, shift, retention_stress(
                                    OP_TEMP, OP_REFRESH, OP_VDD))


def error_summary_phase(batch, pop) -> dict:
    """Phase 13: the fleet error summary at an operating point and at
    nominal supply; returns its launches."""
    op = dict(temp_C=OP_TEMP, refresh_ms=OP_REFRESH, vdd=OP_VDD,
              retention=True, collect_fail_maps=True)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    at_op = stream_error_summary(PopulationStream.from_batch(batch), OP_PARAM,
                                 OP_T, chunk_size=OP_CHUNK, **op)
    op_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nominal = stream_error_summary(PopulationStream.from_batch(batch),
                                   OP_PARAM, OP_T, chunk_size=OP_CHUNK,
                                   temp_C=OP_TEMP, refresh_ms=OP_REFRESH)
    nominal_s = time.perf_counter() - t0
    DENSE.update(summary_op=at_op, summary_nominal=nominal)
    n_chunks = -(-batch.n_dimms // OP_CHUNK)
    launches = counted({"fail_prob_op": n_chunks, "fail_prob": n_chunks})
    g = batch.geom
    if at_op["grid_sum"].shape != (g.mats_x, g.rows_per_mat, g.cols_per_mat) \
            or not np.isfinite(at_op["grid_sum"]).all() \
            or at_op["lam_total"].shape != (batch.n_dimms,):
        raise AssertionError("fleet error summary: bad shapes or non-finite")

    # a ragged stream of 8 DIMMs, card against CPU
    k = OP_CPU_DIMMS
    sub = DimmBatch.from_population(pop[:k], batch.device)
    card = stream_error_summary(sub, OP_PARAM, OP_T, chunk_size=OP_CPU_CHUNK,
                                **op)
    cpu_batch, cpu_cf = _op_coeffs_cpu(pop, k)
    t0 = time.perf_counter()
    cpu = stream_error_summary(cpu_batch, OP_PARAM, OP_T,
                               chunk_size=OP_CPU_CHUNK, **op)
    cpu_s = time.perf_counter() - t0
    np.testing.assert_allclose(card["lam_total"], cpu["lam_total"],
                               rtol=LAMBDA_RTOL)
    # each cell of each DIMM within the kernel's bound of the plain version
    np.testing.assert_allclose(card["grid_sum"], cpu["grid_sum"],
                               rtol=LAMBDA_RTOL, atol=k * KERNEL_ATOL)
    for key in ("lam_min", "lam_max"):
        if not np.array_equal(card[key]["serial"], cpu[key]["serial"]):
            raise AssertionError(f"{key} serial differs on the card and CPU")
    maps = lambda res: np.concatenate([unpack_bool(p)
                                       for p in res["fail_maps"]])
    hot_diff = card["hot_cells"] != cpu["hot_cells"]          # (M, R, C)
    row_diff = maps(card) != maps(cpu)                        # (k, R)
    near_cells = int(hot_diff.sum()) + int(row_diff.sum())
    if near_cells:
        # a difference is allowed only where a cell lies within the kernel's
        # bound of the threshold (0.5)
        grids = fail_prob_op_ref(cpu_batch.row_src[:, 0].contiguous(),
                                 torch.as_tensor(_geom_consts(g)[1]), cpu_cf,
                                 cols=g.cols_per_mat, voltage=True,
                                 retention=True)
        near = ((grids - 0.5).abs() <= KERNEL_ATOL).numpy()
        if (hot_diff & ~near.any(axis=0)).any() \
                or (row_diff & ~near.any(axis=(1, 3))).any():
            raise AssertionError("hot cells or fail maps differ on the card "
                                 "and the CPU away from the threshold")
    emit("error_summary", dimms=batch.n_dimms, param=OP_PARAM, t_op=OP_T,
         temp_C=OP_TEMP, refresh_ms=OP_REFRESH, vdd=OP_VDD, retention=True,
         chunk_size=OP_CHUNK, n_chunks=at_op["n_chunks"],
         seconds=op_s, nominal_seconds=nominal_s, launches=launches,
         lam_mean_operating_point=float(at_op["lam_stats"]["mean"]),
         lam_mean_nominal=float(nominal["lam_stats"]["mean"]),
         lam_max_serial=int(at_op["lam_max"]["serial"]),
         hot_cells_total=int(at_op["hot_cells"].sum()),
         hot_cells_total_nominal=int(nominal["hot_cells"].sum()),
         rows_failing=int(maps(at_op).sum()),
         cpu_dimms=k, cpu_chunk_size=OP_CPU_CHUNK, rtol=LAMBDA_RTOL,
         cells_differing_near_threshold=near_cells, cpu_check_seconds=cpu_s)
    return launches


def blind_phase(batch, pop) -> dict:
    """Phase 14: blind discovery on the 96 DIMMs; returns its launches."""
    ops.reset_launches()
    torch.cuda.synchronize()
    secs = {}
    t0 = time.perf_counter()
    counts, expected = campaign_counts(pop, batch)
    secs["campaign"] = time.perf_counter() - t0
    serials = batch.serial.cpu().numpy()
    t0 = time.perf_counter()
    disc = BlindDiva().discover(counts, expected, serials=serials,
                                device=batch.device)
    secs["discover"] = time.perf_counter() - t0
    DENSE.update(campaign_counts=counts, campaign_expected=expected)
    t0 = time.perf_counter()
    bvo = blind_vs_oracle(batch, disc, temp_C=55.0, multibit_only=True)
    secs["blind_vs_oracle"] = time.perf_counter() - t0
    g = batch.geom
    T = counts.shape[0]
    launches = counted({"fail_prob_rows": T * g.subarrays * 4,
                        "bit_signature": 2 * T})

    # checks against the port on the CPU
    t0 = time.perf_counter()
    ke = BLIND_CPU_EXPECTED_DIMMS
    _, exp_cpu = campaign_counts(pop[:ke], DimmBatch.from_population(
        pop[:ke], "cpu"), t_ops=(7.5,))
    np.testing.assert_allclose(expected[1, :ke], exp_cpu[0], rtol=5e-5)
    exp_rel = float(np.max(np.abs(expected[1, :ke] - exp_cpu[0])
                           / np.maximum(np.abs(exp_cpu[0]), 1e-30)))
    disc_cpu = BlindDiva().discover(counts, expected, serials=serials,
                                    device="cpu")
    for f in ("labels", "ext_rows", "ext_to_int", "vuln_rows", "canonical",
              "confidence"):
        if not np.array_equal(getattr(disc, f), getattr(disc_cpu, f)):
            raise AssertionError(f"blind discovery {f} differs on the card "
                                 f"and the CPU")
    kt = BLIND_CPU_TABLE_DIMMS
    blind_cpu = BlindDiva().profile(
        DimmBatch.from_population(pop[:kt], "cpu"),
        dataclasses.replace(disc_cpu, ext_rows=disc_cpu.ext_rows[:kt]),
        temp_C=55.0, multibit_only=True)
    if not np.array_equal(bvo["blind"][:kt], blind_cpu):
        raise AssertionError("blind tables differ on the card and the CPU")
    cpu_s = time.perf_counter() - t0
    emit("blind_discovery", dimms=batch.n_dimms, param="trp",
         t_ops=[10.0, 7.5, 5.0], temp_C=85.0, refresh_ms=256.0,
         seconds=secs, launches=launches,
         generations=int(disc.canonical.shape[0]),
         agreement=bvo["agreement"], n_agree=bvo["n_agree"],
         region_recovered_frac=bvo["region_recovered_frac"],
         mean_confidence=float(disc.confidence.mean()),
         rows_tested_blind=bvo["rows_tested_blind"],
         rows_tested_conventional=bvo["rows_tested_conventional"],
         expected_cpu_dimms=ke, expected_cpu_t_op=7.5,
         expected_max_rel_err_vs_cpu=exp_rel, discovery_equal_cpu=True,
         blind_tables_equal_cpu_dimms=kt, cpu_check_seconds=cpu_s)
    return launches


def rc_flops_per_cell(cp: CircuitParams, t_total_ns: float = 45.0,
                      t_pre_ns: float = 30.0) -> int:
    """float32 operations one cell of ``csrc/rc_transient.cu`` performs over
    the run (its header's count: 8*n_seg + 3 a step, + 17 while the
    wordline is open, + 5 while the sense amp is on, + 3 while precharging;
    each division and transcendental one operation)."""
    total = 0
    for t in step_times(cp, t_total_ns):
        wl_open, sa_on, pre_on = step_phases(t, cp, t_pre_ns)
        total += 8 * cp.n_seg + 3 + 17 * wl_open + 5 * sa_on + 3 * pre_on
    return total


def mat_cells(dev):
    """The sense map of one mat: (MAT*MAT,) row and column fractions."""
    r = (np.arange(MAT) / (MAT - 1)).astype(np.float32)
    return (torch.as_tensor(np.repeat(r, MAT), device=dev),
            torch.as_tensor(np.tile(r, MAT), device=dev))


def rc_compare(got: dict, want: dict, dt: float, what: str) -> dict:
    """``rc_transient`` outputs against the plain version's (or the CPU
    port's): v_probe/v_cell within KERNEL_ATOL, sense_t on the same Euler
    step and ``inf`` where ``want`` has ``inf``, or raise.  Returns the
    measured maxima and the count of crossings that moved at all."""
    got = {k: v.cpu() for k, v in got.items()}
    want = {k: v.cpu() for k, v in want.items()}
    errs = {k: float((got[k] - want[k]).abs().max()) if got[k].numel() else 0.0
            for k in ("v_probe", "v_cell")}
    ts, ref_ts = got["sense_t"], want["sense_t"]
    if not torch.equal(torch.isinf(ts), torch.isinf(ref_ts)):
        raise AssertionError(f"rc_transient ({what}): sense_t is inf in other "
                             f"cells than its reference's")
    fin = torch.isfinite(ref_ts)
    dts = (ts[fin] - ref_ts[fin]).abs()
    errs["sense_t"] = float(dts.max()) if dts.numel() else 0.0
    if max(errs["v_probe"], errs["v_cell"]) > KERNEL_ATOL \
            or errs["sense_t"] >= dt / 2:
        raise AssertionError(f"rc_transient ({what}) differs from its "
                             f"reference: {errs}")
    return dict(max_abs_err=errs, sense_steps_moved=int((dts > 0).sum()),
                inf_cells=int((~fin).sum()), all_zero=not any(errs.values()))


def rc_kernel_vs_plain(dev) -> dict:
    """Phase 15: ``rc_transient`` against its plain version, bit for bit, with
    the kernel's fast divisions checked for every ``CircuitParams`` the port
    launches with; returns its ``kernels``-line fields."""
    cp = CircuitParams()
    # the fast divisions against IEEE division on every operand of their
    # ranges, for the divisors of each circuit the paths and tests launch
    t0 = time.perf_counter()
    checks = {}
    for label, c in RC_CIRCUITS.items():
        bad = rc_division_check(torch.as_tensor(launch_divisors(c), device=dev))
        checks[label] = dict(divisors=launch_divisors(c).tolist(), mismatches=bad)
        if any(bad):
            raise AssertionError(f"rc_transient's fast divisions differ from IEEE "
                                 f"division on {bad} operands ({label})")
    div_s = time.perf_counter() - t0
    emit("division_check", kernel="rc_transient", circuits=checks, seconds=div_s)

    rf, cf = mat_cells(dev)
    cases = {}

    def check(label, r, c, **kw):
        reset_route_counts(dev)
        got = rc_transient(r, c, **kw)
        routes = route_counts(dev)
        want = rc_transient_ref(r, c, **kw)
        torch.cuda.synchronize()
        cases[label] = rc_compare(got, want, kw.get("cp", cp).dt_ns, label)
        if not all(torch.equal(got[k], want[k]) for k in want):
            raise AssertionError(f"rc_transient ({label}) differs from its plain "
                                 f"version bit for bit")
        cases[label].update(equal=True, routes=routes)
        return got

    mat = check("mat", rf, cf)
    if not torch.isfinite(mat["sense_t"]).all():
        raise AssertionError("a charged cell of the mat never sensed")
    if cases["mat"]["routes"]["mixed_tap_warps"]:
        raise AssertionError("a warp of the mat did not share a tap")
    for n in RC_RAGGED:
        rng = np.random.default_rng(n)
        r, c = (torch.as_tensor(rng.uniform(0, 1, n), dtype=torch.float32,
                                device=dev) for _ in range(2))
        check(f"ragged_{n}", r, c)
    check("uncharged", rf, cf, cell_charged=False)
    if cases["uncharged"]["inf_cells"] != rf.numel():
        raise AssertionError("an uncharged cell reached v_ready")
    check("n_seg4_tpre12", rf, cf, cp=RC_CIRCUITS["n_seg4"], t_pre_ns=12.0)
    rng = np.random.default_rng(16)
    r, c = (torch.as_tensor(rng.uniform(0, 1, 4096), dtype=torch.float32, device=dev)
            for _ in range(2))
    check("n_seg16_dt004", r, c, cp=RC_CIRCUITS["n_seg16_dt004"], t_total_ns=20.0)
    ieee_cells = sum(c["routes"]["ieee_cells"] for c in cases.values())
    ms = cuda_ms(lambda: rc_transient(rf, cf), 20)
    mhz = sm_clock_mhz()
    plain_ms = cuda_ms(lambda: rc_transient_ref(rf, cf), 3)
    N = rf.numel()
    # a warp's issue slots a step: each of the card's 4 x SMs schedulers
    # issues at most one instruction a cycle, shared by its resident warps
    steps = n_steps(cp, 45.0)
    schedulers = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    warp_step_cycles = ms * 1e-3 * mhz * 1e6 * schedulers / (-(-N // 32) * steps)
    n_bytes = N * (2 + 3) * 4
    n_ops = N * rc_flops_per_cell(cp)
    err = max(max(c["max_abs_err"]["v_probe"], c["max_abs_err"]["v_cell"])
              for c in cases.values())
    fields = dict(ms=ms, plain_ms=plain_ms,
                  bytes_ms=n_bytes / PEAK_BYTES_PER_S * 1e3,
                  ops_ms=n_ops / PEAK_FP32_FLOPS * 1e3, library_ms=None,
                  max_abs_err=err)
    emit("kernel_vs_plain", kernel="rc_transient", shape=[N],
         mat=[MAT, MAT], n_seg=cp.n_seg, steps=steps,
         ragged=list(RC_RAGGED), cases=cases, equal="torch.equal",
         all_maxima_zero=all(c["all_zero"] for c in cases.values()),
         ieee_rerun_cells=ieee_cells, division_check_s=div_s,
         sm_clock_mhz=mhz, scheduler_cycles_per_warp_step=warp_step_cycles,
         bytes=n_bytes, flops=n_ops, flops_per_cell=n_ops // N,
         library="none (no single PyTorch call computes it)", **fields)
    return fields


def circuit_phase(dev) -> dict:
    """Phase 16: the Appendix B circuit path; returns its launches."""
    rf, cf = mat_cells(dev)
    ops.reset_launches()
    torch.cuda.synchronize()
    secs = {}
    t0 = time.perf_counter()
    coeffs = fit_latency_coefficients(device=dev)
    secs["fit_latency_coefficients"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    restore = simulate(np.array([0.05, 0.95]), np.array([0.0, 0.0]),
                       t_precharge_at_ns=12.0, device=dev)
    rv = restored_voltage(restore, 12.0)
    secs["restore_run"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    smap = rc_transient(rf, cf)
    torch.cuda.synchronize()
    secs["sense_map"] = time.perf_counter() - t0
    launches = counted({"rc_transient": 1})

    # checks against the port on the CPU
    t0 = time.perf_counter()
    coeffs_cpu = fit_latency_coefficients(device="cpu")
    if coeffs != coeffs_cpu:
        raise AssertionError(f"Appendix B coefficients differ on the card and "
                             f"the CPU: {coeffs} vs {coeffs_cpu}")
    restore_cpu = simulate(np.array([0.05, 0.95]), np.array([0.0, 0.0]),
                           t_precharge_at_ns=12.0, device="cpu")
    rv_err = float(np.abs(rv - restored_voltage(restore_cpu, 12.0)).max())
    if rv_err > KERNEL_ATOL or not np.array_equal(sense_time(restore),
                                                  sense_time(restore_cpu)):
        raise AssertionError(f"the appB restore run differs on the card and "
                             f"the CPU (restored voltage by {rv_err})")
    idx = torch.arange(0, rf.numel(), RC_CPU_STRIDE, device=dev)
    smap_cpu = rc_transient(rf[idx].cpu(), cf[idx].cpu())
    cpu_cmp = rc_compare({k: v[idx] for k, v in smap.items()}, smap_cpu,
                         CircuitParams().dt_ns, "sense map, card vs CPU")
    secs["cpu_check"] = time.perf_counter() - t0
    ts = smap["sense_t"].reshape(MAT, MAT).cpu().numpy()
    if not np.isfinite(ts).all():
        raise AssertionError("a cell of the sense map never sensed")
    loss_mv = float(rv[0] - rv[1]) * 1e3
    emit("circuit", seconds=secs, launches=launches, map_cells=rf.numel(),
         sense_t_near_row_mean_ns=float(ts[0].mean()),
         sense_t_far_row_mean_ns=float(ts[-1].mean()),
         sense_t_min_ns=float(ts.min()), sense_t_max_ns=float(ts.max()),
         coefficients=coeffs, restore_loss_far_mV=loss_mv,
         restored_voltage=rv.tolist(), reference=APPB_REFERENCE,
         coefficients_equal_cpu=True, restore_max_abs_err_vs_cpu=rv_err,
         map_cpu_cells=int(idx.numel()), map_vs_cpu=cpu_cmp)
    return launches


def lifetime_phase(batch, pop) -> dict:
    """Phase 17: the lifetime lifecycle; returns its launches (none: the
    reference's epoch scan is fused jnp)."""
    dev = batch.device
    temps = np.full(len(LIFE_AGES), LIFE_TEMP)
    ops.reset_launches()
    torch.cuda.synchronize()
    secs = {}
    t0 = time.perf_counter()
    life = lifetime_population(batch, LIFE_AGES, temps)
    secs["fig_lifetime"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    banked = lifetime_population(
        DimmBatch.from_population(pop[:LIFE_BANK_DIMMS], dev), LIFE_AGES,
        temps, banks=4)
    secs["banks4"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    al = ALDRAM.install(pop[0], device=dev)
    fig18 = {}
    for t in (55.0, 85.0):
        lr_diva = latency_reduction(diva_profile(pop[0], temp_C=t, device=dev))
        lr_al = latency_reduction(al.timing(t))
        fig18[f"{int(t)}C"] = dict(
            diva_read=lr_diva["read_reduction"],
            diva_write=lr_diva["write_reduction"],
            aldram_read=lr_al["read_reduction"],
            aldram_write=lr_al["write_reduction"])
    secs["fig18"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prof = DivaProfiler(pop[0], period_steps=1, years_per_period=2.0,
                        device=dev)
    served = [prof.timing() for _ in range(PROFILER_EPOCHS)]
    secs["diva_profiler"] = time.perf_counter() - t0
    launches = counted({})

    D, E = batch.n_dimms, len(LIFE_AGES)
    t = life["timings"]
    if t.shape != (E, D, 4) or life["stale_fail"].shape != (E, D) \
            or not np.isfinite(life["ecc_lambda"]).all():
        raise AssertionError("lifetime: bad shapes or non-finite ECC exposure")
    if not (np.diff(t, axis=0) >= 0).all():
        raise AssertionError("lifetime: aging at a fixed temperature lowered "
                             "a profiled timing")
    if banked["timings"].shape != (E, LIFE_BANK_DIMMS, 4, 4) or not \
            np.array_equal(banked["timings"].max(axis=2),
                           t[:, :LIFE_BANK_DIMMS]):
        raise AssertionError("per-bank lifetime tables do not have the "
                             "whole-DIMM tables as their envelope")
    for temp in (55.0, 85.0):
        if al.timing(temp) != conventional_profile(pop[0], temp_C=temp,
                                                   device=dev):
            raise AssertionError(f"ALDRAM's {temp} C bin is not the "
                                 f"conventional profile")

    # checks against the port on the CPU
    t0 = time.perf_counter()
    k = LIFE_CPU_DIMMS
    cpu = lifetime_population(DimmBatch.from_population(pop[:k], "cpu"),
                              LIFE_AGES, temps)
    for key in ("timings", "stale_fail"):
        if not np.array_equal(life[key][:, :k], cpu[key]):
            raise AssertionError(f"lifetime {key} differs on the card and the "
                                 f"CPU")
    np.testing.assert_allclose(life["ecc_lambda"][:, :k], cpu["ecc_lambda"],
                               rtol=ECC_RTOL)
    ecc_rel = float(np.max(np.abs(life["ecc_lambda"][:, :k] - cpu["ecc_lambda"])
                           / np.maximum(np.abs(cpu["ecc_lambda"]), 1e-30)))
    prof_cpu = DivaProfiler(pop[0], period_steps=1, years_per_period=2.0,
                            device="cpu")
    if served != [prof_cpu.timing() for _ in range(PROFILER_EPOCHS)]:
        raise AssertionError("DivaProfiler tables differ on the card and the "
                             "CPU")
    secs["cpu_check"] = time.perf_counter() - t0
    DENSE["lifetime"] = life
    read = t[:, :, :3].sum(axis=2)                       # tRCD + tRAS + tRP
    emit("lifetime", dimms=D, epochs=E, ages=LIFE_AGES.tolist(),
         temp_C=LIFE_TEMP, seconds=secs, launches=launches,
         read_ns_mean_age0=float(read[0].mean()),
         read_ns_mean_age10=float(read[-1].mean()),
         read_drift_ns=float(read[-1].mean() - read[0].mean()),
         drift_ns={p: float(t[-1, :, i].mean() - t[0, :, i].mean())
                   for i, p in enumerate(("trcd", "tras", "trp", "twr"))},
         stale_share=float(life["stale_fail"].mean()),
         stale_share_by_epoch=life["stale_fail"].mean(axis=1).tolist(),
         mean_ecc_lambda=float(life["ecc_lambda"].mean()),
         mean_ecc_lambda_age10=float(life["ecc_lambda"][-1].mean()),
         banks4_dimms=LIFE_BANK_DIMMS,
         banks4_stale_share=float(banked["stale_fail"].mean()),
         fig18_dimm0=fig18, profiler_served=[
             dataclasses.astuple(s) for s in served],
         cpu_dimms=k, equal_cpu=True, ecc_max_rel_err_vs_cpu=ecc_rel,
         ecc_rtol=ECC_RTOL, profiler_equal_cpu_epochs=PROFILER_EPOCHS)
    return launches


def wkv_inputs(shape, dev, dtype=torch.float32, seed=0):
    """Seeded r, k, v, wlog (normal, std 0.5) of ``shape`` in ``dtype`` and
    u (H, dh) float32 (std 0.1) on the card: tests/test_kernels.py's draws."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rkvw = [(torch.randn(shape, generator=gen, device=dev) * 0.5).to(dtype)
            for _ in range(4)]
    return (*rkvw, torch.randn(shape[2:], generator=gen, device=dev) * 0.1)


def wkv_state(shape, dev, seed):
    B, _, H, dh = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((B, H, dh, dh), generator=gen, device=dev) * 0.5


def wkv_compare(args, s0, label: str) -> float:
    """``wkv6`` against ``wkv6_ref`` on the same inputs: ``y`` and the final
    state within the dtype's bound (rtol = atol), or raise.  Returns the
    largest |kernel - plain|."""
    (y, s), (yr, sr) = wkv6(*args, init_state=s0), wkv6_ref(*args, init_state=s0)
    torch.cuda.synchronize()
    tol = WKV_TOL[args[0].dtype]
    err = 0.0
    for got, want in ((y, yr), (s, sr)):
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"wkv6 ({label}) gave {tuple(got.shape)}, "
                                 f"not finite or not {tuple(want.shape)}")
        diff = (got - want).abs()
        if bool((diff > tol + tol * want.abs()).any()):
            raise AssertionError(f"wkv6 ({label}) differs from its plain "
                                 f"version by {float(diff.max())} (bound {tol})")
        err = max(err, float(diff.max()))
    return err


def serving_dtypes(args):
    """r, k, v, wlog, u as the serving path passes them: k and v in bfloat16,
    r, wlog and u in float32."""
    r, k, v, w, u = args
    return r, k.bfloat16(), v.bfloat16(), w, u


def decode_run(fn, n: int) -> tuple[float, float]:
    """``n`` calls of ``fn`` queued behind a sleeping kernel, so that the
    card runs their launches back to back: (device ms per launch over one
    pair of CUDA events around the n launches, host us per call)."""
    torch.cuda.synchronize()
    torch.cuda._sleep(int(4e7))   # ~20 ms of the card's clock: longer than the enqueue
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    h0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_us = (time.perf_counter() - h0) / n * 1e6
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n, host_us


def wkv_kernel_vs_plain(dev) -> dict:
    """Phase 18: ``wkv6`` against its plain version; returns its
    ``kernels``-line fields (at the prefill shape)."""
    cases = {}
    pre = wkv_inputs(WKV_PREFILL, dev, seed=1)
    cases["prefill"] = wkv_compare(pre, None, "prefill")
    pre_s0 = wkv_state(WKV_PREFILL, dev, seed=2)
    cases["prefill_init_state"] = wkv_compare(pre, pre_s0, "prefill, init state")
    dec = wkv_inputs(WKV_DECODE, dev, seed=3)
    dec_s0 = wkv_state(WKV_DECODE, dev, seed=4)
    cases["decode_init_state"] = wkv_compare(dec, dec_s0, "decode")
    for shape in WKV_SWEEP:
        for dtype in (torch.float32, torch.float16):
            label = "x".join(map(str, shape)) + f"_{str(dtype)[6:]}"
            cases[label] = wkv_compare(wkv_inputs(shape, dev, dtype, seed=shape[1]),
                                       None, label)
    cases["prefill_float16"] = wkv_compare(
        wkv_inputs(WKV_PREFILL, dev, torch.float16, seed=5), None, "prefill f16")
    for S in WKV_AROUND_CHUNK:
        for dh in (8, 64):
            shape = (2, S, 3, dh)
            label = f"S{S}_dh{dh}_init_state"
            cases[label] = wkv_compare(wkv_inputs(shape, dev, seed=100 + S),
                                       wkv_state(shape, dev, seed=200 + S), label)
    # the serving path's dtypes, held to the plain version on the same tensors
    pre_mix, dec_mix = serving_dtypes(pre), serving_dtypes(dec)
    cases["prefill_serving_dtypes"] = wkv_compare(pre_mix, pre_s0, "prefill, serving dtypes")
    cases["decode_serving_dtypes"] = wkv_compare(dec_mix, dec_s0, "decode, serving dtypes")
    ms = cuda_ms(lambda: wkv6(*pre), 20)
    plain_ms = cuda_ms(lambda: wkv6_ref(*pre), 5)
    mix_ms = cuda_ms(lambda: wkv6(*pre_mix, init_state=pre_s0), 20)
    dec_ms = cuda_ms(lambda: wkv6(*dec, init_state=dec_s0), 20)
    dec_plain_ms = cuda_ms(lambda: wkv6_ref(*dec, init_state=dec_s0), 5)
    dec_run_ms, dec_host_us = decode_run(lambda: wkv6(*dec_mix, init_state=dec_s0),
                                         WKV_DECODE_RUN)
    n_bytes, n_ops = wkv6_work(*pre)
    dec_bytes, dec_ops = wkv6_work(*dec, dec_s0)
    bw, flops = PEAK_BYTES_PER_S, PEAK_FP32_FLOPS
    fields = dict(ms=ms, plain_ms=plain_ms, bytes_ms=n_bytes / bw * 1e3,
                  ops_ms=n_ops / flops * 1e3, library_ms=None,
                  max_abs_err=max(cases.values()))
    emit("kernel_vs_plain", kernel="wkv6", shape=list(WKV_PREFILL),
         max_abs_err_by_case=cases,
         bound={"float32": WKV_TOL[torch.float32],
                "float16": WKV_TOL[torch.float16]},
         bytes=n_bytes, flops=n_ops, serving_dtypes_ms=mix_ms,
         decode_shape=list(WKV_DECODE), decode_ms=dec_ms,
         decode_kernel_ms_each=dec_run_ms, decode_launches_timed=WKV_DECODE_RUN,
         decode_wrapper_host_us_per_call=dec_host_us, decode_plain_ms=dec_plain_ms,
         decode_bytes_ms=dec_bytes / bw * 1e3, decode_ops_ms=dec_ops / flops * 1e3,
         library="none (no single PyTorch call computes the recurrence)",
         **fields)
    return fields


def allclose_err(got, want, tol: float, what: str) -> float:
    """max |got - want| after checking |got - want| <= tol + tol * |want|
    (numpy's assert_allclose with rtol = atol = tol) on the host."""
    got, want = got.float().cpu(), want.float().cpu()
    diff = (got - want).abs()
    if got.shape != want.shape or not torch.isfinite(got).all() \
            or bool((diff > tol + tol * want.abs()).any()):
        raise AssertionError(f"{what}: max |difference| {float(diff.max())}, "
                             f"bound {tol}")
    return float(diff.max())


def greedy(logits):
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def teacher_logits(cfg, params, seq):
    """Prefill ``seq[:, :CPU_PROMPT]`` and decode its other tokens one by one
    on the parameters' device: every step's last logits, (B, n, V) float32
    on the host."""
    seq = seq.to(model.param_device(params))
    logits, cache = model_cache.prefill(cfg, params, {"tokens": seq[:, :CPU_PROMPT]})
    out = [logits[:, -1]]
    for t in range(CPU_PROMPT, seq.shape[1]):
        logits, cache = model_cache.decode_step(cfg, params, cache, seq[:, t:t + 1])
        out.append(logits[:, -1])
    return torch.stack(out, dim=1).float().cpu()


def rwkv6_serving_phase(dev) -> dict:
    """Phase 19: RWKV-6 serving at full width; returns its launches."""
    cfg = get_config(ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init_params(SERVE_SEED, cfg, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    prompts = make_batch(cfg, SERVE_BATCH, SERVE_PROMPT, seed=0, step=0)
    prompts["tokens"] = prompts["tokens"][:, :-1]
    ops.reset_launches()
    torch.cuda.synchronize()
    toks, stats = generate(cfg, params, prompts, max_new=SERVE_NEW, device=dev)
    launches = counted({"wkv6": cfg.n_layers * SERVE_NEW})
    peak = torch.cuda.max_memory_allocated(dev)
    if toks.shape != (SERVE_BATCH, SERVE_NEW) or toks.dtype != torch.int32 \
            or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"generate gave {tuple(toks.shape)} {toks.dtype}")

    # decode against teacher-forced forward, full width, float32 compute
    f32 = cfg.replace(compute_dtype="float32")
    seq = torch.as_tensor(make_batch(cfg, 1, TF_PROMPT + TF_DECODE, seed=3,
                                     step=0)["tokens"][:, :-1], device=dev)
    full, _ = model.forward(f32, params, {"tokens": seq})
    logits, cache = model_cache.prefill(f32, params, {"tokens": seq[:, :TF_PROMPT]})
    tf_prefill = allclose_err(logits[0, -1], full[0, TF_PROMPT - 1],
                              TF_PREFILL_TOL, "prefill against forward")
    tf_decode = 0.0
    for t in range(TF_PROMPT, TF_PROMPT + TF_DECODE):
        logits, cache = model_cache.decode_step(f32, params, cache, seq[:, t:t + 1])
        tf_decode = max(tf_decode, allclose_err(logits[0, -1], full[0, t],
                                                TF_DECODE_TOL, "decode against forward"))
    del params, full, cache
    torch.cuda.empty_cache()
    emit("rwkv6_serving", arch=ARCH, n_layers=cfg.n_layers, d_model=cfg.d_model,
         vocab=cfg.vocab_size, compute_dtype=cfg.compute_dtype, params=n_params,
         init_s=init_s, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
         new_tokens=SERVE_NEW, launches=launches, **stats,
         max_memory_allocated=peak, first_tokens=toks[:2, :8].tolist(),
         teacher_forced=dict(compute_dtype="float32", prompt=TF_PROMPT,
                             decode=TF_DECODE, prefill_max_abs_err=tf_prefill,
                             decode_max_abs_err=tf_decode,
                             bounds=[TF_PREFILL_TOL, TF_DECODE_TOL]))

    # the card against the port on the CPU: 2 layers, full width, float32
    small = cfg.replace(n_layers=CPU_LAYERS, compute_dtype="float32")
    host = model.init_params(SERVE_SEED, small, device="cpu")
    card = model.params_to(host, dev)
    prompts = make_batch(small, CPU_BATCH, CPU_PROMPT, seed=1, step=0)
    prompts["tokens"] = prompts["tokens"][:, :-1]
    tok_h = torch.as_tensor(prompts["tokens"])
    lh, ch = model_cache.prefill(small, host, {"tokens": tok_h})
    lg, cg = model_cache.prefill(small, card, {"tokens": tok_h.to(dev)})
    errs = [allclose_err(lg, lh, CARD_CPU_TOL, "prefill logits, card vs CPU")]
    for _ in range(CPU_DECODE):
        th, tg = greedy(lh), greedy(lg)
        if not torch.equal(tg.cpu(), th):
            raise AssertionError(f"greedy tokens differ: card {tg.tolist()}, "
                                 f"CPU {th.tolist()}")
        lh, ch = model_cache.decode_step(small, host, ch, th[:, None])
        lg, cg = model_cache.decode_step(small, card, cg, tg[:, None])
        errs.append(allclose_err(lg, lh, CARD_CPU_TOL, "decode logits, card vs CPU"))
    state_err = max(allclose_err(cg[k], ch[k], CARD_CPU_TOL, f"cache {k}")
                    for k in ("shift_t", "shift_c", "wkv"))
    gen_h, _ = generate(small, host, prompts, max_new=CPU_DECODE + 1, device="cpu")
    gen_g, _ = generate(small, card, prompts, max_new=CPU_DECODE + 1, device=dev)
    if not torch.equal(gen_g.cpu(), gen_h):
        raise AssertionError(f"generate differs: card {gen_g.tolist()}, CPU "
                             f"{gen_h.tolist()}")
    emit("rwkv6_card_vs_cpu", n_layers=CPU_LAYERS, d_model=small.d_model,
         vocab=small.vocab_size, compute_dtype="float32", batch=CPU_BATCH,
         prompt_len=CPU_PROMPT, decode_steps=CPU_DECODE,
         prefill_max_abs_err=errs[0], decode_max_abs_err=max(errs[1:]),
         cache_max_abs_err=state_err, bound=CARD_CPU_TOL,
         greedy_tokens_identical=True, tokens=gen_h.tolist())

    # the same in bfloat16 compute, teacher-forced on one token sequence,
    # beside two faulty ports on the card as controls
    bf = small.replace(compute_dtype="bfloat16")
    seq = torch.as_tensor(make_batch(small, CPU_BATCH, CPU_PROMPT + CPU_DECODE,
                                     seed=2, step=0)["tokens"][:, :-1])
    want = teacher_logits(bf, host, seq)
    diff = (teacher_logits(bf, card, seq) - want).abs()
    r_bf16 = {**card, "layers": {**card["layers"],
                                 "wr": card["layers"]["wr"].bfloat16()}}
    controls = {name: (teacher_logits(c, p, seq) - want).abs()
                for name, c, p in (("float32_compute", small, card),
                                   ("r_in_bfloat16", bf, r_bf16))}
    bf_max, bf_mean = float(diff.max()), float(diff.mean())
    if not torch.isfinite(diff).all() or bf_max > BF16_CARD_CPU_MAX \
            or bf_mean > BF16_CARD_CPU_MEAN:
        raise AssertionError(f"bfloat16 logits, card vs CPU: max {bf_max}, "
                             f"mean {bf_mean}, bounds {BF16_CARD_CPU_MAX}, "
                             f"{BF16_CARD_CPU_MEAN}")
    for name, d in controls.items():
        if float(d.max()) <= BF16_CARD_CPU_MAX and float(d.mean()) <= BF16_CARD_CPU_MEAN:
            raise AssertionError(f"the bfloat16 bounds pass a faulty port "
                                 f"({name}): max {float(d.max())}, mean "
                                 f"{float(d.mean())}")
    emit("rwkv6_card_vs_cpu_bf16", n_layers=CPU_LAYERS, d_model=bf.d_model,
         vocab=bf.vocab_size, compute_dtype="bfloat16", batch=CPU_BATCH,
         prompt_len=CPU_PROMPT, decode_steps=CPU_DECODE, max_abs_err=bf_max,
         mean_abs_err=bf_mean, bounds=[BF16_CARD_CPU_MAX, BF16_CARD_CPU_MEAN],
         logit_abs_max=float(want.abs().max()),
         controls={k: {"max_abs_err": float(v.max()),
                       "mean_abs_err": float(v.mean())}
                   for k, v in controls.items()})
    return launches


def wkv_bwd_inputs(shape, dev, seed, with_state, kv_dtype=torch.float32):
    """``wkv_inputs`` (``k``/``v`` in ``kv_dtype``), a seeded cotangent
    ``dy`` (std 1) and, ``with_state``, a start state (std 0.5) and a
    final-state cotangent (std 1): the arguments of ``wkv6_bwd``."""
    r, k, v, w, u = wkv_inputs(shape, dev, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    dy = torch.randn(shape, generator=gen, device=dev)
    s0 = ds = None
    if with_state:
        B, _, H, dh = shape
        s0 = torch.randn((B, H, dh, dh), generator=gen, device=dev) * 0.5
        ds = torch.randn((B, H, dh, dh), generator=gen, device=dev)
    return r, k.to(kv_dtype), v.to(kv_dtype), w, u, s0, dy, ds


def wkv_bwd_compare(args, label: str) -> float:
    """``wkv6_bwd`` against ``wkv6_bwd_ref`` on the same inputs: every
    gradient finite, in its input's dtype and within ``WKV_BWD_TOL``, or
    raise.  Returns the largest |kernel - plain|."""
    got, want = wkv6_bwd(*args), wkv6_bwd_ref(*args)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, w in zip(("dr", "dk", "dv", "dwlog", "du", "dinit"), got, want):
        if w is None:
            if g is not None:
                raise AssertionError(f"wkv6_bwd ({label}) gave {name} without a start state")
            continue
        if g.dtype != w.dtype or g.shape != w.shape or not torch.isfinite(g).all():
            raise AssertionError(f"wkv6_bwd ({label}) {name}: {g.dtype} "
                                 f"{tuple(g.shape)}, not finite or not {w.dtype} "
                                 f"{tuple(w.shape)}")
        rtol, atol = WKV_BWD_TOL[torch.bfloat16 if w.dtype == torch.bfloat16
                                 else torch.float32]
        diff = (g.float() - w.float()).abs()
        if bool((diff > atol + rtol * w.float().abs()).any()):
            raise AssertionError(f"wkv6_bwd ({label}) {name} differs from its plain "
                                 f"version by {float(diff.max())} (rtol {rtol}, atol {atol})")
        err = max(err, float(diff.max()))
    return err


def ptxas_report(log: str, symbol: str) -> dict:
    """Registers and spill bytes of each kernel whose mangled name holds
    ``symbol``, from nvcc's ``-Xptxas=-v`` output: {name: {registers,
    spill_stores, spill_loads}}."""
    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if entry:
            name = entry.group(1) if symbol in entry.group(1) else None
            if name:
                out.setdefault(name, {})
            continue
        if name is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            out[name]["spill_stores"], out[name]["spill_loads"] = map(int, spill.groups())
        used = re.search(r"Used (\d+) registers", line)
        if used:
            out[name]["registers"] = int(used.group(1))
    return out


def wkv_bwd_resources(nvcc_log: str) -> dict:
    """The backward kernel's launch shape and occupancy at each head width
    (the CUDA runtime's report, at the training shape's B*H, with its local
    bytes a thread) and ptxas's registers and spills from ``nvcc_log`` (its
    build's output, empty if it was built before this run); raises if
    either reports a spill."""
    B, _, H, _ = WKV_TRAIN
    occ = {dh: wkv6_bwd_resources(dh, B * H) for dh in WKV_DH}
    ptxas = ptxas_report(nvcc_log, "wkv6_bwd_kernel")
    spills = {n: p for n, p in ptxas.items()
              if p.get("spill_stores", 0) or p.get("spill_loads", 0)}
    if spills or any(o["local_bytes"] for o in occ.values()):
        raise AssertionError(f"wkv6_bwd spills: ptxas {spills}, runtime {occ}")
    emit("wkv6_bwd_resources", by_dh=occ, ptxas=ptxas,
         ptxas_log="present" if ptxas else "not built in this run")
    return occ


def wkv_bwd_kernel_vs_plain(dev, nvcc_log: str) -> dict:
    """Phase 23: ``wkv6_bwd``'s resources (``wkv_bwd_resources``), then the
    kernel against its plain version; returns its ``kernels``-line fields
    (at the training shape, float32)."""
    wkv_bwd_resources(nvcc_log)
    cases = {}
    main_args = wkv_bwd_inputs(WKV_TRAIN, dev, seed=31, with_state=False)
    cases["train"] = wkv_bwd_compare(main_args, "train")
    mixed = wkv_bwd_inputs(WKV_TRAIN, dev, seed=31, with_state=False,
                           kv_dtype=torch.bfloat16)
    cases["train_bf16_kv"] = wkv_bwd_compare(mixed, "train, bfloat16 k/v")
    cases["train_init_state"] = wkv_bwd_compare(
        wkv_bwd_inputs(WKV_TRAIN, dev, seed=33, with_state=True), "train, init state")
    for shape in WKV_BWD_EDGES:
        for with_state in (False, True):
            label = "x".join(map(str, shape)) + ("_init_state" if with_state else "")
            cases[label] = wkv_bwd_compare(
                wkv_bwd_inputs(shape, dev, seed=shape[1] * shape[3], with_state=with_state),
                label)
    # no atomics: the same bits every run
    first, again = wkv6_bwd(*mixed), wkv6_bwd(*mixed)
    if not all(torch.equal(a, b) for a, b in zip(first, again) if a is not None):
        raise AssertionError("wkv6_bwd gave other bits on a second run")
    ms = cuda_ms(lambda: wkv6_bwd(*main_args), 20)
    mix_ms = cuda_ms(lambda: wkv6_bwd(*mixed), 20)
    plain_ms = cuda_ms(lambda: wkv6_bwd_ref(*main_args), 3)
    fwd_ms = cuda_ms(lambda: wkv6(*main_args[:5]), 20)
    n_bytes, n_ops = wkv6_bwd_work(*main_args)
    mix_bytes, _ = wkv6_bwd_work(*mixed)
    bw, flops = PEAK_BYTES_PER_S, PEAK_FP32_FLOPS
    fields = dict(ms=ms, plain_ms=plain_ms, bytes_ms=n_bytes / bw * 1e3,
                  ops_ms=n_ops / flops * 1e3, library_ms=None,
                  max_abs_err=max(cases.values()))
    emit("kernel_vs_plain", kernel="wkv6_bwd", shape=list(WKV_TRAIN),
         max_abs_err_by_case=cases,
         bound={"float32": list(WKV_BWD_TOL[torch.float32]),
                "bfloat16": list(WKV_BWD_TOL[torch.bfloat16])},
         bytes=n_bytes, flops=n_ops, same_bits_twice=True, training_dtypes_ms=mix_ms,
         training_dtypes_bytes_ms=mix_bytes / bw * 1e3, forward_kernel_ms=fwd_ms,
         library="none (no single PyTorch call computes the recurrence's VJP)",
         **fields)
    return fields


# kernel names by group in the profiled train step
PROFILE_GROUPS = (("wkv6_bwd", ("wkv6_bwd_kernel", "wkv6_du_kernel")), ("wkv6", ("wkv6_kernel",)),
                  ("matmul", ("gemm", "nvjet", "xmma")))


# each wrapper a replayed train step credits with launches, and the kernels
# whose launches those are (``wkv6_bwd``'s second kernel, ``wkv6_du_kernel``,
# runs once a call too but is not counted)
CREDITED_KERNELS = {"wkv6": ("wkv6_kernel",), "wkv6_bwd": ("wkv6_bwd_kernel",),
                    "adamw": ("adamw_kernel",),
                    "grad_sq_norm": ("sq_partials_kernel", "norm_finish_kernel")}


def profile_train_step(cfg, dev, required=("wkv6_bwd", "wkv6"), seq=TRAIN_SEQ) -> dict:
    """One full-size train step of TRAIN_BATCH x ``seq`` tokens, replayed
    from the step's CUDA graph (after three calls: two op by op, then the
    capture), under ``torch.profiler``: wall ms, kernel ms by group and the
    idle share (1 - kernel time / wall time), and the 10 longest kernels.
    Raises unless the step replayed, each group in ``required`` shows
    kernel time, and each kernel the replay credits to the launch counters
    (``ops.launch_counts``) shows in the trace as many times as credited."""
    state = build_state(cfg, device=dev)
    step = make_train_step(cfg)
    batch = make_batch(cfg, TRAIN_BATCH, seq, seed=0, step=0)
    for _ in range(3):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    before = ops.launch_counts()
    replays = REGISTRY.value("repro_train_steps_total", path="graph")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del state
    if REGISTRY.value("repro_train_steps_total", path="graph") != replays + 1:
        raise AssertionError("the profiled train step did not replay its graph")
    credited = {k: n - before[k] for k, n in ops.launch_counts().items() if n != before[k]}
    kernels = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    traced = {name: sum(n for key, n, _ in kernels
                        if any(re.search(rf"\b{sym}\b", key) for sym in syms))
              for name, syms in CREDITED_KERNELS.items()}
    if set(credited) - set(CREDITED_KERNELS) or \
            any(traced[k] != credited.get(k, 0) for k in CREDITED_KERNELS):
        raise AssertionError(f"the replay credited {credited}, its trace shows {traced}")
    groups = dict.fromkeys([g for g, _ in PROFILE_GROUPS] + ["other"], 0.0)
    fp32_mm = 0.0
    for name, _, ms in kernels:
        group = next((g for g, keys in PROFILE_GROUPS if any(k in name for k in keys)), "other")
        groups[group] += ms
        if group == "matmul" and ("f32f32" in name or "sgemm" in name):
            fp32_mm += ms
    kernel_ms = sum(groups.values())
    if not all(groups[g] for g in required):
        raise AssertionError(f"the profiled step shows no {required} kernel: {groups}")
    return dict(wall_ms=wall_ms, kernel_ms=kernel_ms, idle_share=1 - kernel_ms / wall_ms,
                credited_launches=credited, traced_launches=traced,
                kernel_ms_by_group=groups, fp32_matmul_ms=fp32_mm,
                top=[dict(kernel=name[:90], count=n, ms=ms)
                     for name, n, ms in sorted(kernels, key=lambda k: -k[2])[:10]])


def rwkv6_training_phase(dev) -> dict:
    """Phase 24: RWKV-6 training at full width and depth, then the card
    against the CPU port at 2 layers; returns the training run's launches."""
    cfg = get_config(ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = train_main(["--arch", ARCH, "--steps", str(TRAIN_STEPS), "--batch",
                      str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--log-every", "1"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = counted({"wkv6": 2 * cfg.n_layers * TRAIN_STEPS,
                        "wkv6_bwd": cfg.n_layers * TRAIN_STEPS,
                        **optimizer_launches(cfg, TRAIN_STEPS, own_norm=False)})
    peak = torch.cuda.max_memory_allocated(dev)
    losses = out["losses"]
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training losses {losses}")
    steady = statistics.median(out["step_s"][1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    emit("rwkv6_training", arch=ARCH, n_layers=cfg.n_layers, d_model=cfg.d_model,
         d_ff=cfg.d_ff, vocab=cfg.vocab_size, param_dtype=cfg.param_dtype,
         compute_dtype=cfg.compute_dtype, remat=cfg.remat, optimizer=cfg.optimizer,
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS, losses=losses,
         step_s=out["step_s"], first_step_s=out["step_s"][0], median_step_s=steady,
         tokens_per_s=tokens / steady, run_s=run_s, max_memory_allocated=peak,
         launches=launches)
    torch.cuda.empty_cache()
    emit("rwkv6_training_profile", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         **profile_train_step(cfg, dev))
    torch.cuda.empty_cache()

    # the card against the port on the CPU: 2 layers, full width, float32
    emit("rwkv6_training_card_vs_cpu", **train_card_vs_cpu(cfg, dev))
    return launches


def train_card_vs_cpu(cfg, dev, small=None, seq: int = TRAIN_CPU_SEQ) -> dict:
    """``loss_fn`` and its gradients of ``small`` (default: ``cfg`` cut to
    TRAIN_CPU_LAYERS layers, float32 compute) on TRAIN_CPU_BATCH x ``seq``
    tokens, one set of host parameters, on the card and on the CPU: the
    loss, the global gradient norm and every gradient leaf held to the CPU's
    (phase 24's bounds), or raise."""
    if small is None:
        small = cfg.replace(n_layers=TRAIN_CPU_LAYERS, compute_dtype="float32")
    host = model.init_params(SERVE_SEED, small, device="cpu")
    batch = make_batch(small, TRAIN_CPU_BATCH, seq, seed=5, step=0)
    res = {}
    for name, params in (("cpu", host), ("card", model.params_to(host, dev))):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, _ = model.loss_fn(small, p, batch)
        grads = tree_unflatten(p, torch.autograd.grad(loss, tree_leaves(p)))
        res[name] = (float(loss.detach()), float(global_norm(grads)),
                     [g.float().cpu() for g in tree_leaves(grads)])
    (loss_c, gn_c, g_c), (loss_g, gn_g, g_g) = res["cpu"], res["card"]
    if abs(loss_g - loss_c) > TRAIN_LOSS_RTOL * abs(loss_c) \
            or abs(gn_g - gn_c) > TRAIN_GNORM_RTOL * abs(gn_c):
        raise AssertionError(f"card vs CPU: loss {loss_g} / {loss_c}, gnorm "
                             f"{gn_g} / {gn_c}")
    leaf_err = []
    for a, b in zip(g_g, g_c):
        if not torch.isfinite(a).all():
            raise AssertionError("a card gradient is not finite")
        leaf_err.append(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30))
    if max(leaf_err) > TRAIN_GRAD_TOL:
        raise AssertionError(f"card vs CPU gradients: {max(leaf_err)} of the leaf's "
                             f"largest (bound {TRAIN_GRAD_TOL})")
    return dict(arch=cfg.arch_id, n_layers=small.n_layers, n_enc_layers=small.n_enc_layers,
                d_model=small.d_model, vocab=small.vocab_size,
                compute_dtype=small.compute_dtype, batch=TRAIN_CPU_BATCH,
                seq=seq, loss_cpu=loss_c, loss_card=loss_g, gnorm_cpu=gn_c,
                gnorm_card=gn_g, leaves=len(leaf_err), max_scaled_grad_err=max(leaf_err),
                bounds=dict(loss_rtol=TRAIN_LOSS_RTOL, gnorm_rtol=TRAIN_GNORM_RTOL,
                            grad_scaled=TRAIN_GRAD_TOL))


def _flip_lanes(step_dir: Path, leaf: int) -> None:
    """Flip FLEET_FLIP_BITS contiguous stored lanes of one leaf's ECC
    sidecar (the checkpoint layout: packed (G, 576) lanes a leaf)."""
    path = step_dir / f"leaf_{leaf}.ecc.npy"
    lanes = np.unpackbits(np.load(path), axis=1)
    lanes[0, FLEET_FLIP_LANE:FLEET_FLIP_LANE + FLEET_FLIP_BITS] ^= 1
    np.save(path, np.packbits(lanes, axis=1))


def fleet_phase(dev) -> dict:
    """Phase 20: the fleet timing-table service at the benchmark geometry;
    returns its launches (ingest, and tick + checkpoint save and load)."""
    n, chunk = FLEET_DIMMS, FLEET_CHUNK
    cfg = FleetConfig(chunk_size=chunk)
    fleet = synthetic_fleet(n, FLEET_GEOM, seed=0, device=dev)
    g = fleet.geom
    T = len(cfg.campaign_t_ops)
    per_point = g.subarrays * len(DEFAULT_PATTERNS)   # row_error_lambda
    secs = {}
    with tempfile.TemporaryDirectory() as ckpt:
        server = FleetServer(fleet, cfg, checkpoint_dir=ckpt)
        # ingest chunk by chunk: a chunk founds generations iff the count
        # of generations grows (every new leader is discovered at once)
        ops.reset_launches()
        torch.cuda.synchronize()
        chunk_s, founding, gens = [], 0, 0
        stats = dict(hits=0, misses=0, conventional=0)
        for _ in range(0, n, chunk):
            t0 = time.perf_counter()
            st = server.ingest(chunk, now=0.0)
            chunk_s.append(time.perf_counter() - t0)
            founding += st["n_generations"] > gens
            gens = st["n_generations"]
            for key in stats:
                stats[key] += st[key]
        secs["ingest"] = sum(chunk_s)
        n_chunks = len(chunk_s)
        ingest_launches = counted({
            "fail_prob_rows": per_point * T * (n_chunks + founding),
            "bit_signature": T * (n_chunks + founding)})
        if sum(stats.values()) != n or len(server.state) != n:
            raise AssertionError(f"fleet service ingested {stats} of {n}")
        path = server.state.view("path")
        if not ((path == PATH_HIT).sum() == stats["hits"]
                and (path == PATH_DISCOVER).sum() == stats["misses"]
                and (path == PATH_CONVENTIONAL).sum() == stats["conventional"]):
            raise AssertionError("fleet paths disagree with the ingest stats")

        # queries: 100,000 random serials, then every DIMM
        serials = np.random.default_rng(20).integers(0, n, FLEET_QUERIES)
        t0 = time.perf_counter()
        tables = server.query_batch(serials)
        secs["queries"] = time.perf_counter() - t0
        every = server.query_batch(np.arange(n))
        if tables.shape != (FLEET_QUERIES, 4) or every.shape != (n, 4) \
                or not np.isfinite(every).all() \
                or not np.array_equal(tables, every[serials]):
            raise AssertionError("fleet queries: bad shape, non-finite or "
                                 "inconsistent tables")

        # the serve bench's oracle gate on the first DIMMs, before the tick
        t0 = time.perf_counter()
        k = FLEET_ORACLE_DIMMS
        first = fleet.chunk(0, k)
        kw = dict(temp_C=cfg.profile_temp_C,
                  refresh_ms=cfg.profile_refresh_ms,
                  guard_cycles=cfg.guard_cycles,
                  multibit_only=cfg.multibit_only)
        conv = path[:k] == PATH_CONVENTIONAL
        diva = profile_population_arrays(first, region="worst", **kw)[:, :4]
        if not np.array_equal(every[:k][~conv], diva[~conv]):
            raise AssertionError("a HIT or DISCOVER table differs from the "
                                 "dense DIVA oracle")
        conv_idx = np.flatnonzero(conv)[:FLEET_ORACLE_CONV]
        if len(conv_idx):
            full = profile_population_arrays(take_batch(first, conv_idx),
                                             region="all", **kw)[:, :4]
            if not np.array_equal(every[conv_idx], full):
                raise AssertionError("a CONVENTIONAL table differs from the "
                                     "every-row oracle")
        secs["oracle"] = time.perf_counter() - t0

        # re-profile at the fleet's smallest horizon, then checkpoint
        ops.reset_launches()
        torch.cuda.synchronize()
        now = float(server.state.view("horizon").min())
        due = int((server.state.view("due_at") <= now).sum())
        t0 = time.perf_counter()
        tick = server.tick(now)
        secs["tick"] = time.perf_counter() - t0
        if tick["reprofiled"] != due or due == 0:
            raise AssertionError(f"tick re-profiled {tick}, {due} were due")
        t0 = time.perf_counter()
        saved = server.save(step=0)
        secs["save"] = time.perf_counter() - t0
        state = server.state_dict()
        _flip_lanes(saved, sorted(state).index(FLEET_FLIP_LEAF))
        fresh = FleetServer(fleet, cfg, checkpoint_dir=ckpt)
        t0 = time.perf_counter()
        info = fresh.load()
        secs["load"] = time.perf_counter() - t0
        leaves = sum(1 for v in state.values() if v.nbytes)
        ckpt_launches = counted({"secded_encode": leaves,
                                 "diva_shuffle": 2 * leaves,
                                 "secded_syndrome": leaves})
        if info["corrected_codewords"] < 1:
            raise AssertionError("the flipped run was not corrected")
        if not np.array_equal(fresh.query_batch(np.arange(n)),
                              server.query_batch(np.arange(n))):
            raise AssertionError("the restored server serves other tables")
        for field in ("label", "path", "due_at", "profiled_at", "horizon"):
            if not np.array_equal(fresh.state.view(field),
                                  server.state.view(field)):
                raise AssertionError(f"the restored server's {field} differs")
    launches = {name: ingest_launches[name] + ckpt_launches[name]
                for name in ingest_launches}
    verified = sum(st["verified"] for st in server.founding_stats.values())
    emit("fleet_service", dimms=n, chunk_size=chunk,
         geometry=dataclasses.asdict(g),
         paths={"hit": stats["hits"], "discover": stats["misses"],
                "conventional": stats["conventional"]},
         generations=gens, verified_generations=verified,
         founding_chunks=founding, chunks=n_chunks,
         ingest_seconds=secs["ingest"], chunk_seconds=chunk_s,
         dimms_per_s=n / secs["ingest"], queries=FLEET_QUERIES,
         query_seconds=secs["queries"],
         queries_per_s=FLEET_QUERIES / secs["queries"],
         oracle_dimms=k, oracle_conventional_dimms=len(conv_idx),
         oracle_equal=True, oracle_seconds=secs["oracle"],
         tick_now_years=now, reprofiled=tick["reprofiled"],
         tick_seconds=secs["tick"], save_seconds=secs["save"],
         load_seconds=secs["load"], checkpoint_leaves=leaves,
         flipped_leaf=FLEET_FLIP_LEAF, flipped_bits=FLEET_FLIP_BITS,
         corrected_codewords=info["corrected_codewords"],
         restored_equal=True, ingest_launches=ingest_launches,
         checkpoint_launches=ckpt_launches, launches=launches)
    return launches


def serve_twin_phase(dev) -> dict:
    """Phase 21: the service on the card against the CPU port (both fed the
    card's counts), each host's own draws compared, and the serving CLI on
    the card; returns the card's launches."""
    cfg = FleetConfig(chunk_size=TWIN_CHUNK)
    recorded = {}

    def key(batch, t_op):
        return int(batch.serial[0]), batch.n_dimms, float(t_op)

    def card_counts(batch, param, t_op, **kw):
        counts = hash_poisson_counts(batch, param, t_op, **kw)
        recorded[key(batch, t_op)] = (param, kw, counts)
        return counts

    def replay(batch, param, t_op, **kw):
        return recorded[key(batch, t_op)][2]

    secs = {}
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = FleetServer(synthetic_fleet(TWIN_DIMMS, TWIN_GEOM, seed=0,
                                       device=dev), cfg,
                       counts_fn=card_counts)
    card_stats = card.ingest(now=0.0)
    secs["card"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        metrics, trace = Path(d) / "metrics.prom", Path(d) / "trace.json"
        t0 = time.perf_counter()
        cli = serve_main(["--fleet", str(CLI_FLEET), "--chunk",
                          str(CLI_CHUNK), "--ckpt-dir", str(Path(d) / "ck"),
                          "--metrics-out", str(metrics),
                          "--trace-out", str(trace)])
        secs["cli"] = time.perf_counter() - t0
        launches = ops.launch_counts()
        text = metrics.read_text()
        spans = [e for e in json.loads(trace.read_text())["traceEvents"]
                 if e["name"] == "serve.ingest_chunk"]
    used = ("fail_prob_rows", "bit_signature", "secded_encode", "diva_shuffle")
    if any(launches[k] == 0 for k in used) \
            or any(v for k, v in launches.items() if k not in used):
        raise AssertionError(f"phase 21 launches {launches}")
    sid = cli["metrics"]["server"]
    for path, stat in (("hit", "hits"), ("discover", "misses"),
                       ("conventional", "conventional")):
        line = f'repro_serve_ingest_total{{server="{sid}",path="{path}"}} '
        if line + f"{cli[stat]}\n" not in text:
            raise AssertionError(f"the metrics file lacks {line}{cli[stat]}")
    if len(spans) != -(-CLI_FLEET // CLI_CHUNK):
        raise AssertionError(f"the trace holds {len(spans)} ingest chunks")

    t0 = time.perf_counter()
    cpu = FleetServer(synthetic_fleet(TWIN_DIMMS, TWIN_GEOM, seed=0,
                                      device="cpu"), cfg, counts_fn=replay)
    cpu_stats = cpu.ingest(now=0.0)
    secs["cpu"] = time.perf_counter() - t0
    if cpu_stats != card_stats:
        raise AssertionError(f"ingest stats: card {card_stats}, CPU "
                             f"{cpu_stats}")
    a, b = card.state_dict(), cpu.state_dict()
    for k in a:
        if not np.array_equal(a[k], b[k]):
            raise AssertionError(f"the card's and the CPU's {k} differ")
    if card.founding_stats != cpu.founding_stats:
        raise AssertionError("founding stats differ on the card and the CPU")
    # each host sampling its own lambdas: the +-1 kind of ROADMAP queue 3
    own = synthetic_fleet(TWIN_DIMMS, TWIN_GEOM, seed=0, device="cpu")
    n_draws = n_diff = max_diff = 0
    for (lo, c, t_op), (param, kw, counts) in recorded.items():
        mine = hash_poisson_counts(own.chunk(lo, lo + c), param, t_op, **kw)
        diff = np.abs(mine - counts)
        n_draws += diff.size
        n_diff += int((diff > 0).sum())
        max_diff = max(max_diff, int(diff.max()))
    emit("fleet_service_vs_cpu", dimms=TWIN_DIMMS, chunk_size=TWIN_CHUNK,
         geometry="TINY", stats=card_stats, equal_cpu=True,
         compared=sorted(a) + ["founding_stats"],
         draws=n_draws, draws_differing_own_lambdas=n_diff,
         max_draw_diff=max_diff, seconds=secs,
         cli=dict(fleet=CLI_FLEET, chunk=CLI_CHUNK, ingest_s=cli["ingest_s"],
                  hits=cli["hits"], misses=cli["misses"],
                  conventional=cli["conventional"],
                  generations=cli["n_generations"], ingest_chunk_spans=len(spans)),
         launches=launches)
    return launches


def _scan(name: str, fn, used: tuple, secs: dict, launches: dict):
    """One streamed scan, counted: every kernel of ``used`` must launch and
    no other."""
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs[name] = time.perf_counter() - t0
    got = ops.launch_counts()
    if any(got[k] == 0 for k in used) \
            or any(v for k, v in got.items() if k not in used):
        raise AssertionError(f"{name} launched {got}, expected {used}")
    launches[name] = {k: v for k, v in got.items() if v}
    return out


def stream_scans_phase(batch, diva) -> dict:
    """Phase 22: the streamed scans in ragged chunks against the dense card
    results of phases 4-17; returns their launches, summed."""
    dev = batch.device
    D = batch.n_dimms
    stream = PopulationStream.from_batch(batch)
    secs, launches, checks = {}, {}, {}

    out = _scan("profile", lambda: stream_profile_population(
        stream, chunk_size=SCAN_CHUNK, collect=True, multibit_only=True),
        (), secs, launches)
    if not np.array_equal(out["tables"], diva):
        raise AssertionError("streamed DIVA tables differ from phase 4's")

    out = _scan("operating_grid", lambda: stream_operating_grid(
        stream, OP_POINTS, chunk_size=SCAN_CHUNK, collect=True),
        (), secs, launches)
    dense = DENSE["op_grid"]
    if not np.array_equal(out["fails"], dense["fails"]):
        raise AssertionError("streamed grid decisions differ from phase 12's")
    np.testing.assert_allclose(out["lam"], dense["lam"], rtol=LAMBDA_RTOL)
    checks["grid_lam_max_rel"] = float(np.max(
        np.abs(out["lam"] - dense["lam"])
        / np.maximum(np.abs(dense["lam"]), 1e-30)))

    temps = np.full(len(LIFE_AGES), LIFE_TEMP)
    out = _scan("lifetime", lambda: stream_lifetime_population(
        stream, LIFE_AGES, temps, chunk_size=SCAN_CHUNK, collect=True),
        (), secs, launches)
    life = DENSE["lifetime"]
    for k in ("timings", "stale_fail"):
        if not np.array_equal(out[k], np.moveaxis(life[k], 0, 1)):
            raise AssertionError(f"streamed lifetime {k} differs from "
                                 f"phase 17's")
    np.testing.assert_allclose(out["ecc_lambda"],
                               np.moveaxis(life["ecc_lambda"], 0, 1),
                               rtol=ECC_RTOL)

    gain = DENSE["fig17_gain"]
    out = _scan("shuffling", lambda: stream_shuffling_gain(
        DENSE["fig17_probs"], chunk_size=SCAN_CHUNK, seed=0,
        n_accesses=N_ACCESSES, collect=True, device=dev),
        ("diva_shuffle", "secded_syndrome"), secs, launches)
    for k in ("total", "uncorrectable_no_shuffle", "uncorrectable_shuffle",
              "undetected_no_shuffle", "undetected_shuffle"):
        if not np.array_equal(out[k], gain[k]):
            raise AssertionError(f"streamed Fig 17 {k} differs from phase 6's")
    denom = np.maximum(out["total"], 1)
    for mode in ("no_shuffle", "shuffle"):
        if not np.array_equal(np.where(out["total"] == 0, 1.0,
                                       out[f"corrected_{mode}"] / denom),
                              gain[f"frac_{mode}"]):
            raise AssertionError(f"streamed Fig 17 corrected ({mode}) differs")

    counts = DENSE["campaign_counts"][1]              # tRP 7.5 ns
    dense_sig = bit_signature_population(counts.astype(np.int32), device=dev)
    out = _scan("bit_signature", lambda: stream_bit_signature(
        lambda lo, hi: counts[lo:hi], D, chunk_size=SCAN_CHUNK, device=dev),
        ("bit_signature",), secs, launches)
    if not np.array_equal(out, dense_sig):
        raise AssertionError("streamed signatures differ from the dense ones")

    # phase 8's flipped lanes, de-interleaved on the host into codewords
    inv = np.argsort(interleave_permutation())
    bad, lanes = DENSE["codec_bad"], DENSE["codec_lanes"]
    code = bad[:, inv].reshape(-1, 72)
    out = _scan("secded_scrub", lambda: stream_secded_scrub(
        lambda lo, hi: code[lo:hi], len(code), chunk_size=SCRUB_CHUNK,
        device=dev), ("secded_syndrome",), secs, launches)
    if out["corrected"] != DENSE["codec_corrected"] or out["uncorrectable"] \
            or out["clean"] != len(code) - out["corrected"]:
        raise AssertionError(f"streamed scrub {out} against the dense "
                             f"decode's {DENSE['codec_corrected']} corrected")
    bursts = np.sort(DENSE["codec_bursts"])
    flipped = stream_secded_scrub(bad[bursts][:, inv].reshape(-1, 72),
                                  chunk_size=SCRUB_CHUNK, collect=True,
                                  device=dev)
    if not np.array_equal(flipped["codewords"],
                          lanes[bursts][:, inv].reshape(-1, 72)):
        raise AssertionError("scrubbed codewords differ from the clean ones")
    checks.update(scrub_words=len(code), scrub_corrected=out["corrected"],
                  scrub_donated=out["donated"],
                  scrub_collected_words=len(flipped["codewords"]))
    del code

    fleet = synthetic_fleet(DISCOVER_DIMMS, FLEET_GEOM, seed=0, device=dev)
    runs = [_scan(f"discover_chunk{c}", lambda c=c: stream_discover_generations(
        fleet, chunk_size=c), ("fail_prob_rows", "bit_signature"), secs, launches)
        for c in DISCOVER_CHUNKS]
    for k in ("labels", "canonical", "members"):
        if not np.array_equal(runs[0][k], runs[1][k]):
            raise AssertionError(f"streamed generations' {k} differ between "
                                 f"chunk sizes {DISCOVER_CHUNKS}")
    total = {name: sum(l.get(name, 0) for l in launches.values())
             for name in ops.KERNELS}
    emit("stream_scans", dimms=D, chunk_size=SCAN_CHUNK,
         n_chunks=-(-D // SCAN_CHUNK), seconds=secs, launches=launches,
         equal_dense=["profile", "operating_grid", "lifetime", "shuffling",
                      "bit_signature", "secded_scrub"],
         discover_dimms=DISCOVER_DIMMS, discover_chunks=list(DISCOVER_CHUNKS),
         generations=runs[0]["n_generations"], **checks)
    return total


def max_gap(got, want) -> float:
    """Largest |got - want| / |want| over the nonzero entries of ``want``, a
    float array of ``got``'s shape (0.0: bit for bit)."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"shapes {got.shape} and {want.shape} differ")
    nz = want != 0
    return float(np.max(np.abs(got - want)[nz] / np.abs(want[nz]))) \
        if nz.any() else 0.0


def same(got, want, what: str) -> None:
    """Identical (``np.array_equal``), or raise."""
    if not np.array_equal(got, want):
        raise AssertionError(f"{what} differs from its unsharded result")


def close(got, want, what: str, rtol: float, atol: float = 0.0) -> float:
    """Within rtol / atol, or raise; returns the largest relative gap."""
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)
    return max_gap(got, want)


def sharded_phase(batch, diva) -> dict:
    """Phase 25: the DIVA path's entry points with the DIMM axis split over
    meshes that repeat the card, each beside its unsharded run; returns the
    launches of every run, summed."""
    dev = batch.device
    meshes = {f"N{n}": DimmMesh([dev] * n) for n in SHARD_SIZES}
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        meshes[f"dimm_mesh_{n_cards}_cards"] = dimm_mesh()
    secs, launches, gaps = {}, {}, {}
    total = dict.fromkeys(ops.KERNELS, 0)

    def run(name, fn, check, labels=None):
        """``fn(mesh)`` unsharded, then on each mesh of ``labels``: timed,
        counted (N times the unsharded launches of each kernel) and held by
        ``check(out, unsharded out)``, which returns the largest relative
        gap of each float output it holds to a bound (none: all exact)."""
        base = None
        for label in ["unsharded"] + list(labels or meshes):
            mesh = None if label == "unsharded" else meshes[label]
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(mesh)
            torch.cuda.synchronize()
            secs.setdefault(name, {})[label] = time.perf_counter() - t0
            got = {k: v for k, v in ops.launch_counts().items() if v}
            launches.setdefault(name, {})[label] = got
            for k, v in got.items():
                total[k] += v
            if mesh is None:
                base, base_launches = out, got
            elif got != {k: mesh.size * v for k, v in base_launches.items()}:
                raise AssertionError(f"{name} on {label} launched {got}, "
                                     f"expected {mesh.size} x {base_launches}")
            gaps.setdefault(name, {})[label] = check(out, base)

    lam = DENSE["lam"]
    run("row_error_lambda",
        lambda m: row_error_lambda(batch, "trp", 7.5, mesh=m),
        lambda out, _: {"lam": close(out, lam, "row lambdas", LAMBDA_RTOL,
                                     1e-6)})
    run("profile_population_arrays",
        lambda m: profile_population_arrays(batch, region="worst",
                                            multibit_only=True, mesh=m),
        lambda out, _: same(out, diva, "DIVA tables") or {})

    gain = DENSE["fig17_gain"]

    def fig17(m):
        probs = burst_bit_profile_population(batch, "trp", 7.5,
                                             refresh_ms=256.0, mesh=m)
        return probs, shuffling_gain_population(
            probs, seeds=batch.serial, n_accesses=N_ACCESSES, device=dev,
            mesh=m)

    def fig17_check(out, _):
        for k in ("total", "uncorrectable_no_shuffle", "uncorrectable_shuffle",
                  "undetected_no_shuffle", "undetected_shuffle",
                  "frac_no_shuffle", "frac_shuffle"):
            same(out[1][k], gain[k], f"Fig 17 {k}")
        return {"probs": close(out[0], DENSE["fig17_probs"],
                               "burst-bit profiles", PROB_RTOL, PROB_ATOL)}

    run("fig17_profile_and_shuffling", fig17, fig17_check)

    whole = DENSE["fig19_whole"]

    def fig19_check(out, _):
        same(out["total_latency_cycles"], whole["total_latency_cycles"],
             "Fig 19 totals")
        same(out["per_dimm_workload_speedup"],
             whole["per_dimm_workload_speedup"], "Fig 19 speedups")
        return {}

    run("system_speedup_population",
        lambda m: memsim.system_speedup_population(
            diva, n_requests=MEMSIM_N, device=dev, mesh=m), fig19_check)

    op = dict(temp_C=OP_TEMP, refresh_ms=OP_REFRESH, vdd=OP_VDD,
              retention=True, collect_fail_maps=True)
    stream = PopulationStream.from_batch(batch)

    def summaries(m):
        return (stream_error_summary(stream, OP_PARAM, OP_T,
                                     chunk_size=OP_CHUNK, mesh=m, **op),
                stream_error_summary(stream, OP_PARAM, OP_T,
                                     chunk_size=OP_CHUNK, temp_C=OP_TEMP,
                                     refresh_ms=OP_REFRESH, mesh=m))

    def summary_check(out, _):
        gap = {}
        for res, want, what in ((out[0], DENSE["summary_op"], "op_point"),
                                (out[1], DENSE["summary_nominal"], "nominal")):
            same(res["hot_cells"], want["hot_cells"], f"{what} hot cells")
            for key in ("lam_min", "lam_max", "worst_cell_max"):
                same(res[key]["serial"], want[key]["serial"],
                     f"{what} {key} serial")
                gap[f"{what}_{key}"] = close(
                    res[key]["value"], want[key]["value"], f"{what} {key}",
                    LAMBDA_RTOL)
            gap[f"{what}_grid_sum"] = close(res["grid_sum"], want["grid_sum"],
                                            f"{what} cell-sum", GRID_SUM_RTOL)
        maps = lambda res: np.concatenate([unpack_bool(p)
                                           for p in res["fail_maps"]])
        same(maps(out[0]), maps(DENSE["summary_op"]), "fail maps")
        gap["op_point_lam_total"] = close(
            out[0]["lam_total"], DENSE["summary_op"]["lam_total"],
            "fleet lambdas", LAMBDA_RTOL)
        return gap

    run("stream_error_summary", summaries, summary_check)

    counts = DENSE["campaign_counts"][1]                  # tRP 7.5 ns
    expected = DENSE["campaign_expected"][1]

    def discovery(m):
        return (bit_signature_population(counts.astype(np.int32), device=dev,
                                         mesh=m),
                recover_mapping_population(counts, expected, device=dev,
                                           mesh=m))

    def discovery_check(out, base):
        same(out[0], base[0], "signatures")
        for k in base[1]:
            same(out[1][k], base[1][k], f"recovered {k}")
        return {}

    run("signatures_and_recovery", discovery, discovery_check)

    life = DENSE["lifetime"]
    E = SHARD_LIFE_EPOCHS
    temps = np.full(E, LIFE_TEMP)

    def life_check(out, _):
        for k in ("timings", "stale_fail"):
            same(out[k], life[k][:E], f"lifetime {k}")
        return {"ecc_lambda": close(out["ecc_lambda"], life["ecc_lambda"][:E],
                                    "ECC exposure", LAMBDA_RTOL)}

    run("lifetime_population",
        lambda m: lifetime_population(batch, LIFE_AGES[:E], temps, mesh=m),
        life_check, labels=[f"N{SHARD_LIFE_SIZE}"])

    emit("sharded", dimms=batch.n_dimms, mesh_sizes=list(SHARD_SIZES),
         lifetime_epochs=E, lifetime_mesh_size=SHARD_LIFE_SIZE,
         cards=n_cards, all_cards_mesh=(
             f"dimm_mesh() over {n_cards} cards ran" if n_cards > 1 else
             "not run: one card visible"),
         meshes={k: [str(d) for d in m.devices] for k, m in meshes.items()},
         seconds=secs, launches=launches, max_rel_float_gap=gaps,
         largest_rel_float_gap=max([g for per in gaps.values()
                                    for run_gaps in per.values()
                                    for g in run_gaps.values()] + [0.0]),
         note="a mesh that repeats one card measures the split, the clone "
              "padding and the gather, not a speed-up across cards")
    return total


@contextlib.contextmanager
def recorded_routes():
    """Record each ``moe._route`` call while inside: (device, expert ids,
    positions, the call's capacity); the tensors stay where they are, so
    recording adds no host read."""
    seen, plain = [], moe_mod._route

    def spy(cfg, xt, wr):
        out = plain(cfg, xt, wr)
        seen.append((xt.device.type, out[0], out[1],
                     moe_mod.expert_capacity(cfg, xt.shape[0])))
        return out

    moe_mod._route = spy
    try:
        yield seen
    finally:
        moe_mod._route = plain


def dropped(routes) -> list:
    """Assignments past their expert's capacity, a ``_route`` call each."""
    return [int((pos >= cap).sum()) for _, _, pos, cap in routes]


def serve_at_full_width(cfg, params, dev, batch: int, prompt: int, new: int,
                        seed: int = 0) -> tuple[torch.Tensor, dict]:
    """``generate`` of ``batch`` prompts of ``prompt`` tokens and ``new``
    tokens on the card with the launch counts from 0: the dense and MoE
    paths launch no port kernel.  Returns (tokens, stats)."""
    prompts = make_batch(cfg, batch, prompt, seed=seed, step=0)
    prompts["tokens"] = prompts["tokens"][:, :-1]
    torch.cuda.synchronize()
    ops.reset_launches()
    toks, stats = generate(cfg, params, prompts, max_new=new, device=dev)
    launches = counted({})
    if toks.shape != (batch, new) or toks.dtype != torch.int32 \
            or not bool(((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"generate gave {tuple(toks.shape)} {toks.dtype}")
    return toks, dict(batch=batch, prompt_len=prompt, new_tokens=new, **stats,
                      launches=launches, max_memory_allocated=torch.cuda.max_memory_allocated(dev))


def init_on_card(cfg, dev) -> tuple[dict, dict]:
    """Random parameters from SERVE_SEED on the card, the peak memory reset
    before: (params, {params, init_s})."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init_params(SERVE_SEED, cfg, device=dev)
    torch.cuda.synchronize()
    return params, dict(arch=cfg.arch_id, n_layers=cfg.n_layers, d_model=cfg.d_model,
                        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.dh,
                        d_ff=cfg.d_ff, vocab=cfg.vocab_size, compute_dtype=cfg.compute_dtype,
                        params=sum(t.numel() for t in tree_leaves(params)),
                        init_s=time.perf_counter() - t0)


def blockwise_vs_full(cfg, params, dev) -> dict:
    """One layer's q, k, v of a LONG_PROMPT-token prompt on the card, in
    float32 and in bfloat16: ``blockwise_attention`` (chunks of 2048 keys)
    held to ``full_attention`` within the stated bounds."""
    seq = torch.as_tensor(make_batch(cfg, 1, LONG_PROMPT, seed=4, step=0)["tokens"][:, :-1],
                          device=dev)
    positions = torch.arange(LONG_PROMPT, dtype=torch.int32, device=dev)
    out = {}
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(compute_dtype=dtype)
        p = model.cast_params(params, c)
        lp = model._layer_slice(p["layers"], 0)["attn"]
        q, k, v = attn.qkv(c, lp, apply_norm(c, lp["ln"], model._embed(c, p, seq)), positions)
        full = attn.full_attention(q, k, v, q_pos=positions, kv_pos=positions).float()
        blk = attn.blockwise_attention(q, k, v, block_kv=2048).float()
        diff = (blk - full).abs()
        if dtype == "float32":
            bound = BLOCKWISE_F32_TOL * (1 + full.abs())
        else:
            bound = BLOCKWISE_BF16_RTOL * full.abs() \
                + BLOCKWISE_BF16_VTOL * float(v.float().abs().max())
        if not torch.isfinite(blk).all() or bool((diff > bound).any()):
            raise AssertionError(f"blockwise vs full attention ({dtype}): max "
                                 f"|difference| {float(diff.max())}")
        out[dtype] = dict(max_abs_err=float(diff.max()), mean_abs_err=float(diff.mean()),
                          max_share_of_bound=float((diff / bound).max()),
                          out_abs_max=float(full.abs().max()))
    return dict(seq=LONG_PROMPT, block_kv=2048, layer=0, shape=list(q.shape), **out,
                bounds=dict(float32=BLOCKWISE_F32_TOL,
                            bfloat16=[BLOCKWISE_BF16_RTOL, BLOCKWISE_BF16_VTOL]))


def cut(arch: str, layers: int):
    """``arch`` at full width, ``layers`` layers (an encoder-decoder's
    encoder too), float32 compute."""
    cfg = get_config(arch)
    enc = dict(n_enc_layers=layers) if cfg.is_encoder_decoder else {}
    return cfg.replace(n_layers=layers, compute_dtype="float32", **enc)


def prompts_of(cfg, batch: int, text: int, seed: int) -> dict:
    """``make_batch``'s prompts with ``text`` text tokens each (a vlm's
    patches and an audio model's frames whole), the last token dropped."""
    prompts = make_batch(cfg, batch, cfg.n_vision_tokens + text, seed=seed, step=0)
    prompts["tokens"] = prompts["tokens"][:, :-1]
    return prompts


def teacher_forced(cfg, params, prompts, dev) -> dict:
    """Float32 compute on the card: prefill DENSE_TF_PROMPT tokens of
    ``prompts`` (numpy, one sequence; its patches or frames whole) and
    decode the rest of its tokens, against teacher-forced ``forward``."""
    f32 = cfg.replace(compute_dtype="float32")
    batch = {k: torch.as_tensor(v, device=dev) for k, v in prompts.items()}
    seq = batch["tokens"]
    n, P = seq.shape[1], (batch["patches"].shape[1] if "patches" in batch else 0)
    full, _ = model.forward(f32, params, batch)
    logits, cache = model_cache.prefill(f32, params, {**batch, "tokens": seq[:, :DENSE_TF_PROMPT]},
                                        max_seq=P + n)
    pre = allclose_err(logits[0, -1], full[0, P + DENSE_TF_PROMPT - 1], DENSE_TF_PREFILL_TOL,
                       "prefill against forward")
    dec = 0.0
    for t in range(DENSE_TF_PROMPT, n):
        logits, cache = model_cache.decode_step(f32, params, cache, seq[:, t:t + 1])
        dec = max(dec, allclose_err(logits[0, -1], full[0, P + t], DENSE_TF_DECODE_TOL,
                                    "decode against forward"))
    return dict(compute_dtype="float32", prompt=DENSE_TF_PROMPT, decode=n - DENSE_TF_PROMPT,
                prefix=P, prefill_max_abs_err=pre, decode_max_abs_err=dec,
                bounds=[DENSE_TF_PREFILL_TOL, DENSE_TF_DECODE_TOL])


def moe_calls(cfg) -> int:
    """The routing calls one pass over ``cfg``'s model makes."""
    if not cfg.n_experts:
        return 0
    if cfg.family == "hybrid":
        P = cfg.attn_period
        return cfg.n_layers // P * sum(cfg.is_moe_layer(i) for i in range(P))
    return cfg.n_layers if cfg.is_moe_layer(0) else 0


def card_vs_cpu(cfg, prompts, dev) -> dict:
    """``cfg`` (float32 compute) with one set of host parameters, on the CPU
    and then on the card, each prefilling ``prompts`` (numpy: tokens and
    any patches or frames) and decoding CPU_DECODE greedy tokens: the greedy
    tokens identical, every step's logits and the caches within
    CARD_CPU_TOL, ``generate`` identical, and every MoE routing call's
    expert ids, positions and kept assignments identical."""
    host = model.init_params(SERVE_SEED, cfg, device="cpu")
    card = model.params_to(host, dev)
    prefix = prompts["patches"].shape[1] if "patches" in prompts else 0
    S = prompts["tokens"].shape[1]
    max_seq = prefix + S + CPU_DECODE
    runs = {}
    for name, params, d in (("cpu", host, "cpu"), ("card", card, dev)):
        batch = {k: torch.as_tensor(v, device=d) for k, v in prompts.items()}
        with recorded_routes() as routes:
            logits, cache = model_cache.prefill(cfg, params, batch, max_seq=max_seq)
            out, toks = [logits], []
            for _ in range(CPU_DECODE):
                toks.append(greedy(logits))
                logits, cache = model_cache.decode_step(cfg, params, cache, toks[-1][:, None])
                out.append(logits)
        runs[name] = (out, [t.cpu() for t in toks], cache, routes)
    (lh, th, ch, rh), (lg, tg, cg, rg) = runs["cpu"], runs["card"]
    for a, b in zip(tg, th):
        if not torch.equal(a, b):
            raise AssertionError(f"greedy tokens differ: card {a.tolist()}, CPU {b.tolist()}")
    errs = [allclose_err(g, h, CARD_CPU_TOL, f"logits after step {i}, card vs CPU")
            for i, (g, h) in enumerate(zip(lg, lh))]
    cache_err = max(allclose_err(cg[k], ch[k], CARD_CPU_TOL, f"cache {k}")
                    for k in ch if k != "pos")
    n = moe_calls(cfg)
    if len(rh) != len(rg) or len(rh) != n * (1 + CPU_DECODE) \
            or {r[0] for r in rh} - {"cpu"} or {r[0] for r in rg} - {torch.device(dev).type}:
        raise AssertionError(f"{len(rh)} / {len(rg)} routing calls, expected "
                             f"{n * (1 + CPU_DECODE)} each")
    for (_, eh, ph, cap), (_, eg, pg, _) in zip(rh, rg):
        if not (torch.equal(eg.cpu(), eh) and torch.equal(pg.cpu(), ph)
                and torch.equal(pg.cpu() < cap, ph < cap)):
            raise AssertionError("MoE routing differs on the card and the CPU")
    gen_h, _ = generate(cfg, host, prompts, max_new=CPU_DECODE + 1, device="cpu")
    gen_g, _ = generate(cfg, card, prompts, max_new=CPU_DECODE + 1, device=dev)
    if not torch.equal(gen_g.cpu(), gen_h):
        raise AssertionError(f"generate differs: card {gen_g.tolist()}, CPU {gen_h.tolist()}")
    return dict(arch=cfg.arch_id, n_layers=cfg.n_layers, n_enc_layers=cfg.n_enc_layers,
                d_model=cfg.d_model, vocab=cfg.vocab_size, compute_dtype=cfg.compute_dtype,
                batch=prompts["tokens"].shape[0], prompt_len=S, prefix=prefix,
                decode_steps=CPU_DECODE, prefill_max_abs_err=errs[0],
                decode_max_abs_err=max(errs[1:]), cache_max_abs_err=cache_err,
                bound=CARD_CPU_TOL, greedy_tokens_identical=True,
                routing_calls_identical=len(rh), prefill_dropped=dropped(rh[:n]),
                tokens=gen_h.tolist())


def dense_serving_phase(dev) -> dict:
    """Phase 26: dense and MoE serving at full width (bfloat16 compute), the
    int8 cache, a long prompt through blockwise attention, decode against
    teacher-forced forward and the card against the CPU port; returns the
    launches of its serving runs (none)."""
    cfg = get_config(DENSE_ARCH)
    params, info = init_on_card(cfg, dev)
    toks, stats = serve_at_full_width(cfg, params, dev, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW)
    launches = stats["launches"]
    emit("dense_serving", **info, **stats, first_tokens=toks[:2, :8].tolist())

    # the int8 KV cache, same parameters and prompts
    q8 = cfg.replace(kv_quant=True)
    torch.cuda.reset_peak_memory_stats(dev)
    toks_q, stats_q = serve_at_full_width(q8, params, dev, SERVE_BATCH, SERVE_PROMPT,
                                          SERVE_NEW)
    max_seq = SERVE_PROMPT + SERVE_NEW
    cache_b = {name: sum(t.numel() * t.element_size() for t in tree_leaves(
        model_cache.init_cache(c, SERVE_BATCH, max_seq, device="meta")))
        for name, c in (("bfloat16", cfg), ("int8", q8))}
    emit("dense_serving_int8_cache", arch=cfg.arch_id, **stats_q,
         cache_bytes=cache_b, bytes_ratio=cache_b["bfloat16"] / cache_b["int8"],
         greedy_agreement=float((toks_q == toks).float().mean()),
         first_agreeing_run=float((toks_q == toks).int().cumprod(1).sum(1).float().mean()))

    # a LONG_PROMPT-token prompt: prefill through blockwise attention
    torch.cuda.reset_peak_memory_stats(dev)
    _, stats_l = serve_at_full_width(cfg, params, dev, 1, LONG_PROMPT, LONG_NEW, seed=3)
    emit("dense_serving_long_prompt", arch=cfg.arch_id, **stats_l,
         attention="blockwise" if LONG_PROMPT > model_cache.FULL_THRESH else "full",
         blockwise_vs_full=blockwise_vs_full(cfg, params, dev))
    emit("dense_teacher_forced", arch=cfg.arch_id, **teacher_forced(
        cfg, params, prompts_of(cfg, 1, DENSE_TF_PROMPT + DENSE_TF_DECODE, seed=2), dev))
    del params

    # qwen2.5-3b at full width and depth
    cfg3 = get_config(DENSE_3B)
    params, info = init_on_card(cfg3, dev)
    toks, stats = serve_at_full_width(cfg3, params, dev, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW)
    emit("dense_serving", **info, **stats, first_tokens=toks[:2, :8].tolist())
    del params

    # moonshot-v1-16b-a3b at full width, its depth cut
    mcfg = get_config(MOE_ARCH).replace(n_layers=MOE_SERVE_LAYERS)
    params, info = init_on_card(mcfg, dev)
    with recorded_routes() as routes:
        toks, stats = serve_at_full_width(mcfg, params, dev, SERVE_BATCH, SERVE_PROMPT,
                                          SERVE_NEW)
    drops = dropped(routes)
    T = SERVE_BATCH * SERVE_PROMPT
    emit("moe_serving", **info, full_depth=get_config(MOE_ARCH).n_layers,
         n_experts=mcfg.n_experts, top_k=mcfg.experts_per_token, **stats,
         capacity_prefill=moe_mod.expert_capacity(mcfg, T),
         dropped_prefill_by_layer=drops[:MOE_SERVE_LAYERS],
         dropped_share_prefill=sum(drops[:MOE_SERVE_LAYERS])
         / (MOE_SERVE_LAYERS * T * mcfg.experts_per_token),
         dropped_decode=sum(drops[MOE_SERVE_LAYERS:]), first_tokens=toks[:2, :8].tolist())
    del params
    torch.cuda.empty_cache()

    for arch in (DENSE_ARCH, MOE_ARCH):
        cfg = cut(arch, CPU_LAYERS)
        emit("dense_card_vs_cpu", **card_vs_cpu(
            cfg, prompts_of(cfg, DENSE_CPU_BATCH, DENSE_CPU_PROMPT, seed=1), dev))
    torch.cuda.empty_cache()
    return launches


def dense_training_phase(dev) -> dict:
    """Phase 27: qwen2-0.5b training at full width and depth through
    ``launch.train.main``, a profiled step, the card against the CPU port at
    2 layers, and moonshot at full width cut to 2 layers; returns the
    training run's launches (none)."""
    cfg = get_config(DENSE_ARCH)
    run = train_main_run(cfg, dev)
    launches = run["launches"]
    emit("dense_training", **run)
    torch.cuda.empty_cache()
    emit("dense_training_profile", arch=DENSE_ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         **profile_train_step(cfg, dev, required=("matmul",)))
    torch.cuda.empty_cache()
    emit("dense_training_card_vs_cpu", **train_card_vs_cpu(cfg, dev))

    # moonshot-v1-16b-a3b at full width, 2 of its 48 layers
    mcfg = get_config(MOE_ARCH).replace(n_layers=MOE_TRAIN_LAYERS)
    run = train_steps(mcfg, dev, MOE_TRAIN_STEPS)
    if not all(r["aux"] > 0 for r in run["metrics"]):
        raise AssertionError(f"moe training metrics {run['metrics']}")
    emit("moe_training", arch=MOE_ARCH, n_layers=MOE_TRAIN_LAYERS,
         full_depth=get_config(MOE_ARCH).n_layers, d_model=mcfg.d_model,
         n_experts=mcfg.n_experts, top_k=mcfg.experts_per_token, **run)
    return launches


def families_serving_phase(dev) -> dict:
    """Phase 28: the hybrid, vlm and audio families serving (bfloat16
    compute), decode against teacher-forced forward and the card against
    the CPU port in float32; returns the launches of its serving runs
    (none)."""
    # jamba-1.5-large-398b: one block, 4 of its 16 experts
    full = get_config(JAMBA)
    jcfg = full.replace(n_layers=JAMBA_LAYERS, n_experts=JAMBA_EXPERTS)
    params, info = init_on_card(jcfg, dev)
    with recorded_routes() as routes:
        toks, stats = serve_at_full_width(jcfg, params, dev, SERVE_BATCH, SERVE_PROMPT,
                                          SERVE_NEW)
    launches = stats["launches"]
    n, T = moe_calls(jcfg), SERVE_BATCH * SERVE_PROMPT
    drops = dropped(routes)
    emit("hybrid_serving", **info, full_depth=full.n_layers, full_experts=full.n_experts,
         n_experts=jcfg.n_experts, top_k=jcfg.experts_per_token, d_inner=jcfg.d_inner,
         **stats, capacity_prefill=moe_mod.expert_capacity(jcfg, T),
         dropped_prefill_by_layer=drops[:n],
         dropped_share_prefill=sum(drops[:n]) / (n * T * jcfg.experts_per_token),
         dropped_decode=sum(drops[n:]), first_tokens=toks[:2, :8].tolist())
    del params
    # paligemma-3b and whisper-medium at full width and depth
    for arch, prompt, phase in ((PALIGEMMA, SERVE_PROMPT, "vlm_serving"),
                                (WHISPER, WHISPER_PROMPT, "audio_serving")):
        cfg = get_config(arch)
        params, info = init_on_card(cfg, dev)
        toks, stats = serve_at_full_width(cfg, params, dev, SERVE_BATCH, prompt, SERVE_NEW)
        emit(phase, **info, n_vision_tokens=cfg.n_vision_tokens, n_enc_layers=cfg.n_enc_layers,
             enc_seq=cfg.enc_seq if cfg.is_encoder_decoder else 0, **stats,
             first_tokens=toks[:2, :8].tolist())
        del params
        torch.cuda.empty_cache()

    # float32 on the card: decode against teacher-forced forward, 2 layers
    for arch in (PALIGEMMA, WHISPER):
        cfg = cut(arch, FAMILY_CPU_LAYERS)
        params = model.init_params(SERVE_SEED, cfg, device=dev)
        prompts = prompts_of(cfg, 1, DENSE_TF_PROMPT + DENSE_TF_DECODE, seed=2)
        emit("family_teacher_forced", arch=arch, n_layers=cfg.n_layers,
             n_enc_layers=cfg.n_enc_layers, **teacher_forced(cfg, params, prompts, dev))
        del params
    torch.cuda.empty_cache()
    # the card against the CPU port, float32
    for cfg, text in ((cut(PALIGEMMA, FAMILY_CPU_LAYERS), FAMILY_CPU_PROMPT),
                      (cut(WHISPER, FAMILY_CPU_LAYERS), FAMILY_CPU_PROMPT),
                      (get_smoke_config(JAMBA), JAMBA_CPU_PROMPT)):
        emit("family_card_vs_cpu", **card_vs_cpu(cfg, prompts_of(cfg, CPU_BATCH, text, seed=1),
                                                 dev))
    torch.cuda.empty_cache()
    return launches


def families_training_phase(dev) -> dict:
    """Phase 29: whisper-medium training at full width and depth through
    ``launch.train.main`` with a profiled step, paligemma-3b at full width
    cut to 8 layers, Jamba at smoke widths in bfloat16 under Adafactor, and
    the card against the CPU port in float32; returns the whisper run's
    launches (none)."""
    cfg = get_config(WHISPER)
    run = train_main_run(cfg, dev, WHISPER_TRAIN_SEQ)
    launches = run["launches"]
    emit("audio_training", **run, enc_seq=cfg.enc_seq, n_enc_layers=cfg.n_enc_layers)
    torch.cuda.empty_cache()
    emit("audio_training_profile", arch=WHISPER, batch=TRAIN_BATCH, seq=WHISPER_TRAIN_SEQ,
         **profile_train_step(cfg, dev, required=("matmul",), seq=WHISPER_TRAIN_SEQ))
    torch.cuda.empty_cache()
    emit("audio_training_card_vs_cpu", **train_card_vs_cpu(
        cfg, dev, small=cut(WHISPER, TRAIN_CPU_LAYERS)))

    pcfg = get_config(PALIGEMMA).replace(n_layers=PALIGEMMA_TRAIN_LAYERS)
    emit("vlm_training", arch=PALIGEMMA, n_layers=pcfg.n_layers,
         full_depth=get_config(PALIGEMMA).n_layers, d_model=pcfg.d_model,
         vocab=pcfg.vocab_size, n_vision_tokens=pcfg.n_vision_tokens,
         **train_steps(pcfg, dev, FAMILY_TRAIN_STEPS))

    smoke = get_smoke_config(JAMBA)
    jcfg = smoke.replace(param_dtype="bfloat16", compute_dtype="bfloat16")
    run = train_steps(jcfg, dev, FAMILY_TRAIN_STEPS)
    if not all(r["aux"] > 0 for r in run["metrics"]):
        raise AssertionError(f"hybrid training metrics {run['metrics']}")
    emit("hybrid_training", arch=JAMBA, n_layers=jcfg.n_layers, d_model=jcfg.d_model,
         param_dtype=jcfg.param_dtype, compute_dtype=jcfg.compute_dtype,
         optimizer=jcfg.optimizer, chunked_scan=run["seq"] > 128 and run["seq"] % 128 == 0,
         **run)
    emit("hybrid_training_card_vs_cpu", **train_card_vs_cpu(
        jcfg, dev, small=smoke, seq=JAMBA_CPU_PROMPT))
    return launches


def _step_run(step, state, cfg, batch: int, seq: int, steps: int, dev):
    """``steps`` steps of ``step`` on make_batch(seed 0) batches: (state,
    metrics a step, seconds a step)."""
    rows, secs = [], []
    for i in range(steps):
        b = make_batch(cfg, batch, seq, seed=0, step=i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        rows.append({k: float(v) for k, v in metrics.items()})
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["gnorm"]) for r in rows):
        raise AssertionError(f"training metrics {rows}")
    return state, rows, secs


def sharded_vs_unsharded(cfg, dev, mesh, batch: int, steps: int, seq: int = TRAIN_SEQ,
                         keep_grads: bool = False) -> tuple[dict, dict | None]:
    """``steps`` unsharded steps (``make_train_step``) and as many sharded
    ones on ``mesh`` from the same seed: metrics within MESH_RTOL, the
    parameters after the last step within MESH_RTOL of the largest |value|
    of each leaf; the sharded run's launches are counted from 0.  Returns
    the record and, with ``keep_grads``, the gradients of the first batch
    (unsharded)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    state = build_state(cfg, device=dev)
    grads = None
    if keep_grads:
        params = tree_map(lambda t: t.detach().requires_grad_(), state["params"])
        with torch.enable_grad():
            loss, _ = model.loss_fn(cfg, params, make_batch(cfg, batch, seq, seed=0, step=0))
            grads = tree_unflatten(params, torch.autograd.grad(loss, tree_leaves(params)))
        del params, loss
    state, plain_rows, plain_s = _step_run(make_train_step(cfg), state, cfg, batch, seq,
                                           steps, dev)
    want = tree_map(lambda t: t.detach().clone(), state["params"])
    plain_peak = torch.cuda.max_memory_allocated(dev)
    del state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    full = build_state(cfg, device=dev)
    sh = state_shardings(full, mesh)
    state = shard_tree(full, sh)
    del full
    gathered = sum(t.numel() * t.element_size() for t in tree_leaves(state["params"]))
    step = make_sharded_train_step(cfg, mesh, sh)
    ops.reset_launches()
    state, rows, secs = _step_run(step, state, cfg, batch, seq, steps, dev)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    got = gather_tree(state["params"], sh["params"])
    worst = {}
    for r, w in zip(rows, plain_rows):
        for k in w:
            worst[k] = max(worst.get(k, 0.0), abs(r[k] - w[k]) / max(abs(w[k]), 1e-30))
    param_rel = max(float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))
                    for a, b in zip(tree_leaves(got), tree_leaves(want)))
    identical = rows == plain_rows and all(torch.equal(a, b) for a, b in
                                           zip(tree_leaves(got), tree_leaves(want)))
    kept = sum(t.numel() * t.element_size() for t in tree_leaves(want))
    del state, got, want
    torch.cuda.empty_cache()
    if max(worst.values()) > MESH_RTOL or param_rel > MESH_RTOL:
        raise AssertionError(f"{cfg.arch_id}: sharded against unsharded steps: metrics "
                             f"{worst}, parameters {param_rel}")
    return dict(arch=cfg.arch_id, n_layers=cfg.n_layers, d_model=cfg.d_model,
                vocab=cfg.vocab_size, compute_dtype=cfg.compute_dtype, batch=batch, seq=seq,
                steps=steps, metrics=rows, unsharded_metrics=plain_rows,
                max_rel_metric=worst, max_rel_param=param_rel, bit_identical=identical,
                step_s=secs, unsharded_step_s=plain_s, max_memory_allocated=peak,
                unsharded_max_memory_allocated=plain_peak, gathered_copy_bytes=gathered,
                kept_unsharded_params_bytes=kept,
                launches=launches), grads


def moe_paths_phase(dev, mesh) -> dict:
    """moonshot at full width, MESH_MOE_LAYERS layer(s): the ep and a2a
    paths' float32 logits against the local path's, routing identical; then
    MESH_MOE_STEPS sharded steps of each in bfloat16 compute."""
    import os
    full = get_config(MOE_ARCH)
    cfg = full.replace(n_layers=MESH_MOE_LAYERS)
    f32 = cfg.replace(compute_dtype="float32")
    torch.cuda.empty_cache()
    params = model.init_params(SERVE_SEED, f32, device=dev)
    tokens = make_batch(cfg, MESH_MOE_BATCH, TRAIN_SEQ, seed=3, step=0)
    tokens = {"tokens": tokens["tokens"][:, :-1]}
    out = {}
    with torch.no_grad():
        ops.reset_launches()
        with recorded_routes() as routes:
            want, _ = model.forward(f32, params, tokens)
        counted({})                                      # the MoE path runs no kernel
        want_routes = [(e.cpu(), p.cpu()) for _, e, p, _ in routes]
        for path in ("ep", "a2a"):
            os.environ["REPRO_MOE_A2A"] = "1" if path == "a2a" else "0"
            ops.reset_launches()
            with use_mesh(mesh), recorded_routes() as routes:
                got, _ = model.forward(f32, params, tokens)
            counted({})
            same_routes = [(e.cpu(), p.cpu()) for _, e, p, _ in routes]
            ok = len(same_routes) == len(want_routes) and all(
                torch.equal(a, c) and torch.equal(b, d)
                for (a, b), (c, d) in zip(same_routes, want_routes))
            err = float((got - want).abs().max())
            if not ok or not torch.allclose(got, want, rtol=MOE_PATH_TOL, atol=MOE_PATH_TOL):
                raise AssertionError(f"moe {path} at 1x1: routing same {ok}, logits "
                                     f"max |diff| {err}")
            out[path] = dict(max_abs_logit_err=err, logits_equal=torch.equal(got, want),
                             routing_calls=len(same_routes))
            del got
    del params, want
    torch.cuda.empty_cache()
    for path in ("ep", "a2a"):
        os.environ["REPRO_MOE_A2A"] = "1" if path == "a2a" else "0"
        torch.cuda.reset_peak_memory_stats(dev)
        full_state = build_state(cfg, device=dev)
        sh = state_shardings(full_state, mesh)
        state = shard_tree(full_state, sh)
        del full_state
        calls = {"ep": 0, "a2a": 0}
        plain = {k: getattr(moe_mod, f"_moe_ffn_{k}") for k in calls}

        def spy(name):
            def fn(*a):
                calls[name] += 1
                return plain[name](*a)
            return fn

        for k in calls:
            setattr(moe_mod, f"_moe_ffn_{k}", spy(k))
        ops.reset_launches()
        try:
            state, rows, secs = _step_run(make_sharded_train_step(cfg, mesh, sh), state, cfg,
                                          MESH_MOE_BATCH, TRAIN_SEQ, MESH_MOE_STEPS, dev)
        finally:
            for k in calls:
                setattr(moe_mod, f"_moe_ffn_{k}", plain[k])
        counted(optimizer_launches(cfg, MESH_MOE_STEPS, own_norm=False))
        if not all(r["aux"] > 0 for r in rows) or calls[path] == 0 or \
                calls["a2a" if path == "ep" else "ep"]:
            raise AssertionError(f"moe {path} steps: {rows}, path calls {calls}")
        out[path].update(metrics=rows, step_s=secs, path_calls=calls[path],
                         max_memory_allocated=torch.cuda.max_memory_allocated(dev))
        del state
        torch.cuda.empty_cache()
    os.environ.pop("REPRO_MOE_A2A", None)
    return dict(arch=MOE_ARCH, n_layers=cfg.n_layers, full_depth=full.n_layers,
                d_model=cfg.d_model, n_experts=cfg.n_experts, top_k=cfg.experts_per_token,
                batch=MESH_MOE_BATCH, seq=TRAIN_SEQ, tol=MOE_PATH_TOL, **out)


def mesh_training_phase(dev) -> dict:
    """Phase 30: the training mesh over a one-rank NCCL group; returns the
    launches of the rwkv6 sharded run and of the sharded checkpoint's
    codec."""
    import torch.distributed as dist
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=dev)
    try:
        mesh = make_host_mesh(device=dev)
        if len(mesh.groups) != 2 or dist.get_backend(mesh.groups[0]) != "nccl":
            raise AssertionError(f"the host mesh has no NCCL groups: {mesh}")
        t0 = time.perf_counter()
        qwen, grads = sharded_vs_unsharded(get_config(DENSE_ARCH), dev, mesh, TRAIN_BATCH,
                                           MESH_STEPS, keep_grads=True)
        qwen_launches = optimizer_launches(get_config(DENSE_ARCH), MESH_STEPS,
                                           own_norm=False)
        counted(qwen_launches)
        # int8 compression of qwen's gradients: the card against the CPU
        t1 = time.perf_counter()
        q, scales, err = compress_grads(grads, init_compression_state(grads))
        cpu = tree_map(lambda g: g.cpu(), grads)
        cq, cs, ce = compress_grads(cpu, init_compression_state(cpu))
        same_q = all(torch.equal(a.cpu(), b) for a, b in zip(tree_leaves(q), tree_leaves(cq)))
        same_s = all(torch.equal(a.cpu(), b) for a, b in
                     zip(tree_leaves(scales), tree_leaves(cs)))
        same_e = all(torch.equal(a.cpu(), b) for a, b in zip(tree_leaves(err), tree_leaves(ce)))
        n_grad = sum(g.numel() for g in tree_leaves(grads))
        counted(qwen_launches)                           # plain torch: no kernel
        del grads, q, scales, err, cpu, cq, cs, ce
        if not (same_q and same_s):
            raise AssertionError(f"compress_grads: q identical {same_q}, scales {same_s}")
        compression = dict(elements=n_grad, q_identical=same_q, scales_identical=same_s,
                           residuals_identical=same_e, seconds=time.perf_counter() - t1)
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        moe = moe_paths_phase(dev, mesh)
        t3 = time.perf_counter()
        rcfg = get_config(ARCH).replace(n_layers=MESH_RWKV_LAYERS)
        rwkv, _ = sharded_vs_unsharded(rcfg, dev, mesh, TRAIN_BATCH, MESH_RWKV_STEPS)
        want = {"wkv6": 2 * MESH_RWKV_LAYERS * MESH_RWKV_STEPS,
                "wkv6_bwd": MESH_RWKV_LAYERS * MESH_RWKV_STEPS,
                **optimizer_launches(rcfg, MESH_RWKV_STEPS, own_norm=False)}
        launches = rwkv["launches"]
        if launches != {name: want.get(name, 0) for name in launches}:
            raise AssertionError(f"rwkv6 sharded steps launched {launches}, expected {want}")
        if [r["loss"] for r in rwkv["metrics"]] != [r["loss"] for r in rwkv["unsharded_metrics"]]:
            raise AssertionError(f"rwkv6 sharded losses {rwkv['metrics']} differ from "
                                 f"{rwkv['unsharded_metrics']}")
        t4 = time.perf_counter()
        ckpt = mesh_checkpoint(dev, mesh)
        launches = {name: launches.get(name, 0) + ckpt["launches"].get(name, 0)
                    for name in launches}
        emit("mesh_training", nvidia_smi=nvidia_smi(), backend="nccl", world_size=dist.get_world_size(), mesh=mesh.shape,
            qwen=qwen, compression=compression, moe=moe, rwkv6=rwkv, checkpoint=ckpt,
            seconds=dict(qwen=t1 - t0, compression=t2 - t1, moe=t3 - t2, rwkv6=t4 - t3,
                         checkpoint=time.perf_counter() - t4))
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    return launches


def mesh_checkpoint(dev, mesh) -> dict:
    """A moonshot smoke state trained one sharded step, saved from the mesh
    (the codec on the card) and restored with ``shardings=`` from the
    shards as the example: bit for bit, the codec's launches counted (one
    encode and one shuffle a leaf to save, one shuffle and one syndrome a
    leaf to restore)."""
    cfg = get_smoke_config(MOE_ARCH)
    full = build_state(cfg, device=dev)
    sh = state_shardings(full, mesh)
    ops.reset_launches()
    state, _, _ = _step_run(make_sharded_train_step(cfg, mesh, sh), shard_tree(full, sh),
                            cfg, 2, 64, 1, dev)
    step_launches = optimizer_launches(cfg, 1, own_norm=False)
    counted(step_launches)
    del full
    leaves = sum(1 for t in tree_leaves(state) if t.numel())
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(1, state, shardings=sh)
        back, info = mgr.restore(state, shardings=sh)
    launches = counted({"secded_encode": leaves, "diva_shuffle": 2 * leaves,
                        "secded_syndrome": leaves, **step_launches})
    same = all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(tree_leaves(back), tree_leaves(state)))
    if not same or info != {"step": 1, "corrected_codewords": 0}:
        raise AssertionError(f"sharded checkpoint: identical {same}, {info}")
    return dict(arch=cfg.arch_id, leaves=leaves, identical=same, launches=launches, **info)


def train_main_run(cfg, dev, seq: int = TRAIN_SEQ) -> dict:
    """``launch.train.main`` on ``cfg.arch_id`` at full width and depth,
    TRAIN_STEPS steps of TRAIN_BATCH x ``seq`` tokens, launch counts from 0
    (none but the optimizer's may launch): finite losses, step times,
    tokens/s, memory peak."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = train_main(["--arch", cfg.arch_id, "--steps", str(TRAIN_STEPS), "--batch",
                      str(TRAIN_BATCH), "--seq", str(seq), "--log-every", "1"])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = counted(optimizer_launches(cfg, TRAIN_STEPS, own_norm=False))
    peak = torch.cuda.max_memory_allocated(dev)
    losses = out["losses"]
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"training losses {losses}")
    steady = statistics.median(out["step_s"][1:])
    return dict(arch=cfg.arch_id, n_layers=cfg.n_layers, d_model=cfg.d_model,
                d_ff=cfg.d_ff, vocab=cfg.vocab_size, param_dtype=cfg.param_dtype,
                compute_dtype=cfg.compute_dtype, remat=cfg.remat, optimizer=cfg.optimizer,
                batch=TRAIN_BATCH, seq=seq, steps=TRAIN_STEPS, losses=losses,
                step_s=out["step_s"], first_step_s=out["step_s"][0], median_step_s=steady,
                tokens_per_s=TRAIN_BATCH * seq / steady, run_s=run_s,
                max_memory_allocated=peak, launches=launches)


def train_steps(cfg, dev, steps: int, seq: int = TRAIN_SEQ) -> dict:
    """``steps`` train steps of ``cfg`` (``build_state``,
    ``make_train_step``) on TRAIN_BATCH x ``seq`` tokens on the card, launch
    counts from 0 (none but the optimizer's may launch): finite losses,
    metrics a step, step seconds, parameters, memory peak."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    state = build_state(cfg, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(state["params"]))
    step = make_train_step(cfg)
    ops.reset_launches()
    step_s, rows = [], []
    for i in range(steps):
        batch = make_batch(cfg, TRAIN_BATCH, seq, seed=0, step=i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        rows.append({k: float(v) for k, v in metrics.items()})
    launches = counted(optimizer_launches(cfg, steps, own_norm=True))
    peak = torch.cuda.max_memory_allocated(dev)
    del state
    torch.cuda.empty_cache()
    if not all(math.isfinite(r["loss"]) for r in rows):
        raise AssertionError(f"training metrics {rows}")
    return dict(params=n_params, batch=TRAIN_BATCH, seq=seq, steps=steps, metrics=rows,
                step_s=step_s, max_memory_allocated=peak, launches=launches)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def dryrun_cells() -> list:
    """Phase 31(a): the cells of DRYRUN_CELLS traced in the fake world."""
    out = []
    for arch, shape, multi in DRYRUN_CELLS:
        rec = dryrun.run_cell(arch, shape, multi)
        mem = rec.get("memory", {})
        if rec["status"] != "ok" or rec["flops_per_device"] <= 0 or not mem.get("peak_bytes"):
            raise AssertionError(f"dry run {arch} {shape}: {rec}")
        calls = {k: v["calls"] for k, v in rec["kernels"].items()}
        want = {"wkv6": 48, "wkv6_bwd": 24} if arch == ARCH else {}
        if shape.startswith("train") and get_config(arch).optimizer == "adamw":
            want["adamw"] = 1
        if calls != want:
            raise AssertionError(f"dry run {arch} {shape} kernels {rec['kernels']}")
        out.append({k: rec[k] for k in (
            "arch", "shape", "mesh", "n_chips", "trace_s", "flops_by_dtype",
            "bytes_per_device", "device_ops", "kernels", "roofline")}
            | {"collective_bytes": rec["collectives"]["by_axis"],
               "peak_bytes": mem["peak_bytes"], "peak_parts": mem["peak_parts"]})
    return out


def predicted_vs_card(cfg, shape: ShapeConfig, dev) -> dict:
    """Phase 31(b), one step: the dry run of ``cfg`` at ``shape`` on the 1 x 1
    mesh on fake tensors, then the same step on the card, built fresh, run
    under the same counter and then timed without it.  The FLOPs must be
    identical, the predicted peak within PEAK_RTOL of the card's, the
    kernels' launches those the dry run counted."""
    reset_collectives()
    fake = dryrun.trace(cfg, shape, counting_mesh((1, 1), ("data", "model")))
    mesh = make_host_mesh(device=dev)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    baseline = torch.cuda.memory_allocated(dev)
    state = build_state(cfg, device=dev) if shape.kind == "train" else \
        {"params": model.init_params(SERVE_SEED, cfg, device=dev)}
    step, args = dryrun.rank_program(cfg, shape, mesh, state)
    del state
    b = make_batch(cfg, shape.global_batch, shape.seq_len, seed=0, step=0)
    batch = b if shape.kind == "train" else {"tokens": b["tokens"][:, :-1]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = ops.launch_counts()
    with WorkCounter(track_memory=False) as counter:
        out = step(*args, batch)
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - baseline
    launches = {k: v - before[k] for k, v in ops.launch_counts().items()}
    card = counter.summary()
    if shape.kind == "train":
        args = (out[0],)
    del out
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step(*args, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    del out, args
    torch.cuda.empty_cache()
    kernel_calls = {k: v["calls"] for k, v in fake["kernels"].items()}
    rel = abs(fake["memory"]["peak_bytes"] - peak) / peak
    if card["flops"] != fake["flops"] or rel > PEAK_RTOL or \
            {k: v for k, v in launches.items() if v} != kernel_calls:
        raise AssertionError(f"{cfg.arch_id} {shape.name}: FLOPs card {card['flops']} dry "
                             f"run {fake['flops']}; peak card {peak} predicted "
                             f"{fake['memory']['peak_bytes']}; launches {launches} against "
                             f"{kernel_calls}")
    terms = roofline_terms(fake["flops"], fake["bytes"], fake["collectives"], {})
    return dict(arch=cfg.arch_id, n_layers=cfg.n_layers, kind=shape.kind,
                batch=shape.global_batch, seq=shape.seq_len, flops_by_dtype=card["flops"],
                flops_identical=True, bytes_dry_run=fake["bytes"], bytes_card=card["bytes"],
                device_ops_dry_run=fake["ops"], device_ops_card=card["ops"],
                predicted_peak_bytes=fake["memory"]["peak_bytes"],
                predicted_peak_parts=fake["memory"]["peak_parts"],
                measured_peak_bytes=peak, baseline_bytes=baseline, peak_rel_err=rel,
                peak_rtol=PEAK_RTOL, kernel_calls_dry_run=kernel_calls,
                card_launches=launches, trace_s=fake["trace_s"], step_s=step_s,
                roofline=terms, step_over_bound=step_s / max(
                    terms["t_compute_s"], terms["t_memory_s"], 1e-30))


def dryrun_phase(dev) -> dict:
    """Phase 31: the dry run's cells, and its predictions held against the
    card; returns the phase's launches (counted from 0)."""
    t0 = time.perf_counter()
    cells = dryrun_cells()
    t1 = time.perf_counter()
    shape = ShapeConfig("train_512", "train", PREDICT_SEQ, PREDICT_BATCH)
    pre = ShapeConfig("prefill_512", "prefill", PREDICT_SEQ, PREDICT_BATCH)
    ops.reset_launches()
    runs = [predicted_vs_card(get_config(DENSE_ARCH), shape, dev),
            predicted_vs_card(get_config(ARCH), pre, dev),
            predicted_vs_card(get_config(ARCH).replace(n_layers=PREDICT_RWKV_LAYERS),
                              shape, dev)]
    opt = [optimizer_launches(cfg, 2, own_norm=False) for cfg in (
        get_config(DENSE_ARCH), get_config(ARCH).replace(n_layers=PREDICT_RWKV_LAYERS))]
    launches = counted({"wkv6": PREDICT_WKV6, "wkv6_bwd": PREDICT_WKV6_BWD,
                        "adamw": sum(o.get("adamw", 0) for o in opt)})
    smi = nvidia_smi()
    for r in runs:
        emit("dryrun_vs_card", nvidia_smi=smi, arch=r["arch"], n_layers=r["n_layers"],
             kind=r["kind"], batch=r["batch"], seq=r["seq"], step_s=r["step_s"],
             t_compute_s=r["roofline"]["t_compute_s"],
             t_memory_s=r["roofline"]["t_memory_s"],
             t_collective_s=r["roofline"]["t_collective_s"],
             predicted_peak_bytes=r["predicted_peak_bytes"],
             measured_peak_bytes=r["measured_peak_bytes"])
    emit("dryrun", nvidia_smi=smi, cells=cells, predicted=runs,
         seconds=dict(cells=t1 - t0, predicted=time.perf_counter() - t1))
    return launches


def adamw_inputs(shapes, dev, dtype=torch.float32, seed: int = 0, step: int = 5) -> tuple:
    """``adamw_update``'s arguments over leaves of ``shapes`` at optimizer
    step ``step``: gradients and parameters in ``dtype``, float32 moments of
    a gradient's scale, the rate and the bias corrections as the optimizer
    makes them (0-d float32 on the card) and a clip scale under 1."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda sh, s: torch.randn(sh, generator=gen, device=dev) * s
    grads = [rand(sh, 1e-3).to(dtype) for sh in shapes]
    params = [rand(sh, 2e-2).to(dtype) for sh in shapes]
    ms = [rand(sh, 1e-4) for sh in shapes]
    vs = [rand(sh, 1e-4).square() for sh in shapes]
    c = torch.tensor(step, dtype=torch.int32, device=dev).float()
    return (grads, ms, vs, params, torch.tensor(3e-4, device=dev), 1 - 0.9 ** c,
            1 - 0.95 ** c, torch.tensor(0.37, device=dev))


def adamw_kernel_vs_plain(dev) -> dict:
    """Phase 32: the optimizer phase's kernels at rwkv6-1.6b's leaf set (19
    float32 leaves, 1.48B elements): ``grad_sq_norm``'s norm within 1e-6 of
    its plain version, its clip scale the clip's formula of that norm bit for
    bit and so within the norm's error of the plain scale, both the same bits
    twice; ``adamw_update`` at the kernel's
    scale against its plain version bit for bit, leaf by leaf; each timed
    against its bytes bound, the plain clip and update (the step's eager
    optimizer before the kernels) timed, and beside them PyTorch's own fused
    AdamW (``torch._fused_adamw_``, another formula: a yardstick of speed).
    Returns the kernels line's row."""
    shapes = [tuple(t.shape) for t in tree_leaves(abstract_state(get_config(ARCH))["params"])]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    args = adamw_inputs(shapes, dev, seed=33)
    grads, ms, vs, params, lr, bc1, bc2, _ = args
    ops.reset_launches()
    norm, scale = grad_sq_norm(grads, 1.0)
    norm2, scale2 = grad_sq_norm(grads, 1.0)
    want_norm, want_scale = grad_sq_norm_ref(grads, 1.0)
    norm_rel = float((norm - want_norm).abs() / want_norm)
    scale_rel = float((scale - want_scale).abs() / want_scale)
    twice = ops.same_bits((norm, scale), (norm2, scale2))
    # the scale is the clip's formula of the kernel's own norm, bit for bit,
    # and so within the norm's error (and two float32 roundings) of the plain
    # scale; the gradients' norm (~38) makes the clip act (scale ~0.026)
    scale_bits = ops.same_bits(scale, clip_scale(norm, 1.0))
    if (norm_rel > 1e-6 or not twice or not scale_bits or not float(want_scale) < 1.0
            or scale_rel > norm_rel + 2.0 ** -22):
        raise AssertionError(f"grad_sq_norm: {float(norm)} against {float(want_norm)} "
                             f"(rel {norm_rel}), scale {float(scale)} against "
                             f"{float(want_scale)} (rel {scale_rel}, the clip's formula of "
                             f"the norm bit for bit {scale_bits}), the same bits twice {twice}")
    got = adamw_update(grads, ms, vs, params, lr, bc1, bc2, scale)
    counted({"grad_sq_norm": 2 * (-(-len(shapes) // ADAMW_MAX_LEAVES) + 1),
             "adamw": -(-len(shapes) // ADAMW_MAX_LEAVES)})
    for i, leaf in enumerate(zip(grads, ms, vs, params)):
        want = adamw_update_ref(*([t] for t in leaf), lr, bc1, bc2, scale)
        if not ops.same_bits(tuple(o[i] for o in got), tuple(w[0] for w in want)):
            raise AssertionError(f"adamw_update differs from its plain version on leaf "
                                 f"{i} {shapes[i]}")
        del want
    del got
    edge = adamw_inputs(ADAMW_EDGE, dev, torch.bfloat16, seed=39)
    if not ops.same_bits(adamw_update(*edge), adamw_update_ref(*edge)):
        raise AssertionError(f"adamw_update differs from its plain version at the odd "
                             f"bfloat16 leaves {ADAMW_EDGE}")
    del edge
    norm_ms = cuda_ms(lambda: grad_sq_norm(grads, 1.0), ADAMW_REPS)
    update_ms = cuda_ms(lambda: adamw_update(*args), ADAMW_REPS)
    plain_ms = cuda_ms(lambda: adamw_update_ref(*args[:7], grad_sq_norm_ref(grads, 1.0)[1]),
                       ADAMW_PLAIN_REPS)
    norm_bytes = grad_sq_norm_work(grads)[0]
    update_bytes = adamw_update_work(grads, params)[0]
    library_ms = None
    if hasattr(torch, "_fused_adamw_"):   # in place: the inputs' last use
        steps = [torch.tensor(5.0, device=dev) for _ in params]
        library_ms = cuda_ms(lambda: torch._fused_adamw_(
            params, grads, ms, vs, [], steps, lr=3e-4, beta1=0.9, beta2=0.95,
            weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False), ADAMW_REPS)
    peak = torch.cuda.max_memory_allocated(dev)
    del args, grads, ms, vs, params
    torch.cuda.empty_cache()
    bytes_ms = (norm_bytes + update_bytes) / PEAK_BYTES_PER_S * 1e3
    emit("adamw_kernel_vs_plain", arch=ARCH, leaves=len(shapes),
         elements=sum(math.prod(sh) for sh in shapes), norm_rel_err=norm_rel,
         scale=float(scale), scale_rel_err=scale_rel, norm_same_bits_twice=twice, update_equal="bits, leaf by leaf",
         edge_shapes=[list(sh) for sh in ADAMW_EDGE], edge_equal="bits (bfloat16)",
         norm_ms=norm_ms, update_ms=update_ms, kernel_ms=norm_ms + update_ms,
         norm_bound_ms=norm_bytes / PEAK_BYTES_PER_S * 1e3,
         update_bound_ms=update_bytes / PEAK_BYTES_PER_S * 1e3, bound_ms=bytes_ms,
         bytes=norm_bytes + update_bytes, plain_ms=plain_ms,
         fused_adamw_library_ms=library_ms, reps=ADAMW_REPS,
         plain_reps=ADAMW_PLAIN_REPS, max_memory_allocated=peak)
    return dict(max_abs_err=0.0, ms=norm_ms + update_ms, plain_ms=plain_ms,
                bytes_ms=bytes_ms, ops_ms=0.0, library_ms=library_ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU host",
              file=sys.stderr)
        return 2

    t_script = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # float32 products in full float32 (PyTorch's default, stated here): the
    # card-vs-CPU checks hold float32 logits to 1e-4
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. card and build
    smi = nvidia_smi()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        print(f"--- nvcc {name}\n{log}", file=sys.stderr)
    emit("card", nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         build_s=build_s, built=sorted(logs))

    # ---- 2. kernel against its plain version at the main path's shapes
    pop = make_population(FULL, N_DIMMS)
    batch = DimmBatch.from_population(pop, dev)
    g = batch.geom
    adder = torch.as_tensor(condition_adders(batch, 85.0, 64.0), device=dev)
    coeffs = _pack_coeffs(batch, 2, 7.5, PATTERN_STRESS["0101"], adder, 0, 0)
    row_src = batch.row_src[:, 0].contiguous()
    d_mat = torch.as_tensor(_geom_consts(g)[1], device=dev)
    C = g.cols_per_mat
    errs = {"main": grid_exact(fail_prob, fail_prob_ref, row_src, d_mat, coeffs, cols=C),
            "closed_bitline": grid_exact(fail_prob, fail_prob_ref, row_src, d_mat,
                                         coeffs, cols=C, open_bitline=False)}
    rng = np.random.default_rng(0)
    rag_rows = torch.as_tensor(rng.integers(0, 100, (3, 100)), dtype=torch.int32,
                               device=dev)
    rag_cf = torch.as_tensor(
        np.array([3.9, 2.1, 0.4, 0.8, 0.4, 7.5, 0.15, 3e-6, 3.5], np.float32)
        + (rng.normal(0, 0.05, (3, 9)) * (np.arange(9) < 6)).astype(np.float32),
        device=dev)
    errs["ragged"] = grid_exact(fail_prob, fail_prob_ref, rag_rows, d_mat[:5], rag_cf,
                                cols=96)
    for i, (De, Me, Re, Ce, ob) in enumerate(FP_EDGES):
        rs, dm, cf = edge_inputs(De, Me, Re, coeffs, d_mat, seed=10 + i)
        errs[f"{De}x{Me}x{Re}x{Ce}" + ("" if ob else "_closed")] = grid_exact(
            fail_prob, fail_prob_ref, rs, dm, cf, cols=Ce, open_bitline=ob)
    # the kernel's divisions by sigma, sqrt 2 and 1 + p|x| against IEEE
    # division on every operand of the ranges where it takes them, for the
    # population's divisors (csrc/fail_prob.cu)
    divisors = torch.cat([batch.sigma, batch.ret_sigma]).float().clamp_min(1e-6).unique()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    div_bad = division_check(divisors)
    div_s = time.perf_counter() - t0
    if any(div_bad):
        raise AssertionError(f"fast divisions differ from IEEE division on "
                             f"{div_bad} operands (x / sigma, z / sqrt 2, 1 / d)")
    emit("division_check", divisors=len(divisors), mismatches=div_bad, seconds=div_s)
    kernel_ms = cuda_ms(lambda: fail_prob(row_src, d_mat, coeffs, cols=C), 20)
    plain_ms = cuda_ms(lambda: fail_prob_ref(row_src, d_mat, coeffs, cols=C), 5)
    D, M, R = batch.n_dimms, g.mats_x, g.rows_per_mat
    cells = D * M * R * C
    n_bytes = row_src.numel() * 4 + d_mat.numel() * 4 + coeffs.numel() * 4 \
        + cells * 4
    bw, flops = PEAK_BYTES_PER_S, PEAK_FP32_FLOPS
    bytes_ms, ops_ms = n_bytes / bw * 1e3, cells * FAIL_PROB_FLOPS_PER_CELL / flops * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    emit("kernel_vs_plain", kernel="fail_prob", shape=[D, M, R, C],
         max_abs_err_by_case=errs, ragged_shape=[3, 5, 100, 96],
         edge_shapes=[list(e) for e in FP_EDGES], equal="torch.equal",
         kernel_ms=kernel_ms, plain_ms=plain_ms,
         bound_ms=bound_ms, bytes_ms=bytes_ms, ops_ms=ops_ms,
         bytes=n_bytes, flops=cells * FAIL_PROB_FLOPS_PER_CELL,
         peak_bytes_per_s=bw, peak_fp32_flops=flops,
         comparison_launches=fail_prob.launches)

    # ---- 3-4. the main path, counted
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lam = row_error_lambda(batch, "trp", 7.5)
    DENSE["lam"] = lam
    char_s = time.perf_counter() - t0
    char_launches = ops.launch_counts()["fail_prob_rows"]
    expected = g.subarrays * 4
    if char_launches != expected:
        raise AssertionError(f"row_error_lambda launched fail_prob_rows "
                             f"{char_launches} times, expected {expected}")
    t0 = time.perf_counter()
    diva = profile_population_arrays(batch, region="worst", multibit_only=True)
    diva_s = time.perf_counter() - t0
    conv_batch = DimmBatch.from_population(pop[:N_CONVENTIONAL], dev)
    t0 = time.perf_counter()
    conv = profile_population_arrays(conv_batch, region="all")
    conv_s = time.perf_counter() - t0
    launches = counted({"fail_prob_rows": expected})   # the sweep runs no kernel

    # ---- checks against the port on the CPU
    if lam.shape != (D, g.subarrays * R) or not np.isfinite(lam).all():
        raise AssertionError(f"row_error_lambda gave {lam.shape}, non-finite?")
    lam_cpu = row_error_lambda(DimmBatch.from_population(pop[:4], "cpu"),
                               "trp", 7.5)
    np.testing.assert_allclose(lam[:4], lam_cpu, rtol=LAMBDA_RTOL, atol=1e-6)
    lam_rel = float(np.max(np.abs(lam[:4] - lam_cpu)
                           / np.maximum(np.abs(lam_cpu), 1e-30)))
    emit("characterization", dimms=D, param="trp", t_op=7.5, seconds=char_s,
         launches=char_launches, lam_shape=list(lam.shape),
         lam_total=float(lam.sum()), cpu_dimms=4, max_rel_err_vs_cpu=lam_rel,
         rtol=LAMBDA_RTOL)

    diva_cpu = profile_population_arrays(
        DimmBatch.from_population(pop[:8], "cpu"), region="worst",
        multibit_only=True)
    if not np.array_equal(diva[:8], diva_cpu):
        raise AssertionError(f"DIVA tables differ on the card and the CPU:\n"
                             f"{diva[:8]}\n{diva_cpu}")

    def mean_reduction(tables):
        lr = [latency_reduction(TimingParams(*map(float, row))) for row in tables]
        return (float(np.mean([x["read_reduction"] for x in lr])),
                float(np.mean([x["write_reduction"] for x in lr])))

    d_read, d_write = mean_reduction(diva)
    c_read, c_write = mean_reduction(conv)
    emit("profiling", diva_dimms=D, diva_seconds=diva_s,
         conventional_dimms=N_CONVENTIONAL, conventional_seconds=conv_s,
         diva_equal_cpu_dimms=8,
         diva_mean_read_reduction=d_read, diva_mean_write_reduction=d_write,
         conventional_mean_read_reduction=c_read,
         conventional_mean_write_reduction=c_write,
         paper_read_reduction=PAPER_READ, paper_write_reduction=PAPER_WRITE,
         diva_first_tables=diva[:4].tolist())

    # ---- 5-8. the DIVA Shuffling path and the codec, each counted
    ints = int_kernels_vs_plain(dev)
    paths = [launches, fig17_profiled(batch, pop), fig17_synthetic(dev),
             codec_blob(dev)]

    # ---- 9. the Fig 19 memory system, counted
    memsim_launches, ints["bank_sched"] = memsim_phase(dev, batch, diva)
    paths.append(memsim_launches)

    # ---- 10-11. the operating-point and signature kernels against plain
    ints["fail_prob_op"] = op_kernel_vs_plain(batch)
    ints["bit_signature"] = sig_kernel_vs_plain(dev)

    # ---- 12-14. operating points, the fleet error summary, blind discovery
    paths += [op_points_phase(batch, pop), error_summary_phase(batch, pop),
              blind_phase(batch, pop)]

    # ---- 15-17. the circuit model (rc_transient) and the lifetime lifecycle
    ints["rc_transient"] = rc_kernel_vs_plain(dev)
    paths += [circuit_phase(dev), lifetime_phase(batch, pop)]

    # ---- 18-19. the wkv6 kernel, and RWKV-6 serving at full width
    ints["wkv6"] = wkv_kernel_vs_plain(dev)
    paths.append(rwkv6_serving_phase(dev))

    # ---- 20-22. the fleet service, its CPU twin and CLI, the streamed scans
    paths += [fleet_phase(dev), serve_twin_phase(dev),
              stream_scans_phase(batch, diva)]
    for key in [k for k in DENSE if k.startswith("codec_")]:
        del DENSE[key]                                   # phase 22's only

    # ---- 23-24. the wkv6 backward kernel, and RWKV-6 training at full width
    ints["wkv6_bwd"] = wkv_bwd_kernel_vs_plain(dev, logs.get("wkv6_bwd", ""))
    paths.append(rwkv6_training_phase(dev))

    # ---- 25. the DIVA path with the DIMM axis split over a mesh
    paths.append(sharded_phase(batch, diva))

    # ---- 26-27. the dense and MoE families: serving and training
    t0 = time.perf_counter()
    paths.append(dense_serving_phase(dev))
    t1 = time.perf_counter()
    paths.append(dense_training_phase(dev))
    emit("dense_phases", serving_s=t1 - t0, training_s=time.perf_counter() - t1)
    DENSE.clear()

    # ---- 28-29. the hybrid, vlm and audio families: serving and training
    t0 = time.perf_counter()
    paths.append(families_serving_phase(dev))
    t1 = time.perf_counter()
    paths.append(families_training_phase(dev))
    emit("family_phases", serving_s=t1 - t0, training_s=time.perf_counter() - t1)

    # ---- 30. the training mesh over NCCL
    t0 = time.perf_counter()
    paths.append(mesh_training_phase(dev))
    emit("mesh_phase", seconds=time.perf_counter() - t0)

    # ---- 31. the dry run and the roofline, predicted against the card
    t0 = time.perf_counter()
    paths.append(dryrun_phase(dev))
    emit("dryrun_phase", seconds=time.perf_counter() - t0)
    total = {name: sum(p[name] for p in paths) for name in ops.KERNELS}

    # ---- 32. the optimizer phase's kernels at rwkv6-1.6b's leaves
    ints["adamw"] = adamw_kernel_vs_plain(dev)

    rows = [dict(name="fail_prob",
                 source="src/repro_torch/kernels/csrc/fail_prob.cu",
                 replaces="src/repro/kernels/fail_prob.py:114",
                 max_abs_err=max(errs.values()),
                 ms=kernel_ms, plain_ms=plain_ms, bytes_ms=bytes_ms,
                 ops_ms=ops_ms, library_ms=None)]
    for name, source, replaces in (
            ("secded_encode", "secded.cu", "secded.py:56"),
            ("secded_syndrome", "secded.cu", "secded.py:73"),
            ("diva_shuffle", "shuffle.cu", "shuffle.py:64"),
            ("bank_sched", "bank_sched.cu", "bank_sched.py:138"),
            ("fail_prob_op", "fail_prob.cu", "fail_prob.py:161"),
            ("bit_signature", "bit_signature.cu", "bit_signature.py:53"),
            ("rc_transient", "rc_transient.cu", "rc_transient.py:80"),
            ("wkv6", "wkv6.cu", "wkv6.py:66")):
        rows.append(dict(name=name,
                         source=f"src/repro_torch/kernels/csrc/{source}",
                         replaces=f"src/repro/kernels/{replaces}", **ints[name]))
    # no Pallas twin: the reference differentiates its scan with XLA
    rows.append(dict(name="wkv6_bwd", source="src/repro_torch/kernels/csrc/wkv6_bwd.cu",
                     replaces="src/repro/models/rwkv6.py:54", **ints["wkv6_bwd"]))
    # no Pallas twin: the reference's clip and AdamW are jnp that XLA fuses
    rows.append(dict(name="adamw", source="src/repro_torch/kernels/csrc/adamw.cu",
                     replaces="src/repro/optim/optimizers.py:31", **ints["adamw"]))
    print(json.dumps({"kernels": [{
        "name": r["name"], "route": "cuda", "source": r["source"],
        "replaces": r["replaces"], "launches": total[r["name"]],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": max(r["bytes_ms"], r["ops_ms"]),
        "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
        "library_ms": r["library_ms"]} for r in rows]}), flush=True)
    emit("script", seconds=time.perf_counter() - t_script, build_s=build_s,
         nvidia_smi=smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
