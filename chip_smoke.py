#!/usr/bin/env python3
"""Smoke test of the PyTorch port (icsg3d_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits nonzero, before the result line):

1. Device: the card's name and ``nvidia-smi`` name and power limit; CUDA
   must be available.
2. Build: compile icsg3d_torch/csrc/conv3d.cu, conv3d_dw.cu, voxelize.cu
   and extract.cu for sm_90a (one nvcc per source, started together;
   ctypes).
3. Kernel vs plain, at batch 20, each against its plain version on the
   same operands (TF32 off), with the kernel's, the plain version's and
   one PyTorch library call's CUDA-event medians of 10 runs, and the
   bound (the larger of bytes / 3.35 TB/s and FLOPs / the H100's dense
   peak: 989.4 TFLOP/s bf16, 66.9 TFLOP/s f32):
   - forward: every 3x3x3 conv shape of the generation path with its path
     epilogue, then every forward of the training step (epilogue
     ``bias``), against ``conv3d_same_reference``; library F.conv3d;
   - K1 as dx: the 18 input-gradient convs of a training step, against
     ``conv3d_dx_reference``; library torch.nn.grad.conv3d_input;
   - K2: the 10 VAE weight gradients, against ``conv3d_dw_reference``;
     library torch.nn.grad.conv3d_weight.  A second launch must give the
     same bits (the split-K sum runs in a fixed order).  Each dW row also
     prints K2's path (``wgmma+tma``, ``wgmma+cp.async``, or the f32 head's
     ``fma+slide`` with its tile from ``kernels/conv3d_dw.fma_plan``),
     bound/kernel, the split-K workspace MB and split count, and the second
     (split-sum) pass's device ms from one profiled launch.
   Each forward and dx row (and the VALID rows of phase 14) also prints
   the conv kernel's path (``wgmma+tma`` with its tile from
   ``kernels/conv3d.plan``: N tile, m64 sub-tiles, rows x planes, column
   segments; or the f32 head's ``fma+window`` with its tile from
   ``kernels/conv3d.fma_plan``) and bound/kernel, and at every
   shape of every pass a second launch must give the same bits (no
   atomics, no split sum in the conv kernel).
   Bound on max|err| / max|ref|: 1e-2 for bf16 outputs, 1e-4 for f32
   outputs, 1e-3 for dW (f32 out, but sums of 10^3..10^6 bf16 products
   taken in another order).  Each pass's summary line gives its sums and
   kernel/library and kernel/bound.  The generation shapes are checked
   again at evaluate's batch 10 and at the later paths' other batches:
   1 (view, interpolate's pair encodes), 2 (the encoder: the sweep's
   encodes) and 4 (the trainers' plot forwards); and at the rows each
   data-parallel rank of phase 27 holds: the VAE step's forwards, dx and
   dW at 10, the U-Net's training and eval forwards, dx and dW at 5.  The
   batch 1, 2, 4, and the ranks' rows' errors join the kernels line;
   their times stay out of its sums.
4. Generation: ``icsg3d_torch.apps.generate.main`` on a synthetic 32^3
   GridDataset with seeded full-width weights (.npz), 40 samples at batch
   20, once with ``--fused`` and once on the host watershed path.  Checks
   40 records, finite lattices, that the conv kernel was launched
   exactly once per 3x3x3 conv of the path, and the extraction kernels
   2 x batches (E1) and batches (E2) times with ``--fused``, never on the
   host path.  ``[breakdown]``: one fused batch of 20 by stage (decode,
   U-Net, extraction) and the extraction by its stages (E1 foreground,
   erosion, E1 cores, seeds, E2, region ranking and votes), CUDA-event
   medians; one ``extract_atoms`` at batch 20 under
   ``torch.cuda.set_sync_debug_mode("error")``, queued behind a long
   sleep kernel that must still run when it returns (no host sync).
   ``[extract-kernels]``: E1 (``extract_cc``) and E2 (``extract_bfs``)
   against their plain versions on the same operands: the breakdown's
   decoded masks (E1 on the foreground and the erosion cores, E2 on the
   split's seeds), a batch of 128 (bench.py's fused generation batch,
   decoded in chunks of 20), 4 of the masks at 64^3, and (errors in the
   kernels line, times not) batch 1 and 4 at 32^3, one mask at 64^3, one
   at 96^3 (the smallest grid whose state the plan keeps in device
   memory), and the adversarial grids of tests/test_torch_extract_plan.py
   at 32^3 (empty, full, a one-voxel-wide snake, a multi-valued grid, two
   seeds equidistant from a box's middle plane, a non-cubic blob grid).
   Labels bitwise equal, E2's largest per-sample round count the plain
   version's; each row gives the plan (CTAs per sample, shared or device
   memory, the clusters the card runs at once), kernel and plain
   CUDA-event medians, the byte bound (E1 8 bytes per voxel, E2 14 with
   seed labels, 10 without, over 3.35 TB/s) and its share, E1's merge
   passes or E2's rounds against the plain version's rounds.
5. GPU vs CPU: the fused step for one batch of 2 on the card and on the
   CPU (plain versions), same weights and latents.  Lattices agree to
   1e-2 relative; extracted atoms agree wherever the masks agree, and the
   card's extraction of the CPU's own masks (E1 twice, E2 once) equals
   the CPU's plain versions' exactly.
6. Training: ``icsg3d_torch.apps.train_vae.main`` at production width
   (32^3 x 4, filters 16-128, latent 256, the seeded 95-class U-Net for the
   DFC loss, batch 20) on 100 synthetic parents with ``--nrot 0`` (80
   train = 4 steps, 20 val = 1 batch), 2 epochs.  Checks a finite loss
   every epoch, history.json, and the launch counts: 28 forward, 18 dx
   and 10 dW per train step, 28 forward per eval step.  Then generate
   ``--fused`` from the trained checkpoint directory.
7. Train step: the counts of one train step and one eval step alone; ms
   per step by stage (VAE forward, perceptual forwards and loss,
   backward, Adam) and grids/s (CUDA events); one torch.profiler step,
   with the device ms and launches of each conv kernel in it (bf16 and the
   f32 head's apart, and K2's split sum).
8. GPU vs CPU for one train step (batch 2, same weights and noise): loss
   within 2e-2 relative, and the cosine of the first and last VAE conv's
   weight gradients at least 0.95 (bf16 activations and input gradients
   through ~20 convs on the card, f32 on the CPU).
9. Voxelizer kernel (K4) against its plain version on the same operands:
   one production launch (256 synthetic perovskite/rocksalt structures,
   32^3, site_pad 64) and the repo's real CIFs (tests/fixtures/real_cifs,
   those within max_sites 40) at 32^3.  Species identical (a differing
   voxel prints its f64 margin to the labelling radius or to the tie),
   density within rtol 2e-4 / atol 1e-6; kernel and plain CUDA-event
   medians and the bound (the largest of bytes / 3.35 TB/s, f32 operations
   / 66.9 TFLOP/s, exponentials / the SFU rate of 16 per SM per clock at
   the card's maximum SM clock), counted over the real sites.  Each row
   adds the profiled device ms of K4's two kernels (main and per-structure
   setup) and the bound share, and prints the thread tile and the voxels
   that took the tie walk (inside two or more radii).
10. Dataset build: ``icsg3d_torch.apps.voxelize.main`` on the real CIFs
   (``--nrot 2 --d 32``, card and ``--device cpu``: identical ids and
   species, density within rtol 2e-4) and on 300 synthetic structures
   (``--nrot 0``).  K4 launched ceil(kept / 256) times per build; every
   field written; species within {0} and the structure's atomic numbers.
11. U-Net training: ``icsg3d_torch.apps.train_unet.main`` on the
   synthetic build at production width (95 classes, batch 10, ``--nrot
   0``, 2 epochs of 24 train steps and 6 val batches): finite metrics,
   history.json, class_weights.json, and exactly 14 forward (``bias``), 13
   dx and 14 dW launches per train step and 14 folded forwards per eval
   step.  Then generate ``--fused`` with the trained checkpoint directory.
12. U-Net train step: the counts of one train and one eval step alone; ms
   by stage (forward, loss, backward, Adam) and train grids/s at batch 10;
   one torch.profiler step.  The backward-kernel phase (3) also checks
   the 14 U-Net dW shapes and the 5 dx shapes of convs 10-14 at batch 10,
   and the forward phase the 14 U-Net training forwards at batch 10.
13. GPU vs CPU for one U-Net train step (batch 2, same weights and
   batch): loss within 2e-2 relative, weight-gradient cosines of conv1
   and conv14 at least 0.95.
14. Depth-VALID kernels (``--spatial``), each against its plain version on
   the same operands, at every shape the two sharded train steps launch
   on a 1x2 mesh (a slab of edge/2 output planes, full batch): K1 VALID
   (``conv3d_valid_cuda`` vs ``conv3d_valid_reference``; library F.conv3d
   with padding (0, 1, 1)), its full-window dx (``conv3d_dx_valid_cuda``;
   library torch.nn.grad.conv3d_input) and K2 VALID
   (``conv3d_dw_valid_cuda``; library conv3d_weight), with the bounds,
   the dW columns and the same-bits check of phase 3.
15. Sharded training: ``apps.train_vae.main --spatial 2 --device
   cuda:0,cuda:0`` at production width for one epoch (4 steps + 1 val
   batch), then ``apps.train_unet.main --spatial 2`` for one epoch at
   batch 10 (24 steps + 6 val batches).  Per VAE train step: 20 VALID
   forwards, 18 SAME forwards (the frozen U-Net taps), 18 VALID dx + 9
   SAME dx, 20 VALID dW; per VAE eval step 20 VALID (18 folded) + 18 SAME.
   Per U-Net train step 28 VALID forwards, 26 VALID dx, 28 VALID dW; per
   eval step 28 VALID folded.
16. ``--spatial 2`` against ``--spatial 1``: for each trainer one train
   step from the same weights and batch, loss within 1e-4 relative and
   every weight gradient's cosine at least 0.999; the launch counts of
   one sharded train and eval step alone; both train steps' times
   (CUDA-event medians, in turns); one profiled sharded train step.
16a. The captured epoch (``[epoch-scan]``): ``apps.train_vae.main
   --resident --epoch-scan`` (each epoch one upload of the permutation,
   the train and eval steps as replays of CUDA graphs captured after one
   eager warm-up step, one fetch; train/graphs.py) against ``--resident``'s
   per-step loop with the same seed, 2 epochs each at production width:
   the VAE at batch 20 on 300 parents (12 steps + 3 val batches) in turns
   per-step, captured, captured, per-step, and with
   ``--cache-true-features``; ``apps.train_unet.main`` at batch 10 on the
   synthetic build in turns; the VAE at ``--spatial 2 --device
   cuda:0,cuda:0`` on the 100 parents of phase 6.  Each captured run's
   latest.npz (parameters, BatchNorm statistics, Adam's moments and step)
   and history bitwise those of its per-step twin (the U-Net's per-class
   CE sums within 1e-5: ``index_add_``'s float atomics); the card's
   launches (each capture's recorded launches times its replays, plus the
   eager ones) those of the per-step run, which match the per-step
   counts; the train capture replayed every step but the warm-up.  Both
   paths' epoch times in turns.  Then one train epoch of each path,
   unprofiled in turns and once under torch.profiler, on one state (the
   VAE at batch 20, the U-Net at 10): wall ms, steps/s, device busy ms,
   idle share, kernels and host launch/copy calls per step, and the
   captured epoch's graph launches (one per step).

17. CGCNN training: ``icsg3d_torch.apps.train_cgcnn.main`` at production
   width (93 -> 64, 41 centres, 50 x 12 graphs, hidden 128, f32) on 320
   synthetic structures, 2 epochs at batch 32 (8 steps + 2 val batches),
   once per property (formation energy, band gap): finite losses,
   best.npz, latest.npz and history.json, no conv launch; TF32 off; the
   train step's and the forward's CUDA-event medians at batch 32 (train
   graphs/s, predictions/s) and one profiled train step.
18. GPU vs CPU for CGCNN at batch 32, same seeded weights and batch:
   predictions within 1e-5 of max(1, max|pred|), one train step's loss
   within 1e-5 relative and every gradient within 1e-4 of its max.
19. Prediction: ``apps.predict.main`` on the real CIFs with the two
   checkpoints, card and ``--device cpu``: a record per CIF, the same
   parse errors, finite properties within 1e-5 of max(1, max|value|).
20. ``apps.generate --fused --cgcnn-ckpt`` with both checkpoints on the
   blob dataset of phase 4 (the VAE's coordinate outputs scaled to cells
   of a few Angstrom, threshold 0.9999, atoms merged within 1.5 Angstrom;
   see ``phase_generate_cgcnn``): 24 conv launches; every structure of
   1..50 atoms carries both properties.
21. Evaluation: ``apps.evaluate.main`` on the synthetic build of phase 10
   (``--samples 45``: 9 validation samples, one batch of 10, padded) with
   the seeded models, card and ``--device cpu``: every sample evaluated or
   skipped, one K1 ``bias`` and 23 folded launches per batch, the same
   n_evaluated on the CPU and lattices within 1e-2 relative.
22. Interpolation: ``apps.interpolate.main`` with the VAE checkpoint of
   phase 6 on the synthetic build of phase 10, a pair (``--ninterps 10``)
   and ``--sweep-conds``: every strip (12, 32, 32, 32, 4), finite, its
   endpoints bitwise the input grids, one strip per condition bin of two
   or more members; one K1 ``bias`` and 4 folded launches per encode
   batch, 5 folded per decode batch.  One pair card vs CPU (same weights):
   the decoded frames within 2e-2 of max|CPU| in each channel (density
   and the three coordinates apart); the time per strip.
23. The viewer: ``apps.view.main --n 3`` with the checkpoints of phases 6
   and 11 (the U-Net's background bias shifted so that F1 is not 0 on
   both sides, ``view_unet``), card and ``--device cpu`` with the same
   ``--seed``: mse within 2e-2 relative, F1 within 0.02 and above 0 on
   the CPU; one ``bias`` and 23 folded launches per sample; seconds per
   sample.
24. Plots: where matplotlib does not import (the card's machine), both
   trainer CLIs print ``plots skipped: matplotlib is not installed`` once,
   write history.json and no plot, and launch exactly their training's
   kernels; ``evaluate --plots`` and ``interpolate --voxels`` exit 2 with
   a usage error naming matplotlib, before any load.  Where it imports,
   the trainers write loss.png and their best-val plots (whose forwards'
   launches are counted), evaluate its seven PNGs.  The phases before
   count their trainers' training alone: there the trainers draw no plots
   (``plots_off``).
25. Profiling: ``utils/profiling.StepTimer`` over the VAE train step at
   batch 20 and the U-Net train step at batch 10 (step ms, grids/s, MFU
   of the analytic FLOP count against the dense bf16 peak), and
   ``profiling.trace`` around one more step writes a non-empty trace.
26. Data parallelism over NCCL, one rank (``[dp-nccl]``): this script
   again as a rank worker (``--dp-worker``) under ``python -m
   torch.distributed.run --standalone --nproc-per-node 1``, running
   ``apps.train_vae.main --device cuda --dist-backend nccl`` for one epoch
   at batch 20: its history equal to (or within rtol 1e-6 of) the first
   epoch of phase 6's single-process run, its launches those of one
   epoch; then the gradient buffer's bytes, the gradient all-reduce's
   CUDA-event ms and the train step's ms beside the same step without a
   process group.
26a. The captured epoch under a process group (``[dp-nccl-epoch-scan]``):
   this script as a rank worker under torchrun with one NCCL rank, running
   phase 16a's ``apps.train_vae.main`` at batch 20 (with and without
   ``--cache-true-features``) and ``apps.train_unet.main`` at batch 10,
   ``--resident --epoch-scan`` and ``--resident``, 2 epochs each: no
   ``--epoch-scan: not captured`` line; each run's latest.npz and history
   bitwise those of its per-step twin and of phase 16a's single-process
   captured run (the U-Net's CE sums within 1e-5); launches (captured x
   replays) those of the per-step run and of phase 16a.  Then on the rank,
   on one state each for the VAE at batch 20 and the U-Net at batch 10,
   in turns and then profiled: the epoch wall, steps/s and idle share of
   the per-step epoch in the group, the captured epoch in the group (its
   all-reduces inside the graph) and a captured epoch with the group
   taken off, with the NCCL kernels of each profiled epoch (at world 1
   NCCL may launch none); a captured epoch under sync-debug mode "error"
   returns while a kernel queued before it still runs.  Where two cards
   are visible, the VAE and the U-Net on two NCCL ranks, one per card, at
   ``DP_LR``: captured vs per-step bitwise, the ranks' histories and
   BatchNorm statistics equal, within 2e-2 of a single-process captured
   run at the same global batch; with one card a line says why that check
   did not run.
27. Two ranks on cuda:0 over gloo (``[dp-gloo]``; NCCL refuses two ranks
   on one card): ``train_vae`` (batch 20, 10 rows per rank),
   ``train_unet`` (10, 5) and ``train_cgcnn`` (32, 16), one epoch each,
   the VAE at lr 1e-5 and the U-Net at 1e-7 (``DP_LR``: Adam turns a
   last-bit difference of a near-zero gradient into a +-lr step), against
   world-1 runs of the same global batches: in float32 (``f32_cli``)
   every per-epoch metric within rtol 1e-3, and in bfloat16, the card's
   dtype, whose runs join the kernels line, within 2e-2 (f1 and weighted
   recall, voxel-count ratios in [0, 1], absolute); only rank 0 wrote
   under the checkpoint directory, both ranks' BatchNorm statistics
   bitwise equal, each rank's launches its steps times the per-step
   counts.  Then one VAE and one U-Net train step from the seeded weights
   against world 1 on the whole batch: in float32, loss and every metric
   within 1e-4 (f1 and weighted recall absolute, the U-Net's class counts
   exactly) and every gradient within 1e-2 of the world-1 gradient in l2
   norm (a max pool's argmax may move with the last bit of a BatchNorm
   moment, so single elements may differ more: the largest is printed),
   and the VAE's conv biases before a training BatchNorm (true gradient
   0) below 1e-2 of their kernel's max gradient on both sides; in
   bfloat16, where such last-bit moves grow through the layers (see
   ``phase_dp_gloo``), loss within 2e-2 and gradient cosines at least
   0.95, the card-vs-CPU standard of phases 8 and 13, and the step's and
   the gradient all-reduce's times.  Two processes share the card and
   gloo goes through the host: the times are not a data-parallel rate.
   Last, ``train_vae --resident --epoch-scan`` in float32 on the two
   ranks: each prints the refusal of a gloo group on a CUDA model (gloo
   moves CUDA tensors through host memory) and gives ``--resident``'s
   history, launches and latest.npz bitwise.
28. The build in parts (``[dp-voxelize]``): ``apps.voxelize --synthetic
   300`` on two gloo ranks on cuda:0, rank k writing ``part-<k>/``;
   ``merge_parts`` equals phase 10's single-process build bitwise in
   every field, id by id; one K4 launch per rank.

Every torchrun launch has a timeout (its process group is killed on the
way out) and a failed rank fails the smoke test.  It imports nothing of
JAX.  The last two stdout lines are the kernels
JSON object (ten entries; the extraction kernels' launches are those of
every ``--fused`` generation: phase 4's, the trained checkpoints' of
phases 6 and 11 and ``--cgcnn-ckpt``'s) and then ``{"ok": true,
"device": {...}}``; the kernels' launches count generation with
``--cgcnn-ckpt``, evaluate, interpolate, view, the plots phase's
trainers, the data-parallel ranks and the runs of phases 16a and 26a (captured
launches times replays) too.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

BATCH = 20
NSAMPLES = 40
D = 32
SEED = 0
DEVICE = "cuda"

# Every 3x3x3 conv of the generation path at production width:
# (model, Cin, Cout, grid edge, epilogue, input dtype, output dtype)
CONV_SHAPES = [
    ("vae.encoder", 14, 16, 32, "affine_leaky", "bf16", "bf16"),
    ("vae.encoder", 16, 32, 16, "affine_leaky", "bf16", "bf16"),
    ("vae.encoder", 32, 64, 8, "affine_leaky", "bf16", "bf16"),
    ("vae.encoder", 64, 128, 4, "affine_leaky", "bf16", "bf16"),
    ("vae.encoder", 128, 4, 2, "bias", "bf16", "bf16"),
    ("vae.decoder", 4, 128, 4, "affine_leaky", "bf16", "bf16"),
    ("vae.decoder", 128, 64, 8, "affine_leaky", "bf16", "bf16"),
    ("vae.decoder", 64, 32, 16, "affine_leaky", "bf16", "bf16"),
    ("vae.decoder", 32, 16, 32, "affine_leaky", "bf16", "bf16"),
    ("vae.decoder", 16, 4, 32, "affine_relu", "f32", "f32"),
    ("unet", 4, 32, 32, "relu_affine", "bf16", "bf16"),
    ("unet", 32, 64, 32, "relu_affine", "bf16", "bf16"),
    ("unet", 64, 64, 16, "relu_affine", "bf16", "bf16"),
    ("unet", 64, 128, 16, "relu_affine", "bf16", "bf16"),
    ("unet", 128, 128, 8, "relu_affine", "bf16", "bf16"),
    ("unet", 128, 256, 8, "relu_affine", "bf16", "bf16"),
    ("unet", 256, 512, 4, "relu_affine", "bf16", "bf16"),
    ("unet", 512, 512, 4, "relu_affine", "bf16", "bf16"),
    ("unet", 768, 512, 8, "relu_affine", "bf16", "bf16"),
    ("unet", 512, 256, 8, "relu_affine", "bf16", "bf16"),
    ("unet", 384, 256, 16, "relu_affine", "bf16", "bf16"),
    ("unet", 256, 128, 16, "relu_affine", "bf16", "bf16"),
    ("unet", 192, 128, 32, "relu_affine", "bf16", "bf16"),
    ("unet", 128, 128, 32, "relu_affine", "bf16", "bf16"),
]

# The 3x3x3 convs of one DFC-VAE train step: (name, Cin, Cout, edge, dtype).
VAE_CONVS = [
    ("vae.enc.Conv_0", 14, 16, 32, "bf16"),
    ("vae.enc.Conv_1", 16, 32, 16, "bf16"),
    ("vae.enc.Conv_2", 32, 64, 8, "bf16"),
    ("vae.enc.Conv_3", 64, 128, 4, "bf16"),
    ("vae.enc.Conv_4", 128, 4, 2, "bf16"),
    ("vae.dec.Conv_0", 4, 128, 4, "bf16"),
    ("vae.dec.Conv_1", 128, 64, 8, "bf16"),
    ("vae.dec.Conv_2", 64, 32, 16, "bf16"),
    ("vae.dec.Conv_3", 32, 16, 32, "bf16"),
    ("vae.dec.output", 16, 4, 32, "f32"),
]
UNET_PREFIX = [  # the perceptual forward, cut at conv9 (taps 3/5/7/9)
    ("unet.conv1", 4, 32, 32, "bf16"),
    ("unet.conv2", 32, 64, 32, "bf16"),
    ("unet.conv3", 64, 64, 16, "bf16"),
    ("unet.conv4", 64, 128, 16, "bf16"),
    ("unet.conv5", 128, 128, 8, "bf16"),
    ("unet.conv6", 128, 256, 8, "bf16"),
    ("unet.conv7", 256, 512, 4, "bf16"),
    ("unet.conv8", 512, 512, 4, "bf16"),
    ("unet.conv9", 768, 512, 8, "bf16"),
]
# forwards of a train step: the VAE, then the U-Net prefix twice
TRAIN_FWD_SHAPES = [(n, ci, co, e, "bias", dt, dt)
                    for n, ci, co, e, dt in VAE_CONVS + UNET_PREFIX]
# input gradients: the U-Net prefix (to reach the reconstruction) and every
# VAE conv but the encoder's first, whose input is data
DX_SHAPES = UNET_PREFIX[::-1] + VAE_CONVS[:0:-1]
DW_SHAPES = VAE_CONVS  # weight gradients: the VAE only (the U-Net is frozen)
FWD_PER_STEP = len(VAE_CONVS) + 2 * len(UNET_PREFIX)  # 28, eval steps too
DX_PER_STEP, DW_PER_STEP = len(DX_SHAPES), len(DW_SHAPES)  # 18, 10

TRAIN_PARENTS, TRAIN_EPOCHS = 100, 2  # 80 train (4 steps) + 20 val per epoch

# U-Net training at the CLI's and the reference's batch: its 14 convs
# (name, Cin, Cout, edge, dtype).
UNET_BATCH = 10
UNET_TRAIN = UNET_PREFIX + [
    ("unet.conv10", 512, 256, 8, "bf16"),
    ("unet.conv11", 384, 256, 16, "bf16"),
    ("unet.conv12", 256, 128, 16, "bf16"),
    ("unet.conv13", 192, 128, 32, "bf16"),
    ("unet.conv14", 128, 128, 32, "bf16"),
]
UNET_FWD_SHAPES = [(n, ci, co, e, "bias", dt, dt) for n, ci, co, e, dt in UNET_TRAIN]
UNET_DX_NEW = UNET_TRAIN[:8:-1]  # convs 14..10: dx shapes the VAE step has not
UNET_CONVS_N = len(UNET_TRAIN)  # 14 forward + 14 dW per train step, 13 dx
UNET_PARENTS, UNET_EPOCHS = 300, 2  # 240 train (24 steps) + 60 val (6 batches)

# The dataset build: the CLI's chunk at 32^3 and the config's site limits.
VOX_CHUNK, SITE_PAD, MAX_SITES = 256, 64, 40
REAL_CIFS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                         "fixtures", "real_cifs")
SFU_EXP_PER_SM_CLOCK = 16

# Depth sharding: the spatial mesh axis of the sharded phases, a 1x2 mesh
# of the one card.
SPATIAL = 2
SPATIAL_DEVICES = ",".join(["cuda:0"] * SPATIAL)

# The H100 SXM's dense peaks and memory rate (NVIDIA's data sheet).
PEAK_FLOPS = {"bf16": 989.4e12, "f32": 66.9e12}
MEM_BYTES_PER_S = 3.35e12
ITEMSIZE = {"bf16": 2, "f32": 4}

# CGCNN at the JAX package's production width (CGCNNConfig: 93 -> 64, 41
# Gaussian centres, 50 atoms x 12 neighbours, hidden 128) and the
# train_cgcnn CLI's batch: 320 synthetic structures = 256 train (8 steps) +
# 64 val (2 batches) per epoch, one checkpoint per synthetic property.
CGCNN_SYNTHETIC, CGCNN_BATCH, CGCNN_EPOCHS = 320, 32, 2
CGCNN_PROPS = {"formation_energy_per_atom": "formation_energy", "band_gap": "band_gap"}

# Evaluate on the first EVAL_SAMPLES parents of the synthetic build: a
# validation split of 9 at batch 10, so the id list is padded by one.
EVAL_SAMPLES, EVAL_BATCH = 45, 10
# interpolate: steps per strip (the CLI's default); view: samples per run;
# the plots phase's U-Net run: parents (80 train = 8 steps, 20 val = 2
# batches); the profiling phase: steps per StepTimer run
INTERPS, VIEW_N, PLOTS_UNET_SAMPLES, PROFILE_STEPS = 10, 3, 100, 12
# the generate-cgcnn phase's cell scale and occupancy threshold (see there)
COORD_SCALE, CGCNN_OCCUPANCY, CGCNN_MERGE = 12.0, 0.9999, 1.5

FOLDED = ("affine_leaky", "relu_affine", "affine_relu")
# (name, source, TPU kernel it replaces, rows it covers)
KERNEL_ENTRIES = [
    ("conv3d_same[bias]", "icsg3d_torch/csrc/conv3d.cu",
     "icsg3d_tpu/ops/lowc_conv.py:110", lambda r: r["pass"] == "fwd"
     and r["epilogue"] == "bias"),
    ("conv3d_same[folded_bn]", "icsg3d_torch/csrc/conv3d.cu",
     "icsg3d_tpu/ops/pallas_conv.py:39", lambda r: r["pass"] == "fwd"
     and r["epilogue"] in FOLDED),
    ("conv3d_same[dx]", "icsg3d_torch/csrc/conv3d.cu",
     "icsg3d_tpu/ops/lowc_conv.py:549", lambda r: r["pass"] == "dx"),
    ("conv3d_dw", "icsg3d_torch/csrc/conv3d_dw.cu",
     "icsg3d_tpu/ops/lowc_conv.py:289", lambda r: r["pass"] == "dw"),
    ("voxelize", "icsg3d_torch/csrc/voxelize.cu",
     "icsg3d_tpu/ops/pallas_voxelize.py:41", lambda r: r["pass"] == "vox"),
    ("conv3d_same[valid]", "icsg3d_torch/csrc/conv3d.cu",
     "icsg3d_tpu/ops/lowc_conv.py:586", lambda r: r["pass"] == "fwd_valid"),
    ("conv3d_same[dx_valid]", "icsg3d_torch/csrc/conv3d.cu",
     "icsg3d_tpu/ops/lowc_conv.py:615", lambda r: r["pass"] == "dx_valid"),
    ("conv3d_dw[valid]", "icsg3d_torch/csrc/conv3d_dw.cu",
     "icsg3d_tpu/ops/lowc_conv.py:624", lambda r: r["pass"] == "dw_valid"),
    # the extraction's two lax.while_loops (no Pallas counterpart)
    ("extract_cc", "icsg3d_torch/csrc/extract.cu",
     "icsg3d_tpu/ops/extract.py:104", lambda r: r["pass"] == "cc"),
    ("extract_bfs", "icsg3d_torch/csrc/extract.cu",
     "icsg3d_tpu/ops/extract.py:221", lambda r: r["pass"] == "bfs"),
]

# the extraction kernels' phase: bench.py's fused generation batch; the
# no-sync probe's sleep ahead of extract_atoms (~0.5 s at H100 clocks)
EXTRACT_BATCH, SYNC_PROBE_CYCLES = 128, 1_000_000_000

# 3x3x3 convs per generation run: the encoder once (4 blocks + Conv_4),
# then per batch the decoder (4 blocks + output head) and the U-Net (14).
ENCODER_CONVS, DECODER_CONVS, UNET_CONVS = 5, 5, 14


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def sync() -> None:
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def cuda_median_ms(fn, runs: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device 0: {name}; count {torch.cuda.device_count()}")
    print(card)
    return name, card


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from icsg3d_torch.kernels import conv3d as k
    from icsg3d_torch.kernels import conv3d_dw as kdw
    from icsg3d_torch.kernels import extract as kext
    from icsg3d_torch.kernels import voxelize as kv

    t0 = time.perf_counter()
    mods = (k, kdw, kv, kext)
    with ThreadPoolExecutor(len(mods)) as pool:  # one nvcc per source, at once
        libs = list(pool.map(lambda m: m.load(), mods))
    print(f"[build] {', '.join(os.path.basename(lib._name) for lib in libs)} in "
          f"{time.perf_counter() - t0:.2f} s (one nvcc per source, in parallel)")


def bound_ms(pas: str, cin: int, cout: int, edge: int, idt: str, odt: str,
             batch: int, depth=None):
    """The least time the card could take for one conv pass at ``batch``:
    the larger of its FLOPs over the dense peak of its input type and its
    bytes (x read once, the other activation read (dw) or written (fwd,
    dx) once, the weights) over the memory rate.  ``depth`` (VALID modes):
    the output planes of a halo-padded slab of depth + 2 input planes
    (fwd, dw; for dx, the cotangent's planes and depth + 2 planes of dx);
    FLOPs count the products of the output (cotangent) voxels.  Returns
    (ms, "operations" or "bytes")."""
    vox = batch * edge ** 2 * (edge if depth is None else depth)
    xvox = vox if depth is None else batch * edge ** 2 * (depth + 2)
    flops = 2 * vox * 27 * cin * cout
    i, o, w = ITEMSIZE[idt], ITEMSIZE[odt], 27 * cin * cout
    if pas == "fwd":
        nbytes = xvox * cin * i + vox * cout * o + w * i
    elif pas == "dx":
        nbytes = vox * cout * i + xvox * cin * o + w * i
    else:  # dw: x and g read, dW written in f32
        nbytes = xvox * cin * i + vox * cout * i + w * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[idt], nbytes / MEM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def profiled_ms(run, args, keys) -> dict:
    """The device ms of one ``run(*args)`` spent in kernels whose names
    contain each of ``keys``, averaged over three profiled calls.  A
    session that recorded no event of ``keys[0]`` (the launch's own
    kernel: a profiled K2 launch has come back without its kernels'
    events) is profiled again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _attempt in range(3):
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                run(*args)
            sync()
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        if any(keys[0] in e.name for e in dev):
            break
    return {key: sum(e.time_range.elapsed_us() for e in dev if key in e.name) / 3e3
            for key in keys}


def dw_launch_report(run, args, off: int):
    """K2's launch at ``args`` = (x, g): its path (``wgmma+tma``,
    ``wgmma+cp.async`` or the f32 ``fma+slide``), its tile, workspace bytes
    and split count from the launch plan, and the device ms of the main
    kernel and of the second (split-sum) pass, averaged over three profiled
    calls."""
    from icsg3d_torch.kernels import conv3d_dw as kdw

    x, g = args
    info = kdw.describe(tuple(x.shape), tuple(g.shape), x.dtype, off)
    dev = profiled_ms(run, args, ("conv3d_dw", "reduce_splits"))
    info["main_ms"], info["split_ms"] = dev["conv3d_dw"], dev["reduce_splits"]
    return info


def dw_row_note(info: dict, ms: float, bms: float) -> str:
    """The K2 columns of a dW row: path (the f32 ``fma+slide`` with its
    tile: input x output channels per block, g rows per chunk), bound
    share, the profiled device ms (both passes) and its bound share,
    workspace MB, the split pass's device ms and its share of the profiled
    launch."""
    total = info["main_ms"] + info["split_ms"]
    tile = (f" ci{info['ci_t']} co{info['ct']} r{info['rows']}"
            if info["path"] == "fma+slide" else "")
    return (f"  {info['path']}{tile:14s} bound/kernel {bms / ms:5.3f} device "
            f"{total:.4f} ms (bound/device {bms / max(total, 1e-9):5.3f}) ws "
            f"{info['ws_bytes'] / 2 ** 20:5.1f} MB x{info['splits']:<2d} split pass "
            f"{info['split_ms']:.4f} ms ({info['split_ms'] / max(total, 1e-9):5.1%})")


def conv_row_note(run, args, mode: str, dx: bool, ms: float, bms: float) -> str:
    """The conv3d.cu columns of a forward, dx or VALID row: the path and its
    tile (``wgmma+tma``: N tile, m64 sub-tiles, rows x planes, column
    segments; the f32 ``fma+window``: rows and N channels per block,
    column segments, channels per staged chunk) and
    bound/kernel; for the f32 path also the profiled device ms of
    ``run(*args)`` and its bound share (the event time of such a short
    launch includes the host's launch overhead)."""
    from icsg3d_torch.kernels import conv3d as k

    a, w = args[0], args[1]
    n = w.shape[3] if dx else w.shape[4]
    d = k.describe(tuple(a.shape), n, a.dtype, mode, dx)
    if d["path"] != "fma+window":
        tile = f" n{d['bn']} m{d['mt']} {d['rows']}x{d['nd']} s{d['segments']}"
        return f"  {d['path']}{tile} bound/kernel {bms / ms:5.3f}"
    dev = profiled_ms(run, args, ("conv3d_f32_kernel",))["conv3d_f32_kernel"]
    tile = f" r{d['rows']} n{d['bn']} s{d['segments']} kc{d['kc']}"
    return (f"  {d['path']}{tile} bound/kernel {bms / ms:5.3f} device {dev:.4f} ms "
            f"(bound/device {bms / max(dev, 1e-9):5.3f})")


def pass_summary(mine) -> str:
    """A pass's sums: kernel, plain, library and bound ms, kernel/library
    and kernel/bound."""
    k, pl, lib, b = (sum(r[key] for r in mine)
                     for key in ("ms", "plain_ms", "library_ms", "bound_ms"))
    return (f"kernel {k:.3f} ms, plain {pl:.3f} ms, library {lib:.3f} ms, bound "
            f"{b:.3f} ms; kernel/library {k / lib:.3f}, kernel/bound {k / b:.2f}")


def phase_kernels(card: str, shapes, batch: int):
    import torch
    import torch.nn.functional as F

    from icsg3d_torch.kernels import conv3d as k

    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    print(f"[kernels] batch {batch}, card: {card}")
    print("  model        Cin->Cout @edge  epilogue      out   max_abs_err  "
          "rel_err   kernel_ms  plain_ms  cudnn_ms  bound_ms")
    for model, cin, cout, edge, epi, idt, odt in shapes:
        x = torch.randn(batch, edge, edge, edge, cin, device="cuda",
                        generator=gen).to(dt[idt])
        w = (torch.randn(3, 3, 3, cin, cout, device="cuda", generator=gen)
             / (27 * cin) ** 0.5).to(dt[idt])
        b, scale, shift = (
            0.1 * torch.randn(cout, device="cuda", generator=gen) for _ in range(3)
        )
        scale = scale + 1.0
        args = (x, w, b, scale, shift, epi, dt[odt])
        got = k.conv3d_same_cuda(*args)
        torch.cuda.synchronize()
        ref = k.conv3d_same_reference(*args)
        abs_err = float((got.float() - ref.float()).abs().max())
        rel_err = abs_err / max(float(ref.float().abs().max()), 1e-30)
        bound = 1e-2 if odt == "bf16" else 1e-4
        check(got.shape == ref.shape and got.dtype == dt[odt],
              f"{model} {cin}->{cout}@{edge}: shape/dtype {got.shape} {got.dtype}")
        check(bool(torch.isfinite(got.float()).all()),
              f"{model} {cin}->{cout}@{edge}: non-finite output")
        check(rel_err <= bound, f"{model} {cin}->{cout}@{edge} {epi}: "
              f"rel err {rel_err:.3e} > {bound:g}")
        check(torch.equal(got, k.conv3d_same_cuda(*args)),
              f"{model} {cin}->{cout}@{edge}: a second launch gave other bits")
        ms = cuda_median_ms(lambda: k.conv3d_same_cuda(*args))
        plain_ms = cuda_median_ms(lambda: k.conv3d_same_reference(*args))
        xc = x.permute(0, 4, 1, 2, 3)  # channels_last_3d view, no copy
        wc = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)

        def cudnn():
            y = F.conv3d(xc, wc, padding=1).permute(0, 2, 3, 4, 1)
            return k.apply_epilogue(y.float() + b, epi, scale, shift).to(dt[odt])

        cudnn_ms = cuda_median_ms(cudnn)
        bms, bby = bound_ms("fwd", cin, cout, edge, idt, odt, batch)
        print(f"  {model:12s} {cin:4d}->{cout:<4d}@{edge:<3d} {epi:13s} {odt:4s} "
              f"{abs_err:11.3e} {rel_err:9.2e} {ms:10.4f} {plain_ms:9.4f} "
              f"{cudnn_ms:9.4f} {bms:9.4f} {bby}"
              f"{conv_row_note(k.conv3d_same_cuda, args, 'same', False, ms, bms)}")
        rows.append(dict(model=model, cin=cin, cout=cout, edge=edge, epilogue=epi,
                         batch=batch, abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                         library_ms=cudnn_ms, bound_ms=bms, bound_by=bby,
                         **{"pass": "fwd"}))
    print(f"  total over the shapes: {pass_summary(rows)}")
    del x, w, got, ref
    torch.cuda.empty_cache()
    return rows


def phase_backward_kernels(card: str, sets):
    """K1 as dx and K2 at the shapes of ``sets``: (pass, shapes, batch) --
    the 18 input-gradient and 10 weight-gradient shapes of a VAE train step
    at batch BATCH, the 14 U-Net weight gradients and the U-Net's 5 new
    input-gradient shapes at batch UNET_BATCH."""
    import torch

    from icsg3d_torch.kernels import conv3d as k
    from icsg3d_torch.kernels import conv3d_dw as kdw

    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    rows = []
    print(f"[backward-kernels] card: {card}")
    print("  pass conv          batch fwd Cin->Cout @edge type  max_abs_err  rel_err  "
          "bound    kernel_ms  plain_ms  library_ms  bound_ms")
    for pas, shapes, batch in sets:
        mine = []
        for name, cin, cout, edge, idt in shapes:
            t = dt[idt]
            shape = (batch, edge, edge, edge)
            g = torch.randn(*shape, cout, device="cuda", generator=gen).to(t)
            if pas == "dx":
                w = (torch.randn(3, 3, 3, cin, cout, device="cuda", generator=gen)
                     / (27 * cout) ** 0.5).to(t)
                args, run, plain = (g, w), k.conv3d_dx_cuda, k.conv3d_dx_reference
                wc = w.permute(4, 3, 0, 1, 2).contiguous(
                    memory_format=torch.channels_last_3d)
                gc = g.permute(0, 4, 1, 2, 3)  # channels_last_3d view, no copy

                def library():
                    return torch.nn.grad.conv3d_input(
                        (batch, cin, edge, edge, edge), wc, gc, padding=1)
            else:
                x = torch.randn(*shape, cin, device="cuda", generator=gen).to(t)
                args, run, plain = (x, g), kdw.conv3d_dw_cuda, kdw.conv3d_dw_reference
                xc, gc = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)

                def library():
                    return torch.nn.grad.conv3d_weight(
                        xc, (cout, cin, 3, 3, 3), gc, padding=1)
            got = run(*args)
            torch.cuda.synchronize()
            ref = plain(*args)
            abs_err = float((got.float() - ref.float()).abs().max())
            rel_err = abs_err / max(float(ref.float().abs().max()), 1e-30)
            bound = 1e-3 if pas == "dw" else (1e-2 if idt == "bf16" else 1e-4)
            check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
                  f"{pas} {name}: shape {tuple(got.shape)} or non-finite output")
            check(rel_err <= bound, f"{pas} {name} {cin}->{cout}@{edge}: rel err "
                  f"{rel_err:.3e} > {bound:g}")
            # no atomics; dW's split sum runs in a fixed order: the same bits again
            check(torch.equal(got, run(*args)), f"{pas} {name}: a second launch "
                  "gave other bits")
            ms = cuda_median_ms(lambda: run(*args))
            plain_ms = cuda_median_ms(lambda: plain(*args))
            library_ms = cuda_median_ms(library)
            bms, bby = bound_ms(pas, cin, cout, edge, idt, idt, batch)
            note = (dw_row_note(dw_launch_report(run, args, 0), ms, bms) if pas == "dw"
                    else conv_row_note(run, args, "same", True, ms, bms))
            print(f"  {pas:4s} {name:15s} {batch:3d} {cin:4d}->{cout:<4d}@{edge:<3d} {idt:4s} "
                  f"{abs_err:11.3e} {rel_err:8.2e} {bound:6g} {ms:10.4f} "
                  f"{plain_ms:9.4f} {library_ms:11.4f} {bms:9.4f} {bby}{note}")
            mine.append(dict(model=name, cin=cin, cout=cout, edge=edge, batch=batch,
                             abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bms, bound_by=bby,
                             epilogue=None, **{"pass": pas}))
        rows += mine
        print(f"  {pas} at batch {batch}, {len(mine)} shapes: {pass_summary(mine)}")
    torch.cuda.empty_cache()
    return rows


def write_dataset(path: str):
    """A few Gaussian-blob densities at 32^3 with their coordinate grids."""
    import numpy as np

    from icsg3d_torch.data.store import GridDataset

    rng = np.random.default_rng(SEED)
    n, eps = 4, 0.25
    g = np.mgrid[:D, :D, :D].astype(np.float32)
    density = np.zeros((n, D, D, D), np.float32)
    coords = np.zeros((n, D, D, D, 3), np.float32)
    for i in range(n):
        for c in rng.uniform(6, D - 6, (int(rng.integers(2, 6)), 3)):
            density[i] += np.exp(-((g - c[:, None, None, None]) ** 2).sum(0) / 4.5)
        abc = rng.uniform(3.5, 7.0, 3).astype(np.float32)
        dv = abc * (1 + 2 * eps) / D
        coords[i] = np.moveaxis(g, 0, -1) * dv - eps * abc + dv / 2
    return GridDataset.write(path, [f"syn-{i}" for i in range(n)], {
        "density": density, "coords": coords,
        "target": rng.standard_normal(n).astype(np.float32),
    })


def seeded_models(device):
    """Full-width models from a seed.  The occupancy head is then rescaled
    so that ~30% of voxels of a decoded batch pass the 0.8 threshold:
    with random weights the logits sit in a narrow band and the mask
    would be all-or-nothing, leaving the extraction no work."""
    import numpy as np
    import torch

    from icsg3d_torch.config import GridSpec, UNetConfig, VAEConfig
    from icsg3d_torch.models import ConditionalDFCVAE, UNet3D

    gen = torch.Generator().manual_seed(SEED)
    vae = ConditionalDFCVAE(VAEConfig(grid=GridSpec(d=D)), gen).to(device).eval()
    unet = UNet3D(UNetConfig(), gen).to(device).eval()
    rng = np.random.default_rng(SEED + 1)
    z = torch.from_numpy(rng.standard_normal((BATCH, 256)).astype(np.float32))
    cond = torch.zeros(BATCH, 10)
    cond[:, 3] = 1.0
    with torch.inference_mode():
        _, sig = unet(vae.decode(z.to(device), cond.to(device)))
        logits = sig.double().flatten()
        q = float(torch.quantile(logits, 0.7))
        a = 6.0 / float(logits.std())
    with torch.no_grad():  # logit -> a * (logit - q) + logit(0.8)
        head = unet.head_sig
        head.kernel.mul_(a)
        head.bias.copy_(a * (head.bias - q) + float(np.log(4.0)))
    return vae, unet


def phase_main_path(tmp: str, card: str):
    import numpy as np
    import torch

    from icsg3d_torch.apps import generate
    from icsg3d_torch.kernels import conv3d as k
    from icsg3d_torch.kernels import extract as kext
    from icsg3d_torch.weights import save_npz, to_flax_variables

    write_dataset(os.path.join(tmp, "data"))
    vae, unet = seeded_models(DEVICE)
    save_npz(os.path.join(tmp, "vae.npz"), to_flax_variables(vae))
    save_npz(os.path.join(tmp, "unet.npz"), to_flax_variables(unet))
    n_batches = -(-NSAMPLES // BATCH)
    want = ENCODER_CONVS + n_batches * (DECODER_CONVS + UNET_CONVS)
    results = {}
    for fused in (True, False):
        label = "fused" if fused else "host"
        out = os.path.join(tmp, f"out-{label}")
        argv = ["--data", os.path.join(tmp, "data"), "--base", "syn-1",
                "--vae-ckpt", os.path.join(tmp, "vae.npz"),
                "--unet-ckpt", os.path.join(tmp, "unet.npz"),
                "--nsamples", str(NSAMPLES), "--batch-size", str(BATCH),
                "--device", DEVICE, "--output", out] + (["--fused"] if fused else [])
        sync()
        k.reset_launches()
        kext.reset_launches()
        t0 = time.perf_counter()
        generate.main(argv)
        sync()
        secs = time.perf_counter() - t0
        launches = k.launches
        by_epi = dict(k.launches_by_epilogue)
        ext = {"cc": kext.launches_cc, "bfs": kext.launches_bfs}
        # the fused path extracts on the card: E1 on the foreground and on
        # the erosion cores, E2 once, per batch; the host path never
        want_ext = ({"cc": 2 * n_batches, "bfs": n_batches} if fused
                    else {"cc": 0, "bfs": 0})
        check(ext == want_ext, f"{label}: extraction kernels launched {ext}, "
              f"want {want_ext}")
        with open(os.path.join(out, "results.json")) as f:
            rows = json.load(f)
        check(len(rows) == NSAMPLES, f"{label}: {len(rows)} records, want {NSAMPLES}")
        lat = np.asarray([r["lattice"] for r in rows], np.float64)
        check(lat.shape == (NSAMPLES, 3) and bool(np.isfinite(lat).all()),
              f"{label}: lattice values not finite or misshapen")
        check(launches == want, f"{label}: conv kernel launched {launches} times, "
              f"the path runs {want} 3x3x3 convs")
        n_atoms = sum(len(r.get("atoms", [])) for r in rows)
        n_valid = sum(bool(r.get("valid")) for r in rows)
        n_err = sum("error" in r for r in rows)
        print(f"[main:{label}] {NSAMPLES} samples in {secs:.3f} s = "
              f"{NSAMPLES / secs:.2f} samples/s ({card}); conv launches "
              f"{launches} = {want} expected {by_epi}; extraction launches "
              f"E1 {ext['cc']} E2 {ext['bfs']} = expected; atoms {n_atoms}, "
              f"valid {n_valid}, per-sample errors {n_err}")
        results[label] = dict(seconds=secs, launches=launches, by_epilogue=by_epi,
                              **ext)
    return vae, unet, results


def phase_breakdown(vae, unet, card: str):
    """Device time of one fused batch of 20 by stage (CUDA events), the
    extraction by its own stages; then one extraction under sync-debug
    mode "error", queued behind a long kernel, which must return to the
    host before that kernel ends.  Returns the batch's (species, binary)."""
    import numpy as np
    import torch

    from icsg3d_torch.apps.generate import _decode_segment
    from icsg3d_torch.config import GridSpec, PipelineConfig
    from icsg3d_torch.ops import extract as ex

    pipe = PipelineConfig(grid=GridSpec(d=D))
    rng = np.random.default_rng(SEED + 2)
    z = torch.from_numpy(rng.standard_normal((BATCH, 256)).astype(np.float32)).cuda()
    cond = torch.zeros(BATCH, 10, device="cuda")
    cond[:, 3] = 1.0
    with torch.inference_mode():
        dec_ms = cuda_median_ms(lambda: vae.decode(z, cond), runs=5, warmup=1)
        M = vae.decode(z, cond)
        unet_ms = cuda_median_ms(lambda: unet(M), runs=5, warmup=1)
        _, _, _, labels, binary = _decode_segment(vae, unet, pipe, z, cond)
        spec = torch.where(binary > 0, labels, 0)
        ext_ms = cuda_median_ms(
            lambda: ex.extract_atoms(spec, binary, max_atoms=64, vote_classes=95))
        # the stages of extract_atoms, each on what the one before gave
        fg = binary > 0
        spec_i = torch.where(fg, spec.to(torch.int32), 0)
        lab = ex.connected_components_same_value(fg.to(torch.int32))
        er = ex.erode6(fg)
        cores = ex.connected_components_same_value(er.to(torch.int32))
        seed, seed_labels = ex.erosion_split_seeds(lab, cores, fg)
        regions = ex.nearest_seed_labels(seed, lab, fg, seed_labels)
        stages = {
            "E1 foreground": lambda: ex.connected_components_same_value(
                fg.to(torch.int32)),
            "erosion": lambda: ex.erode6(fg),
            "E1 cores": lambda: ex.connected_components_same_value(er.to(torch.int32)),
            "seeds": lambda: ex.erosion_split_seeds(lab, cores, fg),
            "E2": lambda: ex.nearest_seed_labels(seed, lab, fg, seed_labels),
            "region ranking and votes": lambda: ex.atoms_from_regions(
                regions, spec_i, fg, 64, 4, 95),
        }
        stage_ms = {name: cuda_median_ms(fn) for name, fn in stages.items()}
        # no host synchronisation: sync-debug mode raises on one, and the
        # host must get past the extraction while the sleep still runs
        want = ex.extract_atoms(spec, binary, max_atoms=64, vote_classes=95)
        sync()
        done = torch.cuda.Event()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            torch.cuda._sleep(SYNC_PROBE_CYCLES)
            got = ex.extract_atoms(spec, binary, max_atoms=64, vote_classes=95)
            done.record()
            ahead = not done.query()
        except RuntimeError as err:
            fail(f"extract_atoms synchronised with the host: {err}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        host_ms = 1e3 * (time.perf_counter() - t0)
        sync()
        check(ahead, "extract_atoms returned only after the kernel queued before it")
        for a, b in zip(got, want):
            check(torch.equal(a, b), "extract_atoms under sync-debug mode differs")
    split = ", ".join(f"{name} {ms:.3f}" for name, ms in stage_ms.items())
    print(f"[breakdown] fused batch of {BATCH} ({card}): decode {dec_ms:.3f} ms, "
          f"U-Net {unet_ms:.3f} ms, extraction {ext_ms:.3f} ms "
          f"(foreground {float(binary.float().mean()):.3f}); extraction by stage "
          f"(ms): {split}")
    print(f"[breakdown] extract_atoms at batch {BATCH} under sync-debug mode "
          f"\"error\": no host synchronisation; it returned after {host_ms:.3f} ms "
          f"of host time, before the {SYNC_PROBE_CYCLES:.0e}-cycle kernel queued "
          f"ahead of it ended")
    return spec, binary


def phase_extract_kernels(vae, unet, card: str, spec20, binary20):
    """E1 and E2 against their plain versions on the card, on the same
    operands: outputs bitwise equal, E2's largest per-sample round count
    the plain version's, no sample at the round cap.  Operands: the
    breakdown's decoded, segmented batch of 20 (E1 on the foreground and
    the erosion cores, E2 on the split's seeds), a batch of 128 decoded in
    chunks of 20, 4 of the batch's masks at 64^3 (each voxel doubled along
    each axis): their rows' times make the kernels line's sums.  Then, with
    their errors in the kernels line and their times out of it: batch 1
    and 4 at 32^3, one mask at 64^3, one at 96^3 (tripled; the plan keeps
    its state in device memory), and the adversarial grids of
    tests/test_torch_extract_plan.py at D^3 (empty, full from two corners,
    the one-voxel-wide snake from one end, a multi-valued grid, two seeds
    equidistant from a box's middle plane) and its non-cubic blob grid.
    Each row: the plan (``kernels/extract.launch_plan``: CTAs per sample,
    path, and the clusters of that size the card runs at once), CUDA-event
    medians of kernel and plain, the bound (the bytes read or written once
    over 3.35 TB/s: 8 per voxel for E1, 14 for E2 with seed labels, 10
    without), its share, E1's merge passes or E2's rounds beside the
    plain version's rounds; library none (no one PyTorch call computes
    either function)."""
    import numpy as np
    import torch

    from icsg3d_torch.apps.generate import _decode_segment
    from icsg3d_torch.config import GridSpec, PipelineConfig
    from icsg3d_torch.kernels import extract as kext
    from icsg3d_torch.ops import extract as ex

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from test_torch_extract_plan import adversarial, bfs_operands

    pipe = PipelineConfig(grid=GridSpec(d=D))
    rng = np.random.default_rng(SEED + 5)
    chunks = []
    with torch.inference_mode():
        for _ in range(-(-EXTRACT_BATCH // BATCH)):
            z = torch.from_numpy(rng.standard_normal((BATCH, 256)).astype(np.float32))
            cond = torch.zeros(BATCH, 10)
            cond[:, 3] = 1.0
            chunks.append(_decode_segment(vae, unet, pipe, z.cuda(), cond.cuda())[4])
    fg128 = torch.cat(chunks)[:EXTRACT_BATCH] > 0
    fg20 = binary20 > 0

    def scaled(fg, k):  # each voxel repeated k times along each axis
        for dim in (1, 2, 3):
            fg = fg.repeat_interleave(k, dim=dim)
        return fg.contiguous()

    sets = {f"batch {BATCH}": fg20, f"batch {EXTRACT_BATCH}": fg128,
            f"4 x {2 * D}^3": scaled(fg20[:4], 2)}
    more = {"batch 1": fg20[:1].contiguous(), "batch 4": fg20[:4].contiguous(),
            f"1 x {2 * D}^3": scaled(fg20[:1], 2), f"1 x {3 * D}^3": scaled(fg20[:1], 3)}

    rows, checked = [], []

    def row(kind, what, grid, per_voxel, fn, plain, timed, slow=False):
        """Time and compare one kernel call with its plain version."""
        got, rounds = fn()
        want, want_rounds = plain()
        sync()
        check(torch.equal(got, want), f"{kind} {what}: the kernel's labels differ "
              f"from the plain version's in {int((got != want).sum())} voxels")
        r_max, r_min = int(rounds.max()), int(rounds.min())
        check(r_min >= 1, f"{kind} {what}: a sample hit the kernel's round cap")
        if kind == "E2":
            check(r_max == want_rounds, f"E2 {what}: the kernel's rounds {r_max}, "
                  f"the plain version's {want_rounds}")
        ms = cuda_median_ms(fn)
        plain_ms = cuda_median_ms(plain, runs=1 if slow else 3, warmup=0 if slow else 1)
        bms = 1e3 * grid.numel() * per_voxel / MEM_BYTES_PER_S
        name = "cc" if kind == "E1" else "bfs"
        p = kext.launch_plan(name, grid)
        n_vox = grid[0].numel()
        active = kext.max_active_clusters(name, n_vox, grid.device)(
            p.cluster, p.smem_bytes_per_cta, p.path)
        count = "merge passes" if kind == "E1" else "rounds"
        print(f"[extract-kernels] {kind} {what} ({card}): C={p.cluster} {p.path} "
              f"({p.smem_bytes_per_cta} B/CTA, {active} such clusters at once); kernel "
              f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bms:.5f} ms bytes (share "
              f"{bms / ms:.4f}); {count} kernel {r_max} (least sample {r_min}), plain "
              f"rounds {want_rounds}; bitwise equal; library none")
        (rows if timed else checked).append({
            "pass": name, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": "bytes", "library_ms": None, "abs_err": 0.0})

    def e1(what, sp, timed=True, slow=False):
        # int32 in, int32 out
        row("E1", what, sp, 8, lambda: kext.connected_components_cuda(sp),
            lambda: ex.connected_components_reference(sp, return_rounds=True), timed, slow)

    def e2(what, seeds, cc, fg, seed_labels, timed=True, slow=False):
        # seeds and fg a byte each, cc (and seed labels) int32 in, int32 out
        row("E2", what, cc, 10 if seed_labels is None else 14,
            lambda: kext.nearest_seed_labels_cuda(seeds, cc, fg, seed_labels),
            lambda: ex.nearest_seed_labels_reference(seeds, cc, fg, seed_labels,
                                                     return_rounds=True), timed, slow)

    with torch.inference_mode():
        for timed, group in ((True, sets), (False, more)):
            for name, fg in group.items():
                shape = "x".join(str(s) for s in fg.shape)
                fgi = fg.to(torch.int32)
                core_i = ex.erode6(fg).to(torch.int32)
                e1(f"foreground {name} ({shape})", fgi, timed)
                e1(f"erosion cores {name}", core_i, timed)
                lab = ex.connected_components_reference(fgi)
                cores = ex.connected_components_reference(core_i)
                seed, seed_labels = ex.erosion_split_seeds(lab, cores, fg)
                e2(f"split seeds {name}", seed, lab, fg, seed_labels, timed)
        for name, (grid, seeds) in adversarial(D).items():
            what = f"{name} (1x{'x'.join(str(s) for s in grid.shape)})"
            grid = torch.from_numpy(grid[None]).cuda()
            seeds = None if seeds is None else torch.from_numpy(seeds[None]).cuda()
            slow = name == "snake"
            e1(what, grid, False, slow)
            e2(what, *bfs_operands(grid, seeds), timed=False, slow=slow)
    return rows, checked


def phase_cpu_parity(vae, unet):
    import numpy as np
    import torch

    from icsg3d_torch.apps.generate import _decode_segment
    from icsg3d_torch.config import GridSpec, PipelineConfig
    from icsg3d_torch.ops.extract import extract_atoms

    pipe = PipelineConfig(grid=GridSpec(d=D))
    rng = np.random.default_rng(SEED + 3)
    z = rng.standard_normal((2, 256)).astype(np.float32)
    cond = np.zeros((2, 10), np.float32)
    cond[:, 3] = 1.0
    out, grids = {}, {}
    t0 = time.perf_counter()
    for dev, (v, u) in ((DEVICE, (vae, unet)),
                        ("cpu", (copy.deepcopy(vae).cpu(), copy.deepcopy(unet).cpu()))):
        with torch.inference_mode():
            zt, ct = torch.from_numpy(z).to(dev), torch.from_numpy(cond).to(dev)
            M, lattice, dv, labels, binary = _decode_segment(v, u, pipe, zt, ct)
            spec = torch.where(binary > 0, labels, 0)
            atoms, mu, valid = extract_atoms(spec, binary, max_atoms=64,
                                             vote_classes=95)
        grids[dev] = (spec, binary)
        out[dev] = {n: t.cpu().numpy() for n, t in dict(
            lattice=lattice, labels=labels, binary=binary, atoms=atoms, mu=mu,
            valid=valid).items()}
    g, c = out[DEVICE], out["cpu"]
    lat_rel = float(np.max(np.abs(g["lattice"] - c["lattice"]) / np.abs(c["lattice"])))
    check(lat_rel <= 1e-2, f"GPU vs CPU lattice rel err {lat_rel:.3e} > 1e-2")
    mask_agree = 0
    for i in range(2):
        if np.array_equal(g["binary"][i], c["binary"][i]):
            mask_agree += 1
            check(np.array_equal(g["valid"][i], c["valid"][i])
                  and np.allclose(g["mu"][i], c["mu"][i], atol=1e-5),
                  f"sample {i}: masks agree, extracted atoms differ")
    # the extraction itself on identical masks: the CPU's grids through the
    # card's kernels (E1 twice, E2 once) against the CPU's plain versions
    from icsg3d_torch.kernels import extract as kext

    before = (kext.launches_cc, kext.launches_bfs)
    with torch.inference_mode():
        same = extract_atoms(*(t.to(DEVICE) for t in grids["cpu"]),
                             max_atoms=64, vote_classes=95)
    check((kext.launches_cc - before[0], kext.launches_bfs - before[1]) == (2, 1),
          "the card's extraction of the CPU's masks did not run E1 twice and E2 once")
    for name, a, b in zip(("atoms", "mu", "valid"), same,
                          (c["atoms"], c["mu"], c["valid"])):
        ok = (np.allclose(a.cpu().numpy(), b, atol=1e-5) if name == "mu"
              else np.array_equal(a.cpu().numpy(), b))
        check(ok, f"extraction of the same masks differs on {DEVICE}: {name}")
    mismatch = [int((g["binary"][i] != c["binary"][i]).sum()) for i in range(2)]
    print(f"[gpu-vs-cpu] batch 2 in {time.perf_counter() - t0:.1f} s: lattice max "
          f"rel err {lat_rel:.2e}; masks agree on {mask_agree}/2 samples (voxels "
          f"differing {mismatch} of {D ** 3}); extraction of identical masks: "
          f"{int(c['valid'].sum())} atoms, equal on {DEVICE} (E1, E2) and cpu "
          f"(plain versions); valid atoms "
          f"from own masks gpu {int(g['valid'].sum())} cpu {int(c['valid'].sum())}")


def write_train_dataset(path: str, n: int = None):
    """``n`` (default TRAIN_PARENTS) Gaussian-blob densities at 32^3 with
    lattice lengths (so ``--nrot 0`` rebuilds the coordinate channels on
    the card) and the matching coordinate grids (which generate reads)."""
    import numpy as np

    from icsg3d_torch.data.store import GridDataset

    rng = np.random.default_rng(SEED + 4)
    n, eps = n or TRAIN_PARENTS, 0.25
    g = np.mgrid[:D, :D, :D].astype(np.float32)
    density = np.zeros((n, D, D, D), np.float32)
    for i in range(n):
        for c in rng.uniform(6, D - 6, (int(rng.integers(2, 6)), 3)):
            density[i] += np.exp(-((g - c[:, None, None, None]) ** 2).sum(0) / 4.5)
    abc = rng.uniform(3.5, 7.0, (n, 3)).astype(np.float32)
    dv = abc * (1 + 2 * eps) / D
    coords = np.moveaxis(g, 0, -1)[None] * dv[:, None, None, None, :]
    lattice = np.concatenate([abc, np.full((n, 3), 90.0, np.float32)], axis=1)
    return GridDataset.write(path, [f"par-{i}" for i in range(n)], {
        "density": density, "coords": coords.astype(np.float32),
        "lattice": lattice, "target": rng.standard_normal(n).astype(np.float32),
    })


def reset_counts() -> None:
    from icsg3d_torch.kernels import conv3d as k
    from icsg3d_torch.kernels import conv3d_dw as kdw
    from icsg3d_torch.kernels import extract as kext
    from icsg3d_torch.kernels import voxelize as kv

    k.reset_launches()
    kdw.reset_launches()
    kv.reset_launches()
    kext.reset_launches()


def read_counts() -> dict:
    from icsg3d_torch.kernels import conv3d as k
    from icsg3d_torch.kernels import conv3d_dw as kdw
    from icsg3d_torch.kernels import extract as kext
    from icsg3d_torch.kernels import voxelize as kv

    by, byv = dict(k.launches_by_epilogue), dict(k.launches_valid_by_epilogue)
    return {"fwd": k.launches, "bias": by["bias"],
            "folded": sum(by[e] for e in FOLDED), "dx": k.launches_dx,
            "dw": kdw.launches, "vox": kv.launches,
            "fwd_valid": k.launches_valid, "valid_folded": sum(byv[e] for e in FOLDED),
            "dx_valid": k.launches_dx_valid, "dw_valid": kdw.launches_valid,
            "cc": kext.launches_cc, "bfs": kext.launches_bfs}


# read_counts() of a run that launched nothing
NO_LAUNCHES = {key: 0 for key in ("fwd", "bias", "folded", "dx", "dw", "vox",
                                  "fwd_valid", "valid_folded", "dx_valid", "dw_valid",
                                  "cc", "bfs")}


def phase_train(tmp: str, card: str):
    """``apps.train_vae.main`` at production width, then ``apps.generate``
    from the checkpoint directory it wrote."""
    import numpy as np

    from icsg3d_torch.apps import generate, train_vae

    data = os.path.join(tmp, "train-data")
    write_train_dataset(data)
    ckpt = os.path.join(tmp, "vae-ckpt")
    unet_npz = os.path.join(tmp, "unet.npz")
    argv = ["--data", data, "--unet-ckpt", unet_npz, "--epochs", str(TRAIN_EPOCHS),
            "--batch-size", str(BATCH), "--nrot", "0", "--device", DEVICE,
            "--ckpt", ckpt, "--seed", str(SEED)]
    sync()
    reset_counts()
    t0 = time.perf_counter()
    hist = train_vae.main(argv)
    sync()
    secs = time.perf_counter() - t0
    counts = read_counts()
    n_train = int(0.8 * TRAIN_PARENTS) // BATCH
    n_val = (TRAIN_PARENTS - int(0.8 * TRAIN_PARENTS)) // BATCH
    check(len(hist) == TRAIN_EPOCHS, f"train: {len(hist)} epochs of history")
    for e, h in enumerate(hist):
        check(h["steps"] == n_train, f"train epoch {e}: {h['steps']} steps")
        for split in ("train", "val"):
            check(all(np.isfinite(v) for v in h[split].values()),
                  f"train epoch {e}: non-finite {split} metrics {h[split]}")
    with open(os.path.join(ckpt, "history.json")) as f:
        check(len(json.load(f)) == TRAIN_EPOCHS, "history.json is incomplete")
    want = {"fwd": TRAIN_EPOCHS * (n_train + n_val) * FWD_PER_STEP,
            "dx": TRAIN_EPOCHS * n_train * DX_PER_STEP,
            "dw": TRAIN_EPOCHS * n_train * DW_PER_STEP}
    for key, n in want.items():
        check(counts[key] == n, f"train: {key} launches {counts[key]}, want {n} "
              f"({TRAIN_EPOCHS} epochs x ({n_train} train + {n_val} eval) steps)")
    losses = [round(h["train"]["loss"], 4) for h in hist]
    print(f"[train] train_vae.main: {TRAIN_EPOCHS} epochs x {n_train} steps + "
          f"{n_val} val batch at batch {BATCH} in {secs:.3f} s ({card}); epoch "
          f"times {[round(h['time'], 3) for h in hist]} s; train loss {losses}; "
          f"launches {counts} = {want} expected")

    out = os.path.join(tmp, "gen-trained")
    sync()
    reset_counts()
    generate.main(["--data", data, "--base", "par-0", "--vae-ckpt", ckpt,
                   "--unet-ckpt", unet_npz, "--nsamples", str(BATCH),
                   "--batch-size", str(BATCH), "--device", DEVICE, "--fused",
                   "--output", out])
    sync()
    gen_counts = read_counts()
    with open(os.path.join(out, "results.json")) as f:
        rows = json.load(f)
    lat = np.asarray([r["lattice"] for r in rows], np.float64)
    check(len(rows) == BATCH and bool(np.isfinite(lat).all()),
          f"generate from the trained checkpoint: {len(rows)} records")
    want_gen = ENCODER_CONVS + DECODER_CONVS + UNET_CONVS
    check(gen_counts["fwd"] == want_gen,
          f"generate from the trained checkpoint: {gen_counts['fwd']} launches")
    check((gen_counts["cc"], gen_counts["bfs"]) == (2, 1),
          f"generate from the trained checkpoint: extraction launches E1 "
          f"{gen_counts['cc']} E2 {gen_counts['bfs']}, want 2 and 1")
    print(f"[train] generate --fused from {os.path.basename(ckpt)}/best.npz: "
          f"{len(rows)} records, {sum(bool(r.get('valid')) for r in rows)} valid; "
          f"conv launches {gen_counts['fwd']}, E1 2, E2 1")
    # the training's launches and the generation's extraction
    return {**counts, "cc": gen_counts["cc"], "bfs": gen_counts["bfs"]}


def phase_train_step(tmp: str, unet, card: str):
    """One train and one eval step alone (launch counts), then the train
    step's time by stage, and one profiled step."""
    import numpy as np
    import torch

    from icsg3d_torch.config import GridSpec, VAEConfig
    from icsg3d_torch.data.store import GridDataset
    from icsg3d_torch.models.unet import unet_features
    from icsg3d_torch.ops import losses
    from icsg3d_torch.train.vae import _assemble_x, create_vae_state, make_vae_steps

    cfg = VAEConfig(grid=GridSpec(d=D))
    state = create_vae_state(cfg, 5e-4, SEED, DEVICE)
    model, opt = state.model, state.optimizer
    train_step, eval_step = make_vae_steps(model, unet)
    ds = GridDataset(os.path.join(tmp, "train-data"))
    cond = np.zeros((BATCH, cfg.cond_bins), np.float32)
    cond[np.arange(BATCH), np.arange(BATCH) % cfg.cond_bins] = 1.0
    batch = {
        "density": torch.from_numpy(np.array(ds.arrays["density"][:BATCH])),
        "abc": torch.from_numpy(np.array(ds.arrays["lattice"][:BATCH, :3])),
        "cond": torch.from_numpy(cond),
    }
    batch = {k: v.to(DEVICE) for k, v in batch.items()}
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    eps = torch.randn(BATCH, cfg.latent_dim, generator=gen, device=DEVICE)

    for label, step, want in (
        ("train", train_step, {**NO_LAUNCHES, "fwd": FWD_PER_STEP,
                               "bias": FWD_PER_STEP, "dx": DX_PER_STEP,
                               "dw": DW_PER_STEP}),
        ("eval", eval_step, {**NO_LAUNCHES, "fwd": FWD_PER_STEP,
                             "bias": 1 + 2 * len(UNET_PREFIX),
                             "folded": len(VAE_CONVS) - 1}),
    ):
        sync()
        reset_counts()
        mets = step(state, batch, eps)
        sync()
        got = read_counts()
        check(got == want, f"one {label} step launched {got}, want {want}")
        check(all(bool(torch.isfinite(v)) for v in mets.values()),
              f"one {label} step: non-finite metrics")
        print(f"[train-step] one {label} step: launches {got}")

    taps = cfg.perceptual_taps

    def staged():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        x = _assemble_x(batch, cfg.grid)
        recon, z_mean, z_log_var, _ = model(x, batch["cond"], eps, train=True)
        ev[1].record()
        with torch.no_grad():
            f_true = unet_features(unet, x, taps)
        f_pred = unet_features(unet, recon, taps)
        pm = losses.perceptual_feature_loss(f_true, f_pred, cfg.perceptual_tap_weights)
        total = torch.mean(losses.mse_flat(x, recon) + cfg.alpha * pm
                           + cfg.beta * losses.kld_gaussian(z_mean, z_log_var))
        ev[2].record()
        total.backward()
        ev[3].record()
        opt.step()
        ev[4].record()
        ev[4].synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]

    for _ in range(2):
        staged()
    runs = [staged() for _ in range(5)]
    stage = [statistics.median(r[i] for r in runs) for i in range(4)]
    step_ms = cuda_median_ms(lambda: train_step(state, batch, eps), runs=5, warmup=1)
    eval_ms = cuda_median_ms(lambda: eval_step(state, batch, eps), runs=5, warmup=1)
    print(f"[train-step] batch {BATCH} ({card}), CUDA-event medians of 5: VAE "
          f"forward {stage[0]:.3f} ms, perceptual forwards + loss {stage[1]:.3f} ms, "
          f"backward {stage[2]:.3f} ms, Adam {stage[3]:.3f} ms (sum "
          f"{sum(stage):.3f}); train_step {step_ms:.3f} ms = "
          f"{BATCH / step_ms * 1e3:.2f} train grids/s; eval_step {eval_ms:.3f} ms")

    profile_step(lambda: train_step(state, batch, eps), step_ms, "train-profile", card)
    return state, batch, eps


def phase_train_cpu_parity(state, unet, batch, eps):
    """One train step's loss and weight gradients, batch 2, on the card
    (bf16 compute) and on the CPU (f32, plain versions), same weights and
    noise."""
    import copy
    import dataclasses

    import torch

    from icsg3d_torch.models import ConditionalDFCVAE, UNet3D
    from icsg3d_torch.train.vae import _vae_losses

    t0 = time.perf_counter()
    vae_cpu = ConditionalDFCVAE(dataclasses.replace(state.model.cfg, dtype="float32"))
    vae_cpu.load_state_dict(state.model.state_dict())
    unet_cpu = UNet3D(dataclasses.replace(unet.cfg, dtype="float32"))
    unet_cpu.load_state_dict(unet.state_dict())
    unet_cpu.eval().requires_grad_(False)
    names = ("encoder.Conv_0.kernel", "decoder.decoder_output.kernel")
    out = {}
    for dev, vae, u in ((DEVICE, copy.deepcopy(state.model), unet),
                        ("cpu", vae_cpu, unet_cpu)):
        b = {k: v[:2].to(dev) for k, v in batch.items()}
        vae.zero_grad(set_to_none=True)
        total, mets = _vae_losses(vae, u, b, eps[:2].to(dev), train=True)
        total.backward()
        grads = dict(vae.named_parameters())
        out[dev] = ({k: float(v.detach()) for k, v in mets.items()},
                    {n: grads[n].grad.detach().double().cpu().flatten() for n in names})
    (mg, gg), (mc, gc) = out[DEVICE], out["cpu"]
    rel = abs(mg["loss"] - mc["loss"]) / abs(mc["loss"])
    check(rel <= 2e-2, f"train step GPU vs CPU: loss {mg['loss']} vs {mc['loss']} "
          f"(rel {rel:.3e} > 2e-2)")
    cos = {n: float(torch.nn.functional.cosine_similarity(gg[n], gc[n], dim=0))
           for n in names}
    for n, c in cos.items():
        check(c >= 0.95, f"train step GPU vs CPU: grad cosine of {n} {c:.4f} < 0.95")
    print(f"[train-gpu-vs-cpu] batch 2 in {time.perf_counter() - t0:.1f} s: loss "
          f"{mg['loss']:.6f} (card, bf16) vs {mc['loss']:.6f} (cpu, f32), rel "
          f"{rel:.3e}; metrics card {mg} cpu {mc}; weight-gradient cosines {cos}")


def _pack(structures):
    """Pad structures' sites as the dataset build does (frac * abc
    cartesians, sigma = ionic radius, SITE_PAD): (sites, z, sigma, mask,
    abc) numpy float32 stacks."""
    import numpy as np

    from icsg3d_torch.ops.voxelize import pad_sites

    rows = []
    for s in structures:
        N, z, r = s.site_arrays()
        cart = N * np.asarray(s.lattice.abc, np.float64)
        rows.append((*pad_sites(cart, z, r, SITE_PAD),
                     np.array(s.lattice.abc, np.float32)))
    return [np.stack([r[i] for r in rows]) for i in range(5)]


def real_cif_structures():
    """The repo's real CIFs that parse and have 1..MAX_SITES sites (what
    the build keeps), sorted by file name."""
    from icsg3d_torch.crystal.cif import read_cif

    out = []
    for fname in sorted(f for f in os.listdir(REAL_CIFS) if f.endswith(".cif")):
        try:
            s = read_cif(os.path.join(REAL_CIFS, fname))
        except Exception:  # the build skips files that do not parse
            continue
        if 0 < len(s) <= MAX_SITES:
            out.append(s)
    return out


def vox_bound_counts(mask, d: int) -> dict:
    """What K4 must do for these inputs, for its bound: bytes
    (each input read once, the two f32 outputs written once), f32
    operations and exponentials over the real (mask != 0) site-voxel pairs,
    and the same over the padded site count beside them."""
    import numpy as np

    B, S = mask.shape
    nv = d ** 3
    real = int(np.count_nonzero(mask))
    # per pair: cross 5, d2 4 (add, sub, mul, max), exponent argument 1,
    # weight 1, sum 1, sqrt 1, two compares; per voxel: |v|^2 5, scale 1
    per_pair, per_voxel = 15, 6
    return {
        "bytes": 4 * (B * S * 6 + B * 3) + 2 * 4 * B * nv,
        "flops": per_pair * real * nv + per_voxel * B * nv,
        "exps": real * nv,
        "flops_padded": per_pair * B * S * nv + per_voxel * B * nv,
        "exps_padded": B * S * nv,
    }


def species_margins(arrs, d, where, limit=10):
    """For voxels whose species differ: the f64 margin of each to the
    labelling radius of its nearest site and to the tie of its two nearest
    valid sites."""
    import numpy as np
    import torch

    from icsg3d_torch.kernels.voxelize import voxel_axes

    sites, z, sigma, mask, abc = (np.asarray(a, np.float64) for a in arrs)
    ax = voxel_axes(torch.from_numpy(arrs[4]), d, 0.25).double().numpy()
    lines = []
    for b, i, j, k in list(zip(*where))[:limit]:
        v = np.array([ax[b, 0, i], ax[b, 1, j], ax[b, 2, k]])
        valid = mask[b] > 0
        dist = np.linalg.norm(sites[b][valid] - v, axis=1)
        rad = np.maximum(sigma[b][valid], 1e-6)
        srt = np.sort(dist)
        lines.append(f"voxel (b={b}, {i}, {j}, {k}): min |dist - radius| "
                     f"{np.min(np.abs(dist - rad)):.3e}, tie margin "
                     f"{srt[1] - srt[0] if len(srt) > 1 else float('inf'):.3e}")
    return lines


def vox_tie_voxels(args, d: int, label_frac: float = 1.0) -> int:
    """Voxels inside two or more labelling radii (the plain version's
    n_within >= 2, same d2 rounding): those that take K4's tie walk."""
    import torch

    from icsg3d_torch.kernels.voxelize import voxel_axes

    sites, _, sigma, mask, abc = args
    ax = voxel_axes(abc, d, 0.25)
    rad = torch.where(mask > 0, torch.clamp(sigma, min=1e-6) * label_frac,
                      torch.full_like(sigma, -1.0))
    n = 0
    for b in range(sites.shape[0]):
        X, Y, Z = torch.meshgrid(ax[b, 0], ax[b, 1], ax[b, 2], indexing="ij")
        vx, vy, vz = (t.reshape(-1, 1) for t in (X, Y, Z))
        sx, sy, sz = (sites[b, None, :, a] for a in range(3))
        v2 = (vx * vx + vy * vy) + vz * vz
        n2 = (sx * sx + sy * sy) + sz * sz
        d2 = torch.clamp(v2 + n2 - 2.0 * ((vx * sx + vy * sy) + vz * sz), min=0.0)
        n += int(((torch.sqrt(d2) < rad[b, None]).sum(dim=1) >= 2).sum())
    return n


def phase_voxelize_kernel(card: str):
    """K4 against its plain version on one production launch and on the
    real CIFs, with times, the profiled device time of its two kernels, the
    bound and bound share, its thread tile and the voxels of the tie
    walk."""
    import numpy as np
    import torch

    from icsg3d_torch.data.synthetic import random_structures
    from icsg3d_torch.kernels import voxelize as kv

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi clocks failed: {smi.stderr.strip()}")
    clock_hz = float(smi.stdout.strip().splitlines()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    exp_rate = SFU_EXP_PER_SM_CLOCK * sms * clock_hz
    inputs = [
        (f"chunk of {VOX_CHUNK} synthetic",
         random_structures(VOX_CHUNK, seed=SEED + 6, kinds=("perovskite", "rocksalt"))),
        ("real CIFs", real_cif_structures()),
    ]
    rows = []
    qd, tpc, blocks = kv.tile(D)
    print(f"[voxelize-kernel] {D}^3, site_pad {SITE_PAD} ({card}; {sms} SMs, max SM "
          f"clock {clock_hz / 1e6:.0f} MHz, SFU {exp_rate / 1e12:.3f} T exp/s); tile: "
          f"{4 * kv.QUADS_PER_THREAD} k voxels per thread ({kv.QUADS_PER_THREAD} float4 "
          f"per grid), {tpc} threads per column, {blocks} blocks of {kv.THREADS} per "
          f"structure, after a setup kernel of one thread per site")
    for label, structures in inputs:
        arrs = _pack(structures)
        args = [torch.from_numpy(a).cuda() for a in arrs]
        dens, spec = kv.voxelize_cuda(*args, D, 0.25, 1.0)
        torch.cuda.synchronize()
        ref_d, ref_s = kv.voxelize_reference(*args, D, 0.25, 1.0)
        diff = (spec != ref_s).cpu().numpy()
        if diff.any():
            for line in species_margins(arrs, D, np.nonzero(diff)):
                print("  " + line)
        check(not diff.any(), f"K4 {label}: {int(diff.sum())} voxels' species differ "
              "from the plain version")
        abs_err = float((dens - ref_d).abs().max())
        close = bool(torch.allclose(dens, ref_d, rtol=2e-4, atol=1e-6))
        check(close and bool(torch.isfinite(dens).all()),
              f"K4 {label}: density off the plain version by up to {abs_err:.3e}")
        ms = cuda_median_ms(lambda: kv.voxelize_cuda(*args, D, 0.25, 1.0))
        plain_ms = cuda_median_ms(lambda: kv.voxelize_reference(*args, D, 0.25, 1.0),
                                  runs=3, warmup=1)
        n = vox_bound_counts(arrs[3], D)
        t = {"bytes": n["bytes"] / MEM_BYTES_PER_S, "f32": n["flops"] / PEAK_FLOPS["f32"],
             "exp": n["exps"] / exp_rate}
        bby = max(t, key=t.get)
        bms = 1e3 * t[bby]
        pad_ms = 1e3 * max(t["bytes"], n["flops_padded"] / PEAK_FLOPS["f32"],
                           n["exps_padded"] / exp_rate)
        real = int(np.count_nonzero(arrs[3]))
        dev = profiled_ms(lambda *a: kv.voxelize_cuda(*a, D, 0.25, 1.0), args,
                          ("voxelize_kernel", "voxelize_sites"))
        dev_ms = dev["voxelize_kernel"] + dev["voxelize_sites"]
        ties = vox_tie_voxels(args, D)
        print(f"  {label}: {len(structures)} structures, {real} real sites of "
              f"{arrs[3].size} padded; species equal, density max abs err "
              f"{abs_err:.3e} (max {float(ref_d.max()):.3e}); kernel {ms:.4f} ms, "
              f"device {dev_ms:.4f} ms (main {dev['voxelize_kernel']:.4f} + setup "
              f"{dev['voxelize_sites']:.4f}), plain {plain_ms:.4f} ms; bound {bms:.4f} "
              f"ms by {bby} (bytes {1e3 * t['bytes']:.4f}, f32 ops {1e3 * t['f32']:.4f}, "
              f"exp {1e3 * t['exp']:.4f} ms; over the padded sites {pad_ms:.4f} ms); "
              f"bound/device {bms / max(dev_ms, 1e-9):5.3f}, bound/kernel "
              f"{bms / ms:5.3f}; tie walk {ties} of {len(structures) * D ** 3} voxels")
        rows.append(dict(model=label, abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                         library_ms=None, bound_ms=bms,
                         bound_by="bytes" if bby == "bytes" else "operations",
                         **{"pass": "vox"}))
    torch.cuda.empty_cache()
    return rows


def _species_within_z(ds) -> bool:
    import numpy as np

    spec, site_z = np.asarray(ds.arrays["species"]), np.asarray(ds.arrays["site_z"])
    return all(set(np.unique(spec[i]).tolist()) <= {0} | set(site_z[i].tolist())
               for i in range(len(ds)))


def phase_voxelize(tmp: str, card: str):
    """``apps.voxelize.main`` on the real CIFs (card and CPU) and on
    UNET_PARENTS synthetic structures; returns (the synthetic build's path,
    the K4 launches of the card builds)."""
    import math

    import numpy as np

    from icsg3d_torch.apps import voxelize
    from icsg3d_torch.data.store import FIELDS

    builds = [
        ("cifs", ["--cifs", REAL_CIFS, "--targets-csv",
                  os.path.join(REAL_CIFS, "targets.csv"), "--nrot", "2"]),
        ("synthetic", ["--synthetic", str(UNET_PARENTS), "--kinds",
                       "perovskite,rocksalt", "--nrot", "0"]),
    ]
    total = {"vox": 0}
    out = {}
    for label, argv in builds:
        path = os.path.join(tmp, f"vox-{label}")
        sync()
        reset_counts()
        t0 = time.perf_counter()
        ds = voxelize.main(argv + ["--d", str(D), "--out", path, "--device", DEVICE])
        sync()
        secs = time.perf_counter() - t0
        n = read_counts()["vox"]
        kept = sum("_rot_" not in i for i in ds.ids)
        want = math.ceil(kept / VOX_CHUNK)
        check(n == want, f"voxelize {label}: K4 launched {n} times for {kept} "
              f"structures, want {want}")
        check(set(ds.arrays) == set(FIELDS), f"voxelize {label}: fields {sorted(ds.arrays)}")
        check(_species_within_z(ds), f"voxelize {label}: species outside the "
              "structures' atomic numbers")
        total["vox"] += n
        out[label] = (path, ds)
        print(f"[voxelize] {label}: {len(ds)} samples ({kept} structures) in "
              f"{secs:.3f} s ({card}); K4 launches {n} = ceil({kept}/{VOX_CHUNK}); "
              f"species classes {len(np.unique(np.asarray(ds.arrays['species'])))}")
    t0 = time.perf_counter()
    cpu = voxelize.main(builds[0][1] + ["--d", str(D), "--out",
                                        os.path.join(tmp, "vox-cifs-cpu"),
                                        "--device", "cpu"])
    secs = time.perf_counter() - t0
    card_ds = out["cifs"][1]
    check(cpu.ids == card_ds.ids, "voxelize cifs: card and CPU ids differ")
    same = np.array_equal(np.asarray(cpu.arrays["species"]),
                          np.asarray(card_ds.arrays["species"]))
    check(same, "voxelize cifs: card and CPU species differ")
    dc, dg = np.asarray(cpu.arrays["density"]), np.asarray(card_ds.arrays["density"])
    check(np.allclose(dg, dc, rtol=2e-4, atol=1e-6),
          f"voxelize cifs: card and CPU density differ by {np.abs(dg - dc).max():.3e}")
    print(f"[voxelize] cifs on the CPU in {secs:.3f} s: ids and species equal the "
          f"card's, density max abs diff {float(np.abs(dg - dc).max()):.3e}")
    return out["synthetic"][0], total


def phase_train_unet(tmp: str, data: str, card: str):
    """``apps.train_unet.main`` at production width on the synthetic build,
    then generate ``--fused`` from the checkpoint directory it wrote."""
    import numpy as np

    from icsg3d_torch.apps import generate, train_unet

    ckpt = os.path.join(tmp, "unet-ckpt")
    argv = ["--data", data, "--epochs", str(UNET_EPOCHS), "--batch-size",
            str(UNET_BATCH), "--nrot", "0", "--device", DEVICE, "--ckpt", ckpt,
            "--seed", str(SEED)]
    sync()
    reset_counts()
    t0 = time.perf_counter()
    hist = train_unet.main(argv)
    sync()
    secs = time.perf_counter() - t0
    counts = read_counts()
    n_train = int(0.8 * UNET_PARENTS) // UNET_BATCH
    n_val = (UNET_PARENTS - int(0.8 * UNET_PARENTS)) // UNET_BATCH
    check(len(hist) == UNET_EPOCHS, f"train_unet: {len(hist)} epochs of history")
    for e, h in enumerate(hist):
        check(h["steps"] == n_train, f"train_unet epoch {e}: {h['steps']} steps")
        for split in ("train", "val"):
            vals = [v for k, v in h[split].items() if k != "ce_per_class"]
            check(all(np.isfinite(v) for v in vals) and
                  bool(np.isfinite(h[split]["ce_per_class"]).all()),
                  f"train_unet epoch {e}: non-finite {split} metrics")
    for name in ("history.json", "class_weights.json", "best.npz", "latest.npz"):
        check(os.path.exists(os.path.join(ckpt, name)), f"train_unet wrote no {name}")
    with open(os.path.join(ckpt, "class_weights.json")) as f:
        cw = json.load(f)["class_weights"]
    check(len(cw) == 95 and cw[0] == 0.0, "class_weights.json is malformed")
    per = UNET_EPOCHS * n_train
    want = {**NO_LAUNCHES,
            "fwd": per * UNET_CONVS_N + UNET_EPOCHS * n_val * UNET_CONVS_N,
            "bias": per * UNET_CONVS_N,
            "folded": UNET_EPOCHS * n_val * UNET_CONVS_N,
            "dx": per * (UNET_CONVS_N - 1), "dw": per * UNET_CONVS_N}
    check(counts == want, f"train_unet: launches {counts}, want {want} "
          f"({UNET_EPOCHS} epochs x ({n_train} train + {n_val} eval) steps)")
    print(f"[train-unet] train_unet.main: {UNET_EPOCHS} epochs x {n_train} steps + "
          f"{n_val} val batches at batch {UNET_BATCH} in {secs:.3f} s ({card}); epoch "
          f"times {[round(h['time'], 3) for h in hist]} s; train loss "
          f"{[round(h['train']['loss'], 4) for h in hist]}, val ce "
          f"{[round(h['val']['ce'], 4) for h in hist]}; launches {counts} = expected")

    out = os.path.join(tmp, "gen-unet")
    sync()
    reset_counts()
    generate.main(["--data", data, "--base", "syn-0", "--vae-ckpt",
                   os.path.join(tmp, "vae.npz"), "--unet-ckpt", ckpt, "--nsamples",
                   str(BATCH), "--batch-size", str(BATCH), "--device", DEVICE,
                   "--fused", "--output", out])
    sync()
    gen_counts = read_counts()
    with open(os.path.join(out, "results.json")) as f:
        rows = json.load(f)
    want_gen = ENCODER_CONVS + DECODER_CONVS + UNET_CONVS
    check(len(rows) == BATCH and gen_counts["fwd"] == want_gen
          and (gen_counts["cc"], gen_counts["bfs"]) == (2, 1),
          f"generate from the U-Net checkpoint: {len(rows)} records, "
          f"{gen_counts['fwd']} launches, E1 {gen_counts['cc']}, E2 {gen_counts['bfs']}")
    print(f"[train-unet] generate --fused --unet-ckpt {os.path.basename(ckpt)}: "
          f"{len(rows)} records, {sum(bool(r.get('valid')) for r in rows)} valid; "
          f"conv launches {gen_counts['fwd']}, E1 2, E2 1")
    # the training's launches and the generation's extraction
    return ({**counts, "cc": gen_counts["cc"], "bfs": gen_counts["bfs"]},
            np.asarray(cw, np.float32))


def phase_unet_train_step(data: str, class_weights, card: str):
    """One U-Net train and eval step alone (launch counts), the train step
    by stage, and one profiled step, at batch UNET_BATCH."""
    import numpy as np
    import torch

    from icsg3d_torch.config import UNetConfig
    from icsg3d_torch.data.store import GridDataset
    from icsg3d_torch.train.unet import (
        create_unet_state,
        losses_from_logits,
        make_unet_steps,
        prepare_unet_batch,
    )
    from icsg3d_torch.train.vae import _assemble_x

    state = create_unet_state(UNetConfig(), 3e-6, SEED, DEVICE)
    model, opt = state.model, state.optimizer
    train_step, eval_step = make_unet_steps(model, class_weights)
    ds = GridDataset(data)
    raw = {k: np.asarray(ds.arrays[k][:UNET_BATCH]) for k in ("density", "lattice",
                                                              "species")}
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in prepare_unet_batch(raw, 95, device_coords=True).items()}
    n = UNET_CONVS_N
    for label, step, want in (
        ("train", train_step, {**NO_LAUNCHES, "fwd": n, "bias": n, "dx": n - 1,
                               "dw": n}),
        ("eval", eval_step, {**NO_LAUNCHES, "fwd": n, "folded": n}),
    ):
        sync()
        reset_counts()
        mets = step(state, batch)
        sync()
        got = read_counts()
        check(got == want, f"one U-Net {label} step launched {got}, want {want}")
        check(all(bool(torch.isfinite(v).all()) for v in mets.values()),
              f"one U-Net {label} step: non-finite metrics")
        print(f"[unet-train-step] one {label} step: launches {got}")

    cw = torch.from_numpy(class_weights).to(DEVICE)

    def staged():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        soft, sig = model(_assemble_x(batch, None), train=True)
        ev[1].record()
        loss, _ = losses_from_logits(soft, sig, batch["labels"], cw)
        ev[2].record()
        loss.backward()
        ev[3].record()
        opt.step()
        ev[4].record()
        ev[4].synchronize()
        return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]

    for _ in range(2):
        staged()
    runs = [staged() for _ in range(5)]
    stage = [statistics.median(r[i] for r in runs) for i in range(4)]
    step_ms = cuda_median_ms(lambda: train_step(state, batch), runs=5, warmup=1)
    eval_ms = cuda_median_ms(lambda: eval_step(state, batch), runs=5, warmup=1)
    print(f"[unet-train-step] batch {UNET_BATCH} ({card}), CUDA-event medians of 5: "
          f"forward {stage[0]:.3f} ms, loss + metrics {stage[1]:.3f} ms, backward "
          f"{stage[2]:.3f} ms, Adam {stage[3]:.3f} ms (sum {sum(stage):.3f}); "
          f"train_step {step_ms:.3f} ms = {UNET_BATCH / step_ms * 1e3:.2f} train "
          f"grids/s; eval_step {eval_ms:.3f} ms")
    profile_step(lambda: train_step(state, batch), step_ms, "unet-train-profile", card)
    return state, batch, cw


def profile_step(fn, step_ms: float, tag: str, card: str,
                 what: str = "one train step"):
    """One call of ``fn`` (``what``) under torch.profiler: device busy ms
    (kernels and copies), the idle share against the unprofiled
    ``step_ms``, and the top device ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device activity only: kernels and copies, not the CPU ops that launch
    # them nor the GPU-side ranges of user annotations
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    by_name = {}
    for e in dev:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    print(f"[{tag}] {what} under torch.profiler ({card}): wall "
          f"{wall_ms:.3f} ms (profiled), device busy {busy_ms:.3f} ms over "
          f"{len(dev)} device ops; unprofiled step {step_ms:.3f} ms, idle share "
          f"{max(0.0, 1 - busy_ms / step_ms):.3f}")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"    {ms:9.3f} ms  x{n:<4d} {name[:90]}")
    for label, key in (("forward/dx kernel conv3d.cu, bf16", "conv3d_wgmma_kernel"),
                       ("forward/dx kernel conv3d.cu, f32 head", "conv3d_f32_kernel"),
                       ("weight-gradient kernel conv3d_dw.cu, bf16", "conv3d_dw_wgmma_kernel"),
                       ("weight-gradient kernel conv3d_dw.cu, f32 head", "conv3d_dw_f32_kernel"),
                       ("weight-gradient split sum conv3d_dw.cu", "reduce_splits_kernel")):
        mine = [(ms, n) for name, (ms, n) in by_name.items() if key in name]
        print(f"  [{tag}] {label}: {sum(m for m, _ in mine):.3f} ms over "
              f"{sum(n for _, n in mine)} launches")


def phase_unet_train_cpu_parity(state, batch, cw):
    """One U-Net train step's loss and weight gradients, batch 2, on the
    card (bf16 compute) and on the CPU (f32, plain versions), same weights
    and batch."""
    import copy
    import dataclasses

    import torch

    from icsg3d_torch.models import UNet3D
    from icsg3d_torch.train.unet import _unet_losses

    t0 = time.perf_counter()
    card_model = copy.deepcopy(state.model)
    cpu_model = UNet3D(dataclasses.replace(card_model.cfg, dtype="float32"))
    cpu_model.load_state_dict(card_model.state_dict())
    names = ("conv1.kernel", "conv14.kernel")
    out = {}
    for dev, model in ((DEVICE, card_model), ("cpu", cpu_model)):
        b = {k: v[:2].to(dev) for k, v in batch.items()}
        model.zero_grad(set_to_none=True)
        loss, mets = _unet_losses(model, b, cw.to(dev), train=True)
        loss.backward()
        grads = dict(model.named_parameters())
        out[dev] = (float(loss.detach()),
                    {n: grads[n].grad.detach().double().cpu().flatten() for n in names})
    (lg, gg), (lc, gc) = out[DEVICE], out["cpu"]
    rel = abs(lg - lc) / abs(lc)
    check(rel <= 2e-2, f"U-Net train step GPU vs CPU: loss {lg} vs {lc} "
          f"(rel {rel:.3e} > 2e-2)")
    cos = {n: float(torch.nn.functional.cosine_similarity(gg[n], gc[n], dim=0))
           for n in names}
    for n, c in cos.items():
        check(c >= 0.95, f"U-Net train step GPU vs CPU: grad cosine of {n} {c:.4f} < 0.95")
    print(f"[unet-train-gpu-vs-cpu] batch 2 in {time.perf_counter() - t0:.1f} s: loss "
          f"{lg:.6f} (card, bf16) vs {lc:.6f} (cpu, f32), rel {rel:.3e}; "
          f"weight-gradient cosines {cos}")


def phase_valid_kernels(card: str, sets, same_rows):
    """K1 VALID, its full-window dx and K2 VALID at the slab shapes of
    ``sets`` ((pass, shapes, batch)): each cell of a 1 x SPATIAL mesh holds
    a slab of edge // SPATIAL output planes of the full batch, read with
    its two halo planes.  Each pass's sum over the SPATIAL cells is printed
    beside the SAME kernel's time on the convs ``same_rows`` (phase 3)
    measured at the same batch."""
    import torch
    import torch.nn.functional as F

    from icsg3d_torch.kernels import conv3d as k
    from icsg3d_torch.kernels import conv3d_dw as kdw

    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    rows = []
    cl3d = torch.channels_last_3d
    print(f"[valid-kernels] 1x{SPATIAL} mesh slabs, card: {card}")
    print("  pass conv            batch Cin->Cout @edge planes type  max_abs_err  "
          "rel_err  bound    kernel_ms  plain_ms  library_ms  bound_ms")
    for pas, shapes, batch in sets:
        mine = []
        for name, cin, cout, edge, idt in shapes:
            t, d = dt[idt], edge // SPATIAL

            def rand(*shape):
                return torch.randn(*shape, device="cuda", generator=gen)

            if pas == "fwd":
                x = rand(batch, d + 2, edge, edge, cin).to(t)
                w = (rand(3, 3, 3, cin, cout) / (27 * cin) ** 0.5).to(t)
                b = 0.1 * rand(cout)
                args, run, plain = (x, w, b), k.conv3d_valid_cuda, k.conv3d_valid_reference
                xc = x.permute(0, 4, 1, 2, 3)
                wc = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=cl3d)

                def library():
                    y = F.conv3d(xc, wc, padding=(0, 1, 1)).permute(0, 2, 3, 4, 1)
                    return (y.float() + b).to(t)
            elif pas == "dx":
                g = rand(batch, d, edge, edge, cout).to(t)
                w = (rand(3, 3, 3, cin, cout) / (27 * cout) ** 0.5).to(t)
                args, run, plain = (g, w), k.conv3d_dx_valid_cuda, k.conv3d_dx_valid_reference
                wc = w.permute(4, 3, 0, 1, 2).contiguous(memory_format=cl3d)
                gc = g.permute(0, 4, 1, 2, 3)

                def library():
                    return torch.nn.grad.conv3d_input(
                        (batch, cin, d + 2, edge, edge), wc, gc, padding=(0, 1, 1))
            else:
                x = rand(batch, d + 2, edge, edge, cin).to(t)
                g = rand(batch, d, edge, edge, cout).to(t)
                args = (x, g)
                run, plain = kdw.conv3d_dw_valid_cuda, kdw.conv3d_dw_valid_reference
                xc, gc = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)

                def library():
                    return torch.nn.grad.conv3d_weight(
                        xc, (cout, cin, 3, 3, 3), gc, padding=(0, 1, 1))
            got = run(*args)
            torch.cuda.synchronize()
            ref = plain(*args)
            abs_err = float((got.float() - ref.float()).abs().max())
            rel_err = abs_err / max(float(ref.float().abs().max()), 1e-30)
            bound = 1e-3 if pas == "dw" else (1e-2 if idt == "bf16" else 1e-4)
            check(got.shape == ref.shape and bool(torch.isfinite(got.float()).all()),
                  f"{pas} valid {name}: shape {tuple(got.shape)} or non-finite output")
            check(rel_err <= bound, f"{pas} valid {name} {cin}->{cout}@{edge}: rel err "
                  f"{rel_err:.3e} > {bound:g}")
            check(torch.equal(got, run(*args)), f"{pas} valid {name}: a second "
                  "launch gave other bits")
            ms = cuda_median_ms(lambda: run(*args))
            plain_ms = cuda_median_ms(lambda: plain(*args))
            library_ms = cuda_median_ms(library)
            bms, bby = bound_ms(pas, cin, cout, edge, idt, idt, batch, depth=d)
            if pas == "dw":
                note = dw_row_note(dw_launch_report(run, args, 1), ms, bms)
            else:
                note = conv_row_note(run, args, "valid" if pas == "fwd" else "full",
                                     pas == "dx", ms, bms)
            print(f"  {pas:4s} {name:15s} {batch:3d} {cin:4d}->{cout:<4d}@{edge:<3d} "
                  f"{d:3d}+2 {idt:4s} {abs_err:11.3e} {rel_err:8.2e} {bound:6g} "
                  f"{ms:10.4f} {plain_ms:9.4f} {library_ms:11.4f} {bms:9.4f} {bby}{note}")
            mine.append(dict(model=name, cin=cin, cout=cout, edge=edge, batch=batch,
                             abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bms, bound_by=bby,
                             epilogue="bias" if pas == "fwd" else None,
                             **{"pass": pas + "_valid"}))
        rows += mine
        print(f"  {pas} valid at batch {batch}, {len(mine)} shapes: {pass_summary(mine)}")
        same = {r["model"]: r["ms"] for r in same_rows if r["pass"] == pas
                and r["batch"] == batch and r.get("epilogue") in (None, "bias")}
        both = [r for r in mine if r["model"] in same]
        if both:
            cells = SPATIAL * sum(r["ms"] for r in both)
            whole = sum(same[r["model"]] for r in both)
            print(f"  {pas} valid over {SPATIAL} cells vs SAME on the {len(both)} convs "
                  f"measured at both: {cells:.3f} ms vs {whole:.3f} ms "
                  f"(x{cells / whole:.3f})")
    torch.cuda.empty_cache()
    return rows


def spatial_step_counts(model: str, train: bool) -> dict:
    """Launches of one step on a 1 x SPATIAL mesh, where every 3x3x3 conv
    of the model divides (one VALID launch per cell); the VAE step's frozen
    U-Net taps stay SAME."""
    cells = SPATIAL
    if model == "vae":
        n, taps = len(VAE_CONVS), len(UNET_PREFIX)
        if train:
            return {**NO_LAUNCHES, "fwd": 2 * taps, "bias": 2 * taps, "dx": taps,
                    "fwd_valid": cells * n, "dx_valid": cells * (n - 1),
                    "dw_valid": cells * n}
        # eval: every VAE conv but the encoder's last runs a folded epilogue
        return {**NO_LAUNCHES, "fwd": 2 * taps, "bias": 2 * taps,
                "fwd_valid": cells * n, "valid_folded": cells * (n - 1)}
    n = UNET_CONVS_N
    if train:
        return {**NO_LAUNCHES, "fwd_valid": cells * n, "dx_valid": cells * (n - 1),
                "dw_valid": cells * n}
    return {**NO_LAUNCHES, "fwd_valid": cells * n, "valid_folded": cells * n}


def _steps_counts(model: str, n_train: int, n_val: int) -> dict:
    tr, ev = spatial_step_counts(model, True), spatial_step_counts(model, False)
    return {key: n_train * tr[key] + n_val * ev[key] for key in NO_LAUNCHES}


def phase_train_spatial(tmp: str, unet_data: str, card: str):
    """Both trainer CLIs at ``--spatial SPATIAL --device cuda:0,...`` at
    production width, one epoch each; returns their summed launches."""
    import numpy as np

    from icsg3d_torch.apps import train_unet, train_vae

    runs = [
        ("vae", train_vae, ["--data", os.path.join(tmp, "train-data"), "--unet-ckpt",
                            os.path.join(tmp, "unet.npz"), "--batch-size", str(BATCH)],
         TRAIN_PARENTS, BATCH),
        ("unet", train_unet, ["--data", unet_data, "--batch-size", str(UNET_BATCH)],
         UNET_PARENTS, UNET_BATCH),
    ]
    total = dict(NO_LAUNCHES)
    for label, app, argv, parents, batch in runs:
        argv = argv + ["--epochs", "1", "--nrot", "0", "--device", SPATIAL_DEVICES,
                       "--spatial", str(SPATIAL), "--seed", str(SEED),
                       "--ckpt", os.path.join(tmp, f"{label}-spatial-ckpt")]
        sync()
        reset_counts()
        t0 = time.perf_counter()
        hist = app.main(argv)
        sync()
        secs = time.perf_counter() - t0
        counts = read_counts()
        n_train, n_val = int(0.8 * parents) // batch, (parents - int(0.8 * parents)) // batch
        check(len(hist) == 1 and hist[0]["steps"] == n_train,
              f"{label} --spatial {SPATIAL}: history {[h['steps'] for h in hist]}")
        for split in ("train", "val"):
            vals = [v for key, v in hist[0][split].items() if key != "ce_per_class"]
            check(all(np.isfinite(v) for v in vals),
                  f"{label} --spatial {SPATIAL}: non-finite {split} metrics")
        want = _steps_counts(label, n_train, n_val)
        check(counts == want, f"{label} --spatial {SPATIAL}: launches {counts}, want "
              f"{want} ({n_train} train + {n_val} eval steps)")
        total = {key: total[key] + counts[key] for key in total}
        print(f"[train-spatial] {app.__name__.rsplit('.', 1)[-1]}.main --spatial "
              f"{SPATIAL} --device {SPATIAL_DEVICES}: 1 epoch of {n_train} steps + "
              f"{n_val} val batches at batch {batch} in {secs:.3f} s ({card}); epoch "
              f"time {hist[0]['time']:.3f} s; train loss "
              f"{hist[0]['train']['loss']:.4f}; launches {counts} = expected")
    return total


def phase_spatial_parity(tmp: str, unet_data: str, class_weights, card: str):
    """``--spatial SPATIAL`` against ``--spatial 1``, for each trainer: one
    train step's loss and weight gradients from the same weights and batch;
    one sharded train and eval step's launches; both train steps' times."""
    import numpy as np
    import torch

    from icsg3d_torch.apps.common import load_unet
    from icsg3d_torch.config import GridSpec, UNetConfig, VAEConfig
    from icsg3d_torch.data.store import GridDataset
    from icsg3d_torch.parallel import make_mesh
    from icsg3d_torch.train.state import TrainState
    from icsg3d_torch.train.unet import (
        _unet_losses,
        create_unet_state,
        make_unet_steps,
        prepare_unet_batch,
    )
    from icsg3d_torch.train.vae import _vae_losses, create_vae_state, make_vae_steps

    mesh = make_mesh(1, SPATIAL, devices=[torch.device("cuda", 0)] * SPATIAL)
    unet = load_unet(UNetConfig(), os.path.join(tmp, "unet.npz"), device=DEVICE)
    ds = GridDataset(os.path.join(tmp, "train-data"))
    cond = np.zeros((BATCH, 10), np.float32)
    cond[np.arange(BATCH), np.arange(BATCH) % 10] = 1.0
    vae_batch = {key: torch.from_numpy(v).to(DEVICE) for key, v in (
        ("density", np.array(ds.arrays["density"][:BATCH])),
        ("abc", np.array(ds.arrays["lattice"][:BATCH, :3])), ("cond", cond))}
    eps = torch.randn(BATCH, 256, device=DEVICE,
                      generator=torch.Generator(device=DEVICE).manual_seed(SEED + 8))
    uds = GridDataset(unet_data)
    raw = {key: np.asarray(uds.arrays[key][:UNET_BATCH])
           for key in ("density", "lattice", "species")}
    unet_batch = {key: torch.from_numpy(v).to(DEVICE)
                  for key, v in prepare_unet_batch(raw, 95, device_coords=True).items()}
    cw = torch.from_numpy(class_weights).to(DEVICE)

    cases = [
        ("vae", create_vae_state(VAEConfig(grid=GridSpec(d=D)), 5e-4, SEED, DEVICE,
                                 spatial_mesh=mesh),
         lambda m: _vae_losses(m, unet, vae_batch, eps, train=True)[0],
         lambda m: make_vae_steps(m, unet), (vae_batch, eps)),
        ("unet", create_unet_state(UNetConfig(), 3e-6, SEED, DEVICE, spatial_mesh=mesh),
         lambda m: _unet_losses(m, unet_batch, cw, train=True)[0],
         lambda m: make_unet_steps(m, class_weights), (unet_batch,)),
    ]
    for label, sharded, loss_of, steps_of, step_args in cases:
        plain = TrainState.create(copy.deepcopy(sharded.model),
                                  sharded.optimizer.param_groups[0]["lr"])
        plain.model.spatial_mesh = None
        out = {}
        for name, state in (("spatial", sharded), ("plain", plain)):
            model = state.model
            model.zero_grad(set_to_none=True)
            loss = loss_of(model)
            loss.backward()
            out[name] = (float(loss.detach()), {
                n: p.grad.detach().double().flatten()
                for n, p in model.named_parameters() if n.endswith("kernel")})
        (ls, gs), (lp, gp) = out["spatial"], out["plain"]
        rel = abs(ls - lp) / abs(lp)
        check(rel <= 1e-4, f"{label} --spatial {SPATIAL} vs 1: loss {ls} vs {lp} "
              f"(rel {rel:.3e} > 1e-4)")
        cos = {n: float(torch.nn.functional.cosine_similarity(gs[n], gp[n], dim=0))
               for n in gs}
        worst = min(cos, key=cos.get)
        check(cos[worst] >= 0.999, f"{label} --spatial {SPATIAL} vs 1: gradient "
              f"cosine of {worst} {cos[worst]:.6f} < 0.999")

        train_s, eval_s = steps_of(sharded.model)
        train_p, _ = steps_of(plain.model)
        for kind, step, want in (("train", train_s, spatial_step_counts(label, True)),
                                 ("eval", eval_s, spatial_step_counts(label, False))):
            sync()
            reset_counts()
            step(sharded, *step_args)
            sync()
            got = read_counts()
            check(got == want, f"one {label} {kind} step at --spatial {SPATIAL} "
                  f"launched {got}, want {want}")
        # in turns: plain, sharded, sharded, plain
        times = {"plain": [], "spatial": []}
        for name in ("plain", "spatial", "spatial", "plain"):
            st, fn = (plain, train_p) if name == "plain" else (sharded, train_s)
            times[name].append(cuda_median_ms(lambda: fn(st, *step_args), runs=5,
                                              warmup=1))
        ms = {name: statistics.mean(v) for name, v in times.items()}
        batch = BATCH if label == "vae" else UNET_BATCH
        print(f"[spatial-vs-1] {label} ({card}): loss {ls:.6f} (--spatial {SPATIAL}) vs "
              f"{lp:.6f} (--spatial 1), rel {rel:.3e}; {len(cos)} weight-gradient "
              f"cosines >= {cos[worst]:.6f} (lowest {worst}); one train/eval step at "
              f"--spatial {SPATIAL} launched the expected "
              f"{spatial_step_counts(label, True)} / {spatial_step_counts(label, False)}; "
              f"train_step {ms['spatial']:.3f} ms (--spatial {SPATIAL}, "
              f"{batch / ms['spatial'] * 1e3:.2f} grids/s) vs {ms['plain']:.3f} ms "
              f"(--spatial 1, {batch / ms['plain'] * 1e3:.2f} grids/s), CUDA-event "
              f"medians of 5 in turns {times}")
        profile_step(lambda: train_s(sharded, *step_args), ms["spatial"],
                     f"{label}-spatial-profile", card)
        del sharded, plain
        torch.cuda.empty_cache()


# [epoch-scan]: the VAE split of its turns, at the VAE CLI's batch.
EPOCH_PARENTS = 300  # 240 train (12 steps) + 60 val (3 batches) per epoch
EPOCH_SCAN_EPOCHS = 2


def captured_counts() -> dict:
    """``read_counts()`` of the kernels the card ran: a wrapper counts a
    launch that a CUDA graph captures once, at the capture
    (train/graphs.py), so each capture's recorded launches are added once
    more for every replay after the first."""
    from icsg3d_torch.train import graphs

    counts = read_counts()
    for c in graphs.captures:
        n = c.launches
        add = {"fwd": n["conv3d"], "bias": n["conv3d[bias]"],
               "folded": sum(n[f"conv3d[{e}]"] for e in FOLDED), "dx": n["conv3d_dx"],
               "dw": n["conv3d_dw"], "fwd_valid": n["conv3d_valid"],
               "valid_folded": sum(n[f"conv3d_valid[{e}]"] for e in FOLDED),
               "dx_valid": n["conv3d_dx_valid"], "dw_valid": n["conv3d_dw_valid"]}
        for key, v in add.items():
            counts[key] += (c.replays - 1) * v
    return counts


def _epoch_scan_run(app, argv: list, ckpt: str, scan: bool):
    """One trainer CLI run, --resident with or without --epoch-scan:
    (history, the card's launches, [(capture, replays)], seconds)."""
    from icsg3d_torch.train import graphs

    sync()
    reset_counts()
    graphs.reset_captures()
    t0 = time.perf_counter()
    hist = app.main(argv + ["--ckpt", ckpt] + (["--epoch-scan"] if scan else []))
    sync()
    secs = time.perf_counter() - t0
    caps = [(c.name, c.replays) for c in graphs.captures]
    check(bool(caps) == scan, f"{app.__name__}: captures {caps} with epoch_scan={scan}")
    return hist, captured_counts(), caps, secs


def _same_training(label: str, runs: list) -> str:
    """Each run's latest.npz (parameters, BatchNorm statistics, Adam's
    moments and step) and history against the first run's: bitwise, except
    the U-Net's per-class CE sums (``index_add_``'s float atomics), held to
    1e-5 relative.  Returns what was seen."""
    import numpy as np

    ref_ckpt, ref_hist = runs[0]
    with np.load(os.path.join(ref_ckpt, "latest.npz")) as f:
        ref = {k: f[k] for k in f.files}
    worst = 0.0
    for ckpt, hist in runs[1:]:
        with np.load(os.path.join(ckpt, "latest.npz")) as f:
            got = {k: f[k] for k in f.files}
        check(got.keys() == ref.keys(), f"{label}: latest.npz keys differ")
        for key in ref:
            check(np.array_equal(got[key], ref[key]),
                  f"{label}: {key} differs from the per-step path (max abs "
                  f"{float(np.abs(got[key] - ref[key]).max()):.3e})")
        for e, (a, b) in enumerate(zip(ref_hist, hist)):
            for split in ("train", "val"):
                for key, v in a[split].items():
                    if key == "ce_per_class":
                        v, w = np.asarray(v), np.asarray(b[split][key])
                        rel = float((np.abs(w - v) / np.maximum(np.abs(v), 1e-30)).max())
                        worst = max(worst, rel)
                        check(rel <= 1e-5, f"{label} epoch {e}: {split} ce_per_class "
                              f"rel {rel:.3e} > 1e-5")
                    else:
                        check(b[split][key] == v, f"{label} epoch {e}: {split} {key} "
                              f"{b[split][key]!r} != {v!r}")
    return ("bitwise" if worst == 0.0 else
            f"bitwise but ce_per_class (index_add_ atomics) rel {worst:.3e}")


def epoch_profile(label: str, fns: list, n_steps: int, card: str,
                  tag: str = "epoch-scan-profile") -> dict:
    """Train epochs of ``n_steps`` of each named path in ``fns`` ([(name,
    fn)]; a name starting with "captured" replays a captured step) after
    the runs that warm and capture them: the unprofiled wall ms of each (in
    turns: the list, then the list reversed), then one profiled epoch of
    each: device busy ms and the idle share against the unprofiled wall,
    kernels per step (NCCL's apart), and the host's launch and copy calls
    per step (graph launches apart).  Prints a line per path; returns
    {name: its numbers}."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _, fn in fns:  # warm: the capture, the first launches
        fn()
        sync()
    walls = {name: [] for name, _ in fns}
    for name, fn in fns + fns[::-1]:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        walls[name].append((time.perf_counter() - t0) * 1e3)
    host = re.compile(r"^cu(da)?(LaunchKernel|GraphLaunch|Memcpy|Memset|LaunchCooperative)")
    out = {}
    for name, fn in fns:
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        events = prof.events()
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        calls = [e.name for e in events if e.device_type == DeviceType.CPU
                 and host.match(e.name)]
        busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        wall = statistics.median(walls[name])
        kernels = [e for e in dev if "memcpy" not in e.name.lower()
                   and "memset" not in e.name.lower()]
        nccl = sorted({e.name for e in kernels if "nccl" in e.name.lower()})
        names = {}
        for e in dev:
            names[e.name] = names.get(e.name, 0) + 1
        out[name] = {"names": names, "wall_ms": wall, "walls": walls[name], "busy_ms": busy,
                     "idle": max(0.0, 1 - busy / wall),
                     "steps_per_s": n_steps / wall * 1e3,
                     "kernels_per_step": len(kernels) / n_steps,
                     "nccl_per_step": sum("nccl" in e.name.lower() for e in kernels) / n_steps,
                     "nccl_kernels": nccl,
                     "copies_per_step": (len(dev) - len(kernels)) / n_steps,
                     "host_calls_per_step": len(calls) / n_steps,
                     "graph_launches": sum("GraphLaunch" in c for c in calls)}
        check(len(kernels) > 0, f"{label} {name}: the profiled epoch recorded no kernel")
    for name, r in out.items():
        print(f"[{tag}] {label}, one train epoch of {n_steps} steps, {name} "
              f"({card}): wall {r['wall_ms']:.3f} ms (median of {r['walls']}), "
              f"{r['steps_per_s']:.2f} steps/s; profiled device busy "
              f"{r['busy_ms']:.3f} ms, idle share {r['idle']:.3f}; per step "
              f"{r['kernels_per_step']:.1f} kernels ({r['nccl_per_step']:.1f} of NCCL), "
              f"{r['copies_per_step']:.2f} device copies, {r['host_calls_per_step']:.2f} host "
              f"launch/copy calls ({r['graph_launches']} graph launches in the epoch)",
              flush=True)
        if name.startswith("captured"):
            check(r["graph_launches"] == n_steps,
                  f"{label} {name}: {r['graph_launches']} graph launches, want {n_steps}")
    return out


def epoch_scan_cases(tmp: str, synthetic: str) -> dict:
    """{label: (app name, argv without --ckpt and --epoch-scan)} of the
    trainer runs of phases 16a and 26a at production width: the VAE at
    batch 20 on the epoch split (300 parents), with and without
    ``--cache-true-features``, and the U-Net at batch 10 on the synthetic
    build, 2 epochs each."""
    unet_npz = os.path.join(tmp, "unet.npz")
    common_argv = ["--epochs", str(EPOCH_SCAN_EPOCHS), "--nrot", "0", "--resident",
                   "--seed", str(SEED), "--device", DEVICE]
    vae = ["--data", os.path.join(tmp, "epoch-data"), "--unet-ckpt", unet_npz,
           "--batch-size", str(BATCH)] + common_argv
    return {
        "train_vae": ("train_vae", vae),
        "train_vae --cache-true-features": ("train_vae", vae + ["--cache-true-features"]),
        "train_unet": ("train_unet", ["--data", synthetic, "--batch-size",
                                      str(UNET_BATCH)] + common_argv),
    }


def vae_epoch_data(tmp: str):
    """The VAE profiles' split on the card: the epoch split's train rows,
    cyclic condition bins.  Returns (data, its row count)."""
    import numpy as np
    import torch

    from icsg3d_torch.data.store import GridDataset

    ds = GridDataset(os.path.join(tmp, "epoch-data"))
    n = int(0.8 * EPOCH_PARENTS) // BATCH * BATCH
    cond = np.eye(10, dtype=np.float32)[np.arange(n) % 10]
    return {"density": torch.from_numpy(np.array(ds.arrays["density"][:n],
                                                 np.float16)).to(DEVICE),
            "abc": torch.from_numpy(np.array(ds.arrays["lattice"][:n, :3],
                                             np.float32)).to(DEVICE),
            "cond": torch.from_numpy(cond).to(DEVICE)}, n


def unet_epoch_data(synthetic: str):
    """The U-Net profiles' split on the card: the synthetic build's train
    rows.  Returns (data, its row count)."""
    import numpy as np
    import torch

    from icsg3d_torch.data.store import GridDataset

    uds = GridDataset(synthetic)
    n = int(0.8 * UNET_PARENTS) // UNET_BATCH * UNET_BATCH
    return {"density": torch.from_numpy(np.array(uds.arrays["density"][:n],
                                                 np.float16)).to(DEVICE),
            "abc": torch.from_numpy(np.array(uds.arrays["lattice"][:n, :3],
                                             np.float32)).to(DEVICE),
            "labels": torch.from_numpy(np.minimum(np.asarray(
                uds.arrays["species"][:n]), 94).astype(np.uint8)).to(DEVICE)}, n


def phase_epoch_scan(tmp: str, synthetic: str, card: str):
    """``--resident --epoch-scan`` (the epoch as replays of a captured train
    and eval step) against ``--resident``'s per-step loop of the same seed,
    at production width, bitwise; then a profiled epoch of each path.
    Returns the CLI runs' summed launches (captured launches x replays) and
    {label: the captured run's checkpoint, history and launches} of the
    ``epoch_scan_cases``."""
    import numpy as np
    import torch

    from icsg3d_torch.apps import common, train_unet, train_vae
    from icsg3d_torch.config import GridSpec, UNetConfig, VAEConfig
    from icsg3d_torch.train import unet as tunet
    from icsg3d_torch.train import vae as tvae

    write_train_dataset(os.path.join(tmp, "epoch-data"), EPOCH_PARENTS)
    unet_npz = os.path.join(tmp, "unet.npz")
    small = ["--data", os.path.join(tmp, "train-data"), "--unet-ckpt", unet_npz,
             "--batch-size", str(BATCH), "--device", SPATIAL_DEVICES, "--spatial",
             str(SPATIAL), "--epochs", str(EPOCH_SCAN_EPOCHS), "--nrot", "0",
             "--resident", "--seed", str(SEED)]
    E = EPOCH_SCAN_EPOCHS

    def steps(parents, batch):
        return int(0.8 * parents) // batch, (parents - int(0.8 * parents)) // batch

    def vae_want(cached):
        t, v = steps(EPOCH_PARENTS, BATCH)
        taps = len(UNET_PREFIX)
        # the cache: one true-side tap forward per batch of the train split,
        # then a train step without it
        fwd = FWD_PER_STEP - taps * cached
        pre = -(-int(0.8 * EPOCH_PARENTS) // BATCH) * taps * cached
        return {**NO_LAUNCHES, "fwd": pre + E * (t * fwd + v * FWD_PER_STEP),
                "bias": pre + E * (t * fwd + v * (1 + 2 * taps)),
                "folded": E * v * (len(VAE_CONVS) - 1), "dx": E * t * DX_PER_STEP,
                "dw": E * t * DW_PER_STEP}

    t, v = steps(UNET_PARENTS, UNET_BATCH)
    n = UNET_CONVS_N
    unet_want = {**NO_LAUNCHES, "fwd": E * (t + v) * n, "bias": E * t * n,
                 "folded": E * v * n, "dx": E * t * (n - 1), "dw": E * t * n}
    spatial_want = {key: E * c for key, c in
                    _steps_counts("vae", *steps(TRAIN_PARENTS, BATCH)).items()}
    shared = epoch_scan_cases(tmp, synthetic)
    apps = {"train_vae": train_vae, "train_unet": train_unet}
    cases = [  # (label, app, argv, per-step/captured turns, launches)
        ("train_vae", (0, 1, 1, 0), vae_want(False)),
        ("train_vae --cache-true-features", (0, 1), vae_want(True)),
        ("train_unet", (0, 1, 1, 0), unet_want),
    ]
    cases = [(label, apps[shared[label][0]], shared[label][1], turns, want)
             for label, turns, want in cases]
    cases.append((f"train_vae --spatial {SPATIAL}", train_vae, small, (0, 1),
                  spatial_want))
    total, captured_runs = dict(NO_LAUNCHES), {}
    for i, (label, app, argv, turns, want) in enumerate(cases):
        runs, times, counts, captured = [], [], {}, None
        for j, scan in enumerate(turns):
            ckpt = os.path.join(tmp, f"epoch-scan-{i}-{j}")
            hist, got, caps, secs = _epoch_scan_run(app, argv, ckpt, scan)
            check(len(hist) == EPOCH_SCAN_EPOCHS and all(
                np.isfinite(h["train"]["loss"]) for h in hist),
                f"{label}: history {hist}")
            runs.append((ckpt, hist))
            times.append(("captured" if scan else "per-step",
                          [round(h["time"], 4) for h in hist]))
            if scan in counts:
                check(got == counts[scan], f"{label}: launches {got} != {counts[scan]}")
            counts[scan] = got
            total = {key: total[key] + got[key] for key in total}
            if scan:
                captured, steps = caps, hist[0]["steps"]
                check(caps and caps[0][1] == EPOCH_SCAN_EPOCHS * steps - 1,
                      f"{label}: captures {caps}, want {EPOCH_SCAN_EPOCHS * steps - 1} "
                      "train replays (one warm-up step)")
                captured_runs.setdefault(label, {"ckpt": ckpt, "history": hist,
                                                 "launches": got, "captures": caps})
        check(counts[0] == want, f"{label}: the per-step path launched {counts[0]}, "
              f"want {want}")
        check(counts[1] == counts[0], f"{label}: the captured path launched "
              f"{counts[1]}, the per-step path {counts[0]}")
        seen = _same_training(label, runs)
        steps = runs[0][1][0]["steps"]
        print(f"[epoch-scan] {label} --resident --epoch-scan vs --resident, "
              f"{EPOCH_SCAN_EPOCHS} epochs of {steps} steps ({card}): {seen}; launches "
              f"{counts[1]} (captured launches x replays) = the per-step path's; "
              f"captures (name, replays) {captured}; epoch times in turns (s; the captured epoch 0 "
              f"holds the warm-up step and the capture): "
              + ", ".join(f"{name} {t}" for name, t in times))

    # profiled epochs, both paths on one state: the VAE at batch 20 on the
    # epoch split's train rows, the U-Net at batch 10 on the synthetic build
    unet = common.load_unet(UNetConfig(num_classes=95), unet_npz, grid_d=D,
                            device=DEVICE)
    vae_data, n = vae_epoch_data(tmp)
    state = tvae.create_vae_state(VAEConfig(grid=GridSpec(d=D)), 5e-4, SEED, DEVICE)
    train_step, _ = tvae.make_vae_steps(state.model, unet)
    train_epoch, _ = tvae.make_vae_epoch_fns(state.model, unet)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    epoch_profile(f"VAE at batch {BATCH}", [
        ("per-step", lambda: _per_step_epoch(state, vae_data, n // BATCH, BATCH,
                                             lambda s, b: train_step(s, b, _noise(gen)),
                                             _perm_rows)),
        ("captured", lambda: _captured_epoch(state, vae_data, n // BATCH, BATCH,
                                             train_epoch, _noises(gen, n // BATCH)))],
        n // BATCH, card)
    del state, train_epoch, vae_data
    unet_data, n = unet_epoch_data(synthetic)
    ustate = tunet.create_unet_state(UNetConfig(num_classes=95), 3e-6, SEED, DEVICE)
    utrain, _ = tunet.make_unet_steps(ustate.model)
    uepoch, _ = tunet.make_unet_epoch_fns(ustate.model)
    epoch_profile(f"U-Net at batch {UNET_BATCH}", [
        ("per-step", lambda: _per_step_epoch(ustate, unet_data, n // UNET_BATCH,
                                             UNET_BATCH, utrain, _perm_rows)),
        ("captured", lambda: _captured_epoch(ustate, unet_data, n // UNET_BATCH,
                                             UNET_BATCH, uepoch, lambda: None))],
        n // UNET_BATCH, card)
    return total, captured_runs


def _noise(gen):
    import torch

    return torch.randn((BATCH, 256), generator=gen, device=DEVICE)


def _noises(gen, n_steps: int):
    """A captured epoch's noise: ``n_steps`` draws of ``_noise``, stacked."""
    import torch

    return lambda: torch.stack([_noise(gen) for _ in range(n_steps)])


def _perm_rows(n_steps: int, batch: int):
    """A host permutation of the split's rows, (n_steps, batch)."""
    import numpy as np

    return np.random.default_rng(SEED).permutation(n_steps * batch).reshape(n_steps, batch)


def _per_step_epoch(state, data, n_steps, batch, step, perm_rows):
    """The trainers' per-step resident epoch: an index upload, a gather and
    a step per batch, then one fetch of the stacked metrics."""
    import torch

    mets = []
    for rows in perm_rows(n_steps, batch):
        idx = torch.from_numpy(rows).to(DEVICE)
        mets.append(step(state, {k: v[idx] for k, v in data.items()}))
    return {k: torch.stack([m[k] for m in mets]).float().cpu() for k in mets[0]}


def _captured_epoch(state, data, n_steps, batch, program, noise):
    """The trainers' --epoch-scan epoch: one upload, the replays, one fetch."""
    import torch

    rows = torch.from_numpy(_perm_rows(n_steps, batch)).to(DEVICE)
    return program(state, data, rows, noise()).cpu()


def phase_train_cgcnn(tmp: str, card: str):
    """``apps.train_cgcnn.main`` at production width, one checkpoint per
    property; then the train step's and the forward's CUDA-event medians
    at batch 32 and one profiled train step.  Returns {property: ckpt}."""
    import numpy as np
    import torch

    from icsg3d_torch.apps import train_cgcnn
    from icsg3d_torch.config import CGCNNConfig
    from icsg3d_torch.train.cgcnn import cgcnn_forward, create_cgcnn_state, make_cgcnn_steps

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    n_train = int(0.8 * CGCNN_SYNTHETIC) // CGCNN_BATCH
    n_val = (CGCNN_SYNTHETIC - int(0.8 * CGCNN_SYNTHETIC)) // CGCNN_BATCH
    ckpts = {}
    for prop, synthetic in CGCNN_PROPS.items():
        ckpt = os.path.join(tmp, f"cgcnn-{synthetic}")
        sync()
        reset_counts()
        t0 = time.perf_counter()
        hist = train_cgcnn.main(["--synthetic", str(CGCNN_SYNTHETIC),
                                 "--synthetic-property", synthetic,
                                 "--epochs", str(CGCNN_EPOCHS),
                                 "--batch-size", str(CGCNN_BATCH), "--device", DEVICE,
                                 "--ckpt", ckpt, "--seed", str(SEED)])
        sync()
        secs = time.perf_counter() - t0
        check(len(hist) == CGCNN_EPOCHS and all(h["steps"] == n_train for h in hist),
              f"train_cgcnn {synthetic}: history {[h['steps'] for h in hist]}")
        for e, h in enumerate(hist):
            for split in ("train", "val"):
                check(all(np.isfinite(v) for v in h[split].values()),
                      f"train_cgcnn {synthetic} epoch {e}: non-finite {split} "
                      f"metrics {h[split]}")
        for name in ("best.npz", "latest.npz", "history.json"):
            check(os.path.exists(os.path.join(ckpt, name)),
                  f"train_cgcnn {synthetic} wrote no {name}")
        check(read_counts() == NO_LAUNCHES, "train_cgcnn launched a conv kernel")
        ckpts[prop] = ckpt
        print(f"[train-cgcnn] train_cgcnn.main --synthetic {CGCNN_SYNTHETIC} "
              f"--synthetic-property {synthetic}: {CGCNN_EPOCHS} epochs x {n_train} "
              f"steps + {n_val} val batches at batch {CGCNN_BATCH} in {secs:.3f} s "
              f"({card}), featurization included; epoch times "
              f"{[round(h['time'], 3) for h in hist]} s; train mse "
              f"{[round(h['train']['loss'], 4) for h in hist]}, val mae "
              f"{[round(h['val']['mae'], 4) for h in hist]}")

    state = create_cgcnn_state(CGCNNConfig(), 1e-3, SEED, DEVICE)
    train_step, _ = make_cgcnn_steps(state.model)
    graphs = train_cgcnn.graph_arrays_synthetic(CGCNN_BATCH, SEED + 6,
                                                CGCNNConfig().graph_spec())
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in graphs.items()}
    step_ms = cuda_median_ms(lambda: train_step(state, batch), runs=20, warmup=3)
    with torch.inference_mode():
        fwd_ms = cuda_median_ms(lambda: cgcnn_forward(state.model, batch), runs=20,
                                warmup=3)
    print(f"[train-cgcnn] batch {CGCNN_BATCH} ({card}), CUDA-event medians of 20: "
          f"train_step {step_ms:.3f} ms = {CGCNN_BATCH / step_ms * 1e3:.2f} train "
          f"graphs/s; forward {fwd_ms:.3f} ms = {CGCNN_BATCH / fwd_ms * 1e3:.2f} "
          f"predictions/s")
    profile_step(lambda: train_step(state, batch), step_ms, "cgcnn-train-profile", card)
    return ckpts


def phase_cgcnn_cpu_parity(card: str):
    """One CGCNN train step and one prediction batch at batch 32, on the
    card and on the CPU from the same seeded weights and batch, both f32:
    predictions within 1e-5 of max(1, max|pred|), the loss within 1e-5
    relative, each parameter's gradient within 1e-4 of its max|g| (f32
    sums in another order; no TF32)."""
    import torch

    from icsg3d_torch.apps.train_cgcnn import graph_arrays_synthetic
    from icsg3d_torch.config import CGCNNConfig
    from icsg3d_torch.train.cgcnn import cgcnn_forward, create_cgcnn_state, make_cgcnn_steps

    graphs = graph_arrays_synthetic(CGCNN_BATCH, SEED + 7, CGCNNConfig().graph_spec())
    out = {}
    for dev in (DEVICE, "cpu"):
        state = create_cgcnn_state(CGCNNConfig(), 1e-3, SEED, dev)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in graphs.items()}
        with torch.no_grad():
            preds = cgcnn_forward(state.model, batch).cpu()
        train_step, _ = make_cgcnn_steps(state.model)
        loss = float(train_step(state, batch)["loss"])
        out[dev] = (preds, loss, {n: p.grad.detach().cpu()
                                  for n, p in state.model.named_parameters()})
    (pg, lg, gg), (pc, lc, gc) = out[DEVICE], out["cpu"]
    pred_err = float((pg - pc).abs().max())
    check(pred_err <= 1e-5 * max(1.0, float(pc.abs().max())),
          f"CGCNN predictions card vs CPU differ by {pred_err:.3e}")
    rel = abs(lg - lc) / abs(lc)
    check(rel <= 1e-5, f"CGCNN train step card vs CPU: loss {lg} vs {lc} (rel {rel:.3e})")
    errs = {n: float((gg[n] - g).abs().max()) / max(float(g.abs().max()), 1e-12)
            for n, g in gc.items()}
    worst = max(errs, key=errs.get)
    check(errs[worst] <= 1e-4, f"CGCNN gradient of {worst} card vs CPU: "
          f"{errs[worst]:.3e} of its max > 1e-4")
    print(f"[cgcnn-gpu-vs-cpu] batch {CGCNN_BATCH} ({card}): predictions max abs diff "
          f"{pred_err:.3e} (max |pred| {float(pc.abs().max()):.4f}); loss {lg:.6f} "
          f"(card) vs {lc:.6f} (cpu), rel {rel:.3e}; {len(errs)} gradients within "
          f"{errs[worst]:.3e} of their max (worst {worst})")


def _quiet(fn, *args):
    """fn(*args) with its standard output (a CLI's JSON dump) held back."""
    import contextlib
    import io

    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def phase_predict(tmp: str, ckpts: dict, card: str):
    """``apps.predict.main`` on the real CIFs with the two checkpoints, on
    the card and on the CPU: a record per CIF, finite properties, the same
    parse errors, properties within 1e-5 of max(1, max|value|)."""
    import numpy as np

    from icsg3d_torch.apps import predict

    spec = ",".join(f"{prop}={ckpt}" for prop, ckpt in ckpts.items())
    n_cifs = sum(f.endswith(".cif") for f in os.listdir(REAL_CIFS))
    out, secs = {}, {}
    for dev in (DEVICE, "cpu"):
        argv = [REAL_CIFS, "--ckpt", spec, "--device", dev,
                "--output", os.path.join(tmp, f"predict-{dev}.json")]
        sync()
        t0 = time.perf_counter()
        out[dev] = _quiet(predict.main, argv)
        sync()
        secs[dev] = time.perf_counter() - t0
    card_recs, cpu_recs = out[DEVICE], out["cpu"]
    check(len(card_recs) == len(cpu_recs) == n_cifs,
          f"predict: {len(card_recs)} records for {n_cifs} CIFs")
    check([r.get("error") for r in card_recs] == [r.get("error") for r in cpu_recs],
          "predict: the card's parse errors differ from the CPU's")
    vals = {dev: np.asarray([[r["properties"][p] for p in ckpts] for r in recs
                             if "properties" in r], np.float64)
            for dev, recs in out.items()}
    n_ok = len(vals["cpu"])
    check(n_ok > 0 and vals[DEVICE].shape == (n_ok, len(ckpts))
          and bool(np.isfinite(vals[DEVICE]).all()), "predict: missing or non-finite "
          "properties")
    err = float(np.abs(vals[DEVICE] - vals["cpu"]).max())
    check(err <= 1e-5 * max(1.0, float(np.abs(vals["cpu"]).max())),
          f"predict: card and CPU properties differ by {err:.3e}")
    print(f"[predict] predict.main on {n_cifs} CIFs x {len(ckpts)} properties "
          f"({card}): {n_ok} predicted, {n_cifs - n_ok} parse errors (same on the "
          f"CPU); a smoke timing with the parsing, featurization and two weight "
          f"loads inside it, not a rate: {secs[DEVICE]:.3f} s on the card, "
          f"{secs['cpu']:.3f} s on the CPU; max |card - cpu| {err:.3e}")


def phase_generate_cgcnn(tmp: str, ckpts: dict, card: str):
    """``apps.generate --fused --cgcnn-ckpt`` on the blob dataset with the
    trained checkpoints, one batch: every extracted structure of 1..50
    atoms carries both properties.  The seeded VAE decodes cells of ~0.4
    Angstrom, where the CGCNN's 8 Angstrom neighbour search of 50 atoms
    would walk ~10^5 periodic images per structure, so this run scales the
    VAE's coordinate outputs (the decoder's output BatchNorm, channels 1-3,
    x COORD_SCALE) to cells of a few Angstrom.  Without a merge (at the
    thresholds 0.8 and 0.9999) the seeded models' fused extraction gives
    every structure more than 50 atoms on the H100, so this run thresholds
    at CGCNN_OCCUPANCY and merges atoms closer than CGCNN_MERGE Angstrom,
    as a user would for noisy decodes.  Returns the run's launches."""
    import numpy as np

    from icsg3d_torch.apps import generate
    from icsg3d_torch.weights import load_npz, save_npz

    tree = load_npz(os.path.join(tmp, "vae.npz"))
    bn = tree["params"]["decoder"]["output_bn"]
    bn["scale"][1:] *= COORD_SCALE
    bn["bias"][1:] *= COORD_SCALE
    vae_npz = os.path.join(tmp, "vae-cells.npz")
    save_npz(vae_npz, tree)
    out = os.path.join(tmp, "gen-cgcnn")
    spec = ",".join(f"{prop}={ckpt}" for prop, ckpt in ckpts.items())
    sync()
    reset_counts()
    t0 = time.perf_counter()
    generate.main(["--data", os.path.join(tmp, "data"), "--base", "syn-1",
                   "--vae-ckpt", vae_npz, "--unet-ckpt", os.path.join(tmp, "unet.npz"),
                   "--nsamples", str(BATCH), "--batch-size", str(BATCH),
                   "--device", DEVICE, "--fused", "--output", out,
                   "--binary-threshold", str(CGCNN_OCCUPANCY),
                   "--merge-closer-than", str(CGCNN_MERGE), "--cgcnn-ckpt", spec])
    sync()
    secs = time.perf_counter() - t0
    counts = read_counts()
    want = ENCODER_CONVS + DECODER_CONVS + UNET_CONVS
    check(counts["fwd"] == want, f"generate --cgcnn-ckpt: {counts['fwd']} conv "
          f"launches, want {want}")
    check((counts["cc"], counts["bfs"]) == (2, 1), f"generate --cgcnn-ckpt: "
          f"extraction launches E1 {counts['cc']} E2 {counts['bfs']}, want 2 and 1")
    with open(os.path.join(out, "results.json")) as f:
        rows = json.load(f)
    check(len(rows) == BATCH, f"generate --cgcnn-ckpt: {len(rows)} records")
    scored = [r for r in rows if 1 <= len(r.get("atoms") or []) <= 50]
    for r in scored:
        props = r.get("properties") or {}
        check(set(props) == set(ckpts) and all(np.isfinite(v) for v in props.values()),
              f"generate --cgcnn-ckpt: a structure of {len(r['atoms'])} atoms has "
              f"properties {props}")
    check(len(scored) > 0, "generate --cgcnn-ckpt: no structure to score: atoms "
          f"{sorted(len(r.get('atoms') or []) for r in rows)}, cells "
          f"{[[round(v, 2) for v in r['lattice']] for r in rows[:4]]}")
    n_valid = sum(bool(r.get("valid")) for r in rows)
    lat = np.asarray([r["lattice"] for r in rows])
    print(f"[generate-cgcnn] generate --fused --binary-threshold {CGCNN_OCCUPANCY} "
          f"--merge-closer-than {CGCNN_MERGE} --cgcnn-ckpt {'+'.join(ckpts)}: "
          f"{BATCH} samples in {secs:.3f} s ({card}), cells {lat.min():.2f}.."
          f"{lat.max():.2f} A, atoms {sorted(len(r.get('atoms') or []) for r in rows)}; "
          f"{len(scored)} structures of "
          f"1..50 atoms scored ({n_valid} valid), "
          f"{sum(len(r.get('atoms') or []) > 50 for r in rows)} larger skipped; conv "
          f"launches {counts['fwd']} = {want} expected")
    return counts


def phase_evaluate(tmp: str, synthetic: str, card: str):
    """``apps.evaluate.main`` on the synthetic build (sites and site_z
    stored) at batch 10 with the seeded models, on the card and on the
    CPU: every validation sample evaluated or skipped, one K1 ``bias`` and
    23 folded launches per batch, the same n_evaluated and lattices within
    1e-2 relative on the CPU.  The U-Net part is held on its own: the
    card's and the CPU's U-Net segment the CPU's reconstruction of the
    first batch, and their occupancy masks must agree on at least 0.99 of
    the voxels, and their labels on at least 0.99 of the voxels both call
    occupied (the card computes in bfloat16, the CPU in float32).  A
    second card run under torch.profiler gives the device's busy time.
    Returns the first card run's launches."""
    import numpy as np
    import torch

    from icsg3d_torch.apps import common, evaluate
    from icsg3d_torch.apps.generate import segment_grids
    from icsg3d_torch.config import GridSpec, PipelineConfig, UNetConfig, VAEConfig
    from icsg3d_torch.data.binning import bin_and_encode
    from icsg3d_torch.data.splits import data_split
    from icsg3d_torch.data.store import BatchIterator, GridDataset

    ds = GridDataset(synthetic)
    _, val_ids = data_split(ds.ids, n=EVAL_SAMPLES, frac=0.8, n_rot=0)
    n_batches = -(-len(val_ids) // EVAL_BATCH)
    vae_npz, unet_npz = (os.path.join(tmp, f) for f in ("vae.npz", "unet.npz"))

    def argv(dev):
        return ["--data", synthetic, "--vae-ckpt", vae_npz, "--unet-ckpt", unet_npz,
                "--batch-size", str(EVAL_BATCH), "--samples", str(EVAL_SAMPLES),
                "--device", dev, "--output", os.path.join(tmp, f"eval-{dev}.json")]

    out, secs = {}, {}
    for dev in (DEVICE, "cpu"):
        sync()
        reset_counts()
        t0 = time.perf_counter()
        out[dev] = _quiet(evaluate.main, argv(dev))
        sync()
        secs[dev] = time.perf_counter() - t0
        if dev == DEVICE:
            counts = read_counts()
    res, cpu = out[DEVICE], out["cpu"]
    check(res["n_evaluated"] + res["n_skipped"] == len(val_ids),
          f"evaluate: {res['n_evaluated']} evaluated + {res['n_skipped']} skipped of "
          f"{len(val_ids)}")
    per_batch = {"bias": 1, "folded": len(VAE_CONVS) - 1 + UNET_CONVS}
    want = {**NO_LAUNCHES, "fwd": n_batches * sum(per_batch.values()),
            **{key: n_batches * n for key, n in per_batch.items()}}
    check(counts == want, f"evaluate: launches {counts}, want {want}")
    check(res["n_evaluated"] == cpu["n_evaluated"],
          f"evaluate: {res['n_evaluated']} evaluated on the card, {cpu['n_evaluated']} "
          "on the CPU")
    lg, lc = (np.asarray(r["lattice_pred"], np.float64) for r in (res, cpu))
    lat_rel = float(np.max(np.abs(lg - lc) / np.abs(lc))) if len(lc) else 0.0
    check(lat_rel <= 1e-2, f"evaluate: lattices card vs CPU rel {lat_rel:.3e} > 1e-2")

    # the U-Net segment of the first batch on the same input: the CPU's
    # reconstruction of the CLI's first batch (ids padded with the last,
    # its conditions, its generator's first noise draw)
    pipe = PipelineConfig(grid=GridSpec(d=D))
    ids = (val_ids + val_ids[-1:] * EVAL_BATCH)[:EVAL_BATCH]
    _, conds, _ = bin_and_encode(np.asarray(ds.arrays["target"]), 10)
    batch = next(iter(BatchIterator(ds, ids, EVAL_BATCH, fields=("density", "coords"))))
    cond = torch.from_numpy(conds[[ds.index[sid] for sid in ids]])
    eps = torch.randn((EVAL_BATCH, 256), generator=torch.Generator().manual_seed(SEED))
    vae = common.load_vae(VAEConfig(grid=GridSpec(d=D), dtype="float32"), vae_npz,
                          device="cpu")
    seg = {}
    with torch.inference_mode():
        recon = vae(torch.from_numpy(common.grid_input(batch["density"],
                                                       batch["coords"])), cond, eps)[0]
        for dev in (DEVICE, "cpu"):
            dtype = common.compute_dtype(torch.device(dev))
            unet = common.load_unet(UNetConfig(dtype=dtype), unet_npz, device=dev)
            _, _, _, labels, binary = segment_grids(unet, pipe, recon.to(dev))
            seg[dev] = (labels.cpu().numpy(), binary.cpu().numpy())
            del unet
    del vae, recon
    (lab_g, bin_g), (lab_c, bin_c) = seg[DEVICE], seg["cpu"]
    occ_agree = float(np.mean(bin_g == bin_c))
    both = (bin_g > 0) & (bin_c > 0)
    lab_agree = float(np.mean(lab_g[both] == lab_c[both])) if both.any() else 1.0
    check(occ_agree >= 0.99, f"evaluate: U-Net occupancy card vs CPU agrees on "
          f"{occ_agree:.5f} < 0.99 of the voxels")
    check(lab_agree >= 0.99, f"evaluate: U-Net labels card vs CPU agree on "
          f"{lab_agree:.5f} < 0.99 of the {int(both.sum())} voxels both call occupied")

    print(f"[evaluate] evaluate.main --samples {EVAL_SAMPLES} at batch {EVAL_BATCH} "
          f"({card}), a smoke timing with the weight loads inside it, not a rate: "
          f"{len(val_ids)} validation samples ({n_batches} batch of {EVAL_BATCH}, the "
          f"last padded) in {secs[DEVICE]:.3f} s on the card, {secs['cpu']:.3f} s on "
          f"the CPU; n_evaluated {res['n_evaluated']} (the same on the CPU), n_skipped "
          f"{res['n_skipped']}, n_emd_undefined {res['n_emd_undefined']}, mean EMD "
          f"{res['mean_emd']}, mean datoms {res['mean_datoms']}; launches {counts} = "
          f"expected; lattice max rel {lat_rel:.3e}; U-Net segment of the first batch, "
          f"card vs CPU on the CPU's reconstruction: occupancy agrees on "
          f"{occ_agree:.5f} of {bin_c.size} voxels, labels on {lab_agree:.5f} of the "
          f"{int(both.sum())} both call occupied")
    profile_step(lambda: _quiet(evaluate.main, argv(DEVICE)), secs[DEVICE] * 1e3,
                 "evaluate-profile", card, what=f"evaluate.main run ({len(val_ids)} "
                 "samples, weight loads included)")
    return counts


@contextlib.contextmanager
def plots_off():
    """The phases that count a trainer's launches exactly count its
    training alone: inside this block the trainers draw no best-val plots
    (the card's machine has no matplotlib anyway).  ``phase_plots`` counts
    the plot forwards where matplotlib imports."""
    from icsg3d_torch import viz

    available = viz.available
    viz.available = lambda: False
    try:
        yield
    finally:
        viz.available = available


def _seconds(fn, *args):
    """(fn(*args), wall seconds of it, the device synchronised)."""
    sync()
    t0 = time.perf_counter()
    out = fn(*args)
    sync()
    return out, time.perf_counter() - t0


def phase_interpolate(tmp: str, synthetic: str, card: str):
    """``apps.interpolate.main`` with the trained VAE checkpoint on the
    synthetic build: a pair (--ninterps 10) and the per-bin sweep.  Each
    strip is (12, 32, 32, 32, 4), finite, its endpoints bitwise the input
    grids; one strip per bin of two or more members; K1 ``bias`` once and
    K3 four times per encode batch, K3 five times per decode batch.  One
    pair on the card against the CPU (same weights; bfloat16 convs on the
    card, float32 on the CPU): the decoded frames within 2e-2 of max|CPU|,
    each channel against its own.  Returns the two runs' launches."""
    import numpy as np
    import torch

    from icsg3d_torch.apps import common, interpolate
    from icsg3d_torch.config import GridSpec, VAEConfig
    from icsg3d_torch.data.binning import bin_and_encode
    from icsg3d_torch.data.store import GridDataset

    ds = GridDataset(synthetic)
    bin_idx, conds, _ = bin_and_encode(np.asarray(ds.arrays["target"]), 10)
    ckpt = os.path.join(tmp, "vae-ckpt")
    base = ["--data", synthetic, "--vae-ckpt", ckpt, "--ninterps", str(INTERPS),
            "--device", DEVICE]
    encode = {"bias": 1, "folded": ENCODER_CONVS - 1}
    decode = {"folded": DECODER_CONVS}

    def want(n_strips, n_encodes):
        w = dict(NO_LAUNCHES, bias=n_encodes * encode["bias"],
                 folded=n_strips * decode["folded"] + n_encodes * encode["folded"])
        w["fwd"] = w["bias"] + w["folded"]
        return w

    def check_strip(row, ia, ib, label):
        check(row.shape == (INTERPS + 2, D, D, D, 4) and bool(np.isfinite(row).all()),
              f"interpolate {label}: strip {row.shape}, finite {np.isfinite(row).all()}")
        for end, i in ((row[0], ia), (row[-1], ib)):
            x = common.grid_input(np.asarray(ds.arrays["density"][i])[None],
                                  np.asarray(ds.arrays["coords"][i])[None])[0]
            check(np.array_equal(end, x), f"interpolate {label}: an endpoint is not "
                  "the input grid")

    ids = ds.ids[:2]
    out = os.path.join(tmp, "interp-pair")
    reset_counts()
    grids, pair_s = _seconds(interpolate.main, base + ["--a", ids[0], "--b", ids[1],
                                                       "--output", out])
    pair = read_counts()
    check(pair == want(1, 2), f"interpolate pair: launches {pair}, want {want(1, 2)}")
    check_strip(grids, ds.index[ids[0]], ds.index[ids[1]], "pair")
    check(np.array_equal(np.load(os.path.join(out, "interpolation.npy")), grids),
          "interpolate pair: interpolation.npy is not the strip")

    out = os.path.join(tmp, "interp-sweep")
    reset_counts()
    (rows, meta), sweep_s = _seconds(interpolate.main,
                                     base + ["--sweep-conds", "--output", out])
    sweep = read_counts()
    full = [b for b in range(10) if (bin_idx == b).sum() >= 2]
    check([m["bin"] for m in meta] == full, f"interpolate sweep: strips for bins "
          f"{[m['bin'] for m in meta]}, bins with two or more members {full}")
    check(sweep == want(len(rows), len(rows)), f"interpolate sweep: launches {sweep}, "
          f"want {want(len(rows), len(rows))}")
    for row, m in zip(rows, meta):
        check_strip(row, ds.index[m["a"]], ds.index[m["b"]], f"bin {m['bin']}")
    with open(os.path.join(out, "sweep.json")) as f:
        check(json.load(f) == meta, "interpolate sweep: sweep.json differs")

    # one pair, card against the CPU, and the card's time per strip
    ia, ib = ds.index[ids[0]], ds.index[ids[1]]
    x = [common.grid_input(np.asarray(ds.arrays["density"][i])[None],
                           np.asarray(ds.arrays["coords"][i])[None])[0] for i in (ia, ib)]
    strips = {}
    for dev in (DEVICE, "cpu"):
        dtype = common.compute_dtype(torch.device(dev))
        vae = common.load_vae(VAEConfig(grid=GridSpec(d=D), dtype=dtype), ckpt,
                              device=dev)
        strips[dev] = interpolate.interpolate_latents(vae, x[0], conds[ia], x[1],
                                                      conds[ib], INTERPS)
        if dev == DEVICE:
            times = [_seconds(interpolate.interpolate_latents, vae, x[0], conds[ia],
                              x[1], conds[ib], INTERPS)[1] for _ in range(6)][1:]
        del vae
    # each channel (density, three coordinates) against its own max|CPU|
    # over the decoded frames (the endpoints are the inputs on both)
    mids = {dev: s[1:-1].reshape(-1, s.shape[-1]) for dev, s in strips.items()}
    refs = np.abs(mids["cpu"]).max(axis=0)
    errs = np.abs(mids[DEVICE] - mids["cpu"]).max(axis=0)
    check(np.array_equal(strips[DEVICE][[0, -1]], strips["cpu"][[0, -1]]),
          "interpolate: the card's and the CPU's endpoints differ")
    for c, (err, ref) in enumerate(zip(errs, refs)):
        check(err <= 2e-2 * ref, f"interpolate: card vs CPU channel {c} differs by "
              f"{err:.3e} > 2e-2 x its max|CPU| {ref:.3e}")
    per_channel = ", ".join(f"ch{c} {e:.3e} = {e / r:.3e} of {r:.3e}"
                            for c, (e, r) in enumerate(zip(errs, refs)))
    strip_ms = statistics.median(times) * 1e3
    print(f"[interpolate] interpolate.main ({card}): pair ({INTERPS}+2 grids) in "
          f"{pair_s:.3f} s, launches {pair}; --sweep-conds: {len(rows)} strips (bins "
          f"{full}) in {sweep_s:.3f} s, launches {sweep} = expected (K1 bias once and "
          f"K3 {encode['folded']} times per encode batch, K3 {decode['folded']} times "
          f"per decode batch); weight loads inside both; interpolate_latents alone: "
          f"{strip_ms:.3f} ms per strip (median of 5, host clock, synchronised); card "
          f"vs CPU decoded frames, max |diff| per channel against its own max|CPU|: "
          f"{per_channel} (bound 2e-2 each)")
    return pair, sweep


def view_unet(tmp: str, synthetic: str) -> str:
    """The trained U-Net checkpoint with head_soft's background bias
    shifted so that the background class takes over half the probability
    at about half the voxels of the viewed reconstructions (the CPU's, f32,
    with view's noise).  After two epochs at the CLI's learning rate the
    U-Net puts no class over 0.5 anywhere, which leaves every F1 at 0 and
    the card-vs-CPU F1 check empty.  Returns the .npz path."""
    import numpy as np
    import torch

    from icsg3d_torch.apps import common
    from icsg3d_torch.config import GridSpec, UNetConfig, VAEConfig
    from icsg3d_torch.data.binning import bin_and_encode
    from icsg3d_torch.data.splits import data_split
    from icsg3d_torch.data.store import GridDataset
    from icsg3d_torch.weights import load_npz, save_npz

    ds = GridDataset(synthetic)
    _, conds, _ = bin_and_encode(np.asarray(ds.arrays["target"]), 10)
    rows = [ds.index[i] for i in data_split(ds.ids, frac=0.8, n_rot=0)[1][:VIEW_N]]
    cfg = VAEConfig(grid=GridSpec(d=D), dtype="float32")
    vae = common.load_vae(cfg, os.path.join(tmp, "vae-ckpt"), device="cpu")
    ckpt = os.path.join(tmp, "unet-ckpt", "best.npz")
    unet = common.load_unet(UNetConfig(dtype="float32"), ckpt, device="cpu")
    gen = torch.Generator().manual_seed(SEED)  # view's noise, in view's order
    eps = torch.cat([torch.randn((1, cfg.latent_dim), generator=gen) for _ in rows])
    x = common.grid_input(np.asarray(ds.arrays["density"][rows]),
                          np.asarray(ds.arrays["coords"][rows]))
    with torch.inference_mode():
        recon = vae(torch.from_numpy(x), torch.from_numpy(conds[rows]), eps)[0]
        soft = unet(recon)[0].double()
    margin = soft[..., 0] - torch.logsumexp(soft[..., 1:], dim=-1)
    tree = load_npz(ckpt)
    tree["params"]["head_soft"]["bias"][0] -= float(margin.median())
    path = os.path.join(tmp, "unet-view.npz")
    save_npz(path, tree)
    return path


def phase_view(tmp: str, synthetic: str, card: str):
    """``apps.view.main`` on VIEW_N validation samples of the synthetic
    build with the trained VAE and the trained U-Net (its background bias
    shifted, ``view_unet``), on the card and on the CPU with the same
    --seed (the same noise): one K1 ``bias`` and 23 K3 launches per
    sample, mse within 2e-2 relative and F1 within 0.02 of the CPU's.
    Returns the card run's launches."""
    import numpy as np

    from icsg3d_torch.apps import view

    unet = view_unet(tmp, synthetic)

    def argv(dev):
        return ["--data", synthetic, "--vae-ckpt", os.path.join(tmp, "vae-ckpt"),
                "--unet-ckpt", unet, "--n", str(VIEW_N),
                "--seed", str(SEED), "--device", dev,
                "--output", os.path.join(tmp, f"view-{dev}")]

    recs, secs = {}, {}
    for dev in (DEVICE, "cpu"):
        reset_counts()
        recs[dev], secs[dev] = _seconds(_quiet, view.main, argv(dev))
        if dev == DEVICE:
            counts = read_counts()
    per = {"bias": 1, "folded": len(VAE_CONVS) - 1 + UNET_CONVS}
    want = dict(NO_LAUNCHES, fwd=VIEW_N * sum(per.values()),
                **{k: VIEW_N * n for k, n in per.items()})
    check(counts == want, f"view: launches {counts}, want {want}")
    got, cpu = recs[DEVICE], recs["cpu"]
    check([r["id"] for r in got] == [r["id"] for r in cpu] and len(got) == VIEW_N,
          f"view: ids {[r['id'] for r in got]} vs {[r['id'] for r in cpu]}")
    check(all(np.isfinite([r["mse"], r["f1"]]).all() for r in got),
          f"view: non-finite records {got}")
    mse_rel = max(abs(g["mse"] - c["mse"]) / abs(c["mse"]) for g, c in zip(got, cpu))
    f1_abs = max(abs(g["f1"] - c["f1"]) for g, c in zip(got, cpu))
    check(mse_rel <= 2e-2, f"view: mse card vs CPU rel {mse_rel:.3e} > 2e-2")
    check(f1_abs <= 0.02, f"view: F1 card vs CPU differs by {f1_abs:.4f} > 0.02")
    check(all(r["f1"] > 0 for r in cpu), f"view: an F1 of 0 on the CPU {cpu}")
    print(f"[view] view.main --n {VIEW_N} ({card}), a smoke timing with the weight "
          f"loads inside it: {secs[DEVICE]:.3f} s on the card = "
          f"{secs[DEVICE] / VIEW_N:.3f} s per sample, {secs['cpu']:.3f} s on the CPU; "
          f"records {[(r['id'], round(r['mse'], 5), round(r['f1'], 4)) for r in got]}; "
          f"card vs CPU mse max rel {mse_rel:.3e} (bound 2e-2), F1 max |diff| "
          f"{f1_abs:.4f} (bound 0.02); launches {counts} = expected")
    return counts


def phase_plots(tmp: str, synthetic: str, card: str):
    """The plots rule at production width.  Without matplotlib (the card's
    machine): both trainers print the skip line once, write history.json
    and no plot, and train with exactly their training launches;
    ``evaluate --plots`` and ``interpolate --voxels`` exit with a usage
    error naming matplotlib.  With it: the trainers write loss.png and
    their best-val plots (the plot forwards' launches counted: VAE one
    ``bias`` and 14 folded, U-Net 14 folded per refresh), ``evaluate
    --plots`` its seven PNGs, interpolate its strip PNGs.  Returns the
    trainers' launches."""
    import contextlib
    import io

    from icsg3d_torch import viz
    from icsg3d_torch.apps import evaluate, interpolate, train_unet, train_vae

    have = viz.available()
    n_unet = PLOTS_UNET_SAMPLES
    runs = [
        ("vae", train_vae, ["--data", os.path.join(tmp, "train-data"), "--unet-ckpt",
                            os.path.join(tmp, "unet.npz"), "--batch-size", str(BATCH)],
         TRAIN_PARENTS, BATCH, {"fwd": FWD_PER_STEP, "bias": FWD_PER_STEP,
                                "dx": DX_PER_STEP, "dw": DW_PER_STEP},
         {"fwd": FWD_PER_STEP, "bias": 1 + 2 * len(UNET_PREFIX),
          "folded": len(VAE_CONVS) - 1},
         {"bias": 1, "folded": len(VAE_CONVS) - 1 + DECODER_CONVS},
         ["latent_kde.png", "reconstructions.png", "samples.png"]),
        ("unet", train_unet, ["--data", synthetic, "--samples", str(n_unet),
                              "--batch-size", str(UNET_BATCH)],
         n_unet, UNET_BATCH, {"fwd": UNET_CONVS_N, "bias": UNET_CONVS_N,
                              "dx": UNET_CONVS_N - 1, "dw": UNET_CONVS_N},
         {"fwd": UNET_CONVS_N, "folded": UNET_CONVS_N}, {"folded": UNET_CONVS_N},
         ["segmentations_best.png", "segmentations_binary_best.png"]),
    ]
    total = dict(NO_LAUNCHES)
    notes = []
    for label, app, argv, parents, batch, per_train, per_eval, per_plot, pngs in runs:
        ckpt = os.path.join(tmp, f"plots-{label}")
        out = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(out):
            hist, secs = _seconds(app.main, argv + [
                "--epochs", "1", "--nrot", "0", "--device", DEVICE, "--ckpt", ckpt,
                "--seed", str(SEED), "--plot-every", "1"])
        counts = read_counts()
        n_train = int(0.8 * parents) // batch
        n_val = (parents - int(0.8 * parents)) // batch
        # one epoch: its finite val loss is the first best, one refresh
        events = 1 if have else 0
        want = dict(NO_LAUNCHES)
        for per, n in ((per_train, n_train), (per_eval, n_val), (per_plot, events)):
            for key, k in per.items():
                want[key] += n * k
        want["fwd"] += events * sum(per_plot.values())
        check(counts == want, f"plots {label}: launches {counts}, want {want} "
              f"({n_train} train + {n_val} eval steps, {events} plot refreshes)")
        skips = out.getvalue().count(viz.PLOTS_SKIPPED)
        files = set(os.listdir(ckpt))
        check("history.json" in files and len(hist) == 1, f"plots {label}: history")
        if have:
            check(skips == 0 and "loss.png" in files and events == 1
                  and sorted(os.listdir(os.path.join(ckpt, "plots"))) == pngs,
                  f"plots {label}: files {sorted(files)}, {events} refreshes")
        else:
            check(skips == 1 and not {"loss.png", "plots"} & files,
                  f"plots {label}: {skips} skip lines, files {sorted(files)}")
        total = {key: total[key] + counts[key] for key in total}
        notes.append(f"{label} 1 epoch in {secs:.3f} s, {skips} skip line, "
                     f"{events} plot refreshes, launches {counts} = expected")

    eval_argv = ["--data", synthetic, "--vae-ckpt", os.path.join(tmp, "vae.npz"),
                 "--unet-ckpt", os.path.join(tmp, "unet.npz"), "--batch-size",
                 str(EVAL_BATCH), "--samples", str(EVAL_SAMPLES), "--device", DEVICE,
                 "--plots", os.path.join(tmp, "eval-plots")]
    interp_argv = ["--data", synthetic, "--vae-ckpt", os.path.join(tmp, "vae-ckpt"),
                   "--sweep-conds", "--voxels", "--device", DEVICE]
    if have:
        _quiet(evaluate.main, eval_argv)
        made = sorted(os.listdir(os.path.join(tmp, "eval-plots")))
        check(made == sorted([f"{k}_{a}.png" for k in ("parity", "err_hist")
                              for a in "abc"] + ["emd_hist.png"]),
              f"evaluate --plots wrote {made}")
        strips = [f for f in os.listdir(os.path.join(tmp, "interp-sweep"))
                  if f.endswith(".npy")]
        check(all(os.path.exists(os.path.join(tmp, "interp-sweep", f[:-4] + ".png"))
                  for f in strips), "interpolate: a strip has no PNG")
        notes.append(f"evaluate --plots wrote {len(made)} PNGs; interpolate's "
                     f"{len(strips)} strips have their PNGs")
    else:
        for name, app, argv in (("evaluate --plots", evaluate, eval_argv),
                                ("interpolate --voxels", interpolate, interp_argv)):
            err = io.StringIO()
            reset_counts()
            with contextlib.redirect_stderr(err):
                try:
                    app.main(argv)
                    code = 0
                except SystemExit as e:
                    code = e.code
            check(code == 2 and "matplotlib is not installed" in err.getvalue()
                  and read_counts() == NO_LAUNCHES,
                  f"{name} without matplotlib: exit {code}, {err.getvalue()!r}")
            notes.append(f"{name} exits 2 before any load: "
                         f"{err.getvalue().strip().splitlines()[-1]!r}")
    print(f"[plots] matplotlib {'imports' if have else 'is not installed'} here "
          f"({card}): " + "; ".join(notes))
    return total


def phase_profiling(tmp: str, synthetic: str, card: str):
    """``utils/profiling.StepTimer`` over PROFILE_STEPS train steps of the
    VAE (batch 20, the seeded 95-class U-Net for the DFC loss) and of the
    U-Net (batch 10): step ms, grids/s and MFU from the analytic FLOP count
    against the dense bf16 peak; ``profiling.trace`` around one more step
    must write a non-empty Chrome trace."""
    import numpy as np
    import torch

    from icsg3d_torch.apps import common
    from icsg3d_torch.config import GridSpec, UNetConfig, VAEConfig
    from icsg3d_torch.data.store import GridDataset
    from icsg3d_torch.train.unet import create_unet_state, make_unet_steps, prepare_unet_batch
    from icsg3d_torch.train.vae import create_vae_state, make_vae_steps
    from icsg3d_torch.utils import profiling

    vcfg, ucfg = VAEConfig(grid=GridSpec(d=D)), UNetConfig()
    unet = common.load_unet(ucfg, os.path.join(tmp, "unet.npz"), device=DEVICE)
    vstate = create_vae_state(vcfg, 5e-4, SEED, DEVICE)
    vae_train, _ = make_vae_steps(vstate.model, unet)
    train_ds = GridDataset(os.path.join(tmp, "train-data"))
    cond = np.zeros((BATCH, vcfg.cond_bins), np.float32)
    cond[np.arange(BATCH), np.arange(BATCH) % vcfg.cond_bins] = 1.0
    vbatch = {"density": torch.from_numpy(np.array(train_ds.arrays["density"][:BATCH])),
              "abc": torch.from_numpy(np.array(train_ds.arrays["lattice"][:BATCH, :3])),
              "cond": torch.from_numpy(cond)}
    vbatch = {k: v.to(DEVICE) for k, v in vbatch.items()}
    eps = torch.randn(BATCH, vcfg.latent_dim, generator=torch.Generator().manual_seed(
        SEED + 6)).to(DEVICE)
    ustate = create_unet_state(ucfg, 3e-6, SEED, DEVICE)
    unet_train, _ = make_unet_steps(ustate.model)
    ds = GridDataset(synthetic)
    raw = {k: np.asarray(ds.arrays[k][:UNET_BATCH]) for k in ("density", "lattice",
                                                              "species")}
    ubatch = {k: torch.from_numpy(v).to(DEVICE)
              for k, v in prepare_unet_batch(raw, 95, device_coords=True).items()}
    steps = [
        ("VAE", lambda: vae_train(vstate, vbatch, eps), BATCH,
         profiling.vae_train_step_flops(vcfg, ucfg, BATCH)),
        ("U-Net", lambda: unet_train(ustate, ubatch), UNET_BATCH,
         profiling.unet_train_step_flops(ucfg, D, UNET_BATCH)),
    ]
    for label, step, batch, flops in steps:
        timer = profiling.StepTimer(batch, flops_per_step=flops, warmup=2,
                                    device=DEVICE)
        for _ in range(PROFILE_STEPS):
            step()
            stats = timer.tick()
        check(stats is not None and np.isfinite(stats["mfu"]) and stats["mfu"] > 0,
              f"profiling {label}: StepTimer gave {stats}")
        log_dir = os.path.join(tmp, f"trace-{label}")
        with profiling.trace(log_dir):
            step()
            sync()
        size = os.path.getsize(os.path.join(log_dir, "trace.json"))
        check(size > 0, f"profiling {label}: empty trace")
        print(f"[profiling] {label} train step at batch {batch} ({card}), StepTimer "
              f"over {PROFILE_STEPS - 2} steps after 2 of warm-up: "
              f"{stats['step_ms']:.3f} ms per step, {stats['items_per_sec']:.2f} "
              f"grids/s, {flops / 1e9:.3f} GFLOP per step (analytic), MFU "
              f"{stats['mfu']:.4f} of the dense bf16 peak "
              f"{profiling.PEAK_FLOPS['h100'] / 1e12:.1f} TFLOP/s; trace() wrote "
              f"{size} bytes")


# -- data parallelism across processes ------------------------------------------
# Rank workers are this script again (``--dp-worker SPEC``) under
# ``python -m torch.distributed.run --standalone``: the launch counters are
# per process, so each rank writes its results (histories, read_counts(),
# the files it wrote, step checks) to rank<r>.json and its arrays to
# rank<r>.npz, and the phase reads them.

DP_RANKS = 2  # the gloo phases: two ranks on cuda:0
DP_LAUNCH_TIMEOUT_S = 300
DP_ONE_BACKEND = "nccl"  # the backend of the phases with a rank per card
# phase 27's trainer runs: Adam moves every weight by ~lr whatever its
# gradient, so a last-bit difference in a near-zero gradient (another
# summation order) flips a step's sign; these small rates keep such flips
# from drowning the comparison of the histories (as
# tests/test_torch_spatial_train.py does on the CPU); the steps' own check
# holds the gradients
DP_LR = {"train_vae": "1e-5", "train_unet": "1e-7"}
# [0, 1] ratios of voxel counts (the voxels whose true-class probability
# rounds to 1): a voxel crossing p = 0.5 moves them by a step, so they are
# held to 1e-3 absolute where the other metrics are held relative
COUNT_METRICS = ("f1", "weighted_recall")


def dp_device() -> str:
    """The card every rank of the gloo phases names: cuda:0."""
    return "cuda:0" if DEVICE == "cuda" else DEVICE


def torchrun(nproc: int, jobs: list, tmp: str, tag: str):
    """Run ``jobs`` on ``nproc`` ranks of this script; returns (each rank's
    results, each rank's arrays, wall seconds).  A rank that fails, or a
    launch that outlives DP_LAUNCH_TIMEOUT_S, fails the smoke test; the
    launch's whole process group is killed on the way out."""
    import signal

    import numpy as np

    out = os.path.join(tmp, f"{tag}-ranks")
    os.makedirs(out)
    spec = os.path.join(out, "spec.json")
    with open(spec, "w") as f:
        json.dump({"jobs": jobs, "out": out}, f)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), os.path.abspath(__file__), "--dp-worker", spec]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        stdout, stderr = proc.communicate(timeout=DP_LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"{tag}: {nproc} ranks outlived {DP_LAUNCH_TIMEOUT_S} s")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    secs = time.perf_counter() - t0
    with open(os.path.join(out, "ranks.log"), "w") as f:
        f.write(stdout + stderr)
    check(proc.returncode == 0, f"{tag}: torchrun exited {proc.returncode}:\n"
          f"{stderr[-3000:]}")
    results, arrays = [], []
    for r in range(nproc):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            results.append(json.load(f))
        with np.load(os.path.join(out, f"rank{r}.npz")) as f:
            arrays.append({k: f[k] for k in f.files})
    return results, arrays, secs


def vae_step_batch(tmp: str, device):
    """The VAE step checks' global batch: the first BATCH parents of the
    training set, cyclic condition bins, seeded noise."""
    import numpy as np
    import torch

    from icsg3d_torch.data.store import GridDataset

    ds = GridDataset(os.path.join(tmp, "train-data"))
    cond = np.zeros((BATCH, 10), np.float32)
    cond[np.arange(BATCH), np.arange(BATCH) % 10] = 1.0
    batch = {"density": torch.from_numpy(np.array(ds.arrays["density"][:BATCH])),
             "abc": torch.from_numpy(np.array(ds.arrays["lattice"][:BATCH, :3])),
             "cond": torch.from_numpy(cond)}
    eps = torch.randn(BATCH, 256, generator=torch.Generator().manual_seed(SEED + 9))
    return {k: v.to(device) for k, v in batch.items()}, eps.to(device)


def unet_step_batch(synthetic: str, device):
    """The U-Net step checks' global batch: the first UNET_BATCH samples of
    the synthetic build."""
    import numpy as np
    import torch

    from icsg3d_torch.data.store import GridDataset
    from icsg3d_torch.train.unet import prepare_unet_batch

    ds = GridDataset(synthetic)
    raw = {k: np.asarray(ds.arrays[k][:UNET_BATCH]) for k in ("density", "lattice",
                                                              "species")}
    return {k: torch.from_numpy(v).to(device)
            for k, v in prepare_unet_batch(raw, 95, device_coords=True).items()}


def dp_step_models(model: str, job: dict, device, group):
    """(fresh seeded train state, its train step, its step arguments at the
    global batch) for the step checks, computing in ``job["dtype"]``."""
    import numpy as np

    from icsg3d_torch.apps.common import load_unet
    from icsg3d_torch.config import GridSpec, UNetConfig, VAEConfig
    from icsg3d_torch.train.unet import create_unet_state, make_unet_steps
    from icsg3d_torch.train.vae import create_vae_state, make_vae_steps

    dt = job["dtype"]
    if model == "vae":
        unet = load_unet(UNetConfig(dtype=dt), job["unet"], device=device)
        state = create_vae_state(VAEConfig(grid=GridSpec(d=D), dtype=dt), 5e-4, SEED,
                                 device, group=group)
        batch, eps = vae_step_batch(job["tmp"], device)
        return state, make_vae_steps(state.model, unet)[0], (batch, eps)
    with open(job["class_weights"]) as f:
        cw = np.asarray(json.load(f)["class_weights"], np.float32)
    state = create_unet_state(UNetConfig(dtype=dt), 3e-6, SEED, device, group=group)
    return state, make_unet_steps(state.model, cw)[0], (unet_step_batch(
        job["synthetic"], device),)


class _Tee(io.StringIO):
    """A text buffer that also writes through to ``stream``."""

    def __init__(self, stream):
        super().__init__()
        self.stream = stream

    def write(self, text):
        self.stream.write(text)
        return super().write(text)


def dp_job_cli(job: dict, arrays: dict) -> dict:
    """One CLI run on this rank (computing in ``job["dtype"]`` where given,
    ``f32_cli``): its history (or dataset size), launches, wall seconds,
    the files it opened for writing under ``job["watch"]``, and (trainers)
    its model's BatchNorm statistics in ``arrays``."""
    import builtins
    import importlib

    from icsg3d_torch.train import graphs
    from icsg3d_torch.train.checkpoints import CheckpointManager

    app = importlib.import_module(f"icsg3d_torch.apps.{job['app']}")
    watch = os.path.abspath(job["watch"])
    writes, states = [], []
    real_open, real_makedirs = builtins.open, os.makedirs
    save_epoch = CheckpointManager.save_epoch

    def log(path):
        path = os.path.abspath(os.fspath(path))
        if path == watch or path.startswith(watch + os.sep):
            writes.append(os.path.relpath(path, watch))

    def logged_open(file, mode="r", *args, **kwargs):
        if isinstance(file, (str, bytes, os.PathLike)) and set(mode) & set("wax+"):
            log(file)
        return real_open(file, mode, *args, **kwargs)

    def logged_makedirs(name, *args, **kwargs):
        log(name)
        return real_makedirs(name, *args, **kwargs)

    def keep_state(self, state, *args, **kwargs):
        states[:] = [state]
        return save_epoch(self, state, *args, **kwargs)

    builtins.open, os.makedirs = logged_open, logged_makedirs
    CheckpointManager.save_epoch = keep_state
    printed = _Tee(sys.stdout)
    try:
        with plots_off(), f32_cli(job.get("dtype") == "float32"), \
                contextlib.redirect_stdout(printed):
            sync()
            reset_counts()
            graphs.reset_captures()
            result, secs = _seconds(app.main, job["argv"])
            counts = captured_counts()
    finally:
        builtins.open, os.makedirs = real_open, real_makedirs
        CheckpointManager.save_epoch = save_epoch
    out = {"counts": counts, "seconds": secs, "writes": writes,
           "captures": [(c.name, c.replays) for c in graphs.captures],
           "refusals": [ln for ln in printed.getvalue().splitlines()
                        if ln.startswith("--epoch-scan")]}
    if isinstance(result, list):
        out["history"] = result
    else:
        out["samples"] = len(result)
    if states:
        for name, t in states[0].model.named_buffers():
            arrays[f"{job['watch']}/{name}"] = t.detach().cpu().numpy()
    return out


def dp_job_step(job: dict, arrays: dict) -> dict:
    """One train step of ``job["model"]`` at this rank's rows of the global
    batch, from the seeded weights.  With ``job["timed"]``: the gradient
    all-reduce's CUDA-event median, the step's, and on rank 0 (the others
    waiting) the same step without a process group at the global batch, in
    turns.  Then on rank 0 the step at world 1 on the whole batch from the
    same weights: its loss, and for each parameter the gradient difference
    (the ranks' values are the global batch's after the all-reduces) in
    l2 norm over the world-1 gradient's, its largest element over the
    world-1 gradient's max, and both gradients' maxima."""
    import torch

    from icsg3d_torch.parallel import distributed, shard_batch

    device = torch.device(dp_device())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    group = distributed.initialize(backend=job["backend"])
    rank0 = distributed.process_index() == 0
    state, step, args = dp_step_models(job["model"], job, device, group)
    mine = tuple(shard_batch(a, group) for a in args)
    mets = step(state, *mine)
    grads = {n: p.grad.detach().double() for n, p in state.model.named_parameters()}
    # grad_bytes: the flat f32 buffer that reduce_gradients all-reduces
    out = {"loss": float(mets["loss"]),
           "grad_bytes": 4 * sum(g.numel() for g in grads.values())}
    if job["timed"]:
        out["reduce_ms"] = cuda_median_ms(state.reduce_gradients, runs=10)
        plain, plain_step, _ = (dp_step_models(job["model"], job, device, None)
                                if rank0 else (None, None, None))
        times = {"group": [], "plain": []}
        for name in ("plain", "group", "group", "plain"):
            if name == "group":
                times[name].append(cuda_median_ms(lambda: step(state, *mine), runs=5,
                                                  warmup=1))
            else:
                if rank0:
                    times[name].append(cuda_median_ms(
                        lambda: plain_step(plain, *args), runs=5, warmup=1))
                distributed.sync_hosts(group)
        out["step_ms"] = {k: statistics.mean(v) if v else None for k, v in times.items()}
        del plain
    del state
    if rank0:
        one, one_step, _ = dp_step_models(job["model"], job, device, None)
        one_mets = one_step(one, *args)
        out["loss_one"] = float(one_mets["loss"])
        out["mets"], out["mets_one"] = ({k: v.tolist() for k, v in m.items()}
                                        for m in (mets, one_mets))
        out["grad_l2"], out["grad_cos"], out["grad_err"], out["grad_max"] = ({}, {},
                                                                           {}, {})
        for n, p in one.model.named_parameters():
            g1, g = p.grad.detach().double().flatten(), grads[n].flatten()
            diff, scale, norm = g - g1, float(g1.abs().max()), float(g1.norm())
            out["grad_l2"][n] = float(diff.norm()) / max(norm, 1e-30)
            out["grad_cos"][n] = float(g @ g1) / max(float(g.norm()) * norm, 1e-30)
            out["grad_err"][n] = float(diff.abs().max()) / max(scale, 1e-30)
            out["grad_max"][n] = [scale, float(g.abs().max())]
        del one
    torch.cuda.empty_cache()
    distributed.sync_hosts(group)
    return out


def dp_job_epoch_profile(job: dict, arrays: dict) -> dict:
    """On this rank (one NCCL rank on its card): for the VAE at batch 20
    and the U-Net at batch 10, a train state in the process group and on
    it, in turns and then profiled (``epoch_profile``), a per-step epoch,
    a captured epoch (its all-reduces inside the graph) and a captured
    epoch with the group taken off the state and the model (a graph of
    its own, no collective).  Then the group's captured VAE epoch once
    more under sync-debug mode "error", behind a long kernel that must
    still run when its replays return."""
    import torch

    from icsg3d_torch.apps import common
    from icsg3d_torch.config import GridSpec, UNetConfig, VAEConfig
    from icsg3d_torch.parallel import distributed
    from icsg3d_torch.train import unet as tunet
    from icsg3d_torch.train import vae as tvae

    if DEVICE == "cuda":
        torch.cuda.set_device(distributed.local_rank())
    group = distributed.initialize(backend=job["backend"])
    card = job["card"]

    def no_group(state, fn):
        def run():
            state.group = state.model.group = None
            try:
                return fn()
            finally:
                state.group = state.model.group = group
        return run

    out = {"blocking_wait": os.environ.get("TORCH_NCCL_BLOCKING_WAIT")}
    unet = common.load_unet(UNetConfig(num_classes=95), job["unet"], grid_d=D,
                            device=DEVICE)
    data, n = vae_epoch_data(job["tmp"])
    steps = n // BATCH
    state = tvae.create_vae_state(VAEConfig(grid=GridSpec(d=D)), 5e-4, SEED, DEVICE,
                                  group=group)
    train_step, _ = tvae.make_vae_steps(state.model, unet)
    epoch, _ = tvae.make_vae_epoch_fns(state.model, unet)
    plain, _ = tvae.make_vae_epoch_fns(state.model, unet)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    out["vae"] = epoch_profile(f"VAE at batch {BATCH}", [
        ("per-step, group", lambda: _per_step_epoch(
            state, data, steps, BATCH, lambda s, b: train_step(s, b, _noise(gen)),
            _perm_rows)),
        ("captured, group", lambda: _captured_epoch(state, data, steps, BATCH, epoch,
                                                    _noises(gen, steps))),
        ("captured, no group", no_group(state, lambda: _captured_epoch(
            state, data, steps, BATCH, plain, _noises(gen, steps))))],
        steps, card, tag="dp-nccl-epoch-scan-profile")

    # no host sync between the epoch's upload and its fetch
    rows = torch.from_numpy(_perm_rows(steps, BATCH)).to(DEVICE)
    noise = _noises(gen, steps)()
    replays = epoch.capture.replays
    done = torch.cuda.Event()
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.cuda._sleep(2_000_000_000)  # ~1 s of device time
        buf = epoch(state, data, rows, noise)
        done.record()
        running = not done.query()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    fetched = buf.cpu()
    out["sync"] = {"still_running": running, "replays": epoch.capture.replays - replays,
                   "finite": bool(torch.isfinite(fetched).all())}
    del state, epoch, plain, data, unet

    data, n = unet_epoch_data(job["synthetic"])
    steps = n // UNET_BATCH
    ustate = tunet.create_unet_state(UNetConfig(num_classes=95), 3e-6, SEED, DEVICE,
                                     group=group)
    utrain, _ = tunet.make_unet_steps(ustate.model)
    uepoch, _ = tunet.make_unet_epoch_fns(ustate.model)
    uplain, _ = tunet.make_unet_epoch_fns(ustate.model)
    out["unet"] = epoch_profile(f"U-Net at batch {UNET_BATCH}", [
        ("per-step, group", lambda: _per_step_epoch(ustate, data, steps, UNET_BATCH,
                                                    utrain, _perm_rows)),
        ("captured, group", lambda: _captured_epoch(ustate, data, steps, UNET_BATCH,
                                                    uepoch, lambda: None)),
        ("captured, no group", no_group(ustate, lambda: _captured_epoch(
            ustate, data, steps, UNET_BATCH, uplain, lambda: None)))],
        steps, card, tag="dp-nccl-epoch-scan-profile")
    del ustate, uepoch, uplain, data
    torch.cuda.empty_cache()
    return out


def dp_worker(spec_path: str) -> None:
    """A rank of ``torchrun``: runs the spec's jobs, writes the results."""
    import numpy as np

    from icsg3d_torch.parallel import distributed

    with open(spec_path) as f:
        spec = json.load(f)
    rank = int(os.environ["RANK"])
    arrays, results = {}, []
    for job in spec["jobs"]:
        run = {"cli": dp_job_cli, "step": dp_job_step,
               "epoch_profile": dp_job_epoch_profile}[job["kind"]]
        results.append(run(job, arrays))
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "world": distributed.process_count(),
                   "jobs": results}, f)
    np.savez(os.path.join(spec["out"], f"rank{rank}.npz"), **arrays)
    distributed.shutdown()


def _metric_err(key: str, got, want) -> float:
    """The difference of two values of metric ``key`` over its tolerance's
    scale: relative, or absolute for the COUNT_METRICS."""
    import numpy as np

    a, b = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = 1.0 if key.split()[-1] in COUNT_METRICS else np.maximum(np.abs(b), 1e-12)
    return float((np.abs(a - b) / scale).max())


def _history_rel(got: list, want: list) -> dict:
    """{"<split> <metric>": the largest difference over the epochs (see
    ``_metric_err``)} of two histories (their epochs and steps must
    agree)."""
    check(len(got) == len(want) and all(g["steps"] == w["steps"]
                                        for g, w in zip(got, want)),
          f"histories of {len(got)} and {len(want)} epochs differ in shape")
    rels = {}
    for g, w in zip(got, want):
        for split in ("train", "val"):
            check(set(g[split]) == set(w[split]), f"history keys {sorted(g[split])}")
            for key, v in w[split].items():
                name = f"{split} {key}"
                rels[name] = max(rels.get(name, 0.0), _metric_err(key, g[split][key], v))
    return rels


def _first_epoch(ckpt: str) -> list:
    with open(os.path.join(ckpt, "history.json")) as f:
        return json.load(f)[:1]


def _train_argv(tmp: str, synthetic: str, app: str, device: str, backend: str,
                tag: str):
    """One epoch of ``app`` with the arguments of its single-process phase
    (phase_train, phase_train_unet, phase_train_cgcnn's formation energy)."""
    common = ["--epochs", "1", "--device", device, "--dist-backend", backend,
              "--seed", str(SEED), "--ckpt", os.path.join(tmp, f"{tag}-{app}")]
    return common + {
        "train_vae": ["--data", os.path.join(tmp, "train-data"), "--unet-ckpt",
                      os.path.join(tmp, "unet.npz"), "--batch-size", str(BATCH),
                      "--nrot", "0"],
        "train_unet": ["--data", synthetic, "--batch-size", str(UNET_BATCH),
                       "--nrot", "0"],
        "train_cgcnn": ["--synthetic", str(CGCNN_SYNTHETIC), "--synthetic-property",
                        "formation_energy", "--batch-size", str(CGCNN_BATCH)],
    }[app]


def _dp_step_job(tmp: str, synthetic: str, model: str, backend: str, timed: bool,
                 dtype: str = "bfloat16"):
    return {"kind": "step", "model": model, "backend": backend, "timed": timed,
            "dtype": dtype, "tmp": tmp, "unet": os.path.join(tmp, "unet.npz"),
            "synthetic": synthetic,
            "class_weights": os.path.join(tmp, "unet-ckpt", "class_weights.json")}


def phase_dp_nccl(tmp: str, synthetic: str, card: str):
    """``apps.train_vae`` on one rank over NCCL (torchrun, ``--device cuda``
    = cuda:$LOCAL_RANK), one epoch at batch BATCH, against the first epoch
    of phase 6's single-process run from the same seed: every metric equal
    or within rtol 1e-6.  Then the timed VAE step: the gradient buffer's
    bytes, the all-reduce's CUDA-event ms, the step's ms beside the same
    step without a process group.  Returns the rank's launches."""
    argv = _train_argv(tmp, synthetic, "train_vae", DEVICE, DP_ONE_BACKEND,
                       "dp-nccl")
    jobs = [{"kind": "cli", "app": "train_vae", "argv": argv,
             "watch": os.path.join(tmp, "dp-nccl-train_vae")},
            _dp_step_job(tmp, synthetic, "vae", DP_ONE_BACKEND, True)]
    (rank,), _, secs = torchrun(1, jobs, tmp, "dp-nccl")
    cli, step = rank["jobs"]
    check(rank["world"] == 1, f"dp-nccl: world {rank['world']}")
    rel = max(_history_rel(cli["history"],
                           _first_epoch(os.path.join(tmp, "vae-ckpt"))).values())
    check(rel <= 1e-6, f"dp-nccl: history differs from the single-process run by "
          f"rel {rel:.3e} > 1e-6")
    n_train = int(0.8 * TRAIN_PARENTS) // BATCH
    n_val = (TRAIN_PARENTS - int(0.8 * TRAIN_PARENTS)) // BATCH
    want = {**NO_LAUNCHES, "fwd": (n_train + n_val) * FWD_PER_STEP,
            "bias": n_train * FWD_PER_STEP + n_val * (1 + 2 * len(UNET_PREFIX)),
            "folded": n_val * (len(VAE_CONVS) - 1), "dx": n_train * DX_PER_STEP,
            "dw": n_train * DW_PER_STEP}
    check(cli["counts"] == want, f"dp-nccl: launches {cli['counts']}, want {want}")
    ms = step["step_ms"]
    print(f"[dp-nccl] train_vae under torchrun, 1 rank over NCCL ({card}): 1 epoch "
          f"of {n_train} steps + {n_val} val batch at batch {BATCH} in "
          f"{cli['seconds']:.3f} s (launch {secs:.3f} s); history "
          f"{'equal to' if rel == 0 else f'within rel {rel:.3e} of'} the "
          f"single-process run's first epoch; launches {cli['counts']} = expected; "
          f"gradient buffer {step['grad_bytes']} bytes, all-reduce "
          f"{step['reduce_ms']:.4f} ms per step (CUDA-event median of 10); train "
          f"step {ms['group']:.3f} ms with the process group vs {ms['plain']:.3f} ms "
          f"without (CUDA-event medians of 5, in turns)")
    return cli["counts"]


def _op_name(name: str) -> str:
    """A device op's profiler name, short: a torch kernel's functor or
    kernel, a copy's own name."""
    import re

    functors = re.findall(r"(\w+Functor)\b", name)
    if functors:
        return functors[-1]
    m = re.search(r"native::(?:\(anonymous namespace\)::)?(\w+)", name)
    return m.group(1) if m else name


def _timeless(history: list) -> list:
    return [{k: v for k, v in h.items() if k != "time"} for h in history]


def _profile_note(label: str, runs: dict) -> str:
    return f"{label}: " + "; ".join(
        f"{name} {r['wall_ms']:.3f} ms ({r['steps_per_s']:.2f} steps/s, idle "
        f"{r['idle']:.3f}, {r['nccl_per_step']:.1f} NCCL kernels a step "
        f"{r['nccl_kernels']})" for name, r in runs.items())


def phase_dp_nccl_epoch_scan(tmp: str, synthetic: str, card: str, single: dict):
    """``--resident --epoch-scan`` under torchrun on one NCCL rank: the
    three ``epoch_scan_cases`` (the VAE at batch 20 with and without
    ``--cache-true-features``, the U-Net at batch 10, 2 epochs) against the
    same rank's ``--resident`` per-step runs and phase 16a's
    single-process captured runs (``single``): latest.npz and history
    bitwise (the U-Net's CE sums within 1e-5), no refusal line, launches
    as captured x replays equal to the per-step path's and to phase 16a's.
    Then on the rank (``dp_job_epoch_profile``) the wall, steps/s and idle
    share of the per-step, the captured and the no-group captured epoch
    in turns on one state, the NCCL kernels of a profiled captured epoch,
    and no host sync in a captured epoch.  Then the two-card check.
    Returns the rank's launches."""
    cases = epoch_scan_cases(tmp, synthetic)
    jobs = []
    for i, (label, (app, argv)) in enumerate(cases.items()):
        for scan in (0, 1):
            ckpt = os.path.join(tmp, f"dp-nccl-epoch-{i}-{scan}")
            jobs.append({"kind": "cli", "app": app, "watch": ckpt,
                         "argv": argv + ["--dist-backend", DP_ONE_BACKEND, "--ckpt", ckpt]
                         + (["--epoch-scan"] if scan else [])})
    jobs.append({"kind": "epoch_profile", "backend": DP_ONE_BACKEND, "tmp": tmp,
                 "synthetic": synthetic, "card": card,
                 "unet": os.path.join(tmp, "unet.npz")})
    (rank,), _, secs = torchrun(1, jobs, tmp, "dp-nccl-epoch-scan")
    check(rank["world"] == 1, f"dp-nccl-epoch-scan: world {rank['world']}")
    total = dict(NO_LAUNCHES)
    for i, label in enumerate(cases):
        per, cap = rank["jobs"][2 * i], rank["jobs"][2 * i + 1]
        ref = single[label]
        check(not per["refusals"] and not cap["refusals"],
              f"{label}: {per['refusals'] + cap['refusals']}")
        steps = cap["history"][0]["steps"]
        check(not per["captures"] and cap["captures"]
              and cap["captures"][0][1] == EPOCH_SCAN_EPOCHS * steps - 1,
              f"{label}: captures {per['captures']} / {cap['captures']}")
        check(per["counts"] == ref["launches"] and cap["counts"] == per["counts"],
              f"{label}: launches per-step {per['counts']}, captured {cap['counts']}, "
              f"phase 16a {ref['launches']}")
        seen = _same_training(f"dp-nccl {label}", [
            (ref["ckpt"], ref["history"]), (jobs[2 * i]["watch"], per["history"]),
            (jobs[2 * i + 1]["watch"], cap["history"])])
        total = {key: total[key] + per["counts"][key] + cap["counts"][key]
                 for key in total}
        print(f"[dp-nccl-epoch-scan] {label} under torchrun, 1 rank over NCCL, "
              f"--resident --epoch-scan and --resident, {EPOCH_SCAN_EPOCHS} epochs of "
              f"{steps} steps ({card}): no refusal line; both {seen} to the "
              f"single-process captured run of [epoch-scan]; launches {cap['counts']} "
              f"(captured x replays) = the per-step run's = [epoch-scan]'s; captures "
              f"{cap['captures']}; epoch times (s) per-step "
              f"{[round(h['time'], 4) for h in per['history']]}, captured "
              f"{[round(h['time'], 4) for h in cap['history']]}", flush=True)
    prof = rank["jobs"][-1]
    sync_ok = prof["sync"]
    check(prof["blocking_wait"] in (None, "0"),
          f"TORCH_NCCL_BLOCKING_WAIT={prof['blocking_wait']}: a blocking wait cannot "
          "be captured")
    check(sync_ok["still_running"] and sync_ok["finite"]
          and sync_ok["replays"] == int(0.8 * EPOCH_PARENTS) // BATCH,
          f"dp-nccl-epoch-scan: the captured epoch under sync-debug 'error': {sync_ok}")
    extra = {}
    for key, batch in (("vae", BATCH), ("unet", UNET_BATCH)):
        group, plain = (prof[key][n]["names"] for n in ("captured, group",
                                                        "captured, no group"))
        steps = (int(0.8 * (EPOCH_PARENTS if key == "vae" else UNET_PARENTS))
                 // batch)
        extra[key] = {}
        for name in set(group) | set(plain):
            short = _op_name(name)
            extra[key][short] = (extra[key].get(short, 0)
                                 + (group.get(name, 0) - plain.get(name, 0)) / steps)
        extra[key] = {k: round(v, 3) for k, v in extra[key].items() if v}
    print(f"[dp-nccl-epoch-scan] profiled train epochs on one state, 1 NCCL rank "
          f"({card}), in turns: "
          + " | ".join(_profile_note(m, prof[k]) for m, k in
                       ((f"VAE at batch {BATCH}", "vae"),
                        (f"U-Net at batch {UNET_BATCH}", "unet")))
          + f"; device ops a step the group's captured step has beyond the no-group "
          f"one (the collectives as NCCL runs them at world 1): VAE {extra['vae']}, "
          f"U-Net {extra['unet']}"
          + f"; a captured VAE epoch under sync-debug 'error' returned with the "
          f"queued sleep kernel still running ({sync_ok['replays']} replays, finite "
          f"metrics); torchrun launch {secs:.3f} s", flush=True)
    two = phase_dp_nccl_two_cards(tmp, synthetic, card)
    return {key: total[key] + two[key] for key in total}


def phase_dp_nccl_two_cards(tmp: str, synthetic: str, card: str):
    """Where two cards are visible: the VAE (batch 20, 10 rows per rank)
    and the U-Net (10, 5) on two NCCL ranks, one per card, ``--resident
    --epoch-scan`` against ``--resident``, 2 epochs at ``DP_LR``: each
    rank's history and rank 0's latest.npz bitwise (the U-Net's CE sums
    within 1e-5), both ranks' BatchNorm statistics bitwise equal, and the
    captured history within 2e-2 of a single-process captured run at the
    same global batch and rate (phase 27's bfloat16 standard).  With one
    card it prints why it did not run.  Returns the ranks' launches."""
    import numpy as np
    import torch

    from icsg3d_torch.apps import train_unet, train_vae

    n = torch.cuda.device_count()
    if n < 2:
        print(f"[dp-nccl-epoch-scan] two NCCL ranks on two cards: not run, {n} card "
              "visible (NCCL refuses two ranks on one card)", flush=True)
        return dict(NO_LAUNCHES)
    cases = epoch_scan_cases(tmp, synthetic)
    labels = ("train_vae", "train_unet")
    jobs = []
    for label in labels:
        app, argv = cases[label]
        for scan in (0, 1):
            ckpt = os.path.join(tmp, f"dp-nccl2-{app}-{scan}")
            jobs.append({"kind": "cli", "app": app, "watch": ckpt,
                         "argv": argv + ["--lr", DP_LR[app], "--dist-backend",
                                         DP_ONE_BACKEND, "--ckpt", ckpt]
                         + (["--epoch-scan"] if scan else [])})
    ranks, arrays, secs = torchrun(2, jobs, tmp, "dp-nccl-2cards")
    total = dict(NO_LAUNCHES)
    mods = {"train_vae": train_vae, "train_unet": train_unet}
    for i, label in enumerate(labels):
        app, argv = cases[label]
        per = [r["jobs"][2 * i] for r in ranks]
        cap = [r["jobs"][2 * i + 1] for r in ranks]
        for r in range(2):
            check(not per[r]["refusals"] and not cap[r]["refusals"] and cap[r]["captures"],
                  f"2 cards {label} rank {r}: {cap[r]['refusals']} {cap[r]['captures']}")
            check(cap[r]["counts"] == per[r]["counts"],
                  f"2 cards {label} rank {r}: launches {cap[r]['counts']} vs "
                  f"{per[r]['counts']}")
            total = {k: total[k] + per[r]["counts"][k] + cap[r]["counts"][k]
                     for k in total}
        seen = _same_training(f"2 cards {label}", [
            (jobs[2 * i]["watch"], per[0]["history"]),
            (jobs[2 * i + 1]["watch"], cap[0]["history"])])
        check(_timeless(cap[1]["history"]) == _timeless(cap[0]["history"]),
              f"2 cards {label}: the ranks' histories differ")
        stats = sorted(k for k in arrays[0] if k.startswith(jobs[2 * i + 1]["watch"] + "/"))
        check(stats and all(np.array_equal(arrays[1][k], arrays[0][k]) for k in stats),
              f"2 cards {label}: the ranks' BatchNorm statistics differ")
        one = os.path.join(tmp, f"dp-nccl2-one-{app}")
        with plots_off():
            world1 = _quiet(mods[app].main, argv + ["--lr", DP_LR[app], "--ckpt", one,
                                                    "--epoch-scan"])
        rels = _history_rel(cap[0]["history"], world1)
        worst = max(rels, key=rels.get)
        check(rels[worst] <= 2e-2, f"2 cards {label}: {worst} differs from world 1 by "
              f"{rels[worst]:.3e} > 2e-2")
        print(f"[dp-nccl-epoch-scan] {label} on two NCCL ranks, one per card "
              f"({card}), at lr {DP_LR[app]}: captured vs per-step {seen}, ranks' "
              f"histories and {len(stats)} BatchNorm buffers equal; launches per rank "
              f"{cap[0]['counts']} = the per-step run's; within {rels[worst]:.3e} of "
              f"the single-process captured run (worst {worst}; bound 2e-2); epoch "
              f"times (s) per-step {[round(h['time'], 4) for h in per[0]['history']]}, "
              f"captured {[round(h['time'], 4) for h in cap[0]['history']]}, the "
              f"single-process captured run on one card "
              f"{[round(h['time'], 4) for h in world1]}", flush=True)
    print(f"[dp-nccl-epoch-scan] two cards: torchrun launch {secs:.3f} s", flush=True)
    return total


@contextlib.contextmanager
def f32_cli(on: bool):
    """Inside this block (when ``on``) the trainer CLIs compute in float32
    on the card too (``apps.common.compute_dtype``), on the f32 kernels."""
    from icsg3d_torch.apps import common

    chosen = common.compute_dtype
    if on:
        common.compute_dtype = lambda device: "float32"
    try:
        yield
    finally:
        common.compute_dtype = chosen


def phase_dp_gloo(tmp: str, synthetic: str, card: str):
    """Three trainers on DP_RANKS ranks on cuda:0 over gloo, one epoch each
    at the single-process phases' global batches (VAE 20 = 10 per rank,
    U-Net 10 = 5, CGCNN 32 = 16; the VAE and the U-Net at DP_LR), against
    world-1 runs of the same global batches (the VAE and U-Net here,
    CGCNN's phase 17): the VAE and the U-Net once computing in float32,
    held to 1e-3, and once in bfloat16, the card's, held to the
    card-vs-CPU standard 2e-2 and counted in the kernels line.  In
    bfloat16 the ranks' other summation order of a BatchNorm moment moves
    a rounding now and then, and through 9-14 bf16 layers and their max
    pools that grows to percents (the U-Net's conv1 gradient cosine card
    vs CPU is ~0.96, phase 13).  Then one VAE and one U-Net step against
    world 1 in float32 (loss and metrics 1e-4, gradients 1e-2 in l2 norm)
    and in bfloat16 (loss 2e-2, gradient cosines 0.95, the times).  Two
    ranks share one card and gloo goes through the host: their times are
    not a data-parallel rate.  Every result is printed before the checks
    fail.  Returns the launches of the ranks' bfloat16 and CGCNN runs."""
    import numpy as np

    from icsg3d_torch.apps import train_unet, train_vae

    clis = [("train_vae", "float32"), ("train_unet", "float32"),
            ("train_cgcnn", "float32"), ("train_vae", "bfloat16"),
            ("train_unet", "bfloat16")]
    tol = {"float32": 1e-3, "bfloat16": 2e-2}

    def argv(app, dt, device, tag):
        return (_train_argv(tmp, synthetic, app, device, "gloo", f"{tag}-{dt}")
                + (["--lr", DP_LR[app]] if app in DP_LR else []))

    jobs = [{"kind": "cli", "app": app, "dtype": dt,
             "argv": argv(app, dt, dp_device(), "dp-gloo"),
             "watch": os.path.join(tmp, f"dp-gloo-{dt}-{app}")} for app, dt in clis]
    steps = [(m, dt) for dt in ("float32", "bfloat16") for m in ("vae", "unet")]
    jobs += [_dp_step_job(tmp, synthetic, m, "gloo", dt == "bfloat16", dt)
             for m, dt in steps]
    # --epoch-scan on a gloo group on the card: refused, the per-step values
    resident = [{"kind": "cli", "app": "train_vae", "dtype": "float32",
                 "argv": argv("train_vae", "float32", dp_device(), f"dp-gloo-{tag}")
                 + ["--resident"] + extra,
                 "watch": os.path.join(tmp, f"dp-gloo-{tag}-float32-train_vae")}
                for tag, extra in (("resident", []), ("scan", ["--epoch-scan"]))]
    jobs += resident
    ranks, arrays, secs = torchrun(DP_RANKS, jobs, tmp, "dp-gloo")
    singles = {("train_cgcnn", "float32"): _first_epoch(
        os.path.join(tmp, "cgcnn-formation_energy"))}
    with plots_off():
        for app, mod in (("train_vae", train_vae), ("train_unet", train_unet)):
            for dt in tol:
                with f32_cli(dt == "float32"):
                    singles[app, dt] = _quiet(mod.main, argv(app, dt, DEVICE, "dp-one"))
    n = {"train_vae": (TRAIN_PARENTS, BATCH), "train_unet": (UNET_PARENTS, UNET_BATCH),
         "train_cgcnn": (CGCNN_SYNTHETIC, CGCNN_BATCH)}
    per_step = {
        "train_vae": ({"fwd": FWD_PER_STEP, "bias": FWD_PER_STEP, "dx": DX_PER_STEP,
                       "dw": DW_PER_STEP},
                      {"fwd": FWD_PER_STEP, "bias": 1 + 2 * len(UNET_PREFIX),
                       "folded": len(VAE_CONVS) - 1}),
        "train_unet": ({"fwd": UNET_CONVS_N, "bias": UNET_CONVS_N,
                        "dx": UNET_CONVS_N - 1, "dw": UNET_CONVS_N},
                       {"fwd": UNET_CONVS_N, "folded": UNET_CONVS_N}),
        "train_cgcnn": ({}, {}),
    }
    total = dict(NO_LAUNCHES)
    notes, fails = [], []

    def need(cond: bool, msg: str) -> None:
        if not cond:
            fails.append(msg)

    for i, (app, dt) in enumerate(clis):
        runs = [r["jobs"][i] for r in ranks]
        rels = {}
        for run in runs:
            for k, v in _history_rel(run["history"], singles[app, dt]).items():
                rels[k] = max(rels.get(k, 0.0), v)
        worst = max(rels, key=rels.get)
        need(rels[worst] <= tol[dt], f"{app} in {dt}: {worst} differs from world 1 "
             f"by {rels[worst]:.3e} > {tol[dt]:g} (all: {rels})")
        ckpt_files = [w for w in runs[0]["writes"] if w != "."]
        need(all(run["writes"] == [] for run in runs[1:]) and ckpt_files,
             f"{app} in {dt}: writes {[run['writes'] for run in runs]}")
        prefix = jobs[i]["watch"] + "/"
        stats = sorted(k for k in arrays[0] if k.startswith(prefix))
        for other in arrays[1:]:
            need(sorted(k for k in other if k.startswith(prefix)) == stats and all(
                np.array_equal(other[k], arrays[0][k]) for k in stats),
                f"{app} in {dt}: the ranks' BatchNorm statistics differ")
        parents, batch = n[app]
        n_train = int(0.8 * parents) // batch
        n_val = (parents - int(0.8 * parents)) // batch
        want = dict(NO_LAUNCHES)
        for per, k in zip(per_step[app], (n_train, n_val)):
            for key, c in per.items():
                want[key] += k * c
        for r, run in enumerate(runs):
            need(run["counts"] == want, f"{app} in {dt} rank {r}: launches "
                 f"{run['counts']}, want {want}")
            if dt == "bfloat16" or app == "train_cgcnn":  # the card's own runs
                total = {key: total[key] + run["counts"][key] for key in total}
        lr = f" at lr {DP_LR[app]}" if app in DP_LR else ""
        notes.append(f"{app} in {dt}{lr}, 1 epoch ({n_train} steps + {n_val} val "
                     f"batches, {batch // DP_RANKS} rows per rank) in "
                     f"{[round(run['seconds'], 3) for run in runs]} s; metrics within "
                     f"{rels[worst]:.3e} of world 1 (worst {worst}; relative, "
                     f"{'/'.join(COUNT_METRICS)} absolute; bound {tol[dt]:g}); rank 0 "
                     f"wrote {sorted(set(w.split(os.sep)[0] for w in ckpt_files))}, "
                     f"rank 1 nothing; {len(stats)} BatchNorm buffers bitwise equal; "
                     f"launches per rank {runs[0]['counts']} = expected")
    for i, (model, dt) in enumerate(steps, start=len(clis)):
        step = ranks[0]["jobs"][i]
        tag = f"{model} step in {dt}"
        loss_rel = abs(step["loss"] - step["loss_one"]) / abs(step["loss_one"])
        zero = dp_zero_gradient_biases(model)
        l2 = {k: v for k, v in step["grad_l2"].items() if k not in zero}
        cos = {k: v for k, v in step["grad_cos"].items() if k not in zero}
        worst, low = max(l2, key=l2.get), min(cos, key=cos.get)
        elem = max((k for k in step["grad_err"] if k not in zero),
                   key=step["grad_err"].get)
        # a bias whose true gradient is 0: both sides' noise below 1e-2 of the
        # max gradient of its conv's kernel
        noise = {k: max(step["grad_max"][k]) / step["grad_max"][k[:-4] + "kernel"][0]
                 for k in zero}
        if dt == "float32":
            need(loss_rel <= 1e-4, f"{tag}: loss {step['loss']} vs world 1 "
                 f"{step['loss_one']} (rel {loss_rel:.3e} > 1e-4)")
            met_err = dp_step_metric_errs(step["mets"], step["mets_one"])
            need(max(met_err.values()) <= 1e-4, f"{tag}: metrics beyond 1e-4 of world "
                 f"1: {met_err}")
            need(l2[worst] <= 1e-2, f"{tag}: gradients beyond 1e-2 of their l2 norm "
                 f"at world 1: { {k: v for k, v in l2.items() if v > 1e-2} }")
            need(all(v <= 1e-2 for v in noise.values()), f"{tag}: the zero-gradient "
                 f"biases' noise over their kernels' max: {noise}")
        else:
            need(loss_rel <= 2e-2, f"{tag}: loss {step['loss']} vs world 1 "
                 f"{step['loss_one']} (rel {loss_rel:.3e} > 2e-2)")
            need(cos[low] >= 0.95, f"{tag}: gradient cosines below 0.95: "
                 f"{ {k: v for k, v in cos.items() if v < 0.95} }")
        met_err = dp_step_metric_errs(step["mets"], step["mets_one"])
        note = (f"one {tag}: loss {step['loss']:.6f} vs {step['loss_one']:.6f} at "
                f"world 1 (rel {loss_rel:.3e}), every metric within "
                f"{max(met_err.values()):.3e} ({max(met_err, key=met_err.get)}); "
                f"{len(l2)} gradients within "
                f"{l2[worst]:.3e} of their l2 norm (worst {worst}), cosines >= "
                f"{cos[low]:.6f} ({low}), largest element {step['grad_err'][elem]:.3e} "
                f"of its max ({elem})")
        if zero:
            note += (f"; the {len(zero)} biases before a training BatchNorm (true "
                     f"gradient 0) at most {max(noise.values()):.3e} of their "
                     f"kernel's max")
        if "step_ms" in step:
            ms = step["step_ms"]
            note += (f"; gradient buffer {step['grad_bytes']} bytes, gloo all-reduce "
                     f"{step['reduce_ms']:.3f} ms; step {ms['group']:.3f} ms per rank "
                     f"at {DP_RANKS} ranks on one card vs {ms['plain']:.3f} ms at "
                     f"world 1 (two processes share the card and gloo goes through "
                     f"the host: not a data-parallel rate)")
        notes.append(note)
    refusal = ("--epoch-scan: not captured (a gloo process group: it moves CUDA "
               "tensors through host memory, which a CUDA graph cannot capture); "
               "running the per-step resident loop")
    per, scan = ([r["jobs"][len(jobs) - 2 + k] for r in ranks] for k in (0, 1))
    for r in range(DP_RANKS):
        need(per[r]["refusals"] == [] and scan[r]["refusals"] == [refusal]
             and not scan[r]["captures"],
             f"--epoch-scan over gloo, rank {r}: {scan[r]['refusals']}")
        need(_timeless(scan[r]["history"]) == _timeless(per[r]["history"])
             and scan[r]["counts"] == per[r]["counts"],
             f"--epoch-scan over gloo, rank {r}: history or launches differ from "
             "--resident's")
    with np.load(os.path.join(resident[0]["watch"], "latest.npz")) as a, \
            np.load(os.path.join(resident[1]["watch"], "latest.npz")) as b:
        same = a.files == b.files and all(np.array_equal(a[k], b[k]) for k in a.files)
    need(same, "--epoch-scan over gloo: latest.npz differs from --resident's")
    notes.append(f"train_vae --resident --epoch-scan in float32: each rank printed "
                 f"'{refusal}', and its history, launches and rank 0's latest.npz "
                 f"equal --resident's bitwise")
    print(f"[dp-gloo] {DP_RANKS} ranks on cuda:0 over gloo ({card}), launch "
          f"{secs:.3f} s: " + "; ".join(notes))
    check(not fails, "dp-gloo: " + "; ".join(fails))
    return total


def dp_step_metric_errs(got: dict, want: dict) -> dict:
    """Each step metric's difference (``_metric_err``); the U-Net's
    per-class sums as the per-class CE where a class occurs, and its class
    counts (integers summed over the ranks) exactly (0 or 1)."""
    import numpy as np

    out = {}
    for key, v in want.items():
        if key == "ce_class_sum":
            seen = np.asarray(want["class_count"]) > 0
            out["ce_per_class"] = _metric_err(
                key, np.asarray(got[key])[seen] / np.asarray(got["class_count"])[seen],
                np.asarray(v)[seen] / np.asarray(want["class_count"])[seen])
        elif key == "class_count":
            out[key] = float(got[key] != v)
        else:
            out[key] = _metric_err(key, got[key], v)
    return out


def dp_zero_gradient_biases(model: str) -> set:
    """The parameters whose true gradient is 0: the VAE's conv biases that
    feed a training BatchNorm (its batch mean takes the bias out again);
    their computed gradients are rounding noise."""
    if model != "vae":
        return set()
    n = len(VAE_CONVS) // 2 - 1
    return ({f"encoder.Conv_{i}.bias" for i in range(n)}
            | {f"decoder.Conv_{i}.bias" for i in range(n)}
            | {"decoder.decoder_output.bias"})


def phase_dp_voxelize(tmp: str, synthetic: str, card: str):
    """``apps.voxelize`` on DP_RANKS ranks on cuda:0 over gloo: the
    UNET_PARENTS synthetic structures in parts; ``merge_parts`` of them
    equals phase 10's single-process build bitwise, id by id.  Returns the
    ranks' K4 launches."""
    import math

    import numpy as np

    from icsg3d_torch.apps.voxelize import merge_parts
    from icsg3d_torch.data.store import GridDataset

    out = os.path.join(tmp, "dp-vox")
    argv = ["--synthetic", str(UNET_PARENTS), "--kinds", "perovskite,rocksalt",
            "--nrot", "0", "--d", str(D), "--out", out, "--device", dp_device(),
            "--dist-backend", "gloo"]
    ranks, _, secs = torchrun(DP_RANKS, [{"kind": "cli", "app": "voxelize",
                                          "argv": argv, "watch": out}], tmp, "dp-vox")
    merged, whole = merge_parts(out), GridDataset(synthetic)
    check(sorted(merged.ids) == sorted(whole.ids), "dp-voxelize: merged ids differ")
    rows = [merged.index[i] for i in whole.ids]
    for field, arr in whole.arrays.items():
        check(np.array_equal(np.asarray(merged.arrays[field])[rows], np.asarray(arr)),
              f"dp-voxelize: merged {field} differs from the single-process build")
    total = dict(NO_LAUNCHES)
    for r, rank in enumerate(ranks):
        run = rank["jobs"][0]
        want = math.ceil(run["samples"] / VOX_CHUNK)
        check(run["counts"]["vox"] == want, f"dp-voxelize rank {r}: K4 launched "
              f"{run['counts']['vox']} times for {run['samples']} structures")
        check(all(w == "." or w.split(os.sep)[0] == f"part-{r}" for w in run["writes"]),
              f"dp-voxelize rank {r} wrote {run['writes']}")
        total["vox"] += run["counts"]["vox"]
    print(f"[dp-voxelize] voxelize --synthetic {UNET_PARENTS} on {DP_RANKS} ranks on "
          f"cuda:0 over gloo ({card}) in {secs:.3f} s (launch); parts "
          f"{[rank['jobs'][0]['samples'] for rank in ranks]} samples in "
          f"{[round(rank['jobs'][0]['seconds'], 3) for rank in ranks]} s; merge_parts "
          f"equals the single-process build bitwise in every field; K4 launches per "
          f"rank {[rank['jobs'][0]['counts']['vox'] for rank in ranks]}")
    return total


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke test needs one NVIDIA GPU")
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "icsg3d_torch")):
        fail(f"no icsg3d_torch package beside {__file__}: run from a checkout")
    sys.path.insert(0, repo)
    if sys.argv[1:2] == ["--dp-worker"]:  # a rank of phase 26-28's torchrun
        dp_worker(sys.argv[2])
        return
    torch.manual_seed(SEED)

    name, card = phase_device()
    phase_build()
    rows = phase_kernels(card, CONV_SHAPES + TRAIN_FWD_SHAPES, BATCH)
    rows += phase_kernels(card, UNET_FWD_SHAPES, UNET_BATCH)
    rows += phase_kernels(card, CONV_SHAPES, EVAL_BATCH)  # evaluate's batch
    # the later paths' other batches, at the same bounds: view's samples
    # and interpolate's pair encodes (1), the sweep's encodes (2), the
    # trainers' plot forwards (4, where matplotlib imports).  Their errors
    # join the kernels line, their times stay out of its sums.
    checked = phase_kernels(card, CONV_SHAPES, 1)
    checked += phase_kernels(card, CONV_SHAPES[:ENCODER_CONVS], 2)
    checked += phase_kernels(card, CONV_SHAPES, 4)
    rows += phase_backward_kernels(card, [
        ("dx", DX_SHAPES, BATCH), ("dw", DW_SHAPES, BATCH),
        ("dx", UNET_DX_NEW, UNET_BATCH), ("dw", UNET_TRAIN, UNET_BATCH)])
    # the data-parallel ranks' batches (phases 26-27: VAE 20 -> 10 rows per
    # rank, U-Net 10 -> 5): the VAE step's forwards, dx and dW at 10, the
    # U-Net's training and eval forwards, dx and dW at 5.  Their errors join
    # the kernels line, their times stay out of its sums.
    vae_b, unet_b = BATCH // DP_RANKS, UNET_BATCH // DP_RANKS
    checked += phase_kernels(card, TRAIN_FWD_SHAPES[:len(VAE_CONVS)], vae_b)
    checked += phase_kernels(card, UNET_FWD_SHAPES + CONV_SHAPES[-UNET_CONVS:], unet_b)
    checked += phase_backward_kernels(card, [
        ("dx", DX_SHAPES, vae_b), ("dw", DW_SHAPES, vae_b),
        ("dx", UNET_TRAIN[:0:-1], unet_b), ("dw", UNET_TRAIN, unet_b)])
    rows += phase_voxelize_kernel(card)
    rows += phase_valid_kernels(card, [
        ("fwd", VAE_CONVS, BATCH), ("dx", VAE_CONVS[1:], BATCH), ("dw", VAE_CONVS, BATCH),
        ("fwd", UNET_TRAIN, UNET_BATCH), ("dx", UNET_TRAIN[1:], UNET_BATCH),
        ("dw", UNET_TRAIN, UNET_BATCH)], rows)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        vae, unet, runs = phase_main_path(tmp, card)
        spec20, binary20 = phase_breakdown(vae, unet, card)
        ext_rows, ext_checked = phase_extract_kernels(vae, unet, card, spec20, binary20)
        rows += ext_rows
        checked += ext_checked
        del spec20, binary20
        phase_cpu_parity(vae, unet)
        with plots_off():
            train_counts = phase_train(tmp, card)
        state, batch, eps = phase_train_step(tmp, unet, card)
        phase_train_cpu_parity(state, unet, batch, eps)
        del state, batch, eps, vae, unet
        synthetic, vox_counts = phase_voxelize(tmp, card)
        with plots_off():
            unet_counts, class_weights = phase_train_unet(tmp, synthetic, card)
        ustate, ubatch, cw = phase_unet_train_step(synthetic, class_weights, card)
        phase_unet_train_cpu_parity(ustate, ubatch, cw)
        del ustate, ubatch, cw
        with plots_off():
            spatial_counts = phase_train_spatial(tmp, synthetic, card)
        phase_spatial_parity(tmp, synthetic, class_weights, card)
        with plots_off():
            epoch_counts, epoch_runs = phase_epoch_scan(tmp, synthetic, card)
        ckpts = phase_train_cgcnn(tmp, card)
        phase_cgcnn_cpu_parity(card)
        dp_counts = [phase_dp_nccl(tmp, synthetic, card),
                     phase_dp_nccl_epoch_scan(tmp, synthetic, card, epoch_runs),
                     phase_dp_gloo(tmp, synthetic, card),
                     phase_dp_voxelize(tmp, synthetic, card)]
        phase_predict(tmp, ckpts, card)
        gen_cgcnn_counts = phase_generate_cgcnn(tmp, ckpts, card)
        eval_counts = phase_evaluate(tmp, synthetic, card)
        interp_counts = phase_interpolate(tmp, synthetic, card)
        view_counts = phase_view(tmp, synthetic, card)
        plots_counts = phase_plots(tmp, synthetic, card)
        phase_profiling(tmp, synthetic, card)

    # launches on the main paths: generation (fused and host), VAE
    # training, the two dataset builds, U-Net training, both trainers at
    # --spatial, the trainers' --epoch-scan runs and their per-step twins
    # (captured launches x replays), the data-parallel ranks (training over NCCL and gloo, the
    # build in parts), generation with --cgcnn-ckpt, evaluate, interpolate
    # (pair and sweep), view and the plots phase's trainers
    gen_counts = [{"bias": r["by_epilogue"]["bias"],
                   "folded": sum(r["by_epilogue"][e] for e in FOLDED),
                   "dx": 0, "dw": 0, "vox": 0, "cc": r["cc"], "bfs": r["bfs"]}
                  for r in runs.values()]
    paths = gen_counts + [train_counts, vox_counts, unet_counts, spatial_counts,
                          epoch_counts, *dp_counts, gen_cgcnn_counts, eval_counts, *interp_counts, view_counts,
                          plots_counts]
    count_key = {"conv3d_same[bias]": "bias", "conv3d_same[folded_bn]": "folded",
                 "conv3d_same[dx]": "dx", "conv3d_dw": "dw", "voxelize": "vox",
                 "conv3d_same[valid]": "fwd_valid",
                 "conv3d_same[dx_valid]": "dx_valid", "conv3d_dw[valid]": "dw_valid",
                 "extract_cc": "cc", "extract_bfs": "bfs"}
    kernels = []
    for entry, source, replaces, covers in KERNEL_ENTRIES:
        mine = [r for r in rows if covers(r)]
        by_kind = {}
        for r in mine:
            by_kind[r["bound_by"]] = by_kind.get(r["bound_by"], 0.0) + r["bound_ms"]
        libs = [r["library_ms"] for r in mine]
        kernels.append({
            "name": entry,
            "route": "cuda",
            "source": source,
            "replaces": replaces,
            "launches": sum(p.get(count_key[entry], 0) for p in paths),
            "max_abs_err": max(r["abs_err"] for r in mine
                               + [r for r in checked if covers(r)]),
            "ms": sum(r["ms"] for r in mine),
            "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": sum(r["bound_ms"] for r in mine),
            "bound_by": max(by_kind, key=by_kind.get),
            "library_ms": None if None in libs else sum(libs),
        })
        check(kernels[-1]["launches"] > 0, f"{entry} was not launched by the paths")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
