"""Drives the PyTorch/CUDA port (scene_graph_commonsense_torch) on one NVIDIA
GPU and checks it, phase by phase; any failure raises and exits non-zero.

    python3 chip_smoke.py

Phases, each printing JSON lines:
  1. device:  requires CUDA; prints the card's name and power limit.
  2. build:   compiles every csrc/*.cu with nvcc (sm_90a), one process each.
  3. kernel:  each kernel against its plain PyTorch version at the
              production shape (M=240 objects, S=32, C=512), in bfloat16 and
              float32, with the indices pack_pairs gives a synthetic batch
              and with random indices.  pair_pool at P=4560 pair slots and
              pair_pool_idx must equal their plain versions exactly (out and
              idx); pair_pool_bwd at P=1024 and 4560 must lie within float32
              rounding of its plain version (see check_grad).  Times each
              kernel and plain version with CUDA events.
  4. slice:   PredCLS at full VG width (batch 12, 20 objects, 256 feature
              channels, hidden 128, bfloat16, worst-case pair capacity,
              seeded random weights): run_eval_pc over 3 synthetic batches,
              then SceneGraphPredictor.predict on one batch.  The launch
              counts are set to 0 just before and read just after: the
              forward kernel once per batch, the training kernels never.
  5. profile: torch.profiler over run_eval_pc: device busy share, kernels
              and operators by device time.
  6. train:   PredCLS training at bench.py's configuration (full VG width,
              batch 12, pair capacity 1024, augmented capacity 256, clip
              5.0, bf16): the train step of train.loop.fit, 2 warm-up steps
              then 6 timed by CUDA events, with the launch counts set to 0
              just before: exactly 2 launches of each training kernel per
              step (main and augmented view), none of the forward kernel;
              finite losses; parameters changed.  torch.profiler over 3
              steps.  Then one fit epoch of 3 steps with its test pass,
              which must launch the forward kernel once per test batch and
              per train-time recall pass, and write its checkpoint.
  7. featurize: the live DETR-101 featurizer at full width (ResNet-101
              trunk, 6 encoder layers, d_model 256, 8 heads, dim_ff 2048,
              bf16, seeded random weights; the default config, so the
              fused trunk and the encoder kernels run on the card) on
              seeded 1024x1024 images: encode_features of 12 and of 24
              images (CUDA events after a warm-up), with the fused trunk
              and beside it with fused_backbone off (the cuDNN trunk);
              SceneGraphPredictor.predict from 12 images, and
              fit(featurize=...) for 2 steps with both views in one 2B
              dispatch.  Per encode dispatch exactly 1 stem kernel, 30
              stride-1 and 3 stride-2 bottleneck kernels, no stem-pool
              kernel, 6 of each encoder kernel; the pair-pool kernels as on
              their own paths; peak memory; torch.profiler split of both
              trunks, the encoder, the kernels (each kernel group must
              hold device time) and the relation head, and
              the fused trunk's per-stage split (CUDA events over chained
              prefixes, `upto`).  Then model.image_size 1020 (even, not
              divisible by 8) with the same DETR: encode_12 of 12 seeded
              1020^2 images (CUDA events over 3, features (12, 32, 32,
              256) finite, its device split) and predict from them, each
              encode exactly 1 stem-pool kernel (K6, after the plain stem
              conv), 30 stride-1 and 2 stride-2 bottleneck kernels (the
              odd 255^2 layer2 transition runs the plain block) and 6 of
              each encoder kernel; K6's launches in the summary are this
              predict's.
  8. detect:  SGDET/SGCLS detection at full width (the featurizer's DETR-101
              plus 6 decoder layers, 100 queries, 151 classes, bf16, seeded
              random weights, the default config) through load_detr
              (detection=True) and eval.engines.make_detr_detect_fn on 12
              seeded 1000x1000 canvases (data.nonsq_canvas) with VG-like
              pixel masks (600x800 and 800x600 valid regions in turn, one
              full image; about half of the encoder's keys masked):
              finite logits, boxes in [0, 1], the post-process equal on
              the card and on the CPU; detect_12 by CUDA events over 3
              dispatches after a warm-up, exactly 1 stem, 30 stride-1, 1
              stride-2 (layer3_0 and layer4_0 take odd inputs and the
              plain fallback) and 6 of each encoder kernel per dispatch;
              peak memory; the split into trunk, encoder, decoder and
              heads, post-process (torch.profiler, and host clock beside
              CUDA events per nested prefix) and the NMS loop's wall
              time; the trunk kernels and attention at the canvas shapes
              against their plain versions (phase `kernel`'s rules;
              attention under the canvases' own key mask, beside SDPA);
              run_eval_sgd and run_eval_sgc over 2 synthetic full-VG-width
              batches (the pair-pool kernel once per batch, recall in
              [0, 1], wall time per batch); the detection forward on the
              card and on the CPU at reduced depth in float32 on two
              1024x512 canvases, one padded (within 1e-4), and the
              post-process of the same outputs on both (equal integer
              outputs).
  9. parity:  the same weights and batch through make_eval_step, one
              train step and one faithful train step
              (training.faithful_dynamics; 2 + 2 training-kernel launches),
              on the card (kernels) and on the CPU (plain versions) at a
              reduced size in float32 with TF32 off: outputs and parameters
              after each step within 1e-4, integer outputs and metrics
              equal, the winner index equal on equal streams;
              encode_features of a 1024x512 image at reduced depth in
              float32 (kernels on the card, plain versions on the CPU)
              within 1e-4; the fused trunk at depth (1, 1, 1, 1), float32,
              on a 1024x512 image (stem, stride-1 and stride-2 kernels) and
              a 1020x508 one (the stem-pool kernel and the odd-size
              fallback) within TRUNK_F32_TOL of the output's scale.
 10. real_data: real Visual Genome data at full width (the featurizer and
              the detector as in phases featurize and detect): a mini-VG
              of 60 JPEGs in the reference's on-disk format (36 train, 24
              test; VG's common sizes 800x600, 600x800, 500x375, 500x333,
              1024x768 in turn; up to 20 objects of 150 classes), its SGRC
              records (train v2, test v1, tools/sgrecords.py) and its
              feature cache (tools/precompute_features.py); run_eval_pc
              from images over the Python loader and prepped_batches
              (exactly 1 stem, 30 stride-1, 3 stride-2, 6 of each encoder
              kernel and 1 pair-pool kernel per batch; wall time per batch
              from disk and from loaded batches; busy share);
              run_eval_sgd / run_eval_sgc from images on the 1000^2
              canvas, one detector giving features and detections (the
              encode's and the detect dispatch's launches per batch);
              fit over NativeRecordPipeline (v2, plain view) for 3 steps
              (one 2B encode and 2 + 2 training-kernel launches a step),
              the train step from records and from features and the 2B
              encode by CUDA events, the step's busy share; the loaders
              alone on the host (the Python loader's training batches,
              the packer at 1 and 8 threads); the native path (v1
              records + the cache) equal to the Python loader key by key;
              the CLI as a user runs it: train on v2 records, then eval
              pc (v1 records + cache) and eval sgd, each exiting 0.
 11. commonsense: the commonsense loop and the training leftovers at full
              VG width (bf16, batch 12, 20 objects, seeded weights): the
              faithful train step (every valid pair, 4560, the augmented
              view at 1140; CUDA events over 3 steps after 1 warm-up,
              exactly 2 + 2 training-kernel launches a step, lr_scale in
              (0, 1], finite losses, fc1 changed) beside the ordinary step
              at the same capacities, with peak memory; the chunked path at
              chunk_size CHUNK: the eval step (one forward-kernel launch a
              chunk) and the train step (per view of n > 1 chunks 2n
              forward-with-index and n backward launches: the recompute)
              against the unchunked ones from the same weights, each bf16
              output within 2x the unchunked step's own error against a
              float32 run, with ms and peak memory both ways; run_prepare_cs
              from the images of phase real_data's mini-VG with the mock LLM
              (exactly 1 stem, 30 stride-1, 3 stride-2, 6 of each encoder
              kernel and 1 forward kernel a batch; wall time a batch), its
              resume from the per-image files (no launch, the same table),
              and the CLI train -> prepare_cs --mock-llm -> train_cs ->
              eval_cs, each exiting 0 with a commonsense loss > 0 in
              train_cs; a 3-step fit with training.tensorboard and a
              profiler window [1, 2): the JAX package's scalar tags, and a
              Chrome trace of step 1 naming 2 + 2 training kernels.
 12. oiv6:    OpenImages V6 at full width (601 classes, 30 relations in
              branches of 4, 2 and 24, the flagship head, bf16, batch 12,
              20 objects, seeded weights) from a mini-OIv6 of 60 seeded
              JPEGs at OIv6-like sizes in the SGTR format
              (tools/make_mini_oiv6.py; 36 train, 24 test, depth maps):
              PredCLS eval from images through the CLI's data path
              (cli.real_batches, prepped_batches, the live featurizer) over
              2 batches with recall, mR and the weighted mAP (wmap_rel,
              wmap_phrase), exactly 1 stem, 30 stride-1, 3 stride-2, 6 of
              each encoder kernel and 1 pair-pool kernel a batch; fit for 3
              steps from the training images, exactly one encode, 1
              pair-pool-with-index and 1 backward launch a step (OIv6
              batches carry no augmented view); the eval step by CUDA
              events, in turns with the VG head's on the same features;
              the CLI's --dataset oiv6 --eval_mode sgd on the mini-OIv6,
              which must exit non-zero with the refusal of
              engines.check_detector_classes (VG's 151-entry class remap,
              the 602-class detector) before it builds the detector.
 13. pnp:     the plug-and-play families (Motifs, Transformer, VCTree,
              VTransE) at the JAX package's widths (hidden 256, pair 512,
              float32, VG's 150 classes and 50 relations, 20 objects, 400
              pairs an image, batch 12) from seeded 1024^2 images through
              the live featurizer: fit_predictor for 3 steps (the augmented
              view dropped before the encode) and run_eval_pc_predictor over
              2 batches without and with TDE, exactly one encode a batch
              and no pair-pool launch; the train step and the eval step
              (without and with TDE) from features by CUDA events beside
              the host's time to issue them, peak memory, and one call of
              each under torch.profiler (its device ms over the CUDA-event
              ms is the device share: near 1, the card sets the pace);
              each family's train and eval step on the card and on the CPU
              at reduced widths in float32 within PNP_TOL (VCTree's card
              run on the CPU's Prim trees, its flipped parents counted);
              the CLI on the
              mini-OIv6: --dataset oiv6 eval beside --predictor vctree
              train, then --predictor vctree eval --tde, each exiting 0.
 14. mesh:    data parallelism (parallel/mesh.py) at bench.py's
              configuration: world size 1 over NCCL in this process, the
              mesh train step held bit for bit against the single-device
              step over 3 steps (parameters and metrics; deterministic
              cuDNN and index kernels for both) and the mesh eval step
              against the unsharded one, both step times by CUDA events
              in turns, exactly 2 + 2 training-kernel launches a step and
              1 forward launch an eval step; fit(mesh=, featurize=) from
              seeded 1024^2 images for 2 steps with fused_backbone auto
              (one encode a step: the trunk and encoder kernels); then
              world size 2 over gloo's CUDA path, two processes of this
              script on the one card (6 images a rank): a first update
              without the clip (which would scale away an error in the
              mean's scale) within MESH_UPDATE_TOL of one process's
              two-shard update (engine.train_losses on each half with that
              rank's dropout streams, the mean gradient, the optimizer);
              3 clipped steps with both ranks' parameters bit-identical
              after each, the step and the all-reduce alone by the host
              clock, the launches per rank, the sharded eval step through
              gloo's all-gather, fused_backbone auto resolved off, and a
              step with the bfloat16 all-reduce (finite, the ranks
              bit-identical after it); last, two processes that put NCCL
              on the one card (what NCCL says).  The remaining entry
              points over the mesh, at full width (phase detect's DETR-101
              detector, seeded, on 12 of its 1000^2 canvases; the VG head
              in bf16; Motifs at phase pnp's widths from features, the
              second half of its batch cut to 2 valid objects an image):
              at world size 1 over NCCL with fused_backbone auto,
              make_detr_detect_fn(mesh=) and the Motifs eval step (with
              and without TDE) and 3 train steps bit for bit against their
              unsharded runs, run_eval_sgd(mesh=) (batches sharded ahead)
              and run_eval_sgc(mesh=) over MESH_EVAL_BATCHES batches (their
              GT objects the detector's detections) and
              SceneGraphPredictor(mesh=) from 12 1024^2 images equal to
              theirs, each path's launches (a detect dispatch's, an
              encode's, K1 once a relation step, none in the pnp steps)
              and its host-clock times beside the unsharded run's in
              turns; at world size 2 over gloo in the same two processes
              (the cuDNN trunk, K7 and K8 6 a dispatch, K3-K5 none): the
              gathered detections equal to the bit to one process's
              detect_fn on the two halves concatenated, run_eval_sgd(mesh=)
              equal on both ranks, the Motifs first update (at
              PNP_UPDATE_LR, unclipped) within PNP_UPDATE_TOL of one
              process's global-loss update over all 12 images while the
              mean of the halves' local-loss updates misses it, then 3
              steps with the ranks bit-identical after each.
 15. tp:      tensor parallelism (parallel/tp.py) at bench.py's configuration
              at the worst-case pair capacity (4560, the augmented view
              1140): the unsharded run in this process, then a (1, 2) mesh
              as two processes of this script over gloo's CUDA path on the
              one card (`--tp_rank R --work DIR`; fc1 split 65536 x 2048 a
              rank, fc2_h 512 x 2048): the eval step's outputs within
              TP_EVAL_TOL of the unsharded one's, an unclipped first update
              whose every parameter lies within TP_UPDATE_TOL of its
              largest unsharded update, then TP_STEPS clipped steps with the
              replicated parameters bit-identical on both ranks after each,
              exactly 2 + 2 training-kernel launches a step and 1 forward
              launch an eval step per rank, each rank's peak memory below
              the unsharded process's; step times and the (P, 65536) bf16
              all-reduce alone by the host clock; then the global-batch
              step (make_train_step(global_batch=True), the JAX package's
              GSPMD step) at TP_GLOBAL_MESH (2, 2) as four processes
              (`--tp_global_rank R --work DIR`, 6 images a data shard, the
              global capacities 4560 and 1140): its unclipped first update
              within TP_UPDATE_TOL of the unsharded one's with the
              per-image stage run per data shard (the same function; the
              whole batch's convolutions round otherwise) and its float32
              first update within TP_F32_TOL of the whole-batch float32
              step's (no TF32: that rounding gone), TP_STEPS clipped
              steps with the replicas bit-identical within every model and
              data group after each and exactly 2 + 2 training-kernel
              launches a step per rank, step times and peak memory per
              rank; then the port's dryrun at world size 4 over gloo on the
              card, its dp x tp leg on a (2, 2) mesh: the shard_map step
              (fit's and the CLI's) and the global-batch step.
 16. contention: the stride-2 and stride-1 bottleneck kernels (K4 at its
              three transitions, K3 at its five block shapes, batch 12,
              bf16, seeded random blocks) launched back to back for
              CONTENTION_S seconds while a second process of this script
              (`--contend SECONDS`) keeps the card busy with bf16 matrix
              products, so that the card switches between the two
              processes mid-kernel; every output must equal the same
              launch made alone, and the second process must still be
              running when the check ends.
 17. offline: the offline data and checkpoint tools at full width (the
              VG head in bf16, DETR-101 on 1024^2 views, seeded weights),
              run after real_data: a raw VG in VG's own files
              (tools/make_raw_vg.py: 60 JPEGs at REAL_SIZES, 36 train / 24
              test) through the four stages of tools/preprocess_vg.py
              (instances through write_instances on the split indices: no
              h5py on the card's machine; annotations with --with_depth,
              which finds no MiDaS and writes zero maps; triplets under a
              temporary artifacts_dir, the repo's file unchanged; SGRC
              records, whose test batches equal the Python loader's image
              by image); a DETR-101 state dict in detectron2's names
              through tools/convert_checkpoints.py --remap, its encode
              equal to the un-renamed dict's to the bit; fit for 3 steps
              from the new records; a reference-format relation .pth of
              seeded weights through the tool, the same tensors and eval
              outputs as the seeded model; the IETrans pass of
              tools/label_transfer.py from the images with both files
              (an encode and 1 pair-pool launch a batch); its scoring and
              both passes on the card against the CPU from the same cached
              features (a float32 head at hidden OFFLINE_LT_HIDDEN): scores
              within OFFLINE_LT_TOL, every differing relabel a marginal
              one; a train step on the rewritten annotations (the cache
              with the tool's files laid over it); a fabricated GloVe
              file through tools/glove_embeddings.py into a Motifs
              predictor's embeddings and one pnp train step.  Seconds and
              launches per stage (each stage's launches checked exactly),
              the annotation stage's images per second and the
              label-transfer pass's seconds a batch.
Phase `kernel` also holds the encoder kernels against their plain versions:
attention at (B, 1024, 8, 32) for B = 12 and 24, with all keys valid, 80%
of the keys masked, and one image's keys all masked; FFN + LayerNorm at
N = 12288 and 24576 tokens; each in bf16 (error against a float64 truth at
most 2x the plain version's, the FFN 1.1x) and float32 (within
ATTN_F32_TOL / FFN_F32_TOL of the plain version), with SDPA timed in turns
with the attention kernel over as many launches and the kernel's
two-exponential floor (`exp_floor_ms`) beside its bound, and the FFN
kernel (on its prepared weights, which must give the same bits as the
per-call layout) timed in turns with the port's unfused counterpart
(`unfused_ms`: EncoderLayer's cuBLAS path) beside its plan (tile, cluster,
blocks, `weight_l2_bytes`); and the
trunk kernels at the production shapes (batch 12, 1024^2 images): the stem
at (12, 1024, 1024, 3), the stem pool at (12, 510, 510, 64) (exact), the
stride-1 bottleneck at the five block shapes of the trunk and the stride-2
one at its three transitions, bf16 (2x rule; K4 and K5 1.1x) and float32
(TRUNK_F32_TOL of the output's scale), each timed beside its plain version
and the port's unfused counterpart (`unfused_ms`: cuDNN convolutions and
their passes); the stem record names the kernel, its tile in pool outputs
and its grid (bf16 stem_conv_pool_hopper: bands of 4 pool rows walked in
chunks of 64 columns, one block of 3 warpgroups per SM at most); each
bottleneck record names the kernel's tile, its cluster size, the weight
bytes it streams from L2 per call (`weight_l2_bytes`) and the scratch it
takes (`scratch_bytes`: bf16 K4's conv1 output).
Then a {"phase": "seconds"} line (each phase's wall seconds), a
{"kernels": [...]} line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.  Uses no JAX.

    python3 chip_smoke.py [--phases kernel,train,...]

runs the named phases only (device and build always run; the summary lines
need all phases).
"""

import argparse
import contextlib
import dataclasses
import glob
import hashlib
import io
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from scene_graph_commonsense_torch import bench
from scene_graph_commonsense_torch import config as config_lib
from scene_graph_commonsense_torch import __main__ as cli
from scene_graph_commonsense_torch.__main__ import synthetic_batches
from scene_graph_commonsense_torch.commonsense.pipeline import (
    run_prepare_cs)
from scene_graph_commonsense_torch.constants import (
    OBJ_ALP2FRE, VG_OBJECTS, class_weights)
from scene_graph_commonsense_torch.data.artifacts import load_vg_artifacts
from scene_graph_commonsense_torch.data.dataset import (
    VGDataset, batches_from_dataset, color_jitter_params)
from scene_graph_commonsense_torch.data import native as native_lib
from scene_graph_commonsense_torch.data.pipeline import (
    NativeRecordPipeline, to_device)
from scene_graph_commonsense_torch.data.synthetic import (
    BGR_MEAN, synthetic_batch, synthetic_images)
from scene_graph_commonsense_torch.device import disable_tf32
from scene_graph_commonsense_torch.eval import engines
from scene_graph_commonsense_torch.inference import SceneGraphPredictor
from scene_graph_commonsense_torch.models import detr as detr_lib
from scene_graph_commonsense_torch.models import resnet_fused
from scene_graph_commonsense_torch.models import weights
from scene_graph_commonsense_torch.models.predictors import (
    HierarchicalPredictor)
from scene_graph_commonsense_torch.models.relation_head import (
    make_relation_classifier)
from scene_graph_commonsense_torch.ops import _build, pair_pool, pairs
from scene_graph_commonsense_torch.ops import attention, ffn
from scene_graph_commonsense_torch.ops import bottleneck, stem
from scene_graph_commonsense_torch.ops import boxes as box_ops
from scene_graph_commonsense_torch.ops.detection import (
    postprocess_detections)
from scene_graph_commonsense_torch.ops.nms import class_aware_nms
from scene_graph_commonsense_torch.parallel import mesh as mesh_lib
from scene_graph_commonsense_torch.parallel import tp as tp_lib
from scene_graph_commonsense_torch.parallel.launch import run_processes
from scene_graph_commonsense_torch.tools.make_mini_oiv6 import (
    data_config, make_mini_oiv6)
from scene_graph_commonsense_torch.tools.make_mini_vg import make_mini_vg
from scene_graph_commonsense_torch.tools.precompute_features import (
    precompute_features)
from scene_graph_commonsense_torch.tools.sgrecords import write_sgrecords
from scene_graph_commonsense_torch.train import checkpoint as ckpt_lib
from scene_graph_commonsense_torch.train import engine
from scene_graph_commonsense_torch.train import loop, pnp_engine

# published H100 SXM peaks (NVIDIA data sheet, dense, at a 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
# exponentials (ex2 on the special function units): 16 per clock per SM on
# compute capability 9.0 (CUDA C++ programming guide, arithmetic
# instruction throughput), times the 132 SMs and the card's maximum SM
# clock as nvidia-smi reports it in this run
EXP_PER_CLOCK_PER_SM = 16
H100_SMS = 132
# exponentials the attention kernel takes per score: one in each of its two
# passes over the keys (the row max and sum, then p v)
ATTN_EXP_PER_SCORE = 2
# tolerances of the encoder kernels against their plain versions in float32
# (sums of 32 / 256 and 2048 products taken in another order; the FFN's
# LayerNorm divides by the row's deviation)
ATTN_F32_TOL = 1e-5
FFN_F32_TOL = 5e-5
# the trunk kernels in float32 against their plain versions, relative to
# the output's scale (max |plain|): sums of up to 9 * 512 products in
# another order, each rounded once in float32 (~1e-6 relative)
TRUNK_F32_TOL = 1e-5
# K4's and K5's bf16 error against the float64 truth, at most this times
# the plain version's: the same roundings (K4's of a and b, K5's of the
# images and the kernel), only the sums' order differs
SAME_ROUNDINGS_BF16_RATIO = 1.1
# the port's kernels: the module holding the launch counter, the counter,
# source, the TPU kernel it replaces
SOURCE = "scene_graph_commonsense_torch/csrc/pair_pool.cu"
PALLAS = "scene_graph_commonsense_tpu/ops/pallas/"
KERNELS = {
    "pair_pool": (pair_pool, "launches", SOURCE, PALLAS + "pair_pool.py:42"),
    "pair_pool_idx": (pair_pool, "idx_launches", SOURCE,
                      PALLAS + "pair_pool.py:47"),
    "pair_pool_bwd": (pair_pool, "bwd_launches", SOURCE,
                      PALLAS + "pair_pool.py:149"),
    "ffn_ln": (ffn, "launches", "scene_graph_commonsense_torch/csrc/ffn.cu",
               PALLAS + "ffn.py:34"),
    "attention": (attention, "launches",
                  "scene_graph_commonsense_torch/csrc/attention.cu",
                  PALLAS + "attention.py:36"),
    "stem_conv_pool": (stem, "conv_pool_launches",
                       "scene_graph_commonsense_torch/csrc/stem.cu",
                       PALLAS + "stem.py:55"),
    "stem_pool": (stem, "pool_launches",
                  "scene_graph_commonsense_torch/csrc/stem.cu",
                  PALLAS + "stem.py:172"),
    "bottleneck": (bottleneck, "launches",
                   "scene_graph_commonsense_torch/csrc/bottleneck.cu",
                   PALLAS + "bottleneck.py:78"),
    "bottleneck_s2": (bottleneck, "s2_launches",
                      "scene_graph_commonsense_torch/csrc/bottleneck.cu",
                      PALLAS + "bottleneck.py:145"),
}
# launches of each trunk and encoder kernel per encode dispatch at 1024^2
# with the fused trunk: the stem, 30 stride-1 blocks, 3 transitions, and
# one attention and one FFN per encoder layer
PER_ENCODE = {"stem_conv_pool": 1, "bottleneck": 30, "bottleneck_s2": 3,
              "ffn_ln": 6, "attention": 6}
# model.image_size 1020 (even, not divisible by 8; 32^2 features as at
# 1024): models/resnet_fused.py runs the plain 7x7/2 conv, then K6 (510^2
# -> 255^2); layer2_0 takes the odd 255^2 map and runs the plain block, so
# one stride-2 kernel fewer (layer3_0 at 128^2, layer4_0 at 64^2); 30
# stride-1 blocks and the encoder as at 1024
SIZE_K6 = 1020
PER_ENCODE_K6 = {"stem_pool": 1, "bottleneck": 30, "bottleneck_s2": 2,
                 "ffn_ln": 6, "attention": 6}
# the detection canvas (data.nonsq_canvas) and the launches per detect
# dispatch of 12 canvases: the stem (1000 % 8 == 0), 30 stride-1 blocks at
# 250^2, 125^2, 63^2 and 32^2, K4 at layer2_0 only (layer3_0 and layer4_0
# take odd inputs, 125^2 and 63^2, and run the plain fallback), one
# attention and one FFN per encoder layer; the decoder runs no kernel
CANVAS = 1000
PER_DETECT = {"stem_conv_pool": 1, "bottleneck": 30, "bottleneck_s2": 1,
              "ffn_ln": 6, "attention": 6}
# the trunk's blocks at the canvas, batch 12, as K3_CASES / K4_CASES
K3_CANVAS_CASES = (("layer1_0", 250, 250, 64, 64, True, 1),
                   ("layer1_1", 250, 250, 256, 64, False, 2),
                   ("layer2", 125, 125, 512, 128, False, 3),
                   ("layer3", 63, 63, 1024, 256, False, 22),
                   ("layer4", 32, 32, 2048, 512, False, 2))
K4_CANVAS_CASES = (("layer2_0", 250, 250, 256, 128),)
# phase real_data: a mini-VG of 60 JPEGs in the reference's on-disk format
# (36 train, 24 test), at VG's common sizes (height, width), taken in turn,
# so both the 1024^2 square view and the 1000^2 canvas resample and most
# canvases carry masked padding; the packer's thread counts timed
REAL_IMAGES = 60
REAL_TRAIN_FRAC = 0.6
REAL_SIZES = ((600, 800), (800, 600), (375, 500), (333, 500), (768, 1024))
PACKER_THREADS = (1, 8)


PAIR_POOL_KERNELS = ("pair_pool", "pair_pool_idx", "pair_pool_bwd")
# phase commonsense: the chunk size of the chunked path (pairs), and the
# train step's metrics, each a train/<metric> scalar of fit as in the JAX
# package (perf/<StepTimer key> from the 4th step, test/R@k and test/mR@k
# after the test pass)
CHUNK = 1024
TRAIN_METRICS = ("loss", "loss_relationship", "loss_connectivity",
                 "loss_commonsense", "loss_contrast", "num_connected",
                 "num_not_connected", "num_connected_pred",
                 "connectivity_precision_hits", "connectivity_recall_hits",
                 "num_pairs", "pair_overflow", "aug_pair_overflow")
TEST_TAGS = tuple(f"test/{m}@{k}" for m in ("R", "mR") for k in (20, 50, 100))


def reset_counts():
    for module, counter, _, _ in KERNELS.values():
        setattr(module, counter, 0)


def read_counts():
    return {name: getattr(module, counter)
            for name, (module, counter, _, _) in KERNELS.items()}


def expected(**counts):
    """A full launch-count dict: the named counts, 0 for every other
    kernel."""
    return {name: counts.get(name, 0) for name in KERNELS}


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters, issue=False):
    """Mean time of fn() over `iters` calls, by CUDA events, after two
    warm-up calls; with `issue`, (that time, the host's mean time to issue
    a call).  Their ratio alone cannot tell a host-bound call from a
    device-bound one whose launch queue fills: device_profile's busy share
    does."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    issue_s = 0.0
    start.record()
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        issue_s += time.perf_counter() - t
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    return (ms, issue_s * 1e3 / iters) if issue else ms


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    card = bench.card_name()
    print(card, flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    max_sm_mhz = float(smi.stdout.strip().splitlines()[0])
    info = {"phase": "device", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": card,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "max_sm_clock_mhz": max_sm_mhz,
            "exp_per_s": EXP_PER_CLOCK_PER_SM * H100_SMS * max_sm_mhz * 1e6}
    emit(info)
    return info


def phase_build():
    t0 = time.perf_counter()
    _build.build_all()
    secs = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in
                    _build.log_path(name).read_text().splitlines()
                    if "registers" in ln or "spill" in ln]
             if _build.log_path(name).exists() else []
             for name in _build.sources()}
    emit({"phase": "build", "seconds": secs, "sources": _build.sources(),
          "ptxas": ptxas})


def bound(nbytes, ops):
    """Least time for `nbytes` of device-memory traffic and `ops` float32
    operations at the card's published peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def pair_pool_bound(a, si, oj, out_elems, idx_bytes=0, ops_per_elem=8):
    """Least time for relu(maxpool2(a[si] + b[oj])) on these inputs: one
    write of the output (and of the int8 index, for the forward with
    index), one read of each stream row the pairs touch and of the indices,
    against `ops_per_elem` float32 operations per output element (8: 4
    adds, 3 maxes, 1 relu; the index adds 3 selects)."""
    row = a[0].numel() * a.element_size()
    touched = torch.unique(si).numel() + torch.unique(oj).numel()
    nbytes = out_elems * a.element_size() + idx_bytes + touched * row \
        + (si.numel() + oj.numel()) * si.element_size()
    return {**bound(nbytes, ops_per_elem * out_elems),
            "touched_rows": touched}


def pair_pool_bwd_bound(g, idx, si, oj, m):
    """Least time for the backward on these inputs: one read of g, idx and
    the indices, one write of ga and gb, against 2 float32 operations per g
    element for each of ga and gb (the winner test and the add)."""
    s = 2 * g.shape[1]
    out = 2 * m * s * s * g.shape[3] * g.element_size()
    nbytes = g.numel() * g.element_size() + idx.numel() + out \
        + (si.numel() + oj.numel()) * si.element_size()
    return bound(nbytes, 4 * g.numel())


def ulp_bf16(x):
    """The spacing of bfloat16 numbers at |x| (8 significant bits)."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def check_grad(got, want, mag, name):
    """got: the kernel's gradient, want: the plain version's on the same
    inputs (float32 sums in another order, by atomics, then rounded once),
    mag: the plain version's sums of |g| (float32).  float32: within
    1e-6 * mag, above any reordering error of these sums; bfloat16: within
    one bf16 ulp of the plain result plus the same float32 allowance.
    Returns (max abs err, max error in units of the tolerance)."""
    err = (got.float() - want.float()).abs()
    tol = 1e-6 * mag
    if got.dtype == torch.bfloat16:
        tol = tol + ulp_bf16(torch.maximum(got.float().abs(),
                                           want.float().abs()))
    ratio = float((err / tol.clamp_min(1e-30)).max())
    if not bool((err <= tol).all()):
        raise AssertionError(f"{name}: kernel gradient differs from the "
                             f"plain version by {ratio:.3g} x the "
                             f"tolerance (max abs err {float(err.max())})")
    return float(err.max()), ratio


def timed(kernel_fn, plain_fn, plain_iters=5, kernel_iters=20,
          library_fn=None):
    """plain, kernel, kernel, plain: both see the same clocks.  A library
    call is timed as the kernel is, each of its runs after a kernel run."""
    plain1 = cuda_ms(plain_fn, plain_iters)
    kern, lib = [], []
    for _ in range(2):
        kern.append(cuda_ms(kernel_fn, kernel_iters))
        if library_fn is not None:
            lib.append(cuda_ms(library_fn, kernel_iters))
    plain2 = cuda_ms(plain_fn, plain_iters)
    rec = {"ms": min(kern), "ms_runs": kern,
           "plain_ms": min(plain1, plain2), "plain_ms_runs": [plain1, plain2]}
    if library_fn is not None:
        rec.update(library_ms=min(lib), library_ms_runs=lib)
    return rec


def _pack_indices(p, dev):
    batch = synthetic_batch(np.random.default_rng(0), batch_size=12,
                            max_objects=20, with_aug=False)
    packed = pairs.pack_pairs(
        pairs.pair_validity(torch.as_tensor(batch["valid"], device=dev)), p)
    return packed.flat_sub, packed.flat_obj, int(packed.count)


def phase_kernel():
    """Each kernel vs its plain version at the production shape.  Returns,
    per kernel, the numbers of the main path's case (bf16, pack_pairs
    indices; P = 4560 for the eval forward, 1024 for training)."""
    m, s, c = 240, 32, 512
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    a32 = torch.randn((m, s, s, c), device=dev, generator=gen)
    b32 = torch.randn((m, s, s, c), device=dev, generator=gen)
    cases = [("pack_pairs", *_pack_indices(4560, dev)),
             ("pack_pairs", *_pack_indices(1024, dev))]
    cases.append(("random", *[torch.randint(
        0, m, (4560,), device=dev, generator=gen, dtype=torch.int32)
        for _ in range(2)], None))
    main = {}
    max_err = {name: 0.0 for name in PAIR_POOL_KERNELS}
    for idx_name, si, oj, live in cases:
        p = si.shape[0]
        for dtype in (torch.bfloat16, torch.float32):
            a, b = a32.to(dtype), b32.to(dtype)
            common = {"indices": idx_name, "dtype": str(dtype).split(".")[1],
                      "m": m, "s": s, "c": c, "p": p, "live_pairs": live}
            is_main = idx_name == "pack_pairs" and dtype == torch.bfloat16
            recs = {}

            # forward (eval): exact
            if p == 4560:
                got = pair_pool.pair_pool_kernel(a, b, si, oj)
                want = pair_pool.pair_pool_plain(a, b, si, oj)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"pair_pool kernel != plain ({idx_name}, {dtype}): "
                        f"max abs err {err}")
                rec = {**common, "max_abs_err": err, **timed(
                    lambda: pair_pool.pair_pool_kernel(a, b, si, oj),
                    lambda: pair_pool.pair_pool_plain(a, b, si, oj)),
                    **pair_pool_bound(a, si, oj, got.numel())}
                rec["no_reuse_bytes"] = (2 * 4 * p + p) * (s // 2) ** 2 * c \
                    * a.element_size()
                recs["pair_pool"] = rec
                del got, want

            # forward with index (training): out and idx exact
            out, idx = pair_pool.pair_pool_idx_kernel(a, b, si, oj)
            w_out, w_idx = pair_pool.pair_pool_idx_plain(a, b, si, oj)
            torch.cuda.synchronize()
            err = (out.float() - w_out.float()).abs().max().item()
            if not (torch.equal(out, w_out) and torch.equal(idx, w_idx)):
                raise AssertionError(
                    f"pair_pool_idx kernel != plain ({idx_name}, {dtype}): "
                    f"out err {err}, idx differs at "
                    f"{int((idx != w_idx).sum())} elements")
            slots = torch.bincount(idx.flatten().long() + 1, minlength=5)
            recs["pair_pool_idx"] = {
                **common, "max_abs_err": err,
                "idx_counts_clip_0_1_2_3": slots.tolist(), **timed(
                    lambda: pair_pool.pair_pool_idx_kernel(a, b, si, oj),
                    lambda: pair_pool.pair_pool_idx_plain(a, b, si, oj)),
                **pair_pool_bound(a, si, oj, out.numel(),
                                  idx_bytes=idx.numel(), ops_per_elem=11)}
            del out, w_out, w_idx

            # backward: within float32 rounding of the plain version
            g = torch.randn(idx.shape, device=dev, generator=gen).to(dtype)
            ga, gb = pair_pool.pair_pool_bwd_kernel(g, idx, si, oj, m)
            ga2, gb2 = pair_pool.pair_pool_bwd_kernel(g, idx, si, oj, m)
            w_ga, w_gb = pair_pool.pair_pool_bwd_plain(g, idx, si, oj, m)
            mag_a, mag_b = pair_pool.pair_pool_bwd_plain(
                g.float().abs(), idx, si, oj, m)
            torch.cuda.synchronize()
            if not (torch.equal(ga, ga2) and torch.equal(gb, gb2)):
                raise AssertionError("pair_pool_bwd is not deterministic")
            tag = f"pair_pool_bwd ({idx_name}, P={p}, {dtype})"
            err_a, ratio_a = check_grad(ga, w_ga, mag_a, tag + " ga")
            err_b, ratio_b = check_grad(gb, w_gb, mag_b, tag + " gb")
            del ga, gb, ga2, gb2, w_ga, w_gb, mag_a, mag_b
            recs["pair_pool_bwd"] = {
                **common, "max_abs_err": max(err_a, err_b),
                "max_err_over_tol": max(ratio_a, ratio_b),
                "deterministic": True, **timed(
                    lambda: pair_pool.pair_pool_bwd_kernel(g, idx, si, oj,
                                                           m),
                    lambda: pair_pool.pair_pool_bwd_plain(g, idx, si, oj,
                                                          m)),
                **pair_pool_bwd_bound(g, idx, si, oj, m)}
            del g, idx
            torch.cuda.empty_cache()

            for name, rec in recs.items():
                max_err[name] = max(max_err[name], rec["max_abs_err"])
                emit({"phase": "kernel", "name": name, **rec})
                main_p = 4560 if name == "pair_pool" else 1024
                if is_main and p == main_p:
                    main[name] = rec
    del a32, b32
    torch.cuda.empty_cache()
    return {name: {"max_abs_err": max_err[name],
                   **{k: main[name][k] for k in ("ms", "plain_ms",
                                                 "bound_ms", "bound_by")},
                   "library_ms": None}
            for name in PAIR_POOL_KERNELS}


def bound_terms(nbytes, **op_seconds):
    """Least time for `nbytes` of device-memory traffic and operation
    counts already divided by their peak rates (name -> seconds): the
    larger of the two, and which one bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, max(op_seconds.values())
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes,
            "op_ms": {k: v * 1e3 for k, v in op_seconds.items()}}


def product_rate(dtype):
    """Peak rate of the products a kernel does in `dtype`: the bf16 tensor
    cores, or float32 FMAs outside them (the port's float32 kernels)."""
    return BF16_TENSOR_OPS_PER_S if dtype == torch.bfloat16 \
        else FP32_OPS_PER_S


def attention_bound(q, valid, exp_per_s):
    """q, k, v read and out written once, the key mask read once; the two
    products (4 B H L^2 dh operations) at the peak rate of their dtype; one
    exponential per score.  Beside it the kernel's own floor: its two
    passes over the keys take ATTN_EXP_PER_SCORE exponentials per score at
    the same rate."""
    b, l, h, dh = q.shape
    nbytes = 4 * q.numel() * q.element_size() + valid.numel()
    flops = 4 * b * h * l * l * dh
    exps = b * h * l * l
    return {**bound_terms(nbytes, products=flops / product_rate(q.dtype),
                          exponentials=exps / exp_per_s),
            "flops": flops, "exponentials": exps,
            "exp_per_score": ATTN_EXP_PER_SCORE,
            "exp_floor_ms": ATTN_EXP_PER_SCORE * exps / exp_per_s * 1e3}


def ffn_bound(x, w1):
    """x read and y written once (float32), both weight matrices and the
    four vectors read once; 4 N D F operations of products at the peak rate
    of the weights' dtype."""
    n, d = x.shape
    f = w1.shape[1]
    nbytes = 2 * x.numel() * 4 + 2 * w1.numel() * w1.element_size() \
        + (f + 3 * d) * 4
    flops = 4 * n * d * f
    return {**bound_terms(nbytes, products=flops / product_rate(w1.dtype)),
            "flops": flops}


def close(got, want, tol):
    """max |got - want| / (tol (1 + |want|)): <= 1 means within atol and
    rtol `tol`."""
    return float(((got.float() - want.float()).abs()
                  / (tol * (1 + want.float().abs()))).max())


def attention_truth(q, k, v, valid, scale):
    """float64 attention of the same inputs with the kernel's -3e38 key
    fill (so an image whose keys are all masked is uniform)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * scale
    s = torch.where(valid[:, None, None, :], s,
                    torch.tensor(attention.MASK_FILL, dtype=torch.float64,
                                 device=s.device))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                        v.double())


def ffn_truth(x, w1, b1, w2, b2, g, beta):
    """float64 FFN + LayerNorm with the kernel's roundings of x and h to
    the weights' dtype, exact sums."""
    cd, f64 = w1.dtype, torch.float64
    h = torch.relu(x.to(cd).to(f64) @ w1.to(f64) + b1.to(f64))
    y = h.to(cd).to(f64) @ w2.to(f64) + b2.to(f64) + x.to(f64)
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    return (y - mu) / torch.sqrt(var + 1e-5) * g.to(f64) + beta.to(f64)


def check_bf16(name, got, want, truth, ratio=2.0):
    """The kernel's largest error against the float64 truth is at most
    `ratio` x the plain version's."""
    err = (got.double() - truth).abs().max().item()
    plain_err = (want.double() - truth).abs().max().item()
    if not err <= ratio * plain_err + 1e-6:
        raise AssertionError(f"{name}: bf16 error against float64 {err} > "
                             f"{ratio} x the plain version's {plain_err}")
    return {"err_vs_f64": err, "plain_err_vs_f64": plain_err}


def attention_record(q, k, v, valid, mask_name, scale, exp_per_s, phase):
    """K8 against its plain version on these inputs (float32: within
    ATTN_F32_TOL; bf16: the 2x rule against the float64 truth; an image
    whose keys are all masked: uniform), timed in turns with the plain
    version and SDPA beside its bound; emits and returns the record."""
    b, l, h, dh = q.shape
    dtype = q.dtype
    got = attention.attention_kernel(q, k, v, valid, scale=scale)
    want = attention.attention_plain(q, k, v, valid, scale=scale)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    rec = {"b": b, "l": l, "h": h, "dh": dh, "mask": mask_name,
           "masked_keys": 1 - valid.float().mean().item(),
           "dtype": str(dtype).split(".")[1], "max_abs_err": err}
    if dtype == torch.float32:
        ratio = close(got, want, ATTN_F32_TOL)
        if ratio > 1:
            raise AssertionError(f"attention kernel vs plain ({mask_name}, "
                                 f"f32, B={b}): {ratio:.3g} x the "
                                 f"tolerance")
        rec["max_err_over_tol"] = ratio
    else:
        rec.update(check_bf16(f"attention ({mask_name}, B={b})", got, want,
                              attention_truth(q, k, v, valid, scale)))
    if not valid.any(dim=1).all():
        i = int((~valid.any(dim=1)).nonzero()[0])
        uniform = v[i].float().mean(dim=0).expand_as(got[i])
        uerr = (got[i].float() - uniform).abs().max().item()
        if uerr > (2e-2 if dtype == torch.bfloat16 else 1e-5):
            raise AssertionError(f"attention: a fully masked image is not "
                                 f"uniform ({uerr})")
        rec["masked_image_uniform_err"] = uerr
    del got, want
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa_mask = valid[:, None, None, :]
    rec.update(timed(
        lambda: attention.attention_kernel(q, k, v, valid, scale=scale),
        lambda: attention.attention_plain(q, k, v, valid, scale=scale),
        library_fn=lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=sdpa_mask, scale=scale)))
    rec["library"] = "F.scaled_dot_product_attention"
    rec.update(attention_bound(q, valid, exp_per_s))
    emit({"phase": phase, "name": "attention", **rec})
    del qt, kt, vt
    torch.cuda.empty_cache()
    return rec


def phase_kernel_encoder(exp_per_s):
    """The encoder kernels vs their plain versions at the DETR shapes, B =
    12 (the serving batch) and 24 (fit's two views in one dispatch).
    Returns, per kernel, the numbers of the main path's case (bf16, B = 12,
    all keys valid as the encoder passes them)."""
    dev = torch.device("cuda")
    disable_tf32()
    gen = torch.Generator(device=dev).manual_seed(1)
    scale = 1.0 / math.sqrt(32)
    main, max_err = {}, {"attention": 0.0, "ffn_ln": 0.0}
    for b in (12, 24):
        l = 1024
        qkv32 = [torch.randn((b, l, 8, 32), device=dev, generator=gen)
                 for _ in range(3)]
        masks = {"all_valid": torch.ones((b, l), dtype=torch.bool,
                                         device=dev),
                 "random_80pct_masked": torch.rand(
                     (b, l), device=dev, generator=gen) >= 0.8,
                 "one_image_masked": torch.ones((b, l), dtype=torch.bool,
                                                device=dev)}
        masks["random_80pct_masked"][:, 0] = True
        masks["one_image_masked"][0] = False
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (t.to(dtype) for t in qkv32)
            for mask_name, valid in masks.items():
                rec = attention_record(q, k, v, valid, mask_name, scale,
                                       exp_per_s, "kernel")
                max_err["attention"] = max(max_err["attention"],
                                           rec["max_abs_err"])
                if b == 12 and dtype == torch.bfloat16 \
                        and mask_name == "all_valid":
                    main["attention"] = rec
        del qkv32, masks

    for n in (12288, 24576):
        x = torch.randn((n, 256), device=dev, generator=gen)
        w1 = torch.randn((256, 2048), device=dev, generator=gen) / 16
        w2 = torch.randn((2048, 256), device=dev, generator=gen) \
            / math.sqrt(2048)
        b1 = torch.randn(2048, device=dev, generator=gen)
        b2 = torch.randn(256, device=dev, generator=gen)
        g = 1 + 0.1 * torch.randn(256, device=dev, generator=gen)
        beta = 0.1 * torch.randn(256, device=dev, generator=gen)
        for dtype in (torch.bfloat16, torch.float32):
            w1c, w2c = w1.to(dtype), w2.to(dtype)
            args = (x, w1c, b1, w2c, b2, g, beta)
            prep = ffn.kernel_weights(w1c, w2c)    # as EncoderLayer keeps it
            got = ffn.ffn_ln_kernel(*args, prepared=prep)
            want = ffn.ffn_ln_plain(*args, compute_dtype=dtype)
            if not torch.equal(got, ffn.ffn_ln_kernel(*args)):
                raise AssertionError(f"ffn_ln kernel with prepared weights "
                                     f"!= without (N={n}, {dtype})")
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            rec = {"n": n, "d": 256, "f": 2048,
                   "dtype": str(dtype).split(".")[1], "max_abs_err": err,
                   **ffn_plan(x, w1c)}
            if dtype == torch.float32:
                ratio = close(got, want, FFN_F32_TOL)
                if ratio > 1:
                    raise AssertionError(f"ffn_ln kernel vs plain (f32, "
                                         f"N={n}): {ratio:.3g} x the "
                                         f"tolerance")
                rec["max_err_over_tol"] = ratio
            else:
                rec.update(check_bf16(f"ffn_ln (N={n})", got, want,
                                      ffn_truth(*args)))
            del got, want
            # the port's unfused counterpart: EncoderLayer with
            # flash_encoder off (cuBLAS products, then the passes)
            layer = detr_lib.EncoderLayer(dtype=dtype).to(dev)
            with torch.no_grad():
                layer.linear1.weight.copy_(w1.t())
                layer.linear1.bias.copy_(b1)
                layer.linear2.weight.copy_(w2.t())
                layer.linear2.bias.copy_(b2)
                layer.norm2.weight.copy_(g)
                layer.norm2.bias.copy_(beta)

            def unfused():
                with torch.no_grad():
                    h = torch.relu(detr_lib._dense(layer.linear1, x, dtype))
                    y = detr_lib._dense(layer.linear2, h, dtype)
                    return detr_lib._layer_norm(layer.norm2, x + y)

            t = timed(lambda: ffn.ffn_ln_kernel(*args, prepared=prep),
                      lambda: ffn.ffn_ln_plain(*args, compute_dtype=dtype),
                      library_fn=unfused)
            t["unfused_ms"] = t.pop("library_ms")
            t["unfused_ms_runs"] = t.pop("library_ms_runs")
            rec.update(t)
            rec["library_ms"] = None    # no single PyTorch call computes it
            rec.update(ffn_bound(x, w1c))
            max_err["ffn_ln"] = max(max_err["ffn_ln"], err)
            emit({"phase": "kernel", "name": "ffn_ln", **rec})
            if n == 12288 and dtype == torch.bfloat16:
                main["ffn_ln"] = rec
            del layer, prep
        torch.cuda.empty_cache()
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {"attention": {"max_abs_err": max_err["attention"],
                          **{k: main["attention"][k] for k in keys}},
            "ffn_ln": {"max_abs_err": max_err["ffn_ln"],
                       **{k: main["ffn_ln"][k]
                          for k in keys + ("unfused_ms",)}}}


def ffn_plan(x, w1):
    """The FFN kernel's plan and the weight bytes it streams from L2 per
    call: bf16 ffn_ln_hopper, 128-token tiles in 2-block clusters that
    share each weight chunk (every cluster reads both matrices once);
    float32 ffn_ln_kernel, one block a 32-token tile reading both."""
    n, f = x.shape[0], w1.shape[1]
    weights = 2 * w1.numel() * w1.element_size()
    if w1.dtype == torch.bfloat16:
        plan = ffn.hopper_plan()
        tiles = -(-n // plan["tile_rows"])
        clusters = -(-tiles // plan["cluster"])
        return {"kernel": "ffn_ln_hopper", **plan,
                "blocks": clusters * plan["cluster"],
                "weight_l2_bytes": clusters * weights}
    tiles = -(-n // 32)
    return {"kernel": "ffn_ln_kernel", "tile_rows": 32, "cluster": 1,
            "blocks": tiles, "weight_l2_bytes": tiles * weights}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bottleneck_bound(x, blk, out):
    """x read, y written, the weights and folds read once; the products of
    conv1 on every input pixel, conv2, conv3 and the projection on every
    output pixel at the peak rate of x's dtype."""
    b, h, w, c = x.shape
    m, co = blk.w1.shape[1], blk.w3.shape[1]
    p_in, p_out = b * h * w, out.numel() // co
    flops = 2 * (p_in * c * m + p_out * (9 * m * m + m * co
                                         + (c * co if blk.wd is not None
                                            else 0)))
    moved = nbytes(x, out, *blk.args())
    return {**bound_terms(moved, products=flops / product_rate(x.dtype)),
            "flops": flops}


def weight_stream(x, blk, stride):
    """A bottleneck kernel's output tile, cluster size, the weight bytes it
    streams from L2 per call and the scratch it takes: every cluster of
    tiles reads all of the weights it applies once (bf16: the Hopper
    kernels' plan, 2-block clusters that share each weight chunk; at
    stride 2 the conv1 kernel reads w1 once per cluster of its row tiles
    and the second kernel w2, w3 and wd once per cluster of output tiles,
    beside the scratch a between them; float32: the mma.sync template's
    4 x 4 tile, one block a tile)."""
    b, h, w, _ = x.shape
    m = blk.w1.shape[1]
    ho, wo = h // stride, w // stride
    scratch = bottleneck.scratch_shape(x, m, stride)
    if x.dtype == torch.bfloat16:
        plan = bottleneck.hopper_plan(m, blk.wd is not None, stride)
        th, tw, cluster = plan["tile_h"], plan["tile_w"], plan["cluster"]
    else:
        th, tw, cluster = 4, 4, 1
    tiles = -(-ho // th) * -(-wo // tw)
    clusters = b * -(-tiles // cluster)
    if scratch is None:
        streamed = clusters * nbytes(blk.w1, blk.w2, blk.w3, blk.wd)
    else:
        conv1_tiles = -(-b * h * w // plan["conv1_tile_rows"])
        streamed = -(-conv1_tiles // cluster) * nbytes(blk.w1) \
            + clusters * nbytes(blk.w2, blk.w3, blk.wd)
    return {"tile": [th, tw], "cluster": cluster,
            "weight_l2_bytes": streamed,
            "scratch_bytes": 0 if scratch is None
            else math.prod(scratch) * x.element_size()}


def stem_bound(images, w7, fold, out):
    """The float32 images, kernel and fold read once, the pooled output
    written once; 2 x 147 x 64 operations per conv output pixel at the
    peak rate of the compute dtype."""
    b, h, w, _ = images.shape
    flops = 2 * b * (h // 2) * (w // 2) * 147 * 64
    return {**bound_terms(nbytes(images, w7, fold, out),
                          products=flops / product_rate(w7.dtype)),
            "flops": flops}


def stem_plan(images, dtype):
    """The stem kernel's tile in pool outputs (rows, columns) and grid:
    bf16 stem_conv_pool_hopper, a persistent grid of at most one block per
    SM, each warpgroup walking bands of pool rows in chunks of columns;
    float32 one block per 4 x 8 tile."""
    b, h, w, _ = images.shape
    if dtype == torch.bfloat16:
        rows, cells = stem.HOPPER_ROWS, stem.HOPPER_CELLS
        wgs = stem.HOPPER_WARPGROUPS
        bands = b * -(-(h // 4) // rows)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        return {"kernel": "stem_conv_pool_hopper", "tile": [rows, cells],
                "bands": bands, "chunks_per_band": -(-(w // 4) // cells),
                "warpgroups_per_block": wgs,
                "blocks": min(-(-bands // wgs), sms), "blocks_per_sm": 1}
    tiles = b * -(-(h // 4) // 4) * -(-(w // 4) // 8)
    return {"kernel": "stem_conv_pool_kernel", "tile": [4, 8],
            "blocks": tiles}


def stem_pool_bound(x, fold, out):
    """x read and out written once; a multiply, an add and a max with 0 per
    input element and 8 maxes per output element, float32."""
    ops = 3 * x.numel() + 8 * out.numel()
    return bound_terms(nbytes(x, fold, out), elementwise=ops / FP32_OPS_PER_S)


def random_bottleneck(cin, m, stride, proj, gen, dev):
    """A port Bottleneck with seeded random weights and frozen-BN
    statistics (so that the folds are not trivial)."""
    blk = detr_lib.Bottleneck(cin, m, stride, downsample=proj)
    with torch.no_grad():
        for mod in blk.modules():
            if isinstance(mod, torch.nn.Conv2d):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(0, fan_in ** -0.5, generator=gen)
            elif isinstance(mod, detr_lib.FrozenBatchNorm):
                mod.weight.uniform_(0.5, 1.5, generator=gen)
                mod.bias.normal_(0, 0.2, generator=gen)
                mod.running_mean.normal_(0, 0.5, generator=gen)
                mod.running_var.uniform_(0.5, 2.0, generator=gen)
    return blk.to(dev).eval().requires_grad_(False)


def bottleneck_truth(x, blk, stride):
    """float64 block with the kernel's roundings of a and b to x's dtype,
    exact sums."""
    cd, f = x.dtype, torch.float64
    w1, s1, w2, s2, w3, s3, wd, sd = (None if t is None else t.to(f)
                                      for t in blk.args())
    xf = x.to(f)
    a = torch.relu(xf @ w1 * s1[0] + s1[1]).to(cd).to(f)
    acc = F.conv2d(a.permute(0, 3, 1, 2), w2.permute(3, 2, 0, 1),
                   stride=stride, padding=1).permute(0, 2, 3, 1)
    b = torch.relu(acc * s2[0] + s2[1]).to(cd).to(f)
    c = b @ w3 * s3[0] + s3[1]
    idn = xf if wd is None else xf[:, ::stride, ::stride] @ wd * sd[0] + sd[1]
    return torch.relu(c + idn)


def stem_truth(images, w7, fold):
    """float64 stem on the compute-dtype-rounded images and kernel, exact
    sums."""
    f = torch.float64
    x = images.to(w7.dtype).to(f).permute(0, 3, 1, 2)
    conv = F.conv2d(x, w7.to(f).permute(3, 2, 0, 1), stride=2, padding=3)
    s = fold.to(f)
    v = torch.relu(conv * s[0][:, None, None] + s[1][:, None, None])
    return F.max_pool2d(v, 3, 2, 1).permute(0, 2, 3, 1)


def check_trunk_kernel(name, got, want, truth_fn, bf16_ratio=2.0):
    """float32: within TRUNK_F32_TOL of the output's scale; bf16: at most
    bf16_ratio x the plain version's error against the float64 truth."""
    err = (got.float() - want.float()).abs().max().item()
    rec = {"max_abs_err": err}
    if got.dtype == torch.float32:
        ratio = err / (TRUNK_F32_TOL * want.abs().max().item())
        if ratio > 1:
            raise AssertionError(f"{name}: float32 kernel vs plain "
                                 f"{ratio:.3g} x the tolerance")
        rec["max_err_over_tol"] = ratio
    else:
        rec.update(check_bf16(name, got, want, truth_fn(), bf16_ratio))
    return rec


# the trunk's stride-1 blocks at 1024^2, batch 12: (name, H, W, C_in, M,
# projection, launches per encode); C_out = 4 M
K3_CASES = (("layer1_0", 256, 256, 64, 64, True, 1),
            ("layer1_1", 256, 256, 256, 64, False, 2),
            ("layer2", 128, 128, 512, 128, False, 3),
            ("layer3", 64, 64, 1024, 256, False, 22),
            ("layer4", 32, 32, 2048, 512, False, 2))
# the transitions: (name, H, W, C_in, M)
K4_CASES = (("layer2_0", 256, 256, 256, 128), ("layer3_0", 128, 128, 512, 256),
            ("layer4_0", 64, 64, 1024, 512))


def trunk_timing(kernel_fn, plain_fn, unfused_fn, dtype):
    """A trunk kernel beside its plain version (in turns, `timed`) and the
    port's unfused counterpart; fewer runs of the slow float32 kernels."""
    few = dtype == torch.float32
    rec = timed(kernel_fn, plain_fn, plain_iters=2 if few else 3,
                kernel_iters=3 if few else 10)
    rec["unfused_ms"] = cuda_ms(unfused_fn, 3)
    return rec


def _launch_mean(recs, weights_, key):
    return sum(r[key] * n for r, n in zip(recs, weights_)) / sum(weights_)


def stem_records(side, phase, gen, cpu_gen, dev, b=12):
    """K5 against its plain version on (b, side, side, 3) images, bf16
    (1.1x rule) and float32, each timed beside the plain version and the
    cuDNN stem; emits and returns both records (bf16 first)."""
    net = detr_lib.ResNet101((0, 0, 0, 0))
    with torch.no_grad():
        net.conv1.weight.normal_(0, 147 ** -0.5, generator=cpu_gen)
        net.bn1.running_var.uniform_(0.5, 2.0, generator=cpu_gen)
        net.bn1.bias.normal_(0, 0.2, generator=cpu_gen)
    net = net.to(dev).requires_grad_(False)
    images = torch.randn((b, side, side, 3), device=dev, generator=gen)
    recs = []
    for dtype in (torch.bfloat16, torch.float32):
        prep = resnet_fused.prepared(net, dtype)
        args = (images, prep.stem_w7, prep.stem_fold)
        got = stem.stem_conv_pool_kernel(*args, prep.stem_wk)
        want = stem.stem_conv_pool_plain(*args, compute_dtype=dtype)
        torch.cuda.synchronize()
        rec = {"shape": list(images.shape), "dtype": str(dtype)[6:],
               **stem_plan(images, dtype),
               **check_trunk_kernel("stem_conv_pool", got, want,
                                    lambda: stem_truth(*args),
                                    SAME_ROUNDINGS_BF16_RATIO),
               **trunk_timing(
                   lambda: stem.stem_conv_pool_kernel(*args, prep.stem_wk),
                   lambda: stem.stem_conv_pool_plain(*args,
                                                     compute_dtype=dtype),
                   lambda: net(images, dtype), dtype),
               "library_ms": None, **stem_bound(*args, got)}
        del got, want
        emit({"phase": phase, "name": "stem_conv_pool", **rec})
        recs.append(rec)
    del images, net
    torch.cuda.empty_cache()
    return recs


def block_records(name, cases, stride, phase, gen, cpu_gen, dev, b=12):
    """K3 (stride 1) or K4 (stride 2) against its plain version at each
    case's block shape, bf16 (2x rule; K4 1.1x) and float32, each timed
    beside the plain version and the port's unfused block; emits every
    record.  Returns the bf16 records, each case's launches (K3: the
    case's last field; K4: 1) and the largest error."""
    main, counts, max_err = [], [], 0.0
    kernel = bottleneck.bottleneck_kernel if stride == 1 \
        else bottleneck.bottleneck_s2_kernel
    plain = bottleneck.fused_bottleneck_plain if stride == 1 \
        else bottleneck.fused_bottleneck_s2_plain
    for case in cases:
        label, h, w, cin, m = case[:5]
        proj = case[5] if stride == 1 else True
        mod = random_bottleneck(cin, m, stride, proj, cpu_gen, dev)
        x32 = torch.randn((b, h, w, cin), device=dev, generator=gen)
        for dtype in (torch.bfloat16, torch.float32):
            blk = resnet_fused.prepare_block(mod, stride, dtype)
            x = x32.to(dtype)
            got = kernel(x, *blk.args())
            want = plain(x, *blk.args())
            torch.cuda.synchronize()
            rec = {"case": label, "shape": list(x.shape), "m": m,
                   "co": 4 * m, "dtype": str(dtype)[6:],
                   **check_trunk_kernel(
                       f"{name} {label}", got, want,
                       lambda: bottleneck_truth(x, blk, stride),
                       SAME_ROUNDINGS_BF16_RATIO if stride == 2 else 2.0),
                   "library_ms": None, **bottleneck_bound(x, blk, got),
                   **weight_stream(x, blk, stride)}
            del got, want
            x_nchw = x.permute(0, 3, 1, 2)
            rec.update(trunk_timing(lambda: kernel(x, *blk.args()),
                                    lambda: plain(x, *blk.args()),
                                    lambda: mod(x_nchw, dtype), dtype))
            emit({"phase": phase, "name": name, **rec})
            max_err = max(max_err, rec["max_abs_err"])
            if dtype == torch.bfloat16:
                main.append(rec)
                counts.append(case[6] if stride == 1 else 1)
            del x, x_nchw, blk
            torch.cuda.empty_cache()
        del mod, x32
    return main, counts, max_err


def phase_kernel_trunk():
    """The trunk kernels vs their plain versions at the production shapes
    (batch 12, 1024^2 images; K6 at the stem conv output of 1020^2 images),
    bf16 and float32, each timed beside its plain version and the port's
    unfused counterpart (cuDNN and its passes).  Returns, per kernel, the
    bf16 numbers as a mean per launch over one encode's launches (K6: its
    one case)."""
    dev = torch.device("cuda")
    disable_tf32()
    gen = torch.Generator(device=dev).manual_seed(3)
    cpu_gen = torch.Generator().manual_seed(4)
    b = 12
    summary = {}

    # K5: the whole stem at (12, 1024, 1024, 3)
    recs = stem_records(1024, "kernel", gen, cpu_gen, dev, b)
    summary["stem_conv_pool"] = {**recs[0], "max_abs_err": max(
        r["max_abs_err"] for r in recs)}

    # K6: BN + ReLU + pool of the stem conv output of 1020^2 images
    bn = detr_lib.FrozenBatchNorm(64)
    with torch.no_grad():
        bn.running_var.uniform_(0.5, 2.0, generator=cpu_gen)
        bn.bias.normal_(0, 0.2, generator=cpu_gen)
    bn = bn.to(dev)
    fold = bottleneck.fold_bn(bn)
    conv32 = torch.randn((b, 510, 510, 64), device=dev, generator=gen)
    recs = []
    for dtype in (torch.bfloat16, torch.float32):
        conv = conv32.to(dtype)
        got = stem.stem_pool_kernel(conv, fold)
        want = stem.stem_pool_plain(conv, fold)
        torch.cuda.synchronize()
        if stem.last_pool_kernel != "stem_pool_hopper":
            raise AssertionError(f"stem_pool ran {stem.last_pool_kernel} at "
                                 f"{tuple(conv.shape)} {dtype}")
        if not torch.equal(got, want):
            raise AssertionError(f"stem_pool kernel != plain ({dtype}): "
                                 f"{(got.float() - want.float()).abs().max()}")
        nchw = conv.permute(0, 3, 1, 2)
        rec = {"shape": list(conv.shape), "dtype": str(dtype)[6:],
               "kernel": stem.last_pool_kernel,
               "tile": [stem.POOL_ROWS, stem.POOL_COLS,
                        min(conv.shape[3],
                            stem.POOL_CHUNK_BYTES // conv.element_size())],
               "max_abs_err": 0.0, "exact": True,
               **trunk_timing(
                   lambda: stem.stem_pool_kernel(conv, fold),
                   lambda: stem.stem_pool_plain(conv, fold),
                   lambda: F.max_pool2d(torch.relu(bn(nchw, dtype)),
                                        3, 2, 1), dtype),
               "library_ms": None, **stem_pool_bound(conv, fold, got)}
        del got, want
        emit({"phase": "kernel", "name": "stem_pool", **rec})
        recs.append(rec)
    summary["stem_pool"] = recs[0]
    del conv32, conv
    torch.cuda.empty_cache()

    # K3 and K4 at the trunk's shapes
    for name, cases, stride in (("bottleneck", K3_CASES, 1),
                                ("bottleneck_s2", K4_CASES, 2)):
        main, counts, max_err = block_records(name, cases, stride, "kernel",
                                              gen, cpu_gen, dev, b)
        # per launch over one encode: the launch-weighted means, bound by
        # what bounds the case with the most launches
        summary[name] = {
            "max_abs_err": max_err,
            "bound_by": main[counts.index(max(counts))]["bound_by"],
            **{k: _launch_mean(main, counts, k) for k in (
                "ms", "plain_ms", "unfused_ms", "bound_ms")},
            "library_ms": None}
    return {name: {k: rec[k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "unfused_ms")} for name, rec in summary.items()}


def phase_slice():
    """PredCLS eval + serving at full VG width through the port's entry
    points."""
    cfg = config_lib.derive("vg", hierarchical_pred=True, run_mode="eval",
                            training={"batch_size": 12})
    t0 = time.perf_counter()
    model = make_relation_classifier(
        cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    init_s = time.perf_counter() - t0
    batches = list(synthetic_batches(cfg, 3, seed=100))
    estep = engine.make_eval_step(model, cfg, device="cuda")
    estep(batches[0])                             # warm-up (cuDNN plans)
    torch.cuda.synchronize()

    seen = []

    def checked_step(batch):
        out = estep(batch)
        seen.append({k: out[k] for k in ("relation", "super_relation",
                                         "connectivity", "pair_count")})
        return out

    artifacts = load_vg_artifacts("datasets/artifacts")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = engines.run_eval_pc(cfg, model, batches, artifacts=artifacts,
                              estep=checked_step, device="cuda")
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = read_counts()
    predictor = SceneGraphPredictor(cfg, model, device="cuda")
    request = {k: v for k, v in batches[0].items() if k != "rel"}
    t0 = time.perf_counter()
    graphs = predictor.predict(request, top_k=50)
    predict_s = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    cap = cfg.pair_capacity
    for out in seen:
        for k in ("relation", "super_relation", "connectivity"):
            if not bool(torch.isfinite(out[k]).all()):
                raise AssertionError(f"non-finite {k} on the main path")
        assert out["relation"].shape == (cap, cfg.model.num_relations)
        assert out["super_relation"].shape == (cap, 3)
        assert out["connectivity"].shape == (cap,)
    for key in ("recall", "mean_recall"):
        assert all(0.0 <= r <= 1.0 for r in res[key]), (key, res[key])
        assert all(0.0 <= r <= 1.0 for r in res["top3"][key]), key
    assert len(graphs) == cfg.training.batch_size
    n_edges = sum(len(g) for g in graphs)
    assert n_edges > 0, "the predictor returned no edges"
    assert all(np.isfinite(e["confidence"]) for g in graphs for e in g)
    # eval and serving launch the forward kernel once per batch and never
    # the training kernels (no gradient in flight)
    expect = expected(pair_pool=len(batches))
    if eval_launches != expect:
        raise AssertionError(f"launches over {len(batches)} eval batches: "
                             f"{eval_launches}, expected {expect}")
    expect["pair_pool"] += 1
    if launches != expect:
        raise AssertionError(f"launches on the eval/serving path: "
                             f"{launches}, expected {expect}")

    # device time of one eval step, after the warm-up above
    step_ms = [cuda_ms(lambda b=b: estep(b), 3) for b in batches]
    emit({"phase": "slice", "batch_size": cfg.training.batch_size,
          "max_objects": cfg.data.max_objects,
          "pair_capacity": cap, "compute_dtype": cfg.model.compute_dtype,
          "live_pairs": [int(o["pair_count"][0]) for o in seen],
          "recall": res["recall"], "mean_recall": res["mean_recall"],
          "recall_zs": res["recall_zs"], "top3": res["top3"],
          "num_targets": res["num_targets"], "predict_edges": n_edges,
          "launches": launches, "eval_step_ms": step_ms,
          "run_eval_pc_s": eval_s, "predict_s": predict_s,
          "init_s": init_s, "peak_mem_gb": peak_gb})
    return launches, (cfg, model, estep, batches, artifacts)


PROFILED = "chip_smoke.profiled"


def device_profile(fn, n, top_ops=16, groups=None):
    """torch.profiler over fn(): device busy share of the wall time, kernels
    by name, operators by input shape, per call of n; with `groups` (label
    -> substrings of kernel names) also each group's device time.

    fn runs twice with the tracer on, a warm-up and the call that counts,
    marked by a record_function range: only what starts inside it is
    counted.  A trace at times lacked the first kernel of its window or of
    such a range (the fused trunk's stem kernel, an encode's first): the
    trace's device times drift from its host times by milliseconds, so
    device events are counted from the range's own device span (its first
    kernel's start, on the device's clock) where the trace holds one; the
    warm-up and the pause keep the warm-up's kernels apart."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
        with record_function(PROFILED):
            # a pause keeps the warm-up's kernels apart from the range's
            time.sleep(0.005)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    # the range's host event, and the device span the profiler adds under
    # the same name (its kernels' first start); 1 ms of margin before the
    # span, which the 5 ms pause keeps clear of the warm-up's kernels
    marks = [e.time_range.start for e in events
             if e.name == PROFILED and e.device_type == DeviceType.CPU]
    if len(marks) != 1:
        raise AssertionError(f"the trace holds {len(marks)} marked ranges")
    spans = [e.time_range.start for e in events
             if e.name == PROFILED and e.device_type == DeviceType.CUDA]
    device_start = min(spans) - 1000 if spans else marks[0]
    events = [e for e in events if e.name != PROFILED and e.time_range.start
              >= (device_start if e.device_type == DeviceType.CUDA
                  else marks[0])]
    kernels = {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    busy_us = sum(kernels.values())
    n_device = sum(e.device_type == DeviceType.CUDA for e in events)
    if busy_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    top_kernels = sorted(kernels.items(), key=lambda kv: -kv[1])[:14]
    grouped = {label: sum(t for name, t in kernels.items()
                          if any(p in name for p in parts)) / 1e3 / n
               for label, parts in (groups or {}).items()}

    ops = {}                  # (operator, input shapes) -> [calls, self us]
    for e in events:
        if e.device_type == DeviceType.CPU and e.self_device_time_total > 0:
            op = ops.setdefault((e.name, str(e.input_shapes)[:120]), [0, 0.0])
            op[0] += 1
            op[1] += e.self_device_time_total
    top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:top_ops]
    return {"calls": n,
            "wall_ms_per_call": wall_us / 1e3 / n,
            "device_ms_per_call": busy_us / 1e3 / n,
            "device_busy_share": busy_us / wall_us,
            "device_events_per_call": n_device / n,
            "group_ms_per_call": grouped,
            "top_kernels": [{"name": k[:90], "ms_per_call": v / 1e3 / n,
                             "share": v / busy_us}
                            for k, v in top_kernels],
            "top_ops": [{"op": op, "shapes": shapes, "calls_per_call": c / n,
                         "ms_per_call": us / 1e3 / n, "share": us / busy_us}
                        for (op, shapes), (c, us) in top]}


def phase_profile(cfg, model, estep, batches, artifacts):
    """Where the device time of run_eval_pc goes, per batch.  The
    profiler's own cost is in its wall time; phase `slice` has the
    unprofiled one."""
    emit({"phase": "profile", **device_profile(
        lambda: engines.run_eval_pc(cfg, model, batches,
                                    artifacts=artifacts, estep=estep),
        len(batches))})


def phase_train():
    """PredCLS training at bench.py's configuration through the train step
    of train.loop.fit, then one fit epoch.  Returns the training kernels'
    launches over the timed steps."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, model, step, state, batch = bench.setup(seed=0, device="cuda")
    init_s = time.perf_counter() - t0
    before = {k: v.detach().float().clone() for k, v in
              (("fc1", model.fc1.weight[:8]),
               ("conv2_sub", model.conv2_sub.weight),
               ("emb_c1", model.emb_c1.weight))}
    warmup, steps = 2, 6
    seen = []
    for _ in range(warmup):
        state, metrics = step(state, batch)
        seen.append(metrics)
    torch.cuda.synchronize()
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        state, metrics = step(state, batch)
        seen.append(metrics)
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts()
    device_ms = start.elapsed_time(end) / steps
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect = expected(pair_pool_idx=2 * steps, pair_pool_bwd=2 * steps)
    if launches != expect:
        raise AssertionError(f"train step launches over {steps} steps: "
                             f"{launches}, expected {expect}")
    metrics = [{k: float(v) for k, v in m.items()} for m in seen]
    for mt in metrics:
        bad = [k for k, v in mt.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite train metrics {bad}")
    moved = {k: float((getattr(model, k).weight[:8] if k == "fc1"
                       else getattr(model, k).weight).detach().float()
                      .sub(v).abs().max()) for k, v in before.items()}
    if not all(d > 0 for d in moved.values()):
        raise AssertionError(f"parameters did not change: {moved}")
    flops = bench.train_step_flops(cfg)
    emit({"phase": "train", "batch_size": cfg.training.batch_size,
          "pair_capacity": cfg.pair_capacity,
          "aug_capacity": engine.aug_pair_capacity(cfg),
          "compute_dtype": cfg.model.compute_dtype,
          "live_pairs": metrics[-1]["num_pairs"],
          "steps": steps, "warmup": warmup, "launches": launches,
          "step_device_ms": device_ms, "step_wall_ms": wall_s * 1e3 / steps,
          "img_per_s": cfg.training.batch_size * steps / wall_s,
          "train_step_tflop": flops / 1e12,
          "mfu_pct": 100 * flops / (wall_s / steps) / bench.PEAK_BF16_FLOPS,
          "peak_mem_gb": peak_gb, "init_s": init_s,
          "param_max_change": moved,
          "losses_first_last": [{k: v for k, v in mt.items()
                                 if k.startswith("loss")}
                                for mt in (metrics[0], metrics[-1])],
          "pair_overflow": metrics[-1]["pair_overflow"],
          "aug_pair_overflow": metrics[-1]["aug_pair_overflow"]})

    # where the step's device time goes
    def three_steps():
        nonlocal state
        for _ in range(3):
            state, _ = step(state, batch)
    emit({"phase": "train_profile",
          **device_profile(three_steps, 3, top_ops=48)})
    del state, batch, step
    torch.cuda.empty_cache()

    # one epoch of fit: its own step, train-time recall at batches 0 and 2,
    # the checkpoint, the truncated test pass
    with tempfile.TemporaryDirectory() as tmp:
        fcfg = bench.bench_config(
            num_epoch=1, print_freq=1, eval_freq=2,
            checkpoint_path=os.path.join(tmp, "ck"),
            result_path=os.path.join(tmp, "res"))
        n_train, n_test = 3, 2
        lines = []
        reset_counts()
        t0 = time.perf_counter()
        loop.fit(fcfg, model,
                 lambda e: synthetic_batches(fcfg, n_train, seed=e,
                                             with_aug=True),
                 lambda e: synthetic_batches(fcfg, n_test, seed=100 + e),
                 steps_per_epoch=n_train,
                 artifacts=load_vg_artifacts("datasets/artifacts"),
                 device="cuda", log_fn=lines.append)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = read_counts()
        ckpt = loop.checkpoint_file(fcfg, 0)
        ckpt_bytes = os.path.getsize(ckpt) if os.path.exists(ckpt) else 0
    expect = expected(pair_pool=n_test + 2, pair_pool_idx=2 * n_train,
                      pair_pool_bwd=2 * n_train)
    if fit_launches != expect:
        raise AssertionError(f"fit launches {fit_launches}, expected "
                             f"{expect}")
    if not ckpt_bytes:
        raise AssertionError(f"fit wrote no checkpoint {ckpt}")
    train_lines = [ln for ln in lines if ln.startswith("TRAIN")]
    test_lines = [ln for ln in lines if ln.startswith("TEST")]
    if len(train_lines) != n_train or len(test_lines) != 1:
        raise AssertionError(f"fit printed {lines}")
    emit({"phase": "fit", "train_batches": n_train, "test_batches": n_test,
          "launches": fit_launches, "seconds": fit_s,
          "checkpoint_bytes": ckpt_bytes, "lines": lines})
    return launches


def image_batches(rng, n, batch_size, image_size, with_aug):
    """n request/train batches of seeded normalised images with synthetic
    VG objects (no features: the featurizer computes them)."""
    for _ in range(n):
        b = synthetic_batch(rng, batch_size=batch_size, max_objects=20,
                            with_aug=False)
        del b["features"]
        yield {**b, **synthetic_images(rng, batch_size, image_size,
                                       with_aug=with_aug)}


def phase_featurize():
    """The live DETR-101 featurizer at full width through the port's entry
    points, with the default config (fused trunk and encoder kernels on the
    card), at model.image_size 1024 and SIZE_K6.  Returns the trunk and
    encoder kernels' launches over one serving call (predict from 12
    images; K6's at SIZE_K6, the others' at 1024)."""
    torch.cuda.empty_cache()
    cfg = config_lib.derive("vg", hierarchical_pred=True, run_mode="eval",
                            training={"batch_size": 12})
    log = []
    t0 = time.perf_counter()
    featurize, detr = loop.load_detr_featurizer(
        cfg, device="cuda", generator=torch.Generator().manual_seed(0),
        log_fn=log.append)
    init_s = time.perf_counter() - t0
    if not (log and log[0].startswith("WARNING")):
        raise AssertionError(f"expected the random-weights warning: {log}")
    if not (detr.fused_backbone and detr.flash_encoder) \
            or detr.backbone.blocks != (3, 4, 23, 3) \
            or len(detr.encoder_layers()) != 6:
        raise AssertionError("not the full DETR-101 with fused_backbone and "
                             "flash_encoder on")
    size = cfg.model.image_size
    rng = np.random.default_rng(21)
    images = synthetic_images(rng, 12, size)
    x12 = torch.from_numpy(images["image"]).cuda()
    x24 = torch.cat([x12, torch.from_numpy(images["image_aug"]).cuda()])

    def encode(x):
        with torch.inference_mode():
            return detr.encode_features(x)

    def trunk(x, upto=None):
        with torch.inference_mode():
            if detr.fused_backbone:
                return resnet_fused.resnet_forward_fused(
                    detr.backbone, x, detr.dtype, upto=upto)
            return detr.backbone(x, detr.dtype)

    def per_encode(n, **extra):
        return expected(**{k: v * n for k, v in PER_ENCODE.items()}, **extra)

    timing, timing_unfused = {}, {}
    for fused, name, x in ((True, "encode_12", x12), (True, "encode_24", x24),
                           (False, "encode_12", x12),
                           (False, "encode_24", x24)):
        detr.fused_backbone = fused                     # off: the cuDNN trunk
        feats = encode(x)                               # warm-up
        torch.cuda.synchronize()
        s = cfg.model.feature_size
        if feats.shape != (x.shape[0], s, s, 256) \
                or feats.dtype != torch.float32 \
                or not bool(torch.isfinite(feats).all()):
            raise AssertionError(f"{name}: features {tuple(feats.shape)} "
                                 f"{feats.dtype}, finite "
                                 f"{bool(torch.isfinite(feats).all())}")
        del feats
        reps = 3
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            encode(x)
        end.record()
        torch.cuda.synchronize()
        counts = read_counts()
        want = per_encode(reps) if fused \
            else expected(ffn_ln=6 * reps, attention=6 * reps)
        if counts != want:
            raise AssertionError(f"{name} (fused trunk {fused}): launches "
                                 f"over {reps} encodes {counts}, expected "
                                 f"{want}")
        ms = start.elapsed_time(end) / reps
        (timing if fused else timing_unfused)[name] = {
            "ms": ms, "ms_per_image": ms / x.shape[0],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": counts}

    # where the time of one encode of 12 goes: the unfused trunk, then the
    # fused one (the rest of the phase runs fused)
    prof_trunk_unfused = device_profile(lambda: trunk(x12), 1)
    detr.fused_backbone = True
    kernel_groups = {"attention": ("attention_tc_kernel",),
                     "ffn_ln": ("ffn_ln_hopper",),
                     "bottleneck": ("bottleneck", "conv1_s2"),  # K3, K4
                     "stem_conv_pool": ("stem_conv_pool_kernel",
                                        "stem_conv_pool_hopper")}
    prof_trunk = device_profile(lambda: trunk(x12), 1, groups=kernel_groups)
    prof_encode = device_profile(lambda: encode(x12), 1,
                                 groups=kernel_groups)
    # the fused trunk's stages: CUDA-event times of its chained prefixes
    prefix_ms = {u: cuda_ms(lambda u=u: trunk(x12, upto=u), 3)
                 for u in ("stem", "layer1", "layer2", "layer3", "layer4")}
    stages, before = {}, 0.0
    for u, ms in prefix_ms.items():
        stages[u] = ms - before
        before = ms

    # serving: SceneGraphPredictor.predict from 12 images
    model = make_relation_classifier(
        cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    predictor = SceneGraphPredictor(cfg, model, detr_model=detr,
                                    device="cuda")
    request = next(image_batches(rng, 1, 12, size, with_aug=False))
    predictor.predict(request, top_k=50)                # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    graphs = predictor.predict(request, top_k=50)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    predict_launches = read_counts()
    if predict_launches != per_encode(1, pair_pool=1):
        raise AssertionError(f"predict from images launched "
                             f"{predict_launches}")
    if len(graphs) != 12 or not sum(len(g) for g in graphs):
        raise AssertionError("the predictor returned no edges")
    if not all(np.isfinite(e["confidence"]) for g in graphs for e in g):
        raise AssertionError("non-finite edge confidences")
    features = featurize({"image": request["image"]})["features"]
    head_batch = {**{k: v for k, v in request.items() if k != "image"},
                  "features": features,
                  "rel": np.full((12, 20, 20), -1, np.int32)}
    prof_head = device_profile(lambda: predictor.estep(head_batch), 1)
    encode_ms = prof_encode["device_ms_per_call"]
    trunk_ms = prof_trunk["device_ms_per_call"]
    kern = prof_encode["group_ms_per_call"]
    missing = [k for k, ms in kern.items() if ms <= 0]
    if missing:
        raise AssertionError(f"the encode's profile holds no time of the "
                             f"kernel groups {missing}")
    split = {"trunk_ms": trunk_ms,
             "trunk_unfused_ms": prof_trunk_unfused["device_ms_per_call"],
             "trunk_stage_ms": stages,
             "bottleneck_kernels_ms": kern["bottleneck"],
             "stem_kernel_ms": kern["stem_conv_pool"],
             "encoder_ms": encode_ms - trunk_ms,
             "attention_kernel_ms": kern["attention"],
             "ffn_ln_kernel_ms": kern["ffn_ln"],
             "encoder_rest_ms": encode_ms - trunk_ms - kern["attention"]
             - kern["ffn_ln"],
             "relation_head_ms": prof_head["device_ms_per_call"]}
    del features, head_batch, predictor
    torch.cuda.empty_cache()

    # model.image_size 1020: encode_12 and predict from the same 12 images,
    # through the plain stem conv and K6 (PER_ENCODE_K6)
    cfg_k6 = config_lib.derive("vg", hierarchical_pred=True, run_mode="eval",
                               training={"batch_size": 12},
                               model={"image_size": SIZE_K6})
    request = next(image_batches(rng, 1, 12, SIZE_K6, with_aug=False))
    x_k6 = torch.from_numpy(request["image"]).cuda()
    feats = encode(x_k6)                                # warm-up
    torch.cuda.synchronize()
    if feats.shape != (12, 32, 32, 256) \
            or not bool(torch.isfinite(feats).all()):
        raise AssertionError(f"encode_12 at {SIZE_K6}^2: features "
                             f"{tuple(feats.shape)}, finite "
                             f"{bool(torch.isfinite(feats).all())}")
    del feats
    reps = 3
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        encode(x_k6)
    end.record()
    torch.cuda.synchronize()
    counts = read_counts()
    want = expected(**{k: v * reps for k, v in PER_ENCODE_K6.items()})
    if counts != want:
        raise AssertionError(f"encode_12 at {SIZE_K6}^2: launches over "
                             f"{reps} encodes {counts}, expected {want}")
    ms = start.elapsed_time(end) / reps
    # beside the 1024^2 encode_12, in turns 1024, 1020, 1020, 1024 (CUDA
    # events over 3 after 2 warm-ups each)
    turns = {1024: [], SIZE_K6: []}
    for side, x in ((1024, x12), (SIZE_K6, x_k6), (SIZE_K6, x_k6),
                    (1024, x12)):
        turns[side].append(cuda_ms(lambda x=x: encode(x), 3))
    k6_groups = {**kernel_groups, "stem_pool": ("stem_pool_hopper",
                                                "stem_pool_kernel")}
    prof_k6 = device_profile(lambda: encode(x_k6), 1, groups=k6_groups)
    timing_k6 = {"image_size": SIZE_K6, "ms": ms, "ms_per_image": ms / 12,
                 "launches": counts, "stem_pool_kernel": stem.last_pool_kernel,
                 "encode_12_ms_in_turns": {str(k): v for k, v in turns.items()},
                 "device_ms": prof_k6["device_ms_per_call"],
                 "group_ms": prof_k6["group_ms_per_call"]}
    predictor = SceneGraphPredictor(cfg_k6, model, detr_model=detr,
                                    device="cuda")
    predictor.predict(request, top_k=50)                # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    graphs_k6 = predictor.predict(request, top_k=50)
    torch.cuda.synchronize()
    timing_k6["predict_s"] = time.perf_counter() - t0
    predict_k6 = read_counts()
    if predict_k6 != expected(**PER_ENCODE_K6, pair_pool=1):
        raise AssertionError(f"predict at {SIZE_K6}^2 launched {predict_k6}")
    if len(graphs_k6) != 12 or not sum(len(g) for g in graphs_k6) \
            or not all(np.isfinite(e["confidence"])
                       for g in graphs_k6 for e in g):
        raise AssertionError(f"predict at {SIZE_K6}^2: no or non-finite "
                             f"edges")
    timing_k6["predict_launches"] = predict_k6
    emit({"phase": "featurize_k6", "batch_size": 12, **timing_k6,
          "encode_12_1024_ms": timing["encode_12"]["ms"]})
    del predictor, x_k6, request
    torch.cuda.empty_cache()

    # training: fit with the featurizer, 2 steps, both views in one
    # 2B dispatch per step
    with tempfile.TemporaryDirectory() as tmp:
        fcfg = bench.bench_config(
            num_epoch=1, print_freq=1, eval_freq=0,
            checkpoint_path=os.path.join(tmp, "ck"),
            result_path=os.path.join(tmp, "res"))
        fmodel = make_relation_classifier(
            fcfg, device="cuda", generator=torch.Generator().manual_seed(1))
        steps, lines = 2, []
        reset_counts()
        t0 = time.perf_counter()
        loop.fit(fcfg, fmodel,
                 lambda e: image_batches(np.random.default_rng(30 + e),
                                         steps, 12, size, with_aug=True),
                 None, steps_per_epoch=steps,
                 artifacts=load_vg_artifacts("datasets/artifacts"),
                 device="cuda", featurize=loop.make_detr_featurize_fn(
                     fcfg, detr), log_fn=lines.append)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = read_counts()
    expect = per_encode(steps, pair_pool_idx=2 * steps,
                        pair_pool_bwd=2 * steps)
    if fit_launches != expect:
        raise AssertionError(f"fit(featurize=) launched {fit_launches}, "
                             f"expected {expect}")
    train_lines = [ln for ln in lines if ln.startswith("TRAIN")]
    if len(train_lines) != steps or any("nan" in ln.lower()
                                        for ln in train_lines):
        raise AssertionError(f"fit printed {lines}")
    emit({"phase": "featurize", "batch_size": 12, "image_size": size,
          "compute_dtype": cfg.model.compute_dtype,
          "fused_backbone": cfg.model.fused_backbone,
          "flash_encoder": cfg.model.flash_encoder,
          "resolved": dict(zip(("fused_backbone", "flash_encoder"),
                               detr_lib.resolve_detr_modes(
                                   cfg, torch.device("cuda")))),
          "weights": log[0], "init_s": init_s, **timing,
          "fused_backbone_off": timing_unfused,
          "predict_s": predict_s, "predict_launches": predict_launches,
          "predict_edges": sum(len(g) for g in graphs),
          "device_split_encode_12": split,
          "profile_encode_12": prof_encode, "profile_trunk_12": prof_trunk,
          "profile_trunk_unfused_12": prof_trunk_unfused,
          "profile_relation_head": prof_head,
          "fit_steps": steps, "fit_s": fit_s, "fit_launches": fit_launches,
          "fit_lines": lines, "image_size_k6": timing_k6})
    del detr, fmodel
    torch.cuda.empty_cache()
    return {**{k: predict_launches[k] for k in PER_ENCODE},
            "stem_pool": predict_k6["stem_pool"]}


def detection_canvases(rng, regions, canvas=(CANVAS, CANVAS)):
    """Seeded canvases as the VG detection view builds them (JAX
    data/dataset.py nonsquare_canvas: BGR pixels in 0..255 minus the BGR
    means in the top-left valid region, zero outside) with their pixel
    masks; `regions` gives each image's valid (h, w)."""
    images = np.zeros((len(regions), *canvas, 3), np.float32)
    mask = np.zeros((len(regions), *canvas), bool)
    for i, (h, w) in enumerate(regions):
        pixels = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        images[i, :h, :w] = pixels.astype(np.float32) - BGR_MEAN
        mask[i, :h, :w] = True
    return {"image_nonsq": images, "pixel_mask": mask}


def canvas_regions(n):
    """4:3 images at min side 600 / max side 1000: 600 x 800 landscape and
    800 x 600 portrait valid regions in turn, the last image a full
    1000 x 1000 one."""
    return [(600, 800) if i % 2 == 0 else (800, 600)
            for i in range(n - 1)] + [(CANVAS, CANVAS)]


def phase_kernel_canvas(key_valid, exp_per_s):
    """The trunk kernels and K8 at the detection canvas's shapes, batch 12:
    K5 on 1000^2 images (250 pool columns: a partial 64-column chunk), K3
    at the five block shapes (250^2, 125^2, 63^2, 32^2), K4 at 250^2 ->
    125^2, K8 at (12, 1024, 8, 32) under the canvases' own key mask, each
    against its plain version by the rules of phase `kernel` and timed
    beside it (K8 beside SDPA too).  Returns the bf16 records by case."""
    dev = torch.device("cuda")
    disable_tf32()
    gen = torch.Generator(device=dev).manual_seed(5)
    cpu_gen = torch.Generator().manual_seed(6)
    out = {"stem_conv_pool": stem_records(CANVAS, "detect_kernel", gen,
                                          cpu_gen, dev)[0]}
    for name, cases, stride in (("bottleneck", K3_CANVAS_CASES, 1),
                                ("bottleneck_s2", K4_CANVAS_CASES, 2)):
        for rec in block_records(name, cases, stride, "detect_kernel", gen,
                                 cpu_gen, dev)[0]:
            out[f"{name} {rec['case']}"] = rec
    qkv32 = [torch.randn((12, 1024, 8, 32), device=dev, generator=gen)
             for _ in range(3)]
    for dtype in (torch.bfloat16, torch.float32):
        rec = attention_record(*(t.to(dtype) for t in qkv32), key_valid,
                               "detect_canvas", 1.0 / math.sqrt(32),
                               exp_per_s, "detect_kernel")
        if dtype == torch.bfloat16:
            out["attention"] = rec
    del qkv32
    torch.cuda.empty_cache()
    return out


def phase_detect(exp_per_s):
    """SGDET/SGCLS detection at full width through the port's entry points:
    load_detr(detection=True) with the default config (fused trunk and
    encoder kernels on the card; no checkpoint in the repo, so seeded
    random weights), make_detr_detect_fn on 12 seeded 1000^2 canvases
    with VG-like pixel masks, then run_eval_sgd and run_eval_sgc over 2
    synthetic full-VG-width batches; the kernels at the canvas shapes;
    card against CPU at reduced depth in float32."""
    torch.cuda.empty_cache()
    cfg = config_lib.derive("vg", hierarchical_pred=True, run_mode="eval",
                            eval_mode="sgd", training={"batch_size": 12})
    b = cfg.training.batch_size
    log = []
    t0 = time.perf_counter()
    detr = loop.load_detr(cfg, device="cuda",
                          generator=torch.Generator().manual_seed(0),
                          log_fn=log.append, detection=True)
    init_s = time.perf_counter() - t0
    if not (log and log[0].startswith("WARNING")):
        raise AssertionError(f"expected the random-weights warning: {log}")
    if not (detr.fused_backbone and detr.flash_encoder) \
            or detr.backbone.blocks != (3, 4, 23, 3) \
            or len(detr.encoder_layers()) != 6 \
            or len(detr.decoder_layers()) != 6 \
            or (detr.num_classes, detr.num_queries) != (151, 100):
        raise AssertionError("not the full DETR-101 detector with "
                             "fused_backbone and flash_encoder on")
    canvases = detection_canvases(np.random.default_rng(50),
                                  canvas_regions(b))
    images = torch.from_numpy(canvases["image_nonsq"]).cuda()
    mask = torch.from_numpy(canvases["pixel_mask"]).cuda()
    on_card = {"image_nonsq": images, "pixel_mask": mask}
    detect_fn = engines.make_detr_detect_fn(cfg, detr)
    det = detect_fn(on_card)                            # warm-up
    torch.cuda.synchronize()

    # the forward's outputs
    with torch.inference_mode():
        out = detr(images, mask)
        _, _, kmask, grid = detr._encode(images, mask)
    logits, boxes = out["pred_logits"], out["pred_boxes"]
    if logits.shape != (b, 100, 151) or boxes.shape != (b, 100, 4) \
            or logits.dtype != torch.float32 \
            or not bool(torch.isfinite(logits).all()) \
            or not bool(((boxes >= 0) & (boxes <= 1)).all()):
        raise AssertionError(f"detection outputs {tuple(logits.shape)} "
                             f"{tuple(boxes.shape)} {logits.dtype}: finite "
                             f"logits and boxes in [0, 1] expected")
    n = cfg.data.max_objects
    if det["cats"].shape != (b, n) or det["boxes"].shape != (b, n, 4) \
            or not ((det["cats"] >= 0) & (det["cats"] < 150)).all() \
            or not ((det["boxes"] >= 0) & (det["boxes"] <= 32)).all():
        raise AssertionError("detect_fn returned malformed detections")
    # the post-process on the card and on the CPU, fed the same logits
    # and boxes: equal integer outputs
    with torch.inference_mode():
        post_cpu = engines.to_numpy(postprocess_detections(
            logits.cpu(), boxes.cpu(), OBJ_ALP2FRE))
        post_card = engines.to_numpy(postprocess_detections(
            logits, boxes, OBJ_ALP2FRE))
    post_err = {}
    for k, v in post_card.items():
        want = post_cpu[k]
        if k in ("cats", "valid"):
            if not np.array_equal(v, want):
                raise AssertionError(f"card vs CPU post-process {k} differ")
        else:
            post_err[k] = float(np.abs(v - want).max())
            if post_err[k] > 1e-5:
                raise AssertionError(f"card vs CPU post-process {k}: "
                                     f"{post_err[k]}")

    # launches and device time per detect dispatch (CUDA events over 3,
    # after the warm-up), from canvases on the card and from the host
    reps = 3
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        detect_fn(on_card)
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    launches = read_counts()
    want = expected(**{k: v * reps for k, v in PER_DETECT.items()})
    if launches != want:
        raise AssertionError(f"launches over {reps} detect dispatches "
                             f"{launches}, expected {want}")
    detect_ms = start.elapsed_time(end) / reps
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    host_ms = cuda_ms(lambda: detect_fn(canvases), reps)

    # where the time of one detect goes: trunk, encoder, decoder and heads,
    # post-process (each profiled; differences of nested prefixes)
    def run(fn):
        def call():
            with torch.inference_mode():
                return fn()
        return call

    kernel_groups = {"attention": ("attention_tc_kernel",),
                     "ffn_ln": ("ffn_ln_hopper",),
                     "bottleneck": ("bottleneck", "conv1_s2"),  # K3, K4
                     "stem_conv_pool": ("stem_conv_pool_hopper",)}
    parts = {"trunk": run(lambda: resnet_fused.resnet_forward_fused(
                 detr.backbone, images, detr.dtype)),
             "encode": run(lambda: detr._encode(images, mask)),
             "forward": run(lambda: detr(images, mask)),
             "postprocess": run(lambda: postprocess_detections(
                 logits, boxes, OBJ_ALP2FRE)),
             "detect": lambda: detect_fn(on_card)}
    prof = {k: device_profile(fn, 1, groups=kernel_groups)
            for k, fn in parts.items()}
    missing = [k for k, ms in prof["detect"]["group_ms_per_call"].items()
               if ms <= 0]
    if missing:
        raise AssertionError(f"the detect profile holds no time of the "
                             f"kernel groups {missing}")

    def wall(fn, iters=3):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / iters

    def enqueue(fn, iters=3):
        """Host time until fn returns, from an idle card: what issuing its
        work costs the host (the detect dispatch's ends in its copy out)."""
        total = 0.0
        for _ in range(iters):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            total += time.perf_counter() - t
        torch.cuda.synchronize()
        return total * 1e3 / iters

    # each nested prefix alone: host clock (ending in a synchronise), CUDA
    # events, and the host's time to issue it; where issuing takes as long
    # as the events' time, the host holds the card back
    part_ms = {k: {"wall_ms": wall(fn), "event_ms": cuda_ms(fn, 3),
                   "enqueue_ms": enqueue(fn)}
               for k, fn in parts.items()}
    q = logits.shape[1] * cfg.model.topk_cat
    nms_args = (torch.rand((b, q, 4), device="cuda").sort(-1).values,
                torch.rand((b, q), device="cuda"),
                torch.randint(0, 150, (b, q), device="cuda"),
                torch.ones((b, q), dtype=torch.bool, device="cuda"))
    ms = {k: p["device_ms_per_call"] for k, p in prof.items()}
    split = {"trunk_ms": ms["trunk"],
             "encoder_ms": ms["encode"] - ms["trunk"],
             "decoder_and_heads_ms": ms["forward"] - ms["encode"],
             "postprocess_ms": ms["postprocess"],
             "nms_wall_ms": wall(run(lambda: class_aware_nms(*nms_args,
                                                             0.5))),
             "kernel_ms": prof["detect"]["group_ms_per_call"],
             "device_busy_share": prof["detect"]["device_busy_share"],
             "parts": part_ms}
    del out, logits, boxes, nms_args

    # the kernels at the canvas shapes, K8 under the canvases' key mask
    canvas_kernels = phase_kernel_canvas(kmask, exp_per_s)
    del kmask

    # SGDET and SGCLS over 2 synthetic full-VG-width batches (features and
    # objects as phase `slice`, canvases to detect on), after a warm-up
    model = make_relation_classifier(
        cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    artifacts = load_vg_artifacts("datasets/artifacts")
    rng = np.random.default_rng(51)
    batches = [{**synthetic_batch(rng, batch_size=b, max_objects=n,
                                  with_aug=False),
                **detection_canvases(rng, canvas_regions(b))}
               for _ in range(2)]
    engines.run_eval_sgd(cfg, model, batches[:1], detect_fn,
                         artifacts=artifacts, device="cuda")
    evals = {}
    for mode, runner in (("sgd", engines.run_eval_sgd),
                         ("sgc", engines.run_eval_sgc)):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = runner(cfg, model, batches, detect_fn, artifacts=artifacts,
                     device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        want = expected(**{k: v * len(batches)
                           for k, v in PER_DETECT.items()},
                        pair_pool=len(batches))
        if counts != want:
            raise AssertionError(f"run_eval_{mode} launched {counts}, "
                                 f"expected {want}")
        recalls = [*res["recall"], *res["mean_recall"], *res["recall_zs"]]
        if not all(0 <= r <= 1 for r in recalls) or not res["num_targets"]:
            raise AssertionError(f"run_eval_{mode}: {res}")
        evals[mode] = {"recall": res["recall"],
                       "mean_recall": res["mean_recall"],
                       "recall_zs": res["recall_zs"],
                       "num_targets": res["num_targets"],
                       "launches": counts, "batches": len(batches),
                       "wall_s_per_batch": secs / len(batches)}
    del model, batches
    emit({"phase": "detect", "batch_size": b, "canvas": CANVAS,
          "regions": canvas_regions(b),
          "masked_keys": 1 - mask_fraction(canvases["pixel_mask"], grid),
          "compute_dtype": cfg.model.compute_dtype, "weights": log[0],
          "init_s": init_s,
          "detect_12": {"ms": detect_ms, "wall_ms": wall_ms,
                        "from_host_ms": host_ms, "peak_mem_gb": peak_gb,
                        "launches": launches, "reps": reps},
          "launches_per_detect": PER_DETECT,
          "detections_per_image": det["valid"].sum(1).tolist(),
          "postprocess_card_vs_cpu_err": post_err,
          "device_split_detect_12": split,
          "canvas_kernels": {k: {f: r[f] for f in (
              "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
              "unfused_ms", "max_abs_err") if f in r}
              for k, r in canvas_kernels.items()},
          **{f"run_eval_{k}": v for k, v in evals.items()},
          "profile_detect_12": prof["detect"]})
    del detr, images, mask, on_card
    torch.cuda.empty_cache()
    phase_detect_parity()


def mask_fraction(pixel_mask, grid):
    """The share of valid keys on the (h, w) feature grid."""
    fmask = detr_lib.downsample_mask(torch.from_numpy(pixel_mask), *grid)
    return fmask.float().mean().item()


def phase_detect_parity():
    """The detection forward on the card (K7, K8) and on the CPU (plain
    versions), float32, reduced depth (blocks (1, 1, 1, 1), 1 encoder and 2
    decoder layers, full width), seeded weights, two 1024 x 512 canvases
    (L = 512 tokens), one with a 700 x 400 valid region: outputs within
    1e-4; the post-process of the CPU's outputs on both devices gives
    equal integer outputs."""
    dcfg = config_lib.derive("vg", model={
        "detr_blocks": (1, 1, 1, 1), "detr_enc_layers": 1,
        "detr_dec_layers": 2, "compute_dtype": "float32",
        "flash_encoder": "on"})
    sd = weights.init_detr_params(dcfg, torch.Generator().manual_seed(7),
                                  detection=True)
    canv = detection_canvases(np.random.default_rng(52),
                              [(700, 400), (1024, 512)], canvas=(1024, 512))
    outs = {}
    for dev in ("cuda", "cpu"):
        detr = detr_lib.make_detr(dcfg, device=dev, state_dict=sd,
                                  detection=True)
        reset_counts()
        with torch.inference_mode():
            outs[dev] = {k: v.cpu() for k, v in detr(
                torch.from_numpy(canv["image_nonsq"]).to(dev),
                torch.from_numpy(canv["pixel_mask"]).to(dev)).items()}
        if dev == "cuda" and read_counts() != expected(ffn_ln=1,
                                                       attention=1):
            raise AssertionError(f"card detect launched {read_counts()}")
    errs = {k: float((outs["cuda"][k] - outs["cpu"][k]).abs().max())
            for k in outs["cpu"]}
    if not all(e <= 1e-4 for e in errs.values()):
        raise AssertionError(f"card vs CPU detection forward: {errs} > 1e-4")
    logits, boxes = outs["cpu"]["pred_logits"], outs["cpu"]["pred_boxes"]
    with torch.inference_mode():
        posts = {dev: engines.to_numpy(postprocess_detections(
            logits.to(dev), boxes.to(dev), OBJ_ALP2FRE)) for dev in
            ("cuda", "cpu")}
    for k in ("cats", "valid"):
        if not np.array_equal(posts["cuda"][k], posts["cpu"][k]):
            raise AssertionError(f"card vs CPU post-process {k} differ")
    emit({"phase": "detect_parity", "canvas": [1024, 512],
          "regions": [[700, 400], [1024, 512]], "detr_blocks": [1, 1, 1, 1],
          "encoder_layers": 1, "decoder_layers": 2, "max_abs_err": errs,
          "tolerance": 1e-4, "postprocess_int_equal": True,
          "detections": posts["cpu"]["valid"].sum(1).tolist()})


def phase_parity():
    """Card (kernels) vs CPU (plain versions) on the same weights and batch,
    float32, reduced size: the eval step, one train step, one faithful
    train step, and the forward with index on the same streams."""
    cfg = config_lib.derive(
        "vg", hierarchical_pred=True, run_mode="eval",
        model={"feature_size": 16, "hidden_dim": 8, "num_img_feature": 16,
               "compute_dtype": "float32", "dropout_rate": 0.0},
        data={"max_objects": 6},
        training={"batch_size": 4, "learning_rate": 1e-3,
                  "grad_clip_norm": 5.0})
    sd = weights.init_params(cfg, torch.Generator().manual_seed(1))
    batch = next(synthetic_batches(cfg, 1, seed=5))
    outs = {}
    for dev in ("cuda", "cpu"):
        model = make_relation_classifier(cfg, device=dev, state_dict=sd)
        outs[dev] = engines.to_numpy(
            engine.make_eval_step(model, cfg, device=dev)(batch))
    errs = {}
    for k, v in outs["cpu"].items():
        g = outs["cuda"][k]
        if k in ("relation", "super_relation", "connectivity"):
            errs[k] = float(np.abs(g - v).max())
            if errs[k] > 1e-4:
                raise AssertionError(f"card vs CPU {k}: {errs[k]} > 1e-4")
        elif not np.array_equal(g, v):
            raise AssertionError(f"card vs CPU {k} differ")

    # one train step (forward with index, backward kernel, SGD update)
    train_batch = next(synthetic_batches(cfg, 1, seed=6, with_aug=True))
    params, metrics = {}, {}
    for dev in ("cuda", "cpu"):
        model = make_relation_classifier(cfg, device=dev, state_dict=sd)
        opt = engine.make_optimizer(cfg.training.learning_rate,
                                    grad_clip_norm=5.0)
        reset_counts()
        state, met = engine.make_train_step(
            model, cfg, opt, class_weights("vg"), device=dev)(engine.init_train_state(model, opt), train_batch)
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = read_counts()
            if counts != expected(pair_pool_idx=2, pair_pool_bwd=2):
                raise AssertionError(f"card train step launched {counts}")
        params[dev] = {k: v.detach().cpu() for k, v in state.params.items()}
        metrics[dev] = {k: float(v) for k, v in met.items()}
    param_err = max(float((params["cuda"][k] - params["cpu"][k]).abs().max())
                    for k in params["cpu"])
    if param_err > 1e-4:
        raise AssertionError(f"card vs CPU parameters after a train step: "
                             f"{param_err} > 1e-4")
    metric_err = {}
    for k, v in metrics["cpu"].items():
        if k.startswith("loss"):
            metric_err[k] = abs(metrics["cuda"][k] - v)
            if metric_err[k] > 1e-4 * max(1.0, abs(v)):
                raise AssertionError(f"card vs CPU {k}: {metrics['cuda'][k]}"
                                     f" vs {v}")
        elif metrics["cuda"][k] != v:
            raise AssertionError(f"card vs CPU metric {k}: "
                                 f"{metrics['cuda'][k]} vs {v}")

    # one faithful train step (every valid pair, the grid losses, the
    # dynamic learning rate): the same kernels, 2 + 2 launches
    fcfg = cfg.replace(training=dataclasses.replace(
        cfg.training, faithful_dynamics=True))
    fparams, fmetrics = {}, {}
    for dev in ("cuda", "cpu"):
        model = make_relation_classifier(fcfg, device=dev, state_dict=sd)
        opt = engine.make_optimizer(fcfg.training.learning_rate,
                                    grad_clip_norm=5.0)
        reset_counts()
        state, met = engine.make_train_step(
            model, fcfg, opt, class_weights("vg", faithful=True),
            device=dev)(engine.init_train_state(model, opt), train_batch)
        if dev == "cuda":
            torch.cuda.synchronize()
            if read_counts() != expected(pair_pool_idx=2, pair_pool_bwd=2):
                raise AssertionError(f"card faithful step launched "
                                     f"{read_counts()}")
        fparams[dev] = {k: v.detach().cpu() for k, v in state.params.items()}
        fmetrics[dev] = {k: float(v) for k, v in met.items()}
    faithful_err = max(float((fparams["cuda"][k] - fparams["cpu"][k])
                             .abs().max()) for k in fparams["cpu"])
    if faithful_err > 1e-4:
        raise AssertionError(f"card vs CPU parameters after a faithful "
                             f"step: {faithful_err} > 1e-4")
    for k, v in fmetrics["cpu"].items():
        tol = 1e-4 * max(1.0, abs(v)) if k.startswith(("loss", "lr_")) \
            else 0.0
        if abs(fmetrics["cuda"][k] - v) > tol:
            raise AssertionError(f"card vs CPU faithful {k}: "
                                 f"{fmetrics['cuda'][k]} vs {v}")

    # the winner index on equal streams (the CPU's), with exact ties
    model = make_relation_classifier(cfg, device="cpu", state_dict=sd)
    with torch.no_grad():
        b = {k: torch.as_tensor(batch[k]) for k in engine.MODEL_KEYS}
        masks = box_ops.boxes_to_masks(b["boxes"], cfg.model.feature_size,
                                       b["features"].dtype)
        a_s, b_s = model.object_streams_from_image(b["features"],
                                                   b["depth"], masks)
    a_s = a_s.to(torch.bfloat16)
    b_s = b_s.to(torch.bfloat16)
    a_s[:, 0::2] = a_s[:, 1::2]                 # tie the window rows
    b_s[:, 0::2] = b_s[:, 1::2]
    packed = pairs.pack_pairs(pairs.pair_validity(b["valid"]),
                              cfg.pair_capacity)
    want = pair_pool.pair_pool_idx_plain(a_s, b_s, packed.flat_sub,
                                         packed.flat_obj)
    got = pair_pool.pair_pool_idx(a_s.cuda(), b_s.cuda(),
                                  packed.flat_sub.cuda(),
                                  packed.flat_obj.cuda())
    if not all(torch.equal(x.cpu(), y) for x, y in zip(got, want)):
        raise AssertionError("card vs CPU pair_pool_idx differ")
    emit({"phase": "parity", "max_abs_err": errs, "tolerance": 1e-4,
          "live_pairs": int(outs["cpu"]["pair_count"][0]),
          "train_param_max_abs_err": param_err,
          "train_loss_abs_err": metric_err,
          "faithful_param_max_abs_err": faithful_err,
          "faithful_lr_scale": fmetrics["cuda"]["lr_scale"],
          "train_int_metrics_equal": True, "idx_equal": True})

    # encode_features at reduced depth, 1024x512 (L = 512: every encoder
    # layer runs the kernels on the card, the plain versions on the CPU)
    dcfg = config_lib.derive("vg", model={
        "detr_blocks": (1, 1, 1, 1), "detr_enc_layers": 2,
        "compute_dtype": "float32", "flash_encoder": "on"})
    sd = weights.init_detr_params(dcfg, torch.Generator().manual_seed(2))
    image = synthetic_images(np.random.default_rng(40), 1, 1024,
                             with_aug=False)["image"][:, :, :512].copy()
    mask = np.ones((1, 1024, 512), bool)
    mask[0, :, 400:] = False
    feats = {}
    for dev in ("cuda", "cpu"):
        detr = detr_lib.make_detr(dcfg, device=dev, state_dict=sd)
        reset_counts()
        with torch.inference_mode():
            feats[dev] = detr.encode_features(
                torch.from_numpy(image).to(dev),
                torch.from_numpy(mask).to(dev)).cpu()
        if dev == "cuda" and read_counts() != expected(ffn_ln=2,
                                                       attention=2):
            raise AssertionError(f"card encode launched {read_counts()}")
    enc_err = float((feats["cuda"] - feats["cpu"]).abs().max())
    if not enc_err <= 1e-4:
        raise AssertionError(f"card vs CPU encode_features: {enc_err} > "
                             f"1e-4")
    emit({"phase": "parity_encode", "image": [1024, 512], "tokens": 512,
          "detr_blocks": [1, 1, 1, 1], "encoder_layers": 2,
          "max_abs_err": enc_err, "tolerance": 1e-4})
    phase_parity_trunk()


def phase_parity_trunk():
    """The fused trunk on the card (kernels) and on the CPU (plain
    versions), float32, blocks (1, 1, 1, 1) at full width, seeded random
    weights and frozen-BN statistics, on a 1024x512 image (the stem
    kernel, K3, K4 at every transition) and a 1020x508 one (the plain stem
    conv and K6, the plain fallback at the odd layer2 transition, K3, K4)."""
    blocks = (1, 1, 1, 1)
    tcfg = config_lib.derive("vg", model={"detr_blocks": blocks,
                                          "compute_dtype": "float32"})
    gen = torch.Generator().manual_seed(9)
    sd = {}
    for k, v in weights.init_detr_params(tcfg, gen).items():
        if not k.startswith("backbone."):
            continue
        if k.endswith("running_var") or k.endswith(".weight") and v.dim() == 1:
            v = torch.empty_like(v).uniform_(0.5, 2.0, generator=gen)
        elif k.endswith("running_mean") or k.endswith(".bias"):
            v = torch.empty_like(v).normal_(0, 0.2, generator=gen)
        sd[k.removeprefix("backbone.")] = v
    nets = {}
    for dev in ("cuda", "cpu"):
        nets[dev] = detr_lib.ResNet101(blocks).to(dev)
        nets[dev].load_state_dict(sd)
        nets[dev].requires_grad_(False)
    full = synthetic_images(np.random.default_rng(41), 1, 1024,
                            with_aug=False)["image"]
    cases = (((1024, 512), expected(stem_conv_pool=1, bottleneck=1,
                                    bottleneck_s2=3)),
             ((1020, 508), expected(stem_pool=1, bottleneck=1,
                                    bottleneck_s2=2)))
    for (h, w), want in cases:
        image = torch.from_numpy(full[:, :h, :w].copy())
        outs = {}
        for dev in ("cuda", "cpu"):
            reset_counts()
            with torch.inference_mode():
                outs[dev] = resnet_fused.resnet_forward_fused(
                    nets[dev], image.to(dev), torch.float32).cpu()
            if dev == "cuda":
                counts = read_counts()
                if counts != want:
                    raise AssertionError(f"card trunk {h}x{w} launched "
                                         f"{counts}, expected {want}")
        scale = outs["cpu"].abs().max().item()
        err = (outs["cuda"] - outs["cpu"]).abs().max().item()
        # sums of up to 9 * 512 float32 products in another order, through
        # 5 blocks: ~1e-6 of the output's scale
        if not err <= TRUNK_F32_TOL * scale:
            raise AssertionError(f"card vs CPU fused trunk {h}x{w}: {err} > "
                                 f"{TRUNK_F32_TOL} x {scale}")
        emit({"phase": "parity_trunk", "image": [h, w],
              "detr_blocks": list(blocks), "shape": list(outs["cpu"].shape),
              "max_abs_err": err, "scale": scale,
              "tolerance": f"{TRUNK_F32_TOL} x scale", "launches": want})


def image_names(paths):
    """Image names of annotation paths (<name>_annotations.pkl) or SGRC
    record paths (<name>.sgrec)."""
    return [os.path.basename(p).rsplit("_annotations", 1)[0]
            .rsplit(".sgrec", 1)[0] for p in paths]


def same_batches(got, want):
    """Key-by-key equality of two lists of host batches (np.array_equal,
    same dtype); annotation paths compared by image name."""
    if len(got) != len(want) or not got:
        raise AssertionError(f"{len(got)} batches against {len(want)}")
    for g, w in zip(got, want):
        if set(g) != set(w):
            raise AssertionError(f"keys {sorted(g)} against {sorted(w)}")
        for k in w:
            if k == "annot_path":
                if image_names(g[k]) != image_names(w[k]):
                    raise AssertionError(f"annot_path {g[k]}")
            elif g[k].dtype != w[k].dtype or not np.array_equal(g[k], w[k]):
                raise AssertionError(f"batches differ in {k}")


def loader_rate(batches):
    """Images per second of a host batch source, drained on this thread."""
    t0 = time.perf_counter()
    n = sum(len(b["cats"]) for b in batches)
    return n / (time.perf_counter() - t0), n


def run_cli(root, yaml_path, *args):
    """python -m scene_graph_commonsense_torch as a user runs it (on the
    card, no --synthetic); returns the process after it exits."""
    return subprocess.Popen(
        [sys.executable, "-m", "scene_graph_commonsense_torch", "--hierar",
         "--config", yaml_path, *args], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def finish_cli(name, proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"CLI {name} exited {proc.returncode}:\n"
                             f"{err[-3000:]}")
    return out


def mini_vg(tmp, batch_size=12):
    """The mini-VG of phase real_data under `tmp`: REAL_IMAGES JPEGs in the
    reference's on-disk format at REAL_SIZES, 3 training and 2 test
    batches.  Returns (the config's data paths, n_train, n_test)."""
    vg = os.path.join(tmp, "vg")
    n_train, n_test = make_mini_vg(
        vg, images=REAL_IMAGES, feature_size=32, max_objects=20,
        num_classes=150, seed=0, train_frac=REAL_TRAIN_FRAC,
        sizes=REAL_SIZES)
    if (n_train, n_test) != (3 * batch_size, 2 * batch_size):
        raise AssertionError(f"mini-VG split {n_train}/{n_test}")
    data = {"image_dir": os.path.join(vg, "images"),
            "annot_dir": os.path.join(vg, "annot"),
            **{f"annotation_{split}": os.path.join(
                vg, f"instances_vg_{split}.json")
               for split in ("train", "test")}}
    return data, n_train, n_test


def phase_real_data():
    """Real Visual Genome data through the port's loaders, records and
    CLI at full width: a mini-VG fabricated in a temporary directory, its
    SGRC records (train v2, test v1) and its feature cache; PredCLS eval
    from images (the Python loader, prepped_batches, the live featurizer);
    SGCLS and SGDET from images (the detection canvas, one detector);
    fit from v2 records through NativeRecordPipeline; the loaders alone;
    the native path against the Python loader; the CLI three times."""
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    art = load_vg_artifacts("datasets/artifacts")
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    t0 = time.perf_counter()
    native_lib.build_library()              # g++, unless already built
    native_build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        data, n_train, n_test = mini_vg(tmp)
        cfg = config_lib.derive("vg", hierarchical_pred=True,
                                run_mode="eval", data=data,
                                training={"batch_size": 12})
        b = cfg.training.batch_size
        quiet = dict(log_fn=lambda *a: None)
        sgrc_train = os.path.join(tmp, "sgrc_train")
        sgrc_test = os.path.join(tmp, "sgrc_test")
        if write_sgrecords(cfg, "train", sgrc_train, embed_images=True,
                           **quiet) != n_train \
                or write_sgrecords(cfg, "test", sgrc_test,
                                   **quiet) != n_test:
            raise AssertionError("SGRC records missing")
        fabricate_s = time.perf_counter() - t0

        # PredCLS eval from images: the Python loader, prepped_batches
        # (the featurizer on the prefetch thread), run_eval_pc
        log = []
        featurize, detr = loop.load_detr_featurizer(
            cfg, device="cuda", generator=gen(), log_fn=log.append)
        model = make_relation_classifier(cfg, device="cuda",
                                         generator=gen())
        estep = engine.make_eval_step(model, cfg, device="cuda")
        test_fn = cli.real_batches(cfg, training=False)

        def eval_pc():
            return engines.run_eval_pc(
                cfg, model, cli.prepped_batches(cfg, test_fn(0), featurize),
                artifacts=art, estep=estep, device="cuda")

        engines.run_eval_pc(cfg, model, cli.prepped_batches(
            cfg, test_fn(0), featurize), artifacts=art, estep=estep,
            max_batches=1)                                  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = eval_pc()
        torch.cuda.synchronize()
        pc_s = time.perf_counter() - t0
        counts = read_counts()
        want = expected(**{k: v * 2 for k, v in PER_ENCODE.items()},
                        pair_pool=2)
        if counts != want:
            raise AssertionError(f"run_eval_pc from images launched "
                                 f"{counts}, expected {want}")
        if not res["num_targets"] or not all(
                0 <= r <= 1 for r in res["recall"]):
            raise AssertionError(f"run_eval_pc from images: {res}")
        host = list(test_fn(0))                   # the loader's batches
        if host[0]["image"].shape != (b, 1024, 1024, 3):
            raise AssertionError(f"square view {host[0]['image'].shape}")
        t0 = time.perf_counter()
        engines.run_eval_pc(cfg, model, map(featurize, host), artifacts=art,
                            estep=estep, device="cuda")
        torch.cuda.synchronize()
        pc_host_s = time.perf_counter() - t0
        pc_prof = device_profile(eval_pc, 2)
        predcls = {"wall_s_per_batch": pc_s / 2,
                   "from_host_batches_s_per_batch": pc_host_s / 2,
                   "launches_per_batch": {k: v // 2 for k, v in
                                          counts.items()},
                   "recall": res["recall"],
                   "num_targets": res["num_targets"],
                   "device_busy_share": pc_prof["device_busy_share"],
                   "device_ms_per_batch": pc_prof["device_ms_per_call"],
                   "wall_ms_per_batch_profiled":
                       pc_prof["wall_ms_per_call"]}

        # the feature cache of the test split by the port's tool, and the
        # native path (v1 records + cache) against the Python loader
        feat_dir = os.path.join(tmp, "features")
        t0 = time.perf_counter()
        written = precompute_features(cfg, "test", feat_dir, b,
                                      featurize=featurize)
        precompute_s = time.perf_counter() - t0
        ccfg = cfg.replace(data=dataclasses.replace(
            cfg.data, features_dir=feat_dir, sgrc_dir=sgrc_test))
        with open(ccfg.data.annotation_test) as f:
            test_ann = json.load(f)
        native_b = list(cli.native_batches(ccfg)(0))
        python_b = list(batches_from_dataset(
            VGDataset(ccfg, test_ann, training=False), b, shuffle=False))
        same_batches(native_b, python_b)
        if "features" not in native_b[0] or "image" in native_b[0]:
            raise AssertionError("the cached batches carry no features")

        # training: fit over NativeRecordPipeline(v2, want_plain), 3 steps,
        # one 2B encode a step
        tcfg = config_lib.derive(
            "vg", hierarchical_pred=True, run_mode="train", data=data,
            training={"batch_size": b, "num_epoch": 1, "print_freq": 1,
                      "eval_freq": 0,
                      "checkpoint_path": os.path.join(tmp, "ck_fit"),
                      "result_path": os.path.join(tmp, "res_fit")})
        paths = sorted(os.path.join(sgrc_train, p)
                       for p in os.listdir(sgrc_train))

        def pipe(threads, want_plain=True):
            return NativeRecordPipeline(
                paths, b, max_objects=20, feature_size=32,
                num_threads=threads, seed=0, training=True,
                image_size=cfg.model.image_size, want_plain=want_plain)

        tmodel = make_relation_classifier(tcfg, device="cuda",
                                          generator=gen())
        lines = []
        reset_counts()
        t0 = time.perf_counter()
        loop.fit(tcfg, tmodel, pipe(8).iter_epoch, None,
                 steps_per_epoch=1000, artifacts=art, device="cuda",
                 featurize=featurize, log_fn=lines.append)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = read_counts()
        want = expected(**{k: v * 3 for k, v in PER_ENCODE.items()},
                        pair_pool_idx=6, pair_pool_bwd=6)
        if counts != want:
            raise AssertionError(f"fit from records launched {counts}, "
                                 f"expected {want}")
        train_lines = [ln for ln in lines if ln.startswith("TRAIN")]
        if len(train_lines) != 3 or "nan" in " ".join(train_lines):
            raise AssertionError(f"fit from records printed {lines}")
        if not os.path.exists(loop.checkpoint_file(tcfg, 0)):
            raise AssertionError("fit from records wrote no checkpoint")

        # the train step from records, from features, and the 2B encode,
        # by CUDA events, and its busy share (featurize, copy, step)
        opt = engine.make_optimizer(
            tcfg.training.learning_rate, momentum=tcfg.training.momentum,
            weight_decay=tcfg.training.weight_decay)
        step = engine.make_train_step(tmodel, tcfg, opt, class_weights("vg"),
                                      device="cuda")
        state = engine.init_train_state(tmodel, opt)
        record_batch = next(pipe(8).iter_epoch(1))
        record_batch.pop("annot_path")
        dev = torch.device("cuda")

        def record_step():
            nonlocal state
            state, _ = step(state, to_device(featurize(record_batch), dev))

        featured = to_device(featurize(record_batch), dev)

        def feature_step():
            nonlocal state
            state, _ = step(state, featured)

        images24 = torch.cat([torch.as_tensor(record_batch["image"]),
                              torch.as_tensor(record_batch["image_aug"])]
                             ).cuda()

        def encode24():
            with torch.inference_mode():
                detr.encode_features(images24)

        step_ms = cuda_ms(record_step, 3)
        feature_step_ms = cuda_ms(feature_step, 3)
        encode_ms = cuda_ms(encode24, 3)
        train_prof = device_profile(record_step, 1)
        training = {
            "fit_s": fit_s, "fit_img_per_s": n_train / fit_s,
            "steps": 3, "launches_per_step": {k: v // 3 for k, v in
                                              counts.items()},
            "record_step_ms": step_ms,
            "record_step_img_per_s": b * 1e3 / step_ms,
            "feature_step_ms": feature_step_ms,
            "feature_step_img_per_s": b * 1e3 / feature_step_ms,
            "encode_24_ms": encode_ms,
            "pair_capacity": tcfg.pair_capacity,
            "device_busy_share": train_prof["device_busy_share"],
            "device_ms_per_step": train_prof["device_ms_per_call"],
            "wall_ms_per_step_profiled": train_prof["wall_ms_per_call"],
            "lines": train_lines}
        del state, step, opt, tmodel, featured, images24, record_batch

        # the loaders alone, on the host (both views of 36 training images)
        with open(cfg.data.annotation_train) as f:
            train_ann = json.load(f)
        py_rate, py_n = loader_rate(batches_from_dataset(
            VGDataset(tcfg, train_ann, training=True), b))
        loaders = {"python_img_per_s": py_rate, "images": py_n,
                   "native_img_per_s": {}, "native_no_plain_img_per_s": {},
                   "pack_train_call_ms": {}}
        jrng = np.random.default_rng(0)
        jitter = np.array([[float(a), *o, *f] for a, o, f in (
            color_jitter_params(jrng) for _ in range(b))], np.float32)
        for threads in PACKER_THREADS:
            p = pipe(threads)
            rate, n = loader_rate(p.iter_epoch(0))
            loaders["native_img_per_s"][threads] = rate
            rate, _ = loader_rate(pipe(threads, False).iter_epoch(0))
            loaders["native_no_plain_img_per_s"][threads] = rate
            if n != n_train:
                raise AssertionError(f"the packer gave {n} images")
            # the C++ call alone, one batch, without the pipeline's
            # per-example split and restacking
            t0 = time.perf_counter()
            p.packer.pack_train(paths[:b], jitter, cfg.model.image_size,
                                want_plain=True)
            loaders["pack_train_call_ms"][threads] = \
                (time.perf_counter() - t0) * 1e3
        loaders["host_cores"] = os.cpu_count()

        # SGCLS and SGDET from images: one detector gives the features
        # (its encode half) and the detections, on the 1000^2 canvas
        del featurize, detr, model, estep
        torch.cuda.empty_cache()
        detector = loop.load_detr(cfg, device="cuda", generator=gen(),
                                  detection=True, **quiet)
        dfeat = loop.make_detr_featurize_fn(cfg, detector)
        detect_fn = engines.make_detr_detect_fn(cfg, detector)
        dmodel = make_relation_classifier(cfg, device="cuda",
                                          generator=gen())
        detect_evals = {}
        for mode, runner in (("sgd", engines.run_eval_sgd),
                             ("sgc", engines.run_eval_sgc)):
            mcfg = cfg.replace(training=dataclasses.replace(
                cfg.training, eval_mode=mode))
            fn = cli.real_batches(mcfg, training=False)
            if mode == "sgd":
                first = next(iter(fn(0)))
                if first["image_nonsq"].shape != (b, CANVAS, CANVAS, 3):
                    raise AssertionError("canvas shape")
                padded = float(1 - first["pixel_mask"].mean())
                runner(mcfg, dmodel, cli.prepped_batches(mcfg, fn(0), dfeat),
                       detect_fn, artifacts=art, max_batches=1,
                       device="cuda")                       # warm-up
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            res = runner(mcfg, dmodel, cli.prepped_batches(mcfg, fn(0),
                                                           dfeat),
                         detect_fn, artifacts=art, device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = read_counts()
            want = expected(**{k: 2 * (PER_ENCODE.get(k, 0)
                                       + PER_DETECT.get(k, 0))
                               for k in PER_ENCODE}, pair_pool=2)
            if counts != want:
                raise AssertionError(f"run_eval_{mode} from images "
                                     f"launched {counts}, expected {want}")
            if not res["num_targets"] or not all(
                    0 <= r <= 1 for r in res["recall"]):
                raise AssertionError(f"run_eval_{mode} from images: {res}")
            detect_evals[mode] = {
                "wall_s_per_batch": secs / 2,
                "launches_per_batch": {k: v // 2 for k, v in
                                       counts.items()},
                "recall": res["recall"], "num_targets": res["num_targets"]}
        del detector, dfeat, detect_fn, dmodel
        torch.cuda.empty_cache()

        # the CLI as a user runs it: train (v2 records), then eval pc (v1
        # records + the cache) and eval sgd (the Python loader) at once
        run = {"model": {}, "training": {
            "batch_size": b, "num_epoch": 1, "print_freq": 1,
            "eval_freq": 0, "test_epoch": 0,
            "checkpoint_path": os.path.join(tmp, "ck"),
            "result_path": os.path.join(tmp, "res")}}
        yamls = {}
        for name, extra in (("train", {"sgrc_dir": sgrc_train}),
                            ("pc", {"sgrc_dir": sgrc_test,
                                    "features_dir": feat_dir}),
                            ("sgd", {})):
            yamls[name] = os.path.join(tmp, f"{name}.yaml")
            with open(yamls[name], "w") as f:
                json.dump({**run, "data": {**data, **extra}}, f)
        t0 = time.perf_counter()
        out = finish_cli("train", run_cli(root, yamls["train"], "--run_mode",
                                          "train", "--eval_mode", "pc"))
        cli_s = {"train": time.perf_counter() - t0}
        if "Saved checkpoint" not in out or "TEST, epoch 0, R@k" not in out:
            raise AssertionError(f"CLI train printed {out[-2000:]}")
        t0 = time.perf_counter()
        procs = {m: run_cli(root, yamls[m], "--run_mode", "eval",
                            "--eval_mode", m) for m in ("pc", "sgd")}
        cli_out = {}
        for m, proc in procs.items():
            lines_m = finish_cli(m, proc).strip().splitlines()
            if not any("Loaded relation checkpoint" in ln for ln in lines_m):
                raise AssertionError(f"CLI eval {m} did not load the "
                                     f"checkpoint: {lines_m[-5:]}")
            cli_out[m] = json.loads(lines_m[-1])
            if not all(0 <= r <= 1 for r in cli_out[m]["recall"]):
                raise AssertionError(f"CLI eval {m}: {cli_out[m]}")
        cli_s["eval_pc_and_sgd"] = time.perf_counter() - t0
    emit({"phase": "real_data", "images": {"train": n_train,
                                           "test": n_test},
          "sizes_hw": REAL_SIZES, "fabricate_s": fabricate_s,
          "native_build_s": native_build_s,
          "weights": log[0], "predcls_from_images": predcls,
          "precompute": {"written": written, "seconds": precompute_s},
          "native_equals_python": True, "train_from_records": training,
          "loaders": loaders, "canvas_padded_share": padded,
          **{f"{m}_from_images": v for m, v in detect_evals.items()},
          "cli_s": cli_s,
          "cli_results": {m: {k: v[k] for k in ("recall", "num_targets")}
                          for m, v in cli_out.items()}})


# phase offline: the raw VG (tools/make_raw_vg.py) of OFFLINE_IMAGES JPEGs
# at REAL_SIZES, split OFFLINE_TRAIN / the rest; the label-transfer check's
# relation head on the CPU and the card (float32, hidden OFFLINE_LT_HIDDEN:
# the full width's pair trunk takes minutes a batch on the CPU), its scores
# held within OFFLINE_LT_TOL, and the GloVe file's vector width
OFFLINE_IMAGES = 60
OFFLINE_TRAIN = 36
OFFLINE_LT_HIDDEN = 8
OFFLINE_LT_TOL = 1e-4
GLOVE_DIM = 100


def reference_relation_state(sd, cfg):
    """The reference's BayesianRelationClassifier state dict (torch layout,
    reference model.py:105-186, DDP's 'module.' prefixes) holding the
    port's weights `sd`: the inverse of weights.from_reference_state_dict
    (conv2's two halves joined, fc1's columns back to (c, y, x) order,
    fc2's column blocks joined, the embeddings as one-hot columns)."""
    h, sp = cfg.model.hidden_dim, cfg.model.feature_size // 4
    ref = {"conv1_1.weight": sd["conv1_sub.weight"],
           "conv1_1.bias": sd["conv1_sub.bias"],
           "conv1_2.weight": sd["conv1_obj.weight"],
           "conv1_2.bias": sd["conv1_obj.bias"],
           "conv2_1.weight": torch.cat([sd["conv2_sub.weight"],
                                        sd["conv2_obj.weight"]], 1),
           "conv2_1.bias": sd["conv2_obj.bias"],
           "conv3_1.weight": sd["conv3.weight"],
           "conv3_1.bias": sd["conv3.bias"],
           "fc1.weight": sd["fc1.weight"].reshape(-1, sp, sp, 8 * h)
           .permute(0, 3, 1, 2).reshape(sd["fc1.weight"].shape[0], -1),
           "fc1.bias": sd["fc1.bias"],
           "fc2.weight": torch.cat([sd["fc2_h.weight"],
                                    sd["emb_c1.weight"].T,
                                    sd["emb_c2.weight"].T,
                                    sd["fc2_s1.weight"],
                                    sd["fc2_s2.weight"]], 1),
           "fc2.bias": sd["fc2_h.bias"]}
    for name in ("fc4", "fc3_1", "fc3_2", "fc3_3", "fc5"):
        ref[f"{name}.weight"] = sd[f"{name}.weight"]
        ref[f"{name}.bias"] = sd[f"{name}.bias"]
    return {"module." + k: v.contiguous() for k, v in ref.items()}


def hub_detr_state(cfg, sd):
    """The torch-hub DETR names of the port's detector state dict `sd`
    (the inverse of weights.detr_from_hub_state_dict: each attention's
    q/k/v rows joined into in_proj)."""
    m = cfg.model
    hub = {h: sd[p] for p, h in weights._hub_key_map(
        m.detr_enc_layers, tuple(m.detr_blocks), m.detr_dec_layers).items()}
    attns = [(f"encoder_{i}.self_attn",
              f"transformer.encoder.layers.{i}.self_attn")
             for i in range(m.detr_enc_layers)]
    for i in range(m.detr_dec_layers):
        layer = f"transformer.decoder.layers.{i}"
        attns += [(f"decoder_{i}.self_attn", f"{layer}.self_attn"),
                  (f"decoder_{i}.cross_attn", f"{layer}.multihead_attn")]
    for port, name in attns:
        for kind in ("weight", "bias"):
            hub[f"{name}.in_proj_{kind}"] = torch.cat(
                [sd[f"{port}.{p}.{kind}"] for p in ("q_proj", "k_proj",
                                                    "v_proj")])
    return hub


def detectron2_name(key):
    """The detectron2 name of a torch-hub DETR backbone key, as the
    reference's VG-finetuned checkpoint names it (reference
    utils.py:96-119): stem.conv1(.norm), res<stage+1>.<i>.conv<c>(.norm),
    shortcut(.norm)."""
    prefix = "backbone.0.body."
    if not key.startswith(prefix):
        return key
    k = key[len(prefix):]
    k = re.sub(r"^conv1\.", "stem.conv1.", k)
    k = re.sub(r"^bn1\.", "stem.conv1.norm.", k)
    k = re.sub(r"^layer(\d)\.", lambda g: f"res{int(g.group(1)) + 1}.", k)
    k = re.sub(r"\.bn(\d)\.", r".conv\1.norm.", k)
    k = k.replace(".downsample.0.", ".shortcut.")
    return "backbone." + k.replace(".downsample.1.", ".shortcut.norm.")


def print_fail(line):
    """A log_fn for loads that must not warn (a missing weights file)."""
    raise AssertionError(line)


def quietly(fn, *args, **kwargs):
    """fn's result and the lines it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue().strip().splitlines()


def marginal_pairs(recs, mode, num_relations, tol):
    """The pairs whose label the transfer may set either way when the scores
    move by up to `tol`: a predicate argmax within 2 tol of the runner-up,
    a candidate margin within 2 tol of 0 or of the margin at a selection's
    cutoff (lt.select_top_percent at the tool's default percents), a
    relatedness within tol of the external gate."""
    from scene_graph_commonsense_torch.data import label_transfer as lt
    rels = {k: r["rel"] for k, r in recs.items()}
    freq = lt.predicate_frequencies(rels.values(), num_relations)
    near = set()
    lists = {"internal": [], "external": [], "nice": []}
    for k, r in recs.items():
        s = np.sort(r["scores"], axis=-1)
        with np.errstate(invalid="ignore"):        # unscored: -inf - -inf
            tie = s[..., -1] - s[..., -2] <= 2 * tol
        for i, j in zip(*np.nonzero(tie & np.isfinite(s).all(axis=-1))):
            near.add((k, int(i), int(j)))
        for i, j in zip(*np.nonzero(np.abs(r["conn"] - 0.5) <= tol)):
            near.add((k, int(i), int(j)))
        if mode == "ietrans":
            lists["internal"] += lt.internal_candidates(k, r["rel"],
                                                        r["scores"], freq)
            lists["external"] += lt.external_candidates(
                k, r["rel"], r["scores"], r["conn"], r["valid_pair"])
        else:
            lists["nice"] += lt.nice_candidates(k, r["rel"], r["scores"])
    percents = {"internal": 70.0, "external": 100.0, "nice": 30.0}
    for name, cands in lists.items():
        if not cands:
            continue
        margins = sorted((c.margin for c in cands), reverse=True)
        k = max(1, int(round(len(cands) * percents[name] / 100.0)))
        edges = [0.0] + margins[max(k - 1, 0):k + 1]
        for c in cands:
            if min(abs(c.margin - e) for e in edges) <= 2 * tol:
                near.add((c.image, c.sub, c.obj))
    return near


def offline_card_vs_cpu(data, feat_dir, gen):
    """The label-transfer tool's scoring (collect_scores) and both passes
    on the card and on the CPU from the same cached features and weights
    (a float32 head at hidden OFFLINE_LT_HIDDEN, TF32 off): the scores
    within OFFLINE_LT_TOL, and every relabel and summary count that differs
    explained by a pair of marginal_pairs."""
    from scene_graph_commonsense_torch.tools import label_transfer as ltool
    cfg = config_lib.derive(
        "vg", hierarchical_pred=True, run_mode="eval",
        data={**data, "features_dir": feat_dir},
        model={"hidden_dim": OFFLINE_LT_HIDDEN, "compute_dtype": "float32"},
        training={"batch_size": 12})
    with open(cfg.data.annotation_train) as f:
        ann = {"images": [i for i in json.load(f)["images"]
                          if os.path.exists(os.path.join(
                              feat_dir, os.path.splitext(i["file_name"])[0]
                              + "_features.npz"))]}
    sd = weights.init_params(cfg, gen())
    recs, launches, secs = {}, {}, {}
    for dev, tag in (("cuda", "card"), ("cpu", "cpu")):
        model = make_relation_classifier(cfg, device=dev, state_dict=sd)
        estep = engine.make_eval_step(model, cfg, device=dev)
        reset_counts()
        t0 = time.perf_counter()
        recs[tag] = ltool.collect_scores(cfg, batches_from_dataset(
            VGDataset(cfg, ann, training=False), 12, shuffle=False,
            drop_last=False), estep)
        launches[tag] = {k: v for k, v in read_counts().items() if v}
        secs[tag] = time.perf_counter() - t0
    if launches["cpu"]:
        raise AssertionError(f"the CPU pass launched {launches['cpu']}")
    if sorted(recs["card"]) != sorted(recs["cpu"]):
        raise AssertionError("the card and the CPU scored other images")
    err = 0.0
    for k, r in recs["cpu"].items():
        c = recs["card"][k]
        fin = np.isfinite(r["scores"])
        if not np.array_equal(fin, np.isfinite(c["scores"])):
            raise AssertionError(f"image {k}: other scored pairs")
        err = max(err, float(np.abs(c["scores"][fin]
                                    - r["scores"][fin]).max(initial=0)),
                  float(np.abs(c["conn"] - r["conn"]).max()))
    if not err <= OFFLINE_LT_TOL:
        raise AssertionError(f"card scores {err} off the CPU's")
    out = {"max_abs_err": err, "launches_card": launches["card"],
           "card_s": secs["card"], "cpu_s": secs["cpu"]}
    for mode in ("ietrans", "nice"):
        got = ltool.transfer(recs["card"], mode, cfg.model.num_relations)
        want = ltool.transfer(recs["cpu"], mode, cfg.model.num_relations)
        differ = {(k, int(i), int(j)) for k in want[1]
                  for i, j in zip(*np.nonzero(got[1][k] != want[1][k]))}
        near = marginal_pairs(recs["cpu"], mode, cfg.model.num_relations,
                              err) | marginal_pairs(
            recs["card"], mode, cfg.model.num_relations, err)
        if not differ <= near or (not differ and got[2] != want[2]):
            raise AssertionError(f"{mode}: the card relabels "
                                 f"{sorted(differ - near)[:8]} unlike the "
                                 f"CPU ({got[2]} against {want[2]})")
        out[mode] = {"card": got[2], "cpu": want[2],
                     "differing_pairs": len(differ),
                     "marginal_pairs": len(near)}
    return out


def phase_offline():
    """The offline data and checkpoint tools on the card, from raw files to
    a relabelled training set and trained steps: a raw VG fabricated in a
    temporary directory; the four stages of tools/preprocess_vg.py
    (instances through its body, write_instances, on the split indices:
    no h5py here); fit from the new SGRC records; a reference-format
    relation .pth and a DETR-101 state dict in detectron2's names through
    tools/convert_checkpoints.py; the IETrans pass of
    tools/label_transfer.py from the images with both; its scoring on the
    card against the CPU from the same features; a train step on the
    rewritten annotations; a GloVe text file through
    tools/glove_embeddings.py into a Motifs predictor and one pnp train
    step.  Each stage's seconds and launches are printed."""
    from scene_graph_commonsense_torch.data.dataset import load_annotation
    from scene_graph_commonsense_torch.tools import (
        convert_checkpoints, glove_embeddings, label_transfer,
        preprocess_vg)
    from scene_graph_commonsense_torch.tools.make_raw_vg import make_raw_vg
    torch.cuda.empty_cache()
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    stages = {}
    phase_t0 = time.perf_counter()

    def stage(name, fn, want=None):
        """Runs fn with the counts set to 0 just before and read just
        after; checks them against `want` (the launches of each kernel,
        none where not named)."""
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        counts = read_counts()
        stages[name] = {"s": time.perf_counter() - t0,
                        "launches": {k: v for k, v in counts.items() if v}}
        if counts != expected(**(want or {})):
            raise AssertionError(f"offline {name} launched {counts}, "
                                 f"expected {expected(**(want or {}))}")
        return out

    def per_encode(n, **extra):
        return {**{k: v * n for k, v in PER_ENCODE.items()}, **extra}

    repo_artifacts = os.path.join("datasets", "artifacts",
                                  "vg_artifacts.npz")
    with open(repo_artifacts, "rb") as f:
        repo_digest = hashlib.sha256(f.read()).hexdigest()
    with tempfile.TemporaryDirectory() as tmp:
        raw = stage("fabricate", lambda: make_raw_vg(
            os.path.join(tmp, "raw"), images=OFFLINE_IMAGES, seed=0,
            sizes=REAL_SIZES))
        data = {"image_dir": raw["image_dir"],
                "annot_dir": os.path.join(tmp, "annot"),
                "annotation_train": os.path.join(tmp, "train.json"),
                "annotation_test": os.path.join(tmp, "test.json"),
                "artifacts_dir": os.path.join(tmp, "artifacts")}
        os.makedirs(data["artifacts_dir"])
        shutil.copy(repo_artifacts, data["artifacts_dir"])
        cfg = config_lib.derive("vg", hierarchical_pred=True,
                                run_mode="eval", data=data,
                                training={"batch_size": 12})
        printed = {}

        # the four stages of tools/preprocess_vg.py
        (train, test, _), printed["instances"] = stage(
            "instances", lambda: quietly(
                preprocess_vg.write_instances, cfg, raw["raw_dir"],
                range(OFFLINE_TRAIN), range(OFFLINE_TRAIN, OFFLINE_IMAGES),
                vocab_dir=raw["vocab_dir"]))
        if (len(train["images"]), len(test["images"])) != (
                OFFLINE_TRAIN, OFFLINE_IMAGES - OFFLINE_TRAIN):
            raise AssertionError("the instances stage split "
                                 f"{len(train['images'])} / "
                                 f"{len(test['images'])}")
        if not any(a["relation_id"] == 12 for a in train["annotations"]):
            raise AssertionError("no raw predicate 12 ('wears') left")
        written = {}
        for split in ("train", "test"):
            args = argparse.Namespace(split=split, with_depth=True,
                                      device="cuda")
            written[split], printed[f"annotations_{split}"] = stage(
                f"annotations_{split}", lambda: quietly(
                    preprocess_vg.stage_annotations, args, cfg))
        ann_s = stages["annotations_train"]["s"] \
            + stages["annotations_test"]["s"]
        for split, js in (("train", train), ("test", test)):
            recs = [load_annotation(os.path.join(
                data["annot_dir"], os.path.splitext(i["file_name"])[0]
                + "_annotations.npz")) for i in js["images"]]
            if sum(r is not None for r in recs) != written[split] \
                    or not written[split]:
                raise AssertionError(f"{split}: {written[split]} files")
        path, printed["triplets"] = stage("triplets", lambda: quietly(
            preprocess_vg.stage_triplets, argparse.Namespace(), cfg))
        art = load_vg_artifacts(data["artifacts_dir"])
        with np.load(path) as z:
            if not len(z["train_rel"]) or not len(z["test_rel"]):
                raise AssertionError("empty triplet tables")
        sgrc = {s: os.path.join(tmp, f"sgrc_{s}") for s in ("train", "test")}
        records = {}
        for split in ("train", "test"):
            args = argparse.Namespace(split=split, out=sgrc[split],
                                      embed_images=split == "train")
            records[split] = stage(f"sgrecords_{split}",
                                   lambda: preprocess_vg.stage_sgrecords(
                                       args, cfg, log_fn=lambda *a: None))
        paths = {s: sorted(glob.glob(os.path.join(sgrc[s], "**",
                                                  "*.sgrec"),
                                     recursive=True)) for s in sgrc}
        if any(len(paths[s]) != records[s] for s in sgrc):
            raise AssertionError(f"records {records} on disk {paths}")

        # the records' batches against the Python loader's, image by image
        python_rows = {}
        for b in batches_from_dataset(VGDataset(cfg, test, training=False,
                                                load_images=False), 12,
                                      shuffle=False, drop_last=False):
            for i, name in enumerate(image_names(b["annot_path"])):
                python_rows[name] = {k: v[i] for k, v in b.items()
                                     if k != "annot_path"}
        compared = 0
        for b in NativeRecordPipeline(
                paths["test"], 12, max_objects=cfg.data.max_objects,
                feature_size=cfg.model.feature_size, shuffle=False,
                num_threads=8).iter_epoch(0):
            for i, name in enumerate(image_names(b["annot_path"])):
                for k, v in b.items():
                    if k == "annot_path":
                        continue
                    want = python_rows[name][k]
                    if v[i].dtype != want.dtype or \
                            not np.array_equal(v[i], want):
                        raise AssertionError(f"record {name}: {k}")
                compared += 1
        if compared != records["test"] // 12 * 12 or not compared:
            raise AssertionError(f"{compared} records compared")

        # the DETR-101 in detectron2's names through convert_checkpoints;
        # its encode against the un-renamed state dict's, bit for bit
        hub = hub_detr_state(cfg, weights.init_detr_params(
            cfg, gen(), detection=True))
        remap = os.path.join(tmp, "remap")
        os.makedirs(remap)
        renamed = [k for k in hub if detectron2_name(k) != k]
        for name, keys in (("before", [detectron2_name(k) for k in renamed]),
                           ("after", renamed)):
            with open(os.path.join(remap, f"detr101_key_{name}.txt"),
                      "w") as f:
                f.write("\n".join(keys) + "\n")
        detr_src = os.path.join(tmp, "detr101_vg_ckpt.pth")
        torch.save({"model": {detectron2_name(k): v for k, v in hub.items()},
                    "args": argparse.Namespace(backbone="resnet101")},
                   detr_src)
        detr_plain = os.path.join(tmp, "detr101_hub.pth")
        torch.save(hub, detr_plain)
        detr_pt = os.path.join(tmp, "detr101_vg.pth")
        _, printed["convert_detr"] = stage("convert_detr", lambda: quietly(
            convert_checkpoints.main, ["--kind", "detr", "--src", detr_src,
                                       "--out", detr_pt, "--remap", remap]))
        del hub
        images = torch.as_tensor(synthetic_images(
            np.random.default_rng(5), 12, cfg.model.image_size,
            with_aug=False)["image"])

        def encode(path):
            dcfg = config_lib.derive("vg", model={"detr_pretrained": path})
            featurize, _ = loop.load_detr_featurizer(
                dcfg, device="cuda", log_fn=print_fail)
            return featurize, featurize({"image": images})["features"]

        featurize, feats = stage("convert_detr_encode", lambda: encode(
            detr_pt), per_encode(1))
        _, plain_feats = encode(detr_plain)
        if not torch.equal(feats, plain_feats):
            raise AssertionError("the remapped DETR encodes otherwise")
        del plain_feats, feats

        # fit from the new SGRC records (v2: the plain view and the
        # jittered view in one 2B encode a step)
        tcfg = config_lib.derive(
            "vg", hierarchical_pred=True, run_mode="train", data=data,
            training={"batch_size": 12, "num_epoch": 1, "print_freq": 1,
                      "eval_freq": 0,
                      "checkpoint_path": os.path.join(tmp, "ck_fit"),
                      "result_path": os.path.join(tmp, "res_fit")})
        pipe = NativeRecordPipeline(
            paths["train"], 12, max_objects=cfg.data.max_objects,
            feature_size=cfg.model.feature_size,
            num_threads=8, seed=0, training=True,
            image_size=cfg.model.image_size, want_plain=True)
        steps = records["train"] // 12
        lines = []
        stage("fit_from_records", lambda: loop.fit(
            tcfg, make_relation_classifier(tcfg, device="cuda",
                                           generator=gen()),
            pipe.iter_epoch, None, steps_per_epoch=1000, artifacts=art,
            device="cuda", featurize=featurize, log_fn=lines.append),
            per_encode(steps, pair_pool_idx=2 * steps,
                       pair_pool_bwd=2 * steps))
        train_lines = [ln for ln in lines if ln.startswith("TRAIN")]
        if steps < 2 or len(train_lines) != steps \
                or "nan" in " ".join(train_lines):
            raise AssertionError(f"fit from the new records: {lines}")

        # the relation head's weights as a reference .pth through
        # convert_checkpoints: the same tensors, the same eval outputs
        sd = weights.init_params(cfg, gen())
        rel_src = os.path.join(tmp, "HierRelationModel_ref.pth")
        torch.save({"model": reference_relation_state(sd, cfg),
                    "args": argparse.Namespace(hierar=True)}, rel_src)
        rel_pt = os.path.join(tmp, "ck", "HierRelationModel_Baseline_"
                                         "motif0.pt")
        _, printed["convert_relation"] = stage(
            "convert_relation", lambda: quietly(
                convert_checkpoints.main, ["--kind", "relation", "--hierar",
                                           "--src", rel_src, "--out",
                                           rel_pt]))
        converted = torch.load(rel_pt, map_location="cpu",
                               weights_only=True)
        if sorted(converted) != sorted(sd) or not all(
                torch.equal(converted[k], sd[k]) for k in sd):
            raise AssertionError("the converted relation weights differ")
        batch = synthetic_batch(np.random.default_rng(6), batch_size=12,
                                feature_size=cfg.model.feature_size,
                                num_channels=cfg.model.num_img_feature,
                                with_aug=False)

        def eval_outputs(state_dict):
            model = make_relation_classifier(cfg, device="cuda",
                                             state_dict=state_dict)
            return engine.make_eval_step(model, cfg, device="cuda")(batch)

        want = eval_outputs(sd)
        got = stage("convert_relation_eval",
                    lambda: eval_outputs(ckpt_lib.load(rel_pt)),
                    {"pair_pool": 1})
        bad = [k for k in want if not torch.equal(got[k], want[k])]
        if bad:
            raise AssertionError(f"converted checkpoint's eval differs: {bad}")
        del sd, converted, got, want, batch
        torch.cuda.empty_cache()

        # the IETrans pass from the images with both converted files
        lt_out = os.path.join(tmp, "ietrans")
        lt_yaml = os.path.join(tmp, "lt.yaml")
        with open(lt_yaml, "w") as f:
            json.dump({"data": data, "model": {"detr_pretrained": detr_pt}},
                      f)
        batches = -(-records["train"] // 12)
        summary, printed["label_transfer"] = stage(
            "label_transfer", lambda: quietly(label_transfer.main, [
                "--mode", "ietrans", "--config", lt_yaml, "--checkpoint",
                rel_pt, "--out_dir", lt_out, "--batch_size", "12"]),
            per_encode(batches, pair_pool=batches))
        if json.loads(printed["label_transfer"][-1]) != summary \
                or summary["images"] != records["train"] \
                or not summary["written"]:
            raise AssertionError(f"label transfer: {summary}")

        # the same scoring on the card and the CPU from the same features
        feat_dir = os.path.join(tmp, "features")
        stage("precompute_train", lambda: precompute_features(
            cfg, "train", feat_dir, 12, featurize=featurize),
            per_encode(batches))
        card_vs_cpu = offline_card_vs_cpu(data, feat_dir, gen)
        del featurize
        torch.cuda.empty_cache()

        # a train step on the rewritten annotations: the cache with the
        # tool's files laid over it
        overlay = os.path.join(tmp, "annot_ietrans")
        shutil.copytree(data["annot_dir"], overlay)
        shutil.copytree(lt_out, overlay, dirs_exist_ok=True)
        ocfg = tcfg.replace(data=dataclasses.replace(tcfg.data,
                                                     annot_dir=overlay))
        changed = 0
        for old, new in zip(
                batches_from_dataset(VGDataset(tcfg, train, training=False,
                                               load_images=False), 12,
                                     shuffle=False, drop_last=False),
                batches_from_dataset(VGDataset(ocfg, train, training=False,
                                               load_images=False), 12,
                                     shuffle=False, drop_last=False)):
            changed += int(sum(not np.array_equal(a, b)
                               for a, b in zip(old["rel"], new["rel"])))
        if not 0 < changed <= summary["written"]:
            raise AssertionError(f"{changed} images read relabelled, "
                                 f"{summary['written']} written")
        featurize, _ = loop.load_detr_featurizer(
            cfg.replace(model=dataclasses.replace(
                cfg.model, detr_pretrained=detr_pt)),
            device="cuda", log_fn=print_fail)
        first = next(batches_from_dataset(VGDataset(ocfg, train,
                                                    training=True), 12))
        first.pop("annot_path")
        tmodel = make_relation_classifier(ocfg, device="cuda",
                                          generator=gen())
        opt = engine.make_optimizer(ocfg.training.learning_rate,
                                    momentum=ocfg.training.momentum,
                                    weight_decay=ocfg.training.weight_decay)
        step = engine.make_train_step(tmodel, ocfg, opt, class_weights("vg"),
                                      device="cuda")
        _, metrics = stage("train_step_rewritten", lambda: step(
            engine.init_train_state(tmodel, opt),
            to_device(featurize(first), torch.device("cuda"))),
            per_encode(1, pair_pool_idx=2, pair_pool_bwd=2))
        if not math.isfinite(float(metrics["loss"])):
            raise AssertionError(f"train step on rewritten labels: "
                                 f"{metrics}")
        del featurize, tmodel, step, opt, first

        # a GloVe text file -> glove_embeddings -> a Motifs predictor
        rng = np.random.default_rng(8)
        tokens = sorted({t for n in VG_OBJECTS for t in n.split()})
        glove_txt = os.path.join(tmp, "glove.100d.txt")
        with open(glove_txt, "w", encoding="utf-8") as f:
            for i, tok in enumerate(tokens):
                if i % 5:              # some tokens out of the vocabulary
                    f.write(tok + " " + " ".join(
                        f"{v:.5f}" for v in rng.standard_normal(GLOVE_DIM))
                        + "\n")
        glove_npz = os.path.join(tmp, "glove_labels_vg.npz")
        _, printed["glove"] = stage("glove", lambda: quietly(
            glove_embeddings.main, ["--glove", glove_txt, "--out",
                                    glove_npz]))
        gcfg = config_lib.derive("vg", hierarchical_pred=True,
                                 model={"glove_embeddings": glove_npz},
                                 training={"batch_size": 12})
        predictor = pnp_engine.make_predictor(gcfg, "motifs", device="cuda",
                                              log_fn=lambda *a: None)
        with np.load(glove_npz) as z:
            vecs, found = z["vectors"], z["found"]
        rows = np.nonzero(found)[0]
        for key, tab in predictor.state_dict().items():
            if key.endswith("label_embed.weight") and not np.array_equal(
                    tab[torch.as_tensor(rows)].cpu().numpy(), vecs[rows]):
                raise AssertionError(f"{key} is not the GloVe table")
        opt, state = pnp_train_parts(predictor, gcfg)
        pstep = pnp_engine.make_pnp_train_step(predictor, gcfg, opt,
                                               device="cuda")
        pbatch = to_device(synthetic_batch(
            np.random.default_rng(9), batch_size=12,
            feature_size=gcfg.model.feature_size,
            num_channels=gcfg.model.num_img_feature, with_aug=False),
            torch.device("cuda"))
        _, pmetrics = stage("pnp_step_glove", lambda: pstep(state, pbatch))
        if not math.isfinite(float(pmetrics["loss"])):
            raise AssertionError(f"pnp step from GloVe: {pmetrics}")
    with open(repo_artifacts, "rb") as f:
        if hashlib.sha256(f.read()).hexdigest() != repo_digest:
            raise AssertionError("the repo's vg_artifacts.npz changed")
    emit({"phase": "offline", "card": bench.card_name(),
          "phase_s": time.perf_counter() - phase_t0,
          "images": {"train": OFFLINE_TRAIN,
                     "test": OFFLINE_IMAGES - OFFLINE_TRAIN},
          "sizes_hw": REAL_SIZES, "records": records,
          "annotations_written": written,
          "annotation_img_per_s": OFFLINE_IMAGES / ann_s,
          "label_transfer": {"summary": summary, "batches": batches,
                             "s_per_batch":
                                 stages["label_transfer"]["s"] / batches},
          "fit_steps": steps, "fit_lines": train_lines,
          "records_equal_loader": compared,
          "card_vs_cpu": card_vs_cpu, "stages": stages,
          "printed": {k: v[-2:] for k, v in printed.items()}})


def chunked_train_launches(capacities, chunk):
    """K2 launches of one train step whose views pack `capacities` pairs,
    at chunk_size `chunk` (engine._chunked_pair_trunk): a view split into
    n > 1 chunks runs the forward with index 2n times (each chunk's forward
    and its recompute in the backward) and the backward n times; a view in
    one piece runs each once."""
    idx = bwd = 0
    for cap in capacities:
        n = -(-cap // chunk) if 0 < chunk < cap else 1
        idx += 2 * n if n > 1 else 1
        bwd += n
    return {"pair_pool_idx": idx, "pair_pool_bwd": bwd}


def train_model(cfg, faithful=False, state_dict=None):
    """(model, optimizer, state) for a train step on the card: seeded
    weights (or `state_dict`) and the config's optimizer."""
    tc = cfg.training
    model = make_relation_classifier(
        cfg, device="cuda", state_dict=state_dict,
        generator=torch.Generator().manual_seed(0))
    opt = engine.make_optimizer(tc.learning_rate, momentum=tc.momentum,
                                weight_decay=tc.weight_decay,
                                grad_clip_norm=tc.grad_clip_norm,
                                momentum_dtype=tc.momentum_dtype)
    return model, opt, engine.init_train_state(model, opt)


def timed_train(step, state, batch, warmup, steps):
    """`warmup` steps, then `steps` timed by CUDA events with the launch
    counts set to 0 just before and peak memory reset.  Returns (state,
    the timed steps' float metrics, ms per step, peak GB, launches)."""
    for _ in range(warmup):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    seen = []
    start.record()
    for _ in range(steps):
        state, metrics = step(state, batch)
        seen.append(metrics)
    end.record()
    torch.cuda.synchronize()
    launches = read_counts()
    metrics = [{k: float(v) for k, v in m.items()} for m in seen]
    for m in metrics:
        bad = [k for k, v in m.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite train metrics {bad}")
    return (state, metrics, start.elapsed_time(end) / steps,
            torch.cuda.max_memory_allocated() / 1e9, launches)


def max_err(got, want):
    return float((got.float() - want.float()).abs().max())


def phase_commonsense():
    """The commonsense loop and the training leftovers at full VG width
    (derive("vg", hierarchical_pred=True), bf16, batch 12, 20 objects,
    seeded weights): (a) the faithful train step against the ordinary one
    at the same capacity; (b) the chunked eval and train steps at
    chunk_size CHUNK against the unchunked ones; (c) prepare_cs from the
    images of phase real_data's mini-VG, its resume, and the CLI chain
    train -> prepare_cs -> train_cs -> eval_cs; (d) a fit with TensorBoard
    scalars and a profiler window."""
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    base = {"batch_size": 12, "grad_clip_norm": bench.GRAD_CLIP_NORM}
    batch = to_device(synthetic_batch(np.random.default_rng(7)), dev)
    warmup, steps = 1, 3
    result = {"phase": "commonsense", "card": bench.card_name()}

    # (a) the faithful step (every valid pair, B N (N - 1) = 4560; the
    # augmented view at 4560 // 4) and the ordinary step at 4560 / 1140
    steps_out = {}
    for name, faithful in (("faithful", True), ("ordinary", False)):
        cfg = config_lib.derive("vg", hierarchical_pred=True, training={
            **base, "faithful_dynamics": faithful})
        model, opt, state = train_model(cfg)
        step = engine.make_train_step(
            model, cfg, opt, class_weights("vg", faithful=faithful),
            device="cuda")
        before = model.fc1.weight[:8].detach().clone()
        state, metrics, ms, peak, launches = timed_train(
            step, state, batch, warmup, steps)
        caps = (engine.train_pair_capacity(cfg),
                engine.aug_pair_capacity(cfg))
        if caps != (4560, 1140):
            raise AssertionError(f"{name} capacities {caps}")
        want = expected(pair_pool_idx=2 * steps, pair_pool_bwd=2 * steps)
        if launches != want:
            raise AssertionError(f"{name} step launches {launches}, "
                                 f"expected {want}")
        moved = max_err(model.fc1.weight[:8].detach(), before)
        if not moved > 0:
            raise AssertionError(f"{name} step left fc1 unchanged")
        steps_out[name] = {"step_ms": ms, "peak_mem_gb": peak,
                           "launches_per_step": {
                               k: v // steps for k, v in launches.items()
                               if v},
                           "capacities": caps, "fc1_max_change": moved,
                           "losses_last": {k: v for k, v in
                                           metrics[-1].items()
                                           if k.startswith("loss")}}
        if faithful:
            scales = [m["lr_scale"] for m in metrics]
            if not all(0 < x <= 1 for x in scales):
                raise AssertionError(f"lr_scale {scales}")
            steps_out[name]["lr_scale"] = scales[-1]
        del model, opt, state, step
        torch.cuda.empty_cache()
    result["faithful_vs_ordinary"] = {"steps": steps, "warmup": warmup,
                                      **steps_out}

    # (b) the chunked path: the eval step at worst-case capacity, then the
    # train step (dropout off, so that the steps can be compared) from
    # one set of weights; the tolerance of each bf16 output is 2x the
    # unchunked step's own error against a float32 run of it
    ecfg = config_lib.derive("vg", hierarchical_pred=True, run_mode="eval",
                             training={"batch_size": 12})
    cap = ecfg.pair_capacity
    eval_batch = next(synthetic_batches(ecfg, 1, seed=8))
    model = make_relation_classifier(
        ecfg, device="cuda", generator=torch.Generator().manual_seed(0))
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    model32 = make_relation_classifier(
        config_lib.derive("vg", hierarchical_pred=True, run_mode="eval",
                          model={"compute_dtype": "float32"},
                          training={"batch_size": 12}),
        device="cuda", state_dict=sd)
    esteps = {"unchunked": engine.make_eval_step(model, ecfg, device="cuda"),
              "chunked": engine.make_eval_step(model, ecfg, device="cuda",
                                               chunk_size=CHUNK),
              "float32": engine.make_eval_step(model32, ecfg,
                                               device="cuda")}
    outs, eval_ms, eval_peak, eval_launches = {}, {}, {}, {}
    for name, fn in esteps.items():
        fn(eval_batch)                                     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        outs[name] = fn(eval_batch)
        torch.cuda.synchronize()
        eval_launches[name] = read_counts()
        eval_peak[name] = torch.cuda.max_memory_allocated() / 1e9
        if name != "float32":                 # the reference, not timed
            eval_ms[name] = cuda_ms(lambda f=fn: f(eval_batch), 3)
    n_chunks = -(-cap // CHUNK)
    for name, want in (("chunked", expected(pair_pool=n_chunks)),
                       ("unchunked", expected(pair_pool=1))):
        if eval_launches[name] != want:
            raise AssertionError(f"{name} eval step launched "
                                 f"{eval_launches[name]}, expected {want}")
    eval_err = {}
    for k, v in outs["unchunked"].items():
        if k in ("relation", "super_relation", "connectivity"):
            ref = outs["float32"][k]
            eval_err[k] = {"unchunked": max_err(v, ref),
                           "chunked": max_err(outs["chunked"][k], ref)}
            if eval_err[k]["chunked"] > 2 * eval_err[k]["unchunked"]:
                raise AssertionError(f"chunked eval {k}: {eval_err[k]}")
        elif not torch.equal(outs["chunked"][k], v):
            raise AssertionError(f"chunked eval {k} differs")
    del model, model32, esteps, outs
    torch.cuda.empty_cache()

    tcfg = config_lib.derive("vg", hierarchical_pred=True,
                             model={"dropout_rate": 0.0}, training=base)
    caps = (engine.train_pair_capacity(tcfg), engine.aug_pair_capacity(tcfg))
    sd = ref = None
    train_err, train_ms, train_peak, train_launches = {}, {}, {}, {}
    for name, chunk, dtype in (("float32", 0, "float32"),
                               ("unchunked", 0, "bfloat16"),
                               ("chunked", CHUNK, "bfloat16")):
        cfg = tcfg.replace(model=dataclasses.replace(tcfg.model,
                                                     compute_dtype=dtype))
        model, opt, state = train_model(cfg, state_dict=sd)
        if sd is None:
            sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        step = engine.make_train_step(model, cfg, opt, class_weights("vg"),
                                      device="cuda", chunk_size=chunk)
        state, met = step(state, batch)               # from the same weights
        # the first update and losses, on the host (kept on the card they
        # would weigh on the next configuration's peak memory)
        upd = {k: (v.detach() - sd[k].to(dev)).cpu()
               for k, v in state.params.items()}
        loss = {k: float(v) for k, v in met.items() if k.startswith("loss")}
        if ref is None:
            ref = (upd, loss)
        else:
            train_err[name] = {
                "update": max(max_err(upd[k], ref[0][k]) for k in upd),
                **{k: abs(loss[k] - ref[1][k]) for k in loss}}
            state, _, train_ms[name], train_peak[name], \
                train_launches[name] = timed_train(step, state, batch, 1, 3)
        del model, opt, state, step, upd
        torch.cuda.empty_cache()
    for name, chunk in (("chunked", CHUNK), ("unchunked", 0)):
        want = expected(**{k: 3 * v for k, v in
                           chunked_train_launches(caps, chunk).items()})
        if train_launches[name] != want:
            raise AssertionError(f"{name} train step launched "
                                 f"{train_launches[name]}, expected {want}")
    for k, v in train_err["chunked"].items():
        if v > 2 * train_err["unchunked"][k]:
            raise AssertionError(f"chunked train step {k}: {v} against "
                                 f"the unchunked {train_err['unchunked'][k]}")
    del ref, sd
    result["chunked"] = {
        "chunk_size": CHUNK, "eval_capacity": cap,
        "eval_launches_per_step": {k: {n: c for n, c in v.items() if c}
                                   for k, v in eval_launches.items()},
        "eval_ms": eval_ms, "eval_peak_mem_gb": eval_peak,
        "eval_err_vs_float32": eval_err, "train_capacities": caps,
        "train_launches_per_step": {k: {n: c // 3 for n, c in v.items()
                                        if c}
                                    for k, v in train_launches.items()},
        "train_ms": train_ms, "train_peak_mem_gb": train_peak,
        "train_err_vs_float32": train_err, "tolerance": "2x unchunked"}
    emit(result)
    phase_commonsense_loop()


def phase_commonsense_loop():
    """(c) and (d) of phase commonsense: prepare_cs from images, its resume,
    the CLI chain, and a fit with scalars and a profiler window."""
    root = os.path.dirname(os.path.abspath(__file__))
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    quiet = dict(log_fn=lambda *a: None)
    result = {"phase": "commonsense_loop"}
    with tempfile.TemporaryDirectory() as tmp:
        data, n_train, _ = mini_vg(tmp)
        art_dir = os.path.join(tmp, "art")
        os.makedirs(art_dir)
        shutil.copy(os.path.join("datasets", "artifacts",
                                 "vg_artifacts.npz"), art_dir)
        data["artifacts_dir"] = art_dir
        cfg = config_lib.derive("vg", hierarchical_pred=True,
                                run_mode="prepare_cs", data=data,
                                training={"batch_size": 12})
        art = load_vg_artifacts(art_dir)
        featurize, detr = loop.load_detr_featurizer(
            cfg, device="cuda", generator=gen(), **quiet)
        model = make_relation_classifier(cfg, device="cuda",
                                         generator=gen())
        train_fn = cli.real_batches(cfg, training=True)
        transport = cli.mock_llm_transport()
        # warm-up on one batch, without the prefetch thread (an abandoned
        # producer would go on encoding into the counted run)
        run_prepare_cs(cfg, model, map(featurize,
                                       itertools.islice(train_fn(0), 1)),
                       art, transport=transport, device="cuda",
                       out_dir=os.path.join(tmp, "warm"))
        torch.cuda.synchronize()
        out_dir = os.path.join(tmp, "cs")
        encoded = []

        def featurize_kept(batch):
            encoded.append(featurize(batch))
            return encoded[-1]

        reset_counts()
        t0 = time.perf_counter()
        path = run_prepare_cs(cfg, model,
                              cli.prepped_batches(cfg, train_fn(0),
                                                  featurize_kept),
                              art, transport=transport, device="cuda",
                              out_dir=out_dir)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = read_counts()
        n_batches = n_train // cfg.training.batch_size
        want = expected(**{k: v * n_batches for k, v in PER_ENCODE.items()},
                        pair_pool=n_batches)
        if counts != want:
            raise AssertionError(f"prepare_cs from images launched {counts}"
                                 f", expected {want}")
        table = dict(np.load(path))
        files = [f for f in os.listdir(out_dir)
                 if f.endswith("_pseudo_annotations.npz")]
        if not (len(table["cs_aligned_sub"]) and files):
            raise AssertionError(f"prepare_cs wrote {len(files)} files and "
                                 f"{len(table['cs_aligned_sub'])} aligned")

        # resume over the same encoded batches: no image is queried again;
        # a batch whose every image has its file never reaches the card,
        # and an image with nothing to validate has no file (as in JAX),
        # so its batch runs the eval step again
        def refuse(prompts):
            raise AssertionError("prepare_cs resumed images were queried")

        rerun = sum(not all(os.path.exists(os.path.join(
            out_dir, os.path.splitext(os.path.basename(p))[0]
            + "_pseudo_annotations.npz")) for p in bt["annot_path"])
            for bt in encoded)
        reset_counts()
        t0 = time.perf_counter()
        again = dict(np.load(run_prepare_cs(
            cfg, model, encoded, art, transport=refuse, device="cuda",
            out_dir=out_dir)))
        resume_s = time.perf_counter() - t0
        if read_counts() != expected(pair_pool=rerun):
            raise AssertionError(f"the resume launched {read_counts()}, "
                                 f"expected {rerun} eval steps")
        cols = ("sub", "rel", "obj", "count")
        for prefix in ("cs_aligned", "cs_violated"):
            rows = [sorted(zip(*(t[f"{prefix}_{c}"].tolist()
                                 for c in cols))) for t in (table, again)]
            if rows[0] != rows[1]:
                raise AssertionError(f"the resume changed {prefix}")
        result["prepare_cs"] = {
            "batches": n_batches, "wall_s_per_batch": secs / n_batches,
            "launches_per_batch": {k: v // n_batches
                                   for k, v in counts.items() if v},
            "per_image_files": len(files),
            "aligned": len(table["cs_aligned_sub"]),
            "violated": len(table["cs_violated_sub"]),
            "resume_s": resume_s, "resume_batches_rerun": rerun,
            "resume_launches": {k: v for k, v in read_counts().items()
                                if v}}
        del encoded
        del featurize, detr, model
        torch.cuda.empty_cache()

        # the CLI as a user runs it, on a third of the training images and
        # half the test images: train, prepare_cs (mock LLM), train_cs,
        # eval_cs, each exiting 0
        yaml_path = os.path.join(tmp, "cs.yaml")
        with open(yaml_path, "w") as f:
            json.dump({"data": {**data, "percent_train": 0.34,
                                "percent_test": 0.5},
                       "training": {
                           "batch_size": 12, "num_epoch": 1,
                           "print_freq": 1, "eval_freq": 0, "test_epoch": 0,
                           "checkpoint_path": os.path.join(tmp, "ck"),
                           "result_path": os.path.join(tmp, "res")}}, f)
        cli_s, cli_out = {}, {}
        for mode in ("train", "prepare_cs", "train_cs", "eval_cs"):
            t0 = time.perf_counter()
            cli_out[mode] = finish_cli(mode, run_cli(
                root, yaml_path, "--run_mode", mode, "--eval_mode", "pc",
                "--mock-llm"))
            cli_s[mode] = time.perf_counter() - t0
        cs_losses = [float(ln.split("commonsense=")[1].split(",")[0])
                     for ln in cli_out["train_cs"].splitlines()
                     if ln.startswith("TRAIN")]
        if not cs_losses or not all(x > 0 for x in cs_losses):
            raise AssertionError(f"train_cs commonsense losses {cs_losses}")
        if "Wrote commonsense triplet tables" not in cli_out["prepare_cs"] \
                or "Loaded relation checkpoint" not in cli_out["prepare_cs"]:
            raise AssertionError(f"CLI prepare_cs printed "
                                 f"{cli_out['prepare_cs'][-2000:]}")
        eval_cs = json.loads(cli_out["eval_cs"].strip().splitlines()[-1])
        if not all(0 <= r <= 1 for r in eval_cs["recall"]):
            raise AssertionError(f"CLI eval_cs: {eval_cs}")
        result["cli"] = {"seconds": cli_s,
                         "train_cs_loss_commonsense": cs_losses,
                         "eval_cs_recall": eval_cs["recall"]}

        # (d) fit for 3 steps with TensorBoard scalars and a profiler
        # window [1, 2): the JAX package's tag set; a Chrome trace of step
        # 1 naming the training kernels
        tb, prof = os.path.join(tmp, "tb"), os.path.join(tmp, "prof")
        fcfg = bench.bench_config(
            num_epoch=1, print_freq=1, eval_freq=0, tensorboard=True,
            tensorboard_dir=tb, profile_dir=prof, profile_start_step=1,
            profile_num_steps=1, checkpoint_path=os.path.join(tmp, "ck2"),
            result_path=os.path.join(tmp, "res2"))
        fmodel = make_relation_classifier(fcfg, device="cuda",
                                          generator=gen())
        reset_counts()
        loop.fit(fcfg, fmodel,
                 lambda e: synthetic_batches(fcfg, 3, seed=e, with_aug=True),
                 lambda e: synthetic_batches(fcfg, 1, seed=100 + e),
                 steps_per_epoch=3, artifacts=art, device="cuda", **quiet)
        torch.cuda.synchronize()
        counts = read_counts()
        want = expected(pair_pool=1, pair_pool_idx=6, pair_pool_bwd=6)
        if counts != want:
            raise AssertionError(f"fit launched {counts}, expected {want}")
        if os.path.exists(os.path.join(tb, "scalars.jsonl")):
            writer = "jsonl"
            with open(os.path.join(tb, "scalars.jsonl")) as f:
                tags = {json.loads(line)["tag"] for line in f}
        else:
            from tensorboard.backend.event_processing.event_accumulator \
                import EventAccumulator
            writer = "tensorboard"
            acc = EventAccumulator(tb)
            acc.Reload()
            tags = set(acc.Tags()["scalars"])
        want_tags = {f"train/{k}" for k in TRAIN_METRICS} \
            | {"train/lr"} | set(TEST_TAGS)
        if tags != want_tags:
            raise AssertionError(f"fit scalars {sorted(tags)}, expected "
                                 f"{sorted(want_tags)}")
        traces = os.listdir(prof)
        if traces != ["trace_1_2.json"]:
            raise AssertionError(f"profile_dir holds {traces}")
        with open(os.path.join(prof, traces[0])) as f:
            names = [e.get("name", "") for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "kernel"]
        traced = {k: sum(f"{k}_kernel" in n for n in names)
                  for k in ("pair_pool_idx", "pair_pool_bwd")}
        if traced != {"pair_pool_idx": 2, "pair_pool_bwd": 2}:
            raise AssertionError(f"the trace of step 1 holds the training "
                                 f"kernels {traced} times")
        result["observability"] = {
            "writer": writer, "tags": len(tags),
            "trace_kernels": len(names), "trace_training_kernels": traced}
    emit(result)


# phases oiv6 and pnp: the mini-OIv6 (OIV6_IMAGES JPEGs at OIv6-like sizes,
# 36 train and 24 test: 3 training and 2 test batches of 12), the predictor
# families, and the reduced widths of the card-vs-CPU check
OIV6_IMAGES = 60
OIV6_TRAIN_FRAC = 0.6
PNP_FAMILIES = ("motifs", "transformer", "vctree", "vtranse")
PNP_TOL = 1e-4


def mini_oiv6(tmp):
    """The mini-OIv6 under `tmp` (tools/make_mini_oiv6.py); returns the
    config's data paths."""
    root = os.path.join(tmp, "oiv6")
    n_train, n_test = make_mini_oiv6(root, images=OIV6_IMAGES,
                                     max_objects=20, seed=0,
                                     train_frac=OIV6_TRAIN_FRAC)
    if (n_train, n_test) != (36, 24):
        raise AssertionError(f"mini-OIv6 split {n_train}/{n_test}")
    return data_config(root)


def phase_oiv6(data):
    """OIv6 at full width (derive("oiv6"): 601 classes, 30 relations in
    (4, 2, 24), the flagship head, bf16, batch 12, 20 objects, seeded
    weights) from the mini-OIv6's JPEGs through the CLI's data path
    (cli.real_batches, prepped_batches, the live featurizer): PredCLS eval
    over the 2 test batches with the weighted mAP, exact launches (one
    encode and one pair-pool launch a batch); fit for 3 steps from the
    training images (one encode, one pair-pool-with-index and one backward
    launch a step: OIv6 batches carry no augmented view); the eval step
    from features by CUDA events, in turns with the VG head's; the CLI's
    --eval_mode sgd refused (oiv6_detection_refused)."""
    torch.cuda.empty_cache()
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    result = {"phase": "oiv6", "card": bench.card_name()}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = config_lib.derive("oiv6", hierarchical_pred=True,
                                run_mode="eval", data=data,
                                training={"batch_size": 12})
        m = cfg.model
        if (m.num_classes, m.num_relations, m.num_geometric,
                m.num_possessive, m.num_semantic) != (601, 30, 4, 2, 24):
            raise AssertionError(f"OIv6 head {m}")
        featurize, _ = loop.load_detr_featurizer(
            cfg, device="cuda", generator=gen(), log_fn=lambda *a: None)
        model = make_relation_classifier(cfg, device="cuda",
                                         generator=gen())
        estep = engine.make_eval_step(model, cfg, device="cuda")
        test_fn = cli.real_batches(cfg, training=False)
        engines.run_eval_pc(cfg, model, cli.prepped_batches(
            cfg, test_fn(0), featurize), estep=estep, max_batches=1)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        res = engines.run_eval_pc(
            cfg, model, cli.prepped_batches(cfg, test_fn(0), featurize),
            estep=estep, device="cuda")
        torch.cuda.synchronize()
        pc_s = time.perf_counter() - t0
        counts = read_counts()
        want = expected(**{k: v * 2 for k, v in PER_ENCODE.items()},
                        pair_pool=2)
        if counts != want:
            raise AssertionError(f"OIv6 PredCLS from images launched "
                                 f"{counts}, expected {want}")
        if not res["num_targets"] or not all(
                0 <= r <= 1 for r in res["recall"] + [res["wmap_rel"],
                                                      res["wmap_phrase"]]):
            raise AssertionError(f"OIv6 PredCLS from images: {res}")
        host = next(iter(test_fn(0)))
        if host["image"].shape != (12, 1024, 1024, 3) or \
                host["image_nonsq"].shape != (12, 1000, 1000, 3) or \
                "super_mh" in host:
            raise AssertionError("OIv6 batch shapes")
        fbatch = featurize(host)
        eval_ms, eval_issue = cuda_ms(lambda: estep(fbatch), 10,
                                       issue=True)
        # the VG head (150 classes, 50 relations) on the same features and
        # boxes (the classes folded into VG's range), in turns with the OIv6
        # head
        vcfg = config_lib.derive("vg", hierarchical_pred=True,
                                 training={"batch_size": 12})
        vg_step = engine.make_eval_step(
            make_relation_classifier(vcfg, device="cuda", generator=gen()),
            vcfg, device="cuda")
        vbatch = {**fbatch, "cats": fbatch["cats"] % 150}
        vg_ms = cuda_ms(lambda: vg_step(vbatch), 10)
        eval_ms_2 = cuda_ms(lambda: estep(fbatch), 10)
        del vg_step, vbatch
        result["predcls"] = {
            "wall_s_per_batch": pc_s / 2,
            "launches_per_batch": {k: v // 2 for k, v in counts.items()
                                   if v},
            "recall": res["recall"], "mean_recall": res["mean_recall"],
            "wmap_rel": res["wmap_rel"], "wmap_phrase": res["wmap_phrase"],
            "num_targets": res["num_targets"],
            "eval_step_ms": [eval_ms, eval_ms_2],
            "eval_step_issue_ms": eval_issue,
            "vg_head_eval_step_ms": vg_ms}
        del fbatch

        tcfg = config_lib.derive(
            "oiv6", hierarchical_pred=True, run_mode="train", data=data,
            training={"batch_size": 12, "num_epoch": 1, "print_freq": 1,
                      "eval_freq": 0, "grad_clip_norm": bench.GRAD_CLIP_NORM,
                      "checkpoint_path": os.path.join(tmp, "ck"),
                      "result_path": os.path.join(tmp, "res")})
        tmodel = make_relation_classifier(tcfg, device="cuda",
                                          generator=gen())
        lines = []
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        loop.fit(tcfg, tmodel, cli.real_batches(tcfg, training=True), None,
                 steps_per_epoch=1000, device="cuda", featurize=featurize,
                 log_fn=lines.append)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = read_counts()
        want = expected(**{k: v * 3 for k, v in PER_ENCODE.items()},
                        pair_pool_idx=3, pair_pool_bwd=3)
        if counts != want:
            raise AssertionError(f"OIv6 fit launched {counts}, expected "
                                 f"{want}")
        train_lines = [ln for ln in lines if ln.startswith("TRAIN")]
        if len(train_lines) != 3 or "nan" in " ".join(train_lines):
            raise AssertionError(f"OIv6 fit printed {lines}")
        if not os.path.exists(loop.checkpoint_file(tcfg, 0)):
            raise AssertionError("OIv6 fit wrote no checkpoint")
        result["fit"] = {"s_per_step": fit_s / 3,
                         "peak_mem_gb": torch.cuda.max_memory_allocated()
                         / 1e9,
                         "launches_per_step": {k: v // 3 for k, v in
                                               counts.items() if v},
                         "last_line": train_lines[-1]}
        del featurize, model, estep, tmodel
        result["sgd_refused"] = oiv6_detection_refused(data, tmp)
    emit(result)


def oiv6_detection_refused(data, tmp):
    """The CLI's OIv6 SGDET on the mini-OIv6, as a user runs it: it must
    exit non-zero with engines.check_detector_classes' message (VG's
    151-entry class remap, the 602-class detector) before it builds the
    detector.  Returns the message and the seconds the run took."""
    yaml_path = os.path.join(tmp, "sgd.yaml")
    with open(yaml_path, "w") as f:
        json.dump({"data": data, "training": {
            "batch_size": 12, "test_epoch": 0,
            "checkpoint_path": os.path.join(tmp, "sgd_ck"),
            "result_path": os.path.join(tmp, "sgd_res")}}, f)
    t0 = time.perf_counter()
    proc = run_cli(os.path.dirname(os.path.abspath(__file__)), yaml_path,
                   "--dataset", "oiv6", "--run_mode", "eval",
                   "--eval_mode", "sgd")
    out, err = proc.communicate(timeout=300)
    message = next((ln for ln in err.splitlines()
                    if "no class remap is defined" in ln), "")
    if proc.returncode == 0 or "602 classes" not in message \
            or "DETR" in out:
        raise AssertionError(f"the CLI's OIv6 SGDET exited "
                             f"{proc.returncode}: {out[-2000:]}\n"
                             f"{err[-3000:]}")
    return {"exit": proc.returncode, "message": message,
            "seconds": time.perf_counter() - t0}


def pnp_train_parts(predictor, cfg):
    """(optimizer, state) of a predictor's train step: fit_predictor's
    optimizer (clip 5.0) at a constant learning rate."""
    opt = engine.make_optimizer(cfg.training.learning_rate,
                                momentum=cfg.training.momentum,
                                weight_decay=cfg.training.weight_decay,
                                grad_clip_norm=bench.GRAD_CLIP_NORM)
    return opt, engine.init_train_state(predictor, opt)


def pnp_card_vs_cpu(family, gen):
    """One train step and the eval step (with TDE) of `family` at reduced
    widths (hidden 32, pair 64, 8 objects, a 16^2 grid of 32 channels,
    batch 2) in float32 with TF32 off, on the card and on the CPU from the
    same weights and batch: outputs, losses and parameters after the step
    within PNP_TOL.  VCTree's trees come from Prim's argmax, where rounding
    may flip a near-tie: the CPU records the parent and depth of each of
    its structure calls, the card counts the entries where its own differ
    (`parent_flips`, reported) and then goes on with the CPU's, so that
    everything else is compared whatever the trees."""
    cfg = config_lib.derive(
        "vg", hierarchical_pred=True,
        model={"feature_size": 16, "num_img_feature": 32},
        data={"max_objects": 8},
        training={"batch_size": 2, "learning_rate": 1e-2})
    batch = synthetic_batch(np.random.default_rng(61), batch_size=2,
                            max_objects=8, feature_size=16,
                            num_channels=32, with_aug=False)
    kw = dict(family=family, feature_dim=32, union_dim=32, hidden_dim=32,
              pair_dim=64, box_scale=16.0)
    cpu = HierarchicalPredictor(**kw)
    cpu.load_state_dict(weights.init_predictor_state(cpu, gen))
    card = HierarchicalPredictor(**kw).cuda()
    card.load_state_dict(cpu.state_dict())
    trees, flips = [], []
    if family == "vctree":
        def recorded(x, boxes, valid, own=cpu.context.structure):
            scores, parent, depth = own(x, boxes, valid)
            trees.append((parent, depth))
            return scores, parent, depth

        def replayed(x, boxes, valid, own=card.context.structure):
            scores, parent, depth = own(x, boxes, valid)
            want, want_depth = (t.to(parent.device)
                                for t in trees[len(flips)])
            flips.append(int((parent != want).sum()))
            return scores, want, want_depth

        cpu.context.structure = recorded
        card.context.structure = replayed
    outs = []
    for p, dev in ((cpu, "cpu"), (card, "cuda")):
        opt, state = pnp_train_parts(p, cfg)
        estep = pnp_engine.make_pnp_eval_step(p, cfg, tde=True, device=dev)
        before = {k: v.cpu() for k, v in estep(batch).items()}
        step = pnp_engine.make_pnp_train_step(p, cfg, opt, device=dev)
        _, metrics = step(state, batch)
        outs.append((before, {k: float(v) for k, v in metrics.items()},
                     {k: v.detach().cpu() for k, v in
                      p.state_dict().items()}))
    if family == "vctree" and (not trees or len(flips) != len(trees)):
        raise AssertionError(f"vctree built {len(trees)} trees on the CPU, "
                             f"{len(flips)} on the card")
    (b0, m0, s0), (b1, m1, s1) = outs
    errs = {"eval": max(max_err(b1[k], b0[k]) for k in b0
                        if b0[k].dtype.is_floating_point),
            "metrics": max(abs(m1[k] - m0[k]) for k in m0),
            "params": max(max_err(s1[k], s0[k]) for k in s0)}
    ints = [k for k in b0 if not b0[k].dtype.is_floating_point]
    if any(not torch.equal(b0[k], b1[k]) for k in ints) \
            or max(errs.values()) > PNP_TOL:
        raise AssertionError(f"{family} card vs CPU: {errs}")
    rec = {"trees": len(trees), "parent_flips": sum(flips)} \
        if family == "vctree" else {}
    return {**rec, "max_abs_err": errs, "tolerance": PNP_TOL}


def pnp_profile(fn):
    """device_profile of one call of a pnp step, cut to its totals (device
    ms, its busy share of the wall time under the tracer, device events)
    and its three longest kernels."""
    prof = device_profile(fn, 1, top_ops=0)
    return {**{k: prof[k] for k in (
        "wall_ms_per_call", "device_ms_per_call", "device_busy_share",
        "device_events_per_call")},
        "top_kernels": prof["top_kernels"][:3]}


def phase_pnp(data):
    """The plug-and-play families at full width (the JAX package's widths:
    hidden 256, pair 512, embeddings 100, float32; VG's 150 classes and 50
    relations in (15, 11, 24); 20 objects, 400 directed pairs an image,
    pooling over the 32x32x256 DETR map; batch 12; seeded weights) from
    seeded 1024^2 images through the live featurizer: per family
    fit_predictor for 3 steps (the augmented view dropped before the
    encode) and run_eval_pc_predictor over 2 batches without and with TDE,
    exactly one encode a batch and no pair-pool launch; the train step and
    the eval step (without and with TDE) from features by CUDA events,
    the host's issue time, peak memory and the device time of one call by
    torch.profiler; the card-vs-CPU check at reduced widths.  Then the CLI as a user runs it on the mini-OIv6:
    --dataset oiv6 eval beside --predictor vctree train, then --predictor
    vctree eval --tde."""
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    result = {"phase": "pnp", "card": bench.card_name(), "families": {}}
    rng = np.random.default_rng(71)
    train_b = list(image_batches(rng, 3, 12, 1024, with_aug=True))
    test_b = list(image_batches(rng, 2, 12, 1024, with_aug=False))
    with tempfile.TemporaryDirectory() as tmp:
        cfg = config_lib.derive(
            "vg", hierarchical_pred=True, run_mode="train",
            training={"batch_size": 12, "num_epoch": 1, "print_freq": 1,
                      "checkpoint_path": os.path.join(tmp, "ck")})
        featurize, _ = loop.load_detr_featurizer(
            cfg, device="cuda", generator=gen(), log_fn=lambda *a: None)
        fbatch = to_device(featurize(test_b[0]), torch.device("cuda"))
        for family in PNP_FAMILIES:
            lines = []
            reset_counts()
            t0 = time.perf_counter()
            predictor, state = pnp_engine.fit_predictor(
                cfg, family, lambda e: iter(train_b), None,
                featurize=featurize, device="cuda", log_fn=lines.append)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            counts = read_counts()
            want = expected(**{k: v * 3 for k, v in PER_ENCODE.items()})
            if counts != want:
                raise AssertionError(f"{family} fit launched {counts}, "
                                     f"expected {want}")
            steps = [ln for ln in lines if " batch " in ln]
            if len(steps) != 3 or "nan" in " ".join(steps):
                raise AssertionError(f"{family} fit printed {lines}")
            if not os.path.exists(pnp_engine.checkpoint_file(cfg, family,
                                                             0)):
                raise AssertionError(f"{family} fit wrote no checkpoint")
            evals = {}
            for tde in (False, True):
                reset_counts()
                t0 = time.perf_counter()
                res = pnp_engine.run_eval_pc_predictor(
                    cfg, predictor, iter(test_b), featurize=featurize,
                    tde=tde, device="cuda")
                secs = time.perf_counter() - t0
                counts = read_counts()
                want = expected(**{k: v * 2 for k, v in PER_ENCODE.items()})
                if counts != want:
                    raise AssertionError(f"{family} eval (tde={tde}) "
                                         f"launched {counts}, expected "
                                         f"{want}")
                if not res["num_targets"] or not all(
                        0 <= r <= 1 for r in res["recall"]):
                    raise AssertionError(f"{family} eval: {res}")
                evals["tde" if tde else "plain"] = {
                    "wall_s_per_batch": secs / 2, "recall": res["recall"],
                    "mean_recall": res["mean_recall"]}
            # the steps alone, from features on the card
            opt, tstate = pnp_train_parts(predictor, cfg)
            tstep = pnp_engine.make_pnp_train_step(predictor, cfg, opt,
                                                   device="cuda")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            train_ms, train_issue = cuda_ms(lambda: tstep(tstate, fbatch), 5,
                                            issue=True)
            peak = torch.cuda.max_memory_allocated() / 1e9
            step_ms = {"train_step_ms": train_ms,
                       "train_step_issue_ms": train_issue,
                       "train_host_issue_share": train_issue / train_ms,
                       "train_peak_mem_gb": peak,
                       "train_profile": pnp_profile(
                           lambda: tstep(tstate, fbatch))}
            step_ms["train_device_share"] = step_ms["train_profile"][
                "device_ms_per_call"] / train_ms
            for tde in (False, True):
                estep = pnp_engine.make_pnp_eval_step(predictor, cfg,
                                                      tde=tde, device="cuda")
                ms, issue = cuda_ms(lambda: estep(fbatch), 5, issue=True)
                tag = "eval_tde" if tde else "eval"
                step_ms.update({f"{tag}_step_ms": ms,
                                f"{tag}_step_issue_ms": issue,
                                f"{tag}_host_issue_share": issue / ms,
                                f"{tag}_profile": pnp_profile(
                                    lambda: estep(fbatch))})
                step_ms[f"{tag}_device_share"] = step_ms[f"{tag}_profile"][
                    "device_ms_per_call"] / ms
            result["families"][family] = {
                "fit_s_per_step": fit_s / 3, "eval": evals, **step_ms,
                "last_step_line": steps[-1],
                "card_vs_cpu": pnp_card_vs_cpu(family, gen())}
            del predictor, state, tstep, tstate, opt
        del fbatch

        # the CLI on the mini-OIv6: the flagship's eval beside a VCTree
        # predictor's training, then the predictor's eval with TDE
        yaml_path = os.path.join(tmp, "cli.yaml")
        with open(yaml_path, "w") as f:
            json.dump({"data": data, "training": {
                "batch_size": 12, "num_epoch": 1, "print_freq": 1,
                "test_epoch": 0, "checkpoint_path": os.path.join(tmp, "cli"),
                "result_path": os.path.join(tmp, "cli_res")}}, f)
        t0 = time.perf_counter()
        procs = {name: run_cli(root, yaml_path, "--dataset", "oiv6",
                               "--eval_mode", "pc", *args)
                 for name, args in (
                     ("oiv6_eval", ("--run_mode", "eval")),
                     ("vctree_train", ("--run_mode", "train",
                                       "--predictor", "vctree")))}
        outs = {name: finish_cli(name, p) for name, p in procs.items()}
        pair_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs["vctree_eval_tde"] = finish_cli("vctree_eval_tde", run_cli(
            root, yaml_path, "--dataset", "oiv6", "--eval_mode", "pc",
            "--run_mode", "eval", "--predictor", "vctree", "--tde"))
        tde_s = time.perf_counter() - t0
        oiv6_res = json.loads(outs["oiv6_eval"].strip().splitlines()[-1])
        tde_res = json.loads(
            outs["vctree_eval_tde"].strip().splitlines()[-1])
        if "wmap_rel" not in oiv6_res or not tde_res["num_targets"]:
            raise AssertionError(f"CLI results {oiv6_res} {tde_res}")
        if "[pnp:vctree] TEST epoch 0" not in outs["vctree_train"] or \
                "Loaded predictor checkpoint" not in outs["vctree_eval_tde"]:
            raise AssertionError("the CLI chain lost its checkpoint")
        result["cli"] = {"oiv6_eval_and_vctree_train_s": pair_s,
                         "vctree_eval_tde_s": tde_s,
                         "oiv6_eval": {k: oiv6_res[k] for k in (
                             "recall", "wmap_rel", "wmap_phrase")},
                         "vctree_tde_recall": tde_res["recall"]}
    emit(result)


# phase contention: how long the kernels run beside the other process, and
# the side of that process's bf16 products.  The two blocks of a K3/K4
# cluster drift apart when the card switches processes mid-kernel; before
# every ring release became one arrival a warp, that overflowed a barrier
# and faulted K4 within a few seconds of such a run (5 s: about 150
# cycles of the eight launches).
CONTENTION_S = 5.0
CONTENTION_SIDE = 8192


def contend_main(seconds):
    """The other process of phase contention: bf16 products on the card
    for `seconds`; prints "ready" after the first one."""
    a = torch.randn(CONTENTION_SIDE, CONTENTION_SIDE, device="cuda",
                    dtype=torch.bfloat16)
    a @ a
    torch.cuda.synchronize()
    print("ready", flush=True)
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            a @ a
        torch.cuda.synchronize()
        n += 10
    print(json.dumps({"products": n}), flush=True)


def phase_contention():
    """K4 and K3 at the trunk's shapes under time-slicing with a second
    process: the outputs of back-to-back launches against the same launches
    made alone."""
    dev = torch.device("cuda")
    disable_tf32()
    gen = torch.Generator(device=dev).manual_seed(5)
    cpu_gen = torch.Generator().manual_seed(6)
    b = 12
    calls = []
    for label, h, w, cin, m in K4_CASES:
        calls.append((label, bottleneck.bottleneck_s2_kernel, cin, m, 2,
                      True, h, w))
    for label, h, w, cin, m, proj, _ in K3_CASES:
        calls.append((label, bottleneck.bottleneck_kernel, cin, m, 1, proj,
                      h, w))
    work = []
    for label, fn, cin, m, stride, proj, h, w in calls:
        blk = resnet_fused.prepare_block(
            random_bottleneck(cin, m, stride, proj, cpu_gen, dev), stride,
            torch.bfloat16)
        x = torch.randn((b, h, w, cin), device=dev,
                        generator=gen).to(torch.bfloat16)
        work.append((label, fn, x, blk.args()))
    refs = []
    for _, fn, x, args in work:
        refs.append(fn(x, *args))
        torch.cuda.synchronize()
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--contend",
         str(CONTENTION_S + 60)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        if proc.stdout.readline().strip() != "ready":
            raise AssertionError("the contending process did not start")
        cycles = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < CONTENTION_S:
            outs = [fn(x, *args) for _, fn, x, args in work]
            torch.cuda.synchronize()
            for (label, *_), got, want in zip(work, outs, refs):
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"{label} under contention differs from its launch "
                        f"alone by {(got.float() - want.float()).abs().max()}")
            cycles += 1
        secs = time.perf_counter() - t0
        beside = proc.poll() is None
    finally:
        proc.kill()
        proc.communicate()
    if not beside:
        raise AssertionError("the contending process ended before the check")
    emit({"phase": "contention", "card": bench.card_name(),
          "seconds": secs, "cycles": cycles,
          "launches": {"bottleneck_s2": cycles * len(K4_CASES),
                       "bottleneck": cycles * len(K3_CASES)},
          "cases": [label for label, *_ in work]})


# phase mesh: train steps per path, the world-size-2 run's processes and its
# limit, and the rule of the world-2 run's first update against one
# process's two-shard update: |got - want| <= MESH_UPDATE_TOL * max |want|
# over the update (new weights - old); under deterministic algorithms both
# sum the same bf16 gradients in the same order, and the rule leaves room
# for one bf16 rounding (2^-8 relative) of a gradient element
MESH_STEPS = 3
MESH_WORLD = 2
MESH_TIMEOUT_S = 600
MESH_UPDATE_TOL = 2 ** -7


@contextlib.contextmanager
def deterministic():
    """cuDNN's and PyTorch's deterministic algorithms (index_put and
    index_add_ without atomics), so that two runs of one step can be held
    bit for bit; restored on exit."""
    was = (torch.backends.cudnn.deterministic,
           torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was[0]
        torch.use_deterministic_algorithms(was[1], warn_only=was[2])


def eval_batch(cfg):
    """A batch like bench.py's, from another seed, without the augmented
    view."""
    return {k: v for k, v in bench.bench_batch(cfg, 1, "cuda").items()
            if k != "features_aug"}


def mesh_world1(mesh, tmp):
    """World size 1 over NCCL at bench.py's configuration: the mesh train
    step against the single-device step, bit for bit over MESH_STEPS steps
    (the all-reduce of one rank is the identity, rank 0 draws the
    single-device dropout streams), the mesh eval step against the
    unsharded one, both step times by CUDA events, the launches; then
    fit(mesh=, featurize=) from seeded 1024^2 images with fused_backbone
    auto (the trunk and encoder kernels)."""
    cfg, model_a, step_a, state_a, batch = bench.setup(seed=0, device="cuda")
    _, model_b, step_b, state_b, _ = bench.setup(seed=0, mesh=mesh)
    launches = expected()
    with deterministic():
        for i in range(MESH_STEPS):
            state_a, met_a = step_a(state_a, batch)
            reset_counts()
            state_b, met_b = step_b(state_b, mesh_lib.shard_batch(mesh, batch))
            torch.cuda.synchronize()
            launches = {k: launches[k] + v for k, v in read_counts().items()}
            met_a = {k: float(v) for k, v in met_a.items()}
            met_b = {k: float(v) for k, v in met_b.items()}
            if met_a != met_b or not all(np.isfinite(list(met_a.values()))):
                raise AssertionError(f"mesh step {i}: metrics {met_b} vs the "
                                     f"single-device step's {met_a}")
            differ = [k for k, p in model_a.named_parameters()
                      if not torch.equal(p, model_b.get_parameter(k))]
            if differ:
                raise AssertionError(f"mesh step {i}: parameters {differ} "
                                     f"differ from the single-device step's")
        want = expected(pair_pool_idx=2 * MESH_STEPS,
                        pair_pool_bwd=2 * MESH_STEPS)
        if launches != want:
            raise AssertionError(f"mesh train steps launched {launches}, "
                                 f"expected {want}")
        ebatch = eval_batch(cfg)
        estep_a = engine.make_eval_step(model_a, cfg, device="cuda")
        estep_b = engine.make_eval_step(model_b, cfg, mesh=mesh)
        out_a = estep_a(ebatch)
        reset_counts()
        out_b = estep_b(mesh_lib.shard_batch(mesh, ebatch))
        torch.cuda.synchronize()
        eval_launches = read_counts()
        differ = [k for k, v in out_a.items() if not torch.equal(v, out_b[k])]
        if differ or eval_launches != expected(pair_pool=1):
            raise AssertionError(f"mesh eval step: {differ} differ, "
                                 f"launches {eval_launches}")

    # step times, the default (non-deterministic) algorithms, in turns
    def timed_steps(step, state, b):
        def one():
            nonlocal state
            state, _ = step(state, b)
        return cuda_ms(one, 5)

    local = mesh_lib.shard_batch(mesh, batch)
    times = {"single": [], "mesh": []}
    for _ in range(2):
        times["single"].append(timed_steps(step_a, state_a, batch))
        times["mesh"].append(timed_steps(step_b, state_b, local))
    eval_ms = {"single": cuda_ms(lambda: estep_a(ebatch), 5),
               "mesh": cuda_ms(lambda: estep_b(
                   mesh_lib.shard_batch(mesh, ebatch)), 5)}
    del model_a, model_b, state_a, state_b, step_a, step_b, estep_a, estep_b
    del batch, local, ebatch, out_a, out_b
    torch.cuda.empty_cache()

    # fit(mesh=, featurize=): the fused trunk under auto at world size 1
    fcfg = bench.bench_config(num_epoch=1, print_freq=1, eval_freq=0,
                              checkpoint_path=os.path.join(tmp, "ck"),
                              result_path=os.path.join(tmp, "res"))
    featurize, detr = loop.load_detr_featurizer(
        fcfg, device="cuda", generator=torch.Generator().manual_seed(0),
        log_fn=lambda *a: None)
    if not (detr.fused_backbone and detr.flash_encoder):
        raise AssertionError("fused_backbone auto is off at world size 1")
    fmodel = make_relation_classifier(
        fcfg, device="cuda", generator=torch.Generator().manual_seed(1))
    steps, lines = 2, []
    reset_counts()
    t0 = time.perf_counter()
    loop.fit(fcfg, fmodel,
             lambda e: image_batches(np.random.default_rng(30 + e), steps,
                                     12, fcfg.model.image_size,
                                     with_aug=True),
             None, steps_per_epoch=steps,
             artifacts=load_vg_artifacts("datasets/artifacts"),
             featurize=featurize, log_fn=lines.append, mesh=mesh)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = read_counts()
    want = expected(**{k: v * steps for k, v in PER_ENCODE.items()},
                    pair_pool_idx=2 * steps, pair_pool_bwd=2 * steps)
    train_lines = [ln for ln in lines if ln.startswith("TRAIN")]
    if fit_launches != want or len(train_lines) != steps \
            or any("nan" in ln.lower() for ln in train_lines):
        raise AssertionError(f"fit(mesh=, featurize=) launched "
                             f"{fit_launches}, expected {want}; {lines}")
    del detr, fmodel, featurize
    torch.cuda.empty_cache()
    return {"backend": dist.get_backend(), "steps": MESH_STEPS,
            "bitwise_equal_steps": MESH_STEPS, "train_launches": launches,
            "eval_launches": eval_launches,
            "step_ms_single": times["single"], "step_ms_mesh": times["mesh"],
            "eval_ms": eval_ms, "fit_featurize_steps": steps,
            "fit_featurize_s": fit_s, "fit_featurize_launches": fit_launches}


def ranks_identical(mesh, params):
    """Whether every rank holds rank 0's bits of every tensor, and of a TP
    shard its data group's first rank's bits (broadcast and compared on
    each rank, then agreed over the group)."""
    same = True
    for p in params.values():
        buf = p.detach().clone()
        if tp_lib.is_shard(p):
            dist.broadcast(buf, src=mesh.model_index, group=mesh.data_group)
        else:
            dist.broadcast(buf, src=0)
        same = same and torch.equal(buf, p.detach())
    flag = torch.tensor([int(same)], device=mesh.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def mesh_reference_update(cfg, batch):
    """One process's data-parallel update on the card: the port's
    forward_pairs and losses (engine.train_losses) on each half of the
    batch at the shards' capacities with that rank's dropout streams, the
    mean of the two gradients, the optimizer.  Returns (weights before,
    after) by name."""
    _, model, _, state, _ = bench.setup(cfg, seed=0, device="cuda")
    before = {k: p.detach().clone() for k, p in state.params.items()}
    cap = engine.train_pair_capacity(cfg, MESH_WORLD)
    aug = engine.aug_pair_capacity(cfg, MESH_WORLD)
    weights_ = torch.as_tensor(class_weights("vg"), device="cuda")
    model.train()
    for rank in range(MESH_WORLD):
        half = mesh_lib.shard_batch(
            mesh_lib.Mesh(MESH_WORLD, 1, rank, torch.device("cuda")), batch)
        gens = engine.dropout_generators(cfg.training.seed, 0, "cuda", rank)
        total, _ = engine.train_losses(model, cfg, half, cap, aug, gens,
                                       weights_)
        total.backward()            # the second half's adds to the first's
    grads = {k: p.grad.div_(MESH_WORLD) for k, p in state.params.items()}
    bench.optimizer(cfg).update(grads, state.opt_state, state.params)
    after = {k: p.detach().clone() for k, p in state.params.items()}
    del model, state, grads
    torch.cuda.empty_cache()
    return before, after


def mesh_first_update(mesh, cfg, batch):
    """The first world-size-2 update without the clip against one
    process's two-shard update (rank 0 computes the reference): the clip
    by global norm would scale away an error in the averaged gradient's
    scale (a sum without the division, a double division).  Returns
    (max |error|, max |update|) on rank 0, else None."""
    cfg = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, grad_clip_norm=0.0))
    if mesh.rank == 0:
        before, want = mesh_reference_update(cfg, batch)
    _, model, step, state, _ = bench.setup(cfg, seed=0, mesh=mesh)
    state, met = step(state, mesh_lib.shard_batch(mesh, batch))
    if not all(np.isfinite(float(v)) for v in met.values()):
        raise AssertionError(f"non-finite metrics of the unclipped step "
                             f"{met}")
    got = None
    if mesh.rank == 0:
        got = (max(float((p - want[k]).abs().max())
                   for k, p in state.params.items()),
               max(float((want[k] - before[k]).abs().max()) for k in want))
    del model, step, state
    torch.cuda.empty_cache()
    return got


# phase mesh, the remaining entry points: SGDET and SGCLS over
# MESH_EVAL_BATCHES batches; the rule of the world-2 Motifs first update
# against one process's global-loss update: |got - want| <= PNP_UPDATE_TOL *
# max |want| over the update, taken at learning rate PNP_UPDATE_LR (the
# config's after it) without clip or weight decay, so that the update is
# minus the global gradient, far above the weights' rounding; both sum the
# same float32 per-image terms, in another order
MESH_EVAL_BATCHES = 2
PNP_UPDATE_TOL = 1e-4
PNP_UPDATE_LR = 1.0


def detect_config(batch_size=12):
    """Phase detect's configuration: VG width, bf16, batch 12."""
    return config_lib.derive("vg", hierarchical_pred=True, run_mode="eval",
                             eval_mode="sgd",
                             training={"batch_size": batch_size})


def sg_batches(cfg, seed):
    """MESH_EVAL_BATCHES synthetic full-VG-width batches, each with 12
    seeded 1000^2 canvases and their pixel masks (phase detect's)."""
    rng = np.random.default_rng(seed)
    b, n = cfg.training.batch_size, cfg.data.max_objects
    return [{**synthetic_batch(rng, batch_size=b, max_objects=n,
                               with_aug=False),
             **detection_canvases(rng, canvas_regions(b))}
            for _ in range(MESH_EVAL_BATCHES)]


def detected_targets(batches, detect_fn, seed=95):
    """The batches with their GT objects replaced by `detect_fn`'s
    detections of their canvases and a seeded relation on every directed
    pair of them, so that SGDET and SGCLS have targets that a random
    detector's boxes and labels match."""
    rng = np.random.default_rng(seed)
    out = []
    for b in batches:
        det = detect_fn(b)
        n = det["valid"].shape[1]
        pair = det["valid"][:, :, None] & det["valid"][:, None, :] \
            & ~np.eye(n, dtype=bool)
        rel = rng.integers(0, 50, pair.shape).astype(np.int32)
        out.append({**b, "boxes": det["boxes"].astype(np.float32),
                    "cats": det["cats"].astype(np.int32),
                    "valid": det["valid"], "rel": np.where(pair, rel, -1)})
    return out


def related_by_model(cfg, model, batches, artifacts, device):
    """detected_targets' `batches` with every detected pair that the
    overlap filter keeps related by `model`'s best geometric predicate on
    it in the unsharded eval step, and no other pair related: SGDET
    targets that the random weights' candidates hit, so that its recall
    is not 0 and a wrong step cannot match a right one by both being 0."""
    estep = engine.make_eval_step(model, cfg, device=device)
    ng = cfg.model.num_geometric
    out = []
    for b in batches:
        o = engines.to_numpy(estep({
            **b, "super_mh": artifacts.sub2super[b["cats"]].astype(
                np.float32)}))
        keep = o["pair_mask"] & o["iou_ok"]
        rel = np.full(b["rel"].shape, -1, np.int32)
        rel[o["pair_img"][keep], o["pair_sub"][keep], o["pair_obj"][keep]] \
            = o["relation"][keep, :ng].argmax(1)
        out.append({**b, "rel": rel})
    return out


def pnp_mesh_batch(seed):
    """A batch at phase pnp's widths from features (12 images, 20 objects,
    the 32x32x256 map) whose second half is cut to 2 valid objects an
    image: the halves hold different numbers of valid objects and
    connected pairs, so a mean of the halves' local losses is not the
    global loss."""
    b = synthetic_batch(np.random.default_rng(seed), batch_size=12,
                        max_objects=20, with_aug=False)
    valid = b["valid"].copy()
    valid[6:, 2:] = False
    pair = valid[:, :, None] & valid[:, None, :]
    b.update(valid=valid, cats=np.where(valid, b["cats"], 0),
             rel=np.where(pair, b["rel"], -1))
    return b


def pnp_mesh_parts(cfg, mesh=None, first_lr=None):
    """A seeded Motifs predictor at the JAX widths on the card, its train
    step (over `mesh`, else on one device) with fit_predictor's optimizer,
    or with `first_lr` for the first update (the config's learning rate
    after it) and no clip or weight decay; (predictor, state, step)."""
    p = pnp_engine.make_predictor(cfg, "motifs", device="cuda",
                                  log_fn=lambda *a: None)
    tc = cfg.training
    opt = engine.make_optimizer(tc.learning_rate, momentum=tc.momentum,
                                weight_decay=tc.weight_decay,
                                grad_clip_norm=bench.GRAD_CLIP_NORM) \
        if first_lr is None else engine.make_optimizer(
            lambda count: first_lr if count == 0 else tc.learning_rate,
            momentum=tc.momentum, weight_decay=0.0)
    step = pnp_engine.make_pnp_train_step(p, cfg, opt, mesh=mesh,
                                          device="cuda")
    return p, engine.init_train_state(p, opt), step


def differing_keys(got, want):
    """The keys of two dicts whose values differ in dtype, shape or any
    element, NaN equal to NaN (nested dicts key by key)."""
    bad = []
    for k in set(got) | set(want):
        a, b = got.get(k), want.get(k)
        if isinstance(b, dict) and isinstance(a, dict):
            bad += [f"{k}.{x}" for x in differing_keys(a, b)]
            continue
        if isinstance(b, torch.Tensor):
            a, b = a.cpu().numpy(), b.cpu().numpy()
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype != b.dtype or not np.array_equal(
                a, b, equal_nan=a.dtype.kind in "fc"):
            bad.append(k)
    return bad


def in_turns(single, sharded, iters=1):
    """Host-clock ms of single() and sharded() (each ending in a copy to
    the host or a synchronise) in turns single, sharded, sharded, single,
    `iters` calls each time after a warm-up."""
    def ms(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3 / iters

    single()
    sharded()
    order = (("single", single), ("mesh", sharded), ("mesh", sharded),
             ("single", single))
    out = {"single": [], "mesh": []}
    for name, fn in order:
        out[name].append(ms(fn))
    return out


def mesh_world1_paths(mesh):
    """World size 1 over NCCL, the remaining entry points, with
    fused_backbone auto (the trunk and encoder kernels run): the detector
    (load_detr(detection=True), seeded) through make_detr_detect_fn(mesh=)
    against the unsharded detect_fn, every field bit for bit, on 12 of
    phase detect's 1000^2 canvases; run_eval_sgd(mesh=) over batches
    sharded ahead (shard_eval_batch) and run_eval_sgc(mesh=) over
    MESH_EVAL_BATCHES batches whose GT objects are the detections
    (detected_targets) against the unsharded runs, result dicts equal; SceneGraphPredictor(mesh=) from 12 seeded 1024^2 images against
    the unsharded predictor, graphs equal; Motifs at phase pnp's widths:
    the eval step without and with TDE and 3 train steps over the mesh
    against the unsharded ones bit for bit.  The launches of each mesh
    path, and the host-clock times of each path beside its unsharded run
    in turns (the Motifs train step by CUDA events)."""
    cfg = detect_config()
    quiet = dict(log_fn=lambda *a: None)
    detr = loop.load_detr(cfg, device="cuda",
                          generator=torch.Generator().manual_seed(0),
                          detection=True, **quiet)
    if not (detr.fused_backbone and detr.flash_encoder):
        raise AssertionError("fused_backbone / flash_encoder auto off at "
                             "world size 1")
    model = make_relation_classifier(
        cfg, device="cuda", generator=torch.Generator().manual_seed(0))
    artifacts = load_vg_artifacts("datasets/artifacts")
    batches = sg_batches(cfg, 90)
    single = engines.make_detr_detect_fn(cfg, detr)
    sharded = engines.make_detr_detect_fn(cfg, detr, mesh=mesh)
    out, launches, ms = {}, {}, {}
    with deterministic():
        want = single(batches[0])
        reset_counts()
        got = sharded(batches[0])
        launches["detect"] = read_counts()
        bad = differing_keys(got, want)
        if bad or launches["detect"] != expected(**PER_DETECT):
            raise AssertionError(f"mesh detect_fn: fields {bad} differ, "
                                 f"launches {launches['detect']}")
        ms["detect"] = in_turns(lambda: single(batches[0]),
                                lambda: sharded(batches[0]))
        out["detections"] = int(want["valid"].sum())
        batches = detected_targets(batches, single)

        for mode, runner in (("sgd", engines.run_eval_sgd),
                             ("sgc", engines.run_eval_sgc)):
            want = runner(cfg, model, batches, single, artifacts=artifacts,
                          device="cuda")
            rows = [engines.shard_eval_batch(mesh, b) for b in batches] \
                if mode == "sgd" else batches
            reset_counts()
            got = runner(cfg, model, rows, sharded, artifacts=artifacts,
                         mesh=mesh)
            torch.cuda.synchronize()
            launches[mode] = read_counts()
            want_launches = expected(
                **{k: v * MESH_EVAL_BATCHES for k, v in PER_DETECT.items()},
                pair_pool=MESH_EVAL_BATCHES)
            bad = differing_keys(got, want)
            if bad or launches[mode] != want_launches \
                    or not want["num_targets"]:
                raise AssertionError(f"run_eval_{mode}(mesh=): {bad} differ "
                                     f"from the unsharded run, launches "
                                     f"{launches[mode]}")
            ms[mode] = in_turns(
                lambda: runner(cfg, model, batches, single,
                               artifacts=artifacts, device="cuda"),
                lambda: runner(cfg, model, rows, sharded,
                               artifacts=artifacts, mesh=mesh), iters=1)
            out[f"{mode}_recall"] = got["recall"]

        request = next(image_batches(np.random.default_rng(91), 1, 12,
                                     cfg.model.image_size, with_aug=False))
        pred_a = SceneGraphPredictor(cfg, model, detr_model=detr,
                                     device="cuda")
        pred_b = SceneGraphPredictor(cfg, model, detr_model=detr, mesh=mesh)
        want = pred_a.predict(request)
        reset_counts()
        got = pred_b.predict(request)
        launches["predict"] = read_counts()
        if got != want or not sum(map(len, want)) \
                or launches["predict"] != expected(**PER_ENCODE,
                                                   pair_pool=1):
            raise AssertionError(f"SceneGraphPredictor(mesh=) graphs differ "
                                 f"or launches {launches['predict']}")
        ms["predict"] = in_turns(lambda: pred_a.predict(request),
                                 lambda: pred_b.predict(request))
        out["predict_edges"] = sum(map(len, got))
        del detr, pred_a, pred_b, request, batches
        torch.cuda.empty_cache()

        pcfg = config_lib.derive("vg", hierarchical_pred=True,
                                 training={"batch_size": 12})
        pbatch = to_device(pnp_mesh_batch(92), torch.device("cuda"))
        p_a, state_a, step_a = pnp_mesh_parts(pcfg)
        p_b, state_b, step_b = pnp_mesh_parts(pcfg, mesh)
        for tde in (False, True):
            want = pnp_engine.make_pnp_eval_step(p_a, pcfg, tde=tde,
                                                 device="cuda")(pbatch)
            estep = pnp_engine.make_pnp_eval_step(p_b, pcfg, tde=tde,
                                                  mesh=mesh)
            reset_counts()
            got = estep(mesh_lib.shard_batch(mesh, pbatch))
            tag = "pnp_eval_tde" if tde else "pnp_eval"
            launches[tag] = read_counts()
            bad = differing_keys(got, want)
            if bad or launches[tag] != expected():
                raise AssertionError(f"{tag}(mesh=): {bad} differ, "
                                     f"launches {launches[tag]}")
        launches["pnp_train"] = expected()
        for i in range(MESH_STEPS):
            state_a, met_a = step_a(state_a, pbatch)
            reset_counts()
            state_b, met_b = step_b(state_b,
                                    mesh_lib.shard_batch(mesh, pbatch))
            launches["pnp_train"] = {
                k: n + read_counts()[k]
                for k, n in launches["pnp_train"].items()}
            met_a = {k: float(v) for k, v in met_a.items()}
            met_b = {k: float(v) for k, v in met_b.items()}
            differ = [k for k, q in p_a.named_parameters()
                      if not torch.equal(q, p_b.get_parameter(k))]
            if met_a != met_b or differ \
                    or not all(np.isfinite(list(met_a.values()))):
                raise AssertionError(f"pnp mesh step {i}: metrics {met_b} "
                                     f"vs {met_a}, parameters {differ}")
        if launches["pnp_train"] != expected():
            raise AssertionError(f"pnp steps launched {launches}")
    local = mesh_lib.shard_batch(mesh, pbatch)
    ms["pnp_train_cuda_events"] = {"single": [], "mesh": []}
    for name, step, state, b in (("single", step_a, state_a, pbatch),
                                 ("mesh", step_b, state_b, local),
                                 ("mesh", step_b, state_b, local),
                                 ("single", step_a, state_a, pbatch)):
        ms["pnp_train_cuda_events"][name].append(
            cuda_ms(lambda: step(state, b), 3))
    del p_a, p_b, state_a, state_b, step_a, step_b, model
    torch.cuda.empty_cache()
    return {"bitwise_equal": ["detect", "pnp_eval", "pnp_eval_tde",
                              f"pnp_train x{MESH_STEPS}"],
            "equal_results": ["sgd", "sgc", "predict"],
            "launches": launches, "ms_in_turns": ms, **out}


def mesh_rank_paths(mesh):
    """World size 2 over gloo on the one card, the remaining entry points
    (fused_backbone auto resolves off: the cuDNN trunk; the encoder
    kernels run): the detector on this rank's 6 canvases, gathered (rank
    0 holds the gathered detections against one process's detect_fn on
    rows 0-5 and 6-11 concatenated, bit for bit: each half is the per-rank
    batch, so the same algorithms run); run_eval_sgd(mesh=) over
    MESH_EVAL_BATCHES batches sharded ahead; Motifs: the first unclipped
    update against one process's global-loss update over all 12 images
    (rank 0 computes it, and beside it the mean of the two halves' own
    updates, which the rule must refuse), then MESH_STEPS steps with the
    ranks' parameters compared after each; host-clock times and the
    launches of each path."""
    cfg = detect_config()
    quiet = dict(log_fn=lambda *a: None)
    dev = mesh.device
    detr = loop.load_detr(cfg, device=dev,
                          generator=torch.Generator().manual_seed(0),
                          detection=True, **quiet)
    model = make_relation_classifier(
        cfg, device=dev, generator=torch.Generator().manual_seed(0))
    batches = sg_batches(cfg, 93)
    sharded = engines.make_detr_detect_fn(cfg, detr, mesh=mesh)
    res = {"detr_fused_backbone": detr.fused_backbone,
           "detr_flash_encoder": detr.flash_encoder}
    with deterministic():
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sharded(batches[0])
        res["detect_s"] = time.perf_counter() - t0
        res["detect_launches"] = read_counts()
        if mesh.rank == 0:
            single = engines.make_detr_detect_fn(cfg, detr)
            halves = [single(mesh_lib.shard_batch(
                mesh_lib.Mesh(MESH_WORLD, 1, r, dev),
                {k: batches[0][k] for k in engines.DETECT_KEYS}))
                for r in range(MESH_WORLD)]
            want = {k: np.concatenate([h[k] for h in halves])
                    for k in halves[0]}
            res["detect_fields_differ"] = differing_keys(got, want)
            res["detections"] = int(want["valid"].sum())
        artifacts = load_vg_artifacts("datasets/artifacts")
        batches = related_by_model(cfg, model,
                                   detected_targets(batches, sharded),
                                   artifacts, dev)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sgd = engines.run_eval_sgd(
            cfg, model, [engines.shard_eval_batch(mesh, b) for b in batches],
            sharded, artifacts=artifacts, mesh=mesh)
        torch.cuda.synchronize()
        res["sgd_s"] = time.perf_counter() - t0
        res["sgd_launches"] = read_counts()
        res["sgd_results"] = {k: np.asarray(sgd[k]).tolist() for k in (
            "recall", "mean_recall", "recall_zs", "num_targets")}
        if mesh.rank == 0:
            # the unsharded run over each batch's halves, the per-rank
            # batches (the same algorithms run; recall is per image)
            half = detect_config(cfg.training.batch_size // MESH_WORLD)
            rows = [mesh_lib.shard_batch(
                mesh_lib.Mesh(MESH_WORLD, 1, r, dev), b)
                for b in batches for r in range(MESH_WORLD)]
            res["sgd_differ_from_halves"] = differing_keys(
                sgd, engines.run_eval_sgd(half, model, rows, single,
                                          artifacts=artifacts, device=dev))
        del detr, model, batches, sharded
        torch.cuda.empty_cache()

        pcfg = config_lib.derive("vg", hierarchical_pred=True,
                                 training={"batch_size": 12})
        batch = to_device(pnp_mesh_batch(94), dev)
        if mesh.rank == 0:
            p, state, step = pnp_mesh_parts(pcfg, first_lr=PNP_UPDATE_LR)
            before = {k: q.detach().clone() for k, q in
                      p.named_parameters()}
            step(state, batch)
            want = {k: q.detach() - before[k] for k, q in
                    p.named_parameters()}
            ddp = {k: torch.zeros_like(v) for k, v in want.items()}
            for r in range(MESH_WORLD):
                p, state, step = pnp_mesh_parts(pcfg, first_lr=PNP_UPDATE_LR)
                step(state, mesh_lib.shard_batch(
                    mesh_lib.Mesh(MESH_WORLD, 1, r, dev), batch))
                for k, q in p.named_parameters():
                    ddp[k] += (q.detach() - before[k]) / MESH_WORLD
            del p, state, step
        p, state, step = pnp_mesh_parts(pcfg, mesh, first_lr=PNP_UPDATE_LR)
        local = mesh_lib.shard_batch(mesh, batch)
        reset_counts()
        step_s, same = [], []
        for i in range(MESH_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, local)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            if not all(np.isfinite(float(v)) for v in met.values()):
                raise AssertionError(f"non-finite pnp metrics {met}")
            if i == 0 and mesh.rank == 0:
                upd = {k: q.detach() - before[k] for k, q in
                       p.named_parameters()}
                res["pnp_first_update_max_abs"] = max(
                    float(v.abs().max()) for v in want.values())
                res["pnp_first_update_max_abs_err"] = max(
                    float((upd[k] - want[k]).abs().max()) for k in want)
                res["pnp_mean_of_local_losses_max_abs_err"] = max(
                    float((ddp[k] - want[k]).abs().max()) for k in want)
            same.append(ranks_identical(mesh, state.params))
        res.update(pnp_step_s=step_s, pnp_ranks_bitwise_identical=same,
                   pnp_launches=read_counts(),
                   pnp_loss_last=float(met["loss"]))
    del p, state, step
    torch.cuda.empty_cache()
    return res


def mesh_rank_main(rank, work):
    """One rank of phase mesh's world-size-2 run: gloo's CUDA path, both
    ranks on the one card, at bench.py's configuration (6 images a rank).
    Writes its result to <work>/rank<rank>.json."""
    result = {"rank": rank}
    mesh_lib.init_multihost(f"file://{work}/gloo.store", MESH_WORLD, rank,
                            device="cuda", backend="gloo")
    try:
        mesh = mesh_lib.make_mesh(device="cuda")
        cfg = bench.bench_config()
        result["fused_backbone_auto"] = detr_lib.resolve_detr_modes(
            cfg, mesh.device)[0]
        with deterministic():
            first = mesh_first_update(mesh, cfg,
                                      bench.bench_batch(cfg, 0, "cuda"))
            if first is not None:
                (result["first_update_max_abs_err"],
                 result["first_update_max_abs"]) = first
            _, model, step, state, batch = bench.setup(cfg, seed=0,
                                                       mesh=mesh)
            local = mesh_lib.shard_batch(mesh, batch)
            reset_counts()
            step_s, same = [], []
            for i in range(MESH_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, met = step(state, local)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                if not all(np.isfinite(float(v)) for v in met.values()):
                    raise AssertionError(f"non-finite metrics {met}")
                same.append(ranks_identical(mesh, state.params))
            result["train_launches"] = read_counts()
        result.update(step_s=step_s, ranks_bitwise_identical=same,
                      loss_last=float(met["loss"]))
        # the gradient all-reduce alone: the master weights' bytes through
        # gloo (device to host, the exchange, host to device)
        flat = torch.zeros(sum(p.numel() for p in state.params.values()),
                           device=mesh.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh_lib.all_mean_(mesh, flat)
        torch.cuda.synchronize()
        result["allreduce_s"] = time.perf_counter() - t0
        result["allreduce_bytes"] = flat.numel() * flat.element_size()
        del flat
        reset_counts()
        out = engine.make_eval_step(model, cfg, mesh=mesh)(
            mesh_lib.shard_batch(mesh, eval_batch(cfg)))
        torch.cuda.synchronize()
        result["eval_launches"] = read_counts()
        result["eval_pair_count"] = out["pair_count"].tolist()
        result["eval_finite"] = bool(torch.isfinite(
            out["relation"][out["pair_mask"]]).all())
        # the bfloat16 all-reduce through gloo's CUDA path
        bf_cfg = bench.bench_config(grad_allreduce_dtype="bfloat16")
        bf_step = engine.make_train_step(model, bf_cfg,
                                         bench.optimizer(bf_cfg),
                                         class_weights("vg"), mesh=mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, met = bf_step(state, local)
        torch.cuda.synchronize()
        result["bf16_allreduce"] = {
            "step_s": time.perf_counter() - t0,
            "loss": float(met["loss"]),
            "ranks_bitwise_identical": ranks_identical(mesh, state.params)}
        del model, step, state, bf_step, out
        torch.cuda.empty_cache()
        result["paths"] = mesh_rank_paths(mesh)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def nccl_duplicate_rank_main(rank, work):
    """One of two ranks that put NCCL on the same card: records whether
    the first collective raises (NCCL: "Duplicate GPU detected")."""
    mesh_lib.init_multihost(f"file://{work}/nccl_dup.store", MESH_WORLD,
                            rank, device="cuda")
    result = {"rank": rank, "raised": None}
    try:
        x = torch.ones(1, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
    except RuntimeError as e:             # dist.DistBackendError included
        result["raised"] = str(e)[:300]
    # written before the group is torn down, which may not return after
    # a failed NCCL communicator (the parent kills what is left)
    with open(os.path.join(work, f"nccl_dup{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.destroy_process_group()


def run_ranks(work, flag, timeout, world=MESH_WORLD):
    """`world` processes of this script with --<flag> (the rank's entry),
    their output in files under `work`; their exit codes and output,
    killing any left at `timeout`."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    logs = [os.path.join(work, f"{flag}{r}.log") for r in range(world)]
    codes, timed_out = run_processes(
        [[sys.executable, os.path.abspath(__file__), f"--{flag}", str(r),
          "--work", work] for r in range(world)], here, env, logs,
        timeout)
    outs = []
    for log in logs:
        with open(log) as f:
            outs.append(f.read())
    return codes, outs, timed_out


def check_world2_paths(ranks):
    """Phase mesh's rules for mesh_rank_paths' records of both ranks."""
    r0 = ranks[0]
    per_detect = {"ffn_ln": PER_DETECT["ffn_ln"],
                  "attention": PER_DETECT["attention"]}
    for rk in ranks:
        if rk["detr_fused_backbone"] or not rk["detr_flash_encoder"] \
                or rk["detect_launches"] != expected(**per_detect) \
                or rk["sgd_launches"] != expected(
                    **{k: v * MESH_EVAL_BATCHES
                       for k, v in per_detect.items()},
                    pair_pool=MESH_EVAL_BATCHES) \
                or rk["pnp_launches"] != expected() \
                or not all(rk["pnp_ranks_bitwise_identical"]) \
                or rk["sgd_results"] != r0["sgd_results"]:
            raise AssertionError(f"world-2 gloo paths: {rk}")
    if r0["detect_fields_differ"] or not r0["detections"]:
        raise AssertionError(f"world-2 detections differ from one "
                             f"process's two halves: {r0}")
    if r0["sgd_differ_from_halves"] \
            or not min(r0["sgd_results"]["recall"]) > 0:
        raise AssertionError(f"world-2 run_eval_sgd(mesh=) differs from "
                             f"one process's run over the two halves, or "
                             f"its recall is 0: {r0}")
    err, scale, ddp = (r0["pnp_first_update_max_abs_err"],
                       r0["pnp_first_update_max_abs"],
                       r0["pnp_mean_of_local_losses_max_abs_err"])
    if not (scale > 0 and err <= PNP_UPDATE_TOL * scale < ddp):
        raise AssertionError(
            f"world-2 Motifs first update off the one-process global-loss "
            f"update by {err} (max {scale}; the mean of the halves' local "
            f"losses by {ddp}, which the rule must refuse)")


def phase_mesh():
    """Data parallelism on the card: world size 1 over NCCL (mesh_world1),
    world size 2 over gloo's CUDA path with both ranks on the one card
    (mesh_rank_main), and whether NCCL takes two ranks on one card."""
    torch.cuda.empty_cache()
    result = {"phase": "mesh"}
    with tempfile.TemporaryDirectory() as tmp:
        mesh_lib.init_multihost(f"file://{tmp}/nccl1.store", 1, 0,
                                device="cuda")
        try:
            if dist.get_backend() != "nccl":
                raise AssertionError(f"world size 1 on {dist.get_backend()}")
            mesh = mesh_lib.make_mesh(device="cuda")
            result["world1_nccl"] = mesh_world1(mesh, tmp)
            result["world1_nccl_paths"] = mesh_world1_paths(mesh)
        finally:
            dist.destroy_process_group()

        t0 = time.perf_counter()
        codes, outs, timed_out = run_ranks(tmp, "mesh_rank", MESH_TIMEOUT_S)
        if any(codes) or timed_out:
            raise AssertionError(f"world-2 gloo run: exit codes {codes}, "
                                 f"timed out {timed_out}:\n"
                                 + "\n".join(o[-4000:] for o in outs))
        ranks = []
        for r in range(MESH_WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        per_step = {k: v * MESH_STEPS for k, v in
                    (("pair_pool_idx", 2), ("pair_pool_bwd", 2))}
        for rk in ranks:
            bf16 = rk["bf16_allreduce"]
            if not all(rk["ranks_bitwise_identical"]) \
                    or not bf16["ranks_bitwise_identical"] \
                    or not np.isfinite(bf16["loss"]) \
                    or rk["train_launches"] != expected(**per_step) \
                    or rk["eval_launches"] != expected(pair_pool=1) \
                    or not rk["eval_finite"] \
                    or len(rk["eval_pair_count"]) != MESH_WORLD \
                    or rk["fused_backbone_auto"]:
                raise AssertionError(f"world-2 gloo rank: {rk}")
        err, scale = (ranks[0]["first_update_max_abs_err"],
                      ranks[0]["first_update_max_abs"])
        if not (scale > 0 and err <= MESH_UPDATE_TOL * scale):
            raise AssertionError(f"world-2 first update off the one-process "
                                 f"two-shard update by {err} (max {scale})")
        check_world2_paths([rk["paths"] for rk in ranks])
        result["world2_gloo"] = {"wall_s": time.perf_counter() - t0,
                                 "update_tol": MESH_UPDATE_TOL,
                                 "pnp_update_tol": PNP_UPDATE_TOL,
                                 "ranks": ranks}

        codes, outs, timed_out = run_ranks(tmp, "nccl_duplicate", 120)
        dup = []
        for r in range(MESH_WORLD):
            path = os.path.join(tmp, f"nccl_dup{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    dup.append(json.load(f))
        result["nccl_two_ranks_one_card"] = {
            "exit_codes": codes, "timed_out": timed_out, "ranks": dup,
            "output_tail": [o[-600:] for o in outs]}
    emit(result)



# phase tp: a (1, 2) mesh of two gloo processes on the one card at full VG
# width, bench.py's configuration at the worst-case pair capacity (4560,
# the augmented view 1140).  Rules, decided before the first run: each
# parameter's first update (unclipped, bf16) within TP_UPDATE_TOL of its
# largest |update| from the one-process unsharded update (the split sums of
# fc2_h and of fc1's input gradient are rounded on another path); each float
# output of the eval step within TP_EVAL_TOL of its largest |value| from the
# unsharded step's, integer outputs equal; the replicated parameters of the
# two ranks equal to the bit after every step; each rank's peak memory
# below the unsharded process's
TP_STEPS = 3
TP_UPDATE_TOL = 2 ** -5
# the global-batch leg's float32 first update against the whole-batch step
TP_F32_TOL = 2 ** -10
# ... whose pair trunk runs in chunks of 1140 pairs on both sides: four
# float32 ranks at whole buffers do not fit on the one card together
TP_F32_CHUNK = 1140
TP_EVAL_TOL = 2 ** -5
TP_TIMEOUT_S = 600
TP_DRYRUN_WORLD = 4
# the global-batch leg's (data, model) mesh
TP_GLOBAL_MESH = (2, 2)


def tp_config():
    """bench.py's configuration at the default pair capacity."""
    return bench.bench_config(pair_capacity=0)


def tp_run(mesh=None, global_batch=False):
    """The sequence every side of phase tp runs, unsharded in this process
    (mesh None) or in a rank: the seeded model, the eval step on
    eval_batch (its outputs, launches; not in the global-batch leg, whose
    sharded eval step is the data-parallel one), one unclipped train step
    (the weights before it, unsharded, and after it, gathered on rank 0),
    then TP_STEPS clipped steps timed by the host clock (launches; after
    each, whether the replicas agree) and their peak memory over the
    memory allocated before the run.  `global_batch`: the train steps are
    make_train_step(global_batch=True)'s."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cfg = tp_config()
    dev = "cuda" if mesh is None else None
    _, model, step, state, batch = bench.setup(cfg, seed=0, device=dev,
                                               mesh=mesh)
    if global_batch:
        step = engine.make_train_step(model, cfg, bench.optimizer(cfg),
                                      class_weights("vg"), mesh=mesh,
                                      global_batch=True)
    if mesh is not None:
        batch = mesh_lib.shard_batch(mesh, batch)
    res = {}
    if not global_batch:
        ebatch = eval_batch(cfg)
        if mesh is not None:
            ebatch = mesh_lib.shard_batch(mesh, ebatch)
        estep = engine.make_eval_step(model, cfg, device=dev, mesh=mesh)
        reset_counts()
        out = estep(ebatch)
        torch.cuda.synchronize()
        res.update(eval_launches=read_counts(),
                   eval={k: v.cpu() for k, v in out.items()
                         if v is not None})
        del out, estep
    cfg0 = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, grad_clip_norm=0.0))
    step0 = engine.make_train_step(model, cfg0, bench.optimizer(cfg0),
                                   class_weights("vg"), device=dev,
                                   mesh=mesh, global_batch=global_batch)
    if mesh is None:
        res["before"] = {k: v.to("cpu", copy=True)
                         for k, v in model.state_dict().items()}
    state, met = step0(state, batch)
    res.update(after={k: v.to("cpu", copy=True) for k, v in
                      tp_lib.full_state_dict(model).items()},
               first_loss=float(met["loss"]))
    if mesh is not None and mesh.rank:
        del res["after"]
    # the peak over the clipped steps alone (not the gathers above)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    step_s, same = [], []
    for _ in range(TP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if not all(np.isfinite(float(v)) for v in met.values()):
            raise AssertionError(f"non-finite metrics {met}")
        if mesh is not None:
            same.append(ranks_identical(mesh, state.params))
    torch.cuda.synchronize()
    res.update(train_launches=read_counts(), step_s=step_s,
               ranks_bitwise_identical=same, loss_last=float(met["loss"]),
               peak_bytes=torch.cuda.max_memory_allocated() - base,
               sharded=tp_lib.is_shard(model.fc1.weight))
    if mesh is not None and not global_batch:
        # the fc1 input gradient's all-reduce alone: the main view's
        # (P, 65536) bf16 through gloo (device to host, the exchange, host
        # to device)
        g = torch.zeros(cfg.pair_capacity, model.fc1.weight.shape[1],
                        dtype=torch.bfloat16, device=mesh.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(g, group=mesh.model_group)
        torch.cuda.synchronize()
        res.update(fc1_grad_allreduce_s=time.perf_counter() - t0,
                   fc1_grad_allreduce_bytes=g.numel() * g.element_size())
        del g
    del model, step, step0, state
    torch.cuda.empty_cache()
    return res


def tp_rank_main(rank, work):
    """One rank of phase tp: gloo's CUDA path, both ranks on the one card,
    mesh (1, 2).  Each rank saves its run to <work>/tp_rank<rank>.pt."""
    mesh_lib.init_multihost(f"file://{work}/tp.store", 2, rank,
                            device="cuda", backend="gloo")
    try:
        mesh = mesh_lib.make_mesh(data=1, model=2, device="cuda")
        res = tp_run(mesh)
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(work, f"tp_rank{rank}.pt"))


def tp_global_rank_main(rank, work):
    """One rank of phase tp's global-batch leg: gloo's CUDA path, the four
    ranks on the one card, mesh TP_GLOBAL_MESH.  Each rank saves its run
    to <work>/tp_global_rank<rank>.pt."""
    data, model = TP_GLOBAL_MESH
    mesh_lib.init_multihost(f"file://{work}/tpg.store", data * model, rank,
                            device="cuda", backend="gloo")
    try:
        mesh = mesh_lib.make_mesh(data=data, model=model, device="cuda")
        res = tp_run(mesh, global_batch=True)
        res["f32"] = tp_first_update(mesh, compute_dtype="float32",
                                     chunk_size=TP_F32_CHUNK)
    finally:
        dist.destroy_process_group()
    torch.save(res, os.path.join(work, f"tp_global_rank{rank}.pt"))


def per_shard_image_stage(model, shards):
    """Makes the model run its per-image stage (object_streams_from_image:
    conv1 and conv2 of each object's map) on `shards` equal blocks of a
    batch's images, as the data shards of a mesh run it, and concatenate
    the blocks' streams.  The same function; but the convolutions' bf16
    roundings can follow the batch they run at (cuDNN chooses its
    algorithms by the shapes)."""
    whole = model.object_streams_from_image

    def blocks(features, depth, masks):
        n = features.shape[0] // shards
        outs = [whole(features[i * n:(i + 1) * n], depth[i * n:(i + 1) * n],
                      masks[i * n:(i + 1) * n]) for i in range(shards)]
        return tuple(torch.cat(x) for x in zip(*outs))

    model.object_streams_from_image = blocks


def tp_first_update(mesh=None, compute_dtype=None, image_shards=1,
                    chunk_size=0):
    """tp_run's unclipped first update alone, on the same weights and batch:
    unsharded in this process (mesh None; `image_shards` > 1 runs the
    per-image stage per data shard, per_shard_image_stage) or the
    global-batch step in a rank; `compute_dtype` overrides the model's;
    chunk_size > 0 runs the pair trunk in chunks (its dropout masks drawn
    a chunk of the global buffer at a time on every side).  Returns the weights after it (gathered, on rank 0 only), before it
    (unsharded) and the loss."""
    cfg = tp_config()
    cfg0 = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, grad_clip_norm=0.0))
    if compute_dtype is not None:
        cfg0 = dataclasses.replace(cfg0, model=dataclasses.replace(
            cfg0.model, compute_dtype=compute_dtype))
    dev = "cuda" if mesh is None else None
    _, model, _, state, batch = bench.setup(cfg0, seed=0, device=dev,
                                            mesh=mesh)
    if image_shards > 1:
        per_shard_image_stage(model, image_shards)
    res = {}
    if mesh is None:
        res["before"] = {k: v.to("cpu", copy=True)
                         for k, v in model.state_dict().items()}
    else:
        batch = mesh_lib.shard_batch(mesh, batch)
    step0 = engine.make_train_step(model, cfg0, bench.optimizer(cfg0),
                                   class_weights("vg"), device=dev,
                                   mesh=mesh, global_batch=mesh is not None,
                                   chunk_size=chunk_size)
    _, met = step0(state, batch)
    res.update(after={k: v.to("cpu", copy=True) for k, v in
                      tp_lib.full_state_dict(model).items()},
               first_loss=float(met["loss"]))
    if mesh is not None and mesh.rank:
        del res["after"]
    del model, step0, state, batch
    torch.cuda.empty_cache()
    return res


def tp_update_errors(ref, got):
    """Per parameter: max |got after - ref after| over max |ref update|."""
    out = {}
    for k, b in ref["before"].items():
        want = ref["after"][k].cuda()
        scale = float((want - b.cuda()).abs().max())
        err = float((got["after"][k].cuda() - want).abs().max())
        out[k] = (err, scale)
    return out


def tp_eval_errors(ref, got):
    """Per float output: max |got - ref| over max |ref|; the integer
    outputs that differ."""
    errs, differ = {}, []
    for k, w in ref["eval"].items():
        g = got["eval"][k]
        if g.shape != w.shape:
            differ.append(k)
        elif w.is_floating_point():
            live = ref["eval"]["pair_mask"]
            if w.dim() > 0 and w.shape[0] == live.shape[0]:
                w, g = w[live], g[live]
            errs[k] = (float((g.float() - w.float()).abs().max()),
                       float(w.float().abs().max()))
        elif not torch.equal(g, w):
            differ.append(k)
    return errs, differ


def tp_global_leg(ref, tmp):
    """Phase tp's global-batch leg: TP_GLOBAL_MESH as four processes of
    this script over gloo's CUDA path on the one card, each running
    tp_run(global_batch=True) on its rows of the unsharded run's batch,
    then its first update again in float32 (tp_first_update).  The bf16
    reference is the unsharded first update with the per-image stage run
    per data shard (tp_first_update(image_shards=2)): that stage run at
    the whole batch instead moves some bf16 first updates, the embeddings'
    most, by up to ~0.05 of their largest, with no collective involved
    (`image_stage_spread`, recorded beside the leg with its error against
    the whole-batch run).  In float32 (no TF32) the leg is held against
    the whole-batch step itself, where that rounding is far smaller (its
    split is recorded: the per-image stage's batch alone, and the leg
    against the per-shard float32 reference).
    Returns (the leg's record, the failures of its rules: every
    parameter's bf16 first update within TP_UPDATE_TOL of its largest
    update in the reference and its float32 one within TP_F32_TOL of the
    whole-batch float32 step's, the replicas bit-identical within each
    model and each data group after every step, 2 + 2 training-kernel
    launches a step per rank)."""
    data, model = TP_GLOBAL_MESH
    shard_ref = tp_first_update(image_shards=data)
    spread = tp_update_errors(ref, shard_ref)
    whole_f32 = tp_first_update(compute_dtype="float32",
                                chunk_size=TP_F32_CHUNK)
    shard_f32 = tp_first_update(compute_dtype="float32", image_shards=data,
                                chunk_size=TP_F32_CHUNK)
    t0 = time.perf_counter()
    codes, outs, timed_out = run_ranks(tmp, "tp_global_rank", TP_TIMEOUT_S,
                                       world=data * model)
    if any(codes) or timed_out:
        raise AssertionError(f"tp global ranks: exit codes {codes}, timed "
                             f"out {timed_out}:\n"
                             + "\n".join(o[-4000:] for o in outs))
    wall_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(tmp, f"tp_global_rank{r}.pt"),
                        weights_only=False) for r in range(data * model)]
    upd = tp_update_errors(shard_ref, ranks[0])
    ratio = {k: e / sc if sc > 0 else math.inf for k, (e, sc) in upd.items()}
    failures = [f"global first update of {k}: {upd[k][0]} off of "
                f"{upd[k][1]}" for k, r in ratio.items()
                if not r <= TP_UPDATE_TOL]
    upd32 = tp_update_errors(whole_f32, ranks[0]["f32"])
    ratio32 = {k: e / sc if sc > 0 else math.inf
               for k, (e, sc) in upd32.items()}
    failures += [f"global float32 first update of {k}: {upd32[k][0]} off "
                 f"of {upd32[k][1]}" for k, r in ratio32.items()
                 if not r <= TP_F32_TOL]

    def worst_ratio(errors):
        k = max(errors, key=lambda k: errors[k][0] / max(errors[k][1],
                                                         1e-30))
        return {"param": k, "ratio": errors[k][0] / max(errors[k][1], 1e-30)}
    want = expected(pair_pool_idx=2 * TP_STEPS, pair_pool_bwd=2 * TP_STEPS)
    for r, rk in enumerate(ranks):
        if not rk["sharded"] or not all(rk["ranks_bitwise_identical"]) \
                or rk["train_launches"] != want:
            failures.append(
                f"global rank {r}: sharded {rk['sharded']}, replicas "
                f"{rk['ranks_bitwise_identical']}, launches "
                f"{rk['train_launches']}")
    worst = max(ratio, key=ratio.get)
    return {"mesh": list(TP_GLOBAL_MESH), "ranks_wall_s": wall_s,
            "ranks": [{k: rk[k] for k in (
                "step_s", "peak_bytes", "loss_last", "first_loss",
                "train_launches", "ranks_bitwise_identical")}
                for rk in ranks],
            "unsharded_first_loss": ref["first_loss"],
            "image_shards_first_loss": shard_ref["first_loss"],
            "update_ratio": {k: round(v, 6) for k, v in ratio.items()},
            "worst_update": {"param": worst, "max_abs_err": upd[worst][0],
                             "max_abs_update": upd[worst][1]},
            "against_whole_batch_image_stage": worst_ratio(
                tp_update_errors(ref, ranks[0])),
            "image_stage_spread": worst_ratio(spread),
            "f32_first_loss": ranks[0]["f32"]["first_loss"],
            "f32_unsharded_first_loss": whole_f32["first_loss"],
            "f32_update_ratio": {k: float(f"{v:.6g}")
                                 for k, v in ratio32.items()},
            "f32_worst_update": worst_ratio(upd32),
            # the float32 error's split: the per-image stage's batch alone,
            # and the leg against the per-shard float32 reference
            "f32_image_stage_spread": worst_ratio(
                tp_update_errors(whole_f32, shard_f32)),
            "f32_against_image_shards": worst_ratio(
                tp_update_errors(shard_f32, ranks[0]["f32"]))}, failures


def phase_tp(info):
    """Tensor parallelism on the card (parallel/tp.py): the unsharded run
    in this process, then the (1, 2) mesh as two processes of this script
    over gloo's CUDA path on the one card (NCCL refuses two ranks on one
    card), the rules above; the global-batch leg at TP_GLOBAL_MESH as four
    processes (tp_global_leg); then the port's dryrun at world size
    TP_DRYRUN_WORLD over gloo on the card, its dp x tp leg at (2, 2) both
    the shard_map step and the global-batch step.  The phase's line is
    printed before any rule fails."""
    torch.cuda.empty_cache()
    result = {"phase": "tp", "card": info["nvidia_smi"],
              "capacity": engine.train_pair_capacity(tp_config()),
              "aug_capacity": engine.aug_pair_capacity(tp_config())}
    ref = tp_run()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        codes, outs, timed_out = run_ranks(tmp, "tp_rank", TP_TIMEOUT_S)
        if any(codes) or timed_out:
            raise AssertionError(f"tp ranks: exit codes {codes}, timed out "
                                 f"{timed_out}:\n"
                                 + "\n".join(o[-4000:] for o in outs))
        wall_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"tp_rank{r}.pt"),
                            weights_only=False) for r in range(2)]
    upd = tp_update_errors(ref, ranks[0])
    ratio = {k: e / sc if sc > 0 else math.inf for k, (e, sc) in upd.items()}
    failures = [f"first update of {k}: {upd[k][0]} off of {upd[k][1]}"
                for k, r in ratio.items() if not r <= TP_UPDATE_TOL]
    want_train = expected(pair_pool_idx=2 * TP_STEPS,
                          pair_pool_bwd=2 * TP_STEPS)
    eval_rel = []
    for r, rk in enumerate(ranks):
        errs, differ = tp_eval_errors(ref, rk)
        eval_rel.append({k: e / max(sc, 1e-30)
                         for k, (e, sc) in errs.items()})
        failures += [f"rank {r} eval {k}" for k in differ] + [
            f"rank {r} eval {k}: {e} of {eval_rel[-1][k]}"
            for k, e in eval_rel[-1].items() if not e <= TP_EVAL_TOL]
        if not rk["sharded"] or not all(rk["ranks_bitwise_identical"]) \
                or rk["train_launches"] != want_train \
                or rk["eval_launches"] != expected(pair_pool=1) \
                or not rk["peak_bytes"] < ref["peak_bytes"]:
            failures.append(
                f"rank {r}: sharded {rk['sharded']}, replicas "
                f"{rk['ranks_bitwise_identical']}, launches "
                f"{rk['train_launches']} / {rk['eval_launches']}, peak "
                f"{rk['peak_bytes']} against {ref['peak_bytes']}")
    worst = max(ratio, key=ratio.get)
    result.update(
        unsharded={"step_s": ref["step_s"], "peak_bytes": ref["peak_bytes"],
                   "loss_last": ref["loss_last"],
                   "first_loss": ref["first_loss"],
                   "launches": ref["train_launches"]},
        ranks=[{k: rk[k] for k in (
            "step_s", "peak_bytes", "loss_last", "first_loss",
            "train_launches", "eval_launches", "ranks_bitwise_identical",
            "fc1_grad_allreduce_s", "fc1_grad_allreduce_bytes")}
            for rk in ranks],
        peak_saving_bytes=[ref["peak_bytes"] - rk["peak_bytes"]
                           for rk in ranks],
        update_tol=TP_UPDATE_TOL, eval_tol=TP_EVAL_TOL,
        update_ratio={k: round(v, 6) for k, v in ratio.items()},
        worst_update={"param": worst, "max_abs_err": upd[worst][0],
                      "max_abs_update": upd[worst][1]},
        eval_rel_err=eval_rel[0], ranks_wall_s=wall_s)
    del ranks
    with tempfile.TemporaryDirectory() as tmp:
        result["global_batch"], fails = tp_global_leg(ref, tmp)
    failures += fails
    del ref
    if not failures:
        # the port's dryrun at world size 4: both legs over gloo on the
        # card
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m",
             "scene_graph_commonsense_torch.tools.dryrun_multichip", "--n",
             str(TP_DRYRUN_WORLD), "--device", "cuda", "--backend", "gloo"],
            capture_output=True, text=True, timeout=TP_TIMEOUT_S,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        # two dp x tp lines: the shard_map step's, the global batch's
        tp_lines = [ln for ln in proc.stdout.splitlines() if "dp x tp" in ln]
        if proc.returncode or len(tp_lines) != 2 \
                or any("nan" in ln for ln in tp_lines):
            failures.append(f"dryrun_multichip({TP_DRYRUN_WORLD}): "
                            f"{proc.returncode}\n{proc.stdout[-2000:]}"
                            f"\n{proc.stderr[-4000:]}")
        result["dryrun"] = {"wall_s": time.perf_counter() - t0,
                            "lines": proc.stdout.strip().splitlines()}
    emit(result)
    if failures:
        raise AssertionError("phase tp: " + "; ".join(failures))

def main():
    started = time.perf_counter()
    ap = argparse.ArgumentParser(description="chip smoke of the port")
    ap.add_argument(
        "--phases",
        default="kernel,slice,profile,train,featurize,detect,parity,"
                "real_data,offline,commonsense,oiv6,pnp,mesh,tp,"
                "contention")
    # the entries of phase mesh's rank processes
    ap.add_argument("--mesh_rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--nccl_duplicate", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--tp_rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--tp_global_rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--contend", type=float, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--work", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mesh_rank is not None:
        mesh_rank_main(args.mesh_rank, args.work)
        return 0
    if args.nccl_duplicate is not None:
        nccl_duplicate_rank_main(args.nccl_duplicate, args.work)
        return 0
    if args.tp_rank is not None:
        tp_rank_main(args.tp_rank, args.work)
        return 0
    if args.tp_global_rank is not None:
        tp_global_rank_main(args.tp_global_rank, args.work)
        return 0
    if args.contend is not None:
        contend_main(args.contend)
        return 0
    phases = set(args.phases.split(","))
    seconds = {}

    @contextlib.contextmanager
    def timed_phase(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            seconds[name] = round(time.perf_counter() - t0, 3)

    with timed_phase("device"):
        info = phase_device()
    with timed_phase("build"):
        phase_build()
    kernel = {}
    if "kernel" in phases:
        with timed_phase("kernel"):
            kernel.update(phase_kernel())
            kernel.update(phase_kernel_encoder(info["exp_per_s"]))
            kernel.update(phase_kernel_trunk())
    launches = {}
    if {"slice", "profile"} & phases:
        with timed_phase("slice,profile"):
            slice_launches, slice_state = phase_slice()
            launches["pair_pool"] = slice_launches["pair_pool"]
            if "profile" in phases:
                phase_profile(*slice_state)
            del slice_state
    if "train" in phases:
        with timed_phase("train"):
            train_launches = phase_train()
        launches["pair_pool_idx"] = train_launches["pair_pool_idx"]
        launches["pair_pool_bwd"] = train_launches["pair_pool_bwd"]
    if "featurize" in phases:
        with timed_phase("featurize"):
            launches.update(phase_featurize())
    if "detect" in phases:
        with timed_phase("detect"):
            phase_detect(info["exp_per_s"])
    if "parity" in phases:
        with timed_phase("parity"):
            phase_parity()
    for name, fn in (("real_data", phase_real_data),
                     ("offline", phase_offline),
                     ("commonsense", phase_commonsense)):
        if name in phases:
            with timed_phase(name):
                fn()
    if {"oiv6", "pnp"} & phases:
        with tempfile.TemporaryDirectory() as tmp:
            with timed_phase("mini_oiv6"):
                data = mini_oiv6(tmp)
            for name, fn in (("oiv6", phase_oiv6), ("pnp", phase_pnp)):
                if name in phases:
                    with timed_phase(name):
                        fn(data)
    if "mesh" in phases:
        with timed_phase("mesh"):
            phase_mesh()
    if "tp" in phases:
        with timed_phase("tp"):
            phase_tp(info)
    if "contention" in phases:
        with timed_phase("contention"):
            phase_contention()
    # the wall seconds of each phase, and of the run since main started
    emit({"phase": "seconds", "seconds": seconds,
          "total_s": round(time.perf_counter() - started, 3)})
    if len(kernel) != len(KERNELS) or len(launches) != len(KERNELS):
        return 0                                # a partial run: no summary
    rows = [{"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": launches[name],
             **{k: kernel[name][k] for k in (
                 "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "unfused_ms") if k in kernel[name]}}
            for name, (_, _, source, replaces) in KERNELS.items()]
    emit({"kernels": rows})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
