#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and eval paths on one CUDA card
and check them.

    python3 chip_smoke.py            # from the repository root

Phases, one JSON line each on stdout:
  device        the card, and its name and power limit from nvidia-smi;
  build         nvcc builds rec_attend_tpu_torch/csrc/glimpse.cu and the C++
                compiler csrc/hungarian.cc, both at once (seconds taken),
                and each kernel's registers a thread, spill bytes and
                static shared memory as nvcc -Xptxas -v reports them (the
                paste kernel and the three extract routes must be there);
  kernels       each hand-written kernel against its plain PyTorch version,
                at the serving path's shapes (CVPPP, b128, b8 and b1), at
                the synth3 chain's (KITTI 128x448, b32, extract D=13, paste
                D=1, 48x48 glimpse), at the synthcs chain's (256x512, b32,
                extract D=15, paste D=1), at Cityscapes' extract (256x512,
                b32, D=21), at paste's d_p of the KITTI size (extract D=1) and
                at a ragged shape (KITTI 128x448, D=13, 48x64 glimpse), with
                CUDA-event times; each extract names its route (the tiled
                kernel, the strip kernel and their output rows a block, or
                the general one), must take the route its shape is meant
                for, must give the same bits on a second launch and, on the
                tiled and strip routes, the plain version's strides;
  kernels_grad  each differentiable glimpse (ExtractPatch, PastePatch)
                against plain autograd through the einsums, every input
                gradient, at the CVPPP train shapes (b32), the ragged shape
                and the synth3 chain's shape (b32, D=13, 48x48, where
                paste's d_p takes the strip route); the kernels' backward
                uses (paste as extract's d_x, extract at D=1 as paste's d_p)
                and the filter-gradient einsums timed;
  serve         InstanceSegmenter serves the flagship CVPPP checkpoint (a
                checkout without it fails) to three requests of b=8, 32 and
                128 at the model's size and two of other sizes (b1 530x500,
                b8 300x400: input resize, masks upsampled back), counting
                kernel launches; the other sizes' requests are held against
                the CPU's through the same predict, the b32 forward against
                the plain-glimpse forward and a b2 forward against the CPU
                (beside them plain einsums that sum in another order against
                the plain forward: the float32 floor), a forward with the
                bf16 islands on must fail the same gates, and the b128
                forward is timed;
  train         the Trainer restores the flagship checkpoint with its Adam
                state and takes 5 steps at b32 from step 30000 and 2 from
                step 0 (the ground-truth segmentation mix on), counting
                launches per step; one step's loss, gradients and update are
                held against the plain-glimpse step (b32) at step 0 and at
                step 30000 (there by the loss and all gradients at once,
                beside the step's float32 noise floor) and against the CPU's
                (b2) at step 0, with the matchings of each pair reported
                and pinned where they differ; a step whose glimpse backward
                drops the filter gradients must fail the same gates;
  bf16          the flagship trained in bfloat16 (results/full_model_
                synth1024bf16-r5, dtype from its model_opt.yaml; a
                checkout without it fails): eval_split over the first 64
                images of its valid split at b32 (mask 0.40, score 0.50)
                with the kernels, the plain glimpses and the reordered
                plain ones, per-example SBD and counts held as in eval, the
                means printed beside the run's committed headline; the
                b128 forward in bf16 and in f32 on the same weights
                (CUDA events, not gated); each bf16 layer (convolutions,
                BatchNorm in train mode, LSTM, MLP) and its gradients card
                against CPU at the model's widths, with a control whose
                weights are 2 % off; the Trainer restores it with its
                Adam state and one step at step 0 is held kernel against
                plain (b32, limits from step_noise.py --bf16) and card
                against the float32 model's step in float64 on the CPU
                (b2, limits from step_noise.py --bf16-exact), each beside
                its floor and with the dropped-filter-gradient control,
                then 5 steps at b32 (84
                extracts, 42 as d_p, and 84 pastes a step), their ms,
                instances/s and peak memory beside the train phase's
                float32 ones; one step each of fixed_order and rnd_colour
                training from the flagship checkpoint held kernel against
                plain (b8) with the same control; a bf16 TrainingExperiment
                of 2 steps whose checkpoint is float32 and whose
                model_opt.yaml reads back dtype: bfloat16 (control: the
                float32 preset must differ from it);
  eval          eval_split over 64 synthetic 224x224 images with labels at
                b32, score and mask thresholds 0.40, with the kernels, the
                plain glimpses and plain einsums that sum in another order
                (the float32 floor), counting kernel launches (the extracts
                all on the tiled route); per example
                the kernels' SBD is held to the plain one within a limit
                set from that floor, and the counts must be equal; upsample
                on the card against the CPU; host seconds per batch of the
                postprocess chain and of the analyzers;
  chain         the KITTI-shaped chain of the synth3 checkpoints (a checkout
                without them fails): the fg model over 64 synthetic 128x448
                images with labels at b32, its maps packed to uint8 as the
                JAX H5 pack writes them (the same bytes quantised on the
                card as on the host), and eval_split of the full model on
                the packed channels, score threshold 0.15 and mask threshold
                0.40, with the kernels, the plain glimpses and reordered
                plain einsums, counting kernel launches (20 extracts, all on
                the strip route, and 40 pastes a b32 forward); the b32
                forward kernel against plain and the fg and full forwards
                card against CPU (b2) held to their limits, per-example SBD
                and counts as in eval; host seconds per batch of the fg
                forward, the pack, the full forward, the postprocess chain
                and the analyzers;
  chain_train   the synth3 chain's training at b8 on 16 synthetic 128x448
                images, each stage through its Trainer: the fg model
                restored from its checkpoint with its momentum trace, 5
                steps (cuDNN deterministic, so every run packs the same
                bytes); pack_fg of the trained fg model; the box model
                restored with its Adam state on the packed channels, 5
                steps; the KITTI full model started from the trained box's
                controller (load_pretrained), 2 steps, then restored from
                its checkpoint, 2 steps.  Per stage the step ms (CUDA
                events), the peak memory and the launches per step, which
                must be the path's (the box's 2T pastes; the full model's
                4T extracts on the strip route, 2T of them as d_p, and 4T
                pastes).  Before its steps, one step of each stage is
                gated: fg card against CPU (b2) beside its floor (the batch
                in the other order), with two controls that must fail (the
                momentum trace reset, the loss without the orientation CE);
                box kernel against plain (b8, beside the reordered-plain
                floor) and card against CPU (b2); full kernel against plain
                (b8, at step 0); the box and full controls drop the filter
                gradients;
  cs_chain      the Cityscapes-shaped synthcs chain (a checkout without its
                full checkpoint fails): the multiclass fg model (weights
                drawn from a seed: its checkpoint does not fit in the copy)
                over 32 synthetic 256x512 images of 2 classes at b32, its
                3-class pack, eval_split of the full model (score threshold
                0.50, mask threshold 0.40) with the kernels, the plain
                glimpses and reordered plain einsums (20 extracts, all on
                the strip route at x [32,256,512,15], and 40 pastes into
                [32,256,512,1] a forward), then with each of the three the
                full model's pack, the model-free Cityscapes eval on the
                card (mask threshold 0.6, regions of up to 100 pixels
                removed) and the instance AP of its submission, all also
                on a pack of the ground truth's maps (the seeded fg maps
                carry no classes), and the pixel eval of the fg bytes;
                held: per-example SBD and counts as in eval, the kernel
                run's AP, AP_50% and per-class AP to the plain run's (equal
                where the kernels give the plain bits at these shapes, else
                within twice the reordered-plain floor plus 1e-4; on the
                ground truth's maps person and rider swapped must fail), the
                pixel eval of labels made on the card to the host's, the
                b32 forward kernel against plain, fg maps and full forward
                card against CPU (b2; the packed fg channels reversed must
                fail), the pack's bytes the same on the host; host seconds
                per batch of every stage;
  pipeline      the synth pipeline (rec_attend_tpu_torch/pipelines/
                run_pipeline.py) as users launch it, at its paper widths
                (224x224, T=21, up to 9 instances, b8) with its step counts
                cut: 32 train and 8 valid examples, the box model's
                TrainingExperiment with the split on the card (6 steps), the
                full model's from the box's last checkpoint, host-fed with
                prefetching worker threads (6 steps), checkpoints every 2
                steps and valid and trainval passes every 3, then the eval
                command line on the valid split and a restore of the full
                run that takes 2 more steps; its results and logs go to a
                temporary folder in the checkout, removed after.  Gates,
                each with a control that must fail: ckpt-4 and ckpt-6 kept
                and ckpt-2 pruned (control: a listing with ckpt-2); the live
                parameters and optimizer state equal to ckpt-6's leaves bit
                for bit (control: ckpt-4's); the box's uint8 index gather
                from the split on the card equal to the host's batch of the
                same examples, bit for bit (control: the next examples);
                the full model's controller at step 0 equal to the box's
                last checkpoint (control: a fresh model); model_opt.yaml
                read back to the config (control: read as the other model's
                config); the trained full model's eval step (the loss of
                the valid and trainval passes) on a valid batch, kernel
                against plain, each soft metric within 1e-5 relative
                (control: glimpses with the window transposed); the eval
                CSVs' 8 rows (control: the command line with --max_batches
                0); the eval command line on the flagship checkpoint's
                valid split (its first 8 images, thresholds 0.40), per
                example SBD within 1e-3 and counts equal to eval_split with
                the plain glimpses (control: the plain eval of the test
                split); the restored run at step 6 with ckpt-6's state
                (control: ckpt-4's), and its next step held to the same
                step from the live state (control: the restored parameters
                with a fresh Adam state), then 2 finite steps; extract and
                paste launched in the full stage, the eval and (paste) the
                box stage (its patch of ones needs no d_p: the box launches
                no extract; control: the counts of a plain train step and
                eval step of the full model, which must be 0).
                Reported: step ms at the log cadence, the seconds of each
                valid pass, checkpoint write and the restore, peak memory;
                it runs after the phases above, so that they run as they
                did without it;
  synth3_pipeline
                the synth3 pipeline (run_pipeline --dataset synth3: fg ->
                pack -> box -> full -> eval) through run_pipeline.main at
                its paper widths (128x448, T=20, up to 12 instances, b8,
                the KITTI presets), its scale cut (synth3_stages patched):
                32 train and 8 valid examples, 6 + 6 + 6 steps, checkpoints
                every 2, valid and trainval every 3 with one batch, each
                split on the card; --stages fg,pack in this process,
                --stages box,full,eval in a child process (`chip_smoke.py
                synth3-child`, which counts its own launches; the packed
                maps cross in the pack files), then a --resume relaunch
                that skips fg, pack and box and takes 2 more full steps;
                all under a temporary folder in the checkout, removed
                after.  Gates, each with a
                control that must fail: the fg stage's split on the card
                against the host batch, bit for bit (control: the next
                examples); the child's box stage's d_in and y_in on the
                card against the pack file, bit for bit (control: the pack
                rolled by one example); launches per step of the stages'
                own runs, fg none, box 2T pastes, full 4T extracts on the
                strip route (2T as d_p) and 4T pastes (control: a plain
                step's, 0; of fg: a full step's);
                fg_metrics_valid.json against the same checkpoint's metrics
                on the CPU within 1e-3 (control: the CPU's of the test
                split); the relaunch's stages (full only), its start step
                (6) and end step (control: the prefix with the valid pack
                file gone, and a run without --resume); the eval command
                line at the six thresholds against eval_split with the
                plain glimpses, per example SBD within 1e-3 and counts
                equal, cuDNN deterministic, on the committed synth3 full
                checkpoint and a pack file of the valid split's ground
                truth maps (the six-step model finds no instance; control:
                the pack rolled by one example).  Reported: step ms at the
                log cadence per stage, the pack's seconds and bytes, the
                child process's seconds and peak resident memory, each
                stage run's seconds, peak device memory and launches.
Then the kernel table (each row with bound_share = bound_ms / ms), the
card's name and power limit, and as the last line
{"ok": true, "device": {...}}.  Any failure raises, and the exit code is not
0.  Without CUDA the script exits 1 before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT_DIR = os.path.join(REPO, 'results',
                              'full_model_synth-20260816104712')
# The KITTI-shaped chain: the fg model, then the full model on its packed
# predictions (RESULTS.md, the synth3 runs).
CHAIN_FG_DIR = os.path.join(REPO, 'results', 'fg_model_synth3-20260818a')
CHAIN_FULL_DIR = os.path.join(REPO, 'results', 'full_model_synth3-20260818a')
CHAIN_BOX_DIR = os.path.join(REPO, 'results', 'box_model_synth3-20260818a')
# The Cityscapes-shaped chain: the multiclass fg model, then the full model
# at 256x512 on its packed predictions (RESULTS.md, the synthcs runs).  The
# fg model's checkpoint (211 MB with its momentum trace) does not fit in a
# copy of 256 MiB beside the checkpoints of the other phases, so its weights
# here are drawn from CS_FG_SEED; the CPU tests run the committed one
# (tests/test_torch_cityscapes_chain.py).
CS_FULL_DIR = os.path.join(REPO, 'results', 'full_model_synthcs-20260818a')
CS_FG_SEED = 14
REPLACES = {
    'glimpse_extract': 'rec_attend_tpu/ops/pallas/glimpse.py:62',
    'glimpse_paste': 'rec_attend_tpu/ops/pallas/glimpse.py:75',
}
# Where the JAX package launches each kernel for a gradient.
BACKWARD_USES = {
    'glimpse_extract': 'd_p of _paste_bwd, rec_attend_tpu/ops/pallas/'
                       'glimpse.py:181',
    'glimpse_paste': 'd_x of _extract_bwd, rec_attend_tpu/ops/pallas/'
                     'glimpse.py:152',
}
SOURCE = 'rec_attend_tpu_torch/csrc/glimpse.cu'
# Published H100 SXM peaks: HBM3 bytes/s and float32 FLOP/s outside the
# tensor cores (NVIDIA's data sheet), for the least time of a kernel.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# Kernel against plain version, both float32: the sums run in other orders
# (the tolerance of tests/test_pallas_glimpse.py).
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# Whole forward, kernel glimpses against plain ones (and card against CPU).
# Float32 summation-order differences of 1e-7 pass through 21 canvas
# feedbacks and the steep output sigmoid sigmoid(e^2 * y - 5), whose logits
# reach 300: at mask edges a few pixels move by up to 0.2 while the rest
# agree.  So y_out is held by its mean and by the share of pixels that move
# more than 1e-3, s_out by its largest difference.  A forward with the bf16
# islands on (cfg.dtype='bfloat16') must fail these gates.
Y_OUT_MEAN_ATOL = 1e-5
Y_OUT_MOVED, Y_OUT_MOVED_SHARE = 1e-3, 1e-3
S_OUT_ATOL = 1e-4

# Gradients of one glimpse, Function against plain autograd: the tolerance
# of ROADMAP B, atol scaled by the gradient's largest magnitude (the filter
# gradients sum up to 48*48*4 products).
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4
# Whole train step, kernel glimpses against plain ones (and card against
# CPU), from the same parameters, Adam state, batch and draws:
#   loss: relative difference;
#   gradients (the main gate): per parameter leaf, the relative L2 error
#   ||g - g_ref|| / ||g_ref||; a conv bias that a train-mode BatchNorm
#   follows has gradient 0 in exact arithmetic (the BatchNorm subtracts the
#   batch mean), so there max |g| / max |g_w| of the layer's weight
#   gradient, on both sides, instead;
#   updated parameters: per leaf, the relative L2 error of the update
#   (new - old); for those biases, whose gradient is noise, the largest
#   update difference in units of lr (Adam moves an element whose gradient
#   is noise by up to about lr either way, so 2 lr at most).
#   The update's limit is ten times the gradient's: Adam divides each
#   element by the root of its second moment, which weighs most the
#   elements whose gradient is small against their history (measured on
#   the card: the update's error 1.8 times the gradient's at step 0).
# The steps compared run with cuDNN held to its deterministic algorithms,
# as the serving forwards do, and with the same Hungarian matchings: where
# a step's matchings differ from the reference's in any example, the gate
# holds the step taken with the reference's matching pinned.
# STEP_LIMITS hold at step 0, where the ground-truth segmentation mix fills
# the canvas, so no timestep sees another's predicted masks.  A step whose
# glimpse backward drops the filter gradients must fail them.
STEP_LIMITS = {'loss_rel_diff': 1e-4, 'grad_rel_l2_max': 1e-3,
               'zero_grad_share_max': 1e-4, 'update_rel_l2_max': 1e-2,
               'zero_update_in_lr_max': 2.0}
# From step 30000 on, both knobs are about 0 and the canvas carries the
# model's own masks through 21 feedbacks and the steep output sigmoid.
# There float32 summation-order differences of 1e-7 grow in the forward
# (y_out) and reach the gradients, with the matchings unchanged: two plain
# steps whose glimpse einsums only sum in other orders differed in the
# gradient of all leaves together by 0.005 to 0.050 relative L2, and in
# their worst leaf by 0.015 to 0.26, over five b32 batches (H100).  So the
# step there is held by the loss and by the relative L2 error of all
# gradients at once, at twice the largest of those floors; the control
# measured 0.95 to 0.99.  A limit set as a multiple of the floor of the
# same run would rest on one sample of a floor that spread tenfold over
# those batches (kernel against plain reached 3.7 times it).
OWN_CANVAS_LIMITS = {'loss_rel_diff': 1e-4, 'grad_rel_l2_all': 0.1}
# The gradient gates: the dropped-filter-gradient control must fail each
# of them that the limits name.
GRADIENT_GATES = ('grad_rel_l2_max', 'grad_rel_l2_all', 'grad_rel_l2_median')
TRAIN_BATCH = 32
TRAIN_CPU_BATCH = 2
# Requests of other sizes than the model's: CVPPP A1's image size at b1,
# and a b8 request of another size.
OTHER_SIZE_REQUESTS = ((1, 530, 500), (8, 300, 400))
# The eval path: the flagship's valid-split size and thresholds (the
# headline of count_calibration.json), at the JAX TrainConfig batch size.
EVAL_EXAMPLES, EVAL_BATCH, EVAL_THRESHOLD = 64, 32, 0.4
# Per example, kernel against plain: |delta SBD| <= twice the largest of
# the float32 floor (plain einsums that sum in another order against the
# plain forward, same run, same 64 examples) plus the CSVs' resolution,
# 1e-4; counts equal.
EVAL_SBD_FLOOR_FACTOR, EVAL_CSV_RESOLUTION = 2.0, 1e-4
# upsample on the card against the CPU: the tolerance the CPU tests hold
# it to against cv2.
UPSAMPLE_ATOL = 1e-6
# The chain: the synth3 valid split's size and generator knobs (64 of its
# 256 examples: seed 4, up to 12 objects), the JAX TrainConfig batch size,
# the headline's thresholds (count_calibration.json).
CHAIN_EXAMPLES, CHAIN_BATCH, CHAIN_MAX_OBJECTS = 64, 32, 12
CHAIN_MASK_THRESHOLD, CHAIN_SCORE_THRESHOLD = 0.4, 0.15
# The fg forward, card against CPU: its sigmoid and softmax maps, largest
# difference (the port against JAX on the CPU: 1.3e-6 and 3.7e-6).
FG_MAPS_ATOL = 1e-4
# The Cityscapes-shaped chain: the synthcs valid split's generator knobs
# (data/provider.py:42-53 with the model's data_opt.yaml: seed 4, up to 10
# objects of 2 classes, 256x512) at b32, one batch; the calibrated
# headline's thresholds (count_calibration.json); the pipeline's AP stage:
# mask threshold 0.6, regions of at most 100 pixels removed
# (pipelines/run_pipeline.py:642, cli/cityscapes_eval.py:111).
CS_EXAMPLES, CS_BATCH, CS_MAX_OBJECTS, CS_CLASSES = 32, 32, 10, 2
CS_MASK_THRESHOLD, CS_SCORE_THRESHOLD = 0.4, 0.5
CS_AP_THRESHOLD, CS_AP_REMOVE_TINY = 0.6, 100
# The AP gate where the kernels' patches are not the plain version's bits:
# kernel against plain within twice the reordered-plain floor plus this.
CS_AP_FLOOR_FACTOR, CS_AP_SLACK = 2.0, 1e-4
# The chain's training: b8, the batch of the JAX pipeline's synth3 run
# (pipelines/run_pipeline.py:283-375), over 16 synthetic 128x448 images (two
# batches, cycled); fg, box, full from the box and full from its checkpoint
# take these numbers of steps; the card-against-CPU gates run at b2.
CHAIN_TRAIN_BATCH, CHAIN_TRAIN_CPU_BATCH, CHAIN_TRAIN_EXAMPLES = 8, 2, 16
CHAIN_TRAIN_STEPS = (5, 5, 2, 2)
# The chain's gates, each limit set from the float32 floor that
# `step_noise.py --chain` measured over five b8 batches (one H100 80GB
# HBM3 at 700 W):
# - fg, card against CPU (b2), from ckpt-3000.  Its floor, the card's step
#   on the batch in the other order against the card's step, reached 0.0122
#   in the worst leaf's gradient (the BatchNorm beta and gamma of a deep
#   layer, whose gradient is a sum that nearly cancels), 0.0030 in all
#   gradients at once and 0.0107 in the worst leaf's update; card against
#   CPU reached 0.0122, 0.0031 and 0.0141.  The limits are twice the floor's
#   largest; the controls measured 1.02 and more in the gradients (no
#   orientation CE) and 0.72 and more in the update (the trace reset).
FG_STEP_LIMITS = {'loss_rel_diff': 1e-4, 'grad_rel_l2_max': 0.025,
                  'grad_rel_l2_all': 0.0062, 'zero_grad_share_max': 1e-4,
                  'update_rel_l2_max': 0.022, 'zero_update_in_lr_max': 2.0}
# - box, kernel against plain (b8) and card against CPU (b2), from
#   ckpt-12000: its canvas takes the ground truth, as at step 0, and the
#   floor (reordered plain against plain) stayed below 9e-7 in any leaf's
#   gradient and 3.2e-5 in any update; card against CPU reached 3.6e-4 and
#   3.5e-4.  STEP_LIMITS hold with room.
BOX_STEP_LIMITS = dict(STEP_LIMITS)
# - full at step 0 from the box's controller, kernel against plain (b8):
#   its attention nets are freshly initialised, and their BatchNorm leaves'
#   gradients are float32 noise of nearly constant activations.  The floor
#   reached 0.115 in the worst leaf's gradient, 0.0061 in all gradients at
#   once and 0.315 in the worst leaf's update (Adam's first step moves a
#   noise-level element by lr either way); kernel against plain reached
#   2.0e-6, 2.7e-7 and 3.8e-4.  The limits are twice the floor's largest;
#   the control (dropped filter gradients) measured 1.0 and more in the
#   worst leaf's gradient, 0.040 and more in all gradients and 1.39 and
#   more in the update.  Those leaves are few: the median leaf's gradient
#   error separates the two by far more.  Its floor reached 9.7e-4 (2.4e-5
#   to 1.3e-4 on the other four batches), kernel against plain 3.7e-7, the
#   control 0.82 and more; its limit is twice the floor's largest, and the
#   control must fail it too.
FULL_STEP_LIMITS = {'loss_rel_diff': 1e-4, 'grad_rel_l2_max': 0.23,
                    'grad_rel_l2_all': 0.0122, 'grad_rel_l2_median': 2e-3,
                    'zero_grad_share_max': 1e-4,
                    'update_rel_l2_max': 0.63, 'zero_update_in_lr_max': 2.0}
# The synth pipeline (rec_attend_tpu_torch/pipelines/run_pipeline.py) at
# its paper widths, 224x224, T=21, up to 9 instances, b8, its step counts
# cut: 32 train examples (8 valid), 6 box and 6 full steps, a checkpoint
# every 2 (ckpt-4 and ckpt-6 kept), valid and trainval passes every 3 (one
# batch), the loss and step time logged every step.
PIPELINE_EXAMPLES, PIPELINE_STEPS = 32, 6
PIPELINE_CKPT_STEPS, PIPELINE_EVAL_STEPS, PIPELINE_LOG_STEPS = 2, 3, 1
# The eval step's metrics that vary smoothly with the forward, held kernel
# against plain to EVAL_STEP_REL_LIMIT relative (kernel against plain read
# 0.0, reordered plain up to 1.8e-7, the transposed-window control 2.5e-4
# in box_loss, PR 15 run 5).
EVAL_STEP_METRICS = ('loss', 'box_loss', 'segm_loss', 'conf_loss',
                     'iou_soft', 'iou_soft_box', 'wt_cov_soft',
                     'unwt_cov_soft')
EVAL_STEP_REL_LIMIT = 1e-5
# The eval command line on the flagship's valid split against eval_split
# with the plain glimpses: per-example SBD within the CSVs' 4 decimals and
# float noise (the eval phase's kernel against plain read 0.0 over 64
# images, PR 15 run 3), counts equal.
PIPELINE_CLI_EXAMPLES, PIPELINE_CLI_SBD_LIMIT = 8, 1e-3
# A restored step against the same step from the live state: the same
# parameters, Adam state, batch and draws, cuDNN deterministic.
RESTORED_STEP_LIMITS = {'loss_rel_diff': 1e-6, 'grad_rel_l2_max': 1e-5,
                        'update_rel_l2_max': 1e-5}
# The synth3 pipeline (rec_attend_tpu_torch/pipelines/run_pipeline.py
# --dataset synth3) at its paper widths, 128x448, T=20, up to 12 instances,
# b8, its scale cut: 32 train examples (8 valid), 6 fg, 6 box and 6 full
# steps, checkpoints and passes on the synth pipeline's cadence, each split
# on the device; the --resume relaunch takes 2 more full steps.  The eval
# stage's thresholds are the JAX pipeline's (run_pipeline.py:366-371).
SYNTH3_EXAMPLES, SYNTH3_STEPS, SYNTH3_MORE_STEPS = 32, 6, 2
SYNTH3_THRESHOLDS = '0.2,0.3,0.4,0.5,0.6,0.7'
SYNTH3_CHILD_TIMEOUT = 600
# fg_metrics_valid.json on the card against the CPU's for the same
# checkpoint: the file holds 4 decimals, and the fg maps card against CPU
# agree to FG_MAPS_ATOL.
FG_METRICS = ('iou_soft', 'iou_hard', 'orientation_acc')
SYNTH3_METRICS_LIMIT = 1e-3
# The eval command line's gate runs one batch of this many valid images.
SYNTH3_CLI_EXAMPLES = 8

# The flagship trained in bfloat16 (RESULTS.md:156-166): the synth1024 run
# with ``dtype: bfloat16`` in its model_opt.yaml, and its headline
# (count_calibration.json: its 256-example valid split, mask threshold
# 0.40, score threshold 0.50).  Phase bf16 evaluates the first 64 of those
# examples, which the headline does not describe alone: its means are
# printed beside it, not gated.
BF16_DIR = os.path.join(REPO, 'results', 'full_model_synth1024bf16-r5')
BF16_HEADLINE = {'sbd': 0.8442, 'count_acc': 0.6875}
BF16_EVAL_EXAMPLES = 64
BF16_MASK_THRESHOLD, BF16_SCORE_THRESHOLD = 0.4, 0.5
BF16_TRAIN_STEPS = 5
# The bfloat16 step at step 0 (the ground truth fills the canvas), each
# limit twice the largest floor that `step_noise.py --bf16` measured over
# five b32 batches (one H100 80GB HBM3 at 700 W).  A float32
# difference of 1e-7 that crosses a bfloat16 rounding boundary moves an
# activation by 2^-8 of itself, so these floors stand far above float32's.
# - Kernel against plain (b32).  Its floor, plain einsums that sum in the
#   other order against plain, reached 6.0e-6 in the loss, 0.181 in the
#   worst leaf's gradient, 0.0676 in all gradients at once, 0.0312 in the
#   median leaf and 0.0277 in the worst leaf's update; kernel against plain
#   reached 0, 2.45e-3, 7.7e-4, 7.4e-4 and 8.0e-4.  The zero-gradient
#   biases and Adam's bound keep STEP_LIMITS' values (the floor's biases
#   read 2.0e-6).  The control measured 1.0, 0.957 and 0.795 and more in
#   the three gradient gates.
BF16_STEP_LIMITS = {'loss_rel_diff': 1.2e-5, 'grad_rel_l2_max': 0.37,
                    'grad_rel_l2_all': 0.14, 'grad_rel_l2_median': 0.063,
                    'zero_grad_share_max': 1e-4,
                    'update_rel_l2_max': 0.056, 'zero_update_in_lr_max': 2.0}
# - Card against float64 (b2, the first two examples of the b32 batch): the
#   card's step against the exact step's stand-in, the float32 model's
#   step in float64 on the CPU (``float64_step``).  Its floor is what two
#   other bfloat16 implementations read against the same step on the same
#   batch: the CPU's step (oneDNN's convolutions, plain glimpses) and the
#   card's with cuDNN off (PyTorch's own convolutions).  Each statistic of
#   BF16_FLOOR_GATES is held to BF16_FLOOR_FACTOR times the larger of the
#   two, computed in the run; the zero-gradient biases and Adam's bound
#   keep STEP_LIMITS' values.  The floor moves from batch to batch (all
#   gradients at once 0.203-1.21, the worst update 0.17-2.27 over five
#   batches), so no fixed limit fits them all; over those five the card
#   read at most 1.04 times the larger floor in each statistic, and on the
#   gated batch 0.95-1.03 (`step_noise.py --bf16`, one H100 80GB HBM3 at
#   700 W).  The control read 3.0-4.7 times it in the three
#   gradient statistics there.  A bfloat16 step lies 0.2 or more from the
#   exact one by its roundings alone, so this gate catches a card that
#   computes the step worse than other implementations do, not an error
#   of a few percent: BF16_LAYER_LIMIT holds each bfloat16 layer to that.
#   The CPU's bfloat16 step alone is no reference: on one batch of five
#   (seed 1001) the exact gradient is 20 times the others', and the CPU's
#   step read 1.15 from it in all gradients, the card's 0.20 (ROADMAP
#   C.12).
BF16_FLOOR_GATES = ('loss_rel_diff', 'grad_rel_l2_max', 'grad_rel_l2_all',
                    'grad_rel_l2_median', 'update_rel_l2_max')
BF16_FLOOR_FACTOR = 2.0
# The bfloat16 layers card against CPU at the flagship's widths (b2, or
# b32 for the LSTM and the MLP): each result and each gradient as a
# relative L2 error.  The card and the CPU sum in other orders, so a few
# bfloat16 values land one rounding step apart, which moves each by 2^-8
# to 2^-7 of itself: the limit, about 2^-9, lets a few through, not all.
# Float32 results carry those steps too where a bfloat16 value feeds them
# (the LSTM's state and weight gradients, which are bfloat16 products, as
# in JAX).  On one H100 80GB HBM3 at 700 W the largest read 3.64e-4 at b8
# (the LSTM's input gradient; the convolutions' 3.9e-5 and less, the
# MLP's 0) and 1.04e-4 at b2, and the control, every weight scaled by
# 1.02, read 8.6e-3 or more in each layer (`chip_smoke.py`).
BF16_LAYER_LIMIT = 2e-3
BF16_LAYER_CONTROL_SCALE = 1.02
# The full model's other training options, one step each at step 0 from
# the flagship checkpoint, kernel against plain at b8 (STEP_LIMITS, with
# the dropped-filter-gradient control).
OPTION_BATCH = 8


def emit(phase, **fields):
  print(json.dumps({'phase': phase, **fields}), flush=True)


def nvidia_smi_name_power():
  proc = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, check=True,
      timeout=60)
  return proc.stdout.strip().splitlines()[0]


def ms(torch, fn, iters=20, warmup=3, sleep=True):
  """Median time of one call of fn, in ms, from CUDA events.

  With sleep, the stream is given a few ms of sleep before each timed call,
  so that the host has enqueued the call before the device reaches it and
  the events time the device's work only.  Without it the stream is idle,
  and the host's launch overhead counts wherever the device waits for it."""
  for _ in range(warmup):
    fn()
  times = []
  for _ in range(iters):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if sleep:
      torch.cuda._sleep(5_000_000)
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  return statistics.median(times)


@contextlib.contextmanager
def deterministic_cudnn(torch):
  """cuDNN held to its deterministic algorithms (same result every call)
  inside the block."""
  saved = torch.backends.cudnn.deterministic
  torch.backends.cudnn.deterministic = True
  try:
    yield
  finally:
    torch.backends.cudnn.deterministic = saved


def forward_diff(got, want):
  """Differences of two forwards' outputs."""
  dy = (got['y_out'].float().cpu() - want['y_out'].float().cpu()).abs()
  ds = (got['s_out'].float().cpu() - want['s_out'].float().cpu()).abs()
  return {'y_out_mean': float(dy.mean()), 'y_out_max': float(dy.max()),
          'y_out_moved_share': float((dy > Y_OUT_MOVED).float().mean()),
          's_out_max': float(ds.max())}


def gate_failures(stats):
  """Names of the limits that the differences of forward_diff exceed."""
  limits = {'y_out_mean': Y_OUT_MEAN_ATOL,
            'y_out_moved_share': Y_OUT_MOVED_SHARE, 's_out_max': S_OUT_ATOL}
  return [k for k, limit in limits.items() if stats[k] > limit]


def forward_agreement(got, want):
  """Differences of two forwards' outputs; raises beyond the limits."""
  stats = forward_diff(got, want)
  if gate_failures(stats):
    raise AssertionError(f'forwards disagree: {stats}')
  return stats


def bound(nbytes, flops):
  """(least ms on the card, 'bytes' or 'operations')."""
  t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
  t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
  return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def extract_flops(b, h, w, d, fh, fw):
  """Operations of patch = f_y^T x f_x in its cheaper contraction order:
  over h first ([b,fh,w,d], then w) or over w first ([b,h,fw,d], then h)."""
  return 2 * b * min(fh * h * w * d + fh * w * fw * d,
                     h * w * fw * d + fh * h * fw * d)


def paste_flops(b, h, w, d, fh, fw):
  """Operations of out = f_y p f_x^T in its cheaper contraction order:
  over fh first ([b,h,fw,d], then fw) or over fw first ([b,fh,w,d],
  then fh)."""
  return 2 * b * min(h * fh * fw * d + h * w * fw * d,
                     fh * w * fw * d + h * fh * w * d)


def filters(torch, attention, b, h, w, fh, fw, gen, dev):
  """Filter banks as the model makes them: random boxes inside the image,
  tap variance from box size over glimpse size."""
  def bank(length, taps):
    ctr = torch.rand(b, generator=gen, device=dev) * length
    size = 8 + torch.rand(b, generator=gen, device=dev) * (length - 8)
    lg_var = torch.log(size / taps)
    return attention.get_gaussian_filter(ctr, size, lg_var, length, taps)
  return bank(h, fh), bank(w, fw)


def check_kernel(torch, gk, attention, name, b, h, w, d, fh, fw, gen, dev,
                 timed):
  """Compare one kernel with its plain version; time all three forms."""
  f_y, f_x = filters(torch, attention, b, h, w, fh, fw, gen, dev)
  if name == 'glimpse_extract':
    a = torch.rand((b, h, w, d), generator=gen, device=dev)
    kernel, plain = gk.glimpse_extract, gk.extract_patch_plain
    library = lambda: torch.einsum('bhf,bhwd,bwg->bfgd', f_y, a, f_x)
    nbytes = 4 * (b * h * w * d + b * h * fh + b * w * fw + b * fh * fw * d)
    flops = extract_flops(b, h, w, d, fh, fw)
  else:
    a = torch.rand((b, fh, fw, d), generator=gen, device=dev)
    kernel, plain = gk.glimpse_paste, gk.paste_patch_plain
    library = lambda: torch.einsum('bhf,bfgd,bwg->bhwd', f_y, a, f_x)
    nbytes = 4 * (b * fh * fw * d + b * h * fh + b * w * fw + b * h * w * d)
    flops = paste_flops(b, h, w, d, fh, fw)
  got = kernel(a, f_y, f_x)
  torch.cuda.synchronize()
  want = plain(a, f_y, f_x)
  err = float((got - want).abs().max())
  if not torch.allclose(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL):
    raise AssertionError(
        f'{name} {tuple(a.shape)} disagrees with its plain version: max abs '
        f'err {err}, max rel err '
        f'{float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())}')
  result = {'shape': [b, h, w, d, fh, fw], 'max_abs_err': err,
            'max_abs_value': float(want.abs().max())}
  if name == 'glimpse_extract':
    # The route taken; a second launch gives the same bits (no sum crosses
    # blocks, nothing is atomic); the tiled and strip routes write the plain
    # version's layout.
    route = result['route'] = gk.extract_route_of(a, f_y, f_x)
    again = kernel(a, f_y, f_x)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
      raise AssertionError(f'{name} {tuple(a.shape)} ({route}): two launches '
                           f'differ')
    result['strides'] = list(got.stride())
    if (route['kernel'] != 'extract_kernel_general'
        and got.stride() != want.stride()):
      raise AssertionError(f'{name} {tuple(a.shape)} ({route}): strides '
                           f'{got.stride()}, plain {want.stride()}')
  if timed:
    bound_ms, bound_by = bound(nbytes, flops)
    kernel_ms = ms(torch, lambda: kernel(a, f_y, f_x))
    result.update(
        kernel_ms=kernel_ms,
        plain_ms=ms(torch, lambda: plain(a, f_y, f_x)),
        library_ms=ms(torch, library),
        bound_ms=bound_ms, bound_by=bound_by,
        bound_share=bound_ms / kernel_ms, bytes=nbytes, flops=flops)
  return result


def check_kernel_grad(torch, gk, attention, name, b, h, w, d, fh, fw, gen,
                      dev, timed):
  """Every input gradient of one differentiable glimpse against plain
  autograd through the einsums; time the kernel's backward use and the
  filter-gradient einsums."""
  f_y, f_x = filters(torch, attention, b, h, w, fh, fw, gen, dev)
  if name == 'glimpse_extract':
    a = torch.rand((b, h, w, d), generator=gen, device=dev)
    g = torch.rand((b, fh, fw, d), generator=gen, device=dev)
    fn, plain = gk.glimpse_extract, attention.extract_patch
  else:
    a = torch.rand((b, fh, fw, d), generator=gen, device=dev)
    g = torch.rand((b, h, w, d), generator=gen, device=dev)
    fn, plain = gk.glimpse_paste, attention.paste_patch

  def grads(f):
    ins = [t.detach().clone().requires_grad_() for t in (a, f_y, f_x)]
    return torch.autograd.grad(f(*ins), ins, g)

  before = dict(gk.glimpse_extract.route_launches)
  got = grads(fn)
  torch.cuda.synchronize()
  want = grads(plain)
  result = {'shape': [b, h, w, d, fh, fw], 'extract_route_launches': {
      k: v - before[k] for k, v in gk.glimpse_extract.route_launches.items()
      if v != before[k]}}
  for key, x, y in zip(('d_operand', 'd_f_y', 'd_f_x'), got, want):
    err = float((x - y).abs().max())
    scale = max(1.0, float(y.abs().max()))
    if not torch.allclose(x, y, rtol=GRAD_RTOL, atol=GRAD_ATOL * scale):
      raise AssertionError(f'{name} {key} at {result["shape"]} disagrees '
                           f'with plain autograd: max abs err {err}, '
                           f'largest |grad| {scale}')
    result[key] = {'max_abs_err': err, 'max_abs_value': float(y.abs().max())}
  if not timed:
    return result
  # The kernel's backward use: extract's d_x = paste(g); paste's d_p =
  # extract(g).  Bytes: g, both filter banks, the result; operations: the
  # two contractions at the use's shapes.
  if name == 'glimpse_extract':
    use = lambda: gk._paste(g, f_y, f_x)
    use_plain = lambda: attention.paste_patch(g, f_y, f_x)
    use_library = lambda: torch.einsum('bhf,bfgd,bwg->bhwd', f_y, g, f_x)
    nbytes = 4 * (b * fh * fw * d + b * h * fh + b * w * fw + b * h * w * d)
    flops = paste_flops(b, h, w, d, fh, fw)
    use_kernel = 'glimpse_paste'

    def filter_grads():
      xg = torch.einsum('bhwd,bwg->bhgd', a, f_x)
      fyx = torch.einsum('bhf,bhwd->bfwd', f_y, a)
      return (torch.einsum('bfgd,bhgd->bhf', g, xg),
              torch.einsum('bfgd,bfwd->bwg', g, fyx))
  else:
    use = lambda: gk._extract(g, f_y, f_x)
    use_plain = lambda: attention.extract_patch(g, f_y, f_x)
    use_library = lambda: torch.einsum('bhf,bhwd,bwg->bfgd', f_y, g, f_x)
    nbytes = 4 * (b * h * w * d + b * h * fh + b * w * fw + b * fh * fw * d)
    flops = extract_flops(b, h, w, d, fh, fw)
    use_kernel = 'glimpse_extract'

    def filter_grads():
      pfx = torch.einsum('bfgd,bwg->bfwd', a, f_x)
      fyp = torch.einsum('bhf,bfgd->bhgd', f_y, a)
      return (torch.einsum('bhwd,bfwd->bhf', g, pfx),
              torch.einsum('bhwd,bhgd->bwg', g, fyp))
  bound_ms, bound_by = bound(nbytes, flops)
  ins = [t.detach().clone().requires_grad_() for t in (a, f_y, f_x)]
  out = fn(*ins)
  plain_ins = [t.detach().clone().requires_grad_() for t in (a, f_y, f_x)]
  plain_out = plain(*plain_ins)
  kernel_ms = ms(torch, use)
  result['backward_use'] = {
      'kernel': use_kernel, 'kernel_ms': kernel_ms,
      'plain_ms': ms(torch, use_plain), 'library_ms': ms(torch, use_library),
      'bound_ms': bound_ms, 'bound_by': bound_by,
      'bound_share': bound_ms / kernel_ms, 'bytes': nbytes, 'flops': flops}
  if use_kernel == 'glimpse_extract':
    result['backward_use']['route'] = gk.extract_route_of(g, f_y, f_x)
  result['filter_grad_einsums_ms'] = ms(torch, filter_grads)
  result['backward_ms'] = ms(torch, lambda: torch.autograd.grad(
      out, ins, g, retain_graph=True))
  result['plain_backward_ms'] = ms(torch, lambda: torch.autograd.grad(
      plain_out, plain_ins, g, retain_graph=True))
  return result


def zero_grad_leaves(model):
  """{bias name: weight name} of the conv layers that a BatchNorm follows
  (their bias gradient is 0 in exact arithmetic)."""
  return {f'{name[:-len(".bn")]}.b': f'{name[:-len(".bn")]}.w'
          for name, module in model.named_modules()
          if name.endswith('.bn') and module is not None}


def match_differences(got, want):
  """{matching: number of examples whose matching differs} of two steps'
  'match', 'match_box' (Hungarian) and 'grd_match' (greedy, [B,T,T]),
  those that both steps have."""
  return {k: int((got[k] != want[k]).flatten(1).any(1).sum())
          for k in ('match', 'match_box', 'grd_match')
          if k in got and k in want}


def step_diff(torch, model, got, want, lr):
  """Differences of two train steps from the same state, as one_step
  returns them.  Returns the statistics that STEP_LIMITS names ("_max" ones
  as [leaf, value]); besides them the relative L2 error of all gradients
  but the zero-gradient biases at once, the median leaf's, how many
  examples' matchings differ, and the forwards' differences (the full
  model's y_out and s_out, the box model's s_out)."""
  zero = zero_grad_leaves(model)
  loss, grads, old, new = got[:4]
  loss_ref, grads_ref, _, new_ref = want[:4]
  stats = {'loss': float(loss), 'loss_ref': float(loss_ref),
           'loss_rel_diff': abs(float(loss) - float(loss_ref))
           / max(abs(float(loss_ref)), 1e-30)}
  grad_rel, update_rel, zero_grad, zero_update = {}, {}, {}, {}

  def rel(x, y):
    return float((x - y).norm() / y.norm().clamp_min(1e-30))
  for k, g in grads.items():
    g_ref = grads_ref[k]
    if not (torch.isfinite(g).all() and torch.isfinite(new[k]).all()):
      raise AssertionError(f'non-finite gradient or parameter: {k}')
    if k in zero:
      w_ref = float(grads_ref[zero[k]].abs().max())
      zero_grad[k] = max(float(g.abs().max()),
                         float(g_ref.abs().max())) / max(w_ref, 1e-30)
      zero_update[k] = float((new[k] - new_ref[k]).abs().max()) / lr
    else:
      grad_rel[k] = rel(g, g_ref)
      update_rel[k] = rel(new[k] - old[k], new_ref[k] - old[k])
  worst = lambda d: max(d.items(), key=lambda kv: kv[1])
  live = [k for k in grads if k not in zero]
  stats.update(grad_rel_l2_max=worst(grad_rel),
               update_rel_l2_max=worst(update_rel),
               zero_grad_share_max=worst(zero_grad),
               zero_update_in_lr_max=worst(zero_update),
               grad_rel_l2_all=rel(torch.cat([grads[k].flatten()
                                              for k in live]),
                                   torch.cat([grads_ref[k].flatten()
                                              for k in live])),
               grad_rel_l2_median=statistics.median(grad_rel.values()),
               matches_differ=match_differences(got[4], want[4]))
  if {'y_out', 's_out'} <= want[4].keys():
    stats['forward'] = forward_diff(got[4], want[4])
  elif 's_out' in want[4]:
    stats['forward'] = {'s_out_max': float(
        (got[4]['s_out'].cpu() - want[4]['s_out'].cpu()).abs().max())}
  return stats


def step_gate_failures(stats, limits):
  """Names of the limits that step_diff's statistics exceed."""
  def value(v):
    return v[1] if isinstance(v, (list, tuple)) else v
  return [k for k, limit in limits.items() if value(stats[k]) > limit]


@contextlib.contextmanager
def hungarian_calls(matching, solve_fn):
  """Inside the block every Hungarian solve of the loss calls
  solve_fn(solve, weights), where solve is the host solver."""
  solve = matching.hungarian_lib.hungarian
  matching.hungarian_lib.hungarian = lambda w: solve_fn(solve, w)
  try:
    yield
  finally:
    matching.hungarian_lib.hungarian = solve


def one_step(torch, ts, matching, model, opt_state, batch, draws, step,
             glimpse, pinned=None):
  """One train step of any model on copies of model and opt_state: (loss,
  grads, old params, new params, matches).  matches holds, where the model
  has them, the step's Hungarian matchings 'match' and 'match_box', its
  greedy matches 'grd_match', the host solver's answer 'solved', and the
  forward's 'y_out' and 's_out'.  With pinned (another step's 'solved'),
  the solve returns that answer instead of solving."""
  model = copy.deepcopy(model)
  opt_state = copy.deepcopy(opt_state)
  old = {k: v.detach().clone() for k, v in model.named_parameters()}
  solved = []

  def solve_fn(solve, w):
    solved.append(solve(w) if pinned is None else pinned)
    return solved[-1]
  with hungarian_calls(matching, solve_fn):
    loss, aux, grads = ts.loss_and_grads(model, batch, draws, step, glimpse)
  ts.apply_updates(model, opt_state, grads, aux['new_bn'])
  new = {k: v.detach().clone() for k, v in model.named_parameters()}
  # The full model solves one Hungarian matching a step (with fixed_order
  # that of its masks alone), the box model one (none with fixed_order),
  # the fg model none.
  want = 1 if 'match' in aux else int('match_box' in aux
                                      and not model.cfg.fixed_order)
  if len(solved) != want:
    raise AssertionError(f'{len(solved)} Hungarian solves in one step, '
                         f'want {want}')
  outs = aux['outputs']
  matches = {'solved': solved[0] if solved else None,
             **{k: aux[k] for k in ('match', 'match_box') if k in aux},
             **{k: outs[k].detach() for k in ('grd_match', 'y_out', 's_out')
                if k in outs}}
  return loss.detach(), grads, old, new, matches


def without_filter_grads(torch, gk):
  """Glimpse functions whose backward drops d_f_y and d_f_x: the negative
  control of the train-step gates."""
  class Drop(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f):
      return f.view_as(f)

    @staticmethod
    def backward(ctx, g):
      return torch.zeros_like(g)

  return (lambda x, f_y, f_x: gk.glimpse_extract(x, Drop.apply(f_y),
                                                 Drop.apply(f_x)),
          lambda p, f_y, f_x: gk.glimpse_paste(p, Drop.apply(f_y),
                                               Drop.apply(f_x)))


def reordered_plain(torch):
  """Plain glimpse einsums that contract in the other order (W before H for
  extract, G before F for paste): the same functions, other float32
  rounding."""
  return (lambda x, f_y, f_x: torch.einsum(
              'bhf,bhgd->bfgd', f_y, torch.einsum('bhwd,bwg->bhgd', x, f_x)),
          lambda p, f_y, f_x: torch.einsum(
              'bhf,bfwd->bhwd', f_y, torch.einsum('bfgd,bwg->bfwd', p, f_x)))


def to_device(draws, dev):
  return {k: (v if k == 'aug' else v.to(dev)) for k, v in draws.items()}


def step_to(torch, step, dev):
  """A step as one_step returns it, its tensors moved to ``dev``."""
  return tuple(({k: (v.to(dev) if torch.is_tensor(v) else v)
                 for k, v in x.items()} if isinstance(x, dict) else x.to(dev))
               for x in step)


def held_steps(torch, model, run, want, lr, limits):
  """A train step held against the reference step want (as one_step gives
  them).  run(pinned) takes the step, solving its matchings, or with the
  host solver's answer pinned.  Yields (suffix, stats, gated): the step as
  it solves ('', gated where its Hungarian matchings agree with want's in
  every example) and, where they do not, the step with want's answer pinned
  ('_pinned', gated)."""
  def diff(got):
    stats = step_diff(torch, model, got, want, lr)
    stats['failed'] = step_gate_failures(stats, limits)
    return stats
  stats = diff(run(None))
  agree = not (stats['matches_differ'].get('match')
               or stats['matches_differ'].get('match_box'))
  yield '', stats, agree
  if not agree:
    yield '_pinned', diff(run(want[4]['solved'])), True


def step_gates(torch, ts, matching, gk, model, opt, batch, draws, step, lr,
               limits):
  """Kernel glimpses against plain ones on one train step at global step
  ``step``, from the same parameters, Adam state, batch and draws, with
  cuDNN held to its deterministic algorithms, held to ``limits``.  Beside
  it: two plain steps whose einsums sum in other orders (the float32 noise
  floor), and the step whose glimpse backward drops the filter gradients,
  with the plain step's matchings pinned, which must fail the gradient
  limits.  Returns (gates {name: stats}, failures)."""
  def run(glimpse):
    def step_fn(pinned):
      with deterministic_cudnn(torch):
        return one_step(torch, ts, matching, model, opt, batch, draws, step,
                        glimpse, pinned)
    return step_fn
  plain = run('plain')(None)
  gates, failures = {}, []
  for name, stats, _ in held_steps(torch, model, run(reordered_plain(torch)),
                                   plain, lr, limits):
    gates['noise_floor' + name] = stats
  for name, stats, gated in held_steps(torch, model, run('kernel'), plain,
                                       lr, limits):
    gates['kernel_vs_plain' + name] = stats
    if gated and stats['failed']:
      failures.append(f'kernel_vs_plain{name}: fails {stats["failed"]}')
  control = run(without_filter_grads(torch, gk))(plain[4]['solved'])
  stats = step_diff(torch, model, control, plain, lr)
  stats['failed'] = step_gate_failures(stats, limits)
  gates['dropped_filter_grads_vs_plain_pinned'] = stats
  passed = [k for k in GRADIENT_GATES
            if k in limits and k not in stats['failed']]
  if passed:
    failures.append('dropped_filter_grads_vs_plain_pinned: the gradient '
                    f'gates {passed} pass it')
  return gates, failures


def read_scores(folder, name):
  """{example id: value} of an analyzer's CSV (the ID,Score lines)."""
  with open(os.path.join(folder, f'{name}.csv')) as f:
    rows = [line.strip().split(',') for line in f.readlines()[1:]]
  return {r[0]: float(r[1]) for r in rows if r[0] not in ('Mean', 'Std')}


def eval_runs(torch, gk, folder, cfg, dataset, examples, batch, threshold,
              score_threshold, label):
  """eval_split of the full model in ``folder`` over ``dataset`` (one mask
  threshold) with the kernel glimpses, launches counted (T extracts and 2T
  pastes a batch), the plain ones and the reordered plain ones (the float32
  floor), cuDNN deterministic, each writing its CSVs to a temporary folder
  inside the checkout.  Per example, the kernels' SBD is held to the plain
  one within twice the floor plus the CSVs' resolution, and the counts
  must be equal.  Returns (runs {'kernel', 'plain', 'reordered_plain'}:
  means, per-example sbd and dic, seconds, timings; launches; stats;
  the SBD limit; failures)."""
  from rec_attend_tpu_torch.cli.eval import DEFAULT_ANALYZERS
  from rec_attend_tpu_torch.cli.eval import eval_split
  from rec_attend_tpu_torch.engine.experiment import EvalExperiment
  T = cfg.timespan
  n_batches = -(-examples // batch)
  names = DEFAULT_ANALYZERS + ['count']

  def run(glimpse, name):
    exp = EvalExperiment(folder, cfg=cfg, device='cuda', glimpse=glimpse)
    out = os.path.join(csv_root, name)
    timings = {}
    t0 = time.time()
    with deterministic_cudnn(torch):
      summary = eval_split(exp, dataset, out, [threshold], names,
                           batch_size=batch, score_threshold=score_threshold,
                           timings=timings)
    seconds = time.time() - t0
    means = {k.split()[0]: float(v[0]) for k, v in summary[threshold].items()}
    if not all(math.isfinite(v) for v in means.values()):
      raise AssertionError(f'{label} {name}: means {means}')
    per_example = {n: read_scores(out, n) for n in ('sbd', 'dic')}
    if len(per_example['sbd']) != examples:
      raise AssertionError(f'{label} {name}: {len(per_example["sbd"])} rows')
    return {'means': means, 'per_example': per_example, 'seconds': seconds,
            'timings': timings}

  with tempfile.TemporaryDirectory(prefix=f'.chip_smoke_{label}-',
                                   dir=REPO) as csv_root:
    gk.reset_launch_counts()
    runs = {'kernel': run('kernel', 'kernel')}
    launches = gk.launch_counts()
    runs['kernel']['extract_route_launches'] = {
        k: v for k, v in gk.glimpse_extract.route_launches.items() if v}
    want = {'glimpse_extract': T * n_batches,
            'glimpse_paste': 2 * T * n_batches}
    if launches != want:
      raise AssertionError(f'{label}: kernel launches {launches}, want '
                           f'{want}')
    runs['plain'] = run('plain', 'plain')
    runs['reordered_plain'] = run(reordered_plain(torch), 'reordered_plain')

  def compare(got, ref):
    sbd, sbd_ref = got['per_example']['sbd'], ref['per_example']['sbd']
    dic, dic_ref = got['per_example']['dic'], ref['per_example']['dic']
    return {'sbd_max_abs_diff': max(abs(sbd[k] - sbd_ref[k]) for k in sbd),
            'sbd_differ': sorted(k for k in sbd if sbd[k] != sbd_ref[k]),
            'count_differ': sorted(k for k in dic if dic[k] != dic_ref[k])}
  stats = {'kernel_vs_plain': compare(runs['kernel'], runs['plain']),
           'reordered_plain_vs_plain': compare(runs['reordered_plain'],
                                               runs['plain'])}
  sbd_limit = (EVAL_SBD_FLOOR_FACTOR
               * stats['reordered_plain_vs_plain']['sbd_max_abs_diff']
               + EVAL_CSV_RESOLUTION)
  failures = []
  kernel_stats = stats['kernel_vs_plain']
  if kernel_stats['sbd_max_abs_diff'] > sbd_limit:
    failures.append(f'SBD differs by {kernel_stats["sbd_max_abs_diff"]}, '
                    f'limit {sbd_limit}')
  if kernel_stats['count_differ']:
    failures.append(f'counts differ at {kernel_stats["count_differ"]}')
  return runs, launches, stats, sbd_limit, failures


def eval_phase(torch, cfg, gk):
  """The eval path: eval_split over a synthetic split with the kernel
  glimpses, the plain ones and the reordered plain ones (the float32
  floor), cuDNN deterministic; launches counted on the kernel run."""
  from rec_attend_tpu_torch.data.synthetic import SyntheticDataset
  from rec_attend_tpu_torch.engine.experiment import EvalExperiment
  from rec_attend_tpu_torch.models.full_model import full_model_forward
  from rec_attend_tpu_torch.utils import postprocess as pp

  ds = SyntheticDataset(EVAL_EXAMPLES, cfg.inp_height, cfg.inp_width,
                        cfg.timespan, seed=4)
  runs, launches, stats, sbd_limit, failures = eval_runs(
      torch, gk, CHECKPOINT_DIR, cfg, ds, EVAL_EXAMPLES, EVAL_BATCH,
      EVAL_THRESHOLD, EVAL_THRESHOLD, 'eval')
  kernel, plain, floor = (runs[k] for k in ('kernel', 'plain',
                                            'reordered_plain'))
  routes = kernel['extract_route_launches']
  if routes != {'extract_tiled_kernel': launches['glimpse_extract']}:
    failures.append(f'the eval\'s extracts took {routes}')

  # upsample on the card against the CPU, on the same confidence-weighted
  # maps: at the model's size (the eval path) and at 530x500 (serving).
  exp = EvalExperiment(CHECKPOINT_DIR, cfg=cfg, device='cuda')
  with torch.inference_mode():
    x = torch.from_numpy(ds.get_batch(range(min(8, EVAL_EXAMPLES)))['x'])
    out = full_model_forward(exp.model, x.cuda())
    maps = out['y_out'] * out['s_out'][:, :, None, None]
  upsample = {}
  for b, size in ((len(x), (cfg.inp_height, cfg.inp_width)),
                  (2, (530, 500))):
    got = pp.upsample(maps[:b], [size] * b).cpu()
    want = pp.upsample(maps[:b].cpu(), [size] * b)
    err = float((got - want).abs().max())
    upsample[f'b{b}_{size[0]}x{size[1]}'] = err
    if err > UPSAMPLE_ATOL:
      failures.append(f'upsample to {size} on the card differs from the '
                      f'CPU by {err}')
  if failures:
    raise AssertionError(f'eval gates: {failures}')
  median = lambda v: statistics.median(v) if v else None
  return {
      'examples': EVAL_EXAMPLES, 'batch': EVAL_BATCH,
      'thresholds': {'score': EVAL_THRESHOLD, 'mask': EVAL_THRESHOLD},
      'launches': launches, 'extract_route_launches': routes,
      'means': {'kernel': kernel['means'], 'plain': plain['means'],
                'reordered_plain': floor['means']},
      **stats,
      'limits': {'sbd_max_abs_diff': sbd_limit, 'count_differ': 0,
                 'upsample_card_vs_cpu': UPSAMPLE_ATOL},
      'upsample_card_vs_cpu_max_abs': upsample,
      'seconds': {k: v['seconds'] for k, v in (
          ('kernel', kernel), ('plain', plain), ('reordered_plain', floor))},
      'host_seconds_per_batch_median': {
          k: median(v) for k, v in kernel['timings'].items()},
      'host_seconds_per_batch': kernel['timings']}


def chain_phase(torch, gk):
  """The KITTI-shaped chain: the fg model, the in-memory pack and eval_split
  of the full model on the packed channels, with the kernel glimpses, the
  plain ones and the reordered plain ones (the float32 floor), cuDNN
  deterministic; launches counted on the kernel run."""
  from rec_attend_tpu_torch.cli.pack import pack_fg
  from rec_attend_tpu_torch.cli.pack import quantise
  from rec_attend_tpu_torch.config import kitti_fg_config
  from rec_attend_tpu_torch.config import kitti_full_config
  from rec_attend_tpu_torch.data.synthetic import SyntheticDataset
  from rec_attend_tpu_torch.engine.experiment import EvalExperiment
  from rec_attend_tpu_torch.models.fg_model import FGModel
  from rec_attend_tpu_torch.models.fg_model import fg_model_forward
  from rec_attend_tpu_torch.models.full_model import FullModel
  from rec_attend_tpu_torch.models.full_model import full_model_forward

  fg_cfg, cfg = kitti_fg_config(), kitti_full_config()
  T = cfg.timespan
  ds = SyntheticDataset(CHAIN_EXAMPLES, cfg.inp_height, cfg.inp_width, T,
                        seed=4, max_objects=CHAIN_MAX_OBJECTS)
  fg = EvalExperiment(CHAIN_FG_DIR, cfg=fg_cfg, device='cuda', spec='fg')
  pack_timings = {}
  t0 = time.time()
  with deterministic_cudnn(torch):
    packed = pack_fg(fg, ds, CHAIN_BATCH, timings=pack_timings)
  pack_seconds = time.time() - t0
  runs, launches, stats, sbd_limit, failures = eval_runs(
      torch, gk, CHAIN_FULL_DIR, cfg, packed, CHAIN_EXAMPLES, CHAIN_BATCH,
      CHAIN_MASK_THRESHOLD, CHAIN_SCORE_THRESHOLD, 'chain')
  kernel, plain, floor = (runs[k] for k in ('kernel', 'plain',
                                            'reordered_plain'))
  routes = kernel['extract_route_launches']
  if routes != {'extract_strip_kernel': launches['glimpse_extract']}:
    failures.append(f'the chain\'s extracts took {routes}')

  # The b32 forward on the packed channels: kernel against plain (the
  # serving gate), the reordered plain floor beside it; every extract takes
  # the strip route.
  exp = EvalExperiment(CHAIN_FULL_DIR, cfg=cfg, device='cuda')
  raw = packed.get_batch(range(CHAIN_BATCH), timespan=T)
  x, d_in, y_in = (torch.from_numpy(raw[k]).cuda()
                   for k in ('x', 'd_out', 'y_out'))
  route = gk.extract_route(CHAIN_BATCH, cfg.inp_height, cfg.inp_width,
                           cfg.acnn_inp_depth, cfg.filter_height,
                           cfg.filter_width)
  if route['kernel'] != 'extract_strip_kernel':
    failures.append(f'the chain\'s extract takes {route}')
  with deterministic_cudnn(torch), torch.inference_mode():
    want = full_model_forward(exp.model, x, d_in, y_in, glimpse='plain')
    reordered = forward_diff(full_model_forward(
        exp.model, x, d_in, y_in, glimpse=reordered_plain(torch)), want)
    gk.reset_launch_counts()
    got = full_model_forward(exp.model, x, d_in, y_in, glimpse='kernel')
    forward_routes = {k: v for k, v in
                      gk.glimpse_extract.route_launches.items() if v}
    if forward_routes != {'extract_strip_kernel': T}:
      failures.append(f'the b32 forward\'s extracts took {forward_routes}')
    kernel_vs_plain = forward_diff(got, want)
    # The card against the CPU on two images: the fg maps, their packed
    # bytes, the full forward.
    x2 = x[:2]
    cpu_fg = FGModel(fg_cfg, device='cpu')
    cpu_fg.load_state_dict(fg.model.state_dict())
    fg_got = fg_model_forward(fg.model, x2)
    fg_want = fg_model_forward(cpu_fg, x2.cpu())
    fg_card_vs_cpu = {k: float((fg_got[k].cpu() - fg_want[k]).abs().max())
                      for k in ('y_out', 'd_out')}
    bytes_differ_share = {k: float((quantise(fg_got[k]).cpu()
                                    != quantise(fg_want[k])).float().mean())
                          for k in ('y_out', 'd_out')}
    quantised_on_host = {k: bool(torch.equal(quantise(fg_got[k]).cpu(),
                                             quantise(fg_got[k].cpu())))
                         for k in ('y_out', 'd_out')}
    cpu_model = FullModel(exp.cfg, device='cpu')
    cpu_model.load_state_dict(exp.model.state_dict())
    full_card_vs_cpu = forward_diff(
        full_model_forward(exp.model, x2, d_in[:2], y_in[:2]),
        full_model_forward(cpu_model, x2.cpu(), d_in[:2].cpu(),
                           y_in[:2].cpu()))
  for label, diff in (('kernel_vs_plain_b32', kernel_vs_plain),
                      ('card_vs_cpu_b2', full_card_vs_cpu)):
    if gate_failures(diff):
      failures.append(f'{label}: {diff}')
  if max(fg_card_vs_cpu.values()) > FG_MAPS_ATOL:
    failures.append(f'fg card against CPU: {fg_card_vs_cpu}')
  if not all(quantised_on_host.values()):
    failures.append(f'the pack\'s bytes differ on the host: '
                    f'{quantised_on_host}')
  if failures:
    raise AssertionError(f'chain gates: {failures}')
  median = lambda v: statistics.median(v) if v else None
  per_batch = {'fg_forward': pack_timings['forward'],
               'pack': pack_timings['pack'],
               'full_forward': kernel['timings']['forward'],
               'postprocess': kernel['timings']['postprocess'],
               'analyzers': kernel['timings']['analyzers']}
  return {
      'examples': CHAIN_EXAMPLES, 'batch': CHAIN_BATCH,
      'weights': [os.path.relpath(d, REPO) for d in (CHAIN_FG_DIR,
                                                     CHAIN_FULL_DIR)],
      'thresholds': {'score': CHAIN_SCORE_THRESHOLD,
                     'mask': CHAIN_MASK_THRESHOLD},
      'launches': launches, 'extract_route': route,
      'extract_route_launches': routes,
      'b32_forward_extract_route_launches': forward_routes,
      'means': {'kernel': kernel['means'], 'plain': plain['means'],
                'reordered_plain': floor['means']},
      **stats,
      'kernel_vs_plain_b32': kernel_vs_plain,
      'reordered_plain_vs_plain_b32': reordered,
      'full_card_vs_cpu_b2': full_card_vs_cpu,
      'fg_card_vs_cpu_b2_max_abs': fg_card_vs_cpu,
      'fg_card_vs_cpu_b2_packed_bytes_differ_share': bytes_differ_share,
      'pack_same_bytes_on_host': quantised_on_host,
      'limits': {'sbd_max_abs_diff': sbd_limit, 'count_differ': 0,
                 'y_out_mean': Y_OUT_MEAN_ATOL,
                 'y_out_moved_share': Y_OUT_MOVED_SHARE,
                 'y_out_moved': Y_OUT_MOVED, 's_out_max': S_OUT_ATOL,
                 'fg_maps_max_abs': FG_MAPS_ATOL},
      'seconds': {'fg_and_pack': pack_seconds,
                  **{k: v['seconds'] for k, v in (
                      ('kernel', kernel), ('plain', plain),
                      ('reordered_plain', floor))}},
      'host_seconds_per_batch_median': {k: median(v)
                                        for k, v in per_batch.items()},
      'host_seconds_per_batch': per_batch}


def ap_difference(got, want):
  """The largest difference of two AP results: AP, AP_50% and each class's
  AP and AP_50% (NaN against NaN is 0, NaN against a number infinite)."""
  def values(avg):
    out = {'allAp': avg['allAp'], 'allAp50%': avg['allAp50%']}
    for name, d in avg['classes'].items():
      out.update({f'{name} ap': d['ap'], f'{name} ap50%': d['ap50%']})
    return out

  def diff(x, y):
    if math.isnan(x) or math.isnan(y):
      return 0.0 if math.isnan(x) and math.isnan(y) else math.inf
    return abs(x - y)
  a, b = values(got), values(want)
  return max(diff(a[k], b[k]) for k in b)


def pixel_result_equal(got, want):
  """Two pixel-eval results hold the same scores (NaN equal to NaN)."""
  def same(x, y):
    return (math.isnan(x) and math.isnan(y)) or x == y
  return all(same(got[f][k], v) for f, d in want.items()
             if isinstance(d, dict) for k, v in d.items()) and all(
                 same(got[f], v) for f, v in want.items()
                 if not isinstance(v, dict))


def params_checkpoint(model, folder, step=0):
  """Write ``model``'s parameters to ``folder`` as a params-only
  ``ckpt-{step}.npz`` in the JAX layout, which ``EvalExperiment``
  restores."""
  from rec_attend_tpu_torch.engine import saver
  state = model.state_dict()
  saver.save_pytree(os.path.join(folder, f'ckpt-{step}.npz'),
                    [state[n].cpu().numpy()
                     for n in saver.jax_leaf_order(state)])


def cs_chain_phase(torch, gk, patches_bit_equal):
  """The Cityscapes-shaped synthcs chain: the multiclass fg model (its
  weights drawn from CS_FG_SEED) and its 3-class pack, eval_split of the
  full model at 256x512 on the packed channels, the full model's pack, the
  model-free Cityscapes eval, its submission's instance AP and the pixel
  eval of the fg bytes; the full model's pack, the Cityscapes eval and the
  AP also on a pack of the ground truth's maps.  The full model runs with
  the kernel glimpses, the plain ones and the reordered plain ones (the
  float32 floor), cuDNN deterministic; launches counted on the kernel
  runs.
  ``patches_bit_equal``: the kernels gave the plain versions' bits at this
  chain's shapes, so the kernel run's AP must equal the plain run's; else
  it is held to twice the floor plus CS_AP_SLACK."""
  import numpy as np
  from rec_attend_tpu_torch.cli.cityscapes_eval import cityscapes_eval
  from rec_attend_tpu_torch.cli.pack import PackedDataset
  from rec_attend_tpu_torch.cli.pack import pack_fg
  from rec_attend_tpu_torch.cli.pack import pack_full
  from rec_attend_tpu_torch.cli.pack import quantise
  from rec_attend_tpu_torch.config import synthcs_fg_config
  from rec_attend_tpu_torch.config import synthcs_full_config
  from rec_attend_tpu_torch.data.synthetic import SyntheticDataset
  from rec_attend_tpu_torch.engine.experiment import EvalExperiment
  from rec_attend_tpu_torch.eval_cityscapes import pixel_eval
  from rec_attend_tpu_torch.eval_cityscapes.instance_eval import (
      evaluate_instance_predictions)
  from rec_attend_tpu_torch.models.fg_model import FGModel
  from rec_attend_tpu_torch.models.fg_model import fg_model_forward
  from rec_attend_tpu_torch.models.full_model import FullModel
  from rec_attend_tpu_torch.models.full_model import full_model_forward

  fg_cfg, cfg = synthcs_fg_config(), synthcs_full_config()
  T = cfg.timespan
  n_batches = -(-CS_EXAMPLES // CS_BATCH)
  ds = SyntheticDataset(CS_EXAMPLES, cfg.inp_height, cfg.inp_width, T,
                        seed=4, max_objects=CS_MAX_OBJECTS,
                        num_semantic_classes=CS_CLASSES)
  with tempfile.TemporaryDirectory(prefix='.chip_smoke_cs_fg-',
                                   dir=REPO) as fg_dir:
    params_checkpoint(FGModel(fg_cfg, seed=CS_FG_SEED, device='cpu'), fg_dir)
    fg = EvalExperiment(fg_dir, cfg=fg_cfg, device='cuda', spec='fg')
  pack_timings = {}
  t0 = time.time()
  with deterministic_cudnn(torch):
    packed = pack_fg(fg, ds, CS_BATCH, timings=pack_timings)
  pack_seconds = time.time() - t0
  if packed.y_out.shape[-1] != CS_CLASSES + 1:
    raise AssertionError(f'the fg pack has {packed.y_out.shape[-1]} '
                         'semantic channels')
  runs, launches, stats, sbd_limit, failures = eval_runs(
      torch, gk, CS_FULL_DIR, cfg, packed, CS_EXAMPLES, CS_BATCH,
      CS_MASK_THRESHOLD, CS_SCORE_THRESHOLD, 'cs_chain')
  kernel, plain, floor = (runs[k] for k in ('kernel', 'plain',
                                            'reordered_plain'))
  routes = kernel['extract_route_launches']
  if routes != {'extract_strip_kernel': launches['glimpse_extract']}:
    failures.append(f'the chain\'s extracts took {routes}')

  # The full model's pack, the Cityscapes eval and its AP, with each
  # glimpse form, on the fg model's pack (the path) and on a pack of the
  # ground truth's maps ('oracle'): the fg model's weights are drawn from a
  # seed, so its maps carry no classes and the full model matches few
  # instances on them, where AP stays near 0 whatever the labels; on the
  # ground truth's maps it works in its trained range, and there the AP
  # gate's control must fail.
  gt_ids = ds.get_instance_id_images(ds.img_ids)
  oracle = PackedDataset(ds, quantise(torch.from_numpy(ds.d_gt)).numpy(),
                         quantise(torch.from_numpy(ds.c_gt)).numpy())
  forms = {'kernel': 'kernel', 'plain': 'plain',
           'reordered_plain': reordered_plain(torch)}
  cs = {'fg': {}, 'oracle': {}}
  with tempfile.TemporaryDirectory(prefix='.chip_smoke_cs_chain-',
                                   dir=REPO) as root:
    for source, src_pack in (('fg', packed), ('oracle', oracle)):
      for name, glimpse in forms.items():
        exp = EvalExperiment(CS_FULL_DIR, cfg=cfg, device='cuda',
                             glimpse=glimpse)
        full_timings, cs_timings = {}, {}
        gk.reset_launch_counts()
        with deterministic_cudnn(torch):
          full_packed = pack_full(exp, src_pack, CS_BATCH,
                                  timings=full_timings)
        pack_launches = gk.launch_counts()
        pack_routes = {k: v for k, v in
                       gk.glimpse_extract.route_launches.items() if v}
        folder = os.path.join(root, f'{source}_{name}')
        summary, rows = cityscapes_eval(
            full_packed, folder, [CS_AP_THRESHOLD], ['sbd'],
            remove_tiny=CS_AP_REMOVE_TINY, batch_size=CS_BATCH,
            device='cuda', timings=cs_timings)
        t0 = time.perf_counter()
        ap = evaluate_instance_predictions(rows[CS_AP_THRESHOLD], gt_ids)
        ap_seconds = time.perf_counter() - t0
        cs[source][name] = {
            'rows': rows[CS_AP_THRESHOLD], 'ap': ap,
            'sbd': float(next(iter(summary[CS_AP_THRESHOLD].values()))[0]),
            'sbd_per_example': read_scores(folder, 'sbd'),
            'submitted': sum(len(r) for r in rows[CS_AP_THRESHOLD]),
            'timings': {'full_pack_forward': full_timings['forward'],
                        'full_pack': full_timings['pack'],
                        **{f'cityscapes_{k}': v
                           for k, v in cs_timings.items()},
                        'ap': [ap_seconds]}}
        if name != 'kernel':
          continue
        want = {'glimpse_extract': T * n_batches,
                'glimpse_paste': 2 * T * n_batches}
        if pack_launches != want:
          failures.append(f'pack_full ({source}): kernel launches '
                          f'{pack_launches}, want {want}')
        if pack_routes != {'extract_strip_kernel': T * n_batches}:
          failures.append(f'pack_full\'s extracts ({source}) took '
                          f'{pack_routes}')
        if source == 'fg':
          full_pack_launches, full_pack_routes = pack_launches, pack_routes
  ap_stats = {}
  for source, by_form in cs.items():
    ap_kernel, ap_plain = by_form['kernel']['ap'], by_form['plain']['ap']
    if not (math.isfinite(ap_kernel['allAp'])
            and math.isfinite(ap_kernel['allAp50%'])):
      failures.append(f'AP ({source}) {ap_kernel}')
    floor_diff = ap_difference(by_form['reordered_plain']['ap'], ap_plain)
    limit = (0.0 if patches_bit_equal
             else CS_AP_FLOOR_FACTOR * floor_diff + CS_AP_SLACK)
    kernel_diff = ap_difference(ap_kernel, ap_plain)
    if kernel_diff > limit:
      failures.append(f'AP ({source}) kernel against plain differs by '
                      f'{kernel_diff}, limit {limit}')
    # Control: the kernel run's submission with person and rider swapped.
    swap = {24: 25, 25: 24}
    swapped = [[r._replace(label_id=swap.get(r.label_id, r.label_id))
                for r in rows] for rows in by_form['kernel']['rows']]
    swapped_diff = ap_difference(
        evaluate_instance_predictions(swapped, gt_ids), ap_plain)
    if source == 'oracle' and swapped_diff <= limit:
      failures.append(f'the AP gate passes person and rider swapped: '
                      f'{swapped_diff}, limit {limit}')
    per_example = {k: v['sbd_per_example'] for k, v in by_form.items()}
    ap_stats[source] = {
        'ap': {k: v['ap'] for k, v in by_form.items()},
        'submitted_rows': {k: v['submitted'] for k, v in by_form.items()},
        'cityscapes_sbd': {k: v['sbd'] for k, v in by_form.items()},
        'cityscapes_sbd_kernel_vs_plain_max_abs': max(
            abs(per_example['kernel'][k] - v)
            for k, v in per_example['plain'].items()),
        'ap_kernel_vs_plain': kernel_diff,
        'ap_reordered_plain_vs_plain': floor_diff,
        'ap_person_rider_swapped_vs_plain': swapped_diff,
        'ap_limit': limit}
  if not cs['oracle']['kernel']['submitted']:
    failures.append('nothing submitted on the ground truth\'s maps')

  # The pixel eval of the card's fg bytes: labelled on the host and on
  # the card, the same labels and the same result.
  t0 = time.perf_counter()
  host = pixel_eval.PixelEvaluator()
  for fg_bytes, ids in zip(packed.y_out, gt_ids):
    label, inst = pixel_eval.groundtruth_labels(ids)
    host.add_pair(pixel_eval.prediction_labels(fg_bytes), label,
                  instance_img=inst)
  pixel = host.finalize()
  pixel_seconds = time.perf_counter() - t0
  card_labels = pixel_eval.prediction_labels(
      torch.from_numpy(packed.y_out).cuda()).cpu().numpy()
  card = pixel_eval.PixelEvaluator()
  for pred, ids in zip(card_labels, gt_ids):
    label, inst = pixel_eval.groundtruth_labels(ids)
    card.add_pair(pred, label, instance_img=inst)
  pixel_card = card.finalize()
  labels_equal = bool(np.array_equal(
      card_labels, np.stack([pixel_eval.prediction_labels(b)
                             for b in packed.y_out])))
  if not (labels_equal and np.array_equal(card.conf, host.conf)
          and pixel_result_equal(pixel_card, pixel)):
    failures.append('the pixel eval of labels made on the card differs '
                    'from the host\'s')
  if not math.isfinite(pixel['meanIoU']):
    failures.append(f'pixel eval {pixel}')

  # The b32 forward on the packed channels: kernel against plain, the
  # reordered plain floor beside it; the card against the CPU (b2) for the
  # fg maps and the full forward, with a control that must fail: the
  # card's forward with the packed fg channels in reversed order.
  exp = EvalExperiment(CS_FULL_DIR, cfg=cfg, device='cuda')
  raw = packed.get_batch(range(CS_BATCH), timespan=T)
  x, d_in, y_in = (torch.from_numpy(raw[k]).cuda()
                   for k in ('x', 'd_out', 'y_out'))
  route = gk.extract_route(CS_BATCH, cfg.inp_height, cfg.inp_width,
                           cfg.acnn_inp_depth, cfg.filter_height,
                           cfg.filter_width)
  if route['kernel'] != 'extract_strip_kernel':
    failures.append(f'the chain\'s extract takes {route}')
  with deterministic_cudnn(torch), torch.inference_mode():
    want = full_model_forward(exp.model, x, d_in, y_in, glimpse='plain')
    reordered = forward_diff(full_model_forward(
        exp.model, x, d_in, y_in, glimpse=reordered_plain(torch)), want)
    gk.reset_launch_counts()
    got = full_model_forward(exp.model, x, d_in, y_in, glimpse='kernel')
    forward_routes = {k: v for k, v in
                      gk.glimpse_extract.route_launches.items() if v}
    if forward_routes != {'extract_strip_kernel': T}:
      failures.append(f'the b32 forward\'s extracts took {forward_routes}')
    kernel_vs_plain = forward_diff(got, want)
    x2 = x[:2]
    cpu_fg = FGModel(fg_cfg, device='cpu')
    cpu_fg.load_state_dict(fg.model.state_dict())
    fg_got = fg_model_forward(fg.model, x2)
    fg_want = fg_model_forward(cpu_fg, x2.cpu())
    fg_card_vs_cpu = {k: float((fg_got[k].cpu() - fg_want[k]).abs().max())
                      for k in ('y_out', 'd_out')}
    bytes_differ_share = {k: float((quantise(fg_got[k]).cpu()
                                    != quantise(fg_want[k])).float().mean())
                          for k in ('y_out', 'd_out')}
    cpu_model = FullModel(exp.cfg, device='cpu')
    cpu_model.load_state_dict(exp.model.state_dict())
    full_cpu = full_model_forward(cpu_model, x2.cpu(), d_in[:2].cpu(),
                                  y_in[:2].cpu())
    full_card = full_model_forward(exp.model, x2, d_in[:2], y_in[:2])
    full_card_vs_cpu = forward_diff(full_card, full_cpu)
    reversed_y_in = forward_diff(full_model_forward(
        exp.model, x2, d_in[:2], y_in[:2].flip(-1)), full_cpu)
    reversed_y_in['failed'] = gate_failures(reversed_y_in)
    quantised_on_host = {
        f'fg_{k}': bool(torch.equal(quantise(fg_got[k]).cpu(),
                                    quantise(fg_got[k].cpu())))
        for k in ('y_out', 'd_out')}
    quantised_on_host['full_y_out'] = bool(torch.equal(
        quantise(full_card['y_out']).cpu(),
        quantise(full_card['y_out'].cpu())))
  for label, diff in (('kernel_vs_plain_b32', kernel_vs_plain),
                      ('card_vs_cpu_b2', full_card_vs_cpu)):
    if gate_failures(diff):
      failures.append(f'{label}: {diff}')
  if not reversed_y_in['failed']:
    failures.append(f'the gates pass a reversed y_in: {reversed_y_in}')
  if max(fg_card_vs_cpu.values()) > FG_MAPS_ATOL:
    failures.append(f'fg card against CPU: {fg_card_vs_cpu}')
  if not all(quantised_on_host.values()):
    failures.append(f'the pack\'s bytes differ on the host: '
                    f'{quantised_on_host}')
  if failures:
    raise AssertionError(f'cs_chain gates: {failures}; AP {ap_stats}')
  median = lambda v: statistics.median(v) if v else None
  per_batch = {'fg_forward': pack_timings['forward'],
               'pack': pack_timings['pack'],
               'full_forward': kernel['timings']['forward'],
               'postprocess': kernel['timings']['postprocess'],
               'analyzers': kernel['timings']['analyzers'],
               **cs['fg']['kernel']['timings'],
               'pixel_eval': [pixel_seconds]}
  return {
      'examples': CS_EXAMPLES, 'batch': CS_BATCH,
      'weights': {'fg': f'seed {CS_FG_SEED}',
                  'full': os.path.relpath(CS_FULL_DIR, REPO)},
      'thresholds': {'score': CS_SCORE_THRESHOLD, 'mask': CS_MASK_THRESHOLD,
                     'ap_mask': CS_AP_THRESHOLD,
                     'ap_remove_tiny': CS_AP_REMOVE_TINY},
      'launches': launches, 'full_pack_launches': full_pack_launches,
      'extract_route': route, 'extract_route_launches': routes,
      'full_pack_extract_route_launches': full_pack_routes,
      'b32_forward_extract_route_launches': forward_routes,
      'means': {'kernel': kernel['means'], 'plain': plain['means'],
                'reordered_plain': floor['means']},
      **stats,
      'cityscapes': ap_stats,
      'pixel_eval': pixel,
      'pixel_labels_card_equal_host': labels_equal,
      'kernel_vs_plain_b32': kernel_vs_plain,
      'reordered_plain_vs_plain_b32': reordered,
      'full_card_vs_cpu_b2': full_card_vs_cpu,
      'reversed_y_in_card_vs_cpu_b2': reversed_y_in,
      'fg_card_vs_cpu_b2_max_abs': fg_card_vs_cpu,
      'fg_card_vs_cpu_b2_packed_bytes_differ_share': bytes_differ_share,
      'pack_same_bytes_on_host': quantised_on_host,
      'limits': {'sbd_max_abs_diff': sbd_limit, 'count_differ': 0,
                 'patches_bit_equal': patches_bit_equal,
                 'y_out_mean': Y_OUT_MEAN_ATOL,
                 'y_out_moved_share': Y_OUT_MOVED_SHARE,
                 'y_out_moved': Y_OUT_MOVED, 's_out_max': S_OUT_ATOL,
                 'fg_maps_max_abs': FG_MAPS_ATOL},
      'seconds': {'fg_and_pack': pack_seconds,
                  **{k: v['seconds'] for k, v in (
                      ('kernel', kernel), ('plain', plain),
                      ('reordered_plain', floor))}},
      'host_seconds_per_batch_median': {k: median(v)
                                        for k, v in per_batch.items()},
      'host_seconds_per_batch': per_batch}


def opt_state_to(opt_state, dev):
  """A copy of an optimizer state (``train_step.init_opt_state`` form) on
  ``dev``."""
  return {k: (v if k == 'count' else {n: t.to(dev) for n, t in v.items()})
          for k, v in opt_state.items()}


def run_steps(torch, gk, trainer, batches, n):
  """``n`` steps of ``trainer``, one batch each, launches counted per step
  (the counts set to 0 just before each, read just after), each step
  timed with CUDA events on the card (None elsewhere)."""
  steps = []
  cuda = trainer.device.type == 'cuda'
  for _ in range(n):
    gk.reset_launch_counts()
    if cuda:
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
    (metrics,) = trainer.run(1, batches)
    if cuda:
      end.record()
      end.synchronize()
    if not math.isfinite(metrics['loss']):
      raise AssertionError(f'step {metrics["step"]}: loss {metrics["loss"]}')
    steps.append({
        'step': metrics['step'] - 1,
        'ms': start.elapsed_time(end) if cuda else None,
        'launches': gk.launch_counts(),
        'backward_launches': gk.launch_counts(backward=True),
        'extract_route_launches': {
            k: v for k, v in gk.glimpse_extract.route_launches.items() if v},
        'metrics': metrics})
  for k, v in trainer.model.state_dict().items():
    if not torch.isfinite(v).all():
      raise AssertionError(f'non-finite parameter after training: {k}')
  return steps


def steps_summary(torch, steps, peak):
  """The median step ms, the peak memory and the launches per step (all
  steps must launch alike)."""
  per_step = {(tuple(s['launches'].items()),
               tuple(s['backward_launches'].items()),
               tuple(s['extract_route_launches'].items())) for s in steps}
  if len(per_step) != 1:
    raise AssertionError(f'the steps launched differently: {per_step}')
  ms_ = [s['ms'] for s in steps if s['ms'] is not None]
  return {'steps': steps,
          'step_ms_median': statistics.median(ms_) if ms_ else None,
          'max_memory_allocated_bytes': peak,
          'launches_per_step': steps[0]['launches'],
          'backward_launches_per_step': steps[0]['backward_launches'],
          'extract_route_launches_per_step':
              steps[0]['extract_route_launches']}


def want_launches(steps, total, backward, routes, label):
  for s in steps:
    if (s['launches'] != total or s['backward_launches'] != backward
        or s['extract_route_launches'] != routes):
      raise AssertionError(
          f'{label} step {s["step"]}: launches {s["launches"]} (backward '
          f'{s["backward_launches"]}, routes {s["extract_route_launches"]}),'
          f' want {total} (backward {backward}, routes {routes})')


def peak_memory(torch, dev):
  return torch.cuda.max_memory_allocated() if dev.type == 'cuda' else None


def reset_peak(torch, dev):
  if dev.type == 'cuda':
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def cpu_gate(torch, ts, matching, model, opt_state, batch, draws, step, lr,
             limits, nb=CHAIN_TRAIN_CPU_BATCH):
  """One step of ``model`` (on its device) against the same step on the
  CPU, on the batch's first ``nb`` examples (``draws`` are theirs), cuDNN
  deterministic, the CPU's Hungarian matchings pinned where they differ
  (``held_steps``).  Returns ({name: stats}, failures, the CPU step)."""
  dev = model.device
  cpu_model = copy.deepcopy(model).to('cpu')
  cpu_model.device = torch.device('cpu')
  small = {k: v[:nb] for k, v in batch.items()}
  host = one_step(torch, ts, matching, cpu_model,
                  opt_state_to(opt_state, 'cpu'),
                  {k: v.cpu() for k, v in small.items()},
                  to_device(draws, 'cpu'), step, 'kernel')
  host = step_to(torch, host, dev)

  def card(pinned):
    with deterministic_cudnn(torch):
      return one_step(torch, ts, matching, model, opt_state, small,
                      to_device(draws, dev), step, 'kernel', pinned)
  gates, failures = {}, []
  for name, stats, gated in held_steps(torch, model, card, host, lr, limits):
    gates[f'card_vs_cpu{name}_b{nb}'] = stats
    if gated and stats['failed']:
      failures.append(f'card_vs_cpu{name}: fails {stats["failed"]}')
  return gates, failures, host


def fg_step_gates(torch, ts, matching, model, opt_state, batch, draws, step,
                  lr, limits):
  """The fg step held to ``limits``, card against CPU (b2).  Beside it the
  float32 floor: the card's step on the batch in the other order (its
  batch sums run in another order) against the card's step.  Two controls
  must fail the gate: the step with the momentum trace reset (its update),
  and the loss without the orientation CE (its gradients).  Returns
  (gates, failures)."""
  gates, failures, host = cpu_gate(torch, ts, matching, model, opt_state,
                                   batch, draws, step, lr, limits)
  small = {k: v[:CHAIN_TRAIN_CPU_BATCH] for k, v in batch.items()}

  def card(m, opt, b=small):
    with deterministic_cudnn(torch):
      return one_step(torch, ts, matching, m, opt, b, draws, step, 'kernel')
  gates['swapped_batch_vs_card'] = step_diff(
      torch, model, card(model, opt_state,
                         {k: v.flip(0) for k, v in small.items()}),
      card(model, opt_state), lr)
  reset = {'count': opt_state['count'], 'trace': {
      k: torch.zeros_like(v) for k, v in opt_state['trace'].items()}}
  no_ori = copy.deepcopy(model)
  no_ori.cfg = model.cfg.replace(add_orientation=False)
  for name, got, must_fail in (
      ('trace_reset', card(model, reset), 'update_rel_l2_max'),
      ('no_orientation_ce', card(no_ori, opt_state), 'grad_rel_l2_max')):
    stats = step_diff(torch, model, got, host, lr)
    stats['failed'] = step_gate_failures(stats, limits)
    gates[f'{name}_vs_cpu'] = stats
    if must_fail not in stats['failed']:
      failures.append(f'control {name} passes the {must_fail} gate')
  return gates, failures


def box_step_gates(torch, ts, matching, gk, model, opt_state, batch, draws,
                   step, lr, limits):
  """The box step held to ``limits``: kernel against plain (b8, with the
  reordered plain floor and the dropped-filter-gradient control,
  ``step_gates``) and card against CPU (b2).  Returns (gates, failures)."""
  gates, failures = step_gates(torch, ts, matching, gk, model, opt_state,
                               batch, draws, step, lr, limits)
  small_draws = {'aug': draws['aug'],
                 'segm_noise': draws['segm_noise'][:, :CHAIN_TRAIN_CPU_BATCH]}
  g, f, _ = cpu_gate(torch, ts, matching, model, opt_state, batch,
                     small_draws, step, lr, limits)
  gates.update(g)
  return gates, failures + f


def chain_batches(torch, get, keys, batch, n_batches):
  """Batches of ``batch`` examples of get(indices), cycled over the first
  ``n_batches``: {key: tensor of get's field src} for keys {key: src}."""
  import numpy as np
  i = 0
  while True:
    raw = get(range(i * batch, (i + 1) * batch))
    yield {k: torch.from_numpy(np.ascontiguousarray(raw[src]))
           for k, src in keys.items()}
    i = (i + 1) % n_batches


# The batch keys of the fg trainer and of the box and full trainers, from
# the fields of SyntheticDataset and of its PackedDataset.
FG_KEYS = {'x': 'x', 'c_gt': 'c_gt', 'd_gt': 'd_gt'}
PACKED_KEYS = {'x': 'x', 'y_gt': 'y_gt', 's_gt': 's_gt', 'd_in': 'd_out',
               'y_in': 'y_out'}


def chain_train_phase(torch, gk, dev, cfgs=None, dirs=None,
                      n_steps=CHAIN_TRAIN_STEPS, batch=CHAIN_TRAIN_BATCH,
                      examples=CHAIN_TRAIN_EXAMPLES,
                      limits=(FG_STEP_LIMITS, BOX_STEP_LIMITS,
                              FULL_STEP_LIMITS)):
  """The synth3 chain's training, each stage through its Trainer at b8
  on ``dev``: fg (restored with its momentum trace), the in-memory pack of
  the trained fg model, box (restored with Adam) on the packed channels,
  full (started from the trained box's controller, then restored from its
  checkpoint).  Each stage's steps are timed and their launches counted;
  one step of each stage is gated before its steps (fg card against CPU;
  box kernel against plain and card against CPU; full kernel against
  plain), each with its controls.  ``cfgs`` and ``dirs`` ((fg, box, full)
  configs and results folders) default to the KITTI presets and the
  synth3 checkpoints, ``limits`` (fg, box, full) to the limits set from
  the card's floor at those presets.  On the card, each stage's launches
  per step must be those of its path.  Returns (results, the gates'
  failures)."""
  from rec_attend_tpu_torch import train_step as ts
  from rec_attend_tpu_torch.cli.pack import pack_fg
  from rec_attend_tpu_torch.config import kitti_box_config
  from rec_attend_tpu_torch.config import kitti_fg_config
  from rec_attend_tpu_torch.config import kitti_full_config
  from rec_attend_tpu_torch.data.synthetic import SyntheticDataset
  from rec_attend_tpu_torch.engine import saver
  from rec_attend_tpu_torch.engine.experiment import EvalExperiment
  from rec_attend_tpu_torch.engine.trainer import Trainer
  from rec_attend_tpu_torch.models.box_model import draw_box_randoms
  from rec_attend_tpu_torch.models.fg_model import draw_fg_randoms
  from rec_attend_tpu_torch.models.full_model import draw_train_randoms
  from rec_attend_tpu_torch.models.full_model import learn_rate
  from rec_attend_tpu_torch.ops import matching

  fg_cfg, box_cfg, full_cfg = cfgs or (kitti_fg_config(), kitti_box_config(),
                                       kitti_full_config())
  fg_dir, box_dir, full_dir = dirs or (CHAIN_FG_DIR, CHAIN_BOX_DIR,
                                       CHAIN_FULL_DIR)
  fg_limits, box_limits, full_limits = limits
  T, H, W = full_cfg.timespan, full_cfg.inp_height, full_cfg.inp_width
  ds = SyntheticDataset(examples, H, W, T, seed=5,
                        max_objects=CHAIN_MAX_OBJECTS)
  n_batches = examples // batch
  out, failures = {}, []

  def first_batch(get, keys):
    return {k: v.to(dev) for k, v in next(chain_batches(
        torch, get, keys, batch, n_batches)).items()}

  # ---- fg ---------------------------------------------------------------
  fg = Trainer(fg_cfg, device=dev)
  ckpt = fg.restore(fg_dir)
  if (fg.step != saver.checkpoint_step(ckpt) or fg.opt_state['count'] != fg.step
      or 'trace' not in fg.opt_state):
    raise AssertionError(f'fg restored step {fg.step}, state '
                         f'{sorted(fg.opt_state)}')
  gates, f = fg_step_gates(
      torch, ts, matching, fg.model, fg.opt_state,
      first_batch(ds.get_batch, FG_KEYS),
      draw_fg_randoms(fg_cfg, torch.Generator(dev).manual_seed(1)), fg.step,
      learn_rate(fg_cfg, fg.opt_state['count']), fg_limits)
  failures += [f'fg {x}' for x in f]
  reset_peak(torch, dev)
  # cuDNN's deterministic algorithms, so that the trained fg model, its
  # pack and with it the box gate's batch are the same bits in every run.
  # With the default ones every run packed other bytes, and on some of
  # them float32 itself lies past the box gate's limit from the float64
  # step (`step_noise.py --box-repeats`).
  with deterministic_cudnn(torch):
    fg_steps = run_steps(torch, gk, fg, chain_batches(
        torch, ds.get_batch, FG_KEYS, batch, n_batches), n_steps[0])
  if dev.type == 'cuda':
    want_launches(fg_steps, {'glimpse_extract': 0, 'glimpse_paste': 0},
                  {'glimpse_extract': 0, 'glimpse_paste': 0}, {}, 'fg')
  out['fg'] = {'weights': os.path.relpath(ckpt, REPO), 'gates': gates,
               'limits': fg_limits,
               'momentum_count': fg.opt_state['count'],
               **steps_summary(torch, fg_steps, peak_memory(torch, dev))}

  # ---- pack: the trained fg model's maps for the box's batches ---------
  fg_exp = EvalExperiment(fg_dir, cfg=fg_cfg, device=dev, spec='fg')
  fg_exp.model.load_state_dict(fg.model.state_dict())
  t0 = time.time()
  with deterministic_cudnn(torch):
    packed = pack_fg(fg_exp, ds, batch)
  out['pack'] = {'seconds': time.time() - t0, 'examples': examples,
                 'sha256': hashlib.sha256(packed.d_out.tobytes()
                                          + packed.y_out.tobytes()
                                          ).hexdigest()[:16]}
  del fg, fg_exp

  # ---- box --------------------------------------------------------------
  box = Trainer(box_cfg, device=dev)
  ckpt = box.restore(box_dir)
  if box.step != saver.checkpoint_step(ckpt) or 'mu' not in box.opt_state:
    raise AssertionError(f'box restored step {box.step}')
  gates, f = box_step_gates(
      torch, ts, matching, gk, box.model, box.opt_state,
      first_batch(packed.get_batch, PACKED_KEYS),
      draw_box_randoms(box_cfg, batch, torch.Generator(dev).manual_seed(2)),
      box.step, learn_rate(box_cfg, box.opt_state['count']), box_limits)
  failures += [f'box {x}' for x in f]
  reset_peak(torch, dev)
  box_steps = run_steps(torch, gk, box, chain_batches(
      torch, packed.get_batch, PACKED_KEYS, batch, n_batches), n_steps[1])
  if dev.type == 'cuda':
    # The box's paste, T a forward and T more in the recompute; its
    # constant patch needs no d_p.
    want_launches(box_steps, {'glimpse_extract': 0, 'glimpse_paste': 2 * T},
                  {'glimpse_extract': 0, 'glimpse_paste': 0}, {}, 'box')
  out['box'] = {'weights': os.path.relpath(ckpt, REPO), 'gates': gates,
                'limits': box_limits,
                **steps_summary(torch, box_steps, peak_memory(torch, dev))}

  # ---- full: from the box's controller, then from its checkpoint --------
  full = Trainer(full_cfg, device=dev)
  full.load_pretrained(box.model)
  state = full.model.state_dict()
  for k, v in box.model.state_dict().items():
    if k.startswith('ctrl_') and not torch.equal(state[k], v):
      raise AssertionError(f'load_pretrained left {k} unloaded')
  gates, f = step_gates(
      torch, ts, matching, gk, full.model, full.opt_state,
      first_batch(packed.get_batch, PACKED_KEYS),
      draw_train_randoms(full_cfg, batch, torch.Generator(dev).manual_seed(3)),
      0, learn_rate(full_cfg, 0), full_limits)
  failures += [f'full {x}' for x in f]
  reset_peak(torch, dev)
  data = chain_batches(torch, packed.get_batch, PACKED_KEYS, batch,
                       n_batches)
  pretrained_steps = run_steps(torch, gk, full, data, n_steps[2])
  peak = peak_memory(torch, dev)
  ckpt = full.restore(full_dir)
  restored_steps = run_steps(torch, gk, full, data, n_steps[3])
  if dev.type == 'cuda':
    # T extracts a forward and T in the recompute, 2T as the pastes' d_p;
    # two pastes a timestep, forward and recompute; all on the strip route.
    for steps in (pretrained_steps, restored_steps):
      want_launches(steps, {'glimpse_extract': 4 * T, 'glimpse_paste': 4 * T},
                    {'glimpse_extract': 2 * T, 'glimpse_paste': 0},
                    {'extract_strip_kernel': 4 * T}, 'full')
  out['full'] = {
      'gates': gates, 'limits': full_limits,
      'from_box': steps_summary(torch, pretrained_steps, peak),
      'weights': os.path.relpath(ckpt, REPO),
      'restored': steps_summary(torch, restored_steps,
                                peak_memory(torch, dev))}
  return out, failures


def launches_now(gk):
  """The kernel launches counted since the last reset: forward and
  backward by kernel, extract by route."""
  return {'launches': gk.launch_counts(),
          'backward_launches': gk.launch_counts(backward=True),
          'extract_route_launches': {
              k: v for k, v in gk.glimpse_extract.route_launches.items()
              if v}}


def launch_gate(counts, want):
  """Failures of a stage's launch counts: each (kind, kernel) in ``want``
  must have been launched at least once."""
  return [f'{kind} {name}: {counts[kind].get(name, 0)} launches'
          for kind, name in want if not counts[kind].get(name)]


def state_gate(torch, model, opt_state, path, cfg):
  """Failures of a model and its optimizer state against checkpoint
  ``path``, bit for bit (parameters, BatchNorm statistics, the
  optimizer's count and its moments or trace)."""
  from rec_attend_tpu_torch import convert
  want = convert.params_from_checkpoint(path, cfg)
  got = model.state_dict()
  out = [k for k, v in want.items() if not torch.equal(got[k].cpu(), v)]
  saved = convert.opt_state_from_checkpoint(path, cfg)
  if saved['count'] != opt_state['count']:
    out.append(f'count {opt_state["count"]} against {saved["count"]}')
  for key in set(saved) - {'count'}:
    out += [f'{key}.{k}' for k, v in saved[key].items()
            if not torch.equal(opt_state[key][k].cpu(), v)]
  return out


def csv_example_rows(path):
  """The per-example rows of an analyzer's CSV."""
  with open(path) as f:
    return [r for r in f.read().splitlines() if r.startswith('synth')]


def timed_calls(torch, dev, fn, seconds):
  """``fn`` that appends the host seconds of each call, the device
  synchronised at its end, to ``seconds``."""
  from rec_attend_tpu_torch.device import synchronize

  def call(*args, **kw):
    t0 = time.time()
    out = fn(*args, **kw)
    synchronize(dev)
    seconds.append(time.time() - t0)
    return out
  return call


def transposed_plain(torch):
  """Plain glimpses with the window transposed (f_y and f_x swapped, for
  square images and glimpses): the negative control of the eval step's
  gate, a kernel that indexes its window the wrong way round."""
  return (lambda x, f_y, f_x: torch.einsum('bhf,bhwd,bwg->bfgd', f_x, x,
                                           f_y),
          lambda p, f_y, f_x: torch.einsum('bhf,bfgd,bwg->bhwd', f_x, p,
                                           f_y))


def eval_step_metrics(torch, ts, matching, model, batch, glimpse,
                      pinned=None):
  """One eval step, cuDNN deterministic: ({metric: float}, its Hungarian
  solves).  With pinned (another step's solves) the solves return those
  answers instead."""
  solved = []

  def solve_fn(solve, w):
    solved.append(solve(w) if pinned is None else pinned[len(solved)])
    return solved[-1]
  with hungarian_calls(matching, solve_fn), deterministic_cudnn(torch):
    metrics = ts.eval_step(model, batch, None, glimpse)
  return {k: float(v) for k, v in metrics.items()}, solved


def metrics_rel_diff(got, want):
  """{metric: relative difference} of the EVAL_STEP_METRICS."""
  return {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
          for k in EVAL_STEP_METRICS}


def pipeline_phase(torch, gk, dev, scale='paper',
                   examples=PIPELINE_EXAMPLES, steps=PIPELINE_STEPS,
                   cli_examples=PIPELINE_CLI_EXAMPLES):
  """The port's synth pipeline (``run_pipeline.run_synth``'s stages)
  at ``scale`` on ``dev``, its step counts cut: the box model's
  ``TrainingExperiment`` with the split on the device, the full model's
  from the box's last checkpoint with the host-fed, prefetched path, each
  ``steps`` steps (checkpoints every PIPELINE_CKPT_STEPS, valid and
  trainval passes every PIPELINE_EVAL_STEPS), then the eval command line on
  the valid split, then a restore of the full run that takes two more
  steps.  Results and logs go to a temporary folder in the checkout,
  removed after.  Returns (results, the gates' failures); each gate's
  control must fail, else it is a failure too."""
  import numpy as np

  from rec_attend_tpu_torch import convert
  from rec_attend_tpu_torch import train_step as ts
  from rec_attend_tpu_torch.cli import eval as eval_cli
  from rec_attend_tpu_torch.config import BoxModelConfig
  from rec_attend_tpu_torch.config import DataConfig
  from rec_attend_tpu_torch.config import FullModelConfig
  from rec_attend_tpu_torch.data import provider
  from rec_attend_tpu_torch.engine.experiment import EvalExperiment
  from rec_attend_tpu_torch.engine.experiment import TrainingExperiment
  from rec_attend_tpu_torch.models.full_model import CTRL_NETS
  from rec_attend_tpu_torch.models.full_model import FullModel
  from rec_attend_tpu_torch.models.full_model import learn_rate
  from rec_attend_tpu_torch.ops import matching
  from rec_attend_tpu_torch.pipelines import run_pipeline

  out, failures = {}, []
  cuda = dev.type == 'cuda'

  def gate(name, got, control):
    return gate_with_control(failures, name, got, control)

  with tempfile.TemporaryDirectory(prefix='.chip_smoke_pipeline-',
                                   dir=REPO) as root:
    results = os.path.join(root, 'results')
    data_cfg, box_cfg, full_base, train_cfg, _ = run_pipeline.synth_stages(
        scale, results, os.path.join(root, 'logs'), num_steps=steps)
    data_cfg = data_cfg.replace(num_examples=examples)
    train_cfg = train_cfg.replace(
        steps_per_ckpt=PIPELINE_CKPT_STEPS, steps_per_log=PIPELINE_LOG_STEPS,
        steps_per_valid=PIPELINE_EVAL_STEPS,
        steps_per_trainval=PIPELINE_EVAL_STEPS, num_batch_valid=1,
        prefetch=True)
    ckpts = [s for s in range(PIPELINE_CKPT_STEPS, steps + 1,
                              PIPELINE_CKPT_STEPS)][-2:]

    def stage(spec, cfg, tcfg):
      reset_peak(torch, dev)
      gk.reset_launch_counts()
      t0 = time.time()
      exp = TrainingExperiment(spec, cfg, tcfg, data_cfg, device=dev)
      setup = time.time() - t0
      valid_s, ckpt_s = [], []
      exp._eval_pass = timed_calls(torch, dev, exp._eval_pass, valid_s)
      exp.checkpoint = timed_calls(torch, dev, exp.checkpoint, ckpt_s)
      return exp, {'setup_seconds': setup, 'eval_pass_seconds': valid_s,
                   'checkpoint_seconds': ckpt_s}

    def finish(exp, summary):
      t0 = time.time()
      exp.run()
      exp.close()
      summary['run_seconds'] = time.time() - t0
      summary.update(launches_now(gk))
      summary['max_memory_allocated_bytes'] = peak_memory(torch, dev)
      with open(os.path.join(exp.logs_folder, 'step_time.csv')) as f:
        summary['step_ms_at_log'] = {
            int(r.split(',')[0]): float(r.split(',')[2])
            for r in f.read().splitlines()[1:]}
      with open(os.path.join(exp.logs_folder, 'loss.csv')) as f:
        losses = [float(r.split(',')[2]) for r in f.read().splitlines()[1:]
                  if r.split(',')[2]]
      summary['train_loss_at_log'] = losses
      if not all(math.isfinite(v) for v in losses):
        failures.append(f'{exp.model_id}: loss {losses}')
      kept = [s for s, _ in exp.saver.list_ckpts()]
      summary['checkpoints'] = kept
      return summary

    def kept_failures(listing):
      return [] if listing == ckpts else [f'{listing}, want {ckpts}']

    def ckpt_gates(exp, cfg, summary):
      kept = summary['checkpoints']
      summary['kept_gate'] = gate(
          f'{exp.model_id} kept checkpoints', kept_failures(kept),
          kept_failures(sorted(kept + [PIPELINE_CKPT_STEPS])))
      last, before = (os.path.join(exp.folder, f'ckpt-{s}.npz')
                      for s in (ckpts[-1], ckpts[-2]))
      model, opt = exp.trainer.model, exp.trainer.opt_state
      summary['state_gate'] = gate(
          f'{exp.model_id} live state against ckpt-{ckpts[-1]}',
          state_gate(torch, model, opt, last, cfg),
          state_gate(torch, model, opt, before, cfg))
      path = os.path.join(exp.folder, 'model_opt.yaml')
      other = (BoxModelConfig if isinstance(cfg, FullModelConfig)
               else FullModelConfig)
      summary['yaml_gate'] = gate(
          f'{exp.model_id} model_opt.yaml',
          [] if type(cfg).from_yaml(path) == cfg else ['differs'],
          [] if other.from_yaml(path) == cfg else [f'as {other.__name__}'])
      data_path = os.path.join(exp.folder, 'data_opt.yaml')
      if DataConfig.from_yaml(data_path) != data_cfg:
        failures.append(f'{exp.model_id} data_opt.yaml differs')

    # ---- box: the split on the device -----------------------------------
    box, out['box'] = stage('box', box_cfg, train_cfg.replace(
        model_id='box_model_synth-chip', device_data=True))
    out['box']['device_split_bytes'] = sum(
        v.numel() * v.element_size() for v in box.device_train_data.values())
    finish(box, out['box'])
    ckpt_gates(box, box_cfg, out['box'])
    _, box_ckpt = box.saver.get_latest_ckpt()
    bs = train_cfg.batch_size
    n_train = box.train_ds.get_dataset_size()
    idx = np.random.RandomState(0).permutation(n_train)[:bs]
    out['box']['gather_gate'] = gate(
        'box device split gather against the host batch',
        split_gather_diff(torch, ts, box, idx, idx),
        split_gather_diff(torch, ts, box, idx, (idx + 1) % n_train))

    # ---- full: from the box's last checkpoint, host-fed -----------------
    full_cfg = full_base.replace(pretrain_ctrl_net=box_ckpt)
    full_train_cfg = train_cfg.replace(model_id='full_model_synth-chip',
                                       device_data=False)
    full, out['full'] = stage('full', full_cfg, full_train_cfg)
    box_state = convert.params_from_checkpoint(box_ckpt, box_cfg)

    def ctrl_diff(model):
      state = model.state_dict()
      return [k for k, v in box_state.items() if k.split('.')[0] in CTRL_NETS
              and not torch.equal(state[k].cpu(), v)]
    out['full']['pretrained_gate'] = gate(
        'full step 0 controller against the box checkpoint',
        ctrl_diff(full.trainer.model),
        ctrl_diff(FullModel(full_base, device=dev)))
    finish(full, out['full'])
    ckpt_gates(full, full_cfg, out['full'])

    # ---- the trained full model's eval step, kernel against plain -------
    n_valid = full.valid_ds.get_dataset_size()
    valid_batch = full._device_batch(full.make_batch_fn(
        full.valid_ds, full_cfg.timespan)(np.arange(min(bs, n_valid))))
    model = full.trainer.model
    plain, plain_solved = eval_step_metrics(torch, ts, matching, model,
                                            valid_batch, 'plain')
    floor, _ = eval_step_metrics(torch, ts, matching, model, valid_batch,
                                 reordered_plain(torch))
    gk.reset_launch_counts()
    kernel, kernel_solved = eval_step_metrics(torch, ts, matching, model,
                                              valid_batch, 'kernel')
    eval_step = {'kernel': kernel, 'plain': plain,
                 'reordered_plain_rel_diff': metrics_rel_diff(floor, plain),
                 'solves_agree': len(kernel_solved) == len(plain_solved)
                 and all(np.array_equal(u, v) for a, b in zip(
                     kernel_solved, plain_solved) for u, v in zip(a, b)),
                 **launches_now(gk)}
    if not eval_step['solves_agree']:
      kernel, _ = eval_step_metrics(torch, ts, matching, model, valid_batch,
                                    'kernel', pinned=plain_solved)
    control, _ = eval_step_metrics(torch, ts, matching, model, valid_batch,
                                   transposed_plain(torch),
                                   pinned=plain_solved)
    eval_step['kernel_rel_diff'] = metrics_rel_diff(kernel, plain)
    eval_step['control_rel_diff'] = metrics_rel_diff(control, plain)

    def over(diff):
      return [f'{k} {v:.3g}' for k, v in diff.items()
              if not v <= EVAL_STEP_REL_LIMIT]
    eval_step['gate'] = gate('full eval step, kernel against plain',
                             over(eval_step['kernel_rel_diff']),
                             over(eval_step['control_rel_diff']))
    out['full']['eval_step'] = eval_step

    # The launch gates' control: a plain train step and eval step of the
    # full model, which must launch no kernel.
    gk.reset_launch_counts()
    draws = full.trainer.family.draws(
        full_cfg, bs, torch.Generator(device=dev).manual_seed(1))
    one_step(torch, ts, matching, model, full.trainer.opt_state,
             valid_batch, draws, full.step, 'plain')
    eval_step_metrics(torch, ts, matching, model, valid_batch, 'plain')
    plain_counts = launches_now(gk)
    out['plain_launches'] = plain_counts
    if cuda:
      want = [('launches', 'glimpse_paste')]
      out['box']['launch_gate'] = gate(
          'box launches', launch_gate(out['box'], want),
          launch_gate(plain_counts, want))
      want = [('launches', 'glimpse_extract'), ('launches', 'glimpse_paste'),
              ('backward_launches', 'glimpse_extract'),
              ('extract_route_launches', 'extract_tiled_kernel')]
      out['full']['launch_gate'] = gate(
          'full launches', launch_gate(out['full'], want),
          launch_gate(plain_counts, want))

    # ---- eval: the command line on the valid split ----------------------
    gk.reset_launch_counts()
    argv = ['--model_id', full.model_id, '--results', results,
            '--dataset', 'synth', '--split', 'valid',
            '--batch_size', str(train_cfg.batch_size)]
    t0 = time.time()
    eval_cli.full_main(argv, device=dev)
    out['eval'] = {'seconds': time.time() - t0, **launches_now(gk)}
    csvs = os.path.join(full.folder, 'output_valid')
    rows = csv_example_rows(os.path.join(csvs, 'sbd.csv'))
    eval_cli.full_main(argv + ['--max_batches', '0', '--output',
                               os.path.join(root, 'control')], device=dev)
    control_rows = csv_example_rows(os.path.join(root, 'control', 'sbd.csv'))
    out['eval']['rows_gate'] = gate(
        'eval sbd.csv rows', (
            [] if len(rows) == n_valid else [f'{len(rows)} rows']), (
                [] if len(control_rows) == n_valid else ['no rows']))
    sbd = [float(r.split(',')[1]) for r in rows]
    out['eval']['sbd'] = statistics.mean(sbd) if sbd else None
    if not all(math.isfinite(v) for v in sbd):
      failures.append(f'eval sbd {sbd}')
    if cuda:
      want = [('launches', 'glimpse_extract'), ('launches', 'glimpse_paste')]
      out['eval']['launch_gate'] = gate(
          'eval launches', launch_gate(out['eval'], want),
          launch_gate(plain_counts, want))

    # ---- the eval command line on a trained model: the flagship ---------
    # A results folder with its checkpoint, its model_opt.yaml and the data
    # snapshot of the run that trained it (run_synth --scale paper; a
    # checkout holds no data_opt.yaml there).  The command line's first
    # images of the valid split, against eval_split with the plain glimpses
    # over the same images, both with cuDNN deterministic (its default
    # algorithms moved one image's SBD by 4e-3, PR 15 run 4).
    flagship = os.path.basename(CHECKPOINT_DIR)
    flagship_dir = os.path.join(root, 'flagship_results', flagship)
    os.makedirs(flagship_dir)
    for name in ('ckpt-30000.npz', 'model_opt.yaml'):
      os.symlink(os.path.join(CHECKPOINT_DIR, name),
                 os.path.join(flagship_dir, name))
    flagship_data = run_pipeline.synth_stages('paper')[0]
    flagship_data.save_yaml(os.path.join(flagship_dir, 'data_opt.yaml'))
    cli_out = os.path.join(root, 'flagship_cli')
    t0 = time.time()
    with deterministic_cudnn(torch):
      eval_cli.full_main(
          ['--model_id', flagship, '--results',
           os.path.dirname(flagship_dir), '--dataset', 'synth', '--split',
           'valid', '--batch_size', str(cli_examples), '--max_batches', '1',
           '--threshold_list', str(EVAL_THRESHOLD), '--score_threshold',
           str(EVAL_THRESHOLD), '--output', cli_out], device=dev)
    cli = {'seconds': time.time() - t0}
    plain_exp = EvalExperiment(flagship_dir, device=dev, glimpse='plain')

    def plain_scores(split):
      folder = os.path.join(root, f'flagship_plain_{split}')
      with deterministic_cudnn(torch):
        eval_cli.eval_split(
            plain_exp, provider.get('synth', flagship_data, split=split),
            folder, [EVAL_THRESHOLD], eval_cli.DEFAULT_ANALYZERS,
            batch_size=cli_examples, score_threshold=EVAL_THRESHOLD,
            max_batches=1)
      return {name: read_scores(folder, name) for name in ('sbd', 'dic')}
    got = {name: read_scores(cli_out, name) for name in ('sbd', 'dic')}

    def cli_diff(want):
      if sorted(got['sbd']) != sorted(want['sbd']):
        return [f'ids {sorted(got["sbd"])}']
      return ([f'{k} sbd {got["sbd"][k]} against {want["sbd"][k]}'
               for k in want['sbd'] if not abs(
                   got['sbd'][k] - want['sbd'][k]) <= PIPELINE_CLI_SBD_LIMIT]
              + [f'{k} dic {got["dic"][k]} against {want["dic"][k]}'
                 for k in want['dic'] if got['dic'][k] != want['dic'][k]])
    cli.update(examples=len(got['sbd']), sbd=got['sbd'], dic=got['dic'],
               sbd_mean=statistics.mean(got['sbd'].values()))
    cli['gate'] = gate('flagship eval command line against plain eval_split',
                       cli_diff(plain_scores('valid')),
                       cli_diff(plain_scores('test')))
    if len(got['sbd']) != cli_examples or not cli['sbd_mean'] > 0:
      failures.append(f'flagship eval command line: {got["sbd"]}')
    out['eval']['flagship_cli'] = cli

    # ---- restore: the full run goes on from its last checkpoint ---------
    last = os.path.join(full.folder, f'ckpt-{ckpts[-1]}.npz')
    before = os.path.join(full.folder, f'ckpt-{ckpts[-2]}.npz')
    gk.reset_launch_counts()
    t0 = time.time()
    again = TrainingExperiment('full', full_cfg, full_train_cfg.replace(
        restore=full.folder, num_steps=steps + 2), data_cfg, device=dev)
    restore_setup = time.time() - t0
    restore_s = []
    timed_calls(torch, dev, again.restore_ckpt, restore_s)()
    restored = {'setup_seconds': restore_setup,
                'restore_seconds': restore_s[0], 'step': again.step}
    restored['state_gate'] = gate(
        f'restored state against ckpt-{ckpts[-1]}', (
            ([] if again.step == ckpts[-1] else [f'step {again.step}'])
            + state_gate(torch, again.trainer.model, again.trainer.opt_state,
                         last, full_cfg)),
        state_gate(torch, again.trainer.model, again.trainer.opt_state,
                   before, full_cfg))

    # The restored run's next step against the same step from the live
    # state (on copies: neither run moves).
    train_batch = again._device_batch(again.make_batch_fn(
        again.train_ds, full_cfg.timespan)(np.arange(bs)))
    draws = full.trainer.family.draws(
        full_cfg, bs, torch.Generator(device=dev).manual_seed(2))

    def step_from(model, opt_state):
      with deterministic_cudnn(torch):
        return one_step(torch, ts, matching, model, opt_state, train_batch,
                        draws, again.step, 'kernel')
    live = step_from(full.trainer.model, full.trainer.opt_state)
    lr = learn_rate(full_cfg, full.trainer.opt_state['count'])
    stats = step_diff(torch, model, step_from(
        again.trainer.model, again.trainer.opt_state), live, lr)
    control = step_diff(torch, model, step_from(
        again.trainer.model, ts.init_opt_state(again.trainer.model)), live,
        lr)
    restored['step_gate'] = gate(
        'restored step against the live step',
        step_gate_failures(stats, RESTORED_STEP_LIMITS)
        + [f'matchings differ {v}' for v in [stats['matches_differ']]
           if any(v.values())],
        step_gate_failures(control, RESTORED_STEP_LIMITS))
    restored['step_stats'] = {k: stats[k] for k in RESTORED_STEP_LIMITS}
    restored['control_stats'] = {k: control[k] for k in RESTORED_STEP_LIMITS}
    again.run()
    again.close()
    restored.update(launches_now(gk))
    with open(os.path.join(again.logs_folder, 'loss.csv')) as f:
      tail = {int(r.split(',')[0]): float(r.split(',')[2])
              for r in f.read().splitlines()[1:] if r.split(',')[2]}
    restored['losses_after'] = {s: v for s, v in tail.items()
                                if s > ckpts[-1]}
    if (again.step != steps + 2 or sorted(restored['losses_after'])
        != [steps + 1, steps + 2] or not all(
            math.isfinite(v) for v in restored['losses_after'].values())):
      failures.append(f'restored run: step {again.step}, losses '
                      f'{restored["losses_after"]}')
    out['restored'] = restored
    out['folders'] = {'box': box.model_id, 'full': full.model_id}
  return out, failures


def split_gather_diff(torch, ts, exp, idx, host_idx):
  """The batch keys whose index gather ``idx`` from the experiment's split
  on the device differs from ``encode_batch`` of the host's batch of
  ``host_idx``, bit for bit."""
  got = {k: v.index_select(0, torch.from_numpy(idx).to(exp.device)).cpu()
         for k, v in exp.device_train_data.items()}
  want = ts.encode_batch(exp.make_batch_fn(
      exp.train_ds, getattr(exp.model_cfg, 'timespan', None))(host_idx))
  return [k for k in want if not (
      got[k].dtype == torch.from_numpy(want[k]).dtype
      and torch.equal(got[k], torch.from_numpy(want[k])))]


def gate_with_control(failures, name, got, control):
  """A gate's failures, and its control's, which must fail: both are
  added to ``failures`` (the control's as one line, if it passed)."""
  failures.extend(f'{name}: {x}' for x in got)
  if not control:
    failures.append(f'{name}: its control passed')
  return {'failures': got, 'control_failures': control[:3]}


@contextlib.contextmanager
def patched(owner, name, wrap):
  """``owner.name`` replaced by ``wrap(owner.name)`` inside the block."""
  saved = getattr(owner, name)
  setattr(owner, name, wrap(saved))
  try:
    yield
  finally:
    setattr(owner, name, saved)


def counts_delta(before, after):
  """The launches between two ``launches_now`` readings (extract routes
  with none left out)."""
  out = {kind: {k: v - before[kind].get(k, 0) for k, v in after[kind].items()}
         for kind in ('launches', 'backward_launches')}
  routes = after['extract_route_launches']
  out['extract_route_launches'] = {
      k: v - before['extract_route_launches'].get(k, 0)
      for k, v in routes.items()
      if v != before['extract_route_launches'].get(k, 0)}
  return out


@contextlib.contextmanager
def recorded_runs(torch, gk, dev, before=None):
  """Inside the block, each ``TrainingExperiment.run`` is recorded: the
  experiment, its start step, its seconds, its peak memory, its kernel
  launches (valid and trainval passes included) and, per train step, the
  kernel launches (``counts_delta`` around the step).  ``before(exp)``, if
  given, is called as each run starts.  Yields the list of records."""
  from rec_attend_tpu_torch.engine.experiment import TrainingExperiment
  from rec_attend_tpu_torch.engine.trainer import Trainer
  runs = []

  def record_run(run):
    def call(exp):
      rec = {'exp': exp, 'spec': exp.spec.name, 'start_step': exp.step,
             'step_launches': []}
      runs.append(rec)
      if before is not None:
        before(exp)
      reset_peak(torch, dev)
      start = launches_now(gk)
      t0 = time.time()
      out = run(exp)
      rec['run_seconds'] = time.time() - t0
      rec['max_memory_allocated_bytes'] = peak_memory(torch, dev)
      rec['launches_at_end'] = launches_now(gk)
      rec['run_launches'] = counts_delta(start, rec['launches_at_end'])
      return out
    return call

  def record_step(step):
    def call(trainer, batch):
      before = launches_now(gk)
      out = step(trainer, batch)
      if runs:
        runs[-1]['step_launches'].append(counts_delta(before,
                                                      launches_now(gk)))
      return out
    return call
  with patched(TrainingExperiment, 'run', record_run), \
      patched(Trainer, 'train_step', record_step):
    yield runs


def log_rows(logs_folder, name):
  """{step: first value} of a run's log CSV, the rows that have one."""
  with open(os.path.join(logs_folder, f'{name}.csv')) as f:
    rows = [r.split(',') for r in f.read().splitlines()[1:]]
  return {int(r[0]): float(r[2]) for r in rows if r[2]}


def run_child(cmd, log_path, timeout):
  """Run ``cmd`` from the checkout (the port on its path), its output to
  ``log_path``: (exit code, seconds, its peak resident memory in bytes).
  Killed at ``timeout`` seconds."""
  env = dict(os.environ)
  env['PYTHONPATH'] = os.pathsep.join(
      [REPO] + ([env['PYTHONPATH']] if env.get('PYTHONPATH') else []))
  t0 = time.time()
  with open(log_path, 'w') as log:
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log,
                            stderr=subprocess.STDOUT)
  while True:
    pid, status, usage = os.wait4(proc.pid, os.WNOHANG)
    if pid:
      break
    if time.time() - t0 > timeout:
      proc.kill()
      _, status, usage = os.wait4(proc.pid, 0)
      break
    time.sleep(0.2)
  proc.returncode = os.waitstatus_to_exitcode(status)
  return proc.returncode, time.time() - t0, usage.ru_maxrss * 1024


def synth3_cut(examples):
  """A wrapper of ``run_pipeline.synth3_stages`` for ``patched``: the
  stages' configs with the phase's scale cut, ``examples`` train examples,
  checkpoints, log rows and one-batch valid and trainval passes on the
  synth pipeline's cadence, and each split on the device."""
  def wrap(stages):
    def call(*args, **kw):
      data_cfg, fg_cfg, box_cfg, full_base, train_cfg, steps = stages(
          *args, **kw)
      return (data_cfg.replace(num_examples=examples), fg_cfg, box_cfg,
              full_base, train_cfg.replace(
                  steps_per_ckpt=PIPELINE_CKPT_STEPS,
                  steps_per_log=PIPELINE_LOG_STEPS,
                  steps_per_valid=PIPELINE_EVAL_STEPS,
                  steps_per_trainval=PIPELINE_EVAL_STEPS, num_batch_valid=1,
                  device_data=True), steps)
    return call
  return wrap


def synth3_child(spec_path):
  """The second process of the ``synth3_pipeline`` phase, ``chip_smoke.py
  synth3-child SPEC``: ``run_pipeline.main`` on the spec's 'argv' and
  'device', its scale cut (``synth3_cut`` of 'examples'), inside
  ``recorded_runs``.  Writes to the spec's 'out' the stages' ids, each
  run's record and the launches of the stages after the runs (eval), and
  to its 'split' the box stage's d_in and y_in as they lie on the device."""
  import numpy as np
  import torch

  from rec_attend_tpu_torch.ops.cuda import glimpse as gk
  from rec_attend_tpu_torch.pipelines import run_pipeline
  with open(spec_path) as f:
    spec = json.load(f)
  dev = torch.device(spec['device'])
  # As in the script's process.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  if dev.type == 'cpu':
    torch.set_num_threads(1)
  split = {}

  def keep_split(exp):
    if exp.spec.name == 'box':
      split.update({k: exp.device_train_data[k].cpu().numpy()
                    for k in ('d_in', 'y_in')})
  gk.reset_launch_counts()
  t0 = time.time()
  with recorded_runs(torch, gk, dev, keep_split) as runs, patched(
      run_pipeline, 'synth3_stages', synth3_cut(spec['examples'])):
    ids = run_pipeline.main(spec['argv'], device=dev)
  seconds = time.time() - t0
  np.savez(spec['split'], **split)
  records = [{'model_id': r['exp'].model_id,
              **{k: v for k, v in r.items() if k != 'exp'}} for r in runs]
  with open(spec['out'], 'w') as f:
    json.dump({'ids': ids, 'seconds': seconds, 'runs': records,
               'after_runs': counts_delta(runs[-1]['launches_at_end'],
                                          launches_now(gk))}, f)


def synth3_pipeline_phase(torch, gk, dev, scale='paper',
                          examples=SYNTH3_EXAMPLES, steps=SYNTH3_STEPS,
                          cli_examples=SYNTH3_CLI_EXAMPLES):
  """The port's synth3 pipeline (``run_pipeline.run_synth3``) at ``scale``
  on ``dev`` through ``run_pipeline.main``, its scale cut (``synth3_cut``
  of ``examples``, ``steps`` steps a stage), each split on the device:
  ``--stages fg,pack`` in this process, ``--stages box,full,eval`` in a
  ``chip_smoke.py synth3-child`` process (the pack crosses in its files;
  the child counts its own launches), then a ``--resume`` relaunch that
  goes on with the full stage.  Results, logs and pack files go to a
  temporary folder in the checkout, removed after.  Returns (results, the
  gates' failures); each gate's control must fail, else it is a failure
  too."""
  import numpy as np

  from rec_attend_tpu_torch import train_step as ts
  from rec_attend_tpu_torch.cli import eval as eval_cli
  from rec_attend_tpu_torch.cli.pack import quantise
  from rec_attend_tpu_torch.config import DataConfig
  from rec_attend_tpu_torch.config import FullModelConfig
  from rec_attend_tpu_torch.data import provider
  from rec_attend_tpu_torch.data.provider import PackedDataset
  from rec_attend_tpu_torch.engine.experiment import EvalExperiment
  from rec_attend_tpu_torch.engine.saver import list_checkpoints
  from rec_attend_tpu_torch.ops import matching
  from rec_attend_tpu_torch.pipelines import eval_fg_metrics
  from rec_attend_tpu_torch.pipelines import run_pipeline
  from rec_attend_tpu_torch.utils import logger

  out, failures = {}, []
  cuda = dev.type == 'cuda'

  def gate(name, got, control):
    return gate_with_control(failures, name, got, control)

  def check(name, problems):
    failures.extend(f'{name}: {x}' for x in problems)

  def kept_diff(listing, want):
    return [] if listing == want else [f'{listing}, want {want}']

  start = time.time()
  with tempfile.TemporaryDirectory(prefix='.chip_smoke_synth3-',
                                   dir=REPO) as root:
    results, logs, data = (os.path.join(root, d)
                           for d in ('results', 'logs', 'data'))
    argv = ['--dataset', 'synth3', '--scale', scale, '--results', results,
            '--logs', logs, '--dataset_folder', data, '--model_id', 'chip',
            '--data_examples', str(examples), '--fg_steps', str(steps),
            '--box_steps', str(steps), '--full_steps', str(steps)]
    cut = synth3_cut(examples)
    data_cfg, _, _, full_base, train_cfg, _ = cut(run_pipeline.synth3_stages)(
        scale, results, logs, data, data_examples=examples)
    T, bs = full_base.timespan, train_cfg.batch_size
    ckpts = list(range(PIPELINE_CKPT_STEPS, steps + 1,
                       PIPELINE_CKPT_STEPS))[-2:]

    def stage_summary(model_id, rec):
      """Step ms and losses at the log cadence, the kept checkpoints, and
      the run's record."""
      folder = os.path.join(logs, model_id)
      summary = {'step_ms_at_log': log_rows(folder, 'step_time'),
                 'train_loss_at_log': log_rows(folder, 'loss')}
      losses = list(summary['train_loss_at_log'].values())
      if not losses or not all(math.isfinite(v) for v in losses):
        failures.append(f'{model_id}: loss {losses}')
      summary['checkpoints'] = [s for s, _ in list_checkpoints(
          os.path.join(results, model_id))]
      summary.update({k: rec[k] for k in (
          'start_step', 'run_seconds', 'max_memory_allocated_bytes',
          'run_launches')})
      return summary

    # ---- fg, pack: this process -----------------------------------------
    gk.reset_launch_counts()
    pack_seconds = []
    with recorded_runs(torch, gk, dev) as runs, patched(
        run_pipeline, 'synth3_stages', cut), patched(
            run_pipeline.pack_cli, 'fg_main',
            lambda fn: timed_calls(torch, dev, fn, pack_seconds)):
      t0 = time.time()
      ids = run_pipeline.main(argv + ['--stages', 'fg,pack'], device=dev)
      first_seconds = time.time() - t0
    (fg_run,) = runs
    fg = fg_run['exp']
    out['fg'] = {**stage_summary(ids['fg'], fg_run), **launches_now(gk),
                 'device_split_bytes': sum(
                     v.numel() * v.element_size()
                     for v in fg.device_train_data.values())}
    check('fg checkpoints', kept_diff(out['fg']['checkpoints'], ckpts))
    out['pack'] = {'seconds': pack_seconds[0], 'bytes': {
        s: os.path.getsize(provider.pack_path(data_cfg, s))
        for s in ('train', 'valid')}}
    out['first_process_seconds'] = first_seconds
    n_train = fg.train_ds.get_dataset_size()
    idx = np.random.RandomState(0).permutation(n_train)[:bs]
    out['fg']['split_gate'] = gate(
        'fg device split against the host batch',
        split_gather_diff(torch, ts, fg, idx, idx),
        split_gather_diff(torch, ts, fg, idx, (idx + 1) % n_train))

    # ---- box, full, eval: a child process -------------------------------
    spec = {'argv': argv + ['--stages', 'box,full,eval'],
            'device': dev.type, 'examples': examples,
            'out': os.path.join(root, 'child.json'),
            'split': os.path.join(root, 'child_box_split.npz')}
    spec_path = os.path.join(root, 'child_spec.json')
    with open(spec_path, 'w') as f:
      json.dump(spec, f)
    cmd = [sys.executable, os.path.abspath(__file__), 'synth3-child',
           spec_path]
    child_log = os.path.join(root, 'child.log')
    rc, seconds, rss = run_child(cmd, child_log, SYNTH3_CHILD_TIMEOUT)
    out['child'] = {'command': ' '.join(cmd[1:]).replace(root, '<tmp>'),
                    'exit_code': rc, 'seconds': seconds,
                    'peak_host_rss_bytes': rss}
    if rc != 0:
      with open(child_log) as f:
        tail = f.read()[-3000:]
      raise AssertionError(f'the box,full,eval process exited {rc}: {tail}')
    with open(spec['out']) as f:
      child = json.load(f)
    child_runs = {r['spec']: r for r in child['runs']}
    if sorted(child_runs) != ['box', 'full'] or any(
        child['ids'][k] != ids[k] for k in ('fg', 'box', 'full')):
      failures.append(f'the child ran {sorted(child_runs)} of {child["ids"]}')
    out['child'].update(pipeline_seconds=child['seconds'],
                        eval_launches=child['after_runs'])
    for stage in ('box', 'full'):
      out[stage] = stage_summary(ids[stage], child_runs[stage])
      check(f'{stage} checkpoints', kept_diff(out[stage]['checkpoints'],
                                               ckpts))
    full_folder = os.path.join(results, ids['full'])
    n_valid = max(examples // 4, 8)
    for tt in SYNTH3_THRESHOLDS.split(','):
      rows = csv_example_rows(os.path.join(
          full_folder, 'output_valid', f'sbd_{int(float(tt) * 100):02d}.csv'))
      if len(rows) != n_valid:
        failures.append(f'eval sbd at {tt}: {len(rows)} rows')
    out['eval'] = {'sbd': {tt: read_scores(
        os.path.join(full_folder, 'output_valid'),
        f'sbd_{int(float(tt) * 100):02d}') for tt in
        SYNTH3_THRESHOLDS.split(',')}}

    # ---- box: its split on the device against the pack file -------------
    with np.load(provider.pack_path(data_cfg, 'train')) as f:
      packed = {'d_in': f['d_out'], 'y_in': f['y_out']}
    with np.load(spec['split']) as f:
      resident = {k: f[k] for k in f.files}

    def pack_diff(want):
      return [k for k in packed if not (
          k in resident and resident[k].dtype == want[k].dtype
          and np.array_equal(resident[k], want[k]))]
    out['box']['pack_gate'] = gate(
        'box device split d_in, y_in against the pack file',
        pack_diff(packed),
        pack_diff({k: np.roll(v, 1, axis=0) for k, v in packed.items()}))

    # ---- fg metrics: the card's against the CPU's -----------------------
    fg_folder = os.path.join(results, ids['fg'])
    with open(os.path.join(fg_folder, 'fg_metrics_valid.json')) as f:
      card = json.load(f)
    metrics_argv = ['--model_id', ids['fg'], '--results', results,
                    '--batch_size', str(bs), '--dataset_folder', data,
                    '--data_examples', str(examples)]
    t0 = time.time()
    cpu = eval_fg_metrics.main(metrics_argv, device='cpu')
    cpu_seconds = time.time() - t0
    other = eval_fg_metrics.main(metrics_argv + ['--split', 'test'],
                                 device='cpu')

    def metrics_diff(want):
      return [f'{k} {card[k]} against {want[k]}' for k in FG_METRICS
              if not abs(card[k] - want[k]) <= SYNTH3_METRICS_LIMIT]
    out['fg_metrics'] = {'card': card, 'cpu': cpu, 'cpu_test_split': other,
                         'cpu_seconds': cpu_seconds}
    out['fg_metrics']['gate'] = gate(
        'fg_metrics_valid.json, card against CPU', metrics_diff(cpu),
        metrics_diff(other))

    # ---- full: a --resume relaunch goes on from its checkpoint ----------
    log = logger.get()
    with recorded_runs(torch, gk, dev) as runs, patched(
        run_pipeline, 'synth3_stages', cut):
      gk.reset_launch_counts()
      t0 = time.time()
      again = run_pipeline.main(
          argv + ['--stages', 'fg,pack,box,full', '--resume',
                  '--full_steps', str(steps + SYNTH3_MORE_STEPS)],
          device=dev)
      resumed_seconds = time.time() - t0
    (full_run,) = runs
    full = full_run['exp']
    out['resumed'] = {'stages': again['stages'], 'seconds': resumed_seconds,
                      **stage_summary(ids['full'], full_run),
                      **launches_now(gk)}

    def resumed_diff(stages, start, end):
      return (([] if stages == ['full'] else [f'stages {stages}'])
              + ([] if start == steps else [f'started at step {start}'])
              + ([] if end == steps + SYNTH3_MORE_STEPS else
                 [f'ended at step {end}']))
    # Control: the prefix with the valid split's pack file gone, and the
    # step a run without --resume starts from.
    valid_pack = provider.pack_path(data_cfg, 'valid')
    os.rename(valid_pack, valid_pack + '.aside')
    kept = run_pipeline._skip_completed_prefix(
        argparse.Namespace(resume=True, results=results),
        {'fg', 'pack', 'box', 'full'}, ids['full'], data_cfg, log)
    os.rename(valid_pack + '.aside', valid_pack)
    fresh = run_pipeline._restore_folder(
        argparse.Namespace(resume=False, results=results), ids['full'])
    out['resumed']['gate'] = gate(
        'the --resume relaunch', resumed_diff(
            again['stages'], full_run['start_step'], full.step),
        resumed_diff([s for s in run_pipeline.SYNTH3_STAGES if s in kept],
                     0 if fresh is None else steps, full.step))

    # ---- launches per step ----------------------------------------------
    valid_batch = full._device_batch(full.make_batch_fn(
        full.valid_ds, T)(np.arange(bs)))
    draws = full.trainer.family.draws(
        full.model_cfg, bs, torch.Generator(device=dev).manual_seed(1))
    before = launches_now(gk)
    one_step(torch, ts, matching, full.trainer.model, full.trainer.opt_state,
             valid_batch, draws, full.step, 'plain')
    plain_step = counts_delta(before, launches_now(gk))
    out['plain_step_launches'] = plain_step
    none = {'glimpse_extract': 0, 'glimpse_paste': 0}
    want = {
        'fg': {'launches': none, 'backward_launches': none,
               'extract_route_launches': {}},
        'box': {'launches': dict(none, glimpse_paste=2 * T),
                'backward_launches': none, 'extract_route_launches': {}},
        'full': {'launches': {'glimpse_extract': 4 * T,
                              'glimpse_paste': 4 * T},
                 'backward_launches': dict(none, glimpse_extract=2 * T),
                 'extract_route_launches': {'extract_strip_kernel': 4 * T}}}

    def steps_diff(stage, per_step):
      return [f'{stage} step {i}: {s}' for i, s in enumerate(per_step)
              if s != want[stage]] or ([] if per_step else ['no step'])
    # Each stage's own run: fg here, box and full in the child, and the
    # full stage's relaunch here.
    recorded = {'fg': fg_run['step_launches'],
                'box': child_runs['box']['step_launches'],
                'full': (child_runs['full']['step_launches']
                         + full_run['step_launches'])}
    out['launches_per_step'] = recorded
    if cuda:   # the plain glimpses of the CPU launch nothing
      out['launch_gate'] = {
          stage: gate(f'{stage} launches per step',
                      steps_diff(stage, per_step),
                      # Control: the plain step's launches (of the fg
                      # stage: the full model's steps).
                      steps_diff(stage, recorded['full'] if stage == 'fg'
                                 else [plain_step]))
          for stage, per_step in recorded.items()}

    # ---- the eval command line against plain ----------------------------
    # On a trained model: the committed synth3 full checkpoint (the
    # pipeline's six-step model finds no instance: its SBD is 0 and its
    # counts do not depend on its input), on a pack file that holds the
    # ground truth's maps of the valid split at the model's size, at the
    # pipeline's thresholds; the command line reads the pack file through
    # the provider, eval_split with the plain glimpses the same split.
    full_cfg = FullModelConfig.from_yaml(os.path.join(CHAIN_FULL_DIR,
                                                      'model_opt.yaml'))
    cli_data = DataConfig(
        dataset='synth', folder=os.path.join(root, 'cli_data'),
        height=full_cfg.inp_height, width=full_cfg.inp_width,
        timespan=full_cfg.timespan, num_examples=SYNTH3_EXAMPLES,
        max_objects=CHAIN_MAX_OBJECTS)
    valid = provider.get('synth', cli_data, split='valid')
    provider.write_pack(
        provider.pack_path(cli_data, 'valid'), valid.img_ids,
        quantise(torch.from_numpy(valid.d_gt)).numpy(),
        quantise(torch.from_numpy(valid.c_gt)).numpy(),
        provider.settings(cli_data, 'valid'))
    name = os.path.basename(CHAIN_FULL_DIR)
    cli_folder = os.path.join(root, 'committed', name)
    os.makedirs(cli_folder)
    for f in ('model_opt.yaml', os.path.basename(
        list_checkpoints(CHAIN_FULL_DIR)[-1][1])):
      os.symlink(os.path.join(CHAIN_FULL_DIR, f), os.path.join(cli_folder, f))
    cli_data.save_yaml(os.path.join(cli_folder, 'data_opt.yaml'))
    thresholds = [float(t) for t in SYNTH3_THRESHOLDS.split(',')]
    cli_out = os.path.join(root, 'cli')
    gk.reset_launch_counts()
    t0 = time.time()
    with deterministic_cudnn(torch):
      eval_cli.full_main(
          ['--model_id', name, '--results', os.path.dirname(cli_folder),
           '--dataset', 'synth', '--split', 'valid', '--batch_size',
           str(cli_examples), '--max_batches', '1', '--threshold_list',
           SYNTH3_THRESHOLDS, '--output', cli_out], device=dev)
    cli = {'seconds': time.time() - t0, **launches_now(gk)}
    packed_valid = provider.get('synth', cli_data, split='valid')
    if not isinstance(packed_valid, PackedDataset):
      failures.append('the eval command line\'s pack file was not read')
    plain_exp = EvalExperiment(cli_folder, device=dev, glimpse='plain')

    def scores(folder):
      return {(tt, name): read_scores(folder, f'{name}_{int(tt * 100):02d}')
              for tt in thresholds for name in ('sbd', 'dic')}

    def plain_scores(dataset, label):
      folder = os.path.join(root, label)
      with deterministic_cudnn(torch):
        eval_cli.eval_split(plain_exp, dataset, folder, thresholds,
                            eval_cli.DEFAULT_ANALYZERS,
                            batch_size=cli_examples, max_batches=1)
      return scores(folder)
    got = scores(cli_out)

    def cli_diff(want):
      bad = []
      for (tt, name), vals in want.items():
        if sorted(got[tt, name]) != sorted(vals):
          bad.append(f'{name} {tt} ids {sorted(got[tt, name])}')
          continue
        limit = PIPELINE_CLI_SBD_LIMIT if name == 'sbd' else 0
        bad += [f'{name} {tt} {k}: {got[tt, name][k]} against {v}'
                for k, v in vals.items()
                if not abs(got[tt, name][k] - v) <= limit]
      return bad
    swapped = PackedDataset(packed_valid.dataset,
                            np.roll(packed_valid.d_out, 1, axis=0),
                            np.roll(packed_valid.y_out, 1, axis=0))
    cli['gate'] = gate(
        'the eval command line against plain eval_split',
        cli_diff(plain_scores(packed_valid, 'plain')),
        cli_diff(plain_scores(swapped, 'swapped')))
    cli['sbd'] = {tt: got[tt, 'sbd'] for tt in thresholds}
    sbd = [v for tt in thresholds for v in got[tt, 'sbd'].values()]
    if len(got[thresholds[0], 'sbd']) != cli_examples or not max(sbd) > 0:
      failures.append(f'the eval command line: {cli["sbd"]}')
    out['eval']['command_line'] = cli
    out['folders'] = ids
  out['seconds'] = time.time() - start
  return out, failures


def bf16_config():
  """The bfloat16 run's config, from its model_opt.yaml.  Raises where the
  checkout lacks it."""
  from rec_attend_tpu_torch.config import FullModelConfig
  cfg = FullModelConfig.from_yaml(os.path.join(BF16_DIR, 'model_opt.yaml'))
  if cfg.dtype != 'bfloat16':
    raise AssertionError(f'{BF16_DIR}: dtype {cfg.dtype}')
  return cfg


@contextlib.contextmanager
def float64_everywhere(torch):
  """Inside the block ``Tensor.float()`` gives float64 and new floating
  tensors are float64, so a model written for float32 runs in float64."""
  cast = torch.Tensor.float
  torch.Tensor.float = lambda self, *a, **kw: self.double()
  torch.set_default_dtype(torch.float64)
  try:
    yield
  finally:
    torch.Tensor.float = cast
    torch.set_default_dtype(torch.float32)


def float64_step(torch, ts, matching, model, opt_state, batch, draws, step,
                 pinned):
  """``one_step`` of a float32 model on the CPU in float64 with the
  Hungarian answer ``pinned``, its floating results cast back to
  float32."""
  model = copy.deepcopy(model).to('cpu').double()
  model.device = torch.device('cpu')
  opt_state = {k: (v if k == 'count' else {n: t.cpu().double()
                                           for n, t in v.items()})
               for k, v in opt_state.items()}
  draws = {k: (v if k == 'aug' else v.cpu().double())
           for k, v in draws.items()}
  with float64_everywhere(torch):
    out = one_step(torch, ts, matching, model, opt_state,
                   {k: v.cpu() for k, v in batch.items()}, draws, step,
                   'kernel', pinned)

  def f32(t):
    return t.float() if torch.is_tensor(t) and t.is_floating_point() else t
  return tuple({k: f32(v) for k, v in x.items()} if isinstance(x, dict)
               else f32(x) for x in out)


def bf16_step_gates(torch, ts, matching, gk, trainer, batch, draws,
                    small_draws, lr, limits=BF16_STEP_LIMITS,
                    floor_gates=BF16_FLOOR_GATES):
  """The bfloat16 step at step 0 from the trainer's state: kernel against
  plain (b32, beside the reordered-plain floor, with the dropped-filter-
  gradient control; ``step_gates``) at ``limits``, and the card's step on
  the batch's first TRAIN_CPU_BATCH examples (``small_draws`` are theirs)
  against the float32 model's step in float64 on the CPU, each statistic
  of ``floor_gates`` held to BF16_FLOOR_FACTOR times its floor (the
  larger of what the CPU's bfloat16 step and the card's with cuDNN off
  read against the same step), the zero-gradient ones to STEP_LIMITS;
  the dropped-filter-gradient control must fail the gradient gates.  The
  CPU's bfloat16 step solves the matchings; the float64 step takes its
  answer.  Returns (gates, failures)."""
  model, opt = trainer.model, trainer.opt_state
  gates, failures = step_gates(torch, ts, matching, gk, model, opt, batch,
                               draws, 0, lr, limits)
  nb, dev = TRAIN_CPU_BATCH, model.device
  small = {k: v[:nb] for k, v in batch.items()}
  cpu_model = copy.deepcopy(model).to('cpu')
  cpu_model.device = torch.device('cpu')
  host = step_to(torch, one_step(
      torch, ts, matching, cpu_model, opt_state_to(opt, 'cpu'),
      {k: v.cpu() for k, v in small.items()},
      to_device(small_draws, 'cpu'), 0, 'kernel'), dev)
  twin = copy.deepcopy(model)
  twin.cfg = model.cfg.replace(dtype='float32')
  exact = step_to(torch, float64_step(torch, ts, matching, twin, opt, small,
                                      small_draws, 0, host[4]['solved']),
                  dev)

  def card(pinned, glimpse='kernel', cudnn=True):
    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = cudnn
    try:
      with deterministic_cudnn(torch):
        return one_step(torch, ts, matching, model, opt, small,
                        to_device(small_draws, dev), 0, glimpse, pinned)
    finally:
      torch.backends.cudnn.enabled = saved
  floors = [step_diff(torch, model, got, exact, lr) for got in (
      host, card(host[4]['solved'], cudnn=False))]
  gates[f'cpu_vs_float64_b{nb}'], gates[
      f'card_cudnn_off_vs_float64_b{nb}'] = floors

  def value(v):
    return v[1] if isinstance(v, (list, tuple)) else v
  exact_limits = {
      **{k: BF16_FLOOR_FACTOR * max(value(f[k]) for f in floors)
         for k in floor_gates},
      **{k: STEP_LIMITS[k] for k in ('zero_grad_share_max',
                                     'zero_update_in_lr_max')}}
  gates[f'card_vs_float64_limits_b{nb}'] = exact_limits
  for name, stats, gated in held_steps(torch, model, card, exact, lr,
                                       exact_limits):
    gates[f'card_vs_float64{name}_b{nb}'] = stats
    if gated and stats['failed']:
      failures.append(f'card_vs_float64{name}: fails {stats["failed"]}')
  control = card(host[4]['solved'], without_filter_grads(torch, gk))
  stats = step_diff(torch, model, control, exact, lr)
  stats['failed'] = step_gate_failures(stats, exact_limits)
  gates[f'dropped_filter_grads_vs_float64_b{nb}'] = stats
  passed = [k for k in GRADIENT_GATES
            if k in exact_limits and k not in stats['failed']]
  if passed:
    failures.append('dropped_filter_grads_vs_float64: the gradient gates '
                    f'{passed} pass it')
  return gates, failures


def bf16_layer_cases(torch, cfg, dev, batch=2, size=None):
  """The bfloat16 layers at the widths of ``cfg`` (a bfloat16 full model)
  as (name, inputs, fn): inputs a {name: tensor on dev} made from one seed
  (the weights' names start with 'w', 'b', 'gamma' or 'beta'), fn(inputs)
  the layer's outputs as a list.  ``batch`` images of ``size`` (default
  the model's) for the convolutions and BatchNorm, 32 rows for the LSTM
  and the MLP; the convolutions' channels are the controller CNN's first two
  layers' and the attention DCNN's second and third layers', the
  transposed convolution's input a quarter of the glimpse."""
  import types
  from torch.func import functional_call
  from rec_attend_tpu_torch.nn import layers as L
  bf = torch.bfloat16
  g = torch.Generator().manual_seed(17)
  h = w = size or cfg.inp_height

  def rand(*shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=g) * scale).to(dtype).to(dev)
  c0, c1, c2 = cfg.ccnn_inp_depth, *cfg.ctrl_cnn_depth[:2]
  d_in, d_out = cfg.attn_dcnn_depth[1:3]
  q = cfg.filter_height // 4
  hid, feat = cfg.ctrl_rnn_hid_dim, cfg.glimpse_feat_dim
  bn = L.BatchNorm(c1, None)
  lstm = L.LSTM(feat, hid, torch.Generator().manual_seed(0))
  lstm_w = {k: rand(*v.shape, scale=0.1) for k, v in lstm.named_parameters()}
  mlp_dims = (hid, hid, cfg.glimpse_map_dim)
  mlp = {**{f'w{i}': rand(mlp_dims[i], mlp_dims[i + 1], scale=0.1)
            for i in range(2)},
         **{f'b{i}': rand(mlp_dims[i + 1], scale=0.1) for i in range(2)}}

  def batch_norm(p):
    """The normalised bfloat16 result and the new EMA mean and variance."""
    stats = []
    y = functional_call(bn, {'gamma': p['gamma'], 'beta': p['beta'],
                             'ema_mean': torch.zeros_like(p['gamma']),
                             'ema_var': torch.ones_like(p['gamma'])},
                        (p['x'], None, stats, bf))
    return [y, *stats[0]]
  return [
      ('conv_float32_input', {'x': rand(batch, c0, h, w),
                              'w': rand(3, 3, c0, c1, scale=0.2)},
       lambda p: [L.conv2d_same(p['x'], p['w'], bf)]),
      ('conv', {'x': rand(batch, c1, h, w, dtype=bf),
                'w': rand(3, 3, c1, c2, scale=0.1)},
       lambda p: [L.conv2d_same(p['x'], p['w'])]),
      ('conv_transpose', {'x': rand(batch, d_in, q, q, dtype=bf),
                          'w': rand(3, 3, d_out, d_in, scale=0.1)},
       lambda p: [L.conv2d_transpose_same(p['x'], p['w'], 2)]),
      ('batch_norm_train', {'x': rand(batch, c1, h, w, scale=3.0),
                            'gamma': rand(c1) + 2, 'beta': rand(c1)},
       batch_norm),
      ('lstm', {'x': rand(32, feat, dtype=bf), 'state': rand(32, 2 * hid),
                **{f'w_{k}': v for k, v in lstm_w.items()}},
       lambda p: [functional_call(
           lstm, {k: p[f'w_{k}'] for k in lstm_w}, (p['x'], p['state']))]),
      ('mlp', {'x': rand(32, hid, dtype=bf), **mlp},
       lambda p: L.apply_mlp(
           [types.SimpleNamespace(w=p[f'w{i}'], b=p[f'b{i}'])
            for i in range(2)], p['x'], [torch.relu, None])),
  ]


def layer_results(torch, inputs, fn):
  """fn's outputs and the gradients of sum(output * r) (r seeded, one a
  output) with respect to every floating input, as {name: tensor}."""
  inputs = {k: v.detach().clone().requires_grad_() for k, v in
            inputs.items()}
  outs = fn(inputs)
  g = torch.Generator().manual_seed(23)
  loss = sum((o.float() * torch.randn(o.shape, generator=g).to(o.device)
              ).sum() for o in outs if o.requires_grad)
  grads = torch.autograd.grad(loss, list(inputs.values()))
  return {**{f'out{i}': o.detach() for i, o in enumerate(outs)},
          **{f'd_{k}': v for k, v in zip(inputs, grads)}}


def bf16_layer_gates(torch, cfg, dev, batch=2, size=None,
                     limit=BF16_LAYER_LIMIT):
  """Each of ``bf16_layer_cases`` on ``dev`` against the CPU, cuDNN
  deterministic: every output and gradient as a relative L2 error, held to
  ``limit``, its dtype to the CPU's.  The control, the same layer with
  every weight scaled by BF16_LAYER_CONTROL_SCALE, must fail.  Returns
  (gates {case: {tensor: error}, ...}, failures)."""
  gates, failures = {}, []

  def rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))
  for name, inputs, fn in bf16_layer_cases(torch, cfg, dev, batch, size):
    cpu_inputs = {k: v.cpu() for k, v in inputs.items()}
    ref = layer_results(torch, cpu_inputs, fn)
    with deterministic_cudnn(torch):
      got = layer_results(torch, inputs, fn)
      control = layer_results(torch, {
          k: (v * BF16_LAYER_CONTROL_SCALE if k[0] in 'wbg' else v)
          for k, v in inputs.items()}, fn)
    errors, failed = {}, []
    for k, want in ref.items():
      if got[k].dtype != want.dtype:
        failed.append(f'{k} is {got[k].dtype}, the CPU {want.dtype}')
        continue
      errors[k] = rel(got[k], want)
      if errors[k] > limit:
        failed.append(k)
    control_errors = {k: rel(control[k], ref[k]) for k in ref}
    control_passes = all(v <= limit for v in control_errors.values())
    gates[name] = {'errors': errors, 'control_errors': control_errors,
                   'dtypes': {k: str(v.dtype).split('.')[-1]
                              for k, v in ref.items()},
                   'failed': failed}
    if failed:
      failures.append(f'{name}: fails {failed}')
    if control_passes:
      failures.append(f'{name}: the control (weights x '
                      f'{BF16_LAYER_CONTROL_SCALE}) passes')
  return gates, failures


def bf16_phase(torch, np, gk, dev, train):
  """The flagship in bfloat16: the committed bfloat16 run's eval, its b128
  forward beside float32's, its train step gated and 5 steps, the full
  model's fixed_order and rnd_colour steps gated, and a bfloat16
  TrainingExperiment with a checkpoint.  ``train``: the train phase's
  summary (its float32 step ms and peak memory)."""
  from rec_attend_tpu_torch import convert
  from rec_attend_tpu_torch import train_step as ts
  from rec_attend_tpu_torch.config import DataConfig
  from rec_attend_tpu_torch.config import FullModelConfig
  from rec_attend_tpu_torch.config import TrainConfig
  from rec_attend_tpu_torch.config import cvppp_full_config
  from rec_attend_tpu_torch.data.synthetic import SyntheticDataset
  from rec_attend_tpu_torch.data.synthetic import synthetic_images
  from rec_attend_tpu_torch.data.synthetic import synthetic_instances
  from rec_attend_tpu_torch.engine import saver
  from rec_attend_tpu_torch.engine.experiment import TrainingExperiment
  from rec_attend_tpu_torch.engine.trainer import Trainer
  from rec_attend_tpu_torch.models.full_model import FullModel
  from rec_attend_tpu_torch.models.full_model import draw_train_randoms
  from rec_attend_tpu_torch.models.full_model import full_model_forward
  from rec_attend_tpu_torch.models.full_model import learn_rate
  from rec_attend_tpu_torch.ops import matching

  cfg = bf16_config()
  T = cfg.timespan
  seconds, failures, out = {}, [], {}

  # ---- eval: eval_split of the bf16 checkpoint, kernel against plain -----
  t0 = time.time()
  ds = SyntheticDataset(BF16_EVAL_EXAMPLES, cfg.inp_height, cfg.inp_width,
                        T, seed=4)
  runs, launches, stats, sbd_limit, f = eval_runs(
      torch, gk, BF16_DIR, cfg, ds, BF16_EVAL_EXAMPLES, EVAL_BATCH,
      BF16_MASK_THRESHOLD, BF16_SCORE_THRESHOLD, 'bf16_eval')
  failures += [f'eval: {x}' for x in f]
  routes = runs['kernel']['extract_route_launches']
  if routes != {'extract_tiled_kernel': launches['glimpse_extract']}:
    failures.append(f"eval: the extracts took {routes}")
  out['eval'] = {
      'examples': BF16_EVAL_EXAMPLES, 'batch': EVAL_BATCH,
      'thresholds': {'mask': BF16_MASK_THRESHOLD,
                     'score': BF16_SCORE_THRESHOLD},
      'launches': launches, 'extract_route_launches': routes,
      'means': {k: runs[k]['means'] for k in runs},
      'committed_headline_256_examples': BF16_HEADLINE, **stats,
      'limits': {'sbd_max_abs_diff': sbd_limit, 'count_differ': 0},
      'seconds': {k: v['seconds'] for k, v in runs.items()}}
  seconds['eval'] = time.time() - t0

  # ---- forward times, b128, bfloat16 and float32, same weights -----------
  t0 = time.time()
  path = saver.latest_checkpoint(BF16_DIR)
  state = convert.params_from_checkpoint(path, cfg)
  x128 = synthetic_images(128, cfg.inp_height, cfg.inp_width,
                          seed=128).to(dev)
  forward_ms = {}
  for dtype in ('bfloat16', 'float32'):
    model = FullModel(cfg.replace(dtype=dtype), device=dev)
    model.load_state_dict(state)
    reset_peak(torch, dev)
    with torch.inference_mode():
      forward_ms[dtype] = ms(torch, lambda: full_model_forward(model, x128),
                             iters=5, warmup=1, sleep=False)
    forward_ms[f'{dtype}_max_memory_allocated_bytes'] = peak_memory(torch,
                                                                    dev)
    del model
  out['forward_b128'] = {**forward_ms, 'instances_per_s': {
      k: 128 * T / (forward_ms[k] / 1e3) for k in ('bfloat16', 'float32')}}
  seconds['forward'] = time.time() - t0

  # ---- train: restore with Adam, gate one step, take 5 steps -------------
  t0 = time.time()
  trainer = Trainer(cfg, device=dev, seed=0)
  ckpt = trainer.restore(BF16_DIR)
  if trainer.step != 30000 or trainer.opt_state['count'] != 30000:
    failures.append(f'restored step {trainer.step}, Adam count '
                    f'{trainer.opt_state["count"]}')
  b = TRAIN_BATCH
  batch = {k: v.to(dev) for k, v in synthetic_instances(
      b, cfg.inp_height, cfg.inp_width, T, seed=1000).items()}
  draws = draw_train_randoms(cfg, b, torch.Generator(dev).manual_seed(1))
  small_draws = draw_train_randoms(cfg, TRAIN_CPU_BATCH,
                                   torch.Generator(dev).manual_seed(2))
  lr = learn_rate(cfg, trainer.opt_state['count'])
  t1 = time.time()
  layer_gates, f = bf16_layer_gates(torch, cfg, dev)
  failures += [f'layers: {x}' for x in f]
  seconds['layer_gates'] = time.time() - t1
  gates, f = bf16_step_gates(torch, ts, matching, gk, trainer, batch, draws,
                             small_draws, lr)
  failures += [f'train step: {x}' for x in f]
  seconds['train_gates'] = time.time() - t0
  t0 = time.time()

  def batches(seed):
    while True:
      yield synthetic_instances(b, cfg.inp_height, cfg.inp_width, T,
                                seed=seed)
      seed += 1
  reset_peak(torch, dev)
  steps = run_steps(torch, gk, trainer, batches(0), BF16_TRAIN_STEPS)
  summary = steps_summary(torch, steps, peak_memory(torch, dev))
  want_launches(steps, {'glimpse_extract': 4 * T, 'glimpse_paste': 4 * T},
                {'glimpse_extract': 2 * T, 'glimpse_paste': 0},
                {'extract_tiled_kernel': 4 * T}, 'bf16 train')
  if trainer.opt_state['count'] != 30000 + BF16_TRAIN_STEPS:
    failures.append(f'Adam count {trainer.opt_state["count"]}')
  n = len(steps)
  out['launches'] = {
      'eval': launches,
      'train_forward': {k: n * (v - summary['backward_launches_per_step'][k])
                        for k, v in summary['launches_per_step'].items()},
      'train_backward': {k: n * v for k, v in
                         summary['backward_launches_per_step'].items()}}
  f32_ms = train['step_ms_median']
  out['train'] = {
      'weights': os.path.relpath(ckpt, REPO), 'batch': b, 'gates': gates,
      'limits': {'kernel_vs_plain': BF16_STEP_LIMITS,
                 'card_vs_float64_floor_factor': BF16_FLOOR_FACTOR},
      'layers': {'gates': layer_gates, 'limit': BF16_LAYER_LIMIT},
      **summary,
      'instances_per_s': b * T / (summary['step_ms_median'] / 1e3),
      'float32_train_phase': {
          'step_ms_median': f32_ms, 'instances_per_s': b * T / (f32_ms / 1e3),
          'max_memory_allocated_bytes': train['max_memory_allocated_bytes']}}
  for s_ in out['train']['steps']:
    s_['metrics'] = {k: s_['metrics'][k] for k in ('loss', 'iou_soft',
                                                   'count_acc')}
  seconds['train_steps'] = time.time() - t0

  # ---- the other training options: fixed_order, rnd_colour ---------------
  t0 = time.time()
  options = {}
  for name, over in (('fixed_order', {'fixed_order': True}),
                     ('rnd_colour', {'rnd_colour': True})):
    ocfg = cvppp_full_config().replace(**over)
    opt_trainer = Trainer(ocfg, device=dev, seed=0)
    opt_trainer.restore(CHECKPOINT_DIR)
    ob = {k: v[:OPTION_BATCH] for k, v in batch.items()}
    odraws = draw_train_randoms(ocfg, OPTION_BATCH,
                                torch.Generator(dev).manual_seed(3))
    g, f = step_gates(torch, ts, matching, gk, opt_trainer.model,
                      opt_trainer.opt_state, ob, odraws, 0,
                      learn_rate(ocfg, opt_trainer.opt_state['count']),
                      STEP_LIMITS)
    failures += [f'{name}: {x}' for x in f]
    options[name] = {'gates': g, 'limits': STEP_LIMITS,
                     'colour_draws': odraws['aug'].get('colour')}
  out['options'] = options
  seconds['options'] = time.time() - t0

  # ---- TrainingExperiment in bfloat16: 2 steps and a checkpoint ----------
  t0 = time.time()
  exp_cfg = cvppp_full_config().replace(dtype='bfloat16')
  with tempfile.TemporaryDirectory(prefix='.chip_smoke_bf16-',
                                   dir=REPO) as root:
    train_cfg = TrainConfig(
        num_steps=2, batch_size=OPTION_BATCH,
        results=os.path.join(root, 'results'),
        logs=os.path.join(root, 'logs'), steps_per_valid=0,
        steps_per_trainval=0, steps_per_log=1, steps_per_ckpt=2,
        steps_per_plot=0, save_ckpt=True, model_id='full_model_bf16')
    data_cfg = DataConfig(dataset='synth', folder=os.path.join(root, 'data'),
                          height=exp_cfg.inp_height, width=exp_cfg.inp_width,
                          timespan=T, num_examples=2 * OPTION_BATCH)
    exp = TrainingExperiment('full', exp_cfg, train_cfg, data_cfg,
                             device=dev)
    gk.reset_launch_counts()
    exp.run()
    counts = gk.launch_counts()
    backward = gk.launch_counts(backward=True)
    out['launches']['experiment_forward'] = {k: v - backward[k]
                                             for k, v in counts.items()}
    out['launches']['experiment_backward'] = backward
    ckpts = [step for step, _ in exp.saver.list_ckpts()]
    yaml_path = os.path.join(exp.folder, 'model_opt.yaml')
    read = FullModelConfig.from_yaml(yaml_path)
    with open(yaml_path) as fh:
      dtype_lines = [l.strip() for l in fh if l.startswith('dtype:')]
    leaves = np.load(exp.saver.get_latest_ckpt()[1])
    leaf_dtypes = sorted({str(leaves[k].dtype) for k in leaves.files})
    control = read == cvppp_full_config()
    experiment = {'checkpoints': ckpts, 'model_opt_dtype': dtype_lines,
                  'read_back_equal': read == exp_cfg,
                  'read_back_equal_float32_preset': control,
                  'checkpoint_leaf_dtypes': leaf_dtypes,
                  'steps': exp.trainer.step}
    if (ckpts != [2] or dtype_lines != ['dtype: bfloat16']
        or read != exp_cfg or control or exp.trainer.step != 2
        or 'bfloat16' in leaf_dtypes):
      failures.append(f'TrainingExperiment: {experiment}')
  out['training_experiment'] = experiment
  seconds['training_experiment'] = time.time() - t0
  out['seconds'] = seconds
  return out, failures


def flagship_segmenter(cfg):
  """(InstanceSegmenter on the card, checkpoint path): the flagship
  checkpoint.  Raises where the checkout lacks it."""
  from rec_attend_tpu_torch.engine import saver
  from rec_attend_tpu_torch.serving import InstanceSegmenter
  ckpt = saver.latest_checkpoint(CHECKPOINT_DIR)
  return (InstanceSegmenter.from_checkpoint(CHECKPOINT_DIR, cfg=cfg,
                                            device='cuda'),
          os.path.relpath(ckpt, REPO))


def train_phase(torch, np, cfg, dev, gk, name_power):
  """The training path: restore, gate one step, take 5 + 2 steps."""
  from rec_attend_tpu_torch import train_step as ts
  from rec_attend_tpu_torch.data.synthetic import synthetic_instances
  from rec_attend_tpu_torch.engine.trainer import Trainer
  from rec_attend_tpu_torch.models.full_model import draw_train_randoms
  from rec_attend_tpu_torch.models.full_model import learn_rate
  from rec_attend_tpu_torch.ops import matching

  trainer = Trainer(cfg, device=dev, seed=0)
  ckpt = trainer.restore(CHECKPOINT_DIR)
  if trainer.step != 30000 or trainer.opt_state['count'] != 30000:
    raise AssertionError(f'restored step {trainer.step}, Adam count '
                         f'{trainer.opt_state["count"]}')
  T, b = cfg.timespan, TRAIN_BATCH

  def batches(seed0):
    seed = seed0
    while True:
      yield synthetic_instances(b, cfg.inp_height, cfg.inp_width, T,
                                seed=seed)
      seed += 1

  # ---- gates: one step from the restored state ------------------------
  batch = {k: v.to(dev) for k, v in next(batches(1000)).items()}
  draws = draw_train_randoms(cfg, b, torch.Generator(dev).manual_seed(1))
  lr = learn_rate(cfg, trainer.opt_state['count'])
  gates, failures = {}, []
  for step, limits in ((0, STEP_LIMITS), (30000, OWN_CANVAS_LIMITS)):
    g, f = step_gates(torch, ts, matching, gk, trainer.model,
                      trainer.opt_state, batch, draws, step, lr, limits)
    gates.update({f'{k}_b{b}_step{step}': v for k, v in g.items()})
    failures += [f'step {step}: {x}' for x in f]
  # The card against the CPU, b2, at step 0.
  nb = TRAIN_CPU_BATCH
  g, f, _ = cpu_gate(torch, ts, matching, trainer.model, trainer.opt_state,
                     batch, draw_train_randoms(
                         cfg, nb, torch.Generator(dev).manual_seed(2)),
                     0, lr, STEP_LIMITS, nb)
  gates.update({f'{k}_step0': v for k, v in g.items()})
  failures += f
  if failures:
    raise AssertionError(f'train step gates: {failures}; {gates}')

  # ---- the main path: 5 steps from 30000, 2 from 0 ---------------------
  solve_ms = []

  def timed_solve(solve, w):
    t0 = time.perf_counter()
    out = solve(w)
    solve_ms.append((time.perf_counter() - t0) * 1e3)
    return out
  data = batches(0)
  steps = []
  forward_launches = {'glimpse_extract': 0, 'glimpse_paste': 0}
  backward_launches = dict(forward_launches)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  with hungarian_calls(matching, timed_solve):
    for i in range(7):
      if i == 5:
        trainer.step = 0
      step = trainer.step
      gk.reset_launch_counts()
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      (metrics,) = trainer.run(1, data)
      end.record()
      end.synchronize()
      total, bwd = gk.launch_counts(), gk.launch_counts(backward=True)
      want = {'glimpse_extract': 4 * T, 'glimpse_paste': 4 * T}
      want_bwd = {'glimpse_extract': 2 * T, 'glimpse_paste': 0}
      if total != want or bwd != want_bwd:
        raise AssertionError(f'step {step}: launches {total} (backward '
                             f'{bwd}), want {want} (backward {want_bwd})')
      for k in total:
        forward_launches[k] += total[k] - bwd[k]
        backward_launches[k] += bwd[k]
      if not np.isfinite(metrics['loss']):
        raise AssertionError(f'step {step}: loss {metrics["loss"]}')
      steps.append({'step': step, 'ms': start.elapsed_time(end),
                    'solve_ms': solve_ms[-1], 'launches': total,
                    'backward_launches': bwd,
                    **{k: metrics[k] for k in (
                        'loss', 'box_loss', 'segm_loss', 'conf_loss',
                        'iou_soft', 'count_acc', 'learn_rate')}})
  peak = torch.cuda.max_memory_allocated()
  for k, v in trainer.model.state_dict().items():
    if not torch.isfinite(v).all():
      raise AssertionError(f'non-finite parameter after training: {k}')
  if trainer.opt_state['count'] != 30007:
    raise AssertionError(f'Adam count {trainer.opt_state["count"]}')
  step_ms = statistics.median(s['ms'] for s in steps)
  solve_med = statistics.median(s['solve_ms'] for s in steps)
  return {
      'weights': os.path.relpath(ckpt, REPO), 'batch': b,
      'gates': gates,
      'limits': {'step0': STEP_LIMITS, 'step30000': OWN_CANVAS_LIMITS},
      'steps': steps, 'step_ms_median': step_ms,
      'instances_per_s': b * T / (step_ms / 1e3),
      'max_memory_allocated_bytes': peak,
      'hungarian_solve_ms_median': solve_med,
      'hungarian_share': solve_med / step_ms,
      'forward_launches': forward_launches,
      'backward_launches': backward_launches,
      'adam_count': trainer.opt_state['count'], 'nvidia_smi': name_power}


def main():
  import torch
  if not torch.cuda.is_available():
    sys.exit('chip_smoke: CUDA is not available; this script runs on a card')
  import numpy as np
  from rec_attend_tpu_torch.config import cvppp_full_config
  from rec_attend_tpu_torch.config import kitti_full_config
  from rec_attend_tpu_torch.config import synthcs_full_config
  from rec_attend_tpu_torch.data.synthetic import synthetic_images
  from rec_attend_tpu_torch.models.full_model import FullModel
  from rec_attend_tpu_torch.models.full_model import full_model_forward
  from rec_attend_tpu_torch.ops import attention
  from rec_attend_tpu_torch.ops.cuda import build
  from rec_attend_tpu_torch.ops.cuda import glimpse as gk

  # ---- device ----------------------------------------------------------
  start = time.time()
  name_power = nvidia_smi_name_power()
  dev = torch.device('cuda')
  kind = torch.cuda.get_device_name(0)
  emit('device', kind=kind, count=torch.cuda.device_count(),
       nvidia_smi=name_power, torch=torch.__version__,
       cuda=torch.version.cuda)

  # ---- build -----------------------------------------------------------
  t0 = time.time()
  paths = build.build()
  build.load()
  build.load_hungarian()
  resources = build.kernel_resources(build.compile_log('glimpse'))
  for prefix in ('paste_kernel', 'extract_tiled_kernel',
                 'extract_strip_kernel', 'extract_kernel_general'):
    if not any(k.startswith(prefix) for k in resources):
      raise AssertionError(f'nvcc -Xptxas -v reported no {prefix}')
  emit('build', seconds=time.time() - t0,
       libraries={k: os.path.relpath(v, REPO) for k, v in paths.items()},
       kernel_resources=resources,
       extract_kernels={k: v for k, v in resources.items()
                        if k.startswith('extract')})

  # ---- kernels ---------------------------------------------------------
  # Full float32 everywhere: matmuls and convolutions off TF32.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  gen = torch.Generator(device=dev).manual_seed(0)
  cfg = cvppp_full_config()
  main_dims = {
      'glimpse_extract': (128, cfg.inp_height, cfg.inp_width,
                          cfg.acnn_inp_depth, cfg.filter_height,
                          cfg.filter_width),
      'glimpse_paste': (128, cfg.inp_height, cfg.inp_width, 1,
                        cfg.filter_height, cfg.filter_width),
  }
  ragged_dims = (16, 128, 448, 13, 48, 64)
  # The synth3 chain's forward at b32: extract x [32,128,448,13] (image,
  # canvas, orientation, foreground), paste [32,48,48,1] -> 128x448.
  chain_cfg = kitti_full_config()
  chain_dims = {
      'glimpse_extract': (CHAIN_BATCH, chain_cfg.inp_height,
                          chain_cfg.inp_width, chain_cfg.acnn_inp_depth,
                          chain_cfg.filter_height, chain_cfg.filter_width),
      'glimpse_paste': (CHAIN_BATCH, chain_cfg.inp_height,
                        chain_cfg.inp_width, 1, chain_cfg.filter_height,
                        chain_cfg.filter_width),
  }
  # Extract at Cityscapes' forward (b32, 256x512, D = 3+1+8+9 = 21) and as
  # paste's d_p at the KITTI size (b32, 128x448, D=1).
  other_extracts = {'cityscapes': (CHAIN_BATCH, 256, 512, 21, 48, 48),
                    'synth3_d1': (CHAIN_BATCH, chain_cfg.inp_height,
                                  chain_cfg.inp_width, 1,
                                  chain_cfg.filter_height,
                                  chain_cfg.filter_width)}
  # The Cityscapes-shaped chain's forward at b32: extract x [32,256,512,15]
  # (image, canvas, orientation, 3 semantic channels), paste [32,48,48,1]
  # -> 256x512.
  cs_cfg = synthcs_full_config()
  cs_dims = {
      'glimpse_extract': (CS_BATCH, cs_cfg.inp_height, cs_cfg.inp_width,
                          cs_cfg.acnn_inp_depth, cs_cfg.filter_height,
                          cs_cfg.filter_width),
      'glimpse_paste': (CS_BATCH, cs_cfg.inp_height, cs_cfg.inp_width, 1,
                        cs_cfg.filter_height, cs_cfg.filter_width),
  }
  # The synth pipeline's full model at b8: its pastes' d_p, extract x
  # [8,224,224,1] (its forward extract and paste are the b8 request's).
  pipeline_d1 = (8, cfg.inp_height, cfg.inp_width, 1, cfg.filter_height,
                 cfg.filter_width)
  # The chain's training at b8: the box's and the full model's paste
  # [8,48,48,1] -> 128x448, the full model's extract x [8,128,448,13] and
  # its pastes' d_p, extract x [8,128,448,1].
  chain_train_dims = {
      'glimpse_extract': (CHAIN_TRAIN_BATCH,) + chain_dims[
          'glimpse_extract'][1:],
      'glimpse_paste': (CHAIN_TRAIN_BATCH,) + chain_dims['glimpse_paste'][1:],
      'synth3_d1_b8': (CHAIN_TRAIN_BATCH,) + other_extracts['synth3_d1'][1:],
  }
  checks = {}
  for name, dims in main_dims.items():
    checks[name] = check_kernel(torch, gk, attention, name, *dims, gen, dev,
                                timed=True)
    checks[name]['ragged'] = check_kernel(torch, gk, attention, name,
                                          *ragged_dims, gen, dev, timed=True)
    checks[name]['synth3'] = check_kernel(torch, gk, attention, name,
                                          *chain_dims[name], gen, dev,
                                          timed=True)
    checks[name]['synthcs'] = check_kernel(torch, gk, attention, name,
                                           *cs_dims[name], gen, dev,
                                           timed=True)
  for key, dims in other_extracts.items():
    checks['glimpse_extract'][key] = check_kernel(
        torch, gk, attention, 'glimpse_extract', *dims, gen, dev, timed=True)
  for key, dims in chain_train_dims.items():
    name = 'glimpse_extract' if key == 'synth3_d1_b8' else key
    checks[name]['synth3_b8' if key == name else key] = check_kernel(
        torch, gk, attention, name, *dims, gen, dev, timed=True)
  checks['glimpse_extract']['pipeline_d1_b8'] = check_kernel(
      torch, gk, attention, 'glimpse_extract', *pipeline_d1, gen, dev,
      timed=True)
  # The small requests of the serving path: 8 images, and one.
  for name, dims in main_dims.items():
    for b in (8, 1):
      checks[name][f'b{b}'] = check_kernel(torch, gk, attention, name, b,
                                           *dims[1:], gen, dev, timed=True)
  # The flagship's extracts take the tiled kernel; the synth3 chain's,
  # Cityscapes' and the KITTI-sized d_p the strip kernel; the 48x64 glimpse
  # the general one.
  ex = checks['glimpse_extract']
  want_routes = {'b128': 'extract_tiled_kernel', 'b8': 'extract_tiled_kernel',
                 'b1': 'extract_tiled_kernel',
                 'ragged': 'extract_kernel_general',
                 'synth3': 'extract_strip_kernel',
                 'synthcs': 'extract_strip_kernel',
                 'cityscapes': 'extract_strip_kernel',
                 'synth3_d1': 'extract_strip_kernel',
                 'synth3_b8': 'extract_strip_kernel',
                 'synth3_d1_b8': 'extract_strip_kernel'}
  routes = {k: (ex if k == 'b128' else ex[k])['route']['kernel']
            for k in want_routes}
  if routes != want_routes:
    raise AssertionError(f'extract routes {routes}, want {want_routes}')
  emit('kernels', tf32=False, rtol=KERNEL_RTOL, atol=KERNEL_ATOL,
       nvidia_smi=name_power, kernels=checks)

  # ---- kernels_grad ----------------------------------------------------
  # The train step's shapes: extract takes x [32,224,224,4]; paste writes
  # [32,224,224,1], so its backward extracts at D=1.
  b = TRAIN_BATCH
  train_dims = {
      'glimpse_extract': (b, cfg.inp_height, cfg.inp_width,
                          cfg.acnn_inp_depth, cfg.filter_height,
                          cfg.filter_width),
      'glimpse_paste': (b, cfg.inp_height, cfg.inp_width, 1,
                        cfg.filter_height, cfg.filter_width),
  }
  grad_checks = {}
  for name, dims in train_dims.items():
    grad_checks[name] = check_kernel_grad(torch, gk, attention, name, *dims,
                                          gen, dev, timed=True)
    grad_checks[name]['ragged'] = check_kernel_grad(
        torch, gk, attention, name, *ragged_dims, gen, dev, timed=False)
    # The synth3 chain's shape, D=13: ExtractPatch's forward and PastePatch's
    # d_p take the strip route.
    grad_checks[name]['synth3'] = check_kernel_grad(
        torch, gk, attention, name, *chain_dims['glimpse_extract'], gen, dev,
        timed=False)
    routes = grad_checks[name]['synth3']['extract_route_launches']
    if routes != {'extract_strip_kernel': 1}:
      raise AssertionError(f'{name} gradients at the synth3 shape: extract '
                           f'launches by route {routes}')
  emit('kernels_grad', tf32=False, rtol=GRAD_RTOL, atol=GRAD_ATOL,
       atol_scaled_by='max(1, largest |grad|)', nvidia_smi=name_power,
       functions=grad_checks)

  # ---- serve -----------------------------------------------------------
  seg, weights = flagship_segmenter(cfg)
  T = cfg.timespan
  images = {b: synthetic_images(b, cfg.inp_height, cfg.inp_width, seed=b)
            for b in (8, 32, 128)}
  other_sizes = [synthetic_images(b, h, w, seed=h).numpy()
                 for b, h, w in OTHER_SIZE_REQUESTS]
  gk.reset_launch_counts()
  requests = []
  for imgs in [v.numpy() for v in images.values()] + other_sizes:
    b, h, w = imgs.shape[:3]
    before = gk.launch_counts()
    t0 = time.time()
    result = seg.predict(imgs)
    seconds = time.time() - t0
    launched = {k: v - before[k] for k, v in gk.launch_counts().items()}
    if launched != {'glimpse_extract': T, 'glimpse_paste': 2 * T}:
      raise AssertionError(f'b={b}: kernel launches {launched}, want '
                           f'{T} extract and {2 * T} paste')
    if result['masks'].shape != (b, T, h, w):
      raise AssertionError(f'masks {result["masks"].shape}')
    if not (np.isfinite(result['scores']).all()
            and np.isfinite(result['soft_masks']).all()):
      raise AssertionError('non-finite outputs')
    if result['counts'].min() < 0 or result['counts'].max() > T:
      raise AssertionError(f'counts {result["counts"]}')
    requests.append({'batch': b, 'size': [h, w], 'seconds': seconds,
                     'launches': launched,
                     'counts': result['counts'].tolist()[:8],
                     'mask_pixels': int(result['masks'].sum())})
  launches = gk.launch_counts()

  # Requests of other sizes, the card against the CPU through the same
  # predict: scores within the serving gate's s_out limit, the share of
  # mask pixels that differ within its moved-pixel share, counts equal.
  from rec_attend_tpu_torch.serving import InstanceSegmenter
  cpu_seg = InstanceSegmenter(seg.model.state_dict(), cfg, device='cpu')
  other_sizes_vs_cpu = {}
  for imgs in other_sizes:
    with deterministic_cudnn(torch):
      got = seg.predict(imgs)
    want = cpu_seg.predict(imgs)
    stats = {
        'scores_max_abs': float(np.abs(got['scores'] - want['scores']).max()),
        'mask_pixels_differ_share': float(
            (got['masks'] != want['masks']).mean()),
        'soft_masks_max_abs': float(
            np.abs(got['soft_masks'] - want['soft_masks']).max()),
        'counts_equal': bool((got['counts'] == want['counts']).all())}
    other_sizes_vs_cpu['b{}_{}x{}'.format(*imgs.shape[:3])] = stats
    if (stats['scores_max_abs'] > S_OUT_ATOL
        or stats['mask_pixels_differ_share'] > Y_OUT_MOVED_SHARE
        or not stats['counts_equal']):
      raise AssertionError(f'request {imgs.shape}: card against CPU {stats}')

  with torch.inference_mode():
    x32 = images[32].to(dev)
    # cuDNN's default algorithms may sum in another order from one call to
    # the next (atomics), and the forward's feedbacks carry such 1e-7
    # differences to s_out: two plain forwards of the same batch differ.
    # The gates compare with cuDNN held to its deterministic algorithms.
    want = full_model_forward(seg.model, x32, glimpse='plain')
    plain_repeat = forward_diff(
        full_model_forward(seg.model, x32, glimpse='plain'), want)
  with deterministic_cudnn(torch), torch.inference_mode():
    want = full_model_forward(seg.model, x32, glimpse='plain')
    plain_repeat_det = forward_diff(
        full_model_forward(seg.model, x32, glimpse='plain'), want)
    # The float32 floor beside the gate: plain einsums that sum in another
    # order, against the plain forward (reported, not gated).
    reordered = forward_diff(full_model_forward(
        seg.model, x32, glimpse=reordered_plain(torch)), want)
    # Kernel glimpses against the plain einsum forms, b32.
    got32 = full_model_forward(seg.model, x32, glimpse='kernel')
    plain_err = forward_agreement(got32, want)
    # The card against the CPU on a small batch.
    cpu_model = FullModel(cfg, device='cpu')
    cpu_model.load_state_dict(seg.model.state_dict())
    x2 = images[8][:2]
    got = full_model_forward(seg.model, x2.to(dev))
    want = full_model_forward(cpu_model, x2)
    cpu_err = forward_agreement(got, want)
    # The gates must reject a lower-precision forward: the same weights with
    # the bf16 islands on, against the float32 kernel forward, b32.
    bf16_model = FullModel(cfg.replace(dtype='bfloat16'), device='cuda')
    bf16_model.load_state_dict(seg.model.state_dict())
    bf16_err = forward_diff(full_model_forward(bf16_model, x32), got32)
    bf16_err['failed'] = gate_failures(bf16_err)
    if not bf16_err['failed']:
      raise AssertionError(f'the gates pass a bf16 forward: {bf16_err}')
  with torch.inference_mode():
    # b128 forward time.
    x128 = images[128].to(dev)
    forward_ms = ms(torch, lambda: full_model_forward(seg.model, x128),
                    iters=5, warmup=1, sleep=False)
  emit('serve', weights=weights, requests=requests, launches=launches,
       plain_vs_plain_b32=plain_repeat,
       plain_vs_plain_b32_deterministic=plain_repeat_det,
       reordered_plain_vs_plain_b32=reordered,
       kernel_vs_plain_b32=plain_err, card_vs_cpu_b2=cpu_err,
       other_sizes_card_vs_cpu=other_sizes_vs_cpu,
       bf16_vs_f32_b32=bf16_err,
       limits={'y_out_mean': Y_OUT_MEAN_ATOL,
               'y_out_moved_share': Y_OUT_MOVED_SHARE,
               'y_out_moved': Y_OUT_MOVED, 's_out_max': S_OUT_ATOL},
       forward_ms_b128=forward_ms,
       instances_per_s_b128=128 * T / (forward_ms / 1e3),
       nvidia_smi=name_power)

  train = train_phase(torch, np, cfg, dev, gk, name_power)
  emit('train', **train)

  t0 = time.time()
  bf16, failures = bf16_phase(torch, np, gk, dev, train)
  emit('bf16', nvidia_smi=name_power, failures=failures,
       phase_seconds=time.time() - t0, **bf16)
  if failures:
    raise AssertionError(f'bf16 gates: {failures}')

  evals = eval_phase(torch, cfg, gk)
  emit('eval', nvidia_smi=name_power, **evals)

  chain = chain_phase(torch, gk)
  emit('chain', nvidia_smi=name_power, **chain)

  chain_train, failures = chain_train_phase(torch, gk, dev)
  emit('chain_train', nvidia_smi=name_power, failures=failures,
       **chain_train)
  if failures:
    raise AssertionError(f'chain_train gates: {failures}')

  # Last, so that the phases before it run as they did without it.
  cs_chain = cs_chain_phase(torch, gk, all(
      checks[name]['synthcs']['max_abs_err'] == 0 for name in checks))
  emit('cs_chain', nvidia_smi=name_power, **cs_chain)

  # The synth pipeline's training run as users launch it: after the other
  # phases, which run as they did without it.
  pipeline, failures = pipeline_phase(torch, gk, dev)
  emit('pipeline', nvidia_smi=name_power, failures=failures, **pipeline)
  if failures:
    raise AssertionError(f'pipeline gates: {failures}')

  # The synth3 pipeline's training run as users launch it, in two
  # processes: after the other phases, which run as they did without it.
  synth3, failures = synth3_pipeline_phase(torch, gk, dev)
  emit('synth3_pipeline', nvidia_smi=name_power, failures=failures,
       **synth3)
  if failures:
    raise AssertionError(f'synth3_pipeline gates: {failures}')

  def row(name, c, use, by_path):
    return {'name': name, 'route': 'cuda', 'source': SOURCE,
            'replaces': REPLACES[name], 'use': use,
            'launches': sum(by_path.values()), 'launches_by_path': by_path,
            'max_abs_err': c['max_abs_err'], 'ms': c['kernel_ms'],
            'plain_ms': c['plain_ms'], 'bound_ms': c['bound_ms'],
            'bound_by': c['bound_by'], 'bound_share': c['bound_share'],
            'library_ms': c['library_ms'],
            **({'kernel_route': c['route']} if 'route' in c else {})}

  def shape(name, dims):
    return '{} [{}]'.format('x' if name == 'glimpse_extract' else 'out',
                            ','.join(str(v) for v in dims[:4]))
  table = []
  bf16_launches = bf16['launches']
  for name, c in checks.items():
    table.append({
        **row(name, c, 'forward', {
            'serve': launches[name], 'train': train['forward_launches'][name],
            'eval': evals['launches'][name],
            'bf16_eval': bf16_launches['eval'][name],
            'bf16_train': bf16_launches['train_forward'][name]}),
        **{f'b{b}': {k: c[f'b{b}'][k] for k in (
            'kernel_ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by',
            'bound_share', 'route', 'max_abs_err') if k in c[f'b{b}']}
           for b in (8, 1)}})
  # The synth3 chain's forward shapes (their launches from the chain phase).
  for name, c in checks.items():
    table.append(row(name, c['synth3'], 'forward, synth3 chain, '
                     + shape(name, chain_dims[name]),
                     {'chain': chain['launches'][name]}))
  # The Cityscapes-shaped chain's forward shapes (their launches from the
  # cs_chain phase: its eval_split and its full pack).
  for name, c in checks.items():
    table.append(row(name, c['synthcs'], 'forward, synthcs chain, '
                     + shape(name, cs_dims[name]),
                     {'cs_chain_eval': cs_chain['launches'][name],
                      'cs_chain_full_pack':
                          cs_chain['full_pack_launches'][name]}))
  # The chain's training at b8 (launches per step of chain_train, times
  # the steps taken): paste in the box and the full model, extract forward
  # and recomputed in the full model, extract at D=1 as its pastes' d_p.
  def train_launches(name, backward):
    key = ('backward_launches_per_step' if backward
           else 'launches_per_step')
    by_path = {}
    for label, summary in (('box', chain_train['box']),
                           ('full_from_box', chain_train['full']['from_box']),
                           ('full_restored', chain_train['full']['restored'])):
      n = summary[key][name] * len(summary['steps'])
      if not backward:
        n -= summary['backward_launches_per_step'][name] * len(
            summary['steps'])
      if n:
        by_path[f'chain_train_{label}'] = n
    return by_path
  table.append(row('glimpse_paste', checks['glimpse_paste']['synth3_b8'],
                   'forward, chain training (box and full), '
                   + shape('glimpse_paste', chain_train_dims['glimpse_paste']),
                   train_launches('glimpse_paste', False)))
  table.append(row('glimpse_extract', checks['glimpse_extract']['synth3_b8'],
                   'forward, chain training (full), '
                   + shape('glimpse_extract',
                           chain_train_dims['glimpse_extract']),
                   train_launches('glimpse_extract', False)))
  table.append(row('glimpse_extract',
                   checks['glimpse_extract']['synth3_d1_b8'],
                   BACKWARD_USES['glimpse_extract'] + ', chain training '
                   '(full), ' + shape('glimpse_extract',
                                      chain_train_dims['synth3_d1_b8']),
                   train_launches('glimpse_extract', True)))
  # The synth pipeline at b8, 224x224 (launches of each stage's run, its
  # valid and trainval passes included, of the eval command line and of
  # the restored run's two steps).
  # With them, the bf16 phase's TrainingExperiment at b8.
  def pipeline_launches(name, kind):
    by_path = {}
    for label in ('box', 'full', 'eval', 'restored'):
      counts = pipeline[label]
      n = counts['launches'][name] - counts['backward_launches'][name]
      n = counts['backward_launches'][name] if kind == 'backward' else n
      if n:
        by_path[f'pipeline_{label}'] = n
    n = bf16_launches[f'experiment_{kind}'][name]
    if n:
      by_path['bf16_training_experiment'] = n
    return by_path
  for name in checks:
    table.append(row(name, checks[name]['b8'], 'forward, synth pipeline '
                     '(box, full, eval), ' + shape(name, (8,) + main_dims[
                         name][1:]), pipeline_launches(name, 'forward')))
  table.append(row('glimpse_extract',
                   checks['glimpse_extract']['pipeline_d1_b8'],
                   BACKWARD_USES['glimpse_extract'] + ', synth pipeline '
                   '(full), ' + shape('glimpse_extract', pipeline_d1),
                   pipeline_launches('glimpse_extract', 'backward')))
  # The synth3 pipeline at b8, 128x448: the box and full stages' runs and
  # the eval stage, counted in the child process, and the full stage's
  # --resume relaunch (each run's steps and valid and trainval passes).
  def synth3_launches(name, backward):
    by_path = {}
    for label, counts in (('box', synth3['box']['run_launches']),
                          ('full', synth3['full']['run_launches']),
                          ('eval', synth3['child']['eval_launches']),
                          ('full_resumed', synth3['resumed'])):
      n = counts['backward_launches'][name]
      if not backward:
        n = counts['launches'][name] - n
      if n:
        by_path[f'synth3_pipeline_{label}'] = n
    return by_path
  for name in checks:
    table.append(row(name, checks[name]['synth3_b8'], 'forward, synth3 '
                     'pipeline, ' + shape(name, chain_train_dims[name]),
                     synth3_launches(name, False)))
  table.append(row('glimpse_extract',
                   checks['glimpse_extract']['synth3_d1_b8'],
                   BACKWARD_USES['glimpse_extract'] + ', synth3 pipeline '
                   '(full), ' + shape('glimpse_extract',
                                      chain_train_dims['synth3_d1_b8']),
                   synth3_launches('glimpse_extract', True)))
  # Shapes that no phase of this script runs on a path (launches 0): the
  # strip route at Cityscapes' forward and at paste's d_p of the KITTI
  # size at b32, the general route at the 48x64 glimpse, paste at that
  # glimpse.
  for key, dims in other_extracts.items():
    table.append(row('glimpse_extract', checks['glimpse_extract'][key],
                     f'{key}, ' + shape('glimpse_extract', dims), {}))
  for name, c in checks.items():
    table.append(row(name, c['ragged'], 'ragged 48x64 glimpse, '
                     + shape(name, ragged_dims), {}))
  # The kernels' backward uses that the main paths run: extract as d_p of
  # paste (paste as d_x of extract is not on them: the flagship's glimpse
  # input needs no gradient; kernels_grad checks and times it).
  for fn_name, c in grad_checks.items():
    use = c['backward_use']
    name = use['kernel']
    by_path = {k: v for k, v in (
        ('train', train['backward_launches'][name]),
        ('bf16_train', bf16_launches['train_backward'][name])) if v}
    if not by_path:
      continue
    table.append({
        'name': name, 'route': 'cuda', 'source': SOURCE,
        'replaces': REPLACES[name], 'use': BACKWARD_USES[name],
        'launches': sum(by_path.values()), 'launches_by_path': by_path,
        'max_abs_err': max(c['d_operand']['max_abs_err'],
                           c['ragged']['d_operand']['max_abs_err']),
        'ms': use['kernel_ms'], 'plain_ms': use['plain_ms'],
        'bound_ms': use['bound_ms'], 'bound_by': use['bound_by'],
        'bound_share': use['bound_share'], 'library_ms': use['library_ms'],
        **({'kernel_route': use['route']} if 'route' in use else {})})
  emit('done', seconds=time.time() - start)
  print(json.dumps({'kernels': table}), flush=True)
  print(name_power, flush=True)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': kind, 'count': torch.cuda.device_count()}}),
        flush=True)


if __name__ == '__main__':
  if sys.argv[1:2] == ['synth3-child']:
    synth3_child(sys.argv[2])
  else:
    main()
