#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and eval paths on one CUDA card
and check them.

    python3 chip_smoke.py            # from the repository root

Phases, one JSON line each on stdout, each with the seconds since the
script started ('script_seconds'):
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
                extract D=15, paste D=1) and at the synthcs pipeline's
                train shapes (256x512, b4, extract D=15 and D=1, paste D=1),
                at Cityscapes' extract (256x512,
                b32, D=21), at paste's d_p of the KITTI size (extract D=1),
                at the H5 pipelines' (CVPPP box and full b5: extract D=4
                and D=1 at 224x224, paste; KITTI box b5 paste, full b2
                extract D=13 and D=1 and paste at 128x448; Cityscapes box
                b4 paste, full b2 extract D=21 and D=1 and paste at
                256x512) and
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
                TrainingExperiment with the split on the card (6 steps),
                read_weights of its last checkpoint to its weights.h5, the
                full model's from that file (pretrain_ctrl_net), host-fed with
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
                weights.h5 as the port reads it (control: a fresh model);
                model_opt.yaml
                read back to the config (control: read as the other model's
                config); the trained full model's eval step (the loss of
                the valid and trainval passes) on a valid batch, kernel
                against plain, each soft metric within 1e-6 relative
                (control: glimpses whose window is 8 pixels off); the eval
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
                Reported: step ms from CUDA events and at the log cadence
                (host clock), the seconds of each valid pass, checkpoint write and the restore, peak memory;
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
                the pack rolled by one example).  Reported: step ms from
                CUDA events and at the log cadence (host clock) per stage,
                the pack's seconds and bytes, the
                child process's seconds and peak resident memory, each
                stage run's seconds, peak device memory and launches;
  synthcs_pipeline
                the synthcs pipeline (run_pipeline --dataset synthcs: fg ->
                pack -> box -> full -> eval -> ap -> pixel) through
                run_pipeline.main, every stage in this process, at its
                paper widths (256x512, T=20, up to 10 instances of 2
                classes, the synthcs presets, fg at b8, box and full at
                b4), its scale cut (synthcs_stages patched): 16 train and 8
                valid examples, 2 steps a stage, a checkpoint and valid
                and trainval passes every step, each split on the card;
                then
                --stages ap,pixel again under the chain's full id on
                the committed synthcs full checkpoint over a pack file of
                the valid split's ground-truth maps, with the kernel
                glimpses and (--stages ap) the plain ones; all under a
                temporary folder in the checkout, removed after.  Gates,
                each with a control that must fail: the fg step at step 0,
                card against CPU (b2) beside its floor (the batch in the
                other order; control: the softmax CE as the per-channel
                BCE); the committed synthcs box checkpoint with its Adam
                state, one b4 step kernel against plain (control: dropped
                filter gradients) and one b2 step card against CPU
                (control: the score head through a sigmoid); the full
                controller at step 0 = the trained box's weights.h5 (the
                pipeline's handoff; control: the box's first checkpoint)
                and one b4 step kernel against plain
                at step 0 (control: dropped filter gradients), limits from
                `step_noise.py --synthcs`; the fg bytes quantised on the
                card = the host's (control: rounded, not truncated); the
                full pack read back from the pack file = pack_full's in
                memory, bit for bit (control: the slots shifted by one);
                launches per step, fg none, box 2T pastes, full 4T
                extracts on the strip route (2T as d_p) and 4T pastes
                (control: a plain step's, 0; of fg: a full step's);
                ap.json of the kernel run against the plain run (AP,
                AP_50% and per class, equal where the kernels give the
                plain bits at these shapes; control: person and rider
                swapped); pixel_eval.json of the trained fg pack against
                the host's labels of the same bytes (control: the class
                channels rolled).  Reported: step ms per stage from CUDA
                events and at the log cadence (host clock), peak device
                memory, launches per step, host
                seconds of the pack, the eval, the full pack, the ap and
                the pixel stages, the pack files' bytes, the phase's
                seconds;
  weights_h5    the weights.h5 files, read and written by the port's own
                HDF5 codec (no h5py on the card): (a) the committed box
                files the copy holds, the flagship box's against a
                SHA-256 table per key made with h5py (control: a copy with
                one float's bytes flipped), synth3's and synthcs's against
                the nets of their ckpt-12000 bit for bit (control: the
                other box's checkpoint); (b) the flagship's committed
                start: its model_opt.yaml as committed (pretrain_ctrl_net,
                the box's weights.h5, resolved against the checkout) in a
                TrainingExperiment at b32 on synthetic 224x224 images, its
                controller equal to the file's arrays and every other leaf
                to its seed-0 value (control: the seed-0 controller), one
                step gated kernel against plain at PRETRAINED_STEP_LIMITS
                (control: dropped filter gradients), then 3 steps (84
                extracts, 42 as d_p, and 84 pastes each; step ms, peak
                memory); (c) read_weights full of the flagship's
                ckpt-30000 (against the checkpoint's nets, bit for bit) and
                box of the synth3 box (against its committed file), then
                the ft2 finetune's committed model_opt.yaml (finetune,
                pretrain_net the exported file) in a TrainingExperiment:
                its parameters and b32 eval forward equal to ckpt-30000's
                bit for bit (cuDNN deterministic; control: the file
                without score_mlp), then 2 steps;
  cvppp_pipeline, kitti_pipeline
                the H5 datasets' pipelines as users launch them, without
                cv2 or h5py: (a) a layout fixture built from a seed at the
                dataset's raw size (CVPPP A1's 128 plants at 530x500 with
                1-20 leaves each, the labels palette-indexed PNGs; KITTI
                cut to 32 train, 16 valid and 8 test images at 375x1242
                with 1-20 cars each); (b) assembled by cli.setup_dataset
                (224x224 and 128x448); (c) run_pipeline --dataset cvppp
                (box -> full -> eval, b5) or kitti (fg b8 -> pack into the
                H5 -> box b5 -> full b2 -> eval) at the paper presets, 2
                steps a stage; (d) gates, each with a control that must
                fail: the PNG codec's round trips over every colour type,
                bit depth and filter (control: Paeth rows read as Up), the
                JAX-written synthetic H5 of tests/fixtures read to the
                digest the CPU tests pin against JAX (control: the
                channels reversed), KITTI's fg maps read back from the H5
                equal to those packed, bit for bit (control: the maps
                flipped before writing), the trained full model's eval
                step kernel against plain (control: the window 8 pixels
                off), the full model's model_opt.yaml naming the box's
                weights.h5 and the eval CSVs (control: the box's folder),
                launches per step (control: a plain step's).  Reported:
                the fixture's and each split's assemble seconds and bytes,
                decode ms per example, step ms per stage (CUDA events and
                the log cadence), peak memory, the pack's seconds, eval
                host seconds per batch, launches;
  cityscapes_pipeline
                Cityscapes as users launch it, on the same path: (a)
                Cityscapes' layout (leftImg8bit and gtFine polygon JSON)
                drawn from a seed at 2048x1024, 8 train, 4 valid and 4 test
                images, each with sky, building and road and, but in test,
                1-20 concave or crossed instances of the 8 classes (some
                off the image), a cargroup, a caravan and a deleted car;
                data.cityscapes_prep.main writes the instanceIds and
                labelIds PNGs; (b) cli.setup_dataset at 256x512; (c)
                run_pipeline --dataset cityscapes (fg b8 -> pack into the
                three H5 files -> box b4 -> full b2 -> full_pack of valid
                and test -> cityscapes_eval of valid and test) at the paper
                presets, 2 steps a stage; (d) the gates of the other H5
                pipelines and three more, each with a control: the prep's
                images to the digest the CPU tests pin with JAX's prep
                (cv2; control: a polygon moved by a pixel), the assembled
                files to the digest pinned with JAX's assembler (control:
                the classes permuted), the AP of a pack of the valid
                split's ground truth through cli.cityscapes_eval.main and
                instance_eval.main to the AP the CPU tests pin (control:
                the masks shifted 8 pixels); and the files: each valid and
                test image's submission text file, its masks 0/255 at
                1024x2048.  Reported also: the prep's seconds, the
                cityscapes_eval host seconds per image (chain, analyzers,
                renders, submission), the full pack's seconds.  KITTI's
                phase ends with the fg eval command line (cli.eval fg) of
                its trained fg model over the valid split: the foreground
                at each image's size (375x1242), the orientation and the
                target at the model's (control: all at the model's), and
                the same command on the CPU, whose renders the card's
                match within KITTI_FG_PIXELS_DIFFER pixels a file
                (control: the CPU's foreground at 0.55);
  calibrate     the flagship's count calibration as users run it
                (pipelines.calibrate_count.main at b32: count_diag of the
                train split, the eval command line on the valid split at
                the calibrated stop score over six mask thresholds, the
                capped train sweep, count_calibration.json) over a
                temporary copy of its folder (checkpoint, both YAML files,
                output_valid/), the synth224 splits (256 train, 64 valid)
                drawn anew from its data_opt.yaml, cuDNN deterministic.
                Gates, each with a control that must fail: count_diag's
                scores with the plain glimpses within 1e-4 of the kernel
                run's per example and its pick the same (control: the true
                counts one slot off); the valid split at the calibrated
                thresholds with the plain glimpses, per-example SBD within
                the eval phase's limit and counts equal (control: the mask
                threshold 0.2 higher); the files written (control: the
                train sweep with renders); launches (18 forwards at b32).
                The picks and the headline are printed beside the
                committed count_calibration.json's, which JAX drew on its
                own images; host seconds of each step;
  fg_eval       the fg eval and the foreground eval as users run them on
                the committed synth3 fg and full checkpoints, 8 synthetic
                128x448 valid images: cli.eval fg on the card and on the
                CPU, the fg pack, cli.eval of the full model with
                --foreground_folder (the card's renders at 0.5),
                --remove_tiny 100 and its renders.  Gates, each with a
                control: the fg renders card against CPU pixel for pixel
                within FG_EVAL_PIXELS_DIFFER a file (control: the CPU's at
                0.55), the foreground eval's per-example SBD and counts
                kernel against plain (control: the fg target's renders as
                the foreground), the renders' names and counts (control:
                the train split's).
The `pipeline` phase's full stage also runs the train command line's plot
hook once (at step 0, num_samples_plot 5); it reports whether matplotlib
imports on the machine and gates its PNGs and catalog lines, or, without
it, the warning and the steps all taken (control: the box's plot list, or
the warnings without that one); dashboard.generate of that logs folder
against the same call in a process without the card, byte for byte
(control: a loss value changed); and profiling.trace around one train
step, whose Chrome trace must name paste_kernel and extract_tiled_kernel
(control: the same check of that trace for extract_strip_kernel, which the
step does not launch).
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
SCRIPT_START = time.time()
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
# The count calibration: calibrate_count at the batch of the eval phase;
# count_diag's scores kernel against plain per example within this (the
# serving gate's s_out limit); the valid eval's control at a mask threshold
# this much higher.
CALIBRATE_BATCH = 32
CALIBRATE_S_OUT_ATOL = 1e-4
CALIBRATE_CONTROL_SHIFT = 0.2
# The fg eval on the synth3 checkpoints: the split's settings with 32 train
# examples (8 valid), the pipeline's batch; the foreground eval removes
# regions of at most JAX's ap_remove_tiny default.  The fg renders card
# against CPU may differ in at most this many pixels a file, by folder:
# twice what TF32 convolutions moved on one H100 80GB HBM3 at 700 W (2 of
# the foreground at 0.5, 12 of the orientation, whose argmax flips at near
# ties; `python3 step_noise.py --fg-eval`), a larger perturbation than
# this script's float32 path, which moved none; the target is the
# dataset's.
FG_EVAL_EXAMPLES, FG_EVAL_BATCH, FG_EVAL_REMOVE_TINY = 32, 8, 100
FG_EVAL_PIXELS_DIFFER = {'50': 4, 'orientation': 24, 'gt': 0}
# KITTI's fg eval at the images' size (kitti_pipeline's fg model over its
# 16 valid images, resized to 375x1242 before the threshold), card against
# CPU: at most this many pixels differing a file, by folder, by the same
# rule: twice what TF32 moved on one H100 80GB HBM3 at 700 W (6 of the
# foreground, 4 of the orientation; `python3 step_noise.py --fg-eval`),
# where float32 moved none and the 0.55 control 9,402.
KITTI_FG_PIXELS_DIFFER = {'50': 12, 'orientation': 8, 'gt': 0}
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
# against plain to EVAL_STEP_REL_LIMIT relative.  On one H100 80GB HBM3 at
# 700 W kernel against plain and reordered plain read 0.0 in eight runs
# (reordered plain up to 1.8e-7 in one earlier run).  After 6 steps the
# model's masks barely depend on where its glimpses look: the window
# transposed, near a symmetry of such a model, moved the metrics by 1.3e-5
# to 1.7e-3 in seven runs and by less than 1e-5 in one, and a window one
# pixel off by 5.3e-6 in one run.  So the limit is 1e-6, five times the
# highest floor, and the control is a window EVAL_STEP_CONTROL_SHIFT
# pixels off, which no symmetry undoes.
EVAL_STEP_METRICS = ('loss', 'box_loss', 'segm_loss', 'conf_loss',
                     'iou_soft', 'iou_soft_box', 'wt_cov_soft',
                     'unwt_cov_soft')
EVAL_STEP_REL_LIMIT = 1e-6
EVAL_STEP_CONTROL_SHIFT = 8
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

# The synthcs pipeline (rec_attend_tpu_torch/pipelines/run_pipeline.py
# --dataset synthcs) at its paper widths, 256x512, T=20, up to 10 instances
# of 2 classes, the synthcs presets, fg at b8 and box and full at b4 (JAX
# run_pipeline.py:392-415), its scale cut: 16 train examples (8 valid, the
# provider's least), 2 steps a stage (the script's time), a checkpoint
# every step (ckpt-1 and ckpt-2 kept), valid and trainval passes every step
# with one batch, each split on the device, every stage in one process (the
# synth3 phase runs a chain across processes).
SYNTHCS_EXAMPLES, SYNTHCS_STEPS, SYNTHCS_EVERY = 16, 2, 1
SYNTHCS_TRAIN_BATCH = 4
# The box gate restores the committed synthcs box checkpoint with its Adam
# state (7 MB; its weights.h5 stays out of the copy).
SYNTHCS_BOX_DIR = os.path.join(REPO, 'results', 'box_model_synthcs-20260818a')
# The phase's step gates, each limit twice the largest float32 floor that
# `step_noise.py --synthcs` measured over five batches (one H100 80GB HBM3
# at 700 W):
# - fg at step 0 (its seed-0 initial parameters), card against CPU (b2).
#   Its floor, the card's step on the batch in the other order against the
#   card's step, reached 0.0177 in the worst leaf's gradient (a BatchNorm
#   leaf of 33 layers over two images), 0.00775 in all gradients at once
#   and 0.128 in the worst leaf's update; card against CPU reached 0.0232,
#   0.0114 and 0.103.  The control (the per-channel BCE) read 0.49 and more
#   in the worst leaf's gradient and 0.25 in the loss.
SYNTHCS_FG_STEP_LIMITS = {'loss_rel_diff': 1e-4, 'grad_rel_l2_max': 0.036,
                          'grad_rel_l2_all': 0.016,
                          'zero_grad_share_max': 1e-4,
                          'update_rel_l2_max': 0.26,
                          'zero_update_in_lr_max': 2.0}
# - box from the committed synthcs checkpoint, kernel against plain (b4)
#   and card against CPU (b2).  Kernel against plain stays below 1.3e-6 in
#   any leaf's gradient.  Card against CPU reached 3.94e-3 in the worst
#   leaf (the first convolution's weight, a sum over 20 timesteps of
#   256x512 pixels), and that is the CPU's own float32 error: against the
#   same step in float64 the CPU read up to 3.97e-3 there (3.25e-3 in all
#   gradients, 2.77e-2 in the worst update, 1.14e-4 in the loss), the card
#   3.8e-4 at most.  The limits are twice the CPU's distance; the controls
#   read 0.59 and more (the sigmoid score head) and 1.0 (dropped filter
#   gradients) in the worst leaf's gradient.
SYNTHCS_BOX_STEP_LIMITS = {'loss_rel_diff': 2.3e-4, 'grad_rel_l2_max': 8e-3,
                           'grad_rel_l2_all': 6.5e-3,
                           'zero_grad_share_max': 1e-4,
                           'update_rel_l2_max': 0.056,
                           'zero_update_in_lr_max': 2.0}
# - full at step 0 from the controller of a box near its initial
#   parameters, kernel against plain (b4).  The floor (reordered plain
#   against plain) reached 7.87e-3 in the worst leaf's gradient, 8.93e-4 in
#   the median leaf's and 0.0472 in the worst update; kernel against plain
#   1.2e-5, 5.4e-7 and 1.8e-3.  The dropped-filter-gradient control read
#   0.36, 3.1e-3 and 0.92 and more.  All gradients at once are not gated:
#   the fresh attention nets' gradients outweigh the controller's, so the
#   control moves them by 3.4e-4 to 6.4e-4 only, below the floor's 1.67e-3.
SYNTHCS_FULL_STEP_LIMITS = {'loss_rel_diff': 1e-4, 'grad_rel_l2_max': 0.016,
                            'grad_rel_l2_median': 1.8e-3,
                            'zero_grad_share_max': 1e-4,
                            'update_rel_l2_max': 0.095,
                            'zero_update_in_lr_max': 2.0}

# Phase weights_h5: the flagship's box model, whose folder holds its
# weights.h5 and its two YAML files and no checkpoint (the flagship's
# model_opt.yaml names that file in pretrain_ctrl_net), and the flagship's
# finetune ft2, whose model_opt.yaml names the flagship's exported
# weights.h5 in pretrain_net.  The start and the finetune train at b32 on
# synthetic 224x224 images, 3 and 2 steps.
FLAGSHIP_BOX_DIR = os.path.join(REPO, 'results',
                                'box_model_synth-20260816104712')
FT2_DIR = os.path.join(REPO, 'results', 'full_model_synth_ft2-r4')
PRETRAIN_FIELDS = ('pretrain_ctrl_net', 'pretrain_attn_net', 'pretrain_net')
WEIGHTS_H5_BATCH = 32
WEIGHTS_H5_START_STEPS, WEIGHTS_H5_FT_STEPS = 3, 2
# Its step gate, kernel against plain (b32) at step 0 from the committed
# start: the controller from the box's weights.h5, the attention nets and
# the score MLP at their seed-0 values, whose BatchNorm leaves' gradients
# are float32 noise of nearly constant activations.  `step_noise.py
# --pretrained` over five b32 batches (one H100 80GB HBM3 at 700 W): the
# floor (reordered plain against plain) reached 0.0104 in the worst leaf's
# gradient, 0.118 in the worst leaf's update and 1.71 lr in the
# zero-gradient biases' update, above half of STEP_LIMITS; 0 in the loss
# and 5.9e-6 in the zero-gradient share, below.  So the first two limits
# are twice the floor; the loss and the zero-gradient share keep
# STEP_LIMITS'; the biases' update keeps 2 lr, the most that Adam's first
# step can move two sides apart (twice the floor would pass any step).
# Kernel against plain reached 5.6e-6, 3.4e-4 and 0.84 lr; the control
# (dropped filter gradients) 1.02 and more in the worst leaf's gradient
# and 1.52 and more in its update.
PRETRAINED_STEP_LIMITS = {'loss_rel_diff': 1e-4, 'grad_rel_l2_max': 0.021,
                          'zero_grad_share_max': 1e-4,
                          'update_rel_l2_max': 0.24,
                          'zero_update_in_lr_max': 2.0}

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
  """One phase's JSON line, with the seconds since the script started
  ('script_seconds': the phases' times are its differences)."""
  print(json.dumps({'phase': phase, **fields,
                    'script_seconds': time.time() - SCRIPT_START}),
        flush=True)


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


def shifted_plain(torch, shift):
  """Plain glimpses whose window is ``shift`` pixels down and right (f_y
  and f_x rolled by that many rows): the negative control of the eval
  step's gate, a kernel that misplaces its window."""
  def roll(f):
    return torch.roll(f, shift, dims=1)
  return (lambda x, f_y, f_x: torch.einsum('bhf,bhwd,bwg->bfgd', roll(f_y),
                                           x, roll(f_x)),
          lambda p, f_y, f_x: torch.einsum('bhf,bfgd,bwg->bhwd', roll(f_y),
                                           p, roll(f_x)))


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

  from rec_attend_tpu_torch import train_step as ts
  from rec_attend_tpu_torch.cli import eval as eval_cli
  from rec_attend_tpu_torch.cli import read_weights
  from rec_attend_tpu_torch.cli import train as train_cli
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
  from rec_attend_tpu_torch.utils import logger

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

    def stage(spec, cfg, tcfg, plot_fn=None):
      reset_peak(torch, dev)
      gk.reset_launch_counts()
      t0 = time.time()
      exp = TrainingExperiment(spec, cfg, tcfg, data_cfg, plot_fn=plot_fn,
                               device=dev)
      setup = time.time() - t0
      valid_s, ckpt_s = [], []
      exp._eval_pass = timed_calls(torch, dev, exp._eval_pass, valid_s)
      exp.checkpoint = timed_calls(torch, dev, exp.checkpoint, ckpt_s)
      return exp, {'setup_seconds': setup, 'eval_pass_seconds': valid_s,
                   'checkpoint_seconds': ckpt_s}

    def finish(exp, summary):
      t0 = time.time()
      with recorded_runs(torch, gk, dev) as runs:
        exp.run()
      exp.close()
      summary['run_seconds'] = time.time() - t0
      summary.update(step_ms_summary(runs[0]))
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
    bs = train_cfg.batch_size
    n_train = box.train_ds.get_dataset_size()
    idx = np.random.RandomState(0).permutation(n_train)[:bs]
    out['box']['gather_gate'] = gate(
        'box device split gather against the host batch',
        split_gather_diff(torch, ts, box, idx, idx),
        split_gather_diff(torch, ts, box, idx, (idx + 1) % n_train))

    # ---- full: from the box's weights.h5, host-fed ----------------------
    # The handoff of run_pipeline.run_synth: the box's last checkpoint
    # exported by read_weights, the file named in pretrain_ctrl_net.
    box_weights = read_weights.box_main(
        ['--model_id', box.model_id, '--results', results], device=dev)
    full_cfg = full_base.replace(pretrain_ctrl_net=box_weights)
    full_train_cfg = train_cfg.replace(model_id='full_model_synth-chip',
                                       device_data=False)
    # The train command line's plot hook, on a cadence that plots once (at
    # step 0); its warnings kept, to see a failed plot.
    warnings = []
    log = logger.get()

    def keep_warning(warning):
      def wrapped(msg, *a, **kw):
        warnings.append(str(msg))
        return warning(msg, *a, **kw)
      return wrapped
    full, out['full'] = stage(
        'full', full_cfg, full_train_cfg.replace(steps_per_plot=steps),
        plot_fn=train_cli._default_plot_fn('full'))
    ctrl = h5_state(box_weights, CTRL_NETS)
    out['full']['pretrained_gate'] = gate(
        'full step 0 controller against the box weights.h5',
        state_diff(torch, full.trainer.model.state_dict(), ctrl),
        state_diff(torch, FullModel(full_base, device=dev).state_dict(),
                   ctrl))
    with patched(log, 'warning', keep_warning):
      finish(full, out['full'])
    ckpt_gates(full, full_cfg, out['full'])
    out['plots'] = plots_gates(full, warnings, gate, steps)
    out['dashboard'] = dashboard_gate(full.logs_folder, root, gate)

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
    control, _ = eval_step_metrics(
        torch, ts, matching, model, valid_batch,
        shifted_plain(torch, EVAL_STEP_CONTROL_SHIFT), pinned=plain_solved)
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
    out['profiler'] = trace_gate(torch, ts, matching, full, valid_batch,
                                 draws, root, gate) if cuda else None
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


# The plot hook's images of the full model, in the order JAX registers
# them (rec_attend_tpu/utils/plot_utils.py:179-190), and the box model's.
FULL_PLOTS = ('input', 'output', 'total_instances', 'patch', 'glimpse')
BOX_PLOTS = ('input', 'output', 'glimpse')
# The glimpse kernels as a trace names them (the flagship's shapes take
# the tiled extract).
TRACE_KERNELS = ('paste_kernel', 'extract_tiled_kernel')
TRACE_ABSENT = 'extract_strip_kernel'


def matplotlib_imports():
  """Whether matplotlib (and the PIL it needs) imports here, as the plots
  import it."""
  from rec_attend_tpu_torch.utils import plot_utils
  try:
    plot_utils._pyplot()
    return True
  except ImportError:
    return False


def plots_gates(exp, warnings, gate, steps):
  """The plot hook of a full model's run: with matplotlib, the PNGs and
  the catalog's image lines of FULL_PLOTS (control: BOX_PLOTS'); without,
  the failed plot's warning and the run's steps all taken (control: the
  warnings with that one left out)."""
  catalog_path = os.path.join(exp.logs_folder, 'catalog')
  with open(catalog_path) as f:
    images = [line.strip() for line in f if ',image,' in line]
  out = {'matplotlib_imports': matplotlib_imports(), 'catalog_images': images,
         'warnings': warnings[:3], 'step': exp.step}

  def image_failures(names):
    want = [f'{n}.png,image,{n}' for n in names]
    failures = [] if images == want else [f'catalog {images}, want {want}']
    for n in names:
      path = os.path.join(exp.logs_folder, f'{n}.png')
      if not os.path.exists(path):
        failures.append(f'no {n}.png')
        continue
      with open(path, 'rb') as f:
        if f.read(8) != b'\x89PNG\r\n\x1a\n':
          failures.append(f'{n}.png is not a PNG')
    return failures

  def warned_failures(kept):
    failed = [w for w in kept if w.startswith('plotting failed')]
    return ([] if len(failed) == 1 else [f'warnings {kept[:3]}']) + (
        [] if exp.step == steps else [f'step {exp.step}'])
  if out['matplotlib_imports']:
    out['gate'] = gate('plots', image_failures(FULL_PLOTS),
                       image_failures(BOX_PLOTS))
  else:
    out['gate'] = gate('a failed plot warns and training goes on',
                       warned_failures(warnings),
                       warned_failures([w for w in warnings if not
                                        w.startswith('plotting failed')]))
  return out


def dashboard_gate(logs_folder, root, gate):
  """dashboard.generate of a run's logs folder here against the same call
  in a process that sees no card, byte for byte (control: the call on a
  copy of the folder with one loss value changed)."""
  import shutil

  from rec_attend_tpu_torch.utils import dashboard
  outputs = {k: os.path.join(root, f'index_{k}.html')
             for k in ('card', 'cpu', 'control')}
  t0 = time.time()
  dashboard.generate(logs_folder, outputs['card'])
  seconds = time.time() - t0
  subprocess.run(
      [sys.executable, '-c', 'import sys\nfrom rec_attend_tpu_torch.utils '
       'import dashboard\ndashboard.generate(sys.argv[1], sys.argv[2])',
       logs_folder, outputs['cpu']], check=True, cwd=REPO, timeout=300,
      env=dict(os.environ, CUDA_VISIBLE_DEVICES='', PYTHONPATH=REPO))
  changed = os.path.join(root, 'logs_changed')
  shutil.copytree(logs_folder, changed)
  path = os.path.join(changed, 'loss.csv')
  with open(path) as f:
    lines = f.read().splitlines()
  last = max(i for i, line in enumerate(lines)
             if i and line.split(',')[2:3] not in ([], ['']))
  parts = lines[last].split(',')
  parts[2] = repr(float(parts[2]) + 1.0)
  lines[last] = ','.join(parts)
  with open(path, 'w') as f:
    f.write('\n'.join(lines) + '\n')
  dashboard.generate(changed, outputs['control'])
  pages = {}
  for k, path in outputs.items():
    with open(path, 'rb') as f:
      pages[k] = f.read()

  def differs(other):
    return [] if pages['card'] == pages[other] else [
        f'{len(pages["card"])} bytes against {len(pages[other])}, first '
        'differing at ' + str(next(i for i, (a, b) in enumerate(
            zip(pages['card'], pages[other] + b'\0' * len(pages['card'])))
                                   if a != b))]
  return {'bytes': len(pages['card']), 'seconds': seconds,
          'images': pages['card'].count(b'data:image/png'),
          'charts': pages['card'].count(b'<svg'),
          'gate': gate('dashboard card process against a CPU process',
                       differs('cpu'), differs('control'))}


def trace_gate(torch, ts, matching, exp, batch, draws, root, gate):
  """profiling.trace around one train step of ``exp``'s model: its Chrome
  trace names both glimpse kernels (control: the same check of the same
  trace for TRACE_ABSENT, a kernel that this step does not launch)."""
  from rec_attend_tpu_torch.utils import profiling
  folder = os.path.join(root, 'trace')
  t0 = time.time()
  with profiling.trace(folder):
    one_step(torch, ts, matching, exp.trainer.model, exp.trainer.opt_state,
             batch, draws, exp.step, 'kernel')
  out = {'seconds': time.time() - t0}
  path = os.path.join(folder, profiling.TRACE_NAME)
  out['trace_bytes'] = os.path.getsize(path)
  with open(path) as f:
    events = json.load(f)['traceEvents']
  kernels = {e['name'] for e in events if e.get('cat') == 'kernel'}
  out['device_events'] = sum(e.get('cat') == 'kernel' for e in events)
  out['glimpse_kernels'] = sorted(k for k in kernels if any(
      name in k for name in TRACE_KERNELS + (TRACE_ABSENT,)))

  def missing(names):
    return [f'no {n} in the trace' for n in names
            if not any(n in k for k in kernels)]
  out['gate'] = gate('the profiler trace names both glimpse kernels',
                     missing(TRACE_KERNELS), missing((TRACE_ABSENT,)))
  return out


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


@contextlib.contextmanager
def chain_patched(run_pipeline, dataset, wrap):
  """The configs function of ``run_pipeline.CHAINS[dataset]`` replaced
  by ``wrap(it)`` inside the block."""
  chains = run_pipeline.CHAINS
  saved = chains[dataset]
  chains[dataset] = (saved[0], wrap(saved[1])) + tuple(saved[2:])
  try:
    yield
  finally:
    chains[dataset] = saved


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
  kernel launches (``counts_delta`` around the step) and, on the card, its
  ms between CUDA events recorded around it ('step_ms').
  ``before(exp)``, if given, is called as each run starts.  Yields the
  list of records."""
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
      if rec.get('step_events'):
        torch.cuda.synchronize()
        rec['step_ms'] = [a.elapsed_time(b) for a, b in
                          rec.pop('step_events')]
      rec['run_seconds'] = time.time() - t0
      rec['max_memory_allocated_bytes'] = peak_memory(torch, dev)
      rec['launches_at_end'] = launches_now(gk)
      rec['run_launches'] = counts_delta(start, rec['launches_at_end'])
      return out
    return call

  def record_step(step):
    def call(trainer, batch):
      before = launches_now(gk)
      events = None
      if dev.type == 'cuda':
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        events[0].record()
      out = step(trainer, batch)
      if events is not None:
        events[1].record()
      if runs:
        runs[-1]['step_launches'].append(counts_delta(before,
                                                      launches_now(gk)))
        if events is not None:
          runs[-1].setdefault('step_events', []).append(events)
      return out
    return call
  with patched(TrainingExperiment, 'run', record_run), \
      patched(Trainer, 'train_step', record_step):
    yield runs


def step_ms_summary(rec):
  """A ``recorded_runs`` record's step ms from CUDA events and their
  median (None off the card)."""
  got = rec.get('step_ms')
  return {'step_ms': got,
          'step_ms_median': statistics.median(got) if got else None}


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


def chain_cut(examples, ckpt_steps=PIPELINE_CKPT_STEPS,
              eval_steps=PIPELINE_EVAL_STEPS):
  """A wrapper of ``run_pipeline.synth3_stages`` or ``synthcs_stages`` for
  ``chain_patched``: the stages' configs with the phase's scale cut, ``examples``
  train examples, checkpoints every ``ckpt_steps``, log rows every step,
  one-batch valid and trainval passes every ``eval_steps``, and each split
  on the device."""
  def wrap(stages):
    def call(*args, **kw):
      data_cfg, fg_cfg, box_cfg, full_base, train_cfg, steps, batch = stages(
          *args, **kw)
      return (data_cfg.replace(num_examples=examples), fg_cfg, box_cfg,
              full_base, train_cfg.replace(
                  steps_per_ckpt=ckpt_steps,
                  steps_per_log=PIPELINE_LOG_STEPS,
                  steps_per_valid=eval_steps, steps_per_trainval=eval_steps,
                  num_batch_valid=1, device_data=True), steps, batch)
    return call
  return wrap


def synth3_child(spec_path):
  """The second process of the ``synth3_pipeline`` phase, ``chip_smoke.py
  synth3-child SPEC``: ``run_pipeline.main`` on the spec's 'argv' and
  'device', its scale cut (``chain_cut`` of 'examples'), inside
  ``recorded_runs``.  Writes to the spec's 'out' the stages' ids, each
  run's record and the launches of the stages after the runs (eval), and
  to its 'split' the box stage's d_in and y_in as they lie on the device
  and the full model's controller as its run starts ('full_ctrl/...')."""
  import numpy as np
  import torch

  from rec_attend_tpu_torch.models.full_model import CTRL_NETS
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
    if exp.spec.name == 'full':
      # The full model's controller as its run starts (a copy: on the CPU
      # the array would share the parameter's memory).
      split.update({f'full_ctrl/{k}': v.cpu().numpy().copy()
                    for k, v in exp.trainer.model.state_dict().items()
                    if k.split('.')[0] in CTRL_NETS})
  gk.reset_launch_counts()
  t0 = time.time()
  with recorded_runs(torch, gk, dev, keep_split) as runs, chain_patched(
      run_pipeline, 'synth3', chain_cut(spec['examples'])):
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
  """The port's synth3 pipeline (``run_pipeline.run_chain``) at ``scale``
  on ``dev`` through ``run_pipeline.main``, its scale cut (``chain_cut``
  of ``examples``, ``steps`` steps a stage), each split on the device:
  ``--stages fg,pack`` in this process, ``--stages box,full,eval`` in a
  ``chip_smoke.py synth3-child`` process (the pack crosses in its files;
  the child counts its own launches), then a ``--resume`` relaunch that
  goes on with the full stage.  Results, logs and pack files go to a
  temporary folder in the checkout, removed after.  Returns (results, the
  gates' failures); each gate's control must fail, else it is a failure
  too."""
  import numpy as np

  from rec_attend_tpu_torch import convert
  from rec_attend_tpu_torch import train_step as ts
  from rec_attend_tpu_torch.cli import eval as eval_cli
  from rec_attend_tpu_torch.cli.pack import quantise
  from rec_attend_tpu_torch.config import BoxModelConfig
  from rec_attend_tpu_torch.config import DataConfig
  from rec_attend_tpu_torch.config import FullModelConfig
  from rec_attend_tpu_torch.data import provider
  from rec_attend_tpu_torch.data.provider import PackedDataset
  from rec_attend_tpu_torch.engine.experiment import EvalExperiment
  from rec_attend_tpu_torch.engine.saver import list_checkpoints
  from rec_attend_tpu_torch.models.full_model import CTRL_NETS
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
    cut = chain_cut(examples)
    data_cfg, _, _, full_base, train_cfg, _, _ = cut(
        run_pipeline.synth3_stages)(
        scale, results, logs, data, data_examples=examples)
    T, bs = full_base.timespan, train_cfg.batch_size
    ckpts = list(range(PIPELINE_CKPT_STEPS, steps + 1,
                       PIPELINE_CKPT_STEPS))[-2:]

    def stage_summary(model_id, rec):
      """Step ms from CUDA events and at the log cadence (host clock),
      losses at the log cadence, the kept checkpoints, and the run's
      record."""
      folder = os.path.join(logs, model_id)
      summary = {**step_ms_summary(rec),
                 'step_ms_at_log': log_rows(folder, 'step_time'),
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
    with recorded_runs(torch, gk, dev) as runs, chain_patched(
        run_pipeline, 'synth3', cut), patched(
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

    # ---- full: its controller as it started, against the box's file -----
    # The child's run_pipeline handed the box over as weights.h5.
    full_ctrl = {k[len('full_ctrl/'):]: torch.from_numpy(v)
                 for k, v in resident.items() if k.startswith('full_ctrl/')}
    box_folder = os.path.join(results, ids['box'])
    box_cfg = BoxModelConfig.from_yaml(os.path.join(box_folder,
                                                    'model_opt.yaml'))
    first = convert.params_from_checkpoint(
        os.path.join(box_folder, f'ckpt-{ckpts[0]}.npz'), box_cfg)
    ctrl = h5_state(os.path.join(box_folder, 'weights.h5'), CTRL_NETS)
    out['full']['pretrained_gate'] = gate(
        'full step 0 controller against the box\'s weights.h5',
        state_diff(torch, full_ctrl, ctrl) or (
            [] if sorted(full_ctrl) == sorted(ctrl) else ['leaves differ']),
        state_diff(torch, full_ctrl, {k: v for k, v in first.items()
                                      if k in full_ctrl}))

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
    with recorded_runs(torch, gk, dev) as runs, chain_patched(
        run_pipeline, 'synth3', cut):
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


class SigmoidScores:
  """``torch`` as the box model's module sees it, but its softmax a sigmoid
  of each channel: the control of the multiclass score head (channel 0,
  the background, through a sigmoid of its own logit)."""

  def __init__(self, torch):
    self._torch = torch

  def __getattr__(self, name):
    return getattr(self._torch, name)

  def softmax(self, x, dim=-1):
    return self._torch.sigmoid(x)


def synthcs_fg_gates(torch, ts, matching, model, opt_state, batch, draws,
                     step, lr, limits):
  """The multiclass fg step held to ``limits``, card against CPU (b2),
  beside its floor (the card's step on the batch in the other order against
  the card's step).  Control: the step whose softmax CE over the classes
  is the per-channel BCE of the one-class branch, which must fail the
  worst leaf's gradient gate where the CE is the segmentation loss
  (``segm_loss_fn`` 'bce', as in the synthcs preset; the tiny config's IoU
  loss leaves it out, and there the control is reported only).  Returns
  (gates, failures)."""
  from rec_attend_tpu_torch.models import fg_model
  gates, failures, host = cpu_gate(torch, ts, matching, model, opt_state,
                                   batch, draws, step, lr, limits)
  small = {k: v[:CHAIN_TRAIN_CPU_BATCH] for k, v in batch.items()}

  def card(b=small):
    with deterministic_cudnn(torch):
      return one_step(torch, ts, matching, model, opt_state, b, draws, step,
                      'kernel')
  gates['swapped_batch_vs_card'] = step_diff(
      torch, model, card({k: v.flip(0) for k, v in small.items()}), card(),
      lr)
  nsc = model.cfg.num_semantic_classes

  def bce(f_ce):
    return lambda y, t: (fg_model.losses.f_bce(y, t) if y.shape[-1] == nsc
                         else f_ce(y, t))
  with patched(fg_model.losses, 'f_ce', bce):
    control = card()
  stats = step_diff(torch, model, control, host, lr)
  stats['failed'] = step_gate_failures(stats, limits)
  gates['per_channel_bce_vs_cpu'] = stats
  if (model.cfg.segm_loss_fn == 'bce'
      and 'grad_rel_l2_max' not in stats['failed']):
    failures.append('control per_channel_bce passes the grad_rel_l2_max '
                    'gate')
  return gates, failures


def synthcs_box_gates(torch, ts, matching, gk, model, opt_state, batch,
                      draws, step, lr, limits):
  """The multiclass box step held to ``limits``: kernel against plain (b4,
  with the reordered plain floor and the dropped-filter-gradient control,
  ``step_gates``) and card against CPU (b2), beside the card's step on the
  batch in the other order against the card's step, where the card's step
  with its score head through a sigmoid (``SigmoidScores``, the CPU's
  matchings pinned) must fail the worst leaf's gradient gate.  Returns
  (gates, failures, the CPU's step)."""
  from rec_attend_tpu_torch.models import box_model
  gates, failures = step_gates(torch, ts, matching, gk, model, opt_state,
                               batch, draws, step, lr, limits)
  nb = CHAIN_TRAIN_CPU_BATCH
  small_draws = {'aug': draws['aug'],
                 'segm_noise': draws['segm_noise'][:, :nb]}
  g, f, host = cpu_gate(torch, ts, matching, model, opt_state, batch,
                        small_draws, step, lr, limits)
  gates.update(g)
  failures += f
  small = {k: v[:nb] for k, v in batch.items()}
  noise = to_device(small_draws, model.device)

  def card(b=small, draws=noise, pinned=None):
    with deterministic_cudnn(torch):
      return one_step(torch, ts, matching, model, opt_state, b, draws,
                      step, 'kernel', pinned)
  gates['swapped_batch_vs_card'] = step_diff(
      torch, model, card({k: v.flip(0) for k, v in small.items()},
                         dict(noise, segm_noise=noise['segm_noise'].flip(1))),
      card(), lr)
  with patched(box_model, 'torch', SigmoidScores):
    control = card(pinned=host[4]['solved'])
  stats = step_diff(torch, model, control, host, lr)
  stats['failed'] = step_gate_failures(stats, limits)
  gates['sigmoid_scores_vs_cpu_pinned'] = stats
  if 'grad_rel_l2_max' not in stats['failed']:
    failures.append('control sigmoid_scores passes the grad_rel_l2_max gate')
  return gates, failures, host


def read_json(*path):
  with open(os.path.join(*path)) as f:
    return json.load(f)


def synthcs_pipeline_phase(torch, gk, dev, scale='paper',
                           examples=SYNTHCS_EXAMPLES, steps=SYNTHCS_STEPS,
                           bit_equal=False, oracle_dir=CS_FULL_DIR,
                           ap_remove_tiny=CS_AP_REMOVE_TINY,
                           limits=(SYNTHCS_FG_STEP_LIMITS,
                                   SYNTHCS_BOX_STEP_LIMITS,
                                   SYNTHCS_FULL_STEP_LIMITS)):
  """The port's synthcs pipeline (``run_pipeline.run_chain``) at
  ``scale`` on ``dev`` through ``run_pipeline.main``, all its stages in
  this process, its scale cut (``chain_cut`` of ``examples``, ``steps``
  steps a stage, checkpoints and passes every SYNTHCS_EVERY), each split
  on the device; then ``--stages ap,pixel --ap_remove_tiny
  <ap_remove_tiny>`` again (the first run ran the eval stage) on the
  trained full model of ``oracle_dir``
  (the committed synthcs one) over a pack file of the ground truth's maps,
  with the kernel glimpses and (``--stages ap``) the plain ones.  The box
  gate restores SYNTHCS_BOX_DIR at the paper scale, the pipeline's own box
  at the tiny one; ``limits`` are the (fg, box, full) step gates'.
  ``bit_equal``: the kernels gave the
  plain versions' bits at this phase's shapes (the kernels phase), so the
  AP of the two must be equal; else it is held to the reordered-plain
  floor as in cs_chain.  Results, logs and pack files go to a temporary
  folder in the checkout, removed after.  Returns (results, the gates'
  failures); each gate's control must fail, else it is a failure too."""
  import numpy as np

  from rec_attend_tpu_torch import convert
  from rec_attend_tpu_torch import train_step as ts
  from rec_attend_tpu_torch.cli import pack as pack_cli
  from rec_attend_tpu_torch.cli.pack import quantise
  from rec_attend_tpu_torch.data import provider
  from rec_attend_tpu_torch.engine.experiment import EvalExperiment
  from rec_attend_tpu_torch.engine.saver import checkpoint_step
  from rec_attend_tpu_torch.engine.saver import list_checkpoints
  from rec_attend_tpu_torch.engine.trainer import Trainer
  from rec_attend_tpu_torch.data.synthetic import get_fname
  from rec_attend_tpu_torch.eval_cityscapes import instance_eval
  from rec_attend_tpu_torch.eval_cityscapes import pixel_eval
  from rec_attend_tpu_torch.eval_cityscapes.instance_eval import (
      evaluate_instance_predictions)
  from rec_attend_tpu_torch.models.box_model import draw_box_randoms
  from rec_attend_tpu_torch.models.fg_model import draw_fg_randoms
  from rec_attend_tpu_torch.models.fg_model import fg_model_forward
  from rec_attend_tpu_torch.models.full_model import CTRL_NETS
  from rec_attend_tpu_torch.models.full_model import draw_train_randoms
  from rec_attend_tpu_torch.models.full_model import learn_rate
  from rec_attend_tpu_torch.ops import matching
  from rec_attend_tpu_torch.pipelines import run_pipeline

  out, failures = {}, []
  cuda = dev.type == 'cuda'
  paper = scale == 'paper'

  def gate(name, got, control):
    return gate_with_control(failures, name, got, control)

  def check(name, problems):
    failures.extend(f'{name}: {x}' for x in problems)

  def tensors(raw, keys=None):
    return {dst: torch.from_numpy(np.ascontiguousarray(raw[src])).to(dev)
            for dst, src in (keys or {k: k for k in raw}).items()}

  start = time.time()
  with tempfile.TemporaryDirectory(prefix='.chip_smoke_synthcs-',
                                   dir=REPO) as root:
    results, logs, data = (os.path.join(root, d)
                           for d in ('results', 'logs', 'data'))
    argv = ['--dataset', 'synthcs', '--scale', scale, '--results', results,
            '--logs', logs, '--dataset_folder', data, '--model_id', 'chip',
            '--data_examples', str(examples), '--fg_steps', str(steps),
            '--box_steps', str(steps), '--full_steps', str(steps)]
    cut = chain_cut(examples, SYNTHCS_EVERY, SYNTHCS_EVERY)
    data_cfg, fg_cfg, box_cfg, full_base, _, _, batch = cut(
        run_pipeline.synthcs_stages)(scale, results, logs, data,
                                     data_examples=examples)
    T = full_base.timespan
    if paper and (batch['box'], batch['full']) != (SYNTHCS_TRAIN_BATCH,) * 2:
      raise AssertionError(f'the synthcs stages train at {batch}: the '
                           f'kernels phase checks b{SYNTHCS_TRAIN_BATCH}')
    ids = {s: f'{s}_model_synthcs-chip' for s in ('fg', 'box', 'full')}
    ckpts = list(range(SYNTHCS_EVERY, steps + 1, SYNTHCS_EVERY))[-2:]

    # ---- gates as the fg and full runs start (step 0) -------------------
    def first_batch(exp, b):
      return tensors(exp.make_batch_fn(exp.train_ds, getattr(
          exp.model_cfg, 'timespan', None))(np.arange(b)))

    gate_seconds = {}

    def before(exp):
      t0 = time.time()
      gated(exp)
      gate_seconds[exp.spec.name] = time.time() - t0

    def gated(exp):
      trainer, name = exp.trainer, exp.spec.name
      if name == 'fg':
        gates, f = synthcs_fg_gates(
            torch, ts, matching, trainer.model, trainer.opt_state,
            first_batch(exp, batch['fg']),
            draw_fg_randoms(fg_cfg, torch.Generator(dev).manual_seed(1)), 0,
            learn_rate(fg_cfg, 0), limits[0])
        out['fg_gates'] = gates
        failures.extend(f'fg {x}' for x in f)
      elif name == 'full':
        box_folder = os.path.join(results, ids['box'])
        box_ckpts = list_checkpoints(box_folder)
        state = trainer.model.state_dict()
        first = convert.params_from_checkpoint(box_ckpts[0][1], box_cfg)
        out['full_controller_gate'] = gate(
            'full step 0 controller against the box\'s weights.h5',
            state_diff(torch, state, h5_state(os.path.join(
                box_folder, 'weights.h5'), CTRL_NETS)),
            state_diff(torch, state, {k: v for k, v in first.items()
                                      if k.split('.')[0] in CTRL_NETS}))
        gates, f = step_gates(
            torch, ts, matching, gk, trainer.model, trainer.opt_state,
            first_batch(exp, batch['full']),
            draw_train_randoms(full_base, batch['full'],
                               torch.Generator(dev).manual_seed(3)),
            0, learn_rate(full_base, 0), limits[2])
        out['full_gates'] = gates
        failures.extend(f'full {x}' for x in f)

    # ---- the pipeline, every stage in this process ----------------------
    seconds = {k: [] for k in ('pack', 'eval', 'full_pack', 'ap', 'pixel')}
    in_memory = []

    def keep(fn):
      def call(*args, **kw):
        in_memory.append(fn(*args, **kw))
        return in_memory[-1]
      return call

    def timed(key):
      return lambda fn: timed_calls(torch, dev, fn, seconds[key])
    gk.reset_launch_counts()
    t0 = time.time()
    with contextlib.ExitStack() as stack:
      runs = stack.enter_context(recorded_runs(torch, gk, dev, before))
      stack.enter_context(chain_patched(run_pipeline, 'synthcs', cut))
      for owner, name, wrap in (
          (run_pipeline.pack_cli, 'fg_main', timed('pack')),
          (run_pipeline.eval_fg_metrics, 'main', timed('eval')),
          (run_pipeline.eval_cli, 'full_main', timed('eval')),
          (run_pipeline.pack_cli, 'full_main', timed('full_pack')),
          (run_pipeline.pack_cli, 'pack_full', keep),
          (run_pipeline, 'run_ap_stage', timed('ap')),
          (run_pipeline, 'run_pixel_stage', timed('pixel'))):
        stack.enter_context(patched(owner, name, wrap))
      got = run_pipeline.main(argv, device=dev)
    out['pipeline_seconds'] = time.time() - t0
    out['stages'] = got['stages']
    if got['stages'] != list(run_pipeline.SYNTHCS_STAGES) or any(
        got[k] != v for k, v in ids.items()):
      failures.append(f'the pipeline ran {got["stages"]} of {got}')
    by_stage = {r['spec']: r for r in runs}
    for stage in ('fg', 'box', 'full'):
      rec = by_stage[stage]
      folder = os.path.join(logs, ids[stage])
      out[stage] = {
          'batch': batch[stage], **step_ms_summary(rec),
          'step_ms_at_log': log_rows(folder, 'step_time'),
          'train_loss_at_log': log_rows(folder, 'loss'),
          'checkpoints': [s for s, _ in list_checkpoints(
              os.path.join(results, ids[stage]))],
          **{k: rec[k] for k in ('start_step', 'run_seconds',
                                 'max_memory_allocated_bytes',
                                 'run_launches')}}
      losses = list(out[stage]['train_loss_at_log'].values())
      if not losses or not all(math.isfinite(v) for v in losses):
        failures.append(f'{stage}: loss {losses}')
      check(f'{stage} checkpoints', [] if out[stage]['checkpoints'] == ckpts
            else [f'{out[stage]["checkpoints"]}, want {ckpts}'])
    out['eval_ap_pixel_launches'] = counts_delta(
        runs[-1]['launches_at_end'], launches_now(gk))
    out['stage_host_seconds'] = seconds
    out['pack'] = {'bytes': {s: os.path.getsize(provider.pack_path(
        data_cfg, s)) for s in ('train', 'valid')}}
    fg_folder, full_folder = (os.path.join(results, ids[s])
                              for s in ('fg', 'full'))
    out['fg_metrics'] = read_json(fg_folder, 'fg_metrics_valid.json')
    valid_out = os.path.join(full_folder, 'output_valid')
    out['ap'] = {'trained': read_json(valid_out, 'ap.json')['averages']}
    pixel_trained = read_json(valid_out, 'pixel_eval.json')
    out['eval_sbd'] = {
        tt: read_scores(valid_out, f'sbd_{int(float(tt) * 100):02d}')
        for tt in run_pipeline.EVAL_THRESHOLDS.split(',')}

    # ---- launches per step ----------------------------------------------
    full = by_stage['full']['exp']
    valid_batch = full._device_batch(full.make_batch_fn(
        full.valid_ds, T)(np.arange(batch['full'])))
    draws = full.trainer.family.draws(
        full.model_cfg, batch['full'], torch.Generator(dev).manual_seed(1))
    before_plain = launches_now(gk)
    one_step(torch, ts, matching, full.trainer.model, full.trainer.opt_state,
             valid_batch, draws, full.step, 'plain')
    plain_step = counts_delta(before_plain, launches_now(gk))
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
    recorded = {s: by_stage[s]['step_launches'] for s in ('fg', 'box', 'full')}
    out['launches_per_step'] = {s: v[0] if v else None
                                for s, v in recorded.items()}

    def steps_diff(stage, per_step):
      return [f'{stage} step {i}: {s}' for i, s in enumerate(per_step)
              if s != want[stage]] or ([] if per_step else ['no step'])
    if cuda:   # the plain glimpses of the CPU launch nothing
      out['launch_gate'] = {
          stage: gate(f'{stage} launches per step',
                      steps_diff(stage, per_step),
                      steps_diff(stage, recorded['full'] if stage == 'fg'
                                 else [plain_step]))
          for stage, per_step in recorded.items()}

    # ---- packs ----------------------------------------------------------
    # The fg maps quantised on the card against the host's quantisation of
    # the same maps (control: the host's rounded to the nearest byte, as
    # encode_batch rounds, where the pack truncates).
    fg_exp = EvalExperiment(fg_folder, device=dev, spec='fg')
    valid = provider.get('synth', data_cfg, split='valid')
    x2 = torch.from_numpy(valid.dataset.x[:2]).to(dev)
    with torch.inference_mode():
      fg_maps = fg_model_forward(fg_exp.model, x2)

    def fg_bytes_diff(host_bytes):
      return [k for k in ('y_out', 'd_out') if not torch.equal(
          quantise(fg_maps[k]).cpu(), host_bytes(fg_maps[k].cpu()))]
    packs = {'fg_gate': gate(
        'fg bytes on the card against the host', fg_bytes_diff(quantise),
        fg_bytes_diff(lambda a: torch.from_numpy(ts.encode_batch(
            {'y_in': a.clamp(0, 1).numpy()})['y_in'])))}
    # The full pack read back from the disk against pack_full's in memory
    # (control: its slots shifted by one).
    (mem,) = in_memory

    def full_pack_diff(shift):
      return [k for k in ('d_out', 'y_out', 'y_out_ins', 's_out')
              if not (getattr(valid, k) is not None and np.array_equal(
                  getattr(valid, k), np.roll(getattr(mem, k), shift,
                                             axis=1)))]
    packs['full_gate'] = gate('the full pack read back against pack_full',
                              full_pack_diff(0), full_pack_diff(1))
    out['packs'] = packs

    # ---- box: from the committed synthcs checkpoint with Adam -----------
    box = Trainer(box_cfg, device=dev)
    ckpt = box.restore(SYNTHCS_BOX_DIR if paper
                       else os.path.join(results, ids['box']))
    if box.step != checkpoint_step(ckpt) or 'mu' not in box.opt_state:
      failures.append(f'box restored step {box.step}')
    train = provider.get('synth', data_cfg, split='train')
    t0 = time.time()
    gates, f, _ = synthcs_box_gates(
        torch, ts, matching, gk, box.model, box.opt_state,
        tensors(train.get_batch(np.arange(batch['box']), timespan=T),
                PACKED_KEYS),
        draw_box_randoms(box_cfg, batch['box'],
                         torch.Generator(dev).manual_seed(2)),
        box.step, learn_rate(box_cfg, box.opt_state['count']), limits[1])
    gate_seconds['box'] = time.time() - t0
    out['gate_seconds'] = gate_seconds
    out['box_gates'] = {'weights': os.path.relpath(ckpt, REPO), **gates}
    failures.extend(f'box {x}' for x in f)
    del box

    # ---- pixel: the trained fg pack against the host's labels -----------
    def host_pixel(maps):
      ev = pixel_eval.PixelEvaluator()
      for fg_bytes, inst_ids in zip(maps, valid.dataset.get_instance_id_images(
          valid.dataset.img_ids)):
        label, inst = pixel_eval.groundtruth_labels(inst_ids)
        ev.add_pair(pixel_eval.prediction_labels(fg_bytes), label,
                    instance_img=inst)
      return ev.finalize()

    def pixel_diff(want_result):
      return [] if pixel_result_equal(pixel_trained, want_result) else [
          f'meanIoU {pixel_trained["meanIoU"]} against '
          f'{want_result["meanIoU"]}']
    out['pixel'] = {'trained': pixel_trained, 'gate': gate(
        'pixel_eval.json against the host\'s labels of the same bytes',
        pixel_diff(host_pixel(valid.y_out)),
        pixel_diff(host_pixel(np.roll(valid.y_out, 1, axis=-1))))}

    # ---- eval, ap, pixel again on a trained full model ------------------
    # The committed synthcs full checkpoint (the pipeline's two-step model
    # finds no instance) under the chain's full id, over a pack file of the
    # ground truth's maps of the valid split, as cs_chain's oracle.
    results2, data2 = (os.path.join(root, d) for d in ('results2', 'data2'))
    cfg2 = data_cfg.replace(folder=data2)
    src = oracle_dir or full_folder
    folder2 = os.path.join(results2, ids['full'])
    os.makedirs(folder2)
    os.symlink(list_checkpoints(src)[-1][1], os.path.join(
        folder2, os.path.basename(list_checkpoints(src)[-1][1])))
    full_base.save_yaml(os.path.join(folder2, 'model_opt.yaml'))
    cfg2.save_yaml(os.path.join(folder2, 'data_opt.yaml'))
    os.symlink(fg_folder, os.path.join(results2, ids['fg']))
    gt = valid.dataset
    provider.write_pack(
        provider.pack_path(cfg2, 'valid'), gt.img_ids,
        quantise(torch.from_numpy(gt.d_gt)).numpy(),
        quantise(torch.from_numpy(gt.c_gt)).numpy(),
        provider.settings(cfg2, 'valid'))
    argv2 = ['--dataset', 'synthcs', '--scale', scale, '--results', results2,
             '--logs', os.path.join(root, 'logs2'), '--dataset_folder',
             data2, '--model_id', 'chip', '--data_examples', str(examples),
             '--ap_remove_tiny', str(ap_remove_tiny)]
    forms = {'kernel': 'kernel', 'plain': 'plain'}
    if not bit_equal:
      forms['reordered_plain'] = reordered_plain(torch)
    ap2, rows2, seconds2 = {}, {}, {}

    def submitted():
      # The rows of the submission's files that the AP stage read.
      sub = os.path.join(folder2, 'cs_output_valid', 'cityscapes')
      return [instance_eval.read_prediction_rows(
          instance_eval.find_prediction_file(get_fname(i)[:-len('.png')],
                                             sub))
              for i in gt.img_ids]
    for name, glimpse in forms.items():

      def with_glimpse(cls, glimpse=glimpse):
        return lambda *args, **kw: cls(*args, glimpse=glimpse, **kw)
      gk.reset_launch_counts()
      t0 = time.time()
      with patched(pack_cli, 'EvalExperiment', with_glimpse), \
          deterministic_cudnn(torch):
        run_pipeline.main(argv2 + ['--stages', 'ap,pixel'
                                   if name == 'kernel' else 'ap'],
                          device=dev)
      seconds2[name] = time.time() - t0
      if name == 'kernel':
        out['oracle_launches'] = launches_now(gk)
      ap2[name] = read_json(folder2, 'output_valid', 'ap.json')['averages']
      rows2[name] = submitted()
    limit = (0.0 if bit_equal else CS_AP_FLOOR_FACTOR * ap_difference(
        ap2['reordered_plain'], ap2['plain']) + CS_AP_SLACK)
    gt_ids = gt.get_instance_id_images(gt.img_ids)
    swap = {24: 25, 25: 24}
    swapped = evaluate_instance_predictions(
        [[(m, swap.get(label, label), c) for m, label, c in rows]
         for rows in rows2['kernel']], gt_ids)

    def ap_diff(got_ap):
      diff = ap_difference(got_ap, ap2['plain'])
      return [] if diff <= limit else [f'differs by {diff}, limit {limit}']
    out['ap'].update(
        oracle=ap2, limit=limit, seconds=seconds2,
        kernel_vs_plain=ap_difference(ap2['kernel'], ap2['plain']),
        person_rider_swapped_vs_plain=ap_difference(swapped, ap2['plain']),
        submitted_rows={k: sum(len(r) for r in v) for k, v in rows2.items()},
        gate=gate('ap.json of the kernel run against the plain run',
                  ap_diff(ap2['kernel']), ap_diff(swapped)))
    if not ap2['kernel']['allAp'] > 0:
      failures.append(f'AP on the ground truth\'s maps {ap2["kernel"]}')
    out['oracle_pixel'] = read_json(folder2, 'output_valid',
                                    'pixel_eval.json')['meanIoU']
    out['folders'] = ids
  out['seconds'] = time.time() - start
  return out, failures


# ---------------------------------------------------------------------------
# cvppp_pipeline, kitti_pipeline: the H5 datasets on the card
# ---------------------------------------------------------------------------

# The layout fixtures, built from a seed at the real raw sizes: CVPPP A1's
# 128 plants at 530x500 (its 80/20 split: 103/25), KITTI cut to 32 train,
# 16 valid and 8 test images (the real car set has thousands; the cut
# keeps the whole script near 900 s) at 375x1242; 1-20 instances an image.
CVPPP_FIXTURE = dict(count=128, height=530, width=500, seed=20)
KITTI_FIXTURE = dict(counts={'train': 32, 'valid': 16, 'test': 8},
                     height=375, width=1242, seed=21)
# Cityscapes' layout fixture at its raw 2048x1024 (gtFine's polygons and
# leftImg8bit), 8 train, 4 valid and 4 test images, two cities a split.
CITYSCAPES_FIXTURE = dict(counts={'train': 8, 'valid': 4, 'test': 4},
                          height=1024, width=2048, seed=22)
# Pinned on the CPU: the digest of the instanceIds and labelIds images that
# the JAX package's cityscapes_prep (cv2) writes from the fixture
# (cityscapes_prep_digest; tests/test_torch_cityscapes_prep.py), the digest
# of the files its CityscapesAssembler writes (cityscapes_h5_digest;
# tests/test_torch_cityscapes_data.py), and the AP of the valid split's
# ground-truth pack (cityscapes_gt_ap, the port on the CPU, held to JAX's
# command lines at a small size by tests/test_torch_cityscapes_eval_cli.py;
# pinned by tests/test_torch_cityscapes_data.py).  The card's AP may differ
# where the upsampled maps cross the mask threshold in float32 noise:
# CITYSCAPES_AP_ATOL; the control rolls the packed masks 8 pixels right.
CITYSCAPES_PREP_DIGEST = (
    '342b42865c31f6bd5760eaf0c3d34d19510b425355cc1a45eff01d69629462e2')
CITYSCAPES_H5_DIGEST = (
    '740118f2ba1721ca2ef596bec798f60f91c4c49618c2fc59c52f7c339a26b95b')
CITYSCAPES_GT_AP = {'allAp': 0.7732610987103175, 'allAp50%': 0.959375}
CITYSCAPES_AP_ATOL = 0.01
CITYSCAPES_AP_CONTROL_SHIFT = 8
H5_SPLITS = {'cvppp': ('train', 'valid'), 'kitti': ('train', 'valid', 'test'),
             'cityscapes': ('train', 'valid', 'test')}
H5_PIPELINE_STEPS = 2
MAX_INSTANCES = 20
# A synthetic split written by the JAX package (make_synthetic_h5: cv2's
# PNGs, nested label_segmentation/NN groups, a |S9 index_map), and the
# SHA-256 of what its get_batch and get_full_size_labels give over every
# example (``jax_h5_digest``), pinned by tests/test_torch_datasets.py
# against the JAX package's InsSegDataset on the CPU.
JAX_SYNTH_H5 = os.path.join(REPO, 'tests', 'fixtures',
                            'synth_valid_64x64.h5')
JAX_SYNTH_VARIABLES = ('x', 'y_gt', 'c_gt', 'd_gt', 's_gt', 'orig_size',
                       'idx_map')
JAX_SYNTH_DIGEST = (
    'f19e3bf59b015fbe62697689a6041c30eeede36cbd69607e8be8a67f5c7d1163')


def ellipse(h, w, cy, cx, ry, rx, angle):
  """[H, W] bool: the filled ellipse of centre (cy, cx), radii (ry, rx),
  turned by ``angle`` radians (computed over its bounding box)."""
  import numpy as np
  r = int(np.ceil(max(ry, rx))) + 1
  y0, y1 = max(int(cy) - r, 0), min(int(cy) + r + 1, h)
  x0, x1 = max(int(cx) - r, 0), min(int(cx) + r + 1, w)
  out = np.zeros((h, w), bool)
  if y0 >= y1 or x0 >= x1:
    return out
  yy, xx = np.mgrid[y0:y1, x0:x1]
  c, s = np.cos(angle), np.sin(angle)
  u = (xx - cx) * c + (yy - cy) * s
  v = -(xx - cx) * s + (yy - cy) * c
  out[y0:y1, x0:x1] = (u / rx) ** 2 + (v / ry) ** 2 <= 1
  return out


def distinct_colours(rng, n):
  """[n, 3] uint8 colours, none black and no two alike."""
  import numpy as np
  codes = []
  while len(codes) < n:
    code = int(rng.randint(1, 1 << 24))
    if code not in codes:
      codes.append(code)
  codes = np.array(codes)
  return np.stack([(codes >> s) & 255 for s in (16, 8, 0)], 1).astype(
      np.uint8)


def cvppp_fixture(folder, count, height, width, seed):
  """CVPPP A1's layout: plantNNN_rgb.png (leaves on soil), plantNNN_label.png
  (a palette-indexed PNG, index k the k-th leaf, so the palette path runs)
  and plantNNN_fg.png (gray, 255 on the plant), plants 1..count, each with
  1-20 leaves (ellipses about the plant's centre, later ones on top).
  Returns the bytes written."""
  import numpy as np

  from rec_attend_tpu_torch.utils import png
  os.makedirs(folder, exist_ok=True)
  rng = np.random.RandomState(seed)
  nbytes = 0
  for pid in range(1, count + 1):
    leaves = rng.randint(1, MAX_INSTANCES + 1)
    idx = np.zeros((height, width), np.uint8)
    cy, cx = height / 2 + rng.randn() * height / 20, width / 2
    scale = min(height, width)
    for k in range(1, leaves + 1):
      turn = rng.rand() * 2 * np.pi
      dist = rng.rand() * scale * 0.3
      idx[ellipse(height, width, cy + dist * np.sin(turn),
                  cx + dist * np.cos(turn), scale * (0.03 + 0.04 * rng.rand()),
                  scale * (0.07 + 0.08 * rng.rand()), turn)] = k
    bgr = (rng.rand(height, width, 3) * 40 + [20, 50, 80]).astype(np.uint8)
    greens = np.stack([rng.randint(0, 60, leaves + 1),
                       rng.randint(90, 230, leaves + 1),
                       rng.randint(0, 90, leaves + 1)], 1).astype(np.uint8)
    leaf = idx > 0
    bgr[leaf] = np.clip(greens[idx[leaf]].astype(int)
                        + rng.randint(-12, 13, (leaf.sum(), 3)), 0, 255)
    palette = np.concatenate([np.zeros((1, 3), np.uint8),
                              distinct_colours(rng, leaves)])
    files = {'rgb': png.encode(bgr),
             'label': png.encode_samples(idx, 3, 8, palette=palette),
             'fg': png.encode((leaf * 255).astype(np.uint8))}
    for kind, blob in files.items():
      with open(os.path.join(folder, f'plant{pid:03d}_{kind}.png'), 'wb') as f:
        f.write(blob.tobytes())
      nbytes += blob.size
  return nbytes


def kitti_fixture(folder, counts, height, width, seed):
  """The KITTI car set's layout: images/NNNNNN.png, the colour-labelled
  instances of gt/NNNNNN.png and gt_man/NNNNNN.png (one colour a car) and
  {split}.txt with the ids, ``counts`` images a split, each with 1-20 cars
  (ellipses in the road's half, nearer ones larger and on top).  Returns
  the bytes written."""
  import numpy as np

  from rec_attend_tpu_torch.utils import png
  for sub in ('images', 'gt', 'gt_man'):
    os.makedirs(os.path.join(folder, sub), exist_ok=True)
  rng = np.random.RandomState(seed)
  nbytes, next_id = 0, 0
  for split, n in counts.items():
    ids = list(range(next_id, next_id + n))
    next_id += n
    with open(os.path.join(folder, f'{split}.txt'), 'w') as f:
      f.writelines(f'{i}\n' for i in ids)
    for iid in ids:
      cars = rng.randint(1, MAX_INSTANCES + 1)
      sky = (rng.rand(height, width, 3) * 30 + [150, 120, 90])
      bgr = sky.astype(np.uint8)
      bgr[height // 2:] = (rng.rand(height - height // 2, width, 3) * 30
                           + 60).astype(np.uint8)
      label = np.zeros((height, width), np.int32)
      ys = np.sort(rng.uniform(height * 0.5, height * 0.95, cars))
      for k, y in enumerate(ys, 1):
        near = (y - height * 0.45) / (height * 0.5)
        label[ellipse(height, width, y, rng.uniform(0, width),
                      height * 0.12 * near + 2, width * 0.06 * near + 3,
                      0.0)] = k
      colours = np.concatenate([np.zeros((1, 3), np.uint8),
                                distinct_colours(rng, cars)])
      car = label > 0
      bgr[car] = (colours[label[car]] // 2 + 60).astype(np.uint8)
      gt = colours[label]
      files = {'images': png.encode(bgr), 'gt': png.encode(gt),
               'gt_man': png.encode(gt)}
      for sub, blob in files.items():
        with open(os.path.join(folder, sub, f'{iid:06d}.png'), 'wb') as f:
          f.write(blob.tobytes())
        nbytes += blob.size
  return nbytes


CITYSCAPES_CITIES = {'train': ('aachen', 'bochum'),
                     'valid': ('frankfurt', 'lindau'),
                     'test': ('berlin', 'bielefeld')}
CITYSCAPES_CLASSES = ('person', 'rider', 'car', 'truck', 'bus', 'train',
                      'motorcycle', 'bicycle')


def star_polygon(rng, cx, cy, r, n, crossed=False):
  """[(x, y)] of a star-shaped polygon about (cx, cy): ``n`` vertices at
  random radii in [0.35 r, r] (concave), a tenth of them at half pixels;
  ``crossed``: two of them swapped, so that its edges cross."""
  import numpy as np
  ang = np.sort(rng.uniform(0, 2 * np.pi, n))
  rad = r * rng.uniform(0.35, 1.0, n)
  pts = [[float(cx + a * np.cos(t)), float(cy + 0.6 * a * np.sin(t))]
         for a, t in zip(rad, ang)]
  pts = [[round(x) + (0.5 if rng.rand() < 0.1 else 0.0), round(y)]
         for x, y in pts]
  if crossed and n >= 4:
    i = rng.randint(0, n - 2)
    pts[i], pts[i + 2] = pts[i + 2], pts[i]
  return pts


def cityscapes_fixture(folder, counts, height, width, seed):
  """Cityscapes' layout: leftImg8bit/{train,val,test}/{city}/{city}_{seq:06d}
  _{frame:06d}_leftImg8bit.png and gtFine/{split}/{city}/..._gtFine_polygons
  .json, ``counts`` images a split (two cities each).  Each annotation has
  sky, building and road polygons and, but in the test split (whose
  ground truth holds no instance, as Cityscapes' does), 1-20 instances of
  the 8 classes (star-shaped and concave, a quarter of them with crossed
  edges, some off the image), a cargroup, a caravan (trainId 0: dropped)
  and a deleted car.  (No license plate: the label table of both packages
  has none, and both raise on it.)  The image is the
  label colours (BGR) with noise.  Returns the bytes written a split."""
  import json

  import numpy as np

  from rec_attend_tpu_torch.data import cityscapes_prep as prep
  from rec_attend_tpu_torch.utils import png
  rng = np.random.RandomState(seed)
  h, w = height, width
  nbytes = {}
  for split, n in counts.items():
    nbytes[split] = 0
    sub = 'val' if split == 'valid' else split
    for k in range(n):
      city = CITYSCAPES_CITIES[split][k % 2]
      name = f'{city}_{k // 2:06d}_{19 + k:06d}'
      horizon = int(h * rng.uniform(0.3, 0.45))
      objects = [
          {'label': 'sky', 'polygon': [[-1, -1], [w, -1], [w, horizon],
                                       [-1, horizon + 3]]},
          {'label': 'building', 'polygon': [
              [int(w * 0.05), horizon + 2], [int(w * 0.1), int(h * 0.1)],
              [int(w * 0.3), int(h * 0.15)], [int(w * 0.35), horizon]]},
          {'label': 'road', 'polygon': [[-1, h], [-1, horizon + 10],
                                        [w, horizon + 5], [w, h]]}]
      if split != 'test':
        scale = min(h, w)
        for j in range(rng.randint(1, MAX_INSTANCES + 1)):
          cls = CITYSCAPES_CLASSES[rng.randint(0, 8)]
          cx = rng.uniform(-0.05, 1.05) * w
          cy = rng.uniform(0.45, 1.0) * h
          objects.append({'label': cls, 'polygon': star_polygon(
              rng, cx, cy, scale * rng.uniform(0.04, 0.2),
              rng.randint(5, 25), crossed=j % 4 == 3)})
        for label in ('cargroup', 'caravan'):
          objects.append({'label': label, 'polygon': star_polygon(
              rng, rng.uniform(0.1, 0.9) * w, rng.uniform(0.5, 0.9) * h,
              scale * 0.08, 10)})
        objects.append({'label': 'car', 'deleted': 1, 'polygon': star_polygon(
            rng, w / 2, h * 0.7, scale * 0.1, 8)})
      ann = {'imgHeight': h, 'imgWidth': w, 'objects': objects}
      gt_dir = os.path.join(folder, 'gtFine', sub, city)
      img_dir = os.path.join(folder, 'leftImg8bit', sub, city)
      os.makedirs(gt_dir, exist_ok=True)
      os.makedirs(img_dir, exist_ok=True)
      path = os.path.join(gt_dir, f'{name}_gtFine_polygons.json')
      with open(path, 'w') as f:
        json.dump(ann, f)
      bgr = prep.create_label_image(prep.Annotation.from_json_file(path),
                                    'color')
      bgr = np.clip(bgr.astype(np.int16) + rng.randint(-20, 21, bgr.shape),
                    0, 255).astype(np.uint8)
      blob = png.encode(bgr)
      with open(os.path.join(img_dir, f'{name}_leftImg8bit.png'), 'wb') as f:
        f.write(blob.tobytes())
      nbytes[split] += blob.size + os.path.getsize(path)
  return nbytes


def cityscapes_prep_digest(root, moved=False):
  """SHA-256 of every ``*_instanceIds.png`` and ``*_labelIds.png`` under
  ``root``'s gtFine and gtCoarse, decoded (names and ``sha256_of``).
  ``moved``: the first train image's last instance polygon that lies in
  the image moved a pixel right (its instance ids drawn again), the
  gate's control."""
  import glob

  from rec_attend_tpu_torch.data import cityscapes_prep as prep
  from rec_attend_tpu_torch.utils import png
  paths = sorted(glob.glob(os.path.join(root, 'gt*', '*', '*',
                                        '*_gt*_*Ids.png')))
  first = next(p for p in paths if p.endswith('_instanceIds.png')
               and f'{os.sep}train{os.sep}' in p)
  h = hashlib.sha256()
  for path in paths:
    a = png.imread(path, png.IMREAD_UNCHANGED)
    if moved and path == first:
      ann = prep.Annotation.from_json_file(
          path.replace('_instanceIds.png', '_polygons.json'))
      k = max(i for i, (label, poly) in enumerate(ann.objects)
              if label in CITYSCAPES_CLASSES and all(
                  0 <= x < ann.img_width - 1 and 0 <= y < ann.img_height
                  for x, y in poly))
      label, poly = ann.objects[k]
      ann.objects[k] = (label, [(x + 1, y) for x, y in poly])
      a = prep.create_instance_image(ann).astype(a.dtype)
    h.update(f'{os.path.relpath(path, root)} {sha256_of(a)}'.encode())
  return h.hexdigest()


def cityscapes_h5_digest(paths, permuted=False):
  """SHA-256 of what assembled H5 files hold, but the cubic 'input': each
  dataset by its path in the file, PNGs decoded, the index map as text,
  the classes as int64.  ``permuted``: class c read as (c + 1) % 8, the
  gate's control."""
  import numpy as np

  from rec_attend_tpu_torch.utils import h5
  from rec_attend_tpu_torch.utils import png

  def flat(tree, prefix=''):
    for k in sorted(tree):
      if isinstance(tree[k], dict):
        yield from flat(tree[k], f'{prefix}{k}/')
      else:
        yield f'{prefix}{k}', tree[k]
  h = hashlib.sha256()
  for path in paths:
    for name, value in flat(h5.read(path)):
      parts = name.split('/')
      if len(parts) == 2 and parts[1] == 'input':
        continue
      a = np.asarray(value)
      if name == 'index_map':
        a = np.frombuffer(','.join(
            v.decode() if isinstance(v, bytes) else str(v)
            for v in a).encode(), np.uint8)
      elif parts[-1] == 'instance_semantic_classes':
        a = a.astype(np.int64)
        if permuted:
          a = (a + 1) % 8
      elif a.dtype == np.uint8 and a.ndim == 1 and \
          a[:8].tobytes() == png.SIGNATURE:
        a = png.decode(a, png.IMREAD_UNCHANGED)
      h.update(f'{os.path.basename(path)}:{name} {sha256_of(a)}'.encode())
  return h.hexdigest()


def cityscapes_gt_ap(torch, dev, valid_h5, fixture_root, root, timespan,
                     shift=0):
  """The official AP of a pack of the valid split's ground truth: a copy
  of the split's H5 with its labels packed as the full model's
  predictions (semantic maps, orientation, the instance maps rolled
  ``shift`` pixels right, scores 0.9 where an instance is),
  ``cli.cityscapes_eval.main`` over it at the JAX command line's defaults
  and ``eval_cityscapes.instance_eval.main`` on its submission against
  ``fixture_root``'s gtFine.  Returns (the averages, the seconds of each
  step, the host seconds of the eval per batch)."""
  import shutil

  import numpy as np

  from rec_attend_tpu_torch import config as C
  from rec_attend_tpu_torch.cli import cityscapes_eval as cs_eval_cli
  from rec_attend_tpu_torch.data.cityscapes import Cityscapes
  from rec_attend_tpu_torch.data.dataset import pack_predictions
  from rec_attend_tpu_torch.eval_cityscapes import instance_eval
  seconds = {}
  t0 = time.time()
  data = os.path.join(root, 'data')
  os.makedirs(data, exist_ok=True)
  copy = os.path.join(data, os.path.basename(valid_h5))
  shutil.copyfile(valid_h5, copy)
  ds = Cityscapes(copy)
  n = ds.get_dataset_size()
  b = ds.get_batch(np.arange(n), timespan=timespan,
                   variables={'y_gt', 'c_gt', 'd_gt', 's_gt', 'idx_map'})
  pack_predictions(copy, {
      ds.get_str_id(i): {'foreground': b['c_gt'][k],
                         'orientation': b['d_gt'][k],
                         'instance': np.roll(b['y_gt'][k], shift, axis=-1),
                         'score': b['s_gt'][k] * 0.9}
      for k, i in enumerate(b['idx_map'])})
  h, w = ds.get_batch([0], timespan=timespan, variables={'x'})['x'].shape[1:3]
  results = os.path.join(root, 'results')
  os.makedirs(os.path.join(results, 'gt_pack'))
  C.DataConfig(dataset='cityscapes', folder=data, height=h, width=w,
               timespan=timespan).save_yaml(
                   os.path.join(results, 'gt_pack', 'data_opt.yaml'))
  seconds['pack'] = time.time() - t0
  t0 = time.time()
  timings = {}
  cs_eval_cli.main(['--model_id', 'gt_pack', '--results', results,
                    '--split', 'valid', '--batch_size', '2'],
                   device=dev, timings=timings)
  seconds['cityscapes_eval'] = time.time() - t0
  t0 = time.time()
  avg = instance_eval.main([
      '--predictions', os.path.join(results, 'gt_pack', 'output_valid',
                                    'cityscapes'),
      '--dataset', fixture_root, '--split', 'val'])
  seconds['instance_eval'] = time.time() - t0
  return avg, seconds, timings


def expected_samples(samples, colour_type, depth, palette, trns):
  """What ``png.decode(.., IMREAD_UNCHANGED)`` must return for raw samples
  in the file's order: BGR(A), gray samples of 1-4 bits scaled to 8."""
  import numpy as np
  s = samples
  if colour_type == 0:
    return s[..., 0] * np.uint8(255 // ((1 << depth) - 1)) if depth < 8 \
        else s[..., 0]
  if colour_type == 2:
    return s[..., ::-1]
  if colour_type == 3:
    bgr = palette[s[..., 0]][..., ::-1]
    if trns is None:
      return bgr
    alpha = np.full(len(palette), 255, np.uint8)
    alpha[:len(trns)] = np.frombuffer(trns, np.uint8)
    return np.concatenate([bgr, alpha[s[..., :1]]], axis=2)
  if colour_type == 4:
    return s[..., [0, 0, 0, 1]]
  return s[..., [2, 1, 0, 3]]


def paeth_as_up(blob):
  """The PNG ``blob`` with every Paeth row marked Up: what a decoder that
  took the one filter for the other would decode."""
  import struct
  import zlib

  import numpy as np
  data = bytes(blob)
  w, h, depth, ctype = struct.unpack('>IIBB', data[16:26])
  n = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
  rowbytes = (w * n * depth + 7) // 8
  start = data.index(b'IDAT') - 4
  size = struct.unpack('>I', data[start:start + 4])[0]
  stream = np.frombuffer(zlib.decompress(data[start + 8:start + 8 + size]),
                         np.uint8).reshape(h, rowbytes + 1).copy()
  stream[stream[:, 0] == 4, 0] = 2
  body = zlib.compress(stream.tobytes())
  chunk = (struct.pack('>I', len(body)) + b'IDAT' + body
           + struct.pack('>I', zlib.crc32(b'IDAT' + body)))
  return np.frombuffer(data[:start] + chunk + data[start + 12 + size:],
                       np.uint8)


def png_round_trips(h=19, w=37, seed=0):
  """The codec gate: random samples of every colour type and bit depth
  (palettes with and without tRNS), each encoded with each of the five
  filters forced on every row and with the heuristic's choice, decoded
  with IMREAD_UNCHANGED against ``expected_samples``, and the palette
  image with IMREAD_COLOR as BGR.  Returns (the failures, the control's:
  the Paeth streams decoded as Up, which must differ)."""
  import numpy as np

  from rec_attend_tpu_torch.utils import png
  rng = np.random.RandomState(seed)
  failures, control = [], []
  for ctype, depths in png.DEPTHS.items():
    for depth in depths:
      n = png.CHANNELS[ctype]
      s = rng.randint(0, 1 << depth, (h, w, n)).astype(
          np.uint16 if depth == 16 else np.uint8)
      cases = [(None, None)]
      if ctype == 3:
        pal = rng.randint(0, 256, (1 << depth, 3)).astype(np.uint8)
        cases = [(pal, None), (pal, bytes(rng.randint(
            0, 256, max(1, len(pal) // 2)).astype(np.uint8)))]
      for pal, trns in cases:
        want = expected_samples(s, ctype, depth, pal, trns)
        for filt in list(range(5)) + [None]:
          blob = png.encode_samples(s, ctype, depth, palette=pal, trns=trns,
                                    filter_type=filt)
          name = f'type {ctype} depth {depth} filter {filt} tRNS {bool(trns)}'
          got = png.decode(blob, png.IMREAD_UNCHANGED)
          if got.dtype != want.dtype or not np.array_equal(got, want):
            failures.append(name)
          if ctype == 3 and not np.array_equal(
              png.decode(blob, png.IMREAD_COLOR), want[..., :3]):
            failures.append(f'{name} IMREAD_COLOR')
          if filt == 4 and np.array_equal(
              png.decode(paeth_as_up(blob), png.IMREAD_UNCHANGED), want):
            control.append(name)
  # The control must fail: Paeth rows read as Up decode to other samples.
  n_paeth = sum(len(d) for d in png.DEPTHS.values()) + 1
  return failures, ([] if len(control) == n_paeth
                    else [f'{n_paeth - len(control)} Paeth streams differ '
                          'read as Up'])


def jax_h5_digest(ds, channels_reversed=False):
  """SHA-256 of what ``ds`` (a dataset of JAX_SYNTH_H5) gives: its
  get_batch of JAX_SYNTH_VARIABLES over every example and its full-size
  labels, each array's dtype, shape and bytes in a fixed order.
  ``channels_reversed``: the images' channels reversed first (RGB for
  BGR), the gate's control."""
  import numpy as np
  n = ds.get_dataset_size()
  batch = ds.get_batch(np.arange(n), timespan=6,
                       variables=set(JAX_SYNTH_VARIABLES))
  if channels_reversed:
    batch['x'] = batch['x'][..., ::-1]
  h = hashlib.sha256()
  for k in JAX_SYNTH_VARIABLES:
    h.update(f'{k} {sha256_of(np.ascontiguousarray(batch[k]))}'.encode())
  for a in ds.get_full_size_labels(ds.img_ids, timespan=6):
    h.update(sha256_of(np.ascontiguousarray(a)).encode())
  return h.hexdigest()


def decode_ms(ds, n):
  """Host ms per example of the first ``n`` examples of ``ds`` (an
  ``InsSegDataset``): each's input PNG decoded, its full-size input PNG
  decoded, and its get_batch of the train variables with the decode cache
  cleared."""
  import numpy as np

  from rec_attend_tpu_torch.utils import h5
  from rec_attend_tpu_torch.utils import png
  out = {'input': [], 'input_full_size': [], 'get_batch': []}
  with h5.File(ds.h5_fname) as f:
    for i in range(n):
      group = f[ds.get_str_id(ds.img_ids[i])]
      for key in ('input', 'input_full_size'):
        blob = group[key]
        t0 = time.perf_counter()
        png.decode(blob, png.IMREAD_UNCHANGED)
        out[key].append((time.perf_counter() - t0) * 1e3)
  for i in range(n):
    ds.clear_cache()
    t0 = time.perf_counter()
    ds.get_batch(np.arange(i, i + 1), variables={'x', 'y_gt', 's_gt',
                                                 'c_gt', 'd_gt'})
    out['get_batch'].append((time.perf_counter() - t0) * 1e3)
  return {k: {'median_ms': statistics.median(v), 'max_ms': max(v)}
          for k, v in out.items()}


def h5_kernel_dims(cvppp_cfg, kitti_cfg, cityscapes_cfg):
  """{(kernel, key): dims} of the H5 pipelines' glimpses: CVPPP's box and
  full model at b5, KITTI's box at b5 and full model at b2, Cityscapes'
  box at b4 and full model at b2."""
  out = {}
  for dataset, cfg, full_b, box_b in (('cvppp', cvppp_cfg, 5, 5),
                                      ('kitti', kitti_cfg, 2, 5),
                                      ('cityscapes', cityscapes_cfg, 2, 4)):
    hw = (cfg.inp_height, cfg.inp_width)
    f = (cfg.filter_height, cfg.filter_width)
    out['glimpse_extract', f'{dataset}_b{full_b}'] = (
        (full_b,) + hw + (cfg.acnn_inp_depth,) + f)
    out['glimpse_extract', f'{dataset}_d1_b{full_b}'] = (full_b,) + hw + (
        1,) + f
    for b in sorted({full_b, box_b}):
      out['glimpse_paste', f'{dataset}_b{b}'] = (b,) + hw + (1,) + f
  return out


def h5_pipeline_phase(torch, gk, dev, dataset, fixture=None,
                      steps=H5_PIPELINE_STEPS, size=None, pinned=None):
  """The port's pipeline of an H5 dataset (``dataset`` 'cvppp', 'kitti' or
  'cityscapes') as users launch it, on ``dev``: (a) a layout fixture from
  a seed (``fixture``: CVPPP_FIXTURE, KITTI_FIXTURE or CITYSCAPES_FIXTURE
  by default; Cityscapes' polygons then turned into its instanceIds and
  labelIds images by ``data.cityscapes_prep.main``), (b) assembled by
  ``cli.setup_dataset`` at the dataset's size (``size`` (h, w) where
  given: the CPU tests' 64x64), (c) ``run_pipeline.main --dataset
  <dataset> --num_steps <steps>``, the paper presets, or the models that
  ``run_pipeline.CHAINS[dataset]`` gives at the call (cvppp: box -> full ->
  eval; kitti: fg -> pack into the H5 -> box -> full -> eval; cityscapes:
  fg -> pack -> box -> full -> full_pack -> cityscapes_eval of valid and
  test), (d) the gates, each with a control that must fail: the PNG
  codec's round trips (control: Paeth read as Up), the JAX-written
  synthetic H5 read to the digest pinned on the CPU (control: the channels
  reversed), the fg pack read back from the H5 bit for bit (KITTI and
  Cityscapes; control: the maps flipped before writing), the trained full
  model's eval step kernel against plain (control: the window 8 pixels
  off), the files (the full model's model_opt.yaml naming the box's
  weights.h5 and the eval CSVs, for Cityscapes also each valid and test
  image's submission text file and its masks, 0/255 at the full size;
  control: the box's folder) and, on the card, the launches per step
  (control: a plain step's).  Cityscapes adds three: the prep's images to
  CITYSCAPES_PREP_DIGEST (control: a polygon moved by a pixel), the
  assembled files to CITYSCAPES_H5_DIGEST (control: the classes
  permuted), both pinned by the CPU tests with the JAX package's prep (cv2)
  and assembler, and the AP of a pack of the valid split's ground truth
  through ``cli.cityscapes_eval.main`` and ``instance_eval.main`` to
  CITYSCAPES_GT_AP (control: the masks shifted).  ``pinned``: {'prep',
  'h5', 'ap'} in place of those constants (the CPU tests' small
  fixtures).  All under a temporary folder in the checkout, removed after.
  Returns (results, failures)."""
  import numpy as np

  from rec_attend_tpu_torch import train_step as ts
  from rec_attend_tpu_torch.cli import cityscapes_eval as cs_eval_cli
  from rec_attend_tpu_torch.cli import eval as eval_cli
  from rec_attend_tpu_torch.cli import pack as pack_cli
  from rec_attend_tpu_torch.cli import setup_dataset
  from rec_attend_tpu_torch.cli.eval import DEFAULT_ANALYZERS
  from rec_attend_tpu_torch.config import FullModelConfig
  from rec_attend_tpu_torch.data import cityscapes_prep
  from rec_attend_tpu_torch.data import provider
  from rec_attend_tpu_torch.data.dataset import pack_predictions
  from rec_attend_tpu_torch.data.provider import _DECODE
  from rec_attend_tpu_torch.data.synthetic import SyntheticH5
  from rec_attend_tpu_torch.ops import matching
  from rec_attend_tpu_torch.pipelines import run_pipeline
  from rec_attend_tpu_torch.utils import png

  out, failures = {}, []
  cuda = dev.type == 'cuda'
  cityscapes = dataset == 'cityscapes'
  packs = dataset != 'cvppp'
  build_fixture, default = {
      'cvppp': (cvppp_fixture, CVPPP_FIXTURE),
      'kitti': (kitti_fixture, KITTI_FIXTURE),
      'cityscapes': (cityscapes_fixture, CITYSCAPES_FIXTURE)}[dataset]
  fixture = fixture or default
  pinned = pinned or {'prep': CITYSCAPES_PREP_DIGEST,
                      'h5': CITYSCAPES_H5_DIGEST, 'ap': CITYSCAPES_GT_AP}

  def gate(name, got, control):
    return gate_with_control(failures, name, got, control)

  start = time.time()
  # ---- the codecs, and the readers on JAX-written data ----------------
  t0 = time.time()
  out['codec_gate'] = gate('PNG round trips', *png_round_trips())
  jax_ds = SyntheticH5(JAX_SYNTH_H5)
  digest = jax_h5_digest(jax_ds)
  out['jax_h5'] = {'digest': digest, 'gate': gate(
      'the JAX-written synthetic H5 read',
      [] if digest == JAX_SYNTH_DIGEST else [f'digest {digest}'],
      [] if jax_h5_digest(jax_ds, True) == JAX_SYNTH_DIGEST
      else ['channels reversed'])}
  out['codec_seconds'] = time.time() - t0

  with tempfile.TemporaryDirectory(prefix=f'.chip_smoke_{dataset}-',
                                   dir=REPO) as root:
    folder, results, logs = (os.path.join(root, d)
                             for d in ('data', 'results', 'logs'))
    # ---- (a) the fixture, (b) assembled ---------------------------------
    t0 = time.time()
    nbytes = build_fixture(folder, **fixture)
    out['fixture'] = dict(fixture, bytes=nbytes, seconds=time.time() - t0)
    if cityscapes:
      t0 = time.time()
      converted = cityscapes_prep.main(['--dataset', folder])
      out['prep'] = {'annotations': converted,
                     'seconds': time.time() - t0}
      digest = cityscapes_prep_digest(folder)
      out['prep']['digest'] = digest
      out['prep']['gate'] = gate(
          'the prep\'s images against the digest of JAX\'s (cv2)',
          [] if digest == pinned['prep'] else [f'digest {digest}'],
          [] if cityscapes_prep_digest(folder, moved=True) == pinned['prep']
          else ['a polygon moved by a pixel'])
    argv = ['--dataset', dataset, '--folder', folder, '--splits',
            ','.join(H5_SPLITS[dataset])]
    if size:
      argv += ['--height', str(size[0]), '--width', str(size[1])]
    t0 = time.time()
    out['assemble'] = setup_dataset.main(argv)
    out['assemble_seconds'] = time.time() - t0
    h5_paths = [out['assemble'][s]['path'] for s in H5_SPLITS[dataset]]
    for stats in out['assemble'].values():
      stats['path'] = os.path.relpath(stats['path'], root)
    if cityscapes:
      digest = cityscapes_h5_digest(h5_paths)
      out['h5_digest'] = {'digest': digest, 'gate': gate(
          'the assembled H5 files against the digest of JAX\'s',
          [] if digest == pinned['h5'] else [f'digest {digest}'],
          [] if cityscapes_h5_digest(h5_paths, permuted=True) == pinned['h5']
          else ['the classes permuted'])}

    # ---- (c) the pipeline -----------------------------------------------
    argv = ['--dataset', dataset, '--dataset_folder', folder, '--results',
            results, '--logs', logs, '--model_id', 'chip', '--num_steps',
            str(steps)]
    data_cfg, _, box_cfg, full_base, _, _, batch = run_pipeline.CHAINS[
        dataset][1]('paper', results, logs, folder, steps)
    T = full_base.timespan
    valid = provider.get(dataset, data_cfg, split='valid')
    out['decode'] = decode_ms(valid, valid.get_dataset_size())
    ids = {s: f'{s}_model_{dataset}-chip' for s in ('fg', 'box', 'full')}
    seconds = {'pack': [], 'full_pack': [], 'eval': [],
               'cityscapes_eval': []}
    timings = {'pack': {}, 'eval': {}, 'cityscapes_eval': {}}
    packed_maps = []

    def with_timings(key):
      def wrap(fn):
        return lambda *a, **kw: fn(*a, timings=timings[key], **kw)
      return wrap

    def keep_maps(fn):
      def call(**maps):
        packed_maps.append({k: np.array(v) for k, v in maps.items()})
        return fn(**maps)
      return call
    gk.reset_launch_counts()
    t0 = time.time()
    with contextlib.ExitStack() as stack:
      runs = stack.enter_context(recorded_runs(torch, gk, dev))
      for owner, name, wrap in (
          (pack_cli, 'fg_main', lambda fn: timed_calls(
              torch, dev, fn, seconds['pack'])),
          (pack_cli, 'pack_h5', with_timings('pack')),
          (pack_cli, 'packed_group', keep_maps),
          (pack_cli, 'full_main', lambda fn: timed_calls(
              torch, dev, fn, seconds['full_pack'])),
          (eval_cli, 'full_main', lambda fn: timed_calls(
              torch, dev, fn, seconds['eval'])),
          (eval_cli, 'eval_split', with_timings('eval')),
          (cs_eval_cli, 'main', lambda fn: timed_calls(
              torch, dev, with_timings('cityscapes_eval')(fn),
              seconds['cityscapes_eval']))):
        stack.enter_context(patched(owner, name, wrap))
      got = run_pipeline.main(argv, device=dev)
    out['pipeline_seconds'] = time.time() - t0
    want_stages = list(run_pipeline.CHAINS[dataset][0])
    if got['stages'] != want_stages:
      failures.append(f'the pipeline ran {got["stages"]}')
    by_stage = {r['spec']: r for r in runs}
    for stage in [s for s in ('fg', 'box', 'full') if s in by_stage]:
      rec = by_stage[stage]
      out[stage] = {
          'batch': batch[stage], **step_ms_summary(rec),
          'step_ms_at_log': log_rows(os.path.join(logs, ids[stage]),
                                     'step_time'),
          'train_loss_at_log': log_rows(os.path.join(logs, ids[stage]),
                                        'loss'),
          **{k: rec[k] for k in ('start_step', 'run_seconds',
                                 'max_memory_allocated_bytes',
                                 'run_launches')}}
      losses = list(out[stage]['train_loss_at_log'].values())
      if not losses or not all(math.isfinite(v) for v in losses):
        failures.append(f'{stage}: loss {losses}')
    out['stage_host_seconds'] = seconds
    out['eval_host_seconds_per_batch'] = {
        k: statistics.median(v) for k, v in timings['eval'].items() if v}
    out['eval_batches'] = len(timings['eval'].get('forward', []))
    out['eval_launches'] = counts_delta(runs[-1]['launches_at_end'],
                                        launches_now(gk))
    if cityscapes:
      # Per image: the chain runs batches of the full model's size.
      per = {k: [t / batch['full'] for t in v]
             for k, v in timings['cityscapes_eval'].items()}
      out['cityscapes_eval_host_seconds_per_image'] = {
          k: statistics.median(v) for k, v in per.items() if v}

    # ---- (d) the fg pack, read back from the H5 (KITTI, Cityscapes) -----
    if packs:
      out['pack'] = {
          'seconds': seconds['pack'], 'full_pack_seconds': seconds['full_pack'],
          'write_seconds': timings['pack'].get('write'),
          'host_seconds_per_batch': {
              k: statistics.median(v) for k, v in timings['pack'].items()
              if v and k != 'write'},
          'bytes': {s: os.path.getsize(provider.h5_path(dataset, data_cfg, s))
                    for s in ('train', 'valid')}}

      def read_back(split, path=None):
        ds = provider.get(dataset, data_cfg, split=split, h5_fname=path)
        b = ds.get_batch(np.arange(ds.get_dataset_size()),
                         variables={'y_out', 'd_out'})
        return b['y_out'], b['d_out']
      n = {s: provider.get(dataset, data_cfg, split=s).get_dataset_size()
           for s in ('train', 'valid')}
      fg_maps = [m for m in packed_maps if 'foreground' in m]
      maps = {'train': fg_maps[:n['train']],
              'valid': fg_maps[n['train']:n['train'] + n['valid']]}

      def pack_diff(split, got):
        want_y = _DECODE[np.stack([m['foreground'] for m in maps[split]])]
        want_d = _DECODE[np.stack([m['orientation'] for m in maps[split]])]
        return [f'{split} {k}' for k, a, b in (('y_out', got[0], want_y),
                                               ('d_out', got[1], want_d))
                if not np.array_equal(a, b)]
      problems = [f'{s}: not every example holds the maps'
                  for s in ('train', 'valid')
                  if not provider.has_pack(data_cfg, s)]
      n_fg = sum(n.values()) + (provider.get(
          dataset, data_cfg, split='test').get_dataset_size()
                                if cityscapes else 0)
      if len(fg_maps) != n_fg:
        problems.append(f'{len(fg_maps)} examples packed')
      problems += [x for s in ('train', 'valid')
                   for x in pack_diff(s, read_back(s))]
      flipped = os.path.join(root, 'flipped.h5')
      valid_path = provider.h5_path(dataset, data_cfg, 'valid')
      with open(valid_path, 'rb') as src, open(flipped, 'wb') as dst:
        dst.write(src.read())
      ds = provider.get(dataset, data_cfg, split='valid')
      pack_predictions(flipped, {
          ds.get_str_id(i): {k: v[::-1] for k, v in m.items()}
          for i, m in zip(ds.img_ids, maps['valid'])})
      out['pack']['gate'] = gate(
          'the fg pack read back from the H5', problems,
          pack_diff('valid', read_back('valid', flipped)))

    # ---- the trained full model's eval step, kernel against plain -------
    full = by_stage['full']['exp']
    model = full.trainer.model
    bs = min(batch['full'], valid.get_dataset_size())
    valid_batch = full._device_batch(full.make_batch_fn(valid, T)(
        np.arange(bs)))
    plain, plain_solved = eval_step_metrics(torch, ts, matching, model,
                                            valid_batch, 'plain')
    gk.reset_launch_counts()
    kernel, kernel_solved = eval_step_metrics(torch, ts, matching, model,
                                              valid_batch, 'kernel')
    eval_step = {'kernel': kernel, 'plain': plain, **launches_now(gk),
                 'solves_agree': len(kernel_solved) == len(plain_solved)
                 and all(np.array_equal(u, v) for a, b in zip(
                     kernel_solved, plain_solved) for u, v in zip(a, b))}
    if not eval_step['solves_agree']:
      kernel, _ = eval_step_metrics(torch, ts, matching, model, valid_batch,
                                    'kernel', pinned=plain_solved)
    control, _ = eval_step_metrics(
        torch, ts, matching, model, valid_batch,
        shifted_plain(torch, EVAL_STEP_CONTROL_SHIFT), pinned=plain_solved)
    eval_step['kernel_rel_diff'] = metrics_rel_diff(kernel, plain)
    eval_step['control_rel_diff'] = metrics_rel_diff(control, plain)

    def over(diff):
      return [f'{k} {v:.3g}' for k, v in diff.items()
              if not v <= EVAL_STEP_REL_LIMIT]
    eval_step['gate'] = gate('full eval step, kernel against plain',
                             over(eval_step['kernel_rel_diff']),
                             over(eval_step['control_rel_diff']))
    out['eval_step'] = eval_step

    # ---- the files ------------------------------------------------------
    n_valid = valid.get_dataset_size()

    def files_diff(model_id):
      folder_ = os.path.join(results, model_id)
      problems = []
      want = os.path.join(results, ids['box'], 'weights.h5')
      try:
        named = FullModelConfig.from_yaml(os.path.join(
            folder_, 'model_opt.yaml')).pretrain_ctrl_net
      except (OSError, TypeError, ValueError) as e:
        named = f'unreadable ({e})'
      if named != want or not os.path.exists(want):
        problems.append(f'pretrain_ctrl_net {named}')
      if cityscapes:
        problems += submission_diff(folder_)
        return problems
      for name in DEFAULT_ANALYZERS:
        path = os.path.join(folder_, 'output_valid', f'{name}.csv')
        if not os.path.exists(path):
          problems.append(f'no {name}.csv')
      return problems

    def submission_diff(folder_):
      # Each valid and test image: the CSVs, its submission text file, and
      # its masks 0/255 at the full size.
      problems, masks = [], 0
      for split in run_pipeline.CITYSCAPES_EVAL_SPLITS:
        sub = os.path.join(folder_, f'output_{split}')
        for name in ('sbd', 'wt_cov', 'unwt_cov'):
          if not os.path.exists(os.path.join(sub, f'{name}.csv')):
            problems.append(f'{split}: no {name}.csv')
        ds = provider.get(dataset, data_cfg, split=split)
        full = ds.get_batch([0], variables={'orig_size'})['orig_size'][0]
        for i in ds.img_ids:
          fname = ds.get_fname(i)
          txt = os.path.join(sub, 'cityscapes', fname.split('_')[0],
                             fname[:-len('.png')] + '.txt')
          if not os.path.exists(txt):
            problems.append(f'{split}: no {os.path.basename(txt)}')
            continue
          with open(txt) as f:
            for line in f:
              m = png.imread(os.path.join(os.path.dirname(txt),
                                          line.split()[0]),
                             png.IMREAD_UNCHANGED)
              masks += 1
              if m.shape != tuple(full) or not set(np.unique(m)) <= {0, 255}:
                problems.append(f'{line.split()[0]}: {m.shape}')
      out.setdefault('submitted_masks', {})[os.path.basename(folder_)] = masks
      return problems
    out['files_gate'] = gate('the full model\'s files', files_diff(
        ids['full']), files_diff(ids['box']))
    sbd = os.path.join(results, ids['full'], 'output_valid', 'sbd.csv')
    if os.path.exists(sbd) and not cityscapes:
      with open(sbd) as f:
        rows = f.read().splitlines()[1:]
      out['eval_sbd_rows'] = len(rows)
      if len([r for r in rows if r and not r.startswith(('mean', 'std'))]) \
          < n_valid:
        failures.append(f'sbd.csv: {len(rows)} rows for {n_valid} examples')

    # ---- the AP of the ground truth's pack (Cityscapes) -----------------
    if cityscapes:
      valid_h5 = provider.h5_path(dataset, data_cfg, 'valid')
      ap, ap_seconds, ap_timings = cityscapes_gt_ap(
          torch, dev, valid_h5, folder, os.path.join(root, 'gt_ap'), T)
      shifted, _, _ = cityscapes_gt_ap(
          torch, dev, valid_h5, folder, os.path.join(root, 'gt_ap_shifted'),
          T, shift=CITYSCAPES_AP_CONTROL_SHIFT)

      def ap_diff(got):
        diff = {k: abs(got[k] - v) for k, v in pinned['ap'].items()}
        return [f'{k} {got[k]} against {pinned["ap"][k]}'
                for k, d in diff.items() if not d <= CITYSCAPES_AP_ATOL]
      out['gt_ap'] = {
          'ap': {k: ap[k] for k in pinned['ap']},
          'shifted': {k: shifted[k] for k in pinned['ap']},
          'pinned': pinned['ap'], 'atol': CITYSCAPES_AP_ATOL,
          'seconds': ap_seconds,
          'eval_host_seconds_per_batch': {
              k: statistics.median(v) for k, v in ap_timings.items() if v},
          'gate': gate('the AP of the ground truth\'s pack against the CPU\'s',
                       ap_diff(ap), ap_diff(shifted))}

    # ---- launches per step ----------------------------------------------
    gk.reset_launch_counts()
    draws = full.trainer.family.draws(
        full.model_cfg, bs, torch.Generator(dev).manual_seed(1))
    one_step(torch, ts, matching, model, full.trainer.opt_state,
             valid_batch, draws, full.step, 'plain')
    plain_step = launches_now(gk)
    recorded = {s: by_stage[s]['step_launches'] for s in by_stage}
    out['launches_per_step'] = {s: v[0] if v else None
                                for s, v in recorded.items()}
    if cuda:
      h, w = data_cfg.height, data_cfg.width
      fh, fw = full_base.filter_height, full_base.filter_width
      routes = {}
      for d, n in ((full_base.acnn_inp_depth, 2 * T), (1, 2 * T)):
        r = gk.extract_route(batch['full'], h, w, d, fh, fw)['kernel']
        routes[r] = routes.get(r, 0) + n
      out['full_extract_routes'] = routes
      none = {'glimpse_extract': 0, 'glimpse_paste': 0}
      want = {
          'fg': {'launches': none, 'backward_launches': none,
                 'extract_route_launches': {}},
          'box': {'launches': dict(none, glimpse_paste=2 * T),
                  'backward_launches': none, 'extract_route_launches': {}},
          'full': {'launches': {'glimpse_extract': 4 * T,
                                'glimpse_paste': 4 * T},
                   'backward_launches': dict(none, glimpse_extract=2 * T),
                   'extract_route_launches': routes}}

      def steps_diff(stage, per_step):
        return [f'{stage} step {i}: {s}' for i, s in enumerate(per_step)
                if s != want[stage]] or ([] if per_step else ['no step'])
      out['launch_gate'] = {
          stage: gate(f'{stage} launches per step',
                      steps_diff(stage, per_step),
                      steps_diff(stage, recorded['full'] if stage == 'fg'
                                 else [plain_step]))
          for stage, per_step in recorded.items()}

    # ---- the fg eval at the images' size (KITTI) ------------------------
    if dataset == 'kitti':
      out['fg_eval'] = fg_eval_at_orig_size(
          torch, provider.get(dataset, data_cfg, split='valid'), data_cfg,
          ['--model_id', ids['fg'], '--results', results, '--dataset',
           dataset, '--dataset_folder', folder, '--split', 'valid',
           '--batch_size', str(batch['fg'])], os.path.join(root, 'fg_eval'),
          gate, dev)
    out['folders'] = ids
  out['seconds'] = time.time() - start
  return out, failures


def fg_eval_at_orig_size(torch, ds, data_cfg, argv, out_dir, gate, dev):
  """``cli.eval fg`` of an H5 split (``argv``) into ``out_dir``, on
  ``dev`` and on the CPU: the foreground at each image's size in the
  dataset, the orientation and the target at the model's.  Gates: the
  renders' names and sizes (control: the foreground expected at the
  model's size); the renders card against CPU, at most
  KITTI_FG_PIXELS_DIFFER pixels differing a file by folder (control: the
  CPU's foreground at 0.55)."""
  import numpy as np

  from rec_attend_tpu_torch.cli import eval as eval_cli
  t0 = time.time()
  with deterministic_cudnn(torch):
    eval_cli.fg_main(argv + ['--output', out_dir], device=dev)
  seconds = time.time() - t0
  cpu_dir = out_dir + '_cpu'
  t0 = time.time()
  eval_cli.fg_main(argv + ['--output', cpu_dir, '--threshold_list',
                           '0.5,0.55'], device='cpu')
  cpu_seconds = time.time() - t0
  raw = ds.get_batch(np.arange(ds.get_dataset_size()),
                     variables={'idx_map', 'orig_size'})
  model_size = (data_cfg.height, data_cfg.width)
  card = decoded_pngs(out_dir)
  got = {name: img.shape[:2] for name, img in card.items()}

  def sizes_failures(fg_size):
    want = {}
    for idx, size in zip(raw['idx_map'], raw['orig_size']):
      name = ds.get_fname(idx)
      want[f'50/{name}'] = fg_size(tuple(int(v) for v in size))
      want[f'gt/{name}'] = want[f'orientation/{name}'] = model_size
    if sorted(got) != sorted(want):
      return [f'files {sorted(got)[:2]}... ({len(got)}), want '
              f'{sorted(want)[:2]}... ({len(want)})']
    return [f'{k}: {got[k]}, want {v}' for k, v in want.items()
            if got[k] != v]
  cpu = decoded_pngs(cpu_dir)
  differ = pixels_differ(card, {k: v for k, v in cpu.items()
                                if not k.startswith('55/')})
  control = pixels_differ(card, {k.replace('55/', '50/'): v
                                 for k, v in cpu.items()
                                 if k.startswith('55/')})

  def most(counts):
    by_folder = {}
    for k, v in counts.items():
      folder = k.split('/')[0]
      by_folder[folder] = max(by_folder.get(folder, v), v)
    return by_folder
  return {'seconds': seconds, 'cpu_seconds': cpu_seconds,
          'renders': len(got),
          'sizes': sorted({str(v) for v in got.values()}),
          'gate': gate('fg eval renders at the images\' size',
                       sizes_failures(lambda size: size),
                       sizes_failures(lambda size: model_size)),
          'pixels_differ_most': most(differ),
          'control_pixels_differ_most': most(control),
          'pixels_gate': gate('fg eval at the images\' size, card against '
                              'CPU', pixels_over(differ,
                                                 KITTI_FG_PIXELS_DIFFER),
                              pixels_over(control, KITTI_FG_PIXELS_DIFFER))}


# ---------------------------------------------------------------------------
# weights_h5: the weights.h5 files on the card
# ---------------------------------------------------------------------------

def sha256_of(a):
  """SHA-256 of an array's dtype, shape and bytes (FLAGSHIP_BOX_SHA256)."""
  return hashlib.sha256(f'{a.dtype.str}{a.shape}'.encode()
                        + a.tobytes()).hexdigest()


def committed_config(folder):
  """The ``FullModelConfig`` of a committed ``model_opt.yaml``, its
  ``pretrain_*`` paths resolved against the checkout's root, where the JAX
  runs started."""
  from rec_attend_tpu_torch.config import FullModelConfig
  cfg = FullModelConfig.from_yaml(os.path.join(folder, 'model_opt.yaml'))
  return cfg.replace(**{k: os.path.join(REPO, getattr(cfg, k))
                        for k in PRETRAIN_FIELDS if getattr(cfg, k)
                        and not os.path.isabs(getattr(cfg, k))})


def checkpoint_h5_arrays(path, cfg, nets):
  """{weights.h5 key: array} of the nets of a checkpoint, as
  ``read_weights`` exports them."""
  from rec_attend_tpu_torch import convert
  from rec_attend_tpu_torch.nn import params as P
  state = convert.params_from_checkpoint(path, cfg)
  out = {}
  for net in nets:
    value = P.net_from_state(state, net)
    if value is not None:
      out.update(P.h5_arrays(net, value))
  return out


def h5_state(path, nets):
  """{state-dict name: array} of the nets of a weights.h5 as the port
  reads them (``params.load_net_h5``)."""
  from rec_attend_tpu_torch.nn import params as P
  out = {}
  for net in nets:
    value = P.load_net_h5(path, net)
    if value is not None:
      out.update(P.net_to_state(net, value))
  return out


def arrays_diff(got, want):
  """The keys of two {key: array} whose arrays differ in dtype, shape or
  bits, or that one of them lacks."""
  return [k for k in sorted(set(got) | set(want))
          if k not in got or k not in want or got[k].dtype != want[k].dtype
          or got[k].shape != want[k].shape
          or got[k].tobytes() != want[k].tobytes()]


def state_diff(torch, state, want):
  """The names whose tensor in ``state`` differs from ``want``'s array or
  tensor, bit for bit."""
  return [k for k, v in want.items()
          if not torch.equal(state[k].cpu(), torch.as_tensor(v).cpu())]


def committed_weights_gates(failures, root):
  """Phase weights_h5 (a): the committed box weights.h5 files the copy
  holds, read by the port's codec: the flagship box's against
  FLAGSHIP_BOX_SHA256 (h5py's reading; control: a copy with one float's
  bytes flipped), synth3's and synthcs's against their ckpt-12000's nets
  bit for bit (control: against the other box's checkpoint)."""
  from rec_attend_tpu_torch.cli.read_weights import BOX_NETS
  from rec_attend_tpu_torch.config import BoxModelConfig
  from rec_attend_tpu_torch.engine import saver
  from rec_attend_tpu_torch.utils import h5
  table = dict(line.split() for line in FLAGSHIP_BOX_SHA256.split('\n')
               if line)

  def sha_diff(path):
    got = {k: sha256_of(v) for k, v in h5.read(path).items()}
    return sorted(k for k in set(got) | set(table)
                  if got.get(k) != table.get(k))
  path = os.path.join(FLAGSHIP_BOX_DIR, 'weights.h5')
  flipped = os.path.join(root, 'flipped.h5')
  with open(path, 'rb') as f:
    raw = bytearray(f.read())
  at = raw.find(h5.read(path)['ctrl_cnn_w_0'].tobytes()) + 1
  raw[at] ^= 1      # a mantissa bit of the first float of ctrl_cnn_w_0
  with open(flipped, 'wb') as f:
    f.write(raw)
  out = {'flagship_box_keys': len(table), 'flagship_box': gate_with_control(
      failures, 'flagship box weights.h5 against its SHA-256 table',
      sha_diff(path), sha_diff(flipped))}
  ckpt_arrays = {}
  for name, folder in (('synth3_box', CHAIN_BOX_DIR),
                       ('synthcs_box', SYNTHCS_BOX_DIR)):
    cfg = BoxModelConfig.from_yaml(os.path.join(folder, 'model_opt.yaml'))
    ckpt_arrays[name] = checkpoint_h5_arrays(saver.latest_checkpoint(folder),
                                             cfg, BOX_NETS)
  for name, other, folder in (
      ('synth3_box', 'synthcs_box', CHAIN_BOX_DIR),
      ('synthcs_box', 'synth3_box', SYNTHCS_BOX_DIR)):
    got = h5.read(os.path.join(folder, 'weights.h5'))
    out[name] = gate_with_control(
        failures, f'{name} weights.h5 against its ckpt-12000',
        arrays_diff(got, ckpt_arrays[name]),
        arrays_diff(got, ckpt_arrays[other]))
    out[name]['keys'] = len(got)
  return out


def weights_h5_phase(torch, gk, dev, batch=WEIGHTS_H5_BATCH):
  """The weights.h5 files on the card: (a) ``committed_weights_gates``;
  (b) the flagship's committed start, its model_opt.yaml as committed (its
  controller from the box's weights.h5, every other net at its seed-0
  value) in a ``TrainingExperiment`` on synthetic data, its first step
  gated kernel against plain (PRETRAINED_STEP_LIMITS), then
  WEIGHTS_H5_START_STEPS steps; (c) ``read_weights`` of the flagship's
  ckpt-30000 and of the synth3 box, and the ft2 finetune's
  ``TrainingExperiment`` from the exported file (``pretrain_net``): its
  state and eval forward against ckpt-30000's bit for bit (control: the
  file without score_mlp), then WEIGHTS_H5_FT_STEPS steps.  Results and
  logs go to a temporary folder in the checkout, removed after.  Returns
  (results, the gates' failures)."""
  from rec_attend_tpu_torch import convert
  from rec_attend_tpu_torch import train_step as ts
  from rec_attend_tpu_torch.cli import read_weights
  from rec_attend_tpu_torch.config import DataConfig
  from rec_attend_tpu_torch.config import TrainConfig
  from rec_attend_tpu_torch.data.synthetic import synthetic_images
  from rec_attend_tpu_torch.data.synthetic import synthetic_instances
  from rec_attend_tpu_torch.engine import saver
  from rec_attend_tpu_torch.engine.experiment import TrainingExperiment
  from rec_attend_tpu_torch.models.full_model import CTRL_NETS
  from rec_attend_tpu_torch.models.full_model import FullModel
  from rec_attend_tpu_torch.models.full_model import draw_train_randoms
  from rec_attend_tpu_torch.models.full_model import full_model_forward
  from rec_attend_tpu_torch.models.full_model import learn_rate
  from rec_attend_tpu_torch.models.full_model import load_pretrained
  from rec_attend_tpu_torch.ops import matching
  from rec_attend_tpu_torch.utils import h5

  out, failures = {}, []

  def gate(name, got, control):
    return gate_with_control(failures, name, got, control)

  cfg = committed_config(CHECKPOINT_DIR)
  T, H, W = cfg.timespan, cfg.inp_height, cfg.inp_width
  # A step's launches: on the CPU the kernels' plain versions run, none.
  n = T if dev.type == 'cuda' else 0
  want_step = {'launches': {'glimpse_extract': 4 * n, 'glimpse_paste': 4 * n},
               'backward_launches': {'glimpse_extract': 2 * n,
                                     'glimpse_paste': 0}}

  def run(exp, label):
    """exp.run() recorded: step ms, peak memory, launches per step."""
    with recorded_runs(torch, gk, dev) as runs:
      exp.run()
    exp.close()
    rec = runs[0]
    steps = rec['step_launches']
    for i, got in enumerate(steps):
      got = {k: got[k] for k in want_step}
      if got != want_step:
        failures.append(f'{label} step {i}: launches {got}, want '
                        f'{want_step}')
    losses = log_rows(exp.logs_folder, 'loss')
    if len(steps) != exp.train_cfg.num_steps or not all(
        math.isfinite(v) for v in losses.values()):
      failures.append(f'{label}: {len(steps)} steps, losses {losses}')
    return {**step_ms_summary(rec), 'losses': losses,
            'launches_per_step': steps[0] if steps else None,
            'run_launches': rec['run_launches'],
            'max_memory_allocated_bytes': rec['max_memory_allocated_bytes'],
            'run_seconds': rec['run_seconds']}

  with tempfile.TemporaryDirectory(prefix='.chip_smoke_weights_h5-',
                                   dir=REPO) as root:
    # ---- (a) the committed files ----------------------------------------
    t0 = time.time()
    out['committed'] = committed_weights_gates(failures, root)
    out['committed']['seconds'] = time.time() - t0

    # ---- (b) the flagship's committed start -----------------------------
    data_cfg = DataConfig(dataset='synth', folder=os.path.join(root, 'data'),
                          height=H, width=W, timespan=T, num_examples=batch,
                          max_objects=9)
    train_cfg = TrainConfig(
        model_id='full_model_synth-start', num_steps=WEIGHTS_H5_START_STEPS,
        batch_size=batch, results=os.path.join(root, 'results'),
        logs=os.path.join(root, 'logs'), steps_per_valid=0,
        steps_per_trainval=0, steps_per_plot=0, steps_per_log=1,
        has_valid=False, save_ckpt=False)
    t0 = time.time()
    exp = TrainingExperiment('full', cfg, train_cfg, data_cfg, device=dev)
    start = {'pretrain_ctrl_net': os.path.relpath(cfg.pretrain_ctrl_net,
                                                  REPO),
             'setup_seconds': time.time() - t0}
    state = exp.trainer.model.state_dict()
    seed0 = FullModel(cfg, seed=0, device='cpu').state_dict()
    ctrl = h5_state(cfg.pretrain_ctrl_net, CTRL_NETS)
    others = {k: v for k, v in seed0.items()
              if k.split('.')[0] not in CTRL_NETS}
    start['loaded_leaves'] = len(ctrl)
    start['loaded_gate'] = gate(
        'committed start: controller = the box weights.h5, the rest seed 0',
        state_diff(torch, state, {**ctrl, **others}),
        state_diff(torch, state, seed0))
    gate_batch = {k: v.to(dev) for k, v in synthetic_instances(
        batch, H, W, T, seed=1000).items()}
    draws = draw_train_randoms(cfg, batch,
                               torch.Generator(dev).manual_seed(1))
    t0 = time.time()
    gates, f = step_gates(torch, ts, matching, gk, exp.trainer.model,
                          exp.trainer.opt_state, gate_batch, draws, 0,
                          learn_rate(cfg, 0), PRETRAINED_STEP_LIMITS)
    start['step_gates'] = gates
    start['step_gate_seconds'] = time.time() - t0
    failures.extend(f'committed start step 0: {x}' for x in f)
    start['run'] = run(exp, 'committed start')
    out['start'] = start

    # ---- (c) export and finetune ----------------------------------------
    t0 = time.time()
    full_h5 = read_weights.full_main(
        ['--model_id', os.path.basename(CHECKPOINT_DIR), '--results',
         os.path.dirname(CHECKPOINT_DIR), '--output',
         os.path.join(root, 'full_weights.h5')], device=dev)
    ckpt = saver.latest_checkpoint(CHECKPOINT_DIR)
    exported = h5.read(full_h5)
    box_committed = h5.read(os.path.join(CHAIN_BOX_DIR, 'weights.h5'))
    export = {'seconds': time.time() - t0, 'full_keys': len(exported)}
    export['full_gate'] = gate(
        'read_weights full of ckpt-30000 against its nets',
        arrays_diff(exported, checkpoint_h5_arrays(
            ckpt, cfg, read_weights.FULL_NETS)),
        arrays_diff(exported, h5.read(cfg.pretrain_ctrl_net)))
    box_h5 = read_weights.box_main(
        ['--model_id', os.path.basename(CHAIN_BOX_DIR), '--results',
         os.path.dirname(CHAIN_BOX_DIR), '--output',
         os.path.join(root, 'synth3_box.h5')], device=dev)
    export['synth3_box_gate'] = gate(
        'read_weights box of the synth3 box against its committed file',
        arrays_diff(h5.read(box_h5), box_committed),
        arrays_diff(h5.read(box_h5), h5.read(os.path.join(
            SYNTHCS_BOX_DIR, 'weights.h5'))))
    out['export'] = export

    ft_cfg = committed_config(FT2_DIR).replace(pretrain_net=full_h5)
    t0 = time.time()
    ft = TrainingExperiment('full', ft_cfg, train_cfg.replace(
        model_id='full_model_synth_ft2-chip',
        num_steps=WEIGHTS_H5_FT_STEPS), data_cfg, device=dev)
    finetune = {'finetune': ft_cfg.finetune,
                'setup_seconds': time.time() - t0}
    restored = FullModel(cfg, device=dev)
    restored.load_state_dict(convert.params_from_checkpoint(ckpt, cfg))
    no_score = os.path.join(root, 'no_score_mlp.h5')
    h5.write(no_score, {k: v for k, v in exported.items()
                        if not k.startswith('score_mlp')})
    control = FullModel(ft_cfg, device=dev)
    load_pretrained(control, ft_cfg.replace(pretrain_net=no_score))
    x = synthetic_images(batch, H, W, seed=7).to(dev)

    def forward(model):
      with deterministic_cudnn(torch), torch.inference_mode():
        return full_model_forward(model, x, glimpse='kernel')
    want = forward(restored)

    def forward_diff_bits(model):
      got = forward(model)
      return state_diff(torch, model.state_dict(), restored.state_dict()) + [
          k for k, v in want.items() if not torch.equal(got[k], v)]
    finetune['forward_gate'] = gate(
        'ft2 start: state and b32 eval forward against ckpt-30000, bit for '
        'bit', forward_diff_bits(ft.trainer.model),
        forward_diff_bits(control))
    del restored, control
    finetune['run'] = run(ft, 'ft2 finetune')
    out['finetune'] = finetune

  launches = {}
  for kind in ('launches', 'backward_launches'):
    launches[kind] = {
        k: sum(r['run']['run_launches'][kind][k]
               for r in (out['start'], out['finetune']))
        for k in ('glimpse_extract', 'glimpse_paste')}
  out['launches'] = launches
  out['limits'] = PRETRAINED_STEP_LIMITS
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


def linked_model_folder(src, dst, data_cfg=None):
  """A results folder ``dst`` for the model of ``src``: its checkpoints
  linked and its model_opt.yaml copied (the commands write beside them, so
  a committed folder is never theirs), and ``data_cfg``'s data_opt.yaml
  where given."""
  import glob
  import shutil
  os.makedirs(dst)
  for path in glob.glob(os.path.join(src, 'ckpt-*.npz')):
    os.symlink(path, os.path.join(dst, os.path.basename(path)))
  shutil.copy(os.path.join(src, 'model_opt.yaml'), dst)
  if data_cfg is not None:
    data_cfg.save_yaml(os.path.join(dst, 'data_opt.yaml'))
  return dst


def png_files(folder):
  """The PNG files under ``folder``, relative to it, in order."""
  return sorted(os.path.relpath(os.path.join(root, f), folder)
                for root, _, files in os.walk(folder) for f in files
                if f.endswith('.png'))


def decoded_pngs(folder):
  from rec_attend_tpu_torch.utils import png
  return {name: png.imread(os.path.join(folder, name), png.IMREAD_UNCHANGED)
          for name in png_files(folder)}


def pixels_differ(got, want):
  """{file of ``want``: the pixels in which the decoded PNG ``got[file]``
  differs from it, or -1 where it is missing or of another shape}."""
  counts = {}
  for name, other in want.items():
    img = got.get(name)
    if img is None or other.shape != img.shape:
      counts[name] = -1
      continue
    differ = img != other
    counts[name] = int((differ.any(axis=-1) if differ.ndim == 3
                        else differ).sum())
  return counts


def pixels_over(counts, limits):
  """Failures of pixel counts against ``limits``, by the file's folder."""
  return [f'{k}: {v} pixels' for k, v in counts.items()
          if not 0 <= v <= limits[k.split('/')[0]]]


def per_example_diff(got, want, sbd_limit):
  """Failures of per-example SBD (within ``sbd_limit``) and counts (equal)
  of two {'sbd', 'dic'} score tables."""
  if sorted(got['sbd']) != sorted(want['sbd']) or not want['sbd']:
    return [f'ids {sorted(got["sbd"])[:3]} against {sorted(want["sbd"])[:3]}']
  return ([f'{k} sbd {got["sbd"][k]} against {want["sbd"][k]}'
           for k in want['sbd']
           if not abs(got['sbd'][k] - want['sbd'][k]) <= sbd_limit]
          + [f'{k} dic {got["dic"][k]} against {want["dic"][k]}'
             for k in want['dic'] if got['dic'][k] != want['dic'][k]])


def calibrate_phase(torch, gk, dev, sbd_limit):
  """The count calibration of the flagship as users run it:
  pipelines.calibrate_count.main on the card, at b32, over a temporary
  copy of the flagship's folder (its checkpoint, its two YAML files and
  its output_valid/) inside the checkout, removed after; the synth224
  train (256) and valid (64) splits drawn anew from its data_opt.yaml.
  cuDNN deterministic, as every compared forward.  Gates, each with a
  control that must fail: count_diag's scores of the train split with
  the plain glimpses within CALIBRATE_S_OUT_ATOL of the kernel run's per
  example, with its best score-only row and so the same stop score
  (control: the true counts one slot off); the valid split at the
  calibrated thresholds with the plain glimpses, per-example SBD within
  ``sbd_limit`` (the eval phase's) and counts equal to the kernel run's
  CSVs (control: the mask threshold CALIBRATE_CONTROL_SHIFT higher); the
  files the command writes (control: the train sweep's renders).  The
  thresholds and the headline are printed beside the committed
  count_calibration.json's, which JAX drew on its own images (ROADMAP
  C.17).  Returns (results, failures)."""
  import shutil

  import numpy as np

  from rec_attend_tpu_torch.cli import eval as eval_cli
  from rec_attend_tpu_torch.config import DataConfig
  from rec_attend_tpu_torch.data import provider
  from rec_attend_tpu_torch.engine.experiment import EvalExperiment
  from rec_attend_tpu_torch.pipelines import calibrate_count
  from rec_attend_tpu_torch.pipelines import count_diag

  out, failures = {}, []

  def gate(name, got, control):
    return gate_with_control(failures, name, got, control)

  model_id = os.path.basename(CHECKPOINT_DIR)
  with open(os.path.join(CHECKPOINT_DIR, 'count_calibration.json')) as f:
    committed = json.load(f)
  with tempfile.TemporaryDirectory(prefix='.chip_smoke_calibrate-',
                                   dir=REPO) as root:
    results = os.path.join(root, 'results')
    folder = linked_model_folder(CHECKPOINT_DIR,
                                 os.path.join(results, model_id))
    shutil.copy(os.path.join(CHECKPOINT_DIR, 'data_opt.yaml'), folder)
    shutil.copytree(os.path.join(CHECKPOINT_DIR, 'output_valid'),
                    os.path.join(folder, 'output_valid'))
    data = os.path.join(root, 'data')
    data_cfg = DataConfig.from_yaml(os.path.join(folder, 'data_opt.yaml'))
    data_cfg = data_cfg.replace(folder=data)

    # ---- the command; its count_diag scores and its splits kept ---------
    kept, splits = [], {}

    def keep(scores):
      def wrapped(exp, dataset, *a, **kw):
        kept.append(scores(exp, dataset, *a, **kw))
        splits['train'] = dataset
        return kept[-1]
      return wrapped

    def keep_valid(eval_split):
      def wrapped(exp, dataset, output_folder, *a, **kw):
        if output_folder.endswith('output_valid_calibrated'):
          splits['valid'] = dataset
        return eval_split(exp, dataset, output_folder, *a, **kw)
      return wrapped
    timings = {}
    gk.reset_launch_counts()
    t0 = time.time()
    with deterministic_cudnn(torch), patched(count_diag, 'scores', keep), \
        patched(eval_cli, 'eval_split', keep_valid):
      summary = calibrate_count.main(
          ['--model_id', model_id, '--results', results, '--batch_size',
           str(CALIBRATE_BATCH), '--dataset_folder', data], device=dev,
          timings=timings)
    out['seconds'] = time.time() - t0
    out['host_seconds'] = timings
    out.update(launches_now(gk))
    thr = summary['calibrated_threshold']
    head = summary['headline']
    out['calibrated_threshold'] = thr
    out['mask_threshold'] = head['mask_threshold']
    out['train_score_only'] = summary['train_score_only']
    out['headline'] = {k: v[0] for k, v in head['metrics'].items()}
    out['valid_rows'] = summary['valid']
    out['committed'] = {
        'calibrated_threshold': committed['calibrated_threshold'],
        'mask_threshold': committed['headline']['mask_threshold'],
        'train_score_only': committed['train_score_only'],
        'headline': {k: v[0]
                     for k, v in committed['headline']['metrics'].items()}}
    n_train, n_valid = (provider.settings(data_cfg, split)['num_examples']
                        for split in ('train', 'valid'))
    batches = (-(-n_train // CALIBRATE_BATCH)
               + -(-n_valid // CALIBRATE_BATCH)
               + min(calibrate_count.TRAIN_MAX_BATCHES,
                     -(-n_train // CALIBRATE_BATCH)))
    plain = EvalExperiment(folder, device=dev, glimpse='plain')
    T = plain.cfg.timespan
    want = {'glimpse_extract': T * batches, 'glimpse_paste': 2 * T * batches}
    if out['launches'] != want or out['extract_route_launches'] != {
        'extract_tiled_kernel': T * batches}:
      failures.append(f'launches {out["launches"]} '
                      f'{out["extract_route_launches"]}, want {want}')

    # ---- count_diag with the plain glimpses -----------------------------
    s_kernel, _ = kept[0]
    with deterministic_cudnn(torch):
      s_plain, k_plain = count_diag.scores(plain, splits['train'],
                                           CALIBRATE_BATCH)
    s_diff = float(np.abs(s_plain - s_kernel).max())
    best = count_diag.diagnose(s_plain, k_plain, model_id, 'train')[
        'score_only_best']
    off = count_diag.diagnose(s_plain, np.minimum(k_plain + 1, T), model_id,
                              'train')['score_only_best']

    def diag_failures(pick, s_max_abs):
      return ([f's_out differs by {s_max_abs}'] if not s_max_abs <=
              CALIBRATE_S_OUT_ATOL else []) + (
                  [f'best {pick}, kernel {summary["train_score_only"]}']
                  if pick != summary['train_score_only'] else [])
    out['count_diag'] = {
        's_out_max_abs_kernel_vs_plain': s_diff,
        'examples': len(s_plain), 'plain_best': best,
        'control_best': off,
        'gate': gate('count_diag plain against kernel',
                     diag_failures(best, s_diff), diag_failures(off, s_diff))}

    # ---- the valid split at the calibrated thresholds, plain ------------
    nn = f'{int(head["mask_threshold"] * 100):02d}'
    got = {n: read_scores(os.path.join(folder, 'output_valid_calibrated'),
                          f'{n}_{nn}') for n in ('sbd', 'dic')}
    # The plain glimpses' eval at the calibrated thresholds and, for the
    # control, at a mask threshold CALIBRATE_CONTROL_SHIFT higher: one
    # forward pass, two thresholds.
    masks = [head['mask_threshold'],
             head['mask_threshold'] + CALIBRATE_CONTROL_SHIFT]
    path = os.path.join(root, 'plain')
    with deterministic_cudnn(torch):
      eval_cli.eval_split(plain, splits['valid'], path, masks,
                          ['sbd', 'dic'], batch_size=CALIBRATE_BATCH,
                          score_threshold=thr)
    plain_at = [{n: read_scores(path, f'{n}_{int(m * 100):02d}')
                 for n in ('sbd', 'dic')} for m in masks]
    out['valid_eval_gate'] = gate(
        'valid split at the calibrated thresholds, kernel against plain',
        per_example_diff(got, plain_at[0], sbd_limit),
        per_example_diff(got, plain_at[1], sbd_limit))
    out['sbd_limit'] = sbd_limit

    # ---- the files -------------------------------------------------------
    thresholds = 6
    listing = {
        'count_diag_train': sorted(f for f in os.listdir(folder)
                                   if f.startswith('count_diag_train')),
        'calibration': os.path.exists(os.path.join(
            folder, 'count_calibration.json')),
        **{sub: (len([f for f in os.listdir(os.path.join(folder, sub))
                      if f.endswith('.csv')]),
                 len(png_files(os.path.join(folder, sub))))
           for sub in ('output_valid_calibrated', 'output_train_calibrated')}}
    out['files'] = listing
    csvs = len(eval_cli.DEFAULT_ANALYZERS) * thresholds

    def files_failures(valid_renders, train_renders):
      want = {'count_diag_train': ['count_diag_train.csv',
                                   'count_diag_train.json'],
              'calibration': True,
              'output_valid_calibrated': (csvs, valid_renders),
              'output_train_calibrated': (csvs, train_renders)}
      return [f'{k}: {listing[k]}, want {v}' for k, v in want.items()
              if listing[k] != v]
    out['files_gate'] = gate(
        'the files written', files_failures(thresholds * n_valid, 0),
        files_failures(thresholds * n_valid, thresholds * n_train))
  return out, failures


def fg_eval_phase(torch, gk, dev):
  """The fg eval and the foreground eval as users run them, on the
  committed synth3 chain's fg and full checkpoints (a checkout without
  them fails) over 8 synthetic 128x448 valid images (the synth3 split's
  settings, 32 train examples), in temporary results folders inside the
  checkout, removed after: ``cli.eval fg`` (foreground at 0.5, its
  orientation colour wheel, its target) on the card and on the CPU, the
  fg pack, and ``cli.eval`` of the full model with
  ``--foreground_folder`` (those renders at 0.5), ``--remove_tiny``
  FG_EVAL_REMOVE_TINY and its instance renders.  Gates, each with a
  control that must fail: the fg PNGs card against CPU, at most
  FG_EVAL_PIXELS_DIFFER pixels differing a file (control: the CPU's
  foreground at threshold 0.55); the foreground eval's per-example SBD
  and counts kernel against plain (eval_split with the plain glimpses on
  the same files; control: the foreground target's renders as the
  foreground); the renders' names and counts (control: those of the
  train split).  Returns (results, failures)."""
  import functools

  import numpy as np

  from rec_attend_tpu_torch.cli import eval as eval_cli
  from rec_attend_tpu_torch.cli import pack as pack_cli
  from rec_attend_tpu_torch.data import provider
  from rec_attend_tpu_torch.engine.experiment import EvalExperiment
  from rec_attend_tpu_torch.pipelines import run_pipeline

  out, failures = {}, []

  def gate(name, got, control):
    return gate_with_control(failures, name, got, control)

  with tempfile.TemporaryDirectory(prefix='.chip_smoke_fg_eval-',
                                   dir=REPO) as root:
    results = os.path.join(root, 'results')
    data_cfg = run_pipeline.synth3_stages('paper')[0].replace(
        folder=os.path.join(root, 'data'), num_examples=FG_EVAL_EXAMPLES)
    fg_id, full_id = (os.path.basename(d) for d in (CHAIN_FG_DIR,
                                                    CHAIN_FULL_DIR))
    for src, name in ((CHAIN_FG_DIR, fg_id), (CHAIN_FULL_DIR, full_id)):
      linked_model_folder(src, os.path.join(results, name), data_cfg)
    common = ['--results', results, '--dataset', 'synth', '--split',
              'valid', '--batch_size', str(FG_EVAL_BATCH)]
    fg_out = {d: os.path.join(root, f'fg_{d}') for d in ('card', 'cpu')}
    seconds = {}
    for where, device in (('card', dev), ('cpu', 'cpu')):
      t0 = time.time()
      with deterministic_cudnn(torch):
        eval_cli.fg_main(common + ['--model_id', fg_id, '--output',
                                   fg_out[where]], device=device)
      seconds[f'fg_eval_{where}'] = time.time() - t0
    eval_cli.fg_main(common + ['--model_id', fg_id, '--output',
                               os.path.join(root, 'fg_cpu_55'),
                               '--threshold_list', '0.55'], device='cpu')
    card = decoded_pngs(fg_out['card'])
    cpu = decoded_pngs(fg_out['cpu'])
    control = {k.replace('55/', '50/'): v for k, v in decoded_pngs(
        os.path.join(root, 'fg_cpu_55')).items() if k.startswith('55/')}

    differ = pixels_differ(card, cpu)
    control_differ = pixels_differ(card, control)
    if sorted(differ) != sorted(card):
      failures.append(f'fg renders: card {sorted(card)[:3]}, CPU '
                      f'{sorted(cpu)[:3]}')
    out['fg'] = {'pixels_differ_card_vs_cpu': differ,
                 'control_pixels_differ': control_differ,
                 'gate': gate('fg renders card against CPU',
                              pixels_over(differ, FG_EVAL_PIXELS_DIFFER),
                              pixels_over(control_differ,
                                          FG_EVAL_PIXELS_DIFFER))}

    # ---- the fg pack, then the full eval on those foreground maps -------
    t0 = time.time()
    with deterministic_cudnn(torch):
      pack_cli.fg_main(common[:-2] + ['--model_id', fg_id, '--batch_size',
                                      str(FG_EVAL_BATCH)], device=dev)
    seconds['fg_pack'] = time.time() - t0
    fg_folder = os.path.join(fg_out['card'], '50')
    full_out = os.path.join(root, 'full_card')
    gk.reset_launch_counts()
    t0 = time.time()
    with deterministic_cudnn(torch):
      eval_cli.full_main(common + [
          '--model_id', full_id, '--output', full_out, '--threshold_list',
          str(CHAIN_MASK_THRESHOLD), '--score_threshold',
          str(CHAIN_SCORE_THRESHOLD), '--foreground_folder', fg_folder,
          '--remove_tiny', str(FG_EVAL_REMOVE_TINY)], device=dev)
    seconds['foreground_eval'] = time.time() - t0
    out['foreground_eval_launches'] = launches_now(gk)
    got = {n: read_scores(full_out, n) for n in ('sbd', 'dic')}
    packed = provider.get('synth', data_cfg, split='valid')
    plain = EvalExperiment(os.path.join(results, full_id), device=dev,
                           glimpse='plain')

    def plain_scores(foreground_folder, name):
      path = os.path.join(root, name)
      with deterministic_cudnn(torch):
        eval_cli.eval_split(
            plain, packed, path, [CHAIN_MASK_THRESHOLD], ['sbd', 'dic'],
            foreground=functools.partial(eval_cli._read_foreground,
                                         foreground_folder),
            remove_tiny=FG_EVAL_REMOVE_TINY, batch_size=FG_EVAL_BATCH,
            score_threshold=CHAIN_SCORE_THRESHOLD)
      return {n: read_scores(path, n) for n in ('sbd', 'dic')}
    out['foreground_eval'] = {
        'sbd': got['sbd'], 'dic': got['dic'],
        'sbd_mean': statistics.mean(got['sbd'].values()),
        'gate': gate('foreground eval, kernel against plain',
                     per_example_diff(got, plain_scores(fg_folder, 'plain'),
                                      PIPELINE_CLI_SBD_LIMIT),
                     per_example_diff(got, plain_scores(
                         os.path.join(fg_out['card'], 'gt'), 'control'),
                                      PIPELINE_CLI_SBD_LIMIT))}

    # ---- the renders' names and counts ----------------------------------
    def names(split):
      ds = provider.get('synth', data_cfg, split=split)
      files = [ds.get_fname(i) for i in ds.get_batch(
          np.arange(ds.get_dataset_size()), timespan=data_cfg.timespan,
          variables={'idx_map'})['idx_map']]
      return ([f'{sub}/{f}' for sub in ('50', 'gt', 'orientation')
               for f in files],
              [f'{int(CHAIN_MASK_THRESHOLD * 100):02d}/{f}' for f in files])
    listing = (png_files(fg_out['card']), png_files(full_out))

    def listing_failures(want):
      return [f'{got[:2]}... ({len(got)}) against {w[:2]}... ({len(w)})'
              for got, w in zip(listing, want) if got != w]
    out['renders'] = {'fg': len(listing[0]), 'full': len(listing[1]),
                      'gate': gate('render files', listing_failures(
                          [sorted(v) for v in names('valid')]),
                                   listing_failures([sorted(v) for v in
                                                     names('train')]))}
    out['seconds'] = seconds
  return out, failures


def main():
  import torch
  if not torch.cuda.is_available():
    sys.exit('chip_smoke: CUDA is not available; this script runs on a card')
  import numpy as np
  from rec_attend_tpu_torch.config import cityscapes_full_config
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
  # The synthcs pipeline's box and full model at b4: extract x
  # [4,256,512,15], its pastes' d_p, extract x [4,256,512,1], and paste
  # [4,48,48,1] -> 256x512.
  synthcs_train_dims = {
      'glimpse_extract': (SYNTHCS_TRAIN_BATCH,) + cs_dims[
          'glimpse_extract'][1:],
      'glimpse_paste': (SYNTHCS_TRAIN_BATCH,) + cs_dims['glimpse_paste'][1:],
      'synthcs_d1_b4': (SYNTHCS_TRAIN_BATCH,) + cs_dims['glimpse_paste'][1:],
  }
  for key, dims in synthcs_train_dims.items():
    name = 'glimpse_extract' if key == 'synthcs_d1_b4' else key
    checks[name]['synthcs_b4' if key == name else key] = check_kernel(
        torch, gk, attention, name, *dims, gen, dev, timed=True)
  # The H5 datasets' pipelines: CVPPP's box and full model at b5 (extract x
  # [5,224,224,4], its pastes' d_p [5,224,224,1], paste [5,48,48,1] ->
  # 224x224), KITTI's box at b5 (paste -> 128x448) and full model at b2
  # (extract x [2,128,448,13], d_p [2,128,448,1], paste -> 128x448).
  h5_dims = h5_kernel_dims(cfg, chain_cfg, cityscapes_full_config())
  for (name, key), dims in h5_dims.items():
    checks[name][key] = check_kernel(torch, gk, attention, name, *dims, gen,
                                     dev, timed=True)
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
                 'synth3_d1_b8': 'extract_strip_kernel',
                 'synthcs_b4': 'extract_strip_kernel',
                 'synthcs_d1_b4': 'extract_strip_kernel',
                 'cvppp_b5': 'extract_tiled_kernel',
                 'cvppp_d1_b5': 'extract_tiled_kernel',
                 'kitti_b2': 'extract_strip_kernel',
                 'kitti_d1_b2': 'extract_strip_kernel',
                 'cityscapes_b2': 'extract_strip_kernel',
                 'cityscapes_d1_b2': 'extract_strip_kernel'}
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

  # The synthcs pipeline's training run as users launch it, all its stages
  # in one process: after the other phases, which run as they did without
  # it.
  synthcs, failures = synthcs_pipeline_phase(torch, gk, dev, bit_equal=all(
      checks[name]['synthcs_b4']['max_abs_err'] == 0 for name in checks))
  emit('synthcs_pipeline', nvidia_smi=name_power, failures=failures,
       **synthcs)
  if failures:
    raise AssertionError(f'synthcs_pipeline gates: {failures}')

  # The weights.h5 files: the committed ones read, the flagship's committed
  # start and its ft2 finetune; after the other phases, which run as they
  # did without it.
  t0 = time.time()
  weights, failures = weights_h5_phase(torch, gk, dev)
  emit('weights_h5', nvidia_smi=name_power, failures=failures,
       phase_seconds=time.time() - t0, **weights)
  if failures:
    raise AssertionError(f'weights_h5 gates: {failures}')

  # The H5 datasets' pipelines as users launch them, on layout fixtures
  # built here at the datasets' raw sizes: after the other phases, which
  # run as they did without them.
  h5_runs = {}
  for dataset in ('cvppp', 'kitti', 'cityscapes'):
    h5_runs[dataset], failures = h5_pipeline_phase(torch, gk, dev, dataset)
    emit(f'{dataset}_pipeline', nvidia_smi=name_power, failures=failures,
         **h5_runs[dataset])
    if failures:
      raise AssertionError(f'{dataset}_pipeline gates: {failures}')
  # The count calibration of the flagship, then the fg eval and the
  # foreground eval of the synth3 checkpoints, as users run them: after
  # the other phases, which run as they did without them.
  t0 = time.time()
  calibrate, failures = calibrate_phase(torch, gk, dev,
                                        evals['limits']['sbd_max_abs_diff'])
  emit('calibrate', nvidia_smi=name_power, failures=failures,
       phase_seconds=time.time() - t0, **calibrate)
  if failures:
    raise AssertionError(f'calibrate gates: {failures}')
  t0 = time.time()
  fg_eval, failures = fg_eval_phase(torch, gk, dev)
  emit('fg_eval', nvidia_smi=name_power, failures=failures,
       phase_seconds=time.time() - t0, **fg_eval)
  if failures:
    raise AssertionError(f'fg_eval gates: {failures}')
  weights_forward = {k: weights['launches']['launches'][k]
                     - weights['launches']['backward_launches'][k]
                     for k in checks}

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
            'bf16_train': bf16_launches['train_forward'][name],
            'weights_h5': weights_forward[name],
            'calibrate': calibrate['launches'][name]}),
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
    n = fg_eval['foreground_eval_launches']['launches'][name]
    if n and not backward:
      by_path['fg_eval_foreground_eval'] = n
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
  # The synthcs pipeline at b4, 256x512: the box and full stages' runs
  # (their steps and valid and trainval passes), the eval and ap stages
  # after them, and the eval and ap stages on the ground truth's maps.
  def synthcs_launches(name, backward):
    by_path = {}
    for label, counts in (('box', synthcs['box']['run_launches']),
                          ('full', synthcs['full']['run_launches']),
                          ('eval_ap', synthcs['eval_ap_pixel_launches']),
                          ('oracle_eval_ap', synthcs['oracle_launches'])):
      n = counts['backward_launches'][name]
      if not backward:
        n = counts['launches'][name] - n
      if n:
        by_path[f'synthcs_pipeline_{label}'] = n
    return by_path
  for name in checks:
    table.append(row(name, checks[name]['synthcs_b4'], 'forward, synthcs '
                     'pipeline, ' + shape(name, synthcs_train_dims[name]),
                     synthcs_launches(name, False)))
  table.append(row('glimpse_extract',
                   checks['glimpse_extract']['synthcs_d1_b4'],
                   BACKWARD_USES['glimpse_extract'] + ', synthcs pipeline '
                   '(full), ' + shape('glimpse_extract',
                                      synthcs_train_dims['synthcs_d1_b4']),
                   synthcs_launches('glimpse_extract', True)))
  # The H5 datasets' pipelines: each stage run's forward and backward
  # launches and the eval stage's, at the shape of that stage's batch.
  for (name, key), dims in h5_dims.items():
    dataset, backward = key.split('_')[0], '_d1_' in key
    res = h5_runs[dataset]
    # KITTI's box pastes at b5, its full model at b2; CVPPP's both at b5;
    # Cityscapes' box at b4, its full model at b2.
    stages = {'cvppp_b5': ['box', 'full'], 'kitti_b2': ['full'],
              'kitti_b5': ['box'], 'cityscapes_b2': ['full'],
              'cityscapes_b4': ['box']}[key] if name == 'glimpse_paste' else [
                  'full']
    by_path = {}
    for label in stages:
      counts = res[label]['run_launches']
      n = counts['backward_launches'][name]
      n = n if backward else counts['launches'][name] - n
      if n:
        by_path[f'{dataset}_pipeline_{label}'] = n
    # After the last training run: the eval stage's forwards, Cityscapes'
    # full pack's.
    if not backward and key not in ('kitti_b5', 'cityscapes_b4'):
      n = res['eval_launches']['launches'][name]
      if n:
        label = 'full_pack' if dataset == 'cityscapes' else 'eval'
        by_path[f'{dataset}_pipeline_{label}'] = n
    use = (BACKWARD_USES[name] if backward else 'forward') + (
        f', {dataset} pipeline, ' + shape(name, dims))
    table.append(row(name, checks[name][key], use, by_path))
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
        ('bf16_train', bf16_launches['train_backward'][name]),
        ('weights_h5', weights['launches']['backward_launches'][name]))
               if v}
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


# SHA-256 (``sha256_of``: dtype, shape and bytes) of every dataset of
# results/box_model_synth-20260816104712/weights.h5 as h5py reads it, for
# phase weights_h5 on a machine without h5py.  Made with
#   with h5py.File(path) as f:
#     print('\n'.join(f'{k} {sha256_of(np.asarray(f[k][()]))}'
#                      for k in sorted(f)))
FLAGSHIP_BOX_SHA256 = """
ctrl_cnn_0_0_beta c4a1232f3d213c9b68a3b76cf19e473fa91de2171d40bf4bee876a133532d581
ctrl_cnn_0_0_ema_mean 4cc6575f30bdacb7d3330a2b0766bd8f5f810ae8654098ee0f64087451a681fb
ctrl_cnn_0_0_ema_var 96edb092bb00da1af425a20da8ec001925e6dd37210552522ede6ff24c8d97e5
ctrl_cnn_0_0_gamma 78c84795efeba439a0f37bf0aee5c8f3379e9c869cbc44cdf6a4cf760d36f714
ctrl_cnn_0_10_beta 487f0c8f82e30618c170bc8ee7311d022a4049e9d0cf98a647f873b8d25584ca
ctrl_cnn_0_10_ema_mean f7aad7f948fe2bc629d59cd89c2e6905425778dc62fda91bc5b02cb37ca5962d
ctrl_cnn_0_10_ema_var 9bc953bd504d8b194a5bd764e5acb51ad5fe00b3691e6ddef71219431e11aeec
ctrl_cnn_0_10_gamma 1aa4d73709653eb0e99755bdff8cba2650e19b0bdcccf11ad6d7f7e64524c7b7
ctrl_cnn_0_11_beta 6a9c21e0694a853be4190b57144b37e8648bdc20b1ababdb09f81947d119c7f4
ctrl_cnn_0_11_ema_mean 83b091b230b2276c1ac944f7bdf36c7efa403c5e1a03b0b7519c0b4a88438bb0
ctrl_cnn_0_11_ema_var d5ed16d39b7fcba967e05b689ab15c7c13a4b87703c6446a043342fc54c0112e
ctrl_cnn_0_11_gamma f8b5350af10f65ec4d547a3e171e26690007f677efd8df493d2f446718485b26
ctrl_cnn_0_12_beta 1d7673bd379198995989e248572c0a7751519c57c7d09498b9d9379bb9cfb6ed
ctrl_cnn_0_12_ema_mean f63c1b128495d370a66b8d884dd6eaf5c8cbc6a17b39fdb5a359aa68556d40d3
ctrl_cnn_0_12_ema_var 6804c4c8f3d06dc3cf3d5e527d92e7644577d16ea46226556166cda1b6f49a3d
ctrl_cnn_0_12_gamma 333022fb11424347bf8ee2c4d8de461aad0c7626eb0b635bfd3c4d7a62c9e70c
ctrl_cnn_0_13_beta 6c38351232dd02e020c2468d8095273772ab62cfb6afe653865c57fc6d1d4a9f
ctrl_cnn_0_13_ema_mean ffc7d0b237eab6bcedae93220eff86b32944d5c05b9aad17a625014f58394e06
ctrl_cnn_0_13_ema_var 0923ae3fbe622f93c8a14ed972918abc738f7cb1aef9e4ef8ee7c26a16ea6aee
ctrl_cnn_0_13_gamma 3bca93925c5e617100750de16241b46a3f3ab12499f5999d94a0d41877b93db7
ctrl_cnn_0_14_beta 8647ee34a50c68aa992ce33401a81fb91820d4f45df6b3a9bdcb7a71436077e3
ctrl_cnn_0_14_ema_mean 99d63827bc5559b6aff05038b6e4aa25457932c21d6f5efb06959fd99eb59b11
ctrl_cnn_0_14_ema_var 655d4c766e82c33885ee15521521790824b099437f63b03a1f702c9a652eb181
ctrl_cnn_0_14_gamma 209fb6a0887b6c50d46a0256d742a2d497d6688e11aeed6f5af3097d22b34897
ctrl_cnn_0_15_beta 8bc5c1d16946fa282f0a9179bb0defc258c93cdc61eec3baca536cb16506819e
ctrl_cnn_0_15_ema_mean 89a825741140b1345397477fc72692218e942506965caf4a456b9df0a34d7b6b
ctrl_cnn_0_15_ema_var 980ed3ce83dafabdde4930ee81705fbce3477a1f406646b00eda1b9ebb7a5114
ctrl_cnn_0_15_gamma a70e3c5bb8ef82c11621b349292e82e8326e911cad4f78651cab48b6922122ac
ctrl_cnn_0_16_beta ff21f161772ca4aa7c85dec23598d5365f5664ebad448c1edbe1717547c8a0fa
ctrl_cnn_0_16_ema_mean 31afa904fda7769c8c0e0e2f304f30fb42943acb24a8868b7e83b90cd76663d6
ctrl_cnn_0_16_ema_var 42a4a453bf7588536f74213b99369033fee3391b1d74cfda864336a633cca92f
ctrl_cnn_0_16_gamma 1bb9ddbe284bf032921a4f827a31fc719b7bdd5fc9c355cdd24bedbf84234883
ctrl_cnn_0_17_beta 66f24a3653d2a95fc0df33fa234e3acf7f8c5d0e9a81fb6e7c9e5e7c7dbcb771
ctrl_cnn_0_17_ema_mean f22090ad839a3cc79f69ffd0b65b3d6bfa8e0784605e63a7502d119269e68bad
ctrl_cnn_0_17_ema_var 5aa78f2b96ad9e364da88885538d03ef12309cdd1897dbd3cace2f3c5c1176bd
ctrl_cnn_0_17_gamma b5f268f7f07f35c66fcd0df3534a0a92ba336af363617f7ba64b993d1c3a58e3
ctrl_cnn_0_18_beta f3dee44940debfb781b5f5c4e260a531515f747a5ca7892593a8c603d3fb7700
ctrl_cnn_0_18_ema_mean d286c89a1779caf11a419f43f97b98e35e6e3af190051ec085f7d8f08ee3b062
ctrl_cnn_0_18_ema_var d3c3f9ddfcfe52fceb56dd053b14e17d701e673ee172dabbeaafd6a9929bc562
ctrl_cnn_0_18_gamma 92466eb73baa4deb28107bec985a22c12f9a46ae04e3a46eaf5a6610b5e52157
ctrl_cnn_0_19_beta 986a1bef61e40bcd1e8b7b103c4300b3189493ffdf7ad9e7ef88f2d90e1e53ce
ctrl_cnn_0_19_ema_mean 697dc536e0a795320cbb9c005b4a90167f2c14bca97b83fa152cd9c5601e85ad
ctrl_cnn_0_19_ema_var ddf05d74730791d718764367bfe44c38dffaf5b0941d82cdf76c706587091979
ctrl_cnn_0_19_gamma 67d8d7d5bbde4a74789e5a70ec161ff9d8e228e508150e5dac1f7a842cd6e3c3
ctrl_cnn_0_1_beta ef4b44e5b2006300743d68a7e123eb6201264ef75294c8431082792cfea570dc
ctrl_cnn_0_1_ema_mean 80b6a1b4a4e40db47c2fc44cc9ab93e3e89c9f85cd574ab398f607bf3eb33329
ctrl_cnn_0_1_ema_var db7250b09b81bb8ae48a9ee98619c35e1f634ea7917f5d5e0f06b51d4bf757f4
ctrl_cnn_0_1_gamma ed3d0d4bb5fcb3e2f0fbce79a6ba6be4f9b352a7e79a02faeaf6564ea08209e6
ctrl_cnn_0_20_beta bca3c91d11da0451be0eac6fcf4f85d4c4795f051d69f435022b9ed7c4c89c48
ctrl_cnn_0_20_ema_mean 15105e66c5c510e4a4f059d1970e8897193488f519c478e1682bb7f74958d110
ctrl_cnn_0_20_ema_var 1fcc4d6415e2ae868c3589bb9d78c3cdaf7510f5a34e4ac3834ed04c5a1a97c9
ctrl_cnn_0_20_gamma a7a5f3635538801a2b818cdf6fe961af77619674dd4de4a13f794c067b219697
ctrl_cnn_0_2_beta 3123b5aa11cd4fa269ecf1d8df15f67018f52e34047b10d69fef44768fc06ef0
ctrl_cnn_0_2_ema_mean a8e531906d18b5b327c743ab1a5a2387b8654146433b49987612e3469a324eb8
ctrl_cnn_0_2_ema_var a37200139395ae06626325faf7b4ea6786698ed32850733165c7b5acd6670f59
ctrl_cnn_0_2_gamma 414fbbc20732cc3ccadcc0804ea1d5d7ca8d62695eb8c3b918ec0ba4ed37d554
ctrl_cnn_0_3_beta 0a8965c60e4c723f6fa1147ed2fb12519b259fe10f2f5ec6d131bed9d3844448
ctrl_cnn_0_3_ema_mean e60fc9587e2d3b335b457c2d1c4691fcccc6ef3244b853bc0e9f771003149515
ctrl_cnn_0_3_ema_var 456a275d6a80d5688f906f098836fe0fcccee624cc6a863dfc565929aa2947f6
ctrl_cnn_0_3_gamma 8d26e2382128d4c1af411f357bc7e98ee0d812d4c8c87664c2aa1736fec54a90
ctrl_cnn_0_4_beta 1c135315badd831578dacfaa7953c89d90022263126e6f5b2d0d6c12da98f286
ctrl_cnn_0_4_ema_mean d2372df59adbb33f1dcd9e3db7b085b2a24751b514bbda9a083e18a4afba698a
ctrl_cnn_0_4_ema_var 5930b9c56a654d0a099f8ff822c858f84c29a0773c3cf808a2763cee5111d7b8
ctrl_cnn_0_4_gamma 8166b26552e5c4d8203878ab78bbdbeb5c4542f780f135d3ddf9b6e3033467f0
ctrl_cnn_0_5_beta 053b6a068b24b940e731277500855c1facd6b87591c9d08bb8796cf13eee640b
ctrl_cnn_0_5_ema_mean 4f3f163dd9bf0f9e45fdfc79bbbd6a6ff1e1acd6c0ab91c154fa5db5bbe76b24
ctrl_cnn_0_5_ema_var 9a3c12bc9cd0bde8a89958771307a631a059ac4296acb3733e19477e4bf5d799
ctrl_cnn_0_5_gamma 448d0ffe1e08b3a39fa238880713969644c9c67981f834f2dcd7354d6cd5b270
ctrl_cnn_0_6_beta c5b42365a9e405d018559bb6e1af67f16d01c26530e82aba1a29240775f2af00
ctrl_cnn_0_6_ema_mean 69b38528d1d3bee5d8b9f5d25d8f3e97fa502bfc03ac5c4b21b0e42185fe6cc7
ctrl_cnn_0_6_ema_var 823d1f357afd8ac9b1c07c71f6e5b5185f4e68f492b64dd6b57e0da86201f034
ctrl_cnn_0_6_gamma efc13fda05a8650f627b8be5191340a29cdde146b53d9a5b6b3fd211b822eb23
ctrl_cnn_0_7_beta 4a5258b6cfc5bc03b06b122c521830d27c7665180e774190d0e458ae0546b38e
ctrl_cnn_0_7_ema_mean b9044b0ac99df932316e8fa69171b02aed46ac427a1d30e5de1e1917b168ddc5
ctrl_cnn_0_7_ema_var 30be43905e120cccfb27a0da207b0290606e8e105c457861ad069f587934ae85
ctrl_cnn_0_7_gamma 48d6dd34f854a211f34c3792fd80ff28e9b26349bdd0e64cc7ec68021d638f4e
ctrl_cnn_0_8_beta fb21a02bf1d55d42a9c7c66f385533500f0044584110ac844da008f2ecf088a4
ctrl_cnn_0_8_ema_mean 9855e9727c8e37f35158736650d8cd4cffccaee01c324fe2de630a4aa670ef8c
ctrl_cnn_0_8_ema_var 08540d1744bbdc2910e5bb82182dc481af79f643dc945b76a48edaefee792de3
ctrl_cnn_0_8_gamma c0c00d463f2c48e2180ddf3f857e795d427899da26b6b992cd8a214ec98a8e34
ctrl_cnn_0_9_beta d0d63dd34dff03a22e5e6cea9101cc83142686e328a2869cc400a3db0dabb71c
ctrl_cnn_0_9_ema_mean 35f584b9e69760c2f1a86005712f94136e488230b896a7ce554b324f31daadef
ctrl_cnn_0_9_ema_var 7486d46ad0ca77cd0209d2280ff4258c02560942568d1dc523d066ae745f471e
ctrl_cnn_0_9_gamma e68394ce5c66f255e4591f6f27fd1a5654d16bec1b2ee3f77891a53da281b3f6
ctrl_cnn_1_0_beta 01557757c85a86fd0955f945d6781a5063750844175d2566d8254b717da5ecf2
ctrl_cnn_1_0_ema_mean 5e63a0363d9dfbb9fe78fc3195db143194208d49a8570682b2994848269a67e3
ctrl_cnn_1_0_ema_var 45f3cfb807459af3706b9fe921c98b6f5d882f890f8ecc2ffaa60cde991d1b9a
ctrl_cnn_1_0_gamma 1234e49f3e721a5e983c4694d9bfc295774350110b17d7e85885eb643315157b
ctrl_cnn_1_10_beta e5a8c6d1c4d810288fe6ed836913ec3b20810c8ce657ea08e868b04a0bfa7e97
ctrl_cnn_1_10_ema_mean 903cbcc2ffda8718370f29893e8f5c1dc2f82d1db5103d32cd8db153bba4249c
ctrl_cnn_1_10_ema_var 69b99fa4deac1bf258475e8fb3cdad220b7d416d78253427923f18f620af919e
ctrl_cnn_1_10_gamma 014adaf8e836a6b043c239ef146fc56552141a13c1bd2046033520907a7c5613
ctrl_cnn_1_11_beta 90ebb1f192cbb33d834cba178c1e73186a7236d611143f050d885d7d048ea0d8
ctrl_cnn_1_11_ema_mean 4c90434d9e6c720891a514cc25d4cbede31cec34aa6d23fb782dcd5e05ec9223
ctrl_cnn_1_11_ema_var b0ccd23ee337f305d61bfcad13c4302a3d98b3dcd6b604fa0806a88d6fbddb47
ctrl_cnn_1_11_gamma 12a410fa9b5fc2db88cc7af04be1c87ff97e86289064bec2dc42a0008722638d
ctrl_cnn_1_12_beta 57e01b84d359c37c9b7f7331f934a15d47b2ae5b7dc1cb748d0d4789c63e054b
ctrl_cnn_1_12_ema_mean 74b946ec2ebc6144d4b13b117dd436f8cb79a8b2a1b7de9a5066c6a7c792a033
ctrl_cnn_1_12_ema_var 1462a2a2723481944b5cf5c0b30cd45995b5a1d6bb078110d2fb46d2fa78bc7e
ctrl_cnn_1_12_gamma 692d6e51db6b33273213776b8924f8dba2f077287d13ad3a87a639a5426743cf
ctrl_cnn_1_13_beta bad529b4b8f9584c9de8b5941da2cf0122d29747fbed907ce296729745e74eca
ctrl_cnn_1_13_ema_mean 3cd5cd7f9c43ec1c550ca33730ea72699306f0c433ef61d83bf38ebd45250346
ctrl_cnn_1_13_ema_var d62b01f01bda394863e312ebd613c0e8a43ac081ffaca6627c68a6e97c372230
ctrl_cnn_1_13_gamma 44cf0a6e616d3a4c21a43b3503ed419f5d64be3d8f274d86a32ff2cc244216f1
ctrl_cnn_1_14_beta e5752e07033ae97bf8bfde0df59bde8f9c07c2db45b0a5557731ce7901d5dd10
ctrl_cnn_1_14_ema_mean b0121d4b86f67a57dcb5d77cb29092d962e151e0d0e23d351f7b48999eab569a
ctrl_cnn_1_14_ema_var 31ed31a6135704c6c3dbc58c4864d5f491a0e9aa20eed00227e63d50f07af199
ctrl_cnn_1_14_gamma 6176ba5822c6f7acf1db3ac57494fe2134464a25c4c9c8249db4de305f3846d9
ctrl_cnn_1_15_beta e21c080e02e7760e51f443074e1ed600b2ca6e597c84d8b2bb660aee2f060872
ctrl_cnn_1_15_ema_mean 01a11ffbe16f593ab356f7ce500000721cbd24d35753761b7ad4566dd3b78257
ctrl_cnn_1_15_ema_var 2ff175803a37d245973ed15f5ed47294ead86e2c954c73ff10cb60dc62d0798d
ctrl_cnn_1_15_gamma 1c46997bb4e39d3d0906b7ee1883761cd63026ca8dc539ff709b19cb7c55f35d
ctrl_cnn_1_16_beta bddc85c90bbdb821cbd88bb15ab0fdc6da189b9797cc6869488aedbbcfe370ae
ctrl_cnn_1_16_ema_mean 47be0db8741f59cf589ce9e1cf015a08efa6ec9b22e9667da011f4042ad7e8bb
ctrl_cnn_1_16_ema_var e4d6d150072ce4de3876e0fb250815bc449f4cd2ddb00b037ef525a4596487e5
ctrl_cnn_1_16_gamma e9576527f163070f696975d14cf3634d5dbc80bd4ab53fb50c84750ca7f327c0
ctrl_cnn_1_17_beta 6e4e6a19b55887ae94400d60e36682362f8d21080b13bb8b6a5164405cc1679d
ctrl_cnn_1_17_ema_mean 67b26d98921b55b110974f740f4bb90a71bc993eab65ca05d9397d20f77d89ea
ctrl_cnn_1_17_ema_var 943b1cb4216a2162e5da535ea307ff1d87dd995f8e2b58c36865f149c858bd38
ctrl_cnn_1_17_gamma 86f422c070b615396dc1bf3897c509b8738f26fb5e05ef8a6ed2f96e9f66ae88
ctrl_cnn_1_18_beta 58b222293758bc8c60ac3dd8e4d80844da8c2b5d004700f058e67c4e5937576a
ctrl_cnn_1_18_ema_mean e7e1464d7219b0d741f699591338cbc4e2d760a15ef651b2d69561551a5d187e
ctrl_cnn_1_18_ema_var 7ce1321b99557feed3834139c5679d95e7b48a09aeaee7acfef6c60112d2b14e
ctrl_cnn_1_18_gamma 91135819baf4a4d3e4ba324a40b7ac02032a5cb440a0a29e1c832f972207db79
ctrl_cnn_1_19_beta 0a50b5946b96e9107e3a4543da41372a1edd41a9b1a07de2cef51d4c6a2d00a6
ctrl_cnn_1_19_ema_mean e4190d31f86157cde3d45c3d0c5ff6939aa71e78f3d64e177fc8b5d59431a01c
ctrl_cnn_1_19_ema_var a5b665552b3736fc37b79efcba19e6cda150558f461ffcdc80f4aa33f83c6c64
ctrl_cnn_1_19_gamma bffd09045613a5ef7249685d0a58019db1fbe650135ff2c391c0b13868ae646f
ctrl_cnn_1_1_beta 98f553422dac04841d4ddc306618fd04324e182e571248c89da41d99e927b739
ctrl_cnn_1_1_ema_mean 163c10df94cf74e7eacbedab5d9e66914237141897eeab2cbb7728959628c80a
ctrl_cnn_1_1_ema_var 1bec30240636e5628a5e5c0bb6970e3b717857b409d527adcbb480c5539137bb
ctrl_cnn_1_1_gamma ce9ffecf9c93f87693f4d0dca6a2661b645b01bdbd5b1b298090ade3f2d66de3
ctrl_cnn_1_20_beta f9dd8969daf340743e2d06edb88411b4e70629865a1d133fea28bc8b41dd6e32
ctrl_cnn_1_20_ema_mean 618a3889425b23c4dd322bfddcdd2c21c9df8dad94bc5181d637ff71cfb16d47
ctrl_cnn_1_20_ema_var 1db71dacc0451196d0ae64faff533134a45bed6526969ff849da67ce904258e3
ctrl_cnn_1_20_gamma ab51c58bb4c16a73cfe90182bc24d6215bce3cb9723614023e2f9c4f2c21bf70
ctrl_cnn_1_2_beta b8464014847f92caeb83004e0e35b72c997dc78b1a678bd19f56b357937b32b1
ctrl_cnn_1_2_ema_mean 6a0e512bb5106687713978886cb8e3a875759957ed4ca1c805fabc7517099422
ctrl_cnn_1_2_ema_var 30e0baf30b1ff9b5dfaee1e7a87f3fc8e7325fe15127a4631e8c6abb93a6fbcf
ctrl_cnn_1_2_gamma 76955e74641d259635125eef998257f84803f9d2f381898af3b9a2e81e38e9b1
ctrl_cnn_1_3_beta 535dc2ade25eee5c55800cdeb1d1007b272ff11297583143db43f22d975fa257
ctrl_cnn_1_3_ema_mean 3155c4212c1358d8f1c688c9e5f88c6b81af40ef44696932f392f53a0a78ec7a
ctrl_cnn_1_3_ema_var 18f4bf85acf261022d3fcf6fa8218a8bc67f831f708a40322c7b85c36a86bbcc
ctrl_cnn_1_3_gamma b57e568851a4cbc57aed3b86a1ff3cfc66d3c28e1af674dc80e845bd536704aa
ctrl_cnn_1_4_beta 026750b045085d2205f600d226e05239fc2f98590d08530ab67f9c464834cdf0
ctrl_cnn_1_4_ema_mean 8f8b6c92455f3d794f263cdb6870c68eba478b8322bf19adfe6dc1deb7d86a0d
ctrl_cnn_1_4_ema_var 8adb7da230db9cfcce14eb307e0da478efc86d16018eba95c295566ed99e3e72
ctrl_cnn_1_4_gamma a4adef10e12dbaf0d96b7b4a00640feaa0efcef523acee74717d87c41dcaedc1
ctrl_cnn_1_5_beta 005b77a5876230ac787168578c25fbafa8e3a69e3e1183ae8d4642d22f85d0d9
ctrl_cnn_1_5_ema_mean e46a95c7d0b7f8c17bd0863a08daa0d92fb5e52a2df288d077aaf113764d7823
ctrl_cnn_1_5_ema_var ddc264d829df2976e6bfeac5ab95c30bf23a3b246143795b81f1e81dba41bbb9
ctrl_cnn_1_5_gamma a5e71b6df92adb5fe75998e5a17b71c46c71dfe880b3f2b0ad7d5ec0d42c440e
ctrl_cnn_1_6_beta 41b71907776ccb4e39d6d272916ba90236883c8a09a1ad8040611ca9225ef768
ctrl_cnn_1_6_ema_mean 740df2c07fcc4db033932e37e5a4a96fe36a477d693e80de5467aa0f975a8282
ctrl_cnn_1_6_ema_var dbbe6472c44fe5bc4f17727929fa8fb3f6cc56e357caa07996a1570cc0ddfdb4
ctrl_cnn_1_6_gamma a50c9b2ddfe9e45f030fa4ff8ddf41e403efb2dd7c372ea8141a63291af60fe9
ctrl_cnn_1_7_beta 18cd6ccc3feb1d42f0cc3805178ca5a0c841422d83297f1a6a09815c606fe439
ctrl_cnn_1_7_ema_mean 8e9ae3aa4f05625f3bacae33c2687810996c0192c3984ec21c914ed3b3dc1e41
ctrl_cnn_1_7_ema_var cb34227d14457c35a7eaa9b7d162a0435addf2802d2078828190b68fa09a0f07
ctrl_cnn_1_7_gamma cf5c7d2d8bb663e38da037120015fc019c4a28e5af427463680d251b493c4f8f
ctrl_cnn_1_8_beta 6070901b468432e48127d2a647b2bc65fa80c118bd28e600ea512f8f806a53dc
ctrl_cnn_1_8_ema_mean 98129450cdd7f21b77cfde06d843b7c0eb2daabcec6f2245ef89ea1aecd01372
ctrl_cnn_1_8_ema_var 39a1aa481d9f70348a26d756e9f1a35933adf3552cc1e9377ac8ceacdae68a0d
ctrl_cnn_1_8_gamma 7f5820db89a006dc45f5b7813094c08f69ca7512d09d7bef0e1c19ec769dad82
ctrl_cnn_1_9_beta 629f36c0cc8f4cec4a461b771cf16c3e7b595fc1f2cac8345feb7afe3756cebf
ctrl_cnn_1_9_ema_mean ae21dc655c8e0af428a5b7bfe0278455f6ec49258018b36cc8b3be903a3b43b5
ctrl_cnn_1_9_ema_var 8f6b98130b9adbfe70f14fcffe3ca4e01115fc70ad51abfc9e3d03123c5cfda6
ctrl_cnn_1_9_gamma 9a33f6a958b5d59b06198dba82cb9b4e93e7874cb3a48669649b72b7e6a19796
ctrl_cnn_2_0_beta 46f9ff589dc4fcef30e768c76e8551db6432471eacaf7f6a6411a37a86768a25
ctrl_cnn_2_0_ema_mean a74f2ac292749a65f8af33237068c946d71c93ad416dc893a639566cd86f9824
ctrl_cnn_2_0_ema_var 26f1336f74438bd45aca6fdaa4c222d0f2d363e81de320d7b3659e1eac3eed27
ctrl_cnn_2_0_gamma 297487efab46950aa436e959ee5eeffb4823f9e4e3d727cf521b40a1e02a0002
ctrl_cnn_2_10_beta ff78b1b50fe38368c8e2832358227ccb515881035fc11e49f0ba5e57d0b2c89e
ctrl_cnn_2_10_ema_mean 46b9fa05a4327b3e657fcd8067d57b0db1df52c9ba7b3e044032b1fba6720117
ctrl_cnn_2_10_ema_var 3a2ae5f6f8032703194cf919b32fc5cb91bd6b2699dc470e9a6e08d5973a797e
ctrl_cnn_2_10_gamma 42441256057b4a065307681b223be173abec459c4f7194599610438899d63ecc
ctrl_cnn_2_11_beta 9b4867eff45833df5fe223c927b31ce9cdd900e444ec7ed105bef04a4c06240f
ctrl_cnn_2_11_ema_mean e9e800cabcdda59cd17c4b6ad4041a87ee651481aca6a964ff12c589b97adf5a
ctrl_cnn_2_11_ema_var 5c7f0cc07f3842cd5f95333cc871c16e1db2cb17a691145b668d4db039d1c85b
ctrl_cnn_2_11_gamma f76f3218ac5e6390d2bf9b358a2f4682bd3a4ae2b9ca8da4cbd504385f1e4b83
ctrl_cnn_2_12_beta 6f892e99f7cb1cccfd900053ff3d901e3f73872716cff9fbf6cde86a28f17f09
ctrl_cnn_2_12_ema_mean 874360b428b0990baf67142fec64f29e7bf2a32560fa59b5d8b217ddf5a337d9
ctrl_cnn_2_12_ema_var 6119fbc9be511b011c63d289a2b75f48332a6a7304004ee91a39c7b35ac2b7cb
ctrl_cnn_2_12_gamma 0f4d436dd8384b707377218940f0b5e6db90e6345f954cddf4412bdb1f8a9374
ctrl_cnn_2_13_beta 761326c3324fca0dd90899781297827bfe612ca83590cc64ade4da100d1019c1
ctrl_cnn_2_13_ema_mean 98a27c06ae5e07c06eb8c5612817a8061feb04a06b5171ae11ca79fd3137ca58
ctrl_cnn_2_13_ema_var dea4c441dd7f7d462c82d7cab0362448fa0299a3aad354ccb883718b70366c63
ctrl_cnn_2_13_gamma 3e631abf3b62af6b94fd5425879156530b841154b7fad96e83e32a4470fefc15
ctrl_cnn_2_14_beta ef377af6729bdba6204c8d7a4b38c63301f979fbf33f1d15e9e108f2a248e2de
ctrl_cnn_2_14_ema_mean c1ffbf9bee0c191c961abaa471fe71c44873c2449764e893a4381b6b523b09b4
ctrl_cnn_2_14_ema_var bb65f1cf8e967aeccd4f95504c02a8e113d14abfe3e6f2e1a86ab9473ca92ecb
ctrl_cnn_2_14_gamma 97764c22d86dd79a6c9920667ad8afe431aa1f7d8a494da632ef0007b84ebb8a
ctrl_cnn_2_15_beta 2f37de9f44ea8247b6a18e318b07e0529b3d468c759153f0e00d59e6b19378d6
ctrl_cnn_2_15_ema_mean 889bfd511b0afdc3fe0b1ce1356d44128fdeacd5e6031294a91b8296210b2a7d
ctrl_cnn_2_15_ema_var 73dedbdfb7138286211af269ddad6826871a286ced23c2da8f33214385d157a7
ctrl_cnn_2_15_gamma 995164ef62ed0dc8e88dba71e4a7776a813870e65a158d36af88599a9e3c8766
ctrl_cnn_2_16_beta e67412b60573813976952735f1e43b6e612e5e9218950d319af5152c52f6c726
ctrl_cnn_2_16_ema_mean a87050667241853d9d87cd56dd58c7a4fe432c949a449b7025395ef897b6eb50
ctrl_cnn_2_16_ema_var 55cba1da26990b3b123cfea80b18d34c49f8f496fc8364f8d83442eacbc9a826
ctrl_cnn_2_16_gamma 11299b6c29b171f0738da17ab77610e043e8f0f3a8feecc32d7f57e735efd737
ctrl_cnn_2_17_beta 308e4f4af5242d6572e8f51b4702963bd095dfc874989c551dd29a9e4affc41a
ctrl_cnn_2_17_ema_mean f5f701c778ab05460a776b2806140addd39f0530a7208fa325044300af6a37aa
ctrl_cnn_2_17_ema_var 224e0263ae9f270a76e54690ccee50310d390e2d39bd0d58883b841da2a9a63b
ctrl_cnn_2_17_gamma edc30e7e8479b547326d940402e1bc501b370e823917c7d70cdfb32288c96787
ctrl_cnn_2_18_beta 4045fa51ded43eb170736c6063bfb01c16f1b1f3a01a05be78a5d6021959fc9c
ctrl_cnn_2_18_ema_mean 54841cf32029a1e191c831c8dd0ab7ebf1e594ba0137c67a7b5a4600d257d636
ctrl_cnn_2_18_ema_var e617f5608adc65b6ad8bcace0dda8f506840cc9f8b22e7ac522598b49013513b
ctrl_cnn_2_18_gamma 10023eaa83cc7d3aaf853ac2541d0fe1e7f0d7d9688ff385659f39893696e90d
ctrl_cnn_2_19_beta 0926df8cf15505f24aeb7c765bdb6def0f766f7e2609418f2a6e9b3adac7396b
ctrl_cnn_2_19_ema_mean 17307c64b43327759151e788aae1a5c2993429bf37492ab485cc156e675bca61
ctrl_cnn_2_19_ema_var 34a997cbb29f53e71b849ddc25df5bf8aecbdb84973ec99fd08fbec605df4a22
ctrl_cnn_2_19_gamma b7e5a7c1c9d1facbdb92eace6946ac565d034153971278ca95ce7c76f7c80995
ctrl_cnn_2_1_beta e5a0f65d1dda85605c22bc90946bd1a387ffecee2f06c6914143065cfb3ba955
ctrl_cnn_2_1_ema_mean 4a56eeb16e334c691a6746038cc0355fe1834d1aa1b5550507a77dc86ffd547a
ctrl_cnn_2_1_ema_var 75f13b4cdb5b63c0bcaa460fd9a32bc6a309f0bae2873be4711f9fdf3003bb1a
ctrl_cnn_2_1_gamma 89f04e743e9581494137e7caff7e996d492c7b7d67221761dcbd5460e5f1d836
ctrl_cnn_2_20_beta 672511d32027388b8564b116062704eda287a3bf151ebf75dbb9e0298be36af2
ctrl_cnn_2_20_ema_mean db27c5a8c2bab1257d010139cad6ba3359660d06cf9516edea8cc9af31c51d37
ctrl_cnn_2_20_ema_var 548165a33ef474c618e19e1782f6e4b30d4e906a07444beafdf2ced438e719ba
ctrl_cnn_2_20_gamma 11c4852193f45ae26f6c987105a9729552ba94f30d2a87252cf8eda3af7c5a08
ctrl_cnn_2_2_beta a7ba7979f3429f1b9d01408737b6b7a95ba715c620488e544cc8b8182b911fc4
ctrl_cnn_2_2_ema_mean a2db480bfc7ed0b111f354b5f4d34209c3d6a613a02093d92e584bc7730b2a81
ctrl_cnn_2_2_ema_var e4aec6550df2ea806c4dbb4ac4889bd96df69bddb11c26c700515645c93156c8
ctrl_cnn_2_2_gamma 0259f350cfcb5b517d6f08b3cdc2517e0219d3ff4618ac0fa93b5da3f4b0f740
ctrl_cnn_2_3_beta 91abe5065851e9e0d68b8e677a3b11f8da019b4eb3b2ef575a5eeaf6c3219689
ctrl_cnn_2_3_ema_mean 9ee5c541ed3819d8ab123744dc477e4f9070edd96b2e3792ef94ba3219c726b3
ctrl_cnn_2_3_ema_var fcb057100893580044d0062789879de477c647a7268e22c63ff834be8297105c
ctrl_cnn_2_3_gamma 37ed01fcb103586566698110d5997cdcda4c55ed5fc76d5e0c51a9c75e5b9717
ctrl_cnn_2_4_beta b67975ee65c8f4e9f50b720d124aac1ac88c7af725ea059b7531c6402e5d4977
ctrl_cnn_2_4_ema_mean 2566a64c455f47e38c09abf9c5739a9375c9cc24492eecf9e0a8f57b4549321b
ctrl_cnn_2_4_ema_var cf17acafd8bb1ee8f18d05d184c9da1d00bb6d0afb3d47a27e367b039d96a5a4
ctrl_cnn_2_4_gamma c99197a0776666fd10883b53016eed0983634fe2063bd0b8ffb6d37f04528fcb
ctrl_cnn_2_5_beta 7a12b7914998f353cbdc45db73776831f684226bddc197b2381c61a3f7ae805e
ctrl_cnn_2_5_ema_mean 3c1b59f516164caebc3a412ba26c98043bbe186db5be6b3d054a099a8ef2ec6f
ctrl_cnn_2_5_ema_var 864669308a34b6bb90619dc51bcaf3343204f18e3ebef8d3da02d6e5894cf7bc
ctrl_cnn_2_5_gamma 39c52cd6fd71d4153ba2802b67abf340e250b142352e2472d70a9894f52b63fb
ctrl_cnn_2_6_beta 3874be57edeeba9371434ee116c024d8bb3243cd0fc99eb2d2d360f352af6654
ctrl_cnn_2_6_ema_mean 0a1a18bd29094b9a2bca6272c6c1a492b1ab6b8df6a46e76913667467c7adc5f
ctrl_cnn_2_6_ema_var 43740bdbc993314af1750c2c5444dc8c7107844e155c4a1f87a96afb74738f25
ctrl_cnn_2_6_gamma fee0f805d98ca69e7813b461e291e0b171db35bc7fc31a2a902bb1d6a90a748b
ctrl_cnn_2_7_beta a130e85bcb3669866ca4e5eceff4bc66a7c02f75f0d94057a3547a97b2814a5d
ctrl_cnn_2_7_ema_mean 21287a677c6430bdeb74a550acedcd7d608447dc5ccd1f485fece270e103ea68
ctrl_cnn_2_7_ema_var e0fecb70737e9d3a05c0c3112a97e012679a165fac601a51001e766792cb896a
ctrl_cnn_2_7_gamma e0e72e308931bf79e6216b26b091b6a268ade4cd31c2130e77d758ec6f3ff54f
ctrl_cnn_2_8_beta 66816f0f99389e2f9ff99c304a2b20667eb1b0f0a0dd8c222ee0efe37e8ac894
ctrl_cnn_2_8_ema_mean 1372a69339857ce10c49bba890fcee81fcf567571c4af4093028dadcebe4a41d
ctrl_cnn_2_8_ema_var cfbac98c7fe155edff8a59528a4fe68d8eb7d58746aeedc867924e522fe0da00
ctrl_cnn_2_8_gamma ec87a019a7dd580734fedd1fc2f370885c6addeb6700297f2dc55839225193ee
ctrl_cnn_2_9_beta 07e9eea341f9f7cabd11014c5971df761866ea5240f3e62136b75682fa3d464e
ctrl_cnn_2_9_ema_mean 1b958d8c73cb9d21916f65cce952138aff9b6950b467dcaed572c1ae68685a82
ctrl_cnn_2_9_ema_var e6c0ef91e9c99369ad89c27f9d2951cd3733b4b38e98938031e22c8daa65ba3c
ctrl_cnn_2_9_gamma 6ff4049d2247b832f7a10f8733788084ea8d9ca70836d6e8e4045795939f8579
ctrl_cnn_3_0_beta 86a7b39264ef3432b6d43b5ed0de59874fd4b251e2b66e42be872f6d3acfb894
ctrl_cnn_3_0_ema_mean 3cabc84c62880f33ec209d7af6deaee0bea30eee23cf6606c5a001eef064cacc
ctrl_cnn_3_0_ema_var d3eef1ff2d2ab5bdecfcee948278f57083d2ec717be26f112b1d092f2717815e
ctrl_cnn_3_0_gamma 49aecc27479fbfc382e21d3495d3eb9a64968cac227749e9cae63b771cc92770
ctrl_cnn_3_10_beta def2a5d57dd8b9ad65b640ec4cbfe1ba5bdef85cdcfdadd3655f99184cb2f31e
ctrl_cnn_3_10_ema_mean 3e873852d786b0069e4c5f8ecd9d3308f06ecd9c8371e1af28c116ce8bc5ca1b
ctrl_cnn_3_10_ema_var 68fb608f3f09e519d3254ceaed2bfb8c1fdc179fabd6198c068d86189dcfc85c
ctrl_cnn_3_10_gamma 684fdf1ce5d4535623bc1df68edeb57615a17615359c921eaa95273055592701
ctrl_cnn_3_11_beta 92295bd2555bd3042b473219490adca3ee84751489acacffed82e766470e55d5
ctrl_cnn_3_11_ema_mean f09bfa0b9a90a6b049530d89cabd65f7f95237cf29cb5259bea3c671a2161037
ctrl_cnn_3_11_ema_var 81ba9184d98c21858ecd3417f4d9b48499b150abe3a117d7b38bd4bb46aa0e13
ctrl_cnn_3_11_gamma 82544702e0ee1c91f212a4f96197ba5b3c34d10e948fcbae8ca9f7168f5048bd
ctrl_cnn_3_12_beta 469c9c0c0d3e02df316d4a6346435797e36b5f7e39b1c1b9abb61320a3f2fa1d
ctrl_cnn_3_12_ema_mean 8e625abb218143a521fcc8c42d3cdb2c3f87d042feb253b9069326afc45bb85e
ctrl_cnn_3_12_ema_var 29492b6e578fb15b1e4eb4ecdbfc833ce4d30cd6457a1937ae8a356e933615c0
ctrl_cnn_3_12_gamma 0ac392c4fdc7f91b547d62c169a3b38d42a9bf4dc3108cb28f4b57bb110356ef
ctrl_cnn_3_13_beta 45f77bfdde3e5510e61db8c784dd779906189bf781b30532270af17b6dbdfc68
ctrl_cnn_3_13_ema_mean d428ec1615c7ddcb4d43ff2a86a1ed07f0c9f0c95eb6dfefc3a12dcae1796d4a
ctrl_cnn_3_13_ema_var 21d13457d7c3b81173cf522ff5086c9228b280257c74c8a890e23a1e51cfff40
ctrl_cnn_3_13_gamma c65756393d548457aac87a67887edb0b3e0b3d4c211def694febb839c1dfd578
ctrl_cnn_3_14_beta d61da4c3d5bdf64adb9048c139c4c7a3088bce664282eccf5235aef7517db6b9
ctrl_cnn_3_14_ema_mean 8b3e6280d7e8bea8f4d9abbd6b80f3bb8e9a4e14dbff4050bdeb8a73853af112
ctrl_cnn_3_14_ema_var 89a0ba2edaf7f73fc95c6aef70c7fc0d0bf271f36df232d7b1b22abef0868fc5
ctrl_cnn_3_14_gamma 1058499d79530014d49b9584e1e53664f0a5907f899d58c0a330ef67021c8e89
ctrl_cnn_3_15_beta 52bb5fb46f75fe09a2e8d1d77243d5f9895d8a5d51db82769378c52b6e51d166
ctrl_cnn_3_15_ema_mean 793b4b16b0559435709d9b9477d3318b56cbf56c7c1917b3ab95c1942afd8f11
ctrl_cnn_3_15_ema_var 09d19718259275518b985819f954f8b19c7441f795944e35cd7d7899a329fb45
ctrl_cnn_3_15_gamma 63d3cc97fb16abb849c81cee747f7264fc2f47a738025639518399b41b8c46dc
ctrl_cnn_3_16_beta e0e9a76e85b0ff80703c48372cc022ee2d6f188254995fc21f5ad6c586d31241
ctrl_cnn_3_16_ema_mean 62a6610ca798abbe831897bc8e7bd984f37f24b84a042a565df0fde34a79cc26
ctrl_cnn_3_16_ema_var 75d414ae213df0c2981de8462327ffcc8944a780b37824f2502c7e3848eda397
ctrl_cnn_3_16_gamma a3d49d6c79843f8e6cca6e22243d95414ff141f901f6654c8c63df465c899147
ctrl_cnn_3_17_beta 93c99da2c61a2804f8a95994b3101461b815b07eccfb7fb5b3fb859d490351af
ctrl_cnn_3_17_ema_mean ba36de84165ef641d36a1d2115655288aac2bc7304f0587cf01eb6e124f8a62c
ctrl_cnn_3_17_ema_var 5ef121816d89fb002d6ff041857b080c3e3286b06cc894dbe663f2de14480c5f
ctrl_cnn_3_17_gamma 47beeceb121a95d94a36d684faaa24409655bcfc5d6e5db836e3417a08de9c3e
ctrl_cnn_3_18_beta badef4cdc0c0721ba1c41552c91c4d8a6aa4640eefcbf632a2353813008946a2
ctrl_cnn_3_18_ema_mean 95b9afe8fdc133240b88bc43e1c38d5dabe26625bf9e666e4d47a8d5874e8545
ctrl_cnn_3_18_ema_var 6bd83bb4a7fcd1a35d9a0b27714e6c622ec0268058689bfefaeadaf4a04b3f9b
ctrl_cnn_3_18_gamma 663560f12c9a4008be4918448b58bc548ebfd6f16a7a0482c12aec0cad16e23e
ctrl_cnn_3_19_beta 0e0aca3b0165d6db1887edb7b388cd500979d777c5d139f6c736762f12d74ba7
ctrl_cnn_3_19_ema_mean a81387c52f43965b3fd1325132023cdec4487e1636a41308091855dfdc73b531
ctrl_cnn_3_19_ema_var 79d6187ce8936384fb79667a3c2c05a9ed832736da739f501b6ce27d3c47ef76
ctrl_cnn_3_19_gamma decc5f9e9489a0d7e920d8a91a0898977c63cfee6dc3cf0dbf658b73c80d9e9d
ctrl_cnn_3_1_beta 54e8292890aa002346d242510bdd3f96e96260ebf8a01ca63bc06ce058dc06c2
ctrl_cnn_3_1_ema_mean 21344c346166afd1e5bf0b7e50fabc765bd5fd2723e656d5b65bed3070229fe7
ctrl_cnn_3_1_ema_var db79f26dce87bfe311f27be07abb93554ccbd90cf640db911bee21a94eb3e81b
ctrl_cnn_3_1_gamma a193b63afbcc752d6c33afe901cd746de944e21879d143c373851ae52679d70a
ctrl_cnn_3_20_beta 3a5b21998221e4176c4551300238c33c4f40f8f6e06390572c39b4215cca6bdb
ctrl_cnn_3_20_ema_mean 665d3bfb78903127c6379b4599b6c986951fefa0663f1e5e8e8dce8ba89b67ab
ctrl_cnn_3_20_ema_var 56495f0e3de5046d3f09455bcd0f018a8c2c41c39b08fa8dbd6c3e30c52be042
ctrl_cnn_3_20_gamma 6b6d7c62fd7f9f82a1a65f2b2c197155ed5073eb21bf279f67f55c4c00046a8e
ctrl_cnn_3_2_beta 33560c97c45f783fef302cc576f05339d2fc38b9d82106be7c3f37c9e5922d4e
ctrl_cnn_3_2_ema_mean f6e8c688c2097f83b51f4f865ac5265d9221768e0e0dbd611f4b827a8bfd623d
ctrl_cnn_3_2_ema_var 6de1f35e0a765dfa4930c3a343a986bd6e00032ade276e8183bc8fd43b6a9397
ctrl_cnn_3_2_gamma 647f31419c98dd2cc9f8db8c0c9d638d517fe3efddba6967468d12fa3ba389a6
ctrl_cnn_3_3_beta a6bdbca4394893eae98e99e94771924fde1cf50faa470e24afd642f0ff07c0fb
ctrl_cnn_3_3_ema_mean d7088a89eb4a6822331d312b8311854b5818474b964bf93deaf7a843408cb290
ctrl_cnn_3_3_ema_var 4ace52596443ee8483e22636fe426731e2edb5162d736fa1c1d3e5ee7804eedb
ctrl_cnn_3_3_gamma 75f8f876162ae1f8deef43ecb5a7626e5741b95a6de5b83359fa916cf3ff9b90
ctrl_cnn_3_4_beta 30fcd565d7d9dac6b82acaa45b872133b11ac250fe83895cda7678b9ea5f752e
ctrl_cnn_3_4_ema_mean 2385eef855a73c5edf5193a603f6a8da9162501620a6c422f2ee8e8a266d6d78
ctrl_cnn_3_4_ema_var 5ef310601d9878dd20f3d8b66140513f3f3ab19e01334b708b985a9c6c0d1119
ctrl_cnn_3_4_gamma 87c6016ed175f1067915dda7793258a7c305a18eb35eec0b982281ed1d7e6421
ctrl_cnn_3_5_beta 179b81303e82e05ddbfd965589b7c6ec2204c2149e8aa98d05fa1c4f3af8373a
ctrl_cnn_3_5_ema_mean 7df72a162bf6bd5fda49972f678b3af3b033c06485918e8e89001c68fcf713e5
ctrl_cnn_3_5_ema_var 211c52a1ae18a029c53fc96d711da02acc139f2ead2eabe38717d95b91b569da
ctrl_cnn_3_5_gamma 17acd6fd17390967dd820f7ea4b80a04a2c3f9c50a78e3ea79347d3365d7751a
ctrl_cnn_3_6_beta 9e3e00d354271bde62db45489a7aff8830f0d343733def9f377f30d441bddcca
ctrl_cnn_3_6_ema_mean 9566a9f868942cc6b236e0239f0d7944a70a39b6fc9142fa079c07b2f0b18809
ctrl_cnn_3_6_ema_var 2cac2c7271e0bbfba52516baae1ee794defbdaefd8ba5b01bfdf67b96d1bc80a
ctrl_cnn_3_6_gamma db39bf41c3dd9938f6fe30a033190fd431fcc1a0ca4faf4dea23eb1787b16cd1
ctrl_cnn_3_7_beta 86978e53ddaed0cad66300d2c3f70294a191a397e7193e2c86a24f117f1b6ee9
ctrl_cnn_3_7_ema_mean f5c613dc2ba00480508cc76c83e2e9bf014ba7dc3e355d7ae36d40dd713e2a12
ctrl_cnn_3_7_ema_var 22cb99f70fd5a3e3d77544d9b85ed5c3adc9e25afa684b189be700e973ddc0e9
ctrl_cnn_3_7_gamma cbe282d8ce8e1f8da41e9571972613b9c676b252e7b189fd4a45398d1a44cf9a
ctrl_cnn_3_8_beta 419569312d262aeae3a17f6016c798cf5aeae463855adcee1c23bb460a1fc503
ctrl_cnn_3_8_ema_mean 260bb5bcac1848d5d771f6c35466c2958e11f2e1fbe14f0e928485a0a20c783e
ctrl_cnn_3_8_ema_var 6bb2a220191c8955545ce04ca894d425fed00bdb5cc8ba077fd6eedc45bd3d93
ctrl_cnn_3_8_gamma 1abe24ed5660021ecb3237c11276ef3e20eaf78c5c38d96465d1d41386d86f37
ctrl_cnn_3_9_beta cc50fe7696a94bbc1a79f216b305aa26e070a6b62cb8bad8f5563978aef84a8d
ctrl_cnn_3_9_ema_mean 99920b0036a54f72e3ba65df581274e00a762724918583826478e744c4c9b2a1
ctrl_cnn_3_9_ema_var ab8d481783affbee898a9b946a3b653984d8bb40fea0aec40e1e01e79344b74c
ctrl_cnn_3_9_gamma 048f2264f1854619bbd26f8c7ae85b62a39891bac7815d76b1cd5e67ae9f2064
ctrl_cnn_4_0_beta 44bf98ea1abba302101efdbf8d00bfa9553be5d65830914d38f8c19b7607a02d
ctrl_cnn_4_0_ema_mean 239e7a266263aeda12a711aef8cac8f60c7c1ea1be424c63680a0cff29d0d3d0
ctrl_cnn_4_0_ema_var 083065c035bc07fd0452772b0cc6393d98f91179fa294743e22f8c0aa95a7f39
ctrl_cnn_4_0_gamma ead60c95981036c4b9e8137db3bf25af97cdfe69227e37c4539b03e0d599bbf3
ctrl_cnn_4_10_beta fea596f7445ebf045ef2232512d0f25e25df475fd9a581a2463e20eb716f0f48
ctrl_cnn_4_10_ema_mean 9eb2b0ea0c0a01b83437ce126350d9eda772f3f121608d2fcdbd5f8fc3af3264
ctrl_cnn_4_10_ema_var 5128f6e28c611e222398cff9f0ac915fd57066c008af58b032b4e6184a5a1843
ctrl_cnn_4_10_gamma fce3840c58538a5a937b84f6f6a3f79b00a41d3600c25fecf6faca1dc4283a72
ctrl_cnn_4_11_beta ece57464666a8bc7ce593418eacb6c5e9c7e536cfcccbbd351cb9ac2bab48780
ctrl_cnn_4_11_ema_mean 18951887d12e737fe7fb483c5b2de59bb0360c62fc10ba35bbfa2c00bb91f9e0
ctrl_cnn_4_11_ema_var 533c042157526e5aac2dfc2db3be710464fdb31781e856e9dbfd19577a1a2867
ctrl_cnn_4_11_gamma 34d63d3ca6373035f81b82a1c5d84c618c6315ec069e7d8bb238267a607689e6
ctrl_cnn_4_12_beta 70ca1a0ec9201184bdde81bf20859b6da3f2b22dac0ba0c64f65b4ded8a36903
ctrl_cnn_4_12_ema_mean a57cbe0b2198216122c85129cbd6c6ff1b0ba66bd9aafcdb2ee2b816d952fa7e
ctrl_cnn_4_12_ema_var 04c150baadd2019f2ca8ea2e258aaf42a32cd11896d16bf6eee6ebcdb0f3db30
ctrl_cnn_4_12_gamma 006666e6b4b7a44364279ba5ee8139d5ee7a478c10496bcf0c15dd12f5adb9fe
ctrl_cnn_4_13_beta da8f1126ab76d711494ab10ecd64157c9bb0460efbbbd82c2f89d099218bad20
ctrl_cnn_4_13_ema_mean cc2e232adef698d55bf73154730a4bdfc67f6efeb83e409e013113f09baeaf54
ctrl_cnn_4_13_ema_var 8f0b784b77303963a5c634daf07d5f0a22f3e57bb108141ea04e2ddebc7480f2
ctrl_cnn_4_13_gamma f05eb4e6f037f6bdcdd9dca1e7725167efed422ffb98f463d6576d185c1be8c6
ctrl_cnn_4_14_beta 27f2bf29d896617bb6cab7c4cf8c5eb84dbe98622415714823cb94f03414392b
ctrl_cnn_4_14_ema_mean 8089f0e6243b52ed7fa29f5ad9a34e8f3a1415100d26f79dd2d4e9f6eee14dbe
ctrl_cnn_4_14_ema_var 251590be5b569bbe96dd05f748367a8bcb97c4e7f27d88c85e4370b4434402b0
ctrl_cnn_4_14_gamma 30ae3989f655023ece285719955741607e6582fe6290cc95f4b1edf3ddb69cf8
ctrl_cnn_4_15_beta 6273473d67db24ef05ab1acfcbb13c6791c001c49b599ef37a81f4014031e2ef
ctrl_cnn_4_15_ema_mean f49d78a93c4de3d63c52c16a14c4545b4bbb2305a8f8dc1db6d636a5584852e6
ctrl_cnn_4_15_ema_var 6aaaf3435406aa8178da808b10ba88b0f15c8a613e5fbe72f75a08170faf4afd
ctrl_cnn_4_15_gamma ee8bb8b8dc07150ec221f98e2ac1ed9ba39e80cd60cbfc4e98b91a89f48555ba
ctrl_cnn_4_16_beta a12760f18f26826ad2ded43a49527d763b955c61ea1c41701c01e9816a665a60
ctrl_cnn_4_16_ema_mean 26bf77265f80b9c2346b7543a666ff76e2ded6742310d1794285b9fd973850ce
ctrl_cnn_4_16_ema_var 7b87f6469a698cc7330643dbe187f6ea950c8e872d6a7295d1130a27ed2774bf
ctrl_cnn_4_16_gamma ff967d91b03b478dd050e28ff690acb39d96673e5dceb9cd9ff12fee19347062
ctrl_cnn_4_17_beta 4ea14692f45406be08417b8a41378c41089da39d019040765b9c13186ac4690c
ctrl_cnn_4_17_ema_mean ff13d757ea58a423034cc8cc4e3a532781d56cdd89c553d6347d22fdef98e153
ctrl_cnn_4_17_ema_var 09c1116df9d57ce8243d584dc6c51cf590985ad3cec3273463b0ee4e540c3c3d
ctrl_cnn_4_17_gamma c615353ad9102c521ff157205e53916a3558739e4f8baf8974fa5e5c8edc6a44
ctrl_cnn_4_18_beta d4db403b13843cc85767377ecbbb51e330cd8956c31993bf64617f2e1cbdd14d
ctrl_cnn_4_18_ema_mean d99db205ce66b81c7d70b7a732552870d86c116a30f22a85540f68221ad089a9
ctrl_cnn_4_18_ema_var 79f210cb4d8e9d85adc0c4c2d52fdc413a722b53c21baf1b8bed3f851d778b8e
ctrl_cnn_4_18_gamma 910f0f089509ac89447aed190151ea1dfcd93b3ba14dd1062438273ad7c8a397
ctrl_cnn_4_19_beta ad4826863c5d7db86fef79e84441a170cf1b81d2c81365ed1d0193316be6442e
ctrl_cnn_4_19_ema_mean bcefa14b9a7c9a38d2a20db6a5e552fc7f9fc0b9b84deba40339f4a9de8d100a
ctrl_cnn_4_19_ema_var 5c8b7585bc76248fadff2215ec8b555cbdef9ae8fee8d57bdaf88e82a8332302
ctrl_cnn_4_19_gamma f495f2dc95be7acb9c82c995c24343fc78b07314279b90b0aa3ab07229460279
ctrl_cnn_4_1_beta f92c6e6f17902d4cb616065a224e6e148e733eab5663d6c41efffbcfe74f6cf5
ctrl_cnn_4_1_ema_mean 1164634d6ab3db130e14bfc24bcb9ec3e0501688cefb3412ca037f3552e57186
ctrl_cnn_4_1_ema_var 8b69520b26085582b0d2c53f25ccc08c371f274d9a8395accaa96dd15f27c466
ctrl_cnn_4_1_gamma 0690bb526432597b964f5cb53370ecb444f97fc619a67ee51d2cd77ee2915b03
ctrl_cnn_4_20_beta cb1ffeac304367e20d01928c931baf11febdb3e6dfb34122680f572995220cfe
ctrl_cnn_4_20_ema_mean 01cf32c603ef5c7a51c8fab4410e95e320119e6ac64d09ef10f5ee7817ab96e9
ctrl_cnn_4_20_ema_var e8ec29573dc8e5c79df18d461cd8309d54336bf9be30e5416f73fac02847b3fe
ctrl_cnn_4_20_gamma 9fe9b4150fa58d3469fe1c113164eab05dd45acca3d2ad3b726eb2ca274170de
ctrl_cnn_4_2_beta 97ea0e26e1f0ce68c90360e43ddbcb5798a9a08d5af32a65f6a26b2c931a5b9e
ctrl_cnn_4_2_ema_mean 2826886fc186c14d9435afdf88ef1deb564256962640307e93dd6cb77de7bfd1
ctrl_cnn_4_2_ema_var ffea74986e37718655b9e76547a9f1d799cd4f55dd167eebc2a71ffa915d8895
ctrl_cnn_4_2_gamma 7aafc207abf7cb82761298695a0db9eb4f6fb08a571b83d61f96fce35eb36c1f
ctrl_cnn_4_3_beta 1a0e195bf7096de57919ff9983e07b851e715b1516797508936af3b225d3851c
ctrl_cnn_4_3_ema_mean 6123515eef6dcc7e59cef624300827792a76195b325abeeb2f11c72c09c95417
ctrl_cnn_4_3_ema_var d3f42bb319695b7a60c7235664e27b9bf9b05147e3fe201f29c02dbd47dfcb03
ctrl_cnn_4_3_gamma 1023842a6eb0888accfd929c3b36012673756062c380ccc39e7fcf7358461ff6
ctrl_cnn_4_4_beta 2f67c92498de22457aca95ac03f0b2f6f387fb49f67a08e38416a2729b682df4
ctrl_cnn_4_4_ema_mean d78e837476827c4fc22682cc245f9a1e4198c8cb5c86bd36c5ae7ec903b24aa3
ctrl_cnn_4_4_ema_var 2ec88e46e87551590451ddcf8db391577adefc01e4a168e692d71acf0ffa6753
ctrl_cnn_4_4_gamma 5ebc951ddc3ae38f2c8b7b0527bacb8c918d1d38940be7a8e2c637f5ed34b427
ctrl_cnn_4_5_beta 53bb5b046702b8777ce8b9d089e83eec8ab64901505c515994d5e6014eb32581
ctrl_cnn_4_5_ema_mean a4c0cb1fe2c1255b146a4c31bf7d55509b37696d5f7ac673a82b72c9492ab04a
ctrl_cnn_4_5_ema_var d996f62ed0ad8159469c2c666bf7e723dbcf38fb4f5a64bf4f1e0b8915f5020a
ctrl_cnn_4_5_gamma 8b01535c45f87b24b8838ff450e6b6fabd827b0cfe959e9aa0b20c838803fb4a
ctrl_cnn_4_6_beta 103e0920d970ab3bf2a8e4acf67962ea28f0a0b1affe8404120d23d31ee28bb5
ctrl_cnn_4_6_ema_mean b7ed69b879b9a042fcbda7d7f71d57351c0a713729f91cc804df6e59fb02bde5
ctrl_cnn_4_6_ema_var 627fcc96c5e7a44e726a4e7ae3a593c8127f97116ffea49c982afd6b0ad818a0
ctrl_cnn_4_6_gamma d2a23037d4445425fa214e0c208eafaefee730d461a2d9bbff8861c225b3738f
ctrl_cnn_4_7_beta 34697b53dfa91a2d822937f67aec5e16cae1128c9b38c70a43634d9078b78261
ctrl_cnn_4_7_ema_mean 3e7584ffedb010eac2d8ec418b71affa89546380f53532d8b573a5fcd59f92fd
ctrl_cnn_4_7_ema_var a8cb564dd2849d5ae359b3ef6a2850f359ab844319ca9e2c79e94cd85853472a
ctrl_cnn_4_7_gamma 451fb0b12627c1b2ab0ef2f7688526b3db3311d80f5fbe4d5e77a697004fb8d6
ctrl_cnn_4_8_beta 60d31c326b24a96ad91fb3448bce243cacb1f9f2c042003474a13840fb110ca2
ctrl_cnn_4_8_ema_mean 29e09a40a654e958021212b996047eb26719e153c34b5a667457a00c006aa49e
ctrl_cnn_4_8_ema_var ec8e3f620431e892eda49e28236107d791f45dde22d96d1191b318eab120c908
ctrl_cnn_4_8_gamma f11bd6a1d7e437b8af3001870599060c0013be84aa042d99dbfd15a4948ef448
ctrl_cnn_4_9_beta 599474c21f5a8e77d64d8df1c56470bf5dbfc8e806c3bf683da0365002740e67
ctrl_cnn_4_9_ema_mean b48dcf6d175669db9cc6c6c742c4bb05c22a7b8f92091373d0c447405492afea
ctrl_cnn_4_9_ema_var 3c9086e2b1e24beac6aee6d5cfdbb27cb5151db614bf81b74a76261566afac28
ctrl_cnn_4_9_gamma 93fbf9fb3291c3be2e3948e28c1880f11c52f61fa98702b5b72c8261448a5160
ctrl_cnn_5_0_beta 4a5fb02f3e24a7bfea893caa7ccb3b463b6f3e8a7d48bf5a8ea3cfa38c68fbd0
ctrl_cnn_5_0_ema_mean adfb27037a592beb7411e8c7e42770667af6710ce690171f6b4bb03dddc20064
ctrl_cnn_5_0_ema_var 083d305435baf440f41eff01119ab3f4bbb4792fa5d17706a955f7498b9d0850
ctrl_cnn_5_0_gamma 2da83df0c181c3fb6a869203c73d634bc68b4cfbd57103adbe201bc4ce59ca3e
ctrl_cnn_5_10_beta 30f058c8979441880283b48aff6c309273d549ccf0f04e0c3f523de316ac11a3
ctrl_cnn_5_10_ema_mean cf0ce16b615cdb85a6b92e36dcbc26b7d75f26ad981e7372f426a95fe1b637a1
ctrl_cnn_5_10_ema_var 8ed0c7b5648d74dd63eb5df9e4c63a4d01f2ef8a50f1f118a6bb20422bf67401
ctrl_cnn_5_10_gamma 83229178f7a291cb2953812b6cdb7bba1ba2b4aa009b25129ca500a4ec713cc3
ctrl_cnn_5_11_beta 786e9f515de1215bc5a811f4ec5601df5985040cd9e716d457b51e55dcd798ae
ctrl_cnn_5_11_ema_mean 84850be04f878b6416690cde9a68cc1c39dedec5c9e8063d95d986177e3e6f84
ctrl_cnn_5_11_ema_var 729916a57bb508409c95ddc17cdf528182079c0f934af23003a95a8922c7fd16
ctrl_cnn_5_11_gamma 01f35b6ba04b3578711a490e0c9e52c0e6f31f59b7fc50a868190392e53b9e00
ctrl_cnn_5_12_beta df6b125ee11e5d1b5a40f34fe1497f99d82e1bce00e6ef53da76fefc3daadcbe
ctrl_cnn_5_12_ema_mean c4022070f7f1a92054f1dfbbff046251da2d971717621c8eaf99a4cc3944511c
ctrl_cnn_5_12_ema_var 11c4f6e5bc6c5c4e1851904c61acee141a3752bb6ceb7cfab168223663eb1b26
ctrl_cnn_5_12_gamma 6c11dc0bacc9dc59b2559e2a4d4000c8e22d65f7d3409894975a8352b03d3852
ctrl_cnn_5_13_beta 84e9e4d6a5712bbd454f27e8161cde22109af2867763d116ad8f5a72d7aabb07
ctrl_cnn_5_13_ema_mean 16d77bd2ce2af83d8a74b18501724603e5f863e5a34ae06092c6eb8ef2185b02
ctrl_cnn_5_13_ema_var 64e7be03692a3d846653d9cc94bbaa5263f299b51c6a2126a0ab9dcc3ff619fc
ctrl_cnn_5_13_gamma cfd25fdc0659c573e109b03e0ee501d62ec39ff2740a9b73f56df164ba784867
ctrl_cnn_5_14_beta ab18370a60c9d4d1336f08f9aa938540e7cb2ed6d56641484a265bb413bfdc25
ctrl_cnn_5_14_ema_mean 395237d77cfcbbc950bc7232609c8c82d4d1794f79e9db2bf690d74e8dfc41a6
ctrl_cnn_5_14_ema_var 988602b4d54abe7d330f2ebdbdefc2cb8389e0a20bb40f87c91eee973097df8e
ctrl_cnn_5_14_gamma 57c67d3c222e87a9bac36b1fd6041037e79a501587493628745f89d604f32eed
ctrl_cnn_5_15_beta 25127c939fba5a024bb15dda1a4ad876cec35bdaf55fe9d32856377a84bc5702
ctrl_cnn_5_15_ema_mean 589e1051443e1afc57f671239e60772412dcc6257837e338e872f11c9bbc78f1
ctrl_cnn_5_15_ema_var 21380247f952f5051414f2084b97c44f2bd4b4529fd833b4a0f2907cdbb20e48
ctrl_cnn_5_15_gamma 6134fc7b4d7f72b319235942bfcf6ce1a9fff27800597c47773043f47bc62627
ctrl_cnn_5_16_beta 90b29353be2f3df282a6ee4407160f00f60b490858e17646a9b1b78f3e4b1647
ctrl_cnn_5_16_ema_mean aac0184b6edc9fdc4e625bb7bc3c9b3b036d6697a0ca02ad09802e3623f355da
ctrl_cnn_5_16_ema_var 179e2efdf5c3f8fb23d04f0719356b47cbc192990dcb6ddf002118512645fe27
ctrl_cnn_5_16_gamma 3814b663b7ab45395b8dbce18eb932b1664efb0e2b28d664cac332cdb0570674
ctrl_cnn_5_17_beta 3ab0172a732730712cf04155095595a4f8a69268a05280143853b15e2d386ffa
ctrl_cnn_5_17_ema_mean 3126b3960dfd78d712c47cc3e836dfcd25726685f8c16b6a3aff6f0094b762b4
ctrl_cnn_5_17_ema_var 3088e95d61fa04065bc8a8abb1070fa6c507f35c8600e24c4347ba9b2230b820
ctrl_cnn_5_17_gamma 4ea15bbbbfa1b90c24b28bab9bec318e1e2ad4429a37b4faefeb127ea2d9c049
ctrl_cnn_5_18_beta c9e09f461ed757648579b087057f1675768590dcbffa4b0d1ca2206bf6fa58c8
ctrl_cnn_5_18_ema_mean d0151d12e94f580666fce618ad63d5d935cfcb184b01992a6ac5bc5bb8113465
ctrl_cnn_5_18_ema_var 2ca13b188ed07f28b85ed6edc4b698c7883eb354a6e5a7f3ab2bd1f13a0b4660
ctrl_cnn_5_18_gamma 174100af9364cc70b8b5dee06553371a78dac60a9b3eb4533e986b29d8055844
ctrl_cnn_5_19_beta a692c482938299a3c8143ad6f87b9ffa3d8e81df4afcee129d64c0aa5f7ef0c0
ctrl_cnn_5_19_ema_mean 94ac46cff96dbc4a8e6f0f101b028f1e63d4ef2d0b848ec08c26651bbbb514c3
ctrl_cnn_5_19_ema_var 8ac03f9f7d1e18e4e9b938d1df1d17a45fcd55c2895c2b4a4429652ad6fdf7d4
ctrl_cnn_5_19_gamma 052ad610e12539bb2f4db0c5b5284065e7486501e3c0d077f3272f7eecfff248
ctrl_cnn_5_1_beta 4b05078b7113c0d2a2fd33fc3195e531869ad979825d0cb282842f61fb15998b
ctrl_cnn_5_1_ema_mean d4f325864fdfc142d08a4379ba44e2af0535dc8d435d7a3350294c9630ae80fc
ctrl_cnn_5_1_ema_var d6a4972390657b3f14866a638715145664de9920898a7460b9dace8daaa9d9f4
ctrl_cnn_5_1_gamma e15a1e2479ef8cc0357410c4a0ad26373defda96a96bfa99bf5e42288f9ab394
ctrl_cnn_5_20_beta a06814b37c3cf0c157af8503a39b4197cd53744f344d41a703b168eafa5411ab
ctrl_cnn_5_20_ema_mean 9146f087519343f46a145e55864114c965629e592e3d7b2ef587ab45fcd60563
ctrl_cnn_5_20_ema_var b515c8767bda93f4c4f2e6cb83ea7f8c71c43b69180a3453259d7ed2ab1fb6e9
ctrl_cnn_5_20_gamma f50ebf38c7e0249db3cd20dd5c8a14fae0254df1a1269a2adab09e7a8dd6e9a0
ctrl_cnn_5_2_beta 7810eee1a399544376a027e9edc292ece5b21d163907e0f086359e5383033c09
ctrl_cnn_5_2_ema_mean 37cc9257431db209021cdb79282322568137d949e2b67f1b7199270e84562a20
ctrl_cnn_5_2_ema_var 5fedf612afc06fc1aa8a351b4d593ef6223109c4357112c51ae3645fee74f6ef
ctrl_cnn_5_2_gamma b8bc1cada2d2283cc7af2cf52cdeb240ba88c8234cc3534e875b92c8e30e2d2d
ctrl_cnn_5_3_beta 779501cd554db2da5b48355512aeac2a136994aea20a4ef1f4d745e10114e5c6
ctrl_cnn_5_3_ema_mean 0feeb8028cb5c34380ae990f974b478c8173f0a672f853726ad7020cc3b77a23
ctrl_cnn_5_3_ema_var acc84437b65ce218d20103e60ed827aac942e8b6191ce8d8dd96b6b2c58c4f1f
ctrl_cnn_5_3_gamma 10bd5c4c192fa612e6ba96c4bda08619ff9f7c43dd483e38b456ee7eb0e06ee7
ctrl_cnn_5_4_beta 75775fa745bfd557a9e28a2e4deeb7f79a9d644bbcfee45799a1d6d651fe3322
ctrl_cnn_5_4_ema_mean 7766362fe2911189b2c9c5bac2a69292eeb5b6332d6fb24e24f5cc07a157fc96
ctrl_cnn_5_4_ema_var 97804884520226fea2d206ed69a0f95f7bf48d4860075e713400b386ba121262
ctrl_cnn_5_4_gamma f0b08ea4df687f6ffefb93063a1f71c153029b8f041d7779a2f9defd95cfa266
ctrl_cnn_5_5_beta 9a83a1e472e5490aecee2164992da1d5a46345a643d5894d954409771f2b1be0
ctrl_cnn_5_5_ema_mean 2b264b9c0a8d1f6a43c0a658f317ba175d59ef81e236d077a7b96c37dfa7b4db
ctrl_cnn_5_5_ema_var 40d62f14783876cee50aeb3b3dd841e0e0ce83ffab5142a5cfed9bba3d691e3f
ctrl_cnn_5_5_gamma 2ead2650decc8cd8961b51d2d2abbea915326648ffa5d73693885805d4c6382f
ctrl_cnn_5_6_beta 7b120c17d587e9cbb72be2e46eb3c6921522bec384fff33b00ed4664a1e045f4
ctrl_cnn_5_6_ema_mean 6d75af1a7fe1cd6a01690609153a415b129e6cc6b0c6acf9456d83bfc2fe3fda
ctrl_cnn_5_6_ema_var 133eb5dcf407f38fb0b3e5351cc36f929fe362252b4cc88de43aafb6984a4554
ctrl_cnn_5_6_gamma 52fb6f7b510d2e052f9660eb46ae16dc4a0988b6e51624ee78617901f4e55bb6
ctrl_cnn_5_7_beta 69d40134e7d5ea20ee8f8df03a341762ad5655f1ae32975238b71f428bae3897
ctrl_cnn_5_7_ema_mean bf51bd9d4f428b60031d222651c080f8f4f3f310d6b619659ab4a1f21a52d609
ctrl_cnn_5_7_ema_var 0968b95828851957afc9622a8df48ba420a6fd704092d486aab39991f4c76006
ctrl_cnn_5_7_gamma f850804c121a7c5e7a121967b5d74d8e10914b05659b23969630893fb3668abe
ctrl_cnn_5_8_beta 6e1f5cf9bd8457e3e809b358bf0d45c70304bf95c09eeb7284493bcd71ddc5a3
ctrl_cnn_5_8_ema_mean 7bac63e86ddb4b8c6b492c64a5611e647d4316f84edb3fcd60b1937d0041fb76
ctrl_cnn_5_8_ema_var bf504ef0a6b71fe9fd0330f53d70f0737ff5811cf55db910b2120213e5c2fe37
ctrl_cnn_5_8_gamma 5dd84a9774ee68166768fe8ed92b7ab28ea80537ab18cfa61f0b74471edaa615
ctrl_cnn_5_9_beta 4c9300405f6b354569182acd8758e6888a8a3d4b9a36bbad8ba98b49fa3b7ea8
ctrl_cnn_5_9_ema_mean e27dfc47388ffa0f91bd0f1ae18584295d59a2c2b68cc3ee19c04747ba589530
ctrl_cnn_5_9_ema_var 4111a3bde2e0eb0c4f9507ca22629ff00d6305a6d67b4e0f146eb4e97b42713b
ctrl_cnn_5_9_gamma 1319675e42480a9224399d874e1bfbb47b65324c988123f8ea0e0788fec41944
ctrl_cnn_6_0_beta b0ea20cd2f95d38cc49a5d67872fdc9b80190d3a1eaee8c7b6b22e04ecdd996d
ctrl_cnn_6_0_ema_mean 4b58db1691e59a55fee7c1e61ce2f464ed1a4290bcd883bd9c9b2fe4955f672f
ctrl_cnn_6_0_ema_var 569f27ecc63cbae57693e8bf1f2c7c9262db211fc3d084617cf0bfcaf370f846
ctrl_cnn_6_0_gamma c2d205ea742206eab9ea306fb194d502de73f6a8785c79ac98972201c0e9a5e0
ctrl_cnn_6_10_beta 0f8d6172f41ab6cc2e548e471debfccc95a5ee03ef4a684eb4b85e5c4ef3ffa6
ctrl_cnn_6_10_ema_mean 2bfb7fd98f3c4317e2d13ba20208416a3f8be0ea730b402a0614ed67f3a74794
ctrl_cnn_6_10_ema_var c8ed7a11fa6cadfbded71a6bfde0906976796cf5fce09282d4152d604f288a60
ctrl_cnn_6_10_gamma 8b7028726e17c465d5475da5e7cb3b7bca9790db915877b71572d3c74e5caadf
ctrl_cnn_6_11_beta d093300b25053d8d5f61dce89ce1afa2484f607db2e36fc33763438f5dd9f2ae
ctrl_cnn_6_11_ema_mean 3fb30d0cc33842675ae8569af8a8223537b4e10d31a5769ccb976af13257079f
ctrl_cnn_6_11_ema_var b39b976c1cb1f3b239e681f211075cba36bdca04d17b87867813f14e1c13f018
ctrl_cnn_6_11_gamma b7be636bef0083b033fac3beff6a1253613c451dbd561d436b698b126cdb5a4e
ctrl_cnn_6_12_beta e64ef43a0a346a4f708197df12d18b134743db8419b9047b699aae4146e2f329
ctrl_cnn_6_12_ema_mean 1a4f4b3fa5d65b811ff31478bf580fd708d60c853e13bc49ce2367c162a6ae23
ctrl_cnn_6_12_ema_var 630b836fe1f4ca4b3e3844a4a28a0cfb12871548fdfc0473f4ee1f4cb51f08ee
ctrl_cnn_6_12_gamma 1d77585a64a7498078d626dd794434b1338553cb2edc151a5c7a9d77da6c28d2
ctrl_cnn_6_13_beta cda9f4d986170efbc6c61bc602f0e96faae47a71440e0b05f59fb483aef7e46a
ctrl_cnn_6_13_ema_mean fa2ba9390c0ee0c1929d02d343ffaf5189730142a8b1fbb65eacbd95a5f1dc03
ctrl_cnn_6_13_ema_var 1d65a7053b996c17cf1d66bbf27399d0052f66e934b30a37d745324fcb6d2276
ctrl_cnn_6_13_gamma f3f3b89c7a3de443a3f9a12468858addced00f2deccedf00182d07f7af2db3e2
ctrl_cnn_6_14_beta b76a0127d16ef1f7941272f48fdc4fbc04024883c161a42298e6afee512ec427
ctrl_cnn_6_14_ema_mean 8c333988ee9aacc6699fb2cffdf2c49a38f985f160d60e1c49291c8828bd7b9a
ctrl_cnn_6_14_ema_var a4b2767b31013bc8bf7c323e78c1b962f88950539fd7a012d6f83bcf1d14f1da
ctrl_cnn_6_14_gamma 407a95ec1b7d437d8f28b4b5734c46dc0b202a31028d87d296e1bdce28ae3471
ctrl_cnn_6_15_beta 28e141c6adef10a0fb5d0e367c1e89ee409e8e739ce2d47ba0b140909b94b420
ctrl_cnn_6_15_ema_mean 7611e9ed55775fa37b4f7604c6685cba4dede895776d155d3a3759fce68b4621
ctrl_cnn_6_15_ema_var 1bfc8cd49140e68d5b1f02069249ad3677da08abde71d42af32f9c003432624f
ctrl_cnn_6_15_gamma 3d4717389e7bd0e458060144577e4bc0ff93d83e815b916c3cafc5a8ffa9ab0c
ctrl_cnn_6_16_beta c5219708cfc7b77f712aabbc78075ae2f64319fda275e58cbd7618538ef5b8a9
ctrl_cnn_6_16_ema_mean d36ee7870692e5453d753d6a9f6c3b9fd2bccbf1073df02cd3de93018b5939a8
ctrl_cnn_6_16_ema_var 72b874226ee30e09840ca04e4731c921a31a001703edfc48fc1de6ac34f32d9b
ctrl_cnn_6_16_gamma 6f02b6e11db8781f202ed4c7429c8c9318e83cec3e04ff33659410cdd06ec439
ctrl_cnn_6_17_beta 53483be1b9b220ef2f533aa3de9dbf87c66b9c2e74ba4f4d18ee87a42c3e62c0
ctrl_cnn_6_17_ema_mean d60f120c2e1b0332c69a1a477984842e52b648f8e95706d7cdc8751d4f49a00f
ctrl_cnn_6_17_ema_var 8387d3a8f051840105d4f75f7d12711b902c5435897813fd42b6a52aac4d021f
ctrl_cnn_6_17_gamma 167e3bd60b0f4ba8a7578ba107a0b8d76823a2e13bc53efc4a68335de6c3fa94
ctrl_cnn_6_18_beta a6aeeb83bfb7e27fe8208eef9ea97d1921e7a3f27a40bef526d683e254187d4b
ctrl_cnn_6_18_ema_mean 9cb6a16c2af24ba51fe344291a81def999db958f9ddf67f29f7a0bb250398d98
ctrl_cnn_6_18_ema_var 6bc4daf63825089b0bc38383e86edd4c71027ae7c924129149bee7faa101fdae
ctrl_cnn_6_18_gamma c7db336038040a3a0d617b1e58d4b0fcd11054146b6419a7e9dc9787b4ef6584
ctrl_cnn_6_19_beta 8789b688aba4de32762fc80ab7bd0b68eabca147dc7c5a6dfd345b68fc42801f
ctrl_cnn_6_19_ema_mean f0d9b9331c7bb2405032271bfc1a356e3c4dbaef5b3ff83cc7541de74c6d0ec5
ctrl_cnn_6_19_ema_var d6b160ed432ea80bdc83db3a71e777a890eab3f34e94813b3652a51580210c50
ctrl_cnn_6_19_gamma 8cc2e596aaa0d3d3e4b20ee75004e6a56d65fc82780ae9c5316d09d9533580f3
ctrl_cnn_6_1_beta 40cb410c9dd83c05a45926e5ef9f81ad9361c073b5ad4454c736b79b8c7500c9
ctrl_cnn_6_1_ema_mean 21a14428b878a913a26ab0357a871543acbdd0a2ac7d334769b852ed8e777d32
ctrl_cnn_6_1_ema_var 065d89cd265c79433022159ca70cc6fa88d20002deb1911dfb337a519847294c
ctrl_cnn_6_1_gamma 940d50cc07bd44ee979102241af30312dad20120d3cc001c3e136f8c4c733569
ctrl_cnn_6_20_beta 17cc930d338f5e6fb1ac817eb9292ef781f2ff6b5188996c23dcb738e4a757e5
ctrl_cnn_6_20_ema_mean a369aff16dee64832e4e337c2c333d5f512641c3213e9c58ab6e51c7c07d0e49
ctrl_cnn_6_20_ema_var 5c3a8e32604800f1d309bcd14de934dd6899539672153bb47b19d03f5de9500b
ctrl_cnn_6_20_gamma eba91adf3eb221fff0155bdf301f8a8236f1b948239fc94fbd6677b1b2cb0b73
ctrl_cnn_6_2_beta d24f7b0d71ace965ce135d169eb848cc5253893b430be32905ae8f113c5f6aa8
ctrl_cnn_6_2_ema_mean 01b13c8fdfb60c1b8ebf1bbc3d4f48f91002c2bbaa48d910209e46c757ff1b30
ctrl_cnn_6_2_ema_var 417895cffcbd77fa498a4249413cfd8a03609f1072c788daf2c70eef92f2b499
ctrl_cnn_6_2_gamma c5ac4f960d3d2465e0a5f941c9954641d154783d0356489649b9515c8b89162d
ctrl_cnn_6_3_beta 52241d7ea667ba116eae1603a0b1e3df5433bf23d3046cc5cdc5f4e4f3d54533
ctrl_cnn_6_3_ema_mean a17ceb00f0fad78d3d7ed9c4063cd8ad9812b26ee80df99d76873365d9f0d379
ctrl_cnn_6_3_ema_var 04c647ff81d481f552ec051848273eccc73e7df1809fb530b307165f5ae5a9a0
ctrl_cnn_6_3_gamma 69c2a45701f7c2e36ee206ff61d1bbc81f16d3a952229eb532d25d9742d97873
ctrl_cnn_6_4_beta f24a3203d45e740ab567f563abd414363f975ddc33a01c8c9c69ad12d8eeed6e
ctrl_cnn_6_4_ema_mean 8cf97850994907f000861177e57fbe28aeeca6535dfc1729feaee996e0f739df
ctrl_cnn_6_4_ema_var f6b5e423aa552aed429292d243311bb03866b71c964af24e43d8346e16c2904a
ctrl_cnn_6_4_gamma d269bffeca31d86de33ddb7e01f22f83f60331d39610004b61babf2767f2721b
ctrl_cnn_6_5_beta c1dd7c215dd93e59e00bd1a66121f2f2f53f06e431f872e68659235861bd8f01
ctrl_cnn_6_5_ema_mean e500bd9a67a9872997580e3311e3a81bcf928c3a9af2b7d714deaae1d64bee77
ctrl_cnn_6_5_ema_var 26caa60b6514f1a2b938f75b8640559f0258a2c316d2bb2483d20326c0c15a56
ctrl_cnn_6_5_gamma f807742583c8bf6b098fe83f95e9b3a3e9a0f61081c2eaff0a7e602053f7cad0
ctrl_cnn_6_6_beta 042ad74ed08babd641c6193f670d0cf07b5f48b5ccc85dce85a7f663825c3998
ctrl_cnn_6_6_ema_mean 6e1aaba02aac7d0514a56bae4c31c9afe6c7f16e882a337cbe9b827db021c445
ctrl_cnn_6_6_ema_var 5196269c91efd082fa42f9a9dcd970f8ef94112741739a107131203198decf18
ctrl_cnn_6_6_gamma 4c588c66ea8fcf23be31961b0a69839f8d936624702c111addda065462092404
ctrl_cnn_6_7_beta f5b4984b8814fed8ce4318fd6d8390c1880750fdf292689355281be0f47936b8
ctrl_cnn_6_7_ema_mean de9bc1ac4e00e34a9689c267c6b0b05fc437c644bca0fb2482cf004ab1a0cc3a
ctrl_cnn_6_7_ema_var 46ba7f7285482b67f8364cea94a764c07fd1cd2896279c8f61c0cbed92195210
ctrl_cnn_6_7_gamma c0930e2016cd321b2bc9f8d613a12f153bbcbafa76ade272c7fe3a2349da9194
ctrl_cnn_6_8_beta aa5a5bbfe7d4637ac350c393eb821b841c97069dbf000e5490608b059d6a8070
ctrl_cnn_6_8_ema_mean 1debaa5efd9f82257c6494c6fd74dfc2f16653da7c926b059d63a8120d8f0621
ctrl_cnn_6_8_ema_var ea0a6bb34453dd9a92415e2f6c341e78a980b4e0c44d0813249da228ff8f1802
ctrl_cnn_6_8_gamma 53f3de5441fb7d5048dacec31d41af87a8d6f503780714531573ecbf6bb0bc99
ctrl_cnn_6_9_beta e2a9c1263b105421bbe026470f235e26e0e1a8c48bf93e7298e5d753714024b1
ctrl_cnn_6_9_ema_mean bd6cf70335219f555419399604c8a9a299495baadfdc91e4b87e7d528b7f6550
ctrl_cnn_6_9_ema_var 4336f4ae45a478bb7b4439920f810f38a50c34a8f80abc64960cb3e8021b20fa
ctrl_cnn_6_9_gamma b0eb9f6783d05a7cce0e68fe88846af1b4185e966815565df4910661a8f9a688
ctrl_cnn_7_0_beta a43f76e060c0f378dbaf453e1f978b013a7d24424e9d9d03e4e633a43bd1fc43
ctrl_cnn_7_0_ema_mean 02a4650b0e56fd4ece0fa29bde7f0b0511e4e2e986dcf9a2ffc180890a816c0c
ctrl_cnn_7_0_ema_var 1cab2b91dc0c66ce302d7132cb887b7e4dd54d292ca4ff7b6eaf1ecb021ae625
ctrl_cnn_7_0_gamma 28876a89c07e7e4f7332736439a8a5b7c3f5bd7cd241180507bcca055594c647
ctrl_cnn_7_10_beta 1cbba5cd40d0700cdc55cafc779ea21b168f69a1cba6f58bd65a79a67c975157
ctrl_cnn_7_10_ema_mean a6f1a7292fcf3708c920da0de543febf1712422531ccd23c335a814c383316d4
ctrl_cnn_7_10_ema_var 105b102f373903c3d3a2645a7e81270e3051f1b69e307c190b227916c6649398
ctrl_cnn_7_10_gamma d1fe575221e858337141a5bd34b1c607c733344775b9ed283ee90c6d3da77287
ctrl_cnn_7_11_beta 1371b0aaed58dfd50d62056c268648778958d511eaaf644f35e22966111c0f3c
ctrl_cnn_7_11_ema_mean 4b3020659367eb8e32ba35b9f8030b7c027438c9a02f22ae003e29628f829467
ctrl_cnn_7_11_ema_var 2f05ba2feea4c55e6f232da464921e6c3b6e19b3a108aadddfba3dccf8581364
ctrl_cnn_7_11_gamma 50398f5d7f89d44c3915bf2832e197e5ae0326f6ef77b7ac4115a4fe0276176e
ctrl_cnn_7_12_beta 621ec15ce286af5eb3ae3cafb33e08cbd551ea2521ab01d7fb04139572e54f58
ctrl_cnn_7_12_ema_mean f42cdfb8dd51c0a01bb51f613323763af02c3591d1b3b0a367f958031273bc3b
ctrl_cnn_7_12_ema_var c7e1d2c0573250187ea052888b6e22fa45d97561422c233825030ae71d00fa57
ctrl_cnn_7_12_gamma 77f7b281d8faee4125d35dda4c0f756ba62060ecd2d40a6962f35fe7341a3465
ctrl_cnn_7_13_beta b2412fb854ee24f1ae53d91f5c22d8fb51a4f80256dc6f993109b492600fa396
ctrl_cnn_7_13_ema_mean a0e15c2be4b92955433f6cc8791613b458a4c108f5a2c1ae8b1dccb641863c1a
ctrl_cnn_7_13_ema_var 8a3b6d8b7cdbcf225455a60b2141f1f8c49fe9083edf98a6a4845810d18d1972
ctrl_cnn_7_13_gamma 38e64de928f229028026967629a5bfd1ed1c32dc87bf8397c8d4286ed46191ef
ctrl_cnn_7_14_beta 1157bb4f6df3d6ce2223f7d38a5cb77de7f5ba9cc97ac85db71992f87fb1989b
ctrl_cnn_7_14_ema_mean 9670592991172d9fa6c09b1d7a44e7e079c265405971ef92c7631a972bbbe988
ctrl_cnn_7_14_ema_var 9a41020bedbaabdf77856d3b6ff04a1a7ebee85ca587bc36716d88d4a9e10bf5
ctrl_cnn_7_14_gamma 85c076a3211a81e7b3dd4a223b8920cb20b85094341a456ec4b7e5fca72c73e9
ctrl_cnn_7_15_beta a23aae5677b18f81d8da269f28effa6d161b958c789bbed3e0e3008d14585d56
ctrl_cnn_7_15_ema_mean eee7cd725f856260695349c28f94bf962da3009afa7e57012170308f4d278321
ctrl_cnn_7_15_ema_var ecaecd2e94b24179f93bf0d3632a8c0f23b9df8837b2942600be59384ae94b5f
ctrl_cnn_7_15_gamma 21bd8e284b7808616afd37dee86af7fbf0dc2e4ae97bd9951fc4088a294c3c16
ctrl_cnn_7_16_beta f71d09978281ec7baab1c2152ad2d960ad01e6dc7758493e74b01591e26bb13e
ctrl_cnn_7_16_ema_mean 72b6e500a62bf2c6512cb67dfa288afc4317d024e9342c4de98d050d4c3500e0
ctrl_cnn_7_16_ema_var 99859b155c01739134d0c654bc36b3c8ae2576a2113dc80ac0ef146d54494dde
ctrl_cnn_7_16_gamma f9b56cdee85d96f9d337ec1bce02e705b18e2810f8011d4cf7722a6e1cc4f500
ctrl_cnn_7_17_beta 156b2539bfaf58b905ddbc932cef0028f14c8daa1677a41d61bf8e6350ceec87
ctrl_cnn_7_17_ema_mean 1936bde5ce805f42cfd754842ed3cd26aba9cc1d70d97226b75491e2048cf59d
ctrl_cnn_7_17_ema_var 1fb3be610cdcdbe5ce9b338167651c5dda1792b4fa63f581b54e8fb0e3ddb504
ctrl_cnn_7_17_gamma b34678fdf46ee7c650a98226e434d38aec049cc7b8fa0f0d697ac8458c6c92af
ctrl_cnn_7_18_beta 605d02ea97f704cdcf490e794464bf93679bf7ac4b90cd29be76af5c6c2304ac
ctrl_cnn_7_18_ema_mean 5a493ed9207238640af70d43e1d18d965e14fa881322530aad42e166ff861af9
ctrl_cnn_7_18_ema_var f22141a330faf86b5d01075704f198d09e1facb35defcaee37ca59d36e0526fc
ctrl_cnn_7_18_gamma 07576c12aeb1822288769d8714c07b68489e84d2adbff3e05d7cec26216ee7be
ctrl_cnn_7_19_beta be1c31f74f42281734d21df95df440f4d227f62787a3b7747b4bf01e212b63ca
ctrl_cnn_7_19_ema_mean 0b21af6fb08c8bdaf3edcf4a51fd90efb7f5c56135c0401708f3dd3de6b5c3ee
ctrl_cnn_7_19_ema_var 2c267b10179373864335494607bfeb2f9dc592825a461ac101203f3b49c8b937
ctrl_cnn_7_19_gamma 7a2367ad8636c617738e6a2adb859b1f3295e63d18aa7317b065748f1d1acfe0
ctrl_cnn_7_1_beta d159bdc424c15651cf105664c88ea8b24cc999d79ee87300b9abdb742e56ff32
ctrl_cnn_7_1_ema_mean 27c715a42c8d7603e1a8c1e5892ba2a944588a79f66b03176daa4a880f1a71eb
ctrl_cnn_7_1_ema_var 0811a03d01477523a391b24489d6f4d6e359d3d2ef02be2c77736521fe9153f4
ctrl_cnn_7_1_gamma b8434ecf0286ca4c11914d1a7eed7162eac2fed2c12c8053e84a245cb3dd5942
ctrl_cnn_7_20_beta b576699c2287e49b852b7a65f93c37ab8e80e4e03388ef15a083b2628edc0ab2
ctrl_cnn_7_20_ema_mean c96bab2b8206faa6d00d7ef1f781151886d1b9492dce62119d0570648665edc8
ctrl_cnn_7_20_ema_var 6b9421c150608df83e802ba038e280a9b16aa6f1c8229316b9211b411a72f69a
ctrl_cnn_7_20_gamma aa280df6d8f79af087b9bdd87158275cb20da5b089d58d79867d531a83bdb2a0
ctrl_cnn_7_2_beta a70b720988e3184b5346ad985d9db9368fce0148cb7ae48174a1bf6987403976
ctrl_cnn_7_2_ema_mean 87f786868ce33ec0dc42853916e6c34bd2a887bd800b4b821d80b189cc62ef80
ctrl_cnn_7_2_ema_var 2dc93701e1f08a90b3b9e25b7f8a7154fd8c6cb30dd40a7965d79973fb6ba33a
ctrl_cnn_7_2_gamma 275dcb1a43ccf2efeb20877fa076ffa004f93d1745516657998165582ceece62
ctrl_cnn_7_3_beta 4ce7c2b3812d94c1581388ca6aaf511e14da1cc8cdc075dc64f9d081475b3db8
ctrl_cnn_7_3_ema_mean 0750372a1a565b30bdd1978e50217fcfb898be643cc091d26bff65c8b1bf918b
ctrl_cnn_7_3_ema_var a105209d8f1d806a4b3085c3be382e88ed57fa775c0dfcdb4d0048afc6f008b5
ctrl_cnn_7_3_gamma 58c447968c956b795df69edcc166aa4a0b3732dfa129430c2ca568838053ab24
ctrl_cnn_7_4_beta 91b7d38b003935cff0fd88e82a02d13d8810b834b3a33958e4fd20f561ef736b
ctrl_cnn_7_4_ema_mean cc12a74d4ff918f5aa83b14d5c5c836b6e96a988fa9cbf34e3d2e5f8c5dd7c69
ctrl_cnn_7_4_ema_var e131bda24606dcf6cfd67ec2a65d6da173e8fb440fbfc826ef00221e505e6430
ctrl_cnn_7_4_gamma 8a39a37c3fdc3520991b2fd25d0986eb05e36719e210a0813863be187ff41ab4
ctrl_cnn_7_5_beta e3690dde412f7996f8a8105ef0d077129d794d4be0220986f5c4f48ed062852d
ctrl_cnn_7_5_ema_mean 8dc0746e5e74108055704f700c2779750ecd631ef0db51e7b4760b0d71f37d48
ctrl_cnn_7_5_ema_var 82ef490717e510f4464605459c1d8ae1979690cba07c9c27c533f9b6b3b6ca99
ctrl_cnn_7_5_gamma f60db84083eff5b3f1f4a4df1e9bf419622e5606cadeb20c2d08db4a0ad8c9db
ctrl_cnn_7_6_beta 6da7112965d82726b7c450df690a643fd82e2c0476bdbfcdd44a91d35c98c61d
ctrl_cnn_7_6_ema_mean b51a84618791ef48e983b5c89c978fb9fe898dcd7b11d6e8de9416940d12da35
ctrl_cnn_7_6_ema_var 26cce47ab1dac846ef04e4756936fda83a561173f318f539e3d1390f37405126
ctrl_cnn_7_6_gamma 0cbeafb5ea82578de2c41cc04135c26cd11ca03fd73dfa8011ac9a10de28e0ac
ctrl_cnn_7_7_beta 0550ff3fa079243d8e5035bd92de0e2a0f4fb158ad0d34a7b1df481698bcfbe0
ctrl_cnn_7_7_ema_mean 304cdfa4685b37c3f0ea842b38781dcbc52d3909250b11c94e86dff537595f6d
ctrl_cnn_7_7_ema_var 074807aec9144b6f00b276a6ee5eeae799c67b95b2f1ec87b89517eebd436238
ctrl_cnn_7_7_gamma 17d7a24c68f2a443e38ee8a5d517e1d1d15eeb2878925872670f143a74401fa5
ctrl_cnn_7_8_beta 4110cd5e179fd18f6cbd76d968dab055ed5ad5d9d52d52aec4b9857b2f5a94ad
ctrl_cnn_7_8_ema_mean a6e3265c906267814d7e598d87ff442d8d829d38202de983a304507f0044a597
ctrl_cnn_7_8_ema_var 1e6a038ac8f8abd2f43b292bfd726fb3b02d593f6b8965f7f09120949b282c59
ctrl_cnn_7_8_gamma cca01babe381c809057224f2b1b24ae1d09e6fbebff710841841413bb6d58109
ctrl_cnn_7_9_beta 5d0351317ba4c5566579d8eb4541e118a687c3dd2b91abf5c92f6e6c7d12d143
ctrl_cnn_7_9_ema_mean 879acc2cb702f854080b3d9e1f064e76db8efda4a81c8bfc1d348003d950ab85
ctrl_cnn_7_9_ema_var 8031b6123006e82145da4854b57acc577074e98244cd9ff33ca362a66a777a2b
ctrl_cnn_7_9_gamma 981f81e83295e321322a6c2f1bddd0e2ee960132cf37b7831764d054ea886f22
ctrl_cnn_b_0 02fc5c36d54f1147b605e34dd3428fde21db0113cba9a87bd662c94737f972ef
ctrl_cnn_b_1 025ceb47239c08adf312d06179365240a765bdf58a8d8482b611b8d0a02b441b
ctrl_cnn_b_2 02ebd565efb8200df55aad0e856f165c4fad22fb93faffd5e6840bbca01ad58f
ctrl_cnn_b_3 1ab1fdf71b4118871242db765abb28be10de6ea3474e589325742953d2752779
ctrl_cnn_b_4 a2fc474a68cf00adb8e57ca41b1bdacba943473b5c44ef6ea9841484eb7759aa
ctrl_cnn_b_5 fdcb0adbd9c3e482a2f32862ab5c468db329bb80849182afc727d64e941c19a8
ctrl_cnn_b_6 43e21f795356407b25467e54fa1068aedf48496554c69884f4da08954136dd82
ctrl_cnn_b_7 2cc892049fe5c2c033225ac423b4b65c6c8c3286d533fbb902718ca4c468cab9
ctrl_cnn_w_0 8aefaecac3797496e06f73e4b77bb3cd4ac5ca1e38b7f2b9afe3ac768678e1bb
ctrl_cnn_w_1 d5a12a2b9c59dec4aa1613078be231fbeee5f029fd5951cccc3aa2394bd9600c
ctrl_cnn_w_2 5ece3ad1c1dc5a74f1363db7ee798db9060369cab1700658ef46b8a8aceb3db8
ctrl_cnn_w_3 8626fe150cda30a910da8aa31381e16661a4dace379c7e7049d7478650d034dd
ctrl_cnn_w_4 be3ce21446efce4b627d9efff05fcd5b27267819f0616346400e1fa0e5be923e
ctrl_cnn_w_5 3b49f20692b20f45583335dd9b878d19a9061aebe2ddc9fe256af406896fb743
ctrl_cnn_w_6 dee7ea10af9b4a5bdbca35d79e0ce00246f25bfb7488f9fb6485c041455571d6
ctrl_cnn_w_7 ecbf891caffb39b761fdf66b99e157bec05cfd9f1411fd0b548ca89f9f271b07
ctrl_lstm_b_f bb71a56b34bc86d69d66e8ccf5c64847c6c8b615323793bbd8df594a6bf9e28a
ctrl_lstm_b_i 9d52e87d7d613cde66a795186f154526ca760b53c47f06d985af0b07325d9e3f
ctrl_lstm_b_o b76c9758f39f26db2510dc8ab94ee06413395c2e32821ba132c81f69be3ca194
ctrl_lstm_b_u 4f5c4e95ce5615bd7343a9242e30e3940d61dcc2d375f2614f1c2de3bbe872eb
ctrl_lstm_w_hf 41d5df20e54af8726c6a9b8f195924e827681e9ee244c754dc8b8647765b46aa
ctrl_lstm_w_hi 5d2e19ecdcf7096a8963c5301767f897b050980616a43cf73af459a90ff5532b
ctrl_lstm_w_ho c106145508725b4650c463f0c26aad947ee5cb62c079f3460f629bf522fa9119
ctrl_lstm_w_hu ce437aba395ec25687ce584c5a2ebf5f0f466124491ba74365b6165a123daef6
ctrl_lstm_w_xf 77bc0bcc6fdb3cd6e6fc96e25a5990111b56c4dac38dfb849c86e9e840eaa9bd
ctrl_lstm_w_xi e9b49fc9c509bdc2dc466c5cdae36f0bff091ae7f052f498deddaf6291635027
ctrl_lstm_w_xo 56f934c0a28d17c478b8a04c8120df146016b73d871d513629c1e99f4540f199
ctrl_lstm_w_xu 9734c4863bec0748cf787667f61ca8de1c707c6cfde858848798370734354789
ctrl_mlp_b_0 4bfb47392f4367c07fdae4fd3d08ffb32484c9f6b733669c46cfc51e3d33c8f3
ctrl_mlp_w_0 f1612616c888736625f78112f4f003d6474dd9fa4587fbe506a72185dcfe6b50
glimpse_mlp_b_0 b5b9d488030390bf6d5416edcee538130552723d9553180ed38c58a128967ee4
glimpse_mlp_b_1 3d2427fbe6d2107731397b06440dd7167c68d381782d603caf829e7b9c26961d
glimpse_mlp_w_0 e4004818a7cc44f344316a6a12e3c77a036a6ded71f6eddbd478584e1d7ea196
glimpse_mlp_w_1 ff7afce25d5256783286c022f7320abc8f18f80e54e56ed99996003a353a065c
score_mlp_b_0 810a79d6a8030fe6ad6c4b733b8b8cf4db0a371c4f5e713ed9d74032822e4b47
score_mlp_w_0 6e664619d0ff88d816c608af93077ee53a8c8cb2c02a1db01f250bbe13ea7b05
"""


if __name__ == '__main__':
  if sys.argv[1:2] == ['synth3-child']:
    synth3_child(sys.argv[2])
  else:
    main()
