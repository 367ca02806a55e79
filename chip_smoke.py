"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. device: the card's name and power limit (nvidia-smi); no CUDA -> fail;
2. build: nvcc builds every CUDA kernel of the main path from `csrc/`,
   one process per source, all at once (`gluefactory_tpu_torch/ops/_build.py`);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes, in f32 and bf16, with four mask cases (all valid,
   random partial, side 0 fully masked, side 1 fully masked); the attention
   kernels also at a tail shape (777 queries, 1029 keys) and with q/k as
   LightGlue's (B, N, H, D)-ordered views, and in f32 at path E's shape
   (512 keypoints) and a head dim of 32, each with partial masks, with the
   f32 body's blocks an SM recorded; then the kernel, its plain
   version, and one PyTorch library call computing the same function, timed
   with CUDA events (the attention kernels by their device time, also with
   half of the tokens masked at random as width pruning leaves them: the calls
   queued behind a sleep kernel, so that they run back to back; bounds count
   tensor-core operations, exponentials and bytes); Sinkhorn also at ragged
   sizes, 0 and 1 iterations, an all -inf row, several items at once
   (513^2), rows streamed from device memory (4097^2) and v read through L2
   (N = 20000); the VGG blocks also at a strip boundary, an odd size
   pooled and channels that take the CUDA-core body, each block's body and
   strip height recorded, the kernel and the cuDNN sequence by device time;
   the decode bit for bit at every radius 3-8, at 1000 x 1004, one image,
   plateaus of equal values and a constant map, by device time, bound by
   bytes and by its compare operations;
3b. gradients: with grad enabled, each of the four differentiable kernels'
   outputs (both attention kernels, the VGG block, Sinkhorn) carries a
   grad_fn, and its gradients equal the plain version's at small shapes;
   the decode raises under grad;
4. main path: `two_view_pipeline` (SuperPoint + LightGlue-9, d=256, 4 heads,
   2048 keypoints, 1024x1024 images, bf16, random weights from seed 0) run
   through its entry point on 4 pairs; launch counts reset just before and
   read just after; outputs checked; the matcher rerun on 512 keypoints per
   view with the plain versions forced in, against the kernel run;
5. a torch.profiler window over one forward: device time by kernel;
6. path B: SuperPoint + SuperGlue (`superpoint+superglue-official.yaml`'s
   model section: 2048 keypoints, nms_radius 3, SuperGlue d=256, 4 heads,
   9 layer pairs, 50 Sinkhorn iterations), driven, checked, compared with
   the plain versions at 512 keypoints and profiled as in phases 4-5;
7. path C: the main path with SuperPoint's `fused_detect` and
   `fused_backbone` on, driven and profiled as in phases 4-5; its keypoints,
   scores and descriptors against the opt-ins-off extractor in f32 and bf16;
7b. path D: LightGlue's adaptive pruning at bench.py's pruned settings
   (depth_confidence 0.95, width_confidence 0.99) on the main path's
   weights and batch, the confidence heads biased as bench.py biases them
   so that every item exits after 5 layers: the pipeline's masked pruned
   forward (each attention kernel 9 times a forward) and the early-exit
   serving function (`lightglue_serving.make_serving_fn`, 5 times) driven,
   timed and profiled (wall and device ms, busy share, the idle after each
   host read); exit layers, prune counts and log assignments compared
   across the two; then kernels against plain versions under scattered
   active masks (25-75% of the tokens width-pruned) at 512 keypoints, f32;
8. conv study: the streaming and N-packed 3x3 conv kernels, each against
   its plain version at (2, 1024, 1024, 64), (1, 37, 53, 64) and, across
   the kernels' 64-row strips, (1, 130, 200, 64) bf16, one launch per
   wrapper call; then both profiling tools
   (`gluefactory_tpu_torch/scripts_dev/profile_{stream_conv,npack}.py`)
   through their `main` at SuperPoint's conv1b shape (8 x 1024^2 x 64),
   their kernel against the library conv (`maxdiff`) within the tools' bf16
   tolerance; each kernel's time over the library's and its TFLOP/s, of the
   function's work and of its own (halo rows included);
9. path E, stage-1 training (run before phase 8): `gluefactory_tpu_torch.
   train.main` on `superpoint+lightglue_homography.yaml` at full width
   (SuperPoint 512 keypoints frozen, LightGlue-9 d=256 with checkpointed
   layers, 640 x 480, f32, the recipe's `lg` photometry), cut to procedural
   images, batch 32, 6 workers, 2 steps and 2 validation batches of 8 (the cuts
   are printed); every loss term finite and every update applied, each attention
   kernel exactly 18 launches a step (9 forward, 9 in the recompute) and 9 a
   validation batch, the last checkpoint reloaded bit-equal by `--restore`,
   one train step through the kernels against the plain versions (loss and
   the matcher's gradient norm within 1e-3 relative); then ms a step and
   samples/s (CUDA events over 3 steps after 2 warm-ups), the device busy
   share and peak memory, each attention kernel at the training shapes in
   f32 (forward, and forward + backward, against SDPA), and whether one step
   at the published batch of 128 fits; the loader's samples/s with `lg` (6
   workers, the host's core count printed) beside the step's, and which of
   the two sets the pace;
9b. path E in bf16 (`train.mixed_precision=bf16`, all else as path E):
   one bf16 step through the kernels against one through the plain
   versions from the same state (loss and the matcher's gradient norm
   within twice the gap bf16 rounding alone opens, plain bf16 against plain
   f32), 18 launches of each attention kernel a step; ms a step, device ms
   a step, busy share, peak memory and samples/s; each attention kernel at
   the training shapes in bf16 against its bound and SDPA;
9c. folder run: 48 procedural images written to a folder (JPEG through
   Pillow where it is importable, else binary PPM), the loader's samples/s
   from the files, and 2 training steps of path E's recipe on them
   (`data.image_dir`, `data.synthetic_images=0`, batch 16);
10. path F, the HPatches benchmark (run after 9c, before phase 8): an
   HPatches layout of 8 procedural sequences (4 i_, 4 v_; 1000 x 750, 5
   views each with `H_1_k`) written under `outputs/chip_smoke_hpatches/`,
   then `gluefactory_tpu_torch.eval.hpatches.main` in process on
   `superpoint+lightglue-official`'s hpatches section at full width
   (SuperPoint 1024 keypoints, LightGlue-9 dense, f32, 480 on the short
   side) with `eval.estimator=xla_ransac` and random weights from seed 0
   (`model.weights_file`); cut to 40 pairs of 540. Gates: 40 cached items
   with the export keys, 9 + 9 attention launches a pair, every RANSAC
   tensor on the card, finite DLT and RANSAC AUC@1/3/5 px; an export through
   the plain versions (`model.matcher.flash=False`) and a grouped export
   (`items_per_dispatch=4`, 9 + 9 launches a forward), without their eval
   loops, each against the kernels' per-item run within 1e-3 on the scores; an `--overwrite_eval`
   rerun that reads the cache. Export pairs/s, the eval loop's seconds,
   RANSAC ms a pair (CUDA events) and the busy share of one forward;
11. path G, the MegaDepth-1500 benchmark (run after path F, before phase
   8): 2 procedural posed scenes (textured planes ray cast,
   `gluefactory_tpu_torch/scripts_dev/posed_scenes.py`; 1920 x 1440 JPEGs
   and 16-bit PNG depths, one PINHOLE and one SIMPLE_RADIAL scene, 3 pairs
   each) written under `outputs/chip_smoke_megadepth1500/`, then
   `gluefactory_tpu_torch.eval.megadepth1500.main` in process on
   `superpoint+lightglue-official`'s megadepth1500 section at full width
   (SuperPoint 2048 keypoints, nms 3, LightGlue-9 dense, filter 0.1, f32,
   1600 on the long side) with `eval.estimator=xla_ransac`, `ransac_th
   0.5`, `data.depth_format=png` and random weights drawn as path F draws
   them, but on the CPU and centred on one of the path's views; cut to 6
   pairs of 1500. Gates: 6 cached items with the export keys, 9 + 9
   attention launches a pair, every RANSAC tensor on the card, finite
   epipolar, reprojection and GT-match metrics and AUC@5/10/20 degrees;
   exports (no eval loop) through the plain versions and grouped by 4
   against the per-item cache within 1e-3; the `--overwrite_eval` rerun on the cache;
   `ransac_essential` on the card on 1024 synthetic correspondences from a
   known pose (30% outliers) within 1 degree of the truth and 0.5 of the
   CPU's run; `gt_matches_from_pose_depth` on the card equal to the CPU's at
   the path's keypoints. Export pairs/s, the eval loop's seconds, RANSAC
   ms a pair with its launches, device ms and busy share, the forward's
   device ms and busy share, and both attention kernels in f32 at N = 2048
   against their bound and SDPA;
12. path H, stage-2 training (run after path G, before phase 8): 4
   procedural scenes of 12 views at 1600 x 1200 in MegaDepth's D2-Net
   layout under `outputs/chip_smoke_stage2/`, then `train.main` on
   `superpoint+lightglue_megadepth.yaml` at its widths (SuperPoint 2048
   keypoints frozen, 1024 square-padded, LightGlue-9 `checkpointed`, f32),
   warm-started from path E, 2 epochs of one update (2 micro-batches of
   16, grad_accumulation 2; the timed steps at batch 32); gates and
   numbers as `phase_stage2` says;
13. path I, stage 2 on cached features (run after path H, before phase 8):
   `scripts/export_megadepth.py --method sp --with_depth` in process on
   path H's scenes (SuperPoint with path E's best checkpoint's weights) into
   `exports/megadepth-undist-depth-r1024_SP-k2048-nms3/{scene}.h5` there;
   gates: a group for each of a scene's images in every file, every array
   read back by `data/hdf5.py` equal to what went into the writer,
   keypoints finite and inside the image, `valid_depth_keypoints` bool.
   Then `train.main` on path H's argv with `data.load_features.do=true`
   for one epoch; gates: finite losses and applied updates, 18 launches of each attention
   kernel a step and 9 a validation batch, SuperPoint never called, the
   dataset's caches equal to the export's arrays as the loader scales and
   pads them, the batch's `keypoint_mask0/1`, a step vs `flash` off,
   `--restore` bit-equal; ms / device ms a step, busy share, samples/s and
   peak memory beside path H's, the loader's rate with `read_image` true
   and false (over the training split), and which sets the pace;
14. path J, the last two benchmarks (run after path I, before phase 8):
   1 procedural ETH3D scene of 4 views at the DSLR size 6048 x 4032
   (`scripts_dev/posed_scenes.write_eth3d_scene`: COLMAP `cameras.txt` and
   both `images.txt` with 15000 points' observations, 16-bit PNG depths at
   756 x 504) and 2 ZEB scenes of 6 pair files at 1600 x 1200
   (`write_zeb_scene`) written under `outputs/chip_smoke_path_j/`; then
   `eval.eth3d.main` with `--conf superpoint+lightglue-official` (9 + 9
   attention launches a pair) and with `--conf superpoint+NN` (none), and
   `eval.zeb.main` with `--conf superpoint+superglue-official` (36
   attention launches and one Sinkhorn a pair) and `eval.estimator=
   xla_ransac`, each config by name, random weights drawn as path F's.
   Gates: finite AP and AUCs, the caches' items and keys, exact launch
   counts, `depth_matcher` and the RANSAC on the card, the NN matcher's
   outputs against a CPU recomputation of the same tensors, each cache
   read back by an `--overwrite_eval` rerun;
15. path K, SuperGlue stage-1 training (run after path J, before phase
   8): `train.main` on path E's config with SuperGlue at the official
   widths (9 layer pairs, 4 heads, 50 Sinkhorn iterations, checkpointed)
   as its matcher, written to a temporary directory; 2 steps at batch 32
   and one validation batch of 8. Gates: finite losses, every update applied,
   72 `fused_attention` and 1 `log_sinkhorn` launches a step (36 and 1 a
   validation batch), `--restore` bit-equal with the BatchNorm statistics,
   a step through the kernels against the plain versions (every gradient
   entry within 1e-3 of the norm, the BatchNorm statistics after it), the
   Sinkhorn kernel at (32, 513, 513) under autograd against the plain
   loop, one `TripletPipeline` forward and loss on a batch of 8 triplets;
   then ms / device ms a step, busy share, samples/s, peak memory and the
   loader's rate;
16. path L, points and lines (run after path K, before phase 8):
   `superpoint+lsd+gluestick` at its widths (2048 keypoints, 512 LSD
   lines, GlueStick-9 at 256 wide, f32; the LSD is the repo's C++, built
   in phase 2 by the host compiler), random weights passed through
   (`gluestick_pass_through`). Two of path F's v_ pairs at 640 x 480 and a
   1600 x 1200 scene through the pipeline: 36 `fused_attention` launches
   each, finite outputs, the plain versions within 1e-3 on both log
   assignments, LSD the same on a second run; wall and device ms, busy
   share, LSD and clustering ms an image, segments, junctions; the
   attention kernel at the forward's node layout (1, 4, 3072, 64) with its
   mask against its plain version (1e-4) and SDPA. Then `eval.hpatches.main`
   on path F's 20 v_ pairs with `xla_ransac`, and with `homography_est`
   (the point + line RANSAC) on the cache, and `eval.eth3d.main` on path
   J's pairs with the line GT in the forward (one pair's line GT equal to
   the CPU's, as integers; the auction's iterations) and `eval_lines`;
   finite AUCs, AP and line AP, exact launches, the RANSACs on the card;
17. path M, GlueStick training (run after path L, before phase 8):
   `train.main` on `superpoint+lsd+gluestick-homography` by name at its
   widths (SuperPoint 1000 keypoints at threshold 0, frozen, drawn as path
   L draws it; 250 LSD lines in the loader's 6 workers; GlueStick-9 256
   wide, `inter_supervision` [2, 5], checkpointed; f32, `dark`; nodes 2 x
   250 junction slots + 1000 keypoints), 2 updates at batch 32 (each 2
   micro-batches of 16 under grad_accumulation 2) and one validation
   batch; then `superpoint+lsd+gluestick-megadepth` on path H's scenes
   (1024 square-padded, `depth_matcher` with lines on the card),
   warm-started from stage 1, 2 updates at batch 16 (2 micro-batches of 8
   each) and one validation batch. Gates: finite losses (point, line and,
   in stage 1, the inter-layer line NLLs), every update applied, 72
   `fused_attention` launches a micro-batch and 36 a validation batch, a positive line match in
   every batch, no LSD in the main process, `--restore` bit-equal with the
   running statistics, stage 2's first state equal to stage 1's last, a
   stage-1 step through the kernel against the plain versions (gradients
   and statistics), the kernel at (32, 4, 1500, 64) with a batch's node
   mask forward and under autograd; then ms / device ms a step, busy
   share, samples/s and peak memory of both stages, the loaders with and
   without lines and the LSD's ms an image in the workers, and the
   attention's forward and forward + backward against its bound, the
   plain version and SDPA. Path M alone: `phase_device`, `phase_build`,
   `write_stage2_data(S2_ROOT)`, `phase_gluestick_training`;
18. path N, the learned-extractor zoo (run after path M, before phase 8),
   each config by name with random weights drawn as path F's (the
   descriptor head centred on one scene by `centre_descriptors`): N1
   `aliked+lightglue-official` and N2 `disk+lightglue-official` at their
   megadepth1500 widths (ALIKED-n16 / DISK, 2048 keypoints, LightGlue-9
   with input_dim 128, f32) on one procedural 1600 x 1200 pair: 9 + 9
   attention launches a forward, wall and device ms, the extractor alone,
   the plain versions' forward within 1e-3 on the log assignment, both
   attention kernels at the forward's layout against their bound and SDPA;
   N3 the HPatches CLI on `aliked+lightglue-official` (1024 keypoints,
   `xla_ransac`) on path F's v_ pairs: launches, the RANSAC on the card,
   finite AUCs; N4 `train.main` on `aliked+lightglue_homography` and
   `superpoint-open+lightglue_homography` (batch 32, 2 steps, one
   validation batch of 8): finite losses, applied updates, 18 + 18 launches a
   step and 9 + 9 a validation batch, and the frozen extractor's running
   statistics moving at every step where flax normalises by the batch
   (all of ALIKED's; the open SuperPoint's but its 1x1 heads'), unmoved by
   the validation batch and held by the checkpoint; ms a step (each step
   synchronised, host clock) and peak memory. On every call of the
   extractor: outputs finite, descriptors unit-norm, keypoints inside
   `image_size`. Path N alone: `phase_device`, `phase_build`,
   `write_hpatches(HPATCHES_ROOT)`, `phase_zoo`;
19. path O, SIFT on the card (run after path N, before phase 8), each
   config by name with `model.extractor.backend=jax` (the configs ship the
   opencv backend; the card's machine has no cv2): O1
   `sift+lightglue-official` (LightGlue-9 with `add_scale_ori`, input_dim
   128, random weights drawn as path F's) and O2 `sift+NN` at their
   megadepth1500 widths (2048 keypoints, f32) on path N's 1600 x 1200
   pair, as N1 / N2 (O2 launches no kernel); SIFT alone on one image: ms,
   device kernels launched, peak memory; O3 `train.main` on
   `sift+lightglue_homography` (SIFT 512 keypoints frozen, batch 32, 2
   steps, one validation batch of 8): finite losses, applied updates, 18 + 18
   launches a step and 9 + 9 a validation batch, ms a step, peak memory;
   O4 the opencv backend raises an ImportError naming cv2 where cv2 is
   absent (blocked where it is installed). On every SIFT call, on its
   valid slots: outputs finite, RootSIFT descriptors unit-norm, keypoints
   inside `image_size`, scales > 0;
20. path P, LoFTR (run after path O, before phase 8), `loftr` by name with
   random weights drawn as path F's and made to match by
   `loftr_pass_through`: P1 its megadepth1500 section on one procedural
   832 x 624 pair (8112 coarse cells, 2048 match slots, f32): no port
   kernel, wall and device ms, peak memory, valid matches and their error
   under the pair's homography, keypoints finite and inside the image; P2
   the HPatches CLI (480 on the short side, `xla_ransac`) on path F's v_
   pairs: finite AUCs, the RANSAC on the card, the cache written as
   `predictions.h5` with every pair and read back by an `--overwrite_eval`
   rerun. Paths O and P alone: `phase_device`, `phase_build`,
   `write_hpatches(HPATCHES_ROOT)`, `phase_sift`, `phase_loftr`;
21. path Q, RoMa (run after path P, before phase 8), `roma` by name with
   torch's random init from seed 0: Q1 its megadepth1500 section at its
   widths (DINOv2-L 24 blocks 1024 wide, VGG19-BN, the GP, the anchor
   decoder, the ConvRefiners; internal 630^2, output 1344^2, 5000 sampled
   matches, f32 on bf16-rounded images), the weights drawn on the card, on
   path G's first pair at 1024 on the long side: no port kernel, warps
   finite in [-1, 1], certainties in [0, 1], 5000 matches inside both
   images; wall and device ms, busy share, peak memory, the top device
   items; Q2 the MegaDepth-1500 CLI on `roma` (`xla_ransac`, png depths)
   on 2 of path G's pairs: finite metrics, the RANSAC on the card,
   `predictions.h5` and `results.h5` written, an `--overwrite_eval` rerun
   reading the cache and the `names` back; Q3 `grid_extractor` (cell 14)
   with RoMa's keypoint snapping on Q1's pair: matches in range, one to
   one, above `filter_threshold`; Q4 RoMa at the CPU tests' widths, the
   card against the host's CPU on the same weights and pair, warp and
   certainty within 1e-3; Q5 `lightglue_pretrained` (superpoint) equal to
   `lightglue` on its resolved conf and weights, through the attention
   kernels, and `mixed` (grid_extractor + SuperPoint's dense descriptors)
   giving the grid's keypoints, on the main path's batch. Path Q alone:
   `phase_device`, `phase_build`, `write_megadepth(MD_ROOT)`, `phase_roma`;
22. path R, stage 1 with on-device augmentation (run after path Q, before
   phase 8): `train.main` on path E's config at its widths (SuperPoint 512
   keypoints frozen, LightGlue-9 checkpointed, f32, batch 32) with
   `data.emit_source=true` (procedural 640 x 480 sources, 6 workers) and
   `train.device_augment` at the recipe's homography settings (patch 640 x
   480, difficulty 0.7, max_angle 45): 4 steps and one validation batch of
   8, then `steps_per_dispatch=2` for 2 dispatches. Gates: the workers ship
   `source_image` alone; every augmented tensor on the card; losses finite,
   updates applied; each attention kernel 18 launches a step, 36 a
   dispatch of 2 and 9 a validation batch; `generate_homography_pairs` on
   the card against the host's CPU on one key and 4 sources (the same
   lambda for every item, `H_0to1` within 1e-4 relative, images within
   1e-3); cross-view photoconsistency (median below 0.05); a step through
   the kernels against the plain versions (1e-3). Records ms a step,
   samples/s, busy share and peak memory, the augmentation's device ms for
   a batch of 32, and the `emit_source` loader's samples/s beside path
   E's `lg` loader's;
23. path S, KeyNet + HardNet (after path R): `keynet_affnet_hardnet`
   (2048 keypoints, defaults) with the NN matcher through
   `two_view_pipeline` on path N's 1600 x 1200 pair, random weights from
   seed 0: no port kernel, outputs finite, keypoints inside the image,
   descriptors unit-norm, orientations in [-pi, pi]; the card against the
   host's CPU on a 320 x 240 pair (responses within 1e-3, keypoints equal
   where the top-k's margin exceeds 1e-5); wall and device ms a pair,
   KeyNet's ms alone and the busy share. Paths R and S alone:
   `phase_device`, `phase_build`, `phase_device_augment`, `phase_keynet`;
24. path T, DeepLSD (after path S): `get_model("lines.deeplsd")` with
   `backend: native` (channels 64/128/256) and `package-layout` (the
   deeplsd_md.tar widths) on path N's 1600 x 1200 pair, 250 lines, random
   weights from seed 0: fields finite and in range, lines inside the
   image; wall and device ms, the net's ms against the host vectoriser's
   (the probabilistic Hough of `csrc/hough.cpp`, built in phase 2, and
   numpy), the Hough's ms alone, peak memory. GT fields of 250 random
   segments an image from `fields_from_lines` on the card, vectorised: the
   detections on a planted segment (at least 70%). Three Adam steps of the
   native net on the GT fields' loss at batch 8, 640 x 480 (finite losses,
   every update applied). The nets and the fields at narrow widths on the
   card against the host's CPU (1e-4, 1e-5). No port kernel;
25. path U, data-parallel training (after path T): a child process with
   the environment torchrun gives rank 0 of 1 (started before path T, it
   imports on the host meanwhile and waits for path T) runs `train.main` on path
   E's config (batch 32, 6 workers, 2 steps; procedural sources rendered to
   PPMs first, `lg` off, no validation split) in an NCCL group; its steps
   replayed from the same state, batches and generators without the group
   must equal it bit for bit (losses and parameters); 18 launches of each
   attention kernel a step; ms a step with and without the group on the
   same batches (beside path E's), one all-reduce of the flat gradient
   buffer (bytes, ms). Paths T and U alone: `phase_device`, `phase_build`,
   `phase_deeplsd`, `phase_ddp` (`build/path_tu.py` when present);
26. path V, the int8 serving options and the native estimators (after
   path U, before phase 8): V1 the main path's configuration with
   SuperPoint's `quantize: int8` and LightGlue's `int8_similarity` (the
   main path's weights, checked equal) through `two_view_pipeline`: 12
   `int8_conv`, 12 `int8_requant` and 1 `int8_bmm` launches a forward
   beside 9 + 9 attention, outputs checked; timed in turns with the bf16
   main path (pairs/s), profiled (device ms, busy share, top items); every
   int8 layer at bench's shapes against its plain version (float64 on the
   card): the int32 accumulators, the codes and their scale, the bf16
   heads all equal; the forward's similarity against its plain version,
   equal; int8 against bf16 at tests/test_int8.py's bounds (score map
   correlation > 0.99, dense descriptor cosine min > 0.98 and mean > 0.995,
   each image's keypoint overlap > 0.5, LightGlue's matches with and
   without `int8_similarity` agreeing > 0.95); `int8_conv` (the dense pass)
   and `int8_bmm` timed against their bounds, plain versions and, for the
   similarity, `torch._int_mm` per item. V2 SuperPoint with `s2d_block1`
   against the plain SuperPoint in bf16 within twice the bf16 rounding gap
   (plain bf16 against plain f32), both timed. V3 the eval loops alone on
   paths F and G's caches (`--overwrite_eval`): HPatches with
   `eval.estimator=poselib`, MegaDepth-1500 with `poselib` and with
   `two_view_native` (its RANSACs on the card): seconds, ms a pair, finite
   AUCs; then `two_view_native` on 512 planted matches of a known pose
   (30% outliers): the essential model, R and t within 1 degree, both
   RANSACs on the card. Path V alone needs paths F and G's caches: `phase_device`,
   `phase_build`, `phase_hpatches`, `phase_megadepth`, then `phase_int8`
   with `make_batch(torch.device("cuda"))` (`build/path_v.py` when present).

Each path resets every launch count just before its timed run and reads
them just after. Prints each phase's seconds, the script's, the kernel JSON line, the card
line, and as its last line {"ok": true, "device": {...}}. Full results go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import copy
import importlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from gluefactory_tpu_torch.core.config import merge
from gluefactory_tpu_torch.models import get_model
from gluefactory_tpu_torch.ops import (_build, cuda_attention, cuda_conv, cuda_conv3x3, cuda_detect,
                                       cuda_sinkhorn, int8_conv)
from gluefactory_tpu_torch.ops.assignment import log_optimal_transport
from gluefactory_tpu_torch.scripts_dev import profile_npack, profile_stream_conv
from gluefactory_tpu_torch.scripts_dev.conv_study import bf16_step
from gluefactory_tpu_torch.scripts_dev.timing import cuda_time_ms, device_time_ms

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
DEVICE = "cuda"

# H100 SXM published peaks (dense): bf16 tensor cores, f32 outside them, HBM
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# special-function units (exp2, log2): 16 results per clock per SM (the CUDA
# programming guide's throughput table for compute capability 9.0) x 132 SMs
# x 1.98 GHz boost clock
PEAK_SFU = 16 * 132 * 1.98e9

KERNEL_MODULES = (cuda_attention, cuda_sinkhorn, cuda_detect, cuda_conv, cuda_conv3x3, int8_conv)
SMS = 132  # replaced by the card's SM count in phase_device

# main path (bench.py's configuration)
PAIRS, IMAGE, KEYPOINTS, LAYERS, DIM, HEADS = 4, 1024, 2048, 9, 256, 4
HEAD_DIM = DIM // HEADS
FORWARDS = 20  # timed forwards of each path (after one warm-up)
REDUCED_KEYPOINTS = 512

# path B: gluefactory_tpu/configs/superpoint+superglue-official.yaml, model
# section (plus force_num_keypoints, as on the main path)
SUPERGLUE_CONF = {
    "extractor": {"name": "superpoint", "max_num_keypoints": KEYPOINTS,
                  "detection_threshold": 0.0, "nms_radius": 3, "force_num_keypoints": True,
                  "trainable": False},
    "matcher": {"name": "superglue", "filter_threshold": 0.2, "sinkhorn_iterations": 50,
                "descriptor_dim": DIM, "num_heads": HEADS, "n_layers": LAYERS},
}
SINKHORN_ITERS = 50
# Sinkhorn parity beyond path B: (B, M, N, iterations); M = 30 has an all
# -inf row
SINKHORN_SHAPES = [(3, 100, 77, 50), (2, 65, 130, 1), (2, 37, 41, 0), (1, 3, 1, 7),
                   (4, 513, 513, 50), (1, 4097, 4097, 5), (1, 5, 20000, 3), (2, 30, 41, 3)]

# kernel vs plain on the card. f32: both sum f32 products in another order.
# bf16: outputs round to bf16 (step 2^-9 at |x| ~ 0.5) and the kernel rounds
# probabilities to bf16 before PV, as the TPU kernel does.
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def all_launches() -> dict:
    out = {}
    for mod in KERNEL_MODULES:
        out.update(mod.launches)
    return out


def reset_all_launches() -> None:
    for mod in KERNEL_MODULES:
        mod.reset_launches()


# --------------------------------------------------------------------------
# 1. device
# --------------------------------------------------------------------------


def phase_device() -> dict:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global SMS
    SMS = torch.cuda.get_device_properties(0).multi_processor_count
    info = {
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
    }
    print(f"device: {json.dumps(info)}", flush=True)
    return info


# --------------------------------------------------------------------------
# 2. build
# --------------------------------------------------------------------------


def phase_build() -> dict:
    t0 = time.perf_counter()
    built = _build.build_all()
    seconds = time.perf_counter() - t0
    for name in _build.SOURCES:
        _build.load(name)
    t1 = time.perf_counter()
    for name in _build.HOST_SOURCES:
        _build.load_host(name)
    host_s = time.perf_counter() - t1
    print(f"build: {len(built)} kernels in {seconds:.1f} s "
          + json.dumps({n: round(b["seconds"], 1) for n, b in built.items()})
          + f"; the host LSD, Hough and LO-RANSAC in {host_s:.1f} s", flush=True)
    return {"seconds": seconds, "host_lsd_seconds": host_s,
            "logs": {n: b["log"] for n, b in built.items()}}


# --------------------------------------------------------------------------
# 3. kernels
# --------------------------------------------------------------------------


def _masks(gen, B, M, N, dev):
    part0 = torch.rand(B, M, generator=gen, device=dev) > 0.3
    part1 = torch.rand(B, N, generator=gen, device=dev) > 0.3
    ones0 = torch.ones(B, M, dtype=torch.bool, device=dev)
    ones1 = torch.ones(B, N, dtype=torch.bool, device=dev)
    return {
        "all_valid": (ones0, ones1),
        "partial": (part0, part1),
        "side0_masked": (torch.zeros_like(ones0), part1),
        "side1_masked": (part0, torch.zeros_like(ones1)),
    }


def _err(a, b) -> float:
    if isinstance(a, tuple):
        return max(_err(x, y) for x, y in zip(a, b))
    return float((a.float() - b.float()).abs().max())


def _self_attention_case(dtype, gen, dev):
    """Self-attention of both views stacked: B = 2 * PAIRS, H = HEADS."""
    B, N = 2 * PAIRS, KEYPOINTS
    q, k, v = (torch.randn(B, HEADS, N, HEAD_DIM, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    return (q, k, v), _masks(gen, B, N, N, dev)


def _cross_attention_case(dtype, gen, dev):
    B, N = PAIRS, KEYPOINTS
    qk0, qk1, v0, v1 = (torch.randn(B, HEADS, N, HEAD_DIM, generator=gen, device=dev).to(dtype)
                        for _ in range(4))
    return (qk0, qk1, v0, v1), _masks(gen, B, N, N, dev)


def _bound(n_ops: float, n_bytes: float, dtype, n_exps: float = 0.0) -> tuple[float, str]:
    """The least time in ms: the larger of the operations over the peak for
    their type (tensor-core products, exponentials on the special-function
    units) and the bytes over the memory rate."""
    t_ops = max(n_ops / PEAK_OPS[dtype], n_exps / PEAK_SFU) * 1e3
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# parity cases beyond the main shapes: a tail (query and key counts that are
# not multiples of the kernels' 128-row tiles) and LightGlue's layout (q and
# k as (B, N, H, D)-ordered views, as rotary and the head split leave them)
TAIL_M, TAIL_N = 777, 1029


def _heads(gen, dev, dtype, B, n, strided=False, d=HEAD_DIM):
    if strided:
        return torch.randn(B, n, HEADS, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
    return torch.randn(B, HEADS, n, d, generator=gen, device=dev).to(dtype)


def _extra_attention_cases(name, dtype, gen, dev) -> dict:
    """{case: kernel arguments}: the tail case and the strided case, each
    with random partial masks; in f32 also path E's shape (512 keypoints,
    batch TRAIN_BATCH, the self-attention over both views stacked) and a
    head dim of 32."""
    shapes = [("tail", 2, TAIL_M, TAIL_N, False, HEAD_DIM),
              ("lightglue_strided", PAIRS, KEYPOINTS, KEYPOINTS, True, HEAD_DIM)]
    if dtype is torch.float32:
        n_e = REDUCED_KEYPOINTS
        b_e = 2 * TRAIN_BATCH if name == "fused_attention" else TRAIN_BATCH
        shapes += [("path_e_512", b_e, n_e, n_e, False, HEAD_DIM), ("head_dim_32", 3, 600, 515, False, 32)]
    cases = {}
    for case, B, M, N, strided, d in shapes:
        m0 = torch.rand(B, M, generator=gen, device=dev) > 0.3
        m1 = torch.rand(B, N, generator=gen, device=dev) > 0.3
        heads = lambda n, strided=False: _heads(gen, dev, dtype, B, n, strided, d)  # noqa: E731
        if name == "fused_attention":
            cases[case] = (heads(M, strided), heads(N, strided), heads(N), m1, m0)
        else:
            cases[case] = (heads(M, strided), heads(N, strided), heads(M), heads(N), m0, m1)
    return cases


def phase_kernels(dev: torch.device) -> list[dict]:
    gen = torch.Generator(device=dev).manual_seed(0)
    F = torch.nn.functional
    results = []
    specs = [
        ("fused_attention", "gluefactory_tpu_torch/csrc/fused_attention.cu",
         "gluefactory_tpu/ops/pallas_attention.py:55", _self_attention_case),
        ("fused_bidirectional_attention",
         "gluefactory_tpu_torch/csrc/fused_bidirectional_attention.cu",
         "gluefactory_tpu/ops/pallas_attention.py:180", _cross_attention_case),
    ]
    for name, source, replaces, make in specs:
        kernel = getattr(cuda_attention, name)
        plain = (cuda_attention.attention_plain if name == "fused_attention"
                 else cuda_attention.bidirectional_plain)
        parity = []
        timing = {}
        for dtype in (torch.float32, torch.bfloat16):
            tensors, masks = make(dtype, gen, dev)
            for case, (m0, m1) in masks.items():
                if name == "fused_attention":  # side 0 = queries, side 1 = keys
                    args = (*tensors, m1, m0)
                else:
                    args = (*tensors, m0, m1)
                got = kernel(*args)
                torch.cuda.synchronize()
                err = _err(got, plain(*args))
                tol = KERNEL_TOL[dtype]
                parity.append({"dtype": str(dtype).split(".")[-1], "masks": case,
                               "max_abs_err": err, "tol": tol})
                if not err <= tol:
                    fail(f"{name} {dtype} {case}: max abs err {err} > {tol}")
                if case == "side0_masked" and name == "fused_attention":
                    if got.abs().max() != 0:
                        fail(f"{name}: masked query rows are not zero")
            for case, args in _extra_attention_cases(name, dtype, gen, dev).items():
                got = kernel(*args)
                torch.cuda.synchronize()
                err = _err(got, plain(*args))
                tol = KERNEL_TOL[dtype]
                parity.append({"dtype": str(dtype).split(".")[-1], "masks": "partial", "case": case,
                               "max_abs_err": err, "tol": tol})
                if not err <= tol:
                    fail(f"{name} {dtype} {case}: max abs err {err} > {tol}")
                del got, args
            if dtype is not torch.bfloat16:
                continue
            # the main path: bf16, every keypoint valid (force_num_keypoints)
            m0, m1 = masks["all_valid"]
            if name == "fused_attention":
                args = (*tensors, m1, m0)
                q, k, v = tensors
                library = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
                BH, M, N, n_in, n_out = q.shape[0] * HEADS, KEYPOINTS, KEYPOINTS, 3, 1
                n_ops = 4.0 * BH * M * N * HEAD_DIM  # QK^T and PV
                n_exps = 1.0 * BH * M * N  # one exponential per logit
            else:
                args = (*tensors, m0, m1)
                qk0, qk1, v0, v1 = tensors
                # both directions as one batched call (M == N): queries
                # [qk0; qk1], keys [qk1; qk0], values [v1; v0]
                sq, sk, sv = torch.cat([qk0, qk1]), torch.cat([qk1, qk0]), torch.cat([v1, v0])
                library = lambda: F.scaled_dot_product_attention(sq, sk, sv)  # noqa: E731
                BH, M, N, n_in, n_out = qk0.shape[0] * HEADS, KEYPOINTS, KEYPOINTS, 4, 2
                n_ops = 6.0 * BH * M * N * HEAD_DIM  # sim once, two PV products
                n_exps = 2.0 * BH * M * N  # a row and a column softmax of sim
            elem = torch.finfo(dtype).bits // 8
            n_bytes = (n_in + n_out) * BH * M * HEAD_DIM * elem + (m0.numel() + m1.numel())
            bound_ms, bound_by = _bound(n_ops, n_bytes, dtype, n_exps)
            # width pruning's scattered masks: half of the tokens of each
            # side active at random (the kernel skips only wholly masked
            # tiles, so this is predicted to take the time of all valid)
            half = [torch.rand(m.shape, generator=gen, device=dev) > 0.5 for m in (m1, m0)]
            scattered = (*args[:-2], *(half if name == "fused_attention" else half[::-1]))
            # device time (calls queued ahead of the device): the wrapper's
            # host time between launches (~0.1 ms of Python) would otherwise
            # hide a kernel this short; the plain events' times are kept
            # beside it
            timing = {
                "ms": device_time_ms(lambda: kernel(*args)),
                "scattered_ms": device_time_ms(lambda: kernel(*scattered)),
                "plain_ms": device_time_ms(lambda: plain(*args), reps=5),
                "library_ms": device_time_ms(library),
                "event_ms": {"kernel": cuda_time_ms(lambda: kernel(*args)),
                             "library": cuda_time_ms(library)},
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "bound_detail": {"tensor_core_ms": n_ops / PEAK_OPS[dtype] * 1e3,
                                 "exponentials": n_exps, "sfu_ms": n_exps / PEAK_SFU * 1e3,
                                 "bytes_ms": n_bytes / PEAK_BYTES * 1e3},
                "timed_shape": [BH // HEADS, HEADS, M, HEAD_DIM],
            }
            if not min(timing["ms"], timing["plain_ms"], timing["library_ms"]) > 0:
                fail(f"{name}: a time is not positive: {timing}")
            timing["ms_over_library"] = timing["ms"] / timing["library_ms"]
        bf16 = [p["max_abs_err"] for p in parity if p["dtype"] == "bfloat16"]
        results.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": max(bf16), "tol": KERNEL_TOL[torch.bfloat16],
            **timing, "parity": parity,
            "f32_max_abs_err": max(p["max_abs_err"] for p in parity if p["dtype"] == "float32"),
            "f32_blocks_per_sm": {d: cuda_attention.f32_blocks_per_sm(d) for d in (32, 64)},
        })
        print(f"kernel {name}: parity ok ({len(parity)} cases), "
              f"{timing['ms']:.3f} ms (plain {timing['plain_ms']:.3f}, "
              f"library {timing['library_ms']:.3f}, half the tokens masked at random "
              f"{timing['scattered_ms']:.4f}, bound {timing['bound_ms']:.4f} "
              f"{timing['bound_by']}, ms/library_ms {timing['ms_over_library']:.3f}); f32 max abs err "
              f"{results[-1]['f32_max_abs_err']:.2e}, f32 body "
              f"{results[-1]['f32_blocks_per_sm']} blocks an SM by head dim", flush=True)
    return results


def _finite_log_err(got, want) -> float:
    """Max abs error over the finite log-probabilities (|x| < 1e6); fails
    unless infinities agree and the -1e9-scale masked entries (f32 step 64
    there) agree to 1e-6 relatively."""
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin):
        fail("log_sinkhorn: infinities differ from the plain version")
    small = fin & (want.abs() < 1e6)
    big = fin & ~small
    if not ((got - want)[big].abs() <= 1e-6 * want[big].abs()).all():
        fail("log_sinkhorn: masked entries differ from the plain version")
    return float((got - want)[small].abs().max())


def check_sinkhorn(dev, gen) -> dict:
    """Through `log_optimal_transport` at SuperGlue's shapes (4 pairs, 2048
    keypoints, 50 iterations): all valid, partial, side 0 fully masked.
    f32 log-sum-exps in another order over 50 iterations: 1e-4."""
    B, K = PAIRS, KEYPOINTS
    tol = 1e-4
    scores = torch.randn(B, K, K, generator=gen, device=dev) * 2.0
    bin_score = torch.tensor(1.0, device=dev)
    m0 = torch.rand(B, K, generator=gen, device=dev) > 0.3
    m1 = torch.rand(B, K, generator=gen, device=dev) > 0.3
    side0 = m0.clone()
    side0[0] = False
    parity = []
    for case, (a, b) in {"all_valid": (None, None), "partial": (m0, m1),
                         "side0_masked": (side0, m1)}.items():
        got = log_optimal_transport(scores, bin_score, SINKHORN_ITERS, a, b)
        want = log_optimal_transport(scores, bin_score, SINKHORN_ITERS, a, b, flash=False)
        torch.cuda.synchronize()
        err = _finite_log_err(got, want)
        parity.append({"dtype": "float32", "masks": case, "max_abs_err": err, "tol": tol})
        if not err <= tol:
            fail(f"log_sinkhorn {case}: max abs err {err} > {tol}")
    # beyond path B: ragged sizes, one row or column, 0 and 1 iterations,
    # several items at once (513^2), rows streamed from device memory
    # (4097^2), v read through L2 (N = 20000), an all -inf row
    for b_, m_, n_, iters in SINKHORN_SHAPES:
        Z = torch.randn(b_, m_, n_, generator=gen, device=dev) * 2.0
        mu = torch.full((b_, m_), -math.log(m_ + n_), device=dev)
        nu = torch.full((b_, n_), -math.log(m_ + n_), device=dev)
        if m_ == 30:
            Z[0, 3] = -float("inf")
        got = cuda_sinkhorn.log_sinkhorn(Z, mu, nu, iters)
        want = cuda_sinkhorn.plain_log_sinkhorn(Z, mu, nu, iters)
        torch.cuda.synchronize()
        if not torch.equal(torch.isnan(got), torch.isnan(want)):
            fail(f"log_sinkhorn {(b_, m_, n_, iters)}: NaNs differ from the plain version")
        err = _finite_log_err(got, want)
        parity.append({"dtype": "float32", "shape": [b_, m_, n_], "iters": iters,
                       "all_inf_row": m_ == 30, "max_abs_err": err, "tol": tol,
                       "plan": cuda_sinkhorn.sinkhorn_plan(b_, m_, n_, SMS)})
        if not err <= tol:
            fail(f"log_sinkhorn {(b_, m_, n_, iters)}: max abs err {err} > {tol}")
        del Z, got, want
    torch.cuda.empty_cache()
    # the kernel's own inputs at the main shape: couplings with bins
    M = N = K + 1
    Z = torch.randn(B, M, N, generator=gen, device=dev)
    log_mu = torch.full((B, M), -math.log(2 * K), device=dev)
    log_nu = torch.full((B, N), -math.log(2 * K), device=dev)
    exps = 2.0 * SINKHORN_ITERS * B * M * N  # one exponential per entry per pass
    t_bytes = (2 * B * M * N * 4 + (M + N) * B * 4) / PEAK_BYTES * 1e3
    t_ops = max(exps / PEAK_SFU, 4 * exps / PEAK_OPS[torch.float32]) * 1e3
    res = {
        "name": "log_sinkhorn", "route": "cuda", "source": "gluefactory_tpu_torch/csrc/log_sinkhorn.cu",
        "replaces": "gluefactory_tpu/ops/pallas_sinkhorn.py:46",
        "launches": 0, "max_abs_err": max(p["max_abs_err"] for p in parity), "tol": tol,
        "ms": cuda_time_ms(lambda: cuda_sinkhorn.log_sinkhorn(Z, log_mu, log_nu, SINKHORN_ITERS)),
        "plain_ms": cuda_time_ms(
            lambda: cuda_sinkhorn.plain_log_sinkhorn(Z, log_mu, log_nu, SINKHORN_ITERS), reps=3),
        "library_ms": None,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bound_detail": {"exponentials": exps, "sfu_ms": exps / PEAK_SFU * 1e3, "bytes_ms": t_bytes},
        "plan": cuda_sinkhorn.sinkhorn_plan(B, M, N, SMS),
        "timed_shape": [B, M, N, SINKHORN_ITERS], "parity": parity,
    }
    return res


# f32 max and compare operations a pixel of the decode as this kernel's
# algorithm needs them on the output pixels (halo not counted): three float
# pools of two van Herk passes at three max an output (18), the three max
# masks' compares, the suppressed map's two selects, the tile reduction's
# compare. The CUDA programming guide's throughput table for compute
# capability 9.0: 64 compare, minimum or maximum results a clock an SM.
DETECT_OPS_PER_PIXEL = 24
PEAK_CMP = 64 * 132 * 1.98e9


def _detect_maps(gen, dev, B, H, W) -> dict:
    """Score maps beyond uniform noise: plateaus of equal bf16 values (8 x 8
    blocks of 16 levels, exact in bf16) and a constant map."""
    levels = torch.randint(1, 17, (B, H // 8, W // 8), generator=gen, device=dev).float() / 32
    return {"plateaus": levels.repeat_interleave(8, 1).repeat_interleave(8, 2),
            "constant": torch.full((B, H, W), 0.25, device=dev)}


def check_detect(dev, gen) -> dict:
    """At the main path's score maps (8 x 1024 x 1024): bf16 and f32, the
    whole buffer and a smaller true size at radius 4 (the main path's) and
    3, every larger radius the kernel takes, H and W that are not multiples
    of a block's 64 x 64 outputs (1000 x 1004), one image, plateaus of equal
    values, a constant map, and one map with equal maxima planted in a tile.
    Comparisons only: the kernel must equal its plain version (tolerance 0,
    indices equal). Timed by device time in bf16 at radius 4, with the true
    size given as path C gives it."""
    B, H = 2 * PAIRS, IMAGE
    base = torch.rand(B, H, H, generator=gen, device=dev) * 0.99 + 0.01
    base[0, 20, 42] = base[0, 23, 41] = 2.0  # tile (5, 10): dy 0 dx 2 and dy 3 dx 1
    small = torch.tensor([[float(H - 100), float(H - 37)]] * B, device=dev)
    odd = torch.rand(2, 1000, 1004, generator=gen, device=dev)
    odd_size = torch.tensor([[950.0, 1000.0], [1004.0, 990.0]], device=dev)
    maps = _detect_maps(gen, dev, B, H, H)
    parity = []

    def hold(case, s, true_size=None, radius=4):
        got = cuda_detect.fused_nms_tile_reduce(s, true_size, radius=radius)
        want = cuda_detect.nms_tile_reduce_plain(s, true_size, radius=radius)
        torch.cuda.synchronize()
        err = _err(got, want)
        parity.append({"dtype": str(s.dtype).split(".")[-1], "case": case, "shape": list(s.shape),
                       "radius": radius, "max_abs_err": err, "tol": 0.0})
        if err != 0 or not torch.equal(got[1], want[1]):
            fail(f"fused_nms_tile_reduce {s.dtype} {case} r{radius}: differs from plain")
        return got

    for dtype in (torch.bfloat16, torch.float32):
        s = base.to(dtype)
        for radius in range(3, cuda_detect._MAX_RADIUS + 1):
            for size_case, true_size in (("full", None), ("smaller", small)):
                if radius > 4 and size_case == "smaller":
                    continue
                got = hold(size_case, s, true_size, radius)
                if got[1][0, 5, 10] != 13:
                    fail("fused_nms_tile_reduce: planted tie not resolved to the smallest dx")
        hold("1000x1004", odd.to(dtype))
        hold("1000x1004 smaller", odd.to(dtype), odd_size, 3)
        hold("B=1", s[:1])
        for case, m in maps.items():
            hold(case, m.to(dtype))
            hold(case, m.to(dtype), small, 3)
        del s
    del odd, maps
    s = base.to(torch.bfloat16)
    full = torch.tensor([[float(H), float(H)]] * B, device=dev)
    n_bytes = s.numel() * 2 + 2 * (B * (H // 4) ** 2 * 4)
    bytes_ms = n_bytes / PEAK_BYTES * 1e3
    ops_ms = DETECT_OPS_PER_PIXEL * s.numel() / PEAK_CMP * 1e3
    res = {
        "name": "fused_nms_tile_reduce", "route": "cuda",
        "source": "gluefactory_tpu_torch/csrc/nms_tile_reduce.cu",
        "replaces": "gluefactory_tpu/ops/pallas_detect.py:202",
        "launches": 0, "max_abs_err": max(p["max_abs_err"] for p in parity), "tol": 0.0,
        "ms": device_time_ms(lambda: cuda_detect.fused_nms_tile_reduce(s, full)),
        "plain_ms": cuda_time_ms(lambda: cuda_detect.nms_tile_reduce_plain(s, full), reps=5),
        "event_ms": cuda_time_ms(lambda: cuda_detect.fused_nms_tile_reduce(s, full)),
        "library_ms": None,
        "bound_ms": max(bytes_ms, ops_ms), "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
        "bound_bytes_ms": bytes_ms, "bound_ops_ms": ops_ms,
        "plan": cuda_detect.detect_plan(4), "timed_shape": [B, H, H], "parity": parity,
    }
    if not res["ms"] > 0:
        fail(f"fused_nms_tile_reduce: a time is not positive: {res['ms']}")
    return res


# path C's four blocks: (name, input NHWC, C_mid, C_out or None, pool)
VGG_BLOCKS = [
    ("conv1b_pool", (2 * PAIRS, IMAGE, IMAGE, 64), 64, None, True),
    ("block2", (2 * PAIRS, IMAGE // 2, IMAGE // 2, 64), 64, 64, True),
    ("block3", (2 * PAIRS, IMAGE // 4, IMAGE // 4, 64), 128, 128, True),
    ("block4", (2 * PAIRS, IMAGE // 8, IMAGE // 8, 128), 128, 128, False),
]


def _vgg_inputs(gen, dev, shape, cm, co):
    ci = shape[-1]
    x = torch.relu(torch.randn(*shape, generator=gen, device=dev))
    w = [torch.randn(3, 3, ci, cm, generator=gen, device=dev) * math.sqrt(2.0 / (9 * ci)),
         torch.randn(cm, generator=gen, device=dev) * 0.1]
    if co is not None:
        w += [torch.randn(3, 3, cm, co, generator=gen, device=dev) * math.sqrt(2.0 / (9 * cm)),
              torch.randn(co, generator=gen, device=dev) * 0.1]
    return x, w


# VGG parity beyond path C: a pooled pair of blocks across the wgmma body's
# strip boundaries, an odd size pooled, C_out 80 and C_in 48 (the CUDA-core
# body for that conv); (name, input NHWC, C_mid, C_out or None, pool)
VGG_EXTRA = [
    ("strip_boundary", (1, 130, 200, 64), 64, 64, True),
    ("odd_pooled", (2, 37, 51, 64), 64, None, True),
    ("c_out_80", (2, 37, 50, 64), 128, 80, True),
    ("c_in_48", (2, 24, 40, 48), 64, None, True),
]


def check_vgg(dev, gen) -> dict:
    """Path C's four blocks (8 images: conv1b + pool at 1024^2 x 64, the
    two-conv blocks with pool, block 4 without), f32 and bf16. f32: the same
    products summed in another order, 1e-4 relative to the largest output.
    bf16: twice the gap that bf16 rounding alone opens (plain bf16 against
    plain f32 on the same bf16 inputs), plus one bf16 step at the largest
    output, for a sum in another order that flips a rounding. Timed in
    bf16 against the plain version and the cuDNN sequence conv2d, relu,
    [conv2d, relu], [max_pool2d] in channels-last; the kernel and the cuDNN
    sequence by device time (block 4 takes ~0.1 ms, under the wrapper's host
    time, so CUDA events around calls as the host issues them would time the
    Python)."""
    F = torch.nn.functional
    parity, blocks = [], []
    for name, shape, cm, co, pool in VGG_BLOCKS + VGG_EXTRA:
        x, w = _vgg_inputs(gen, dev, shape, cm, co)
        for dtype in (torch.float32, torch.bfloat16):
            xd, wd = x.to(dtype), [a.to(dtype) for a in w]
            got = cuda_conv.fused_vgg_block(xd, *wd, pool=pool)
            want = cuda_conv.vgg_block_plain(xd, *wd, pool=pool)
            torch.cuda.synchronize()
            err = _err(got, want)
            if dtype is torch.float32:
                tol = 1e-4 * max(1.0, float(want.abs().max()))
            else:
                ref = cuda_conv.vgg_block_plain(xd.float(), *(a.float() for a in wd), pool=pool)
                tol = 2.0 * _err(want, ref) + bf16_step(float(want.float().abs().max()))
                del ref
            parity.append({"block": name, "dtype": str(dtype).split(".")[-1],
                           "max_abs_err": err, "tol": tol,
                           "convs": cuda_conv.conv_plan(*shape, cm, co, pool, dtype, SMS)})
            if not err <= tol:
                fail(f"fused_vgg_block {name} {dtype}: max abs err {err} > {tol}")
            del got, want
        if name not in {b[0] for b in VGG_BLOCKS}:
            continue
        xd, wd = x.to(torch.bfloat16), [a.to(torch.bfloat16) for a in w]
        xc = xd.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels-last
        wc = [a.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last) if a.dim() == 4
              else a for a in wd]

        def library():
            y = F.relu(F.conv2d(xc, wc[0], wc[1], padding=1))
            if co is not None:
                y = F.relu(F.conv2d(y, wc[2], wc[3], padding=1))
            return F.max_pool2d(y, 2, 2) if pool else y

        B, H, W, ci = shape
        flops = 2.0 * B * H * W * 9 * (ci * cm + (cm * co if co is not None else 0))
        out_c = co if co is not None else cm
        n_bytes = 2 * (xd.numel() + sum(a.numel() for a in wd)
                       + B * H * W * out_c // (4 if pool else 1))
        bound_ms, bound_by = _bound(flops, n_bytes, torch.bfloat16)
        blocks.append({
            "block": name, "shape": list(shape), "c_mid": cm, "c_out": out_c, "pool": pool,
            "gflop": flops / 1e9,
            "convs": cuda_conv.conv_plan(*shape, cm, co, pool, torch.bfloat16, SMS),
            "ms": device_time_ms(lambda: cuda_conv.fused_vgg_block(xd, *wd, pool=pool), reps=10),
            "plain_ms": cuda_time_ms(lambda: cuda_conv.vgg_block_plain(xd, *wd, pool=pool), reps=5),
            "library_ms": device_time_ms(library, reps=10),
            "event_ms": cuda_time_ms(lambda: cuda_conv.fused_vgg_block(xd, *wd, pool=pool), reps=5),
            "bound_ms": bound_ms, "bound_by": bound_by,
        })
        print(f"  vgg {name}: {json.dumps(blocks[-1])}", flush=True)
        del x, w, xd, wd, xc, wc
    torch.cuda.empty_cache()
    total = {k: sum(b[k] for b in blocks) for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    if not min(total["ms"], total["library_ms"]) > 0:
        fail(f"fused_vgg_block: a time is not positive: {total}")
    return {
        "name": "fused_vgg_block", "route": "cuda", "source": "gluefactory_tpu_torch/csrc/vgg_block.cu",
        "replaces": "gluefactory_tpu/ops/pallas_conv.py:177",
        "launches": 0, "max_abs_err": max(p["max_abs_err"] for p in parity if p["dtype"] == "bfloat16"),
        **total, "bound_by": "operations", "library": "sequence of cuDNN calls (conv2d, relu, "
        "conv2d, relu, max_pool2d), channels-last bf16", "times": "sum over path C's four blocks",
        "blocks": blocks, "parity": parity,
    }


# --------------------------------------------------------------------------
# 3b. gradients
# --------------------------------------------------------------------------


def phase_gradients(dev: torch.device) -> dict:
    """Kernel-path gradients against plain-version gradients at small
    shapes, f32 (the backward is the plain version's own, so they agree to
    1e-5, with cuDNN's conv backward made deterministic); a missing grad_fn
    fails."""
    gen = torch.Generator(device=dev).manual_seed(3)
    torch.backends.cudnn.deterministic = True

    def leaf(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).requires_grad_(True)

    m = torch.rand(2, 100, generator=gen, device=dev) > 0.3
    cases = {
        "fused_attention": (cuda_attention.fused_attention, cuda_attention.attention_plain,
                            [leaf(2, 4, 100, 64), leaf(2, 4, 100, 64), leaf(2, 4, 100, 64), m, None]),
        "fused_bidirectional_attention": (
            cuda_attention.fused_bidirectional_attention, cuda_attention.bidirectional_plain,
            [leaf(2, 4, 100, 64), leaf(2, 4, 77, 64), leaf(2, 4, 100, 64), leaf(2, 4, 77, 64), m, None]),
        "fused_vgg_block": (cuda_conv.fused_vgg_block, cuda_conv.vgg_block_plain,
                            [leaf(2, 20, 34, 64), leaf(3, 3, 64, 64, scale=0.05), leaf(64, scale=0.1),
                             leaf(3, 3, 64, 64, scale=0.05), leaf(64, scale=0.1), True]),
        "log_sinkhorn": (cuda_sinkhorn.log_sinkhorn, cuda_sinkhorn.plain_log_sinkhorn,
                         [leaf(2, 65, 70), torch.full((2, 65), -5.0, device=dev).requires_grad_(True),
                          torch.full((2, 70), -5.0, device=dev), 10]),
    }
    res = {}
    for name, (kernel, plain, inputs) in cases.items():
        leaves = [t for t in inputs if torch.is_tensor(t) and t.requires_grad]
        outs = kernel(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        if any(o.grad_fn is None for o in outs):
            fail(f"{name}: the kernel's output carries no grad_fn under autograd")
        cot = [torch.randn(o.shape, generator=gen, device=dev) for o in outs]
        got = torch.autograd.grad(outs, leaves, cot)
        refs = plain(*inputs)
        want = torch.autograd.grad(refs if isinstance(refs, tuple) else (refs,), leaves, cot)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        scale = max(float(b.abs().max()) for b in want)
        res[name] = {"max_abs_err": err, "tol": 1e-5 * max(1.0, scale), "inputs": len(leaves)}
        if not err <= res[name]["tol"]:
            fail(f"{name}: kernel-path gradient differs from the plain version's by {err}")
    s = torch.rand(1, 64, 64, device=dev, requires_grad=True)
    try:
        cuda_detect.fused_nms_tile_reduce(s)
    except RuntimeError:
        res["fused_nms_tile_reduce"] = "raises under grad"
    else:
        fail("fused_nms_tile_reduce returned outputs under grad instead of raising")
    torch.backends.cudnn.deterministic = False
    print(f"gradients: {json.dumps(res)}", flush=True)
    return res


def phase_new_kernels(dev: torch.device) -> list[dict]:
    gen = torch.Generator(device=dev).manual_seed(1)
    results = []
    for check in (check_sinkhorn, check_detect, check_vgg):
        r = check(dev, gen)
        results.append(r)
        print(f"kernel {r['name']}: parity ok ({len(r['parity'])} cases, max abs err "
              f"{r['max_abs_err']:.3g}), {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, "
              f"library {r['library_ms']}, bound {r['bound_ms']:.4f} {r['bound_by']})", flush=True)
    return results


# --------------------------------------------------------------------------
# 4. main path
# --------------------------------------------------------------------------


MAIN_CONF = {
    "extractor": {"name": "superpoint", "max_num_keypoints": KEYPOINTS,
                  "detection_threshold": 0.0, "force_num_keypoints": True,
                  "trainable": False},
    "matcher": {"name": "lightglue", "n_layers": LAYERS, "descriptor_dim": DIM,
                "num_heads": HEADS, "checkpointed": False},
}
# launches per forward of each path's kernels (every other kernel: none)
MAIN_LAUNCHES = {"fused_attention": LAYERS, "fused_bidirectional_attention": LAYERS}
SUPERGLUE_LAUNCHES = {"fused_attention": 4 * LAYERS, "log_sinkhorn": 1}
FUSED_LAUNCHES = {**MAIN_LAUNCHES, "fused_vgg_block": 4, "fused_nms_tile_reduce": 1}


def build_pipeline(device, conf: dict) -> torch.nn.Module:
    torch.manual_seed(0)  # random weights from a seed
    model = get_model("two_view_pipeline").from_conf(conf, device=device)
    return model.to(torch.bfloat16).eval()


def make_batch(device) -> dict:
    rng = np.random.default_rng(0)
    size = torch.tensor([[float(IMAGE), float(IMAGE)]] * PAIRS, device=device)

    def view():
        img = rng.uniform(0, 1, (PAIRS, IMAGE, IMAGE, 1)).astype(np.float32)
        return {"image": torch.from_numpy(img).to(device, torch.bfloat16), "image_size": size}

    return {"view0": view(), "view1": view()}


def check_outputs(pred: dict) -> None:
    B, K = PAIRS, KEYPOINTS
    expect = {
        "keypoints0": ((B, K, 2), torch.float32),
        "keypoint_scores0": ((B, K), torch.bfloat16),
        "keypoint_mask0": ((B, K), torch.bool),
        "descriptors0": ((B, K, DIM), torch.bfloat16),
        "log_assignment": ((B, K + 1, K + 1), torch.float32),
        "matches0": ((B, K), torch.int32),
        "matches1": ((B, K), torch.int32),
        "matching_scores0": ((B, K), torch.float32),
    }
    for key, (shape, dtype) in expect.items():
        t = pred[key]
        if tuple(t.shape) != shape or t.dtype != dtype:
            fail(f"{key}: {tuple(t.shape)} {t.dtype}, expected {shape} {dtype}")
        if t.is_floating_point() and not torch.isfinite(t).all():
            fail(f"{key}: non-finite values")
    for i in "01":
        kp = pred[f"keypoints{i}"]
        if not ((kp >= 0) & (kp <= IMAGE)).all():
            fail(f"keypoints{i} outside the image")
        norms = pred[f"descriptors{i}"].float().norm(dim=-1)
        if not torch.allclose(norms, torch.ones_like(norms), atol=1e-2):
            fail(f"descriptors{i} are not unit vectors")
    m0, m1 = pred["matches0"].long(), pred["matches1"].long()
    for a, b in ((m0, m1), (m1, m0)):
        valid = a >= 0
        if (a >= K).any() or (a < -1).any():
            fail("match index out of range")
        back = torch.gather(b, 1, a.clamp(min=0))
        if not (back[valid] == torch.arange(K, device=a.device).expand(B, K)[valid]).all():
            fail("matches are not mutual: matches0[matches1[j]] != j")


def set_flash(model: torch.nn.Module, enabled: bool) -> None:
    for m in model.modules():
        if hasattr(m, "flash"):
            m.flash = enabled


def compare_with_plain(model, batch, pred, label: str) -> dict:
    """The matcher on REDUCED_KEYPOINTS per view of the path's features:
    kernels vs plain versions, in f32 and in bf16. The bf16 gap is held to
    twice the gap between the plain bf16 and plain f32 runs (bf16 rounding
    alone moves the result that far)."""
    R = REDUCED_KEYPOINTS
    feats = {"view0": {"image_size": batch["view0"]["image_size"]},
             "view1": {"image_size": batch["view1"]["image_size"]}}
    for i in "01":
        for key in ("keypoints", "keypoint_scores", "descriptors", "keypoint_mask"):
            feats[f"{key}{i}"] = pred[f"{key}{i}"][:, :R]
    matcher = model.matcher
    matcher32 = copy.deepcopy(matcher).float()
    feats32 = {k: (v.float() if torch.is_tensor(v) and v.is_floating_point() else v)
               for k, v in feats.items()}

    def run(m, f, flash):
        set_flash(m, flash)
        with torch.no_grad():
            out = m(f)
        torch.cuda.synchronize()
        return out

    k16, p16 = run(matcher, feats, True), run(matcher, feats, False)
    k32, p32 = run(matcher32, feats32, True), run(matcher32, feats32, False)
    set_flash(matcher, True)
    valid = p32["log_assignment"] > -1e8

    def gap(a, b):
        return float((a["log_assignment"] - b["log_assignment"])[valid].abs().max())

    res = {
        "keypoints": R,
        "f32_kernel_vs_plain": gap(k32, p32),
        "f32_tol": 1e-3,
        "bf16_kernel_vs_plain": gap(k16, p16),
        "bf16_plain_vs_f32_plain": gap(p16, p32),
        "bf16_matches0_agreement": float((k16["matches0"] == p16["matches0"]).float().mean()),
    }
    res["bf16_tol"] = max(2.0 * res["bf16_plain_vs_f32_plain"], 1e-2)
    print(f"{label} vs plain at {R} keypoints: {json.dumps(res)}", flush=True)
    if not res["f32_kernel_vs_plain"] <= res["f32_tol"]:
        fail(f"{label}: f32 matcher kernels vs plain {res['f32_kernel_vs_plain']}")
    if not res["bf16_kernel_vs_plain"] <= res["bf16_tol"]:
        fail(f"{label}: bf16 matcher kernels vs plain {res['bf16_kernel_vs_plain']} > {res['bf16_tol']}")
    return res


def pipeline_forward(model, batch, gen):
    """One forward of a pipeline through its entry point, the keypoint fill
    drawn from `gen` seeded with 0."""
    return lambda: model(batch, generator=gen.manual_seed(0))


def drive_path(label: str, forward, per_forward: dict, device_info: dict):
    """One warm-up `forward()` and FORWARDS timed ones through the entry
    point, every launch count reset just before and read just after; each
    kernel must have launched exactly `per_forward` times per forward (0 if
    not named). Returns (result, last prediction)."""
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    with torch.no_grad():
        pred = forward()  # warm-up and first check
        torch.cuda.synchronize()
        check_outputs(pred)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(FORWARDS):
            pred = forward()
        end.record()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    launches = all_launches()
    for name, n in launches.items():
        expected = (FORWARDS + 1) * per_forward.get(name, 0)
        if n != expected:
            fail(f"{name} launched {n} times on {label}, expected {expected}")
    check_outputs(pred)
    ms = start.elapsed_time(end) / FORWARDS
    res = {
        "pairs": PAIRS, "image": IMAGE, "keypoints": KEYPOINTS, "layers": LAYERS,
        "dtype": "bfloat16", "forwards": FORWARDS + 1,
        "ms_per_forward": ms, "ms_per_pair": ms / PAIRS, "pairs_per_s": PAIRS * 1e3 / ms,
        "host_s_per_forward": host_s / FORWARDS,
        "launches": launches,
        "matches_per_pair": float((pred["matches0"] >= 0).sum()) / PAIRS,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
        "card": device_info["nvidia_smi"],
    }
    print(f"{label}: {ms / PAIRS:.3f} ms/pair, {PAIRS * 1e3 / ms:.2f} pairs/s "
          f"({device_info['nvidia_smi']}) launches {json.dumps(launches)}", flush=True)
    return res, pred


def phase_main_path(device_info: dict, batch: dict):
    dev = torch.device(DEVICE)
    model = build_pipeline(dev, MAIN_CONF)
    gen = torch.Generator(device=dev)
    forward = pipeline_forward(model, batch, gen)
    res, pred = drive_path("main path", forward, MAIN_LAUNCHES, device_info)
    res["vs_plain"] = compare_with_plain(model, batch, pred, "main path")
    res["profile"] = profile_forward(forward)
    return res, model


# --------------------------------------------------------------------------
# 5. profile
# --------------------------------------------------------------------------

# device-kernel names of the port's kernels, by family
KERNEL_SYMBOLS = {"attention": ("gf::attention",), "sinkhorn": ("sinkhorn_",),
                  "detect": ("nms_tile_kernel",), "vgg": ("conv3x3_relu", "NpackBody"),
                  "int8": ("igemm_kernel", "requant_kernel")}


def profile_forward(forward, grad: bool = False) -> dict:
    """Device time by kernel over one `forward()` (torch.profiler), under
    no_grad unless `grad`."""
    from torch.profiler import ProfilerActivity, profile

    with (contextlib.nullcontext() if grad else torch.no_grad()), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        forward()
        torch.cuda.synchronize()
    # device-side events only (kernels, copies): operator rows repeat their
    # time, and so do user annotations on the device timeline (the
    # optimizer's step range)
    rows = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0
            and not getattr(ev, "is_user_annotation", False)]
    if not rows:  # the profiler saw no device event: not measured
        print("profile: no device events recorded; device time by kernel not measured", flush=True)
        return {"device_ms": None, "attention_kernel_ms": None, "port_kernel_ms": None, "top": []}
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    port = {fam: sum(r[1] for r in rows if any(sym in r[0] for sym in syms))
            for fam, syms in KERNEL_SYMBOLS.items()}
    top = [{"kernel": k[:120], "ms": ms, "calls": n} for k, ms, n in rows[:25]]
    res = {"device_ms": total, "attention_kernel_ms": port["attention"], "port_kernel_ms": port,
           "top": top, "host_reads": host_read_gaps(prof)}
    print(f"profile: device {total:.2f} ms per forward, port kernels "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in port.items())
          + f"; {res['host_reads']['reads']} device-to-host reads", flush=True)
    return res


def host_read_gaps(prof) -> dict:
    """On the profiled forward's device timeline: each device-to-host copy
    (a value the host reads, waiting for the device), the idle time from
    its end to the next device event, which the host launches only after
    the read, and the device's idle time from the end of the first read to
    the end of the forward (the host issues each later kernel while the
    device waits). Times under the profiler, whose host overhead lengthens
    them."""
    evs = sorted((ev.time_range.start, ev.time_range.end, ev.name) for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(ev, "is_user_annotation", False))
    reads = [j for j, (_, _, name) in enumerate(evs[:-1]) if "DtoH" in name]
    gaps = [(evs[j + 1][0] - evs[j][1]) / 1e3 for j in reads]
    res = {"reads": len(gaps), "idle_after_ms": gaps, "idle_after_total_ms": sum(gaps),
           "span_ms": (evs[-1][1] - evs[0][0]) / 1e3 if evs else None}
    if reads:
        t, busy = evs[reads[0]][1], 0.0
        for start, end, _ in evs[reads[0] + 1:]:
            busy += max(0.0, end - max(start, t))
            t = max(t, end)
        res["after_first_read_ms"] = (evs[-1][1] - evs[reads[0]][1]) / 1e3
        res["idle_after_first_read_ms"] = res["after_first_read_ms"] - busy / 1e3
    return res


# --------------------------------------------------------------------------
# 6. path B: SuperPoint + SuperGlue
# --------------------------------------------------------------------------


def phase_superglue(device_info: dict, batch: dict) -> dict:
    dev = torch.device(DEVICE)
    model = build_pipeline(dev, SUPERGLUE_CONF)
    gen = torch.Generator(device=dev)
    forward = pipeline_forward(model, batch, gen)
    res, pred = drive_path("path B (SuperPoint + SuperGlue)", forward, SUPERGLUE_LAUNCHES, device_info)
    res["conf"] = SUPERGLUE_CONF
    res["vs_plain"] = compare_with_plain(model, batch, pred, "path B")
    res["profile"] = profile_forward(forward)
    return res


# --------------------------------------------------------------------------
# 7. path C: SuperPoint's fused_detect and fused_backbone
# --------------------------------------------------------------------------


def _keypoint_agreement(a: dict, b: dict) -> dict:
    """Keypoints of `a` also found in `b` (per image, any order), and the
    largest score and descriptor gaps over those common keypoints."""
    ids = [(d["keypoints"] - 0.5).round().long() for d in (a, b)]
    ida = ids[0][..., 1] * IMAGE + ids[0][..., 0]
    idb = ids[1][..., 1] * IMAGE + ids[1][..., 0]
    sorted_b, order = idb.sort(dim=1)
    pos = torch.searchsorted(sorted_b, ida).clamp(max=idb.shape[1] - 1)
    found = sorted_b.gather(1, pos) == ida
    j = order.gather(1, pos)
    scores_b = b["keypoint_scores"].float().gather(1, j)
    desc_b = b["descriptors"].float().gather(1, j[..., None].expand(-1, -1, b["descriptors"].shape[-1]))
    return {
        "agreement": float(found.float().mean()),
        "score_gap": float((a["keypoint_scores"].float() - scores_b).abs()[found].max()),
        "descriptor_gap": float((a["descriptors"].float() - desc_b).abs()[found].max()),
    }


def compare_extractors(plain_sp, fused_sp, batch, gen) -> dict:
    """The fused extractor against the opt-ins-off one on the path's 8
    images. f32: the same keypoints (at least 99%; scores within 1e-5 and
    descriptors within 1e-3 on common keypoints: f32 sums in another
    order). bf16: at least 99% of the same keypoints as the bf16 extractor
    with the opt-ins off, and score and descriptor gaps within twice what
    bf16 rounding alone opens (plain bf16 against plain f32), plus one bf16
    step. Which keypoints bf16 rounding alone keeps is recorded but not
    held: the random image's scores tie in bf16, so the top-k picks other
    pixels among equals (about 10% in common with f32)."""
    stacked = {k: torch.cat([batch["view0"][k], batch["view1"][k]]) for k in ("image", "image_size")}
    stacked32 = {**stacked, "image": stacked["image"].float()}

    def run(sp, data):
        with torch.no_grad():
            out = sp(data, generator=gen.manual_seed(0))
        torch.cuda.synchronize()
        return out

    p16, f16 = run(plain_sp, stacked), run(fused_sp, stacked)
    p32 = run(copy.deepcopy(plain_sp).float(), stacked32)
    f32 = run(copy.deepcopy(fused_sp).float(), stacked32)
    res = {"f32": _keypoint_agreement(f32, p32), "bf16": _keypoint_agreement(f16, p16),
           "bf16_rounding": _keypoint_agreement(p16, p32)}
    step = 2.0**-8  # one bf16 step at 1 (scores and descriptor entries are below 1)
    rnd = res["bf16_rounding"]
    res["tol"] = {
        "f32_agreement": 0.99, "f32_score_gap": 1e-5, "f32_descriptor_gap": 1e-3,
        "bf16_agreement": 0.99,
        "bf16_score_gap": 2 * rnd["score_gap"] + step,
        "bf16_descriptor_gap": 2 * rnd["descriptor_gap"] + step,
    }
    print(f"path C vs opt-ins off: {json.dumps(res)}", flush=True)
    t, f, b = res["tol"], res["f32"], res["bf16"]
    if not (f["agreement"] >= t["f32_agreement"] and f["score_gap"] <= t["f32_score_gap"]
            and f["descriptor_gap"] <= t["f32_descriptor_gap"]):
        fail(f"path C f32 extractor differs from the opt-ins-off one: {f}")
    if not (b["agreement"] >= t["bf16_agreement"] and b["score_gap"] <= t["bf16_score_gap"]
            and b["descriptor_gap"] <= t["bf16_descriptor_gap"]):
        fail(f"path C bf16 extractor differs beyond bf16 rounding: {b} vs {rnd}")
    return res


def phase_fused_superpoint(device_info: dict, batch: dict, main_model) -> dict:
    dev = torch.device(DEVICE)
    conf = copy.deepcopy(MAIN_CONF)
    conf["extractor"].update(fused_detect=True, fused_backbone=True)
    model = build_pipeline(dev, conf)
    model.load_state_dict(main_model.state_dict())
    gen = torch.Generator(device=dev)
    forward = pipeline_forward(model, batch, gen)
    res, _ = drive_path("path C (fused detect + backbone)", forward, FUSED_LAUNCHES, device_info)
    res["vs_opt_ins_off"] = compare_extractors(main_model.extractor, model.extractor, batch, gen)
    res["profile"] = profile_forward(forward)
    return res


# --------------------------------------------------------------------------
# 8. conv study: the streaming and N-packed 3x3 conv kernels
# --------------------------------------------------------------------------

# (name, tool, the tool's time key, source, the TPU kernel it replaces)
CONV_STUDY = [
    ("stream_conv3x3", profile_stream_conv, "stream_ms", "gluefactory_tpu_torch/csrc/conv3x3_stream.cu",
     "scripts_dev/profile_stream_conv.py:79"),
    ("npack_conv3x3", profile_npack, "npack_ms", "gluefactory_tpu_torch/csrc/conv3x3_npack.cu",
     "scripts_dev/profile_npack.py:91"),
]
# the plain N-packed version holds f32 cat and P of ~1.6 GB per image, so
# parity runs on 2 images of the conv1b shape, on an odd size that exercises
# the zero ring and partial tiles, and on one whose rows cross two strip
# boundaries (csrc/conv3x3_tile.cuh: 64-row strips of 64 pixels)
CONV_PARITY_SHAPES = ((2, IMAGE, IMAGE, 64), (1, 37, 53, 64), (1, 130, 200, 64))


def conv_work(shape) -> dict:
    """GFLOP of the conv at `shape` (B, H, W, C -> C): the function's, and
    the kernels' own (both compute every input row of every strip, halo
    rows included, over whole 64-pixel columns)."""
    B, H, W, C = shape
    cols = -(-W // cuda_conv3x3.STRIP_COLS) * cuda_conv3x3.STRIP_COLS
    return {"function_gflop": 2.0 * B * H * W * 9 * C * C / 1e9,
            "own_gflop": 2.0 * B * cuda_conv3x3.input_rows(H) * cols * 9 * C * C / 1e9}


def check_conv3x3(dev, gen, name: str) -> list[dict]:
    """The kernel against its plain version: twice the gap that bf16
    rounding alone opens (plain bf16 against plain f32 on the same bf16
    inputs), plus one bf16 step at the largest output, as check_vgg holds
    it. Each wrapper call must add exactly one launch."""
    kernel = getattr(cuda_conv3x3, name)
    plain = getattr(cuda_conv3x3, name + "_plain")
    parity = []
    for shape in CONV_PARITY_SHAPES:
        x = (torch.randn(*shape, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        w = (torch.randn(3, 3, 64, 64, generator=gen, device=dev) * 0.05).to(torch.bfloat16)
        before = all_launches()
        got = kernel(x, w)
        torch.cuda.synchronize()
        after = all_launches()
        if after != {**before, name: before[name] + 1}:
            fail(f"{name}: one wrapper call changed the launch counts {before} -> {after}")
        want = plain(x, w)
        ref = plain(x.float(), w.float())
        err = _err(got, want)
        tol = 2.0 * _err(want, ref) + bf16_step(float(ref.abs().max()))
        parity.append({"shape": list(shape), "dtype": "bfloat16", "max_abs_err": err, "tol": tol})
        if not err <= tol:
            fail(f"{name} {shape}: max abs err {err} > {tol}")
        del x, w, got, want, ref
    torch.cuda.empty_cache()
    return parity


def phase_conv_study(device_info: dict) -> list[dict]:
    """Each kernel against its plain version, then each tool's `main` at the
    conv1b shape with every launch count reset just before and read just
    after: the tool's kernel launched once per wrapper call the tool made,
    every other kernel not at all; the tool's maxdiff within its tol."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(2)
    results = []
    for name, tool, key, source, replaces in CONV_STUDY:
        parity = check_conv3x3(dev, gen, name)
        reset_all_launches()
        res = tool.main()
        launches = all_launches()
        torch.cuda.empty_cache()
        expected = {n: (res["kernel_calls"] if n == name else 0) for n in launches}
        if launches != expected:
            fail(f"{name}: the tool's run launched {launches}, expected {expected}")
        if not res["maxdiff"] <= res["tol"]:
            fail(f"{name}: the tool's maxdiff {res['maxdiff']} against the library conv > {res['tol']}")
        work = conv_work(res["shape"])
        rates = {"ms_over_library": res[key] / res["lib_ms"],
                 "tflops_function": work["function_gflop"] / res[key],
                 "tflops_own": work["own_gflop"] / res[key],
                 "library_tflops": work["function_gflop"] / res["lib_ms"], **work}
        results.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max(p["max_abs_err"] for p in parity),
            "tol": max(p["tol"] for p in parity), "ms": res[key], "plain_ms": res["plain_ms"],
            "library_ms": res["lib_ms"], "bound_ms": res["bound_ms"], "bound_by": res["bound_by"],
            **rates, "shared_plan": cuda_conv3x3.shared_plan(res["shape"][-1]),
            "library": "F.conv2d, channels-last bf16, TF32 off", "timed_shape": res["shape"],
            "tool": res, "parity": parity, "card": device_info["nvidia_smi"],
        })
        print(f"kernel {name}: parity ok ({len(parity)} cases), tool {json.dumps(res)}, "
              f"{json.dumps(rates)}", flush=True)
    return results


# --------------------------------------------------------------------------
# 7b. path D: LightGlue's adaptive pruning, masked and early-exit serving
# --------------------------------------------------------------------------

# bench.py's pruned line: the official serving defaults
SERVING_CONF = {**MAIN_CONF, "matcher": {**MAIN_CONF["matcher"], "depth_confidence": 0.95,
                                         "width_confidence": 0.99}}
EXIT_LAYERS = 5  # forced as bench.py forces it
SERVING_LAUNCHES = {"fused_attention": EXIT_LAYERS, "fused_bidirectional_attention": EXIT_LAYERS}
# scattered masks: the share of tokens width pruning must remove, the
# layers every item runs, and the token-confidence scale at layer 0
PRUNED_SHARE = (0.25, 0.75)
SCATTER_EXIT = 7
CONFIDENCE_SCALE = 100.0


def check_scattered(matcher, pred) -> dict:
    """Kernels against plain versions under scattered active masks at data-
    dependent depth: the serving function on REDUCED_KEYPOINTS of the
    path's features, f32. Layer 0's token-confidence head reads the first
    principal direction of its tokens, scaled by CONFIDENCE_SCALE, with the
    threshold in the widest gap between neighbouring projections of the
    middle fifth (40-60% of the tokens confident: no exit, and no token
    near the threshold); its matchability bias is pushed 30 down (every
    token unmatchable), so the confident tokens are width-pruned; later
    heads are inert until every item exits after SCATTER_EXIT layers.
    Gates: the pruned share within PRUNED_SHARE, exit layers equal, prune
    counts equal on >= 99.9% of tokens, the log assignment within 1e-3
    where both are finite."""
    from gluefactory_tpu_torch.models.matchers.lightglue_serving import make_serving_fn

    R = REDUCED_KEYPOINTS
    feats = {"view0": {"image_size": pred["view0"]["image_size"]},
             "view1": {"image_size": pred["view1"]["image_size"]}}
    for i in "01":
        for key in ("keypoints", "descriptors", "keypoint_mask"):
            t = pred[f"{key}{i}"][:, :R]
            feats[f"{key}{i}"] = t.float() if t.is_floating_point() else t
    matcher = copy.deepcopy(matcher).float()
    # R keypoints are below the card's pruning guard (1024): prune anyway
    matcher.conf = merge(matcher.conf, {"pruning_min_kpts": -1})
    set_flash(matcher, False)
    with torch.no_grad():
        desc0, desc1, enc0, enc1, mask0, mask1 = matcher._encode(feats)
        d0, d1 = matcher.transformers[0](desc0, desc1, enc0, enc1, mask0, mask1)
        # layer 0's head reads the tokens' first principal direction, with
        # the threshold in the widest gap between neighbouring projections
        # of the middle fifth, so no token lies near it
        x = torch.cat([d0[mask0], d1[mask1]])
        mean = x.mean(0)
        u = torch.linalg.svd(x - mean, full_matrices=False).Vh[0]
        proj = ((x - mean) @ u).sort().values
        lo, hi = int(0.4 * len(proj)), int(0.6 * len(proj))
        j = lo + int((proj[lo + 1:hi + 1] - proj[lo:hi]).argmax())
        center, gap = (proj[j] + proj[j + 1]) / 2, float(proj[j + 1] - proj[j])
        th = matcher._confidence_threshold(0)
        lin = matcher.token_confidence[0].token[0]
        lin.weight.copy_(CONFIDENCE_SCALE * u[None])
        lin.bias.fill_(math.log(th / (1 - th)) - CONFIDENCE_SCALE * float(mean @ u + center))
        matcher.log_assignment[0].matchability.bias.sub_(30.0)
        for i in range(1, len(matcher.token_confidence)):
            head = matcher.token_confidence[i].token[0]
            head.weight.zero_()
            head.bias.fill_(20.0 if i >= SCATTER_EXIT - 1 else -20.0)
    serve = make_serving_fn(matcher)
    with torch.no_grad():
        plain = serve(feats)
        set_flash(matcher, True)
        reset_all_launches()
        got = serve(feats)
        launches = all_launches()
    torch.cuda.synchronize()
    exits = got["exit_layer"].long()
    valid = torch.cat([feats["keypoint_mask0"], feats["keypoint_mask1"]], 1)
    prune = torch.cat([got["prune0"], got["prune1"]], 1)
    prune_plain = torch.cat([plain["prune0"], plain["prune1"]], 1)
    pruned = (prune < 1 + exits[:, None])[valid]
    la, la_plain = got["log_assignment"], plain["log_assignment"]
    both = torch.isfinite(la) & torch.isfinite(la_plain) & (la_plain > -1e8)
    res = {
        "keypoints": R, "exit_layer": got["exit_layer"].tolist(), "projection_gap": gap,
        "exit_layer_plain": plain["exit_layer"].tolist(), "launches": launches,
        "pruned_share": float(pruned.float().mean()),
        "prune_agreement": float((prune == prune_plain)[valid].float().mean()),
        "log_assignment_max_abs_err": float((la - la_plain)[both].abs().max()), "tol": 1e-3,
    }
    print(f"path D scattered masks vs plain at {R} keypoints: {json.dumps(res)}", flush=True)
    if not PRUNED_SHARE[0] <= res["pruned_share"] <= PRUNED_SHARE[1]:
        fail(f"path D scattered: width pruning removed {res['pruned_share']} of the tokens")
    if res["exit_layer"] != res["exit_layer_plain"] or set(res["exit_layer"]) != {SCATTER_EXIT - 1}:
        fail(f"path D scattered: exit layers {res['exit_layer']} vs plain {res['exit_layer_plain']}")
    if launches != {**{k: 0 for k in launches}, "fused_attention": SCATTER_EXIT,
                    "fused_bidirectional_attention": SCATTER_EXIT}:
        fail(f"path D scattered: {launches} launches, expected {SCATTER_EXIT} of each attention kernel")
    if not res["prune_agreement"] >= 0.999:
        fail(f"path D scattered: prune counts agree on {res['prune_agreement']} of the tokens")
    if not res["log_assignment_max_abs_err"] <= res["tol"]:
        fail(f"path D scattered: log assignment differs by {res['log_assignment_max_abs_err']}")
    return res


def phase_serving(device_info: dict, batch: dict) -> dict:
    """bench.py's pruned configuration (depth_confidence 0.95,
    width_confidence 0.99) on the main path's weights and batch, the token-
    confidence heads biased so every item exits after EXIT_LAYERS layers:
    the pipeline's masked pruned forward (each attention kernel 9 times a
    forward) and the early-exit serving function after the extractor
    (EXIT_LAYERS times), each driven, timed and profiled; exit layers,
    prune counts and the log assignment compared across the two; then the
    scattered-mask check."""
    from bench_torch import extractor_pipeline, forced_exit
    from gluefactory_tpu_torch.models.matchers.lightglue_serving import make_serving_fn

    dev = torch.device(DEVICE)
    model = build_pipeline(dev, SERVING_CONF)
    random_heads = copy.deepcopy(model.matcher)
    forced_exit(model.matcher, EXIT_LAYERS)
    gen = torch.Generator(device=dev)
    masked_forward = pipeline_forward(model, batch, gen)
    masked, mpred = drive_path("path D masked pruned forward", masked_forward, MAIN_LAUNCHES,
                               device_info)
    extract = extractor_pipeline(model, dev)
    serving = make_serving_fn(model.matcher)

    def serving_forward():
        feats = extract(batch, generator=gen.manual_seed(0))
        return {**feats, **serving({**batch, **feats})}

    served, spred = drive_path("path D serving", serving_forward, SERVING_LAUNCHES, device_info)
    if not (spred["exit_layer"] == EXIT_LAYERS - 1).all():
        fail(f"path D serving: exit layers {spred['exit_layer'].tolist()}, expected {EXIT_LAYERS - 1}")
    for k in ("prune0", "prune1"):
        if not torch.equal(spred[k], mpred[k]):
            fail(f"path D: {k} differs between the serving function and the masked forward")
    valid = mpred["log_assignment"] > -1e8
    gap = float((spred["log_assignment"] - mpred["log_assignment"])[valid].abs().max())
    tol = KERNEL_TOL[torch.bfloat16]
    if not gap <= tol:
        fail(f"path D: serving and masked log assignments differ by {gap} > {tol}")
    res = {"masked": masked, "serving": served, "serving_vs_masked_max_abs_err": gap, "tol": tol,
           "bit_equal": torch.equal(spred["log_assignment"], mpred["log_assignment"]),
           "exit_layer": spred["exit_layer"].tolist(),
           "prune_counts": torch.bincount(spred["prune0"].flatten().long()).tolist()}
    for name, r, forward in (("masked", masked, masked_forward), ("serving", served, serving_forward)):
        r["profile"] = profile_forward(forward)
        dev_ms = r["profile"]["device_ms"]
        r["busy_share"] = None if dev_ms is None else dev_ms / r["ms_per_forward"]
        print(f"path D {name}: wall {r['ms_per_forward']:.2f} ms, device {dev_ms} ms, busy share "
              f"{r['busy_share']}, {r['pairs_per_s']:.2f} pairs/s ({device_info['nvidia_smi']})",
              flush=True)
    res["scattered"] = check_scattered(random_heads, {**mpred, **batch})
    return res


# --------------------------------------------------------------------------
# 9. path E: stage-1 training (superpoint+lightglue_homography.yaml)
# --------------------------------------------------------------------------

TRAIN_YAML = "gluefactory_tpu_torch/configs/superpoint+lightglue_homography.yaml"
TRAIN_BATCH, TRAIN_STEPS, VAL_BATCHES, TIMED_STEPS, WARMUP_STEPS = 32, 2, 2, 3, 2
# the stage-1 runs' validation batch: a loader worker builds a whole batch,
# so the one batch of 32 after the steps took ~13 s alone on the card's host
VAL_BATCH = 8
PUBLISHED_BATCH = 128
TRAIN_EXPERIMENT = "chip_smoke_path_e"
# the run's cuts of the published recipe, printed and recorded
TRAIN_REDUCED = {
    "data.synthetic_images": "procedural images instead of revisitop1m, which is not on disk",
    "data.batch_size": f"{TRAIN_BATCH} instead of {PUBLISHED_BATCH}, for the smoke's time",
    "data.num_workers": "6 instead of 14 (the card's machine has 8 cores)",
    "length": f"{TRAIN_STEPS} training steps (one epoch) and {VAL_BATCHES} validation batches of "
              f"{VAL_BATCH} (the config's batch for validation too)",
    "--no_tensorboard --no_capture": "no writer, no log capture",
}
TRAIN_ARGV = [
    TRAIN_EXPERIMENT, "--conf", str(ROOT / TRAIN_YAML), "--no_tensorboard", "--no_capture",
    "--max_val_iters", str(VAL_BATCHES),
    f"data.synthetic_images={TRAIN_BATCH * TRAIN_STEPS + VAL_BATCH * VAL_BATCHES}",
    f"data.train_size={TRAIN_BATCH * TRAIN_STEPS}", f"data.val_size={VAL_BATCH * VAL_BATCHES}",
    f"data.batch_size={TRAIN_BATCH}", f"data.val_batch_size={VAL_BATCH}", "data.num_workers=6",
    "train.epochs=1", "train.log_every_iter=1", "train.eval_every_iter=1000000",
]
# launches of each attention kernel: a train step runs every layer forward
# and again in its checkpoint's recompute; a validation batch once
STEP_LAUNCHES = {"fused_attention": 2 * LAYERS, "fused_bidirectional_attention": 2 * LAYERS}
VAL_LAUNCHES = {"fused_attention": LAYERS, "fused_bidirectional_attention": LAYERS}
TRAIN_TOL = 1e-3  # kernels vs plain versions in a train step, relative, f32


def _check_launches(label: str, got: dict, want: dict) -> None:
    for name, n in got.items():
        if n != want.get(name, 0):
            fail(f"{label}: {name} launched {n} times, expected {want.get(name, 0)}")


def run_trainer(argv: list, first_state: list | None = None) -> tuple[list, float, dict, torch.nn.Module]:
    """`gluefactory_tpu_torch.train.main(argv)`, every launch count reset
    just before and read just after: (each train step's (losses, metrics,
    info), seconds, launches, the trained model). With `first_state`, a
    copy of the model's state dict before its first step is appended to it."""
    from gluefactory_tpu_torch import train

    records = []
    call = train.TrainStep.__call__

    def recorded(self, batch, *args):
        if first_state is not None and not records:
            first_state.append({k: v.clone() for k, v in self.model.state_dict().items()})
        out = call(self, batch, *args)
        records.append(out)
        return out

    train.TrainStep.__call__ = recorded
    reset_all_launches()
    t0 = time.perf_counter()
    try:
        model = train.main(argv)
        torch.cuda.synchronize()
    finally:
        train.TrainStep.__call__ = call
    return records, time.perf_counter() - t0, all_launches(), model


def drive_training() -> tuple[dict, torch.nn.Module]:
    """The trainer's CLI entry point on the shipped config with
    TRAIN_ARGV's overrides (`run_trainer`). Every step's losses must be
    finite and every update applied; each attention kernel must launch
    exactly STEP_LAUNCHES a step and VAL_LAUNCHES a validation batch."""
    from gluefactory_tpu_torch.settings import TRAINING_PATH

    shutil.rmtree(Path(TRAINING_PATH, TRAIN_EXPERIMENT), ignore_errors=True)
    records, seconds, launches, model = run_trainer(TRAIN_ARGV)
    _check_launches("path E", launches, {k: TRAIN_STEPS * n + VAL_BATCHES * VAL_LAUNCHES[k]
                                         for k, n in STEP_LAUNCHES.items()})
    if len(records) != TRAIN_STEPS:
        fail(f"path E: {len(records)} train steps, expected {TRAIN_STEPS}")
    losses = [{k: float(v) for k, v in r[0].items()} for r in records]
    for i, (step_losses, (_, _, info)) in enumerate(zip(losses, records)):
        if not all(math.isfinite(v) for v in step_losses.values()):
            fail(f"path E: step {i} has a non-finite loss term: {step_losses}")
        if not bool(info["ok"]):
            fail(f"path E: the update of step {i} was not applied")
    return {"seconds": seconds, "launches": launches, "losses": losses,
            "grad_norms": [float(r[2]["grad_norm"]) for r in records]}, model


def check_restore(model, argv: list = TRAIN_ARGV, experiment: str = TRAIN_EXPERIMENT,
                  updates: int = TRAIN_STEPS, label: str = "path E") -> dict:
    """The last checkpoint holds the trained weights, and `--restore`
    reloads them bit-equal (the run has no epoch left, so it trains none);
    the checkpoint counts `updates` applied updates."""
    from gluefactory_tpu_torch import train
    from gluefactory_tpu_torch.utils.experiments import get_last_checkpoint, load_checkpoint

    path = get_last_checkpoint(experiment)
    payload = load_checkpoint(path, map_location=DEVICE)
    restored = train.main(argv + ["--restore"])
    trained, saved, back = model.state_dict(), payload["model"], restored.state_dict()
    for k, v in trained.items():
        if not (torch.equal(v, saved[k]) and torch.equal(v, back[k])):
            fail(f"{label}: checkpoint round trip changed {k}")
    steps = {int(s["step"]) for s in payload["optimizer"]["state"].values()}
    if payload["step"]["updates"] != updates or steps != {updates}:
        fail(f"{label}: checkpoint counts {payload['step']}, optimizer steps {steps}")
    return {"checkpoint": path.name, "tensors": len(trained), "bit_equal": True}


def _grad_norm(module) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(
        [p.grad.norm() for p in module.parameters() if p.grad is not None]))


def _float_buffers(model) -> dict:
    return {n: b.clone() for n, b in model.named_buffers() if b.is_floating_point()}


def _set_buffers(model, buffers: dict) -> None:
    with torch.no_grad():
        for n, b in model.named_buffers():
            if n in buffers:
                b.copy_(buffers[n])


def train_step_vs_plain(model, batch, label: str = "path E", step_launches: dict = STEP_LAUNCHES) -> dict:
    """One forward with loss and backward on `batch` through the kernels and
    through the plain versions (`flash` off), each from the model's buffers
    as they were (a train-mode BatchNorm updates its running statistics):
    the loss and the matcher's gradient global norm within TRAIN_TOL
    relative, every entry of the matcher's gradients within TRAIN_TOL of
    the plain gradients' global norm, the running statistics after the two
    steps within TRAIN_TOL of their tensor's largest entry, and the
    kernels' launches in the step exactly `step_launches`. The buffers are
    set back after."""
    gen = torch.Generator(device=DEVICE)
    before = _float_buffers(model)
    out = {}
    for flash in (True, False):
        _set_buffers(model, before)
        set_flash(model, flash)
        model.zero_grad(set_to_none=True)
        reset_all_launches()
        _, losses, _ = model.forward_with_loss(batch, train=True, generator=gen.manual_seed(0))
        losses["total"].mean().backward()
        torch.cuda.synchronize()
        out[flash] = (float(losses["total"].mean().detach()), float(_grad_norm(model.matcher)),
                      all_launches(), [p.grad.clone() for p in model.matcher.parameters()
                                       if p.grad is not None], _float_buffers(model))
    _set_buffers(model, before)
    set_flash(model, True)
    model.zero_grad(set_to_none=True)
    _check_launches(f"{label} step, kernels", out[True][2], step_launches)
    _check_launches(f"{label} step, plain versions", out[False][2], {})
    res = {"loss": out[True][0], "plain_loss": out[False][0], "grad_norm": out[True][1],
           "plain_grad_norm": out[False][1], "tol": TRAIN_TOL}
    res["loss_rel_err"] = abs(res["loss"] - res["plain_loss"]) / abs(res["plain_loss"])
    res["grad_norm_rel_err"] = abs(res["grad_norm"] - res["plain_grad_norm"]) / res["plain_grad_norm"]
    # every gradient entry, against the plain gradients' global norm
    res["grad_max_rel_err"] = max(float((a - b).abs().max()) for a, b in zip(out[True][3], out[False][3])
                                  ) / res["plain_grad_norm"]
    stats, plain_stats = ({n: v for n, v in o[4].items() if "running" in n} for o in (out[True], out[False]))
    res["running_stats"] = len(stats)
    res["running_stats_max_rel_err"] = max(
        [float((v - plain_stats[n]).abs().max() / plain_stats[n].abs().max().clamp(min=1e-12))
         for n, v in stats.items()], default=0.0)
    res["running_stats_moved"] = min([float((v - before[n]).abs().max()) for n, v in stats.items()],
                                     default=None)
    if not (res["loss_rel_err"] <= TRAIN_TOL and res["grad_norm_rel_err"] <= TRAIN_TOL
            and res["grad_max_rel_err"] <= TRAIN_TOL and len(out[True][3]) == len(out[False][3])
            and res["running_stats_max_rel_err"] <= TRAIN_TOL):
        fail(f"{label}: a train step through the kernels differs from the plain versions: {res}")
    return res


def _timed_micro_batches(model, batches, gen, accum: int, mixed_precision=None, conf=None,
                         label: str = "path E", timed: int = TIMED_STEPS,
                         step_launches: dict = STEP_LAUNCHES, group=None,
                         warmup: int = WARMUP_STEPS):
    """(TrainStep under `grad_accumulation` accum with a fresh optimizer,
    ms per micro-batch over TIMED_STEPS after WARMUP_STEPS by CUDA events,
    the last micro-batch's outputs); each kernel must launch
    `step_launches` a timed micro-batch. `conf`: the trainer's conf (path
    E's by default); `group`: the data-parallel group of the step."""
    from gluefactory_tpu_torch import train
    from gluefactory_tpu_torch.core.config import merge

    conf = merge((conf or train_conf()).train, {"grad_accumulation": accum})
    optimizer, schedule = train.build_optimizer(conf, model, TRAIN_STEPS)
    step = train.TrainStep(model, optimizer, schedule, accum,
                           max_updates=warmup + timed + 1,
                           mixed_precision=mixed_precision, group=group)
    for i in range(warmup):
        step(batches[i % len(batches)], gen.manual_seed(i))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(timed):
        out = step(batches[i % len(batches)], gen.manual_seed(i))
    end.record()
    torch.cuda.synchronize()
    _check_launches(f"{label} timed steps ({mixed_precision or 'f32'})", all_launches(),
                    {k: timed * n for k, n in step_launches.items()})
    return step, start.elapsed_time(end) / timed, out


def time_training(model, batches, device_info, mixed_precision=None, conf=None,
                  batch: int = TRAIN_BATCH, label: str = "path E", accum2: bool = True,
                  timed: int = TIMED_STEPS, step_launches: dict = STEP_LAUNCHES) -> dict:
    """ms per train step (TrainStep with a fresh optimizer on batches
    already on the card; CUDA events over TIMED_STEPS after WARMUP_STEPS),
    samples/s, peak memory, and the device time and busy share of one
    step; then, in f32 with `accum2`, ms per micro-batch under
    grad_accumulation 2, whose NaN-skip runs the optimizer on every
    micro-batch. `conf`, `batch`: the trainer's conf and batch (path E's by
    default)."""
    gen = torch.Generator(device=DEVICE)
    step, ms, (losses, _, info) = _timed_micro_batches(model, batches, gen, 1, mixed_precision,
                                                       conf, label, timed, step_launches)
    if not (bool(info["ok"]) and math.isfinite(float(losses["total"]))):
        fail(f"{label} ({mixed_precision or 'f32'}): a timed step was not applied")
    res = {"mixed_precision": mixed_precision, "ms_per_step": ms,
           "samples_per_s": batch * 1e3 / ms,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
           "batch": batch, "steps": timed, "card": device_info["nvidia_smi"]}
    res["profile"] = profile_forward(lambda: step(batches[0], gen.manual_seed(0)), grad=True)
    dev_ms = res["profile"]["device_ms"]
    res["device_ms_per_step"] = dev_ms
    res["busy_share"] = None if dev_ms is None else dev_ms / ms
    del step
    if mixed_precision or not accum2:
        return res
    step, ms2, (losses, _, info) = _timed_micro_batches(model, batches, gen, 2)
    if not (bool(info["ok"]) and math.isfinite(float(losses["total"]))):
        fail("path E: a timed micro-batch under grad_accumulation 2 was not kept")
    res["grad_accumulation_2"] = {"ms_per_micro_batch": ms2, "updates": step.updates,
                                  "extra_ms_over_one": ms2 - ms}
    return res


def attention_at_training_shapes(dev, dtype=torch.float32) -> list[dict]:
    """Each attention kernel at path E's shapes (every token valid), in
    `dtype`: forward device time against its bound, its plain version and
    SDPA, and forward + backward (the plain version's gradient) against
    SDPA's."""
    return attention_at_shapes(dev, dtype, 512, TRAIN_BATCH, "path E")


def attention_at_shapes(dev, dtype, N: int, pairs: int, path: str, backward: bool = True,
                        names=("fused_attention", "fused_bidirectional_attention")) -> list[dict]:
    """Each attention kernel of `names` at N tokens a view for `pairs` pairs
    (self attention over both views, 2 * pairs; cross attention, pairs),
    every token valid, in `dtype`: as `attention_at_training_shapes`, the
    backward only with `backward`."""
    gen = torch.Generator(device=dev).manual_seed(5)
    F = torch.nn.functional
    D = HEAD_DIM
    label = "float32" if dtype == torch.float32 else "bfloat16"
    out = []
    for name, B in (("fused_attention", 2 * pairs), ("fused_bidirectional_attention", pairs)):
        if name not in names:
            continue
        n_in = 3 if name == "fused_attention" else 4
        xs = [torch.randn(B, HEADS, N, D, generator=gen, device=dev).to(dtype).requires_grad_()
              for _ in range(n_in)]
        ones = torch.ones(B, N, dtype=torch.bool, device=dev)
        kernel = getattr(cuda_attention, name)
        plain = cuda_attention.attention_plain if n_in == 3 else cuda_attention.bidirectional_plain
        if n_in == 3:
            q, k, v = xs
            args = (q, k, v, ones, ones)
            lib_in = (q, k, v)
            n_ops, n_exps, n_out = 4.0 * B * HEADS * N * N * D, 1.0 * B * HEADS * N * N, 1
        else:
            qk0, qk1, v0, v1 = xs
            args = (qk0, qk1, v0, v1, ones, ones)
            lib_in = (torch.cat([qk0, qk1]), torch.cat([qk1, qk0]), torch.cat([v1, v0]))
            n_ops, n_exps, n_out = 6.0 * B * HEADS * N * N * D, 2.0 * B * HEADS * N * N, 2
        n_bytes = (n_in + n_out) * B * HEADS * N * D * xs[0].element_size() + 2 * ones.numel()
        bound_ms, bound_by = _bound(n_ops, n_bytes, dtype, n_exps)

        def fwd_bwd(fn):
            outs = fn()
            outs = outs if isinstance(outs, tuple) else (outs,)
            torch.autograd.grad(outs, xs, [torch.ones_like(o) for o in outs])

        with torch.no_grad():
            got, want = kernel(*args), plain(*args)
            err = _err(got, want)
            res = {"name": name, "shape": [B, HEADS, N, D], "dtype": label,
                   "max_abs_err": err, "tol": KERNEL_TOL[dtype],
                   "ms": device_time_ms(lambda: kernel(*args)),
                   "plain_ms": device_time_ms(lambda: plain(*args), reps=5),
                   "library_ms": device_time_ms(lambda: F.scaled_dot_product_attention(*lib_in)),
                   "bound_ms": bound_ms, "bound_by": bound_by}
        if not err <= KERNEL_TOL[dtype]:
            fail(f"{name} at {path}'s shapes, {label}: max abs err {err}")
        line = (f"{path} {name} at {res['shape']} {label}: {res['ms']:.4f} ms (plain "
                f"{res['plain_ms']:.3f}, SDPA {res['library_ms']:.4f}, bound {bound_ms:.4f} {bound_by})")
        if backward:
            res["fwd_bwd_ms"] = device_time_ms(lambda: fwd_bwd(lambda: kernel(*args)), reps=5)
            res["backward_ms"] = res["fwd_bwd_ms"] - res["ms"]
            res["library_fwd_bwd_ms"] = device_time_ms(
                lambda: fwd_bwd(lambda: F.scaled_dot_product_attention(*lib_in)), reps=5)
            line += (f"; forward + backward {res['fwd_bwd_ms']:.3f} ms (backward {res['backward_ms']:.3f}), "
                     f"SDPA {res['library_fwd_bwd_ms']:.3f}")
        out.append(res)
        print(line, flush=True)
        del xs, args, lib_in, got, want
    return out


def published_batch_fits(model, batches) -> dict:
    """One train step at the published batch (PUBLISHED_BATCH pairs, the
    timed batches repeated): whether it fits in the card's memory."""
    from gluefactory_tpu_torch import train

    n = PUBLISHED_BATCH // TRAIN_BATCH
    batch = {k: (torch.cat([b[k] for b in (batches * n)[:n]]) if torch.is_tensor(v) else
                 {kk: torch.cat([b[k][kk] for b in (batches * n)[:n]]) for kk in v})
             for k, v in batches[0].items() if k in ("view0", "view1", "H_0to1")}
    optimizer, schedule = train.build_optimizer(train_conf().train, model, TRAIN_STEPS)
    step = train.TrainStep(model, optimizer, schedule, max_updates=1)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        losses, _, info = step(batch, torch.Generator(device=DEVICE).manual_seed(0))
        torch.cuda.synchronize()
        res = {"fits": True, "first_step_s": time.perf_counter() - t0,
               "ok": bool(info["ok"]), "loss": float(losses["total"])}
    except torch.cuda.OutOfMemoryError as e:
        res = {"fits": False, "error": str(e).splitlines()[0]}
    res["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    model.zero_grad(set_to_none=True)
    del batch, step, optimizer
    torch.cuda.empty_cache()
    return res


def _loss_and_grad(model, batch, bf16: bool, flash: bool) -> tuple:
    """(loss, the matcher's gradient global norm, launches) of one forward
    with loss and backward from the model's state, in bf16 as the trainer's
    `mixed_precision: bf16` runs it (bf16 copies of the parameters and the
    images) or in f32, through the kernels or the plain versions."""
    from gluefactory_tpu_torch import train

    set_flash(model, flash)
    model.zero_grad(set_to_none=True)
    reset_all_launches()
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    fb = train._ForwardBackward(model)
    if bf16:
        cast = {"model." + n: p.to(torch.bfloat16) for n, p in model.named_parameters()}
        losses, _ = torch.func.functional_call(fb, cast, (train.bf16_batch(batch), gen))
    else:
        losses, _ = fb(batch, gen)
    torch.cuda.synchronize()
    out = (float(losses["total"].detach().float().mean()), float(_grad_norm(model.matcher)),
           all_launches())
    set_flash(model, True)
    model.zero_grad(set_to_none=True)
    return out


def bf16_step_vs_plain(model, batch) -> dict:
    """One bf16 step through the kernels against one through the plain
    versions, from the same state: loss and the matcher's gradient norm
    within twice the relative gap that bf16 rounding alone opens (plain
    bf16 against plain f32; at least 1e-2, as phase 3's bf16 gates)."""
    k16, p16, p32 = (_loss_and_grad(model, batch, bf16, flash)
                     for bf16, flash in ((True, True), (True, False), (False, False)))
    _check_launches("path E bf16 step, kernels", k16[2], STEP_LAUNCHES)
    _check_launches("path E bf16 step, plain versions", p16[2], {})
    rel = lambda a, b: abs(a - b) / abs(b)
    res = {"loss": k16[0], "plain_loss": p16[0], "f32_plain_loss": p32[0],
           "grad_norm": k16[1], "plain_grad_norm": p16[1], "f32_plain_grad_norm": p32[1],
           "loss_rel_err": rel(k16[0], p16[0]), "grad_norm_rel_err": rel(k16[1], p16[1]),
           "bf16_rounding_loss_gap": rel(p16[0], p32[0]),
           "bf16_rounding_grad_norm_gap": rel(p16[1], p32[1])}
    res["loss_tol"] = max(2 * res["bf16_rounding_loss_gap"], 1e-2)
    res["grad_norm_tol"] = max(2 * res["bf16_rounding_grad_norm_gap"], 1e-2)
    if not (math.isfinite(res["loss"]) and res["loss_rel_err"] <= res["loss_tol"]
            and res["grad_norm_rel_err"] <= res["grad_norm_tol"]):
        fail(f"path E bf16: a step through the kernels differs from the plain versions: {res}")
    return res


FOLDER_IMAGES, FOLDER_BATCH = 48, 16
FOLDER_EXPERIMENT = "chip_smoke_folder"


class _Procedural(torch.utils.data.Dataset):
    """Procedural 640 x 480 images `offset` ... `offset + n - 1` (the
    homography dataset's `synthetic_images` seeds) as uint8, rendered in a
    loader's workers."""

    def __init__(self, n: int, offset: int = 0):
        self.n, self.offset = n, offset

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        from gluefactory_tpu_torch.data.homographies import generate_synthetic_image

        return (generate_synthetic_image(self.offset + i) * 255).astype(np.uint8)


def procedural_images(n: int, offset: int = 0):
    """`_Procedural(n, offset)`'s images in order, 6 workers rendering."""
    loader = torch.utils.data.DataLoader(_Procedural(n, offset), batch_size=None, num_workers=6)
    return (img.numpy() for img in loader)


def write_image_folder(folder: Path) -> dict:
    """FOLDER_IMAGES procedural 640 x 480 images, JPEG (quality 95) through
    Pillow where it is importable, else binary PPM, and `list.txt` naming
    them."""
    try:
        from PIL import Image
    except ImportError:
        Image = None
    shutil.rmtree(folder, ignore_errors=True)
    folder.mkdir(parents=True)
    for i, img in enumerate(procedural_images(FOLDER_IMAGES, 1000)):
        if Image is not None:
            Image.fromarray(img).save(folder / f"{i:03d}.jpg", quality=95)
        else:
            h, w = img.shape[:2]
            (folder / f"{i:03d}.ppm").write_bytes(f"P6\n{w} {h}\n255\n".encode() + img.tobytes())
    fmt = "jpeg" if Image is not None else "ppm"
    names = sorted(p.name for p in folder.iterdir())
    (folder / "list.txt").write_text("\n".join(names) + "\n")
    return {"pillow": Image is not None, "format": fmt, "images": FOLDER_IMAGES}


def phase_folder_run() -> dict:
    """Path E's recipe on images from a folder: the loader's samples/s
    from the files (6 workers, 3 batches, from the loader's start),
    then 2 training steps and a validation batch through `train.main` with
    `data.image_dir` and `data.image_list`."""
    from gluefactory_tpu_torch.settings import TRAINING_PATH

    folder = ROOT / "outputs" / "chip_smoke_images"
    res = write_image_folder(folder)
    print(f"folder run: {FOLDER_IMAGES} images as {res['format']} (Pillow found: {res['pillow']})",
          flush=True)
    data = {"image_dir": str(folder), "image_list": "list.txt", "synthetic_images": 0,
            "batch_size": FOLDER_BATCH, "train_size": 2 * FOLDER_BATCH, "val_size": FOLDER_BATCH}
    argv = [FOLDER_EXPERIMENT, "--conf", str(ROOT / TRAIN_YAML), "--no_tensorboard", "--no_capture",
            "--max_val_iters", "1", "data.num_workers=6", "train.epochs=1",
            "train.log_every_iter=1", "train.eval_every_iter=1000000",
            *(f"data.{k}={v}" for k, v in data.items())]
    conf = merge(train_conf(), {"data": {**data, "train_size": 3 * FOLDER_BATCH}})
    res["loader_samples_per_s"], _ = loader_rate(conf.data)
    print(f"folder run loader: {res['loader_samples_per_s']:.1f} samples/s from {res['format']} files "
          f"(6 workers)", flush=True)
    shutil.rmtree(Path(TRAINING_PATH, FOLDER_EXPERIMENT), ignore_errors=True)
    records, res["seconds"], res["launches"], _ = run_trainer(argv)
    _check_launches("folder run", res["launches"],
                    {k: 2 * n + VAL_LAUNCHES[k] for k, n in STEP_LAUNCHES.items()})
    if len(records) != 2:
        fail(f"folder run: {len(records)} train steps, expected 2")
    res["losses"] = [float(r[0]["total"]) for r in records]
    if not (all(math.isfinite(v) for v in res["losses"]) and all(bool(r[2]["ok"]) for r in records)):
        fail(f"folder run: a step was not applied or its loss is not finite: {res['losses']}")
    res["argv"] = argv
    shutil.rmtree(folder, ignore_errors=True)
    print(f"folder run: 2 steps and 1 validation batch in {res['seconds']:.1f} s, losses "
          f"{res['losses']}, launches {json.dumps(res['launches'])}", flush=True)
    return res


def _cat_batches(batches: list):
    """Collated batches (nested dicts of tensors and lists) as one batch."""
    first = batches[0]
    if isinstance(first, dict):
        return {k: _cat_batches([b[k] for b in batches]) for k in first}
    if torch.is_tensor(first):
        return torch.cat(batches)
    return [x for b in batches for x in b]


def loader_rate(data_conf, keep: int = 0, dataset: str = "homographies",
                merge: int = 1, max_samples: int | None = None) -> tuple[float, list]:
    """samples/s of a dataset's training loader (the homography dataset's
    by default) over its whole split, or its first `max_samples`, from the
    loader's start (its workers' start-up included: with 6 workers a batch
    from each is in flight at once, so the rate of the batches after the
    first would count their overlap), and the first `keep` batches on the
    card, each made of `merge` of the loader's batches."""
    from gluefactory_tpu_torch.data import get_dataset
    from gluefactory_tpu_torch.data.base_dataset import prepare_batch

    loader = get_dataset(dataset)(data_conf).get_data_loader("train", pin_memory=True)
    raw, samples = [], 0
    t0 = time.perf_counter()
    for b in loader:
        samples += len(b["idx"])
        if len(raw) < keep * merge:
            raw.append(b)
        if max_samples is not None and samples >= max_samples and len(raw) >= keep * merge:
            break
    rate = samples / (time.perf_counter() - t0)
    del loader
    batches = [{k: v for k, v in prepare_batch(_cat_batches(raw[i:i + merge]), DEVICE).items()
                if k not in ("name", "idx", "scene")} for i in range(0, len(raw) - merge + 1, merge)]
    return rate, batches


def phase_training(device_info: dict) -> dict:
    """Path E: the trainer on the shipped stage-1 config at full width
    (SuperPoint 512 keypoints frozen, LightGlue-9 d=256 with checkpointed
    layers, 640 x 480, f32, `lg` photometry), cut as TRAIN_REDUCED says."""
    print(f"path E reduced: {json.dumps(TRAIN_REDUCED)}; host cores (os.cpu_count): "
          f"{os.cpu_count()}", flush=True)
    run, model = drive_training()
    print(f"path E: {TRAIN_STEPS} steps and {VAL_BATCHES} validation batches in "
          f"{run['seconds']:.1f} s, launches {json.dumps(run['launches'])}, losses finite, every "
          f"update applied; total {run['losses'][0]['total']:.4f} -> {run['losses'][-1]['total']:.4f}",
          flush=True)
    res = {"reduced": TRAIN_REDUCED, "argv": TRAIN_ARGV, "run": run, "restore": check_restore(model),
           "cpu_count": os.cpu_count()}
    # the loader alone on the host's cores (6 workers): the whole training
    # split from the loader's start (worker start-up included); its 2
    # batches are kept for the timed steps
    res["loader_samples_per_s"], batches = loader_rate(train_conf().data, keep=TRAIN_STEPS)
    print(f"path E loader: {res['loader_samples_per_s']:.1f} samples/s with lg photometry "
          f"(6 workers, {os.cpu_count()} cores)", flush=True)
    res["vs_plain"] = train_step_vs_plain(model, batches[0])
    print(f"path E step vs plain: {json.dumps(res['vs_plain'])}", flush=True)
    res["timing"] = time_training(model, batches, device_info)
    t = res["timing"]
    print(f"path E timing: {t['ms_per_step']:.2f} ms/step, {t['samples_per_s']:.1f} samples/s, "
          f"busy share {t['busy_share']}, peak {t['peak_memory_gib']:.2f} GiB "
          f"({device_info['nvidia_smi']})", flush=True)
    print(f"path E grad_accumulation 2: {json.dumps(t['grad_accumulation_2'])}", flush=True)
    res["pace"] = "loader" if res["loader_samples_per_s"] < t["samples_per_s"] else "step"
    print(f"path E pace: the {res['pace']} sets it (loader {res['loader_samples_per_s']:.1f} "
          f"samples/s, step {t['samples_per_s']:.1f} samples/s)", flush=True)
    res["attention"] = attention_at_training_shapes(torch.device(DEVICE))
    res["bf16"] = {"vs_plain": bf16_step_vs_plain(model, batches[0])}
    print(f"path E bf16 step vs plain: {json.dumps(res['bf16']['vs_plain'])}", flush=True)
    res["bf16"]["timing"] = time_training(model, batches, device_info, "bf16")
    t16 = res["bf16"]["timing"]
    print(f"path E bf16 timing: {t16['ms_per_step']:.2f} ms/step, device "
          f"{t16['device_ms_per_step']} ms/step, busy share {t16['busy_share']}, peak "
          f"{t16['peak_memory_gib']:.2f} GiB, {t16['samples_per_s']:.1f} samples/s "
          f"({device_info['nvidia_smi']})", flush=True)
    res["bf16"]["attention"] = attention_at_training_shapes(torch.device(DEVICE), torch.bfloat16)
    res["published_batch"] = published_batch_fits(model, batches)
    print(f"path E batch {PUBLISHED_BATCH}: {json.dumps(res['published_batch'])}", flush=True)
    return res


# --------------------------------------------------------------------------
# 10. path F: the HPatches benchmark (superpoint+lightglue-official)
# --------------------------------------------------------------------------

# DATA_PATH of the run; the layout is written under it
HPATCHES_ROOT = ROOT / "outputs" / "chip_smoke_hpatches"
HPATCHES_SEQUENCES = [f"i_chip{k}" for k in range(4)] + [f"v_chip{k}" for k in range(4)]
HPATCHES_SIZE = (1000, 750)  # (w, h) of each procedural scene
HPATCHES_PAIRS = 5 * len(HPATCHES_SEQUENCES)
HPATCHES_REDUCED = {
    "pairs": f"{HPATCHES_PAIRS} of 540: {len(HPATCHES_SEQUENCES)} procedural sequences (4 i_, 4 v_) "
             "written to outputs/chip_smoke_hpatches, since hpatches-sequences-release is not on disk",
}
HPATCHES_ARGV = ["--conf", "superpoint+lightglue-official", "eval.estimator=xla_ransac"]
HPATCHES_DISPATCH = 4  # items_per_dispatch of the grouped run
# predictions of two runs of path F (kernels / plain versions, grouped /
# per item): phase 4's f32 tolerance on the matching scores
EVAL_TOL = 1e-3


def _write_ppm(path: Path, img: np.ndarray) -> None:
    h, w = img.shape[:2]
    path.write_bytes(f"P6\n{w} {h}\n255\n".encode() + (img * 255).round().astype(np.uint8).tobytes())


def write_hpatches(root: Path) -> None:
    """An HPatches layout: per sequence a procedural scene (`1.ppm`) and 5
    views of it with `H_1_k`; i_ sequences change the light (gain, offset
    and noise, H the identity), v_ sequences the viewpoint (a homography
    about the centre: scale, rotation, shift and perspective)."""
    from gluefactory_tpu_torch.data.homographies import generate_synthetic_image, warp_patch

    shutil.rmtree(root, ignore_errors=True)
    w, h = HPATCHES_SIZE
    centre = np.array([[1, 0, w / 2], [0, 1, h / 2], [0, 0, 1.0]])
    for s, seq in enumerate(HPATCHES_SEQUENCES):
        rng = np.random.default_rng(7000 + s)
        d = root / "hpatches-sequences-release" / seq
        d.mkdir(parents=True)
        base = generate_synthetic_image(7000 + s, HPATCHES_SIZE)
        _write_ppm(d / "1.ppm", base)
        for q in range(2, 7):
            if seq.startswith("i_"):
                H = np.eye(3)
                img = base * rng.uniform(0.9, 1.1) + rng.uniform(-0.03, 0.03) \
                    + rng.normal(0, 0.01, base.shape)
            else:
                a, sc = np.deg2rad(rng.uniform(-10, 10)), rng.uniform(0.85, 1.15)
                M = np.array([[sc * np.cos(a), -sc * np.sin(a), rng.uniform(-40, 40)],
                              [sc * np.sin(a), sc * np.cos(a), rng.uniform(-30, 30)],
                              [rng.uniform(-1e-4, 1e-4), rng.uniform(-1e-4, 1e-4), 1.0]])
                H = centre @ M @ np.linalg.inv(centre)
                img = warp_patch(base, H, HPATCHES_SIZE)
            _write_ppm(d / f"{q}.ppm", np.clip(img, 0, 1))
            np.savetxt(str(d / f"H_1_{q}"), H)


def benchmark_weights(path: Path, device, benchmark: str = "hpatches", view: dict | None = None,
                      draw_device=None, config: str = "superpoint+lightglue-official") -> dict:
    """Random weights of the official config's model (`config`, its
    `benchmark` section), from seed 0, drawn as
    flax draws them (lecun-normal kernels, zero biases), then the descriptor
    head's bias set to minus its mean response on one procedural scene (a
    data-dependent init): without it the random descriptors share one
    direction (mean cosine ~0.97) and nothing matches above LightGlue's 0.1
    filter. The scene is `view` (a processed view: image, image_size), else
    path F's 1000 x 750 procedural image at 480 on the short side. The
    draw runs on `draw_device` (default `device`): the CPU's generator gives
    the same weights on every machine. Saved as a state dict for
    `model.weights_file`."""
    from gluefactory_tpu_torch.core.config import from_yaml
    from gluefactory_tpu_torch.data.homographies import generate_synthetic_image
    from gluefactory_tpu_torch.data.preprocess import ImagePreprocessor
    from gluefactory_tpu_torch.eval.io import extract_benchmark_conf, load_model

    conf = extract_benchmark_conf(from_yaml(str(ROOT / f"gluefactory_tpu_torch/configs/{config}.yaml")),
                                  benchmark)
    torch.manual_seed(0)
    model = load_model(conf.model, None, draw_device or device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.ndim >= 2:
                torch.nn.init.normal_(p, std=p[0].numel() ** -0.5)
        model.to(device)
        if view is None:
            view = ImagePreprocessor({"resize": 480, "side": "short"})(
                generate_synthetic_image(6999, HPATCHES_SIZE))
        sp = getattr(model.extractor, "point_extractor", model.extractor)
        if sp is not None and any(True for _ in sp.parameters()):  # SIFT has none
            centre_descriptors(sp, view, device)
        if hasattr(model.matcher, "line_bin_score"):
            gluestick_pass_through(model.matcher)
        elif hasattr(model.matcher, "gnn"):
            superglue_pass_through(model.matcher)
        elif hasattr(model.matcher, "loftr_coarse"):
            loftr_pass_through(model.matcher, view, device)
    torch.save(model.state_dict(), path)
    if sp is None:
        made = "loftr_pass_through on one scene"
    elif any(True for _ in sp.parameters()):
        made = "the descriptor head centred on one scene"
    else:
        made = "no extractor weights"
    return {"seed": 0, "init": f"lecun-normal, zero biases, {made}",
            "keypoints": sp.conf.max_num_keypoints if sp is not None else None}


def centre_descriptors(extractor, view: dict, device) -> None:
    """Shift the extractor's descriptor head by minus its mean response on
    `view` (a processed view: image, image_size), so that random weights do
    not give every descriptor one direction: the vanilla SuperPoint's
    `convDb` bias; the open SuperPoint's last descriptor BatchNorm's bias
    (that head normalises by its running statistics in both modes); DISK's
    last conv's descriptor biases; ALIKED's head has no bias, so each
    `agg_weights[m]` loses the direction of the mean of the features it
    aggregates, which makes the mean descriptor (before its norm) zero."""
    data = {"image": torch.from_numpy(view["image"][None]).to(device),
            "image_size": torch.from_numpy(view["image_size"][None]).to(device)}
    out = {}
    if hasattr(extractor, "desc_head"):  # ALIKED
        head = extractor.desc_head
        hook = head.register_forward_pre_hook(lambda mod, args: out.setdefault("inputs", args))
        extractor(data)
        hook.remove()
        mu = head.sample_features(*out["inputs"]).mean(dim=(0, 1))  # (M, C)
        proj = torch.einsum("mc,mcd->md", mu, head.agg_weights)
        head.agg_weights.sub_(mu[:, :, None] * proj[:, None, :] / (mu * mu).sum(-1)[:, None, None])
        return
    if hasattr(extractor, "unet"):  # DISK
        D = extractor.conf.desc_dim
        hook = extractor.unet.register_forward_hook(lambda mod, i, o: out.setdefault("desc", o[:, :D]))
        bias = extractor.unet.path_up[-1].conv[-1].bias[:D]
    elif hasattr(extractor, "descriptor"):  # SuperPoint, open
        hook = extractor.descriptor[1].register_forward_hook(lambda mod, i, o: out.setdefault("desc", o))
        bias = extractor.descriptor[1].bn.bias
    else:
        hook = extractor.convDb.register_forward_hook(lambda mod, i, o: out.setdefault("desc", o))
        bias = extractor.convDb.bias
    extractor(data)
    hook.remove()
    bias.sub_(out["desc"].mean(dim=(0, 2, 3)))


SG_PASS_SCALE, SG_UPDATE_SCALE = 16.0, 0.1


def superglue_pass_through(matcher) -> None:
    """Random SuperGlue weights rescaled so that the descriptors pass
    through and match: with every weight random, the transport plan is
    near uniform and no score reaches the 0.2 filter (0 matches on path
    J's 20 ZEB pairs at 2048 keypoints, on an H100 80GB HBM3 at 700 W).
    The last layer of the keypoint encoder's and of each GNN layer's MLP
    times SG_UPDATE_SCALE (their updates stay small beside the residual),
    `final_proj` SG_PASS_SCALE x the identity, so the similarity is ~16 x
    the descriptors' cosine."""
    with torch.no_grad():
        matcher.kenc.encoder[-1].weight.mul_(SG_UPDATE_SCALE)
        for layer in matcher.gnn.layers:
            layer.mlp[-1].weight.mul_(SG_UPDATE_SCALE)
        w = matcher.final_proj.weight
        w.copy_(SG_PASS_SCALE * torch.eye(w.shape[0], device=w.device)[..., None])
        matcher.final_proj.bias.zero_()


def gluestick_pass_through(matcher) -> None:
    """`superglue_pass_through` for GlueStick: the last layer of both
    encoders', each GNN layer's and each line layer's MLP times
    SG_UPDATE_SCALE, `final_proj` and `final_line_proj` SG_PASS_SCALE x the
    identity, so that points and lines match by their descriptors."""
    with torch.no_grad():
        for mlp in (matcher.kenc.encoder, matcher.lenc.encoder,
                    *(layer.update.mlp for layer in matcher.gnn.layers),
                    *(layer.mlp for layer in matcher.gnn.line_layers)):
            mlp[-1].weight.mul_(SG_UPDATE_SCALE)
        for proj in (matcher.final_proj, matcher.final_line_proj):
            proj.weight.copy_(SG_PASS_SCALE * torch.eye(proj.weight.shape[0],
                                                         device=proj.weight.device)[..., None])
            proj.bias.zero_()


LOFTR_COARSE_NORM2 = 1000.0  # mean squared norm of the centred coarse features


def loftr_pass_through(matcher, view: dict, device) -> None:
    """Random LoFTR weights made to match, as `superglue_pass_through` does
    for SuperGlue: with every weight random, the post-ReLU stage-3 features
    share one direction and no dual-softmax score reaches the 0.2 threshold
    (0 matches on a 416 x 320 procedural pair on the CPU). Each encoder
    layer's `norm2` scale times SG_UPDATE_SCALE (its update stays small
    beside the residual), and the 1x1 coarse projection loses the mean
    direction of its inputs on `view` (a processed view) and is scaled so
    that the coarse features' mean squared norm is LOFTR_COARSE_NORM2: the
    similarity, over 256 x the temperature 0.1, then separates the cells."""
    for layer in (*matcher.loftr_coarse.layers, *matcher.loftr_fine.layers):
        layer.norm2.weight.mul_(SG_UPDATE_SCALE)
    image = torch.from_numpy(view["image"][None]).to(device)
    if image.shape[-1] == 3:
        image = (image * torch.tensor([0.299, 0.587, 0.114], device=device)).sum(-1, keepdim=True)
    conv = matcher.backbone.layer3_outconv
    seen = {}
    hook = conv.register_forward_pre_hook(lambda mod, args: seen.setdefault("x3", args[0]))
    matcher.backbone(image.permute(0, 3, 1, 2))
    hook.remove()
    x3 = seen["x3"]
    mu = x3.mean(dim=(0, 2, 3))
    w = conv.weight[:, :, 0, 0]
    w.sub_((w @ mu)[:, None] * mu[None] / (mu @ mu))
    norm2 = torch.nn.functional.conv2d(x3, conv.weight).pow(2).sum(1).mean()
    w.mul_((LOFTR_COARSE_NORM2 / norm2).sqrt())


def run_hpatches(argv: list, export_only: bool = False) -> dict:
    """`gluefactory_tpu_torch.eval.hpatches.main(argv)`, as `run_eval_cli`
    runs it."""
    from gluefactory_tpu_torch.eval import hpatches
    from gluefactory_tpu_torch.robust_estimators.homography import xla_ransac

    return run_eval_cli(hpatches.main, hpatches.HPatchesPipeline, xla_ransac, "ransac_homography", argv,
                        export_only)


def run_eval_cli(main_fn, pipeline_cls, estimator_module, ransac_name, argv: list,
                 export_only: bool = False) -> dict:
    """A benchmark CLI's `main(argv)` with every launch count reset just
    before and read just after; the export's and the eval loop's seconds,
    and each call of the estimator module's RANSAC (`ransac_name`, or each
    of a tuple of names; none without an `estimator_module`): its devices
    and time (CUDA events). `export_only`: the eval loop returns nothing (a
    run whose cache alone is compared)."""
    calls, seconds = [], {}
    names = (ransac_name,) if isinstance(ransac_name, str) else tuple(ransac_name)
    ransacs = {n: getattr(estimator_module, n) for n in names} if estimator_module is not None else {}
    original = {k: getattr(pipeline_cls, k) for k in ("get_predictions", "run_eval")}
    methods = dict(original)
    if export_only:
        methods["run_eval"] = lambda self, loader, pred_file: ({}, {}, {})

    def recorder(name):
        def recorded(*args, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = ransacs[name](*args, **kw)
            end.record()
            torch.cuda.synchronize()
            tensors = [a for a in (*args, *out.values()) if torch.is_tensor(a)]
            calls.append({"ransac": name, "devices": sorted({str(t.device) for t in tensors}),
                          "ms": start.elapsed_time(end), "host_ms": 1e3 * (time.perf_counter() - t0),
                          "points": int(args[2].shape[0])})
            return out
        return recorded

    def timed(name):
        def wrapper(self, *a, **k):
            t0 = time.perf_counter()
            out = methods[name](self, *a, **k)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            return out
        return wrapper

    for name in ransacs:
        setattr(estimator_module, name, recorder(name))
    for name in methods:
        setattr(pipeline_cls, name, timed(name))
    reset_all_launches()
    try:
        s, _, r = main_fn(argv)
        launches = all_launches()
    finally:
        for name, fn in ransacs.items():
            setattr(estimator_module, name, fn)
        for name, m in original.items():
            setattr(pipeline_cls, name, m)
    return {"summaries": s, "results": {k: np.asarray(v).tolist() for k, v in r.items()},
            "launches": launches, "seconds": seconds, "ransac_calls": calls}


def _cache(tag: str, benchmark: str = "hpatches") -> dict:
    from gluefactory_tpu_torch.settings import EVAL_PATH
    from gluefactory_tpu_torch.utils.export_predictions import load_predictions

    return load_predictions(Path(EVAL_PATH, benchmark, tag, "predictions.h5"))


def _detections(pred: dict, i: str) -> dict:
    """{position: score} of a view's detections (score above the official
    config's detection_threshold, 0; the cache keeps the padded slots, whose
    positions a top-k over zeros picks in any order)."""
    s = pred[f"keypoint_scores{i}"]
    return dict(zip(map(tuple, pred[f"keypoints{i}"][s > 0].tolist()), s[s > 0].tolist()))


def _match_pairs(pred: dict) -> dict:
    """{(position in view 0, position in view 1): matching score}."""
    k0, k1, m0 = pred["keypoints0"].tolist(), pred["keypoints1"].tolist(), pred["matches0"]
    return {(tuple(k0[i]), tuple(k1[j])): float(pred["matching_scores0"][i])
            for i, j in enumerate(m0.tolist()) if j >= 0}


def compare_caches(a: dict, b: dict) -> dict:
    """Two runs' predictions. SuperPoint's top-k breaks ties between equal
    scores (plateaus of the random model's score map) in an order of its
    own, so detections are compared by position: the sorted scores of each
    view's detections, the views whose detection sets are equal, and on the
    pairs whose sets are equal in both views the matches, by the positions
    they join, and their scores."""
    score_gap, views_equal, pairs_equal, match_gap, agreement = 0.0, 0, 0, 0.0, []
    for name in a:
        equal = True
        for i in "01":
            da, db = _detections(a[name], i), _detections(b[name], i)
            sa, sb = np.sort(list(da.values())), np.sort(list(db.values()))
            score_gap = max(score_gap, float(np.abs(sa - sb).max(initial=0.0)) if len(sa) == len(sb)
                            else math.inf)
            views_equal += da.keys() == db.keys()
            equal &= da.keys() == db.keys()
        if equal:
            pairs_equal += 1
            ma, mb = _match_pairs(a[name]), _match_pairs(b[name])
            shared = ma.keys() & mb.keys()
            agreement.append(len(shared) / max(len(ma), len(mb), 1))
            match_gap = max([match_gap] + [abs(ma[k] - mb[k]) for k in shared])
    return {"items": len(a), "views_equal_detections": views_equal,
            "pairs_equal_detections": pairs_equal, "detection_scores_max_abs_err": score_gap,
            "matching_scores_max_abs_err": match_gap,
            "match_agreement": min(agreement, default=math.nan), "tol": EVAL_TOL}


def _check_agreement(label: str, cmp: dict, items: int = HPATCHES_PAIRS, path: str = "path F") -> None:
    """The detections' scores within the tolerance on every view; matches
    and their scores on the pairs whose detections are equal, of which
    there is at least one."""
    if cmp["items"] != items or cmp["pairs_equal_detections"] == 0:
        fail(f"{path} {label}: no pair with equal detections to compare: {cmp}")
    if not (cmp["detection_scores_max_abs_err"] <= EVAL_TOL
            and cmp["matching_scores_max_abs_err"] <= EVAL_TOL and cmp["match_agreement"] >= 0.99):
        fail(f"{path} {label}: predictions differ beyond {EVAL_TOL}: {cmp}")


def ransac_profile(pred: dict, device_info: dict) -> dict:
    """One RANSAC call (`ops/ransac.py`, 1024 hypotheses) on a cached pair's
    matches: wall ms (CUDA events, after a warm-up) and device ms by kernel
    (torch.profiler): where a pair's RANSAC time goes."""
    from gluefactory_tpu_torch.ops.ransac import ransac_homography
    from gluefactory_tpu_torch.robust_estimators.homography.xla_ransac import bucket_pad

    valid0 = pred["matches0"] >= 0
    p0, p1, valid, n = bucket_pad(pred["keypoints0"][valid0],
                                  pred["keypoints1"][pred["matches0"][valid0]])
    args = [torch.from_numpy(x).to(DEVICE) for x in (p0, p1, valid)]
    return {"matches": n, "bucket": len(valid), **profile_call(lambda: ransac_homography(*args, 0.5)),
            "card": device_info["nvidia_smi"]}


def profile_call(call) -> dict:
    """One call's wall ms (CUDA events over 5 calls after a warm-up) and
    device ms by kernel (torch.profiler), with its device launches."""
    from torch.profiler import ProfilerActivity, profile

    call()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        call()
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    rows = sorted(((ev.key, ev.self_device_time_total / 1e3, ev.count) for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0),
                  key=lambda r: -r[1])
    return {"wall_ms": start.elapsed_time(end) / 5,
            "device_ms": sum(r[1] for r in rows) if rows else None,
            "device_launches": sum(r[2] for r in rows),
            "top": [{"kernel": k[:100], "ms": ms, "calls": c} for k, ms, c in rows[:10]]}


def hpatches_forward_profile(weights: Path) -> dict:
    """`forward_profile` of path F's last pair."""
    from gluefactory_tpu_torch.data import get_dataset

    return forward_profile(weights, "hpatches",
                           get_dataset("hpatches")({}).get_dataset("test")[HPATCHES_PAIRS - 1])


def forward_profile(weights: Path, benchmark: str, item: dict) -> dict:
    """Device busy share of one forward of the official config's
    `benchmark` model on `item`: device ms (torch.profiler) over the
    forward's wall ms (CUDA events, after a warm-up)."""
    from gluefactory_tpu_torch.core.config import from_yaml
    from gluefactory_tpu_torch.data.base_dataset import collate, prepare_batch
    from gluefactory_tpu_torch.eval.io import extract_benchmark_conf, load_model

    conf = extract_benchmark_conf(from_yaml(str(ROOT / "gluefactory_tpu_torch/configs/"
                                                 "superpoint+lightglue-official.yaml")), benchmark)
    model = load_model(merge(conf.model, {"weights_file": str(weights)}), None, DEVICE)
    batch = prepare_batch({k: collate([item[k]]) for k in ("view0", "view1")}, DEVICE)
    forward = lambda: model(batch)
    with torch.no_grad():
        forward()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            forward()
        end.record()
        torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 5
    prof = profile_forward(forward)
    busy = prof["device_ms"] / ms if prof["device_ms"] is not None else None
    return {"wall_ms": ms, "device_ms": prof["device_ms"], "busy_share": busy,
            "attention_kernel_ms": prof["attention_kernel_ms"], "top": prof["top"][:8],
            "image": [int(v) for v in item["view0"]["image_size"]]}


def phase_hpatches(device_info: dict) -> dict:
    """Path F: the HPatches CLI's `main` in process on the official config's
    hpatches section at full width (SuperPoint 1024 keypoints, LightGlue-9
    dense, f32, images at 480 on the short side), `eval.estimator=xla_ransac`,
    cut as HPATCHES_REDUCED says. Gates: the cache's items and keys, 9 + 9
    attention launches a pair, the RANSAC on the card, finite AUCs; a run
    with the plain versions, a rerun with --overwrite_eval that reads the
    cache, and a grouped export against the per-item one."""
    import gluefactory_tpu_torch.settings as tsettings
    from gluefactory_tpu_torch.eval.hpatches import HPatchesPipeline

    card = device_info["nvidia_smi"]
    print(f"path F reduced: {json.dumps(HPATCHES_REDUCED)}", flush=True)
    t0 = time.perf_counter()
    write_hpatches(HPATCHES_ROOT)
    data_path, tsettings.DATA_PATH = tsettings.DATA_PATH, HPATCHES_ROOT
    try:
        weights = HPATCHES_ROOT / "weights.pth"
        res = {"reduced": HPATCHES_REDUCED, "weights": benchmark_weights(weights, DEVICE),
               "write_seconds": time.perf_counter() - t0}
        argv = [*HPATCHES_ARGV, f"model.weights_file={weights}"]
        run = run_hpatches([*argv, "--tag", "chip_smoke", "--overwrite"])
        per_pair = {"fused_attention": LAYERS, "fused_bidirectional_attention": LAYERS}
        _check_launches("path F", run["launches"], {k: HPATCHES_PAIRS * n for k, n in per_pair.items()})
        cache = _cache("chip_smoke")
        keys = set(HPatchesPipeline.export_keys)
        if len(cache) != HPATCHES_PAIRS or any(set(p) != keys for p in cache.values()):
            fail(f"path F: the cache holds {len(cache)} items, expected {HPATCHES_PAIRS} with {keys}")
        calls = run["ransac_calls"]
        card_device = str(torch.empty(0, device=DEVICE).device)
        if not calls or any(c["devices"] != [card_device] for c in calls):
            fail(f"path F: the RANSAC ran on {[c['devices'] for c in calls]}, expected the card")
        s = run["summaries"]
        aucs = {f"H_error_{k}@{t}px": s.get(f"H_error_{k}@{t}px") for k in ("dlt", "ransac") for t in (1, 3, 5)}
        if not all(isinstance(v, float) and math.isfinite(v) for v in aucs.values()):
            fail(f"path F: AUCs not finite: {aucs}")
        export_s, eval_s = run["seconds"]["get_predictions"], run["seconds"]["run_eval"]
        ransac_ms = [c["ms"] for c in calls]
        res["run"] = {**{k: v for k, v in run.items() if k != "results"},
                      "export_pairs_per_s": HPATCHES_PAIRS / export_s,
                      "ransac_ms_per_call": float(np.mean(ransac_ms)),
                      "ransac_ms_median": float(np.median(ransac_ms)),
                      "ransac_ms_first": ransac_ms[0],
                      "ransac_ms_range": [float(min(ransac_ms)), float(max(ransac_ms))],
                      "ransac_host_ms_per_call": float(np.mean([c["host_ms"] for c in calls])),
                      "ransac_calls": len(calls), "matches_per_pair": run["results"]["num_matches"]}
        print(f"path F: {HPATCHES_PAIRS} pairs, launches {json.dumps(run['launches'])}, summaries "
              f"{json.dumps(s)}", flush=True)
        print(f"path F: export {res['run']['export_pairs_per_s']:.2f} pairs/s ({export_s:.1f} s), eval "
              f"loop {eval_s:.2f} s, RANSAC {res['run']['ransac_ms_per_call']:.3f} ms a pair by CUDA "
              f"events over {len(calls)} calls (median {res['run']['ransac_ms_median']:.3f}, first "
              f"{ransac_ms[0]:.3f}; host {res['run']['ransac_host_ms_per_call']:.3f} ms) ({card})",
              flush=True)
        busiest = max(cache, key=lambda n: int((cache[n]["matches0"] >= 0).sum()))
        res["ransac_profile"] = ransac_profile(cache[busiest], device_info)
        print(f"path F RANSAC profile: {json.dumps(res['ransac_profile'])}", flush=True)
        res["forward"] = hpatches_forward_profile(weights)
        print(f"path F forward: {res['forward']['wall_ms']:.2f} ms wall, device "
              f"{res['forward']['device_ms']} ms, busy share {res['forward']['busy_share']} ({card})",
              flush=True)

        plain = run_hpatches([*argv, "model.matcher.flash=False", "--tag", "chip_smoke_plain",
                              "--overwrite"], export_only=True)
        _check_launches("path F plain", plain["launches"], {})
        res["vs_plain"] = compare_caches(cache, _cache("chip_smoke_plain"))
        print(f"path F kernels vs plain versions: {json.dumps(res['vs_plain'])}", flush=True)
        _check_agreement("kernels vs plain", res["vs_plain"])

        mtime = (Path(tsettings.EVAL_PATH, "hpatches", "chip_smoke", "predictions.h5")).stat().st_mtime_ns
        again = run_hpatches([*argv, "--tag", "chip_smoke", "--overwrite_eval"])
        _check_launches("path F --overwrite_eval", again["launches"], {})
        now = (Path(tsettings.EVAL_PATH, "hpatches", "chip_smoke", "predictions.h5")).stat().st_mtime_ns
        if now != mtime or again["summaries"] != s:
            fail("path F: the --overwrite_eval rerun did not reuse the cache or changed the summaries")
        res["overwrite_eval"] = {"seconds": again["seconds"], "summaries_equal": True}
        print(f"path F --overwrite_eval: cache reused, summaries equal, eval loop "
              f"{again['seconds']['run_eval']:.2f} s", flush=True)

        grouped = run_hpatches([*argv, f"items_per_dispatch={HPATCHES_DISPATCH}", "--tag",
                                "chip_smoke_grouped", "--overwrite"], export_only=True)
        forwards = -(-HPATCHES_PAIRS // HPATCHES_DISPATCH)
        _check_launches("path F grouped", grouped["launches"],
                        {k: forwards * n for k, n in per_pair.items()})
        res["grouped"] = {**compare_caches(cache, _cache("chip_smoke_grouped")),
                          "items_per_dispatch": HPATCHES_DISPATCH,
                          "export_pairs_per_s": HPATCHES_PAIRS / grouped["seconds"]["get_predictions"]}
        print(f"path F items_per_dispatch={HPATCHES_DISPATCH} vs per item: {json.dumps(res['grouped'])} "
              f"({card})", flush=True)
        _check_agreement("grouped vs per item", res["grouped"])
    finally:
        tsettings.DATA_PATH = data_path
    res["seconds"] = time.perf_counter() - t0
    res["card"] = card
    return res


# --------------------------------------------------------------------------
# 11. path G: the MegaDepth-1500 benchmark (superpoint+lightglue-official)
# --------------------------------------------------------------------------

# DATA_PATH of the run; the posed-images layout is written under it
MD_ROOT = ROOT / "outputs" / "chip_smoke_megadepth1500"
MD_SCENES = [("scene0", "PINHOLE", 0), ("scene1", "SIMPLE_RADIAL", 1)]  # (scene, camera, seed)
MD_VIEWS, MD_PAIRS_PER_SCENE = 5, 3
MD_SIZE = (1920, 1440)  # (w, h): resized to 1600 on the long side by `area`, depths by `nearest`
MD_PAIRS = MD_PAIRS_PER_SCENE * len(MD_SCENES)
MD_REDUCED = {
    "pairs": f"{MD_PAIRS} of 1500: {len(MD_SCENES)} procedural posed scenes (textured planes ray cast, "
             f"{MD_VIEWS} views each, one PINHOLE and one SIMPLE_RADIAL) written to "
             "outputs/chip_smoke_megadepth1500, since megadepth1500 is not on disk",
    "depth_format": "png (16-bit, 1/256 units) for h5: the card's host has no h5py",
    "weights": "random from seed 0, drawn as path F draws them but on the CPU, the descriptor head "
               "centred on one of the path's views: official weights are not on disk",
}
MD_ARGV = ["--conf", "superpoint+lightglue-official", "eval.estimator=xla_ransac", "eval.ransac_th=0.5",
           "data.depth_format=png"]
MD_DISPATCH = 4  # items_per_dispatch of the grouped run
# the card's RANSAC on synthetic correspondences: points, outlier share,
# normalized threshold; R and t within 1 degree of the truth and 0.5 of the
# CPU's, inlier masks 99% equal (cuSOLVER picks other bases than LAPACK)
MD_SYNTH = {"points": 1024, "outliers": 0.3, "th": 2e-3, "truth_deg": 1.0, "cpu_deg": 0.5,
            "inliers_equal": 0.99}


def write_megadepth(root: Path) -> None:
    from gluefactory_tpu_torch.scripts_dev.posed_scenes import write_posed_images

    shutil.rmtree(root, ignore_errors=True)
    for scene, model, seed in MD_SCENES:
        write_posed_images(root / "megadepth1500", scene, n_views=MD_VIEWS, n_pairs=MD_PAIRS_PER_SCENE,
                           size=MD_SIZE, model=model, seed=seed, workers=MD_VIEWS)


def run_megadepth(argv: list, export_only: bool = False) -> dict:
    from gluefactory_tpu_torch.eval import megadepth1500
    from gluefactory_tpu_torch.robust_estimators.relative_pose import xla_ransac

    return run_eval_cli(megadepth1500.main, megadepth1500.MegaDepth1500Pipeline, xla_ransac,
                        "ransac_essential", argv, export_only)


def essential_on_the_card() -> dict:
    """`ransac_essential` (5pt, 512 hypotheses sets) on synthetic
    correspondences from a known pose, on the card and on the CPU: the
    card's R and t against the truth and the CPU's, the inlier masks."""
    from gluefactory_tpu_torch.eval.utils import angle_error_mat_np, angle_error_vec_np
    from gluefactory_tpu_torch.ops.ransac import ransac_essential
    from gluefactory_tpu_torch.robust_estimators.homography.xla_ransac import bucket_pad
    from gluefactory_tpu_torch.scripts_dev.posed_scenes import synthetic_correspondences

    p0, p1, R, t, _, _ = synthetic_correspondences(np.random.default_rng(11), MD_SYNTH["points"],
                                                   3e-4, MD_SYNTH["outliers"])
    args = [torch.from_numpy(x) for x in bucket_pad(p0, p1)[:3]]
    cpu = ransac_essential(*args, MD_SYNTH["th"], seed=0, n_iters=512)
    card = ransac_essential(*(x.to(DEVICE) for x in args), MD_SYNTH["th"], seed=0, n_iters=512)
    devices = sorted({str(v.device) for v in card.values()})
    Rc, tc = card["R"].cpu().double().numpy(), card["t"].cpu().double().numpy()
    res = {**{k: MD_SYNTH[k] for k in ("points", "outliers", "th")}, "devices": devices,
           "success": bool(card["success"]), "num_inliers": int(card["num_inliers"]),
           "num_inliers_cpu": int(cpu["num_inliers"]),
           "R_err_deg": float(angle_error_mat_np(Rc, R)), "t_err_deg": float(angle_error_vec_np(tc, t)),
           "R_vs_cpu_deg": float(angle_error_mat_np(Rc, cpu["R"].double().numpy())),
           "t_vs_cpu_deg": float(angle_error_vec_np(tc, cpu["t"].double().numpy())),
           "inliers_equal": float((card["inliers"].cpu() == cpu["inliers"]).float().mean())}
    if not (res["success"] and devices == [str(torch.empty(0, device=DEVICE).device)]
            and max(res["R_err_deg"], res["t_err_deg"]) <= MD_SYNTH["truth_deg"]
            and max(res["R_vs_cpu_deg"], res["t_vs_cpu_deg"]) <= MD_SYNTH["cpu_deg"]
            and res["inliers_equal"] >= MD_SYNTH["inliers_equal"]):
        fail(f"path G: ransac_essential on the card: {res}")
    return res


def gt_on_the_card(item: dict, pred: dict) -> dict:
    """`gt_matches_from_pose_depth` on a cached pair's keypoints (in the
    processed images' pixels), its depths, cameras and pose, on the card
    and on the CPU: the matches and visibilities equal."""
    from gluefactory_tpu_torch.data.base_dataset import collate, prepare_batch
    from gluefactory_tpu_torch.geometry.gt_generation import gt_matches_from_pose_depth

    batch = prepare_batch(collate([item]), "cpu")
    kp = [torch.from_numpy(pred[f"keypoints{i}"] * item[f"view{i}"]["scales"])[None] for i in "01"]
    args = (*kp, batch["view0"]["camera"], batch["view1"]["camera"], batch["T_0to1"],
            batch["view0"]["depth"], batch["view1"]["depth"])
    cpu = gt_matches_from_pose_depth(*args)
    card = gt_matches_from_pose_depth(*(a.to(DEVICE) for a in args))
    keys = ("matches0", "matches1", "visible0", "visible1")
    res = {"keypoints": [int(k.shape[1]) for k in kp], "positives": int((cpu["matches0"] >= 0).sum()),
           "unmatched": int((cpu["matches0"] == -1).sum()),
           "devices": sorted({str(card[k].device) for k in keys}),
           "differ": {k: int((card[k].cpu() != cpu[k]).sum()) for k in keys}}
    if any(res["differ"].values()) or res["devices"] != [str(torch.empty(0, device=DEVICE).device)]:
        fail(f"path G: gt_matches_from_pose_depth on the card differs from the CPU: {res}")
    return res


def essential_ransac_profile(item: dict, pred: dict, device_info: dict) -> dict:
    """One call of the relative-pose estimator (`xla_ransac` on the card:
    the 5-point RANSAC over 512 minimal sets) on a cached pair's matches, as
    the eval loop makes it: wall ms, device ms by kernel and device launches
    (`profile_call`)."""
    from gluefactory_tpu_torch.data.base_dataset import collate, prepare_batch
    from gluefactory_tpu_torch.robust_estimators import load_estimator
    from gluefactory_tpu_torch.utils.tensor import rbd

    batch = rbd(prepare_batch(collate([item]), "cpu"))
    m = pred["matches0"] >= 0
    data = {"m_kpts0": pred["keypoints0"][m] * item["view0"]["scales"],
            "m_kpts1": pred["keypoints1"][pred["matches0"][m]] * item["view1"]["scales"],
            "camera0": batch["view0"]["camera"], "camera1": batch["view1"]["camera"]}
    estimator = load_estimator("relative_pose", "xla_ransac")({"ransac_th": 0.5, "device": DEVICE})
    res = {"matches": int(m.sum()), **profile_call(lambda: estimator(data)), "card": device_info["nvidia_smi"]}
    res["busy_share"] = res["device_ms"] / res["wall_ms"] if res["device_ms"] is not None else None
    return res


def phase_megadepth(device_info: dict) -> dict:
    """Path G: the MegaDepth-1500 CLI's `main` in process on the official
    config's megadepth1500 section at full width (SuperPoint 2048
    keypoints, nms 3, LightGlue-9 dense, filter 0.1, f32, 1600 on the long
    side), `eval.estimator=xla_ransac`, `ransac_th 0.5`, cut as MD_REDUCED
    says. Gates: the cache's items and keys, 9 + 9 attention launches a
    pair, the RANSAC on the card, finite match metrics and AUCs; a run with
    the plain versions and a grouped export against the per-item one; an
    --overwrite_eval rerun that reads the cache; the essential RANSAC and
    the pose-depth ground truth on the card against the CPU."""
    import gluefactory_tpu_torch.settings as tsettings
    from gluefactory_tpu_torch.data import get_dataset
    from gluefactory_tpu_torch.eval.megadepth1500 import MegaDepth1500Pipeline

    card = device_info["nvidia_smi"]
    print(f"path G reduced: {json.dumps(MD_REDUCED)}", flush=True)
    t0 = time.perf_counter()
    write_megadepth(MD_ROOT)
    data_path, tsettings.DATA_PATH = tsettings.DATA_PATH, MD_ROOT
    try:
        res = {"reduced": MD_REDUCED, "write_seconds": time.perf_counter() - t0}
        # both attention kernels against their plain versions (and timed) at
        # the path's shape before the path runs them
        res["attention"] = attention_at_shapes(torch.device(DEVICE), torch.float32, KEYPOINTS, 1,
                                               "path G", backward=False)
        items = get_dataset("posed_images")(MegaDepth1500Pipeline(
            {"data": {"depth_format": "png"}}).conf.data).get_dataset("test")
        weights = MD_ROOT / "weights.pth"
        # drawn on the CPU: the card's draw from seed 0 matched nothing at 2048
        # keypoints (matching scores below 0.012), the CPU's 10-21 points a pair
        res["weights"] = benchmark_weights(weights, DEVICE, "megadepth1500", items[MD_PAIRS - 1]["view1"],
                                           draw_device="cpu")
        argv = [*MD_ARGV, f"model.weights_file={weights}"]
        run = run_megadepth([*argv, "--tag", "chip_smoke", "--overwrite"])
        per_pair = {"fused_attention": LAYERS, "fused_bidirectional_attention": LAYERS}
        _check_launches("path G", run["launches"], {k: MD_PAIRS * n for k, n in per_pair.items()})
        cache = _cache("chip_smoke", "megadepth1500")
        keys = set(MegaDepth1500Pipeline.export_keys)
        if len(cache) != MD_PAIRS or any(set(p) != keys for p in cache.values()):
            fail(f"path G: the cache holds {len(cache)} items, expected {MD_PAIRS} with {keys}")
        calls = run["ransac_calls"]
        card_device = str(torch.empty(0, device=DEVICE).device)
        if not calls or any(c["devices"] != [card_device] for c in calls):
            fail(f"path G: the RANSAC ran on {[c['devices'] for c in calls]}, expected the card "
                 f"(matches a pair: {run['results']['num_matches']})")
        s = run["summaries"]
        metrics = {k: s.get(k) for k in ("mepi_prec@1e-4", "mepi_prec@5e-4", "mepi_prec@1e-3",
                                          "mreproj_prec@1px", "mreproj_prec@3px", "mreproj_prec@5px",
                                          "mgt_match_recall@3px", "mgt_match_precision@3px",
                                          "rel_pose_error@5°", "rel_pose_error@10°", "rel_pose_error@20°")}
        if not all(isinstance(v, float) and math.isfinite(v) for v in metrics.values()):
            fail(f"path G: metrics not finite: {metrics}")
        export_s, eval_s = run["seconds"]["get_predictions"], run["seconds"]["run_eval"]
        ransac_ms = [c["ms"] for c in calls]
        res["run"] = {**{k: v for k, v in run.items() if k != "results"},
                      "export_pairs_per_s": MD_PAIRS / export_s,
                      "ransac_ms_per_call": float(np.mean(ransac_ms)),
                      "ransac_ms_median": float(np.median(ransac_ms)),
                      "ransac_ms_first": ransac_ms[0],
                      "ransac_ms_range": [float(min(ransac_ms)), float(max(ransac_ms))],
                      "ransac_host_ms_per_call": float(np.mean([c["host_ms"] for c in calls])),
                      "ransac_calls": len(calls), "matches_per_pair": run["results"]["num_matches"],
                      "rel_pose_error": run["results"]["rel_pose_error"]}
        print(f"path G: {MD_PAIRS} pairs, launches {json.dumps(run['launches'])}, summaries "
              f"{json.dumps(s)}", flush=True)
        print(f"path G: export {res['run']['export_pairs_per_s']:.2f} pairs/s ({export_s:.1f} s), eval "
              f"loop {eval_s:.2f} s, RANSAC {res['run']['ransac_ms_per_call']:.3f} ms a pair by CUDA "
              f"events over {len(calls)} calls (median {res['run']['ransac_ms_median']:.3f}, first "
              f"{ransac_ms[0]:.3f}; host {res['run']['ransac_host_ms_per_call']:.3f} ms) ({card})",
              flush=True)

        names = [items.parent.items[i] for i in range(MD_PAIRS)]
        index = {"/".join(n[1:]): i for i, n in enumerate(names)}
        busiest = max(cache, key=lambda n: int((cache[n]["matches0"] >= 0).sum()))
        item = items[index[busiest]]
        res["ransac_profile"] = essential_ransac_profile(item, cache[busiest], device_info)
        print(f"path G RANSAC profile: {json.dumps(res['ransac_profile'])}", flush=True)
        res["gt_on_card"] = gt_on_the_card(item, cache[busiest])
        print(f"path G gt_matches_from_pose_depth, card vs CPU: {json.dumps(res['gt_on_card'])}", flush=True)
        res["essential_on_card"] = essential_on_the_card()
        print(f"path G ransac_essential on the card: {json.dumps(res['essential_on_card'])} ({card})",
              flush=True)
        res["forward"] = forward_profile(weights, "megadepth1500", item)
        print(f"path G forward: {res['forward']['wall_ms']:.2f} ms wall, device "
              f"{res['forward']['device_ms']} ms, busy share {res['forward']['busy_share']} ({card})",
              flush=True)

        plain = run_megadepth([*argv, "model.matcher.flash=False", "--tag", "chip_smoke_plain",
                               "--overwrite"], export_only=True)
        _check_launches("path G plain", plain["launches"], {})
        res["vs_plain"] = compare_caches(cache, _cache("chip_smoke_plain", "megadepth1500"))
        print(f"path G kernels vs plain versions: {json.dumps(res['vs_plain'])}", flush=True)
        _check_agreement("kernels vs plain", res["vs_plain"], MD_PAIRS, "path G")

        cache_file = Path(tsettings.EVAL_PATH, "megadepth1500", "chip_smoke", "predictions.h5")
        mtime = cache_file.stat().st_mtime_ns
        again = run_megadepth([*argv, "--tag", "chip_smoke", "--overwrite_eval"])
        _check_launches("path G --overwrite_eval", again["launches"], {})
        if cache_file.stat().st_mtime_ns != mtime or again["summaries"] != s:
            fail("path G: the --overwrite_eval rerun did not reuse the cache or changed the summaries")
        res["overwrite_eval"] = {"seconds": again["seconds"], "summaries_equal": True}
        print(f"path G --overwrite_eval: cache reused, summaries equal, eval loop "
              f"{again['seconds']['run_eval']:.2f} s", flush=True)

        grouped = run_megadepth([*argv, f"items_per_dispatch={MD_DISPATCH}", "--tag",
                                 "chip_smoke_grouped", "--overwrite"], export_only=True)
        # a bucket holds one shape signature: the two scenes' cameras
        # (PINHOLE, SIMPLE_RADIAL) differ in their parameters' shape, so
        # each scene is grouped alone
        forwards = len(MD_SCENES) * -(-MD_PAIRS_PER_SCENE // MD_DISPATCH)
        _check_launches("path G grouped", grouped["launches"],
                        {k: forwards * n for k, n in per_pair.items()})
        res["grouped"] = {**compare_caches(cache, _cache("chip_smoke_grouped", "megadepth1500")),
                          "items_per_dispatch": MD_DISPATCH,
                          "export_pairs_per_s": MD_PAIRS / grouped["seconds"]["get_predictions"]}
        print(f"path G items_per_dispatch={MD_DISPATCH} vs per item: {json.dumps(res['grouped'])} "
              f"({card})", flush=True)
        _check_agreement("grouped vs per item", res["grouped"], MD_PAIRS, "path G")
    finally:
        tsettings.DATA_PATH = data_path
    res["seconds"] = time.perf_counter() - t0
    res["card"] = card
    return res


# --------------------------------------------------------------------------
# 12. path H: stage-2 training (superpoint+lightglue_megadepth.yaml)
# --------------------------------------------------------------------------

S2_YAML = "gluefactory_tpu_torch/configs/superpoint+lightglue_megadepth.yaml"
# DATA_PATH of the run; the D2-Net layout is written under megadepth/
S2_ROOT = ROOT / "outputs" / "chip_smoke_stage2"
S2_TRAIN_SCENES, S2_VAL_SCENE = ("scene0", "scene1", "scene2"), "scene3"
# each scene's seed: the training scenes' fill every bin with >= 2 ordered
# pairs to spare
S2_SEEDS = {"scene0": 20, "scene1": 21, "scene2": 23, "scene3": 22}
S2_VIEWS, S2_SIZE = 12, (1600, 1200)  # (w, h): 1024 on the long side by `area`, square-padded
S2_PER_SCENE = 12  # the config's three overlap bins, 4 pairs each
# the trainer runs' micro-batches: a loader worker builds a whole batch,
# so two micro-batches of 16 load in parallel where one of 32 loads alone
S2_BATCH, S2_ACCUM = 16, 2
S2_TIMED_BATCH = 32  # the config's batch, of the timed steps and the attention's shapes
S2_LOADER_BATCH = 4  # the batch of the loader's own rate (all 8 workers busy)
S2_EPOCHS, S2_WORKERS, S2_VAL_BATCH, S2_TIMED_STEPS = 2, 8, 4, 2
# training steps an epoch (micro-batches; the loader drops a partial one)
S2_STEPS = len(S2_TRAIN_SCENES) * S2_PER_SCENE // S2_BATCH
S2_EXPERIMENT = "chip_smoke_path_h"
S2_REDUCED = {
    "data": f"{len(S2_TRAIN_SCENES)} procedural training scenes and 1 validation scene of {S2_VIEWS} "
            "views at 1600 x 1200 in MegaDepth's D2-Net layout (ray-cast planes, HDF5 depths; "
            "scripts_dev/posed_scenes.write_megadepth_scene) written to outputs/chip_smoke_stage2, "
            "the splits as explicit lists, since MegaDepth is not on disk",
    "data.train_num_per_scene": f"{S2_PER_SCENE} instead of 300 (3 bins of {S2_PER_SCENE // 3}; "
                                "a bin is kept with >= 2x its quota of pairs)",
    "data.val_pairs": f"{S2_VAL_BATCH} pairs of the validation scene (overlap 0.1-0.7) for "
                      f"valid_pairs.txt, one validation batch of {S2_VAL_BATCH} an epoch",
    "data.num_workers": f"{S2_WORKERS} instead of 14 (the card's machine has 8 cores)",
    "data.batch_size": f"{S2_BATCH} with grad_accumulation {S2_ACCUM} in the trainer's runs: the "
                       f"config's {S2_TIMED_BATCH}, loaded by two workers at once; the timed steps at "
                       f"{S2_TIMED_BATCH}",
    "length": f"{S2_EPOCHS} epochs of {S2_STEPS // S2_ACCUM} update ({S2_STEPS} micro-batches) instead "
              "of 50 epochs",
    "train.load_experiment": f"path E's experiment ({TRAIN_EXPERIMENT}) for sp+lg_homography",
    "--no_tensorboard --no_capture": "no writer, no log capture",
}
S2_ARGV = [
    S2_EXPERIMENT, "--conf", str(ROOT / S2_YAML), "--no_tensorboard", "--no_capture",
    "--max_val_iters", "1", "data.data_dir=megadepth",
    f"data.train_split=[{','.join(S2_TRAIN_SCENES)}]", f"data.val_split=[{S2_VAL_SCENE}]",
    f"data.train_num_per_scene={S2_PER_SCENE}", f"data.batch_size={S2_BATCH}",
    f"data.val_batch_size={S2_VAL_BATCH}", f"data.num_workers={S2_WORKERS}",
    f"train.grad_accumulation={S2_ACCUM}", f"train.epochs={S2_EPOCHS}", "train.log_every_iter=1",
    "train.eval_every_iter=1000000", f"train.load_experiment={TRAIN_EXPERIMENT}",
]


def write_stage2_data(root: Path) -> dict:
    """The procedural scenes under `root/megadepth` (all scenes' views by one
    pool of S2_WORKERS processes) and `scene_lists/valid_pairs.txt`: the
    validation scene's S2_VAL_BATCH pairs of highest overlap within the
    config's (0.1, 0.7]. Each training scene must fill the three bins (at
    least twice the quota of ordered pairs in each). Returns each scene's
    `write_megadepth_scene` record (the depths' SHA-256)."""
    from gluefactory_tpu_torch.scripts_dev.posed_scenes import write_megadepth_scenes

    shutil.rmtree(root, ignore_errors=True)
    base = root / "megadepth"
    written = write_megadepth_scenes(base, {s: S2_SEEDS[s] for s in (*S2_TRAIN_SCENES, S2_VAL_SCENE)},
                                     S2_VIEWS, S2_SIZE, workers=S2_WORKERS)
    for scene in S2_TRAIN_SCENES:
        m = np.load(base / "scene_info" / f"{scene}.npz", allow_pickle=True)["overlap_matrix"]
        counts = [int(((m > lo) & (m <= hi)).sum()) for lo, hi in ((0.1, 0.3), (0.3, 0.5), (0.5, 0.7))]
        if min(counts) < 2 * (S2_PER_SCENE // 3):
            fail(f"path H: scene {scene}'s overlaps fill the bins with {counts} ordered pairs")
    info = np.load(base / "scene_info" / f"{S2_VAL_SCENE}.npz", allow_pickle=True)
    m = info["overlap_matrix"]
    pairs = sorted(((m[i, j], i, j) for i in range(S2_VIEWS) for j in range(i + 1, S2_VIEWS)
                    if 0.1 < m[i, j] <= 0.7), reverse=True)[:S2_VAL_BATCH]
    names = [str(p).split("/", 1)[1] for p in info["image_paths"]]  # below Undistorted_SfM/
    (base / "scene_lists").mkdir(exist_ok=True)
    (base / "scene_lists" / "valid_pairs.txt").write_text(
        "".join(f"{names[i]} {names[j]}\n" for _, i, j in pairs))
    return written


def check_depths(root: Path, written: dict) -> dict:
    """Every depth file read by `data/hdf5.py` equals the array written
    (SHA-256 of its float32 bytes), with the shape of its image."""
    import hashlib

    from gluefactory_tpu_torch.data.hdf5 import read_dataset

    n = 0
    for scene, rec in written.items():
        info = np.load(root / "megadepth" / "scene_info" / f"{scene}.npz", allow_pickle=True)
        for rel, digest in zip(info["depth_paths"], rec["depth_sha256"]):
            depth = read_dataset(root / "megadepth" / str(rel), "/depth")
            if depth.dtype != np.float32 or depth.shape != S2_SIZE[::-1] or \
                    hashlib.sha256(depth.tobytes()).hexdigest() != digest:
                fail(f"path H: {rel} read by data/hdf5.py differs from the array written")
            n += 1
    return {"files": n, "equal": True}


def drive_stage2(conf) -> tuple[dict, torch.nn.Module]:
    """The trainer's CLI entry point on the stage-2 config with S2_ARGV's
    overrides (`run_trainer`). Gates: finite losses and every update
    applied; each attention kernel launched STEP_LAUNCHES a step and
    VAL_LAUNCHES a validation batch; the model before its first step
    bit-equal to path E's best checkpoint (the warm start); the training
    pairs drawn with `seed + epoch` at each epoch, epoch 1's equal to a
    fresh `sample_new_items(seed + 1)` and not to epoch 0's."""
    from gluefactory_tpu_torch.data import get_dataset, megadepth
    from gluefactory_tpu_torch.settings import TRAINING_PATH
    from gluefactory_tpu_torch.utils.experiments import get_best_checkpoint, load_checkpoint

    shutil.rmtree(Path(TRAINING_PATH, S2_EXPERIMENT), ignore_errors=True)
    sampled, first_state = [], []
    sample = megadepth._MegaDepthItems.sample_new_items

    def recorded(self, seed):
        sample(self, seed)
        if self.split == "train":
            sampled.append((seed, list(self.items)))

    megadepth._MegaDepthItems.sample_new_items = recorded
    try:
        records, seconds, launches, model = run_trainer(S2_ARGV, first_state)
    finally:
        megadepth._MegaDepthItems.sample_new_items = sample
    steps = S2_EPOCHS * S2_STEPS
    _check_launches("path H", launches, {k: steps * n + S2_EPOCHS * VAL_LAUNCHES[k]
                                         for k, n in STEP_LAUNCHES.items()})
    if len(records) != steps:
        fail(f"path H: {len(records)} train steps, expected {steps}")
    losses = [{k: float(v) for k, v in r[0].items()} for r in records]
    for i, (step_losses, (_, _, info)) in enumerate(zip(losses, records)):
        if not all(math.isfinite(v) for v in step_losses.values()):
            fail(f"path H: step {i} has a non-finite loss term: {step_losses}")
        if not bool(info["ok"]):
            fail(f"path H: the update of step {i} was not applied")

    best = load_checkpoint(get_best_checkpoint(TRAIN_EXPERIMENT), map_location="cpu")["model"]
    state = first_state[0]
    if set(state) != set(best) or any(not torch.equal(state[k].cpu(), v) for k, v in best.items()):
        fail("path H: the warm-started model differs from path E's best checkpoint")
    warm = {"experiment": TRAIN_EXPERIMENT, "tensors": len(best), "bit_equal": True}

    seed = int(conf.train.seed)
    seeds = [s for s, _ in sampled]
    dataset = get_dataset("megadepth")(conf.data)
    fresh = dataset.get_dataset("train")
    fresh.sample_new_items(seed + 1)
    if seeds != [int(dataset.conf.seed), seed, seed + 1] or sampled[2][1] != fresh.items or sampled[2][1] == sampled[1][1]:
        fail(f"path H: per-epoch resampling: seeds {seeds}, epoch 1 equal to a fresh draw of seed "
             f"{seed + 1}: {sampled[2][1] == fresh.items}, differs from epoch 0: "
             f"{sampled[2][1] != sampled[1][1]}")
    resampling = {"seeds": seeds, "items": len(fresh.items), "epoch1_equals_fresh_draw": True,
                  "epoch1_differs_from_epoch0": True}
    return {"seconds": seconds, "launches": launches, "losses": losses,
            "grad_norms": [float(r[2]["grad_norm"]) for r in records], "warm_start": warm,
            "resampling": resampling}, model


def gt_batch_on_the_card(model, batch) -> dict:
    """`depth_matcher` (the pipeline's ground truth) on one full training
    batch on the card and on the CPU, at the keypoints the extractor gives
    on the card: matches, assignment and visibilities equal, padding slots
    and the square padding's zero depths included."""
    from gluefactory_tpu_torch.utils.tensor import map_tensor

    with torch.no_grad():
        pred = model(batch, generator=torch.Generator(device=DEVICE).manual_seed(0))
        data = {**batch, **{k: v for k, v in pred.items() if k.startswith("keypoint")}}
        card = model.ground_truth(data)
        cpu = model.ground_truth(map_tensor(data, lambda t: t.cpu() if torch.is_tensor(t) else t))
    res = {"pairs": int(batch["view0"]["image"].shape[0]), "keypoints": int(pred["keypoints0"].shape[1]),
           "positives": int((cpu["gt_matches0"] >= 0).sum()),
           "unmatched": int((cpu["gt_matches0"] == -1).sum()),
           "ignored": int((cpu["gt_matches0"] == -2).sum()),
           "devices": sorted({str(v.device) for v in card.values()}),
           "differ": {k: int((card[k].cpu() != cpu[k]).sum()) for k in cpu}}
    if any(res["differ"].values()) or res["devices"] != [str(torch.empty(0, device=DEVICE).device)]:
        fail(f"path H: depth_matcher on the card differs from the CPU: {res}")
    return res


def phase_stage2(device_info: dict) -> dict:
    """Path H: the trainer on the shipped stage-2 config at full width
    (SuperPoint 2048 keypoints frozen, 1024 square-padded, LightGlue-9
    d=256 checkpointed, depth_matcher GT, f32, TF32 off), warm-started
    from path E's experiment and resampled each epoch, cut as S2_REDUCED
    says; then its gates and numbers."""
    import gluefactory_tpu_torch.settings as tsettings

    card = device_info["nvidia_smi"]
    print(f"path H reduced: {json.dumps(S2_REDUCED)}", flush=True)
    t0 = time.perf_counter()
    written = write_stage2_data(S2_ROOT)
    data_path, tsettings.DATA_PATH = tsettings.DATA_PATH, S2_ROOT
    try:
        res = {"reduced": S2_REDUCED, "argv": S2_ARGV, "write_seconds": time.perf_counter() - t0,
               "depths": check_depths(S2_ROOT, written), "cpu_count": os.cpu_count()}
        conf = train_conf(S2_ARGV, S2_YAML)
        run, model = drive_stage2(conf)
        res["run"] = run
        print(f"path H: {len(run['losses'])} steps and {S2_EPOCHS} validation batches in "
              f"{run['seconds']:.1f} s, launches {json.dumps(run['launches'])}, losses finite, every "
              f"update applied; total {run['losses'][0]['total']:.4f} -> {run['losses'][-1]['total']:.4f}; "
              f"warm start {json.dumps(run['warm_start'])}; resampling {json.dumps(run['resampling'])}; "
              f"depths {json.dumps(res['depths'])}", flush=True)
        res["restore"] = check_restore(model, S2_ARGV, S2_EXPERIMENT, S2_EPOCHS * S2_STEPS // S2_ACCUM,
                                       "path H")
        # a worker makes whole batches: at batch 32 the split's 2 batches
        # would keep 2 of the 8 workers busy, where a real epoch keeps all 8
        # busy; so the loader runs the split in batches of S2_LOADER_BATCH,
        # merged into 2 batches of S2_TIMED_BATCH for the timed steps
        res["loader_samples_per_s"], batches = loader_rate(
            merge(conf.data, {"batch_size": S2_LOADER_BATCH}), keep=2, dataset="megadepth",
            merge=S2_TIMED_BATCH // S2_LOADER_BATCH)
        print(f"path H loader: {res['loader_samples_per_s']:.2f} samples/s ({S2_WORKERS} workers, "
              f"{os.cpu_count()} cores, batches of {S2_LOADER_BATCH}, the split's "
              f"{len(S2_TRAIN_SCENES) * S2_PER_SCENE} pairs from the loader's start)", flush=True)
        res["gt_on_card"] = gt_batch_on_the_card(model, batches[0])
        print(f"path H depth_matcher, card vs CPU: {json.dumps(res['gt_on_card'])}", flush=True)
        res["vs_plain"] = train_step_vs_plain(model, batches[0], "path H")
        print(f"path H step vs plain: {json.dumps(res['vs_plain'])}", flush=True)
        res["timing"] = time_training(model, batches, device_info, conf=conf, batch=S2_TIMED_BATCH,
                                      label="path H", accum2=False, timed=S2_TIMED_STEPS)
        t = res["timing"]
        print(f"path H timing: {t['ms_per_step']:.2f} ms/step, device {t['device_ms_per_step']} ms/step, "
              f"busy share {t['busy_share']}, {t['samples_per_s']:.2f} samples/s, peak "
              f"{t['peak_memory_gib']:.2f} GiB at batch {S2_TIMED_BATCH} ({card})", flush=True)
        print(f"path H top device items: {json.dumps(t['profile']['top'][:8])}", flush=True)
        res["pace"] = "loader" if res["loader_samples_per_s"] < t["samples_per_s"] else "step"
        print(f"path H pace: the {res['pace']} sets it (loader {res['loader_samples_per_s']:.2f} "
              f"samples/s, step {t['samples_per_s']:.2f} samples/s)", flush=True)
        del model, batches
        torch.cuda.empty_cache()
        res["attention"] = attention_at_shapes(torch.device(DEVICE), torch.float32, KEYPOINTS, S2_TIMED_BATCH,
                                               "path H")
    finally:
        tsettings.DATA_PATH = data_path
    res["seconds"] = time.perf_counter() - t0
    res["card"] = card
    return res


# --------------------------------------------------------------------------
# 13. path I: stage 2 on cached SuperPoint features
# --------------------------------------------------------------------------

S3_EXPERIMENT = "chip_smoke_path_i"
S3_SCENE_LIST = "chip_smoke_scenes.txt"  # path H's 4 scenes, under megadepth/scene_lists/
S3_RESIZE = 1024
S3_EPOCHS = 1  # path H's resampling is checked there
S3_ARGV = [S3_EXPERIMENT, *S2_ARGV[1:], "data.load_features.do=true", f"train.epochs={S3_EPOCHS}"]
# the loader's rates read the whole training split (its batches of 4), its
# workers' start-up included
S3_LOADER_SAMPLES = len(S2_TRAIN_SCENES) * S2_PER_SCENE
S3_REDUCED = {
    "export": f"path H's {len(S2_TRAIN_SCENES) + 1} procedural scenes ({S2_VIEWS} views each, "
              "1600 x 1200) instead of MegaDepth's 196 training scenes; the extractor is path E's "
              f"best checkpoint's SuperPoint (random weights from a seed, trained {TRAIN_STEPS} steps), since no "
              "official weights are on disk",
    "training": "path H's cuts (S2_REDUCED) and its overrides, with data.load_features.do=true",
    "length": f"{S3_EPOCHS} epoch of {S2_STEPS // S2_ACCUM} update ({S2_STEPS} micro-batches of "
              f"{S2_BATCH}, grad_accumulation {S2_ACCUM})",
}


def _array_digest(a: np.ndarray) -> tuple:
    import hashlib

    return str(a.dtype), tuple(a.shape), hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def export_path_e_features(root: Path) -> dict:
    """`scripts/export_megadepth.py --method sp --with_depth` in process on
    path H's scenes, SuperPoint with path E's best checkpoint's weights (the
    ones the stage-2 trainer warm-starts from). Returns each written item's
    arrays' digests as the writer took them, the seconds and the bytes."""
    from gluefactory_tpu_torch.scripts import export_megadepth
    from gluefactory_tpu_torch.utils import export_predictions
    from gluefactory_tpu_torch.utils.experiments import get_best_checkpoint, load_checkpoint

    best = load_checkpoint(get_best_checkpoint(TRAIN_EXPERIMENT), map_location="cpu")["model"]
    weights = root / "superpoint_path_e.pth"
    torch.save({k[len("extractor."):]: v for k, v in best.items() if k.startswith("extractor.")}, weights)
    scenes = (*S2_TRAIN_SCENES, S2_VAL_SCENE)
    (root / "megadepth" / "scene_lists" / S3_SCENE_LIST).write_text("".join(f"{s}\n" for s in scenes))
    shutil.rmtree(export_megadepth.export_root("sp"), ignore_errors=True)
    written, write = {}, export_predictions.PredictionWriter.write

    def recorded(self, name, arrays):
        before = set(self.names)
        write(self, name, arrays)
        (group,) = self.names - before  # the name written, suffixed where it was taken
        written[(Path(self.file.fh.name).stem, group)] = {
            k: _array_digest(v) for k, v in arrays.items() if isinstance(v, np.ndarray)}

    export_predictions.PredictionWriter.write = recorded
    t0 = time.perf_counter()
    try:
        files = export_megadepth.main(["--method", "sp", "--scenes", S3_SCENE_LIST, "--num_workers",
                                       str(S2_WORKERS), "--resize", str(S3_RESIZE), "--with_depth",
                                       "--weights_file", str(weights), "--device", DEVICE])
    finally:
        export_predictions.PredictionWriter.write = write
    seconds = time.perf_counter() - t0
    return {"files": files, "written": written, "seconds": seconds, "scenes": scenes,
            "bytes": sum(f.stat().st_size for f in files)}


def check_export(root: Path, export: dict) -> dict:
    """Gates: a file for each scene holding a group for each of its images
    (the JAX script's narrowed item list gives every later scene none);
    every array read back by `data/hdf5.py` equal (dtype, shape, bytes) to
    what went into the writer, float16 where float; keypoints finite and
    inside the image; `valid_depth_keypoints` bool."""
    from gluefactory_tpu_torch.data.hdf5 import H5File

    W, H = S2_SIZE
    n_items, keypoints, valid = 0, 0, 0
    for scene, path in zip(export["scenes"], export["files"]):
        info = np.load(root / "megadepth" / "scene_info" / f"{scene}.npz", allow_pickle=True)
        names = sorted(Path(str(p)).name for p in info["image_paths"])
        with H5File(path) as f:
            if f.keys() != names:
                fail(f"path I: {path.name} holds groups {f.keys()}, expected the scene's {names}")
            for name in names:
                grp = f[name]
                arrays = {k: grp[k] for k in grp.keys()}
                if {k: _array_digest(v) for k, v in arrays.items()} != export["written"][(scene, name)]:
                    fail(f"path I: {scene}/{name} read by data/hdf5.py differs from what was written")
                kpts = arrays["keypoints"].astype(np.float32)
                if any(a.dtype.kind == "f" and a.dtype != np.float16 for a in arrays.values()) or \
                        arrays["valid_depth_keypoints"].dtype != bool or not np.isfinite(kpts).all() or \
                        (kpts < 0).any() or (kpts[:, 0] > W).any() or (kpts[:, 1] > H).any():
                    fail(f"path I: {scene}/{name}: dtypes {[str(a.dtype) for a in arrays.values()]}, "
                         f"keypoints in [{kpts.min(0)}, {kpts.max(0)}]")
                n_items += 1
                keypoints += len(kpts)
                valid += int(arrays["valid_depth_keypoints"].sum())
    return {"files": len(export["files"]), "items": n_items, "keypoints": keypoints,
            "valid_depth_share": valid / max(keypoints, 1), "read_back_equal": True}


def check_cache_items(conf, root: Path) -> dict:
    """The training split's first items through the dataset with the cache:
    each view's cache equals the export's arrays at the original
    resolution, cast to float32 and scaled by the view's `scales` (the
    keypoints), padded to the config's padding_length with the mask."""
    from gluefactory_tpu_torch.data import get_dataset
    from gluefactory_tpu_torch.data.hdf5 import H5File
    from gluefactory_tpu_torch.scripts import export_megadepth

    items = get_dataset("megadepth")(conf.data).get_dataset("train")
    pad = int(conf.data.load_features.padding_length)
    padded, views = 0, 0
    for i in range(4):
        data = items[i]
        scene = data["scene"]
        with H5File(export_megadepth.export_root("sp") / f"{scene}.h5") as f:
            for v in ("view0", "view1"):
                view, cache = data[v], data[v]["cache"]
                grp = f[view["name"]]
                n = min(len(grp["keypoints"]), pad)
                want = {"keypoints": grp["keypoints"][:n].astype(np.float32) * view["scales"].astype(np.float32),
                        "keypoint_scores": grp["keypoint_scores"][:n].astype(np.float32),
                        "descriptors": grp["descriptors"][:n].astype(np.float32)}
                mask = cache["keypoint_mask"]
                if mask.shape != (pad,) or int(mask.sum()) != n or any(
                        cache[k].dtype != np.float32 or not np.array_equal(cache[k][:n], w)
                        for k, w in want.items()):
                    fail(f"path I: item {i} {v}: the loader's cache differs from the export's arrays")
                padded += pad - n
                views += 1
    return {"views": views, "padding_length": pad, "padded_slots": padded, "equal": True}


def phase_cached(device_info: dict, path_h: dict) -> dict:
    """Path I: path H's scenes exported with `scripts/export_megadepth.py`,
    then the trainer on the shipped stage-2 config with
    `data.load_features.do=true` (no SuperPoint in the step: LightGlue-9
    on the cached 2048 keypoints with their masks, checkpointed, f32),
    warm-started from path E; its gates and numbers beside path H's."""
    import gluefactory_tpu_torch.settings as tsettings
    from gluefactory_tpu_torch.models.extractors.superpoint import SuperPoint

    card = device_info["nvidia_smi"]
    print(f"path I reduced: {json.dumps(S3_REDUCED)}", flush=True)
    t0 = time.perf_counter()
    data_path, tsettings.DATA_PATH = tsettings.DATA_PATH, S2_ROOT
    forward, extractor_calls = SuperPoint.forward, []

    def counted(self, *args, **kwargs):
        extractor_calls.append(1)
        return forward(self, *args, **kwargs)

    try:
        export = export_path_e_features(S2_ROOT)
        res = {"reduced": S3_REDUCED, "argv": S3_ARGV, "export": check_export(S2_ROOT, export)}
        res["export"].update({"seconds": export["seconds"], "bytes": export["bytes"],
                              "images_per_s": res["export"]["items"] / export["seconds"]})
        print(f"path I export: {json.dumps(res['export'])} ({card})", flush=True)
        conf = train_conf(S3_ARGV, S2_YAML)
        res["cache_items"] = check_cache_items(conf, S2_ROOT)
        print(f"path I loader cache vs export: {json.dumps(res['cache_items'])}", flush=True)

        SuperPoint.forward = counted
        shutil.rmtree(Path(tsettings.TRAINING_PATH, S3_EXPERIMENT), ignore_errors=True)
        records, seconds, launches, model = run_trainer(S3_ARGV)
        steps = S3_EPOCHS * S2_STEPS
        _check_launches("path I", launches, {k: steps * n + S3_EPOCHS * VAL_LAUNCHES[k]
                                             for k, n in STEP_LAUNCHES.items()})
        if len(records) != steps:
            fail(f"path I: {len(records)} train steps, expected {steps}")
        losses = [{k: float(v) for k, v in r[0].items()} for r in records]
        for i, (step_losses, (_, _, info)) in enumerate(zip(losses, records)):
            if not all(math.isfinite(v) for v in step_losses.values()):
                fail(f"path I: step {i} has a non-finite loss term: {step_losses}")
            if not bool(info["ok"]):
                fail(f"path I: the update of step {i} was not applied")
        res["run"] = {"seconds": seconds, "launches": launches, "losses": losses,
                      "grad_norms": [float(r[2]["grad_norm"]) for r in records],
                      "extractor_calls": len(extractor_calls)}
        print(f"path I: {steps} steps and {S3_EPOCHS} validation batches in {seconds:.1f} s, launches "
              f"{json.dumps(launches)}, losses finite, every update applied; total "
              f"{losses[0]['total']:.4f} -> {losses[-1]['total']:.4f}; extractor forwards "
              f"{len(extractor_calls)}", flush=True)
        res["restore"] = check_restore(model, S3_ARGV, S3_EXPERIMENT, steps // S2_ACCUM, "path I")
        res["loader_samples_per_s"], batches = loader_rate(
            merge(conf.data, {"batch_size": S2_LOADER_BATCH}), keep=2, dataset="megadepth",
            merge=S2_TIMED_BATCH // S2_LOADER_BATCH, max_samples=S3_LOADER_SAMPLES)
        res["loader_no_image_samples_per_s"], _ = loader_rate(
            merge(conf.data, {"batch_size": S2_LOADER_BATCH, "read_image": False}), dataset="megadepth",
            max_samples=S3_LOADER_SAMPLES)
        print(f"path I loader: {res['loader_samples_per_s']:.2f} samples/s with the cache as shipped "
              f"(read_image true), {res['loader_no_image_samples_per_s']:.2f} with read_image false; path "
              f"H's {path_h['loader_samples_per_s']:.2f} ({S2_WORKERS} workers)", flush=True)
        masks = [batches[0][v]["cache"]["keypoint_mask"] for v in ("view0", "view1")]
        res["batch_masks"] = {"shape": list(masks[0].shape),
                              "padded_slots": [int((~m).sum()) for m in masks]}
        if any(m.dtype != torch.bool or m.shape != (S2_TIMED_BATCH, KEYPOINTS) for m in masks):
            fail(f"path I: the batch's keypoint masks are {[(m.dtype, m.shape) for m in masks]}")
        print(f"path I batch keypoint_mask0/1: {json.dumps(res['batch_masks'])}", flush=True)
        res["vs_plain"] = train_step_vs_plain(model, batches[0], "path I")
        print(f"path I step vs plain: {json.dumps(res['vs_plain'])}", flush=True)
        res["timing"] = time_training(model, batches, device_info, conf=conf, batch=S2_TIMED_BATCH,
                                      label="path I", accum2=False, timed=S2_TIMED_STEPS)
        res["extractor_calls"] = len(extractor_calls)
        if extractor_calls:
            fail(f"path I: the extractor ran {len(extractor_calls)} times in cached training")
        t, th = res["timing"], path_h["timing"]
        print(f"path I timing: {t['ms_per_step']:.2f} ms/step (path H {th['ms_per_step']:.2f}), device "
              f"{t['device_ms_per_step']} ms/step (path H {th['device_ms_per_step']}), busy share "
              f"{t['busy_share']} (path H {th['busy_share']}), {t['samples_per_s']:.2f} samples/s (path H "
              f"{th['samples_per_s']:.2f}), peak {t['peak_memory_gib']:.2f} GiB (path H "
              f"{th['peak_memory_gib']:.2f}) at batch {S2_TIMED_BATCH} ({card})", flush=True)
        print(f"path I top device items: {json.dumps(t['profile']['top'][:8])}", flush=True)
        res["pace"] = "loader" if res["loader_samples_per_s"] < t["samples_per_s"] else "step"
        print(f"path I pace: the {res['pace']} sets it (loader {res['loader_samples_per_s']:.2f} "
              f"samples/s, step {t['samples_per_s']:.2f} samples/s)", flush=True)
        del model, batches
        torch.cuda.empty_cache()
    finally:
        SuperPoint.forward = forward
        tsettings.DATA_PATH = data_path
    res["seconds"] = time.perf_counter() - t0
    res["card"] = card
    return res


# --------------------------------------------------------------------------
# 14. path J: the ETH3D and ZEB benchmarks through their CLIs
# --------------------------------------------------------------------------

# DATA_PATH of the run: ETH3D_undistorted/ and zeb/ are written under it
J_ROOT = ROOT / "outputs" / "chip_smoke_path_j"
ETH3D_SCENES = (("courtyard", 0),)  # (scene, seed)
# the DSLR size; the loader resizes each image to max(h, w) // 8 = 756
ETH3D_VIEWS, ETH3D_SIZE, ETH3D_DOWNSIZE = 4, (6048, 4032), 8
ETH3D_POINTS = 15000  # 3D points on the planes: > 500 covisible a pair
ETH3D_PAIRS = len(ETH3D_SCENES) * ETH3D_VIEWS * (ETH3D_VIEWS - 1) // 2
ZEB_SCENES = (("gl3d", 10), ("kitti", 11))
ZEB_VIEWS, ZEB_PAIRS_PER_SCENE, ZEB_SIZE = 5, 6, (1600, 1200)
ZEB_PAIRS = len(ZEB_SCENES) * ZEB_PAIRS_PER_SCENE
J_REDUCED = {
    "eth3d": f"{ETH3D_PAIRS} pairs of {len(ETH3D_SCENES)} procedural scenes of {ETH3D_VIEWS} views "
             f"(the DSLR size {ETH3D_SIZE[0]} x {ETH3D_SIZE[1]}, rendered at 1/{ETH3D_DOWNSIZE // 2} and "
             f"upsampled by pixel repetition; 16-bit PNG depths at 1/{ETH3D_DOWNSIZE}; COLMAP calibration "
             f"with {ETH3D_POINTS} points on the planes) in ETH3D's undistorted DSLR layout, for ETH3D's "
             "13 scenes, which are not on disk",
    "zeb": f"{ZEB_PAIRS} pair files of {len(ZEB_SCENES)} procedural scenes ({ZEB_VIEWS} views at "
           f"{ZEB_SIZE[0]} x {ZEB_SIZE[1]}) in ZEB's layout, for ZEB's 46800 pairs, which are not on disk",
    "weights": "random from seed 0, drawn on the CPU as path F draws them, the descriptor head centred "
               "on one of the benchmark's views; SuperGlue's rescaled to pass the descriptors through "
               "(`superglue_pass_through`): official weights are not on disk",
    "estimator": "ZEB: xla_ransac for opencv (the card's host has no cv2)",
}
ETH3D_LAUNCHES = MAIN_LAUNCHES  # a pair: LightGlue-9, 9 of each attention kernel
ZEB_LAUNCHES = {"fused_attention": 4 * LAYERS, "log_sinkhorn": 1}  # a pair: SuperGlue
NN_TOL = 1e-5  # the card's similarity against the CPU's: f32 sums of 256 products in another order


def write_path_j(root: Path) -> dict:
    """The ETH3D and ZEB layouts under `root`; each ETH3D scene's fewest
    covisible points of a pair."""
    from gluefactory_tpu_torch.scripts_dev.posed_scenes import write_eth3d_scene, write_zeb_scene

    shutil.rmtree(root, ignore_errors=True)
    covisible = {}
    for scene, seed in ETH3D_SCENES:
        out = write_eth3d_scene(root / "ETH3D_undistorted", scene, n_views=ETH3D_VIEWS, size=ETH3D_SIZE,
                                downsize_factor=ETH3D_DOWNSIZE, n_points=ETH3D_POINTS, seed=seed,
                                workers=ETH3D_VIEWS)
        covisible[scene] = min(out["covisible"].values())
    for scene, seed in ZEB_SCENES:
        write_zeb_scene(root / "zeb", scene, n_views=ZEB_VIEWS, n_pairs=ZEB_PAIRS_PER_SCENE,
                        size=ZEB_SIZE, seed=seed, workers=ZEB_VIEWS)
    return {"eth3d_min_covisible": covisible}


@contextlib.contextmanager
def recorded_forward(cls, record: list, keep):
    """`cls._forward` patched to append `keep(self, data, out)` to `record`
    after each call."""
    forward = cls._forward

    def wrapped(self, data, *args, **kwargs):
        out = forward(self, data, *args, **kwargs)
        record.append(keep(self, data, out))
        return out

    cls._forward = wrapped
    try:
        yield record
    finally:
        cls._forward = forward


def _gt_record(self, data, out) -> dict:
    """The depth ground truth's devices and counts of one call."""
    return {"devices": sorted({str(v.device) for v in out.values()}),
            "positives": int((out["gt_matches0"] >= 0).sum()),
            "unmatched": int((out["gt_matches0"] == -1).sum())}


def _nn_record(self, data, out) -> dict:
    """The nearest-neighbour matcher's call on the card against a plain CPU
    recomputation of the same tensors: the similarity of the descriptors
    within NN_TOL, and the matcher's outputs from the card's similarity
    (`match_similarity` on the CPU) equal, the log assignment within
    NN_TOL on its entries above -1e6."""
    def cpu(t):
        return None if t is None else t.detach().cpu()

    m0, m1 = cpu(data.get("keypoint_mask0")), cpu(data.get("keypoint_mask1"))
    sim = cpu(out["similarity"])
    sim_cpu = torch.einsum("bnd,bmd->bnm", cpu(data["descriptors0"]), cpu(data["descriptors1"]))
    valid = sim > -1e8
    with torch.no_grad():
        again = self.match_similarity(sim, m0, m1)
    la, la_cpu = cpu(out["log_assignment"]), again["log_assignment"]
    near = (la_cpu > -1e6) & (la > -1e6)
    return {"device": str(out["matches0"].device), "matches": int((out["matches0"] >= 0).sum()),
            "keypoints": list(sim.shape[1:]),
            "similarity_err": float((sim - sim_cpu)[valid].abs().max()),
            "differ": {k: int((again[k] != cpu(out[k])).sum())
                       for k in ("matches0", "matches1", "matching_scores0", "matching_scores1")},
            "log_assignment_err": float((la - la_cpu)[near].abs().max()),
            "log_assignment_far_equal": bool(torch.equal(la > -1e6, la_cpu > -1e6))}


def run_eth3d(argv: list) -> dict:
    from gluefactory_tpu_torch.eval import eth3d

    return run_eval_cli(eth3d.main, eth3d.ETH3DPipeline, None, "", argv)


def run_zeb(argv: list) -> dict:
    from gluefactory_tpu_torch.eval import zeb
    from gluefactory_tpu_torch.robust_estimators.relative_pose import xla_ransac

    return run_eval_cli(zeb.main, zeb.ZEBPipeline, xla_ransac, "ransac_essential", argv)


def check_cache_rerun(label: str, run_fn, argv: list, benchmark: str, tag: str, summaries: dict) -> dict:
    """An `--overwrite_eval` rerun reads the cache (its file untouched, no
    kernel launched) and gives the same summaries."""
    import gluefactory_tpu_torch.settings as tsettings

    cache_file = Path(tsettings.EVAL_PATH, benchmark, tag, "predictions.h5")
    mtime = cache_file.stat().st_mtime_ns
    again = run_fn([*argv, "--tag", tag, "--overwrite_eval"])
    _check_launches(f"{label} --overwrite_eval", again["launches"], {})
    if cache_file.stat().st_mtime_ns != mtime or again["summaries"] != summaries:
        fail(f"{label}: the --overwrite_eval rerun did not reuse the cache or changed the summaries")
    return {"seconds": again["seconds"], "summaries_equal": True}


def _finite_summaries(label: str, s: dict, keys) -> dict:
    metrics = {k: s.get(k) for k in keys}
    if not all(isinstance(v, float) and math.isfinite(v) for v in metrics.values()):
        fail(f"{label}: summaries not finite: {metrics}")
    return metrics


def phase_benchmarks(device_info: dict) -> dict:
    """Path J: the ETH3D CLI (`eval.eth3d.main`) with
    `superpoint+lightglue-official` (LightGlue-9, 9 + 9 attention launches
    a pair) and with `superpoint+NN` (no kernel), each config resolved by
    name, `depth_matcher` in the forward on the card; then the ZEB CLI
    (`eval.zeb.main`) with `superpoint+superglue-official` by name (36
    attention launches and one Sinkhorn a pair at 2048 keypoints) and
    `eval.estimator=xla_ransac`; cut as J_REDUCED says. Gates: finite AP
    and AUCs, the caches' items and keys, exact launch counts, the ground
    truth and the RANSAC on the card, the NN matcher's outputs against a
    CPU recomputation, `--overwrite_eval` reruns that read the caches."""
    import gluefactory_tpu_torch.settings as tsettings
    from gluefactory_tpu_torch.data import get_dataset
    from gluefactory_tpu_torch.eval import eth3d, zeb
    from gluefactory_tpu_torch.models.matchers.depth_matcher import DepthMatcher
    from gluefactory_tpu_torch.models.matchers.nearest_neighbor_matcher import NearestNeighborMatcher

    card = device_info["nvidia_smi"]
    card_device = str(torch.empty(0, device=DEVICE).device)
    print(f"path J reduced: {json.dumps(J_REDUCED)}", flush=True)
    t0 = time.perf_counter()
    res = {"reduced": J_REDUCED, "write": write_path_j(J_ROOT)}
    res["write"]["seconds"] = time.perf_counter() - t0
    print(f"path J layouts written in {res['write']['seconds']:.1f} s: {json.dumps(res['write'])}",
          flush=True)
    if min(res["write"]["eth3d_min_covisible"].values()) < 500:
        fail(f"path J: an ETH3D pair has fewer than 500 covisible points: {res['write']}")
    data_path, tsettings.DATA_PATH = tsettings.DATA_PATH, J_ROOT
    try:
        items = get_dataset("eth3d")(eth3d.ETH3DPipeline.default_conf["data"]).get_dataset("test")
        view = items[0]["view0"]
        if len(items) != ETH3D_PAIRS or view["image"].shape[:2] != (504, 756):
            fail(f"path J: ETH3D gives {len(items)} pairs of {view['image'].shape}, expected "
                 f"{ETH3D_PAIRS} of (504, 756, 1)")
        weights, sp_weights = J_ROOT / "weights_lg.pth", J_ROOT / "weights_sp.pth"
        res["weights"] = benchmark_weights(weights, DEVICE, "eth3d", view, draw_device="cpu")
        torch.save({k[len("extractor."):]: v for k, v in torch.load(weights, weights_only=True).items()
                    if k.startswith("extractor.")}, sp_weights)

        # ETH3D, LightGlue
        gt_calls = []
        argv = ["--conf", "superpoint+lightglue-official", f"model.weights_file={weights}"]
        with recorded_forward(DepthMatcher, gt_calls, _gt_record):
            lg = run_eth3d([*argv, "--tag", "chip_smoke_lg", "--overwrite"])
        _check_launches("path J ETH3D lightglue", lg["launches"],
                        {k: ETH3D_PAIRS * n for k, n in ETH3D_LAUNCHES.items()})
        if len(gt_calls) != ETH3D_PAIRS or any(c["devices"] != [card_device] for c in gt_calls):
            fail(f"path J: depth_matcher ran {len(gt_calls)} times on {[c['devices'] for c in gt_calls]}")
        cache = _cache("chip_smoke_lg", "eth3d")
        if len(cache) != ETH3D_PAIRS or any(set(p) != set(eth3d.ETH3DPipeline.export_keys)
                                            for p in cache.values()):
            fail(f"path J: the ETH3D cache holds {len(cache)} items with {[sorted(p) for p in cache.values()][:1]}")
        res["eth3d_lightglue"] = {
            "summaries": _finite_summaries("path J ETH3D lightglue", lg["summaries"], ["AP"]),
            "launches": lg["launches"], "seconds": lg["seconds"],
            "export_pairs_per_s": ETH3D_PAIRS / lg["seconds"]["get_predictions"],
            "gt_positives_per_pair": float(np.mean([c["positives"] for c in gt_calls])),
            "keypoints_per_view": float(np.mean([len(p["keypoints0"]) for p in cache.values()])),
            "matches_per_pair": float(np.mean([(p["matches0"] >= 0).sum() for p in cache.values()])),
            "rerun": check_cache_rerun("path J ETH3D lightglue", run_eth3d, argv, "eth3d",
                                       "chip_smoke_lg", lg["summaries"])}
        print(f"path J ETH3D superpoint+lightglue-official: {json.dumps(res['eth3d_lightglue'])} "
              f"({card})", flush=True)

        # ETH3D, nearest neighbours
        nn_calls, gt_calls = [], []
        argv = ["--conf", "superpoint+NN", f"model.extractor.weights_file={sp_weights}"]
        with recorded_forward(NearestNeighborMatcher, nn_calls, _nn_record), \
                recorded_forward(DepthMatcher, gt_calls, _gt_record):
            nn = run_eth3d([*argv, "--tag", "chip_smoke_nn", "--overwrite"])
        _check_launches("path J ETH3D NN", nn["launches"], {})
        bad = [c for c in nn_calls if c["device"] != card_device or any(c["differ"].values())
               or c["similarity_err"] > NN_TOL or c["log_assignment_err"] > NN_TOL
               or not c["log_assignment_far_equal"]]
        if len(nn_calls) != ETH3D_PAIRS or bad or any(c["devices"] != [card_device] for c in gt_calls):
            fail(f"path J: the NN matcher on the card against the CPU: {len(nn_calls)} calls, {bad[:2]}")
        res["eth3d_nn"] = {
            "summaries": _finite_summaries("path J ETH3D NN", nn["summaries"], ["AP"]),
            "launches": nn["launches"], "seconds": nn["seconds"],
            "export_pairs_per_s": ETH3D_PAIRS / nn["seconds"]["get_predictions"],
            "vs_cpu": {"calls": len(nn_calls), "tol": NN_TOL,
                       "similarity_err": max(c["similarity_err"] for c in nn_calls),
                       "log_assignment_err": max(c["log_assignment_err"] for c in nn_calls),
                       "outputs_differ": 0, "keypoints": nn_calls[0]["keypoints"],
                       "matches_per_pair": float(np.mean([c["matches"] for c in nn_calls]))},
            "rerun": check_cache_rerun("path J ETH3D NN", run_eth3d, argv, "eth3d", "chip_smoke_nn",
                                       nn["summaries"])}
        print(f"path J ETH3D superpoint+NN: {json.dumps(res['eth3d_nn'])} ({card})", flush=True)

        # ZEB, SuperGlue
        zitems = get_dataset("zeb")(zeb.ZEBPipeline.default_conf["data"]).get_dataset("test")
        if len(zitems) != ZEB_PAIRS:
            fail(f"path J: ZEB gives {len(zitems)} pairs, expected {ZEB_PAIRS}")
        sg_weights = J_ROOT / "weights_sg.pth"
        res["zeb_weights"] = benchmark_weights(sg_weights, DEVICE, "zeb", zitems[0]["view0"],
                                               draw_device="cpu", config="superpoint+superglue-official")
        argv = ["--conf", "superpoint+superglue-official", "eval.estimator=xla_ransac",
                f"model.weights_file={sg_weights}"]
        z = run_zeb([*argv, "--tag", "chip_smoke", "--overwrite"])
        _check_launches("path J ZEB superglue", z["launches"],
                        {k: ZEB_PAIRS * n for k, n in ZEB_LAUNCHES.items()})
        calls = z["ransac_calls"]
        if not calls or any(c["devices"] != [card_device] for c in calls):
            fail(f"path J: the ZEB RANSAC ran on {[c['devices'] for c in calls]}")
        zcache = _cache("chip_smoke", "zeb")
        if len(zcache) != ZEB_PAIRS or any(set(p) != set(zeb.ZEBPipeline.export_keys)
                                           for p in zcache.values()):
            fail(f"path J: the ZEB cache holds {len(zcache)} items")
        res["zeb_superglue"] = {
            "summaries": _finite_summaries("path J ZEB", z["summaries"],
                                           ["rel_pose_error@5°", "rel_pose_error@10°",
                                            "rel_pose_error@20°", "mepi_prec@1e-4"]),
            "launches": z["launches"], "seconds": z["seconds"],
            "export_pairs_per_s": ZEB_PAIRS / z["seconds"]["get_predictions"],
            "ransac_calls": len(calls), "ransac_ms_per_call": float(np.mean([c["ms"] for c in calls])),
            "keypoints_per_view": float(np.mean([len(p["keypoints0"]) for p in zcache.values()])),
            "matches_per_pair": float(np.mean([(p["matches0"] >= 0).sum() for p in zcache.values()])),
            "rerun": check_cache_rerun("path J ZEB", run_zeb, argv, "zeb", "chip_smoke", z["summaries"])}
        print(f"path J ZEB superpoint+superglue-official: {json.dumps(res['zeb_superglue'])} ({card})",
              flush=True)
    finally:
        tsettings.DATA_PATH = data_path
    res["seconds"] = time.perf_counter() - t0
    res["card"] = card
    print(f"path J: {res['seconds']:.1f} s", flush=True)
    return res


# --------------------------------------------------------------------------
# 15. path K: SuperGlue stage-1 training
# --------------------------------------------------------------------------

K_EXPERIMENT = "chip_smoke_path_k"
# the official SuperGlue widths in place of path E's LightGlue
K_MATCHER = {"name": "superglue", "descriptor_dim": DIM, "keypoint_encoder": [32, 64, 128, 256],
             "n_layers": LAYERS, "num_heads": HEADS, "sinkhorn_iterations": SINKHORN_ITERS,
             "filter_threshold": 0.2, "checkpointed": True}
K_STEPS, K_VAL_BATCHES, K_TIMED_STEPS, K_TRIPLET_BATCH = 2, 1, 2, 8
# a train step: 36 attention calls forward and 36 in the checkpoints'
# recompute, one Sinkhorn (its backward is the plain loop's gradient); a
# validation batch: 36 and one
K_STEP_LAUNCHES = {"fused_attention": 2 * 4 * LAYERS, "log_sinkhorn": 1}
K_VAL_LAUNCHES = {"fused_attention": 4 * LAYERS, "log_sinkhorn": 1}
K_REDUCED = {
    "config": "path E's superpoint+lightglue_homography.yaml with its matcher replaced by SuperGlue at "
              "the official widths (d 256, keypoint encoder [32, 64, 128, 256], 9 layer pairs, 4 heads, "
              "50 Sinkhorn iterations, checkpointed), written to a temporary directory: the JAX package "
              "ships no SuperGlue training config",
    "data": "path E's cuts: procedural images, batch 32 for 128, 6 workers for 14",
    "length": f"{K_STEPS} training steps (one epoch) and {K_VAL_BATCHES} validation batch of {VAL_BATCH}",
    "triplet": f"one TripletPipeline forward and loss (train, backward) on a batch of {K_TRIPLET_BATCH} "
               "triplets of the homography dataset (`triplet: true`)",
}


def k_argv(conf_path: Path) -> list:
    return [K_EXPERIMENT, "--conf", str(conf_path), "--no_tensorboard", "--no_capture",
            "--max_val_iters", str(K_VAL_BATCHES),
            f"data.synthetic_images={TRAIN_BATCH * K_STEPS + VAL_BATCH * K_VAL_BATCHES}",
            f"data.train_size={TRAIN_BATCH * K_STEPS}", f"data.val_size={VAL_BATCH * K_VAL_BATCHES}",
            f"data.batch_size={TRAIN_BATCH}", f"data.val_batch_size={VAL_BATCH}", "data.num_workers=6",
            "train.epochs=1",
            "train.log_every_iter=1", "train.eval_every_iter=1000000"]


def write_superglue_config(path: Path) -> Path:
    """Path E's shipped config with K_MATCHER as its matcher, as YAML."""
    from gluefactory_tpu_torch.core.config import Config, from_yaml

    conf = from_yaml(str(ROOT / TRAIN_YAML)).to_dict()
    conf["model"]["matcher"] = dict(K_MATCHER)
    path.write_text(Config(conf).to_yaml())
    return path


def triplet_forward(model, conf) -> dict:
    """A TripletPipeline with the trained model's components and weights:
    one forward and loss (train) and the backward on a batch of
    K_TRIPLET_BATCH triplets (views 0, 1, 2), the three pairs stacked in one
    matcher pass; launches exactly K_STEP_LAUNCHES, every loss finite."""
    from gluefactory_tpu_torch.core.config import merge
    from gluefactory_tpu_torch.data import get_dataset
    from gluefactory_tpu_torch.data.base_dataset import collate, prepare_batch
    from gluefactory_tpu_torch.models import get_model

    mconf = {k: v for k, v in conf.model.to_dict().items() if k != "name"}
    triplet = get_model("triplet_pipeline").from_conf(mconf, device=DEVICE)
    triplet.load_state_dict(model.state_dict())
    ds = get_dataset("homographies")(merge(conf.data, {"triplet": True})).get_dataset("val")
    batch = prepare_batch({k: v for k, v in collate([ds[i] for i in range(K_TRIPLET_BATCH)]).items()
                           if k not in ("name", "idx")}, DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    reset_all_launches()
    t0 = time.perf_counter()
    pred, losses, _ = triplet.forward_with_loss(batch, train=True, generator=gen)
    losses["total"].mean().backward()
    torch.cuda.synchronize()
    launches = all_launches()
    _check_launches("path K triplet", launches, K_STEP_LAUNCHES)
    values = {k: float(v.detach().float().mean()) for k, v in losses.items()}
    shapes = {idx: list(pred[f"log_assignment_{idx}"].shape) for idx in ("0to1", "0to2", "1to2")}
    if not all(math.isfinite(v) for v in values.values()) or any(
            s != [K_TRIPLET_BATCH, REDUCED_KEYPOINTS + 1, REDUCED_KEYPOINTS + 1] for s in shapes.values()):
        fail(f"path K triplet: losses {values}, log assignments {shapes}")
    return {"batch": K_TRIPLET_BATCH, "launches": launches, "losses": values,
            "log_assignment_shapes": shapes, "seconds": time.perf_counter() - t0}


def sinkhorn_at_training_shape(dev) -> dict:
    """`log_sinkhorn` at path K's shape, (32, 513, 513) f32, 50 iterations,
    as its train step runs it: the forward against the plain loop (1e-4),
    the gradient (the plain loop's, through `ops/_autograd.py`) within
    1e-3 of the plain gradient's norm; times of the kernel's forward and of
    forward + backward against the plain loop's, and the bound of the
    forward's exponentials; no single library call computes it."""
    B, M = TRAIN_BATCH, REDUCED_KEYPOINTS + 1
    gen = torch.Generator(device=dev).manual_seed(20)
    Z = (torch.randn(B, M, M, generator=gen, device=dev) * 2.0).requires_grad_(True)
    log_mu = torch.full((B, M), -math.log(2 * (M - 1)), device=dev)
    log_nu = torch.full((B, M), -math.log(2 * (M - 1)), device=dev)
    cot = torch.randn(B, M, M, generator=gen, device=dev)
    kernel, plain = cuda_sinkhorn.log_sinkhorn, cuda_sinkhorn.plain_log_sinkhorn

    def forward(fn):
        with torch.no_grad():
            return fn(Z, log_mu, log_nu, SINKHORN_ITERS)

    def forward_backward(fn):
        return torch.autograd.grad(fn(Z, log_mu, log_nu, SINKHORN_ITERS), Z, cot)[0]

    err = _finite_log_err(forward(kernel), forward(plain))
    g, g_plain = forward_backward(kernel), forward_backward(plain)
    grad_err = float((g - g_plain).abs().max() / torch.linalg.vector_norm(g_plain))
    exps = 2.0 * SINKHORN_ITERS * B * M * M
    t_bytes = (2 * B * M * M * 4 + 2 * M * B * 4) / PEAK_BYTES * 1e3
    t_ops = max(exps / PEAK_SFU, 4 * exps / PEAK_OPS[torch.float32]) * 1e3
    res = {"shape": [B, M, M, SINKHORN_ITERS], "max_abs_err": err, "tol": 1e-4,
           "grad_max_rel_err": grad_err, "grad_tol": TRAIN_TOL,
           "ms": cuda_time_ms(lambda: forward(kernel)), "plain_ms": cuda_time_ms(lambda: forward(plain), reps=3),
           "forward_backward_ms": cuda_time_ms(lambda: forward_backward(kernel), reps=3),
           "plain_forward_backward_ms": cuda_time_ms(lambda: forward_backward(plain), reps=3),
           "bound_ms": max(t_bytes, t_ops), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": None}
    if not (err <= 1e-4 and grad_err <= TRAIN_TOL):
        fail(f"path K: log_sinkhorn at the training shape against the plain loop: {res}")
    return res


def phase_superglue_training(device_info: dict) -> dict:
    """Path K: the trainer on path E's config with SuperGlue at the official
    widths as its matcher (SuperPoint 512 keypoints frozen, 640 x 480, f32,
    TF32 off, `lg`, batch 32), cut as K_REDUCED says. Gates: finite losses
    and every update applied, exact launches a step and a validation batch,
    `--restore` bit-equal (BatchNorm statistics included), a step through
    the kernels against the plain versions (gradients within 1e-3 of their
    norm, the BatchNorm statistics after it), the Sinkhorn kernel at the
    step's shape under autograd, one TripletPipeline forward and loss; then
    ms a step, device ms, busy share, samples/s, peak memory and the
    loader's rate."""
    import tempfile

    from gluefactory_tpu_torch.settings import TRAINING_PATH

    card = device_info["nvidia_smi"]
    print(f"path K reduced: {json.dumps(K_REDUCED)}", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        conf_path = write_superglue_config(Path(tmp) / "superpoint+superglue_homography.yaml")
        argv = k_argv(conf_path)
        conf = train_conf(argv, str(conf_path))
        shutil.rmtree(Path(TRAINING_PATH, K_EXPERIMENT), ignore_errors=True)
        records, seconds, launches, model = run_trainer(argv)
        _check_launches("path K", launches, {k: K_STEPS * n + K_VAL_BATCHES * K_VAL_LAUNCHES[k]
                                             for k, n in K_STEP_LAUNCHES.items()})
        if len(records) != K_STEPS:
            fail(f"path K: {len(records)} train steps, expected {K_STEPS}")
        losses = [{k: float(v) for k, v in r[0].items()} for r in records]
        for i, (step_losses, (_, _, info)) in enumerate(zip(losses, records)):
            if not all(math.isfinite(v) for v in step_losses.values()):
                fail(f"path K: step {i} has a non-finite loss term: {step_losses}")
            if not bool(info["ok"]):
                fail(f"path K: the update of step {i} was not applied")
        res = {"reduced": K_REDUCED, "matcher": K_MATCHER,
               "run": {"seconds": seconds, "launches": launches, "losses": losses,
                       "grad_norms": [float(r[2]["grad_norm"]) for r in records]}}
        print(f"path K: {K_STEPS} steps and {K_VAL_BATCHES} validation batch in {seconds:.1f} s, launches "
              f"{json.dumps(launches)}, losses finite, every update applied; total "
              f"{losses[0]['total']:.4f} -> {losses[-1]['total']:.4f}", flush=True)
        res["restore"] = check_restore(model, argv, K_EXPERIMENT, K_STEPS, "path K")
        res["restore"]["buffers"] = sum(1 for _ in model.buffers())
        res["loader_samples_per_s"], batches = loader_rate(conf.data, keep=2)
        res["vs_plain"] = train_step_vs_plain(model, batches[0], "path K", K_STEP_LAUNCHES)
        if not (res["vs_plain"]["running_stats"] == 2 * (4 + 2 * LAYERS)
                and res["vs_plain"]["running_stats_moved"] > 0):
            fail(f"path K: the step did not move every BatchNorm statistic: {res['vs_plain']}")
        print(f"path K step vs plain: {json.dumps(res['vs_plain'])}", flush=True)
        res["sinkhorn"] = sinkhorn_at_training_shape(torch.device(DEVICE))
        print(f"path K log_sinkhorn at (32, 513, 513): {json.dumps(res['sinkhorn'])} ({card})", flush=True)
        # SuperGlue's attention runs each view alone: (32, 4, 512, 64) a call
        res["attention"] = attention_at_shapes(torch.device(DEVICE), torch.float32, REDUCED_KEYPOINTS,
                                               TRAIN_BATCH // 2, "path K", names=("fused_attention",))
        res["timing"] = time_training(model, batches, device_info, conf=conf, label="path K",
                                      accum2=False, timed=K_TIMED_STEPS, step_launches=K_STEP_LAUNCHES)
        t = res["timing"]
        res["pace"] = "loader" if res["loader_samples_per_s"] < t["samples_per_s"] else "step"
        print(f"path K timing: {t['ms_per_step']:.2f} ms/step, device {t['device_ms_per_step']} ms/step, "
              f"busy share {t['busy_share']}, {t['samples_per_s']:.2f} samples/s, peak "
              f"{t['peak_memory_gib']:.2f} GiB, loader {res['loader_samples_per_s']:.2f} samples/s, the "
              f"{res['pace']} sets the pace ({card})", flush=True)
        print(f"path K top device items: {json.dumps(t['profile']['top'][:8])}", flush=True)
        res["triplet"] = triplet_forward(model, conf)
        print(f"path K triplet: {json.dumps(res['triplet'])}", flush=True)
        del model, batches
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    res["card"] = card
    print(f"path K: {res['seconds']:.1f} s", flush=True)
    return res


def train_conf(argv: list | None = None, yaml: str = TRAIN_YAML):
    """The trainer's conf of path E (or of `argv` on `yaml`): its defaults,
    the shipped config and the overrides, as `train.main` merges them."""
    from gluefactory_tpu_torch import train
    from gluefactory_tpu_torch.core.config import Config, from_dotlist, from_yaml, merge

    dotlist = [a for a in (argv or TRAIN_ARGV) if "=" in a and not a.startswith("-")]
    return merge(Config(train.default_conf), from_yaml(str(ROOT / yaml)), from_dotlist(dotlist))


# --------------------------------------------------------------------------
# 16. path L: GlueStick with lines (LSD on the host, the wireframe, the
#     GlueStick matcher, line GT, ETH3D line AP, the point + line RANSAC)
# --------------------------------------------------------------------------

L_CONFIG = "superpoint+lsd+gluestick"
L_ROOT = ROOT / "outputs" / "chip_smoke_path_l"
L_LAUNCHES = {"fused_attention": 4 * LAYERS}  # a pair: GlueStick-9, 36 launches
L_SUBSET = "v"  # path F's v_ sequences: 4 x 5 pairs
L_REDUCED = {
    "hpatches": f"{5 * sum(s.startswith(L_SUBSET) for s in HPATCHES_SEQUENCES)} pairs of path F's "
                f"procedural {L_SUBSET}_ sequences (data.subset={L_SUBSET}), for HPatches' 540",
    "eth3d": f"path J's {ETH3D_PAIRS} procedural ETH3D pairs, for ETH3D's 13 scenes",
    "weights": "random from seed 0 as path F draws them, the descriptor head centred on one scene, "
               "GlueStick rescaled to pass the descriptors through (`gluestick_pass_through`): "
               "no GlueStick checkpoint is on disk",
}
L_TOL = 1e-3  # kernels vs plain versions on the log assignments, f32


def _l_views():
    """Path L's pairs: two of path F's v_ pairs at 640 x 480 (480 on the
    short side) and a 1600 x 1200 procedural scene with a warped view."""
    from gluefactory_tpu_torch.data.homographies import generate_synthetic_image, warp_patch
    from gluefactory_tpu_torch.data.preprocess import ImagePreprocessor, read_image

    pre = ImagePreprocessor({"resize": 480, "side": "short"})
    pairs = []
    for seq in ("v_chip0", "v_chip1"):
        d = HPATCHES_ROOT / "hpatches-sequences-release" / seq
        pairs.append((pre(read_image(d / "1.ppm"))["image"], pre(read_image(d / "2.ppm"))["image"]))
    base = generate_synthetic_image(7100, (1600, 1200)).astype(np.float32)
    H = np.array([[1.02, 0.03, -20.0], [-0.02, 0.99, 15.0], [1e-5, -1e-5, 1.0]])
    pairs.append((base, np.clip(warp_patch(base, H, (1600, 1200)), 0, 1).astype(np.float32)))
    return pairs


def _l_batch(img0, img1, dev) -> dict:
    def view(img):
        h, w = img.shape[:2]
        return {"image": torch.from_numpy(np.ascontiguousarray(img)[None]).to(dev),
                "image_size": torch.tensor([[float(w), float(h)]], device=dev)}
    return {"view0": view(img0), "view1": view(img1)}


def _l_host_times(img) -> dict:
    """The LSD and the endpoint clustering of one view on the host, timed
    alone (ms), and whether a second detection gives the same segments."""
    from gluefactory_tpu_torch.models.lines import lsd, wireframe

    grey = lsd.rgb_to_grey_u8((img * 255).astype(np.uint8))
    t0 = time.perf_counter()
    segs = lsd.lsd_segments(grey)
    lsd_ms = 1e3 * (time.perf_counter() - t0)
    again = lsd.lsd_segments(grey)
    same = all(np.array_equal(a, b) for a, b in zip(segs, again))
    lines, scores, valid = lsd.detect_lsd_host(img[None], 512, 15.0)
    t0 = time.perf_counter()
    wireframe.cluster_endpoints_host(lines[0], valid[0], 3.0, scores[0])
    return {"lsd_ms": lsd_ms, "cluster_ms": 1e3 * (time.perf_counter() - t0),
            "segments": int(len(segs[0])), "same_twice": same}


def _l_attention(mask: torch.Tensor, dev) -> dict:
    """The attention kernel at GlueStick's shape, (1, 4, N, 64) f32 with the
    forward's node mask as the key and query mask: against its plain version
    and SDPA, by device time. The bound counts the valid queries against the
    valid keys (a masked query's output is zeros), and the bytes of the valid
    rows of q, k and v read and of the whole output written."""
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(6)
    B, N = mask.shape
    q, k, v = (torch.randn(B, HEADS, N, HEAD_DIM, generator=gen, device=dev) for _ in range(3))
    args = (q, k, v, mask, mask)
    valid = mask.sum(-1).double()  # valid keys a batch item; the valid queries are the same
    nk, pairs = float(valid.sum()), float((valid * valid).sum())
    n_ops, n_exps = 4.0 * HEADS * pairs * HEAD_DIM, 1.0 * HEADS * pairs
    n_bytes = (3 * nk + B * N) * HEADS * HEAD_DIM * 4 + 2 * mask.numel()
    bound_ms, bound_by = _bound(n_ops, n_bytes, torch.float32, n_exps)
    with torch.no_grad():
        got = cuda_attention.fused_attention(*args)
        err = _err(got, cuda_attention.attention_plain(*args))
        attn_mask = mask[:, None, None, :]
        res = {"shape": [B, HEADS, N, HEAD_DIM], "dtype": "float32", "valid_nodes": int(nk),
               "max_abs_err": err, "tol": KERNEL_TOL[torch.float32],
               "ms": device_time_ms(lambda: cuda_attention.fused_attention(*args)),
               "plain_ms": device_time_ms(lambda: cuda_attention.attention_plain(*args), reps=5),
               "library_ms": device_time_ms(
                   lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask)),
               "bound_ms": bound_ms, "bound_by": bound_by}
    if not err <= KERNEL_TOL[torch.float32]:
        fail(f"path L: fused_attention at GlueStick's shape, max abs err {err}")
    return res


def _l_forwards(model, dev, card) -> dict:
    """Each pair once through the pipeline's entry point (launches counted
    around it, then timed again without the profiler, then profiled), the
    plain versions' forward against it."""
    gen = torch.Generator(device=dev)
    out = []
    for img0, img1 in _l_views():
        batch = _l_batch(img0, img1, dev)
        forward = pipeline_forward(model, batch, gen)
        reset_all_launches()
        with torch.no_grad():
            pred = forward()
            torch.cuda.synchronize()
        _check_launches(f"path L forward at {img0.shape[1]} x {img0.shape[0]}", all_launches(),
                        L_LAUNCHES)
        for k, t in pred.items():
            if t.is_floating_point() and not torch.isfinite(t).all():
                fail(f"path L: {k} is not finite")
        with torch.no_grad():
            t0 = time.perf_counter()
            pred = forward()
            torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        prof = profile_forward(forward)
        set_flash(model, False)
        with torch.no_grad():
            plain = forward()
        set_flash(model, True)
        gaps = {}
        for key in ("log_assignment", "line_log_assignment"):
            valid = (plain[key] > -1e6) & (pred[key] > -1e6)
            if not torch.equal(plain[key] > -1e6, pred[key] > -1e6):
                fail(f"path L: {key} masked differently by the kernels and the plain versions")
            gaps[key] = float((plain[key] - pred[key])[valid].abs().max())
        if not max(gaps.values()) <= L_TOL:
            fail(f"path L: kernels vs plain versions {gaps}")
        L = pred["line_mask0"].shape[1]
        host = [_l_host_times(img) for img in (img0, img1)]
        if not all(h["same_twice"] for h in host):
            fail("path L: LSD gave other segments on a second run")
        res = {"image": list(img0.shape[:2]), "wall_ms": wall_ms, "device_ms": prof["device_ms"],
               "busy_share": (prof["device_ms"] / wall_ms) if prof["device_ms"] else None,
               "launches": L_LAUNCHES, "vs_plain": gaps, "tol": L_TOL,
               "lsd_ms": [h["lsd_ms"] for h in host], "cluster_ms": [h["cluster_ms"] for h in host],
               "segments": [h["segments"] for h in host],
               "lines_per_view": [int(pred[f"line_mask{i}"].sum()) for i in "01"],
               "junctions_per_view": [int(pred[f"keypoint_mask{i}"][:, :2 * L].sum()) for i in "01"],
               "keypoints_per_view": [int(pred[f"keypoint_mask{i}"][:, 2 * L:].sum()) for i in "01"],
               "nodes": int(pred["keypoint_mask0"].shape[1]),
               "matches": int((pred["matches0"] >= 0).sum()),
               "line_matches": int((pred["line_matches0"] >= 0).sum()),
               "top_kernels": prof["top"][:8], "card": card}
        print(f"path L forward {json.dumps({k: v for k, v in res.items() if k != 'top_kernels'})}",
              flush=True)
        out.append(res)
    out_mask = pred["keypoint_mask0"]
    return {"pairs": out, "mask": out_mask}


@contextlib.contextmanager
def counted_auction(record: list):
    """`gt_lines.auction_assignment` patched to append each call's count of
    bidding iterations to `record`."""
    from gluefactory_tpu_torch.geometry import gt_lines

    assign = gt_lines.auction_assignment

    def wrapped(*args, **kwargs):
        m0, m1, n = gt_lines.auction_with_count(*args, **kwargs)
        record.append(n)
        return m0, m1

    gt_lines.auction_assignment = wrapped
    try:
        yield record
    finally:
        gt_lines.auction_assignment = assign


def _l_gt_record(self, data, out) -> dict:
    """The line GT of one depth_matcher call on the card; on the first call
    also the same GT recomputed on the CPU, compared as integers."""
    from gluefactory_tpu_torch.geometry import gt_lines

    rec = {"devices": sorted({str(v.device) for v in out.values()}),
           "line_positives": int((out["gt_line_matches0"] >= 0).sum()),
           "auction_iterations": _l_gt_record.auction_iterations[-1]}
    if not _l_gt_record.checked:
        _l_gt_record.checked = True
        c = self.conf
        cpu = gt_lines.gt_line_matches_from_pose_depth(
            data["lines0"].cpu(), data["lines1"].cpu(), data["line_mask0"].cpu(),
            data["line_mask1"].cpu(), data["view0"]["camera"].to("cpu"),
            data["view1"]["camera"].to("cpu"), data["T_0to1"].to("cpu"),
            data["view0"]["depth"].cpu(), data["view1"]["depth"].cpu(),
            n_samples=c.n_line_sampled_pts, perp_dist_th=c.line_perp_dist_th,
            overlap_th=c.overlap_th, min_visibility_th=c.min_visibility_th)
        rec["cpu_equal"] = all(torch.equal(out[f"gt_line_{k}"].cpu(), cpu[k])
                               for k in ("matches0", "matches1", "assignment"))
    return rec


def phase_lines(device_info: dict) -> dict:
    """Path L: `superpoint+lsd+gluestick` at its widths (SuperPoint 2048
    keypoints, 512 LSD lines, GlueStick-9 at 256 wide, 4 heads, f32): three
    pairs through the pipeline (36 attention launches each, the plain
    versions within L_TOL, LSD the same twice, the attention kernel at the
    forward's node layout), then the HPatches CLI with xla_ransac and with
    the point + line RANSAC (`homography_est`) on the cache, then the ETH3D
    CLI with the line GT in the forward and `eval_lines`; cut as L_REDUCED
    says. Needs paths F's and J's layouts."""
    import gluefactory_tpu_torch.settings as tsettings
    from gluefactory_tpu_torch.core.config import from_yaml
    from gluefactory_tpu_torch.eval import eth3d, hpatches
    from gluefactory_tpu_torch.eval.io import extract_benchmark_conf, load_model
    from gluefactory_tpu_torch.models.matchers.depth_matcher import DepthMatcher
    from gluefactory_tpu_torch.robust_estimators.homography import homography_est

    card = device_info["nvidia_smi"]
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    print(f"path L reduced: {json.dumps(L_REDUCED)}", flush=True)
    shutil.rmtree(L_ROOT, ignore_errors=True)
    L_ROOT.mkdir(parents=True)
    weights = L_ROOT / "weights.pth"
    res = {"reduced": L_REDUCED, "weights": benchmark_weights(weights, DEVICE, draw_device="cpu",
                                                              config=L_CONFIG)}
    conf = extract_benchmark_conf(from_yaml(str(ROOT / f"gluefactory_tpu_torch/configs/{L_CONFIG}.yaml")),
                                  "hpatches")
    model = load_model({**conf.model.to_dict(), "weights_file": str(weights)}, None, dev).eval()
    fw = _l_forwards(model, dev, card)
    res["forward"] = fw["pairs"]
    res["attention_gluestick_shape"] = _l_attention(fw["mask"], dev)
    print(f"path L fused_attention at GlueStick's shape: {json.dumps(res['attention_gluestick_shape'])} "
          f"({card})", flush=True)
    del model, fw
    torch.cuda.empty_cache()

    data_path = tsettings.DATA_PATH
    try:
        tsettings.DATA_PATH = HPATCHES_ROOT
        argv = ["--conf", L_CONFIG, f"model.weights_file={weights}", f"data.subset={L_SUBSET}",
                "--tag", "chip_smoke_lines"]
        n_pairs = 5 * sum(s.startswith(L_SUBSET) for s in HPATCHES_SEQUENCES)
        h = run_hpatches([*argv, "eval.estimator=xla_ransac", "--overwrite"])
        _check_launches("path L HPatches", h["launches"],
                        {k: n_pairs * n for k, n in L_LAUNCHES.items()})
        hy = run_eval_cli(hpatches.main, hpatches.HPatchesPipeline, homography_est,
                          "ransac_homography_hybrid",
                          [*argv, "eval.estimator=homography_est", "--overwrite_eval"])
        _check_launches("path L HPatches homography_est", hy["launches"], {})
        for label, r in (("xla_ransac", h), ("homography_est", hy)):
            calls = r["ransac_calls"]
            if not calls or any(c["devices"] != [str(torch.empty(0, device=dev).device)]
                                for c in calls):
                fail(f"path L HPatches {label}: the RANSAC ran on {[c['devices'] for c in calls][:2]}")
            aucs = [k for k in r["summaries"] if k.startswith("H_error_ransac@")]
            res[f"hpatches_{label}"] = {
                "summaries": _finite_summaries(f"path L HPatches {label}", r["summaries"], aucs),
                "seconds": r["seconds"], "launches": r["launches"],
                "ransac_calls": len(calls), "ransac_ms_per_call": float(np.mean([c["ms"] for c in calls])),
                # the homography_est run reads the xla_ransac run's cache
                "export_pairs_per_s": n_pairs / r["seconds"]["get_predictions"]
                if label == "xla_ransac" else None}
            print(f"path L HPatches {label}: {json.dumps(res[f'hpatches_{label}'])} ({card})", flush=True)

        tsettings.DATA_PATH = J_ROOT
        gt_calls = []
        _l_gt_record.checked = False
        _l_gt_record.auction_iterations = []
        argv = ["--conf", L_CONFIG, f"model.weights_file={weights}", "--tag", "chip_smoke_lines"]
        with recorded_forward(DepthMatcher, gt_calls, _l_gt_record), \
                counted_auction(_l_gt_record.auction_iterations):
            e = run_eth3d([*argv, "--overwrite"])
        _check_launches("path L ETH3D", e["launches"],
                        {k: ETH3D_PAIRS * n for k, n in L_LAUNCHES.items()})
        card_device = str(torch.empty(0, device=dev).device)
        if len(gt_calls) != ETH3D_PAIRS or any(c["devices"] != [card_device] for c in gt_calls):
            fail(f"path L: depth_matcher ran {len(gt_calls)} times on {[c['devices'] for c in gt_calls]}")
        if not gt_calls[0]["cpu_equal"]:
            fail("path L: the line GT on the card differs from the CPU's")
        res["eth3d"] = {
            "summaries": _finite_summaries("path L ETH3D", e["summaries"], ["AP", "AP_lines"]),
            "seconds": e["seconds"], "launches": e["launches"],
            "export_pairs_per_s": ETH3D_PAIRS / e["seconds"]["get_predictions"],
            "line_gt_cpu_equal": True,
            "line_positives_per_pair": float(np.mean([c["line_positives"] for c in gt_calls])),
            "auction_iterations": [c["auction_iterations"] for c in gt_calls]}
        print(f"path L ETH3D {L_CONFIG}: {json.dumps(res['eth3d'])} ({card})", flush=True)
    finally:
        tsettings.DATA_PATH = data_path
    res["seconds"] = time.perf_counter() - t0
    res["card"] = card
    print(f"path L: {res['seconds']:.1f} s", flush=True)
    return res


# --------------------------------------------------------------------------
# 17. path M: GlueStick training (stage 1 on homographies, stage 2 on
#     MegaDepth), the wireframes from the loader's workers
# --------------------------------------------------------------------------

M_CONFIGS = ("superpoint+lsd+gluestick-homography", "superpoint+lsd+gluestick-megadepth")
M_ROOT = ROOT / "outputs" / "chip_smoke_path_m"
M_EXPERIMENTS = ("chip_smoke_path_m1", "chip_smoke_path_m2")
M_BATCH, M_STEPS, M_WORKERS, M_TIMED_STEPS, M_VAL_BATCH = 32, 2, 6, 2, 8
M2_BATCH, M2_PER_SCENE, M2_VAL_BATCH, M2_TIMED_STEPS = 16, 12, S2_VAL_BATCH, 2
M2_STEPS = len(S2_TRAIN_SCENES) * M2_PER_SCENE // M2_BATCH
# the trainer runs take each step as M_MICRO micro-batches under
# grad_accumulation (a worker builds a whole batch, so halves load in half
# the time); the timed steps stay at the full batch
M_MICRO = 2
M_NODES = 2 * 250 + 1000  # the configs' junction slots, then their keypoints
# a train step: GlueStick-9's 36 attention calls forward and 36 in the
# checkpoints' recompute; a validation batch: 36
M_STEP_LAUNCHES = {"fused_attention": 2 * 4 * LAYERS}
M_VAL_LAUNCHES = {"fused_attention": 4 * LAYERS}
M_LOSSES = {"total", "matcher_assignment_nll", "matcher_line_assignment_nll"}
M_INTER_LOSSES = {"matcher_line_2_assignment_nll", "matcher_line_5_assignment_nll"}
# the loaders' own batches (merged into the steps' batches), so that every
# worker has batches to make
M_LOADER_BATCHES = (8, 4)
M_REDUCED = {
    "stage 1": f"{M_CONFIGS[0]} at its widths (SuperPoint 1000 keypoints at threshold 0, frozen; "
               "250 LSD lines, min length 15, nms 4; GlueStick-9 256 wide, 4 heads, inter_supervision "
               f"[2, 5], checkpointed; f32, dark photometry): procedural images for revisitop1m, batch "
               f"{M_BATCH} for 160 ({M_MICRO} micro-batches of {M_BATCH // M_MICRO} under grad_accumulation "
               f"{M_MICRO} in the trainer's run; the timed steps at {M_BATCH}), {M_WORKERS} workers for 15, "
               f"{M_STEPS} updates and one validation batch of {M_VAL_BATCH}",
    "stage 2": f"{M_CONFIGS[1]} at its widths (1024 square-padded, batch {M2_BATCH}): path H's "
               f"procedural scenes ({len(S2_TRAIN_SCENES)} + 1 of {S2_VIEWS} views at 1600 x 1200) for "
               f"MegaDepth, {M2_PER_SCENE} pairs a scene for 300, {M2_VAL_BATCH} validation pairs, "
               f"{S2_WORKERS} workers for 14, {M2_STEPS} updates ({M_MICRO} micro-batches of "
               f"{M2_BATCH // M_MICRO} each in the trainer's run) and one validation batch, warm-started "
               "from stage 1's experiment",
    "weights": "SuperPoint drawn as path L draws it (random from seed 0, the descriptor head centred "
               "on one scene); GlueStick as the trainer initialises it: no checkpoint is on disk",
}


def m_argv(stage: int) -> list:
    common = ["--conf", M_CONFIGS[stage], "--no_tensorboard", "--no_capture", "--max_val_iters", "1",
              "train.epochs=1", "train.log_every_iter=1", "train.eval_every_iter=1000000"]
    if stage == 0:
        return [M_EXPERIMENTS[0], *common, f"data.synthetic_images={M_BATCH * M_STEPS + M_VAL_BATCH}",
                f"data.train_size={M_BATCH * M_STEPS}", f"data.val_size={M_VAL_BATCH}",
                f"data.batch_size={M_BATCH // M_MICRO}", f"train.grad_accumulation={M_MICRO}",
                f"data.val_batch_size={M_VAL_BATCH}", f"data.num_workers={M_WORKERS}"]
    return [M_EXPERIMENTS[1], *common, "data.data_dir=megadepth",
            f"data.train_split=[{','.join(S2_TRAIN_SCENES)}]", f"data.val_split=[{S2_VAL_SCENE}]",
            f"data.train_num_per_scene={M2_PER_SCENE}", f"data.batch_size={M2_BATCH // M_MICRO}",
            f"train.grad_accumulation={M_MICRO}",
            f"data.val_batch_size={M2_VAL_BATCH}", f"data.num_workers={S2_WORKERS}",
            f"train.load_experiment={M_EXPERIMENTS[0]}"]


def _m_gt_record(self, data, out) -> dict:
    """A ground-truth call's devices and its positive point and line
    matches."""
    return {"devices": sorted({str(v.device) for v in out.values()}),
            "positives": int((out["gt_matches0"] >= 0).sum()),
            "line_positives": int((out["gt_line_matches0"] >= 0).sum())}


def run_gluestick_trainer(label: str, argv: list, gt_cls, steps: int, loss_keys: set,
                          sp_state: dict | None = None, first_state: list | None = None):
    """`run_trainer(argv)` with, where `sp_state` is given, SuperPoint's
    weights loaded into the model when its TrainStep is made (before its
    first step); each ground-truth call recorded (`_m_gt_record`); the
    LSD's detections in this process counted around the run. Gates:
    `steps` train steps, every loss term finite and those of `loss_keys`
    there, every update applied, exact launches, a positive line match in
    every batch, the GT on the card, and no LSD in this process (the
    workers gave every wireframe)."""
    from gluefactory_tpu_torch import train
    from gluefactory_tpu_torch.models.lines import lsd

    init = train.TrainStep.__init__

    def with_superpoint(self, model, *args, **kwargs):
        init(self, model, *args, **kwargs)
        if sp_state is not None:
            model.extractor.point_extractor.load_state_dict(sp_state)

    gt_calls = []
    train.TrainStep.__init__ = with_superpoint
    detections = lsd.detections
    try:
        with recorded_forward(gt_cls, gt_calls, _m_gt_record):
            records, seconds, launches, model = run_trainer(argv, first_state)
    finally:
        train.TrainStep.__init__ = init
    _check_launches(label, launches, {k: steps * n + M_VAL_LAUNCHES[k] for k, n in M_STEP_LAUNCHES.items()})
    if len(records) != steps:
        fail(f"{label}: {len(records)} train steps, expected {steps}")
    losses = [{k: float(v) for k, v in r[0].items()} for r in records]
    for i, (step_losses, (_, _, info)) in enumerate(zip(losses, records)):
        if not (loss_keys <= set(step_losses) and all(math.isfinite(v) for v in step_losses.values())):
            fail(f"{label}: step {i}'s loss terms are not all there and finite: {step_losses}")
        if not bool(info["ok"]):
            fail(f"{label}: the update of step {i} was not applied")
    card = str(torch.empty(0, device=DEVICE).device)
    if len(gt_calls) != steps + 1 or any(c["devices"] != [card] or c["line_positives"] < 1
                                         for c in gt_calls):
        fail(f"{label}: ground truth {gt_calls}")
    if lsd.detections != detections:
        fail(f"{label}: the LSD ran {lsd.detections - detections} times in the main process")
    return {"seconds": seconds, "launches": launches, "losses": losses,
            "grad_norms": [float(r[2]["grad_norm"]) for r in records], "gt": gt_calls,
            "main_process_lsd_calls": 0}, model


def lsd_in_workers(images: list, workers: int, conf) -> dict:
    """`precompute_wireframe` on each image in `workers` loader workers (as
    the datasets run it, all workers busy at once): ms an image, each timed
    in its worker, and the segments kept."""
    from gluefactory_tpu_torch.models.lines.wireframe import precompute_wireframe

    class Timed(torch.utils.data.Dataset):
        def __len__(self):
            return len(images)

        def __getitem__(self, i):
            t0 = time.perf_counter()
            out = precompute_wireframe(images[i], conf.max_num_lines, conf.min_length, conf.nms_radius)
            return 1e3 * (time.perf_counter() - t0), int(out["line_mask"].sum())

    loader = torch.utils.data.DataLoader(Timed(), batch_size=None, num_workers=workers)
    timed = list(loader)
    ms = [t for t, _ in timed]
    return {"images": len(images), "image": list(images[0].shape), "workers": workers,
            "ms_mean": float(np.mean(ms)), "ms_min": float(np.min(ms)), "ms_max": float(np.max(ms)),
            "lines_mean": float(np.mean([n for _, n in timed]))}


def m_loader(label: str, conf, dataset: str, batch: int, loader_batch: int) -> tuple[dict, list]:
    """The training loader's samples/s over the first two steps' samples,
    in its own batches of `loader_batch`, with `detect_lines` on (those two
    batches of `batch` kept on the card), and off over one step's samples;
    the LSD's ms an image in
    the workers on the first batch's views; the kept batches' wireframe
    keys with their dtypes on the card."""
    data = merge(conf.data, {"batch_size": loader_batch})
    rate, batches = loader_rate(data, keep=2, dataset=dataset, merge=batch // loader_batch,
                                max_samples=2 * batch)
    off, _ = loader_rate(merge(data, {"detect_lines": {"do": False}}), dataset=dataset,
                         max_samples=batch)
    for b in batches:
        for v in ("view0", "view1"):
            view = b[v]
            if not (view["lines_junc_idx"].dtype == torch.int32 and view["line_mask"].dtype == torch.bool
                    and view["junc_mask"].dtype == torch.bool
                    and view["lines"].device.type == torch.device(DEVICE).type):
                fail(f"{label}: the batch's wireframe keys are {[(k, view[k].dtype) for k in view]}")
    images = [b[v]["image"][i].cpu().numpy() for b in batches[:1] for v in ("view0", "view1")
              for i in range(b[v]["image"].shape[0])]
    lsd_ms = lsd_in_workers(images, conf.data.num_workers, conf.data.detect_lines)
    res = {"samples_per_s": rate, "samples_per_s_without_lines": off, "lsd_in_workers": lsd_ms,
           "workers": int(conf.data.num_workers), "loader_batch": loader_batch}
    print(f"{label} loader: {rate:.2f} samples/s with detect_lines, {off:.2f} without "
          f"({conf.data.num_workers} workers, {os.cpu_count()} cores); LSD + clustering in the "
          f"workers {json.dumps(lsd_ms)}", flush=True)
    return res, batches


def m_attention(mask: torch.Tensor, dev) -> dict:
    """`fused_attention` at GlueStick's training shape, (B, 4, 1500, 64)
    f32, with a batch's real node mask on queries and keys: the forward
    against its plain version (1e-4), the gradients (the plain backward
    through `ops/_autograd.py`) within TRAIN_TOL of the plain gradients'
    norm; device times of the forward and of forward + backward against
    the plain version's and SDPA's with the same boolean mask; the bound
    counts valid queries x valid keys."""
    F = torch.nn.functional
    gen = torch.Generator(device=dev).manual_seed(7)
    B, N = mask.shape
    xs = [torch.randn(B, HEADS, N, HEAD_DIM, generator=gen, device=dev).requires_grad_() for _ in range(3)]
    q, k, v = xs
    cot = torch.randn(B, HEADS, N, HEAD_DIM, generator=gen, device=dev)
    args = (q, k, v, mask, mask)
    valid = mask.sum(-1).double()
    nk, pairs = float(valid.sum()), float((valid * valid).sum())
    n_ops, n_exps = 4.0 * HEADS * pairs * HEAD_DIM, 1.0 * HEADS * pairs
    n_bytes = (3 * nk + B * N) * HEADS * HEAD_DIM * 4 + 2 * mask.numel()
    bound_ms, bound_by = _bound(n_ops, n_bytes, torch.float32, n_exps)
    attn_mask = mask[:, None, None, :]
    kernel, plain = cuda_attention.fused_attention, cuda_attention.attention_plain

    def fwd_bwd(fn):
        return torch.autograd.grad(fn(), xs, cot)

    with torch.no_grad():
        err = _err(kernel(*args), plain(*args))
    grads = fwd_bwd(lambda: kernel(*args))
    grads_plain = fwd_bwd(lambda: plain(*args))
    grad_err = max(float((a - b).abs().max() / torch.linalg.vector_norm(b)) for a, b in zip(grads, grads_plain))
    del grads, grads_plain
    with torch.no_grad():
        res = {"shape": [B, HEADS, N, HEAD_DIM], "dtype": "float32", "valid_nodes": int(nk),
               "max_abs_err": err, "tol": KERNEL_TOL[torch.float32], "grad_max_rel_err": grad_err,
               "grad_tol": TRAIN_TOL,
               "ms": device_time_ms(lambda: kernel(*args)),
               "plain_ms": device_time_ms(lambda: plain(*args), reps=3),
               "library_ms": device_time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask)),
               "bound_ms": bound_ms, "bound_by": bound_by}
    res["fwd_bwd_ms"] = device_time_ms(lambda: fwd_bwd(lambda: kernel(*args)), reps=3)
    res["plain_fwd_bwd_ms"] = device_time_ms(lambda: fwd_bwd(lambda: plain(*args)), reps=3)
    res["library_fwd_bwd_ms"] = device_time_ms(
        lambda: fwd_bwd(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask)), reps=3)
    if not (err <= KERNEL_TOL[torch.float32] and grad_err <= TRAIN_TOL):
        fail(f"path M: fused_attention at GlueStick's training shape against its plain version: {res}")
    return res


def _m_timing(label: str, model, batches, device_info, conf, batch: int, timed: int) -> dict:
    t = time_training(model, batches, device_info, conf=conf, batch=batch, label=label, accum2=False,
                      timed=timed, step_launches=M_STEP_LAUNCHES)
    print(f"{label} timing: {t['ms_per_step']:.2f} ms/step, device {t['device_ms_per_step']} ms/step, "
          f"busy share {t['busy_share']}, {t['samples_per_s']:.2f} samples/s, peak "
          f"{t['peak_memory_gib']:.2f} GiB at batch {batch} ({device_info['nvidia_smi']})", flush=True)
    print(f"{label} top device items: {json.dumps(t['profile']['top'][:8])}", flush=True)
    return t


def phase_gluestick_training(device_info: dict) -> dict:
    """Path M: the trainer on the two GlueStick configs by name, cut as
    M_REDUCED says. Stage 1 (`run_gluestick_trainer`'s gates), `--restore`
    bit-equal with the running statistics, the loader with and without
    lines and the LSD in the workers, a step through the kernel against the
    plain versions (gradients and statistics), the attention at (32, 4,
    1500, 64) with the batch's node mask forward and under autograd, then
    ms a step. Stage 2 on path H's scenes, warm-started from stage 1: its
    gates, its first state equal to stage 1's last (the inter-layer line
    projections, which it does not supervise, aside), `--restore`, the
    loaders and ms a step. Needs path H's scenes."""
    import gluefactory_tpu_torch.settings as tsettings
    from gluefactory_tpu_torch.models.matchers.depth_matcher import DepthMatcher
    from gluefactory_tpu_torch.models.matchers.homography_matcher import HomographyMatcher
    from gluefactory_tpu_torch.settings import TRAINING_PATH

    card = device_info["nvidia_smi"]
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    print(f"path M reduced: {json.dumps(M_REDUCED)}", flush=True)
    shutil.rmtree(M_ROOT, ignore_errors=True)
    M_ROOT.mkdir(parents=True)
    for e in M_EXPERIMENTS:
        shutil.rmtree(Path(TRAINING_PATH, e), ignore_errors=True)
    weights = M_ROOT / "weights.pth"
    res = {"reduced": M_REDUCED, "weights": benchmark_weights(weights, DEVICE, draw_device="cpu",
                                                              config=L_CONFIG)}
    prefix = "extractor.point_extractor."
    sp_state = {k[len(prefix):]: v for k, v in torch.load(weights, map_location=DEVICE).items()
                if k.startswith(prefix)}

    # stage 1
    argv = m_argv(0)
    conf = train_conf(argv, f"gluefactory_tpu_torch/configs/{M_CONFIGS[0]}.yaml")
    run, model = run_gluestick_trainer("path M stage 1", argv, HomographyMatcher, M_STEPS * M_MICRO,
                                       M_LOSSES | M_INTER_LOSSES, sp_state)
    stage1_state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    res["stage1"] = s1 = {"argv": argv, "run": run}
    print(f"path M stage 1: {M_STEPS} updates of {M_MICRO} micro-batches and 1 validation batch in "
          f"{run['seconds']:.1f} s, launches "
          f"{json.dumps(run['launches'])}, losses finite, every update applied, line positives a batch "
          f"{[c['line_positives'] for c in run['gt']]}, no LSD in the main process; total "
          f"{run['losses'][0]['total']:.4f} -> {run['losses'][-1]['total']:.4f}", flush=True)
    s1["restore"] = check_restore(model, argv, M_EXPERIMENTS[0], M_STEPS, "path M stage 1")
    s1["loader"], batches = m_loader("path M stage 1", conf, "homographies", M_BATCH, M_LOADER_BATCHES[0])
    s1["vs_plain"] = train_step_vs_plain(model, batches[0], "path M stage 1", M_STEP_LAUNCHES)
    n_stats = 2 * (2 * len(conf.model.matcher.get("keypoint_encoder", [32, 64, 128, 256])) + 3 * LAYERS)
    if not (s1["vs_plain"]["running_stats"] == n_stats and s1["vs_plain"]["running_stats_moved"] > 0):
        fail(f"path M stage 1: the step did not move every BatchNorm statistic: {s1['vs_plain']}")
    print(f"path M stage 1 step vs plain: {json.dumps(s1['vs_plain'])}", flush=True)
    with torch.no_grad():
        pred = model(batches[0], generator=torch.Generator(device=DEVICE).manual_seed(0))
    mask = pred["keypoint_mask0"]
    if list(mask.shape) != [M_BATCH, M_NODES]:
        fail(f"path M: the node mask is {list(mask.shape)}, expected {[M_BATCH, M_NODES]}")
    s1["nodes"] = {"valid_mean": float(mask.sum(-1).float().mean()),
                   "lines_mean": float(pred["line_mask0"].sum(-1).float().mean())}
    del pred
    s1["timing"] = _m_timing("path M stage 1", model, batches, device_info, conf, M_BATCH, M_TIMED_STEPS)
    del model, batches
    torch.cuda.empty_cache()
    s1["attention"] = m_attention(mask, dev)
    print(f"path M fused_attention at {s1['attention']['shape']} with a batch's node mask: "
          f"{json.dumps(s1['attention'])} ({card})", flush=True)

    # stage 2, on path H's scenes
    data_path, tsettings.DATA_PATH = tsettings.DATA_PATH, S2_ROOT
    try:
        argv = m_argv(1)
        conf = train_conf(argv, f"gluefactory_tpu_torch/configs/{M_CONFIGS[1]}.yaml")
        first_state = []
        run, model = run_gluestick_trainer("path M stage 2", argv, DepthMatcher, M2_STEPS * M_MICRO, M_LOSSES,
                                           first_state=first_state)
        res["stage2"] = s2 = {"argv": argv, "run": run}
        state = first_state[0]
        skipped = sorted(set(stage1_state) - set(state))
        if set(state) - set(stage1_state) or any(not k.startswith("matcher.inter_line_proj.") for k in skipped) \
                or any(not torch.equal(v, stage1_state[k]) for k, v in state.items()):
            fail(f"path M stage 2: the warm-started model differs from stage 1's last (skipped {skipped})")
        run["warm_start"] = {"experiment": M_EXPERIMENTS[0], "tensors": len(state), "bit_equal": True,
                             "skipped": skipped}
        print(f"path M stage 2: {M2_STEPS} updates of {M_MICRO} micro-batches and 1 validation batch in "
              f"{run['seconds']:.1f} s, "
              f"launches {json.dumps(run['launches'])}, losses finite, every update applied, line "
              f"positives a batch {[c['line_positives'] for c in run['gt']]}; warm start "
              f"{json.dumps(run['warm_start'])}", flush=True)
        s2["restore"] = check_restore(model, argv, M_EXPERIMENTS[1], M2_STEPS, "path M stage 2")
        s2["loader"], batches = m_loader("path M stage 2", conf, "megadepth", M2_BATCH, M_LOADER_BATCHES[1])
        s2["timing"] = _m_timing("path M stage 2", model, batches, device_info, conf, M2_BATCH,
                                 M2_TIMED_STEPS)
        del model, batches
        torch.cuda.empty_cache()
    finally:
        tsettings.DATA_PATH = data_path
    for s, batch in ((s1, M_BATCH), (s2, M2_BATCH)):
        s["pace"] = "loader" if s["loader"]["samples_per_s"] < s["timing"]["samples_per_s"] else "step"
    print(f"path M pace: stage 1 the {s1['pace']}, stage 2 the {s2['pace']}", flush=True)
    res["seconds"] = time.perf_counter() - t0
    res["card"] = card
    print(f"path M: {res['seconds']:.1f} s", flush=True)
    return res


# --------------------------------------------------------------------------
# 18. path N: the learned-extractor zoo (ALIKED, DISK, SuperPoint-open)
#     with LightGlue, by config name
# --------------------------------------------------------------------------

N_ROOT = ROOT / "outputs" / "chip_smoke_path_n"
N_FORWARD = (("N1", "aliked+lightglue-official"), ("N2", "disk+lightglue-official"))
N_HPATCHES = "aliked+lightglue-official"
N_TRAIN = (("N4a", "aliked+lightglue_homography", "chip_smoke_path_n4a"),
           ("N4b", "superpoint-open+lightglue_homography", "chip_smoke_path_n4b"))
N_SIZE = (1600, 1200)  # (w, h): MegaDepth-1500's resize, 1600 on the long side
N_TIMED = 5  # timed forwards of N1 / N2, after one warm-up
N_STEPS, N_WORKERS = 2, 6
N_TOL = 1e-3  # kernels vs plain versions on the log assignment, f32
N_REDUCED = {
    "N1 / N2": f"the configs' megadepth1500 sections at their widths (2048 keypoints at threshold 0, "
               f"LightGlue-9 256 wide, 4 heads, input_dim 128, f32) on one procedural {N_SIZE[0]} x "
               f"{N_SIZE[1]} pair (a scene and its warp) for MegaDepth-1500's 1500",
    "N3": f"{N_HPATCHES}'s hpatches section (1024 keypoints, xla_ransac) on path F's "
          f"{5 * sum(s.startswith('v') for s in HPATCHES_SEQUENCES)} procedural v_ pairs for 540",
    "N4": f"{N_TRAIN[0][1]} and {N_TRAIN[1][1]} at their widths (512 keypoints, frozen extractor, "
          f"LightGlue-9 checkpointed, f32, lg photometry): procedural images for revisitop1m, batch "
          f"{TRAIN_BATCH} for 128, {N_WORKERS} workers for 14, {N_STEPS} steps and one validation batch "
          f"of {VAL_BATCH}",
    "weights": "random from seed 0 as path F draws them (lecun-normal, zero biases, the descriptor head "
               "centred on one scene: `centre_descriptors`); no official checkpoint is on disk",
}


def _n_views():
    """A procedural 1600 x 1200 scene and its view through a homography."""
    from gluefactory_tpu_torch.data.homographies import generate_synthetic_image, warp_patch

    base = generate_synthetic_image(7200, N_SIZE).astype(np.float32)
    H = np.array([[0.98, 0.04, 25.0], [-0.03, 1.01, -18.0], [2e-5, -1e-5, 1.0]])
    return base, np.clip(warp_patch(base, H, N_SIZE), 0, 1).astype(np.float32)


def _zoo_record(self, data, out) -> dict:
    """One extractor call's gates: outputs finite, descriptors unit-norm,
    keypoints inside `image_size` (the image's size without it)."""
    kp, desc = out["keypoints"], out["descriptors"]
    size = data.get("image_size")
    if size is None:
        h, w = data["image"].shape[1:3]
        size = torch.tensor([[w, h]], dtype=torch.float32, device=kp.device).expand(kp.shape[0], 2)
    finite = all(bool(torch.isfinite(t).all()) for t in (kp, desc, out["keypoint_scores"]))
    return {"finite": finite, "norm_err": float((desc.float().norm(dim=-1) - 1).abs().max()),
            "inside": bool(((kp >= 0) & (kp <= size.to(kp.dtype)[:, None, :])).all()),
            "valid": int(out["keypoint_mask"].sum()), "keypoints": list(kp.shape)}


def _check_zoo_records(label: str, records: list) -> None:
    if not records or not all(r["finite"] and r["inside"] and r["norm_err"] <= 1e-3 for r in records):
        fail(f"{label}: extractor outputs not finite, not unit-norm or outside the image: {records[:4]}")


def _n_forward(label: str, config: str, views, device_info: dict, root: Path = N_ROOT,
               overrides: dict | None = None, record=_zoo_record, launches: dict = MAIN_LAUNCHES) -> dict:
    """N1 / N2 (and O1 / O2): the config's megadepth1500 model (by name,
    random weights saved under `root`, the model conf merged with
    `overrides`) on one pair through the pipeline's entry point: `launches`
    counted around one forward, the extractor's outputs gated by `record`
    on every call, wall ms (CUDA events over N_TIMED forwards) and device ms
    (profile), the extractor alone, the plain versions' forward against the
    kernels' (N_TOL on the log assignment, the matches' agreement), and,
    where the forward launches them, both attention kernels at its layout
    against their bound and SDPA."""
    from gluefactory_tpu_torch.core.config import from_yaml
    from gluefactory_tpu_torch.eval.io import extract_benchmark_conf, load_model

    card = device_info["nvidia_smi"]
    dev = torch.device(DEVICE)
    img0, img1 = views
    view = {"image": img0, "image_size": np.array(N_SIZE, np.float32)}
    weights = root / f"{label}.pth"
    res = {"config": config, "weights": benchmark_weights(weights, DEVICE, "megadepth1500", view=view,
                                                          draw_device="cpu", config=config)}
    conf = extract_benchmark_conf(from_yaml(str(ROOT / f"gluefactory_tpu_torch/configs/{config}.yaml")),
                                  "megadepth1500")
    model = load_model(merge(conf.model, {**(overrides or {}), "weights_file": str(weights)}), None, dev)
    batch = _l_batch(img0, img1, dev)
    forward = pipeline_forward(model, batch, torch.Generator(device=dev))
    records = []
    ext_cls = type(model.extractor)
    with recorded_forward(ext_cls, records, record):
        reset_all_launches()
        with torch.no_grad():
            pred = forward()
            torch.cuda.synchronize()
        _check_launches(f"path {label}", all_launches(), launches)
    _check_zoo_records(f"path {label}", records)
    for k, t in pred.items():
        if t.is_floating_point() and not torch.isfinite(t).all():
            fail(f"path {label}: {k} is not finite")
    K = int(conf.model.extractor.max_num_keypoints)
    if list(pred["keypoints0"].shape) != [1, K, 2] or pred["descriptors0"].shape[-1] != 128:
        fail(f"path {label}: keypoints {list(pred['keypoints0'].shape)}, descriptors "
             f"{list(pred['descriptors0'].shape)}")
    with torch.no_grad():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(N_TIMED):
            forward()
        end.record()
        torch.cuda.synchronize()
        wall_ms = start.elapsed_time(end) / N_TIMED
        stacked = {k: torch.cat([batch["view0"][k], batch["view1"][k]]) for k in ("image", "image_size")}
        ext_ms = cuda_time_ms(lambda: model.extractor(stacked), reps=3)
    prof = profile_forward(forward)
    set_flash(model, False)
    reset_all_launches()
    with torch.no_grad():
        plain = forward()
    set_flash(model, True)
    _check_launches(f"path {label} plain", all_launches(), {})
    valid = (plain["log_assignment"] > -1e6) & (pred["log_assignment"] > -1e6)
    gap = float((plain["log_assignment"] - pred["log_assignment"])[valid].abs().max())
    agreement = float((plain["matches0"] == pred["matches0"]).float().mean())
    if not gap <= N_TOL:
        fail(f"path {label}: kernels vs plain versions {gap} > {N_TOL}")
    res.update({
        "image": [N_SIZE[1], N_SIZE[0]], "keypoints": K, "launches": launches,
        "wall_ms": wall_ms, "device_ms": prof["device_ms"],
        "busy_share": prof["device_ms"] / wall_ms if prof["device_ms"] else None,
        "extractor_ms_two_views": ext_ms, "attention_kernel_ms": prof["attention_kernel_ms"],
        "vs_plain": {"log_assignment_max_abs_err": gap, "tol": N_TOL, "matches0_agreement": agreement},
        "matches": int((pred["matches0"] >= 0).sum()),
        "valid_keypoints": [int(pred[f"keypoint_mask{i}"].sum()) for i in "01"],
        "extractor_gates": records[0], "top_kernels": prof["top"][:8], "card": card})
    print(f"path {label} {config}: {json.dumps({k: v for k, v in res.items() if k != 'top_kernels'})}",
          flush=True)
    del model, pred, plain
    torch.cuda.empty_cache()
    if launches:
        res["attention"] = attention_at_shapes(dev, torch.float32, K, 1, f"path {label}", backward=False)
    return res


def _n_hpatches(device_info: dict) -> dict:
    """N3: the HPatches CLI on `aliked+lightglue-official` by name with
    `xla_ransac` on path F's v_ sequences: 9 + 9 launches a pair, the
    RANSAC on the card, the extractor's gates on every call, finite AUCs."""
    import gluefactory_tpu_torch.settings as tsettings

    weights = N_ROOT / "N3.pth"
    res = {"weights": benchmark_weights(weights, DEVICE, draw_device="cpu", config=N_HPATCHES)}
    n_pairs = 5 * sum(s.startswith("v") for s in HPATCHES_SEQUENCES)
    records = []
    data_path, tsettings.DATA_PATH = tsettings.DATA_PATH, HPATCHES_ROOT
    try:
        with recorded_forward(get_model("aliked"), records, _zoo_record):
            h = run_hpatches(["--conf", N_HPATCHES, "eval.estimator=xla_ransac", "data.subset=v",
                              f"model.weights_file={weights}", "--tag", "chip_smoke_zoo", "--overwrite"])
    finally:
        tsettings.DATA_PATH = data_path
    _check_launches("path N3", h["launches"], {k: n_pairs * n for k, n in MAIN_LAUNCHES.items()})
    _check_zoo_records("path N3", records)
    if {r["keypoints"][1] for r in records} != {1024}:
        fail(f"path N3: the extractor gave {[r['keypoints'] for r in records][:2]} keypoints, expected 1024")
    calls = h["ransac_calls"]
    if not calls or any(c["devices"] != [str(torch.empty(0, device=DEVICE).device)] for c in calls):
        fail(f"path N3: the RANSAC ran on {[c['devices'] for c in calls][:2]}, expected the card")
    aucs = [f"H_error_{k}@{t}px" for k in ("dlt", "ransac") for t in (1, 3, 5)]
    res.update({"summaries": _finite_summaries("path N3", h["summaries"], aucs), "pairs": n_pairs,
                "launches": h["launches"], "seconds": h["seconds"],
                "export_pairs_per_s": n_pairs / h["seconds"]["get_predictions"],
                "ransac_ms_per_call": float(np.mean([c["ms"] for c in calls])),
                "matches_per_pair": float(np.mean(h["results"]["num_matches"])),
                "extractor_calls": len(records), "card": device_info["nvidia_smi"]})
    print(f"path N3 HPatches {N_HPATCHES}: {json.dumps(res)}", flush=True)
    return res


def n_argv(config: str, experiment: str) -> list:
    return [experiment, "--conf", config, "--no_tensorboard", "--no_capture", "--max_val_iters", "1",
            f"data.synthetic_images={TRAIN_BATCH * N_STEPS + VAL_BATCH}",
            f"data.train_size={TRAIN_BATCH * N_STEPS}", f"data.val_size={VAL_BATCH}",
            f"data.batch_size={TRAIN_BATCH}", f"data.val_batch_size={VAL_BATCH}",
            f"data.num_workers={N_WORKERS}", "train.epochs=1", "train.log_every_iter=1",
            "train.eval_every_iter=1000000"]


def _running_stats(module) -> dict:
    return {n: b.detach().clone() for n, b in module.named_buffers() if "running" in n}


def _n_training(label: str, config: str, experiment: str, device_info: dict) -> dict:
    """N4: `train.main` on a stage-1 config by name, the extractor's drawn
    weights loaded when its TrainStep is made; the extractor's outputs
    gated on every call and its running statistics read after each step.
    Gates: the steps' losses finite, every update applied, 18 + 18 launches
    and 9 + 9 for the validation batch; the frozen extractor's BatchNorm as
    in the JAX trainer (`make_train_step` keeps the mutated batch_stats):
    every statistic of a BatchNorm that normalises by the batch in training
    moves at every step (all of ALIKED's; the open SuperPoint's but its two
    1x1 heads', which keep their running statistics), the validation batch
    moves none, and the last checkpoint holds them. Also ms a step (each
    step synchronised) and the run's peak memory."""
    from gluefactory_tpu_torch import train
    from gluefactory_tpu_torch.settings import TRAINING_PATH
    from gluefactory_tpu_torch.utils.experiments import get_last_checkpoint, load_checkpoint

    shutil.rmtree(Path(TRAINING_PATH, experiment), ignore_errors=True)
    weights = N_ROOT / f"{label}.pth"
    res = {"config": config, "weights": benchmark_weights(weights, DEVICE, draw_device="cpu", config=config)}
    ext_state = {k[len("extractor."):]: v for k, v in torch.load(weights, map_location=DEVICE).items()
                 if k.startswith("extractor.")}
    init, call = train.TrainStep.__init__, train.TrainStep.__call__
    stats, step_ms = [], []

    def with_extractor(self, model, *args, **kwargs):
        init(self, model, *args, **kwargs)
        model.extractor.load_state_dict(ext_state)
        stats.append(_running_stats(model.extractor))

    def recorded(self, batch, generator=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call(self, batch, generator)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        stats.append(_running_stats(self.model.extractor))
        return out

    records, argv = [], n_argv(config, experiment)
    torch.cuda.reset_peak_memory_stats()
    train.TrainStep.__init__, train.TrainStep.__call__ = with_extractor, recorded
    try:
        ext_cls = get_model(config.split("+")[0].replace("-", "_"))
        with recorded_forward(ext_cls, records, _zoo_record):
            steps, seconds, launches, model = run_trainer(argv)
    finally:
        train.TrainStep.__init__, train.TrainStep.__call__ = init, call
    _check_launches(f"path {label}", launches, {k: N_STEPS * n + VAL_LAUNCHES[k]
                                                for k, n in STEP_LAUNCHES.items()})
    _check_zoo_records(f"path {label}", records)
    if len(steps) != N_STEPS or len(records) != N_STEPS + 1:
        fail(f"path {label}: {len(steps)} steps and {len(records)} extractor calls")
    losses = [{k: float(v) for k, v in r[0].items()} for r in steps]
    for i, (step_losses, (_, _, info)) in enumerate(zip(losses, steps)):
        if not all(math.isfinite(v) for v in step_losses.values()) or not bool(info["ok"]):
            fail(f"path {label}: step {i}: losses {step_losses}, update applied {bool(info['ok'])}")
    by_batch = {n for n in stats[0] if not n.startswith(("detector.1.", "descriptor.1."))}
    moved = [sorted(n for n in stats[0] if not torch.equal(stats[i][n], stats[i + 1][n]))
             for i in range(N_STEPS)]
    final = _running_stats(model.extractor)
    saved = load_checkpoint(get_last_checkpoint(experiment), map_location=DEVICE)["model"]
    kept = all(torch.equal(final[n], stats[-1][n]) and torch.equal(saved[f"extractor.{n}"], final[n])
               for n in final)
    if not stats[0] or any(set(m) != by_batch for m in moved) or not kept:
        fail(f"path {label}: the frozen extractor's statistics moved {[len(m) for m in moved]} of "
             f"{len(by_batch)} a step; kept through validation and in the checkpoint: {kept}")
    res.update({"argv": argv, "seconds": seconds, "step_ms": step_ms,
                "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
                "launches": launches, "losses": losses,
                "grad_norms": [float(r[2]["grad_norm"]) for r in steps],
                "running_stats": len(stats[0]), "moved_each_step": len(by_batch),
                "kept_running": sorted(set(stats[0]) - by_batch),
                "max_move": [max(float((stats[i + 1][n] - stats[i][n]).abs().max()) for n in by_batch)
                             for i in range(N_STEPS)],
                "extractor_gates": records[-1], "card": device_info["nvidia_smi"]})
    print(f"path {label} {config}: {json.dumps(res)}", flush=True)
    del model
    torch.cuda.empty_cache()
    return res


def phase_zoo(device_info: dict) -> dict:
    """Path N: the learned-extractor zoo with LightGlue by config name, cut
    as N_REDUCED says: N1 and N2 forwards at 1600 x 1200, N3 the HPatches
    CLI, N4 two stage-1 trainings. Needs path F's HPatches layout (written
    here where it is missing)."""
    t0 = time.perf_counter()
    print(f"path N reduced: {json.dumps(N_REDUCED)}", flush=True)
    shutil.rmtree(N_ROOT, ignore_errors=True)
    N_ROOT.mkdir(parents=True)
    if not (HPATCHES_ROOT / "hpatches-sequences-release").exists():
        write_hpatches(HPATCHES_ROOT)
    views = _n_views()
    res = {"reduced": N_REDUCED}
    for label, config in N_FORWARD:
        res[label] = _n_forward(label, config, views, device_info)
    res["N3"] = _n_hpatches(device_info)
    for label, config, experiment in N_TRAIN:
        res[label] = _n_training(label, config, experiment, device_info)
    res["seconds"] = time.perf_counter() - t0
    res["card"] = device_info["nvidia_smi"]
    print(f"path N: {res['seconds']:.1f} s", flush=True)
    return res


# --------------------------------------------------------------------------
# 19. path O: SIFT on the card (`ops/sift.py`, `extractor.backend=jax`)
#     with LightGlue's add_scale_ori and with the NN matcher, by config name
# --------------------------------------------------------------------------

O_ROOT = ROOT / "outputs" / "chip_smoke_path_o"
O_FORWARD = (("O1", "sift+lightglue-official", MAIN_LAUNCHES), ("O2", "sift+NN", {}))
O_TRAIN, O_EXPERIMENT = "sift+lightglue_homography", "chip_smoke_path_o3"
O_DEVICE = {"extractor": {"backend": "jax"}}  # the configs ship the opencv backend; the card has no cv2
O_REDUCED = {
    "O1 / O2": f"the configs' megadepth1500 sections at their widths (SIFT on the card, 2048 keypoints; "
               f"LightGlue-9 256 wide, 4 heads, input_dim 128, add_scale_ori, f32; or the NN matcher) on "
               f"path N's procedural {N_SIZE[0]} x {N_SIZE[1]} pair for MegaDepth-1500's 1500",
    "O3": f"{O_TRAIN} at its widths (SIFT 512 keypoints on the card, frozen; LightGlue-9 checkpointed, "
          f"add_scale_ori, f32, lg photometry): procedural images for revisitop1m, batch {TRAIN_BATCH} for "
          f"128, {N_WORKERS} workers for 14, {N_STEPS} steps and one validation batch of {VAL_BATCH}",
    "weights": "LightGlue random from seed 0 as path F draws them (lecun-normal, zero biases); SIFT has none",
}


def _sift_record(self, data, out) -> dict:
    """One SIFT call's gates, on its valid slots: outputs finite, keypoints
    inside `image_size`, descriptors unit-norm (RootSIFT), scales > 0."""
    valid = out["keypoint_mask"]
    kp, desc = out["keypoints"][valid], out["descriptors"][valid]
    size = data["image_size"].to(kp.dtype)[:, None, :].expand_as(out["keypoints"])[valid]
    finite = all(bool(torch.isfinite(out[k]).all()) for k in ("keypoints", "descriptors", "keypoint_scores",
                                                               "scales", "oris"))
    return {"finite": finite, "norm_err": float((desc.norm(dim=-1) - 1).abs().max()) if len(desc) else 1.0,
            "inside": bool(((kp >= 0) & (kp <= size)).all()),
            "scales_positive": bool((out["scales"][valid] > 0).all()),
            "valid": int(valid.sum()), "keypoints": list(out["keypoints"].shape)}


def _check_sift_records(label: str, records: list) -> None:
    _check_zoo_records(label, records)
    if not all(r["scales_positive"] and r["valid"] > 0 for r in records):
        fail(f"{label}: SIFT gave no valid keypoint or a scale <= 0: {records[:4]}")


def _sift_alone(view: np.ndarray, device_info: dict) -> dict:
    """SIFT on the card (the config's extractor, `ops/sift.py`) on one
    image: ms (CUDA events), device kernels launched (profile) and the
    peak memory above what was allocated before the call."""
    from torch.profiler import ProfilerActivity, profile

    from gluefactory_tpu_torch.core.config import from_yaml

    dev = torch.device(DEVICE)
    conf = from_yaml(str(ROOT / "gluefactory_tpu_torch/configs/sift+lightglue-official.yaml")).model.extractor
    sift = get_model("sift").from_conf({**conf.to_dict(), **O_DEVICE["extractor"]}, device=dev)
    data = {"image": torch.from_numpy(view[None]).to(dev),
            "image_size": torch.tensor([[float(N_SIZE[0]), float(N_SIZE[1])]], device=dev)}
    with torch.no_grad():
        sift(data)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = sift(data)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        ms = cuda_time_ms(lambda: sift(data), reps=5)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            sift(data)
            torch.cuda.synchronize()
    rows = [ev for ev in prof.key_averages() if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0]
    res = {"ms_an_image": ms, "device_kernels_an_image": sum(ev.count for ev in rows) or None,
           "device_ms_an_image": sum(ev.self_device_time_total for ev in rows) / 1e3 or None,
           "peak_memory_gib_an_image": peak / 2**30, "valid_keypoints": int(out["keypoint_mask"].sum()),
           "top": sorted(({"kernel": ev.key[:100], "ms": ev.self_device_time_total / 1e3, "calls": ev.count}
                          for ev in rows), key=lambda r: -r["ms"])[:8],
           "card": device_info["nvidia_smi"]}
    print(f"path O SIFT alone: {json.dumps(res)}", flush=True)
    return res


def _opencv_backend_raises() -> dict:
    """O4: the opencv backend where cv2 is absent (the card's machine; where
    it is importable, the check blocks it) raises an ImportError naming cv2
    and the device backend, with no fallback."""
    import importlib.util

    present = importlib.util.find_spec("cv2") is not None
    saved = sys.modules.get("cv2")
    if present:
        sys.modules["cv2"] = None
    try:
        sift = get_model("sift").from_conf({"max_num_keypoints": 16}, device=DEVICE)
        sift({"image": torch.rand(1, 32, 48, 1, device=DEVICE)})
    except ImportError as e:
        message = str(e)
    else:
        fail("path O4: the opencv SIFT backend ran without cv2")
    finally:
        if present:
            sys.modules["cv2"] = saved
    if "cv2" not in message or "extractor.backend=jax" not in message:
        fail(f"path O4: the error does not name cv2 and the device backend: {message}")
    return {"cv2_installed": present, "error": message}


def _o_training(device_info: dict) -> dict:
    """O3: `train.main` on the stage-1 SIFT config by name with the device
    backend: finite losses, every update applied, 18 + 18 launches a step
    and 9 + 9 for the validation batch, ms a step (each step synchronised)
    and the run's peak memory."""
    from gluefactory_tpu_torch import train
    from gluefactory_tpu_torch.settings import TRAINING_PATH

    shutil.rmtree(Path(TRAINING_PATH, O_EXPERIMENT), ignore_errors=True)
    weights = O_ROOT / "O3.pth"
    res = {"config": O_TRAIN, "weights": benchmark_weights(weights, DEVICE, draw_device="cpu", config=O_TRAIN)}
    argv = [*n_argv(O_TRAIN, O_EXPERIMENT), "model.extractor.backend=jax"]
    call, step_ms, records = train.TrainStep.__call__, [], []

    def timed(self, batch, generator=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call(self, batch, generator)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    torch.cuda.reset_peak_memory_stats()
    train.TrainStep.__call__ = timed
    try:
        with recorded_forward(get_model("sift"), records, _sift_record):
            steps, seconds, launches, model = run_trainer(argv)
    finally:
        train.TrainStep.__call__ = call
    _check_launches("path O3", launches, {k: N_STEPS * n + VAL_LAUNCHES[k] for k, n in STEP_LAUNCHES.items()})
    _check_sift_records("path O3", records)
    if len(steps) != N_STEPS or len(records) != N_STEPS + 1:
        fail(f"path O3: {len(steps)} steps and {len(records)} extractor calls")
    losses = [{k: float(v) for k, v in r[0].items()} for r in steps]
    for i, (step_losses, (_, _, info)) in enumerate(zip(losses, steps)):
        if not all(math.isfinite(v) for v in step_losses.values()) or not bool(info["ok"]):
            fail(f"path O3: step {i}: losses {step_losses}, update applied {bool(info['ok'])}")
    res.update({"argv": argv, "seconds": seconds, "step_ms": step_ms,
                "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": launches,
                "losses": losses, "grad_norms": [float(r[2]["grad_norm"]) for r in steps],
                "extractor_gates": records[-1], "card": device_info["nvidia_smi"]})
    print(f"path O3 {O_TRAIN}: {json.dumps(res)}", flush=True)
    del model
    torch.cuda.empty_cache()
    return res


def phase_sift(device_info: dict) -> dict:
    """Path O: SIFT on the card, cut as O_REDUCED says: O1 / O2 forwards at
    1600 x 1200 (with SIFT alone on one image), O3 a stage-1 training, O4
    the opencv backend without cv2."""
    t0 = time.perf_counter()
    print(f"path O reduced: {json.dumps(O_REDUCED)}", flush=True)
    shutil.rmtree(O_ROOT, ignore_errors=True)
    O_ROOT.mkdir(parents=True)
    views = _n_views()
    res = {"reduced": O_REDUCED}
    for label, config, launches in O_FORWARD:
        res[label] = _n_forward(label, config, views, device_info, root=O_ROOT, overrides=O_DEVICE,
                                record=_sift_record, launches=launches)
    res["sift_alone"] = _sift_alone(views[0], device_info)
    res["O3"] = _o_training(device_info)
    res["O4"] = _opencv_backend_raises()
    res["seconds"] = time.perf_counter() - t0
    res["card"] = device_info["nvidia_smi"]
    print(f"path O: {res['seconds']:.1f} s", flush=True)
    return res


# --------------------------------------------------------------------------
# 20. path P: LoFTR (`loftr.yaml`) on the card, a forward and the HPatches CLI
# --------------------------------------------------------------------------

P_ROOT = ROOT / "outputs" / "chip_smoke_path_p"
P_CONFIG = "loftr"
P_SIZE = (832, 624)  # (w, h): MegaDepth-1500's resize for LoFTR, 832 on the long side, divisible by 8
P_REDUCED = {
    "P1": f"{P_CONFIG}'s megadepth1500 section at its widths (ResNet-FPN 8/2, 4 coarse layer pairs 256 "
          f"wide, 8 heads, 2048 match slots, f32) on one procedural {P_SIZE[0]} x {P_SIZE[1]} pair (a "
          f"scene and its warp) for MegaDepth-1500's 1500",
    "P2": f"{P_CONFIG}'s hpatches section (480 on the short side, divisible by 8, xla_ransac) on path "
          f"F's {5 * sum(s.startswith('v') for s in HPATCHES_SEQUENCES)} procedural v_ pairs for 540",
    "weights": "random from seed 0 as path F draws them (lecun-normal, zero biases), made to match by "
               "`loftr_pass_through` on one scene; no official checkpoint is on disk",
}


def _p_forward(weights: Path, device_info: dict) -> dict:
    """P1: the LoFTR pipeline on one pair: no port kernel launched, wall ms
    (CUDA events) and device ms (profile), peak memory, valid matches, and
    every keypoint finite and inside its image."""
    from gluefactory_tpu_torch.core.config import from_yaml
    from gluefactory_tpu_torch.data.homographies import generate_synthetic_image, warp_patch
    from gluefactory_tpu_torch.eval.io import extract_benchmark_conf, load_model

    dev = torch.device(DEVICE)
    base = generate_synthetic_image(7200, P_SIZE).astype(np.float32)
    H = np.array([[0.98, 0.04, 12.0], [-0.03, 1.01, -9.0], [2e-5, -1e-5, 1.0]])
    img1 = np.clip(warp_patch(base, H, P_SIZE), 0, 1).astype(np.float32)
    view = {"image": base, "image_size": np.array(P_SIZE, np.float32)}
    res = {"config": P_CONFIG, "weights": benchmark_weights(weights, DEVICE, "megadepth1500", view=view,
                                                            draw_device="cpu", config=P_CONFIG)}
    conf = extract_benchmark_conf(from_yaml(str(ROOT / f"gluefactory_tpu_torch/configs/{P_CONFIG}.yaml")),
                                  "megadepth1500")
    model = load_model(merge(conf.model, {"weights_file": str(weights)}), None, dev)
    batch = _l_batch(base, img1, dev)
    forward = pipeline_forward(model, batch, torch.Generator(device=dev))
    with torch.no_grad():
        forward()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        reset_all_launches()
        pred = forward()
        torch.cuda.synchronize()
        _check_launches("path P1", all_launches(), {})
        peak = torch.cuda.max_memory_allocated() - before
        wall_ms = cuda_time_ms(forward, reps=N_TIMED, warmup=0)
    prof = profile_forward(forward)
    valid = pred["keypoint_mask0"][0]
    K = int(conf.model.matcher.max_num_matches)
    size = torch.tensor(P_SIZE, dtype=torch.float32, device=dev)
    kp = torch.cat([pred["keypoints0"][0][valid], pred["keypoints1"][0][valid]])
    if list(pred["keypoints0"].shape) != [1, K, 2] or not all(
            torch.isfinite(t).all() for t in (pred["keypoints0"], pred["keypoints1"], pred["matching_scores0"])):
        fail(f"path P1: keypoints {list(pred['keypoints0'].shape)} or not finite")
    if not int(valid.sum()) or not bool(((kp >= 0) & (kp <= size)).all()):
        fail(f"path P1: {int(valid.sum())} valid matches, keypoints inside the image: "
             f"{bool(((kp >= 0) & (kp <= size)).all())}")
    p0 = pred["keypoints0"][0][valid].double().cpu().numpy()
    w = np.c_[p0, np.ones(len(p0))] @ H.T
    err = np.linalg.norm(w[:, :2] / w[:, 2:] - pred["keypoints1"][0][valid].double().cpu().numpy(), axis=1)
    res.update({"image": [P_SIZE[1], P_SIZE[0]], "coarse_cells": (P_SIZE[0] // 8) * (P_SIZE[1] // 8),
                "match_slots": K, "valid_matches": int(valid.sum()),
                "median_error_px": float(np.median(err)), "wall_ms": wall_ms, "device_ms": prof["device_ms"],
                "busy_share": prof["device_ms"] / wall_ms if prof["device_ms"] else None,
                "peak_memory_gib": peak / 2**30, "top_kernels": prof["top"][:8],
                "card": device_info["nvidia_smi"]})
    print(f"path P1 {P_CONFIG}: {json.dumps(res)}", flush=True)
    del model, pred
    torch.cuda.empty_cache()
    return res


def _p_hpatches(weights: Path, device_info: dict) -> dict:
    """P2: the HPatches CLI on `loftr` by name with `xla_ransac` on path F's
    v_ sequences: no port kernel, the RANSAC on the card, finite AUCs, the
    cache written as `predictions.h5` and read back by an `--overwrite_eval`
    rerun."""
    import gluefactory_tpu_torch.settings as tsettings

    n_pairs = 5 * sum(s.startswith("v") for s in HPATCHES_SEQUENCES)
    argv = ["--conf", P_CONFIG, "eval.estimator=xla_ransac", "data.subset=v", f"model.weights_file={weights}"]
    data_path, tsettings.DATA_PATH = tsettings.DATA_PATH, HPATCHES_ROOT
    try:
        h = run_hpatches([*argv, "--tag", "chip_smoke_loftr", "--overwrite"])
        cache = _cache("chip_smoke_loftr")
        rerun = check_cache_rerun("path P2", run_hpatches, argv, "hpatches", "chip_smoke_loftr", h["summaries"])
    finally:
        tsettings.DATA_PATH = data_path
    _check_launches("path P2", h["launches"], {})
    if len(cache) != n_pairs:
        fail(f"path P2: {len(cache)} cached items in predictions.h5, expected {n_pairs}")
    calls = h["ransac_calls"]
    if not calls or any(c["devices"] != [str(torch.empty(0, device=DEVICE).device)] for c in calls):
        fail(f"path P2: the RANSAC ran on {[c['devices'] for c in calls][:2]}, expected the card")
    aucs = [f"H_error_{k}@{t}px" for k in ("dlt", "ransac") for t in (1, 3, 5)]
    res = {"summaries": _finite_summaries("path P2", h["summaries"], aucs), "pairs": n_pairs,
           "seconds": h["seconds"], "export_pairs_per_s": n_pairs / h["seconds"]["get_predictions"],
           "ransac_ms_per_call": float(np.mean([c["ms"] for c in calls])),
           "matches_per_pair": float(np.mean(h["results"]["num_matches"])), "rerun": rerun,
           "cache_items": len(cache), "card": device_info["nvidia_smi"]}
    print(f"path P2 HPatches {P_CONFIG}: {json.dumps(res)}", flush=True)
    return res


def phase_loftr(device_info: dict) -> dict:
    """Path P: LoFTR by config name, cut as P_REDUCED says. Needs path F's
    HPatches layout (written here where it is missing)."""
    t0 = time.perf_counter()
    print(f"path P reduced: {json.dumps(P_REDUCED)}", flush=True)
    shutil.rmtree(P_ROOT, ignore_errors=True)
    P_ROOT.mkdir(parents=True)
    if not (HPATCHES_ROOT / "hpatches-sequences-release").exists():
        write_hpatches(HPATCHES_ROOT)
    weights = P_ROOT / "P.pth"
    res = {"reduced": P_REDUCED, "P1": _p_forward(weights, device_info), "P2": _p_hpatches(weights, device_info)}
    res["seconds"] = time.perf_counter() - t0
    res["card"] = device_info["nvidia_smi"]
    print(f"path P: {res['seconds']:.1f} s", flush=True)
    return res


Q_CONFIG = "roma"
Q_TIMED = 3  # timed forwards of Q1, after one warm-up
Q_PAIRS = 2  # of path G's pairs, for Q2
Q_TOL = 1e-3  # the card's RoMa against the CPU's at the tests' widths (warp and certainty)
# the widths of tests/test_torch_roma.py
Q_NARROW = {
    "net": {"dinov2": {"weights": "dinov2_vits14", "embed_dim": 32, "depth": 1, "num_heads": 2},
            "vgg_blocks": [[8, 2], [16, 2], [16, 2], [16, 2]], "gp_dim": 16, "decoder_blocks": 1,
            "decoder_heads": 2, "anchor_res": 4,
            "proj_dims": {"16": 16, "8": 16, "4": 16, "2": 8, "1": 9},
            "disp_emb_dims": {"16": 8, "8": 8, "4": 4, "2": 4, "1": 2},
            "corr_radius": {"16": 2, "8": 1, "4": 1, "2": None, "1": None}, "hidden_blocks": 2},
    "internal_hw": [56, 56], "output_hw": [112, 112],
}
Q_REDUCED = {
    "Q1": f"{Q_CONFIG}'s megadepth1500 section at its widths (DINOv2-L 24 blocks 1024 wide, VGG19-BN, GP 512, "
          "5 decoder blocks, 64 x 64 anchors, internal 630^2, output 1344^2, 5000 sampled matches, f32 on "
          "bf16-rounded images) on one of path G's procedural pairs at 1024 on the long side for "
          "MegaDepth-1500's 1500",
    "Q2": f"the megadepth1500 CLI on {Q_CONFIG} (xla_ransac, png depths) on {Q_PAIRS} of path G's pairs "
          "for 1500",
    "Q3": "grid_extractor (cell 14) with RoMa's keypoint snapping on Q1's pair",
    "Q4": "RoMa at the CPU tests' widths (tests/test_torch_roma.py) on Q1's pair, the card against the CPU",
    "Q5": "lightglue_pretrained (superpoint) and mixed (grid_extractor + superpoint) on the main path's "
          "batch and weights",
    "weights": "random: torch's init from seed 0 (Q1, Q3 on the card; Q2 in the CLI's process on the "
               "CPU); no RoMa or DINOv2 checkpoint is on disk",
}


def _q_conf():
    from gluefactory_tpu_torch.core.config import from_yaml
    from gluefactory_tpu_torch.eval.io import extract_benchmark_conf

    return extract_benchmark_conf(from_yaml(str(ROOT / f"gluefactory_tpu_torch/configs/{Q_CONFIG}.yaml")),
                                  "megadepth1500")


def _q_pair(dev) -> tuple[dict, dict]:
    """Path G's first pair as the megadepth1500 section reads it (1024 on
    the long side): the batch on `dev`, and the item."""
    from gluefactory_tpu_torch.data import get_dataset
    from gluefactory_tpu_torch.eval.megadepth1500 import MegaDepth1500Pipeline

    data = MegaDepth1500Pipeline({"data": {**_q_conf().data.to_dict(), "depth_format": "png"}}).conf.data
    item = get_dataset("posed_images")(data).get_dataset("test")[0]
    return _l_batch(item["view0"]["image"], item["view1"]["image"], dev), item


def _q_check_dense(label: str, pred: dict, batch: dict, num: int) -> dict:
    """Warps finite in [-1, 1], certainties in [0, 1], `num` sampled matches
    finite and inside both images."""
    for i in ("0", "1"):
        w, c = pred[f"warp{i}"], pred[f"certainty{i}"]
        if not (torch.isfinite(w).all() and w.abs().max() <= 1 and torch.isfinite(c).all()
                and c.min() >= 0 and c.max() <= 1):
            fail(f"{label}: warp{i} / certainty{i} not finite or out of range")
        kp = pred[f"keypoints{i}"]
        size = batch[f"view{i}"]["image_size"][0]
        if list(kp.shape) != [1, num, 2] or not torch.isfinite(kp).all() or \
                not bool(((kp >= 0) & (kp <= size)).all()):
            fail(f"{label}: keypoints{i} {list(kp.shape)} not {num} finite matches inside the image")
    return {"valid_matches": int(pred["keypoint_mask0"].sum()),
            "certainty_mean": [float(pred[f"certainty{i}"].mean()) for i in "01"],
            "warp_hw": list(pred["warp0"].shape[1:3])}


def _q_forward(device_info: dict) -> tuple[dict, torch.nn.Module, dict]:
    """Q1: RoMa by name on one pair: no port kernel, gates as
    `_q_check_dense`, wall ms (CUDA events), device ms and the top device
    items (profile), busy share, peak memory."""
    dev = torch.device(DEVICE)
    conf = _q_conf()
    mconf = {k: v for k, v in conf.model.matcher.to_dict().items() if k != "name"}
    torch.manual_seed(0)
    t0 = time.perf_counter()
    with torch.device(dev):  # the weights drawn on the card
        model = get_model(Q_CONFIG).from_conf(mconf, device=dev).eval()
    init_s = time.perf_counter() - t0
    batch, item = _q_pair(dev)
    gen = torch.Generator(device=dev)
    forward = lambda: model(batch, generator=gen.manual_seed(0))  # noqa: E731
    with torch.no_grad():
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        reset_all_launches()
        pred = forward()
        torch.cuda.synchronize()
        _check_launches("path Q1", all_launches(), {})
        peak, extra = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_allocated() - before
        wall_ms = cuda_time_ms(forward, reps=Q_TIMED, warmup=0)
    prof = profile_forward(forward)
    res = {"config": Q_CONFIG, "pair": item["name"], "image": list(batch["view0"]["image"].shape[1:3]),
           **_q_check_dense("path Q1", pred, batch, int(mconf["sample_num_matches"])),
           "parameters": sum(p.numel() for p in model.parameters()), "init_s": init_s,
           "first_forward_s": first_s, "wall_ms": wall_ms, "device_ms": prof["device_ms"],
           "busy_share": prof["device_ms"] / wall_ms if prof["device_ms"] else None,
           "peak_memory_gib": peak / 2**30, "forward_memory_gib": extra / 2**30,
           "top_device_items": prof["top"][:10], "card": device_info["nvidia_smi"]}
    print(f"path Q1 {Q_CONFIG}: {json.dumps(res)}", flush=True)
    return res, model, batch


def _q_cli(device_info: dict) -> dict:
    """Q2: the megadepth1500 CLI on `roma` by name on Q_PAIRS of path G's
    pairs: no port kernel, the RANSAC on the card, finite metrics,
    `predictions.h5` and `results.h5` written; an --overwrite_eval rerun
    reads the cache and the results back (`names` as strings)."""
    import gluefactory_tpu_torch.settings as tsettings

    scene = MD_SCENES[0][0]
    pairs = (MD_ROOT / "megadepth1500" / scene / "pairs.txt").read_text().splitlines()[:Q_PAIRS]
    (MD_ROOT / "megadepth1500" / scene / "pairs_q.txt").write_text("\n".join(pairs) + "\n")
    names = ["/".join(n.replace("/", "-") for n in line.split()) for line in pairs]
    argv = ["--conf", Q_CONFIG, "eval.estimator=xla_ransac", "data.depth_format=png",
            f"data.scene_list=[{scene}]", "data.view_groups='{scene}/pairs_q.txt'"]
    from gluefactory_tpu_torch.eval import eval_pipeline

    load_model, load_s = eval_pipeline.load_model, []

    def timed_load(*a, **k):
        t0 = time.perf_counter()
        model = load_model(*a, **k)
        torch.cuda.synchronize()
        load_s.append(time.perf_counter() - t0)
        return model

    torch.manual_seed(0)  # the CLI's model: torch's init on the CPU
    eval_pipeline.load_model = timed_load
    try:
        run = run_megadepth([*argv, "--tag", "chip_smoke_roma", "--overwrite"])
    finally:
        eval_pipeline.load_model = load_model
    exp = Path(tsettings.EVAL_PATH, "megadepth1500", "chip_smoke_roma")
    cache = _cache("chip_smoke_roma", "megadepth1500")
    mtime = (exp / "predictions.h5").stat().st_mtime_ns
    again = run_megadepth([*argv, "--tag", "chip_smoke_roma", "--overwrite_eval"])
    _check_launches("path Q2", run["launches"], {})
    _check_launches("path Q2 --overwrite_eval", again["launches"], {})
    if len(cache) != Q_PAIRS or not (exp / "results.h5").exists():
        fail(f"path Q2: {len(cache)} cached items, expected {Q_PAIRS}; results.h5 "
             f"{(exp / 'results.h5').exists()}")
    if (exp / "predictions.h5").stat().st_mtime_ns != mtime or again["summaries"] != run["summaries"]:
        fail("path Q2: the --overwrite_eval rerun did not reuse the cache or changed the summaries")
    if again["results"]["names"] != names or run["results"]["names"] != names:
        fail(f"path Q2: names read back {again['results']['names']}, expected {names}")
    calls = run["ransac_calls"]
    if not calls or any(c["devices"] != [str(torch.empty(0, device=DEVICE).device)] for c in calls):
        fail(f"path Q2: the RANSAC ran on {[c['devices'] for c in calls]}, expected the card")
    keys = ("mepi_prec@1e-4", "mepi_prec@5e-4", "mepi_prec@1e-3", "mreproj_prec@1px", "mreproj_prec@3px",
            "mgt_match_recall@3px", "mgt_match_precision@3px", "rel_pose_error@5°", "rel_pose_error@10°",
            "rel_pose_error@20°")
    res = {"summaries": _finite_summaries("path Q2", run["summaries"], keys), "pairs": Q_PAIRS,
           "names": names, "seconds": run["seconds"], "model_load_s": load_s, "rerun_seconds": again["seconds"],
           "export_pairs_per_s": Q_PAIRS / run["seconds"]["get_predictions"],
           "ransac_ms_per_call": float(np.mean([c["ms"] for c in calls])),
           "matches_per_pair": run["results"]["num_matches"], "card": device_info["nvidia_smi"]}
    print(f"path Q2 megadepth1500 {Q_CONFIG}: {json.dumps(res)}", flush=True)
    return res


def _q_sparse(model, batch: dict, device_info: dict) -> dict:
    """Q3: `grid_extractor` (cell 14) and RoMa's keypoint snapping (Q1's
    weights, no sampling) through the pipeline on Q1's pair: matches in
    range, one to one in each direction (the mutual check's nearest
    neighbours), scores above `filter_threshold`."""
    dev = torch.device(DEVICE)
    mconf = {k: v for k, v in model.conf.to_dict().items() if k != "name"}
    with torch.device(dev):
        pipe = get_model("two_view_pipeline").from_conf(
            {"extractor": {"name": "grid_extractor", "cell_size": 14},
             "matcher": {"name": Q_CONFIG, **mconf, "sample_num_matches": 0}}, device=dev).eval()
    pipe.matcher.load_state_dict(model.state_dict())
    with torch.no_grad():
        reset_all_launches()
        t0 = time.perf_counter()
        pred = pipe(batch, generator=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    _check_launches("path Q3", all_launches(), {})
    m0, m1 = pred["matches0"][0].long(), pred["matches1"][0].long()
    n0, n1 = pred["keypoints0"].shape[1], pred["keypoints1"].shape[1]
    v0, v1 = m0 >= 0, m1 >= 0
    thr = float(mconf["filter_threshold"])
    ok = (bool(((m0 >= -1) & (m0 < n1)).all()) and bool(((m1 >= -1) & (m1 < n0)).all())
          and len(set(m0[v0].tolist())) == int(v0.sum()) and len(set(m1[v1].tolist())) == int(v1.sum())
          and bool((pred["matching_scores0"][0][v0] > thr).all())
          and bool((pred["matching_scores1"][0][v1] > thr).all()))
    if not ok:
        fail("path Q3: matches out of range, not mutual or scored below the threshold")
    res = {"keypoints": [n0, n1], "matches": [int(v0.sum()), int(v1.sum())], "seconds": seconds,
           "card": device_info["nvidia_smi"]}
    print(f"path Q3 grid_extractor + {Q_CONFIG}: {json.dumps(res)}", flush=True)
    del pipe
    return res


def _q_card_vs_cpu(batch: dict, device_info: dict) -> dict:
    """Q4: RoMa at the CPU tests' widths, the same weights and pair on the
    card and on the host's CPU: warp and certainty within Q_TOL."""
    torch.manual_seed(0)
    cpu = get_model(Q_CONFIG).from_conf(Q_NARROW, device="cpu").eval()
    card = copy.deepcopy(cpu).to(DEVICE)
    batch_cpu = {v: {k: t.cpu() for k, t in batch[v].items()} for v in ("view0", "view1")}
    with torch.no_grad():
        want = cpu(batch_cpu)
        got = card(batch)
    errs = {k: float((got[k].cpu() - want[k]).abs().max()) for k in ("warp0", "warp1", "certainty0", "certainty1")}
    if not all(e <= Q_TOL for e in errs.values()):
        fail(f"path Q4: the card's RoMa against the CPU's: {errs} (tolerance {Q_TOL})")
    res = {"max_abs_err": errs, "tolerance": Q_TOL, "certainty_std": float(want["certainty0"].std()),
           "card": device_info["nvidia_smi"]}
    print(f"path Q4 card vs CPU: {json.dumps(res)}", flush=True)
    return res


def _q_small_modules(device_info: dict) -> dict:
    """Q5: `lightglue_pretrained` (features superpoint) equals `lightglue`
    built from its resolved conf with the same weights, and `mixed`
    (grid_extractor detector, superpoint descriptor sampled from its dense
    map) gives the grid's keypoints, on the main path's batch (bf16)."""
    dev = torch.device(DEVICE)
    batch = make_batch(dev)
    gen = torch.Generator(device=dev)
    res = {}
    pre = build_pipeline(dev, {"extractor": MAIN_CONF["extractor"],
                               "matcher": {"name": "lightglue_pretrained", "features": "superpoint",
                                           "checkpointed": False}})
    resolved = {k: v for k, v in pre.matcher.conf.to_dict().items() if k not in ("features", "name")}
    plain = build_pipeline(dev, {"extractor": MAIN_CONF["extractor"], "matcher": {"name": "lightglue", **resolved}})
    plain.load_state_dict(pre.state_dict())
    with torch.no_grad():
        reset_all_launches()
        a = pre(batch, generator=gen.manual_seed(0))
        launches = all_launches()
        b = plain(batch, generator=gen.manual_seed(0))
    if sorted(a) != sorted(b) or not all(torch.equal(a[k], b[k]) for k in a):
        fail("path Q5: lightglue_pretrained differs from lightglue on its resolved conf")
    if not launches["fused_attention"] or not launches["fused_bidirectional_attention"]:
        fail(f"path Q5: lightglue_pretrained launched {launches}: not through the attention kernels")
    res["lightglue_pretrained"] = {"launches": launches, "depth_confidence": resolved["depth_confidence"],
                                   "width_confidence": resolved["width_confidence"],
                                   "matches_per_pair": float((a["matches0"] >= 0).sum()) / PAIRS}
    del pre, plain, a, b
    sp = {**MAIN_CONF["extractor"], "dense_outputs": True}
    mixed = build_pipeline(dev, {"extractor": {"name": "mixed", "detector": {"name": "grid_extractor",
                                                                             "cell_size": 14},
                                               "descriptor": sp,
                                               "interpolate_descriptors_from": "dense_descriptors"},
                                 "matcher": MAIN_CONF["matcher"]})
    with torch.no_grad():
        reset_all_launches()
        pred = mixed(batch, generator=gen.manual_seed(0))
        launches = all_launches()
        grid = get_model("grid_extractor").from_conf({"cell_size": 14}, device=dev)(batch["view0"])["keypoints"]
    _check_launches("path Q5 mixed", launches, MAIN_LAUNCHES)
    if not torch.equal(pred["keypoints0"], grid) or not torch.equal(pred["keypoints1"], grid):
        fail("path Q5: mixed's keypoints are not the grid's")
    if list(pred["descriptors0"].shape) != [PAIRS, grid.shape[1], DIM] or not torch.isfinite(
            pred["descriptors0"].float()).all():
        fail(f"path Q5: mixed's descriptors {list(pred['descriptors0'].shape)}")
    res["mixed"] = {"keypoints": grid.shape[1], "launches": launches,
                    "matches_per_pair": float((pred["matches0"] >= 0).sum()) / PAIRS}
    res["card"] = device_info["nvidia_smi"]
    print(f"path Q5: {json.dumps(res)}", flush=True)
    return res


def phase_roma(device_info: dict) -> dict:
    """Path Q: RoMa by config name, cut as Q_REDUCED says, and the small
    zoo modules. Needs path G's MegaDepth-1500 layout (written here where it
    is missing)."""
    import gluefactory_tpu_torch.settings as tsettings

    t0 = time.perf_counter()
    print(f"path Q reduced: {json.dumps(Q_REDUCED)}", flush=True)
    if not (MD_ROOT / "megadepth1500").exists():
        write_megadepth(MD_ROOT)
    res = {"reduced": Q_REDUCED}
    data_path, tsettings.DATA_PATH = tsettings.DATA_PATH, MD_ROOT
    try:
        res["Q1"], model, batch = _q_forward(device_info)
        res["Q3"] = _q_sparse(model, batch, device_info)
        del model
        torch.cuda.empty_cache()
        res["Q4"] = _q_card_vs_cpu(batch, device_info)
        res["Q2"] = _q_cli(device_info)
    finally:
        tsettings.DATA_PATH = data_path
    torch.cuda.empty_cache()
    res["Q5"] = _q_small_modules(device_info)
    res["seconds"] = time.perf_counter() - t0
    res["card"] = device_info["nvidia_smi"]
    print(f"path Q: {res['seconds']:.1f} s", flush=True)
    return res


# --------------------------------------------------------------------------
# 22. path R: stage 1 with on-device augmentation (emit_source +
#     device_augment) and steps_per_dispatch
# --------------------------------------------------------------------------

R_EXPERIMENTS = ("chip_smoke_path_r", "chip_smoke_path_r2")
R_STEPS, R_K = 4, 2  # the first run's steps; the second's steps a dispatch (R_STEPS / R_K dispatches)
R_AUGMENT = {"name": "homography", "patch_size": [640, 480], "difficulty": 0.7, "max_angle": 45}
R_SOURCES = 4  # sources of the card-against-CPU check
R_TOL = {"H_0to1": 1e-4, "image": 1e-3}
R_REDUCED = {
    "run": f"path E's config at its widths with data.emit_source and train.device_augment "
           f"{json.dumps(R_AUGMENT)}: procedural 640 x 480 sources for revisitop1m, batch {TRAIN_BATCH} for "
           f"{PUBLISHED_BATCH}, 6 workers for 14, {R_STEPS} steps and one validation batch of {VAL_BATCH}; "
           f"then steps_per_dispatch={R_K} for {R_STEPS // R_K} dispatches",
}


def r_argv(experiment: str, k: int = 1) -> list:
    return [experiment, "--conf", str(ROOT / TRAIN_YAML), "--no_tensorboard", "--no_capture",
            "--max_val_iters", "1", f"data.synthetic_images={TRAIN_BATCH * R_STEPS + VAL_BATCH}",
            f"data.train_size={TRAIN_BATCH * R_STEPS}", f"data.val_size={VAL_BATCH}",
            f"data.batch_size={TRAIN_BATCH}", f"data.val_batch_size={VAL_BATCH}", "data.num_workers=6",
            "data.emit_source=true", "data.source_size=[640,480]",
            "train.device_augment=" + json.dumps(R_AUGMENT), f"train.steps_per_dispatch={k}",
            "train.epochs=1", "train.log_every_iter=1", "train.eval_every_iter=1000000"]


@contextlib.contextmanager
def augment_recorded(record: list):
    """`train.apply_device_augment` patched to append each call's devices
    (the sources', and every tensor's it returns) and the batch's keys."""
    from gluefactory_tpu_torch import train

    apply = train.apply_device_augment

    def wrapped(batch, key, conf):
        out = apply(batch, key, conf)
        tensors = [out["H_0to1"]] + [out[v][k] for v in ("view0", "view1") for k in ("image", "image_size")]
        record.append({"in_keys": sorted(batch), "source": str(batch["source_image"].device),
                       "shape": list(batch["source_image"].shape),
                       "devices": sorted({str(t.device) for t in tensors})})
        return out

    train.apply_device_augment = wrapped
    try:
        yield record
    finally:
        train.apply_device_augment = apply


def _r_run(label: str, argv: list, k: int) -> tuple[dict, torch.nn.Module]:
    """`train.main(argv)` with each step's launches and batch recorded: the
    gates of path R's runs (the workers' items, the augmentation's devices,
    finite losses, applied updates, 18 launches a step, 9 the validation
    batch)."""
    from gluefactory_tpu_torch import train

    call, per_step, batches = train.TrainStep.__call__, [], []

    def counted(self, batch, *args):
        before = all_launches()
        batches.append({"keys": sorted(batch), "views": "view0" in batch})
        out = call(self, batch, *args)
        after = all_launches()
        per_step.append({n: after[n] - before.get(n, 0) for n in after})
        return out

    augments = []
    train.TrainStep.__call__ = counted
    try:
        with augment_recorded(augments):
            steps, seconds, launches, model = run_trainer(argv)
    finally:
        train.TrainStep.__call__ = call
    if len(steps) != R_STEPS:
        fail(f"{label}: {len(steps)} train steps, expected {R_STEPS}")
    if any(b["views"] or "source_image" not in b["keys"] for b in batches):
        fail(f"{label}: the workers shipped more than the source: {batches[:2]}")
    card = str(torch.empty(0, device=DEVICE).device)
    if len(augments) != R_STEPS + 1 or any(a["devices"] != [card] or a["source"] != card
                                           or a["shape"] != [TRAIN_BATCH, 480, 640, 3] and a is not augments[-1]
                                           for a in augments):
        fail(f"{label}: augmentation calls {augments}")
    for i, n in enumerate(per_step):
        _check_launches(f"{label} step {i}", n, STEP_LAUNCHES)
    _check_launches(label, launches, {n: R_STEPS * c + VAL_LAUNCHES[n] for n, c in STEP_LAUNCHES.items()})
    losses = [{n: float(v) for n, v in r[0].items()} for r in steps]
    for i, (step_losses, (_, _, info)) in enumerate(zip(losses, steps)):
        if not all(math.isfinite(v) for v in step_losses.values()) or not bool(info["ok"]):
            fail(f"{label}: step {i}: losses {step_losses}, update applied {bool(info['ok'])}")
    dispatches = [{n: sum(p[n] for p in per_step[j:j + k]) for n in per_step[0]}
                  for j in range(0, R_STEPS, k)]
    return {"argv": argv, "seconds": seconds, "launches": launches, "launches_per_step": per_step[0],
            "launches_per_dispatch": dispatches, "losses": losses,
            "grad_norms": [float(r[2]["grad_norm"]) for r in steps],
            "worker_items": batches[0]["keys"], "augment_calls": augments[:2]}, model


def _r_card_vs_cpu(sources: np.ndarray) -> dict:
    """`generate_homography_pairs` on the card against the host's CPU on
    one key and the same sources: each view's lambda equal, H_0to1 within
    R_TOL relative, the images within R_TOL."""
    from gluefactory_tpu_torch import train
    from gluefactory_tpu_torch.data.device_homography import generate_homography_pairs

    key = train.augment_keys(train.train_key(0), 0, 1)[0]
    kw = {"patch_size": tuple(R_AUGMENT["patch_size"]), "difficulty": R_AUGMENT["difficulty"],
          "max_angle": R_AUGMENT["max_angle"]}
    out, details = {}, {}
    for dev in (DEVICE, "cpu"):
        details[dev] = {}
        with torch.no_grad():
            out[dev] = generate_homography_pairs(torch.from_numpy(sources).to(dev), key, details=details[dev], **kw)
    lam = {dev: [details[dev][v]["lambda"].cpu().tolist() for v in ("view0", "view1")] for dev in details}
    H = [out[d]["H_0to1"].double().cpu() for d in (DEVICE, "cpu")]
    res = {"lambda": lam["cpu"], "lambda_equal": lam[DEVICE] == lam["cpu"],
           "H_0to1_rel_err": float(((H[0] - H[1]).abs().amax((1, 2)) / H[1].abs().amax((1, 2))).max()),
           "image_max_abs_err": max(float((out[DEVICE][v]["image"].cpu() - out["cpu"][v]["image"]).abs().max())
                                    for v in ("view0", "view1")),
           "tol": R_TOL, "window": list(details["cpu"]["window"])}
    if not (res["lambda_equal"] and res["H_0to1_rel_err"] <= R_TOL["H_0to1"]
            and res["image_max_abs_err"] <= R_TOL["image"]):
        fail(f"path R: the card's augmentation differs from the CPU's: {res} (card lambdas {lam[DEVICE]})")
    return res


def _r_photoconsistency(sources: np.ndarray) -> dict:
    """A point of view0 mapped by H_0to1 sees the same content in view1
    (no jitter), on the card: the median difference below 0.05."""
    from gluefactory_tpu_torch.data.device_homography import generate_homography_pairs
    from gluefactory_tpu_torch.geometry.homography import warp_points
    from gluefactory_tpu_torch.ops.grid_sample import grid_sample_nd

    w, h = R_AUGMENT["patch_size"]
    with torch.no_grad():
        b = generate_homography_pairs(torch.from_numpy(sources).to(DEVICE), 1, (w, h), R_AUGMENT["difficulty"],
                                      photometric_strength=0.0, max_angle=R_AUGMENT["max_angle"])
        rng = np.random.default_rng(0)
        pts0 = torch.from_numpy(rng.uniform([0.2 * w, 0.2 * h], [0.8 * w, 0.8 * h],
                                            (len(sources), 500, 2)).astype(np.float32)).to(DEVICE)
        pts1 = warp_points(pts0, b["H_0to1"])
        inb = (pts1[..., 0] > 2) & (pts1[..., 0] < w - 2) & (pts1[..., 1] > 2) & (pts1[..., 1] < h - 2)
        diff = (grid_sample_nd(b["view0"]["image"], pts0) - grid_sample_nd(b["view1"]["image"], pts1)).abs()
    med = float(diff[inb].median())
    res = {"median_abs_diff": med, "points_inside": int(inb.sum()), "limit": 0.05}
    if not (med < 0.05 and int(inb.sum()) > 0):
        fail(f"path R: views inconsistent under H_0to1: {res}")
    return res


def _r_timing(model, sources: list, device_info: dict) -> dict:
    """ms a train step with the augmentation in it (TrainStep with
    device_augment, a fresh optimizer, the keys of the trainer's chain;
    CUDA events over TIMED_STEPS after WARMUP_STEPS), samples/s, peak
    memory, one step's device ms and busy share; and the augmentation of a
    batch alone (CUDA events, and its device ms)."""
    from gluefactory_tpu_torch import train
    from gluefactory_tpu_torch.core.config import Config

    conf = train_conf(r_argv(R_EXPERIMENTS[0]))
    optimizer, schedule = train.build_optimizer(conf.train, model, R_STEPS)
    step = train.TrainStep(model, optimizer, schedule, max_updates=WARMUP_STEPS + TIMED_STEPS + 1,
                           device_augment=conf.train.device_augment)
    gen, rng_key = torch.Generator(device=DEVICE), train.train_key(0)
    keys = train.augment_keys(rng_key, 0, WARMUP_STEPS + TIMED_STEPS + 1)
    for i in range(WARMUP_STEPS):
        step(sources[i % len(sources)], gen.manual_seed(i), keys[i])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(TIMED_STEPS):
        losses, _, info = step(sources[i % len(sources)], gen.manual_seed(i), keys[WARMUP_STEPS + i])
    end.record()
    torch.cuda.synchronize()
    _check_launches("path R timed steps", all_launches(), {n: TIMED_STEPS * c for n, c in STEP_LAUNCHES.items()})
    if not (bool(info["ok"]) and math.isfinite(float(losses["total"]))):
        fail("path R: a timed step was not applied")
    ms = start.elapsed_time(end) / TIMED_STEPS
    res = {"ms_per_step": ms, "samples_per_s": TRAIN_BATCH * 1e3 / ms,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30, "batch": TRAIN_BATCH,
           "steps": TIMED_STEPS, "card": device_info["nvidia_smi"]}
    prof = profile_forward(lambda: step(sources[0], gen.manual_seed(0), keys[-1]), grad=True)
    res.update(device_ms_per_step=prof["device_ms"], top_kernels=prof["top"][:8],
               busy_share=None if prof["device_ms"] is None else prof["device_ms"] / ms)
    aug = Config(R_AUGMENT)
    res["augment_ms"] = cuda_time_ms(lambda: train.apply_device_augment(sources[0], keys[0], aug), reps=5)
    aprof = profile_forward(lambda: train.apply_device_augment(sources[0], keys[0], aug))
    res["augment_device_ms"] = aprof["device_ms"]
    res["augment_top_kernels"] = aprof["top"][:6]
    res["augment_share"] = res["augment_ms"] / ms
    del step
    return res


def phase_device_augment(device_info: dict, path_e: dict | None = None) -> dict:
    """Path R: stage 1 with `data.emit_source` and `train.device_augment`,
    then `steps_per_dispatch`, cut as R_REDUCED says; `path_e`'s loader rate
    beside this loader's."""
    from gluefactory_tpu_torch import train
    from gluefactory_tpu_torch.core.config import Config
    from gluefactory_tpu_torch.settings import TRAINING_PATH

    t0 = time.perf_counter()
    card = device_info["nvidia_smi"]
    print(f"path R reduced: {json.dumps(R_REDUCED)}", flush=True)
    for e in R_EXPERIMENTS:
        shutil.rmtree(Path(TRAINING_PATH, e), ignore_errors=True)
    res = {"reduced": R_REDUCED}
    res["run"], model = _r_run("path R", r_argv(R_EXPERIMENTS[0]), 1)
    run = res["run"]
    print(f"path R: {R_STEPS} steps and 1 validation batch in {run['seconds']:.1f} s, launches "
          f"{json.dumps(run['launches'])}, workers ship {run['worker_items']}, augmentation on the card, "
          f"losses finite, every update applied; total {run['losses'][0]['total']:.4f} -> "
          f"{run['losses'][-1]['total']:.4f}", flush=True)
    res["dispatch_run"], _ = _r_run("path R dispatch", r_argv(R_EXPERIMENTS[1], R_K), R_K)
    d = res["dispatch_run"]
    for j, n in enumerate(d["launches_per_dispatch"]):
        _check_launches(f"path R dispatch {j}", n, {k: R_K * c for k, c in STEP_LAUNCHES.items()})
    print(f"path R steps_per_dispatch={R_K}: {R_STEPS // R_K} dispatches in {d['seconds']:.1f} s, launches a "
          f"dispatch {json.dumps(d['launches_per_dispatch'][0])}, losses finite", flush=True)
    res["loader_samples_per_s"], sources = loader_rate(train_conf(r_argv(R_EXPERIMENTS[0])).data, keep=2,
                                                       max_samples=2 * TRAIN_BATCH)
    if any(set(b) != {"source_image"} for b in sources):
        fail(f"path R loader: batches hold {[sorted(b) for b in sources]}")
    raw = sources[0]["source_image"][:R_SOURCES].cpu().numpy()
    res["card_vs_cpu"] = _r_card_vs_cpu(raw)
    print(f"path R augmentation, card vs CPU: {json.dumps(res['card_vs_cpu'])}", flush=True)
    res["photoconsistency"] = _r_photoconsistency(raw)
    print(f"path R photoconsistency: {json.dumps(res['photoconsistency'])}", flush=True)
    key = train.augment_keys(train.train_key(0), 1, 1)[0]
    views = train.apply_device_augment(sources[0], key, Config(R_AUGMENT))
    res["vs_plain"] = train_step_vs_plain(model, views, "path R")
    print(f"path R step vs plain: {json.dumps(res['vs_plain'])}", flush=True)
    del views
    res["timing"] = t = _r_timing(model, sources, device_info)
    e_rate = (path_e or {}).get("loader_samples_per_s")
    res["path_e_loader_samples_per_s"] = e_rate
    res["pace"] = "loader" if res["loader_samples_per_s"] < t["samples_per_s"] else "step"
    print(f"path R timing: {t['ms_per_step']:.2f} ms/step, device {t['device_ms_per_step']} ms/step, "
          f"{t['samples_per_s']:.1f} samples/s, busy share {t['busy_share']}, peak "
          f"{t['peak_memory_gib']:.2f} GiB; augmentation of {TRAIN_BATCH}: {t['augment_ms']:.2f} ms, device "
          f"{t['augment_device_ms']} ms ({card})", flush=True)
    print(f"path R pace: the {res['pace']} sets it (emit_source loader {res['loader_samples_per_s']:.1f} "
          f"samples/s, path E's lg loader {e_rate}, step {t['samples_per_s']:.1f} samples/s)", flush=True)
    del model, sources
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    res["card"] = card
    print(f"path R: {res['seconds']:.1f} s", flush=True)
    return res


# --------------------------------------------------------------------------
# 23. path S: KeyNet + HardNet with the NN matcher
# --------------------------------------------------------------------------

S_CONF = {"extractor": {"name": "keynet_affnet_hardnet", "max_num_keypoints": 2048},
          "matcher": {"name": "nearest_neighbor_matcher"}}  # two_view_pipeline's
S_SMALL = (320, 240)  # (w, h) of the card-against-CPU pair
S_SMALL_KEYPOINTS = 512  # its keypoints: 2048 at 320 x 240 would be mostly zero-score ties
S_TOL = {"response": 1e-3, "margin": 1e-5}
S_REDUCED = {
    "S": f"keynet_affnet_hardnet (2048 keypoints, nms 4, patch scale 12, oriented) with the NN matcher "
         f"on path N's procedural {N_SIZE[0]} x {N_SIZE[1]} pair; random weights from seed 0 (torch's "
         f"init, BatchNorm statistics 0 / 1): no kornia checkpoint is on disk",
}


def _s_record(self, data, out) -> dict:
    rec = _zoo_record(self, data, out)
    rec["oris_in_range"] = bool(((out["oris"] >= -math.pi - 1e-5) & (out["oris"] <= math.pi + 1e-5)).all())
    rec["finite"] = rec["finite"] and bool(torch.isfinite(out["oris"]).all())
    return rec


def _s_card_vs_cpu(model, views) -> dict:
    """The extractor (its weights, S_SMALL_KEYPOINTS keypoints) on the card
    against the host's CPU on a 320 x 240 pair: the responses within S_TOL,
    the keypoints equal where the top-k's margin to the next score exceeds
    S_TOL["margin"]."""
    from gluefactory_tpu_torch.models.extractors.keynet_affnet_hardnet import GRAY

    w, h = S_SMALL
    small = np.stack([np.ascontiguousarray(v[:h * 5:5, :w * 5:5]) for v in views])  # every 5th pixel
    gray = torch.from_numpy((small * np.float32(GRAY)).sum(-1, dtype=np.float32))[:, None]
    conf = {**S_CONF["extractor"], "max_num_keypoints": S_SMALL_KEYPOINTS}
    exts = {}
    for dev in (DEVICE, "cpu"):
        exts[dev] = get_model(conf["name"]).from_conf(conf, device=dev).eval()
        exts[dev].load_state_dict(model.extractor.state_dict())
    out = {}
    with torch.no_grad():
        for dev, ext in exts.items():
            resp = ext.detector.model(gray.to(dev)).cpu()
            pred = ext({"image": torch.from_numpy(small).to(dev)})
            out[dev] = (resp, pred["keypoints"].cpu(), pred["keypoint_scores"].cpu())
    resp_err = float((out[DEVICE][0] - out["cpu"][0]).abs().max())
    scores = out["cpu"][2]
    srt = scores.sort(dim=-1).values
    gaps = torch.diff(srt, dim=-1)
    margin = torch.minimum(torch.cat([torch.full_like(gaps[:, :1], float("inf")), gaps], -1),
                           torch.cat([gaps, torch.full_like(gaps[:, :1], float("inf"))], -1))
    margin = margin.gather(-1, scores.argsort(-1).argsort(-1))
    clear = margin > S_TOL["margin"]
    equal = (out[DEVICE][1] == out["cpu"][1]).all(-1)
    res = {"response_max_abs_err": resp_err, "clear_keypoints": int(clear.sum()),
           "clear_equal": int((equal & clear).sum()), "all_equal": int(equal.sum()),
           "keypoints": int(equal.numel()), "tol": S_TOL, "size": [h, w]}
    if not (resp_err <= S_TOL["response"] and bool(equal[clear].all())):
        fail(f"path S: the card's KeyNet differs from the CPU's: {res}")
    return res


def phase_keynet(device_info: dict) -> dict:
    """Path S: KeyNet + HardNet and the NN matcher through the pipeline's
    entry point, cut as S_REDUCED says."""
    t0 = time.perf_counter()
    card = device_info["nvidia_smi"]
    dev = torch.device(DEVICE)
    print(f"path S reduced: {json.dumps(S_REDUCED)}", flush=True)
    torch.manual_seed(0)
    model = get_model("two_view_pipeline").from_conf(S_CONF, device="cpu").to(dev).eval()
    views = _n_views()
    batch = _l_batch(*views, dev)
    forward = pipeline_forward(model, batch, torch.Generator(device=dev))
    records = []
    with recorded_forward(type(model.extractor), records, _s_record):
        reset_all_launches()
        with torch.no_grad():
            pred = forward()
            torch.cuda.synchronize()
        _check_launches("path S", all_launches(), {})
    if not records or not all(r["finite"] and r["inside"] and r["norm_err"] <= 1e-3 and r["oris_in_range"]
                              for r in records):
        fail(f"path S: extractor outputs not finite, not unit-norm, outside the image or orientations out "
             f"of range: {records}")
    for k, t in pred.items():
        if t.is_floating_point() and not torch.isfinite(t).all():
            fail(f"path S: {k} is not finite")
    if list(pred["keypoints0"].shape) != [1, 2048, 2] or pred["descriptors0"].shape[-1] != 128:
        fail(f"path S: keypoints {list(pred['keypoints0'].shape)}, descriptors {list(pred['descriptors0'].shape)}")
    with torch.no_grad():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(N_TIMED):
            forward()
        end.record()
        torch.cuda.synchronize()
        wall_ms = start.elapsed_time(end) / N_TIMED
        stacked = torch.cat([batch["view0"]["image"], batch["view1"]["image"]])
        gray = (stacked * torch.tensor((0.299, 0.587, 0.114), device=dev)).sum(-1)[:, None]
        keynet_ms = cuda_time_ms(lambda: model.extractor.detector.model(gray), reps=5)
        extractor_ms = cuda_time_ms(lambda: model.extractor({"image": stacked}), reps=3)
    prof = profile_forward(forward)
    res = {"reduced": S_REDUCED, "image": [N_SIZE[1], N_SIZE[0]], "keypoints": 2048, "wall_ms": wall_ms,
           "device_ms": prof["device_ms"],
           "busy_share": prof["device_ms"] / wall_ms if prof["device_ms"] else None,
           "keynet_ms_two_views": keynet_ms, "extractor_ms_two_views": extractor_ms,
           "matches": int((pred["matches0"] >= 0).sum()),
           "valid_keypoints": [int(pred[f"keypoint_mask{i}"].sum()) for i in "01"],
           "extractor_gates": records[0], "top_kernels": prof["top"][:8], "card": card}
    res["card_vs_cpu"] = _s_card_vs_cpu(model, views)
    print(f"path S: {json.dumps({k: v for k, v in res.items() if k != 'top_kernels'})}", flush=True)
    del model, pred
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    print(f"path S: {res['seconds']:.1f} s", flush=True)
    return res


# path T: DeepLSD (gluefactory_tpu/models/lines/deeplsd.py's defaults)
T_LINES = 250  # max_num_lines
T_PLANTED = 250  # planted segments an image for the GT-field vectorisation
T_TIMED = 3  # timed forwards a backend, after one warm-up
T_TRAIN = (8, 480, 640)  # batch, h, w of the Adam steps
T_STEPS = 3
T_SMALL = {"channels": [8, 16, 32], "hw": (120, 160)}
T_TOL = {"net": 1e-4, "fields": 1e-5}
T_BACKENDS = {
    "native": {"backend": "native", "channels": [64, 128, 256], "max_num_lines": T_LINES},
    "package-layout": {"backend": "package-layout", "max_num_lines": T_LINES},
}
T_REDUCED = {
    "T": f"both DeepLSD backends at their default widths (native channels 64/128/256; the package "
         f"layout's deeplsd_md.tar widths) on path N's procedural {N_SIZE[0]} x {N_SIZE[1]} pair, "
         f"{T_LINES} lines, random weights from seed 0 (no DeepLSD checkpoint is on disk); GT fields "
         f"of {T_PLANTED} random segments an image vectorised; {T_STEPS} Adam steps of the native net "
         f"at batch {T_TRAIN[0]}, {T_TRAIN[2]} x {T_TRAIN[1]}, on GT fields of random segments",
}


def _t_segments(rng, B, L, h, w) -> np.ndarray:
    """Random segments of 20-300 px inside the image, (B, L, 2, 2) xy."""
    a = rng.uniform([0, 0], [w, h], (B, L, 2))
    ang = rng.uniform(0, 2 * math.pi, (B, L))
    length = rng.uniform(20, 300, (B, L))
    b = np.clip(a + length[..., None] * np.stack([np.cos(ang), np.sin(ang)], -1), 0,
                [w - 1, h - 1])
    return np.stack([a, b], 2).astype(np.float32)


def _t_recovered(planted: np.ndarray, lines: np.ndarray, valid: np.ndarray, tol: float = 3.0) -> dict:
    """Detections lying on a planted segment (both endpoints within `tol`
    px of it) and planted segments covered by such a detection."""
    hits, covered = 0, set()
    for det in lines[valid]:
        a, ab = planted[:, 0], planted[:, 1] - planted[:, 0]
        len2 = np.maximum((ab ** 2).sum(-1), 1e-6)
        d = []
        for p in det:
            t = np.clip(((p - a) * ab).sum(-1) / len2, 0, 1)
            d.append(np.linalg.norm(p - (a + t[:, None] * ab), axis=-1))
        on = np.flatnonzero(np.maximum(*d) <= tol)
        hits += bool(len(on))
        covered.update(on.tolist())
    return {"detections": int(valid.sum()), "on_a_planted_segment": hits,
            "planted_covered": len(covered), "planted": int(len(planted))}


def _t_forward(label: str, images: torch.Tensor, device_info: dict) -> dict:
    from gluefactory_tpu_torch.models.lines.deeplsd import lines_from_fields_host
    from gluefactory_tpu_torch.ops.hough import hough_lines_p

    dev = images.device
    torch.manual_seed(0)
    model = get_model("lines.deeplsd").from_conf(T_BACKENDS[label], device=dev).eval()
    B, H, W = images.shape[:3]
    forward = lambda: model({"image": images})  # noqa: E731
    with torch.no_grad():
        pred = forward()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(T_TIMED):
            pred = forward()
        end.record()
        torch.cuda.synchronize()
        wall_ms = start.elapsed_time(end) / T_TIMED
        peak = torch.cuda.max_memory_allocated() / 2**30
        net_ms = cuda_time_ms(lambda: model.net(images), reps=T_TIMED, warmup=1)
    df, ang = pred["df"].float().cpu().numpy(), pred["angle"].float().cpu().numpy()
    t = time.perf_counter()
    lines_from_fields_host(df, ang, T_LINES)
    vec_ms = (time.perf_counter() - t) * 1e3
    mask = (df[0] < 0.45).astype(np.uint8) * 255
    t = time.perf_counter()
    segs = hough_lines_p(mask, 1.0, math.pi / 180.0, 10, 15, 4)
    hough_ms = (time.perf_counter() - t) * 1e3
    prof = profile_forward(forward)
    lines, valid = pred["lines"], pred["line_mask"]
    inside = bool(((lines >= 0) & (lines <= torch.tensor([W, H], device=dev))).all())
    finite = all(bool(torch.isfinite(pred[k]).all()) for k in ("df", "angle", "lines", "line_scores"))
    in_range = (float(pred["df"].min()) >= 0 and float(pred["df"].max()) <= 1
                and float(pred["angle"].min()) >= 0 and float(pred["angle"].max()) <= math.pi)
    if not (finite and inside and in_range) or list(lines.shape) != [B, T_LINES, 2, 2]:
        fail(f"path T {label}: outputs not finite, out of range or outside the image "
             f"({finite}, {in_range}, {inside}, {list(lines.shape)})")
    res = {"wall_ms": wall_ms, "device_ms": prof["device_ms"],
           "busy_share": prof["device_ms"] / wall_ms if prof["device_ms"] else None,
           "net_ms": net_ms, "vectorizer_ms": vec_ms, "hough_ms_one_image": hough_ms,
           "hough_segments_one_image": int(len(segs)), "mask_density": float((df < 0.45).mean()),
           "lines": [int(v) for v in valid.sum(-1)], "peak_memory_gib": peak,
           "parameters": sum(p.numel() for p in model.parameters()), "top_kernels": prof["top"][:6]}
    print(f"path T {label}: " + json.dumps({k: v for k, v in res.items() if k != "top_kernels"}),
          flush=True)
    del model, pred
    torch.cuda.empty_cache()
    return res


def _t_planted(dev) -> dict:
    """GT fields of T_PLANTED random segments an image, on the card,
    vectorised on the host: the detections against the planted segments."""
    from gluefactory_tpu_torch.models.lines.deeplsd import fields_from_lines, lines_from_fields_host

    W, H = N_SIZE
    planted = _t_segments(np.random.default_rng(3), 2, T_PLANTED, H, W)
    lines = torch.from_numpy(planted).to(dev)
    df, ang = fields_from_lines(lines, None, H, W)
    fields_ms = cuda_time_ms(lambda: fields_from_lines(lines, None, H, W), reps=3, warmup=1)
    df, ang = df.cpu().numpy(), ang.cpu().numpy()
    t = time.perf_counter()
    out, _, valid = lines_from_fields_host(df, ang, T_LINES)
    vec_ms = (time.perf_counter() - t) * 1e3
    rec = [_t_recovered(planted[b], out[b], valid[b]) for b in range(2)]
    res = {"fields_ms": fields_ms, "vectorizer_ms": vec_ms, "mask_density": float((df < 0.45).mean()),
           "recovered": rec}
    if not all(r["detections"] >= 100 and r["on_a_planted_segment"] >= 0.7 * r["detections"] for r in rec):
        fail(f"path T: the planted fields' detections do not lie on the planted segments: {res}")
    print(f"path T planted: {json.dumps(res)}", flush=True)
    return res


def _t_training(dev) -> dict:
    """T_STEPS Adam steps of the native net on the GT fields' loss."""
    from gluefactory_tpu_torch.data.homographies import generate_synthetic_image
    from gluefactory_tpu_torch.optim import Adam

    B, H, W = T_TRAIN
    torch.manual_seed(0)
    model = get_model("lines.deeplsd").from_conf(T_BACKENDS["native"], device=dev).train()
    images = torch.from_numpy(np.stack([generate_synthetic_image(9000 + i, (W, H)) for i in range(B)]))
    data = {"image": images.to(dev),
            "lines": torch.from_numpy(_t_segments(np.random.default_rng(4), B, T_LINES, H, W)).to(dev),
            "line_mask": torch.ones(B, T_LINES, dtype=torch.bool, device=dev)}
    opt = Adam(model.parameters(), lr=1e-3)
    losses, moved, step_ms = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(T_STEPS):
        before = [p.detach().clone() for p in model.parameters()]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        opt.zero_grad()
        pred, loss, _ = model.forward_with_loss(data, train=True)
        loss["total"].mean().backward()
        opt.step()
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append({k: float(v.detach().mean()) for k, v in loss.items()})
        moved.append(all(not torch.equal(b, p) for b, p in zip(before, model.parameters())))
        if set(pred) != {"df", "angle"}:
            fail(f"path T: a train forward returned {sorted(pred)}")
    res = {"losses": losses, "every_update_applied": moved, "ms_a_step": step_ms,
           "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30}
    if not (all(math.isfinite(v) for l in losses for v in l.values()) and all(moved)):
        fail(f"path T: training losses not finite or an update not applied: {res}")
    print(f"path T training: {json.dumps(res)}", flush=True)
    del model, opt
    torch.cuda.empty_cache()
    return res


def _t_card_vs_cpu(dev) -> dict:
    """At narrow widths: the native and package-layout nets (the same
    weights) and the GT fields on the card against the host's CPU, within
    T_TOL; the lines the host vectorises from each are recorded (fields a
    rounding apart may flip a median test or the order of two equal
    scores, so they are not a gate)."""
    from gluefactory_tpu_torch.models.lines.deeplsd import fields_from_lines, lines_from_fields_host

    h, w = T_SMALL["hw"]
    rng = np.random.default_rng(5)
    img = torch.from_numpy(rng.uniform(0, 1, (2, h, w, 3)).astype(np.float32))
    res = {}
    for label, conf in (("native", {"channels": T_SMALL["channels"]}),
                        ("package-layout", {"backend": "package-layout",
                                            "package_spec": {"enc": [[8, 8], [16, 16], [16, 16]],
                                                             "dec": [[8, 8], [8, 8]], "head": [8]}})):
        torch.manual_seed(1)
        cpu = get_model("lines.deeplsd").from_conf(conf, device="cpu").eval()
        card = get_model("lines.deeplsd").from_conf(conf, device=dev).eval()
        card.load_state_dict(cpu.state_dict())
        with torch.no_grad():
            a, b = cpu.net(img), card.net(img.to(dev))
        res[label] = max(float((x - y.cpu()).abs().max()) for x, y in zip(a, b))
    planted = torch.from_numpy(_t_segments(rng, 2, 60, h, w))
    fc = fields_from_lines(planted, None, h, w)
    fd = fields_from_lines(planted.to(dev), None, h, w)
    res["fields"] = max(float((x - y.cpu()).abs().max()) for x, y in zip(fc, fd))
    lc = lines_from_fields_host(fc[0].numpy(), fc[1].numpy(), 40)
    ld = lines_from_fields_host(fd[0].cpu().numpy(), fd[1].cpu().numpy(), 40)
    same = (lc[0] == ld[0]).all(axis=(-1, -2)) & (lc[2] == ld[2])
    res["lines_equal"] = {"slots": int(same.sum()), "of": int(same.size),
                          "valid": [int(lc[2].sum()), int(ld[2].sum())]}
    res["tol"] = T_TOL
    if not (res["native"] <= T_TOL["net"] and res["package-layout"] <= T_TOL["net"]
            and res["fields"] <= T_TOL["fields"]):
        fail(f"path T: the card differs from the CPU: {res}")
    return res


def phase_deeplsd(device_info: dict) -> dict:
    """Path T: DeepLSD, both backends through `get_model("lines.deeplsd")`,
    the planted fields, the Adam steps and the card against the CPU, cut as
    T_REDUCED says."""
    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    print(f"path T reduced: {json.dumps(T_REDUCED)}", flush=True)
    images = torch.from_numpy(np.stack(_n_views())).to(dev)
    reset_all_launches()
    res = {"reduced": T_REDUCED, "image": [N_SIZE[1], N_SIZE[0]], "card": device_info["nvidia_smi"]}
    res["seconds_by_part"] = {"views": time.perf_counter() - t0}
    parts = [(label, lambda label=label: _t_forward(label, images, device_info)) for label in T_BACKENDS]
    parts += [("planted", lambda: _t_planted(dev)), ("training", lambda: _t_training(dev)),
              ("card_vs_cpu", lambda: _t_card_vs_cpu(dev))]
    for name, fn in parts:
        t = time.perf_counter()
        res[name] = fn()
        res["seconds_by_part"][name] = time.perf_counter() - t
    _check_launches("path T", all_launches(), {})
    res["seconds"] = time.perf_counter() - t0
    print(f"path T: card vs CPU {json.dumps(res['card_vs_cpu'])}; {res['seconds']:.1f} s", flush=True)
    return res


# path U: data-parallel training (train.py under torchrun), world size 1 over NCCL
U_EXPERIMENT = "chip_smoke_path_u"
U_STEPS = 2
U_ARGV = [a.replace(TRAIN_EXPERIMENT, U_EXPERIMENT) for a in TRAIN_ARGV
          if not a.startswith(("data.synthetic_images", "data.val_size"))]
U_ARGV[U_ARGV.index("--max_val_iters") + 1] = "0"
U_ROOT = ROOT / "outputs" / "chip_smoke_path_u"
U_ARGV += ["data.synthetic_images=0", f"data.image_dir={U_ROOT}", "data.image_list=list.txt",
           "data.val_size=0", "data.photometric.name=identity"]
U_TIMED, U_WARMUP = 3, 1  # timed steps with and without the group, after warm-ups
U_TIMEOUT = 240  # seconds for the child, its start-up included
U_REDUCED = {
    "U": f"path E's run ({TRAIN_YAML}, f32, batch {TRAIN_BATCH}, 6 workers, {U_STEPS} steps) at world "
         f"size 1 over NCCL, in a child process with the environment torchrun gives a rank: the card's "
         f"machine has one GPU and NCCL takes no two ranks on one GPU, so no run crosses cards; an empty "
         f"validation split, the {TRAIN_BATCH * U_STEPS} procedural sources rendered first, one a "
         f"loader worker, into a folder of PPMs that the run reads (`data.image_dir`), and the `lg` "
         f"photometry off: the run's loader builds a whole batch a worker (~20 s for 32 procedural "
         f"images with `lg` on the card's host), which would be most of the path; the steps are "
         f"timed on batches in memory. The child imports (and torch._dynamo) while path T runs, "
         f"and touches the card only after it",
}


def path_u_child(out: Path, go: Path) -> None:
    """Path U's child, a rank of world size 1 by its environment. It
    imports torch._dynamo (which the first optimizer imports, ~10 s on the
    card's host) and waits for `go` without touching the card (path T runs
    meanwhile); then `train.main` on U_ARGV joins the NCCL group of that
    environment;
    its steps are replayed from the same state on the same batches and
    generators by a TrainStep without the group, which must give the same
    losses and parameters bit for bit. Then ms a step with and without the
    group on those batches, one all-reduce of the flat gradient buffer, and
    the group's facts, into `out` (JSON)."""
    import torch.distributed as dist

    from gluefactory_tpu_torch import train
    from gluefactory_tpu_torch.settings import TRAINING_PATH
    from gluefactory_tpu_torch.utils import distributed

    importlib.import_module("torch._dynamo")
    t0 = time.perf_counter()
    while not go.exists():
        if time.perf_counter() - t0 > U_TIMEOUT:
            fail("path U: the parent never let the child train")
        time.sleep(0.05)
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # as phase_device sets them in the parent
    torch.backends.cudnn.allow_tf32 = False
    shutil.rmtree(Path(TRAINING_PATH, U_EXPERIMENT), ignore_errors=True)
    seen, call, marks = [], train.TrainStep.__call__, []

    def recorded(self, batch, generator=None, *args):
        marks.append(time.perf_counter() - t0)
        seen.append((batch, generator.get_state().clone(), self))
        return call(self, batch, generator, *args)

    train.TrainStep.__call__ = recorded
    first = []
    try:
        records, seconds, launches, model = run_trainer(U_ARGV, first_state=first)
    finally:
        train.TrainStep.__call__ = call
    group = distributed.setup(DEVICE)
    res = {"run_seconds": seconds, "launches": launches, "step_starts_s": marks,
           "group": {"backend": dist.get_backend(), "world": dist.get_world_size(), "rank": dist.get_rank(),
                     "device": str(group.device)},
           "losses": [{k: float(v) for k, v in r[0].items()} for r in records],
           "ok": [bool(r[2]["ok"]) for r in records]}
    trainer_step = seen[0][2]
    if trainer_step.group is not group or len(records) != U_STEPS:
        fail(f"path U: the trainer's step is not on the group, or {len(records)} steps")
    conf = train_conf(U_ARGV)

    def replay(with_group):
        m = get_model(conf.model.name).from_conf(
            {k: v for k, v in conf.model.to_dict().items() if k != "name"}, device=group.device)
        m.load_state_dict(first[0])
        opt, _ = train.build_optimizer(conf.train, m, U_STEPS)
        step = train.TrainStep(m, opt, trainer_step.schedule, max_updates=len(trainer_step.lr_table) - 1,
                               group=group if with_group else None)
        gen = torch.Generator(device=group.device)
        outs = [step(b, gen.set_state(g)) for b, g, _ in seen]
        return m, step, outs

    plain, _, outs = replay(False)
    res["replay_losses"] = [{k: float(v) for k, v in o[0].items()} for o in outs]
    res["bit_equal"] = {
        "losses": all(torch.equal(o[0][k], r[0][k]) for o, r in zip(outs, records) for k in r[0]),
        "parameters": all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                            plain.state_dict().values())),
    }
    batches = [b for b, _, _ in seen]
    gen = torch.Generator(device=group.device)
    for label, g in (("with_group", group), ("without_group", None)):
        step, ms, _ = _timed_micro_batches(model, batches, gen, 1, conf=conf, group=g,
                                           label=f"path U {label}", timed=U_TIMED, warmup=U_WARMUP)
        res[f"ms_per_step_{label}"] = ms
        del step
    grads = [torch.randn_like(p) for p in model.parameters() if p.requires_grad]
    res["all_reduce"] = {"bytes": 4 * (sum(g.numel() for g in grads) + 1),
                         "ms": cuda_time_ms(lambda: distributed.all_reduce_mean(grads, group), reps=10)}
    res["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    distributed.teardown()
    res["child_seconds"] = time.perf_counter() - t0
    out.write_text(json.dumps(res))


def write_sources(folder: Path, n: int) -> float:
    """The first `n` procedural sources as PPMs in `folder` with
    `list.txt`, one image a loader worker (6); returns the seconds."""
    t0 = time.perf_counter()
    shutil.rmtree(folder, ignore_errors=True)
    folder.mkdir(parents=True)
    for i, img in enumerate(procedural_images(n)):
        h, w = img.shape[:2]
        (folder / f"{i:03d}.ppm").write_bytes(f"P6\n{w} {h}\n255\n".encode() + img.tobytes())
    (folder / "list.txt").write_text("\n".join(f"{i:03d}.ppm" for i in range(n)) + "\n")
    return time.perf_counter() - t0


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def start_ddp_child() -> dict:
    """Start path U's child (`path_u_child`) with torchrun's environment for
    rank 0 of 1 (the rendezvous on a free port of 127.0.0.1), in a session of
    its own; it starts up on the host's CPU and waits for `phase_ddp`.
    `stop_ddp_child` ends it."""
    OUT_DIR.mkdir(exist_ok=True)
    child = {"out": OUT_DIR / "path_u.json", "go": OUT_DIR / "path_u.go", "t0": time.perf_counter()}
    for f in (child["out"], child["go"]):
        f.unlink(missing_ok=True)
    env = {**os.environ, "RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1", "LOCAL_WORLD_SIZE": "1",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    child["proc"] = subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--path-u-child", str(child["out"]), str(child["go"])],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    return child


def stop_ddp_child(child: dict | None) -> None:
    """Kill path U's child and its loader workers if it still runs."""
    if child is not None and child["proc"].poll() is None:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(child["proc"].pid, 9)
        child["proc"].wait()


def phase_ddp(device_info: dict, path_e: dict | None = None, child: dict | None = None) -> dict:
    """Path U: path E's config at world size 1 over NCCL in a child process
    (`path_u_child`, started by `start_ddp_child` before path T), cut as
    U_REDUCED says."""
    t0 = time.perf_counter()
    print(f"path U reduced: {json.dumps(U_REDUCED)}", flush=True)
    child = child or start_ddp_child()
    try:
        sources_s = write_sources(U_ROOT, TRAIN_BATCH * U_STEPS)
        child["go"].touch()
        log, _ = child["proc"].communicate(timeout=U_TIMEOUT)
    finally:
        stop_ddp_child(child)
        shutil.rmtree(U_ROOT, ignore_errors=True)
    (OUT_DIR / "path_u_child.log").write_text(log or "")
    if child["proc"].returncode != 0 or not child["out"].exists():
        fail(f"path U: the child exited {child['proc'].returncode}:\n{(log or '')[-4000:]}")
    res = json.loads(child["out"].read_text())
    res["sources_seconds"] = sources_s
    res["child_started_s_before"] = t0 - child["t0"]
    _check_launches("path U", res["launches"], {k: U_STEPS * n for k, n in STEP_LAUNCHES.items()})
    if res["group"]["backend"] != "nccl" or res["group"]["world"] != 1:
        fail(f"path U: the group is {res['group']}, expected NCCL of 1 rank")
    if not (all(res["ok"]) and all(math.isfinite(v) for l in res["losses"] for v in l.values())):
        fail(f"path U: a loss is not finite or an update was not applied: {res['losses']}")
    if not all(res["bit_equal"].values()):
        fail(f"path U: the steps under the group differ from the same steps without it: "
             f"{res['bit_equal']}, {res['losses']} against {res['replay_losses']}")
    if path_e is not None:
        res["path_e_ms_per_step"] = path_e["timing"]["ms_per_step"]
    res["reduced"], res["card"] = U_REDUCED, device_info["nvidia_smi"]
    res["seconds"] = time.perf_counter() - t0
    print(f"path U: {json.dumps(res)}", flush=True)
    return res


# --------------------------------------------------------------------------
# 26. path V: the int8 serving options and the native estimators
# --------------------------------------------------------------------------

# V1: bench's configuration with SuperPoint's `quantize: int8` and
# LightGlue's `int8_similarity`, against the main path's bf16 forward
V_CONF = {"extractor": {**MAIN_CONF["extractor"], "quantize": "int8"},
          "matcher": {**MAIN_CONF["matcher"], "int8_similarity": True}}
# a forward: 8 backbone convs and 4 heads, each a conv and a requant launch;
# the similarity at the last layer only
INT8_LAUNCHES = {**MAIN_LAUNCHES, "int8_conv": 12, "int8_requant": 12, "int8_bmm": 1}
# tests/test_int8.py's bounds of the int8 path against the float one
INT8_BOUNDS = {"score_corr": 0.99, "desc_cos_min": 0.98, "desc_cos_mean": 0.995,
               "keypoint_overlap": 0.5, "matches_agree": 0.95}
INT8_PEAK_OPS = 1979e12  # H100 SXM dense int8 tensor-core operations a second
V_TIMED = 10  # timed forwards of each of the bf16 and int8 pipelines, in turns
V_ESTIMATORS = (("hpatches", "poselib"), ("megadepth1500", "poselib"), ("megadepth1500", "two_view_native"))
V_REDUCED = {
    "V1": "none: bench's configuration (4 pairs of 1024^2, SuperPoint 2048 keypoints, LightGlue-9, "
          "bf16) with quantize int8 and int8_similarity, random weights from seed 0 (the main path's)",
    "V2": "SuperPoint alone on the main path's 8 images, s2d_block1 against the plain blocks",
    "V3": "the eval loops alone on paths F and G's caches (40 HPatches pairs, 6 MegaDepth-1500 pairs), "
          "not the 540 and 1500 pairs of the benchmarks",
}


def _v_extractors(model, dev, **confs) -> dict:
    """SuperPoints with the pipeline extractor's weights and dense outputs,
    one a conf overlay of `confs` (dtype key "dtype")."""
    base = {k: v for k, v in MAIN_CONF["extractor"].items() if k != "name"}
    out = {}
    for label, overlay in confs.items():
        overlay = dict(overlay)
        dtype = overlay.pop("dtype", torch.bfloat16)
        sp = get_model("superpoint").from_conf({**base, "dense_outputs": True, **overlay}, device=dev)
        sp.load_state_dict(model.extractor.state_dict(), strict=True)
        out[label] = sp.to(dtype).eval()
    return out


def _v_images(batch) -> torch.Tensor:
    """The pipeline's extractor input: both views stacked (8 images)."""
    return torch.cat([batch["view0"]["image"], batch["view1"]["image"]])


def _v_layers(sp, images) -> dict:
    """Each int8 layer of the dense pass at bench's shapes, kernel against
    plain version, the kernel's output feeding the next layer: the int32
    accumulators (the kernel's core alone) and the codes with their scale
    (or the bf16 heads) must be equal. The plain version computes in
    float64 on the card. Times by CUDA events, one call each."""
    from gluefactory_tpu_torch.ops import int8_conv as I

    def timed(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    n_blocks = len(sp.conf.channels)
    backbone = [(f"conv{i+1}{t}", t == "b" and i < n_blocks - 1) for i in range(n_blocks) for t in "ab"]
    x8, s = I.quantize_activation(images)
    layers, heads_in = [], None
    for name, pool, relu, requant, src in (
            [(n, p, True, True, None) for n, p in backbone]
            + [("convPa", False, True, True, "trunk"), ("convPb", False, False, False, None),
               ("convDa", False, True, True, "trunk"), ("convDb", False, False, False, None)]):
        if src == "trunk":
            x8, s = heads_in
        w, b = sp._packed(name)
        acc_k = I.conv_accumulators(x8, w)
        acc_p = I.plain_conv_acc(x8, w.w8)
        acc_equal = bool(torch.equal(acc_k, acc_p))
        del acc_k, acc_p
        out_k, ms = timed(lambda: I.int8_conv(x8, s, w, b, relu, requant, pool))
        out_p, plain_ms = timed(lambda: I.plain_int8_conv(x8, s, w, b, relu, requant, pool))
        rec = {"layer": name, "in": list(x8.shape), "cout": w.cout, "pool": pool, "acc_equal": acc_equal,
               "ms": ms, "plain_ms": plain_ms}
        if requant:
            diff = (out_k[0].int() - out_p[0].int()).abs()
            rec.update(codes_differ=int(diff.gt(0).sum()), max_code_diff=int(diff.max()),
                       scale_equal=bool(torch.equal(out_k[1], out_p[1])), out=list(out_k[0].shape))
            x8, s = out_k
        else:
            rec.update(bf16_differ=int((out_k != out_p).sum()),
                       max_abs_err=float((out_k.float() - out_p.float()).abs().max()), out=list(out_k.shape))
        if name == f"conv{n_blocks}b":
            heads_in = (x8, s)
        layers.append(rec)
        del out_k, out_p
    torch.cuda.empty_cache()
    bad = [r for r in layers if not r["acc_equal"] or r.get("codes_differ", 0) or r.get("bf16_differ", 0)
           or not r.get("scale_equal", True)]
    if bad:
        fail(f"path V1: int8 layers differ from their plain versions: {json.dumps(bad)}")
    return {"layers": layers, "max_abs_err": max(r.get("max_code_diff", r.get("max_abs_err", 0.0)) for r in layers),
            "ms": sum(r["ms"] for r in layers), "plain_ms": sum(r["plain_ms"] for r in layers)}


def _v_similarity(model, batch, gen) -> dict:
    """The int8 similarity's inputs as one forward gives them, the kernel
    against the plain version: equal (the integer sums are exact in both,
    the dequantization rounds in the same order)."""
    from gluefactory_tpu_torch.models.matchers import lightglue as lg_mod
    from gluefactory_tpu_torch.ops import int8_conv as I

    seen = []
    real = lg_mod.int8_bmm
    lg_mod.int8_bmm = lambda *a: seen.append(a) or real(*a)
    try:
        with torch.no_grad():
            model(batch, generator=gen.manual_seed(0))
    finally:
        lg_mod.int8_bmm = real
    if len(seen) != 1:
        fail(f"path V1: {len(seen)} int8 similarities in a forward, expected 1")
    q0, q1, s0, s1, c = seen[0]
    got, want = I.int8_bmm(q0, q1, s0, s1, c), I.plain_int8_bmm(q0, q1, s0, s1, c)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"path V1: int8_bmm differs from its plain version by {float((got - want).abs().max())}")
    return {"args": (q0, q1, s0, s1, c), "shape": [*q0.shape[:2], q1.shape[1], q0.shape[2]],
            "max_abs_err": 0.0}


def _v_agreement(model, main_model, batch, gen) -> dict:
    """int8 against bf16 at tests/test_int8.py's bounds: the dense score
    maps' correlation, the dense descriptors' cosine (min, mean), each
    image's keypoint overlap (SuperPoint with and without `quantize`); the
    matches of LightGlue with and without `int8_similarity` on the bf16
    extractor's features."""
    dev = torch.device(DEVICE)
    sps = _v_extractors(model, dev, bf16={}, int8={"quantize": "int8"})
    images = _v_images(batch)
    with torch.no_grad():
        a, b = (sps[k]({"image": images}, generator=gen.manual_seed(0)) for k in ("bf16", "int8"))
        sa = a["dense_score_map"].double().flatten()
        sb = b["dense_score_map"].double().flatten()
        corr = float(torch.corrcoef(torch.stack([sa, sb]))[0, 1])
        cos = (a["dense_descriptors"].double() * b["dense_descriptors"].double()).sum(-1)
        overlap = []
        for i in range(images.shape[0]):
            ka, kb = (p["keypoints"][i].round().long() for p in (a, b))
            ia, ib = ka[:, 1] * 8 * IMAGE + ka[:, 0], kb[:, 1] * 8 * IMAGE + kb[:, 0]
            overlap.append(float(torch.isin(ia, ib).float().mean()))
        feats = main_model(batch, generator=gen.manual_seed(0))
        data = {**batch, **{k: v for k, v in feats.items() if not k.startswith(("matches", "matching",
                                                                                 "log_assignment"))}}
        m_int8 = model.matcher(data)
        agree = float((m_int8["matches0"] == feats["matches0"]).float().mean())
    res = {"score_corr": corr, "desc_cos_min": float(cos.min()), "desc_cos_mean": float(cos.mean()),
           "keypoint_overlap": min(overlap), "keypoint_overlap_by_image": overlap, "matches_agree": agree,
           "bounds": INT8_BOUNDS}
    ok = (corr > INT8_BOUNDS["score_corr"] and res["desc_cos_min"] > INT8_BOUNDS["desc_cos_min"]
          and res["desc_cos_mean"] > INT8_BOUNDS["desc_cos_mean"]
          and res["keypoint_overlap"] > INT8_BOUNDS["keypoint_overlap"] and agree > INT8_BOUNDS["matches_agree"])
    if not ok:
        fail(f"path V1: int8 against bf16 outside tests/test_int8.py's bounds: {json.dumps(res)}")
    del sps
    torch.cuda.empty_cache()
    return res


def _v_s2d(model, batch, device_info) -> dict:
    """V2: SuperPoint with `s2d_block1` against the plain SuperPoint in bf16,
    held to twice the gap that bf16 rounding alone opens (plain bf16 against
    plain f32) on the dense score map and descriptors, and at least to two
    bf16 steps at the output's largest value (two bf16 results of sums
    taken in another order may round one step apart each); both timed."""
    sps = _v_extractors(model, torch.device(DEVICE), plain={}, s2d={"s2d_block1": True},
                        f32={"dtype": torch.float32})
    images = _v_images(batch)
    gen = torch.Generator(device=DEVICE)
    with torch.no_grad():
        out = {k: sps[k]({"image": images.float() if k == "f32" else images}, generator=gen.manual_seed(0))
               for k in sps}

    def gap(a, b, key):
        return float((out[a][key].float() - out[b][key].float()).abs().max())

    res = {}
    for key in ("dense_score_map", "dense_descriptors"):
        rounding = gap("plain", "f32", key)
        step = 2.0 ** (math.floor(math.log2(float(out["f32"][key].abs().max()))) - 7)
        res[key] = {"s2d_vs_plain": gap("s2d", "plain", key), "plain_bf16_vs_f32": rounding,
                    "bf16_step_at_max": step, "tol": max(2 * rounding, 2 * step)}
        if not res[key]["s2d_vs_plain"] <= res[key]["tol"]:
            fail(f"path V2: s2d_block1 against the plain SuperPoint on {key}: {json.dumps(res[key])}")
    del out
    with torch.no_grad():
        ms = {k: [] for k in ("plain", "s2d")}
        for k in ("plain", "s2d", "s2d", "plain"):
            ms[k].append(cuda_time_ms(lambda: sps[k]({"image": images}, generator=gen.manual_seed(0)), reps=5))
    res["ms"] = {k: min(v) for k, v in ms.items()}
    res["ms_runs"] = ms
    res["card"] = device_info["nvidia_smi"]
    del sps
    torch.cuda.empty_cache()
    return res


def _v_bmm_record(sim: dict) -> dict:
    from gluefactory_tpu_torch.ops import int8_conv as I

    q0, q1, s0, s1, c = sim["args"]
    B, M, N, D = sim["shape"]
    n_bytes = B * M * D + B * N * D + 4 * (B * M + B * N) + 4 * B * M * N
    t_ops, t_bytes = 2.0 * B * M * N * D / INT8_PEAK_OPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    try:  # one cuBLASLt int8 product per item: the int32 sums, without the dequantization
        library_ms = device_time_ms(lambda: [torch._int_mm(q0[b], q1[b].t()) for b in range(B)])
        library_note = "torch._int_mm per item (int32 sums only)"
    except RuntimeError as e:
        library_ms, library_note = None, f"torch._int_mm refused these shapes: {str(e)[:200]}"
    return {"name": "int8_bmm", "route": "cuda", "source": "gluefactory_tpu_torch/csrc/int8_conv.cu",
            "replaces": "none: the XLA int8 einsum of gluefactory_tpu/models/matchers/lightglue.py:202",
            "launches": 0, "max_abs_err": sim["max_abs_err"], "tol": 0.0,
            "ms": device_time_ms(lambda: I.int8_bmm(q0, q1, s0, s1, c)),
            "plain_ms": cuda_time_ms(lambda: I.plain_int8_bmm(q0, q1, s0, s1, c), reps=5),
            "library_ms": library_ms, "library_note": library_note,
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "timed_shape": sim["shape"]}


def _v_conv_record(sp, images, layers: dict) -> dict:
    """The int8 dense pass as one record: `ms` the 12 convs with their
    requant passes and the input's quantization (CUDA events over 5
    passes), `plain_ms` the plain versions' layers summed (one call each),
    the bound from `dense_pass_work` (int8 operations at the int8 peak,
    int8 in and out once a layer)."""
    from gluefactory_tpu_torch.ops.int8_conv import dense_pass_work

    c = sp.conf
    work = dense_pass_work(images.shape[0], images.shape[1], images.shape[2], c.channels, c.head_channels,
                           c.descriptor_dim)
    ops, n_bytes = sum(w["ops"] for w in work.values()), sum(w["bytes"] for w in work.values())
    t_ops, t_bytes = ops / INT8_PEAK_OPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    with torch.no_grad():
        ms = cuda_time_ms(lambda: sp._int8_dense(images), reps=5)
    return {"name": "int8_conv", "route": "cuda", "source": "gluefactory_tpu_torch/csrc/int8_conv.cu",
            "replaces": "none: the XLA int8 conv of gluefactory_tpu/ops/int8_conv.py:52",
            "launches": 0, "max_abs_err": layers["max_abs_err"], "tol": 0.0, "ms": ms,
            "plain_ms": layers["plain_ms"], "library_ms": None,
            "library_note": "none: PyTorch has no CUDA int8 conv",
            "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_detail": {"ops": ops, "bytes": n_bytes, "ops_ms": t_ops, "bytes_ms": t_bytes},
            "timed_shape": [images.shape[0], images.shape[1], images.shape[2]],
            "layers_ms": {r["layer"]: r["ms"] for r in layers["layers"]}}


def _v_eval(device_info: dict) -> dict:
    """V3: the eval loops alone (`--overwrite_eval`) on the caches paths F
    and G exported, with `poselib` (HPatches, MegaDepth-1500) and
    `two_view_native` (MegaDepth-1500, its RANSACs on the card): seconds, ms
    a pair, finite AUCs, the RANSAC calls' devices."""
    import gluefactory_tpu_torch.settings as tsettings
    from gluefactory_tpu_torch.eval import hpatches, megadepth1500
    from gluefactory_tpu_torch.robust_estimators.relative_pose import two_view_native

    card_device = str(torch.empty(0, device=DEVICE).device)
    out = {}
    for bench, estimator in V_ESTIMATORS:
        tag = f"chip_smoke_{estimator}"
        src = Path(tsettings.EVAL_PATH, bench, "chip_smoke", "predictions.h5")
        dst = Path(tsettings.EVAL_PATH, bench, tag, "predictions.h5")
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(src, dst)
        if bench == "hpatches":
            root, argv, pairs, main_fn, cls = HPATCHES_ROOT, HPATCHES_ARGV, HPATCHES_PAIRS, hpatches.main, \
                hpatches.HPatchesPipeline
            aucs = [f"H_error_ransac@{t}px" for t in (1, 3, 5)]
        else:
            root, argv, pairs, main_fn, cls = MD_ROOT, MD_ARGV, MD_PAIRS, megadepth1500.main, \
                megadepth1500.MegaDepth1500Pipeline
            aucs = [f"rel_pose_error@{t}°" for t in (5, 10, 20)]
        module = two_view_native if estimator == "two_view_native" else None
        data_path, tsettings.DATA_PATH = tsettings.DATA_PATH, root
        try:
            run = run_eval_cli(main_fn, cls, module, ("ransac_essential", "ransac_homography"),
                               [*argv, f"eval.estimator={estimator}", "--tag", tag, "--overwrite_eval"])
        finally:
            tsettings.DATA_PATH = data_path
        s = run["summaries"]
        vals = {k: s.get(k) for k in aucs}
        if not all(isinstance(v, float) and math.isfinite(v) for v in vals.values()):
            fail(f"path V3 {bench} {estimator}: AUCs not finite: {vals}")
        _check_launches(f"path V3 {bench} {estimator}", run["launches"], {})
        calls = run["ransac_calls"]  # none for a pair of fewer than 8 matches
        if any(c["devices"] != [card_device] for c in calls):
            fail(f"path V3 {estimator}: the RANSACs ran on {[c['devices'] for c in calls]}, expected the card")
        eval_s = run["seconds"]["run_eval"]
        out[f"{bench}/{estimator}"] = {
            "pairs": pairs, "eval_seconds": eval_s, "ms_per_pair": 1e3 * eval_s / pairs, "aucs": vals,
            "summaries": s, "ransac_calls": len(calls),
            "ransac_calls_by_name": {n: sum(c["ransac"] == n for c in calls)
                                     for n in ("ransac_essential", "ransac_homography")},
            "ransac_ms_per_call": float(np.mean([c["ms"] for c in calls])) if calls else None,
            "ransac_devices": sorted({d for c in calls for d in c["devices"]})}
        print(f"path V3 {bench} {estimator}: eval loop {eval_s:.2f} s ({1e3 * eval_s / pairs:.1f} ms a pair), "
              f"AUCs {json.dumps(vals)}, RANSAC calls {len(calls)} on "
              f"{out[f'{bench}/{estimator}']['ransac_devices']} ({device_info['nvidia_smi']})", flush=True)
    return out


def _v_two_view_on_card() -> dict:
    """`two_view_native` at its defaults on planted pixel matches of a known
    pose (a general scene, 512 matches, 30% outliers, 1600 x 1200 pinhole
    cameras): the essential model chosen, R and t within MD_SYNTH's degree
    of the truth, its two RANSACs' tensors on the card. The eval loop's
    random-weight matches may give it no pair of 8 matches."""
    from gluefactory_tpu_torch.eval.utils import angle_error_mat_np, angle_error_vec_np
    from gluefactory_tpu_torch.geometry.wrappers import Camera
    from gluefactory_tpu_torch.robust_estimators import load_estimator
    from gluefactory_tpu_torch.robust_estimators.relative_pose import two_view_native
    from gluefactory_tpu_torch.scripts_dev.posed_scenes import synthetic_correspondences

    p0, p1, R, t, _, _ = synthetic_correspondences(np.random.default_rng(12), 512, 3e-4, 0.3)
    cam = Camera.from_colmap({"model": "PINHOLE", "width": 1600, "height": 1200,
                              "params": [1200.0, 1200.0, 800.0, 600.0]})
    k0, k1 = (cam.denormalize(torch.from_numpy(p)[None])[0].numpy() for p in (p0, p1))
    calls, planar = [], []
    names = ("ransac_essential", "ransac_homography", "decompose_homography")
    real = {n: getattr(two_view_native, n) for n in names}

    def recorded(name):
        def call(*args, **kw):
            out = real[name](*args, **kw)
            if name == "decompose_homography":
                planar.append(True)
            else:
                calls.append(sorted({str(v.device) for v in out.values() if torch.is_tensor(v)}))
            return out
        return call

    for n in names:
        setattr(two_view_native, n, recorded(n))
    try:
        est = load_estimator("relative_pose", "two_view_native")({"ransac_th": 1.0, "device": DEVICE})
        out = est({"m_kpts0": k0, "m_kpts1": k1, "camera0": cam, "camera1": cam})
    finally:
        for n, fn in real.items():
            setattr(two_view_native, n, fn)
    card = [str(torch.empty(0, device=DEVICE).device)]
    res = {"matches": len(k0), "success": bool(out["success"]), "planar": bool(planar),
           "ransac_devices": calls, "inliers": int(out["inliers"].sum()),
           "R_err_deg": float(angle_error_mat_np(out["M_0to1"].R.double().numpy(), R)),
           "t_err_deg": float(angle_error_vec_np(out["M_0to1"].t.double().numpy(), t))}
    if not (res["success"] and not planar and calls == [card, card]
            and max(res["R_err_deg"], res["t_err_deg"]) <= MD_SYNTH["truth_deg"]):
        fail(f"path V3: two_view_native on planted matches: {res}")
    return res


def phase_int8(device_info: dict, batch: dict) -> dict:
    """Path V: V1 bench's configuration with `quantize: int8` and
    `int8_similarity` driven through the pipeline (exact launches, outputs
    checked), timed in turns with the bf16 main path and profiled; each
    int8 layer and the similarity against their plain versions; int8
    against bf16 at tests/test_int8.py's bounds. V2 `s2d_block1`. V3 the
    native estimators' eval loops. Returns the path's record with the
    `int8_conv` and `int8_bmm` kernel records."""
    card = device_info["nvidia_smi"]
    print(f"path V reduced: {json.dumps(V_REDUCED)}", flush=True)
    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    model, main_model = build_pipeline(dev, V_CONF), build_pipeline(dev, MAIN_CONF)
    for k, v in main_model.state_dict().items():
        if not torch.equal(v, model.state_dict()[k]):
            fail(f"path V1: the int8 pipeline's {k} differs from the main path's")
    gen = torch.Generator(device=dev)
    forward = pipeline_forward(model, batch, gen)
    res, _ = drive_path("path V1 (int8)", forward, INT8_LAUNCHES, device_info)
    main_forward = pipeline_forward(main_model, batch, torch.Generator(device=dev))
    with torch.no_grad():
        turns = {"bf16": [], "int8": []}
        for k in ("bf16", "int8", "int8", "bf16"):
            turns[k].append(cuda_time_ms(main_forward if k == "bf16" else forward, reps=V_TIMED))
    ms = {k: min(v) for k, v in turns.items()}
    res["vs_main"] = {"ms_per_forward": ms, "runs_ms": turns,
                      "pairs_per_s": {k: PAIRS * 1e3 / v for k, v in ms.items()},
                      "int8_over_bf16": ms["bf16"] / ms["int8"], "card": card}
    print(f"path V1: int8 {PAIRS * 1e3 / ms['int8']:.2f} pairs/s against bf16 {PAIRS * 1e3 / ms['bf16']:.2f} "
          f"in turns ({card})", flush=True)
    res["profile"] = profile_forward(forward)
    dms = res["profile"]["device_ms"]
    res["busy_share"] = None if dms is None else dms / ms["int8"]
    print(f"path V1 top device items: {json.dumps(res['profile']['top'][:8])}", flush=True)
    images = _v_images(batch)
    layers = _v_layers(model.extractor, images)
    res["layers"] = layers["layers"]
    print(f"path V1 layers, kernel against plain: accumulators, codes and bf16 heads equal; "
          f"{json.dumps([{k: r[k] for k in ('layer', 'ms', 'plain_ms')} for r in layers['layers']])}",
          flush=True)
    sim = _v_similarity(model, batch, gen)
    res["agreement"] = _v_agreement(model, main_model, batch, gen)
    print(f"path V1 int8 against bf16: {json.dumps(res['agreement'])}", flush=True)
    kernels = [_v_conv_record(model.extractor, images, layers), _v_bmm_record(sim)]
    for k in kernels:
        k["launches"] = res["launches"][k["name"]]
        print(f"kernel {k['name']}: {k['ms']:.3f} ms (plain {k['plain_ms']:.3f}, library {k['library_ms']}, "
              f"bound {k['bound_ms']:.4f} {k['bound_by']}), {k['launches']} launches on path V1 ({card})",
              flush=True)
    del sim
    res["s2d"] = _v_s2d(model, batch, device_info)
    print(f"path V2 s2d_block1: {json.dumps(res['s2d'])}", flush=True)
    del model, main_model
    torch.cuda.empty_cache()
    res["eval"] = _v_eval(device_info)
    res["two_view_planted"] = _v_two_view_on_card()
    print(f"path V3 two_view_native on planted matches: {json.dumps(res['two_view_planted'])}", flush=True)
    res["kernels"] = kernels
    res["reduced"] = V_REDUCED
    res["seconds"] = time.perf_counter() - t0
    res["card"] = card
    return res


def main() -> None:
    t0 = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t, 1)
        torch.cuda.empty_cache()
        return out

    device_info = phase_device()
    build = timed("build", phase_build)
    dev = torch.device(DEVICE)
    kernels = timed("kernels", lambda: phase_kernels(dev) + phase_new_kernels(dev))
    gradients = timed("gradients", phase_gradients, dev)
    batch = make_batch(dev)
    main_path, main_model = timed("main_path", phase_main_path, device_info, batch)
    path_b = timed("path_b", phase_superglue, device_info, batch)
    path_c = timed("path_c", phase_fused_superpoint, device_info, batch, main_model)
    path_d = timed("path_d", phase_serving, device_info, batch)
    # each kernel's launches from the path that runs it
    from_path = {"fused_attention": main_path, "fused_bidirectional_attention": main_path,
                 "log_sinkhorn": path_b, "fused_nms_tile_reduce": path_c, "fused_vgg_block": path_c}
    for k in kernels:
        k["launches"] = from_path[k["name"]]["launches"][k["name"]]
    del main_model
    path_e = timed("path_e", phase_training, device_info)
    path_e["folder_run"] = timed("path_e_folder", phase_folder_run)
    path_f = timed("path_f", phase_hpatches, device_info)
    path_g = timed("path_g", phase_megadepth, device_info)
    path_h = timed("path_h", phase_stage2, device_info)
    path_i = timed("path_i", phase_cached, device_info, path_h)
    path_j = timed("path_j", phase_benchmarks, device_info)
    path_k = timed("path_k", phase_superglue_training, device_info)
    path_l = timed("path_l", phase_lines, device_info)
    path_m = timed("path_m", phase_gluestick_training, device_info)
    path_n = timed("path_n", phase_zoo, device_info)
    path_o = timed("path_o", phase_sift, device_info)
    path_p = timed("path_p", phase_loftr, device_info)
    path_q = timed("path_q", phase_roma, device_info)
    path_r = timed("path_r", phase_device_augment, device_info, path_e)
    path_s = timed("path_s", phase_keynet, device_info)
    u_child = start_ddp_child()  # imports on the host's CPU while path T runs
    try:
        path_t = timed("path_t", phase_deeplsd, device_info)
        path_u = timed("path_u", phase_ddp, device_info, path_e, u_child)
    finally:
        stop_ddp_child(u_child)
    path_v = timed("path_v", phase_int8, device_info, batch)
    kernels += path_v["kernels"]  # launches from path V1's run
    kernels += timed("conv_study", phase_conv_study, device_info)  # launches from the tools' runs
    OUT_DIR.mkdir(exist_ok=True)
    record = {"device": device_info, "build": build, "kernels": kernels, "gradients": gradients,
              "main_path": main_path,
              "path_b_superglue": path_b, "path_c_fused_superpoint": path_c,
              "path_d_serving": path_d, "path_e_training": path_e, "path_f_hpatches": path_f,
              "path_g_megadepth1500": path_g, "path_h_stage2": path_h, "path_i_cached": path_i,
              "path_j_benchmarks": path_j, "path_k_superglue_training": path_k,
              "path_l_lines": path_l, "path_m_gluestick_training": path_m, "path_n_zoo": path_n,
              "path_o_sift": path_o, "path_p_loftr": path_p, "path_q_roma": path_q,
              "path_r_device_augment": path_r, "path_s_keynet": path_s, "path_t_deeplsd": path_t,
              "path_u_ddp": path_u, "path_v_int8": {k: v for k, v in path_v.items() if k != "kernels"},
              "seconds_by_phase": seconds,
              "seconds": time.perf_counter() - t0}
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print("chip_smoke seconds by phase: " + json.dumps(seconds), flush=True)
    print(f"chip_smoke: {record['seconds']:.1f} s in all", flush=True)
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    print(device_info["nvidia_smi"])
    if not all(math.isfinite(k["ms"]) for k in kernels):
        fail("kernel timing is not finite")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_info["kind"],
                                             "count": device_info["count"]}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--path-u-child"]:
        path_u_child(Path(sys.argv[2]), Path(sys.argv[3]))
    else:
        main()
