#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on a CUDA card.

    python3 chip_smoke.py

Phases, one line each (the kernel checks one line per kernel):
  1. environment: torch, CUDA and nvcc versions, the card's name and power
     limit as nvidia-smi gives them;
  2. build of the CUDA kernels (conductor_tpu_torch/csrc), and its time;
  3. each serving kernel (K1-K4) against its plain PyTorch version on the
     card, at the serving path's shapes (B = 2 clips of 60 s: T = 5400 mel
     frames, 1800 motion frames, D = 128, E = 512, 8 layers; K1 also in its
     bf16-VPU mode, within 0.2 %, moving with the mode at least half as far
     as the plain version and on average within a quarter of the mode's
     move of it, and K2 with int8 output and K1 in its int8-AdaLN mode on
     the int8 operands of the first ladder step, K2's codes compared
     dequantized, at most 0.1 % of them differing from the plain version's
     and none by more than 1, and all right on exact ties; K1's AdaLN GEMM
     alone in bf16 and int8 as K1 launches it, all 8 layers at once,
     beside torch.addmm with float32 out or torch._int_mm, and in device
     time beside torch.matmul in bf16 or torch._int_mm on the same
     product; K1's three modes and its GEMM again at B = 8, the
     headline's batch, and K1's device time split by launch at B = 2 and
     8, the `[k1-split]` lines; K2 (both modes) and K3 again at B = 8,
     the `[k2]` / `[k3]` lines giving each at both batches by CUDA events
     and device ms by launch (one launch a call, a repeat bit-identical
     and the tiling `ops.sampler_glue.plan` computes the kernel's
     `sampler_plan`, all three in `ok`) beside its bound and, at B = 8,
     its device-ms bar (`bar_met`); K4 on each of the encoder's 7 blocks at
     B = 2 and again at B = 8, each call's time printed and a repeat
     bit-identical), and the
     training layer kernels K5 (forward) and K6 (backward, seven
     gradients) on layer 0 of
     a training forward at B = 4 windows of 30 s (T = 900,
     padded to 960, the ``_b4`` rows) and at the stage-2 step's B = 32 (K6 a repeat
     bit-identical, its device time split by launch, its workspace bytes,
     and beside its d_adaln_w and d_emb GEMMs one PyTorch call each on the
     same product, the `[k6]` lines), and K7, the frozen ST-GCN of the perceptual loss
     (forward on pred and target, d(pred) backward from the plain forward's
     ReLU masks against the plain backward on the same masks), on pred and
     target of one training forward at B = 32, T = 900, bf16 operands on
     both sides, a repeat bit-identical, 10 launches a call, the tiling
     `ops.stgcn.plan` reports the kernel's, and the forward's ReLU masks
     those of the plain forward but for at most 0.1 % of their bits; the
     `[k7]` lines give each direction's time by CUDA events (the forward's
     two calls apart), device ms by launch, bound (the backward's old bound
     beside it), the bytes of the masks the forward keeps and `bar_met`;
     and the stage-1 music encoder's kernels, K9 (each 3x3 conv's
     d(kernel)), K10 and K11 (each pool's forward and first-max backward)
     and K4 in its training modes (each call beside cuDNN's bf16
     `F.conv2d` on the same operands, a repeat bit-identical), on the
     inputs and cotangents of their
     calls in one train-mode forward and backward of a stage-1 step at
     B = 10 with 10-s crops (900 mel, 300 motion frames), bf16 on both
     sides; and K8, the standalone linear attention, at the shapes of its
     two paths, the reference-mask training step (B = 32, T = 900, bf16 q,
     the key mask of m_lens = 60 folded into float32 k and v) and the
     plain-layer serving path (B = 2, T = 1800, a ones mask); each output
     must agree within 2 % of the plain output's largest value, and K11
     must follow the first-max tie rule exactly (error 0 on tied inputs
     with a cotangent whose sums are exact), repeat bit for bit and launch
     one kernel a call; the `[k11]` lines give each pool's time by CUDA
     events and on the device beside its bound and autograd's max_pool2d
     backward (another tie rule), and the three pools' sums against K11's
     bars (`bar_met`); K10 must equal its plain version bit for bit,
     repeat bit for bit, launch one kernel a call and run the tiling
     `ops.max_pool.fwd_plan` computes (the kernel's `max_pool_fwd_plan`),
     the `[k10]` lines giving each pool's events and device ms beside its
     bound and `F.max_pool2d`, and the sums against K10's bars; K8 must
     repeat bit for bit and launch one kernel a call, the `[k8]` lines
     giving its events and device ms at both shapes against its bars; and
     the float32 modes of phase 15: K4 on the serving encoder's 7 blocks at
     B = 2 in float32 (`conv_block_f32`, beside cuDNN's float32 convs of
     the blocks alone), K4's training modes, K9, K10 and K11 on the inputs
     and cotangents of one float32 stage-1 forward and backward at B = 10
     (the `_f32` lines, each beside cuDNN's float32 `F.conv2d` / weight
     gradient or `F.max_pool2d`, TF32 off): K4 and K9 within 1e-4 of the
     plain version's largest value, K10 bit-equal, K11 within 1e-6 and
     exact on tied inputs, each repeating bit for bit, the products priced
     at the card's float32 rate (67 TFLOP/s); and the fused ladder's
     float32 mode (phase 15 (e)) on the first step of phase 4's mel and
     x_T: K2 with float32 emb_act (`sampler_prologue_f32`) and with int8
     output beside float32 products (`sampler_prologue_f32_int8`, h within
     1e-4, the codes as phase 3's int8 K2), K1 alone, with
     int8 AdaLN and with bf16 VPU (`decoder_stack_f32`, `_f32_int8`,
     `_f32_vpu_bf16`), its float32 AdaLN GEMM alone (`adaln_modulation_f32`,
     beside torch.addmm in float32 with TF32 off) and K3 with float32
     products (`sampler_epilogue_f32`), within 1e-4 of the plain version's
     largest value (the bf16-VPU mode within 0.2 %, its mean within 1e-4,
     moving with the mode), K2 and K3 one launch a call, a repeat
     bit-identical, priced at the float32 rate; K1 and its GEMM again at
     B = 8, and K1's device time by launch (`[k1-split] decoder_stack_f32`);
     and the float32 training kernels (phase 15 (f)) on layer 0 of a
     float32 training forward: K5 (`decoder_layer_f32`) and K6
     (`decoder_layer_bwd_f32`, seven gradients) at B = 4 and 32, within
     1e-4 of the plain float32 version's largest value, priced at the
     float32 rate, K6's `[k6]` lines as the bf16 mode's (its GEMMs beside
     `torch.mm` in float32, TF32 off); and K7's float32 mode
     (`stgcn_forward_f32`, `stgcn_backward_f32`) on the float32 perceptual
     term's inputs at B = 32, T = 900, as the bf16 rows but within 1e-4,
     priced at the float32 rate, 21 launches a call and no plan or bar;
  4. `DDPMTrainer.generate` on the kernel path, ddim50, on synthetic flagship
     weights and a seeded mel: a finite (2, 1800, 26) motion within 3 % of
     the plain path's on the card, with every serving kernel launched;
  5. timings: the ddim50 latency of one clip, and a 1000-step ladder over
     8 clips (bench.py's shape) timed up to the host readback;
  6. training: 4 `DDPMTrainer.train_step`s on the kernel path (K5 / K6 /
     K7, bf16) and 4 on the plain path (float32 modules and autograd), both from
     the same synthetic flagship weights and synthetic ST-GCN, on the same
     seeded mel, motion, t, noise and condition keep masks at the training
     default B = 32 windows of 30 s (T = 900 motion, 2700 mel frames); each
     kernel-path loss, and its perceptual term `loss_mot_feat` (weighted
     1e-6 in the loss, so the loss alone would not see a wrong K7), must be
     finite and within 3e-2 relative of the plain path's (the bf16 bound of
     tests/test_fused_train_path.py), K5, K6 and K7 must have launched in
     every step (K7's forward twice and its backward once), and the median
     ms per step of both paths is printed;
  7. stage 1: 4 `M2SNetTrainer.train_step`s on the kernel path ("auto" on
     CUDA: bf16, music_conv_impl "pallas_train") and 4 on the plain path
     (float32, "lax", cuDNN without TF32), from the same synthetic M2SNet
     weights, on the same seeded music (10, 2700, 128) and motion
     (10, 900, 13, 2), strategy "hard", the same starts drawn with numpy;
     each kernel-path loss must be finite and within 3e-2 relative of the
     plain path's, K4, K9, K10 and K11 must have launched in every step
     (K10 12 times: three pools in each of the step's four forwards),
     and the median ms per step of both paths is printed, with that of the
     ``share_encodes=True`` kernel-path step;
  8. training with the reference's loss mask: 4 steps of
     ``replicate_reference_mask=True``, which "auto" on CUDA must resolve
     to bf16 plain layers with the self-attention on K8 and the perceptual
     term on K7, and 4 on the plain float32 path with the mask, on phase 6's
     batch and random numbers and m_lens = 60 (the reference's value);
     each loss and `loss_mot_feat` finite and within 3e-2 relative of the
     plain path's, K8 launched num_layers = 8 times in every step and K7
     2 + 1 times, the median ms per step of both paths printed;
  9. serving on the plain layers (``layer_impl="flax"``, bf16): ddim50 at
     B = 2 on phase 4's mel and noise, within 3 % of the plain float32
     path's motion, K8 launched 8 x 50 times and K4 launched, its ms
     printed;
 10. serving under bench.py's exact config (int8 AdaLN, bf16 operands, the
     fused kernels): ddim50 at B = 2 on phase 4's mel and noise, and again
     with ``sampler_vpu_dtype="bfloat16"`` added, each within 3 % of the
     plain float32 path's motion with K2 and K1 in their int8 modes (and K1
     in its bf16-VPU mode) on all 50 steps; then bench.py's headline,
     ``ddim1000_60s_clip_motion_frames_per_sec_per_chip``: ddim1000 at
     B = 8, one untimed call, then the best of 3 timed to the host readback
     (`bench.py:64-87`), then the same on the bf16 config, both printed
     (and phase 5's one bf16 call);
 11. M2SGAN (`M2SGANTrainer`), the WGAN-GP step at the reference batch,
     B = 55 samples of 30 s (2700 mel, 900 motion frames), 5 critic
     iterations, from synthetic generator and critic weights and phase 7's
     M2SNet (its music encoder in the generator, its motion encoder the
     SyncLoss network), the same seeded noise and interpolation weights on
     every path, 4 steps each: (a) "auto" on CUDA (K4 on the frozen
     encoder, 7 launches a step; K7 bf16 in the SyncLoss, its forward on
     the fake, masks kept, and the real, its backward on the fake) beside
     the plain float32 path (the encoder on cuDNN without TF32, the flax
     SyncLoss module in float32); (b) (a) with ``cached_features`` and
     ``cached_sync_latents`` (no K4, K7's forward once), whose metrics
     must equal (a)'s bit for bit (cuDNN deterministic in this phase); (c)
     ``train_music_encoder`` on "auto" (bf16, K4's training modes, K9,
     K10 6 and K11 3 times a step) beside its witness, the same precision
     without the kernels (a bf16 generator with its encoder on cuDNN, the
     SyncLoss module in bf16), and the float32 "lax" path.  Every metric
     finite and ``loss_sync`` within 3e-2 relative of the plain path's or
     the witness's at every step; at the first step, from the same weights
     and numbers, ``w_distance`` and ``loss_adv`` within 0.05 (the JAX
     tests' one-step bound, tests/test_stage1.py:276, 337); the plain
     paths and the witness launch no kernel; each step's differences,
     (c)'s from the float32 path too, printed; the median ms a step of
     each path and its peak memory.  Phase 3 also holds phase 11's kernels
     against their plain versions at its shapes: K4 on the frozen encoder
     at B = 55, T = 2700 (`[k4] conv_block_gan`), K7 on the SyncLoss's
     inputs (`[k7] ..._gan`), and K4's training modes, K9, K10 and K11 on
     the inputs and cotangents of their calls in one generator step of
     (c) (`[k4] conv_block_train_gan`, `[k9]`, `[k10]`, `[k11]` ..._gan);
 12. the stage-2 CLI, `python -m conductor_tpu_torch.cli.train`, on a
     synthetic root of 16 60-s clips in a temporary directory (the `[cli]`
     lines): the loader must be the native one, its sequential epoch equal
     to the Python iterator's, and its ms a B = 32 batch and the batch's
     pageable copy to the card are printed; then in process (1) the CLI's
     defaults with ``--times 4 --epochs 3 --save_latest 2``, 6 steps at
     B = 32, T = 900, 1000 diffusion steps: finite losses, config.json
     resolved to ``pallas_fused`` / ``pallas`` / bf16, K5 and K6 8 times
     and K7 2 + 1 times a step, checkpoints at steps 2, 4 and 6, steps/s
     beside phase 6's bare step, and the run's peak memory; (2)
     ``--epochs 1`` then ``--continue --epochs 2`` with
     ``--cached_features`` and cuDNN deterministic, equal to a straight
     ``--epochs 2`` bit for bit (weights, Adam state, every logged loss);
     (3) a SIGTERM to a CLI subprocess: exit 0, its checkpoint at the last
     logged step, and ``--continue`` from it; (4) ``--stage1_ckpt`` from
     a synthetic reference-format M2SNet file, both encoders grafted; (5)
     ``--timestep_sampler loss-second-moment --diffusion_steps 50``, 60
     steps, every ring full; (6) ``--faithful``, 2 steps, no kernel; (7)
     ``--compute_dtype float32`` at its other defaults, 4 steps: config.json
     resolved to ``pallas_fused`` / ``pallas`` / float32, K5 and K6 8 times
     and K7 2 + 1 times a step in their float32 counts and no bf16 K5 / K6
     / K7, finite losses, its ms a step beside (1)'s;
 13. the M2SNet CLI, `python -m conductor_tpu_torch.cli.train_m2snet`, in
     process on a synthetic root of 28 train and 28 test 60-s clips in a
     temporary directory (the `[m2snet_cli]` lines; each `train_step`'s
     launches and wall counted by wrapping it): the Python loader's ms a
     B = 10 batch and its pageable copy; (1) the defaults with ``--epochs 3
     --evaluate_epoch 2``, 15 steps: finite losses, K4 / K9 / K10 / K11 every
     step (K10 12 times), evaluations at epochs 0 and 2 over the three
     difficulties, 24 feature-map dumps, checkpoints 5 and 15, the loop's
     ms a step beside phase 7's bare step, peak memory; (2) ``--continue
     --epochs 1`` (epoch 0, easy, again) equal bit for bit to the same steps
     replayed in process from step 15's checkpoint, cuDNN deterministic;
     (3) ``--remat``: the first step's loss and BN statistics bit-equal to
     (1)'s, K10 24 a step, less peak memory, the largest parameter
     difference printed; (4) ``--microbatch 2``: the first loss within 5 %
     of (1)'s; (5) ``--faithful``: no kernel; (6) phase 15 (b);
 14. the M2SGAN CLI, `python -m conductor_tpu_torch.cli.train_m2sgan`, on
     the same root from (13)'s checkpoint (the `[m2sgan_cli]` lines, cuDNN
     deterministic): the loader's ms a B = 55 batch and its copy; (1) the
     defaults with ``--epochs 2 --evaluate_epoch 1 --eval_batches 1``: K4 7
     and K7 2 + 1 times a step, every evaluation metric finite, BC among
     them, its beat tracking's seconds; (2) ``--cached_sync_latents``: every
     training metric (1)'s bit for bit, K7's forward once; (3) with
     ``--cached_features`` too: no K4, loss_sync and loss_mse within 3e-2 of
     (1)'s (the features' window borders, ROADMAP F11), every metric's
     largest difference printed; (4) ``--train_music_encoder``: K4's
     training modes, K9, K10 6 and K11 3 times a step; (5) ``--continue``
     without ``--m2snet_ckpt``, the SyncLoss net kept; (6) ``--faithful``:
     no kernel;
 15. float32 on the kernels' float32 modes (the `[f32]` lines): (a) 4
     stage-1 steps at B = 10, 10-s crops, "hard", ``compute_dtype=
     "float32", music_conv_impl="pallas_train"`` against the plain float32
     "lax" path on phase 7's weights, batch and starts: the first loss
     within 1e-4 relative and every parameter and BN statistic after it
     within 5e-3 (tests/test_conv_train.py:314, 324), each loss within
     1e-3, K4 52, K9 28, K10 12 and K11 12 float32 launches a step and no
     bf16 one; the median ms a step and peak memory beside the plain
     float32 and the bf16 kernel steps; (b) in phase 13's root, its step
     (6): the M2SNet CLI with ``--compute_dtype float32 --music_conv_impl
     pallas_train`` for (5)'s steps from the same seed, every loss in
     ``metrics.jsonl`` within 1e-3 relative of ``--faithful``'s; (c) 4
     M2SGAN steps at B = 55 with the encoder training in float32 on the
     kernels (the SyncLoss on the plain float32 module) beside phase 11's
     float32 witness (c_plain): the first step's loss_sync, w_distance and
     loss_adv within 1e-3 relative, K4 20, K9 7, K10 6 and K11 3 float32
     launches a step, its ms and peak memory; (d) ddim50 at B = 2 on phase
     4's mel and noise with ``compute_dtype="float32"``,
     ``music_encoder_impl="pallas"`` and the plain layers: the encoder's
     features within 1e-4 of the plain encoder's largest value, the motion
     within 1e-3 of phase 4's plain float32 path's, K4's float32 mode 7
     launches and no other kernel; (d') (d) with ``attention_impl=
     "pallas"``: K8 on float32 q, k and v 8 x 50 times, the motion within
     the same bound; (e) ddim50 at B = 2 on phase 4's mel and noise on the
     fused ladder's float32 mode (``compute_dtype="float32"``,
     ``layer_impl="pallas_fused"``, ``music_encoder_impl="pallas"``,
     ``train_layer_impl="flax"``): the motion within 1e-3 of phase 4's
     plain float32 path's, K4's float32 mode 7 launches and K2, K1, K3 and
     the AdaLN GEMM 50 each in their float32 counts and no other; then with
     bf16 VPU and with int8 AdaLN added, each within 3 %; each call's ms
     beside (d)'s; (f) 4 stage-2 steps at B = 32, T = 900 with
     ``compute_dtype="float32"`` at "auto" (K5 / K6's and K7's float32
     modes) on phase 6's weights and random numbers, against phase 6's
     plain float32 path: the first loss within 1e-4 relative, each loss and
     each `loss_mot_feat` within 1e-3, the largest gap printed, K5 and K6
     8 times and K7 2 + 1 times a step in their float32 counts and no other
     K5 / K6 / K7 count; the median ms a step beside the plain float32
     path's and the bf16 kernel path's;
 16. (run right after phase 3, the `[widths]` lines, `widths_phase`) the
     model widths beside the flagship's that the decoder kernels take,
     each at 8 layers: W32 (D = 32, 4 heads, ff 16), W64 (D = 64, 8
     heads, ff 64), H4 (D = 128, 4 heads, ff 64): (a) K1 in its six
     modes, its AdaLN GEMM (bf16, int8, float32), K2 (bf16, int8, float32
     emb_act, int8 beside float32 products), K3 (both modes) on the first
     ladder step at B = 2, T = 1800, and K5 / K6 (both modes) on layer 0 of
     a training forward at B = 32, T = 900, each against its plain version
     (REL_TOL, F32_REL_TOL, the bf16-VPU rule), a repeat bit-identical, its
     plan the kernel's own export, its ms by CUDA events beside its bound;
     (b) ddim50 at B = 2 in bf16, bench.py's int8 config (with and without
     bf16 VPU) and the three float32 ladders against the plain float32
     path (3 %, float32 1e-3), every step in the mode's counts; (c) 4
     stage-2 steps at B = 32 in bf16 and float32 (losses within 3e-2 of
     the plain float32 path's, K5 / K6 once a layer); (d) at W32 and H4
     (head widths 8, 32) 4 reference-mask steps (K8 8 times a step) and K8
     alone at the mask step's shape, and at head width 64 (D = 256, 4
     heads) K8 alone and a ddim50 on the bf16 plain layers (3 %, K8 400
     times); (e), in phase 12 on its root, `cli.train --latent_dim 64
     --num_heads 8 --ff_size 64`, 4 steps on K5 / K6 / K7.  Each width's
     launches are counted apart (rows `<kernel>_w32`, ..., `_dh64`);
 17. (run after phase 10, the `[serve17]` lines, `serving_phase`) the rest
     of serving at the flagship width, B = 2, on phase 4's mel and noise,
     every trainer on phase 4's weights: `FusedDenoiser.__call__` against
     its glue over `decoder_stack_plain` in bf16 and int8, on the music and
     the null conditions (REL_TOL, one K1 launch a call); (a) guidance 2.5,
     ddim50, in bf16 and bench.py's int8 config (K1 100 launches, K2 / K3
     none); (b) the ancestral ladder, 50 respaced steps, one explicit
     step noise; (c) "epsilon" and "previous_x" with "fixed_large" under it
     (K1 50, K2 / K3 none: F9's gate); (d) `efficient_attention=False` on
     the bf16 plain layers (K4 alone); each within 3 % of the plain float32
     path's largest value, but two: the int8 mode under guidance, held
     against the same ladder on K1's plain version (3 %) and within 4 % of
     the float32 path (`GUIDED_INT8_REL_TOL`, above the serving bound), and
     "epsilon", whose values leave unit scale, held element by element
     (3 % of the element's value plus 3 % of the path's median value); the
     ms of a call beside the plain path's; (e), in phase 12 on its default
     run (`serving_cli_phase`), `cli.test_unseen` and `cli.visualize
     --max_seconds 0 --steps 50 --save_npy` on a synthetic 150-s WAV: 3
     windows, K4 21 and K1 / K2 / K3 150 launches each, the motion (4501,
     13, 2) within 3 % of the plain float32 path's over the same checkpoint
     and seed; `render_motion_video` is replaced by a recorder of that
     motion and no video is rendered (a line says so);
 18. (run after phase 14, the `[eval18]` lines, `eval_phase`) denoiser
     dropout and stage-2 evaluation: (a) 4 stage-2 steps with dropout 0.1
     at B = 32, T = 900, "auto" (bf16 plain layers, K8 8 and K7 2 + 1
     launches a step, no K5 / K6), fixed keep masks from one generator,
     each loss within 3e-2 of the plain float32 path's on the same
     weights, masks and numbers, ms a step beside phase 6's; on phase 12's
     default run and a 16-clip synthetic test split written into its root:
     (b) `cli.evaluate` in bench.py's config at the full ladder (K4 7 and
     K2 / K1 / K3 1000 launches a wave of 8), the bf16 config at ddim50
     and the exact path (plain float32 layers, none of K1-K3), each report
     finite with its wall seconds by part; (c) `cli.evaluate_protocol`
     with phase 13's checkpoint (2 replications, MultiModality; K1-K3 50
     and K4 7 a generate call); (d) `ProspectiveEvaluator` with bench.py's
     config at ddim50; (e) `cli.serving_delta_ci`, 3 seeds x 16 clips at
     ddim50, whose deltas check the pipeline only (a 6-step run's
     weights);
 19. (run after phase 18, the `[dp19]` lines, `dp_phase`) data
     parallelism: (a) two ranks (`python chip_smoke.py --dp19-worker DIR`,
     `dp_worker`) share the card over gloo, each running 4 stage-2 steps on
     its 16 rows of phase 6's global batch of 32 with phase 6's weights
     and random numbers, on "auto" (K5 / K6 / K7), with the reference mask
     (K8 / K7; m_lens that differ between the ranks) and on the plain
     float32 path, every loss and grad_norm within 1e-3 (float32 1e-5) of
     the 1-process steps on the global batch, each rank's launches and ms
     a step beside phase 6's; (b) `cli.train` under torchrun on phase 12's
     root: 1 rank over NCCL (its 2 steps against phase 12's first two), 2
     ranks over gloo with a SIGTERM to rank 1 (both stop at one step, rank
     0 saves, rc 0), then `--continue`; (c) the sharded evaluator (8 clips
     a rank) against the 1-process one on the same waves of 16, its motion
     bit for bit or the gap printed, and `cli.evaluate` under torchrun on 2
     ranks against the 1-process CLI; then the 4-rank wave shape (`python
     chip_smoke.py --dp19-wave-worker DIR`, `dp_wave_worker`): 4 ranks
     over gloo on the card, 2 clips each of waves of 8, against one
     process of 8 on the same waves and x_T, bit for bit (the music
     encoder's projection runs a GEMM a clip since the 4-rank report's
     gap was traced to it); (d) `scripts/run_e2e_demo_torch.py`
     at 8 / 4 clips, 2 + 2 epochs, 2 serving seeds (every stage's seconds,
     the round trip exact) and `scripts/run_1000ladder_torch.py` at ddim50;
 20. (run after phase 19, the `[ref20]` lines, `reference_phase`) a
     reference run directory in and out, at the flagship width: (a)
     `cli.export_torch diffusion` of phase 12's default run into a
     reference run directory (``model/latest.tar`` and an ``opt.txt`` in
     the reference's layout from its config), `cli.export_torch m2snet` of
     phase 13's run, then `cli.import_torch diffusion --stage1_pt` of them
     into ``<checkpoints_dir>/ConductorMotion100/imported``: its checkpoint
     phase 12's (weights and Adam moments bit for bit) with phase 13's
     motion encoder as the perceptual ST-GCN; ddim50 at B = 2 on phase 4's
     mel and noise in the bf16 and bench.py's int8 configs on the imported
     run and on phase 12's, bit for bit (K4 7, K2 / K1 / K3 50 each a
     call); (b) `cli.train --continue` for 2 steps on the imported run, at
     the model flags its config.json records, and on a copy of phase 12's
     run holding the same perceptual ST-GCN, cuDNN deterministic: the
     losses equal; (c) `Generator(decoder_kind="bilstm")` as the M2SGAN
     trainer builds it (the frozen encoder on K4), `GeneratorCVPRLSTM` and
     `CNNLSTMGenerator` at B = 55, 30-s samples: cuDNN's LSTM against the
     plain float32 recurrence (`lstm_plain`) on the same inputs within 1e-3
     of the largest value, and the BiLSTM generator's whole path (K4 in
     bf16) against the plain float32 one within the same bound, ms beside
     each (a second call); (d) DDIM at eta = 1,
     ddim50, B = 2 on the fused layers (K4, then K1 alone a step through
     `FusedDenoiser.__call__`) against the plain float32 path with the same
     step noise, within 3 %; (e) `utils.profiling.trace` around a ddim10
     call, its Chrome trace holding K1's kernels and the `annotate` names;
 21. (run after phase 20, the `[t2m21]` lines, `t2m_phase`) the
     text-to-motion stack (`conductor_tpu_torch.t2m`), which runs none of
     the kernels: a random BiGRU co-embedding evaluator out to a
     `finest.tar`-layout file and back in strictly, its co-embeddings at
     HumanML3D's evaluation batch (B = 32, 196 x 263 motions, 22 x (300 +
     15) captions) against the CPU port, cuDNN's GRUs against `gru_plain`
     (1e-5 of the largest value), and `recover_from_ric`, FK / IK and
     `process_file` on a 196-frame, 22-joint motion against the CPU (1e-4),
     with ms a call.

Every path runs at full depth; the run takes about 9 minutes of its 1200-s
limit, so no path is cut.  Then one JSON line of per-kernel results (the
launch counts of K1-K4 and K1's AdaLN GEMM from phase 4, of K5 / K6 / K7
from phase 6, of K9, K10 and K11 from phase 7, of K8 from phase 8, of K1's
and K2's int8 modes, K1's bf16-VPU mode and the int8 GEMM from phase 10,
phase 11's launches of K4, K7, K9, K10 and K11, phase 12's of K5, K6
and K7, and the steps' launches of phase 13's default run and phase 14's
kernel paths added; the float32 rows with phase 15's: K4's serving mode
(`conv_block_f32`) (d)'s, its training modes (`conv_block_train_f32`),
K9, K10 and K11 those of (a), (b) and (c), K1's float32 modes, its float32
GEMM, K2's float32 emb_act and K3's float32 mode (e)'s, K5's, K6's and
K7's float32 modes those of (f) and of phase 12's float32 run; the
width rows phase 16's, K5 / K6 at W64 with (e)'s added; phase 17's
launches of K1 (bf16 and int8), its GEMM, K2, K3 and K4 added, and phase
18's of K1-K4, K1's GEMM (bf16 and int8), K7 and K8, phase 19's: the
ranks' (a) and (c), and (d)'s demo and ladder in process, and phase 20's:
(a)'s ladders, (b)'s steps, (c)'s encoder and (d)'s and (e)'s K1);
each kernel's time, its
plain version's, its bound and, where one PyTorch call computes the same
function, that call's time), the nvidia-smi line again, and as the last
line {"ok": true, "device": {...}}.
Exits non-zero, printing no result, when there is no CUDA device or any
phase fails.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_SOURCES = {
    "decoder_stack": ("conductor_tpu_torch/csrc/decoder_stack.cu",
                      "conductor_tpu/ops/pallas_layer.py:262"),
    "decoder_stack_int8": ("conductor_tpu_torch/csrc/decoder_stack.cu",
                           "conductor_tpu/ops/pallas_layer.py:262"),
    "decoder_stack_vpu_bf16": ("conductor_tpu_torch/csrc/decoder_stack.cu",
                               "conductor_tpu/ops/pallas_layer.py:262"),
    "sampler_prologue": ("conductor_tpu_torch/csrc/sampler_glue.cu",
                         "conductor_tpu/ops/pallas_sampler.py:80"),
    "sampler_prologue_int8": ("conductor_tpu_torch/csrc/sampler_glue.cu",
                              "conductor_tpu/ops/pallas_sampler.py:80"),
    "sampler_epilogue": ("conductor_tpu_torch/csrc/sampler_glue.cu",
                         "conductor_tpu/ops/pallas_sampler.py:143"),
    "conv_block": ("conductor_tpu_torch/csrc/conv_block.cu",
                   "conductor_tpu/ops/pallas_conv.py:198"),
    "decoder_layer": ("conductor_tpu_torch/csrc/decoder_stack.cu",
                      "conductor_tpu/ops/pallas_layer.py:210"),
    "decoder_layer_bwd": ("conductor_tpu_torch/csrc/decoder_layer_bwd.cu",
                          "conductor_tpu/ops/pallas_layer_bwd.py:353"),
    "stgcn_forward": ("conductor_tpu_torch/csrc/stgcn.cu", "conductor_tpu/ops/pallas_stgcn.py:252"),
    "stgcn_backward": ("conductor_tpu_torch/csrc/stgcn.cu", "conductor_tpu/ops/pallas_stgcn.py:280"),
    "conv3x3_dkernel": ("conductor_tpu_torch/csrc/conv_train.cu",
                        "conductor_tpu/ops/conv_train.py:104"),
    "max_pool": ("conductor_tpu_torch/csrc/max_pool.cu", "conductor_tpu/ops/pallas_pool.py:163"),
    "max_pool_bwd": ("conductor_tpu_torch/csrc/max_pool.cu", "conductor_tpu/ops/pallas_pool.py:352"),
    # the float32 modes of K4 (serving; training), K9, K10 and K11 (phase 15)
    "conv_block_f32": ("conductor_tpu_torch/csrc/conv_block.cu",
                       "conductor_tpu/ops/pallas_conv.py:198"),
    "conv_block_train_f32": ("conductor_tpu_torch/csrc/conv_block.cu",
                             "conductor_tpu/ops/pallas_conv.py:198"),
    "conv3x3_dkernel_f32": ("conductor_tpu_torch/csrc/conv_train.cu",
                            "conductor_tpu/ops/conv_train.py:104"),
    "max_pool_f32": ("conductor_tpu_torch/csrc/max_pool.cu", "conductor_tpu/ops/pallas_pool.py:163"),
    "max_pool_bwd_f32": ("conductor_tpu_torch/csrc/max_pool.cu",
                         "conductor_tpu/ops/pallas_pool.py:352"),
    "linear_attention": ("conductor_tpu_torch/csrc/linear_attention.cu",
                         "conductor_tpu/ops/pallas_attention.py:152"),
    # K1's AdaLN modulation (`_layer_body` :112-120), launched by K1 once a call
    "adaln_modulation": ("conductor_tpu_torch/csrc/adaln_gemm.cu",
                         "conductor_tpu/ops/pallas_layer.py:262"),
    "adaln_modulation_int8": ("conductor_tpu_torch/csrc/adaln_gemm.cu",
                              "conductor_tpu/ops/pallas_layer.py:262"),
    # the fused ladder's float32 mode (phase 15 (e)): K1 alone, with int8
    # AdaLN and with bf16 VPU, its float32 GEMM, K2's float32 emb_act, K3
    "decoder_stack_f32": ("conductor_tpu_torch/csrc/decoder_stack.cu",
                          "conductor_tpu/ops/pallas_layer.py:262"),
    "decoder_stack_f32_int8": ("conductor_tpu_torch/csrc/decoder_stack.cu",
                               "conductor_tpu/ops/pallas_layer.py:262"),
    "decoder_stack_f32_vpu_bf16": ("conductor_tpu_torch/csrc/decoder_stack.cu",
                                   "conductor_tpu/ops/pallas_layer.py:262"),
    "adaln_modulation_f32": ("conductor_tpu_torch/csrc/adaln_gemm.cu",
                             "conductor_tpu/ops/pallas_layer.py:262"),
    "sampler_prologue_f32": ("conductor_tpu_torch/csrc/sampler_glue.cu",
                             "conductor_tpu/ops/pallas_sampler.py:80"),
    "sampler_prologue_f32_int8": ("conductor_tpu_torch/csrc/sampler_glue.cu",
                                  "conductor_tpu/ops/pallas_sampler.py:80"),
    "sampler_epilogue_f32": ("conductor_tpu_torch/csrc/sampler_glue.cu",
                             "conductor_tpu/ops/pallas_sampler.py:143"),
    # the training layers' float32 mode (phase 15 (f)): K5 and K6
    "decoder_layer_f32": ("conductor_tpu_torch/csrc/decoder_stack.cu",
                          "conductor_tpu/ops/pallas_layer.py:210"),
    "decoder_layer_bwd_f32": ("conductor_tpu_torch/csrc/decoder_layer_bwd.cu",
                              "conductor_tpu/ops/pallas_layer_bwd.py:353"),
    # the perceptual ST-GCN's float32 mode (phase 15 (f)): K7
    "stgcn_forward_f32": ("conductor_tpu_torch/csrc/stgcn_f32.cu",
                          "conductor_tpu/ops/pallas_stgcn.py:252"),
    "stgcn_backward_f32": ("conductor_tpu_torch/csrc/stgcn_f32.cu",
                           "conductor_tpu/ops/pallas_stgcn.py:280"),
}
# the AdaLN GEMM's device time beside its yardstick's, in its kernels-line entries
YARDSTICK_KEYS = ("device_ms", "yardstick", "yardstick_device_ms", "no_slower_than_yardstick")
# K1's modes, with their rows of the per-launch split (`k1_launch_split`)
K1_MODES = ("decoder_stack", "decoder_stack_vpu_bf16", "decoder_stack_int8")
SERVING_KERNELS = ("decoder_stack", "sampler_prologue", "sampler_epilogue", "conv_block")
# bench.py's serving config (bench.py:41-50), applied to the port's Config()
BENCH_DENOISER = dict(attention_impl="pallas", compute_dtype="bfloat16", layer_impl="pallas_fused",
                      sampler_adaln_int8=True, music_encoder_impl="pallas")
# phase 15 (e): the fused ladder's float32 modes, (extra denoiser knobs, the
# launches of a ddim50 call on them: K4's float32 mode 7, K2 / K1 / K3 and
# the AdaLN GEMM 50 each, in these counts and no other)
F32_LADDER = {
    "f32": ({}, ("decoder_stack_f32", "sampler_prologue_f32", "sampler_epilogue_f32",
                 "adaln_modulation_f32")),
    "f32_vpu_bf16": (dict(sampler_vpu_dtype="bfloat16"),
                     ("decoder_stack_f32_vpu_bf16", "sampler_prologue_f32",
                      "sampler_epilogue_f32", "adaln_modulation_f32")),
    "f32_int8": (dict(sampler_adaln_int8=True),
                 ("decoder_stack_f32_int8", "sampler_prologue_f32_int8", "sampler_epilogue_f32",
                  "adaln_modulation")),
}
# phase 16: the model widths beside the flagship's that the decoder kernels
# take (ops/_build.py WIDTHS), at the flagship's depth and lengths: JAX's
# own test widths (tests/test_fused_denoiser.py:20), D = 64 with the
# flagship's 8 heads (--latent_dim 64), and D = 128 with 4 heads (head
# width 32, --num_heads 4)
WIDTH_CONFIGS = {"W32": dict(latent_dim=32, num_heads=4, ff_size=16),
                 "W64": dict(latent_dim=64, num_heads=8, ff_size=64),
                 "H4": dict(num_heads=4, ff_size=64)}
# the kernels and modes phase 16 holds at each width (rows named <kernel>_w32, ...)
WIDTH_KERNELS = (
    "decoder_stack", "decoder_stack_int8", "decoder_stack_vpu_bf16", "adaln_modulation",
    "adaln_modulation_int8", "sampler_prologue", "sampler_prologue_int8", "sampler_epilogue",
    "decoder_layer", "decoder_layer_bwd", "decoder_stack_f32", "decoder_stack_f32_int8",
    "decoder_stack_f32_vpu_bf16", "adaln_modulation_f32", "sampler_prologue_f32",
    "sampler_prologue_f32_int8", "sampler_epilogue_f32", "decoder_layer_f32",
    "decoder_layer_bwd_f32")
# phase 16 (b): the fused ladder's modes at each width, (denoiser knobs, the
# launches a ddim50 call gives 50 of each: K1's mode, K2, K3, the AdaLN
# GEMM, whose int8 count the kernels line names adaln_modulation_int8)
WIDTH_LADDERS = {
    "bf16": ({}, ("decoder_stack", "sampler_prologue", "sampler_epilogue", "adaln_modulation")),
    "bench": (dict(sampler_adaln_int8=True),
              ("decoder_stack_int8", "sampler_prologue_int8", "sampler_epilogue",
               "adaln_modulation_int8")),
    "bench+vpu_bf16": (dict(sampler_adaln_int8=True, sampler_vpu_dtype="bfloat16"),
                       ("decoder_stack_int8", "decoder_stack_vpu_bf16", "sampler_prologue_int8",
                        "sampler_epilogue", "adaln_modulation_int8")),
    **{k: (dict(v[0], compute_dtype="float32"),
           tuple("adaln_modulation_int8" if m == "adaln_modulation" else m for m in v[1]))
       for k, v in F32_LADDER.items()},
}
# phase 16 (e): the stage-2 CLI at D = 64 (its other flags the defaults)
WIDTH_CLI_ARGS = ("--latent_dim", "64", "--num_heads", "8", "--ff_size", "64")
# phase 16 (d): K8 alone at head width 64 (D = 256, 4 heads), and serving
# on the plain layers there
DH64 = dict(latent_dim=256, num_heads=4)
for _w in WIDTH_CONFIGS:
    for _k in (*WIDTH_KERNELS, "linear_attention"):
        KERNEL_SOURCES[f"{_k}_{_w.lower()}"] = KERNEL_SOURCES[_k]
KERNEL_SOURCES["linear_attention_dh64"] = KERNEL_SOURCES["linear_attention"]
TRAIN_KERNELS = ("decoder_layer", "decoder_layer_bwd", "stgcn_forward", "stgcn_backward")
# the float32 training kernels' counts (phase 15 (f), phase 12's float32 run)
TRAIN_F32_KERNELS = ("decoder_layer_f32", "decoder_layer_bwd_f32", "stgcn_forward_f32",
                     "stgcn_backward_f32")
K7_PER_STEP = (2, 1)  # K7's forward (pred, target) and backward calls in a stage-2 step
STAGE1_KERNELS = ("conv_block", "conv3x3_dkernel", "max_pool", "max_pool_bwd")
K10_PER_STEP = 12  # K10's calls in a stage-1 step: 3 pools in each of its 4 music forwards
# the float32 modes' counts, and their launches in a float32 stage-1 step (7
# K4 forwards and 6 d(input)s, 7 K9s, 3 K10s and 3 K11s a music forward and
# backward, 4 of them) and in an M2SGAN step with the encoder training in
# float32 (the fake's forward, then the generator step's forward and backward)
STAGE1_F32_KERNELS = ("conv_block_f32", "conv3x3_dkernel_f32", "max_pool_f32", "max_pool_bwd_f32")
F32_PER_STEP = dict(zip(STAGE1_F32_KERNELS, (52, 28, 12, 12)))
GAN_F32_PER_STEP = dict(zip(STAGE1_F32_KERNELS, (20, 7, 6, 3)))
# phase 15's bounds: the float32 stage-1 step's first loss (rtol; (f)'s
# stage-2 step's too) and parameters after it (atol), as
# tests/test_conv_train.py:314, 324 hold the
# JAX package's packed float32 step; its 4 losses, the M2SNet CLI's losses
# and M2SGAN's first-step metrics (rtol); the float32 encoder's features and
# the motion of a float32 generate (of the plain path's largest value)
F32_FIRST_LOSS_RTOL, F32_PARAM_ATOL, F32_LOSS_RTOL = 1e-4, 5e-3, 1e-3
F32_FEATURE_TOL, F32_MOTION_TOL = 1e-4, 1e-3
# stage 1's batch, sample and crop seconds (conductor_tpu/cli/train_m2snet.py)
STAGE1_B, STAGE1_S, STAGE1_C = 10, 30, 10
REFERENCE_M_LENS = 60  # the reference's m_lens (conductor_tpu_torch/config.py TrainConfig)
GENERATE_REL_TOL = 0.03  # ladder drift bound of tests/test_fused_denoiser.py
TRAIN_LOSS_REL_TOL = 3e-2  # bf16 loss bound of tests/test_fused_train_path.py
TRAIN_STEPS = 4
# M2SGAN: the reference batch, sample seconds and critic iterations
# (M2SGAN_train.py:168-196)
GAN_B, GAN_S, GAN_ITERS = 55, 30, 5
GAN_KERNELS = ("conv_block", "conv3x3_dkernel", "max_pool", "max_pool_bwd", "stgcn_forward",
               "stgcn_backward", *STAGE1_F32_KERNELS)
GAN_ADV_TOL = 0.05  # w_distance and loss_adv, tests/test_stage1.py:276, 337
# phase 12: the stage-2 CLI on a synthetic root of 60-s clips; 16 clips
# give 16 windows an epoch, 2 batches of 32 with --times 4
CLI_CLIPS = 16
CLI_KERNELS = TRAIN_KERNELS + TRAIN_F32_KERNELS
# phases 13 and 14: the stage-1 CLIs on one synthetic root of 60-s clips, 28
# a split: 5 batches of 10 (and one of 55) 30-s windows an epoch
STAGE1_CLI_CLIPS = 28
CLI_SEED = 19990319  # the stage-1 CLIs' default --seed
MICROBATCH_LOSS_REL_TOL = 0.05  # tests/test_stage1.py's microbatch bound
GAN_METRICS = ("w_distance", "gp", "loss_adv", "loss_sync", "loss_mse")
GAN_EVAL_KEYS = ("SD_real", "SD_fake", "SDP", "wasserstein", "MSE", "RDE", "SCE", "MPE", "FGD",
                 "Diversity", "BC")


# phase 17: the rest of serving; guidance at tests/test_train_e2e.py:139's
# scale, and a track for the serving CLIs of three windows (60 + 60 + 30 s)
SERVE_GUIDANCE = 2.5
SERVE_CLI_SECONDS = 150
# bench.py's int8 config under guidance 2.5 reads 3.21 % of the plain
# float32 path's largest value on an H100 (700 W; unguided 1.74 %), above
# GENERATE_REL_TOL: the int8 AdaLN's drift, which guidance's (1 - s) u + s c
# enlarges.  The float32 comparison of that item is held just above the
# reading; its kernel is held to GENERATE_REL_TOL against K1's plain version
# in the same mode.
GUIDED_INT8_REL_TOL = 0.04
# phase 18: denoiser dropout at the check's rate (not a documented default),
# and the evaluation CLIs on phase 12's run: a 16-clip test split in waves of
# 8 (`conductor_tpu/eval/evaluator.py:66-67`), the serving-delta sweep's seeds
DROPOUT = 0.1
EVAL_CLIPS = 16
EVAL_WAVE = 8
DELTA_SEEDS = 3
# phase 19: data parallelism, two ranks sharing the card over gloo: the
# bounds of the 2-rank steps against the 1-process steps on the global
# batch (the bf16 kernel paths; the plain float32 path), the reference
# mask's m_lens (rank 0's rows 60 frames, rank 1's 30 and 120), the demo's
# small flags, and each torchrun call's time limit
DP_WORLD = 2
DP_REL_TOL = 1e-3
DP_F32_REL_TOL = 1e-5
DP_M_LENS = np.array([60] * 16 + [30, 120] * 8)
DEMO_ARGS = ("--train_clips", "8", "--test_clips", "4", "--stage1_epochs", "2",
             "--stage2_epochs", "2", "--serving_seeds", "2", "--serving_clips", "8")
DP_TIMEOUT = 300
# the 4-rank wave shape of phase 19 (c): 4 ranks of 2 clips a wave of 8
DP_WAVE_WORLD = 4
# phase 20 (c): cuDNN's LSTM against the plain float32 recurrence
LSTM_REL_TOL = 1e-3
# phase 21: the t2m stack at HumanML3D's evaluation batch (B = 32 motions of
# 196 frames x 263 channels, unit-aligned lengths 40-196; captions of
# max_text_len 20 tokens with sos / eos, 22 positions of 300 GloVe + 15 POS
# channels), and its preprocessing on a 196-frame motion of 22 joints; the
# bounds, of the largest value: the embeddings against the CPU port and
# cuDNN's GRU against `gru_plain`, then the kinematics and features
T2M_B, T2M_FRAMES, T2M_TOKENS, T2M_JOINTS = 32, 196, 22, 22
T2M_EMB_REL_TOL = 1e-5
T2M_MOTION_REL_TOL = 1e-4


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if proc.returncode:
        raise RuntimeError(f"{cmd[0]} failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn().cpu()  # up to the host readback
    return out, time.perf_counter() - t0


def cli_phase(smi: str, bare_step_s: float) -> tuple[dict[str, int], dict[str, int],
                                                     dict[str, int], str]:
    """Phase 12: `python -m conductor_tpu_torch.cli.train` on a synthetic
    root, in process unless a signal is sent; returns the launches of K5 /
    K6 / K7 in its default run and of K5 / K6's float32 mode in its float32
    run, those of phase 16 (e), the CLI at ``WIDTH_CLI_ARGS`` on the same
    root, and those of phase 17 (e), the serving CLIs on the default run
    (`serving_cli_phase`), and its work directory, which phase 18 reads
    (``work/data``, ``work/ConductorMotion100/defaults``) and the caller
    removes.  Raises SystemExit on any failed check."""
    import os
    import shutil
    import signal
    import tempfile

    from conductor_tpu_torch.cli.train import main as train_cli
    from conductor_tpu_torch.data.dataset import (
        BatchIterator,
        ConductorMotionDataset,
        make_synthetic_dataset,
    )
    from conductor_tpu_torch.data.native_loader import make_batch_iterator
    from conductor_tpu_torch.interop import synthetic_m2snet_state_dict
    from conductor_tpu_torch.models.m2snet import M2SNet
    from conductor_tpu_torch.ops import launch_counts, reset_launch_counts
    from conductor_tpu_torch.train.checkpoints import CheckpointManager

    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        root = os.path.join(work, "data")
        make_synthetic_dataset(root, "train", num_clips=CLI_CLIPS)

        # (1) the loader: native, its sequential epoch the Python one's, and
        # its time a B = 32 random-window batch, and the copy to the card
        seq = ConductorMotionDataset(root, "train", 30, "sequential")
        native = make_batch_iterator(seq, 8, shuffle=False)
        if native.kind != "native":
            raise SystemExit(f"chip_smoke: the native loader was not chosen: "
                             f"{getattr(native, 'fallback_reason', '')}")
        nb, pb = list(native), list(BatchIterator(seq, 8, shuffle=False))
        if len(nb) != len(pb) or not all(np.array_equal(x, y) for a, b in zip(nb, pb)
                                         for x, y in zip(a, b)):
            raise SystemExit("chip_smoke: the native loader's epoch differs from the Python one's")
        native.close()
        loader = make_batch_iterator(ConductorMotionDataset(root, "train", 30, "random"), 32,
                                     seed=1, times=4)
        batch_s, copy_s = [], []
        for epoch in range(4):
            loader.epoch = epoch
            t0 = time.perf_counter()
            for mel, motion, m_lens in loader:
                batch_s.append(time.perf_counter() - t0)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                torch.tensor(mel).to("cuda")  # the step's copy: pageable host memory
                torch.tensor(motion).to("cuda")
                torch.cuda.synchronize()
                copy_s.append(time.perf_counter() - t1)
                t0 = time.perf_counter()
        loader.close()
        mb = (mel.nbytes + motion.nbytes) / 1e6
        print(f"[cli] loader: native, its sequential epoch equal to the Python iterator's "
              f"({len(nb)} batches of 8); B=32 random windows: median {np.median(batch_s) * 1e3:.2f} "
              f"ms a batch from the loader (max {max(batch_s) * 1e3:.2f}, {len(batch_s)} batches), "
              f"host-to-device copy of its {mb:.1f} MB median {np.median(copy_s) * 1e3:.2f} ms "
              f"(max {max(copy_s) * 1e3:.2f}) on {smi}")

        def run(name, *extra):
            """One in-process CLI run; its run directory, the launches of the
            path's kernels and its wall seconds."""
            reset_launch_counts()
            t0 = time.perf_counter()
            train_cli(["--data_root", root, "--name", name, "--checkpoints_dir", work, *extra])
            torch.cuda.synchronize()
            return (os.path.join(work, "ConductorMotion100", name), launch_counts(),
                    time.perf_counter() - t0)

        def records(run_dir):
            with open(os.path.join(run_dir, "metrics.jsonl")) as f:
                return [json.loads(line) for line in f]

        def final(run_dir):
            return CheckpointManager(os.path.join(run_dir, "ckpt")).restore()

        # (2) the defaults: B = 32, 30-s windows, 1000 steps, "auto"; 6 steps
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        run_dir, cli_counts, wall = run("defaults", "--times", "4", "--epochs", "3",
                                        "--save_latest", "2")
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        recs = records(run_dir)
        with open(os.path.join(run_dir, "config.json")) as f:
            saved = json.load(f)
        impls = (saved["denoiser"]["train_layer_impl"], saved["train"]["feat_impl"],
                 saved["denoiser"]["compute_dtype"])
        per_step = {k: cli_counts[k] for k in CLI_KERNELS}
        steps = [r["step"] for r in recs]
        t_steps = [r["t"] for r in recs]
        steady = (t_steps[-1] - t_steps[1]) / (len(t_steps) - 2)  # steps 3-6, saves included
        step_ms = [round((b - a) * 1e3, 1) for a, b in zip(t_steps, t_steps[1:])]
        print(f"[cli] defaults (B=32, T=900, 1000 steps, --times 4 --epochs 3): steps {steps}, "
              f"losses {[r['loss'] for r in recs]}, config {impls}, launches {per_step}, "
              f"{1 / steady:.2f} steps/s over steps 3-6 ({steady * 1e3:.1f} ms a step, "
              f"checkpoint saves included; steps 2-6 {step_ms} ms apart; phase 6's bare step "
              f"{bare_step_s * 1e3:.1f} ms, "
              f"{1 / bare_step_s:.2f} steps/s), run wall {wall:.1f} s, peak memory above the "
              f"phases before {peak:.2f} GiB on {smi}")
        if steps != list(range(1, 7)) or not all(np.isfinite(r["loss"]) for r in recs):
            raise SystemExit(f"chip_smoke: the CLI's default run went wrong: {recs}")
        if impls != ("pallas_fused", "pallas", "bfloat16"):
            raise SystemExit(f"chip_smoke: the CLI did not resolve 'auto' to the kernels: {impls}")
        if per_step != {"decoder_layer": 48, "decoder_layer_bwd": 48, "stgcn_forward": 12,
                        "stgcn_backward": 6} | {k: 0 for k in TRAIN_F32_KERNELS}:
            raise SystemExit(f"chip_smoke: the CLI did not launch K5 / K6 / K7 every step: "
                             f"{per_step}")
        if CheckpointManager(os.path.join(run_dir, "ckpt")).all_steps() != [2, 4, 6]:
            raise SystemExit("chip_smoke: the CLI's default run did not save steps 2, 4, 6")
        serve_counts = serving_cli_phase(smi, run_dir, work)  # phase 17 (e)

        # (3) resume from an epoch boundary, cached features, cuDNN
        # deterministic: --epochs 1 then --continue --epochs 2 equals a
        # straight --epochs 2 bit for bit
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            common = ["--times", "4", "--cached_features"]
            straight, _, _ = run("straight", *common, "--epochs", "2")
            resumed, _, _ = run("resumed", *common, "--epochs", "1")
            run("resumed", *common, "--epochs", "2", "--continue")
        finally:
            torch.backends.cudnn.deterministic = deterministic
        a, b = final(straight), final(resumed)
        same = a["total_it"] == b["total_it"] == 4 and all(
            torch.equal(v, b["encoder"][k]) for k, v in a["encoder"].items()) and all(
            torch.equal(v, b["opt_encoder"]["state"][i][key])
            for i, st in a["opt_encoder"]["state"].items() for key, v in st.items())
        losses_a = [r["loss"] for r in records(straight)]
        losses_b = [r["loss"] for r in records(resumed)]
        print(f"[cli] resume at step 2 (cached features): losses straight {losses_a}, resumed "
              f"{losses_b}; final weights and Adam state bit-equal: {same}")
        if not same or losses_a != losses_b:
            raise SystemExit("chip_smoke: the resumed CLI run differs from the straight one")

        # (4) SIGTERM to a CLI process: a checkpoint at the logged step, rc 0
        argv = [sys.executable, "-m", "conductor_tpu_torch.cli.train", "--data_root", root,
                "--name", "sigterm", "--checkpoints_dir", work, "--times", "4",
                "--cached_features", "--epochs", "1000"]
        sig_dir = os.path.join(work, "ConductorMotion100", "sigterm")
        jsonl = os.path.join(sig_dir, "metrics.jsonl")
        proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            deadline = time.time() + 120
            while not (os.path.exists(jsonl) and os.path.getsize(jsonl) > 0):
                if proc.poll() is not None or time.time() > deadline:
                    raise SystemExit(f"chip_smoke: the CLI process logged no step: "
                                     f"{proc.communicate()[0][-2000:]}")
                time.sleep(0.05)
            proc.send_signal(signal.SIGTERM)
            out, _ = proc.communicate(timeout=120)
        finally:
            proc.kill()
            proc.wait()
        last = records(sig_dir)[-1]["step"]
        saved_step = CheckpointManager(os.path.join(sig_dir, "ckpt")).latest_step()
        run("sigterm", "--times", "4", "--cached_features", "--epochs", str(last // 2 + 2),
            "--continue")
        after = [r["step"] for r in records(sig_dir)]
        print(f"[cli] SIGTERM after step {last}: rc {proc.returncode}, latest checkpoint "
              f"{saved_step}; --continue logged steps {after[after.index(last) + 1:]}")
        if proc.returncode != 0 or saved_step != last or after[-1] <= last:
            raise SystemExit(f"chip_smoke: SIGTERM did not checkpoint and resume: {out[-2000:]}")

        # (5) the stage-1 graft from a reference-format M2SNet file
        m2s = synthetic_m2snet_state_dict(M2SNet(), seed=1)
        torch.save({k: torch.from_numpy(v) for k, v in m2s.items()}, os.path.join(work, "m2snet.pt"))
        graft_dir, graft_counts, _ = run("graft", "--times", "2", "--epochs", "1",
                                         "--stage1_ckpt", os.path.join(work, "m2snet.pt"))
        g = final(graft_dir)
        grafted = all(np.array_equal(g["encoder"][k].numpy(), v) for k, v in m2s.items()
                      if k.startswith("music_encoder.")) and all(
            np.array_equal(g["feat_encoder"][k.removeprefix("motion_encoder.")].numpy(), v)
            for k, v in m2s.items() if k.startswith("motion_encoder."))
        g_loss = records(graft_dir)[-1]["loss"]
        print(f"[cli] --stage1_ckpt: encoders grafted {grafted}, loss {g_loss}, K7 launches "
              f"{graft_counts['stgcn_forward']} + {graft_counts['stgcn_backward']}")
        if not grafted or not np.isfinite(g_loss) or graft_counts["stgcn_backward"] != 1:
            raise SystemExit("chip_smoke: the stage-1 graft went wrong")

        # (6) the loss-second-moment sampler over 50 timesteps, to a full ring
        lsm_dir, _, lsm_wall = run("lsm", "--timestep_sampler", "loss-second-moment",
                                   "--diffusion_steps", "50", "--times", "40", "--epochs", "3",
                                   "--cached_features", "--save_latest", "1000")
        st = final(lsm_dir)["sampler_state"]
        full = int((st["loss_counts"] == 10).sum())
        lsm_losses = [r["loss"] for r in records(lsm_dir)]
        print(f"[cli] loss-second-moment, 50 timesteps: {len(lsm_losses)} steps in {lsm_wall:.1f} s, "
              f"{full} of 50 rings full, last loss {lsm_losses[-1]}")
        if full != 50 or not all(np.isfinite(lsm_losses)):
            raise SystemExit("chip_smoke: the loss-second-moment sampler did not fill its rings")

        # (7) --faithful: the plain float32 path, which launches no kernel
        faithful_dir, faithful_counts, faithful_wall = run("faithful", "--faithful", "--times", "2",
                                                           "--epochs", "2")
        f_losses = [r["loss"] for r in records(faithful_dir)]
        print(f"[cli] --faithful: 2 steps in {faithful_wall:.1f} s, losses {f_losses}, launches "
              f"{sum(faithful_counts.values())}")
        if any(faithful_counts.values()) or len(f_losses) != 2 or not all(np.isfinite(f_losses)):
            raise SystemExit(f"chip_smoke: --faithful launched a kernel: {faithful_counts}")

        # (8) float32 at the other defaults: K5 / K6's and K7's float32 modes
        f32_dir, f32_counts, f32_wall = run("float32", "--compute_dtype", "float32", "--times",
                                            "4", "--epochs", "2")
        f32_recs = records(f32_dir)
        with open(os.path.join(f32_dir, "config.json")) as f:
            saved = json.load(f)
        f32_impls = (saved["denoiser"]["train_layer_impl"], saved["train"]["feat_impl"],
                     saved["denoiser"]["compute_dtype"])
        f32_t = [r["t"] for r in f32_recs]
        f32_ms = (f32_t[-1] - f32_t[1]) / (len(f32_t) - 2) * 1e3
        f32_step = {k: f32_counts[k] for k in CLI_KERNELS}
        print(f"[cli] --compute_dtype float32 (--times 4 --epochs 2): steps "
              f"{[r['step'] for r in f32_recs]}, losses {[r['loss'] for r in f32_recs]}, config "
              f"{f32_impls}, launches {f32_step}, {f32_ms:.1f} ms a step over steps 3-4 "
              f"((1): {steady * 1e3:.1f} over steps 3-6, saves included), run wall "
              f"{f32_wall:.1f} s on {smi}")
        if ([r["step"] for r in f32_recs] != [1, 2, 3, 4]
                or not all(np.isfinite(r["loss"]) for r in f32_recs)):
            raise SystemExit(f"chip_smoke: the CLI's float32 run went wrong: {f32_recs}")
        if f32_impls != ("pallas_fused", "pallas", "float32"):
            raise SystemExit(f"chip_smoke: the float32 CLI did not resolve to K5 / K6's and K7's "
                             f"float32 modes: {f32_impls}")
        if f32_step != {k: 0 for k in TRAIN_KERNELS} | {
                "decoder_layer_f32": 32, "decoder_layer_bwd_f32": 32, "stgcn_forward_f32": 8,
                "stgcn_backward_f32": 4}:
            raise SystemExit(f"chip_smoke: the float32 CLI did not launch K5 / K6's and K7's "
                             f"float32 modes every step: {f32_step}")

        # (9) = phase 16 (e): D = 64 with 8 heads and ff 64 at the other
        # defaults, 4 steps: "auto" must resolve to K5 / K6 / K7 at that width
        w_dir, w_counts, w_wall = run("w64", *WIDTH_CLI_ARGS, "--times", "4", "--epochs", "2")
        w_recs = records(w_dir)
        with open(os.path.join(w_dir, "config.json")) as f:
            saved = json.load(f)
        w_impls = (saved["denoiser"]["train_layer_impl"], saved["train"]["feat_impl"],
                   saved["denoiser"]["latent_dim"], saved["denoiser"]["num_heads"])
        w_step = {k: w_counts[k] for k in TRAIN_KERNELS}
        print(f"[widths] (e) cli.train {' '.join(WIDTH_CLI_ARGS)} (--times 4 --epochs 2, on "
              f"phase 12's root): steps {[r['step'] for r in w_recs]}, losses "
              f"{[r['loss'] for r in w_recs]}, config {w_impls}, launches {w_step}, run wall "
              f"{w_wall:.1f} s on {smi}")
        if ([r["step"] for r in w_recs] != [1, 2, 3, 4]
                or not all(np.isfinite(r["loss"]) for r in w_recs)
                or w_impls != ("pallas_fused", "pallas", 64, 8)
                or w_step != {"decoder_layer": 32, "decoder_layer_bwd": 32, "stgcn_forward": 8,
                              "stgcn_backward": 4}):
            raise SystemExit(f"chip_smoke: the CLI at --latent_dim 64 did not run on K5 / K6 / "
                             f"K7: {w_recs} {w_impls} {w_step}")
        return {k: per_step[k] + f32_step[k] for k in CLI_KERNELS}, w_step, serve_counts, work
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise


class StepRecorder:
    """Wraps ``cls.train_step`` while a CLI phase runs: each step's launches
    of ``kernels``, its wall ms (the card synchronised before and after, the
    batch's copy to the card included) and, after the first step, a copy of
    the model's buffers and parameters (``module`` names the attribute)."""

    def __init__(self, cls, kernels, module: str | None = None):
        self.cls, self.kernels, self.module, self.orig = cls, kernels, module, cls.train_step
        self.steps: list[dict] = []
        self.first: dict | None = None

    def __enter__(self):
        from conductor_tpu_torch.ops import launch_counts

        def step(tr, *args, **kwargs):
            before = launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.orig(tr, *args, **kwargs)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            after = launch_counts()
            self.steps.append({"ms": ms, "launches": {k: after[k] - before[k] for k in self.kernels}})
            if self.first is None and self.module is not None:
                module = getattr(tr, self.module)
                self.first = {part: {k: v.detach().clone() for k, v in named()}
                              for part, named in (("buffers", module.named_buffers),
                                                  ("params", module.named_parameters))}
            return out

        self.cls.train_step = step
        return self

    def __exit__(self, *exc):
        self.cls.train_step = self.orig

    def launches(self) -> dict[str, int]:
        return {k: sum(s["launches"][k] for s in self.steps) for k in self.kernels}


def stage1_cli_run(cli, work: str, stage: str, kernels, module: str, name: str, *argv):
    """One in-process run of a stage-1 CLI on phase 13's root: its run
    directory, records, `StepRecorder`, peak memory above the run's start
    (bytes), the launches of the whole run (steps, evaluations and caches)
    and its wall seconds."""
    import os

    from conductor_tpu_torch.ops import launch_counts, reset_launch_counts

    cls = cli.M2SNetTrainer if stage == "M2SNet" else cli.M2SGANTrainer
    reset_launch_counts()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with StepRecorder(cls, kernels, module) as rec:
        t0 = time.perf_counter()
        cli.main(["--data_root", os.path.join(work, "data"), "--checkpoints_dir", work,
                  "--name", name, *argv])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run_dir = os.path.join(work, stage, name)
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    return (run_dir, records, rec, torch.cuda.max_memory_allocated() - base, launch_counts(),
            wall)


def batch_copy(root: str, batch: int, seconds: int, smi: str, tag: str) -> None:
    """The CLIs' Python loader's ms a batch of ``seconds``-s windows and its
    pageable copy to the card, as the step copies it, three batches."""
    from conductor_tpu_torch.data.dataset import BatchIterator, ConductorMotionDataset

    loader = BatchIterator(ConductorMotionDataset(root, "train", seconds, "sequential"), batch,
                           seed=1, times=3)
    load_ms, copy_ms = [], []
    it = iter(loader)
    for _ in range(3):
        t0 = time.perf_counter()
        mel, motion, _ = next(it)
        load_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.tensor(mel).to("cuda")
        torch.tensor(motion).to("cuda")
        torch.cuda.synchronize()
        copy_ms.append((time.perf_counter() - t0) * 1e3)
    mb = (mel.nbytes + motion.nbytes) / 1e6
    print(f"[{tag}] B={batch} batch from the Python loader: {[round(x, 2) for x in load_ms]} ms; "
          f"its {mb:.1f} MB pageable copy to the card: {[round(x, 2) for x in copy_ms]} ms on {smi}")


def m2snet_cli_phase(smi: str, work: str,
                     bare_step_s: float) -> tuple[dict[str, int], str, dict[str, int]]:
    """Phase 13: `python -m conductor_tpu_torch.cli.train_m2snet` in process
    on the root under ``work``; returns the launches of its default run's
    steps, that run's checkpoint root and the launches of the float32 run's
    steps (phase 15 (b)).  Raises SystemExit on any failed check."""
    import os

    from conductor_tpu_torch import M2SNetTrainer
    from conductor_tpu_torch.cli import train_m2snet as cli
    from conductor_tpu_torch.data.dataset import BatchIterator, ConductorMotionDataset
    from conductor_tpu_torch.train.checkpoints import CheckpointManager
    from conductor_tpu_torch.train.ddpm_trainer import step_generator

    root = os.path.join(work, "data")
    batch_copy(root, STAGE1_B, STAGE1_S, smi, "m2snet_cli")

    def run(name, *argv):
        return stage1_cli_run(cli, work, "M2SNet", STAGE1_KERNELS, "model", name, *argv)

    def losses(records):
        return [r["loss"] for r in records if "loss" in r]

    # (1) the defaults: B = 10, 30-s windows, 10-s crops, "hard", "auto"
    run_dir, recs, rec, peak, _, wall = run("defaults", "--epochs", "3", "--evaluate_epoch", "2")
    steps = [r for r in recs if "loss" in r]
    evals = [r for r in recs if "accuracy_easy" in r]
    keys = [f"{k}_{s}" for s in ("easy", "hard", "super_hard")
            for k in ("accuracy", "sync_prob", "non_sync_prob")]
    per_step = [s["launches"] for s in rec.steps]
    images = os.listdir(os.path.join(run_dir, "images"))
    ckpts = CheckpointManager(os.path.join(run_dir, "ckpt")).all_steps()
    # the loop's ms a step: consecutive steps with no evaluation between them
    gaps = [(b["t"] - a["t"]) * 1e3 for a, b in zip(recs, recs[1:]) if "loss" in a and "loss" in b]
    print(f"[m2snet_cli] defaults (B={STAGE1_B}, {STAGE1_S}-s windows, hard, --epochs 3 "
          f"--evaluate_epoch 2): {len(steps)} steps, losses {losses(recs)}; evaluations at (step, epoch) "
          f"{[(r['step'], r['epoch']) for r in evals]}: {[{k: r[k] for k in keys} for r in evals]}; "
          f"{len(images)} feature-map images, checkpoints {ckpts}; launches per step {per_step}")
    print(f"[m2snet_cli] defaults: the loop's ms a step (consecutive steps) median "
          f"{np.median(gaps):.1f} (min {min(gaps):.1f}, max {max(gaps):.1f}, {len(gaps)}); "
          f"train_step with its batch copy median {np.median([s['ms'] for s in rec.steps]):.1f} "
          f"ms; phase 7's bare step {bare_step_s * 1e3:.1f} ms; run wall {wall:.1f} s, peak "
          f"memory above its start {peak / 2**30:.3f} GiB on {smi}")
    if (len(steps) != 15 or not all(np.isfinite(losses(recs)))
            or [(r["step"], r["epoch"]) for r in evals] != [(5, 0), (15, 2)]
            or not all(np.isfinite(r[k]) for r in evals for k in keys)):
        raise SystemExit(f"chip_smoke: the M2SNet CLI's default run went wrong: {recs}")
    if len(images) != 2 * (5 + 7) or ckpts != [5, 15]:
        raise SystemExit(f"chip_smoke: the M2SNet CLI's dumps went wrong: {images}, {ckpts}")
    if min(c[k] for c in per_step for k in STAGE1_KERNELS) == 0 or any(
            c["max_pool"] != K10_PER_STEP for c in per_step):
        raise SystemExit(f"chip_smoke: a stage-1 kernel was not launched in every CLI step: "
                         f"{per_step}")
    counts, first, first_loss = rec.launches(), rec.first, losses(recs)[0]

    # (2) --continue --epochs 1: epoch 0 (easy) again from step 15, against
    # the same steps replayed here from that checkpoint, cuDNN deterministic
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        saved = CheckpointManager(os.path.join(run_dir, "ckpt")).restore(15)
        _, recs, rec, _, _, _ = run("defaults", "--epochs", "1", "--continue",
                                    "--eval_batches", "1")
        replay = M2SNetTrainer(sample_length=STAGE1_S, clip_length=STAGE1_C, device="cuda")
        replay.load_state_dict(saved)
        replayed = []
        loader = BatchIterator(ConductorMotionDataset(root, "train", STAGE1_S, "sequential"),
                               STAGE1_B, seed=CLI_SEED)
        for mel, motion, _ in loader:
            m = replay.train_step(mel, motion, "easy",
                                  generator=step_generator(CLI_SEED, replay.step))
            replayed.append({k: float(v) for k, v in m.items()})
    finally:
        torch.backends.cudnn.deterministic = deterministic
    resumed = [{k: r[k] for k in replayed[0]} for r in recs if "loss" in r][15:]
    final = CheckpointManager(os.path.join(run_dir, "ckpt")).restore()
    again = replay.state_dict()
    same = final["step"] == again["step"] == 20 and all(
        torch.equal(v, again["model"][k]) for k, v in final["model"].items()) and all(
        torch.equal(v, again["optimizer"]["state"][i][key])
        for i, st in final["optimizer"]["state"].items() for key, v in st.items())
    print(f"[m2snet_cli] --continue --epochs 1 from step 15: steps "
          f"{[r['step'] for r in recs if 'loss' in r][15:]}, losses {[r['loss'] for r in resumed]}, "
          f"replayed in process {[r['loss'] for r in replayed]}; every metric equal "
          f"{resumed == replayed}; final weights, BN statistics and Adam state bit-equal {same}")
    if resumed != replayed or not same:
        raise SystemExit("chip_smoke: the resumed M2SNet CLI differs from the replay")
    del replay, saved, final, again

    # (3) --remat: the first step's loss and BN statistics bit-equal to (1)'s
    _, recs, rec, remat_peak, _, _ = run("remat", "--remat", "--epochs", "1", "--evaluate_epoch",
                                         "5", "--eval_batches", "1")
    stats_equal = all(torch.equal(v, first["buffers"][k]) for k, v in rec.first["buffers"].items())
    param_diff = max(float((v - first["params"][k]).abs().max())
                     for k, v in rec.first["params"].items())
    print(f"[m2snet_cli] --remat: first loss {losses(recs)[0]} (defaults {first_loss}), BN "
          f"statistics after step 1 bit-equal {stats_equal}, largest parameter difference after "
          f"step 1 {param_diff:.6g}; launches per step {[s['launches'] for s in rec.steps]}; "
          f"train_step median {np.median([s['ms'] for s in rec.steps]):.1f} ms; peak memory "
          f"{remat_peak / 2**30:.3f} GiB against the defaults' {peak / 2**30:.3f} GiB on {smi}")
    if losses(recs)[0] != first_loss or not stats_equal or not remat_peak < peak or any(
            s["launches"]["max_pool"] != 2 * K10_PER_STEP for s in rec.steps):
        raise SystemExit("chip_smoke: --remat did not repeat the first step or save memory")

    # (4) --microbatch 2: the first loss within 5 % of (1)'s (tests/test_stage1.py)
    _, recs, rec, micro_peak, _, _ = run("micro", "--microbatch", "2", "--epochs", "1",
                                         "--evaluate_epoch", "5", "--eval_batches", "1")
    rel = abs(losses(recs)[0] - first_loss) / abs(first_loss)
    print(f"[m2snet_cli] --microbatch 2: first loss {losses(recs)[0]} (defaults {first_loss}, "
          f"rel diff {rel:.4g}); train_step median {np.median([s['ms'] for s in rec.steps]):.1f} "
          f"ms; peak memory {micro_peak / 2**30:.3f} GiB on {smi}")
    if not rel <= MICROBATCH_LOSS_REL_TOL or not all(np.isfinite(losses(recs))):
        raise SystemExit("chip_smoke: --microbatch 2 moved the first loss")

    # (5) --faithful: the plain float32 path, which launches no kernel
    _, recs, rec, _, faithful_counts, wall = run("faithful", "--faithful", "--epochs", "1",
                                                 "--evaluate_epoch", "5", "--eval_batches", "1")
    print(f"[m2snet_cli] --faithful: {len(losses(recs))} steps in {wall:.1f} s, losses "
          f"{losses(recs)}, train_step median {np.median([s['ms'] for s in rec.steps]):.1f} ms, "
          f"launches {sum(faithful_counts.values())}")
    if any(faithful_counts.values()) or not all(np.isfinite(losses(recs))):
        raise SystemExit(f"chip_smoke: the M2SNet CLI's --faithful launched a kernel: "
                         f"{faithful_counts}")

    # (6) = phase 15 (b): float32 on the kernels' float32 modes, the same
    # steps as (5) from the same seed: every loss within 1e-3 relative
    faithful_losses = losses(recs)
    _, recs, rec, f32_peak, _, wall = stage1_cli_run(
        cli, work, "M2SNet", STAGE1_KERNELS + STAGE1_F32_KERNELS, "model", "f32",
        "--compute_dtype", "float32", "--music_conv_impl", "pallas_train", "--epochs", "1",
        "--evaluate_epoch", "5", "--eval_batches", "1")
    f32_losses, per_step = losses(recs), [s["launches"] for s in rec.steps]
    rel = [abs(a - b) / abs(b) for a, b in zip(f32_losses, faithful_losses)]
    print(f"[m2snet_cli] --compute_dtype float32 --music_conv_impl pallas_train (phase 15 (b)): "
          f"{len(f32_losses)} steps in {wall:.1f} s, losses {f32_losses} against --faithful's "
          f"{faithful_losses}, largest rel diff {max(rel):.3g} (bound {F32_LOSS_RTOL}); "
          f"train_step median {np.median([s['ms'] for s in rec.steps]):.1f} ms, peak memory "
          f"{f32_peak / 2**30:.3f} GiB; launches per step {per_step} on {smi}")
    if len(f32_losses) != len(faithful_losses) or not max(rel) <= F32_LOSS_RTOL:
        raise SystemExit("chip_smoke: the float32 M2SNet CLI on the kernels disagrees with "
                         "--faithful")
    if any({k: c[k] for k in STAGE1_F32_KERNELS} != F32_PER_STEP
           or any(c[k] for k in STAGE1_KERNELS) for c in per_step):
        raise SystemExit(f"chip_smoke: the float32 M2SNet CLI did not launch the float32 modes "
                         f"as expected: {per_step}")
    f32_counts = {k: sum(c[k] for c in per_step) for k in STAGE1_F32_KERNELS}
    return counts, os.path.join(run_dir, "ckpt"), f32_counts


def m2sgan_cli_phase(smi: str, work: str, m2snet_ckpt: str, gan_step_s: float) -> dict[str, int]:
    """Phase 14: `python -m conductor_tpu_torch.cli.train_m2sgan` in process
    on phase 13's root, from its checkpoint; returns the launches of the
    kernel paths' steps.  Raises SystemExit on any failed check."""
    import os

    from conductor_tpu_torch.cli import train_m2sgan as cli
    from conductor_tpu_torch.eval import stage1
    from conductor_tpu_torch.train.checkpoints import CheckpointManager, restore_raw

    batch_copy(os.path.join(work, "data"), GAN_B, GAN_S, smi, "m2sgan_cli")
    beat_s: list[float] = []
    beat = stage1.beat_consistency

    def timed_beat(*args, **kwargs):
        t0 = time.perf_counter()
        out = beat(*args, **kwargs)
        beat_s.append(time.perf_counter() - t0)
        return out

    def run(name, *argv):
        return stage1_cli_run(cli, work, "M2SGAN", GAN_KERNELS, None, name, *argv)

    def steps(records):
        return [{k: r[k] for k in GAN_METRICS} for r in records if "loss_sync" in r]

    common = ["--m2snet_ckpt", m2snet_ckpt, "--evaluate_epoch", "5", "--eval_batches", "1",
              "--no_eval_beats"]
    # cuDNN deterministic, so that (2) can repeat (1)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    stage1.beat_consistency = timed_beat
    try:
        # (1) the defaults: B = 55, frozen encoder on K4, SyncLoss on K7
        t0 = time.perf_counter()
        _, recs, rec, peak, _, wall = run("defaults", "--m2snet_ckpt", m2snet_ckpt, "--epochs", "2",
                                          "--evaluate_epoch", "1", "--eval_batches", "1")
        evals = [r for r in recs if "FGD" in r]
        base = steps(recs)
        print(f"[m2sgan_cli] defaults (B={GAN_B}, {GAN_S}-s samples, critic_iters {GAN_ITERS}, "
              f"--epochs 2 --evaluate_epoch 1 --eval_batches 1): metrics {base}; evaluations "
              f"{[{k: r[k] for k in GAN_EVAL_KEYS} for r in evals]}; BC's beat tracking "
              f"{sum(beat_s):.2f} s over {len(beat_s)} clips; launches per step "
              f"{[s['launches'] for s in rec.steps]}")
        print(f"[m2sgan_cli] defaults: train_step with its batch copy "
              f"{[round(s['ms'], 1) for s in rec.steps]} ms (phase 11's (a) step median "
              f"{gan_step_s * 1e3:.1f} ms); run wall {wall:.1f} s; peak memory above its start "
              f"{peak / 2**30:.3f} GiB on {smi}")
        if (len(base) != 2 or not all(np.isfinite(list(m.values())).all() for m in base)
                or len(evals) != 2 or not all(np.isfinite(r[k]) for r in evals for k in GAN_EVAL_KEYS)
                or not beat_s):
            raise SystemExit(f"chip_smoke: the M2SGAN CLI's default run went wrong: {recs}")
        if any((c["conv_block"], c["stgcn_forward"], c["stgcn_backward"]) != (7, 2, 1)
               for c in (s["launches"] for s in rec.steps)):
            raise SystemExit(f"chip_smoke: the M2SGAN CLI did not launch K4 7 times and K7 2 + 1 "
                             f"times a step: {rec.steps}")
        counts = rec.launches()

        # (2) --cached_sync_latents: every training metric (1)'s, bit for bit
        _, recs, rec, _, _, _ = run("latents", *common, "--epochs", "2", "--cached_sync_latents")
        print(f"[m2sgan_cli] --cached_sync_latents: metrics {steps(recs)}; equal to the defaults' "
              f"bit for bit {steps(recs) == base}; launches per step "
              f"{[s['launches'] for s in rec.steps]}; train_step "
              f"{[round(s['ms'], 1) for s in rec.steps]} ms")
        if steps(recs) != base or any((c["stgcn_forward"], c["stgcn_backward"]) != (1, 1)
                                      for c in (s["launches"] for s in rec.steps)):
            raise SystemExit("chip_smoke: --cached_sync_latents did not repeat the uncached run")
        counts = {k: n + rec.launches()[k] for k, n in counts.items()}

        # (3) with --cached_features as well: no K4, K7's forward once; the
        # features' window borders (F11) move the losses within 3e-2
        _, recs, rec, _, _, _ = run("cached", *common, "--epochs", "2", "--cached_sync_latents",
                                    "--cached_features")
        got = steps(recs)
        rel = max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(got, base)
                  for k in ("loss_sync", "loss_mse"))
        diff = {k: max(abs(g[k] - w[k]) for g, w in zip(got, base)) for k in GAN_METRICS}
        print(f"[m2sgan_cli] --cached_sync_latents --cached_features: metrics {got}; largest "
              f"difference from the defaults' {diff}, loss_sync / loss_mse rel {rel:.4g}; "
              f"launches per step {[s['launches'] for s in rec.steps]}; train_step "
              f"{[round(s['ms'], 1) for s in rec.steps]} ms")
        if not rel <= TRAIN_LOSS_REL_TOL or any(
                (c["conv_block"], c["stgcn_forward"], c["stgcn_backward"]) != (0, 1, 1)
                for c in (s["launches"] for s in rec.steps)):
            raise SystemExit("chip_smoke: the cached M2SGAN CLI run went wrong")
        counts = {k: n + rec.launches()[k] for k, n in counts.items()}

        # (4) --train_music_encoder: K4's training modes, K9, K10 6 and K11 3 a step
        _, recs, rec, enc_peak, _, _ = run("encoder", *common, "--epochs", "2",
                                           "--train_music_encoder")
        per_step = [s["launches"] for s in rec.steps]
        print(f"[m2sgan_cli] --train_music_encoder: metrics {steps(recs)}; launches per step "
              f"{per_step}; train_step {[round(s['ms'], 1) for s in rec.steps]} ms; peak memory "
              f"{enc_peak / 2**30:.3f} GiB on {smi}")
        if len(per_step) != 2 or not all(np.isfinite(list(m.values())).all() for m in steps(recs)) or any(
                min(c["conv_block"], c["conv3x3_dkernel"]) == 0
                or (c["max_pool"], c["max_pool_bwd"], c["stgcn_forward"], c["stgcn_backward"])
                != (6, 3, 2, 1) for c in per_step):
            raise SystemExit(f"chip_smoke: --train_music_encoder did not launch its kernels: "
                             f"{per_step}")
        counts = {k: n + rec.launches()[k] for k, n in counts.items()}

        # (5) --continue without --m2snet_ckpt: the SyncLoss net from the checkpoint
        _, recs, _, _, _, _ = run("defaults", "--epochs", "1", "--continue", "--evaluate_epoch", "5",
                                  "--eval_batches", "1", "--no_eval_beats")
        final = CheckpointManager(os.path.join(work, "M2SGAN", "defaults", "ckpt")).restore()
        m2snet = restore_raw(m2snet_ckpt)
        sync_kept = all(torch.equal(v, m2snet["motion_encoder." + k])
                        for k, v in final["sync_encoder"].items())
        print(f"[m2sgan_cli] --continue (no --m2snet_ckpt): steps "
              f"{[r['step'] for r in recs if 'loss_sync' in r]}, metrics {steps(recs)[2:]}; the "
              f"SyncLoss net is the M2SNet's {sync_kept}")
        if [r["step"] for r in recs if "loss_sync" in r] != [1, 2, 3] or not sync_kept:
            raise SystemExit("chip_smoke: the M2SGAN CLI's --continue went wrong")

        # (6) --faithful: the plain float32 path, which launches no kernel
        _, recs, rec, _, faithful_counts, wall = run("faithful", *common, "--epochs", "1",
                                                     "--faithful")
        print(f"[m2sgan_cli] --faithful: metrics {steps(recs)} in {wall:.1f} s, train_step "
              f"{[round(s['ms'], 1) for s in rec.steps]} ms, launches "
              f"{sum(faithful_counts.values())}")
        if any(faithful_counts.values()) or not steps(recs):
            raise SystemExit(f"chip_smoke: the M2SGAN CLI's --faithful launched a kernel: "
                             f"{faithful_counts}")
        print(f"[m2sgan_cli] phase 14 took {time.perf_counter() - t0:.1f} s")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        stage1.beat_consistency = beat
    return counts


def widths_phase(smi, cfg, feat_sd, mel, noise, mel_train, motion_train, train, m_lens, rng):
    """Phase 16: the model widths beside the flagship's (`WIDTH_CONFIGS`),
    each at the flagship's 8 layers: (a) every widened kernel and mode
    against its plain version on the real operands of layer 0 (K1-K3 on
    the first ladder step of ``mel`` / ``noise`` at B = 2, T = 1800; K5 /
    K6 on ``mel_train`` / ``motion_train`` at B = 32, T = 900), a repeat
    bit-identical, the plan the kernel's own export; (b) ddim50 at B = 2 in
    each of the ladder's modes (`WIDTH_LADDERS`) against the plain float32
    path; (c) 4 stage-2 steps by ``train`` (phase 6's) in bf16 and float32
    against the plain float32 path; (d) K8 through phase 8's
    reference-mask steps (``m_lens``) at head widths 8 (W32) and 32 (H4),
    and at 64 alone and in plain-layer serving (D = 256, 4 heads); K8's
    inputs drawn from ``rng``.  (e),
    the CLI at D = 64, runs in phase 12.  Returns the kernel rows (named
    ``<kernel>_<width>``) and their launches on the paths (b)-(d), each
    width counted apart.  Raises SystemExit on any failed check."""
    from conductor_tpu_torch import DDPMTrainer
    from conductor_tpu_torch.config import DenoiserConfig, TrainConfig
    from conductor_tpu_torch.interop import synthetic_state_dict
    from conductor_tpu_torch.kernel_checks import (
        check_attention_kernel,
        check_kernels,
        check_train_kernels,
    )
    from conductor_tpu_torch.ops import launch_counts, part_launch_counts, reset_launch_counts

    n_train, t_train = mel_train.shape[0], motion_train.shape[1]
    results, counts = [], {}
    width_counts = {}

    def width_trainer(widths, **knobs):
        """A trainer at ``widths`` with the denoiser ``knobs`` ("plain": the
        plain float32 path) on synthetic weights of its own width."""
        train_kw = {}
        if knobs.pop("plain", False):
            knobs.update(layer_impl="flax", music_encoder_impl="flax", train_layer_impl="flax",
                         attention_impl="xla", compute_dtype="float32")
            train_kw["feat_impl"] = "flax"
        if knobs.pop("mask", False):
            train_kw["replicate_reference_mask"] = True
        tr = DDPMTrainer(cfg.replace(denoiser=DenoiserConfig(**widths, **knobs),
                                     train=TrainConfig(**train_kw)), device="cuda")
        tr.load_reference_state_dict(synthetic_state_dict(tr.model, seed=0),
                                     motion_encoder=feat_sd)
        return tr

    def width_rows(rows, tag):
        for r in rows:
            r["name"] = f"{r['name']}_{tag}"
            extra = "".join(f", {k} {r[k]}" for k in ("repeat_identical", "plan_ok") if k in r)
            dev = f", device {r['device_ms']:.4f} ms" if "device_ms" in r else ""
            print(f"[widths] (a) {r['name']}: max_abs_err {r['max_abs_err']:.6g} (plain max "
                  f"{r['ref_max_abs']:.6g}) kernel {r['ms']:.4f} ms by CUDA events{dev}, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms"
                  f"{extra}: ok {r['ok']} ({smi})")
        failed = [r["name"] for r in rows if not r["ok"]]
        if failed:
            raise SystemExit(f"chip_smoke: kernels disagree with their plain versions: {failed}")
        return rows

    for wname, widths in WIDTH_CONFIGS.items():
        t_w = time.perf_counter()
        tag, wc = wname.lower(), {}
        w_k, w_f, w_p = (width_trainer(widths), width_trainer(widths, compute_dtype="float32"),
                         width_trainer(widths, plain=True))
        if (w_k.fused is None or w_f.fused is None or w_k.cfg.denoiser.train_layer_impl
                != "pallas_fused" or w_f.cfg.denoiser.train_layer_impl != "pallas_fused"):
            raise SystemExit(f"chip_smoke: 'auto' at {wname} did not select the decoder kernels")
        # (a)
        rows = [r for tr in (w_k, w_f) for r in check_kernels(tr, mel, noise)
                if not r["name"].startswith("conv_block")]
        rows += check_train_kernels(w_k, mel_train, motion_train)
        rows += check_train_kernels(w_f, mel_train, motion_train)
        results += width_rows(rows, tag)
        torch.cuda.empty_cache()
        # (b)
        ref_w = w_p.generate(mel, num_steps=50, noise=noise)
        scale_w = float(ref_w.abs().max())
        for label, (knobs, modes) in WIDTH_LADDERS.items():
            tr = width_trainer(widths, **knobs) if knobs else w_k
            reset_launch_counts()
            out_w = tr.generate(mel, num_steps=50, noise=noise)
            torch.cuda.synchronize()
            bc = launch_counts() | part_launch_counts()
            got = {k: bc["adaln_modulation" if k == "adaln_modulation_int8" else k] for k in modes}
            err_w = float((out_w - ref_w).abs().max())
            tol = F32_MOTION_TOL if label == "f32" else GENERATE_REL_TOL
            print(f"[widths] (b) {wname} ddim50 B=2 {label}: max_abs_err vs plain float32 "
                  f"{err_w:.6g} (plain max {scale_w:.6g}, bound {tol:g} of it) launches {got}")
            if (tuple(out_w.shape) != (2, 1800, 26) or not bool(torch.isfinite(out_w).all())
                    or not err_w <= tol * scale_w):
                raise SystemExit(f"chip_smoke: generate at {wname} ({label}) is wrong")
            if any(n != 50 for n in got.values()):
                raise SystemExit(f"chip_smoke: the {label} ladder at {wname} did not launch its "
                                 f"modes on every step: {got}")
            for k, n in got.items():
                wc[k] = wc.get(k, 0) + n
            del tr
        # (c)
        losses_wp, _, times_wp, _ = train(w_p)
        for label, tr, kset in (("bf16", w_k, ("decoder_layer", "decoder_layer_bwd")),
                                ("float32", w_f, ("decoder_layer_f32", "decoder_layer_bwd_f32"))):
            losses_w, _, times_w, counts_w = train(tr)
            rel_w = [abs(a - b) / abs(b) for a, b in zip(losses_w, losses_wp)]
            per_step_w = [{k: c[k] for k in kset} for c in counts_w]
            print(f"[widths] (c) {wname} stage-2 step B={n_train} T={t_train} {label}: losses "
                  f"{losses_w} against the plain float32 path's {losses_wp}: largest rel diff "
                  f"{max(rel_w):.3g} (<= {TRAIN_LOSS_REL_TOL}); median {np.median(times_w) * 1e3:.1f} "
                  f"ms a step (plain {np.median(times_wp) * 1e3:.1f}); launches per step "
                  f"{per_step_w} on {smi}")
            if not all(np.isfinite(losses_w)) or max(rel_w) > TRAIN_LOSS_REL_TOL:
                raise SystemExit(f"chip_smoke: stage 2 at {wname} ({label}) disagrees with the "
                                 f"plain float32 path")
            if any(c[k] != cfg.denoiser.num_layers for c in per_step_w for k in kset):
                raise SystemExit(f"chip_smoke: stage 2 at {wname} ({label}) did not launch K5 / "
                                 f"K6 once a layer: {per_step_w}")
            for k in kset:
                wc[k] = sum(c[k] for c in per_step_w)
        del w_k, w_f, w_p
        # (d): the reference-mask step at head widths 8 and 32
        dh = widths.get("latent_dim", 128) // widths["num_heads"]
        if wname in ("W32", "H4"):
            mask_k, mask_p = (width_trainer(widths, mask=True),
                              width_trainer(widths, mask=True, plain=True))
            if mask_k.cfg.denoiser.attention_impl != "pallas":
                raise SystemExit(f"chip_smoke: the mask step at {wname} does not run K8")
            losses_mk, _, _, counts_mk = train(mask_k, m_lens)
            losses_mp, _, _, _ = train(mask_p, m_lens)
            rel_mk = [abs(a - b) / abs(b) for a, b in zip(losses_mk, losses_mp)]
            k8 = [c["linear_attention"] for c in counts_mk]
            print(f"[widths] (d) {wname} reference-mask step (head width {dh}): losses "
                  f"{losses_mk} plain {losses_mp}, largest rel diff {max(rel_mk):.3g}; K8 "
                  f"launches per step {k8}")
            if (not all(np.isfinite(losses_mk)) or max(rel_mk) > TRAIN_LOSS_REL_TOL
                    or any(n != cfg.denoiser.num_layers for n in k8)):
                raise SystemExit(f"chip_smoke: the mask step at {wname} is wrong: {k8}")
            wc["linear_attention"] = sum(k8)
            d_w = widths.get("latent_dim", 128)
            q, k, v = (torch.from_numpy(rng.normal(size=(n_train, t_train, d_w)).astype(
                np.float32)).cuda().to(torch.bfloat16) for _ in range(3))
            key_mask = (torch.arange(t_train, device="cuda")[None] < REFERENCE_M_LENS).float()[
                ..., None].expand(n_train, t_train, 1)
            results += width_rows([check_attention_kernel(q, k, v, key_mask, widths["num_heads"])
                                   | {"name": "linear_attention"}], tag)
            del mask_k, mask_p, q, k, v
        width_counts[wname] = wc
        for k, n in wc.items():
            counts[f"{k}_{tag}"] = n
        print(f"[widths] {wname} {widths} (head width {dh}): launches {wc}; "
              f"{time.perf_counter() - t_w:.1f} s")
        torch.cuda.empty_cache()
    # (d) head width 64: K8 alone at the mask step's shape, then serving on
    # the plain bf16 layers (K8 8 times a step) against the plain float32 path
    q, k, v = (torch.from_numpy(rng.normal(size=(n_train, t_train, DH64["latent_dim"])).astype(
        np.float32)).cuda().to(torch.bfloat16) for _ in range(3))
    key_mask = (torch.arange(t_train, device="cuda")[None] < REFERENCE_M_LENS).float()[
        ..., None].expand(n_train, t_train, 1)
    results += width_rows([check_attention_kernel(q, k, v, key_mask, DH64["num_heads"])
                           | {"name": "linear_attention"}], "dh64")
    del q, k, v
    flax64 = width_trainer(DH64, layer_impl="flax", train_layer_impl="flax")
    plain64 = width_trainer(DH64, plain=True)
    reset_launch_counts()
    out64 = flax64.generate(mel, num_steps=50, noise=noise)
    torch.cuda.synchronize()
    k8_64 = launch_counts()["linear_attention"]
    ref64 = plain64.generate(mel, num_steps=50, noise=noise)
    err64, scale64 = float((out64 - ref64).abs().max()), float(ref64.abs().max())
    print(f"[widths] (d) serving on the bf16 plain layers at {DH64} (head width 64): ddim50 B=2 "
          f"max_abs_err vs plain float32 {err64:.6g} (plain max {scale64:.6g}); K8 launches "
          f"{k8_64}")
    if (not bool(torch.isfinite(out64).all()) or not err64 <= GENERATE_REL_TOL * scale64
            or k8_64 != cfg.denoiser.num_layers * 50):
        raise SystemExit("chip_smoke: serving on the plain layers at head width 64 is wrong")
    counts["linear_attention_dh64"] = k8_64
    del flax64, plain64
    print(f"[widths] launches by width: {width_counts}")
    return results, counts


def serving_phase(smi, cfg, plain_cfg, sd, mel, noise, rng):
    """Phase 17 (a)-(d): the rest of serving at the flagship width on phase
    4's mel and noise, B = 2, each on the kernels against the plain float32
    path on the same inputs (`GENERATE_REL_TOL` of its largest value):
    `FusedDenoiser.__call__` once against its glue over
    `decoder_stack_plain` in bf16 and int8; (a) guidance 2.5, ddim50, in
    bf16 ("auto" on ``cfg``) and bench.py's int8 config; (b) the ancestral
    ladder, 50 respaced steps, one explicit ``step_noise`` from ``rng``;
    (c) "epsilon" and "previous_x" with "fixed_large" under it; (d)
    ``efficient_attention=False`` in bf16 on the plain layers.  The int8
    mode under guidance is held to `GUIDED_INT8_REL_TOL` of the float32
    path and to `GENERATE_REL_TOL` of K1's plain version in the mode;
    "epsilon", whose ladder on weights not trained for it leaves unit scale
    (its values spread over orders of magnitude), element by element to
    `GENERATE_REL_TOL` of the element's value plus that of the path's median
    value.  Every trainer loads ``sd`` afresh (phase 6 trained phase 4's),
    the plain float32 path on ``plain_cfg``.  On the
    fused layers (a)-(c) must launch K1 alone through `__call__` (twice a
    step under guidance) and K2 / K3 never: the F9 gate.  Returns the
    launches of (a)-(d).  Raises SystemExit on any failed check."""
    from conductor_tpu_torch import DDPMTrainer
    from conductor_tpu_torch.kernel_checks import REL_TOL
    from conductor_tpu_torch.ops import launch_counts, part_launch_counts, reset_launch_counts
    from conductor_tpu_torch.ops.decoder_stack import decoder_stack_plain
    from conductor_tpu_torch.train import fused_denoiser

    t_phase = time.perf_counter()

    def trainer(base, **diffusion):
        tr = DDPMTrainer(base.replace(diffusion=dataclasses.replace(base.diffusion, **diffusion)),
                         device="cuda")
        tr.load_reference_state_dict(sd)
        return tr

    kernel_tr, plain_tr = trainer(cfg), trainer(plain_cfg)
    bench_tr = trainer(cfg.replace(denoiser=dataclasses.replace(cfg.denoiser, **BENCH_DENOISER)))

    # `__call__` once against the same glue over K1's plain version, on
    # the music and the null conditions
    t = torch.tensor([cfg.diffusion.steps - 1, 17], device="cuda")
    for label, tr in (("bf16", kernel_tr), ("int8", bench_tr)):
        model, fused = tr.model, tr.fused
        with torch.no_grad():
            music = model.cond_from_features(tr.fused_encoder(mel))
            for cond_name, xf in (("music", music), ("null", model.encode_null(*noise.shape[:2]))):
                cond = fused.prepare_cond(dict(model.precompute_cond(*xf),
                                               temb_table=tr.temb_table))
                reset_launch_counts()
                out = fused(noise, t, cond)
                torch.cuda.synchronize()
                called = {k: n for k, n in launch_counts().items() if n}
                saved = fused_denoiser.fused_decoder_stack
                fused_denoiser.fused_decoder_stack = decoder_stack_plain
                try:
                    ref = fused(noise, t, cond)
                finally:
                    fused_denoiser.fused_decoder_stack = saved
                err, scale = float((out - ref).abs().max()), float(ref.abs().max())
                name = "decoder_stack" if label == "bf16" else "decoder_stack_int8"
                print(f"[serve17] FusedDenoiser.__call__ {label}, {cond_name} condition, t "
                      f"{t.tolist()}: max_abs_err {err:.6g} against decoder_stack_plain's glue "
                      f"(max {scale:.6g}, bound {REL_TOL} of it); launches {called}")
                if called != {name: 1} or not err <= REL_TOL * scale:
                    raise SystemExit(f"chip_smoke: FusedDenoiser.__call__ ({label}, {cond_name}) "
                                     f"disagrees with its plain glue or launched {called}")

    step_noise = torch.from_numpy(rng.normal(size=(50, *noise.shape)).astype(np.float32)).cuda()
    f32_types = {}

    def plain_for(**diffusion):
        key = tuple(sorted(diffusion.items()))
        if key not in f32_types:
            f32_types[key] = trainer(plain_tr.cfg, **diffusion) if diffusion else plain_tr
        return f32_types[key]

    items = [  # (label, kernel trainer, plain trainer, generate kwargs, K1 mode, K1 calls)
        ("(a) guidance 2.5, ddim50, bf16", kernel_tr, plain_for(),
         dict(guidance_scale=SERVE_GUIDANCE), "decoder_stack", 100),
        ("(a) guidance 2.5, ddim50, bench.py's int8 config", bench_tr, plain_for(),
         dict(guidance_scale=SERVE_GUIDANCE), "decoder_stack_int8", 100),
        ("(b) ancestral, 50 steps, bf16", kernel_tr, plain_for(),
         dict(sampler="ancestral", step_noise=step_noise), "decoder_stack", 50),
    ]
    for mean_type in ("epsilon", "previous_x"):
        types = dict(mean_type=mean_type, var_type="fixed_large")
        items.append((f"(c) {mean_type} / fixed_large, ancestral, 50 steps, bf16",
                      trainer(cfg, **types), plain_for(**types),
                      dict(sampler="ancestral", step_noise=step_noise), "decoder_stack", 50))
    quad_tr = DDPMTrainer(cfg.replace(denoiser=dataclasses.replace(
        cfg.denoiser, efficient_attention=False, layer_impl="auto", train_layer_impl="auto")),
        device="cuda")
    qd = quad_tr.cfg.denoiser
    if (qd.layer_impl, qd.compute_dtype, qd.music_encoder_impl, quad_tr.model.efficient) != (
            "flax", "bfloat16", "pallas", False):
        raise SystemExit(f"chip_smoke: 'auto' with efficient_attention=False resolved to {qd}")
    quad_tr.load_reference_state_dict(sd)
    quad_plain = DDPMTrainer(plain_tr.cfg.replace(denoiser=dataclasses.replace(
        plain_tr.cfg.denoiser, efficient_attention=False)), device="cuda")
    quad_plain.load_reference_state_dict(sd)
    items.append(("(d) efficient_attention=False, ddim50, bf16 plain layers", quad_tr, quad_plain,
                  {}, None, 0))

    def plain_k1_ladder(tr, kwargs):
        """``tr``'s call with K1's plain version in its place (the mode's
        operands and glue alike): the int8 witness under guidance."""
        saved = fused_denoiser.fused_decoder_stack
        fused_denoiser.fused_decoder_stack = decoder_stack_plain
        try:
            return _timed(lambda: tr.generate(mel, num_steps=50, noise=noise, **kwargs))
        finally:
            fused_denoiser.fused_decoder_stack = saved

    counts = {}
    for label, tr, ref_tr, kwargs, k1, k1_calls in items:
        reset_launch_counts()
        out, ms = _timed(lambda: tr.generate(mel, num_steps=50, noise=noise, **kwargs))
        c = {k: n for k, n in (launch_counts() | part_launch_counts()).items() if n}
        out_ref, ms_ref = _timed(lambda: ref_tr.generate(mel, num_steps=50, noise=noise, **kwargs))
        _, ms = _timed(lambda: tr.generate(mel, num_steps=50, noise=noise, **kwargs))
        err, scale = float((out - out_ref).abs().max()), float(out_ref.abs().max())
        f32_tol = GENERATE_REL_TOL
        if k1 == "decoder_stack_int8" and "guidance_scale" in kwargs:
            f32_tol = GUIDED_INT8_REL_TOL
            out_w, ms_w = plain_k1_ladder(tr, kwargs)
            err_w = float((out - out_w).abs().max())
            print(f"[serve17] {label}: motion max_abs_err {err_w:.6g} against the same ladder on "
                  f"K1's plain version in the int8 mode ({ms_w * 1e3:.1f} ms; of the float32 "
                  f"path's max {scale:.6g}: {err_w / scale:.4%}, bound {GENERATE_REL_TOL})")
            if not err_w <= GENERATE_REL_TOL * scale:
                raise SystemExit(f"chip_smoke: {label} disagrees with K1's plain version")
        if label.startswith("(c) epsilon"):
            ref_abs = out_ref.abs()
            median = float(ref_abs.median())
            worst = float(((out - out_ref).abs()
                           / (GENERATE_REL_TOL * (ref_abs + median))).max())
            within = worst <= 1.0
            print(f"[serve17] {label}: motion |err| against the plain float32 path's, element by "
                  f"element, at most {worst:.4f} of the bound {GENERATE_REL_TOL} x (|value| + the "
                  f"median {median:.6g}); max_abs_err {err:.6g} (max {scale:.6g}); launches {c}")
        else:
            within = err <= f32_tol * scale
            print(f"[serve17] {label}: motion max_abs_err {err:.6g} against the plain float32 "
                  f"path's (max {scale:.6g}: {err / scale:.4%}, bound {f32_tol:.4g} of it); "
                  f"launches {c}")
        print(f"[time] {label}, B=2: {ms * 1e3:.1f} ms, plain float32 path {ms_ref * 1e3:.1f} ms "
              f"on {smi}")
        gemm = "adaln_modulation_int8" if k1 == "decoder_stack_int8" else "adaln_modulation"
        want = {"conv_block": 7} | ({k1: k1_calls, "adaln_modulation": k1_calls} if k1 else {})
        if (tuple(out.shape) != (2, 1800, 26) or not bool(torch.isfinite(out).all())
                or not within):
            raise SystemExit(f"chip_smoke: {label} on the kernels disagrees with the plain path")
        if c != want:
            raise SystemExit(f"chip_smoke: {label} did not launch K1 alone through __call__ (and "
                             f"K4 7 times), K2 / K3 never: {c}")
        for k, n in c.items():
            counts[gemm if k == "adaln_modulation" else k] = counts.get(
                gemm if k == "adaln_modulation" else k, 0) + n
    print(f"[serve17] (a)-(d) launches {counts}; phase 17 (a)-(d) took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return counts


def serving_cli_phase(smi: str, run_dir: str, work: str) -> dict[str, int]:
    """Phase 17 (e), run inside phase 12 on its default run (bf16, the
    kernels, the run's config and newest checkpoint): `cli.test_unseen`
    and `cli.visualize --max_seconds 0 --steps 50 --save_npy`, in process,
    on a synthetic 150-s 22.05-kHz WAV written with `wave`.  Each CLI: 3
    windows (60 + 60 + 30 s), K4 21 launches and K1 / K2 / K3 150 each and
    no other; the motion (4501, 13, 2), finite, the two CLIs' equal, and
    within `GENERATE_REL_TOL` of the plain float32 path's `generate_long`
    over the same checkpoint and seed.  `render_motion_video` is replaced
    by a recorder of the motion it is handed: no video is rendered (the
    CPU test of the CLIs covers the rendering call).  Returns the launches of the two CLIs.  Raises SystemExit on any failed
    check."""
    import os
    import wave

    from conductor_tpu_torch import DDPMTrainer
    from conductor_tpu_torch.cli import test_unseen, visualize
    from conductor_tpu_torch.config import Config, pin_faithful
    from conductor_tpu_torch.data.mel import extract_mel_feature
    from conductor_tpu_torch.ops import launch_counts, reset_launch_counts
    from conductor_tpu_torch.prospective.unseen import generate_long
    from conductor_tpu_torch.train.checkpoints import CheckpointManager
    from conductor_tpu_torch.viz import motion as viz

    music_dir = os.path.join(work, "music")
    os.makedirs(music_dir)
    wav = os.path.join(music_dir, "track.wav")
    sr, seconds = 22050, SERVE_CLI_SECONDS
    tt = np.arange(sr * seconds) / sr
    y = 0.4 * np.sin(2 * np.pi * 220 * tt) * (1 + np.sin(2 * np.pi * 2 * tt)) / 2
    y += 0.05 * np.random.RandomState(17).normal(size=tt.shape)
    with wave.open(wav, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(y, -1, 1) * 32767).astype(np.int16).tobytes())

    seen = []
    render = viz.render_motion_video

    def recorder(motions, save_path, name="motion", **kw):
        """Keeps the motion in place of rendering it."""
        seen.append(np.asarray(motions[0]))
        return os.path.join(save_path, f"{name}.avi")

    viz.render_motion_video = recorder
    runs = {}
    try:
        for name, cli, argv in (
                ("test_unseen", test_unseen.main,
                 ["--music_dir", music_dir, "--out_dir", os.path.join(work, "unseen")]),
                ("visualize", visualize.main,
                 ["--music", wav, "--max_seconds", "0", "--save_npy", "--out_dir",
                  os.path.join(work, "viz")])):
            reset_launch_counts()
            t0 = time.perf_counter()
            cli(["--run_dir", run_dir, "--steps", "50", *argv])
            torch.cuda.synchronize()
            runs[name] = ({k: n for k, n in launch_counts().items() if n},
                          time.perf_counter() - t0)
    finally:
        viz.render_motion_video = render
    saved = np.load(os.path.join(work, "viz", "track.npy"))

    # the plain float32 path: the same checkpoint, windows and seed
    plain = DDPMTrainer(pin_faithful(Config.load(os.path.join(run_dir, "config.json"))),
                        device="cuda")
    plain.load_state_dict(CheckpointManager(os.path.join(run_dir, "ckpt")).restore())
    t0 = time.perf_counter()
    ref = generate_long(visualize.window_generator(plain, 0, num_steps=50),
                        extract_mel_feature(wav))
    plain_s = time.perf_counter() - t0
    err, scale = float(np.abs(seen[1] - ref).max()), float(np.abs(ref).max())
    same = float(np.abs(seen[0] - seen[1]).max())
    want = {"conv_block": 21, "decoder_stack": 150, "sampler_prologue": 150,
            "sampler_epilogue": 150}
    for name, (c, wall) in runs.items():
        print(f"[serve17] (e) cli.{name} --steps 50 on phase 12's default run, a {seconds}-s "
              f"22.05-kHz WAV: launches {c}, wall {wall:.2f} s (mel included) on {smi}")
    print(f"[serve17] (e) motion {[m.shape for m in seen]}, the CLIs' largest difference "
          f"{same:.6g}; visualize's against the plain float32 path's generate_long (same "
          f"checkpoint, windows and seed; {plain_s:.2f} s) max_abs_err {err:.6g} (max {scale:.6g}, "
          f"bound {GENERATE_REL_TOL} of it); --save_npy equal to the recorded motion: "
          f"{np.array_equal(saved, seen[1])}")
    print("[serve17] (e) no video rendered: the motion is recorded in place of "
          "render_motion_video")
    if (len(seen) != 2 or any(m.shape != (4501, 13, 2) or not np.isfinite(m).all() for m in seen)
            or not np.array_equal(saved, seen[1]) or not err <= GENERATE_REL_TOL * scale
            or not same <= GENERATE_REL_TOL * scale):
        raise SystemExit("chip_smoke: the serving CLIs went wrong on the card")
    if any(c != want for c, _ in runs.values()):
        raise SystemExit(f"chip_smoke: the serving CLIs did not launch K4 21 and K1 / K2 / K3 "
                         f"150 times each: {runs}")
    return {k: sum(c.get(k, 0) for c, _ in runs.values()) for k in want}


def eval_phase(smi: str, cfg, sd, feat_sd, mel_train, motion_train, drawn, bare_step_s: float,
               run_dir: str, root: str, m2snet_ckpt: str) -> dict[str, int]:
    """Phase 18 (the `[eval18]` lines), after phase 14: (a) 4 stage-2 steps
    with denoiser dropout (`DROPOUT`) on phase 6's batch and random numbers
    at "auto" on CUDA (bf16 plain layers, K8 in the self-attention, K7 in
    the perceptual term, no K5 / K6), fixed keep masks drawn once from one
    `torch.Generator`, against the plain float32 path on the same weights
    (phase 4's ``sd``), masks and numbers: each loss within
    `TRAIN_LOSS_REL_TOL`, K8 once a layer and K7 as phase 6 each step, ms a
    step beside phase 6's ``bare_step_s``; then, on phase 12's default run
    (``run_dir``) and a test split of `EVAL_CLIPS` synthetic 60-s clips
    written into its ``root`` (two waves of 8): (b) `cli.evaluate` in
    bench.py's config at the full 1000-step ladder (K4 7 and K2 / K1 / K3
    and K1's int8 GEMM 1000 a wave), in the bf16 config at ``--steps 50``
    (K4 7, K2 / K1 / K3 50 a wave) and on the exact path (``--layer_impl
    flax --compute_dtype float32``, ``--steps 50``: none of K1-K3), each
    report finite with its wall seconds by part; (c) `cli.evaluate_protocol`
    with phase 13's checkpoint (``m2snet_ckpt``), ``--steps 50
    --replications 2 --mm_samples 2`` (K2 / K1 / K3 50 and K4 7 a generate
    call, 4 calls a replication); (d) `ProspectiveEvaluator` over the
    split's batches of 8, bench.py's config generating at ddim50; (e)
    `cli.serving_delta_ci` over `DELTA_SEEDS` seeds of one 16-clip wave at
    ddim50.  Returns the phase's launches by kernels-line row.  Raises
    SystemExit on any failed check."""
    import os

    from conductor_tpu_torch import DDPMTrainer
    from conductor_tpu_torch.cli import evaluate, evaluate_protocol, serving_delta_ci
    from conductor_tpu_torch.cli.visualize import load_run
    from conductor_tpu_torch.config import DenoiserConfig, TrainConfig
    from conductor_tpu_torch.data.dataset import (
        BatchIterator,
        ConductorMotionDataset,
        make_synthetic_dataset,
    )
    from conductor_tpu_torch.eval import DiffusionEvaluator
    from conductor_tpu_torch.ops import launch_counts, part_launch_counts, reset_launch_counts
    from conductor_tpu_torch.prospective import ProspectiveEvaluator

    t_phase = time.perf_counter()
    counts: dict[str, int] = {}

    def launched() -> dict[str, int]:
        return {k: n for k, n in (launch_counts() | part_launch_counts()).items() if n}

    def add(c: dict[str, int], gemm: str = "adaln_modulation") -> None:
        """Adds launches under the kernels line's rows: K1's GEMM under
        ``gemm`` (its int8 mode's row when K1 ran in that mode)."""
        for k, n in c.items():
            key = gemm if k == "adaln_modulation" else k
            counts[key] = counts.get(key, 0) + n

    # (a) dropout: "auto" against the plain float32 path, the same masks
    drop_cfg = cfg.replace(denoiser=dataclasses.replace(cfg.denoiser, dropout=DROPOUT))
    kernel = DDPMTrainer(drop_cfg, device="cuda")
    kd = kernel.cfg.denoiser
    if (kd.compute_dtype, kd.train_layer_impl, kd.attention_impl, kernel.cfg.train.feat_impl) != (
            "bfloat16", "flax", "pallas", "pallas"):
        raise SystemExit(f"chip_smoke: 'auto' with dropout resolved to {kd}")
    plain = DDPMTrainer(drop_cfg.replace(
        denoiser=DenoiserConfig(dropout=DROPOUT, layer_impl="flax", music_encoder_impl="flax",
                                train_layer_impl="flax", attention_impl="xla",
                                compute_dtype="float32"),
        train=TrainConfig(feat_impl="flax")), device="cuda")
    for tr in (kernel, plain):
        tr.load_reference_state_dict(sd, motion_encoder=feat_sd)
    n, t = motion_train.shape[0], motion_train.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(18)
    masks = [{site: torch.rand((n, t, kd.ff_size if site.endswith("ffn.dropout")
                                else kd.latent_dim), generator=gen, device="cuda") >= DROPOUT
              for site in kernel.model.dropout_sites()} for _ in drawn]
    kept = float(torch.stack([m.float().mean() for m in masks[0].values()]).mean())

    def steps(tr):
        losses, times, step_counts = [], [], []
        for d, keep in zip(drawn, masks):
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.train_step(mel_train, motion_train, **d, dropout_keep=keep)
            losses.append(float(m["loss"]))  # host readback ends the step
            times.append(time.perf_counter() - t0)
            step_counts.append(launched())
        return losses, times, step_counts

    losses_k, times_k, counts_k = steps(kernel)
    losses_p, times_p, _ = steps(plain)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p)]
    want = {"linear_attention": kd.num_layers, "stgcn_forward": K7_PER_STEP[0],
            "stgcn_backward": K7_PER_STEP[1]}
    print(f"[eval18] (a) dropout {DROPOUT} ({len(masks[0])} sites a step, {kept:.4f} kept), "
          f"B={n} T={t}, 'auto' (bf16 plain layers, K8, K7) against the plain float32 path on "
          f"the same masks and numbers: losses {losses_k} against {losses_p}, rel diff "
          f"{[f'{x:.3g}' for x in rel]} (each <= {TRAIN_LOSS_REL_TOL}); launches per step "
          f"{counts_k}")
    print(f"[time] (a) dropout step B={n} T={t}, median ms: 'auto' {np.median(times_k) * 1e3:.1f}, "
          f"plain float32 {np.median(times_p) * 1e3:.1f}, phase 6's kernel step without dropout "
          f"{bare_step_s * 1e3:.1f} (per step {[round(x * 1e3, 1) for x in times_k]}) on {smi}")
    if not all(np.isfinite(losses_k)) or not max(rel) <= TRAIN_LOSS_REL_TOL:
        raise SystemExit("chip_smoke: the dropout step disagrees with the plain float32 path")
    if any(c != want for c in counts_k):
        raise SystemExit(f"chip_smoke: the dropout step did not launch K8 once a layer and K7 as "
                         f"phase 6, and no K5 / K6: {counts_k}")
    for c in counts_k:
        add(c)
    del kernel, plain, masks
    torch.cuda.empty_cache()

    # (b) cli.evaluate in three configurations on a 16-clip test split
    make_synthetic_dataset(root, "test", num_clips=EVAL_CLIPS, seed=18, correlated=True)
    waves = -(-EVAL_CLIPS // EVAL_WAVE)
    seconds: list[dict[str, float]] = []
    evaluate_fn = DiffusionEvaluator.evaluate

    def recording(self, *args, **kwargs):
        """`DiffusionEvaluator.evaluate`, its seconds by part kept."""
        out = evaluate_fn(self, *args, **kwargs)
        seconds.append(dict(self.seconds))
        return out

    ladder = {"decoder_stack": 0, "sampler_prologue": 0, "sampler_epilogue": 0}
    configs = (
        ("bench.py's config, ddim1000", ["--layer_impl", "pallas_fused", "--adaln_int8"],
         {"conv_block": 7 * waves, "decoder_stack_int8": 1000 * waves,
          "sampler_prologue_int8": 1000 * waves, "sampler_epilogue": 1000 * waves,
          "adaln_modulation": 1000 * waves}, "adaln_modulation_int8"),
        ("bf16 fused, ddim50", ["--layer_impl", "pallas_fused", "--compute_dtype", "bfloat16",
                                "--steps", "50"],
         {"conv_block": 7 * waves, "decoder_stack": 50 * waves, "sampler_prologue": 50 * waves,
          "sampler_epilogue": 50 * waves, "adaln_modulation": 50 * waves}, "adaln_modulation"),
        ("exact (plain layers, float32), ddim50",
         ["--layer_impl", "flax", "--compute_dtype", "float32", "--steps", "50"], None,
         "adaln_modulation"),
    )
    DiffusionEvaluator.evaluate = recording
    try:
        for label, argv, want_c, gemm in configs:
            reset_launch_counts()
            t0 = time.perf_counter()
            report = evaluate.main(["--run_dir", run_dir, "--data_root", root, "--out_suffix",
                                    f"_{len(seconds)}", *argv])
            torch.cuda.synchronize()
            wall, c = time.perf_counter() - t0, launched()
            part = ", ".join(f"{k} {v:.2f}" for k, v in seconds[-1].items())
            print(f"[eval18] (b) cli.evaluate, {label}, {EVAL_CLIPS} clips in waves of "
                  f"{EVAL_WAVE}: {report}; wall {wall:.2f} s ({part} s); launches {c} on {smi}")
            if not all(np.isfinite(v) for v in report.values()):
                raise SystemExit(f"chip_smoke: cli.evaluate ({label}) gave non-finite metrics")
            if want_c is not None and c != want_c:
                raise SystemExit(f"chip_smoke: cli.evaluate ({label}) launched {c}, not {want_c}")
            if want_c is None and any(k.startswith(tuple(ladder)) for k in c):
                raise SystemExit(f"chip_smoke: the exact path launched K1-K3: {c}")
            add(c, gemm)
    finally:
        DiffusionEvaluator.evaluate = evaluate_fn

    # (c) the retrieval protocol over phase 13's M2SNet
    reset_launch_counts()
    t0 = time.perf_counter()
    report = evaluate_protocol.main(["--run_dir", run_dir, "--data_root", root, "--m2snet_ckpt",
                                     m2snet_ckpt, "--steps", "50", "--replications", "2",
                                     "--mm_samples", "2"])
    torch.cuda.synchronize()
    wall, c = time.perf_counter() - t0, launched()
    # each of the 2 replications: 2 batches of 8 and 2 MultiModality calls
    calls = 2 * (EVAL_CLIPS // 8 + 2)
    want_c = {"conv_block": 7 * calls, "decoder_stack": 50 * calls, "sampler_prologue": 50 * calls,
              "sampler_epilogue": 50 * calls, "adaln_modulation": 50 * calls}
    print(f"[eval18] (c) cli.evaluate_protocol --steps 50 --replications 2 --mm_samples 2: "
          f"{json.dumps(report)}; wall {wall:.2f} s; launches {c} on {smi}")
    if set(report) != {"MatchingScore", "R_precision", "FID", "Diversity", "MultiModality"} or (
            not np.isfinite(report["FID"]["conductor_tpu"]["mean"])):
        raise SystemExit("chip_smoke: cli.evaluate_protocol's report is incomplete")
    if c != want_c:
        raise SystemExit(f"chip_smoke: cli.evaluate_protocol launched {c}, not {want_c}")
    add(c)

    # (d) the Prospective Cup scorer, bench.py's config generating
    bench = load_run(run_dir, None, "cuda", evaluate.run_config(run_dir, "cuda", "pallas_fused",
                                                                adaln_int8=True))
    batches = [(mel, motion) for mel, motion, _ in BatchIterator(
        ConductorMotionDataset(root, "test", 60, "sequential"), 8, shuffle=False)]

    def generate_fn(mel):
        gen = torch.Generator(device="cuda").manual_seed(0)
        return bench.generate(mel, num_steps=50, generator=gen).cpu().numpy()

    reset_launch_counts()
    t0 = time.perf_counter()
    pros = ProspectiveEvaluator(generate_fn).evaluate(batches).as_dict()
    wall, c = time.perf_counter() - t0, launched()
    print(f"[eval18] (d) ProspectiveEvaluator over {len(batches)} batches of 8, bench.py's config "
          f"at ddim50: {pros}; wall {wall:.2f} s; launches {c} on {smi}")
    if not all(np.isfinite(v) for v in pros.values()) or c.get("decoder_stack_int8") != 50 * len(
            batches):
        raise SystemExit(f"chip_smoke: the Prospective scorer went wrong: {pros} {c}")
    add(c, "adaln_modulation_int8")
    del bench

    # (e) the serving-vs-exact sweep: its deltas check the pipeline only
    reset_launch_counts()
    t0 = time.perf_counter()
    quality = serving_delta_ci.sweep(run_dir, root, clips=EVAL_CLIPS, seeds=DELTA_SEEDS, steps=50)
    wall, c = time.perf_counter() - t0, launched()
    print(f"[eval18] (e) cli.serving_delta_ci, {DELTA_SEEDS} seeds x {EVAL_CLIPS} clips, ddim50 "
          f"(exact: plain float32 layers; serving: bench.py's config): {json.dumps(quality)}; "
          f"wall {wall:.2f} s; launches {c} on {smi}")
    print("[eval18] (e) the weights are phase 12's 6-step run on synthetic data: the deltas "
          "check the pipeline and say nothing of the serving path's quality")
    if any(not np.isfinite(quality[k]["mean_pct"]) for k in serving_delta_ci.METRICS) or (
            c.get("decoder_stack_int8") != 50 * DELTA_SEEDS or c.get("decoder_stack")):
        raise SystemExit(f"chip_smoke: the serving-delta sweep went wrong: {quality} {c}")
    add(c, "adaln_modulation_int8")
    print(f"[eval18] launches {counts}; phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return counts


def dp_worker(tmp: str) -> int:
    """One rank of phase 19 (a) and (c) (``python chip_smoke.py
    --dp19-worker DIR`` with torchrun's environment): joins the group over
    gloo on the card, runs 4 stage-2 steps of each configuration in
    ``DIR/in.pt`` on its rows of the global batch, then the sharded
    evaluator on phase 12's run in bench.py's config at ddim50, and writes
    ``DIR/out<rank>.pt``: each step's loss, ``grad_norm``, seconds and
    launches, the evaluation's motion (rank 0), seconds and launches."""
    import os

    from conductor_tpu_torch import DDPMTrainer
    from conductor_tpu_torch.cli.evaluate import run_config
    from conductor_tpu_torch.cli.visualize import load_run
    from conductor_tpu_torch.eval import DiffusionEvaluator
    from conductor_tpu_torch.ops import launch_counts, part_launch_counts, reset_launch_counts
    from conductor_tpu_torch.parallel import init_from_env, shutdown

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh, dev = init_from_env("gloo", "cuda")
    inp = torch.load(os.path.join(tmp, "in.pt"), weights_only=False)
    out: dict = {"steps": {}}
    mel, motion = mesh.local(inp["mel"]), mesh.local(inp["motion"])
    for name, cfg in inp["configs"].items():
        tr = DDPMTrainer(cfg, device=dev, mesh=mesh)
        tr.load_reference_state_dict(inp["sd"], motion_encoder=inp["feat_sd"])
        m_lens = mesh.local(inp["m_lens"]) if cfg.train.replicate_reference_mask else None
        rec: dict[str, list] = {"loss": [], "grad_norm": [], "s": [], "launches": []}
        for d in inp["drawn"]:
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.train_step(mel, motion, m_lens, **d)
            rec["loss"].append(float(m["loss"]))  # host readback ends the step
            rec["s"].append(time.perf_counter() - t0)
            rec["grad_norm"].append(float(m["grad_norm"]))
            rec["launches"].append({k: n for k, n in launch_counts().items() if n})
        out["steps"][name] = rec
        del tr
        torch.cuda.empty_cache()
    run_dir, root = inp["run_dir"], inp["root"]
    bench = load_run(run_dir, None, dev, run_config(run_dir, dev, "pallas_fused",
                                                    adaln_int8=True))
    ev = DiffusionEvaluator(bench, mesh=mesh)  # 8 clips a rank, JAX's default
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev.evaluate(root, num_steps=50, compute_beats=False)
    torch.cuda.synchronize()
    out["eval"] = {"s": time.perf_counter() - t0, "wave": ev.batch_size,
                   "generated": getattr(ev, "generated", None),
                   "launches": {k: n for k, n in (launch_counts() | part_launch_counts()).items()
                                if n}}
    torch.save(out, os.path.join(tmp, f"out{mesh.rank}.pt"))
    shutdown(mesh)
    return 0


def dp_wave_worker(tmp: str) -> int:
    """One rank of phase 19 (c)'s 4-rank wave shape (``python chip_smoke.py
    --dp19-wave-worker DIR`` with torchrun's environment): joins the group
    over gloo on the card and runs the sharded evaluator on phase 12's run
    in bench.py's config at ddim50 in waves of ``EVAL_WAVE`` clips (2 a
    rank on 4 ranks); writes ``DIR/wave<rank>.pt``: the motion (rank 0),
    the seconds and the launches."""
    import os

    from conductor_tpu_torch.cli.evaluate import run_config
    from conductor_tpu_torch.cli.visualize import load_run
    from conductor_tpu_torch.eval import DiffusionEvaluator
    from conductor_tpu_torch.ops import launch_counts, part_launch_counts, reset_launch_counts
    from conductor_tpu_torch.parallel import init_from_env, shutdown

    mesh, dev = init_from_env("gloo", "cuda")
    inp = torch.load(os.path.join(tmp, "wave_in.pt"), weights_only=False)
    bench = load_run(inp["run_dir"], None, dev, run_config(inp["run_dir"], dev, "pallas_fused",
                                                           adaln_int8=True))
    ev = DiffusionEvaluator(bench, batch_size=EVAL_WAVE, mesh=mesh)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev.evaluate(inp["root"], num_steps=50, compute_beats=False)
    torch.cuda.synchronize()
    torch.save({"s": time.perf_counter() - t0, "wave": ev.batch_size,
                "generated": getattr(ev, "generated", None),
                "launches": {k: n for k, n in (launch_counts() | part_launch_counts()).items()
                             if n}}, os.path.join(tmp, f"wave{mesh.rank}.pt"))
    shutdown(mesh)
    return 0


def dp_phase(smi: str, cfg, plain_cfg, sd, feat_sd, mel_train, motion_train, drawn,
             bare_step_s: float, run_dir: str, root: str) -> dict[str, int]:
    """Phase 19 (the `[dp19]` lines), after phase 18: data parallelism.
    (a) `DP_WORLD` ranks share the card over gloo (`dp_worker`), each
    running 4 stage-2 steps on its 16 rows of phase 6's global batch of 32
    (T = 900) with phase 6's weights and random numbers: "auto" (K5 / K6 /
    K7), the reference mask (bf16 plain layers, K8, K7; `DP_M_LENS`, so
    the ranks' mask counts differ) and the plain float32 path, each against
    the 1-process steps on the global batch: every loss and ``grad_norm``
    within `DP_REL_TOL` (float32 `DP_F32_REL_TOL`); (b) `cli.train` under
    torchrun on phase 12's root: ``--nproc_per_node 1`` over NCCL (its 2
    steps against phase 12's default run's first 2), then 2 ranks over
    gloo, a SIGTERM to rank 1 (both stop at one step, rank 0 saves, rc 0)
    and ``--continue``; (c) `cli.evaluate` under torchrun on 2 ranks (gloo)
    on phase 12's run, bench.py's config at ddim50, waves of 16 (8 a rank),
    against the 1-process CLI on the same waves, and the ranks' motion
    (from (a)'s workers) against the 1-process evaluator's, bit for bit or
    the gap printed; (d) `scripts/run_e2e_demo_torch.py` at `DEMO_ARGS`,
    every stage's seconds, then `scripts/run_1000ladder_torch.py` at ddim50.
    Returns the launches by kernels-line row; raises SystemExit on any
    failed check."""
    import itertools
    import os
    import shutil
    import signal
    import tempfile
    import threading

    from conductor_tpu_torch import DDPMTrainer
    from conductor_tpu_torch.cli import evaluate
    from conductor_tpu_torch.cli.visualize import load_run
    from conductor_tpu_torch.eval import DiffusionEvaluator
    from conductor_tpu_torch.ops import launch_counts, part_launch_counts, reset_launch_counts
    from conductor_tpu_torch.parallel.mesh import free_port
    from conductor_tpu_torch.train.checkpoints import CheckpointManager

    t_phase = time.perf_counter()
    counts: dict[str, int] = {}
    here = os.path.dirname(os.path.abspath(__file__))
    env0 = dict(os.environ, PYTHONUNBUFFERED="1",
                PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        env0.pop(k, None)

    def add(c: dict[str, int]) -> None:
        for k, n in c.items():
            counts[k] = counts.get(k, 0) + n

    def wait(procs, what: str, timeout: float = DP_TIMEOUT) -> list[str]:
        """Each process's output (a pipe, or the file ``p.log``); kills
        them all and raises if one fails or outlasts ``timeout``."""
        outs = []
        deadline = time.time() + timeout
        try:
            for p in procs:
                out = p.communicate(timeout=max(1.0, deadline - time.time()))[0]
                if getattr(p, "log", None):
                    with open(p.log) as f:
                        out = f.read()
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        if any(p.returncode for p in procs):
            raise SystemExit(f"chip_smoke: {what} failed (rc {[p.returncode for p in procs]}):\n"
                             + "\n".join(o[-3000:] for o in outs))
        return outs

    work = tempfile.mkdtemp(prefix="chip_smoke_dp19_")
    try:
        # (a) the 1-process steps on the global batch, then the ranks
        mask_cfg = cfg.replace(train=dataclasses.replace(cfg.train, replicate_reference_mask=True))
        configs = {"auto": cfg, "mask": mask_cfg, "plain_f32": plain_cfg}
        m_lens = torch.from_numpy(DP_M_LENS)
        one: dict[str, dict] = {}
        for name, c in configs.items():
            tr = DDPMTrainer(c, device="cuda")
            tr.load_reference_state_dict(sd, motion_encoder=feat_sd)
            rec: dict[str, list] = {"loss": [], "grad_norm": [], "s": []}
            for d in drawn:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = tr.train_step(mel_train, motion_train,
                                  m_lens if c.train.replicate_reference_mask else None, **d)
                rec["loss"].append(float(m["loss"]))
                rec["s"].append(time.perf_counter() - t0)
                rec["grad_norm"].append(float(m["grad_norm"]))
            one[name] = rec
            del tr
            torch.cuda.empty_cache()
        torch.save({"configs": configs, "sd": sd, "feat_sd": feat_sd, "mel": mel_train.cpu(),
                    "motion": motion_train.cpu(), "drawn": drawn, "m_lens": m_lens,
                    "run_dir": run_dir, "root": root}, os.path.join(work, "in.pt"))
        port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp19-worker", work],
            env=dict(env0, RANK=str(r), WORLD_SIZE=str(DP_WORLD), LOCAL_RANK=str(r),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(DP_WORLD)]
        wait(procs, "phase 19 (a)'s ranks")
        ranks = [torch.load(os.path.join(work, f"out{r}.pt"), weights_only=False)
                 for r in range(DP_WORLD)]
        print(f"[dp19] (a) {DP_WORLD} ranks over gloo on one card: {time.perf_counter() - t0:.1f} "
              f"s for the ranks' processes (start-up, 3 x 4 steps, (c)'s evaluation) on {smi}")
        want = {"auto": {"decoder_layer": cfg.denoiser.num_layers,
                         "decoder_layer_bwd": cfg.denoiser.num_layers,
                         "stgcn_forward": K7_PER_STEP[0], "stgcn_backward": K7_PER_STEP[1]},
                "mask": {"linear_attention": cfg.denoiser.num_layers,
                         "stgcn_forward": K7_PER_STEP[0], "stgcn_backward": K7_PER_STEP[1]},
                "plain_f32": {}}
        bad = []
        for name in configs:
            tol = DP_F32_REL_TOL if name == "plain_f32" else DP_REL_TOL
            gaps = {}
            for key in ("loss", "grad_norm"):
                gaps[key] = max(abs(a - b) / abs(b) for r in ranks
                                for a, b in zip(r["steps"][name][key], one[name][key]))
                if not (np.isfinite(gaps[key]) and gaps[key] <= tol):
                    bad.append((name, key, gaps[key]))
            launches = [r["steps"][name]["launches"] for r in ranks]
            if any(c != want[name] for per_rank in launches for c in per_rank):
                bad.append((name, "launches", launches))
            for per_rank in launches:
                for c in per_rank:
                    add(c)
            ms = [round(float(np.median(r["steps"][name]["s"])) * 1e3, 1) for r in ranks]
            print(f"[dp19] (a) {name}: B=32 global ({32 // DP_WORLD} a rank), T=900, 4 steps: "
                  f"losses {ranks[0]['steps'][name]['loss']} against the 1-process steps' "
                  f"{one[name]['loss']}; largest rel gap loss {gaps['loss']:.3g}, grad_norm "
                  f"{gaps['grad_norm']:.3g} (bound {tol:g}); launches per step, each rank "
                  f"{[r['steps'][name]['launches'][0] for r in ranks]}")
            print(f"[time] (a) {name} data-parallel step, median ms a rank {ms} (two ranks "
                  f"sharing the card, gradients summed over gloo through the host), 1-process "
                  f"step on the global batch {np.median(one[name]['s']) * 1e3:.1f}; phase 6's "
                  f"kernel step {bare_step_s * 1e3:.1f} on {smi}")
        if bad:
            raise SystemExit(f"chip_smoke: the data-parallel steps disagree with the 1-process "
                             f"steps or launched other kernels: {bad}")

        # (c) the ranks' motion against the 1-process evaluator's, same waves
        bench_cfg = evaluate.run_config(run_dir, "cuda", "pallas_fused", adaln_int8=True)
        bench = load_run(run_dir, None, "cuda", bench_cfg)
        ev = DiffusionEvaluator(bench, batch_size=ranks[0]["eval"]["wave"])
        t0 = time.perf_counter()
        ev.evaluate(root, num_steps=50, compute_beats=False)
        one_s = time.perf_counter() - t0
        got, ref = ranks[0]["eval"]["generated"], ev.generated
        gap = float(np.abs(got - ref).max())
        print(f"[dp19] (c) the sharded evaluator (bench.py's config, ddim50, waves of "
              f"{ranks[0]['eval']['wave']}, 8 a rank) against the 1-process evaluator on the same "
              f"waves and x_T: motion {got.shape}, bit-equal {bool(np.array_equal(got, ref))}, "
              f"largest gap {gap:.6g} (max {float(np.abs(ref).max()):.6g}); launches each rank "
              f"{[r['eval']['launches'] for r in ranks]}; seconds {[round(r['eval']['s'], 2) for r in ranks]} "
              f"against {one_s:.2f} on one process, on {smi}")
        if got.shape != ref.shape or not gap <= GENERATE_REL_TOL * float(np.abs(ref).max()):
            raise SystemExit("chip_smoke: the sharded evaluator's motion disagrees with the "
                             "1-process evaluator's")
        if not np.array_equal(got, ref):
            print("[dp19] (c) not bit-equal: each rank generates 8 rows where one process "
                  "generates 16, and a kernel's tiling over the batch changes its summation "
                  "order; the gap is within the ladder's drift bound")
        for r in ranks:
            for k, n in r["eval"]["launches"].items():
                add({"adaln_modulation_int8" if k == "adaln_modulation" else k: n})
            if r["eval"]["launches"].get("decoder_stack_int8", 0) == 0:
                raise SystemExit("chip_smoke: a rank's sharded evaluation launched no K1")

        # (c) the 4-rank wave shape: 4 ranks of 2 clips against one process
        # of 8 on the same waves and x_T
        torch.save({"run_dir": run_dir, "root": root}, os.path.join(work, "wave_in.pt"))
        port = free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--dp19-wave-worker", work],
            env=dict(env0, RANK=str(r), WORLD_SIZE=str(DP_WAVE_WORLD), LOCAL_RANK=str(r),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(DP_WAVE_WORLD)]
        wait(procs, "phase 19 (c)'s 4 ranks")
        t_ranks = time.perf_counter() - t0
        waves = [torch.load(os.path.join(work, f"wave{r}.pt"), weights_only=False)
                 for r in range(DP_WAVE_WORLD)]
        ev8 = DiffusionEvaluator(bench, batch_size=EVAL_WAVE)
        t0 = time.perf_counter()
        ev8.evaluate(root, num_steps=50, compute_beats=False)
        one8_s = time.perf_counter() - t0
        got, ref = waves[0]["generated"], ev8.generated
        gap = float(np.abs(got - ref).max()) if got.shape == ref.shape else float("inf")
        print(f"[dp19] (c) {DP_WAVE_WORLD} ranks over gloo on one card, waves of "
              f"{waves[0]['wave']} ({EVAL_WAVE // DP_WAVE_WORLD} clips a rank), against one "
              f"process of {ev8.batch_size} on the same waves and x_T (bench.py's config, "
              f"ddim50): motion {got.shape}, bit-equal {bool(np.array_equal(got, ref))}, largest "
              f"gap {gap:.6g}; launches each rank {[w['launches'] for w in waves]}; seconds "
              f"{[round(w['s'], 2) for w in waves]} ({t_ranks:.1f} s with the ranks' start-up) "
              f"against {one8_s:.2f} in one process, on {smi}")
        if waves[0]["wave"] != EVAL_WAVE or not np.array_equal(got, ref):
            # where it breaks: each clip's gap, and the music encoder (where a
            # batch-dependent GEMM hid before) on a wave at once and 2 at a time
            clips = (np.abs(got - ref).reshape(len(got), -1).max(1).tolist()
                     if got.shape == ref.shape else None)
            mel8 = torch.from_numpy(np.random.RandomState(19).uniform(
                -1, 1, (EVAL_WAVE, 5400, 128)).astype(np.float32)).cuda()
            with torch.no_grad():
                f8 = bench.fused_encoder(mel8)
                f2 = torch.cat([bench.fused_encoder(mel8[i:i + 2])
                                for i in range(0, EVAL_WAVE, 2)])
            raise SystemExit(f"chip_smoke: the 4-rank wave's motion is not the 1-process "
                             f"wave's bit for bit (each clip's largest gap {clips}; the music "
                             f"encoder at {EVAL_WAVE} clips against 2 at a time: bit-equal "
                             f"{bool(torch.equal(f8, f2))}, gap "
                             f"{float((f8 - f2).abs().max()):.6g})")
        for w in waves:
            for k, n in w["launches"].items():
                add({"adaln_modulation_int8" if k == "adaln_modulation" else k: n})
        del bench, ev, ev8

        def torchrun(nproc: int, module: str, *argv: str, backend: str | None = None,
                     pipe: bool = False):
            """A torchrun call, its output in a pipe or in a file of the
            work directory (``p.log``)."""
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node", str(nproc), "-m", module, *argv]
            if backend:
                cmd += ["--dist_backend", backend]
            log = None if pipe else os.path.join(work, f"torchrun{next(call_ids)}.log")
            with open(log or os.devnull, "w") as f:
                p = subprocess.Popen(cmd, env=env0, cwd=here, stderr=subprocess.STDOUT, text=True,
                                     stdout=subprocess.PIPE if pipe else f)
            p.log = log
            return p

        call_ids = itertools.count()

        def records(name):
            with open(os.path.join(work, "ConductorMotion100", name, "metrics.jsonl")) as f:
                return [json.loads(line) for line in f]

        # (c)'s 1-process CLI run on the waves the ranks take (16, 8 a rank)
        eval_argv = ("--run_dir", run_dir, "--data_root", root, "--steps", "50", "--layer_impl",
                     "pallas_fused", "--adaln_int8")
        t0 = time.perf_counter()
        one_rep = evaluate.main([*eval_argv, "--batch_size", str(EVAL_WAVE * DP_WORLD),
                                 "--out_suffix", "_dp19_one"])
        t_one = time.perf_counter() - t0

        # (b) and (c) under torchrun, three calls at once, since a torchrun
        # call starts two interpreters before any work and importing torch
        # can take seconds: the CLI on 1 rank over NCCL, on 2 ranks over
        # gloo with a SIGTERM to rank 1, and cli.evaluate on 2 ranks
        t0 = time.perf_counter()
        train_argv = ("--data_root", root, "--checkpoints_dir", work, "--times", "4",
                      "--log_every", "1")
        nccl1 = torchrun(1, "conductor_tpu_torch.cli.train", *train_argv, "--name", "nccl1",
                         "--epochs", "1")
        eval2 = torchrun(DP_WORLD, "conductor_tpu_torch.cli.evaluate", *eval_argv,
                         "--out_suffix", "_dp19", backend="gloo")
        proc = torchrun(DP_WORLD, "conductor_tpu_torch.cli.train", *train_argv, "--name", "sig",
                        "--epochs", "1000", "--save_latest", "100000", "--save_every_e",
                        "100000", backend="gloo", pipe=True)
        lines: list[str] = []
        reader = threading.Thread(target=lambda: lines.extend(iter(proc.stdout.readline, "")))
        reader.start()
        jsonl = os.path.join(work, "ConductorMotion100", "sig", "metrics.jsonl")
        deadline = time.time() + DP_TIMEOUT
        pid = None
        try:
            while time.time() < deadline and proc.poll() is None:
                # the ranks share the pipe unbuffered, so rank 1's line can land
                # inside one of rank 0's (print writes the text and the newline
                # apart): look for it anywhere
                banner = re.search(r"rank 1 of 2 \(\w+\) on \S+ \(pid (\d+)\)", "".join(lines))
                pid = pid or (int(banner.group(1)) if banner else None)
                if pid and os.path.exists(jsonl) and os.path.getsize(jsonl) > 0:
                    break
                time.sleep(0.05)
            if pid is None or proc.poll() is not None:
                raise SystemExit("chip_smoke: cli.train on 2 ranks did not start:\n"
                                 + "".join(lines)[-3000:])
            os.kill(pid, signal.SIGTERM)
            rc = proc.wait(timeout=DP_TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
            reader.join(30)
            outs = wait([nccl1, eval2], "cli.train on 1 rank (nccl) / cli.evaluate on 2 ranks")
        t_calls = time.perf_counter() - t0
        out = "".join(lines)
        sig = records("sig")
        last = sig[-1]["step"]
        saved = CheckpointManager(os.path.join(work, "ConductorMotion100", "sig", "ckpt")
                                  ).latest_step()
        print(f"[dp19] (b) torchrun --nproc_per_node 2 --dist_backend gloo cli.train, SIGTERM to "
              f"rank 1 (pid {pid}) after step {sig[0]['step']}: rc {rc}, {len(sig)} steps logged "
              f"(losses {[r['loss'] for r in sig]}), rank 0 saved step {saved}")
        if (rc != 0 or saved != last
                or f"stop requested (signal on another rank): saved step {last}" not in out
                or f"stop requested (signal {int(signal.SIGTERM)}): stopped at step {last}"
                not in out):
            raise SystemExit(f"chip_smoke: a SIGTERM on rank 1 did not stop both ranks at one "
                             f"step where rank 0 saves:\n{out[-3000:]}")
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            base = [json.loads(line) for line in f][:2]
        got_r = records("nccl1")
        gap = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(got_r, base))
        print(f"[dp19] (b) torchrun --nproc_per_node 1 (nccl) cli.train --times 4 --epochs 1: "
              f"steps {[r['step'] for r in got_r]}, losses {[r['loss'] for r in got_r]} against "
              f"phase 12's default run's first two {[r['loss'] for r in base]} (largest rel gap "
              f"{gap:.3g}); '{next(ln for ln in outs[0].splitlines() if ln.startswith('rank 0 of 1'))}'")
        if [r["step"] for r in got_r] != [1, 2] or "rank 0 of 1 (nccl)" not in outs[0] or not (
                gap <= DP_REL_TOL):
            raise SystemExit(f"chip_smoke: cli.train under torchrun (nccl) went wrong:\n"
                             f"{outs[0][-3000:]}")
        with open(os.path.join(run_dir, "eval_test_dp19.json")) as f:
            dp_rep = json.load(f)
        gaps = {k: abs(dp_rep[k] - v) for k, v in one_rep.items()}
        print(f"[dp19] (c) torchrun --nproc_per_node 2 cli.evaluate (bench.py's config, ddim50, "
              f"{EVAL_CLIPS} clips, waves of {EVAL_WAVE * DP_WORLD}): {dp_rep}; against one "
              f"process: gaps {gaps}; {t_one:.1f} s in process; "
              f"'{[ln for ln in outs[1].splitlines() if 'evaluating on' in ln]}'")
        if set(dp_rep) != set(one_rep) or not all(np.isfinite(v) for v in dp_rep.values()) or any(
                g > GENERATE_REL_TOL * max(abs(one_rep[k]), 1e-6) for k, g in gaps.items()):
            raise SystemExit("chip_smoke: cli.evaluate on 2 ranks disagrees with one process")
        print(f"[dp19] (b), (c) the three torchrun calls at once: {t_calls:.1f} s, process "
              f"start-up included, on {smi}")
        t0 = time.perf_counter()
        epochs = last // 2 + 1  # 2 steps an epoch at --times 4
        out = wait([torchrun(DP_WORLD, "conductor_tpu_torch.cli.train", *train_argv, "--name",
                             "sig", "--epochs", str(epochs), "--continue", backend="gloo")],
                   "cli.train --continue on 2 ranks")[0]
        sig = records("sig")
        print(f"[dp19] (b) --continue on 2 ranks: steps {[r['step'] for r in sig]} "
              f"({time.perf_counter() - t0:.1f} s)")
        # the resumed run restarts the interrupted epoch (the signal may land
        # mid-epoch, at an odd step) from its first batch: 2 steps an epoch
        # from epoch last // 2 to the last
        if f"resumed from step {last}" not in out or sig[-1]["step"] != last + 2 * (
                epochs - last // 2):
            raise SystemExit(f"chip_smoke: --continue on 2 ranks did not resume:\n{out[-3000:]}")

        # (d) the demo and the 1000-step ladder at small flags, in process
        sys.path.insert(0, os.path.join(here, "scripts"))
        import run_1000ladder_torch
        import run_e2e_demo_torch

        demo_out, demo_work = os.path.join(work, "demo_out"), os.path.join(work, "demo")
        reset_launch_counts()
        t0 = time.perf_counter()
        res = run_e2e_demo_torch.main(["--out", demo_out, "--work", demo_work, *DEMO_ARGS])
        torch.cuda.synchronize()
        c = {k: n for k, n in launch_counts().items() if n}
        print(f"[dp19] (d) run_e2e_demo_torch.py {' '.join(DEMO_ARGS)}: "
              f"{time.perf_counter() - t0:.1f} s, stages (s) "
              f"{ {k: round(v, 2) for k, v in res['seconds'].items()} }; run_meta "
              f"{json.dumps(res['meta'])}; launches {c} (K1's GEMM "
              f"{part_launch_counts()}) on {smi}")
        with open(os.path.join(demo_out, "run_meta.json")) as f:
            meta = json.load(f)
        need = ("conv_block", "decoder_layer", "decoder_layer_bwd", "stgcn_forward",
                "stgcn_backward", "conv3x3_dkernel", "max_pool", "max_pool_bwd", "decoder_stack",
                "decoder_stack_int8", "sampler_prologue", "sampler_epilogue")
        if (not meta["torch_export_roundtrip"].startswith("exact")
                or not meta["backend"].startswith(smi) or any(not c.get(k) for k in need)):
            raise SystemExit(f"chip_smoke: the demo went wrong: {meta} {c}")
        add(c)
        reset_launch_counts()
        t0 = time.perf_counter()
        payload = run_1000ladder_torch.main(["--out", demo_out, "--work", demo_work,
                                             "--stage2_epochs", "2", "--steps", "50"])
        torch.cuda.synchronize()
        c = {k: n for k, n in launch_counts().items() if n}
        print(f"[dp19] (d) run_1000ladder_torch.py --steps 50: {time.perf_counter() - t0:.1f} s, "
              f"{json.dumps(payload)}; launches {c}")
        if not all(np.isfinite(v) for v in payload["sweep"]["50"].values()) or not c.get(
                "decoder_stack"):
            raise SystemExit(f"chip_smoke: the 1000-step ladder sweep went wrong: {payload} {c}")
        add(c)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[dp19] launches {counts}; phase 19 took {time.perf_counter() - t_phase:.1f} s on {smi}")
    return counts


def reference_phase(smi: str, mel, noise, run_dir: str, root: str, m2snet_ckpt: str
                    ) -> dict[str, int]:
    """Phase 20 (the `[ref20]` lines), after phase 19: a reference run
    directory in and out on phase 12's default run (``run_dir``, its
    ``--data_root`` ``root``) and phase 13's M2SNet checkpoint, at the
    flagship width; (a)-(e) as the module docstring lists them.  Returns
    the launches by kernels-line row; raises SystemExit on any failed
    check."""
    import os
    import shutil
    import tempfile

    from conductor_tpu_torch.cli import export_torch, import_torch
    from conductor_tpu_torch.cli.evaluate import run_config
    from conductor_tpu_torch.cli.train import main as train_cli
    from conductor_tpu_torch.cli.visualize import load_run
    from conductor_tpu_torch.config import Config
    from conductor_tpu_torch.interop import synthetic_generator_state_dict, synthetic_state_dict
    from conductor_tpu_torch.interop.opt_txt import write_opt_txt
    from conductor_tpu_torch.models.generator import (Generator, GeneratorCVPRLSTM, bilstm_plain,
                                                      lstm_plain)
    from conductor_tpu_torch.models.music_encoder import FusedMusicEncoder
    from conductor_tpu_torch.ops import launch_counts, part_launch_counts, reset_launch_counts
    from conductor_tpu_torch.prospective import CNNLSTMGenerator
    from conductor_tpu_torch.train.checkpoints import CheckpointManager
    from conductor_tpu_torch.utils.profiling import annotate, trace

    t_phase = time.perf_counter()
    counts: dict[str, int] = {}

    def add(c: dict[str, int], int8: bool = False) -> None:
        for k, n in c.items():
            if n:
                k = "adaln_modulation_int8" if int8 and k == "adaln_modulation" else k
                counts[k] = counts.get(k, 0) + n

    def launched() -> dict[str, int]:
        torch.cuda.synchronize()
        return {k: n for k, n in (launch_counts() | part_launch_counts()).items() if n}

    checkpoints = os.path.dirname(os.path.dirname(run_dir))  # phase 12's --checkpoints_dir
    cfg12 = Config.load(os.path.join(run_dir, "config.json"))
    d, tc = cfg12.denoiser, cfg12.train
    work = tempfile.mkdtemp(prefix="chip_smoke_ref20_")
    try:
        # (a) phase 12's run out as a reference run directory, phase 13's
        # M2SNet out as a .pt, both back in as one imported run
        ref = os.path.join(work, "ref")
        os.makedirs(os.path.join(ref, "model"))
        t0 = time.perf_counter()
        export_torch.main(["diffusion", "--run_dir", run_dir,
                           "--output", os.path.join(ref, "model", "latest.tar")])
        write_opt_txt(os.path.join(ref, "opt.txt"), {
            "name": "defaults", "dataset_name": cfg12.dataset.name,
            "num_layers": d.num_layers, "latent_dim": d.latent_dim,
            "diffusion_steps": cfg12.diffusion.steps, "lr": tc.lr, "batch_size": tc.batch_size,
            "num_epochs": tc.num_epochs, "log_every": tc.log_every,
            "save_latest": tc.save_latest, "save_every_e": tc.save_every_e,
            "no_eff": not d.efficient_attention, "which_epoch": "latest", "is_train": True})
        m2s_pt = os.path.join(work, "M2SNet_last.pt")
        export_torch.main(["m2snet", "--run_dir", os.path.dirname(m2snet_ckpt),
                           "--output", m2s_pt])
        imported = os.path.join(checkpoints, cfg12.dataset.name, "imported")
        import_torch.main(["diffusion", "--input", ref, "--output", imported,
                           "--stage1_pt", m2s_pt])
        t_io = time.perf_counter() - t0
        a = CheckpointManager(os.path.join(run_dir, "ckpt")).restore()
        b = CheckpointManager(os.path.join(imported, "ckpt")).restore()
        m2s = torch.load(m2s_pt, weights_only=True)
        same = (a["total_it"] == b["total_it"]
                and all(torch.equal(v, b["encoder"][k]) for k, v in a["encoder"].items())
                and all(torch.equal(v, b["opt_encoder"]["state"][i][key])
                        for i, st in a["opt_encoder"]["state"].items() for key, v in st.items())
                and all(torch.equal(v, m2s[f"motion_encoder.{k}"])
                        for k, v in b["feat_encoder"].items()))
        print(f"[ref20] (a) export_torch diffusion + m2snet, import_torch diffusion --stage1_pt: "
              f"{t_io:.1f} s; the imported checkpoint (step {b['total_it']}) phase 12's weights and "
              f"Adam moments, its perceptual ST-GCN phase 13's motion encoder, bit for bit: {same}")
        if not same:
            raise SystemExit("chip_smoke: the imported run is not phase 12's run")
        trainers = {}
        for label, int8 in (("bf16", False), ("bench_int8", True)):
            outs = []
            for name, rd in (("imported", imported), ("phase 12", run_dir)):
                tr = load_run(rd, None, "cuda", run_config(rd, "cuda", "pallas_fused",
                                                           adaln_int8=int8))
                reset_launch_counts()
                t0 = time.perf_counter()
                out = tr.generate(mel, num_steps=50, noise=noise)
                c = launched()
                outs.append((out, time.perf_counter() - t0, c))
                add(c, int8)
                if label == "bf16":
                    trainers[name] = tr
            (o_i, s_i, c_i), (o_p, s_p, _) = outs
            mode = "_int8" if int8 else ""
            want = {"conv_block": 7, f"decoder_stack{mode}": 50, f"sampler_prologue{mode}": 50,
                    "sampler_epilogue": 50, "adaln_modulation": 50}
            print(f"[ref20] (a) {label} ddim50 B=2 on phase 4's mel and noise: imported run "
                  f"{s_i * 1e3:.1f} ms, phase 12's {s_p * 1e3:.1f} ms; motion bit-equal "
                  f"{bool(torch.equal(o_i, o_p))}, finite {bool(torch.isfinite(o_i).all())}; "
                  f"launches {c_i}")
            if not torch.equal(o_i, o_p) or c_i != want:
                raise SystemExit(f"chip_smoke: the imported run does not serve as phase 12's "
                                 f"({label}): launches {c_i}")

        # (b) --continue for 2 steps on the imported run and on a copy of
        # phase 12's run holding the same perceptual ST-GCN
        copy = os.path.join(checkpoints, cfg12.dataset.name, "p12_stgcn13")
        shutil.copytree(run_dir, copy)
        mgr = CheckpointManager(os.path.join(copy, "ckpt"))
        st = mgr.restore()
        st["feat_encoder"] = b["feat_encoder"]
        mgr.save(st["total_it"], st, wait=True)
        with open(os.path.join(imported, "config.json")) as f:
            rec = json.load(f)
        flags = ["--latent_dim", rec["denoiser"]["latent_dim"], "--num_layers",
                 rec["denoiser"]["num_layers"], "--ff_size", rec["denoiser"]["ff_size"],
                 "--num_heads", rec["denoiser"]["num_heads"], "--diffusion_steps",
                 rec["diffusion"]["steps"], "--lr", rec["train"]["lr"], "--batch_size",
                 rec["train"]["batch_size"], "--sample_length", rec["train"]["sample_length"],
                 *([] if rec["denoiser"]["efficient_attention"] else ["--no_eff"])]
        epochs = b["total_it"] // 2 + 1  # 2 steps an epoch at --times 4: 2 more steps
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        losses, walls = {}, {}
        try:
            for name in ("imported", "p12_stgcn13"):
                reset_launch_counts()
                t0 = time.perf_counter()
                train_cli(["--data_root", root, "--name", name, "--checkpoints_dir", checkpoints,
                           *map(str, flags), "--times", "4", "--epochs", str(epochs),
                           "--save_latest", "2", "--continue"])
                torch.cuda.synchronize()
                c = {k: n for k, n in launch_counts().items() if n}  # K5 / K6 / K7
                walls[name] = time.perf_counter() - t0
                add(c)
                with open(os.path.join(checkpoints, cfg12.dataset.name, name,
                                       "metrics.jsonl")) as f:
                    losses[name] = [(r["step"], r["loss"]) for r in map(json.loads, f)][-2:]
        finally:
            torch.backends.cudnn.deterministic = deterministic
        print(f"[ref20] (b) cli.train --continue {' '.join(map(str, flags))} --times 4 --epochs "
              f"{epochs}: (step, loss) imported {losses['imported']}, phase 12's copy "
              f"{losses['p12_stgcn13']}; {walls['imported']:.1f} / {walls['p12_stgcn13']:.1f} s; "
              f"launches of the last run {c}")
        steps = [b["total_it"] + 1, b["total_it"] + 2]
        if [s for s, _ in losses["imported"]] != steps or losses["imported"] != losses[
                "p12_stgcn13"]:
            raise SystemExit("chip_smoke: --continue on the imported run differs from phase 12's")

        # (c) the BiLSTM generators and the CNN-LSTM baseline at B = 55, 30 s
        rng = np.random.RandomState(20)
        b55, s30 = GAN_B, GAN_S
        gmel = torch.from_numpy(rng.uniform(0, 1, (b55, s30 * 90, 128)).astype(np.float32)).cuda()
        gnoise = torch.from_numpy(rng.normal(size=(b55, s30, 8)).astype(np.float32)).cuda()

        def timed(fn):
            """fn's output and the ms of its second call (the first warms
            cuDNN's plans and the allocator)."""
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t0) * 1e3

        def held(label, got, want, ms, plain_ms, tol):
            err, scale = float((got - want).abs().max()), float(want.abs().max())
            print(f"[ref20] (c) {label}: shape {tuple(got.shape)}, max_abs_err {err:.6g} (plain "
                  f"max {scale:.6g}, bound {tol:g} of it), {ms:.1f} ms against the plain "
                  f"version's {plain_ms:.1f} on {smi}")
            if not bool(torch.isfinite(got).all()) or not err <= tol * scale:
                raise SystemExit(f"chip_smoke: {label} disagrees with its plain version")

        with torch.no_grad():
            g = Generator(decoder_kind="bilstm").cuda()
            g.load_state_dict({k: torch.from_numpy(v) for k, v in
                               synthetic_generator_state_dict(g, seed=20).items()})
            g.eval()
            enc = FusedMusicEncoder(g.music_encoder)  # as the M2SGAN trainer's frozen encoder

            def kernel_path():
                hx = enc(gmel)
                return hx, g.decode(hx, gnoise)

            reset_launch_counts()
            (hx, fake), ms = timed(kernel_path)
            c = {k: n // 2 for k, n in launched().items()}  # a call's, of the two timed
            add(c)
            if c != {"conv_block": 7}:
                raise SystemExit(f"chip_smoke: the BiLSTM generator's encoder is not K4: {c}")
            h = g._hidden(hx, gnoise)
            plain_dec, plain_ms = timed(lambda: bilstm_plain(g.lstm, h))
            held("Generator(decoder_kind='bilstm') decoder, cuDNN LSTM vs lstm_plain on K4's "
                 "features", g.lstm(h), plain_dec, ms, plain_ms, LSTM_REL_TOL)
            plain_fake, plain_ms = timed(lambda: bilstm_plain(
                g.lstm, g._hidden(g.music_encoder(gmel), gnoise)).reshape(fake.shape))
            held("Generator(decoder_kind='bilstm') whole path, K4 (bf16) + cuDNN vs the plain "
                 "float32 encoder + lstm_plain", fake, plain_fake, ms, plain_ms, LSTM_REL_TOL)
            cv = GeneratorCVPRLSTM().cuda().eval()
            cv.load_state_dict({k: torch.from_numpy(v) for k, v in
                                synthetic_state_dict(cv, seed=21).items()})
            feats20 = torch.from_numpy(rng.normal(size=(b55, s30 * 30, 20)).astype(
                np.float32)).cuda()
            got, ms = timed(lambda: cv(feats20))
            want, plain_ms = timed(lambda: bilstm_plain(cv.lstm, feats20).reshape(got.shape))
            held("GeneratorCVPRLSTM, 20-d features", got, want, ms, plain_ms, LSTM_REL_TOL)
            cnn = CNNLSTMGenerator().cuda()
            cnn.load_state_dict({k: torch.from_numpy(v) for k, v in
                                 synthetic_state_dict(cnn, seed=22).items()})
            got, ms = timed(lambda: cnn(gmel))  # eval mode, as the plain version below runs
            want, plain_ms = timed(lambda: cnn.fc(lstm_plain(cnn.lstm, cnn.music_encoder(
                gmel))).reshape(got.shape))
            held("CNNLSTMGenerator", got, want, ms, plain_ms, LSTM_REL_TOL)
            del g, enc, cv, cnn

        # (d) DDIM at eta = 1 on the fused layers against the plain float32
        # path, the same x_T and step noise
        step_noise = torch.from_numpy(np.random.RandomState(21).normal(
            size=(50, *noise.shape)).astype(np.float32)).cuda()
        fused = trainers["imported"]
        plain_cfg = Config.load(os.path.join(imported, "config.json"))
        plain_cfg = plain_cfg.replace(denoiser=dataclasses.replace(
            plain_cfg.denoiser, layer_impl="flax", music_encoder_impl="flax", attention_impl="xla",
            compute_dtype="float32"))
        plain = load_run(imported, b["total_it"], "cuda", plain_cfg)  # the fused one's step
        reset_launch_counts()
        got, ms = timed(lambda: fused.generate(mel, num_steps=50, noise=noise, eta=1.0,
                                               step_noise=step_noise))
        c = {k: n // 2 for k, n in launched().items()}  # a call's, of the two timed
        add(c)
        want, plain_ms = timed(lambda: plain.generate(mel, num_steps=50, noise=noise, eta=1.0,
                                                      step_noise=step_noise))
        eta0 = fused.generate(mel, num_steps=50, noise=noise)
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        print(f"[ref20] (d) DDIM eta=1 ddim50 B=2 on the fused layers: max_abs_err vs the plain "
              f"float32 path {err:.6g} (plain max {scale:.6g}, bound {GENERATE_REL_TOL:g} of it); "
              f"moved from eta=0 by {float((got - eta0).abs().max()):.6g}; {ms:.1f} ms against "
              f"{plain_ms:.1f}; launches {c}")
        if (not err <= GENERATE_REL_TOL * scale or c != {"conv_block": 7, "decoder_stack": 50,
                                                         "adaln_modulation": 50}):
            raise SystemExit("chip_smoke: DDIM at eta > 0 on the fused layers is wrong")
        del plain

        # (e) a torch.profiler trace of a ddim10 call, annotated
        reset_launch_counts()
        with trace(os.path.join(work, "trace")) as prof:
            with annotate("ref20.generate"):
                fused.generate(mel, num_steps=10, noise=noise)
                torch.cuda.synchronize()
        c = launched()
        add(c)
        with open(prof.trace_path) as f:
            events = json.load(f)["traceEvents"]
        names = [e.get("name", "") for e in events]
        k1 = [n for n in names if "layer_rows_kernel" in n or "kv_partials_kernel" in n]
        print(f"[ref20] (e) utils.profiling.trace around a ddim10 call: {len(events)} events, "
              f"{len(k1)} of K1's kernels, 'ref20.generate' in it "
              f"{'ref20.generate' in names}; launches {c}")
        if not k1 or "ref20.generate" not in names:
            raise SystemExit("chip_smoke: the profiling trace lacks K1's kernels or the "
                             "annotation")
        del fused, trainers
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[ref20] launches {counts}; phase 20 took {time.perf_counter() - t_phase:.1f} s on "
          f"{smi}")
    return counts


def t2m_phase(smi: str) -> None:
    """Phase 21 (the `[t2m21]` lines), after phase 20: the text-to-motion
    stack on the card against the same work on the CPU port.  (1) A random
    evaluator (`T2MEvaluatorWrapper.init` from a seeded generator) written
    by `save_torch_checkpoint` as a `finest.tar`-layout file and re-loaded
    strictly, bit for bit; (2) its co-embeddings at B = 32 against the CPU
    port on the same weights and inputs, and the encoders' cuDNN GRUs
    against `gru_plain` on the card (both within ``T2M_EMB_REL_TOL`` of the
    largest value); (3) `recover_from_ric` on the batch's motions read as
    features, FK and IK (smoothed) on a 196-frame walking motion and
    `process_file` of it against the CPU (``T2M_MOTION_REL_TOL``), the foot
    contacts equal (``feet_thre`` in the widest relative gap among the
    middle half of the squared foot displacements).  ms a call, the median
    of 2-10 calls after one not timed: the card, the CPU port and the plain
    GRUs.  No kernel of the kernels line runs here.  Raises SystemExit on
    any failed check."""
    import os
    import shutil
    import tempfile

    from conductor_tpu_torch.models.precision import full_float32
    from conductor_tpu_torch.t2m import param_util
    from conductor_tpu_torch.t2m.evaluator_models import (T2MEvaluatorWrapper, bigru_co_plain,
                                                          load_torch_checkpoint,
                                                          save_torch_checkpoint)
    from conductor_tpu_torch.t2m.motion_process import (T2M_FACE_JOINTS, T2M_FID_L, T2M_FID_R,
                                                        process_file, recover_from_ric)
    from conductor_tpu_torch.t2m.quaternion import qnormalize
    from conductor_tpu_torch.t2m.skeleton import Skeleton

    t_phase = time.perf_counter()

    def ms(fn, reps):
        """The median wall ms of ``reps`` calls of ``fn`` up to the host
        readback, after one call not timed."""
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    def held(label, got, want, tol):
        got, want = np.asarray(got), np.asarray(want)
        err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
        print(f"[t2m21] {label}: shape {got.shape}, max_abs_err {err:.6g} (max {scale:.6g}, "
              f"bound {tol:g} of it)")
        if got.shape != want.shape or not np.isfinite(got).all() or not err <= tol * scale:
            raise SystemExit(f"chip_smoke: t2m {label} disagrees")

    # (1) a finest.tar-layout file out and in
    work = tempfile.mkdtemp(prefix="chip_smoke_t2m_")
    try:
        state = T2MEvaluatorWrapper("t2m", device="cuda").init(torch.Generator().manual_seed(21))
        path = os.path.join(work, "finest.tar")
        save_torch_checkpoint(path, state)
        size = os.path.getsize(path)
        loaded = load_torch_checkpoint(path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    card = T2MEvaluatorWrapper("t2m", loaded, device="cuda")
    cpu = T2MEvaluatorWrapper("t2m", loaded, device="cpu")
    equal = all(torch.equal(v.cpu(), state[key][name].cpu())
                for key, sd in card.state_dict().items() for name, v in sd.items())
    n_params = sum(v.numel() for sd in state.values() for v in sd.values())
    print(f"[t2m21] (1) save_torch_checkpoint -> load_torch_checkpoint: {size} bytes, keys "
          f"{sorted(loaded)}, {n_params} parameters, loaded strictly on the card and the CPU, "
          f"bit-equal {equal}")
    if not equal:
        raise SystemExit("chip_smoke: the t2m evaluator's checkpoint did not round-trip")

    # (2) the co-embeddings at HumanML3D's evaluation batch
    rng = np.random.RandomState(21)
    m_lens = rng.randint(10, T2M_FRAMES // 4 + 1, T2M_B) * 4
    m_lens[[5, 17]] = T2M_FRAMES, 40
    cap_lens = rng.randint(5, T2M_TOKENS + 1, T2M_B)
    cap_lens[3] = T2M_TOKENS
    words = rng.normal(size=(T2M_B, T2M_TOKENS, 300)).astype(np.float32)
    pos = np.eye(15, dtype=np.float32)[rng.randint(0, 15, (T2M_B, T2M_TOKENS))]
    motions = rng.normal(size=(T2M_B, T2M_FRAMES, 263)).astype(np.float32)
    for i, n in enumerate(m_lens):  # zero past each length, as the dataset pads
        motions[i, n:] = 0.0
    batch = (words, pos, cap_lens, motions, m_lens)
    text_card, mot_card = card.get_co_embeddings(*batch)
    text_cpu, mot_cpu = cpu.get_co_embeddings(*batch)
    held("(2) text embeddings, card against the CPU port", text_card, text_cpu, T2M_EMB_REL_TOL)
    held("(2) motion embeddings, card against the CPU port", mot_card, mot_cpu, T2M_EMB_REL_TOL)
    dev = {k: torch.from_numpy(np.asarray(v)).cuda() for k, v in zip(
        ("words", "pos", "cap", "mot"), (words, pos, cap_lens, motions))}
    mlen4 = torch.from_numpy(m_lens // card.UNIT_LENGTH)

    te, me = card.text_enc, card.motion_enc

    def text(plain):
        if plain:
            emb = te.input_emb(dev["words"] + te.pos_emb(dev["pos"]))
            return bigru_co_plain(te, emb, dev["cap"]).cpu()
        return te(dev["words"], dev["pos"], dev["cap"]).cpu()

    def motion(plain):
        if plain:
            return bigru_co_plain(me, me.input_emb(movements), mlen4).cpu()
        return me(movements, mlen4).cpu()

    with torch.no_grad(), full_float32():
        movements = card.movement_enc(dev["mot"][..., :-4])
        held("(2) text encoder, cuDNN's GRU against gru_plain on the card", text(False),
             text(True), T2M_EMB_REL_TOL)
        held("(2) motion encoder, cuDNN's GRU against gru_plain on the card", motion(False),
             motion(True), T2M_EMB_REL_TOL)
        t_gru = {f"{name} {kind}": ms(lambda: fn(plain), 5)
                 for name, fn in (("text", text), ("motion", motion))
                 for kind, plain in (("cuDNN", False), ("gru_plain", True))}
    t_card = ms(lambda: card.get_co_embeddings(*batch), 10)
    t_cpu = ms(lambda: cpu.get_co_embeddings(*batch), 2)
    print(f"[t2m21] (2) get_co_embeddings B={T2M_B}, {T2M_FRAMES} x 263 motions, "
          f"{T2M_TOKENS} x (300 + 15) captions: {t_card:.3f} ms a call on the card, the CPU "
          f"port {t_cpu:.1f} ms; encoders alone on the card, ms: "
          f"{', '.join(f'{k} {v:.3f}' for k, v in t_gru.items())} on {smi}")

    # (3) the kinematics and the features
    with full_float32():
        x = torch.from_numpy(motions)
        held("(3) recover_from_ric of the batch, card against the CPU",
             recover_from_ric(x.cuda(), T2M_JOINTS).cpu(), recover_from_ric(x, T2M_JOINTS),
             T2M_MOTION_REL_TOL)
        t_ric = ms(lambda: recover_from_ric(dev["mot"], T2M_JOINTS).cpu(), 10)
        chain = (param_util.t2m_raw_offsets, param_util.t2m_kinematic_chain)
        skel = Skeleton(*chain)
        skel.set_offset(np.asarray(param_util.t2m_raw_offsets, np.float32) * 0.25)
        q = np.concatenate([np.ones((T2M_FRAMES, T2M_JOINTS, 1)),
                            0.03 * rng.normal(size=(T2M_FRAMES, T2M_JOINTS, 3))], -1)
        q = qnormalize(torch.tensor(q, dtype=torch.float32))
        root = torch.tensor(np.stack([np.linspace(0, 2.5, T2M_FRAMES), 0.9 + np.zeros(T2M_FRAMES),
                                      0.5 * np.linspace(0, 1, T2M_FRAMES)], -1),
                            dtype=torch.float32)
        walk = skel.forward_kinematics(q, root)
        held("(3) Skeleton.forward_kinematics, card against the CPU",
             skel.forward_kinematics(q.cuda(), root.cuda()).cpu(), walk, T2M_MOTION_REL_TOL)
        held("(3) Skeleton.inverse_kinematics (smoothed), card against the CPU",
             skel.inverse_kinematics(walk.cuda(), T2M_FACE_JOINTS, smooth_forward=True).cpu(),
             skel.inverse_kinematics(walk, T2M_FACE_JOINTS, smooth_forward=True),
             T2M_MOTION_REL_TOL)
    walk = walk.numpy()
    tgt = np.asarray(param_util.t2m_raw_offsets, np.float32) * 0.4
    glob = process_file(walk, 0.0, tgt, *chain, device="cpu")[1]
    fid = list(T2M_FID_L) + list(T2M_FID_R)
    d2 = np.sort(((glob[1:, fid] - glob[:-1, fid]) ** 2).sum(-1).ravel())
    lo = len(d2) // 4  # the widest relative gap in the middle half
    gap = lo + int(np.argmax(np.diff(d2[lo:3 * lo + 1]) / d2[lo + 1:3 * lo + 1]))
    thre = float((d2[gap] + d2[gap + 1]) / 2)
    want = process_file(walk, thre, tgt, *chain, device="cpu")
    got = process_file(walk, thre, tgt, *chain, device="cuda")
    for name, g, w in zip(("data", "global_positions", "local_positions", "l_velocity"), got,
                          want):
        held(f"(3) process_file {name}, card against the CPU", g, w, T2M_MOTION_REL_TOL)
    contacts = got[0][:, -4:]
    print(f"[t2m21] (3) foot contacts equal {np.array_equal(contacts, want[0][:, -4:])}, "
          f"{int(contacts.sum())} of {contacts.size} set, feet_thre {thre:.6g} between "
          f"{d2[gap]:.6g} and {d2[gap + 1]:.6g}")
    if not np.array_equal(contacts, want[0][:, -4:]) or not 0 < contacts.sum() < contacts.size:
        raise SystemExit("chip_smoke: t2m process_file's foot contacts differ on the card")
    t_pf = ms(lambda: process_file(walk, thre, tgt, *chain, device="cuda"), 3)
    t_pf_cpu = ms(lambda: process_file(walk, thre, tgt, *chain, device="cpu"), 3)
    print(f"[t2m21] (3) recover_from_ric B={T2M_B} x {T2M_FRAMES} frames: {t_ric:.3f} ms a call "
          f"on the card; process_file {T2M_FRAMES} frames x {T2M_JOINTS} joints: {t_pf:.1f} ms "
          f"on the card, {t_pf_cpu:.1f} ms with device='cpu', on {smi}")
    print(f"[t2m21] phase 21 took {time.perf_counter() - t_phase:.1f} s on {smi}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from conductor_tpu_torch import DDPMTrainer, M2SGANTrainer, M2SNetTrainer
    from conductor_tpu_torch.config import Config, DenoiserConfig, TrainConfig
    from conductor_tpu_torch.interop import (
        synthetic_discriminator_state_dict,
        synthetic_generator_state_dict,
        synthetic_m2snet_state_dict,
        synthetic_motion_encoder_state_dict,
        synthetic_state_dict,
    )
    from conductor_tpu_torch.kernel_checks import (
        F32_REL_TOL,
        K11_F32_REL_TOL,
        K7_BAR_MS,
        K7_MASK_FLIP_SHARE,
        K8_BAR_DEVICE_MS,
        K10_BAR_DEVICE_MS,
        K10_BAR_MS,
        K11_BAR_DEVICE_MS,
        K11_BAR_MS,
        check_attention_kernel,
        check_conv_blocks,
        check_kernels,
        check_layer_bwd,
        check_sampler_glue,
        check_stack_kernels,
        check_stage1_kernels,
        check_stgcn_kernels,
        check_train_kernels,
        gan_encoder_kernel_inputs,
        k1_launch_split,
        ladder_step_inputs,
        perceptual_inputs,
        stack_operands,
        stage1_kernel_inputs,
        sync_loss_inputs,
        time_ms,
    )
    from conductor_tpu_torch.models.music_encoder import FusedMusicEncoder
    from conductor_tpu_torch.ops import (
        _build,
        fused_decoder_stack,
        launch_counts,
        part_launch_counts,
        reset_launch_counts,
    )

    # the plain references run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. environment
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    smi = smi.splitlines()[0]
    nvcc = _run([_build._nvcc(), "--version"]).splitlines()[-1]
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} nvcc '{nvcc}' device '{torch.cuda.get_device_name(0)}'")
    print(smi)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    ptxas = [ln.strip() for ln in _build.build_log().read_text().splitlines() if "registers" in ln]
    print(f"[build] {time.perf_counter() - t0:.1f} s ({len(ptxas)} kernels: "
          f"{'; '.join(ptxas)})")

    cfg = Config()  # flagship: D = 128, 8 layers, 8 heads, ff 64, 1000 linear steps
    kernel_tr = DDPMTrainer(cfg, device="cuda")  # "auto" on CUDA: the kernel path
    if kernel_tr.fused is None or kernel_tr.fused_encoder is None:
        raise SystemExit("chip_smoke: 'auto' did not select the kernel path on CUDA")
    if (kernel_tr.cfg.denoiser.train_layer_impl, kernel_tr.cfg.train.feat_impl) != (
            "pallas_fused", "pallas"):
        raise SystemExit("chip_smoke: 'auto' did not select the training kernels on CUDA")
    plain_cfg = cfg.replace(denoiser=DenoiserConfig(
        layer_impl="flax", music_encoder_impl="flax", train_layer_impl="flax",
        attention_impl="xla", compute_dtype="float32"), train=TrainConfig(feat_impl="flax"))
    plain_tr = DDPMTrainer(plain_cfg, device="cuda")
    sd = synthetic_state_dict(kernel_tr.model, seed=0)
    feat_sd = synthetic_motion_encoder_state_dict(kernel_tr.feat_model, seed=0)
    kernel_tr.load_reference_state_dict(sd, motion_encoder=feat_sd)
    plain_tr.load_reference_state_dict(sd, motion_encoder=feat_sd)
    # stage 2 in float32 at "auto" (phase 15 (f)): K5 / K6's and K7's
    # float32 modes
    f32_train = DDPMTrainer(cfg.replace(denoiser=DenoiserConfig(compute_dtype="float32")),
                            device="cuda")
    if (f32_train.cfg.denoiser.train_layer_impl, f32_train.cfg.train.feat_impl) != (
            "pallas_fused", "pallas"):
        raise SystemExit("chip_smoke: float32 'auto' did not select K5 / K6 and K7")
    f32_train.load_reference_state_dict(sd, motion_encoder=feat_sd)

    def f32_ladder_trainer(extra):
        """Serving on the fused ladder's float32 mode (phase 15 (e)): K4's
        float32 encoder, K2 / K1 / K3 in float32 (``extra``: bf16 VPU or
        int8 AdaLN on top), the plain training layers, on phase 4's
        weights."""
        tr = DDPMTrainer(cfg.replace(
            denoiser=DenoiserConfig(compute_dtype="float32", layer_impl="pallas_fused",
                                    music_encoder_impl="pallas", train_layer_impl="flax", **extra),
            train=TrainConfig(feat_impl="flax")), device="cuda")
        tr.load_reference_state_dict(sd)
        return tr
    rng = np.random.RandomState(0)
    mel = torch.from_numpy(rng.uniform(0, 1, size=(2, 5400, 128)).astype(np.float32)).cuda()
    noise = torch.from_numpy(rng.normal(size=(2, 1800, 26)).astype(np.float32)).cuda()

    # the training batch: B = 32 windows of 30 s, and each step's random
    # numbers, made on the host from the seed
    n_train, t_train = cfg.train.batch_size, cfg.train.sample_length * cfg.dataset.motion_hz
    mel_train = torch.from_numpy(rng.uniform(
        0, 1, size=(n_train, 3 * t_train, 128)).astype(np.float32)).cuda()
    motion_train = torch.from_numpy(rng.uniform(
        0, 1, size=(n_train, t_train, 13, 2)).astype(np.float32)).cuda()
    drawn = [{"t": rng.randint(0, cfg.diffusion.steps, size=n_train),
              "noise": rng.normal(size=(n_train, t_train, 26)).astype(np.float32),
              "cond_keep": (rng.uniform(size=(n_train, t_train)) >= 0.1).astype(np.float32)}
             for _ in range(TRAIN_STEPS)]

    # stage 1: the kernel and plain trainers on one synthetic M2SNet, a
    # seeded batch of 30-s samples and the "hard" starts of each step
    m2s_kernel = M2SNetTrainer(sample_length=STAGE1_S, clip_length=STAGE1_C, device="cuda")
    if (m2s_kernel.compute_dtype, m2s_kernel.music_conv_impl) != ("bfloat16", "pallas_train"):
        raise SystemExit("chip_smoke: 'auto' did not select the stage-1 kernels on CUDA")
    m2s_plain = M2SNetTrainer(sample_length=STAGE1_S, clip_length=STAGE1_C, compute_dtype="float32",
                              music_conv_impl="lax", device="cuda")
    m2s_sd = synthetic_m2snet_state_dict(m2s_kernel.model, seed=0)
    music = torch.from_numpy(rng.uniform(
        0, 1, size=(STAGE1_B, STAGE1_S * 90, 128)).astype(np.float32)).cuda()
    motion_s1 = torch.from_numpy(rng.uniform(
        0, 1, size=(STAGE1_B, STAGE1_S * 30, 13, 2)).astype(np.float32)).cuda()
    span = (STAGE1_S - STAGE1_C) * 30  # the "hard" ranges of data/pairs.py
    starts = []
    for _ in range(TRAIN_STEPS):
        s1 = int(rng.randint(0, span - 300))
        starts.append((s1, int(rng.randint(s1 + 300, span))))

    # M2SGAN: the "auto" trainer (K4 frozen encoder, K7 bf16 SyncLoss), the
    # synthetic generator and critic, phase 7's M2SNet, a seeded batch of
    # 30-s samples and each step's noise and interpolation weights
    gan = M2SGANTrainer(critic_iters=GAN_ITERS, device="cuda")
    if (gan.music_encoder_impl, gan.sync_encoder_impl, gan.sync_encoder_dtype,
            gan.compute_dtype) != ("pallas", "pallas", "bfloat16", "float32"):
        raise SystemExit("chip_smoke: 'auto' did not select the M2SGAN kernels on CUDA")
    gan_sd = (synthetic_generator_state_dict(gan.G, seed=0),
              synthetic_discriminator_state_dict(gan.D, seed=1))
    gan.load_reference_state_dict(*gan_sd, m2snet=m2s_sd)

    def gan_trainer(**kw):
        tr = M2SGANTrainer(critic_iters=GAN_ITERS, device="cuda", **kw)
        tr.load_reference_state_dict(*gan_sd, m2snet=m2s_sd)
        return tr

    gan_mel = torch.from_numpy(rng.uniform(
        0, 1, size=(GAN_B, GAN_S * 90, 128)).astype(np.float32)).cuda()
    gan_real = torch.from_numpy(rng.uniform(
        0, 1, size=(GAN_B, GAN_S * 30, 13, 2)).astype(np.float32)).cuda()
    gan_drawn = [(torch.from_numpy(rng.normal(size=(GAN_B, GAN_S, 8)).astype(np.float32)).cuda(),
                  {"real_fake": torch.from_numpy(rng.uniform(size=(GAN_ITERS, GAN_B))
                                                 .astype(np.float32))})
                 for _ in range(TRAIN_STEPS)]

    # 3. every kernel against its plain version, at the main paths' shapes;
    # K1 and its AdaLN GEMM also at B = 8 (the headline's batch), on a mel
    # and x_T of their own seed, and K1's device time by launch at both
    rng8 = np.random.RandomState(8)
    mel_b8 = torch.from_numpy(rng8.uniform(0, 1, size=(8, 5400, 128)).astype(np.float32)).cuda()
    noise_b8 = torch.from_numpy(rng8.normal(size=(8, 1800, 26)).astype(np.float32)).cuda()
    results = check_kernels(kernel_tr, mel, noise, glue_inputs=(mel_b8, noise_b8))
    step_b8 = ladder_step_inputs(kernel_tr, mel_b8, noise_b8)[:2]
    results += check_stack_kernels(kernel_tr, *step_b8, suffix="_b8")
    results.append(check_conv_blocks(kernel_tr.fused_encoder, mel_b8) | {"name": "conv_block_b8"})
    for label, (m, x_t) in (("B=2", (mel, noise)), ("B=8", (mel_b8, noise_b8))):
        ops = stack_operands(kernel_tr, *ladder_step_inputs(kernel_tr, m, x_t)[:2])
        for mode in K1_MODES:
            args, kw = ops[mode]
            split = k1_launch_split(lambda: fused_decoder_stack(*args, **kw))
            print(f"[k1-split] {mode} {label} T=1800, device ms a call: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
                  + f", sum {sum(split.values()):.4f} ({smi})")
    del step_b8, ops, args, kw
    # K5 and K6 at B = 4 (the ``_b4`` rows) and at the main path's B = 32
    results += check_train_kernels(kernel_tr, mel_train, motion_train, batches=(4, n_train))
    # the training kernels' float32 modes (phase 15 (f)'s) on layer 0 of a
    # float32 training forward, K5 and K6 at B = 4 and 32, and K7 on the
    # float32 perceptual term's inputs
    results += check_train_kernels(f32_train, mel_train, motion_train, batches=(4, n_train))
    torch.cuda.empty_cache()
    feat_mxu = getattr(torch, kernel_tr.cfg.denoiser.compute_dtype)
    results += check_stgcn_kernels(kernel_tr.feat_model, kernel_tr.feat_pack, feat_mxu,
                                   *perceptual_inputs(kernel_tr, mel_train, motion_train))
    results += check_stgcn_kernels(f32_train.feat_model, f32_train.feat_pack, torch.float32,
                                   *perceptual_inputs(f32_train, mel_train, motion_train))
    m2s_kernel.load_reference_state_dict(m2s_sd)
    results += check_stage1_kernels(*stage1_kernel_inputs(m2s_kernel, music, motion_s1, starts[0]))
    m2s_kernel.load_reference_state_dict(m2s_sd)  # undo the check's BN statistics
    # the float32 modes (phase 15's kernels) on the inputs of their calls: K4
    # on the serving encoder's 7 blocks at B = 2, and K4's training modes,
    # K9, K10 and K11 in one float32 stage-1 forward and backward at B = 10
    results.append(check_conv_blocks(FusedMusicEncoder(kernel_tr.model.music_encoder,
                                                       torch.float32), mel))
    # the fused ladder's float32 mode (phase 15 (e)'s kernels) on the first
    # ladder step of phase 4's mel and x_T: K2 with float32 and int8 emb_act, K1 alone,
    # with bf16 VPU and with int8 AdaLN, its float32 GEMM, K3; K1 and its
    # GEMM again at B = 8, and K1's device time by launch at both
    f32_fused = f32_ladder_trainer({})
    step_f32 = ladder_step_inputs(f32_fused, mel, noise)
    glue_f32 = check_sampler_glue(f32_fused, *step_f32)
    results += [glue_f32[0], *check_stack_kernels(f32_fused, *step_f32[:2]), *glue_f32[1:]]
    step_f32_b8 = ladder_step_inputs(f32_fused, mel_b8, noise_b8)[:2]
    results += check_stack_kernels(f32_fused, *step_f32_b8, suffix="_b8")
    for label, step in (("B=2", step_f32[:2]), ("B=8", step_f32_b8)):
        args, kw = stack_operands(f32_fused, *step)["decoder_stack"]
        split = k1_launch_split(lambda: fused_decoder_stack(*args, **kw))
        print(f"[k1-split] decoder_stack_f32 {label} T=1800, device ms a call: "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f", sum {sum(split.values()):.4f} ({smi})")
    del f32_fused, step_f32, glue_f32, step_f32_b8, args, kw, mel_b8, noise_b8
    torch.cuda.empty_cache()
    m2s_f32 = M2SNetTrainer(sample_length=STAGE1_S, clip_length=STAGE1_C, compute_dtype="float32",
                            music_conv_impl="pallas_train", device="cuda")
    m2s_f32.load_reference_state_dict(m2s_sd)
    results += check_stage1_kernels(*stage1_kernel_inputs(m2s_f32, music, motion_s1, starts[0]))
    del m2s_f32
    # M2SGAN's kernels at phase 11's shapes: K4 on the frozen encoder (a),
    # K7 on the SyncLoss's inputs, and the trainable encoder's kernels
    # (K4's training modes, K9, K10, K11) in a generator step of (c)
    results.append(check_conv_blocks(gan.fused_encoder(), gan_mel) | {"name": "conv_block_gan"})
    results += check_stgcn_kernels(gan.sync_encoder, gan.sync_pack(), gan.sync_dtype,
                                   *sync_loss_inputs(gan, gan_mel, gan_real, gan_drawn[0][0]),
                                   suffix="_gan")
    trains = gan_trainer(train_music_encoder=True)
    results += [r | {"name": r["name"] + "_gan"} for r in check_stage1_kernels(
        *gan_encoder_kernel_inputs(trains, gan_mel, gan_real, gan_drawn[0][0]))]
    del trains
    torch.cuda.empty_cache()
    heads = cfg.denoiser.num_heads
    for b, t, lens, name, bar in (
            (n_train, t_train, REFERENCE_M_LENS, "linear_attention", K8_BAR_DEVICE_MS["mask"]),
            (2, 1800, 1800, "linear_attention_serving", K8_BAR_DEVICE_MS["serving"])):
        q, k, v = (torch.from_numpy(rng.normal(size=(b, t, 128)).astype(np.float32)).cuda()
                   .to(torch.bfloat16) for _ in range(3))
        key_mask = (torch.arange(t, device="cuda")[None] < lens).float()[..., None].expand(b, t, 1)
        results.append(check_attention_kernel(q, k, v, key_mask, heads, bar_device_ms=bar)
                       | {"name": name, "bar_device_ms": bar})
    for r in results:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        shape = f" {r['shape']}" if "shape" in r and "kv_dtype" not in r else ""
        print(f"[kernel] {r['name']}{shape}: max_abs_err {r['max_abs_err']:.6g} "
              f"(plain max {r['ref_max_abs']:.6g}, {'ok' if r['ok'] else 'FAIL'}) "
              f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
              f"library {lib}")
        if r["name"].startswith("decoder_layer_bwd"):
            for name, (e, m) in zip(("dx", "demb", "dkvc", "dmats", "dvecs", "daw", "dab"),
                                    r["parts"]):
                print(f"[kernel]   {r['name']} {name}: err {e:.6g} (max {m:.6g})")
            print(f"[k6] {r['shape']}: repeat bit-identical {r['repeat_identical']}; device "
                  f"{r['device_ms']:.4f} ms a call by launch: "
                  + "; ".join(f"{k} {v:.4f}" for k, v in r["launch_split"])
                  + f"; bound {r['bound_ms']:.4f} ms ({r['bound_by']}); workspace "
                  f"{r['workspace_bytes']} bytes; yardsticks, device ms: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in r["yardsticks"].items())
                  + "; GEMM launches' bounds: "
                  + ", ".join(f"{k} {v['bound_ms']:.4f} ms ({v['bound_by']})"
                              for k, v in r["part_bounds"].items()) + f" ({smi})")
        k7 = r["name"].removesuffix("_gan").removesuffix("_f32")
        gan_k7 = r["name"].endswith("_gan")
        if k7 == "stgcn_backward":
            print(f"[kernel]   {r['name']} after the kernel's own forward (ReLU masks of "
                  f"another summation order): err {r['e2e_err']:.6g}, not bounded")
        if k7 in ("stgcn_forward", "stgcn_backward"):
            calls = "".join(f"; {k} {v:.4f} ms" for k, v in r.get("calls_ms", {}).items())
            old = r.get("old_bound")
            extra = (f"; old bound {old['bound_ms']:.4f} ms ({old['bound_by']})" if old else
                     f"; masks kept {r['mask_bytes']} bytes, {r['mask_flips']} of their "
                     f"{r['mask_bits']} bits other than the plain forward's (at most "
                     f"{K7_MASK_FLIP_SHARE:g} of them)")
            shape = (f"B={GAN_B} T={GAN_S * 30} (M2SGAN SyncLoss: the fake, the real)" if gan_k7
                     else f"B={n_train} T={t_train}")
            bar = ("" if gan_k7 or r["bar_met"] is None
                   else f" (bar <= {K7_BAR_MS}: bar_met {r['bar_met']})")
            plan_ok = "" if r["plan_ok"] is None else f"; plan the kernel's {r['plan_ok']}"
            print(f"[k7] {r['name']} {shape}: {r['ms']:.4f} ms a call by CUDA events"
                  f"{calls}{bar}; device "
                  f"{r['device_ms']:.4f} ms in {len(r['launch_split'])} launches, "
                  f"{r['launches_a_call']} of them K7's: "
                  + "; ".join(f"{k} {v:.4f}" for k, v in r["launch_split"])
                  + f"; bound {r['bound_ms']:.4f} ms ({r['bound_by']}){extra}; repeat "
                  f"bit-identical {r['repeat_identical']}{plan_ok} ({smi})")
        if "yardstick" in r:
            print(f"[kernel]   {r['name']}{shape}: device ms {r['device_ms']:.4f}, "
                  f"{r['yardstick']} {r['yardstick_device_ms']:.4f}: no slower than it: "
                  f"{r['no_slower_than_yardstick']}")
        if "kv_dtype" in r:
            print(f"[kernel]   {r['name']} {r['shape']}: bf16 q, k and v {r['kv_dtype']}")
            print(f"[k8] {r['name']} {r['shape']}, k and v {r['kv_dtype']}, clusters of "
                  f"{r['cluster']}: {r['ms']:.4f} ms a call by CUDA events, device "
                  f"{r['device_ms']:.4f} ms (bar <= {r['bar_device_ms']}), "
                  f"{r['launches_a_call']} launch a call, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), repeat bit-identical "
                  f"{r['repeat_identical']}: bar_met {r['bar_met']} ({smi})")
        if "tie_err" in r:
            print(f"[kernel]   max_pool_bwd on tied inputs: err {r['tie_err']:.6g} (must be 0)")
        if r["name"].startswith("sampler_"):
            bar = ("" if r["bar_device_ms"] is None else
                   f" (bar <= {r['bar_device_ms']}: bar_met {r['bar_met']})")
            print(f"[{'k3' if 'epilogue' in r['name'] else 'k2'}] {r['name']} B={r['shape'][0]} "
                  f"T={r['shape'][1]}: {r['ms']:.4f} ms a call by CUDA events, device "
                  f"{r['device_ms']:.4f} ms{bar}, {r['launches_a_call']} launch a call, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}), repeat bit-identical "
                  f"{r['repeat_identical']}, plan {r['plan']} the kernel's {r['plan_ok']} ({smi})")
        if "codes_differ" in r:
            print(f"[kernel]   {r['name']} codes: {r['codes_differ']} of {r['n_codes']} "
                  f"differ from the plain version's (at most 0.1 % may), by at most "
                  f"{r['code_max_diff']} (must be <= 1); wrong codes on exact ties: "
                  f"{r['tie_errors']} (must be 0)")
        if "mode_gap" in r:
            print(f"[kernel]   {r['name']}: the mode moves the plain output by "
                  f"{r['mode_gap']:.6g} at most, {r['mean_mode_gap']:.6g} on average, and the "
                  f"kernel's by {r['kernel_gap']:.6g} (must be >= half the largest); the "
                  f"kernel's mean distance from the plain version: {r['mean_abs_err']:.6g} "
                  f"(must be <= a quarter of the mean move)")
        for c in r.get("calls", []):
            lib = "none" if c["library_ms"] is None else f"{c['library_ms']:.4f} ms"
            extra = ""
            if "repeat_identical" in c:  # K4: beside its library call, a repeat
                if c["library_ms"] is not None:
                    extra = f" (kernel no slower: {c['ms'] <= c['library_ms']})"
                extra += f"; repeat bit-identical {c['repeat_identical']}"
            edge = f" {c['edge']}" if "edge" in c else ""
            print(f"[kernel]   {r['name']} {c.get('shape', '')}{edge}: err {c['max_abs_err']:.6g} "
                  f"(max {c['ref_max_abs']:.6g}) kernel {c['ms']:.4f} ms plain {c['plain_ms']:.4f} "
                  f"ms bound {c['bound_ms']:.4f} ms library {lib}{extra}")
        # the trainable encoder's kernels at stage 1's shapes or M2SGAN's
        # (``_gan``, B = 55 samples of 30 s), in bf16 or in their float32
        # modes (``_f32``); the bars are bf16 stage 1's
        f32 = r["name"].endswith("_f32")
        base = r["name"].removesuffix("_gan").removesuffix("_f32")
        gan_s1 = r["name"].endswith("_gan") or f32
        where = (f"M2SGAN B={GAN_B} T={GAN_S * 90}" if r["name"].endswith("_gan") else
                 f"stage 1 B={STAGE1_B} crops T={STAGE1_C * 90}"
                 + (f", float32 (bound {F32_REL_TOL:g} of the largest value; K11 "
                    f"{K11_F32_REL_TOL:g})" if f32 else ""))
        if base == "conv3x3_dkernel":
            print(f"[k9] {r['name']} {where}: {len(r['calls'])} calls, {r['ms']:.4f} ms by CUDA "
                  f"events, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}), library {r['library_ms']:.4f} ms, max_abs_err "
                  f"{r['max_abs_err']:.6g} (plain max {r['ref_max_abs']:.6g}): ok {r['ok']} ({smi})")
        if base == "max_pool_bwd":
            for c in r["calls"]:
                print(f"[k11] pool {c['pool']} x {c['shape']}: {c['ms']:.4f} ms by CUDA events, "
                      f"device {c['device_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
                      f"({c['bound_by']}), {c['launches_a_call']} launch a call, repeat "
                      f"bit-identical {c['repeat_identical']}; autograd's max_pool2d backward "
                      f"(another tie rule, not a yardstick) {c['reference_ms']:.4f} ms ({smi})")
            bars = ("" if gan_s1 else f" (bar <= {K11_BAR_MS})",
                    "" if gan_s1 else f" (bar <= {K11_BAR_DEVICE_MS})",
                    "" if gan_s1 else f", bar_met {r['bar_met']}")
            print(f"[k11] {r['name']} {where}, 3 pools: {r['ms']:.4f} ms by CUDA events{bars[0]}, "
                  f"device {r['device_ms']:.4f} ms{bars[1]}, bound {r['bound_ms']:.4f} ms, tie_err "
                  f"{r['tie_err']:.6g}: ok {r['ok']}{bars[2]} ({smi})")
        if base == "max_pool":
            for c in r["calls"]:
                print(f"[k10] pool {c['pool']} x {c['shape']}: {c['ms']:.4f} ms by CUDA events, "
                      f"device {c['device_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
                      f"({c['bound_by']}), F.max_pool2d {c['library_ms']:.4f} ms, "
                      f"{c['launches_a_call']} launch a call, err {c['max_abs_err']:.6g} (must "
                      f"be 0), repeat bit-identical {c['repeat_identical']}, plan {c['plan']} the "
                      f"kernel's {c['plan_ok']} ({smi})")
            bars = ("" if gan_s1 else f" (bar <= {K10_BAR_MS})",
                    "" if gan_s1 else f" (bar <= {K10_BAR_DEVICE_MS})",
                    "" if gan_s1 else f", bar_met {r['bar_met']}")
            print(f"[k10] {r['name']} {where}, 3 pools: {r['ms']:.4f} ms by CUDA events{bars[0]}, "
                  f"device {r['device_ms']:.4f} ms{bars[1]}, bound {r['bound_ms']:.4f} ms, "
                  f"F.max_pool2d {r['library_ms']:.4f} ms: ok {r['ok']}{bars[2]} ({smi})")
        if r["name"].startswith("conv_block"):
            lib = "" if r["library_ms"] is None else (
                f"; library {r['library_ms']:.4f} ms, device {r['library_device_ms']:.4f} ms")
            if "cudnn_conv_ms" in r:
                lib = (f"; cuDNN float32 F.conv2d of the 7 convs alone {r['cudnn_conv_ms']:.4f} ms"
                       f"; bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
            elif f32:
                lib += f"; bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
            print(f"[k4] {r['name']} (first input {r['calls'][0]['shape']}): {len(r['calls'])} calls, "
                  f"{r['ms']:.4f} ms by CUDA events, device {r['device_ms']:.4f} ms{lib}, max_abs_err "
                  f"{r['max_abs_err']:.6g} (plain max {r['ref_max_abs']:.6g}): ok {r['ok']} ({smi})")
    failed = [r["name"] for r in results if not r["ok"]]
    if failed:
        raise SystemExit(f"chip_smoke: kernels disagree with their plain versions: {failed}")

    # stage 2's steps on the training batch (phases 6, 8, 15 (f) and 16)
    def train(tr, m_lens=None):
        """4 steps on the training batch: losses, `loss_mot_feat`s, seconds
        and launch counts, each step's own."""
        losses, feats, times, step_counts = [], [], [], []
        for d in drawn:
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.train_step(mel_train, motion_train, m_lens, **d)
            losses.append(float(m["loss"]))  # host readback ends the step
            times.append(time.perf_counter() - t0)
            feats.append(float(m["loss_mot_feat"]))
            step_counts.append(launch_counts())
        return losses, feats, times, step_counts

    m_lens = torch.full((n_train,), REFERENCE_M_LENS)  # the reference's (phases 8, 16)

    # 16. the model widths beside the flagship's (`widths_phase`; its (e)
    # runs in phase 12), here beside phase 3's kernel checks.
    width_rows, width_counts = widths_phase(smi, cfg, feat_sd, mel, noise, mel_train,
                                            motion_train, train, m_lens,
                                            np.random.RandomState(16))

    # 4. the main path: generate through the kernels, ddim50, B = 2
    reset_launch_counts()
    out = kernel_tr.generate(mel, num_steps=50, noise=noise)
    torch.cuda.synchronize()
    counts = launch_counts()
    counts["adaln_modulation"] = part_launch_counts()["adaln_modulation"]
    ref = plain_tr.generate(mel, num_steps=50, noise=noise)
    err, scale = float((out - ref).abs().max()), float(ref.abs().max())
    finite = bool(torch.isfinite(out).all())
    print(f"[generate] ddim50 B=2 shape {tuple(out.shape)} finite {finite} "
          f"max_abs_err vs plain {err:.6g} (plain max {scale:.6g}) launches {counts}")
    if tuple(out.shape) != (2, 1800, 26) or not finite or not err <= GENERATE_REL_TOL * scale:
        raise SystemExit("chip_smoke: generate on the kernel path is wrong")
    if min(counts[k] for k in SERVING_KERNELS) == 0:
        raise SystemExit(f"chip_smoke: a kernel of the path was never launched: {counts}")
    if counts["adaln_modulation"] != 50:
        raise SystemExit(f"chip_smoke: K1 did not launch its AdaLN GEMM on every step: {counts}")

    # 5. timings on the kernel path
    mel1, noise1 = mel[:1].contiguous(), noise[:1].contiguous()
    kernel_tr.generate(mel1, num_steps=50, noise=noise1)  # warm-up
    _, t50 = _timed(lambda: kernel_tr.generate(mel1, num_steps=50, noise=noise1))
    _, t50_plain = _timed(lambda: plain_tr.generate(mel1, num_steps=50, noise=noise1))
    print(f"[time] ddim50 one 60-s clip: kernel path {t50 * 1e3:.1f} ms, "
          f"plain path {t50_plain * 1e3:.1f} ms ({smi})")

    mel8 = mel.repeat(4, 1, 1)
    noise8 = torch.from_numpy(rng.normal(size=(8, 1800, 26)).astype(np.float32)).cuda()
    enc_ms = time_ms(lambda: kernel_tr.fused_encoder(mel8), 3)
    motion8, t1000 = _timed(lambda: kernel_tr.generate(mel8, noise=noise8))
    if not bool(torch.isfinite(motion8).all()):
        raise SystemExit("chip_smoke: the ddim1000 ladder gave non-finite motion")
    fps = 8 * 1800 / t1000
    print(f"[time] ddim1000 B=8: {t1000:.3f} s, {fps:.1f} motion frames/s "
          f"(encoder {enc_ms:.2f} ms of it) on {smi}")

    # 6. training: kernel path, then the plain path, same weights and numbers
    losses_k, feats_k, times_k, step_counts = train(kernel_tr)
    losses_p, feats_p, times_p, _ = train(plain_tr)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p)]
    rel_feat = [abs(a - b) / abs(b) for a, b in zip(feats_k, feats_p)]
    per_step = [{k: c[k] for k in TRAIN_KERNELS} for c in step_counts]
    train_counts = {k: sum(c[k] for c in per_step) for k in TRAIN_KERNELS}
    print(f"[train] B={n_train} T={t_train} losses kernel {losses_k} plain {losses_p} "
          f"max rel diff {max(rel):.3g} launches {dict((k, train_counts[k]) for k in TRAIN_KERNELS)}")
    print(f"[train] loss_mot_feat kernel {feats_k} plain {feats_p} max rel diff "
          f"{max(rel_feat):.3g}; launches per step {per_step}")
    print(f"[time] train step B={n_train} T={t_train}: kernel path median "
          f"{np.median(times_k) * 1e3:.1f} ms, plain path median {np.median(times_p) * 1e3:.1f} ms "
          f"(per step: kernel {[round(x * 1e3, 1) for x in times_k]}, plain "
          f"{[round(x * 1e3, 1) for x in times_p]}) on {smi}")
    if (not all(np.isfinite(losses_k + feats_k)) or max(rel) > TRAIN_LOSS_REL_TOL
            or max(rel_feat) > TRAIN_LOSS_REL_TOL):
        raise SystemExit("chip_smoke: training on the kernel path disagrees with the plain path")
    if min(c[k] for c in per_step for k in TRAIN_KERNELS) == 0 or any(
            (c["stgcn_forward"], c["stgcn_backward"]) != K7_PER_STEP for c in per_step):
        raise SystemExit(f"chip_smoke: a training kernel was not launched in every step: {per_step}")
    counts.update({k: train_counts[k] for k in TRAIN_KERNELS})

    # 7. stage 1: kernel path, then the plain path, same weights and starts
    def train_s1(tr):
        losses, times, step_counts = [], [], []
        for st in starts:
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.train_step(music, motion_s1, "hard", starts=st)
            losses.append(float(m["loss"]))  # host readback ends the step
            times.append(time.perf_counter() - t0)
            step_counts.append({k: v for k, v in launch_counts().items() if k in STAGE1_KERNELS})
        return losses, times, step_counts

    m2s_plain.load_reference_state_dict(m2s_sd)
    losses_k1, times_k1, counts_s1 = train_s1(m2s_kernel)
    losses_p1, times_p1, _ = train_s1(m2s_plain)
    m2s_share = M2SNetTrainer(sample_length=STAGE1_S, clip_length=STAGE1_C, share_encodes=True,
                              device="cuda")
    m2s_share.load_reference_state_dict(m2s_sd)
    losses_s1, times_s1, _ = train_s1(m2s_share)
    rel1 = [abs(a - b) / abs(b) for a, b in zip(losses_k1, losses_p1)]
    print(f"[stage1] B={STAGE1_B} crops {STAGE1_C} s, hard, starts {starts}: losses kernel "
          f"{losses_k1} plain {losses_p1} max rel diff {max(rel1):.3g}; share_encodes kernel "
          f"losses {losses_s1}; launches per step {counts_s1}")
    print(f"[time] stage-1 step B={STAGE1_B}: kernel path median {np.median(times_k1) * 1e3:.1f} ms, "
          f"plain path median {np.median(times_p1) * 1e3:.1f} ms, share_encodes kernel path median "
          f"{np.median(times_s1) * 1e3:.1f} ms (per step: kernel "
          f"{[round(x * 1e3, 1) for x in times_k1]}, plain {[round(x * 1e3, 1) for x in times_p1]}, "
          f"share {[round(x * 1e3, 1) for x in times_s1]}) on {smi}")
    if not all(np.isfinite(losses_k1 + losses_s1)) or max(rel1) > TRAIN_LOSS_REL_TOL:
        raise SystemExit("chip_smoke: stage 1 on the kernel path disagrees with the plain path")
    if min(c[k] for c in counts_s1 for k in STAGE1_KERNELS) == 0 or any(
            c["max_pool"] != K10_PER_STEP for c in counts_s1):
        raise SystemExit(f"chip_smoke: a stage-1 kernel was not launched in every step: {counts_s1}")
    counts.update({k: sum(c[k] for c in counts_s1) for k in STAGE1_KERNELS if k != "conv_block"})

    # 8. training with the reference's loss mask: "auto" on CUDA, then the
    # plain float32 path with the mask, same weights, batch and numbers
    mask_cfg = cfg.replace(train=TrainConfig(replicate_reference_mask=True))
    mask_tr = DDPMTrainer(mask_cfg, device="cuda")
    md = mask_tr.cfg.denoiser
    if (md.compute_dtype, md.train_layer_impl, md.attention_impl, mask_tr.cfg.train.feat_impl) != (
            "bfloat16", "flax", "pallas", "pallas"):
        raise SystemExit(f"chip_smoke: 'auto' with the reference mask resolved to {md}")
    mask_plain = DDPMTrainer(mask_cfg.replace(
        denoiser=DenoiserConfig(layer_impl="flax", music_encoder_impl="flax",
                                train_layer_impl="flax", attention_impl="xla",
                                compute_dtype="float32"),
        train=TrainConfig(replicate_reference_mask=True, feat_impl="flax")), device="cuda")
    for tr in (mask_tr, mask_plain):
        tr.load_reference_state_dict(sd, motion_encoder=feat_sd)
    losses_m, feats_m, times_m, counts_m = train(mask_tr, m_lens)
    losses_mp, feats_mp, times_mp, _ = train(mask_plain, m_lens)
    rel_m = [abs(a - b) / abs(b) for a, b in zip(losses_m + feats_m, losses_mp + feats_mp)]
    mask_kernels = ("linear_attention", "stgcn_forward", "stgcn_backward")
    per_step_m = [{k: c[k] for k in mask_kernels} for c in counts_m]
    print(f"[mask] B={n_train} T={t_train} m_lens={REFERENCE_M_LENS}: losses kernel {losses_m} "
          f"plain {losses_mp}; loss_mot_feat kernel {feats_m} plain {feats_mp}; max rel diff "
          f"{max(rel_m):.3g}; launches per step {per_step_m}")
    print(f"[time] reference-mask train step B={n_train} T={t_train}: K8 path median "
          f"{np.median(times_m) * 1e3:.1f} ms, plain path median {np.median(times_mp) * 1e3:.1f} ms "
          f"(per step: K8 {[round(x * 1e3, 1) for x in times_m]}, plain "
          f"{[round(x * 1e3, 1) for x in times_mp]}) on {smi}")
    if not all(np.isfinite(losses_m + feats_m)) or max(rel_m) > TRAIN_LOSS_REL_TOL:
        raise SystemExit("chip_smoke: the reference-mask step disagrees with the plain path")
    if any(c["linear_attention"] != md.num_layers
           or (c["stgcn_forward"], c["stgcn_backward"]) != K7_PER_STEP for c in per_step_m):
        raise SystemExit(f"chip_smoke: K8 / K7 not launched as expected in every step: {per_step_m}")
    counts["linear_attention"] = sum(c["linear_attention"] for c in per_step_m)
    del mask_tr, mask_plain

    # 9. serving on the plain layers in bf16, K4 encoder and K8 attention
    flax_tr = DDPMTrainer(cfg.replace(denoiser=DenoiserConfig(layer_impl="flax")), device="cuda")
    fd = flax_tr.cfg.denoiser
    if (fd.compute_dtype, fd.attention_impl, fd.music_encoder_impl) != ("bfloat16", "pallas", "pallas"):
        raise SystemExit(f"chip_smoke: 'auto' with layer_impl='flax' resolved to {fd}")
    flax_tr.load_reference_state_dict(sd)
    reset_launch_counts()
    out_flax = flax_tr.generate(mel, num_steps=50, noise=noise)
    torch.cuda.synchronize()
    flax_counts = launch_counts()
    err_f = float((out_flax - ref).abs().max())
    print(f"[serve-flax] ddim50 B=2 bf16 plain layers: max_abs_err vs plain {err_f:.6g} (plain max "
          f"{scale:.6g}) launches {flax_counts}")
    if (tuple(out_flax.shape) != (2, 1800, 26) or not bool(torch.isfinite(out_flax).all())
            or not err_f <= GENERATE_REL_TOL * scale):
        raise SystemExit("chip_smoke: generate on the bf16 plain layers is wrong")
    if flax_counts["linear_attention"] != fd.num_layers * 50 or flax_counts["conv_block"] == 0:
        raise SystemExit(f"chip_smoke: K8 / K4 not launched as expected in serving: {flax_counts}")
    _, t_flax = _timed(lambda: flax_tr.generate(mel, num_steps=50, noise=noise))
    print(f"[time] ddim50 B=2 on the bf16 plain layers (K4, K8): {t_flax * 1e3:.1f} ms on {smi}")

    # 10. serving under bench.py's exact config: int8 AdaLN (K2 int8 output,
    # K1 int8 mode), then with the bf16-VPU mode added; then bench.py's
    # headline, ddim1000 at B = 8, best of 3 timed to the host readback
    del flax_tr
    bench_cfg = cfg.replace(denoiser=dataclasses.replace(cfg.denoiser, **BENCH_DENOISER))
    bench_counts = {}
    for label, vpu in (("bench", "float32"), ("bench+vpu_bf16", "bfloat16")):
        tr = DDPMTrainer(bench_cfg.replace(denoiser=dataclasses.replace(
            bench_cfg.denoiser, sampler_vpu_dtype=vpu)), device="cuda")
        tr.load_reference_state_dict(sd)
        reset_launch_counts()
        out_b = tr.generate(mel, num_steps=50, noise=noise)
        torch.cuda.synchronize()
        bc = launch_counts() | part_launch_counts()
        err_b = float((out_b - ref).abs().max())
        print(f"[serve-{label}] ddim50 B=2 int8 AdaLN, VPU {vpu}: max_abs_err vs plain float32 "
              f"{err_b:.6g} (plain max {scale:.6g}) launches {bc}")
        if (tuple(out_b.shape) != (2, 1800, 26) or not bool(torch.isfinite(out_b).all())
                or not err_b <= GENERATE_REL_TOL * scale):
            raise SystemExit(f"chip_smoke: generate under bench.py's config ({label}) is wrong")
        modes = ["decoder_stack_int8", "sampler_prologue_int8"] + (
            ["decoder_stack_vpu_bf16"] if vpu == "bfloat16" else [])
        if (any(bc[k] != 50 for k in modes) or bc["sampler_epilogue"] != 50
                or bc["adaln_modulation"] != 50):
            raise SystemExit(f"chip_smoke: the {label} modes did not run on every step: {bc}")
        bench_counts[label] = bc
        if vpu == "float32":
            bench_tr = tr
    del tr
    for k in ("decoder_stack_int8", "sampler_prologue_int8"):
        counts[k] = bench_counts["bench"][k]
    counts["decoder_stack_vpu_bf16"] = bench_counts["bench+vpu_bf16"]["decoder_stack_vpu_bf16"]
    counts["adaln_modulation_int8"] = bench_counts["bench"]["adaln_modulation"]
    # bench.py's compile call, then best of 3 on each config in turns
    best = {}
    for name, tr in (("bench.py serving (int8 AdaLN)", bench_tr), ("bf16", kernel_tr)):
        tr.generate(mel8, noise=noise8)
        times = []
        for _ in range(3):
            motion8, dt = _timed(lambda: tr.generate(mel8, noise=noise8))
            times.append(dt)
        if not bool(torch.isfinite(motion8).all()):
            raise SystemExit(f"chip_smoke: the {name} ddim1000 ladder gave non-finite motion")
        best[name] = (8 * 1800 / min(times), times)
    (fps_q, times_q), (fps_b, times_b) = best.values()
    print(f"[bench] ddim1000_60s_clip_motion_frames_per_sec_per_chip {fps_q:.1f} "
          f"(config: bench.py serving (int8 AdaLN); B=8, best of 3: {times_q} s) against "
          f"{fps_b:.1f} on the bf16 config (best of 3: {times_b} s; phase 5's one call: "
          f"{fps:.1f}), on {smi}")

    # 17. the rest of serving (a)-(d) on phase 4's mel and noise; (e), the
    # serving CLIs, runs in phase 12 on its default run
    for k, n in serving_phase(smi, cfg, plain_cfg, sd, mel, noise,
                              np.random.RandomState(17)).items():
        counts[k] += n

    # 11. M2SGAN: 4 WGAN-GP steps at B = 55 on each path, (a) "auto" (K4
    # frozen encoder, K7 bf16) beside the plain float32 path, (b) (a) with
    # the features and real SyncLoss latents cached, (c) the encoder
    # training on "auto" (bf16, K4's training modes, K9, K10, K11) beside
    # its bf16 witness on cuDNN and the float32 "lax" path; cuDNN
    # deterministic, so that (b) can repeat (a)
    del kernel_tr, plain_tr, bench_tr, tr, m2s_kernel, m2s_plain, m2s_share
    torch.cuda.empty_cache()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True

    def gan_steps(tr, cond, latents=None):
        """4 steps on the GAN batch: each step's metrics, seconds and launch
        counts, and the peak memory of the 4."""
        metrics, times, step_counts = [], [], []
        torch.cuda.reset_peak_memory_stats()
        for noise_i, alpha_i in gan_drawn:
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.train_step(cond, gan_real, latents, noise=noise_i, gp_alpha=alpha_i)
            metrics.append({k: float(v) for k, v in m.items()})  # host readback ends the step
            times.append(time.perf_counter() - t0)
            step_counts.append({k: v for k, v in launch_counts().items() if k in GAN_KERNELS})
        return metrics, times, step_counts, torch.cuda.max_memory_allocated()

    plain_kw = dict(music_encoder_impl="flax", sync_encoder_impl="flax",
                    sync_encoder_dtype="float32", compute_dtype="float32", music_conv_impl="lax")
    # (c)'s witness: its precision (a bf16 generator and SyncLoss) without
    # the kernels (the encoder on cuDNN, the SyncLoss module in bf16)
    witness_kw = plain_kw | dict(sync_encoder_dtype="bfloat16", compute_dtype="bfloat16")
    gan.load_reference_state_dict(*gan_sd, m2snet=m2s_sd)  # undo the check's statistics
    gan_runs = {"a": gan_steps(gan, gan_mel), "a_plain": gan_steps(gan_trainer(**plain_kw), gan_mel)}
    cached = gan_trainer(cached_features=True, cached_sync_latents=True)
    with torch.no_grad():
        feats, latents = cached.music_features(gan_mel), cached.sync_latents(gan_real)
    gan_runs["b"] = gan_steps(cached, feats, latents)
    del gan, cached, feats, latents
    torch.cuda.empty_cache()
    trains = gan_trainer(train_music_encoder=True)
    if (trains.compute_dtype, trains.music_conv_impl) != ("bfloat16", "pallas_train"):
        raise SystemExit("chip_smoke: 'auto' with train_music_encoder did not select the kernels")
    gan_runs["c"] = gan_steps(trains, gan_mel)
    del trains
    torch.cuda.empty_cache()
    gan_runs["c_bf16"] = gan_steps(gan_trainer(train_music_encoder=True, **witness_kw), gan_mel)
    gan_runs["c_plain"] = gan_steps(gan_trainer(train_music_encoder=True, **plain_kw), gan_mel)
    torch.backends.cudnn.deterministic = deterministic
    for name, (metrics, times, step_counts, peak) in gan_runs.items():
        print(f"[gan] ({name}) B={GAN_B} S={GAN_S} critic_iters={GAN_ITERS}: metrics "
              f"{metrics}; launches per step {step_counts}")
        print(f"[time] m2sgan step ({name}) B={GAN_B}: median {np.median(times) * 1e3:.1f} ms (per "
              f"step {[round(x * 1e3, 1) for x in times]}), peak memory {peak} bytes on {smi}")
    # every step: finite metrics and loss_sync within 3e-2 of the plain
    # path's; the first step, from the same weights, batch and numbers on
    # both sides, w_distance and loss_adv within 0.05, the JAX tests' bound
    # for one step of these paths.  (a) against the plain float32 path, (c)
    # against its bf16 witness: a bf16 generator's output moves by its
    # rounding far more than the kernels' summation orders move it, so
    # (c) against float32 is printed, not bounded.  Later steps diverge as
    # GAN updates do, and are printed.
    gan_bad = []
    for path, ref_path in (("a", "a_plain"), ("c", "c_bf16")):
        for i, (got, want) in enumerate(zip(gan_runs[path][0], gan_runs[ref_path][0])):
            if (not all(np.isfinite(list(got.values()) + list(want.values())))
                    or abs(got["loss_sync"] - want["loss_sync"]) > TRAIN_LOSS_REL_TOL * abs(
                        want["loss_sync"])
                    or (i == 0 and any(abs(got[k] - want[k]) > GAN_ADV_TOL
                                       for k in ("w_distance", "loss_adv")))):
                gan_bad.append((path, i, got, want))
    for path, ref_path in (("a", "a_plain"), ("c", "c_bf16"), ("c", "c_plain"),
                           ("c_bf16", "c_plain")):
        print(f"[gan] ({path}) against ({ref_path}) by step: "
              + "; ".join(f"w_distance {abs(g['w_distance'] - w['w_distance']):.6g}, loss_adv "
                          f"{abs(g['loss_adv'] - w['loss_adv']):.6g}, loss_sync rel "
                          f"{abs(g['loss_sync'] - w['loss_sync']) / abs(w['loss_sync']):.6g}"
                          for g, w in zip(gan_runs[path][0], gan_runs[ref_path][0])))
    if gan_bad:
        raise SystemExit(f"chip_smoke: the M2SGAN kernel paths disagree with the plain ones: {gan_bad}")
    if gan_runs["b"][0] != gan_runs["a"][0]:
        raise SystemExit("chip_smoke: the cached M2SGAN step did not repeat the uncached one bit "
                         "for bit")
    expect = {"a": lambda c: (c["conv_block"], c["stgcn_forward"], c["stgcn_backward"]) == (7, 2, 1),
              "b": lambda c: (c["conv_block"], c["stgcn_forward"], c["stgcn_backward"]) == (0, 1, 1),
              "c": lambda c: (min(c["conv_block"], c["conv3x3_dkernel"]) > 0
                              and (c["max_pool"], c["max_pool_bwd"]) == (6, 3)
                              and (c["stgcn_forward"], c["stgcn_backward"]) == (2, 1))}
    expect |= {path: lambda c: not any(c.values()) for path in ("a_plain", "c_bf16", "c_plain")}
    for path, ok in expect.items():
        if not all(ok(c) for c in gan_runs[path][2]):
            raise SystemExit(f"chip_smoke: M2SGAN path ({path}) did not launch its kernels as "
                             f"expected: {gan_runs[path][2]}")
    gan_counts = {k: sum(c[k] for path in "abc" for c in gan_runs[path][2]) for k in GAN_KERNELS}
    print(f"[gan] launches in phase 11's kernel paths (a), (b), (c): {gan_counts}")
    for k, n in gan_counts.items():
        counts[k] += n

    # 12. the stage-2 CLI on the card, beside phase 6's bare step (and phase
    # 16 (e), the CLI at --latent_dim 64, on its root); its work directory
    # stays for phase 18
    cli_counts, w64_cli_counts, serve_cli_counts, cli_work = cli_phase(
        smi, float(np.median(times_k)))
    for k, n in cli_counts.items():
        counts[k] += n
    for k, n in serve_cli_counts.items():  # phase 17 (e)
        counts[k] += n

    # 13. and 14. the stage-1 CLIs on one synthetic root, beside phase 7's
    # and phase 11's bare steps
    import os
    import shutil
    import tempfile

    from conductor_tpu_torch.data.dataset import make_synthetic_dataset

    work = tempfile.mkdtemp(prefix="chip_smoke_stage1_")
    try:
        for split in ("train", "test"):
            make_synthetic_dataset(os.path.join(work, "data"), split, num_clips=STAGE1_CLI_CLIPS)
        s1_counts, m2snet_ckpt, f32_cli_counts = m2snet_cli_phase(smi, work,
                                                                  float(np.median(times_k1)))
        for k, n in s1_counts.items():
            counts[k] += n
        for k, n in m2sgan_cli_phase(smi, work, m2snet_ckpt,
                                     float(np.median(gan_runs["a"][1]))).items():
            counts[k] += n
        # 18. denoiser dropout, and stage-2 evaluation on phase 12's default
        # run with phase 13's M2SNet checkpoint (its launches are added to
        # the kernels line after phase 15's counts are set)
        eval_counts = eval_phase(smi, cfg, sd, feat_sd, mel_train, motion_train, drawn,
                                 float(np.median(times_k)),
                                 os.path.join(cli_work, "ConductorMotion100", "defaults"),
                                 os.path.join(cli_work, "data"), m2snet_ckpt)
        # 19. data parallelism, on phase 12's root and run (its launches are
        # added to the kernels line with phase 18's)
        dp_counts = dp_phase(smi, cfg, plain_cfg, sd, feat_sd, mel_train, motion_train, drawn,
                             float(np.median(times_k)),
                             os.path.join(cli_work, "ConductorMotion100", "defaults"),
                             os.path.join(cli_work, "data"))
        # 20. a reference run directory in and out, on phase 12's run and
        # phase 13's checkpoint (its launches are added with phase 19's)
        ref_counts = reference_phase(smi, mel, noise,
                                     os.path.join(cli_work, "ConductorMotion100", "defaults"),
                                     os.path.join(cli_work, "data"), m2snet_ckpt)
        # 21. the t2m stack (no kernel of the kernels line runs in it)
        t2m_phase(smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(cli_work, ignore_errors=True)

    # 15. float32 on the kernels' float32 modes: (a) the stage-1 step, (b)
    # the M2SNet CLI (phase 13's (6)), (c) M2SGAN with the encoder training,
    # (d) generate with the float32 fused encoder
    f32_counts = dict(f32_cli_counts)

    def s1_steps(tr):
        """4 steps on phase 7's batch and starts: losses, seconds, launches
        by step, the state after the first step and the peak memory."""
        losses, times, step_counts, first = [], [], [], None
        torch.cuda.reset_peak_memory_stats()
        for st in starts:
            reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = tr.train_step(music, motion_s1, "hard", starts=st)
            losses.append(float(m["loss"]))  # host readback ends the step
            times.append(time.perf_counter() - t0)
            step_counts.append({k: v for k, v in launch_counts().items()
                                if k in STAGE1_KERNELS + STAGE1_F32_KERNELS})
            if first is None:
                first = {k: v.detach().float().clone() for k, v in tr.model.state_dict().items()}
        return losses, times, step_counts, first, torch.cuda.max_memory_allocated()

    s1_runs = {}
    for name, kw in (("f32_kernels", dict(compute_dtype="float32", music_conv_impl="pallas_train")),
                     ("f32_plain", dict(compute_dtype="float32", music_conv_impl="lax")),
                     ("bf16_kernels", {})):
        tr = M2SNetTrainer(sample_length=STAGE1_S, clip_length=STAGE1_C, device="cuda", **kw)
        tr.load_reference_state_dict(m2s_sd)
        s1_runs[name] = s1_steps(tr)
        del tr
    (lk, tk, ck, first_k, peak_k), (lp, tp, _, first_p, peak_p), (lb, tb, _, _, peak_b) = (
        s1_runs.values())
    rel = [abs(a - b) / abs(b) for a, b in zip(lk, lp)]
    param_diff = max(float((v - first_p[k]).abs().max()) for k, v in first_k.items())
    print(f"[f32] (a) stage-1 step B={STAGE1_B} crops {STAGE1_C} s, hard, float32 on the kernels: "
          f"losses {lk} against the plain float32 path's {lp}: rel diff {[f'{x:.3g}' for x in rel]} "
          f"(first <= {F32_FIRST_LOSS_RTOL}, each <= {F32_LOSS_RTOL}); largest parameter or "
          f"statistic difference after step 1 {param_diff:.6g} (<= {F32_PARAM_ATOL}); launches "
          f"per step {ck}")
    print(f"[time] (a) stage-1 step B={STAGE1_B}, median ms: float32 kernels "
          f"{np.median(tk) * 1e3:.1f}, plain float32 {np.median(tp) * 1e3:.1f}, bf16 kernels "
          f"{np.median(tb) * 1e3:.1f} (per step {[round(x * 1e3, 1) for x in tk]}, "
          f"{[round(x * 1e3, 1) for x in tp]}, {[round(x * 1e3, 1) for x in tb]}); peak memory "
          f"{peak_k}, {peak_p}, {peak_b} bytes on {smi}")
    if (not all(np.isfinite(lk)) or not rel[0] <= F32_FIRST_LOSS_RTOL or not max(rel) <= F32_LOSS_RTOL
            or not param_diff <= F32_PARAM_ATOL):
        raise SystemExit("chip_smoke: the float32 stage-1 step on the kernels disagrees with the "
                         "plain float32 path")
    if any({k: c[k] for k in STAGE1_F32_KERNELS} != F32_PER_STEP
           or any(c[k] for k in STAGE1_KERNELS) for c in ck):
        raise SystemExit(f"chip_smoke: the float32 stage-1 step did not launch the float32 modes "
                         f"as expected: {ck}")
    for k in STAGE1_F32_KERNELS:
        f32_counts[k] += sum(c[k] for c in ck)
    del s1_runs, first_k, first_p
    torch.cuda.empty_cache()

    # (c) M2SGAN with the encoder training in float32 on the kernels, the
    # SyncLoss on the plain float32 module as phase 11's float32 witness
    # (c_plain), cuDNN deterministic as there
    torch.backends.cudnn.deterministic = True
    f32_gan = gan_trainer(train_music_encoder=True, compute_dtype="float32",
                          music_conv_impl="pallas_train", sync_encoder_impl="flax",
                          sync_encoder_dtype="float32")
    metrics, times, gan_f32_counts, peak = gan_steps(f32_gan, gan_mel)
    del f32_gan
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = deterministic
    witness, w_times, _, w_peak = gan_runs["c_plain"]
    rel = {k: abs(metrics[0][k] - witness[0][k]) / abs(witness[0][k])
           for k in ("loss_sync", "w_distance", "loss_adv")}
    print(f"[f32] (c) M2SGAN B={GAN_B} S={GAN_S}, the encoder training in float32 on the kernels: "
          f"metrics {metrics}; first step against phase 11's float32 witness (c_plain) "
          + ", ".join(f"{k} rel {v:.3g}" for k, v in rel.items())
          + f" (<= {F32_LOSS_RTOL}); launches per step {gan_f32_counts}")
    print(f"[time] (c) m2sgan step B={GAN_B}, float32 encoder on the kernels: median "
          f"{np.median(times) * 1e3:.1f} ms (per step {[round(x * 1e3, 1) for x in times]}), peak "
          f"memory {peak} bytes; the witness on cuDNN {np.median(w_times) * 1e3:.1f} ms, {w_peak} "
          f"bytes, on {smi}")
    if (not all(np.isfinite(list(m.values())).all() for m in metrics)
            or not max(rel.values()) <= F32_LOSS_RTOL):
        raise SystemExit("chip_smoke: M2SGAN with the float32 encoder on the kernels disagrees "
                         "with its float32 witness")
    if any({k: c[k] for k in STAGE1_F32_KERNELS} != GAN_F32_PER_STEP
           or any(c[k] for k in GAN_KERNELS if k not in STAGE1_F32_KERNELS)
           for c in gan_f32_counts):
        raise SystemExit(f"chip_smoke: M2SGAN's float32 encoder did not launch the float32 modes "
                         f"as expected: {gan_f32_counts}")
    for k in STAGE1_F32_KERNELS:
        f32_counts[k] += sum(c[k] for c in gan_f32_counts)

    # (d) generate, ddim50 at B = 2 on phase 4's mel and noise, the float32
    # fused encoder (K4's float32 serving mode) and the plain float32 layers
    f32_tr = DDPMTrainer(cfg.replace(
        denoiser=DenoiserConfig(compute_dtype="float32", music_encoder_impl="pallas",
                                layer_impl="flax", train_layer_impl="flax", attention_impl="xla"),
        train=TrainConfig(feat_impl="flax")), device="cuda")
    f32_tr.load_reference_state_dict(sd)
    reset_launch_counts()
    out_f32 = f32_tr.generate(mel, num_steps=50, noise=noise)
    torch.cuda.synchronize()
    gen_counts = launch_counts()
    with torch.no_grad():
        enc_k, enc_p = f32_tr.fused_encoder(mel), f32_tr.music_features(mel)
    err_feat, feat_scale = float((enc_k - enc_p).abs().max()), float(enc_p.abs().max())
    err_mot = float((out_f32 - ref).abs().max())
    _, t_f32 = _timed(lambda: f32_tr.generate(mel, num_steps=50, noise=noise))
    print(f"[f32] (d) generate ddim50 B=2, float32 fused encoder, plain float32 layers: encoder "
          f"features max_abs_err {err_feat:.6g} against the plain encoder's (max {feat_scale:.6g}, "
          f"bound {F32_FEATURE_TOL:g} of it); motion max_abs_err {err_mot:.6g} against the plain "
          f"float32 path's (max {scale:.6g}, bound {F32_MOTION_TOL:g} of it); launches {gen_counts}")
    print(f"[time] (d) ddim50 B=2, float32 fused encoder and plain float32 layers: "
          f"{t_f32 * 1e3:.1f} ms on {smi}")
    if (tuple(out_f32.shape) != (2, 1800, 26) or not bool(torch.isfinite(out_f32).all())
            or not err_feat <= F32_FEATURE_TOL * feat_scale or not err_mot <= F32_MOTION_TOL * scale):
        raise SystemExit("chip_smoke: generate with the float32 fused encoder is wrong")
    if gen_counts["conv_block_f32"] != 7 or any(n for k, n in gen_counts.items()
                                                if k != "conv_block_f32"):
        raise SystemExit(f"chip_smoke: the float32 generate did not launch K4's float32 mode "
                         f"alone, 7 times: {gen_counts}")
    del f32_tr

    # (d') (d) with the plain layers' self-attention on K8, float32 q, k and v
    k8_tr = DDPMTrainer(cfg.replace(
        denoiser=DenoiserConfig(compute_dtype="float32", music_encoder_impl="pallas",
                                layer_impl="flax", train_layer_impl="flax",
                                attention_impl="pallas"),
        train=TrainConfig(feat_impl="flax")), device="cuda")
    k8_tr.load_reference_state_dict(sd)
    reset_launch_counts()
    out_k8 = k8_tr.generate(mel, num_steps=50, noise=noise)
    torch.cuda.synchronize()
    k8_counts = {k: n for k, n in launch_counts().items() if n}
    err_k8 = float((out_k8 - ref).abs().max())
    _, t_k8 = _timed(lambda: k8_tr.generate(mel, num_steps=50, noise=noise))
    print(f"[f32] (d') generate ddim50 B=2, float32 fused encoder, plain float32 layers, K8 on "
          f"float32 q, k and v: motion max_abs_err {err_k8:.6g} against the plain float32 path's "
          f"(max {scale:.6g}, bound {F32_MOTION_TOL:g} of it); launches {k8_counts}")
    print(f"[time] (d') ddim50 B=2, float32 plain layers with K8: {t_k8 * 1e3:.1f} ms (d: "
          f"{t_f32 * 1e3:.1f} ms) on {smi}")
    if (tuple(out_k8.shape) != (2, 1800, 26) or not bool(torch.isfinite(out_k8).all())
            or not err_k8 <= F32_MOTION_TOL * scale):
        raise SystemExit("chip_smoke: the float32 generate with K8 is wrong")
    if k8_counts != {"conv_block_f32": 7, "linear_attention": cfg.denoiser.num_layers * 50}:
        raise SystemExit(f"chip_smoke: the float32 generate with K8 did not launch K4's float32 "
                         f"mode 7 times and K8 8 x 50 times alone: {k8_counts}")
    del k8_tr

    # (e) serving on the fused ladder's float32 mode: ddim50 at B = 2 on phase
    # 4's mel and noise (K4 float32, then K2 / K1 / K3 in float32 every step),
    # within F32_MOTION_TOL of phase 4's plain float32 path; then with bf16
    # VPU and with int8 AdaLN on top, within the 3 % ladder bound of those
    # modes; each the launches F32_LADDER says and no other, its ms beside (d)'s
    ladder_counts = {}
    for label, (extra, modes) in F32_LADDER.items():
        tr = f32_ladder_trainer(extra)
        reset_launch_counts()
        out_e = tr.generate(mel, num_steps=50, noise=noise)
        torch.cuda.synchronize()
        ec = {k: n for k, n in (launch_counts() | part_launch_counts()).items() if n}
        err_e = float((out_e - ref).abs().max())
        tol = F32_MOTION_TOL if label == "f32" else GENERATE_REL_TOL
        _, t_e = _timed(lambda: tr.generate(mel, num_steps=50, noise=noise))
        print(f"[f32] (e) generate ddim50 B=2 on the fused ladder, {label}: motion max_abs_err "
              f"{err_e:.6g} against the plain float32 path's (max {scale:.6g}, bound {tol:g} of "
              f"it); launches {ec}")
        print(f"[time] (e) ddim50 B=2 on the fused ladder, {label}: {t_e * 1e3:.1f} ms (d, the "
              f"plain float32 layers: {t_f32 * 1e3:.1f} ms) on {smi}")
        if (tuple(out_e.shape) != (2, 1800, 26) or not bool(torch.isfinite(out_e).all())
                or not err_e <= tol * scale):
            raise SystemExit(f"chip_smoke: generate on the float32 fused ladder ({label}) is wrong")
        if ec != {"conv_block_f32": 7, **dict.fromkeys(modes, 50)}:
            raise SystemExit(f"chip_smoke: the float32 fused ladder ({label}) did not launch its "
                             f"modes as expected: {ec}")
        ladder_counts.update({k: ec[k] for k in modes if k.endswith(("_f32", "_f32_int8",
                                                                      "_f32_vpu_bf16"))})
        del tr
    counts.update(f32_counts, conv_block_f32=gen_counts["conv_block_f32"],
                  conv_block_train_f32=f32_counts["conv_block_f32"], **ladder_counts)

    # (f) stage 2 in float32 on K5 / K6's and K7's float32 modes: 4 steps on
    # phase 6's weights, batch and random numbers, against phase 6's plain
    # float32 path
    losses_f, feats_f, times_f, counts_f = train(f32_train)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses_f, losses_p)]
    rel_feat = [abs(a - b) / abs(b) for a, b in zip(feats_f, feats_p)]
    per_step = [{k: n for k, n in c.items() if n} for c in counts_f]
    print(f"[f32] (f) stage-2 step B={n_train} T={t_train}, float32 on K5 / K6 / K7: losses "
          f"{losses_f} against phase 6's plain float32 path's {losses_p}: rel diff "
          f"{[f'{x:.3g}' for x in rel]}, largest {max(rel):.3g} (first <= "
          f"{F32_FIRST_LOSS_RTOL}, each <= {F32_LOSS_RTOL}); loss_mot_feat rel diff "
          f"{[f'{x:.3g}' for x in rel_feat]} (each <= {F32_LOSS_RTOL}); launches per step "
          f"{per_step}")
    print(f"[time] (f) train step B={n_train} T={t_train}, median ms: float32 on K5 / K6 / K7 "
          f"{np.median(times_f) * 1e3:.1f}, plain float32 (phase 6) "
          f"{np.median(times_p) * 1e3:.1f}, bf16 kernels (phase 6) {np.median(times_k) * 1e3:.1f} "
          f"(per step {[round(x * 1e3, 1) for x in times_f]}) on {smi}")
    if (not all(np.isfinite(losses_f + feats_f)) or not rel[0] <= F32_FIRST_LOSS_RTOL
            or not max(rel) <= F32_LOSS_RTOL or not max(rel_feat) <= F32_LOSS_RTOL):
        raise SystemExit("chip_smoke: the float32 stage-2 step on K5 / K6 / K7 disagrees with the "
                         "plain float32 path")
    if any(c != {"decoder_layer_f32": cfg.denoiser.num_layers,
                 "decoder_layer_bwd_f32": cfg.denoiser.num_layers,
                 "stgcn_forward_f32": K7_PER_STEP[0], "stgcn_backward_f32": K7_PER_STEP[1]}
           for c in per_step):
        raise SystemExit(f"chip_smoke: the float32 stage-2 step did not launch K5 / K6's float32 "
                         f"mode alone, once a layer, and K7's as phase 6 does: {per_step}")
    for k in TRAIN_F32_KERNELS:
        counts[k] += sum(c[k] for c in counts_f)
    del f32_train

    # phase 16's rows and launches (it ran after phase 3; its (e) in phase 12)
    results += width_rows
    counts.update(width_counts)
    counts["decoder_layer_w64"] += w64_cli_counts["decoder_layer"]
    counts["decoder_layer_bwd_w64"] += w64_cli_counts["decoder_layer_bwd"]
    print(f"[widths] (e)'s CLI run at D = 64 (phase 12): launches {w64_cli_counts}")
    for k, n in (*eval_counts.items(), *dp_counts.items(), *ref_counts.items()):  # 18-20
        counts[k] = counts.get(k, 0) + n

    kernels = []
    for r in results:
        if r["name"] not in KERNEL_SOURCES:  # K4's training modes and B = 8, reported above
            continue
        source, replaces = KERNEL_SOURCES[r["name"]]
        kernels.append({
            "name": r["name"], "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[r["name"]], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        } | {k: r[k] for k in YARDSTICK_KEYS if k in r})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp19-worker"]:  # a rank of phase 19, started by dp_phase
        sys.exit(dp_worker(sys.argv[2]))
    if sys.argv[1:2] == ["--dp19-wave-worker"]:  # a rank of phase 19 (c)'s 4-rank wave
        sys.exit(dp_wave_worker(sys.argv[2]))
    sys.exit(main())
