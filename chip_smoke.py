#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (msla_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when its check fails:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA sources in msla_tpu_torch/csrc with nvcc, one process per
     source, in parallel, and print what ptxas reports (registers, spills);
  3. the serving kernels (K1 conv_stem, K2 deconv_stem, K3 nearest_codes)
     against their plain PyTorch versions on the card, at the shapes of a
     batch-64 separation (stems at atol = rtol = 1e-4, and against fp64
     within their 3xTF32 accumulation bound, stem_accumulation_bound, also
     at ragged T for K1 and ragged W for K2; every nearest-code mismatch
     must be a near-tie, also at ragged N, RAGGED_N; planted ties must go to
     the lower index and planted close pairs 1e-4 apart, which one TF32 pass
     would get wrong, to the nearer code, vq_planted), with median times
     over 20 CUDA-event-timed runs of the kernel, its plain version and one
     library call;
  4. the serving path through the user's entry points: the full-width VQ-VAE
     (configs/model/vqvae.yaml) with seeded random weights,
     SourceSeparator.separate (plain and overlap) and encode_codes on a 60 s
     22 kHz mixture, and a timed batch-64 separation; every serving kernel's
     launch count must grow and every output be finite;
  5. the card against the port on the CPU (plain versions) on 2 frames;
  6. the training kernels (K1b, K2b: the stems' save-hidden forwards, held
     as in phase 3, hidden included; #4 vq_fused_fwd; #5 vq_codebook_grad)
     against their plain versions at the shapes of a batch-64 train step,
     timed as in phase 3; #4 also on planted ties and close pairs and at N =
     704,001 (q = codebook[id] bit for bit, counts a bincount, sq within
     1e-5 of fp64 and the same bits twice); #5 (csrc/segment_sum.cuh) on
     the seeded model's ids of the first batch, uniform ids, one code for
     every row and sorted runs, each timed, and at N = 1, 31, 33, 4,097 and
     704,001 (RAGGED_GRAD_N): bit-equal to codebook_grad_order_ref at the
     card's grid, within segment_sum_bound against fp64 (its largest share
     printed) and the same bits twice, with the scratch bytes and CUDA
     launches of one call, measured (call_footprint);
  7. gradients on 2 frames of the full-width model: loss and every parameter
     gradient through the kernels against the same loss written with the
     plain versions and torch's autograd on the card (atol 1e-4, rtol 1e-3),
     and one train step on the card against the same step on the CPU,
     masking off;
  8. the training path through the user's entry point: Trainer.fit of the
     full-width model on synthetic batch-64 stems with masking on (6 train
     and 2 validation batches); every training kernel's launch count must
     grow, every loss and metric be finite, every parameter move and the
     codebook CSV be written; then a train step's device time (CUDA events)
     and its parts, fit's host time per step and the peak device memory;
  9. the Audio-BERT kernels against their plain versions on the card: #7
     flash_attn at one layer's shapes of the batch-16 call (352 sequences x
     12 heads x 512 x 64, rows of padding and sequences of padding alone
     included; atol = rtol = 1e-4; against fp64 within the 3xTF32
     accumulation bound, its share printed beside the plain fp32 chain's;
     and at ragged S = 130 and 401, the latter at sm_scale 0.1), #6
     mlm_argmax and mlm_argmax_conf (3xTF32 on the tensor cores) at M =
     180,224 rows (all rows compared: every
     differing id a near-tie, conf at rtol 1e-4 and the same bits twice, the
     two variants' ids equal), on planted ties (the lowest index must win),
     on planted close pairs 1e-4 apart that one TF32 pass would tie (the
     larger must win, the gap within what the accumulation may lose) and on
     coherent rows (logits of 83 whose terms all add: the kernel's error
     against fp64 within that bound, printed beside cuBLAS fp32's), each
     timed as in phase 3 beside one library call;
 10. the Audio-BERT serving path through the user's entry points: an
     AudioGenerator over the full-width bert-base AudioBertTask (seed 0)
     and phase 8's VQ-VAE, with its codebook CSV: batch-16
     corrupt_and_generate on 2 s stems (timed: median of 5 host-clock calls,
     the device time by CUDA events, and its parts), sample_codes at
     W = 11,000 and generate_waveform; both #6 variants' and #7's launch
     counts must grow, every output be finite and every code in [0, 512);
 11. the card against the CPU (plain versions) on code_proposals of one row
     of 1,000 codes (two windows, the second partly padding);
 12. the VQ measurement tools through their entry points at their full
     N = 704,000 rows (msla_tpu_torch.tools.bench_vq_lean and
     bench_vq_precision, main(device="cuda")): #8 vq_lean_fwd and the launch
     counts of #8, #9's new modes, #4 and #5 must grow; then #8 (both
     regimes) and #9's bf16/split2, bf16/f32, split3/split2 forwards and
     split2 gradient against their plain versions on the tools' own inputs
     (every differing id a near-tie on the mode's own distance, q and counts
     bit-equal where the ids are, sq at rtol 1e-5, plus the lean form's
     cancellation bound; the gradient within 1e-5 of max |plain| and the
     same bits twice, then checked and timed as #5 in phase 6), each timed
     as in phase 3 beside one library chain;
 13. the bf16 separation kernels (K1 and K2 on bf16 operands, the Pallas
     kernel's function) against their plain bf16 versions at batch 64
     (within 2 bf16 ulps; the bit-equal share printed), K1 in bf16 at
     lengths T not divisible by 4, K2 and K2b in bf16 at widths W around
     their 120-position tile (the hidden within 2 ulps, the output within 2
     ulps of the plain second layer on the kernel's own hidden, K2's equal
     to K2b's), each timed beside the cuDNN bf16 pair;
 14. the bf16 separation path through the user's entry points:
     SourceSeparator over VQVAETask(compute_dtype="bfloat16") with phase 8's
     weights, a 60 s song, then timed separations at batch 64 and at
     fast_serving's 128 (configs/experiment/fast_serving.yaml); K1 and K2
     must launch in bf16 and K3 in fp32, in the run and in each timed
     separation (counts read before any timing), then device time and parts;
 15. its codes, card against the CPU's plain bf16 path on 2 frames: at
     least 99 % equal, each differing code a near-tie on the card's latents;
 16. the bf16 Audio-BERT kernels (#7, #6, #6b on bf16 operands) against their
     plain bf16 versions at the batch-16 call's shapes: #7 within
     2·2⁻⁹·Σ p|v| + 1e-5 (also at ragged S), every #6 id equal or a near-tie, planted ties to
     the lowest index, conf at rtol 1e-4 (also at M = 1, 129, 257 and at
     V = 100, MLM_SMALL), timed beside bf16 SDPA and a bf16 addmm chain;
     the first #6 bf16 kernel (csrc/mlm_argmax_probe.cu) and its three
     probes timed beside its successor;
 17. the bf16 Audio-BERT serving path: AudioGenerator over a bf16 bert-base
     AudioBertTask and the bf16 VQ-VAE, as phase 10, timed and in parts;
 18. its code_proposals, card against the CPU's plain bf16 path;
 19. the bf16 training kernels (K1b and K2b on bf16 operands) against their
     plain bf16 versions at a batch-64 train step's shapes (out within 2 bf16
     ulps or check_bf16's hidden-flip bound, the hidden within 2 ulps), K1b
     in bf16 at lengths T not divisible by 4, K2b at the ragged W of phase
     13, timed beside the cuDNN bf16 pair;
 20. one batch-64 bf16 step's loss and gradients through the kernels against
     plain_loss on plain bf16 ops (each gradient within twice bf16's own
     distance from the fp32 step's), and each module's distance from fp32;
 21. the bf16 training path through the user's entry point: Trainer.fit of
     VQVAETask(compute_dtype="bfloat16") at batch 64 and at large_batch's 128
     (configs/experiment/large_batch.yaml), masking on, with ModelCheckpoint,
     EarlyStopping and a CSVLogger in a temporary default_root_dir; the
     launch counts read right after each fit must be exactly K1b/K2b in bf16
     and #5 in fp32 once a step, #4 once a batch, K1/K2 in bf16 once a
     validation batch, and K1, #4 and K2 once more for the audio demo of
     the first; the checkpoints and metrics.csv must exist; a resume
     by fit(ckpt_path="last") must stop at the saved step and epoch with the
     saved weights bit for bit, and go on; the fp32-vs-bf16 code flips of
     the first batch's latents; each batch's step device time and parts,
     samples/s through fit's loop and peak memory;
 22. the command line on the card, from WAV files on disk: a Slakh-shaped
     fixture (4 stems a track, 16-bit PCM at Slakh's 44.1 kHz, enough for 2
     train batches and 1 validation and 1 test batch of 64 frames of 2 s)
     cleaned by the port's SlakhDataset (decode and 44,100 → 22,000 Hz
     resampling through the native IO library; timed), the loader's
     batch-64 assembly timed with num_workers 1 and 0, phase 10's bert-base
     weights written as best_bert.ckpt, then msla_tpu_torch.main.main with
     train_vqvae=True (configs/train.yaml's full-width VQ-VAE at batch 64,
     masking on, a CSV logger) in process: fit, test, generate and
     visualize each timed on the host clock and counted; K1b, K2b, #4, #5
     (fit), K1, K2 (test), K1, K3 (visualize), K1, K3, #6, #7 (generate)
     must launch in fp32; the checkpoints, codebook CSV, demo and generated
     WAVs and the 15 SVGs must exist and test/loss be finite; fit's
     samples/s and device busy share (a CUDA-only torch.profiler trace of
     fit) printed beside phase 8's;
 23. Audio-BERT training through the command line in phase 22's project:
     python -m msla_tpu_torch train_bert=True in process (bert-base at full
     width, batch 64, fp32, 3 epochs of 2 train and 1 validation batch, the
     frozen teacher from phase 22's best_vqvae.ckpt, a CSV logger), then
     generate from the port-trained best_bert.ckpt; the launches of fit, test,
     generate and a step exact (K1 and K3 once a batch, #6 3 and #7 36 times
     a batch-64 step, 1 and 12 a one-frame demo or predict call); BERT and
     the codebook bit-unchanged and the head moved; one frozen-*.ckpt and
     checkpoints of the head plus AdamW's size; a resume from last.ckpt
     bit-exact for one further step; frame 0's teacher and BERT ids card
     against CPU (>= 99.9 % equal, each difference a near-tie) and the head's
     gradient card against CPU on the card's code ids (atol 1e-4, rtol
     1e-3); Trainer.predict from best_bert.ckpt over the 65 test frames;
     then the step's device time in parts, samples/s, one save_checkpoint's
     and the sidecar's seconds and bytes, peak memory, and K1, K3, #6 and #7
     re-timed on the path's own inputs; its fit writes its checkpoints in
     the background, and phase 24 prints its seconds and busy share beside
     the figures PERF.md §5 records from when they were written in the loop;
 24. the transformer stage in phase 22's project, over its best_vqvae.ckpt:
     python -m msla_tpu_torch train_transformer=True, then with
     experiment=moe_transformer, in process (configs/model/transformer.yaml
     at full width: 4 layers, 8 heads, hidden 512, fp32, batch 64, T =
     44,000, W = 11,000; 3 and 2 epochs of the fixture's 2 train and 1
     validation batch, 1 test batch; a CSV logger): fit's and test's
     seconds, samples/s and busy share, K1 and K3 launches exact (once a
     batch and a demo), the checkpoints on disk and each write's seconds in
     the loop (the snapshot) beside the writer's seconds and its bytes; one
     batch-64 step in parts (augment and teacher, forward, backward, Adam;
     CUDA events, median of 5) beside each part's bound, in fp32, bf16 and
     the MoE preset, with K1 and K3 once a step and the peak memory; the
     fp32 forward card against CPU on the teacher's latents (atol = rtol =
     1e-4); one batch-64 step with remat=True at dropout 0.1 against one
     without from the same weights and generator state (the gradients equal,
     bit for bit where the card's sums repeat, within 1e-5 of each tensor's
     largest in any case, and a step on another generator state different),
     each step's ms and peak, and the stepped state's save_checkpoint exact
     and with wire="q8" (seconds and bytes); K1 and K3 re-timed on the
     path's inputs; then the project is removed, the fixture kept;
 25. the rest of the trainer at full width on phase 22's fixture: (a)
     python -m msla_tpu_torch experiment=vqvae_slakh in process
     (trainer.max_epochs cut from 10 to 2; its tensorboard logger; fit,
     test, visualize and generate timed and counted as in phase 22), the
     event files read back by read_events with every record's two CRCs
     checked, each scalar's tag, step and value those the Trainer logged,
     in order, and the hparams text; (b) one optimizer step of
     accumulate_grad_batches=2 at batch 32 and one step at batch 64 on the
     same 64 examples from the same weights (masking off): the mean
     gradients within atol 1e-4 of each tensor's largest and rtol 1e-3, the
     updated parameters within atol = rtol = 1e-4 where the gradient is
     clear of 0, K1b, K2b, #4 and #5 launched exactly 2 times a step (1 at
     batch 64), each step's ms and peak, and the four kernels re-timed on a
     batch-32 microbatch; (c) one epoch with profiler="jax" after the same
     epoch untraced: the trace must hold the stem, fused-VQ and segment-sum
     kernels among its device events, its five costliest device ops
     printed; (d) last.ckpt written exact, bf16 and q8 (bytes, seconds),
     every decoded tensor within its codec's bound, and fit resumed one step
     from the q8 file; (e) the same state as a JAX msgpack checkpoint
     written by the script (msgpack_pack, jax_checkpoint: the card has no
     flax or msgpack), fit resumed one step from it and from the port's file
     of the same state, the two bit for bit; then the fixture is removed;
 26. the kernels at every width configs/hparams_search/optuna.yaml samples,
     at batch 32 and full length (T = 44,000, W = 11,000): K1, K1b, K2 and
     K2b at num_hidden 64, 128 and 256 (all 3xTF32; at 256 W2′ in groups and
     h's channels over a cluster) against their plain versions (atol = rtol
     = 1e-4), against fp64 within their 3xTF32 accumulation bound on 4
     items, output and hidden, at ragged T and W around their tiles, the
     same bits twice, each printed beside the cuDNN pair; K3, #4
     and #5 at each (K, D) of {128, 256, 512} x {64, 128, 256} (the codebook
     through a TMA ring at D = 128 and 256, #5 over D / 64 column slices) at
     N = 352,000: ids equal to the plain version's or near-ties, planted ties
     and close pairs and ragged N at each D, #4's fields as in phase 6, #5
     bit-equal to codebook_grad_order_ref at the card's grid of each slice,
     within segment_sum_bound, the same bits twice; each timed (median of 5)
     beside its plain version and a library call, with ptxas's registers
     (the ring kernels must not spill) and its shared memory (K3's and #4's
     as csrc/nearest_codes.cu reports it, which must equal what the
     wrappers admit K by);
 27. the sweep through the command line: python -m msla_tpu_torch -m
     hparams_search=optuna, then hparams_search=optuna_smoke, in process on
     a 22 kHz fixture of 4 tracks a split (260 frames: one batch of 256),
     with train_vqvae=True, one epoch of one train, validation and test
     batch, and each trial's checkpoints in its run directory, nothing swept
     overridden (10 trials of seed 1234, batch 32 to 256, and 2): every trial
     must complete, its trial_result.json finite, and its launches by
     instantiation meet the prediction (TRIAL_LAUNCHES), each trial's
     seconds and peak memory printed; the fixture stays for phase 30;
 28. data parallelism at world size 1, the one card's most (NCCL takes one
     rank a device; the checks with several ranks are the CPU tests'): (a)
     in process, RANK=0 WORLD_SIZE=1 and a MASTER_ADDR/PORT, then
     setup_distributed(), which must give NCCL at world size 1; phase 8's
     Trainer.fit (full width, batch 64, masking on, seed 0, from phase 8's
     starting weights) once without a group and once under it, cuDNN
     deterministic for both: the parameters must be bit-equal (the flat
     all-reduce and the division by 1 change nothing; the distance from
     phase 8's own fit, cuDNN not deterministic, printed), the metrics
     within 1e-6, and K1b, K2b, #4 and #5 must launch DP_LAUNCHES times
     exactly under the group; a step's device time with the
     gradient's all-reduce and without it, in turns, and the all-reduce's
     bytes and ms (the Trainer's whole reduction between CUDA events, and
     queued behind a spin kernel, which hides the host's launches; NCCL's
     call alone);
     destroy_process_group(); (b) through the user's entry point, python -m
     msla_tpu_torch.parallel.launch --nproc 1 -- -m msla_tpu_torch
     train_vqvae=True on phase 22's fixture in a project of its own: exit 0,
     every line of its output prefixed [rank 0], a process group of NCCL at
     world size 1 reported, last.ckpt (at its global step) and the codebook
     CSV written and read back;
 29. the model axis at world size 1 (sharded state over groups of one rank;
     model_parallel > 1 is the CPU tests'): (a) phase 8's fit again (phase
     28's inputs and cuDNN flags) in a rank started by python -m
     msla_tpu_torch.parallel.launch --nproc 1 -- chip_smoke.py --model-axis
     <dir>, under NCCL, with zero1=True, then with fsdp=True: each fit's
     parameters and metrics bit-equal to phase 28's fit under the group, K1b,
     K2b, #4 and #5 launched DP_LAUNCHES times (the kernels line's
     launches_model_axis), every leaf on the sharded path (its layout over
     "data", its block and moments the whole leaf's shape); a batch-64
     step's device ms with the sharded optimizer (fsdp: the gathers, the
     slices, Adam on the blocks) and without (the plain group), in turns,
     and queued behind a spin;
     the gathers' bytes and ms between CUDA events and queued behind a spin
     (queued_ms); Trainer(model_parallel=2) raising JAX's ValueError before
     any step; (b) python -m msla_tpu_torch.parallel.launch --nproc 1 -- -m
     msla_tpu_torch train_vqvae=True trainer.fsdp=True (generate and visualize
     off: phase 28 ran them) on phase 22's fixture: exit 0, every line
     [rank 0], its seconds, last.ckpt of whole tensors;
     then phase 22's fixture is removed;
 30. pipeline parallelism at one stage (a model axis of 1; pp >= 2 is the CPU
     tests'): (a) in a rank started by python -m
     msla_tpu_torch.parallel.launch --nproc 1 -- chip_smoke.py --pipeline
     <dir>, under NCCL, the batch-16 Audio-BERT call's one group of 352
     sequences (bert-base, fp32, seed 0) through pipelined_bert_apply at
     n_micro 1, 2 and 4 against the unpipelined BERT call: #6's ids equal or
     near-ties, #7 launched 12 x n_micro times and #6 once (the kernels line's
     launches_pipeline), the hidden states' largest difference, each forward's
     ms; (b) AudioBertTask.pipeline_loss_fn (n_micro 2) against loss_fn on
     the batch-16 ids and one [MASK] draw: with equal vocab ids the loss and
     the head's gradient bit-equal; (c) one batch-64 step of
     configs/model/transformer.yaml's net (seed 0, dropout 0) through
     pipeline_loss_fn at n_micro 2 and 4 against loss_fn: loss and gradients
     within 1e-5 relative, each step's ms between events and queued behind a
     spin, and its peak memory; (d) python -m msla_tpu_torch.parallel.launch
     --nproc 1 -- -m msla_tpu_torch -m hparams_search=optuna_smoke on phase
     27's fixture (generate and visualize off): exit 0, both trials with
     phase 27's sampled overrides; then the fixture is removed;
 31. the perceptual loss (msla_tpu_torch.nn.PerceptualLoss, random VGG16
     weights of seed 0) at the config's data: x the trained VQ-VAE's
     separated stems of phase 8's first batch, the target its stems (batch
     64 x 4 stems x 44,000 samples at 22 kHz: 256 + 256 mel images of 64 x
     276); (a) one sample's 4 stems: the card's loss against the port's CPU
     path in fp64 (within 1e-5 relative) and dL/dx against fp64 on the
     card's own ReLU masks and pool argmaxes (fp64_on_pieces; within 2e-4
     of its largest: where fp32 and fp64 take other pieces near a tie, the
     gradient jumps), and plain F.conv2d in TF32, forward and backward,
     written here, outside that tolerance; (b) backward() called outside any scope
     with torch.backends.cudnn.allow_tf32 = True set globally: within (a)'s
     tolerance, and within 1e-5 of the backward run inside fp32_convs() on
     the same forward (as plain F.conv2d's fp32 backward is), which a TF32
     backward alone misses; (c) loss(x, x) == 0, no VGG weight with a
     gradient, no launch of the port's kernels; (d) forward and forward +
     backward ms (median of 10, CUDA events) beside their bound at 67
     TFLOP/s, the peak memory, the cuDNN share of a trace's kernels
     (device_parts), the host's share and the mel filterbank's build on the
     host and copy (two a loss call), and forward + backward's ms and peak
     with cudnn.benchmark = True;
 32. the VQ-VAE's kernels at widths past the sweep's (csrc/stem_any.cu,
     csrc/vq_any.cu, #5 over runs of codes; batch 8 x 44,000 samples): the
     stems at num_hidden 2, 7, 96, 200, 384, 512 in fp32 (atol = rtol =
     1e-4, against fp64 within stem_accumulation_bound) and 64, 96, 256,
     512 in bf16 (bf16_width_check: the hidden as check_bf16 holds it, the
     output against the plain second layer on the kernel's own hidden), K1
     and K2 also at ragged lengths, the same bits twice; K3, #4 and #5 at
     (D, K) = (8, 1,024), (64, 1,024), (64, 2,048), (64, 511), (96,
     4,096), (512, 512), (32, 65,536), (7, 33): ids equal or near-ties, also at
     ragged N, planted ties and close pairs right (K >= 512), #4 as in
     phase 6, #5 bit-equal to codebook_grad_order_ref at its grid; each
     timed beside its plain version and a library call, with its plan's
     tile, padding and shared memory (the source's *_smem_bytes); then,
     with the counts zeroed, the entry points there: Trainer.fit and
     SourceSeparator.separate of a VQVAETask at (num_hidden 96, D 8, K
     1,024) fp32 and (256, 64, 2,048) bf16 (card vs CPU codes >= 99.9 %,
     bf16 >= 99 %), python -m msla_tpu_torch train_vqvae=True
     experiment=fast_serving model.vqvae.num_hidden=64 in process, and
     Audio-BERT (bert-base) over a frozen teacher of 1,024 codes; every new
     kernel must launch there; the phase's and each nvcc's seconds
     (python3 chip_smoke.py --widths runs the build and this phase alone);
 33. #7 at any head width, forward and backward (csrc/flash_attn.cu at D =
     64 with its log-sum-exp, csrc/flash_any.cu elsewhere up to 256,
     csrc/flash_bwd.cu's dQ and dK/dV kernels): every (D, type) at D = 1,
     8, 26, 32, 48, 64, 80, 96, 128, 160, 256 and (Sq, Sk) = (512, 512),
     (130, 257), (1, 512), (64, 256), masked and not, with a sequence of
     padding alone, against the plain versions (fp32 also against fp64
     within attention_accumulation_bound and attention_grad_bound; bf16's
     forward within 2·2⁻⁹·Σ p|v| + 1e-5, its backward within
     attention_bf16_grad_bound of attention_bwd_ref), the backward the same
     bits twice, D = 257 refused; then, with the counts zeroed, 4
     DecoderLayer(zero_memory=False) at hidden 512 with 8 and 4 heads (D 64,
     128), batch 64, 64 queries over a memory of 256, 3 Adam steps on the
     card against the CPU on the card's ReLU masks (every q/k/v projection
     with a gradient, the first gradients, moves within 0.2·lr, exact
     launches), and TinyBERT-4L-312D's encoder (D 26) over the batch-16
     fold, card vs CPU; each kernel timed beside its plain version, SDPA's
     forward and backward, its bound, registers and shared memory, the
     tuned forward re-timed at the batch-16 Audio-BERT layer (python3
     chip_smoke.py --attention runs the build and this phase alone);
 34. one JSON line with every kernel's numbers, then the device line.
The backwards of phases 7 and 8 run under fp32 convs, as the Trainer's do
(phase 7 checks cuDNN's TF32 flag from a hook during the backward, and a
residual conv's weight gradient against fp64), and K1 and K1b are held at
lengths T not divisible by 4 (phases 3 and 6) and through encode_codes
(phase 4).
A path's parts (phases 4, 10, 14, 17) come from a torch.profiler trace of
the path's own call: each kernel's device time, summed by kind of kernel.
The redesigned kernels (#7, K1/K1b and K2/K2b in both types; #6/#6b in
bf16; K3 and #4) each print their time over their library call's and over
their bound.
msla_tpu_torch/tools/bench_stems.py times the 3xTF32 kernels (the fp32 stems,
K3, #4) beside probes of their parts and another commit's kernels.
The bf16 #6 kernel traps when an mbarrier wait outlasts 2 s, so a hang
fails the phase with a launch error.
Each phase's seconds are printed as it ends.
It exits non-zero without a result when no CUDA card is present.
"""
from __future__ import annotations

import collections
import contextlib
import json
import math
import re
import statistics
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

T_IMPORT = time.perf_counter()        # once torch is imported (phase 29's rank reports from it)

PEAK_FLOPS = {"fp32": 67e12,     # H100 SXM, fp32 outside the tensor cores (data sheet)
              "tf32": 495e12,    # H100 SXM, TF32 dense on the tensor cores (data sheet)
              "bf16": 989e12}    # H100 SXM, bf16 dense on the tensor cores (data sheet)
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (data sheet)
MODEL = dict(num_hidden=128, num_residual_layer=2, num_residual_hidden=32,
             num_embedding=512, embedding_dim=64, commitment_cost=0.25,
             learning_rate=1e-4, sample_rate=22000)
SR, FRAME, BATCH = 22000, 44000, 64   # configs/data/default.yaml: 22 kHz x 2 s, batch 64
SONG_S = 60.0                          # the separated song: 30 frames
HOST_RUNS = 20                         # timed batch-64 separations
STEM_TOL = 1e-4
TRAIN_BATCHES, VAL_BATCHES = 6, 2      # Trainer.fit's batches in phase 8
OUT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"  # codebook CSV
BERT_BATCH = 16                        # the JAX package's BERT batch (bench.py:74)
BERT_SEQS = 352                        # 16 rows x 22 windows of 512: one folded call
BERT_ROWS = BERT_SEQS * 512            # M of the fused argmax
GEN_HOST_RUNS = 5                      # timed corrupt_and_generate calls


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def reset_counts(kernels) -> None:
    """Every wrapper's launch counts to 0, by operand type and by widths."""
    for k in kernels:
        k.launches.clear()
        getattr(k, "widths", {}).clear()


def launch_counts(kernels, dtypes: dict | None = None) -> dict:
    """Each wrapper's launches by name: all of them, or with ``dtypes`` those
    on the operand type it gives the wrapper's name (all for a name it lacks)."""
    from msla_tpu_torch.ops._build import launch_count

    return {k.__name__: launch_count(k, (dtypes or {}).get(k.__name__)) for k in kernels}


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() in ms, each run between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float, peak: float = PEAK_FLOPS["fp32"]) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, atol: float = STEM_TOL,
                rtol: float = STEM_TOL) -> float:
    err = (got - want).abs()
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    if (err > atol + rtol * want.abs()).any():
        fail(f"{name}: max abs error {err.max().item():.3e} beyond atol={atol} rtol={rtol}")
    return err.max().item()


def check_bf16(name: str, got: torch.Tensor, want: torch.Tensor, terms: torch.Tensor):
    """A bf16 stem's output against its plain version. The two sum the same
    exact products in fp32 in another order and round once each: 2 bf16 ulps
    of the larger magnitude (or 1e-6 near 0). But the hidden layer is rounded
    to bf16 too, and where the two fp32 sums of a hidden value straddle a
    rounding point, the two round it apart by one bf16 ulp, at most 2⁻⁷ of
    it; ``terms`` is Σ |w2|·|h| of each output, so 2⁻⁷·terms bounds what such
    flips may move it. Every value must be within both parts, and at most
    1e-4 of the values beyond the first. Returns the largest abs error, the
    share beyond 2 ulps and the share of bit-equal values."""
    g, w = got.float(), want.float()
    if got.dtype != torch.bfloat16 or not torch.isfinite(g).all():
        fail(f"{name}: a {got.dtype} output, or non-finite values")
    err = (g - w).abs()
    ulp = torch.ldexp(torch.ones_like(err), torch.frexp(torch.maximum(g.abs(), w.abs()))[1] - 8)
    beyond = err > torch.clamp(2 * ulp, min=1e-6)
    share = beyond.double().mean().item()
    if (err > torch.clamp(2 * ulp, min=1e-6) + 2.0 ** -7 * terms).any() or share > 1e-4:
        fail(f"{name}: {beyond.sum().item()} values beyond 2 bf16 ulps (share {share:.2e}), "
             f"max abs error {err.max().item():.3e}")
    return err.max().item(), share, (got == want).double().mean().item()


def stem_terms(h: torch.Tensor, w2: torch.Tensor, transposed: bool) -> torch.Tensor:
    """Σ |w2|·|h| of each output of a stem's second layer (k4 s2 p1), fp32."""
    import torch.nn.functional as F

    conv = F.conv_transpose1d if transposed else F.conv1d
    return conv(h.float().abs(), w2.float().abs(), None, 2, 1)


#: T/2 odd; T % 4 = 3; h1's extra row after a whole tile; one column (T/2
#: odd); two whole 128-column tiles and one more column (T/2 odd)
RAGGED_T = (44_002, 44_003, 44_546, 7, 1_030)


def ragged_stem(enc, dev, g, dtype=torch.float32, save_hidden=False) -> dict:
    """K1 (K1b with ``save_hidden``) at lengths T not divisible by 4, batch 4,
    against conv_stem_ref: floor(T/4) columns, floor(T/2) hidden rows (the
    last a real row when T/2 is odd), fp32 at atol = rtol = 1e-4 and within
    the fp64 accumulation bound, bf16 as ``check_bf16`` holds it (the bf16
    hidden within 2 ulps). Returns the largest error at each T."""
    from msla_tpu_torch.ops import conv_stem, conv_stem_ref, conv_stem_save_hidden

    errs = {}
    for t in RAGGED_T:
        x = (torch.randn((4, 4, t), generator=g, device=dev) * 0.3).to(dtype)
        args = (x, enc.conv1.weight.detach().to(dtype), enc.conv1.bias.detach(),
                enc.conv2.weight.detach().to(dtype), enc.conv2.bias.detach())
        want, want_h = conv_stem_ref(*args)
        got, h = conv_stem_save_hidden(*args) if save_hidden else (conv_stem(*args), None)
        torch.cuda.synchronize()
        if got.shape != (4, 128, t // 4) or (h is not None and h.shape != (4, 64, t // 2)):
            fail(f"conv_stem at T = {t}: shapes {got.shape}, {None if h is None else h.shape}")
        name = f"conv_stem{'_save_hidden' if save_hidden else ''} {dtype} at T = {t}"
        if dtype == torch.bfloat16:
            errs[t] = max(check_bf16(name, got, want, stem_terms(want_h, args[3], False))[0],
                          check_bf16(name + " hidden", h, want_h, torch.zeros_like(
                              want_h, dtype=torch.float32))[0] if save_hidden else 0.0)
        else:
            errs[t] = max(check_close(name, got, want),
                          check_close(name + " hidden", h, want_h) if save_hidden else 0.0)
            stem_fp64_share(name, stem_accumulation_bound(*args, transposed=False), got, h)
    print(f"[kernel] {'K1b' if save_hidden else 'K1'} {dtype} at ragged T: {errs}", flush=True)
    return errs


def stem_accumulation_bound(x, w1, b1, w2, b2, transposed: bool):
    """The exact stem of fp32 operands in fp64 (K1's conv pair with both
    ReLUs, or with ``transposed`` K2's, ReLU after the first layer), and an
    upper bound, per value of its output and of its hidden, on how far the
    fp32 kernels (3xTF32 on mma.sync) may fall from it: (out, its bound, the
    hidden, its bound), fp64.

    The model is #7's (``attention_accumulation_bound``): each accumulation
    into the tensor cores' fp32 accumulator is off by less than one fp32 ulp
    of the sum of its terms' magnitudes so far, ulp(x) <= u·x with u = 2^-23.
    A layer of depth K runs 3 products in each of its K/8 k8 steps, 3K/8
    accumulations of at most u·A each, A = Σ|w|·|a| its terms' magnitudes,
    however the depth is cut into chains; the split drops lo·lo and the
    parts' remainders, at most 3·2^-22·A = 6u·A; the n - 1 adds of a
    layer's n chains (its partial sums, added in fp32) and the bias add
    round once each, within u·(A + |b|): a layer's own error is at most
    (3K/8 + 6 + a)·u·A + a·u·|b|, a = max(2, n), and a ReLU passes on no
    more than it gets:
    - hidden (K1's conv1, K = 16, one chain; K2's first layer, K = 2·C, one
      chain, two on a cluster): e1 = (3K/8 + 8)·u·A1 + 2u·|b1|; the pad rows
      are 0 in both;
    - output: e1 carried through the second layer's weights, Σ|w2|·e1 (first
      order), plus its own (K = 4·C1) with A2 = Σ|w2|·h and n the kernel's
      chains: K1's ``conv2_chains`` (one a tap at (128, 256)), K2's
      ``second_layer_chains`` (two row sets times its ``cluster_blocks``, 4
      at (256, 128); the any-width kernel's 8 warps' runs elsewhere).
    The fp32 plain version sums in another order, rounding each add to
    nearest, and stays well inside it; single-pass TF32 products, ~2^-11 of
    each term off, do not (tests/test_torch_fp32_stems_3xtf32.py,
    tests/test_torch_widths.py)."""
    import torch.nn.functional as F

    from msla_tpu_torch.ops.conv_stem import conv2_chains
    from msla_tpu_torch.ops.deconv_stem import second_layer_chains

    conv = F.conv_transpose1d if transposed else F.conv1d
    xd, w1d, b1d, w2d, b2d = (t.double() for t in (x, w1, b1, w2, b2))
    k1 = 2 * x.shape[1] if transposed else 4 * x.shape[1]   # taps x channels a value sums
    k2 = 4 * w2.shape[0 if transposed else 1]
    chains = (second_layer_chains(*w1.shape[:2]) if transposed
              else conv2_chains(w1.shape[0], w2.shape[0]))
    u = 2.0 ** -23
    adds = lambda n: max(2, n)
    own = lambda k, n: (3 * k / 8 + 6 + adds(n)) * u
    h = torch.relu(conv(xd, w1d, b1d, 2, 1))
    e1 = own(k1, 1) * conv(xd.abs(), w1d.abs(), None, 2, 1) + adds(1) * u * b1d.abs()[:, None]
    out = conv(h, w2d, b2d, 2, 1)
    if not transposed:
        out = torch.relu(out)
    e2 = (conv(e1, w2d.abs(), None, 2, 1) + own(k2, chains) * conv(h, w2d.abs(), None, 2, 1)
          + adds(chains) * u * b2d.abs()[:, None])
    return out, e2, h, e1


def stem_fp64_share(name: str, bounds, out, hidden=None, plain=None) -> float:
    """A fp32 stem's largest error against fp64, output and (if given) hidden,
    as a share of ``stem_accumulation_bound``'s ``bounds``; fails above 1.
    With ``plain`` (the plain version's (out, hidden)) prints its share beside
    it."""
    exact, limit, exact_h, limit_h = bounds

    def share(got, got_h):
        s = ((got.double() - exact).abs() / (limit + 1e-30)).max().item()
        if got_h is not None:
            s = max(s, ((got_h.double() - exact_h).abs() / (limit_h + 1e-30)).max().item())
        return s

    got = share(out, hidden)
    beside = "" if plain is None else \
        f", the plain fp32 version's {share(plain[0], None if hidden is None else plain[1]):.3f}"
    print(f"[stem] {name}: against fp64, {got:.3f} of the 3xTF32 accumulation bound{beside}",
          flush=True)
    if got > 1:
        fail(f"{name}: off fp64 by {got:.2f}x what its 3xTF32 accumulation may lose")
    return got


def tf32_bounds(flop: float, moved: float) -> dict:
    """An fp32 kernel on the TF32 tensor cores is held to its FLOP at the TF32
    peak, as #6 and #7 fp32 are; beside it, its three products there and the
    FLOP on the fp32 FMA units."""
    return dict(flop_type="tf32", three_products_ms=bound(3 * flop, moved, PEAK_FLOPS["tf32"])[0],
                fp32_bound_ms=bound(flop, moved)[0])


def near_ties_by(dist, idx_a, idx_b, what: str = "nearest_codes") -> tuple[int, float, float]:
    """Rows where two id vectors differ, and the largest fp64 distance gap between
    the two picks, absolute and relative to |dist|+1, where dist(rows, ids) gives
    the fp64 distances. Fails unless every relative gap is below 1e-5 (a
    near-tie that fp32 sums in another order may flip)."""
    rows = (idx_a != idx_b).nonzero().flatten()
    if rows.numel() == 0:
        return 0, 0.0, 0.0
    da, db = dist(rows, idx_a[rows].long()), dist(rows, idx_b[rows].long())
    gap = (da - db).abs()
    rel = (gap / (db.abs() + 1)).max().item()
    if rel >= 1e-5:
        fail(f"{what}: {rows.numel()} mismatches, one is not a near-tie "
             f"(relative gap {rel:.3e})")
    return rows.numel(), gap.max().item(), rel


def l2_dist(x, codebook):
    """dist(rows, ids) = |e|^2 - 2 x.e in fp64, for near_ties_by."""
    cb = codebook.double()

    def dist(rows, ids):
        e = cb[ids]
        return (e * e).sum(1) - 2 * (x[rows].double() * e).sum(1)
    return dist


def near_ties(x, codebook, idx_a, idx_b) -> tuple[int, float, float]:
    """near_ties_by on the fp32 operands' L2 distance."""
    return near_ties_by(l2_dist(x, codebook), idx_a, idx_b)


#: planted (lower, higher) code pairs of the VQ search at K = 512. A lane of
#: the search holds columns 2t and 2t + 1 of each n8 tile of codes and walks
#: them in groups of 32, then merges over its quad: pairs in one lane, in two
#: lanes of one tile, from lane 3 to the next tile's lane 0 (the lower index
#: in the higher lane), in one lane of two tiles, in two groups, and to the
#: last codes
VQ_PAIRS = ((0, 1), (100, 101), (2, 5), (104, 110), (7, 8), (118, 121), (16, 24), (130, 138),
            (40, 77), (200, 263), (48, 511), (300, 509))
VQ_PLANTED_ROWS = 2000   # no multiple of the search's 32-row tile


def vq_planted(cb, close: bool, g, n: int = VQ_PLANTED_ROWS):
    """Rows x, a codebook and the id each row must get, row r planted on the
    pair VQ_PAIRS[r % 12] of ``cb`` (512 standard normal codes, which lie far
    from each other and from the rows).
    - Ties (``close`` false): e[hi] = e[lo] exactly, x = e[lo] + noise: the
      lower index must win.
    - Close pairs: e[lo] = tf32(cb[lo]), e[hi] = e[lo] + δ, δ_k of e[lo]_k's
      sign and 0.4 of its TF32 ulp, so one TF32 pass rounds both to e[lo] and,
      e[hi] being longer, picks lo; x = e[lo] + noise ⟂ δ + a·δ/|δ|, a set so
      that hi is nearer by 1e-4 of |dist| + 1 (near_ties' unit: 10x its
      limit). Every pick must be hi.
    The construction is checked in fp64."""
    from msla_tpu_torch.ops.tf32 import tf32_round_ref

    dev = cb.device
    pairs = torch.tensor(VQ_PAIRS, device=dev)
    lo, hi = pairs[torch.arange(n, device=dev) % len(VQ_PAIRS)].unbind(1)
    e = cb.clone()
    noise = (torch.randn((n, cb.shape[1]), generator=g, device=dev) * 0.3).double()
    if close:
        base = tf32_round_ref(cb[pairs[:, 0]])
        step = torch.sign(base) * torch.ldexp(torch.ones_like(base), torch.frexp(base)[1] - 11)
        e[pairs[:, 0]], e[pairs[:, 1]] = base, base + 0.4 * step
        if not torch.equal(tf32_round_ref(e[pairs[:, 1]]), base):
            fail("planted close pairs: one TF32 pass would not tie them")
        el, eh = e[lo].double(), e[hi].double()
        delta = eh - el
        dn = delta.norm(dim=1)
        u = delta / dn[:, None]
        w = noise - (noise * u).sum(1, keepdim=True) * u
        d0 = (eh * eh).sum(1) - 2 * ((el + w) * eh).sum(1)   # dist_hi less a's share
        a = (1e-4 * (1 - d0) + dn ** 2) / (2 * dn - 2e-4 * (u * eh).sum(1))
        x, want = (el + w + a[:, None] * u).float(), hi
    else:
        e[pairs[:, 1]] = e[pairs[:, 0]]
        x, want = (e[lo].double() + noise).float(), lo
    ed = e.double()
    dist = (ed * ed).sum(1) - 2 * x.double() @ ed.T
    two = dist.topk(2, dim=1, largest=False)
    gap = (dist.gather(1, lo[:, None]) - dist.gather(1, hi[:, None]))[:, 0]
    rel = (gap / (two.values[:, 0].abs() + 1)).aminmax()
    if (not torch.equal(torch.sort(two.indices, 1).values, torch.stack([lo, hi], 1))
            or (close and (rel.min < 5e-5 or rel.max > 2e-4)) or (not close and rel.max != 0)):
        fail(f"planted {'close pairs' if close else 'ties'}: the construction did not plant "
             f"them (relative gaps {rel.min.item():.3e}..{rel.max.item():.3e})")
    return x, e, want


def vq_planted_picks(what: str, search, dev, g, d: int = 64) -> dict:
    """K3 or #4 (``search`` gives the ids of (x, codebook)) and the plain
    version on vq_planted's ties and close pairs, 512 codes of width d:
    every id as planted."""
    from msla_tpu_torch.ops import nearest_codes_ref

    cb = torch.randn((512, d), generator=g, device=dev)
    for close in (False, True):
        x, e, want = vq_planted(cb, close, g)
        for label, ids in (("kernel", search(x, e)), ("plain version", nearest_codes_ref(x, e))):
            if not torch.equal(ids.long(), want):
                fail(f"{what} planted {'close pairs' if close else 'ties'}: the {label} missed "
                     f"{(ids.long() != want).sum().item()} of {want.numel()} rows")
    print(f"[{what}] planted ties to the lower index and close pairs 1e-4 apart to the "
          f"nearer, {VQ_PLANTED_ROWS} rows each: every pick right", flush=True)
    return dict(planted_ties=VQ_PLANTED_ROWS, planted_close_pairs=VQ_PLANTED_ROWS)


#: row counts around the search's 32-row tile, and one past a batch-64 call's
RAGGED_N = (1, 7, 129, 704_001)


def ragged_rows(search, dev, g, ns=RAGGED_N, d: int = 64) -> dict:
    """K3 or #4 (``search`` gives the ids) at N rows no multiple of its tile,
    against 512 codes of width d: each id equal to the plain version's or a
    near-tie. Returns the mismatches at each N."""
    from msla_tpu_torch.ops import nearest_codes_ref

    cb = torch.randn((512, d), generator=g, device=dev)
    out = {}
    for n in ns:
        x = torch.randn((n, d), generator=g, device=dev)
        ids = search(x, cb)
        torch.cuda.synchronize()
        if ids.shape != (n,):
            fail(f"ragged N = {n}: ids of shape {tuple(ids.shape)}")
        out[n] = near_ties(x, cb, ids, nearest_codes_ref(x, cb))[0]
    print(f"[vq search] ragged N, mismatches (each a near-tie): {out}", flush=True)
    return out


def check_fused(flat, cb):
    """#4 on (flat, cb) against the plain version: each id equal or a
    near-tie, q = codebook[id] bit for bit, counts a bincount of the ids, sq
    within 1e-5 of the fp64 sum, and a second call the same bits. Returns
    (q, ids, counts, sq, near_ties' triple, sq's relative error)."""
    from msla_tpu_torch.ops import vq_fused_fwd, vq_fused_fwd_ref

    q, idx, counts, sq = vq_fused_fwd(flat, cb)
    torch.cuda.synchronize()
    ties = near_ties_by(l2_dist(flat, cb), idx, vq_fused_fwd_ref(flat, cb)[1], "vq_fused_fwd")
    if not torch.equal(q, cb[idx.long()]):
        fail("vq_fused_fwd: q is not codebook[idx] bit for bit")
    if not torch.equal(counts, torch.bincount(idx.long(), minlength=cb.shape[0]).float()):
        fail("vq_fused_fwd: counts differ from a bincount of its ids")
    sq64 = ((cb.double()[idx.long()] - flat.double()) ** 2).sum().item()
    sq_rel = abs(sq.item() - sq64) / max(sq64, 1e-30)
    if sq_rel > 1e-5:
        fail(f"vq_fused_fwd: squared-error sum off by {sq_rel:.3e} of the fp64 sum")
    again = vq_fused_fwd(flat, cb)
    if not all(torch.equal(a, b) for a, b in zip(again, (q, idx, counts, sq))):
        fail("vq_fused_fwd: two calls on the same inputs differ")
    return q, idx, counts, sq, ties, sq_rel


def phase_kernels(net, dev) -> list[dict]:
    import torch.nn.functional as F

    from msla_tpu_torch.ops.conv_adjoints import fp32_convs
    from msla_tpu_torch.ops import (conv_stem, conv_stem_ref, deconv_stem,
                                    deconv_stem_ref, nearest_codes, nearest_codes_ref)

    g = torch.Generator(device=dev).manual_seed(1)
    enc, dec = net.encoder, net.decoder
    w = FRAME // 4
    report = []
    with torch.no_grad():
        # K1 at the batch-64 encoder input
        x = torch.randn((BATCH, 4, FRAME), generator=g, device=dev) * 0.3
        args = (x, enc.conv1.weight, enc.conv1.bias, enc.conv2.weight, enc.conv2.bias)
        out = conv_stem(*args)
        torch.cuda.synchronize()
        want = conv_stem_ref(*args)[0]
        err = check_close("conv_stem", out, want)
        share = stem_fp64_share("conv_stem", stem_accumulation_bound(*args, transposed=False),
                                out, plain=(want, None))
        del want
        with fp32_convs():
            lib = time_ms(lambda: F.relu(F.conv1d(F.relu(F.conv1d(x, args[1], args[2], 2, 1)),
                                                  args[3], args[4], 2, 1)))
        flops = 2 * BATCH * (FRAME // 2 * 64 * 4 * 4 + w * 128 * 64 * 4)
        report.append(dict(
            name="conv_stem", route="cuda", source="msla_tpu_torch/csrc/conv_stem.cu",
            replaces="msla_tpu/ops/conv_stem.py:48", max_abs_err=err,
            fp64_share_of_bound=share,
            ms=time_ms(lambda: conv_stem(*args)), plain_ms=time_ms(lambda: conv_stem_ref(*args)),
            library_ms=lib, flop=flops, bytes=nbytes(*args, out),
            **tf32_bounds(flops, nbytes(*args, out)),
            ragged_t_max_abs_err=ragged_stem(enc, dev, g)))
        del x, out

        # K2 at the batch-64 decoder stem input (post-ReLU activations)
        q = torch.rand((BATCH, 128, w), generator=g, device=dev)
        args = (q, dec.conv1_transpose.weight, dec.conv1_transpose.bias,
                dec.conv2_transpose.weight, dec.conv2_transpose.bias)
        out = deconv_stem(*args)
        torch.cuda.synchronize()
        want = deconv_stem_ref(*args)[0]
        err = check_close("deconv_stem", out, want)
        share = stem_fp64_share("deconv_stem", stem_accumulation_bound(*args, transposed=True),
                                out, plain=(want, None))
        del want
        with fp32_convs():
            lib = time_ms(lambda: F.conv_transpose1d(
                F.relu(F.conv_transpose1d(q, args[1], args[2], 2, 1)), args[3], args[4], 2, 1))
        flops = 2 * BATCH * (2 * w * 64 * 128 * 2 + 4 * w * 4 * 64 * 2)
        report.append(dict(
            name="deconv_stem", route="cuda", source="msla_tpu_torch/csrc/deconv_stem.cu",
            replaces="msla_tpu/ops/deconv_stem.py:35", max_abs_err=err,
            fp64_share_of_bound=share,
            ragged_w_max_abs_err=ragged_deconv(dec, dev, g, torch.float32),
            ms=time_ms(lambda: deconv_stem(*args)),
            plain_ms=time_ms(lambda: deconv_stem_ref(*args)),
            library_ms=lib, flop=flops, bytes=nbytes(*args, out),
            **tf32_bounds(flops, nbytes(*args, out))))
        del q, out

        # K3 at N = B*W rows against a 512 x 64 codebook (3xTF32 on mma.sync)
        n = BATCH * w
        flat = torch.randn((n, 64), generator=g, device=dev)
        cb = torch.randn((512, 64), generator=g, device=dev)
        idx = nearest_codes(flat, cb)
        want = nearest_codes_ref(flat, cb)
        torch.cuda.synchronize()
        # max_abs_err: the largest fp64 distance gap between the two picks
        mismatches, gap, rel_gap = near_ties(flat, cb, idx, want)
        e2 = (cb * cb).sum(1)
        lib = time_ms(lambda: torch.argmin(e2 - 2.0 * torch.matmul(flat, cb.T), dim=1))
        flops = 2 * n * 512 * 64
        report.append(dict(
            name="nearest_codes", route="cuda", source="msla_tpu_torch/csrc/nearest_codes.cu",
            replaces="msla_tpu/ops/vq_pallas.py:40", max_abs_err=gap,
            index_mismatches=mismatches, max_tie_gap=rel_gap,
            **vq_planted_picks("nearest_codes", nearest_codes, dev, g),
            ragged_n_mismatches=ragged_rows(nearest_codes, dev, g),
            ms=time_ms(lambda: nearest_codes(flat, cb)),
            plain_ms=time_ms(lambda: nearest_codes_ref(flat, cb)),
            library_ms=lib, flop=flops, bytes=nbytes(flat, cb, idx),
            **tf32_bounds(flops, nbytes(flat, cb, idx))))
        del flat, cb, idx, want
    return with_bounds(report)


#: the kernel entries whose kernels were redesigned for Hopper: each also
#: prints its time over its library call's and over its bound
REDESIGNED = ("flash_attn", "flash_attn[bf16]", "deconv_stem", "deconv_stem_save_hidden",
              "deconv_stem[bf16]", "deconv_stem_save_hidden[bf16]", "conv_stem",
              "conv_stem_save_hidden", "conv_stem[bf16]", "conv_stem_save_hidden[bf16]",
              "mlm_argmax[bf16]", "mlm_argmax_conf[bf16]", "nearest_codes", "vq_fused_fwd",
              "vq_lean_fwd", "vq_precision_fwd[bf16/split2]", "vq_precision_fwd[bf16/f32]",
              "vq_precision_fwd[split3/split2]", "vq_codebook_grad", "vq_precision_bwd[split2]",
              "conv_stem[128x256]", "conv_stem_save_hidden[128x256]", "deconv_stem[256x128]",
              "deconv_stem_save_hidden[256x128]")


def with_bounds(report: list[dict]) -> list[dict]:
    """Add each kernel's bound from its FLOP (at the peak of its "flop_type",
    fp32 unless it says tf32 or bf16) and bytes, and print its line."""
    for k in report:
        k["bound_ms"], k["bound_by"] = bound(k["flop"], k["bytes"],
                                             PEAK_FLOPS[k.setdefault("flop_type", "fp32")])
        extra = {key: k[key] for key in ("index_mismatches", "max_tie_gap", "fp32_bound_ms",
                                         "three_products_ms", "planted_close_pairs",
                                         "coherent_logit_err", "ms_uniform_ids",
                                         "max_abs_err_uniform_ids", "sq_rel_err",
                                         "sq_rel_err_converged", "bit_equal_share",
                                         "beyond_2_ulps_share", "max_share_of_bound",
                                         "fp64_share_of_bound", "ragged_s_max_abs_err",
                                         "ragged_w_max_abs_err", "previous_ms", "planted_ties",
                                         "ragged_n_mismatches", "tool_ms", "hgmma",
                                         "ms_one_code", "ms_sorted_runs", "blocks",
                                         "scratch_bytes", "cuda_launches_per_call",
                                         "padded_share", "runs", "backward_ms",
                                         "backward_bound_ms")
                 if key in k}
        lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f}"
        print(f"[kernel] {k['name']}: max_abs_err={k['max_abs_err']:.3e} ms={k['ms']:.4f} "
              f"plain_ms={k['plain_ms']:.4f} library_ms={lib} "
              f"bound_ms={k['bound_ms']:.4f} ({k['bound_by']}) {extra or ''}", flush=True)
        if k["name"] in REDESIGNED:
            print(f"[redesigned] {k['name']}: kernel / library = "
                  f"{k['ms'] / k['library_ms']:.3f}, kernel / bound = "
                  f"{k['ms'] / k['bound_ms']:.2f}", flush=True)
    return report


def synthetic_mixture(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    mix = sum(0.2 * np.sin(2 * np.pi * 55.0 * 2 ** i * (1 + 0.01 * rng.standard_normal()) * t)
              for i in range(4))
    return (mix + 0.01 * rng.standard_normal(t.shape)).astype(np.float32)


def phase_main_path(task, kernels) -> dict:
    from msla_tpu_torch.inference import SourceSeparator

    reset_counts(kernels)
    song = synthetic_mixture(SONG_S, seed=2)
    sep = SourceSeparator(task, frame_samples=FRAME, batch_size=16)
    stems = sep.separate(song)
    stems_ov = sep.separate(song, overlap=True)
    codes = sep.encode_codes(song)
    for name, a, shape in (("separate", stems, (4, song.size)),
                           ("separate(overlap)", stems_ov, (4, song.size)),
                           ("encode_codes", codes, (-(-song.size // FRAME), FRAME // 4))):
        if a.shape != shape or not np.isfinite(a).all():
            fail(f"{name}: shape {a.shape} (want {shape}) or non-finite values")
    if codes.min() < 0 or codes.max() >= MODEL["num_embedding"]:
        fail("encode_codes: ids out of range")
    ragged_frame(task, song)

    sep64 = SourceSeparator(task, frame_samples=FRAME, batch_size=BATCH)
    song64 = synthetic_mixture(BATCH * FRAME / SR, seed=3)
    sep64.separate(song64)                           # warm-up
    before = launch_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    host_s = []
    for _ in range(HOST_RUNS):
        t0 = time.perf_counter()
        out64 = sep64.separate(song64)
        host_s.append(time.perf_counter() - t0)
    counts = launch_counts(kernels)
    per_batch = {name: (n - before[name]) // HOST_RUNS for name, n in counts.items()}
    if not np.isfinite(out64).all():
        fail("batch-64 separate: non-finite values")
    if min(counts.values()) == 0:
        fail(f"a kernel of the main path never launched: {counts}")

    model_in = sep64._model_input(song64.reshape(BATCH, FRAME))
    device_ms = time_ms(lambda: sep64._separate(model_in), reps=10, warmup=2)
    q1, median, q3 = statistics.quantiles(host_s, n=4)
    result = dict(launches=counts, launches_per_batch64=per_batch,
                  batch64_host_s=dict(n=HOST_RUNS, median=median, q1=q1, q3=q3,
                                      min=min(host_s), max=max(host_s)),
                  batch64_device_ms=device_ms,
                  samples_per_s=BATCH * FRAME / median,
                  device_samples_per_s=BATCH * FRAME / (device_ms / 1e3),
                  device_busy_share=device_ms / 1e3 / median,
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                  breakdown_ms=device_parts(lambda: sep64._separate(model_in)))
    print(f"[main] launches={counts} per_batch64={per_batch} batch-64 separate: "
          f"{result['samples_per_s']:.0f} samples/s end to end (median of {HOST_RUNS}), "
          f"{result['device_samples_per_s']:.0f} samples/s on the device", flush=True)
    return result


def ragged_frame(task, song) -> None:
    """A frame length not divisible by 4 (F4): encode_codes gives floor(F/4)
    codes a frame, and separate raises ValueError, as the JAX package's do."""
    from msla_tpu_torch.inference import SourceSeparator

    frame = FRAME + 2
    sep = SourceSeparator(task, frame_samples=frame, batch_size=16)
    codes = sep.encode_codes(song)
    if codes.shape != (-(-song.size // frame), frame // 4):
        fail(f"encode_codes at a frame of {frame}: shape {codes.shape}")
    try:
        sep.separate(song)
    except ValueError:
        return
    fail(f"separate took a frame of {frame} samples")


#: the part of a breakdown a kernel belongs to: the first entry whose words
#: its name holds, else "other". The port's kernels of the serving paths by
#: their __global__ names (K2's holds K1's, so it comes first) ...
PORT_PARTS = (("K2 deconv_stem", ("deconv_stem_3xtf32_kernel", "deconv_stem_bf16_kernel")),
              ("K1 conv_stem", ("conv_stem_3xtf32_kernel", "conv_stem_bf16_kernel")),
              ("K3 nearest_codes", ("nearest_codes_kernel",)),
              ("#7 flash_attn", ("flash_attn_kernel",)),
              ("#6 mlm_argmax", ("mlm_argmax",)))
#: ... then the libraries' kernels by the words in theirs
LIBRARY_PARTS = (("cuDNN convs", ("conv", "fprop", "cudnn", "nhwc", "Nhwc", "DSE::",
                                  "pointwise_mult_and_sum_complex")),   # cuDNN's FFT convs
                 ("cuBLAS GEMMs", ("gemm", "nvjet", "gemv", "splitK")))


def kernel_part(name: str) -> str:
    return next((part for part, words in PORT_PARTS + LIBRARY_PARTS
                 if any(w in name for w in words)),
                "other: elementwise, casts, reductions, gathers, copies")


TRACE_TRIES = 3
TRACE_TAKES = 8  # traces a measurement may take in all, the discarded ones included


def device_parts(fn, passes: int = 3) -> dict:
    """Device ms of the parts of one fn() call, from a torch.profiler trace
    (CUPTI) of the call: each kernel's device time summed by ``kernel_part``,
    "kernels" their sum and "idle" the call's device span less it; the
    median of ``passes`` traced calls. The call is the path's own, so the
    parts are what the path runs; "top" names its five longest kernels.
    Each trace follows one untraced warm-up step of the profiler's schedule
    (a trace started at the call drops its first kernels), and must hold as
    many of the port's kernels as the wrappers counted launches in the call:
    a trace that drops one (CUPTI did, once in 15 launches, on an H100) is
    discarded and taken again, at most ``TRACE_TAKES`` times a pass, and
    each discarded trace is printed."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from msla_tpu_torch.ops import KERNELS

    ours = {part for part, _ in PORT_PARTS}
    runs, top = collections.defaultdict(list), collections.Counter()
    for _ in range(passes):
        for _ in range(TRACE_TAKES):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
                for _ in range(2):  # the warm-up step, then the traced one
                    before = launch_counts(KERNELS)
                    fn()
                    torch.cuda.synchronize()
                    prof.step()
            launched = {k: n - before[k] for k, n in launch_counts(KERNELS).items()
                        if n > before[k]}
            kernels = [e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and not e.name.startswith("ProfilerStep")]  # the step's own span
            traced = collections.Counter(kernel_part(e.name) for e in kernels
                                         if kernel_part(e.name) in ours)
            if sum(traced.values()) == sum(launched.values()):
                break
            print(f"[device_parts] a trace dropped kernels: it holds {dict(traced)}, the "
                  f"wrappers counted {launched}; tracing again", flush=True)
        else:
            fail(f"device_parts: {TRACE_TAKES} traces each dropped some of the port's kernels")
        sums = collections.defaultdict(float)
        for e in kernels:
            sums[kernel_part(e.name)] += e.device_time / 1e3
            top[e.name[:80]] += e.device_time / 1e3 / passes
        sums["kernels"] = sum(e.device_time for e in kernels) / 1e3
        span = max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)
        sums["idle"] = span / 1e3 - sums["kernels"]
        for part, ms in sums.items():
            runs[part].append(ms)
    parts = {part: statistics.median(ms + [0.0] * (passes - len(ms))) for part, ms in runs.items()}
    return dict(parts, top={name: ms for name, ms in top.most_common(5)})


def phase_cpu_agreement(task) -> dict:
    from msla_tpu_torch.models.vqvae import VQVAETask

    cpu = VQVAETask(**MODEL, checkpoint_dir=".", codebook_file="codebook.csv", device="cpu")
    cpu.net.load_state_dict({k: v.cpu() for k, v in task.net.state_dict().items()})
    frames = synthetic_mixture(2 * FRAME / SR, seed=4).reshape(2, 1, FRAME).repeat(4, axis=1)
    x_cpu = torch.from_numpy(np.ascontiguousarray(frames))
    x_gpu = x_cpu.cuda()
    with torch.inference_mode():
        zg, zc = task.net.encode(x_gpu), cpu.net.encode(x_cpu)
        qg, qc = task.get_quantized(x_gpu), cpu.get_quantized(x_cpu)
        sg, sc = task.net.decode(qg.quantized).cpu(), cpu.net.decode(qc.quantized)
        ig, ic = qg.encoding_indices.cpu(), qc.encoding_indices
        agree = (ig == ic).double().mean().item()
        if agree < 0.999:
            fail(f"card vs CPU: only {agree:.5f} of codes agree")
        mismatches, _, gap = near_ties(zc.reshape(-1, zc.shape[-1]),
                                       cpu.net.vector_quantizer.codebook.weight,
                                       ig.flatten(), ic.flatten())
        z_err = (zg.cpu() - zc).abs().max().item()
        frame_ok = (ig == ic).all(dim=1)
        stem_err = 0.0
        if frame_ok.any():
            stem_err = check_close("separation card vs CPU", sc[frame_ok], sg[frame_ok])
        # the decoder alone on the same ids, whatever the lookup picked
        dec_err = check_close("decode_indices card vs CPU",
                              task.net.decode_indices(ic.cuda()).cpu(),
                              cpu.net.decode_indices(ic))
    result = dict(code_agreement=agree, code_mismatches=mismatches, max_tie_gap=gap,
                  latent_max_abs_err=z_err, frames_compared=int(frame_ok.sum()),
                  stem_max_abs_err=stem_err, decode_indices_max_abs_err=dec_err)
    print(f"[cpu-vs-card] {json.dumps(result)}", flush=True)
    return result


def ptxas_report() -> dict:
    """Registers and spill bytes of every kernel function, from the build logs."""
    from msla_tpu_torch.ops import _build

    out = {}
    for source in _build.SOURCES:
        fn = None
        for line in _build.build_log(source).splitlines():
            if m := re.search(r"Compiling entry function '(\S+)'", line):
                fn = f"{source}/{kernel_name(m.group(1))}"
                out[fn] = {}
            elif fn and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                        line)):
                out[fn].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            elif fn and (m := re.search(r"Used (\d+) registers", line)):
                out[fn]["registers"] = int(m.group(1))
    for fn, info in out.items():
        print(f"[ptxas] {fn}: {info}", flush=True)
    return out


def kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name:
    '_ZN12_GLOBAL__N_117mlm_argmax_kernelILb1EEEv...' -> 'mlm_argmax_kernel<true>',
    a float or named type argument as 'conv_stem_kernel<float>', mixed ones
    as 'flash_bwd_dkv_kernel<__nv_bfloat16,32,false,true>'."""
    pos = 3 if mangled.startswith("_ZN") else 2
    name = ""
    while m := re.match(r"\d+", mangled[pos:]):  # the nested names, length-prefixed
        pos += m.end()
        name = mangled[pos:pos + int(m.group())]
        pos += int(m.group())
    if not mangled[pos:].startswith("I"):
        return name
    values, rest = [], mangled[pos + 1:]
    while rest and rest[0] != "E":
        if rest[0] == "f":
            values.append("float")
            rest = rest[1:]
        elif m := re.match(r"L([a-z]+)(\d+)E", rest):  # a value: Li64E, Lb1E
            values.append({"b0": "false", "b1": "true"}.get(m.group(1) + m.group(2),
                                                             m.group(2)))
            rest = rest[m.end():]
        elif m := re.match(r"\d+", rest):  # a named type: 13__nv_bfloat16
            values.append(rest[m.end():m.end() + int(m.group())])
            rest = rest[m.end() + int(m.group()):]
        else:
            break
    return name + f"<{','.join(values)}>" if values else name


def synthetic_stems(n_batches: int, seed: int, batch: int = BATCH) -> list[np.ndarray]:
    """(batch, 4, FRAME) stems: one tone per stem at a random pitch and phase,
    plus a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(FRAME, dtype=np.float32) / SR
    batches = []
    for _ in range(n_batches):
        f0 = (55.0 * 2.0 ** rng.uniform(0, 4, (batch, 4, 1))).astype(np.float32)
        phase = rng.uniform(0, 2 * np.pi, (batch, 4, 1)).astype(np.float32)
        noise = 0.01 * rng.standard_normal((batch, 4, FRAME), dtype=np.float32)
        batches.append((0.2 * np.sin(2 * np.pi * f0 * t + phase) + noise).astype(np.float32))
    return batches


def in_memory_datamodule(train: list, val: list, masking: bool = True, batch: int = BATCH):
    """The port's SlakhDataModule with in-memory loaders of synthetic batches:
    the kernels' phases need no WAV files (phase 22 reads them)."""
    from msla_tpu_torch.data.datamodule import SlakhDataModule

    class InMemory(SlakhDataModule):
        def train_dataloader(self):
            return train

        def val_dataloader(self):
            return val

    return InMemory(train_dir="", val_dir="", test_dir="", target_sample_rate=SR,
                    target_sample_duration=FRAME // SR, max_duration=120,
                    maximum_dataset_size=len(train) * batch, batch_size=batch,
                    masking=masking)


def first_batch_latents(net, dm, raw: np.ndarray) -> torch.Tensor:
    """The seeded model's pre-VQ rows of the first train batch, masked as the
    first train step masks it: (B*W, D)."""
    dev = next(net.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(1)  # the Trainer's seed + 1
    with torch.no_grad():
        model_in, _ = dm.on_after_batch_transfer(
            dm.train_transform(torch.from_numpy(raw).to(dev), gen))
        return net.encode(model_in).reshape(-1, MODEL["embedding_dim"])


RAGGED_GRAD_N = (1, 31, 33, 4_097, 704_001)  # the segment sums' rows: around groups and parts


def segment_ids(kind: str, n: int, k: int, g, model=None) -> torch.Tensor:
    """(n,) int32 ids of one kind: ``model`` itself, uniform, one code for
    every row, or uniform ids sorted (runs of about n / k rows)."""
    dev = g.device
    if kind == "model":
        return model
    if kind == "one code":
        return torch.full((n,), 7, dtype=torch.int32, device=dev)
    ids = torch.randint(0, k, (n,), generator=g, device=dev, dtype=torch.int32)
    return torch.sort(ids)[0] if kind == "sorted runs" else ids


def check_segment_sum(name: str, fn, grad, ids, k: int, split2: bool) -> dict:
    """A segment-sum kernel (``fn(g, ids)``, csrc/segment_sum.cuh) against
    codebook_grad_order_ref at the card's grid, bit for bit; against fp64
    within segment_sum_bound (summation depth x 2^-24 x sum |g|, the share of
    it used returned); the same bits twice."""
    from msla_tpu_torch.ops import segment_sum as ss

    from msla_tpu_torch.ops.vq_fused import grad_layout

    n, d = grad.shape
    clusters, rows = (ss.launch_layout("vq_precision_bwd_split2", n, k, grad.device, True)
                      if split2 else grad_layout(n, k, d, grad.device))
    blocks = clusters * ss.CLUSTER
    got = fn(grad, ids)
    torch.cuda.synchronize()
    if got.shape != (k, d) or not torch.isfinite(got).all():
        fail(f"{name}: an output of shape {tuple(got.shape)}, or non-finite values")
    if not torch.equal(got, ss.codebook_grad_order_ref(grad, ids, k, blocks, split2=split2)):
        fail(f"{name}: differs from codebook_grad_order_ref at the card's {blocks} blocks")
    err = (got.double() - ss.segment_sum_fp64(grad, ids, k, split2)).abs()
    bound = ss.segment_sum_bound(grad, ids, k, ss.summation_depth(n, blocks, split2), split2)
    if (err > bound).any():
        fail(f"{name}: {(err > bound).sum().item()} sums beyond segment_sum_bound against fp64")
    if not torch.equal(got, fn(grad, ids)):
        fail(f"{name}: two calls on the same inputs differ")
    share = (err / bound).nan_to_num(0.0).max().item()  # 0/0 where a code has no rows
    return dict(max_abs_err=err.max().item(), fp64_share_of_bound=share, blocks=blocks,
                rows_per_part=rows)


SEGMENT_SUM_KERNELS = ("segment_sum_kernel", "segment_sum_finish")  # csrc/segment_sum.cuh


FOOTPRINT_LEAD = 4  # one-element adds that open each of its steps


def call_footprint(fn, kernel_names) -> tuple[int, int]:
    """(CUDA launches, scratch bytes) of one fn() call, both measured: the
    kernels whose names hold one of ``kernel_names`` in a torch.profiler trace
    of one call, after an untraced warm-up step as in device_parts, the most
    of TRACE_TRIES traces (a trace may drop a kernel, never add one); and the
    peak of allocated device memory over one call, less what was allocated
    before it and the output it returns. Each step opens with FOOTPRINT_LEAD
    one-element adds, so that kernels a trace drops at its start are those and
    not fn's (CUPTI dropped both of a segment sum's kernels in three traces in
    a row on an H100); a trace that holds none of fn's kernels is printed and
    taken again, at most TRACE_TAKES traces in all."""
    from torch.profiler import ProfilerActivity, profile, schedule

    lead = torch.zeros(1, device="cuda")
    traced = []
    for _ in range(TRACE_TAKES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):  # the warm-up step, then the traced one
                for _ in range(FOOTPRINT_LEAD):
                    lead.add_(1)
                fn()
                torch.cuda.synchronize()
                prof.step()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith("ProfilerStep")]
        ours = sum(1 for name in kernels if any(w in name for w in kernel_names))
        if ours:
            traced.append(ours)
            if len(traced) == TRACE_TRIES:
                break
        else:
            print(f"[call_footprint] a trace holds none of {kernel_names} among its "
                  f"{len(kernels)} CUDA kernels {sorted(set(n[:40] for n in kernels))}; "
                  f"tracing again", flush=True)
    if not traced:
        fail(f"call_footprint: no kernel named {kernel_names} in {TRACE_TAKES} traces")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - before - out.untyped_storage().nbytes()
    return max(traced), scratch


def segment_sum_checks(name: str, fn, grad, k: int, split2: bool, g, model) -> dict:
    """check_segment_sum on the model's (or the tool's) ids, uniform ids, one
    code and sorted runs, each timed, then at RAGGED_GRAD_N on uniform ids;
    and one call's CUDA launches and scratch bytes on the model's ids
    (call_footprint)."""
    out = {}
    for kind in ("model", "uniform", "one code", "sorted runs"):
        ids = segment_ids(kind, grad.shape[0], k, g, model)
        out[kind] = dict(check_segment_sum(f"{name} ({kind} ids)", fn, grad, ids, k, split2),
                         ms=time_ms(lambda: fn(grad, ids)))
    ragged = {}
    for n in RAGGED_GRAD_N:
        small = torch.randn((n, 64), generator=g, device=grad.device)
        ragged[n] = check_segment_sum(f"{name} at N = {n}", fn, small,
                                      segment_ids("uniform", n, k, g), k, split2)
    launches, scratch = call_footprint(lambda: fn(grad, model), SEGMENT_SUM_KERNELS)
    model = out["model"]
    share = max(r["fp64_share_of_bound"] for r in [*out.values(), *ragged.values()])
    print(f"[{name}] ms by ids " + ", ".join(f"{kind} {r['ms']:.4f}" for kind, r in out.items())
          + f"; bit-equal to codebook_grad_order_ref at {model['blocks']} blocks and the same "
          f"bits twice on every kind of ids and at N = {RAGGED_GRAD_N}; largest share of "
          f"segment_sum_bound {share:.3e}; one call on the model's ids (measured): scratch "
          f"{scratch} bytes, {launches} CUDA launches", flush=True)
    return dict(by_ids=out, ragged_n_max_abs_err={n: r["max_abs_err"] for n, r in ragged.items()},
                fp64_share_of_bound=share, blocks=model["blocks"], scratch_bytes=scratch,
                cuda_launches_per_call=launches)


def phase_train_kernels(net, dev, flat_model: torch.Tensor) -> list[dict]:
    import torch.nn.functional as F

    from msla_tpu_torch.ops import (conv_stem_ref, conv_stem_save_hidden, deconv_stem_ref,
                                    deconv_stem_save_hidden, vq_codebook_grad,
                                    vq_codebook_grad_ref, vq_fused_fwd, vq_fused_fwd_ref)
    from msla_tpu_torch.ops.conv_adjoints import fp32_convs

    g = torch.Generator(device=dev).manual_seed(5)
    enc, dec = net.encoder, net.decoder
    w = FRAME // 4
    k_codes = MODEL["num_embedding"]
    report = []
    with torch.no_grad():
        # K1b at the batch-64 encoder input of a train step
        x = torch.randn((BATCH, 4, FRAME), generator=g, device=dev) * 0.3
        args = (x, enc.conv1.weight, enc.conv1.bias, enc.conv2.weight, enc.conv2.bias)
        out, h = conv_stem_save_hidden(*args)
        torch.cuda.synchronize()
        want_out, want_h = conv_stem_ref(*args)
        err = max(check_close("conv_stem_save_hidden out", out, want_out),
                  check_close("conv_stem_save_hidden hidden", h, want_h))
        share = stem_fp64_share("conv_stem_save_hidden",
                                stem_accumulation_bound(*args, transposed=False), out, h,
                                plain=(want_out, want_h))
        del want_out, want_h
        with fp32_convs():
            lib = time_ms(lambda: F.relu(F.conv1d(F.relu(F.conv1d(x, args[1], args[2], 2, 1)),
                                                  args[3], args[4], 2, 1)))
        flops = 2 * BATCH * (FRAME // 2 * 64 * 4 * 4 + w * 128 * 64 * 4)
        report.append(dict(
            name="conv_stem_save_hidden", route="cuda", source="msla_tpu_torch/csrc/conv_stem.cu",
            replaces="msla_tpu/ops/conv_stem.py:132", max_abs_err=err,
            fp64_share_of_bound=share,
            ms=time_ms(lambda: conv_stem_save_hidden(*args)),
            plain_ms=time_ms(lambda: conv_stem_ref(*args)), library_ms=lib,
            flop=flops, bytes=nbytes(*args, out, h), **tf32_bounds(flops, nbytes(*args, out, h)),
            ragged_t_max_abs_err=ragged_stem(enc, dev, g, save_hidden=True)))
        del x, out, h

        # K2b at the batch-64 decoder stem input
        q = torch.rand((BATCH, 128, w), generator=g, device=dev)
        args = (q, dec.conv1_transpose.weight, dec.conv1_transpose.bias,
                dec.conv2_transpose.weight, dec.conv2_transpose.bias)
        out, h = deconv_stem_save_hidden(*args)
        torch.cuda.synchronize()
        want_out, want_h = deconv_stem_ref(*args)
        err = max(check_close("deconv_stem_save_hidden out", out, want_out),
                  check_close("deconv_stem_save_hidden hidden", h, want_h))
        share = stem_fp64_share("deconv_stem_save_hidden",
                                stem_accumulation_bound(*args, transposed=True), out, h,
                                plain=(want_out, want_h))
        del want_out, want_h
        with fp32_convs():
            lib = time_ms(lambda: F.conv_transpose1d(
                F.relu(F.conv_transpose1d(q, args[1], args[2], 2, 1)), args[3], args[4], 2, 1))
        flops = 2 * BATCH * (2 * w * 64 * 128 * 2 + 4 * w * 4 * 64 * 2)
        report.append(dict(
            name="deconv_stem_save_hidden", route="cuda",
            source="msla_tpu_torch/csrc/deconv_stem.cu",
            replaces="msla_tpu/ops/deconv_stem.py:132", max_abs_err=err,
            fp64_share_of_bound=share,
            ragged_w_max_abs_err=ragged_deconv(dec, dev, g, torch.float32),
            ms=time_ms(lambda: deconv_stem_save_hidden(*args)),
            plain_ms=time_ms(lambda: deconv_stem_ref(*args)), library_ms=lib,
            flop=flops, bytes=nbytes(*args, out, h), **tf32_bounds(flops, nbytes(*args, out, h))))
        del q, out, h

        # #4 on the seeded model's latents of the first batch and its codebook
        # (3xTF32 on mma.sync); planted ties and close pairs, ragged N
        cb = net.vector_quantizer.codebook.weight.detach()
        flat = flat_model.contiguous()
        n = flat.shape[0]
        q, idx, counts, sq, (mismatches, gap, rel_gap), sq_rel = check_fused(flat, cb)
        planted = vq_planted_picks("vq_fused_fwd", lambda x, e: check_fused(x, e)[1], dev, g)
        ragged = ragged_rows(lambda x, e: check_fused(x, e)[1], dev, g, RAGGED_N[-1:])
        e2 = (cb * cb).sum(1)

        def composite():  # one library call each: matmul, argmin, gather, bincount, sum
            i = torch.argmin(e2 - 2.0 * torch.matmul(flat, cb.T), dim=1)
            qq = cb.index_select(0, i)
            return torch.bincount(i, minlength=k_codes), ((qq - flat) ** 2).sum()

        report.append(dict(
            name="vq_fused_fwd", route="cuda", source="msla_tpu_torch/csrc/vq_fused.cu",
            replaces="msla_tpu/ops/vq_fused.py:42", max_abs_err=gap,
            index_mismatches=mismatches, max_tie_gap=rel_gap, sq_rel_err=sq_rel,
            codes_used=int((counts > 0).sum().item()), **planted, ragged_n_mismatches=ragged,
            ms=time_ms(lambda: vq_fused_fwd(flat, cb)),
            plain_ms=time_ms(lambda: vq_fused_fwd_ref(flat, cb)),
            library_ms=time_ms(composite),
            library_call="composite: matmul + argmin + index_select + bincount + sum",
            flop=2 * n * k_codes * 64, bytes=nbytes(flat, cb, q, idx, counts, sq),
            **tf32_bounds(2 * n * k_codes * 64, nbytes(flat, cb, q, idx, counts, sq))))
        model_idx = idx
        del q

        # #5 (csrc/segment_sum.cuh) on the model's ids (main figure), uniform
        # ids, one code and sorted runs, each against fp64 at atol = rtol = 1e-4
        # as before, then segment_sum_checks; ragged N
        grad = torch.randn((n, 64), generator=g, device=dev)
        errs = {}
        for kind in ("model", "uniform", "one code", "sorted runs"):
            ids = segment_ids(kind, n, k_codes, g, model_idx)
            want = torch.zeros((k_codes, 64), dtype=torch.float64, device=dev).index_add_(
                0, ids.long(), grad.double())
            errs[kind] = check_close(f"vq_codebook_grad ({kind} ids)",
                                     vq_codebook_grad(grad, ids, k_codes).double(), want)
        del want
        checks = segment_sum_checks("vq_codebook_grad", lambda x, i: vq_codebook_grad(
            x, i, k_codes), grad, k_codes, False, g, model_idx)
        by_ids = checks.pop("by_ids")
        ids_long = model_idx.long()
        zeros = torch.zeros((k_codes, 64), device=dev)
        report.append(dict(
            checks, name="vq_codebook_grad", route="cuda",
            source="msla_tpu_torch/csrc/segment_sum.cuh",
            replaces="msla_tpu/ops/vq_fused.py:81", max_abs_err=errs["model"],
            max_abs_err_uniform_ids=errs["uniform"], ms=by_ids["model"]["ms"],
            ms_uniform_ids=by_ids["uniform"]["ms"], ms_one_code=by_ids["one code"]["ms"],
            ms_sorted_runs=by_ids["sorted runs"]["ms"],
            codes_used_model=int(torch.unique(model_idx).numel()),
            plain_ms=time_ms(lambda: vq_codebook_grad_ref(grad, model_idx, k_codes)),
            library_ms=time_ms(lambda: zeros.index_add_(0, ids_long, grad)),
            library_call="index_add_", flop=n * 64,
            bytes=nbytes(grad, model_idx) + k_codes * 64 * 4))
        del grad
    torch.cuda.empty_cache()
    return with_bounds(report)


def plain_loss(net, batch):
    """The training loss of ``net`` computed with the plain versions alone and
    torch's own autograd: the stems' ``*_ref`` tap sums, the nearest codes of
    ``vq_fused_fwd_ref`` and the VQ losses written out, in the net's compute
    dtype (bf16: the net's own cast points, the VQ in fp32). No kernel and no
    custom backward runs in it. Returns (loss, pre-VQ rows, ids)."""
    from msla_tpu_torch.nn.layers import conv
    from msla_tpu_torch.ops import conv_stem_ref, deconv_stem_ref, vq_fused_fwd_ref
    from msla_tpu_torch.ops.conv_adjoints import fp32_convs
    from msla_tpu_torch.ops.metrics import l1_loss

    mixed, instruments = batch
    enc, dec, vq = net.encoder, net.decoder, net.vector_quantizer
    dt = net.dtype
    cast = (lambda t: t) if dt is None else (lambda t: t.to(dt))  # noqa: E731
    with fp32_convs():
        h = conv_stem_ref(cast(mixed), cast(enc.conv1.weight), enc.conv1.bias,
                          cast(enc.conv2.weight), enc.conv2.bias)[0]
        z = conv(net.conv, enc.residual_stack(conv(enc.conv3, h, dt)), dt).float() \
            .transpose(1, 2)
        flat = z.reshape(-1, z.shape[-1])
        cb = vq.codebook.weight
        idx = vq_fused_fwd_ref(flat.detach(), cb.detach())[1]
        q = cb.index_select(0, idx)
        loss = torch.mean((q - flat.detach()) ** 2)                            # embedding
        loss = loss + vq.commitment_cost * torch.mean((q.detach() - flat) ** 2)  # commitment
        q_ste = (flat + (q - flat).detach()).reshape(z.shape).transpose(1, 2).contiguous()
        d = dec.residual_stack(conv(dec.conv1, q_ste, dt))
        out = deconv_stem_ref(d, cast(dec.conv1_transpose.weight), dec.conv1_transpose.bias,
                              cast(dec.conv2_transpose.weight),
                              dec.conv2_transpose.bias)[0].float()
    for i in range(4):
        loss = loss + l1_loss(out[:, i, :], instruments[:, i, :])
    return loss, flat.detach(), idx


def phase_gradients(task, raw: np.ndarray) -> dict:
    """2 frames of the full-width model: the backward in fp32 (the TF32 flag
    off while it runs, a residual conv's weight gradient against fp64), the
    kernels' path against the plain loss on the card, and one train step
    against the CPU."""
    from msla_tpu_torch.models.vqvae import VQVAETask
    from msla_tpu_torch.ops.conv_adjoints import fp32_convs

    dm = in_memory_datamodule([], [], masking=False)
    cpu = VQVAETask(**MODEL, checkpoint_dir=str(OUT_DIR), codebook_file=str(OUT_DIR / "cb.csv"),
                    device="cpu")
    cpu.net.load_state_dict({k: v.cpu() for k, v in task.net.state_dict().items()})
    stems = torch.from_numpy(np.ascontiguousarray(raw[:2]))

    def run(t, plain=False):
        batch = dm.on_after_batch_transfer(stems.to(t.device))
        t.net.zero_grad(set_to_none=True)
        if plain:
            loss, z, idx = plain_loss(t.net, batch)
            with fp32_convs():
                loss.backward()
        else:
            loss, _ = t.loss_fn(batch, None)
            with fp32_convs():  # as Trainer._train_step runs it
                loss.backward()
            with torch.no_grad():
                z = t.net.encode(batch[0]).reshape(-1, MODEL["embedding_dim"])
                idx = t.net.vector_quantizer(z).encoding_indices
        grads = {k: p.grad.detach().clone() for k, p in t.net.named_parameters()}
        return loss.item(), grads, z, idx.flatten()

    def compare(label, a, b) -> dict:
        loss_a, grads_a, z_a, idx_a = a
        loss_b, grads_b, _, idx_b = b
        mismatches, _, gap = near_ties(z_a.cpu(), cpu.net.vector_quantizer.codebook.weight,
                                       idx_a.cpu(), idx_b.cpu())
        if abs(loss_a - loss_b) > 1e-4 * abs(loss_b):
            fail(f"{label}: loss {loss_a} against {loss_b}")
        errs = {}
        for k, g in grads_a.items():
            if mismatches and k == "vector_quantizer.codebook.weight":
                continue  # a flipped near-tie moves a row's gradient to another code
            errs[k] = check_close(f"{label}: grad {k}", g.cpu(), grads_b[k].cpu(),
                                  atol=1e-4, rtol=1e-3)
        return dict(loss=loss_a, loss_other=loss_b, code_mismatches=mismatches,
                    max_tie_gap=gap, max_grad_abs_err=max(errs.values()),
                    grads_compared=len(errs))

    with backward_probe(task.net) as probe:
        card = run(task)
    result = {"fp32_backward": probe.check(),
              "kernels_vs_plain": compare("card kernels vs plain loss", card,
                                          run(task, plain=True))}
    result["card_vs_cpu"] = compare("card vs CPU", card, run(cpu))
    # one Adam step from the same weights and gradients on both devices, then
    # the loss of the stepped weights (rtol 1e-3: Adam moves a parameter whose
    # gradient is near 0 by up to lr whatever that gradient's last digits)
    before = {k: v.detach().clone() for k, v in task.net.state_dict().items()}
    for t in (task, cpu):
        run(t)
        t.configure_optimizer().step()
    loss_card, loss_cpu = run(task)[0], run(cpu)[0]
    if abs(loss_card - loss_cpu) > 1e-3 * abs(loss_cpu):
        fail(f"card vs CPU after one Adam step: loss {loss_card} against {loss_cpu}")
    cpu_sd = cpu.net.state_dict()
    result["card_vs_cpu"].update(
        loss_after_step=loss_card, loss_after_step_cpu=loss_cpu,
        param_max_abs_err_after_step=max((v.cpu() - cpu_sd[k]).abs().max().item()
                                         for k, v in task.net.state_dict().items()))
    task.net.load_state_dict(before)  # the training phase starts from the seeded init
    task.net.zero_grad(set_to_none=True)
    print(f"[gradients] {json.dumps(result)}", flush=True)
    return result


class backward_probe:
    """Hooks on the encoder's first residual k3 conv (128 -> 32) during one
    backward: cuDNN's TF32 flag as its weight gradient is made, and the conv's
    input and output gradient. ``check`` holds the card's weight gradient
    against fp64 on the CPU from the same input and output gradient: its error
    must be under a quarter of what TF32's operand rounding alone costs the
    same sum (the fp64 gradient of the TF32-rounded operands), so a TF32
    backward fails it."""

    def __init__(self, net):
        self.conv = net.encoder.residual_stack.residual_layers[0][1]
        self.flags, self.saved = [], {}

    def __enter__(self):
        def forward_hook(_, inputs, out):
            if out.requires_grad:  # the forward of the backward, not a later no-grad pass
                self.saved["x"] = inputs[0].detach()
                out.register_hook(lambda g: self.saved.__setitem__("g", g.detach()))

        self.handles = [
            self.conv.register_forward_hook(forward_hook),
            self.conv.weight.register_hook(
                lambda g: self.flags.append(torch.backends.cudnn.allow_tf32))]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()

    def check(self) -> dict:
        from msla_tpu_torch.ops.tf32 import tf32_round_ref

        if not self.flags or any(self.flags):
            fail(f"backward: cuDNN's TF32 flag read {self.flags} while the conv's weight "
                 "gradient was made (F1)")
        x, g = self.saved["x"], self.saved["g"]
        w = self.conv.weight

        def grad64(a, b):
            return torch.ops.aten.convolution_backward(
                b.cpu().double(), a.cpu().double(), w.detach().cpu().double(), None, [1], [1],
                [1], False, [0], 1, [False, True, False])[1]

        exact = grad64(x, g)
        card_err = (w.grad.cpu().double() - exact).abs().max().item()
        tf32_err = (grad64(tf32_round_ref(x), tf32_round_ref(g)) - exact).abs().max().item()
        out = dict(tf32_flag_in_backward=self.flags, residual_conv_grad_err=card_err,
                   tf32_operand_err=tf32_err, share_of_tf32=card_err / tf32_err)
        print(f"[gradients] residual conv weight gradient against fp64: {card_err:.3e}, "
              f"{out['share_of_tf32']:.4f} of TF32's operand rounding ({tf32_err:.3e}); "
              f"TF32 flag during the backward {self.flags}", flush=True)
        if card_err > 0.25 * tf32_err:
            fail("backward: the residual conv's weight gradient is as far from fp64 as TF32 "
                 "would put it (F1)")
        return out


def timed_step(trainer, task, dm, raw: torch.Tensor) -> list[float]:
    """One train step as Trainer._train_step runs it, with CUDA events between
    its parts: augment and mixture, forward, backward, Adam."""
    from msla_tpu_torch.ops.conv_adjoints import fp32_convs

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    batch = dm.on_after_batch_transfer(dm.train_transform(raw, trainer._generator))
    ev[1].record()
    trainer._optimizer.zero_grad(set_to_none=True)
    loss, _ = task.loss_fn(batch, trainer._generator)
    ev[2].record()
    with fp32_convs():
        loss.backward()
    ev[3].record()
    trainer._optimizer.step()
    ev[4].record()
    ev[4].synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]


#: phase 8's fit as it ended (its weights, metrics and launches), which phase
#: 28 runs again under a process group
PHASE8_FIT: dict = {}


def phase_training(task, dm, kernels) -> dict:
    from msla_tpu_torch.train.trainer import Trainer

    path_kernels = ("conv_stem", "deconv_stem", "conv_stem_save_hidden",
                    "deconv_stem_save_hidden", "vq_fused_fwd", "vq_codebook_grad")
    csv = Path(task.hparams["codebook_file"])
    csv.unlink(missing_ok=True)
    before = {k: v.detach().clone() for k, v in task.net.state_dict().items()}
    trainer = Trainer(max_epochs=1, limit_train_batches=TRAIN_BATCHES,
                      limit_val_batches=VAL_BATCHES, seed=0, enable_progress_bar=False)
    reset_counts(kernels)
    t0 = time.perf_counter()
    trainer.fit(task, dm)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = launch_counts(kernels)
    if any(counts[name] == 0 for name in path_kernels):
        fail(f"a kernel of the training path never launched: {counts}")
    cm = trainer.callback_metrics
    if len(cm) != 21 or not all(np.isfinite(v) for v in cm.values()):
        fail(f"fit: {len(cm)} metrics, or a non-finite one: {cm}")
    unmoved = [k for k, v in task.net.state_dict().items() if torch.equal(v, before[k])]
    if unmoved:
        fail(f"fit: parameters that did not change: {unmoved}")
    codebook = np.loadtxt(csv, delimiter=",", skiprows=1)
    if codebook.shape != (MODEL["num_embedding"], MODEL["embedding_dim"]):
        fail(f"fit: codebook CSV of shape {codebook.shape}")
    print(f"[train] fit: {trainer.global_step} steps in {fit_s:.2f} s, launches {counts}, "
          f"train/loss {cm['train/loss']:.5f}, validation/loss {cm['validation/loss']:.5f}",
          flush=True)
    PHASE8_FIT.update(start=before, callback_metrics=dict(cm), launches=counts,
                      state={k: v.detach().clone() for k, v in task.net.state_dict().items()})
    result = dict(fit_steps=trainer.global_step, fit_s=fit_s, launches=counts,
                  callback_metrics=cm, **measure_steps(trainer, task, dm, kernels))
    print(f"[train] {result}", flush=True)
    return result


def measure_steps(trainer, task, dm, kernels) -> dict:
    """A train step after ``fit``: its device time (CUDA events, median of 10)
    and its parts, the launches per step, the peak device memory, and fit's
    train loop (prefetch + step) on the host clock, ending in a sync."""
    loader = dm.train_dataloader()
    raw = torch.from_numpy(loader[0]).to(task.device)
    rows = raw.shape[0]
    for _ in range(2):
        timed_step(trainer, task, dm, raw)
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    parts = [timed_step(trainer, task, dm, raw) for _ in range(10)]
    per_step = {name: n // 10 for name, n in launch_counts(kernels).items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    names = ("augment_and_mixture", "forward", "backward", "adam")
    breakdown = {n: statistics.median(p[i] for p in parts) for i, n in enumerate(names)}
    step_ms = time_ms(lambda: trainer._train_step(task, dm, [raw]), reps=10, warmup=2)
    host_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        steps = 0
        for _, batch in trainer._prefetched(loader, len(loader)):
            trainer._train_step(task, dm, [batch])
            steps += 1
        torch.cuda.synchronize()
        host_s.append((time.perf_counter() - t0) / steps)
    host_step_s = statistics.median(host_s)
    return dict(launches_per_step=per_step, step_device_ms=step_ms,
                step_host_ms=host_step_s * 1e3, step_host_ms_runs=[s * 1e3 for s in host_s],
                samples_per_s=rows * FRAME / host_step_s,
                device_samples_per_s=rows * FRAME / (step_ms / 1e3),
                device_busy_share=step_ms / 1e3 / host_step_s, peak_mem_gb=peak_gb,
                breakdown_ms=breakdown)


def mlm_near_ties(h, emb, bias, ids_a, ids_b) -> tuple[int, float]:
    """Rows where two vocab-id vectors differ, and the largest fp64 logit gap
    between the two picks relative to |logit|+1. Fails unless every gap is
    below 1e-5 (a near-tie that fp32 sums in another order may flip)."""
    rows = (ids_a != ids_b).nonzero().flatten()
    if rows.numel() == 0:
        return 0, 0.0
    hs, e, b = h[rows].double(), emb.double(), bias.double()
    la = (hs * e[ids_a[rows].long()]).sum(1) + b[ids_a[rows].long()]
    lb = (hs * e[ids_b[rows].long()]).sum(1) + b[ids_b[rows].long()]
    rel = ((la - lb).abs() / (lb.abs() + 1)).max().item()
    if rel >= 1e-5:
        fail(f"mlm_argmax: {rows.numel()} mismatches, one is not a near-tie "
             f"(relative gap {rel:.3e})")
    return rows.numel(), rel


def batch16_mask(dev) -> torch.Tensor:
    """The key mask of the batch-16 call's 352 folded sequences (row f*16 + i is
    window f of row i; window 21 holds 11,000 - 21*512 = 248 codes), with the
    last two sequences made all padding, as batch 64 gives them."""
    mask = torch.ones((BERT_SEQS, 512), device=dev)
    mask[21 * BERT_BATCH:, 248:] = 0.0
    mask[-2:] = 0.0
    return mask


def phase_bert_kernels(bert_task, dev) -> list[dict]:
    import torch.nn.functional as F

    from msla_tpu_torch.ops import (attention_ref, flash_attn, mlm_argmax, mlm_argmax_conf,
                                    mlm_argmax_ref)

    g = torch.Generator(device=dev).manual_seed(7)
    report = []
    with torch.inference_mode():
        # #7 at one layer's shapes: q, k, v (352, 512, 12, 64), the projections' layout
        shape = (BERT_SEQS, 512, 12, 64)
        q, k, v = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
        mask = batch16_mask(dev)
        out = flash_attn(q, k, v, mask, 0.125)
        torch.cuda.synchronize()
        bhsd = [t.transpose(1, 2) for t in (q, k, v)]
        want = attention_ref(*bhsd, mask, 0.125).transpose(1, 2)
        err = check_close("flash_attn", out, want)
        mean_v = v[-1].mean(dim=0, keepdim=True).expand(512, -1, -1)
        check_close("flash_attn (all keys padding: the mean of v)", out[-1], mean_v)
        # against fp64: two sequences without padding, two with 264 keys of it
        seqs = [0, 1, 21 * BERT_BATCH, 21 * BERT_BATCH + 1]
        share = fp64_share("flash_attn", out[seqs], q[seqs], k[seqs], v[seqs], mask[seqs],
                           want[seqs])
        del want
        additive = ((1.0 - mask) * -1e9)[:, None, None, :]
        flop, moved = 4 * BERT_SEQS * 12 * 512 * 512 * 64, nbytes(q, k, v, out, mask)
        report.append(dict(
            name="flash_attn", route="cuda", source="msla_tpu_torch/csrc/flash_attn.cu",
            replaces="msla_tpu/ops/flash_attn.py:51", max_abs_err=err,
            fp64_share_of_bound=share, ragged_s_max_abs_err=ragged_attention(dev, g, torch.float32),
            # held to its FLOP at the TF32 peak, as #6 fp32: beside it the design's
            # three products there, and the FLOP on the fp32 FMA units
            three_products_ms=bound(3 * flop, moved, PEAK_FLOPS["tf32"])[0],
            fp32_bound_ms=bound(flop, moved)[0],
            ms=time_ms(lambda: flash_attn(q, k, v, mask, 0.125)),
            plain_ms=time_ms(lambda: attention_ref(*bhsd, mask, 0.125)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                *bhsd, attn_mask=additive, scale=0.125)),
            library_call="scaled_dot_product_attention, additive mask",
            flop=flop, flop_type="tf32", bytes=moved))
        del q, k, v, out, bhsd, additive
        torch.cuda.empty_cache()

        # #6 at M = 180,224 rows against the model's tied decoder, all rows held
        # against the plain version (in its 4,096-row chunks)
        emb = bert_task._decoder_weights()[0]
        bias = torch.randn((emb.shape[0],), generator=g, device=dev) * 0.1
        h = torch.randn((BERT_ROWS, 768), generator=g, device=dev)
        ids = mlm_argmax(h, emb, bias)
        ids_c, conf_c = mlm_argmax_conf(h, emb, bias)
        torch.cuda.synchronize()
        want_ids, want_conf = mlm_argmax_ref(h, emb, bias, with_conf=True)
        mismatches, gap = mlm_near_ties(h, emb, bias, ids, want_ids)
        mismatches_c, gap_c = mlm_near_ties(h, emb, bias, ids_c, want_ids)
        print(f"[mlm_argmax] {BERT_ROWS} rows: {mismatches} near-tie mismatches (largest "
              f"relative gap {gap:.3e}), conf variant {mismatches_c} ({gap_c:.3e})", flush=True)
        if not torch.equal(ids, ids_c):
            fail("mlm_argmax and mlm_argmax_conf pick different ids")
        conf_err = check_close("mlm_argmax_conf conf", conf_c, want_conf, atol=0.0, rtol=1e-4)
        if not torch.equal(conf_c, mlm_argmax_conf(h, emb, bias)[1]):
            fail("mlm_argmax_conf: two runs give different confidences")
        del want_ids, want_conf
        ties = planted_ties(h, emb, bias)
        close_pairs = planted_close_pairs(h, emb, bias)
        coherent = coherent_logit_errors(h)

        def library(with_conf):  # addmm + argmax (+ logsumexp) over row chunks
            for chunk in h.split(4096):
                logits = torch.addmm(bias, chunk, emb.T)
                logits.argmax(dim=-1)
                if with_conf:
                    torch.logsumexp(logits, dim=-1)

        flop = 2 * BERT_ROWS * emb.shape[0] * 768  # the function's, held at the TF32 peak
        for name, line, with_conf in (("mlm_argmax", 47, False), ("mlm_argmax_conf", 67, True)):
            fn = mlm_argmax_conf if with_conf else mlm_argmax
            outs = (ids_c, conf_c) if with_conf else (ids,)
            report.append(dict(
                name=name, route="cuda", source="msla_tpu_torch/csrc/mlm_argmax.cu",
                replaces=f"msla_tpu/ops/mlm_argmax.py:{line}",
                max_abs_err=conf_err if with_conf else gap,
                index_mismatches=mismatches_c if with_conf else mismatches,
                max_tie_gap=gap_c if with_conf else gap, rows_compared=BERT_ROWS,
                planted_ties=ties, planted_close_pairs=close_pairs, coherent_logit_err=coherent,
                fp32_bound_ms=bound(flop, nbytes(h, emb, bias, *outs))[0],
                # the design's own floor: 3xTF32 runs three products at the TF32 peak
                three_products_ms=bound(3 * flop, nbytes(h, emb, bias, *outs),
                                        PEAK_FLOPS["tf32"])[0],
                ms=time_ms(lambda: fn(h, emb, bias)),
                plain_ms=time_ms(lambda: mlm_argmax_ref(h, emb, bias, with_conf=with_conf)),
                library_ms=time_ms(lambda: library(with_conf)),
                library_call="addmm + argmax" + (" + logsumexp" if with_conf else "")
                + ", 4,096-row chunks",
                flop=flop, flop_type="tf32", bytes=nbytes(h, emb, bias, *outs)))
        del h, ids, ids_c, conf_c
    torch.cuda.empty_cache()
    return with_bounds(report)


def planted_ties(h, emb, bias) -> int:
    """2,000 rows (no multiple of the 128-row tile), each with two equal vocab
    rows set to 3·h/|h|, far above any other logit: across tiles (one of them
    in the ragged last tile), in adjacent columns, and 64 columns apart (one
    thread). The lower index must win in the kernel and in the plain version,
    and the two variants' confidences (≈ 0.5) agree with the plain ones."""
    from msla_tpu_torch.ops import mlm_argmax, mlm_argmax_conf, mlm_argmax_ref

    n, v = 2000, emb.shape[0]
    r = torch.arange(n, device=h.device)
    k = r - 1400
    lo = torch.where(r < 700, r, torch.where(r < 1400, 4000 + 2 * (r - 700),
                                             10240 + 128 * (k // 64) + k % 64))
    hi = torch.where(r < 700, v - 1 - r, torch.where(r < 1400, lo + 1, lo + 64))
    hs = h[:n]
    e = emb.clone()
    b = bias.clone()
    planted = 3.0 * hs / hs.norm(dim=1, keepdim=True)
    e[lo], e[hi] = planted, planted
    b[lo], b[hi] = 0.0, 0.0
    ids = mlm_argmax(hs, e, b)
    ids_c, conf = mlm_argmax_conf(hs, e, b)
    want_ids, want_conf = mlm_argmax_ref(hs, e, b, with_conf=True)
    for label, got in (("kernel", ids), ("conf kernel", ids_c), ("plain version", want_ids)):
        if not torch.equal(got.long(), lo):
            fail(f"mlm_argmax planted ties: the {label} did not pick the lower index")
    check_close("mlm_argmax_conf planted ties", conf, want_conf, atol=0.0, rtol=1e-4)
    return n


def planted_close_pairs(h, emb, bias) -> int:
    """2,000 rows, each with two vocab rows lo < hi whose fp64 logits differ by
    1e-4 of the larger (hi's), far above any other logit: E[lo] = tf32(3·h/|h|)
    and E[hi] = E[lo] + δ with each |δ_k| under half a TF32 ulp of E[lo]_k, so
    one TF32 pass sees two equal rows and picks lo. The gap is 10× the near-tie
    limit: both kernels, the plain version and the 3xTF32 emulation must pick
    hi. Pairs in adjacent columns (one thread), 8 apart (the thread's next
    n8 block), 64 apart, 256 apart (the next vocab tile) and across the vocab
    into the ragged last tile, 400 rows each. The kernel's gap, read back
    from conf ≈ σ(gap), is held to fp64 within `accumulation_bound`."""
    from msla_tpu_torch.ops import mlm_argmax, mlm_argmax_conf, mlm_argmax_ref
    from msla_tpu_torch.ops.mlm_argmax import mlm_logits_3xtf32_ref
    from msla_tpu_torch.ops.tf32 import tf32_round_ref

    n, v = 2000, emb.shape[0]
    kind, i = torch.arange(n, device=h.device).div(400, rounding_mode="floor"), \
        torch.arange(n, device=h.device) % 400
    lo = torch.stack([2 * i, 1000 + 16 * (i // 8) + i % 8, 2048 + 128 * (i // 64) + i % 64,
                      3072 + 512 * (i // 256) + i % 256, 5000 + i]).gather(0, kind[None])[0]
    hi = torch.stack([lo + 1, lo + 8, lo + 64, lo + 256, v - 1 - i]).gather(0, kind[None])[0]
    hs = h[:n]
    planted = tf32_round_ref(3.0 * hs / hs.norm(dim=1, keepdim=True))
    step = torch.sign(hs) * torch.ldexp(torch.ones_like(planted), torch.frexp(planted)[1] - 11)
    scale = 1e-4 * (hs.double() * planted.double()).sum(1) / (hs.double() * step.double()).sum(1)
    if (scale >= 0.5).any():
        fail("planted close pairs: δ would reach half a TF32 ulp")
    e, b = emb.clone(), bias.clone()
    e[lo] = planted
    e[hi] = planted + (scale[:, None] * step.double()).float()
    b[lo], b[hi] = 0.0, 0.0
    exact = [(hs.double() * e[c].double()).sum(1) for c in (lo, hi)]
    rel = ((exact[1] - exact[0]) / exact[1]).aminmax()
    if rel.min < 5e-5:
        fail(f"planted close pairs: relative gap {rel.min.item():.3e}, not 1e-4")
    if not torch.equal(tf32_round_ref(e[lo]), tf32_round_ref(e[hi])):
        fail("planted close pairs: one TF32 pass would not tie them")
    emulated = [torch.diagonal(mlm_logits_3xtf32_ref(hs, e[c], b[c])) for c in (lo, hi)]
    ids = mlm_argmax(hs, e, b)
    ids_c, conf = mlm_argmax_conf(hs, e, b)
    want_ids, want_conf = mlm_argmax_ref(hs, e, b, with_conf=True)
    for label, got in (("kernel", ids), ("conf kernel", ids_c), ("plain version", want_ids)):
        if not torch.equal(got.long(), hi):
            fail(f"mlm_argmax planted close pairs: the {label} missed the larger logit in "
                 f"{(got.long() != hi).sum().item()} of {n} rows")
    if not (emulated[1] > emulated[0]).all():
        fail("mlm_argmax planted close pairs: the 3xTF32 emulation missed the larger logit")
    # conf = σ(gap) here (every other logit is below 10), so the conf variant
    # gives the kernel's gap l_hi − l_lo: held against fp64 to what the two
    # logits' accumulations may lose plus the read-back's resolution (conf
    # carries its fp32 logsumexp's rounding at |l| ≈ 83); cuBLAS fp32's beside it
    r = torch.arange(n, device=h.device)
    gap = exact[1] - exact[0]
    c = conf.double()
    gap_err = (torch.log(c) - torch.log1p(-c) - gap).abs()
    limit = accumulation_bound(hs, e[lo]) + accumulation_bound(hs, e[hi]) + 4 * fp32_ulp(exact[1])
    ratio = (gap_err / limit).max().item()
    logits = torch.addmm(b, hs, e.T)
    gap_err_p = ((logits[r, hi] - logits[r, lo]).double() - gap).abs().max().item()
    print(f"[mlm_argmax] planted close pairs: {n} rows, relative gaps {rel.min.item():.3e}"
          f"..{rel.max.item():.3e}, every pick the larger; one TF32 pass ties them; gap error "
          f"against fp64: kernel {gap_err.max().item():.3e} ({ratio:.3f} of its bound), cuBLAS "
          f"fp32 {gap_err_p:.3e}; conf off the plain version's by at most "
          f"{(conf - want_conf).abs().max().item():.3e}", flush=True)
    if ratio > 1:
        fail(f"mlm_argmax_conf planted close pairs: the gap is off fp64 by {ratio:.2f}x what "
             f"the kernel's accumulation may lose")
    return n


def fp32_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of fp32 values at |x| (fp64 in and out)."""
    return torch.ldexp(torch.ones_like(x), torch.frexp(x.abs().float())[1].to(x.device) - 24)


def accumulation_bound(hs, e) -> torch.Tensor:
    """Per row, the most the kernel may lose on h_i·e_i if each of its 288
    accumulations into the tensor cores' fp32 accumulator (96 k8 steps × its
    three products) is off by less than one fp32 ulp of the running sum, as
    an adder that truncates is: Σ_t 3·ulp(max(|S_t−1|, |S_t|)) with S_t the
    exact sum after step t (fp64)."""
    s = (hs.double() * e.double()).view(hs.shape[0], 96, 8).sum(2).cumsum(1)
    prev = torch.cat([torch.zeros_like(s[:, :1]), s[:, :-1]], 1)
    return 3 * fp32_ulp(torch.maximum(s.abs(), prev.abs()) * (1 + 1e-6)).sum(1)


def coherent_logit_errors(h) -> dict:
    """The kernel's logit error where its fp32 accumulation is hardest, against
    fp64 and beside cuBLAS fp32's (addmm, as in the plain version) on the same
    rows: 2,000 rows h_i, each with a vocab row e_i = 83·h_i/|h_i|² (the 768
    terms of h_i·e_i ≈ 83 all add, as on the planted pairs) under bias −83,
    and one zero row under bias 0; every other logit is below −40. The bias
    add is exact near 0, so the conf variant returns σ(|l_i|), the pick gives
    its sign, and the kernel's l_i = h_i·e_i − 83 comes back to ~3e-7. Fails
    where the kernel's error exceeds `accumulation_bound` (+ 1e-6 for the
    read-back). Returns the largest and the mean signed error of each, over 83,
    and the kernel's largest share of its bound."""
    from msla_tpu_torch.ops import mlm_argmax_conf

    n, big = 2000, 83.0
    hs = h[:n]
    e = torch.cat([big * hs / (hs * hs).sum(1, keepdim=True), hs.new_zeros((1, 768))])
    b = torch.cat([hs.new_full((n,), -big), hs.new_zeros((1,))])
    rows = torch.arange(n, device=h.device)
    ids, conf = mlm_argmax_conf(hs, e, b)
    own = ids.long() == rows
    if not (own | (ids == n)).all():
        fail("coherent rows: a pick is neither the row's own column nor the zero row")
    c = conf.double()
    got = torch.where(own, 1.0, -1.0) * (torch.log(c) - torch.log1p(-c))
    exact = (hs.double() * e[:n].double()).sum(1) - big
    plain = torch.addmm(b, hs, e.T)[rows, rows].double()
    out = {}
    for label, err in (("kernel", got - exact), ("plain", plain - exact)):
        out[f"{label}_max"] = err.abs().max().item() / big
        out[f"{label}_mean"] = err.mean().item() / big
    out["kernel_share_of_bound"] = ((got - exact).abs()
                                    / (accumulation_bound(hs, e[:n]) + 1e-6)).max().item()
    print(f"[mlm_argmax] coherent rows: {n} logits of 83 against fp64, relative error: kernel "
          f"max {out['kernel_max']:.3e} mean {out['kernel_mean']:+.3e} "
          f"({out['kernel_share_of_bound']:.3f} of its accumulation bound); cuBLAS fp32 max "
          f"{out['plain_max']:.3e} mean {out['plain_mean']:+.3e}", flush=True)
    if out["kernel_share_of_bound"] > 1:
        fail(f"mlm_argmax coherent rows: the kernel's logit error is "
             f"{out['kernel_share_of_bound']:.2f}x what its accumulation may lose")
    return out


def phase_bert_serving(bert_task, vq_task, kernels) -> dict:
    from msla_tpu_torch.inference import AudioGenerator

    gen = AudioGenerator(bert_task, vq_task)
    stems = synthetic_stems(1, seed=20)[0][:BERT_BATCH]
    reset_counts(kernels)
    out = gen.corrupt_and_generate(stems, corrupt_stem=1, rng=np.random.default_rng(0))
    codes = gen.sample_codes(width=FRAME // 4, batch=1, rounds=4, seed=0)
    wave = gen.generate_waveform(width=FRAME // 4, batch=1, rounds=4, seed=1)
    torch.cuda.synchronize()
    counts = launch_counts(kernels)
    for name, a, shape in (("corrupt_and_generate", out, (BERT_BATCH, 4, FRAME)),
                           ("sample_codes", codes, (1, FRAME // 4)),
                           ("generate_waveform", wave, (1, 4, FRAME))):
        if a.shape != shape or not np.isfinite(a).all():
            fail(f"{name}: shape {a.shape} (want {shape}) or non-finite values")
    if codes.min() < 0 or codes.max() >= MODEL["num_embedding"]:
        fail("sample_codes: codes out of [0, 512)")
    path = ("mlm_argmax", "mlm_argmax_conf", "flash_attn", "conv_stem", "nearest_codes",
            "deconv_stem")
    if any(counts[name] == 0 for name in path):
        fail(f"a kernel of the Audio-BERT path never launched: {counts}")

    # timed: batch-16 corrupt_and_generate, host clock, then the device time
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts(kernels)
    host_s = []
    for i in range(GEN_HOST_RUNS):
        t0 = time.perf_counter()
        gen.corrupt_and_generate(stems, corrupt_stem=1, rng=np.random.default_rng(i))
        host_s.append(time.perf_counter() - t0)
    per_call = {name: (n - before[name]) // GEN_HOST_RUNS
                for name, n in launch_counts(kernels).items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    noisy = stems.copy()
    noisy[:, 1, :] = np.random.default_rng(0).random(FRAME, dtype=np.float32)
    x = torch.from_numpy(noisy).cuda()

    def call():  # corrupt_and_generate's device work on the corrupted batch
        with torch.inference_mode():
            return bert_task.predict_step((vq_task.get_quantized(x).encoding_indices, x))

    device_ms = time_ms(call, reps=5, warmup=1)
    median = statistics.median(host_s)
    codes_per_call = BERT_BATCH * FRAME // 4
    result = dict(launches=counts, launches_per_call=per_call,
                  host_s=dict(n=GEN_HOST_RUNS, median=median, runs=host_s),
                  device_ms=device_ms, codes_per_s=codes_per_call / median,
                  device_codes_per_s=codes_per_call / (device_ms / 1e3),
                  device_busy_share=device_ms / 1e3 / median, peak_mem_gb=peak_gb,
                  breakdown_ms=device_parts(call))
    print(f"[bert] launches={counts} per call={per_call}; batch-16 corrupt_and_generate "
          f"{median * 1e3:.1f} ms end to end (median of {GEN_HOST_RUNS}), {device_ms:.1f} ms "
          f"on the device, {result['codes_per_s']:.0f} codes/s, peak {peak_gb:.2f} GB, "
          f"breakdown {result['breakdown_ms']}", flush=True)
    return result


def phase_bert_cpu_agreement(bert_task) -> dict:
    from msla_tpu_torch.models.bert import AudioBertTask

    cpu = AudioBertTask(**bert_task_args(), device="cpu", seed=0)
    cpu.net.load_state_dict({k: v.cpu() for k, v in bert_task.net.state_dict().items()})
    w = 1000
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, 512, (1, w)))
    tokens[:, ::7] = bert_task.config.mask_token_id
    with torch.inference_mode():
        pc, pg = cpu.code_proposals(tokens), bert_task.code_proposals(tokens).cpu()
        ic, cc = cpu._chunked_argmax(tokens, with_conf=True)
        ig, cg = (t.cpu() for t in bert_task._chunked_argmax(tokens.cuda(), with_conf=True))
        tok, am, _ = cpu._fold(tokens)
        h = torch.cat([cpu.bert(t, a, return_mlm_hidden=True) for t, a in zip(tok, am)])
        emb, bias = cpu._decoder_weights()
        mismatches, gap = mlm_near_ties(h.reshape(-1, 768)[:w], emb, bias, ig.flatten(),
                                        ic.flatten())
        conf_err = check_close("code_proposals conf card vs CPU", cg, cc, atol=0.0, rtol=1e-4)
    result = dict(vocab_id_mismatches=mismatches, max_tie_gap=gap, conf_max_abs_err=conf_err,
                  code_id_agreement=(pc[..., 0] == pg[..., 0]).double().mean().item(),
                  proposal_conf_max_abs_err=(pc[..., 1] - pg[..., 1]).abs().max().item())
    print(f"[bert cpu-vs-card] {json.dumps(result)}", flush=True)
    return result


def bert_task_args() -> dict:
    """configs/model/bert.yaml at the data config's 22 kHz x 2 s frame, with the
    codebook phase 8 wrote; no pretrained weights (random init, seed 0)."""
    return dict(learning_rate=2e-4, checkpoint_dir=str(OUT_DIR),
                codebook=str(OUT_DIR / "codebook.csv"), sample_rate=SR,
                frame_length=FRAME // SR, num_embedding=MODEL["num_embedding"])



VQ_TOOL_MODES = ("bf16/split2", "bf16/f32", "split3/split2")  # #9's modes new to the port


def mode_dist(x, codebook, dist_mode: str):
    """dist(rows, ids) in fp64 on a precision mode's own operands, for
    near_ties_by: bf16(x) against cb_hi (bf16), or the three products of
    split3 against |cb_hi + cb_lo|^2."""
    from msla_tpu_torch.ops.vq_precision import split_bf16

    (xh, xl), (ch, cl) = ([p.double() for p in split_bf16(t)] for t in (x, codebook))
    if dist_mode == "bf16":
        return l2_dist(xh, ch)

    def dist(rows, ids):
        e = ch[ids] + cl[ids]
        dots = (xh[rows] * ch[ids] + xh[rows] * cl[ids] + xl[rows] * ch[ids]).sum(1)
        return (e * e).sum(1) - 2 * dots
    return dist


def check_vq_fwd(name: str, got, want, dist, sq_atol: float = 0.0) -> dict:
    """A VQ forward's (q, idx, counts, sq) against its plain version's: every
    differing id a near-tie, q bit-equal where the ids are, counts a bincount of
    the ids (and the plain counts where no id differs), sq within rtol 1e-5 +
    sq_atol."""
    q, idx, counts, sq = got[0], *(t.flatten() for t in got[1:])
    q_r, idx_r, counts_r, sq_r = want[0], *(t.flatten() for t in want[1:])
    mismatches, gap, rel_gap = near_ties_by(dist, idx, idx_r, name)
    same = idx == idx_r
    if not torch.equal(q[same], q_r[same]):
        fail(f"{name}: q differs from the plain version's on rows with the same id")
    if not torch.equal(counts, torch.bincount(idx.long(), minlength=counts.numel()).float()):
        fail(f"{name}: counts differ from a bincount of its ids")
    if not mismatches and not torch.equal(counts, counts_r):
        fail(f"{name}: counts differ from the plain version's")
    sq_err = abs(sq.item() - sq_r.item())
    if sq_err > 1e-5 * abs(sq_r.item()) + sq_atol:
        fail(f"{name}: sq {sq.item()} against {sq_r.item()} (atol {sq_atol:.3e})")
    return dict(max_abs_err=gap, index_mismatches=mismatches, max_tie_gap=rel_gap,
                sq_rel_err=sq_err / abs(sq_r.item()))


def same_bits(name: str, got, again) -> None:
    """Fails unless a second call's outputs equal the first's bit for bit."""
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f"{name}: two calls on the same inputs differ")


def ragged_vq(name: str, fwd, plain, dist_of, dev, g, sq_atol_of=lambda x: 0.0,
              ns=RAGGED_N) -> dict:
    """A VQ forward (``fwd`` gives (q, idx, counts, sq) of (x, codebook)) at N
    rows no multiple of its tiles, against 512 codes: check_vq_fwd against
    its plain version at each N, on the distance ``dist_of(x, codebook)``,
    and a second call the same bits. Returns the mismatches at each N."""
    cb = torch.randn((512, 64), generator=g, device=dev)
    out = {}
    for n in ns:
        x = torch.randn((n, 64), generator=g, device=dev)
        got = fwd(x, cb)
        torch.cuda.synchronize()
        if got[0].shape != (n, 64) or got[1].numel() != n:
            fail(f"{name} at N = {n}: outputs of shapes {[tuple(t.shape) for t in got]}")
        out[n] = check_vq_fwd(f"{name} at N = {n}", got, plain(x, cb), dist_of(x, cb),
                              sq_atol_of(x))["index_mismatches"]
        same_bits(f"{name} at N = {n}", got, fwd(x, cb))
    print(f"[{name}] ragged N, mismatches (each a near-tie), the same bits twice: {out}",
          flush=True)
    return out


def vq_bf16_planted(g, dev):
    """vq_planted's exact ties, made ties of #9's own operands alone: the
    higher code of each pair moves off the lower one by an eighth of its bf16
    low part's ulp, towards cb_hi, in each value where that leaves both bf16
    parts (``split_bf16``) as they were. So the two codes agree in cb_hi and
    cb_lo, and in both modes' distances, and differ in fp32. Returns (x,
    codebook, the lower index each row must get)."""
    from msla_tpu_torch.ops.vq_precision import split_bf16

    x, e, want = vq_planted(torch.randn((512, 64), generator=g, device=dev), False, g)
    pairs = torch.tensor(VQ_PAIRS, device=dev)
    base = e[pairs[:, 0]]
    lo = split_bf16(base)[1].float()
    step = torch.where(lo != 0, -torch.sign(lo) * torch.ldexp(torch.ones_like(lo),
                                                             torch.frexp(lo)[1] - 11), 0.0)
    moved = base + step
    (mh, ml), (bh, bl) = split_bf16(moved), split_bf16(base)
    e[pairs[:, 1]] = torch.where((mh == bh) & (ml == bl), moved, base)
    parts = split_bf16(e)
    if (not all(torch.equal(t[pairs[:, 0]], t[pairs[:, 1]]) for t in parts)
            or (e[pairs[:, 0]] == e[pairs[:, 1]]).all(1).any()):
        fail("planted bf16 ties: a pair differs in cb_hi or cb_lo, or not in fp32")
    return x, e, want


def vq_bf16_planted_picks(fwd, dev, g) -> int:
    """#9's compiled modes, kernel and plain version, on vq_bf16_planted's
    rows: every id the lower index of its pair."""
    from msla_tpu_torch.ops import vq_precision_fwd_ref

    x, e, want = vq_bf16_planted(g, dev)
    for mode in VQ_TOOL_MODES:
        dist_mode, quant_mode = mode.split("/")
        for label, out in (("kernel", fwd(x, e, dist_mode, quant_mode)),
                           ("plain version", vq_precision_fwd_ref(x, e, dist_mode, quant_mode))):
            ids = out[1].flatten().long()
            if not torch.equal(ids, want):
                fail(f"vq_precision_fwd {mode} planted ties: the {label} missed "
                     f"{(ids != want).sum().item()} of {want.numel()} rows")
    print(f"[vq_precision_fwd] {VQ_PLANTED_ROWS} planted ties in cb_hi and cb_lo (apart in "
          f"fp32) to the lower index in {VQ_TOOL_MODES}: every pick right", flush=True)
    return VQ_PLANTED_ROWS


def sass_ops(source: str) -> dict:
    """Each kernel function of a built source with its count of HGMMA
    (wgmma) and HMMA (mma.sync) instructions, from ``cuobjdump -sass``."""
    from msla_tpu_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path(source))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            fn = kernel_name(m.group(1))
            out[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn:
            for op in out[fn]:
                out[fn][op] += bool(re.search(rf"\b{op}\.", line))
    print(f"[sass] {source}: {out}", flush=True)
    return out


def phase_vq_tools(kernels, dev) -> tuple[dict, list[dict]]:
    """The port's two VQ measurement tools through their entry points at their
    full N, then #8 and #9's new modes against their plain versions on the
    tools' own inputs, on planted ties (and #8's close pairs) and at ragged N,
    each twice with the same bits; #9's forwards on wgmma (SASS)."""
    from msla_tpu_torch.ops import (vq_lean_fwd, vq_lean_fwd_ref, vq_precision_bwd,
                                    vq_precision_bwd_ref, vq_precision_fwd, vq_precision_fwd_ref)
    from msla_tpu_torch.ops.vq_lean import sq_error_bound
    from msla_tpu_torch.ops.vq_precision import COMPILED, dotted_norms, split_bf16
    from msla_tpu_torch.tools import bench_vq_lean, bench_vq_precision

    reset_counts(kernels)
    tools = {"bench_vq_lean": bench_vq_lean.main(device=dev),
             "bench_vq_precision": bench_vq_precision.main(device=dev)}
    torch.cuda.synchronize()
    counts = launch_counts(kernels)
    modes = {m: vq_precision_fwd.launches[m] for m in VQ_TOOL_MODES}
    path = ("vq_lean_fwd", "vq_precision_fwd", "vq_precision_bwd", "vq_fused_fwd",
            "vq_codebook_grad")
    if any(counts[name] == 0 for name in path) or 0 in modes.values():
        fail(f"a kernel of the VQ tools' path never launched: {counts}, modes {modes}")
    tools.update(launches=counts, mode_launches=modes)
    print(f"[vq tools] launches {counts}, #9 forward by mode {modes}", flush=True)
    sass = sass_ops("vq_precision")
    hgmma = {f"{dm}/{qm}": sass.get(f"vq_precision_fwd_kernel<{d},{q}>", {})
             for (dm, qm), (d, q) in COMPILED.items()}
    if any(not ops or not ops["HGMMA"] or ops["HMMA"] for ops in hgmma.values()):
        fail(f"#9's forwards must run wgmma (HGMMA) and no mma.sync (HMMA): {hgmma}")
    tools["sass"] = hgmma

    k_codes = bench_vq_lean.K
    gen = torch.Generator(device=dev).manual_seed(12)
    report = []
    with torch.no_grad():
        # #8 in both regimes of its tool; timed on the random rows, as the tool times it
        cb, x_rand, x_conv = bench_vq_lean.inputs(bench_vq_lean.N, dev)
        checks = {}
        for regime, x in (("random", x_rand), ("converged", x_conv)):
            got = vq_lean_fwd(x, cb)
            torch.cuda.synchronize()
            checks[regime] = check_vq_fwd(f"vq_lean_fwd ({regime})", got, vq_lean_fwd_ref(x, cb),
                                          l2_dist(x, cb), sq_error_bound(x))
        x = x_rand
        e2 = (cb * cb).sum(1)

        def lean_library():  # addmm + min + index_select + bincount + (x.x).sum
            m, i = torch.addmm(e2, x, cb.T, alpha=-2.0).min(dim=1)
            return (cb.index_select(0, i), torch.bincount(i, minlength=k_codes),
                    ((x * x).sum(1) + m).sum())

        q, idx, counts_out, sq = got = vq_lean_fwd(x, cb)
        same_bits("vq_lean_fwd", got, vq_lean_fwd(x, cb))
        flop, moved = 2 * x.shape[0] * k_codes * 64, nbytes(x, cb, q, idx, counts_out, sq)
        report.append(dict(
            checks["random"], name="vq_lean_fwd", route="cuda",
            source="msla_tpu_torch/csrc/vq_lean.cu", replaces="tools/bench_vq_lean.py:32",
            sq_rel_err_converged=checks["converged"]["sq_rel_err"],
            index_mismatches_converged=checks["converged"]["index_mismatches"],
            sq_atol_converged=sq_error_bound(x_conv),
            **vq_planted_picks("vq_lean_fwd", lambda x, e: vq_lean_fwd(x, e)[1], dev, gen),
            ragged_n_mismatches=ragged_vq(
                "vq_lean_fwd", vq_lean_fwd, vq_lean_fwd_ref, l2_dist, dev, gen, sq_error_bound),
            ms=time_ms(lambda: vq_lean_fwd(x, cb)), plain_ms=time_ms(lambda: vq_lean_fwd_ref(x, cb)),
            tool_ms=tools["bench_vq_lean"]["lean_ms"],
            gather_ms=time_ms(lambda: cb.index_select(0, idx)),
            library_ms=time_ms(lean_library),
            library_call="addmm(e2, x, cb.T, alpha=-2) + min + index_select + bincount + "
                         "(x*x).sum, fp32",
            flop=flop, bytes=moved, **tf32_bounds(flop, moved)))
        del cb, x_rand, x_conv, x, q, idx

        # #9: the new forward modes, then the split2 gradient, on the precision tool's inputs
        x, cb, g = bench_vq_precision.inputs(bench_vq_precision.N, dev)
        n = x.shape[0]
        planted = vq_bf16_planted_picks(vq_precision_fwd, dev, gen)
        for mode in VQ_TOOL_MODES:
            dist_mode, quant_mode = mode.split("/")
            got = vq_precision_fwd(x, cb, dist_mode, quant_mode)
            torch.cuda.synchronize()
            check = check_vq_fwd(f"vq_precision_fwd {mode}", got,
                                 vq_precision_fwd_ref(x, cb, dist_mode, quant_mode),
                                 mode_dist(x, cb, dist_mode))
            same_bits(f"vq_precision_fwd {mode}", got,
                      vq_precision_fwd(x, cb, dist_mode, quant_mode))
            ragged = ragged_vq(f"vq_precision_fwd {mode}",
                               lambda x, e: vq_precision_fwd(x, e, dist_mode, quant_mode),
                               lambda x, e: vq_precision_fwd_ref(x, e, dist_mode, quant_mode),
                               lambda x, e: mode_dist(x, e, dist_mode), dev, gen)
            hi, lo = split_bf16(cb)
            e2 = dotted_norms(hi, lo, dist_mode)
            q_cb = cb if quant_mode == "f32" else hi.float() + lo.float()

            def library():  # bf16 addmm chain, fp32 out + argmin + gather + bincount + sum
                xh, xl = split_bf16(x)
                dist = torch.addmm(e2, xh, hi.T, alpha=-2.0, out_dtype=torch.float32)
                if dist_mode == "split3":
                    for a, b in ((xh, lo), (xl, hi)):
                        dist = torch.addmm(dist, a, b.T, alpha=-2.0, out_dtype=torch.float32)
                i = dist.argmin(dim=1)
                qq = q_cb.index_select(0, i)
                return torch.bincount(i, minlength=k_codes), ((qq - x) ** 2).sum()

            products = 3 if dist_mode == "split3" else 1
            report.append(dict(
                check, name=f"vq_precision_fwd[{mode}]", route="cuda",
                source="msla_tpu_torch/csrc/vq_precision.cu",
                replaces="tools/bench_vq_precision.py:35", launches=modes[mode],
                planted_ties=planted, ragged_n_mismatches=ragged, hgmma=hgmma[mode]["HGMMA"],
                ms=time_ms(lambda: vq_precision_fwd(x, cb, dist_mode, quant_mode)),
                tool_ms=tools["bench_vq_precision"]["fwd"][mode]["ms"],
                plain_ms=time_ms(lambda: vq_precision_fwd_ref(x, cb, dist_mode, quant_mode)),
                library_ms=time_ms(library),
                library_call=f"{products} bf16 addmm (cuBLAS tensor cores, fp32 output by "
                             f"out_dtype, not rounded) + argmin + index_select + bincount + sum",
                flop=2 * n * k_codes * 64 * products, flop_type="bf16",
                bytes=nbytes(x, cb, *got)))
            del got

        idx = vq_precision_fwd(x, cb, "f32", "f32")[1][:, 0]
        dcb = vq_precision_bwd(g, idx, "split2")
        torch.cuda.synchronize()
        want = vq_precision_bwd_ref(g, idx, "split2")
        err = (dcb - want).abs().max().item()
        if err > 1e-5 * want.abs().max().item():
            fail(f"vq_precision_bwd split2: max abs error {err:.3e} against the plain version")
        if not torch.equal(dcb, vq_precision_bwd(g, idx, "split2")):
            fail("vq_precision_bwd split2: two runs differ")
        # csrc/segment_sum.cuh on the tool's ids, uniform, one code, sorted runs, ragged N
        checks = segment_sum_checks("vq_precision_bwd split2", lambda x, i: vq_precision_bwd(
            x, i, "split2"), g, k_codes, True, gen, idx)
        by_ids = checks.pop("by_ids")
        ids = idx.long()

        def bwd_library():  # the bf16 split, then two index_add_
            hi, lo = split_bf16(g)
            sums = torch.zeros((2, k_codes, 64), device=dev)
            sums[0].index_add_(0, ids, hi.float())
            sums[1].index_add_(0, ids, lo.float())
            return sums[0] + sums[1]

        report.append(dict(
            checks, name="vq_precision_bwd[split2]", route="cuda",
            source="msla_tpu_torch/csrc/segment_sum.cuh",
            replaces="tools/bench_vq_precision.py:139", max_abs_err=err,
            ms=by_ids["model"]["ms"], ms_uniform_ids=by_ids["uniform"]["ms"],
            ms_one_code=by_ids["one code"]["ms"], ms_sorted_runs=by_ids["sorted runs"]["ms"],
            tool_ms=tools["bench_vq_precision"]["bwd"]["split2"]["ms"],
            plain_ms=time_ms(lambda: vq_precision_bwd_ref(g, idx, "split2")),
            library_ms=time_ms(bwd_library),
            library_call="bf16 split + two index_add_", flop=2 * n * 64,
            bytes=nbytes(g, idx, dcb)))
        report[0]["launches"] = counts["vq_lean_fwd"]
        report[-1]["launches"] = counts["vq_precision_bwd"]
        for k in report:
            k["path"] = "vq_tools"
        del x, cb, g, idx, dcb, want
    torch.cuda.empty_cache()
    return tools, with_bounds(report)


BF16_BATCHES = (64, 128)  # the training batch, and fast_serving's (configs/experiment)


#: the operand type each kernel of the bf16 serving paths launches on (the VQ stays fp32)
BF16_PATH = {"conv_stem": torch.bfloat16, "deconv_stem": torch.bfloat16,
             "nearest_codes": torch.float32, "mlm_argmax": torch.bfloat16,
             "mlm_argmax_conf": torch.bfloat16, "flash_attn": torch.bfloat16}


def phase_bf16_sep_kernels(net16, dev) -> list[dict]:
    """K1 and K2 on bf16 operands at the batch-64 separation's shapes against
    their plain bf16 versions on the card, K1 at ragged T, and the cuDNN bf16
    conv pair as the library yardstick."""
    import torch.nn.functional as F

    from msla_tpu_torch.ops import conv_stem, conv_stem_ref, deconv_stem, deconv_stem_ref

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(13)
    enc, dec = net16.encoder, net16.decoder
    w = FRAME // 4
    report = []
    with torch.no_grad():
        x = (torch.randn((BATCH, 4, FRAME), generator=g, device=dev) * 0.3).to(bf)
        args = (x, enc.conv1.weight.to(bf), enc.conv1.bias, enc.conv2.weight.to(bf),
                enc.conv2.bias)
        out = conv_stem(*args)
        torch.cuda.synchronize()
        want, h1 = conv_stem_ref(*args)
        err, beyond, equal = check_bf16("conv_stem bf16", out, want,
                                        stem_terms(h1, args[3], False))
        del want, h1
        lib_w = (args[1], args[2].to(bf), args[3], args[4].to(bf))
        report.append(dict(
            name="conv_stem[bf16]", route="cuda", source="msla_tpu_torch/csrc/conv_stem.cu",
            replaces="msla_tpu/ops/conv_stem.py:48", max_abs_err=err, bit_equal_share=equal,
            beyond_2_ulps_share=beyond,
            ragged_t_max_abs_err=ragged_stem(enc, dev, g, torch.bfloat16),
            ms=time_ms(lambda: conv_stem(*args)), plain_ms=time_ms(lambda: conv_stem_ref(*args)),
            library_ms=time_ms(lambda: F.relu(F.conv1d(
                F.relu(F.conv1d(x, lib_w[0], lib_w[1], 2, 1)), lib_w[2], lib_w[3], 2, 1))),
            library_call="cuDNN bf16 conv1d pair, bf16 biases",
            flop=2 * BATCH * (FRAME // 2 * 64 * 4 * 4 + w * 128 * 64 * 4), flop_type="bf16",
            bytes=nbytes(*args, out)))
        del x, out

        q = torch.rand((BATCH, 128, w), generator=g, device=dev).to(bf)
        args = (q, dec.conv1_transpose.weight.to(bf), dec.conv1_transpose.bias,
                dec.conv2_transpose.weight.to(bf), dec.conv2_transpose.bias)
        out = deconv_stem(*args)
        torch.cuda.synchronize()
        want, h = deconv_stem_ref(*args)
        err, beyond, equal = check_bf16("deconv_stem bf16", out, want,
                                        stem_terms(h, args[3], True))
        del want, h
        lib_w = (args[1], args[2].to(bf), args[3], args[4].to(bf))
        report.append(dict(
            name="deconv_stem[bf16]", route="cuda", source="msla_tpu_torch/csrc/deconv_stem.cu",
            replaces="msla_tpu/ops/deconv_stem.py:35", max_abs_err=err, bit_equal_share=equal,
            beyond_2_ulps_share=beyond, ragged_w_max_abs_err=ragged_deconv(dec, dev, g),
            ms=time_ms(lambda: deconv_stem(*args)),
            plain_ms=time_ms(lambda: deconv_stem_ref(*args)),
            library_ms=time_ms(lambda: F.conv_transpose1d(F.relu(F.conv_transpose1d(
                q, lib_w[0], lib_w[1], 2, 1)), lib_w[2], lib_w[3], 2, 1)),
            library_call="cuDNN bf16 conv_transpose1d pair, bf16 biases",
            flop=2 * BATCH * (2 * w * 64 * 128 * 2 + 4 * w * 4 * 64 * 2), flop_type="bf16",
            bytes=nbytes(*args, out)))
        del q, out
    torch.cuda.empty_cache()
    return with_bounds(report)


def phase_bf16_separation(task16, kernels) -> dict:
    """SourceSeparator with the bf16 VQVAETask through its entry points: a 60 s
    song (plain, overlap, encode_codes), then timed separations at batch 64
    and at fast_serving's 128. The launch counts, of the whole run and of one
    separation at each batch, are read when the entry points' calls end,
    before any timing or breakdown calls a kernel; then device time and parts."""
    from msla_tpu_torch.inference import SourceSeparator

    reset_counts(kernels)
    song = synthetic_mixture(SONG_S, seed=2)
    sep = SourceSeparator(task16, frame_samples=FRAME, batch_size=16)
    stems, stems_ov, codes = sep.separate(song), sep.separate(song, overlap=True), \
        sep.encode_codes(song)
    for name, a, shape in (("bf16 separate", stems, (4, song.size)),
                           ("bf16 separate(overlap)", stems_ov, (4, song.size)),
                           ("bf16 encode_codes", codes, (-(-song.size // FRAME), FRAME // 4))):
        if a.shape != shape or not np.isfinite(a).all():
            fail(f"{name}: shape {a.shape} (want {shape}) or non-finite values")
    if codes.min() < 0 or codes.max() >= MODEL["num_embedding"]:
        fail("bf16 encode_codes: ids out of range")
    result, separators = {}, {}
    for batch in BF16_BATCHES:
        sep_b = SourceSeparator(task16, frame_samples=FRAME, batch_size=batch)
        song_b = synthetic_mixture(batch * FRAME / SR, seed=3)
        sep_b.separate(song_b)                       # warm-up
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts(kernels, BF16_PATH)
        host_s = []
        for _ in range(HOST_RUNS // 2):
            t0 = time.perf_counter()
            out = sep_b.separate(song_b)
            host_s.append(time.perf_counter() - t0)
        per_batch = {name: (n - before[name]) // len(host_s)
                     for name, n in launch_counts(kernels, BF16_PATH).items()}
        if not np.isfinite(out).all():
            fail(f"bf16 batch-{batch} separate: non-finite values")
        if min(per_batch.values()) == 0:
            fail(f"a batch-{batch} bf16 separation launched a kernel of its path on its "
                 f"operand type no time: {per_batch}")
        q1, median, q3 = statistics.quantiles(host_s, n=4)
        result[f"batch{batch}"] = dict(
            launches_per_batch=per_batch,
            host_s=dict(n=len(host_s), median=median, q1=q1, q3=q3, min=min(host_s),
                        max=max(host_s)),
            samples_per_s=batch * FRAME / median,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        separators[batch] = sep_b, sep_b._model_input(song_b.reshape(batch, FRAME))
    counts = launch_counts(kernels, BF16_PATH)
    if min(counts.values()) == 0:
        fail(f"a kernel of the bf16 separation path never launched in bf16: {counts}")
    result["launches"] = counts

    for batch, (sep_b, model_in) in separators.items():
        r = result[f"batch{batch}"]
        r["device_ms"] = time_ms(lambda: sep_b._separate(model_in), reps=10, warmup=2)
        r.update(device_samples_per_s=batch * FRAME / (r["device_ms"] / 1e3),
                 device_busy_share=r["device_ms"] / 1e3 / r["host_s"]["median"],
                 breakdown_ms=device_parts(lambda: sep_b._separate(model_in)))
        print(f"[bf16 separation] batch {batch}: {r}", flush=True)
    return result


def phase_bf16_separation_cpu(task16) -> dict:
    """The card's bf16 codes against the CPU's plain bf16 path on 2 frames:
    at least 99 % equal, each differing code a near-tie on the card's own
    latents: the two picks' fp64 distance gap within 4 bf16 ulps of each term
    of 2·z·(e_a − e_b), what the two latents' bf16 roundings may move it."""
    from msla_tpu_torch.models.vqvae import VQVAETask

    cpu = VQVAETask(**MODEL, checkpoint_dir=".", codebook_file="codebook.csv", device="cpu",
                    compute_dtype="bfloat16")
    cpu.net.load_state_dict({k: v.cpu() for k, v in task16.net.state_dict().items()})
    frames = synthetic_mixture(2 * FRAME / SR, seed=4).reshape(2, 1, FRAME).repeat(4, axis=1)
    x_cpu = torch.from_numpy(np.ascontiguousarray(frames))
    with torch.inference_mode():
        zg = task16.net.encode(x_cpu.cuda()).cpu().reshape(-1, MODEL["embedding_dim"])
        ig = task16.get_quantized(x_cpu.cuda()).encoding_indices.cpu().flatten()
        ic = cpu.get_quantized(x_cpu).encoding_indices.flatten()
        stems_g = task16.net.decode_indices(ic.reshape(2, -1).cuda()).cpu()
        stems_c = cpu.net.decode_indices(ic.reshape(2, -1))
    agree = (ig == ic).double().mean().item()
    if agree < 0.99:
        fail(f"bf16 card vs CPU: only {agree:.5f} of codes agree")
    cb = cpu.net.vector_quantizer.codebook.weight.detach().double()
    rows = (ig != ic).nonzero().flatten()
    z, ea, eb = zg[rows].double(), cb[ig[rows].long()], cb[ic[rows].long()]
    gap = ((eb * eb).sum(1) - 2 * (z * eb).sum(1)) - ((ea * ea).sum(1) - 2 * (z * ea).sum(1))
    limit = 2.0 ** -6 * 2 * (z.abs() * (ea - eb).abs()).sum(1)
    if (gap.abs() > limit).any():
        fail(f"bf16 card vs CPU: a differing code is no near-tie on the card's latents "
             f"({(gap.abs() / limit).max().item():.2f} of the bound)")
    scale = stems_c.abs().max().item()
    dec_err = (stems_g - stems_c).abs().max().item()
    if dec_err > 0.02 * scale:
        fail(f"bf16 decode_indices card vs CPU: {dec_err:.3e} beyond 0.02 of {scale:.3e}")
    result = dict(code_agreement=agree, code_mismatches=rows.numel(),
                  max_share_of_tie_bound=(gap.abs() / limit).max().item() if rows.numel() else 0.0,
                  decode_indices_max_abs_err=dec_err, decode_scale=scale)
    print(f"[bf16 cpu-vs-card] {json.dumps(result)}", flush=True)
    return result


def attention_bound(q, k, v, mask, sm_scale: float = 0.125) -> torch.Tensor:
    """2·2⁻⁹·Σₖ pₖ|vₖ| + 1e-5 per (sequence, head, row, column) of (B, S, H, D)
    bf16 q, k, v: what rounding P to bf16 at two different points may cost."""
    from msla_tpu_torch.ops import attention_ref

    bhsd = [t.transpose(1, 2) for t in (q, k, v.abs())]
    # p·|v| with p unrounded: the chain on fp32 copies of the rounded operands
    pv = attention_ref(*(t.float() for t in bhsd), mask, sm_scale)
    return (2 * 2.0 ** -9 * pv + 1e-5).transpose(1, 2)


#: #7 with a short last key tile and a short last query tile: (S, sm_scale),
#: the second scale no power of two (the kernel multiplies by it per score)
RAGGED_S = ((130, 0.125), (384 + 17, 0.1))


def attention_accumulation_bound(q, k, v, mask, sm_scale):
    """The exact attention of fp32 (B, Sq, H, D) q and (B, Sk, H, D) k, v in
    fp64 (the mask's bias added unrounded), and an upper bound, per output
    value, on how far #7 fp32 (3xTF32 on mma.sync; the tuned kernel at D =
    64, csrc/flash_any.cu elsewhere) may fall from it; both (B, Sq, H, D).

    The model is #6's (``accumulation_bound``): each accumulation into the
    tensor cores' fp32 accumulator is off by less than one fp32 ulp of the sum
    of its terms' magnitudes so far, and ulp(x) <= 2^-23·x. Per query row:
    - scores: Q·Kᵀ runs 3 products (lo·hi, hi·lo, hi·hi) in each of ⌈D/8⌉ k8
      steps (D padded to 8 with zeros), 3⌈D/8⌉ accumulations of at most
      2^-23·A_k each, A_k = Σ_d |q_d||k_d|; the split drops lo·lo and the
      parts' remainders, at most 3·2^-22·A_k: so |δs_k| <= (3⌈D/8⌉ +
      7)·2^-23·A_k, times sm_scale (a power of two is folded into q exactly;
      another scale's product rounds once more, within the 7);
    - exp: ex2.approx of z·log2(e) − m·log2(e) (one FFMA after one product)
      or of (z − m)·log2(e): p_k off by a factor 1 + η_k, |η_k| <= 2^-21 +
      2^-22·|z_k − m| (twice what the approximation and the roundings allow;
      a factor common to a row's p and to its l cancels);
    - both reach the output through ∂out/∂z_k = p_k(v_k − out), and
      |v_k − out| <= |v_k| + |out|: Σ_k p_k w_k (|v_k| + |out|), with w_k the
      bound on sm_scale·|δs_k| plus that on |η_k|;
    - P·V: 3 products in each of S'/8 k8 steps (S' = Sk rounded up to 64), each
      accumulation off by at most 2^-23·Σ_k p_k|v_k| once the running rescales
      (factors <= 1) are applied, the split's 3·2^-22·Σ_k p_k|v_k|, and the
      S'/32 rescales' products (a tile of 64 keys, or of 32 at D > 128),
      2^-24 each;
    - l: S' positive terms summed in fp32, then 1/l and o·(1/l): at most
      (S' + 1)·2^-24·|out|.
    The sum is first order in roundings that are each below 1e-5 here; plain
    single-pass TF32 products are off by ~2^-11·A_k, some 70 times the score
    term. Sequences whose keys are all padding are not held to it: the fp32
    chain rounds all their scores to one value, which fp64 does not."""
    qd, kd, vd = (t.double().transpose(1, 2) for t in (q, k, v))  # (B, H, S, D)
    n, d = k.shape[1], q.shape[3]
    n_pad = -(-n // 64) * 64
    z = attention_scores64(qd, kd, mask, sm_scale)
    p = torch.softmax(z, dim=-1)
    out = p @ vd
    u = 2.0 ** -23
    w = (sm_scale * (3 * -(-d // 8) + 7) * u * (qd.abs() @ kd.abs().transpose(-1, -2))
         + 2.0 ** -21 + 2.0 ** -22 * (z - z.amax(-1, keepdim=True)).abs())
    pw = p * w
    bound = (pw @ vd.abs() + out.abs() * pw.sum(-1, keepdim=True)
             + (3 * n_pad / 8 * u + 3 * 2.0 ** -22 + n_pad / 32 * 2.0 ** -24) * (p @ vd.abs())
             + (n_pad + 1) * 2.0 ** -24 * out.abs())
    return out.transpose(1, 2), bound.transpose(1, 2)


def attention_scores64(qd, kd, mask, sm_scale):
    """fp64 (B, H, Sq, Sk) scores of (B, H, S, D) fp64 q, k: scaled, plus the
    mask's bias, unrounded."""
    z = (qd @ kd.transpose(-1, -2)) * sm_scale
    if mask is not None:
        z = z + ((1.0 - mask.double()) * -1e9)[:, None, None, :]
    return z


def attention_grad_bound(q, k, v, mask, sm_scale, d_out):
    """The exact gradients (dq, dk, dv) of fp32 attention on (B, Sq, H, D) q,
    d_out and (B, Sk, H, D) k, v in fp64, and an upper bound per value on how
    far #7 fp32's backward (csrc/flash_bwd.cu, 3xTF32 on mma.sync, after the
    forward's lse and O) may fall from each; all (B, S, H, D).

    The model is the forward's (``attention_accumulation_bound``), first
    order, u = 2^-23, ⌈·/8⌉ k8 steps of 3 accumulations plus 7 for the
    split's remainders:
    - s: sm_scale·(3⌈D/8⌉ + 7)·u·A_ik, A = |Q|·|K|ᵀ;
    - lse (the forward's): Σ_k p·δs, the exponentials' 2^-21 + 2^-22·Σ_k p|z
      − m|, the log's and l's roundings, 2^-22·(|m − shift| + |lse|) and
      (S' + 2)·2^-24 (S' = Sk rounded up to 64); the one-FFMA exponent's
      factor 2^(m log2(e) − ml) lies inside 2^-22·|m|;
    - P = exp((s − shift) − lse): relative error ε = δs + δlse + 2^-21 +
      2^-22·(|z − shift − lse| + |lse|) (ex2.approx and the argument's
      roundings);
    - dP = dO·Vᵀ: (3⌈D/8⌉ + 7)·u·|dO|·|V|ᵀ; Dᵢ = Σ dO∘O reads the forward's O,
      whose error the forward's bound gives: Σ|dO|·δO + (D + 2)·2^-24·Σ|dO||O|;
    - dS = P·(dP − Dᵢ)·sm_scale: sm_scale·(P·ε·|dP − Dᵢ| + P·(δdP + δDᵢ) +
      3·2^-24·P·|dP − Dᵢ|);
    - dQ = dS·K, dK = dSᵀ·Q, dV = Pᵀ·dO: the operand's error through the
      product, Σ δdS·|K| (or Σ P·ε·|dO|), plus the 3xTF32 accumulation over
      the keys (dQ) or queries (dK, dV), (3⌈S'/8⌉ + 7)·u·Σ|terms|.
    Plain single-pass TF32 products are off by ~2^-11 of their terms, some
    100 times this at the widths here. Sequences whose keys are all padding
    are not held to it (the fp32 chain rounds their scores to one value)."""
    from msla_tpu_torch.ops.flash_attn import attention_shift

    qd, kd, vd, gd = (t.double().transpose(1, 2) for t in (q, k, v, d_out))
    s_q, s_k, d = q.shape[1], k.shape[1], q.shape[3]
    u = 2.0 ** -23
    pad_q, pad_k = -(-s_q // 64) * 64, -(-s_k // 64) * 64
    steps_d = 3 * -(-d // 8) + 7
    z = attention_scores64(qd, kd, mask, sm_scale)
    shift = attention_shift(mask, q.shape[0], q.device).double()[:, None, None, None]
    p = torch.softmax(z, dim=-1)
    o = p @ vd
    lse = torch.logsumexp(z - shift, dim=-1, keepdim=True)
    zmax = z.amax(-1, keepdim=True)
    dp = gd @ vd.transpose(-1, -2)
    delta = (gd * o).sum(-1, keepdim=True)
    ds = p * (dp - delta) * sm_scale
    grads = (ds @ kd, ds.transpose(-1, -2) @ qd, p.transpose(-1, -2) @ gd)
    _, e_o = attention_accumulation_bound(q, k, v, mask, sm_scale)
    e_o = e_o.double().transpose(1, 2)
    e_s = sm_scale * steps_d * u * (qd.abs() @ kd.abs().transpose(-1, -2))
    e_lse = ((p * e_s).sum(-1, keepdim=True) + 2.0 ** -21
             + 2.0 ** -22 * ((p * (z - zmax).abs()).sum(-1, keepdim=True)
                             + (zmax - shift).abs() + lse.abs())
             + (pad_k + 2) * 2.0 ** -24)
    eps = e_s + e_lse + 2.0 ** -21 + 2.0 ** -22 * ((z - shift - lse).abs() + lse.abs())
    e_p = p * eps
    e_dp = steps_d * u * (gd.abs() @ vd.abs().transpose(-1, -2))
    e_delta = ((gd.abs() * e_o).sum(-1, keepdim=True)
               + (d + 2) * 2.0 ** -24 * (gd.abs() * o.abs()).sum(-1, keepdim=True))
    r = (dp - delta).abs()
    e_ds = sm_scale * (e_p * r + p * (e_dp + e_delta) + 3 * 2.0 ** -24 * p * r)
    acc_k, acc_q = (3 * pad_k / 8 + 7) * u, (3 * pad_q / 8 + 7) * u
    bounds = (e_ds @ kd.abs() + acc_k * (ds.abs() @ kd.abs()),
              e_ds.transpose(-1, -2) @ qd.abs() + acc_q * (ds.abs().transpose(-1, -2) @ qd.abs()),
              e_p.transpose(-1, -2) @ gd.abs() + acc_q * (p.transpose(-1, -2) @ gd.abs()))
    return tuple(t.transpose(1, 2) for t in grads), tuple(t.transpose(1, 2) for t in bounds)


def attention_bf16_grad_bound(q, k, v, mask, sm_scale, out, lse, d_out, want):
    """How far #7's bf16 backward may lie from ``attention_bwd_ref`` on the
    same bf16 (B, S, H, D) q, k, v, the kernel's own fp32 out and lse, and
    d_out, given ``want`` = attention_bwd_ref's (dq, dk, dv): per value,
    2⁻⁷·(Σ|terms| + |want|) + 2⁻¹⁴·Σ|terms| + the cancellation slack + 1e-6.

    Both round dO, P, dS·sm_scale and the result to bf16 at the same points.
    Their fp32 values before each rounding differ in the last bits only (the
    sums' order; ex2.approx against exp: ~2⁻²¹ relative), so where one lies
    at a bf16 rounding boundary the two round it one bf16 ulp apart, at most
    2⁻⁷ of it: over a sum, 2⁻⁷·Σ|terms| (Σ P|dO| for dV, Σ|dS||K| for dQ,
    Σ|dS||Q| for dK) for the rounded operand, 2⁻⁷·|want| for the result's
    own rounding, and 2⁻¹⁴·Σ|terms| for the fp32 differences themselves.
    Where dP − Dᵢ cancels, dS's fp32 difference is not relative to it but to
    its parts: sm_scale·P·(D + 2)·2⁻²³·(|dO|·|V|ᵀ + Σ|dO||O|) a value, carried
    through the product with K (or Q)."""
    from msla_tpu_torch.ops.flash_attn import _probabilities, _scores

    bq, bk, bv, bo, bdo = (t.transpose(1, 2) for t in (q, k, v, out, d_out))
    d = q.shape[3]
    do = bdo.to(torch.bfloat16).float()
    p = _probabilities(_scores(bq, bk, mask, sm_scale), mask, lse)
    dp = do @ bv.float().transpose(-1, -2)
    delta = (do * bo).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * sm_scale).abs()
    slack = sm_scale * p * (d + 2) * 2.0 ** -23 * (
        do.abs() @ bv.float().abs().transpose(-1, -2) + (do.abs() * bo.abs()).sum(-1, keepdim=True))
    qa, ka = bq.float().abs(), bk.float().abs()
    terms = (ds @ ka, ds.transpose(-1, -2) @ qa, p.transpose(-1, -2) @ do.abs())
    slacks = (slack @ ka, slack.transpose(-1, -2) @ qa, torch.zeros_like(terms[2]))
    return tuple((2.0 ** -7 * (t + w.float().abs().transpose(1, 2)) + 2.0 ** -14 * t + sl
                  + 1e-6).transpose(1, 2) for t, w, sl in zip(terms, want, slacks))


def fp64_share(name: str, got, q, k, v, mask, want=None, sm_scale: float = 0.125) -> float:
    """#7 fp32's largest error against fp64 as a share of
    ``attention_accumulation_bound``; fails above 1. With ``want`` (the
    plain version's fp32 output) prints that one's share beside it."""
    exact, limit = attention_accumulation_bound(q, k, v, mask, sm_scale)
    share = ((got.double() - exact).abs() / limit).max().item()
    plain = "" if want is None else \
        f", the plain fp32 chain's {((want.double() - exact).abs() / limit).max().item():.3f}"
    print(f"[flash_attn] {name}: against fp64, {share:.3f} of the 3xTF32 accumulation bound "
          f"(largest error {(got.double() - exact).abs().max().item():.3e}){plain}", flush=True)
    if share > 1:
        fail(f"{name}: off fp64 by {share:.2f}x what its 3xTF32 accumulation may lose")
    return share


def ragged_attention(dev, g, dtype) -> dict:
    """#7 at lengths S that are no multiple of 64, with their sm_scale
    (RAGGED_S), 4 sequences of 12 heads: sequence 1 with its last third of
    keys padding, sequence 3 all padding (its output the mean of v). fp32
    at atol = rtol = 1e-4 and within the fp64 accumulation bound on the
    other three, bf16 within ``attention_bound``. Returns the largest error
    at each S."""
    from msla_tpu_torch.ops import attention_ref, flash_attn

    errs = {}
    for n, scale in RAGGED_S:
        q, k, v = (torch.randn((4, n, 12, 64), generator=g, device=dev).to(dtype)
                   for _ in range(3))
        mask = torch.ones((4, n), device=dev)
        mask[1, 2 * n // 3:] = 0.0
        mask[3] = 0.0
        out = flash_attn(q, k, v, mask, scale)
        torch.cuda.synchronize()
        if out.shape != (4, n, 12, 64) or out.dtype != torch.float32:
            fail(f"flash_attn at S = {n}: a {out.dtype} output of shape {tuple(out.shape)}")
        want = attention_ref(*(t.transpose(1, 2) for t in (q, k, v)), mask, scale)
        want = want.transpose(1, 2)
        name = f"flash_attn {dtype} at S = {n}, sm_scale = {scale}"
        mean_v = v[3].float().mean(dim=0, keepdim=True).expand(n, -1, -1)
        check_close(name + " (all keys padding: the mean of v)", out[3], mean_v)
        if dtype == torch.float32:
            errs[n] = check_close(name, out, want)
            fp64_share(name, out[:3], q[:3], k[:3], v[:3], mask[:3], sm_scale=scale)
        else:
            err, limit = (out - want).abs(), attention_bound(q, k, v, mask, scale)
            if not torch.isfinite(out).all() or (err > limit).any():
                fail(f"{name}: {(err > limit).sum().item()} values beyond "
                     f"2·2⁻⁹·Σ p|v| + 1e-5")
            errs[n] = err.max().item()
    print(f"[kernel] #7 {dtype} at ragged S: {errs}", flush=True)
    return errs


#: K2's tiles are 120 positions in bf16 and 60 in fp32; W % 8 != 0 breaks
#: bf16's 16-byte loads and W % 4 != 0 fp32's (368 % 8 == 0: 16-byte loads)
RAGGED_W = (1, 2, 59, 60, 61, 119, 121, 240, 361, 368)


def ragged_deconv(dec, dev, g, dtype=torch.bfloat16) -> dict:
    """K2 and K2b at widths W around their tiles (RAGGED_W), batch 4, with the
    decoder's weights, and K2's output equal to K2b's bit for bit. fp32: the
    output and hidden at atol = rtol = 1e-4 of the plain version and within
    the fp64 accumulation bound. bf16: K2b's hidden within 2 bf16 ulps of
    the plain version's, K2b's output within 2 ulps of the plain second
    layer (fp32, TF32 off) on K2b's own hidden (the same exact products
    summed in fp32 in another order, one rounding each). Returns the largest
    error at each W."""
    import torch.nn.functional as F

    from msla_tpu_torch.ops import deconv_stem, deconv_stem_ref, deconv_stem_save_hidden
    from msla_tpu_torch.ops.conv_adjoints import fp32_convs

    weights = (dec.conv1_transpose.weight.detach().to(dtype), dec.conv1_transpose.bias.detach(),
               dec.conv2_transpose.weight.detach().to(dtype), dec.conv2_transpose.bias.detach())
    errs = {}
    for w in RAGGED_W:
        args = (torch.rand((4, 128, w), generator=g, device=dev).to(dtype), *weights)
        out, h = deconv_stem_save_hidden(*args)
        out_k2 = deconv_stem(*args)
        want_out, want_h = deconv_stem_ref(*args)
        torch.cuda.synchronize()
        if out.shape != (4, 4, 4 * w) or h.shape != (4, 64, 2 * w):
            fail(f"deconv_stem {dtype} at W = {w}: shapes {tuple(out.shape)}, {tuple(h.shape)}")
        name = f"deconv_stem {dtype} at W = {w}"
        if dtype == torch.float32:
            errs[w] = max(check_close(name, out, want_out),
                          check_close(name + " hidden", h, want_h))
            stem_fp64_share(name, stem_accumulation_bound(*args, transposed=True), out, h)
        else:
            with fp32_convs():
                want = F.conv_transpose1d(h.float(), args[3].float(), args[4], 2, 1).to(dtype)
            zero = torch.zeros_like(want, dtype=torch.float32)
            err = check_bf16(name + " (layer 2 on its own hidden)", out, want, zero)[0]
            err_h = check_bf16(name + " hidden", h, want_h,
                               torch.zeros_like(h, dtype=torch.float32))[0]
            errs[w] = max(err, err_h)
        if not torch.equal(out, out_k2):
            fail(f"{name}: K2 and K2b give different outputs")
    print(f"[kernel] K2/K2b {dtype} at ragged W: {errs}", flush=True)
    return errs


def phase_bf16_bert_kernels(bert16, dev) -> list[dict]:
    """#7, #6 and #6b on bf16 operands at the batch-16 call's shapes against
    their plain bf16 versions on the card."""
    import torch.nn.functional as F

    from msla_tpu_torch.ops import (attention_ref, flash_attn, mlm_argmax, mlm_argmax_conf,
                                    mlm_argmax_ref)

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(17)
    report = []
    with torch.inference_mode():
        shape = (BERT_SEQS, 512, 12, 64)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(bf) for _ in range(3))
        mask = batch16_mask(dev)
        out = flash_attn(q, k, v, mask, 0.125)
        torch.cuda.synchronize()
        if out.dtype != torch.float32:
            fail(f"flash_attn bf16: a {out.dtype} output")
        bhsd = [t.transpose(1, 2) for t in (q, k, v)]
        want = attention_ref(*bhsd, mask, 0.125).transpose(1, 2)
        err = (out - want).abs()
        limit = attention_bound(q, k, v, mask)
        if not torch.isfinite(out).all() or (err > limit).any():
            fail(f"flash_attn bf16: {(err > limit).sum().item()} values beyond "
                 f"2·2⁻⁹·Σ p|v| + 1e-5 (max abs error {err.max().item():.3e})")
        mean_v = v[-1].float().mean(dim=0, keepdim=True).expand(512, -1, -1)
        check_close("flash_attn bf16 (all keys padding: the mean of v)", out[-1], mean_v)
        share = (err / limit).max().item()
        del want, limit
        keep = mask.bool()[:, None, None, :]
        report.append(dict(
            name="flash_attn[bf16]", route="cuda", source="msla_tpu_torch/csrc/flash_attn.cu",
            replaces="msla_tpu/ops/flash_attn.py:51", max_abs_err=err.max().item(),
            max_share_of_bound=share,
            ragged_s_max_abs_err=ragged_attention(dev, g, torch.bfloat16),
            ms=time_ms(lambda: flash_attn(q, k, v, mask, 0.125)),
            plain_ms=time_ms(lambda: attention_ref(*bhsd, mask, 0.125)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                *bhsd, attn_mask=keep, scale=0.125)),
            library_call="scaled_dot_product_attention, bf16, boolean key mask",
            flop=4 * BERT_SEQS * 12 * 512 * 512 * 64, flop_type="bf16",
            bytes=nbytes(q, k, v, out, mask)))
        del q, k, v, out, bhsd, err
        torch.cuda.empty_cache()

        emb = bert16._decoder_weights()[0]
        if emb.dtype != bf:
            fail(f"bf16 Audio-BERT: a {emb.dtype} tied decoder")
        bias = torch.randn((emb.shape[0],), generator=g, device=dev) * 0.1
        h = torch.randn((BERT_ROWS, 768), generator=g, device=dev).to(bf)
        ids = mlm_argmax(h, emb, bias)
        ids_c, conf_c = mlm_argmax_conf(h, emb, bias)
        torch.cuda.synchronize()
        want_ids, want_conf = mlm_argmax_ref(h, emb, bias, with_conf=True)
        mismatches, gap = mlm_near_ties(h, emb, bias, ids, want_ids)
        mismatches_c, gap_c = mlm_near_ties(h, emb, bias, ids_c, want_ids)
        print(f"[mlm_argmax bf16] {BERT_ROWS} rows: {mismatches} near-tie mismatches (largest "
              f"relative gap {gap:.3e}), conf variant {mismatches_c} ({gap_c:.3e})", flush=True)
        if not torch.equal(ids, ids_c):
            fail("mlm_argmax and mlm_argmax_conf pick different ids in bf16")
        conf_err = check_close("mlm_argmax_conf bf16 conf", conf_c, want_conf, atol=0.0,
                               rtol=1e-4)
        if not torch.equal(conf_c, mlm_argmax_conf(h, emb, bias)[1]):
            fail("mlm_argmax_conf bf16: two runs give different confidences")
        del want_ids, want_conf
        ties = planted_ties(h, emb, bias)
        small = mlm_bf16_small_shapes(emb, bias, g)
        probes = mlm_bf16_probes(h, emb, bias)

        def library(with_conf):  # bf16 addmm with fp32 output + argmax (+ logsumexp)
            for chunk in h.split(4096):
                logits = torch.addmm(bias, chunk, emb.T, out_dtype=torch.float32)
                logits.argmax(dim=-1)
                if with_conf:
                    torch.logsumexp(logits, dim=-1)

        flop = 2 * BERT_ROWS * emb.shape[0] * 768
        for name, line, with_conf in (("mlm_argmax", 47, False), ("mlm_argmax_conf", 67, True)):
            fn = mlm_argmax_conf if with_conf else mlm_argmax
            outs = (ids_c, conf_c) if with_conf else (ids,)
            report.append(dict(
                name=f"{name}[bf16]", route="cuda", source="msla_tpu_torch/csrc/mlm_argmax.cu",
                replaces=f"msla_tpu/ops/mlm_argmax.py:{line}",
                max_abs_err=conf_err if with_conf else gap,
                index_mismatches=mismatches_c if with_conf else mismatches,
                max_tie_gap=gap_c if with_conf else gap, rows_compared=BERT_ROWS,
                planted_ties=ties, small_shapes=small,
                previous_ms=probes["first kernel" + (", conf" if with_conf else "")],
                probe_ms=probes, ms=time_ms(lambda: fn(h, emb, bias)),
                plain_ms=time_ms(lambda: mlm_argmax_ref(h, emb, bias, with_conf=with_conf)),
                library_ms=time_ms(lambda: library(with_conf)),
                library_call="bf16 addmm (cuBLAS, fp32 output by out_dtype) + argmax"
                + (" + logsumexp" if with_conf else "") + ", 4,096-row chunks",
                flop=flop, flop_type="bf16", bytes=nbytes(h, emb, bias, *outs)))
        del h, ids, ids_c, conf_c
    torch.cuda.empty_cache()
    return with_bounds(report)


#: (M, V) of #6/#6b bf16 beside the batch-16 call's: one row; 129 and 257
#: rows, whose last 128-row block has a cluster partner with no rows (the
#: kernel's clusters are two blocks along M); V = 100, less than one
#: 256-wide vocab tile
MLM_SMALL = ((1, 30_522), (129, 30_522), (257, 30_522), (1, 100), (129, 100), (257, 100))


def mlm_bf16_small_shapes(emb, bias, g) -> dict:
    """#6 and #6b on bf16 operands at ``MLM_SMALL``, against the plain
    version: ids equal or near-ties, the two variants' ids equal, a planted
    tie of row 0 between columns 1 and V - 1 (two threads' slices, and two
    tiles where V > 256) to the lower, conf within rtol 1e-4 and the same
    bits twice. An mbarrier wait that hangs traps in the kernel
    (csrc/mlm_argmax.cu), and the launch's error fails the run here."""
    from msla_tpu_torch.ops import mlm_argmax, mlm_argmax_conf, mlm_argmax_ref

    out = {}
    for m, v in MLM_SMALL:
        h = torch.randn((m, 768), generator=g, device=emb.device).to(torch.bfloat16)
        e, b = emb[:v].clone(), bias[:v].clone()
        e[1] = e[v - 1] = (3.0 * h[0].float() / h[0].float().norm()).to(torch.bfloat16)
        b[1] = b[v - 1] = 0.0
        ids = mlm_argmax(h, e, b)
        ids_c, conf = mlm_argmax_conf(h, e, b)
        torch.cuda.synchronize()
        want, want_conf = mlm_argmax_ref(h, e, b, with_conf=True)
        name = f"mlm_argmax bf16 at M = {m}, V = {v}"
        n = mlm_near_ties(h, e, b, ids, want)[0]
        if not torch.equal(ids, ids_c) or ids[0].item() != 1 or want[0].item() != 1:
            fail(f"{name}: the variants' ids differ, or the planted tie did not go to column 1")
        err = check_close(name + " conf", conf, want_conf, atol=0.0, rtol=1e-4)
        if not torch.equal(conf, mlm_argmax_conf(h, e, b)[1]):
            fail(f"{name}: two runs give different confidences")
        out[f"{m}x{v}"] = dict(index_mismatches=n, conf_max_abs_err=err)
    print(f"[mlm_argmax bf16] small shapes: {out}", flush=True)
    return out


def mlm_bf16_probes(h, emb, bias) -> dict:
    """The first bf16 kernel, kept in csrc/mlm_argmax_probe.cu, timed on the
    batch-16 call's operands beside its successor: as it was (probe 0, both
    variants; its ids held to the plain version's near-tie rule), and (a)
    without its fold, (b) with every block reading vocab tile 0's rows of E,
    so that E stays in L2, (c) without the mainloop's __syncthreads (wrong
    ids; timing only). Median ms of 20 CUDA-event-timed calls."""
    from msla_tpu_torch.ops import mlm_argmax_ref
    from msla_tpu_torch.ops._build import check, kernel, stream_of

    fn = kernel("mlm_argmax_bf16_probe")
    m, v = h.shape[0], emb.shape[0]
    ids = torch.empty((m,), dtype=torch.int32, device=h.device)
    conf = torch.empty((m,), dtype=torch.float32, device=h.device)

    def run(probe, with_conf=0):
        check("mlm_argmax_bf16_probe", fn(probe, with_conf, h.data_ptr(), emb.data_ptr(),
                                          bias.data_ptr(), ids.data_ptr(), conf.data_ptr(), m,
                                          v, stream_of(h)))

    run(0)
    torch.cuda.synchronize()
    mlm_near_ties(h, emb, bias, ids, mlm_argmax_ref(h, emb, bias))
    times = {"first kernel": time_ms(lambda: run(0)),
             "first kernel, conf": time_ms(lambda: run(0, 1)),
             "(a) no fold": time_ms(lambda: run(1)),
             "(b) E tile 0 for every tile": time_ms(lambda: run(2)),
             "(c) no __syncthreads": time_ms(lambda: run(3))}
    print(f"[probe] the first mlm_argmax bf16 at M = {m}, V = {v}: {times}", flush=True)
    return times


def phase_bf16_bert_serving(bert16, vq16, kernels) -> dict:
    """AudioGenerator with the bf16 Audio-BERT over the bf16 VQ-VAE through its
    entry points; every kernel of the path launched in bf16 (K3 in fp32);
    the batch-16 corrupt_and_generate timed as in phase 10."""
    from msla_tpu_torch.inference import AudioGenerator

    gen = AudioGenerator(bert16, vq16)
    stems = synthetic_stems(1, seed=20)[0][:BERT_BATCH]
    reset_counts(kernels)
    out = gen.corrupt_and_generate(stems, corrupt_stem=1, rng=np.random.default_rng(0))
    codes = gen.sample_codes(width=FRAME // 4, batch=1, rounds=4, seed=0)
    wave = gen.generate_waveform(width=FRAME // 4, batch=1, rounds=4, seed=1)
    torch.cuda.synchronize()
    counts = launch_counts(kernels, BF16_PATH)
    for name, a, shape in (("bf16 corrupt_and_generate", out, (BERT_BATCH, 4, FRAME)),
                           ("bf16 sample_codes", codes, (1, FRAME // 4)),
                           ("bf16 generate_waveform", wave, (1, 4, FRAME))):
        if a.shape != shape or not np.isfinite(a).all():
            fail(f"{name}: shape {a.shape} (want {shape}) or non-finite values")
    if codes.min() < 0 or codes.max() >= MODEL["num_embedding"]:
        fail("bf16 sample_codes: codes out of [0, 512)")
    path = ("mlm_argmax", "mlm_argmax_conf", "flash_attn", "conv_stem", "nearest_codes",
            "deconv_stem")
    if any(counts[name] == 0 for name in path):
        fail(f"a kernel of the bf16 Audio-BERT path never launched in bf16: {counts}")

    torch.cuda.reset_peak_memory_stats()
    before = launch_counts(kernels, BF16_PATH)
    host_s = []
    for i in range(GEN_HOST_RUNS):
        t0 = time.perf_counter()
        gen.corrupt_and_generate(stems, corrupt_stem=1, rng=np.random.default_rng(i))
        host_s.append(time.perf_counter() - t0)
    after = launch_counts(kernels, BF16_PATH)
    per_call = {name: (after[name] - before[name]) // GEN_HOST_RUNS for name in after}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    noisy = stems.copy()
    noisy[:, 1, :] = np.random.default_rng(0).random(FRAME, dtype=np.float32)
    x = torch.from_numpy(noisy).cuda()

    def call():
        with torch.inference_mode():
            return bert16.predict_step((vq16.get_quantized(x).encoding_indices, x))

    device_ms = time_ms(call, reps=5, warmup=1)
    median = statistics.median(host_s)
    codes_per_call = BERT_BATCH * FRAME // 4
    result = dict(launches=counts, launches_per_call=per_call,
                  host_s=dict(n=GEN_HOST_RUNS, median=median, runs=host_s),
                  device_ms=device_ms, codes_per_s=codes_per_call / median,
                  device_codes_per_s=codes_per_call / (device_ms / 1e3),
                  device_busy_share=device_ms / 1e3 / median, peak_mem_gb=peak_gb,
                  breakdown_ms=device_parts(call))
    print(f"[bf16 bert] launches={counts} per call={per_call}; batch-16 corrupt_and_generate "
          f"{median * 1e3:.1f} ms end to end (median of {GEN_HOST_RUNS}), {device_ms:.1f} ms "
          f"on the device, {result['codes_per_s']:.0f} codes/s, peak {peak_gb:.2f} GB, "
          f"breakdown {result['breakdown_ms']}", flush=True)
    return result


def phase_bf16_bert_cpu(bert16) -> dict:
    """code_proposals of the bf16 Audio-BERT, card against the CPU's plain
    bf16 path, on one row of 1,000 codes: vocab ids at least 95 % equal, each
    differing id a bf16 near-tie on the card's own hidden states (the fp64
    logit gap within 4 bf16 ulps of each term, 2⁻⁶·Σₖ |hₖ|·|e_a,k − e_b,k|),
    each confidence within 2·2⁻⁶·max_v Σₖ |hₖ|·|e_v,k| in log (the bounds of
    tests/test_torch_bf16_bert.py)."""
    from msla_tpu_torch.models.bert import AudioBertTask

    cpu = AudioBertTask(**bert_task_args(), device="cpu", seed=0, compute_dtype="bfloat16")
    cpu.net.load_state_dict({k: v.cpu() for k, v in bert16.net.state_dict().items()})
    w = 1000
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, 512, (1, w)))
    tokens[:, ::7] = bert16.config.mask_token_id
    with torch.inference_mode():
        pc, pg = cpu.code_proposals(tokens), bert16.code_proposals(tokens).cpu()
        ic, cc = (t.flatten() for t in cpu._chunked_argmax(tokens, with_conf=True))
        ig, cg = (t.cpu().flatten() for t in bert16._chunked_argmax(tokens.cuda(),
                                                                    with_conf=True))
        tok, am, _ = bert16._fold(tokens.cuda())
        h = torch.cat([bert16.bert(t, a, return_mlm_hidden=True) for t, a in zip(tok, am)])
        h = h.reshape(-1, 768)[:w].cpu().double()
        emb, bias = (t.cpu().double() for t in bert16._decoder_weights())
    agree = (ig == ic).double().mean().item()
    if agree < 0.95:
        fail(f"bf16 code_proposals card vs CPU: only {agree:.4f} of vocab ids agree")
    rows = (ig != ic).nonzero().flatten()
    a, b = ig[rows].long(), ic[rows].long()
    gap = (h[rows] * (emb[a] - emb[b])).sum(1) + bias[a] - bias[b]
    tie = 2.0 ** -6 * (h[rows].abs() * (emb[a] - emb[b]).abs()).sum(1)
    if (gap.abs() > tie).any():
        fail("bf16 code_proposals card vs CPU: a differing id is no bf16 near-tie")
    moved = 2 * 2.0 ** -6 * (h.abs() @ emb.abs().T).max(1).values
    conf_share = ((cg.double().log() - cc.double().log()).abs() / moved).max().item()
    if conf_share > 1:
        fail(f"bf16 code_proposals card vs CPU: a confidence moved {conf_share:.2f}x its bound")
    result = dict(vocab_id_agreement=agree, vocab_id_mismatches=rows.numel(),
                  max_share_of_tie_bound=(gap.abs() / tie).max().item() if rows.numel() else 0.0,
                  max_conf_share_of_bound=conf_share,
                  code_id_agreement=(pc[..., 0] == pg[..., 0]).double().mean().item(),
                  proposal_conf_max_abs_err=(pc[..., 1] - pg[..., 1]).abs().max().item())
    print(f"[bf16 bert cpu-vs-card] {json.dumps(result)}", flush=True)
    return result


def phase_bf16_train_kernels(net16, dev) -> list[dict]:
    """K1b and K2b on bf16 operands at a batch-64 train step's shapes against
    their plain bf16 versions on the card (out as ``check_bf16`` holds it, the
    hidden within 2 bf16 ulps: the same fp32 sums in another order, rounded
    once), K1b in bf16 at lengths T not divisible by 4, each timed beside the
    cuDNN bf16 conv pair, whose first conv's output is the hidden."""
    import torch.nn.functional as F

    from msla_tpu_torch.ops import (conv_stem_ref, conv_stem_save_hidden, deconv_stem_ref,
                                    deconv_stem_save_hidden)

    bf = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(19)
    enc, dec = net16.encoder, net16.decoder
    w = FRAME // 4
    report = []

    def check(name, out, h, ref, args, transposed):
        want, want_h = ref(*args)
        err, beyond, equal = check_bf16(name, out, want, stem_terms(want_h, args[3], transposed))
        err_h, _, equal_h = check_bf16(name + " hidden", h, want_h,
                                       torch.zeros_like(want_h, dtype=torch.float32))
        return dict(max_abs_err=max(err, err_h), bit_equal_share=equal,
                    hidden_bit_equal_share=equal_h, beyond_2_ulps_share=beyond)

    with torch.no_grad():
        x = (torch.randn((BATCH, 4, FRAME), generator=g, device=dev) * 0.3).to(bf)
        args = (x, enc.conv1.weight.to(bf), enc.conv1.bias, enc.conv2.weight.to(bf),
                enc.conv2.bias)
        out, h = conv_stem_save_hidden(*args)
        torch.cuda.synchronize()
        checked = check("conv_stem_save_hidden bf16", out, h, conv_stem_ref, args, False)
        lib_w = (args[1], args[2].to(bf), args[3], args[4].to(bf))
        report.append(dict(
            name="conv_stem_save_hidden[bf16]", route="cuda",
            source="msla_tpu_torch/csrc/conv_stem.cu", replaces="msla_tpu/ops/conv_stem.py:132",
            **checked, ragged_t_max_abs_err=ragged_stem(enc, dev, g, bf, save_hidden=True),
            ms=time_ms(lambda: conv_stem_save_hidden(*args)),
            plain_ms=time_ms(lambda: conv_stem_ref(*args)),
            library_ms=time_ms(lambda: F.relu(F.conv1d(
                F.relu(F.conv1d(x, lib_w[0], lib_w[1], 2, 1)), lib_w[2], lib_w[3], 2, 1))),
            library_call="cuDNN bf16 conv1d pair, bf16 biases",
            flop=2 * BATCH * (FRAME // 2 * 64 * 4 * 4 + w * 128 * 64 * 4), flop_type="bf16",
            bytes=nbytes(*args, out, h)))
        del x, out, h

        q = torch.rand((BATCH, 128, w), generator=g, device=dev).to(bf)
        args = (q, dec.conv1_transpose.weight.to(bf), dec.conv1_transpose.bias,
                dec.conv2_transpose.weight.to(bf), dec.conv2_transpose.bias)
        out, h = deconv_stem_save_hidden(*args)
        torch.cuda.synchronize()
        checked = check("deconv_stem_save_hidden bf16", out, h, deconv_stem_ref, args, True)
        lib_w = (args[1], args[2].to(bf), args[3], args[4].to(bf))
        report.append(dict(
            name="deconv_stem_save_hidden[bf16]", route="cuda",
            source="msla_tpu_torch/csrc/deconv_stem.cu",
            replaces="msla_tpu/ops/deconv_stem.py:132", **checked,
            ragged_w_max_abs_err=ragged_deconv(dec, dev, g),
            ms=time_ms(lambda: deconv_stem_save_hidden(*args)),
            plain_ms=time_ms(lambda: deconv_stem_ref(*args)),
            library_ms=time_ms(lambda: F.conv_transpose1d(F.relu(F.conv_transpose1d(
                q, lib_w[0], lib_w[1], 2, 1)), lib_w[2], lib_w[3], 2, 1)),
            library_call="cuDNN bf16 conv_transpose1d pair, bf16 biases",
            flop=2 * BATCH * (2 * w * 64 * 128 * 2 + 4 * w * 4 * 64 * 2), flop_type="bf16",
            bytes=nbytes(*args, out, h)))
        del q, out, h
    torch.cuda.empty_cache()
    return with_bounds(report)


def phase_bf16_gradients(task16, task, raw: np.ndarray) -> dict:
    """One batch-64 bf16 step's gradients through the kernels against
    plain_loss's on plain bf16 ops on the same card, masking off: the loss
    within rtol 1e-3, and each parameter's gradient within twice the distance
    that bf16 itself puts between plain_loss's bf16 gradients and the fp32
    step's (the bound the CPU tests hold the port's bf16 gradients to against
    the JAX package's). Prints each module's relative distance of the bf16
    gradients from the fp32 step's, on the same weights."""
    from msla_tpu_torch.ops.conv_adjoints import fp32_convs

    task.net.load_state_dict(task16.net.state_dict())
    dm = in_memory_datamodule([], [], masking=False)
    batch = dm.on_after_batch_transfer(torch.from_numpy(raw).to(task16.device))

    def grads(t, plain=False):
        t.net.zero_grad(set_to_none=True)
        loss = plain_loss(t.net, batch)[0] if plain else t.loss_fn(batch, None)[0]
        with fp32_convs():
            loss.backward()
        out = {k: p.grad.detach().clone() for k, p in t.net.named_parameters()}
        t.net.zero_grad(set_to_none=True)
        return loss.item(), out

    (loss16, g16), (plain16, gp16), (loss32, g32) = grads(task16), grads(task16, True), \
        grads(task)
    if abs(loss16 - plain16) > 1e-3 * abs(plain16):
        fail(f"bf16 step: loss {loss16} through the kernels against {plain16} plain")
    shares, vs_fp32 = {}, collections.defaultdict(float)
    for k, g in g16.items():
        err = (g - gp16[k]).abs().max().item()
        bf16_rounding = (gp16[k] - g32[k]).abs().max().item()
        shares[k] = err / bf16_rounding
        if err > 2 * bf16_rounding:
            fail(f"bf16 step: grad {k} {err:.3e} from plain_loss's, beyond twice bf16's own "
                 f"distance from fp32 ({bf16_rounding:.3e})")
        module = k.rsplit(".", 1)[0]
        vs_fp32[module] = max(vs_fp32[module],
                              (g - g32[k]).abs().max().item() / g32[k].abs().max().item())
    result = dict(loss=loss16, loss_plain=plain16, loss_fp32=loss32,
                  max_share_of_bf16_rounding=max(shares.values()),
                  grad_share_of_bf16_rounding=shares,
                  relative_distance_from_fp32_by_module=dict(vs_fp32))
    print(f"[bf16 gradients] {json.dumps(result)}", flush=True)
    return result


BF16_TRAIN_BATCHES, BF16_VAL_BATCHES = 4, 2   # each bf16 Trainer.fit's batches


def bf16_fit_launches(steps: int, val: int) -> dict:
    """The launches of a one-epoch bf16 fit of ``steps`` train steps and
    ``val`` validation batches with a logger, by wrapper and operand type:
    K1b and K2b in bf16 and #5 in fp32 once a step, #4 in fp32 once a batch
    (validation runs its forward too), K1 and K2 in bf16 once a validation
    batch; and the audio demo's forward of one row of the first validation
    batch (the trainer has a logger), K1, #4 and K2 once more; nothing else."""
    bf, f32 = str(torch.bfloat16), str(torch.float32)
    return {"conv_stem_save_hidden": {bf: steps}, "deconv_stem_save_hidden": {bf: steps},
            "vq_codebook_grad": {f32: steps}, "vq_fused_fwd": {f32: steps + val + 1},
            "conv_stem": {bf: val + 1}, "deconv_stem": {bf: val + 1}}


def code_flips(task16, dm, raw: np.ndarray) -> dict:
    """fp32 against bf16 codes of the first train batch's latents (masked as
    the first step masks it) under the bf16 task's weights, each code the fp64
    argmin, so that only the latents differ. Each flip is a bf16 near-tie if
    the bf16 latent's fp64 distance gap between the two codes is within 4 bf16
    ulps of each term of 2·z·(e_a − e_b) (phase 15's bound), else counted as
    not one."""
    from msla_tpu_torch.models.vqvae import VQVAETask

    fp32 = VQVAETask(**MODEL, checkpoint_dir=str(OUT_DIR), codebook_file=str(OUT_DIR / "f.csv"),
                     device=task16.device)
    fp32.net.load_state_dict(task16.net.state_dict())
    z32, z16 = (first_batch_latents(t.net, dm, raw) for t in (fp32, task16))
    cb = task16.net.vector_quantizer.codebook.weight.detach().double()
    e2 = (cb * cb).sum(1)

    def ids(z):
        return torch.cat([(e2 - 2 * zc.double() @ cb.T).argmin(1) for zc in z.split(65536)])

    a, b = ids(z32), ids(z16)
    rows = (a != b).nonzero().flatten()
    z, ea, eb = z16[rows].double(), cb[a[rows]], cb[b[rows]]
    gap = ((ea * ea).sum(1) - 2 * (z * ea).sum(1)) - ((eb * eb).sum(1) - 2 * (z * eb).sum(1))
    limit = 2.0 ** -6 * 2 * (z.abs() * (ea - eb).abs()).sum(1)
    ties = int((gap.abs() <= limit).sum().item())
    out = dict(rows=a.numel(), flips=rows.numel(), flip_share=rows.numel() / a.numel(),
               near_ties=ties, not_near_ties=rows.numel() - ties,
               max_gap_share_of_bound=(gap.abs() / limit).max().item() if rows.numel() else 0.0,
               latent_max_rel_err=((z16 - z32).abs().max() / z32.abs().max()).item())
    print(f"[bf16 code flips] {json.dumps(out)}", flush=True)
    return out


def phase_bf16_training(task16, kernels, fp32_training: dict) -> dict:
    """Trainer.fit of the bf16 VQVAETask at batch 64 and at large_batch's 128
    (configs/experiment/large_batch.yaml), masking on, with ModelCheckpoint,
    EarlyStopping and a CSVLogger (configs/callbacks/default.yaml,
    configs/logger/csv.yaml) under a temporary default_root_dir. The launch
    counts are read right after each fit and must be ``bf16_fit_launches``;
    last.ckpt, the best file and metrics.csv must exist. At batch 64 a fresh
    task resumed by ``fit(ckpt_path="last")`` must stop at the saved step and
    epoch with the saved weights bit for bit, and go on for one more epoch;
    then the fp32-vs-bf16 code flips. Then each batch's step device time and
    parts, samples/s through fit's loop, peak memory and the host seconds of
    one ``save_checkpoint``, beside phase 8's fp32 step of the same run."""
    import tempfile

    from msla_tpu_torch.models.vqvae import VQVAETask
    from msla_tpu_torch.train.callbacks import EarlyStopping, ModelCheckpoint
    from msla_tpu_torch.train.checkpoint import load_checkpoint
    from msla_tpu_torch.train.loggers import CSVLogger
    from msla_tpu_torch.train.trainer import Trainer

    start = {k: v.clone() for k, v in task16.net.state_dict().items()}
    result = {}
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as root:
        for batch in BF16_BATCHES:
            run_dir = Path(root) / f"batch{batch}"

            def trainer_for(max_epochs):
                return Trainer(default_root_dir=str(run_dir), max_epochs=max_epochs, seed=0,
                               enable_progress_bar=False, log_every_n_steps=2,
                               callbacks=[ModelCheckpoint(dirpath=str(run_dir / "checkpoints"),
                                                          filename="best_vqvae"),
                                          EarlyStopping()],
                               logger=CSVLogger(str(run_dir / "csv")))

            task16.net.load_state_dict(start)
            train = synthetic_stems(BF16_TRAIN_BATCHES, seed=30 + batch, batch=batch)
            dm = in_memory_datamodule(train, synthetic_stems(BF16_VAL_BATCHES, 31 + batch, batch),
                                      batch=batch)
            trainer = trainer_for(1)
            reset_counts(kernels)
            t0 = time.perf_counter()
            trainer.fit(task16, dm)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            counts = {k.__name__: {str(t): n for t, n in k.launches.items()}
                      for k in kernels if k.launches}
            want = bf16_fit_launches(BF16_TRAIN_BATCHES, BF16_VAL_BATCHES)
            if counts != want:
                fail(f"bf16 fit at batch {batch}: launches {counts}, want {want}")
            cm = trainer.callback_metrics
            if len(cm) != 21 or not all(np.isfinite(v) for v in cm.values()):
                fail(f"bf16 fit at batch {batch}: {len(cm)} metrics, or a non-finite one: {cm}")
            for path in ("checkpoints/last.ckpt", "checkpoints/best_vqvae.ckpt",
                         "csv/metrics.csv"):
                if not (run_dir / path).exists():
                    fail(f"bf16 fit at batch {batch}: no {path}")
            t0 = time.perf_counter()
            trainer.save_checkpoint(run_dir / "timed.ckpt")
            r = dict(fit_s=fit_s, fit_steps=trainer.global_step, launches=counts,
                     callback_metrics=cm, save_checkpoint_s=time.perf_counter() - t0,
                     checkpoint_mb=(run_dir / "timed.ckpt").stat().st_size / 1e6)
            if batch == BATCH:
                saved = {k: v.clone() for k, v in task16.net.state_dict().items()}
                ckpt = load_checkpoint(run_dir / "checkpoints" / "last.ckpt")
                fresh = VQVAETask(**MODEL, checkpoint_dir=str(run_dir),
                                  codebook_file=str(run_dir / "codebook.csv"),
                                  device=task16.device, seed=1, compute_dtype="bfloat16")
                resumed = trainer_for(1)
                resumed.fit(fresh, dm, ckpt_path="last")
                at = (resumed.global_step, resumed.current_epoch)
                if at != (trainer.global_step, trainer.current_epoch) or \
                        at != (ckpt["global_step"], ckpt["epoch"]):
                    fail(f"bf16 resume: at step, epoch {at}, saved "
                         f"{(ckpt['global_step'], ckpt['epoch'])}")
                differ = [k for k, v in fresh.net.state_dict().items()
                          if not torch.equal(v, saved[k]) or not torch.equal(
                              v.cpu(), ckpt["state_dict"][k])]
                if differ:
                    fail(f"bf16 resume: parameters that are not the saved bits: {differ}")
                more = trainer_for(2)
                more.fit(fresh, dm, ckpt_path="last")
                if more.global_step != 2 * trainer.global_step or more.current_epoch != 2:
                    fail(f"bf16 resume: one more epoch ended at step {more.global_step}")
                r["resume"] = dict(at_step_epoch=list(at), bit_exact=True,
                                   one_more_epoch_to_step=more.global_step)
                del fresh
                r["code_flips"] = code_flips(task16, dm, train[0])
            r.update(measure_steps(trainer, task16, dm, kernels))
            result[f"batch{batch}"] = r
            print(f"[bf16 train] batch {batch}: {r}", flush=True)
    fp32_ms = fp32_training["step_device_ms"]
    result["fp32_batch64"] = {k: fp32_training[k] for k in (
        "step_device_ms", "breakdown_ms", "step_host_ms", "samples_per_s", "peak_mem_gb")}
    bf16_ms = {b: round(result[f"batch{b}"]["step_device_ms"], 2) for b in BF16_BATCHES}
    print(f"[bf16 train] step on the device, ms by batch: bf16 {bf16_ms}; fp32 at batch "
          f"{BATCH} {fp32_ms:.2f} (phase 8)", flush=True)
    return result


class Phases:
    """Prints each phase's seconds as it ends, and keeps them."""

    def __init__(self):
        self.seconds: dict[str, float] = {}

    def __call__(self, name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.seconds[name] = time.perf_counter() - t0
        print(f"[phase] {name}: {self.seconds[name]:.1f} s", flush=True)
        return out


CLI_ROOT = OUT_DIR / "cli"            # phase 22's fixture and project; phase 23 goes on there
CLI_SR = 44100                        # Slakh's own rate: the cleaning pass resamples to SR
CLI_TRACK_S = 86                      # 66 s after the 10 s trims: 65 frames of 2 s a track
CLI_TRACKS = {"train": 2, "validation": 1, "test": 1}  # 130 / 65 / 65 frames: 2 / 1 / 1 batches
CLI_SVGS = tuple(f"{n}_{kind}.svg" for n in ("bass", "drums", "guitar", "piano", "song")
                 for kind in ("spectrogram", "waveform")) + tuple(
    f"{n}_embeddings_quantized_representation.svg"
    for n in ("bass", "drums", "guitar", "piano")) + ("codebook.svg",)
CLI_STAGE_KERNELS = {
    "fit": ("conv_stem_save_hidden", "deconv_stem_save_hidden", "vq_fused_fwd",
            "vq_codebook_grad"),
    "test": ("conv_stem", "deconv_stem", "vq_fused_fwd"),
    "visualize": ("conv_stem", "nearest_codes"),
    "generate": ("conv_stem", "nearest_codes", "mlm_argmax", "flash_attn"),
}


def busy_ms(events) -> float:
    """The union of the device intervals of a trace's CUDA events, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def staged(name: str, fn, kernels, stages: dict, before=None):
    """``fn`` wrapped to record, in ``stages[name]``, its host seconds (ending
    in a synchronize) and the fp32 launches it made; ``fit`` also its steps,
    samples/s and device busy share (a CUDA-only torch.profiler trace), and
    ``before(*args)`` runs first when given."""
    import functools

    from torch.profiler import ProfilerActivity, profile

    fp32 = {k.__name__: torch.float32 for k in kernels}

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        if before is not None:
            before(*args)
        torch.cuda.synchronize()
        start = launch_counts(kernels, fp32)
        t0 = time.perf_counter()
        if name == "fit":
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = fn(*args, **kw)
                torch.cuda.synchronize()
        else:
            out = fn(*args, **kw)
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        end = launch_counts(kernels, fp32)
        stages[name] = dict(s=seconds, launches={k: end[k] - start[k] for k in end
                                                 if end[k] > start[k]})
        if name == "fit":
            trainer = args[0]
            cuda = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
            stages[name].update(steps=trainer.global_step,
                                samples_per_s=trainer.global_step * BATCH * FRAME / seconds,
                                device_busy_ms=busy_ms(cuda),
                                device_busy_share=busy_ms(cuda) / 1e3 / seconds)
        return out
    return wrapper


def phase_cli(bert_task, kernels, smi: str, fp32_training: dict) -> dict:
    """The port's command line in process, from a fixture of WAV files, in
    CLI_ROOT, which phase 23 goes on in."""
    import os
    import shutil

    from msla_tpu_torch import main as cli
    from msla_tpu_torch.data.dataset import SlakhDataset, make_fixture_dataset
    from msla_tpu_torch.data.loader import DataLoader
    from msla_tpu_torch.train.checkpoint import save_checkpoint
    from msla_tpu_torch.train.trainer import Trainer

    root = CLI_ROOT
    shutil.rmtree(root, ignore_errors=True)
    slakh, project = root / "slakh", root / "project"
    t0 = time.perf_counter()
    for i, (split, n) in enumerate(CLI_TRACKS.items()):
        make_fixture_dataset(slakh / split, n_tracks=n, seconds=CLI_TRACK_S, sr=CLI_SR, seed=i)
    write_s = time.perf_counter() - t0

    # the cleaning pass: the first build of each split (the CLI reuses its caches)
    t0 = time.perf_counter()
    data = {split: SlakhDataset(str(slakh / split), target_sample_duration=FRAME // SR,
                                target_sample_rate=SR, max_duration=120,
                                maximum_dataset_size=150000) for split in CLI_TRACKS}
    clean_s = time.perf_counter() - t0
    frames = {split: len(ds) for split, ds in data.items()}
    if frames["train"] < 2 * BATCH or frames["validation"] < BATCH or frames["test"] < BATCH:
        fail(f"cli: the fixture gives {frames} frames")
    if data["train"][0].shape != (4, FRAME) or data["train"][0].dtype != np.float32:
        fail(f"cli: a frame of {data['train'][0].shape} {data['train'][0].dtype}")
    loader_ms = {}
    for workers in (1, 0):
        loader = DataLoader(data["train"], batch_size=BATCH, shuffle=True, drop_last=True,
                            num_workers=workers, seed=0)
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            n = sum(1 for _ in loader)
            runs.append((time.perf_counter() - t0) / n * 1e3)
        loader_ms[f"num_workers={workers}"] = statistics.median(runs)

    best = project / "logs" / "best_checkpoint"
    save_checkpoint(best / "best_bert.ckpt", state_dict=bert_task.net.state_dict())

    stages: dict[str, dict] = {}
    saved = {"fit": Trainer.fit, "test": Trainer.test, "generate": cli.generate,
             "visualize": cli.visualize}
    env = {k: os.environ.get(k) for k in ("SLAKH_DIR", "PROJECT_ROOT")}
    os.environ.update(SLAKH_DIR=str(slakh), PROJECT_ROOT=str(project))
    Trainer.fit, Trainer.test = (staged("fit", saved["fit"], kernels, stages),
                                 staged("test", saved["test"], kernels, stages))
    cli.generate, cli.visualize = (staged("generate", saved["generate"], kernels, stages),
                                   staged("visualize", saved["visualize"], kernels, stages))
    reset_counts(kernels)
    try:
        t0 = time.perf_counter()
        test_loss = cli.main(["train_vqvae=True", "trainer.max_epochs=1", "logger=csv",
                              "extras.print_config=False", "+optimized_metric=test/loss"])
        cli_s = time.perf_counter() - t0
    finally:
        Trainer.fit, Trainer.test = saved["fit"], saved["test"]
        cli.generate, cli.visualize = saved["generate"], saved["visualize"]
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    counts = launch_counts(kernels)

    missing = [s for s in CLI_STAGE_KERNELS if s not in stages]
    if missing:
        fail(f"cli: stages that did not run: {missing}")
    for stage, names in CLI_STAGE_KERNELS.items():
        absent = [n for n in names if not stages[stage]["launches"].get(n)]
        if absent:
            fail(f"cli {stage}: fp32 kernels that never launched: {absent} "
                 f"({stages[stage]['launches']})")
    if test_loss is None or not np.isfinite(test_loss):
        fail(f"cli: test/loss {test_loss}")
    run_dirs = sorted((project / "logs" / "train" / "runs").glob("*"))
    if len(run_dirs) != 1:
        fail(f"cli: run directories {run_dirs}")
    ckpt = run_dirs[0] / "checkpoint"
    wavs = [f"{kind}_{n}.wav" for kind in ("original", "generated")
            for n in ("bass", "drums", "guitar", "piano", "full_song")]
    wavs += ["random_instrument.wav", "bert_generated_during_evaluation.wav"]
    want = ([best / n for n in ("best_vqvae.ckpt", "last.ckpt", "codebook.csv")]
            + [ckpt / n for n in wavs] + [project / "logs" / "plot_dir" / n for n in CLI_SVGS]
            + [run_dirs[0] / "csv" / "metrics.csv", run_dirs[0] / "train.log"])
    absent = [str(p.relative_to(project)) for p in want if not p.is_file()]
    if absent:
        fail(f"cli: files not written: {absent}")
    codebook = np.loadtxt(best / "codebook.csv", delimiter=",", skiprows=1)
    if codebook.shape != (MODEL["num_embedding"], MODEL["embedding_dim"]):
        fail(f"cli: codebook CSV of shape {codebook.shape}")
    from msla_tpu_torch.data.wavio import read_wav

    generated, rate = read_wav(ckpt / "bert_generated_during_evaluation.wav")
    if rate != SR or generated.shape != (1, FRAME) or not np.isfinite(generated).all():
        fail(f"cli: generated WAV {generated.shape} at {rate} Hz")

    result = dict(frames=frames, fixture_write_s=write_s, clean_s=clean_s,
                  loader_ms_per_batch64=loader_ms, cli_s=cli_s, test_loss=test_loss,
                  launches=counts, stages=stages,
                  phase8_samples_per_s=fp32_training["samples_per_s"],
                  phase8_device_busy_share=fp32_training["device_busy_share"])
    fit = stages["fit"]
    print(f"[cli] {smi}: cleaning pass (first build of the three splits, {sum(frames.values())} "
          f"frames from {sum(CLI_TRACKS.values())} tracks at {CLI_SR} Hz) {clean_s:.3f} s",
          flush=True)
    print(f"[cli] {smi}: loader batch-64 assembly {loader_ms} ms a batch", flush=True)
    print(f"[cli] {smi}: fit {fit['steps']} steps in {fit['s']:.3f} s, "
          f"{fit['samples_per_s']:.4g} samples/s, device busy {fit['device_busy_share']:.4f} "
          f"(phase 8, in-memory loader: {fp32_training['samples_per_s']:.4g} samples/s, busy "
          f"{fp32_training['device_busy_share']:.4f})", flush=True)
    print(f"[cli] {smi}: test {stages['test']['s']:.3f} s, visualize "
          f"{stages['visualize']['s']:.3f} s, generate {stages['generate']['s']:.3f} s; "
          f"main() {cli_s:.3f} s; test/loss {test_loss:.5f}", flush=True)
    print(f"[cli] {json.dumps(result)}", flush=True)
    return result


#: Audio-BERT training through the CLI (main.py: max_epochs=3): phase 22's
#: fixture gives 2 train batches and 1 validation batch of 64 frames an epoch
BERT_EPOCHS, BERT_TRAIN_BATCHES, BERT_VAL_BATCHES = 3, 2, 1
BERT_PATH_KERNELS = ("conv_stem", "nearest_codes", "mlm_argmax", "flash_attn")
BERT_TIMED_STEPS = 3


def bert_launches(batches: int, demos: int = 0) -> dict:
    """fp32 launches of ``batches`` batch-64 Audio-BERT steps (train or
    evaluation) and ``demos`` one-frame forwards: the teacher's K1 and K3
    once a batch; 11,000 codes are 22 windows of 512, folded 8 a call at
    batch 64 (512 sequences), so 3 BERT calls with #6 once and #7 12 times
    each; one frame folds all 22 windows into one call."""
    return {"conv_stem": batches + demos, "nearest_codes": batches + demos,
            "mlm_argmax": 3 * batches + demos, "flash_attn": 36 * batches + 12 * demos}


def timed_bert_step(trainer, task, dm, raw: torch.Tensor) -> list[float]:
    """One Audio-BERT train step as Trainer._train_step runs it, with CUDA
    events between its parts: the masking augment and the teacher (K1, K3),
    the mask, BERT and the
    argmax (#7, #6) and the rescale, the head's forward and backward (and the
    loss), AdamW."""
    from msla_tpu_torch.ops.conv_adjoints import fp32_convs
    from msla_tpu_torch.ops.metrics import l1_loss

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ev[0].record()
    ids, stems = dm.on_after_batch_transfer(dm.train_transform(raw, trainer._generator))
    ev[1].record()
    trainer._optimizer.zero_grad(set_to_none=True)
    code_ids = task.bert_code_ids(ids.reshape(ids.shape[0], -1).long(), trainer._generator)
    ev[2].record()
    out = task.head_stems(code_ids, ids.shape[0])
    loss = sum(l1_loss(out[:, i], stems[:, i]) for i in range(4))
    with fp32_convs():
        loss.backward()
    ev[3].record()
    trainer._optimizer.step()
    ev[4].record()
    ev[4].synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]


def teacher_kernels(net, raw: torch.Tensor) -> tuple[list[dict], torch.Tensor]:
    """K1 and K3 re-timed on a second stage's inputs: K1 on the batch's stems
    with the frozen teacher's weights, K3 on the teacher's latents and
    codebook; each against its plain version, timed beside one library
    call. Also returns the teacher's (B, W) code ids."""
    import torch.nn.functional as F

    from msla_tpu_torch.ops import conv_stem, conv_stem_ref, nearest_codes, nearest_codes_ref
    from msla_tpu_torch.ops.conv_adjoints import fp32_convs

    enc = net.encoder
    report = []
    with torch.inference_mode():
        args = (raw, enc.conv1.weight, enc.conv1.bias, enc.conv2.weight, enc.conv2.bias)
        out = conv_stem(*args)
        err = check_close("conv_stem (teacher)", out, conv_stem_ref(*args)[0])
        with fp32_convs():
            lib = time_ms(lambda: F.relu(F.conv1d(F.relu(F.conv1d(raw, args[1], args[2], 2, 1)),
                                                  args[3], args[4], 2, 1)))
        w = FRAME // 4
        flops = 2 * BATCH * (FRAME // 2 * 64 * 4 * 4 + w * 128 * 64 * 4)
        report.append(dict(
            name="conv_stem", ms=time_ms(lambda: conv_stem(*args)),
            plain_ms=time_ms(lambda: conv_stem_ref(*args)), library_ms=lib, max_abs_err=err,
            route="cuda", source="msla_tpu_torch/csrc/conv_stem.cu",
            replaces="msla_tpu/ops/conv_stem.py:48", flop=flops, bytes=nbytes(*args, out),
            **tf32_bounds(flops, nbytes(*args, out))))
        del out

        flat = net.encode(raw).reshape(-1, MODEL["embedding_dim"])
        cb = net.vector_quantizer.codebook.weight
        idx = nearest_codes(flat, cb)
        mismatches, gap, _ = near_ties(flat, cb, idx, nearest_codes_ref(flat, cb))
        e2 = (cb * cb).sum(1)
        flops = 2 * flat.shape[0] * cb.shape[0] * cb.shape[1]
        report.append(dict(
            name="nearest_codes", ms=time_ms(lambda: nearest_codes(flat, cb)),
            plain_ms=time_ms(lambda: nearest_codes_ref(flat, cb)),
            library_ms=time_ms(lambda: torch.argmin(e2 - 2.0 * flat @ cb.T, dim=1)),
            max_abs_err=gap, index_mismatches=mismatches, route="cuda",
            source="msla_tpu_torch/csrc/nearest_codes.cu",
            replaces="msla_tpu/ops/vq_pallas.py:40", flop=flops, bytes=nbytes(flat, cb, idx),
            **tf32_bounds(flops, nbytes(flat, cb, idx))))
        ids = idx.reshape(raw.shape[0], -1).long()
    return report, ids


def bert_path_kernels(task, dm, raw: torch.Tensor, launches: dict, per_step: dict) -> list[dict]:
    """K1, K3, #6 and #7 re-timed in this path's call, on its inputs: K1 and
    K3 as ``teacher_kernels`` times them, #6 on BERT's MLM hidden states of
    the first folded call (512 sequences of 512) with the tied decoder, #7 at
    one layer's shapes of that call (q, k, v drawn, the last call's key mask:
    windows 21-23 padding); each against its plain version, timed beside one
    library call."""
    import torch.nn.functional as F

    from msla_tpu_torch.ops import attention_ref, flash_attn, mlm_argmax, mlm_argmax_ref

    g = torch.Generator(device=raw.device).manual_seed(23)
    report, ids = teacher_kernels(dm.quantize.net, raw)
    with torch.inference_mode():
        tokens, attn, _ = task._fold(ids)
        emb, bias = task._decoder_weights()
        h = task.bert(tokens[0], attn[0], return_mlm_hidden=True).reshape(-1, emb.shape[1])
        vocab = mlm_argmax(h, emb, bias)
        mismatches, gap = mlm_near_ties(h, emb, bias, vocab, mlm_argmax_ref(h, emb, bias))

        def library():  # addmm + argmax over row chunks
            for chunk in h.split(4096):
                torch.addmm(bias, chunk, emb.T).argmax(dim=-1)

        flops = 2 * h.shape[0] * emb.shape[0] * emb.shape[1]
        report.append(dict(
            name="mlm_argmax", ms=time_ms(lambda: mlm_argmax(h, emb, bias)),
            plain_ms=time_ms(lambda: mlm_argmax_ref(h, emb, bias)),
            library_ms=time_ms(library), max_abs_err=gap, index_mismatches=mismatches,
            rows_compared=h.shape[0], route="cuda", source="msla_tpu_torch/csrc/mlm_argmax.cu",
            replaces="msla_tpu/ops/mlm_argmax.py:47", flop=flops, flop_type="tf32",
            bytes=nbytes(h, emb, bias, vocab)))
        del h, vocab

        mask = attn[-1].contiguous()
        shape = (mask.shape[0], 512, 12, 64)
        q, k, v = (torch.randn(shape, generator=g, device=raw.device) for _ in range(3))
        out = flash_attn(q, k, v, mask, 0.125)
        bhsd = [t.transpose(1, 2) for t in (q, k, v)]
        err = check_close("flash_attn (Audio-BERT training)", out,
                          attention_ref(*bhsd, mask, 0.125).transpose(1, 2))
        additive = ((1.0 - mask) * -1e9)[:, None, None, :]
        flops = 4 * shape[0] * 12 * 512 * 512 * 64
        report.append(dict(
            name="flash_attn", ms=time_ms(lambda: flash_attn(q, k, v, mask, 0.125)),
            plain_ms=time_ms(lambda: attention_ref(*bhsd, mask, 0.125)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                *bhsd, attn_mask=additive, scale=0.125)),
            max_abs_err=err, route="cuda", source="msla_tpu_torch/csrc/flash_attn.cu",
            replaces="msla_tpu/ops/flash_attn.py:51", flop=flops, flop_type="tf32",
            bytes=nbytes(q, k, v, out, mask)))
        del q, k, v, out, bhsd, additive
    torch.cuda.empty_cache()
    for k in report:
        k.update(launches=launches.get(k["name"], 0),
                 launches_per_step=per_step.get(k["name"], 0), path="audio_bert_training")
    report = with_bounds(report)
    for k in report:
        k["name"] += "@audio_bert_training"
    return report


def bert_card_vs_cpu(task, dm, raw: torch.Tensor) -> dict:
    """One step's code ids, card against the CPU's plain path on frame 0: the
    teacher's ids, and BERT's vocab ids on the masked ids the card drew; then
    the head's gradient on the card and on the CPU, both fed the card's
    code ids of the whole batch."""
    from msla_tpu_torch.data.transform import Quantize
    from msla_tpu_torch.models.bert import AudioBertTask, mask_tokens
    from msla_tpu_torch.models.vqvae import VQVAETask
    from msla_tpu_torch.ops import mlm_argmax
    from msla_tpu_torch.ops.conv_adjoints import fp32_convs
    from msla_tpu_torch.ops.metrics import l1_loss

    teacher = dm.quantize.net
    cpu_vq = VQVAETask(**MODEL, checkpoint_dir=".", codebook_file="codebook.csv", device="cpu")
    cpu_vq.net.load_state_dict({k: v.cpu() for k, v in teacher.state_dict().items()})
    cpu_bert = AudioBertTask(**{k: task.hparams[k] for k in (
        "learning_rate", "checkpoint_dir", "codebook", "sample_rate", "frame_length",
        "num_embedding")}, device="cpu", seed=0)
    cpu_bert.net.load_state_dict({k: v.cpu() for k, v in task.net.state_dict().items()})
    frame = raw[:1].cpu()
    with torch.inference_mode():
        ids = dm.on_after_batch_transfer(raw)[0].long()
        ids_cpu = Quantize(cpu_vq).get_encodings_idx(frame).long()[0]
        latents = cpu_vq.net.encode(frame).reshape(-1, MODEL["embedding_dim"])
        teacher_mismatches, _, teacher_gap = near_ties(
            latents, cpu_vq.net.vector_quantizer.codebook.weight, ids[0].cpu(), ids_cpu)
        g = torch.Generator(device=raw.device).manual_seed(5)
        masked = mask_tokens(ids, torch.rand(ids.shape, generator=g, device=raw.device),
                             task.mask_prob)
        vocab = task._chunked_argmax(masked, with_conf=False)
        code_ids = task._code_ids(vocab)
        tok, am, _ = cpu_bert._fold(masked[:1].cpu())
        emb, bias = cpu_bert._decoder_weights()
        h = torch.cat([cpu_bert.bert(t, a, return_mlm_hidden=True) for t, a in zip(tok, am)])
        h = h.reshape(-1, emb.shape[1])[:ids.shape[1]]
        vocab_cpu = mlm_argmax(h, emb, bias)
        vocab_mismatches, vocab_gap = mlm_near_ties(h, emb, bias, vocab[0].cpu(), vocab_cpu)
    agreement = dict(teacher=(ids[0].cpu() == ids_cpu).double().mean().item(),
                     bert=(vocab[0].cpu() == vocab_cpu).double().mean().item())
    for what, share in agreement.items():
        if share < 0.999:
            fail(f"Audio-BERT card vs CPU: only {share:.5f} of the {what}'s ids agree")

    stems = raw.float()
    grads = {}
    for name, t, c, x in (("card", task, code_ids, stems),
                          ("cpu", cpu_bert, code_ids.cpu(), stems.cpu())):
        t.net.head.zero_grad(set_to_none=True)
        out = t.head_stems(c.clone(), BATCH)
        loss = sum(l1_loss(out[:, i], x[:, i]) for i in range(4))
        with fp32_convs():
            loss.backward()
        grads[name] = {k: p.grad.detach().cpu() for k, p in t.net.head.named_parameters()}
        t.net.head.zero_grad(set_to_none=True)
    grad_err = {k: check_close(f"head gradient {k} card vs CPU", grads["card"][k],
                               grads["cpu"][k], atol=1e-4, rtol=1e-3) for k in grads["card"]}
    result = dict(agreement=agreement, teacher_mismatches=teacher_mismatches,
                  teacher_max_tie_gap=teacher_gap, vocab_mismatches=vocab_mismatches,
                  vocab_max_tie_gap=vocab_gap, head_grad_max_abs_err=grad_err)
    print(f"[bert train cpu-vs-card] {json.dumps(result)}", flush=True)
    return result


def bert_resume(trainer, task, dm, raw: torch.Tensor, last: Path) -> dict:
    """One more step of the trained Trainer, and the same step of a new
    Trainer restored from last.ckpt (weights, sidecar, AdamW, generator):
    the same head and AdamW state bit for bit (cuDNN deterministic for both)."""
    from msla_tpu_torch.train.trainer import Trainer

    head = {k: v.clone() for k, v in task.net.head.state_dict().items()}
    flags = dict(enabled=True, benchmark=False, deterministic=True, allow_tf32=False)
    with torch.backends.cudnn.flags(**flags):
        trainer._train_step(task, dm, [raw])
    want = {k: v.clone() for k, v in task.net.head.state_dict().items()}
    want_opt = [{k: v.clone() for k, v in s.items()}
                for s in trainer._optimizer.state_dict()["state"].values()]
    again = Trainer(seed=0, enable_progress_bar=False)
    again._setup(task, dm)
    again._restore(last)
    if any(not torch.equal(v, head[k]) for k, v in task.net.head.state_dict().items()):
        fail("Audio-BERT resume: the restored head is not the saved one")
    with torch.backends.cudnn.flags(**flags):
        again._train_step(task, dm, [raw])
    got_opt = list(again._optimizer.state_dict()["state"].values())
    differ = [k for k, v in task.net.head.state_dict().items() if not torch.equal(v, want[k])]
    differ += [f"adamw {i} {k}" for i, (a, b) in enumerate(zip(want_opt, got_opt))
               for k in a if not torch.equal(a[k], b[k])]
    if differ:
        fail(f"Audio-BERT resume: one further step differs in {differ}")
    return dict(bit_exact=True, restored_step=again.global_step,
                restored_epoch=again.current_epoch)


def phase_bert_training(kernels, smi: str) -> dict:
    """``python -m msla_tpu_torch train_bert=True`` in process in phase 22's
    project: bert-base at full width, batch 64, fp32, over phase 22's
    best_vqvae.ckpt and codebook CSV, with its ModelCheckpoint, EarlyStopping
    and a CSV logger; then generate from the port-trained best_bert.ckpt.
    Checks: fit, test and generate's exact launches (``bert_launches``); BERT
    and the codebook bit-unchanged by fit and the head moved; one
    frozen-*.ckpt, versioned files of the head plus AdamW's size; a resume
    from last.ckpt bit-exact for one further step; card against CPU
    (``bert_card_vs_cpu``); Trainer.predict from best_bert.ckpt. Prints the
    step's device time in parts, samples/s through fit, one save_checkpoint's
    and the sidecar's seconds and bytes, peak memory and the path's kernels
    re-timed (``bert_path_kernels``)."""
    import os
    import shutil

    from msla_tpu_torch import main as cli
    from msla_tpu_torch.train.checkpoint import (FROZEN_SIDECAR, frozen_fingerprint, is_frozen,
                                                 save_frozen_sidecar)
    from msla_tpu_torch.train.trainer import Trainer

    project, best = CLI_ROOT / "project", CLI_ROOT / "project" / "logs" / "best_checkpoint"
    (best / "best_bert.ckpt").unlink()  # phase 22's random-weight file
    free_gb = shutil.disk_usage(best).free / 1e9
    print(f"[bert train] {free_gb:.1f} GB free on the checkpoint disk", flush=True)

    stages: dict[str, dict] = {}
    seen: dict = {}

    def before_fit(trainer, task, dm, *_):
        seen.update(trainer=trainer, task=task, dm=dm,
                    start={k: v.clone() for k, v in task.net.state_dict().items()})

    saved = {"fit": Trainer.fit, "test": Trainer.test, "generate": cli.generate}
    env = {k: os.environ.get(k) for k in ("SLAKH_DIR", "PROJECT_ROOT")}
    os.environ.update(SLAKH_DIR=str(CLI_ROOT / "slakh"), PROJECT_ROOT=str(project))
    Trainer.fit = staged("fit", saved["fit"], kernels, stages, before=before_fit)
    Trainer.test = staged("test", saved["test"], kernels, stages)
    cli.generate = staged("generate", saved["generate"], kernels, stages)
    reset_counts(kernels)
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        test_loss = cli.main(["train_bert=True", "logger=csv", "extras.print_config=False",
                              "+optimized_metric=test/loss", "+visualize=False"])
        cli_s = time.perf_counter() - t0
    finally:
        Trainer.fit, Trainer.test, cli.generate = saved["fit"], saved["test"], saved["generate"]
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    steps = BERT_EPOCHS * BERT_TRAIN_BATCHES
    want = {"fit": bert_launches(steps + BERT_EPOCHS * BERT_VAL_BATCHES, demos=BERT_EPOCHS),
            "test": bert_launches(1), "generate": bert_launches(0, demos=1)}
    for stage, counts in want.items():
        if stage not in stages:
            fail(f"bert train: stage {stage} did not run")
        got = {k: stages[stage]["launches"].get(k, 0) for k in BERT_PATH_KERNELS}
        if got != counts or set(stages[stage]["launches"]) - set(BERT_PATH_KERNELS):
            fail(f"bert train {stage}: launches {stages[stage]['launches']}, want {counts}")
    trainer, task, dm = seen["trainer"], seen["task"], seen["dm"]
    if trainer.global_step != steps or test_loss is None or not np.isfinite(test_loss):
        fail(f"bert train: {trainer.global_step} steps, test/loss {test_loss}")
    end = task.net.state_dict()
    moved = [k for k in end if not torch.equal(end[k], seen["start"][k])]
    if sorted(moved) != sorted(k for k in end if k.startswith("head.")):
        fail(f"bert train: fit changed {moved}: only the head's four tensors may move")

    sidecars = sorted(best.glob("frozen-*.ckpt"))
    head_bytes = sum(p.numel() * p.element_size() for p in task.net.head.parameters())
    files = {p.name: p.stat().st_size for p in sorted(best.glob("best_bert*.ckpt"))}
    files["last.ckpt"] = (best / "last.ckpt").stat().st_size
    if len(sidecars) != 1 or (best / FROZEN_SIDECAR).exists():
        fail(f"bert train: sidecars {sidecars}")
    off = {n: b / (3 * head_bytes) for n, b in files.items() if abs(b / (3 * head_bytes) - 1) > 0.01}
    if off:
        fail(f"bert train: checkpoints not the head plus AdamW ({3 * head_bytes} B): {off}")

    raw = torch.from_numpy(next(iter(dm.train_dataloader()))).to(task.device)
    resume = bert_resume(trainer, task, dm, raw, best / "last.ckpt")

    timed_bert_step(trainer, task, dm, raw)  # warm-up
    reset_counts(kernels)
    parts = [timed_bert_step(trainer, task, dm, raw) for _ in range(BERT_TIMED_STEPS)]
    per_step = {k: n // BERT_TIMED_STEPS for k, n in launch_counts(kernels).items()}
    if {k: per_step.get(k, 0) for k in BERT_PATH_KERNELS} != bert_launches(1):
        fail(f"bert train: launches a step {per_step}, want {bert_launches(1)}")
    names = ("augment_and_teacher", "bert_and_argmax", "head_forward_backward", "adamw")
    breakdown = {n: statistics.median(p[i] for p in parts) for i, n in enumerate(names)}
    step_ms = statistics.median(sum(p) for p in parts)

    # one save_checkpoint into a new directory (the sidecar written), then into
    # the same one (only the fingerprint), and the sidecar's parts alone
    timing = CLI_ROOT / "timing"
    frozen = {k: v for k, v in task.net.state_dict().items()
              if is_frozen(k, task.frozen_param_keys)}
    saves = {}
    for name in ("first.ckpt", "second.ckpt"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.save_checkpoint(timing / name)
        saves[name] = dict(s=time.perf_counter() - t0, bytes=(timing / name).stat().st_size)
        (timing / name).unlink()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frozen_fingerprint(frozen)
    fingerprint_s = time.perf_counter() - t0
    shutil.rmtree(timing)
    t0 = time.perf_counter()
    sidecar = save_frozen_sidecar(timing, frozen)
    sidecar_s = time.perf_counter() - t0
    sidecar_bytes = (timing / sidecar).stat().st_size
    shutil.rmtree(timing)

    kernel_report = bert_path_kernels(task, dm, raw, stages["fit"]["launches"], per_step)
    cpu = bert_card_vs_cpu(task, dm, raw)

    reset_counts(kernels)
    t0 = time.perf_counter()
    outputs = Trainer(seed=0, enable_progress_bar=False).predict(
        task, dm, ckpt_path=str(best / "best_bert.ckpt"))
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    frames = len(dm.predict_dataloader())
    predict_launches = {k: n for k, n in launch_counts(kernels).items() if n}
    if len(outputs) != frames or any(o.shape != (1, 4, FRAME) or not torch.isfinite(o).all()
                                     for o in outputs):
        fail(f"bert predict: {len(outputs)} outputs for {frames} frames")
    if predict_launches != bert_launches(0, demos=frames):
        fail(f"bert predict: launches {predict_launches}, want {bert_launches(0, demos=frames)}")

    fit = stages["fit"]
    result = dict(
        free_disk_gb=free_gb, cli_s=cli_s, test_loss=test_loss, stages=stages, peak_mem_gb=peak_gb,
        steps=steps, step_device_ms=step_ms, breakdown_ms=breakdown,
        step_samples_per_s=BATCH * FRAME / (step_ms / 1e3), launches_per_step=per_step,
        checkpoint_files=files, sidecar=sidecars[0].name, save_checkpoint=saves,
        fingerprint_s=fingerprint_s, sidecar_s=sidecar_s, sidecar_bytes=sidecar_bytes,
        head_bytes=head_bytes, resume=resume, card_vs_cpu=cpu, predict_s=predict_s,
        predict_frames=frames, predict_launches=predict_launches)
    print(f"[bert train] {smi}: fit {fit['steps']} steps in {fit['s']:.3f} s, "
          f"{fit['samples_per_s']:.4g} samples/s, device busy {fit['device_busy_share']:.4f}; "
          f"test {stages['test']['s']:.3f} s, generate {stages['generate']['s']:.3f} s, "
          f"main() {cli_s:.3f} s, test/loss {test_loss:.5f}", flush=True)
    print(f"[bert train] {smi}: step {step_ms:.2f} ms on the device "
          f"({BATCH * FRAME / (step_ms / 1e3):.4g} samples/s): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in breakdown.items()), flush=True)
    print(f"[bert train] {smi}: launches fit {fit['launches']}, a step {per_step}, test "
          f"{stages['test']['launches']}, generate {stages['generate']['launches']}, predict "
          f"{predict_launches} ({frames} frames, {predict_s:.3f} s)", flush=True)
    print(f"[bert train] {smi}: save_checkpoint {saves['first.ckpt']['s']:.3f} s with the "
          f"sidecar, {saves['second.ckpt']['s']:.3f} s without, "
          f"{saves['second.ckpt']['bytes']} B; sidecar {sidecar_bytes} B in {sidecar_s:.3f} s, "
          f"fingerprint {fingerprint_s * 1e3:.2f} ms; peak {peak_gb:.2f} GB", flush=True)
    print(f"[bert train] {json.dumps(result)}", flush=True)
    for name in ("best_bert*.ckpt", "last.ckpt", "frozen-*.ckpt"):  # phase 24 goes on here
        for path in best.glob(name):
            path.unlink()
    return result, kernel_report


#: the transformer through the CLI (configs/model/transformer.yaml at full width):
#: max_epochs cut from the trainer config's 10 to 3, and to 2 for the MoE run
TRANSFORMER_EPOCHS = {"transformer": 3, "transformer_inline_writes": 3, "moe_transformer": 2}
TRANSFORMER = dict(sample_rate=SR, frame_length=FRAME // SR, learning_rate=1e-4, num_layers=4,
                   num_heads=8, hidden_dim=512, latent_channels=MODEL["embedding_dim"])
TRANSFORMER_STEPS = {"fp32": {}, "bf16": dict(compute_dtype="bfloat16"),
                     "moe_transformer": dict(moe_experts=8, moe_selected=2)}
TRANSFORMER_KERNELS = ("conv_stem", "nearest_codes")
TRANSFORMER_TIMED_STEPS = 5
#: phase 23's fit with its writes in the loop, as PERF.md §5 records it
INLINE_WRITES_FIT = dict(s=54.789, device_busy_share=0.7228)


def transformer_launches(batches: int) -> dict:
    """fp32 launches of ``batches`` batch-64 transformer steps, evaluation
    batches or demos: the teacher's K1 and K3 once each; the transformer
    itself runs no kernel of the port (its attention takes a causal mask)."""
    return {"conv_stem": batches, "nearest_codes": batches}


def transformer_work(task, batch: int = BATCH) -> dict:
    """One train step's FLOP and least bytes: the embedding W → hidden, the
    layers (q, k, v, out projections, Q·Kᵀ and P·V, the FFN, or the MoE's
    experts on their E·C slots and its dispatch and combine), and ``fc``;
    the backward twice the forward but the embedding's (the latents take
    no gradient); the forward and backward read the weights (and the
    backward writes their gradients), Adam reads p, g, m, v and writes p,
    m, v."""
    hp, net = task.hparams, task.net
    h, s, w, t = hp["hidden_dim"], TRANSFORMER["latent_channels"], FRAME // 4, FRAME
    tokens = batch * s
    attn = 8 * tokens * h * h + 4 * batch * s * s * h
    if hp["moe_experts"]:
        e = hp["moe_experts"]
        c = net.layer0.moe.capacity(s)
        ffn = 4 * batch * e * c * h * 2048 + 4 * batch * s * e * c * h + 2 * tokens * h * e
    else:
        ffn = 4 * tokens * h * 2048
    embed, fc = 2 * tokens * w * h, 2 * batch * 4 * (s * h // 4) * t
    body = hp["num_layers"] * (attn + ffn) + fc
    params = sum(p.numel() for p in net.parameters())
    return dict(forward=embed + body, backward=embed + 2 * body, params=params,
                forward_bytes=4 * params, backward_bytes=8 * params, adam_bytes=28 * params)


def transformer_step(dm, raw: torch.Tensor, kernels, smi: str, name: str, **kw):
    """One batch-64 train step of a full-width TransformerTask (seed 0) over
    the CLI's teacher, as the Trainer runs it (``timed_step``: the augment
    and teacher, forward, backward, Adam, CUDA events, median of 5 after a
    warm-up), each part beside its bound, and the step's kernels by kind
    (``device_parts``); K1 and K3 launches a step (once each) and the peak
    memory. Returns the figures and the task."""
    from msla_tpu_torch.models.transformer import TransformerTask
    from msla_tpu_torch.train.trainer import Trainer

    task = TransformerTask(**TRANSFORMER, checkpoint_dir=str(CLI_ROOT / "steps"), device="cuda",
                           seed=0, **kw)
    trainer = Trainer(seed=0, enable_progress_bar=False)
    trainer._setup(task, dm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed_step(trainer, task, dm, raw)  # warm-up
    reset_counts(kernels)
    parts = [timed_step(trainer, task, dm, raw) for _ in range(TRANSFORMER_TIMED_STEPS)]
    per_step = {k: n / TRANSFORMER_TIMED_STEPS for k, n in launch_counts(kernels).items() if n}
    if per_step != transformer_launches(1):
        fail(f"transformer {name}: launches a step {per_step}, want {transformer_launches(1)}")
    names = ("augment_and_teacher", "forward", "backward", "adam")
    breakdown = {n: statistics.median(p[i] for p in parts) for i, n in enumerate(names)}
    kinds = device_parts(lambda: timed_step(trainer, task, dm, raw), passes=1)
    work = transformer_work(task)
    peak = PEAK_FLOPS["bf16" if kw.get("compute_dtype") else "fp32"]
    bounds = {"forward": bound(work["forward"], work["forward_bytes"], peak),
              "backward": bound(work["backward"], work["backward_bytes"], peak),
              "adam": bound(0, work["adam_bytes"])}
    result = dict(step_ms=statistics.median(sum(p) for p in parts), breakdown_ms=breakdown,
                  bounds_ms={k: v[0] for k, v in bounds.items()},
                  bound_by={k: v[1] for k, v in bounds.items()},
                  flop=work["forward"] + work["backward"], params=work["params"],
                  launches_per_step=per_step, device_parts_ms=kinds,
                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[transformer step] {smi}: {name} batch {BATCH}: step {result['step_ms']:.2f} ms "
          f"({BATCH * FRAME / result['step_ms'] * 1e3:.4g} samples/s), {work['params']} "
          f"parameters, {result['flop']:.3e} FLOP; "
          + ", ".join(f"{n} {breakdown[n]:.3f} ms" + (
              f" (bound {bounds[n][0]:.3f}, {bounds[n][1]})" if n in bounds else "")
              for n in names)
          + f"; peak {result['peak_mem_gb']:.2f} GB", flush=True)
    print(f"[transformer step] {smi}: {name} device parts of a step (ms, one traced step): "
          f"{json.dumps(kinds)}", flush=True)
    return result, task


def transformer_card_vs_cpu(task, dm, raw: torch.Tensor) -> dict:
    """The full-width fp32 transformer's deterministic forward on one batch of
    the teacher's latents, card against the port's CPU path on the same
    weights and latents: atol = rtol = 1e-4 (fp32 sums in another order,
    ``fc``'s over K = 8,192 and the embedding's over 11,000)."""
    from msla_tpu_torch.models.transformer import TransformerTask

    cpu = TransformerTask(**TRANSFORMER, checkpoint_dir=str(CLI_ROOT / "steps"), device="cpu")
    cpu.net.load_state_dict({k: v.cpu() for k, v in task.net.state_dict().items()})
    with torch.inference_mode():
        latents = dm.on_after_batch_transfer(raw)[0]
        card = task.net(latents)
        t0 = time.perf_counter()
        want = cpu.net(latents.cpu())
        cpu_s = time.perf_counter() - t0
    err = check_close("transformer card vs CPU", card.cpu(), want, atol=1e-4, rtol=1e-4)
    result = dict(max_abs_err=err, max_abs_out=want.abs().max().item(), cpu_s=cpu_s,
                  shape=list(card.shape))
    print(f"[transformer cpu-vs-card] {json.dumps(result)}", flush=True)
    return result


def peak_step(fn) -> dict:
    """``fn()`` once after a synchronize: the device memory resident before it,
    the peak during it and the peak's excess over the resident, in GB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return dict(resident_gb=resident / 1e9, peak_gb=peak / 1e9,
                step_gb=(peak - resident) / 1e9)


def transformer_remat_and_wire(dm, raw: torch.Tensor, smi: str, ckpt_dir: Path) -> dict:
    """The full-width transformer at dropout 0.1 (the task's default), one
    batch-64 step with ``remat=True`` and one without, each from seed 0 and
    the Trainer's generator at seed 0: the gradients the two steps took must
    agree (bit for bit where the card's kernels repeat their sums; within
    1e-5 of each tensor's largest in any case), which holds only if the
    recomputed forward drew the forward's dropout masks; a step on another
    generator state must differ. Each step's ms (CUDA events, median of 5)
    and peak. Then ``save_checkpoint`` of the stepped state (weights and
    Adam, 4.54 GB), exact and ``wire="q8"``, in the loop: seconds and bytes."""
    from msla_tpu_torch.models.transformer import TransformerTask
    from msla_tpu_torch.train.trainer import Trainer

    def setup(remat: bool, seed: int = 0):
        task = TransformerTask(**TRANSFORMER, checkpoint_dir=str(CLI_ROOT / "steps"),
                               device="cuda", seed=0)
        trainer = Trainer(seed=seed, enable_progress_bar=False, remat=remat)
        trainer._setup(task, dm)
        return task, trainer

    grads, figures = {}, {}
    for name, remat in (("plain", False), ("remat", True)):
        task, trainer = setup(remat)
        figures[name] = peak_step(lambda: trainer._train_step(task, dm, [raw]))
        grads[name] = {k: p.grad.clone() for k, p in task.net.named_parameters()}
        figures[name]["step_ms"] = time_ms(lambda: trainer._train_step(task, dm, [raw]),
                                           reps=5, warmup=1)
        if name == "plain":
            del task, trainer
            torch.cuda.empty_cache()
    worst, equal, tensors = 0.0, 0, len(grads["plain"])
    for key, g in grads["plain"].items():
        other = grads["remat"][key]
        equal += int(torch.equal(g, other))
        worst = max(worst, ((other - g).abs().max() / g.abs().max().clamp_min(1e-30)).item())
    if worst > 1e-5:
        fail(f"transformer remat: gradients off the plain step's by {worst:.3e} of a "
             "tensor's largest: the recomputed forward drew other dropout masks")
    del grads["remat"]
    other_task, other_trainer = setup(False, seed=7)
    other_trainer._train_step(other_task, dm, [raw])
    if torch.equal(other_task.net.fc.weight.grad, grads["plain"]["fc.weight"]):
        fail("transformer remat: another generator state gave the same gradients")
    del other_task, other_trainer, grads
    torch.cuda.empty_cache()

    writes = {}
    for wire in ("off", "q8"):
        path = ckpt_dir / f"wire_{wire}.ckpt"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.save_checkpoint(path, wire=wire)
        writes[wire] = dict(s=time.perf_counter() - t0, bytes=path.stat().st_size)
        path.unlink()
    del task, trainer
    torch.cuda.empty_cache()
    result = dict(figures, tensors_bit_equal=equal, tensors=tensors, max_rel_diff=worst,
                  writes=writes)
    print(f"[transformer remat] {smi}: step {figures['plain']['step_ms']:.2f} ms, peak "
          f"{figures['plain']['peak_gb']:.2f} GB ({figures['plain']['step_gb']:.2f} over the "
          f"resident); remat=True {figures['remat']['step_ms']:.2f} ms, peak "
          f"{figures['remat']['peak_gb']:.2f} GB ({figures['remat']['step_gb']:.2f} over the "
          f"resident); gradients bit-equal in {equal} of "
          f"{tensors} tensors, the largest difference {worst:.3e} of its tensor's largest",
          flush=True)
    print(f"[transformer wire] {smi}: save_checkpoint exact {writes['off']['s']:.3f} s "
          f"{writes['off']['bytes']} B, q8 {writes['q8']['s']:.3f} s {writes['q8']['bytes']} B",
          flush=True)
    return result


def phase_transformer(kernels, smi: str, bert_training: dict) -> tuple[dict, list[dict]]:
    """The transformer stage on the card, in phase 22's project, over its
    best_vqvae.ckpt:
    (a) ``python -m msla_tpu_torch train_transformer=True``, again with
        ModelCheckpoint's writes in the loop (the run before background
        writes, in the same call), then with ``experiment=moe_transformer``,
        in process at full width (4 layers,
        8 heads, hidden 512, fp32, batch 64, T = 44,000, W = 11,000) with the
        default callbacks and a CSV logger, ``+generate=False
        +visualize=False``: fit's and test's seconds, fit's samples/s and
        busy share, exact K1 and K3 launches (once a train, validation and
        test batch and a demo), and each checkpoint's seconds in the loop
        (``save_checkpoint``: the snapshot) beside the writer's seconds and
        its bytes;
    (b) one batch-64 step in parts for fp32, bf16 and the MoE preset
        (``transformer_step``);
    (c) card against CPU (``transformer_card_vs_cpu``);
    (d) phase 23's fit, now with background writes, beside its figures
        with the writes in the loop (``INLINE_WRITES_FIT``);
    (e) one step with ``remat=True`` against one without, and the exact
        and q8 writes of the stepped state (``transformer_remat_and_wire``);
    then K1 and K3 re-timed on this path's inputs. Prints the free disk
    first and removes the project (not the fixture) at its end."""
    import os
    import shutil

    from msla_tpu_torch import main as cli
    from msla_tpu_torch.train.checkpoint import wait_for_pending
    from msla_tpu_torch.train.trainer import Trainer

    project, best = CLI_ROOT / "project", CLI_ROOT / "project" / "logs" / "best_checkpoint"
    free_gb = shutil.disk_usage(best).free / 1e9
    print(f"[transformer] {free_gb:.1f} GB free on the checkpoint disk", flush=True)
    saved = {"fit": Trainer.fit, "test": Trainer.test, "save": Trainer.save_checkpoint}
    runs: dict[str, dict] = {}
    seen: dict = {}
    env = {k: os.environ.get(k) for k in ("SLAKH_DIR", "PROJECT_ROOT")}
    os.environ.update(SLAKH_DIR=str(CLI_ROOT / "slakh"), PROJECT_ROOT=str(project))
    try:
        for run, extra in (("transformer", []), ("transformer_inline_writes", []),
                           ("moe_transformer", ["experiment=moe_transformer"])):
            stages: dict[str, dict] = {}
            writes: list[dict] = []

            def save(trainer, path, *a, _inline=run.endswith("inline_writes"), **kw):
                if _inline:  # the same run with ModelCheckpoint's writes in the loop
                    kw["background"] = False
                # the loop's stream only: a device-wide synchronize would also
                # wait for the writer's copy on its own stream
                stream = torch.cuda.current_stream()
                stream.synchronize()
                t0 = time.perf_counter()
                wait_for_pending(path)  # save_checkpoint's own join of a write in flight
                t1 = time.perf_counter()
                future = saved["save"](trainer, path, *a, **kw)
                stream.synchronize()  # the snapshot's clones included
                t2 = time.perf_counter()
                writes.append(dict(file=Path(path).name, loop_s=t2 - t0, join_s=t1 - t0,
                                   snapshot_s=t2 - t1, future=future))
                if future is None:  # written in the loop: the snapshot is the whole write
                    writes[-1].update(s=t2 - t1, bytes=Path(path).stat().st_size)
                return future

            Trainer.fit = staged("fit", saved["fit"], kernels, stages,
                                 before=lambda trainer, task, dm, *_: seen.update(dm=dm))
            Trainer.test = staged("test", saved["test"], kernels, stages)
            Trainer.save_checkpoint = save
            reset_counts(kernels)
            epochs = TRANSFORMER_EPOCHS[run]
            test_loss = cli.main(["train_transformer=True", "logger=csv",
                                  f"trainer.max_epochs={epochs}", "extras.print_config=False",
                                  "+optimized_metric=testing/loss", "+generate=False",
                                  "+visualize=False", *extra])
            for w in writes:  # fit has joined them all
                future = w.pop("future")
                if future is not None:
                    w.update(future.result())
                w.pop("path", None)
            want = {"fit": transformer_launches(epochs * (BERT_TRAIN_BATCHES + 2)),
                    "test": transformer_launches(1)}
            for stage, counts in want.items():
                if stages.get(stage, {}).get("launches") != counts:
                    fail(f"transformer {run} {stage}: launches "
                         f"{stages.get(stage, {}).get('launches')}, want {counts}")
            if test_loss is None or not np.isfinite(test_loss):
                fail(f"transformer {run}: testing/loss {test_loss}")
            files = {p.name: p.stat().st_size for p in sorted(best.glob("*transformer*.ckpt"))}
            if "best_transformer.ckpt" not in files or not (best / "last.ckpt").is_file():
                fail(f"transformer {run}: checkpoints {files}")
            runs[run] = dict(epochs=epochs, test_loss=test_loss, stages=stages, writes=writes,
                             files=files)
            fit = stages["fit"]
            print(f"[transformer] {smi}: {run} fit {fit['steps']} steps in {fit['s']:.3f} s, "
                  f"{fit['samples_per_s']:.4g} samples/s, device busy "
                  f"{fit['device_busy_share']:.4f}; test {stages['test']['s']:.3f} s; "
                  f"testing/loss {test_loss:.5f}; launches fit {fit['launches']}", flush=True)
            for w in writes:
                print(f"[transformer] {smi}: {run} {w['file']}: {w['loop_s']:.3f} s in the loop "
                      f"(save_checkpoint: {w['join_s']:.3f} s joining this file's write in "
                      f"flight, {w['snapshot_s']:.3f} s the snapshot), {w['s']:.3f} s on the "
                      f"writer, {w['bytes']} B", flush=True)
    finally:
        Trainer.fit, Trainer.test = saved["fit"], saved["test"]
        Trainer.save_checkpoint = saved["save"]
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    dm = seen["dm"]
    raw = torch.from_numpy(next(iter(dm.train_dataloader()))).to("cuda")
    steps = {}
    for name, kw in TRANSFORMER_STEPS.items():
        steps[name], task = transformer_step(dm, raw, kernels, smi, name, **kw)
        if name == "fp32":
            card_vs_cpu = transformer_card_vs_cpu(task, dm, raw)
        del task
        torch.cuda.empty_cache()

    for path in [*best.glob("*transformer*.ckpt"), best / "last.ckpt"]:  # room on the disk
        path.unlink(missing_ok=True)
    remat_and_wire = transformer_remat_and_wire(dm, raw, smi, best)

    fit23 = bert_training["stages"]["fit"]
    print(f"[transformer] {smi}: phase 23's fit with background writes {fit23['s']:.3f} s, "
          f"busy {fit23['device_busy_share']:.4f} (writes in the loop, PERF.md §5: "
          f"{INLINE_WRITES_FIT['s']} s, busy {INLINE_WRITES_FIT['device_busy_share']})",
          flush=True)

    report, _ = teacher_kernels(dm.quantize.net, raw)
    fit_launches = runs["transformer"]["stages"]["fit"]["launches"]
    for k in report:
        k.update(launches=fit_launches.get(k["name"], 0),
                 launches_per_step=steps["fp32"]["launches_per_step"].get(k["name"], 0),
                 path="transformer_training")
    report = with_bounds(report)
    for k in report:
        k["name"] += "@transformer_training"
    torch.cuda.empty_cache()
    result = dict(free_disk_gb=free_gb, runs=runs, steps=steps, card_vs_cpu=card_vs_cpu,
                  remat_and_wire=remat_and_wire, bert_fit_with_background_writes=dict(s=fit23["s"],
                                                       device_busy_share=fit23[
                                                           "device_busy_share"]),
                  bert_fit_writes_in_loop=INLINE_WRITES_FIT)
    print(f"[transformer] {json.dumps(result)}", flush=True)
    shutil.rmtree(project, ignore_errors=True)  # phase 25 goes on from the fixture
    return result, report


# ---- phase 25: the rest of the trainer --------------------------------------------------

#: configs/experiment/vqvae_slakh.yaml's trainer.max_epochs (10), cut to 2
EXPERIMENT_EPOCHS = 2
ACC_BATCH = BATCH // 2                 # (b): 2 microbatches of 32 against one batch of 64
ACC_KERNELS = ("conv_stem_save_hidden", "deconv_stem_save_hidden", "vq_fused_fwd",
               "vq_codebook_grad")
#: (c): the port's kernels that a traced epoch must hold, by the kernel's own name
TRACE_KERNELS = {"stems": ("conv_stem_3xtf32_kernel", "deconv_stem_3xtf32_kernel"),
                 "fused VQ": ("vq_fused_fwd_kernel",), "segment sum": ("segment_sum_kernel",)}
Q8_BLOCK, WIRE_FLOOR = 1024, 16384     # train/checkpoint.py's codec constants


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC-32C, computed bit by bit (apart from the port's
    table-driven one)."""
    crc = 0xFFFFFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 & -(crc & 1))
    crc ^= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def proto_fields(buf: bytes) -> dict:
    """A protobuf message's fields by number: varints as ints, fixed64 and
    fixed32 as their bytes, length-delimited fields as bytes."""
    out, pos = collections.defaultdict(list), 0

    def varint():
        nonlocal pos
        value = shift = 0
        while True:
            byte = buf[pos]
            pos += 1
            value |= (byte & 0x7F) << shift
            shift += 7
            if byte < 0x80:
                return value

    while pos < len(buf):
        key = varint()
        field, wire = key >> 3, key & 7
        if wire == 0:
            out[field].append(varint())
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            out[field].append(buf[pos:pos + n])
            pos += n
        elif wire == 2:
            n = varint()
            out[field].append(buf[pos:pos + n])
            pos += n
        else:
            fail(f"event file: wire type {wire} in a message")
    return out


def read_events(path: Path) -> list[dict]:
    """Every record of a TFRecord event file, both CRCs of each checked, as
    {step, file_version, scalars: [(tag, value)], texts: [(tag, plugin, text)]}."""
    data, pos, events = path.read_bytes(), 0, []
    while pos < len(data):
        header = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        body = data[pos + 12:pos + 12 + n]
        crcs = struct.unpack("<II", data[pos + 8:pos + 12] + data[pos + 12 + n:pos + 16 + n])
        if crcs != (masked_crc32c(header), masked_crc32c(body)):
            fail(f"{path.name}: a record at byte {pos} fails its CRC")
        pos += 16 + n
        f = proto_fields(body)
        event = dict(step=f[2][0] if f[2] else 0,
                     file_version=f[3][0].decode() if f[3] else None, scalars=[], texts=[])
        for summary in f[5]:
            for value in proto_fields(summary)[1]:
                v = proto_fields(value)
                tag = v[1][0].decode()
                if v[2]:
                    event["scalars"].append((tag, struct.unpack("<f", v[2][0])[0]))
                if v[8]:
                    plugin = proto_fields(proto_fields(v[9][0])[1][0])[1][0].decode()
                    text = b"".join(proto_fields(v[8][0])[8]).decode()
                    event["texts"].append((tag, plugin, text))
        events.append(event)
    return events


def experiment_run(kernels, smi: str, bert_task) -> dict:
    """(a) ``python -m msla_tpu_torch experiment=vqvae_slakh`` in process on
    phase 22's fixture, in a project of its own: the full-width VQ-VAE at
    batch 64 with the experiment's tensorboard logger, trainer.max_epochs
    cut from 10 to 2; fit, test, visualize and generate (phase 10's bert-base
    weights as best_bert.ckpt), each timed and counted as in phase 22. The
    event files, read back by ``read_events`` (every CRC checked), must hold
    every scalar the Trainer logged, with its tag and step, in order, and the
    hparams as text."""
    import os
    import shutil

    from msla_tpu_torch import main as cli
    from msla_tpu_torch.train.checkpoint import save_checkpoint
    from msla_tpu_torch.train.loggers import TensorBoardLogger
    from msla_tpu_torch.train.trainer import Trainer

    project = CLI_ROOT / "project25"
    best = project / "logs" / "best_checkpoint"
    save_checkpoint(best / "best_bert.ckpt", state_dict=bert_task.net.state_dict())
    stages: dict[str, dict] = {}
    logged: list[tuple] = []
    saved = {"fit": Trainer.fit, "test": Trainer.test, "generate": cli.generate,
             "visualize": cli.visualize, "log": TensorBoardLogger.log_metrics}

    def log_metrics(self, metrics, step):
        logged.extend((self._prefix + k, step, float(v)) for k, v in metrics.items())
        return saved["log"](self, metrics, step)

    env = {k: os.environ.get(k) for k in ("SLAKH_DIR", "PROJECT_ROOT")}
    os.environ.update(SLAKH_DIR=str(CLI_ROOT / "slakh"), PROJECT_ROOT=str(project))
    Trainer.fit, Trainer.test = (staged("fit", saved["fit"], kernels, stages),
                                 staged("test", saved["test"], kernels, stages))
    cli.generate, cli.visualize = (staged("generate", saved["generate"], kernels, stages),
                                   staged("visualize", saved["visualize"], kernels, stages))
    TensorBoardLogger.log_metrics = log_metrics
    reset_counts(kernels)
    try:
        t0 = time.perf_counter()
        test_loss = cli.main(["experiment=vqvae_slakh", f"trainer.max_epochs={EXPERIMENT_EPOCHS}",
                              "extras.print_config=False", "+optimized_metric=test/loss"])
        cli_s = time.perf_counter() - t0
    finally:
        Trainer.fit, Trainer.test = saved["fit"], saved["test"]
        cli.generate, cli.visualize = saved["generate"], saved["visualize"]
        TensorBoardLogger.log_metrics = saved["log"]
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    for stage, names in CLI_STAGE_KERNELS.items():
        absent = [n for n in names if not stages.get(stage, {}).get("launches", {}).get(n)]
        if absent:
            fail(f"experiment {stage}: fp32 kernels that never launched: {absent}")
    if test_loss is None or not np.isfinite(test_loss):
        fail(f"experiment: test/loss {test_loss}")
    if stages["fit"]["steps"] != EXPERIMENT_EPOCHS * BERT_TRAIN_BATCHES:
        fail(f"experiment: fit took {stages['fit']['steps']} steps")
    run_dir, = (project / "logs" / "vqvae_slakh" / "runs").glob("*")
    files = sorted((run_dir / "tensorboard").glob("events.out.tfevents.*"))
    events = [e for path in files for e in read_events(path)]
    scalars = [(tag, e["step"], value) for e in events for tag, value in e["scalars"]]
    want = [(tag, step, float(np.float32(value))) for tag, step, value in logged]
    if [s[:2] for s in scalars] != [w[:2] for w in want] or not all(
            a[2] == b[2] or (np.isnan(a[2]) and np.isnan(b[2])) for a, b in zip(scalars, want)):
        fail(f"experiment: the event files hold {len(scalars)} scalars, the Trainer logged "
             f"{len(want)}, or they part in tag, step or value")
    texts = [t for e in events for t in e["texts"]]
    if len(texts) != 1 or texts[0][:2] != ("hparams/text_summary", "text") or \
            json.loads(texts[0][2]).get("num_embedding") != MODEL["num_embedding"]:
        fail(f"experiment: the hparams text {texts}")
    if not files or any(read_events(path)[0]["file_version"] != "brain.Event:2"
                        for path in files):
        fail("experiment: an event file does not open with its version record")
    written = [best / "best_vqvae.ckpt", best / "codebook.csv",
               run_dir / "checkpoint" / "bert_generated_during_evaluation.wav"]
    if not all(p.is_file() for p in written):
        fail(f"experiment: files not written: {[str(p) for p in written if not p.is_file()]}")
    fit = stages["fit"]
    result = dict(epochs=EXPERIMENT_EPOCHS, cli_s=cli_s, test_loss=test_loss, stages=stages,
                  event_files=len(files), events=len(events), scalars=len(scalars),
                  event_bytes=sum(p.stat().st_size for p in files))
    print(f"[experiment] {smi}: vqvae_slakh fit {fit['steps']} steps in {fit['s']:.3f} s "
          f"({fit['samples_per_s']:.4g} samples/s, busy {fit['device_busy_share']:.4f}), test "
          f"{stages['test']['s']:.3f} s, visualize {stages['visualize']['s']:.3f} s, generate "
          f"{stages['generate']['s']:.3f} s, main() {cli_s:.3f} s; {len(scalars)} scalars in "
          f"{len(files)} event files, every CRC checked; launches fit {fit['launches']}",
          flush=True)
    shutil.rmtree(project, ignore_errors=True)
    return result


def microbatch_kernels(net, dm, raw: torch.Tensor) -> list[dict]:
    """K1b, K2b, #4 and #5 re-timed on one batch-32 microbatch of (b): K1b on
    its model input, #4 on its pre-VQ latents and the codebook, K2b on the
    decoder's stem input for those codes, #5 on a gradient of the latents'
    shape summed by those codes; each against its plain version, timed
    beside one library call as in phase 6."""
    import torch.nn.functional as F

    from msla_tpu_torch.ops import (conv_stem_ref, conv_stem_save_hidden, deconv_stem_ref,
                                    deconv_stem_save_hidden, vq_codebook_grad,
                                    vq_codebook_grad_ref, vq_fused_fwd, vq_fused_fwd_ref)
    from msla_tpu_torch.ops.conv_adjoints import fp32_convs

    enc, dec = net.encoder, net.decoder
    b, w, k_codes = raw.shape[0], FRAME // 4, MODEL["num_embedding"]
    report = []
    with torch.no_grad():
        x = dm.on_after_batch_transfer(raw)[0].contiguous()
        args = (x, enc.conv1.weight, enc.conv1.bias, enc.conv2.weight, enc.conv2.bias)
        out, h = conv_stem_save_hidden(*args)
        want_out, want_h = conv_stem_ref(*args)
        err = max(check_close("conv_stem_save_hidden (microbatch) out", out, want_out),
                  check_close("conv_stem_save_hidden (microbatch) hidden", h, want_h))
        with fp32_convs():
            lib = time_ms(lambda: F.relu(F.conv1d(F.relu(F.conv1d(x, args[1], args[2], 2, 1)),
                                                  args[3], args[4], 2, 1)))
        flops = 2 * b * (FRAME // 2 * 64 * 4 * 4 + w * 128 * 64 * 4)
        report.append(dict(
            name="conv_stem_save_hidden", route="cuda", source="msla_tpu_torch/csrc/conv_stem.cu",
            replaces="msla_tpu/ops/conv_stem.py:132", max_abs_err=err,
            ms=time_ms(lambda: conv_stem_save_hidden(*args)),
            plain_ms=time_ms(lambda: conv_stem_ref(*args)), library_ms=lib, flop=flops,
            bytes=nbytes(*args, out, h), **tf32_bounds(flops, nbytes(*args, out, h))))
        del out, h, want_out, want_h

        flat = net.encode(x).reshape(-1, MODEL["embedding_dim"])
        cb = net.vector_quantizer.codebook.weight.detach()
        q, idx, counts, sq, (mismatches, gap, rel_gap), sq_rel = check_fused(flat, cb)
        e2 = (cb * cb).sum(1)

        def composite():
            i = torch.argmin(e2 - 2.0 * torch.matmul(flat, cb.T), dim=1)
            qq = cb.index_select(0, i)
            return torch.bincount(i, minlength=k_codes), ((qq - flat) ** 2).sum()

        flops = 2 * flat.shape[0] * k_codes * 64
        report.append(dict(
            name="vq_fused_fwd", route="cuda", source="msla_tpu_torch/csrc/vq_fused.cu",
            replaces="msla_tpu/ops/vq_fused.py:42", max_abs_err=gap, index_mismatches=mismatches,
            max_tie_gap=rel_gap, sq_rel_err=sq_rel, ms=time_ms(lambda: vq_fused_fwd(flat, cb)),
            plain_ms=time_ms(lambda: vq_fused_fwd_ref(flat, cb)), library_ms=time_ms(composite),
            flop=flops, bytes=nbytes(flat, cb, q, idx, counts, sq),
            **tf32_bounds(flops, nbytes(flat, cb, q, idx, counts, sq))))

        with fp32_convs():
            stem_in = dec.residual_stack(dec.conv1(q.reshape(b, w, -1).transpose(1, 2)))
        args = (stem_in.contiguous(), dec.conv1_transpose.weight, dec.conv1_transpose.bias,
                dec.conv2_transpose.weight, dec.conv2_transpose.bias)
        out, h = deconv_stem_save_hidden(*args)
        want_out, want_h = deconv_stem_ref(*args)
        err = max(check_close("deconv_stem_save_hidden (microbatch) out", out, want_out),
                  check_close("deconv_stem_save_hidden (microbatch) hidden", h, want_h))
        with fp32_convs():
            lib = time_ms(lambda: F.conv_transpose1d(
                F.relu(F.conv_transpose1d(args[0], args[1], args[2], 2, 1)), args[3], args[4],
                2, 1))
        flops = 2 * b * (2 * w * 64 * 128 * 2 + 4 * w * 4 * 64 * 2)
        report.append(dict(
            name="deconv_stem_save_hidden", route="cuda",
            source="msla_tpu_torch/csrc/deconv_stem.cu",
            replaces="msla_tpu/ops/deconv_stem.py:132", max_abs_err=err,
            ms=time_ms(lambda: deconv_stem_save_hidden(*args)),
            plain_ms=time_ms(lambda: deconv_stem_ref(*args)), library_ms=lib, flop=flops,
            bytes=nbytes(*args, out, h), **tf32_bounds(flops, nbytes(*args, out, h))))
        del out, h, want_out, want_h

        g = torch.Generator(device=flat.device).manual_seed(25)
        grad = torch.randn(flat.shape, generator=g, device=flat.device)
        want = torch.zeros((k_codes, 64), dtype=torch.float64, device=flat.device).index_add_(
            0, idx.long(), grad.double())
        err = check_close("vq_codebook_grad (microbatch)",
                          vq_codebook_grad(grad, idx, k_codes).double(), want)
        ids_long, zeros = idx.long(), torch.zeros((k_codes, 64), device=flat.device)
        report.append(dict(
            name="vq_codebook_grad", route="cuda", source="msla_tpu_torch/csrc/segment_sum.cuh",
            replaces="msla_tpu/ops/vq_fused.py:81", max_abs_err=err,
            ms=time_ms(lambda: vq_codebook_grad(grad, idx, k_codes)),
            plain_ms=time_ms(lambda: vq_codebook_grad_ref(grad, idx, k_codes)),
            library_ms=time_ms(lambda: zeros.index_add_(0, ids_long, grad)),
            library_call="index_add_", flop=flat.shape[0] * 64,
            bytes=nbytes(grad, idx) + k_codes * 64 * 4))
    return report


def vq_task(seed: int = 0):
    """A full-width VQVAETask on the card."""
    from msla_tpu_torch.models.vqvae import VQVAETask

    return VQVAETask(**MODEL, checkpoint_dir=str(CLI_ROOT / "steps"),
                     codebook_file=str(CLI_ROOT / "steps" / "codebook.csv"), device="cuda",
                     seed=seed)


def vq_trainer(dm, seed: int = 0, **kw):
    """A full-width VQVAETask and a Trainer (seed 0) set up on it."""
    from msla_tpu_torch.train.trainer import Trainer

    task = vq_task(seed)
    trainer = Trainer(seed=0, enable_progress_bar=False, **kw)
    trainer._setup(task, dm)
    return task, trainer


def accumulation(kernels, smi: str):
    """(b) One optimizer step of ``accumulate_grad_batches=2`` at batch 32 and
    one step at batch 64, on the same 64 examples (masking off) from the same
    weights: the mean gradients within atol 1e-4 of each tensor's largest,
    rtol 1e-3, and the updated parameters within atol = rtol = 1e-4 wherever
    the batch-64 gradient is clear of 0 (above 1e-3 of its tensor's largest:
    Adam's first step moves a parameter by ±lr whatever the size of its
    gradient, so an entry at rounding's size may step either way; those are
    counted). Launches per optimizer step exactly 2 of K1b, K2b, #4 and #5
    (1 at batch 64); each step's ms (CUDA events, median of 5) and peak.
    Returns the figures, the re-timed kernels and the batch-64 trainer."""
    full = synthetic_stems(1, seed=25)[0]
    dm = in_memory_datamodule([full], synthetic_stems(1, seed=26), masking=False)
    dev_full = torch.from_numpy(full).to("cuda")
    halves = [dev_full[:ACC_BATCH].contiguous(), dev_full[ACC_BATCH:].contiguous()]
    steps, tasks = {}, {}
    for name, k, group in (("accumulate_2x32", 2, halves), ("batch_64", 1, [dev_full])):
        task, trainer = vq_trainer(dm, accumulate_grad_batches=k)
        reset_counts(kernels)
        steps[name] = peak_step(lambda: trainer._train_step(task, dm, group))
        per_step = {n: c for n, c in launch_counts(kernels).items() if c}
        if per_step != {n: k for n in ACC_KERNELS}:
            fail(f"accumulation {name}: launches an optimizer step {per_step}")
        steps[name].update(launches_per_step=per_step)
        tasks[name] = (task, trainer, group,
                       {n: p.grad.clone() for n, p in task.net.named_parameters()},
                       {n: p.detach().clone() for n, p in task.net.named_parameters()})
    (acc, _, halves, acc_grads, acc_params), (one, one_trainer, _, grads, params) = (
        tasks["accumulate_2x32"], tasks["batch_64"])
    unclear, worst = 0, 0.0
    for key, g in grads.items():
        err = (acc_grads[key] - g).abs()
        if (err > 1e-4 * g.abs().max() + 1e-3 * g.abs()).any():
            fail(f"accumulation: {key}'s mean gradient off the batch-64 one by "
                 f"{err.max().item():.3e}")
        clear = g.abs() > 1e-3 * g.abs().max()
        off = (acc_params[key] - params[key]).abs() > 1e-4 + 1e-4 * params[key].abs()
        if (off & clear).any():
            fail(f"accumulation: {key} updated off the batch-64 step where its gradient is "
                 f"clear of 0 ({(off & clear).sum().item()} entries)")
        unclear += int(off.sum().item())
        worst = max(worst, (acc_params[key] - params[key]).abs().max().item())
    for name, (task, trainer, group, *_) in tasks.items():
        steps[name]["step_ms"] = time_ms(lambda: trainer._train_step(task, dm, group), reps=5,
                                         warmup=1)
    report = microbatch_kernels(acc.net, dm, halves[0])
    del tasks["accumulate_2x32"], acc
    torch.cuda.empty_cache()
    result = dict(steps=steps, max_param_diff=worst, params_off_where_unclear=unclear)
    print(f"[accumulate] {smi}: accumulate_grad_batches=2 at batch {ACC_BATCH}: "
          f"{steps['accumulate_2x32']['step_ms']:.2f} ms an optimizer step, peak "
          f"{steps['accumulate_2x32']['step_gb']:.2f} GB over the resident; batch 64: "
          f"{steps['batch_64']['step_ms']:.2f} ms, {steps['batch_64']['step_gb']:.2f} GB over "
          f"the resident; the updated parameters part by "
          f"at most {worst:.3e}, {unclear} entries beyond 1e-4 where the gradient is not "
          f"clear of 0; launches an optimizer step {steps['accumulate_2x32']['launches_per_step']}",
          flush=True)
    return result, report, (one, one_trainer, dm)


def profiled_epoch(smi: str) -> dict:
    """(c) One epoch of ``fit`` with ``profiler="jax"`` (2 train and 1
    validation batch of 64, masking on), after the same epoch untraced: the
    trace under default_root_dir/jax_trace must hold, among its device
    events, the stem, fused-VQ and segment-sum kernels by name; both fits'
    host seconds and the five costliest device ops."""
    import shutil

    from msla_tpu_torch.train.trainer import Trainer

    root = CLI_ROOT / "trace"
    dm = in_memory_datamodule(synthetic_stems(2, seed=27), synthetic_stems(1, seed=28))
    task = vq_task()
    seconds = {}
    for profiler in (None, "jax"):  # the same epoch untraced first (also a warm-up)
        trainer = Trainer(default_root_dir=str(root), max_epochs=1, seed=0,
                          enable_progress_bar=False, profiler=profiler)
        t0 = time.perf_counter()
        trainer.fit(task, dm)
        torch.cuda.synchronize()
        seconds[profiler or "untraced"] = time.perf_counter() - t0
    fit_s = seconds["jax"]
    traces = sorted((root / "jax_trace").glob("*.pt.trace.json"))
    if len(traces) != 1:
        fail(f"profiler: traces written {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    found = {part: sum(1 for e in device if e.get("cat") == "kernel"
                       and any(w in e.get("name", "") for w in words))
             for part, words in TRACE_KERNELS.items()}
    if not all(found.values()):
        fail(f"profiler: the trace's device events lack the port's kernels: {found}")
    costs = collections.Counter()
    for e in device:
        costs[e["name"][:80]] += e.get("dur", 0) / 1e3
    top = dict(costs.most_common(5))
    result = dict(fit_s=fit_s, untraced_fit_s=seconds["untraced"],
                  trace_bytes=traces[0].stat().st_size, events=len(events),
                  device_events=len(device), port_kernels=found, top5_device_ms=top)
    print(f"[profiler] {smi}: profiler=\"jax\" fit of {trainer.global_step} steps in "
          f"{fit_s:.3f} s (untraced {seconds['untraced']:.3f} s), trace "
          f"{result['trace_bytes']} B with {len(device)} device events; "
          f"the port's kernels {found}; the five costliest device ops (ms) {json.dumps(top)}",
          flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return result


def wire_error_ok(codec: str, exact: torch.Tensor, got: torch.Tensor) -> bool:
    """Whether a decoded tensor lies within its codec's bound of the exact one:
    bf16 half an ulp (2⁻⁸ of |x|), q8 half a step of its block's max (and
    fp32's rounding of the scale and product); a tensor the codec leaves (not
    floating, or under 16,384 elements) bit-equal."""
    if not exact.is_floating_point() or exact.numel() < WIRE_FLOOR:
        return torch.equal(exact, got)
    err = (got.double() - exact.double()).abs().reshape(-1)
    if codec == "bf16":
        return bool((err <= exact.double().abs().reshape(-1) * 2.0 ** -8).all())
    flat = exact.double().abs().reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % Q8_BLOCK)).view(-1, Q8_BLOCK)
    bound = (flat.amax(1) * (0.5 / 127 + 2.0 ** -22)).repeat_interleave(Q8_BLOCK)
    return bool((err <= bound[:err.numel()]).all())


def leaves(tree, prefix="") -> dict:
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in leaves(sub, f"{prefix}/{key}").items()}
    return {}


def wire_writes(trainer, task, dm, smi: str) -> dict:
    """(d) ``save_checkpoint`` of the batch-64 step's state exact, ``bf16`` and
    ``q8`` (in the loop): each file's bytes and seconds; every decoded tensor
    within its codec's bound (``wire_error_ok``: weights bf16 under both, the
    moments bf16 or q8); then ``fit`` resumes one step from the q8 file, on
    its decoded weights and moments."""
    from msla_tpu_torch.train.checkpoint import load_checkpoint
    from msla_tpu_torch.train.trainer import Trainer

    d = CLI_ROOT / "wire"
    writes = {}
    for wire in ("off", "bf16", "q8"):
        path = d / f"last_{wire}.ckpt"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.save_checkpoint(path, wire=wire)
        writes[wire] = dict(s=time.perf_counter() - t0, bytes=path.stat().st_size)
    exact = load_checkpoint(d / "last_off.ckpt")
    for wire, opt_codec in (("bf16", "bf16"), ("q8", "q8")):
        got = load_checkpoint(d / f"last_{wire}.ckpt")
        for part, codec in (("state_dict", "bf16"), ("opt_state", opt_codec)):
            want, have = leaves(exact[part]), leaves(got[part])
            if want.keys() != have.keys():
                fail(f"wire {wire}: the decoded {part} has other tensors")
            bad = [k for k in want if have[k].shape != want[k].shape
                   or have[k].dtype != want[k].dtype or not wire_error_ok(codec, want[k],
                                                                          have[k])]
            if bad:
                fail(f"wire {wire}: {part} tensors beyond the {codec} bound: {bad[:5]}")
    q8 = d / "last_q8.ckpt"
    resumed_task = vq_task(seed=1)
    resumed = Trainer(seed=0, enable_progress_bar=False, max_epochs=1, limit_train_batches=1,
                      limit_val_batches=1)
    resumed._setup(resumed_task, dm)
    resumed._restore(q8)
    decoded = load_checkpoint(q8)
    if any(not torch.equal(v.cpu(), decoded["state_dict"][k])
           for k, v in resumed_task.net.state_dict().items()):
        fail("wire q8: fit restored other weights than the file's")
    resumed.fit(resumed_task, dm, ckpt_path=str(q8))
    if resumed.global_step != trainer.global_step + 1 or not np.isfinite(
            resumed.callback_metrics["train/loss"]):
        fail(f"wire q8: the resumed fit ended at step {resumed.global_step}")
    result = dict(writes=writes, q8_resumed_step=resumed.global_step,
                  q8_resumed_loss=resumed.callback_metrics["train/loss"])
    print(f"[wire] {smi}: the VQ-VAE's weights and Adam: exact {writes['off']['bytes']} B in "
          f"{writes['off']['s']:.3f} s, bf16 {writes['bf16']['bytes']} B in "
          f"{writes['bf16']['s']:.3f} s, q8 {writes['q8']['bytes']} B in {writes['q8']['s']:.3f}"
          f" s; every decoded tensor within its codec's bound; fit resumed one step from q8",
          flush=True)
    return result


def msgpack_pack(obj) -> bytes:
    """msgpack as flax's ``msgpack_serialize`` writes a checkpoint: dicts as
    maps in key order, str, int, float (f64), bytes as bin, lists as arrays,
    numpy arrays as ext type 1 holding (shape, dtype name, bytes), each in
    its smallest form."""
    def head(n: int, small: int, small_max: int, codes: tuple) -> bytes:
        if n <= small_max:
            return bytes([small | n])
        for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
            if code is not None and n <= top:
                return bytes([code]) + struct.pack(fmt, n)
        fail(f"msgpack: {n} items")

    if isinstance(obj, dict):
        return head(len(obj), 0x80, 15, (None, 0xDE, 0xDF)) + b"".join(
            msgpack_pack(k) + msgpack_pack(v) for k, v in sorted(obj.items()))
    if isinstance(obj, (list, tuple)):
        return head(len(obj), 0x90, 15, (None, 0xDC, 0xDD)) + b"".join(map(msgpack_pack, obj))
    if isinstance(obj, str):
        data = obj.encode()
        return head(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + data
    if isinstance(obj, bytes):
        return head(len(obj), 0, -1, (0xC4, 0xC5, 0xC6)) + obj
    if obj is None or isinstance(obj, bool):
        return bytes([{None: 0xC0, False: 0xC2, True: 0xC3}[obj]])
    if isinstance(obj, int):
        if 0 <= obj < 128 or -32 <= obj < 0:
            return struct.pack(">b" if obj < 0 else ">B", obj)
        for code, fmt, lo, hi in ((0xCC, ">B", 0, 2**8), (0xCD, ">H", 0, 2**16),
                                  (0xCE, ">I", 0, 2**32), (0xCF, ">Q", 0, 2**64),
                                  (0xD0, ">b", -2**7, 0), (0xD1, ">h", -2**15, 0),
                                  (0xD2, ">i", -2**31, 0), (0xD3, ">q", -2**63, 0)):
            if lo <= obj < hi:
                return bytes([code]) + struct.pack(fmt, obj)
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, np.ndarray):
        data = msgpack_pack([list(obj.shape), obj.dtype.name, obj.tobytes()])
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(data) in fixed:
            return bytes([fixed[len(data)], 1]) + data
        return head(len(data), 0, -1, (0xC7, 0xC8, 0xC9)) + b"\x01" + data
    fail(f"msgpack: cannot pack {type(obj)}")


def vqvae_jax_tree(sd: dict, num_residual_layer: int = MODEL["num_residual_layer"]) -> dict:
    """The port's VQ-VAE state_dict (or a tree of its layout: Adam's moments)
    as the JAX ``VQVAENet``'s params: the inverse of
    ``utils/jax_compat.vqvae_state_dict_from_jax``, each kernel's axes
    reversed, as fp32 numpy arrays."""
    def arr(t):
        return np.ascontiguousarray(t.detach().float().cpu().numpy())

    def conv(key):
        node = {"kernel": arr(sd[f"{key}.weight"].permute(2, 1, 0))}
        if f"{key}.bias" in sd:
            node["bias"] = arr(sd[f"{key}.bias"])
        return {"conv": node}

    def stack(prefix):
        out = {}
        for i in range(num_residual_layer):
            out[f"block{i}_conv3"] = conv(f"{prefix}.residual_layers.{i}.1")
            out[f"block{i}_conv1"] = conv(f"{prefix}.residual_layers.{i}.3")
        return out

    return {"encoder": {"conv1": conv("encoder.conv1"), "conv2": conv("encoder.conv2"),
                        "conv3": conv("encoder.conv3"),
                        "residual_stack": stack("encoder.residual_stack")},
            "pre_vq_conv": conv("conv"),
            "vector_quantizer": {"codebook": arr(sd["vector_quantizer.codebook.weight"])},
            "decoder": {"conv1": conv("decoder.conv1"),
                        "residual_stack": stack("decoder.residual_stack"),
                        "conv1_transpose": conv("decoder.conv1_transpose"),
                        "conv2_transpose": conv("decoder.conv2_transpose")}}


def jax_checkpoint(trainer, task) -> dict:
    """The Trainer's VQ-VAE state as the JAX package's ``save_checkpoint``
    lays it out: the flax params, optax.adam's state ({"0": count, mu, nu;
    "1": {}}) and the meta fields."""
    names = {id(p): n for n, p in task.net.named_parameters()}
    mu, nu, count = {}, {}, None
    for p, state in trainer._optimizer.state.items():
        mu[names[id(p)]], nu[names[id(p)]] = state["exp_avg"], state["exp_avg_sq"]
        count = int(state["step"].item())
    return {"state_dict": vqvae_jax_tree(task.net.state_dict()),
            "opt_state": {"0": {"count": np.array(count, dtype=np.int32),
                                "mu": vqvae_jax_tree(mu), "nu": vqvae_jax_tree(nu)},
                          "1": {}},
            "epoch": trainer.current_epoch, "global_step": trainer.global_step,
            "hparams": json.dumps(task.hparams, default=str), "callback_metrics": {},
            "callbacks": "[]"}


def jax_resume(trainer, task, dm, smi: str) -> dict:
    """(e) The batch-64 step's state written twice: as a port checkpoint and,
    by ``jax_checkpoint`` and ``msgpack_pack``, as a JAX msgpack file (the
    card has neither flax nor msgpack). ``fit`` resumes one step from each,
    on new tasks of another seed, with cuDNN deterministic: the two end with
    the same weights and Adam state bit for bit."""
    from msla_tpu_torch.train.checkpoint import is_jax_file
    from msla_tpu_torch.train.trainer import Trainer

    d = CLI_ROOT / "jax_resume"
    d.mkdir(parents=True, exist_ok=True)
    trainer.save_checkpoint(d / "port.ckpt")
    t0 = time.perf_counter()
    (d / "jax.ckpt").write_bytes(msgpack_pack(jax_checkpoint(trainer, task)))
    jax_write_s = time.perf_counter() - t0
    if not is_jax_file(d / "jax.ckpt"):
        fail("jax resume: the msgpack file does not read as a JAX checkpoint")
    ends = {}
    flags = dict(enabled=True, benchmark=False, deterministic=True, allow_tf32=False)
    for name in ("port", "jax"):
        resumed_task = vq_task(seed=1)
        resumed = Trainer(seed=0, enable_progress_bar=False, max_epochs=1,
                          limit_train_batches=1, limit_val_batches=1)
        with torch.backends.cudnn.flags(**flags):
            resumed.fit(resumed_task, dm, ckpt_path=str(d / f"{name}.ckpt"))
        ends[name] = (resumed.global_step, resumed_task.net.state_dict(),
                      resumed._optimizer.state_dict()["state"])
    (step_p, sd_p, opt_p), (step_j, sd_j, opt_j) = ends["port"], ends["jax"]
    differ = [k for k, v in sd_p.items() if not torch.equal(v, sd_j[k])]
    differ += [f"adam {i} {k}" for i, s in opt_p.items() for k, v in s.items()
               if not torch.equal(v, opt_j[i][k])]
    if step_p != step_j or step_p != trainer.global_step + 1 or differ:
        fail(f"jax resume: steps {step_p} / {step_j}, differing {differ[:5]}")
    result = dict(bit_exact=True, step=step_j, jax_file_bytes=(d / "jax.ckpt").stat().st_size,
                  jax_write_s=jax_write_s)
    print(f"[jax resume] {smi}: fit resumed one step from a JAX msgpack file "
          f"({result['jax_file_bytes']} B) and from the port's file of the same state: the "
          f"same weights and Adam state bit for bit", flush=True)
    return result


def phase_rest_of_trainer(kernels, smi: str, bert_task) -> tuple[dict, list[dict]]:
    """The rest of the trainer on the card, at full width (hidden 128, K =
    512, D = 64): (a) ``experiment_run``, (b) ``accumulation``, (c)
    ``profiled_epoch``, (d) ``wire_writes``, (e) ``jax_resume``; then all of
    CLI_ROOT but phase 22's fixture, which phase 28 reads, is removed.
    Returns the figures and (b)'s re-timed kernels."""
    import shutil

    experiment = experiment_run(kernels, smi, bert_task)
    acc, report, (task, trainer, dm) = accumulation(kernels, smi)
    profile = profiled_epoch(smi)
    wire = wire_writes(trainer, task, dm, smi)
    resume = jax_resume(trainer, task, dm, smi)
    fit_launches = experiment["stages"]["fit"]["launches"]
    for k in report:
        k.update(launches=fit_launches.get(k["name"], 0),
                 launches_per_optimizer_step=acc["steps"]["accumulate_2x32"][
                     "launches_per_step"][k["name"]], path="accumulate_grad_batches")
    report = with_bounds(report)
    for k in report:
        k["name"] += "@accumulate_grad_batches"
    del task, trainer
    torch.cuda.empty_cache()
    result = dict(experiment=experiment, accumulation=acc, profiler=profile, wire=wire,
                  jax_resume=resume)
    print(f"[rest of trainer] {json.dumps(result)}", flush=True)
    for path in CLI_ROOT.iterdir():
        if path.name != "slakh":
            shutil.rmtree(path, ignore_errors=True) if path.is_dir() else path.unlink()
    return result, report


#: phase 26: the sweep's widths at full length, batch 32 (T = 44,000, W = 11,000)
SWEEP_BATCH = 32
SWEEP_HIDDEN = (64, 128, 256)          # configs/hparams_search/optuna.yaml's num_hidden
SWEEP_CODES = tuple((k, d) for k in (128, 256, 512) for d in (64, 128, 256))
SWEEP_REPS = 5                         # timed runs a figure (the median), after one warm-up
SWEEP_FP64_ITEMS = 4                   # batch items the stems' fp64 bound is computed on
#: K1/K1b lengths at batch 2, around the 64-position tile of num_hidden 256's
#: kernel (T = 256) and the default's 128 (T = 512), most not divisible by 4
SWEEP_RAGGED_T = (7, 255, 257, 260, 511, 513, 1_030, 44_003)
#: K2/K2b widths at batch 2 around the 60-position tile of the 3xTF32 kernels,
#: most not divisible by 4
SWEEP_RAGGED_W = (1, 59, 60, 61, 63, 64, 119, 121, 1_001)


def width_label(name: str, widths: tuple) -> str:
    """A kernel instantiation's name in the kernels line: 'conv_stem[32x64]'
    (the stems' channels), 'nearest_codes[D=256,K=512]' (the VQ kernels')."""
    if name.startswith(("conv", "deconv")):
        return f"{name}[{'x'.join(str(w) for w in widths)}]"
    return f"{name}[D={widths[0]},K={widths[1]}]"


def kernel_smem(symbol: str, *widths: int) -> int:
    """Shared memory of a block of a kernel at its widths, as its source
    reports it (``conv_stem_smem_bytes``, ``deconv_stem_smem_bytes``:
    dynamic; ``vq_search_smem_bytes``: dynamic and static)."""
    from msla_tpu_torch.ops._build import kernel

    smem = kernel(symbol)(*widths)
    if smem < 0:
        fail(f"{symbol}: not compiled for widths {widths}")
    return smem


def search_smem(k: int, d: int, with_hist: bool) -> int:
    """K3's (or, ``with_hist``, #4's) shared memory at (K, D) as
    csrc/nearest_codes.cu reports it; fails unless the wrappers admit K by
    the same figure (``search_smem_bytes``)."""
    from msla_tpu_torch.ops.nearest_codes import search_smem_bytes

    got = kernel_smem("vq_search_smem_bytes", k, d, int(with_hist))
    if got != search_smem_bytes(k, with_hist, d):
        fail(f"vq_search_smem_bytes({k}, {d}, {int(with_hist)}) = {got}, the wrappers' "
             f"search_smem_bytes {search_smem_bytes(k, with_hist, d)}")
    return got


def ptxas_of(ptxas: dict, source: str, kernel: str) -> dict:
    """What ptxas reported (registers, spills) of ``kernel`` (with its
    template arguments) in ``source``'s build."""
    return ptxas.get(f"{source}/{kernel}", {})


def sweep_stem_rows(dev, g, ptxas: dict, transposed: bool) -> list[dict]:
    """K1/K1b (or K2/K2b) at each of the sweep's stem widths: the kernel
    against its plain version at batch 32 and full length (atol = rtol =
    1e-4), against fp64 within its 3xTF32 accumulation bound on
    SWEEP_FP64_ITEMS items, output and hidden, at ragged lengths, the same
    bits on a second call, and timed beside the plain version and the cuDNN
    pair."""
    import torch.nn.functional as F

    from msla_tpu_torch.ops import (conv_stem, conv_stem_ref, conv_stem_save_hidden,
                                    deconv_stem, deconv_stem_ref, deconv_stem_save_hidden)
    from msla_tpu_torch.ops.conv_adjoints import fp32_convs

    b, w = SWEEP_BATCH, FRAME // 4
    rows = []
    for hidden in SWEEP_HIDDEN:
        half = hidden // 2
        if transposed:
            names, ref, fns = ("deconv_stem", "deconv_stem_save_hidden"), deconv_stem_ref, (
                deconv_stem, deconv_stem_save_hidden)
            widths = (hidden, half)
            x = torch.rand((b, hidden, w), generator=g, device=dev)
            w1 = torch.randn((hidden, half, 4), generator=g, device=dev) / (2 * hidden) ** 0.5
            w2 = torch.randn((half, 4, 4), generator=g, device=dev) / (2 * half) ** 0.5
            b2 = torch.randn((4,), generator=g, device=dev) * 0.1
            conv, replaces = F.conv_transpose1d, ("msla_tpu/ops/deconv_stem.py:35",
                                                  "msla_tpu/ops/deconv_stem.py:132")
            flop = 2 * b * (2 * w * half * hidden * 2 + 4 * w * 4 * half * 2)
        else:
            names, ref, fns = ("conv_stem", "conv_stem_save_hidden"), conv_stem_ref, (
                conv_stem, conv_stem_save_hidden)
            widths = (half, hidden)
            x = torch.randn((b, 4, FRAME), generator=g, device=dev) * 0.3
            w1 = torch.randn((half, 4, 4), generator=g, device=dev) / 4.0
            w2 = torch.randn((hidden, half, 4), generator=g, device=dev) / (4 * half) ** 0.5
            b2 = torch.randn((hidden,), generator=g, device=dev) * 0.1
            conv, replaces = F.conv1d, ("msla_tpu/ops/conv_stem.py:48",
                                        "msla_tpu/ops/conv_stem.py:132")
            flop = 2 * b * (FRAME // 2 * half * 16 + w * hidden * 4 * half)
        b1 = torch.randn((half,), generator=g, device=dev) * 0.1
        args = (x, w1, b1, w2, b2)
        source = "deconv_stem" if transposed else "conv_stem"
        # W2' (K1) or W1' (K2) outgrows a block at 256: in groups, over a cluster
        design = "" if hidden < SWEEP_HIDDEN[-1] else "_cluster" if transposed else "_groups"
        kernel = f"{source}_3xtf32{design}_kernel<{widths[0]},{widths[1]}>"
        with fp32_convs():
            lib = time_ms(lambda: conv(F.relu(conv(x, w1, b1, 2, 1)), w2, b2, 2, 1),
                          SWEEP_REPS, 1)
        for name, fn, rep in zip(names, fns, replaces):
            hidden_out = name.endswith("save_hidden")
            got = fn(*args)
            out, h = got if hidden_out else (got, None)
            torch.cuda.synchronize()
            want, want_h = ref(*args)
            label = width_label(name, widths)
            err = max(check_close(label, out, want),
                      check_close(label + " hidden", h, want_h) if hidden_out else 0.0)
            del want, want_h
            few = tuple(a[:SWEEP_FP64_ITEMS] if i == 0 else a for i, a in enumerate(args))
            share = stem_fp64_share(label, stem_accumulation_bound(
                *few, transposed=transposed), out[:SWEEP_FP64_ITEMS],
                None if h is None else h[:SWEEP_FP64_ITEMS])
            same_bits(label, got if hidden_out else (got,), fn(*args) if hidden_out
                      else (fn(*args),))
            ragged = {}
            for n in SWEEP_RAGGED_W if transposed else SWEEP_RAGGED_T:
                small = ((torch.rand if transposed else torch.randn)(
                    (2, x.shape[1], n), generator=g, device=dev),) + args[1:]
                got = fn(*small)
                got, got_h = got if hidden_out else (got, None)
                want, want_h = ref(*small)
                ragged[n] = max(check_close(f"{label} at {n}", got, want),
                                check_close(f"{label} hidden at {n}", got_h, want_h)
                                if hidden_out else 0.0)
            moved = nbytes(*args, out) + (nbytes(h) if hidden_out else 0)
            ms = time_ms(lambda: fn(*args), SWEEP_REPS, 1)
            print(f"[stem] {label}: {ms:.4f} ms, the cuDNN pair {lib:.4f} ms in this run "
                  f"({ms / lib:.3f}x)", flush=True)
            rows.append(dict(
                name=label, route="cuda", source=f"msla_tpu_torch/csrc/{source}.cu",
                replaces=rep, widths=list(widths), design="3xTF32" + design, max_abs_err=err,
                fp64_share_of_bound=share, ragged_max_abs_err=ragged, ms=ms,
                plain_ms=time_ms(lambda: ref(*args), SWEEP_REPS, 1), library_ms=lib,
                flop=flop, bytes=moved, registers=ptxas_of(ptxas, source, kernel),
                smem_bytes=kernel_smem(f"{source}_smem_bytes", *widths),
                **tf32_bounds(flop, moved)))
            del out, h
        del x
    torch.cuda.empty_cache()
    return rows


def sweep_vq_rows(dev, g, ptxas: dict) -> list[dict]:
    """K3, #4 and #5 at each (K, D) of the sweep at batch 32's N = 352,000
    rows: K3's and #4's ids each equal to the plain version's or a near-tie
    (planted ties and close pairs and ragged N at K = 512, each D), #4's q
    the codebook rows bit for bit, counts a bincount, sq within 1e-5 of fp64
    and the same bits twice; #5 on #4's ids and on uniform ids bit-equal to
    codebook_grad_order_ref at the card's grid of each column slice, within
    segment_sum_bound and the same bits twice; each timed beside its plain
    version and a library call."""
    from msla_tpu_torch.ops import (nearest_codes, nearest_codes_ref, vq_codebook_grad,
                                    vq_codebook_grad_ref, vq_fused_fwd, vq_fused_fwd_ref)
    from msla_tpu_torch.ops.vq_fused import grad_smem_bytes

    n = SWEEP_BATCH * FRAME // 4
    rows = []
    for d in (64, 128, 256):
        planted = {w: vq_planted_picks(f"{w}[D={d}]", s, dev, g, d) for w, s in (
            ("nearest_codes", nearest_codes), ("vq_fused_fwd", lambda x, e: check_fused(x, e)[1]))}
        ragged = {w: ragged_rows(s, dev, g, (1, 7, 129, 4_097), d) for w, s in (
            ("nearest_codes", nearest_codes), ("vq_fused_fwd", lambda x, e: check_fused(x, e)[1]))}
        search = f"nearest_codes_{'kernel' if d == 64 else 'ring_kernel'}<{d}>"
        fused = f"vq_fused_{'fwd_kernel' if d == 64 else 'ring_kernel'}<{d}>"
        for source, name in (("nearest_codes", search), ("vq_fused", fused)):
            regs = ptxas_of(ptxas, source, name)
            if d > 64 and (not regs or regs.get("spill_stores", 0) or regs.get("spill_loads", 0)):
                fail(f"{source}/{name}: ptxas reports {regs or 'no such kernel'}: the ring "
                     f"kernels must not spill")
        for k in (128, 256, 512):
            flat = torch.randn((n, d), generator=g, device=dev)
            cb = torch.randn((k, d), generator=g, device=dev)
            e2 = (cb * cb).sum(1)
            flop = 2 * n * k * d
            idx = nearest_codes(flat, cb)
            torch.cuda.synchronize()
            mismatches, gap, rel = near_ties(flat, cb, idx, nearest_codes_ref(flat, cb))
            moved = nbytes(flat, cb, idx)
            rows.append(dict(
                name=width_label("nearest_codes", (d, k)), route="cuda",
                source="msla_tpu_torch/csrc/nearest_codes.cu",
                replaces="msla_tpu/ops/vq_pallas.py:40", widths=[d, k],
                design=("codebook in shared memory" if d == 64
                        else "codebook through a TMA ring"),
                max_abs_err=gap, index_mismatches=mismatches, max_tie_gap=rel,
                **planted["nearest_codes"], ragged_n_mismatches=ragged["nearest_codes"],
                ms=time_ms(lambda: nearest_codes(flat, cb), SWEEP_REPS, 1),
                plain_ms=time_ms(lambda: nearest_codes_ref(flat, cb), SWEEP_REPS, 1),
                library_ms=time_ms(lambda: torch.argmin(e2 - 2.0 * torch.matmul(flat, cb.T),
                                                        dim=1), SWEEP_REPS, 1),
                flop=flop, bytes=moved, registers=ptxas_of(ptxas, "nearest_codes", search),
                smem_bytes=search_smem(k, d, False), **tf32_bounds(flop, moved)))

            q, idx, counts, sq, (mismatches, gap, rel), sq_rel = check_fused(flat, cb)

            def composite():  # matmul, argmin, gather, bincount, sum
                i = torch.argmin(e2 - 2.0 * torch.matmul(flat, cb.T), dim=1)
                return torch.bincount(i, minlength=k), ((cb.index_select(0, i) - flat) ** 2).sum()

            moved = nbytes(flat, cb, q, idx, counts, sq)
            rows.append(dict(
                name=width_label("vq_fused_fwd", (d, k)), route="cuda",
                source="msla_tpu_torch/csrc/vq_fused.cu", replaces="msla_tpu/ops/vq_fused.py:42",
                widths=[d, k], max_abs_err=gap, index_mismatches=mismatches, max_tie_gap=rel,
                sq_rel_err=sq_rel, **planted["vq_fused_fwd"],
                ragged_n_mismatches=ragged["vq_fused_fwd"],
                ms=time_ms(lambda: vq_fused_fwd(flat, cb), SWEEP_REPS, 1),
                plain_ms=time_ms(lambda: vq_fused_fwd_ref(flat, cb), SWEEP_REPS, 1),
                library_ms=time_ms(composite, SWEEP_REPS, 1),
                library_call="composite: matmul + argmin + index_select + bincount + sum",
                flop=flop, bytes=moved, registers=ptxas_of(ptxas, "vq_fused", fused),
                smem_bytes=search_smem(k, d, True), **tf32_bounds(flop, moved)))
            del q, flat

            grad = torch.randn((n, d), generator=g, device=dev)
            fn = lambda x, i: vq_codebook_grad(x, i, k)
            checks = {kind: check_segment_sum(f"vq_codebook_grad[D={d},K={k}] ({kind} ids)",
                                              fn, grad, ids, k, False)
                      for kind, ids in (("model", idx), ("uniform", segment_ids(
                          "uniform", n, k, g)))}
            ids_long = idx.long()
            zeros = torch.zeros((k, d), device=dev)
            rows.append(dict(
                name=width_label("vq_codebook_grad", (d, k)), route="cuda",
                source="msla_tpu_torch/csrc/segment_sum.cuh",
                replaces="msla_tpu/ops/vq_fused.py:81", widths=[d, k],
                max_abs_err=checks["model"]["max_abs_err"],
                fp64_share_of_bound=max(c["fp64_share_of_bound"] for c in checks.values()),
                blocks=checks["model"]["blocks"], column_slices=d // 64,
                ms=time_ms(lambda: fn(grad, idx), SWEEP_REPS, 1),
                plain_ms=time_ms(lambda: vq_codebook_grad_ref(grad, idx, k), SWEEP_REPS, 1),
                library_ms=time_ms(lambda: zeros.index_add_(0, ids_long, grad), SWEEP_REPS, 1),
                library_call="index_add_", flop=n * d, bytes=nbytes(grad, idx) + k * d * 4,
                registers=ptxas_of(ptxas, "vq_fused", "segment_sum_kernel<false>"),
                smem_bytes=grad_smem_bytes(k)))
            del grad, idx
    torch.cuda.empty_cache()
    return rows


def phase_sweep_kernels(dev, ptxas: dict) -> list[dict]:
    g = torch.Generator(device=dev).manual_seed(26)
    with torch.no_grad():
        rows = (sweep_stem_rows(dev, g, ptxas, False) + sweep_stem_rows(dev, g, ptxas, True)
                + sweep_vq_rows(dev, g, ptxas))
    return with_bounds(rows)


#: phase 27: the sweeps through the CLI, on a fixture of their own
SWEEP_ROOT = OUT_DIR / "sweep"
SWEEP_TRACKS = {"train": 4, "validation": 4, "test": 4}  # 260 frames each: a batch of 256
SWEEP_TRIALS = {"optuna": 10, "optuna_smoke": 2}          # hydra.sweeper.n_trials of each
#: the overrides of every trial, none of them swept: one epoch of one train,
#: one validation and one test batch, each trial's checkpoints in its own
#: run directory (its widths are its own, so visualize reads its own model)
SWEEP_ARGS = ["train_vqvae=True", "trainer.max_epochs=1", "+trainer.limit_train_batches=1",
              "+trainer.limit_val_batches=1", "+trainer.limit_test_batches=1",
              "paths.best_checkpoint_dir=${paths.output_dir}/best_checkpoint",
              "extras.print_config=False"]
#: fp32 launches of one trial, by wrapper, at the trial's widths (the
#: prediction, PERF.md §6): a train step (K1b, K2b, #4, #5), one validation
#: and one test batch (K1, #4, K2 each), visualize's 4 instruments (K1, K3);
#: generate skips (no best_bert.ckpt), no logger writes an audio demo
TRIAL_LAUNCHES = {"conv_stem_save_hidden": 1, "deconv_stem_save_hidden": 1, "vq_fused_fwd": 3,
                  "vq_codebook_grad": 1, "conv_stem": 6, "deconv_stem": 2, "nearest_codes": 4}
WIDTH_KERNELS = tuple(TRIAL_LAUNCHES)


def widths_of_trial(vq: dict) -> dict:
    """Each wrapper's widths key at a trial's model config."""
    h, d, k = int(vq["num_hidden"]), int(vq["embedding_dim"]), int(vq["num_embedding"])
    stems = {"conv_stem": (h // 2, h), "conv_stem_save_hidden": (h // 2, h),
             "deconv_stem": (h, h // 2), "deconv_stem_save_hidden": (h, h // 2)}
    return {name: stems.get(name, (d, k)) for name in WIDTH_KERNELS}


def width_counts(kernels) -> collections.Counter:
    """Launches by (wrapper, widths), fp32."""
    out = collections.Counter()
    for k in kernels:
        for (dtype, widths), n in getattr(k, "widths", {}).items():
            if dtype == torch.float32:
                out[k.__name__, widths] += n
    return out


def phase_sweep(kernels, smi: str) -> dict:
    """``python -m msla_tpu_torch -m hparams_search=optuna`` and then
    ``hparams_search=optuna_smoke``, in process, on a 22 kHz fixture of 4
    tracks a split (260 frames each), with SWEEP_ARGS and nothing swept
    overridden: each trial's seconds, peak memory and launches by widths;
    every trial must complete (optimization_results.yaml's n_completed, a
    finite trial_result.json each), and every launch count meet
    TRIAL_LAUNCHES at the trial's widths, trial by trial and summed."""
    import os
    import shutil

    import yaml

    from msla_tpu_torch import main as cli
    from msla_tpu_torch.data.dataset import make_fixture_dataset

    shutil.rmtree(SWEEP_ROOT, ignore_errors=True)
    slakh, project = SWEEP_ROOT / "slakh", SWEEP_ROOT / "project"
    t0 = time.perf_counter()
    for i, (split, n) in enumerate(SWEEP_TRACKS.items()):
        make_fixture_dataset(slakh / split, n_tracks=n, seconds=CLI_TRACK_S, sr=SR, seed=30 + i)
    fixture_s = time.perf_counter() - t0

    trials: list[dict] = []
    saved_run = cli.run

    def run(cfg):  # one trial, timed and counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = width_counts(kernels)
        t = time.perf_counter()
        try:
            return saved_run(cfg)
        finally:
            torch.cuda.synchronize()
            after = width_counts(kernels)
            vq = cfg.model.vqvae
            trials.append(dict(
                params={k: vq[k] for k in ("num_hidden", "embedding_dim", "num_embedding",
                                           "num_residual_layer", "num_residual_hidden")}
                | dict(batch_size=int(cfg.data.batch_size)),
                s=time.perf_counter() - t, peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                launches={f"{name}{list(w)}": after[name, w] - before[name, w]
                          for name, w in after if after[name, w] > before[name, w]}))

    env = {k: os.environ.get(k) for k in ("SLAKH_DIR", "PROJECT_ROOT")}
    os.environ.update(SLAKH_DIR=str(slakh), PROJECT_ROOT=str(project))
    cli.run = run
    sweeps = {}
    try:
        for name, n_trials in SWEEP_TRIALS.items():
            reset_counts(kernels)
            first = len(trials)
            t0 = time.perf_counter()
            best = cli.main(["-m", f"hparams_search={name}", *SWEEP_ARGS])
            sweeps[name] = dict(s=time.perf_counter() - t0, best_value=best,
                                counts=width_counts(kernels), trials=trials[first:])
    finally:
        cli.run = saved_run
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    result = dict(fixture_write_s=fixture_s, sweeps={})
    dirs = sorted((project / "logs" / "train" / "multiruns").glob("*"))
    if len(dirs) != len(SWEEP_TRIALS):
        fail(f"sweep: multirun directories {dirs}")
    for (name, n_trials), sweep_dir in zip(SWEEP_TRIALS.items(), dirs):
        sweep = sweeps[name]
        res = yaml.safe_load((sweep_dir / "optimization_results.yaml").read_text())
        if res["n_completed"] != n_trials or len(sweep["trials"]) != n_trials:
            fail(f"sweep {name}: {res['n_completed']} of {n_trials} trials completed")
        values = []
        for i in range(n_trials):
            rec = json.loads((sweep_dir / str(i) / "trial_result.json").read_text())
            if rec["trial"] != i or not np.isfinite(rec["value"]):
                fail(f"sweep {name}: trial {i}'s result {rec}")
            values.append(rec["value"])
        want = collections.Counter()
        for i, trial in enumerate(sweep["trials"]):
            expect = collections.Counter()
            for wrapper, widths in widths_of_trial(trial["params"]).items():
                expect[wrapper, widths] += TRIAL_LAUNCHES[wrapper]
            got = {f"{k}{list(w)}": n for (k, w), n in expect.items()}
            if trial["launches"] != got:
                fail(f"sweep {name} trial {i}: launches {trial['launches']}, predicted {got}")
            want += expect
        if sweep["counts"] != want:
            fail(f"sweep {name}: launches {dict(sweep['counts'])}, predicted {dict(want)}")
        for i, trial in enumerate(sweep["trials"]):
            print(f"[sweep] {smi}: {name} trial {i} {trial['params']}: {trial['s']:.3f} s, "
                  f"peak {trial['peak_gb']:.3f} GiB, value {values[i]:.5f}", flush=True)
        result["sweeps"][name] = dict(
            s=sweep["s"], best_value=sweep["best_value"], values=values,
            trials=sweep["trials"],
            params=[json.loads((sweep_dir / str(i) / "trial_result.json").read_text())["params"]
                    for i in range(n_trials)],
            launches={width_label(k, w): n for (k, w), n in sorted(sweep["counts"].items())})
        print(f"[sweep] {smi}: {name} {n_trials} trials completed in {sweep['s']:.3f} s, best "
              f"{res['best_value']:.5f} (trial {res['best_trial']}); launches by instantiation "
              f"as predicted: {result['sweeps'][name]['launches']}", flush=True)
    shutil.rmtree(project, ignore_errors=True)   # the fixture stays for phase 30
    return result


#: phase 28: the fit of phase 8 (6 train and 2 validation batches of 64, no
#: logger): K1b, K2b and #5 once a train step, #4 once a train and a
#: validation batch, whatever the process group
DP_LAUNCHES = {"conv_stem_save_hidden": TRAIN_BATCHES, "deconv_stem_save_hidden": TRAIN_BATCHES,
               "vq_fused_fwd": TRAIN_BATCHES + VAL_BATCHES, "vq_codebook_grad": TRAIN_BATCHES}
DP_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "MSLA_PLATFORM")
DP_ROUNDS = 2                         # turns of the step with and without the all-reduce
DP_CLI_TIMEOUT_S = 300
QUEUE_SPIN_CYCLES = 20_000_000        # ~10 ms of the card's clock: time to enqueue a call


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def queued_ms(fn, reps: int = 20, spin: int = QUEUE_SPIN_CYCLES) -> float:
    """Median device ms of fn() with its launches queued behind a spin
    kernel of ``spin`` cycles: the host enqueues them while the card spins,
    so the events time the kernels back to back and not the host's launches
    (fn must not wait for the device, and must enqueue within the spin)."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def dp_fit(dm, kernels, dp: bool):
    """Phase 8's fit from phase 8's starting weights, with cuDNN deterministic
    (its convs' backward then gives the same bits run after run); under the
    process group when ``dp``. Returns the task, the Trainer, its seconds and
    launches."""
    from msla_tpu_torch.models.vqvae import VQVAETask
    from msla_tpu_torch.train.trainer import Trainer

    out = OUT_DIR / ("dp" if dp else "dp_reference")
    task = VQVAETask(**MODEL, checkpoint_dir=str(out), codebook_file=str(out / "codebook.csv"),
                     device="cuda", seed=0)
    task.net.load_state_dict(PHASE8_FIT["start"])
    trainer = Trainer(max_epochs=1, limit_train_batches=TRAIN_BATCHES,
                      limit_val_batches=VAL_BATCHES, seed=0, enable_progress_bar=False)
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        trainer.fit(task, dm)
    torch.cuda.synchronize()
    return task, trainer, time.perf_counter() - t0, launch_counts(kernels)


#: phase 28's fit under the group as it ended, which phase 29's sharded fits
#: must give bit for bit
PHASE28_FIT: dict = {}


def dp_in_process(kernels, smi: str, dm, fp32_training: dict) -> dict:
    """(a) NCCL at world size 1 in this process: the fit against the same fit
    without a group, bit for bit; its launches; the all-reduce's cost."""
    import os

    import torch.distributed as dist

    import msla_tpu_torch.train.trainer as trainer_module
    from msla_tpu_torch.parallel import distributed as pdist
    from msla_tpu_torch.parallel import mesh

    ref_task, ref_trainer, ref_s, _ = dp_fit(dm, kernels, dp=False)
    saved = {k: os.environ.get(k) for k in DP_ENV}
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()), WORLD_SIZE="1",
                      RANK="0", LOCAL_RANK="0")
    os.environ.pop("MSLA_PLATFORM", None)
    try:
        if not pdist.setup_distributed():
            fail("data parallel: setup_distributed() did not join a group")
        backend, world = dist.get_backend(), dist.get_world_size()
        if backend != "nccl" or world != 1 or mesh.process_info() != (0, 1):
            fail(f"data parallel: a group of {backend} at world size {world}")
        task, trainer, fit_s, counts = dp_fit(dm, kernels, dp=True)
        wrong = {k: (counts[k], n) for k, n in DP_LAUNCHES.items() if counts[k] != n}
        if wrong:
            fail(f"data parallel: launches (got, predicted) {wrong}; all: {counts}")
        differ = [k for k, v in task.net.state_dict().items()
                  if not torch.equal(v, ref_task.net.state_dict()[k])]
        if differ:
            fail(f"data parallel: parameters not bit-equal to the fit without a group: {differ}")
        cm, ref_cm = trainer.callback_metrics, ref_trainer.callback_metrics
        PHASE28_FIT.update(callback_metrics=dict(cm), state={
            k: v.detach().cpu().clone() for k, v in task.net.state_dict().items()})
        metric_rel = max(abs(cm[k] - v) / max(abs(v), 1e-30) for k, v in ref_cm.items())
        if set(cm) != set(ref_cm) or metric_rel > 1e-6:
            fail(f"data parallel: metrics {cm} against {ref_cm}")
        phase8_diff = max((v - PHASE8_FIT["state"][k]).abs().max().item()
                          for k, v in ref_task.net.state_dict().items())

        raw = torch.from_numpy(dm.train_dataloader()[0]).to("cuda")
        grads = [p.grad for p in task.net.parameters() if p.grad is not None]
        grad_bytes = nbytes(*grads)
        step = lambda: trainer._train_step(task, dm, [raw])  # noqa: E731
        with_ms, without_ms = [], []
        for _ in range(DP_ROUNDS):
            with_ms.append(time_ms(step, reps=10, warmup=2))
            trainer_module.mean_gradients = lambda params: None
            try:
                without_ms.append(time_ms(step, reps=10, warmup=2))
            finally:
                trainer_module.mean_gradients = mesh.mean_gradients
        reduce_ms = time_ms(lambda: mesh.mean_gradients(task.net.parameters()))
        reduce_queued = queued_ms(lambda: mesh.mean_gradients(task.net.parameters()))
        flat = torch.cat([g.reshape(-1) for g in grads])
        nccl_ms = time_ms(lambda: dist.all_reduce(flat))
        pdist.teardown_distributed()
        if mesh.group_up():
            fail("data parallel: the group outlived destroy_process_group()")
    finally:
        pdist.teardown_distributed()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    result = dict(backend=backend, world_size=world, fit_s=fit_s, fit_s_without_group=ref_s,
                  launches=counts, bit_equal=True, metrics_max_rel=metric_rel,
                  params_max_abs_vs_phase8=phase8_diff,
                  step_ms_with_allreduce=statistics.median(with_ms),
                  step_ms_without_allreduce=statistics.median(without_ms),
                  step_ms_rounds=dict(with_allreduce=with_ms, without=without_ms),
                  phase8_step_ms=fp32_training["step_device_ms"], grad_bytes=grad_bytes,
                  grad_tensors=len(grads), mean_gradients_ms=reduce_ms,
                  mean_gradients_queued_ms=reduce_queued, nccl_allreduce_ms=nccl_ms,
                  nccl_bus_gb_per_s=grad_bytes / (nccl_ms / 1e3) / 1e9)
    print(f"[data parallel] {smi}: NCCL, world size 1: fit {fit_s:.3f} s ({ref_s:.3f} s "
          f"without a group), parameters bit-equal; launches {dict((k, counts[k]) for k in DP_LAUNCHES)} "
          f"as predicted; phase 8's own fit (cuDNN not deterministic) within "
          f"{phase8_diff:.3g}", flush=True)
    print(f"[data parallel] {smi}: a batch-64 step {result['step_ms_with_allreduce']:.3f} ms "
          f"with the gradient's all-reduce, {result['step_ms_without_allreduce']:.3f} ms "
          f"without (rounds {with_ms} / {without_ms}; phase 8 "
          f"{fp32_training['step_device_ms']:.3f}); the all-reduce of {grad_bytes} B in "
          f"{len(grads)} tensors: mean_gradients {reduce_ms:.4f} ms between events, "
          f"{reduce_queued:.4f} ms queued behind a spin (the device's own), NCCL's call "
          f"{nccl_ms:.4f} ms", flush=True)
    return result


def dp_launched(smi: str) -> dict:
    """(b) python -m msla_tpu_torch.parallel.launch --nproc 1 -- -m msla_tpu_torch
    train_vqvae=True on phase 22's fixture, in a project of its own."""
    import os

    from msla_tpu_torch.train.checkpoint import load_checkpoint

    repo = Path(__file__).resolve().parent
    project = CLI_ROOT / "dp_project"
    env = {k: v for k, v in os.environ.items() if k not in DP_ENV}
    env.update(SLAKH_DIR=str(CLI_ROOT / "slakh"), PROJECT_ROOT=str(project),
               PYTHONPATH=os.pathsep.join([str(repo), env.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "msla_tpu_torch.parallel.launch", "--nproc", "1", "--",
           "-m", "msla_tpu_torch", "train_vqvae=True", "trainer.max_epochs=1", "logger=csv",
           "extras.print_config=False"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=DP_CLI_TIMEOUT_S,
                          env=env, cwd=repo)
    seconds = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    if proc.returncode != 0:
        fail(f"data parallel: the launched CLI exited {proc.returncode}: "
             f"{chr(10).join(lines[-40:])} {proc.stderr[-2000:]}")
    bare = [line for line in lines if not line.startswith("[rank 0] ")]
    if bare or not lines:
        fail(f"data parallel: {len(bare)} of {len(lines)} output lines without [rank 0]: "
             f"{bare[:5]}")
    if not any("Data parallel: rank 0 of 1, nccl" in line for line in lines):
        fail("data parallel: the launched CLI reported no NCCL group of one rank")
    best = project / "logs" / "best_checkpoint"
    last = load_checkpoint(best / "last.ckpt")
    if int(last["global_step"]) != 2 or not last["state_dict"]:
        fail(f"data parallel: last.ckpt at step {last.get('global_step')}")
    codebook = np.loadtxt(best / "codebook.csv", delimiter=",", skiprows=1)
    if codebook.shape != (MODEL["num_embedding"], MODEL["embedding_dim"]):
        fail(f"data parallel: codebook CSV of shape {codebook.shape}")
    result = dict(s=seconds, lines=len(lines), last_global_step=int(last["global_step"]))
    print(f"[data parallel] {smi}: python -m msla_tpu_torch.parallel.launch --nproc 1 -- -m "
          f"msla_tpu_torch train_vqvae=True: exit 0 in {seconds:.3f} s, {len(lines)} lines all "
          f"[rank 0], last.ckpt at step 2 and the codebook CSV read back", flush=True)
    return result


def phase_data_parallel(kernels, smi: str, dm, fp32_training: dict) -> dict:
    """Data parallelism on one card, world size 1: (a) ``dp_in_process``, (b)
    ``dp_launched``. Phase 22's fixture stays for phase 29."""
    result = dict(in_process=dp_in_process(kernels, smi, dm, fp32_training),
                  launched=dp_launched(smi))
    result["launches"] = result["in_process"]["launches"]
    print(f"[data parallel] {json.dumps(result)}", flush=True)
    return result


MODEL_AXIS_FLAG = "--model-axis"      # chip_smoke.py --model-axis <dir>: phase 29's rank
MODEL_AXIS_TIMEOUT_S = 300


class HeldShapes:
    """A callback (the Trainer's protocol): after each validation, whether the
    Trainer's sharded state runs, and each leaf's layout, held block and
    moments' shapes against its whole shape."""

    def __init__(self):
        self.seen: dict = {}

    stop_training = False

    def on_validation_end(self, trainer, metrics) -> None:
        shards, opt = trainer._shards, trainer._optimizer
        self.seen = dict(active=bool(shards is not None and shards.active), leaves={
            name: dict(spec=list(leaf.spec), opt=list(leaf.opt), whole=list(leaf.shape),
                       held=list(leaf.p.shape),
                       moment=list(opt.state[leaf.p]["exp_avg"].shape)
                       if leaf.p in opt.state else None)
            for name, leaf in (shards.leaves.items() if shards is not None else [])})

    def on_train_end(self, trainer) -> None:
        pass

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, state: dict) -> None:
        pass


def model_axis_rank(out: Path) -> int:
    """Phase 29 (a)'s rank, started by the launcher under NCCL at world size
    1: phase 8's fit with zero1=True, then fsdp=True; the step with and
    without the sharded optimizer; the gathers; model_parallel=2's
    ValueError. Writes ``<out>/result.json`` and each fit's parameters."""
    import torch.distributed as dist

    from msla_tpu_torch.models.vqvae import VQVAETask
    from msla_tpu_torch.ops import KERNELS
    from msla_tpu_torch.parallel.distributed import setup_distributed, teardown_distributed
    from msla_tpu_torch.parallel.mesh import on_grid
    from msla_tpu_torch.train.trainer import Trainer

    marks = {"imported": time.perf_counter() - T_IMPORT}
    if not setup_distributed():
        fail("model axis: setup_distributed() did not join a group")
    marks["group"] = time.perf_counter() - T_IMPORT
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        fail(f"model axis: a group of {dist.get_backend()} at {dist.get_world_size()}")
    start = torch.load(out / "start.pt")
    train, val = synthetic_stems(TRAIN_BATCHES, seed=10), synthetic_stems(VAL_BATCHES, seed=11)
    dm = in_memory_datamodule(train, val)

    def task_of(name: str):
        task = VQVAETask(**MODEL, checkpoint_dir=str(out / name),
                         codebook_file=str(out / name / "codebook.csv"), device="cuda", seed=0)
        task.net.load_state_dict(start)
        return task

    result: dict = {}
    for mode in ("zero1", "fsdp"):
        task, held = task_of(mode), HeldShapes()
        trainer = Trainer(max_epochs=1, limit_train_batches=TRAIN_BATCHES,
                          limit_val_batches=VAL_BATCHES, seed=0, enable_progress_bar=False,
                          callbacks=[held], **{mode: True})
        reset_counts(KERNELS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False):
            trainer.fit(task, dm)
        torch.cuda.synchronize()
        result[mode] = dict(fit_s=time.perf_counter() - t0, launches=launch_counts(KERNELS),
                            callback_metrics=dict(trainer.callback_metrics), **held.seen)
        torch.save({k: v.cpu() for k, v in task.net.state_dict().items()}, out / f"{mode}.pt")
        marks[mode] = time.perf_counter() - T_IMPORT

    raw = torch.from_numpy(train[0]).to("cuda")
    plain_task, sharded_task = task_of("plain"), task_of("sharded")
    plain, sharded = Trainer(seed=0, enable_progress_bar=False), \
        Trainer(seed=0, enable_progress_bar=False, fsdp=True)
    plain._setup(plain_task, dm)
    sharded._setup(sharded_task, dm)
    shards = sharded._shards

    def gather():
        with shards.use():
            pass

    with on_grid(sharded.grid):   # cuDNN as phases 8 and 28 time their steps
        shards.shard()
        with_ms, without_ms = [], []
        for _ in range(DP_ROUNDS):
            with_ms.append(time_ms(lambda: sharded._train_step(sharded_task, dm, [raw]),
                                   reps=10, warmup=2))
            without_ms.append(time_ms(lambda: plain._train_step(plain_task, dm, [raw]),
                                      reps=10, warmup=2))
        queued = dict(sharded=queued_ms(lambda: sharded._train_step(sharded_task, dm, [raw]),
                                        reps=10),
                      plain=queued_ms(lambda: plain._train_step(plain_task, dm, [raw]), reps=10))
        gathered = [leaf for leaf in shards.leaves.values() if any(leaf.spec)]
        gather_bytes = sum(math.prod(leaf.shape) * leaf.p.element_size() for leaf in gathered)
        gather_ms, gather_queued = time_ms(gather), queued_ms(gather)
        shards.unshard()
    marks["timed"] = time.perf_counter() - T_IMPORT
    try:
        Trainer(seed=0, enable_progress_bar=False, model_parallel=2)
        refused = None
    except ValueError as err:
        refused = str(err)
    result.update(step_ms_sharded=statistics.median(with_ms),
                  step_ms_plain=statistics.median(without_ms),
                  step_ms_rounds=dict(sharded=with_ms, plain=without_ms),
                  step_queued_ms=queued,
                  gather_bytes=gather_bytes, gather_tensors=len(gathered), gather_ms=gather_ms,
                  gather_queued_ms=gather_queued, model_parallel_2=refused,
                  seconds_since_import=marks)
    (out / "result.json").write_text(json.dumps(result))
    teardown_distributed()
    print(f"model axis rank done: {sorted(result)}", flush=True)
    return 0


def model_axis_launched(smi: str) -> dict:
    """(a): the rank through python -m msla_tpu_torch.parallel.launch --nproc 1,
    its fits against phase 28's under the group."""
    import os
    import shutil

    repo = Path(__file__).resolve().parent
    out = OUT_DIR / "model_axis"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    torch.save({k: v.detach().cpu() for k, v in PHASE8_FIT["start"].items()}, out / "start.pt")
    env = {k: v for k, v in os.environ.items() if k not in DP_ENV}
    env["PYTHONPATH"] = os.pathsep.join([str(repo), env.get("PYTHONPATH", "")])
    cmd = [sys.executable, "-m", "msla_tpu_torch.parallel.launch", "--nproc", "1", "--",
           str(repo / "chip_smoke.py"), MODEL_AXIS_FLAG, str(out)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=MODEL_AXIS_TIMEOUT_S,
                          env=env, cwd=repo)
    seconds = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    if proc.returncode != 0:
        fail(f"model axis: the launched rank exited {proc.returncode}: "
             f"{chr(10).join(lines[-40:])} {proc.stderr[-3000:]}")
    if any(not line.startswith("[rank 0] ") for line in lines):
        fail(f"model axis: output lines without [rank 0]: {lines[:5]}")
    res = json.loads((out / "result.json").read_text())
    for mode in ("zero1", "fsdp"):
        fit = res[mode]
        state = torch.load(out / f"{mode}.pt")
        differ = [k for k, v in PHASE28_FIT["state"].items() if not torch.equal(state[k], v)]
        if differ:
            fail(f"model axis: {mode}'s parameters not bit-equal to phase 28's: {differ}")
        if fit["callback_metrics"] != PHASE28_FIT["callback_metrics"]:
            fail(f"model axis: {mode}'s metrics {fit['callback_metrics']} against "
                 f"{PHASE28_FIT['callback_metrics']}")
        wrong = {k: (fit["launches"][k], n) for k, n in DP_LAUNCHES.items()
                 if fit["launches"][k] != n}
        if wrong:
            fail(f"model axis: {mode}'s launches (got, predicted) {wrong}")
        leaves = fit["leaves"]
        off = [n for n, leaf in leaves.items()
               if "data" not in (leaf["spec"] if mode == "fsdp" else leaf["opt"])
               or leaf["held"] != leaf["whole"] or leaf["moment"] != leaf["whole"]]
        if not fit["active"] or len(leaves) != len(state) or off:
            fail(f"model axis: {mode} not on the sharded path over a group of one: {off}")
    if not (res["model_parallel_2"] or "").startswith("1 devices not divisible by the "
                                                      "model-axis size 2"):
        fail(f"model axis: Trainer(model_parallel=2) at world size 1: {res['model_parallel_2']}")
    result = dict(s=seconds, **res)
    print(f"[model axis] {smi}: python -m msla_tpu_torch.parallel.launch --nproc 1 -- "
          f"chip_smoke.py {MODEL_AXIS_FLAG}: NCCL at world size 1, zero1 fit "
          f"{res['zero1']['fit_s']:.3f} s, fsdp fit {res['fsdp']['fit_s']:.3f} s, both "
          f"bit-equal to phase 28's fit under the group, launches "
          f"{dict((k, res['fsdp']['launches'][k]) for k in DP_LAUNCHES)} as predicted; "
          f"model_parallel=2 refused: {res['model_parallel_2']}", flush=True)
    print(f"[model axis] {smi}: a batch-64 step {res['step_ms_sharded']:.3f} ms with the "
          f"sharded optimizer (fsdp), {res['step_ms_plain']:.3f} ms without (rounds "
          f"{res['step_ms_rounds']}; queued behind a spin, which hides the host's head start "
          f"of each timed step, {res['step_queued_ms']}); the gathers of "
          f"{res['gather_bytes']} B in {res['gather_tensors']} tensors {res['gather_ms']:.4f} ms between events, "
          f"{res['gather_queued_ms']:.4f} ms queued behind a spin; the rank's command "
          f"{seconds:.3f} s (its seconds since chip_smoke.py's imports: "
          f"{res['seconds_since_import']})", flush=True)
    return result


def model_axis_cli(smi: str) -> dict:
    """(b): python -m msla_tpu_torch.parallel.launch --nproc 1 -- -m msla_tpu_torch
    train_vqvae=True trainer.fsdp=True on phase 22's fixture."""
    import os

    from msla_tpu_torch.train.checkpoint import load_checkpoint

    repo = Path(__file__).resolve().parent
    project = CLI_ROOT / "model_axis_project"
    env = {k: v for k, v in os.environ.items() if k not in DP_ENV}
    env.update(SLAKH_DIR=str(CLI_ROOT / "slakh"), PROJECT_ROOT=str(project),
               PYTHONPATH=os.pathsep.join([str(repo), env.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "msla_tpu_torch.parallel.launch", "--nproc", "1", "--",
           "-m", "msla_tpu_torch", "train_vqvae=True", "trainer.max_epochs=1", "logger=csv",
           "trainer.fsdp=True", "extras.print_config=False", "+visualize=False",
           "+generate=False"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=DP_CLI_TIMEOUT_S,
                          env=env, cwd=repo)
    seconds = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    if proc.returncode != 0:
        fail(f"model axis: the launched CLI exited {proc.returncode}: "
             f"{chr(10).join(lines[-40:])} {proc.stderr[-2000:]}")
    if any(not line.startswith("[rank 0] ") for line in lines) or not lines:
        fail(f"model axis: CLI output lines without [rank 0]: {lines[:5]}")
    last = load_checkpoint(project / "logs" / "best_checkpoint" / "last.ckpt")
    shapes = {k: tuple(v.shape) for k, v in PHASE8_FIT["start"].items()}
    if int(last["global_step"]) != 2 or {k: tuple(v.shape) for k, v in
                                          last["state_dict"].items()} != shapes:
        fail(f"model axis: the CLI's last.ckpt at step {last.get('global_step')} or not whole")
    moments = [tuple(e["exp_avg"].shape) for e in last["opt_state"]["state"].values()]
    if sorted(moments) != sorted(shapes.values()):
        fail("model axis: the CLI's last.ckpt holds moments that are not whole")
    print(f"[model axis] {smi}: python -m msla_tpu_torch.parallel.launch --nproc 1 -- -m "
          f"msla_tpu_torch train_vqvae=True trainer.fsdp=True: exit 0 in {seconds:.3f} s, "
          f"{len(lines)} lines all [rank 0], last.ckpt whole at step 2", flush=True)
    return dict(s=seconds, lines=len(lines))


def phase_model_axis(smi: str) -> dict:
    """The model axis on one card, world size 1: (a) ``model_axis_launched``,
    (b) ``model_axis_cli``; then phase 22's fixture is removed."""
    import shutil

    try:
        result = dict(launched=model_axis_launched(smi), cli=model_axis_cli(smi))
    finally:
        shutil.rmtree(CLI_ROOT, ignore_errors=True)
    result["launches"] = result["launched"]["fsdp"]["launches"]
    print(f"[model axis] {json.dumps(result)}", flush=True)
    return result


PIPELINE_FLAG = "--pipeline"          # chip_smoke.py --pipeline <dir>: phase 30's rank
PIPELINE_TIMEOUT_S = 400
PIPELINE_MICRO = (1, 2, 4)            # n_micro of the pipelined batch-16 BERT call
PIPELINE_STEP_MICRO = (2, 4)          # n_micro of the pipelined transformer step
PIPELINE_REPS = 3                     # timed runs a figure (the median), after one warm-up
PIPELINE_KERNELS = ("flash_attn", "mlm_argmax")   # fp32: the pipelined BERT group's kernels
PIPELINE_SPIN_CYCLES = 400_000_000    # ~200 ms of the card's clock: a step's host enqueue


def fp32_counts(names=PIPELINE_KERNELS) -> dict:
    from msla_tpu_torch.ops import KERNELS

    return {k: n for k, n in launch_counts(KERNELS, {name: torch.float32 for name in names}
                                           ).items() if n}


def pipelined_bert_call(task, grid, tok, am, emb, bias) -> dict:
    """(a) the batch-16 call's one group (352 sequences) through
    pipelined_bert_apply at each n_micro against the unpipelined BERT call:
    #6's ids equal or near-ties, #7 launched 12 x n_micro times and #6 once,
    the hidden states' largest difference, each forward's ms."""
    from msla_tpu_torch.ops import KERNELS, mlm_argmax
    from msla_tpu_torch.parallel.pipeline import pipelined_bert_apply

    def plain():
        return task.bert(tok, am, return_mlm_hidden=True)

    def piped(nm):
        return pipelined_bert_apply(task.bert, tok, grid, n_micro=nm, attention_mask=am,
                                    return_mlm_hidden=True)

    hidden = emb.shape[1]
    with torch.inference_mode():
        plain_h = plain()
        plain_ids = mlm_argmax(plain_h, emb, bias)
        reset_counts(KERNELS)
        runs = {}
        for nm in PIPELINE_MICRO:
            before = fp32_counts()
            h = piped(nm)
            ids = mlm_argmax(h, emb, bias)
            torch.cuda.synchronize()
            after = fp32_counts()
            got = {k: after.get(k, 0) - before.get(k, 0) for k in PIPELINE_KERNELS}
            want = {"flash_attn": 12 * nm, "mlm_argmax": 1}
            if got != want:
                fail(f"pipeline: n_micro {nm}: launches {got}, want {want}")
            flips, gap = mlm_near_ties(plain_h.reshape(-1, hidden), emb, bias,
                                       plain_ids.reshape(-1), ids.reshape(-1))
            runs[nm] = dict(launches=got, hidden_max_abs=(h - plain_h).abs().max().item(),
                            ids_differing=flips, largest_relative_gap=gap)
        launches = fp32_counts()
        for nm in PIPELINE_MICRO:
            runs[nm]["ms"] = time_ms(lambda nm=nm: piped(nm), reps=PIPELINE_REPS, warmup=1)
        plain_ms = time_ms(plain, reps=PIPELINE_REPS, warmup=1)
    return dict(runs=runs, plain_ms=plain_ms, launches=launches)


def pipelined_audio_bert_loss(task, grid, ids, instruments) -> dict:
    """(b) AudioBertTask.pipeline_loss_fn (n_micro 2) against loss_fn on the
    batch-16 ids and one [MASK] draw: equal vocab ids give the same loss and
    head gradient bit for bit; ids that differ must be near-ties."""
    from msla_tpu_torch.models.bert import mask_tokens
    from msla_tpu_torch.parallel.mesh import data_axis, on_grid

    def draw():
        return torch.Generator(device="cuda").manual_seed(7)

    def loss_and_grads(fn):
        task.net.zero_grad(set_to_none=True)
        loss, _ = fn(draw())
        loss.backward()
        return loss.detach(), {n: p.grad.clone() for n, p in task.net.head.named_parameters()}

    batch = (ids, instruments)
    with on_grid(grid), data_axis():
        loss, grads = loss_and_grads(lambda g: task.loss_fn(batch, g))
        pp_loss, pp_grads = loss_and_grads(lambda g: task.pipeline_loss_fn(batch, g, grid, 2))
        with torch.no_grad():
            x = mask_tokens(ids, torch.rand(ids.shape, generator=draw(), device="cuda"),
                            task.mask_prob, task.config.mask_token_id)
            vocab = task._chunked_argmax(x, with_conf=False)
            pp_vocab = task._chunked_argmax(x, with_conf=False, pipeline=(grid, 2))
    differing = int((vocab != pp_vocab).sum())
    grad_diff = max((pp_grads[n] - g).abs().max().item() for n, g in grads.items())
    if differing == 0 and (not torch.equal(loss, pp_loss) or grad_diff != 0.0):
        fail(f"pipeline: pipeline_loss_fn {pp_loss.item()} against loss_fn {loss.item()} on "
             f"equal ids, head gradients apart by {grad_diff}")
    if differing:   # only near-ties may part
        tokens, attn, _ = task._fold(x)
        emb, bias = task._decoder_weights()
        with torch.no_grad():
            h = torch.cat([task.bert(t, a, return_mlm_hidden=True) for t, a in zip(tokens, attn)])
        order = task._fold(vocab)[0].reshape(-1), task._fold(pp_vocab)[0].reshape(-1)
        mlm_near_ties(h.reshape(-1, emb.shape[1]), emb, bias, *order)
    return dict(loss=loss.item(), pipeline_loss=pp_loss.item(), ids_differing=differing,
                head_grad_max_abs=grad_diff, bit_equal=differing == 0)


def pipelined_transformer_step(out: Path) -> dict:
    """(c) one batch-64 step (forward and backward) of transformer.yaml's net
    (seed 0, dropout 0) through pipeline_loss_fn at each n_micro against
    loss_fn: the loss and every gradient within 1e-5 of the plain step's
    (relative; a gradient relative to its tensor's largest, the attention's
    key biases left out: their gradient is 0 in exact arithmetic), each
    step's ms between CUDA events and queued behind a spin (the device's
    own), and the peak memory of each."""
    from msla_tpu_torch.models.transformer import TransformerTask

    task = TransformerTask(**TRANSFORMER, dropout=0.0, checkpoint_dir=str(out / "transformer"),
                           device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(31)
    batch = (torch.randn((BATCH, MODEL["embedding_dim"], FRAME // 4), generator=g,
                         device="cuda"),
             0.3 * torch.randn((BATCH, 4, FRAME), generator=g, device="cuda"))

    def step(nm=None):
        task.net.zero_grad(set_to_none=True)
        loss = (task.loss_fn(batch, None) if nm is None else
                task.pipeline_loss_fn(batch, None, None, nm))[0]
        loss.backward()
        return loss

    def peak_gb(nm=None) -> float:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(nm)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() / 1e9

    loss = step().item()
    grads = {n: p.grad.clone() for n, p in task.net.named_parameters()}
    result = dict(loss=loss, plain_ms=time_ms(step, reps=PIPELINE_REPS, warmup=1),
                  plain_queued_ms=queued_ms(step, reps=PIPELINE_REPS, spin=PIPELINE_SPIN_CYCLES),
                  plain_peak_gb=peak_gb())
    for nm in PIPELINE_STEP_MICRO:
        pp_loss = step(nm).item()
        worst = max(((p.grad - grads[n]).abs().max() / grads[n].abs().max()).item()
                    for n, p in task.net.named_parameters() if not n.endswith("k_proj.bias"))
        rel = abs(pp_loss - loss) / abs(loss)
        if rel > 1e-5 or worst > 1e-5:
            fail(f"pipeline: the transformer step at n_micro {nm}: loss {pp_loss} against "
                 f"{loss} (relative {rel:.3g}), gradients apart by {worst:.3g} of their largest")
        result[nm] = dict(loss=pp_loss, loss_rel=rel, grad_rel=worst,
                          ms=time_ms(lambda nm=nm: step(nm), reps=PIPELINE_REPS, warmup=1),
                          queued_ms=queued_ms(lambda nm=nm: step(nm), reps=PIPELINE_REPS,
                                              spin=PIPELINE_SPIN_CYCLES),
                          peak_gb=peak_gb(nm))
    del task, grads
    torch.cuda.empty_cache()
    return result


def pipeline_rank(out: Path) -> int:
    """Phase 30's rank, started by the launcher under NCCL at world size 1
    (one stage, the schedule without sends): (a) pipelined_bert_call, (b)
    pipelined_audio_bert_loss, (c) pipelined_transformer_step. Writes
    ``<out>/result.json``."""
    import torch.distributed as dist

    from msla_tpu_torch.models.bert import AudioBertTask
    from msla_tpu_torch.parallel.distributed import setup_distributed, teardown_distributed
    from msla_tpu_torch.parallel.mesh import make_grid

    if not setup_distributed():
        fail("pipeline: setup_distributed() did not join a group")
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        fail(f"pipeline: a group of {dist.get_backend()} at {dist.get_world_size()}")
    free, total = torch.cuda.mem_get_info()   # what the parent process leaves the rank
    grid = make_grid(1)
    task = AudioBertTask(**bert_task_args(), device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(30)
    ids = torch.randint(0, MODEL["num_embedding"], (BERT_BATCH, FRAME // 4), generator=g,
                        device="cuda")
    tokens, attn, _ = task._fold(ids)
    if tokens.shape[:2] != (1, BERT_SEQS):
        fail(f"pipeline: the batch-16 call folds into {tuple(tokens.shape[:2])}")
    emb, bias = task._decoder_weights()
    result = dict(bert=pipelined_bert_call(task, grid, tokens[0], attn[0], emb, bias))
    instruments = 0.3 * torch.randn((BERT_BATCH, 4, FRAME), generator=g, device="cuda")
    result["audio_bert_loss"] = pipelined_audio_bert_loss(task, grid, ids, instruments)
    del task
    torch.cuda.empty_cache()
    result["transformer"] = pipelined_transformer_step(out)
    result["card_free_gb_at_start"], result["card_total_gb"] = free / 1e9, total / 1e9
    (out / "result.json").write_text(json.dumps(result))
    teardown_distributed()
    print(f"pipeline rank done: {sorted(result)}", flush=True)
    return 0


def pipeline_launched(smi: str) -> dict:
    """(a)-(c): the rank through python -m msla_tpu_torch.parallel.launch --nproc 1."""
    import os
    import shutil

    repo = Path(__file__).resolve().parent
    out = OUT_DIR / "pipeline"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = {k: v for k, v in os.environ.items() if k not in DP_ENV}
    env["PYTHONPATH"] = os.pathsep.join([str(repo), env.get("PYTHONPATH", "")])
    cmd = [sys.executable, "-m", "msla_tpu_torch.parallel.launch", "--nproc", "1", "--",
           str(repo / "chip_smoke.py"), PIPELINE_FLAG, str(out)]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=PIPELINE_TIMEOUT_S,
                          env=env, cwd=repo)
    seconds = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    if proc.returncode != 0:
        fail(f"pipeline: the launched rank exited {proc.returncode}: "
             f"{chr(10).join(lines[-40:])} {proc.stderr[-3000:]}")
    if any(not line.startswith("[rank 0] ") for line in lines):
        fail(f"pipeline: output lines without [rank 0]: {lines[:5]}")
    res = json.loads((out / "result.json").read_text())
    bert, loss, step = res["bert"], res["audio_bert_loss"], res["transformer"]
    for nm, run in bert["runs"].items():
        print(f"[pipeline] {smi}: pipelined_bert_apply, batch 16 (352 sequences), n_micro {nm}: "
              f"{run['ms']:.3f} ms (unpipelined {bert['plain_ms']:.3f}), launches {run['launches']}, "
              f"hidden within {run['hidden_max_abs']:.3g}, {run['ids_differing']} of "
              f"{BERT_ROWS} ids apart (near-ties, largest gap {run['largest_relative_gap']:.3g})",
              flush=True)
    print(f"[pipeline] {smi}: AudioBertTask.pipeline_loss_fn {loss['pipeline_loss']!r} against "
          f"loss_fn {loss['loss']!r}, {loss['ids_differing']} vocab ids apart, head gradients "
          f"apart by {loss['head_grad_max_abs']}", flush=True)
    for nm in PIPELINE_STEP_MICRO:
        r = step[str(nm)]
        print(f"[pipeline] {smi}: transformer batch-64 step at n_micro {nm}: {r['ms']:.3f} ms "
              f"between events, {r['queued_ms']:.3f} queued behind a spin, peak "
              f"{r['peak_gb']:.3f} GB (loss_fn's {step['plain_ms']:.3f} / "
              f"{step['plain_queued_ms']:.3f} ms, {step['plain_peak_gb']:.3f} GB), loss within "
              f"{r['loss_rel']:.3g}, gradients within {r['grad_rel']:.3g} of their largest; the "
              f"card had {res['card_free_gb_at_start']:.1f} of {res['card_total_gb']:.1f} GB "
              "free at the rank's start", flush=True)
    return dict(s=seconds, **res)


def pipeline_sweep(smi: str, smoke: dict) -> dict:
    """(d) python -m msla_tpu_torch.parallel.launch --nproc 1 -- -m msla_tpu_torch -m
    hparams_search=optuna_smoke on phase 27's fixture: both trials complete
    with phase 27's sampled overrides; then the fixture is removed."""
    import os
    import shutil

    import yaml

    repo = Path(__file__).resolve().parent
    project = SWEEP_ROOT / "launched"
    env = {k: v for k, v in os.environ.items() if k not in DP_ENV}
    env.update(SLAKH_DIR=str(SWEEP_ROOT / "slakh"), PROJECT_ROOT=str(project),
               PYTHONPATH=os.pathsep.join([str(repo), env.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "msla_tpu_torch.parallel.launch", "--nproc", "1", "--",
           "-m", "msla_tpu_torch", "-m", "hparams_search=optuna_smoke", *SWEEP_ARGS,
           "+visualize=False", "+generate=False"]   # phase 27 ran them at these widths
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=DP_CLI_TIMEOUT_S,
                              env=env, cwd=repo)
        seconds = time.perf_counter() - t0
        lines = proc.stdout.splitlines()
        if proc.returncode != 0:
            fail(f"pipeline: the launched sweep exited {proc.returncode}: "
                 f"{chr(10).join(lines[-40:])} {proc.stderr[-2000:]}")
        sweep_dir, = (project / "logs" / "train" / "multiruns").iterdir()
        res = yaml.safe_load((sweep_dir / "optimization_results.yaml").read_text())
        trials = [json.loads((sweep_dir / str(i) / "trial_result.json").read_text())
                  for i in range(SWEEP_TRIALS["optuna_smoke"])]
    finally:
        shutil.rmtree(SWEEP_ROOT, ignore_errors=True)
    params = [t["params"] for t in trials]
    if res["n_completed"] != len(trials) or params != smoke["params"]:
        fail(f"pipeline: the launched sweep's trials {params} ({res['n_completed']} completed) "
             f"against phase 27's {smoke['params']}")
    values = [t["value"] for t in trials]
    print(f"[pipeline] {smi}: python -m msla_tpu_torch.parallel.launch --nproc 1 -- -m "
          f"msla_tpu_torch -m hparams_search=optuna_smoke: exit 0 in {seconds:.3f} s, trials "
          f"{params} as phase 27's, values {values} (phase 27's {smoke['values']})", flush=True)
    return dict(s=seconds, params=params, values=values, phase27_values=smoke["values"])


def phase_pipeline(smi: str, sweep: dict) -> dict:
    """Pipeline parallelism at one stage (a model axis of 1 under NCCL at world
    size 1; pp >= 2 is the CPU tests'): (a)-(c) ``pipeline_launched``, (d)
    ``pipeline_sweep``."""
    result = dict(launched=pipeline_launched(smi),
                  sweep=pipeline_sweep(smi, sweep["sweeps"]["optuna_smoke"]))
    result["launches"] = result["launched"]["bert"]["launches"]
    print(f"[pipeline] {json.dumps(result)}", flush=True)
    return result


PERCEPTUAL_LOSS_RTOL = 1e-5   # (a) the loss against fp64, relative
PERCEPTUAL_GRAD_TOL = 2e-4    # (a) dL/dx against fp64 on the same linear piece, of its largest
PERCEPTUAL_SCOPE_TOL = 1e-5   # (b) dL/dx against the same forward's fp32-scoped backward
PERCEPTUAL_REPS = 10
PERCEPTUAL_HOST_REPS = 5


def vgg_flop(h: int, w: int) -> int:
    """FLOP of one (3, h, w) image through VGG16's convs; the input adjoint of
    each conv (3×3, stride 1, padding 1) costs the same."""
    from msla_tpu_torch.nn.vgg import VGG16_PLAN

    flop, cin = 0, 3
    for spec in VGG16_PLAN:
        if spec == "M":
            h, w = h // 2, w // 2
            continue
        flop += 2 * 9 * cin * spec * h * w
        cin = spec
    return flop


def cudnn_tf32(on: bool):
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=on)


def mel_images(wave: torch.Tensor) -> torch.Tensor:
    """(..., T) waveforms → (N, 3, 64, frames): PerceptualLoss's images."""
    from msla_tpu_torch.ops.stft import mel_spectrogram

    mel = mel_spectrogram(wave, SR, n_fft=400, hop_length=160, n_mels=64)
    return mel.unsqueeze(-3).expand(*mel.shape[:-2], 3, *mel.shape[-2:]).reshape(
        -1, 3, *mel.shape[-2:])


def vgg_plain(img: torch.Tensor, params, pieces: tuple | None = None):
    """VGG16's features with plain F.conv2d and torch's autograd. Without
    ``pieces``: (features, masks, argmaxes), each ReLU's mask and each pool's
    argmax, which fix the linear piece of the stack that ``img`` lies in.
    With ``pieces`` = (masks, argmaxes): the features of that piece's linear
    map, each conv's output times its mask and each pool a gather at its
    argmax, whatever ``img``'s own masks would be."""
    import torch.nn.functional as F

    from msla_tpu_torch.nn.vgg import VGG16_PLAN

    ps = iter(params)
    masks, argmaxes = ([], []) if pieces is None else (iter(pieces[0]), iter(pieces[1]))
    h = img
    for spec in VGG16_PLAN:
        if spec == "M":
            if pieces is None:
                h, argmax = F.max_pool2d(h, 2, 2, return_indices=True)
                argmaxes.append(argmax)
            else:
                argmax = next(argmaxes).to(h.device)
                h = h.flatten(2).gather(2, argmax.flatten(2)).view(argmax.shape)
            continue
        h = F.conv2d(h, next(ps), next(ps), padding=1)
        if pieces is None:
            h = torch.relu(h)
            masks.append(h > 0)
        else:
            h = h * next(masks).to(h.device)
    return h if pieces is not None else (h, masks, argmaxes)


def plain_perceptual(pl, x, target, fwd_tf32: bool, bwd_tf32: bool):
    """(loss, dL/dx) of the perceptual loss with plain F.conv2d and torch's
    autograd, the forward and the backward each under cuDNN's TF32 or not:
    the planted gaps of (a) (both TF32) and (b) (the backward alone)."""
    params = list(pl.net.parameters())
    x = x.detach().requires_grad_(True)
    with cudnn_tf32(fwd_tf32):
        loss = torch.mean((vgg_plain(mel_images(x), params)[0]
                           - vgg_plain(mel_images(target), params)[0]) ** 2)
    with cudnn_tf32(bwd_tf32):
        loss.backward()
    return loss.detach(), x.grad


def fp64_on_pieces(pl, x, target):
    """(loss, dL/dx) in fp64 on the CPU on the linear pieces that the card's
    fp32 forward lies in (its masks and argmaxes): what fp32 arithmetic alone
    is held to. A pre-activation or a pool's pair within fp32's rounding of a
    tie can take another piece in fp64, and the gradient, piecewise constant
    in the masks, then jumps (on the CPU at 22 kHz one argmax of ~10^6 moved
    dL/dx by 3 % of its largest). Also (masks, argmaxes) flipped against the
    fp64 forward's own."""
    from msla_tpu_torch.ops.conv_adjoints import fp32_convs

    params = list(pl.net.parameters())
    p64 = [p.detach().cpu().double() for p in params]
    x64 = x.detach().cpu().double().requires_grad_(True)
    t64 = target.detach().cpu().double()
    with fp32_convs(), torch.no_grad():
        pieces = [vgg_plain(mel_images(w), params)[1:] for w in (x, target)]
    with torch.no_grad():
        own = vgg_plain(mel_images(x64), p64)[1:]
    flips = tuple(sum(int((a.cpu() != b).sum()) for a, b in zip(mine, theirs))
                  for mine, theirs in zip(pieces[0], own))
    loss = torch.mean((vgg_plain(mel_images(x64), p64, pieces[0])
                       - vgg_plain(mel_images(t64), p64, pieces[1])) ** 2)
    loss.backward()
    return loss.detach(), x64.grad, flips


def perceptual_grads(pl, x, target, scoped: bool):
    """(loss, dL/dx) through the port, backward() called inside fp32_convs()
    or outside any scope."""
    from msla_tpu_torch.ops.conv_adjoints import fp32_convs

    x = x.detach().requires_grad_(True)
    loss = pl(x, target)
    if scoped:
        with fp32_convs():
            loss.backward()
    else:
        loss.backward()
    return loss.detach(), x.grad


def against(name: str, loss, grad, ref_loss, ref_grad) -> dict:
    loss_rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    g, ref = grad.double().cpu(), ref_grad.double().cpu()
    grad_rel = ((g - ref).abs().max() / ref.abs().max()).item()
    if not (math.isfinite(loss.item()) and torch.isfinite(g).all()):
        fail(f"perceptual: {name}: a non-finite loss or gradient")
    return dict(loss=loss.item(), loss_rel=loss_rel, grad_rel=grad_rel,
                grad_rel_l2=((g - ref).norm() / ref.norm()).item())


def phase_perceptual(task, raw: np.ndarray, kernels, smi: str) -> dict:
    """PerceptualLoss (seed 0) at the config's data: x the trained VQ-VAE's
    separated stems of phase 8's first batch (SourceSeparator.separate at
    batch 64), the target that batch's stems, (64, 4, 44,000) each at 22 kHz.
    (a) one sample's 4 stems: the card's loss against the port's CPU path in
    fp64 (within PERCEPTUAL_LOSS_RTOL) and its dL/dx against fp64 on the
    same linear pieces (fp64_on_pieces, within PERCEPTUAL_GRAD_TOL of its
    largest; the distance from the fp64 path's own and the pieces that
    differ printed), and plain F.conv2d in TF32, forward and backward,
    outside them; (b) with cudnn.allow_tf32 = True set globally, backward()
    outside any scope: within (a)'s tolerance, and within
    PERCEPTUAL_SCOPE_TOL of the backward run inside fp32_convs() on the same
    forward, as plain F.conv2d's fp32 backward is and a TF32 backward alone
    (plain F.conv2d, the forward in fp32) is not; (c) loss(x, x) == 0, no
    weight with a .grad, no launch of the port's kernels; (d) forward and
    forward + backward ms (median of PERCEPTUAL_REPS, CUDA events), the peak
    memory, the FLOP and bound, the cuDNN share of a trace's kernels, the
    host's share and the mel filterbank's host build and copy, and forward +
    backward's ms and peak with cudnn.benchmark = True (the autotuner's
    algorithms in place of the heuristics')."""
    from msla_tpu_torch.inference import SourceSeparator

    sep = SourceSeparator(task, frame_samples=FRAME, batch_size=BATCH)
    stems = sep.separate(raw.sum(axis=1).reshape(-1))             # (4, 64 x 44,000)
    x = torch.from_numpy(np.ascontiguousarray(
        stems.reshape(4, BATCH, FRAME).transpose(1, 0, 2))).cuda()
    return perceptual_checks(x, torch.from_numpy(raw).cuda(), kernels, smi)


def perceptual_checks(x: torch.Tensor, target: torch.Tensor, kernels, smi: str) -> dict:
    """Phase 31's (a)-(d) on the card's (B, 4, T) waveforms x and target."""
    from msla_tpu_torch.nn import PerceptualLoss
    from msla_tpu_torch.ops.stft import mel_filterbank

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = launch_counts(kernels)

    pl = PerceptualLoss(SR, generator=torch.Generator().manual_seed(0))
    cpu = PerceptualLoss(SR, state_dict={k: v.cpu() for k, v in pl.net.state_dict().items()},
                         device="cpu")
    cpu.net.double()
    x1, t1 = x[:1], target[:1]
    fp64 = perceptual_grads(cpu, x1.cpu().double(), t1.cpu().double(), scoped=False)
    *piece, flips = fp64_on_pieces(pl, x1, t1)

    def held(name: str, loss, grad) -> dict:
        """Against fp64: the loss against the fp64 path's, dL/dx against
        fp64 on the card's pieces (and, printed, against the fp64 path's)."""
        on_pieces = against(name, loss, grad, *piece)
        own = against(name, loss, grad, *fp64)
        return dict(loss=loss.item(), loss_rel=own["loss_rel"], grad_rel=on_pieces["grad_rel"],
                    grad_rel_l2=on_pieces["grad_rel_l2"], grad_rel_fp64_path=own["grad_rel"])

    def within(r: dict) -> bool:
        return r["loss_rel"] <= PERCEPTUAL_LOSS_RTOL and r["grad_rel"] <= PERCEPTUAL_GRAD_TOL

    # (a) fp32 against fp64, and the TF32 stack outside the tolerance
    scoped = perceptual_grads(pl, x1, t1, scoped=True)
    a = held("fp32", *scoped)
    tf32 = held("TF32", *plain_perceptual(pl, x1, t1, True, True))
    if not within(a):
        fail(f"perceptual (a): the card's fp32 against fp64: {a}")
    if within(tf32):
        fail(f"perceptual (a): the TF32 stack passes the fp64 tolerance: {tf32}")

    # (b) backward() outside any scope with cuDNN's TF32 on globally
    cudnn = torch.backends.cudnn
    was = cudnn.allow_tf32
    cudnn.allow_tf32 = True
    try:
        free = perceptual_grads(pl, x1, t1, scoped=False)
        tf32_bwd = plain_perceptual(pl, x1, t1, False, True)
    finally:
        cudnn.allow_tf32 = was
    b = held("outside any scope", *free)
    b_scope = against("outside any scope", *free, *scoped)
    bwd_gap = against("TF32 backward", *tf32_bwd, *scoped)
    plain = against("plain fp32", *plain_perceptual(pl, x1, t1, False, False), *scoped)
    if not within(b):
        fail(f"perceptual (b): the backward outside any scope against fp64: {b}")
    if b_scope["grad_rel"] > PERCEPTUAL_SCOPE_TOL:
        fail(f"perceptual (b): the backward outside any scope against fp32_convs(): {b_scope}")
    if plain["grad_rel"] > PERCEPTUAL_SCOPE_TOL:
        fail(f"perceptual (b): plain F.conv2d's fp32 backward against the port's: {plain}")
    if bwd_gap["grad_rel"] <= PERCEPTUAL_SCOPE_TOL:
        fail(f"perceptual (b): a TF32 backward passes the scope tolerance: {bwd_gap}")

    # (c) at the full batch: loss(x, x) == 0, the gradient, no weight's
    xg = x.detach().requires_grad_(True)
    loss = pl(xg, target)
    loss.backward()
    same = pl(x, x).item()
    if same != 0.0 or not torch.isfinite(xg.grad).all() or loss.shape != ():
        fail(f"perceptual (c): loss(x, x) = {same}, loss shape {tuple(loss.shape)}, or a "
             "non-finite dL/dx")
    if any(p.grad is not None or p.requires_grad for p in pl.net.parameters()):
        fail("perceptual (c): a VGG weight requires or holds a gradient")

    # (d) times, memory, FLOP and bound, parts
    def forward():
        return pl(x.detach().requires_grad_(True), target)

    def step():
        xs = x.detach().requires_grad_(True)
        pl(xs, target).backward()

    def peak_of(fn) -> tuple[int, int]:
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(), start

    fwd_ms = time_ms(forward, reps=PERCEPTUAL_REPS, warmup=2)
    step_ms = time_ms(step, reps=PERCEPTUAL_REPS, warmup=1)
    host_s = []
    for _ in range(PERCEPTUAL_HOST_REPS):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        host_s.append(time.perf_counter() - t0)
    peak, start = peak_of(step)
    heuristics = cudnn.benchmark
    cudnn.benchmark = True      # what cuDNN's autotuner picks instead of its heuristics
    try:
        tuned_ms = time_ms(step, reps=PERCEPTUAL_HOST_REPS, warmup=2)
        tuned_peak, _ = peak_of(step)
    finally:
        cudnn.benchmark = heuristics
    fb_ms, copy_ms = [], []
    for _ in range(PERCEPTUAL_REPS):
        t0 = time.perf_counter()
        fb = mel_filterbank(SR, 400, 64)
        t1_ = time.perf_counter()
        torch.from_numpy(fb).to("cuda")
        torch.cuda.synchronize()
        fb_ms.append((t1_ - t0) * 1e3)
        copy_ms.append((time.perf_counter() - t1_) * 1e3)
    parts = device_parts(step)
    images = x.numel() // FRAME
    h, w = 64, FRAME // 160 + 1
    flop_fwd = 2 * images * vgg_flop(h, w)
    flop_step = flop_fwd + images * vgg_flop(h, w)
    moved = nbytes(x, target) + sum(nbytes(p) for p in pl.net.parameters())
    bound_fwd, by_fwd = bound(flop_fwd, moved)
    bound_step, by_step = bound(flop_step, moved + nbytes(x))
    host_ms = statistics.median(host_s) * 1e3
    cudnn_ms = parts.get("cuDNN convs", 0.0)
    after = launch_counts(kernels)
    if after != before:
        fail(f"perceptual (c): the port's kernels launched: {before} -> {after}")

    result = dict(
        card=smi, images_per_side=images, mel=(h, w), loss=loss.item(), fp32_vs_fp64=a,
        pieces_apart=dict(masks=flips[0], argmaxes=flips[1]),
        tf32_vs_fp64=tf32, outside_scope_vs_fp64=b, outside_scope_vs_scoped=b_scope,
        tf32_backward_vs_scoped=bwd_gap, plain_fp32_vs_scoped=plain,
        tolerance=dict(loss_rtol=PERCEPTUAL_LOSS_RTOL, grad=PERCEPTUAL_GRAD_TOL,
                       scope=PERCEPTUAL_SCOPE_TOL),
        forward_ms=fwd_ms, forward_backward_ms=step_ms, host_ms=host_ms,
        peak_gb=peak / 1e9, peak_over_start_gb=(peak - start) / 1e9,
        flop_forward=flop_fwd, flop_forward_backward=flop_step,
        bound_forward_ms=bound_fwd, bound_forward_by=by_fwd,
        bound_forward_backward_ms=bound_step, bound_forward_backward_by=by_step,
        parts_ms=parts, cudnn_share=cudnn_ms / parts["kernels"],
        host_share=(host_ms - step_ms) / host_ms,
        cudnn_benchmark=dict(forward_backward_ms=tuned_ms, peak_gb=tuned_peak / 1e9),
        filterbank_host_ms=statistics.median(fb_ms),
        filterbank_copy_ms=statistics.median(copy_ms),
        launches=after)
    print(f"[perceptual] {smi}: PerceptualLoss at {images} + {images} mel images of {h} x {w} "
          f"(batch {BATCH} x 4 stems x {FRAME} samples at {SR} Hz): forward {fwd_ms:.3f} ms, "
          f"forward + backward {step_ms:.3f} ms (median of {PERCEPTUAL_REPS}, CUDA events; "
          f"bounds {bound_fwd:.3f} / {bound_step:.3f} ms by {by_step} at "
          f"{PEAK_FLOPS['fp32'] / 1e12:.0f} TFLOP/s, {flop_fwd:.3e} / {flop_step:.3e} FLOP), "
          f"host {host_ms:.3f} ms, peak {peak / 1e9:.3f} GB ({(peak - start) / 1e9:.3f} over the "
          f"call's start), cuDNN {cudnn_ms:.3f} of {parts['kernels']:.3f} kernel ms, host share "
          f"{result['host_share']:.4f} (host {host_ms:.3f} ms against the events' {step_ms:.3f}; "
          f"with cudnn.benchmark = True {tuned_ms:.3f} ms, peak {tuned_peak / 1e9:.3f} GB), the "
          f"mel filterbank {result['filterbank_host_ms']:.3f} ms "
          f"on the host + {result['filterbank_copy_ms']:.3f} ms copy a call (2 a loss)",
          flush=True)
    print(f"[perceptual] {smi}: one sample against fp64 (tolerance: loss "
          f"{PERCEPTUAL_LOSS_RTOL:g} relative, dL/dx {PERCEPTUAL_GRAD_TOL:g} of its largest on "
          f"the card's pieces; {flips[0]} masks and {flips[1]} argmaxes apart from the fp64 "
          f"path's): fp32 {a}, TF32 stack {tf32} (outside, as it must be); backward outside "
          f"any scope with cudnn.allow_tf32 = True {b}, against fp32_convs()'s {b_scope} "
          f"(tolerance {PERCEPTUAL_SCOPE_TOL:g}; a TF32 backward {bwd_gap}, plain fp32 {plain}); "
          f"loss(x, x) = {same}, no VGG weight has a gradient, the port's kernels launched 0 times",
          flush=True)
    print(f"[perceptual] {json.dumps(result)}", flush=True)
    return result


#: phase 32: the VQ-VAE's kernels at widths past the sweep's (csrc/stem_any.cu,
#: csrc/vq_any.cu, #5 over runs of codes), at batch 8 x 44,000 samples
WIDTH_BATCH = 8
WIDTH_HIDDEN = {torch.float32: (2, 7, 96, 200, 384, 512), torch.bfloat16: (64, 96, 256, 512)}
#: (D, K): a codec's 1,024 and 2,048 codes, an odd K, the widths between
#: and past the sweep's, the largest K, and a D no multiple of 4 (#5 reads
#: its rows padded to 4 columns)
WIDTH_CODES = ((8, 1024), (64, 1024), (64, 2048), (64, 511), (96, 4096), (512, 512),
               (32, 65_536), (7, 33))
WIDTH_REPS = 10
WIDTH_RAGGED_T, WIDTH_RAGGED_W, WIDTH_RAGGED_N = (7, 1_030, 44_003), (2, 258), (1, 7, 129, 4_097)
#: the entry points at new widths: (num_hidden, embedding_dim, num_embedding,
#: compute_dtype, the least share of card codes equal to the CPU's)
WIDTH_MODELS = ((96, 8, 1024, None, 0.999), (256, 64, 2048, "bfloat16", 0.99))
WIDTH_TEACHER_K = 1024                # Audio-BERT's frozen teacher's codebook
WIDTH_ROOT = OUT_DIR / "widths"
WIDTH_CLI_ARGS = ["train_vqvae=True", "experiment=fast_serving", "model.vqvae.num_hidden=64",
                  "trainer.max_epochs=1", "+trainer.limit_train_batches=1",
                  "+trainer.limit_val_batches=1", "+trainer.limit_test_batches=1",
                  "extras.print_config=False"]
WIDTHS_FLAG = "--widths"              # chip_smoke.py --widths: the build and phase 32 alone


def any_label(name: str, widths: tuple, dtype: torch.dtype) -> str:
    """An instantiation's name in the kernels line: width_label's, with
    'bf16 ' before a bf16 stem's widths; #7's by ``attention_label`` (its
    ``.widths`` keys hold the launch's kind and type, and (D,))."""
    if name == "flash_attn":
        return f"flash_attn {attention_label(dtype, widths[0])}"
    if dtype == torch.bfloat16 and name.startswith(("conv", "deconv")):
        return f"{name}[bf16 {'x'.join(str(w) for w in widths)}]"
    return width_label(name, widths)


def bf16_width_check(name: str, out, h, want, want_h, w2, b2, transposed: bool):
    """A bf16 stem at a new width, from its output and the hidden its kernel
    computed (K1b's or K2b's on the same inputs): the hidden against the
    plain one (``check_bf16``); the output against the plain second layer
    run in fp32 on the kernel's own hidden (``check_bf16``: two fp32 sums in
    another order, each rounded once); and every output value within 2 ulps
    + 2⁻⁷·Σ|w2|·|h| of the plain version's, ``check_bf16``'s bound. Hidden
    values whose fp32 sums straddle a bf16 rounding point round apart, and
    the outputs past 2 ulps that they leave grow in number with the terms
    an output sums (C1): their share is returned, not held to
    ``check_bf16``'s 1e-4, which the default widths set (C1 = 64). Returns
    (largest error against the plain version, that share)."""
    import torch.nn.functional as F

    from msla_tpu_torch.ops.conv_adjoints import fp32_convs

    zeros = torch.zeros_like(want_h, dtype=torch.float32)
    check_bf16(name + " hidden", h, want_h, zeros)
    with fp32_convs():
        if transposed:
            own = F.conv_transpose1d(h.float(), w2.float(), b2, 2, 1)
        else:
            own = F.relu(F.conv1d(h.float(), w2.float(), b2, 2, 1))
    check_bf16(name + " on its own hidden", out, own.to(torch.bfloat16),
               torch.zeros_like(own))
    g, w = out.float(), want.float()
    err = (g - w).abs()
    ulp = torch.ldexp(torch.ones_like(err), torch.frexp(torch.maximum(g.abs(), w.abs()))[1] - 8)
    terms = stem_terms(want_h, w2, transposed)
    if (err > torch.clamp(2 * ulp, min=1e-6) + 2.0 ** -7 * terms).any():
        fail(f"{name}: values beyond 2 bf16 ulps + 2^-7 of their terms, max abs error "
             f"{err.max().item():.3e}")
    return err.max().item(), (err > torch.clamp(2 * ulp, min=1e-6)).double().mean().item()


def width_stem_rows(dev, g, ptxas: dict, transposed: bool) -> list[dict]:
    """K1/K1b (or K2/K2b) at WIDTH_HIDDEN on csrc/stem_any.cu's kernel: each
    against its plain version at WIDTH_BATCH x FRAME, fp32 within STEM_TOL
    and, on the first item, against fp64 within ``stem_accumulation_bound``,
    bf16 by ``bf16_width_check`` (K1 and K2 equal to K1b's and K2b's
    output); output and hidden, at ragged lengths, the same bits twice;
    timed beside the plain version and cuDNN's pair."""
    import torch.nn.functional as F

    from msla_tpu_torch.ops import (conv_stem, conv_stem_ref, conv_stem_save_hidden,
                                    deconv_stem, deconv_stem_ref, deconv_stem_save_hidden)
    from msla_tpu_torch.ops.conv_adjoints import fp32_convs
    from msla_tpu_torch.ops.conv_stem import plan_stem as conv_plan
    from msla_tpu_torch.ops.deconv_stem import plan_stem as deconv_plan

    b, w = WIDTH_BATCH, FRAME // 4
    source = "deconv_stem" if transposed else "conv_stem"
    rows = []
    for dtype, hiddens in WIDTH_HIDDEN.items():
        bf16 = dtype == torch.bfloat16
        for hidden in hiddens:
            half = hidden // 2
            if transposed:
                widths, ref, fns = (hidden, half), deconv_stem_ref, (deconv_stem,
                                                                     deconv_stem_save_hidden)
                x = torch.rand((b, hidden, w), generator=g, device=dev)
                w1 = torch.randn((hidden, half, 4), generator=g, device=dev) / (2 * hidden) ** 0.5
                w2 = torch.randn((half, 4, 4), generator=g, device=dev) / (2 * half) ** 0.5
                b2 = torch.randn((4,), generator=g, device=dev) * 0.1
                conv, reps = F.conv_transpose1d, ("msla_tpu/ops/deconv_stem.py:35",
                                                  "msla_tpu/ops/deconv_stem.py:132")
                flop = 2 * b * (2 * w * half * hidden * 2 + 4 * w * 4 * half * 2)
                plan = deconv_plan(hidden, half, dtype)
            else:
                widths, ref, fns = (half, hidden), conv_stem_ref, (conv_stem,
                                                                   conv_stem_save_hidden)
                x = torch.randn((b, 4, FRAME), generator=g, device=dev) * 0.3
                w1 = torch.randn((half, 4, 4), generator=g, device=dev) / 4.0
                w2 = torch.randn((hidden, half, 4), generator=g, device=dev) / (4 * half) ** 0.5
                b2 = torch.randn((hidden,), generator=g, device=dev) * 0.1
                conv, reps = F.conv1d, ("msla_tpu/ops/conv_stem.py:48",
                                        "msla_tpu/ops/conv_stem.py:132")
                flop = 2 * b * (FRAME // 2 * half * 16 + w * hidden * 4 * half)
                plan = conv_plan(half, hidden, dtype)
            if plan.symbol != f"{source}_any_fwd":
                fail(f"{source} {dtype} at {widths}: planned on {plan.symbol}, not stem_any.cu")
            b1 = torch.randn((half,), generator=g, device=dev) * 0.1
            args = (x.to(dtype), w1.to(dtype), b1, w2.to(dtype), b2)
            smem = kernel_smem("stem_any_smem_bytes", int(transposed), int(bf16), *widths,
                               plan.tile)
            if smem != plan.smem:
                fail(f"stem_any_smem_bytes at {widths} {dtype}: {smem}, plan_stem's {plan.smem}")
            lib_w = (args[1], b1.to(dtype), args[3], b2.to(dtype))
            if bf16:
                lib = time_ms(lambda: conv(F.relu(conv(args[0], lib_w[0], lib_w[1], 2, 1)),
                                           lib_w[2], lib_w[3], 2, 1), WIDTH_REPS, 1)
            else:
                with fp32_convs():
                    lib = time_ms(lambda: conv(F.relu(conv(args[0], w1, b1, 2, 1)), w2, b2, 2, 1),
                                  WIDTH_REPS, 1)
            kernel = f"{source}_any_kernel<{'__nv_bfloat16' if bf16 else 'float'}>"
            for name, fn, rep in zip((source, f"{source}_save_hidden"), fns, reps):
                hidden_out = name.endswith("save_hidden")
                label = any_label(name, widths, dtype)

                def check(fn_args, at: str = "") -> tuple[float, float]:
                    got = fn(*fn_args)
                    out, h = got if hidden_out else (got, None)
                    want, want_h = ref(*fn_args)
                    if bf16:  # K1 and K2 alike, on the hidden K1b / K2b computed
                        out_b, h_b = fns[1](*fn_args)
                        if not torch.equal(out, out_b):
                            fail(f"{label}{at}: differs from {fns[1].__name__}'s output")
                        return bf16_width_check(label + at, out, h_b, want, want_h,
                                                fn_args[3], fn_args[4], transposed)
                    err = max(check_close(label + at, out, want),
                              check_close(label + at + " hidden", h, want_h) if hidden_out
                              else 0.0)
                    return err, 0.0

                got = fn(*args)
                torch.cuda.synchronize()
                err, beyond = check(args)
                share = None
                if not bf16:
                    few = (args[0][:1],) + args[1:]
                    out, h = got if hidden_out else (got, None)
                    share = stem_fp64_share(label, stem_accumulation_bound(
                        *few, transposed=transposed), out[:1], None if h is None else h[:1])
                same_bits(label, got if hidden_out else (got,),
                          fn(*args) if hidden_out else (fn(*args),))
                ragged = {}
                for n in WIDTH_RAGGED_W if transposed else WIDTH_RAGGED_T:
                    small = ((torch.rand if transposed else torch.randn)(
                        (2, x.shape[1], n), generator=g, device=dev).to(dtype),) + args[1:]
                    ragged[n] = check(small, at=f" at {n}")[0]
                out = got[0] if hidden_out else got
                moved = nbytes(*args, out) + (nbytes(got[1]) if hidden_out else 0)
                ms = time_ms(lambda: fn(*args), WIDTH_REPS, 1)
                rows.append(dict(
                    name=label, route="cuda", source="msla_tpu_torch/csrc/stem_any.cu",
                    replaces=rep, widths=list(widths), dtype=str(dtype).split(".")[1],
                    design=plan.design, tile=plan.tile, padded=list(plan.padded),
                    padded_share=plan.padded_share, max_abs_err=err,
                    **({"beyond_2_ulps_share": beyond} if bf16 else
                       {"fp64_share_of_bound": share}),
                    ragged_max_abs_err=ragged, ms=ms,
                    plain_ms=time_ms(lambda: ref(*args), WIDTH_REPS, 1), library_ms=lib,
                    library_call=f"cuDNN {'bf16' if bf16 else 'fp32'} "
                                 f"{conv.__name__} pair", flop=flop, bytes=moved,
                    registers=ptxas_of(ptxas, "stem_any", kernel), smem_bytes=smem,
                    **({"flop_type": "bf16"} if bf16 else tf32_bounds(flop, moved))))
                del got, out
            del x, args
    torch.cuda.empty_cache()
    return rows


def chunked_ids(x: torch.Tensor, cb: torch.Tensor, rows: int = 8192) -> torch.Tensor:
    """nearest_codes_ref over row blocks: the plain ids at any K without a
    (N, K) block past rows x K."""
    from msla_tpu_torch.ops import nearest_codes_ref

    return torch.cat([nearest_codes_ref(c, cb) for c in x.split(rows)])


def width_vq_rows(dev, g, ptxas: dict) -> list[dict]:
    """K3, #4 and #5 at WIDTH_CODES on N = WIDTH_BATCH x FRAME / 4 rows, on
    csrc/vq_any.cu (K3, #4) and #5's runs of codes: ids equal to the plain
    version's or a near-tie, also at ragged N; planted ties and close pairs
    (vq_planted, K >= 512; codebooks 4x wider at D <= 16, where standard
    normal codes lie too near each other for the construction) right; #4's
    q the codebook rows bit for bit, counts a bincount, sq within 1e-5 of
    fp64, the same bits twice; #5 on #4's ids and uniform ids bit-equal to
    codebook_grad_order_ref at its grid (``grad_layout``), within
    segment_sum_bound, the same bits twice; each timed beside its plain
    version and a library call (none for K3 and #4 where the (N, K) distance
    block passes 8 GB)."""
    from msla_tpu_torch.ops import (nearest_codes, vq_codebook_grad, vq_codebook_grad_ref,
                                    vq_fused_fwd, vq_fused_fwd_ref)
    from msla_tpu_torch.ops.nearest_codes import plan_search
    from msla_tpu_torch.ops.vq_fused import grad_smem_bytes, plan_grad

    n = WIDTH_BATCH * FRAME // 4
    rows = []
    for d, k in WIDTH_CODES:
        plans = [plan_search(k, d, h) for h in (False, True)]
        if any(p.design != "any width" for p in plans):
            fail(f"vq search at D={d}, K={k}: planned on {plans}, not vq_any.cu")
        smem = kernel_smem("vq_any_smem_bytes", d, plans[0].rows, plans[0].codes)
        if smem != plans[0].smem:
            fail(f"vq_any_smem_bytes({d}): {smem}, plan_search's {plans[0].smem}")
        scale = 4.0 if d <= 16 else 1.0
        flat = torch.randn((n, d), generator=g, device=dev)
        cb = torch.randn((k, d), generator=g, device=dev) * scale
        e2 = (cb * cb).sum(1)
        searches = (("nearest_codes", nearest_codes),
                    ("vq_fused_fwd", lambda x, e: vq_fused_fwd(x, e)[1]))
        planted = {}
        if k >= 512:
            for close in (False, True):
                x, e, want = vq_planted(cb, close, g)
                for what, search in searches:
                    for label, ids in (("kernel", search(x, e)), ("plain", chunked_ids(x, e))):
                        if not torch.equal(ids.long(), want):
                            fail(f"{what}[D={d},K={k}] planted {'close pairs' if close else 'ties'}"
                                 f": the {label} version missed {(ids.long() != want).sum()} rows")
            planted = dict(planted_ties=VQ_PLANTED_ROWS, planted_close_pairs=VQ_PLANTED_ROWS)
        ragged = {what: {} for what, _ in searches}
        for nn in WIDTH_RAGGED_N:
            x = torch.randn((nn, d), generator=g, device=dev)
            for what, search in searches:
                ragged[what][nn] = near_ties_by(l2_dist(x, cb), search(x, cb), chunked_ids(x, cb),
                                                what)[0]
        flop = 2 * n * k * d
        big = n * k * 4 > 8e9
        idx = nearest_codes(flat, cb)
        torch.cuda.synchronize()
        mismatches, gap, rel = near_ties(flat, cb, idx, chunked_ids(flat, cb))
        if not torch.equal(idx, nearest_codes(flat, cb)):
            fail(f"nearest_codes[D={d},K={k}]: two calls differ")
        moved = nbytes(flat, cb, idx)
        rows.append(dict(
            name=width_label("nearest_codes", (d, k)), route="cuda",
            source="msla_tpu_torch/csrc/vq_any.cu", replaces="msla_tpu/ops/vq_pallas.py:40",
            widths=[d, k], design=plans[0].design, rows=plans[0].rows, codes=plans[0].codes,
            padded=list(plans[0].padded), padded_share=plans[0].padded_share, max_abs_err=gap,
            index_mismatches=mismatches, max_tie_gap=rel, **planted,
            ragged_n_mismatches=ragged["nearest_codes"],
            ms=time_ms(lambda: nearest_codes(flat, cb), WIDTH_REPS, 1),
            plain_ms=time_ms(lambda: chunked_ids(flat, cb), WIDTH_REPS, 1),
            library_ms=None if big else time_ms(
                lambda: torch.argmin(e2 - 2.0 * torch.matmul(flat, cb.T), dim=1), WIDTH_REPS, 1),
            flop=flop, bytes=moved,
            registers=ptxas_of(ptxas, "vq_any", "vq_any_kernel<false>"), smem_bytes=smem,
            **tf32_bounds(flop, moved)))

        q, idx, counts, sq, (mismatches, gap, rel), sq_rel = check_fused(flat, cb)

        def composite():  # matmul, argmin, gather, bincount, sum
            i = torch.argmin(e2 - 2.0 * torch.matmul(flat, cb.T), dim=1)
            return torch.bincount(i, minlength=k), ((cb.index_select(0, i) - flat) ** 2).sum()

        moved = nbytes(flat, cb, q, idx, counts, sq)
        rows.append(dict(
            name=width_label("vq_fused_fwd", (d, k)), route="cuda",
            source="msla_tpu_torch/csrc/vq_any.cu", replaces="msla_tpu/ops/vq_fused.py:42",
            widths=[d, k], design=plans[1].design, padded=list(plans[1].padded),
            padded_share=plans[1].padded_share, max_abs_err=gap, index_mismatches=mismatches,
            max_tie_gap=rel, sq_rel_err=sq_rel, **planted,
            ragged_n_mismatches=ragged["vq_fused_fwd"],
            ms=time_ms(lambda: vq_fused_fwd(flat, cb), WIDTH_REPS, 1),
            plain_ms=time_ms(lambda: vq_fused_fwd_ref(flat, cb), WIDTH_REPS, 1),
            library_ms=None if big else time_ms(composite, WIDTH_REPS, 1),
            library_call="composite: matmul + argmin + index_select + bincount + sum",
            flop=flop, bytes=moved, registers=ptxas_of(ptxas, "vq_any", "vq_any_kernel<true>"),
            smem_bytes=smem + 64, **tf32_bounds(flop, moved)))  # 64 static: the warps' fp64
        del q, flat

        grad = torch.randn((n, d), generator=g, device=dev)
        fn = lambda x, i: vq_codebook_grad(x, i, k)
        checks = {kind: check_segment_sum(f"vq_codebook_grad[D={d},K={k}] ({kind} ids)",
                                          fn, grad, ids, k, False)
                  for kind, ids in (("model", idx), ("uniform", segment_ids("uniform", n, k, g)))}
        plan = plan_grad(k, d)
        ids_long = idx.long()
        zeros = torch.zeros((k, d), device=dev)
        rows.append(dict(
            name=width_label("vq_codebook_grad", (d, k)), route="cuda",
            source="msla_tpu_torch/csrc/segment_sum.cuh",
            replaces="msla_tpu/ops/vq_fused.py:81", widths=[d, k],
            max_abs_err=checks["model"]["max_abs_err"],
            fp64_share_of_bound=max(c["fp64_share_of_bound"] for c in checks.values()),
            blocks=checks["model"]["blocks"], column_slices=plan.slices, runs=plan.runs,
            codes_a_run=plan.run, padded_share=plan.padded_share,
            ms=time_ms(lambda: fn(grad, idx), WIDTH_REPS, 1),
            plain_ms=time_ms(lambda: vq_codebook_grad_ref(grad, idx, k), WIDTH_REPS, 1),
            library_ms=time_ms(lambda: zeros.index_add_(0, ids_long, grad), WIDTH_REPS, 1),
            library_call="index_add_", flop=n * d, bytes=nbytes(grad, idx) + k * d * 4,
            registers=ptxas_of(ptxas, "vq_fused", "segment_sum_kernel<false>"),
            smem_bytes=grad_smem_bytes(plan.run)))
        del grad, idx
    torch.cuda.empty_cache()
    return rows


def codes_card_vs_cpu(task, model: dict, least: float) -> dict:
    """The task's codes on 2 frames on the card against a CPU copy's (the
    plain versions, the same compute dtype): at least ``least`` of them
    equal, every fp32 mismatch a near-tie."""
    from msla_tpu_torch.models.vqvae import VQVAETask

    cpu = VQVAETask(**model, checkpoint_dir=".", codebook_file="codebook.csv", device="cpu")
    cpu.net.load_state_dict({k: v.cpu() for k, v in task.net.state_dict().items()})
    frames = synthetic_mixture(2 * FRAME / SR, seed=40).reshape(2, 1, FRAME).repeat(4, axis=1)
    x_cpu = torch.from_numpy(np.ascontiguousarray(frames))
    with torch.inference_mode():
        ig = task.get_quantized(x_cpu.cuda()).encoding_indices.cpu()
        ic = cpu.get_quantized(x_cpu).encoding_indices
        zc = cpu.net.encode(x_cpu)
    agree = (ig == ic).double().mean().item()
    if agree < least:
        fail(f"card vs CPU at {model}: only {agree:.5f} of codes agree (least {least})")
    ties = None
    if model.get("compute_dtype") is None:
        ties = near_ties(zc.reshape(-1, zc.shape[-1]), cpu.net.vector_quantizer.codebook.weight,
                         ig.flatten(), ic.flatten())[0]
    return dict(code_agreement=agree, near_tie_mismatches=ties)


def width_models(kernels) -> dict:
    """The entry points at WIDTH_MODELS: ``Trainer.fit`` (2 train and 1
    validation batch of WIDTH_BATCH) then ``SourceSeparator.separate()`` of
    a song on the card, each output finite and of its shape, the trained
    model's codes card vs CPU; the launches at the model's widths."""
    from msla_tpu_torch.inference import SourceSeparator
    from msla_tpu_torch.models.vqvae import VQVAETask
    from msla_tpu_torch.train.trainer import Trainer

    out = {}
    for hidden, d, k, dtype, least in WIDTH_MODELS:
        model = dict(MODEL, num_hidden=hidden, embedding_dim=d, num_embedding=k,
                     compute_dtype=dtype)
        name = f"{hidden}x{d}x{k}{'-bf16' if dtype else ''}"
        root = WIDTH_ROOT / name
        task = VQVAETask(**model, checkpoint_dir=str(root), codebook_file=str(root / "cb.csv"),
                         device="cuda", seed=0)
        dm = in_memory_datamodule(synthetic_stems(2, seed=32, batch=WIDTH_BATCH),
                                  synthetic_stems(1, seed=33, batch=WIDTH_BATCH),
                                  batch=WIDTH_BATCH)
        before = {key: v.detach().clone() for key, v in task.net.state_dict().items()}
        reset_counts(kernels)
        t0 = time.perf_counter()
        trainer = Trainer(max_epochs=1, seed=0, enable_progress_bar=False)
        trainer.fit(task, dm)
        sep = SourceSeparator(task, frame_samples=FRAME, batch_size=WIDTH_BATCH)
        song = synthetic_mixture(WIDTH_BATCH * FRAME / SR, seed=34)
        stems = sep.separate(song)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        cm = trainer.callback_metrics
        if not cm or not all(np.isfinite(v) for v in cm.values()):
            fail(f"width model {name}: fit's metrics {cm}")
        if all(torch.equal(v, before[key]) for key, v in task.net.state_dict().items()):
            fail(f"width model {name}: fit changed no parameter")
        if stems.shape != (4, song.size) or not np.isfinite(stems).all():
            fail(f"width model {name}: separate gave {stems.shape} or non-finite values")
        op = torch.bfloat16 if dtype else torch.float32
        want = {("conv_stem", op, (hidden // 2, hidden)), ("conv_stem_save_hidden", op,
                (hidden // 2, hidden)), ("deconv_stem", op, (hidden, hidden // 2)),
                ("deconv_stem_save_hidden", op, (hidden, hidden // 2)),
                ("nearest_codes", torch.float32, (d, k)), ("vq_fused_fwd", torch.float32, (d, k)),
                ("vq_codebook_grad", torch.float32, (d, k))}
        got = {(w.__name__, key[0], key[1]): c for w in kernels
               for key, c in getattr(w, "widths", {}).items()}
        absent = [f"{n} {t} {w}" for n, t, w in want if not got.get((n, t, w))]
        if absent:
            fail(f"width model {name}: instantiations that never launched: {absent}")
        out[name] = dict(s=seconds, steps=trainer.global_step, train_loss=cm["train/loss"],
                         launches={any_label(n, w, t): c for (n, t, w), c in got.items()},
                         **codes_card_vs_cpu(task, model, least))
        print(f"[widths] model {name}: fit {trainer.global_step} steps and separate in "
              f"{seconds:.2f} s, {out[name]}", flush=True)
        del task, trainer, sep
        torch.cuda.empty_cache()
    return out


def width_cli(kernels) -> dict:
    """``python -m msla_tpu_torch`` with WIDTH_CLI_ARGS in process, on phase
    27's 22 kHz fixture (written again if gone): one batch of 128 of each
    split, the bf16 stems at num_hidden 64; the run's launches."""
    import os
    import shutil

    from msla_tpu_torch import main as cli
    from msla_tpu_torch.data.dataset import make_fixture_dataset

    slakh, project = SWEEP_ROOT / "slakh", WIDTH_ROOT / "cli"
    if not all((slakh / split).is_dir() for split in SWEEP_TRACKS):
        for i, (split, n) in enumerate(SWEEP_TRACKS.items()):
            make_fixture_dataset(slakh / split, n_tracks=n, seconds=CLI_TRACK_S, sr=SR,
                                 seed=30 + i)
    shutil.rmtree(project, ignore_errors=True)
    env = {key: os.environ.get(key) for key in ("SLAKH_DIR", "PROJECT_ROOT")}
    os.environ.update(SLAKH_DIR=str(slakh), PROJECT_ROOT=str(project))
    reset_counts(kernels)
    t0 = time.perf_counter()
    try:
        cli.main(WIDTH_CLI_ARGS)
    finally:
        for key, v in env.items():
            if v is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = v
    seconds = time.perf_counter() - t0
    got = {any_label(w.__name__, key[1], key[0]): c for w in kernels
           for key, c in getattr(w, "widths", {}).items()}
    for n in ("conv_stem_save_hidden", "deconv_stem_save_hidden", "conv_stem", "deconv_stem"):
        widths = (32, 64) if n.startswith("conv") else (64, 32)
        if not got.get(any_label(n, widths, torch.bfloat16)):
            fail(f"width cli: {n} never launched on bf16 at {widths}: {got}")
    if not (project / "logs" / "best_checkpoint" / "best_vqvae.ckpt").is_file():
        fail("width cli: no best_vqvae.ckpt written")
    shutil.rmtree(project, ignore_errors=True)
    print(f"[widths] cli {' '.join(WIDTH_CLI_ARGS[:3])}: {seconds:.2f} s, launches {got}",
          flush=True)
    return dict(s=seconds, launches=got)


def width_teacher(kernels) -> dict:
    """Audio-BERT over a frozen teacher of WIDTH_TEACHER_K codes: the
    teacher's code ids of 2 frames card vs CPU (at least 0.999 equal), then
    a bert-base AudioBertTask with the teacher's codebook (num_embedding
    WIDTH_TEACHER_K) on the card's ids: finite stems of the frame's shape."""
    from msla_tpu_torch.data.transform import Quantize
    from msla_tpu_torch.models.bert import AudioBertTask
    from msla_tpu_torch.models.vqvae import VQVAETask

    model = dict(MODEL, num_embedding=WIDTH_TEACHER_K)
    root = WIDTH_ROOT / "teacher"
    root.mkdir(parents=True, exist_ok=True)
    csv = root / "codebook.csv"
    teacher = VQVAETask(**model, checkpoint_dir=str(root), codebook_file=str(csv),
                        device="cuda", seed=0)
    cb = teacher.net.vector_quantizer.codebook.weight.detach().cpu().numpy()
    np.savetxt(csv, cb, delimiter=",", header=",".join(str(i) for i in range(cb.shape[1])),
               comments="")
    reset_counts(kernels)
    frames = torch.from_numpy(np.ascontiguousarray(synthetic_stems(1, seed=41, batch=2)[0]))
    ids = Quantize(teacher).get_encodings_idx(frames.cuda())
    bert = AudioBertTask(**dict(bert_task_args(), codebook=str(csv),
                                num_embedding=WIDTH_TEACHER_K), device="cuda", seed=0)
    stems = bert.forward(ids)
    torch.cuda.synchronize()
    got = {any_label(w.__name__, key[1], key[0]): c for w in kernels
           for key, c in getattr(w, "widths", {}).items()}
    if tuple(stems.shape) != (2, 4, FRAME) or not torch.isfinite(stems).all():
        fail(f"width teacher: Audio-BERT gave {tuple(stems.shape)} or non-finite values")
    if not got.get(width_label("nearest_codes", (64, WIDTH_TEACHER_K))):
        fail(f"width teacher: K3 never launched at K={WIDTH_TEACHER_K}: {got}")
    agreement = codes_card_vs_cpu(teacher, model, 0.999)  # after the counts: it runs the card
    del bert, teacher
    torch.cuda.empty_cache()
    result = dict(launches=got, **agreement)
    print(f"[widths] Audio-BERT over a teacher of {WIDTH_TEACHER_K} codes: {result}", flush=True)
    return result


def phase_widths(kernels, dev, ptxas: dict, smi: str) -> tuple[dict, list[dict]]:
    """Phase 32: every new instantiation against its plain version (stems,
    search, gradient), then the entry points at new widths with the launch
    counts zeroed just before them: the fp32 and bf16 models (fit, separate,
    card vs CPU), the CLI at num_hidden 64 and Audio-BERT's teacher at
    1,024 codes. Each row's ``launches``: its instantiation's in those runs."""
    from msla_tpu_torch.ops import _build

    g = torch.Generator(device=dev).manual_seed(32)
    t0 = time.perf_counter()
    with torch.no_grad():
        rows = (width_stem_rows(dev, g, ptxas, False) + width_stem_rows(dev, g, ptxas, True)
                + width_vq_rows(dev, g, ptxas))
    kernels_s = time.perf_counter() - t0
    models = width_models(kernels)
    cli = width_cli(kernels)
    teacher = width_teacher(kernels)
    launches = collections.Counter()
    for run in (*models.values(), cli, teacher):
        launches.update(run["launches"])
    for row in rows:
        row["launches"] = launches.get(row["name"], 0)
    for prefix in ("conv_stem[", "conv_stem_save_hidden[", "deconv_stem[",
                   "deconv_stem_save_hidden[", "conv_stem[bf16", "conv_stem_save_hidden[bf16",
                   "deconv_stem[bf16", "deconv_stem_save_hidden[bf16", "nearest_codes[",
                   "vq_fused_fwd[", "vq_codebook_grad["):
        if not any(r["name"].startswith(prefix) and r["launches"] for r in rows):
            fail(f"phase 32: no instantiation {prefix}...] launched on the entry points")
    result = dict(card=smi, kernels_s=kernels_s, nvcc_s=dict(_build.NVCC_SECONDS),
                  models=models, cli=cli, teacher=teacher, launches=dict(launches))
    print(f"[widths] {smi}: instantiations checked in {kernels_s:.1f} s; nvcc seconds "
          f"{result['nvcc_s']}", flush=True)
    return result, with_bounds(rows)


ATTENTION_FLAG = "--attention"        # chip_smoke.py --attention: the build and phase 33 alone
#: every (D, type) instantiation is held at these widths and (Sq, Sk), masked
#: and not, 3 sequences of 2 heads (sequence 1 its last third of keys
#: padding, sequence 2 all padding)
ATTN_WIDTHS = (1, 8, 26, 32, 48, 64, 80, 96, 128, 160, 256)
ATTN_LENGTHS = ((512, 512), (130, 257), (1, 512), (64, 256))
ATTN_BATCH, ATTN_HEADS = 3, 2
#: the timed sweep: each instantiation at 8 sequences x 8 heads x 512 x 512
ATTN_TIMED = dict(b=8, h=8, s_q=512, s_k=512)
ATTN_REPS = 10
#: the tuned forward's times at the batch-16 Audio-BERT layer in PERF.md
#: (fp32, bf16 ms; NVIDIA H100 80GB HBM3, 700 W; PERF.md §6's #7 rows)
ATTN_TUNED_MS = (5.471, 1.203)
#: the training stacks: configs/model/transformer.yaml's hidden 512, 4 layers,
#: at 8 heads (D 64) and 4 heads (D 128); DecoderLayer(zero_memory=False),
#: dropout 0, FFN 2,048 (the layer's default), batch 64, S = 64 latent
#: channels, a memory of 256 whose last 64 positions are zeros
ATTN_STACK = dict(hidden=512, layers=4, ffn=2048, batch=64, s=64, memory=256, pad=64,
                  steps=3, lr=1e-4)
ATTN_STACK_HEADS = (8, 4)
#: a gradient that is 0 in exact arithmetic (k_proj.bias) is held below this
#: share of the stack's largest first gradient
ATTN_ZERO_GRAD = 1e-4
#: the CPU replays the card's ReLU masks; the share of them whose own sign on
#: the CPU differs is held below this, so that the masks it borrows can part
#: from its own by rounding alone (a preactivation within an ulp of 0)
ATTN_RELU_FLIPS = 1e-6
#: TinyBERT-4L-312D's published widths (huawei-noah/TinyBERT_General_4L_312D,
#: config.json): 12 heads of 26
TINYBERT = dict(vocab_size=30522, hidden_size=312, num_hidden_layers=4,
                num_attention_heads=12, intermediate_size=1200, max_position_embeddings=512)
TINYBERT_SEQS = (0, 1, 21 * BERT_BATCH, BERT_SEQS - 1)   # card vs CPU: whole, padded, all padding
JAX_FLASH = "jax/experimental/pallas/ops/tpu/flash_attention.py"   # the installed JAX's


def attention_inputs(d, dtype, b, h, s_q, s_k, masked, g, dev):
    """Seeded (B, Sq, H, D) q, d_out and (B, Sk, H, D) k, v in ``dtype``
    (d_out fp32), and a mask: with ``masked`` "batch16" the batch-16 call's
    (``batch16_mask``), with True sequence 1 (and every third after it) its
    last third of keys padding, sequence 2 (and every third after it) all
    padding."""
    q = torch.randn((b, s_q, h, d), generator=g, device=dev).to(dtype)
    k, v = (torch.randn((b, s_k, h, d), generator=g, device=dev).to(dtype) for _ in range(2))
    d_out = torch.randn((b, s_q, h, d), generator=g, device=dev)
    mask = None
    if masked == "batch16":
        mask = batch16_mask(dev)
    elif masked:
        mask = torch.ones((b, s_k), device=dev)
        mask[1::3, 2 * s_k // 3:] = 0.0
        mask[2::3] = 0.0
    return q, k, v, mask, d_out


def attention_case(d, dtype, s_q, s_k, masked, g, dev) -> dict:
    """One instantiation at one shape: the forward (with lse) and the
    backward through the wrapper's launch functions, against the plain
    versions and fp64; the backward twice, the same bits. Returns the largest
    errors and shares of the bounds."""
    from msla_tpu_torch.ops.flash_attn import (_backward, _forward, attention_bwd_ref,
                                               attention_ref)

    scale = d ** -0.5
    q, k, v, mask, d_out = attention_inputs(d, dtype, ATTN_BATCH, ATTN_HEADS, s_q, s_k, masked,
                                            g, dev)
    out, lse = _forward(q, k, v, mask, scale, with_lse=True)
    grads = _backward(q, k, v, mask, scale, out, lse, d_out)
    again = _backward(q, k, v, mask, scale, out, lse, d_out)
    torch.cuda.synchronize()
    name = f"flash_attn {str(dtype)[6:]} D={d} Sq={s_q} Sk={s_k}{' masked' if masked else ''}"
    for a, b_, what in zip(grads, again, ("dq", "dk", "dv")):
        same_bits(f"{name} {what}", a, b_)
    bq, bk, bv, bo, bdo = (t.transpose(1, 2) for t in (q, k, v, out, d_out))
    want = attention_ref(bq, bk, bv, mask, scale).transpose(1, 2)
    want_grads = [t.transpose(1, 2) for t in attention_bwd_ref(bq, bk, bv, mask, scale, bo, lse,
                                                               bdo)]
    real = [0, 1] if masked else [0, 1, 2]   # the sequences with a real key
    result = {}
    if dtype == torch.float32:
        result["out_err"] = check_close(name, out, want)
        sub = [t[real] for t in (q, k, v, d_out)]
        m_real = None if mask is None else mask[real]
        exact, limit = attention_accumulation_bound(*sub[:3], m_real, scale)
        result["fp64_share"] = ((out[real].double() - exact).abs() / limit).max().item()
        exact_g, limits = attention_grad_bound(*sub[:3], m_real, scale, sub[3])
        result["grad_fp64_share"] = max(((g_[real].double() - e).abs() / lim).max().item()
                                        for g_, e, lim in zip(grads, exact_g, limits))
        if max(result["fp64_share"], result["grad_fp64_share"]) > 1:
            fail(f"{name}: off fp64 by {result['fp64_share']:.2f} (forward) and "
                 f"{result['grad_fp64_share']:.2f} (backward) of the 3xTF32 bounds")
        if masked:   # all padding: the mean of v, and the plain version's gradients
            check_close(name + " (all keys padding: the mean of v)", out[2],
                        v[2].mean(dim=0, keepdim=True).expand(s_q, -1, -1))
            for got, w, what in zip(grads, want_grads, ("dq", "dk", "dv")):
                check_close(f"{name} {what} (all keys padding)", got[2], w[2])
        result["grad_err"] = max((got - w).abs().max().item()
                                 for got, w in zip(grads, want_grads))
    else:
        err, limit = (out - want).abs(), attention_bound(q, k, v, mask, scale)
        if not torch.isfinite(out).all() or (err > limit).any():
            fail(f"{name}: {(err > limit).sum().item()} values beyond 2·2⁻⁹·Σ p|v| + 1e-5")
        result["out_err"] = err.max().item()
        limits = attention_bf16_grad_bound(q, k, v, mask, scale, out, lse, d_out, want_grads)
        share = 0.0
        for got, w, lim, what in zip(grads, want_grads, limits, ("dq", "dk", "dv")):
            if got.dtype != torch.bfloat16 or not torch.isfinite(got.float()).all():
                fail(f"{name} {what}: a {got.dtype} gradient, or non-finite values")
            e = (got.float() - w.float()).abs()
            share = max(share, (e / lim).max().item())
        if share > 1:
            fail(f"{name}: the bf16 backward off attention_bwd_ref by {share:.2f} of its bound")
        result["grad_share"] = share
        result["grad_err"] = max((got.float() - w.float()).abs().max().item()
                                 for got, w in zip(grads, want_grads))
    return result


def attention_instantiations(dev) -> dict:
    """Every (D, type) at ATTN_LENGTHS, masked and not (``attention_case``);
    the forward without lse equal to the one with it; D = 257 raises."""
    from msla_tpu_torch.ops.flash_attn import _forward, flash_attn

    g = torch.Generator(device=dev).manual_seed(33)
    summary = {}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            for d in ATTN_WIDTHS:
                cases = [attention_case(d, dtype, s_q, s_k, masked, g, dev)
                         for s_q, s_k in ATTN_LENGTHS for masked in (False, True)]
                q, k, v, mask, _ = attention_inputs(d, dtype, ATTN_BATCH, ATTN_HEADS, 130, 257,
                                                    True, g, dev)
                with_lse = _forward(q, k, v, mask, d ** -0.5, with_lse=True)[0]
                same_bits(f"flash_attn {dtype} D={d}: the forward with and without lse",
                          flash_attn(q, k, v, mask, d ** -0.5), with_lse)
                row = {key: max(c[key] for c in cases) for key in cases[0]}
                summary[f"{str(dtype)[6:]} D={d}"] = row
                print(f"[attention] {dtype} D={d}: {len(cases)} shapes, {row}", flush=True)
        q = torch.zeros((1, 4, 1, 257), device=dev)
        try:
            flash_attn(q, q, q, None, 0.1)
        except ValueError as e:
            if "257" not in str(e) or "256" not in str(e):
                fail(f"flash_attn at D = 257 raised without naming the width and limit: {e}")
        else:
            fail("flash_attn at D = 257 launched: no kernel takes it")
    return summary


def attention_label(key, d: int) -> str:
    """'forward[float32 D=64]', 'dq[bfloat16 D=26]', 'dkv[...]': a launch of
    #7 by its ``flash_attn.launches`` key and head width."""
    kind, dtype = ("forward", key) if isinstance(key, torch.dtype) else key
    return f"{kind}[{str(dtype)[6:]} D={d}]"


def attention_launches() -> dict:
    """#7's launches since the counts were zeroed, by ``attention_label``."""
    from msla_tpu_torch.ops.flash_attn import flash_attn

    return {attention_label(key, widths[0]): n for (key, widths), n in flash_attn.widths.items()}


def attention_timed_rows(label: str, d, dtype, b, h, s_q, s_k, masked, dev, ptxas: dict,
                         backward: bool = True) -> list[dict]:
    """The forward and (``backward``) the dQ and dK/dV kernels at one shape,
    each timed (median of ATTN_REPS, CUDA events) beside its plain version
    (the forward's; the whole plain backward) and SDPA (the forward; the
    backward of one SDPA call), with its largest error against the plain
    version, its bound, registers, spills and shared memory (the source's
    ``*_smem_bytes``, which must equal the plan's). Each backward kernel's
    bound is its share of the backward's (``backward_bound_ms``): dQ's
    product and half of the recomputed Q·Kᵀ and dO·Vᵀ (4n FLOP of 10n), and
    the query side's bytes; dK and dV's products and the other half (6n),
    and the key side's bytes and the mask; so the two add up to the
    backward's and the recomputation counts as no needed work."""
    import torch.nn.functional as F

    from msla_tpu_torch.ops import _build
    from msla_tpu_torch.ops.flash_attn import (_forward, _launch_dkv, _launch_dq,
                                               attention_bwd_ref, attention_ref,
                                               attention_shift, plan_attention)

    g = torch.Generator(device=dev).manual_seed(d)
    scale = d ** -0.5
    q, k, v, mask, d_out = attention_inputs(d, dtype, b, h, s_q, s_k, masked, g, dev)
    plan = plan_attention(d, dtype, s_q, s_k)
    bf16 = int(dtype == torch.bfloat16)
    kind, tname = str(dtype)[6:], "__nv_bfloat16" if bf16 else "float"
    no = plan.widest // 8
    smem = dict(fwd=None if plan.smem["fwd"] is None
                else _build.kernel("flash_any_smem_bytes")(bf16, d),
                dq=_build.kernel("flash_bwd_smem_bytes")(bf16, 0, d),
                dkv=_build.kernel("flash_bwd_smem_bytes")(bf16, 1, d))
    if smem != plan.smem:
        fail(f"flash_attn D={d} {kind}: the sources' shared memory {smem} is not the plan's "
             f"{plan.smem}")
    out, lse = _forward(q, k, v, mask, scale, with_lse=True)
    bq, bk, bv, bo, bdo = (t.transpose(1, 2) for t in (q, k, v, out, d_out))
    additive = None if mask is None else ((1.0 - mask) * -1e9)[:, None, None, :].to(dtype)
    es, n = q.element_size(), b * h * s_q * s_k * d
    io_q, io_k, stat = b * s_q * h * d, b * s_k * h * d, b * h * s_q * 4
    mask_bytes = 0 if mask is None else mask.numel() * 4
    flop_type = "bf16" if bf16 else "tf32"
    tuned = plan.symbol != "flash_any_fwd"
    fwd_source, fwd_kernel = (("flash_attn", f"flash_attn_kernel<{tname}>") if tuned
                              else ("flash_any", f"flash_any_kernel<{tname},{no}>"))
    base = dict(route="cuda", design=plan.design, shape=(b, h, s_q, s_k), padded=plan.padded,
                tile=(plan.fwd_tile, plan.bwd_tile), flop_type=flop_type, kernel_kind="forward",
                label=attention_label(dtype, d))
    rows = [dict(
        base, name=f"{'flash_attn' if tuned else 'flash_any_fwd'}[{kind} D={d}{label}]",
        source=f"msla_tpu_torch/csrc/{fwd_source}.cu", replaces="msla_tpu/ops/flash_attn.py:51",
        max_abs_err=(out - attention_ref(bq, bk, bv, mask, scale).transpose(1, 2)).abs().max()
        .item(),
        ms=time_ms(lambda: _forward(q, k, v, mask, scale, with_lse=False), ATTN_REPS),
        plain_ms=time_ms(lambda: attention_ref(bq, bk, bv, mask, scale), ATTN_REPS),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            bq, bk, bv, attn_mask=additive, scale=scale), ATTN_REPS),
        library_call="scaled_dot_product_attention", flop=4 * n,
        bytes=es * (io_q + 2 * io_k) + 4 * io_q + mask_bytes,
        registers=ptxas_of(ptxas, fwd_source, fwd_kernel), smem_bytes=smem["fwd"])]
    if not backward:
        return rows

    do = d_out.to(dtype).contiguous()
    shift = None if mask is None else attention_shift(mask, b, dev)
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
              None if mask is None else mask.data_ptr(),
              None if shift is None else shift.data_ptr())
    sizes = (b, h, s_q, s_k, d, scale, _build.stream_of(q))
    dkv_launches = []

    def run_dq():
        _launch_dq(bf16, common, out, do, lse, delta, dq, sizes)

    def run_dkv():
        dkv_launches.append(_launch_dkv(bf16, common, do, lse, delta, dk, dv, sizes))

    lq, lk, lv = (t.detach().clone().requires_grad_() for t in (bq, bk, bv))
    with torch.enable_grad():   # the phase times under no_grad; SDPA's backward needs a graph
        lib_out = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=additive, scale=scale)
        lib_grad = bdo.to(lib_out.dtype)
        library = time_ms(lambda: torch.autograd.grad(lib_out, (lq, lk, lv), lib_grad,
                                                      retain_graph=True), ATTN_REPS)
    ms = dict(dq=time_ms(run_dq, ATTN_REPS), dkv=time_ms(run_dkv, ATTN_REPS),
              plain=time_ms(lambda: attention_bwd_ref(bq, bk, bv, mask, scale, bo, lse, bdo),
                            ATTN_REPS),
              library=library)
    del lib_out, lq, lk, lv
    want = [t.transpose(1, 2).float()
            for t in attention_bwd_ref(bq, bk, bv, mask, scale, bo, lse, bdo)]
    errs = [(got.float() - w).abs().max().item() for got, w in zip((dq, dk, dv), want)]
    dkv_kernels = sorted((key.split("/", 1)[1] for key in ptxas   # dV's pass, then dK's
                          if key.startswith(f"flash_bwd/flash_bwd_dkv_kernel<{tname},{no},")),
                         reverse=True)
    # the whole backward's bound: 2.5x the forward's FLOP; q, dO, O, lse and
    # dq on the query side, k, v, dk, dv and the mask on the key side
    q_side, k_side = es * 3 * io_q + 4 * io_q + stat, es * 4 * io_k + mask_bytes
    whole = bound(10 * n, q_side + k_side, PEAK_FLOPS[flop_type])
    common_row = dict(base, source="msla_tpu_torch/csrc/flash_bwd.cu", plain_ms=ms["plain"],
                      library_ms=ms["library"], backward_ms=ms["dq"] + ms["dkv"],
                      backward_bound_ms=whole[0],
                      library_call="the backward of one scaled_dot_product_attention call "
                                   "(dq, dk and dv)")
    rows += [
        dict(common_row, name=f"flash_bwd_dq[{kind} D={d}{label}]", kernel_kind="dq",
             label=attention_label(("dq", dtype), d), replaces=f"{JAX_FLASH}:1287",
             max_abs_err=errs[0], ms=ms["dq"], flop=4 * n, bytes=q_side,
             registers=ptxas_of(ptxas, "flash_bwd", f"flash_bwd_dq_kernel<{tname},{no}>"),
             smem_bytes=smem["dq"]),
        dict(common_row, name=f"flash_bwd_dkv[{kind} D={d}{label}]", kernel_kind="dkv",
             label=attention_label(("dkv", dtype), d), replaces=f"{JAX_FLASH}:941",
             max_abs_err=max(errs[1:]), ms=ms["dkv"], flop=6 * n, bytes=k_side,
             registers=[ptxas_of(ptxas, "flash_bwd", kk) for kk in dkv_kernels],
             smem_bytes=smem["dkv"], launches_a_backward=dkv_launches[0])]
    return rows


def attention_sweep_rows(dev, ptxas: dict) -> list[dict]:
    """Every (D, type) instantiation timed at ATTN_TIMED, masked."""
    return [row for dtype in (torch.float32, torch.bfloat16) for d in ATTN_WIDTHS
            for row in attention_timed_rows("", d, dtype, *ATTN_TIMED.values(), True, dev,
                                            ptxas)]


def decoder_stack(heads: int, seed: int = 33):
    """ATTN_STACK's 4 DecoderLayer(zero_memory=False) at ``heads``, on the CPU."""
    from msla_tpu_torch.nn.transformer_net import DecoderLayer

    c = ATTN_STACK
    g = torch.Generator().manual_seed(seed)
    return torch.nn.ModuleList(
        DecoderLayer(c["hidden"], heads, dim_feedforward=c["ffn"], dropout=0.0,
                     zero_memory=False, generator=g, device="cpu") for _ in range(c["layers"]))


@contextlib.contextmanager
def relu_masks(masks: list, replay: bool):
    """``torch.relu`` made to record each call's mask (z > 0) into ``masks``,
    or (``replay``) to apply the recorded ones in order, z·mask, so that a
    second run takes the first's pieces of the piecewise-linear FFN; yields
    a one-element list that counts the replayed entries whose own sign
    differs (the flips)."""
    relu, pieces, flips = torch.relu, iter(masks), [0]

    def record(z):
        masks.append((z > 0).cpu())
        return relu(z)

    def apply(z):
        mask = next(pieces).to(z.device)
        flips[0] += int(((z > 0) != mask).sum().item())
        return z * mask.to(z.dtype)

    torch.relu = apply if replay else record
    try:
        yield flips
    finally:
        torch.relu = relu


def decoder_steps(stack, x, memory, target):
    """ATTN_STACK's Adam steps on ``stack``: each step's loss, the first
    step's gradients and the moves over all steps, by name."""
    from msla_tpu_torch.nn.attention import causal_mask

    c = ATTN_STACK
    mask = causal_mask(c["s"], device=x.device)
    opt = torch.optim.Adam(stack.parameters(), lr=c["lr"])
    before = {n: p.detach().clone() for n, p in stack.named_parameters()}
    first, losses = None, []
    for _ in range(c["steps"]):
        opt.zero_grad(set_to_none=True)
        out = x
        for layer in stack:
            out, _ = layer(out, memory, mask)
        loss = ((out - target) ** 2).mean()
        loss.backward()
        if first is None:
            first = {n: None if p.grad is None else p.grad.detach().clone()
                     for n, p in stack.named_parameters()}
        opt.step()
        losses.append(loss.item())
    moves = {n: p.detach() - before[n] for n, p in stack.named_parameters()}
    return losses, first, moves


def attention_training(kernels, heads: int) -> dict:
    """ATTN_STACK at ``heads`` on the card and the CPU from the same weights,
    the CPU on the card's own ReLU masks (``relu_masks``: a preactivation
    within rounding of 0 takes a token's whole term in or out of the FFN's
    gradients, and Adam's next steps carry that on), whose own sign differs
    from the card's on at most ATTN_RELU_FLIPS of them: every attention
    projection has a gradient; the cross-attention launched #7's forward, dQ
    and dK/dV exactly once a layer a step; the first gradients within atol
    1e-4 of each tensor's largest and rtol 1e-3; the moves over the 3 steps
    within 0.2·lr where the first gradient is clear of 0 (above 1e-2 of its
    tensor's largest); the losses within rtol 1e-5. A key projection's bias
    has a gradient of 0 in exact arithmetic (a softmax is unchanged by a
    constant added to a row's scores): its first gradient, card's and
    CPU's, must lie below ATTN_ZERO_GRAD of the stack's largest, and its
    moves, Adam's ±lr on rounding's sign, are not compared."""
    import copy

    from msla_tpu_torch.ops.flash_attn import flash_attn

    c = ATTN_STACK
    d = c["hidden"] // heads
    rng = np.random.default_rng(heads)
    x, target = (torch.from_numpy(rng.standard_normal((c["batch"], c["s"], c["hidden"]))
                                  .astype(np.float32)) for _ in range(2))
    memory = torch.from_numpy(rng.standard_normal((c["batch"], c["memory"], c["hidden"]))
                              .astype(np.float32))
    memory[:, c["memory"] - c["pad"]:] = 0.0
    cpu = decoder_stack(heads)
    card = copy.deepcopy(cpu).cuda()
    masks = []
    reset_counts(kernels)
    t0 = time.perf_counter()
    with relu_masks(masks, replay=False):
        card_losses, card_first, card_moves = decoder_steps(card, x.cuda(), memory.cuda(),
                                                            target.cuda())
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches, widths = dict(flash_attn.launches), dict(flash_attn.widths)
    t0 = time.perf_counter()
    with relu_masks(masks, replay=True) as flips:
        cpu_losses, cpu_first, cpu_moves = decoder_steps(cpu, x, memory, target)
    cpu_s = time.perf_counter() - t0
    relu_values = sum(m.numel() for m in masks)
    if flips[0] > ATTN_RELU_FLIPS * relu_values:
        fail(f"transformer stack at {heads} heads: {flips[0]} of {relu_values} ReLU "
             f"preactivations took another sign on the CPU than on the card, more than "
             f"{ATTN_RELU_FLIPS:g} of them")
    for name, grad in card_first.items():
        if grad is None and name.split(".")[-2] in ("q_proj", "k_proj", "v_proj"):
            fail(f"transformer stack at {heads} heads: {name}.grad is None")
        if grad is None:
            fail(f"transformer stack at {heads} heads: {name} has no gradient")
    n = c["layers"] * c["steps"]
    f32 = torch.float32
    want = {f32: n, ("dq", f32): n, ("dkv", f32): n}
    if launches != want or widths != {(key, (d,)): v for key, v in want.items()}:
        fail(f"transformer stack at {heads} heads: #7 launched {launches} ({widths}), want "
             f"{want} at D = {d}")
    largest = max(g.abs().max().item() for g in cpu_first.values())
    zero_share, shares, worst, worst_at = 0.0, {}, 0.0, None
    for name, g in cpu_first.items():
        got = card_first[name].cpu()
        if name.endswith("k_proj.bias"):
            zero_share = max(zero_share, g.abs().max().item() / largest,
                             got.abs().max().item() / largest)
            continue
        shares[name] = ((got - g).abs() / (1e-4 * g.abs().max() + 1e-3 * g.abs())).max().item()
        err = (card_moves[name].cpu() - cpu_moves[name]).abs()[g.abs() > 1e-2 * g.abs().max()]
        if err.numel() and err.max().item() / c["lr"] > worst:
            worst, worst_at = err.max().item() / c["lr"], name
    grad_share = max(shares.values())
    if zero_share > ATTN_ZERO_GRAD:
        fail(f"transformer stack at {heads} heads: a k_proj.bias gradient at {zero_share:.2e} "
             f"of the largest, where exact arithmetic gives 0")
    if grad_share > 1:
        fail(f"transformer stack at {heads} heads: the first gradients off the CPU's by "
             f"{grad_share:.2f} of atol 1e-4 of each tensor's largest + rtol 1e-3: "
             f"{sorted(shares.items(), key=lambda kv: -kv[1])[:4]}")
    if worst > 0.2:
        fail(f"transformer stack at {heads} heads: the card's moves off the CPU's by "
             f"{worst:.3f}·lr at {worst_at}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    if not all(math.isfinite(v) for v in card_losses) or loss_err > 1e-5:
        fail(f"transformer stack at {heads} heads: losses {card_losses} against {cpu_losses}")
    result = dict(heads=heads, d=d, launches=attention_launches(),
                  card_losses=card_losses, cpu_losses=cpu_losses, loss_rel_err=loss_err,
                  first_grad_share=grad_share, k_bias_grad_share=zero_share,
                  move_err_over_lr=worst, worst_move=worst_at, relu_flips=flips[0],
                  relu_values=relu_values, card_s=card_s, cpu_s=cpu_s)
    print(f"[attention] transformer stack, {heads} heads (D = {d}): {result}", flush=True)
    return result


def tinybert_serving(kernels, dev) -> dict:
    """TinyBERT-4L-312D's encoder (random weights, seed 0) over the batch-16
    fold's 352 x 512 tokens and its mask: #7 launches once a layer at (fp32,
    26), the hidden state finite, the card against the CPU on TINYBERT_SEQS
    within atol = rtol = 1e-4; the call's host and device ms."""
    from msla_tpu_torch.nn.bert import BertConfig, BertForMaskedLM
    from msla_tpu_torch.ops.flash_attn import flash_attn

    net = BertForMaskedLM(BertConfig(**TINYBERT), device=dev, seed=0)
    g = torch.Generator(device=dev).manual_seed(26)
    ids = torch.randint(0, TINYBERT["vocab_size"], (BERT_SEQS, 512), generator=g, device=dev)
    mask = batch16_mask(dev)

    def call():
        with torch.inference_mode():
            return net(ids, mask, return_mlm_hidden=True)

    reset_counts(kernels)
    t0 = time.perf_counter()
    hidden = call()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    want = {(torch.float32, (26,)): TINYBERT["num_hidden_layers"]}
    if dict(flash_attn.widths) != want or sum(flash_attn.launches.values()) != 4:
        fail(f"TinyBERT: #7 launched {dict(flash_attn.widths)}, want {want}")
    launches = attention_launches()
    if hidden.shape != (BERT_SEQS, 512, TINYBERT["hidden_size"]) or \
            not torch.isfinite(hidden).all():
        fail(f"TinyBERT: a hidden state of shape {tuple(hidden.shape)} or non-finite values")
    cpu = BertForMaskedLM(BertConfig(**TINYBERT), device="cpu")
    cpu.load_state_dict({n: t.cpu() for n, t in net.state_dict().items()})
    seqs = list(TINYBERT_SEQS)
    with torch.inference_mode():
        on_cpu = cpu(ids[seqs].cpu(), mask[seqs].cpu(), return_mlm_hidden=True)
    err = check_close("TinyBERT card vs CPU", hidden[seqs].cpu(), on_cpu)
    device_ms = time_ms(call, reps=5, warmup=1)
    result = dict(launches=launches, host_s=host_s,
                  device_ms=device_ms, card_vs_cpu_err=err)
    print(f"[attention] TinyBERT-4L-312D encoder, batch-16 fold: {result}", flush=True)
    return result


def phase_attention(kernels, dev, ptxas: dict, smi: str) -> tuple[dict, list[dict]]:
    """Phase 33: #7 at any head width D 1-256, Sq and Sk free, forward and
    backward. Every instantiation against its plain version and fp64; the
    training stacks (the F6 repair: every q/k/v projection has a gradient)
    and TinyBERT-4L-312D's encoder with the counts zeroed just before each;
    the tuned forward re-timed at the batch-16 Audio-BERT layer; every
    instantiation timed at ATTN_TIMED, and the paths' shapes. A row's
    ``launches`` are those of the run at its shape: the stacks' at the
    cross-attention rows, TinyBERT's at its layer's, 0 at the sweep's and
    the re-timed Audio-BERT layer's (no run of this phase has those
    shapes)."""
    t0 = time.perf_counter()
    checked = attention_instantiations(dev)
    checks_s = time.perf_counter() - t0
    training = {heads: attention_training(kernels, heads) for heads in ATTN_STACK_HEADS}
    serving = tinybert_serving(kernels, dev)
    launches = collections.Counter()
    for run in (*training.values(), serving):
        launches.update(run["launches"])

    def on_path(path_rows, run):
        for row in path_rows:
            row["launches"] = run["launches"].get(row["label"], 0)
        return path_rows

    with torch.no_grad():
        rows = attention_sweep_rows(dev, ptxas)
        c = ATTN_STACK
        for heads in ATTN_STACK_HEADS:   # the training stacks' cross-attention
            rows += on_path(attention_timed_rows(", cross-attention", c["hidden"] // heads,
                                                 torch.float32, c["batch"], heads, c["s"],
                                                 c["memory"], False, dev, ptxas),
                            training[heads])
        rows += on_path(attention_timed_rows(", TinyBERT layer", 26, torch.float32, BERT_SEQS,
                                             12, 512, 512, "batch16", dev, ptxas,
                                             backward=False), serving)
        tuned = [attention_timed_rows(", Audio-BERT layer", 64, dtype, BERT_SEQS, 12, 512, 512,
                                      "batch16", dev, ptxas, backward=False)[0]
                 for dtype in (torch.float32, torch.bfloat16)]
        rows += tuned
    for row, before in zip(tuned, ATTN_TUNED_MS):   # the comparison is printed, not a row's
        print(f"[attention] {row['name']}: {row['ms']:.3f} ms against PERF.md's {before} "
              f"({row['ms'] / before:.2f}x)", flush=True)
    for row in rows:
        row.setdefault("launches", 0)
    result = dict(card=smi, checks_s=checks_s, instantiations=checked, training=training,
                  tinybert=serving, launches=dict(launches))
    print(f"[attention] {smi}: {len(checked) * len(ATTN_LENGTHS) * 2} cases checked in "
          f"{checks_s:.1f} s", flush=True)
    return result, with_bounds(rows)

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card and has no CPU mode",
              file=sys.stderr)
        return 2
    from msla_tpu_torch.models.bert import AudioBertTask
    from msla_tpu_torch.models.vqvae import VQVAETask
    from msla_tpu_torch.ops import KERNELS, _build

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("torch.backends.cuda.matmul.allow_tf32 is on: the fp32 path would run in TF32")

    # 2. build
    phase = Phases()
    phase("build", _build.build_all)
    print(f"[build] {len(_build.SOURCES)} sources", flush=True)
    ptxas = ptxas_report()

    dev = torch.device("cuda")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    task = VQVAETask(**MODEL, checkpoint_dir=str(OUT_DIR),
                     codebook_file=str(OUT_DIR / "codebook.csv"), device=dev, seed=0)
    serving = [k for k in KERNELS if k.__name__ in ("conv_stem", "deconv_stem",
                                                    "nearest_codes")]

    # 3. serving kernels against their plain versions; 4. the serving path;
    # 5. CPU vs card
    report = phase("3 separation kernels", phase_kernels, task.net, dev)
    main_path = phase("4 separation path", phase_main_path, task, serving)
    agreement = phase("5 separation card vs CPU", phase_cpu_agreement, task)
    for k in report:
        k.update(path="serving", launches=main_path["launches"][k["name"]],
                 launches_per_batch64=main_path["launches_per_batch64"][k["name"]])

    # 6. training kernels; 7. gradients; 8. the training path
    train, val = synthetic_stems(TRAIN_BATCHES, seed=10), synthetic_stems(VAL_BATCHES, seed=11)
    dm = in_memory_datamodule(train, val)
    train_report = phase("6 training kernels", phase_train_kernels, task.net, dev,
                         first_batch_latents(task.net, dm, train[0]))
    gradients = phase("7 gradients", phase_gradients, task, train[0])
    training = phase("8 training path", phase_training, task, dm, KERNELS)
    for k in train_report:
        k.update(path="training", launches=training["launches"][k["name"]],
                 launches_per_step=training["launches_per_step"][k["name"]])

    # 9. Audio-BERT kernels; 10. the Audio-BERT serving path; 11. CPU vs card
    bert_task = AudioBertTask(**bert_task_args(), device=dev, seed=0)
    bert_report = phase("9 Audio-BERT kernels", phase_bert_kernels, bert_task, dev)
    bert_serving = phase("10 Audio-BERT serving path", phase_bert_serving, bert_task, task,
                         KERNELS)
    bert_agreement = phase("11 Audio-BERT card vs CPU", phase_bert_cpu_agreement, bert_task)
    for k in bert_report:
        k.update(path="audio_bert_serving", launches=bert_serving["launches"][k["name"]],
                 launches_per_call=bert_serving["launches_per_call"][k["name"]])

    # 12. the VQ measurement tools, and their kernels against their plain versions
    vq_tools, vq_tools_report = phase("12 VQ measurement variants", phase_vq_tools, KERNELS,
                                    dev)

    # 13-15. bf16 separation: kernels, the path, CPU vs card (the trained weights)
    task16 = VQVAETask(**MODEL, checkpoint_dir=str(OUT_DIR),
                       codebook_file=str(OUT_DIR / "codebook.csv"), device=dev, seed=0,
                       compute_dtype="bfloat16")
    task16.net.load_state_dict(task.net.state_dict())
    bf16_report = phase("13 bf16 separation kernels", phase_bf16_sep_kernels, task16.net, dev)
    bf16_sep = phase("14 bf16 separation path", phase_bf16_separation, task16, serving)
    bf16_sep_cpu = phase("15 bf16 separation card vs CPU", phase_bf16_separation_cpu, task16)
    for k in bf16_report:
        name = k["name"].split("[")[0]
        k.update(path="bf16_serving", launches=bf16_sep["launches"][name],
                 **{f"launches_per_batch{b}": bf16_sep[f"batch{b}"]["launches_per_batch"][name]
                    for b in BF16_BATCHES})

    # 16-18. bf16 Audio-BERT: kernels, serving over the bf16 VQ-VAE, CPU vs card
    bert16 = AudioBertTask(**bert_task_args(), device=dev, seed=0, compute_dtype="bfloat16")
    bf16_bert_report = phase("16 bf16 Audio-BERT kernels", phase_bf16_bert_kernels, bert16, dev)
    bf16_bert = phase("17 bf16 Audio-BERT serving path", phase_bf16_bert_serving, bert16,
                      task16, KERNELS)
    bf16_bert_cpu = phase("18 bf16 Audio-BERT card vs CPU", phase_bf16_bert_cpu, bert16)
    for k in bf16_bert_report:
        name = k["name"].split("[")[0]
        k.update(path="bf16_audio_bert_serving", launches=bf16_bert["launches"][name],
                 launches_per_call=bf16_bert["launches_per_call"][name])

    # 19-21. bf16 training: kernels, one step's gradients, Trainer.fit at 64 and 128
    bf16_train_report = phase("19 bf16 training kernels", phase_bf16_train_kernels, task16.net,
                              dev)
    bf16_gradients = phase("20 bf16 gradients", phase_bf16_gradients, task16, task, train[0])
    bf16_training = phase("21 bf16 training path", phase_bf16_training, task16, KERNELS,
                          training)
    # 22. the command line on the card, from WAV files on disk
    cli = phase("22 command line", phase_cli, bert_task, KERNELS, smi, training)
    for k in report + train_report + bert_report:
        k["cli_launches"] = cli["launches"].get(k["name"], 0)
    # 23. Audio-BERT training through the command line, in phase 22's project
    bert_training, bert_training_report = phase("23 Audio-BERT training", phase_bert_training,
                                                KERNELS, smi)
    # 24. the transformer stage through the command line, in phase 22's project
    transformer, transformer_report = phase("24 transformer", phase_transformer, KERNELS, smi,
                                            bert_training)
    # 25. the rest of the trainer: experiment=vqvae_slakh on phase 22's fixture,
    # accumulation, the profiler, the wire codecs, a resume from a JAX file
    rest, rest_report = phase("25 rest of the trainer", phase_rest_of_trainer, KERNELS, smi,
                              bert_task)
    # 26. K1/K1b, K2/K2b, K3, #4 and #5 at every width the sweep samples;
    # 27. the sweep through the command line
    sweep_report = phase("26 sweep widths", phase_sweep_kernels, dev, ptxas)
    sweep = phase("27 sweep", phase_sweep, KERNELS, smi)
    for k in sweep_report:
        k.update(path="sweep", launches=sweep["sweeps"]["optuna"]["launches"].get(k["name"], 0),
                 launches_smoke=sweep["sweeps"]["optuna_smoke"]["launches"].get(k["name"], 0))
    # 28. data parallelism at world size 1: NCCL in process, then the launcher
    data_parallel = phase("28 data parallel", phase_data_parallel, KERNELS, smi, dm, training)
    for k in train_report:
        k["launches_data_parallel"] = data_parallel["launches"][k["name"]]
    # 29. the model axis at world size 1: sharded state over groups of one, the launcher
    model_axis = phase("29 model axis", phase_model_axis, smi)
    for k in train_report:
        k["launches_model_axis"] = model_axis["launches"][k["name"]]
    # 30. the pipeline at one stage, the launcher; the sweep under the launcher
    pipeline = phase("30 pipeline", phase_pipeline, smi, sweep)
    # 31. the perceptual loss at the config's data, no kernel of the port
    perceptual = phase("31 perceptual loss", phase_perceptual, task, train[0], KERNELS, smi)
    # 32. the VQ-VAE's kernels at widths past the sweep's; the entry points there
    widths, widths_report = phase("32 widths", phase_widths, KERNELS, dev, ptxas, smi)
    # 33. #7 at any head width, forward and backward; training and TinyBERT through it
    attention, attention_report = phase("33 attention", phase_attention, KERNELS, dev, ptxas,
                                        smi)

    bf = str(torch.bfloat16)
    for k in bf16_train_report:
        name = k["name"].split("[")[0]
        k.update(path="bf16_training", launches=bf16_training["batch64"]["launches"][name][bf],
                 launches_batch128=bf16_training["batch128"]["launches"][name][bf],
                 launches_per_step=bf16_training["batch64"]["launches_per_step"][name])

    print(json.dumps({"card": smi, "ptxas": ptxas, "phase_s": phase.seconds,
                      "main_path": main_path, "cpu_vs_card": agreement,
                      "gradients": gradients, "training": training,
                      "audio_bert_serving": bert_serving,
                      "audio_bert_cpu_vs_card": bert_agreement, "vq_tools": vq_tools,
                      "bf16_separation": bf16_sep, "bf16_separation_cpu_vs_card": bf16_sep_cpu,
                      "bf16_audio_bert_serving": bf16_bert,
                      "bf16_audio_bert_cpu_vs_card": bf16_bert_cpu,
                      "bf16_gradients": bf16_gradients, "bf16_training": bf16_training,
                      "cli": cli, "bert_training": bert_training,
                      "transformer": transformer, "rest_of_trainer": rest,
                      "sweep": sweep, "data_parallel": data_parallel,
                      "model_axis": model_axis, "pipeline": pipeline,
                      "perceptual": perceptual, "widths": widths,
                      "attention": attention}),
          flush=True)
    kernels_line = (report + train_report + bert_report + vq_tools_report + bf16_report
                    + bf16_bert_report + bf16_train_report + bert_training_report
                    + transformer_report + rest_report + sweep_report + widths_report
                    + attention_report)
    for k in kernels_line:   # phase 30's fp32 launches: the pipelined BERT group's
        k["launches_pipeline"] = pipeline["launches"].get(k["name"], 0)
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def attention_only() -> int:
    """``chip_smoke.py --attention``: the build and phase 33 alone, for work
    on #7; prints phase 33's result and rows."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from msla_tpu_torch.ops import KERNELS, _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase = Phases()
    phase("build", _build.build_all)
    result, rows = phase("33 attention", phase_attention, KERNELS, torch.device("cuda"),
                         ptxas_report(), smi)
    print(json.dumps({"attention": result, "phase_s": phase.seconds}, default=str), flush=True)
    print(json.dumps({"kernels": rows}, default=str), flush=True)
    return 0


def widths_only() -> int:
    """``chip_smoke.py --widths``: the build and phase 32 alone, for work on
    the any-width kernels; prints phase 32's result and rows."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from msla_tpu_torch.ops import KERNELS, _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    phase = Phases()
    phase("build", _build.build_all)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    result, rows = phase("32 widths", phase_widths, KERNELS, torch.device("cuda"),
                         ptxas_report(), smi)
    print(json.dumps({"widths": result, "phase_s": phase.seconds}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 2 and sys.argv[1] == WIDTHS_FLAG:
        sys.exit(widths_only())
    if len(sys.argv) == 2 and sys.argv[1] == ATTENTION_FLAG:
        sys.exit(attention_only())
    if len(sys.argv) == 3 and sys.argv[1] == MODEL_AXIS_FLAG:
        sys.exit(model_axis_rank(Path(sys.argv[2])))
    if len(sys.argv) == 3 and sys.argv[1] == PIPELINE_FLAG:
        sys.exit(pipeline_rank(Path(sys.argv[2])))
    sys.exit(main())
