#!/usr/bin/env python
"""Drive the PyTorch port's serving paths, train steps, trainers and
evaluation once on one CUDA card.

  python3 chip_smoke.py

Phases, one JSON line each; any failure raises, so the script exits non-zero
before the last line:

1. device   — needs torch.cuda; the card's name and power limit.
2. build    — nvcc builds mds_tpu_torch/csrc/*.cu for sm_90a, one process
              per source; cuobjdump's SASS of the library must show HGMMA
              (warpgroup MMA) and no HMMA (mma.sync) in the conv3,
              detail-tail, S1-pair (kernel 3), detail-head (4), 3×3 stem
              (kernels 1 and 2), StemBlock (5) and 7×7 stem (6) kernels.
3. kernels  — each stem kernel at the serving shapes (B=1, 1024×2048; the
              7×7 stem of BiSeNetV1 at O=64; the single 3×3 stem and its
              window variant at O=64 and 16, the window variant bit-equal
              to the single stem, both with a bit-equal share >= 0.999 and
              timed warm on their packed table, cold packing in the call
              and by the profiler's device time) against its plain PyTorch
              version on the card (TF32 off), rel max-diff < 1e-2, times as
              the median of 20 CUDA-event runs; beside the single 3×3, its
              window variant and the 7×7 stems, one bf16 F.conv2d with the
              folded weight and bias (no ReLU) as the library's time; the
              7×7 and the 3×3 stems (with the f32 training form) also on
              ragged tiles, B > 1 and O from 8 to 128, the StemBlock at B =
              2 with H/4 and W/4 off its strips and at H = W = 4; the S1
              pair (kernel 3), the fused detail head (4), the StemBlock (5)
              and the 7×7 stem (6) warm on their weights packed once (the
              warm output equal to the cold one), cold packing in the call
              and by their device time, each with its bit-equal share
              (>= 0.999 for 5 and 6 at the frame). Then the kernels of
              BiSeNetV2's routes at the inputs one served frame gives them
              (captured from the model): the 16 depthwise convs through
              depthwise3x3 (bit-equal share >= 0.999 and rel < 1e-2 against
              the plain version; each shape's device time beside that of
              the library's bf16 grouped F.conv2d), the 10 stride-1 ones
              through
              depthwise3x3_dma (also bit-equal to depthwise3x3; kernel 9's
              device time beside its own at each shape), the head
              logits (1, 19, 128, 256) through upsample_argmax (label
              agreement >= 0.9999, differing pixels and its device time
              printed), the /4 detail feature (1, 64, 256, 512)
              through detail_tail_fused, and DetailBranch S1_2's input
              (1, 64, 512, 1024) of a frame on the window-stem + conv3 route
              through conv3x3_bn_relu (both rel < 1e-2, bit-equal share
              printed; each timed cold, packing its weights, and warm, on
              the model's packed weights, and its own device time read by
              torch.profiler); beside each, the library's bf16 grouped F.conv2d
              and the port's library route, the interpolate + argmax chain,
              the plain route's five ConvBNReLU modules, or one bf16
              F.conv2d with the folded weight and bias; then the depthwise,
              upsample, S1-pair, tail and conv3 kernels on ragged shapes
              (odd tiles, B > 1, the depthwise kernel's staged form at m =
              2, 3, 4 and 6, the DMA kernel's TMA form with windows off
              every side of the image, more tiles than one persistent pass,
              B = 3 and f32, and its masked form at C % 8 != 0 -- each
              bit-equal to the plain version and to depthwise3x3 --, the
              upsample at s = 1-8 and C = 1-150 in bf16
              and f32, conv3 at C_in 3-64 and C_out 8-136).
4. dropout  — the dropout kernel at the main head's shape (16, 1024, 64,
              128) bf16 channels_last, rate 0.1: bit-identical to its plain
              version, keep fraction within 0.002 of 230/256, kept values
              scaled by bf16(256/230), masks fixed by the seed, and the
              backward's mask the forward's; at element offsets 1, 2, 3
              and half the tensor, bit-identical to the plain version, the
              second half at its offset equal to the whole draw's rows
              (timed at offset 1 too); torch.native_dropout at the
              same rate as the library's time.
5. slice    — BiSeNetV2 (configs/bisenetv2_city.json: 19 classes, bf16,
              seeded weights, random BN stats) behind the port's HTTP server
              on 127.0.0.1 answers 3 requests of 1024×2048 uint8 frames with
              every deploy route on (stem kernel, detail fusion and tail,
              depthwise kernel, fused pred); then one E2EModel call on the
              stem-kernel route alone and one on it with the window stem and
              the conv3 kernel. The kernel launch counts of that run are
              read (per request 16 depthwise3x3 and 1 each of
              detail_s1s2_fused, stemblock_fused, detail_tail_fused and
              upsample_argmax; 2 stem_conv_bn_relu_s2 on the stem route; 2
              stem_conv_bn_relu_s2_window and 1 conv3x3_bn_relu on the
              window-stem + conv3 route), and the label maps are held
              against the same model on the plain path (library ops): the
              served ones against its head logits put through the fused
              tail's plain version, the stem routes' against its labels,
              agreement > 0.995; logits rel max-diff < 2e-2 on every route.
              E2EModel time per frame on all routes, all routes but the
              tail, the fused stem routes alone (stem kernel, detail
              fusion), the stem route, the window-stem + conv3 route and the
              plain path in turns; one profiled frame on each.
6. v1_slice — BiSeNetV1 (configs/bisenetv1_city.json: 19 classes, no aux
              heads, bf16, seeded weights, random BN stats), built by
              tools/serve_torch.py's build_e2e, behind the port's HTTP
              server on 127.0.0.1 with set_stem_impl("kernel") answers 3
              requests of 1024×2048 uint8 frames: 2 stem-7 launches per
              frame and no other stem kernel's; every label map against the
              same model on the plain path (agreement > 0.995, logits rel
              < 2e-2); E2EModel time per frame with the kernel and on the
              plain path (CUDA events, median of 10, in turns); one frame
              of each route under torch.profiler (idle share, device
              launches, time by kernel, the stem kernel's device time).
7. train    — the train step (BiSeNetV2 with aux heads, bf16, the config's
              SGD and warmup-poly LR) at batch 16 of 512×1024 uint8 images:
              2 warm-up steps, 5 timed ones (CUDA events, median), finite
              losses, parameters and BN stats moved, 10 dropout launches per
              step and no stem-kernel launch (the fused routes are eval-only);
              the dropout kernel's bound for a step (its 10 calls' inputs
              read and outputs written once, over 3.35 TB/s); one more
              step under torch.profiler gives the idle share and the
              dropout kernel's device time. Then the step with
              train.fused_up_loss (each head's OHEM CE through the phase
              decomposition of its upsample) from the same weights, batch
              and dropout seed: first loss within 1e-2 (relative) of the
              plain route's; both routes' step ms (median of 3) and peak
              memory in turns plain, fused, fused, plain; then, at every
              head's logits of the batch scaled to a trained head's spread
              (std 3) with 5% of the labels ignored, the phase-decomposed
              CE against the CE of F.interpolate's upsample: the valid
              pixels' CE as sorted multisets (rel <= 1e-5) and the gradient
              of their sum wrt the logits (rel <= 1e-4).
8. trainer  — tools/train_torch.py's main in this process, on
              configs/bisenetv2_city.json with the Synthetic reader at
              1024×2048 (19 classes, 64 frames) and lr.max_iter 6,
              train.ckpt_interval 3, train.log_interval 1: 6 steps of bs16
              512×1024 crops with finite losses, checkpoints at 3 and 6, a
              fresh Trainer restoring step 6 (state_dict, momentum, count
              equal), --max-iter 8 resuming to 8; exactly 10 dropout_u8
              launches a step and no other kernel's; the loader's pipeline
              (native or numpy), step ms (CUDA events), images/s by the step,
              by the loop (steps 2-6: all their images over the sum of
              their iterations' host ms) and by the run's wall, the ms
              waited on the loader and on the H2D copy a step, the ms of a
              checkpoint save, peak memory.
9. eval     — tools/evaluate_torch.py's main in this process on the card,
              configs/bisenetv2_city.json with the Synthetic reader at
              1024×2048 (19 classes), eval_ims_per_gpu 1: the served
              model's weights (WEIGHT_SEED, random BN stats, its aux heads at
              their seeded init) saved through engine/checkpoints.py and
              restored by --ckpt. Modes ss and ssc on 4 frames, msf and mscf
              on 3, each on the served route without the pred tail (stem
              kernel, detail fusion and tail, depthwise kernel) and on the
              plain path in turns: the share of pixels whose predictions
              agree > 0.995 (each frame's printed), more than one class
              predicted; on each mode's 4 largest calls (msf's 1792×3584
              frames, mscf's 25 windows), the logits routed against plain
              rel < 2e-2 (over the batch and its worst image) and every
              kernel call of that forward against its plain version
              rel < 1e-2; exactly 1
              detail_s1s2_fused, stemblock_fused and detail_tail_fused and 16
              depthwise3x3 launches a forward (1 forward a frame in ss and
              ssc, 12 in msf, 12 batched calls in mscf: up to 25 windows of
              512×1024 and their flips), no other kernel's, none on the
              plain path; per-frame seconds (CUDA events a batch, median of
              the warm frames), peak memory. BiSeNetV1
              (configs/bisenetv1_city.json) in ss on 2 frames with
              set_stem_impl("kernel") against plain: agreement > 0.995, 2
              stem7_conv_bn_relu_s2 launches a forward. --precise-bn 2 on
              the plain ss path: every BN stat finite and moved, the model
              in eval mode, 10 dropout_u8 launches (5 heads a batch, forward
              only); then precise BN at (2, 3, 128, 256) f32, TF32 and
              dropout off, the card's stats against the CPU's (max-diff over
              the larger of the tensor's and its starting stats' largest
              magnitude < 1e-4).
10. flagship — configs/ltbgnn_3_datasets_snp.json (snp_rn18 + the BGNN,
              3 datasets of 11, 19 and 36 classes, M = 52 unified classes)
              at full width in bf16, each dataset on the Synthetic reader at
              1024×2048, crops of 768×768, 4 a dataset, with
              set_stem_impl("kernel"): train_from_config with gnn=True
              (what tools/train_torch.py --gnn calls, here with
              compute_dtype bf16) runs 2 GNN steps, the UOT switch, 2 SEG
              steps, the re-entry and 2 GNN steps (checkpoints at 3 and
              6): finite losses, exactly 9 kernel-6 launches a GNN step (3
              datasets × 3 pyramid levels of the frozen seg net) and none a
              SEG step, each UOT graph one row a column and every dataset
              class a column, gnn_lr_scale max(0.1, 1 − 2/6); a fresh
              trainer restores step 6 exactly (both nets, both AdamW
              states, βs, graphs, the stage machine); one GNN step's frozen
              features routed against plain (rel < 2e-2) and its 9 kernel-6
              calls against their plain version (rel < 1e-2, bit-equal
              share >= 0.999); the SEG step alone on one fixed batch, 5
              timed steps after a warm one, and its peak memory.
              tools/serve_torch.py's build_e2e on the checkpoint's seg
              weights (its UOT graphs) answers 2 requests of 1024×2048
              frames: 3 kernel-6 launches each, labels against the plain path
              (> 0.995), logits rel < 2e-2 and each kernel-6 call against its
              plain version; E2EModel ms and one profiled frame each way.
              tools/evaluate_torch.py on the checkpoint in contrast and ss on
              2 Synthetic frames a dataset, routed and plain, as the eval
              phase holds them (3 kernel-6 launches a forward; the labels'
              agreement printed, not gated: the random model's ties on the
              frames' flat blocks). The GNN step's ms (median of the loop's
              GNN steps after the first), the SEG step's (median of the 5
              alone; the loop's one warm SEG step printed beside it), SEG
              images/s, the UOT switch ms and peak memory.
11. flagship7 — configs/ltbgnn_7_datasets_snp_train_tg.json (snp_rn18 +
              the direct BGNN its GNN name builds; 7 datasets of 19, 64,
              37, 19, 26, 150 and 133 classes, M = 358) at full width in
              bf16, the config's 4 crops of 768×768 a dataset of Synthetic
              1024×2048 frames, kernel 6 on: train_from_config with
              gnn=True takes GNN, GNN, the UOT switch, SEG, SEG (a
              checkpoint at 4): finite losses, 21 kernel-6 launches a GNN
              step (7 datasets × 3 levels) and none a SEG step, each UOT
              graph (c, 358) one row a column and a column a row, a fresh
              trainer restoring step 4 exactly; one GNN step's frozen
              features routed against plain (rel < 2e-2) and its 21 kernel-6
              calls against their plain version (rel < 1e-2); the GNN and
              the SEG step alone on one fixed batch (3 timed after a warm
              one, CUDA events), SEG images/s, the switch ms, peak memory.
12. graph_forks — at full width in bf16 through train_from_config (GNN,
              the switch, SEG; the config's crops, Synthetic frames, kernel
              6 on): configs/ltbgnn_3_datasets_gat.json's BGAT (512×1024,
              64 + 51 nodes) and configs/ltbgnn_3_datasets_snp.json with
              one override a run: the cosine BGNN, GNN.mse_or_adv adv,
              GNN.GumbelSoftmax, GNN.use_km, the sfg fork; 9 kernel-6
              launches in the GNN step and none in the SEG step, valid
              graphs (KM leaves the βs), each fork's options. Then one f32
              GNN step of the cosine, BGAT, direct_full, adv and Gumbel
              forks at test width (TEST_WIDTH) on the card and on the CPU
              from the same init, generator and Gumbel noise (drawn on the
              CPU), dropout 0, TF32 off: loss rel < 1e-4, per-group
              gradient cosine > 0.9999, parameters after the step rel < 1e-4.
13. clip    — configs/clip_5_datasets.json (train.mode clip: 5 datasets,
              M = 90) at full width in bf16, the config's 2 crops of
              512×1024 a dataset: train_from_config takes 4 SEG steps
              against the frozen text prototypes (each its seeded value
              times Π(1 − lr_t·wd) within f32 rounding, PROTO_GATE; the
              backbone moves; no kernel launch); tools/evaluate_torch.py
              --mode clip on its checkpoint, routed (kernel 6 three times a
              forward, the largest calls' logits and kernel calls against
              plain) and plain, 2 frames a dataset; SEG step ms, peak memory.
14. contrast — configs/bisenetv2_contrast_3ds.json (BiSeNetV2Contrast: 46
              unified classes, proj_dim 256, a bank of 46 × 64 × 256, the
              EMA teacher) at full width in bf16, each dataset on the
              Synthetic reader at 1024×2048 with its own class count (19,
              11, 36), the config's crops of 512×1024, 1 + 1 + 2:
              tools/train_torch.py's main for 6 steps (checkpoints at 3
              and 6), a fresh trainer restoring step 6 exactly (student,
              SGD state, teacher, bank), --max-iter 8 resuming to 8;
              exactly 30 dropout launches a step (5 heads × 3 datasets,
              forward and backward) and no other kernel's; step ms (CUDA
              events, median after the first), images/s, the teacher's
              (EMA and forward) and the bank pushes' ms, peak memory; then
              the step on one fixed batch of those crops (5 timed after 2
              warm, one under torch.profiler: idle share, launches). One
              f32 step at 4 crops of 64×128 a dataset on the card and on
              the CPU (TF32 off, same init, generator seed and anchor
              noise): loss rel < 1e-4, per-group gradient cosine > 0.9999,
              parameters, teacher (per group) and bank rel < 1e-4.
              tools/evaluate_torch.py on the checkpoint in contrast and
              emb, 2 Synthetic frames a dataset, routed (kernels 4, 5, 7
              once and 9 16 times a forward) and plain, gated as the eval
              phase gates them (the labels' agreement printed, not gated:
              the random model ties on the frames' flat blocks).
15. mulbn   — snp_rn18_mulbn (configs/ltbgnn_3_datasets_snp.json with
              model_name snp_rn18_mulbn: a BN stat set and affine for each
              dataset) at full width in bf16, the config's 4 crops of
              768×768 a dataset of Synthetic 1024×2048 frames, kernel 6 on:
              train_from_config with gnn=True takes a GNN step, the UOT
              switch and a SEG step (the checkpoint at 2): 9 kernel-6
              launches in the GNN step, none in the SEG step, valid graphs;
              one GNN step's frozen features routed against plain and its 9
              kernel-6 calls (each dataset's input with its own set's fold,
              cached per (level, dataset)) against their plain version (rel
              < 1e-2, bit-equal share >= 0.999); the GNN and the SEG step
              alone on one fixed batch (3 timed after a warm one) and their
              peak memory; a served frame (3 kernel-6 launches) with its
              logits and kernel calls against plain; tools/evaluate_torch.py
              --mode uni on the checkpoint, routed and plain; one f32 SEG
              step at test width on the card and on the CPU: loss rel <
              1e-4, per-group gradient cosine > 0.9999, parameters and the
              running stats of every (level or set, dataset) rel < 1e-4.
16. audit   — tools/find_unuse_torch.py on mulbn's checkpoint over 2
              Synthetic frames a dataset with kernel 6 on (3 launches a
              forward, two passes): each dataset's used slots, the audit's
              seconds, the .npz whose target_bipart_i is (n_cats_i, 52)
              with entries in {0, 1, 255}; tools/print_bigraph_torch.py on
              the same checkpoint: valid graphs.
17. contrast_multiproto — configs/bisenetv2_contrast_3ds.json with
              contrast.num_prototype 4 and lr.warmup_iters 2, at full width
              in bf16, crops of 512×1024, 1 + 1 + 2: tools/train_torch.py's
              main for 6 steps (the OHEM seg loss in steps 0-1,
              seg_mul_loss from step 2): 30 dropout launches in a warmup
              step, 18 after (the aux heads' losses leave the backward),
              step and prototype_learning ms (CUDA events), peak memory, a
              fresh trainer restoring step 6 and its prototypes exactly;
              every dropout call of one more step against its plain
              version bit for bit; one f32 step after the warmup on the
              card and on the CPU (same init, prototypes, generator: the
              dropout seeds, then the Gumbel noise drawn on the CPU):
              loss rel < 1e-4, per-group gradient cosine > 0.9999,
              parameters, teacher, bank and prototypes rel < 1e-4, each
              side's EMA residual < 1e-6; tools/evaluate_torch.py --mode
              dsg and emb on the checkpoint, routed (kernels 4, 5, 7 once
              and 9 16 times a forward) and plain. The Synthetic reader has
              no ann lists, so dsg's stage-2 lists are checked on the CPU
              (tests/test_torch_data_stage.py).
18. hrnet   — HRNet-W48 (configs/hrnet_w48_city.json: 1 dataset, 19
              classes, D = 720) at full width in bf16, seeded weights,
              random BN statistics, the identity-start graphs of
              pretrain_bipartite_graphs, built by tools/serve_torch.py's
              build_e2e: behind the HTTP server with set_stem_impl("kernel")
              3 requests of 1024×2048 uint8 frames, exactly one
              stem_conv_bn_relu_s2 (kernel 1) launch each and no other
              kernel's; the labels against the plain path (printed); one
              frame's eval logits, routed and plain, each against the f32
              model's: the route's distance at most F32_RATIO_GATE (1.25)
              times the plain path's (not rel < 2e-2 against plain: on
              random weights a 1-ulp change at the stem grows through ~100
              bf16 layers to 0.0285 from plain, while from f32 the route is
              no farther than plain; the argmax agreements are printed),
              and its kernel-1 call against its plain version (rel < 1e-2,
              bit-equal share >= 0.999);
              E2EModel ms in turns (kernel, plain, plain, kernel), HTTP
              ms, one profiled frame each way (idle share, launches), peak
              memory. configs/gnn_city_cam_a2d2.json (hrnet_w48_gnn, 3
              datasets of 19, 11, 36 classes, M = 52, D = 512): one frame a
              dataset, each with one kernel-1 launch whose folded scale and
              bias are that dataset's own. tools/evaluate_torch.py --mode
              ss on a checkpoint of the served weights, 2 Synthetic frames,
              routed (one kernel-1 launch a forward) and plain, the
              largest call's logits under the same f32 ratio gate. One f32
              train-mode forward and backward at test width
              (HRNET_TEST_STAGES, 2 datasets, aux prototypes, 4 × 256² a
              dataset) on the card and on the CPU: outputs and running
              stats rel < 1e-4; each parameter's gradient cosine with the
              CPU's > 0.9999, or else the card's f32 gradient within twice
              the CPU's f32 distance (1 − cosine) from the CPU's f64 one.
19. swin    — BiSeNetV1Swin (19 classes, no aux heads) in bf16 at
              896×1792 (Swin-T wants multiples of 224), seeded weights,
              random BN statistics, in an E2EModel with
              set_stem_impl("kernel"): 3 frames, exactly one
              stem7_conv_bn_relu_s2 (kernel 6: the SpatialPath's 7×7 stem)
              launch each; labels against plain (printed), one frame's
              logits against plain (< 2e-2, > 0.995) and its kernel-6 call
              against its plain version (< 1e-2, bit-equal >= 0.999);
              E2EModel ms in turns, one profiled frame, peak memory; one
              f32 train-mode forward at 224×224 with the aux heads, card
              against CPU: every output rel < 1e-4.
20. loss_library — in f32 on the card against the CPU (value rel < 1e-4,
              every gradient's cosine > 0.9999, or else the card's
              gradient within twice the CPU's f32 distance from the CPU's
              f64 one: AAF's edge weights sum ~2.5 M pairs with heavy
              cancellation) and timed on the card (CUDA
              events, value and gradient): rmi_loss, lovasz_softmax,
              boundary_aware_focal_loss, AAFLoss (with its edge and
              not-edge weights), fs_ce, FSCELoss, FSOhemCELoss, FSAuxCELoss,
              FSRMILoss, FSAuxRMILoss, FSCELOVASZLoss and SegFixLoss on
              logits of (8, 19, 128, 256) with 5% of the labels ignored;
              pairwise_soft_dtw (64 × 19 sequences of 32 × 16); k-means,
              euclidean and cosine, at N = 65536, D = 256, K = 19 from one
              set of initial indices: one Lloyd iteration card against
              CPU (centers rel < 1e-4, assignments agreeing on >= 0.999),
              and the 20-iteration result's assignment the CPU's argmin of
              the distances to its centers (>= 0.999: Lloyd's iterations
              from random indices split clusters, whose points then sit
              near ties, so the two devices' 20-iteration runs part); and
              20 iterations from one index in each blob, where both
              devices converge to the same centers, card against CPU
              (centers rel < 1e-4, assignments equal);
              CrossDatasetsCELossKMeans at
              configs/bisenetv2_contrast_3ds.json's class counts (a warmup
              call, then a main-phase one: loss, gradients, bank and
              prototypes).
21. v1_train — BiSeNetV1's train step (configs/bisenetv1_city.json: bs16
              512×1024, bf16, aux heads, SGD) on a fixed batch, plain and
              train.fused_up_loss in turns (plain, fused, fused, plain; 5
              timed steps each): step ms, images/s, peak memory, launches
              (none: kernel 6 is eval-only), one profiled step of each
              route (idle share); one f32 step (4, 64, 128) on
              the card against the CPU (loss rel < 1e-4, per-group gradient
              cosine > 0.9999, parameters < 1e-4) and precise BN over 2
              batches of (4, 3, 128, 256), card against CPU (< 1e-4).
22. train_stem — the same train step with set_stem_impl("kernel"): the two
              RGB stems' convs (DetailBranch S1_1, StemBlock conv) run
              stem_conv3x3_s2 (kernel 1 forward, the library conv's
              gradients backward). From one set of weights and one batch, a
              step on the plain route and 2 on the kernel route: exactly 2
              stem_conv3x3_s2 launches a step, the first step's loss within
              1e-2 (relative) of the plain route's; the Function's f32
              output at the steps' inputs against its plain version (rel <=
              1e-4) and, with dx and dk, against the library conv on the
              card (rel < 1e-2); timed warm on the layer's packed table,
              cold and by the profiler's device time, beside its plain
              version, f32 F.conv2d (TF32 off: the same function) and bf16
              F.conv2d.
23. parity  — one f32 train step at (4, 64, 128) with dropout on, TF32 off,
              on the card (dropout kernel) and on the CPU (its plain
              version), same weights and generator seed: loss rel < 1e-4,
              per-group gradient cosine > 0.9999, parameters after the step
              rel < 1e-4; and PyTorch's avg_pool2d backward on a
              channels_last input, card against CPU, raw and through the
              port's pool (which must agree to 1e-5).
24. parallel — the parallel layer (mds_tpu_torch/parallel/) in child
              processes of this script that load the library built above
              (a child's failure or timeout fails the phase):
              NCCL at world 1: BiSeNetV2's train step (the config's bs16
              512×1024, bf16, aux heads) with no group, then under a
              world-1 NCCL group in SyncBN and in local BN, each against
              the no-group step (loss and parameters rel < NCCL_GATE),
              step ms (median of 5), collectives a step;
              gloo, two ranks on the one card (NCCL refuses two ranks on
              one device): the SyncBN f32 step on 2 + 2 crops of 512×1024,
              dropout on, against this process's world-1 step on the 4
              (loss rel < 1e-4, per-group gradient cosine > 0.9999,
              parameters and running stats rel < 1e-4); each rank's
              kernel-12 masks in a data-parallel step bit-equal to its rows
              of the world-1 masks; the bf16 step at 8 + 8 (median of 5);
              ss eval of 8 Synthetic 1024×2048 frames on the deploy routes
              (kernels 4, 5, 7, 9), each rank its half, against world 1
              (pixel count equal, mIoU within 1e-3, differing predictions
              printed); BiSeNetV2's tiled inference of a 1024×2048 frame
              on the deploy routes (2 tiles, margin 96: a tile a rank)
              against world 1 with n_tiles=2 (logits rel < 1e-2, labels
              agreeing >= 0.999; each tile kernel's calls against their
              plain version, rel < 1e-2; agreement with the whole frame
              printed); the
              halo conv on a W-sharded (1, 64, 512, 1024) f32 tensor
              against the unsharded conv (rel < 1e-5).
25. parallel_trainers — the alternating and contrast trainers at world
              size > 1, in child processes as in 24:
              NCCL at world 1: the flagship (configs/ltbgnn_3_datasets_snp
              .json at full width, bf16, 4 crops of 768×768 a dataset,
              kernel 6 on) through one GNN step, the UOT switch and one SEG
              step, and the contrast config (full width, f32, 1 + 1 + 2
              crops of 512×1024; the bf16 backward is not deterministic on
              the card) through two steps, with no group and under the
              group, from the same seeded init and batch, each step from
              the same state (loss, parameters, teacher and bank under the
              group within NCCL_GATE of no group); kernel 6 9 times a GNN
              step, each call against its plain version (rel < 1e-2),
              kernel 12 30 times a contrast step; step ms (3 timed alone;
              the contrast step's in bf16 after one untimed), collectives
              a step;
              gloo, two ranks on the one card, f32: snp_rn18_mulbn at test
              width (GNN step, switch, SEG step; 2 + 2 crops of 64×64 a
              dataset, the halves apart) and the contrast config at P = 1
              (a step each side of the warmup) and 4 (the step after it;
              2 + 2 crops of 64×128, teacher momentum 0.9), each against
              this process's world-1 run on the 4, each step from world
              1's state before it (loss rel < 1e-4, per-group gradient
              cosine > 0.9999, parameters, running stats, teacher, bank
              and prototypes rel < 1e-4, the AdamW step's parameters where
              its gradients agree (PT_ADAM_*), the others within 2·lr;
              UOT graphs and bank pointers
              equal); each rank's kernel-12 masks, call by call, bit-equal
              to its rows of the world-1 call's; a bf16 GNN step at test
              width with kernel 6 on, each of its 6 calls against the
              plain version (rel < 1e-2).

Then a {"phase_seconds": {...}} line (each phase's wall seconds), a
{"kernels": [...]} line, the nvidia-smi name/power-limit line, and as the
last line {"ok": true, "device": {...}}.
"""

import contextlib
import copy
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

H, W = 1024, 2048
ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "bisenetv2_city.json")
V1_CONFIG = os.path.join(ROOT, "configs", "bisenetv1_city.json")
KERNEL_GATE = 1e-2     # rel max-diff, kernel vs its plain version
ARGMAX_GATE = 0.995    # bench.py:296-297
LOGITS_GATE = 2e-2
# Where the logits are cosines (the contrast family's, snp_rn18's clip
# head), both bf16 paths sit 0.011-0.020 from the model in f32 on the H100:
# the route is gated on its distance from f32 over the plain path's. The
# readings (20 calls of clip, 24 of the contrast family's dsg and emb) put
# it at 0.66-1.16 of the plain path's.
F32_RATIO_GATE = 1.25
# A random model's argmax agreement between two bf16 paths depends on how
# many of its pixels sit within rounding noise of a tie between classes.
# Measured on an H100 (700 W) at 1024×2048 over init seeds 0-7 (BN seed =
# init seed + 1): seeds 0, 3 and 7 agreed on 0.979-0.991 of the pixels, the
# other five on more than 0.9996; seed 0's logits still agreed to rel
# 0.012. The smoke model uses seed 1.
WEIGHT_SEED = 1
# The same holds for BiSeNetV1, where the two 7×7 stems of the kernel route
# round once after conv, BN and ReLU and the plain path three times.
# tools/v1_seed_scan_torch.py on an H100 (700 W), 1024×2048, the v1_slice
# phase's first frame, init seeds 0-5 (BN seed = init seed + 1): seed 0
# agreed on 0.9937 of the pixels at logits rel 0.0201, seed 3 on 0.9855, and
# seed 4's logits lay at rel 0.0227, each past a gate; seeds 1, 2 and 5
# passed (0.9990-0.9997, rel 0.0148-0.0170).
V1_WEIGHT_SEED = 2
SOURCES = {
    "stem_conv_bn_relu_s2": ("mds_tpu_torch/csrc/stem.cu",
                             "mds_tpu/ops/pallas/stem.py:143"),
    "stem_conv_bn_relu_s2_window": ("mds_tpu_torch/csrc/stem.cu",
                                    "mds_tpu/ops/pallas/stem.py:265"),
    "stem_s1_pair_fused": ("mds_tpu_torch/csrc/stem.cu",
                           "mds_tpu/ops/pallas/stem.py:408"),
    "detail_s1s2_fused": ("mds_tpu_torch/csrc/stem.cu",
                          "mds_tpu/ops/pallas/stem.py:582"),
    "stemblock_fused": ("mds_tpu_torch/csrc/stem.cu",
                        "mds_tpu/ops/pallas/stem.py:775"),
    "dropout_u8": ("mds_tpu_torch/csrc/dropout.cu",
                   "mds_tpu/ops/pallas/dropout.py:54"),
    "stem7_conv_bn_relu_s2": ("mds_tpu_torch/csrc/stem7.cu",
                              "mds_tpu/ops/pallas/stem.py:911"),
    "depthwise3x3": ("mds_tpu_torch/csrc/depthwise.cu",
                     "mds_tpu/ops/pallas/depthwise.py:112"),
    "depthwise3x3_dma": ("mds_tpu_torch/csrc/depthwise.cu",
                         "mds_tpu/ops/pallas/depthwise_dma.py:44"),
    "upsample_argmax": ("mds_tpu_torch/csrc/upsample_argmax.cu",
                        "mds_tpu/ops/pallas/upsample_argmax.py:76"),
    "detail_tail_fused": ("mds_tpu_torch/csrc/detail_tail.cu",
                          "mds_tpu/ops/pallas/stem.py:1148"),
    "conv3x3_bn_relu": ("mds_tpu_torch/csrc/conv3x3.cu",
                        "mds_tpu/ops/pallas/conv3x3.py:69"),
    # kernel 1's training form (a custom_vjp over _stem_fwd)
    "stem_conv3x3_s2": ("mds_tpu_torch/csrc/stem.cu",
                        "mds_tpu/ops/pallas/stem.py:1235"),
}
# the kernels that run warpgroup MMA (csrc/wgmma.cuh): their SASS must show
# HGMMA and no HMMA (stem_kernel: kernels 1 and 2; pair_kernel: 3;
# detail_head_kernel: 4; stemblock_kernel: 5; stem7_kernel: 6)
WGMMA_KERNELS = ("conv3x3_kernel", "detail_tail_kernel", "stem_kernel", "pair_kernel",
                 "detail_head_kernel", "stemblock_kernel", "stem7_kernel")
# one H100 SXM (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12  # CUDA cores, outside the tensor cores
# the share of a depthwise kernel's outputs that must equal its plain
# version's bit for bit (both sum the same f32 products in the same order);
# also of stem kernels 1 and 2 (the f32 sum of the exact products of x and
# the f32 table, in another order than the plain version's)
BIT_EQUAL_GATE = 0.999
# kernel 1's f32 training form against its plain version: the round's f32
# gate (both the f32 sum of the same exact products, in another order)
F32_GATE = 1e-4
UPSAMPLE_ARGMAX_GATE = 0.9999  # label agreement with the plain version
# the main head's dropout input at the config's batch and crop (16, 512×1024)
DROPOUT_SHAPE = (16, 1024, 64, 128)


def emit(**kw):
    print(json.dumps(kw), flush=True)


def rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()


def cuda_ms(fn, n=20):
    """Median over n single runs, CUDA events, after 3 warmup runs."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, kernel, n=10, per_call=False):
    """The mean device time of `kernel` (a substring of its name; "": every
    kernel) per launch, or per call of fn with per_call, over n calls of fn
    under torch.profiler, or "not measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
          and not e.is_user_annotation and kernel in e.name]
    total = sum(e.device_time_total for e in ev) / 1e3
    return total / (n if per_call else len(ev)) if ev and total > 0 else "not measured"


def sass_check(lib):
    """HGMMA and HMMA instruction counts in the SASS of each kernel named in
    WGMMA_KERNELS (cuobjdump of the built library); raises unless every
    instantiation has HGMMA and none has HMMA."""
    import shutil

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for body in sass.split("Function : ")[1:]:
        fn = body.split("\n", 1)[0].strip()
        for k in WGMMA_KERNELS:
            if k in fn:
                counts[fn] = {"kernel": k, "HGMMA": body.count("HGMMA"),
                              "HMMA": len(re.findall(r"\bHMMA\b", body))}
    emit(phase="sass", functions=counts)
    for k in WGMMA_KERNELS:
        fns = [c for c in counts.values() if c["kernel"] == k]
        if not fns or any(c["HGMMA"] == 0 or c["HMMA"] for c in fns):
            raise RuntimeError(f"{k}: its SASS lacks HGMMA or has HMMA: {fns}")
    return counts


def bound(n_bytes, flops, flop_rate=BF16_FLOP_PER_S):
    """(least ms, what bounds it): bytes over HBM's rate, operations over
    `flop_rate` (the bf16 tensor rate unless the work is f32 on the CUDA
    cores), whichever is larger."""
    t_mem, t_ops = n_bytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops else "operations"


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def conv_flops(out, k):
    """2·MACs of a conv whose output is `out` (B, O, H, W) with kernel k."""
    return 2 * out.numel() * k[0].numel()


def folded_bn(rng, n, dev):
    """Folded eval-BN (scale, bias): gamma ~N(1, .1), beta ~N(0, .1),
    mean ~N(0, .1), var ~U(.5, 1.5)."""
    g, b = rng.normal(1, 0.1, n), rng.normal(0, 0.1, n)
    m, v = rng.normal(0, 0.1, n), rng.uniform(0.5, 1.5, n)
    s = g / np.sqrt(v + 1e-5)
    return (torch.tensor(s, dtype=torch.float32, device=dev),
            torch.tensor(b - m * s, dtype=torch.float32, device=dev))


def conv_w(rng, o, i, ks, dev):
    std = np.sqrt(2.0 / (o * ks * ks))
    return torch.tensor(rng.normal(0, std, (o, i, ks, ks)), dtype=torch.float32,
                        device=dev)


def phase_kernels(dev):
    from mds_tpu_torch.ops import stem

    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(0, 1, (1, H, W, 3)), dtype=torch.float32,
                     device=dev).to(torch.bfloat16).permute(0, 3, 1, 2)
    results = stem_rows(dev, x, rng)
    calls = {
        "stem_s1_pair_fused": [(
            x, conv_w(rng, 64, 3, 3, dev), *folded_bn(rng, 64, dev),
            conv_w(rng, 64, 64, 3, dev), *folded_bn(rng, 64, dev), True)],
        "detail_s1s2_fused": [(
            x, conv_w(rng, 64, 3, 3, dev), *folded_bn(rng, 64, dev),
            conv_w(rng, 64, 64, 3, dev), *folded_bn(rng, 64, dev),
            conv_w(rng, 64, 64, 3, dev), *folded_bn(rng, 64, dev))],
        "stemblock_fused": [(
            x, conv_w(rng, 16, 3, 3, dev), *folded_bn(rng, 16, dev),
            conv_w(rng, 8, 16, 1, dev), *folded_bn(rng, 8, dev),
            conv_w(rng, 16, 8, 3, dev), *folded_bn(rng, 16, dev),
            conv_w(rng, 16, 32, 3, dev), *folded_bn(rng, 16, dev))],
        # BiSeNetV1's two 7×7 RGB stems (ResNet18 conv1, SpatialPath conv1)
        "stem7_conv_bn_relu_s2": [
            (x, conv_w(rng, 64, 3, 7, dev), *folded_bn(rng, 64, dev), True)],
    }
    # the kernels whose model routes pack their weights once: the packing
    # function of the arguments after x, and the kernel's name in a trace
    warm = {"stem_s1_pair_fused": (lambda *a: stem.pack_s1_pair(*a[:6]), "pair_kernel"),
            "detail_s1s2_fused": (stem.pack_detail_head, "detail_head_kernel"),
            "stemblock_fused": (stem.pack_stemblock, "stemblock_kernel"),
            "stem7_conv_bn_relu_s2": (lambda k, s, b, relu: stem.pack_stem7(k, s, b),
                                      "stem7_kernel")}
    # the kernels held at the frame to a bit-equal share >= BIT_EQUAL_GATE
    # with their plain version, as stem_rows holds kernels 1 and 2
    share_gated = ("stemblock_fused", "stem7_conv_bn_relu_s2")
    for name, arg_sets in calls.items():
        kernel = getattr(stem, name)
        plain = getattr(stem, name + "_plain")
        res = {"max_abs_err": 0.0, "rel": 0.0, "bit_equal": 1.0, "ms": 0.0,
               "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": None, "shapes": []}
        for args in arg_sets:
            before = kernel.launches
            got = kernel(*args)
            torch.cuda.synchronize()
            if kernel.launches != before + 1:
                raise RuntimeError(f"{name}: launch counter did not move")
            want = plain(*args)
            if not (got.shape == want.shape and got.dtype == torch.bfloat16
                    and got.is_contiguous(memory_format=torch.channels_last)):
                raise RuntimeError(f"{name}: bad output {got.shape} {got.dtype}")
            r = rel(got, want)
            if not (torch.isfinite(got.float()).all() and r < KERNEL_GATE):
                raise RuntimeError(f"{name}: rel max-diff {r} >= {KERNEL_GATE}")
            res["max_abs_err"] = max(res["max_abs_err"],
                                     (got.float() - want.float()).abs().max().item())
            res["rel"] = max(res["rel"], r)
            eq = share_equal(bits(got), bits(want))
            if name in share_gated and eq < BIT_EQUAL_GATE:
                raise RuntimeError(f"{name}: bit-equal share {eq} < {BIT_EQUAL_GATE}")
            res["bit_equal"] = min(res["bit_equal"], eq)
            # kernel and plain timed in turns on the same inputs
            ms = cuda_ms(lambda: kernel(*args))
            plain_ms = cuda_ms(lambda: plain(*args))
            extra = {}
            if name in warm:
                # warm on its weights packed once, as the route calls it (`ms`);
                # cold, packing in the call; the kernel's own device time
                pack, dev_kernel = warm[name]
                packed = pack(*args[1:])
                # the warm call, the routes' own, gives the cold call's output
                if not torch.equal(kernel(*args, packed=packed), got):
                    raise RuntimeError(f"{name}: output on packed weights differs "
                                       "from the one packing in the call")
                extra = {"cold_ms": ms,
                         "device_ms": device_ms(lambda: kernel(*args, packed=packed),
                                                dev_kernel)}
                ms = cuda_ms(lambda: kernel(*args, packed=packed))
                for k, v in extra.items():
                    res[k] = v
            res["ms"] += ms
            res["plain_ms"] += plain_ms
            x_in, ks = args[0], [a for a in args[1:] if torch.is_tensor(a) and a.dim() == 4]
            flops = {  # the convs each kernel computes, from this run's shapes
                "stem_s1_pair_fused": lambda: 2 * x_in.numel() // 3 // 4 * 64 * (27 + 576),
                "stem7_conv_bn_relu_s2": lambda: conv_flops(got, ks[0]),
                "detail_s1s2_fused": lambda: 2 * x_in.numel() // 3 // 4 * 64 * (27 + 576)
                + conv_flops(got, ks[2]),
                "stemblock_fused": lambda: 2 * x_in.numel() // 3 // 4 * (16 * 27 + 8 * 16)
                + 2 * got.numel() * (8 * 9 + 32 * 9),
            }[name]()
            b_ms, b_by = bound(nbytes(*[a for a in args if torch.is_tensor(a)], got),
                               flops)
            res["bound_ms"] += b_ms
            res["bound_by"] = b_by
            shape = {"out": list(got.shape), "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, **extra}
            if name == "stem7_conv_bn_relu_s2":
                # the library's one call for the same conv: bf16 F.conv2d with
                # the folded weight and bias (the ReLU left out)
                k, scale, bias = args[1], args[2], args[3]
                wf = (k.float() * scale.reshape(-1, 1, 1, 1)).to(torch.bfloat16)
                bf = bias.to(torch.bfloat16)
                pad = k.shape[-1] // 2
                shape["library_ms"] = cuda_ms(
                    lambda: F.conv2d(x, wf, bf, stride=2, padding=pad))
                res["library_ms"] = (res["library_ms"] or 0.0) + shape["library_ms"]
            res["shapes"].append(shape)
        emit(phase="kernels", kernel=name, plain="library ops in f32, TF32 off",
             **res)
        results[name] = res
    emit(phase="kernels", kernel="stem7_conv_bn_relu_s2", ragged=stem7_ragged(dev))
    emit(phase="kernels", kernel="stemblock_fused", ragged=stemblock_ragged(dev))
    emit(phase="kernels", kernel="stem_conv_bn_relu_s2", ragged=stem_ragged(dev))
    return results


def stem_rows(dev, x, rng):
    """Kernels 1 and 2 at the stem route's two RGB stems (DetailBranch S1_1
    → 64, StemBlock conv → 16, folded BN, ReLU) on the frame-sized x: each
    against the plain version (rel, bit-equal share), kernel 2 bit for bit
    against kernel 1; timed warm on the packed table (as the route calls
    them: `ms`) and cold, packing in the call, by the profiler's device time,
    beside the plain version and one bf16 F.conv2d with the folded weight
    and bias (no ReLU)."""
    from mds_tpu_torch.ops import stem

    stems = [(x, conv_w(rng, o, 3, 3, dev), *folded_bn(rng, o, dev), True)
             for o in (64, 16)]
    packs = [stem.pack_stem(*args[1:4]) for args in stems]
    results = {}
    for name in ("stem_conv_bn_relu_s2", "stem_conv_bn_relu_s2_window"):
        kernel = getattr(stem, name)
        res = {"max_abs_err": 0.0, "rel": 0.0, "bit_equal": 1.0, "ms": 0.0, "cold_ms": 0.0,
               "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
               "shapes": []}
        for args, packed in zip(stems, packs):
            got, want, r = check_kernel_output(
                name, lambda *a: kernel(*a, packed=packed), stem.stem_conv_bn_relu_s2_plain,
                args, counter=kernel)
            eq = share_equal(bits(got), bits(want))
            if eq < BIT_EQUAL_GATE:
                raise RuntimeError(f"{name}: bit-equal share {eq} < {BIT_EQUAL_GATE}")
            if name == "stem_conv_bn_relu_s2_window" and not torch.equal(
                    bits(got), bits(stem.stem_conv_bn_relu_s2(*args, packed=packed))):
                raise RuntimeError(f"{name}: differs from stem_conv_bn_relu_s2")
            k, scale, bias = args[1:4]
            wf = (k * scale.reshape(-1, 1, 1, 1)).to(torch.bfloat16)
            bf = bias.to(torch.bfloat16)
            b_ms, res["bound_by"] = bound(nbytes(x, k, scale, bias, got), conv_flops(got, k))
            shape = {"out": list(got.shape), "rel": r, "bit_equal": eq,
                     "ms": cuda_ms(lambda: kernel(*args, packed=packed)),
                     "cold_ms": cuda_ms(lambda: kernel(*args)),
                     "device_ms": device_ms(lambda: kernel(*args, packed=packed),
                                            "stem_kernel"),
                     "plain_ms": cuda_ms(lambda: stem.stem_conv_bn_relu_s2_plain(*args)),
                     "library_ms": cuda_ms(lambda: F.conv2d(x, wf, bf, stride=2, padding=1)),
                     "bound_ms": b_ms}
            res["shapes"].append(shape)
            res["max_abs_err"] = max(res["max_abs_err"],
                                     (got.float() - want.float()).abs().max().item())
            res["rel"], res["bit_equal"] = max(res["rel"], r), min(res["bit_equal"], eq)
            for key in ("ms", "cold_ms", "device_ms", "plain_ms", "library_ms", "bound_ms"):
                if isinstance(shape[key], float) and isinstance(res[key], float):
                    res[key] += shape[key]
                else:
                    res[key] = "not measured"
        if name == "stem_conv_bn_relu_s2_window":
            res["equal_to_stem_conv_bn_relu_s2"] = True  # checked above
        emit(phase="kernels", kernel=name, plain="library ops in f32, TF32 off",
             library="bf16 F.conv2d, folded weight and bias, no ReLU", **res)
        results[name] = res
    return results


def stem_ragged(dev):
    """Kernels 1 and 2 on ragged tiles (W/2 not a multiple of 64), B > 1, O
    from 8 to 128, with and without ReLU (rel, bit-equal share, kernel 2
    bit-equal to kernel 1), and kernel 1's f32 training form on the same
    inputs (rel <= F32_GATE). Not counted as main-path launches."""
    from mds_tpu_torch.ops import stem

    rng = np.random.default_rng(7)
    out = []
    for b, h, w, o, relu in ((2, 18, 134, 64, True), (1, 6, 2050, 16, False),
                             (3, 2, 2, 8, True), (1, 34, 70, 128, True),
                             (2, 10, 14, 24, False), (1, 36, 44, 64, True),
                             (2, 18, 262, 16, False), (1, 100, 66, 24, False)):
        x = torch.tensor(rng.normal(0, 1, (b, h, w, 3)), dtype=torch.float32,
                         device=dev).to(torch.bfloat16).permute(0, 3, 1, 2)
        args = (x, conv_w(rng, o, 3, 3, dev), *folded_bn(rng, o, dev), relu)
        want = stem.stem_conv_bn_relu_s2_plain(*args)
        k1 = stem.stem_conv_bn_relu_s2(*args)
        k2 = stem.stem_conv_bn_relu_s2_window(*args)
        kb = args[1].to(torch.bfloat16)
        f32 = stem.stem_conv3x3_s2(x, kb)
        rec = {"shape": [b, h, w, o], "relu": relu, "rel": rel(k1, want),
               "bit_equal": share_equal(bits(k1), bits(want)),
               "window_equal": torch.equal(bits(k1), bits(k2)),
               "f32_rel": rel(f32, stem.stem_conv3x3_s2_plain(x, kb)),
               "f32_dtype": str(f32.dtype)}
        out.append(rec)
        if (k1.shape != want.shape or not torch.isfinite(k1.float()).all()
                or rec["rel"] >= KERNEL_GATE or rec["bit_equal"] < BIT_EQUAL_GATE
                or not rec["window_equal"] or f32.dtype != torch.float32
                or rec["f32_rel"] > F32_GATE):
            raise RuntimeError(f"stem_conv_bn_relu_s2 ragged: {rec}")
    return out


def stem7_ragged(dev):
    """The 7×7 stem on shapes whose tiles are ragged (8×32 output tiles cut
    by the image's edge), on B > 1, and on every O % 8 == 0 up to 128,
    against its plain version: rel max-diff and the share of bit-equal
    outputs per shape. Not counted as main-path launches."""
    from mds_tpu_torch.ops import stem

    rng = np.random.default_rng(5)
    out = []
    for b, h, w, o, relu in ((1, 36, 44, 64, True), (2, 18, 70, 32, False),
                             (1, 64, 130, 128, True), (3, 2, 2, 8, True),
                             (1, 100, 66, 24, False)):
        x = torch.tensor(rng.normal(0, 1, (b, h, w, 3)), dtype=torch.float32,
                         device=dev).to(torch.bfloat16).permute(0, 3, 1, 2)
        args = (x, conv_w(rng, o, 3, 7, dev), *folded_bn(rng, o, dev), relu)
        got, want = stem.stem7_conv_bn_relu_s2(*args), stem.stem7_conv_bn_relu_s2_plain(*args)
        r = rel(got, want)
        out.append({"shape": [b, h, w, o], "relu": relu, "rel": r,
                    "bit_equal": share_equal(bits(got), bits(want))})
        if got.shape != want.shape or not torch.isfinite(got.float()).all() or r >= KERNEL_GATE:
            raise RuntimeError(f"stem7_conv_bn_relu_s2 at {out[-1]}")
    return out


def stemblock_ragged(dev):
    """The StemBlock at B = 2 with H/4 and W/4 off its 61-column strips, at
    three strips, and at H = W = 4, against its plain version: rel max-diff
    and the share of bit-equal outputs per shape. Not counted as main-path
    launches."""
    from mds_tpu_torch.ops import stem

    rng = np.random.default_rng(8)
    out = []
    for b, h, w in ((2, 36, 260), (2, 20, 252), (1, 4, 4), (1, 68, 500)):
        x = torch.tensor(rng.normal(0, 1, (b, h, w, 3)), dtype=torch.float32,
                         device=dev).to(torch.bfloat16).permute(0, 3, 1, 2)
        args = (x, conv_w(rng, 16, 3, 3, dev), *folded_bn(rng, 16, dev),
                conv_w(rng, 8, 16, 1, dev), *folded_bn(rng, 8, dev),
                conv_w(rng, 16, 8, 3, dev), *folded_bn(rng, 16, dev),
                conv_w(rng, 16, 32, 3, dev), *folded_bn(rng, 16, dev))
        got, want = stem.stemblock_fused(*args), stem.stemblock_fused_plain(*args)
        r = rel(got, want)
        out.append({"shape": [b, h, w], "rel": r,
                    "bit_equal": share_equal(bits(got), bits(want))})
        if got.shape != want.shape or not torch.isfinite(got.float()).all() or r >= KERNEL_GATE:
            raise RuntimeError(f"stemblock_fused at {out[-1]}")
    return out


def bits(t):
    """A bf16 or f32 tensor's bit patterns in NHWC order (-0 != +0)."""
    it = torch.int16 if t.dtype == torch.bfloat16 else torch.int32
    return t.permute(0, 2, 3, 1).contiguous().view(it)


def share_equal(a, b):
    """The exact share of equal elements (a count over the size)."""
    return (a == b).sum().item() / a.numel()


def _clone(a):
    return a.clone() if torch.is_tensor(a) else a


class _Spy:
    """Stands in for a kernel wrapper in its module: records each call's
    arguments (each through `keep`: cloned by default) and calls the
    wrapper. The wrapper counts its launch through its module's name, so
    `launches` reads and writes the wrapper's."""

    def __init__(self, real, keep=_clone):
        self.real, self.keep, self.seen = real, keep, []

    @property
    def launches(self):
        return self.real.launches

    @launches.setter
    def launches(self, n):
        self.real.launches = n

    def __call__(self, *args, **kw):
        self.seen.append(tuple(self.keep(a) for a in args))
        return self.real(*args, **kw)


@contextlib.contextmanager
def captured(module, name, keep=_clone):
    """The arguments of every call of module.<name> in the block, each
    through `keep` (cloned by default; the call itself goes through)."""
    spy = _Spy(getattr(module, name), keep)
    setattr(module, name, spy)
    try:
        yield spy.seen
    finally:
        setattr(module, name, spy.real)


def main_path_inputs(e2e, frame):
    """The depthwise kernel's 16 (x, w, stride), the fused tail's (logits,
    scale) and the detail tail's arguments of one served BiSeNetV2 frame, and
    the conv3 kernel's of one frame on the window-stem + conv3 route: real
    activations at the shapes the main path gives the kernels."""
    from mds_tpu_torch.ops import conv3x3, depthwise, stem, upsample_argmax

    with torch.no_grad(), route(**ALL_ROUTES):
        with captured(depthwise, "depthwise3x3") as dw, \
                captured(upsample_argmax, "upsample_argmax") as ua, \
                captured(stem, "detail_tail_fused") as tail:
            e2e.model.pred(normalized(e2e, frame))
    with torch.no_grad(), route(**STEM_DMA_CONV3_ROUTES):
        with captured(conv3x3, "conv3x3_bn_relu") as c3:
            e2e.model.pred(normalized(e2e, frame))
    torch.cuda.synchronize()
    return dw, ua, tail, c3


def check_kernel_output(name, kernel, plain, args, dtype=torch.bfloat16, counter=None):
    """One launch of `kernel` (the counter of `counter`, else of `kernel`,
    must move by one) against its plain version on the same arguments:
    (output, plain output, rel)."""
    counter = counter or kernel
    before = counter.launches
    got = kernel(*args)
    torch.cuda.synchronize()
    if counter.launches != before + 1:
        raise RuntimeError(f"{name}: launch counter did not move")
    want = plain(*args)
    if not (got.shape == want.shape and got.dtype == dtype
            and got.is_contiguous(memory_format=torch.channels_last)):
        raise RuntimeError(f"{name}: bad output {got.shape} {got.dtype}")
    r = rel(got, want)
    if not torch.isfinite(got.float()).all() or r >= KERNEL_GATE:
        raise RuntimeError(f"{name}: rel max-diff {r} >= {KERNEL_GATE}")
    return got, want, r


def detail_tail_row(call, detail, x):
    """detail_tail_fused at the served frame's /4 detail feature against its
    plain version, timed cold (weights folded and packed in the call) and
    warm (on the packed weights, as the served route calls it: `ms`), its
    device time read by the profiler, beside its plain version and the chain
    the plain route runs (the DetailBranch's five ConvBNReLU modules: cuDNN
    conv, unfolded BN, ReLU); no single PyTorch call computes the function
    (library_ms null). Also the chain that kernel 4 replaces (S1_1, S1_2,
    S2_1) on the frame x, the yardstick of kernel 4's row, which has no
    single call either."""
    from mds_tpu_torch.ops import stem

    name = "detail_tail_fused"
    call = call[:16]  # the captured call's last argument: the model's pack
    got, want, r = check_kernel_output(name, stem.detail_tail_fused,
                                       stem.detail_tail_fused_plain, call)
    y = call[0]
    packed = stem.pack_detail_tail(*call[1:])

    def chain():
        xs = [y]
        with torch.inference_mode():
            for layer in detail._tail():
                xs = layer(xs)
        return xs[0]

    def head_chain():
        with torch.inference_mode():
            return detail.S2_1(detail.S1_2(detail.S1_1([x])))[0]

    cold_ms = cuda_ms(lambda: stem.detail_tail_fused(*call))
    ms = cuda_ms(lambda: stem.detail_tail_fused(*call, packed))
    dev_ms = device_ms(lambda: stem.detail_tail_fused(*call, packed),
                       "detail_tail_kernel")
    plain_ms = cuda_ms(lambda: stem.detail_tail_fused_plain(*call))
    chain_ms = cuda_ms(chain)
    emit(phase="kernels", kernel="detail_s1s2_fused", shape=list(x.shape),
         chain_ms=cuda_ms(head_chain), chain="the plain route's S1_1, S1_2, "
         "S2_1 ConvBNReLU modules (bf16 cuDNN conv, f32 BN, ReLU)")
    b, _, h4, w4 = y.shape
    p4, p8 = b * h4 * w4, b * (h4 // 2) * (w4 // 2)
    flops = 2 * (2 * p4 * 64 * 576 + p8 * 128 * 576 + 2 * p8 * 128 * 1152)
    b_ms, b_by = bound(nbytes(*[a for a in call if torch.is_tensor(a)], got), flops)
    res = {"max_abs_err": (got.float() - want.float()).abs().max().item(),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None}
    emit(phase="kernels", kernel=name, shape=list(y.shape), rel=r,
         bit_equal=share_equal(bits(got), bits(want)), cold_ms=cold_ms,
         device_ms=dev_ms, chain_ms=chain_ms,
         chain="the plain route's five ConvBNReLU modules (bf16 cuDNN conv, "
         "f32 BN, ReLU)", plain="library ops in f32, TF32 off", **res)
    return res


def conv3x3_row(call):
    """conv3x3_bn_relu at DetailBranch S1_2's input of a frame on the
    window-stem + conv3 route against its plain version, timed cold (k packed
    in the call) and warm (on the packed k, as the route calls it: `ms`),
    its device time read by the profiler, beside its plain version and one
    bf16 F.conv2d with the folded weight and bias (no ReLU)."""
    from mds_tpu_torch.ops import conv3x3 as c3

    name = "conv3x3_bn_relu"
    call = call[:5]  # the captured call's last argument: the model's pack
    got, want, r = check_kernel_output(name, c3.conv3x3_bn_relu,
                                       c3.conv3x3_bn_relu_plain, call)
    x, k, scale, bias = call[:4]
    wp = c3.pack_conv3x3(k)
    wf = (k.float() * scale.reshape(-1, 1, 1, 1)).to(torch.bfloat16)
    bf = bias.to(torch.bfloat16)
    cold_ms = cuda_ms(lambda: c3.conv3x3_bn_relu(*call))
    ms = cuda_ms(lambda: c3.conv3x3_bn_relu(*call, wp))
    dev_ms = device_ms(lambda: c3.conv3x3_bn_relu(*call, wp), "conv3x3_kernel")
    plain_ms = cuda_ms(lambda: c3.conv3x3_bn_relu_plain(*call))
    library_ms = cuda_ms(lambda: F.conv2d(x, wf, bf, padding=1))
    b_ms, b_by = bound(nbytes(x, k, scale, bias, got), conv_flops(got, k))
    res = {"max_abs_err": (got.float() - want.float()).abs().max().item(),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": library_ms}
    emit(phase="kernels", kernel=name, shape=list(x.shape), out=list(got.shape),
         rel=r, bit_equal=share_equal(bits(got), bits(want)), cold_ms=cold_ms,
         device_ms=dev_ms,
         plain="f32 conv on bf16(k), then ·scale + bias, ReLU; TF32 off",
         library="bf16 F.conv2d, folded weight and bias, no ReLU", **res)
    return res


def conv_kernels_ragged(dev):
    """The S1 pair, the detail tail and the conv3 kernel on ragged tiles, B > 1 and, for conv3, C_in from 3
    to 64 and C_out from 8 to 136, against their plain versions. Not counted
    as main-path launches."""
    from mds_tpu_torch.ops import conv3x3 as c3, stem

    rng = np.random.default_rng(7)

    def image(b, h, w, c=3):  # RGB as normalized, features after a ReLU
        x = torch.tensor(rng.normal(0, 1, (b, h, w, c)), dtype=torch.float32,
                         device=dev)
        return (x if c == 3 else x.relu()).to(torch.bfloat16).permute(0, 3, 1, 2)

    out = {"stem_s1_pair_fused": [], "detail_tail_fused": [], "conv3x3_bn_relu": []}

    def record(name, rec, got, want):
        rec.update(rel=rel(got, want), bit_equal=share_equal(bits(got), bits(want)))
        out[name].append(rec)
        if (got.shape != want.shape or not torch.isfinite(got.float()).all()
                or rec["rel"] >= KERNEL_GATE):
            raise RuntimeError(f"{name} ragged: {rec}")

    for b, h, w, relu2 in ((1, 36, 70, True), (2, 18, 10, False), (1, 2, 2, True),
                           (2, 14, 262, True)):
        args = (image(b, h, w), conv_w(rng, 64, 3, 3, dev), *folded_bn(rng, 64, dev),
                conv_w(rng, 64, 64, 3, dev), *folded_bn(rng, 64, dev), relu2)
        record("stem_s1_pair_fused", {"shape": [b, h, w], "relu2": relu2},
               stem.stem_s1_pair_fused(*args), stem.stem_s1_pair_fused_plain(*args))
    for b, h4, w4 in ((2, 22, 38), (1, 2, 2), (1, 34, 130)):
        params = []
        for o, i in stem._TAIL_SHAPES:
            params += [conv_w(rng, o, i, 3, dev), *folded_bn(rng, o, dev)]
        args = (image(b, h4, w4, 64), *params)
        record("detail_tail_fused", {"shape": [b, 64, h4, w4]},
               stem.detail_tail_fused(*args), stem.detail_tail_fused_plain(*args))
    for b, h, w, ci, co, relu in ((2, 17, 33, 64, 64, True), (1, 9, 40, 3, 8, True),
                                  (2, 31, 15, 16, 16, False), (1, 13, 27, 24, 136, True),
                                  (1, 8, 8, 40, 72, False), (1, 5, 70, 48, 32, True)):
        args = (image(b, h, w, ci), conv_w(rng, co, ci, 3, dev), *folded_bn(rng, co, dev),
                relu)
        record("conv3x3_bn_relu", {"shape": [b, h, w, ci], "c_out": co, "relu": relu},
               c3.conv3x3_bn_relu(*args), c3.conv3x3_bn_relu_plain(*args))
    return out


def depthwise_rows(dw_calls):
    """depthwise3x3 at the frame's 16 shapes and depthwise3x3_dma at its
    stride-1 ones against their plain version (rel max-diff, bit-equal
    share; the DMA kernel bit-equal to kernel 9), each timed beside its
    plain version, one bf16 F.conv2d with groups = C (the library call) and
    the port's library route (repeat_interleave + depthwise conv); beside
    the DMA kernel's device time, kernel 9's at the same shape."""
    from mds_tpu_torch.models.layers import _repeat_channels
    from mds_tpu_torch.ops import depthwise

    def library(x, w, s):
        return F.conv2d(x, w, None, s, 1, 1, x.shape[1])

    def port_route(x, w, s):
        c, co = x.shape[1], w.shape[0]
        x = _repeat_channels(x, co // c) if co != c else x
        return F.conv2d(x, w, None, s, 1, 1, co)

    rows = {}
    for name in ("depthwise3x3", "depthwise3x3_dma"):
        kernel = getattr(depthwise, name)
        res = {"max_abs_err": 0.0, "rel": 0.0, "bit_equal": 1.0, "ms": 0.0,
               "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
               "port_route_ms": 0.0, "device_ms": 0.0, "library_device_ms": 0.0,
               "shapes": []}
        for x, w, s in dw_calls:
            if name == "depthwise3x3_dma" and s != 1:
                continue
            args = (x, w, s) if name == "depthwise3x3" else (x, w)
            before = kernel.launches
            got = kernel(*args)
            torch.cuda.synchronize()
            if kernel.launches != before + 1:
                raise RuntimeError(f"{name}: launch counter did not move")
            want = depthwise.depthwise3x3_plain(x, w, s)
            if not (got.shape == want.shape and got.dtype == x.dtype
                    and got.is_contiguous(memory_format=torch.channels_last)):
                raise RuntimeError(f"{name}: bad output {got.shape} {got.dtype}")
            r, eq = rel(got, want), share_equal(bits(got), bits(want))
            shape = {"x": list(x.shape), "stride": s, "m": w.shape[0] // x.shape[1],
                     "rel": r, "bit_equal": eq}
            if name == "depthwise3x3_dma":
                k9 = depthwise.depthwise3x3(x, w, 1)
                shape["equal_to_depthwise3x3"] = torch.equal(bits(got), bits(k9))
                if not shape["equal_to_depthwise3x3"]:
                    raise RuntimeError(f"{name}: differs from depthwise3x3 at {shape}")
            if not torch.isfinite(got.float()).all() or r >= KERNEL_GATE or eq < BIT_EQUAL_GATE:
                raise RuntimeError(f"{name}: {shape}")
            # kernel, plain version, library call and library route in turns
            shape["ms"] = cuda_ms(lambda: kernel(*args))
            shape["plain_ms"] = cuda_ms(lambda: depthwise.depthwise3x3_plain(x, w, s))
            shape["library_ms"] = cuda_ms(lambda: library(x, w, s))
            shape["port_route_ms"] = cuda_ms(lambda: port_route(x, w, s))
            # device time per call, the kernel's and the library call's; at
            # kernel 10's shapes also kernel 9's
            shape["device_ms"] = device_ms(lambda: kernel(*args), "dw3x3")
            if name == "depthwise3x3_dma":
                shape["k9_device_ms"] = device_ms(lambda: depthwise.depthwise3x3(x, w, 1),
                                                  "dw3x3_kernel")
                res["k9_device_ms"] = res.get("k9_device_ms", 0.0) + (
                    shape["k9_device_ms"] if isinstance(shape["k9_device_ms"], float)
                    else float("nan"))
            shape["library_device_ms"] = device_ms(lambda: library(x, w, s), "",
                                                   per_call=True)
            # each input read once, each output written once; 9 f32
            # multiply-adds per output on the CUDA cores
            shape["bound_ms"], res["bound_by"] = bound(nbytes(x, w, got),
                                                       2 * 9 * got.numel(),
                                                       F32_FLOP_PER_S)
            res["max_abs_err"] = max(res["max_abs_err"],
                                     (got.float() - want.float()).abs().max().item())
            res["rel"] = max(res["rel"], r)
            res["bit_equal"] = min(res["bit_equal"], eq)
            for k in ("ms", "plain_ms", "bound_ms", "library_ms", "port_route_ms",
                      "device_ms", "library_device_ms"):
                res[k] = (res[k] + shape[k] if isinstance(shape[k], float)
                          and isinstance(res[k], float) else "not measured")
            res["shapes"].append(shape)
        emit(phase="kernels", kernel=name, plain="f32 slices of the padded input, "
             "multiply, add in tap order", library="bf16 F.conv2d, groups = C_in",
             port_route="repeat_interleave + depthwise F.conv2d", **res)
        rows[name] = res
    return rows


def upsample_argmax_row(ua_call):
    """upsample_argmax at the frame's head logits against its plain version
    (label agreement, differing pixels), timed beside the plain version and
    the library chain the plain route runs (bf16 F.interpolate, argmax, int32
    cast), its device time read by the profiler; no single PyTorch call
    computes the function (library_ms null)."""
    from mds_tpu_torch.ops import upsample_argmax as ua

    logits, s = ua_call
    before = ua.upsample_argmax.launches
    got = ua.upsample_argmax(logits, s)
    torch.cuda.synchronize()
    if ua.upsample_argmax.launches != before + 1:
        raise RuntimeError("upsample_argmax: launch counter did not move")
    want = ua.upsample_argmax_plain(logits, s)
    b, c, h, w = logits.shape
    if got.shape != (b, h * s, w * s) or got.dtype != torch.int32:
        raise RuntimeError(f"upsample_argmax: bad output {got.shape} {got.dtype}")
    agree = share_equal(got, want)

    def chain():
        up = F.interpolate(logits, size=(h * s, w * s), mode="bilinear",
                           align_corners=False)
        return up.argmax(dim=1).to(torch.int32)

    ms = cuda_ms(lambda: ua.upsample_argmax(logits, s))
    dev_ms = device_ms(lambda: ua.upsample_argmax(logits, s), "upsample_argmax_kernel")
    plain_ms = cuda_ms(lambda: ua.upsample_argmax_plain(logits, s))
    chain_ms = cuda_ms(chain)
    # the separable passes: 3 f32 operations per vertical and per horizontal
    # value, one comparison per class after the first
    flops = 3 * b * c * h * s * (w + w * s) + b * h * s * w * s * (c - 1)
    b_ms, b_by = bound(nbytes(logits, got), flops, F32_FLOP_PER_S)
    # labels: the largest class-index difference, 0 where the maps agree
    res = {"max_abs_err": float((got - want).abs().max().item()), "ms": ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None}
    emit(phase="kernels", kernel="upsample_argmax", shape=list(logits.shape),
         scale=s, dtype=str(logits.dtype), agreement=agree,
         differing_pixels=int((got != want).sum()), device_ms=dev_ms,
         chain_ms=chain_ms, chain="bf16 F.interpolate + argmax + int32 cast",
         plain="two f32 passes, bf16 rounding between, argmax", **res)
    if agree < UPSAMPLE_ARGMAX_GATE:
        raise RuntimeError(f"upsample_argmax: agreement {agree}")
    return res


def new_kernels_ragged(dev):
    """The depthwise kernels at odd H and W, B > 1, C = 3, 5, 12, m = 1, 2,
    6, both strides (and f32), against their plain version (depthwise3x3_dma
    also equal to depthwise3x3, bit for bit, and on its TMA form at
    tiles off the image, more tiles than one persistent pass, an image
    narrower than a tile, B = 3); upsample_argmax
    at odd h and w, B = 1 and 2, C = 1, 5, 19, 150, s = 1, 2, 3, 4, 5, 8, bf16
    and f32, against its plain version. Not counted as main-path
    launches."""
    from mds_tpu_torch.ops import depthwise, upsample_argmax as ua

    rng = np.random.default_rng(6)
    out = {"depthwise": [], "upsample_argmax": []}
    for b, h, w, c, m, s, dt in (
            (2, 17, 33, 3, 1, 1, torch.bfloat16), (2, 17, 33, 3, 2, 2, torch.bfloat16),
            (1, 31, 15, 5, 6, 1, torch.bfloat16), (3, 9, 9, 5, 1, 2, torch.bfloat16),
            (2, 21, 19, 12, 2, 1, torch.bfloat16), (1, 13, 27, 12, 6, 2, torch.bfloat16),
            (2, 7, 11, 12, 1, 1, torch.bfloat16), (1, 11, 13, 16, 6, 1, torch.float32),
            (2, 9, 10, 8, 1, 2, torch.float32), (2, 17, 37, 16, 6, 1, torch.bfloat16),
            (1, 19, 70, 8, 6, 2, torch.bfloat16), (3, 9, 33, 24, 2, 2, torch.bfloat16),
            (1, 6, 40, 8, 3, 1, torch.bfloat16), (2, 5, 9, 16, 4, 1, torch.bfloat16),
            # depthwise3x3_dma's TMA form: windows off the image on all four
            # sides, H and W off its tiles, more tiles than one persistent
            # pass (m = 1: 2 × 66 × 9 tiles of 2 × 32; m = 6: 67 × 7 of
            # 1 × 20), a 3 × 5 image (narrower than a tile, its windows off
            # all four sides), B = 3, f32; its masked form at C % 8 != 0
            (2, 131, 259, 64, 1, 1, torch.bfloat16), (1, 67, 129, 32, 6, 1, torch.bfloat16),
            (3, 13, 45, 32, 1, 1, torch.bfloat16), (1, 3, 5, 64, 6, 1, torch.bfloat16),
            (3, 35, 70, 16, 2, 1, torch.bfloat16), (2, 21, 45, 32, 6, 1, torch.float32),
            (1, 19, 37, 20, 3, 1, torch.float32), (2, 17, 33, 12, 6, 1, torch.bfloat16)):
        x = torch.tensor(rng.normal(0, 1, (b, h, w, c)), device=dev).relu().to(dt)
        x = x.permute(0, 3, 1, 2)
        wt = torch.tensor(rng.normal(0, 0.3, (c * m, 1, 3, 3)), device=dev).to(dt)
        want = depthwise.depthwise3x3_plain(x, wt, s)
        got = depthwise.depthwise3x3(x, wt, s)
        rec = {"shape": [b, h, w, c], "m": m, "stride": s, "dtype": str(dt),
               "rel": rel(got, want), "bit_equal": share_equal(bits(got), bits(want))}
        if s == 1:
            dma = bits(depthwise.depthwise3x3_dma(x, wt))
            rec["dma_equal"] = torch.equal(dma, bits(got))
            rec["dma_bit_equal"] = share_equal(dma, bits(want))
        out["depthwise"].append(rec)
        if (got.shape != want.shape or rec["rel"] >= KERNEL_GATE
                or rec["bit_equal"] < BIT_EQUAL_GATE or rec.get("dma_equal") is False
                or rec.get("dma_bit_equal", 1.0) < BIT_EQUAL_GATE):
            raise RuntimeError(f"depthwise ragged: {rec}")
    for b, h, w, c, s, dt in ((1, 9, 13, 1, 2, torch.bfloat16), (2, 7, 11, 5, 4, torch.bfloat16),
                              (1, 15, 9, 150, 8, torch.bfloat16), (1, 5, 7, 19, 3, torch.bfloat16),
                              (1, 11, 5, 5, 8, torch.float32), (2, 13, 37, 19, 8, torch.bfloat16),
                              (1, 9, 71, 19, 1, torch.bfloat16), (2, 7, 9, 19, 5, torch.bfloat16),
                              (2, 17, 35, 19, 8, torch.float32)):
        lg = torch.tensor(rng.normal(0, 1, (b, h, w, c)), device=dev).to(dt).permute(0, 3, 1, 2)
        got, want = ua.upsample_argmax(lg, s), ua.upsample_argmax_plain(lg, s)
        rec = {"shape": [b, c, h, w], "scale": s, "dtype": str(dt),
               "agreement": share_equal(got, want),
               "differing_pixels": int((got != want).sum())}
        out["upsample_argmax"].append(rec)
        if got.shape != want.shape or rec["agreement"] < UPSAMPLE_ARGMAX_GATE:
            raise RuntimeError(f"upsample_argmax ragged: {rec}")
    return out


def kernels():
    """Every kernel wrapper of the port, each with its launch counter."""
    from mds_tpu_torch.ops import conv3x3, depthwise, dropout, stem, upsample_argmax

    return (stem.KERNELS + dropout.KERNELS + depthwise.KERNELS
            + upsample_argmax.KERNELS + conv3x3.KERNELS)


def reset_counts():
    for k in kernels():
        k.launches = 0


def read_counts():
    return {k.__name__: k.launches for k in kernels()}


def phase_dropout(dev):
    """The dropout kernel at the main head's shape against its plain version,
    bit for bit, and its rule: keep rate, scale, seeds, backward mask."""
    from mds_tpu_torch.ops.dropout import (
        DropoutU8,
        dropout_u8,
        dropout_u8_plain,
        seed_words,
    )

    drop = 26  # round(0.1 · 256)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(DROPOUT_SHAPE, device=dev, generator=gen).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    k0, k1 = seed_words(torch.Generator().manual_seed(1))
    before = dropout_u8.launches
    got = dropout_u8(x, k0, k1, drop)
    torch.cuda.synchronize()
    if dropout_u8.launches != before + 1:
        raise RuntimeError("dropout_u8: launch counter did not move")
    want = dropout_u8_plain(x, k0, k1, drop)
    if not (got.is_contiguous(memory_format=torch.channels_last)
            and torch.equal(got.view(torch.int16), want.view(torch.int16))):
        raise RuntimeError("dropout_u8: not bit-identical to its plain version")
    # the mask itself: the kernel on ones (x holds exact zeros: randn draws
    # some, so y == 0 does not mean dropped)
    ones = torch.ones_like(x)
    keep = dropout_u8(ones, k0, k1, drop) != 0
    keep_frac = keep.float().mean().item()
    scale = torch.tensor(256 / 230, dtype=torch.bfloat16).item()
    nz = keep & (x != 0)
    ratio = (got.float()[nz] / x.float()[nz]).mean().item()
    same = torch.equal(keep, dropout_u8(ones, k0, k1, drop) != 0)
    other = torch.equal(keep, dropout_u8(ones, k0 ^ 1, k1, drop) != 0)
    xg = x.detach().requires_grad_(True)
    r = torch.randn(DROPOUT_SHAPE, device=dev, generator=gen).to(torch.bfloat16)
    (DropoutU8.apply(xg, k0, k1, drop) * r).sum().backward()  # r arrives NCHW
    grad_ok = torch.equal(xg.grad.view(torch.int16), torch.where(
        keep, (r.float() * scale).to(torch.bfloat16), 0.0).view(torch.int16))
    del ones, nz, xg, r
    # element offsets (parallel/mesh.py: a rank's rows of the batch's mask):
    # bit-equal to the plain version at offsets that are not multiples of 4,
    # and the second half of the batch at its offset equal to those rows of
    # the whole draw
    half = x[DROPOUT_SHAPE[0] // 2:]
    offsets = {}
    for off in (1, 2, 3, half.numel()):
        a = dropout_u8(x, k0, k1, drop, off)
        offsets[off] = torch.equal(a.view(torch.int16),
                                   dropout_u8_plain(x, k0, k1, drop, off).view(torch.int16))
        del a
    rows_ok = torch.equal(dropout_u8(half, k0, k1, drop, half.numel()).view(torch.int16),
                          got[DROPOUT_SHAPE[0] // 2:].view(torch.int16))
    offset1_ms = cuda_ms(lambda: dropout_u8(x, k0, k1, drop, 1))
    ms = cuda_ms(lambda: dropout_u8(x, k0, k1, drop))
    plain_ms = cuda_ms(lambda: dropout_u8_plain(x, k0, k1, drop), n=5)
    # the library's one call for the same function: drop with probability
    # 26/256, scale the kept by 256/230 (in f32, not rounded to bf16 first);
    # its mask comes from its own generator and is also written out
    library_ms = cuda_ms(lambda: torch.native_dropout(x, drop / 256, True))
    b_ms, b_by = bound(nbytes(x, got), 0)
    res = {"max_abs_err": (got.float() - want.float()).abs().max().item(),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": library_ms}
    emit(phase="dropout", shape=list(DROPOUT_SHAPE), keep_fraction=keep_frac,
         mean_kept_ratio=ratio, bf16_scale=scale, same_seed_same_mask=same,
         other_seed_other_mask=not other, backward_mask_ok=grad_ok,
         offsets_bit_equal={str(k): v for k, v in offsets.items()},
         shard_rows_bit_equal=rows_ok, offset1_ms=offset1_ms, **res)
    if not (all(offsets.values()) and rows_ok):
        raise RuntimeError("dropout_u8: an element offset's mask is not the plain version's")
    if abs(keep_frac - 230 / 256) > 0.002:
        raise RuntimeError(f"dropout_u8: keep fraction {keep_frac}")
    if abs(ratio - scale) > 1e-3 * scale or not same or other or not grad_ok:
        raise RuntimeError("dropout_u8: scale, seed or backward check failed")
    return res


def train_step_for(cfg, model, compute_dtype, fused_up_loss=False, local_bn=False):
    """The config's optimizer, schedule and normalization around `model`;
    `fused_up_loss` takes each head's OHEM CE through the phase
    decomposition of its upsample; `local_bn` selects local BN under a
    process group."""
    from mds_tpu_torch.data.labels import get_spec
    from mds_tpu_torch.engine.lr_schedule import warmup_poly_lr
    from mds_tpu_torch.engine.optim import build_optimizer
    from mds_tpu_torch.engine.train_step import make_seg_train_step

    schedule = warmup_poly_lr(
        float(cfg.get("lr", "lr_start")), float(cfg.get("lr", "lr_power")),
        int(cfg.get("lr", "max_iter")),
        warmup_iter=int(cfg.get("lr", "warmup_iters")),
        warmup_ratio=float(cfg.get("lr", "warmup_ratio")),
        warmup=cfg.get("lr", "warmup", default="exp"))
    opt = build_optimizer(cfg, model, schedule)
    spec = get_spec(cfg.dataset_cfg(0)["spec"])
    step = make_seg_train_step(
        model, opt, [spec.mean], [spec.std],
        ohem_thresh=float(cfg.get("loss", "ohem_thresh")),
        compute_dtype=compute_dtype, fused_up_loss=fused_up_loss, local_bn=local_bn)
    return step, opt


def seg_batch(rng, b, h, w, n_classes):
    """uint8 images and labels as bench.py:186-189 (classes drawn at 1/8
    resolution, repeated ×8)."""
    im = rng.integers(0, 256, (b, h, w, 3)).astype(np.uint8)
    lb8 = rng.integers(0, n_classes, (b, h // 8, w // 8))
    return im, np.repeat(np.repeat(lb8, 8, 1), 8, 2).astype(np.uint8)


def phase_train(dev):
    """The train step at the config's batch and crop, bf16."""
    from mds_tpu_torch import MODELS
    from mds_tpu_torch.config import Configer

    cfg = Configer(config_file=CONFIG)
    n_classes = cfg.n_cats(0)
    b = int(cfg.dataset_cfg(0)["ims_per_gpu"])
    h, w = cfg.get("train", "cropsize")
    init = MODELS[cfg.get("model_name")](n_classes=(n_classes,), n_bn=1, aux=True,
                                         dtype=torch.bfloat16)
    init.init_weights(torch.Generator().manual_seed(WEIGHT_SEED))
    model = copy.deepcopy(init).to(dev)
    step, opt = train_step_for(cfg, model, torch.bfloat16)
    im, lb = seg_batch(np.random.default_rng(0), b, h, w, n_classes)
    ims, lbs = [torch.from_numpy(im).to(dev)], [torch.from_numpy(lb).to(dev)]
    gen = torch.Generator().manual_seed(0)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    s0 = {k: v.clone() for k, v in model.named_buffers() if "running" in k}
    from mds_tpu_torch.ops import dropout

    metrics = [step(ims, lbs, gen)]  # warm-up
    # the dropout kernel's calls in one step (5 forward, 5 backward): their
    # bound reads each input once and writes each output once
    with captured(dropout, "dropout_u8",
                  lambda a: a.numel() * a.element_size() if torch.is_tensor(a) else None) as dc:
        metrics.append(step(ims, lbs, gen))
    drop_bytes = sum(2 * c[0] for c in dc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics.append(step(ims, lbs, gen))
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"].item() for m in metrics]
    moved = sum(not torch.equal(p0[k], v) for k, v in model.named_parameters())
    stats_moved = sum(not torch.equal(s0[k], v) for k, v in model.named_buffers()
                      if "running" in k)
    idle = profile_idle_share(lambda: step(ims, lbs, gen), ("dropout_bf16_kernel",))
    step_ms = float(np.median(times))
    emit(phase="train", batch=[b, h, w], losses=losses,
         step_ms=times, median_step_ms=step_ms, images_per_s=b / step_ms * 1e3,
         max_memory_allocated=peak, params_moved=f"{moved}/{len(p0)}",
         bn_stats_moved=f"{stats_moved}/{len(s0)}", optimizer_steps=opt.count,
         launches=launches, dropout_calls_per_step=len(dc),
         dropout_step_bytes=drop_bytes,
         dropout_step_bound_ms=drop_bytes / HBM_BYTES_PER_S * 1e3, **idle)
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite train losses {losses}")
    if stats_moved != len(s0) or moved < 0.9 * len(p0):
        raise RuntimeError(f"train step moved {moved} params, {stats_moved} stats")
    want = {k: 0 for k in launches}
    want["dropout_u8"] = 10 * 5
    if launches != want:
        raise RuntimeError(f"train launches {launches}, expected {want}")
    fused_up_routes(dev, cfg, init, (step, model), ims, lbs, losses[0])
    return launches


def fused_up_routes(dev, cfg, init, plain, ims, lbs, plain_loss):
    """The train step with train.fused_up_loss from the same weights,
    batch and dropout seed as the plain route's first step: the first
    losses within 1e-2 (the plain route's bf16 upsampled volume against
    the fused route's f32 blends); then both routes' step ms (CUDA events,
    median of 3) and peak memory in turns plain, fused, fused, plain."""
    fused_model = copy.deepcopy(init).to(dev)
    fused_step, _ = train_step_for(cfg, fused_model, torch.bfloat16, fused_up_loss=True)
    fused_loss = fused_step(ims, lbs, torch.Generator().manual_seed(0))["loss"].item()
    routes = {"plain": plain[0], "fused": fused_step}
    gen = torch.Generator().manual_seed(1)
    turns = []
    for name in ("plain", "fused", "fused", "plain"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            routes[name](ims, lbs, gen)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        turns.append({"route": name, "median_step_ms": float(np.median(times)),
                      "step_ms": times, "max_memory_allocated": torch.cuda.max_memory_allocated()})
    loss_rel = abs(fused_loss - plain_loss) / abs(plain_loss)
    emit(phase="train", fused_up_loss={"first_loss": fused_loss, "plain_first_loss": plain_loss,
                                       "loss_rel": loss_rel, "turns": turns})
    if not np.isfinite(fused_loss) or loss_rel >= 1e-2:
        raise RuntimeError(f"fused_up_loss: first loss {fused_loss} vs plain {plain_loss}")
    fused_ce_heads(cfg, fused_model, ims, lbs)


def fused_ce_heads(cfg, model, ims, lbs, ignore_share=0.05):
    """cross_entropy_upsampled on the card at every head of the batch, held
    against the CE of F.interpolate's bilinear upsample of the same logits.
    The first-loss gate above cannot see a wrong tap, blend or label layout:
    at a random init every pixel's CE is about log 19 whatever the blends.
    So each head's logits (the model's up=False forward, no grad) are scaled
    to a standard deviation of 3, as a trained head's spread, and a seeded
    5% of the labels are ignored. Gates, those of tests/test_torch_losses.py:
    the same valid pixels; the valid pixels' CE as sorted multisets, max-diff
    over the largest, <= 1e-5; the gradient of their sum wrt the logits, the
    same measure, <= 1e-4."""
    from mds_tpu_torch.data.labels import get_spec
    from mds_tpu_torch.engine.train_step import normalize_images
    from mds_tpu_torch.losses.ohem_ce import cross_entropy_per_pixel, cross_entropy_upsampled

    spec = get_spec(cfg.dataset_cfg(0)["spec"])
    with torch.no_grad():
        out = model(normalize_images(ims, [spec.mean], [spec.std], torch.bfloat16),
                    up=False, generator=torch.Generator().manual_seed(2))
    main_f, aux_fs = out["up_factors"]
    heads = [("main", main_f, out["logits"][0])] + [
        (f"aux{i}", f, a[0]) for i, (f, a) in enumerate(zip(aux_fs, out["aux"]))]
    drop = torch.rand(lbs[0].shape, generator=torch.Generator().manual_seed(3))
    lb = torch.where(drop.to(lbs[0].device) < ignore_share, 255, lbs[0].long())
    rows = []
    for name, f, logits in heads:
        lg = logits.float()
        x = (lg * (3.0 / lg.std())).requires_grad_()
        ce, valid = cross_entropy_upsampled(x, lb, f)
        (g_fused,) = torch.autograd.grad(ce[valid].sum(), x)
        up = F.interpolate(x, scale_factor=f, mode="bilinear", align_corners=False)
        ref, ref_valid = cross_entropy_per_pixel(up, lb)
        (g_ref,) = torch.autograd.grad(ref[ref_valid].sum(), x)
        n, n_ref = int(valid.sum()), int(ref_valid.sum())
        want = torch.sort(ref[ref_valid].detach()).values
        rows.append({"head": name, "logits": list(x.shape), "factor": f,
                     "valid": n, "ref_valid": n_ref, "ce_std": want.std().item(),
                     "ce_rel": rel(torch.sort(ce[valid].detach()).values, want)
                     if n == n_ref else None,
                     "grad_rel": rel(g_fused, g_ref)})
        del ce, valid, g_fused, up, ref, ref_valid, g_ref, want
    emit(phase="train", fused_up_ce=rows)
    bad = [r for r in rows if r["ce_rel"] is None or r["ce_rel"] > 1e-5
           or r["grad_rel"] > 1e-4]
    if bad:
        raise RuntimeError(f"cross_entropy_upsampled against the upsampled CE: {bad}")


TRAINER_OVERRIDES = [
    "dataset1.data_reader", "Synthetic",
    "dataset1.reader_kwargs", "{'n_cats': 19, 'size': [1024, 2048], 'length': 64}",
    "lr.max_iter", "6", "train.ckpt_interval", "3", "train.log_interval", "1"]


def phase_trainer(dev):
    """tools/train_torch.py's main in this process on the config with the
    Synthetic reader at Cityscapes' 1024×2048 frame: 6 steps, checkpoints at
    3 and 6, a fresh Trainer restoring step 6 exactly, --max-iter 8
    resuming to step 8; 10 dropout launches a step and no other kernel's."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_torch

    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.engine.trainer import Trainer
    from mds_tpu_torch.utils.metrics_writer import read_metrics

    with tempfile.TemporaryDirectory() as work:
        args = ["--config", CONFIG, "--work-dir", work] + TRAINER_OVERRIDES
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        run = train_torch.main(args)
        wall_s = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        losses = [r["seg"] for r in read_metrics(os.path.join(work, "runs"))]
        saved = run.ckpt.all_steps()
        fresh = Trainer(Configer(config_file=CONFIG, args_parser=TRAINER_OVERRIDES),
                        work_dir=work, device=dev)
        fresh.restore_if_available()
        names = {id(p): n for n, p in run.model.named_parameters()}
        fresh_params = dict(fresh.model.named_parameters())
        restored = {
            "step": fresh.step, "count": fresh.optimizer.count,
            "state_dict_equal": all(torch.equal(fresh.model.state_dict()[k], v)
                                    for k, v in run.model.state_dict().items()),
            "momentum_equal": len(run.optimizer.state) > 0 and all(
                torch.equal(fresh.optimizer.state[fresh_params[names[id(p)]]]["momentum_buffer"],
                            st["momentum_buffer"]) for p, st in run.optimizer.state.items())}
        del fresh
        reset_counts()
        resumed = train_torch.main(args + ["--max-iter", "8"])
        resume_launches = read_counts()
        resumed_saved = resumed.ckpt.all_steps()
    steps = run.timings
    timed = [r["step_ms"] for r in steps[1:]]  # the first step builds and tunes
    b = sum(int(run.configer.dataset_cfg(i)["ims_per_gpu"])
            for i in range(run.configer.n_datasets))
    res = {"batch": b, "crop": run.configer.get("train", "cropsize"),
           "frame": run.configer.dataset_cfg(0)["reader_kwargs"]["size"],
           "pipeline": run.pipeline, "losses": losses, "checkpoints": saved,
           "restored": restored, "resumed_to": resumed.step,
           "resumed_checkpoints": resumed_saved, "launches": launches,
           "resume_launches": resume_launches,
           "step_ms": [r["step_ms"] for r in steps],
           "median_step_ms": float(np.median(timed)),
           "images_per_s": b / float(np.median(timed)) * 1e3,
           "loader_wait_ms": [r["loader_ms"] for r in steps],
           "median_loader_wait_ms": float(np.median([r["loader_ms"] for r in steps[1:]])),
           "copy_ms": [r["copy_ms"] for r in steps],
           "median_copy_ms": float(np.median([r["copy_ms"] for r in steps])),
           "checkpoint_save_ms": [r["ckpt_ms"] for r in steps if "ckpt_ms" in r],
           "images_per_s_loop": b * len(steps[1:]) / sum(r["loop_ms"] for r in steps[1:]) * 1e3,
           "run_wall_s": wall_s, "images_per_s_wall": b * len(steps) / wall_s,
           "max_memory_allocated": peak}
    emit(phase="trainer", **res)
    want = {k: 0 for k in launches}
    want["dropout_u8"] = 10 * 6
    want_resume = dict(want, dropout_u8=10 * 2)
    if len(losses) != 6 or not np.isfinite(losses).all():
        raise RuntimeError(f"trainer: losses {losses}")
    if saved != [3, 6] or resumed_saved != [3, 6, 8] or resumed.step != 8:
        raise RuntimeError(f"trainer: checkpoints {saved}, {resumed_saved}")
    if restored != {"step": 6, "count": 6, "state_dict_equal": True, "momentum_equal": True}:
        raise RuntimeError(f"trainer: restore {restored}")
    if launches != want or resume_launches != want_resume:
        raise RuntimeError(f"trainer launches {launches}, {resume_launches}")
    return launches["dropout_u8"] + resume_launches["dropout_u8"]


EVAL_OVERRIDES = [
    "dataset1.data_reader", "Synthetic", "dataset1.eval_ims_per_gpu", "1"]
# the served route without the pred tail, as the evaluator's forward runs it
EVAL_ROUTES = {"stem_impl": "kernel", "fuse": True, "tail": True, "depthwise": "kernel"}
EVAL_PER_FORWARD = {"detail_s1s2_fused": 1, "stemblock_fused": 1, "detail_tail_fused": 1,
                    "depthwise3x3": 16}
# mode → (frames, forwards a frame): msf 6 scales and their flips; mscf
# every window of a scale in one call, and its flip, at 6 scales. The first
# frame of a run is cold (new shapes, packs); seconds a frame are the
# median of the others.
EVAL_MODES = {"ss": (4, 1), "ssc": (4, 1), "msf": (3, 12), "mscf": (3, 12)}


def synthetic_frames(n):
    return ["dataset1.reader_kwargs",
            f"{{'n_cats': 19, 'size': [{H}, {W}], 'length': {n}}}"]


@contextlib.contextmanager
def returned(module, name):
    """The return value of every call of module.<name> in the block."""
    real, out = getattr(module, name), []

    def call(*args, **kw):
        out.append(real(*args, **kw))
        return out[-1]

    setattr(module, name, call)
    try:
        yield out
    finally:
        setattr(module, name, real)


def save_served_weights(config, served, seed, work):
    """The served model's weights in the config's full model (its aux heads
    at their seeded init), saved as step 0 through engine/checkpoints.py
    under work/ckpt, where tools/evaluate_torch.py restores them."""
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.engine.checkpoints import CheckpointManager, train_state
    from mds_tpu_torch.engine.optim import build_optimizer
    from mds_tpu_torch.engine.trainer import build_model

    cfg = Configer(config_file=config)
    full = build_model(cfg)
    full.init_weights(torch.Generator().manual_seed(seed))
    missing, unexpected = full.load_state_dict(served.state_dict(), strict=False)
    if unexpected or not missing or not all(k.startswith(("aux", "conv_out16", "conv_out32"))
                                            for k in missing):
        raise RuntimeError(f"served weights: missing {missing}, unexpected {unexpected}")
    ckpt = os.path.join(work, "ckpt")
    CheckpointManager(ckpt).maybe_save(
        train_state(full, build_optimizer(cfg, full, lambda _: 0.0), 0), force=True)
    return ckpt


def _to_cpu(a):
    return a.cpu() if torch.is_tensor(a) else a


@contextlib.contextmanager
def largest_calls(evaluator, keep=4):
    """The first `keep` calls, made in the block, of the evaluator's logits
    functions whose input is the largest: (logits_fn, image, dataset, the
    make_logits_fn arguments that made it). ss's four frames; msf's
    1792×3584 frame and its flip, of two frames; mscf's 25 windows of
    512×1024 and their flip, of two frames. The inputs are held, not
    copied: they add to the run's peak memory."""
    real, out = evaluator.make_logits_fn, []

    def make(*args, **kw):
        fn = real(*args, **kw)

        def logits_fn(im, dataset):
            if out and im.numel() > out[0][1].numel():
                out.clear()
            if len(out) < keep and (not out or im.numel() == out[0][1].numel()):
                out.append((fn, im, dataset, (args, kw)))
            return fn(im, dataset)

        return logits_fn

    evaluator.make_logits_fn = make
    try:
        yield out
    finally:
        evaluator.make_logits_fn = real


# the positional arguments of each kernel of the evaluated forward that its
# plain version takes (the wrapper's last, the model's pack, left out)
EVAL_KERNEL_ARGS = {"detail_s1s2_fused": 10, "stemblock_fused": 13, "detail_tail_fused": 16,
                    "depthwise3x3": 3, "stem7_conv_bn_relu_s2": 4,
                    "stem_conv_bn_relu_s2": 5}


def f32_copy(model):
    """The model in f32: its parameters, buffers and compute dtype."""
    m32 = copy.deepcopy(model).float()
    for m in m32.modules():
        if getattr(m, "dtype", None) == torch.bfloat16:
            m.dtype = torch.float32
    return m32


def logits_off(rec):
    """Whether a record of the routed logits against the plain path fails:
    bench.py:296-297's gate on its rel (and its worst image's, and its
    argmax agreement, where recorded); with an f32 record, the route's
    distance from the f32 model over the plain path's (F32_RATIO_GATE)
    instead."""
    if "f32" in rec:
        return rec["f32"]["routed"] > F32_RATIO_GATE * rec["f32"]["plain"]
    return (max(rec["rel"], rec.get("worst_image_rel", 0.0)) >= LOGITS_GATE
            or rec.get("argmax_agreement", 1.0) <= ARGMAX_GATE)


def largest_call_rels(calls, routes, names, f32_model=None):
    """Each captured call's logits on the route against the plain path, on
    the same model and input: rel max-diff over the batch, and the worst of
    its images' own; every logits tensor checked for shape and finiteness.
    Then each call the routed forward made of the kernels `names`, again
    against its plain version on the same arguments (KERNEL_GATE). Returns
    the records and the failures.

    With `f32_model` (the model in f32), both bf16 paths are also measured
    against its logits of the same input, and the route's gate is its
    distance from f32 over the plain path's (F32_RATIO_GATE) in place of its
    distance from the plain path: a model whose logits are cosines (the
    contrast family's ConvNorm, snp_rn18's clip_logits) holds them in bf16,
    and each bf16 path is about LOGITS_GATE from f32 on its own (on the
    H100, the contrast family: the route 0.0111-0.0155, the plain path
    0.0130-0.0186; clip: the route 0.0153-0.0197, the plain path
    0.0160-0.0196, the two paths 0.0135-0.0206 apart)."""
    from mds_tpu_torch.evaluation import evaluator
    from mds_tpu_torch.ops import depthwise, stem

    out, bad = [], []
    for fn, im, dataset, (make_args, make_kw) in calls:
        with torch.inference_mode():
            ref = fn(im, dataset)
            with contextlib.ExitStack() as stack:
                stack.enter_context(route(**routes))
                seen = {n: stack.enter_context(captured(
                    depthwise if n == "depthwise3x3" else stem, n)) for n in names}
                got = fn(im, dataset)
        # logits at the input's size, at its quarter (snp_rn18's heads) or
        # at its eighth (the contrast model's emb_logits)
        if (got.shape != ref.shape or got.shape[0] != im.shape[0]
                or got.shape[2:] not in (im.shape[2:], (im.shape[2] // 4, im.shape[3] // 4),
                                         (im.shape[2] // 8, im.shape[3] // 8))
                or not (torch.isfinite(got.float()).all()
                        and torch.isfinite(ref.float()).all())):
            raise RuntimeError(f"bad logits {got.shape} {ref.shape} of {im.shape}")
        rec = {"input": list(im.shape), "rel": rel(got, ref),
               "worst_image_rel": max(rel(g, r) for g, r in zip(got, ref)), "kernels": {}}
        if f32_model is not None:
            with torch.inference_mode():
                exact = evaluator.make_logits_fn(f32_model, *make_args[1:], **make_kw)(
                    im, dataset)
            rec["f32"] = {"routed": rel(got, exact), "plain": rel(ref, exact)}
            del exact
        del got, ref
        if logits_off(rec):
            bad.append(f"logits of {rec['input']}: rel {rec['rel']}, "
                       f"worst image {rec['worst_image_rel']}, {rec.get('f32', '')}")
        for n, args_seen in seen.items():
            mod = depthwise if n == "depthwise3x3" else stem
            kernel, plain = getattr(mod, n), getattr(mod, n + "_plain")
            if not args_seen:
                bad.append(f"{n}: not called by the routed forward of {rec['input']}")
            rels = []
            for args in args_seen:
                args = args[:EVAL_KERNEL_ARGS[n]]
                try:
                    with torch.inference_mode():
                        rels.append(check_kernel_output(n, kernel, plain, args)[2])
                except RuntimeError as e:
                    bad.append(f"{n} at {list(args[0].shape)}: {e}")
            rec["kernels"][n] = {"calls": len(args_seen), "max_rel": max(rels, default=None)}
        del seen
        out.append(rec)
    return out, bad


def eval_run(config, ckpt, mode, n_frames, routes, extra=(), overrides=None):
    """tools/evaluate_torch.py's main in this process on the card under the
    route switches: its mIoU, each batch's predictions (read at the
    evaluator's confusion_hist), the kernel launches, each batch's ms
    (CUDA events, the evaluator's timings), peak memory, wall seconds and
    the calls with the largest input (`largest_calls`). `overrides`: the
    config overrides, by default dataset1's Synthetic frames."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import evaluate_torch

    from mds_tpu_torch.evaluation import drivers, evaluator

    if overrides is None:
        overrides = EVAL_OVERRIDES + synthetic_frames(n_frames)
    args = (["--config", config, "--ckpt", ckpt, "--mode", mode,
             "--work-dir", os.path.dirname(ckpt)] + list(extra) + list(overrides))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with route(**routes), captured(evaluator, "confusion_hist", _to_cpu) as hists, \
            returned(evaluator, "_make_evaluator") as evs, \
            returned(drivers, "build_eval_bundle") as bundles, \
            largest_calls(evaluator) as largest:
        reset_counts()
        t0 = time.perf_counter()
        mious = evaluate_torch.main(args)
        wall_s = time.perf_counter() - t0
        launches = read_counts()
    ms = [t["ms"] for t in evs[0].timings]
    return {"mious": mious, "preds": [h[1] for h in hists],
            "launches": launches, "batch_ms": ms,
            "s_per_frame": float(np.median(ms[1:] or ms)) / 1e3,
            "max_memory_allocated": torch.cuda.max_memory_allocated(), "wall_s": wall_s,
            "model": bundles[0], "largest_calls": largest}


def eval_pair(config, ckpt, mode, n_frames, routes, per_forward, forwards,
              overrides=None, datasets=1, argmax_gate=ARGMAX_GATE, f32_gate=False):
    """One mode on the routed and the plain path in turns (routed, plain):
    the share of pixels on which they agree (each frame's beside), exact
    launch counts on both, times; then, on the routed run's largest calls,
    the logits on the route against the plain path (LOGITS_GATE, over the
    batch and on its worst image) and each kernel call of that forward
    against its plain version (KERNEL_GATE): a kernel wrong at one scale or
    on the later windows of a batch moves these where the argmax, summed
    over 12 softmaxes, may not move. `datasets`: how many datasets the
    `overrides` give n_frames each. `argmax_gate` None: the agreement is
    printed, not gated. `f32_gate`: the largest calls' logits are gated on
    their distance from the model in f32 (largest_call_rels' `f32_model`)."""
    routed = eval_run(config, ckpt, mode, n_frames, routes, overrides=overrides)
    plain = eval_run(config, ckpt, mode, n_frames, {}, overrides=overrides)
    n_frames *= datasets
    if len(routed["preds"]) != n_frames or len(plain["preds"]) != n_frames:
        raise RuntimeError(f"eval {mode}: {len(routed['preds'])} and "
                           f"{len(plain['preds'])} batches for {n_frames} frames")
    agree = [share_equal(a, b) for a, b in zip(routed["preds"], plain["preds"])]
    share = float(np.mean(agree))  # every frame has the same pixel count
    classes = [int(p.unique().numel()) for p in plain["preds"]]
    all_classes = int(torch.cat([p.flatten() for p in plain["preds"]]).unique().numel())
    want = {k: 0 for k in routed["launches"]}
    want.update({k: n * forwards * n_frames for k, n in per_forward.items()})
    rec = {"mode": mode, "frames": n_frames, "forwards_a_frame": forwards,
           "pred_shape": list(plain["preds"][0].shape),
           "argmax_agreement": share, "argmax_agreement_per_frame": agree,
           "classes_per_frame": classes,
           "classes": all_classes,
           "miou": {"routed": routed["mious"], "plain": plain["mious"]},
           "s_per_frame": {"routed": routed["s_per_frame"], "plain": plain["s_per_frame"]},
           "batch_ms": {"routed": routed["batch_ms"], "plain": plain["batch_ms"]},
           "max_memory_allocated": {"routed": routed["max_memory_allocated"],
                                    "plain": plain["max_memory_allocated"]},
           "wall_s": {"routed": routed["wall_s"], "plain": plain["wall_s"]},
           "launches": routed["launches"]}
    rec["largest_calls"], bad = largest_call_rels(
        routed["largest_calls"], routes, tuple(per_forward),
        f32_copy(routed["model"]) if f32_gate else None)
    del routed["largest_calls"]
    if routed["launches"] != want:
        bad.append(f"routed launches {routed['launches']}, expected {want}")
    if any(plain["launches"].values()):
        bad.append(f"plain launches {plain['launches']}")
    if argmax_gate is not None and share <= argmax_gate:
        bad.append(f"agreement {share} ({agree})")
    if all_classes < 2:  # a constant map would agree with anything
        bad.append(f"degenerate predictions: {classes} classes")
    return rec, bad, routed["launches"]


def precise_bn_card_vs_cpu(dev):
    """update_bn_stats at (2, 3, 128, 256) f32, dropout off, TF32 off: the
    card's recomputed stats against the CPU's from the same weights and
    batches (rel: max-diff over the larger of the tensor's largest
    magnitude and that of the stats it started from; plain rel beside)."""
    from mds_tpu_torch import MODELS
    from mds_tpu_torch.engine.precise_bn import update_bn_stats
    from mds_tpu_torch.models.layers import FastDropout

    rng = np.random.default_rng(6)
    batches = []
    for _ in range(2):
        im, _ = seg_batch(rng, 2, 128, 256, 19)
        gain = rng.uniform(0.2, 1.0, (2, 1, 1, 1))  # spread the pooled features
        im = (im * gain + rng.uniform(0, 255, (2, 1, 1, 1)) * (1 - gain)) / 255.0
        batches.append(torch.from_numpy(((im - 0.5) / 0.25).astype(np.float32)))
    out = {}
    for d in ("cpu", dev):
        model = MODELS["bisenetv2"](n_classes=(19,), n_bn=1, aux=True, dtype=torch.float32)
        model.init_weights(torch.Generator().manual_seed(WEIGHT_SEED))
        randomize_bn(model, WEIGHT_SEED + 1)
        for m in model.modules():
            if isinstance(m, FastDropout):
                m.rate = 0.0
        model.to(d)
        before = {k: v.double().cpu() for k, v in model.state_dict().items() if "running" in k}
        update_bn_stats(model, [b.to(d).permute(0, 3, 1, 2) for b in batches],
                        lambda m, x: m([x]))
        out[d] = {k: v.double().cpu() for k, v in model.state_dict().items() if "running" in k}
    rels = {k: ((out[dev][k] - v).abs().max()
                / max(v.abs().max(), before[k].abs().max())).item()
            for k, v in out["cpu"].items()}
    plain = {k: rel(out[dev][k], v) for k, v in out["cpu"].items()}
    worst = max(rels, key=rels.get)
    return {"tensors": len(rels), "max_rel": rels[worst], "worst": worst,
            "max_plain_rel": max(plain.values())}


def phase_eval(dev):
    """tools/evaluate_torch.py's main on the card: BiSeNetV2 (the served
    weights, restored from a checkpoint) in ss, ssc, msf and mscf, each on
    the deploy routes without the pred tail and on the plain path in turns;
    BiSeNetV1 in ss with its 7×7 stem kernel and plain; --precise-bn 2 on
    the plain ss path; precise BN's stats on the card against the CPU's."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from serve_torch import build_e2e

    from mds_tpu_torch.engine.checkpoints import CheckpointManager

    t0 = time.perf_counter()
    launches, modes, bad = {}, [], []
    with tempfile.TemporaryDirectory() as work:
        served, _ = v2_model(dev)
        ckpt = save_served_weights(CONFIG, served.model, WEIGHT_SEED, work)
        del served
        for mode, (frames, forwards) in EVAL_MODES.items():
            rec, fail, got = eval_pair(CONFIG, ckpt, mode, frames, EVAL_ROUTES,
                                       EVAL_PER_FORWARD, forwards)
            modes.append(rec)
            bad += [f"{mode}: {f}" for f in fail]
            for k, n in got.items():
                launches[k] = launches.get(k, 0) + n
        v1 = build_e2e(V1_CONFIG, seed=V1_WEIGHT_SEED, device=dev)
        randomize_bn(v1.model, V1_WEIGHT_SEED + 1)
        v1_ckpt = save_served_weights(V1_CONFIG, v1.model, V1_WEIGHT_SEED,
                                      os.path.join(work, "v1"))
        del v1
        rec, fail, got = eval_pair(V1_CONFIG, v1_ckpt, "ss", 2, {"stem_impl": "kernel"},
                                   {"stem7_conv_bn_relu_s2": 2}, 1)
        rec["model"] = "bisenetv1"
        modes.append(rec)
        bad += [f"v1 ss: {f}" for f in fail]
        for k, n in got.items():
            launches[k] += n
        run = eval_run(CONFIG, ckpt, "ss", 1, {}, ["--precise-bn", "2"])
        saved = CheckpointManager(ckpt).restore()[0]["model"]
        stats = {k: v for k, v in run["model"].state_dict().items() if "running" in k}
        moved = sum(not torch.equal(v.cpu(), saved[k]) for k, v in stats.items())
        pbn = {"miou": run["mious"], "launches": run["launches"], "wall_s": run["wall_s"],
               "stats": len(stats), "stats_moved": moved,
               "finite": all(bool(torch.isfinite(v).all()) for v in stats.values()),
               "eval_mode": not run["model"].training}
        del run
    want_pbn = {k: 0 for k in pbn["launches"]}
    want_pbn["dropout_u8"] = 10  # 2 batches × 5 heads, forward only
    if pbn["launches"] != want_pbn:
        bad.append(f"precise BN launches {pbn['launches']}")
    if not (pbn["finite"] and pbn["eval_mode"] and pbn["stats_moved"] == pbn["stats"]):
        bad.append(f"precise BN stats: {pbn}")
    launches["dropout_u8"] += pbn["launches"]["dropout_u8"]
    pbn["card_vs_cpu"] = precise_bn_card_vs_cpu(dev)
    if not pbn["card_vs_cpu"]["max_rel"] < F32_GATE:
        bad.append(f"precise BN card vs CPU: {pbn['card_vs_cpu']}")
    emit(phase="eval", config=os.path.relpath(CONFIG, ROOT), modes=modes,
         precise_bn=pbn, launches=launches, seconds=time.perf_counter() - t0)
    if bad:
        raise RuntimeError(f"eval: {bad}")
    return launches


FLAGSHIP_CONFIG = os.path.join(ROOT, "configs", "ltbgnn_3_datasets_snp.json")
FLAGSHIP_CATS = (11, 19, 36)  # CamVid, Cityscapes, A2D2: M = int(0.8 · 66) = 52
# Synthetic frames a dataset for the trainer (its sampler cycles through
# them: 6 steps take 24 crops of each dataset)
FLAGSHIP_LENGTH = 8
FLAGSHIP_STEPS = ["GNN", "GNN", "SEG", "SEG", "GNN", "GNN"]


def synthetic_readers(cats, length, eval_batch=False):
    """Each dataset on the Synthetic reader at H×W with its own class count
    (`cats`, in the config's order); its spec, crop and batch stay the
    config's."""
    out = []
    for i, n in enumerate(cats, 1):
        out += [f"dataset{i}.data_reader", "Synthetic", f"dataset{i}.reader_kwargs",
                f"{{'n_cats': {n}, 'size': [{H}, {W}], 'length': {length}, 'seed': {i}}}"]
        if eval_batch:
            out += [f"dataset{i}.eval_ims_per_gpu", "1"]
    return out


FLAGSHIP_OVERRIDES = synthetic_readers(FLAGSHIP_CATS, FLAGSHIP_LENGTH) + [
    "train.gnn_iters", "2", "train.seg_iters", "2", "lr.max_iter", "6",
    "train.ckpt_interval", "3", "train.log_interval", "1"]


@contextlib.contextmanager
def step_launches(records):
    """Each AlternatingTrainer.step in the block: its stage after the step,
    the kernel-6 launches the step made and its metrics' names."""
    from mds_tpu_torch.engine import gnn_trainer
    from mds_tpu_torch.ops import stem

    real = gnn_trainer.AlternatingTrainer.step

    def step(self, batch, generator=None):
        before = stem.stem7_conv_bn_relu_s2.launches
        out = real(self, batch, generator)
        records.append({"stage": self.stage,
                        "stem7": stem.stem7_conv_bn_relu_s2.launches - before,
                        "metrics": sorted(out)})
        return out

    gnn_trainer.AlternatingTrainer.step = step
    try:
        yield
    finally:
        gnn_trainer.AlternatingTrainer.step = real


def same_state(a, b):
    """Whether two nested dicts and lists of tensors and values are equal,
    tensors bit for bit wherever they lie."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_state(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same_state(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.equal(a.cpu(), b.cpu())
    return a == b


def trainer_state_equal(a, b):
    """Whether two AlternatingTrainers hold the same state: both nets, both
    AdamW states, βs, UOT graphs and the stage machine."""
    from mds_tpu_torch.engine.optim import optimizer_state

    out = {"seg": same_state(a.seg_model.state_dict(), b.seg_model.state_dict()),
           "gnn": same_state(a.gnn_model.state_dict(), b.gnn_model.state_dict()),
           "seg_optimizer": same_state(optimizer_state(a.seg_model, a.seg_opt),
                                       optimizer_state(b.seg_model, b.seg_opt)),
           "gnn_optimizer": same_state(optimizer_state(a.gnn_model, a.gnn_opt),
                                       optimizer_state(b.gnn_model, b.gnn_opt)),
           "betas": all(np.array_equal(x, y) for x, y in zip(a.betas, b.betas)),
           "graphs": all(np.array_equal(x, y) for x, y in zip(a.uot_bi, b.uot_bi))}
    out["meta"] = all(getattr(a, k) == getattr(b, k) for k in (
        "stage", "alter_iter", "init_iters", "total_iter", "gnn_lr_scale", "seg_steps",
        "gnn_steps"))
    return out


def stem7_calls_rels(calls):
    """Each captured kernel-6 call against its plain version: rel max-diff
    (KERNEL_GATE) and the bit-equal share (BIT_EQUAL_GATE)."""
    from mds_tpu_torch.ops import stem

    out = []
    for args in calls:
        args = args[:EVAL_KERNEL_ARGS["stem7_conv_bn_relu_s2"]]
        with torch.inference_mode():
            got, want, r = check_kernel_output(
                "stem7_conv_bn_relu_s2", stem.stem7_conv_bn_relu_s2,
                stem.stem7_conv_bn_relu_s2_plain, args)
        out.append({"input": list(args[0].shape), "rel": r,
                    "bit_equal": share_equal(bits(got), bits(want))})
    return out


def flagship_batch(rng, dev, cats=FLAGSHIP_CATS, crop=(768, 768), b=4, ignore=0.05):
    """uint8 crops and label maps (5% ignored) of each dataset (its class
    count in `cats`) on the card."""
    ims, lbs = [], []
    for n in cats:
        lb = rng.integers(0, n, (b, *crop))
        lb[rng.random(lb.shape) < ignore] = 255
        ims.append(torch.from_numpy(rng.integers(0, 256, (b, *crop, 3), dtype=np.uint8)).to(dev))
        lbs.append(torch.from_numpy(lb.astype(np.uint8)).to(dev))
    return ims, lbs


def alone_ms(step, n=3):
    """`step()` once warm, then `n` timed (CUDA events): their ms and the
    peak memory of the timed ones."""
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out, torch.cuda.max_memory_allocated()


def phase_flagship(dev):
    """The flagship snp_rn18 + BGNN (configs/ltbgnn_3_datasets_snp.json at
    full width, bf16) through its three entry points with kernel 6 on:
    train_from_config with gnn=True, as tools/train_torch.py --gnn calls it
    (2 GNN steps, the UOT switch, 2 SEG steps, the re-entry, 2 GNN steps;
    checkpoints at 3 and 6), a fresh trainer restoring step 6, the served
    frame from that checkpoint's weights, and tools/evaluate_torch.py in
    contrast and ss on its checkpoint."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from serve_torch import build_e2e

    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.engine.gnn_trainer import AlternatingTrainer
    from mds_tpu_torch.engine.trainer import train_from_config
    from mds_tpu_torch.engine.train_step import normalize_images
    from mds_tpu_torch.ops import stem

    t0 = time.perf_counter()
    bad, launches = [], {}
    rng = np.random.default_rng(7)
    with tempfile.TemporaryDirectory() as work:
        # ---- training: what tools/train_torch.py --gnn runs, in bf16
        steps = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with route(stem_impl="kernel"), step_launches(steps):
            run = train_from_config(FLAGSHIP_CONFIG, FLAGSHIP_OVERRIDES, work_dir=work,
                                    device=dev, gnn=True, compute_dtype=torch.bfloat16)
        train_launches = read_counts()
        train_peak = torch.cuda.max_memory_allocated()
        timings = run.timings
        stages = [r["stage"] for r in timings]
        losses = [r["loss"] for r in timings]
        want = {k: 0 for k in train_launches}
        want["stem7_conv_bn_relu_s2"] = 9 * FLAGSHIP_STEPS.count("GNN")
        per_step = [r["stem7"] for r in steps]
        if stages != FLAGSHIP_STEPS or len(losses) != 6 or not np.isfinite(losses).all():
            bad.append(f"train: stages {stages}, losses {losses}")
        if per_step != [9 if st == "GNN" else 0 for st in FLAGSHIP_STEPS]:
            bad.append(f"train: kernel-6 launches a step {per_step}")
        if train_launches != want:
            bad.append(f"train launches {train_launches}, expected {want}")
        graphs = run.uot_bi or []
        graph_ok = len(graphs) == 3 and all(
            g.shape == (n, 52) and (g.sum(axis=0) == 1).all() and (g.sum(axis=1) >= 1).all()
            for g, n in zip(graphs, FLAGSHIP_CATS))
        if not graph_ok:
            bad.append("UOT graphs: not one row a column and a column a row")
        lr_scale = run.gnn_lr_scale
        if lr_scale != max(0.1, 1 - 2 / 6):
            bad.append(f"gnn_lr_scale {lr_scale}")
        saved = run.latest_step(os.path.join(work, "ckpt_gnn"))
        cfg = Configer(config_file=FLAGSHIP_CONFIG, args_parser=FLAGSHIP_OVERRIDES)
        fresh = AlternatingTrainer(cfg, compute_dtype=torch.bfloat16, device=dev)
        fresh.restore(os.path.join(work, "ckpt_gnn"))
        restored = trainer_state_equal(run, fresh)
        if saved != 6 or not all(restored.values()):
            bad.append(f"restore of step {saved}: {restored}")

        # one GNN step's frozen features: routed against plain, and every
        # kernel-6 call of that forward against its plain version
        ims, lbs = flagship_batch(rng, dev)
        xs = normalize_images(ims, run.means, run.stds, torch.bfloat16)
        run.seg_model.eval()
        with torch.no_grad():
            plain_feats = run.seg_model.features(xs)
            with route(stem_impl="kernel"), captured(stem, "stem7_conv_bn_relu_s2") as calls:
                routed_feats = run.seg_model.features(xs)
        feats_rel = [rel(a, b) for a, b in zip(routed_feats, plain_feats)]
        kernel_rels = stem7_calls_rels(calls)
        del plain_feats, routed_feats, calls
        if len(kernel_rels) != 9 or max(feats_rel) >= LOGITS_GATE:
            bad.append(f"features routed vs plain: rel {feats_rel}, {len(kernel_rels)} calls")
        if min(k["bit_equal"] for k in kernel_rels) < BIT_EQUAL_GATE:
            bad.append(f"kernel 6 bit-equal share {kernel_rels}")

        # the SEG step alone on the fixed batch: a warm step, then 5 timed
        seg_alone_ms, seg_alone_peak = alone_ms(lambda: fresh.seg_step(ims, lbs), n=5)
        del fresh, ims, lbs, xs

        # ---- serving: build_e2e on the checkpoint's seg weights
        weights = os.path.join(work, "snp_rn18.pt")
        torch.save({k: v.cpu() for k, v in run.seg_model.state_dict().items()}, weights)
        e2e = build_e2e(FLAGSHIP_CONFIG, weights=weights, device=dev)
        served_graph = e2e.model.bipartite_graphs[0].cpu().numpy()
        if not (served_graph.any() and np.array_equal(served_graph, graphs[0])):
            bad.append("served graphs are not the checkpoint's UOT graphs")
        del run
        frames = np.random.default_rng(8).integers(0, 256, (2, 1, H, W, 3)).astype(np.uint8)
        served = serve_and_check(e2e, "snp_rn18", frames, FLAGSHIP_CATS[0], stem_impl="kernel")
        want = {k: 0 for k in served["launches"]}
        want["stem7_conv_bn_relu_s2"] = 3 * len(frames)
        if served["launches"] != want:
            bad.append(f"served launches {served['launches']}, expected {want}")
        if min(served["agree"]) <= ARGMAX_GATE:
            bad.append(f"served agreement {served['agree']}")
        x = normalized(e2e, frames[0])
        with torch.inference_mode():
            ref = e2e.model.eval_logits(x)
            with route(stem_impl="kernel"), captured(stem, "stem7_conv_bn_relu_s2") as calls:
                got = e2e.model.eval_logits(x)
        if got.shape != (1, FLAGSHIP_CATS[0], H // 4, W // 4) or not torch.isfinite(got).all():
            bad.append(f"served logits {got.shape}")
        serve_logits_rel = rel(got, ref)
        serve_kernel_rels = stem7_calls_rels(calls)
        del calls, got, ref
        if serve_logits_rel >= LOGITS_GATE or len(serve_kernel_rels) != 3:
            bad.append(f"served logits rel {serve_logits_rel}, {len(serve_kernel_rels)} calls")
        frame_ms = {"kernel": [], "plain": []}
        for k, kw in (("kernel", {"stem_impl": "kernel"}), ("plain", {}),
                      ("plain", {}), ("kernel", {"stem_impl": "kernel"})):
            frame_ms[k].append(e2e_ms(e2e, frames[1], **kw))
        profiles = {}
        for k, kw in (("kernel", {"stem_impl": "kernel"}), ("plain", {})):
            with route(**kw):
                profiles[k] = profile_idle_share(lambda: e2e(torch.from_numpy(frames[1])),
                                                 ("stem7_kernel",))
        del e2e

        # ---- evaluation: tools/evaluate_torch.py on the checkpoint
        modes = []
        eval_launches = 0
        # the labels' agreement is printed, not gated: on the Synthetic
        # frames' flat blocks this random model's summed unified logits sit
        # near ties (0.9931 and 0.9935 of the pixels in the first card run,
        # while the served noise frames agree on 0.9997); the logits of the
        # largest calls and every kernel-6 call of them are gated
        for mode in ("contrast", "ss"):
            rec, fail, got = eval_pair(
                FLAGSHIP_CONFIG, os.path.join(work, "ckpt_gnn"), mode, 2,
                {"stem_impl": "kernel"}, {"stem7_conv_bn_relu_s2": 3}, 1,
                overrides=synthetic_readers(FLAGSHIP_CATS, 2, eval_batch=True), datasets=3,
                argmax_gate=None)
            modes.append(rec)
            bad += [f"eval {mode}: {f}" for f in fail]
            eval_launches += got["stem7_conv_bn_relu_s2"]
    gnn_ms = [r["step_ms"] for r in timings if r["stage"] == "GNN"]
    seg_ms = [r["step_ms"] for r in timings if r["stage"] == "SEG"]
    seg_images = 4 * len(FLAGSHIP_CATS)
    launches["stem7_conv_bn_relu_s2"] = (train_launches["stem7_conv_bn_relu_s2"]
                                         + served["launches"]["stem7_conv_bn_relu_s2"]
                                         + eval_launches)
    emit(phase="flagship", config=os.path.relpath(FLAGSHIP_CONFIG, ROOT),
         dtype="bfloat16", stages=stages, losses=losses,
         kernel6_launches_per_step=per_step, train_launches=train_launches,
         step_ms=[r["step_ms"] for r in timings],
         gnn_step_ms=float(np.median(gnn_ms[1:])), seg_step_in_loop_ms=seg_ms[1:],
         seg_step_alone_ms=seg_alone_ms, seg_step_ms=float(np.median(seg_alone_ms)),
         seg_images_per_s=seg_images / float(np.median(seg_alone_ms)) * 1e3,
         seg_step_max_memory_allocated=seg_alone_peak,
         uot_switch_ms=[r["switch_ms"] for r in timings if "switch_ms" in r],
         train_max_memory_allocated=train_peak, gnn_lr_scale=lr_scale,
         uot_graph_columns=[g.sum(axis=1).tolist() for g in graphs],
         restored=restored, features_rel=feats_rel, kernel6_calls=kernel_rels,
         serve={"latency_ms": served["latency_ms"], "classes": served["classes"],
                "agreement": served["agree"], "logits_rel": serve_logits_rel,
                "kernel6_calls": serve_kernel_rels, "e2e_ms": frame_ms, "profile": profiles},
         eval=modes, launches=launches, seconds=time.perf_counter() - t0)
    if bad:
        raise RuntimeError(f"flagship: {bad}")
    return launches


# ------------------------------------------------ the flagship's graph layer
FLAGSHIP7_CONFIG = os.path.join(ROOT, "configs", "ltbgnn_7_datasets_snp_train_tg.json")
FLAGSHIP7_STEPS = ["GNN", "GNN", "SEG", "SEG"]
GAT_CONFIG = os.path.join(ROOT, "configs", "ltbgnn_3_datasets_gat.json")
CLIP_CONFIG = os.path.join(ROOT, "configs", "clip_5_datasets.json")
STEM7_LEVELS = 3  # snp_rn18's pyramid levels: kernel 6 once each a dataset
# a frozen prototype after 4 AdamW steps against its seeded value times the
# decay: 4 f32 roundings of p − lr·wd·p (4 × 2⁻²⁴ ≈ 2.4e-7); an unfrozen one
# moves by about lr = 1e-3
PROTO_GATE = 1e-6
# one GNN → switch → SEG run of each graph net a config names or an option
# sets: (config, overrides)
FORK_RUNS = {
    "bgat": (GAT_CONFIG, []),
    "cosine": (FLAGSHIP_CONFIG, ["GNN.model_name", "learnable_topology_BGNN"]),
    "adv": (FLAGSHIP_CONFIG, ["GNN.mse_or_adv", "adv"]),
    "gumbel": (FLAGSHIP_CONFIG, ["GNN.GumbelSoftmax", "True"]),
    "km": (FLAGSHIP_CONFIG, ["GNN.use_km", "True"]),
    "sfg": (FLAGSHIP_CONFIG, ["GNN.model_name", "learnable_topology_BGNN_sfg"]),
}
# the card-vs-CPU f32 GNN step of each fork at test width: its GNN options
FORK_PARITY = {"cosine": {"model_name": "learnable_topology_BGNN"},
               "bgat": {"model_name": "learnable_topology_BGAT"},
               "direct_full": {"model_name": "learnable_topology_BGNN_adj3"},
               "adv": {"mse_or_adv": "adv"},
               "gumbel": {"GumbelSoftmax": True}}
# the test width of tests/torch_flagship_parity.py: ResNet layers [1, 1, 1,
# 1], planes [64, 16, 24, 32], 16 features, nfeat 32, 2 datasets, M = 5
TEST_WIDTH = {
    "model_name": "snp_rn18", "n_datasets": 2, "seed": 0, "network": {"efficient": False},
    "backbone": {"layers": [1, 1, 1, 1], "planes": [64, 16, 24, 32], "num_features": 16},
    "dataset1": {"n_cats": 3, "ims_per_gpu": 2}, "dataset2": {"n_cats": 4, "ims_per_gpu": 2},
    "GNN": {"model_name": "learnable_topology_BGNN_adj", "nfeat": 32, "nfeat_out": 16,
            "nfeat_adj": 16, "output_feat_dim": 16, "unify_ratio": 0.8, "dropout_rate": 0.0,
            "GNN_type": "GSAGE", "mse_or_adv": "None", "output_max_adj": True,
            "output_softmax_and_max_adj": True, "with_orth": True, "uot_ratio": 1.0},
    "loss": {"with_datasets_aux": True, "aux_weight": 0.2, "ignore_index": 255},
    "lr": {"seg_lr_start": 1e-3, "gnn_lr_start": 1e-3, "weight_decay": 1e-5,
           "max_iter": 20, "warmup_iters": 0, "init_iter": 0},
    "train": {"seg_iters": 2, "gnn_iters": 2, "cropsize": [64, 64]},
}


def config_cats(config):
    from mds_tpu_torch.config import Configer

    cfg = Configer(config_file=config)
    return tuple(cfg.n_cats(i) for i in range(cfg.n_datasets))


def node_features_file(config, path):
    """The hashed node features with one row for each class the config
    declares, saved to `path` for GNN.node_features_path: a spec that names
    fewer classes (CamVid's 11 against configs/clip_5_datasets.json's 12)
    is padded with dataset{i}_class{j} names, as a user gives the trainer
    Σ n_cats rows of CLIP features."""
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.data.node_features import class_names_of, gen_graph_node_features

    cfg = Configer(config_file=config)
    names = [ns + [f"dataset{i}_class{j}" for j in range(len(ns), cfg.n_cats(i))]
             for i, ns in enumerate(class_names_of(cfg))]
    np.save(path, gen_graph_node_features(class_names=names, nfeat=int(cfg.get("GNN", "nfeat"))))
    return path


def graphs_ok(graphs, cats, M):
    """Each dataset's 0/1 graph (n_cats, M): one row a column and at least
    one column a row."""
    return len(graphs) == len(cats) and all(
        g.shape == (n, M) and (g.sum(axis=0) == 1).all() and (g.sum(axis=1) >= 1).all()
        for g, n in zip(graphs, cats))


def train_alternating_run(config, overrides, work, dev, steps):
    """train_from_config (what tools/train_torch.py calls) in bf16 with
    kernel 6 on: the trainer with its timings read back, the run's
    launches and peak memory; `steps` gets each step's stage, kernel-6
    launches and metric names."""
    from mds_tpu_torch.engine.trainer import train_from_config

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with route(stem_impl="kernel"), step_launches(steps):
        run = train_from_config(config, overrides, work_dir=work, device=dev, gnn=True,
                                compute_dtype=torch.bfloat16)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    run.read_timings()
    return run, launches, peak


def phase_flagship7(dev):
    """The 7-dataset flagship (configs/ltbgnn_7_datasets_snp_train_tg.json:
    snp_rn18 + the direct BGNN its GNN name builds; 19, 64, 37, 19, 26,
    150 and 133 classes, M = 358) at full width in bf16, the config's 4
    crops of 768×768 a dataset of Synthetic 1024×2048 frames, kernel 6 on:
    train_from_config with gnn=True takes GNN, GNN, the UOT switch, SEG,
    SEG (a checkpoint at 4): 21 kernel-6 launches a GNN step and none a
    SEG step, the UOT graphs, a fresh trainer restoring step 4 exactly;
    one GNN step's frozen features routed against plain and its 21
    kernel-6 calls against their plain version; the GNN and the SEG step
    alone on one fixed batch (3 timed after a warm one each) and their
    peak memory."""
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.engine.gnn_trainer import AlternatingTrainer
    from mds_tpu_torch.engine.trainer import step_generator
    from mds_tpu_torch.engine.train_step import normalize_images
    from mds_tpu_torch.ops import stem

    t0 = time.perf_counter()
    cats = config_cats(FLAGSHIP7_CONFIG)
    a_step = STEM7_LEVELS * len(cats)
    overrides = synthetic_readers(cats, 4) + [
        "train.gnn_iters", "2", "train.seg_iters", "2", "lr.max_iter", "4",
        "train.ckpt_interval", "4", "train.log_interval", "1"]
    cfg = Configer(config_file=FLAGSHIP7_CONFIG, args_parser=overrides)
    bad, steps = [], []
    with tempfile.TemporaryDirectory() as work:
        run, train_launches, train_peak = train_alternating_run(
            FLAGSHIP7_CONFIG, overrides, work, dev, steps)
        M, timings = run.M, run.timings
        stages = [r["stage"] for r in timings]
        losses = [r["loss"] for r in timings]
        per_step = [r["stem7"] for r in steps]
        want = {k: 0 for k in train_launches}
        want["stem7_conv_bn_relu_s2"] = a_step * FLAGSHIP7_STEPS.count("GNN")
        if stages != FLAGSHIP7_STEPS or not np.isfinite(losses).all():
            bad.append(f"train: stages {stages}, losses {losses}")
        if per_step != [a_step if s == "GNN" else 0 for s in FLAGSHIP7_STEPS]:
            bad.append(f"train: kernel-6 launches a step {per_step}")
        if train_launches != want:
            bad.append(f"train launches {train_launches}, expected {want}")
        # each dataset class's fewest and most unified columns
        graph_columns = [[int(g.sum(axis=1).min()), int(g.sum(axis=1).max())]
                         for g in run.uot_bi or []]
        if not graphs_ok(run.uot_bi or [], cats, M):
            bad.append("UOT graphs: not one row a column and a column a row")
        fresh = AlternatingTrainer(cfg, compute_dtype=torch.bfloat16, device=dev)
        fresh.restore(os.path.join(work, "ckpt_gnn"))
        restored = trainer_state_equal(run, fresh)
        saved = run.latest_step(os.path.join(work, "ckpt_gnn"))
        if saved != 4 or not all(restored.values()):
            bad.append(f"restore of step {saved}: {restored}")
    del run

    # one GNN step's frozen features: routed against plain, and every
    # kernel-6 call of that forward against its plain version
    ims, lbs = flagship_batch(np.random.default_rng(17), dev, cats,
                              tuple(cfg.get("train", "cropsize")),
                              int(cfg.dataset_cfg(0)["ims_per_gpu"]))
    xs = normalize_images(ims, fresh.means, fresh.stds, torch.bfloat16)
    fresh.seg_model.eval()
    with torch.no_grad():
        plain_feats = fresh.seg_model.features(xs)
        with route(stem_impl="kernel"), captured(stem, "stem7_conv_bn_relu_s2") as calls:
            routed_feats = fresh.seg_model.features(xs)
    feats_rel = [rel(a, b) for a, b in zip(routed_feats, plain_feats)]
    kernel_rels = stem7_calls_rels(calls)
    del plain_feats, routed_feats, calls, xs
    if len(kernel_rels) != a_step or max(feats_rel) >= LOGITS_GATE:
        bad.append(f"features routed vs plain: rel {feats_rel}, {len(kernel_rels)} calls")
    if max(k["rel"] for k in kernel_rels) >= KERNEL_GATE:
        bad.append(f"kernel-6 calls against their plain version: {kernel_rels}")
    with route(stem_impl="kernel"):
        gnn_ms, gnn_peak = alone_ms(lambda: fresh.gnn_step(
            ims, lbs, step_generator(fresh.seed, fresh.gnn_steps), max_rate=0.5))
    seg_ms, seg_peak = alone_ms(lambda: fresh.seg_step(ims, lbs))
    images = sum(x.shape[0] for x in ims)
    del fresh, ims, lbs
    emit(phase="flagship7", config=os.path.relpath(FLAGSHIP7_CONFIG, ROOT), dtype="bfloat16",
         cats=list(cats), unified=M, images_a_step=images, crop=cfg.get("train", "cropsize"),
         stages=stages, losses=losses, kernel6_launches_per_step=per_step,
         train_launches=train_launches, step_ms=[r["step_ms"] for r in timings],
         uot_switch_ms=[r["switch_ms"] for r in timings if "switch_ms" in r],
         train_max_memory_allocated=train_peak, uot_graph_columns=graph_columns,
         restored=restored, features_rel=feats_rel, kernel6_calls=kernel_rels,
         gnn_step_alone_ms=gnn_ms, gnn_step_ms=float(np.median(gnn_ms)),
         gnn_step_max_memory_allocated=gnn_peak,
         seg_step_alone_ms=seg_ms, seg_step_ms=float(np.median(seg_ms)),
         seg_images_per_s=images / float(np.median(seg_ms)) * 1e3,
         seg_step_max_memory_allocated=seg_peak, seconds=time.perf_counter() - t0)
    if bad:
        raise RuntimeError(f"flagship7: {bad}")
    return {"stem7_conv_bn_relu_s2": train_launches["stem7_conv_bn_relu_s2"]}


def fork_run(name, dev):
    """FORK_RUNS[name] through train_from_config at full width in bf16, the
    config's crops and batch of Synthetic frames, kernel 6 on: one GNN
    step, the switch, one SEG step; its record and its faults."""
    config, extra = FORK_RUNS[name]
    cats = config_cats(config)
    overrides = synthetic_readers(cats, 2) + [
        "train.gnn_iters", "1", "train.seg_iters", "1", "lr.max_iter", "2",
        "train.ckpt_interval", "100", "train.log_interval", "1"] + extra
    steps = []
    with tempfile.TemporaryDirectory() as work:
        run, launches, peak = train_alternating_run(config, overrides, work, dev, steps)
    # the matching again on the same block: the switch's host cost without
    # its first calls (the KM run's first imports scipy.optimize)
    t0 = time.perf_counter()
    run.optimal_matching()
    rematch_ms = (time.perf_counter() - t0) * 1e3
    g = run.gnn_model
    rec = {"config": os.path.relpath(config, ROOT), "overrides": extra,
           "adj_mode": g.adj_mode, "gnn_type": g.gnn_type, "layers": len(g.gcn_layers),
           "mse_or_adv": g.mse_or_adv, "gumbel": run.gumbel, "km": run.use_km,
           "nodes": g.total_nodes + g.max_num_unify_class,
           "stages": [r["stage"] for r in run.timings],
           "losses": [r["loss"] for r in run.timings],
           "step_ms": [r["step_ms"] for r in run.timings],
           "switch_ms": [r["switch_ms"] for r in run.timings if "switch_ms" in r],
           "rematch_ms": rematch_ms,
           "kernel6_launches_per_step": [r["stem7"] for r in steps],
           "gnn_metrics": steps[0]["metrics"], "max_memory_allocated": peak,
           "crops": [int(run.configer.dataset_cfg(i)["ims_per_gpu"]) for i in range(len(cats))]}
    bad = []
    if rec["stages"] != ["GNN", "SEG"] or not np.isfinite(rec["losses"]).all():
        bad.append(f"stages {rec['stages']}, losses {rec['losses']}")
    if rec["kernel6_launches_per_step"] != [STEM7_LEVELS * len(cats), 0] or (
            launches["stem7_conv_bn_relu_s2"] != STEM7_LEVELS * len(cats)):
        bad.append(f"kernel-6 launches {rec['kernel6_launches_per_step']}, {launches}")
    if not graphs_ok(run.uot_bi or [], cats, run.M):
        bad.append("graphs: not one row a column and a column a row")
    want = {"bgat": ("cosine", "GAT"), "cosine": ("cosine", "GSAGE"),
            "sfg": ("direct_full", "GSAGE")}.get(name, ("direct", "GSAGE"))
    if (g.adj_mode, g.gnn_type) != want or (name == "sfg") != (rec["layers"] == 3):
        bad.append(f"graph net {g.adj_mode}, {g.gnn_type}, {rec['layers']} layers")
    if (name == "adv") != ("adv_loss" in rec["gnn_metrics"]):
        bad.append(f"GNN step metrics {rec['gnn_metrics']}")
    if name == "km" and not all(np.allclose(b, 1.0 / c) for b, c in zip(run.betas, cats)):
        bad.append("KM moved the UOT βs")
    return rec, bad, launches["stem7_conv_bn_relu_s2"]


def fork_step_record(dev, gnn, batch):
    """One f32 GNN step (test width, dropout 0, TF32 off) of the fork with
    GNN options `gnn` on `dev` from the seeded init: loss, gradients,
    groups (a parameter's module), parameters after it. Gumbel noise is
    drawn on the CPU from the step's generator, so both devices draw the
    same."""
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.engine.gnn_trainer import AlternatingTrainer

    cfg = copy.deepcopy(TEST_WIDTH)
    cfg["GNN"].update(gnn)
    t = AlternatingTrainer(Configer(configs=cfg), device=dev)
    ims = [torch.from_numpy(x).to(dev) for x in batch["ims"]]
    lbs = [torch.from_numpy(x).to(dev) for x in batch["lbs"]]
    metrics = t.gnn_step(ims, lbs, torch.Generator().manual_seed(5), max_rate=0.5, tau=1.0)
    named = dict(t.gnn_model.named_parameters())
    # an unused parameter (the last discriminator's) has no gradient: zero
    return {"loss": float(metrics["loss"].detach()),
            "grads": {k: (torch.zeros_like(p) if p.grad is None else p.grad).cpu().double()
                      for k, p in named.items()},
            "group": {k: k.split(".")[0] for k in named},
            "params": {k: p.detach().cpu() for k, p in named.items()}}


def phase_graph_forks(dev):
    """Each graph net and option the flagship's configs name or set, at full
    width in bf16 through train_from_config (GNN, the switch, SEG):
    configs/ltbgnn_3_datasets_gat.json's BGAT (3 datasets, 512×1024, 64 +
    51 nodes), and configs/ltbgnn_3_datasets_snp.json with the cosine
    BGNN, the adversarial GNN, Gumbel graphs, KM matching and the sfg fork
    (one override each): 9 kernel-6 launches in the GNN step, none in the
    SEG step, valid graphs. Then one f32 GNN step of the cosine, BGAT,
    direct_full, adversarial and Gumbel forks at test width on the card and
    on the CPU from the same init, generator and Gumbel noise: loss rel,
    per-group gradient cosine, parameters after the step."""
    t0 = time.perf_counter()
    bad, runs, launches = [], {}, 0
    for name in FORK_RUNS:
        rec, fail, n = fork_run(name, dev)
        runs[name] = rec
        bad += [f"{name}: {f}" for f in fail]
        launches += n
        torch.cuda.empty_cache()
    rng = np.random.default_rng(19)
    batch = {"ims": [], "lbs": []}
    for n in (3, 4):
        im, lb = seg_batch(rng, 2, 64, 64, n)
        batch["ims"].append(im)
        batch["lbs"].append(lb)
    parity = {}
    for name, gnn in FORK_PARITY.items():
        with route(stem_impl="kernel"):  # f32: the plain stem on both devices
            a, b = (fork_step_record(d, gnn, batch) for d in (dev, "cpu"))
        cos, rels = group_agreement(a, b)
        parity[name] = {"loss_cuda": a["loss"], "loss_cpu": b["loss"],
                        "loss_rel": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
                        "grad_cosine": cos, "param_rel": max(rels.values())}
        p = parity[name]
        if (p["loss_rel"] >= F32_GATE or min(cos.values()) <= 0.9999
                or p["param_rel"] >= F32_GATE):
            bad.append(f"card vs CPU {name}: {p}")
    emit(phase="graph_forks", dtype="bfloat16", runs=runs, card_vs_cpu=parity,
         seconds=time.perf_counter() - t0)
    if bad:
        raise RuntimeError(f"graph_forks: {bad}")
    return {"stem7_conv_bn_relu_s2": launches}


def phase_clip(dev):
    """train.mode clip (configs/clip_5_datasets.json: snp_rn18, 5 datasets
    of 19, 12, 37, 19 and 26 classes, M = 90) at full width in bf16, the
    config's 2 crops of 512×1024 a dataset of Synthetic frames, the hashed
    node features padded to the config's 113 classes (`node_features_file`):
    train_from_config takes 4 SEG steps against the node features' text
    prototypes, frozen (each prototype its seeded value times Π(1 −
    lr_t·wd) within f32 rounding; the backbone moves), no kernel-6
    launch (train mode); the SEG step alone on one fixed batch (3 timed
    after a warm one); then tools/evaluate_torch.py --mode clip on its
    checkpoint, routed (kernel 6 three times a forward, its largest calls
    against plain) and plain. clip's logits are cosines against the
    prototype rows, so the largest calls' logits are gated against the
    model in f32 (eval_pair's `f32_gate`), as the contrast family's are."""
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.engine.gnn_trainer import AlternatingTrainer

    t0 = time.perf_counter()
    cats = config_cats(CLIP_CONFIG)
    bad, steps = [], []
    with tempfile.TemporaryDirectory() as work:
        features = ["GNN.node_features_path",
                    node_features_file(CLIP_CONFIG, os.path.join(work, "node_features.npy"))]
        overrides = synthetic_readers(cats, 4) + features + [
            "lr.max_iter", "4", "train.ckpt_interval", "4", "train.log_interval", "1"]
        cfg = Configer(config_file=CLIP_CONFIG, args_parser=overrides)
        run, train_launches, peak = train_alternating_run(CLIP_CONFIG, overrides, work, dev,
                                                          steps)
        stages = [r["stage"] for r in run.timings]
        losses = [r["loss"] for r in run.timings]
        if stages != ["SEG"] * 4 or not np.isfinite(losses).all() or any(train_launches.values()):
            bad.append(f"train: stages {stages}, losses {losses}, launches {train_launches}")
        seeded = AlternatingTrainer(cfg, compute_dtype=torch.bfloat16, device=dev)
        shrink = float(np.prod([1 - run.seg_schedule(t) * run.weight_decay for t in range(4)]))
        got, init = run.seg_model.state_dict(), seeded.seg_model.state_dict()
        proto_rel = {k: rel(got[k].double(), init[k].double() * shrink)
                     for k in got if "prototype" in k}
        if max(proto_rel.values()) > PROTO_GATE:
            bad.append(f"prototypes not frozen: {proto_rel}")
        moved = not torch.equal(got["backbone.conv1.weight"], init["backbone.conv1.weight"])
        if not moved:
            bad.append("the backbone did not move")
        timings = run.timings
        ims, lbs = flagship_batch(np.random.default_rng(23), dev, cats,
                                  tuple(cfg.get("train", "cropsize")),
                                  int(cfg.dataset_cfg(0)["ims_per_gpu"]))
        seg_ms, seg_peak = alone_ms(lambda: run.seg_step(ims, lbs))
        del run, seeded, got, init, ims, lbs
        torch.cuda.empty_cache()
        rec, fail, eval_launches = eval_pair(
            CLIP_CONFIG, os.path.join(work, "ckpt_gnn"), "clip", 2, {"stem_impl": "kernel"},
            {"stem7_conv_bn_relu_s2": STEM7_LEVELS}, 1,
            overrides=synthetic_readers(cats, 2, eval_batch=True) + features, datasets=len(cats),
            argmax_gate=None, f32_gate=True)
        bad += [f"eval clip: {f}" for f in fail]
    loop_ms = [r["step_ms"] for r in timings]
    images = sum(int(cfg.dataset_cfg(i)["ims_per_gpu"]) for i in range(len(cats)))
    emit(phase="clip", config=os.path.relpath(CLIP_CONFIG, ROOT), dtype="bfloat16",
         cats=list(cats), images_a_step=images, crop=cfg.get("train", "cropsize"),
         stages=stages, losses=losses, step_ms=loop_ms,
         seg_step_in_loop_ms=float(np.median(loop_ms[1:])), seg_step_alone_ms=seg_ms,
         seg_step_ms=float(np.median(seg_ms)),
         seg_images_per_s=images / float(np.median(seg_ms)) * 1e3,
         train_max_memory_allocated=peak, seg_step_max_memory_allocated=seg_peak, weight_decay_shrink=shrink,
         prototype_rel=proto_rel, backbone_moved=moved, eval=rec,
         seconds=time.perf_counter() - t0)
    if bad:
        raise RuntimeError(f"clip: {bad}")
    return {"stem7_conv_bn_relu_s2": eval_launches["stem7_conv_bn_relu_s2"]}


def phase_train_stem(dev):
    """The train step with set_stem_impl("kernel") against the plain route
    from one set of weights and one batch; then stem_conv3x3_s2 at the inputs
    the steps gave it against its plain version and the library conv."""
    from mds_tpu_torch import MODELS
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.ops import stem

    cfg = Configer(config_file=CONFIG)
    n_classes = cfg.n_cats(0)
    b = int(cfg.dataset_cfg(0)["ims_per_gpu"])
    h, w = cfg.get("train", "cropsize")
    im, lb = seg_batch(np.random.default_rng(6), b, h, w, n_classes)
    ims, lbs = [torch.from_numpy(im).to(dev)], [torch.from_numpy(lb).to(dev)]
    init = MODELS[cfg.get("model_name")](n_classes=(n_classes,), n_bn=1, aux=True,
                                         dtype=torch.bfloat16)
    init.init_weights(torch.Generator().manual_seed(WEIGHT_SEED))

    def steps(stem_impl, n):
        model = copy.deepcopy(init).to(dev)
        step, _ = train_step_for(cfg, model, torch.bfloat16)
        with route(stem_impl), captured(stem, "stem_conv3x3_s2") as calls:
            reset_counts()
            out = []
            for i in range(n):
                out.append(step(ims, lbs, torch.Generator().manual_seed(i))["loss"].item())
                out.append(read_counts())
        return out, calls

    (plain_loss, plain_counts), _ = steps("plain", 1)
    torch.cuda.empty_cache()
    (loss1, counts1, loss2, launches), calls = steps("kernel", 2)
    torch.cuda.synchronize()
    want = {k: 0 for k in launches}
    want.update(dropout_u8=20, stem_conv3x3_s2=4)
    loss_rel = abs(loss1 - plain_loss) / abs(plain_loss)
    res = {"max_abs_err": 0.0, "ms": 0.0, "cold_ms": 0.0, "device_ms": 0.0,
           "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "library_bf16_ms": 0.0,
           "launches": launches["stem_conv3x3_s2"]}
    convs = []
    for x, k, packed in calls[:2]:  # the first step's two stems
        x, k = x.detach(), k.detach()
        got = stem.stem_conv3x3_s2(x, k, packed)
        want_y = stem.stem_conv3x3_s2_plain(x, k)
        lib_y = F.conv2d(x, k, stride=2, padding=1)
        g = torch.randn(got.shape, device=dev, generator=torch.Generator(dev).manual_seed(3)
                        ).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        grads = []
        for fn in (stem.stem_conv3x3_s2, lambda a, c: F.conv2d(a, c, stride=2, padding=1)):
            xg = x.clone().requires_grad_(True)
            kf = k.float().requires_grad_(True)  # as the model's f32 weight
            (fn(xg, kf.to(torch.bfloat16)) * g).sum().backward()
            grads.append((xg.grad, kf.grad))
        xf, kf = x.float(), k.float()
        rec = {"x": list(x.shape), "k": list(k.shape), "dtype": str(got.dtype),
               "rel": rel(got, want_y), "bit_equal": share_equal(bits(got), bits(want_y)),
               "rel_vs_library": rel(got, lib_y),
               "dx_rel": rel(grads[0][0], grads[1][0]),
               "dk_rel": rel(grads[0][1], grads[1][1]),
               "ms": cuda_ms(lambda: stem.stem_conv3x3_s2(x, k, packed)),
               "cold_ms": cuda_ms(lambda: stem.stem_conv3x3_s2(x, k)),
               "device_ms": device_ms(lambda: stem.stem_conv3x3_s2(x, k, packed),
                                      "stem_kernel"),
               "plain_ms": cuda_ms(lambda: stem.stem_conv3x3_s2_plain(x, k), n=5),
               # the same function (f32 out) in one call, TF32 off; and the
               # bf16 conv, the yardstick of the earlier bf16-output form
               "library_ms": cuda_ms(lambda: F.conv2d(xf, kf, stride=2, padding=1)),
               "library_bf16_ms": cuda_ms(lambda: F.conv2d(x, k, stride=2, padding=1))}
        rec["bound_ms"], res["bound_by"] = bound(nbytes(x, k, got), conv_flops(got, k))
        convs.append(rec)
        res["max_abs_err"] = max(res["max_abs_err"],
                                 (got.float() - want_y.float()).abs().max().item())
        for key in ("ms", "cold_ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                    "library_bf16_ms"):
            if isinstance(rec[key], float) and isinstance(res[key], float):
                res[key] += rec[key]
            else:
                res[key] = "not measured"
        if not (got.dtype == torch.float32 and torch.isfinite(got).all()
                and rec["rel"] <= F32_GATE and max(
                    rec["rel_vs_library"], rec["dx_rel"], rec["dk_rel"]) < KERNEL_GATE):
            raise RuntimeError(f"stem_conv3x3_s2: {rec}")
    emit(phase="train_stem", batch=[b, h, w], plain_loss=plain_loss,
         kernel_losses=[loss1, loss2], loss_rel=loss_rel,
         plain_launches=plain_counts, first_step_launches=counts1,
         launches=launches, convs=convs,
         library="f32 F.conv2d, TF32 off (library_bf16_ms: bf16 F.conv2d); "
                 "gradients against bf16 F.conv2d's autograd")
    if not np.isfinite([plain_loss, loss1, loss2]).all() or loss_rel >= 1e-2:
        raise RuntimeError(f"train_stem: losses {plain_loss} vs {loss1}, {loss2}")
    if launches != want or counts1["stem_conv3x3_s2"] != 2:
        raise RuntimeError(f"train_stem launches {launches}, expected {want}")
    return res


def profile_idle_share(fn, kernels_of_interest=()):
    """Device busy time and idle share of one call under torch.profiler, or
    "not measured" where the profiler sees no device time; beside the top
    ten, the summed device time and launches of each kernel named in
    `kernels_of_interest`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device activity, without the annotation ranges drawn over it
    kernels_ = [e for e in prof.events()
                if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.device_time_total for e in kernels_) / 1e3  # µs → ms
    if busy_ms <= 0:
        return {"profiled_wall_ms": wall_ms, "idle_share": "not measured"}
    by_name = {}
    for e in kernels_:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    named = {k: {"device_ms": sum(e.device_time_total for e in kernels_ if k in e.name) / 1e3,
                 "launches": sum(k in e.name for e in kernels_)}
             for k in kernels_of_interest}
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_launches": len(kernels_), "idle_share": 1 - busy_ms / wall_ms,
            "top_device_ms": [[n[:80], ms] for n, ms in top], "kernel_device_ms": named}


def step_record(model, opt, loss):
    """One train step's loss, gradients (each parameter's .grad), groups
    and parameters after it, on the CPU."""
    groups = {id(p): g["name"] for g in opt.param_groups for p in g["params"]}
    named = dict(model.named_parameters())
    return {"loss": loss, "grads": {k: p.grad.cpu().double() for k, p in named.items()},
            "group": {k: groups[id(p)] for k, p in named.items()},
            "params": {k: p.detach().cpu() for k, p in named.items()}}


def group_agreement(a, b, tensors="params"):
    """Two steps' records (the card's `a`, the CPU's `b`): the gradient
    cosine of each param group, and the worst group's max-diff of
    `tensors` over the group's largest magnitude. Per group: a
    zero-initialized bias whose gradient a train-mode BN cancels moves by
    rounding noise alone, so no tensor stands alone."""
    cos = {}
    for g in sorted(set(a["group"].values())):
        ks = [k for k in a["grads"] if a["group"][k] == g]
        va = torch.cat([a["grads"][k].flatten() for k in ks])
        vb = torch.cat([b["grads"][k].flatten() for k in ks])
        cos[g] = (va @ vb / (va.norm() * vb.norm())).item()
    by_group = {}
    for k in b[tensors]:
        by_group.setdefault(a["group"].get(k, k.rsplit(".", 1)[-1]), []).append(k)
    rels = {g: max((a[tensors][k] - b[tensors][k]).abs().max().item() for k in ks)
            / max(max(b[tensors][k].abs().max().item() for k in ks), 1e-30)
            for g, ks in by_group.items()}
    return cos, rels


def phase_parity(dev):
    """One f32 train step with dropout on, on the card and on the CPU, from
    the same weights and generator seed: the card's kernels and library ops
    against the CPU path that tests/test_torch_train.py holds to JAX."""
    from mds_tpu_torch import MODELS
    from mds_tpu_torch.config import Configer

    cfg = Configer(config_file=CONFIG)
    n_classes = cfg.n_cats(0)
    # batch 4: the CEBlock's BN over 2 images' global pools would make the
    # gradients rounding-chaotic (tests/test_torch_train.py)
    im, lb = seg_batch(np.random.default_rng(3), 4, 64, 128, n_classes)
    gain = np.random.default_rng(4).uniform(0.2, 1.0, (4, 1, 1, 1))
    im = (im * gain).astype(np.uint8)  # images of distinct global statistics
    cpu = MODELS[cfg.get("model_name")](n_classes=(n_classes,), n_bn=1, aux=True)
    cpu.init_weights(torch.Generator().manual_seed(WEIGHT_SEED))
    runs = {}
    for name, model, d in (("cuda", copy.deepcopy(cpu).to(dev), dev), ("cpu", cpu, "cpu")):
        step, opt = train_step_for(cfg, model, torch.float32)
        reset_counts()
        loss = step([torch.from_numpy(im).to(d)], [torch.from_numpy(lb).to(d)],
                    torch.Generator().manual_seed(5))["loss"].item()
        runs[name] = dict(step_record(model, opt, loss),
                          launches=read_counts()["dropout_u8"])
    a, b = runs["cuda"], runs["cpu"]
    loss_rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    cos, rels = group_agreement(a, b)
    param_rel = max(rels.values())
    pool = avg_pool_backward_check(dev)
    emit(phase="parity", loss_cuda=a["loss"], loss_cpu=b["loss"], loss_rel=loss_rel,
         grad_cosine=cos, param_rel=param_rel,
         dropout_launches={"cuda": a["launches"], "cpu": b["launches"]},
         avg_pool2d_channels_last_grad_rel_l2=pool)
    if pool["port"] > 1e-5:
        raise RuntimeError(f"parity: the port's avg pool gradient disagrees {pool}")
    if a["launches"] != 10 or b["launches"] != 0:
        raise RuntimeError("parity: the card's step did not run the dropout kernel")
    if loss_rel >= 1e-4 or min(cos.values()) <= 0.9999 or param_rel >= 1e-4:
        raise RuntimeError("parity: the card's train step disagrees with the CPU's")


def avg_pool_backward_check(dev):
    """PyTorch's avg_pool2d backward on a channels_last input, the card
    against the CPU (relative L2): layers.avg_pool_3x3_s2 pools an NCHW copy
    under autograd while the card's is wrong; when `raw` reads ~1e-7, the
    copy can go. `port` is the port's pool, which must agree."""
    from mds_tpu_torch.models.layers import avg_pool_3x3_s2

    x = torch.randn(4, 16, 32, 64, generator=torch.Generator().manual_seed(0))
    r = torch.randn(4, 16, 16, 32, generator=torch.Generator().manual_seed(1))
    out = {}
    for name, fn in (("raw", lambda t: F.avg_pool2d(t, 3, 2, 1, count_include_pad=True)),
                     ("port", avg_pool_3x3_s2)):
        grads = []
        for d in (dev, "cpu"):
            t = x.to(d).contiguous(memory_format=torch.channels_last).requires_grad_(True)
            (fn(t) * r.to(d)).sum().backward()
            grads.append(t.grad.cpu().double())
        out[name] = ((grads[0] - grads[1]).norm() / grads[1].norm()).item()
    return out


def randomize_bn(model, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=gen) + 0.5)


@contextlib.contextmanager
def route(stem_impl="plain", fuse=False, depthwise="plain", pred="plain",
          tail=False, conv3="plain", stem_variant="tiles"):
    """The layers' route switches set for the block; the plain path after."""
    from mds_tpu_torch.models.layers import (
        set_conv3_eval_impl,
        set_depthwise_impl,
        set_detail_fuse,
        set_detail_tail,
        set_pred_impl,
        set_stem_impl,
    )
    from mds_tpu_torch.ops.stem import set_stem_variant

    set_stem_impl(stem_impl)
    set_detail_fuse(fuse)
    set_depthwise_impl(depthwise)
    set_pred_impl(pred)
    set_detail_tail(tail)
    set_conv3_eval_impl(conv3)
    set_stem_variant(stem_variant)
    try:
        yield
    finally:
        set_stem_impl("plain")
        set_detail_fuse(False)
        set_depthwise_impl("plain")
        set_pred_impl("plain")
        set_detail_tail(False)
        set_conv3_eval_impl("plain")
        set_stem_variant("tiles")


# BiSeNetV2's served route: every deploy kernel on (tools/serve_torch.py)
ALL_ROUTES = {"stem_impl": "kernel", "fuse": True, "depthwise": "kernel",
              "pred": "fused", "tail": True}
NO_TAIL_ROUTES = {**ALL_ROUTES, "tail": False}  # every deploy route but the tail
STEM_FUSED_ROUTES = {"stem_impl": "kernel", "fuse": True}
# the segment.py route with the window stem and the conv3 kernel: the two
# RGB stems on kernel 2, DetailBranch S1_2 on kernel 8
STEM_DMA_CONV3_ROUTES = {"stem_impl": "kernel", "stem_variant": "dma",
                         "conv3": "kernel"}


def normalized(e2e, frame):
    """One uint8 (1, H, W, 3) frame as the model's bf16 NCHW input."""
    x = torch.from_numpy(frame).to(e2e.mean.device).float() / 255.0
    return ((x - e2e.mean) / e2e.std).to(torch.bfloat16).permute(0, 3, 1, 2)


def serve_and_check(e2e, name, frames, n_classes, **route_kw):
    """`frames` as requests to InferenceServer on 127.0.0.1 under the route,
    after one frame that warms up cuDNN's algorithm choice (not counted):
    the kernel launches of the requests, their latencies, the label maps
    checked for shape, range and more than one class (a constant map would
    agree with anything), and each map's agreement with the same model on
    the plain path (library ops, no kernels)."""
    from mds_tpu_torch.deploy.server import InferenceServer

    srv = InferenceServer(e2e, (H, W), name=name)
    httpd = srv.serve_background(0, "127.0.0.1")
    url = f"http://127.0.0.1:{httpd.server_address[1]}/v2/models/{name}/infer"
    try:
        with route(**route_kw):
            e2e.infer(frames[0])
            reset_counts()
            replies, latency_ms = [], []
            for fr in frames:
                t0 = time.perf_counter()
                with urllib.request.urlopen(
                        urllib.request.Request(url, data=fr.tobytes()), timeout=300) as r:
                    shape = json.loads(r.headers["X-Shape"])
                    replies.append(np.frombuffer(r.read(), np.int32).reshape(shape))
                latency_ms.append((time.perf_counter() - t0) * 1e3)
            launches = read_counts()
    finally:
        httpd.shutdown()
        httpd.server_close()
    classes = []
    for rep in replies:
        if rep.shape != (1, H, W) or rep.dtype != np.int32:
            raise RuntimeError(f"{name}: bad reply {rep.shape} {rep.dtype}")
        if rep.min() < 0 or rep.max() >= n_classes:
            raise RuntimeError(f"{name}: labels out of range [{rep.min()}, {rep.max()}]")
        classes.append(int(np.unique(rep).size))
    if min(classes) < 2:
        raise RuntimeError(f"{name}: degenerate label maps: {classes} classes")
    plain = [e2e.infer(fr) for fr in frames]
    return {"launches": launches, "latency_ms": latency_ms, "classes": classes,
            "replies": replies, "plain_labels": plain,
            "agree": [float((rep == ref).mean()) for rep, ref in zip(replies, plain)]}


def logits_rels(model, x, n_classes, routes):
    """The rel max-diff of the model's logits of `x` on each route against
    the plain path; every logits tensor checked for shape and finiteness."""
    with torch.inference_mode():
        ref = model.eval_logits(x)
        outs = []
        for kw in routes:
            with route(**kw):
                outs.append(model.eval_logits(x))
    for t in (ref, *outs):
        if t.shape != (1, n_classes, H, W) or not torch.isfinite(t.float()).all():
            raise RuntimeError(f"bad logits {t.shape}")
    return [rel(t, ref) for t in outs]


def e2e_ms(e2e, frame, **route_kw):
    """E2EModel time per frame alone (no HTTP) on the route: CUDA events,
    median of 10."""
    with route(**route_kw):
        return cuda_ms(lambda: e2e(torch.from_numpy(frame)), n=10)


def v2_model(dev):
    """BiSeNetV2 as configs/bisenetv2_city.json serves it (19 classes, bf16,
    no aux heads), seeded weights with random BN statistics, in an E2EModel
    on the card; and the phase's three 1024×2048 uint8 frames."""
    from mds_tpu_torch import MODELS
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.data.labels import get_spec
    from mds_tpu_torch.deploy.e2e import E2EModel

    cfg = Configer(config_file=CONFIG)
    spec = get_spec(cfg.dataset_cfg(0)["spec"])
    model = MODELS[cfg.get("model_name")](n_classes=(cfg.n_cats(0),), n_bn=1,
                                          aux=False, dtype=torch.bfloat16)
    model.init_weights(torch.Generator().manual_seed(WEIGHT_SEED))
    randomize_bn(model, WEIGHT_SEED + 1)
    frames = np.random.default_rng(2).integers(0, 256, (3, 1, H, W, 3)).astype(np.uint8)
    return E2EModel(model, spec.mean, spec.std, device=dev), frames


def fused_tail_reference(model, x):
    """The plain route's head logits (library ops, head resolution) through
    the fused tail's plain version, which rounds where the kernel does."""
    from mds_tpu_torch.models.layers import as_multi
    from mds_tpu_torch.ops.upsample_argmax import upsample_argmax_plain

    with torch.inference_mode():
        feat, _ = model.backbone(as_multi(x, 0, model.n_bn))
        head = model.head[0]
        logits = head(feat[0], up=False)
        return upsample_argmax_plain(logits, head.residual_factor).cpu().numpy()


def phase_slice(dev, e2e, frames):
    """BiSeNetV2 served with every deploy route on (stem kernel, detail
    fusion and tail, depthwise kernel, fused pred), then one frame on the
    stem-kernel route alone and one on it with the window stem and the conv3
    kernel, against the same model on the plain path."""
    model = e2e.model
    n_classes = model.n_classes[0]
    served = serve_and_check(e2e, "bisenetv2", frames, n_classes, **ALL_ROUTES)
    launches = dict(served["launches"])
    # the segment.py route: stem kernels, no detail/StemBlock fusion; then
    # the same with the window stem (kernel 2) and the conv3 kernel (8)
    stem_labels = {}
    for key, kw in (("stem", {"stem_impl": "kernel"}),
                    ("stem_dma_conv3", STEM_DMA_CONV3_ROUTES)):
        with route(**kw):
            reset_counts()
            stem_labels[key] = e2e.infer(frames[0])
            got = read_counts()
        launches = {k: launches[k] + n for k, n in got.items()}
    want = {k: 0 for k in launches}
    want.update(detail_s1s2_fused=3, stemblock_fused=3, detail_tail_fused=3,
                stem_conv_bn_relu_s2=2, stem_conv_bn_relu_s2_window=2,
                conv3x3_bn_relu=1, depthwise3x3=16 * len(frames),
                upsample_argmax=len(frames))
    if launches != want:
        raise RuntimeError(f"kernel launches {launches}, expected {want}")
    # the fused tail rounds the vertical pass to bf16 by design, as JAX's
    # does: the served labels are held to the plain route's head logits put
    # through the tail's plain version, and their agreement with the plain
    # route's F.interpolate + argmax labels is reported without a gate
    agree = [float((rep == fused_tail_reference(model, normalized(e2e, fr))).mean())
             for rep, fr in zip(served["replies"], frames)]
    agree_interp = served["agree"]
    agree_stem = {k: float((v == served["plain_labels"][0]).mean())
                  for k, v in stem_labels.items()}
    rel_all, rel_dw, rel_stem, rel_dma = logits_rels(
        model, normalized(e2e, frames[0]), n_classes,
        ({**ALL_ROUTES, "pred": "plain"}, {"depthwise": "kernel"},
         {"stem_impl": "kernel"}, STEM_DMA_CONV3_ROUTES))
    # in turns: all routes, all but the tail, stem fusion, the stem route,
    # the stem route with the window stem and conv3, plain; then backwards
    order = (("all", ALL_ROUTES), ("no_tail", NO_TAIL_ROUTES),
             ("stem_fused", STEM_FUSED_ROUTES), ("stem", {"stem_impl": "kernel"}),
             ("stem_dma_conv3", STEM_DMA_CONV3_ROUTES), ("plain", {}))
    e2e_times = {k: [] for k, _ in order}
    for k, kw in order + order[::-1]:
        e2e_times[k].append(e2e_ms(e2e, frames[1], **kw))
    # stem_kernel: kernel 1, or kernel 2 on the window-stem route
    of_interest = ("dw3x3_kernel", "upsample_argmax_kernel", "stem_kernel",
                   "detail_head_kernel", "stemblock_kernel", "detail_tail_kernel",
                   "conv3x3_kernel")
    profiles = {}
    for k, kw in order:
        with route(**kw):
            profiles[k] = profile_idle_share(
                lambda: e2e(torch.from_numpy(frames[1])), of_interest)
    emit(phase="slice", requests=len(frames), latency_ms=served["latency_ms"],
         classes_per_reply=served["classes"],
         argmax_agreement=agree, argmax_agreement_interpolate=agree_interp,
         logits_rel=rel_all, depthwise_route_logits_rel=rel_dw,
         stem_route_agreement=agree_stem, stem_route_logits_rel=rel_stem,
         stem_dma_conv3_route_logits_rel=rel_dma,
         e2e_ms=e2e_times, launches=launches, profile=profiles)
    if min(agree + list(agree_stem.values())) <= ARGMAX_GATE:
        raise RuntimeError(f"argmax agreement {agree} / {agree_stem}")
    if max(rel_all, rel_dw, rel_stem, rel_dma) >= LOGITS_GATE:
        raise RuntimeError(f"logits rel {rel_all} / {rel_dw} / {rel_stem} / {rel_dma}")
    return launches


def phase_v1_slice(dev):
    """BiSeNetV1 served as tools/serve_torch.py serves it, the 7×7 stems on
    their kernel, against the same model on the plain path."""
    from mds_tpu_torch.config import Configer

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from serve_torch import build_e2e

    cfg = Configer(config_file=V1_CONFIG)
    name, n_classes = cfg.get("model_name"), cfg.n_cats(0)
    e2e = build_e2e(V1_CONFIG, seed=V1_WEIGHT_SEED, device=dev)
    randomize_bn(e2e.model, V1_WEIGHT_SEED + 1)
    frames = np.random.default_rng(4).integers(0, 256, (3, 1, H, W, 3)).astype(np.uint8)

    served = serve_and_check(e2e, name, frames, n_classes, stem_impl="kernel")
    launches = served["launches"]
    want = {k: 0 for k in launches}
    want["stem7_conv_bn_relu_s2"] = 2 * len(frames)
    if launches != want:
        raise RuntimeError(f"v1 kernel launches {launches}, expected {want}")
    agree = served["agree"]
    (logits_rel,) = logits_rels(e2e.model, normalized(e2e, frames[0]), n_classes,
                                ({"stem_impl": "kernel"},))
    # in turns: kernel, plain, plain, kernel
    kernel_ms, plain_ms = e2e_ms(e2e, frames[1], stem_impl="kernel"), e2e_ms(e2e, frames[1])
    plain_ms2, kernel_ms2 = e2e_ms(e2e, frames[1]), e2e_ms(e2e, frames[1], stem_impl="kernel")
    profiles = {}
    for impl in ("kernel", "plain"):
        with route(impl):
            profiles[impl] = profile_idle_share(
                lambda: e2e(torch.from_numpy(frames[1])), ("stem7_kernel",))
    emit(phase="v1_slice", config=os.path.relpath(V1_CONFIG, ROOT),
         requests=len(frames), latency_ms=served["latency_ms"],
         classes_per_reply=served["classes"],
         argmax_agreement=agree, logits_rel=logits_rel,
         e2e_kernel_ms=[kernel_ms, kernel_ms2], e2e_plain_ms=[plain_ms, plain_ms2],
         launches=launches, profile=profiles)
    if min(agree) <= ARGMAX_GATE:
        raise RuntimeError(f"v1 argmax agreement {agree}")
    if logits_rel >= LOGITS_GATE:
        raise RuntimeError(f"v1 logits rel {logits_rel}")
    return launches


CONTRAST_CONFIG = os.path.join(ROOT, "configs", "bisenetv2_contrast_3ds.json")
CONTRAST_CATS = (19, 11, 36)  # Cityscapes, CamVid, A2D2 (46 unified classes)


CONTRAST_OVERRIDES = synthetic_readers(CONTRAST_CATS, 8) + [
    "lr.max_iter", "6", "train.ckpt_interval", "3", "train.log_interval", "1"]


def contrast_valid_share(lbs_by_dataset):
    """Each dataset's share of labelled pixels that the single-mapping LUT
    keeps (a class mapped to several unified ids becomes ignore) and the
    share of all pixels it keeps; `lbs_by_dataset` holds uint8 label maps."""
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.data.class_remap import ClassRemap

    remap = ClassRemap(Configer(config_file=CONTRAST_CONFIG))
    out = []
    for i, lbs in enumerate(lbs_by_dataset):
        lut = remap.single_lut(i).numpy()
        kept = sum(int((lut[lb] != remap.ignore_index).sum()) for lb in lbs)
        labelled = sum(int((lb != remap.ignore_index).sum()) for lb in lbs)
        out.append({"of_labelled": kept / labelled,
                    "of_pixels": kept / sum(lb.size for lb in lbs)})
    return out


def synthetic_valid_share(length):
    """contrast_valid_share over the `length` raw frames of each dataset's
    Synthetic reader as CONTRAST_OVERRIDES sets it (before crop and scale)."""
    from mds_tpu_torch.data.base import SyntheticDataset

    return contrast_valid_share(
        [[SyntheticDataset(n_cats=n, size=(H, W), length=length, seed=i).read(k)["lb"]
          for k in range(length)] for i, n in enumerate(CONTRAST_CATS, 1)])


def contrast_state(t):
    """A ContrastTrainer's whole state on the CPU: student, SGD state,
    teacher, bank, step."""
    from mds_tpu_torch.engine.optim import optimizer_state

    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}  # noqa: E731
    return {"model": cpu(t.model.state_dict()), "teacher": cpu(t.teacher.state_dict()),
            "optimizer": optimizer_state(t.model, t.optimizer),
            "bank": [x.cpu() for x in (t.bank.feats, t.bank.ptr, t.bank.count)],
            "step": t.step_count}


# the card-against-CPU step's teacher momentum: at the config's 0.999 the
# teacher after one step is init plus 1e-3 of the student's move, and a wrong
# or skipped EMA would hide under the gate
CARD_VS_CPU_EMA = 0.9
# the EMA residual's gate: about 8 f32 roundings of the teacher, which the
# EMA as written stays within; tests/test_torch_contrast_ema_gate.py holds
# that a skipped EMA, one without the parameters and one a tenth off in
# momentum land above it
EMA_RESIDUAL_GATE = 1e-6


def contrast_parity_batch():
    """4 crops of 64×128 a dataset, each image of its own brightness and
    contrast."""
    rng = np.random.default_rng(12)
    batch = {"ims": [], "lbs": []}
    for n in CONTRAST_CATS:
        im, lb = seg_batch(rng, 4, 64, 128, n)
        gain = np.asarray([0.3, 0.55, 0.8, 1.0]).reshape(4, 1, 1, 1)
        batch["ims"].append((im * gain + (1 - gain) * 96).astype(np.uint8))
        batch["lbs"].append(lb)
    return batch


def contrast_step_record(dev, batch, work, extra=()):
    """One f32 contrast step from the config's seeded init (and the
    overrides `extra`) on `dev` at teacher momentum CARD_VS_CPU_EMA:
    step_record's loss, gradients, groups and parameters, the contrast
    loss, dropout launches, the bank, the prototypes (P > 1), and the
    teacher's float state after the step and its change in the step (f64)."""
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.engine.contrast_trainer import ContrastTrainer

    cfg = Configer(config_file=CONTRAST_CONFIG,
                   args_parser=["contrast.ema_momentum", str(CARD_VS_CPU_EMA), *extra])
    t = ContrastTrainer(cfg, work_dir=work, compute_dtype=torch.float32, device=dev)

    def teacher():
        return {k: v.detach().cpu().clone() for k, v in t.teacher.state_dict().items()
                if v.is_floating_point()}

    before = teacher()
    reset_counts()
    m = t.step(batch, generator=torch.Generator().manual_seed(5))
    after = teacher()
    if t.P > 1:
        # past the warmup seg_mul_loss takes over from the aux heads' OHEM,
        # so their parameters leave the backward: their gradient is zero
        for k, p in t.model.named_parameters():
            if p.grad is None and k.split(".")[0] in CONTRAST_AUX_HEADS:
                p.grad = torch.zeros_like(p)
    rec = dict(step_record(t.model, t.optimizer, m["loss"].item()),
               contrast_loss=m["contrast_loss"].item(),
               launches=read_counts()["dropout_u8"], bank=t.bank.feats.cpu(), teacher=after,
               prototypes=None if t.prototypes is None else t.prototypes.cpu())
    # the EMA on this device against its formula over this device's own
    # states, in f64: a few f32 roundings of the teacher where it ran as
    # written, a tenth of the student's move in the step where it did not
    student = t.model.state_dict()
    by_group = {}
    for k, v in after.items():
        want = (CARD_VS_CPU_EMA * before[k].double()
                + (1 - CARD_VS_CPU_EMA) * student[k].detach().cpu().double())
        g = rec["group"].get(k, k.rsplit(".", 1)[-1])
        err, mag = by_group.get(g, (0.0, 0.0))
        by_group[g] = (max(err, (v.double() - want).abs().max().item()),
                       max(mag, v.abs().max().item()))
    rec["ema_residual"] = {g: err / max(mag, 1e-30) for g, (err, mag) in by_group.items()}
    return rec


def contrast_card_vs_cpu(dev):
    """One f32 contrast step (configs/bisenetv2_contrast_3ds.json at full
    width: 46 classes, proj 256, bank 46 × 64 × 256, teacher on at momentum
    CARD_VS_CPU_EMA) at 4 crops of 64×128 a dataset, TF32 off, dropout on,
    on the card and on the CPU from the same seeded init, generator seed and
    anchor noise (drawn on the CPU from that seed): loss rel, per-group
    gradient cosine, parameters, teacher and bank rel, and each side's EMA
    residual (EMA_RESIDUAL_GATE). Teacher tensors go by the student's
    groups, the running means and variances as two more groups (the running
    mean of a 1×1 conv over BN-centred inputs is rounding noise alone).
    The teacher's change in one step is too close to the f32 rounding of
    its stored values to be compared across devices at 1e-4: the residual,
    on each side's own states, is what resolves the EMA."""
    batch = contrast_parity_batch()
    with tempfile.TemporaryDirectory() as work:
        a, b = (contrast_step_record(d, batch, work) for d in (dev, "cpu"))
    cos, rels = group_agreement(a, b)
    _, teacher_rel = group_agreement(a, b, "teacher")
    worst_teacher = max(teacher_rel, key=teacher_rel.get)
    return {"loss_cuda": a["loss"], "loss_cpu": b["loss"],
            "loss_rel": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
            "contrast_loss_rel": abs(a["contrast_loss"] - b["contrast_loss"])
            / abs(b["contrast_loss"]),
            "grad_cosine": cos, "param_rel": max(rels.values()),
            "ema_momentum": CARD_VS_CPU_EMA,
            "teacher_rel": teacher_rel[worst_teacher], "teacher_worst": worst_teacher,
            "ema_residual": {"cuda": a["ema_residual"], "cpu": b["ema_residual"]},
            "bank_rel": rel(a["bank"], b["bank"]),
            "dropout_launches": {"cuda": a["launches"], "cpu": b["launches"]}}


def contrast_fixed_batch(trainer, dev):
    """The contrast step on one fixed batch of the config's crops (no loader
    beside it: the bench's `contrast_train` cell): 5 timed steps after 2
    warm ones (CUDA events; the trainer's split into the step to the
    optimizer, the teacher and the pushes), then one under torch.profiler
    (idle share, launches, the dropout kernel's device time)."""
    rng = np.random.default_rng(15)
    h, w = trainer.configer.get("train", "cropsize")
    batch = {"ims": [], "lbs": []}
    for i, n in enumerate(CONTRAST_CATS):
        b = int(trainer.configer.dataset_cfg(i)["ims_per_gpu"])
        im, lb = seg_batch(rng, b, h, w, n)
        batch["ims"].append(torch.from_numpy(im).to(dev))
        batch["lbs"].append(torch.from_numpy(lb).to(dev))
    for _ in range(2):
        trainer.step(batch)
    trainer.timings.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        trainer.step(batch)
    recs = trainer.read_timings()
    out = {k: [r[k] for r in recs] for k in ("step_ms", "teacher_ms", "push_ms")}
    out["median_step_ms"] = float(np.median(out["step_ms"]))
    out["images_per_s"] = sum(x.shape[0] for x in batch["ims"]) / out["median_step_ms"] * 1e3
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["profile"] = profile_idle_share(lambda: trainer.step(batch), ("dropout_bf16_kernel",))
    out["valid_label_share"] = contrast_valid_share([[lb.cpu().numpy()] for lb in batch["lbs"]])
    return out


def phase_contrast(dev):
    """The contrast trainer (configs/bisenetv2_contrast_3ds.json at full
    width, bf16) through tools/train_torch.py's main: 6 steps, checkpoints
    at 3 and 6, a fresh trainer restoring step 6 exactly, --max-iter 8
    resuming to 8; 30 dropout launches a step (15 forward, 15 backward) and
    no other kernel's; the f32 step on the card against the CPU's;
    tools/evaluate_torch.py on the checkpoint in contrast and emb, routed
    (kernels 4, 5, 7, 9) and plain."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_torch

    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.engine.contrast_trainer import ContrastTrainer
    from mds_tpu_torch.utils.metrics_writer import read_metrics

    t0 = time.perf_counter()
    bad, launches = [], {}
    with tempfile.TemporaryDirectory() as work:
        args = ["--config", CONTRAST_CONFIG, "--work-dir", work] + CONTRAST_OVERRIDES
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t1 = time.perf_counter()
        run = train_torch.main(args)
        wall_s = time.perf_counter() - t1
        train_launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        saved = run.ckpt.all_steps()
        fresh = ContrastTrainer(Configer(config_file=CONTRAST_CONFIG,
                                         args_parser=CONTRAST_OVERRIDES),
                                work_dir=work, device=dev)
        fresh.restore()
        restored = same_state(contrast_state(fresh), contrast_state(run))
        bank_filled = int(run.bank.count.sum())
        del fresh
        reset_counts()
        resumed = train_torch.main(args + ["--max-iter", "8"])
        resume_launches = read_counts()
        resumed_saved, resumed_step = resumed.ckpt.all_steps(), resumed.step_count
        fixed = contrast_fixed_batch(resumed, dev)
        timings, cfg = run.timings, run.configer
        del run, resumed
        torch.cuda.empty_cache()
        want = {k: 0 for k in train_launches}
        # 5 heads × 3 datasets forward, as many backward
        want["dropout_u8"] = 30 * 6
        if train_launches != want or resume_launches != dict(want, dropout_u8=30 * 2):
            bad.append(f"train launches {train_launches}, resumed {resume_launches}")
        if saved != [3, 6] or resumed_saved != [3, 6, 8] or resumed_step != 8:
            bad.append(f"checkpoints {saved}, {resumed_saved}, resumed to {resumed_step}")
        if not restored:
            bad.append("a fresh trainer did not restore step 6 exactly")
        losses = [r["loss"] for r in read_metrics(os.path.join(work, "runs"))]
        # ---- evaluation: tools/evaluate_torch.py on the checkpoint
        modes = []
        eval_launches = {}
        ckpt = os.path.join(work, "ckpt_contrast")
        for mode in ("contrast", "emb"):
            rec, fail, got = eval_pair(
                CONTRAST_CONFIG, ckpt, mode, 2, EVAL_ROUTES, EVAL_PER_FORWARD, 1,
                overrides=synthetic_readers(CONTRAST_CATS, 2, eval_batch=True), datasets=3, argmax_gate=None)
            modes.append(rec)
            bad += [f"eval {mode}: {f}" for f in fail]
            for k, n in got.items():
                eval_launches[k] = eval_launches.get(k, 0) + n
    steps = [r["step_ms"] for r in timings]
    b = sum(int(cfg.dataset_cfg(i)["ims_per_gpu"]) for i in range(cfg.n_datasets))
    step_ms = float(np.median(steps[1:]))
    parity = contrast_card_vs_cpu(dev)
    if (parity["loss_rel"] >= F32_GATE or min(parity["grad_cosine"].values()) <= 0.9999
            or max(parity["param_rel"], parity["teacher_rel"], parity["bank_rel"]) >= F32_GATE):
        bad.append(f"card vs CPU: {parity}")
    if max(max(r.values()) for r in parity["ema_residual"].values()) >= EMA_RESIDUAL_GATE:
        bad.append(f"card vs CPU: the teacher's EMA {parity['ema_residual']}")
    if parity["dropout_launches"] != {"cuda": 30, "cpu": 0}:
        bad.append(f"card vs CPU: dropout launches {parity['dropout_launches']}")
    for k, n in train_launches.items():
        launches[k] = n + resume_launches[k] + eval_launches.get(k, 0)
    emit(phase="contrast", config=os.path.relpath(CONTRAST_CONFIG, ROOT), dtype="bfloat16",
         batch=b, crop=cfg.get("train", "cropsize"),
         losses=losses, valid_label_share=synthetic_valid_share(8),
         step_ms=steps, median_step_ms=step_ms,
         images_per_s=b / step_ms * 1e3,
         teacher_ms=[r["teacher_ms"] for r in timings],
         median_teacher_ms=float(np.median([r["teacher_ms"] for r in timings[1:]])),
         push_ms=[r["push_ms"] for r in timings],
         median_push_ms=float(np.median([r["push_ms"] for r in timings[1:]])),
         loader_wait_ms=[r["loader_ms"] for r in timings], run_wall_s=wall_s,
         max_memory_allocated=peak, checkpoints=saved, restored=restored,
         bank_entries=bank_filled, resumed_checkpoints=resumed_saved,
         train_launches=train_launches, launches_per_step=sum(train_launches.values()) / 6,
         dropout_launches_per_step=train_launches["dropout_u8"] / 6,
         resume_launches=resume_launches, fixed_batch=fixed, card_vs_cpu=parity, eval=modes,
         launches=launches, seconds=time.perf_counter() - t0)
    if bad:
        raise RuntimeError(f"contrast: {bad}")
    return launches


def v1_card_vs_cpu(dev):
    """One f32 BiSeNetV1 train step (aux heads, the config's SGD) at (4, 64,
    128), each image of its own brightness and contrast, TF32 off, on the
    card and on the CPU from the same seeded init: loss rel, per-group
    gradient cosine, parameters rel; then precise BN over 2 such batches of
    128×256, the card's recomputed stats against the CPU's."""
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.engine.precise_bn import update_bn_stats

    cfg = Configer(config_file=V1_CONFIG)
    rng = np.random.default_rng(13)
    gain = np.asarray([0.3, 0.55, 0.8, 1.0]).reshape(4, 1, 1, 1)
    im, lb = seg_batch(rng, 4, 64, 128, 19)
    im = (im * gain + (1 - gain) * 96).astype(np.uint8)
    runs = {}
    for d in ("cpu", dev):
        model = v1_init(torch.float32).to(d)
        step, opt = train_step_for(cfg, model, torch.float32)
        loss = step([torch.from_numpy(im).to(d)], [torch.from_numpy(lb).to(d)])["loss"].item()
        runs[d] = step_record(model, opt, loss)
    a, b = runs[dev], runs["cpu"]
    cos, rels = group_agreement(a, b)
    param_rel = max(rels.values())
    if set(a["group"].values()) != {"wd", "nowd"}:
        raise RuntimeError(f"v1 groups {set(a['group'].values())}: V1 has no head group")
    # precise BN, card against CPU
    batches = []
    for _ in range(2):
        x, _ = seg_batch(rng, 4, 128, 256, 19)
        x = (x * gain + (1 - gain) * 96) / 255.0
        batches.append(torch.from_numpy(((x - 0.5) / 0.25).astype(np.float32)))
    stats = {}
    for d in ("cpu", dev):
        model = v1_init(torch.float32).to(d)
        before = {k: v.double().cpu() for k, v in model.state_dict().items() if "running" in k}
        update_bn_stats(model, [x.to(d).permute(0, 3, 1, 2) for x in batches],
                        lambda m, x: m([x]))
        stats[d] = {k: v.double().cpu() for k, v in model.state_dict().items() if "running" in k}
    pbn = {k: ((stats[dev][k] - v).abs().max() / max(v.abs().max(), before[k].abs().max())).item()
           for k, v in stats["cpu"].items()}
    worst = max(pbn, key=pbn.get)
    return {"loss_cuda": a["loss"], "loss_cpu": b["loss"],
            "loss_rel": abs(a["loss"] - b["loss"]) / abs(b["loss"]), "grad_cosine": cos,
            "param_rel": param_rel,
            "precise_bn": {"tensors": len(pbn), "max_rel": pbn[worst], "worst": worst}}


def v1_init(dtype=torch.bfloat16):
    """BiSeNetV1 of the config (19 classes, aux heads) computing in `dtype`
    at its seeded init with random BN stats."""
    from mds_tpu_torch import MODELS

    model = MODELS["bisenetv1"](n_classes=(19,), n_bn=1, aux=True, dtype=dtype)
    model.init_weights(torch.Generator().manual_seed(V1_WEIGHT_SEED))
    randomize_bn(model, V1_WEIGHT_SEED + 1)
    return model


def phase_v1_train(dev):
    """BiSeNetV1's train step (configs/bisenetv1_city.json: bs16 512×1024,
    bf16, aux heads, SGD) on a fixed batch, plain and with fused_up_loss in
    turns (plain, fused, fused, plain; 5 timed steps each after a warm
    one); the f32 step and precise BN on the card against the CPU."""
    from mds_tpu_torch.config import Configer

    cfg = Configer(config_file=V1_CONFIG)
    b = int(cfg.dataset_cfg(0)["ims_per_gpu"])
    h, w = cfg.get("train", "cropsize")
    init = v1_init()
    im, lb = seg_batch(np.random.default_rng(14), b, h, w, 19)
    ims, lbs = [torch.from_numpy(im).to(dev)], [torch.from_numpy(lb).to(dev)]
    routes = {}
    first = {}
    for name, fused in (("plain", False), ("fused", True)):
        model = copy.deepcopy(init).to(dev)
        step, opt = train_step_for(cfg, model, torch.bfloat16, fused_up_loss=fused)
        first[name] = step(ims, lbs)["loss"].item()  # warm: cuDNN's first calls
        routes[name] = (model, step, opt)
    turns, bad = [], []
    for name in ("plain", "fused", "fused", "plain"):
        model, step, opt = routes[name]
        p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        times, losses = [], []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append(step(ims, lbs)["loss"])
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        launches = read_counts()
        moved = sum(not torch.equal(p0[k], v) for k, v in model.named_parameters())
        losses = [x.item() for x in losses]
        ms = float(np.median(times))
        turns.append({"route": name, "step_ms": times, "median_step_ms": ms,
                      "images_per_s": b / ms * 1e3, "losses": losses,
                      "max_memory_allocated": torch.cuda.max_memory_allocated(),
                      "launches": launches, "params_moved": f"{moved}/{len(p0)}"})
        if not np.isfinite(losses).all() or moved < 0.9 * len(p0) or any(launches.values()):
            bad.append(f"{name}: losses {losses}, moved {moved}/{len(p0)}, launches {launches}")
    profiles = {name: profile_idle_share(lambda: step(ims, lbs))
                for name, (_, step, _) in routes.items()}
    del routes
    torch.cuda.empty_cache()
    loss_rel = abs(first["fused"] - first["plain"]) / abs(first["plain"])
    if loss_rel >= 1e-2:
        bad.append(f"fused_up_loss first loss {first['fused']} vs plain {first['plain']}")
    parity = v1_card_vs_cpu(dev)
    if (parity["loss_rel"] >= F32_GATE or min(parity["grad_cosine"].values()) <= 0.9999
            or parity["param_rel"] >= F32_GATE or parity["precise_bn"]["max_rel"] >= F32_GATE):
        bad.append(f"card vs CPU: {parity}")
    emit(phase="v1_train", config=os.path.relpath(V1_CONFIG, ROOT), batch=[b, h, w],
         dtype="bfloat16", first_loss=first, fused_first_loss_rel=loss_rel, turns=turns,
         profile=profiles, card_vs_cpu=parity)
    if bad:
        raise RuntimeError(f"v1_train: {bad}")


# ------------------------------------------------ the two trainers completed
# snp_rn18_mulbn: the flagship config with a BN set for each dataset
MULBN_OVERRIDES = synthetic_readers(FLAGSHIP_CATS, 4) + [
    "train.gnn_iters", "1", "train.seg_iters", "2", "lr.max_iter", "2",
    "train.ckpt_interval", "2", "train.log_interval", "1", "train.eval_at_switch", "False"]
MULBN_STEPS = ["GNN", "SEG"]
AUDIT_FRAMES = 2  # Synthetic frames a dataset in each audit pass
MULTIPROTO_P = 4
CONTRAST_AUX_HEADS = ("aux2", "aux3", "aux4", "aux5_4")
# 2 OHEM steps, then seg_mul_loss takes over for the last 4
MULTIPROTO_OVERRIDES = synthetic_readers(CONTRAST_CATS, 8) + [
    "contrast.num_prototype", str(MULTIPROTO_P), "lr.warmup_iters", "2", "lr.max_iter", "6",
    "train.ckpt_interval", "6", "train.log_interval", "1"]
MULTIPROTO_STEPS = 6
MULTIPROTO_WARMUP = 2
# dropout launches a step: 5 heads × 3 datasets forward and as many
# backward while the OHEM seg loss holds; once seg_mul_loss takes over, the
# aux heads' losses leave the backward and only the main head's 3 run back
DROPOUT_WARM, DROPOUT_MUL = 30, 18


def mulbn_config(work):
    """configs/ltbgnn_3_datasets_snp.json with model_name snp_rn18_mulbn,
    written into `work` (the serving and eval tools take a config file)."""
    with open(FLAGSHIP_CONFIG) as f:
        cfg = json.load(f)
    cfg["model_name"] = "snp_rn18_mulbn"
    path = os.path.join(work, "ltbgnn_3_datasets_snp_mulbn.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def mulbn_seg_record(dev, batch):
    """One f32 SEG step of snp_rn18_mulbn at TEST_WIDTH (its seeded init,
    TF32 off) on `dev`: step_record's loss, gradients, groups (a
    parameter's top module) and parameters after it, and the running
    stats, grouped by (set kind, level, dataset)."""
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.engine.gnn_trainer import AlternatingTrainer

    cfg = copy.deepcopy(TEST_WIDTH)
    cfg["model_name"] = "snp_rn18_mulbn"
    t = AlternatingTrainer(Configer(configs=cfg), device=dev)
    ims = [torch.from_numpy(x).to(dev) for x in batch["ims"]]
    lbs = [torch.from_numpy(x).to(dev) for x in batch["lbs"]]
    metrics = t.seg_step(ims, lbs)
    named = dict(t.seg_model.named_parameters())
    stats, groups = {}, {}
    for k, v in t.seg_model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            stats[k] = v.detach().cpu()
            # a level's set …bn{1,2}.{level}.{dataset}.running_*, else
            # a single set's …{dataset}.running_*
            m = re.search(r"\.bn[12]\.(\d+)\.(\d+)\.(running_\w+)$", k)
            g = (f"level{m[1]}.dataset{m[2]}.{m[3]}" if m else
                 re.sub(r"^.*\.(\d+)\.(running_\w+)$", r"set.dataset\1.\2", k))
            groups.setdefault(g, []).append(k)
    return {"loss": float(metrics["loss"].detach()),
            "grads": {k: p.grad.cpu().double() for k, p in named.items()},
            "group": {k: k.split(".")[0] for k in named},
            "params": {k: p.detach().cpu() for k, p in named.items()},
            "stats": stats, "stat_groups": groups}


def mulbn_card_vs_cpu(dev):
    """mulbn_seg_record on the card and on the CPU from the same init and
    batch (2 crops of 64×64 a dataset): loss rel, per-group gradient
    cosine, parameters rel, and every (level or set, dataset) group of
    running stats rel."""
    rng = np.random.default_rng(23)
    batch = {"ims": [], "lbs": []}
    for n in (3, 4):
        im, lb = seg_batch(rng, 2, 64, 64, n)
        batch["ims"].append(im)
        batch["lbs"].append(lb)
    with route(stem_impl="kernel"):  # f32: the plain stem on both devices
        a, b = (mulbn_seg_record(d, batch) for d in (dev, "cpu"))
    cos, rels = group_agreement(a, b)
    stat_rels = {g: max((a["stats"][k] - b["stats"][k]).abs().max().item() for k in ks)
                 / max(max(b["stats"][k].abs().max().item() for k in ks), 1e-30)
                 for g, ks in a["stat_groups"].items()}
    return {"loss_cuda": a["loss"], "loss_cpu": b["loss"],
            "loss_rel": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
            "grad_cosine": cos, "param_rel": max(rels.values()),
            "stats_groups": len(stat_rels), "stats_rel": max(stat_rels.values())}


def phase_mulbn(dev, work):
    """snp_rn18_mulbn (configs/ltbgnn_3_datasets_snp.json with model_name
    snp_rn18_mulbn: a BN set for each dataset) at full width in bf16, the
    config's 4 crops of 768×768 a dataset of Synthetic 1024×2048 frames,
    kernel 6 on, each dataset's input folding its own set: train_from_config
    with gnn=True takes a GNN step, the UOT switch and a SEG step (the
    checkpoint at 2, in `work` for the audit phase); one GNN step's frozen
    features routed against plain and its 9 kernel-6 calls against their
    plain version; the GNN and SEG steps alone (CUDA events) and their peak
    memory; a served frame (3 kernel-6 launches) and tools/evaluate_torch.py
    --mode uni on the checkpoint, routed against plain; one f32 SEG step at
    test width on the card against the CPU."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from serve_torch import build_e2e

    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.engine.trainer import step_generator
    from mds_tpu_torch.engine.train_step import normalize_images
    from mds_tpu_torch.ops import stem

    t0 = time.perf_counter()
    config = mulbn_config(work)
    cfg = Configer(config_file=config, args_parser=MULBN_OVERRIDES)
    a_step = STEM7_LEVELS * len(FLAGSHIP_CATS)
    bad, steps = [], []
    run, train_launches, train_peak = train_alternating_run(
        config, MULBN_OVERRIDES, work, dev, steps)
    timings = run.timings
    stages = [r["stage"] for r in timings]
    losses = [r["loss"] for r in timings]
    per_step = [r["stem7"] for r in steps]
    want = {k: 0 for k in train_launches}
    want["stem7_conv_bn_relu_s2"] = a_step * MULBN_STEPS.count("GNN")
    if not (run.mulbn and run.seg_model.mulbn and len(run.seg_model.logits.norm) == 3):
        bad.append("the trainer did not build snp_rn18_mulbn")
    if stages != MULBN_STEPS or not np.isfinite(losses).all():
        bad.append(f"train: stages {stages}, losses {losses}")
    if per_step != [a_step if s == "GNN" else 0 for s in MULBN_STEPS]:
        bad.append(f"train: kernel-6 launches a step {per_step}")
    if train_launches != want:
        bad.append(f"train launches {train_launches}, expected {want}")
    if not graphs_ok(run.uot_bi or [], FLAGSHIP_CATS, run.M):
        bad.append("UOT graphs: not one row a column and a column a row")
    saved = run.latest_step(os.path.join(work, "ckpt_gnn"))
    if saved != 2:
        bad.append(f"checkpoint at {saved}, expected 2")

    # the GNN step's frozen features: routed against plain, each kernel-6
    # call (dataset i's input with dataset i's fold) against its plain version
    ims, lbs = flagship_batch(np.random.default_rng(21), dev)
    xs = normalize_images(ims, run.means, run.stds, torch.bfloat16)
    run.seg_model.eval()
    with torch.no_grad():
        plain_feats = run.seg_model.features(xs)
        with route(stem_impl="kernel"), captured(stem, "stem7_conv_bn_relu_s2") as calls:
            routed_feats = run.seg_model.features(xs)
    feats_rel = [rel(a, b) for a, b in zip(routed_feats, plain_feats)]
    kernel_rels = stem7_calls_rels(calls)
    folds = sorted(k for k in run.seg_model.backbone._packs._entries if k.startswith("fold/"))
    del plain_feats, routed_feats, calls, xs
    if len(kernel_rels) != a_step or max(feats_rel) >= LOGITS_GATE:
        bad.append(f"features routed vs plain: rel {feats_rel}, {len(kernel_rels)} calls")
    if (max(k["rel"] for k in kernel_rels) >= KERNEL_GATE
            or min(k["bit_equal"] for k in kernel_rels) < BIT_EQUAL_GATE):
        bad.append(f"kernel-6 calls against their plain version: {kernel_rels}")
    if folds != [f"fold/{lv}/{d}" for lv in range(STEM7_LEVELS)
                 for d in range(len(FLAGSHIP_CATS))]:
        bad.append(f"kernel-6 folds cached as {folds}")
    with route(stem_impl="kernel"):
        gnn_ms, gnn_peak = alone_ms(lambda: run.gnn_step(
            ims, lbs, step_generator(run.seed, run.gnn_steps), max_rate=0.5))
    seg_ms, seg_peak = alone_ms(lambda: run.seg_step(ims, lbs))
    images = sum(x.shape[0] for x in ims)
    del ims, lbs

    # ---- serving: build_e2e on the checkpoint's seg weights, dataset 0
    weights = os.path.join(work, "snp_rn18_mulbn.pt")
    torch.save({k: v.cpu() for k, v in run.seg_model.state_dict().items()}, weights)
    del run
    torch.cuda.empty_cache()
    e2e = build_e2e(config, weights=weights, device=dev)
    frames = np.random.default_rng(22).integers(0, 256, (1, 1, H, W, 3)).astype(np.uint8)
    served = serve_and_check(e2e, "snp_rn18_mulbn", frames, FLAGSHIP_CATS[0],
                             stem_impl="kernel")
    want = {k: 0 for k in served["launches"]}
    want["stem7_conv_bn_relu_s2"] = STEM7_LEVELS * len(frames)
    if served["launches"] != want:
        bad.append(f"served launches {served['launches']}, expected {want}")
    x = normalized(e2e, frames[0])
    with torch.inference_mode():
        ref = e2e.model.eval_logits(x)
        with route(stem_impl="kernel"), captured(stem, "stem7_conv_bn_relu_s2") as calls:
            got = e2e.model.eval_logits(x)
    serve_logits_rel = rel(got, ref)
    serve_kernel_rels = stem7_calls_rels(calls)
    if (got.shape != (1, FLAGSHIP_CATS[0], H // 4, W // 4) or not torch.isfinite(got).all()
            or serve_logits_rel >= LOGITS_GATE or len(serve_kernel_rels) != STEM7_LEVELS
            or max(k["rel"] for k in serve_kernel_rels) >= KERNEL_GATE):
        bad.append(f"served logits {tuple(got.shape)} rel {serve_logits_rel}, "
                   f"kernel-6 calls {serve_kernel_rels}")
    del calls, got, ref, e2e

    # ---- evaluation: tools/evaluate_torch.py --mode uni on the checkpoint
    rec, fail, eval_launches = eval_pair(
        config, os.path.join(work, "ckpt_gnn"), "uni", 2, {"stem_impl": "kernel"},
        {"stem7_conv_bn_relu_s2": STEM7_LEVELS}, 1,
        overrides=synthetic_readers(FLAGSHIP_CATS, 2, eval_batch=True), datasets=3,
        argmax_gate=None)
    bad += [f"eval uni: {f}" for f in fail]

    parity = mulbn_card_vs_cpu(dev)
    if (parity["loss_rel"] >= F32_GATE or min(parity["grad_cosine"].values()) <= 0.9999
            or parity["param_rel"] >= F32_GATE or parity["stats_rel"] >= F32_GATE):
        bad.append(f"card vs CPU: {parity}")
    launches = {"stem7_conv_bn_relu_s2": train_launches["stem7_conv_bn_relu_s2"]
                + served["launches"]["stem7_conv_bn_relu_s2"]
                + eval_launches["stem7_conv_bn_relu_s2"]}
    emit(phase="mulbn", config=os.path.relpath(FLAGSHIP_CONFIG, ROOT),
         model_name="snp_rn18_mulbn", dtype="bfloat16", images_a_step=images,
         crop=cfg.get("train", "cropsize"), stages=stages, losses=losses,
         kernel6_launches_per_step=per_step, train_launches=train_launches,
         step_ms=[r["step_ms"] for r in timings],
         uot_switch_ms=[r["switch_ms"] for r in timings if "switch_ms" in r],
         train_max_memory_allocated=train_peak, features_rel=feats_rel,
         kernel6_calls=kernel_rels, kernel6_folds=folds,
         gnn_step_alone_ms=gnn_ms, gnn_step_ms=float(np.median(gnn_ms)),
         gnn_step_max_memory_allocated=gnn_peak,
         seg_step_alone_ms=seg_ms, seg_step_ms=float(np.median(seg_ms)),
         seg_images_per_s=images / float(np.median(seg_ms)) * 1e3,
         seg_step_max_memory_allocated=seg_peak,
         serve={"latency_ms": served["latency_ms"], "classes": served["classes"],
                "agreement": served["agree"], "logits_rel": serve_logits_rel,
                "kernel6_calls": serve_kernel_rels},
         eval=rec, card_vs_cpu=parity, launches=launches, seconds=time.perf_counter() - t0)
    if bad:
        raise RuntimeError(f"mulbn: {bad}")
    return launches


def phase_audit(dev, work):
    """The label-usage audit on the checkpoint phase_mulbn wrote:
    tools/find_unuse_torch.py (each dataset's used slots per class, the
    use/unuse targets into an .npz: each `target_bipart_i` (n_cats_i, M)
    with entries in {0, 1, 255}) over AUDIT_FRAMES Synthetic frames a
    dataset, its forwards on kernel 6 (3 launches each); then
    tools/print_bigraph_torch.py, the restored trainer's UOT graphs."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import find_unuse_torch
    import print_bigraph_torch

    t0 = time.perf_counter()
    bad = []
    config = mulbn_config(work)
    ckpt = os.path.join(work, "ckpt_gnn")
    out = os.path.join(work, "target_bipart.npz")
    overrides = synthetic_readers(FLAGSHIP_CATS, AUDIT_FRAMES, eval_batch=True)
    reset_counts()
    with route(stem_impl="kernel"), contextlib.redirect_stdout(io.StringIO()) as text:
        used, target_bipart, audit_s = find_unuse_torch.main(
            ["--config", config, "--ckpt", ckpt, "--out", out, *overrides])
    launches = read_counts()
    forwards = 2 * AUDIT_FRAMES * len(FLAGSHIP_CATS)  # two passes over each dataset
    want = {k: 0 for k in launches}
    want["stem7_conv_bn_relu_s2"] = STEM7_LEVELS * forwards
    if launches != want:
        bad.append(f"audit launches {launches}, expected {want}")
    saved = np.load(out)
    M = int(0.8 * sum(FLAGSHIP_CATS))
    shapes, values = [], set()
    for i, n in enumerate(FLAGSHIP_CATS):
        t = saved[f"target_bipart_{i}"]
        shapes.append(list(t.shape))
        values |= set(np.unique(t).tolist())
        if t.shape != (n, M) or not np.array_equal(t, target_bipart[i]):
            bad.append(f"target_bipart_{i}: {t.shape}")
    if not values <= {0.0, 1.0, 255.0}:
        bad.append(f"target_bipart values {sorted(values)}")
    if text.getvalue().count("used slots per class:") != len(FLAGSHIP_CATS):
        bad.append("the audit printed no used slots")
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        graphs = print_bigraph_torch.main(["--config", config, "--ckpt", ckpt, *overrides])
    if not graphs_ok(graphs, FLAGSHIP_CATS, M) or "== dataset 2 (36 classes" not in printed.getvalue():
        bad.append("print_bigraph: graphs not one row a column and a column a row")
    emit(phase="audit", config=os.path.relpath(FLAGSHIP_CONFIG, ROOT),
         model_name="snp_rn18_mulbn", frames_a_dataset=AUDIT_FRAMES,
         used_slots=[{str(k): v for k, v in sorted(u.items())} for u in used],
         target_bipart_shapes=shapes, target_bipart_values=sorted(values),
         target_bipart_counts=[{str(v): int((t == v).sum()) for v in (0.0, 1.0, 255.0)}
                               for t in target_bipart],
         audit_seconds=audit_s, launches=launches, seconds=time.perf_counter() - t0)
    if bad:
        raise RuntimeError(f"audit: {bad}")
    return {"stem7_conv_bn_relu_s2": launches["stem7_conv_bn_relu_s2"]}


@contextlib.contextmanager
def proto_timer(records):
    """Each prototype_learning call of the contrast trainer in the block:
    its ms (CUDA events)."""
    from mds_tpu_torch.engine import contrast_trainer

    real = contrast_trainer.prototype_learning

    def timed(*a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*a, **kw)
        end.record()
        records.append((start, end))
        return out

    contrast_trainer.prototype_learning = timed
    try:
        yield
    finally:
        contrast_trainer.prototype_learning = real


@contextlib.contextmanager
def contrast_metrics(records):
    """Each ContrastTrainer.step's metrics in the block, as floats."""
    from mds_tpu_torch.engine.contrast_trainer import ContrastTrainer

    real = ContrastTrainer.step

    def step(self, *a, **kw):
        out = real(self, *a, **kw)
        records.append({k: float(v) for k, v in out.items()})
        return out

    ContrastTrainer.step = step
    try:
        yield
    finally:
        ContrastTrainer.step = real


def multiproto_card_vs_cpu(dev):
    """contrast_step_record with P = MULTIPROTO_P and the warmup over (so
    seg_mul_loss and the multi-label contrast term both run): the card
    against the CPU from the same init, generator (dropout seeds, then the
    Gumbel noise, drawn on the CPU) and prototypes; the prototypes after
    the step rel."""
    batch = contrast_parity_batch()
    extra = ["contrast.num_prototype", str(MULTIPROTO_P), "lr.warmup_iters", "0"]
    with tempfile.TemporaryDirectory() as work:
        a, b = (contrast_step_record(d, batch, work, extra) for d in (dev, "cpu"))
    cos, rels = group_agreement(a, b)
    _, teacher_rel = group_agreement(a, b, "teacher")
    return {"loss_cuda": a["loss"], "loss_cpu": b["loss"],
            "loss_rel": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
            "contrast_loss_rel": abs(a["contrast_loss"] - b["contrast_loss"])
            / abs(b["contrast_loss"]),
            "grad_cosine": cos, "param_rel": max(rels.values()),
            "teacher_rel": max(teacher_rel.values()), "bank_rel": rel(a["bank"], b["bank"]),
            "prototypes_rel": rel(a["prototypes"], b["prototypes"]),
            "ema_residual": {"cuda": a["ema_residual"], "cpu": b["ema_residual"]},
            "dropout_launches": {"cuda": a["launches"], "cpu": b["launches"]}}


def phase_contrast_multiproto(dev):
    """The contrast trainer's multi-prototype path
    (configs/bisenetv2_contrast_3ds.json with contrast.num_prototype 4 and
    lr.warmup_iters 2: steps 0-1 OHEM, steps 2-5 seg_mul_loss) at full
    width in bf16, the config's 512×1024 crops, 1 + 1 + 2 a step, through
    tools/train_torch.py's main: 6 steps (30 dropout launches in each OHEM
    step, 18 once seg_mul_loss takes over), the step and
    prototype_learning ms, peak memory, a fresh trainer restoring step 6
    with its prototypes; every dropout call of one more step against its
    plain version bit for bit; the f32 step on the card against the CPU's;
    then tools/evaluate_torch.py --mode dsg and emb on the checkpoint,
    routed (kernels 4, 5, 7, 9) and plain."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import train_torch

    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.engine.contrast_trainer import ContrastTrainer
    from mds_tpu_torch.ops import dropout

    t0 = time.perf_counter()
    bad, launches, protos_ms, metrics = [], {}, [], []
    with tempfile.TemporaryDirectory() as work:
        args = ["--config", CONTRAST_CONFIG, "--work-dir", work] + MULTIPROTO_OVERRIDES
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with proto_timer(protos_ms), contrast_metrics(metrics):
            run = train_torch.main(args)
        train_launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        protos_ms = [s.elapsed_time(e) for s, e in protos_ms]
        timings = [dict(r) for r in run.read_timings()]
        fresh = ContrastTrainer(Configer(config_file=CONTRAST_CONFIG,
                                         args_parser=MULTIPROTO_OVERRIDES),
                                work_dir=work, device=dev)
        fresh.restore()
        restored = (torch.equal(fresh.prototypes, run.prototypes)
                    and same_state(contrast_state(fresh), contrast_state(run)))
        # the momentum mix of two unit rows: not renormalized, as JAX's
        proto_norm = torch.linalg.norm(run.prototypes.float(), dim=-1)
        del fresh
        # every dropout call of one more step: the kernel against its plain
        # version, bit for bit
        rng = np.random.default_rng(25)
        h, w = run.configer.get("train", "cropsize")
        batch = {"ims": [], "lbs": []}
        for i, n in enumerate(CONTRAST_CATS):
            im, lb = seg_batch(rng, int(run.configer.dataset_cfg(i)["ims_per_gpu"]), h, w, n)
            batch["ims"].append(torch.from_numpy(im).to(dev))
            batch["lbs"].append(torch.from_numpy(lb).to(dev))
        reset_counts()
        with captured(dropout, "dropout_u8", keep=lambda a: a) as calls:
            run.step(batch)
        n_drop = read_counts()["dropout_u8"]
        # the comparison's own launches are not counted
        drop_ok = [torch.equal(dropout.dropout_u8(*args).view(torch.int16),
                               dropout.dropout_u8_plain(*args).view(torch.int16))
                   for args in calls]
        del calls, batch, run
        torch.cuda.empty_cache()
        want = {k: 0 for k in train_launches}
        want["dropout_u8"] = (DROPOUT_WARM * MULTIPROTO_WARMUP
                              + DROPOUT_MUL * (MULTIPROTO_STEPS - MULTIPROTO_WARMUP))
        if train_launches != want:
            bad.append(f"train launches {train_launches}, expected {want}")
        if n_drop != DROPOUT_MUL or len(drop_ok) != n_drop or not all(drop_ok):
            bad.append(f"dropout calls of a step against plain: {n_drop} calls, {drop_ok}")
        if not restored:
            bad.append("a fresh trainer did not restore step 6 and its prototypes exactly")
        if not (torch.isfinite(proto_norm).all() and proto_norm.max().item() <= 1 + 1e-5
                and proto_norm.min().item() > 0.5):
            bad.append(f"prototype norms in [{proto_norm.min().item()}, "
                       f"{proto_norm.max().item()}]")
        mul = [m["seg_loss"] == m["seg_mul_loss"] for m in metrics]
        if (len(metrics) != MULTIPROTO_STEPS
                or mul != [k >= MULTIPROTO_WARMUP for k in range(MULTIPROTO_STEPS)]):
            bad.append(f"seg_mul_loss took over at steps {mul}")
        if not all(np.isfinite(list(m.values())).all() for m in metrics):
            bad.append(f"losses {metrics}")
        if len(protos_ms) != MULTIPROTO_STEPS:
            bad.append(f"{len(protos_ms)} prototype_learning calls")
        # ---- evaluation: tools/evaluate_torch.py on the checkpoint
        modes, eval_launches = [], {}
        ckpt = os.path.join(work, "ckpt_contrast")
        for mode in ("dsg", "emb"):
            rec, fail, got = eval_pair(
                CONTRAST_CONFIG, ckpt, mode, 2, EVAL_ROUTES, EVAL_PER_FORWARD, 1,
                overrides=synthetic_readers(CONTRAST_CATS, 2, eval_batch=True)
                + ["contrast.num_prototype", str(MULTIPROTO_P)], datasets=3, argmax_gate=None,
                f32_gate=True)
            modes.append(rec)
            bad += [f"eval {mode}: {f}" for f in fail]
            for k, n in got.items():
                eval_launches[k] = eval_launches.get(k, 0) + n
    parity = multiproto_card_vs_cpu(dev)
    if (parity["loss_rel"] >= F32_GATE or min(parity["grad_cosine"].values()) <= 0.9999
            or max(parity["param_rel"], parity["teacher_rel"], parity["bank_rel"],
                   parity["prototypes_rel"]) >= F32_GATE):
        bad.append(f"card vs CPU: {parity}")
    if max(max(r.values()) for r in parity["ema_residual"].values()) >= EMA_RESIDUAL_GATE:
        bad.append(f"card vs CPU: the teacher's EMA {parity['ema_residual']}")
    if parity["dropout_launches"] != {"cuda": DROPOUT_MUL, "cpu": 0}:
        bad.append(f"card vs CPU: dropout launches {parity['dropout_launches']}")
    for k, n in train_launches.items():
        launches[k] = n + eval_launches.get(k, 0) + (n_drop if k == "dropout_u8" else 0)
    steps = [r["step_ms"] for r in timings]
    emit(phase="contrast_multiproto", config=os.path.relpath(CONTRAST_CONFIG, ROOT),
         num_prototype=MULTIPROTO_P, dtype="bfloat16", metrics=metrics, step_ms=steps,
         median_step_ms=float(np.median(steps[1:])), prototype_learning_ms=protos_ms,
         median_prototype_learning_ms=float(np.median(protos_ms[1:])),
         max_memory_allocated=peak, restored=restored, train_launches=train_launches,
         prototype_norm=[proto_norm.min().item(), proto_norm.max().item()],
         dropout_calls_bit_equal=f"{sum(drop_ok)}/{n_drop}", card_vs_cpu=parity,
         eval=modes, launches=launches, seconds=time.perf_counter() - t0)
    if bad:
        raise RuntimeError(f"contrast_multiproto: {bad}")
    return launches


# ------------------------------------------------ the rest of the model zoo
HRNET_CONFIG = os.path.join(ROOT, "configs", "hrnet_w48_city.json")
HRNET_GNN_CONFIG = os.path.join(ROOT, "configs", "gnn_city_cam_a2d2.json")
HRNET_SEED = 1
# the card-vs-CPU train step's widths: every transition, branch, module and
# fusion of the stage dicts at widths 4-32 (tests/test_hrnet.py's)
HRNET_TEST_STAGES = {
    "stage2": dict(num_modules=1, num_branches=2, num_blocks=(1, 1), num_channels=(4, 8)),
    "stage3": dict(num_modules=1, num_branches=3, num_blocks=(1, 1, 1),
                   num_channels=(4, 8, 16)),
    "stage4": dict(num_modules=1, num_branches=4, num_blocks=(1, 1, 1, 1),
                   num_channels=(4, 8, 16, 32)),
}
# Swin-T wants H and W multiples of 7·32 = 224: the largest such frame
# within a Cityscapes frame
SWIN_H, SWIN_W = 896, 1792
SWIN_SEED = 1
GRAD_COSINE_GATE = 0.9999
LOSS_LOGITS = (8, 19, 128, 256)  # the loss library's logits
KMEANS_SHAPE = (65536, 256, 19)  # k-means' N, D, K


def stem1_calls_rels(calls):
    """Each captured kernel-1 call (x, w, scale, bias, relu) against its
    plain version: rel max-diff (KERNEL_GATE) and the bit-equal share."""
    from mds_tpu_torch.ops import stem

    out = []
    for args in calls:
        args = args[:EVAL_KERNEL_ARGS["stem_conv_bn_relu_s2"]]
        with torch.inference_mode():
            got, want, r = check_kernel_output(
                "stem_conv_bn_relu_s2", stem.stem_conv_bn_relu_s2,
                stem.stem_conv_bn_relu_s2_plain, args)
        out.append({"input": list(args[0].shape), "rel": r,
                    "bit_equal": share_equal(bits(got), bits(want))})
    return out


def logits_vs_plain(model, x, shape, kernel, dataset=0, f32_model=None):
    """The model's eval logits of `x` on the stem route against the plain
    path (rel max-diff, argmax agreement; bench.py:296-297's gate), with
    the route's calls of `kernel` (a name in ops/stem.py) captured. With
    `f32_model` (the model in f32), both bf16 paths' rel from its logits
    too (largest_call_rels' f32 gate)."""
    from mds_tpu_torch.ops import stem

    with torch.inference_mode():
        ref = model.eval_logits(x, dataset)
        with route(stem_impl="kernel"), captured(stem, kernel) as calls:
            got = model.eval_logits(x, dataset)
    if tuple(got.shape) != shape or not (torch.isfinite(got).all() and torch.isfinite(ref).all()):
        raise RuntimeError(f"bad logits {tuple(got.shape)}, expected {shape}")
    rec = {"rel": rel(got, ref), "argmax_agreement": share_equal(got.argmax(1), ref.argmax(1))}
    if f32_model is not None:
        with torch.inference_mode():
            exact = f32_model.eval_logits(x.float(), dataset)
        rec["f32"] = {"routed": rel(got, exact), "plain": rel(ref, exact),
                      "routed_argmax": share_equal(got.argmax(1), exact.argmax(1)),
                      "plain_argmax": share_equal(ref.argmax(1), exact.argmax(1))}
    return rec, calls


def logits_bad(name, rec):
    return [f"{name}: logits {rec}"] if logits_off(rec) else []


def kernel_calls_bad(name, rels, n):
    if len(rels) != n or any(r["bit_equal"] < BIT_EQUAL_GATE for r in rels):
        return [f"{name}: {len(rels)} kernel calls (expected {n}): {rels}"]
    return []


def _cosine(a, b):
    a, b = a.double().cpu().flatten(), b.double().cpu().flatten()
    return (a @ b / (a.norm() * b.norm()).clamp_min(1e-300)).item()


def grad_cosines(a, b):
    """Per-parameter gradient cosine of two models (same names)."""
    gb = dict(b.named_parameters())
    return {k: _cosine(p.grad, gb[k].grad) for k, p in a.named_parameters()}


def hrnet_card_vs_cpu(dev):
    """One train-mode forward and backward of HRNetW48 at test width
    (HRNET_TEST_STAGES, 2 datasets, aux prototypes, 4 images of 256×256 a
    dataset) from the same weights: in f32 on the card (TF32 off) and on
    the CPU, and in f64 on the CPU. The outputs' and running stats' rel,
    card against the CPU's f32; each parameter's gradient cosine with the
    CPU's f32 one, and each f32 gradient's distance from the f64 one (1 −
    cosine), the worst five beside."""
    from mds_tpu_torch.models.hrnet import HRNetW48

    rng = np.random.default_rng(12)
    xs = [torch.from_numpy(rng.normal(0, 1, (4, 3, 256, 256)).astype(np.float32))
          for _ in range(2)]
    ws = None
    runs = []
    for d, dtype in (("cpu", torch.float32), (dev, torch.float32), ("cpu", torch.float64)):
        m = HRNetW48((19, 11), 16, 0.8, True, n_bn=2, stages=HRNET_TEST_STAGES, dtype=dtype)
        m.init_weights(torch.Generator().manual_seed(HRNET_SEED))
        randomize_bn(m, HRNET_SEED + 1)
        m.to(d, dtype).train()
        out = m([x.to(d, dtype) for x in xs])
        if ws is None:
            g = torch.Generator().manual_seed(3)
            ws = {k: [torch.randn(t.shape, generator=g) for t in ts] for k, ts in out.items()}
        sum((t * w.to(d, dtype)).sum() for k in out for t, w in zip(out[k], ws[k])).backward()
        runs.append((m, {k: [t.detach().cpu() for t in ts] for k, ts in out.items()}))
    (cpu, ref), (card, got), (exact, _) = runs
    out_rel = max(rel(a, b) for k in got for a, b in zip(got[k], ref[k]))
    sd_c, sd_g = cpu.state_dict(), card.state_dict()
    stats_rel = max(rel(sd_g[k].cpu(), v) for k, v in sd_c.items() if "running" in k)
    cos, card_err, cpu_err = grad_cosines(card, cpu), grad_cosines(card, exact), grad_cosines(
        cpu, exact)
    bad = [k for k in cos if not (cos[k] > GRAD_COSINE_GATE
                                  or 1 - card_err[k] <= 2 * max(1 - cpu_err[k], 1e-12))]
    worst = sorted(cos, key=cos.get)[:5]
    return {"outputs_rel": out_rel, "running_stats_rel": stats_rel, "params": len(cos),
            "min_grad_cosine": cos[worst[0]],
            "worst": {k: {"cosine": cos[k], "card_from_f64": 1 - card_err[k],
                          "cpu_from_f64": 1 - cpu_err[k]} for k in worst},
            "failing": bad}


def phase_hrnet(dev):
    """HRNet-W48 (configs/hrnet_w48_city.json: 1 dataset, 19 classes, D =
    720) at full width in bf16, seeded weights with random BN statistics
    and the identity-start graphs of pretrain_bipartite_graphs, built by
    tools/serve_torch.py's build_e2e: 3 requests behind the HTTP server on
    the stem route (one kernel-1 launch each), the logits and the kernel
    call against the plain path, E2EModel and HTTP ms, idle share, peak
    memory; one served frame per dataset of configs/gnn_city_cam_a2d2.json
    (3 datasets), each kernel-1 call with its own dataset's fold;
    tools/evaluate_torch.py --mode ss on a checkpoint the phase writes,
    routed and plain; the f32 train step at test width, card against CPU.

    The gates: each kernel-1 call within KERNEL_GATE of its plain version,
    bit-equal on ≥ BIT_EQUAL_GATE of its outputs. The served and the eval
    logits take the f32 ratio gate (the route's distance from the f32
    model at most F32_RATIO_GATE times the plain path's), not bench.py's
    2e-2 against plain: a 1-ulp change at the stem grows through ~100 bf16
    layers of random weights, and on the H100 the route read 0.0285 from
    plain (labels agreeing on 0.973-0.984) where, from f32, it was no
    farther than plain (0.0207-0.0226 against 0.0215-0.0228); the label
    agreement is printed. The train step: outputs and running stats
    within F32_GATE; each parameter's gradient cosine with the CPU's above
    GRAD_COSINE_GATE, or else the card's f32 gradient within twice the
    CPU's f32 distance (1 − cosine) from the CPU's f64 one (at 2 × 128² a
    dataset a fuse affine, whose BN sees 8 values a channel, read 0.99914;
    at this step's 4 × 256² the cosines read ≥ 0.99990, thin above the
    gate)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from serve_torch import build_e2e

    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.engine.checkpoints import CheckpointManager
    from mds_tpu_torch.ops import stem

    t0 = time.perf_counter()
    bad, launches = [], {}
    cfg = Configer(config_file=HRNET_CONFIG)
    n_classes = cfg.n_cats(0)
    e2e = build_e2e(HRNET_CONFIG, seed=HRNET_SEED, device=dev)
    randomize_bn(e2e.model, HRNET_SEED + 1)
    model = e2e.model
    frames = np.random.default_rng(11).integers(0, 256, (3, 1, H, W, 3)).astype(np.uint8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    served = serve_and_check(e2e, "hrnet_w48", frames, n_classes, stem_impl="kernel")
    serve_peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in served["launches"]}
    want["stem_conv_bn_relu_s2"] = len(frames)
    if served["launches"] != want:
        bad.append(f"served launches {served['launches']}, expected {want}")
    logits, calls = logits_vs_plain(model, normalized(e2e, frames[0]),
                                    (1, n_classes, H // 4, W // 4), "stem_conv_bn_relu_s2",
                                    f32_model=f32_copy(model))
    bad += logits_bad("served", logits)
    kernel_rels = stem1_calls_rels(calls)
    bad += kernel_calls_bad("served", kernel_rels, 1)
    del calls
    frame_ms = {"kernel": [], "plain": []}
    for k, kw in (("kernel", {"stem_impl": "kernel"}), ("plain", {}),
                  ("plain", {}), ("kernel", {"stem_impl": "kernel"})):
        frame_ms[k].append(e2e_ms(e2e, frames[1], **kw))
    profiles = {}
    for k, kw in (("kernel", {"stem_impl": "kernel"}), ("plain", {})):
        with route(**kw):
            profiles[k] = profile_idle_share(lambda: e2e(torch.from_numpy(frames[1])),
                                             ("stem_kernel",))
    served_launches = served["launches"]["stem_conv_bn_relu_s2"]

    # ---- the 3-dataset config: each dataset's frame folds its own stats
    gcfg = Configer(config_file=HRNET_GNN_CONFIG)
    g = build_e2e(HRNET_GNN_CONFIG, seed=HRNET_SEED, device=dev)
    randomize_bn(g.model, HRNET_SEED + 2)
    cats = tuple(gcfg.n_cats(i) for i in range(gcfg.n_datasets))
    M = int(float(gcfg.get("GNN", "unify_ratio")) * sum(cats))
    if (g.model.max_num_unify_class, g.model.output_feat_dim, g.model.n_bn) != (M, 512, 3):
        bad.append(f"gnn config: M {g.model.max_num_unify_class}, D "
                   f"{g.model.output_feat_dim}, n_bn {g.model.n_bn}")
    conv1 = g.model.backbone.conv1
    per_dataset, folds = [], []
    for ds, n in enumerate(cats):
        g.dataset = ds
        reset_counts()
        with route(stem_impl="kernel"), captured(stem, "stem_conv_bn_relu_s2") as calls:
            labels = g.infer(frames[2])
        got = read_counts()["stem_conv_bn_relu_s2"]
        s, b = conv1.bn.fold_at(ds, conv1._shared())
        own = len(calls) == 1 and calls[0][4] is True and bool(
            torch.equal(calls[0][2], s) and torch.equal(calls[0][3], b))
        folds.append(s)
        rels = stem1_calls_rels(calls)
        per_dataset.append({"dataset": ds, "n_cats": n, "launches": got, "own_fold": own,
                            "classes": int(np.unique(labels).size),
                            "labels_in_range": bool(labels.min() >= 0 and labels.max() < n),
                            "kernel": rels})
        if got != 1 or not own or not per_dataset[-1]["labels_in_range"]:
            bad.append(f"gnn config dataset {ds}: {per_dataset[-1]}")
        bad += kernel_calls_bad(f"gnn config dataset {ds}", rels, 1)
        launches["stem_conv_bn_relu_s2"] = launches.get("stem_conv_bn_relu_s2", 0) + got
        del calls
    if any(torch.equal(folds[0], f) for f in folds[1:]):
        bad.append("gnn config: the datasets' folds are the same")
    del g

    # ---- evaluation: tools/evaluate_torch.py on a checkpoint of the served weights
    with tempfile.TemporaryDirectory() as work:
        ckpt = os.path.join(work, "ckpt")
        CheckpointManager(ckpt).maybe_save(
            {"model": {k: v.detach().cpu() for k, v in model.state_dict().items()},
             "step": 0}, force=True)
        del e2e, model
        torch.cuda.empty_cache()
        rec, fail, got = eval_pair(HRNET_CONFIG, ckpt, "ss", 2, {"stem_impl": "kernel"},
                                   {"stem_conv_bn_relu_s2": 1}, 1, argmax_gate=None,
                                   f32_gate=True)
        bad += [f"eval ss: {f}" for f in fail]
    launches["stem_conv_bn_relu_s2"] += served_launches + got["stem_conv_bn_relu_s2"]
    card_vs_cpu = hrnet_card_vs_cpu(dev)
    if not (card_vs_cpu["outputs_rel"] < F32_GATE and card_vs_cpu["running_stats_rel"] < F32_GATE
            and not card_vs_cpu["failing"]):
        bad.append(f"card vs CPU: {card_vs_cpu}")
    emit(phase="hrnet", config=os.path.relpath(HRNET_CONFIG, ROOT), dtype="bfloat16",
         requests=len(frames), latency_ms=served["latency_ms"],
         classes_per_reply=served["classes"], argmax_agreement=served["agree"],
         logits=logits, kernel1_calls=kernel_rels, e2e_ms=frame_ms, profile=profiles,
         serve_max_memory_allocated=serve_peak, served_launches=served["launches"],
         gnn_config={"config": os.path.relpath(HRNET_GNN_CONFIG, ROOT), "cats": cats, "M": M,
                     "datasets": per_dataset},
         eval=rec, card_vs_cpu=card_vs_cpu, launches=launches,
         seconds=time.perf_counter() - t0)
    if bad:
        raise RuntimeError(f"hrnet: {bad}")
    return launches


def swin_card_vs_cpu(dev):
    """One f32 train-mode forward of BiSeNetV1Swin (19 classes, aux heads)
    at (1, 3, 224, 224), TF32 off, card against CPU from the same weights:
    each output's rel."""
    from mds_tpu_torch import MODELS

    x = torch.from_numpy(np.random.default_rng(13).normal(0, 1, (1, 3, 224, 224))
                         .astype(np.float32))
    outs = []
    for d in ("cpu", dev):
        m = MODELS["bisenetv1_swin"](n_classes=(19,), aux=True, dtype=torch.float32)
        m.init_weights(torch.Generator().manual_seed(SWIN_SEED))
        randomize_bn(m, SWIN_SEED + 1)
        with torch.no_grad():
            out = m.to(d).train()([x.to(d)])
        outs.append([out["logits"][0].cpu()] + [a[0].cpu() for a in out["aux"]])
    return {"outputs": len(outs[0]), "max_rel": max(rel(a, b) for a, b in zip(outs[1], outs[0]))}


def phase_swin(dev):
    """BiSeNetV1Swin (19 classes, no aux heads) in bf16 at 896×1792, seeded
    weights with random BN statistics, in an E2EModel on the stem route: 3
    frames with one kernel-6 launch each (the SpatialPath's 7×7 stem), the
    labels against the plain path, the logits and the kernel call against
    plain; E2EModel ms in turns, peak memory; the f32 train forward at
    224×224, card against CPU."""
    from mds_tpu_torch import MODELS
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.data.labels import get_spec
    from mds_tpu_torch.deploy.e2e import E2EModel

    t0 = time.perf_counter()
    bad = []
    spec = get_spec(Configer(config_file=V1_CONFIG).dataset_cfg(0)["spec"])
    model = MODELS["bisenetv1_swin"](n_classes=(19,), aux=False, dtype=torch.bfloat16)
    model.init_weights(torch.Generator().manual_seed(SWIN_SEED))
    randomize_bn(model, SWIN_SEED + 1)
    e2e = E2EModel(model, spec.mean, spec.std, device=dev)
    frames = np.random.default_rng(14).integers(
        0, 256, (3, 1, SWIN_H, SWIN_W, 3)).astype(np.uint8)
    with route(stem_impl="kernel"):
        e2e.infer(frames[0])  # cuDNN's algorithm choice, not counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        labels = [e2e.infer(fr) for fr in frames]
        launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in launches}
    want["stem7_conv_bn_relu_s2"] = len(frames)
    if launches != want:
        bad.append(f"launches {launches}, expected {want}")
    plain = [e2e.infer(fr) for fr in frames]
    agree = [share_equal(torch.from_numpy(a), torch.from_numpy(b))
             for a, b in zip(labels, plain)]
    classes = [int(np.unique(a).size) for a in labels]
    if any(a.shape != (1, SWIN_H, SWIN_W) or a.min() < 0 or a.max() >= 19 for a in labels) \
            or min(classes) < 2:
        bad.append(f"labels: {[a.shape for a in labels]}, classes {classes}")
    logits, calls = logits_vs_plain(model, normalized(e2e, frames[0]),
                                    (1, 19, SWIN_H, SWIN_W), "stem7_conv_bn_relu_s2")
    bad += logits_bad("swin", logits)
    kernel_rels = stem7_calls_rels(calls)
    bad += kernel_calls_bad("swin", kernel_rels, 1)
    del calls
    frame_ms = {"kernel": [], "plain": []}
    for k, kw in (("kernel", {"stem_impl": "kernel"}), ("plain", {}),
                  ("plain", {}), ("kernel", {"stem_impl": "kernel"})):
        frame_ms[k].append(e2e_ms(e2e, frames[1], **kw))
    with route(stem_impl="kernel"):
        profile = profile_idle_share(lambda: e2e(torch.from_numpy(frames[1])),
                                     ("stem7_kernel",))
    del e2e, model
    card_vs_cpu = swin_card_vs_cpu(dev)
    if not card_vs_cpu["max_rel"] < F32_GATE:
        bad.append(f"card vs CPU: {card_vs_cpu}")
    emit(phase="swin", frame=[SWIN_H, SWIN_W], dtype="bfloat16", launches=launches,
         argmax_agreement=agree, classes_per_frame=classes, logits=logits,
         kernel6_calls=kernel_rels, e2e_ms=frame_ms, profile=profile,
         max_memory_allocated=peak, card_vs_cpu=card_vs_cpu,
         seconds=time.perf_counter() - t0)
    if bad:
        raise RuntimeError(f"swin: {bad}")
    return {"stem7_conv_bn_relu_s2": launches["stem7_conv_bn_relu_s2"]}


def card_vs_cpu_loss(name, fn, inputs, dev, grads=(0,)):
    """fn(*inputs) on the CPU and on the card (each input copied there;
    those at `grads` take a gradient): the value's rel, each gradient's
    cosine, and the card's ms for value and gradient (CUDA events, median
    of 5). A gradient whose cosine is not above GRAD_COSINE_GATE passes
    where the card's is within twice the CPU's f32 distance (1 − cosine)
    from the CPU's in f64 (the float inputs in f64): a sum with heavy
    cancellation (AAF's weights, softmaxed over 3 sizes, each summed over
    ~2.5 M pairs) is ill-conditioned in f32 on either device."""
    def run(d, dtype=None):
        xs = [x.to(d) if torch.is_tensor(x) else x for x in inputs]
        if dtype is not None:
            xs = [x.to(dtype) if torch.is_tensor(x) and x.is_floating_point() else x
                  for x in xs]
        for i in grads:
            xs[i] = xs[i].detach().clone().requires_grad_(True)
        v = fn(*xs)
        v.backward()
        return v.detach().cpu(), [xs[i].grad.cpu() for i in grads], xs

    (v_cpu, g_cpu, _), (v_card, g_card, xs) = run("cpu"), run(dev)

    def step():
        for i in grads:
            xs[i].grad = None
        fn(*xs).backward()

    rec = {"name": name, "value": v_card.item(), "rel": rel(v_card, v_cpu),
           "grad_cosine": [_cosine(a, b) for a, b in zip(g_card, g_cpu)],
           "ms": cuda_ms(step, n=5)}
    ok = [c > GRAD_COSINE_GATE for c in rec["grad_cosine"]]
    if not all(ok):
        _, g64, _ = run("cpu", torch.float64)
        rec["card_from_f64"] = [1 - _cosine(a, b) for a, b in zip(g_card, g64)]
        rec["cpu_from_f64"] = [1 - _cosine(a, b) for a, b in zip(g_cpu, g64)]
        ok = [o or c <= 2 * max(p, 1e-15)
              for o, c, p in zip(ok, rec["card_from_f64"], rec["cpu_from_f64"])]
    return rec, rec["rel"] < F32_GATE and all(ok)


def phase_loss_library(dev):
    """Each function of the loss library (rmi, Lovász, the boundary-aware
    focal loss, AAF with its weights, fs_ce and the FS wrappers, SegFix),
    k-means and soft-DTW, and the k-means loss at
    configs/bisenetv2_contrast_3ds.json's class counts, in f32 on the card
    against the CPU: value rel < 1e-4, gradient cosine > 0.9999, the card's
    ms. Logits (8, 19, 128, 256) with 5% of the labels ignored; k-means at
    N = 65536, D = 256, K = 19 from one set of initial indices."""
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.losses import fs
    from mds_tpu_torch.losses.aaf import AAFLoss
    from mds_tpu_torch.losses.contrast import MemoryBank
    from mds_tpu_torch.losses.cross_datasets_kmeans import CrossDatasetsCELossKMeans
    from mds_tpu_torch.losses.lovasz import boundary_aware_focal_loss, lovasz_softmax
    from mds_tpu_torch.losses.rmi import rmi_loss
    from mds_tpu_torch.ops.kmeans import (
        kmeans,
        kmeans_assign,
        kmeans_init_indices,
        pairwise_soft_dtw,
    )

    t0 = time.perf_counter()
    rng = np.random.default_rng(15)
    shape = LOSS_LOGITS
    b, c, h, w = shape
    logits = torch.from_numpy(rng.normal(0, 2, shape).astype(np.float32))
    aux = torch.from_numpy(rng.normal(0, 2, shape).astype(np.float32))
    lb = rng.integers(0, c, (b, h, w))
    lb[rng.random(lb.shape) < 0.05] = 255
    lb = torch.from_numpy(lb)
    alphas = torch.from_numpy(np.where(lb.numpy() == 255, 0.0, rng.uniform(0, 2, lb.shape))
                              .astype(np.float32))
    we, wn = (torch.from_numpy(rng.normal(0, 1, (c, 3)).astype(np.float32)) for _ in range(2))
    seg = lb.clone()
    dist = torch.from_numpy(rng.uniform(0, 10, lb.shape).astype(np.float32))
    ang = torch.from_numpy(rng.uniform(-180, 180, lb.shape).astype(np.float32))
    masks = torch.from_numpy(rng.normal(0, 2, (b, 2, h, w)).astype(np.float32))
    dirs = torch.from_numpy(rng.normal(0, 2, (b, 8, h, w)).astype(np.float32))
    aaf = AAFLoss(c)
    cases = [
        ("rmi_loss", lambda x, y: rmi_loss(x, y, c), (logits, lb), (0,)),
        ("lovasz_softmax", lambda x, y: lovasz_softmax(x, y), (logits, lb), (0,)),
        ("boundary_aware_focal_loss", boundary_aware_focal_loss, (logits, lb, alphas), (0,)),
        ("AAFLoss", lambda x, y, a, b: aaf(x, y, a, b), (logits, lb, we, wn), (0, 2, 3)),
        ("fs_ce", lambda x, y: fs.fs_ce(x, y, [0.5 + 0.1 * i for i in range(c)]),
         (logits, lb), (0,)),
        ("FSCELoss", lambda x, a, y: fs.FSCELoss()([x, a], y, [1.0, 0.4]), (logits, aux, lb),
         (0, 1)),
        ("FSOhemCELoss", lambda x, y: fs.FSOhemCELoss()(x, y), (logits, lb), (0,)),
        ("FSAuxCELoss", lambda x, a, y: fs.FSAuxCELoss()((a, x), y), (logits, aux, lb), (0, 1)),
        ("FSRMILoss", lambda x, y: fs.FSRMILoss()(x, y), (logits, lb), (0,)),
        ("FSAuxRMILoss", lambda x, a, y: fs.FSAuxRMILoss()((a, x), y), (logits, aux, lb),
         (0, 1)),
        ("FSCELOVASZLoss", lambda x, y: fs.FSCELOVASZLoss()(x, y), (logits, lb), (0,)),
        ("SegFixLoss", lambda m, d, s, di, an: fs.SegFixLoss()((m, d), (s, di, an)),
         (masks, dirs, seg, dist, ang), (0, 1)),
        ("pairwise_soft_dtw", lambda x, c: pairwise_soft_dtw(x, c, 0.5).sum(),
         (torch.from_numpy(rng.normal(0, 1, (64, 32, 16)).astype(np.float32)),
          torch.from_numpy(rng.normal(0, 1, (19, 32, 16)).astype(np.float32))), (0, 1)),
    ]
    bad, records = [], []
    for name, fn, inputs, grads in cases:
        rec, ok = card_vs_cpu_loss(name, fn, inputs, dev, grads)
        records.append(rec)
        if not ok:
            bad.append(rec)

    # k-means: clustered points, the same initial indices on both sides.
    # Lloyd's iterations from random indices split some clusters between
    # two centers, whose points then sit near a tie: 20 iterations on two
    # devices part there (in the first card run: centers 0.005 apart, 0.3%
    # of the assignments). So from random indices one iteration is held
    # card against CPU, and the card's 20-iteration result against the
    # CPU's reading of it (its assignment is the argmin of the distances to
    # its centers). From one index in each blob, both devices converge to
    # the same centers, and the 20 iterations are held card against CPU:
    # centers within F32_GATE, the same assignment.
    n, d, k = KMEANS_SHAPE
    centers = rng.normal(0, 1, (k, d)).astype(np.float32)
    blob = rng.integers(0, k, n)
    pts = centers[blob] + rng.normal(0, 0.3, (n, d))
    x = torch.from_numpy(pts.astype(np.float32))
    xd = x.to(dev)
    idx = kmeans_init_indices(n, k, torch.Generator().manual_seed(0))
    one_a_blob = torch.from_numpy(np.array([np.flatnonzero(blob == j)[0] for j in range(k)]))
    for distance in ("euclidean", "cosine"):
        c1_cpu, a1_cpu = kmeans(x, idx, n_iter=1, distance=distance)
        c1_card, a1_card = kmeans(xd, idx, n_iter=1, distance=distance)
        c_card, a_card = kmeans(xd, idx, distance=distance)
        a_cpu_of_card = kmeans_assign(x, c_card.cpu(), distance)
        cb_cpu, ab_cpu = kmeans(x, one_a_blob, distance=distance)
        cb_card, ab_card = kmeans(xd, one_a_blob, distance=distance)
        rec = {"name": f"kmeans_{distance}", "rel": rel(c1_card.cpu(), c1_cpu),
               "assignment_agreement": share_equal(a1_card.cpu(), a1_cpu),
               "final_assignment_vs_cpu_argmin": share_equal(a_card.cpu(), a_cpu_of_card),
               "one_a_blob_rel": rel(cb_card.cpu(), cb_cpu),
               "one_a_blob_assignment_equal": bool(torch.equal(ab_card.cpu(), ab_cpu)),
               "finite": bool(torch.isfinite(c_card).all() and torch.isfinite(cb_card).all()),
               "ms": cuda_ms(lambda: kmeans(xd, idx, distance=distance), n=3)}
        records.append(rec)
        if (rec["rel"] >= F32_GATE or rec["assignment_agreement"] < 0.999
                or rec["final_assignment_vs_cpu_argmin"] < 0.999
                or rec["one_a_blob_rel"] >= F32_GATE or not rec["one_a_blob_assignment_equal"]
                or not rec["finite"]):
            bad.append(rec)

    # the k-means loss at the contrast config's class counts: warmup, then
    # a main-phase step, from the same bank and prototypes
    cfg = Configer(config_file=CONTRAST_CONFIG)
    crit = CrossDatasetsCELossKMeans(cfg)
    U, D = crit.U, int(cfg.get("contrast", "proj_dim"))
    m_bank = int(cfg.get("contrast", "memory_bank_size"))
    seg_l = [torch.from_numpy(rng.normal(0, 2, (2, U, h, w)).astype(np.float32))
             for _ in CONTRAST_CATS]
    emb = [torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(0, 1, (2, D, h // 8, w // 8)).astype(np.float32)), dim=1)
        for _ in CONTRAST_CATS]
    lbs = []
    for n in CONTRAST_CATS:
        lbl = rng.integers(0, n, (2, h, w))
        lbl[rng.random(lbl.shape) < 0.05] = 255
        lbs.append(torch.from_numpy(lbl))
    protos = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(0, 1, (U, D)).astype(np.float32)), dim=1)

    def kmeans_loss(d):
        s = [t.to(d).clone().requires_grad_(True) for t in seg_l]
        e = [t.to(d).clone().requires_grad_(True) for t in emb]
        bank = MemoryBank.create(U, m_bank, D, device=d)
        y = [t.to(d) for t in lbs]
        _, _, bank, p = crit({"seg": s, "embed": e}, y, bank, protos.to(d), is_warmup=True)
        loss, metrics, bank, p = crit({"seg": s, "embed": e}, y, bank, p, cur_iter=50000)
        loss.backward()
        return loss.detach().cpu(), [t.grad.cpu() for t in s + e], bank.to("cpu"), p.cpu()

    l_cpu, g_cpu, b_cpu, p_cpu = kmeans_loss("cpu")
    l_card, g_card, b_card, p_card = kmeans_loss(dev)
    rec = {"name": "CrossDatasetsCELossKMeans", "value": l_card.item(), "rel": rel(l_card, l_cpu),
           "grad_cosine": [_cosine(a, b) for a, b in zip(g_card, g_cpu)],
           "bank_rel": rel(b_card.feats, b_cpu.feats),
           "bank_ptr_equal": bool(torch.equal(b_card.ptr, b_cpu.ptr)),
           "prototypes_rel": rel(p_card, p_cpu),
           "ms": cuda_ms(lambda: kmeans_loss(dev), n=3)}
    records.append(rec)
    if not (rec["rel"] < F32_GATE and min(rec["grad_cosine"]) > GRAD_COSINE_GATE
            and rec["bank_rel"] < F32_GATE and rec["bank_ptr_equal"]
            and rec["prototypes_rel"] < F32_GATE):
        bad.append(rec)
    emit(phase="loss_library", logits=list(shape), functions=records,
         seconds=time.perf_counter() - t0)
    if bad:
        raise RuntimeError(f"loss_library: {bad}")


# ------------------------------------------------------------------ parallel

NCCL_GATE = 1e-5       # loss and parameters: a world-1 NCCL group's step against no group
HALO_GATE = 1e-5       # the halo conv against the unsharded conv (f32, TF32 off)
MIOU_GATE = 1e-3       # world-2 eval against world 1
TILE_AGREEMENT_GATE = 0.999
TILE_MARGIN = 96
PARALLEL_CROPS = 4     # the f32 SyncBN parity step: world 1's crops of 512×1024
PARALLEL_EVAL_FRAMES = 8
PARALLEL_TIMEOUT = 900  # seconds a child may take
HALO_SHAPE = (1, 64, 512, 1024)
# a child: python -c CHILD role work device (MDS_* in its environment)
PARALLEL_CHILD = ("import sys; sys.path.insert(0, {root!r}); import chip_smoke; "
                  "chip_smoke.parallel_child(*sys.argv[1:])")


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(role, world, work, dev):
    """`world` children of this script in one process group (MDS_COORDINATOR
    on 127.0.0.1, MDS_NUM_PROCESSES, MDS_PROCESS_ID), each writing
    work/<role><rank>.json; their records. A child that fails or outlasts
    PARALLEL_TIMEOUT fails the phase, its log's end in the error; every
    child is stopped before this returns."""
    port, procs = str(_free_port()), []
    code = PARALLEL_CHILD.format(root=ROOT)
    try:
        for r in range(world):
            env = dict(os.environ, MDS_COORDINATOR=f"127.0.0.1:{port}",
                       MDS_NUM_PROCESSES=str(world), MDS_PROCESS_ID=str(r))
            log = open(os.path.join(work, f"{role}{r}.log"), "w")
            procs.append((subprocess.Popen([sys.executable, "-c", code, role, work, dev], env=env,
                                           stdout=log, stderr=subprocess.STDOUT), log))
        deadline = time.time() + PARALLEL_TIMEOUT
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.time(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = []
        for r in bad:
            with open(os.path.join(work, f"{role}{r}.log")) as f:
                tails.append(f"--- {role} rank {r} (exit {procs[r][0].returncode}):\n"
                             + f.read()[-4000:])
        raise RuntimeError("parallel: a child failed\n" + "\n".join(tails))
    recs = []
    for r in range(world):
        with open(os.path.join(work, f"{role}{r}.json")) as f:
            recs.append(json.load(f))
    return recs


def v2_train_init(cfg, dtype):
    """BiSeNetV2 as the config trains it (aux heads), seeded (WEIGHT_SEED)."""
    from mds_tpu_torch import MODELS

    init = MODELS[cfg.get("model_name")](n_classes=(cfg.n_cats(0),), n_bn=1, aux=True,
                                         dtype=dtype)
    init.init_weights(torch.Generator().manual_seed(WEIGHT_SEED))
    return init


def parity_batch(cfg):
    """The SyncBN parity step's uint8 batch: PARALLEL_CROPS crops of the
    config's size, each image at its own gain (the CEBlock's pooled BN),
    the two halves' pixel values shifted apart (local moments are not the
    global ones)."""
    h, w = cfg.get("train", "cropsize")
    im, lb = seg_batch(np.random.default_rng(3), PARALLEL_CROPS, h, w, cfg.n_cats(0))
    gain = np.random.default_rng(4).uniform(0.2, 0.5, (PARALLEL_CROPS, 1, 1, 1))
    im = im * gain
    im[PARALLEL_CROPS // 2:] += 127
    return im.astype(np.uint8), lb


def stats_of(model):
    return {k: v.detach().cpu().double() for k, v in model.named_buffers() if "running" in k}


def one_step_record(cfg, init, dtype, im, lb, dev, local_bn=False, seed=5):
    """One step of a copy of `init` on (im, lb) on the card: step_record,
    its running stats, the dropout launches, the collectives it made."""
    from mds_tpu_torch.parallel import mesh

    model = copy.deepcopy(init).to(dev)
    step, opt = train_step_for(cfg, model, dtype, local_bn=local_bn)
    reset_counts()
    before = mesh.all_reduce.collectives
    loss = step([torch.from_numpy(im).to(dev)], [torch.from_numpy(lb).to(dev)],
                torch.Generator().manual_seed(seed))["loss"].item()
    torch.cuda.synchronize()
    rec = dict(step_record(model, opt, loss), stats=stats_of(model),
               launches=read_counts(), collectives=mesh.all_reduce.collectives - before)
    return rec, model, step


def step_times(step, ims, lbs, n=5):
    """n steps after one warm-up, CUDA events each: (ms list, launches)."""
    step(ims, lbs, torch.Generator().manual_seed(0))
    reset_counts()
    times = []
    for i in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(ims, lbs, torch.Generator().manual_seed(i + 1))
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times, read_counts()


def tile_model(dev):
    """The served BiSeNetV2 (v2_model's weights) and its eval logits
    function, and the first of v2_model's frames as a (1, 3, H, W) f32
    image on the card."""
    from mds_tpu_torch.evaluation.evaluator import make_logits_fn

    e2e, frames = v2_model(dev)
    im = torch.from_numpy(frames[0]).to(dev).permute(0, 3, 1, 2).float()
    return e2e.model, make_logits_fn(e2e.model, e2e.mean.cpu().numpy(),
                                     e2e.std.cpu().numpy()), im


def _nccl_child(dev, work):
    """The config's bf16 step with no group, then under a world-1 NCCL
    group in both BN modes, each from the same weights and batch."""
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.parallel import mesh

    cfg = Configer(config_file=CONFIG)
    init = v2_train_init(cfg, torch.bfloat16)
    b = int(cfg.dataset_cfg(0)["ims_per_gpu"])
    h, w = cfg.get("train", "cropsize")
    im, lb = seg_batch(np.random.default_rng(0), b, h, w, cfg.n_cats(0))
    ims, lbs = [torch.from_numpy(im).to(dev)], [torch.from_numpy(lb).to(dev)]
    out = {"batch": [b, h, w]}
    ref = None
    for name, local_bn in (("no_group", False), ("sync", False), ("local", True)):
        if name == "sync":
            if not mesh.maybe_initialize_distributed(dev):
                raise RuntimeError("parallel: no NCCL group")
            out["backend"] = torch.distributed.get_backend()
        rec, model, step = one_step_record(cfg, init, torch.bfloat16, im, lb, dev, local_bn)
        before = mesh.all_reduce.collectives
        times, launches = step_times(step, ims, lbs)
        r = {"loss": rec["loss"], "median_step_ms": float(np.median(times)), "step_ms": times,
             "collectives_per_step": rec["collectives"],
             "collectives_timed": mesh.all_reduce.collectives - before,
             "launches": launches}
        if ref is None:
            ref = rec
        else:
            cos, rels = group_agreement(rec, ref)
            r.update(loss_rel=abs(rec["loss"] - ref["loss"]) / abs(ref["loss"]),
                     param_rel=max(rels.values()), grad_cosine_bf16=cos)
        out[name] = r
        del model, step, rec
        torch.cuda.empty_cache()
    return out


def _gloo_child(dev, work):
    """Rank r of two gloo ranks on the one card: the SyncBN f32 step, the
    dropout masks, the bf16 step's time, the ss eval, tiled inference and
    the halo conv, each against the parent's world-1 record in `work`."""
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.evaluation import evaluator
    from mds_tpu_torch.models.layers import FastDropout
    from mds_tpu_torch.ops import depthwise, stem
    from mds_tpu_torch.ops.dropout import dropout_u8, seed_words
    from mds_tpu_torch.parallel import mesh
    from mds_tpu_torch.parallel.spatial import halo_conv3x3, tiled_inference

    if not mesh.maybe_initialize_distributed(dev, backend="gloo"):
        raise RuntimeError("parallel: no gloo group")
    r, n = mesh.rank(), mesh.world()
    cfg = Configer(config_file=CONFIG)
    out = {"rank": r, "world": n, "launches": {}}

    def count(launches):
        for k, v in launches.items():
            out["launches"][k] = out["launches"].get(k, 0) + v

    # the SyncBN f32 step on this rank's rows
    im, lb = parity_batch(cfg)
    rows = slice(r * PARALLEL_CROPS // n, (r + 1) * PARALLEL_CROPS // n)
    rec, model, _ = one_step_record(cfg, v2_train_init(cfg, torch.float32), torch.float32,
                                    im[rows], lb[rows], dev)
    count(rec["launches"])
    ref = torch.load(os.path.join(work, "w1_parity.pt"), weights_only=False)
    cos, rels = group_agreement(rec, ref)
    _, stat_rels = group_agreement(rec, ref, "stats")
    out["syncbn"] = {"loss": rec["loss"], "loss_world1": ref["loss"],
                     "loss_rel": abs(rec["loss"] - ref["loss"]) / abs(ref["loss"]),
                     "grad_cosine": cos, "param_rel": max(rels.values()),
                     "stats_rel": max(stat_rels.values()),
                     "collectives": rec["collectives"],
                     "dropout_launches": rec["launches"]["dropout_u8"]}
    del rec, model, ref
    torch.cuda.empty_cache()

    # kernel 12's masks in a data-parallel step: the rows of the world-1 draw
    ones = torch.ones(DROPOUT_SHAPE, dtype=torch.bfloat16, device=dev).contiguous(
        memory_format=torch.channels_last)
    b = DROPOUT_SHAPE[0] // n
    with mesh.data_parallel(sync_bn=True):
        mine = FastDropout(0.1).train()(ones[r * b:(r + 1) * b], torch.Generator().manual_seed(21))
    whole = dropout_u8(ones, *seed_words(torch.Generator().manual_seed(21)), 26)
    out["dropout_masks"] = {
        "shape": list(mine.shape),
        "bit_equal_rows": bool(torch.equal(mine.view(torch.int16),
                                           whole[r * b:(r + 1) * b].view(torch.int16))),
        "keep_fraction": (mine != 0).float().mean().item()}
    del ones, mine, whole

    # the bf16 step at the config's batch per rank, timed
    bsz = int(cfg.dataset_cfg(0)["ims_per_gpu"]) // n
    h, w = cfg.get("train", "cropsize")
    bim, blb = seg_batch(np.random.default_rng(10 + r), bsz, h, w, cfg.n_cats(0))
    model = copy.deepcopy(v2_train_init(cfg, torch.bfloat16)).to(dev)
    step, _ = train_step_for(cfg, model, torch.bfloat16)
    before = mesh.all_reduce.collectives
    times, launches = step_times(step, [torch.from_numpy(bim).to(dev)],
                                 [torch.from_numpy(blb).to(dev)])
    count(launches)
    out["bf16_step"] = {"batch": [bsz, h, w], "step_ms": times,
                        "median_step_ms": float(np.median(times)),
                        "collectives_per_step": (mesh.all_reduce.collectives - before) / 6,
                        "launches": launches}
    del model, step
    torch.cuda.empty_cache()

    # ss eval of this rank's half of the frames on the deploy routes
    with returned(evaluator, "_psum_hist") as hists:
        run = eval_run(CONFIG, os.path.join(work, "ckpt"), "ss", PARALLEL_EVAL_FRAMES,
                       EVAL_ROUTES, ["--device", dev])
    count(run["launches"])
    w1 = np.load(os.path.join(work, "w1_eval.npz"))
    mine = list(range(r, PARALLEL_EVAL_FRAMES, n))
    differing = [int((p.cpu().numpy().astype(np.uint8) != w1["preds"][i]).sum())
                 for i, p in zip(mine, run["preds"])]
    out["eval"] = {"frames": mine, "mious": run["mious"], "mious_world1": w1["mious"].tolist(),
                   "pixels": int(hists[0].sum()), "pixels_world1": int(w1["pixels"]),
                   "differing_predictions": differing, "s_per_frame": run["s_per_frame"],
                   "launches": run["launches"]}
    del run

    # tiled inference: a tile a rank, on the deploy routes
    model, fn, frame = tile_model(dev)
    with torch.inference_mode(), route(**EVAL_ROUTES):
        reset_counts()
        logits = tiled_inference(fn, frame, model.n_classes[0], margin=TILE_MARGIN)
        torch.cuda.synchronize()
        count(read_counts())
        tile_launches = read_counts()
        ms = cuda_ms(lambda: tiled_inference(fn, frame, model.n_classes[0],
                                             margin=TILE_MARGIN), n=3)
    w1t = torch.load(os.path.join(work, "w1_tiles.pt"))
    labels = logits.argmax(1).cpu()
    out["tiles"] = {"logits_rel": rel(logits.cpu(), w1t["logits"]),
                    "label_agreement": share_equal(labels, w1t["logits"].argmax(1)),
                    "whole_frame_agreement": share_equal(labels, w1t["whole"]),
                    "frame_ms": ms, "launches": tile_launches}
    del logits, w1t
    # each of this rank's tile's kernel calls against its plain version
    names = ("detail_s1s2_fused", "stemblock_fused", "detail_tail_fused", "depthwise3x3")
    with torch.inference_mode(), route(**EVAL_ROUTES), contextlib.ExitStack() as stack:
        seen = {k: stack.enter_context(captured(depthwise if k == "depthwise3x3" else stem, k))
                for k in names}
        tiled_inference(fn, frame, model.n_classes[0], margin=TILE_MARGIN)
    kernel_rels = {}
    for k, calls in seen.items():
        mod = depthwise if k == "depthwise3x3" else stem
        with torch.inference_mode():
            kernel_rels[k] = max(rel(getattr(mod, k)(*a[:EVAL_KERNEL_ARGS[k]]),
                                     getattr(mod, k + "_plain")(*a[:EVAL_KERNEL_ARGS[k]]))
                                 for a in calls) if calls else None
    out["tiles"]["kernel_rels"] = kernel_rels
    del seen, model, fn, frame
    torch.cuda.empty_cache()

    # the halo conv on this rank's W-shard
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(HALO_SHAPE, device=dev, generator=gen)
    c = HALO_SHAPE[1]
    k = torch.randn((c, c, 3, 3), device=dev, generator=gen) * 0.05
    wd = HALO_SHAPE[-1] // n
    got = halo_conv3x3(x[..., r * wd:(r + 1) * wd].contiguous(), k)
    want = F.conv2d(x, k, padding=1)[..., r * wd:(r + 1) * wd]
    out["halo"] = {"shape": list(HALO_SHAPE), "rel": rel(got, want)}
    out["collectives"] = mesh.all_reduce.collectives
    return out


def parallel_child(role, work, dev="cuda"):
    """A child of the parallel phase: loads the kernel library the parent
    built (build.load finds it by its sources' hash), TF32 off, runs its
    role and writes work/<role><rank>.json."""
    from mds_tpu_torch.ops import build
    from mds_tpu_torch.parallel import mesh

    if dev == "cuda":
        build.load()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"nccl": _nccl_child, "gloo": _gloo_child, "nccl_trainers": _nccl_trainers_child,
           "gloo_trainers": _gloo_trainers_child}[role](dev, work)
    if "jax" in sys.modules:
        raise RuntimeError("parallel: a child imported jax")
    with open(os.path.join(work, f"{role}{mesh.rank()}.json"), "w") as f:
        json.dump(out, f)
    mesh.barrier()
    torch.distributed.destroy_process_group()


def phase_parallel(dev):
    """The parallel layer: NCCL at world 1, then two gloo ranks on the one
    card against this process's world-1 records (module docstring, 24).
    Returns the children's kernel launches."""
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.evaluation import evaluator
    from mds_tpu_torch.parallel.spatial import tiled_inference

    t0 = time.perf_counter()
    cfg = Configer(config_file=CONFIG)
    bad, launches = [], {}

    def count(d):
        for k, v in d.items():
            launches[k] = launches.get(k, 0) + v

    with tempfile.TemporaryDirectory() as work:
        (nccl,) = run_ranks("nccl", 1, work, dev)
        count(nccl["sync"]["launches"])
        count(nccl["local"]["launches"])
        for mode in ("sync", "local"):
            m = nccl[mode]
            if not (m["loss_rel"] < NCCL_GATE and m["param_rel"] < NCCL_GATE):
                bad.append(f"NCCL world 1 {mode}: loss {m['loss_rel']}, params {m['param_rel']}")
            if m["launches"].get("dropout_u8") != 50:
                bad.append(f"NCCL world 1 {mode}: launches {m['launches']}")
        if nccl["sync"]["collectives_per_step"] <= nccl["local"]["collectives_per_step"]:
            bad.append("NCCL world 1: SyncBN made no more collectives than local BN")

        # the world-1 records the ranks are held to
        im, lb = parity_batch(cfg)
        rec, _, _ = one_step_record(cfg, v2_train_init(cfg, torch.float32), torch.float32,
                                    im, lb, dev)
        torch.save({k: rec[k] for k in ("loss", "grads", "group", "params", "stats")},
                   os.path.join(work, "w1_parity.pt"))
        del rec
        served, _ = v2_model(dev)
        save_served_weights(CONFIG, served.model, WEIGHT_SEED, work)
        del served
        with returned(evaluator, "_psum_hist") as hists:
            run = eval_run(CONFIG, os.path.join(work, "ckpt"), "ss", PARALLEL_EVAL_FRAMES,
                           EVAL_ROUTES, ["--device", dev])
        np.savez(os.path.join(work, "w1_eval.npz"), mious=np.asarray(run["mious"]),
                 pixels=np.asarray(sum(int(h.sum()) for h in hists)),
                 preds=np.stack([p.cpu().numpy() for p in run["preds"]]).astype(np.uint8))
        w1_eval = {"mious": run["mious"], "s_per_frame": run["s_per_frame"]}
        del run
        model, fn, frame = tile_model(dev)
        with torch.inference_mode(), route(**EVAL_ROUTES):
            logits = tiled_inference(fn, frame, model.n_classes[0], n_tiles=2,
                                     margin=TILE_MARGIN)
            whole = fn(frame, 0).argmax(1)
            w1_tile_ms = cuda_ms(lambda: tiled_inference(
                fn, frame, model.n_classes[0], n_tiles=2, margin=TILE_MARGIN), n=3)
            whole_ms = cuda_ms(lambda: fn(frame, 0), n=3)
        torch.save({"logits": logits.cpu(), "whole": whole.cpu()},
                   os.path.join(work, "w1_tiles.pt"))
        w1_tiles = {"whole_frame_agreement": share_equal(logits.argmax(1), whole),
                    "frame_ms": w1_tile_ms, "whole_frame_ms": whole_ms}
        del model, fn, frame, logits, whole
        torch.cuda.empty_cache()

        ranks = run_ranks("gloo", 2, work, dev)
    for g in ranks:
        count(g["launches"])
        s, e, t = g["syncbn"], g["eval"], g["tiles"]
        where = f"gloo rank {g['rank']}"
        if not (s["loss_rel"] < F32_GATE and min(s["grad_cosine"].values()) > GRAD_COSINE_GATE
                and s["param_rel"] < F32_GATE and s["stats_rel"] < F32_GATE):
            bad.append(f"{where} SyncBN step: {s}")
        if s["dropout_launches"] != 10 or not g["dropout_masks"]["bit_equal_rows"]:
            bad.append(f"{where} dropout: {s['dropout_launches']} launches, "
                       f"{g['dropout_masks']}")
        if (e["pixels"] != e["pixels_world1"]
                or max(abs(a - b) for a, b in zip(e["mious"], e["mious_world1"])) >= MIOU_GATE):
            bad.append(f"{where} eval: {e}")
        want = {k: 0 for k in e["launches"]}
        want.update({k: v * len(e["frames"]) for k, v in EVAL_PER_FORWARD.items()})
        if e["launches"] != want:
            bad.append(f"{where} eval launches {e['launches']}, expected {want}")
        if not (t["logits_rel"] < KERNEL_GATE and t["label_agreement"] >= TILE_AGREEMENT_GATE):
            bad.append(f"{where} tiles: {t}")
        want = {k: 0 for k in t["launches"]}
        want.update(EVAL_PER_FORWARD)  # one tile a rank
        if t["launches"] != want:
            bad.append(f"{where} tile launches {t['launches']}, expected {want}")
        # each kernel at the tile's shapes against its plain version
        far = {k: v for k, v in t["kernel_rels"].items() if v is None or not v < KERNEL_GATE}
        if far:
            bad.append(f"{where} tile kernels against their plain versions: {far}")
        if not g["halo"]["rel"] < HALO_GATE:
            bad.append(f"{where} halo: {g['halo']}")
    emit(phase="parallel", nccl_world1=nccl, gloo_world2=ranks, world1_eval=w1_eval,
         world1_tiles=w1_tiles, launches=launches, seconds=time.perf_counter() - t0)
    if bad:
        raise RuntimeError(f"parallel: {bad}")
    return launches


# ------------------------------------------------------ the parallel trainers

PT_FLAGSHIP_OVERRIDES = ["train.gnn_iters", "1", "train.seg_iters", "2"]
PT_STEPS = ["GNN", "SEG"]  # one GNN step, then the UOT switch and one SEG step
PT_KERNEL6_PER_GNN_STEP = 9  # kernel 6 at 3 pyramid levels × 3 datasets
PT_DROPOUT_PER_STEP = 30     # kernel 12: 5 heads × 3 datasets, forward and backward
PT_CONTRAST_P = (1, 4)
PT_TIMED = 3                 # steps timed alone after the stage's steps
# the biases of snp_rn18's last layer4 block whose exact SEG-step gradient
# is zero (tests/torch_flagship_parity.py ZERO_GRAD): they add a per-channel
# constant that only a train-mode BN, the decoder's blend, reads. Their
# gradient is rounding noise, and AdamW's first update moves them by ±lr on
# its sign: printed, not gated
PT_ZERO_GRAD = re.compile(r"^seg\.backbone\.layer4\.0\.(bn2\.\d+|downsample\.1)(\.\d+)?\.bias$")
# AdamW's first update is lr·g/(|g| + ε): ±lr wherever |g| ≫ ε, whatever
# |g|, and as sensitive to g as ε/(|g| + ε) near zero. On the card the f32
# world-2 and world-1 SEG steps' gradients agree to a group cosine of
# 0.99999995 but part at single elements by up to 1.5e-3 of their tensor's
# largest (an element of layer1's conv at −3.9e-6 on world 1, +3.4e-6 on
# world 2 against 5.0e-3: a max-pool or OHEM-cutoff tie taken the other
# way), and such an element moves 2·lr apart. So the AdamW record's
# gradients are gated by cosine and by max-diff at PT_ADAM_GRAD_GATE (a
# missing reduction halves them), and its parameters where the two
# gradients agree to PT_ADAM_AGREE of their own size: there the updates
# differ by at most lr·PT_ADAM_AGREE/4. The other elements are counted;
# their share must stay below PT_ADAM_UNDECIDED, and their parameters
# within PT_ADAM_STEP·lr: a first update is at most lr either way, 1e-3 of
# it the f32 rounding of the two updated values
PT_ADAM_GRAD_GATE = 1e-2
PT_ADAM_AGREE = 1e-2
PT_ADAM_UNDECIDED = 1e-2
PT_ADAM_STEP = 2 * (1 + 1e-3)


def _dropout_keep(a):
    """A dropout_u8 argument as _Spy keeps it: a tensor's shape and whether
    it is channels_last; a number as it is."""
    if torch.is_tensor(a):
        return tuple(a.shape), a.is_contiguous(memory_format=torch.channels_last)
    return a


def dropout_mask(call, dev, rows=None):
    """The keep mask a recorded dropout_u8 call draws (f32 ones through the
    kernel at the call's shape, layout, seed words, drop and offset), or its
    batch rows `rows`."""
    from mds_tpu_torch.ops import dropout

    (shape, cl), k0, k1, drop, offset = call
    ones = torch.ones(shape, device=dev)
    if cl:
        ones = ones.contiguous(memory_format=torch.channels_last)
    mask = dropout.dropout_u8(ones, k0, k1, drop, offset) != 0
    return mask if rows is None else mask[rows]


def pt_alternating_batch():
    """The gloo parity steps' batch at TEST_WIDTH: 4 crops of 64×64 a dataset
    (2 a rank), the halves' pixel values apart, so that a rank's own
    moments are not the global ones."""
    rng = np.random.default_rng(33)
    out = {"ims": [], "lbs": []}
    for n in (3, 4):
        im, lb = seg_batch(rng, 4, 64, 64, n)
        im = im // 2
        im[2:] += 128
        out["ims"].append(im)
        out["lbs"].append(lb)
    return out


def pt_rows(batch, r, n):
    from mds_tpu_torch.parallel import mesh

    return {k: mesh.shard_batch(v, r, n) for k, v in batch.items()}


def pt_alternating_record(dev, batch, mid):
    """snp_rn18_mulbn at TEST_WIDTH, f32, one GNN step then the switch and
    one SEG step on `batch` (this rank's rows under a group): each step's
    loss and the gradients it left (GNN, then seg), both nets' parameters,
    the running stats, the UOT graphs. Between the steps the trainer saves
    to the directory `mid` where it holds no checkpoint yet, and restores
    from it otherwise: the SEG step starts from the world-1 state (a f32
    trajectory parts by rounding, and the steps are held one at a time)."""
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.engine.gnn_trainer import AlternatingTrainer
    from mds_tpu_torch.parallel import mesh

    cfg = copy.deepcopy(TEST_WIDTH)
    cfg["model_name"] = "snp_rn18_mulbn"
    cfg["train"]["gnn_iters"] = 1
    t = AlternatingTrainer(Configer(configs=cfg), device=dev)
    rec = {"losses": [], "stages": [], "grads": {}, "group": {}}
    for k, (name, model) in enumerate((("gnn", t.gnn_model), ("seg", t.seg_model))):
        if k == 1:
            if t.latest_step(mid) is None and mesh.world() == 1:
                t.save(mid)
            else:
                t.restore(mid)
        m = t.step(batch, generator=torch.Generator().manual_seed(50 + k))
        rec["losses"].append(float(m["loss"].detach()))
        rec["stages"].append(t.timings[-1]["stage"])
        for pk, p in model.named_parameters():
            if p.grad is not None:
                rec["grads"][f"{name}.{pk}"] = p.grad.cpu().double()
                rec["group"][f"{name}.{pk}"] = f"{name}.{pk.split('.')[0]}"
    rec["params"] = {f"{n}.{k}": p.detach().cpu() for n, mod in
                     (("gnn", t.gnn_model), ("seg", t.seg_model))
                     for k, p in mod.named_parameters()}
    rec["group"].update({k: f"{k.split('.')[0]}.{k.split('.')[1]}" for k in rec["params"]
                         if k not in rec["group"]})
    rec["stats"] = {k: v.detach().cpu() for k, v in t.seg_model.state_dict().items()
                    if k.endswith(("running_mean", "running_var"))}
    rec["uot_bi"] = [np.asarray(g) for g in t.uot_bi]
    rec["adam"] = True
    rec["lr"] = max(g["lr"] * o.update_scale for o in (t.seg_opt, t.gnn_opt)
                    for g in o.param_groups)
    return rec


def pt_contrast_record(dev, batch, P, work, mid=None, first=0):
    """The contrast config at full width, f32, teacher momentum
    CARD_VS_CPU_EMA, warmup 1, contrast.num_prototype P: steps `first` to 1
    on `batch` (step 0 inside the warmup, step 1 after it), the generator
    seeded 60 + step; step 1 from `mid` where given (the world-1 state
    after step 0: its train state and extras). Each step's loss and
    gradients (a parameter without one as zeros), the state after step 0,
    the parameters, teacher, bank and prototypes after step 1, every
    dropout_u8 call."""
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.engine.contrast_trainer import ContrastTrainer
    from mds_tpu_torch.ops import dropout

    cfg = Configer(config_file=CONTRAST_CONFIG, args_parser=[
        "contrast.ema_momentum", str(CARD_VS_CPU_EMA), "lr.warmup_iters", "1",
        "contrast.num_prototype", str(P)])
    t = ContrastTrainer(cfg, work_dir=work, compute_dtype=torch.float32, device=dev)
    losses, grads0, after0 = [], None, None
    if first == 1:
        t.load(*mid)
    with captured(dropout, "dropout_u8", keep=_dropout_keep) as calls:
        for k in range(first, 2):
            m = t.step(batch, generator=torch.Generator().manual_seed(60 + k))
            losses.append(float(m["loss"]))
            if k == 0:
                grads0 = {n: (torch.zeros_like(p) if p.grad is None else p.grad).cpu().double()
                          for n, p in t.model.named_parameters()}
                after0 = (t.state(), t.extras())
                if mid is not None:
                    t.load(*mid)
    for p in t.model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    rec = dict(step_record(t.model, t.optimizer, losses[-1]), losses=losses, grads0=grads0,
               after0=after0,
               teacher={k: v.detach().cpu() for k, v in t.teacher.state_dict().items()
                        if v.is_floating_point()},
               bank=t.bank.feats.cpu(), bank_ptr=t.bank.ptr.cpu(), bank_count=t.bank.count.cpu(),
               prototypes=None if t.prototypes is None else t.prototypes.cpu(),
               dropout_calls=list(calls))
    return rec


def pt_compare(got, want):
    """A world-2 record against world 1's: loss rel (each step), per-group
    gradient cosine, and the worst group's rel of each state (as
    group_agreement: no tensor stands alone). The parameters leave out
    PT_ZERO_GRAD's and, in an AdamW record, the elements whose update the
    gradients leave undecided (PT_ADAM_UNDECIDED); both are printed."""
    zero = [k for k in want["params"] if PT_ZERO_GRAD.match(k)]
    params, undecided = dict(got["params"]), {"elements": 0, "of": 0, "max_diff": 0.0}
    if want.get("adam"):
        for k, g in want["grads"].items():
            if k in zero:
                continue
            keep = (got["grads"][k] - g).abs() <= PT_ADAM_AGREE * g.abs()
            d = (got["params"][k] - want["params"][k]).abs()[~keep]
            undecided["elements"] += int(d.numel())
            undecided["of"] += g.numel()
            if d.numel():
                undecided["max_diff"] = max(undecided["max_diff"], d.max().item())
            params[k] = torch.where(keep, got["params"][k], want["params"][k])
    cos, rels = group_agreement({**got, "params": params},
                                {**want, "params": {k: v for k, v in want["params"].items()
                                                    if k not in zero}})
    # a record that took the last steps only against want's last ones
    pairs = zip(got["losses"], want["losses"][len(want["losses"]) - len(got["losses"]):])
    out = {"loss_rel": max(abs(a - b) / abs(b) for a, b in pairs),
           "grad_cosine": min(cos.values()), "param_rel": max(rels.values()),
           "param_worst_group": max(rels, key=rels.get), "grad_cosines": cos}
    if zero:
        out["zero_grad_params"] = {"count": len(zero), "max_diff": max(
            (got["params"][k] - want["params"][k]).abs().max().item() for k in zero)}
    if want.get("adam"):
        _, grad_rels = group_agreement(got, want, "grads")
        out["adam_grad_maxdiff"] = max(grad_rels.values())
        out["adam_undecided"] = undecided
        out["adam_undecided_share"] = undecided["elements"] / max(undecided["of"], 1)
        out["adam_undecided_limit"] = PT_ADAM_STEP * max(got["lr"], want["lr"])
    if got.get("grads0") is not None:
        cos0, _ = group_agreement({**got, "grads": got["grads0"]}, {**want, "grads": want["grads0"]})
        out["grad_cosines_step0"] = cos0
    for part in ("stats", "teacher"):
        if part in want:
            groups = {}
            for k in want[part]:
                groups.setdefault(k.rsplit(".", 1)[-1] if part == "stats"
                                  else got["group"].get(k, k.rsplit(".", 1)[-1]), []).append(k)
            out[part + "_rel"] = max(
                max((got[part][k].double() - want[part][k].double()).abs().max().item()
                    for k in ks) / max(max(want[part][k].abs().max().item() for k in ks), 1e-30)
                for ks in groups.values())
    for part in ("bank", "prototypes"):
        if want.get(part) is not None:
            out[part + "_rel"] = rel(got[part], want[part])
    return out


def pt_gate(where, cmp, bad):
    if not (cmp["loss_rel"] < F32_GATE and cmp["grad_cosine"] > GRAD_COSINE_GATE
            and all(v < F32_GATE for k, v in cmp.items()
                    if k.endswith("_rel") and k != "loss_rel")
            and cmp.get("adam_undecided_share", 0.0) < PT_ADAM_UNDECIDED
            and (cmp.get("adam_undecided", {}).get("max_diff", 0.0)
                 <= cmp.get("adam_undecided_limit", 0.0))
            and cmp.get("adam_grad_maxdiff", 0.0) < PT_ADAM_GRAD_GATE):
        bad.append(f"{where}: {cmp}")


def _pt_nccl_alternating(dev, cfg, ims, lbs, out_key, out, mid):
    """The flagship's GNN step, the switch and its SEG step (bf16, kernel 6
    on) from the seeded init, then PT_TIMED GNN and SEG steps alone: each
    step's loss, ms, kernel launches and collectives; the parameters. The
    trainer saves to `mid` after the GNN step where it holds no checkpoint,
    and restores from it otherwise (each step held from the same state)."""
    from mds_tpu_torch.engine.gnn_trainer import AlternatingTrainer
    from mds_tpu_torch.ops import stem
    from mds_tpu_torch.parallel import mesh

    t = AlternatingTrainer(cfg, compute_dtype=torch.bfloat16, device=dev)
    rec = {"steps": []}
    host = {"ims": [x.cpu().numpy() for x in ims], "lbs": [x.cpu().numpy() for x in lbs]}
    with route(stem_impl="kernel"):
        for k in range(len(PT_STEPS)):
            if k == 1:
                if t.latest_step(mid) is None:
                    t.save(mid)
                else:
                    t.restore(mid)
            reset_counts()
            before = mesh.all_reduce.collectives
            with captured(stem, "stem7_conv_bn_relu_s2") as calls:
                m = t.step(host, generator=torch.Generator().manual_seed(40 + k))
            torch.cuda.synchronize()
            rec["steps"].append({"stage": t.timings[-1]["stage"], "loss": float(m["loss"].detach()),
                                 "launches": read_counts(),
                                 "collectives": mesh.all_reduce.collectives - before,
                                 "kernel6_calls": stem7_calls_rels(calls)})
            del calls
        t.read_timings()
        rec["step_ms"] = [r["step_ms"] for r in t.timings]
        rec["switch_ms"] = [r["switch_ms"] for r in t.timings if "switch_ms" in r]
        rec["params"] = {f"{n}.{k}": p.detach().float().cpu() for n, mod in
                         (("gnn", t.gnn_model), ("seg", t.seg_model))
                         for k, p in mod.named_parameters()}
        reset_counts()
        before = mesh.all_reduce.collectives
        gnn_ms, _ = alone_ms(lambda: t.gnn_step(ims, lbs, torch.Generator().manual_seed(3)),
                             n=PT_TIMED)
        seg_ms, peak = alone_ms(lambda: t.seg_step(ims, lbs), n=PT_TIMED)
        rec.update(gnn_step_ms=gnn_ms, seg_step_ms=seg_ms, max_memory_allocated=peak)
        rec["timed_launches"] = read_counts()
        rec["timed_collectives"] = mesh.all_reduce.collectives - before
    out[out_key] = rec
    del t
    torch.cuda.empty_cache()


def _pt_nccl_contrast(dev, out_key, out, work, mid):
    """The contrast config at full width, 1 + 1 + 2 crops of 512×1024: two
    f32 steps from the seeded init on one batch, step 1 from `mid[0]` where
    it is set (else the state after step 0 goes there): each step's loss,
    launches and collectives; the parameters, teacher and bank. The
    compared steps are f32 because the bf16 backward is not deterministic
    on the card (two bf16 runs with no group part by 3.1-5.7e-5 on an H100).
    Then the bf16 trainer from the seeded init: one step, then PT_TIMED
    timed, their ms and launches."""
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.engine.contrast_trainer import ContrastTrainer
    from mds_tpu_torch.parallel import mesh

    cfg = Configer(config_file=CONTRAST_CONFIG)
    rng = np.random.default_rng(34)
    h, w = cfg.get("train", "cropsize")
    batch = {"ims": [], "lbs": []}
    for i, n in enumerate(CONTRAST_CATS):
        im, lb = seg_batch(rng, int(cfg.dataset_cfg(i)["ims_per_gpu"]), h, w, n)
        batch["ims"].append(torch.from_numpy(im).to(dev))
        batch["lbs"].append(torch.from_numpy(lb).to(dev))
    t = ContrastTrainer(cfg, work_dir=work, compute_dtype=torch.float32, device=dev)
    rec = {"steps": []}
    for k in range(2):
        if k == 1:
            if mid[0] is None:
                mid[0] = (t.state(), t.extras())
            else:
                t.load(*mid[0])
        reset_counts()
        before = mesh.all_reduce.collectives
        m = t.step(batch, generator=torch.Generator().manual_seed(70 + k))
        torch.cuda.synchronize()
        rec["steps"].append({"loss": float(m["loss"]), "launches": read_counts(),
                             "collectives": mesh.all_reduce.collectives - before})
    rec["params"] = {k: p.detach().float().cpu() for k, p in t.model.named_parameters()}
    rec["teacher"] = {k: v.detach().float().cpu() for k, v in t.teacher.state_dict().items()
                      if v.is_floating_point()}
    rec["bank"] = t.bank.feats.cpu()
    del t
    torch.cuda.empty_cache()
    t = ContrastTrainer(cfg, work_dir=work, compute_dtype=torch.bfloat16, device=dev)
    t.step(batch, generator=torch.Generator().manual_seed(79))
    reset_counts()
    t.timings.clear()
    for k in range(PT_TIMED):
        t.step(batch, generator=torch.Generator().manual_seed(80 + k))
    rec["step_ms"] = [r["step_ms"] for r in t.read_timings()]
    rec["timed_launches"] = read_counts()
    out[out_key] = rec
    del t
    torch.cuda.empty_cache()


def _pt_state_rels(a, b):
    """Each named tensor of `b` against `a`'s: the worst max-diff over the
    whole dict's largest magnitude."""
    mag = max(v.abs().max().item() for v in b.values())
    return max((a[k].double() - v.double()).abs().max().item() for k, v in b.items()) / mag


def _nccl_trainers_child(dev, work):
    """The two multi-dataset trainers at full width with no group, then under
    a world-1 NCCL group, each from the same seeded init and batch, each
    step from the same state."""
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.parallel import mesh

    cfg = Configer(config_file=FLAGSHIP_CONFIG, args_parser=PT_FLAGSHIP_OVERRIDES)
    ims, lbs = flagship_batch(np.random.default_rng(31), dev)
    out, mid = {}, [None]
    for name in ("no_group", "nccl"):
        if name == "nccl":
            if not mesh.maybe_initialize_distributed(dev):
                raise RuntimeError("parallel_trainers: no NCCL group")
            out["backend"] = torch.distributed.get_backend()
        _pt_nccl_alternating(dev, cfg, ims, lbs, f"alternating_{name}", out,
                             os.path.join(work, "nccl_mid"))
        _pt_nccl_contrast(dev, f"contrast_{name}", out, work, mid)
    for kind in ("alternating", "contrast"):
        a, b = out[f"{kind}_nccl"], out[f"{kind}_no_group"]
        cmp = {"loss_rel": max(abs(x["loss"] - y["loss"]) / abs(y["loss"])
                               for x, y in zip(a["steps"], b["steps"])),
               "params_rel": _pt_state_rels(a.pop("params"), b.pop("params"))}
        if kind == "contrast":
            cmp["teacher_rel"] = _pt_state_rels(a.pop("teacher"), b.pop("teacher"))
            cmp["bank_rel"] = rel(a.pop("bank"), b.pop("bank"))
        out[f"{kind}_nccl_cmp"] = cmp
    return out


def _gloo_trainers_child(dev, work):
    """Rank r of two gloo ranks on the one card: the mulbn alternating steps
    and the contrast steps at P = 1 and 4 on this rank's rows, each against
    the parent's world-1 record; each dropout_u8 call's mask against the
    world-1 call's rows; one bf16 GNN step at TEST_WIDTH with kernel 6 on,
    each of its calls against the plain version."""
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.engine.gnn_trainer import AlternatingTrainer
    from mds_tpu_torch.ops import stem
    from mds_tpu_torch.parallel import mesh

    if not mesh.maybe_initialize_distributed(dev, backend="gloo"):
        raise RuntimeError("parallel_trainers: no gloo group")
    r, n = mesh.rank(), mesh.world()
    w1 = torch.load(os.path.join(work, "w1_trainers.pt"), weights_only=False)
    out = {"rank": r, "world": n, "launches": {}}

    def count(launches):
        for k, v in launches.items():
            out["launches"][k] = out["launches"].get(k, 0) + v

    reset_counts()
    before = mesh.all_reduce.collectives
    rec = pt_alternating_record(dev, pt_rows(pt_alternating_batch(), r, n),
                                os.path.join(work, "w1_mid"))
    out["alternating"] = dict(pt_compare(rec, w1["alternating"]),
                              stages=rec["stages"], collectives=mesh.all_reduce.collectives - before,
                              uot_equal=all(np.array_equal(a, b) for a, b in zip(
                                  rec["uot_bi"], w1["alternating"]["uot_bi"])))
    count(read_counts())
    cbatch = pt_rows(contrast_parity_batch(), r, n)
    b = len(cbatch["ims"][0])
    for P in PT_CONTRAST_P:
        reset_counts()
        before = mesh.all_reduce.collectives
        # P = 1 from the seeded init; P = 4 its step after the warmup alone,
        # from world 1's state after step 0
        rec = pt_contrast_record(dev, cbatch, P, os.path.join(work, f"rank{r}_{P}"),
                                 w1[f"contrast{P}"]["after0"], first=0 if P == 1 else 1)
        launches = read_counts()
        count(launches)
        want = w1[f"contrast{P}"]
        calls, wcalls = rec["dropout_calls"], want["dropout_calls"]
        wcalls = wcalls[len(wcalls) - len(calls):]
        masks_equal = bool(calls) and all(
            c[1:4] == wc[1:4] and torch.equal(dropout_mask(c, dev),
                                              dropout_mask(wc, dev, slice(r * b, (r + 1) * b)))
            for c, wc in zip(calls, wcalls))
        out[f"contrast{P}"] = dict(pt_compare(rec, want), masks_equal=masks_equal,
                                   dropout_calls=len(calls),
                                   dropout_launches=launches["dropout_u8"],
                                   collectives=mesh.all_reduce.collectives - before,
                                   bank_ptr_equal=torch.equal(rec["bank_ptr"], want["bank_ptr"]))
    # kernel 6 in a data-parallel GNN step: each call against its plain version
    cfg = copy.deepcopy(TEST_WIDTH)
    t = AlternatingTrainer(Configer(configs=cfg), compute_dtype=torch.bfloat16, device=dev)
    ab = pt_rows(pt_alternating_batch(), r, n)
    reset_counts()
    with route(stem_impl="kernel"), captured(stem, "stem7_conv_bn_relu_s2") as calls:
        t.step(ab, generator=torch.Generator().manual_seed(52))
    launches = read_counts()
    count(launches)
    out["kernel6"] = {"launches": launches["stem7_conv_bn_relu_s2"],
                      "calls": stem7_calls_rels(calls)}
    out["collectives"] = mesh.all_reduce.collectives
    return out


def phase_parallel_trainers(dev):
    """The two multi-dataset trainers at world size > 1 (module docstring,
    25). Returns the children's kernel launches on the trainers' paths."""
    t0 = time.perf_counter()
    bad, launches = [], {}

    def count(d):
        for k, v in d.items():
            launches[k] = launches.get(k, 0) + v

    with tempfile.TemporaryDirectory() as work:
        (nccl,) = run_ranks("nccl_trainers", 1, work, dev)
        for name in ("no_group", "nccl"):
            a, c = nccl[f"alternating_{name}"], nccl[f"contrast_{name}"]
            for st in a["steps"]:
                count(st["launches"])
                want = PT_KERNEL6_PER_GNN_STEP if st["stage"] == "GNN" else 0
                k6 = st["launches"]["stem7_conv_bn_relu_s2"]
                far = [x for x in st["kernel6_calls"] if not x["rel"] < KERNEL_GATE]
                if k6 != want or len(st["kernel6_calls"]) != want or far:
                    bad.append(f"{name} {st['stage']} step: kernel 6 {k6}, calls far {far}")
            if [st["stage"] for st in a["steps"]] != PT_STEPS:
                bad.append(f"{name}: stages {[st['stage'] for st in a['steps']]}")
            count(a["timed_launches"])
            for st in c["steps"]:
                count(st["launches"])
                if st["launches"]["dropout_u8"] != PT_DROPOUT_PER_STEP:
                    bad.append(f"{name} contrast step: launches {st['launches']}")
            count(c["timed_launches"])
            if c["timed_launches"]["dropout_u8"] != PT_DROPOUT_PER_STEP * PT_TIMED:
                bad.append(f"{name} bf16 contrast steps: launches {c['timed_launches']}")
        for kind in ("alternating", "contrast"):
            far = {k: v for k, v in nccl[f"{kind}_nccl_cmp"].items() if not v < NCCL_GATE}
            if far:
                bad.append(f"NCCL world 1 {kind} against no group: {far}")
        if nccl["alternating_nccl"]["steps"][1]["collectives"] == 0:
            bad.append("NCCL world 1: the SEG step made no collective")

        # the world-1 records the gloo ranks are held to
        w1 = {"alternating": pt_alternating_record(dev, pt_alternating_batch(),
                                                   os.path.join(work, "w1_mid"))}
        for P in PT_CONTRAST_P:
            w1[f"contrast{P}"] = pt_contrast_record(dev, contrast_parity_batch(), P,
                                                     os.path.join(work, f"w1_{P}"))
        torch.save(w1, os.path.join(work, "w1_trainers.pt"))
        w1_losses = {k: v["losses"] for k, v in w1.items()}
        del w1
        torch.cuda.empty_cache()
        ranks = run_ranks("gloo_trainers", 2, work, dev)
    for g in ranks:
        count(g["launches"])
        where = f"gloo rank {g['rank']}"
        a = g["alternating"]
        pt_gate(f"{where} alternating", a, bad)
        if a["stages"] != PT_STEPS or not a["uot_equal"]:
            bad.append(f"{where} alternating: stages {a['stages']}, graphs {a['uot_equal']}")
        for P in PT_CONTRAST_P:
            c = g[f"contrast{P}"]
            pt_gate(f"{where} contrast P={P}", c, bad)
            want = 2 * PT_DROPOUT_PER_STEP if P == 1 else DROPOUT_MUL
            if not (c["masks_equal"] and c["dropout_launches"] == want and c["bank_ptr_equal"]):
                bad.append(f"{where} contrast P={P}: masks {c['masks_equal']}, launches "
                           f"{c['dropout_launches']} (expected {want}), ptr {c['bank_ptr_equal']}")
        k6 = g["kernel6"]
        far = [x for x in k6["calls"] if not x["rel"] < KERNEL_GATE]
        if k6["launches"] != 3 * 2 or len(k6["calls"]) != 3 * 2 or far:
            bad.append(f"{where} kernel 6: {k6['launches']} launches, far {far}")
    emit(phase="parallel_trainers", nccl_world1=nccl, gloo_world2=ranks,
         world1_losses=w1_losses, launches=launches, seconds=time.perf_counter() - t0)
    if bad:
        raise RuntimeError(f"parallel_trainers: {bad}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, ROOT)
    from mds_tpu_torch.ops import build

    dev = "cuda"
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit(phase="device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    seconds = {}

    def timed(phase, *args):
        """phase(*args), its seconds kept under its name."""
        t0 = time.perf_counter()
        out = phase(*args)
        seconds[phase.__name__.replace("phase_", "")] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        return out

    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    emit(phase="build", seconds=time.perf_counter() - t0, library=lib.name)
    sass_check(lib)

    # the plain references run cuDNN convs in full f32 (TF32 off)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    results = timed(phase_kernels, dev)
    t0 = time.perf_counter()
    e2e, frames = v2_model(dev)
    dw_calls, ua_calls, tail_calls, c3_calls = main_path_inputs(e2e, frames[0])
    counts = [len(c) for c in (dw_calls, ua_calls, tail_calls, c3_calls)]
    if counts != [16, 1, 1, 1]:
        raise RuntimeError(f"a V2 frame made {counts} depthwise, fused-tail, "
                           "detail-tail and conv3 calls, expected 16, 1, 1, 1")
    results.update(depthwise_rows(dw_calls))
    results["upsample_argmax"] = upsample_argmax_row(ua_calls[0])
    results["detail_tail_fused"] = detail_tail_row(
        tail_calls[0], e2e.model.detail, normalized(e2e, frames[0]))
    results["conv3x3_bn_relu"] = conv3x3_row(c3_calls[0])
    del dw_calls, ua_calls, tail_calls, c3_calls
    emit(phase="kernels", ragged=new_kernels_ragged(dev))
    emit(phase="kernels", ragged=conv_kernels_ragged(dev))
    seconds["main_path_kernels"] = time.perf_counter() - t0
    results["dropout_u8"] = timed(phase_dropout, dev)
    launches = timed(phase_slice, dev, e2e, frames)
    del e2e
    launches["stem7_conv_bn_relu_s2"] = timed(phase_v1_slice, dev)["stem7_conv_bn_relu_s2"]
    launches["dropout_u8"] = timed(phase_train, dev)["dropout_u8"]
    launches["dropout_u8"] += timed(phase_trainer, dev)
    for phase in (phase_eval, phase_flagship, phase_flagship7, phase_graph_forks,
                  phase_clip, phase_contrast):
        for k, n in timed(phase, dev).items():
            launches[k] = launches.get(k, 0) + n
    with tempfile.TemporaryDirectory() as work:  # the mulbn checkpoint the audit reads
        for phase in (phase_mulbn, phase_audit):
            for k, n in timed(phase, dev, work).items():
                launches[k] = launches.get(k, 0) + n
    for k, n in timed(phase_contrast_multiproto, dev).items():
        launches[k] = launches.get(k, 0) + n
    for phase in (phase_hrnet, phase_swin):
        for k, n in timed(phase, dev).items():
            launches[k] = launches.get(k, 0) + n
    timed(phase_loss_library, dev)
    timed(phase_v1_train, dev)
    results["stem_conv3x3_s2"] = timed(phase_train_stem, dev)
    launches["stem_conv3x3_s2"] = results["stem_conv3x3_s2"]["launches"]
    timed(phase_parity, dev)
    for phase in (phase_parallel, phase_parallel_trainers):
        for k, n in timed(phase, dev).items():
            launches[k] = launches.get(k, 0) + n
    emit(phase_seconds=seconds)
    emit(kernels=[{
        "name": k, "route": "cuda", "source": src, "replaces": tpu,
        "launches": launches[k], "max_abs_err": results[k]["max_abs_err"],
        "ms": results[k]["ms"], "plain_ms": results[k]["plain_ms"],
        "bound_ms": results[k]["bound_ms"], "bound_by": results[k]["bound_by"],
        "library_ms": results[k]["library_ms"],
    } for k, (src, tpu) in SOURCES.items()])
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
