#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA
card — the quickest proof that the port builds, is right, serves and
trains (ResNet-50, the transformer LM, the LSTM text classifier, the
OCR CRNN and the attention NMT in f32 and bf16, the CIFAR-10 VGG, the
benchmark image nets and the Wide & Deep CTR), serves the LM in f32 and
bf16, and runs the raw-input recurrences, the large-vocabulary
cross-entropy and the embedding scatter-add in f32 and bf16.

Run from the root of a checkout, on a machine with one card and nvcc:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. The card (``nvidia-smi`` name and power limit, torch's name and
   device count).  Every kernel is built from ``paddle_tpu_torch/ops/
   kernels/csrc`` (one ``nvcc`` per source, all at once; timed).
2. Each kernel against its plain PyTorch twin on the card, at the shapes
   its path gives it: the f32 flash forward (3xTF32, reading q, k, v
   where they lie) at the prefill shape [8, 512, 12, 64] causal (and an
   odd T=333), the whole lse too; the f32 paged decode (split over the
   sequence, one launch) at B=32, H=12, D=64, page_size=16, 36 pages per
   row, ragged lengths including 0, 1, 16, 17 and 576, on two launches
   (the tickets reset), a rerun in the same bits, with its planted faults
   (``PAGED_F32_FAULTS``: a chunk's correction dropped, a ticket not
   reset) that must fail; the shared f32 GEMM
   tile (``csrc/gemm_f32.cuh``) as the BRGEMM kernel at every distinct
   1x1 conv of ResNet-50 at batch 64 (``RESNET_1X1``: each stage's
   branch2a and branch2c, the stride-2 branch2a and branch1 projections
   by a strided row map) with the stats epilogue, res2_2c also with
   affine+ReLU, and as the direct conv kernel at every direct conv of
   ResNet-50 (the 7x7 stem, the four stages' 3x3s; stats, res2 also
   affine+ReLU), AlexNet's conv1 and conv2 and small_vgg's widest and
   narrowest 3x3 (``DIRECT_SHAPES``).  Each shape prints the plan it
   took (tile, 16- or 4-byte copies, split), its error against the twin
   (max abs error <= 1e-4: f32 round-off of another summation order,
   TF32 off; the BN statistics as the moments they feed, sum / count
   and sumsq / count), a rerun in the same bits, and
   its times (below) with the device time of each of its kernels from a
   trace (the tile, the split's second pass, the stats reduction); the
   kernels cuDNN launches for ``F.conv2d`` at AlexNet's conv2 and res2's
   and res3's 3x3; and the blocks an SM holds of every instantiation of
   both tiles, f32 and bf16, from the CUDA runtime, against the tile
   plan's tables.
   The flash forward and the backward's dQ and dK/dV kernels at the LM
   training shape [16, 1024, 12, 64] causal (and T=333; the forward gets
   a row of its own at this shape), each against its plain twin
   (max abs error <= 1e-4, relative to the largest entry where that is
   above 1), the forward's o against float64 exact attention (relative
   norm <= 2 x 3.25e-7, its planted one-pass and chained-O builds above
   it), and the whole backward through the autograd Function against
   float64 autograd of exact attention on the card (relative norm <=
   1e-5), with a backward that drops delta = rowsum(dO * O) as a planted
   fault that must exceed it.
   Times are CUDA-event means over many launches with the 50 MB L2
   flushed before each launch, beside the plain twin, one PyTorch library
   call used only here as a yardstick (``scaled_dot_product_attention``
   and its backward, ``torch.matmul``, channels_last ``F.conv2d``) and
   the bound: the larger
   of bytes moved / 3.35 TB/s and flops / 67 TFLOP/s (H100 SXM f32 FMA,
   the tensor cores would need TF32), counting only the taps of a conv
   that fall inside the image.  cuDNN's conv backward (dx, dw) at res2's
   3x3 and the stem against float64 on the CPU: relative error <= 5e-5,
   and the same call with TF32 allowed (a planted fault) above it.  The
   fused SGD / Momentum update on ResNet-50's 161 tensors (Momentum 0.9)
   and small_vgg's 46 (with L2 decay), one launch each, and the row-lazy
   update on the CTR's 8 [1000, 64] tables with the rows a batch of
   1,024 ids touches: equal to their plain twins bit for bit and on a
   rerun, untouched rows copied through; each timed beside the
   per-tensor twin loop, the bound (20 bytes an element) and, for the
   fused update, ``torch.optim.SGD(momentum=0.9, fused=True)`` and
   ``foreach=True``.
3. The serving engine end to end at the GPT-2-small width of the repo's
   LM config (vocab 50257, 12 layers, 12 heads, 768 wide, MLP 3072, f32,
   random weights from a seeded generator): 64 greedy requests with
   prompts of 16-512 tokens plus 8 at temperature 0.8, 64 new tokens
   each, 32 slots.  Kernel launch counts are zeroed just before and read
   just after: flash must run once per layer per prefill pass and paged
   attention once per layer per decode step.  Two greedy requests must
   equal the argmax of one full-context forward pass on the card.
4. ResNet-50 training through the v2 ``trainer.SGD`` (224x224x3, 1000
   classes, Momentum 0.9 at lr 0.1/64, random weights from a seeded
   generator, seeded synthetic data): one step at batch 2 from the same
   parameters on the CPU (plain twins) and on the card (kernels), each
   held against a float64 step on the CPU: cost within 1e-4 relative, and
   per parameter and BN statistic ||x32 - x64|| / ||x64 - x0|| <= 0.1
   (see ``witness_ratio``; the float64 step's own move under a 1e-6 input
   nudge is reported beside it).  A card step whose BN backward drops the
   batch mean's term is a planted fault that must exceed that limit, and
   the card's step must repeat bit for bit, and equal bit for bit the
   same step with its update through the optimizer's per-tensor loop
   instead of the one fused-update launch.  Then 10 steps at batch 64
   after 2 warm-up steps (img/s, step ms, peak memory), with the launch
   counts zeroed just before and read just after: exactly 36 BRGEMM, 17
   direct-conv and 1 fused-update launches per step, no per-tensor loop;
   then 3 steps under ``torch.profiler`` (device time by kernel class,
   busy share); then 20 steps with deterministic cuDNN on and off in turn
   (its cost in step time); then 20 steps with the update through the
   kernels and through the per-tensor loop in turn (blocks of 5: kernels,
   loop, loop, kernels; ``update_route_ab``); then ``test`` on 2 batches,
   again exactly 36 and 17 per batch and no update.
5. The LM training path, ``transformer.build_train_step``, at the width
   of phase 3 in f32 (flash attention, no remat), Adam at lr 1e-4 with
   bf16 moments (as the repo's LM benchmark): one step at batch 2 x 128
   on the card (kernels) and on the CPU (plain twins), each against the
   CPU's plain twins in float64 by the loss (relative 1e-5) and every
   gradient leaf (||g32 - g64|| / ||g64|| <= 1e-4), with TF32 allowed in
   cuBLAS and the flash backward's delta dropped as planted faults that
   must exceed it, and the card's step repeated bit for bit.  Then 2
   warm-up and 10 timed steps at batch 16 x 1024 on one fixed batch
   (tokens/s, step ms, peak memory, the f32 MFU against 67 TFLOP/s by
   ``bench.py``'s FLOP count), losses finite and falling, with the launch
   counts zeroed just before and read just after: exactly 12 flash
   forward, 12 dQ and 12 dK/dV launches per step; then 3 steps under
   ``torch.profiler`` (device time by kernel class, the optimizer split
   out, busy share).
6. The LSTM text classifier (``bench.py``'s ``_lstm_classify_cost`` and
   ``bench_lstm``'s batch and optimizer: embedding 128 over a 30,000-id
   vocabulary, fc to 4 x 1280, ``lstmemory`` with peepholes, ``last_seq``,
   a 2-way softmax fc, ``classification_cost``; f32, Adam at lr 2e-3 with
   bf16 moments).  Its kernels against their plain twins at the path's
   shapes (LSTM forward and backward at B 64, T 128, D 1280, lengths 100;
   the gather and the table gradient of 8,192 ids into [30000, 128]; max
   abs error <= 1e-4 x max(1, |ref|)), the forward with its gates slab
   (the path's form; without it timed beside) and the backward's
   stored-gates form (the path's) and remat form and a rerun equal in
   bits, the backward's planted
   faults (its dh product on the tensor cores in one TF32 pass, a range
   of the blocks' partials left out of the sum: ``LSTM_BWD_FAULTS``) each
   over that limit, the forward product's (one TF32 pass, over the limit;
   the remat product through another routine, which must break remat ==
   stored: ``LSTM_FWD_FAULTS``, also at phase 7's D 64 and phase 12's D
   512), each timed (alone too) beside its
   twin, its bound and a library call (cuDNN's ``nn.LSTM`` forward and
   backward, which has no peepholes and includes the input projection:
   the fc plus the forward kernel is timed beside it; ``F.embedding`` and
   ``embedding_dense_backward``).  The gather also with a padding id,
   equal in bits, its planted fault (the padding rows copied, not
   zeroed: ``GATHER_FAULTS``) unequal; the lookup forward one gather
   launch and no other, with no host sync (``gather_checks``); the
   gather and the lookup forward alone (a trace) and in host ms a call.
   Then a batch-2 step (ragged lengths,
   T = 16) on the card and on the CPU against a float64 witness by the
   loss (relative 1e-5) and every gradient leaf (1e-4), with TF32 allowed
   in cuBLAS on the card and a CPU backward whose dc carry drops its
   peephole terms as planted faults that must exceed it, and the card's
   step repeated bit for bit.  Then ``trainer.SGD``: the first step twice
   from the same parameters (bit for bit), 2 warm-up and 10 timed steps
   at batch 64 of 100-token sequences (T = 128 after the feeder's
   bucketing; sequences/s, step ms, peak memory, finite losses, the
   classification error from the events) with exactly one launch each of
   the LSTM forward, the LSTM backward in its stored-gates form (the slab
   fits the card: ``ops.rnn.stored_slab_fits``; no remat launch), the
   gather and the scatter-add per step; 3 steps under
   ``torch.profiler``, whose trace must hold no
   library sort (the lookup forward no longer dedups); ``test`` on 2
   batches (one forward and one gather per batch).
7. The OCR CRNN (``models/ocr_crnn.crnn_ctc_cost`` at ``bench_crnn``'s
   configuration: 32x96x1 images, two 3x3 ``img_conv_bn`` layers 1->16
   and 16->32 each with a 2x2 pool, ``layer.bilstm`` of 64, a 27-way
   softmax fc, ``ctc_layer``; f32, Adam at lr 1e-3 with bf16 moments).
   Its kernels against their plain twins at the path's shapes: the
   BiLSTM forward (x [64, 24, 256], D 64, both directions; its cluster
   plan, its time alone and the host's ms a call; a planted fault that
   reads the peers' h from the other parity must fail), the LSTM
   backward kernel in its remat form at the BiLSTM's shapes (xw
   [64, 24, 256], D 64) in both directions, the CTC
   forward-backward on log-probs [64, 24, 27] with labels of 5 in a
   16-slot (S = 33), in both ``normalize`` forms, the greedy decode of the
   same slab and of [8, 300, 100] with ragged lengths, ids and lengths in
   one launch (bit-equal to the twin and the compaction; alone and host
   ms; the eager ``ops/ctc`` chain beside it; a planted fault that drops
   the scan's carry across chunks must fail at T 300), the direct conv
   with its BN statistics epilogue at the two 3x3 shapes (Cin = 1 and 16); max abs error <= 1e-4 x
   max(1, |ref|), reruns equal in bits; each timed beside its twin, its
   bound and a library call the port never makes (cuDNN's bidirectional
   ``nn.LSTM``, input projection included and no peepholes, and the
   backward of its one-direction form; ``F.ctc_loss`` forward and backward by the log-probs; ``torch.argmax``
   over the slab as the decode's read floor).  Then a batch-2 step on the
   card and on the CPU against ``SGD.step_f64`` (plain SGD at lr 1, so
   the update is the gradient): cost within 1e-5 relative, and per
   parameter and BN statistic the witness ratio within 10x the float64
   step's own move under a 1e-6 input nudge (at least 1e-4); TF32 on the
   card and a CPU CTC twin whose beta recursion drops the s-2 skip are
   planted faults that must exceed it, and the card's step repeats bit
   for bit.  Then ``trainer.SGD``: 2 warm-up and 10 timed steps at batch
   64 (samples/s, step ms, peak memory, finite falling costs) with
   exactly 2 direct-conv, 1 BiLSTM, 2 LSTM-backward and 1 CTC launches
   per step and no other; 3 steps under ``torch.profiler``;
   ``paddle.infer`` on 64 samples and ``ocr_crnn.ctc_decode``, exactly 1
   BiLSTM, 2 conv and 1 decode launch; and the slow JAX test's
   convergence recipe (8 classes, rnn_size 32, Adam 3e-3, 25 passes of
   512 samples at batch 32): the last cost under 5% of the first and the
   greedy decode of 16 fresh samples exact on at least 13.
8. The attention NMT (``models/seqtoseq.seqtoseq_net`` at ``bench_nmt``'s
   configuration: vocab 30,000 both sides, word, encoder and decoder 512,
   32-token sequences, batch 64; 53,458,224 parameters; f32, Adam at lr
   5e-4 with bf16 moments).  Its kernels against their plain twins at the
   path's shapes (B 64, T 32, E = D = 512, half the rows ragged): the
   BiGRU forward (both directions), the GRU forward (with its slab timed
   beside), the GRU backward in its remat form and its stored-gates form
   (the same bits), the GRU
   kernels in both directions; max abs error
   <= 1e-4 x max(1, |ref|), reruns equal in bits; each timed beside its
   twin, its bound and cuDNN's ``nn.GRU`` (another cell: the reset gate
   after the product; a yardstick of scale only).  Then a batch-2 step
   (ragged source and target lengths, T = 16) on the card and on the CPU
   against the CPU's plain twins in float64: cost within 1e-5 relative,
   and every gradient leaf (||g32 - g64|| / ||g64||) within 10x the
   float64 gradient's own move under a 1e-6 nudge of the embedding tables
   (at least 1e-4); TF32 on the card, a CPU cell with cuDNN's reset
   convention and an attention that does not mask the source padding are
   planted faults that must exceed it, and the card's step repeats bit
   for bit.  Then
   ``trainer.SGD``: the first step twice (bit for bit), 2 warm-up and 10
   timed steps (sequences/s, step ms, peak memory) with exactly 1 BiGRU
   forward, 2 GRU remat backward, 0 GRU forward, 2 gathers and 2
   scatter-adds per step; 3 steps under ``torch.profiler``; ``test`` on
   2 batches (1 BiGRU forward and 2 gathers each); and ``layer.bigru``
   against the composed ``simple_gru2`` pair on the card (forward and
   every gradient within 1e-4 x max(1, |ref|); the pair's ``grumemory``
   runs the stored-gates backward, the BiGRU the remat one), then each
   ``grumemory`` of the pair as ``gru_seq`` on the pair's own inputs with
   the remat and the stored-gates backward (equal in bits), whose
   launches count the GRU forward and stored-gates rows.
9. The CIFAR-10 VGG with batch norm and dropout (``layers/networks.
   small_vgg``, the book's ``vgg_bn_drop``: 46 tensors, 7,909,450
   parameters, 11 batch norms; batch 128 of the port's seeded CIFAR-10;
   Momentum 0.9 at lr 0.1 / 128 with L2 0.0002 x 128; f32).
   ``channel_stats`` against its twin at small_vgg's five [R, C] views
   ([131072, 64] to [128, 512]; max abs error <= 1e-4 x max(1, |ref|), a
   rerun in the same bits with a call of another shape between, one
   kernel a call by the counter and in a trace), each timed beside its
   twin, its bound and ``torch.var_mean``, with its device time alone (a
   trace) and the host's ms a call; its planted faults
   (``STATS_FAULTS``: the finish drops a partial, a ticket left drawn),
   built from copies of the source, must fail.  Then a
   batch-4 train-mode step with dropout on, on the card and on the CPU,
   each against the float64 run on the same device (the same masks):
   cost within 1e-5 relative, every gradient leaf within 10x the float64
   gradient's own move under a 1e-6 image nudge (at least 1e-4), every
   BN moving statistic within 1e-5; TF32 on the card, dropout without
   its 1 / keep scaling and ``F.batch_norm``'s unbiased running variance
   are planted faults that must exceed them, and the card's step repeats
   bit for bit.  Then ``trainer.SGD``: the first step twice and once
   through the per-tensor loop (all three bit for bit), 2 warm-up and 10
   timed steps (images/s, step ms, peak memory) with exactly 11
   ``channel_stats``, 10 direct-conv and 1 fused-update launches a step,
   finite falling costs, a 3-step profile, the update's kernels-vs-loop
   blocks as in phase 4, and ``test`` on 2 batches (no
   ``channel_stats``).  Last, ``bench.py``'s image nets under its
   ``_image_step`` configuration at batch 64 (Momentum 0.9 at lr 0.01 /
   64): smallnet, AlexNet and GoogLeNet 2 warm-up and 5 timed steps each
   (ms a batch), VGG-19 one step, each with its exact direct-conv,
   BRGEMM and fused-update launches a step; then each again in bf16
   (``compute_dtype``, ``bench.py:113-114``) from freshly created
   parameters, with the bf16 forms' exact launches and no f32 tile's.
10. The Wide & Deep CTR (``models/ctr.wide_and_deep_ctr`` at
   ``bench_ctr``'s shapes: wide 10,000, 8 fields of vocab 1,000,
   embedding 64, hidden (256, 128); 756,506 parameters; batch 1,024 of
   uniform synthetic ids; f32, Momentum 0.9 at lr 0.05, the repo's CTR
   test optimizer, in place of ``bench_ctr``'s AdaGrad, which has no
   row-lazy rule; the tables row-lazy).  A batch-2 step on the card and
   on the CPU against a float64 witness (loss relative 1e-5, every
   gradient leaf 1e-4; TF32 on the card a planted fault that must exceed
   it), the card's step repeated bit for bit.  Then ``trainer.SGD``: the
   first step twice and once through the per-tensor loop (bit for bit),
   2 warm-up and 10 timed steps (examples/s, step ms, peak memory) with
   exactly 1 fused-update, 1 row-lazy, 8 gather and 8 scatter-add
   launches a step; a 3-step profile; the update's kernels-vs-loop
   blocks as in phase 4; ``paddle.infer`` on the predict
   layer for one batch equal to the eval step's probabilities; the
   row-lazy check: 3 steps (L2 1e-3) whose field-0 ids stay below 900,
   after which every row of that table no batch hit keeps its start's
   bits and a zero velocity, and the same run with the dense rule on the
   table, a planted fault, must fail it.
11. ``softmax_xent`` (row 4) at the LM's logits, [16 x 1023, 50257] f32
   (3.29 GB, seeded): the forward kernel (lse, NLL) and the backward
   kernel under g = 1 against their twins (1e-4 x max(1, |ref|)), reruns
   in the same bits, each timed beside its twin, its own device time, its
   bound (one read; one read and one write) and ``F.cross_entropy(
   reduction="none")``'s forward / backward.  Then the mean NLL and its
   gradient 10 times through the Function (launch counts zeroed just
   before, read just after: exactly 10 of each kernel) against the port's
   eager LM loss chain (``torch.logsumexp`` - gather, the mean, its
   backward) on the same logits: loss and gradient within 1e-4, step ms
   of each in blocks of 10 (kernel, eager, eager, kernel) and each one's
   peak memory.  A measurement only: the LM loss is not routed.
12. The raw-input recurrences ``ops.rnn.lstm`` (B 64, T 100, E 128, D
   512, reverse off and on) and ``ops.rnn.gru`` (B 64, T 32, E = D =
   512), the widths ``tools/bench_mem.py`` sizes their fused-input kernels
   at; seeded weights, half the rows shorter than T (one of length 1).
   Rows 6 and 9 (the fused-input forward kernels) against their twins in
   both directions (max abs error <= 1e-4 x max(1, |ref|), with and
   without the gate slab, reruns in the same bits), each timed beside its
   twin, its own device time, its bound (the valid row-steps' products),
   the port's unfused route (the ``torch.matmul`` projection and the row
   5 / row 8 forward kernel) and cuDNN's ``nn.LSTM`` / ``nn.GRU`` forward
   (input projection included; not the same cell).  Then each entry
   forward and backward 10 times against a fixed cotangent with the
   launch counts zeroed just before and read just after: exactly 10
   fused-input forward and 10 remat backward launches and no sequence
   forward (the unfused route: 10 sequence forward and 10 stored-gates
   backward launches); outputs and every input gradient (x, W_x, b,
   W_h, [W_hc], h0, [c0]) against a float64 witness of the plain
   composition on the card, per leaf within 1e-4 x max(1, max |ref|),
   with TF32 in cuBLAS and the ragged mask ignored as planted faults that
   must exceed it; a rerun in the same bits; step ms of the fused route
   against the unfused one in blocks of 10 (fused, unfused, unfused,
   fused).
13. bf16 ``compute_dtype`` (rows 13–15's bf16 forms: ``csrc/
   gemm_wgmma.cuh``'s Hopper tile where the copies can be 16 bytes wide,
   ``csrc/gemm_bf16.cuh``'s mma.sync tile elsewhere (the stem, AlexNet's
   conv1), and ``channel_stats_bf16``).  Every
   shape of ``RESNET_1X1`` and ``DIRECT_SHAPES`` and small_vgg's five
   ``channel_stats`` views in bf16, each against its twin on float64
   operands rounded once to bf16 (``bf16_agrees``: unequal on at most 1%
   of the elements, each within one bf16 ulp of its own magnitude plus
   sqrt(K) 2^-24 of its sum of |products|, an f32 sum's error; the
   statistics within 1e-4 as moments), a rerun in
   the same bits, a planted fault (an accumulator rounded to bf16 after
   every 16-deep slice, at res2_2c and the stem) that must fail it; each
   timed as in phase 2 beside its twin, bound (bytes at 2 B an element;
   flops at 989 TFLOP/s) and a library call (bf16 ``torch.matmul``,
   channels_last bf16 ``F.conv2d``, ``torch.var_mean``), with its host
   ms a call.  The Hopper tile's planted faults (``WGMMA_FAULTS``: A's
   shared-memory writes one chunk off the swizzle; a stage's empty
   barrier released before its wgmma group retired), built at the start
   from copies of ``csrc/gemm_wgmma.cuh`` into both sources, must fail
   ``bf16_agrees`` at res4's 3x3 and 1x1.  Then ResNet-50
   through ``trainer.SGD(compute_dtype=torch.bfloat16)``: the witness
   step at ResNet-50's blocks at an eighth of the width (64x64, batch 8;
   ``bf16_witness``: card and CPU per leaf within 2x the JAX package's
   own bf16 error against the float64 step plus 0.02, with a BN-mean
   control that must exceed it, bit for bit on a rerun, f32 masters and
   states); the layer witness at full width (224x224, batch 8;
   ``bf16_layer_witness``: each of the 53 conv + BN backward passes of
   the card's step against the CPU twins' on the same tensors, within
   0.02 relative norm, with every conv's dw dropped and the BN-mean fault
   as controls that must exceed it); then at phase 4's
   configuration the first bf16 step twice in the same bits (cuDNN's
   bf16 conv backward deterministic at every shape), a bf16 and an f32
   trainer, 2 warm-up and 10 timed steps
   each in blocks (bf16, f32, f32, bf16) with exactly 36 + 17 bf16 tile
   launches (36 + 16 on the Hopper tile, the stem's 1 on the mma.sync
   tile) and 1 update a bf16 step and no f32 tile launch (img/s, step
   ms, peak memory), a 3-step profile, and ``test`` on 2 batches in f32
   (36 + 17 f32 launches a batch, no bf16).  Then small_vgg at phase 9's
   configuration the same way: exactly 11 ``channel_stats_bf16`` and 10
   direct-conv bf16 launches a bf16 step (9 on the Hopper tile, the
   first conv's on the mma.sync tile), costs finite and falling.
14. The LM in bf16 (rows 2 and 3's bf16 forms: ``csrc/flash_attention.cu``'s
   Hopper forward, ``wgmma`` fed by TMA from q, k, v as they lie, and the
   ``mma.sync`` m16n8k16 forward, dQ and dK/dV kernels of
   ``flash_attention.cu`` and ``flash_attention_bwd.cu``, f32 sums).  At
   the LM training shape [16, 1024, 12, 64] causal and at T = 333, bf16
   operands: the Hopper forward, the mma.sync forward, dQ and dK/dV
   kernels each against their twins on the same inputs (``bf16_agrees`` with
   ``FLASH_BF16_FLIP``: unequal on at most 1% of the elements, each
   within one bf16 ulp plus 2^-7 of its sum of |terms|, a rounded P or dS
   flipped; lse within 1e-4), a rerun in the same bits, and three planted
   faults that must fail (an accumulator kept in bf16, delta dropped, the
   diagonal tile's mask off), and the Hopper forward's planted faults
   built from copies of the source (``FLASH_WGMMA_FAULTS``: P fed
   unrounded, a ring stage released before its products) must fail its
   check at [8, 512] or [16, 1024]; the Hopper forward, dQ and dK/dV
   timed as in phase 2, alone (a trace) and in host ms a call beside
   their twins, their bounds (2 B an element, 989 TFLOP/s) and bf16
   ``scaled_dot_product_attention`` with the flash backend (forward, and
   the whole backward); the mma.sync forward's times beside, off the
   path now.  Then ``transformer.build_train_step(cfg,
   Adam(1e-4, moment_dtype=torch.bfloat16), compute_dtype=torch.bfloat16)``
   at phase 5's width: the witness (``lm_bf16_witness``: the bf16 step of
   a 2-layer cut at batch 2 x 128 on the card and on the CPU, per gradient
   leaf and the loss within 2x the JAX package's own bf16 error against
   float64 plus 2^-8, the delta-dropped control over it, bit for bit on a
   rerun); then a bf16 and an f32 step from the same weights, 2 warm-up
   and 10 timed steps each in blocks of 5 (bf16, f32, f32, bf16) on one
   batch of 16 x 1024, with exactly 12 launches of the Hopper forward and
   of each bf16 backward form a bf16 step and no mma.sync forward or f32
   flash launch (and the reverse), tokens/s, step ms,
   peak memory, the bf16 MFU against 989 TFLOP/s; a 3-step profile.
15. The LSTM text classifier and the OCR CRNN in bf16 (rows 5, 7 and
   17's bf16 forms: ``csrc/lstm_seq.cu``'s ``lstm_fwd_bf16`` and
   ``lstm_bwd_bf16``, ``csrc/bilstm_seq.cu``'s ``bilstm_fwd_bf16``,
   ``csrc/embedding.cu``'s ``embedding_gather_bf16``).  Each form at its
   path's shape (the text LSTM at B 64, T 128, lengths 100, D 1280; the
   backward over the BiLSTM's f32 projection and the BiLSTM forward at x
   [64, 24, 256], D 64, both directions; 8,192 ids from [30000, 128])
   against its forced float64 steps (every step recomputed from the
   form's own carries: hs within one bf16 ulp plus its f32 sum term on
   all but 1% of the elements, dgates per step 1e-3, dh0 and dpeep 1e-5;
   end to end within 2x the twin's distance from float64), reruns and
   the two backward forms in the same bits, the gather bit for bit (as
   phase 6's ``gather_checks``, in bf16: padding, its fault, the lookup
   forward one launch without a host sync), and
   planted faults that must fail (the gate halves swapped, dgates
   unrounded in dh_{t-1}, the BiLSTM's projection rounded, and in a
   build of the source the dh product's second pass leaving a part out:
   ``LSTM_BF16_FAULTS``); each timed with the L2 flushed and alone (a
   trace) beside its twin, its bound (2 B an element, 989 TFLOP/s) and
   bf16 cuDNN ``nn.LSTM`` or ``F.embedding``; at the text shape the
   forward with its gates slab and the stored-gates backward (the path's
   forms), each timed beside the other form on one line.  The bf16
   witness steps of the two nets at a cut width (``rnn_bf16_witness``:
   every gradient leaf and the loss on the card and the CPU within 2x the
   JAX package's own bf16 error plus 2^-8; dW_h over unshifted stacks
   must exceed it; a rerun in the same bits).
   Then each at its bench configuration through ``trainer.SGD(...,
   compute_dtype=torch.bfloat16)`` (Adam with bf16 moments) beside f32,
   2 warm-up and 10 timed steps each in blocks (bf16, f32, f32, bf16):
   exactly 1 ``lstm_fwd_bf16``, 1 ``lstm_bwd_bf16`` in its stored-gates
   form, 1 bf16 gather and 1 (f32) scatter-add a text step, 1
   ``bilstm_fwd_bf16``, 2 ``lstm_bwd_bf16`` in its remat form, 2 bf16
   direct convs and 1 CTC a CRNN step, and no other form's; sequences/s
   and samples/s, step ms, peak memory, a 3-step profile.
16. The attention NMT in bf16 (rows 8 and 10's bf16 forms:
   ``csrc/gru_seq.cu``'s ``gru_fwd_bf16`` and ``gru_bwd_bf16``,
   ``csrc/bigru_seq.cu``'s ``bigru_fwd_bf16``).  Each form at the NMT's
   shape (B 64, T 32, E = D = 512; half the rows ragged, one of length 1):
   the GRU forward and backward (remat and stored, xw bf16) in both
   directions, the BiGRU forward and the backward over its f32
   projection, each against its forced float64 steps (every step
   recomputed from the form's own carries, r h rounded to bf16 there too:
   hs and the u/r/c slab within one bf16 ulp plus the f32 sum term on all
   but 1% of the elements, h_T 1e-4; dxw per step 1e-3, dh0 1e-5, rh
   equal on all but 1%, within two ulps), reruns and the two backward
   forms in the same bits, and planted faults that must fail (r h
   unrounded, the u/r halves swapped, the BiGRU's projection rounded, the
   backward's products unrounded, dW_hc from the unrounded r); each timed
   with the L2 flushed and alone (a trace) beside its twin, its bound (2 B
   an element, 989 TFLOP/s) and bf16 cuDNN ``nn.GRU`` (not the same
   cell).
   The NMT's bf16 witness step at a cut width (``nmt_bf16_witness``: every
   gradient leaf and the loss on the card and the CPU within 2x the JAX
   package's own bf16 error plus 2^-8; the GRUs' dW_h over unshifted
   stacks must exceed it; a rerun in the same bits).  The composed BiGRU
   check in bf16 (``layer.bigru`` against the ``simple_gru2`` pair, each
   against float64; the pair's ``grumemory`` through ``gru_fwd_bf16`` and
   the stored-gates backward, then both backward forms, remat and stored
   in the same bits).  Then
   ``bench_nmt``'s configuration through ``trainer.SGD(...,
   compute_dtype=torch.bfloat16)`` (Adam 5e-4, bf16 moments) beside f32,
   2 warm-up and 10 timed steps each in blocks (bf16, f32, f32, bf16):
   exactly 1 ``bigru_fwd_bf16``, 2 ``gru_bwd_bf16``, 2 bf16 gathers and 2
   (f32) scatter-adds a bf16 step and no other form's; sequences/s, step
   ms, peak memory, a 3-step profile.
17. Serving in bf16 (row 1's bf16 form: ``csrc/paged_attention.cu``'s
   ``split16``, split over the sequence in two launches a call, the
   scores and page maxes, then p.V and the combine, p rounded to bf16
   against the running max of whole pages as the Pallas kernel's page
   loop rounds it; and row 2's bf16 forward at serving's prefill shape,
   the Hopper form).  The bf16 kernel at phase 2's paged problem in bf16
   (B 32, H 12, D 64, page 16, 36 pages, the same ragged lengths) against
   its twin (``bf16_agrees`` with FLASH_BF16_FLIP: unequal on at most 1%
   of the elements, each within one bf16 ulp plus 2^-7 of sum_j p_j
   |v_j| / l), also with the queries reversed, a rerun in the same bits,
   idle rows exactly 0, a trace of its calls holding its two kernels and
   no other (``PAGED_BF16_KERNELS``: the device launches a call); the
   Hopper flash forward at [8, 512, 12, 64] causal on q, k, v as they
   lie (``flash_forward_agreement``); each timed with the L2
   flushed and alone (a trace) beside its twin, its bound (2 B an
   element) and bf16 SDPA, the flash forward also in host ms and the
   mma.sync form's times beside.  Then phase 3's
   configuration and requests on an f32 and a bf16 engine (``LM_FULL``
   with ``dtype=torch.bfloat16``, the f32 weights rounded once), one
   fresh engine a block in blocks (bf16, f32, f32, bf16) with the launch
   counts zeroed just before and read just after: a bf16 block launches
   the Hopper flash forward exactly 12 times a prefill pass and the bf16
   paged kernel 12 times a decode step and no f32 form (an f32 block the
   reverse); tokens/s, TTFT p50/p99, decode step and prefill p50, peak
   memory and the KV pool's bytes of each; a profile of 3 decode steps
   with all 32 slots live (device time by class, idle share) of each.
   Correctness: the first 4 greedy bf16 requests' logits recomputed in
   float64 from the same bf16 weights (``served_margin_check``): where
   the float64 top-2 margin exceeds 2x the bf16 logits' largest error on
   the prompt positions, the served token is the float64 argmax;
   elsewhere its float64 logit lies within that 2x of the max.  The
   share of bf16 greedy tokens equal to f32's is reported, not gated.
   Four planted faults, copies of the source under ``build/faults/``
   built beside it (``PAGED_BF16_FAULTS``): the scores left unscaled, the
   pages' weights dropped, p rounded against each chunk's own max, the
   ticket left set (the second launch wrong); each must fail the kernel
   check, and the first, served again, the margin check.
18. The last bf16 forms (rows 4, 6, 9 and 18: ``csrc/lstm_seq.cu``'s
   ``lstm_fi_fwd_bf16``, ``csrc/gru_seq.cu``'s ``gru_fi_fwd_bf16``,
   ``csrc/softmax_xent.cu``'s ``softmax_xent_fwd_bf16`` /
   ``_bwd_bf16``, ``csrc/embedding.cu``'s ``embedding_scatter_add_bf16``;
   ``bf16_last_forms``).  The fused-input forwards at ``RAW_RNN``'s
   shapes in both directions, with the bf16 remat backward over their
   f32 projection, against their forced float64 steps (the in-loop
   projection's |terms| in the sum term, K = E + D; h_T, c_T 1e-5, the
   GRU's h_T 1e-4), reruns and the slab form in the same bits, the twins'
   planted faults outside (the projection rounded, the gate halves
   swapped, r h unrounded); softmax_xent at the LM's logits in bf16 (lse
   and the NLL within 1e-5 x max(1, |ref|), dlogits unequal on at most 1%
   and within one ulp, reruns); the scatter-add of 8,192 ids into a bf16
   [30000, 128] with f32 and with bf16 rows (unequal on at most 1%,
   within one ulp, reruns).  Each timed with the L2 flushed and alone
   beside its twin, its bound (2 B an element, 989 TFLOP/s) and the bf16
   library call (cuDNN ``nn.LSTM`` / ``nn.GRU``, not the same cell;
   ``F.cross_entropy``; ``index_add``).  The path legs, the launch counts
   zeroed just before and read just after: ``ops.rnn.lstm`` (both
   directions) and ``gru`` on bf16 operands, forward and backward 10
   times (exactly 10 bf16 fused-input forwards and 10 bf16 remat
   backwards, no f32 fused-input or sequence forward; the unfused route's
   backward stored-gates), every leaf within
   2x the bf16 twins' distance from a float64 witness plus 2^-8 (the
   ragged mask ignored must fail), fused against the unfused bf16 route
   in blocks (fused, unfused, unfused, fused); ``softmax_xent``'s mean
   NLL and gradient on the bf16 logits 10 times against the eager LM
   loss chain on them (step ms, peak memory); the scatter-add 10 times
   with each rows' dtype.  Four planted faults, copies of the sources
   under ``build/faults/`` built beside it (``BF16_LAST_FAULTS``: the
   projection rounded to bf16 in each fused-input form, dlogits rounded
   twice, the rows rounded to the table's dtype), must each fail their
   form's check.
19. ``{"kernels": [...]}`` and then, as the last line, ``{"ok": true,
   "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

TOL = 1e-4
STEP_COST_RTOL = 1e-4    # f32 ResNet-50 step vs the f64 witness: cost, and
STEP_LEAF_LIMIT = 0.1    # per leaf ||x32 - x64|| / ||x64 - x0|| (below)
STEP_FLOOR = 1e-2        # of the leaf's share of the whole f64 update
CONV_BWD_RTOL = 5e-5     # cuDNN conv backward at the f32 policy vs f64
FLASH_BWD_F64_LIMIT = 1e-5  # flash backward kernels vs f64 exact attention
#: the f32 flash backward's distance from float64 before its 3xTF32 form
#: (the FMA kernels, PERF.md row 3): the tensor-core form stays within
#: FLASH_BWD_F64_SLACK times it
FLASH_BWD_F64_FMA = 7.92e-7
FLASH_BWD_F64_SLACK = 2.0
LM_LOSS_RTOL = 1e-5      # f32 LM step on the card vs the f64 witness: loss,
LM_GRAD_LIMIT = 1e-4     # per leaf ||g32 - g64|| / ||g64||
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores
XENT_GRAD_RTOL = 1e-5     # softmax_xent's gradient, entry by entry: rtol of
XENT_GRAD_ATOL = 1e-12    # the entry, plus atol x the largest entry
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 on the tensor cores
TF32_FLOPS_PER_S = 495e12   # H100 SXM dense TF32 on the tensor cores
BF16_ULP_SHARE = 0.01     # a bf16 form vs one rounding of its f64-summed
                          # twin: unequal on at most 1% of the elements
#: the LM at GPT-2-small's width (``bench.py:900-907``): phases 3, 5, 14
LM_FULL = {"vocab_size": 50257, "num_layers": 12, "num_heads": 12,
           "embed_dim": 768, "mlp_dim": 3072, "max_seq_len": 2048}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Mean CUDA-event time of ``fn`` with L2 flushed before each launch."""

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.int8, device=device)

    def __call__(self, fn, iters: int = 20) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def bound(nbytes: float, flops: float,
          flops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bound_3xtf32(nbytes: float, flops: float) -> tuple[float, str]:
    """The bound of an f32 function the card may compute on the tensor
    cores as 3xTF32 (three TF32 products for each f32 one): the lesser of
    the f32 FMA bound and the 3xTF32 one."""
    return min(bound(nbytes, flops), bound(nbytes, 3.0 * flops,
                                           TF32_FLOPS_PER_S))


def bf16_ulps(a, b):
    """Per element, how many bf16 steps apart two bf16 tensors lie (+0 and
    -0 equal): the distance of their bit patterns in sign-magnitude
    order."""
    def key(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i + 32768), i)
    return (key(a) - key(b)).abs()


def bf16_agreement(got, want, mag, kred: int = 1,
                   coef: float | None = None) -> dict:
    """How a bf16 output lies against ``want``, the one rounding of its
    f64-summed twin, element by element.  Each may lie one bf16 ulp (at
    the larger of the two magnitudes: two roundings, each within half of
    one) plus the error of an f32 sum of ``kred`` terms from ``want``:
    sqrt(kred) 2^-24 ``mag``, ``mag`` the element's sum of |products|
    (Higham and Mary's probabilistic bound; an element that cancels to
    near zero carries that error in many of its own tiny ulps).  ``coef``
    replaces sqrt(kred) 2^-24 where an operand of the sum is itself
    rounded to bf16 (``FLASH_BF16_FLIP``).  Returns the share of elements
    not equal, the share more than one of their own ulps apart, the most
    ulps apart, the largest absolute gap, and the largest share of its
    bound an element's gap takes."""
    d = bf16_ulps(got, want)
    g, w = got.double(), want.double()
    gap = (g - w).abs()
    top = torch.maximum(g.abs(), w.abs())
    ulp = torch.ldexp(torch.ones_like(top), torch.frexp(top)[1] - 8)
    coef = kred ** 0.5 * 2.0 ** -24 if coef is None else coef
    limit = ulp + coef * mag.double().reshape(gap.shape)
    return {"share_off": float((d > 0).float().mean()),
            "share_over_1ulp": float((d > 1).float().mean()),
            "max_ulps": int(d.max()),
            "max_abs_err": float(gap.max()),
            "max_share_of_bound": float((gap / limit).max())}


def bf16_agrees(got, want, mag, kred: int = 1,
                coef: float | None = None) -> bool:
    """``got`` equals the twin's one rounding on all but BF16_ULP_SHARE of
    the elements, and every element lies within its bound
    (:func:`bf16_agreement`) of it."""
    a = bf16_agreement(got, want, mag, kred, coef)
    return (a["share_off"] <= BF16_ULP_SHARE
            and a["max_share_of_bound"] <= 1.0)


def slice_rounded_product(a2, b2, k: int = 16):
    """The planted fault of the bf16 forms: a [..., M, K] @ b [..., K, N]
    whose f32 accumulator is rounded to bf16 after every k-deep slice of
    the reduction (an accumulator kept in bf16), returned in bf16."""
    acc = torch.zeros(*a2.shape[:-1], b2.shape[-1], device=a2.device)
    for k0 in range(0, a2.shape[-1], k):
        acc = (acc + a2[..., k0:k0 + k].float()
               @ b2[..., k0:k0 + k, :].float()).to(torch.bfloat16).float()
    return acc.to(torch.bfloat16)


def check_flash(dev, timer) -> dict:
    """Row 2 f32 at serving's prefill shape [8, 512, 12, 64] causal and at
    T 333: the in-place 3xTF32 forward (``_fwd_bthd``, what the prefill
    calls) against its twin on the padded problem, o and the whole lse
    (the padded rows' too); at 512 its times (L2 flushed, alone from a
    trace, the host's ms a call), its twin's and SDPA's memory-efficient
    f32 forward's, and the bound as the lesser of f32 FMA and 3xTF32
    (:func:`bound_3xtf32`)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    gen = torch.Generator(device=dev).manual_seed(1)
    b, h, d = 8, 12, 64
    scale = d ** -0.5
    err, row = 0.0, None
    for t in (512, 333):
        q, k, v = (torch.randn(b, t, h, d, generator=gen, device=dev)
                   for _ in range(3))
        fwd = lambda: FA._fwd_bthd(q, k, v, True, scale)  # noqa: E731
        o, lse = fwd()
        qp, kp, vp = FA._prep(q, k, v)
        o_ref, lse_ref = FA._fwd_plain(qp, kp, vp, t, True, scale)
        torch.cuda.synchronize()
        if not torch.isfinite(lse).all():
            raise AssertionError(f"flash forward T {t}: lse not finite")
        err = max(err,
                  (o - FA._from_bh(o_ref, b, h, t, d)).abs().max().item(),
                  (lse - lse_ref).abs().max().item())
        if t != 512:
            continue
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qh, kh, vh, is_causal=True)
            library_ms, library_alone_ms = timer(sdpa), call_alone_ms(sdpa)
        pairs = b * h * t * (t + 1) // 2       # causal (query, key) pairs
        flops = 4.0 * pairs * d                # q.k and p.v, 2 flops/FMA
        nbytes = 4.0 * (4 * b * t * h * d + b * h * t)  # q, k, v, o, lse
        bound_ms, by = bound_3xtf32(nbytes, flops)
        row = {"name": "flash_attention_fwd_tf32x3", "route": "cuda",
               "source": "paddle_tpu_torch/ops/kernels/csrc/"
                         "flash_attention.cu",
               "replaces": "paddle_tpu/ops/pallas/flash_attention.py:277",
               "shape": [b, t, h, d], "ms": timer(fwd),
               "alone_ms": device_ms([fwd], "flash_fwd_tf32x3_kernel"),
               "host_ms": host_ms(fwd),
               "plain_ms": timer(lambda: FA._fwd_plain(qp, kp, vp, t, True,
                                                       scale)),
               "bound_ms": bound_ms, "bound_by": by,
               "fma_bound_ms": bound(nbytes, flops)[0],
               "library_ms": library_ms,
               "library_alone_ms": library_alone_ms}
    row["max_abs_err"] = err
    if not err <= TOL:
        raise AssertionError(f"flash kernel vs plain: max abs err {err}")
    return row


def rel_norm(got, want) -> float:
    """||got - want|| / ||want|| in float64 on the CPU."""
    want = want.detach().cpu().double()
    return float(torch.linalg.norm(got.detach().cpu().double() - want)
                 / torch.linalg.norm(want))


#: the f32 backward's planted fault (csrc/tf32x3.cuh, built with
#: flash_attention_bwd.cu): its products in one TF32 pass (hi.hi) where the
#: form takes three; the whole backward against float64 must then exceed
#: FLASH_BWD_F64_LIMIT
FLASH_TF32_FAULTS = {"one_pass_tf32": [(
    "  mma(d, a.lo, bh0, bh1);\n  mma(d, a.hi, bl0, bl1);\n", "")]}
#: the f32 forward's distance from float64 in its FMA form (PERF.md row 2,
#: "Yardsticks against float64"): the 3xTF32 form stays within
#: FLASH_FWD_F64_SLACK times it
FLASH_FWD_F64_FMA = 3.25e-7
FLASH_FWD_F64_SLACK = 2.0
#: the f32 forward's planted faults (built with flash_attention.cu): one
#: TF32 pass (FLASH_TF32_FAULTS' line in tf32x3.cuh), which must land above
#: FLASH_FWD_ONE_PASS_FLOOR, and O's slices chained into one accumulator;
#: each must exceed the forward's float64 limit
FLASH_TF32_FWD_FAULTS = {
    "one_pass_tf32": FLASH_TF32_FAULTS["one_pass_tf32"],
    "o_chained": [(
        "        mma3_add(acc[dn], pa, sv[bi], sv[bi + LD]);  // O's slice "
        "apart\n",
        "        mma3(acc[dn], pa, sv[bi], sv[bi + LD]);  // planted\n")]}
FLASH_FWD_ONE_PASS_FLOOR = 1e-4


def flash_f32_fault_builds() -> dict:
    """Start the builds of the f32 flash kernels' planted faults:
    {"bwd": FLASH_TF32_FAULTS', "fwd": FLASH_TF32_FWD_FAULTS'}, each
    {fault: (the process, the library's path)}."""
    return {"bwd": source_fault_builds("flash_attention_bwd",
                                       FLASH_TF32_FAULTS),
            "fwd": source_fault_builds("flash_attention",
                                       FLASH_TF32_FWD_FAULTS)}


def check_flash_backward(dev, timer, builds=None) -> tuple[list, dict]:
    """The f32 flash kernels at the LM training shape [16, 1024, 12, 64]
    causal and at an odd T=333, on the in-place route (q, k, v, dO read
    where they lie in [B, T, H, D]).  The forward, and the dQ and dK/dV
    kernels (3xTF32 on the tensor cores), each against its plain twin on
    the padded problem fed the same lse and delta (max abs error <= TOL,
    relative to the largest entry where that is above 1).  Against
    float64 exact attention on the card: the forward's o (relative norm
    <= FLASH_FWD_F64_SLACK x FLASH_FWD_F64_FMA, with its planted faults
    FLASH_TF32_FWD_FAULTS above that limit and the one-pass one above
    FLASH_FWD_ONE_PASS_FLOOR), and the whole backward through the autograd
    Function (<= FLASH_BWD_F64_LIMIT and FLASH_BWD_F64_SLACK x
    FLASH_BWD_F64_FMA), with a backward that drops delta (on both delta
    routes) and one whose products take a single TF32 pass
    (FLASH_TF32_FAULTS) as the planted faults that must exceed the limit
    (``builds``: :func:`flash_f32_fault_builds`, started by :func:`main`
    beside the kernels' build).
    Times at the training shape: the forward, each backward kernel (with
    the L2 flushed, alone from a trace, and the host's ms a call), the
    whole backward (delta + both kernels), the plain twins and
    ``scaled_dot_product_attention`` forward (memory-efficient) and
    backward (a yardstick only; the kernels it ran are named, and its math
    backend, plain f32 products with TF32 off, is timed beside it).  The
    bounds are the lesser of f32 FMA and 3xTF32 (:func:`bound_3xtf32`)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    builds = builds or flash_f32_fault_builds()
    tf32_builds, fwd_builds = builds["bwd"], builds["fwd"]
    gen = torch.Generator(device=dev).manual_seed(6)
    h, d = 12, 64
    scale = d ** -0.5
    fwd_limit = FLASH_FWD_F64_SLACK * FLASH_FWD_F64_FMA
    summary = {"phase": "flash_backward", "tol": TOL,
               "f64_limit": FLASH_BWD_F64_LIMIT,
               "f64_vs_fma_form_limit": FLASH_BWD_F64_SLACK
               * FLASH_BWD_F64_FMA, "forward_f64_limit": fwd_limit}
    # name, in-place call on (q, k, v, lse, dO, delta), plain twin on the
    # padded problem, products of the function it computes (dQ: S, dP,
    # dQ; dK/dV: S, dP, dV, dK), outputs of [B, T, H, D], the kernel's
    # name in a trace
    kernels = (("flash_attention_bwd_dq", FA._bwd_dq_bthd,
                FA._bwd_dq_plain, 3, 1, "flash_bwd_dq_tf32x3"),
               ("flash_attention_bwd_dkv", FA._bwd_dkv_bthd,
                FA._bwd_dkv_plain, 4, 2, "flash_bwd_dkv_tf32x3"))
    forms = (FA.KERNEL_BWD_DQ, FA.KERNEL_BWD_DKV)
    real = [k._fn or k._resolve() for k in forms]
    one_pass = planted_all(*tf32_builds["one_pass_tf32"], forms)
    fwd_real = FA.KERNEL._fn or FA.KERNEL._resolve()
    fwd_faults = {name: planted(proc, lib, FA.KERNEL)
                  for name, (proc, lib) in fwd_builds.items()}
    err = {name: 0.0 for name, *_ in kernels}
    fwd_err = 0.0
    rows = []
    plain_delta = FA._delta, FA._delta_bthd
    for b, t in ((16, 1024), (16, 333)):
        q, k, v, g = (torch.randn(b, t, h, d, generator=gen, device=dev)
                      for _ in range(4))
        fwd = lambda: FA._fwd_bthd(q, k, v, True, scale)  # noqa: E731
        o, lse = fwd()
        qp, kp, vp = FA._prep(q, k, v)
        dop = FA._to_bh(g)
        o_ref, lse_ref = FA._fwd_plain(qp, kp, vp, t, True, scale)
        fwd_err = max(fwd_err,
                      (o - FA._from_bh(o_ref, b, h, t, d)).abs().max().item(),
                      (lse - lse_ref).abs().max().item())
        del o_ref, lse_ref
        delta = FA._delta_bthd(g, o, lse.shape[1])
        args = (q, k, v, lse, g, delta, True, scale)
        plain_args = (qp, kp, vp, lse, dop, delta.view(b * h, -1, 1), t,
                      True, scale)
        for name, kern, plain, *_ in kernels:
            got, want = kern(*args), plain(*plain_args)
            for x, y in zip(*((r,) if torch.is_tensor(r) else r
                              for r in (got, want))):
                y = FA._from_bh(y, b, h, t, d)
                e = (x - y).abs().max().item()
                err[name] = max(err[name], e)
                if not e <= TOL * max(1.0, y.abs().max().item()):
                    raise AssertionError(f"flash bwd {name} [{b},{t},{h},"
                                         f"{d}]: kernel vs plain {e}")
        # the forward and the whole backward, as training reaches them,
        # against float64
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        wide = [x.double().requires_grad_() for x in (q, k, v)]
        o64 = FA.flash_attention_reference(*wide, causal=True)
        want = torch.autograd.grad(o64, wide, g.double())
        forward = {"f32": rel_norm(o, o64)}
        for name, fn in fwd_faults.items():
            FA.KERNEL._fn = fn
            try:
                forward[f"{name}_control"] = rel_norm(fwd()[0], o64)
            finally:
                FA.KERNEL._fn = fwd_real
        summary[f"forward_vs_f64_T{t}"] = forward
        if not (forward["f32"] <= fwd_limit
                and all(forward[f"{n}_control"] > fwd_limit
                        for n in fwd_faults)
                and forward["one_pass_tf32_control"]
                > FLASH_FWD_ONE_PASS_FLOOR):
            raise AssertionError(f"flash forward vs f64: {forward}")
        readings = {}
        for label in ("f32", "delta_dropped_control",
                      "one_pass_tf32_control"):
            if label == "delta_dropped_control":
                FA._delta = lambda do, o: torch.zeros_like(
                    plain_delta[0](do, o))
                FA._delta_bthd = lambda do, o, tqp: torch.zeros_like(
                    plain_delta[1](do, o, tqp))
            elif label == "one_pass_tf32_control":
                for kern, fn in zip(forms, one_pass):
                    kern._fn = fn
            try:
                got = torch.autograd.grad(FA.flash_attention(
                    *leaves, causal=True), leaves, g)
            finally:
                FA._delta, FA._delta_bthd = plain_delta
                for kern, fn in zip(forms, real):
                    kern._fn = fn
            readings[label] = max(rel_norm(x, y) for x, y in zip(got, want))
        summary[f"vs_f64_T{t}"] = readings
        if not (readings["f32"] <= min(FLASH_BWD_F64_LIMIT,
                                       FLASH_BWD_F64_SLACK
                                       * FLASH_BWD_F64_FMA)
                and FLASH_BWD_F64_LIMIT < min(
                    readings["delta_dropped_control"],
                    readings["one_pass_tf32_control"])):
            raise AssertionError(f"flash backward vs f64: {summary}")
        # the yardsticks against the same float64 run: SDPA's f32
        # memory-efficient backend, forward and backward, beside rows 2
        # and 3 f32 (does the yardstick compute the same function?)
        qh, kh, vh = (x.detach().transpose(1, 2).contiguous()
                      .requires_grad_() for x in (q, k, v))
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            oh = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
        sdpa_g = torch.autograd.grad(oh, (qh, kh, vh),
                                     g.transpose(1, 2).contiguous())
        summary[f"yardsticks_vs_f64_T{t}"] = {
            "rows_2_3_f32": {"forward": forward["f32"],
                             "backward": readings["f32"]},
            "sdpa_efficient_f32": {
                "forward": rel_norm(oh.detach().transpose(1, 2),
                                    o64.detach()),
                "backward": max(rel_norm(x.transpose(1, 2), y)
                                for x, y in zip(sdpa_g, want))}}
        del wide, want, leaves, o64, qh, kh, vh, oh, sdpa_g
        if t != 1024:
            continue
        pairs_n = b * h * t * (t + 1) // 2     # causal (query, key) pairs
        act = 4.0 * b * t * h * d              # one [B, T, H, D] f32 tensor
        rowvec = 4.0 * b * h * t               # lse or delta
        qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        # the forward as training runs it: q.k and p.v over the causal
        # pairs against q, k, v in and o, lse out
        nbytes, flops = 4 * act + rowvec, 4.0 * pairs_n * d
        bound_ms, by = bound_3xtf32(nbytes, flops)
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qh, kh, vh, is_causal=True)
            library_fwd, library_fwd_alone = timer(sdpa), call_alone_ms(sdpa)
        rows.append({
            "name": "flash_attention_fwd_tf32x3_lm_train", "route": "cuda",
            "source": "paddle_tpu_torch/ops/kernels/csrc/flash_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/flash_attention.py:277",
            "shape": [b, t, h, d], "ms": timer(fwd),
            "alone_ms": device_ms([fwd], "flash_fwd_tf32x3_kernel"),
            "host_ms": host_ms(fwd),
            "plain_ms": timer(lambda: FA._fwd_plain(qp, kp, vp, t, True,
                                                    scale)),
            "bound_ms": bound_ms, "bound_by": by,
            "fma_bound_ms": bound(nbytes, flops)[0],
            "library_ms": library_fwd,
            "library_alone_ms": library_fwd_alone})
        for name, kern, plain, products, outs, key in kernels:
            # reads q, k, v, dO, lse, delta; writes the outputs
            nbytes = act * (4 + outs) + 2 * rowvec
            flops = 2.0 * products * pairs_n * d
            bound_ms, by = bound_3xtf32(nbytes, flops)
            call = lambda kern=kern: kern(*args)          # noqa: E731
            rows.append({
                "name": name, "route": "cuda",
                "source": "paddle_tpu_torch/ops/kernels/csrc/"
                          "flash_attention_bwd.cu",
                "replaces": "paddle_tpu/ops/pallas/flash_attention.py:331",
                "shape": [b, t, h, d],
                "ms": timer(call), "alone_ms": device_ms([call], key),
                "host_ms": host_ms(call),
                "plain_ms": timer(lambda plain=plain: plain(*plain_args)),
                "bound_ms": bound_ms, "bound_by": by,
                "fma_bound_ms": bound(nbytes, flops)[0],
                # no PyTorch call computes dQ (or dK, dV) alone
                "library_ms": None, "max_abs_err": err[name]})
        # the whole function: five products over the causal pairs against
        # q, k, v, o, dO in and dq, dk, dv out
        bound_ms, by = bound_3xtf32(8 * act + rowvec, 10.0 * pairs_n * d)
        out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
        gh = g.transpose(1, 2).contiguous()
        with sdpa_kernel(SDPBackend.MATH):
            out_math = F.scaled_dot_product_attention(qh, kh, vh,
                                                      is_causal=True)

        def library_step():
            F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
            torch.autograd.grad(out, (qh, kh, vh), gh, retain_graph=True)

        # which backend SDPA picks for f32 (its kernels decide whether it
        # uses the tensor cores, as the flash kernels do)
        summary["library_kernels"] = [
            k["name"] for k in profile_window(library_step, 1).get(
                "top_kernels", [])]
        op = FA._to_bh(o)
        whole = lambda: FA._bwd_bthd(q, k, v, o, lse, g, True,  # noqa: E731
                                     scale)
        summary["whole_backward"] = {
            "shape": [b, t, h, d], "gflop": 10.0 * pairs_n * d / 1e9,
            "gbytes": (8 * act + rowvec) / 1e9,
            "ms": timer(whole),
            "kernels_alone_ms": device_passes_ms(
                [whole], [key for *_, key in kernels])["total"],
            "host_ms": host_ms(whole),
            "plain_ms": timer(lambda: FA._bwd_plain(qp, kp, vp, op, lse, dop,
                                                    t, True, scale)),
            "library_ms": timer(lambda: torch.autograd.grad(
                out, (qh, kh, vh), gh, retain_graph=True)),
            "library_math_ms": timer(lambda: torch.autograd.grad(
                out_math, (qh, kh, vh), gh, retain_graph=True)),
            "bound_ms": bound_ms, "bound_by": by}
        del qh, kh, vh, out, out_math, op
    if not fwd_err <= TOL:
        raise AssertionError(f"flash forward at the training shapes: kernel "
                             f"vs plain max abs err {fwd_err}")
    err["flash_attention_fwd_tf32x3_lm_train"] = fwd_err
    for row in rows:       # the worst over both shapes
        row["max_abs_err"] = err[row["name"]]
    summary["max_abs_err"] = err
    torch.cuda.synchronize()
    return rows, summary


def paged_inputs(dev, b=32, h=12, d=64, ps=16, maxp=36):
    """The decode attention problem at serving's shape, f32 and seeded: q
    [B, H, D], pools [H, 1 + B * maxp, ps, D] with scattered page ids, the
    table and the ragged lengths (0, 1, 16, 17, the full 576 and random
    ones).  Returns (q, k_pages, v_pages, page_table, seq_lens, lens)."""
    rng = np.random.default_rng(2)
    lens = np.concatenate([[0, 1, 16, 17, maxp * ps],
                           rng.integers(1, maxp * ps + 1, size=b - 5)])
    num_pages = 1 + b * maxp
    table = np.zeros((b, maxp), np.int32)
    ids = rng.permutation(np.arange(1, num_pages))
    nxt = 0
    for i, n in enumerate(lens):
        need = -(-int(n) // ps)
        table[i, :need] = ids[nxt:nxt + need]
        nxt += need
    gen = torch.Generator(device=dev).manual_seed(2)
    kp, vp = (torch.randn(h, num_pages, ps, d, generator=gen, device=dev)
              for _ in range(2))
    q = torch.randn(b, h, d, generator=gen, device=dev)
    return (q, kp, vp, torch.from_numpy(table).to(dev),
            torch.from_numpy(lens.astype(np.int32)).to(dev), lens)


#: the f32 paged kernel's planted faults (csrc/paged_attention.cu): the
#: combine drops chunk 1's correction exp(m_c - m), and the ticket is left
#: where the last chunk drew it (caught on the second launch)
PAGED_F32_FAULTS = {
    "correction_dropped": [(
        "    const float w = expf(__ldcg(pc) - mx);  // chunk cc's correction",
        "    const float w = cc == 1 ? 1.f : expf(__ldcg(pc) - mx);")],
    "ticket_kept": [(
        "  if (tid == 0) tickets[bh] = 0;  // ready for the next launch",
        "  // planted: the ticket is not reset")]}


def check_paged(dev, timer, builds=None) -> dict:
    """Row 1 f32 at serving's shape: the split kernel against its twin
    (max abs error <= TOL) on two launches with other queries (the second
    finds the tickets the first reset), idle rows exact zeros, a rerun the
    same bits; the planted faults (``PAGED_F32_FAULTS``, each built from a
    copy of the source; ``builds``, where :func:`main` started them
    beside the kernels' build) on those two launches: a dropped
    correction must exceed TOL on the first, a kept ticket pass the
    first and exceed TOL on the second.  Its times (:func:`paged_times`)
    and the host's ms a call."""
    from paddle_tpu_torch.ops.kernels import _kept
    from paddle_tpu_torch.ops.kernels import paged_attention as PA

    builds = builds or source_fault_builds("paged_attention",
                                           PAGED_F32_FAULTS)
    q, kp, vp, pt, sl, lens = paged_inputs(dev)
    b, h, d = q.shape
    ps, maxp = kp.shape[2], pt.shape[1]
    queries = (q, torch.flip(q, dims=(2,)))
    refs = [PA.ragged_paged_attention_reference(x, kp, vp, pt, sl)
            for x in queries]

    def errors():
        """(the two launches' outputs, each one's max abs error)"""
        outs = [PA.ragged_paged_attention(x, kp, vp, pt, sl) for x in queries]
        torch.cuda.synchronize()
        return outs, [(o - r).abs().max().item() for o, r in zip(outs, refs)]

    outs, errs = errors()
    err = max(errs)
    if not err <= TOL:
        raise AssertionError(f"paged kernel vs plain: max abs err {errs}")
    idle = sl == 0
    if not torch.equal(outs[0][idle], torch.zeros_like(outs[0][idle])):
        raise AssertionError("paged kernel: idle rows are not exactly 0")
    again, _ = errors()
    if not all(torch.equal(x, y) for x, y in zip(outs, again)):
        raise AssertionError("paged kernel: a rerun is not bit-identical")
    real = PA.KERNEL._fn or PA.KERNEL._resolve()
    faults = {}
    for name, (proc, lib) in builds.items():
        PA.KERNEL._fn = planted(proc, lib, PA.KERNEL)
        _kept.forget()
        try:
            faults[name] = errors()[1]
        finally:
            PA.KERNEL._fn = real
            _kept.forget()
    # a dropped correction shows on the first launch; a kept ticket only
    # on the second, which finds the first's tickets
    if not (faults["correction_dropped"][0] > TOL
            and faults["ticket_kept"][0] <= TOL < faults["ticket_kept"][1]):
        raise AssertionError(f"paged planted faults (each launch's error): "
                             f"{faults}")
    fn = lambda: PA.ragged_paged_attention(q, kp, vp, pt, sl)  # noqa: E731
    return {"name": "ragged_paged_attention_split", "route": "cuda",
            "source": "paddle_tpu_torch/ops/kernels/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/paged_attention.py:274",
            "shape": [b, h, d, ps, maxp], "max_abs_err": err,
            "rerun_bit_identical": True, "planted_faults": faults,
            "pages_a_chunk": PA.pages_per_chunk(ps),
            "splits": PA.splits(maxp, ps), "host_ms": host_ms(fn),
            **paged_times(q, kp, vp, pt, sl, lens, timer,
                          "paged_split_kernel")}


def paged_times(q, kp, vp, pt, sl, lens, timer, alone_key=None) -> dict:
    """The paged wrapper's times on these inputs: with the L2 flushed,
    alone (a trace; where ``alone_key`` names the kernel, or a tuple of
    kernels, summed), its twin's,
    ``scaled_dot_product_attention`` over the gathered dense K/V in the
    same dtype (the library yardstick), and the bound: each resident K/V
    element, q, out, the table and the lengths moved once at the dtype's
    size, and 4 flops per resident element at the dtype's rate."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import paged_attention as PA

    b, h, d = q.shape
    ps, maxp = kp.shape[2], pt.shape[1]
    fn = lambda: PA.ragged_paged_attention(q, kp, vp, pt, sl)  # noqa: E731
    kd = kp[:, pt.long()].transpose(0, 1).reshape(b, h, maxp * ps, d)
    vd = vp[:, pt.long()].transpose(0, 1).reshape(b, h, maxp * ps, d)
    mask = (torch.arange(maxp * ps, device=q.device)[None, :]
            < sl[:, None])[:, None, None, :]
    resident = float(lens.sum())
    size = q.element_size()
    nbytes = size * (2 * resident * h * d + 2 * b * h * d) + 4.0 * (
        b * maxp + b)
    bound_ms, by = bound(nbytes, 4.0 * resident * h * d,
                         F32_FLOPS_PER_S if size == 4 else BF16_FLOPS_PER_S)
    out = {"resident_tokens": int(resident), "ms": timer(fn),
           "plain_ms": timer(lambda: PA.ragged_paged_attention_reference(
               q, kp, vp, pt, sl)),
           "bound_ms": bound_ms, "bound_by": by,
           "library_ms": timer(lambda: F.scaled_dot_product_attention(
               q[:, :, None, :], kd, vd, attn_mask=mask))}
    if alone_key:
        keys = (alone_key,) if isinstance(alone_key, str) else alone_key
        passes = device_passes_ms([fn], keys)
        out["alone_ms"] = passes["total"]
        if len(keys) > 1:
            out["alone_passes_ms"] = passes
        out["library_alone_ms"] = call_alone_ms(
            lambda: F.scaled_dot_product_attention(q[:, :, None, :], kd, vd,
                                                   attn_mask=mask))
    return out



#: (source, the TPU kernel it replaces, the name of the tile's kernel in a
#: trace) by row name; a trace of one case holds one tile kernel
TILE_KERNELS = {
    "brgemm": ("paddle_tpu_torch/ops/kernels/csrc/brgemm.cu",
               "paddle_tpu/ops/pallas/tpp/brgemm.py:155", "gemm_kernel<"),
    "conv2d_direct": ("paddle_tpu_torch/ops/kernels/csrc/conv2d_direct.cu",
                      "paddle_tpu/ops/pallas/tpp/conv.py:240",
                      "gemm_kernel<"),
    "brgemm_bf16": ("paddle_tpu_torch/ops/kernels/csrc/brgemm.cu",
                    "paddle_tpu/ops/pallas/tpp/brgemm.py:155",
                    "::mma_kernel<"),
    "conv2d_direct_bf16": (
        "paddle_tpu_torch/ops/kernels/csrc/conv2d_direct.cu",
        "paddle_tpu/ops/pallas/tpp/conv.py:240", "::mma_kernel<"),
    # the Hopper tile (csrc/gemm_wgmma.cuh): every bf16 shape whose
    # copies can be 16 bytes wide
    "brgemm_wgmma": ("paddle_tpu_torch/ops/kernels/csrc/brgemm.cu",
                     "paddle_tpu/ops/pallas/tpp/brgemm.py:155",
                     "wgmma_kernel<"),
    "conv2d_direct_wgmma": (
        "paddle_tpu_torch/ops/kernels/csrc/conv2d_direct.cu",
        "paddle_tpu/ops/pallas/tpp/conv.py:240", "wgmma_kernel<"),
}


def tile_name(entry: str, plan, dtype) -> str:
    """The kernel a plan launches: ``entry`` (``brgemm``,
    ``conv2d_direct``) in f32, or its bf16 form by tile."""
    if dtype == torch.float32:
        return entry
    return entry + ("_wgmma" if plan.wgmma else "_bf16")

#: ResNet-50's distinct 1x1 convs at batch 64 (``models/image.py``
#: ``_mid_projection`` and ``_bottleneck``): (label, x [N, H, W, Cin],
#: Cout, stride).  From res3 on, the first block's branch2a and branch1
#: take stride 2; res2_1's branch1 (64 -> 256) is res2_2c's shape.
RESNET_1X1 = (
    ("res2_1_branch2a", (64, 56, 56, 64), 64, 1),
    ("res2_2a", (64, 56, 56, 256), 64, 1),
    ("res2_2c", (64, 56, 56, 64), 256, 1),
    ("res3_1_branch2a_s2", (64, 56, 56, 256), 128, 2),
    ("res3_1_branch1_s2", (64, 56, 56, 256), 512, 2),
    ("res3_2a", (64, 28, 28, 512), 128, 1),
    ("res3_2c", (64, 28, 28, 128), 512, 1),
    ("res4_1_branch2a_s2", (64, 28, 28, 512), 256, 2),
    ("res4_1_branch1_s2", (64, 28, 28, 512), 1024, 2),
    ("res4_2a", (64, 14, 14, 1024), 256, 1),
    ("res4_2c", (64, 14, 14, 256), 1024, 1),
    ("res5_1_branch2a_s2", (64, 14, 14, 1024), 512, 2),
    ("res5_1_branch1_s2", (64, 14, 14, 1024), 2048, 2),
    ("res5_2a", (64, 7, 7, 2048), 512, 1),
    ("res5_2c", (64, 7, 7, 512), 2048, 1),
)

#: every distinct direct conv of the ResNet-50 path at batch 64 (the
#: stem and the four stages' 3x3s), AlexNet's conv1 and conv2 at batch 64
#: and small_vgg's 3x3 at its widest and narrowest spatial size at its
#: batch of 128: (label, x [N, H, W, Cin], (k, Cout, s, p), epilogue)
DIRECT_SHAPES = (
    ("stem_7x7", (64, 224, 224, 3), (7, 64, 2, 3), "stats"),
    ("res2_3x3", (64, 56, 56, 64), (3, 64, 1, 1), "stats"),
    ("res2_3x3", (64, 56, 56, 64), (3, 64, 1, 1), "affine_relu"),
    ("res3_3x3", (64, 28, 28, 128), (3, 128, 1, 1), "stats"),
    ("res4_3x3", (64, 14, 14, 256), (3, 256, 1, 1), "stats"),
    ("res5_3x3", (64, 7, 7, 512), (3, 512, 1, 1), "stats"),
    ("alexnet_conv1", (64, 227, 227, 3), (11, 96, 4, 1), "none"),
    ("alexnet_conv2", (64, 27, 27, 96), (5, 256, 1, 2), "none"),
    ("small_vgg_widest", (128, 32, 32, 64), (3, 64, 1, 1), "stats"),
    ("small_vgg_narrowest", (128, 4, 4, 512), (3, 512, 1, 1), "stats"),
)

def plan_dict(p, dtype=torch.float32) -> dict:
    staged = "4-byte" if dtype == torch.float32 else "register-staged"
    tile = ("f32 SIMT" if dtype == torch.float32 else
            "wgmma" if p.wgmma else "mma.sync")
    return {"tile": tile, "block_m": p.block_m, "block_n": p.block_n,
            "form": "16-byte" if p.vec else staged, "splits": p.splits}


def moments_err(got, want, count) -> float:
    """Max abs error of y, then of (sum, sumsq) as the moments they feed
    (divided by the ``count`` of rows)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = (a / count, b / count) if i else (a, b.reshape(a.shape))
        err = max(err, (a - b).abs().max().item())
    return err


def tile_row(name, case, timer) -> dict:
    """One shape of a shared GEMM tile (rows 14 and 15, f32 or bf16), a
    case of :func:`brgemm_cases` or :func:`conv_cases`: the kernel against
    its twin and a rerun in the same bits, then its times: CUDA-event
    means with the L2 flushed (kernel, twin, library call), the bound,
    and from a trace the device time of each kernel the call launches: the
    tile, the split's second pass (``split_reduce``) and the stats
    reduction (``stats_reduce``); ``alone_ms`` is their sum; ``host_ms``
    the host's median wall ms of a call without a sync (the wrapper's
    host path).  f32: max abs error <= TOL against the twin.  bf16: y
    against the twin's one rounding of an f64 sum (``bf16_agrees``), the
    stats within TOL as the moments they feed, and the planted fault
    where the case has one: a product whose accumulator is rounded to
    bf16 after every 16-deep slice must fail ``bf16_agrees``."""
    source, replaces, key = TILE_KERNELS[name]
    fn, plain_fn, plan = case["fn"], case["plain_fn"], case["plan"]
    got, again = fn(), fn()
    pairs = zip(got, again) if isinstance(got, tuple) else [(got, again)]
    rerun_same = all(torch.equal(a, b) for a, b in pairs)
    bf16 = case["dtype"] == torch.bfloat16
    extra = {}
    if bf16:
        want, mag, kred = case["wide_fn"](), case["mag_fn"](), case["kred"]
        y, w = (got[0], want[0]) if isinstance(got, tuple) else (got, want)
        w = w.reshape(y.shape).to(torch.bfloat16)
        extra["vs_f64_once_rounded"] = bf16_agreement(y, w, mag, kred)
        ok = bf16_agrees(y, w, mag, kred)
        err = extra["vs_f64_once_rounded"]["max_abs_err"]
        if isinstance(got, tuple):
            extra["stats_err"] = moments_err(
                (w.double(),) + got[1:], (w.double(),) + want[1:],
                case["count"])
            ok = ok and extra["stats_err"] <= TOL
        if "fault_fn" in case:
            fault = case["fault_fn"]().reshape(w.shape)
            extra["planted_fault"] = bf16_agreement(fault, w, mag, kred)
            ok = ok and not bf16_agrees(fault, w, mag, kred)
            del fault
        del want, mag, y, w
    else:
        err = moments_err(got, plain_fn(), case["count"])
        ok = err <= TOL
    if not (ok and rerun_same):
        raise AssertionError(f"{name} {case['label']} {case['mode']}: kernel "
                             f"vs plain {err} {extra}, or a rerun differs "
                             f"({not rerun_same})")
    del got, again
    bound_ms, by = bound(case["nbytes"], case["flops"],
                         BF16_FLOPS_PER_S if bf16 else F32_FLOPS_PER_S)
    ms = timer(fn)
    host = host_ms(fn)
    parts = {"tile_alone_ms": device_ms([fn], key)}
    if plan.splits > 1:
        parts["split_reduce_alone_ms"] = device_ms([fn], "split_reduce")
    if case["mode"] == "stats":
        parts["stats_reduce_alone_ms"] = device_ms([fn], "stats_reduce")
    alone = sum(parts.values())
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces,
           "shape": {case["label"]: case["shape"], "epilogue": case["mode"]},
           "plan": plan_dict(plan, case["dtype"]), **extra,
           "max_abs_err": err, "ms": ms, "host_ms": host,
           "alone_ms": alone, **parts, "plain_ms": timer(plain_fn),
           "bound_ms": bound_ms, "bound_by": by,
           "library_ms": timer(case["library_fn"]),
           "bound_share": bound_ms / ms, "bound_share_alone": bound_ms / alone}
    row["vs_library"] = ms / row["library_ms"]
    return row


def brgemm_cases(dev, dtype=torch.float32):
    """Row 15's shapes, one at a time: every distinct 1x1 conv of
    ResNet-50 at batch 64 with the stats epilogue of training (and res2_2c
    also with the affine + ReLU epilogue of ``test``), the stride-1 convs
    beside ``torch.matmul`` on the pixel rows, the stride-2 projections (a
    strided row map) beside channels_last ``F.conv2d``, all in ``dtype``
    (f32, or bf16 with f32 scale and shift).  Each case holds the
    kernel's call ``fn``, its twin ``plain_fn``, the library call, the
    rows ``count``, the bytes and flops of the bound, the plan and the
    reduction's length ``kred``; in bf16 also ``wide_fn`` (the twin on
    float64 operands), ``mag_fn`` (each output's sum of |products|, times
    |scale| in the affine epilogue: the scale of its f32 sum's error) and,
    at res2_2c with stats, the planted fault ``fault_fn``."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import brgemm as BR

    gen = torch.Generator(device=dev).manual_seed(3)
    sms = BR.sm_count(dev)
    size = torch.empty((), dtype=dtype).element_size()
    cases = []
    for label, x, cout, s in RESNET_1X1:
        cases.append((label, x, cout, s, "stats"))
        if label == "res2_2c":       # and the eval epilogue of ``test``
            cases.append((label, x, cout, s, "affine_relu"))
    for label, (n, h, w, cin), cout, s, mode in cases:
        x = torch.randn(n, h, w, cin, generator=gen, device=dev).to(dtype)
        wt = (torch.randn(1, 1, cin, cout, generator=gen, device=dev) * (
            2.0 / cin) ** 0.5).to(dtype)      # msra scale, as initialized
        if mode == "stats":
            kw = dict(stats=True)
        else:
            kw = dict(scale=1 + 0.1 * torch.randn(cout, generator=gen,
                                                  device=dev),
                      shift=0.1 * torch.randn(cout, generator=gen,
                                              device=dev), act="relu")
        oh, ow = (h - 1) // s + 1, (w - 1) // s + 1
        m = n * oh * ow
        a = x[:, ::s, ::s].reshape(1, m, cin)     # a copy when s = 2
        b = wt.reshape(1, cin, cout)
        if s == 1:
            library = lambda: torch.matmul(a[0], b[0])  # noqa: E731
        else:
            xl = x.permute(0, 3, 1, 2)
            wl = wt.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            library = lambda: F.conv2d(xl, wl, None, s, 0)  # noqa: E731

        def fn():
            out = BR.conv1x1(x, wt, (s, s), **kw)
            if isinstance(out, tuple):
                return (out[0].reshape(m, cout), *out[1:])
            return out.reshape(m, cout)

        def plain():
            return BR.brgemm_reference(a, b, **kw)

        # the strided projection reads every s-th pixel row by index; the
        # rows it reads are the bytes it must move
        case = {"label": label, "shape": [n, h, w, cin, 1, cout, s, 0],
                "mode": mode, "fn": fn, "plain_fn": plain,
                "library_fn": library, "count": m, "dtype": dtype,
                "nbytes": size * (m * cin + cin * cout + m * cout)
                + 4.0 * 2 * cout,
                "flops": 2.0 * m * cin * cout, "kred": cin,
                "plan": BR.plan(m, cout, cin, cin,
                                (x.data_ptr(), wt.data_ptr()), sms,
                                BR.FORMS[dtype])}
        if dtype == torch.bfloat16:
            case["wide_fn"] = lambda: BR.brgemm_reference(
                a.double(), b.double(), **kw)
            case["mag_fn"] = lambda: BR.brgemm_reference(
                a.double().abs(), b.double().abs()) * (
                    kw["scale"].double().abs() if "scale" in kw else 1.0)
            if (label, mode) == ("res2_2c", "stats"):
                case["fault_fn"] = lambda: slice_rounded_product(a[0], b[0])
        yield case
        del x, a, library, fn, plain, case


def check_brgemm(dev, timer, dtype=torch.float32) -> list:
    """Row 15 in ``dtype`` at every case of :func:`brgemm_cases`
    (:func:`tile_row`)."""
    rows = [tile_row(tile_name("brgemm", case["plan"], dtype), case, timer)
            for case in brgemm_cases(dev, dtype)]
    torch.cuda.synchronize()
    return rows


def in_range_taps(size: int, k: int, s: int, p: int) -> int:
    """Taps of a k-wide window (stride s, padding p) that fall inside an
    axis of ``size``, summed over the output positions: the multiply-adds
    a convolution needs along that axis; a tap on the zero padding needs
    none."""
    out = (size + 2 * p - k) // s + 1
    return sum(min(o * s - p + k, size) - max(o * s - p, 0)
               for o in range(out))


def library_kernels(fn, rounds: int = 20) -> list:
    """The device kernels one call of ``fn`` launches, by name, with each
    one's device time a call, from a ``torch.profiler`` trace of
    ``rounds`` calls (the first few records of a trace may be lost; an
    empty trace is taken again, ``cuda_records``)."""
    return sorted(({"name": e.key[:160], "launches": e.count,
                    "ms_per_call": e.self_device_time_total / 1e3 / rounds}
                   for e in cuda_records(fn, rounds)
                   if e.self_device_time_total),
                  key=lambda r: -r["ms_per_call"])


def conv_cases(dev, dtype=torch.float32):
    """Row 14's shapes, one at a time: every shape of ``DIRECT_SHAPES`` in
    ``dtype`` beside channels_last ``F.conv2d`` (TF32 off); the bound
    counts only the taps inside the image.  Each case as in
    :func:`brgemm_cases`; the bf16 stem carries the planted fault (on its
    patch matrix, (cin, kh, kw) order)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import nn as nn_ops
    from paddle_tpu_torch.ops.kernels import brgemm as BR
    from paddle_tpu_torch.ops.kernels import conv as CV

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    if any(tf32):
        raise AssertionError(f"TF32 is on (cuDNN, cuBLAS): {tf32}")
    gen = torch.Generator(device=dev).manual_seed(4)
    sms = BR.sm_count(dev)
    size = torch.empty((), dtype=dtype).element_size()
    for label, (n, h, w, cin), (k, cout, s, p), mode in DIRECT_SHAPES:
        x = torch.randn(n, h, w, cin, generator=gen, device=dev).to(dtype)
        wt = (torch.randn(k, k, cin, cout, generator=gen, device=dev) * (
            2.0 / (k * k * cin)) ** 0.5).to(dtype)
        kw = {"stats": dict(stats=True), "none": {}}.get(mode)
        if kw is None:
            kw = dict(scale=1 + 0.1 * torch.randn(cout, generator=gen,
                                                  device=dev),
                      shift=0.1 * torch.randn(cout, generator=gen,
                                              device=dev), act="relu")
        m = n * nn_ops.conv_out(h, k, s, p) * nn_ops.conv_out(w, k, s, p)
        xl = x.permute(0, 3, 1, 2)               # channels_last NCHW view
        wl = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        macs = (n * in_range_taps(h, k, s, p) * in_range_taps(w, k, s, p)
                * cin * cout)

        def fn():
            return CV.fwd_raw(x, wt, (s, s), (p, p), **kw)

        def plain():
            return CV.fwd_raw_reference(x, wt, (s, s), (p, p), **kw)

        def library():
            return F.conv2d(xl, wl, None, s, p)

        case = {"label": label, "shape": [n, h, w, cin, k, cout, s, p],
                "mode": mode, "fn": fn, "plain_fn": plain,
                "library_fn": library, "count": m, "dtype": dtype,
                # x, w, y, and (sum, sumsq) out or (scale, shift) in
                "nbytes": size * (x.numel() + wt.numel() + m * cout)
                + 4.0 * (0 if mode == "none" else 2 * cout),
                "flops": 2.0 * macs, "kred": k * k * cin,
                "plan": CV.direct_plan(x, wt, m, sms)}
        if dtype == torch.bfloat16:
            case["wide_fn"] = lambda: CV.fwd_raw_reference(
                x.double(), wt.double(), (s, s), (p, p), **kw)
            case["mag_fn"] = lambda: CV.fwd_raw_reference(
                x.double().abs(), wt.double().abs(), (s, s), (p, p)) * (
                    kw["scale"].double().abs() if "scale" in kw else 1.0)
            if label == "stem_7x7":
                case["fault_fn"] = lambda: slice_rounded_product(
                    F.unfold(xl, k, padding=p, stride=s).transpose(1, 2)
                    .reshape(m, -1), wt.permute(2, 0, 1, 3).reshape(-1, cout))
        yield case
        del x, xl, fn, plain, library, case


def check_conv(dev, timer, dtype=torch.float32) -> tuple[list, dict]:
    """Row 14 in ``dtype`` at every case of :func:`conv_cases`
    (:func:`tile_row`), and the kernels cuDNN launches for ``F.conv2d``
    at AlexNet's conv2 and res2's and res3's 3x3."""
    rows, cudnn = [], {}
    for case in conv_cases(dev, dtype):
        rows.append(tile_row(tile_name("conv2d_direct", case["plan"], dtype),
                             case, timer))
        label = case["label"]
        if label in ("alexnet_conv2", "res2_3x3", "res3_3x3") and \
                label not in cudnn:
            cudnn[label] = library_kernels(case["library_fn"])
    torch.cuda.synchronize()
    return rows, cudnn


#: the Hopper tile's planted faults: {fault: (a line of
#: csrc/gemm_wgmma.cuh, what it becomes), or a list of such pairs}, each
#: built into both kernels' sources (:func:`wgmma_fault_builds`); each
#: must fail ``bf16_agrees`` (:func:`wgmma_faults`)
WGMMA_FAULTS = {
    # A's shared-memory writes one chunk off the 128-byte swizzle
    "a_swizzle_off_by_one": (
        "    const uint32_t a_off = r0 * 128 + ((c ^ (r0 & 7)) << 4);",
        "    const uint32_t a_off = r0 * 128 + ((c ^ ((r0 + 1) & 7)) << 4);"),
    # a stage's empty barrier released as soon as it is full, before the
    # wgmma group that reads it is even issued (once a use and never
    # after, so the phases hold and nothing hangs)
    "empty_before_retire": [
        ("        fence_proxy_async();",
         "        fence_proxy_async();\n"
         "        if (leader) mbar_arrive(empty + 8 * stage);"),
        ("        last = stage;", "        last = -1;")],
}


def wgmma_fault_builds() -> dict:
    """Start the builds of every planted fault of WGMMA_FAULTS in both
    sources: {(source, fault): (the process, the library's path)}."""
    return {(source, name): build
            for source in ("brgemm", "conv2d_direct")
            for name, build in source_fault_builds(source,
                                                   WGMMA_FAULTS).items()}


def built(builds: dict) -> dict:
    """{key: the library's path} of ``builds`` ({key: (process, path)}),
    once every process has ended; raises with the log of a failed one."""
    out = {}
    for key, (proc, lib) in builds.items():
        log_, _ = proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"nvcc of planted fault {key} failed:\n"
                                 f"{log_}")
        out[key] = lib
    return out


def wgmma_faults(dev, libs) -> dict:
    """Each planted fault's library (``libs``, from :func:`built`) in
    place of its source's Hopper-tile entry, at res4's 3x3
    (conv2d_direct) and branch2a 1x1 (brgemm) at batch 64 with stats:
    the 128 x 256 tile over 36 and 16 stages.  Each must fail
    ``bf16_agrees`` against the f64 twin rounded once, where the real
    entry passes (phase 13's rows)."""
    import ctypes

    from paddle_tpu_torch.ops.kernels import brgemm as BR
    from paddle_tpu_torch.ops.kernels import conv as CV

    gen = torch.Generator(device=dev).manual_seed(18)
    cases = {}
    for source, mod, (cin, k, p) in (("conv2d_direct", CV, (256, 3, 1)),
                                     ("brgemm", BR, (1024, 1, 0))):
        x = torch.randn(64, 14, 14, cin, generator=gen, device=dev).to(
            torch.bfloat16)
        w = (torch.randn(k, k, cin, 256, generator=gen, device=dev)
             * (2.0 / (k * k * cin)) ** 0.5).to(torch.bfloat16)
        want = CV.fwd_raw_reference(x.double(), w.double(), (1, 1), (p, p))
        mag = CV.fwd_raw_reference(x.double().abs(), w.double().abs(),
                                   (1, 1), (p, p))
        plan = BR.plan(64 * 14 * 14, 256, k * k * cin, cin,
                       (x.data_ptr(), w.data_ptr()), BR.sm_count(dev),
                       BR.BF16)
        cases[source] = (mod, x, w, p, want.to(torch.bfloat16), mag,
                         k * k * cin, plan_dict(plan, torch.bfloat16))
    out = {}
    for (source, name), lib in libs.items():
        mod, x, w, p, want, mag, kred, plan = cases[source]
        kernel = mod.KERNEL_WGMMA
        real = kernel._fn or kernel._resolve()
        fn = getattr(ctypes.CDLL(str(lib)), kernel.symbol)
        fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
        kernel._fn = fn
        try:
            got = CV.fwd_raw(x, w, (1, 1), (p, p), stats=True)[0]
            torch.cuda.synchronize()
        finally:
            kernel._fn = real
        a = bf16_agreement(got, want, mag, kred)
        out[f"{source} {name}"] = {"plan": plan, **a}
        if bf16_agrees(got, want, mag, kred):
            raise AssertionError(f"planted fault {name} in {source} passed "
                                 f"bf16_agrees: {a}")
    del cases
    return out


def check_resident() -> dict:
    """Each form's ``resident`` table (``brgemm.F32``, ``brgemm.BF16``),
    the blocks an SM holds that the tile plan reads, against the CUDA
    runtime's occupancy of every instantiation of both tiles in both
    kernels."""
    from paddle_tpu_torch.ops.kernels import brgemm as BR
    from paddle_tpu_torch.ops.kernels import conv as CV

    got = {}
    for form, kernels in ((BR.F32, (BR.KERNEL, CV.KERNEL)),
                          (BR.BF16, (BR.KERNEL_BF16, CV.KERNEL_BF16)),
                          (BR.WGMMA, (BR.KERNEL_WGMMA, CV.KERNEL_WGMMA))):
        for kernel in kernels:
            for key, want in form.resident.items():
                n = BR.resident(kernel, *key)
                got[f"{kernel.symbol} {key[0]}x{key[1]} "
                    f"{'16-byte' if key[2] else 'element'} copies"] = n
                if n != want:
                    raise AssertionError(f"{kernel.symbol} {key}: {n} blocks"
                                         f" an SM, the plan's table says "
                                         f"{want}")
    return got


def check_conv_backward(dev) -> dict:
    """The backward of every conv on the training path (``CV.
    conv_input_grads``: cuDNN's dx and dw on NCHW views of the NHWC
    tensors) at the port's f32 policy, against the same call in float64 on
    the CPU, at res2's 3x3 and the stem: relative norm error of dx and dw
    <= CONV_BWD_RTOL.  The same call with TF32 allowed in cuDNN is the
    planted fault that must exceed it."""
    from paddle_tpu_torch.core.dtype import set_policy
    from paddle_tpu_torch.ops import nn as nn_ops
    from paddle_tpu_torch.ops.kernels import conv as CV

    gen = torch.Generator().manual_seed(5)
    out = {"phase": "conv_backward", "limit": CONV_BWD_RTOL}
    for label, (n, h, w, cin), (k, cout, s, p) in (
            ("res2_3x3", (8, 56, 56, 64), (3, 64, 1, 1)),
            ("stem_7x7", (4, 224, 224, 3), (7, 64, 2, 3))):
        x = torch.randn(n, h, w, cin, generator=gen)
        wt = torch.randn(k, k, cin, cout, generator=gen) * (
            2.0 / (k * k * cin)) ** 0.5
        dy = torch.randn(n, nn_ops.conv_out(h, k, s, p),
                         nn_ops.conv_out(w, k, s, p), cout, generator=gen)
        want = CV.conv_input_grads(x.double(), wt.double(), dy.double(),
                                   (s, s), (p, p))
        row = {"shape": [n, h, w, cin, k, cout, s, p]}
        for mode in ("f32", "tf32_control"):
            torch.backends.cudnn.allow_tf32 = mode == "tf32_control"
            try:
                got = CV.conv_input_grads(x.to(dev), wt.to(dev), dy.to(dev),
                                          (s, s), (p, p))
            finally:
                set_policy()
            row[mode] = max(rel_norm(g, r) for g, r in zip(got, want))
        out[label] = row
        if not (row["f32"] <= CONV_BWD_RTOL < row["tf32_control"]):
            raise AssertionError(f"conv backward vs f64: {out}")
    return out


def fine_buckets() -> tuple:
    """1%-geometric bucket edges from 0.01 ms to ~100 s, so histogram
    percentiles are exact to ~1%."""
    return tuple(0.01 * 1.01 ** i for i in range(1620))


def serve_workload(cfg):
    """Phase 3's serving configuration and requests: 32 slots, page 16,
    prompts of 16-512 tokens (seeded), 64 new tokens each, 64 greedy
    requests and 8 at temperature 0.8.  Returns (scfg, prompts, temps)."""
    from paddle_tpu_torch.serving import ServingConfig

    scfg = ServingConfig(max_slots=32, page_size=16, max_prompt_len=512,
                         max_new_tokens=64, prefill_batch=8,
                         num_pages=32 * 36 + 1, seed=0)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, cfg.vocab_size, size=n))
               for n in rng.integers(16, 513, size=72)]
    return scfg, prompts, [0.0] * 64 + [0.8] * 8


def serve_block(cfg, params, scfg, prompts, temps, dev, counters) -> dict:
    """Every request through a fresh engine, ``run_until_idle``, with the
    launch counts of ``counters`` ({name: Kernel}) zeroed just before and
    read just after and the peak memory reset; checks that every request
    got its tokens.  Returns the run's numbers, its results by id and the
    ids in submission order."""
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.telemetry import MetricsRegistry

    reg = MetricsRegistry("chip_smoke")
    for name in ("serve_prefill_ms", "serve_decode_step_ms"):
        reg.histogram(name, buckets=fine_buckets())
    eng = ServingEngine(cfg, params, scfg, registry=reg, device=dev)
    kv_bytes = eng.cache.k.nbytes + eng.cache.v.nbytes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for kernel in counters.values():
        kernel.launches = 0
    t0 = time.perf_counter()
    ids = [eng.submit(p, temperature=tt) for p, tt in zip(prompts, temps)]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: kernel.launches for n, kernel in counters.items()}
    got = {r.id: r for r in eng.results()}
    peak = torch.cuda.max_memory_allocated(dev)
    del eng
    if sorted(got) != sorted(ids):
        raise AssertionError(f"served {len(got)} of {len(ids)} requests")
    for r in got.values():
        if len(r.tokens) != scfg.max_new_tokens or r.finish_reason != "length":
            raise AssertionError(f"request {r.id}: {len(r.tokens)} tokens, "
                                 f"{r.finish_reason}")
    ttft = np.array([got[i].metrics["ttft_ms"] for i in ids])
    new_tokens = sum(len(r.tokens) for r in got.values())
    return {"run": {
        "requests": len(ids), "new_tokens": new_tokens,
        "prompt_tokens": sum(len(p) for p in prompts),
        "wall_s": wall, "tokens_per_s": new_tokens / wall,
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p99": float(np.percentile(ttft, 99)),
        "decode_step_ms_p50": reg.get("serve_decode_step_ms").percentile(50),
        "prefill_ms_p50": reg.get("serve_prefill_ms").percentile(50),
        "prefill_passes": reg.get("serve_prefill_ms").summary()["count"],
        "decode_steps": reg.get("serve_decode_step_ms").summary()["count"],
        "launches": launches, "max_memory_allocated_bytes": peak,
        "kv_pool_bytes": kv_bytes}, "results": got, "ids": ids}


def serve_end_to_end(dev) -> tuple[dict, int, int]:
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.ops.kernels import flash_attention as FA
    from paddle_tpu_torch.ops.kernels import paged_attention as PA
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.telemetry import MetricsRegistry

    cfg = T.TransformerConfig(**LM_FULL, dtype=torch.float32, remat=False,
                              attn_impl="flash")
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator().manual_seed(0), dev)
    n_params = T.count_params(params)
    scfg, prompts, temps = serve_workload(cfg)

    # warm-up on its own engine: cuBLAS handles, allocator, the kernels'
    # first loads — set-up cost, kept out of the measured run
    ServingEngine(cfg, params, scfg, registry=MetricsRegistry("warmup"),
                  device=dev).generate(prompts[:2], max_new_tokens=2)
    setup_s = time.perf_counter() - t0

    block = serve_block(cfg, params, scfg, prompts, temps, dev,
                        {"flash": FA.KERNEL, "paged": PA.KERNEL})
    run, got, ids = block["run"], block["results"], block["ids"]
    flash_n, paged_n = run["launches"]["flash"], run["launches"]["paged"]
    prefills, steps = run["prefill_passes"], run["decode_steps"]
    if flash_n != cfg.num_layers * prefills or flash_n == 0:
        raise AssertionError(f"flash launches {flash_n} != "
                             f"{cfg.num_layers} x {prefills} prefill passes")
    if paged_n != cfg.num_layers * steps or paged_n == 0:
        raise AssertionError(f"paged launches {paged_n} != "
                             f"{cfg.num_layers} x {steps} decode steps")
    for rid in ids[:2]:   # greedy requests: tokens = full-context argmax
        r = got[rid]
        full = torch.tensor([r.prompt + r.tokens], device=dev)
        logits = T.forward(cfg, params, full)
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite logits")
        want = logits[0, len(r.prompt) - 1:-1].argmax(-1).tolist()
        if r.tokens != want:
            raise AssertionError(f"request {rid}: engine tokens differ from "
                                 "the full-context argmax")
    run.pop("launches")
    return ({"phase": "serve", "params": n_params, **run,
             "flash_launches": flash_n, "paged_launches": paged_n,
             "setup_s": setup_s}, flash_n, paged_n)


def kernel_class(name: str) -> str:
    """Coarse class of a device kernel by its (mangled) name."""
    low = name.lower()
    if "bilstm_cluster_kernel" in low:    # csrc/bilstm_seq.cu's f32 form
        return "bilstm_fwd (ours)"
    for mine in ("flash_fwd_wgmma", "flash_fwd_bf16", "flash_bwd_dq_bf16",
                 "flash_bwd_dkv_bf16", "flash_bwd_dq_wgmma",
                 "flash_bwd_dkv_wgmma", "flash_bwd_dq_tf32x3",
                 "flash_bwd_dkv_tf32x3",
                 "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "paged_bf16",
                 "paged",
                 "bilstm_fwd_bf16", "lstm_fwd_bf16", "lstm_bwd_bf16",
                 "bilstm_fwd", "lstm_fwd", "lstm_bwd", "bigru_fwd",
                 "gru_fwd", "gru_bwd", "ctc_fwd_bwd", "ctc_decode"):
        if mine in low:
            return f"{mine} (ours)"
    if ("lse_kernel<" in low or "::dlogits_kernel(" in low
            or "dlogits_bf16_kernel" in low):
        return "softmax_xent (ours)"      # csrc/softmax_xent.cu
    if any(k in low for k in ("place_copy_kernel<", "sum_runs_kernel<",
                              "group_sort_kernel")):
        # csrc/embedding.cu
        return "embedding_scatter_add (ours)"
    if "::gather_kernel<" in low:         # both forms: one template
        return "embedding_gather (ours)"
    if "radixsort" in low or "sort" in low:
        return "sort/unique (library)"
    if "wgmma_kernel<" in low:            # csrc/gemm_wgmma.cuh
        return ("brgemm wgmma (ours)" if "brgemma" in low
                else "conv2d_direct wgmma (ours)")
    if "mma_kernel<" in low:              # csrc/gemm_bf16.cuh
        return ("brgemm bf16 (ours)" if "brgemma" in low
                else "conv2d_direct bf16 (ours)")
    if "brgemma" in low:
        return "brgemm (ours)"
    if "conva" in low:
        return "conv2d_direct (ours)"
    if "channel_stats_kernel<__nv_bfloat16" in low:  # csrc/channel_stats.cu
        return "channel_stats bf16 (ours)"
    if "channel_stats_kernel<float" in low:
        return "channel_stats (ours)"
    if "fused_update_kernel" in low:
        return "fused_update (ours)"      # csrc/update.cu
    if "sparse_row_update_kernel" in low:
        return "sparse_row_update (ours)"
    if "stats_reduce" in low:
        return "stats_reduce (ours)"      # csrc/gemm_f32.cuh
    if "split_reduce" in low:
        return "split_reduce (ours)"      # csrc/gemm_f32.cuh
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    if any(k in low for k in ("dgrad", "wgrad", "cudnn", "convolve")):
        return "cudnn conv backward"
    if "gemm" in low or "splitk" in low or "nvjet" in low:
        return "other gemm (cuBLAS/cuDNN)"    # nvjet: cuBLAS's Hopper GEMMs
    return "elementwise and reductions"


def profile_window(fn, steps: int, split: str | None = None) -> dict:
    """Device time by kernel class over ``fn()`` (``steps`` train steps)
    under ``torch.profiler``; busy = the sum of kernel times (one stream).
    The kernels launched inside the ``record_function`` ranges named
    ``split`` form a class of their own.  The profiler's own host cost
    inflates the traced wall many times over, so the caller sets the idle
    share against an untraced step.  An empty trace reports "not
    measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_class: dict[str, float] = {}
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or not e.self_device_time_total:
            continue
        if e.key.startswith("train_step/"):
            continue     # a range's device-side span, not a kernel
        ms = e.self_device_time_total / 1e3
        cls = kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + ms / steps
        kernels.append((ms / steps, e.count // steps, e.key[:100], cls))
    if not kernels:
        return {"steps": steps, "device_time": "not measured"}
    if split:
        moved = range_device_ms(prof, split, steps)
        for cls, ms in moved.items():
            by_class[cls] -= ms
        by_class[split] = sum(moved.values())
    busy = sum(by_class.values())
    kernels.sort(reverse=True)
    return {"steps": steps, "traced_wall_ms_per_step": wall_ms / steps,
            "library_sort_kernels": sorted({
                k[2] for k in kernels if k[3] == "sort/unique (library)"}),
            "device_busy_ms_per_step": busy,
            "kernels_per_step": sum(k[1] for k in kernels),
            "by_class_ms_per_step": by_class,
            "top_kernels": [{"ms_per_step": k[0], "per_step": k[1],
                             "name": k[2], "class": k[3]}
                            for k in kernels[:12]]}


#: the GRU kernels' names in a trace, by the launch ``device_ms`` reads
GRU_KERNEL_NAMES = {"bi": "bigru_fwd_kernel",
                    "fwd": "::gru_fwd_kernel<false",
                    "fwd_slab": "::gru_fwd_kernel<false",
                    "remat": "gru_bwd_kernel<true",
                    "stored": "gru_bwd_kernel<false"}


def device_ms(fns, key: str, rounds: int = 20, tries: int = 5) -> float:
    """The device time of one launch of the kernel whose name holds
    ``key``, averaged over the launches a ``torch.profiler`` trace of
    ``rounds`` calls of each of ``fns`` records: the kernel's own time,
    without the wrapper's weight packing and allocations (and without an
    L2 flush).  On the H100 host every other trace drops its first ~7
    kernel records (13 of 20 launches recorded, then 20 of 20, in turn),
    so a trace of 5 launches could hold none: 20 launches leave at least
    13.  Three traces in a row of a microsecond kernel have held none,
    so each further trace takes twice the rounds.
    Raises when ``tries`` traces in a row hold no such kernel."""
    return device_passes_ms(fns, (key,), rounds, tries)[key]


def cuda_records(fn, rounds: int, tries: int = 3) -> list:
    """The CUDA records (``key_averages``) of a ``torch.profiler`` trace of
    ``rounds`` calls of ``fn``.  On the H100 host a trace of 40 calls has
    come back holding no device time at all, so such a trace is taken
    again, up to ``tries`` traces; an empty list means all were empty."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(rounds):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        if any(e.self_device_time_total for e in events):
            return events
        log(f"chip_smoke: a trace of {rounds} calls held no device time; "
            f"taken again")
    return []


def call_alone_ms(fn, rounds: int = 20) -> float:
    """The device time of one call of ``fn``, whatever its kernels are
    named: the sum of every CUDA kernel's (and memset's or copy's) time in
    a ``torch.profiler`` trace of ``rounds`` calls, over ``rounds`` (a
    library call's own time, no flush).  Raises when every trace
    (``cuda_records``) holds no device time."""
    fn()
    total = sum(e.self_device_time_total for e in cuda_records(fn, rounds))
    if not total:
        raise AssertionError("a trace of the call holds no device time")
    return total / 1e3 / rounds


def device_passes_ms(fns, keys, rounds: int = 20, tries: int = 5) -> dict:
    """{key: device ms of one launch} of each kernel (or memset) whose
    name holds a key of ``keys``, from one ``torch.profiler`` trace of
    ``rounds`` calls of each of ``fns`` (as :func:`device_ms`), and
    ``total``, their sum: the device time of one call that runs each once.
    Raises when ``tries`` traces in a row miss a key."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        rounds_now = rounds << attempt
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(rounds_now):
                for fn in fns:
                    fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        out = {}
        for key in keys:
            hits = [e for e in events if key in e.key]
            n = sum(e.count for e in hits)
            if not n:
                break
            out[key] = sum(e.self_device_time_total for e in hits) / 1e3 / n
        else:
            out["total"] = sum(out.values())
            return out
    raise AssertionError(f"device_passes_ms: {tries} traces missed one of "
                         f"{keys}")


#: the scatter-add's device passes by name (csrc/embedding.cu; the memset
#: of its counters is the "Memset" record; the placement pass and the copy
#: of the untouched rows share a launch), the run sums by form
SCATTER_PASSES = ("Memset", "group_sort_kernel", "place_copy_kernel")


def witness_ratio(start: dict, wide: dict, got: dict) -> tuple:
    """The worst leaf of an f32 step against the f64 witness: per leaf
    ||got - wide|| / max(||wide - start||, STEP_FLOOR * u * sqrt(size)),
    u the per-element RMS of the whole f64 update.  The floor keeps a leaf
    whose exact update is zero from dividing by round-off: conv1's BN
    shift is one (pool1's maxima are positive, so a shift of it reaches
    res2_1's two 1x1 convs as a constant that their BNs remove).  Returns
    (ratio, leaf, the same ratio over all leaves at once)."""
    ratios = leaf_ratios(start, wide, got)
    worst = max(ratios, key=ratios.get)
    sq = sum(float(np.sum((wide[n] - start[n]) ** 2)) for n in wide)
    err_sq = sum(float(np.sum((got[n] - wide[n]) ** 2)) for n in wide)
    return ratios[worst], worst, (err_sq / sq) ** 0.5


def leaf_ratios(start: dict, wide: dict, got: dict) -> dict:
    """Per leaf ||got - wide|| / max(||wide - start||, STEP_FLOOR * u *
    sqrt(size)), u the per-element RMS of the whole update: the ratio
    :func:`witness_ratio` takes the worst of."""
    sq = sum(float(np.sum((wide[n] - start[n]) ** 2)) for n in wide)
    u = (sq / sum(wide[n].size for n in wide)) ** 0.5
    return {n: float(np.linalg.norm(got[n] - wide[n]))
            / max(float(np.linalg.norm(wide[n] - start[n])),
                  STEP_FLOOR * u * wide[n].size ** 0.5) for n in wide}


def update_route_ab(tr, run, data, stamp, marks) -> dict:
    """Step ms with the optimizer update through the kernels (``apply``)
    and through the per-tensor loop (``_apply_each``) on one trainer, in
    blocks of ``len(data)`` steps: kernels, loop, loop, kernels, so a
    drift of the machine falls on both sides."""
    ms: dict[str, list] = {"kernels": [], "loop": []}
    for route in ("kernels", "loop", "loop", "kernels"):
        if route == "loop":
            tr.optimizer.apply = tr.optimizer._apply_each
        else:
            tr.optimizer.__dict__.pop("apply", None)
        marks.clear()
        run(tr, data, stamp)
        ms[route] += [1e3 * (b - a) for a, b in marks.values()]
    tr.optimizer.__dict__.pop("apply", None)
    return {"kernels_p50": float(np.percentile(ms["kernels"], 50)),
            "loop_p50": float(np.percentile(ms["loop"], 50)), **ms}


def drop_kept_tables(*kernels) -> None:
    """Forget the update tables ``kernels`` keep (``update.TableKernel``),
    so that a timed run's count of table builds does not depend on where
    the caching allocator put an earlier run's tensors: ``trainer.SGD``'s
    ``train`` copies its parameters once a call, and a copy that lands at
    the addresses of a kept table's tensors, with their shapes and
    scalars, reuses that table (rightly) and builds none."""
    for kernel in kernels:
        kernel.tables.clear()


def train_end_to_end(dev) -> tuple[dict, int, int, int]:
    """ResNet-50 through the v2 flow: the CPU-vs-card step, then the
    batch-64 run and ``test``, with exact launch counts."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.dtype import set_policy
    from paddle_tpu_torch.core.parameters import Parameters
    from paddle_tpu_torch.layers.base import reset_name_counters
    from paddle_tpu_torch.ops import nn as nn_ops
    from paddle_tpu_torch.ops.kernels import brgemm as BR
    from paddle_tpu_torch.ops.kernels import conv as CV
    from paddle_tpu_torch.ops.kernels import update as UP

    bs, steps, side, classes = 64, 10, 224, 1000
    t0 = time.perf_counter()
    reset_name_counters()
    cost = paddle.models.image.resnet_cost(depth=50, class_num=classes,
                                           height=side, width=side)[0]
    created = paddle.parameters.create(cost)   # generator seeded 0
    carried = {n: created[n] for n in created.names()}
    rng = np.random.default_rng(0)

    def batches(k, b):
        return [[(rng.standard_normal(3 * side * side, dtype=np.float32),
                  int(rng.integers(0, classes))) for _ in range(b)]
                for _ in range(k)]

    def trainer(where):
        return paddle.trainer.SGD(
            cost=cost, parameters=Parameters.from_numpy(carried),
            update_equation=paddle.optimizer.Momentum(
                momentum=0.9, learning_rate=0.1 / bs), device=where)

    def run(tr, data, handler=None):
        costs = []

        def h(e):
            if isinstance(e, paddle.event.EndIteration):
                costs.append(e.cost)
            if handler is not None:
                handler(e)

        tr.train(reader=lambda: iter(data), num_passes=1, event_handler=h)
        return costs

    # (a) one step at batch 2 from the same parameters: the CPU's plain
    # twins and the card's kernels, both f32, each held against a float64
    # step on the CPU (the witness).  The witness's own move under a 1e-6
    # relative nudge of the input is measured beside them: at full depth
    # the step is that sensitive (pool1's max routing, amplified through
    # 16 BN blocks), so f32 round-off alone moves it by a few percent.  A
    # card step whose BN backward drops the batch mean's term is the
    # planted fault the limit must catch.  The card's step updates through
    # one launch of the fused update kernel; the same step through the
    # per-tensor loop (``_apply_each``) must give the same bits.
    small = batches(1, 2)
    nudged = [(x * (1 + 1e-6 * rng.standard_normal(x.shape,
                                                    dtype=np.float32)), y)
              for x, y in small[0]]
    witness = trainer("cpu")
    p64, s64, c64 = witness.step_f64(small[0])
    start = (carried, {k: v.numpy() for k, v in witness.states.items()})
    p_n, s_n, c_n = witness.step_f64(nudged)
    sides = {"f64_nudged": (c_n, p_n, s_n)}
    del witness
    plain_bn = CV.bn_act_train

    def bn_mean_term_dropped(y_conv, gamma, beta, eps, act):
        mean, var = nn_ops.moments(y_conv)
        return CV.bn_apply(y_conv, mean.detach(), var, gamma, beta, eps, act)

    update_n = {}
    for label, where in (("cpu", "cpu"), ("card", dev), ("card_rerun", dev),
                         ("card_generic_loop", dev),
                         ("card_bn_vjp_control", dev)):
        tr = trainer(where)
        if label == "card_bn_vjp_control":
            CV.bn_act_train = bn_mean_term_dropped
        if label == "card_generic_loop":
            tr.optimizer.apply = tr.optimizer._apply_each
        n0 = UP.KERNEL.launches
        try:
            c = run(tr, small)[0]
        finally:
            CV.bn_act_train = plain_bn
        torch.cuda.synchronize()
        update_n[label] = UP.KERNEL.launches - n0
        sides[label] = (c, {n: tr.parameters[n] for n in carried},
                        {k: v.cpu().numpy() for k, v in tr.states.items()})
        del tr
    # the card's step repeats bit for bit: the kernels' stats use no
    # atomics and cuDNN is held to deterministic algorithms; and the
    # update kernel gives the per-tensor loop's bits
    for other in ("card_rerun", "card_generic_loop"):
        (c_a, p_a, s_a), (c_b, p_b, s_b) = sides["card"], sides.pop(other)
        if not (c_a == c_b
                and all(np.array_equal(p_a[n], p_b[n]) for n in p_a)
                and all(np.array_equal(s_a[k], s_b[k]) for k in s_a)):
            raise AssertionError(f"the card's train step and {other} are "
                                 "not bit-identical")
    if (update_n["card"], update_n["card_generic_loop"]) != (1, 0):
        raise AssertionError(f"fused update launches a step {update_n}")
    witness_rows = {}
    for label, (c, p_side, s_side) in sides.items():
        pr, pn, pg = witness_ratio(start[0], p64, p_side)
        sr, sn, sg = witness_ratio(start[1], s64, s_side)
        witness_rows[label] = {
            "cost": c, "cost_rel_err": abs(c - c64) / abs(c64),
            "param_worst": pr, "param_worst_leaf": pn, "param_global": pg,
            "state_worst": sr, "state_worst_leaf": sn, "state_global": sg}
    for label in ("cpu", "card"):
        w = witness_rows[label]
        if not (np.isfinite(w["cost"]) and w["cost_rel_err"] <= STEP_COST_RTOL
                and max(w["param_worst"], w["state_worst"])
                <= STEP_LEAF_LIMIT):
            raise AssertionError(f"{label} f32 step vs the f64 witness "
                                 f"(cost {c64}): {witness_rows}")
    control = witness_rows["card_bn_vjp_control"]
    if max(control["param_worst"], control["state_worst"]) <= STEP_LEAF_LIMIT:
        raise AssertionError("the f64 witness limit does not catch a BN "
                             f"backward without its mean term: {witness_rows}")

    # (b) the batch-64 run, after 2 warm-up steps (allocator growth, the
    # kernels' first loads, cuDNN handles: set-up)
    tr = trainer(dev)
    warm, data, test_data = batches(2, bs), batches(steps, bs), batches(2, bs)
    traced = batches(3, bs)
    run(tr, warm)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    marks: dict[int, list] = {}

    def stamp(e):
        if isinstance(e, (paddle.event.BeginIteration,
                          paddle.event.EndIteration)):
            marks.setdefault(e.batch_id, []).append(time.perf_counter())

    each = []
    loop = tr.optimizer._apply_each
    tr.optimizer._apply_each = lambda *a: each.append(1) or loop(*a)
    BR.KERNEL.launches = 0
    CV.KERNEL.launches = 0
    UP.KERNEL.launches = 0
    drop_kept_tables(UP.KERNEL)
    builds0 = UP.KERNEL.table_builds
    t1 = time.perf_counter()
    costs = run(tr, data, stamp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    br_n, cv_n, up_n = (BR.KERNEL.launches, CV.KERNEL.launches,
                        UP.KERNEL.launches)
    table_builds = UP.KERNEL.table_builds - builds0
    peak = torch.cuda.max_memory_allocated(dev)
    if (br_n, cv_n, up_n, len(each)) != (36 * steps, 17 * steps, steps, 0):
        raise AssertionError(f"train launches brgemm {br_n}, conv {cv_n}, "
                             f"fused update {up_n}, per-tensor loops "
                             f"{len(each)} != 36 x {steps}, 17 x {steps}, "
                             f"{steps}, 0")
    if table_builds != 1:
        raise AssertionError(f"the fused update built {table_builds} "
                             f"tables over {steps} steps, not 1")
    if len(costs) != steps or not all(np.isfinite(costs)):
        raise AssertionError(f"train costs {costs}")
    step_ms = [1e3 * (b - a) for a, b in marks.values()]
    profile = profile_window(lambda: run(tr, traced), len(traced))

    # (c) what deterministic cuDNN costs: steps in blocks of 5 with it on,
    # off, off, on, so a drift of the machine falls on both sides
    det_ms: dict[bool, list] = {True: [], False: []}
    for det in (True, False, False, True):
        torch.backends.cudnn.deterministic = det
        marks.clear()
        run(tr, data[:5], stamp)
        det_ms[det] += [1e3 * (b - a) for a, b in marks.values()]
    set_policy()
    route_ms = update_route_ab(tr, run, data[:5], stamp, marks)

    # (d) test on 2 batches: the eval epilogue (affine + ReLU)
    BR.KERNEL.launches = 0
    CV.KERNEL.launches = 0
    UP.KERNEL.launches = 0
    result = tr.test(reader=lambda: iter(test_data))
    test_n = (BR.KERNEL.launches, CV.KERNEL.launches, UP.KERNEL.launches)
    if test_n != (36 * 2, 17 * 2, 0) or not np.isfinite(result.cost):
        raise AssertionError(f"test launches {test_n} != 72, 34, 0 or cost "
                             f"{result.cost}")
    if "device_busy_ms_per_step" in profile:
        profile["idle_share_vs_step_p50"] = (
            1 - profile["device_busy_ms_per_step"] / np.percentile(step_ms, 50))
    return ({"phase": "train", "model": "resnet50", "params":
             int(sum(v.size for v in carried.values())),
             "step_vs_f64_witness": {"batch": 2, "cost_f64": c64,
                                     "limit": STEP_LEAF_LIMIT,
                                     **witness_rows,
                                     "card_rerun_bit_identical": True,
                                     "card_generic_loop_bit_identical":
                                         True,
                                     "fused_update_launches": update_n},
             "batch": bs, "steps": steps, "wall_s": wall,
             "img_per_s": bs * steps / wall,
             "step_ms_p50": float(np.percentile(step_ms, 50)),
             "step_ms": step_ms, "costs": costs,
             "max_memory_allocated_bytes": peak,
             "train_launches": {"brgemm": br_n, "conv2d_direct": cv_n,
                                "fused_update": up_n},
             "fused_update_table_builds": table_builds,
             "train_per_tensor_loops": len(each),
             "test_launches": {"brgemm": test_n[0],
                               "conv2d_direct": test_n[1]},
             "test_batches": 2, "test_cost": result.cost,
             "update_route_step_ms": route_ms,
             "cudnn_deterministic_step_ms": {
                 "on_p50": float(np.percentile(det_ms[True], 50)),
                 "off_p50": float(np.percentile(det_ms[False], 50)),
                 "on": det_ms[True], "off": det_ms[False]},
             "setup_s": setup_s, "profile": profile}, br_n, cv_n, up_n)


def named_leaves(tree_, prefix="") -> dict:
    """{"blocks/wq": leaf, ...} of a nested params dict."""
    out = {}
    for k in sorted(tree_):
        if isinstance(tree_[k], dict):
            out.update(named_leaves(tree_[k], f"{prefix}{k}/"))
        else:
            out[prefix + k] = tree_[k]
    return out


def range_device_ms(prof, name: str, steps: int) -> dict:
    """{kernel class: device ms per step} of the kernels launched inside
    the ``record_function`` ranges called ``name``."""
    from torch.autograd import DeviceType

    out: dict[str, float] = {}

    def walk(e):
        for k in e.kernels:
            cls = kernel_class(k.name)
            out[cls] = out.get(cls, 0.0) + k.duration / 1e3 / steps
        for c in e.cpu_children:
            walk(c)

    for e in prof.events():
        if e.name == name and e.device_type == DeviceType.CPU:
            walk(e)
    return out


def train_lm(dev) -> tuple[dict, tuple]:
    """The GPT-2-small-shape LM through ``transformer.build_train_step``
    in f32 with Adam: the batch-2 step against a float64 witness, a
    bit-identical rerun, then 10 timed steps at batch 16 x 1024 with
    exact launch counts and a 3-step profile."""
    from paddle_tpu_torch.core import tree
    from paddle_tpu_torch.core.dtype import set_policy
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.ops.kernels import flash_attention as FA
    from paddle_tpu_torch.optimizer import Adam

    cfg = T.TransformerConfig(**LM_FULL, dtype=torch.float32, remat=False,
                              attn_impl="flash")
    bs, seqlen, steps = 16, 1024, 10
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator().manual_seed(0), dev)
    n_params = T.count_params(params)
    rng = np.random.default_rng(0)

    # (a) one step at batch 2 x 128 from the same weights: the card's
    # kernels in f32 and the CPU's plain twins in f32, each against the
    # CPU's plain twins in float64 (the witness), by the loss and every
    # gradient leaf (Adam's first update is about lr * sign(g), which
    # round-off can flip, so the gradient is what is compared).  The same
    # card step with TF32 allowed in cuBLAS, and with the flash backward's
    # delta dropped, are the planted faults the limit must catch.
    small = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 129)))

    def cast(dtype, where):
        return tree.unflatten(params, [p.detach().to(where, dtype)
                                       for p in tree.leaves(params)])

    loss64, g64 = T.loss_and_grads(cfg, cast(torch.float64, "cpu"), small)
    g64 = named_leaves(g64)
    sides = {"cpu": T.loss_and_grads(cfg, cast(torch.float32, "cpu"),
                                     small)}
    plain_delta = FA._delta

    def card_step():
        return T.loss_and_grads(cfg, params, small.to(dev))

    sides["card"] = card_step()
    rerun = card_step()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        sides["card_tf32_control"] = card_step()
    finally:
        set_policy()
    # the f32 route takes delta from [B, T, H, D] (_delta_bthd): both
    # delta routes drop it
    plain_bthd = FA._delta_bthd
    FA._delta = lambda do, o: torch.zeros_like(plain_delta(do, o))
    FA._delta_bthd = lambda do, o, tqp: torch.zeros_like(
        plain_bthd(do, o, tqp))
    try:
        sides["card_delta_dropped_control"] = card_step()
    finally:
        FA._delta, FA._delta_bthd = plain_delta, plain_bthd
    if not (torch.equal(rerun[0], sides["card"][0]) and all(
            torch.equal(a, b) for a, b in zip(tree.leaves(rerun[1]),
                                              tree.leaves(sides["card"][1])))):
        raise AssertionError("the card's LM step is not bit-identical on a "
                             "rerun")
    witness = {"batch": [2, 128], "loss_f64": float(loss64),
               "loss_rtol": LM_LOSS_RTOL, "grad_limit": LM_GRAD_LIMIT,
               "card_rerun_bit_identical": True}
    for label, (loss, grads) in sides.items():
        ratios = {n: rel_norm(x, g64[n])
                  for n, x in named_leaves(grads).items()}
        worst = max(ratios, key=ratios.get)
        witness[label] = {"loss": float(loss),
                          "loss_rel_err": abs(float(loss) - float(loss64))
                          / abs(float(loss64)),
                          "grad_worst": ratios[worst],
                          "grad_worst_leaf": worst,
                          "grad_median": float(np.median(list(
                              ratios.values())))}
    del sides, rerun, g64
    for label in ("cpu", "card"):
        w = witness[label]
        if not (w["loss_rel_err"] <= LM_LOSS_RTOL
                and w["grad_worst"] <= LM_GRAD_LIMIT):
            raise AssertionError(f"{label} LM step vs the f64 witness: "
                                 f"{witness}")
    for label in ("card_tf32_control", "card_delta_dropped_control"):
        if witness[label]["grad_worst"] <= LM_GRAD_LIMIT:
            raise AssertionError(f"the LM witness limit does not catch "
                                 f"{label}: {witness}")

    # (b) the timed run: Adam lr 1e-4 with bf16 moments (as the repo's LM
    # benchmark), 2 warm-up steps (allocator growth, cuBLAS handles:
    # set-up), then 10 steps on one fixed batch with the launch counts
    # zeroed just before and read just after
    opt = Adam(learning_rate=1e-4, moment_dtype=torch.bfloat16)
    state = opt.init_tree(params)
    step = T.build_train_step(cfg, opt)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        size=(bs, seqlen + 1))).to(dev)
    losses = []
    for _ in range(2):
        params, state, loss = step(params, state, ids)
        losses.append(float(loss))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    kernels = (FA.KERNEL, FA.KERNEL_BWD_DQ, FA.KERNEL_BWD_DKV)
    for k in kernels:
        k.launches = 0
    step_ms = []
    t1 = time.perf_counter()
    for _ in range(steps):
        a = time.perf_counter()
        params, state, loss = step(params, state, ids)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - a))
        losses.append(float(loss))
    wall = time.perf_counter() - t1
    launches = tuple(k.launches for k in kernels)
    peak = torch.cuda.max_memory_allocated(dev)
    if launches != (cfg.num_layers * steps,) * 3:
        raise AssertionError(f"LM train launches (fwd, dq, dkv) {launches} "
                             f"!= {cfg.num_layers} x {steps} each")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"LM losses not finite and falling: {losses}")

    # (c) 3 steps under torch.profiler: device time by kernel class, the
    # optimizer's kernels (its record_function range) split out; the step
    # updates params and state in place
    prof = profile_window(lambda: [step(params, state, ids)
                                   for _ in range(3)], 3,
                          split="train_step/optimizer")
    p50 = float(np.percentile(step_ms, 50))
    tokens = bs * seqlen
    flops = (6.0 * n_params * tokens + 12.0 * cfg.num_layers * bs * seqlen
             * seqlen * cfg.embed_dim / 2)        # bench.py's count
    if "device_busy_ms_per_step" in prof:
        prof["idle_share_vs_step_p50"] = (
            1 - prof["device_busy_ms_per_step"] / p50)
    out = {"phase": "train_lm", "model": "transformer LM, GPT-2-small shape",
           "params": n_params, "dtype": "float32", "adam_moments": "bfloat16",
           "lr": 1e-4, "step_vs_f64_witness": witness,
           "batch": [bs, seqlen], "steps": steps, "wall_s": wall,
           "tokens_per_s": tokens * steps / wall, "step_ms_p50": p50,
           "step_ms": step_ms, "losses": losses,
           "flop_per_step": flops,
           "mfu_f32_vs_67tflops": flops / (p50 / 1e3) / F32_FLOPS_PER_S,
           "max_memory_allocated_bytes": peak,
           "train_launches": dict(zip(("flash_fwd", "flash_bwd_dq",
                                       "flash_bwd_dkv"), launches)),
           "setup_s": setup_s, "profile": prof}
    del params, state
    return out, launches


TEXT_LOSS_RTOL = 1e-5    # f32 text step vs the f64 witness: loss,
TEXT_GRAD_LIMIT = 1e-4   # per leaf ||g32 - g64|| / ||g64||


def text_classifier(hidden: int, vocab: int, embed: int):
    """``bench.py``'s ``_lstm_classify_cost`` in the port: embedding ->
    fc(4 * hidden, linear) -> lstmemory -> last_seq -> fc(2, softmax) ->
    classification_cost."""
    import paddle_tpu_torch as paddle

    L, A, D = paddle.layer, paddle.activation, paddle.data_type
    data = L.data(name="data", type=D.integer_value_sequence(vocab))
    net = L.embedding(input=data, size=embed)
    net = L.fc(input=net, size=hidden * 4, act=A.LinearActivation())
    net = L.lstmemory(input=net)
    net = L.last_seq(input=net)
    net = L.fc(input=net, size=2, act=A.SoftmaxActivation())
    label = L.data(name="label", type=D.integer_value(2))
    return L.classification_cost(input=net, label=label)


#: planted fault of the scatter-add's grouping (csrc/embedding.cu): each
#: run's positions placed in reverse, an unstable grouping
GROUP_FAULTS = {"runs_reversed": (
    "  order[offsets[id] + prior[head] + (t - head)] = (int)(unsigned)key;",
    "  order[offsets[id + 1] - 1 - prior[head] - (t - head)] ="
    " (int)(unsigned)key;")}


def gather_checks(table, ids, fault) -> dict:
    """Row 17's form of ``table``'s dtype at the text batch (``ids`` flat,
    8,192 of [64, 128]): bit for bit against the twin with and without a
    padding id (the first id), a rerun equal; the planted fault of
    GATHER_FAULTS (``fault``: its build) must not be; the lookup forward
    (``fused_embedding_lookup`` on the [64, 128] ids, a leaf that wants
    its gradient) exactly one launch of the form and of no other embedding
    kernel, with no host sync (``torch.cuda.set_sync_debug_mode``), its
    output the gather's.  Returns the summary and the gather's and the
    lookup forward's device time alone and host ms a call."""
    from paddle_tpu_torch.ops.kernels import embedding as EK

    form = EK.GATHER_FORMS[table.dtype]
    pad = int(ids[0])
    want = {}
    for padding in (None, pad):
        got = EK.embedding_gather(table, ids, padding)
        again = EK.embedding_gather(table, ids, padding)
        torch.cuda.synchronize()
        want[padding] = EK.embedding_gather_reference(table, ids, padding)
        if not (torch.equal(got, want[padding]) and torch.equal(got, again)):
            raise AssertionError(f"gather {table.dtype} (padding "
                                 f"{padding}): differs from its twin or its "
                                 f"rerun")
    real = form._fn or form._resolve()
    form._fn = planted(*fault, form)
    try:
        bad = EK.embedding_gather(table, ids, pad)
        torch.cuda.synchronize()
    finally:
        form._fn = real
    fault_rows = float((bad != want[pad]).any(dim=1).float().mean())
    if torch.equal(bad, want[pad]):
        raise AssertionError("the planted gather fault (padding not "
                             "zeroed) passed the twin")
    grid = ids.view(64, -1)
    leaf = table.detach().requires_grad_()
    kernels = (EK.KERNEL_GATHER, EK.KERNEL_GATHER_BF16, EK.KERNEL_SCATTER,
               EK.KERNEL_SCATTER_BF16, EK.KERNEL_GROUP)
    before = [k.launches for k in kernels]
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = EK.fused_embedding_lookup(leaf, grid)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    moved = {k.symbol: k.launches - n for k, n in zip(kernels, before)}
    if moved != {k.symbol: int(k is form) for k in kernels}:
        raise AssertionError(f"the lookup forward launched {moved}")
    if not torch.equal(out.detach().reshape(-1, table.shape[1]),
                       want[None]):
        raise AssertionError("the lookup forward differs from the gather")
    gather = lambda: EK.embedding_gather(table, ids)  # noqa: E731
    lookup = lambda: EK.fused_embedding_lookup(leaf, grid)  # noqa: E731
    traced = trace_kernel_counts(lookup)
    if not traced or any("gather_kernel<" not in k for k in traced):
        raise AssertionError(f"a trace of the lookup forward holds "
                             f"{traced}")
    return {"summary": {
                "bit_identical_to_twin_with_and_without_padding": True,
                "lookup_forward_launches": moved,
                "lookup_forward_trace": traced,
                "lookup_forward_host_sync": False,
                "planted_faults": {"padding_not_zeroed": {
                    "share_of_rows_unequal": fault_rows}}},
            "alone_ms": device_ms([gather], "gather_kernel<"),
            "host_ms": host_ms(gather),
            "lookup": {"alone_ms": device_ms([lookup], "gather_kernel<"),
                       "host_ms": host_ms(lookup)},
            "lookup_fn": lookup}


#: the f32 LSTM backward's planted faults (csrc/lstm_seq.cu): the dh
#: product's low passes dropped (one TF32 pass, hi.hi: another function),
#: and the (B) sum's second range of blocks left out
LSTM_BWD_FAULTS = {
    "tf32_one_pass": [
        ("tf32x3::mma(part[j], a.lo, bh[j][0], bh[j][1]);   // lo.hi",
         ";"),
        ("tf32x3::mma(part[j], a.hi, bl[j][0], bl[j][1]);   // hi.lo",
         ";")],
    "range_left_out": ("        for (int r = 1; r < groups; ++r) {",
                       "        for (int r = 2; r < groups; ++r) {")}


#: the f32 LSTM forward product's planted faults (csrc/lstm_seq.cu): one
#: TF32 pass (hi.hi: another function) in ``passes``, the product's step
#: the forward, its fused-input form and the remat backward share; and the
#: remat backward's product taken through another routine (an fmaf chain
#: over k: the same function in other bits than the forward's)
LSTM_FWD_FAULTS = {
    "fwd_tf32_one_pass": [
        ("        mma_zero(pt[q][m][j], as[q][m].lo, bh[q][j][0], bh[q][j][1]);",
         "        mma_zero(pt[q][m][j], as[q][m].hi, bh[q][j][0], bh[q][j][1]);"),
        ("        tf32x3::mma(pt[q][m][j], as[q][m].hi, bl[q][j][0], "
         "bl[q][j][1]);", "        ;"),
        ("        tf32x3::mma(pt[q][m][j], as[q][m].hi, bh[q][j][0], "
         "bh[q][j][1]);", "        ;")],
    "remat_other_routine": [(
        "        gemm_gates<S>(a, first ? D : TD, rows, D, w_s, U, uu, rg, half, "
        "a_s,\n                      fin);",
        "        for (int i = 0; i < 2; ++i) {   // planted: an fmaf chain\n"
        "          const int r = rg + kRG * (2 * half + i);\n"
        "          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);\n"
        "          for (int k = 0; r < rows && k < D; ++k) {\n"
        "            const float h = __ldg(a + (size_t)r * (first ? D : TD) + "
        "k);\n"
        "            const float4 w = *reinterpret_cast<const float4*>(\n"
        "                w_s + ((size_t)k * U + uu) * 4);\n"
        "            v.x = fmaf(h, w.x, v.x);\n"
        "            v.y = fmaf(h, w.y, v.y);\n"
        "            v.z = fmaf(h, w.z, v.z);\n"
        "            v.w = fmaf(h, w.w, v.w);\n"
        "          }\n"
        "          fin[i][0] = v.x;\n"
        "          fin[i][1] = v.y;\n"
        "          fin[i][2] = v.z;\n"
        "          fin[i][3] = v.w;\n"
        "        }")]}

_lstm_fwd_entries: dict = {}


def lstm_fwd_fault_entries(builds) -> dict:
    """{fault: [lstm_fwd_f32, lstm_fi_fwd_f32, lstm_bwd_f32]} of
    LSTM_FWD_FAULTS' libraries (``builds``: :func:`source_fault_builds`),
    each build waited for and loaded once a process."""
    from paddle_tpu_torch.ops.kernels import lstm as LK

    for name, build in builds.items():
        if name not in _lstm_fwd_entries:
            _lstm_fwd_entries[name] = planted_all(
                *build, [LK.KERNEL_FWD, LK.KERNEL_FI, LK.KERNEL_BWD])
    return _lstm_fwd_entries


def lstm_fwd_faults_caught(builds, fwd, want, remat_vs_stored) -> dict:
    """LSTM_FWD_FAULTS at one shape, each library in place of the f32
    forward, fused-input forward and backward entries: with one TF32 pass,
    ``fwd()`` (the shape's forward kernel) must lie over TOL x max(1,
    |ref|) from ``want`` (its twin's outputs) on some output; with the
    remat product through another routine, ``remat_vs_stored()`` (whether
    the backward over the forward's hs, cs gives the same bits with remat
    and with the stored slab) must say no.  Returns each fault's
    measure."""
    from paddle_tpu_torch.ops.kernels import lstm as LK

    entries = lstm_fwd_fault_entries(builds)
    kernels = (LK.KERNEL_FWD, LK.KERNEL_FI, LK.KERNEL_BWD)
    real = [k._fn or k._resolve() for k in kernels]

    def swap(fns):
        for k, fn in zip(kernels, fns):
            k._fn = fn

    try:
        swap(entries["fwd_tf32_one_pass"])
        one = max((g - w).abs().max().item()
                  / max(1.0, w.abs().max().item())
                  for g, w in zip(fwd(), want) if g is not None)
        swap(entries["remat_other_routine"])
        same = remat_vs_stored()
        torch.cuda.synchronize()
    finally:
        swap(real)
    out = {"fwd_tf32_one_pass_err": one,
           "remat_other_routine_same_bits": same}
    if not one > TOL or same:
        raise AssertionError(f"lstm forward planted faults passed: {out}")
    return out


def lstm_remat_vs_stored(xw, mask, w_h, peep, h0, c0, hs, cs, gates, dhs,
                         reverse=False) -> bool:
    """Whether the f32 backward over the forward's hs, cs gives the same
    bits with remat (the product recomputed in a block of 32U threads)
    and with the forward's gates slab (from its block of at least 8
    warps)."""
    from paddle_tpu_torch.ops.kernels import lstm as LK

    zeros = torch.zeros_like(h0)
    args = (mask, w_h, peep, h0, c0, hs, cs, dhs, zeros, zeros, reverse)
    remat = LK._bwd_kernel(xw, None, *args, True)
    stored = LK._bwd_kernel(None, gates, *args, False)
    return all(torch.equal(x, y) for x, y in zip(remat, stored))


def check_text_kernels(dev, timer, b=64, t=128, d=1280, length=100,
                       n_ids=8192, vocab=30000, embed=128,
                       fwd_faults=None) -> tuple:
    """The text path's kernels at its shapes, each against its plain twin
    (max abs error <= TOL * max(1, |ref|)): the LSTM forward (writing its
    gates slab, as the card's stored-gates path runs it; timed without the
    slab beside) and backward (the stored-gates form the path runs, and
    the remat form, which must give the same bits, timed beside) at B 64,
    T 128, D 1280 with lengths 100, the backward's planted faults
    (``LSTM_BWD_FAULTS``: each over TOL) and the forward product's
    (``LSTM_FWD_FAULTS``, ``fwd_faults`` their builds: one TF32 pass over
    TOL, the remat product through another routine breaking remat ==
    stored); the gather of 8,192 ids from
    [30000, 128]
    and the table gradient (zeros plus the scatter-add of 8,192 rows), a
    rerun bit-identical, and its grouping passes alone, equal to their
    twin in integers (a planted grouping that reverses each run must
    not be).  Library yardsticks: cuDNN's ``nn.LSTM``
    (no peepholes, input projection included; the fc plus the kernel is
    timed beside it), ``F.embedding`` and its backward."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import embedding as EK
    from paddle_tpu_torch.ops.kernels import lstm as LK

    fault_builds = source_fault_builds("embedding",
                                       {**GROUP_FAULTS, **GATHER_FAULTS})
    lstm_faults = source_fault_builds("lstm_seq", LSTM_BWD_FAULTS)
    fwd_faults = fwd_faults or source_fault_builds("lstm_seq",
                                                   LSTM_FWD_FAULTS)
    gen = torch.Generator(device=dev).manual_seed(7)
    lens = torch.full((b,), length, device=dev)
    mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).float()
    xw = 0.5 * torch.randn(b, t, 4 * d, generator=gen, device=dev)
    w_h = torch.randn(d, 4 * d, generator=gen, device=dev) / d ** 0.5
    peep = 0.1 * torch.randn(3, d, generator=gen, device=dev)
    h0 = torch.zeros(b, d, device=dev)
    c0 = torch.zeros(b, d, device=dev)
    dhs = torch.randn(b, t, d, generator=gen, device=dev)
    dh_t, dc_t = torch.zeros(b, d, device=dev), torch.zeros(b, d, device=dev)

    def worst(got, want):
        e = 0.0
        for x, y in zip(got, want):
            err = (x - y).abs().max().item()
            if not err <= TOL * max(1.0, y.abs().max().item()):
                raise AssertionError(f"text kernel vs plain: {err}")
            e = max(e, err)
        return e

    fwd = lambda: LK._fwd_kernel(xw, mask, w_h, peep, h0, c0, False, True)
    no_slab = lambda: LK._fwd_kernel(xw, mask, w_h, peep, h0, c0, False,
                                     False)
    fwd_plain = lambda: LK._fwd_plain(xw, mask, w_h, peep, h0, c0, False,
                                      True)
    hs, cs, gates, _, _ = got = fwd()
    fwd_err = worst(got, fwd_plain())
    if not all(g is None or torch.equal(g, s)
               for g, s in zip(no_slab(), got)):
        raise AssertionError("lstm forward: writing the gates slab changes "
                             "the outputs' bits")
    args = (mask, w_h, peep, h0, c0, hs, cs, dhs, dh_t, dc_t, False)
    bwd = lambda: LK._bwd_kernel(xw, None, *args, True)
    stored_bwd = lambda: LK._bwd_kernel(None, gates, *args, False)
    remat = bwd()
    stored = stored_bwd()
    again = bwd()
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) and torch.equal(x, z)
               for x, y, z in zip(remat, stored, again)):
        raise AssertionError("lstm backward: remat, stored gates and a rerun "
                             "differ in bits on the card")
    bwd_plain = lambda: LK._bwd_plain(xw, None, *args, True)
    stored_plain = lambda: LK._bwd_plain(None, gates, *args, False)
    want_bwd = bwd_plain()
    bwd_err = worst(stored, stored_plain())
    worst(remat, want_bwd)
    real = LK.KERNEL_BWD._fn or LK.KERNEL_BWD._resolve()
    bwd_faults = {}
    for name, build in lstm_faults.items():
        LK.KERNEL_BWD._fn = planted(*build, LK.KERNEL_BWD)
        try:
            bad = bwd()
            torch.cuda.synchronize()
        finally:
            LK.KERNEL_BWD._fn = real
        bwd_faults[name] = max(
            (x - y).abs().max().item() / max(1.0, y.abs().max().item())
            for x, y in zip(bad, want_bwd))
        del bad
    if not all(e > TOL for e in bwd_faults.values()):
        raise AssertionError(f"lstm backward planted faults (each one's "
                             f"error over max(1, |ref|)): {bwd_faults}")
    fwd_fault_measures = lstm_fwd_faults_caught(
        fwd_faults, lambda: LK._fwd_kernel(xw, mask, w_h, peep, h0, c0, False,
                                           True),
        LK._fwd_plain(xw, mask, w_h, peep, h0, c0, False, True),
        lambda: lstm_remat_vs_stored(xw, mask, w_h, peep, h0, c0, hs, cs,
                                     gates, dhs))
    del stored, again, want_bwd

    # yardsticks: cuDNN's LSTM over the 128-wide embeddings, and the
    # port's fc (x @ W_x + b) plus the forward kernel over the same input
    x_emb = torch.randn(b, t, embed, generator=gen, device=dev)
    w_x = torch.randn(embed, 4 * d, generator=gen, device=dev) / embed ** 0.5
    bias = torch.zeros(4 * d, device=dev)
    cudnn = torch.nn.LSTM(embed, d, batch_first=True).to(dev)
    x_lib = x_emb.clone().requires_grad_()
    out_lib, _ = cudnn(x_lib)
    g_lib = torch.randn_like(out_lib)
    lib_params = (x_lib, *cudnn.parameters())
    def lib_fwd():
        with torch.no_grad():
            return cudnn(x_emb)

    fc_fwd = lambda: LK._fwd_kernel(
        (x_emb.reshape(-1, embed) @ w_x + bias).reshape(b, t, 4 * d), mask,
        w_h, peep, h0, c0, False, False)
    steps = float(lens.sum().item())          # the steps the data needs
    cell = 25.0 * steps * d                   # gate bundle per unit-step
    f32 = 4.0
    rows = [{
        "name": "lstm_seq_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/lstm_seq.cu",
        "replaces": "paddle_tpu/ops/pallas/lstm.py:489",
        "shape": [b, t, d], "max_abs_err": fwd_err,
        "planted_faults": fwd_fault_measures,
        "ms": timer(fwd), "plain_ms": timer(fwd_plain),
        # xw, W_h, peep, h0, c0, mask in; hs, cs, the gates slab, h_T,
        # c_T out; the product on the tensor cores as 3xTF32 (the lesser
        # bound)
        "bytes_flops": (f32 * (2 * b * t * 4 * d + d * 4 * d + 3 * d
                               + 4 * b * d + b * t + 2 * b * t * d),
                        2.0 * steps * d * 4 * d + cell),
        "bound_rule": bound_3xtf32,
        "alone_ms": device_ms([fwd], "lstm_fwd_kernel"),
        "no_slab_ms": timer(no_slab),
        "no_slab_alone_ms": device_ms([no_slab], "lstm_fwd_kernel"),
        "library_ms": timer(lib_fwd),
        "fc_plus_kernel_ms": timer(fc_fwd)}, {
        "name": "lstm_seq_bwd_stored", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/lstm_seq.cu",
        "replaces": "paddle_tpu/ops/pallas/lstm.py:310",
        "shape": [b, t, d], "max_abs_err": bwd_err,
        "planted_faults": bwd_faults,
        "ms": timer(stored_bwd),
        "alone_ms": device_ms([stored_bwd], "lstm_bwd_kernel"),
        "plain_ms": timer(stored_plain),
        # the gates slab, mask, W_h, peep, h0, c0, hs, cs, dhs, dh_T,
        # dc_T in; dgates, dh0, dc0, dpeep out; dgates @ W_h^T on the
        # tensor cores as 3xTF32 (the lesser bound); no remat product
        "bytes_flops": (f32 * (2 * b * t * 4 * d + d * 4 * d + 6 * d
                               + 6 * b * d + b * t + 3 * b * t * d),
                        2.0 * steps * d * 4 * d + cell),
        "bound_rule": bound_3xtf32,
        # the remat form over xw (the same bits), off the text path since
        # the stored slab fits: its times and bound (the remat product
        # besides)
        "remat_ms": timer(bwd),
        "remat_alone_ms": device_ms([bwd], "lstm_bwd_kernel"),
        "remat_bound_ms": bound_3xtf32(
            f32 * (2 * b * t * 4 * d + d * 4 * d + 6 * d + 6 * b * d + b * t
                   + 3 * b * t * d), 4.0 * steps * d * 4 * d + 2 * cell)[0],
        "library_ms": timer(lambda: torch.autograd.grad(
            out_lib, lib_params, g_lib, retain_graph=True))}]
    del xw, dhs, hs, cs, gates, remat, out_lib, g_lib, lib_params, x_lib
    del cudnn

    ids = torch.randint(0, vocab, (n_ids,), generator=gen, device=dev)
    table = torch.randn(vocab, embed, generator=gen, device=dev)
    ct = torch.randn(n_ids, embed, generator=gen, device=dev)
    uniq = float(torch.unique(ids).numel())
    got = EK.embedding_gather(table, ids)
    torch.cuda.synchronize()
    if not torch.equal(got, EK.embedding_gather_reference(table, ids)):
        raise AssertionError("gather kernel differs from its twin")
    gathered = gather_checks(table, ids, fault_builds["padding_not_zeroed"])
    grad = EK.table_grad(ids, ct, vocab)
    if not torch.equal(grad, EK.table_grad(ids, ct, vocab)):
        raise AssertionError("table gradient: a rerun differs in bits")
    zeros = torch.zeros(vocab, embed, device=dev)
    scatter_err = worst([grad], [EK.embedding_scatter_add_reference(
        zeros, ids, ct)])
    want_groups = EK.group_ids_reference(ids.cpu(), vocab)
    if not all(torch.equal(g.cpu(), w) for g, w in zip(
            EK.group_ids(ids, vocab), want_groups)):
        raise AssertionError("the grouping passes differ from their twin")
    # the planted fault: each run placed in reverse (an unstable grouping)
    fn = EK.KERNEL_GROUP._fn or EK.KERNEL_GROUP._resolve()
    EK.KERNEL_GROUP._fn = planted(*fault_builds["runs_reversed"],
                                  EK.KERNEL_GROUP)
    try:
        bad = EK.group_ids(ids, vocab)
    finally:
        EK.KERNEL_GROUP._fn = fn
    group_fault = {"counts_equal": torch.equal(bad[0].cpu(), want_groups[0]),
                   "order_equal": torch.equal(bad[2].cpu(), want_groups[2])}
    if group_fault["order_equal"]:
        raise AssertionError("a grouping that reverses each run passed the "
                             f"twin's order: {group_fault}")
    passes = device_passes_ms([lambda: EK.table_grad(ids, ct, vocab)],
                              SCATTER_PASSES + ("sum_runs_kernel<float",))
    group_alone = device_passes_ms([lambda: EK.group_ids(ids, vocab)],
                                   SCATTER_PASSES)
    rows += [{
        "name": "embedding_gather", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/embedding.cu",
        "replaces": "paddle_tpu/ops/pallas/tpp/embedding.py:120",
        "shape": [n_ids, vocab, embed], "unique_ids": int(uniq),
        "max_abs_err": 0.0,
        "ms": timer(lambda: EK.embedding_gather(table, ids)),
        "alone_ms": gathered["alone_ms"], "host_ms": gathered["host_ms"],
        "plain_ms": timer(lambda: EK.embedding_gather_reference(table, ids)),
        # the unique rows read once, every output row written, the ids
        "bytes_flops": (f32 * (uniq + n_ids) * embed + 8.0 * n_ids, 0.0),
        "library_ms": timer(lambda: F.embedding(ids, table))}, {
        "name": "embedding_scatter_add", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/embedding.cu",
        "replaces": "paddle_tpu/ops/pallas/tpp/embedding.py:192",
        "shape": [n_ids, vocab, embed], "unique_ids": int(uniq),
        "max_abs_err": scatter_err,
        # as the backward runs it: one call, the grouping passes and the
        # output pass (zeros where no id lands)
        "ms": timer(lambda: EK.table_grad(ids, ct, vocab)),
        "host_ms": host_ms(lambda: EK.table_grad(ids, ct, vocab)),
        "alone_ms": passes["total"], "passes_ms": passes,
        "plain_ms": timer(lambda: EK.embedding_scatter_add_reference(
            torch.zeros(vocab, embed, device=dev), ids, ct)),
        # the cotangent rows and ids read, the dense gradient written
        "bytes_flops": (f32 * (n_ids * embed + vocab * embed) + 8.0 * n_ids,
                        float(n_ids * embed)),
        "library_ms": timer(lambda: torch.ops.aten.embedding_dense_backward(
            ct, ids, vocab, -1, False))}, {
        "name": "embedding_group_ids", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/embedding.cu",
        "replaces": "paddle_tpu/ops/pallas/tpp/embedding.py:192 (the "
                    "scatter-add's grouping of ids; no kernel of its own "
                    "there: the one-hot contraction needs none)",
        "shape": [n_ids, vocab], "max_abs_err": 0.0,
        "ms": timer(lambda: EK.group_ids(ids, vocab)),
        "alone_ms": group_alone["total"], "passes_ms": group_alone,
        "plain_ms": timer(lambda: EK.group_ids_reference(ids, vocab)),
        # the ids read; counts, offsets and order written; integer adds
        "bytes_flops": (8.0 * n_ids + 4.0 * (2 * vocab + 1 + n_ids),
                        float(n_ids + vocab)),
        "library_ms": timer(lambda: torch.sort(ids, stable=True)),
        "library_note": "torch.sort(ids, stable=True): the order alone"}]
    for row in rows:
        row["bound_ms"], row["bound_by"] = row.pop("bound_rule", bound)(
            *row.pop("bytes_flops"))
    summary = {"phase": "text_kernels", "tol": TOL,
               "lstm_bwd_remat_stored_rerun_bit_identical": True,
               "lstm_fwd_planted_faults": fwd_fault_measures,
               "table_grad_rerun_bit_identical": True,
               "gather_bit_identical_to_twin": True,
               "gather": gathered["summary"],
               "lookup_forward": {**gathered["lookup"], "ms": timer(
                   gathered["lookup_fn"])},
               "group_ids_equal_to_twin": True,
               "planted_faults": {"runs_reversed": group_fault}}
    torch.cuda.synchronize()
    return rows, summary


def text_loss_and_grads(topo, cost_name, params, feed):
    """(loss, {name: gradient}) of one train-mode forward of ``topo``."""
    leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
    values, _ = topo.forward(leaves, {}, feed, True)
    loss = values[cost_name]
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def train_text(dev, hidden=1280, vocab=30000, embed=128, bs=64, seqlen=100,
               steps=10) -> tuple[dict, tuple]:
    """The LSTM text classifier through the v2 flow (``bench_lstm``'s
    configuration): the batch-2 step against a float64 witness, then
    2 warm-up and ``steps`` timed ``trainer.SGD`` steps at batch 64 with
    exact launch counts, a bit-identical rerun, a 3-step profile, and
    ``test`` on 2 batches."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.config.topology import Topology
    from paddle_tpu_torch.core.dtype import set_policy
    from paddle_tpu_torch.core.parameters import Parameters
    from paddle_tpu_torch.layers.base import reset_name_counters
    from paddle_tpu_torch.ops.kernels import embedding as EK
    from paddle_tpu_torch.ops.kernels import lstm as LK
    from paddle_tpu_torch.reader.feeder import DataFeeder

    t0 = time.perf_counter()
    reset_name_counters()
    cost = text_classifier(hidden, vocab, embed)
    topo = Topology(cost)
    created = paddle.parameters.create(cost)       # generator seeded 0
    carried = {n: created[n] for n in created.names()}
    # the LSTM's gate biases and peepholes start at 0; make them nonzero
    # so the witness sees every term of the cell
    rng = np.random.default_rng(0)
    for n in carried:
        if n.startswith("___lstmemory") and n.endswith(".wbias"):
            carried[n] = (0.1 * rng.standard_normal(carried[n].shape)
                          ).astype(np.float32)
    n_params = int(sum(v.size for v in carried.values()))

    def batches(k, b, lo=seqlen, hi=seqlen):
        return [[(rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1))
                               ).tolist(), int(rng.integers(0, 2)))
                 for _ in range(b)] for _ in range(k)]

    # (a) one step at batch 2 with ragged lengths (T = 16 after bucketing)
    # from the same weights: the card's kernels in f32 and the CPU's plain
    # twins in f32, each against the CPU's plain twins in float64, by the
    # loss and every gradient leaf.  TF32 allowed in cuBLAS on the card,
    # and a CPU backward whose dc carry drops its peephole terms, are the
    # planted faults the limit must catch.
    small = batches(1, 2, 7, 12)[0]
    types = {n: paddle.data_type.InputType(
        dim=l.attrs["dim"], seq_type=l.attrs["seq_type"],
        kind=l.attrs["data_type"]) for n, l in topo.data_layers().items()}

    def side(where, dtype=torch.float32):
        feed = DataFeeder(types, device=where)(small)
        params = {n: torch.from_numpy(v).to(where, dtype)
                  for n, v in carried.items()}
        return text_loss_and_grads(topo, cost.name, params, feed)

    loss64, g64 = side("cpu", torch.float64)
    sides = {"cpu": side("cpu"), "card": side(dev)}
    rerun = side(dev)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        sides["card_tf32_control"] = side(dev)
    finally:
        set_policy()
    plain_bwd = LK._bwd_plain

    def dc_peephole_dropped(xw, gates, mask, w_h, peep, *rest):
        keep_o = torch.tensor([[0.0], [0.0], [1.0]], dtype=peep.dtype)
        return plain_bwd(xw, gates, mask, w_h, peep * keep_o, *rest)

    LK._bwd_plain = dc_peephole_dropped
    try:
        sides["cpu_dc_peephole_dropped_control"] = side("cpu")
    finally:
        LK._bwd_plain = plain_bwd
    if not (torch.equal(rerun[0], sides["card"][0]) and all(
            torch.equal(rerun[1][n], sides["card"][1][n]) for n in g64)):
        raise AssertionError("the card's text step is not bit-identical on "
                             "a rerun")
    witness = {"batch": 2, "lengths": [len(x) for x, _ in small],
               "loss_f64": float(loss64), "loss_rtol": TEXT_LOSS_RTOL,
               "grad_limit": TEXT_GRAD_LIMIT}
    for label, (loss, grads) in sides.items():
        ratios = {n: rel_norm(grads[n], g64[n]) for n in g64}
        worst = max(ratios, key=ratios.get)
        witness[label] = {"loss": float(loss),
                          "loss_rel_err": abs(float(loss) - float(loss64))
                          / abs(float(loss64)),
                          "grad_worst": ratios[worst],
                          "grad_worst_leaf": worst}
    del sides, rerun, g64
    for label in ("cpu", "card"):
        w = witness[label]
        if not (w["loss_rel_err"] <= TEXT_LOSS_RTOL
                and w["grad_worst"] <= TEXT_GRAD_LIMIT):
            raise AssertionError(f"{label} text step vs the f64 witness: "
                                 f"{witness}")
    for label in ("card_tf32_control", "cpu_dc_peephole_dropped_control"):
        if witness[label]["grad_worst"] <= TEXT_GRAD_LIMIT:
            raise AssertionError(f"the text witness limit does not catch "
                                 f"{label}: {witness}")

    # (b) trainer.SGD at the bench's configuration: Adam 2e-3 with bf16
    # moments, batch 64 of 100-token sequences (T = 128 after bucketing)
    def trainer():
        return paddle.trainer.SGD(
            cost=cost, parameters=Parameters.from_numpy(carried),
            update_equation=paddle.optimizer.Adam(
                learning_rate=2e-3, moment_dtype=torch.bfloat16),
            device=dev)

    def run(tr, data, handler=None):
        out = []

        def h(e):
            if isinstance(e, paddle.event.EndIteration):
                out.append((e.cost, e.metrics[
                    "classification_error_evaluator"]))
            if handler is not None:
                handler(e)

        tr.train(reader=lambda: iter(data), num_passes=1, event_handler=h)
        return out

    warm, data, test_data = batches(2, bs), batches(steps, bs), batches(2, bs)
    one = [data[0]]
    first = [trainer() for _ in range(2)]
    reruns = [(run(tr, one), {n: tr.parameters[n] for n in carried})
              for tr in first]
    if not (reruns[0][0] == reruns[1][0] and all(
            np.array_equal(reruns[0][1][n], reruns[1][1][n])
            for n in carried)):
        raise AssertionError("trainer.SGD's first text step is not "
                             "bit-identical on a rerun")
    del first, reruns
    tr = trainer()
    run(tr, warm)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    marks: dict[int, list] = {}

    def stamp(e):
        if isinstance(e, (paddle.event.BeginIteration,
                          paddle.event.EndIteration)):
            marks.setdefault(e.batch_id, []).append(time.perf_counter())

    # the backward's two forms counted apart: the stored-gates form where
    # the slab fits (``ops.rnn.stored_slab_fits``), none of the remat form
    names = ("lstm_fwd", "lstm_bwd_stored", "lstm_bwd_remat", "gather",
             "scatter_add", "group_ids")
    kernels = (LK.KERNEL_FWD, LK.KERNEL_BWD_STORED, LK.KERNEL_BWD,
               EK.KERNEL_GATHER, EK.KERNEL_SCATTER, EK.KERNEL_GROUP)
    for k in kernels:
        k.launches = 0
    t1 = time.perf_counter()
    events = run(tr, data, stamp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = tuple(k.launches for k in kernels)
    peak = torch.cuda.max_memory_allocated(dev)
    if launches != (steps, steps, 0, steps, steps, steps):
        raise AssertionError(f"text train launches "
                             f"{dict(zip(names, launches))} != {steps} each "
                             f"and no remat backward")
    losses = [c for c, _ in events]
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"text train losses {losses}")
    step_ms = [1e3 * (b - a) for a, b in marks.values()]
    traced = batches(3, bs)
    prof = profile_window(lambda: run(tr, traced), 3)
    for k in kernels:
        k.launches = 0
    # the forward alone (test mode, 2 batches) under the profiler: its
    # trace must hold no library sort (the lookup's dedup is gone)
    tested = {}
    fwd_prof = profile_window(lambda: tested.setdefault("r", tr.test(
        reader=lambda: iter(test_data))), 2)
    result = tested["r"]
    if fwd_prof.get("library_sort_kernels"):
        raise AssertionError(f"the text forward's trace holds a library "
                             f"sort: {fwd_prof['library_sort_kernels']}")
    test_n = tuple(k.launches for k in kernels)
    if test_n != (2, 0, 0, 2, 0, 0) or not np.isfinite(result.cost):
        raise AssertionError(f"text test launches {test_n} != (2, 0, 0, 2, "
                             f"0, 0) or cost {result.cost}")
    p50 = float(np.percentile(step_ms, 50))
    if "device_busy_ms_per_step" in prof:
        prof["idle_share_vs_step_p50"] = (
            1 - prof["device_busy_ms_per_step"] / p50)
    out = {"phase": "train_text", "model": "LSTM text classifier "
           "(bench.py _lstm_classify_cost)", "params": n_params,
           "hidden": hidden, "vocab": vocab, "embed": embed,
           "dtype": "float32", "adam_moments": "bfloat16", "lr": 2e-3,
           "step_vs_f64_witness": witness, "rerun_bit_identical": True,
           "batch": bs, "tokens_per_sequence": seqlen,
           "bucketed_T": tr._feeder(None)(data[0])["data"].max_len,
           "steps": steps, "wall_s": wall,
           "sequences_per_s": bs * steps / wall, "step_ms_p50": p50,
           "step_ms": step_ms, "losses": losses,
           "classification_error": [m for _, m in events],
           "max_memory_allocated_bytes": peak,
           "train_launches": dict(zip(names, launches)),
           "test_launches": dict(zip(names, test_n)),
           "test_batches": 2, "test_cost": result.cost,
           "test_forward_library_sort_kernels":
               fwd_prof.get("library_sort_kernels"),
           "test_metrics": result.metrics, "setup_s": setup_s,
           "profile": prof}
    print(json.dumps({"train_text_step_ms_p50": p50,
                      "max_memory_allocated_bytes": peak,
                      "lstm_bwd_stored": launches[1],
                      "lstm_bwd_remat": launches[2]}), flush=True)
    # the rows' launches: the forward, the stored-gates backward the path
    # runs, the gather, the scatter-add and its grouping
    return out, launches[:2] + launches[3:]


CRNN_COST_RTOL = 1e-5    # f32 CRNN step vs the f64 witness: cost, and per
CRNN_LEAF_FLOOR = 1e-4   # leaf the witness ratio's least limit (see below)


def crnn_feed_batches(rng, k, bs, classes):
    """``bench_crnn``'s synthetic batches: N(0, 1) 32x96 images and labels
    of 5 ids (the feeder pads the label slot to its bucket, 16)."""
    return [[(rng.standard_normal(32 * 96, dtype=np.float32),
              rng.integers(0, classes, size=5).tolist())
             for _ in range(bs)] for _ in range(k)]


#: planted faults of the CRNN's two redesigned kernels, {source: {fault:
#: (line, planted line)}}: the f32 BiLSTM reads its peers' h from the
#: other parity (h_{t-2}, and the buffer the step writes); the decode drops
#: the kept count carried across its 256-frame chunks
CRNN_FAULTS = {
    "bilstm_seq": {"h_other_parity": (
        "    const float* h_cur = h_s + (s & 1) * D * kRows;",
        "    const float* h_cur = h_s + ((s + 1) & 1) * D * kRows;  "
        "// planted")},
    "ctc": {"scan_carry_dropped": (
        "    int base = kept;   // this warp's first slot in the row",
        "    int base = 0;   // planted: the carry across chunks dropped")}}


def fault_caught(kernel, build, run) -> bool:
    """Whether ``run()`` raises an AssertionError (its check fails) with a
    planted fault's library (``build``: the process and the path of
    :func:`source_fault_builds`) in place of ``kernel``'s C entry."""
    real = kernel._fn or kernel._resolve()
    kernel._fn = planted(*build, kernel)
    try:
        run()
        torch.cuda.synchronize()
    except AssertionError:
        return True
    finally:
        kernel._fn = real
    return False


def check_crnn_kernels(dev, timer, b=64, t=24, e=256, d=64, v=27, l=16,
                       label_len=5, fwd_faults=None) -> tuple:
    """The OCR CRNN's kernels at its shapes, each against its plain twin
    (max abs error <= TOL * max(1, |ref|); the decode bit for bit), a rerun
    bit-identical: the BiLSTM forward (x [64, 24, 256], D 64, both
    directions); the LSTM backward kernel in the remat form the BiLSTM's
    backward launches, once per direction, over the forward's own hs/cs
    and the recomputed projection (xw [64, 24, 256]); the CTC
    forward-backward on log-probs [64, 24, 27] with
    labels of 5 in a 16-slot (S = 33), in both ``normalize`` forms; the
    greedy decode of the same slab; and the direct conv with the BN
    statistics epilogue at the CRNN's two 3x3 convs (conv1's Cin = 1).
    Library yardsticks: cuDNN's bidirectional ``nn.LSTM`` (input
    projection included, no peepholes) and the backward of its
    one-direction form, ``F.ctc_loss`` forward and
    backward by the log-probs, and ``torch.argmax`` over the slab (the
    decode's read floor; no single call decodes) and, for the decode,
    the eager ``ops/ctc.ctc_greedy_decode``.  The BiLSTM and the decode
    also report their device time alone (a trace), the host's ms a call
    and the planted faults of ``CRNN_FAULTS``, which must fail.  At D 64
    (U 1: the backward's block is one warp) row 5's forward over the
    forward direction's projection against its twin, its backward with
    remat and over its gates slab in the same bits, and the forward
    product's planted faults (``LSTM_FWD_FAULTS``, ``fwd_faults`` their
    builds)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import ctc as ctc_ops
    from paddle_tpu_torch.ops.kernels import conv as CV
    from paddle_tpu_torch.ops.kernels import ctc as KC
    from paddle_tpu_torch.ops.kernels import lstm as LK

    builds = {src: source_fault_builds(src, faults)
              for src, faults in CRNN_FAULTS.items()}
    fwd_faults = fwd_faults or source_fault_builds("lstm_seq",
                                                   LSTM_FWD_FAULTS)
    gen = torch.Generator(device=dev).manual_seed(8)
    rnd = lambda *s, k=1.0: k * torch.randn(*s, generator=gen, device=dev)  # noqa: E731

    def worst(got, want, what):
        err = 0.0
        for x, y in zip(got, want):
            if x is None:
                continue
            m = (x - y).abs().max().item()
            if not m <= TOL * max(1.0, y.abs().max().item()):
                raise AssertionError(f"{what} kernel vs plain: {m}")
            err = max(err, m)
        return err

    # the BiLSTM forward: zero initial states, every row the full T
    x = rnd(b, t, e)
    mask = torch.ones(b, t, device=dev)
    zeros = torch.zeros(b, d, device=dev)
    fw, bw = ((rnd(e, 4 * d, k=e ** -0.5), rnd(4 * d, k=0.1),
               rnd(d, 4 * d, k=d ** -0.5), rnd(3, d, k=0.3), zeros, zeros)
              for _ in range(2))
    bi = lambda: LK._bi_fwd_kernel(x, mask, fw, bw)  # noqa: E731
    bi_plain = lambda: LK._bi_fwd_plain(x, mask, fw, bw)  # noqa: E731
    got, again = bi(), bi()
    torch.cuda.synchronize()
    if not all(torch.equal(p, q) for g, a in zip(got, again)
               for p, q in zip(g, a)):
        raise AssertionError("bilstm kernel: a rerun differs in bits")
    want_bi = bi_plain()
    bi_err = max(worst(g, w, "bilstm") for g, w in zip(got, want_bi))
    faults = {"bilstm_h_other_parity": fault_caught(
        LK.KERNEL_BI, builds["bilstm_seq"]["h_other_parity"],
        lambda: [worst(g, w, "bilstm") for g, w in zip(bi(), want_bi)])}
    del want_bi
    cudnn = torch.nn.LSTM(e, d, batch_first=True, bidirectional=True).to(dev)

    def lib_lstm():
        with torch.no_grad():
            return cudnn(x)

    # the LSTM backward kernel as the BiLSTM's backward launches it: remat,
    # over the recomputed projection and the forward kernel's hs/cs, with
    # a random cotangent on hs and zeros on (h_T, c_T), once per direction
    bwd_calls, bwd_err = {}, 0.0
    for (w_x, bias, w_h, peep, h0, c0), (hs, cs, _, _), reverse in (
            (fw, got[0], False), (bw, got[1], True)):
        xw = LK._project_xw(x, w_x, bias)
        args = (mask, w_h, peep, h0, c0, hs, cs, rnd(b, t, d), zeros, zeros,
                reverse)
        bwd_calls[reverse] = (
            lambda xw=xw, args=args: LK._bwd_kernel(xw, None, *args, True),
            lambda xw=xw, args=args: LK._bwd_plain(xw, None, *args, True))
        first, rerun = bwd_calls[reverse][0](), bwd_calls[reverse][0]()
        torch.cuda.synchronize()
        if not all(torch.equal(p, q) for p, q in zip(first, rerun)):
            raise AssertionError("lstm backward at the crnn shapes: a rerun "
                                 "differs in bits")
        bwd_err = max(bwd_err, worst(first, bwd_calls[reverse][1](),
                                     "lstm backward (crnn)"))
    del first, rerun
    # row 5's forward at U 1 over the forward direction's projection: the
    # product in a block of 8 warps, recomputed by the backward's one warp
    xw = LK._project_xw(x, fw[0], fw[1])
    lstm_args = (xw, mask, *fw[2:], False, True)
    fwd_out = LK._fwd_kernel(*lstm_args)
    fwd_want = LK._fwd_plain(*lstm_args)
    worst(fwd_out, fwd_want, "lstm forward (crnn)")
    dhs = rnd(b, t, d)
    if not lstm_remat_vs_stored(xw, mask, *fw[2:], *fwd_out[:3], dhs):
        raise AssertionError("lstm backward at D 64: remat and the stored "
                             "slab differ in bits")
    lstm_fwd = lstm_fwd_faults_caught(
        fwd_faults, lambda: LK._fwd_kernel(*lstm_args), fwd_want,
        lambda: lstm_remat_vs_stored(xw, mask, *fw[2:], *fwd_out[:3], dhs))
    del xw, fwd_out, fwd_want
    cudnn1 = torch.nn.LSTM(e, d, batch_first=True).to(dev)
    x_lib = x.clone().requires_grad_()
    out_lib, _ = cudnn1(x_lib)
    g_lib = torch.randn_like(out_lib)
    lib_params = (x_lib, *cudnn1.parameters())

    steps = float(mask.sum().item())          # row-steps of one direction
    f32 = 4.0
    cell = 25.0 * steps * d                   # gate bundle per unit-step
    bwd_ms = {r: timer(calls[0]) for r, calls in bwd_calls.items()}
    bwd_plain_ms = {r: timer(calls[1]) for r, calls in bwd_calls.items()}
    rows = [{
        "name": "bilstm_seq", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/bilstm_seq.cu",
        "replaces": "paddle_tpu/ops/pallas/lstm.py:934",
        "shape": [b, t, e, d], "max_abs_err": bi_err,
        "plan": LK._bi_launch(x.device, b, t, e, d)[0]._asdict(),
        "ms": timer(bi), "plain_ms": timer(bi_plain),
        "alone_ms": device_ms([bi], "bilstm_cluster_kernel"),
        "host_ms": host_ms(bi),
        # x, mask, both directions' W_x, b, W_h, peep, h0, c0 in; hs, cs,
        # h_T, c_T of both out.  The products over the valid row-steps of
        # both directions, and the cell
        "bytes_flops": (f32 * (b * t * e + b * t + 2 * (e * 4 * d + 4 * d
                                                        + d * 4 * d + 3 * d
                                                        + 2 * b * d)
                               + 2 * (2 * b * t * d + 2 * b * d)),
                        2 * (2.0 * steps * (e + d) * 4 * d + cell)),
        "library_ms": timer(lib_lstm)}, {
        "name": "lstm_seq_bwd_crnn", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/lstm_seq.cu",
        "replaces": "paddle_tpu/ops/pallas/lstm.py:426",
        "shape": [b, t, d], "max_abs_err": bwd_err,
        # one launch: the mean of the two directions' times
        "ms": (bwd_ms[False] + bwd_ms[True]) / 2,
        "alone_ms": device_ms([c[0] for c in bwd_calls.values()],
                              "lstm_bwd_kernel"),
        "plain_ms": (bwd_plain_ms[False] + bwd_plain_ms[True]) / 2,
        "ms_by_direction": {"forward": bwd_ms[False],
                            "reverse": bwd_ms[True]},
        # xw, mask, W_h, peep, h0, c0, hs, cs, dhs, dh_T, dc_T in; dgates,
        # dh0, dc0, dpeep out; the remat product and dgates @ W_h^T (the
        # latter as 3xTF32)
        "bytes_flops": (f32 * (2 * b * t * 4 * d + d * 4 * d + 6 * d
                               + 6 * b * d + b * t + 3 * b * t * d),
                        4.0 * steps * d * 4 * d + 2 * cell),
        "bound_rule": bound_3xtf32,
        # cuDNN's one-direction LSTM backward (input and weight gradients)
        "library_ms": timer(lambda: torch.autograd.grad(
            out_lib, lib_params, g_lib, retain_graph=True))}]
    del got, again, cudnn, cudnn1, bwd_calls, out_lib, g_lib, lib_params
    del x_lib

    # the CTC forward-backward and the decode, on one log-prob slab
    lp = torch.log_softmax(rnd(b, t, v, k=2.0), -1)
    labels = torch.zeros(b, l, dtype=torch.int64, device=dev)
    labels[:, :label_len] = torch.randint(0, v - 1, (b, label_len),
                                          generator=gen, device=dev)
    ilen = torch.full((b,), t, dtype=torch.int64, device=dev)
    llen = torch.full((b,), label_len, dtype=torch.int64, device=dev)
    ext, valid, skip = ctc_ops.ctc_tables(labels, llen, v - 1)
    tables = (ext, skip, valid, ilen.to(torch.int32), llen.to(torch.int32))
    ctc_err = 0.0
    for normalize, slab in ((False, lp), (True, rnd(b, t, v, k=2.0))):
        got, again = (KC._fwd_bwd_kernel(slab, *tables, normalize)
                      for _ in range(2))
        torch.cuda.synchronize()
        if not all(torch.equal(p, q) for p, q in zip(got, again)):
            raise AssertionError("ctc kernel: a rerun differs in bits")
        ctc_err = max(ctc_err, worst(got, KC._fwd_bwd_plain(
            slab, *tables, normalize), "ctc"))
    lp_lib = lp.detach().transpose(0, 1).contiguous().requires_grad_()

    def lib_ctc():
        loss = F.ctc_loss(lp_lib, labels, ilen, llen, blank=v - 1,
                          reduction="sum")
        return torch.autograd.grad(loss, (lp_lib,))

    # the decode: the CRNN's slab, then T past the kernel's 256-frame
    # chunk, V past one 32-lane run, ragged int64 lengths with a zero,
    # small-integer scores (ties and repeats)
    def decode_twin(slab, lens):
        best, keep = KC._decode_plain(slab, lens, slab.shape[2] - 1)
        return ctc_ops.compact_decoded(best, keep.bool())

    def decode_check(slab, lens):
        n = KC.KERNEL_DECODE.launches
        got = KC.ctc_greedy_decode_fused(slab, lens, slab.shape[2] - 1)
        want = decode_twin(slab, lens)
        torch.cuda.synchronize()
        if KC.KERNEL_DECODE.launches != n + 1:
            raise AssertionError("the fused decode is not one launch")
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError("ctc decode kernel differs from its twin")

    long_slab = torch.randint(0, 3, (8, 300, 100), generator=gen,
                              device=dev).float()
    long_lens = torch.randint(0, 301, (8,), generator=gen, device=dev)
    long_lens[0], long_lens[1] = 300, 0
    for slab, lens in ((lp, ilen), (long_slab, long_lens)):
        decode_check(slab, lens)
    faults["ctc_decode_scan_carry_dropped"] = fault_caught(
        KC.KERNEL_DECODE, builds["ctc"]["scan_carry_dropped"],
        lambda: decode_check(long_slab, long_lens))
    if not all(faults.values()):
        raise AssertionError(f"a planted fault passed its check: {faults}")
    decode = lambda: KC.ctc_greedy_decode_fused(lp, ilen, v - 1)  # noqa: E731
    s = ext.shape[1]
    rows += [{
        "name": "ctc_loss_fused", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/ctc.cu",
        "replaces": "paddle_tpu/ops/pallas/ctc.py:248",
        "shape": [b, t, v, s], "max_abs_err": ctc_err,
        "ms": timer(lambda: KC._fwd_bwd_kernel(lp, *tables, False)),
        "plain_ms": timer(lambda: KC._fwd_bwd_plain(lp, *tables, False)),
        # the slab in, its gradient out, the tables and lengths, the losses;
        # the recursions' log-adds are a few flops per (t, s): bytes bound
        "bytes_flops": (f32 * (2 * b * t * v + 3 * b * s + 3 * b),
                        2 * 12.0 * b * t * s),
        "library_ms": timer(lib_ctc)}, {
        "name": "ctc_greedy_decode_fused", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/ctc.cu",
        "replaces": "paddle_tpu/ops/pallas/ctc.py:310",
        "shape": [b, t, v], "max_abs_err": 0.0,
        "ms": timer(decode), "plain_ms": timer(lambda: decode_twin(lp, ilen)),
        "alone_ms": device_ms([decode], "ctc_decode_kernel"),
        "host_ms": host_ms(decode),
        "eager_ms": timer(lambda: ctc_ops.ctc_greedy_decode(lp, ilen,
                                                            v - 1)),
        # the slab and the int64 lengths in, the ids and lengths out
        "bytes_flops": (f32 * (b * t * v + b * t + b) + 8.0 * b,
                        float(b * t * v)),
        "library_ms": timer(lambda: torch.argmax(lp, dim=2))}]
    for row in rows:
        row["bound_ms"], row["bound_by"] = row.pop("bound_rule", bound)(
            *row.pop("bytes_flops"))

    # the direct conv at the CRNN's two 3x3 s1 p1 shapes, BN stats epilogue
    conv_err = 0.0
    for shape, cout in (((b, 32, 96, 1), 16), ((b, 16, 48, 16), 32)):
        xc = rnd(*shape)
        wc = rnd(3, 3, shape[-1], cout, k=0.3)
        got = CV.fwd_raw(xc, wc, (1, 1), (1, 1), stats=True)
        again = CV.fwd_raw(xc, wc, (1, 1), (1, 1), stats=True)
        want = CV.fwd_raw_reference(xc, wc, (1, 1), (1, 1), stats=True)
        torch.cuda.synchronize()
        if not all(torch.equal(p, q) for p, q in zip(got, again)):
            raise AssertionError("crnn conv: a rerun differs in bits")
        count = got[0].numel() // cout
        conv_err = max(conv_err, worst(
            [got[0], got[1] / count, got[2] / count],
            [want[0], want[1] / count, want[2] / count], "crnn conv"))
    summary = {"phase": "crnn_kernels", "tol": TOL,
               "reruns_bit_identical": True,
               "decode_bit_identical_to_twin": True,
               "decode_shapes": [[b, t, v], list(long_slab.shape)],
               "planted_faults_caught": faults,
               "lstm_fwd_d64_remat_stored_bit_identical": True,
               "lstm_fwd_planted_faults": lstm_fwd,
               "ctc_normalize_forms": [False, True],
               "conv2d_direct_crnn_shapes_max_abs_err": conv_err}
    torch.cuda.synchronize()
    return rows, summary


def train_crnn(dev, bs=64, steps=10) -> tuple[dict, tuple]:
    """The OCR CRNN through the v2 flow (``bench_crnn``'s configuration):
    the batch-2 step against a float64 witness, ``trainer.SGD`` at batch
    64 with exact launch counts and a profile, ``paddle.infer`` and
    ``ocr_crnn.ctc_decode`` with exact launch counts, then the slow JAX
    test's convergence recipe."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.dtype import set_policy
    from paddle_tpu_torch.core.parameters import Parameters
    from paddle_tpu_torch.layers.base import reset_name_counters
    from paddle_tpu_torch.models import ocr_crnn
    from paddle_tpu_torch.ops.kernels import brgemm as BR
    from paddle_tpu_torch.ops.kernels import conv as CV
    from paddle_tpu_torch.ops.kernels import ctc as KC
    from paddle_tpu_torch.ops.kernels import lstm as LK

    classes, rnn = 26, 64
    t0 = time.perf_counter()
    reset_name_counters()
    cost, probs, order = ocr_crnn.crnn_ctc_cost(num_classes=classes,
                                                rnn_size=rnn)
    feeding = {n: i for i, n in enumerate(order)}
    created = paddle.parameters.create(cost)     # generator seeded 0
    carried = {n: created[n] for n in created.names()}
    # the BiLSTM's gate biases and peepholes start at 0; make them nonzero
    # so the witness sees every term of the cell
    rng = np.random.default_rng(0)
    for n in carried:
        if n.startswith("_crnn_bilstm") and n.endswith(".wbias"):
            carried[n] = (0.1 * rng.standard_normal(carried[n].shape)
                          ).astype(np.float32)
    n_params = int(sum(v.size for v in carried.values()))

    def trainer(where, opt=None):
        return paddle.trainer.SGD(
            cost=cost, parameters=Parameters.from_numpy(carried),
            update_equation=opt or paddle.optimizer.Adam(
                learning_rate=1e-3, moment_dtype=torch.bfloat16),
            device=where)

    def run(tr, data, handler=None):
        costs = []

        def h(e):
            if isinstance(e, paddle.event.EndIteration):
                costs.append(e.cost)
            if handler is not None:
                handler(e)

        tr.train(reader=lambda: iter(data), num_passes=1, event_handler=h,
                 feeding=feeding)
        return costs

    # (a) one step at batch 2 from the same parameters: the CPU's plain
    # twins and the card's kernels, both f32, each held against a float64
    # step on the CPU (``SGD.step_f64``) by the cost and, per parameter
    # and BN statistic, ||x32 - x64|| / ||x64 - x0||.  The witness step
    # takes plain SGD at lr 1, so its update is the gradient itself
    # (Adam's first update is lr * sign(g), blind to the gradient's
    # error, and a small lr would drown it in the f32 rounding of the
    # update).  The float64 step's own move under a 1e-6 relative nudge of
    # the input sets the limit: 10x that move, at least CRNN_LEAF_FLOOR.
    # TF32 allowed on the card, and a CPU CTC twin whose beta recursion
    # drops the s-2 skip, are the planted faults that must exceed it.
    small = crnn_feed_batches(rng, 1, 2, classes)[0]
    nudged = [(x * (1 + 1e-6 * rng.standard_normal(x.shape,
                                                    dtype=np.float32)), y)
              for x, y in small]
    sgd = lambda: paddle.optimizer.SGD(learning_rate=1.0)  # noqa: E731
    witness = trainer("cpu", sgd())
    p64, s64, c64 = witness.step_f64(small, feeding)
    start = (carried, {k: v.numpy() for k, v in witness.states.items()})
    p_n, s_n, c_n = witness.step_f64(nudged, feeding)
    sides = {"f64_nudged": (c_n, p_n, s_n)}
    del witness
    plain_shift = KC._shift_left

    def beta_skip_dropped(a, k, fill):
        out = plain_shift(a, k, fill)
        return torch.zeros_like(out) if out.dtype == torch.bool else out

    for label, where in (("cpu", "cpu"), ("card", dev), ("card_rerun", dev),
                         ("card_tf32_control", dev),
                         ("cpu_ctc_beta_skip_dropped_control", "cpu")):
        tr = trainer(where, sgd())
        if label == "card_tf32_control":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        if label.startswith("cpu_ctc"):
            KC._shift_left = beta_skip_dropped
        try:
            c = run(tr, [small])[0]
        finally:
            set_policy()
            KC._shift_left = plain_shift
        sides[label] = (c, {n: tr.parameters[n] for n in carried},
                        {k: v.cpu().numpy() for k, v in tr.states.items()})
        del tr
    (c_a, p_a, s_a), (c_b, p_b, s_b) = sides["card"], sides.pop("card_rerun")
    if not (c_a == c_b and all(np.array_equal(p_a[n], p_b[n]) for n in p_a)
            and all(np.array_equal(s_a[k], s_b[k]) for k in s_a)):
        raise AssertionError("the card's CRNN step is not bit-identical on a "
                             "rerun")
    witness_rows = {}
    for label, (c, p_side, s_side) in sides.items():
        pr, pn, pg = witness_ratio(start[0], p64, p_side)
        sr, sn, sg = witness_ratio(start[1], s64, s_side)
        witness_rows[label] = {
            "cost": c, "cost_rel_err": abs(c - c64) / abs(c64),
            "param_worst": pr, "param_worst_leaf": pn, "param_global": pg,
            "state_worst": sr, "state_worst_leaf": sn, "state_global": sg,
            "worst": max(pr, sr)}
    limit = max(CRNN_LEAF_FLOOR, 10 * witness_rows["f64_nudged"]["worst"])
    for label in ("cpu", "card"):
        w = witness_rows[label]
        if not (np.isfinite(w["cost"]) and w["cost_rel_err"] <= CRNN_COST_RTOL
                and w["worst"] <= limit):
            raise AssertionError(f"{label} CRNN step vs the f64 witness "
                                 f"(cost {c64}, limit {limit}): "
                                 f"{witness_rows}")
    for label in ("card_tf32_control", "cpu_ctc_beta_skip_dropped_control"):
        if witness_rows[label]["worst"] <= limit:
            raise AssertionError(f"the CRNN witness limit {limit} does not "
                                 f"catch {label}: {witness_rows}")

    # (b) trainer.SGD at bench_crnn's configuration: Adam 1e-3 with bf16
    # moments, batch 64, 2 warm-up steps (set-up), 10 timed steps with the
    # launch counts zeroed just before and read just after
    tr = trainer(dev)
    warm, data = (crnn_feed_batches(rng, k, bs, classes) for k in (2, steps))
    run(tr, warm)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    marks: dict[int, list] = {}

    def stamp(e):
        if isinstance(e, (paddle.event.BeginIteration,
                          paddle.event.EndIteration)):
            marks.setdefault(e.batch_id, []).append(time.perf_counter())

    kernels = {"conv2d_direct": CV.KERNEL, "bilstm_fwd": LK.KERNEL_BI,
               "lstm_fwd": LK.KERNEL_FWD, "lstm_bwd": LK.KERNEL_BWD,
               "lstm_bwd_stored": LK.KERNEL_BWD_STORED,
               "ctc_fwd_bwd": KC.KERNEL_LOSS, "ctc_decode": KC.KERNEL_DECODE,
               "brgemm": BR.KERNEL}

    def zero():
        for k in kernels.values():
            k.launches = 0

    def counts():
        return {n: k.launches for n, k in kernels.items()}

    zero()
    t1 = time.perf_counter()
    costs = run(tr, data, stamp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    train_n = counts()
    peak = torch.cuda.max_memory_allocated(dev)
    # the BiLSTM's backward stays remat (``bilstm_fused``): 2 a step, no
    # stored-gates launch
    want = {"conv2d_direct": 2, "bilstm_fwd": 1, "lstm_fwd": 0,
            "lstm_bwd": 2, "lstm_bwd_stored": 0, "ctc_fwd_bwd": 1,
            "ctc_decode": 0, "brgemm": 0}
    if train_n != {n: c * steps for n, c in want.items()}:
        raise AssertionError(f"CRNN train launches {train_n} != {want} "
                             f"x {steps}")
    if not (len(costs) == steps and all(np.isfinite(costs))
            and costs[-1] < costs[0]):
        raise AssertionError(f"CRNN costs not finite and falling: {costs}")
    step_ms = [1e3 * (b - a) for a, b in marks.values()]
    p50 = float(np.percentile(step_ms, 50))
    traced = crnn_feed_batches(rng, 3, bs, classes)
    prof = profile_window(lambda: run(tr, traced), 3)
    if "device_busy_ms_per_step" in prof:
        prof["idle_share_vs_step_p50"] = (
            1 - prof["device_busy_ms_per_step"] / p50)

    # (c) paddle.infer on 64 samples, then the greedy decode: one BiLSTM
    # forward, the two convs (eval epilogue) and one decode launch
    samples = crnn_feed_batches(rng, 1, bs, classes)[0]
    zero()
    out = paddle.infer(output_layer=probs, parameters=tr.parameters,
                       input=samples, feeding=feeding, device=dev)
    lp = torch.log(torch.from_numpy(np.stack(out)).to(dev) + 1e-9)
    lens = torch.full((len(out),), lp.shape[1], dtype=torch.int64, device=dev)
    ids, ids_len = ocr_crnn.ctc_decode(lp, lens, blank=classes)
    torch.cuda.synchronize()
    infer_n = counts()
    want_infer = dict(want, bilstm_fwd=1, lstm_bwd=0, ctc_fwd_bwd=0,
                      ctc_decode=1)
    if infer_n != want_infer or ids.shape != (bs, lp.shape[1]):
        raise AssertionError(f"CRNN infer/decode launches {infer_n} != "
                             f"{want_infer} or ids {tuple(ids.shape)}")
    del tr

    # (d) the slow JAX test's convergence recipe (tests/test_ocr_crnn.py):
    # 8 classes, rnn_size 32, Adam 3e-3, 25 passes of 512 synthetic
    # samples at batch 32; the last cost under 5% of the first, and the
    # greedy decode of 16 fresh samples (seed 123) exact on >= 13
    reset_name_counters()
    c8, p8, o8 = ocr_crnn.crnn_ctc_cost(num_classes=8, rnn_size=32)
    feed8 = {n: i for i, n in enumerate(o8)}
    tr8 = paddle.trainer.SGD(
        cost=c8, parameters=paddle.parameters.create(c8),
        update_equation=paddle.optimizer.Adam(learning_rate=3e-3),
        device=dev)
    reader = ocr_crnn.synthetic_ocr_reader(n_samples=512, num_classes=8)
    conv_costs = []
    t2 = time.perf_counter()
    tr8.train(reader=paddle.batch(reader, 32), num_passes=25,
              feeding=feed8,
              event_handler=lambda e: conv_costs.append(e.cost)
              if isinstance(e, paddle.event.EndIteration) else None)
    conv_s = time.perf_counter() - t2
    fresh = list(ocr_crnn.synthetic_ocr_reader(n_samples=16, num_classes=8,
                                               seed=123)())
    out8 = paddle.infer(output_layer=p8, parameters=tr8.parameters,
                        input=fresh, feeding=feed8, device=dev)
    lp8 = torch.log(torch.from_numpy(np.stack(out8)).to(dev) + 1e-9)
    dec, dec_len = ocr_crnn.ctc_decode(
        lp8, torch.full((16,), lp8.shape[1], dtype=torch.int64, device=dev),
        blank=8)
    dec, dec_len = dec.cpu().numpy(), dec_len.cpu().numpy()
    exact = sum(dec[i, :dec_len[i]].tolist() == labels
                for i, (_, labels) in enumerate(fresh))
    if not (conv_costs[-1] < 0.05 * conv_costs[0] and exact >= 13):
        raise AssertionError(f"CRNN convergence: cost {conv_costs[0]} -> "
                             f"{conv_costs[-1]}, {exact}/16 decoded exactly")
    del tr8

    result = {"phase": "train_crnn",
              "model": "OCR CRNN (models/ocr_crnn.crnn_ctc_cost, bench_crnn)",
              "params": n_params, "image": [32, 96, 1], "classes": classes,
              "rnn_size": rnn, "dtype": "float32", "adam_moments": "bfloat16",
              "lr": 1e-3,
              "step_vs_f64_witness": {"batch": 2, "cost_f64": c64,
                                      "optimizer": "SGD lr 1",
                                      "limit": limit,
                                      "card_rerun_bit_identical": True,
                                      **witness_rows},
              "batch": bs, "steps": steps, "wall_s": wall,
              "samples_per_s": bs * steps / wall, "step_ms_p50": p50,
              "step_ms": step_ms, "costs": costs,
              "max_memory_allocated_bytes": peak,
              "train_launches": train_n, "infer_launches": infer_n,
              "infer_samples": bs, "decoded_mean_len":
                  float(ids_len.float().mean().item()),
              "convergence": {"classes": 8, "rnn_size": 32, "lr": 3e-3,
                              "passes": 25, "samples": 512, "batch": 32,
                              "steps": len(conv_costs), "seconds": conv_s,
                              "first_cost": conv_costs[0],
                              "last_cost": conv_costs[-1],
                              "decoded_exact": f"{exact}/16"},
              "setup_s": setup_s, "profile": prof}
    return result, (train_n["bilstm_fwd"], train_n["lstm_bwd"],
                    train_n["ctc_fwd_bwd"], infer_n["ctc_decode"])


NMT_COST_RTOL = 1e-5     # f32 NMT step vs the f64 witness: cost, and per
NMT_GRAD_FLOOR = 1e-4    # gradient leaf ||g32 - g64|| / ||g64||' least limit


def nmt_inputs(dev, gen, b, t, e, d):
    """x [b, t, e], a mask with half the rows full and half ragged (a
    length-1 row among them) and both directions' (w_x, b, w_h, w_hc,
    h0)."""
    rnd = lambda *s, k=1.0: k * torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    lens = torch.randint(1, t + 1, (b,), generator=gen, device=dev)
    lens[: b // 2] = t
    lens[-1] = 1
    mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).float()
    dirs = [(rnd(e, 3 * d, k=e ** -0.5), rnd(3 * d, k=0.1),
             rnd(d, 2 * d, k=d ** -0.5), rnd(d, d, k=d ** -0.5),
             rnd(b, d, k=0.5)) for _ in range(2)]
    return rnd(b, t, e), mask, dirs[0], dirs[1]


def check_nmt_kernels(dev, timer, b=64, t=32, e=512, d=512) -> tuple:
    """The NMT's kernels at its shapes (B 64, T 32, E = D = 512, half the
    rows full and half ragged), each against its plain twin (max abs error
    <= TOL * max(1, |ref|)) with a rerun bit-identical: the BiGRU forward
    (both directions, x @ W_x + b inside); the GRU forward (no gate slab,
    as the remat route runs it; timed with the slab beside, as the stored
    route runs it), the GRU backward in its remat form (the BiGRU's
    backward launches it once per direction) and in its stored-gates form
    (which must give the remat form's bits; ``grumemory``'s form where the
    slab fits), each over both directions' inputs (reverse off and on)
    and timed per launch, with its own device time from a trace beside
    the wrapper's.  Library yardstick: cuDNN's
    ``nn.GRU``, which is NOT the same cell (its reset gate acts after the
    candidate product, r * (h W_hn + b_hn); the gate order is [r, z, n])
    and includes the input projection: bidirectional for the BiGRU row,
    one direction forward and backward for the GRU rows."""
    from paddle_tpu_torch.ops.kernels import gru as GK
    from paddle_tpu_torch.ops.kernels import lstm as LK

    gen = torch.Generator(device=dev).manual_seed(9)
    x, mask, fw, bw = nmt_inputs(dev, gen, b, t, e, d)

    def worst(got, want, what):
        err = 0.0
        for g, w in zip(got, want):
            if g is None:
                continue
            m = (g - w).abs().max().item()
            if not m <= TOL * max(1.0, w.abs().max().item()):
                raise AssertionError(f"{what} kernel vs plain: {m}")
            err = max(err, m)
        return err

    def same_bits(a, c, what):
        if not all(torch.equal(p, q) for p, q in zip(a, c)
                   if p is not None):
            raise AssertionError(f"{what}: a rerun differs in bits")

    bi = lambda: GK._bi_fwd_kernel(x, mask, fw, bw)  # noqa: E731
    bi_plain = lambda: GK._bi_fwd_plain(x, mask, fw, bw)  # noqa: E731
    got, again = bi(), bi()
    torch.cuda.synchronize()
    same_bits([p for g in got for p in g], [p for a in again for p in a],
              "bigru forward")
    bi_err = max(worst(g, w, "bigru") for g, w in zip(got, bi_plain()))

    # the GRU kernels over each direction's projected input, as the
    # BiGRU's backward launches them: fw with reverse off, bw with reverse
    # on; the backward over the forward kernel's hs, with a random
    # cotangent on hs and zeros on h_T
    calls, dh_t = {}, torch.zeros(b, d, device=dev)
    fwd_err = bwd_err = stored_err = 0.0
    for (w_x, bias, w_h, w_hc, h0), reverse in ((fw, False), (bw, True)):
        xw = LK._project_xw(x, w_x, bias)
        fa = (xw, mask, w_h, w_hc, h0, reverse)
        got = GK._fwd_kernel(*fa, False)
        same_bits(got, GK._fwd_kernel(*fa, False), "gru forward")
        fwd_err = max(fwd_err, worst(got, GK._fwd_plain(*fa, False),
                                     "gru forward"))
        hs, urc, _ = GK._fwd_kernel(*fa, True)
        if not torch.equal(hs, got[0]):
            raise AssertionError("gru forward: the gate slab changes hs")
        args = (mask, w_h, w_hc, h0, hs,
                torch.randn(b, t, d, generator=gen, device=dev), dh_t,
                reverse)
        calls[reverse] = {
            "fwd": (lambda fa=fa: GK._fwd_kernel(*fa, False),
                    lambda fa=fa: GK._fwd_plain(*fa, False)),
            "fwd_slab": (lambda fa=fa: GK._fwd_kernel(*fa, True),
                         lambda fa=fa: GK._fwd_plain(*fa, True)),
            "remat": (
                lambda xw=xw, a=args: GK._bwd_kernel(xw, None, *a, True),
                lambda xw=xw, a=args: GK._bwd_plain(xw, None, *a, True)),
            "stored": (
                lambda u=urc, a=args: GK._bwd_kernel(None, u, *a, False),
                lambda u=urc, a=args: GK._bwd_plain(None, u, *a, False))}
        remat, stored = calls[reverse]["remat"], calls[reverse]["stored"]
        r1, r2, s1, s2 = remat[0](), remat[0](), stored[0](), stored[0]()
        torch.cuda.synchronize()
        same_bits(r1, r2, "gru backward (remat)")
        same_bits(s1, s2, "gru backward (stored)")
        same_bits(r1, s1, "gru backward: remat vs stored gates")
        bwd_err = max(bwd_err, worst(r1, remat[1](), "gru backward"))
        stored_err = max(stored_err, worst(s1, stored[1](),
                                           "gru backward (stored)"))
        del r1, r2, s1, s2, got
    del again

    def per_launch(kind):
        """(mean ms of a launch over both directions, ms by direction,
        the twin's mean ms, the kernel's own device ms a launch)."""
        ms = {r: timer(c[kind][0]) for r, c in calls.items()}
        plain = [timer(c[kind][1]) for c in calls.values()]
        own = device_ms([c[kind][0] for c in calls.values()],
                        GRU_KERNEL_NAMES[kind])
        return ((ms[False] + ms[True]) / 2,
                {"forward": ms[False], "reverse": ms[True]},
                sum(plain) / 2, own)

    # yardsticks: cuDNN's GRU (another cell), bidirectional over x, and one
    # direction over a D-wide input, forward and backward
    cudnn_bi = torch.nn.GRU(e, d, batch_first=True, bidirectional=True).to(dev)
    cudnn1 = torch.nn.GRU(d, d, batch_first=True).to(dev)
    x1 = torch.randn(b, t, d, generator=gen, device=dev).requires_grad_()
    out1, _ = cudnn1(x1)
    g1 = torch.randn_like(out1)
    lib_params = (x1, *cudnn1.parameters())

    def lib_bi():
        with torch.no_grad():
            return cudnn_bi(x)

    def lib_fwd():
        with torch.no_grad():
            return cudnn1(x1)

    steps = float(mask.sum().item())          # row-steps of one direction
    f32 = 4.0
    cell = 20.0 * steps * d                   # gate bundle per unit-step
    rec = 2.0 * steps * 3 * d * d             # h W_h and (r h) W_hc
    io = f32 * (b * t + 2 * d * d + d * d + b * d)   # mask, W_h, W_hc, h0
    lib_note = "cuDNN nn.GRU: not the same cell"
    lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
        out1, lib_params, g1, retain_graph=True)
    gru_bwd_bytes = (f32 * (2 * b * t * 3 * d + 3 * b * t * d + 2 * b * d)
                     + io)
    rows = [{
        "name": "bigru_seq_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/bigru_seq.cu",
        "replaces": "paddle_tpu/ops/pallas/gru.py:663",
        "shape": [b, t, e, d], "max_abs_err": bi_err,
        "ms": timer(bi), "plain_ms": timer(bi_plain),
        "kernel_only_ms": device_ms([bi], GRU_KERNEL_NAMES["bi"]),
        # x, mask, both directions' W_x, b, W_h, W_hc, h0 in; hs and h_T of
        # both out.  The three products over the valid row-steps of both
        # directions, and the cell
        "bytes_flops": (f32 * (b * t * e + b * t
                               + 2 * (e * 3 * d + 3 * d + 3 * d * d + b * d)
                               + 2 * (b * t * d + b * d)),
                        2 * (2.0 * steps * e * 3 * d + rec + cell)),
        "library_ms": timer(lib_bi), "library_note": lib_note}]
    for kind, name, line, lib, bytes_flops in (
            # xw, mask, W_h, W_hc, h0 in; hs, h_T out
            ("fwd", "gru_seq_fwd", 311, lib_fwd,
             (f32 * (b * t * 3 * d + b * t * d + b * d) + io, rec + cell)),
            # xw, mask, W_h, W_hc, h0, hs, dhs, dh_T in; dxw, dh0, r*h
            # out; the recomputed products, dc W_hc^T and [du, dr] W_h^T
            ("remat", "gru_seq_bwd_remat", 279, lib_bwd,
             (gru_bwd_bytes, 2 * rec + 2 * cell)),
            # urc instead of xw, the same outputs; only the two transposed
            # products
            ("stored", "gru_seq_bwd_stored", 232, lib_bwd,
             (gru_bwd_bytes, rec + cell))):
        ms, by_dir, plain_ms, own = per_launch(kind)
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/ops/kernels/csrc/gru_seq.cu",
            "replaces": f"paddle_tpu/ops/pallas/gru.py:{line}",
            "shape": [b, t, d], "max_abs_err": {
                "fwd": fwd_err, "remat": bwd_err, "stored": stored_err}[kind],
            # one launch: the mean of the two directions' times
            "ms": ms, "ms_by_direction": by_dir, "plain_ms": plain_ms,
            "kernel_only_ms": own, "bytes_flops": bytes_flops,
            "library_ms": timer(lib), "library_note": lib_note})
    # the forward writing its u/r/c slab, as the stored route runs it
    ms, by_dir, _, own = per_launch("fwd_slab")
    rows[1].update(with_slab_ms=ms, with_slab_ms_by_direction=by_dir,
                   with_slab_kernel_only_ms=own)
    for row in rows:
        row["bound_ms"], row["bound_by"] = bound(*row.pop("bytes_flops"))
    summary = {"phase": "nmt_kernels", "tol": TOL,
               "lengths": "half full (32), half ragged, one of length 1",
               "gru_directions": "forward (fw weights), reverse (bw weights)",
               "reruns_bit_identical": True,
               "gru_bwd_remat_equals_stored_bits": True,
               "gate_slab_leaves_hs_bits": True}
    del cudnn_bi, cudnn1, out1, g1, lib_params, x1
    torch.cuda.synchronize()
    return rows, summary


def nmt_batches(rng, k, bs, vocab, lo=32, hi=32):
    """``bench_nmt``'s synthetic batches: (source, target, next-target) id
    lists; lengths in [lo, hi] (the bench's 32), the target pair sharing
    one."""
    out = []
    for _ in range(k):
        batch = []
        for _ in range(bs):
            ls, lt = (int(rng.integers(lo, hi + 1)) for _ in range(2))
            trg = rng.integers(0, vocab, size=lt + 1)
            batch.append((rng.integers(0, vocab, size=ls).tolist(),
                          trg[:-1].tolist(), trg[1:].tolist()))
        out.append(batch)
    return out


def composed_bigru_check(dev, b=64, t=32, e=512, d=512,
                         dtype=torch.float32):
    """``layer.bigru`` against the composed fw/bw ``networks.simple_gru2``
    pair (a mixed transform with bias + ``grumemory``) at the NMT's width on
    the card, on the same parameter values: in f32 the forward and every
    gradient within TOL * max(1, |ref|); in bf16 (the parameters and x cast
    inside the graph, as the v2 step casts them) each, per tensor, within
    2x the pair's relative distance from the float64 run of ``layer.bigru``
    on the CPU plus 2^-8 (the pair rounds its projection to bf16, the
    BiGRU keeps it f32).  The pair's ``grumemory`` runs the stored-gates
    backward (its slab fits), the BiGRU the remat one.  Then each
    ``grumemory`` of the pair again as its layer calls ``gru_seq``, on the
    pair's own gate inputs and weights, once with the remat backward and
    once with the stored-gates one: the same bits, and the pair's output.
    Returns (summary, launches by kernel, the bf16 forms' for bf16)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.config.topology import Topology
    from paddle_tpu_torch.core.dtype import cast_floats
    from paddle_tpu_torch.core.lod import SequenceBatch
    from paddle_tpu_torch.layers import networks
    from paddle_tpu_torch.layers.base import reset_name_counters
    from paddle_tpu_torch.ops.kernels import gru as GK

    bf16 = dtype == torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(3)
    L, D = paddle.layer, paddle.data_type
    reset_name_counters()
    node = L.bigru(input=L.data(name="x", type=D.dense_vector_sequence(e)),
                   size=d, name="bi")
    topo = Topology(node)
    params = {s.name: 0.05 * torch.randn(*s.shape, generator=gen, device=dev)
              for s in topo.param_specs()}
    reset_name_counters()
    x2 = L.data(name="x", type=D.dense_vector_sequence(e))
    pair = [networks.simple_gru2(input=x2, size=d, name=f"bi_{k}",
                                 reverse=k == "bw", mixed_bias_attr=True)
            for k in ("fw", "bw")]
    topo2 = Topology(pair)
    if sorted(s.name for s in topo2.param_specs()) != sorted(params):
        raise AssertionError("bigru and the simple_gru2 pair name their "
                             "parameters differently")
    lens = torch.randint(1, t + 1, (b,), generator=gen, device=dev)
    lens[: b // 2] = t
    feed = {"x": SequenceBatch(torch.randn(b, t, e, generator=gen,
                                           device=dev), lens)}
    ct = torch.randn(b, t, 2 * d, generator=gen, device=dev)

    def run(topology, outs, where=dev, cast=dtype):
        leaves = {n: v.to(where, torch.float32 if cast != torch.float64
                          else cast).clone().requires_grad_()
                  for n, v in params.items()}
        fd = cast_floats({k: SequenceBatch(v.data.to(where),
                                           v.length.to(where))
                          for k, v in feed.items()}, cast)
        vals, _ = topology.forward(cast_floats(leaves, cast), {}, fd, True)
        out = torch.cat([vals[o].data for o in outs], dim=-1)
        grads = torch.autograd.grad((out.double() * ct.to(where).double()
                                     ).sum(), list(leaves.values()))
        return [out.detach(), *grads], vals

    mask = feed["x"].mask(torch.float32)
    h0 = torch.zeros(b, d, device=dev, dtype=dtype)

    def grumemory_pair(vals, remat):
        """hs and the gradients of (xw, W_h, W_hc) of each direction, the
        operands in the run's dtype, as ``grumemory`` hands them over."""
        out = []
        for k, reverse in (("fw", False), ("bw", True)):
            w = params[f"_bi_{k}.w0"].to(dtype)
            xw = (vals[f"bi_{k}_transform"].data.detach()
                  + params[f"_bi_{k}.wbias"].to(dtype))
            leaves = [xw, w[:, :2 * d].clone(), w[:, 2 * d:].clone()]
            leaves = [v.requires_grad_() for v in leaves]
            hs, _ = GK.gru_seq(leaves[0], mask, leaves[1], leaves[2], h0,
                               reverse=reverse, remat=remat)
            cot = (ct[..., :d] if k == "fw" else ct[..., d:]).to(dtype)
            out += [hs.detach(),
                    *torch.autograd.grad((hs * cot).sum(), leaves)]
        return out

    counters = gru_bf16_counters()
    names = {"bigru_fwd": "bigru_fwd", "gru_fwd": "gru_fwd",
             "gru_bwd_remat": "gru_bwd_remat",
             "gru_bwd_stored": "gru_bwd_stored"}
    if bf16:
        names = {k: v + "_bf16" for k, v in names.items()}
    for k in counters.values():
        k.launches = 0
    got, _ = run(topo, ["bi"])
    want, vals = run(topo2, ["bi_fw", "bi_bw"])
    remat = grumemory_pair(vals, True)
    stored = grumemory_pair(vals, False)
    torch.cuda.synchronize()
    launches = {n: counters[c].launches for n, c in names.items()}
    others = {n: k.launches for n, k in counters.items()
              if k.launches and n not in names.values()}
    if launches != {"bigru_fwd": 1, "gru_fwd": 6, "gru_bwd_remat": 4,
                    "gru_bwd_stored": 4} or others:
        raise AssertionError(f"composed check launches {launches}, "
                             f"{others}")
    if not all(torch.equal(p, q) for p, q in zip(remat, stored)):
        raise AssertionError("the grumemory pair: remat and stored-gates "
                             "backward differ in bits")
    if not torch.equal(torch.cat([remat[0], remat[4]], dim=-1), want[0]):
        raise AssertionError("gru_seq on the pair's inputs differs from "
                             "the pair's output")
    errs = {}
    if bf16:
        wide, _ = run(topo, ["bi"], "cpu", torch.float64)
        for name, g, w, r in zip(["out"] + list(params), got, want, wide):
            errs[name] = (rel_norm(g, r), rel_norm(w, r))
            if not errs[name][0] <= 2 * errs[name][1] + 2.0 ** -8:
                raise AssertionError(f"bf16 bigru vs the simple_gru2 pair, "
                                     f"against float64: {name} {errs[name]}")
        worst = max(errs, key=lambda n: errs[n][0] / (2 * errs[n][1]
                                                      + 2.0 ** -8))
        limit = f"2 x the pair's distance from float64 + {2.0 ** -8}"
    else:
        for name, g, w in zip(["out"] + list(params), got, want):
            err = (g - w).abs().max().item()
            scale = max(1.0, w.abs().max().item())
            errs[name] = err / scale
            if not err <= TOL * scale:
                raise AssertionError(f"bigru vs the simple_gru2 pair: "
                                     f"{name} {err} (scale {scale})")
        worst = max(errs, key=errs.get)
        limit = TOL
    return ({"phase": "nmt_composed_bigru_check", "dtype": str(dtype),
             "batch": b, "T": t, "E": e, "D": d, "limit": limit,
             "errors": errs if bf16 else {"max_rel_err": errs[worst]},
             "worst": worst, "remat_equals_stored_bits": True,
             "gru_seq_on_the_pair_inputs_equals_the_pair_bits": True,
             "launches": launches},
            launches)


def train_nmt(dev, vocab=30000, width=512, bs=64, steps=10) -> tuple:
    """The attention NMT through the v2 flow (``bench_nmt``'s
    configuration, f32): the batch-2 step against a float64 witness, the
    first ``trainer.SGD`` step twice (bit for bit), 2 warm-up and
    ``steps`` timed steps at batch 64 with exact launch counts, a 3-step
    profile, ``test`` on 2 batches, and the composed BiGRU check."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.config.topology import Topology
    from paddle_tpu_torch.core.dtype import set_policy
    from paddle_tpu_torch.core.parameters import Parameters
    from paddle_tpu_torch.layers import networks
    from paddle_tpu_torch.layers.base import reset_name_counters
    from paddle_tpu_torch.models import seqtoseq
    from paddle_tpu_torch.ops import rnn as rnn_ops
    from paddle_tpu_torch.ops.kernels import embedding as EK
    from paddle_tpu_torch.ops.kernels import gru as GK
    from paddle_tpu_torch.reader.feeder import DataFeeder

    t0 = time.perf_counter()
    reset_name_counters()
    cost = seqtoseq.seqtoseq_net(vocab, vocab, word_vector_dim=width,
                                 encoder_size=width, decoder_size=width)
    order = ("source_language_word", "target_language_word",
             "target_language_next_word")
    feeding = {n: i for i, n in enumerate(order)}
    created = paddle.parameters.create(cost)     # generator seeded 0
    carried = {n: created[n] for n in created.names()}
    # the biases start at 0; make them nonzero so the witness sees every
    # term of the cells and the softmax
    rng = np.random.default_rng(0)
    for n in carried:
        if n.endswith("bias"):
            carried[n] = (0.1 * rng.standard_normal(carried[n].shape)
                          ).astype(np.float32)
    n_params = int(sum(v.size for v in carried.values()))

    def trainer(where):
        return paddle.trainer.SGD(
            cost=cost, parameters=Parameters.from_numpy(carried),
            update_equation=paddle.optimizer.Adam(
                learning_rate=5e-4, moment_dtype=torch.bfloat16),
            device=where)

    def run(tr, data, handler=None):
        out = []

        def h(e):
            if isinstance(e, paddle.event.EndIteration):
                out.append((e.cost, e.metrics[
                    "classification_error_evaluator"]))
            if handler is not None:
                handler(e)

        tr.train(reader=lambda: iter(data), num_passes=1, event_handler=h,
                 feeding=feeding)
        return out

    # (a) one step at batch 2, ragged source and target lengths (T = 16
    # after bucketing), from the same parameters: the card's kernels in
    # f32 and the CPU's plain twins in f32, each against the CPU's plain
    # twins in float64, by the cost and every gradient leaf
    # (||g32 - g64|| / ||g64||).  The limit is 10x the float64 gradient's
    # own move when both embedding tables are nudged by 1e-6 relative (at
    # least NMT_GRAD_FLOOR).  TF32 allowed on the card, a CPU cell that
    # applies the reset gate after the candidate product (cuDNN's
    # convention) and an attention that does not mask the source padding
    # are planted faults that must exceed it; the card's step repeats bit
    # for bit.
    small = nmt_batches(rng, 1, 2, vocab, lo=5, hi=14)[0]
    topo = Topology(cost)
    types = {n: paddle.data_type.InputType(
        dim=l.attrs["dim"], seq_type=l.attrs["seq_type"],
        kind=l.attrs["data_type"]) for n, l in topo.data_layers().items()}
    nudged = dict(carried)
    for n in ("_source_language_embedding", "_target_language_embedding"):
        nudged[n] = carried[n] * (1 + 1e-6 * rng.standard_normal(
            carried[n].shape)).astype(np.float32)

    def side(where, dtype=torch.float32, start=carried):
        feed = DataFeeder(types, feeding, device=where)(small)
        params = {n: torch.from_numpy(v).to(where, dtype)
                  for n, v in start.items()}
        return text_loss_and_grads(topo, cost.name, params, feed)

    loss64, g64 = side("cpu", torch.float64)
    sides = {"f64_nudged": side("cpu", torch.float64, nudged),
             "cpu": side("cpu"), "card": side(dev)}
    rerun = side(dev)
    plain_gates, plain_cell = GK._gates, rnn_ops.gru_cell
    plain_weights = networks._attention_weights

    def cudnn_gates(x_t, h, w_h, w_hc):
        d = h.shape[-1]
        ur = x_t[:, :2 * d] + torch.matmul(h, w_h)
        u, r = torch.sigmoid(ur[:, :d]), torch.sigmoid(ur[:, d:])
        c = torch.tanh(x_t[:, 2 * d:] + r * torch.matmul(h, w_hc))
        return u, r, c, r * h

    def cudnn_cell(xw, h, w_h, w_hc, gate_act=None, state_act=None):
        u, _, c, _ = cudnn_gates(xw, h, w_h, w_hc)
        return u * h + (1.0 - u) * c

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        sides["card_tf32_control"] = side(dev)
    finally:
        set_policy()
    GK._gates, rnn_ops.gru_cell = cudnn_gates, cudnn_cell
    try:
        sides["cpu_cudnn_cell_control"] = side("cpu")
    finally:
        GK._gates, rnn_ops.gru_cell = plain_gates, plain_cell
    networks._attention_weights = (
        lambda scores, mask: plain_weights(scores, torch.ones_like(mask)))
    try:
        sides["card_unmasked_attention_control"] = side(dev)
    finally:
        networks._attention_weights = plain_weights
    if not (torch.equal(rerun[0], sides["card"][0]) and all(
            torch.equal(rerun[1][n], sides["card"][1][n]) for n in g64)):
        raise AssertionError("the card's NMT step is not bit-identical on a "
                             "rerun")
    witness = {"batch": 2, "lengths": [[len(s) for s in x[:2]]
                                       for x in small],
               "cost_f64": float(loss64), "cost_rtol": NMT_COST_RTOL}
    for label, (loss, grads) in sides.items():
        ratios = {n: rel_norm(grads[n], g64[n]) for n in g64}
        worst = max(ratios, key=ratios.get)
        witness[label] = {"cost": float(loss),
                          "cost_rel_err": abs(float(loss) - float(loss64))
                          / abs(float(loss64)),
                          "grad_worst": ratios[worst],
                          "grad_worst_leaf": worst}
    del sides, rerun, g64
    limit = max(NMT_GRAD_FLOOR, 10 * witness["f64_nudged"]["grad_worst"])
    witness["grad_limit"] = limit
    for label in ("cpu", "card"):
        w = witness[label]
        if not (w["cost_rel_err"] <= NMT_COST_RTOL
                and w["grad_worst"] <= limit):
            raise AssertionError(f"{label} NMT step vs the f64 witness: "
                                 f"{witness}")
    for label in ("card_tf32_control", "cpu_cudnn_cell_control",
                  "card_unmasked_attention_control"):
        if witness[label]["grad_worst"] <= limit:
            raise AssertionError(f"the NMT witness limit does not catch "
                                 f"{label}: {witness}")

    # (b) trainer.SGD at bench_nmt's configuration: Adam 5e-4 with bf16
    # moments, batch 64 of 32-token sequences; the first step twice from
    # the same parameters (bit for bit), then 2 warm-up steps (set-up) and
    # the timed steps with the launch counts zeroed just before and read
    # just after
    warm, data, test_data = (nmt_batches(rng, k, bs, vocab)
                             for k in (2, steps, 2))
    firsts = []
    for _ in range(2):
        tr = trainer(dev)
        firsts.append((run(tr, data[:1]),
                       {n: tr.parameters[n] for n in carried}))
        del tr
    if not (firsts[0][0] == firsts[1][0] and all(
            np.array_equal(firsts[0][1][n], firsts[1][1][n])
            for n in carried)):
        raise AssertionError("trainer.SGD's first NMT step is not "
                             "bit-identical on a rerun")
    del firsts
    tr = trainer(dev)
    run(tr, warm)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    marks: dict[int, list] = {}

    def stamp(e):
        if isinstance(e, (paddle.event.BeginIteration,
                          paddle.event.EndIteration)):
            marks.setdefault(e.batch_id, []).append(time.perf_counter())

    kernels = {"bigru_fwd": GK.KERNEL_BI, "gru_fwd": GK.KERNEL_FWD,
               "gru_bwd_remat": GK.KERNEL_BWD,
               "gru_bwd_stored": GK.KERNEL_BWD_STORED,
               "gather": EK.KERNEL_GATHER, "scatter_add": EK.KERNEL_SCATTER}

    def zero():
        for k in kernels.values():
            k.launches = 0

    def counts():
        return {n: k.launches for n, k in kernels.items()}

    zero()
    t1 = time.perf_counter()
    events = run(tr, data, stamp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    train_n = counts()
    peak = torch.cuda.max_memory_allocated(dev)
    want = {"bigru_fwd": 1, "gru_fwd": 0, "gru_bwd_remat": 2,
            "gru_bwd_stored": 0, "gather": 2, "scatter_add": 2}
    if train_n != {n: c * steps for n, c in want.items()}:
        raise AssertionError(f"NMT train launches {train_n} != {want} x "
                             f"{steps}")
    costs = [c for c, _ in events]
    if not (len(costs) == steps and all(np.isfinite(costs))):
        raise AssertionError(f"NMT costs not finite: {costs}")
    step_ms = [1e3 * (b - a) for a, b in marks.values()]
    p50 = float(np.percentile(step_ms, 50))
    traced = nmt_batches(rng, 3, bs, vocab)
    prof = profile_window(lambda: run(tr, traced), 3)
    if "device_busy_ms_per_step" in prof:
        prof["idle_share_vs_step_p50"] = (
            1 - prof["device_busy_ms_per_step"] / p50)
    zero()
    result = tr.test(reader=lambda: iter(test_data), feeding=feeding)
    test_n = counts()
    want_test = dict(bigru_fwd=2, gru_fwd=0, gru_bwd_remat=0,
                     gru_bwd_stored=0, gather=4, scatter_add=0)
    if test_n != want_test or not np.isfinite(result.cost):
        raise AssertionError(f"NMT test launches {test_n} != {want_test} or "
                             f"cost {result.cost}")
    del tr
    torch.cuda.empty_cache()
    composed, composed_n = composed_bigru_check(dev, e=width, d=width)
    out = {"phase": "train_nmt",
           "model": "attention NMT (models/seqtoseq.seqtoseq_net, bench_nmt)",
           "params": n_params, "tensors": len(carried), "vocab": vocab,
           "width": width, "dtype": "float32", "adam_moments": "bfloat16",
           "lr": 5e-4,
           "step_vs_f64_witness": witness,
           "card_step_rerun_bit_identical": True,
           "first_step_rerun_bit_identical": True,
           "batch": bs, "tokens_per_sequence": 32, "steps": steps,
           "wall_s": wall, "sequences_per_s": bs * steps / wall,
           "step_ms_p50": p50, "step_ms": step_ms, "costs": costs,
           "classification_error": [m for _, m in events],
           "max_memory_allocated_bytes": peak, "train_launches": train_n,
           "test_launches": test_n, "test_batches": 2,
           "test_cost": result.cost, "test_metrics": result.metrics,
           "setup_s": setup_s, "profile": prof, "composed": composed}
    return out, (train_n["bigru_fwd"], composed_n["gru_fwd"],
                 train_n["gru_bwd_remat"], composed_n["gru_bwd_stored"])


VGG_COST_RTOL = 1e-5     # f32 small_vgg step vs the f64 witness: cost,
VGG_GRAD_FLOOR = 1e-4    # the gradient leaves' least limit, and
VGG_STATE_LIMIT = 1e-5   # the BN moving statistics (relative norm)
#: small_vgg's channel_stats views [R, C] at batch 128 of 32x32 images
VGG_STATS_SHAPES = ((131072, 64), (32768, 128), (8192, 256), (2048, 512),
                    (128, 512))


#: planted faults of the batch-norm moments kernel (csrc/channel_stats.cu):
#: the finish adds P - 1 row blocks' partials; the last block leaves its
#: ticket drawn, so the next call on its column chunk finishes early or
#: never
STATS_FAULTS = {
    "finish_drops_a_partial": (
        "  const int parts = P;   // every row block's partials",
        "  const int parts = P - 1;   // planted: the last partial dropped"),
    "ticket_not_reset": (
        "  if (t == 0) tickets[blockIdx.x] = 0;   // ready for the next "
        "launch",
        "  // planted: the ticket is left drawn")}
#: the trace name of the moments kernel by form (csrc/channel_stats.cu)
STATS_KERNEL = {torch.float32: "channel_stats_kernel<float, 4>",
                torch.bfloat16: "channel_stats_kernel<__nv_bfloat16, 8>"}
_stats_faults: dict = {}


def start_stats_faults() -> None:
    """Start the builds of ``STATS_FAULTS`` (once per process, under
    ``build/faults/``)."""
    if not _stats_faults:
        _stats_faults.update(source_fault_builds("channel_stats",
                                                 STATS_FAULTS))


def stats_fault_entries(kernel) -> dict:
    """{fault: the C entry of ``kernel``'s symbol in that fault's build},
    waiting for the builds the first time."""
    import ctypes

    start_stats_faults()
    out = {}
    for name, build in _stats_faults.items():
        if isinstance(build, tuple):
            proc, lib = build
            log_, _ = proc.communicate()
            if proc.returncode != 0:
                raise AssertionError(f"nvcc of a planted fault failed:\n"
                                     f"{log_}")
            build = _stats_faults[name] = lib
        fn = getattr(ctypes.CDLL(str(build)), kernel.symbol)
        fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
        out[name] = fn
    return out


def trace_kernel_counts(fn, rounds: int = 40) -> dict:
    """{kernel name: records} of the CUDA kernels a ``torch.profiler``
    trace of ``rounds`` calls of ``fn`` holds (the H100 host's traces drop
    some of their first records: 7 to 9 of 40 seen; an empty trace is
    taken again, ``cuda_records``)."""
    fn()
    return {e.key: e.count for e in cuda_records(fn, rounds)}


def check_vgg_kernels(dev, timer, shapes=VGG_STATS_SHAPES,
                      dtype=torch.float32):
    """``channel_stats`` in ``dtype`` against its twin at small_vgg's five
    [R, C] views (max abs error <= 1e-4 x max(1, |ref|) for both sums; in
    bf16 against the sums of the same bf16 values in float64), a rerun in
    the same bits with a call of another shape between (the tickets), one
    launch a call by the counter and in a trace, each timed beside its
    twin, ``torch.var_mean`` and its bound, with its device time alone (a
    trace, no flush) and the host's ms a call.  Then the planted faults
    of ``STATS_FAULTS``, which must fail.  Returns (the kernel row at the
    largest view, the phase's summary)."""
    from paddle_tpu_torch.ops.kernels import channel_stats as CS
    from paddle_tpu_torch.ops.kernels import _kept

    bf16 = dtype == torch.bfloat16
    kernel = CS.KERNELS[dtype]
    start_stats_faults()
    size = torch.empty((), dtype=dtype).element_size()
    gen = torch.Generator(device=dev).manual_seed(9)
    rnd = lambda r, c: (torch.randn(r, c, generator=gen, device=dev)  # noqa: E731
                        * 2 + 0.5).to(dtype)

    def checked(x, other):
        """x, ``other``, x again: each against the twin, x's two calls
        in the same bits; returns x's error."""
        got, between, again = (CS.channel_stats(v) for v in (x, other, x))
        err = 0.0
        for v, outs in ((x, got), (other, between), (x, again)):
            want = CS.channel_stats_reference(v.double() if bf16 else v)
            for a, b in zip(outs, want):
                rel = ((a - b).abs().max().item()
                       / max(1.0, b.abs().max().item()))
                if not rel <= TOL:
                    raise AssertionError(
                        f"channel_stats {list(v.shape)}: kernel vs plain "
                        f"err {rel} x max(1, |ref|)")
                err = max(err, rel) if v is x else err
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"channel_stats {list(x.shape)} is not "
                                 "bit-identical on a rerun")
        return err

    other = rnd(4096, 64)
    per_shape = []
    for r, c in shapes:
        x = rnd(r, c)
        before = kernel.launches
        err = checked(x, other)
        call = lambda: CS.channel_stats(x)  # noqa: E731
        traced = trace_kernel_counts(call)
        launches = kernel.launches - before
        if (launches != 3 + 41 or any(STATS_KERNEL[dtype] not in k
                                      for k in traced)
                or not 20 <= sum(traced.values()) <= 40):
            raise AssertionError(f"channel_stats [{r}, {c}]: not one "
                                 f"kernel a call ({launches} launches for "
                                 f"44 calls; trace of 40: {traced})")
        bound_ms, by = bound(size * r * c + 4.0 * 2 * c, 3.0 * r * c)
        per_shape.append({
            "shape": [r, c], "max_abs_err": err,
            "plan": list(CS.plan(r, c, CS.VEC[dtype])),
            "ms": timer(call),
            "alone_ms": device_ms([call], STATS_KERNEL[dtype]),
            "host_ms": host_ms(call),
            "plain_ms": timer(lambda: CS.channel_stats_reference(x)),
            "bound_ms": bound_ms, "bound_by": by,
            "library_ms": timer(lambda: torch.var_mean(x, dim=0,
                                                       correction=0))})
        del x
    # each planted fault on inputs no earlier call saw, so that no stale
    # output can hold their sums
    caught = {}
    fault_shapes = (8192, 256), (2048, 256)
    if any(CS.plan(*v, CS.VEC[dtype]).row_blocks < 2 for v in fault_shapes):
        raise AssertionError("the planted faults need row blocks to finish")
    for name, entry in stats_fault_entries(kernel).items():
        real = kernel._fn or kernel._resolve()
        kernel._fn = entry
        try:
            checked(*(rnd(*v) for v in fault_shapes))
            torch.cuda.synchronize()
            caught[name] = False
        except AssertionError:
            caught[name] = True
        finally:
            kernel._fn = real
            torch.cuda.synchronize()
            _kept.forget()    # a fault may leave its tickets drawn
    if not all(caught.values()):
        raise AssertionError(f"a planted channel_stats fault passed: "
                             f"{caught}")
    big = per_shape[0]
    name = "channel_stats_bf16" if bf16 else "channel_stats"
    row = {"name": name, "route": "cuda",
           "source": "paddle_tpu_torch/ops/kernels/csrc/channel_stats.cu",
           "replaces": "paddle_tpu/ops/pallas/tpp/conv.py:87",
           "shape": big["shape"],
           "max_abs_err": max(s["max_abs_err"] for s in per_shape),
           **{k: big[k] for k in ("ms", "alone_ms", "host_ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")}}
    torch.cuda.synchronize()
    return row, {"phase": "vgg_kernels", "dtype": str(dtype), name: per_shape,
                 f"{name}_rerun_bit_identical": True,
                 "planted_faults_caught": caught}


def vgg_cost(paddle):
    """small_vgg over CIFAR-10 (32x32x3, 10 classes) with
    ``classification_cost``, as the book's ``train.py`` builds it."""
    from paddle_tpu_torch.layers import networks

    img = paddle.layer.data(name="image",
                            type=paddle.data_type.dense_vector(3072))
    label = paddle.layer.data(name="label",
                              type=paddle.data_type.integer_value(10))
    return paddle.layer.classification_cost(
        input=networks.small_vgg(img, 3, 10), label=label)


def vgg_witness(dev, cost, carried, small, seed=5):
    """A batch-4 small_vgg train-mode forward and backward (dropout on,
    seed ``seed``) on the card and on the CPU, each against the float64
    run on the same device (the masks are drawn in f32 from the same
    per-layer generators, so the witness drops what the step drops): the
    cost within VGG_COST_RTOL, every gradient leaf (||g32 - g64|| /
    ||g64||) within 10x the float64 gradient's own move under a 1e-6
    relative nudge of the images (at least VGG_GRAD_FLOOR), every BN
    moving statistic within VGG_STATE_LIMIT.  Batch 4, not 2: the head's
    batch norm normalizes over the rows, and two rows normalize to
    +-gamma whatever their values, with the single-pass f32 variance
    (E[x^2] - E[x]^2, the JAX package's convention) cancelling wherever
    the two are close (its output 3.5e-2 and the cost 4.9e-4 from the
    float64 run at batch 2, 2e-5 and 3e-7 at batch 4, on the CPU).  The
    conv biases that feed a batch norm (exact gradient zero) are left out
    of the gradient comparison.  TF32 on the card, dropout
    without its 1 / keep scaling and ``F.batch_norm``'s unbiased running
    variance are planted faults that must exceed those limits; the
    card's run repeats bit for bit."""
    import torch.nn.functional as F

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.config.topology import Topology
    from paddle_tpu_torch.core.dtype import set_policy
    from paddle_tpu_torch.ops import nn as nn_ops
    from paddle_tpu_torch.reader.feeder import DataFeeder

    topo = Topology(cost)
    types = {n: paddle.data_type.InputType(
        dim=l.attrs["dim"], seq_type=l.attrs["seq_type"],
        kind=l.attrs["data_type"]) for n, l in topo.data_layers().items()}
    rng = np.random.default_rng(1)
    nudged = [(x * (1 + 1e-6 * rng.standard_normal(x.shape)).astype(
        np.float32), y) for x, y in small]

    def side(where, dtype=torch.float32, data=small):
        feed = DataFeeder(types, None, device=where)(data)
        feed = {k: v.to(dtype) if v.is_floating_point() else v
                for k, v in feed.items()}
        leaves = {n: torch.from_numpy(v).to(where, dtype).requires_grad_()
                  for n, v in carried.items()}
        states = {k: v.to(where, dtype) for k, v in
                  topo.init_states(where).items()}
        values, new_states = topo.forward(leaves, states, feed, True, seed)
        loss = values[cost.name]
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return (float(loss.detach()), dict(zip(leaves, grads)),
                {k: v.detach() for k, v in new_states.items()})

    plain_dropout, plain_bn = nn_ops.dropout, nn_ops.batch_norm

    def unscaled_dropout(x, rate, generator, is_train):
        kept = plain_dropout(x, rate, generator, is_train)
        return kept * (1.0 - rate) if is_train and rate > 0 else kept

    def unbiased_running_var(x, scale, bias, rm, rv, is_train, momentum=0.9,
                             eps=1e-5, use_fused_stats=None):
        y, nm, nv = plain_bn(x, scale, bias, rm, rv, is_train, momentum, eps,
                             use_fused_stats)
        if is_train:
            nm, nv = rm.clone(), rv.clone()
            F.batch_norm(x.detach().reshape(-1, x.shape[-1]), nm, nv,
                         training=True, momentum=1 - momentum, eps=eps)
        return y, nm, nv

    wit = {"cpu": side("cpu", torch.float64), "card": side(dev,
                                                           torch.float64)}
    nudge = {"cpu": side("cpu", torch.float64, nudged),
             "card": side(dev, torch.float64, nudged)}
    sides = {"cpu": ("cpu", side("cpu")), "card": ("card", side(dev))}
    rerun = side(dev)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        sides["card_tf32_control"] = ("card", side(dev))
    finally:
        set_policy()
    nn_ops.dropout = unscaled_dropout
    try:
        sides["cpu_unscaled_dropout_control"] = ("cpu", side("cpu"))
    finally:
        nn_ops.dropout = plain_dropout
    nn_ops.batch_norm = unbiased_running_var
    try:
        sides["card_unbiased_running_var_control"] = ("card", side(dev))
    finally:
        nn_ops.batch_norm = plain_bn
    c_a, g_a, s_a = sides["card"][1]
    if not (rerun[0] == c_a and all(torch.equal(rerun[1][n], g_a[n])
                                    for n in g_a)
            and all(torch.equal(rerun[2][k], s_a[k]) for k in s_a)):
        raise AssertionError("the card's small_vgg step is not "
                             "bit-identical on a rerun")

    # a conv bias that feeds a batch norm directly has an exact gradient
    # of zero (the norm removes a per-channel constant): its f32 and f64
    # values are round-off alone, so it is left out of the comparison
    zero_grad = {s.name for n in topo.nodes if n.layer_type == "batch_norm"
                 for p in n.parents if p.layer_type == "exconv"
                 and not p.attrs.get("drop_rate")
                 for s in p.param_specs if s.name.endswith(".wbias")}

    def worst(got, want):
        """The worst ||got - want|| / ||want|| over the leaves, ||want||
        floored at STEP_FLOOR of the leaf's share of the whole."""
        want = {n: v.detach().cpu().double() for n, v in want.items()
                if n not in zero_grad}
        u = (sum(float(torch.sum(v * v)) for v in want.values())
             / sum(v.numel() for v in want.values())) ** 0.5
        ratios = {n: float(torch.linalg.norm(got[n].detach().cpu().double()
                                             - v))
                  / max(float(torch.linalg.norm(v)),
                        STEP_FLOOR * u * v.numel() ** 0.5)
                  for n, v in want.items()}
        n = max(ratios, key=ratios.get)
        return ratios[n], n

    out = {"batch": len(small), "seed": seed, "cost_rtol": VGG_COST_RTOL,
           "state_limit": VGG_STATE_LIMIT}
    limits = {}
    for where in ("cpu", "card"):
        c64, g64, s64 = wit[where]
        moved, leaf = worst(nudge[where][1], g64)
        limits[where] = max(VGG_GRAD_FLOOR, 10 * moved)
        out[f"f64_{where}"] = {"cost": c64, "nudge_grad_worst": moved,
                               "nudge_grad_worst_leaf": leaf,
                               "grad_limit": limits[where]}
    for label, (where, (c, g, s)) in sides.items():
        c64, g64, s64 = wit[where]
        gw, gn = worst(g, g64)
        sw, sn = worst(s, s64)
        out[label] = {"cost": c, "cost_rel_err": abs(c - c64) / abs(c64),
                      "grad_worst": gw, "grad_worst_leaf": gn,
                      "state_worst": sw, "state_worst_leaf": sn}
    for label in ("cpu", "card"):
        w = out[label]
        if not (w["cost_rel_err"] <= VGG_COST_RTOL
                and w["grad_worst"] <= limits[label]
                and w["state_worst"] <= VGG_STATE_LIMIT):
            raise AssertionError(f"{label} small_vgg step vs the f64 "
                                 f"witness: {out}")
    for label in ("card_tf32_control", "cpu_unscaled_dropout_control",
                  "card_unbiased_running_var_control"):
        w, where = out[label], sides[label][0]
        if (w["cost_rel_err"] <= VGG_COST_RTOL
                and w["grad_worst"] <= limits[where]
                and w["state_worst"] <= VGG_STATE_LIMIT):
            raise AssertionError(f"the small_vgg witness limits do not "
                                 f"catch {label}: {out}")
    out["card_rerun_bit_identical"] = True
    return out


def train_vgg(dev, bs=128, steps=10) -> tuple[dict, int, int]:
    """small_vgg through the v2 flow at the book's configuration (batch
    128 of CIFAR-10 from the port's seeded reader; Momentum 0.9 at lr
    0.1 / 128, L2 0.0002 x 128; f32): the batch-2 witness, the first
    ``trainer.SGD`` step twice (bit for bit), 2 warm-up and ``steps`` timed
    steps with exactly 11 channel_stats and 10 direct-conv launches a
    step, a 3-step profile, and ``test`` on 2 batches (no channel_stats:
    the running statistics)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import rng as prng
    from paddle_tpu_torch.core.parameters import Parameters
    from paddle_tpu_torch.dataset import cifar
    from paddle_tpu_torch.layers.base import reset_name_counters
    from paddle_tpu_torch.ops.kernels import update as UP

    t0 = time.perf_counter()
    reset_name_counters()
    cost = vgg_cost(paddle)
    created = paddle.parameters.create(cost)     # generator seeded 0
    carried = {n: created[n] for n in created.names()}
    n_params = int(sum(v.size for v in carried.values()))
    samples = list(cifar.train10()())
    witness = vgg_witness(dev, cost, carried, samples[:4])

    def trainer():
        return paddle.trainer.SGD(
            cost=cost, parameters=Parameters.from_numpy(carried),
            update_equation=paddle.optimizer.Momentum(
                momentum=0.9, learning_rate=0.1 / 128,
                regularization=paddle.optimizer.L2Regularization(
                    rate=0.0002 * 128)), device=dev)

    def run(tr, data, handler=None):
        costs = []

        def h(e):
            if isinstance(e, paddle.event.EndIteration):
                costs.append(e.cost)
            if handler is not None:
                handler(e)

        tr.train(reader=lambda: iter(data), num_passes=1, event_handler=h)
        return costs

    batches = [samples[i:i + bs] for i in range(0, len(samples) - bs + 1,
                                                bs)]
    warm, data, traced = batches[:2], batches[2:2 + steps], \
        batches[2 + steps:5 + steps]
    # the first step twice, then through the per-tensor loop: the same bits
    firsts, first_update_n = [], []
    for generic in (False, False, True):
        prng.seed(11)
        tr = trainer()
        if generic:
            tr.optimizer.apply = tr.optimizer._apply_each
        n0 = UP.KERNEL.launches
        firsts.append((run(tr, data[:1]),
                       {n: tr.parameters[n] for n in carried},
                       {k: v.cpu().numpy() for k, v in tr.states.items()}))
        first_update_n.append(UP.KERNEL.launches - n0)
        del tr
    (c1, p1, s1) = firsts[0]
    for c2, p2, s2 in firsts[1:]:
        if not (c1 == c2 and all(np.array_equal(p1[n], p2[n]) for n in p1)
                and all(np.array_equal(s1[k], s2[k]) for k in s1)):
            raise AssertionError("trainer.SGD's first small_vgg step is not "
                                 "bit-identical on a rerun or through the "
                                 "per-tensor loop")
    if first_update_n != [1, 1, 0]:
        raise AssertionError(f"small_vgg first steps' fused update launches "
                             f"{first_update_n} != [1, 1, 0]")
    del firsts
    prng.seed(12)
    tr = trainer()
    run(tr, warm)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    marks: dict[int, list] = {}

    def stamp(e):
        if isinstance(e, (paddle.event.BeginIteration,
                          paddle.event.EndIteration)):
            marks.setdefault(e.batch_id, []).append(time.perf_counter())

    each = []
    loop = tr.optimizer._apply_each
    tr.optimizer._apply_each = lambda *a: each.append(1) or loop(*a)
    zero_counts()
    drop_kept_tables(UP.KERNEL)
    builds0 = UP.KERNEL.table_builds
    t1 = time.perf_counter()
    costs = run(tr, data, stamp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    train_n = read_counts()
    table_builds = UP.KERNEL.table_builds - builds0
    peak = torch.cuda.max_memory_allocated(dev)
    want = {"channel_stats": 11, "conv2d_direct": 10, "fused_update": 1}
    if train_n != per_step(want, steps) or each:
        raise AssertionError(f"small_vgg train launches {train_n} != {want} "
                             f"x {steps}, or {len(each)} per-tensor loops")
    if table_builds != 1:
        raise AssertionError(f"small_vgg: the fused update built "
                             f"{table_builds} tables over {steps} steps")
    if not (len(costs) == steps and all(np.isfinite(costs))
            and np.mean(costs[-3:]) < np.mean(costs[:3])):
        raise AssertionError(f"small_vgg costs not finite and falling: "
                             f"{costs}")
    step_ms = [1e3 * (b - a) for a, b in marks.values()]
    p50 = float(np.percentile(step_ms, 50))
    prof = profile_window(lambda: run(tr, traced), 3)
    if "device_busy_ms_per_step" in prof:
        prof["idle_share_vs_step_p50"] = (
            1 - prof["device_busy_ms_per_step"] / p50)
    route_ms = update_route_ab(tr, run, data[:5], stamp, marks)
    test_data = list(cifar.test10()())[:2 * bs]
    zero_counts()
    result = tr.test(reader=lambda: iter([test_data[:bs], test_data[bs:]]))
    torch.cuda.synchronize()
    test_n = read_counts()
    want_test = per_step({"conv2d_direct": 10}, 2)
    if test_n != want_test or not np.isfinite(result.cost):
        raise AssertionError(f"small_vgg test launches {test_n} != "
                             f"{want_test} or cost {result.cost}")
    del tr
    out = {"phase": "train_vgg",
           "model": "small_vgg (layers/networks.small_vgg, the book's "
                    "vgg_bn_drop on CIFAR-10)",
           "params": n_params, "tensors": len(carried), "image": [32, 32, 3],
           "classes": 10, "dtype": "float32",
           "optimizer": "Momentum 0.9, lr 0.1/128, L2 0.0002*128",
           "step_vs_f64_witness": witness,
           "first_step_rerun_and_loop_bit_identical": True,
           "first_steps_fused_update_launches": first_update_n,
           "batch": bs, "steps": steps, "wall_s": wall,
           "images_per_s": bs * steps / wall, "step_ms_p50": p50,
           "step_ms": step_ms, "costs": costs,
           "max_memory_allocated_bytes": peak, "train_launches": train_n,
           "fused_update_table_builds": table_builds,
           "test_launches": test_n, "test_batches": 2,
           "test_cost": result.cost, "test_metrics": result.metrics,
           "update_route_step_ms": route_ms,
           "setup_s": setup_s, "profile": prof}
    return out, train_n["channel_stats"], train_n["fused_update"]


# -- bf16 compute_dtype: ResNet-50 and small_vgg (phase 13) ------------------

#: the bf16 witness steps.  ``BF16_WITNESS_NET``: ResNet-50's 16
#: bottleneck blocks (its 161 parameter leaves, by name) at an eighth of
#: its width on 64x64 images, batch 8, where the CPU here computes the
#: JAX package's own bf16 error at this very step (the same parameters
#: and batch): ``BF16_WITNESS_JAX`` holds it, recomputed by
#: ``tests/test_torch_bf16.py`` (``PYTHONPATH=.:tests python
#: tests/test_torch_bf16.py`` prints it).  That error is ~1x the update on
#: most leaves: the first bf16 step from a random init is mostly
#: amplified round-off, and one bf16 ulp on 0.01% of the input pixels
#: moves it as far, so a whole-step limit catches only gross faults.
#: ``BF16_WITNESS_FULL``: ResNet-50 at full width, 224x224, batch 8, where
#: each of the step's 53 conv + BN backward passes on the card is held,
#: on the very tensors the step gave it, to the plain twins' on the CPU:
#: per output, relative norm error within BF16_LAYER_LIMIT (on an H100:
#: 3.0e-3 at worst, a dw; the planted faults read 1 and 2.4 or more).
BF16_WITNESS_NET = {"side": 64, "div": 8, "classes": 1000, "batch": 8}
BF16_WITNESS_FULL = {"side": 224, "div": 1, "classes": 1000, "batch": 8}
BF16_WITNESS_FLOOR = 0.02
BF16_LAYER_LIMIT = 0.02
BF16_WITNESS_JAX = {
    '_conv1_bn.w0': 1.106, '_conv1_bn.w1': 0.001451, '_conv1_bn.w2': 0.001393,
    '_conv1_bn.wbias': 1.554, '_conv1_conv.w0': 1.327, '_fc_out.w0': 0.3555,
    '_fc_out.wbias': 0.007092, '_res2_1_branch1_bn.w0': 1.133,
    '_res2_1_branch1_bn.w1': 0.001969, '_res2_1_branch1_bn.w2': 0.006229,
    '_res2_1_branch1_bn.wbias': 1.484, '_res2_1_branch1_conv.w0': 1.425,
    '_res2_1_branch2a_bn.w0': 0.7662, '_res2_1_branch2a_bn.w1': 0.001141,
    '_res2_1_branch2a_bn.w2': 0.003068, '_res2_1_branch2a_bn.wbias': 0.8963,
    '_res2_1_branch2a_conv.w0': 1.356, '_res2_1_branch2b_bn.w0': 1.497,
    '_res2_1_branch2b_bn.w1': 0.01007, '_res2_1_branch2b_bn.w2': 0.006765,
    '_res2_1_branch2b_bn.wbias': 0.5373, '_res2_1_branch2b_conv.w0': 1.392,
    '_res2_1_branch2c_bn.w0': 1.268, '_res2_1_branch2c_bn.w1': 0.002865,
    '_res2_1_branch2c_bn.w2': 0.006267, '_res2_1_branch2c_bn.wbias': 1.484,
    '_res2_1_branch2c_conv.w0': 1.264, '_res2_2_branch2a_bn.w0': 1.98,
    '_res2_2_branch2a_bn.w1': 0.002872, '_res2_2_branch2a_bn.w2': 0.00732,
    '_res2_2_branch2a_bn.wbias': 1.622, '_res2_2_branch2a_conv.w0': 1.304,
    '_res2_2_branch2b_bn.w0': 0.8929, '_res2_2_branch2b_bn.w1': 0.001919,
    '_res2_2_branch2b_bn.w2': 0.004061, '_res2_2_branch2b_bn.wbias': 1.544,
    '_res2_2_branch2b_conv.w0': 1.324, '_res2_2_branch2c_bn.w0': 1.021,
    '_res2_2_branch2c_bn.w1': 0.004696, '_res2_2_branch2c_bn.w2': 0.008473,
    '_res2_2_branch2c_bn.wbias': 1.246, '_res2_2_branch2c_conv.w0': 1.095,
    '_res2_3_branch2a_bn.w0': 1.553, '_res2_3_branch2a_bn.w1': 0.005787,
    '_res2_3_branch2a_bn.w2': 0.00611, '_res2_3_branch2a_bn.wbias': 1.449,
    '_res2_3_branch2a_conv.w0': 1.23, '_res2_3_branch2b_bn.w0': 2.051,
    '_res2_3_branch2b_bn.w1': 0.001974, '_res2_3_branch2b_bn.w2': 0.004537,
    '_res2_3_branch2b_bn.wbias': 1.688, '_res2_3_branch2b_conv.w0': 1.374,
    '_res2_3_branch2c_bn.w0': 1.035, '_res2_3_branch2c_bn.w1': 0.002771,
    '_res2_3_branch2c_bn.w2': 0.004615, '_res2_3_branch2c_bn.wbias': 1.459,
    '_res2_3_branch2c_conv.w0': 1.124, '_res3_1_branch1_bn.w0': 1.268,
    '_res3_1_branch1_bn.w1': 0.003531, '_res3_1_branch1_bn.w2': 0.004815,
    '_res3_1_branch1_bn.wbias': 1.314, '_res3_1_branch1_conv.w0': 1.437,
    '_res3_1_branch2a_bn.w0': 1.259, '_res3_1_branch2a_bn.w1': 0.004605,
    '_res3_1_branch2a_bn.w2': 0.004189, '_res3_1_branch2a_bn.wbias': 1.3,
    '_res3_1_branch2a_conv.w0': 1.362, '_res3_1_branch2b_bn.w0': 1.597,
    '_res3_1_branch2b_bn.w1': 0.002601, '_res3_1_branch2b_bn.w2': 0.006855,
    '_res3_1_branch2b_bn.wbias': 1.507, '_res3_1_branch2b_conv.w0': 1.359,
    '_res3_1_branch2c_bn.w0': 1.419, '_res3_1_branch2c_bn.w1': 0.004958,
    '_res3_1_branch2c_bn.w2': 0.01044, '_res3_1_branch2c_bn.wbias': 1.314,
    '_res3_1_branch2c_conv.w0': 1.471, '_res3_2_branch2a_bn.w0': 1.186,
    '_res3_2_branch2a_bn.w1': 0.006325, '_res3_2_branch2a_bn.w2': 0.008099,
    '_res3_2_branch2a_bn.wbias': 1.186, '_res3_2_branch2a_conv.w0': 1.424,
    '_res3_2_branch2b_bn.w0': 1.524, '_res3_2_branch2b_bn.w1': 0.003067,
    '_res3_2_branch2b_bn.w2': 0.01198, '_res3_2_branch2b_bn.wbias': 1.496,
    '_res3_2_branch2b_conv.w0': 1.377, '_res3_2_branch2c_bn.w0': 1.25,
    '_res3_2_branch2c_bn.w1': 0.003381, '_res3_2_branch2c_bn.w2': 0.01237,
    '_res3_2_branch2c_bn.wbias': 1.157, '_res3_2_branch2c_conv.w0': 1.358,
    '_res3_3_branch2a_bn.w0': 1.111, '_res3_3_branch2a_bn.w1': 0.004079,
    '_res3_3_branch2a_bn.w2': 0.01064, '_res3_3_branch2a_bn.wbias': 1.341,
    '_res3_3_branch2a_conv.w0': 1.474, '_res3_3_branch2b_bn.w0': 1.127,
    '_res3_3_branch2b_bn.w1': 0.005639, '_res3_3_branch2b_bn.w2': 0.008958,
    '_res3_3_branch2b_bn.wbias': 1.558, '_res3_3_branch2b_conv.w0': 1.387,
    '_res3_3_branch2c_bn.w0': 1.232, '_res3_3_branch2c_bn.w1': 0.005869,
    '_res3_3_branch2c_bn.w2': 0.0157, '_res3_3_branch2c_bn.wbias': 1.396,
    '_res3_3_branch2c_conv.w0': 1.31, '_res3_4_branch2a_bn.w0': 1.487,
    '_res3_4_branch2a_bn.w1': 0.003017, '_res3_4_branch2a_bn.w2': 0.01143,
    '_res3_4_branch2a_bn.wbias': 1.653, '_res3_4_branch2a_conv.w0': 1.287,
    '_res3_4_branch2b_bn.w0': 1.055, '_res3_4_branch2b_bn.w1': 0.003115,
    '_res3_4_branch2b_bn.w2': 0.0095, '_res3_4_branch2b_bn.wbias': 0.9446,
    '_res3_4_branch2b_conv.w0': 1.297, '_res3_4_branch2c_bn.w0': 1.095,
    '_res3_4_branch2c_bn.w1': 0.005847, '_res3_4_branch2c_bn.w2': 0.0153,
    '_res3_4_branch2c_bn.wbias': 1.416, '_res3_4_branch2c_conv.w0': 1.238,
    '_res4_1_branch1_bn.w0': 1.328, '_res4_1_branch1_bn.w1': 0.007902,
    '_res4_1_branch1_bn.w2': 0.02606, '_res4_1_branch1_bn.wbias': 1.335,
    '_res4_1_branch1_conv.w0': 1.273, '_res4_1_branch2a_bn.w0': 1.46,
    '_res4_1_branch2a_bn.w1': 0.006187, '_res4_1_branch2a_bn.w2': 0.02752,
    '_res4_1_branch2a_bn.wbias': 1.471, '_res4_1_branch2a_conv.w0': 1.245,
    '_res4_1_branch2b_bn.w0': 1.283, '_res4_1_branch2b_bn.w1': 0.01739,
    '_res4_1_branch2b_bn.w2': 0.03024, '_res4_1_branch2b_bn.wbias': 1.172,
    '_res4_1_branch2b_conv.w0': 1.214, '_res4_1_branch2c_bn.w0': 1.362,
    '_res4_1_branch2c_bn.w1': 0.008728, '_res4_1_branch2c_bn.w2': 0.05118,
    '_res4_1_branch2c_bn.wbias': 1.335, '_res4_1_branch2c_conv.w0': 1.267,
    '_res4_2_branch2a_bn.w0': 1.267, '_res4_2_branch2a_bn.w1': 0.01256,
    '_res4_2_branch2a_bn.w2': 0.05652, '_res4_2_branch2a_bn.wbias': 1.036,
    '_res4_2_branch2a_conv.w0': 1.27, '_res4_2_branch2b_bn.w0': 1.476,
    '_res4_2_branch2b_bn.w1': 0.02036, '_res4_2_branch2b_bn.w2': 0.0407,
    '_res4_2_branch2b_bn.wbias': 1.486, '_res4_2_branch2b_conv.w0': 1.267,
    '_res4_2_branch2c_bn.w0': 1.301, '_res4_2_branch2c_bn.w1': 0.01403,
    '_res4_2_branch2c_bn.w2': 0.07403, '_res4_2_branch2c_bn.wbias': 1.232,
    '_res4_2_branch2c_conv.w0': 1.291, '_res4_3_branch2a_bn.w0': 1.501,
    '_res4_3_branch2a_bn.w1': 0.01576, '_res4_3_branch2a_bn.w2': 0.08376,
    '_res4_3_branch2a_bn.wbias': 1.476, '_res4_3_branch2a_conv.w0': 1.303,
    '_res4_3_branch2b_bn.w0': 1.281, '_res4_3_branch2b_bn.w1': 0.02477,
    '_res4_3_branch2b_bn.w2': 0.05723, '_res4_3_branch2b_bn.wbias': 1.167,
    '_res4_3_branch2b_conv.w0': 1.28, '_res4_3_branch2c_bn.w0': 1.189,
    '_res4_3_branch2c_bn.w1': 0.01725, '_res4_3_branch2c_bn.w2': 0.09953,
    '_res4_3_branch2c_bn.wbias': 1.369, '_res4_3_branch2c_conv.w0': 1.307,
    '_res4_4_branch2a_bn.w0': 1.363, '_res4_4_branch2a_bn.w1': 0.01405,
    '_res4_4_branch2a_bn.w2': 0.09246, '_res4_4_branch2a_bn.wbias': 1.369,
    '_res4_4_branch2a_conv.w0': 1.318, '_res4_4_branch2b_bn.w0': 1.095,
    '_res4_4_branch2b_bn.w1': 0.0398, '_res4_4_branch2b_bn.w2': 0.08407,
    '_res4_4_branch2b_bn.wbias': 0.9428, '_res4_4_branch2b_conv.w0': 1.295,
    '_res4_4_branch2c_bn.w0': 1.336, '_res4_4_branch2c_bn.w1': 0.01842,
    '_res4_4_branch2c_bn.w2': 0.1327, '_res4_4_branch2c_bn.wbias': 1.386,
    '_res4_4_branch2c_conv.w0': 1.234, '_res4_5_branch2a_bn.w0': 1.188,
    '_res4_5_branch2a_bn.w1': 0.01122, '_res4_5_branch2a_bn.w2': 0.08431,
    '_res4_5_branch2a_bn.wbias': 1.338, '_res4_5_branch2a_conv.w0': 1.243,
    '_res4_5_branch2b_bn.w0': 1.157, '_res4_5_branch2b_bn.w1': 0.03567,
    '_res4_5_branch2b_bn.w2': 0.0875, '_res4_5_branch2b_bn.wbias': 1.178,
    '_res4_5_branch2b_conv.w0': 1.282, '_res4_5_branch2c_bn.w0': 1.168,
    '_res4_5_branch2c_bn.w1': 0.01788, '_res4_5_branch2c_bn.w2': 0.1326,
    '_res4_5_branch2c_bn.wbias': 1.202, '_res4_5_branch2c_conv.w0': 1.228,
    '_res4_6_branch2a_bn.w0': 1.35, '_res4_6_branch2a_bn.w1': 0.02919,
    '_res4_6_branch2a_bn.w2': 0.08107, '_res4_6_branch2a_bn.wbias': 1.19,
    '_res4_6_branch2a_conv.w0': 1.22, '_res4_6_branch2b_bn.w0': 1.233,
    '_res4_6_branch2b_bn.w1': 0.03333, '_res4_6_branch2b_bn.w2': 0.08581,
    '_res4_6_branch2b_bn.wbias': 1.154, '_res4_6_branch2b_conv.w0': 1.19,
    '_res4_6_branch2c_bn.w0': 1.21, '_res4_6_branch2c_bn.w1': 0.02143,
    '_res4_6_branch2c_bn.w2': 0.1786, '_res4_6_branch2c_bn.wbias': 1.085,
    '_res4_6_branch2c_conv.w0': 1.205, '_res5_1_branch1_bn.w0': 1.097,
    '_res5_1_branch1_bn.w1': 0.05876, '_res5_1_branch1_bn.w2': 0.184,
    '_res5_1_branch1_bn.wbias': 0.939, '_res5_1_branch1_conv.w0': 1.182,
    '_res5_1_branch2a_bn.w0': 1.278, '_res5_1_branch2a_bn.w1': 0.06009,
    '_res5_1_branch2a_bn.w2': 0.1653, '_res5_1_branch2a_bn.wbias': 1.221,
    '_res5_1_branch2a_conv.w0': 1.166, '_res5_1_branch2b_bn.w0': 1.253,
    '_res5_1_branch2b_bn.w1': 0.1201, '_res5_1_branch2b_bn.w2': 0.06911,
    '_res5_1_branch2b_bn.wbias': 1.383, '_res5_1_branch2b_conv.w0': 1.219,
    '_res5_1_branch2c_bn.w0': 1.079, '_res5_1_branch2c_bn.w1': 0.04162,
    '_res5_1_branch2c_bn.w2': 0.3019, '_res5_1_branch2c_bn.wbias': 0.939,
    '_res5_1_branch2c_conv.w0': 1.187, '_res5_2_branch2a_bn.w0': 1.14,
    '_res5_2_branch2a_bn.w1': 0.06266, '_res5_2_branch2a_bn.w2': 0.5442,
    '_res5_2_branch2a_bn.wbias': 1.314, '_res5_2_branch2a_conv.w0': 1.213,
    '_res5_2_branch2b_bn.w0': 1.156, '_res5_2_branch2b_bn.w1': 0.1405,
    '_res5_2_branch2b_bn.w2': 0.1107, '_res5_2_branch2b_bn.wbias': 1.218,
    '_res5_2_branch2b_conv.w0': 1.195, '_res5_2_branch2c_bn.w0': 0.9475,
    '_res5_2_branch2c_bn.w1': 0.06273, '_res5_2_branch2c_bn.w2': 0.4045,
    '_res5_2_branch2c_bn.wbias': 0.5615, '_res5_2_branch2c_conv.w0': 1.151,
    '_res5_3_branch2a_bn.w0': 1.075, '_res5_3_branch2a_bn.w1': 0.06177,
    '_res5_3_branch2a_bn.w2': 0.3957, '_res5_3_branch2a_bn.wbias': 1.176,
    '_res5_3_branch2a_conv.w0': 1.208, '_res5_3_branch2b_bn.w0': 1.115,
    '_res5_3_branch2b_bn.w1': 0.1915, '_res5_3_branch2b_bn.w2': 0.1095,
    '_res5_3_branch2b_bn.wbias': 1.229, '_res5_3_branch2b_conv.w0': 1.1,
    '_res5_3_branch2c_bn.w0': 0.7142, '_res5_3_branch2c_bn.w1': 0.05018,
    '_res5_3_branch2c_bn.w2': 0.4055, '_res5_3_branch2c_bn.wbias': 0.3205,
    '_res5_3_branch2c_conv.w0': 0.9942}


def resnet50_cut(paddle, models, side: int, div: int, classes: int):
    """ResNet-50's topology (``models/image.resnet``: the 7x7 stem, the
    ceil-mode max pool, 16 bottleneck blocks, the average pool, the
    softmax fc and the cross-entropy cost ``loss``, under ResNet-50's
    layer names) at 1/``div`` of its widths on ``side``-pixel images,
    built with either package (``paddle`` and its ``models.image``)."""
    import importlib

    L, A, P = paddle.layer, paddle.activation, paddle.pooling
    D = importlib.import_module(paddle.__name__ + ".layers.data_type")
    img = L.data(name="image", type=D.dense_vector(3 * side * side,
                                                   channels=3),
                 height=side, width=side)
    t = models._conv_bn("conv1", img, 7, 64 // div, 2, 3, channels=3)
    t = L.img_pool(name="pool1", input=t, pool_size=3, stride=2)
    for sname, num, f1, f2, stride in (("res2", 3, 64, 256, 1),
                                       ("res3", 4, 128, 512, 2),
                                       ("res4", 6, 256, 1024, 2),
                                       ("res5", 3, 512, 2048, 2)):
        t = models._mid_projection(f"{sname}_1", t, f1 // div, f2 // div,
                                   stride=stride)
        for i in range(2, num + 1):
            t = models._bottleneck(f"{sname}_{i}", t, f1 // div, f2 // div)
    t = L.img_pool(name="avgpool", input=t, pool_size=side // 32, stride=1,
                   pool_type=P.AvgPooling())
    predict = L.fc(input=t, size=classes, act=A.SoftmaxActivation(),
                   name="fc_out")
    label = L.data(name="label", type=D.integer_value(classes))
    return L.cross_entropy_cost(input=predict, label=label, name="loss")


def seeded_params(specs, seed: int = 0) -> dict:
    """Parameters from a numpy generator, the same on every machine and in
    either package: conv filters N(0, 2 / fan_in) (msra), fc weights
    N(0, 2 / (fan_in + fan_out)), BN scales 1, biases 0 (``specs``: the
    topology's (name, shape) pairs, in order)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in specs:
        if len(shape) == 4:
            std = (2.0 / (shape[0] * shape[1] * shape[2])) ** 0.5
        elif len(shape) == 2:
            std = (2.0 / (shape[0] + shape[1])) ** 0.5
        else:
            out[name] = np.full(shape, 1.0 if name.endswith(".w0") else 0.0,
                                np.float32)
            continue
        out[name] = (rng.standard_normal(shape) * std).astype(np.float32)
    return out


def witness_batch(side: int, classes: int, bs: int, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(3 * side * side, dtype=np.float32),
             int(rng.integers(0, classes))) for _ in range(bs)]


def witness_setup(cfg: dict):
    """ResNet-50 at ``cfg`` (``resnet50_cut``), its seeded parameters, the
    witness batch, and a maker of ``trainer.SGD`` (Momentum 0.9 at lr 0.1
    / 64) from them: ``trainer(device, compute_dtype)``."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.config.topology import Topology
    from paddle_tpu_torch.core.parameters import Parameters
    from paddle_tpu_torch.layers.base import reset_name_counters

    reset_name_counters()
    cost = resnet50_cut(paddle, paddle.models.image, cfg["side"], cfg["div"],
                        cfg["classes"])
    carried = seeded_params([(s.name, s.shape)
                             for s in Topology(cost).param_specs()])
    batch = witness_batch(cfg["side"], cfg["classes"], cfg["batch"])

    def trainer(where, dtype):
        return paddle.trainer.SGD(
            cost=cost, parameters=Parameters.from_numpy(carried),
            update_equation=paddle.optimizer.Momentum(
                momentum=0.9, learning_rate=0.1 / 64),
            device=where, compute_dtype=dtype)
    return carried, batch, trainer


def one_step(tr, batch) -> float:
    """One ``train`` step of ``tr`` on ``batch``; its cost."""
    import paddle_tpu_torch as paddle

    costs = []
    tr.train(reader=lambda: iter([batch]), num_passes=1,
             event_handler=lambda e: costs.append(e.cost)
             if isinstance(e, paddle.event.EndIteration) else None)
    torch.cuda.synchronize()
    return costs[0]


def bn_mean_term_dropped(y_conv, gamma, beta, eps, act):
    """The planted fault of the BN witnesses: a train-mode BN whose
    backward drops the batch mean's term."""
    from paddle_tpu_torch.ops import nn as nn_ops
    from paddle_tpu_torch.ops.kernels import conv as CV

    mean, var = nn_ops.moments(y_conv)
    return CV.bn_apply(y_conv, mean.detach(), var, gamma, beta, eps, act)


def step_spread(start: dict, ref: dict, got: dict) -> dict:
    """``got``'s step against ``ref``'s, both from ``start``: per leaf
    ``leaf_ratios``' median and largest, and over all leaves at once
    ||got - ref|| / ||ref - start||."""
    ratios = leaf_ratios(start, ref, got)
    sq = sum(float(np.sum((ref[n] - start[n]) ** 2)) for n in ref)
    err = sum(float(np.sum((got[n] - ref[n]) ** 2)) for n in ref)
    return {"median": float(np.median(list(ratios.values()))),
            "largest": max(ratios.values()),
            "leaf": max(ratios, key=ratios.get), "global": (err / sq) ** 0.5}


def bf16_witness(dev) -> dict:
    """The bf16 witness step at ``BF16_WITNESS_NET``: one
    ``trainer.SGD(compute_dtype=torch.bfloat16)`` step on the card
    (kernels) and on the CPU (plain twins), each held against the float64
    step on the CPU per leaf, ||x - x64|| / ||x64 - x0|| (``leaf_ratios``'
    floored ratio), parameters and BN statistics, within 2x the JAX
    package's own error at the same step (``BF16_WITNESS_JAX``) plus
    BF16_WITNESS_FLOOR.  A card step whose BN backward drops the batch
    mean's term must exceed it; the card's step repeats bit for bit;
    parameters and states are f32 afterwards.  Written down beside it:
    the card's step against the CPU's, and how far the CPU's step moves
    when one bf16 ulp is added to 0.01% of the input pixels (a step
    dominated by amplified round-off moves about its whole length)."""
    from paddle_tpu_torch.ops.kernels import conv as CV

    carried, batch, trainer = witness_setup(BF16_WITNESS_NET)
    wide = trainer("cpu", None)
    s0 = {k: v.numpy() for k, v in wide.states.items()}
    p64, s64, c64 = wide.step_f64(batch)
    del wide
    rng = np.random.default_rng(1)
    nudged = [(np.where(rng.random(x.shape) < 1e-4, x * (1 + 2.0 ** -8),
                        x).astype(np.float32), y) for x, y in batch]
    plain_bn = CV.bn_act_train
    sides = {}
    for label, where, data in (
            ("card", dev, batch), ("card_rerun", dev, batch),
            ("cpu", "cpu", batch), ("cpu_nudged", "cpu", nudged),
            ("card_bn_vjp_control", dev, batch)):
        tr = trainer(where, torch.bfloat16)
        if label == "card_bn_vjp_control":
            CV.bn_act_train = bn_mean_term_dropped
        try:
            c = one_step(tr, data)
        finally:
            CV.bn_act_train = plain_bn
        sides[label] = (c, {n: tr.parameters[n] for n in carried},
                        {k: v.cpu().numpy() for k, v in tr.states.items()})
        if not (all(v.dtype == np.float32 for v in sides[label][1].values())
                and all(v.dtype == np.float32
                        for v in sides[label][2].values())):
            raise AssertionError(f"{label}: bf16 step left non-f32 masters or"
                                 " states")
        del tr
    (c_a, p_a, s_a), (c_b, p_b, s_b) = sides["card"], sides.pop("card_rerun")
    if not (c_a == c_b and all(np.array_equal(p_a[n], p_b[n]) for n in p_a)
            and all(np.array_equal(s_a[k], s_b[k]) for k in s_a)):
        raise AssertionError("the card's bf16 step is not bit-identical on a "
                             "rerun")
    out = {"net": BF16_WITNESS_NET, "cost_f64": c64,
           "limit": f"2 x JAX's own + {BF16_WITNESS_FLOOR}"}
    for label in ("card", "cpu", "card_bn_vjp_control"):
        c, p_side, s_side = sides[label]
        row, over = {"cost": c}, []
        for part, start, ref, got in (("param", carried, p64, p_side),
                                      ("state", s0, s64, s_side)):
            ratios = leaf_ratios(start, ref, got)
            share = {n: r / (2 * BF16_WITNESS_JAX[n] + BF16_WITNESS_FLOOR)
                     for n, r in ratios.items()}
            n_worst = max(share, key=share.get)
            row[part] = {"leaf": n_worst, "ratio": ratios[n_worst],
                         "jax": BF16_WITNESS_JAX[n_worst],
                         "share_of_limit": share[n_worst],
                         "largest_ratio": max(ratios.values()),
                         "median_ratio": float(np.median(list(
                             ratios.values())))}
            over += [n for n, x in share.items() if x > 1]
        row["leaves_over_limit"] = over
        out[label] = row
    for label in ("card", "cpu"):
        if out[label]["leaves_over_limit"] or not np.isfinite(
                out[label]["cost"]):
            raise AssertionError(f"bf16 {label} step vs the f64 witness: "
                                 f"{out}")
    if not out["card_bn_vjp_control"]["leaves_over_limit"]:
        raise AssertionError("the bf16 witness limit does not catch a BN "
                             f"backward without its mean term: {out}")
    out["card_bn_vjp_control"]["leaves_over_limit"] = len(
        out["card_bn_vjp_control"]["leaves_over_limit"])
    cpu = sides["cpu"][1]
    out["card_vs_cpu"] = step_spread(carried, cpu, p_a)
    out["cpu_nudged_vs_cpu"] = step_spread(carried, cpu,
                                           sides["cpu_nudged"][1])
    out["card_rerun_bit_identical"] = True
    return out


def rel_norm(got, want) -> float:
    """||got - want|| / ||want|| in float64 (0 where both are 0)."""
    g, w = got.detach().double().cpu(), want.detach().double().cpu()
    den = float(w.norm())
    return float((g - w).norm()) / den if den else float((g - w).norm())


def bf16_layer_witness(dev, cfg=BF16_WITNESS_FULL, controls_at=3) -> dict:
    """The card's bf16 step at ``cfg`` (full-width ResNet-50, batch 8)
    layer by layer: every ``conv2d_bn_act`` backward of the step (53,
    ``_CbrTrain``: BN's backward in bf16, then cuDNN's conv backward) is
    recorded with the tensors it was given (x, w, gamma, beta, the
    kernel's y_conv, the cotangent) and recomputed on the CPU by the plain
    twins (``bn_act_train``, ``conv_input_grads``); dx, dw, dgamma, dbeta
    each within BF16_LAYER_LIMIT relative norm.  Held on the same inputs,
    the comparison does not see the step's amplified round-off.  Two
    planted faults on the card must exceed it at the first
    ``controls_at`` layers the backward reaches: every conv's dw dropped,
    and a BN backward without its mean term.  Beside it: the card's
    step against the float64 step on the CPU, per leaf (the bf16 error
    at full width; no JAX error is at hand there)."""
    from paddle_tpu_torch.ops.kernels import conv as CV

    t0 = time.perf_counter()
    carried, batch, trainer = witness_setup(cfg)
    plain_bn, plain_grads = CV.bn_act_train, CV.conv_input_grads
    plain_backward = CV._CbrTrain.backward

    def conv_dw_dropped(x, w, dy, strides, pads, needed=(True, True)):
        dx, dw = plain_grads(x, w, dy, strides, pads, needed)
        return dx, None if dw is None else torch.zeros_like(dw)

    def recorded(patch=None):
        records = []

        def backward(ctx, dy, dmean, dvar):
            grads = plain_backward(ctx, dy, dmean, dvar)
            records.append((ctx.saved_tensors, ctx.cfg,
                            ctx.needs_input_grad[:2], dy, grads[:4]))
            return grads

        tr = trainer(dev, torch.bfloat16)
        CV._CbrTrain.backward = staticmethod(backward)
        if patch:
            setattr(CV, *patch)
        try:
            cost = one_step(tr, batch)
        finally:
            CV._CbrTrain.backward = staticmethod(plain_backward)
            CV.bn_act_train, CV.conv_input_grads = plain_bn, plain_grads
        return tr, cost, records

    def layer_errors(records):
        rows = []
        for saved, (strides, pads, eps, act), needed, dy, grads in records:
            x, w, gamma, beta, y_conv = (t.detach().cpu() for t in saved)
            leaves = [t.requires_grad_() for t in (y_conv, gamma, beta)]
            with torch.enable_grad():
                y = plain_bn(*leaves, eps, act)
                dyc, dga, dbe = torch.autograd.grad(y, leaves, dy.cpu())
            dx, dw = plain_grads(x, w, dyc, strides, pads, needed)
            rows.append({k: rel_norm(g, r) for k, g, r in zip(
                ("dx", "dw", "dgamma", "dbeta"), grads, (dx, dw, dga, dbe))
                if r is not None})
        return rows

    tr, cost, records = recorded()
    if len(records) != 53:
        raise AssertionError(f"{len(records)} conv + BN backward passes "
                             "recorded, not ResNet-50's 53")
    errs = layer_errors(records)
    del records
    worst = {k: max(r[k] for r in errs if k in r)
             for k in ("dx", "dw", "dgamma", "dbeta")}
    out = {"net": cfg, "layers": len(errs), "limit": BF16_LAYER_LIMIT,
           "cost": cost, "worst": worst,
           "median": {k: float(np.median([r[k] for r in errs if k in r]))
                      for k in worst}}
    if max(worst.values()) > BF16_LAYER_LIMIT or not np.isfinite(cost):
        raise AssertionError(f"bf16 layer witness: {out} {errs}")
    card = {n: tr.parameters[n] for n in carried}
    if not all(v.dtype == np.float32 for v in card.values()):
        raise AssertionError("the bf16 step left non-f32 masters")
    del tr
    for label, patch in (
            ("conv_dw_dropped_control", ("conv_input_grads", conv_dw_dropped)),
            ("bn_vjp_control", ("bn_act_train", bn_mean_term_dropped))):
        _, _, records = recorded(patch)
        rows = layer_errors(records[:controls_at])
        del records
        out[label] = [max(r.values()) for r in rows]
        if not all(e > BF16_LAYER_LIMIT for e in out[label]):
            raise AssertionError(f"the bf16 layer witness does not catch "
                                 f"{label}: {out}")
    p64, _, c64 = trainer("cpu", None).step_f64(batch)
    out["card_vs_f64"] = step_spread(carried, p64, card)
    out["cost_f64"] = c64
    out["seconds"] = time.perf_counter() - t0
    return out


def tile_counters():
    """{name: Kernel} of the shared tiles' forms, the fused update and
    channel_stats' forms."""
    from paddle_tpu_torch.ops.kernels import brgemm as BR
    from paddle_tpu_torch.ops.kernels import channel_stats as CS
    from paddle_tpu_torch.ops.kernels import conv as CV
    from paddle_tpu_torch.ops.kernels import update as UP

    return {"brgemm": BR.KERNEL, "conv2d_direct": CV.KERNEL,
            "brgemm_bf16": BR.KERNEL_BF16,
            "conv2d_direct_bf16": CV.KERNEL_BF16,
            "brgemm_wgmma": BR.KERNEL_WGMMA,
            "conv2d_direct_wgmma": CV.KERNEL_WGMMA,
            "channel_stats": CS.KERNEL, "channel_stats_bf16": CS.KERNEL_BF16,
            "fused_update": UP.KERNEL}


def zero_counts() -> None:
    for k in tile_counters().values():
        k.launches = 0


def read_counts() -> dict:
    return {n: k.launches for n, k in tile_counters().items()}


def per_step(per_step_counts: dict, steps: int) -> dict:
    """Every counter of :func:`tile_counters` at ``per_step_counts`` x
    ``steps`` (0 where not named)."""
    return {n: per_step_counts.get(n, 0) * steps for n in tile_counters()}


def dtype_blocks(trainers: dict, data: list, want: dict, stamp_of,
                 counters=None, feeding=None) -> dict:
    """Timed steps in blocks of ``len(data)``: bf16, f32, f32, bf16, so a
    drift of the machine falls on both sides.  ``trainers`` and ``want``
    ({counter: launches a step}) by dtype name; each block's launches of
    ``counters`` ({name: Kernel}, default :func:`tile_counters`) are
    zeroed just before it and read just after, and must equal ``want``.
    Returns per dtype the step ms, img/s of each block's wall, the peak
    memory and the costs."""
    import paddle_tpu_torch as paddle

    counters = counters or tile_counters()
    out = {d: {"step_ms": [], "walls": [], "costs": [], "peak": 0,
               "launches": []} for d in trainers}
    for d in ("bf16", "f32", "f32", "bf16"):
        marks: dict = {}
        stamp = stamp_of(marks)

        def handler(e, costs=out[d]["costs"]):
            stamp(e)
            if isinstance(e, paddle.event.EndIteration):
                costs.append(e.cost)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in counters.values():
            k.launches = 0
        t0 = time.perf_counter()
        trainers[d].train(reader=lambda: iter(data), num_passes=1,
                          event_handler=handler, feeding=feeding)
        torch.cuda.synchronize()
        out[d]["walls"].append(time.perf_counter() - t0)
        got = {n: k.launches for n, k in counters.items()}
        if got != {n: want[d].get(n, 0) * len(data) for n in counters}:
            raise AssertionError(f"{d} block launches {got} != "
                                 f"{want[d]} x {len(data)}")
        out[d]["launches"].append(got)
        out[d]["peak"] = max(out[d]["peak"], torch.cuda.max_memory_allocated())
        out[d]["step_ms"] += [1e3 * (b - a) for a, b in marks.values()]
    return out


def stamp_factory(marks):
    import paddle_tpu_torch as paddle

    def stamp(e):
        if isinstance(e, (paddle.event.BeginIteration,
                          paddle.event.EndIteration)):
            marks.setdefault(e.batch_id, []).append(time.perf_counter())
    return stamp


def rates(blocks: dict, bs: int) -> dict:
    return {d: {"images_per_s": bs * len(b["step_ms"]) / sum(b["walls"]),
                "step_ms_p50": float(np.percentile(b["step_ms"], 50)),
                "step_ms": b["step_ms"], "max_memory_allocated_bytes":
                    b["peak"], "costs": b["costs"],
                "launches_per_block": b["launches"][0]}
            for d, b in blocks.items()}


def train_resnet_bf16(dev, bs=64, steps=10, side=224, classes=1000) -> tuple:
    """ResNet-50 through ``trainer.SGD(compute_dtype=torch.bfloat16)`` at
    phase 4's configuration (224x224x3, 1,000 classes, Momentum 0.9 at lr
    0.1 / 64, batch 64): the witness steps (:func:`bf16_witness` at
    ``BF16_WITNESS_NET``, :func:`bf16_layer_witness` at full width); the
    first bf16 step twice, in the same bits; then a bf16 and an f32
    trainer from the same parameters, 2 warm-up steps
    each, and ``steps`` timed steps each in blocks (bf16, f32, f32, bf16)
    with exactly 36 ``brgemm_wgmma``, 16 ``conv2d_direct_wgmma``, 1
    ``conv2d_direct_bf16`` (the stem: Cin 3 takes the mma.sync tile) and
    1 fused-update launches a bf16 step and no f32 tile launch (and the
    f32 forms' 36 and 17 in an f32 step); 3 bf16 steps under
    ``torch.profiler``; ``test`` on 2 batches through the bf16 trainer:
    exactly 36 and 17 f32 launches a batch and no bf16 one."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.parameters import Parameters
    from paddle_tpu_torch.layers.base import reset_name_counters

    t0 = time.perf_counter()
    witness = {"cut": bf16_witness(dev), "full_width": bf16_layer_witness(dev)}
    reset_name_counters()
    cost = paddle.models.image.resnet_cost(depth=50, class_num=classes,
                                           height=side, width=side)[0]
    created = paddle.parameters.create(cost)
    carried = {n: created[n] for n in created.names()}
    rng = np.random.default_rng(0)

    def batches(k):
        return [[(rng.standard_normal(3 * side * side, dtype=np.float32),
                  int(rng.integers(0, classes))) for _ in range(bs)]
                for _ in range(k)]

    def trainer(dtype):
        return paddle.trainer.SGD(
            cost=cost, parameters=Parameters.from_numpy(carried),
            update_equation=paddle.optimizer.Momentum(
                momentum=0.9, learning_rate=0.1 / bs), device=dev,
            compute_dtype=dtype)

    # the first bf16 step twice: the same bits at every ResNet-50 shape
    # (cuDNN's bf16 conv backward under deterministic algorithms)
    first, firsts = batches(1), []
    for _ in range(2):
        tr = trainer(torch.bfloat16)
        tr.train(reader=lambda: iter(first), num_passes=1,
                 event_handler=lambda e: None)
        firsts.append({n: tr.parameters[n] for n in carried})
        del tr
    if not all(np.array_equal(firsts[0][n], firsts[1][n]) for n in carried):
        raise AssertionError("ResNet-50's first bf16 step is not "
                             "bit-identical on a rerun")
    del firsts
    trainers = {"bf16": trainer(torch.bfloat16), "f32": trainer(None)}
    warm = batches(2)
    for tr in trainers.values():
        tr.train(reader=lambda: iter(warm), num_passes=1,
                 event_handler=lambda e: None)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    want = {"bf16": {"brgemm_wgmma": 36, "conv2d_direct_wgmma": 16,
                     "conv2d_direct_bf16": 1, "fused_update": 1},
            "f32": {"brgemm": 36, "conv2d_direct": 17, "fused_update": 1}}
    blocks = dtype_blocks(trainers, batches(steps // 2), want, stamp_factory)
    out = rates(blocks, bs)
    for d in out:
        if not all(np.isfinite(out[d]["costs"])):
            raise AssertionError(f"ResNet-50 {d} costs {out[d]['costs']}")
    traced = batches(3)
    bf16 = trainers["bf16"]
    prof = profile_window(lambda: bf16.train(
        reader=lambda: iter(traced), num_passes=1,
        event_handler=lambda e: None), len(traced))
    if "device_busy_ms_per_step" in prof:
        prof["idle_share_vs_step_p50"] = (
            1 - prof["device_busy_ms_per_step"] / out["bf16"]["step_ms_p50"])
    zero_counts()
    result = bf16.test(reader=lambda: iter(batches(2)))
    torch.cuda.synchronize()
    test_n = read_counts()
    if test_n != per_step({"brgemm": 36, "conv2d_direct": 17}, 2) or \
            not np.isfinite(result.cost):
        raise AssertionError(f"bf16 trainer's test launches {test_n} or cost "
                             f"{result.cost}")
    for tr in trainers.values():
        if not all(tr.parameters[n].dtype == np.float32 for n in carried):
            raise AssertionError("masters are not f32 after the bf16 steps")
    del trainers, bf16
    return ({"phase": "train_bf16", "model": "resnet50", "batch": bs,
             "compute_dtype": "bfloat16", "step_vs_f64_witness": witness,
             "first_step_rerun_bit_identical": True,
             "steps_per_dtype": steps, **out, "bf16_vs_f32_images_per_s":
                 out["bf16"]["images_per_s"] / out["f32"]["images_per_s"],
             "test_launches": test_n, "test_cost": result.cost,
             "setup_s": setup_s, "profile": prof},
            {k: sum(b[k] for b in blocks["bf16"]["launches"])
             for k in ("brgemm_bf16", "conv2d_direct_bf16", "brgemm_wgmma",
                       "conv2d_direct_wgmma")})


def train_vgg_bf16(dev, bs=128, steps=10) -> tuple:
    """small_vgg at phase 9's configuration through ``trainer.SGD(
    compute_dtype=torch.bfloat16)`` beside f32 from the same parameters:
    2 warm-up steps each, ``steps`` timed steps each in blocks (bf16, f32,
    f32, bf16) with exactly 11 ``channel_stats_bf16``, 9
    ``conv2d_direct_wgmma``, 1 ``conv2d_direct_bf16`` (the first conv's
    Cin 3) and 1 fused-update launches a bf16 step and no f32 form's;
    the bf16 costs finite and falling."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import rng as prng
    from paddle_tpu_torch.core.parameters import Parameters
    from paddle_tpu_torch.dataset import cifar
    from paddle_tpu_torch.layers.base import reset_name_counters

    reset_name_counters()
    cost = vgg_cost(paddle)
    created = paddle.parameters.create(cost)
    carried = {n: created[n] for n in created.names()}
    samples = list(cifar.train10()())
    batches = [samples[i:i + bs] for i in range(0, len(samples) - bs + 1,
                                                bs)]
    prng.seed(13)
    trainers = {d: paddle.trainer.SGD(
        cost=cost, parameters=Parameters.from_numpy(carried),
        update_equation=paddle.optimizer.Momentum(
            momentum=0.9, learning_rate=0.1 / 128,
            regularization=paddle.optimizer.L2Regularization(
                rate=0.0002 * 128)), device=dev, compute_dtype=dt)
        for d, dt in (("bf16", torch.bfloat16), ("f32", None))}
    for tr in trainers.values():
        tr.train(reader=lambda: iter(batches[:2]), num_passes=1,
                 event_handler=lambda e: None)
    want = {"bf16": {"channel_stats_bf16": 11, "conv2d_direct_wgmma": 9,
                     "conv2d_direct_bf16": 1, "fused_update": 1},
            "f32": {"channel_stats": 11, "conv2d_direct": 10,
                    "fused_update": 1}}
    blocks = dtype_blocks(trainers, batches[2:2 + steps // 2], want,
                          stamp_factory)
    out = rates(blocks, bs)
    c = out["bf16"]["costs"]
    if not (all(np.isfinite(c)) and np.mean(c[-3:]) < np.mean(c[:3])):
        raise AssertionError(f"small_vgg bf16 costs not finite and falling: "
                             f"{c}")
    del trainers
    return ({"phase": "train_vgg_bf16", "model": "small_vgg", "batch": bs,
             "compute_dtype": "bfloat16", "steps_per_dtype": steps, **out,
             "bf16_vs_f32_images_per_s":
                 out["bf16"]["images_per_s"] / out["f32"]["images_per_s"]},
            {k: sum(b[k] for b in blocks["bf16"]["launches"])
             for k in ("channel_stats_bf16", "conv2d_direct_bf16",
                       "conv2d_direct_wgmma")})


#: (builder, image side, classes, direct-conv and BRGEMM launches a step)
BENCH_NETS = {"smallnet": ("smallnet_cost", 32, 10, 3, 0),
              "alexnet": ("alexnet_cost", 227, 1000, 5, 0),
              "googlenet": ("googlenet_cost", 224, 1000, 20, 37),
              "vgg19": ("vgg_cost", 224, 1000, 16, 0)}


def bench_nets(dev, bs=64, warm=2, steps=5) -> dict:
    """``bench.py``'s image nets under its ``_image_step`` configuration
    (one fixed batch of N(0, 1) images, Momentum 0.9 at lr 0.01 / batch),
    through ``trainer.SGD`` in f32 and then, from freshly created
    parameters, in bf16 (``compute_dtype``, as ``bench.py:113-114``
    trains them): smallnet, AlexNet and GoogLeNet 2 warm-up and 5 timed
    steps each (ms a batch), VGG-19 one step; each with its exact conv
    launches a step in the dtype's forms and none in the other's (in
    bf16 every net's first conv, Cin 3, on the mma.sync tile, the rest on
    the Hopper tile)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.layers.base import reset_name_counters

    out = {"phase": "bench_nets", "batch": bs}
    for name, (builder, side, classes, n_direct, n_brgemm) in \
            BENCH_NETS.items():
        reset_name_counters()
        cost = getattr(paddle.models.image, builder)(
            class_num=classes, height=side, width=side)[0]
        r = np.random.default_rng(0)
        batch = [(x, int(y)) for x, y in zip(
            r.normal(size=(bs, 3 * side * side)).astype(np.float32),
            r.integers(0, classes, size=bs))]
        n_warm, n_timed = (warm, steps) if name != "vgg19" else (0, 1)
        for dname, dtype, suffix in (("f32", None, ""),
                                     ("bf16", torch.bfloat16, "_bf16")):
            tr = paddle.trainer.SGD(
                cost=cost, parameters=paddle.parameters.create(cost),
                update_equation=paddle.optimizer.Momentum(
                    momentum=0.9, learning_rate=0.01 / bs), device=dev,
                compute_dtype=dtype)
            costs = []

            def run(k, handler=None):
                tr.train(reader=lambda: iter([batch] * k), num_passes=1,
                         event_handler=handler)

            run(n_warm)
            torch.cuda.synchronize()
            zero_counts()
            marks: dict[int, list] = {}

            def stamp(e):
                if isinstance(e, (paddle.event.BeginIteration,
                                  paddle.event.EndIteration)):
                    marks.setdefault(e.batch_id, []).append(
                        time.perf_counter())
                if isinstance(e, paddle.event.EndIteration):
                    costs.append(e.cost)

            run(n_timed, stamp)
            torch.cuda.synchronize()
            got = read_counts()
            forms = ({"conv2d_direct": n_direct, "brgemm": n_brgemm}
                     if dtype is None else
                     {"conv2d_direct_bf16": 1,
                      "conv2d_direct_wgmma": n_direct - 1,
                      "brgemm_wgmma": n_brgemm})
            want = per_step({**forms, "fused_update": 1}, n_timed)
            if got != want or not all(np.isfinite(costs)):
                raise AssertionError(f"{name} {dname}: launches {got} != "
                                     f"{want} or costs {costs}")
            step_ms = [1e3 * (b - a) for a, b in marks.values()]
            row = {"steps": n_timed, "ms_per_batch_p50":
                   float(np.percentile(step_ms, 50)), "step_ms": step_ms,
                   "costs": costs,
                   "launches_per_step": {k: v // n_timed
                                         for k, v in got.items() if v}}
            if dtype is None:
                out[name] = {"image": [side, side, 3], "classes": classes,
                             **row}
            else:
                out[name]["bf16"] = row
            del tr
            torch.cuda.empty_cache()
    return out


# -- the optimizer update (rows 16 and 19) and the Wide & Deep CTR ------------

#: bench.py's bench_ctr: wide 10,000, 8 fields of vocab 1,000, embedding
#: 64, hidden (256, 128), batch 1,024
CTR_WIDE, CTR_FIELDS, CTR_VOCAB, CTR_EMBED, CTR_HIDDEN = (10_000, 8, 1000,
                                                          64, (256, 128))


def bits_equal(a, b) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def fresh_updates(ups) -> list:
    """Copies of the updates' p and v, the gradients shared: an in-place
    run of its own, the originals left for the twins."""
    import dataclasses

    return [dataclasses.replace(u, p=u.p.clone(),
                                v=None if u.v is None else u.v.clone())
            for u in ups]


def host_ms(fn, iters: int = 50) -> float:
    """Median wall ms the host spends in one call of ``fn``, without a
    sync: what issuing it costs a host-led step."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e3


#: planted faults of the update kernels (csrc/update.cu): the row-lazy
#: kernel lets an untouched row take the rule (its momentum advances, its
#: decay applies)
UPDATE_FAULTS = {"untouched_rows_move": (
    "  if (!__any_sync(0xffffffffu, mine)) return;  // untouched: left as "
    "it is",
    "  (void)__any_sync(0xffffffffu, mine);  // planted: untouched rows "
    "move")}


def update_agrees(run, twin, ups, lazy=False) -> tuple[bool, float]:
    """``run`` on two sets of copies of ``ups`` against ``twin`` on the
    originals: (the twin's bits, in place on both sets, a rerun equal,
    untouched rows kept when ``lazy``; the largest gap)."""
    want = [twin(u) for u in ups]
    first, second = fresh_updates(ups), fresh_updates(ups)
    got, again = run(first), run(second)
    torch.cuda.synchronize()
    ok, err = True, 0.0
    for u, f, (want_p, want_v), (p2, v2), (p3, v3) in zip(ups, first, want,
                                                          got, again):
        ok &= p2 is f.p and v2 is f.v
        err = max(err, (p2 - want_p).abs().max().item())
        ok &= bits_equal(p2, want_p) and bits_equal(p2, p3)
        if v2 is not None:
            err = max(err, (v2 - want_v).abs().max().item())
            ok &= bits_equal(v2, want_v) and bits_equal(v2, v3)
        if lazy:
            still = ~(u.g != 0).any(dim=1)
            ok &= bits_equal(p2[still], u.p[still])
            ok &= v2 is None or bits_equal(v2[still], u.v[still])
    return bool(ok), err


def stale_table_caught(dev) -> dict:
    """The planted fault of the kept table: a key without the p and v
    pointers (``table_key``), so a table is not rebuilt after a parameter
    tensor is replaced; the replaced tensor then misses its step and the
    twin check must fail.  The same replacement with the real key
    passes."""
    from paddle_tpu_torch.ops.kernels import update as UP

    gen = torch.Generator(device=dev).manual_seed(3)
    ups = [UP.TensorUpdate(*(torch.randn(s, generator=gen, device=dev)
                             for _ in range(3)), 0.1, 0.9)
           for s in ((64, 3, 3, 3), (1000,), (37, 5))]
    real = UP.table_key
    out = {}
    for label, key in (("stale", lambda ps, vs, sc: (
            sc, tuple(t.shape for t in ps))), ("real", real)):
        UP.table_key = key
        try:
            UP.fused_update(ups)
            old = ups[1].p      # kept alive: a stale table writes it
            ups[1].p = old.clone()
            want = UP.reference_update(ups[1])
            UP.fused_update(ups)
            torch.cuda.synchronize()
            out[label] = bits_equal(ups[1].p, want[0])
            del old
        finally:
            UP.table_key = real
            UP.KERNEL.tables.clear()
    if out["stale"] or not out["real"]:
        raise AssertionError(f"the kept table's planted fault: {out} (the "
                             "stale key must miss the replaced tensor)")
    return {"stale_key_twin_bits": out["stale"],
            "real_key_twin_bits": out["real"]}


def check_update_kernels(dev, timer) -> tuple[list, dict]:
    """The fused update (row 16) against its twin on ResNet-50's 161
    tensors (Momentum 0.9 at lr 0.1 / 64, phase 4's) and small_vgg's 46
    (Momentum 0.9 at lr 0.1 / 128, L2 0.0002 x 128, phase 9's), and the
    row-lazy update (row 19) on the CTR's 8 [1000, 64] tables with the
    rows one batch of 1,024 uniform ids touches (Momentum 0.9 at lr
    0.05): in place on copies, bit for bit, a rerun in the same bits.
    Each timed in place on a kept table (built by the first call; the
    timed calls must build none) beside the per-tensor twin loop and its
    bound (20 bytes an element), with the host's ms a call (no sync); row
    16 also beside ``torch.optim.SGD(momentum=0.9, fused=True)`` and
    ``foreach=True`` on the same list (the same rule, not the same bits).
    Planted faults that must fail: a stale kept table
    (``stale_table_caught``) and a row-lazy kernel that moves untouched
    rows (``UPDATE_FAULTS``)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.config.topology import Topology
    from paddle_tpu_torch.layers.base import reset_name_counters
    from paddle_tpu_torch.ops.kernels import embedding as EK
    from paddle_tpu_torch.ops.kernels import update as UP

    builds = source_fault_builds("update", UPDATE_FAULTS)
    gen = torch.Generator(device=dev).manual_seed(16)

    def rand(shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def shapes_of(cost):
        return [s.shape for s in Topology(cost).param_specs()]

    def kept_timing(kernel, fn, key):
        """ms, host ms and kernel-only ms of ``fn`` on a kept table."""
        fn()
        n0 = kernel.table_builds
        out = {"ms": timer(fn), "host_ms": host_ms(fn),
               "kernel_only_ms": device_ms([fn], key)}
        if kernel.table_builds != n0:
            raise AssertionError(f"{key}: the timed calls built "
                                 f"{kernel.table_builds - n0} tables")
        return out

    reset_name_counters()
    resnet = shapes_of(paddle.models.image.resnet_cost(
        depth=50, class_num=1000, height=224, width=224)[0])
    reset_name_counters()
    vgg = shapes_of(vgg_cost(paddle))
    dense = {}
    for label, shapes, lr, wd in (("resnet50", resnet, 0.1 / 64, 0.0),
                                  ("small_vgg", vgg, 0.1 / 128,
                                   0.0002 * 128)):
        ups = [UP.TensorUpdate(rand(s), rand(s, 1e-2), rand(s, 1e-2), lr,
                               0.9, False, wd) for s in shapes]
        ok, err = update_agrees(UP.fused_update, UP.reference_update, ups)
        if not ok:
            raise AssertionError(f"fused update on {label}: not the "
                                 "twin's bits, not in place, or not on a "
                                 "rerun")
        n = sum(u.p.numel() for u in ups)
        bound_ms, by = bound(20.0 * n, (6.0 if wd else 4.0) * n)
        libs = {}
        for kind in ("fused", "foreach"):
            ps = [torch.nn.Parameter(u.p.clone()) for u in ups]
            for p, u in zip(ps, ups):
                p.grad = u.g
            opt = torch.optim.SGD(ps, lr=lr, momentum=0.9, weight_decay=wd,
                                  **{kind: True})
            libs[kind] = timer(opt.step)
            libs[f"{kind}_host"] = host_ms(opt.step)
            del ps, opt
        dense[label] = {
            "tensors": len(ups), "params": n, "lr": lr, "mu": 0.9, "wd": wd,
            "max_abs_err": err,
            **kept_timing(UP.KERNEL, lambda: UP.fused_update(ups),
                          "fused_update_kernel"),
            "plain_ms": timer(lambda: [UP.reference_update(u)
                                       for u in ups]),
            "bound_ms": bound_ms, "bound_by": by,
            "library_ms": libs["fused"], "library_host_ms": libs["fused_host"],
            "library_foreach_ms": libs["foreach"],
            "library_foreach_host_ms": libs["foreach_host"]}
        del ups
        torch.cuda.empty_cache()

    # row 19: the rows a batch of 1,024 uniform ids touches in each table
    ups, touched = [], 0
    for _ in range(CTR_FIELDS):
        ids = torch.randint(0, CTR_VOCAB, (1024,), generator=gen, device=dev)
        hit = torch.zeros(CTR_VOCAB, dtype=torch.bool, device=dev)
        hit[ids] = True
        touched += int(hit.sum())
        g = rand((CTR_VOCAB, CTR_EMBED)) * hit[:, None]
        ups.append(UP.TensorUpdate(rand((CTR_VOCAB, CTR_EMBED)), g,
                                   rand((CTR_VOCAB, CTR_EMBED), 1e-2), 0.05,
                                   0.9, False, 0.0))
    ok, err = update_agrees(EK.sparse_row_update, EK.reference_row_update,
                            ups, lazy=True)
    if not ok:
        raise AssertionError("row-lazy update: not the twin's bits, not in "
                             "place, not on a rerun, or an untouched row "
                             "moved")
    n = CTR_FIELDS * CTR_VOCAB * CTR_EMBED
    # in place: every gradient read (4 bytes an element), the touched
    # rows' p and v read and written
    bound_ms, by = bound(4.0 * n + 16.0 * touched * CTR_EMBED,
                         4.0 * touched * CTR_EMBED)
    lazy = {"tables": CTR_FIELDS, "shape": [CTR_VOCAB, CTR_EMBED],
            "touched_rows": touched,
            "touched_share": touched / (CTR_FIELDS * CTR_VOCAB),
            "max_abs_err": err,
            **kept_timing(EK.KERNEL_ROWS, lambda: EK.sparse_row_update(ups),
                          "sparse_row_update_kernel"),
            "plain_ms": timer(lambda: [EK.reference_row_update(u)
                                       for u in ups]),
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None}

    # the planted faults: a stale kept table; untouched rows that move
    faults = {"stale_table": stale_table_caught(dev)}
    kernel = EK.KERNEL_ROWS
    fn = kernel._fn or kernel._resolve()
    kernel._fn = planted(*builds["untouched_rows_move"], kernel)
    try:
        moved, _ = update_agrees(EK.sparse_row_update,
                                 EK.reference_row_update, ups, lazy=True)
    finally:
        kernel._fn = fn
        kernel.tables.clear()
    if moved:
        raise AssertionError("the row-lazy kernel that moves untouched rows "
                             "passed the twin check")
    faults["untouched_rows_move"] = {"twin_check_passed": moved}
    del ups
    torch.cuda.synchronize()
    src = "paddle_tpu_torch/ops/kernels/csrc/update.cu"
    big = dense["resnet50"]
    rows = [{"name": "fused_update", "route": "cuda", "source": src,
             "replaces": "paddle_tpu/ops/pallas/tpp/update.py:112",
             "shape": f"resnet50: {big['tensors']} tensors, "
                      f"{big['params']} params",
             "max_abs_err": max(d["max_abs_err"] for d in dense.values()),
             "alone_ms": big["kernel_only_ms"],
             **{k: big[k] for k in ("ms", "host_ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms")}},
            {"name": "sparse_row_update", "route": "cuda", "source": src,
             "replaces": "paddle_tpu/ops/pallas/tpp/embedding.py:291",
             "shape": f"{CTR_FIELDS} x [{CTR_VOCAB}, {CTR_EMBED}]",
             "alone_ms": lazy["kernel_only_ms"],
             **{k: lazy[k] for k in ("max_abs_err", "ms", "host_ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")}}]
    return rows, {"phase": "update_kernels", "fused_update": dense,
                  "sparse_row_update": lazy, "bit_identical": True,
                  "in_place": True, "planted_faults": faults}


def ctr_batches(rng, k, bs, below=None):
    """``bench_ctr``'s synthetic samples: 3 uniform wide ids, one uniform id
    a field, a uniform label; ``below`` bounds field 0's ids."""
    out = []
    for _ in range(k):
        wide = rng.integers(0, CTR_WIDE, size=(bs, 3))
        cats = rng.integers(0, CTR_VOCAB, size=(bs, CTR_FIELDS))
        if below is not None:
            cats[:, 0] = rng.integers(0, below, size=bs)
        labels = rng.integers(0, 2, size=bs)
        out.append([(w.tolist(), *(int(c) for c in cs), int(y))
                    for w, cs, y in zip(wide, cats, labels)])
    return out


def train_ctr(dev, bs=1024, steps=10, lazy_below=900) -> tuple[dict, tuple]:
    """The Wide & Deep CTR (``models/ctr.wide_and_deep_ctr`` at
    ``bench_ctr``'s shapes) through the v2 flow with the repo's CTR test
    optimizer, ``Momentum(momentum=0.9, learning_rate=0.05)``; the tables
    are row-lazy.  A batch-2 step against a float64 witness; the first
    ``trainer.SGD`` step twice and through the per-tensor loop (the same
    bits); 2 warm-up and ``steps`` timed steps with exactly 1 fused-update,
    1 row-lazy, 8 gather and 8 scatter-add launches a step; a 3-step
    profile; the row-lazy check (a run whose field-0 ids stay below
    ``lazy_below``: those rows keep parameter and velocity, and the dense
    rule on the table, a planted fault, moves them); ``paddle.infer``
    against the eval step."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import optimizer as OPT
    from paddle_tpu_torch.config.topology import Topology
    from paddle_tpu_torch.core.dtype import set_policy
    from paddle_tpu_torch.core.parameters import Parameters
    from paddle_tpu_torch.layers.base import reset_name_counters
    from paddle_tpu_torch.ops.kernels import embedding as EK
    from paddle_tpu_torch.ops.kernels import update as UP
    from paddle_tpu_torch.reader.feeder import DataFeeder
    from paddle_tpu_torch.trainer.step import build_eval_step

    t0 = time.perf_counter()
    reset_name_counters()
    cost, predict, input_names = paddle.models.ctr.wide_and_deep_ctr(
        wide_dim=CTR_WIDE, categorical_vocab_sizes=[CTR_VOCAB] * CTR_FIELDS,
        embedding_size=CTR_EMBED, hidden_sizes=CTR_HIDDEN)
    topo = Topology(cost)
    created = paddle.parameters.create(cost)       # generator seeded 0
    carried = {n: created[n] for n in created.names()}
    n_params = int(sum(v.size for v in carried.values()))
    tables = [n for n in carried if n.startswith("emb_")]
    feeding = {n: i for i, n in enumerate(input_names)}
    rng = np.random.default_rng(0)
    types = {n: paddle.data_type.InputType(
        dim=l.attrs["dim"], seq_type=l.attrs["seq_type"],
        kind=l.attrs["data_type"]) for n, l in topo.data_layers().items()}

    # (a) one step at batch 2 from the same weights: the card's kernels and
    # the CPU's plain twins in f32 against the CPU in float64, by the loss
    # and every gradient leaf; TF32 allowed on the card is the planted
    # fault the limit must catch
    small = ctr_batches(rng, 1, 2)[0]

    def side(where, dtype=torch.float32):
        feed = {k: v.to(dtype) if v.is_floating_point() else v for k, v in
                DataFeeder(types, feeding, device=where)(small).items()}
        params = {n: torch.from_numpy(v).to(where, dtype)
                  for n, v in carried.items()}
        return text_loss_and_grads(topo, cost.name, params, feed)

    loss64, g64 = side("cpu", torch.float64)
    sides = {"cpu": side("cpu"), "card": side(dev)}
    rerun = side(dev)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        sides["card_tf32_control"] = side(dev)
    finally:
        set_policy()
    if not (torch.equal(rerun[0], sides["card"][0]) and all(
            torch.equal(rerun[1][n], sides["card"][1][n]) for n in g64)):
        raise AssertionError("the card's CTR step is not bit-identical on a "
                             "rerun")
    witness = {"batch": 2, "loss_f64": float(loss64),
               "loss_rtol": TEXT_LOSS_RTOL, "grad_limit": TEXT_GRAD_LIMIT}
    for label, (loss, grads) in sides.items():
        ratios = {n: rel_norm(grads[n], g64[n]) for n in g64}
        worst = max(ratios, key=ratios.get)
        witness[label] = {"loss": float(loss),
                          "loss_rel_err": abs(float(loss) - float(loss64))
                          / abs(float(loss64)),
                          "grad_worst": ratios[worst],
                          "grad_worst_leaf": worst}
    del sides, rerun, g64
    for label in ("cpu", "card"):
        w = witness[label]
        if not (w["loss_rel_err"] <= TEXT_LOSS_RTOL
                and w["grad_worst"] <= TEXT_GRAD_LIMIT):
            raise AssertionError(f"{label} CTR step vs the f64 witness: "
                                 f"{witness}")
    if witness["card_tf32_control"]["grad_worst"] <= TEXT_GRAD_LIMIT:
        raise AssertionError(f"the CTR witness limit does not catch TF32: "
                             f"{witness}")

    # (b) trainer.SGD at batch 1,024
    def trainer(regularization=None):
        return paddle.trainer.SGD(
            cost=cost, parameters=Parameters.from_numpy(carried),
            update_equation=paddle.optimizer.Momentum(
                momentum=0.9, learning_rate=0.05,
                regularization=regularization), device=dev)

    def run(tr, data, handler=None):
        costs = []

        def h(e):
            if isinstance(e, paddle.event.EndIteration):
                costs.append(e.cost)
            if handler is not None:
                handler(e)

        tr.train(reader=lambda: iter(data), num_passes=1, event_handler=h,
                 feeding=feeding)
        return costs

    kernels = {"fused_update": UP.KERNEL, "sparse_row_update": EK.KERNEL_ROWS,
               "gather": EK.KERNEL_GATHER, "scatter_add": EK.KERNEL_SCATTER}

    def zero():
        for k in kernels.values():
            k.launches = 0

    def counts():
        return {n: k.launches for n, k in kernels.items()}

    one = ctr_batches(rng, 1, bs)
    firsts = {}
    for label in ("routed", "routed_rerun", "generic_loop"):
        tr = trainer()
        if label == "generic_loop":
            tr.optimizer.apply = tr.optimizer._apply_each
        zero()
        c = run(tr, one)
        torch.cuda.synchronize()
        firsts[label] = (c, {n: tr.parameters[n] for n in carried},
                         counts())
        del tr
    per_step = {"fused_update": 1, "sparse_row_update": 1,
                "gather": CTR_FIELDS, "scatter_add": CTR_FIELDS}
    for label, (c, p, n) in firsts.items():
        want = (per_step if label != "generic_loop" else
                dict(per_step, fused_update=0, sparse_row_update=0))
        if n != want:
            raise AssertionError(f"CTR first step ({label}) launches {n} != "
                                 f"{want}")
        if not (c == firsts["routed"][0] and all(
                np.array_equal(p[k], firsts["routed"][1][k])
                for k in carried)):
            raise AssertionError(f"CTR first step: {label} is not "
                                 "bit-identical to the routed step")
    del firsts
    tr = trainer()
    each = []
    loop = tr.optimizer._apply_each
    tr.optimizer._apply_each = lambda *a: each.append(1) or loop(*a)
    warm, data, traced = (ctr_batches(rng, 2, bs), ctr_batches(rng, steps, bs),
                          ctr_batches(rng, 3, bs))
    run(tr, warm)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    marks: dict[int, list] = {}

    def stamp(e):
        if isinstance(e, (paddle.event.BeginIteration,
                          paddle.event.EndIteration)):
            marks.setdefault(e.batch_id, []).append(time.perf_counter())

    each.clear()
    zero()
    drop_kept_tables(UP.KERNEL, EK.KERNEL_ROWS)
    builds0 = (UP.KERNEL.table_builds, EK.KERNEL_ROWS.table_builds)
    t1 = time.perf_counter()
    costs = run(tr, data, stamp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    train_n = counts()
    table_builds = {"fused_update": UP.KERNEL.table_builds - builds0[0],
                    "sparse_row_update":
                        EK.KERNEL_ROWS.table_builds - builds0[1]}
    peak = torch.cuda.max_memory_allocated(dev)
    if train_n != {n: c * steps for n, c in per_step.items()} or each:
        raise AssertionError(f"CTR train launches {train_n} != {per_step} x "
                             f"{steps}, or {len(each)} per-tensor loops")
    if table_builds != {"fused_update": 1, "sparse_row_update": 1}:
        raise AssertionError(f"CTR: update tables built over {steps} steps: "
                             f"{table_builds}, not one each")
    if len(costs) != steps or not all(np.isfinite(costs)):
        raise AssertionError(f"CTR costs {costs}")
    step_ms = [1e3 * (b - a) for a, b in marks.values()]
    p50 = float(np.percentile(step_ms, 50))
    prof = profile_window(lambda: run(tr, traced), 3)
    if "device_busy_ms_per_step" in prof:
        prof["idle_share_vs_step_p50"] = (
            1 - prof["device_busy_ms_per_step"] / p50)
    touched = [len({s[1 + i] for s in data[0]}) / CTR_VOCAB
               for i in range(CTR_FIELDS)]
    route_ms = update_route_ab(tr, run, data[:5], stamp, marks)

    # (c) paddle.infer on the predict layer: the eval step's probabilities
    batch = traced[0]
    zero()
    probs = paddle.infer(output_layer=predict, parameters=tr.parameters,
                         input=batch, feeding=feeding, device=dev)
    torch.cuda.synchronize()
    infer_n = counts()
    values, _, _ = build_eval_step(tr.topology)(
        {n: torch.as_tensor(v, device=dev)
         for n, v in tr.parameters.as_dict().items()}, tr.states,
        tr._feeder(feeding)(batch))
    want_probs = values[predict.name].cpu().numpy()
    if not (probs.shape == (bs, 2) and np.array_equal(probs, want_probs)
            and infer_n == dict(per_step, fused_update=0, sparse_row_update=0,
                                scatter_add=0)):
        raise AssertionError(f"paddle.infer vs the eval step: launches "
                             f"{infer_n}, equal "
                             f"{np.array_equal(probs, want_probs)}")
    del tr

    # (d) the row-lazy check: field 0's ids below ``lazy_below`` for 3
    # steps, L2 1e-3 on (so the dense rule would move an untouched row):
    # the rows of emb_0 no batch hit (rows lazy_below.. among them) keep
    # the start's bits and a zero velocity, the rows hit move; the same
    # run with the dense rule on the table (the planted fault) must fail
    lazy_data = ctr_batches(rng, 3, bs, below=lazy_below)
    start = carried["emb_0"]
    hit = np.zeros(CTR_VOCAB, bool)
    hit[[s[1] for b in lazy_data for s in b]] = True

    def lazy_run():
        tr = trainer(paddle.optimizer.L2Regularization(rate=1e-3))
        zero()
        run(tr, lazy_data)
        p = tr.parameters["emb_0"]
        v = tr._opt_state["slots"]["emb_0"]["velocity"].cpu().numpy()
        return {"untouched_kept": bool(
                    np.array_equal(p[~hit], start[~hit])
                    and not v[~hit].any()),
                "touched_moved": bool(np.all(np.any(
                    p[hit] != start[hit], axis=1))),
                "launches": counts()}

    lazy = lazy_run()
    real = OPT.lazy_sparse_rows
    OPT.lazy_sparse_rows = lambda spec, p=None: False
    try:
        fault = lazy_run()
    finally:
        OPT.lazy_sparse_rows = real
    if not (lazy["untouched_kept"] and lazy["touched_moved"]
            and not hit[lazy_below:].any()
            and lazy["launches"]["sparse_row_update"] == 3):
        raise AssertionError(f"CTR row-lazy check: {lazy}")
    if fault["untouched_kept"] or fault["launches"]["sparse_row_update"]:
        raise AssertionError(f"the row-lazy check does not catch the dense "
                             f"rule on the table: {fault}")
    out = {"phase": "train_ctr",
           "model": "Wide & Deep CTR (models/ctr.wide_and_deep_ctr at "
                    "bench.py bench_ctr's shapes)",
           "params": n_params, "tensors": len(carried),
           "tables": {n: list(carried[n].shape) for n in tables},
           "wide": CTR_WIDE, "embedding": CTR_EMBED,
           "hidden": list(CTR_HIDDEN), "dtype": "float32",
           "optimizer": "Momentum 0.9, lr 0.05 (row-lazy tables)",
           "cuts": ["optimizer: bench_ctr trains with AdaGrad, which has "
                    "no row-lazy rule (AdaGrad is queued, A3); Momentum "
                    "0.9 at lr 0.05 is the repo's CTR test optimizer",
                    "dtype: bench_ctr trains in bf16; the port in f32 "
                    "(A17)"],
           "step_vs_f64_witness": witness,
           "first_step_rerun_and_loop_bit_identical": True,
           "batch": bs, "steps": steps, "wall_s": wall,
           "examples_per_s": bs * steps / wall, "step_ms_p50": p50,
           "step_ms": step_ms, "costs": costs,
           "touched_row_share_by_field": touched,
           "update_route_step_ms": route_ms,
           "max_memory_allocated_bytes": peak, "train_launches": train_n,
           "update_table_builds": table_builds,
           "infer_launches": infer_n, "infer_equals_eval_step": True,
           "row_lazy_check": {"below": lazy_below, "steps": 3,
                              "l2": 1e-3, "rows_hit": int(hit.sum()),
                              "lazy": lazy,
                              "dense_rule_control": fault},
           "setup_s": setup_s, "profile": prof}
    return out, (train_n["fused_update"], train_n["sparse_row_update"])


# -- phases 11 and 12: softmax_xent and the raw-input recurrences ------------

#: ops.rnn.lstm / ops.rnn.gru at the widths the JAX package sizes their
#: fused-input kernels at (tools/bench_mem.py:143-165): (kind, B, T, E, D)
RAW_RNN = (("lstm", 64, 100, 128, 512), ("gru", 64, 32, 512, 512))
RAW_RNN_STEPS = 10
#: the LM's logits: [16 x 1023, vocab 50257] f32 (phase 5's batch)
XENT_SHAPE = (16 * 1023, 50257)
FI_KERNEL_NAMES = {"lstm": "lstm_fwd_kernel<true", "gru": "gru_fwd_kernel<true"}


def raw_rnn_inputs(dev, kind, b, t, e, d, seed=11):
    """Seeded f32 inputs of ``ops.rnn.lstm`` / ``gru``: x [b, t, e], lengths
    (half the rows full, half shorter than t, one of length 1), the
    weights {w_x, w_h, [w_hc], b}, the initial state [h0, (c0)] and a fixed
    cotangent of each output (hs, h_T, [c_T])."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s, k=1.0: k * torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    lens = torch.randint(1, t, (b,), generator=gen, device=dev)
    lens[: b // 2] = t
    lens[-1] = 1
    n = 4 if kind == "lstm" else 3
    w = {"w_x": rnd(e, n * d, k=e ** -0.5), "b": rnd(n * d, k=0.1)}
    if kind == "lstm":
        w["w_h"] = rnd(d, 4 * d, k=d ** -0.5)
        init = [rnd(b, d, k=0.5), rnd(b, d, k=0.5)]
        cts = [rnd(b, t, d), rnd(b, d), rnd(b, d)]
    else:
        w["w_h"] = rnd(d, 2 * d, k=d ** -0.5)
        w["w_hc"] = rnd(d, d, k=d ** -0.5)
        init = [rnd(b, d, k=0.5)]
        cts = [rnd(b, t, d), rnd(b, d)]
    return rnd(b, t, e), lens, w, init, cts


def raw_rnn_call(kind, x, lens, w, init, reverse):
    """One call of the entry a user makes: ``ops.rnn.lstm`` / ``gru`` over
    SequenceBatch(x, lens); returns the outputs (hs, h_T, [c_T])."""
    from paddle_tpu_torch.core.lod import SequenceBatch
    from paddle_tpu_torch.ops import rnn as R

    seq = SequenceBatch(x, lens)
    if kind == "lstm":
        out, last = R.lstm(seq, w["w_x"], w["w_h"], w["b"], reverse=reverse,
                           init=R.LSTMState(*init))
        return out.data, last.h, last.c
    out, last = R.gru(seq, w["w_x"], w["w_h"], w["w_hc"], w["b"],
                      reverse=reverse, init=init[0])
    return out.data, last


def raw_rnn_reference(kind, x, lens, w, init, reverse):
    """The plain composition (the projection as one product, then the
    plain scan; autograd for the backward) on the same leaves: the
    float64 witness's function."""
    from paddle_tpu_torch.ops.kernels import gru as GK
    from paddle_tpu_torch.ops.kernels import lstm as LK

    t = x.shape[1]
    mask = (torch.arange(t, device=x.device)[None, :]
            < lens[:, None]).to(x.dtype)
    if kind == "lstm":
        peep = torch.zeros(3, w["w_h"].shape[0], dtype=x.dtype,
                           device=x.device)
        hs, (h_t, c_t) = LK.lstm_seq_fi_reference(
            x, mask, w["w_x"], w["b"], w["w_h"], peep, *init, reverse)
        return hs, h_t, c_t
    return GK.gru_seq_fi_reference(x, mask, w["w_x"], w["b"], w["w_h"],
                                   w["w_hc"], init[0], reverse)


def raw_rnn_grads(fn, kind, x, lens, w, init, cts, reverse):
    """(outputs, gradients) of ``fn`` (raw_rnn_call or raw_rnn_reference)
    for the fixed cotangents, by leaf name."""
    leaves = {"x": x, **w, **{f"init{i}": v for i, v in enumerate(init)}}
    leaves = {k: v.detach().requires_grad_() for k, v in leaves.items()}
    ws = {k: leaves[k] for k in w}
    st = [leaves[f"init{i}"] for i in range(len(init))]
    outs = fn(kind, leaves["x"], lens, ws, st, reverse)
    grads = torch.autograd.grad(outs, list(leaves.values()), cts)
    named = {f"out{i}": o.detach() for i, o in enumerate(outs)}
    named.update({"d" + k: g for k, g in zip(leaves, grads)})
    return named


def leaf_errors(got: dict, want: dict) -> dict:
    """Per leaf max |got - want| / max(1, max |want|), in float64."""
    return {k: ((got[k].double() - want[k]).abs().max()
                / max(1.0, want[k].abs().max().item())).item()
            for k in want}


def check_raw_rnn_kernels(dev, timer, fwd_faults=None) -> tuple[list, dict]:
    """Rows 6 and 9 at the path's shapes (``RAW_RNN``; both directions),
    each fused-input forward kernel against its twin (max abs error <= TOL
    x max(1, |ref|)), with and without its gate slab, a rerun in the same
    bits.  Timed per launch (the mean of the two directions) beside its
    twin, its own device time from a trace, the bound (the valid
    row-steps' products), the port's unfused route (``torch.matmul``
    projection + the row 5 / row 8 forward kernel, the A/B of the fusion)
    and cuDNN's ``nn.LSTM`` / ``nn.GRU`` forward with the input projection,
    which is not the same cell (no peepholes; the GRU's reset gate after
    the product), a yardstick of scale only.  The LSTM's also: row 5's
    forward over the projection at D 512 (U 4: the forward's 8 warps, the
    backward's 4) with its backward in the same bits by remat and over the
    slab, and the forward product's planted faults (``LSTM_FWD_FAULTS``,
    ``fwd_faults`` their builds) on the fused-input forward; its bound is
    3xTF32's (:func:`bound_3xtf32`)."""
    from paddle_tpu_torch.ops.kernels import gru as GK
    from paddle_tpu_torch.ops.kernels import lstm as LK

    fwd_faults = fwd_faults or source_fault_builds("lstm_seq",
                                                   LSTM_FWD_FAULTS)
    t0 = time.perf_counter()
    rows, summary = [], {"phase": "raw_rnn_kernels", "tol": TOL}
    f32 = 4.0
    for kind, b, t, e, d in RAW_RNN:
        mod = LK if kind == "lstm" else GK
        x, lens, w, init, _ = raw_rnn_inputs(dev, kind, b, t, e, d)
        mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).float()
        if kind == "lstm":
            rec = (w["w_h"], torch.zeros(3, d, device=dev))
        else:
            rec = (w["w_h"], w["w_hc"])
        args = (x, mask, w["w_x"], w["b"], *rec, *init)
        err, calls = 0.0, {}
        gate = 2 if kind == "lstm" else 1
        for reverse in (False, True):
            slab = mod._fi_fwd_kernel(*args, reverse, True)
            got = mod._fi_fwd_kernel(*args, reverse, False)
            again = mod._fi_fwd_kernel(*args, reverse, False)
            torch.cuda.synchronize()
            for i, (p, q, s) in enumerate(zip(got, again, slab)):
                if i == gate:
                    continue
                if not (torch.equal(p, q) and torch.equal(p, s)):
                    raise AssertionError(f"{kind}_seq_fi forward: a rerun "
                                         "or the gate slab changes the bits")
            want = mod._fi_fwd_plain(*args, reverse, True)
            for g, v in zip(slab, want):
                m = (g - v).abs().max().item()
                if not m <= TOL * max(1.0, v.abs().max().item()):
                    raise AssertionError(f"{kind}_seq_fi forward kernel vs "
                                         f"plain: {m}")
                err = max(err, m)
            del slab, got, again, want
            calls[reverse] = (
                lambda r=reverse: mod._fi_fwd_kernel(*args, r, False),
                lambda r=reverse: mod._fi_fwd_plain(*args, r, False),
                lambda r=reverse: mod._fwd_kernel(
                    LK._project_xw(x, w["w_x"], w["b"]), mask, *rec, *init,
                    r, False))
        if kind == "lstm":
            xw = LK._project_xw(x, w["w_x"], w["b"])
            hs, cs, gates = LK._fwd_kernel(xw, mask, *rec, *init, False,
                                           True)[:3]
            dhs = torch.randn(b, t, d, device=dev, generator=torch.Generator(
                device=dev).manual_seed(12))
            if not lstm_remat_vs_stored(xw, mask, *rec, *init, hs, cs, gates,
                                        dhs):
                raise AssertionError("lstm backward at D 512: remat and the "
                                     "stored slab differ in bits")
            summary["lstm_fwd_planted_faults"] = lstm_fwd_faults_caught(
                fwd_faults, lambda: mod._fi_fwd_kernel(*args, False, True),
                mod._fi_fwd_plain(*args, False, True),
                lambda: lstm_remat_vs_stored(xw, mask, *rec, *init, hs, cs,
                                             gates, dhs))
            del xw, hs, cs, gates, dhs
        ms = {r: timer(c[0]) for r, c in calls.items()}
        unfused = {r: timer(c[2]) for r, c in calls.items()}
        plain = [timer(c[1], iters=3) for c in calls.values()]
        own = device_ms([c[0] for c in calls.values()],
                        FI_KERNEL_NAMES[kind])
        unfused_own = device_ms([c[2] for c in calls.values()],
                                f"{kind}_fwd_kernel<false")
        cudnn = (torch.nn.LSTM if kind == "lstm" else torch.nn.GRU)(
            e, d, batch_first=True).to(dev)

        def lib(cudnn=cudnn, x=x):
            with torch.no_grad():
                return cudnn(x)

        steps = float(mask.sum().item())       # valid row-steps
        n = 4 if kind == "lstm" else 3
        flops = steps * (2.0 * e * n * d + 2.0 * d * n * d)
        # x, mask, W_x, b, the recurrent weights and the state in; hs (and
        # cs) and the last state out
        nbytes = f32 * (b * t * e + b * t + e * n * d + n * d
                        + sum(v.numel() for v in rec) + len(init) * b * d
                        + len(init) * (b * t * d + b * d))
        # the LSTM's products on the tensor cores as 3xTF32: the lesser
        bound_ms, bound_by = (bound_3xtf32 if kind == "lstm" else bound)(
            nbytes, flops)
        rows.append({
            "name": f"{kind}_seq_fi_fwd", "route": "cuda",
            "source": f"paddle_tpu_torch/ops/kernels/csrc/{kind}_seq.cu",
            "replaces": ("paddle_tpu/ops/pallas/lstm.py:686" if kind == "lstm"
                         else "paddle_tpu/ops/pallas/gru.py:452"),
            "shape": [b, t, e, d], "max_abs_err": err,
            "ms": (ms[False] + ms[True]) / 2,
            "ms_by_direction": {"forward": ms[False], "reverse": ms[True]},
            "plain_ms": sum(plain) / 2, "kernel_only_ms": own,
            "unfused_ms": (unfused[False] + unfused[True]) / 2,
            "unfused_kernel_only_ms": unfused_own,
            "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
            "library_ms": timer(lib),
            "library_note": (f"cuDNN nn.{'LSTM' if kind == 'lstm' else 'GRU'}"
                             " forward, input projection included: not the "
                             "same cell")})
        summary[kind] = {"reruns_bit_identical": True,
                         "gate_slab_leaves_outputs_bits": True,
                         "valid_row_steps": steps}
        if kind == "lstm":
            summary[kind]["row5_d512_remat_stored_bit_identical"] = True
        del cudnn, calls
        torch.cuda.synchronize()
    summary["seconds"] = time.perf_counter() - t0
    return rows, summary


def raw_rnn_path(dev, steps=RAW_RNN_STEPS) -> tuple[dict, dict]:
    """The raw-input recurrences through the entries a user calls,
    ``ops.rnn.lstm`` (reverse off and on) and ``ops.rnn.gru``, at
    ``RAW_RNN``'s widths: a forward and backward against a fixed
    cotangent ``steps`` times with the launch counts zeroed just before
    and read just after (exactly ``steps`` fused-input forward and
    ``steps`` remat backward launches, no launch of the sequence forward
    or of the stored-gates backward);
    the outputs and every input gradient against a float64 witness of the
    plain composition on the card (per leaf max |x32 - x64| <= TOL x
    max(1, max |x64|)), with TF32 allowed in cuBLAS and the ragged mask
    ignored as planted faults that must exceed it; the step ms of the
    fused route against the unfused one (the projection product and the
    sequence kernels, the backward in its stored-gates form), in blocks of
    ``steps``: fused, unfused, unfused, fused.  Returns (the phase's
    result, {kind: fused-input launches})."""
    from paddle_tpu_torch.ops import rnn as R
    from paddle_tpu_torch.ops.kernels import gru as GK
    from paddle_tpu_torch.ops.kernels import lstm as LK

    t0 = time.perf_counter()
    out = {"phase": "raw_rnn_path", "steps": steps, "tol": TOL, "cases": {}}
    launches = {"lstm": 0, "gru": 0}
    for kind, b, t, e, d in RAW_RNN:
        mod = LK if kind == "lstm" else GK
        for reverse in ((False, True) if kind == "lstm" else (False,)):
            x, lens, w, init, cts = raw_rnn_inputs(dev, kind, b, t, e, d)
            label = f"{kind}{'_reverse' if reverse else ''}"
            if not R.fused_input_fits(x, mod, w["w_x"],
                                      *(v for k, v in w.items()
                                        if k.startswith("w_h"))):
                raise AssertionError(f"{label}: the predicate refuses the "
                                     "path's shape")
            wide = raw_rnn_grads(
                raw_rnn_reference, kind, x.double(), lens,
                {k: v.double() for k, v in w.items()},
                [v.double() for v in init], [c.double() for c in cts],
                reverse)
            kernels = (mod.KERNEL_FI, mod.KERNEL_BWD, mod.KERNEL_BWD_STORED,
                       mod.KERNEL_FWD)

            def run(n, kernels=kernels, kind=kind, x=x, lens=lens, w=w,
                    init=init, cts=cts, reverse=reverse):
                ms = []
                for k in kernels:
                    k.launches = 0
                for _ in range(n):
                    t0 = time.perf_counter()
                    got = raw_rnn_grads(raw_rnn_call, kind, x, lens, w, init,
                                        cts, reverse)
                    torch.cuda.synchronize()
                    ms.append(1e3 * (time.perf_counter() - t0))
                return got, ms, tuple(k.launches for k in kernels)

            got, fused_ms, n_fused = run(steps)
            if n_fused != (steps, steps, 0, 0):
                raise AssertionError(f"{label}: launches (fused-input, "
                                     f"remat backward, stored backward, "
                                     f"sequence forward) = {n_fused}, want "
                                     f"({steps}, {steps}, 0, 0)")
            launches[kind] += n_fused[0]
            errs = leaf_errors(got, wide)
            if not max(errs.values()) <= TOL:
                raise AssertionError(f"{label} vs the float64 witness: "
                                     f"{errs}")
            again = raw_rnn_grads(raw_rnn_call, kind, x, lens, w, init, cts,
                                  reverse)
            if not all(torch.equal(got[k], again[k]) for k in got):
                raise AssertionError(f"{label}: a rerun differs in bits")
            # the unfused route: the projection product and the sequence
            # kernels (the JAX package's route with its fused flag off),
            # the backward in its stored-gates form (the slab fits)
            on = R.fused_input_on
            R.fused_input_on = lambda device: False
            try:
                unfused, unfused_ms, n_unfused = run(steps)
                unfused_ms += run(steps)[1]
            finally:
                R.fused_input_on = on
            if n_unfused != (0, 0, steps, steps):
                raise AssertionError(f"{label}: unfused launches {n_unfused}")
            unfused_err = max(leaf_errors(unfused, wide).values())
            fused_ms += run(steps)[1]
            # the controls: each must exceed the witness's limit
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32 = max(leaf_errors(raw_rnn_grads(
                    raw_rnn_call, kind, x, lens, w, init, cts, reverse),
                    wide).values())
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            full = torch.full_like(lens, t)
            unmasked = max(leaf_errors(raw_rnn_grads(
                raw_rnn_call, kind, x, full, w, init, cts, reverse),
                wide).values())
            for name, v in (("tf32", tf32), ("mask_ignored", unmasked)):
                if not v > TOL:
                    raise AssertionError(f"{label}: the {name} control "
                                         f"passed the witness ({v})")
            out["cases"][label] = {
                "shape": [b, t, e, d], "reverse": reverse,
                "lengths": "half full, half shorter, one of length 1",
                "launches_fused": n_fused, "launches_unfused": n_unfused,
                "witness_err": max(errs.values()),
                "witness_err_by_leaf": errs,
                "unfused_witness_err": unfused_err,
                "control_tf32": tf32, "control_mask_ignored": unmasked,
                "fused_step_ms_p50": float(np.percentile(fused_ms, 50)),
                "unfused_step_ms_p50": float(np.percentile(unfused_ms, 50)),
                "fused_ms": fused_ms, "unfused_ms": unfused_ms}
            del got, again, unfused, wide
            torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    return out, launches


def xent_inputs(dev, seed=13):
    """Seeded logits [16368, 50257] (N(0, 2^2)) and targets of the LM's
    loss shape."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, v = XENT_SHAPE
    logits = 2.0 * torch.randn(n, v, generator=gen, device=dev)
    return logits, torch.randint(0, v, (n,), generator=gen, device=dev)


def entry_ratio(got, want) -> float:
    """The largest |got - want| / (XENT_GRAD_RTOL |want| + XENT_GRAD_ATOL
    max |want|) over the entries: at most 1 holds every entry of a softmax
    gradient to its own size, the smallest ones included (a typical entry
    is ~1e-5 of the largest at V 50257)."""
    floor = XENT_GRAD_ATOL * want.abs().max().item()
    lim = want.abs().mul_(XENT_GRAD_RTOL).add_(floor)
    return (got - want).abs_().div_(lim).max().item()


def check_xent_kernels(dev, timer) -> tuple[list, dict]:
    """Row 4 at the LM's logits (``XENT_SHAPE``): the forward kernel (lse
    and NLL) and the backward kernel under g = 1 (entries up to 1) against
    their twins (the forward's max abs error <= TOL x max(1, |ref|), the
    backward entry by entry, ``entry_ratio`` <= 1, with two planted faults
    it must catch), reruns in the same bits; each timed beside its twin,
    its own device time (``device_ms``), its bound (one read; one read and
    one write) and ``F.cross_entropy(reduction="none")``'s forward /
    backward."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import softmax_xent as SX

    t0 = time.perf_counter()
    logits, targets = xent_inputs(dev)
    n, v = logits.shape
    g = torch.ones(n, device=dev)
    nll, lse = SX._fwd_kernel(logits, targets)
    again = SX._fwd_kernel(logits, targets)
    d1 = SX._bwd_kernel(logits, targets, lse, g)
    d2 = SX._bwd_kernel(logits, targets, lse, g)
    torch.cuda.synchronize()
    if not (torch.equal(nll, again[0]) and torch.equal(lse, again[1])
            and torch.equal(d1, d2)):
        raise AssertionError("softmax_xent: a rerun differs in bits")
    del again, d2
    errs = {}
    for name, got, want in zip(("nll", "lse"), (nll, lse),
                               SX._fwd_plain(logits, targets)):
        errs[name] = (got - want).abs().max().item()
        if not errs[name] <= TOL * max(1.0, want.abs().max().item()):
            raise AssertionError(f"softmax_xent forward vs plain: {errs}")
    want = SX._bwd_plain(logits, targets, lse, g)
    errs["dlogits"] = (d1 - want).abs().max().item()
    errs["dlogits_ratio"] = entry_ratio(d1, want)
    if not errs["dlogits_ratio"] <= 1.0:
        raise AssertionError(f"softmax_xent backward vs plain: {errs}")
    # planted faults the limit must catch: the entries under 1e-4 (most
    # of a row) zeroed, and every entry 1e-4 too large
    controls = {
        "small_entries_zeroed": entry_ratio(
            d1.masked_fill(d1.abs() < 1e-4, 0.0), want),
        "scaled_1e-4": entry_ratio(d1 * (1.0 + 1e-4), want)}
    errs["controls"] = controls
    if not all(r > 1.0 for r in controls.values()):
        raise AssertionError(f"softmax_xent backward: a planted fault "
                             f"passed the limit: {controls}")
    del want, d1
    torch.cuda.empty_cache()
    leaf = logits.clone().requires_grad_()
    ce = F.cross_entropy(leaf, targets, reduction="none")

    def lib_fwd():
        with torch.no_grad():
            return F.cross_entropy(logits, targets, reduction="none")

    def lib_bwd():
        return torch.autograd.grad(ce, leaf, g, retain_graph=True)

    f32, elems = 4.0, float(n) * v
    fwd = lambda: SX._fwd_kernel(logits, targets)  # noqa: E731
    bwd = lambda: SX._bwd_kernel(logits, targets, lse, g)  # noqa: E731
    rows = []
    for name, fn, plain, lib, key, nbytes, ops in (
            # logits and targets in, lse and nll out; max, compare, exp,
            # add an element
            ("softmax_xent_fwd", fwd,
             lambda: SX._fwd_plain(logits, targets), lib_fwd, "lse_kernel",
             f32 * elems + 8 * n + 2 * f32 * n, 4 * elems),
            # logits, targets, lse, g in, dlogits out; sub, exp, sub, mul
            ("softmax_xent_bwd", bwd,
             lambda: SX._bwd_plain(logits, targets, lse, g), lib_bwd,
             "dlogits_kernel", 2 * f32 * elems + 8 * n + 2 * f32 * n,
             4 * elems)):
        bound_ms, bound_by = bound(nbytes, ops)
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/ops/kernels/csrc/softmax_xent.cu",
            "replaces": ("paddle_tpu/ops/pallas/softmax_xent.py:73"
                         if name.endswith("fwd")
                         else "paddle_tpu/ops/pallas/softmax_xent.py:120"),
            "shape": [n, v],
            "max_abs_err": (max(errs["nll"], errs["lse"])
                            if name.endswith("fwd") else errs["dlogits"]),
            "ms": timer(fn), "plain_ms": timer(plain, iters=5),
            "kernel_only_ms": device_ms([fn], key),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": timer(lib, iters=10),
            "library_note": "F.cross_entropy(reduction='none')"
                            + (" backward" if name.endswith("bwd") else "")})
    del ce, leaf
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows, {"phase": "xent_kernels", "tol": TOL, "errors": errs,
                  "reruns_bit_identical": True,
                  "seconds": time.perf_counter() - t0}


def xent_path(dev, steps=10, dtype=torch.float32) -> tuple[dict, tuple]:
    """``softmax_xent`` at the LM's logits (``XENT_SHAPE``) in ``dtype``
    (f32, or rounded to bf16): the mean NLL and its gradient ``steps``
    times through the Function (its launches zeroed just before and read
    just after: exactly ``steps`` of each form of ``dtype``, none of the
    other dtype's), against the port's eager LM loss chain on the same
    logits (``transformer.loss_fn``'s f32 ``torch.logsumexp`` - gather,
    the mean, its backward): the loss within TOL x max(1, |ref|); the
    gradient in f32 entry by entry (``entry_ratio`` <= 1), in bf16 by
    ``bf16_exact_agreement`` (the chain's gradient reaches the bf16 logits
    rounded once); step ms of each in blocks of ``steps`` (kernel, eager,
    eager, kernel) and the peak memory of each.  A measurement: nothing
    routes the LM loss through the kernels.  Returns (the phase's result,
    (forward, backward) launches of ``dtype``'s forms)."""
    from paddle_tpu_torch.ops.kernels import softmax_xent as SX

    t0 = time.perf_counter()
    logits, targets = xent_inputs(dev)
    if dtype != torch.float32:
        logits = logits.to(dtype)
        torch.cuda.empty_cache()
    leaf = logits.requires_grad_()

    def kernel():
        loss = SX.softmax_xent(leaf, targets).mean()
        return loss, torch.autograd.grad(loss, leaf)[0]

    def eager():
        lse = torch.logsumexp(leaf.float(), dim=-1)
        tgt = torch.gather(leaf, -1, targets[:, None])[:, 0].float()
        loss = torch.mean(lse - tgt)
        return loss, torch.autograd.grad(loss, leaf)[0]

    forms = SX.FORMS[dtype] + tuple(k for dt, ks in SX.FORMS.items()
                                    if dt != dtype for k in ks)
    ms = {"kernel": [], "eager": []}
    peak = {}
    counted = None
    for route in ("kernel", "eager", "eager", "kernel"):
        fn = kernel if route == "kernel" else eager
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if counted is None:
            for k in forms:
                k.launches = 0
        for _ in range(steps):
            start = time.perf_counter()
            loss, grad = fn()
            torch.cuda.synchronize()
            ms[route].append(1e3 * (time.perf_counter() - start))
            del loss, grad
        if counted is None:
            counted = tuple(k.launches for k in forms)
        peak[route] = max(peak.get(route, 0.0),
                          torch.cuda.max_memory_allocated() / 1e9)
    if counted != (steps, steps, 0, 0):
        raise AssertionError(f"softmax_xent {dtype} launches {counted}, "
                             f"want ({steps}, {steps}, 0, 0)")
    got, want = kernel(), eager()
    err = {"loss": abs(got[0].item() - want[0].item())}
    if dtype == torch.float32:
        err["grad_ratio"] = entry_ratio(got[1], want[1])
        grad_ok = err["grad_ratio"] <= 1.0
    else:
        err["grad"] = bf16_exact_agreement(got[1], want[1])
        grad_ok = err["grad"]["ok"]
    if not (err["loss"] <= TOL * max(1.0, abs(want[0].item())) and grad_ok):
        raise AssertionError(f"softmax_xent {dtype} vs the eager loss "
                             f"chain: {err}")
    del got, want, leaf, logits
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return ({"phase": ("xent_path" if dtype == torch.float32
                       else "xent_bf16_path"),
             "shape": list(XENT_SHAPE), "dtype": str(dtype), "steps": steps,
             "launches": counted[:2], "vs_eager": err,
             "kernel_step_ms_p50": float(np.percentile(ms["kernel"], 50)),
             "eager_step_ms_p50": float(np.percentile(ms["eager"], 50)),
             "peak_gb": peak, "seconds": time.perf_counter() - t0,
             **{f"{k}_ms": v for k, v in ms.items()}},
            counted[:2])


# -- phase 14: the LM in bf16, the bf16 forms of rows 2 and 3 ----------------

#: a bf16 operand of a flash product (P, dS) that rounds the other way moves
#: the product by one of its ulps, at most 2^-7 of its size
FLASH_BF16_FLIP = 2.0 ** -7
#: (B, T) of the bf16 flash checks at the LM's 12 heads of 64, causal
FLASH_BF16_SHAPES = ((16, 1024), (16, 333))
#: the bf16 forms of rows 2 and 3 on the LM's path (head_dim 64): the
#: Hopper forward and backward
FLASH_BF16_NAMES = ("flash_attention_fwd_wgmma",
                    "flash_attention_bwd_dq_wgmma",
                    "flash_attention_bwd_dkv_wgmma")
#: each planted fault of the bf16 forms and the outputs it must move
FLASH_BF16_FAULTS = {"bf16_accumulator": ("o", "dq", "dk", "dv"),
                     "delta_dropped": ("dq", "dk"),
                     "diagonal_mask_off": ("o", "dq", "dk", "dv"),
                     "p_unrounded": ("dv",),
                     "ds_unrounded": ("dq", "dk")}

#: the LM's bf16 witness step: GPT-2-small's vocabulary and heads of 64 at
#: 2 layers of 4 heads (256 wide), batch 2 x 128, weights from
#: ``init_params`` with a seeded generator; the CPU here computes the JAX
#: package's own bf16 error at this very step, per gradient leaf and for
#: the loss (``LM_BF16_WITNESS_JAX``, relative to the float64 step;
#: recomputed by ``tests/test_torch_lm_train.py``: ``PYTHONPATH=.:tests
#: python tests/test_torch_lm_train.py`` prints it).  The card's and the
#: CPU's bf16 steps are held within 2x that plus LM_BF16_FLOOR (one bf16
#: unit, 2^-8).
LM_BF16_NET = {"vocab_size": 50257, "num_layers": 2, "num_heads": 4,
               "embed_dim": 256, "mlp_dim": 1024, "max_seq_len": 128}
LM_BF16_BATCH = (2, 128)
LM_BF16_FLOOR = 2.0 ** -8
LM_BF16_WITNESS_JAX = {
    'blocks/b_in': 0.01177, 'blocks/b_out': 0.009841,
    'blocks/ln1_b': 0.01036, 'blocks/ln1_g': 0.01454,
    'blocks/ln2_b': 0.01195, 'blocks/ln2_g': 0.01494,
    'blocks/w_in': 0.01128, 'blocks/w_out': 0.009372,
    'blocks/wk': 0.01374, 'blocks/wo': 0.01013, 'blocks/wq': 0.01383,
    'blocks/wv': 0.01018, 'embed': 0.01142, 'ln_f_b': 0.009119,
    'ln_f_g': 0.009358, 'loss': 2.281e-05, 'pos_embed': 0.01258}


def flash_bf16_mags(qp, kp, vp, o, lse, dop, t_k, causal, scale):
    """Per element of o, dq, dk, dv on the padded [BH, Tp, D] problem, in
    float64, the sum over its reduction of |rounded operand| x |other
    operand|: P |V| (P normalised by ``lse``), (P (|dP| + sum |dO| |O|)
    scale) |K| and the same transposed against |Q|, P^T |dO|.  A bf16 P
    or dS that rounds the other way moves its term by at most
    FLASH_BF16_FLIP of it.  dS = P (dP - delta) scale is sized by the sums
    its difference subtracts, which also covers the f32 residue of a dS
    that cancels to near zero and, against float64, the rounding of the
    bf16 ``o`` that delta = rowsum(dO O) is taken from."""
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    q, k, v, do = (x.double() for x in (qp, kp, vp, dop))
    p = FA._probs(q, k, lse.double(), t_k, causal, scale)
    m_ds = torch.einsum("bqd,bkd->bqk", do, v).abs_()
    m_delta = (do.abs() * o.double().abs()).sum(dim=-1, keepdim=True)
    m_ds = m_ds.add_(m_delta).mul_(p).mul_(scale)
    return (torch.einsum("bqk,bkd->bqd", p, v.abs()),
            torch.einsum("bqk,bkd->bqd", m_ds, k.abs()),
            torch.einsum("bqk,bqd->bkd", m_ds, q.abs()),
            torch.einsum("bqk,bqd->bkd", p, do.abs()))


def diagonal_mask_off(tqp, tkp, t_k, causal, device):
    """A planted fault of the flash mask (``_valid``'s contract): inside a
    64 x 64 tile on the diagonal, keys after the query count too."""
    qi = torch.arange(tqp, device=device)[:, None]
    ki = torch.arange(tkp, device=device)[None, :]
    valid = ki < t_k
    if causal:
        valid = valid & ((qi >= ki) | (qi // 64 == ki // 64))
    return valid


def flash_bf16_faults(qp, kp, vp, lse, dop, delta, t_k, causal, scale):
    """The planted faults of the bf16 forms on the padded problem,
    {fault: {output: tensor}}, each the plain twins' arithmetic with one
    thing wrong: every product's accumulator rounded to bf16 after each
    16-deep slice ("bf16_accumulator"; o from P against the row's final
    max); dS = P dP scale ("delta_dropped", the backward's); keys after
    the query counted inside the diagonal tile ("diagonal_mask_off", for
    a causal problem); P fed to P^T dO in f32 ("p_unrounded"), dS to dS K
    and dS^T Q in f32 ("ds_unrounded")."""
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    bf = torch.bfloat16
    args = (lse, dop, delta, t_k, causal, scale)
    q, k, v, do = (x.float() for x in (qp, kp, vp, dop))
    p, ds = FA._ds(q, k, v, lse, do, delta, t_k, causal, scale)
    pb, dsb = p.to(bf), ds.to(bf)
    out = {"bf16_accumulator": {
        "o": slice_rounded_product(pb, vp),
        "dq": slice_rounded_product(dsb, kp),
        "dk": slice_rounded_product(dsb.transpose(1, 2), qp),
        "dv": slice_rounded_product(pb.transpose(1, 2), dop)}}
    del pb, dsb
    out["p_unrounded"] = {"dv": torch.einsum("bqk,bqd->bkd", p, do).to(bf)}
    out["ds_unrounded"] = {"dq": torch.einsum("bqk,bkd->bqd", ds, k).to(bf),
                           "dk": torch.einsum("bqk,bqd->bkd", ds, q).to(bf)}
    del p, ds
    no_delta = torch.zeros_like(delta)
    out["delta_dropped"] = {
        "dq": FA._bwd_dq_plain(qp, kp, vp, lse, dop, no_delta, *args[3:]),
        "dk": FA._bwd_dkv_plain(qp, kp, vp, lse, dop, no_delta,
                                *args[3:])[0]}
    if not causal:
        return out
    plain_valid = FA._valid
    FA._valid = diagonal_mask_off
    try:
        o = FA._fwd_plain(qp, kp, vp, t_k, causal, scale)[0]
        dk, dv = FA._bwd_dkv_plain(qp, kp, vp, *args)
        out["diagonal_mask_off"] = {
            "o": o, "dq": FA._bwd_dq_plain(qp, kp, vp, *args), "dk": dk,
            "dv": dv}
    finally:
        FA._valid = plain_valid
    return out


def flash_bf16_case(qp, kp, vp, dop, t_q, t_k, causal, scale) -> dict:
    """The three bf16 forms on one padded problem against their twins:
    {"got", "want", "mags", "faults", "rerun_bit_identical", "lse_err",
    "args"}, outputs keyed o, dq, dk, dv and cut to the valid rows."""
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    def run():
        o, lse = FA._fwd_kernel(qp, kp, vp, t_k, causal, scale)
        delta = FA._delta(dop, o).contiguous()
        args = (qp, kp, vp, lse, dop, delta, t_k, causal, scale)
        return (o, lse, delta, args, FA._bwd_dq_kernel(*args),
                *FA._bwd_dkv_kernel(*args))

    o, lse, delta, args, dq, dk, dv = run()
    again = run()
    rerun = all(torch.equal(x, y) for x, y in zip((o, lse, dq, dk, dv),
                                                 again[:2] + again[4:]))
    del again
    o_ref, lse_ref = FA._fwd_plain(qp, kp, vp, t_k, causal, scale)
    want = {"o": o_ref, "dq": FA._bwd_dq_plain(*args)}
    want["dk"], want["dv"] = FA._bwd_dkv_plain(*args)
    got = {"o": o, "dq": dq, "dk": dk, "dv": dv}
    mags = dict(zip(("o", "dq", "dk", "dv"), flash_bf16_mags(
        qp, kp, vp, o, lse, dop, t_k, causal, scale)))
    faults = flash_bf16_faults(*args)
    lse_err = float(((lse - lse_ref).abs() / lse_ref.abs().clamp(min=1))
                    [:, :t_q].max())

    def cut(d):
        return {n: x[:, :t_q if n in ("o", "dq") else t_k]
                for n, x in d.items()}

    return {"got": cut(got), "want": cut(want), "mags": cut(mags),
            "faults": {f: cut(d) for f, d in faults.items()},
            "rerun_bit_identical": rerun, "lse_err": lse_err,
            "args": args}


def flash_wgmma_bwd_case(q, k, v, g, causal, scale) -> dict:
    """The Hopper backward (``_bwd_bthd``, after the Hopper forward) on
    [B, T, H, D] q, k, v and dO as they lie, against the twins on the
    padded problem from the same o and lse: {"got", "want", "mags"} keyed
    dq, dk, dv in [B, T, H, D], "rerun_bit_identical", and "args" (o,
    lse) for the timings."""
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    o, lse = FA._fwd_bthd(q, k, v, causal, scale)
    got = FA._bwd_bthd(q, k, v, o, lse, g, causal, scale)
    again = FA._bwd_bthd(q, k, v, o, lse, g, causal, scale)
    rerun = all(torch.equal(x, y) for x, y in zip(got, again))
    del again
    want, mags = flash_wgmma_bwd_want(q, k, v, o, lse, g, causal, scale)
    return {"got": dict(zip(("dq", "dk", "dv"), got)), "want": want,
            "mags": mags, "rerun_bit_identical": rerun, "args": (o, lse)}


def flash_wgmma_bwd_want(q, k, v, o, lse, g, causal, scale):
    """The twins' dq, dk, dv of the Hopper backward and their
    ``flash_bf16_mags``, each cut to the valid rows in [B, T, H, D]."""
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    b, t_q, h, d = q.shape
    t_k = k.shape[1]
    qp, kp, vp = FA._prep(q, k, v)
    dop, op = FA._to_bh(g), FA._to_bh(o)
    dq, dk, dv = FA._bwd_plain(qp, kp, vp, op, lse, dop, t_k, causal, scale)
    mags = flash_bf16_mags(qp, kp, vp, op, lse, dop, t_k, causal, scale)[1:]
    lens = (t_q, t_k, t_k)
    return ({n: FA._from_bh(x, b, h, t, d)
             for n, x, t in zip(("dq", "dk", "dv"), (dq, dk, dv), lens)},
            {n: FA._from_bh(x, b, h, t, d)
             for n, x, t in zip(("dq", "dk", "dv"), mags, lens)})


def check_flash_bf16(dev, timer) -> tuple[list, dict]:
    """The bf16 forms of rows 2 and 3 at the LM training shape [16, 1024,
    12, 64] causal and at T = 333: each output (o, dq, dk, dv) against its
    twin on the same inputs by ``bf16_agrees`` with FLASH_BF16_FLIP (equal
    on all but 1% of the elements, each within one ulp at the larger
    magnitude plus 2^-7 of its ``flash_bf16_mags``), lse within 1e-4 x
    max(1, |lse|), a rerun in the same bits: the mma.sync forms on the
    padded problem, and the Hopper forward and backward (the LM's path at
    head_dim 64) on q, k, v, dO as they lie.  Each planted fault of
    FLASH_BF16_FAULTS must fail it on every output it moves, and each of
    the Hopper forms' source faults (FLASH_WGMMA_FAULTS,
    FLASH_WGMMA_BWD_FAULTS) on one output at least.  Times at T = 1024
    (bf16, 2 B an element, 989 TFLOP/s): each Hopper kernel with the L2
    flushed, alone (a trace), the host's ms a call, its twin, its bound;
    the forward and the whole backward (delta and both kernels, as the
    autograd backward runs it) beside bf16 ``scaled_dot_product_attention``
    with the flash backend (a yardstick only); the mma.sync forms' kernels
    beside."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    wgmma_builds = source_fault_builds("flash_attention", FLASH_WGMMA_FAULTS)
    bwd_builds = source_fault_builds("flash_attention_bwd",
                                     FLASH_WGMMA_BWD_FAULTS)
    gen = torch.Generator(device=dev).manual_seed(8)
    h, d = 12, 64
    scale = d ** -0.5
    summary = {"phase": "flash_bf16", "flip": FLASH_BF16_FLIP,
               "share": BF16_ULP_SHARE}
    rows, worst = [], {}
    for b, t in FLASH_BF16_SHAPES:
        q, k, v, g = (torch.randn(b, t, h, d, generator=gen, device=dev)
                      .to(torch.bfloat16) for _ in range(4))
        qp, kp, vp = FA._prep(q, k, v)
        dop = FA._prep(g, g, g)[0]
        case = flash_bf16_case(qp, kp, vp, dop, t, t, True, scale)
        per = {"lse_err": case["lse_err"],
               "rerun_bit_identical": case["rerun_bit_identical"]}
        ok = case["rerun_bit_identical"] and case["lse_err"] <= TOL
        for n, got in case["got"].items():
            a = bf16_agreement(got, case["want"][n], case["mags"][n],
                               coef=FLASH_BF16_FLIP)
            per[n] = a
            worst[n] = max(worst.get(n, 0.0), a["max_abs_err"])
            ok = ok and bf16_agrees(got, case["want"][n], case["mags"][n],
                                    coef=FLASH_BF16_FLIP)
        # the Hopper forward (the path's) on q, k, v as they lie
        hop = flash_forward_agreement(q, k, v, *FA._fwd_bthd(
            q, k, v, True, scale), True, scale)
        per["o_wgmma"] = hop
        worst["o_wgmma"] = hop["max_abs_err"]
        ok = ok and hop["agrees"]
        for fault in case["faults"]:
            per[fault] = {}
            for n in FLASH_BF16_FAULTS[fault]:
                bad = case["faults"][fault][n]
                per[fault][n] = bf16_agreement(
                    bad, case["want"][n], case["mags"][n],
                    coef=FLASH_BF16_FLIP)["share_off"]
                ok = ok and not bf16_agrees(bad, case["want"][n],
                                            case["mags"][n],
                                            coef=FLASH_BF16_FLIP)
        args = case.pop("args")
        del case
        # the Hopper backward (the path's) on q, k, v, dO as they lie
        hcase = flash_wgmma_bwd_case(q, k, v, g, True, scale)
        per["wgmma_backward_rerun_bit_identical"] = hcase[
            "rerun_bit_identical"]
        ok = ok and hcase["rerun_bit_identical"]
        for n, got in hcase["got"].items():
            a = bf16_agreement(got, hcase["want"][n], hcase["mags"][n],
                               coef=FLASH_BF16_FLIP)
            per[f"{n}_wgmma"] = a
            worst[f"{n}_wgmma"] = max(worst.get(f"{n}_wgmma", 0.0),
                                      a["max_abs_err"])
            ok = ok and bf16_agrees(got, hcase["want"][n], hcase["mags"][n],
                                    coef=FLASH_BF16_FLIP)
        o_h, lse_h = hcase.pop("args")
        del hcase
        summary[f"T{t}"] = per
        if not ok:
            raise AssertionError(f"bf16 flash forms at [{b}, {t}, {h}, {d}]:"
                                 f" {per}")
        if t != 1024:
            continue
        o, lse = FA._fwd_kernel(qp, kp, vp, t, True, scale)
        pairs_n = b * h * t * (t + 1) // 2
        act = 2.0 * b * t * h * d              # one [B, T, H, D] bf16 tensor
        rowvec = 4.0 * b * h * t               # lse or delta, f32
        qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        gh = g.transpose(1, 2).contiguous()
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            def sdpa():
                return F.scaled_dot_product_attention(qh, kh, vh,
                                                      is_causal=True)
            library_fwd = timer(sdpa)
            out = sdpa()
        library_bwd = timer(lambda: torch.autograd.grad(
            out, (qh, kh, vh), gh, retain_graph=True))
        fwd = lambda: FA._fwd_bthd(q, k, v, True, scale)  # noqa: E731
        mma = lambda: FA._fwd_kernel(qp, kp, vp, t, True, scale)  # noqa: E731
        dq_mma = lambda: FA._bwd_dq_kernel(*args)                 # noqa: E731
        dkv_mma = lambda: FA._bwd_dkv_kernel(*args)               # noqa: E731
        summary["mma_sync_forms"] = {
            "shape": [b, t, h, d],
            "forward": {"ms": timer(mma),
                        "alone_ms": device_ms([mma], "flash_fwd_bf16_kernel")},
            "dq": {"ms": timer(dq_mma),
                   "alone_ms": device_ms([dq_mma], "flash_bwd_dq_bf16")},
            "dkv": {"ms": timer(dkv_mma),
                    "alone_ms": device_ms([dkv_mma], "flash_bwd_dkv_bf16")},
            "whole_backward_padded_ms": timer(lambda: FA._bwd_kernel(
                qp, kp, vp, o, lse, dop, t, True, scale))}
        delta_h = FA._delta_bthd(g, o_h, lse_h.shape[1])
        bwd_args = (lse_h, g, delta_h, True, scale)
        dq = lambda: FA._bwd_dq_bthd(q, k, v, *bwd_args)         # noqa: E731
        dkv = lambda: FA._bwd_dkv_bthd(q, k, v, *bwd_args)       # noqa: E731
        # name, call, kernel name in a trace, plain twin, bytes, flops,
        # library call
        forms = (
            (FLASH_BF16_NAMES[0], fwd, "flash_fwd_wgmma_kernel",
             lambda: FA._fwd_plain(qp, kp, vp, t, True, scale),
             4 * act + rowvec, 4.0 * pairs_n * d, library_fwd, ":277"),
            (FLASH_BF16_NAMES[1], dq, "flash_bwd_dq_wgmma_kernel",
             lambda: FA._bwd_dq_plain(*args), 5 * act + 2 * rowvec,
             6.0 * pairs_n * d, None, ":378"),
            (FLASH_BF16_NAMES[2], dkv, "flash_bwd_dkv_wgmma_kernel",
             lambda: FA._bwd_dkv_plain(*args), 6 * act + 2 * rowvec,
             8.0 * pairs_n * d, None, ":401"))
        for name, fn, key, plain, nbytes, flops, library, line in forms:
            bound_ms, by = bound(nbytes, flops, BF16_FLOPS_PER_S)
            rows.append({
                "name": name, "route": "cuda",
                "source": "paddle_tpu_torch/ops/kernels/csrc/" + (
                    "flash_attention.cu" if "fwd" in name
                    else "flash_attention_bwd.cu"),
                "replaces": "paddle_tpu/ops/pallas/flash_attention.py" + line,
                "shape": [b, t, h, d], "dtype": "bfloat16",
                "ms": timer(fn), "alone_ms": device_ms([fn], key),
                "host_ms": host_ms(fn),
                "plain_ms": timer(plain), "bound_ms": bound_ms,
                "bound_by": by, "library_ms": library})
        bound_ms, by = bound(8 * act + rowvec, 10.0 * pairs_n * d,
                             BF16_FLOPS_PER_S)
        whole = lambda: FA._bwd_bthd(q, k, v, o_h, lse_h, g, True,  # noqa
                                      scale)
        summary["whole_backward"] = {
            "shape": [b, t, h, d], "gflop": 10.0 * pairs_n * d / 1e9,
            "gbytes": (8 * act + rowvec) / 1e9,
            "route": "Hopper: delta from [B, T, H, D], then the two wgmma "
                     "kernels",
            "ms": timer(whole),
            "kernels_alone_ms": device_passes_ms(
                [whole], ("flash_bwd_dq_wgmma_kernel",
                          "flash_bwd_dkv_wgmma_kernel"))["total"],
            "host_ms": host_ms(whole),
            "plain_ms": timer(lambda: FA._bwd_plain(qp, kp, vp, o, lse, dop,
                                                    t, True, scale)),
            "library_ms": library_bwd, "library": "SDPA flash backend",
            "bound_ms": bound_ms, "bound_by": by}
        del qh, kh, vh, out, args
    for row in rows:
        outs = {"fwd": ("o_wgmma",), "dq": ("dq_wgmma",),
                "dkv": ("dk_wgmma", "dv_wgmma")}[row["name"].split("_")[-2]]
        row["max_abs_err"] = max(worst[n] for n in outs)
    summary["max_abs_err"] = worst
    summary["wgmma_planted_faults"] = flash_wgmma_faults(dev, wgmma_builds)
    summary["wgmma_backward_planted_faults"] = flash_wgmma_bwd_faults(
        dev, bwd_builds)
    torch.cuda.synchronize()
    return rows, summary


#: the Hopper form's planted faults: {fault: [(a line of
#: csrc/flash_attention.cu, what it becomes)]}, built by
#: :func:`source_fault_builds`; each must fail ``bf16_agrees`` against the
#: twin (:func:`flash_wgmma_faults`)
FLASH_WGMMA_FAULTS = {
    # P fed to P.V unrounded: its bf16 residual added by a second product
    "p_unrounded": [(
        "        Pv<D>::run(acc, pa[kk], wg::desc(vs + 2048 * kk, kPanelBytes, "
        "1024));",
        "      {\n"
        "        const uint64_t vd = wg::desc(vs + 2048 * kk, kPanelBytes, "
        "1024);\n"
        "        Pv<D>::run(acc, pa[kk], vd);\n"
        "        uint32_t lo[4];\n"
        "        for (int e = 0; e < 4; ++e)\n"
        "          lo[e] = tc::pack_bf16x2(\n"
        "              s[8 * kk + 2 * e] - __uint_as_float(pa[kk][e] << 16),\n"
        "              s[8 * kk + 2 * e + 1] -\n"
        "                  __uint_as_float(pa[kk][e] & 0xffff0000u));\n"
        "        Pv<D>::run(acc, lo, vd);\n"
        "      }")],
    # a ring stage released as soon as it is full, before the products
    # that read it are issued (one arrival a use still, so nothing hangs)
    "stage_released_early": [
        ("    wg::mbar_wait(full + 8 * stage, phase);",
         "    wg::mbar_wait(full + 8 * stage, phase);\n"
         "    if (leader) wg::mbar_arrive(empty + 8 * stage);"),
        ("    if (leader) wg::mbar_arrive(empty + 8 * stage);\n"
         "    if (++stage == L::kStages) {",
         "    if (++stage == L::kStages) {")],
}

#: the gather's planted fault: the padding id's rows copied, not zeroed
GATHER_FAULTS = {"padding_not_zeroed": (
    "        if (has_pad && id == pad) {", "        if (false) {")}


def flash_forward_agreement(q, k, v, o, lse, causal, scale) -> dict:
    """A bf16 forward's o [B, Tq, H, D] and lse [B*H, Tqp, 1] against the
    twin (``_fwd_plain_tiled`` on the padded problem) on the same q, k, v:
    o by ``bf16_agrees`` with FLASH_BF16_FLIP (its mag P |V| from the
    twin's lse, in float64), lse within 1e-4 x max(1, |lse|) on every
    padded row the backward reads."""
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    b, t_q, h, d = q.shape
    t_k = k.shape[1]
    qp, kp, vp = FA._prep(q, k, v)
    o_ref, lse_ref = FA._fwd_plain(qp, kp, vp, t_k, causal, scale)
    p = FA._probs(qp.double(), kp.double(), lse_ref.double(), t_k, causal,
                  scale)
    mag = FA._from_bh(torch.einsum("bqk,bkd->bqd", p, vp.double().abs()),
                      b, h, t_q, d)
    del p
    want = FA._from_bh(o_ref, b, h, t_q, d)
    a = bf16_agreement(o, want, mag, coef=FLASH_BF16_FLIP)
    lse_err = float(((lse - lse_ref).abs() / lse_ref.abs().clamp(min=1))
                    .max())
    return {**a, "lse_err": lse_err,
            "agrees": bf16_agrees(o, want, mag, coef=FLASH_BF16_FLIP)
            and lse_err <= TOL}


def flash_wgmma_faults(dev, builds, shapes=((8, 512), (16, 1024))) -> dict:
    """Each planted fault of FLASH_WGMMA_FAULTS (``builds``: from
    :func:`source_fault_builds`) in place of the Hopper form's entry at
    the main path's shapes ([B, T, 12, 64] causal): each must fail
    :func:`flash_forward_agreement` at one of them at least, where the
    real entry passes."""
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    gen = torch.Generator(device=dev).manual_seed(21)
    cases = [tuple(torch.randn(b, t, 12, 64, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
             for b, t in shapes]
    kernel = FA.KERNEL_WGMMA
    real = kernel._fn or kernel._resolve()
    out = {}
    for name, (proc, lib) in builds.items():
        kernel._fn = planted(proc, lib, kernel)
        try:
            per = {}
            for q, k, v in cases:
                o, lse = FA._fwd_bthd(q, k, v, True, 0.125)
                torch.cuda.synchronize()
                a = flash_forward_agreement(q, k, v, o, lse, True, 0.125)
                per[f"T{q.shape[1]}"] = {"share_off": a["share_off"],
                                         "agrees": a["agrees"]}
        finally:
            kernel._fn = real
        out[name] = per
        if all(c["agrees"] for c in per.values()):
            raise AssertionError(f"planted fault {name} of the Hopper flash "
                                 f"forward passed: {per}")
    return out


#: the Hopper backward's planted faults: {fault: [(a line of
#: csrc/flash_attention_bwd.cu, what it becomes)]}, built by
#: :func:`source_fault_builds`; each must fail ``bf16_agrees`` against the
#: twins on one of dq, dk, dv at least (:func:`flash_wgmma_bwd_faults`)
FLASH_WGMMA_BWD_FAULTS = {
    # P fed to dV += P^T dO unrounded: its bf16 residual added by a second
    # product
    "p_unrounded": [(
        "        Pv<D>::run(acc_v, pa[kk], wg::desc(dos + 2048 * kk, "
        "kPanelBytes, 1024));",
        "      {\n"
        "        const uint64_t od = wg::desc(dos + 2048 * kk, kPanelBytes, "
        "1024);\n"
        "        Pv<D>::run(acc_v, pa[kk], od);\n"
        "        uint32_t lo[4];\n"
        "        for (int e = 0; e < 4; ++e)\n"
        "          lo[e] = bf16_tc::pack_bf16x2(\n"
        "              s[8 * kk + 2 * e] - __uint_as_float(pa[kk][e] << 16),\n"
        "              s[8 * kk + 2 * e + 1] -\n"
        "                  __uint_as_float(pa[kk][e] & 0xffff0000u));\n"
        "        Pv<D>::run(acc_v, lo, od);\n"
        "      }")],
    # dS fed to dK += dS^T Q and dQ += dS K unrounded, the same way
    "ds_unrounded": [(
        "        Pv<D>::run(acc_k, dsa[kk], wg::desc(qs + 2048 * kk, "
        "kPanelBytes, 1024));",
        "      {\n"
        "        const uint64_t qd = wg::desc(qs + 2048 * kk, kPanelBytes, "
        "1024);\n"
        "        Pv<D>::run(acc_k, dsa[kk], qd);\n"
        "        uint32_t lo[4];\n"
        "        for (int e = 0; e < 4; ++e)\n"
        "          lo[e] = bf16_tc::pack_bf16x2(\n"
        "              dp[8 * kk + 2 * e] - __uint_as_float(dsa[kk][e] << 16),"
        "\n"
        "              dp[8 * kk + 2 * e + 1] -\n"
        "                  __uint_as_float(dsa[kk][e] & 0xffff0000u));\n"
        "        Pv<D>::run(acc_k, lo, qd);\n"
        "      }"), (
        "        Pv<D>::run(acc, dsa[kk], wg::desc(ks + 2048 * kk, "
        "kPanelBytes, 1024));",
        "      {\n"
        "        const uint64_t kd = wg::desc(ks + 2048 * kk, kPanelBytes, "
        "1024);\n"
        "        Pv<D>::run(acc, dsa[kk], kd);\n"
        "        uint32_t lo[4];\n"
        "        for (int e = 0; e < 4; ++e)\n"
        "          lo[e] = bf16_tc::pack_bf16x2(\n"
        "              s[8 * kk + 2 * e] - __uint_as_float(dsa[kk][e] << 16),\n"
        "              s[8 * kk + 2 * e + 1] -\n"
        "                  __uint_as_float(dsa[kk][e] & 0xffff0000u));\n"
        "        Pv<D>::run(acc, lo, kd);\n"
        "      }")],
    # dS = P dP scale in both kernels
    "delta_dropped": [
        ("          dp[e] = p * (dp[e] - dl) * scale;",
         "          dp[e] = p * dp[e] * scale;"),
        ("        s[e] = p * (dp[e] - dlt[hh]) * scale;",
         "        s[e] = p * dp[e] * scale;")],
    # a ring stage released as soon as it is full, before the products
    # that read it are issued, in both kernels (one arrival a use still,
    # so nothing hangs)
    "stage_released_early": [
        ("    wg::mbar_wait(qfull + 8 * stage, phase);",
         "    wg::mbar_wait(qfull + 8 * stage, phase);\n"
         "    if (leader) wg::mbar_arrive(qempty + 8 * stage);"),
        ("    if (leader) wg::mbar_arrive(qempty + 8 * stage);\n"
         "    if (++stage == L::kStages) {",
         "    if (++stage == L::kStages) {"),
        ("    wg::mbar_wait(kfull + 8 * stage, phase);",
         "    wg::mbar_wait(kfull + 8 * stage, phase);\n"
         "    if (leader) wg::mbar_arrive(kempty + 8 * stage);"),
        ("    if (leader) wg::mbar_arrive(kempty + 8 * stage);\n"
         "    if (++stage == L::kStages) {",
         "    if (++stage == L::kStages) {")],
}


def flash_wgmma_bwd_faults(dev, builds, shape=(16, 1024)) -> dict:
    """Each planted fault of FLASH_WGMMA_BWD_FAULTS (``builds``: from
    :func:`source_fault_builds`) in place of the Hopper backward's two
    entries at the LM's shape ([B, T, 12, 64] causal): each must fail
    ``bf16_agrees`` against the twins on one of dq, dk, dv at least, where
    the real entries pass (:func:`check_flash_bf16`)."""
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    gen = torch.Generator(device=dev).manual_seed(22)
    b, t = shape
    q, k, v, g = (torch.randn(b, t, 12, 64, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(4))
    o, lse = FA._fwd_bthd(q, k, v, True, 0.125)
    want, mags = flash_wgmma_bwd_want(q, k, v, o, lse, g, True, 0.125)
    kernels = (FA.KERNEL_BWD_DQ_WGMMA, FA.KERNEL_BWD_DKV_WGMMA)
    real = [k_._fn or k_._resolve() for k_ in kernels]
    out = {}
    for name, (proc, lib) in builds.items():
        for kernel, fn in zip(kernels, planted_all(proc, lib, kernels)):
            kernel._fn = fn
        try:
            got = FA._bwd_bthd(q, k, v, o, lse, g, True, 0.125)
            torch.cuda.synchronize()
            per = {}
            for n, x in zip(("dq", "dk", "dv"), got):
                per[n] = {"share_off": bf16_agreement(
                    x, want[n], mags[n], coef=FLASH_BF16_FLIP)["share_off"],
                    "agrees": bf16_agrees(x, want[n], mags[n],
                                          coef=FLASH_BF16_FLIP)}
        finally:
            for kernel, fn in zip(kernels, real):
                kernel._fn = fn
        out[name] = per
        if all(c["agrees"] for c in per.values()):
            raise AssertionError(f"planted fault {name} of the Hopper flash "
                                 f"backward passed: {per}")
    return out


def flash_counters() -> dict:
    """{name: Kernel} of the flash forms, f32 and bf16."""
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    return {"fwd": FA.KERNEL, "dq": FA.KERNEL_BWD_DQ,
            "dkv": FA.KERNEL_BWD_DKV, "fwd_bf16": FA.KERNEL_BF16,
            "fwd_wgmma": FA.KERNEL_WGMMA, "dq_bf16": FA.KERNEL_BWD_DQ_BF16,
            "dkv_bf16": FA.KERNEL_BWD_DKV_BF16,
            "dq_wgmma": FA.KERNEL_BWD_DQ_WGMMA,
            "dkv_wgmma": FA.KERNEL_BWD_DKV_WGMMA}


def lm_bf16_setup():
    """(config, f32 params on the CPU, ids [2, 129]) of the LM's bf16
    witness step (``LM_BF16_NET``)."""
    from paddle_tpu_torch.models import transformer as T

    cfg = T.TransformerConfig(**LM_BF16_NET, attn_impl="flash", remat=False)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b, t = LM_BF16_BATCH
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(b, t + 1)))
    return cfg, params, ids


def lm_bf16_errors(loss, grads, loss64, g64) -> dict:
    """Per gradient leaf ||g - g64|| / ||g64||, and the loss's relative
    error under "loss"."""
    out = {n: rel_norm(x, g64[n]) for n, x in named_leaves(grads).items()}
    out["loss"] = abs(float(loss) - float(loss64)) / abs(float(loss64))
    return out


def lm_bf16_witness(dev) -> dict:
    """The LM's bf16 witness step at ``LM_BF16_NET``: ``loss_and_grads(...,
    compute_dtype=torch.bfloat16)`` on the card (the bf16 kernels: 2 of
    each form, no f32 flash launch) and on the CPU (the twins), each
    against the float64 step on the CPU, per gradient leaf and the loss,
    within 2x the JAX package's own bf16 error (``LM_BF16_WITNESS_JAX``)
    plus LM_BF16_FLOOR; the card's step repeats bit for bit, and the card
    step with the backward's delta dropped must exceed the limit."""
    from paddle_tpu_torch.core import tree
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    cfg, params, ids = lm_bf16_setup()
    bf = torch.bfloat16
    loss64, g64 = T.loss_and_grads(cfg, tree.unflatten(params, [
        p.double() for p in tree.leaves(params)]), ids)
    g64 = named_leaves(g64)
    on_card = tree.unflatten(params, [p.to(dev) for p in tree.leaves(params)])
    counters = flash_counters()
    for c in counters.values():
        c.launches = 0
    sides = {"card": T.loss_and_grads(cfg, on_card, ids.to(dev), bf)}
    launches = {n: c.launches for n, c in counters.items()}
    rerun = T.loss_and_grads(cfg, on_card, ids.to(dev), bf)
    sides["cpu"] = T.loss_and_grads(cfg, params, ids, bf)
    # delta dropped on the Hopper route (head_dim 64) and the padded one
    plain = FA._delta, FA._delta_bthd
    FA._delta = lambda do, o: torch.zeros_like(plain[0](do, o))
    FA._delta_bthd = lambda do, o, tqp: torch.zeros_like(plain[1](do, o, tqp))
    try:
        sides["card_delta_dropped_control"] = T.loss_and_grads(
            cfg, on_card, ids.to(dev), bf)
    finally:
        FA._delta, FA._delta_bthd = plain
    layers = cfg.num_layers
    if launches != {"fwd": 0, "dq": 0, "dkv": 0, "fwd_bf16": 0,
                    "fwd_wgmma": layers, "dq_bf16": 0, "dkv_bf16": 0,
                    "dq_wgmma": layers, "dkv_wgmma": layers}:
        raise AssertionError(f"the bf16 witness step's flash launches "
                             f"{launches}")
    if not (torch.equal(rerun[0], sides["card"][0]) and all(
            torch.equal(a, b) for a, b in zip(tree.leaves(rerun[1]),
                                              tree.leaves(sides["card"][1])))):
        raise AssertionError("the card's bf16 LM step is not bit-identical "
                             "on a rerun")
    out = {"net": LM_BF16_NET, "batch": list(LM_BF16_BATCH),
           "loss_f64": float(loss64), "launches": launches,
           "limit": f"2 x JAX's own + {LM_BF16_FLOOR}",
           "card_rerun_bit_identical": True}
    for label, (loss, grads) in sides.items():
        errs = lm_bf16_errors(loss, grads, loss64, g64)
        share = {n: e / (2 * LM_BF16_WITNESS_JAX[n] + LM_BF16_FLOOR)
                 for n, e in errs.items()}
        n_worst = max(share, key=share.get)
        out[label] = {"loss": float(loss), "worst": n_worst,
                      "err": errs[n_worst], "jax": LM_BF16_WITNESS_JAX[n_worst],
                      "share_of_limit": share[n_worst],
                      "median_err": float(np.median(list(errs.values()))),
                      "over_limit": [n for n, x in share.items() if x > 1]}
    for label in ("card", "cpu"):
        if out[label]["over_limit"]:
            raise AssertionError(f"bf16 LM {label} step vs the f64 witness: "
                                 f"{out}")
    if not out["card_delta_dropped_control"]["over_limit"]:
        raise AssertionError(f"the bf16 LM witness limit does not catch a "
                             f"backward without delta: {out}")
    return out


def train_lm_bf16(dev, bs=16, seqlen=1024, steps=10,
                  net=LM_FULL) -> tuple[dict, dict]:
    """The GPT-2-small-shape LM through ``transformer.build_train_step(cfg,
    Adam(1e-4, moment_dtype=torch.bfloat16), compute_dtype=torch.bfloat16)``
    (the repo's LM benchmark: ``bench.py:891-937``) beside the same step in
    f32 from the same parameters: the witness (:func:`lm_bf16_witness`),
    then 2 warm-up steps each and ``steps`` timed steps each in blocks of
    ``steps // 2`` (bf16, f32, f32, bf16) on one fixed batch of 16 x 1024,
    the launch counts zeroed just before each block and read just after:
    exactly 12 of each Hopper form (the forward, dQ and dK/dV) a bf16 step
    and no mma.sync or f32 flash launch (and 12 of each f32 form, the
    3xTF32 backward's among them, an f32 step and no bf16 launch); tokens/s, step ms p50, peak memory, the bf16 MFU
    against 989 TFLOP/s by ``bench.py:928-929``'s FLOP count, bf16 losses
    finite and falling; 3 bf16 steps under ``torch.profiler``.  Returns
    (the phase's result, the bf16 forms' launches over the timed run)."""
    from paddle_tpu_torch.core import tree
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.optimizer import Adam

    t0 = time.perf_counter()
    witness = lm_bf16_witness(dev)
    cfg = T.TransformerConfig(**net, dtype=torch.float32, remat=False,
                              attn_impl="flash")
    master = T.init_params(cfg, torch.Generator().manual_seed(0), dev)
    n_params = T.count_params(master)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(bs, seqlen + 1))).to(dev)
    runs = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        params = tree.unflatten(master, [p.clone()
                                         for p in tree.leaves(master)])
        opt = Adam(learning_rate=1e-4, moment_dtype=torch.bfloat16)
        runs[name] = {"params": params, "state": opt.init_tree(params),
                      "step": T.build_train_step(cfg, opt,
                                                 compute_dtype=dtype),
                      "losses": [], "step_ms": [], "walls": [], "peak": 0}
    del master

    def one(run):
        run["params"], run["state"], loss = run["step"](
            run["params"], run["state"], ids)
        return loss

    for run in runs.values():
        for _ in range(2):
            run["losses"].append(float(one(run)))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    layers, per_block = cfg.num_layers, steps // 2
    want = {"bf16": {"fwd_wgmma": layers, "dq_wgmma": layers,
                     "dkv_wgmma": layers},
            "f32": {"fwd": layers, "dq": layers, "dkv": layers}}
    counters = flash_counters()
    launched = {n: 0 for n in counters}
    for name in ("bf16", "f32", "f32", "bf16"):
        run = runs[name]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for c in counters.values():
            c.launches = 0
        t1 = time.perf_counter()
        for _ in range(per_block):
            a = time.perf_counter()
            loss = one(run)
            torch.cuda.synchronize()
            run["step_ms"].append(1e3 * (time.perf_counter() - a))
            run["losses"].append(float(loss))
        run["walls"].append(time.perf_counter() - t1)
        got = {n: c.launches for n, c in counters.items()}
        expect = {n: want[name].get(n, 0) * per_block for n in counters}
        if got != expect:
            raise AssertionError(f"LM {name} block launches {got} != "
                                 f"{expect}")
        launched = {n: launched[n] + got[n] for n in counters}
        run["peak"] = max(run["peak"], torch.cuda.max_memory_allocated(dev))
    tokens = bs * seqlen
    flops = (6.0 * n_params * tokens + 12.0 * cfg.num_layers * bs * seqlen
             * seqlen * cfg.embed_dim / 2)        # bench.py's count
    out = {"phase": "train_lm_bf16",
           "model": "transformer LM, GPT-2-small shape", "params": n_params,
           "compute_dtype": "bfloat16", "masters": "float32",
           "adam_moments": "bfloat16", "lr": 1e-4, "batch": [bs, seqlen],
           "steps_per_dtype": steps, "step_vs_f64_witness": witness,
           "flop_per_step": flops, "setup_s": setup_s}
    for name, run in runs.items():
        p50 = float(np.percentile(run["step_ms"], 50))
        out[name] = {"tokens_per_s": tokens * len(run["step_ms"])
                     / sum(run["walls"]), "step_ms_p50": p50,
                     "step_ms": run["step_ms"], "losses": run["losses"],
                     "max_memory_allocated_bytes": run["peak"]}
        if not all(np.isfinite(run["losses"])):
            raise AssertionError(f"LM {name} losses {run['losses']}")
    if not out["bf16"]["losses"][-1] < out["bf16"]["losses"][0]:
        raise AssertionError(f"bf16 LM losses not falling: "
                             f"{out['bf16']['losses']}")
    for name in runs:
        if not all(p.dtype == torch.float32
                   for p in tree.leaves(runs[name]["params"])):
            raise AssertionError("the LM's masters are not f32")
    out["mfu_bf16_vs_989tflops"] = (flops / (out["bf16"]["step_ms_p50"] / 1e3)
                                    / BF16_FLOPS_PER_S)
    out["mfu_f32_vs_67tflops"] = (flops / (out["f32"]["step_ms_p50"] / 1e3)
                                  / F32_FLOPS_PER_S)
    out["bf16_vs_f32_tokens_per_s"] = (out["bf16"]["tokens_per_s"]
                                       / out["f32"]["tokens_per_s"])
    bf16 = runs["bf16"]
    prof = profile_window(lambda: [one(bf16) for _ in range(3)], 3,
                          split="train_step/optimizer")
    if "device_busy_ms_per_step" in prof:
        prof["idle_share_vs_step_p50"] = (
            1 - prof["device_busy_ms_per_step"] / out["bf16"]["step_ms_p50"])
    out["profile"] = prof
    out["train_launches"] = launched
    del runs, bf16
    return out, {n: launched[k] for n, k in zip(
        FLASH_BF16_NAMES, ("fwd_wgmma", "dq_wgmma", "dkv_wgmma"))}


# -- phase 15: the LSTM text classifier and the OCR CRNN in bf16 -------------

#: The bf16 recurrences are held step by step: every step of a bf16 form's
#: output is recomputed in float64 from the output's own carries (the
#: step's h_{t-1}, c_{t-1}; in the backward, the dh carry from the form's
#: own dgates of the step before, rounded to bf16).  A recurrence feeds
#: each one-ulp flip of its bf16 h carry into every later step, so a whole
#: sequence lies a drift from its twin's, not a rounding; one step from its
#: own carries lies one rounding from the float64 step.  Forward: hs
#: unequal to the float64 step rounded once on at most BF16_ULP_SHARE of
#: the elements, each within one ulp plus sqrt(K) 2^-24 of its sum of
#: |terms| (K: the product's depth; the cell's sensitivity folded into the
#: sum, ``lstm_bf16_forced_fwd``); cs per element within F32_CELL_REL of
#: |c| + 1 plus the same sum term.  Backward: each computed step's dgates
#: within LSTM_BF16_STEP_RTOL of the float64 step (relative norm; the
#: gates a remat recomputes may round the other way at a rare element),
#: dc0 the same; dh0 on the rows the boot step updates and dpeep within
#: LSTM_BF16_SUM_RTOL of the float64 product and sums of the form's own
#: dgates (an f32 sum's error; an unrounded dgates moves dh0 by ~2^-9).
#: End to end, the form's relative distance from the float64 run within
#: LSTM_BF16_E2E times the twin's plus LSTM_BF16_E2E_FLOOR.
LSTM_BF16_STEP_RTOL = 1e-3
LSTM_BF16_SUM_RTOL = 1e-5
F32_CELL_REL = 2.0 ** -20
LSTM_BF16_E2E = 2.0
LSTM_BF16_E2E_FLOOR = 2.0 ** -8
#: the bf16 witness steps of phase 15: the text classifier and the CRNN
#: at a cut width (their gradient leaves and the loss of one bf16 step,
#: against the float64 step on the CPU, within 2x the JAX package's own
#: bf16 error at the very same step plus RNN_BF16_FLOOR); the JAX errors
#: are recomputed by ``tests/test_torch_text_crnn_bf16.py``
#: (``PYTHONPATH=.:tests python tests/test_torch_text_crnn_bf16.py``
#: prints them)
TEXT_BF16_NET = {"hidden": 64, "vocab": 1000, "embed": 32}
TEXT_BF16_BATCH = (8, 3, 16)          # rows, shortest and longest length
CRNN_BF16_NET = {"image_height": 16, "image_width": 48, "num_classes": 6,
                 "rnn_size": 8}
CRNN_BF16_BATCH = 8
RNN_BF16_FLOOR = 2.0 ** -8
TEXT_BF16_WITNESS_JAX = {
    '___embedding_0__.w0': 0.004208, '___fc_layer_0__.w0': 0.005431,
    '___fc_layer_0__.wbias': 0.0144, '___fc_layer_1__.w0': 0.007259,
    '___fc_layer_1__.wbias': 0.004127, '___lstmemory_0__.w0': 0.01067,
    '___lstmemory_0__.wbias': 0.01539, 'loss': 6.343e-06}
CRNN_BF16_WITNESS_JAX = {
    '___fc_layer_0__.w0': 0.003214, '___fc_layer_0__.wbias': 0.003404,
    '_crnn_bilstm_bw.w0': 0.01187, '_crnn_bilstm_bw.wbias': 0.006873,
    '_crnn_bilstm_bw_transform.w0': 0.01177,
    '_crnn_bilstm_bw_transform.wbias': 0.007896,
    '_crnn_bilstm_fw.w0': 0.008783, '_crnn_bilstm_fw.wbias': 0.007001,
    '_crnn_bilstm_fw_transform.w0': 0.007248,
    '_crnn_bilstm_fw_transform.wbias': 0.007313,
    '_crnn_conv1_bn.w0': 0.1179, '_crnn_conv1_bn.wbias': 0.1465,
    '_crnn_conv1_conv.w0': 0.09505, '_crnn_conv2_bn.w0': 0.04097,
    '_crnn_conv2_bn.wbias': 0.03528, '_crnn_conv2_conv.w0': 0.07721,
    'loss': 4.852e-05}


def lstm_bf16_forced_fwd(xw, mask, w_h, peep, h0, c0, reverse, hs, cs,
                         proj_mag=None) -> dict:
    """Every step of a bf16 LSTM forward recomputed in float64 from the
    output's own carries: h_{t-1}, c_{t-1} the outputs shifted by one step
    (h0, c0 at the boot index), pre = xw + h_{t-1} W_h, the cell, the
    freeze.  Returns {"h", "c", "gates" [.., 4D], "mag" (per element of h
    and c: the sum over the unit's four gates of |terms| of pre, times
    1 + |c_{t-1}|, which bounds the cell's sensitivity), "mag_g" (per gate
    column)}; ``proj_mag`` adds the |terms| of an in-loop projection."""
    from paddle_tpu_torch.ops.kernels import lstm as LK

    d = w_h.shape[0]
    hp = LK._shift_prev(hs, h0, reverse).double()
    cp = LK._shift_prev(cs, c0.float(), reverse).double()
    w = w_h.double()
    pre = xw.double() + torch.matmul(hp, w)
    mag_g = torch.matmul(hp.abs(), w.abs())
    if proj_mag is not None:
        mag_g = mag_g + proj_mag
    pe = peep.double()
    i = torch.sigmoid(pre[..., :d] + pe[0] * cp)
    f = torch.sigmoid(pre[..., d:2 * d] + pe[1] * cp)
    g = torch.tanh(pre[..., 2 * d:3 * d])
    c = f * cp + i * g
    o = torch.sigmoid(pre[..., 3 * d:] + pe[2] * c)
    m = mask.double()[..., None]
    h = m * o * torch.tanh(c) + (1 - m) * hp
    c = m * c + (1 - m) * cp
    mag = mag_g.reshape(*mag_g.shape[:-1], 4, d).sum(-2) * (1 + cp.abs())
    return {"h": h, "c": c, "gates": torch.cat([i, f, g, o], -1),
            "mag": mag, "mag_g": mag_g}


def lstm_bf16_fwd_agreement(hs, cs, forced, kred: int, gates=None) -> dict:
    """A bf16 forward's outputs against :func:`lstm_bf16_forced_fwd` of
    the same outputs (the module's criterion above); "ok" says whether
    they agree."""
    a = bf16_agreement(hs, forced["h"].to(torch.bfloat16), forced["mag"],
                       kred)
    sum_term = kred ** 0.5 * 2.0 ** -24 * forced["mag"]
    gap = (cs.double() - forced["c"]).abs()
    a["c_max_share_of_bound"] = float((gap / (
        F32_CELL_REL * (forced["c"].abs() + 1) + sum_term)).max())
    ok = (a["share_off"] <= BF16_ULP_SHARE and a["max_share_of_bound"] <= 1
          and a["c_max_share_of_bound"] <= 1)
    if gates is not None:
        g = bf16_agreement(gates, forced["gates"].to(torch.bfloat16),
                           forced["mag_g"] + forced["mag"].repeat(
                               *([1] * (hs.dim() - 1)), 4), kred)
        a["gates"] = g
        ok = (ok and g["share_off"] <= BF16_ULP_SHARE
              and g["max_share_of_bound"] <= 1)
    a["ok"] = bool(ok)
    return a


def lstm_bf16_forced_bwd(gates, mask, w_h, peep, h0, c0, hs, cs, dhs, dhT,
                         dcT, reverse, dgates) -> dict:
    """The backward of a bf16 LSTM recomputed in float64 over ``gates``
    (bf16 [B, T, 4D]), step by step in the backward's order, with each
    step's dh carry rebuilt from the form's own ``dgates`` of the step
    before, rounded to bf16, times W_h^T; the dc carry by the twin's
    recursion.  Returns {"dgates", "dh0", "dc0"} and "dpeep", the sums of
    the form's own dgates against c_{t-1} (i, f) and c_t (o)."""
    from paddle_tpu_torch.ops.kernels import lstm as LK

    t, d = hs.shape[1], w_h.shape[0]
    w = w_h.double()
    carry = torch.matmul(dgates.to(torch.bfloat16).double(), w.t())
    pe = peep.double()
    cp_all = LK._shift_prev(cs, c0.float(), reverse).double()
    dh, dc = dhT.double(), dcT.double()
    out = torch.empty(dgates.shape, dtype=torch.float64,
                      device=dgates.device)
    for k in LK._steps(t, not reverse):
        m = mask[:, k, None].double()
        dh = dh + dhs[:, k].double()
        cp, c = cp_all[:, k], cs[:, k].double()
        i, f, g, o = gates[:, k].double().split(d, dim=-1)
        tc = torch.tanh(c)
        do = dh * tc * o * (1 - o) * m
        dct = (dc + dh * o * (1 - tc * tc)) * m + do * pe[2]
        di = dct * g * i * (1 - i)
        df = dct * cp * f * (1 - f)
        out[:, k] = torch.cat([di, df, dct * i * (1 - g * g), do], -1)
        dh = carry[:, k] + (1 - m) * dh
        dc = dct * f + di * pe[0] + df * pe[1] + (1 - m) * dc
    dg = dgates.double()
    dpeep = torch.stack([(dg[..., :d] * cp_all).sum((0, 1)),
                         (dg[..., d:2 * d] * cp_all).sum((0, 1)),
                         (dg[..., 3 * d:] * cs.double()).sum((0, 1))])
    return {"dgates": out, "dh0": dh, "dc0": dc, "dpeep": dpeep}


def lstm_bf16_bwd_agreement(got, forced, mask, reverse) -> dict:
    """A bf16 backward's (dgates, dh0, dc0, dpeep) against
    :func:`lstm_bf16_forced_bwd` of its own dgates (the module's
    criterion above); "ok" says whether they agree."""
    dgates, dh0, dc0, dpeep = got
    boot = mask.shape[1] - 1 if reverse else 0
    rows = mask[:, boot] > 0
    steps = [rel_norm(dgates[:, k], forced["dgates"][:, k])
             for k in range(dgates.shape[1])
             if forced["dgates"][:, k].abs().max() > 0]
    a = {"dgates_step_worst": max(steps),
         "dc0": rel_norm(dc0, forced["dc0"]),
         "dh0_boot_rows": rel_norm(dh0[rows], forced["dh0"][rows]),
         "dpeep": rel_norm(dpeep, forced["dpeep"]),
         "max_abs_err": float((dgates.double() - forced["dgates"])
                              .abs().max())}
    a["ok"] = bool(a["dgates_step_worst"] <= LSTM_BF16_STEP_RTOL
                   and a["dc0"] <= LSTM_BF16_STEP_RTOL
                   and a["dh0_boot_rows"] <= LSTM_BF16_SUM_RTOL
                   and a["dpeep"] <= LSTM_BF16_SUM_RTOL)
    return a


#: the bf16 LSTM backward's planted kernel fault (csrc/lstm_seq.cu): the
#: dh product's second pass leaves the part of each group's second block
#: out of the sum, so dh_{t-1} misses an eighth of the rounded dgates' k
LSTM_BF16_FAULTS = {"part_left_out": [(
    "    for (int j = 1; j < sp.P; ++j) {",
    "    for (int j = 2; j < sp.P; ++j) {")]}


def halves_swapped(run):
    """``run()`` with the twin's cell taking the (g, o) pre-activations
    for (i, f) and the reverse: the planted fault of the bf16 forms'
    gate gather (the accumulator halves of a unit's two lanes swapped)."""
    from paddle_tpu_torch.ops.kernels import lstm as LK

    plain = LK._cell

    def swapped(x_t, h, c, w_a, peep):
        d = h.shape[-1]
        pre = x_t.to(w_a.dtype) + torch.matmul(h.to(w_a.dtype), w_a)
        pre = torch.cat([pre[:, 2 * d:], pre[:, :2 * d]], -1)
        return plain(pre, torch.zeros_like(h), c, torch.zeros_like(w_a),
                     peep)

    LK._cell = swapped
    try:
        return run()
    finally:
        LK._cell = plain


def dgates_unrounded(run):
    """``run()`` with the twin's dh_{t-1} taking dgates unrounded (the
    planted fault: JAX rounds them to bf16 first, ``lstm.py:196``)."""
    from paddle_tpu_torch.ops.kernels import lstm as LK

    plain = LK._rounded
    LK._rounded = lambda x, dtype: x
    try:
        return run()
    finally:
        LK._rounded = plain


def projection_rounded(run):
    """``run()`` with the BiLSTM twin's projection rounded to bf16 (the
    planted fault: JAX keeps it f32, ``lstm.py:833-835``)."""
    from paddle_tpu_torch.ops.kernels import lstm as LK

    plain = LK._project_xw
    LK._project_xw = lambda *a: plain(*a).to(torch.bfloat16).float()
    try:
        return run()
    finally:
        LK._project_xw = plain


def rnn_bf16_counters() -> dict:
    """{name: Kernel} of every form the text and CRNN steps may launch."""
    from paddle_tpu_torch.ops.kernels import brgemm as BR
    from paddle_tpu_torch.ops.kernels import channel_stats as CS
    from paddle_tpu_torch.ops.kernels import conv as CV
    from paddle_tpu_torch.ops.kernels import ctc as KC
    from paddle_tpu_torch.ops.kernels import embedding as EK
    from paddle_tpu_torch.ops.kernels import lstm as LK

    return {"lstm_fwd": LK.KERNEL_FWD, "lstm_bwd": LK.KERNEL_BWD,
            "lstm_bwd_stored": LK.KERNEL_BWD_STORED,
            "lstm_fwd_bf16": LK.KERNEL_FWD_BF16,
            "lstm_bwd_bf16": LK.KERNEL_BWD_BF16,
            "lstm_bwd_stored_bf16": LK.KERNEL_BWD_STORED_BF16,
            "bilstm": LK.KERNEL_BI,
            "bilstm_bf16": LK.KERNEL_BI_BF16, "gather": EK.KERNEL_GATHER,
            "gather_bf16": EK.KERNEL_GATHER_BF16,
            "scatter_add": EK.KERNEL_SCATTER, "ctc": KC.KERNEL_LOSS,
            "conv2d_direct": CV.KERNEL, "conv2d_direct_bf16": CV.KERNEL_BF16,
            "conv2d_direct_wgmma": CV.KERNEL_WGMMA,
            "brgemm": BR.KERNEL, "brgemm_bf16": BR.KERNEL_BF16,
            "brgemm_wgmma": BR.KERNEL_WGMMA,
            "channel_stats": CS.KERNEL, "channel_stats_bf16": CS.KERNEL_BF16}


def bf16_lstm_inputs(dev, gen, b, t, d, lengths):
    """bf16 xw, W_h, peepholes, h0 and dhs, f32 c0, mask and final
    cotangents of an LSTM at [B, T, D] with the given lengths."""
    bf = torch.bfloat16
    mask = (torch.arange(t, device=dev)[None, :]
            < lengths.to(dev)[:, None]).float()

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device=dev)).to(bf)

    return dict(xw=rnd(b, t, 4 * d, scale=0.5), mask=mask,
                w_h=rnd(d, 4 * d, scale=d ** -0.5), peep=rnd(3, d, scale=0.1),
                h0=rnd(b, d, scale=0.5),
                c0=0.5 * torch.randn(b, d, generator=gen, device=dev),
                dhs=rnd(b, t, d),
                dhT=torch.randn(b, d, generator=gen, device=dev),
                dcT=torch.randn(b, d, generator=gen, device=dev))


def lstm_bf16_case(x, reverse, xw=None) -> dict:
    """The bf16 forward and backward forms on one problem against their
    forced float64 steps, with their planted faults and reruns: {"fwd",
    "bwd" (agreements), "faults" (the same of each fault's twin outputs),
    "bits" (the rerun, stored vs remat, the gates form's hs), "args"}.
    ``xw`` (f32) replaces x["xw"] in the backward's remat (the BiLSTM's
    projection); the forward then is not the path's and is not run."""
    from paddle_tpu_torch.ops.kernels import lstm as LK

    m, w, p, h0, c0 = x["mask"], x["w_h"], x["peep"], x["h0"], x["c0"]
    d = w.shape[0]
    out = {"bits": {}, "faults": {}}
    if xw is None:
        xw = x["xw"]
        hs, cs, _, h_t, c_t = LK._fwd_kernel(xw, m, w, p, h0, c0, reverse,
                                             False)
        again = LK._fwd_kernel(xw, m, w, p, h0, c0, reverse, False)
        hs_g, cs_g, gates, _, _ = LK._fwd_kernel(xw, m, w, p, h0, c0,
                                                 reverse, True)
        out["bits"]["fwd_rerun"] = all(torch.equal(a, b) for a, b in zip(
            (hs, cs, h_t, c_t), (again[0], again[1], again[3], again[4])))
        out["bits"]["fwd_gates_form"] = (torch.equal(hs, hs_g)
                                         and torch.equal(cs, cs_g))
        forced = lstm_bf16_forced_fwd(xw, m, w, p, h0, c0, reverse, hs, cs)
        a = lstm_bf16_fwd_agreement(hs, cs, forced, d, gates)
        last = 0 if reverse else xw.shape[1] - 1
        a["h_T"] = rel_norm(h_t, forced["h"][:, last])
        a["c_T"] = rel_norm(c_t, forced["c"][:, last])
        a["ok"] = a["ok"] and max(a["h_T"], a["c_T"]) <= LSTM_BF16_SUM_RTOL
        out["fwd"] = a
        del forced, again
        bad = halves_swapped(lambda: LK._fwd_plain(xw, m, w, p, h0, c0,
                                                   reverse, False))
        out["faults"]["halves_swapped"] = lstm_bf16_fwd_agreement(
            bad[0], bad[1], lstm_bf16_forced_fwd(
                xw, m, w, p, h0, c0, reverse, bad[0], bad[1]), d)
        del bad
    else:
        hs, cs = x["hs"], x["cs"]
        forced = lstm_bf16_forced_fwd(xw, m, w, p, h0, c0, reverse, hs, cs)
        gates = forced["gates"].to(torch.bfloat16)
        del forced
    args = (m, w, p, h0, c0, hs, cs, x["dhs"], x["dhT"], x["dcT"], reverse)
    remat = LK._bwd_kernel(xw, None, *args, True)
    again = LK._bwd_kernel(xw, None, *args, True)
    out["bits"]["bwd_rerun"] = all(torch.equal(a, b)
                                   for a, b in zip(remat, again))
    if xw.dtype == torch.bfloat16:
        stored = LK._bwd_kernel(None, gates, *args, False)
        out["bits"]["bwd_remat_vs_stored"] = all(
            torch.equal(a, b) for a, b in zip(remat, stored))
        del stored
    out["bwd"] = lstm_bf16_bwd_agreement(
        remat, lstm_bf16_forced_bwd(gates, *args[:-1], reverse, remat[0]),
        m, reverse)
    bad = dgates_unrounded(lambda: LK._bwd_plain(None, gates, *args, False))
    out["faults"]["dgates_unrounded"] = lstm_bf16_bwd_agreement(
        bad, lstm_bf16_forced_bwd(gates, *args[:-1], reverse, bad[0]), m,
        reverse)
    out["args"] = (xw, gates) + args
    out["hs"], out["remat"] = hs, remat
    return out


def bf16_kernel_fault(case_args, fn) -> dict:
    """The bf16 remat backward on ``lstm_bf16_case``'s arguments with the
    planted library entry ``fn`` in place of the kernel's, against the
    forced float64 steps of its own dgates (the fault must fail them)."""
    from paddle_tpu_torch.ops.kernels import lstm as LK

    xw, gates, *args = case_args
    kern = LK.KERNEL_BWD_BF16
    saved, kern._fn = kern._fn, fn
    try:
        bad = LK._bwd_kernel(xw, None, *args, True)
    finally:
        kern._fn = saved
    return lstm_bf16_bwd_agreement(
        bad, lstm_bf16_forced_bwd(gates, *args[:-1], args[-1], bad[0]),
        args[0], args[-1])


def lstm_bf16_e2e(x, reverse, hs, dgates) -> dict:
    """End to end: the form's hs and dgates, and the bf16 twin's, each
    against the float64 run of the same inputs (relative norm); the
    form's within LSTM_BF16_E2E x the twin's plus LSTM_BF16_E2E_FLOOR."""
    from paddle_tpu_torch.ops.kernels import lstm as LK

    keys = ("xw", "mask", "w_h", "peep", "h0", "c0")
    ins = [x[k] for k in keys]
    wide = [v.double() for v in ins]
    twin = LK._fwd_plain(*ins, reverse, False)
    ref = LK._fwd_plain(*wide, reverse, False)
    cts = (x["dhs"], x["dhT"], x["dcT"])
    tb = LK._bwd_plain(ins[0], None, *ins[1:], twin[0], twin[1], *cts,
                       reverse, True)[0]
    rb = LK._bwd_plain(wide[0], None, *wide[1:], ref[0], ref[1],
                       *(c.double() for c in cts), reverse, True)[0]
    out = {"hs": rel_norm(hs, ref[0]), "hs_twin": rel_norm(twin[0], ref[0]),
           "dgates": rel_norm(dgates, rb), "dgates_twin": rel_norm(tb, rb)}
    out["ok"] = bool(all(out[k] <= LSTM_BF16_E2E * out[k + "_twin"]
                         + LSTM_BF16_E2E_FLOOR for k in ("hs", "dgates")))
    return out


def bilstm_bf16_case(xs, mask, fw, bw, gen) -> dict:
    """The bf16 BiLSTM forward on one problem and, per direction, the LSTM
    backward form over its f32 projection, as the BiLSTM's backward runs
    it: each against its forced float64 steps (the projection's |terms|
    in the sum, K = E + D), reruns in the same bits, and the planted
    faults (the projection rounded, the gate halves swapped; dgates
    unrounded in dh_{t-1}).  {"bilstm", "bwd" (by direction),
    "bilstm_faults", "bwd_faults", "bits", "ok", "crnn_args" (the forward
    direction's backward arguments)}."""
    from paddle_tpu_torch.ops.kernels import lstm as LK

    bf = torch.bfloat16
    b, t, e = xs.shape
    d = fw[2].shape[0]
    outs = LK._bi_fwd_kernel(xs, mask, fw, bw)
    again = LK._bi_fwd_kernel(xs, mask, fw, bw)
    out = {"bilstm": {}, "bwd": {}, "bilstm_faults": {}, "bwd_faults": {},
           "bits": {"bilstm_rerun": all(
               torch.equal(u, v) for o1, o2 in zip(outs, again)
               for u, v in zip(o1, o2))}}
    del again
    for key, weights, (hs, cs, h_t, c_t), reverse in (
            ("forward", fw, outs[0], False), ("reverse", bw, outs[1], True)):
        w_x, bias, w_h, peep, h0, c0 = weights
        proj = torch.matmul(xs.double().abs(), w_x.double().abs())
        xw64 = torch.matmul(xs.double(), w_x.double()) + bias.double()
        forced = lstm_bf16_forced_fwd(xw64, mask, w_h, peep, h0, c0, reverse,
                                      hs, cs, proj)
        a = lstm_bf16_fwd_agreement(hs, cs, forced, e + d)
        last = 0 if reverse else t - 1
        a["h_T"] = rel_norm(h_t, forced["h"][:, last])
        a["c_T"] = rel_norm(c_t, forced["c"][:, last])
        a["ok"] = a["ok"] and max(a["h_T"], a["c_T"]) <= LSTM_BF16_SUM_RTOL
        out["bilstm"][key] = a
        del forced
        for fault, wrap in (("projection_rounded", projection_rounded),
                            ("halves_swapped", halves_swapped)):
            bad = wrap(lambda: LK._bi_fwd_plain(xs, mask, fw, bw))[
                1 if reverse else 0]
            out["bilstm_faults"][f"{key}_{fault}"] = lstm_bf16_fwd_agreement(
                bad[0], bad[1], lstm_bf16_forced_fwd(
                    xw64, mask, w_h, peep, h0, c0, reverse, bad[0], bad[1],
                    proj), e + d)
        cx = {"mask": mask, "w_h": w_h, "peep": peep, "h0": h0, "c0": c0,
              "hs": hs, "cs": cs,
              "dhs": torch.randn(b, t, d, generator=gen,
                                 device=xs.device).to(bf),
              "dhT": torch.zeros(b, d, device=xs.device),
              "dcT": torch.zeros(b, d, device=xs.device)}
        case = lstm_bf16_case(cx, reverse, LK._project_xw(xs, w_x, bias))
        out["bits"][f"bwd_{key}_rerun"] = case["bits"]["bwd_rerun"]
        out["bwd"][key] = case["bwd"]
        out["bwd_faults"][key] = case["faults"]["dgates_unrounded"]
        if key == "forward":
            out["crnn_args"] = case["args"]
        del case, xw64, proj
    out["ok"] = bool(all(a["ok"] for a in out["bilstm"].values())
                     and all(a["ok"] for a in out["bwd"].values()))
    return out


def lstm_bf16_bytes_flops(kind: str, b: int, t: int, d: int,
                          steps: float) -> tuple[float, float]:
    """(bytes, operations) of the bf16 LSTM text form ``kind`` at [B, T,
    D] with ``steps`` valid (row, step) pairs: the forward ("fwd") reads
    xw, W_h, peep, h0 in bf16 and c0, mask in f32 and writes hs in bf16,
    cs, h_T, c_T in f32 ("fwd_slab": and the gates slab in bf16); the
    backward ("bwd", remat) reads xw, W_h, peep, h0, hs, dhs in bf16 and
    mask, c0, cs, dh_T, dc_T in f32 and writes dgates, dh0, dc0, dpeep in
    f32, the remat product and dgates W_h^T beside the cells; the
    stored-gates backward ("stored") reads the bf16 slab for xw and does
    dgates W_h^T and the cell's backward alone."""
    cell = 25.0 * steps * d
    if kind in ("fwd", "fwd_slab"):
        return (2 * (b * t * 4 * d + d * 4 * d + 3 * d + b * d)
                + 4 * (b * d + b * t) + 2 * b * t * d
                + 4 * (b * t * d + 2 * b * d)
                + (2 * b * t * 4 * d if kind == "fwd_slab" else 0),
                2.0 * steps * d * 4 * d + cell)
    return (2 * (b * t * 4 * d + d * 4 * d + 3 * d + b * d + 2 * b * t * d)
            + 4 * (b * t + b * t * d + 3 * b * d)
            + 4 * (b * t * 4 * d + 2 * b * d + 3 * d),
            (4.0 * steps * d * 4 * d + 2 * cell if kind == "bwd"
             else 2.0 * steps * d * 4 * d + cell))


def check_rnn_bf16_kernels(dev, timer, text=(64, 128, 1280, 100, 128),
                           crnn=(64, 24, 256, 64),
                           ids=(8192, 30000)) -> tuple[list, dict]:
    """The bf16 forms of rows 5, 7 and 17 at their paths' shapes: the LSTM
    forward and backward at the text classifier's B 64, T 128 (lengths
    100), D 1280; the backward with the BiLSTM's f32 projection at the
    CRNN's [64, 24, 256], D 64, both directions; the BiLSTM forward there;
    the gather of 8,192 ids from [30000, 128].  Each against its forced
    float64 steps (the criterion above; the gather bit for bit against
    its twin), reruns in the same bits, the backward's remat and stored
    forms in the same bits, and each planted fault must fail: the gate
    halves swapped, dgates unrounded in dh_{t-1}, the BiLSTM's projection
    rounded.  Times (bf16, 2 B an element, 989 TFLOP/s): each form with
    the L2 flushed, alone (a trace), its bf16 twin, its bound, and bf16
    cuDNN ``nn.LSTM`` (no peepholes, the input projection included: not
    the same cell) or bf16 ``F.embedding``."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import embedding as EK
    from paddle_tpu_torch.ops.kernels import lstm as LK

    bf = torch.bfloat16
    gather_fault = source_fault_builds("embedding", GATHER_FAULTS)
    gen = torch.Generator(device=dev).manual_seed(15)
    summary = {"phase": "rnn_bf16_kernels",
               "criterion": "forced float64 steps (chip_smoke.py)",
               "step_rtol": LSTM_BF16_STEP_RTOL,
               "sum_rtol": LSTM_BF16_SUM_RTOL}
    rows = []

    def must(ok, what, detail):
        if not ok:
            raise AssertionError(f"bf16 rnn forms, {what}: {detail}")

    # (a) the text path: lstmemory at B 64, T 128, lengths 100, D 1280
    bwd_fault = source_fault_builds("lstm_seq", LSTM_BF16_FAULTS,
                                    prefix="bf16_")
    b, t, d, length, embed = text
    x = bf16_lstm_inputs(dev, gen, b, t, d, torch.full((b,), length))
    x["h0"] = torch.zeros_like(x["h0"])
    x["c0"] = torch.zeros_like(x["c0"])
    case = lstm_bf16_case(x, False)
    case["faults"]["part_left_out"] = bf16_kernel_fault(
        case["args"], planted(*bwd_fault["part_left_out"],
                              LK.KERNEL_BWD_BF16))
    must(all(case["bits"].values()), "text bits", case["bits"])
    must(case["fwd"]["ok"] and case["bwd"]["ok"], "text vs forced steps",
         {k: case[k] for k in ("fwd", "bwd")})
    must(not any(f["ok"] for f in case["faults"].values()),
         "a text fault passed", case["faults"])
    e2e = lstm_bf16_e2e(x, False, case["hs"], case["remat"][0])
    must(e2e["ok"], "text end to end", e2e)
    summary["text"] = {k: case[k] for k in ("fwd", "bwd", "faults", "bits")}
    summary["text"]["end_to_end"] = e2e
    xw, gates, *args = case["args"]
    del case
    m, w, p, h0, c0, hs, cs = args[:7]
    # the path's forms: the forward writing its gates slab and the
    # stored-gates backward over it (the slab fits); the forward without
    # the slab and the remat backward timed beside
    fwd_args = (xw, m, w, p, h0, c0, False, True)
    fwd = lambda: LK._fwd_kernel(*fwd_args)                  # noqa: E731
    no_slab = lambda: LK._fwd_kernel(*fwd_args[:-1], False)  # noqa: E731
    bwd = lambda: LK._bwd_kernel(None, gates, *args, False)  # noqa: E731
    remat = lambda: LK._bwd_kernel(xw, None, *args, True)    # noqa: E731
    fwd_plain = lambda: LK._fwd_plain(*fwd_args)             # noqa: E731
    bwd_plain = lambda: LK._bwd_plain(None, gates, *args, False)  # noqa: E731
    x_emb = torch.randn(b, t, embed, generator=gen, device=dev).to(bf)
    cudnn = torch.nn.LSTM(embed, d, batch_first=True).to(dev, bf)
    cudnn.flatten_parameters()    # one weight buffer, as cuDNN wants it
    x_lib = x_emb.clone().requires_grad_()
    out_lib, _ = cudnn(x_lib)
    g_lib = torch.randn_like(out_lib)
    lib_params = (x_lib, *cudnn.parameters())

    def lib_fwd():
        with torch.no_grad():
            return cudnn(x_emb)

    steps = float(m.sum().item())
    rows += [{
        "name": "lstm_seq_fwd_bf16", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/lstm_seq.cu",
        "replaces": "paddle_tpu/ops/pallas/lstm.py:252",
        "shape": [b, t, d], "dtype": "bfloat16",
        "max_abs_err": summary["text"]["fwd"]["max_abs_err"],
        "ms": timer(fwd), "alone_ms": device_ms([fwd], "lstm_fwd_bf16"),
        "no_slab_ms": timer(no_slab),
        "no_slab_alone_ms": device_ms([no_slab], "lstm_fwd_bf16"),
        "plain_ms": timer(fwd_plain),
        # xw, W_h, peep, h0 bf16 and c0, mask f32 in; hs, the gates slab
        # bf16, cs, h_T, c_T f32 out
        "bytes_flops": lstm_bf16_bytes_flops("fwd_slab", b, t, d, steps),
        "library_ms": timer(lib_fwd)}, {
        "name": "lstm_seq_bwd_stored_bf16", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/lstm_seq.cu",
        "replaces": "paddle_tpu/ops/pallas/lstm.py:310",
        "shape": [b, t, d], "dtype": "bfloat16",
        "max_abs_err": summary["text"]["bwd"]["max_abs_err"],
        "ms": timer(bwd), "alone_ms": device_ms([bwd], "lstm_bwd_bf16"),
        "plain_ms": timer(bwd_plain),
        "bytes_flops": lstm_bf16_bytes_flops("stored", b, t, d, steps),
        # the remat form over xw (the same bits, checked in the case
        # above), off the text path since the slab fits
        "remat_ms": timer(remat),
        "remat_alone_ms": device_ms([remat], "lstm_bwd_bf16"),
        "remat_bound_ms": bound(*lstm_bf16_bytes_flops(
            "bwd", b, t, d, steps), BF16_FLOPS_PER_S)[0],
        "library_ms": timer(lambda: torch.autograd.grad(
            out_lib, lib_params, g_lib, retain_graph=True))}]
    summary["text_forms_ms"] = {
        "fwd": {k: rows[0][k] for k in ("ms", "alone_ms", "no_slab_ms",
                                        "no_slab_alone_ms")},
        "bwd_stored": {k: rows[1][k] for k in ("ms", "alone_ms", "remat_ms",
                                               "remat_alone_ms")}}
    print(json.dumps({"lstm_bf16_text_forms": summary["text_forms_ms"]}),
          flush=True)
    del x, xw, gates, args, fwd_args, hs, cs, out_lib, g_lib, lib_params
    del x_lib, cudnn, x_emb, m, w, p, h0, c0

    # (b) the CRNN: the BiLSTM forward at x [64, 24, 256], D 64, and the
    # LSTM backward over its f32 projection, both directions
    b, t, e, d = crnn
    xs = torch.randn(b, t, e, generator=gen, device=dev).to(bf)
    mask = torch.ones(b, t, device=dev)

    def direction():
        return (
            (torch.randn(e, 4 * d, generator=gen, device=dev) / e ** 0.5
             ).to(bf),
            0.1 * torch.randn(4 * d, generator=gen, device=dev),
            (torch.randn(d, 4 * d, generator=gen, device=dev) / d ** 0.5
             ).to(bf),
            (0.1 * torch.randn(3, d, generator=gen, device=dev)).to(bf),
            torch.zeros(b, d, device=dev, dtype=bf),
            torch.zeros(b, d, device=dev))

    fw, bw = direction(), direction()
    bi = lambda: LK._bi_fwd_kernel(xs, mask, fw, bw)    # noqa: E731
    case = bilstm_bf16_case(xs, mask, fw, bw, gen)
    must(all(case["bits"].values()), "CRNN reruns", case["bits"])
    must(case["ok"], "CRNN vs forced", case)
    must(not any(f["ok"] for f in case["bilstm_faults"].values())
         and not any(f["ok"] for f in case["bwd_faults"].values()),
         "a CRNN fault passed", case)
    crnn_args = case.pop("crnn_args")
    summary["crnn"] = case
    bi_agree, bwd_agree = case["bilstm"], case["bwd"]
    xw_c, _, *cargs = crnn_args
    cbwd = lambda: LK._bwd_kernel(xw_c, None, *cargs, True)       # noqa: E731
    cbwd_plain = lambda: LK._bwd_plain(xw_c, None, *cargs, True)  # noqa: E731
    lib1 = torch.nn.LSTM(e, d, batch_first=True).to(dev, bf)
    lib2 = torch.nn.LSTM(e, d, batch_first=True,
                         bidirectional=True).to(dev, bf)
    lib1.flatten_parameters()
    lib2.flatten_parameters()
    x_lib = xs.clone().requires_grad_()
    out_lib, _ = lib1(x_lib)
    g_lib = torch.randn_like(out_lib)
    lib_params = (x_lib, *lib1.parameters())

    def lib_bi():
        with torch.no_grad():
            return lib2(xs)

    steps = float(mask.sum().item())
    cell = 25.0 * steps * d
    rows += [{
        "name": "lstm_seq_bwd_bf16_crnn", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/lstm_seq.cu",
        "replaces": "paddle_tpu/ops/pallas/lstm.py:445",
        "shape": [b, t, 4 * d, d], "dtype": "bfloat16 (xw f32)",
        "max_abs_err": max(a["max_abs_err"] for a in bwd_agree.values()),
        "ms": timer(cbwd), "alone_ms": device_ms([cbwd], "lstm_bwd_bf16"),
        "plain_ms": timer(cbwd_plain),
        # xw, dgates f32; the rest as the text row's
        "bytes_flops": (4 * b * t * 4 * d + 2 * (d * 4 * d + 3 * d + b * d
                                                 + 2 * b * t * d)
                        + 4 * (b * t + b * t * d + 3 * b * d)
                        + 4 * (b * t * 4 * d + 2 * b * d + 3 * d),
                        4.0 * steps * d * 4 * d + 2 * cell),
        "library_ms": timer(lambda: torch.autograd.grad(
            out_lib, lib_params, g_lib, retain_graph=True))}, {
        "name": "bilstm_seq_fwd_bf16", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/bilstm_seq.cu",
        "replaces": "paddle_tpu/ops/pallas/lstm.py:891",
        "shape": [b, t, e, d], "dtype": "bfloat16",
        "max_abs_err": max(a["max_abs_err"] for a in bi_agree.values()),
        "ms": timer(bi), "alone_ms": device_ms([bi], "bilstm_fwd_bf16"),
        "plain_ms": timer(lambda: LK._bi_fwd_plain(xs, mask, fw, bw)),
        # x, both directions' W_x, W_h, peep, h0 bf16 and b, c0, mask f32
        # in; hs bf16, cs, h_T, c_T f32 out
        "bytes_flops": (2 * (b * t * e + 2 * (e * 4 * d + d * 4 * d + 3 * d
                                              + b * d))
                        + 4 * (b * t + 2 * (4 * d + b * d))
                        + 2 * (2 * b * t * d + 4 * (b * t * d + 2 * b * d)),
                        2 * (2.0 * steps * (e + d) * 4 * d + cell)),
        "library_ms": timer(lib_bi)}]
    del crnn_args, cargs, xw_c, out_lib, g_lib, lib_params, x_lib, lib1, lib2

    # (c) the gather: 8,192 ids (the bench's batch) from [30000, 128]
    n_ids, vocab = ids
    ids = torch.randint(0, vocab, (n_ids,), generator=gen, device=dev)
    table = torch.randn(vocab, embed, generator=gen, device=dev).to(bf)
    got = EK.embedding_gather(table, ids)
    torch.cuda.synchronize()
    must(torch.equal(got, EK.embedding_gather_reference(table, ids))
         and torch.equal(got, EK.embedding_gather(table, ids)),
         "gather", "differs from its twin or its rerun")
    gathered = gather_checks(table, ids, gather_fault["padding_not_zeroed"])
    uniq = float(torch.unique(ids).numel())
    gather = lambda: EK.embedding_gather(table, ids)   # noqa: E731
    rows.append({
        "name": "embedding_gather_bf16", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/embedding.cu",
        "replaces": "paddle_tpu/ops/pallas/tpp/embedding.py:146",
        "shape": [n_ids, vocab, embed], "dtype": "bfloat16",
        "unique_ids": int(uniq), "max_abs_err": 0.0,
        "ms": timer(gather), "alone_ms": gathered["alone_ms"],
        "host_ms": gathered["host_ms"],
        "plain_ms": timer(lambda: EK.embedding_gather_reference(table, ids)),
        "bytes_flops": (2.0 * (uniq + n_ids) * embed + 8.0 * n_ids, 0.0),
        "library_ms": timer(lambda: F.embedding(ids, table))})
    summary["gather_bit_identical_to_twin"] = True
    summary["gather"] = gathered["summary"]
    summary["lookup_forward"] = {**gathered["lookup"],
                                 "ms": timer(gathered["lookup_fn"])}
    for row in rows:
        row["bound_ms"], row["bound_by"] = bound(*row.pop("bytes_flops"),
                                                 BF16_FLOPS_PER_S)
    torch.cuda.synchronize()
    return rows, summary


def text_bf16_setup():
    """The text classifier's bf16 witness step (``TEXT_BF16_NET``): (topology,
    cost name, f32 parameters as numpy, the input types, one seeded batch
    of ``TEXT_BF16_BATCH`` ragged sequences).  Parameters from
    ``parameters.create`` (seeded), the LSTM's biases and peepholes made
    nonzero so every term of the cell counts."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.config.topology import Topology
    from paddle_tpu_torch.layers.base import reset_name_counters

    reset_name_counters()
    cost = text_classifier(**TEXT_BF16_NET)
    topo = Topology(cost)
    created = paddle.parameters.create(cost)
    rng = np.random.default_rng(0)
    params = {n: np.array(created[n]) for n in created.names()}
    for n in params:
        if n.endswith(".wbias"):
            params[n] = (0.1 * rng.standard_normal(params[n].shape)
                         ).astype(np.float32)
    rows, lo, hi = TEXT_BF16_BATCH
    batch = [(rng.integers(0, TEXT_BF16_NET["vocab"],
                           size=int(rng.integers(lo, hi + 1))).tolist(),
              int(rng.integers(0, 2))) for _ in range(rows)]
    return topo, cost.name, params, data_types(paddle, topo), batch


def crnn_bf16_setup():
    """The CRNN's bf16 witness step (``CRNN_BF16_NET``, a batch of
    ``CRNN_BF16_BATCH`` synthetic samples): the contract of
    :func:`text_bf16_setup`, the BiLSTM's biases made nonzero."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.config.topology import Topology
    from paddle_tpu_torch.layers.base import reset_name_counters
    from paddle_tpu_torch.models import ocr_crnn

    reset_name_counters()
    cost, _, _ = ocr_crnn.crnn_ctc_cost(**CRNN_BF16_NET)
    topo = Topology(cost)
    created = paddle.parameters.create(cost)
    rng = np.random.default_rng(0)
    params = {n: np.array(created[n]) for n in created.names()}
    for n in params:
        if n.endswith(".wbias"):
            params[n] = (0.1 * rng.standard_normal(params[n].shape)
                         ).astype(np.float32)
    batch = list(ocr_crnn.synthetic_ocr_reader(
        n_samples=CRNN_BF16_BATCH, image_height=CRNN_BF16_NET["image_height"],
        image_width=CRNN_BF16_NET["image_width"],
        num_classes=CRNN_BF16_NET["num_classes"], max_label_len=3,
        seed=5)())
    return topo, cost.name, params, data_types(paddle, topo), batch


def data_types(paddle, topo) -> dict:
    return {n: paddle.data_type.InputType(
        dim=l.attrs["dim"], seq_type=l.attrs["seq_type"],
        kind=l.attrs["data_type"]) for n, l in topo.data_layers().items()}


def topology_grads(topo, cost_name, params, feed, dtype=None):
    """(loss, {name: gradient}) of one train-mode step's forward and
    backward as the v2 step runs it: with ``dtype`` bf16 the parameters
    and float feeds cast inside the graph (f32 masters get f32
    gradients); a float64 run takes float64 parameters and feeds.  The
    states are the topology's initial ones in the parameters' dtype."""
    from paddle_tpu_torch.core.dtype import at_least_f32, cast_floats

    dev = next(iter(params.values())).device
    leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
    run = cast_floats(leaves, dtype) if dtype is not None else leaves
    wide = next(iter(params.values())).dtype
    states = {k: v.to(wide) for k, v in topo.init_states(dev).items()}
    if dtype is not None:
        feed = cast_floats(feed, dtype)
    elif wide == torch.float64:
        feed = cast_floats(feed, torch.float64)
    values, _ = topo.forward(run, states, feed, True, 0)
    loss = at_least_f32(values[cost_name]).sum()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def rnn_bf16_errors(loss, grads, loss64, g64) -> dict:
    """Per gradient leaf ||g - g64|| / ||g64||, and the loss's relative
    error under "loss"."""
    out = {n: rel_norm(grads[n], g64[n]) for n in g64}
    out["loss"] = abs(float(loss) - float(loss64)) / abs(float(loss64))
    return out


def rnn_bf16_witness(dev) -> dict:
    """The bf16 witness steps of the text classifier and the CRNN at their
    cut widths (:func:`text_bf16_setup`, :func:`crnn_bf16_setup`): the
    bf16 step's loss and gradient leaves on the card (the bf16 forms) and
    on the CPU (the twins), each against the float64 step on the CPU,
    within 2x the JAX package's own bf16 error at the same step
    (``TEXT_BF16_WITNESS_JAX``, ``CRNN_BF16_WITNESS_JAX``) plus
    RNN_BF16_FLOOR; the card's step repeats bit for bit; a card step whose
    dW_h takes h_t for h_{t-1} (the stacks unshifted) must exceed it."""
    from paddle_tpu_torch.ops.kernels import lstm as LK
    from paddle_tpu_torch.reader.feeder import DataFeeder

    bf = torch.bfloat16
    out = {"limit": f"2 x JAX's own + {RNN_BF16_FLOOR}"}
    for name, setup, jax_errs in (
            ("text", text_bf16_setup, TEXT_BF16_WITNESS_JAX),
            ("crnn", crnn_bf16_setup, CRNN_BF16_WITNESS_JAX)):
        topo, cost_name, params, types, batch = setup()

        def side(where, dtype=bf, wide=torch.float32):
            feed = DataFeeder(types, device=where)(batch)
            p = {n: torch.from_numpy(v).to(where, wide)
                 for n, v in params.items()}
            return topology_grads(topo, cost_name, p, feed, dtype)

        loss64, g64 = side("cpu", None, torch.float64)
        counters = rnn_bf16_counters()
        for k in counters.values():
            k.launches = 0
        sides = {"card": side(dev)}
        launches = {n: k.launches for n, k in counters.items() if k.launches}
        rerun = side(dev)
        sides["cpu"] = side("cpu")
        plain_shift = LK._shift_prev
        LK._shift_prev = lambda stack, boot, reverse: stack
        try:
            sides["card_dwh_unshifted_control"] = side(dev)
        finally:
            LK._shift_prev = plain_shift
        if not (torch.equal(rerun[0], sides["card"][0]) and all(
                torch.equal(rerun[1][n], sides["card"][1][n]) for n in g64)):
            raise AssertionError(f"the card's bf16 {name} step is not "
                                 "bit-identical on a rerun")
        row = {"loss_f64": float(loss64), "launches": launches,
               "card_rerun_bit_identical": True}
        for label, (loss, grads) in sides.items():
            errs = rnn_bf16_errors(loss, grads, loss64, g64)
            share = {n: e / (2 * jax_errs[n] + RNN_BF16_FLOOR)
                     for n, e in errs.items()}
            worst = max(share, key=share.get)
            row[label] = {"loss": float(loss), "worst": worst,
                          "err": errs[worst], "jax": jax_errs[worst],
                          "share_of_limit": share[worst],
                          "over_limit": [n for n, x in share.items() if x > 1]}
        for label in ("card", "cpu"):
            if row[label]["over_limit"]:
                raise AssertionError(f"bf16 {name} {label} step vs the f64 "
                                     f"witness: {row}")
        if not row["card_dwh_unshifted_control"]["over_limit"]:
            raise AssertionError(f"the bf16 {name} witness does not catch a "
                                 f"dW_h over unshifted stacks: {row}")
        out[name] = row
    return out


def rnn_rates(blocks: dict, bs: int, unit: str) -> dict:
    out = rates(blocks, bs)
    for d in out:
        out[d][unit] = out[d].pop("images_per_s")
    return out


def train_text_bf16(dev, hidden=1280, vocab=30000, embed=128, bs=64,
                    seqlen=100, steps=10) -> tuple[dict, dict]:
    """The LSTM text classifier at ``bench_lstm``'s configuration through
    ``trainer.SGD(compute_dtype=torch.bfloat16)`` (Adam 2e-3, bf16
    moments) beside f32 from the same parameters: 2 warm-up steps each,
    ``steps`` timed steps each in blocks of ``steps // 2`` (bf16, f32, f32,
    bf16) with exactly one ``lstm_fwd_bf16``, ``lstm_bwd_bf16`` in its
    stored-gates form, ``embedding_gather_bf16`` and (the lookup's backward
    in f32) ``embedding_scatter_add`` launch a bf16 step and no other
    form's (no remat backward);
    sequences/s, step ms, peak memory, the bf16 costs finite, the masters
    f32; a 3-step bf16 profile.  Returns (the phase's result, the bf16
    forms' launches over the timed bf16 steps)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.parameters import Parameters
    from paddle_tpu_torch.layers.base import reset_name_counters

    reset_name_counters()
    cost = text_classifier(hidden, vocab, embed)
    created = paddle.parameters.create(cost)
    carried = {n: created[n] for n in created.names()}
    rng = np.random.default_rng(0)
    for n in carried:
        if n.startswith("___lstmemory") and n.endswith(".wbias"):
            carried[n] = (0.1 * rng.standard_normal(carried[n].shape)
                          ).astype(np.float32)

    def batches(k):
        return [[(rng.integers(0, vocab, size=seqlen).tolist(),
                  int(rng.integers(0, 2))) for _ in range(bs)]
                for _ in range(k)]

    trainers = {d: paddle.trainer.SGD(
        cost=cost, parameters=Parameters.from_numpy(carried),
        update_equation=paddle.optimizer.Adam(
            learning_rate=2e-3, moment_dtype=torch.bfloat16),
        device=dev, compute_dtype=dt)
        for d, dt in (("bf16", torch.bfloat16), ("f32", None))}
    warm = batches(2)
    for tr in trainers.values():
        tr.train(reader=lambda: iter(warm), num_passes=1,
                 event_handler=lambda e: None)
    # the backward in its stored-gates form (the slab fits), no remat
    want = {"bf16": {"lstm_fwd_bf16": 1, "lstm_bwd_stored_bf16": 1,
                     "gather_bf16": 1, "scatter_add": 1},
            "f32": {"lstm_fwd": 1, "lstm_bwd_stored": 1, "gather": 1,
                    "scatter_add": 1}}
    blocks = dtype_blocks(trainers, batches(steps // 2), want,
                          stamp_factory, rnn_bf16_counters())
    out = rnn_rates(blocks, bs, "sequences_per_s")
    if not all(np.isfinite(out[d]["costs"]).all() for d in out):
        raise AssertionError(f"text costs not finite: {out}")
    if not all(v.dtype == np.float32 for v in
               (trainers["bf16"].parameters[n] for n in carried)):
        raise AssertionError("the bf16 text trainer's masters are not f32")
    traced = batches(3)
    prof = profile_window(lambda: trainers["bf16"].train(
        reader=lambda: iter(traced), num_passes=1,
        event_handler=lambda e: None), 3)
    if "device_busy_ms_per_step" in prof:
        prof["idle_share_vs_step_p50"] = (
            1 - prof["device_busy_ms_per_step"] / out["bf16"]["step_ms_p50"])
    launched = {k: sum(b[k] for b in blocks["bf16"]["launches"])
                for k in want["bf16"]}
    del trainers
    return ({"phase": "train_text_bf16", "model": "LSTM text classifier "
             "(bench.py _lstm_classify_cost)", "hidden": hidden,
             "vocab": vocab, "embed": embed, "batch": bs,
             "tokens_per_sequence": seqlen, "compute_dtype": "bfloat16",
             "masters": "float32", "adam_moments": "bfloat16", "lr": 2e-3,
             "steps_per_dtype": steps, **out,
             "bf16_vs_f32_sequences_per_s":
                 out["bf16"]["sequences_per_s"] / out["f32"][
                     "sequences_per_s"],
             "profile_bf16": prof, "bf16_launches": launched}, launched)


def train_crnn_bf16(dev, bs=64, steps=10) -> tuple[dict, dict]:
    """The OCR CRNN at ``bench_crnn``'s configuration through
    ``trainer.SGD(compute_dtype=torch.bfloat16)`` (Adam 1e-3, bf16
    moments) beside f32 from the same parameters, as
    :func:`train_text_bf16`: exactly one ``bilstm_fwd_bf16``, two
    ``lstm_bwd_bf16`` (the BiLSTM's backward over its f32 projection),
    one ``conv2d_direct_bf16`` (conv1, Cin 1), one ``conv2d_direct_wgmma``
    (conv2) and one CTC (f32) launch a bf16 step and no other form's;
    samples/s, step ms, peak memory, finite bf16 costs, f32 masters and
    BN states; a 3-step bf16 profile."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.parameters import Parameters
    from paddle_tpu_torch.layers.base import reset_name_counters
    from paddle_tpu_torch.models import ocr_crnn

    classes = 26
    reset_name_counters()
    cost, _, order = ocr_crnn.crnn_ctc_cost(num_classes=classes, rnn_size=64)
    feeding = {n: i for i, n in enumerate(order)}
    created = paddle.parameters.create(cost)
    carried = {n: created[n] for n in created.names()}
    rng = np.random.default_rng(0)
    trainers = {d: paddle.trainer.SGD(
        cost=cost, parameters=Parameters.from_numpy(carried),
        update_equation=paddle.optimizer.Adam(
            learning_rate=1e-3, moment_dtype=torch.bfloat16),
        device=dev, compute_dtype=dt)
        for d, dt in (("bf16", torch.bfloat16), ("f32", None))}
    warm = crnn_feed_batches(rng, 2, bs, classes)
    for tr in trainers.values():
        tr.train(reader=lambda: iter(warm), num_passes=1,
                 event_handler=lambda e: None, feeding=feeding)
    want = {"bf16": {"bilstm_bf16": 1, "lstm_bwd_bf16": 2,
                     "conv2d_direct_bf16": 1, "conv2d_direct_wgmma": 1,
                     "ctc": 1},
            "f32": {"bilstm": 1, "lstm_bwd": 2, "conv2d_direct": 2,
                    "ctc": 1}}
    blocks = dtype_blocks(trainers, crnn_feed_batches(rng, steps // 2, bs,
                                                      classes), want,
                          stamp_factory, rnn_bf16_counters(), feeding)
    out = rnn_rates(blocks, bs, "samples_per_s")
    if not all(np.isfinite(out[d]["costs"]).all() for d in out):
        raise AssertionError(f"CRNN costs not finite: {out}")
    tr = trainers["bf16"]
    if not (all(tr.parameters[n].dtype == np.float32 for n in carried)
            and all(v.dtype == torch.float32 for v in tr.states.values())):
        raise AssertionError("the bf16 CRNN's masters or BN states are not "
                             "f32")
    traced = crnn_feed_batches(rng, 3, bs, classes)
    prof = profile_window(lambda: tr.train(
        reader=lambda: iter(traced), num_passes=1,
        event_handler=lambda e: None, feeding=feeding), 3)
    if "device_busy_ms_per_step" in prof:
        prof["idle_share_vs_step_p50"] = (
            1 - prof["device_busy_ms_per_step"] / out["bf16"]["step_ms_p50"])
    launched = {k: sum(b[k] for b in blocks["bf16"]["launches"])
                for k in want["bf16"]}
    del trainers, tr
    return ({"phase": "train_crnn_bf16", "model": "OCR CRNN "
             "(models/ocr_crnn.crnn_ctc_cost, bench_crnn)", "batch": bs,
             "classes": classes, "compute_dtype": "bfloat16",
             "masters": "float32", "adam_moments": "bfloat16", "lr": 1e-3,
             "steps_per_dtype": steps, **out,
             "bf16_vs_f32_samples_per_s":
                 out["bf16"]["samples_per_s"] / out["f32"]["samples_per_s"],
             "profile_bf16": prof, "bf16_launches": launched}, launched)


# -- phase 16: the attention NMT in bf16 --------------------------------------

#: The bf16 GRU forms are held step by step, as the LSTM forms are (phase
#: 15): each step of a form's output recomputed in float64 from the
#: output's own carries.  Forward (``gru_bf16_forced_fwd``): h_{t-1} the
#: form's hs shifted by one step, r h_{t-1} rounded to bf16 in the float64
#: step too (a product the f32 step rounds the other way moves an h by
#: less than its ulp); hs and, with the slab, u, r, c unequal to the
#: float64 step rounded once on at most BF16_ULP_SHARE of the elements,
#: each within one ulp plus sqrt(K) 2^-24 of its sum of |terms| (for h:
#: u's sum times |h_{t-1} - c|, plus c's, plus |h_{t-1}| + |c|); h_T
#: within GRU_BF16_STATE_RTOL of the float64 h (relative norm: an r h
#: rounded the other way at the last step moves its row by ~3e-5).
#: Backward (``gru_bf16_forced_bwd``): each computed step's dxw within
#: LSTM_BF16_STEP_RTOL of the float64 step (du and dc from the float64 dh
#: carry, dr from the form's own dc rounded; the carry rebuilt from the
#: form's own dxw rounded to bf16, as the kernel rounds it), dh0 within
#: LSTM_BF16_SUM_RTOL; rh, dW_hc's operand, equal to bf16(bf16(r)
#: h_{t-1}) on all but BF16_ULP_SHARE of the elements, each within two
#: ulps (the product of two bf16 is exact in f32: over the form's own slab
#: it is equal in bits; a recomputed r may round to its neighbour, up to
#: 2^-7 of it, which moves the product by up to two of its ulps).
GRU_BF16_STATE_RTOL = 1e-4
#: the NMT's bf16 witness step at a cut width (vocab 20 / 17, width 16,
#: batch 8; ``nmt_bf16_setup``): its gradient leaves and loss against the
#: float64 step on the CPU, within 2x the JAX package's own bf16 error at
#: the very same step plus RNN_BF16_FLOOR; the JAX errors are recomputed
#: by ``tests/test_torch_nmt_bf16.py`` (``PYTHONPATH=.:tests python
#: tests/test_torch_nmt_bf16.py`` prints them)
NMT_BF16_NET = {"source_dict_dim": 20, "target_dict_dim": 17,
                "word_vector_dim": 16, "encoder_size": 16,
                "decoder_size": 16}
NMT_BF16_BATCH = (8, 1, 12)       # rows, shortest and longest length
NMT_BF16_WITNESS_JAX = {
    '_attention_softmax.w': 0.01243, '_attention_transform.w': 0.1108,
    '_decoder_boot.w': 0.005622, '_decoder_inputs_ctx.w': 0.004889,
    '_decoder_inputs_word.w': 0.00584, '_decoder_prob.bias': 0.00201,
    '_decoder_prob.w': 0.004097, '_encoded_proj.w': 0.0118,
    '_gru_decoder.bias': 0.004642, '_gru_decoder.w': 0.005228,
    '_source_language_embedding': 0.006097, '_src_gru_bw.w0': 0.006235,
    '_src_gru_bw.wbias': 0.005749, '_src_gru_bw_transform.w0': 0.006571,
    '_src_gru_bw_transform.wbias': 0.005749, '_src_gru_fw.w0': 0.006938,
    '_src_gru_fw.wbias': 0.005795, '_src_gru_fw_transform.w0': 0.006317,
    '_src_gru_fw_transform.wbias': 0.005795,
    '_target_language_embedding': 0.004773, 'loss': 7.562e-05}


def gru_bf16_forced_fwd(xw, mask, w_h, w_hc, h0, reverse, hs, kred: int,
                        proj_mag=None) -> dict:
    """Every step of a bf16 GRU forward recomputed in float64 from the
    output's own carries: h_{t-1} the output shifted by one step (h0 at the
    boot index), u, r from xw + h_{t-1} W_h, r h_{t-1} rounded to bf16, c
    from xw + (r h) W_hc, the blend, the freeze.  Returns {"h", "gates"
    ([.., 3D]: u, r, c), "mag" (per element of h), "mag_g" (per gate
    column: the sums of |terms| of its pre-activation)}; ``proj_mag``
    ([.., 3D]) adds the |terms| of an in-loop projection.  A product r
    h_{t-1} that lies nearer a bf16 rounding midpoint than the f32 r's
    error (the sum term of a ``kred``-deep f32 sum, through the sigmoid,
    and 16 f32 ulps of it) may round the other way in the form: the one
    ulp it may move adds |W_hc| times that ulp to c's bound (as a sum of
    |terms| scaled by the criterion's sqrt(kred) 2^-24)."""
    from paddle_tpu_torch.ops.kernels import gru as GK

    d = w_hc.shape[0]
    coef = kred ** 0.5 * 2.0 ** -24
    hp = GK._shift_prev(hs, h0, reverse).double()
    wh, whc, x = w_h.double(), w_hc.double(), xw.double()
    ur = x[..., :2 * d] + torch.matmul(hp, wh)
    u, r = torch.sigmoid(ur[..., :d]), torch.sigmoid(ur[..., d:])
    mag_ur = x[..., :2 * d].abs() + torch.matmul(hp.abs(), wh.abs())
    if proj_mag is not None:
        mag_ur = mag_ur + proj_mag[..., :2 * d]
    p = r * hp
    rh = p.to(torch.bfloat16).double()
    ulp = torch.ldexp(torch.ones_like(p), torch.frexp(p)[1] - 8)
    near = (ulp / 2 - (p - rh).abs()).abs() <= 4 * hp.abs() * (
        0.25 * coef * mag_ur[..., d:] + 2.0 ** -20 * r)
    flip = torch.matmul(near * ulp, whc.abs())
    c = torch.tanh(x[..., 2 * d:] + torch.matmul(rh, whc))
    m = mask.double()[..., None]
    h = m * (u * hp + (1 - u) * c) + (1 - m) * hp
    mag_c = (x[..., 2 * d:].abs() + torch.matmul(rh.abs(), whc.abs())
             + flip / coef)
    if proj_mag is not None:
        mag_c = mag_c + proj_mag[..., 2 * d:]
    mag_g = torch.cat([mag_ur, mag_c], -1)
    mag = mag_ur[..., :d] * (hp - c).abs() + mag_c + hp.abs() + c.abs()
    return {"h": h, "gates": torch.cat([u, r, c], -1), "mag": mag,
            "mag_g": mag_g}


def gru_bf16_fwd_agreement(hs, forced, kred: int, urc=None) -> dict:
    """A bf16 GRU forward's hs (and u/r/c slab) against
    :func:`gru_bf16_forced_fwd` of the same hs (the criterion above);
    "ok" says whether they agree."""
    a = bf16_agreement(hs, forced["h"].to(torch.bfloat16), forced["mag"],
                       kred)
    ok = a["share_off"] <= BF16_ULP_SHARE and a["max_share_of_bound"] <= 1
    if urc is not None:
        g = bf16_agreement(urc, forced["gates"].to(torch.bfloat16),
                           forced["mag_g"], kred)
        a["gates"] = g
        ok = (ok and g["share_off"] <= BF16_ULP_SHARE
              and g["max_share_of_bound"] <= 1)
    a["ok"] = bool(ok)
    return a


def gru_bf16_forced_bwd(urc, mask, w_h, w_hc, h0, hs, dhs, dhT, reverse,
                        dxw) -> dict:
    """The backward of a bf16 GRU recomputed in float64 over ``urc`` (bf16
    [B, T, 3D]: u, r, c), step by step in the backward's order: du and dc
    from the float64 dh carry, dr from the form's own dc (rounded to bf16)
    times W_hc^T, the carry dh u m + drh r + [du, dr] W_h^T from the form's
    own ``dxw`` rounded to bf16.  Returns {"dxw", "dh0", "rh" (bf16(r
    h_{t-1}), r the slab's)}."""
    from paddle_tpu_torch.ops.kernels import gru as GK

    t, d = hs.shape[1], w_hc.shape[0]
    hp_all = GK._shift_prev(hs, h0, reverse).double()
    dg = dxw.to(torch.bfloat16).double()
    drh_all = torch.matmul(dg[..., 2 * d:], w_hc.double().t())
    carry_all = torch.matmul(dg[..., :2 * d], w_h.double().t())
    del dg
    g = urc.double()
    dh = dhT.double()
    out = torch.empty(dxw.shape, dtype=torch.float64, device=dxw.device)
    for k in GK._steps(t, not reverse):
        m = mask[:, k, None].double()
        dh = dh + dhs[:, k].double()
        u, r, c = g[:, k].split(d, dim=-1)
        hp = hp_all[:, k]
        du = dh * (hp - c) * u * (1 - u) * m
        dc = dh * (1 - u) * m * (1 - c * c)
        dr = drh_all[:, k] * hp * r * (1 - r)
        out[:, k] = torch.cat([du, dr, dc], -1)
        dh = dh * u * m + drh_all[:, k] * r + carry_all[:, k] + (1 - m) * dh
    rh = (g[..., d:2 * d] * hp_all).to(torch.bfloat16)
    return {"dxw": out, "dh0": dh, "rh": rh}


def gru_bf16_bwd_agreement(got, forced) -> dict:
    """A bf16 GRU backward's (dxw, dh0, rh) against
    :func:`gru_bf16_forced_bwd` of its own dxw (the criterion above); "ok"
    says whether they agree."""
    dxw, dh0, rh = got
    steps = [rel_norm(dxw[:, k], forced["dxw"][:, k])
             for k in range(dxw.shape[1])
             if forced["dxw"][:, k].abs().max() > 0]
    ulps = bf16_ulps(rh, forced["rh"])
    a = {"dxw_step_worst": max(steps), "dh0": rel_norm(dh0, forced["dh0"]),
         "rh_share_off": float((ulps > 0).float().mean()),
         "rh_max_ulps": int(ulps.max()),
         "max_abs_err": float((dxw.double() - forced["dxw"]).abs().max())}
    a["ok"] = bool(a["dxw_step_worst"] <= LSTM_BF16_STEP_RTOL
                   and a["dh0"] <= LSTM_BF16_SUM_RTOL
                   and a["rh_share_off"] <= BF16_ULP_SHARE
                   and a["rh_max_ulps"] <= 2)
    return a


def gru_halves_swapped(run):
    """``run()`` with the twin's update and reset pre-activations swapped:
    the planted fault of the bf16 forms' pairs slice (a unit's two gate
    columns read the wrong way round)."""
    from paddle_tpu_torch.ops.kernels import gru as GK

    plain = GK._gates

    def swapped(x_t, h, w_h, w_hc):
        d = h.shape[-1]
        x_t = torch.cat([x_t[:, d:2 * d], x_t[:, :d], x_t[:, 2 * d:]], -1)
        return plain(x_t, h, torch.cat([w_h[:, d:], w_h[:, :d]], -1), w_hc)

    GK._gates = swapped
    try:
        return run()
    finally:
        GK._gates = plain


def gru_unrounded(run):
    """``run()`` with the GRU twins' bf16 roundings of a product's operand
    off: in the forward r h_{t-1} before W_hc (JAX ``gru.py:41`` rounds it),
    in the backward dc and [du, dr] before W_hc^T and W_h^T (``:86``,
    ``:93``) — the planted faults "rh unrounded" and "products
    unrounded"."""
    from paddle_tpu_torch.ops.kernels import gru as GK

    plain = GK._rounded
    GK._rounded = lambda x, dtype: x
    try:
        return run()
    finally:
        GK._rounded = plain


def gru_projection_rounded(run):
    """``run()`` with the BiGRU twin's projection rounded to bf16 (the
    planted fault: JAX keeps it f32, ``gru.py:578-580``)."""
    from paddle_tpu_torch.ops.kernels import gru as GK

    plain = GK._project_xw
    GK._project_xw = lambda *a: plain(*a).to(torch.bfloat16).float()
    try:
        return run()
    finally:
        GK._project_xw = plain


def gru_dwh_unshifted(run):
    """``run()`` with the GRUs' dW_h taking h_t for h_{t-1} (the stacks
    unshifted): the planted fault the NMT's bf16 witness must catch."""
    from paddle_tpu_torch.ops.kernels import gru as GK

    plain = GK._shift_prev
    GK._shift_prev = lambda stack, boot, reverse: stack
    try:
        return run()
    finally:
        GK._shift_prev = plain


def gru_bf16_counters() -> dict:
    """{name: Kernel} of every form the NMT's steps may launch."""
    from paddle_tpu_torch.ops.kernels import embedding as EK
    from paddle_tpu_torch.ops.kernels import gru as GK

    return {"bigru_fwd": GK.KERNEL_BI, "gru_fwd": GK.KERNEL_FWD,
            "gru_bwd_remat": GK.KERNEL_BWD,
            "gru_bwd_stored": GK.KERNEL_BWD_STORED,
            "bigru_fwd_bf16": GK.KERNEL_BI_BF16,
            "gru_fwd_bf16": GK.KERNEL_FWD_BF16,
            "gru_bwd_remat_bf16": GK.KERNEL_BWD_BF16,
            "gru_bwd_stored_bf16": GK.KERNEL_BWD_STORED_BF16,
            "gather": EK.KERNEL_GATHER, "gather_bf16": EK.KERNEL_GATHER_BF16,
            "scatter_add": EK.KERNEL_SCATTER}


def bf16_gru_inputs(dev, gen, b, t, d, lengths) -> dict:
    """bf16 xw, W_h, W_hc, h0 and dhs, an f32 mask and dh_T of a GRU at
    [B, T, D] with the given lengths."""
    bf = torch.bfloat16
    mask = (torch.arange(t, device=dev)[None, :]
            < lengths.to(dev)[:, None]).float()

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device=dev)).to(bf)

    return dict(xw=rnd(b, t, 3 * d, scale=0.5), mask=mask,
                w_h=rnd(d, 2 * d, scale=d ** -0.5),
                w_hc=rnd(d, d, scale=d ** -0.5), h0=rnd(b, d, scale=0.5),
                dhs=rnd(b, t, d),
                dhT=torch.randn(b, d, generator=gen, device=dev))


def gru_bf16_case(x, reverse, xw=None) -> dict:
    """The bf16 GRU forward and backward forms on one problem against their
    forced float64 steps, with their planted faults and reruns: {"fwd",
    "bwd" (agreements), "faults" (each fault's twin outputs against the
    same criterion), "bits" (the rerun, stored vs remat, the slab form's
    hs), "args"}.  ``xw`` (f32) replaces x["xw"] in the backward's remat
    (the BiGRU's projection); the forward then is not the path's and is
    not run, and x["hs"] is the BiGRU's."""
    from paddle_tpu_torch.ops.kernels import gru as GK

    m, w_h, w_hc, h0 = x["mask"], x["w_h"], x["w_hc"], x["h0"]
    d = w_hc.shape[0]
    out = {"bits": {}, "faults": {}}
    if xw is None:
        xw = x["xw"]
        hs, _, h_t = GK._fwd_kernel(xw, m, w_h, w_hc, h0, reverse, False)
        again = GK._fwd_kernel(xw, m, w_h, w_hc, h0, reverse, False)
        hs_g, urc, h_t_g = GK._fwd_kernel(xw, m, w_h, w_hc, h0, reverse, True)
        out["bits"]["fwd_rerun"] = (torch.equal(hs, again[0])
                                    and torch.equal(h_t, again[2]))
        out["bits"]["fwd_gates_form"] = (torch.equal(hs, hs_g)
                                         and torch.equal(h_t, h_t_g))
        forced = gru_bf16_forced_fwd(xw, m, w_h, w_hc, h0, reverse, hs, d)
        a = gru_bf16_fwd_agreement(hs, forced, d, urc)
        last = 0 if reverse else xw.shape[1] - 1
        a["h_T"] = rel_norm(h_t, forced["h"][:, last])
        a["ok"] = a["ok"] and a["h_T"] <= GRU_BF16_STATE_RTOL
        out["fwd"] = a
        del again, hs_g, h_t_g
        for name, wrap in (("rh_unrounded", gru_unrounded),
                           ("halves_swapped", gru_halves_swapped)):
            bad = wrap(lambda: GK._fwd_plain(xw, m, w_h, w_hc, h0, reverse,
                                             True))
            out["faults"][name] = gru_bf16_fwd_agreement(
                bad[0], gru_bf16_forced_fwd(xw, m, w_h, w_hc, h0, reverse,
                                            bad[0], d), d, bad[1])
            del bad
    else:
        hs = x["hs"]
        forced = gru_bf16_forced_fwd(xw, m, w_h, w_hc, h0, reverse, hs, d)
        urc = forced["gates"].to(torch.bfloat16)
    r64 = forced["gates"][..., d:2 * d]
    del forced
    args = (m, w_h, w_hc, h0, hs, x["dhs"], x["dhT"], reverse)
    remat = GK._bwd_kernel(xw, None, *args, True)
    again = GK._bwd_kernel(xw, None, *args, True)
    out["bits"]["bwd_rerun"] = all(torch.equal(a, b)
                                   for a, b in zip(remat, again))
    del again
    if xw.dtype == torch.bfloat16:
        stored = GK._bwd_kernel(None, urc, *args, False)
        out["bits"]["bwd_remat_vs_stored"] = all(
            torch.equal(a, b) for a, b in zip(remat, stored))
        del stored
    out["bwd"] = gru_bf16_bwd_agreement(
        remat, gru_bf16_forced_bwd(urc, *args[:-1], reverse, remat[0]))
    bad = gru_unrounded(lambda: GK._bwd_plain(None, urc, *args, False))
    out["faults"]["products_unrounded"] = gru_bf16_bwd_agreement(
        bad, gru_bf16_forced_bwd(urc, *args[:-1], reverse, bad[0]))
    # dW_hc's operand from the forward's unrounded r, bf16(r h_{t-1})
    rh_bad = (r64 * GK._shift_prev(hs, h0, reverse).double()).to(
        torch.bfloat16)
    out["faults"]["rh_from_unrounded_r"] = gru_bf16_bwd_agreement(
        (remat[0], remat[1], rh_bad),
        gru_bf16_forced_bwd(urc, *args[:-1], reverse, remat[0]))
    del bad, rh_bad, r64
    out["args"] = (xw, urc) + args
    out["hs"], out["remat"] = hs, remat
    return out


def bigru_bf16_case(xs, mask, fw, bw, gen) -> dict:
    """The bf16 BiGRU forward on one problem and, per direction, the GRU
    backward form over its f32 projection, as the BiGRU's backward runs
    it: each against its forced float64 steps (the projection's |terms|
    in the sum, K = E + D), reruns in the same bits, and the planted
    faults (the projection rounded, the gate halves swapped, r h
    unrounded; the backward's products unrounded, dW_hc's r unrounded).
    {"bigru", "bwd" (by direction), "bigru_faults", "bwd_faults", "bits",
    "ok", "bwd_args" (the forward direction's backward arguments)}."""
    from paddle_tpu_torch.ops.kernels import gru as GK

    bf = torch.bfloat16
    b, t, e = xs.shape
    d = fw[3].shape[0]
    outs = GK._bi_fwd_kernel(xs, mask, fw, bw)
    again = GK._bi_fwd_kernel(xs, mask, fw, bw)
    out = {"bigru": {}, "bwd": {}, "bigru_faults": {}, "bwd_faults": {},
           "bits": {"bigru_rerun": all(
               torch.equal(u, v) for o1, o2 in zip(outs, again)
               for u, v in zip(o1, o2))}}
    del again
    for key, weights, (hs, h_t), reverse in (
            ("forward", fw, outs[0], False), ("reverse", bw, outs[1], True)):
        w_x, bias, w_h, w_hc, h0 = weights
        proj = torch.matmul(xs.double().abs(), w_x.double().abs())
        xw64 = torch.matmul(xs.double(), w_x.double()) + bias.double()
        forced = gru_bf16_forced_fwd(xw64, mask, w_h, w_hc, h0, reverse, hs,
                                     e + d, proj)
        a = gru_bf16_fwd_agreement(hs, forced, e + d)
        a["h_T"] = rel_norm(h_t, forced["h"][:, 0 if reverse else t - 1])
        a["ok"] = a["ok"] and a["h_T"] <= GRU_BF16_STATE_RTOL
        out["bigru"][key] = a
        del forced
        for fault, wrap in (("projection_rounded", gru_projection_rounded),
                            ("halves_swapped", gru_halves_swapped),
                            ("rh_unrounded", gru_unrounded)):
            bad = wrap(lambda: GK._bi_fwd_plain(xs, mask, fw, bw))[
                1 if reverse else 0][0]
            out["bigru_faults"][f"{key}_{fault}"] = gru_bf16_fwd_agreement(
                bad, gru_bf16_forced_fwd(xw64, mask, w_h, w_hc, h0, reverse,
                                         bad, e + d, proj), e + d)
        cx = {"mask": mask, "w_h": w_h, "w_hc": w_hc, "h0": h0, "hs": hs,
              "dhs": torch.randn(b, t, d, generator=gen,
                                 device=xs.device).to(bf),
              "dhT": torch.zeros(b, d, device=xs.device)}
        case = gru_bf16_case(cx, reverse, GK._project_xw(xs, w_x, bias))
        out["bits"][f"bwd_{key}_rerun"] = case["bits"]["bwd_rerun"]
        out["bwd"][key] = case["bwd"]
        out["bwd_faults"].update({f"{key}_{k}": v
                                  for k, v in case["faults"].items()})
        if key == "forward":
            out["bwd_args"] = case["args"]
        del case, xw64, proj
    out["ok"] = bool(all(a["ok"] for a in out["bigru"].values())
                     and all(a["ok"] for a in out["bwd"].values()))
    return out


NMT_ORDER = ("source_language_word", "target_language_word",
             "target_language_next_word")


def nmt_bf16_setup():
    """The NMT's bf16 witness step (``NMT_BF16_NET``): (topology, cost
    name, f32 parameters as numpy, the input types, one seeded batch of
    ``NMT_BF16_BATCH`` ragged (source, target, next-target) rows, the
    feeding).  Parameters from ``parameters.create`` (seeded), the biases
    made nonzero so every term of the cells and the softmax counts."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.config.topology import Topology
    from paddle_tpu_torch.layers.base import reset_name_counters
    from paddle_tpu_torch.models import seqtoseq

    reset_name_counters()
    net = NMT_BF16_NET
    cost = seqtoseq.seqtoseq_net(net["source_dict_dim"],
                                 net["target_dict_dim"],
                                 word_vector_dim=net["word_vector_dim"],
                                 encoder_size=net["encoder_size"],
                                 decoder_size=net["decoder_size"])
    topo = Topology(cost)
    created = paddle.parameters.create(cost)
    rng = np.random.default_rng(0)
    params = {n: np.array(created[n]) for n in created.names()}
    for n in params:
        if n.endswith("bias"):
            params[n] = (0.1 * rng.standard_normal(params[n].shape)
                         ).astype(np.float32)
    rows, lo, hi = NMT_BF16_BATCH
    batch = []
    for _ in range(rows):
        ls, lt = (int(rng.integers(lo, hi + 1)) for _ in range(2))
        trg = rng.integers(0, net["target_dict_dim"], size=lt + 1)
        batch.append((rng.integers(0, net["source_dict_dim"],
                                   size=ls).tolist(),
                      trg[:-1].tolist(), trg[1:].tolist()))
    feeding = {n: i for i, n in enumerate(NMT_ORDER)}
    return (topo, cost.name, params, data_types(paddle, topo), batch,
            feeding)


def check_gru_bf16_kernels(dev, timer, b=64, t=32, e=512,
                           d=512) -> tuple[list, dict]:
    """The bf16 forms of rows 8 and 10 at the NMT's shapes (B 64, T 32,
    E = D = 512; half the rows full, half ragged, one of length 1): the
    GRU forward and backward (remat and stored gates, xw bf16, as the
    composed ``simple_gru2`` pair runs them) over both directions; the
    BiGRU forward and, per direction, the backward over its f32
    projection, as the NMT's encoder runs them.  Each against its forced
    float64 steps (the criterion above), reruns in the same bits, the
    backward's remat and stored forms in the same bits, and each planted
    fault must fail: r h unrounded, the u/r halves swapped, the BiGRU's
    projection rounded, the backward's products unrounded, dW_hc from the
    unrounded r.  Times (bf16, 2 B an element, 989 TFLOP/s): each form
    with the L2 flushed, alone (a trace), its bf16 twin, its bound, and
    bf16 cuDNN ``nn.GRU`` (not the same cell: its reset gate acts after
    the candidate product, and it includes the input projection)."""
    from paddle_tpu_torch.ops.kernels import gru as GK

    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(16)
    summary = {"phase": "gru_bf16_kernels",
               "criterion": "forced float64 steps (chip_smoke.py)",
               "step_rtol": LSTM_BF16_STEP_RTOL,
               "sum_rtol": LSTM_BF16_SUM_RTOL,
               "state_rtol": GRU_BF16_STATE_RTOL,
               "lengths": "half full (32), half ragged, one of length 1"}

    def must(ok, what, detail):
        if not ok:
            raise AssertionError(f"bf16 gru forms, {what}: {detail}")

    lens = torch.randint(1, t + 1, (b,), generator=gen, device=dev)
    lens[: b // 2] = t
    lens[-1] = 1
    # (a) the GRU forms over xw bf16, both directions
    summary["gru"], calls = {}, {}
    for key, reverse in (("forward", False), ("reverse", True)):
        x = bf16_gru_inputs(dev, gen, b, t, d, lens)
        x["h0"] = torch.zeros_like(x["h0"])
        case = gru_bf16_case(x, reverse)
        must(all(case["bits"].values()), f"gru {key} bits", case["bits"])
        must(case["fwd"]["ok"] and case["bwd"]["ok"],
             f"gru {key} vs forced steps",
             {k: case[k] for k in ("fwd", "bwd")})
        must(not any(f["ok"] for f in case["faults"].values()),
             f"a gru {key} fault passed", case["faults"])
        summary["gru"][key] = {k: case[k] for k in ("fwd", "bwd", "faults",
                                                    "bits")}
        calls[key] = case["args"]
        del case
    xw, urc, *args = calls["forward"]
    m, w_h, w_hc, h0 = args[:4]
    fwd_args = (xw, m, w_h, w_hc, h0, False, False)
    fwd = lambda: GK._fwd_kernel(*fwd_args)                       # noqa: E731
    fwd_slab = lambda: GK._fwd_kernel(*fwd_args[:-1], True)       # noqa: E731
    stored = lambda: GK._bwd_kernel(None, urc, *args, False)      # noqa: E731

    # (b) the BiGRU forward and the backward over its f32 projection
    xs = torch.randn(b, t, e, generator=gen, device=dev).to(bf)
    mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).float()

    def direction():
        return ((torch.randn(e, 3 * d, generator=gen, device=dev)
                 / e ** 0.5).to(bf),
                0.1 * torch.randn(3 * d, generator=gen, device=dev),
                (torch.randn(d, 2 * d, generator=gen, device=dev)
                 / d ** 0.5).to(bf),
                (torch.randn(d, d, generator=gen, device=dev)
                 / d ** 0.5).to(bf),
                torch.zeros(b, d, device=dev, dtype=bf))

    fw, bw = direction(), direction()
    case = bigru_bf16_case(xs, mask, fw, bw, gen)
    must(all(case["bits"].values()), "bigru reruns", case["bits"])
    must(case["ok"], "bigru vs forced", {k: case[k] for k in ("bigru",
                                                               "bwd")})
    must(not any(f["ok"] for f in case["bigru_faults"].values())
         and not any(f["ok"] for f in case["bwd_faults"].values()),
         "a bigru fault passed", case)
    xw_p, _, *pargs = case.pop("bwd_args")
    summary["bigru"] = case
    remat = lambda: GK._bwd_kernel(xw_p, None, *pargs, True)      # noqa: E731
    bi = lambda: GK._bi_fwd_kernel(xs, mask, fw, bw)              # noqa: E731

    # yardsticks: bf16 cuDNN GRU (another cell), one direction over a
    # D-wide input forward and backward, and bidirectional over x
    cudnn1 = torch.nn.GRU(d, d, batch_first=True).to(dev, bf)
    cudnn_bi = torch.nn.GRU(e, d, batch_first=True,
                            bidirectional=True).to(dev, bf)
    cudnn1.flatten_parameters()
    cudnn_bi.flatten_parameters()
    x1 = torch.randn(b, t, d, generator=gen, device=dev).to(bf)
    x1_lib = x1.clone().requires_grad_()
    out1, _ = cudnn1(x1_lib)
    g1 = torch.randn_like(out1)
    lib_params = (x1_lib, *cudnn1.parameters())

    def lib_fwd():
        with torch.no_grad():
            return cudnn1(x1)

    def lib_bi():
        with torch.no_grad():
            return cudnn_bi(xs)

    lib_bwd = lambda: torch.autograd.grad(                        # noqa: E731
        out1, lib_params, g1, retain_graph=True)
    lib_note = "bf16 cuDNN nn.GRU: not the same cell"
    steps = float(mask.sum().item())        # row-steps of one direction
    cell = 20.0 * steps * d
    rec = 2.0 * steps * 3 * d * d           # h W_h and (r h) W_hc
    io = 2 * (3 * d * d + b * d) + 4 * b * t   # W_h, W_hc, h0 bf16; mask
    # hs, dhs bf16 and dh_T in; dxw f32, dh0 f32 and rh bf16 out
    bwd_io = (io + 2 * 2 * b * t * d + 4 * b * d
              + 4 * (b * t * 3 * d + b * d) + 2 * b * t * d)
    src = "paddle_tpu_torch/ops/kernels/csrc/gru_seq.cu"
    gru = summary["gru"]["forward"]
    rows = [{
        "name": "gru_seq_fwd_bf16", "route": "cuda", "source": src,
        "replaces": "paddle_tpu/ops/pallas/gru.py:188",
        "shape": [b, t, d], "dtype": "bfloat16",
        "max_abs_err": gru["fwd"]["max_abs_err"],
        "ms": timer(fwd), "alone_ms": device_ms([fwd], "gru_fwd_bf16_kernel"),
        # writing the u/r/c slab, as the stored route runs it
        "with_slab_ms": timer(fwd_slab),
        "with_slab_alone_ms": device_ms([fwd_slab], "gru_fwd_bf16_kernel"),
        "plain_ms": timer(lambda: GK._fwd_plain(*fwd_args)),
        # xw bf16 in, hs bf16 and h_T f32 out
        "bytes_flops": (2 * b * t * 3 * d + io + 2 * b * t * d + 4 * b * d,
                        rec + cell),
        "library_ms": timer(lib_fwd), "library_note": lib_note}, {
        "name": "gru_seq_bwd_remat_bf16", "route": "cuda", "source": src,
        "replaces": "paddle_tpu/ops/pallas/gru.py:279",
        "shape": [b, t, d], "dtype": "bfloat16 (xw f32, the BiGRU's)",
        "max_abs_err": case["bwd"]["forward"]["max_abs_err"],
        "ms": timer(remat),
        "alone_ms": device_ms([remat], "gru_bwd_bf16_kernel<true"),
        "plain_ms": timer(lambda: GK._bwd_plain(xw_p, None, *pargs, True)),
        # xw f32 in; the recomputed products, dc W_hc^T and [du, dr] W_h^T
        "bytes_flops": (4 * b * t * 3 * d + bwd_io, 2 * rec + 2 * cell),
        "library_ms": timer(lib_bwd), "library_note": lib_note}, {
        "name": "gru_seq_bwd_stored_bf16", "route": "cuda", "source": src,
        "replaces": "paddle_tpu/ops/pallas/gru.py:232",
        "shape": [b, t, d], "dtype": "bfloat16",
        "max_abs_err": gru["bwd"]["max_abs_err"],
        "ms": timer(stored),
        "alone_ms": device_ms([stored], "gru_bwd_bf16_kernel<false"),
        "plain_ms": timer(lambda: GK._bwd_plain(None, urc, *args, False)),
        # the u/r/c slab bf16 in; the two transposed products
        "bytes_flops": (2 * b * t * 3 * d + bwd_io, rec + cell),
        "library_ms": timer(lib_bwd), "library_note": lib_note}, {
        "name": "bigru_seq_fwd_bf16", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/bigru_seq.cu",
        "replaces": "paddle_tpu/ops/pallas/gru.py:625",
        "shape": [b, t, e, d], "dtype": "bfloat16",
        "max_abs_err": max(a["max_abs_err"]
                           for a in case["bigru"].values()),
        "ms": timer(bi), "alone_ms": device_ms([bi], "bigru_fwd_bf16_kernel"),
        "plain_ms": timer(lambda: GK._bi_fwd_plain(xs, mask, fw, bw)),
        # x, both directions' W_x, W_h, W_hc, h0 bf16 and b, mask f32 in;
        # hs bf16 and h_T f32 of both out
        "bytes_flops": (2 * b * t * e + 4 * b * t
                        + 2 * (2 * (e * 3 * d + 3 * d * d + b * d)
                               + 4 * 3 * d)
                        + 2 * (2 * b * t * d + 4 * b * d),
                        2 * (2.0 * steps * e * 3 * d + rec + cell)),
        "library_ms": timer(lib_bi), "library_note": lib_note}]
    for row in rows:
        row["bound_ms"], row["bound_by"] = bound(*row.pop("bytes_flops"),
                                                 BF16_FLOPS_PER_S)
    del calls, cudnn1, cudnn_bi, out1, g1, lib_params, x1_lib
    torch.cuda.synchronize()
    return rows, summary


def nmt_bf16_witness(dev) -> dict:
    """The NMT's bf16 witness step at the cut width (:func:`nmt_bf16_setup`):
    the loss and every gradient leaf of the bf16 step on the card (the
    bf16 forms) and on the CPU (the twins), each against the float64 step
    on the CPU, within 2x the JAX package's own bf16 error at the same
    step (``NMT_BF16_WITNESS_JAX``) plus RNN_BF16_FLOOR; the card's step
    repeats bit for bit; a card step whose GRU dW_h takes h_t for h_{t-1}
    (the stacks unshifted) must exceed it."""
    from paddle_tpu_torch.reader.feeder import DataFeeder

    topo, cost_name, params, types, batch, feeding = nmt_bf16_setup()
    jax_errs = NMT_BF16_WITNESS_JAX

    def side(where, dtype=torch.bfloat16, wide=torch.float32):
        feed = DataFeeder(types, feeding, device=where)(batch)
        p = {n: torch.from_numpy(v).to(where, wide) for n, v in params.items()}
        return topology_grads(topo, cost_name, p, feed, dtype)

    loss64, g64 = side("cpu", None, torch.float64)
    counters = gru_bf16_counters()
    for k in counters.values():
        k.launches = 0
    sides = {"card": side(dev)}
    launches = {n: k.launches for n, k in counters.items() if k.launches}
    if launches != {"bigru_fwd_bf16": 1, "gru_bwd_remat_bf16": 2,
                    "gather_bf16": 2, "scatter_add": 2}:
        raise AssertionError(f"the NMT bf16 witness step's launches "
                             f"{launches}")
    rerun = side(dev)
    sides["cpu"] = side("cpu")
    sides["card_dwh_unshifted_control"] = gru_dwh_unshifted(
        lambda: side(dev))
    if not (torch.equal(rerun[0], sides["card"][0]) and all(
            torch.equal(rerun[1][n], sides["card"][1][n]) for n in g64)):
        raise AssertionError("the card's bf16 NMT step is not bit-identical "
                             "on a rerun")
    out = {"limit": f"2 x JAX's own + {RNN_BF16_FLOOR}",
           "net": NMT_BF16_NET, "loss_f64": float(loss64),
           "launches": launches, "card_rerun_bit_identical": True}
    for label, (loss, grads) in sides.items():
        errs = rnn_bf16_errors(loss, grads, loss64, g64)
        share = {n: e / (2 * jax_errs[n] + RNN_BF16_FLOOR)
                 for n, e in errs.items()}
        worst = max(share, key=share.get)
        out[label] = {"loss": float(loss), "worst": worst,
                      "err": errs[worst], "jax": jax_errs[worst],
                      "share_of_limit": share[worst],
                      "over_limit": [n for n, x in share.items() if x > 1]}
    for label in ("card", "cpu"):
        if out[label]["over_limit"]:
            raise AssertionError(f"bf16 NMT {label} step vs the f64 "
                                 f"witness: {out}")
    if not out["card_dwh_unshifted_control"]["over_limit"]:
        raise AssertionError(f"the bf16 NMT witness does not catch a GRU "
                             f"dW_h over unshifted stacks: {out}")
    return out


def train_nmt_bf16(dev, vocab=30000, width=512, bs=64,
                   steps=10) -> tuple[dict, dict]:
    """The attention NMT at ``bench_nmt``'s configuration through
    ``trainer.SGD(compute_dtype=torch.bfloat16)`` (Adam 5e-4, bf16
    moments) beside f32 from the same parameters: 2 warm-up steps each,
    ``steps`` timed steps each in blocks of ``steps // 2`` (bf16, f32,
    f32, bf16) with exactly one ``bigru_fwd_bf16``, two
    ``gru_bwd_bf16`` (remat, over the BiGRU's f32 projection), two bf16
    gathers and two (the lookups' backward in f32) scatter-adds a bf16
    step and no other form's (no f32 GRU launch); sequences/s, step ms,
    peak memory, finite bf16 costs, f32 masters; a 3-step bf16 profile.
    Returns (the phase's result, the bf16 forms' launches over the timed
    bf16 steps)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.parameters import Parameters
    from paddle_tpu_torch.layers.base import reset_name_counters
    from paddle_tpu_torch.models import seqtoseq

    reset_name_counters()
    cost = seqtoseq.seqtoseq_net(vocab, vocab, word_vector_dim=width,
                                 encoder_size=width, decoder_size=width)
    created = paddle.parameters.create(cost)
    carried = {n: created[n] for n in created.names()}
    rng = np.random.default_rng(0)
    for n in carried:
        if n.endswith("bias"):
            carried[n] = (0.1 * rng.standard_normal(carried[n].shape)
                          ).astype(np.float32)
    feeding = {n: i for i, n in enumerate(NMT_ORDER)}
    trainers = {k: paddle.trainer.SGD(
        cost=cost, parameters=Parameters.from_numpy(carried),
        update_equation=paddle.optimizer.Adam(
            learning_rate=5e-4, moment_dtype=torch.bfloat16),
        device=dev, compute_dtype=dt)
        for k, dt in (("bf16", torch.bfloat16), ("f32", None))}
    warm = nmt_batches(rng, 2, bs, vocab)
    for tr in trainers.values():
        tr.train(reader=lambda: iter(warm), num_passes=1,
                 event_handler=lambda e: None, feeding=feeding)
    want = {"bf16": {"bigru_fwd_bf16": 1, "gru_bwd_remat_bf16": 2,
                     "gather_bf16": 2, "scatter_add": 2},
            "f32": {"bigru_fwd": 1, "gru_bwd_remat": 2, "gather": 2,
                    "scatter_add": 2}}
    blocks = dtype_blocks(trainers, nmt_batches(rng, steps // 2, bs, vocab),
                          want, stamp_factory, gru_bf16_counters(), feeding)
    out = rnn_rates(blocks, bs, "sequences_per_s")
    if not all(np.isfinite(out[k]["costs"]).all() for k in out):
        raise AssertionError(f"NMT costs not finite: {out}")
    if not all(trainers["bf16"].parameters[n].dtype == np.float32
               for n in carried):
        raise AssertionError("the bf16 NMT trainer's masters are not f32")
    traced = nmt_batches(rng, 3, bs, vocab)
    prof = profile_window(lambda: trainers["bf16"].train(
        reader=lambda: iter(traced), num_passes=1,
        event_handler=lambda e: None, feeding=feeding), 3)
    if "device_busy_ms_per_step" in prof:
        prof["idle_share_vs_step_p50"] = (
            1 - prof["device_busy_ms_per_step"] / out["bf16"]["step_ms_p50"])
    launched = {k: sum(b[k] for b in blocks["bf16"]["launches"])
                for k in want["bf16"]}
    del trainers
    return ({"phase": "train_nmt_bf16", "model": "attention NMT "
             "(models/seqtoseq.seqtoseq_net, bench_nmt)", "vocab": vocab,
             "width": width, "batch": bs, "tokens_per_sequence": 32,
             "compute_dtype": "bfloat16", "masters": "float32",
             "adam_moments": "bfloat16", "lr": 5e-4,
             "steps_per_dtype": steps, **out,
             "bf16_vs_f32_sequences_per_s":
                 out["bf16"]["sequences_per_s"] / out["f32"][
                     "sequences_per_s"],
             "profile_bf16": prof, "bf16_launches": launched}, launched)


# -- phase 17: serving in bf16, the bf16 form of row 1 -----------------------

#: the greedy requests of the bf16 serving run held to the float64 witness
SERVE_BF16_WITNESS = 4
#: planted faults of the bf16 paged kernel (``split16``), each a copy of
#: its source under build/faults/ with lines changed: the scores left
#: unscaled; each page's weight exp(m_i - m_c) dropped (the rescale); p
#: rounded against its chunk's own max (the f32 form's split, another
#: function: every page's running max and the chunk's m_c the max of the
#: chunk's pages alone); the row's ticket left where the last chunk drew
#: it (the first launch right, the second wrong).  Each must fail the
#: kernel check; the served tokens' margin check must catch "no_scale".
#: At random weights attention is a near-uniform average of random V rows,
#: so a fault that keeps it an average hardly moves the served tokens: the
#: margin check is run on the others and reported only.
PAGED_BF16_FAULTS = {
    "no_scale": ("s_sm[r] = scale * dot;  // the scaled score",
                 "s_sm[r] = dot;  // the scaled score"),
    "no_rescale": ("w_pg[j] = expf(m_pg[j] - m_last);",
                   "w_pg[j] = 1.f;"),
    "chunk_max": [
        ("    float carry = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], "
         "red[3]));", "    float carry = kNegInf;"),
        ("    const float mi = m_pg[j];   // the page's running max",
         "    const float mi = m_c;   // planted: the chunk's own max"),
        ("w_pg[j] = expf(m_pg[j] - m_last);", "w_pg[j] = 1.f;")],
    "ticket_kept": ("  if (tid == 0) tickets[bh] = 0u;  // the row's ticket, "
                    "ready again", "  // planted: the ticket is not reset")}


def paged_bf16_agreement(q, kp, vp, pt, sl) -> dict:
    """The bf16 kernel against its twin on the same bf16 inputs
    (``bf16_agreement`` with FLASH_BF16_FLIP: one ulp at the larger
    magnitude plus 2^-7 of sum_j p_j |v_j| / l, the twin in f32 on |V|,
    since a bf16 p that rounds the other way moves its term by at most
    2^-7 of it), whether it agrees (unequal on at most BF16_ULP_SHARE), a
    rerun in the same bits and idle rows exactly 0."""
    from paddle_tpu_torch.ops.kernels import paged_attention as PA

    out = PA.ragged_paged_attention(q, kp, vp, pt, sl)
    again = PA.ragged_paged_attention(q, kp, vp, pt, sl)
    want = PA.ragged_paged_attention_reference(q, kp, vp, pt, sl)
    mag = PA.ragged_paged_attention_reference(
        q.float(), kp.float(), vp.float().abs(), pt, sl)
    torch.cuda.synchronize()
    idle = sl == 0
    a = bf16_agreement(out, want, mag, coef=FLASH_BF16_FLIP)
    a["rerun_bit_identical"] = torch.equal(out.view(torch.int16),
                                           again.view(torch.int16))
    a["idle_rows_zero"] = not out[idle].float().any().item()
    a["agrees"] = (bf16_agrees(out, want, mag, coef=FLASH_BF16_FLIP)
                   and a["rerun_bit_identical"] and a["idle_rows_zero"])
    return a


#: the bf16 paged form's two kernels (``split16``): the scores and page
#: maxes, then p.V and the combine
PAGED_BF16_KERNELS = ("paged_bf16_scores_kernel", "paged_bf16_pv_kernel")


def check_paged_bf16(dev, timer) -> dict:
    """Row 1's bf16 form at ``check_paged``'s problem in bf16 (B 32, H 12,
    D 64, page 16, 36 pages, the same ragged lengths): against its twin
    (``paged_bf16_agreement``), also with the queries reversed (the
    second launch finds the tickets the first reset); a trace of its
    calls holds its two kernels (``PAGED_BF16_KERNELS``: the device
    launches a call) and no other; then timed as ``paged_times`` (2 B an
    element, bf16 SDPA as the yardstick), alone as the sum of its two
    kernels' device times, and the host's ms a call."""
    from paddle_tpu_torch.ops.kernels import paged_attention as PA

    q, kp, vp, pt, sl, lens = paged_inputs(dev)
    q, kp, vp = (x.to(torch.bfloat16) for x in (q, kp, vp))
    a = paged_bf16_agreement(q, kp, vp, pt, sl)
    flipped = paged_bf16_agreement(torch.flip(q, dims=(2,)), kp, vp, pt, sl)
    if not (a["agrees"] and flipped["agrees"]):
        raise AssertionError(f"bf16 paged kernel vs its twin: {a}, the "
                             f"queries reversed {flipped}")
    fn = lambda: PA.ragged_paged_attention(q, kp, vp, pt, sl)  # noqa: E731
    traced = trace_kernel_counts(fn)
    names = sorted({k for k in traced
                    for want in PAGED_BF16_KERNELS if want in k})
    if len(names) != 2 or len(traced) != 2:
        raise AssertionError(f"bf16 paged call: kernels traced {traced}")
    b, h, d = q.shape
    ps, maxp = kp.shape[2], pt.shape[1]
    return {"name": "ragged_paged_attention_bf16", "route": "cuda",
            "source": "paddle_tpu_torch/ops/kernels/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/paged_attention.py:274",
            "shape": [b, h, d, ps, maxp], "dtype": "bfloat16",
            "agreement": a, "agreement_queries_reversed": flipped,
            "max_abs_err": max(a["max_abs_err"], flipped["max_abs_err"]),
            "device_launches_a_call": len(names),
            "pages_a_chunk": PA.pages_per_chunk(ps, torch.bfloat16),
            "splits": PA.splits(maxp, ps, torch.bfloat16),
            "host_ms": host_ms(fn),
            **paged_times(q, kp, vp, pt, sl, lens, timer,
                          PAGED_BF16_KERNELS)}


def check_flash_bf16_prefill(dev, timer) -> dict:
    """Row 2's bf16 forward at serving's prefill shape [8, 512, 12, 64]
    causal, the Hopper form on q, k, v as they lie: against its twin
    (:func:`flash_forward_agreement`), then timed with the L2 flushed,
    alone, the host's ms a call, its twin, bf16 SDPA (flash backend) and
    the bound at 2 B an element; the mma.sync form's times on the padded
    problem beside (the parent's route, off the path now)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    b, t, h, d = 8, 512, 12, 64
    scale = d ** -0.5
    gen = torch.Generator(device=dev).manual_seed(9)
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    fwd = lambda: FA._fwd_bthd(q, k, v, True, scale)  # noqa: E731
    o, lse = fwd()
    a = flash_forward_agreement(q, k, v, o, lse, True, scale)
    if not a["agrees"]:
        raise AssertionError(f"bf16 flash forward at the prefill shape: {a}")
    qp, kp, vp = FA._prep(q, k, v)
    mma = lambda: FA._fwd_kernel(qp, kp, vp, t, True, scale)  # noqa: E731
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        library_ms = timer(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True))
    pairs = b * h * t * (t + 1) // 2
    bound_ms, by = bound(2.0 * 4 * b * t * h * d + 4.0 * b * h * t,
                         4.0 * pairs * d, BF16_FLOPS_PER_S)
    return {"name": "flash_attention_fwd_wgmma_prefill", "route": "cuda",
            "source": "paddle_tpu_torch/ops/kernels/csrc/flash_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/flash_attention.py:277",
            "shape": [b, t, h, d], "dtype": "bfloat16", "agreement": a,
            "max_abs_err": a["max_abs_err"], "ms": timer(fwd),
            "alone_ms": device_ms([fwd], "flash_fwd_wgmma_kernel"),
            "host_ms": host_ms(fwd),
            "plain_ms": timer(lambda: FA._fwd_plain(qp, kp, vp, t, True,
                                                    scale)),
            "bound_ms": bound_ms, "bound_by": by, "library_ms": library_ms,
            "mma_sync_form": {
                "ms": timer(mma),
                "alone_ms": device_ms([mma], "flash_fwd_bf16_kernel")}}


def served_margin_check(cfg, params, results) -> dict:
    """Greedy tokens served in bf16 against a float64 witness: the served
    sequences' logits recomputed in float64 (exact attention) from the
    same bf16 weights, upcast.  ``err`` is the bf16 full-context logits'
    largest distance from the witness on a request's prompt positions.
    Where the witness's top-2 margin exceeds 2 err, the served token must
    be its argmax; elsewhere its witness logit must lie within 2 err of
    the witness's max (a bf16 logit may lie err from its witness, so two
    candidates within 2 err may swap).  Returns the counts, the worst
    share of that bound a served token's gap took, and ``ok``."""
    import dataclasses

    from paddle_tpu_torch.core.dtype import cast_floats
    from paddle_tpu_torch.models import transformer as T

    cfg64 = dataclasses.replace(cfg, dtype=torch.float64, attn_impl="exact")
    params64 = cast_floats(params, torch.float64)
    out = {"requests": len(results), "tokens": 0, "clear": 0,
           "clear_equal": 0, "near_ties": 0, "worst_gap_share": 0.0,
           "err": []}
    dev = params["embed"].device
    for r in results:
        seq = torch.tensor([r.prompt + r.tokens], device=dev)
        n = len(r.prompt)
        l64 = T.forward(cfg64, params64, seq)[0]
        lbf = T.forward(cfg, params, seq)[0]
        err = float((lbf[:n - 1].double() - l64[:n - 1]).abs().max())
        del lbf
        gen = l64[n - 1:n - 1 + len(r.tokens)]
        top2 = gen.topk(2, dim=-1).values
        served = gen.gather(1, torch.tensor(r.tokens, device=dev)[:, None])
        gap = top2[:, 0] - served[:, 0]
        clear = (top2[:, 0] - top2[:, 1]) > 2 * err
        out["err"].append(err)
        out["tokens"] += len(r.tokens)
        out["clear"] += int(clear.sum())
        out["clear_equal"] += int((clear & (gap == 0)).sum())
        out["near_ties"] += int((~clear).sum())
        out["worst_gap_share"] = max(out["worst_gap_share"],
                                     float(gap.max()) / max(2 * err, 1e-30))
    out["ok"] = (out["clear_equal"] == out["clear"]
                 and out["worst_gap_share"] <= 1.0)
    return out


def source_fault_builds(source: str, faults: dict, csrc=None,
                        prefix: str = "") -> dict:
    """Start one ``nvcc`` per planted fault of ``faults`` ({fault: (line,
    planted line)}, or a list of such pairs), each on a copy of
    ``csrc/<source>.cu`` in a directory of its own under
    ``build/faults/``, with its lines changed there or, where a line is in
    a shared header (``csrc/*.cuh``), in a copy of that header beside the
    copy of the source (which its quoted include finds first; the other
    headers from ``csrc/``); returns {fault: (the process, the library's
    path)}.  ``csrc``: another tree's ``csrc`` directory to copy from
    (default this one's), its builds named with ``prefix``; an empty
    list of edits builds the source as it is."""
    from paddle_tpu_torch.ops.kernels import _build

    csrc = Path(csrc) if csrc is not None else _build.CSRC
    paths = [csrc / f"{source}.cu", *sorted(csrc.glob("*.cuh"))]
    files = {p.name: p.read_text() for p in paths}
    out = _build.BUILD_DIR.parent / "faults"
    builds = {}
    for name, edits in faults.items():
        changed = {f"{source}.cu": files[f"{source}.cu"]}
        for line, planted in edits if isinstance(edits, list) else [edits]:
            where = [f for f, text in files.items() if line in text]
            if len(where) != 1 or files[where[0]].count(line) != 1:
                raise AssertionError(f"fault {name}: {line!r} is not once "
                                     f"in one of {source}.cu and the "
                                     f"headers")
            text = changed.get(where[0], files[where[0]])
            changed[where[0]] = text.replace(line, planted)
        d = out / f"{prefix}{source}_{name}"
        d.mkdir(parents=True, exist_ok=True)
        for f, text in changed.items():
            (d / f).write_text(text)
        lib = out / f"{prefix}{source}_{name}.so"
        proc = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(csrc),
             "-o", str(lib), str(d / f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True)
        _fault_procs.append(proc)
        builds[name] = (proc, lib)
    return builds


#: every planted-fault build this process started (``source_fault_builds``)
_fault_procs: list = []


def stop_fault_builds() -> None:
    """End the planted-fault builds still running, each ``nvcc`` with the
    compilers it started (its own process group): a phase that raises
    leaves the builds that later phases would have read."""
    for proc in _fault_procs:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        proc.wait()


def planted(proc, lib, kernel):
    """The C entry of a planted fault's library (waits for its build), to
    stand in for the ``Kernel`` ``kernel``'s."""
    import ctypes

    log_, _ = proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"nvcc of a planted fault failed:\n{log_}")
    fn = getattr(ctypes.CDLL(str(lib)), kernel.symbol)
    fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
    return fn


def planted_all(proc, lib, kernels) -> list:
    """The C entries of a planted build's library for each ``Kernel`` of
    ``kernels`` (entries of the one source it was built from), in order;
    waits for the build."""
    import ctypes

    out = [planted(proc, lib, kernels[0])]
    for kernel in kernels[1:]:
        fn = getattr(ctypes.CDLL(str(lib)), kernel.symbol)
        fn.argtypes, fn.restype = kernel.argtypes, ctypes.c_int
        out.append(fn)
    return out


def decode_profile(cfg, params, scfg, prompts, dev) -> dict:
    """Device time by class over 3 decode steps with every slot live:
    32 greedy requests admitted and prefilled first, then 3 traced
    ``step()`` calls (each ends on the host, with its tokens) and 3
    untraced ones for the idle share."""
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.telemetry import MetricsRegistry

    eng = ServingEngine(cfg, params, scfg, registry=MetricsRegistry("p"),
                        device=dev)
    for p in prompts[:scfg.max_slots]:
        eng.submit(p)
    eng.step()
    while eng.scheduler.queue:
        eng.step()
    prof = profile_window(lambda: [eng.step() for _ in range(3)], 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        eng.step()
    step_ms = (time.perf_counter() - t0) * 1e3 / 3
    prof["untraced_step_ms"] = step_ms
    if "device_busy_ms_per_step" in prof:
        prof["idle_share"] = 1.0 - prof["device_busy_ms_per_step"] / step_ms
    return prof


def write_servable(path: str, cfg, params) -> None:
    """A servable in the layout the JAX package's ``export_servable``
    writes (``params.npz`` of the flat param names, ``servable.json`` with
    the config, the payload's sha256 and its inventory): ``params`` as f32
    under ``cfg``, whose dtype names what it serves in, as
    ``checkpoint_to_servable`` writes a bf16-trained model."""
    import dataclasses
    import os

    from paddle_tpu_torch.serving.export import MANIFEST, _sha256

    flat: dict = {}

    def walk(node, prefix=""):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = v.float().cpu().numpy()

    walk(params)
    os.makedirs(path, exist_ok=True)
    npz = os.path.join(path, "params.npz")
    np.savez(npz, **flat)
    config = dataclasses.asdict(cfg)
    config["dtype"] = str(cfg.dtype).removeprefix("torch.")
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump({"schema": "paddle_tpu.servable/1", "config": config,
                   "files": {"params.npz": _sha256(npz)},
                   "params": {k: str(v.dtype) for k, v in flat.items()},
                   "meta": {}}, f)


def serve_bf16_cli(dev, cfg32) -> dict:
    """``python -m paddle_tpu_torch.serving --servable DIR`` on the card,
    DIR a servable of seeded f32 weights (``LM_FULL`` at 2 layers) under a
    bfloat16 config: its printed tokens for three prompt lines must equal
    an in-process engine's on ``load_servable(DIR)`` (bf16 params, the
    CLI's defaults, the lines served one at a time as the CLI serves
    them), which launches the bf16 flash and paged forms and no f32 one."""
    import dataclasses
    import os

    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as FA
    from paddle_tpu_torch.ops.kernels import paged_attention as PA
    from paddle_tpu_torch.serving import (ServingConfig, ServingEngine,
                                          load_servable)
    from paddle_tpu_torch.telemetry import MetricsRegistry

    cfg = dataclasses.replace(cfg32, num_layers=2)
    path = str(_build.BUILD_DIR.parent / "servable_bf16")
    write_servable(path, dataclasses.replace(cfg, dtype=torch.bfloat16),
                   T.init_params(cfg, torch.Generator().manual_seed(3), dev))
    prompts = [[5, 17, 3], [9, 9, 9, 9], list(range(1000, 1030))]
    t0 = time.perf_counter()
    ran = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.serving", "--servable",
         path, "--max_new_tokens", "8"],
        input="".join(" ".join(map(str, p)) + "\n" for p in prompts),
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    cli_s = time.perf_counter() - t0
    if ran.returncode != 0:
        raise AssertionError(f"the serving CLI failed:\n{ran.stderr[-2000:]}")
    printed = [line for line in ran.stdout.splitlines() if line.strip()]
    cfg16, params16 = load_servable(path, device=dev)
    if cfg16.dtype != torch.bfloat16 or params16["embed"].dtype != cfg16.dtype:
        raise AssertionError(f"servable loaded as {cfg16.dtype}")
    eng = ServingEngine(cfg16, params16, ServingConfig(
        max_slots=4, page_size=16, num_pages=64, max_prompt_len=32,
        max_new_tokens=8, seed=0), registry=MetricsRegistry("cli"),
        device=dev)
    kernels = (FA.KERNEL, PA.KERNEL, FA.KERNEL_WGMMA, PA.KERNEL_BF16)
    before = [k.launches for k in kernels]
    want = []
    for p in prompts:
        eng.submit(p, max_new_tokens=8)
        eng.run_until_idle()
        want += [f"{r.id}: {' '.join(map(str, r.tokens))}"
                 for r in eng.results()]
    moved = [k.launches - b for k, b in zip(kernels, before)]
    if printed != want or moved[:2] != [0, 0] or 0 in moved[2:]:
        raise AssertionError(f"the CLI printed {printed}, the engine "
                             f"{want}; launches f32 and bf16 {moved}")
    return {"printed": printed, "cli_seconds": cli_s,
            "in_process_launches": dict(zip(
                ("flash_f32", "paged_f32", "flash_bf16", "paged_bf16"),
                moved))}


def serve_bf16(dev) -> tuple[list, dict, dict]:
    """Phase 17: row 1's bf16 form and row 2's bf16 forward at serving's
    shapes, then the LM served in bf16 beside f32 from the same seeded
    weights (the bf16 engine's are the f32 ones rounded once), phase 3's
    requests in blocks (bf16, f32, f32, bf16), each block a fresh engine
    with the launch counts zeroed just before and read just after: a bf16
    block launches the bf16 flash forward 12 times a prefill pass and the
    bf16 paged kernel 12 times a decode step and no f32 form, an f32 block
    the reverse.  Then a 3-decode-step profile of each dtype, the float64
    margin check of the first bf16 block's first SERVE_BF16_WITNESS greedy
    requests (``served_margin_check``), the share of bf16 greedy tokens
    equal to f32's, and the planted faults of PAGED_BF16_FAULTS: each must
    fail the kernel check, and "no_scale" served again the margin check.
    Last, the serving CLI on a bf16-config servable (``serve_bf16_cli``).
    Returns (kernel rows, the phase's summary, the bf16 launches by
    kernel row)."""
    import dataclasses

    from paddle_tpu_torch.core.dtype import cast_floats
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.ops.kernels import _kept
    from paddle_tpu_torch.ops.kernels import flash_attention as FA
    from paddle_tpu_torch.ops.kernels import paged_attention as PA
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.telemetry import MetricsRegistry

    # named apart from PAGED_F32_FAULTS' builds (a library of the same
    # path is the one the process loaded first)
    fault_builds = source_fault_builds("paged_attention", PAGED_BF16_FAULTS,
                                       prefix="bf16_")
    timer = Timer(dev)
    rows = [check_paged_bf16(dev, timer), check_flash_bf16_prefill(dev, timer)]
    del timer
    cfg32 = T.TransformerConfig(**LM_FULL, dtype=torch.float32, remat=False,
                                attn_impl="flash")
    cfgs = {"f32": cfg32,
            "bf16": dataclasses.replace(cfg32, dtype=torch.bfloat16)}
    params32 = T.init_params(cfg32, torch.Generator().manual_seed(0), dev)
    params = {"f32": params32,
              "bf16": cast_floats(params32, torch.bfloat16)}
    scfg, prompts, temps = serve_workload(cfg32)
    forms = {"f32": {"flash": FA.KERNEL, "paged": PA.KERNEL},
             "bf16": {"flash": FA.KERNEL_WGMMA, "paged": PA.KERNEL_BF16}}
    counters = {f"{k}_{dt}": kernel for dt, ks in forms.items()
                for k, kernel in ks.items()}
    for dt in ("bf16", "f32"):
        ServingEngine(cfgs[dt], params[dt], scfg,
                      registry=MetricsRegistry("warmup"),
                      device=dev).generate(prompts[:2], max_new_tokens=2)
    blocks: dict = {"bf16": [], "f32": []}
    tokens: dict = {}
    for dt in ("bf16", "f32", "f32", "bf16"):
        block = serve_block(cfgs[dt], params[dt], scfg, prompts, temps, dev,
                            counters)
        run = block["run"]
        n = run["launches"]
        other = "f32" if dt == "bf16" else "bf16"
        want = {f"flash_{dt}": cfg32.num_layers * run["prefill_passes"],
                f"paged_{dt}": cfg32.num_layers * run["decode_steps"],
                f"flash_{other}": 0, f"paged_{other}": 0}
        if n != want or not run["decode_steps"]:
            raise AssertionError(f"serve {dt}: launches {n} != {want}")
        if dt not in tokens:
            tokens[dt] = [block["results"][i] for i in block["ids"]]
        blocks[dt].append(run)
        torch.cuda.empty_cache()
    greedy = [i for i, tt in enumerate(temps) if tt == 0.0]
    margin = served_margin_check(
        cfgs["bf16"], params["bf16"],
        [tokens["bf16"][i] for i in greedy[:SERVE_BF16_WITNESS]])
    if not margin["ok"]:
        raise AssertionError(f"bf16 served tokens vs the float64 witness: "
                             f"{margin}")
    pairs = [(tokens["bf16"][i].tokens, tokens["f32"][i].tokens)
             for i in greedy]
    equal = {"tokens": float(np.mean([a == b for x, y in pairs
                                      for a, b in zip(x, y)])),
             "requests": float(np.mean([x == y for x, y in pairs]))}
    profiles = {dt: decode_profile(cfgs[dt], params[dt], scfg, prompts, dev)
                for dt in ("bf16", "f32")}

    faults = {}
    problem = [x.to(torch.bfloat16) if x.is_floating_point() else x
               for x in paged_inputs(dev)[:5]]
    witness_prompts = [prompts[i] for i in greedy[:SERVE_BF16_WITNESS]]
    kernel_fn = PA.KERNEL_BF16._fn or PA.KERNEL_BF16._resolve()
    for name, build in fault_builds.items():
        PA.KERNEL_BF16._fn = planted(*build, PA.KERNEL_BF16)
        _kept.forget()    # fresh tickets: a kept ticket shows on a rerun
        try:
            # two calls of other queries after the first: a kept ticket
            # leaves a row's output unwritten, which a freed buffer of the
            # same call could hold right; of the first queries it cannot
            kernel = paged_bf16_agreement(*problem)
            flipped = paged_bf16_agreement(torch.flip(problem[0], dims=(2,)),
                                           *problem[1:])
            kernel["queries_reversed"] = flipped
            kernel["agrees"] = kernel["agrees"] and flipped["agrees"]
            served = ServingEngine(
                cfgs["bf16"], params["bf16"], scfg,
                registry=MetricsRegistry("fault"), device=dev).generate(
                    witness_prompts)
        finally:
            PA.KERNEL_BF16._fn = kernel_fn
            _kept.forget()
        faults[name] = {"kernel_check": kernel, "margin_check":
                        served_margin_check(cfgs["bf16"], params["bf16"],
                                            served)}
        if kernel["agrees"]:
            raise AssertionError(f"planted fault {name} passed the kernel "
                                 f"check: {kernel}")
    if faults["no_scale"]["margin_check"]["ok"]:
        raise AssertionError(f"planted fault no_scale passed the margin "
                             f"check: {faults['no_scale']['margin_check']}")
    cli = serve_bf16_cli(dev, cfg32)

    def mean(dt, key):
        return float(np.mean([r[key] for r in blocks[dt]]))

    per_dtype = {dt: {k: mean(dt, k) for k in (
        "tokens_per_s", "ttft_ms_p50", "ttft_ms_p99", "decode_step_ms_p50",
        "prefill_ms_p50", "max_memory_allocated_bytes", "kv_pool_bytes")}
        for dt in blocks}
    summary = {"phase": "serve_bf16", "params": T.count_params(params32),
               "per_dtype_mean": per_dtype,
               "bf16_over_f32_tokens_per_s":
                   per_dtype["bf16"]["tokens_per_s"]
                   / per_dtype["f32"]["tokens_per_s"],
               "blocks": blocks, "decode_profile": profiles,
               "margin_check": margin, "planted_faults": faults,
               "greedy_equal_to_f32": equal, "cli": cli,
               "bf16_launches_per_step": {
                   "paged_bf16_a_decode_step":
                       sum(r["launches"]["paged_bf16"] for r in blocks["bf16"])
                       / sum(r["decode_steps"] for r in blocks["bf16"]),
                   "flash_bf16_a_prefill_pass":
                       sum(r["launches"]["flash_bf16"] for r in blocks["bf16"])
                       / sum(r["prefill_passes"] for r in blocks["bf16"])}}
    launches = {rows[0]["name"]: sum(r["launches"]["paged_bf16"]
                                     for r in blocks["bf16"]),
                rows[1]["name"]: sum(r["launches"]["flash_bf16"]
                                     for r in blocks["bf16"])}
    return rows, summary, launches


# -- phase 18: the last bf16 forms (rows 4, 6, 9 and 18) ---------------------

#: NLL and lse of the bf16 softmax_xent form against its twin: rtol of
#: max(1, |ref|) (f32 log-sum-exp in another summation order)
XENT_BF16_NLL_RTOL = 1e-5
#: the planted faults of the four forms, each a line of a copy of its
#: source under build/faults/: {fault: (source, Kernel attribute of the
#: module, line, planted line)}
BF16_LAST_FAULTS = {
    "lstm_fi_projection_rounded": (
        "lstm_seq", "KERNEL_FI_BF16",
        "x[j][g] += __ldg(bias + g * D + u);",
        "x[j][g] = rnd(x[j][g] + __ldg(bias + g * D + u));"),
    "gru_fi_projection_rounded": (
        "gru_seq", "KERNEL_FI_BF16",
        "kFi ? ax[j][e] + b_c[j][e & 1]",
        "kFi ? b2f(f2b(ax[j][e] + b_c[j][e & 1]))"),
    "dlogits_rounded_twice": (
        "softmax_xent", "KERNEL_BWD_BF16",
        "(expf(f[k] - l) - (j0 + k == tgt ? 1.f : 0.f)) * gr);",
        "(to_f(__float2bfloat16_rn(expf(f[k] - l)))"
        " - (j0 + k == tgt ? 1.f : 0.f)) * gr);"),
    "rows_rounded": (
        "embedding", "KERNEL_SCATTER_BF16",
        "load4(rows + p * D, d, D, vec_rows, x[e]);",
        "load4(rows + p * D, d, D, vec_rows, x[e]);"
        " for (int q = 0; q < 4; ++q)"
        " x[e][q] = to_f(__float2bfloat16_rn(x[e][q]));")}
#: the text classifier's table gradient: (ids, vocab, embed), the ids of
#: a [64, 128] batch with the 28 padded steps of each row id 0
SCATTER_BF16_SHAPE = (8192, 30000, 128)


def bf16_exact_agreement(got, want, chunk: int = 1024) -> dict:
    """:func:`bf16_agreement` with no sum term (each element within one
    bf16 ulp at the larger magnitude: two roundings of one f32 value
    computed in another order), over chunks of ``chunk`` rows so the
    float64 temporaries stay small; "ok" says whether the two agree
    (unequal on at most BF16_ULP_SHARE of the elements)."""
    parts = [(g.numel(), bf16_agreement(g, w, torch.zeros(
        g.shape, device=g.device))) for g, w in zip(got.split(chunk),
                                                    want.split(chunk))]
    total = sum(n for n, _ in parts)
    a = {k: sum(n * p[k] for n, p in parts) / total
         for k in ("share_off", "share_over_1ulp")}
    a.update({k: max(p[k] for _, p in parts)
              for k in ("max_ulps", "max_abs_err", "max_share_of_bound")})
    a["ok"] = bool(a["share_off"] <= BF16_ULP_SHARE
                   and a["max_share_of_bound"] <= 1.0)
    return a


def fi_bf16_inputs(dev, kind, b, t, e, d, seed=17) -> dict:
    """bf16 x, W_x, W_h (W_hc), peepholes and h0 (the carry), f32 bias and
    c0 of ``lstm_seq_fi`` / ``gru_seq_fi`` at [B, T, E], D, half the rows
    full, half shorter, one of length 1; a bf16 cotangent of hs and f32
    ones of the final states."""
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, k=1.0):
        return k * torch.randn(*shape, generator=gen, device=dev)

    lens = torch.randint(1, t + 1, (b,), generator=gen, device=dev)
    lens[: b // 2] = t
    lens[-1] = 1
    n = 4 if kind == "lstm" else 3
    x = {"x": rnd(b, t, e).to(bf), "lens": lens,
         "mask": (torch.arange(t, device=dev)[None, :]
                  < lens[:, None]).float(),
         "w_x": rnd(e, n * d, k=e ** -0.5).to(bf), "b": rnd(n * d, k=0.1)}
    if kind == "lstm":
        x.update(w_h=rnd(d, 4 * d, k=d ** -0.5).to(bf),
                 peep=rnd(3, d, k=0.1).to(bf), h0=rnd(b, d, k=0.5).to(bf),
                 c0=rnd(b, d, k=0.5), dhs=rnd(b, t, d).to(bf),
                 dhT=rnd(b, d), dcT=rnd(b, d))
    else:
        x.update(w_h=rnd(d, 2 * d, k=d ** -0.5).to(bf),
                 w_hc=rnd(d, d, k=d ** -0.5).to(bf),
                 h0=rnd(b, d, k=0.5).to(bf), dhs=rnd(b, t, d).to(bf),
                 dhT=rnd(b, d))
    return x


def fi_args(kind, x) -> tuple:
    """The fused-input forward's operands in order, without the flags."""
    keys = (("x", "mask", "w_x", "b", "w_h", "peep", "h0", "c0")
            if kind == "lstm" else ("x", "mask", "w_x", "b", "w_h", "w_hc",
                                    "h0"))
    return tuple(x[k] for k in keys)


def fi_projection(x) -> tuple:
    """(x W_x + b in float64, |x| |W_x|): the in-loop projection exactly
    and its sum of |terms|, per [B, T, nD] entry."""
    xs, w_x = x["x"].double(), x["w_x"].double()
    return (torch.matmul(xs, w_x) + x["b"].double(),
            torch.matmul(xs.abs(), w_x.abs()))


def fi_bf16_fwd_check(kind, x, reverse, out, xw64=None, proj=None) -> dict:
    """A fused-input forward's outputs ``out`` (hs, cs, gates, h_T, c_T /
    hs, urc, h_T) against the forced float64 steps from their own carries
    over the exact projection (its |terms| in the sum term, K = E + D):
    the LSTM's ``lstm_bf16_fwd_agreement`` with h_T, c_T within
    LSTM_BF16_SUM_RTOL, the GRU's ``gru_bf16_fwd_agreement`` with h_T
    within GRU_BF16_STATE_RTOL; the gate slab where ``out`` has one."""
    if xw64 is None:
        xw64, proj = fi_projection(x)
    e, t = x["x"].shape[2], x["x"].shape[1]
    d = x["w_h"].shape[0]
    last = 0 if reverse else t - 1
    if kind == "lstm":
        hs, cs, gates, h_t, c_t = out
        forced = lstm_bf16_forced_fwd(xw64, x["mask"], x["w_h"], x["peep"],
                                      x["h0"], x["c0"], reverse, hs, cs, proj)
        a = lstm_bf16_fwd_agreement(hs, cs, forced, e + d, gates)
        a["h_T"] = rel_norm(h_t, forced["h"][:, last])
        a["c_T"] = rel_norm(c_t, forced["c"][:, last])
        a["ok"] = a["ok"] and max(a["h_T"], a["c_T"]) <= LSTM_BF16_SUM_RTOL
        return a
    hs, urc, h_t = out
    forced = gru_bf16_forced_fwd(xw64, x["mask"], x["w_h"], x["w_hc"],
                                 x["h0"], reverse, hs, e + d, proj)
    a = gru_bf16_fwd_agreement(hs, forced, e + d, urc)
    a["h_T"] = rel_norm(h_t, forced["h"][:, last])
    a["ok"] = a["ok"] and a["h_T"] <= GRU_BF16_STATE_RTOL
    return a


def fi_bf16_case(kind, x, reverse) -> dict:
    """The bf16 fused-input forward (``lstm_fi_fwd_bf16`` /
    ``gru_fi_fwd_bf16``) on one problem, with and without its gate slab,
    against its forced float64 steps (``fi_bf16_fwd_check``), a rerun and
    the slab form in the same bits, the twin's planted faults (the
    projection rounded to bf16, the gate halves swapped; the GRU's r h
    unrounded) outside the criterion; then the backward the path pairs
    with it, the bf16 remat backward over the f32 projection
    (``lstm_bf16_case`` / ``gru_bf16_case`` with xw), against its forced
    steps.  {"fwd", "bwd", "faults", "bits", "ok", "args"}."""
    from paddle_tpu_torch.ops.kernels import gru as GK
    from paddle_tpu_torch.ops.kernels import lstm as LK

    mod = LK if kind == "lstm" else GK
    args = fi_args(kind, x) + (reverse,)
    got = mod._fi_fwd_kernel(*args, False)
    again = mod._fi_fwd_kernel(*args, False)
    slab = mod._fi_fwd_kernel(*args, True)
    gate = 2 if kind == "lstm" else 1
    out = {"bits": {
        "fwd_rerun": all(torch.equal(a, b) for i, (a, b) in
                         enumerate(zip(got, again)) if i != gate),
        "fwd_gates_form": all(torch.equal(a, b) for i, (a, b) in
                              enumerate(zip(got, slab)) if i != gate)},
        "faults": {}}
    del again
    xw64, proj = fi_projection(x)
    out["fwd"] = fi_bf16_fwd_check(kind, x, reverse, slab, xw64, proj)
    del slab
    wraps = ((("projection_rounded", projection_rounded),
              ("halves_swapped", halves_swapped)) if kind == "lstm" else
             (("projection_rounded", gru_projection_rounded),
              ("halves_swapped", gru_halves_swapped),
              ("rh_unrounded", gru_unrounded)))
    for name, wrap in wraps:
        bad = list(wrap(lambda: mod._fi_fwd_plain(*args, False)))
        out["faults"][name] = fi_bf16_fwd_check(kind, x, reverse, bad, xw64,
                                                proj)
    del xw64, proj
    xw = mod._project_xw(x["x"], x["w_x"], x["b"])
    if kind == "lstm":
        cx = {k: x[k] for k in ("mask", "w_h", "peep", "h0", "c0", "dhs",
                                "dhT", "dcT")}
        cx["hs"], cx["cs"] = got[0], got[1]
        case = lstm_bf16_case(cx, reverse, xw)
    else:
        cx = {k: x[k] for k in ("mask", "w_h", "w_hc", "h0", "dhs", "dhT")}
        cx["hs"] = got[0]
        case = gru_bf16_case(cx, reverse, xw)
    out["bits"]["bwd_rerun"] = case["bits"]["bwd_rerun"]
    out["bwd"] = case["bwd"]
    out["faults"].update({f"bwd_{k}": v for k, v in case["faults"].items()})
    out["ok"] = bool(out["fwd"]["ok"] and out["bwd"]["ok"])
    out["args"] = args
    return out


def check_fi_bf16_kernels(dev, timer) -> tuple[list, dict]:
    """Rows 6 and 9 in bf16 at the path's shapes (``RAW_RNN``, both
    directions): ``fi_bf16_case`` must hold (the forms and their paired
    backward against their forced steps, reruns and the slab form in the
    same bits, every twin fault outside).  Timed (2 B an element, 989
    TFLOP/s): the form with the L2 flushed (the mean of the directions)
    and alone (a trace), its bf16 twin, its bound, the unfused bf16 route's
    forward (the f32 projection rounded to bf16, then the bf16 sequence
    forward: ``unfused_ms``, and that kernel alone) and bf16 cuDNN
    ``nn.LSTM`` / ``nn.GRU`` with the input projection (not the same cell:
    a yardstick of scale)."""
    from paddle_tpu_torch.ops.kernels import gru as GK
    from paddle_tpu_torch.ops.kernels import lstm as LK

    bf = torch.bfloat16
    rows, summary = [], {"phase": "fi_bf16_kernels",
                         "criterion": "forced float64 steps (chip_smoke.py)"}
    for kind, b, t, e, d in RAW_RNN:
        mod = LK if kind == "lstm" else GK
        x = fi_bf16_inputs(dev, kind, b, t, e, d)
        summary[kind] = {}
        calls = []
        for key, reverse in (("forward", False), ("reverse", True)):
            case = fi_bf16_case(kind, x, reverse)
            if not (all(case["bits"].values()) and case["ok"]
                    and not any(f["ok"] for f in case["faults"].values())):
                raise AssertionError(f"bf16 {kind}_seq_fi {key}: " + str(
                    {k: case[k] for k in ("bits", "fwd", "bwd", "faults")}))
            summary[kind][key] = {k: case[k] for k in ("fwd", "bwd", "faults",
                                                       "bits")}
            args = case["args"]
            xw = mod._project_xw(x["x"], x["w_x"], x["b"]).to(bf)
            rec = ((x["w_h"], x["peep"], x["h0"], x["c0"]) if kind == "lstm"
                   else (x["w_h"], x["w_hc"], x["h0"]))
            calls.append((
                lambda a=args: mod._fi_fwd_kernel(*a, False),
                lambda a=args: mod._fi_fwd_plain(*a, False),
                lambda r=reverse, xw=xw, rec=rec: mod._fwd_kernel(
                    xw, x["mask"], *rec, r, False)))
            del case
        cudnn = (torch.nn.LSTM if kind == "lstm" else torch.nn.GRU)(
            e, d, batch_first=True).to(dev, bf)
        cudnn.flatten_parameters()

        def lib(cudnn=cudnn, xs=x["x"]):
            with torch.no_grad():
                return cudnn(xs)

        steps = float(x["mask"].sum().item())
        n = 4 if kind == "lstm" else 3
        cell = (25.0 if kind == "lstm" else 20.0) * steps * d
        # x, W_x, W_h (W_hc), peep, h0 bf16 and b, mask, c0 f32 in; hs
        # bf16, cs, h_T (c_T) f32 out
        rec_w = 4 * d * d + 3 * d if kind == "lstm" else 3 * d * d
        states = 2 if kind == "lstm" else 1
        nbytes = (2 * (b * t * e + e * n * d + rec_w + b * d)
                  + 4 * (n * d + b * t + (states - 1) * b * d)
                  + 2 * b * t * d + 4 * ((states - 1) * b * t * d
                                         + states * b * d))
        flops = steps * (2.0 * e * n * d + 2.0 * d * n * d) + cell
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        ms = [timer(c[0]) for c in calls]
        unfused = [timer(c[2]) for c in calls]
        rows.append({
            "name": f"{kind}_seq_fi_fwd_bf16", "route": "cuda",
            "source": f"paddle_tpu_torch/ops/kernels/csrc/{kind}_seq.cu",
            "replaces": ("paddle_tpu/ops/pallas/lstm.py:686" if kind == "lstm"
                         else "paddle_tpu/ops/pallas/gru.py:452"),
            "shape": [b, t, e, d], "dtype": "bfloat16",
            "max_abs_err": max(summary[kind][k]["fwd"]["max_abs_err"]
                               for k in ("forward", "reverse")),
            "ms": sum(ms) / 2,
            "ms_by_direction": {"forward": ms[0], "reverse": ms[1]},
            "alone_ms": device_ms([c[0] for c in calls],
                                  f"{kind}_fwd_bf16_kernel<true"),
            "plain_ms": sum(timer(c[1], iters=2) for c in calls) / 2,
            "unfused_ms": sum(unfused) / 2,
            "unfused_alone_ms": device_ms([c[2] for c in calls],
                                          f"{kind}_fwd_bf16_kernel<false"),
            "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
            "library_ms": timer(lib),
            "library_note": (f"bf16 cuDNN nn.{'LSTM' if kind == 'lstm' else 'GRU'}"
                             " forward, input projection included: not the "
                             "same cell")})
        del cudnn, calls, x
        torch.cuda.synchronize()
    return rows, summary


def xent_bf16_agreement(logits, targets, g) -> dict:
    """The bf16 softmax_xent forms against their twins on the same bf16
    logits: lse and the NLL (f32) within XENT_BF16_NLL_RTOL x max(1,
    |ref|); dlogits (bf16, the backward twin over the kernel's own lse)
    unequal on at most BF16_ULP_SHARE of the entries, each within one bf16
    ulp; reruns in the same bits.  "ok" says whether they agree."""
    from paddle_tpu_torch.ops.kernels import softmax_xent as SX

    nll, lse = SX._fwd_kernel(logits, targets)
    again = SX._fwd_kernel(logits, targets)
    d1 = SX._bwd_kernel(logits, targets, lse, g)
    d2 = SX._bwd_kernel(logits, targets, lse, g)
    torch.cuda.synchronize()
    a = {"reruns_bit_identical": bool(
        torch.equal(nll, again[0]) and torch.equal(lse, again[1])
        and torch.equal(d1, d2))}
    del again, d2
    plain = SX._fwd_plain(logits, targets)
    for name, got, want in zip(("nll", "lse"), (nll, lse), plain):
        a[name] = float(((got - want).abs()
                         / want.abs().clamp(min=1.0)).max())
    a["nll_max_abs_err"] = float((nll - plain[0]).abs().max())
    del plain
    a["dlogits"] = bf16_exact_agreement(
        d1, SX._bwd_plain(logits, targets, lse, g))
    a["ok"] = bool(a["reruns_bit_identical"]
                   and max(a["nll"], a["lse"]) <= XENT_BF16_NLL_RTOL
                   and a["dlogits"]["ok"])
    return a


def xent_bf16_inputs(dev, seed=13):
    """The LM's logits (``xent_inputs``) rounded to bf16, their targets and
    a seeded per-row cotangent (not a power of two, so a rounding of the
    gradient before the product shows)."""
    logits, targets = xent_inputs(dev, seed)
    logits = logits.to(torch.bfloat16)
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    return logits, targets, torch.randn(logits.shape[0], generator=gen,
                                        device=dev)


def check_xent_bf16_kernels(dev, timer) -> tuple[list, dict]:
    """Row 4's bf16 forms at the LM's logits in bf16 (``XENT_SHAPE``, rows
    2-byte aligned: V is odd): ``xent_bf16_agreement`` must hold; each
    timed with the L2 flushed and alone (a trace) beside its twin, its
    bound (one bf16 read; one read and one write) and
    ``F.cross_entropy(reduction="none")`` on the bf16 logits (forward;
    backward)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import softmax_xent as SX

    logits, targets, g = xent_bf16_inputs(dev)
    n, v = logits.shape
    a = xent_bf16_agreement(logits, targets, g)
    if not a["ok"]:
        raise AssertionError(f"bf16 softmax_xent vs its twins: {a}")
    torch.cuda.empty_cache()
    _, lse = SX._fwd_kernel(logits, targets)
    leaf = logits.clone().requires_grad_()
    ce = F.cross_entropy(leaf, targets, reduction="none")

    def lib_fwd():
        with torch.no_grad():
            return F.cross_entropy(logits, targets, reduction="none")

    def lib_bwd():
        return torch.autograd.grad(ce, leaf, g.to(ce.dtype),
                                   retain_graph=True)

    elems = float(n) * v
    fwd = lambda: SX._fwd_kernel(logits, targets)  # noqa: E731
    bwd = lambda: SX._bwd_kernel(logits, targets, lse, g)  # noqa: E731
    rows = []
    for name, fn, plain, lib, key, nbytes in (
            # bf16 logits and targets in, lse and nll f32 out
            ("softmax_xent_fwd_bf16", fwd,
             lambda: SX._fwd_plain(logits, targets), lib_fwd,
             "lse_kernel<__nv_bfloat16", 2 * elems + 8 * n + 2 * 4 * n),
            # logits bf16, targets, lse, g in, dlogits bf16 out
            ("softmax_xent_bwd_bf16", bwd,
             lambda: SX._bwd_plain(logits, targets, lse, g), lib_bwd,
             "dlogits_bf16_kernel", 2 * 2 * elems + 8 * n + 2 * 4 * n)):
        bound_ms, bound_by = bound(nbytes, 4 * elems, BF16_FLOPS_PER_S)
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/ops/kernels/csrc/softmax_xent.cu",
            "replaces": ("paddle_tpu/ops/pallas/softmax_xent.py:73"
                         if name.endswith("fwd_bf16")
                         else "paddle_tpu/ops/pallas/softmax_xent.py:120"),
            "shape": [n, v], "dtype": "bfloat16",
            "max_abs_err": (a["nll_max_abs_err"] if name.endswith("fwd_bf16")
                            else a["dlogits"]["max_abs_err"]),
            "ms": timer(fn), "alone_ms": device_ms([fn], key),
            "plain_ms": timer(plain, iters=5),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": timer(lib, iters=10),
            "library_note": "F.cross_entropy(reduction='none') on bf16 logits"
                            + (" backward" if name.endswith("bwd_bf16")
                               else "")})
    del ce, leaf, logits
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows, {"phase": "xent_bf16_kernels", "agreement": a,
                  "nll_rtol": XENT_BF16_NLL_RTOL}


def scatter_bf16_inputs(dev, seed=18):
    """A bf16 table [30000, 128], the ids of a [64, 128] batch whose rows
    end in 28 padded steps of id 0 (``SCATTER_BF16_SHAPE``) and rows in
    f32 and rounded to bf16."""
    n, vocab, embed = SCATTER_BF16_SHAPE
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn(vocab, embed, generator=gen, device=dev).to(
        torch.bfloat16)
    ids = torch.randint(0, vocab, (64, n // 64), generator=gen, device=dev)
    ids[:, 100:] = 0
    rows = torch.randn(n, embed, generator=gen, device=dev)
    return table, ids.reshape(-1), rows, rows.to(torch.bfloat16)


def scatter_bf16_agreement(table, ids, rows) -> dict:
    """``embedding_scatter_add`` of a bf16 table against its twin on the
    same operands: unequal on at most BF16_ULP_SHARE of the entries, each
    within one bf16 ulp (the run sums are f32 in another order, then
    rounded once), and a rerun in the same bits."""
    from paddle_tpu_torch.ops.kernels import embedding as EK

    got = EK.embedding_scatter_add(table, ids, rows)
    again = EK.embedding_scatter_add(table, ids, rows)
    a = bf16_exact_agreement(
        got, EK.embedding_scatter_add_reference(table, ids, rows))
    a["rerun_bit_identical"] = bool(torch.equal(got, again))
    a["ok"] = a["ok"] and a["rerun_bit_identical"]
    return a


def check_scatter_bf16_kernels(dev, timer) -> tuple[list, dict]:
    """Row 18's bf16 form at the text row's table gradient (8,192 ids into
    [30000, 128], 1,792 of them padding id 0), with f32 and with bf16
    rows: ``scatter_bf16_agreement`` must hold; timed with the L2 flushed
    and alone (a trace: the memset and the three passes, each's device
    time and their sum) beside its twin, its bound (the table read and
    written, the rows and ids read: the function's bytes) and
    ``index_add`` on the bf16 table with bf16 rows."""
    from paddle_tpu_torch.ops.kernels import embedding as EK

    table, ids, rows32, rows16 = scatter_bf16_inputs(dev)
    n, (vocab, embed) = ids.shape[0], table.shape
    rows, summary = [], {"phase": "scatter_bf16_kernels",
                         "unique_ids": int(torch.unique(ids).numel())}
    for label, r in (("f32", rows32), ("bf16", rows16)):
        a = scatter_bf16_agreement(table, ids, r)
        if not a["ok"]:
            raise AssertionError(f"bf16 scatter-add ({label} rows) vs its "
                                 f"twin: {a}")
        summary[f"{label}_rows"] = a
        fn = lambda r=r: EK.embedding_scatter_add(table, ids, r)  # noqa: E731
        nbytes = (2 * 2 * vocab * embed + r.element_size() * n * embed
                  + 8 * n)
        bound_ms, bound_by = bound(nbytes, float(n) * embed,
                                   BF16_FLOPS_PER_S)
        passes = device_passes_ms(
            [fn], SCATTER_PASSES + ("sum_runs_kernel<__nv_bfloat16",))
        rows.append({
            "name": ("embedding_scatter_add_bf16" if label == "f32"
                     else "embedding_scatter_add_bf16_rows_bf16"),
            "route": "cuda",
            "source": "paddle_tpu_torch/ops/kernels/csrc/embedding.cu",
            "replaces": "paddle_tpu/ops/pallas/tpp/embedding.py:217",
            "shape": [n, vocab, embed],
            "dtype": f"bfloat16 table, {label} rows",
            "max_abs_err": a["max_abs_err"], "ms": timer(fn),
            "host_ms": host_ms(fn),
            "alone_ms": passes["total"], "passes_ms": passes,
            "plain_ms": timer(lambda r=r: EK.embedding_scatter_add_reference(
                table, ids, r)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": timer(lambda: table.index_add(0, ids, rows16)),
            "library_note": "index_add on the bf16 table, bf16 rows"})
    torch.cuda.synchronize()
    return rows, summary


class twins_on_card:
    """Within the block, the fused-input Functions of ``mods`` take their
    plain twins on CUDA tensors too (the forward and the backward), so a
    run through the same entries gives the twin's result on the card."""

    def __init__(self, *mods):
        self.mods = mods

    def __enter__(self):
        self.saved = [(m, m._fi_fwd_kernel, m._bwd_kernel) for m in self.mods]
        for m in self.mods:
            m._fi_fwd_kernel, m._bwd_kernel = m._fi_fwd_plain, m._bwd_plain

    def __exit__(self, *exc):
        for m, fwd, bwd in self.saved:
            m._fi_fwd_kernel, m._bwd_kernel = fwd, bwd


def raw_rnn_bf16_path(dev, steps=RAW_RNN_STEPS) -> tuple[dict, dict]:
    """The raw-input recurrences in bf16 through the entries a user calls,
    ``ops.rnn.lstm`` (reverse off and on) and ``ops.rnn.gru``, on bf16 x,
    weights, bias and initial state at ``RAW_RNN``'s widths: a forward and
    backward against a fixed bf16 cotangent ``steps`` times with the
    launch counts zeroed just before and read just after (exactly
    ``steps`` bf16 fused-input forwards and ``steps`` bf16 remat backwards,
    no f32 fused-input, no sequence-forward, no stored-gates backward
    launch); every output and
    gradient leaf against a float64 witness of the plain composition on
    the card: its relative distance at most 2x the bf16 twins' (the same
    entries with the twins on the card) plus 2^-8, with the ragged mask
    ignored as a planted fault that must exceed it; the fused route
    against the unfused bf16 one (the bf16 projection and the sequence
    forms, the backward stored-gates) in blocks of ``steps``: fused,
    unfused, unfused, fused.
    Returns (the phase's result, {kind: bf16 fused-input launches})."""
    from paddle_tpu_torch.ops import rnn as R
    from paddle_tpu_torch.ops.kernels import gru as GK
    from paddle_tpu_torch.ops.kernels import lstm as LK

    bf = torch.bfloat16
    t0 = time.perf_counter()
    out = {"phase": "raw_rnn_bf16_path", "steps": steps,
           "criterion": "per leaf ||x - x64|| / ||x64|| <= 2 x the twins' "
                        "+ 2^-8", "cases": {}}
    launches = {"lstm": 0, "gru": 0}
    for kind, b, t, e, d in RAW_RNN:
        mod = LK if kind == "lstm" else GK
        for reverse in ((False, True) if kind == "lstm" else (False,)):
            x, lens, w, init, cts = raw_rnn_inputs(dev, kind, b, t, e, d)
            x, w = x.to(bf), {k: v.to(bf) for k, v in w.items()}
            init, cts = [v.to(bf) for v in init], [c.to(bf) for c in cts]
            label = f"{kind}{'_reverse' if reverse else ''}"
            if not R.fused_input_fits(x, mod, w["w_x"],
                                      *(v for k, v in w.items()
                                        if k.startswith("w_h"))):
                raise AssertionError(f"{label} bf16: the predicate refuses "
                                     "the path's shape")
            wide = raw_rnn_grads(
                raw_rnn_reference, kind, x.double(), lens,
                {k: v.double() for k, v in w.items()},
                [v.double() for v in init], [c.double() for c in cts],
                reverse)
            with twins_on_card(mod):
                twin = raw_rnn_grads(raw_rnn_call, kind, x, lens, w, init,
                                     cts, reverse)
            kernels = (mod.KERNEL_FI_BF16, mod.KERNEL_BWD_BF16,
                       mod.KERNEL_BWD_STORED_BF16, mod.KERNEL_FI,
                       mod.KERNEL_FWD_BF16, mod.KERNEL_FWD)

            def run(n, kernels=kernels, kind=kind, x=x, lens=lens, w=w,
                    init=init, cts=cts, reverse=reverse):
                ms = []
                for k in kernels:
                    k.launches = 0
                for _ in range(n):
                    start = time.perf_counter()
                    got = raw_rnn_grads(raw_rnn_call, kind, x, lens, w, init,
                                        cts, reverse)
                    torch.cuda.synchronize()
                    ms.append(1e3 * (time.perf_counter() - start))
                return got, ms, tuple(k.launches for k in kernels)

            def errors(got, wide=wide, twin=twin):
                return {k: {"got": rel_norm(got[k], wide[k]),
                            "twin": rel_norm(twin[k], wide[k])}
                        for k in wide}

            def holds(errs):
                return all(v["got"] <= 2 * v["twin"] + 2.0 ** -8
                           for v in errs.values())

            got, fused_ms, n_fused = run(steps)
            if n_fused != (steps, steps, 0, 0, 0, 0):
                raise AssertionError(
                    f"{label} bf16: launches (bf16 fused-input, bf16 remat "
                    f"and stored backward, f32 fused-input, bf16 and f32 "
                    f"sequence forward) = {n_fused}, want ({steps}, "
                    f"{steps}, 0, 0, 0, 0)")
            launches[kind] += n_fused[0]
            errs = errors(got)
            if not holds(errs):
                raise AssertionError(f"{label} bf16 vs the float64 witness: "
                                     f"{errs}")
            again = raw_rnn_grads(raw_rnn_call, kind, x, lens, w, init, cts,
                                  reverse)
            if not all(torch.equal(got[k], again[k]) for k in got):
                raise AssertionError(f"{label} bf16: a rerun differs in bits")
            on = R.fused_input_on
            R.fused_input_on = lambda device: False
            try:
                unfused, unfused_ms, n_unfused = run(steps)
                unfused_ms += run(steps)[1]
            finally:
                R.fused_input_on = on
            # the unfused route's backward in its stored-gates form
            if n_unfused != (0, 0, steps, 0, steps, 0):
                raise AssertionError(f"{label} bf16: unfused launches "
                                     f"{n_unfused}")
            unfused_errs = errors(unfused)
            fused_ms += run(steps)[1]
            full = torch.full_like(lens, t)
            unmasked = errors(raw_rnn_grads(raw_rnn_call, kind, x, full, w,
                                            init, cts, reverse))
            if holds(unmasked):
                raise AssertionError(f"{label} bf16: the mask_ignored "
                                     f"control passed the witness")
            out["cases"][label] = {
                "shape": [b, t, e, d], "reverse": reverse,
                "lengths": "half full, half shorter, one of length 1",
                "launches_fused": n_fused, "launches_unfused": n_unfused,
                "witness_by_leaf": errs,
                "unfused_holds": holds(unfused_errs),
                "unfused_witness_by_leaf": unfused_errs,
                "control_mask_ignored_worst": max(
                    v["got"] for v in unmasked.values()),
                "fused_step_ms_p50": float(np.percentile(fused_ms, 50)),
                "unfused_step_ms_p50": float(np.percentile(unfused_ms, 50)),
                "fused_ms": fused_ms, "unfused_ms": unfused_ms}
            del got, again, unfused, wide, twin
            torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    return out, launches


def scatter_bf16_path(dev, steps=10) -> tuple[dict, dict]:
    """``embedding_scatter_add`` on the bf16 table of
    ``scatter_bf16_inputs``, ``steps`` calls with f32 rows and ``steps``
    with bf16 rows, the launches zeroed just before and read just after
    each (exactly ``steps`` of the bf16 form, none of the f32 one); the
    last result of each against its twin (``scatter_bf16_agreement``'s
    criterion).  Returns (the phase's result, {rows' dtype: launches})."""
    from paddle_tpu_torch.ops.kernels import embedding as EK

    table, ids, rows32, rows16 = scatter_bf16_inputs(dev)
    out, launches = {"phase": "scatter_bf16_path", "steps": steps}, {}
    for label, r in (("f32", rows32), ("bf16", rows16)):
        EK.KERNEL_SCATTER_BF16.launches = EK.KERNEL_SCATTER.launches = 0
        ms = []
        for _ in range(steps):
            start = time.perf_counter()
            got = EK.embedding_scatter_add(table, ids, r)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - start))
        n = (EK.KERNEL_SCATTER_BF16.launches, EK.KERNEL_SCATTER.launches)
        if n != (steps, 0):
            raise AssertionError(f"bf16 scatter-add ({label} rows) launches "
                                 f"{n}, want ({steps}, 0)")
        a = bf16_exact_agreement(got, EK.embedding_scatter_add_reference(
            table, ids, r))
        if not a["ok"]:
            raise AssertionError(f"bf16 scatter-add path ({label} rows): {a}")
        launches[label] = n[0]
        out[f"{label}_rows"] = {"launches": n, "agreement": a,
                                "call_ms_p50": float(np.percentile(ms, 50)),
                                "call_ms": ms}
    return out, launches


def bf16_last_faults(dev, builds) -> dict:
    """Each planted fault of BF16_LAST_FAULTS, its library in place of its
    form's C entry, must fail its form's check: the fused-input forwards'
    ``fi_bf16_fwd_check`` (forward direction), ``xent_bf16_agreement``,
    ``scatter_bf16_agreement`` with f32 rows."""
    from paddle_tpu_torch.ops.kernels import embedding as EK
    from paddle_tpu_torch.ops.kernels import gru as GK
    from paddle_tpu_torch.ops.kernels import lstm as LK
    from paddle_tpu_torch.ops.kernels import softmax_xent as SX

    mods = {"lstm_seq": LK, "gru_seq": GK, "softmax_xent": SX,
            "embedding": EK}
    out = {}
    for name, (source, attr, _, _) in BF16_LAST_FAULTS.items():
        mod = mods[source]
        kernel = getattr(mod, attr)
        fn = kernel._fn or kernel._resolve()
        kernel._fn = planted(*builds[name], kernel)
        try:
            if source in ("lstm_seq", "gru_seq"):
                kind = source.split("_")[0]
                _, b, t, e, d = next(r for r in RAW_RNN if r[0] == kind)
                x = fi_bf16_inputs(dev, kind, b, t, e, d)
                a = fi_bf16_fwd_check(kind, x, False, list(
                    mod._fi_fwd_kernel(*fi_args(kind, x), False, True)))
            elif source == "softmax_xent":
                a = xent_bf16_agreement(*xent_bf16_inputs(dev))
            else:
                table, ids, rows32, _ = scatter_bf16_inputs(dev)
                a = scatter_bf16_agreement(table, ids, rows32)
        finally:
            kernel._fn = fn
        torch.cuda.empty_cache()
        out[name] = a
        if a["ok"]:
            raise AssertionError(f"planted fault {name} passed its form's "
                                 f"check: {a}")
    return out


def bf16_last_forms(dev) -> tuple[list, dict, dict]:
    """Phase 18: rows 4, 6, 9 and 18 in bf16.  The planted faults' builds
    start first; then each form against its twin at its path's shape
    (``check_fi_bf16_kernels``, ``check_xent_bf16_kernels``,
    ``check_scatter_bf16_kernels``), the three bf16 path legs
    (``raw_rnn_bf16_path``, ``xent_path`` in bf16, ``scatter_bf16_path``),
    and last the planted faults (``bf16_last_faults``).  Returns (kernel
    rows, the phase's summary, {row name: launches on its path leg})."""
    builds = {}
    for name, (source, _, line, plant) in BF16_LAST_FAULTS.items():
        builds.update(source_fault_builds(source, {name: (line, plant)}))
    t0 = time.perf_counter()
    timer = Timer(dev)
    rows, fi_summary = check_fi_bf16_kernels(dev, timer)
    xent_rows, xent_summary = check_xent_bf16_kernels(dev, timer)
    scatter_rows, scatter_summary = check_scatter_bf16_kernels(dev, timer)
    del timer
    rows += xent_rows + scatter_rows
    torch.cuda.empty_cache()
    rnn, rnn_n = raw_rnn_bf16_path(dev)
    torch.cuda.empty_cache()
    xent, xent_n = xent_path(dev, dtype=torch.bfloat16)
    scatter, scatter_n = scatter_bf16_path(dev)
    torch.cuda.empty_cache()
    faults = bf16_last_faults(dev, builds)
    summary = {"phase": "bf16_last_forms", "fi": fi_summary,
               "xent": xent_summary, "scatter": scatter_summary,
               "paths": {"raw_rnn": rnn, "xent": xent, "scatter": scatter},
               "planted_faults": faults,
               "seconds": time.perf_counter() - t0}
    launches = {"lstm_seq_fi_fwd_bf16": rnn_n["lstm"],
                "gru_seq_fi_fwd_bf16": rnn_n["gru"],
                "softmax_xent_fwd_bf16": xent_n[0],
                "softmax_xent_bwd_bf16": xent_n[1],
                "embedding_scatter_add_bf16": scatter_n["f32"],
                "embedding_scatter_add_bf16_rows_bf16": scatter_n["bf16"]}
    return rows, summary, launches


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: torch sees no CUDA card; nothing to run")
        return 2
    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.ops.kernels import _build

    dev = resolve_device(None)    # cuda:0, TF32 off for matmul and cuDNN
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"card: {smi} | torch: {kind} x{count} | torch {torch.__version__}"
          f" cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    # the Hopper tile's planted faults (phase 13), the f32 flash and paged
    # kernels' (phase 2) and the f32 LSTM forward product's (phases 6, 7,
    # 12) build beside the kernels
    faults = wgmma_fault_builds()
    flash_faults = flash_f32_fault_builds()
    paged_faults = source_fault_builds("paged_attention", PAGED_F32_FAULTS)
    lstm_faults = source_fault_builds("lstm_seq", LSTM_FWD_FAULTS)
    sources = _build.build()
    wgmma_libs = built(faults)
    print(json.dumps({"phase": "build", "sources": sorted(sources),
                      "wgmma_faults": len(wgmma_libs),
                      "seconds": time.perf_counter() - t0}), flush=True)

    timer = Timer(dev)
    rows = [check_flash(dev, timer), check_paged(dev, timer, paged_faults)]
    bwd_rows, bwd_summary = check_flash_backward(dev, timer, flash_faults)
    resident = check_resident()
    conv_rows = check_brgemm(dev, timer)
    cv_rows, cudnn = check_conv(dev, timer)
    conv_rows += cv_rows
    for row in rows + bwd_rows + conv_rows:
        print(json.dumps({"phase": "kernel", **row}), flush=True)
    print(json.dumps({"phase": "gemm_tile", "resident_blocks": resident,
                      "cudnn_kernels": cudnn}), flush=True)
    print(json.dumps(bwd_summary), flush=True)
    del timer
    print(json.dumps(check_conv_backward(dev)), flush=True)

    serve, flash_n, paged_n = serve_end_to_end(dev)
    print(json.dumps(serve), flush=True)
    update_rows, update_summary = check_update_kernels(dev, Timer(dev))
    for row in update_rows:
        print(json.dumps({"phase": "kernel", **row}), flush=True)
    print(json.dumps(update_summary), flush=True)
    torch.cuda.empty_cache()
    train, br_n, cv_n, up_resnet_n = train_end_to_end(dev)
    print(json.dumps(train), flush=True)
    torch.cuda.empty_cache()
    lm, (fwd_n, dq_n, dkv_n) = train_lm(dev)
    print(json.dumps(lm), flush=True)
    torch.cuda.empty_cache()
    text_rows, text_summary = check_text_kernels(dev, Timer(dev),
                                                 fwd_faults=lstm_faults)
    for row in text_rows:
        print(json.dumps({"phase": "kernel", **row}), flush=True)
    print(json.dumps(text_summary), flush=True)
    text, text_n = train_text(dev)
    print(json.dumps(text), flush=True)
    torch.cuda.empty_cache()
    crnn_rows, crnn_summary = check_crnn_kernels(dev, Timer(dev),
                                                 fwd_faults=lstm_faults)
    for row in crnn_rows:
        print(json.dumps({"phase": "kernel", **row}), flush=True)
    print(json.dumps(crnn_summary), flush=True)
    crnn, crnn_n = train_crnn(dev)
    print(json.dumps(crnn), flush=True)
    torch.cuda.empty_cache()
    nmt_rows, nmt_summary = check_nmt_kernels(dev, Timer(dev))
    for row in nmt_rows:
        print(json.dumps({"phase": "kernel", **row}), flush=True)
    print(json.dumps(nmt_summary), flush=True)
    nmt, nmt_n = train_nmt(dev)
    print(json.dumps(nmt), flush=True)
    torch.cuda.empty_cache()
    vgg_row, vgg_summary = check_vgg_kernels(dev, Timer(dev))
    print(json.dumps({"phase": "kernel", **vgg_row}), flush=True)
    print(json.dumps(vgg_summary), flush=True)
    vgg, stats_n, up_vgg_n = train_vgg(dev)
    print(json.dumps(vgg), flush=True)
    torch.cuda.empty_cache()
    nets = bench_nets(dev)
    print(json.dumps(nets), flush=True)
    torch.cuda.empty_cache()
    ctr, (up_ctr_n, rows_n) = train_ctr(dev)
    print(json.dumps(ctr), flush=True)
    torch.cuda.empty_cache()
    xent_rows, xent_summary = check_xent_kernels(dev, Timer(dev))
    for row in xent_rows:
        print(json.dumps({"phase": "kernel", **row}), flush=True)
    print(json.dumps(xent_summary), flush=True)
    xent, xent_n = xent_path(dev)
    print(json.dumps(xent), flush=True)
    torch.cuda.empty_cache()
    raw_rows, raw_summary = check_raw_rnn_kernels(dev, Timer(dev),
                                                  fwd_faults=lstm_faults)
    for row in raw_rows:
        print(json.dumps({"phase": "kernel", **row}), flush=True)
    print(json.dumps(raw_summary), flush=True)
    raw, raw_n = raw_rnn_path(dev)
    print(json.dumps(raw), flush=True)
    torch.cuda.empty_cache()
    bf16_timer = Timer(dev)
    bf16_rows = check_brgemm(dev, bf16_timer, torch.bfloat16)
    cv_bf16_rows, cudnn_bf16 = check_conv(dev, bf16_timer, torch.bfloat16)
    bf16_rows += cv_bf16_rows
    stats_bf16_row, stats_bf16_summary = check_vgg_kernels(
        dev, bf16_timer, dtype=torch.bfloat16)
    del bf16_timer
    for row in bf16_rows + [stats_bf16_row]:
        print(json.dumps({"phase": "kernel", **row}), flush=True)
    print(json.dumps({"phase": "gemm_tile_bf16",
                      "cudnn_kernels": cudnn_bf16,
                      "wgmma_planted_faults": wgmma_faults(dev, wgmma_libs)}),
          flush=True)
    print(json.dumps(stats_bf16_summary), flush=True)
    torch.cuda.empty_cache()
    resnet_bf16, resnet_bf16_n = train_resnet_bf16(dev)
    print(json.dumps(resnet_bf16), flush=True)
    torch.cuda.empty_cache()
    vgg_bf16, vgg_bf16_n = train_vgg_bf16(dev)
    print(json.dumps(vgg_bf16), flush=True)
    torch.cuda.empty_cache()
    flash_bf16_rows, flash_bf16_summary = check_flash_bf16(dev, Timer(dev))
    for row in flash_bf16_rows:
        print(json.dumps({"phase": "kernel", **row}), flush=True)
    print(json.dumps(flash_bf16_summary), flush=True)
    torch.cuda.empty_cache()
    lm_bf16, lm_bf16_n = train_lm_bf16(dev)
    print(json.dumps(lm_bf16), flush=True)
    torch.cuda.empty_cache()
    rnn_bf16_rows, rnn_bf16_summary = check_rnn_bf16_kernels(dev, Timer(dev))
    for row in rnn_bf16_rows:
        print(json.dumps({"phase": "kernel", **row}), flush=True)
    print(json.dumps(rnn_bf16_summary), flush=True)
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "rnn_bf16_witness",
                      **rnn_bf16_witness(dev)}), flush=True)
    text_bf16, text_bf16_n = train_text_bf16(dev)
    print(json.dumps(text_bf16), flush=True)
    torch.cuda.empty_cache()
    crnn_bf16, crnn_bf16_n = train_crnn_bf16(dev)
    print(json.dumps(crnn_bf16), flush=True)
    torch.cuda.empty_cache()
    gru_bf16_rows, gru_bf16_summary = check_gru_bf16_kernels(dev, Timer(dev))
    for row in gru_bf16_rows:
        print(json.dumps({"phase": "kernel", **row}), flush=True)
    print(json.dumps(gru_bf16_summary), flush=True)
    torch.cuda.empty_cache()
    print(json.dumps({"phase": "nmt_bf16_witness",
                      **nmt_bf16_witness(dev)}), flush=True)
    composed_bf16, composed_bf16_n = composed_bigru_check(
        dev, dtype=torch.bfloat16)
    print(json.dumps(composed_bf16), flush=True)
    torch.cuda.empty_cache()
    nmt_bf16, nmt_bf16_n = train_nmt_bf16(dev)
    print(json.dumps(nmt_bf16), flush=True)
    torch.cuda.empty_cache()
    serve_bf16_rows, serve_bf16_summary, serve_bf16_n = serve_bf16(dev)
    for row in serve_bf16_rows:
        print(json.dumps({"phase": "kernel", **row}), flush=True)
    print(json.dumps(serve_bf16_summary), flush=True)
    torch.cuda.empty_cache()
    last_rows, last_summary, last_n = bf16_last_forms(dev)
    for row in last_rows:
        print(json.dumps({"phase": "kernel", **row}), flush=True)
    print(json.dumps(last_summary), flush=True)
    # the forward kernel runs on two paths, a row for each: serving's
    # prefill and LM training, each timed at its own shape
    rows[0]["launches"], rows[1]["launches"] = flash_n, paged_n
    for row, launches in zip(bwd_rows, (fwd_n, dq_n, dkv_n)):
        row["launches"] = launches
    rows += bwd_rows
    # rows 14 and 15: a line for each shape, each with its kernel's
    # launches on the run of the model the shape is from: ResNet-50's
    # training, AlexNet's image-zoo steps, small_vgg's training
    resnet = ("resnet50 train", {"brgemm": br_n, "conv2d_direct": cv_n})
    alexnet = ("alexnet image-zoo steps", {
        k: v * nets["alexnet"]["steps"]
        for k, v in nets["alexnet"]["launches_per_step"].items()})
    small_vgg = ("small_vgg train", vgg["train_launches"])
    for row in conv_rows:
        label = next(iter(row["shape"]))
        on, counts = (alexnet if label.startswith("alexnet") else
                      small_vgg if label.startswith("small_vgg") else resnet)
        rows.append({**row, "launches": counts[row["name"]],
                     "launches_on": on})
    for row, launches in zip(text_rows, text_n):
        rows.append({**row, "launches": launches})
    # the BiLSTM, LSTM-backward and CTC rows count the training run's
    # launches, the decode row the infer-and-decode run's
    for row, launches in zip(crnn_rows, crnn_n):
        rows.append({**row, "launches": launches})
    # the BiGRU and remat-backward rows count the training run's launches,
    # the GRU forward and stored-gates rows the composed BiGRU check's
    for row, launches in zip(nmt_rows, nmt_n):
        rows.append({**row, "launches": launches})
    rows.append({**vgg_row, "launches": stats_n})
    # the fused update's launches are those of the three timed runs that
    # update through it (ResNet-50, small_vgg, the CTR's dense tensors)
    rows.append({**update_rows[0],
                 "launches": up_resnet_n + up_vgg_n + up_ctr_n})
    rows.append({**update_rows[1], "launches": rows_n})
    # row 4 counts the LM-logits run's launches, rows 6 and 9 the
    # raw-input path's fused-input launches (the LSTM's both directions)
    for row, launches in zip(xent_rows, xent_n):
        rows.append({**row, "launches": launches})
    for row in raw_rows:
        rows.append({**row, "launches": raw_n[row["name"].split("_")[0]]})
    # the bf16 forms (rows 13-15): a line for each shape, with the
    # launches of the bf16 run of the model the shape is from
    resnet = ("resnet50 bf16 train", resnet_bf16_n)
    alexnet = ("alexnet bf16 image-zoo steps", {
        k: v * nets["alexnet"]["bf16"]["steps"]
        for k, v in nets["alexnet"]["bf16"]["launches_per_step"].items()})
    small_vgg = ("small_vgg bf16 train", vgg_bf16_n)
    for row in bf16_rows:
        label = next(iter(row["shape"]))
        on, counts = (alexnet if label.startswith("alexnet") else
                      small_vgg if label.startswith("small_vgg") else resnet)
        rows.append({**row, "launches": counts[row["name"]],
                     "launches_on": on})
    rows.append({**stats_bf16_row,
                 "launches": vgg_bf16_n["channel_stats_bf16"],
                 "launches_on": "small_vgg bf16 train"})
    # rows 2 and 3 in bf16: the bf16 LM training run's launches
    for row in flash_bf16_rows:
        rows.append({**row, "launches": lm_bf16_n[row["name"]],
                     "launches_on": "LM bf16 train"})
    # rows 5, 7 and 17 in bf16: the bf16 text and CRNN training runs'
    # launches (the CRNN's backward row counts both directions)
    on_path = {"lstm_seq_fwd_bf16": (text_bf16_n["lstm_fwd_bf16"], "text"),
               "lstm_seq_bwd_stored_bf16": (
                   text_bf16_n["lstm_bwd_stored_bf16"], "text"),
               "lstm_seq_bwd_bf16_crnn": (crnn_bf16_n["lstm_bwd_bf16"],
                                          "OCR CRNN"),
               "bilstm_seq_fwd_bf16": (crnn_bf16_n["bilstm_bf16"],
                                       "OCR CRNN"),
               "embedding_gather_bf16": (text_bf16_n["gather_bf16"], "text")}
    for row in rnn_bf16_rows:
        launches, model = on_path[row["name"]]
        rows.append({**row, "launches": launches,
                     "launches_on": f"{model} bf16 train"})
    # rows 8 and 10 in bf16: the BiGRU and the remat backward count the
    # bf16 NMT training run's launches, the GRU forward and the
    # stored-gates backward the bf16 composed BiGRU check's
    on_path = {"bigru_seq_fwd_bf16": (nmt_bf16_n["bigru_fwd_bf16"],
                                      "NMT bf16 train"),
               "gru_seq_bwd_remat_bf16": (nmt_bf16_n["gru_bwd_remat_bf16"],
                                          "NMT bf16 train"),
               "gru_seq_fwd_bf16": (composed_bf16_n["gru_fwd"],
                                    "composed BiGRU bf16 check"),
               "gru_seq_bwd_stored_bf16": (composed_bf16_n["gru_bwd_stored"],
                                           "composed BiGRU bf16 check")}
    for row in gru_bf16_rows:
        launches, where = on_path[row["name"]]
        rows.append({**row, "launches": launches, "launches_on": where})
    # rows 1 and 2 in bf16 at serving's shapes: the bf16 serving blocks'
    # launches
    for row in serve_bf16_rows:
        rows.append({**row, "launches": serve_bf16_n[row["name"]],
                     "launches_on": "serving bf16"})
    # rows 4, 6, 9 and 18 in bf16: the bf16 path legs' launches
    for row in last_rows:
        rows.append({**row, "launches": last_n[row["name"]],
                     "launches_on": "bf16 path legs (phase 18)"})
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(smi, flush=True)
    extra = ("shape", "dtype", "alone_ms", "host_ms", "eager_ms", "plan",
             "launches_on", "library_alone_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys + extra if k in r}
                                  for r in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        stop_fault_builds()
    sys.exit(code)
