#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (mxnet_tpu_torch) on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's kernels from the checkout's sources with nvcc, one
process per source, all at once (phase 18's subprocesses build their own
into a cache directory of theirs): the CUDA BatchNorm, copy, NMS and ROI
pooling libraries into the git-ignored ``build/cuda`` and the CUDA
generated from each of phase 6's five rtc bodies into
``build/rtc/<digest>``. Then it runs
these phases, each printing JSON lines, and fails (exit code != 0, no
result line) if any phase fails:

1. device: the card's name and power limit, the torch and CUDA versions,
   and the build's seconds;
2. copy: the copy probe (``python -m mxnet_tpu_torch.tools.bn_probe
   --copy-sweep``): the streaming engine's copy at each swept number of
   vectors per thread and ``copy_`` on a (128, 256·3136) bf16 array, bit for
   bit, each with its call time (one CUDA-event pair around one call),
   device time (20 calls in one CUDA graph) and host enqueue time; the
   best device rate is the measured copy roofline; then every
   configuration on ragged byte counts, bit for bit;
3. kernels: ``bn_fwd``/``bn_bwd`` against their plain PyTorch versions on
   the card at ResNet-50 shapes (batch 32) and a ragged one, in float32
   and bfloat16, with ReLU, fix_gamma and exact statistics on and off, so
   that every plan (block, with aligned and unaligned planes; cluster
   2/4/8; split) runs; the backward without dx against the full call and
   repeat runs, bit for bit; then, at every BatchNorm shape of a
   ResNet-50 step, each kernel's plan, call time (one CUDA-event pair),
   device time (20 calls in one CUDA graph, each on its own copy of the
   inputs so that none finds them in L2) and host enqueue time, the
   plain version's time, the same three times of the PyTorch call that
   computes the same function (a yardstick the port never calls) and the
   least time the card's memory rate allows, at the data sheet's rate and
   at the measured copy roofline; at each of those shapes the kernels are
   also held against their plain versions (the main path's flags); all of
   it in float32 and again in bfloat16 (the byte bound at 2 bytes an
   element for x, y, du and dx; the library call on bfloat16 activations);
4. main path: ResNet-50 (224², 1000 classes, batch 32, float32) through
   ``mx.mod.Module(context=mx.gpu(0))`` on its default, fused route
   (``MeshExecutorGroup``: one step function a batch) with SGD (lr 0.1,
   momentum 0.9, wd 1e-4, rescale 1/32): 5 forward_backward + update
   steps; the kernels' launch counts must be 51 per step each. Then the
   fused and the classic route (``_allow_fused=False``), 3 steps each
   from the same parameters with cuDNN deterministic: the parameters bit
   for bit (else within relative L2 1e-6, with the reason);
5. card vs CPU: one ResNet-50 forward_backward at batch 2 from identical
   weights on the card (kernels) and on the CPU (plain versions): softmax
   outputs and the gradients of fc1_weight, bn1_gamma,
   stage4_unit3_bn3_gamma and conv0_weight, and the same step on the card
   with the plain versions for scale;
6. rtc: five bodies pushed through ``mx.rtc.Rtc`` on the card at one
   ResNet-50 activation (32×256×56×56 float32) and a ragged 5×3×17×13,
   each against its plain version (+ − ×, ``where`` and ``maximum`` bit
   for bit); the bodies were built once each in the build phase, so no
   push compiles; every body again at both shapes in each case of
   ``RTC_CASES`` (refs 4 bytes off 16-byte boundaries, and refs that
   differ mod 16, some of which move as 4-byte words); then at full size
   each body's call, device and enqueue times, those of ``torch.add`` and
   ``torch.square`` for the two bodies one PyTorch call computes, the
   plain version's time and the byte bound;
7. fit: ResNet-50 through ``mod.fit`` on 8 synthetic batches (numpy seed
   0) with 2 eval batches, SGD with a FactorScheduler; exactly 51 × 8
   launches of each BatchNorm kernel, none from scoring;
8. serving: the trained ResNet-50 behind ``serving.Predictor``
   (max_batch_size 32: buckets 2, 4, 8, 16, 32) and ``DynamicBatcher``:
   warmup (5 compiles, one parameter set under all buckets); parity
   (served rows bit for bit equal to ``Module.predict`` through a module
   bound at each launch's bucket, for requests that fit, pad and are
   chunked; the same rows from buckets 2 and 32 within a relative L2 of
   1e-5; one more training step of the source leaves served rows as
   they were); per bucket the forward's device time (CUDA events, and a
   CUDA graph replay), host enqueue, call, host→card copy and readback
   times; 8 clients for 5 s of bench.py's request mix through the
   batcher (requests/s, rows/s, p50/p99, batch fill, rejects, compiles
   after warmup: 0, launches per bucket, the device's estimated busy
   share); each client's last rows checked bit for bit; and no
   BatchNorm kernel launched while serving;
   precision: ResNet-50 as in phase 4 (one synthetic batch, cuDNN
   deterministic) in the modes ``f32``, ``bf16``, ``bf16_opt``,
   ``combined`` and ``custom(remat=full)``, each twice from the same
   parameters: ms a step (median of steps 2-5), img/s, peak memory
   (``max_memory_allocated`` after ``reset_peak_memory_stats``), BN
   launches a step and their dtype, finite outputs, changed parameters,
   the loss scale. Gates: each mode repeats bit for bit; bf16's softmax
   outputs after one step within relative L2 ``BF16_OUT_REL_L2`` of f32's;
   ``combined`` and remat=full under f32's peak memory; exactly 51 BN
   backwards a step and 51 forwards plus one replay per BatchNorm of the
   remat segment plan, all bfloat16 in ``bf16``; ``fit(batch_group=4)``
   over 8 batches equal to 8 per-batch ``fit`` steps bit for bit in
   ``bf16``, and its device-tallied accuracy equal to the per-batch run's
   host metric; a ``bf16_opt`` checkpoint restored by ``Module.load``
   continues bit for bit; and, not gated, where an f32, a bf16 and a
   ``combined`` step's time goes (``torch.profiler`` over 2 steps: host
   wall, kernel and busy device time, the idle share, device time by
   kernel kind);
9. cifar_twin: the CIFAR twin ``mxnet_tpu_torch.examples.train_cifar10``
   (resnet-20 at its published width: 16/32/64 channels, 28² crops, 10
   classes, batch 128, float32, seed 7, cuDNN deterministic). The BN
   kernels against their plain versions and timed at every resnet-20
   BatchNorm shape (as in phase 3), and checked at the 2-row shapes; then
   ``main`` in process for 3 epochs (96 steps) with a checkpoint per
   epoch, ``--serve-smoke`` and ``--min-accuracy 0.9``: fit img/s,
   exactly 20 × 96 launches of each BN kernel, each save's blocking
   snapshot and async commit, the entry's bytes, the restore; the
   served rows' largest relative L2 error against ``Module.predict``
   and, from ``tools/batch_parity.py``, the first node of the eval
   forward whose rows change between 128 and 32, 8 or 2 rows; a
   ``CheckpointManager.save`` of the card's weights followed at once by
   an in-place update of them, whose entry must hold the values at save
   time and whose RNG state gives back the card's generator; the same
   command in a subprocess with ``--exit-after-epoch 1`` (exit 66, one
   committed entry) and again with ``--resume``, whose ``params_digest``
   must equal the in-process run's; and ``reshape``: a training step at
   128 rows, one at 2 rows and an eval forward at 4×3×32×32 on the same
   parameter tensors (``data_ptr`` unchanged), 20 + 20 BN launches per
   training step and none in the eval; and twice in a subprocess with
   ``--precision bf16 --batch-group 4``: accuracy >= 0.9 and the same
   ``params_digest`` both times;
10. decode: continuous-batching decode serving on ``gpu(0)``, float32,
   TF32 off; no hand-written kernel lies on this path, and every kernel
   counter (BN, copy, rtc), set to 0 just before, reads 0 after it.
   (a) ``LSTMCharLM`` at bench.py's decode configuration (vocab 64,
   hidden 64, embed 32, ``init_params(seed=7)``, 8 slots,
   ``max_prefill_len`` 16, 24 prompts of 2–16 tokens from
   ``RandomState(7)``, 64 new tokens each), greedy and at temperature
   0.8: continuous and sequential tokens/s (over the steps' host time
   and over the wall), TTFT p50/p99, average occupancy, host ms per
   step; the continuous streams equal the sequential ones bit for bit
   and ``compiles`` stays at its warmup count; ``prefill_parity`` at
   every prompt length 1–40 (crossing the 16-token chunk); one step at
   full occupancy: host ms, CUDA-event ms, device ms (a CUDA graph
   replay) and the operators it dispatches; the first-token logits of
   the 24 prompts within relative L2 1e-5 of the port's on the CPU.
   (b) ``TransformerLM`` at example/transformer-lm's widths (V 32, D 64,
   4 heads, window 16, 2 blocks, ``init_params(seed=0)``), 4 slots, 12
   prompts of 3–40 tokens (the window slides): the same numbers and
   gates. (c) ``python -m mxnet_tpu_torch.examples.decode_lm`` with its
   default flags in a subprocess: exit 0, its parity, continuation and
   throughput lines and the streams' sha256;
11. imagenet_twin: the input pipeline at ResNet-50's full width (224²,
   1000 classes, batch 32, float32; its BatchNorm shapes are phase 3's,
   where both kernels are held against their plain versions). A
   512-image, 8-class RecordIO pack of raw ``.npy`` records (~77 MB, no
   image library needed) written with the port's ``pack_img`` into the
   git-ignored ``build/imagenet_twin``; the host's decode-and-assemble
   rate alone; ``mxnet_tpu_torch.examples.train_imagenet``'s ``main`` in
   process on the pack, 2 epochs of 16 steps, as the JAX script runs it
   (shuffle, mirror, host assembly): it prints ``TRAIN_IMAGENET_DONE``,
   fit img/s, exactly 51 + 51 BN launches a step (counters reset just
   before). Then, from one parameter set under deterministic cuDNN, the
   same 2 epochs through ``ImageRecordIter(device_augment="defer",
   augment_pad=4)`` four ways: (a) streamed, (b) with
   ``fit(prefetch_to_device=2)``, (c) wrapped in
   ``CachedDataset(placement="device")`` with prefetch (the cache on the
   device tier), (d) the host placement (``apply_host``, float32 over the
   wire); the parameters of all four bit for bit, each way's fit img/s,
   host-wait ms a step, ring high water and staged bytes a batch beside
   phase 4's synthetic img/s. ``DeviceAugment.apply`` on the card equals
   ``apply_host`` bit for bit on a padded, randomly cropped and mirrored
   batch; ``ImageRecordIter(device_augment=True)`` agrees with the host
   path within atol 1e-4; a batch staged by ``DeviceLoader`` and held
   while the ring turns 15 times keeps its bytes; wire bytes a batch
   (uint8 against float32) and the host→card copy ms of each, pageable
   against pinned; the CIFAR twin with ``--device-augment --cache-dataset
   --prefetch-device 2`` and with ``--device-augment --augment-placement
   host`` (in process, 3 epochs): one ``params_digest``, accuracy ≥ 0.9;
12. zoo: the model zoo at its published widths (batch 32, 1000
   classes; 299² for inception-v3 and inception-resnet-v2, 224²
   otherwise). (a) ``bn_fwd``/``bn_bwd`` against their plain versions
   at every BatchNorm shape of inception-bn, inception-v3,
   inception-resnet-v2 and resnext-50, in float32 and bfloat16, at the
   networks' own flags, with ``TOL``: each shape's plan and the calls of
   a step by plan (kind, unit bytes); (b) phase 3's timings over
   inception-v3's 94 BatchNorms, float32 and bfloat16 (device, call,
   bound, plain, library, per step); (c) 3 fused SGD steps (lr 0.01,
   momentum 0.9, wd 1e-4; Xavier from seed 0; one synthetic batch) of
   alexnet, vgg, googlenet, inception-bn, inception-v3 (and again in
   ``bf16``), inception-resnet-v2, resnext-50 and resnet-50: ms a step
   (median of steps 2–3), img/s, peak
   memory, finite outputs and parameters, and exactly 0/0/0/69/94/114/
   54/51 launches of each BN kernel a step, bfloat16 in ``bf16``; (d)
   the train_imagenet twin on inception-v3 from a 256-image 299²
   ``.npy`` pack, one epoch of 8 steps: ``TRAIN_IMAGENET_DONE``, 94 × 8
   launches of each kernel, fit img/s; (e) the benchmark_score twin over
   the eight networks in float32 and bfloat16: img/s, no BN launch; (f)
   alexnet's Dropout under deterministic cuDNN: 3 steps twice from one
   seed bit for bit, fused = classic, remat=full = none (bit for bit,
   else relative L2 1e-6 with the reason), ``fit(batch_group=2)`` twice
   bit for bit, the kept fraction of a 32×4096 mask on the card within
   4σ of 1 − p and equal to the CPU's mask from the same key, ``predict``
   twice equal drawing no key; (g) the fine_tune twin on the card, both
   of its asserts;
13. rnn: the recurrent path, float32, TF32 off; no hand-written kernel
   lies on it, and every kernel counter (BN, copy, rtc), set to 0 just
   before the twins, reads 0 after them. (a) The ``RNN`` operator
   (cuDNN through ``torch._VF``) against ``rnn_plain`` (a loop over
   time) on the card for lstm, gru, rnn_tanh and rnn_relu, uni- and
   bidirectional, 2 layers, at the PTB widths (T 35, N 32, I = H = 200)
   and char_lstm's (T 32, N 32, I 64, H 256): the outputs and every
   gradient within ``RNN_TOL`` of the plain value's max-abs; at
   ``RNN_TIME_CASES`` the forward + backward's call ms (one CUDA-event
   pair), device ms (kernel busy time under ``torch.profiler``) and
   enqueue µs, for the op and the loop, beside the matrix products'
   float32 FLOP bound. (b) ``mxnet_tpu_torch.examples.char_lstm`` at
   full width (its defaults: 264 steps through ``fit`` on the fused
   route): ms a step, tokens/s and perplexity by epoch (it must fall),
   one RNN launch a step, and 10 steps under the profiler (device busy,
   idle share). (c) ``mxnet_tpu_torch.examples.bucketing_lstm`` at
   MXNet 0.9.5 lstm_bucketing.py's widths (2 × 200 LSTM, embedding 200,
   batch 32, buckets 10–60, a 10,000-word vocabulary over 3,200 Zipf
   sentences, 2 epochs), twice from one seed under deterministic cuDNN,
   the first with per-bucket times: ms a step by bucket, positions/s,
   the six buckets bound on one parameter and gradient storage
   (``data_ptr``), perplexity falling, and the two runs' parameter
   digests bit for bit;
14. api: the rest of the training API, float32, TF32 off. (a) The eight
   training-API twins (``mnist_mlp``, ``custom_softmax``, ``sto_depth``,
   ``fgsm``, ``gan_mnist``, ``sgld``, ``autoencoder``, ``multitask``) at
   their JAX scripts' defaults, in process, each passing its own
   asserts, with its ms a step and seconds. (b) resnet-20 at the CIFAR
   twin's shapes (batch 128, 3×28×28, 10 classes) as a
   ``SequentialModule`` of its features (cut at the Flatten; the fused
   route) and its head (``fc1`` + ``SoftmaxOutput``; the classic route),
   3 SGD steps against one classic ``Module`` of the whole net from the
   same parameters under deterministic cuDNN: the parameters within
   relative L2 1e-6 (the line says whether bit for bit), exactly 20 + 20
   BN launches a step, every stage's parameter ``data_ptr``s kept, and
   both ms a step. (c) The ``custom_softmax`` net: its gradients within
   1e-5 (of their max-abs) of the builtin ``SoftmaxOutput`` net's, 3 steps
   fused = classic and remat="full" = plain, bit for bit, and both nets'
   ms a step (the difference is the op's host round trip). (d)
   ``mx.autograd``: an imperative 2-layer MLP's gradients from
   ``mark_variables`` + ``backward`` within 1e-5 of ``Module.backward``'s,
   and ``nd.Dropout`` dropping under ``train_section`` and the identity
   under ``test_section``. (e) ``mx.kv``: the push of four card arrays
   pulled as their sum in list order, twice bit for bit; ``fit`` with
   ``mx.kv.create("local")`` (the update on the store) against
   ``kvstore="local"`` (the fused step), 3 resnet-20 steps within relative
   L2 1e-6, each at 20 + 20 BN launches a step. Every kernel counter reads
   0 over (a), (c), (d) and the store's push and pull;
15. quant: the quantized precision modes (``precision/quant.py``). The
   library GEMMs carry their own counters (``quant.GEMM_CALLS``: one per
   ``torch._int_mm`` / ``torch._scaled_mm`` call). (a) ``narrow_dot``
   int8 at ResNet-50's fc1 (2048 → 1000) and ``narrow_conv`` int8 at its
   7×7/2 stem, a 3×3, a 1×1 and a strided 1×1 projection, and
   resnext-50's 32-group 3×3, each at batch 1, 3 and 32 (1 and 3 pad to
   ``_int_mm``'s rules): the int32 accumulator bit for bit against the
   plain float64 product or convolution on the CPU, and the rescaled
   output bit for bit against the CPU's ``narrow_*``; fp8 ``narrow_dot``
   within ``QUANT_FP8_DOT_TOL``; ``to_e4m3`` and ``fake_cast`` bit for
   bit, NaN positions included, on inputs crossing ±464. The library
   GEMMs at fc1's and the im2col shapes at batch 32: ``_int_mm``,
   ``_scaled_mm``, ``F.linear`` float32 and bfloat16, CUDA-event ms
   beside each one's bound at the card's peak for its type. (b)
   ResNet-50 at full width (224², 1000 classes, Xavier weights, BN
   statistics from 48 training-mode forwards of a synthetic batch) behind
   ``Predictor(max_batch_size=32)`` in f32, bf16, ``int8_serve``
   (calibrated on 8 synthetic batches of 32, ``calibration=``) and
   ``fp8_native``: the library calls of one eval forward equal to the
   sites (54 ``_int_mm``, 1 ``_scaled_mm``), every site's narrow product
   within ``tolerance_check`` of its float32 product (0.05 for int8,
   ``QUANT_FP8_SITE_TOL`` for fp8), the rows' distance from f32 beside
   bf16's and beside the f32 net's response to 2^-8 input noise (not
   gated: the random net amplifies any rounding ~20×), per-bucket event
   ms and rows/s. (c) both decode models of phase 10 under
   ``int8_weight`` and ``bf16``: weight and step-argument bytes against
   f32, first-token and token agreement with the f32 greedy streams (the
   first token at least 0.8), two runs bit for bit, prefill parity,
   tokens/s. (d) resnet-20 at the CIFAR twin's shapes under ``int8_act``
   and ``fp8`` (``MXNET_PRECISION_EXPERIMENTAL=1``), 3 SGD steps twice
   under deterministic cuDNN: bit for bit, the live loss scale with no
   skipped step, exactly 20 + 20 bfloat16 BN launches a step; no kernel
   of ours launches in (a)-(c);
16. vision: the vision and detection operators, float32, TF32 off, and
   their four hand-written kernels (``kernels/nms.py``: ``nms_mask``,
   ``nms_scan``; ``kernels/roi_pooling.py``: ``roi_pool_fwd``,
   ``roi_pool_bwd``). (a) Each kernel against its plain version: NMS keep
   masks and suppression words bit for bit at ragged box counts (1, 63,
   64, 65, 130, 1000), on integer boxes (IoUs of exactly 1/2 at threshold
   1/2), on boxes clipped to [0, 1] (zero areas, copies, −1 scores), on
   pairs whose float32 IoU is exactly the threshold or the next float32
   above it (the strict ``>`` must say no, then yes), on
   MultiBoxDetection's sorted boxes of the SSD300 batch that (b) runs (32
   × 8,732) and at Proposal's 6,000; the ROI forward (out and tie counts)
   bit for bit and the backward within ``ROI_BWD_TOL`` of the plain
   gradient's max-abs, on post-ReLU maps full of zero ties, with empty and
   one-pixel bins, ragged and at Faster R-CNN's full width (512×38×63, 300
   ROIs, 7×7, 1/16; the backward at 128); every kernel twice, bit for bit.
   (b) The phase's main path, part one: SSD300 (VOC, 21 classes, batch 32;
   six maps 38²…1² with 4/6/6/6/4/4 anchors: MultiBoxPrior × 6 → Concat →
   MultiBoxTarget on labels padded to 50 rows and MultiBoxDetection at nms
   0.45, threshold 0.01) and Faster R-CNN with VGG16 (a 600×1000 image:
   Proposal with 9 anchors, pre_n 6000, post_n 300, threshold 0.7 →
   ROIPooling forward at 300 ROIs and forward + backward at 128) as graphs
   bound through ``simple_bind``, once, every counter set to 0 just before
   and read just after: all four kernels launched, no BN, copy or rtc
   launch. Then each op's call, device (CUDA graph) and enqueue times;
   each kernel alone at those shapes (call, device, enqueue ms), its plain
   version's host ms on the same inputs (the NMS pair on all 32 images,
   ``NMS_PLAIN_CHUNK`` a call) and its bound (bytes, or the IoU pairs'
   ``NMS_PAIR_OPS`` at the float32 SIMT rate); the ROI backward's
   ``max_abs_err`` is absolute, its ``max_rel_err`` of the plain
   gradient's max-abs; ``F.ctc_loss`` beside the port's CTCLoss at the CTC
   twins' shapes, as a yardstick. (c) Part two: the five twins at their
   defaults, in process: ``train_ssd`` (NDArrayIter and
   ``--use-recordio``) and ``train_rcnn``, their logged loss of the last
   epoch below the first's and finite parameters; after ``train_ssd`` its
   ``detect`` (``build_detector`` bound with the trained parameters) keeps
   a box in every image and launches the NMS kernels; ``train_rcnn``'s
   demo gives (16, 5) ROIs of image 0 (the JAX script's
   ``rpn_post_nms_top_n`` is 16) and launches the NMS and ROI forward
   kernels; ``fcn_xs``, ``ctc_train`` and ``deepspeech_mini`` pass their
   own asserts; ms a step and seconds of each, and no BN, copy or rtc
   launch. (d) One SSD training step of ``train_ssd``'s graph (batch 32)
   from the same parameters on the card and on the CPU: outputs and every
   gradient within relative L2 ``VISION_CPU_REL_L2``;
17. guardian: ``Module.fit`` with the training guardian, the fault
   plane and the training telemetry, float32, TF32 off, cuDNN
   deterministic, telemetry enabled; resnet-20 at the CIFAR twin's
   shapes (batch 128, 3×28×28, 10 classes, the twin's synthetic data),
   3 epochs of 16 batches, SGD (lr 0.05, momentum 0.9, wd 1e-4), Xavier
   from seed 7. (a) ``fit(guardian=None)``, the guardian armed clean and
   armed with the SDC probe every 3rd step: the parameters bit for bit,
   0 new programs after the warmup boundary, 16 probes and 0
   mismatches. (b) ``GUARD_PLAN_B`` (a NaN batch at (1, 2), an infinite
   spike at (2, 1)) with a checkpoint per epoch: healed by
   rollback-and-skip onto the committed entries, bit for bit equal to a
   guarded run on the same stream without those two batches; the
   transcript exactly the planned incidents, one ``guardian_rollback``
   flight event per fault. (c) a ``param_bitflip`` at restore walks back
   to the entry before; a probe mismatch forced by one element of the
   second run's parameter copy (``guardian.sdc``) sets
   ``HEALTH_SDC_MISMATCH`` and rolls back; each bit for bit equal to its
   excluded-batch reference. (d) transients at ``checkpoint.commit``
   (healed by the ``checkpoint.save`` retry) and ``data.device_put``
   (prefetched) land on the fault-free digest; a ``checkpoint.shard``
   bit flip makes ``restore()`` fall back to the previous entry. (e)
   exactly 20 + 20 BN launches a step, 40 + 40 on probed steps, and the
   replayed steps after a rollback counted. (f) ResNet-50 (224², batch
   32) 2 epochs of 3 steps, armed against unarmed: bit for bit, ms a
   step for both (the timeline's median, each step synchronised) and
   ``_health_update``'s device ms. (g) the counted FLOPs of the step
   (``telemetry.introspect``) within 5% of 2·MACs·3 of every
   convolution and FC layer, for resnet-20 and ResNet-50, beside the
   live ``train.mfu`` / ``achieved_tflops`` of their records;
18. serve_cache: serving's executable cache and replica warm start,
   cuDNN deterministic. (a) The serve twin
   (``mxnet_tpu_torch.examples.serve_cifar10``) in a process of its own
   with a fresh checkpoint and cache directory: it loads its BN kernels
   (one ``nvcc``, into the cache's ``cuda/``), trains resnet-8 for 2
   epochs of 32 batches (exactly 8 + 8 BN launches a step), checkpoints
   through a ``CheckpointManager``, serves from that directory, traces
   and commits each bucket (2…32) with ``torch.export``, and passes its
   asserts (client rows, the Prometheus scrape, the SLO report, the
   in-process second replica). (b) The twin again with ``--expect-warm``:
   0 ``nvcc``, 0 traces, 0 compiles and warmup compiles, no training and
   no BN launch, every bucket loaded, the served digest of (a) bit for
   bit; each bucket's warmup ms cold against warm. (c) In process, on
   (a)'s checkpoint and cache: every bucket's program loaded from (a)'s
   entries serves the eager Predictor's rows bit for bit (pads, chunks);
   a tampered, a truncated and a ``.tmp-*`` entry (buckets 2 and 4) each
   re-trace exactly that bucket and serve a cache-less replica's rows,
   and the replica after them loads both; two
   calibrations of the net under ``int8_serve`` never share an entry
   (the second's rows differ from the first's and equal a cache-less
   predictor's bit for bit); ``DecodeEngine`` cold → warm through the
   cache streams as the eager engine bit for bit and traces nothing
   warm. (d) At buckets 2 and 32 the exported program against the eager
   executor: forward event ms (median of 10 after 3), host enqueue ms,
   ``predict`` call ms (median of 10); the profiler_demo twin's dump
   (its scopes, and the card's kernel events it caught), the debug_conv
   twin, and the memcost twin
   (held and peak MiB, FLOPs; its asserts); no kernel launched in
   process;
19. dist: multi-process data parallelism (``mxnet_tpu_torch.dist``), TF32
   off, cuDNN deterministic. (a) At every ResNet-50 BatchNorm shape
   (batch 32, the main path's flags), in float32 and bfloat16, the four
   cross-rank entry points of the BatchNorm core (``bn_fwd_partials``,
   ``bn_fwd_apply``, ``bn_bwd_partials``, ``bn_bwd_dx``) against their
   plain versions, and two half-batches' partials, summed (standing for
   the all-reduce of two ranks) and applied, against K1's one-call pair
   on the whole batch, both within phase 3's tolerances (exact statistics
   too at the 64- and 2048-channel shapes); each entry point's call,
   device and enqueue times, its plain version's, its byte bound and the
   SyncBatchNorm primitive that computes the same function
   (``batch_norm_stats``; ``batch_norm_gather_stats_with_counts`` +
   ``batch_norm_elemt``; ``batch_norm_backward_reduce``;
   ``batch_norm_backward_elemt``), which the port never calls. (b) A
   process group of one on ``nccl`` (bootstrap, an all-reduce, a
   barrier), and resnet-20 ``fit`` with ``kvstore="dist_sync"`` equal to
   a plain ``fit`` bit for bit. (c) The main path of the phase: ResNet-50
   trained by two ranks on the one card over ``gloo`` (NCCL refuses two
   ranks on one card), launched by ``tools/launch.py -n 2 --launcher
   local`` through the ImageNet twin with ``--kv-store dist_sync``, 32
   rows a rank, 3 steps (lr 0.01) on a ``.npy`` pack; held against one
   process at batch 64 from the same seed and stream: the parameters'
   relative L2 (as one vector) and the loss of a training forward on a
   fixed batch within max(1e-4, 4 × the one-process run's own spread
   between one-pass and exact statistics); every rank's launches: each
   split entry point 51 a step (``bn_bwd_dx`` 50: the data's BatchNorm
   has no dx) and the one-call pair 0; each rank's step and all-reduce
   ms. (d) Three ranks' push/pull of card tensors over ``gloo``
   (``mxnet_tpu_torch.tools.dist_worker sync``): ``dist_sync``'s exact
   sums and ``dist_async`` one push late. (e) The elastic twin
   (``examples.elastic_virtual_hosts``) on the card: 4 virtual hosts
   → 2, the resume bit for bit equal to the continuous width-2 run, at
   resnet-20 width and with the JAX script's MLP (its accuracy assert);
20. gateway: the network serving plane (``gateway``, ``autopilot``,
   ``scenarios``), float32, TF32 off, cuDNN deterministic. (a) A
   ``GatewayServer`` on 127.0.0.1 (port 0) over a ``ReplicaPool`` of two
   ResNet-50 ``Predictor``s (224², 1000 classes, Xavier weights from seed
   0, buckets 2…32, warmed) and phase 10 (a)'s LSTM ``DecodeEngine``:
   64 predict requests of 1 row from 8 client threads, each bit
   for bit a direct ``Predictor`` call on the same rows; p50/p95 of a
   bucket-8 predict through the gateway against a direct call (and the
   JSON encode and decode of its 24 MB body); 8 concurrent
   ``/v1/generate`` streams, each byte for byte the engine's own greedy
   stream, and the time to the first token through the gateway against
   the engine's; the ``gateway.accept`` (flood healed by the client's
   retry), ``gateway.route`` (503, then served) and ``gateway.stream``
   (transient, the exact stream) seams; a drain with a request in
   flight: ``/readyz`` 503, the request completed bit for bit, new
   requests 503;
   no kernel of ours launched. (b) The pool from 1 to 2 to 1 replica
   under the ``Autopilot`` (an SLO breach, the ``autopilot.scale`` seam
   failing the first spin-up, cooldown, the retry, sustained idle) while
   4 threads predict through it: no request enters a released replica
   and every reply is bit for bit; a NaN-poisoned checkpoint generation
   admitted by the ``CanaryController`` is rolled back on its probe and
   the stable tenant's rows stay bit for bit; ``ElasticTrainer`` over 4
   virtual hosts of resnet-20 (28², batch 32, 16 steps) with a
   ``PeerCheckpointStore``: hosts 1 and 3 die at update 6, the resume
   comes from peer memory and trains to the disk resume's parameters bit
   for bit, the store's newest capture restores the manager's entry bit
   for bit, 20 + 20 BN launches a step. (c) ``scenarios.run_matrix()``:
   all six scenarios green on the card with 0 post-warmup retraces
   (``ssd_toy`` launches the NMS kernels), and ``chaos_sweep`` of
   ``nce_loss`` healed to the fault-free digest;
21. the kernels line (each kernel's launches on every path, decode's
   and rnn's 0 among them, ``launches_api`` the BN kernels' 60 + 60 over
   phase 14 (b)'s three steps, ``launches_quant`` their 240 + 240 over
   phase 15 (d), ``launches_vision`` every earlier kernel's 0 over phase
   16's main path, the four vision kernels' launches over it,
   ``launches_guardian`` every kernel's launches over phase 17's runs,
   ``launches_serve_cache`` the BN kernels' 512 + 512 in phase 18's cold
   twin and every other count 0, ``launches_dist`` every kernel's
   launches summed over phase 19 (c)'s two ranks, the four split entry
   points with ``launches`` from that run and ``launches_by_rank``,
   ``launches_gateway`` every kernel's launches over phase 20 (a)-(c),
   and the BN kernels' bfloat16, imagenet-twin and zoo launches and
   times, inception-v3's per-step times), the seconds of each phase,
   the card's nvidia-smi line, and the result line.

Numerics: float32 means float32 here. TF32 is off for convolutions and
matrix products (``cudnn.allow_tf32 = False``, matmul precision
"highest"), as ``f32_precision`` requests full float32 in the JAX package.
It exits with an error, and prints no result, without a CUDA card or
outside a checkout of the repository.
"""
import functools
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12        # float32 outside the tensor cores
EPS = 2e-5
BATCH = 32
IMAGE = (3, 224, 224)
STEPS = 5
BN_PER_STEP = 51               # BatchNorms in ResNet-50, 50 fused with ReLU
TOL = {
    # f32 outputs (y, dx): 1e-5 of the output's max-abs — the kernel's fma
    # and rsqrt round differently from the plain version by an ulp or two
    "f32_out": 1e-5,
    # per-channel reductions (mean, var, dβ, dγ): 1e-4 of the max-abs — the
    # two sum the same terms in another order
    "reduction": 1e-4,
    # bf16 outputs: 1 ulp of bfloat16 (2^-7 of the larger magnitude), plus
    # 1e-6 absolute for values that round to zero on one side only
    "bf16_rel": 2.0 ** -7,
    "bf16_abs": 1e-6,
    # share of elements allowed outside the tolerance: ReLU-mask flips.
    # Both sides round x·scale + shift once, so none are expected.
    "flip_fraction": 1e-6,
    # rtc bodies of transcendental functions: 1e-6 of the plain output's
    # max-abs (the kernel's expf/tanhf and torch's exp/tanh may round
    # differently in the last bits); bodies of + - *, where and maximum
    # agree bit for bit (0 ulps): the kernel rounds every operation once
    # with the _rn intrinsics, as torch's separate ops do, and fuses no
    # multiply and add
    "rtc_transcendental": 1e-6,
    "rtc_exact_ulps": 0,
    # served rows of one request from bucket 2 against bucket 32, as
    # relative L2 error of the softmax outputs: cuDNN and cuBLAS may pick
    # other algorithms at another batch size
    "serve_cross_bucket": 1e-5,
    # card vs CPU, ResNet-50 at batch 2, as relative L2 error
    # ‖card − cpu‖/‖cpu‖. The softmax outputs, and the gradients one
    # layer below them (fc1_weight, bn1_gamma), agree to ~1e-5; 1e-4.
    # Gradients 50 BatchNorms deep (conv0_weight) and the last unit's
    # stage4_unit3_bn3_gamma move by 1e-2 between cuDNN's and the CPU's
    # float32 convolutions, by the same amount whether the card runs the
    # kernels or the plain versions (measured on an H100); 5e-2.
    "cpu_top": 1e-4,
    "cpu_deep": 5e-2,
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def host_ms(fn, reps=5):
    """Median host-clock milliseconds of ``fn`` with the card idle before
    and synchronised after (for work that is not one kernel)."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def bn_inputs(shape, dtype, gen):
    import torch
    C = shape[1]
    dev = "cuda"
    x = (torch.randn(shape, device=dev, generator=gen) * 2.0 + 0.5).to(dtype)
    gamma = torch.rand(C, device=dev, generator=gen) + 0.5
    beta = torch.randn(C, device=dev, generator=gen) * 0.1
    c = torch.randn(C, device=dev, generator=gen) * 0.1
    du = torch.randn(shape, device=dev, generator=gen).to(dtype)
    return x, gamma, beta, c, du


def compare_outputs(kern, plain, dtype):
    """(max abs error, elements outside tolerance) of an activation-shaped
    output."""
    import torch
    k, p = kern.float(), plain.float()
    err = (k - p).abs()
    if dtype == torch.float32:
        bad = err > TOL["f32_out"] * float(p.abs().max())
    else:
        bad = err > TOL["bf16_rel"] * torch.maximum(k.abs(), p.abs()) \
            + TOL["bf16_abs"]
    return float(err.max()), int(bad.sum())


def reduction_error(kern, plain):
    rel = float((kern - plain).abs().max()) / max(float(plain.abs().max()),
                                                  1e-30)
    return rel


def plan_name(K, op, shape, dtype, need_dx=True):
    """The kernels' plan of one call ("block", "cluster k", "split")."""
    p = K.plan(op, shape, dtype, need_dx)
    return "cluster %d" % p.cluster if p.kind == "cluster" else p.kind


def compare_case(K, inputs, dtype, relu, fix_gamma, exact, need_dx=True):
    """Both kernels against their plain versions on the same inputs (the
    backwards from the plain forward's statistics). Returns (row fields,
    ok, the kernel backward's outputs, the statistics it was given)."""
    import torch
    x, gamma, beta, c, du = inputs
    kf = K.bn_fwd(x, gamma, beta, c, EPS, fix_gamma, relu, exact)
    pf = K.bn_fwd_plain(x, gamma, beta, c, EPS, fix_gamma, relu, exact)
    _, mean, _, rstd, scale, shift = pf
    kb = K.bn_bwd(du, x, rstd, mean, scale, shift, relu, need_dx=need_dx)
    pb = K.bn_bwd_plain(du, x, rstd, mean, scale, shift, relu,
                        need_dx=need_dx)
    torch.cuda.synchronize()
    y_err, y_bad = compare_outputs(kf[0], pf[0], dtype)
    if need_dx:
        dx_err, dx_bad = compare_outputs(kb[0], pb[0], dtype)
    else:
        # no dx asked: none may come back
        dx_err, dx_bad = 0.0, (0 if kb[0] is None else x.numel())
    red = max([reduction_error(a, b) for a, b in zip(kf[1:], pf[1:])] +
              [reduction_error(a, b) for a, b in zip(kb[1:], pb[1:])])
    allowed = int(TOL["flip_fraction"] * x.numel())
    fields = {"y_max_abs_err": y_err, "y_outside": y_bad,
              "dx_max_abs_err": dx_err, "dx_outside": dx_bad,
              "reduction_rel_err": red}
    ok = y_bad <= allowed and dx_bad <= allowed and red <= TOL["reduction"]
    return fields, ok, kb, (rstd, mean, scale, shift)


def check_kernels(K):
    """Every plan in float32 and bfloat16 (112²: forward cluster 8,
    backward split or cluster 8; 56²: cluster 2/4; 28² and 7² blocks, 7²
    with unaligned planes; the data's split; a ragged shape) against the
    plain versions; the backward without dx against the full call, bit for
    bit; repeat runs bit for bit at block, cluster and split shapes."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_flags = [(True, False, False), (False, True, False)]
    full_flags = [(r, f, e) for r in (True, False) for f in (True, False)
                  for e in (True, False)]
    grid = [((BATCH, 3, 224, 224), main_flags),
            ((BATCH, 64, 112, 112), main_flags),
            ((BATCH, 256, 56, 56), full_flags),
            ((BATCH, 512, 28, 28), main_flags),
            ((BATCH, 2048, 7, 7), main_flags),
            ((5, 3, 17, 13), full_flags)]
    worst = {"bn_fwd": 0.0, "bn_bwd": 0.0}
    failures = []
    for shape, flags in grid:
        for dtype in (torch.float32, torch.bfloat16):
            plans = {"fwd": plan_name(K, "fwd", shape, dtype),
                     "bwd": plan_name(K, "bwd", shape, dtype),
                     "aligned": K.plan("fwd", shape, dtype).aligned}
            for relu, fix_gamma, exact in flags:
                inputs = bn_inputs(shape, dtype, gen)
                fields, ok, kb, stats = compare_case(K, inputs, dtype, relu,
                                                     fix_gamma, exact)
                x, _, _, _, du = inputs
                nd = K.bn_bwd(du, x, *stats, relu, need_dx=False)
                no_dx = nd[0] is None and all(
                    torch.equal(a, b) for a, b in zip(nd[1:], kb[1:]))
                row = {"phase": "kernels", "shape": list(shape),
                       "dtype": str(dtype).replace("torch.", ""),
                       "relu": relu, "fix_gamma": fix_gamma, "exact": exact,
                       "plan": plans, **fields,
                       "no_dx_bitwise_equal": no_dx, "ok": ok and no_dx}
                emit(row)
                if not row["ok"]:
                    failures.append(row)
                if dtype == torch.float32:
                    worst["bn_fwd"] = max(worst["bn_fwd"],
                                          fields["y_max_abs_err"])
                    worst["bn_bwd"] = max(worst["bn_bwd"],
                                          fields["dx_max_abs_err"])
    # repeat runs are bit for bit identical (no atomics)
    same_all = True
    for shape in ((BATCH, 512, 28, 28), (BATCH, 256, 56, 56),
                  (BATCH, 64, 112, 112), (BATCH, 3, 224, 224)):
        for exact in (False, True):
            x, gamma, beta, c, du = bn_inputs(shape, torch.float32, gen)
            a = K.bn_fwd(x, gamma, beta, c, EPS, False, True, exact)
            b = K.bn_fwd(x, gamma, beta, c, EPS, False, True, exact)
            ga = K.bn_bwd(du, x, a[3], a[1], a[4], a[5], True)
            gb = K.bn_bwd(du, x, a[3], a[1], a[4], a[5], True)
            same = all(torch.equal(u, v) for u, v in zip(a + ga, b + gb))
            emit({"phase": "kernels", "shape": list(shape), "exact": exact,
                  "plan": {"fwd": plan_name(K, "fwd", shape, torch.float32),
                           "bwd": plan_name(K, "bwd", shape, torch.float32)},
                  "repeat_runs_bitwise_equal": same})
            same_all = same_all and same
    if failures or not same_all:
        raise RuntimeError("kernel check failed: %d case(s) out of "
                           "tolerance, repeat-equal=%s" % (len(failures),
                                                           same_all))
    return worst


def model_bn_shapes(mx, network, image_shape, num_classes, batch):
    """Counter of (input shape, fix_gamma, relu, need_dx) over the
    BatchNorms of a zoo network after the BN+ReLU fusion (ResNet-50: 51;
    resnet-20: 20). need_dx is False for the BatchNorm of the data, whose
    gradient the executor never asks for."""
    from mxnet_tpu_torch.executor import fuse_bn_relu
    sym = fuse_bn_relu(mx.models.get_symbol(network, num_classes=num_classes,
                                            image_shape=image_shape))
    internals = sym.get_internals()
    _, out_shapes, _ = internals.infer_shape(data=(batch,) + image_shape,
                                             softmax_label=(batch,))
    shape_of = dict(zip(internals.list_outputs(), out_shapes))
    counts = {}
    for n in sym._topo():
        if n.op is None or n.op.name != "BatchNorm":
            continue
        src, oi = n.inputs[0]
        key = src.name if src.op is None else \
            "%s_%s" % (src.name, src.op.list_outputs(src.attrs)[oi])
        k = (tuple(shape_of[key]), bool(n.attrs.get("fix_gamma", True)),
             bool(n.attrs.get("_fused_relu", False)), src.op is not None)
        counts[k] = counts.get(k, 0) + 1
    return counts


def time_kernels(K, counts, copy_bytes_per_s, model="resnet-50",
                 dtype=None):
    """At every BatchNorm shape of the step (the main path's flags, float32
    unless ``dtype`` says bfloat16): both kernels held against their plain
    versions (the data's backward without dx, as the main path calls it),
    then the per-shape and per-step times of the kernels, their plain
    versions and the PyTorch yardsticks: call ms (one CUDA-event pair
    around one call, host enqueue included), device ms (``graph_ms``) and
    host enqueue µs (``enqueue_us``), beside the plan and the byte bound
    (x, y, du and dx at the dtype's size; the statistics are noise), also
    at the measured copy rate ``copy_bytes_per_s``. Returns the per-step
    sums, the bounds' sums at the copy rate and the worst errors."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.tools.bn_probe import (GRAPH_CALLS, cuda_time,
                                                enqueue_us, graph_ms)
    dtype = dtype or torch.float32
    es = 2 if dtype == torch.bfloat16 else 4
    gen = torch.Generator(device="cuda").manual_seed(1)
    keys = ("ms", "device_ms", "enqueue_us", "plain_ms", "library_ms",
            "library_device_ms", "library_enqueue_us", "bound_ms")
    tot = {k: dict.fromkeys(keys, 0.0) for k in ("bn_fwd", "bn_bwd")}
    tot_copy = {"bn_fwd": 0.0, "bn_bwd": 0.0}
    worst = {"bn_fwd": 0.0, "bn_bwd": 0.0}
    failures = []
    for (shape, fix_gamma, relu, need_dx), n in sorted(counts.items()):
        inputs = bn_inputs(shape, dtype, gen)
        check, ok, _, _ = compare_case(K, inputs, dtype, relu,
                                       fix_gamma, False, need_dx)
        check["ok"] = ok
        worst["bn_fwd"] = max(worst["bn_fwd"], check["y_max_abs_err"])
        worst["bn_bwd"] = max(worst["bn_bwd"], check["dx_max_abs_err"])
        x, gamma, beta, c, du = inputs
        numel = x.numel()
        # one copy of the activations for each call of a graph
        xs = [x] + [x.clone() for _ in range(GRAPH_CALLS - 1)]
        dus = [du] + [du.clone() for _ in range(GRAPH_CALLS - 1)]
        st = K.bn_fwd(x, gamma, beta, c, EPS, fix_gamma, relu, False)
        _, mean, _, rstd, scale, shift = st
        g = torch.ones_like(gamma) if fix_gamma else gamma

        def kern_fwd(i):
            return K.bn_fwd(xs[i], gamma, beta, c, EPS, fix_gamma, relu,
                            False)

        def kern_bwd(i):
            return K.bn_bwd(dus[i], xs[i], rstd, mean, scale, shift, relu,
                            need_dx=need_dx)

        def lib_fwd(i):
            y = F.batch_norm(xs[i], None, None, g, beta, training=True,
                             eps=EPS)
            return F.relu(y, inplace=True) if relu else y

        _, smean, sinv = torch.ops.aten.native_batch_norm(
            x, g, beta, None, None, True, 0.1, EPS)

        def lib_bwd(i):
            return torch.ops.aten.native_batch_norm_backward(
                dus[i], xs[i], g, None, None, smean, sinv, True, EPS,
                [need_dx, True, True])

        def row(kern, plain, lib, sweeps, ops, op):
            dev, method = graph_ms([functools.partial(kern, i)
                                    for i in range(GRAPH_CALLS)])
            lib_dev, lib_method = graph_ms([functools.partial(lib, i)
                                            for i in range(GRAPH_CALLS)])
            return {
                "plan": plan_name(K, op, shape, dtype, need_dx),
                "ms": cuda_time(lambda: kern(0)), "device_ms": dev,
                "enqueue_us": enqueue_us(lambda: kern(0)),
                "plain_ms": cuda_time(plain, reps=5),
                "library_ms": cuda_time(lambda: lib(0)),
                "library_device_ms": lib_dev,
                "library_enqueue_us": enqueue_us(lambda: lib(0)),
                "device_ms_by": sorted({method, lib_method}),
                "bound_ms": 1e3 * max(sweeps * numel * es / HBM_BYTES_PER_S,
                                      ops * numel / F32_FLOPS_PER_S)}

        # forward: read x, write y; ~7 float32 operations an element.
        # backward: read x and du (and write dx); ~16 operations.
        bwd_sweeps = 3 if need_dx else 2
        fwd = row(kern_fwd, lambda: K.bn_fwd_plain(
            x, gamma, beta, c, EPS, fix_gamma, relu, False), lib_fwd, 2, 7,
            "fwd")
        bwd = row(kern_bwd, lambda: K.bn_bwd_plain(
            du, x, rstd, mean, scale, shift, relu, need_dx=need_dx),
            lib_bwd, bwd_sweeps, 16, "bwd")
        at_copy = {"bn_fwd": 1e3 * 2 * numel * es / copy_bytes_per_s,
                   "bn_bwd": 1e3 * bwd_sweeps * numel * es / copy_bytes_per_s}
        out = {"phase": "kernel_times", "model": model, "shape": list(shape),
               "dtype": str(dtype).replace("torch.", ""),
               "fix_gamma": fix_gamma, "relu": relu, "need_dx": need_dx,
               "per_step": n, "check": check, "bn_fwd": fwd, "bn_bwd": bwd,
               "bound_ms_at_measured_copy": at_copy}
        emit(out)
        if not ok:
            failures.append(out)
        for name, t in (("bn_fwd", fwd), ("bn_bwd", bwd)):
            tot_copy[name] += n * at_copy[name]
            for key in keys:
                tot[name][key] += n * t[key]
        del x, du, xs, dus, st, inputs
    if failures:
        raise RuntimeError("kernel check failed at %d step shape(s): %s"
                           % (len(failures), json.dumps(
                               [f["shape"] for f in failures])))
    return tot, tot_copy, worst


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------
def resnet50_module(mx, ctx, batch, arg_params=None, aux_params=None,
                    **kwargs):
    """ResNet-50 bound and initialised (Xavier from ``mx.random``'s seed,
    or the given parameters); ``kwargs`` go to ``Module``."""
    sym = mx.models.get_symbol("resnet-50", num_classes=1000,
                               image_shape=IMAGE)
    mod = mx.mod.Module(sym, context=ctx, **kwargs)
    mod.bind(data_shapes=[("data", (batch,) + IMAGE)],
             label_shapes=[("softmax_label", (batch,))])
    mod.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2), arg_params=arg_params,
                    aux_params=aux_params)
    return mod


def synthetic_batch(mx, ctx, batch, seed, image=None):
    """One batch of gaussian images (``IMAGE`` unless ``image``) and
    labels in [0, 1000), from numpy seed ``seed``, on ``ctx``."""
    import numpy as np
    rs = np.random.RandomState(seed)
    x = rs.randn(batch, *(image or IMAGE)).astype(np.float32)
    y = rs.randint(0, 1000, (batch,)).astype(np.float32)
    return mx.io.DataBatch([mx.nd.array(x, ctx=ctx)],
                           [mx.nd.array(y, ctx=ctx)])


def main_path(mx, K, card):
    import numpy as np
    import torch
    mx.random.seed(0)
    ctx = mx.gpu(0)
    mod = resnet50_module(mx, ctx, BATCH)
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
        "rescale_grad": 1.0 / BATCH})
    batch = synthetic_batch(mx, ctx, BATCH, seed=0)
    before = {k: mod.get_params()[0][k].asnumpy()
              for k in ("conv0_weight", "fc1_weight")}
    torch.cuda.synchronize()
    K.bn_fwd.launches = 0
    K.bn_bwd.launches = 0
    step_ms = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    launches = {"bn_fwd": K.bn_fwd.launches, "bn_bwd": K.bn_bwd.launches}
    out = mod.get_outputs()[0].asnumpy()
    args, aux = mod.get_params()
    finite = bool(np.isfinite(out).all()) and all(
        np.isfinite(v.asnumpy()).all()
        for v in list(args.values()) + list(aux.values()))
    changed = all(not np.array_equal(before[k], args[k].asnumpy())
                  for k in before)
    ms = statistics.median(step_ms[1:])
    row = {"phase": "main_path", "model": "resnet-50", "image": [3, 224, 224],
           "route": type(mod._exec_group).__name__,
           "classes": 1000, "batch": BATCH, "dtype": "float32",
           "steps": STEPS, "step_ms": step_ms, "ms_per_step": ms,
           "img_per_s": BATCH / (ms / 1e3), "launches": launches,
           "outputs_shape": list(out.shape), "finite": finite,
           "params_changed": changed, "card": card}
    emit(row)
    want = BN_PER_STEP * STEPS
    if not (finite and changed and out.shape == (BATCH, 1000)
            and row["route"] == "MeshExecutorGroup"
            and launches == {"bn_fwd": want, "bn_bwd": want}):
        raise RuntimeError("main path failed: %s" % json.dumps(row))
    return launches, row["img_per_s"]


SGD_PARAMS = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
              "rescale_grad": 1.0 / BATCH}
ROUTE_STEPS = 3
ROUTE_REL_L2 = 1e-6     # the fallback limit if the routes are not bitwise


class deterministic_cudnn(object):
    """cuDNN's deterministic algorithms (and no autotuning) for a block."""

    def __enter__(self):
        import torch
        b = torch.backends.cudnn
        self.saved = (b.deterministic, b.benchmark)
        b.deterministic, b.benchmark = True, False

    def __exit__(self, *exc):
        import torch
        b = torch.backends.cudnn
        b.deterministic, b.benchmark = self.saved


def host_params(mod):
    """A module's parameters and aux as host numpy arrays, by name."""
    args, aux = mod.get_params()
    return {k: v.asnumpy() for k, v in list(args.items()) +
            list(aux.items())}


def fused_vs_classic(mx, card):
    """The fused route (the default) against the classic route
    (``_allow_fused=False``): 3 ResNet-50 steps each from the same
    parameters, cuDNN deterministic for both. The float32 parameters must
    agree bit for bit; where they do not, the row names the parameters
    that differ and the largest relative L2 distance, held to
    ``ROUTE_REL_L2``."""
    import numpy as np
    ctx = mx.gpu(0)
    batch = synthetic_batch(mx, ctx, BATCH, seed=0)
    mx.random.seed(0)
    res, args, aux = {}, None, None
    with deterministic_cudnn():
        for route, kw in (("fused", {}), ("classic",
                                          {"_allow_fused": False})):
            mod = resnet50_module(mx, ctx, BATCH, args, aux, **kw)
            if args is None:
                a, x = mod.get_params()
                args = {k: v.copy() for k, v in a.items()}
                aux = {k: v.copy() for k, v in x.items()}
            mod.init_optimizer(optimizer="sgd", optimizer_params=SGD_PARAMS)
            for _ in range(ROUTE_STEPS):
                mod.forward_backward(batch)
                mod.update()
            res[route] = (type(mod._exec_group).__name__, host_params(mod))
            del mod
    (fk, fp), (ck, cp) = res["fused"], res["classic"]
    differ = [k for k in fp if not np.array_equal(fp[k], cp[k])]
    worst = max([rel_l2(fp[k], cp[k]) for k in differ] or [0.0])
    row = {"phase": "main_path_routes", "steps": ROUTE_STEPS,
           "groups": [fk, ck], "params": len(fp),
           "bitwise_equal": not differ, "params_differing": differ[:10],
           "n_params_differing": len(differ), "worst_rel_l2": worst,
           "limit_rel_l2": ROUTE_REL_L2, "card": card}
    if differ:
        row["why"] = ("the two routes gave other bits on the card; the "
                      "first differing parameters are listed (CPU: bit "
                      "for bit, tests/test_torch_fused.py)")
    row["ok"] = (fk == "MeshExecutorGroup" and
                 ck == "DataParallelExecutorGroup" and worst <= ROUTE_REL_L2)
    emit(row)
    if not row["ok"]:
        raise RuntimeError("fused and classic routes disagree: %s"
                           % json.dumps(row))


def card_vs_cpu(mx, K):
    """One ResNet-50 forward_backward at batch 2 from identical weights, on
    the card (kernels) and on the CPU (plain versions). The card also runs
    it with the plain versions in place of the kernels, which shows how
    far the card's own rounding moves each gradient. bn0_gamma is reported
    and not held to a limit: its gradient is a sum that cancels to ~1e-4
    of its terms, so rounding alone moves it by several percent."""
    import numpy as np
    from mxnet_tpu_torch.ops import nn as nn_ops
    mx.random.seed(1)
    cpu_mod = resnet50_module(mx, mx.cpu(), 2)
    args, aux = cpu_mod.get_params()
    limits = {"out": TOL["cpu_top"], "fc1_weight": TOL["cpu_top"],
              "bn1_gamma": TOL["cpu_top"],
              "stage4_unit3_bn3_gamma": TOL["cpu_deep"],
              "conv0_weight": TOL["cpu_deep"], "bn0_gamma": None}

    def run(mod, ctx):
        mod.forward_backward(synthetic_batch(mx, ctx, 2, seed=5))
        grads = dict(zip(mod._param_names, mod._exec_group.grad_arrays))
        res = {k: grads[k][0].asnumpy() for k in limits if k != "out"}
        res["out"] = mod.get_outputs()[0].asnumpy()
        return res

    res = {"cpu": run(cpu_mod, mx.cpu()),
           "card": run(resnet50_module(mx, mx.gpu(0), 2, arg_params=args,
                                       aux_params=aux), mx.gpu(0))}
    nn_ops.bn_fwd, nn_ops.bn_bwd = K.bn_fwd_plain, K.bn_bwd_plain
    try:
        res["card_plain"] = run(resnet50_module(
            mx, mx.gpu(0), 2, arg_params=args, aux_params=aux), mx.gpu(0))
    finally:
        nn_ops.bn_fwd, nn_ops.bn_bwd = K.bn_fwd, K.bn_bwd

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    row = {"phase": "card_vs_cpu", "batch": 2}
    ok = True
    for k, lim in limits.items():
        a, b = res["card"][k], res["cpu"][k]
        row[k] = {"rel_l2_err": rel(a, b), "limit": lim,
                  "card_plain_vs_cpu": rel(res["card_plain"][k], b),
                  "card_vs_card_plain": rel(a, res["card_plain"][k])}
        ok = ok and bool(np.isfinite(a).all()) and \
            (lim is None or rel(a, b) <= lim)
    row["ok"] = ok
    emit(row)
    if not ok:
        raise RuntimeError("card and CPU disagree: %s" % json.dumps(row))


# ---------------------------------------------------------------------------
# phase precision: the precision modes on the fused route
# ---------------------------------------------------------------------------
PRECISION_MODES = ("f32", "bf16", "bf16_opt", "combined",
                   "custom(remat=full)")
PRECISION_STEPS = 5
# bf16 softmax outputs after one step against f32's, relative L2: stated
# before the first run from the port's own ResNet-50 on the CPU at batch
# 4 (0.049); the card's cuDNN convolutions accumulate in float32 as the
# CPU's do
BF16_OUT_REL_L2 = 0.15
GROUP_BATCHES, GROUP_K = 8, 4


def precision_policy(mx, name):
    if name == "custom(remat=full)":
        return mx.precision.PrecisionPolicy(remat="full")
    return name


def bn_replays(mod):
    """BatchNorm forwards a remat step replays, from the segment plan:
    the backward replays every segment once, so each BatchNorm inside a
    segment launches its forward a second time."""
    fn = mod._exec_group._remat_eval_fn
    if fn is None:
        return 0
    bns = {n.name for n in mod._exec_group.symbol._topo()
           if n.op is not None and n.op.name == "BatchNorm"}
    return sum(1 for seg in fn.segments for name in seg if name in bns)


def precision_run(mx, K, name, args, aux, batch):
    """One mode: ResNet-50 from ``args``/``aux``, SGD as phase 4,
    ``PRECISION_STEPS`` steps on ``batch``. Returns (row, host params,
    the first step's softmax outputs)."""
    import gc
    import numpy as np
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    mod = resnet50_module(mx, mx.gpu(0), BATCH, args, aux,
                          precision=precision_policy(mx, name))
    mod.init_optimizer(optimizer="sgd", optimizer_params=SGD_PARAMS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in (K.bn_fwd, K.bn_bwd):
        k.launches = k.launches_bf16 = 0
    step_ms, first = [], None
    for i in range(PRECISION_STEPS):
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        if i == 0:
            first = mod.get_outputs()[0].asnumpy()
    peak = torch.cuda.max_memory_allocated()
    launches = {k: getattr(K, k).launches for k in ("bn_fwd", "bn_bwd")}
    bf16 = {k: getattr(K, k).launches_bf16 for k in ("bn_fwd", "bn_bwd")}
    params = host_params(mod)
    ms = statistics.median(step_ms[1:])
    replays = bn_replays(mod)
    is_bf16 = mod._compute_dtype == "bfloat16"
    want = {"bn_fwd": (BN_PER_STEP + replays) * PRECISION_STEPS,
            "bn_bwd": BN_PER_STEP * PRECISION_STEPS}
    want_bf16 = want if is_bf16 else {"bn_fwd": 0, "bn_bwd": 0}
    states = [leaf for st in mod._updater.states.values()
              for leaf in (st if isinstance(st, (tuple, list)) else [st])
              if leaf is not None]
    out = mod.get_outputs()[0].asnumpy()
    row = {"mode": mod.precision_mode, "policy": mod._precision.describe()
           if mod._precision is not None else None,
           "steps": PRECISION_STEPS, "step_ms": step_ms, "ms_per_step": ms,
           "img_per_s": BATCH / (ms / 1e3), "peak_memory_bytes": peak,
           "bn_launches": launches, "bn_launches_bf16": bf16,
           "bn_launches_per_step": {k: v / PRECISION_STEPS
                                    for k, v in launches.items()},
           "bn_dtype": "bfloat16" if is_bf16 else "float32",
           "bn_replays_per_step": replays, "want_launches": want,
           "optimizer_state_dtype": str(states[0]._read().dtype)
           .replace("torch.", "") if states else None,
           "loss_scale": mod._exec_group.loss_scale(),
           "finite": bool(np.isfinite(out).all()) and all(
               np.isfinite(v).all() for v in params.values()),
           "params_changed": not np.array_equal(params["fc1_weight"],
                                                args["fc1_weight"].asnumpy())}
    row["launches_ok"] = launches == want and bf16 == want_bf16
    del mod
    return row, params, first


def grouped_fit_check(mx, args, aux):
    """``fit(batch_group=4)`` over 8 batches against 8 per-batch ``fit``
    steps in ``bf16``: parameters bit for bit; the grouped run's device
    tally of accuracy and cross-entropy against the per-batch run's host
    metric (random labels over 1000 classes leave the accuracy near 0,
    so the cross-entropy is the value that tells)."""
    import numpy as np
    rs = np.random.RandomState(3)
    n = GROUP_BATCHES * BATCH
    x = rs.randn(n, *IMAGE).astype(np.float32)
    y = rs.randint(0, 1000, n).astype(np.float32)
    res = {}
    for name, group, device_metric in (("per_batch", None, "0"),
                                       ("grouped", GROUP_K, "1")):
        os.environ["MXNET_DEVICE_METRIC"] = device_metric
        try:
            mod = mx.mod.Module(mx.models.get_symbol(
                "resnet-50", num_classes=1000, image_shape=IMAGE),
                context=mx.gpu(0), precision="bf16")
            metric = mx.metric.create(["acc", "ce"])
            t0 = time.perf_counter()
            mod.fit(mx.io.NDArrayIter(x, y, batch_size=BATCH),
                    eval_metric=metric, arg_params=args, aux_params=aux,
                    optimizer="sgd", optimizer_params=SGD_PARAMS,
                    num_epoch=1, batch_group=group)
            seconds = time.perf_counter() - t0
        finally:
            os.environ.pop("MXNET_DEVICE_METRIC", None)
        res[name] = (host_params(mod), metric.get()[1], seconds,
                     mod.grouped_train_engaged(),
                     mod._exec_group._metric_live is metric)
        del mod
    (pa, acc_a, sa, ga, la), (pb, acc_b, sb, gb, lb) = res["per_batch"], \
        res["grouped"]
    bitwise = all(np.array_equal(pa[k], pb[k]) for k in pa)
    return {"batches": GROUP_BATCHES, "batch_group": GROUP_K,
            "params_bitwise_equal": bitwise,
            "host_metric_acc_ce": acc_a, "device_tally_acc_ce": acc_b,
            "grouped_engaged": gb and not ga,
            "device_tally_live": lb and not la,
            "fit_s": {"per_batch": sa, "grouped": sb},
            "ok": bitwise and gb and not ga and lb and not la and
            all(abs(a - b) <= 1e-5 * max(abs(a), 1e-30)
                for a, b in zip(acc_a, acc_b))}


def bf16_opt_resume_check(mx, args, aux, batch):
    """A ``bf16_opt`` run checkpointed after 2 steps and continued 2 more,
    against ``Module.load`` of that entry (the mode and the bf16
    optimizer state adopted) continued the same 2 steps: bit for bit."""
    import shutil
    import numpy as np
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    path = os.path.join(ROOT, "build", "precision", "bf16_opt")
    shutil.rmtree(path, ignore_errors=True)
    mgr = CheckpointManager(path)
    a = resnet50_module(mx, mx.gpu(0), BATCH, args, aux, precision="bf16_opt")
    a.init_optimizer(optimizer="sgd", optimizer_params=SGD_PARAMS)
    for _ in range(2):
        a.forward_backward(batch)
        a.update()
    a.save_checkpoint(None, 2, save_optimizer_states=True, manager=mgr,
                      async_save=False)
    for _ in range(2):
        a.forward_backward(batch)
        a.update()
    pa = host_params(a)
    del a
    b = mx.mod.Module.load(mgr, load_optimizer_states=True,
                           context=mx.gpu(0))
    b.bind(data_shapes=[("data", (BATCH,) + IMAGE)],
           label_shapes=[("softmax_label", (BATCH,))])
    b.init_optimizer(optimizer="sgd", optimizer_params=SGD_PARAMS)
    for _ in range(2):
        b.forward_backward(batch)
        b.update()
    pb = host_params(b)
    mode = b.precision_mode
    dtypes = sorted({str(leaf._read().dtype) for st in
                     b._updater.states.values() for leaf in
                     (st if isinstance(st, (tuple, list)) else [st])})
    del b
    bitwise = all(np.array_equal(pa[k], pb[k]) for k in pa)
    return {"restored_mode": mode, "restored_state_dtypes": dtypes,
            "continued_bitwise_equal": bitwise,
            "ok": bitwise and mode == "bf16_opt" and
            dtypes == ["torch.bfloat16"]}


PROFILE_STEPS = 2
KERNEL_KINDS = (
    ("bn", ("fwd_slab", "bwd_slab", "fwd_partials", "fwd_apply",
            "bwd_partials", "bwd_apply")),
    ("conv_gemm", ("conv", "gemm", "xmma", "cutlass", "cudnn", "fprop",
                   "dgrad", "wgrad", "nhwc", "nchw")),
    ("elementwise", ("elementwise", "vectorized")),
    ("reduce", ("reduce",)),
    ("copy", ("copy", "memcpy", "memset", "fill")))


def kernel_kind(name):
    low = name.lower()
    for kind, keys in KERNEL_KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def merged_us(spans):
    """Microseconds covered by the sorted (start, end) spans, overlaps
    counted once: the device's busy time."""
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return busy + cur_e - cur_s


def step_profile(mx, name, args, aux, batch):
    """Where one step's time goes in mode ``name``: 5 steps timed on
    the host clock (median of the last 3: the wall to a synchronise, and
    the host's enqueue, until ``update()`` returns), then
    ``PROFILE_STEPS`` steps under ``torch.profiler``: the host wall a
    step, the kernels' summed device time and their busy time (union of
    their intervals) a step, the device's idle share of the wall, and the
    device time and kernel count by kind (conv/GEMM, BN kernels,
    elementwise, reductions, copies, other). "not measured" where the
    trace holds no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    mod = resnet50_module(mx, mx.gpu(0), BATCH, args, aux,
                          precision=precision_policy(mx, name))
    mod.init_optimizer(optimizer="sgd", optimizer_params=SGD_PARAMS)
    enqueue, wall = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enqueue.append(1e3 * (t1 - t0))
        wall.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            mod.forward_backward(batch)
            mod.update()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    del mod
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    row = {"mode": name, "steps": PROFILE_STEPS,
           "unprofiled_ms_per_step": statistics.median(wall[2:]),
           "unprofiled_host_enqueue_ms_per_step":
               statistics.median(enqueue[2:]),
           "host_wall_ms_per_step": wall_us / 1e3 / PROFILE_STEPS}
    if not kern:
        row["device"] = "not measured"
        return row
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy = merged_us(spans)
    window = max(spans[-1][1] - spans[0][0], 1e-9)
    kinds, names = {}, {}
    for e in kern:
        us = e.time_range.end - e.time_range.start
        k = kinds.setdefault(kernel_kind(e.name), [0.0, 0])
        k[0] += us
        k[1] += 1
        names[e.name] = names.get(e.name, 0.0) + us
    n = PROFILE_STEPS
    row.update({
        "kernels_per_step": len(kern) / n,
        "kernel_ms_per_step": sum(v[0] for v in kinds.values()) / 1e3 / n,
        "device_busy_ms_per_step": busy / 1e3 / n,
        "device_idle_share_of_wall": 1.0 - busy / max(wall_us, 1e-9),
        "device_idle_share_of_kernel_window": 1.0 - busy / window,
        "by_kind": {k: {"ms_per_step": v[0] / 1e3 / n,
                        "kernels_per_step": v[1] / n}
                    for k, v in sorted(kinds.items())},
        "top_kernels_ms_per_step": [
            [nm[:80], us / 1e3 / n] for nm, us in
            sorted(names.items(), key=lambda kv: -kv[1])[:6]]})
    return row


def precision_phase(mx, K, card):
    """ResNet-50 (224², 1000 classes, batch 32, SGD as phase 4, one
    synthetic batch, cuDNN deterministic) in each of ``PRECISION_MODES``,
    twice from the same parameters: ms a step, img/s, peak memory, BN
    launches a step and their dtype, finite outputs, changed parameters,
    the loss scale. Gates: each mode repeats bit for bit; the bf16
    softmax outputs after one step within ``BF16_OUT_REL_L2`` of f32's;
    ``combined`` and remat=full under f32's peak memory; the exact BN
    launch counts (replays from the segment plan); ``fit(batch_group=4)``
    against 8 per-batch steps and the device tally against the host
    metric; a bf16_opt checkpoint resumed bit for bit. Returns the bf16
    mode's BN launches."""
    import numpy as np
    ctx = mx.gpu(0)
    batch = synthetic_batch(mx, ctx, BATCH, seed=0)
    mx.random.seed(0)
    init = resnet50_module(mx, ctx, BATCH)
    a, x = init.get_params()
    args = {k: v.copy() for k, v in a.items()}
    aux = {k: v.copy() for k, v in x.items()}
    del init
    rows, firsts, failed = {}, {}, []
    with deterministic_cudnn():
        for name in PRECISION_MODES:
            row, params, first = precision_run(mx, K, name, args, aux, batch)
            _, again, first2 = precision_run(mx, K, name, args, aux, batch)
            row["repeat_bitwise_equal"] = all(
                np.array_equal(params[k], again[k]) for k in params) and \
                np.array_equal(first, first2)
            del params, again
            rows[name], firsts[name] = row, first
        grouped = grouped_fit_check(mx, args, aux)
        resume = bf16_opt_resume_check(mx, args, aux, batch)
        profiles = []
        for name in ("f32", "bf16", "combined"):
            try:
                profiles.append(step_profile(mx, name, args, aux, batch))
            except Exception as e:     # diagnostics: never fail the phase
                profiles.append({"mode": name, "device": "not measured",
                                 "error": repr(e)})
    rel = rel_l2(firsts["bf16"], firsts["f32"])
    peak32 = rows["f32"]["peak_memory_bytes"]
    for name, row in rows.items():
        row["ok"] = (row["repeat_bitwise_equal"] and row["finite"] and
                     row["params_changed"] and row["launches_ok"])
        if name in ("combined", "custom(remat=full)"):
            row["peak_below_f32"] = row["peak_memory_bytes"] < peak32
            row["ok"] = row["ok"] and row["peak_below_f32"]
        if name == "bf16":
            row["out_rel_l2_vs_f32"] = rel
            row["out_limit"] = BF16_OUT_REL_L2
            row["ok"] = row["ok"] and rel <= BF16_OUT_REL_L2
        emit({"phase": "precision", "card": card, **row})
        if not row["ok"]:
            failed.append(name)
    emit({"phase": "precision_grouped_fit", "mode": "bf16", **grouped,
          "card": card})
    emit({"phase": "precision_bf16_opt_resume", **resume, "card": card})
    for prof in profiles:
        emit({"phase": "precision_profile", **prof, "card": card})
    failed += [n for n, r in (("grouped fit", grouped),
                              ("bf16_opt resume", resume)) if not r["ok"]]
    if failed:
        raise RuntimeError("precision phase failed: %s" % ", ".join(failed))
    return rows["bf16"]["bn_launches_bf16"]


# ---------------------------------------------------------------------------
# phase 2: the copy probe
# ---------------------------------------------------------------------------
def copy_phase(C, card):
    """The copy sweep through its entry point, with the copy kernel's
    count reset just before and read just after. Returns the kernels-line
    entry and the measured copy roofline (the best device rate) in
    bytes/s."""
    import torch
    from mxnet_tpu_torch.tools import bn_probe
    t0 = time.time()
    C.copy.launches = 0
    rows = bn_probe.copy_sweep()
    launches = C.copy.launches
    for row in rows:
        emit({"phase": "copy", **row})
    best = max(rows, key=lambda r: r["gb_per_s"])
    kern = next(r for r in rows
                if r["config"] and r["config"]["unroll"] == C.UNROLL)
    lib = next(r for r in rows if r["route"] == "copy_")
    times = ("ms", "device_ms", "enqueue_us")
    emit({"phase": "copy_roofline", "measured_copy_gb_per_s":
          best["gb_per_s"], "route": best["route"], "config": best["config"],
          "kernel": {"config": kern["config"],
                     **{k: kern[k] for k in times}},
          "library": {k: lib[k] for k in times},
          "bound_ms": kern["bound_ms"], "launches": launches,
          "seconds_incl_build": time.time() - t0, "card": card})
    # ragged byte counts (a tail of 3 and 15 bytes; 5 bytes: no body), in
    # every swept configuration
    ragged = {}
    gen = torch.Generator(device="cuda").manual_seed(3)
    for n_bytes in (5, 1000003, 12345679):
        x = torch.randint(0, 256, (n_bytes,), dtype=torch.uint8,
                          device="cuda", generator=gen)
        ragged[n_bytes] = all(torch.equal(C.copy(x, None, u), x)
                              for u in C.COPY_SWEEP)
    emit({"phase": "copy_ragged", "bitwise_equal": ragged})
    if not all(r["bitwise_equal"] for r in rows) or launches == 0 \
            or not all(ragged.values()):
        raise RuntimeError("copy phase failed: launches=%d, rows=%s, "
                           "ragged=%s" % (launches, json.dumps(rows),
                                          ragged))
    entry = dict(name="copy", route="cuda",
                 source="mxnet_tpu_torch/kernels/csrc/copy.cu + "
                        "mxnet_tpu_torch/kernels/csrc/stream.cuh",
                 replaces="tools/bn_pallas_probe.py:326", launches=launches,
                 max_abs_err=0.0, ms=kern["ms"], plain_ms=lib["ms"],
                 bound_ms=kern["bound_ms"], bound_by="bytes",
                 library_ms=lib["ms"])
    return entry, best["gb_per_s"] * 1e9


# ---------------------------------------------------------------------------
# phase 6: rtc user kernels
# ---------------------------------------------------------------------------
# name, input names, output names, body, exact (+ - *, where, maximum only)
RTC_BODIES = [
    ("axpy", ["x", "y"], ["z"], "z_ref[...] = x_ref[...] * 2.0 + y_ref[...]",
     True),
    ("square", ["x"], ["o"], "o_ref[...] = x_ref[...] ** 2", True),
    ("exp_tanh", ["x", "y"], ["o"],
     "o_ref[...] = jnp.exp(-x_ref[...] * x_ref[...]) "
     "+ jnp.tanh(y_ref[...])", False),
    ("where_max", ["x", "y"], ["o"],
     "o_ref[...] = jnp.where(x_ref[...] > 0.0, "
     "jnp.maximum(x_ref[...], y_ref[...]), y_ref[...] * 0.5)", True),
    ("two_outputs", ["x", "y"], ["s", "d"],
     "t = x_ref[...] - y_ref[...]\n"
     "s_ref[...] = x_ref[...] + y_ref[...]\n"
     "d_ref[...] = t * t", True),
]
RTC_SHAPES = [(BATCH, 256, 56, 56), (5, 3, 17, 13)]


def rtc_library(name):
    """(text, function) of the one PyTorch call that computes the body
    ``name``, or None: the other bodies take more than one call."""
    import torch
    return {"axpy": ("torch.add(y, x, alpha=2.0)",
                     lambda x, y: torch.add(y, x, alpha=2.0)),
            "square": ("torch.square(x)", torch.square)}.get(name)


def rtc_errors(kern, plain, exact):
    """(max abs error, elements outside tolerance) of one output."""
    import torch
    err = (kern - plain).abs()
    if exact:
        big = torch.maximum(kern.abs(), plain.abs())
        ulp = torch.nextafter(big, torch.full_like(big, float("inf"))) - big
        bad = int((err > TOL["rtc_exact_ulps"] * ulp).sum())
    else:
        bad = int((err > TOL["rtc_transcendental"]
                   * float(plain.abs().max())).sum())
    return float(err.max()), bad


def rtc_times(R, rtc, xs, ys, copy_rate):
    """Call ms, device ms (one set of inputs: 205–411 MB, far above L2)
    and host enqueue µs of one body's kernel, and of the PyTorch call that
    computes the same function where there is one (``rtc_library``; None
    elsewhere); the plain version's call ms; the byte bound (each input
    read once, each output written once) at 3.35 TB/s and at the measured
    copy rate."""
    from mxnet_tpu_torch.tools.bn_probe import (GRAPH_CALLS, cuda_time,
                                                enqueue_us, graph_ms)
    ck = rtc._ck
    ins, outs = [a._read() for a in xs], [a._read() for a in ys]

    def three(fn):
        dev, method = graph_ms([fn] * GRAPH_CALLS)
        return cuda_time(fn), dev, enqueue_us(fn), method

    ms, dev, enq, by = three(lambda: R.rtc_kernel(ck, ins, outs))
    nbytes = (len(ins) + len(outs)) * 4 * ins[0].numel()
    t = {"ms": ms, "device_ms": dev, "enqueue_us": enq,
         "plain_ms": cuda_time(lambda: R.rtc_plain(ck, ins, outs), reps=5),
         "library": None, "library_ms": None, "library_device_ms": None,
         "library_enqueue_us": None, "device_ms_by": [by],
         "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
         "bound_ms_at_measured_copy": 1e3 * nbytes / copy_rate}
    lib = rtc_library(rtc.name)
    if lib is not None:
        call, fn = lib
        lms, ldev, lenq, lby = three(lambda: fn(*ins))
        t.update(library=call, library_ms=lms, library_device_ms=ldev,
                 library_enqueue_us=lenq, device_ms_by=sorted({by, lby}))
    return t


# the plan check's cases: element offsets of the inputs and outputs.
# Refs 4 bytes past a 16-byte boundary (a head of 3 elements, every ref
# as vectors); refs that differ mod 16 (the first input and output at 8
# bytes: vectors; the second input at 0 and the second output at 4:
# words)
RTC_CASES = {"offset_4": ((1, 1), (1, 1)),
             "mixed": ((2, 0), (2, 1))}


def rtc_plans(R, runs):
    """Every body at both shapes in each case of ``RTC_CASES`` against
    the plain version on the same inputs; returns the rows and the device
    ms of axpy at full size in each case."""
    import torch
    from mxnet_tpu_torch.kernels import stream
    from mxnet_tpu_torch.tools.bn_probe import GRAPH_CALLS, graph_ms
    rows, times = [], {}
    for shape, name, exact, rtc, xs, _ in runs:
        ck, n = rtc._ck, xs[0].size
        src = [x._read() for x in xs]
        for case, (e_in, e_out) in sorted(RTC_CASES.items()):

            def view(e, fill=None):
                v = torch.empty(n + 4, device="cuda")[e:e + n].view(shape)
                return v.copy_(fill) if fill is not None else v
            ins = [view(e_in[i], x) for i, x in enumerate(src)]
            outs = [view(e_out[j]) for j in range(ck.n_out)]
            R.rtc_kernel(ck, ins, outs)
            plain = [torch.empty_like(ins[0]) for _ in outs]
            R.rtc_plain(ck, ins, plain)
            torch.cuda.synchronize()
            p_refs = ins + outs
            p = stream.plan(n, tuple(t.data_ptr() % 16 for t in p_refs),
                            ck.n_in, ck.n_out)
            for j, (o, q) in enumerate(zip(outs, plain)):
                err, bad = rtc_errors(o, q, exact)
                rows.append({"phase": "rtc_plan", "body": name,
                             "shape": list(shape), "case": case,
                             "head": p.head, "tail": p.tail,
                             "grid": p.grid, "vec_mask": p.vec_mask,
                             "words": p.vec_mask != 2 ** len(p_refs) - 1,
                             "output": j, "max_abs_err": err,
                             "outside": bad})
            if name == "axpy" and shape == RTC_SHAPES[0]:
                times[case] = graph_ms([lambda: R.rtc_kernel(
                    ck, ins, outs)] * GRAPH_CALLS)[0]
            del ins, outs, plain
    return rows, times


def rtc_checked(mx):
    """The checked kernel of every body, as ``mx.rtc.Rtc`` checks it."""
    x = mx.nd.zeros((1,), ctx=mx.cpu())
    return [mx.rtc.Rtc(name, [(i, x) for i in ins], [(o, x) for o in outs],
                       body)._ck for name, ins, outs, body, _ in RTC_BODIES]


def rtc_phase(mx, R, card, copy_rate):
    """Push every body through ``mx.rtc.Rtc`` on the card at both shapes
    (counts reset just before, read just after; one key pushed twice;
    the bodies were built in the build phase, one build each), then hold
    each output against the plain version on the same inputs, check refs
    off 16-byte boundaries (``rtc_plans``) and time every body at full size
    (``rtc_times``)."""
    import torch
    from mxnet_tpu_torch.tools.bn_probe import enqueue_us
    gen = torch.Generator(device="cuda").manual_seed(2)
    ctx = mx.gpu(0)
    runs = []
    for shape in RTC_SHAPES:
        for name, ins, outs, body, exact in RTC_BODIES:
            xs = [mx.nd.NDArray(torch.randn(shape, device="cuda",
                                            generator=gen), ctx=ctx)
                  for _ in ins]
            ys = [mx.nd.zeros(shape, ctx=ctx) for _ in outs]
            rtc = mx.rtc.Rtc(name, list(zip(ins, xs)), list(zip(outs, ys)),
                             body)
            runs.append((shape, name, exact, rtc, xs, ys))
    torch.cuda.synchronize()
    R.rtc_kernel.launches = 0
    compiles0 = R.rtc_kernel.compiles
    first_push_s = {}
    for shape, name, _, rtc, xs, ys in runs:
        t0 = time.perf_counter()
        rtc.push(xs, ys)
        torch.cuda.synchronize()
        first_push_s["%s@%s" % (name, "x".join(map(str, shape)))] = \
            time.perf_counter() - t0
    push_compiles = R.rtc_kernel.compiles - compiles0
    shape, name, _, rtc, xs, ys = runs[0]       # axpy at full size again
    t0 = time.perf_counter()
    rtc.push(xs, ys)
    torch.cuda.synchronize()
    second_push_s = time.perf_counter() - t0
    recompiles = R.rtc_kernel.compiles - compiles0 - push_compiles
    launches = R.rtc_kernel.launches

    worst, failures = 0.0, []
    for shape, name, exact, rtc, xs, ys in runs:
        ins = [x._read() for x in xs]
        plain = [torch.empty_like(ins[0]) for _ in ys]
        R.rtc_plain(rtc._ck, ins, plain)
        torch.cuda.synchronize()
        for y, p in zip(ys, plain):
            err, bad = rtc_errors(y._read(), p, exact)
            row = {"phase": "rtc", "body": name, "shape": list(shape),
                   "exact": exact, "max_abs_err": err,
                   "plain_max_abs": float(p.abs().max()), "outside": bad}
            emit(row)
            worst = max(worst, err)
            if bad:
                failures.append(row)
    plan_rows, case_ms = rtc_plans(R, runs)
    for row in plan_rows:
        emit(row)
        if row["outside"]:
            failures.append(row)
    words = {r["words"] for r in plan_rows}

    timed = {name: rtc_times(R, rtc, xs, ys, copy_rate)
             for shape, name, _, rtc, xs, ys in runs
             if shape == RTC_SHAPES[0]}
    for name, t in timed.items():
        emit({"phase": "rtc_times", "body": name,
              "shape": list(RTC_SHAPES[0]), **t, "card": card})
    _, _, _, rtc, xs, ys = runs[0]
    ins, outs = [a._read() for a in xs], [a._read() for a in ys]
    check_us = enqueue_us(lambda: R.check_tensors(rtc._ck, ins, outs))
    axpy = timed["axpy"]
    row = {"phase": "rtc_summary", "launches": launches,
           "compiles": R.rtc_kernel.compiles,
           "compiles_in_pushes": push_compiles,
           "recompiles_on_second_push": recompiles,
           "refs_as_words_and_as_vectors_checked": sorted(words),
           "axpy_device_ms_by_case": case_ms,
           "first_push_s": first_push_s, "second_push_s": second_push_s,
           "check_tensors_us": check_us, "card": card}
    emit(row)
    if failures or recompiles or push_compiles or \
            R.rtc_kernel.compiles != len(RTC_BODIES) or \
            launches != len(runs) + 1 or words != {False, True}:
        raise RuntimeError("rtc phase failed: %d output(s) out of "
                           "tolerance; %s" % (len(failures),
                                              json.dumps(row)))
    return dict(name="rtc", route="cuda",
                source="mxnet_tpu_torch/kernels/csrc/stream.cuh + "
                       "mxnet_tpu_torch/kernels/rtc_codegen.py",
                replaces="mxnet_tpu/rtc.py:33", launches=launches,
                max_abs_err=worst, bound_by="bytes",
                **{k: axpy[k] for k in ("ms", "plain_ms", "library_ms",
                                        "bound_ms")})


# ---------------------------------------------------------------------------
# phase 7: Module.fit
# ---------------------------------------------------------------------------
FIT_BATCHES, EVAL_BATCHES = 8, 2


def fit_phase(mx, K, card, hand_img_per_s):
    """ResNet-50 through ``mod.fit``: 8 synthetic batches (numpy seed 0),
    2 eval batches, SGD with a FactorScheduler; then ``score``."""
    import numpy as np
    import torch
    rs = np.random.RandomState(0)
    n_train, n_eval = FIT_BATCHES * BATCH, EVAL_BATCHES * BATCH
    x = rs.randn(n_train + n_eval, 3, 224, 224).astype(np.float32)
    y = rs.randint(0, 1000, (n_train + n_eval,)).astype(np.float32)
    train = mx.io.NDArrayIter(x[:n_train], y[:n_train], batch_size=BATCH,
                              shuffle=False)
    val = mx.io.NDArrayIter(x[n_train:], y[n_train:], batch_size=BATCH)
    mx.random.seed(0)
    mod = resnet50_module(mx, mx.gpu(0), BATCH)
    before = {k: mod.get_params()[0][k].asnumpy()
              for k in ("conv0_weight", "fc1_weight")}
    sched = mx.lr_scheduler.FactorScheduler(step=4, factor=0.5)
    stamps = []
    torch.cuda.synchronize()
    K.bn_fwd.launches = 0
    K.bn_bwd.launches = 0
    t0 = time.perf_counter()
    mod.fit(train, eval_data=val, eval_metric="acc",
            batch_end_callback=[mx.callback.Speedometer(BATCH, 4),
                                lambda p: stamps.append(time.perf_counter())],
            optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                              "wd": 1e-4, "lr_scheduler": sched},
            num_epoch=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {"bn_fwd": K.bn_fwd.launches, "bn_bwd": K.bn_bwd.launches}
    score = dict(mod.score(val, "acc"))
    torch.cuda.synchronize()
    after_score = {"bn_fwd": K.bn_fwd.launches, "bn_bwd": K.bn_bwd.launches}
    args, aux = mod.get_params()
    finite = all(np.isfinite(v.asnumpy()).all()
                 for v in list(args.values()) + list(aux.values()))
    changed = all(not np.array_equal(before[k], args[k].asnumpy())
                  for k in before)
    lr = mod._optimizer._get_lr(0)
    # 8 updates at step 4: the lr halves once, after update 4
    want_lr = 0.1 * 0.5
    img_per_s = (len(stamps) - 1) * BATCH / (stamps[-1] - stamps[0])
    # what a fit batch adds to a hand-driven step: the batch's copy from
    # host memory into the bound arrays, and the metric's readback
    batch = next(iter(train))
    group = mod._exec_group

    def to_card():
        for dst, src in zip(group.data_arrays + group.label_arrays,
                            batch.data + batch.label):
            dst[0][:] = src

    h2d_ms = host_ms(to_card)
    metric_ms = host_ms(lambda: mod.update_metric(
        mx.metric.create("acc"), batch.label))
    row = {"phase": "fit", "model": "resnet-50", "batch": BATCH,
           "batches": FIT_BATCHES, "eval_batches": EVAL_BATCHES,
           "fit_s": fit_s, "fit_img_per_s_batches_2_to_8": img_per_s,
           "hand_driven_img_per_s": hand_img_per_s,
           "batch_to_card_ms": h2d_ms, "metric_update_ms": metric_ms,
           "launches": launches, "launches_after_score": after_score,
           "score": score, "lr_after_fit": lr, "finite": finite,
           "params_changed": changed, "card": card}
    emit(row)
    want = BN_PER_STEP * FIT_BATCHES
    acc = score.get("accuracy", float("nan"))
    if not (launches == {"bn_fwd": want, "bn_bwd": want}
            and after_score == launches and finite and changed
            and abs(lr - want_lr) < 1e-12 and np.isfinite(acc)
            and len(stamps) == FIT_BATCHES):
        raise RuntimeError("fit phase failed: %s" % json.dumps(row))
    return mod


# ---------------------------------------------------------------------------
# phase 8: serving
# ---------------------------------------------------------------------------
SERVE_MAX_BATCH = 32
SERVE_SIZES = (1, 2, 3, 8, 16)     # bench.py _bench_serve's request mix
SERVE_CLIENTS, SERVE_SECONDS = 8, 5.0
SERVE_PARITY_ROWS = (2, 4, 5, 8, 16, 32, 70)   # 5 pads to 8, 70 chunks


def rows_iter(mx, x):
    """An iterator of one batch holding exactly the rows ``x``: no
    iterator padding, so a batch shorter than the bound shape reaches
    ``Module.forward`` as it is (which pads it with zero rows)."""
    class _Rows(mx.io.DataIter):
        def __init__(self):
            super().__init__(batch_size=len(x))
            self.done = False

        def reset(self):
            self.done = False

        def next(self):
            if self.done:
                raise StopIteration
            self.done = True
            return mx.io.DataBatch(data=[mx.nd.array(x, ctx=mx.cpu())],
                                   label=None, pad=0)
    return _Rows()


def rel_l2(a, b):
    import numpy as np
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def serve_shared_params(pred, source):
    """Whether every bucket computes from the top bucket's parameter and
    aux tensors (same storage), none shared with the source module; and
    their megabytes."""
    base = pred._modules[pred.max_batch_size]._exec_group.execs[0]
    src = source._exec_group.execs[0]
    names = [("arg", n) for n in source._param_names] + \
        [("aux", n) for n in base.aux_names]

    def tensor(ex, kind, n):
        return (ex.arg_dict if kind == "arg" else ex.aux_dict)[n]._read()

    one_copy = all(
        tensor(m._exec_group.execs[0], k, n).data_ptr()
        == tensor(base, k, n).data_ptr()
        for m in pred._modules.values() for k, n in names)
    apart = all(tensor(src, k, n).data_ptr() != tensor(base, k, n).data_ptr()
                for k, n in names)
    mb = sum(tensor(base, k, n).nbytes for k, n in names) / 1e6
    return one_copy and apart, len(names), mb


def forward_op_counts(ex):
    """PyTorch operators one eval forward of executor ``ex`` dispatches:
    (all, those that are not views or detaches, by name). Each of the
    latter is at least one kernel launch the host enqueues."""
    from collections import Counter
    from torch.utils._python_dispatch import TorchDispatchMode
    views = {"view", "_unsafe_view", "reshape", "expand", "t", "detach",
             "alias", "slice", "select", "_reshape_alias", "as_strided",
             "unsqueeze", "squeeze", "permute", "transpose"}
    ops = Counter()

    class _Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops[func.overloadpacket.__name__] += 1
            return func(*args, **(kwargs or {}))

    with _Count():
        ex.forward(is_train=False)
    launching = {k: v for k, v in ops.items() if k not in views}
    return sum(ops.values()), sum(launching.values()), launching


def serve_bucket_times(pred, b, x):
    """One bucket's times: the bound forward (data already on the card)
    by CUDA events (median of 10 after 3 warm) and as a CUDA graph
    replay (device only), its host enqueue, ``Predictor.predict`` on
    exactly ``b`` rows (pad, host→card copy, forward, readback), and the
    copy and the readback alone."""
    import torch
    from mxnet_tpu_torch.tools.bn_probe import cuda_time, graph_ms
    m = pred._modules[b]
    ex = m._exec_group.execs[0]
    pred.predict(x)          # the bound data now holds the request

    def forward():
        ex.forward(is_train=False)

    event_ms = cuda_time(forward, reps=10, warm=3)
    enqueue = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward()
        enqueue.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    device_ms, method = graph_ms([forward] * 3)
    for _ in range(3):
        pred.predict(x)
    calls = []
    for _ in range(10):
        t0 = time.perf_counter()
        pred.predict(x)
        calls.append(1e3 * (time.perf_counter() - t0))
    call_ms = statistics.median(calls)
    data = m._exec_group.data_arrays[0][0]

    def to_card():
        data[:] = x

    return {"bucket": b, "forward_event_ms": event_ms,
            "forward_device_ms": device_ms, "device_ms_by": method,
            "forward_enqueue_ms": statistics.median(enqueue),
            "call_ms": call_ms, "host_to_card_ms": host_ms(to_card, 10),
            "readback_ms": host_ms(lambda: m.get_outputs()[0][:b].asnumpy(),
                                   10),
            "rows_per_s": b / (call_ms / 1e3)}


def serve_load(mx, pred, pools):
    """``SERVE_CLIENTS`` threads fire bench.py's mix at a DynamicBatcher
    for ``SERVE_SECONDS``: each client takes its request sizes in turn
    from its own pool, and answers QueueFull with a 2 ms sleep. Returns
    (counts, each client's last (pool index, outputs))."""
    import threading
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serving import DynamicBatcher, QueueFull
    lock = threading.Lock()
    done, rows, last, errors = [0], [0], {}, []
    batcher = DynamicBatcher(pred, max_queue=32, max_wait_ms=2.0)
    stop_at = time.perf_counter() + SERVE_SECONDS

    def client(i):
        k = i
        try:
            while time.perf_counter() < stop_at:
                idx = k % len(SERVE_SIZES)
                k += 1
                try:
                    out = batcher.predict(pools[i][idx], timeout=120)
                except QueueFull:
                    time.sleep(0.002)
                    continue
                with lock:
                    done[0] += 1
                    rows[0] += SERVE_SIZES[idx]
                last[i] = (idx, out)
        except Exception as e:  # noqa: BLE001 — reported, fails the phase
            errors.append("client %d: %r" % (i, e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(SERVE_CLIENTS)]
    telemetry.enable()          # request traces: host clocks only
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(SERVE_SECONDS + 150)
    finally:
        batcher.shutdown(drain=True, timeout=120)
        telemetry.disable()
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        errors.append("a client did not finish")
    return {"wall_s": wall, "completed": done[0], "rows": rows[0],
            "errors": errors}, last


def serving_phase(mx, K, card, mod):
    """The trained ResNet-50 served through Predictor and DynamicBatcher
    (module docstring, phase 8). Fails on any failed check."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.serving import Predictor
    failed = []

    def check(name, ok, row):
        emit(row)
        if not ok:
            failed.append(name)

    shape = dict(mod.data_shapes)["data"][1:]
    rs = np.random.RandomState(1)
    X = rs.randn(max(SERVE_PARITY_ROWS), *shape).astype(np.float32)
    torch.cuda.synchronize()
    K.bn_fwd.launches = 0
    K.bn_bwd.launches = 0

    # 1. warmup
    t0 = time.perf_counter()
    pred = Predictor(mod, max_batch_size=SERVE_MAX_BATCH)
    stats = pred.warmup()
    one_copy, n_tensors, mb = serve_shared_params(pred, mod)
    n_ops, n_launching, by_op = forward_op_counts(
        pred._modules[2]._exec_group.execs[0])
    check("warmup", stats["compiles"] == 5 and one_copy and
          pred.buckets == [2, 4, 8, 16, 32] and
          not torch.backends.cudnn.benchmark,
          {"phase": "serve_warmup", "buckets": pred.buckets,
           "warmup_ms": stats["warmup_ms"], "compiles": stats["compiles"],
           "setup_s": time.perf_counter() - t0,
           "one_parameter_set": one_copy, "param_and_aux_tensors": n_tensors,
           "param_and_aux_mb": mb, "forward_dispatched_ops": n_ops,
           "forward_launching_ops": n_launching, "forward_ops_by_name": by_op,
           "cudnn_benchmark": torch.backends.cudnn.benchmark, "card": card})

    # 2. parity: Module.predict at each launch's bucket, bit for bit
    arg, aux = mod.get_params()
    refs = {}
    for b in pred.buckets:
        refs[b] = mx.mod.Module(mod.symbol, context=mod._context)
        refs[b].bind(data_shapes=[("data", (b,) + shape)],
                     for_training=False)
        refs[b].set_params(arg, aux)
    rows = []
    for n in SERVE_PARITY_ROWS:
        served = pred.predict(X[:n])
        parts, start = [], 0
        while start < n:
            take = min(n - start, pred.max_batch_size)
            parts.append(refs[pred.bucket_for(take)].predict(
                rows_iter(mx, X[start:start + take])).asnumpy())
            start += take
        want = np.concatenate(parts)
        rows.append({"rows": n, "buckets": [pred.bucket_for(min(
                         n - s, pred.max_batch_size))
                         for s in range(0, n, pred.max_batch_size)],
                     "bitwise_equal": bool(np.array_equal(served, want)),
                     "max_abs_err": float(np.abs(served - want).max()),
                     "finite": bool(np.isfinite(served).all()),
                     "shape": list(served.shape)})
    del refs
    pad5 = pred.predict(X[:5])
    pad_free = bool(np.array_equal(pad5, pred.predict(X[:8])[:5]))
    b2, b32 = pred.predict(X[:2]), pred.predict(X[:32])[:2]
    cross = rel_l2(b2, b32)
    # snapshot: one more training step of the source module
    before = pred.predict(X[:8])
    w0 = arg["fc1_weight"].asnumpy().copy()
    saved = (K.bn_fwd.launches, K.bn_bwd.launches)
    labels = rs.randint(0, 1000, (BATCH,)).astype(np.float32)
    mod.forward_backward(mx.io.DataBatch(
        [mx.nd.array(X[:BATCH], ctx=mx.cpu())],
        [mx.nd.array(labels, ctx=mx.cpu())]))
    mod.update()
    torch.cuda.synchronize()
    step_launches = [K.bn_fwd.launches - saved[0],
                     K.bn_bwd.launches - saved[1]]
    K.bn_fwd.launches, K.bn_bwd.launches = saved
    moved = not np.array_equal(w0, mod.get_params()[0]["fc1_weight"]
                               .asnumpy())
    snapshot = moved and bool(np.array_equal(before, pred.predict(X[:8])))
    check("parity", all(r["bitwise_equal"] and r["finite"] for r in rows)
          and pad_free and cross <= TOL["serve_cross_bucket"] and snapshot,
          {"phase": "serve_parity", "requests": rows,
           "pad_rows_change_nothing": pad_free,
           "bucket2_vs_bucket32_rel_l2": cross,
           "bucket2_vs_bucket32_bitwise": bool(np.array_equal(b2, b32)),
           "tolerance": TOL["serve_cross_bucket"],
           "snapshot_held": snapshot, "source_params_moved": moved,
           "train_step_bn_launches": step_launches, "card": card})

    # 3. bucket times
    times = {}
    for b in pred.buckets:
        times[b] = serve_bucket_times(pred, b, X[:b])
        emit({"phase": "serve_bucket", **times[b], "card": card})

    # 4. load through the batcher, on a predictor of its own (fresh stats)
    lp = Predictor(mod, max_batch_size=SERVE_MAX_BATCH)
    lp.warmup()
    compiles0 = lp.stats()["compiles"]
    pools = [[np.random.RandomState(100 + i).rand(n, *shape)
              .astype(np.float32) for n in SERVE_SIZES]
             for i in range(SERVE_CLIENTS)]
    load, last = serve_load(mx, lp, pools)
    s = lp.stats()
    wall_ms = 1e3 * load["wall_s"]
    hits = s["bucket_hits"]
    busy = {k: sum(n * times[b][k] for b, n in hits.items()) / wall_ms
            for k in ("forward_device_ms", "forward_event_ms")}
    lat = s["latency_ms"]
    # mean ms of each request-trace phase, per bucket: device = host→card
    # copy, forward and readback; pad = the host's zero rows; resolve =
    # joining the requests' rows before the launch and slicing after
    hists = lp._stats.scope.snapshot()["histograms"]
    phases = {b: {p[:-3]: h["sum"] / h["count"]
                  for p in ("queue_wait_ms", "coalesce_wait_ms", "pad_ms",
                            "device_ms", "resolve_ms")
                  for h in [hists.get("b%d.phase_%s" % (b, p))]
                  if h and h["count"]}
              for b in sorted(hits)}
    check("load", not load["errors"] and s["compiles"] == compiles0 and
          load["completed"] > 0 and s["errors"] == 0,
          {"phase": "serve_load", "clients": SERVE_CLIENTS,
           "seconds": load["wall_s"], "request_rows": list(SERVE_SIZES),
           "max_queue": 32, "max_wait_ms": 2.0,
           "requests_per_s": load["completed"] / load["wall_s"],
           "rows_per_s": load["rows"] / load["wall_s"],
           "completed": load["completed"],
           "latency_ms_p50": lat["p50"], "latency_ms_p99": lat["p99"],
           "latency_ms_mean": lat["mean"], "latency_samples": lat["count"],
           "batch_fill": s["batch_fill"], "rejected": s["rejected"],
           "timeouts": s["timeouts"], "errors": load["errors"],
           "post_warmup_compiles": s["compiles"] - compiles0,
           "launches_per_bucket": hits, "launches": s["batches"],
           "device_busy_share_by_graph_ms": busy["forward_device_ms"],
           "device_busy_share_by_event_ms": busy["forward_event_ms"],
           "phase_mean_ms_by_bucket": phases, "card": card})

    # 5. routing: each client's last rows are its own, bit for bit
    routing = []
    for i in range(SERVE_CLIENTS):
        idx, out = last[i]
        x = pools[i][idx]
        direct = lp.predict(x)
        matched = [b for b in lp.buckets if b >= len(x) and np.array_equal(
            out, lp._run_bucket(b, {"data": x}, len(x))[0])]
        routing.append({"client": i, "rows": len(x),
                        "direct_bitwise": bool(np.array_equal(out, direct)),
                        "bitwise_in_buckets": matched,
                        "rel_l2_to_direct": rel_l2(out, direct)})
    check("routing", all(r["bitwise_in_buckets"] for r in routing),
          {"phase": "serve_routing", "clients": routing, "card": card})

    # 6. no BatchNorm kernel ran while serving
    torch.cuda.synchronize()
    bn = {"bn_fwd": K.bn_fwd.launches, "bn_bwd": K.bn_bwd.launches}
    check("no_kernels", bn == {"bn_fwd": 0, "bn_bwd": 0},
          {"phase": "serve_kernels", "bn_launches_while_serving": bn})
    if failed:
        raise RuntimeError("serving phase failed: %s" % ", ".join(failed))


# ---------------------------------------------------------------------------
# phase 9: the CIFAR twin (resnet-20) through fit, checkpoints and reshape
# ---------------------------------------------------------------------------
TWIN_ARGS = ["--gpus", "0", "--seed", "7", "--num-epochs", "3"]
TWIN_BATCH, TWIN_STEPS = 128, 3 * 4096 // 128    # 3 epochs of 32 batches
TWIN_IMAGE = (3, 28, 28)
TWIN_MIN_ACCURACY = 0.9
TWIN_BF16_ARGS = ["--precision", "bf16", "--batch-group", "4"]


def twin_bn_shapes(mx, batch):
    return model_bn_shapes(mx, "resnet-20", TWIN_IMAGE, 10, batch)


def twin_bn_check(K, counts):
    """Both kernels against their plain versions at every BatchNorm shape
    of the given counter (float32, the main path's flags, PR 3's
    tolerances); raises on a disagreement."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(4)
    failed = []
    for (shape, fix_gamma, relu, need_dx), n in sorted(counts.items()):
        fields, ok, _, _ = compare_case(K, bn_inputs(shape, torch.float32,
                                                     gen),
                                        torch.float32, relu, fix_gamma,
                                        False, need_dx)
        row = {"phase": "cifar_twin_bn_check", "shape": list(shape),
               "fix_gamma": fix_gamma, "relu": relu, "need_dx": need_dx,
               "per_step": n,
               "plan": {"fwd": plan_name(K, "fwd", shape, torch.float32),
                        "bwd": plan_name(K, "bwd", shape, torch.float32,
                                         need_dx)},
               **fields, "ok": ok}
        emit(row)
        if not ok:
            failed.append(list(shape))
    if failed:
        raise RuntimeError("BN kernels disagree at resnet-20 shapes %s"
                           % failed)


def twin_subprocess(args, cwd):
    """The CIFAR twin in a process of its own; (exit code, output tail)."""
    res = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.examples.train_cifar10"]
        + args, capture_output=True, text=True, timeout=600, cwd=cwd,
        env=dict(os.environ, PYTHONPATH=ROOT))
    return res.returncode, (res.stdout[-1500:] + res.stderr[-3000:])


def snapshot_check(mx, mod):
    """``CheckpointManager.save`` of the card's weights, then an in-place
    update of those tensors right after it returns: the committed entry
    must hold the values at save time. The entry's RNG state (taken by
    ``save``) must also give back the card's generator: the draw after
    the save repeats after ``set_state``."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    grp = mod._exec_group
    ws = {n: mx.nd.NDArray(a[0]._read().clone())
          for n, a in zip(mod._param_names, grp.param_arrays)}
    before = {n: w.asnumpy() for n, w in ws.items()}
    mgr = CheckpointManager(os.path.join(ROOT, "build", "cifar_twin",
                                         "snapshot"))
    gen = mx.random.generator(torch.device("cuda", 0))
    torch.rand(5, device="cuda", generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(0, ws, async_save=True)
    save_ms = 1e3 * (time.perf_counter() - t0)
    with torch.no_grad():
        for w in ws.values():
            w._read().mul_(-3.0).add_(1.0)
    draw = torch.rand(5, device="cuda", generator=gen)
    torch.cuda.synchronize()
    mgr.wait_until_finished()
    entry = mgr.restore(0)
    equal = all(np.array_equal(entry.params[n], before[n]) for n in before)
    mutated = not any(np.array_equal(ws[n].asnumpy(), before[n])
                      for n in before)
    mx.random.set_state(entry.rng)
    again = torch.rand(5, device="cuda",
                       generator=mx.random.generator(torch.device("cuda", 0)))
    rng_ok = "cuda:0" in entry.rng["torch"] and torch.equal(draw, again)
    return {"async_save_call_ms": save_ms, "entry_equals_save_time": equal,
            "weights_mutated_after_save": mutated,
            "card_generator_restored": rng_ok,
            "ok": equal and mutated and rng_ok}


def reshape_check(mx, K, mod, n_bn):
    """One training step at batch 128, one at 2 rows (a re-bind through
    ``reshape``), then an eval forward at a new spatial shape: every
    parameter and aux tensor keeps its ``data_ptr``, and each training
    step launches each BN kernel once per BatchNorm."""
    import numpy as np
    import torch
    rs = np.random.RandomState(11)
    grp = mod._exec_group
    ptrs = [a[0]._read().data_ptr() for a in grp.param_arrays
            + grp.aux_arrays]

    def batch(n, hw):
        x = rs.rand(n, 3, hw, hw).astype(np.float32)
        y = rs.randint(0, 10, (n,)).astype(np.float32)
        return mx.io.DataBatch([mx.nd.array(x, ctx=mx.cpu())],
                               [mx.nd.array(y, ctx=mx.cpu())])

    torch.cuda.synchronize()
    K.bn_fwd.launches = K.bn_bwd.launches = 0
    shapes = []
    for n in (TWIN_BATCH, 2):
        mod.forward_backward(batch(n, TWIN_IMAGE[1]))
        mod.update()
        shapes.append(mod.get_outputs()[0].shape)
    torch.cuda.synchronize()
    launches = {"bn_fwd": K.bn_fwd.launches, "bn_bwd": K.bn_bwd.launches}
    mod.forward(batch(4, 32), is_train=False)
    out = mod.get_outputs()[0].asnumpy()
    shapes.append(out.shape)
    grp = mod._exec_group
    same = ptrs == [a[0]._read().data_ptr() for a in grp.param_arrays
                    + grp.aux_arrays]
    eval_launches = {"bn_fwd": K.bn_fwd.launches - launches["bn_fwd"],
                     "bn_bwd": K.bn_bwd.launches - launches["bn_bwd"]}
    want = {"bn_fwd": 2 * n_bn, "bn_bwd": 2 * n_bn}
    row = {"phase": "cifar_twin_reshape",
           "output_shapes": [list(s) for s in shapes],
           "param_data_ptrs_unchanged": same, "launches": launches,
           "want": want, "eval_launches": eval_launches,
           "finite": bool(np.isfinite(out).all())}
    row["ok"] = (same and launches == want and row["finite"]
                 and eval_launches == {"bn_fwd": 0, "bn_bwd": 0}
                 and shapes == [(TWIN_BATCH, 10), (2, 10), (4, 10)])
    emit(row)
    return row["ok"]


def cifar_twin_phase(mx, K, card, copy_rate):
    """The CIFAR twin (resnet-20, 16/32/64 channels, 28² crops, 10
    classes, batch 128, float32) on ``gpu(0)``: its BN kernels against
    their plain versions and timed at every resnet-20 shape, and checked
    at the 2-row shapes; in process, 3 epochs through ``fit`` with a
    checkpoint per epoch and the serving smoke (BN launches counted from
    0); preempted after epoch 1 in a subprocess (exit 66) and resumed in
    another, which must reach the in-process run's ``params_digest``; the
    card's snapshot under an in-place update; ``reshape``. Returns the
    launches of the in-process run."""
    import shutil
    import numpy as np
    import torch
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.examples import train_cifar10
    from mxnet_tpu_torch.tools.batch_parity import batch_parity
    counts = twin_bn_shapes(mx, TWIN_BATCH)
    n_bn = sum(counts.values())
    tot, _, _ = time_kernels(K, counts, copy_rate, model="resnet-20")
    emit({"phase": "kernel_times_per_step", "model": "resnet-20",
          "batch": TWIN_BATCH, "card": card, **tot})
    twin_bn_check(K, twin_bn_shapes(mx, 2))

    work = os.path.join(ROOT, "build", "cifar_twin")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    failed = []

    def check(name, ok, row):
        row["ok"] = bool(ok)
        emit(row)
        if not ok:
            failed.append(name)

    # in process: 3 epochs, a checkpoint per epoch, the serving smoke
    ckpt = telemetry.registry().scope("checkpoint")
    keys = ("saves", "snapshot_ms", "save_ms", "bytes_written")
    c0 = {k: ckpt.counter(k).value for k in keys}
    torch.cuda.synchronize()
    K.bn_fwd.launches = K.bn_bwd.launches = 0
    res = train_cifar10.main(TWIN_ARGS + [
        "--serve-smoke", "--min-accuracy", str(TWIN_MIN_ACCURACY),
        "--checkpoint-dir", os.path.join(work, "straight"),
        "--params-digest-out", os.path.join(work, "straight.txt")])
    torch.cuda.synchronize()
    launches = {"bn_fwd": K.bn_fwd.launches, "bn_bwd": K.bn_bwd.launches}
    saves = {k: ckpt.counter(k).value - c0[k] for k in keys}
    want = n_bn * TWIN_STEPS
    mgr = CheckpointManager(os.path.join(work, "straight"))
    t0 = time.perf_counter()
    entry = mgr.restore()
    restore_ms = 1e3 * (time.perf_counter() - t0)
    mod = res["module"]
    arg_np, aux_np = mx.checkpoint.split_params(entry.params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.set_params({k: mx.nd.array(v, ctx=mx.cpu()) for k, v in
                    arg_np.items()},
                   {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in
                    aux_np.items()})
    torch.cuda.synchronize()
    to_card_ms = 1e3 * (time.perf_counter() - t0)
    n = max(saves["saves"], 1)
    check("fit", launches == {"bn_fwd": want, "bn_bwd": want}
          and res["accuracy"] >= TWIN_MIN_ACCURACY and mgr.all_steps()
          == [0, 1, 2] and saves["saves"] == 3, {
              "phase": "cifar_twin_fit", "network": "resnet-20",
              "image": list(TWIN_IMAGE), "classes": 10,
              "batch": TWIN_BATCH, "steps": TWIN_STEPS,
              "fit_s": res["fit_s"], "fit_img_per_s": res["fit_img_per_s"],
              "launches": launches, "want": {"bn_fwd": want,
                                             "bn_bwd": want},
              "accuracy": res["accuracy"],
              "min_accuracy": TWIN_MIN_ACCURACY,
              "params_digest": res["params_digest"],
              "serving": {k: res["serving"][k] for k in
                          ("completed", "compiles", "batch_fill",
                           "max_rel_l2", "bitwise_requests")},
              "checkpoint": {
                  "steps": mgr.all_steps(), "saves": saves["saves"],
                  "snapshot_ms_per_save": saves["snapshot_ms"] / n,
                  "async_commit_ms_per_save": saves["save_ms"] / n,
                  "bytes_per_entry": saves["bytes_written"] / n,
                  "restore_ms": restore_ms,
                  "restore_to_card_ms": to_card_ms},
              "card": card})
    # where the served rows part from Module.predict's: the first node of
    # the eval forward whose rows depend on the batch size
    x = train_cifar10.synthetic_cifar(np.random.RandomState(0))[0][:128]
    for row in batch_parity(mod, x, [TWIN_BATCH, 32, 8, 2]):
        emit({"phase": "cifar_twin_batch_parity", **row})
    snap = snapshot_check(mx, mod)
    check("snapshot", snap.pop("ok"), {"phase": "cifar_twin_snapshot",
                                       **snap, "card": card})

    # bf16 with grouped steps, twice in subprocesses: the accuracy gate
    # and a params_digest that repeats. These two processes and the
    # preempt / resume pair below are independent: they run at once
    from concurrent.futures import ThreadPoolExecutor

    def bf16_run(i):
        paths = [os.path.join(work, "bf16_%s%d.txt" % (k, i))
                 for k in ("digest", "acc")]
        t0 = time.time()
        rc, tail = twin_subprocess(TWIN_ARGS + TWIN_BF16_ARGS + [
            "--min-accuracy", str(TWIN_MIN_ACCURACY),
            "--params-digest-out", paths[0], "--acc-out", paths[1]], work)
        return rc, tail, paths, time.time() - t0

    with ThreadPoolExecutor(2) as runner:
        bf16 = [runner.submit(bf16_run, i) for i in range(2)]
        # as subprocesses: preempted after epoch 1, then resumed
        ck = os.path.join(work, "preempt")
        rc, tail = twin_subprocess(TWIN_ARGS + [
            "--checkpoint-dir", ck, "--exit-after-epoch", "1"], work)
        steps = CheckpointManager(ck).all_steps()
        check("preempt", rc == 66 and steps == [0], {
            "phase": "cifar_twin_preempt", "exit_code": rc,
            "committed_steps": steps, "tail": tail if rc != 66 else None})
        digest_path = os.path.join(work, "resumed.txt")
        rc, tail = twin_subprocess(TWIN_ARGS + [
            "--checkpoint-dir", ck, "--resume",
            "--params-digest-out", digest_path], work)
        resumed = open(digest_path).read().strip() if rc == 0 else None
        check("resume", rc == 0 and resumed == res["params_digest"], {
            "phase": "cifar_twin_resume", "exit_code": rc,
            "params_digest": resumed, "uninterrupted": res["params_digest"],
            "bit_for_bit": resumed == res["params_digest"],
            "committed_steps": CheckpointManager(ck).all_steps(),
            "tail": tail if rc != 0 else None})
        if not reshape_check(mx, K, mod, n_bn):
            failed.append("reshape")
        runs = [f.result() for f in bf16]
    digests, accs, tails = [], [], []
    for i, (rc, tail, paths, seconds) in enumerate(runs):
        ok = rc == 0
        digests.append(open(paths[0]).read().strip() if ok else None)
        accs.append(float(open(paths[1]).read()) if ok else None)
        tails.append(None if ok else tail)
        emit({"phase": "cifar_twin_bf16_run", "run": i, "exit_code": rc,
              "seconds": seconds, "concurrent": True})
    check("bf16_grouped", None not in digests and digests[0] == digests[1]
          and min(accs) >= TWIN_MIN_ACCURACY, {
              "phase": "cifar_twin_bf16_grouped", "args": TWIN_BF16_ARGS,
              "params_digests": digests, "accuracy": accs,
              "min_accuracy": TWIN_MIN_ACCURACY,
              "digest_repeats": digests[0] == digests[1], "tails": tails})
    if failed:
        raise RuntimeError("cifar_twin phase failed: %s" % ", ".join(failed))
    return launches


# ---------------------------------------------------------------------------
# phase 10: decode serving (no hand-written kernel on this path)
# ---------------------------------------------------------------------------
# (a) bench.py's decode configuration (_bench_decode); (b) the widths of
# example/transformer-lm (transformer_lm_tp.py: V, D, H, T, BLOCKS)
DECODE_LSTM = {"vocab": 64, "hidden": 64, "embed": 32, "seed": 7,
               "slots": 8, "max_prefill_len": 16, "requests": 24,
               "prompt_len": (2, 17), "new_tokens": 64}
DECODE_TRANSFORMER = {"vocab": 32, "embed": 64, "heads": 4, "window": 16,
                      "blocks": 2, "seed": 0, "slots": 4,
                      "max_prefill_len": 16, "requests": 12,
                      "prompt_len": (3, 41), "new_tokens": 64}
DECODE_TEMPERATURES = (0.0, 0.8)
DECODE_PARITY_LENGTHS = range(1, 41)     # crosses the 16-token chunk
# first-token logits, card vs the port on the CPU, relative L2: the same
# float32 math; cuBLAS and the CPU's GEMMs sum in another order
DECODE_CPU_REL_L2 = 1e-5


def decode_model(cfg):
    from mxnet_tpu_torch.serving.decode import LSTMCharLM, TransformerLM
    if "hidden" in cfg:
        return LSTMCharLM(cfg["vocab"], num_hidden=cfg["hidden"],
                          num_embed=cfg["embed"])
    return TransformerLM(cfg["vocab"], cfg["embed"], cfg["heads"],
                         cfg["window"], cfg["blocks"])


def decode_prompts(cfg):
    import numpy as np
    rng = np.random.RandomState(cfg["seed"])
    lo, hi = cfg["prompt_len"]
    return [list(map(int, rng.randint(0, cfg["vocab"], size=int(
        rng.randint(lo, hi))))) for _ in range(cfg["requests"])]


def decode_engine(mx, cfg, model, params, ctx, temperature):
    from mxnet_tpu_torch.serving.decode import DecodeEngine
    return DecodeEngine(model, params, slots=cfg["slots"],
                        max_prefill_len=cfg["max_prefill_len"],
                        temperature=temperature, start=False, context=ctx)


def decode_run(mx, cfg, model, params, prompts, ctx, temperature):
    """bench.py's decode load: every request queued before the scheduler
    starts, then the same requests one at a time through a second
    engine. Returns (continuous streams, sequential streams, row)."""
    eng = decode_engine(mx, cfg, model, params, ctx, temperature)
    warm = eng.warmup()
    compiles = eng.stats()["compiles"]
    reqs = [eng.submit(p, max_new_tokens=cfg["new_tokens"], seed=i)
            for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    eng.start()
    streams = [r.result(timeout=600) for r in reqs]
    wall = time.perf_counter() - t0
    eng.shutdown(drain=True)
    st = eng.stats()
    eng.release()
    seq = decode_engine(mx, cfg, model, params, ctx, temperature)
    seq.warmup()
    seq.start()
    t0 = time.perf_counter()
    ref = [seq.generate(p, max_new_tokens=cfg["new_tokens"], seed=i,
                        timeout=600) for i, p in enumerate(prompts)]
    seq_wall = time.perf_counter() - t0
    seq.shutdown(drain=True)
    sst = seq.stats()
    seq.release()
    d, sd = st["decode"], sst["decode"]
    row = {"temperature": temperature, "requests": len(prompts),
           "tokens": d["tokens"], "steps": d["steps"],
           "tokens_per_s": d["tokens_per_sec"],
           "sequential_tokens_per_s": sd["tokens_per_sec"],
           "tokens_per_s_wall": d["tokens"] / wall,
           "sequential_tokens_per_s_wall": sd["tokens"] / seq_wall,
           "wall_s": wall, "sequential_wall_s": seq_wall,
           "ttft_ms_p50": d["ttft_ms"]["p50"],
           "ttft_ms_p99": d["ttft_ms"]["p99"],
           "avg_occupancy": d["avg_occupancy"],
           "host_ms_per_step": 1e3 * eng._busy_s / max(d["steps"], 1),
           "sequential_host_ms_per_step":
               1e3 * seq._busy_s / max(sd["steps"], 1),
           "warmup_ms": {k: v["warmup_ms"] for k, v in warm.items()},
           "compiles_after_warmup": compiles,
           "compiles_after_run": st["compiles"],
           "bitwise_equal_sequential": streams == ref}
    return streams, ref, row


def decode_step_times(eng):
    """One decode step at full occupancy on scratch state: its host time
    (the engine's launch from the host vectors and the readback), CUDA
    events around the launch (host dispatch gaps included), its device
    time (a CUDA graph replay: kernels only) and the operators it
    dispatches."""
    import numpy as np
    import torch
    from collections import Counter
    from torch.utils._python_dispatch import TorchDispatchMode
    from mxnet_tpu_torch.tools.bn_probe import cuda_time, graph_ms
    n = eng.slots
    toks = np.arange(n) % eng._model.vocab_size
    ones = np.ones(n, np.int64)
    seeds = np.arange(n)
    with torch.no_grad():
        state = eng._state_zeros(n)
        d_tok, d_act, d_steps, d_seeds = eng._upload([toks, ones, ones,
                                                      seeds])
        act = d_act.bool()

        def step():
            return eng.step_device(state, d_tok, act, d_steps, d_seeds)

        def launch():
            _, nxt = eng._launch_step(state, toks, ones, ones, seeds,
                                      eng._step_buf)
            return nxt.cpu()

        event_ms = cuda_time(step, reps=20, warm=3)
        for _ in range(3):
            launch()
        host = []
        for _ in range(20):
            t0 = time.perf_counter()
            launch()
            host.append(1e3 * (time.perf_counter() - t0))
        device_ms, method = graph_ms([step] * 3)
        ops = Counter()

        class _Count(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                ops[func.overloadpacket.__name__] += 1
                return func(*args, **(kwargs or {}))

        with _Count():
            launch()
    views = {"view", "_unsafe_view", "reshape", "expand", "t", "detach",
             "alias", "slice", "select", "_reshape_alias", "as_strided",
             "unsqueeze", "squeeze", "permute", "transpose", "split",
             "chunk", "unbind"}
    launching = {k: v for k, v in ops.items() if k not in views}
    return {"step_host_ms": statistics.median(host),
            "step_event_ms": event_ms, "step_device_ms": device_ms,
            "device_ms_by": method, "ops_per_step": sum(ops.values()),
            "launching_ops_per_step": sum(launching.values()),
            "ops": dict(sorted(launching.items()))}


def decode_first_logits(mx, cfg, model, params, prompts, ctx):
    """Each prompt's final-position prefill logits (row 0) on ``ctx``."""
    eng = decode_engine(mx, cfg, model, params, ctx, 0.0)
    out = []
    with eng._device_scope():
        for p in prompts:
            _, _, lg = eng._run_prefill_chunks(
                eng._state_zeros(eng.slots), 0, p, 0)
            out.append(lg[0].cpu().numpy())
    eng.release()
    return out


def decode_model_phase(mx, name, cfg, card):
    """(a) or (b): the continuous/sequential load at greedy and sampled
    temperatures, prefill parity at every length 1–40, the step's times
    and operators, and the first-token logits against the CPU. Returns
    the names of the failed gates."""
    import numpy as np
    model = decode_model(cfg)
    params = model.init_params(seed=cfg["seed"])
    prompts = decode_prompts(cfg)
    gpu = mx.gpu(0)
    failed = []
    for temperature in DECODE_TEMPERATURES:
        _, _, row = decode_run(mx, cfg, model, params, prompts, gpu,
                               temperature)
        ok = (row["bitwise_equal_sequential"]
              and row["compiles_after_run"] == row["compiles_after_warmup"])
        emit({"phase": "decode_load", "model": name, **row, "ok": ok,
              "card": card})
        if not ok:
            failed.append("%s load at temperature %g" % (name, temperature))
    eng = decode_engine(mx, cfg, model, params, gpu, 0.0)
    eng.warmup()
    rng = np.random.RandomState(1)
    parity = {L: eng.prefill_parity(list(map(int, rng.randint(
        0, cfg["vocab"], size=L)))) for L in DECODE_PARITY_LENGTHS}
    times = decode_step_times(eng)
    bad = [L for L, ok in parity.items() if not ok]
    emit({"phase": "decode_step", "model": name, "slots": cfg["slots"],
          **times, "prefill_parity_lengths": [min(parity), max(parity)],
          "prefill_parity_failed": bad,
          "weight_bytes": eng.weight_bytes(),
          "step_argument_bytes": eng.step_argument_bytes(),
          "ok": not bad, "card": card})
    eng.release()
    if bad:
        failed.append("%s prefill parity at lengths %s" % (name, bad))
    card_logits = decode_first_logits(mx, cfg, model, params, prompts, gpu)
    cpu_logits = decode_first_logits(mx, cfg, model, params, prompts,
                                     mx.cpu())
    errs = [rel_l2(a, b) for a, b in zip(card_logits, cpu_logits)]
    ok = max(errs) <= DECODE_CPU_REL_L2
    emit({"phase": "decode_card_vs_cpu", "model": name,
          "prompts": len(errs), "max_rel_l2": max(errs),
          "limit": DECODE_CPU_REL_L2, "ok": ok, "card": card})
    if not ok:
        failed.append("%s first-token logits vs CPU" % name)
    return failed


def decode_twin():
    """The decode_lm twin with its default flags in a process of its
    own: (exit code, the lines it prints, output tail)."""
    res = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.examples.decode_lm"],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))
    keep = ("parity:", "continuation:", "tokens/sec:", "streams sha256:",
            "decode_lm:")
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith(keep)]
    return res.returncode, lines, res.stdout[-1500:] + res.stderr[-3000:]


def decode_phase(mx, K, C, R, card):
    """Decode serving on ``gpu(0)``: (a) the LSTM char-LM at bench.py's
    configuration, (b) the transformer LM at example/transformer-lm's
    widths, (c) the decode_lm twin in a subprocess. No hand-written
    kernel lies on this path: every kernel counter reads 0 after it.
    Returns those counts."""
    for counter in (K.bn_fwd, K.bn_bwd, C.copy, R.rtc_kernel):
        counter.launches = 0
    failed = decode_model_phase(mx, "lstm_char_lm", DECODE_LSTM, card)
    failed += decode_model_phase(mx, "transformer_lm", DECODE_TRANSFORMER,
                                 card)
    t0 = time.time()
    rc, lines, tail = decode_twin()
    twin_ok = rc == 0 and any(ln.startswith("decode_lm: all asserts passed")
                              for ln in lines)
    emit({"phase": "decode_twin", "exit_code": rc, "lines": lines,
          "seconds": time.time() - t0, "ok": twin_ok,
          "tail": None if twin_ok else tail, "card": card})
    if not twin_ok:
        failed.append("decode_lm twin")
    launches = {"bn_fwd": K.bn_fwd.launches, "bn_bwd": K.bn_bwd.launches,
                "copy": C.copy.launches, "rtc": R.rtc_kernel.launches}
    emit({"phase": "decode_kernels", "launches": launches,
          "ok": not any(launches.values())})
    if any(launches.values()):
        failed.append("kernel launches on the decode path %s" % launches)
    if failed:
        raise RuntimeError("decode phase failed: %s" % "; ".join(failed))
    return launches


# ---------------------------------------------------------------------------
# phase 11: the input pipeline, driven by the train_imagenet twin
# ---------------------------------------------------------------------------
IMNET_IMAGES, IMNET_CLASSES, IMNET_EPOCHS = 512, 8, 2
IMNET_STEPS = IMNET_EPOCHS * IMNET_IMAGES // BATCH     # 2 epochs of 16
IMNET_NETWORK = "resnet-50"
IMNET_TWIN_ARGS = ["--gpus", "0"]
IMNET_PAD = 4              # the deferred pad-and-crop of ways (a)-(d)
IMNET_MEAN = (123.68, 116.28, 103.53)
IMNET_STD = (58.395, 57.12, 57.375)


def write_pack(path, n, image, classes):
    """``n`` labelled images (the twin's colour blob + noise, from numpy
    seed 0) as raw ``.npy`` records: no image library needed to read them.
    Returns the bytes written."""
    import numpy as np
    from mxnet_tpu_torch import recordio
    rng = np.random.RandomState(0)
    _, h, w = image
    rec = recordio.MXRecordIO(path, "w")
    for i in range(n):
        cls = i % classes
        img = rng.randint(0, 60, (h, w, 3)).astype(np.uint8)
        img[..., cls % 3] += np.uint8(60 + 37 * (cls // 3))
        rec.write(recordio.pack_img(recordio.IRHeader(0, float(cls), i, 0),
                                    img, img_fmt=".npy"))
    rec.close()
    return os.path.getsize(path)


def defer_iter(mx, pack, **kw):
    """The deferred-augment reader of ways (a)-(d): fixed order, pad and
    random crop, mirror, the ImageNet mean and std."""
    return mx.io.ImageRecordIter(
        path_imgrec=pack, data_shape=IMAGE, batch_size=BATCH,
        rand_crop=True, rand_mirror=True, device_augment="defer",
        augment_pad=IMNET_PAD, seed=11,
        **dict(zip(("mean_r", "mean_g", "mean_b"), IMNET_MEAN)),
        **dict(zip(("std_r", "std_g", "std_b"), IMNET_STD)), **kw)


def fed_fit(mx, train, args, aux, prefetch=None, module=None):
    """ResNet-50 (1000 classes, float32) through ``fit`` for
    ``IMNET_EPOCHS`` epochs from the given parameters, cuDNN
    deterministic: (host parameters by name, fit img/s over each epoch's
    batches after its first, the last PipelineStats snapshot)."""
    import torch
    from mxnet_tpu_torch import telemetry
    mod = module or mx.mod.Module(
        mx.models.get_symbol(IMNET_NETWORK, num_classes=1000,
                             image_shape=IMAGE), context=mx.gpu(0))
    stamps, snap = {}, {}

    def stamp(param):
        stamps.setdefault(param.epoch, []).append(time.perf_counter())
        stats = telemetry.active_pipeline()
        if stats is not None:
            snap.update(stats.snapshot())

    with deterministic_cudnn():
        mod.fit(train, num_epoch=IMNET_EPOCHS, optimizer="sgd",
                optimizer_params=SGD_PARAMS, arg_params=args,
                aux_params=aux, batch_end_callback=stamp,
                prefetch_to_device=prefetch)
        torch.cuda.synchronize()
    train.close()
    span = sum(t[-1] - t[0] for t in stamps.values())
    img_s = sum(len(t) - 1 for t in stamps.values()) * BATCH / span
    params = host_params(mod)
    steps = sum(len(t) for t in stamps.values())
    del mod
    torch.cuda.empty_cache()
    return params, img_s, snap, steps


def copy_times(batch_u8):
    """Host→card copy ms of one wire batch as uint8 NHWC and as float32
    NCHW, from pageable and from pinned memory (host clock around the
    copy, card idle before, synchronised after; median of 5)."""
    import numpy as np
    import torch
    out = {}
    f32 = np.ascontiguousarray(
        batch_u8.astype(np.float32).transpose(0, 3, 1, 2))
    for name, arr in (("uint8", batch_u8), ("float32", f32)):
        pageable = torch.from_numpy(np.ascontiguousarray(arr))
        pinned = pageable.pin_memory()
        out[name] = {
            "bytes": int(arr.nbytes),
            "pageable_ms": host_ms(lambda: pageable.to("cuda")),
            "pinned_ms": host_ms(
                lambda: pinned.to("cuda", non_blocking=True))}
    return out


def imagenet_twin_phase(mx, K, card, hand_img_per_s):
    """The input pipeline on ``gpu(0)`` at ResNet-50's full width (224²,
    1000 classes, batch 32, float32), from a 512-image ``.npy`` RecordIO
    pack (8 classes) written with the port's ``pack_img``: the
    train_imagenet twin as the JAX script runs it (the plain host path, BN
    launches counted from 0); the same 2 epochs fed four ways through the
    deferred augment, bit for bit: (a) streamed, (b) prefetched, (c)
    cached on the card and prefetched, (d) the host placement; the
    card's ``DeviceAugment.apply`` against ``apply_host``;
    ``ImageRecordIter(device_augment=True)`` against the host path; a
    staged batch held across ring turns; the CIFAR twin's u8 flags; and
    the pipeline's numbers (img/s, host-wait, wire bytes, copy ms, the
    host's decode rate). Returns the twin run's BN launches."""
    import contextlib
    import io as pyio
    import shutil
    import numpy as np
    import torch
    from mxnet_tpu_torch.data import (CachedDataset, DeviceAugment,
                                      DeviceAugmentIter, DeviceLoader)
    from mxnet_tpu_torch.examples import train_cifar10, train_imagenet
    work = os.path.join(ROOT, "build", "imagenet_twin")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    failed = []

    def check(name, ok, row):
        row["ok"] = bool(ok)
        emit(row)
        if not ok:
            failed.append(name)

    pack = os.path.join(work, "train.rec")
    t0 = time.perf_counter()
    nbytes = write_pack(pack, IMNET_IMAGES, IMAGE, IMNET_CLASSES)
    emit({"phase": "imagenet_pack", "images": IMNET_IMAGES,
          "classes": IMNET_CLASSES, "image": list(IMAGE), "bytes": nbytes,
          "seconds": time.perf_counter() - t0})

    # the host's decode-and-assemble rate alone (the plain host path)
    it = mx.io.ImageRecordIter(
        path_imgrec=pack, data_shape=IMAGE, batch_size=BATCH, shuffle=True,
        rand_mirror=True, **dict(zip(("mean_r", "mean_g", "mean_b"),
                                     IMNET_MEAN)))
    t0 = time.perf_counter()
    rows = sum(b.data[0].shape[0] for b in it)
    host_rate = rows / (time.perf_counter() - t0)
    it.close()

    # the twin, as the JAX script runs it
    torch.cuda.synchronize()
    K.bn_fwd.launches = K.bn_bwd.launches = 0
    out = pyio.StringIO()
    with contextlib.redirect_stdout(out):
        res = train_imagenet.main(IMNET_TWIN_ARGS + [
            "--data-train", pack, "--network", IMNET_NETWORK,
            "--batch-size", str(BATCH), "--num-epochs", str(IMNET_EPOCHS)])
    torch.cuda.synchronize()
    launches = {"bn_fwd": K.bn_fwd.launches, "bn_bwd": K.bn_bwd.launches}
    printed = out.getvalue()
    print(printed, end="")
    want = BN_PER_STEP * IMNET_STEPS
    twin_params = host_params(res["module"])
    finite = all(np.isfinite(v).all() for v in twin_params.values())
    check("twin", "TRAIN_IMAGENET_DONE" in printed and finite
          and res["steps"] == IMNET_STEPS
          and launches == {"bn_fwd": want, "bn_bwd": want}, {
              "phase": "imagenet_twin_fit", "network": IMNET_NETWORK,
              "image": list(IMAGE), "batch": BATCH, "steps": res["steps"],
              "launches": launches, "want": {"bn_fwd": want,
                                             "bn_bwd": want},
              "fit_img_per_s": res["fit_img_per_s"], "fit_s": res["fit_s"],
              "train_accuracy": res["train_accuracy"], "finite": finite,
              "done_printed": "TRAIN_IMAGENET_DONE" in printed,
              "card": card})
    del res, twin_params
    torch.cuda.empty_cache()

    # the four ways through the deferred augment, from one parameter set
    mx.random.seed(0)
    init = resnet50_module(mx, mx.gpu(0), BATCH)
    args, aux = [{k: v.copy() for k, v in d.items()}
                 for d in init.get_params()]
    del init
    runs = {}
    runs["a_streamed"] = fed_fit(mx, defer_iter(mx, pack), args, aux)
    runs["b_prefetched"] = fed_fit(mx, defer_iter(mx, pack), args, aux,
                                   prefetch=2)
    mod_c = mx.mod.Module(mx.models.get_symbol(
        IMNET_NETWORK, num_classes=1000, image_shape=IMAGE),
        context=mx.gpu(0))
    cached = CachedDataset(defer_iter(mx, pack), module=mod_c,
                           placement="device")
    runs["c_cached"] = fed_fit(mx, cached, args, aux, prefetch=2,
                               module=mod_c)
    info = cached.cache_info()
    src = defer_iter(mx, pack)
    runs["d_host"] = fed_fit(mx, DeviceAugmentIter(
        src, src.device_augment_spec["data"], placement="host"), args, aux)
    ref = runs["a_streamed"][0]
    equal = {k: all(np.array_equal(ref[n], r[0][n]) for n in ref)
             for k, r in runs.items()}
    ways = {k: {"fit_img_per_s": r[1], "steps": r[3],
                "host_wait_ms_per_step": r[2].get("host_wait_ms_per_step"),
                "ring_high_water": r[2].get("ring_high_water"),
                "ring_depth": r[2].get("ring_depth"),
                "staged_bytes_per_batch": r[2].get("staged_bytes_per_batch"),
                "staged_dtype": r[2].get("staged_dtype"),
                "augment_placement": r[2].get("augment_placement"),
                "bit_equal_to_a": equal[k]} for k, r in runs.items()}
    check("four_ways", all(equal.values())
          and all(r[3] == IMNET_STEPS for r in runs.values())
          and info["placement"] == "device" and info["rows"] ==
          IMNET_IMAGES, {
              "phase": "imagenet_fed_ways", "arrays": len(ref),
              "ways": ways, "cache_info": info,
              "synthetic_hand_img_per_s": hand_img_per_s,
              "card": card})
    del runs, cached, mod_c, ref
    torch.cuda.empty_cache()

    # the card's augment against the numpy reference, on a padded,
    # randomly cropped and mirrored batch
    spec = DeviceAugment(IMAGE, rand_crop=True, rand_mirror=True,
                         pad=IMNET_PAD, mean=IMNET_MEAN, std=IMNET_STD,
                         seed=5)
    x = np.random.RandomState(2).randint(
        0, 256, (BATCH,) + spec.wire_shape).astype(np.uint8)
    p = spec.draw("data", 1, 3, BATCH)
    crop, mirror = p["data.aug_crop"], p["data.aug_mirror"]
    card_dev = mx.gpu(0).torch_device()
    dev = spec.apply(torch.from_numpy(x).to(card_dev),
                     torch.from_numpy(crop).to(card_dev),
                     torch.from_numpy(mirror).to(card_dev)).cpu().numpy()
    host = spec.apply_host(x, crop, mirror)
    check("apply", np.array_equal(dev, host), {
        "phase": "imagenet_augment_apply", "shape": list(dev.shape),
        "mirrored_rows": int(mirror.sum()),
        "max_abs_err": float(np.abs(dev - host).max()),
        "bit_equal": bool(np.array_equal(dev, host))})

    # ImageRecordIter(device_augment=True) against the plain host path
    kw = dict(path_imgrec=pack, data_shape=IMAGE, batch_size=BATCH,
              rand_mirror=True, seed=4,
              **dict(zip(("mean_r", "mean_g", "mean_b"), IMNET_MEAN)),
              **dict(zip(("std_r", "std_g", "std_b"), IMNET_STD)))
    h_it = mx.io.ImageRecordIter(**kw)
    d_it = mx.io.ImageRecordIter(device_augment=True, ctx=mx.gpu(0), **kw)
    errs = []
    for _ in range(2):
        a, b = next(h_it), next(d_it)
        errs.append(float(np.abs(a.data[0].asnumpy()
                                 - b.data[0].asnumpy()).max()))
    on_card = b.data[0].context == mx.gpu(0)
    h_it.close()
    d_it.close()
    check("device_augment_iter", max(errs) <= 1e-4 and on_card, {
        "phase": "imagenet_device_augment_iter", "max_abs_err": max(errs),
        "atol": 1e-4, "on_card": on_card})

    # a staged batch held while the ring turns over: its bytes stay
    ref_it = defer_iter(mx, pack)
    want_first = next(ref_it).data[0]
    ref_it.close()
    loader_src = defer_iter(mx, pack)
    with DeviceLoader(loader_src, depth=2, ctx=mx.gpu(0)) as loader:
        first = next(loader)
        turned = sum(1 for _ in loader)
        held = first.data[0]._read()
        same = held.device == card_dev and np.array_equal(
            held.cpu().numpy(), want_first)
    loader_src.close()
    check("held_batch", same and turned == IMNET_IMAGES // BATCH - 1, {
        "phase": "imagenet_held_batch", "ring_turns_after": turned,
        "bytes_unchanged": bool(same)})

    # the wire and the copy
    copies = copy_times(np.random.RandomState(3).randint(
        0, 256, (BATCH, IMAGE[1], IMAGE[2], IMAGE[0])).astype(np.uint8))
    emit({"phase": "imagenet_wire", "batch": BATCH,
          "wire_bytes_uint8": BATCH * int(np.prod(IMAGE)),
          "wire_bytes_float32": BATCH * int(np.prod(IMAGE)) * 4,
          "copy": copies, "host_decode_assemble_img_per_s": host_rate,
          "card": card})

    # the CIFAR twin's u8 flags: one digest, accuracy >= 0.9
    digests, accs = [], []
    for i, flags in enumerate((
            ["--device-augment", "--cache-dataset", "--prefetch-device",
             "2"],
            ["--device-augment", "--augment-placement", "host"])):
        path = os.path.join(work, "cifar_u8_%d.txt" % i)
        t0 = time.time()
        r = train_cifar10.main(TWIN_ARGS + flags + [
            "--params-digest-out", path])
        digests.append(r["params_digest"])
        accs.append(r["accuracy"])
        emit({"phase": "imagenet_cifar_u8_run", "flags": flags,
              "accuracy": r["accuracy"], "fit_img_per_s":
              r.get("fit_img_per_s"), "seconds": time.time() - t0})
        del r
    check("cifar_u8", digests[0] == digests[1]
          and min(accs) >= TWIN_MIN_ACCURACY, {
              "phase": "imagenet_cifar_u8", "params_digests": digests,
              "accuracy": accs, "min_accuracy": TWIN_MIN_ACCURACY})
    if failed:
        raise RuntimeError("imagenet_twin phase failed: %s"
                           % ", ".join(failed))
    return launches


# ---------------------------------------------------------------------------
# phase 12: the model zoo
# ---------------------------------------------------------------------------
# the zoo at its published widths: network -> (input, BatchNorms a step
# after the BN+ReLU fusion); batch BATCH, 1000 classes
ZOO_NETS = {"alexnet": ((3, 224, 224), 0), "vgg": ((3, 224, 224), 0),
            "googlenet": ((3, 224, 224), 0),
            "inception-bn": ((3, 224, 224), 69),
            "inception-v3": ((3, 299, 299), 94),
            "inception-resnet-v2": ((3, 299, 299), 114),
            "resnext-50": ((3, 224, 224), 54),
            "resnet-50": ((3, 224, 224), BN_PER_STEP)}
ZOO_BN_NETS = ("inception-bn", "inception-v3", "inception-resnet-v2",
               "resnext-50")
ZOO_MAIN = "inception-v3"
ZOO_STEPS = 3
# lr 0.01: the reference's rate for the zoo's nets without BatchNorm
# (alexnet, vgg), which lr 0.1 drives to NaN within 3 steps of one batch
ZOO_SGD_PARAMS = dict(SGD_PARAMS, learning_rate=0.01)
ZOO_TWIN_IMAGES, ZOO_TWIN_CLASSES = 256, 8      # 1 epoch of 8 steps
ZOO_TWIN_ARGS = ["--gpus", "0"]
ZOO_SCORE_BATCHES = 8
ZOO_DROPOUT_NET, ZOO_DROPOUT_BATCHES = "alexnet", 4
ZOO_FINE_TUNE_ARGS = ["--gpus", "0"]


def card_generator(seed):
    import torch
    return torch.Generator(device="cuda").manual_seed(seed)


def plan_label(K, op, shape, dtype, need_dx=True):
    """A plan as "<kind> <unit bytes>B" ("cluster 4" counts its blocks)."""
    return "%s %dB" % (plan_name(K, op, shape, dtype, need_dx),
                       K.plan(op, shape, dtype, need_dx).unit_bytes)


def zoo_kernels(mx, K, card):
    """``bn_fwd``/``bn_bwd`` against their plain versions at every
    BatchNorm shape of inception-bn, inception-v3, inception-resnet-v2
    and resnext-50 (batch ``BATCH``, published input), in float32 and
    bfloat16, at the networks' own fix_gamma, ReLU and need_dx flags,
    with phase 3's ``TOL``; each shape's plan, and the calls of a step by
    plan. Returns the worst errors of each kernel by dtype."""
    import torch
    gen = card_generator(12)
    worst = {d: {"bn_fwd": 0.0, "bn_bwd": 0.0} for d in ("f32", "bf16")}
    failures, cases = [], 0
    for net in ZOO_BN_NETS:
        counts = model_bn_shapes(mx, net, ZOO_NETS[net][0], 1000, BATCH)
        for dtype, dname in ((torch.float32, "f32"),
                             (torch.bfloat16, "bf16")):
            by_plan = {}
            for (shape, fix_gamma, relu, need_dx), n in sorted(
                    counts.items()):
                inputs = bn_inputs(shape, dtype, gen)
                fields, ok, _, _ = compare_case(K, inputs, dtype, relu,
                                                fix_gamma, False, need_dx)
                plan = {op: plan_label(K, op, shape, dtype, need_dx)
                        for op in ("fwd", "bwd")}
                for op, label in plan.items():
                    key = "%s %s" % (op, label)
                    by_plan[key] = by_plan.get(key, 0) + n
                row = {"phase": "zoo_kernels", "network": net,
                       "shape": list(shape), "dtype": dname,
                       "fix_gamma": fix_gamma, "relu": relu,
                       "need_dx": need_dx, "per_step": n, "plan": plan,
                       **fields, "ok": ok}
                emit(row)
                cases += 1
                worst[dname]["bn_fwd"] = max(worst[dname]["bn_fwd"],
                                             fields["y_max_abs_err"])
                worst[dname]["bn_bwd"] = max(worst[dname]["bn_bwd"],
                                             fields["dx_max_abs_err"])
                if not ok:
                    failures.append(row)
                del inputs
            emit({"phase": "zoo_kernel_plans", "network": net,
                  "dtype": dname, "batchnorms": sum(counts.values()),
                  "shapes": len(counts), "calls_by_plan": by_plan})
    emit({"phase": "zoo_kernels_summary", "cases": cases,
          "failures": len(failures), "worst": worst, "card": card})
    if failures:
        raise RuntimeError("zoo kernel check failed at %d case(s): %s" % (
            len(failures), json.dumps([[f["network"], f["shape"],
                                        f["dtype"]] for f in failures])))
    return worst


def zoo_kernel_times(mx, K, card, copy_rate):
    """``time_kernels`` over inception-v3's BatchNorms (L2-cold, as phase
    3) in float32 and bfloat16: per-step device, call, bound and library
    times. Returns them by dtype."""
    import torch
    counts = model_bn_shapes(mx, ZOO_MAIN, ZOO_NETS[ZOO_MAIN][0], 1000,
                             BATCH)
    out = {}
    for dtype, dname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        tot, at_copy, worst = time_kernels(K, counts, copy_rate,
                                           model=ZOO_MAIN, dtype=dtype)
        emit({"phase": "zoo_kernel_times_per_step", "model": ZOO_MAIN,
              "batch": BATCH, "dtype": dname, "card": card, **tot,
              "bound_ms_at_measured_copy": at_copy, "worst_abs_err": worst,
              "measured_copy_gb_per_s": copy_rate / 1e9})
        out[dname] = tot
    return out


def zoo_train_run(mx, K, net, dtype=None):
    """``ZOO_STEPS`` fused SGD steps of ``net`` (Xavier from seed 0, one
    synthetic batch): the row and whether its gates hold."""
    import gc
    import numpy as np
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    image, n_bn = ZOO_NETS[net]
    ctx = mx.gpu(0)
    mx.random.seed(0)
    mod = mx.mod.Module(mx.models.get_symbol(net, num_classes=1000,
                                             image_shape=image),
                        context=ctx, compute_dtype=dtype)
    mod.bind(data_shapes=[("data", (BATCH,) + image)],
             label_shapes=[("softmax_label", (BATCH,))])
    mod.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2))
    mod.init_optimizer(optimizer="sgd", optimizer_params=ZOO_SGD_PARAMS)
    batch = synthetic_batch(mx, ctx, BATCH, 0, image)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in (K.bn_fwd, K.bn_bwd):
        k.launches = k.launches_bf16 = 0
    step_ms = []
    for _ in range(ZOO_STEPS):
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated()
    launches = {k: getattr(K, k).launches for k in ("bn_fwd", "bn_bwd")}
    bf16 = {k: getattr(K, k).launches_bf16 for k in ("bn_fwd", "bn_bwd")}
    out = mod.get_outputs()[0].asnumpy()
    eg = mod._exec_group
    finite = bool(np.isfinite(out).all()) and all(
        bool(torch.isfinite(eg.execs[0].arg_dict[n]._read()).all())
        for n in eg.param_names)
    ms = statistics.median(step_ms[1:])
    want = n_bn * ZOO_STEPS
    want_bf16 = want if dtype == "bfloat16" else 0
    ok = (finite and out.shape == (BATCH, 1000)
          and launches == {"bn_fwd": want, "bn_bwd": want}
          and bf16 == {"bn_fwd": want_bf16, "bn_bwd": want_bf16})
    row = {"phase": "zoo_train", "network": net, "image": list(image),
           "batch": BATCH, "dtype": dtype or "float32",
           "route": type(eg).__name__, "steps": ZOO_STEPS,
           "step_ms": step_ms, "ms_per_step": ms,
           "img_per_s": BATCH / (ms / 1e3), "peak_memory_bytes": peak,
           "bn_per_step": n_bn, "launches": launches,
           "launches_bf16": bf16, "finite": finite, "ok": ok}
    del mod, batch, eg
    return row, ok


def zoo_imagenet_twin(mx, K, card):
    """The train_imagenet twin on inception-v3 (299², 1000 classes,
    batch ``BATCH``) from a ``ZOO_TWIN_IMAGES``-image ``.npy`` pack, one
    epoch; BN launches counted from 0."""
    import contextlib
    import io as pyio
    import shutil
    import numpy as np
    import torch
    from mxnet_tpu_torch.examples import train_imagenet
    work = os.path.join(ROOT, "build", "zoo_twin")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    image = ZOO_NETS[ZOO_MAIN][0]
    pack = os.path.join(work, "train.rec")
    nbytes = write_pack(pack, ZOO_TWIN_IMAGES, image, ZOO_TWIN_CLASSES)
    torch.cuda.synchronize()
    K.bn_fwd.launches = K.bn_bwd.launches = 0
    out = pyio.StringIO()
    with contextlib.redirect_stdout(out):
        res = train_imagenet.main(ZOO_TWIN_ARGS + [
            "--data-train", pack, "--network", ZOO_MAIN, "--image-shape",
            ",".join(map(str, image)), "--batch-size", str(BATCH),
            "--num-epochs", "1"])
    torch.cuda.synchronize()
    launches = {"bn_fwd": K.bn_fwd.launches, "bn_bwd": K.bn_bwd.launches}
    printed = out.getvalue()
    print(printed, end="")
    steps = ZOO_TWIN_IMAGES // BATCH
    want = ZOO_NETS[ZOO_MAIN][1] * steps
    params = host_params(res["module"])
    finite = all(np.isfinite(v).all() for v in params.values())
    row = {"phase": "zoo_imagenet_twin", "network": ZOO_MAIN,
           "image": list(image), "batch": BATCH, "pack_bytes": nbytes,
           "steps": res["steps"], "launches": launches,
           "want": {"bn_fwd": want, "bn_bwd": want},
           "fit_img_per_s": res.get("fit_img_per_s"), "fit_s": res["fit_s"],
           "finite": finite,
           "done_printed": "TRAIN_IMAGENET_DONE" in printed, "card": card}
    row["ok"] = (row["done_printed"] and finite and res["steps"] == steps
                 and launches == row["want"])
    del res, params
    shutil.rmtree(work, ignore_errors=True)
    return row, launches


def zoo_score(mx, K, card):
    """The benchmark_score twin over every zoo network at batch
    ``BATCH``, in float32 and bfloat16: images/s; no BN kernel launches
    (eval BatchNorm is plain torch ops)."""
    import contextlib
    import io as pyio
    import torch
    from mxnet_tpu_torch.examples import benchmark_score
    rates, launches = {}, {}
    for dtype in ("float32", "bfloat16"):
        torch.cuda.synchronize()
        K.bn_fwd.launches = K.bn_bwd.launches = 0
        with contextlib.redirect_stdout(pyio.StringIO()):
            got = benchmark_score.main([
                "--gpus", "0", "--networks", ",".join(ZOO_NETS),
                "--batch-size", str(BATCH), "--num-batches",
                str(ZOO_SCORE_BATCHES), "--dtype", dtype])
        torch.cuda.synchronize()
        launches[dtype] = {"bn_fwd": K.bn_fwd.launches,
                           "bn_bwd": K.bn_bwd.launches}
        rates[dtype] = {net: r for net, (r, _) in got.items()}
        torch.cuda.empty_cache()
    row = {"phase": "zoo_score", "batch": BATCH,
           "num_batches": ZOO_SCORE_BATCHES, "img_per_s": rates,
           "launches": launches, "card": card}
    row["ok"] = (all(v == {"bn_fwd": 0, "bn_bwd": 0}
                     for v in launches.values())
                 and all(len(r) == len(ZOO_NETS) and min(r.values()) > 0
                         for r in rates.values()))
    return row


def zoo_dropout(mx, card):
    """alexnet (two Dropouts, p 0.5) at batch ``BATCH`` under
    deterministic cuDNN, from one parameter set: 3 steps twice from one
    ``mx.random.seed`` bit for bit; the fused route against the classic
    one and remat=full against none (bit for bit, else relative L2
    ``ROUTE_REL_L2`` with the reason); ``fit(batch_group=2)`` twice bit
    for bit; Dropout's kept fraction on a 32×4096 activation on the card
    within 4σ of 1 − p, and its mask equal to the CPU's from the same
    key; ``predict`` twice equal, drawing no key."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import random as mxr
    from mxnet_tpu_torch import registry as treg
    net = ZOO_DROPOUT_NET
    image = ZOO_NETS[net][0]
    ctx = mx.gpu(0)
    sym = mx.models.get_symbol(net, num_classes=1000, image_shape=image)
    mx.random.seed(0)
    init = mx.mod.Module(sym, context=ctx)
    init.bind(data_shapes=[("data", (BATCH,) + image)],
              label_shapes=[("softmax_label", (BATCH,))])
    init.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                    magnitude=2))
    a, x = init.get_params()
    args = {k: v.copy() for k, v in a.items()}
    aux = {k: v.copy() for k, v in x.items()}
    del init
    batches = [synthetic_batch(mx, ctx, BATCH, s, image) for s in range(3)]
    failed = []

    def check(name, ok, row):
        row["ok"] = bool(ok)
        emit(row)
        if not ok:
            failed.append(name)

    def steps(**kw):
        mx.random.seed(5)
        mod = mx.mod.Module(sym, context=ctx, **kw)
        mod.bind(data_shapes=[("data", (BATCH,) + image)],
                 label_shapes=[("softmax_label", (BATCH,))])
        mod.init_params(arg_params=args, aux_params=aux)
        mod.init_optimizer(optimizer="sgd", optimizer_params=ZOO_SGD_PARAMS)
        drawn = mxr.get_state()["keys_drawn"]
        for b in batches:
            mod.forward_backward(b)
            mod.update()
        keys = mxr.get_state()["keys_drawn"] - drawn
        return host_params(mod), type(mod._exec_group).__name__, keys, mod

    def diff(p, q):
        bad = [k for k in p if not np.array_equal(p[k], q[k])]
        rel = max([float(np.linalg.norm(p[k] - q[k]) /
                         max(np.linalg.norm(q[k]), 1e-30)) for k in bad]
                  or [0.0])
        return bad, rel

    with deterministic_cudnn():
        fused, route, keys, mod = steps()
        again, _, _, _ = steps()
        bad, _ = diff(fused, again)
        check("repeat", not bad and keys == len(batches), {
            "phase": "zoo_dropout_repeat", "network": net, "route": route,
            "steps": len(batches), "keys_drawn": keys,
            "params_differing": bad, "card": card})
        classic, croute, _, _ = steps(_allow_fused=False)
        bad, rel = diff(fused, classic)
        check("routes", not bad or rel <= ROUTE_REL_L2, {
            "phase": "zoo_dropout_routes", "routes": [route, croute],
            "bitwise_equal": not bad, "params_differing": bad,
            "max_rel_l2": rel, "limit": ROUTE_REL_L2,
            "reason": None if not bad else "cuDNN/cuBLAS pick other "
            "algorithms in the classic route's separate calls",
            "card": card})
        remat, _, _, _ = steps(remat="full")
        bad, rel = diff(fused, remat)
        check("remat", not bad or rel <= ROUTE_REL_L2, {
            "phase": "zoo_dropout_remat", "remat": "full",
            "bitwise_equal": not bad, "params_differing": bad,
            "max_rel_l2": rel, "limit": ROUTE_REL_L2,
            "reason": None if not bad else "a segment's replay runs its "
            "convolutions again, and cuDNN may pick another algorithm",
            "card": card})

        rs = np.random.RandomState(7)
        n = BATCH * ZOO_DROPOUT_BATCHES
        X = rs.randn(n, *image).astype(np.float32)
        y = rs.randint(0, 1000, n).astype(np.float32)
        grouped = []
        for _ in range(2):
            mx.random.seed(5)
            gmod = mx.mod.Module(sym, context=ctx)
            gmod.fit(mx.io.NDArrayIter(X, y, batch_size=BATCH),
                     num_epoch=1, optimizer="sgd",
                     optimizer_params=ZOO_SGD_PARAMS, arg_params=args,
                     aux_params=aux, batch_group=2)
            grouped.append((host_params(gmod), gmod.grouped_train_engaged()))
            del gmod
        bad, _ = diff(grouped[0][0], grouped[1][0])
        check("grouped", not bad and grouped[0][1], {
            "phase": "zoo_dropout_grouped", "batch_group": 2,
            "batches": ZOO_DROPOUT_BATCHES, "engaged": grouped[0][1],
            "params_differing": bad, "card": card})

        # the mask on the card, from one key: its kept fraction, and the
        # CPU's mask from the same key
        p = 0.5
        op = treg.get_op("Dropout")
        key = mxr.fold_in(mxr.next_key(), 0)
        act = torch.rand(BATCH, 4096, device="cuda") + 0.5
        card_out = op.fcompute({"p": p}, [act], treg.OpContext(
            is_train=True, key=key))[0]
        cpu_out = op.fcompute({"p": p}, [act.cpu()], treg.OpContext(
            is_train=True, key=key))[0]
        kept = float((card_out != 0).float().mean())
        sigma = (p * (1 - p) / act.numel()) ** 0.5
        same = torch.equal(card_out.cpu() != 0, cpu_out != 0)
        check("mask", abs(kept - (1 - p)) <= 4 * sigma and same, {
            "phase": "zoo_dropout_mask", "shape": list(act.shape), "p": p,
            "kept_fraction": kept, "sigma": sigma,
            "card_mask_equals_cpu_mask": same, "card": card})

        it = mx.io.NDArrayIter(X, y, batch_size=BATCH)
        drawn = mxr.get_state()["keys_drawn"]
        p1 = mod.predict(it).asnumpy()
        p2 = mod.predict(it).asnumpy()
        drew = mxr.get_state()["keys_drawn"] - drawn
        finite = bool(np.isfinite(p1).all())
        check("eval", finite and np.array_equal(p1, p2) and drew == 0, {
            "phase": "zoo_dropout_eval", "rows": int(p1.shape[0]),
            "finite": finite, "equal": bool(np.array_equal(p1, p2)),
            "keys_drawn": drew, "card": card})
    del mod
    return failed


def zoo_phase(mx, K, card, copy_rate):
    """Phase 12 (module docstring). Returns the BN kernels' launches by
    network (the training runs and the twin), inception-v3's per-step
    kernel times by dtype and the worst errors by dtype."""
    import gc
    import torch
    failed = []
    worst = zoo_kernels(mx, K, card)
    v3_times = zoo_kernel_times(mx, K, card, copy_rate)
    launches = {"bn_fwd": {}, "bn_bwd": {}}
    for net in ZOO_NETS:
        for dtype in ((None, "bfloat16") if net == ZOO_MAIN else (None,)):
            row, ok = zoo_train_run(mx, K, net, dtype)
            row["card"] = card
            emit(row)
            if not ok:
                failed.append("train %s %s" % (net, row["dtype"]))
            name = net if dtype is None else "%s-bf16" % net
            for k in launches:
                launches[k][name] = row["launches"][k]
    gc.collect()
    torch.cuda.empty_cache()
    row, twin = zoo_imagenet_twin(mx, K, card)
    emit(row)
    if not row["ok"]:
        failed.append("imagenet_twin")
    for k in launches:
        launches[k]["imagenet_twin"] = twin[k]
    row = zoo_score(mx, K, card)
    emit(row)
    if not row["ok"]:
        failed.append("score")
    failed += ["dropout " + f for f in zoo_dropout(mx, card)]
    from mxnet_tpu_torch.examples import fine_tune
    t0 = time.time()
    acc = fine_tune.main(ZOO_FINE_TUNE_ARGS)
    emit({"phase": "zoo_fine_tune", "accuracy": acc,
          "seconds": time.time() - t0, "ok": True, "card": card})
    if failed:
        raise RuntimeError("zoo phase failed: %s" % ", ".join(failed))
    return launches, v3_times, worst


# ---------------------------------------------------------------------------
# phase 13: the recurrent path (the RNN operator onto cuDNN, the char-LSTM
# and bucketing twins)
# ---------------------------------------------------------------------------
# (name, T, N, I, H, layers): the PTB widths of MXNet 0.9.5's
# lstm_bucketing.py at sequence 35, and char_lstm.py's defaults
RNN_SHAPES = [("ptb", 35, 32, 200, 200, 2), ("char", 32, 32, 64, 256, 2)]
RNN_MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")
# the op against rnn_plain on the card, as the error's share of the plain
# value's max-abs: cuDNN sums the gates' products and, in the backward,
# the steps' and rows' terms in another order than the loop
RNN_TOL = 1e-4
# rnn_relu: a pre-activation within this share of its step's max-abs of
# the ReLU's kink may take the other side in the other computation (a
# mask flip, whose gradient differs by the whole term); such a batch row
# is left out of the gradient comparison (its head gradient set to 0 on
# both sides: rows are independent), and at most half the rows may be
RNN_KINK = 1e-6
RNN_TIME_CASES = [("ptb", m, False) for m in RNN_MODES] + \
    [("ptb", "lstm", True), ("char", "lstm", False)]
RNN_TIME_REPS = 10
RNN_PLAIN_REPS = 1       # the loop takes ~5,000 launches and 30-220 ms
#                          a call: one call is a long sample, and its
#                          profiler trace was the phase's largest cost
RNN_DEVICE = "cuda"
# the JAX script's lr 0.1 diverges at its own default width in both
# packages (the JAX script's perplexity is NaN from epoch 0 on the CPU;
# the twin's rises to ~1e6), so the phase trains at lr 0.01
CHAR_TWIN_ARGS = ["--gpus", "0", "--lr", "0.01"]
BUCKET_TWIN_ARGS = ["--gpus", "0", "--num-layers", "2", "--num-hidden",
                    "200", "--num-embed", "200", "--batch-size", "32",
                    "--buckets", "10,20,30,40,50,60", "--vocab-size",
                    "10000", "--zipf", "1.0", "--sentences", "3200",
                    "--num-epochs", "2", "--seed", "7"]
RNN_PROFILE_STEPS = 10


def rnn_attrs(mode, bi, layers, H):
    return {"state_size": H, "num_layers": layers, "bidirectional": bi,
            "mode": mode, "state_outputs": True}


def rnn_case_inputs(mode, bi, shape, gen):
    """Data, flat parameters, states of one case on the card, requiring
    gradients, from the card's generator."""
    import torch
    from mxnet_tpu_torch.ops import rnn_op
    _, T, N, I, H, L = shape
    d = 2 if bi else 1
    size = rnn_op.rnn_param_size(L, I, H, bi, mode)

    def rnd(*sh, scale=1.0):
        return (torch.randn(*sh, generator=gen, device=RNN_DEVICE)
                * scale).requires_grad_()

    ins = [rnd(T, N, I), rnd(size, scale=(1.0 / H) ** 0.5),
           rnd(L * d, N, H, scale=0.5)]
    if mode == "lstm":
        ins.append(rnd(L * d, N, H, scale=0.5))
    return ins


def rnn_flops(mode, bi, shape):
    """The matrix products' floating-point operations of one forward:
    2·T·N·G·H·(in + H) per layer and direction."""
    from mxnet_tpu_torch.ops import rnn_op
    _, T, N, I, H, L = shape
    d = 2 if bi else 1
    g = rnn_op._gates(mode)
    return sum(2 * T * N * g * H * ((I if layer == 0 else H * d) + H) * d
               for layer in range(L))


def rnn_fwd_bwd(fn, attrs, ins, cots):
    """A callable running ``fn``'s forward and its backward into every
    input."""
    import torch
    from mxnet_tpu_torch import registry as treg

    def run():
        outs = fn(attrs, ins, treg.OpContext(is_train=True))
        return torch.autograd.grad(outs, ins, cots)
    return run


def relu_kink_rows(attrs, ins):
    """The batch rows of an rnn_relu forward that pass within
    ``RNN_KINK`` of the ReLU's kink at some layer, direction and step."""
    import torch
    from mxnet_tpu_torch.ops import rnn_op
    H, L = attrs["state_size"], attrs["num_layers"]
    d = 2 if attrs["bidirectional"] else 1
    data, params, state0 = (t.detach() for t in ins[:3])
    views = rnn_op.split_params(params, L, data.shape[2], H, d, 1)
    rows = torch.zeros(data.shape[1], dtype=torch.bool, device=data.device)
    x = data
    for layer in range(L):
        outs = []
        for di in range(d):
            w, r, bw, br = views[layer * d + di]
            h, ys = state0[layer * d + di], [None] * x.shape[0]
            xw = x @ w.t() + bw
            steps = range(x.shape[0])
            for t in (reversed(steps) if di else steps):
                pre = xw[t] + h @ r.t() + br
                rows |= (pre.abs() < RNN_KINK * pre.abs().max()).any(1)
                h = ys[t] = pre.clamp_min(0)
            outs.append(torch.stack(ys))
        x = torch.cat(outs, -1)
    return rows


def rnn_check(shape, mode, bi, gen):
    """The op against rnn_plain on the card at one shape: the worst
    error (as a share of the plain value's max-abs) over the outputs and
    every gradient, and the rows left out of the gradients (rnn_relu's
    kink rows)."""
    import torch
    from mxnet_tpu_torch import registry as treg
    from mxnet_tpu_torch.ops import rnn_op
    attrs = rnn_attrs(mode, bi, shape[5], shape[4])
    ins = rnn_case_inputs(mode, bi, shape, gen)
    op = treg.get_op("RNN")
    octx = treg.OpContext(is_train=True)
    outs = op.fcompute(attrs, ins, octx)
    cots = [torch.randn(o.shape, generator=gen, device=RNN_DEVICE)
            for o in outs]
    kink = relu_kink_rows(attrs, ins) if mode == "rnn_relu" else \
        torch.zeros(shape[2], dtype=torch.bool, device=RNN_DEVICE)
    for c in cots:       # dim 1 is the batch in the output and the states
        c[:, kink] = 0.0
    grads = torch.autograd.grad(outs, ins, cots)
    pouts = rnn_op.rnn_plain(attrs, ins, octx)
    pgrads = torch.autograd.grad(pouts, ins, cots)
    names = ["output", "state_out", "cell_out"][:len(outs)] + \
        ["d_data", "d_params", "d_state", "d_cell"][:len(ins)]
    errs = {}
    for nm, a, b in zip(names, list(outs) + list(grads),
                        list(pouts) + list(pgrads)):
        scale = float(b.detach().abs().max()) or 1.0
        errs[nm] = float((a - b).detach().abs().max()) / scale
    return errs, int(kink.sum()), attrs, ins, cots


def profile_busy(fn, reps):
    """``fn`` run ``reps`` times under ``torch.profiler``: kernels a
    call, the kernels' summed and merged (busy) device ms a call, the
    host wall ms a call and the device's idle share of that wall. None
    where the trace holds no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy = merged_us(spans)
    return {"kernels_per_call": len(kern) / reps,
            "kernel_ms": sum(b - a for a, b in spans) / 1e3 / reps,
            "busy_ms": busy / 1e3 / reps,
            "wall_ms": wall_us / 1e3 / reps,
            "idle_share": 1.0 - busy / max(wall_us, 1e-9)}


def rnn_op_phase(card):
    """(a) the RNN op against rnn_plain on the card, every mode, uni- and
    bidirectional, at both shapes: outputs and gradients within
    ``RNN_TOL``; (b) the op's and the loop's forward + backward times
    (call: one CUDA-event pair; device: the kernels' busy time under
    torch.profiler; enqueue: host clock, card idle) at ``RNN_TIME_CASES``,
    beside the matrix products' FLOP bound at the f32 peak. Returns the
    failed cases."""
    import torch
    from mxnet_tpu_torch import registry as treg
    from mxnet_tpu_torch.ops import rnn_op
    from mxnet_tpu_torch.tools.bn_probe import cuda_time, enqueue_us
    gen = card_generator(11)
    failed, timed = [], {}
    t0 = time.time()
    shapes = {s[0]: s for s in RNN_SHAPES}
    for shape in RNN_SHAPES:
        for mode in RNN_MODES:
            for bi in (False, True):
                errs, kink, attrs, ins, cots = rnn_check(shape, mode, bi,
                                                         gen)
                worst = max(errs.values())
                ok = worst <= RNN_TOL and 2 * kink <= shape[2]
                emit({"phase": "rnn_op_check", "shape": shape[0],
                      "T_N_I_H_layers": list(shape[1:]), "mode": mode,
                      "bidirectional": bi, "rel_err": errs, "worst": worst,
                      "limit": RNN_TOL, "kink_rows_left_out": kink,
                      "kink_limit": RNN_KINK, "ok": ok, "card": card})
                if not ok:
                    failed.append("rnn op %s %s bi=%s" % (shape[0], mode,
                                                          bi))
                if (shape[0], mode, bi) in RNN_TIME_CASES:
                    timed[(shape[0], mode, bi)] = (attrs, ins, cots)
    emit({"phase": "rnn_op_check_seconds", "seconds": time.time() - t0})
    op = treg.get_op("RNN")
    for key in RNN_TIME_CASES:
        t0 = time.time()
        attrs, ins, cots = timed[key]
        row = {"phase": "rnn_op_times", "shape": key[0],
               "T_N_I_H_layers": list(shapes[key[0]][1:]), "mode": key[1],
               "bidirectional": key[2], "card": card}
        flops = 3 * rnn_flops(key[1], key[2], shapes[key[0]])
        row["bound_ms_flops"] = 1e3 * flops / F32_FLOPS_PER_S
        for name, fn, reps in (("op", op.fcompute, RNN_TIME_REPS),
                               ("plain", rnn_op.rnn_plain, RNN_PLAIN_REPS)):
            run = rnn_fwd_bwd(fn, attrs, ins, cots)
            prof = profile_busy(run, reps)
            row[name] = {
                "call_ms": cuda_time(run, reps=reps, warm=1),
                "device_ms": prof["busy_ms"] if prof else "not measured",
                "kernels": prof["kernels_per_call"] if prof else None,
                "enqueue_us": enqueue_us(run, reps=reps)}
        with torch.no_grad():
            fwd = lambda: op.fcompute(attrs, ins, treg.OpContext())  # noqa
            row["op"]["forward_call_ms"] = cuda_time(fwd,
                                                     reps=RNN_TIME_REPS)
        row["seconds"] = time.time() - t0
        emit(row)
    return failed


def rnn_twin_rows(res, work_name):
    """Per epoch: ms a step, the work (tokens or positions) a second and
    the training perplexity."""
    return [{"epoch": r["epoch"], "batches": r["batches"],
             "ms_per_step": r["ms_per_step"], work_name: r["work_per_s"],
             "perplexity": r["metric"]} for r in res["epochs"]]


def char_lstm_twin(mx, card):
    """The char_lstm twin at full width in process: RNN launches a step,
    ms a step, tokens/s and perplexity by epoch (it must fall), then one
    step profiled. Returns (failed, RNN launches)."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.examples import char_lstm
    from mxnet_tpu_torch.ops import rnn_op
    rnn_op.launches = 0
    t0 = time.time()
    res = char_lstm.main(CHAR_TWIN_ARGS)
    seconds = time.time() - t0
    launches = rnn_op.launches
    mod = res["module"]
    ppl = res["perplexity"]
    finite = all(np.isfinite(v).all() for v in host_params(mod).values())
    ok = finite and ppl[-1] < ppl[0] and launches == res["steps"]
    X, Y, _ = char_lstm.load_data(None, res["seq_len"])
    b = res["batch_size"]
    batch = mx.io.DataBatch([mx.nd.array(X[:b], ctx=mx.cpu())],
                            [mx.nd.array(Y[:b], ctx=mx.cpu())])

    def step():
        mod.forward_backward(batch)
        mod.update()
    prof = profile_busy(step, RNN_PROFILE_STEPS)
    emit({"phase": "rnn_char_lstm", "args": CHAR_TWIN_ARGS,
          "route": type(mod._exec_group).__name__, "steps": res["steps"],
          "rnn_launches": launches,
          "rnn_launches_per_step": launches / max(res["steps"], 1),
          "epochs": rnn_twin_rows(res, "tokens_per_s"),
          "perplexity_falls": ppl[-1] < ppl[0], "finite": finite,
          "step_profile": prof, "seconds": seconds, "ok": ok,
          "card": card})
    del mod, res
    torch.cuda.empty_cache()
    return ([] if ok else ["char_lstm twin"]), launches


def bucketing_twin(mx, card):
    """The bucketing_lstm twin at PTB width twice from one seed under
    deterministic cuDNN, the first with per-bucket times (the queue
    drained after every batch), the second without: ms a step by bucket,
    tokens/s, the buckets bound, every bucket on the master's parameter
    and gradient storage, perplexity falling, the two runs' parameter
    digests. Returns the failed checks."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.examples import bucketing_lstm
    from mxnet_tpu_torch.examples.train_cifar10 import params_digest
    from mxnet_tpu_torch.ops import rnn_op
    failed, digests, runs = [], [], []
    for timed in (True, False):
        rnn_op.launches = 0
        t0 = time.time()
        with deterministic_cudnn():
            res = bucketing_lstm.main(
                BUCKET_TWIN_ARGS + (["--per-bucket-times"] if timed else []))
        seconds = time.time() - t0
        mod = res["module"]
        master = mod.buckets[max(mod.buckets)]._exec_group.execs[0]
        shared = all(
            m._exec_group.execs[0].arg_dict[n]._read().data_ptr() ==
            master.arg_dict[n]._read().data_ptr() and
            m._exec_group.execs[0].grad_dict[n]._read().data_ptr() ==
            master.grad_dict[n]._read().data_ptr()
            for m in mod.buckets.values()
            for n in ("lstm_parameters", "embed_weight", "pred_weight"))
        digests.append(params_digest(mod))
        finite = all(np.isfinite(v).all()
                     for v in host_params(mod).values())
        ppl = res["perplexity"]
        # positions a step: batch × bucket length, padding included
        per_bucket = None if res["bucket_times"] is None else {
            str(k): dict(v, positions_per_s=res["batch_size"] * k * 1e3
                         / v["ms_per_step"])
            for k, v in res["bucket_times"].items()}
        row = {"phase": "rnn_bucketing_lstm", "args": BUCKET_TWIN_ARGS,
               "per_bucket_times": timed, "steps": res["steps"],
               "rnn_launches": rnn_op.launches,
               "buckets_bound": res["buckets_bound"],
               "shared_storage": shared, "finite": finite,
               "perplexity": ppl, "perplexity_falls": ppl[-1] < ppl[0],
               "epochs": rnn_twin_rows(res, "positions_per_s"),
               "by_bucket": per_bucket, "params_digest": digests[-1],
               "seconds": seconds, "card": card}
        row["ok"] = bool(finite and shared and ppl[-1] < ppl[0] and
                         res["buckets_bound"] == [10, 20, 30, 40, 50, 60]
                         and rnn_op.launches == res["steps"])
        emit(row)
        if not row["ok"]:
            failed.append("bucketing twin (per_bucket_times=%s)" % timed)
        runs.append(res)
        del mod
    same = digests[0] == digests[1]
    emit({"phase": "rnn_bucketing_repeat", "deterministic_cudnn": True,
          "digests": digests, "bitwise_equal": same, "ok": same,
          "card": card})
    if not same:
        failed.append("bucketing twin does not repeat bit for bit")
    del runs
    torch.cuda.empty_cache()
    return failed


def rnn_phase(mx, K, C, R, card):
    """Phase 13 (module docstring). Every kernel counter, set to 0 just
    before, reads 0 after the twins (no hand-written kernel lies on the
    recurrent path). Returns those counts and the RNN launches."""
    failed = rnn_op_phase(card)
    for counter in (K.bn_fwd, K.bn_bwd, C.copy, R.rtc_kernel):
        counter.launches = 0
    more, rnn_launches = char_lstm_twin(mx, card)
    failed += more
    failed += bucketing_twin(mx, card)
    launches = {"bn_fwd": K.bn_fwd.launches, "bn_bwd": K.bn_bwd.launches,
                "copy": C.copy.launches, "rtc": R.rtc_kernel.launches}
    emit({"phase": "rnn_kernels", "launches": launches,
          "rnn_launches_char_lstm": rnn_launches,
          "ok": not any(launches.values())})
    if any(launches.values()):
        failed.append("kernel launches on the rnn path %s" % launches)
    if failed:
        raise RuntimeError("rnn phase failed: %s" % "; ".join(failed))
    return launches


# ---------------------------------------------------------------------------
# phase 14: the rest of the training API (SequentialModule, Custom ops,
# autograd, kvstore) and its example twins
# ---------------------------------------------------------------------------
API_TWINS = ("mnist_mlp", "custom_softmax", "sto_depth", "fgsm",
             "gan_mnist", "sgld", "autoencoder", "multitask")
API_TWIN_ARGS = ["--gpus", "0"]
API_DEVICE = "cuda"
API_STEPS = 3
API_BATCH, API_IMAGE, API_CLASSES = 128, (3, 28, 28), 10  # the CIFAR twin's
API_NETWORK = "resnet-20"
API_BN_PER_STEP = 20
API_REL_L2 = 1e-6
API_CUSTOM_TOL = 1e-5      # custom vs builtin gradients, of their max-abs
API_AUTOGRAD_TOL = 1e-5
API_TIME_STEPS = 20
API_KV_SHAPE = (1024, 1024)


def api_ctx(mx):
    return mx.cpu() if API_DEVICE == "cpu" else mx.gpu(0)


def api_sync():
    import torch
    if API_DEVICE != "cpu":
        torch.cuda.synchronize()


def api_counts(K, C, R):
    return {"bn_fwd": K.bn_fwd.launches, "bn_bwd": K.bn_bwd.launches,
            "copy": C.copy.launches, "rtc": R.rtc_kernel.launches}


def api_zero(K, C, R):
    for counter in (K.bn_fwd, K.bn_bwd, C.copy, R.rtc_kernel):
        counter.launches = 0


def api_twins(card):
    """(a) Each twin at its script's defaults, in process; it raises when
    one of its own asserts fails."""
    import importlib
    rows = []
    for name in API_TWINS:
        twin = importlib.import_module("mxnet_tpu_torch.examples." + name)
        t0 = time.time()
        res = twin.main(API_TWIN_ARGS)
        row = {"phase": "api_twin", "twin": name, "args": API_TWIN_ARGS,
               "seconds": time.time() - t0,
               "ms_per_step": res["ms_per_step"], "steps": res["steps"],
               "card": card}
        for key in ("accuracy", "accuracy_builtin", "ms_per_step_builtin",
                    "adversarial_accuracy", "rebind", "mean_err",
                    "var_ratio", "mse", "best_d_fake", "best_dist",
                    "resumed_accuracy", "sequential_accuracy"):
            if key in res:
                row[key] = res[key]
        emit(row)
        rows.append(row)
        del res
    return rows


def api_batches(mx, n, seed=0):
    """``n`` host batches at the CIFAR twin's shapes (numpy, seeded)."""
    import numpy as np
    rs = np.random.RandomState(seed)
    return [mx.io.DataBatch(
        [mx.nd.array(rs.randn(API_BATCH, *API_IMAGE).astype(np.float32),
                     ctx=mx.cpu())],
        [mx.nd.array(rs.randint(0, API_CLASSES, API_BATCH)
                     .astype(np.float32), ctx=mx.cpu())]) for _ in range(n)]


def api_resnet(mx):
    return mx.models.get_symbol(API_NETWORK, num_classes=API_CLASSES,
                                image_shape=API_IMAGE)


def api_start_params(mx):
    """Xavier parameters of resnet-20 from ``mx.random``'s seed 0, on the
    host."""
    mx.random.seed(0)
    mod = mx.mod.Module(api_resnet(mx), context=api_ctx(mx),
                        _allow_fused=False)
    mod.bind(data_shapes=[("data", (API_BATCH,) + API_IMAGE)],
             label_shapes=[("softmax_label", (API_BATCH,))],
             for_training=False)
    mod.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2))
    args, aux = mod.get_params()
    return ({k: v.copy() for k, v in args.items()},
            {k: v.copy() for k, v in aux.items()})


def api_sgd():
    return dict(SGD_PARAMS, rescale_grad=1.0 / API_BATCH)


def api_params_ptr(mod):
    ex = mod._exec_group.execs[0]
    return [ex.arg_dict[n]._read().data_ptr() for n in mod._param_names]


def api_timed_steps(mod, batches, steps):
    """ms a step over ``steps`` steps (after the first), host clock
    around work that ends in a synchronise."""
    ms = []
    for i in range(steps):
        api_sync()
        t0 = time.perf_counter()
        mod.forward_backward(batches[i % len(batches)])
        mod.update()
        api_sync()
        ms.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(ms[1:])


def api_sequential(mx, K, C, R, card, start):
    """(b) resnet-20 as a SequentialModule of its features (cut at the
    Flatten) and its head, against one classic Module of the whole net:
    3 SGD steps from the same parameters, cuDNN deterministic. Returns
    (failed, the kernels' launches over the chain's 3 steps)."""
    import numpy as np
    ctx = api_ctx(mx)
    batches = api_batches(mx, API_STEPS)
    shapes = ([("data", (API_BATCH,) + API_IMAGE)],
              [("softmax_label", (API_BATCH,))])
    args, aux = start
    internals = api_resnet(mx).get_internals()
    feat = internals[next(n for n in internals.list_outputs()
                          if n.startswith("flatten"))]
    head = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.Variable("data"), num_hidden=API_CLASSES, name="fc1"),
        name="softmax")
    with deterministic_cudnn():
        seq = mx.mod.SequentialModule()
        seq.add(mx.mod.Module(feat, label_names=(), context=ctx))
        seq.add(mx.mod.Module(head, context=ctx), take_labels=True,
                auto_wiring=True)
        seq.bind(data_shapes=shapes[0], label_shapes=shapes[1])
        seq.init_params(arg_params=args, aux_params=aux)
        seq.init_optimizer(optimizer="sgd", optimizer_params=api_sgd())
        ptrs = [api_params_ptr(m) for m in seq._modules]
        routes = [type(m._exec_group).__name__ for m in seq._modules]
        api_sync()
        api_zero(K, C, R)
        for b in batches:
            seq.forward_backward(b)
            seq.update()
        api_sync()
        launches = api_counts(K, C, R)
        same_ptrs = [api_params_ptr(m) for m in seq._modules] == ptrs
        got = host_params(seq._modules[0])
        got.update(host_params(seq._modules[1]))
        whole = mx.mod.Module(api_resnet(mx), context=ctx,
                              _allow_fused=False)
        whole.bind(data_shapes=shapes[0], label_shapes=shapes[1])
        whole.init_params(arg_params=args, aux_params=aux)
        whole.init_optimizer(optimizer="sgd", optimizer_params=api_sgd())
        for b in batches:
            whole.forward_backward(b)
            whole.update()
        want = host_params(whole)
        seq_ms = api_timed_steps(seq, batches, API_TIME_STEPS)
        whole_ms = api_timed_steps(whole, batches, API_TIME_STEPS)
    differ = [k for k in want if not np.array_equal(got[k], want[k])]
    worst = max([rel_l2(got[k], want[k]) for k in differ] or [0.0])
    per_step = API_BN_PER_STEP * API_STEPS
    row = {"phase": "api_sequential", "network": API_NETWORK,
           "batch": API_BATCH, "image": list(API_IMAGE),
           "steps": API_STEPS, "routes": routes,
           "params": len(want), "bitwise_equal": not differ,
           "n_params_differing": len(differ), "worst_rel_l2": worst,
           "limit_rel_l2": API_REL_L2, "launches": launches,
           "bn_launches_per_step": {k: launches[k] / API_STEPS
                                    for k in ("bn_fwd", "bn_bwd")},
           "params_data_ptr_kept": same_ptrs,
           "ms_per_step": seq_ms, "ms_per_step_one_module": whole_ms,
           "finite": all(np.isfinite(v).all() for v in got.values()),
           "card": card}
    row["ok"] = (row["finite"] and worst <= API_REL_L2 and same_ptrs and
                 sorted(got) == sorted(want) and
                 launches == {"bn_fwd": per_step, "bn_bwd": per_step,
                              "copy": 0, "rtc": 0})
    emit(row)
    del seq, whole
    return ([] if row["ok"] else ["sequential"]), launches


def api_custom(mx, card):
    """(c) The custom_softmax net on the card: its gradients against the
    builtin SoftmaxOutput net's, the fused route against the classic one
    and remat="full" against none (3 steps each, bit for bit), and the
    step ms of both nets."""
    import numpy as np
    from mxnet_tpu_torch.examples import custom_softmax
    ctx = api_ctx(mx)
    X, y = custom_softmax.make_data()
    b = 128
    batches = [mx.io.DataBatch(
        [mx.nd.array(X[i * b:(i + 1) * b], ctx=mx.cpu())],
        [mx.nd.array(y[i * b:(i + 1) * b].astype(np.float32),
                     ctx=mx.cpu())]) for i in range(API_STEPS)]
    shapes = ([("data", (b, X.shape[1]))], [("softmax_label", (b,))])

    def module(custom, **kw):
        mx.random.seed(0)
        mod = mx.mod.Module(custom_softmax.make_net(custom), context=ctx,
                            **kw)
        mod.bind(data_shapes=shapes[0], label_shapes=shapes[1])
        mod.init_params(mx.init.Xavier())
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.5})
        return mod

    grads = {}
    for custom in (True, False):
        mod = module(custom, _allow_fused=False)
        mod.forward_backward(batches[0])
        ex = mod._exec_group.execs[0]
        grads[custom] = {n: ex.grad_dict[n].asnumpy()
                         for n in mod._param_names}
    scale = max(float(np.abs(g).max()) for g in grads[False].values())
    grad_err = max(float(np.abs(grads[True][n] - grads[False][n]).max())
                   for n in grads[False])
    runs = {}
    for name, kw in (("fused", {}), ("classic", {"_allow_fused": False}),
                     ("remat", {"remat": "full"})):
        mod = module(True, **kw)
        for bt in batches:
            mod.forward_backward(bt)
            mod.update()
        runs[name] = (type(mod._exec_group).__name__, host_params(mod))
    same = {name: all(np.array_equal(runs[name][1][k], runs["fused"][1][k])
                      for k in runs["fused"][1])
            for name in ("classic", "remat")}
    ms = {}
    for custom in (True, False):
        ms["custom" if custom else "builtin"] = api_timed_steps(
            module(custom), batches, API_TIME_STEPS)
    row = {"phase": "api_custom_op", "batch": b,
           "grad_max_abs_err": grad_err, "grad_max_abs": scale,
           "grad_rel_err": grad_err / max(scale, 1e-30),
           "limit": API_CUSTOM_TOL,
           "routes": {k: v[0] for k, v in runs.items()},
           "fused_eq_classic_bitwise": same["classic"],
           "remat_eq_plain_bitwise": same["remat"],
           "ms_per_step_custom": ms["custom"],
           "ms_per_step_builtin": ms["builtin"],
           "host_round_trip_ms": ms["custom"] - ms["builtin"],
           "card": card}
    row["ok"] = (row["grad_rel_err"] <= API_CUSTOM_TOL and
                 same["classic"] and same["remat"] and
                 runs["fused"][0] == "MeshExecutorGroup")
    emit(row)
    return [] if row["ok"] else ["custom op"]


def api_autograd(mx, card):
    """(d) An imperative 2-layer MLP's gradients from mark_variables +
    backward against Module.backward's on the same parameters, and
    Dropout under train_section and test_section."""
    import numpy as np
    from mxnet_tpu_torch import autograd as ag
    ctx = api_ctx(mx)
    rs = np.random.RandomState(3)
    n, d, h, k = 64, 32, 48, 10
    x = rs.randn(n, d).astype(np.float32)
    lab = rs.randint(0, k, n).astype(np.float32)
    vals = {"fc1_weight": rs.randn(h, d) * 0.2, "fc1_bias": rs.randn(h),
            "fc2_weight": rs.randn(k, h) * 0.2, "fc2_bias": rs.randn(k)}
    vals = {nm: v.astype(np.float32) for nm, v in vals.items()}
    params = {nm: mx.nd.array(v, ctx=ctx) for nm, v in vals.items()}
    grads = {nm: mx.nd.zeros(v.shape, ctx=ctx) for nm, v in vals.items()}
    names = sorted(vals)
    ag.mark_variables([params[nm] for nm in names],
                      [grads[nm] for nm in names])
    xd, ld = mx.nd.array(x, ctx=ctx), mx.nd.array(lab, ctx=ctx)
    with ag.train_section():
        a = mx.nd.Activation(mx.nd.FullyConnected(
            xd, params["fc1_weight"], params["fc1_bias"], num_hidden=h),
            act_type="relu")
        o = mx.nd.FullyConnected(a, params["fc2_weight"],
                                 params["fc2_bias"], num_hidden=k)
        out = mx.nd.SoftmaxOutput(o, ld)
    ag.compute_gradient([out])
    mine = {nm: g.asnumpy() for nm, g in grads.items()}
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(mx.sym.Activation(
        mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=h,
                              name="fc1"), act_type="relu"),
        num_hidden=k, name="fc2"), name="softmax")
    mod = mx.mod.Module(net, context=ctx, _allow_fused=False)
    mod.bind(data_shapes=[("data", (n, d))],
             label_shapes=[("softmax_label", (n,))])
    mod.init_params(arg_params={nm: mx.nd.array(v, ctx=mx.cpu())
                                for nm, v in vals.items()})
    mod.forward_backward(mx.io.DataBatch([xd], [ld]))
    ex = mod._exec_group.execs[0]
    err = max(float(np.abs(mine[nm] - ex.grad_dict[nm].asnumpy()).max())
              for nm in names)
    ones = mx.nd.ones((256, 256), ctx=ctx)
    with ag.train_section():
        dropped = float((mx.nd.Dropout(ones, p=0.5).asnumpy() == 0).mean())
    with ag.test_section():
        kept = bool(np.array_equal(mx.nd.Dropout(ones, p=0.5).asnumpy(),
                                   ones.asnumpy()))
    row = {"phase": "api_autograd", "grad_max_abs_err": err,
           "limit": API_AUTOGRAD_TOL, "dropout_train_zero_share": dropped,
           "dropout_test_identity": kept, "card": card}
    row["ok"] = err <= API_AUTOGRAD_TOL and 0.4 < dropped < 0.6 and kept
    emit(row)
    return [] if row["ok"] else ["autograd"]


def api_kvstore_sum(mx, card):
    """(e) push of four card arrays and pull: their sum in list order,
    twice, bit for bit."""
    import numpy as np
    import torch
    ctx = api_ctx(mx)
    gen = torch.Generator(device=API_DEVICE).manual_seed(5)
    vals = [torch.randn(API_KV_SHAPE, generator=gen, device=API_DEVICE)
            for _ in range(4)]
    want = (((vals[0] + vals[1]) + vals[2]) + vals[3]).cpu().numpy()
    runs = []
    for _ in range(2):
        kv = mx.kv.create("local")
        kv.init(0, mx.nd.zeros(API_KV_SHAPE, ctx=ctx))
        kv.push(0, [mx.nd.NDArray(v.clone(), ctx=ctx) for v in vals])
        out = mx.nd.zeros(API_KV_SHAPE, ctx=ctx)
        kv.pull(0, out=out)
        runs.append(out.asnumpy())
    row = {"phase": "api_kvstore_sum", "shape": list(API_KV_SHAPE),
           "arrays": 4, "equals_ordered_sum": bool(np.array_equal(
               runs[0], want)),
           "repeats_bitwise": runs[0].tobytes() == runs[1].tobytes(),
           "card": card}
    row["ok"] = row["equals_ordered_sum"] and row["repeats_bitwise"]
    emit(row)
    return [] if row["ok"] else ["kvstore sum"]


def api_kvstore_fit(mx, K, card, start):
    """(e) fit with a KVStore instance (the update on the store: push,
    pull) against fit(kvstore="local") (no store: the fused step), 3
    resnet-20 steps from the same parameters; the BN kernels launch
    20 + 20 a step in both."""
    import numpy as np
    ctx = api_ctx(mx)
    batches = api_batches(mx, API_STEPS, seed=1)
    X = np.concatenate([b.data[0].asnumpy() for b in batches])
    y = np.concatenate([b.label[0].asnumpy() for b in batches])
    args, aux = start
    res = {}
    with deterministic_cudnn():
        for name, kv in (("local", "local"),
                         ("kvstore", mx.kv.create("local"))):
            it = mx.io.NDArrayIter(X, y, batch_size=API_BATCH)
            mod = mx.mod.Module(api_resnet(mx), context=ctx)
            K.bn_fwd.launches = K.bn_bwd.launches = 0
            mod.fit(it, num_epoch=1, kvstore=kv, optimizer="sgd",
                    optimizer_params=api_sgd(), arg_params=args,
                    aux_params=aux)
            api_sync()
            res[name] = (host_params(mod), mod._update_on_kvstore,
                         {"bn_fwd": K.bn_fwd.launches,
                          "bn_bwd": K.bn_bwd.launches})
            del mod
    (lp, lkv, ll), (kp, kkv, kl) = res["local"], res["kvstore"]
    worst = max(rel_l2(kp[k], lp[k]) for k in lp)
    want = {"bn_fwd": API_BN_PER_STEP * API_STEPS,
            "bn_bwd": API_BN_PER_STEP * API_STEPS}
    row = {"phase": "api_kvstore_fit", "network": API_NETWORK,
           "steps": API_STEPS, "update_on_kvstore": [lkv, kkv],
           "bitwise_equal": all(np.array_equal(kp[k], lp[k]) for k in lp),
           "worst_rel_l2": worst, "limit_rel_l2": API_REL_L2,
           "bn_launches": {"local": ll, "kvstore": kl}, "card": card}
    row["ok"] = (worst <= API_REL_L2 and not lkv and kkv and
                 ll == want and kl == want)
    emit(row)
    return [] if row["ok"] else ["kvstore fit"]


def api_phase(mx, K, C, R, card):
    """Phase 14 (module docstring). Returns the kernels' launches over the
    SequentialModule's steps (b), the phase's main path; every counter
    reads 0 over (a), (c), (d) and the store's push and pull (e)."""
    api_zero(K, C, R)
    twins = api_twins(card)
    off_path = api_counts(K, C, R)
    start = api_start_params(mx)
    failed, launches = api_sequential(mx, K, C, R, card, start)
    api_zero(K, C, R)
    failed += api_custom(mx, card)
    failed += api_autograd(mx, card)
    failed += api_kvstore_sum(mx, card)
    off_path = {k: v + off_path[k] for k, v in api_counts(K, C, R).items()}
    failed += api_kvstore_fit(mx, K, card, start)
    emit({"phase": "api_kernels", "launches_sequential": launches,
          "launches_twins_custom_autograd_kvstore": off_path,
          "twins_seconds": sum(r["seconds"] for r in twins),
          "ok": not any(off_path.values())})
    if any(off_path.values()):
        failed.append("kernel launches off the BN path %s" % off_path)
    if failed:
        raise RuntimeError("api phase failed: %s" % "; ".join(failed))
    return launches


# ---------------------------------------------------------------------------
# phase 15: the quantized precision modes
# ---------------------------------------------------------------------------
QUANT_BATCHES = (1, 3, 32)          # 1 and 3 pad their rows up to 17
# (name, per-image input shape, weight shape, stride, pad, dilate, groups):
# ResNet-50's stem, a 3x3, a 1x1 and a strided 1x1 projection, and
# resnext-50's grouped 3x3 (32 groups)
QUANT_CONVS = [
    ("conv7x7_s2", (3, 224, 224), (64, 3, 7, 7), (2, 2), (3, 3), (1, 1), 1),
    ("conv3x3", (64, 56, 56), (64, 64, 3, 3), (1, 1), (1, 1), (1, 1), 1),
    ("conv1x1", (256, 56, 56), (64, 256, 1, 1), (1, 1), (0, 0), (1, 1), 1),
    ("conv1x1_s2", (512, 28, 28), (1024, 512, 1, 1), (2, 2), (0, 0),
     (1, 1), 1),
    ("conv3x3_g32", (128, 56, 56), (128, 4, 3, 3), (1, 1), (1, 1), (1, 1),
     32),
]
QUANT_FC = (2048, 1000)             # ResNet-50's fc1
# fp8 dot on the card against the CPU's float32 sum of the same e4m3
# products, of the plain output's max-abs: the products are exact, and
# cuBLAS accumulates fp8 MMAs at reduced precision before promoting its
# partial sums to float32 (stated before the first run)
QUANT_FP8_DOT_TOL = 1e-3
# the library GEMMs' shapes (M, K, N) at batch 32: fc1 and the im2col
# products of the convolutions above
QUANT_GEMM_SHAPES = [("fc1", 32, 2048, 1000),
                     ("conv7x7_s2", 32 * 112 * 112, 147, 64),
                     ("conv3x3", 32 * 56 * 56, 576, 64),
                     ("conv1x1", 32 * 56 * 56, 256, 64),
                     ("conv1x1_s2", 32 * 14 * 14, 512, 1024)]
QUANT_PEAK = {"int8": 1979e12, "fp8": 1979e12, "bf16": 989e12,
              "f32": F32_FLOPS_PER_S}
QUANT_SERVE_MAX_BATCH = 32
QUANT_BN_WARM = 48
QUANT_CALIB_BATCHES = 8
QUANT_SERVE_MODES = ("f32", "bf16", "int8_serve", "fp8_native")
# an fp8 site's error, of its float32 output's max-abs: one e4m3 step,
# 2^-3 (each operand rounds by up to half a step, 2^-4 of its value, so
# a product by up to 2^-3 of its own); stated before the first run on
# the card (the CPU rehearsal at batch 4: 0.056 at the worst site)
QUANT_FP8_SITE_TOL = 2.0 ** -3
QUANT_DECODE_MODES = ("int8_weight", "bf16")
QUANT_DECODE_AGREE = 0.8
QUANT_TRAIN_MODES = ("int8_act", "fp8")
QUANT_STEPS = 3


def quant_plain_conv(qx, qw, stride, pad, dilate, groups):
    """The plain int8 convolution on the CPU: float64 over int8 values,
    exact (every partial sum an integer far below 2^53), as int32."""
    import torch
    import torch.nn.functional as F
    conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[qx.dim() - 2]
    return conv(qx.cpu().double(), qw.cpu().double(), None, stride=stride,
                padding=pad, dilation=dilate, groups=groups).to(torch.int32)


def quant_gemm_checks(card):
    """(a) The int8 dot and convolution on the card against their plain
    versions on the CPU, bit for bit in the int32 accumulator and in the
    rescaled output; the fp8 dot within ``QUANT_FP8_DOT_TOL``; ``to_e4m3``
    and ``fake_cast`` bit for bit. Returns the failed checks."""
    import numpy as np
    import torch
    from mxnet_tpu_torch.precision import PrecisionPolicy, fake_cast, \
        quant, to_e4m3
    dev = API_DEVICE
    gen = torch.Generator(device="cpu").manual_seed(15)
    failed, rows = [], []
    int8 = PrecisionPolicy(narrow_math="int8")
    fp8 = PrecisionPolicy(narrow_math="fp8")

    # the int8 operands as narrow_* makes them without a table: a dynamic
    # per-tensor scale for the input, a per-output-channel one for w
    def q_input(t):
        return quant._quantize(t, quant._x_scale(t, None))

    def q_weight(w):
        sw = quant._channel_scale(w)
        return quant._quantize(w, sw.reshape((-1,) + (1,) * (w.dim() - 1)))

    for b in QUANT_BATCHES:
        x = torch.randn(b, QUANT_FC[0], generator=gen).relu()
        w = torch.randn(QUANT_FC[1], QUANT_FC[0], generator=gen) * 0.02
        with quant.trace_gemm_scope(int8):
            got = quant.narrow_dot(x.to(dev), w.to(dev)).cpu()
            want = quant.narrow_dot(x, w)
        qx, qw = q_input(x.to(dev)), q_weight(w.to(dev))
        acc = quant.int8_mm(qx, qw).cpu()
        plain = (qx.cpu().double() @ qw.cpu().double().t()).to(torch.int32)
        with quant.trace_gemm_scope(fp8):
            g8 = quant.narrow_dot(x.to(dev), w.to(dev)).cpu()
            w8 = quant.narrow_dot(x, w)
        err8 = float((g8 - w8).abs().max() / w8.abs().max())
        row = {"gemm": "fc1", "batch": b, "shape": [b] + list(QUANT_FC),
               "int32_bitwise": bool(torch.equal(acc, plain)),
               "int8_out_bitwise": bool(torch.equal(got, want)),
               "int8_max_abs_err": float((got - want).abs().max()),
               "fp8_rel_err": err8, "fp8_limit": QUANT_FP8_DOT_TOL}
        row["ok"] = (row["int32_bitwise"] and row["int8_out_bitwise"]
                     and err8 <= QUANT_FP8_DOT_TOL)
        rows.append(row)
    for name, shape, wshape, stride, pad, dilate, groups in QUANT_CONVS:
        for b in QUANT_BATCHES:
            x = torch.randn((b,) + shape, generator=gen).relu()
            w = torch.randn(wshape, generator=gen) * 0.05
            args = dict(stride=stride, padding=pad, dilation=dilate,
                        groups=groups)
            with quant.trace_gemm_scope(int8):
                got = quant.narrow_conv(x.to(dev), w.to(dev), args).cpu()
                want = quant.narrow_conv(x, w, args)
            qx, qw = q_input(x.to(dev)), q_weight(w.to(dev))
            acc = quant.int8_conv(qx, qw, stride, pad, dilate, groups).cpu()
            plain = quant_plain_conv(qx, qw, stride, pad, dilate, groups)
            row = {"gemm": name, "batch": b, "x": [b] + list(shape),
                   "w": list(wshape), "groups": groups,
                   "int32_bitwise": bool(torch.equal(acc, plain)),
                   "int8_out_bitwise": bool(torch.equal(got, want)),
                   "int8_max_abs_err": float((got - want).abs().max())}
            row["ok"] = row["int32_bitwise"] and row["int8_out_bitwise"]
            rows.append(row)
            del x, w, qx, qw, acc, plain, got, want
    bad = [r for r in rows if not r["ok"]]
    emit({"phase": "quant_gemms", "cases": len(rows), "rows": rows,
          "ok": not bad, "card": card})
    if bad:
        failed.append("int8/fp8 GEMMs vs plain at %s"
                      % [(r["gemm"], r["batch"]) for r in bad])
    # the casts, on inputs crossing +-464 (NaN above, as ml_dtypes does)
    x = (torch.randn(256, 1024, generator=gen) * 300.0)
    x.view(-1)[:10] = torch.tensor([448, 449, 464, 464.5, 500, 1e4, -1e4,
                                    float("inf"), float("nan"), -465.0])
    cast_ok = {}
    for what, fn in (("to_e4m3", lambda v: to_e4m3(v).float()),
                     ("fake_cast_int8", lambda v: fake_cast(v, "int8")),
                     ("fake_cast_fp8", lambda v: fake_cast(v, "fp8")),
                     ("fake_cast_fp8_bf16",
                      lambda v: fake_cast(v.bfloat16(), "fp8").float())):
        a, c = fn(x.to(dev)).cpu().numpy(), fn(x).numpy()
        na, nc = np.isnan(a), np.isnan(c)
        cast_ok[what] = bool((na == nc).all() and np.array_equal(
            a[~na].view(np.uint32), c[~nc].view(np.uint32)))
    emit({"phase": "quant_casts", "bitwise": cast_ok,
          "nan_count": int(np.isnan(to_e4m3(x).float().numpy()).sum()),
          "ok": all(cast_ok.values()), "card": card})
    if not all(cast_ok.values()):
        failed.append("casts %s" % cast_ok)
    return failed


def quant_gemm_times(card):
    """The library GEMMs the slice calls, at fc1's and the im2col shapes
    at batch 32: ``torch._int_mm`` (int8), ``torch._scaled_mm`` (e4m3,
    float32 out), ``F.linear`` in float32 (TF32 off) and bfloat16, each
    by CUDA events (median of 20), beside the least time at the card's
    peak rate for its type and the bytes' time at ``HBM_BYTES_PER_S``."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.tools import bn_probe
    dev = API_DEVICE
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for name, M, K, N in QUANT_GEMM_SHAPES:
        Kp, Np, Mp = -(-K // 16) * 16, -(-N // 16) * 16, max(M, 17)
        a = torch.randint(-127, 128, (Mp, Kp), generator=gen, device=dev,
                          dtype=torch.int8)
        b = torch.randint(-127, 128, (Np, Kp), generator=gen, device=dev,
                          dtype=torch.int8)
        af = torch.randn(M, K, generator=gen, device=dev)
        bf = torch.randn(N, K, generator=gen, device=dev)
        a8 = af.to(torch.float8_e4m3fn)
        b8 = bf.to(torch.float8_e4m3fn)
        a8p = torch.zeros(-(-M // 16) * 16, Kp, device=dev).to(
            torch.float8_e4m3fn)
        a8p[:M, :K] = a8
        b8p = torch.zeros(Np, Kp, device=dev).to(torch.float8_e4m3fn)
        b8p[:N, :K] = b8
        one = torch.ones((), device=dev)
        ah, bh = af.bfloat16(), bf.bfloat16()
        calls = {
            "int8": (lambda: torch._int_mm(a, b.t()), 1, 4),
            "fp8": (lambda: torch._scaled_mm(
                a8p, b8p.t(), scale_a=one, scale_b=one,
                out_dtype=torch.float32, use_fast_accum=False), 1, 4),
            "bf16": (lambda: F.linear(ah, bh), 2, 2),
            "f32": (lambda: F.linear(af, bf), 4, 4)}
        row = {"gemm": name, "M": M, "K": K, "N": N}
        for kind, (fn, in_b, out_b) in calls.items():
            ms = bn_probe.cuda_time(fn, reps=20, warm=3)
            ops_ms = 1e3 * 2.0 * M * N * K / QUANT_PEAK[kind]
            bytes_ms = 1e3 * ((M * K + N * K) * in_b + M * N * out_b) \
                / HBM_BYTES_PER_S
            row[kind] = {"ms": ms, "bound_ms": max(ops_ms, bytes_ms),
                         "bound_by": "operations" if ops_ms >= bytes_ms
                         else "bytes",
                         "tops": 2.0 * M * N * K / (ms * 1e9)}
        rows.append(row)
        del a, b, af, bf, a8, b8, a8p, b8p, ah, bh
    emit({"phase": "quant_gemm_times", "rows": rows,
          "peak_tops": {k: v / 1e12 for k, v in QUANT_PEAK.items()},
          "card": card})
    return rows


def quant_resnet_params(mx):
    """ResNet-50 (224², 1000 classes) as a served net would hold it:
    Xavier weights from ``mx.random``'s seed 0, and BatchNorm moving
    statistics taken from data by ``QUANT_BN_WARM`` training-mode
    forwards of one synthetic batch (momentum 0.9: within 1% of that
    batch's statistics), so that the eval forward normalises as a trained
    net's does. With the initial statistics (mean 0, variance 1) the
    residual sums grow block by block, the softmax saturates to one-hot
    rows, and unscaled e4m3 casts overflow to NaN. Host copies."""
    import numpy as np
    mx.random.seed(0)
    mod = quant_serve_module(mx, None)
    mod.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2))
    x = np.random.RandomState(14).randn(QUANT_SERVE_MAX_BATCH, *IMAGE)
    batch = mx.io.DataBatch([mx.nd.array(x.astype(np.float32),
                                         ctx=api_ctx(mx))], None)
    for _ in range(QUANT_BN_WARM):
        mod.forward(batch, is_train=True)
        mod.get_outputs()[0].asnumpy()
    # a forward marks nothing dirty (only update() does, as in MXNet)
    mod._params_dirty = True
    args, aux = mod.get_params()
    return ({k: v.copy() for k, v in args.items()},
            {k: v.copy() for k, v in aux.items()})


def quant_serve_module(mx, precision, params=None):
    sym = mx.models.get_symbol("resnet-50", num_classes=1000,
                               image_shape=IMAGE)
    mod = mx.mod.Module(sym, context=api_ctx(mx), precision=precision)
    mod.bind(data_shapes=[("data", (QUANT_SERVE_MAX_BATCH,) + IMAGE)],
             label_shapes=[("softmax_label", (QUANT_SERVE_MAX_BATCH,))],
             for_training=False)
    if params is not None:
        mod.init_params(arg_params=params[0], aux_params=params[1])
    return mod


def quant_sites(mod):
    """The model's GEMM sites: (FullyConnected nodes, Convolution nodes,
    Convolution products: one per group)."""
    fc = conv = products = 0
    for n in mod._exec_group.symbol._topo():
        if n.op is None:
            continue
        if n.op.name == "FullyConnected":
            fc += 1
        elif n.op.name in ("Convolution", "Convolution_v1"):
            conv += 1
            products += int(n.attrs.get("num_group", 1))
    return fc, conv, products


def quant_bucket_times(mx, pred, b, x):
    """One bucket: the bound module's eval forward (the request already
    on the card) by CUDA events, median of 10 after 3 warm, and
    ``Predictor.predict`` on ``b`` rows by the host clock (median of 5)."""
    from mxnet_tpu_torch.tools import bn_probe
    m = pred._modules[b]
    batch = mx.io.DataBatch([mx.nd.array(x[:b], ctx=api_ctx(mx))], None)
    event_ms = bn_probe.cuda_time(lambda: m.forward(batch, is_train=False),
                                  reps=10, warm=3)
    calls = []
    for _ in range(6):
        t0 = time.perf_counter()
        pred.predict(x[:b])
        calls.append(1e3 * (time.perf_counter() - t0))
    call_ms = statistics.median(calls[1:])
    return {"bucket": b, "forward_event_ms": event_ms, "call_ms": call_ms,
            "rows_per_s": b / (call_ms / 1e3)}


def quant_site_errors(mx, top, x):
    """Each GEMM site's own error in one served eval forward of ``top``:
    at every FullyConnected and Convolution site, the narrow product
    against the float32 product of the same inputs, as max |narrow -
    wide| over max |wide| (``tolerance_check``'s measure). The forward
    continues on the narrow outputs, as served."""
    import torch.nn.functional as F
    from mxnet_tpu_torch.precision import quant
    errs = []
    dot, conv = quant.narrow_dot, quant.narrow_conv
    convs = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}

    def err(y, ref):
        return float((y.float() - ref).abs().max() / ref.abs().max())

    def wrap_dot(x2, w):
        y = dot(x2, w)
        if y is not None:
            errs.append(err(y, F.linear(x2.float(), w.float())))
        return y

    def wrap_conv(xc, w, args):
        y = conv(xc, w, args)
        if y is not None:
            errs.append(err(y, convs[xc.dim() - 2](xc.float(), w.float(),
                                                   None, **args)))
        return y

    quant.narrow_dot, quant.narrow_conv = wrap_dot, wrap_conv
    try:
        top.forward(mx.io.DataBatch([mx.nd.array(x, ctx=api_ctx(mx))],
                                    None), is_train=False)
        top.get_outputs()[0].asnumpy()
    finally:
        quant.narrow_dot, quant.narrow_conv = dot, conv
    return errs


def quant_sensitivity(pred, x, ref):
    """The f32 net's own response to noise: the rows' max relative
    distance (``tolerance_check``'s measure) when every input element is
    scaled by (1 + 2^-8 n), n standard normal: bfloat16's rounding of
    the input alone."""
    import numpy as np
    from mxnet_tpu_torch.precision import quant
    noise = np.random.RandomState(16).randn(*x.shape).astype(np.float32)
    got = np.asarray(pred.predict(x * (1.0 + 2.0 ** -8 * noise)))
    return quant.tolerance_check(ref, got, tol=float("inf"))["max_rel_err"]


def quant_serving(mx, card, params):
    """(b) ResNet-50 served at full width under f32, bf16, int8_serve
    (calibrated on ``QUANT_CALIB_BATCHES`` synthetic batches, through
    ``Predictor(calibration=)``) and fp8_native: the library GEMM calls
    of one eval forward equal to the model's sites; every site's error
    within its tolerance (``quant_site_errors``); the rows' distance from
    f32 beside bf16's and the f32 net's own sensitivity; per-bucket
    times. Returns the failed checks."""
    import numpy as np
    from mxnet_tpu_torch.precision import quant
    from mxnet_tpu_torch.serving import Predictor
    failed = []
    rs = np.random.RandomState(15)
    x = rs.randn(QUANT_SERVE_MAX_BATCH, *IMAGE).astype(np.float32)
    calib = rs.randn(QUANT_CALIB_BATCHES * QUANT_SERVE_MAX_BATCH,
                     *IMAGE).astype(np.float32)
    t0 = time.time()
    table = quant.calibrate(quant_serve_module(mx, None, params),
                            mx.io.NDArrayIter(calib, None,
                                              batch_size=QUANT_SERVE_MAX_BATCH),
                            num_batches=QUANT_CALIB_BATCHES)
    calib_s = time.time() - t0
    out = {}
    site_tol = {"int8_serve": quant.quant_tolerance(),
                "fp8_native": QUANT_FP8_SITE_TOL}
    for mode in QUANT_SERVE_MODES:
        mod = quant_serve_module(mx, None if mode == "f32" else mode, params)
        pred = Predictor(mod, max_batch_size=QUANT_SERVE_MAX_BATCH,
                         calibration=table if mode == "int8_serve" else None)
        pred.warmup()
        out[mode] = np.asarray(pred.predict(x))
        top = pred._modules[QUANT_SERVE_MAX_BATCH]
        fc, conv, products = quant_sites(top)
        api_sync()
        before = dict(quant.GEMM_CALLS)
        top.forward(mx.io.DataBatch([mx.nd.array(x, ctx=api_ctx(mx))],
                                    None), is_train=False)
        api_sync()
        calls = {k: quant.GEMM_CALLS[k] - before[k] for k in before}
        want = {"f32": {"int_mm": 0, "scaled_mm": 0},
                "bf16": {"int_mm": 0, "scaled_mm": 0},
                "int8_serve": {"int_mm": fc + products, "scaled_mm": 0},
                "fp8_native": {"int_mm": 0, "scaled_mm": fc}}[mode]
        if API_DEVICE == "cpu":
            want = {"int_mm": 0, "scaled_mm": 0}
        row = {"mode": mode, "sites": {"fc": fc, "conv": conv,
                                       "conv_products": products},
               "gemm_calls_per_forward": calls, "want_calls": want,
               "finite": bool(np.isfinite(out[mode]).all()),
               "buckets": [quant_bucket_times(mx, pred, b, x)
                           for b in pred.buckets]}
        ok = row["finite"] and calls == want
        if mode == "f32":
            row["f32_rows_under_2^-8_input_noise_max_rel_err"] = \
                quant_sensitivity(pred, x, out["f32"])
        else:
            rep = quant.tolerance_check(out["f32"], out[mode],
                                        tol=float("inf"))
            row["max_rel_err_vs_f32"] = rep["max_rel_err"]
            row["argmax_agree_vs_f32"] = float(np.mean(
                out[mode].argmax(1) == out["f32"].argmax(1)))
        if mode in site_tol:
            errs = quant_site_errors(mx, top, x)
            row["site_errors"] = {"n": len(errs), "max": max(errs),
                                  "median": statistics.median(errs),
                                  "worst_site_index": errs.index(max(errs)),
                                  "tolerance": site_tol[mode]}
            ok = ok and len(errs) == fc + conv and \
                max(errs) <= site_tol[mode]
        if mode == "int8_serve":
            row["calibration"] = {"sites": len(table.ranges),
                                  "digest": table.digest(),
                                  "seconds": calib_s,
                                  "described": top._precision.describe()[
                                      "calibration_digest"]}
            ok = ok and row["calibration"]["described"] == table.digest()
        row["ok"] = ok
        emit({"phase": "quant_serve", "model": "resnet-50",
              "image": list(IMAGE), "classes": 1000, **row, "card": card})
        if not ok:
            failed.append("%s serving" % mode)
        del pred, mod, top
    return failed


def quant_decode_engine(cfg, model, params, ctx, precision):
    from mxnet_tpu_torch.serving.decode import DecodeEngine
    return DecodeEngine(model, params, slots=cfg["slots"],
                        max_prefill_len=cfg["max_prefill_len"],
                        precision=precision, start=False, context=ctx)


def quant_decode_streams(cfg, model, params, prompts, ctx, precision):
    """Greedy streams of ``prompts`` under one mode, all queued before the
    scheduler starts (phase 10's load): (streams, tokens/s, engine
    bytes)."""
    eng = quant_decode_engine(cfg, model, params, ctx, precision)
    eng.warmup()
    reqs = [eng.submit(p, max_new_tokens=cfg["new_tokens"], seed=i)
            for i, p in enumerate(prompts)]
    eng.start()
    streams = [r.result(timeout=600) for r in reqs]
    eng.shutdown(drain=True)
    st = eng.stats()["decode"]
    nbytes = (eng.weight_bytes(), eng.step_argument_bytes())
    parity = all(eng.prefill_parity(p) for p in prompts[:4])
    eng.release()
    return streams, st, nbytes, parity


def quant_decode(mx, card):
    """(c) Both phase-10 decode models at their widths under int8_weight
    and bf16: step argument and weight bytes against f32, first-token
    and whole-stream agreement with the f32 greedy streams, two runs bit
    for bit, tokens/s. Returns the failed checks."""
    failed = []
    ctx = api_ctx(mx)
    for name, cfg in (("lstm_char_lm", DECODE_LSTM),
                      ("transformer_lm", DECODE_TRANSFORMER)):
        model = decode_model(cfg)
        params = model.init_params(seed=cfg["seed"])
        prompts = decode_prompts(cfg)
        ref, st32, b32, _ = quant_decode_streams(cfg, model, params,
                                                 prompts, ctx, "f32")
        for mode in QUANT_DECODE_MODES:
            s1, st, nb, parity = quant_decode_streams(cfg, model, params,
                                                      prompts, ctx, mode)
            s2, _, _, _ = quant_decode_streams(cfg, model, params, prompts,
                                               ctx, mode)
            first = sum(a[0] == r[0] for a, r in zip(s1, ref)) / len(ref)
            tokens = sum(sum(x == y for x, y in zip(a, r))
                         for a, r in zip(s1, ref)) / float(
                             sum(len(r) for r in ref))
            row = {"model": name, "mode": mode,
                   "weight_quant": st["weight_quant"],
                   "weight_bytes": nb[0], "weight_bytes_f32": b32[0],
                   "step_argument_bytes": nb[1],
                   "step_argument_bytes_f32": b32[1],
                   "step_bytes_ratio": b32[1] / float(nb[1]),
                   "weight_bytes_ratio": b32[0] / float(nb[0]),
                   "first_token_agree": first, "token_agree": tokens,
                   "agree_floor": QUANT_DECODE_AGREE,
                   "repeat_bitwise": s1 == s2, "prefill_parity": parity,
                   "tokens_per_s": st["tokens_per_sec"],
                   "tokens_per_s_f32": st32["tokens_per_sec"]}
            row["ok"] = (nb[1] < b32[1] and first >= QUANT_DECODE_AGREE
                         and s1 == s2 and parity)
            emit({"phase": "quant_decode", **row, "card": card})
            if not row["ok"]:
                failed.append("%s decode under %s" % (name, mode))
    return failed


def quant_train(mx, K, card):
    """(d) resnet-20 at the CIFAR twin's shapes under int8_act and fp8:
    ``QUANT_STEPS`` SGD steps twice from the same parameters under
    deterministic cuDNN, bit for bit; the live loss scale; 20 + 20
    bfloat16 BN launches a step. Returns (failed, BN launches)."""
    import numpy as np
    ctx = api_ctx(mx)
    batches = api_batches(mx, QUANT_STEPS, seed=15)
    start = api_start_params(mx)
    shapes = ([("data", (API_BATCH,) + API_IMAGE)],
              [("softmax_label", (API_BATCH,))])
    failed, total = [], {"bn_fwd": 0, "bn_bwd": 0}
    for mode in QUANT_TRAIN_MODES:
        runs = []
        for _ in range(2):
            with deterministic_cudnn():
                mod = mx.mod.Module(api_resnet(mx), context=ctx,
                                    precision=mode)
                mod.bind(data_shapes=shapes[0], label_shapes=shapes[1])
                mod.init_params(arg_params=start[0], aux_params=start[1])
                mod.init_optimizer(optimizer="sgd",
                                   optimizer_params=api_sgd())
                api_sync()
                names = ("bn_fwd", "bn_bwd")
                n0 = {k: getattr(K, k).launches for k in names}
                h0 = {k: getattr(K, k).launches_bf16 for k in names}
                ms = []
                for bt in batches:
                    t0 = time.perf_counter()
                    mod.forward_backward(bt)
                    mod.update()
                    api_sync()
                    ms.append(1e3 * (time.perf_counter() - t0))
                launches = {k: getattr(K, k).launches - n0[k] for k in names}
                bf16 = {k: getattr(K, k).launches_bf16 - h0[k]
                        for k in names}
                for k in total:
                    total[k] += launches[k]
                grp = mod._exec_group
                runs.append((host_params(mod), launches, bf16,
                             grp.loss_scale(), grp.scale_skips(), ms,
                             mod.get_outputs()[0].asnumpy()))
                del mod, grp
        (p1, l1, h1, ls, skips, ms, out), (p2, l2, _, _, _, _, _) = runs
        want = {"bn_fwd": API_BN_PER_STEP * QUANT_STEPS,
                "bn_bwd": API_BN_PER_STEP * QUANT_STEPS}
        row = {"mode": mode, "network": API_NETWORK, "batch": API_BATCH,
               "image": list(API_IMAGE), "steps": QUANT_STEPS,
               "bitwise_repeat": all(np.array_equal(p1[k], p2[k])
                                     for k in p1),
               "loss_scale": ls, "scale_skips": skips,
               "bn_launches": l1, "bn_launches_bf16": h1,
               "bn_launches_second_run": l2, "want_launches": want,
               "ms_per_step": statistics.median(ms[1:]), "step_ms": ms,
               "finite": bool(np.isfinite(out).all()) and all(
                   np.isfinite(v).all() for v in p1.values()),
               "params_changed": not np.array_equal(
                   p1["fc1_weight"], start[0]["fc1_weight"].asnumpy())}
        row["ok"] = (row["bitwise_repeat"] and ls is not None and ls > 0
                     and skips == 0 and l1 == l2 == h1 == want
                     and row["finite"] and row["params_changed"])
        emit({"phase": "quant_train", **row, "card": card})
        if not row["ok"]:
            failed.append("%s training" % mode)
    return failed, total


def quant_phase(mx, K, C, R, card):
    """Phase 15 (module docstring). Returns the kernels' launches over the
    whole phase; the BN kernels' all come from (d)."""
    prev = os.environ.get("MXNET_PRECISION_EXPERIMENTAL")
    os.environ["MXNET_PRECISION_EXPERIMENTAL"] = "1"    # fp8 modes
    try:
        return quant_phase_runs(mx, K, C, R, card)
    finally:
        if prev is None:
            del os.environ["MXNET_PRECISION_EXPERIMENTAL"]
        else:
            os.environ["MXNET_PRECISION_EXPERIMENTAL"] = prev


def quant_phase_runs(mx, K, C, R, card):
    # the BN statistics' warm-up forwards launch bn_fwd: before the count
    params = quant_resnet_params(mx)
    api_zero(K, C, R)
    failed = quant_gemm_checks(card)
    gemm_rows = quant_gemm_times(card) if API_DEVICE != "cpu" else []
    failed += quant_serving(mx, card, params)
    del params
    failed += quant_decode(mx, card)
    off_path = api_counts(K, C, R)
    f, train_bn = quant_train(mx, K, card)
    failed += f
    launches = api_counts(K, C, R)
    want = {"bn_fwd": train_bn["bn_fwd"], "bn_bwd": train_bn["bn_bwd"],
            "copy": 0, "rtc": 0}
    emit({"phase": "quant_kernels", "launches": launches,
          "launches_gemms_serving_decode": off_path,
          "gemm_rows": len(gemm_rows),
          "ok": not any(off_path.values()) and launches == want})
    if any(off_path.values()) or launches != want:
        failed.append("kernel launches %s (off the training path %s)"
                      % (launches, off_path))
    if failed:
        raise RuntimeError("quant phase failed: %s" % "; ".join(failed))
    return launches


# ---------------------------------------------------------------------------
# phase 16: the vision and detection operators
# ---------------------------------------------------------------------------
# SSD300 (Liu et al., VOC) at MXNet's SSD symbol's sizes and ratios: six
# maps, 4/6/6/6/4/4 anchors a cell, 8,732 in all
SSD_MAPS = [(38, (0.1, 0.141), (1, 2, 0.5)),
            (19, (0.2, 0.272), (1, 2, 0.5, 3, 1 / 3.0)),
            (10, (0.37, 0.447), (1, 2, 0.5, 3, 1 / 3.0)),
            (5, (0.54, 0.619), (1, 2, 0.5, 3, 1 / 3.0)),
            (3, (0.71, 0.79), (1, 2, 0.5)),
            (1, (0.88, 0.961), (1, 2, 0.5))]
SSD_ANCHORS = sum(side * side * (len(sizes) + len(ratios) - 1)
                  for side, sizes, ratios in SSD_MAPS)
SSD_BATCH, SSD_CLASSES, SSD_LABEL_ROWS = 32, 21, 50
SSD_NMS, SSD_THRESH = 0.45, 0.01
# Faster R-CNN with VGG16 (Ren et al.): a 600×1000 image, a 38×63 map at
# stride 16, 9 anchors a cell, 512 channels under the ROI pooling
RCNN_IMAGE, RCNN_MAP, RCNN_STRIDE = (600, 1000), (38, 63), 16
RCNN_SCALES, RCNN_RATIOS = (8, 16, 32), (0.5, 1, 2)
RCNN_PRE, RCNN_POST, RCNN_NMS = 6000, 300, 0.7
ROI_CHANNELS, ROI_POOLED, ROI_SCALE = 512, (7, 7), 1.0 / 16
ROI_FWD_ROIS, ROI_BWD_ROIS = 300, 128
# images a call of the plain NMS: its mask holds a few B × N × N float32
# matrices (2.4 GB each at 8 × 8,732²)
NMS_PLAIN_CHUNK = 8
NMS_RAGGED = (1, 63, 64, 65, 130, 1000)
# float32 operations of nms_mask, per box pair above the diagonal:
# max(x1), max(y1), min(x2), min(y2) (4); iw and ih, a subtraction and a
# max with 0 each (4); inter = iw·ih (1); union = area_a + area_b − inter
# (2); union > 0 (1); inter / union (1); iou > thresh (1). Per box, once:
# its area, (x2 − x1)·(y2 − y1) and a max with 0 (4).
NMS_PAIR_OPS, NMS_BOX_OPS = 14, 4
NMS_AT_THRESH_DRAWS = 1 << 20   # pairs drawn to find IoUs at the threshold
ROI_BWD_TOL = 1e-6         # of the plain gradient's max-abs
VISION_CPU_REL_L2 = 1e-4
VISION_TWINS = [("train_ssd", []), ("train_ssd", ["--use-recordio"]),
                ("train_rcnn", []), ("fcn_xs", []), ("ctc_train", []),
                ("deepspeech_mini", [])]
VISION_TWIN_ARGS = ["--gpus", "0"]
VISION_TIME_REPS = 10
VISION_GRAPH_COPIES = 12   # ROI inputs per graph: 12 × 4.9 MB > L2
# the twins' CTC shapes (T, N, classes with the blank, label length)
VISION_CTC_SHAPES = {"ctc_train": (12, 32, 7, 4),
                     "deepspeech_mini": (24, 32, 9, 4)}


def vision_kernels():
    from mxnet_tpu_torch.kernels import nms as NM
    from mxnet_tpu_torch.kernels import roi_pooling as RP
    return NM, RP


def vision_counts(K, C, R):
    """Every kernel's launch count, the vision kernels' and the rest."""
    NM, RP = vision_kernels()
    return dict(api_counts(K, C, R), nms_mask=NM.nms_mask.launches,
                nms_scan=NM.nms_scan.launches,
                roi_pool_fwd=RP.roi_pool_fwd.launches,
                roi_pool_bwd=RP.roi_pool_bwd.launches)


def vision_zero(K, C, R):
    NM, RP = vision_kernels()
    api_zero(K, C, R)
    for counter in (NM.nms_mask, NM.nms_scan, RP.roi_pool_fwd,
                    RP.roi_pool_bwd):
        counter.launches = 0


def vision_gen(seed):
    import torch
    return torch.Generator(device="cuda").manual_seed(seed)


def vision_boxes(B, n, span, gen):
    """(B, n, 4) random corner boxes in [0, span]², scores (B, n) with
    ties, on ``gen``'s device."""
    import torch
    dev = gen.device
    xy = torch.rand((B, n, 2), generator=gen, device=dev) * span
    wh = torch.rand((B, n, 2), generator=gen, device=dev) * span / 4
    scores = torch.rand((B, n), generator=gen, device=dev)
    scores[:, ::7] = scores[:, :1].clone()
    return torch.cat([xy, xy + wh], dim=2), scores


def integer_boxes(B, n, gen):
    """(B, n, 4) boxes with integer corners in [0, 16]: many pairs have an
    IoU of exactly 1/2, 1/3, 1/4…, which the strict ``>`` keeps."""
    import torch
    c = torch.randint(0, 17, (B, n, 4), generator=gen,
                      device=gen.device).float()
    boxes = torch.cat([torch.minimum(c[..., :2], c[..., 2:]),
                       torch.maximum(c[..., :2], c[..., 2:])], dim=2)
    return boxes, torch.rand((B, n), generator=gen, device=gen.device)


def clipped_boxes(B, n, gen):
    """(B, n, 4) boxes as MultiBoxDetection hands them to NMS: clipped to
    [0, 1], so some have zero area (union 0 against each other) and some
    are identical (every fifth is a copy of an earlier one); a third of
    the scores are −1, the value of a box at or below the threshold."""
    import torch
    dev = gen.device
    xy = torch.rand((B, n, 2), generator=gen, device=dev) * 2.0 - 0.6
    wh = torch.rand((B, n, 2), generator=gen, device=dev) * 0.6
    boxes = torch.cat([xy, xy + wh], dim=2).clamp(0.0, 1.0)
    boxes[:, 5::5] = boxes[:, 1:-4:5].clone()
    scores = torch.rand((B, n), generator=gen, device=dev)
    scores[:, ::3] = -1.0
    return boxes, scores


def threshold_pairs(NM, thresh, gen, draws=NMS_AT_THRESH_DRAWS):
    """Box pairs (M, 2, 4) whose plain float32 IoU is exactly ``thresh``
    (as float32), and pairs whose IoU is the next float32 above it: the
    pairs where an IoU rounded otherwise (an fma contraction, an
    approximate division) flips the strict ``>``. b is a shifted along x
    by w·(1 − t)/(1 + t), an IoU of t, with x1 moved by up to 64 steps of
    2⁻²⁴."""
    import numpy as np
    import torch
    dev = gen.device
    t = np.float32(thresh)
    xy = torch.rand((draws, 2), generator=gen, device=dev)
    wh = 0.05 + torch.rand((draws, 2), generator=gen, device=dev) * 0.5
    a = torch.cat([xy, xy + wh], dim=1)
    dx = wh[:, 0] * float((1 - t) / (1 + t))
    jitter = torch.randint(-64, 65, (draws,), generator=gen,
                           device=dev).float() * 2.0 ** -24
    b = a.clone()
    b[:, 0] += dx + jitter
    b[:, 2] += dx
    iou = NM.iou_matrix(a[:, None], b[:, None])[:, 0, 0]
    pairs = torch.stack([a, b], dim=1)
    above = float(np.nextafter(t, np.float32(1)))
    return pairs[iou == float(t)], pairs[iou == above]


def vision_sorted(boxes, scores):
    import torch
    order = torch.sort(-scores, dim=-1, stable=True).indices
    return boxes.gather(1, order[..., None].expand(-1, -1, 4))


def host_call(fn):
    """(fn's result, its host-clock ms with the card's queue drained at
    both ends): for the plain versions, many launches a call."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def nms_check(NM, boxes_s, thresh):
    """Kernel against plain on score-sorted boxes (B, N, 4), the plain
    version NMS_PLAIN_CHUNK images a call: (mask equal, keep equal,
    repeat equal, kernel mask, kernel keep, the plain mask's and scan's
    host ms over all B images)."""
    import torch
    n = boxes_s.shape[1]
    mask = NM.nms_mask(boxes_s, thresh)
    keep = NM.nms_scan(mask, n)
    mask2 = NM.nms_mask(boxes_s, thresh)
    keep2 = NM.nms_scan(mask2, n)
    mask_eq = keep_eq = True
    mask_ms = scan_ms = 0.0
    for lo in range(0, boxes_s.shape[0], NMS_PLAIN_CHUNK):
        hi = lo + NMS_PLAIN_CHUNK
        pmask, ms = host_call(lambda: NM.nms_mask_plain(boxes_s[lo:hi],
                                                        thresh))
        mask_ms += ms
        pkeep, ms = host_call(lambda: NM.nms_scan_plain(pmask, n))
        scan_ms += ms
        mask_eq = mask_eq and torch.equal(mask[lo:hi], pmask)
        keep_eq = keep_eq and torch.equal(keep[lo:hi], pkeep)
        del pmask, pkeep
    return (mask_eq, keep_eq,
            torch.equal(mask, mask2) and torch.equal(keep, keep2), mask,
            keep, mask_ms, scan_ms)


def roi_inputs(N, C, H, W, R, image, gen, relu=True):
    """A feature map (post-ReLU: about half zeros) and R ROIs in image
    coordinates (x within image[1], y within image[0]), with a few
    one-pixel and off-map ones."""
    import torch
    dev = gen.device
    data = torch.randn((N, C, H, W), generator=gen, device=dev)
    if relu:
        data = torch.relu(data)
    xy = torch.rand((R, 2), generator=gen, device=dev) * \
        torch.tensor([image[1], image[0]], device=dev, dtype=torch.float32)
    wh = torch.rand((R, 2), generator=gen, device=dev) * \
        torch.tensor([image[1], image[0]], device=dev,
                     dtype=torch.float32) / 2
    b = torch.randint(0, N, (R, 1), generator=gen, device=dev).float()
    rois = torch.cat([b, xy, xy + wh], dim=1)
    rois[::17, 3:] = rois[::17, 1:3]                # one-pixel ROIs
    rois[5::23, 1:] += torch.tensor([2.0 * image[1], 2.0 * image[0]] * 2,
                                    device=dev)     # off the map
    return data, rois


def roi_check(RP, data, rois, pooled, scale, gen, bwd_rois=None):
    """Forward against plain bit for bit (out and count), backward within
    ROI_BWD_TOL of the plain gradient's max-abs (on the first
    ``bwd_rois``), repeats bit for bit. Returns (row, out, count)."""
    import torch
    out, count = RP.roi_pool_fwd(data, rois, pooled, scale)
    out2, count2 = RP.roi_pool_fwd(data, rois, pooled, scale)
    pout, pcount = RP.roi_pool_fwd_plain(data, rois, pooled, scale)
    rb = rois[:bwd_rois] if bwd_rois else rois
    o, c = (out[:bwd_rois], count[:bwd_rois]) if bwd_rois else (out, count)
    g = torch.randn(o.shape, generator=gen, device=data.device)
    dx = RP.roi_pool_bwd(g, data, rb, o, c, pooled, scale)
    dx2 = RP.roi_pool_bwd(g, data, rb, o, c, pooled, scale)
    pdx = RP.roi_pool_bwd_plain(g, data, rb, pooled, scale)
    abs_err = float((dx - pdx).abs().max())
    err = abs_err / (float(pdx.abs().max()) or 1.0)
    row = {"fwd_bitwise": torch.equal(out, pout),
           "count_bitwise": torch.equal(count, pcount),
           "fwd_max_abs_err": float((out - pout).abs().max()),
           "bwd_max_abs_err": abs_err, "bwd_rel_err": err,
           "bwd_limit": ROI_BWD_TOL,
           "repeat_bitwise": torch.equal(out, out2) and
           torch.equal(count, count2) and torch.equal(dx, dx2),
           "zero_share_of_out": float((out == 0).float().mean()),
           "ties_share_of_bins": float((count > 1).float().mean()),
           "empty_bins": int((count == 0).sum())}
    row["ok"] = (row["fwd_bitwise"] and row["count_bitwise"]
                 and err <= ROI_BWD_TOL and row["repeat_bitwise"])
    return row, out, count


def vision_checks(NM, RP, card, ssd_boxes):
    """(a) The four kernels against their plain versions: NMS at ragged
    sizes, on integer boxes, on clipped boxes, on pairs at the threshold,
    on ``ssd_boxes`` (MultiBoxDetection's sorted boxes at SSD300's
    full width) and at Proposal's; ROI pooling ragged and at full width.
    Returns (failed, worst errors by kernel, the worst relative error of
    the ROI backward, the plain mask's and scan's host ms on
    ``ssd_boxes``)."""
    import numpy as np
    import torch
    failed = []
    worst = {"nms_mask": 0.0, "nms_scan": 0.0, "roi_pool_fwd": 0.0,
             "roi_pool_bwd": 0.0}
    gen = vision_gen(16)
    t = np.float32(SSD_NMS)
    eq, up = threshold_pairs(NM, SSD_NMS, gen)
    cases = [("ragged", 0.3, vision_boxes(3, n, 40.0, gen))
             for n in NMS_RAGGED] + [
        ("integer", 0.5, integer_boxes(4, 1000, gen)),
        ("clipped", SSD_NMS, clipped_boxes(3, 1000, gen)),
        ("at_threshold", SSD_NMS, (torch.cat([eq, up]), None)),
        ("ssd300_detection", SSD_NMS, (ssd_boxes, None)),
        ("proposal", RCNN_NMS, vision_boxes(1, RCNN_PRE, 1000.0, gen))]
    plain_ms = None
    for name, thresh, (boxes, scores) in cases:
        boxes_s = boxes if scores is None else vision_sorted(boxes, scores)
        B, n = boxes_s.shape[:2]
        mask_eq, keep_eq, rep, mask, keep, mask_ms, scan_ms = nms_check(
            NM, boxes_s, thresh)
        ok = mask_eq and keep_eq and rep
        row = {"phase": "vision_nms_check", "case": name, "images": B,
               "boxes": n, "thresh": thresh, "mask_bitwise": mask_eq,
               "keep_bitwise": keep_eq, "repeat_bitwise": rep,
               "kept": int(keep.sum()), "plain_mask_ms": mask_ms,
               "plain_scan_ms": scan_ms}
        if name == "integer":
            iou = NM.iou_matrix(boxes_s, boxes_s)
            upper = torch.ones(n, n, dtype=torch.bool,
                               device=iou.device).triu(1)
            row["pairs_at_thresh"] = int(((iou == 0.5) & upper).sum())
        if name in ("clipped", "ssd300_detection"):
            wh = boxes_s[..., 2:] - boxes_s[..., :2]
            row["zero_area_boxes"] = int((wh.prod(-1) <= 0).sum())
        if name == "at_threshold":
            # bit 1 of row 0: iou(a, b) > t, false at t, true just above
            bit = (mask[:, 0, 0] >> 1) & 1
            row["pairs_at_thresh"], row["pairs_above"] = len(eq), len(up)
            row["exact"] = bool((bit[:len(eq)] == 0).all()
                                and (bit[len(eq):] == 1).all())
            row["thresh_float32"] = float(t)
            ok = ok and row["exact"] and len(eq) > 0 and len(up) > 0
        if name == "ssd300_detection":
            plain_ms = (mask_ms, scan_ms)
        row.update(ok=ok, card=card)
        emit(row)
        if not ok:
            failed.append("nms %s n=%d" % (name, n))
            worst["nms_mask"] = worst["nms_scan"] = 1.0
    bwd_rel = 0.0
    for name, shape, R, image, scale, pooled, bwd in (
            ("ragged", (2, 3, 13, 17), 40, (13, 17), 1.0, (5, 4), None),
            ("ragged_scaled", (2, 5, 9, 11), 30, (144, 176), 1.0 / 16,
             (3, 3), None),
            ("rcnn_full_width", (1, ROI_CHANNELS) + RCNN_MAP, ROI_FWD_ROIS,
             RCNN_IMAGE, ROI_SCALE, ROI_POOLED, ROI_BWD_ROIS)):
        data, rois = roi_inputs(*shape, R, image, gen)
        row, _, _ = roi_check(RP, data, rois, pooled, scale, gen, bwd)
        emit({"phase": "vision_roi_check", "case": name,
              "data": list(shape), "rois": R, "bwd_rois": bwd or R,
              "pooled": list(pooled), "spatial_scale": scale, **row,
              "card": card})
        worst["roi_pool_fwd"] = max(worst["roi_pool_fwd"],
                                    row["fwd_max_abs_err"])
        worst["roi_pool_bwd"] = max(worst["roi_pool_bwd"],
                                    row["bwd_max_abs_err"])
        bwd_rel = max(bwd_rel, row["bwd_rel_err"])
        if not row["ok"]:
            failed.append("roi %s" % name)
    return failed, worst, bwd_rel, plain_ms


def ssd_inputs(gen):
    """SSD300's anchors (MultiBoxPrior over the six maps), padded labels,
    class predictions and probabilities, location predictions."""
    import torch
    dev = gen.device
    anchors = ssd_anchors()
    A = anchors.shape[1]
    label = torch.full((SSD_BATCH, SSD_LABEL_ROWS, 5), -1.0, device=dev)
    for b in range(SSD_BATCH):
        m = 1 + b % 10
        xy = torch.rand((m, 2), generator=gen, device=dev) * 0.7
        wh = 0.05 + torch.rand((m, 2), generator=gen, device=dev) * 0.3
        label[b, :m, 0] = torch.randint(0, SSD_CLASSES - 1, (m,),
                                        generator=gen, device=dev).float()
        label[b, :m, 1:] = torch.cat([xy, xy + wh], dim=1)
    logits = torch.randn((SSD_BATCH, SSD_CLASSES, A), generator=gen,
                         device=dev)
    loc = torch.randn((SSD_BATCH, A * 4), generator=gen, device=dev) * 0.1
    return anchors, label, logits, torch.softmax(logits, dim=1), loc


def rpn_inputs(gen):
    import torch
    dev = gen.device
    K = len(RCNN_SCALES) * len(RCNN_RATIOS)
    H, W = RCNN_MAP
    logits = torch.randn((1, 2, K, H, W), generator=gen, device=dev)
    cls = torch.softmax(logits, dim=1).reshape(1, 2 * K, H, W)
    deltas = torch.randn((1, 4 * K, H, W), generator=gen, device=dev) * 0.1
    info = torch.tensor([[RCNN_IMAGE[0], RCNN_IMAGE[1], 1.0]], device=dev)
    return cls, deltas, info


def op_call(name, attrs):
    from mxnet_tpu_torch import registry as treg
    op = treg.get_op(name)
    parsed = treg.parse_attrs(op, attrs)
    return lambda ins: op.fcompute(parsed, ins, None)


def op_times(fn, reps=VISION_TIME_REPS, copies=1):
    """Call ms (one CUDA-event pair), device ms (a CUDA graph of
    ``copies`` calls) and enqueue µs of ``fn``."""
    from mxnet_tpu_torch.tools import bn_probe
    device_ms, method = bn_probe.graph_ms([fn] * copies)
    return {"ms": bn_probe.cuda_time(fn, reps=reps, warm=2),
            "device_ms": device_ms, "device_method": method,
            "enqueue_us": bn_probe.enqueue_us(fn, reps=reps)}


def nms_scan_bytes(keep_s, words):
    """The bytes the scan must move for this run's data: each image's
    diagonal words, the rows of its kept boxes past their own tile, the
    keep flags."""
    import numpy as np
    k = keep_s.cpu().numpy()
    total = 0
    for row in k:
        tiles = np.nonzero(row)[0] // 64
        total += 8 * (len(row) + int((words - 1 - tiles).sum())) + len(row)
    return total


def roi_bin_work(RP, data, rois, pooled, scale):
    """Σ over (roi, bin) of the bin's positions, times the channels."""
    H, W = data.shape[2], data.shape[3]
    _, hs, he, ws, we = RP._bins(rois, scale, pooled, data.shape[0])
    h = (he.clamp(0, H) - hs.clamp(0, H)).clamp_min(0)
    w = (we.clamp(0, W) - ws.clamp(0, W)).clamp_min(0)
    return float((h[:, :, None] * w[:, None, :]).sum()) * data.shape[1]


def kernel_entry(name, source, replaces, t, plain_ms, bytes_moved, ops,
                 err):
    byte_ms = 1e3 * bytes_moved / HBM_BYTES_PER_S
    op_ms = 1e3 * ops / F32_FLOPS_PER_S
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=err, ms=t["ms"], device_ms=t["device_ms"],
                enqueue_us=t["enqueue_us"], plain_ms=plain_ms,
                bound_ms=max(byte_ms, op_ms),
                bound_by="bytes" if byte_ms >= op_ms else "operations",
                bound_bytes_ms=byte_ms, bound_operations_ms=op_ms,
                library_ms=None)


def vision_full_width(mx, NM, RP, card, worst, bwd_rel, ssd, nms_plain_ms):
    """(b) Each op at SSD300's and Faster R-CNN's operating points (call,
    device and enqueue times), each kernel alone at the ops' shapes beside
    its plain version and its bound, and F.ctc_loss beside the port's CTC.
    ``ssd`` is ssd_inputs' SSD300 batch, ``nms_plain_ms`` the plain NMS's
    host ms on its 32 images (from the check). Returns the four kernels'
    entries."""
    import torch
    gen = vision_gen(160)
    anchors, label, logits, prob, loc = ssd
    A = anchors.shape[1]
    target = op_call("_contrib_MultiBoxTarget", {"overlap_threshold": 0.5})
    detect = op_call("_contrib_MultiBoxDetection", {
        "nms_threshold": SSD_NMS, "threshold": SSD_THRESH})
    cls, deltas, info = rpn_inputs(gen)
    proposal = op_call("_contrib_Proposal", {
        "feature_stride": RCNN_STRIDE, "scales": RCNN_SCALES,
        "ratios": RCNN_RATIOS, "rpn_pre_nms_top_n": RCNN_PRE,
        "rpn_post_nms_top_n": RCNN_POST, "threshold": RCNN_NMS})
    rois = proposal([cls, deltas, info])[0]
    fmap = torch.relu(torch.randn((1, ROI_CHANNELS) + RCNN_MAP,
                                  generator=gen, device="cuda"))
    roi_op = op_call("ROIPooling", {"pooled_size": ROI_POOLED,
                                    "spatial_scale": ROI_SCALE})
    fmap_g = fmap.clone().requires_grad_(True)
    g128 = torch.randn((ROI_BWD_ROIS, ROI_CHANNELS) + ROI_POOLED,
                       generator=gen, device=fmap.device)

    def roi_fwd_bwd():
        out = roi_op([fmap_g, rois[:ROI_BWD_ROIS]])[0]
        return torch.autograd.grad(out, fmap_g, g128)[0]

    with torch.no_grad():
        runs = [("MultiBoxPrior+Concat", ssd_anchors),
                ("MultiBoxTarget", lambda: target([anchors, label, logits])),
                ("MultiBoxDetection", lambda: detect([prob, loc, anchors])),
                ("Proposal", lambda: proposal([cls, deltas, info])),
                ("ROIPooling_fwd_300", lambda: roi_op([fmap, rois]))]
        for name, fn in runs:
            emit({"phase": "vision_op_times", "op": name, **op_times(fn),
                  "card": card})
    emit({"phase": "vision_op_times", "op": "ROIPooling_fwd_bwd_128",
          **op_times(roi_fwd_bwd), "card": card})

    # each kernel alone, at the ops' shapes, beside its plain version's
    # host ms on the same inputs (the NMS pair's from vision_checks)
    entries = []
    boxes_s = ssd_sorted_boxes(prob, loc, anchors)
    n, words = A, (A + 63) // 64
    mask = NM.nms_mask(boxes_s, SSD_NMS)
    keep_s = NM.nms_scan(mask, n)
    for name, fn, plain_ms, moved, ops in (
            ("nms_mask", lambda: NM.nms_mask(boxes_s, SSD_NMS),
             nms_plain_ms[0], boxes_s.numel() * 4 + mask.numel() * 8,
             SSD_BATCH * (n * (n - 1) / 2 * NMS_PAIR_OPS
                          + n * NMS_BOX_OPS)),
            ("nms_scan", lambda: NM.nms_scan(mask, n), nms_plain_ms[1],
             nms_scan_bytes(keep_s, words), 0.0)):
        e = kernel_entry(name, "mxnet_tpu_torch/kernels/csrc/nms.cu",
                         "mxnet_tpu/ops/detection.py:114", op_times(fn),
                         plain_ms, moved, ops, worst[name])
        e.update(shape=[SSD_BATCH, n], plain_images=SSD_BATCH,
                 kept_per_image_mean=float(keep_s.sum(1).float().mean()))
        entries.append(e)
    copies = [fmap.clone() for _ in range(VISION_GRAPH_COPIES)]
    it = iter(range(10 ** 9))
    t = op_times(lambda: RP.roi_pool_fwd(
        copies[next(it) % VISION_GRAPH_COPIES], rois, ROI_POOLED,
        ROI_SCALE), copies=VISION_GRAPH_COPIES)
    out, count = RP.roi_pool_fwd(fmap, rois, ROI_POOLED, ROI_SCALE)
    _, plain = host_call(lambda: RP.roi_pool_fwd_plain(
        fmap, rois, ROI_POOLED, ROI_SCALE))
    # the function's bytes: the map and the ROIs read, the pooled output
    # written (the tie counts are this design's own, for its backward);
    # one max a bin position a channel
    work = roi_bin_work(RP, fmap, rois, ROI_POOLED, ROI_SCALE)
    entries.append(kernel_entry(
        "roi_pool_fwd", "mxnet_tpu_torch/kernels/csrc/roi_pooling.cu",
        "mxnet_tpu/ops/conv.py:341", t, plain,
        (fmap.numel() + rois.numel() + out.numel()) * 4, work,
        worst["roi_pool_fwd"]))
    entries[-1]["shape"] = {"data": list(fmap.shape), "rois": RCNN_POST,
                            "pooled": list(ROI_POOLED)}
    rb, ob, cb = rois[:ROI_BWD_ROIS], out[:ROI_BWD_ROIS], count[:ROI_BWD_ROIS]
    t = op_times(lambda: RP.roi_pool_bwd(
        g128, copies[next(it) % VISION_GRAPH_COPIES], rb, ob, cb,
        ROI_POOLED, ROI_SCALE), copies=VISION_GRAPH_COPIES)
    _, plain = host_call(lambda: RP.roi_pool_bwd_plain(
        g128, fmap, rb, ROI_POOLED, ROI_SCALE))
    # the inputs read (the head gradient, the forward's out and tie
    # counts, the map, the ROIs), the map's gradient written; a compare,
    # a division and an add a bin position a channel
    work = roi_bin_work(RP, fmap, rb, ROI_POOLED, ROI_SCALE)
    entries.append(kernel_entry(
        "roi_pool_bwd", "mxnet_tpu_torch/kernels/csrc/roi_pooling.cu",
        "mxnet_tpu/ops/conv.py:341", t, plain,
        g128.numel() * 12 + fmap.numel() * 8 + rb.numel() * 4, 3 * work,
        worst["roi_pool_bwd"]))
    entries[-1]["shape"] = {"data": list(fmap.shape), "rois": ROI_BWD_ROIS,
                            "pooled": list(ROI_POOLED)}
    entries[-1]["max_rel_err"] = bwd_rel      # of the plain max-abs
    for e in entries:
        emit({"phase": "vision_kernel_times", **e, "card": card})
    vision_ctc_yardstick(card)
    return entries


def ssd_anchors():
    """MultiBoxPrior over SSD300's six maps, concatenated (the op's
    anchors are cached per shape and device)."""
    import torch
    from mxnet_tpu_torch import registry as treg
    prior = treg.get_op("_contrib_MultiBoxPrior")
    dev = "cuda"
    return torch.cat([prior.fcompute(
        treg.parse_attrs(prior, {"sizes": sizes, "ratios": ratios}),
        [torch.empty((SSD_BATCH, 1, side, side), device=dev)], None)[0]
        for side, sizes, ratios in SSD_MAPS], dim=1)


def ssd_sorted_boxes(prob, loc, anchors):
    """MultiBoxDetection's decoded boxes sorted by the scores its NMS
    sorts by (−1 at or below the threshold), as the NMS kernels see
    them."""
    import torch
    from mxnet_tpu_torch.ops.detection import decode_detections
    boxes, scores, valid = decode_detections({"threshold": SSD_THRESH},
                                             [prob, loc, anchors])
    return vision_sorted(boxes, torch.where(valid, scores,
                                            torch.full_like(scores, -1.0)))


def vision_ctc_yardstick(card):
    """The port's CTCLoss (forward + backward) beside F.ctc_loss at the
    twins' shapes; F.ctc_loss is a yardstick the port never calls."""
    import torch
    import torch.nn.functional as F
    from mxnet_tpu_torch.tools import bn_probe
    ctc = op_call("CTCLoss", {})
    gen = vision_gen(161)
    dev = "cuda"
    for twin, (T, N, Cn, L) in VISION_CTC_SHAPES.items():
        data = torch.randn((T, N, Cn), generator=gen, device=dev)
        lens = torch.randint(2, L + 1, (N,), generator=gen, device=dev)
        labels = torch.randint(1, Cn, (N, L), generator=gen, device=dev)
        labels = torch.where(torch.arange(L, device=dev)[None] < lens[:, None],
                             labels, torch.zeros_like(labels)).float()
        d = data.clone().requires_grad_(True)

        def port():
            return torch.autograd.grad(ctc([d, labels])[0].sum(), d)[0]

        def library():
            lp = torch.log_softmax(d, dim=-1)
            loss = F.ctc_loss(lp, labels.long(), torch.full((N,), T,
                                                            device=dev),
                              lens, blank=0, reduction="none",
                              zero_infinity=False)
            return torch.autograd.grad(loss.sum(), d)[0]

        with torch.no_grad():
            mine = ctc([data, labels])[0]
            lib = F.ctc_loss(torch.log_softmax(data, dim=-1), labels.long(),
                             torch.full((N,), T, device=dev), lens, blank=0,
                             reduction="none")
        emit({"phase": "vision_ctc_yardstick", "twin": twin,
              "T_N_classes_L": [T, N, Cn, L],
              "port_fwd_bwd_ms": bn_probe.cuda_time(port, reps=5, warm=1),
              "ctc_loss_fwd_bwd_ms": bn_probe.cuda_time(library, reps=5,
                                                        warm=1),
              "loss_max_rel_diff": float(((mine - lib).abs()
                                          / lib.abs()).max()),
              "card": card})


def vision_twins(mx, K, C, R, card):
    """(c) The five twins at their defaults, in process, train_ssd with
    both feeds, every counter set to 0 just before each and read just
    after. Returns (failed, rows, the launches summed over them)."""
    import importlib
    import numpy as np
    import torch
    failed, rows = [], []
    total = dict.fromkeys(vision_counts(K, C, R), 0)
    for name, extra in VISION_TWINS:
        twin = importlib.import_module("mxnet_tpu_torch.examples." + name)
        args = VISION_TWIN_ARGS + extra
        vision_zero(K, C, R)
        t0 = time.time()
        res = twin.main(args)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        row = {"phase": "vision_twin", "twin": name, "args": args,
               "seconds": seconds, "ms_per_step": res["ms_per_step"],
               "steps": res["steps"]}
        gates = {}
        if "losses" in res:
            row["losses"] = res["losses"]
            params = res["module"].get_params()[0]
            gates["loss_falls"] = res["losses"][-1] < res["losses"][0]
            gates["params_finite"] = all(
                bool(np.isfinite(v.asnumpy()).all()) for v in params.values())
        if name == "train_ssd":
            t1 = time.time()
            det = twin.detect(*res["module"].get_params(), res["images"],
                              mx.gpu(0))
            torch.cuda.synchronize()
            row["detect_seconds"] = time.time() - t1
            kept = (det[..., 0] >= 0).sum(1)
            row["detect_shape"] = list(det.shape)
            row["detect_kept_per_image"] = kept.tolist()
            gates["detect_keeps_a_box_an_image"] = bool((kept >= 1).all())
        if name == "train_rcnn":
            rois = res["demo"]["rois"]
            row["demo_rois_shape"] = list(rois.shape)
            gates["demo_rois"] = rois.shape == (16, 5) and \
                bool((rois[:, 0] == 0).all())
        if "accuracy" in res:
            row["accuracy"] = res["accuracy"]
            if "iou" in res:
                row["iou"] = res["iou"]
        launches = vision_counts(K, C, R)
        row["launches"] = launches
        if name == "train_ssd":
            gates["nms_in_detector"] = launches["nms_mask"] >= 1 and \
                launches["nms_scan"] >= 1
        if name == "train_rcnn":
            gates["nms_and_roi_in_demo"] = launches["nms_mask"] >= 1 and \
                launches["nms_scan"] >= 1 and launches["roi_pool_fwd"] >= 1
        gates["no_bn_copy_rtc"] = not any(launches[k] for k in
                                          ("bn_fwd", "bn_bwd", "copy",
                                           "rtc"))
        row["gates"] = gates
        row["ok"] = all(gates.values())
        row["card"] = card
        emit(row)
        rows.append(row)
        if not row["ok"]:
            failed.append("twin %s %s: %s" % (name, extra, gates))
        total = {k: total[k] + v for k, v in launches.items()}
        del res
    return failed, rows, total


def vision_card_vs_cpu(mx, card):
    """(d) One SSD training step (the twin's graph at its batch, 32² images)
    from the same parameters on the card and on the CPU: outputs and
    every gradient within VISION_CPU_REL_L2."""
    import numpy as np
    from mxnet_tpu_torch.examples import train_ssd
    rs = np.random.RandomState(16)
    x, label = train_ssd.synth_batch(rs, 32)
    sym = train_ssd.build_ssd()[0]
    shapes = dict(zip(sym.list_arguments(),
                      sym.infer_shape(data=x.shape, label=label.shape)[0]))
    args = {k: (rs.randn(*s) * 0.1).astype(np.float32)
            for k, s in shapes.items() if k not in ("data", "label")}
    runs = {}
    for where, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        with deterministic_cudnn():
            ex = sym.simple_bind(ctx, data=x.shape, label=label.shape)
            for k, v in args.items():
                ex.arg_dict[k][:] = v
            ex.arg_dict["data"][:] = x
            ex.arg_dict["label"][:] = label
            outs = [o.asnumpy() for o in ex.forward(is_train=True)]
            ex.backward()
            runs[where] = (outs, {k: ex.grad_dict[k].asnumpy()
                                  for k in args})
    errs = {"out%d" % i: rel_l2(c, p) for i, (c, p) in
            enumerate(zip(runs["card"][0], runs["cpu"][0]))}
    errs.update({k: rel_l2(runs["card"][1][k], runs["cpu"][1][k])
                 for k in args})
    worst = max(errs.values())
    ok = worst <= VISION_CPU_REL_L2
    emit({"phase": "vision_card_vs_cpu", "rel_l2": errs, "worst": worst,
          "limit": VISION_CPU_REL_L2, "ok": ok, "card": card})
    return [] if ok else ["card vs cpu SSD step %.3g" % worst]


def vision_graphs(mx, K, C, R, card, ssd):
    """(b) The two detectors' operators at full width, once, as graphs
    bound through ``simple_bind`` on the card: SSD300's MultiBoxPrior ×
    6 → Concat → MultiBoxTarget and MultiBoxDetection, and Faster
    R-CNN's Proposal → ROIPooling (forward at 300 ROIs, forward and
    backward at 128), every counter set to 0 just before and read just
    after; SSD300's inputs are ``ssd`` (ssd_inputs'). Returns (failed,
    the launches)."""
    import numpy as np
    import torch
    ctx = mx.gpu(0)
    gen = vision_gen(162)
    _, label, logits, prob, loc = ssd
    sym = mx.sym
    maps = [sym.Variable("map%d" % i) for i in range(len(SSD_MAPS))]
    anc = sym.Concat(*[sym._contrib_MultiBoxPrior(m, sizes=sizes,
                                                  ratios=ratios)
                       for m, (_, sizes, ratios) in zip(maps, SSD_MAPS)],
                     dim=1)
    tgt = sym._contrib_MultiBoxTarget(anc, sym.Variable("label"),
                                      sym.Variable("cls_pred"),
                                      overlap_threshold=0.5)
    det = sym._contrib_MultiBoxDetection(
        sym.Variable("cls_prob"), sym.Variable("loc_pred"), anc,
        nms_threshold=SSD_NMS, threshold=SSD_THRESH)
    ssd = sym.Group([tgt[2], det])
    shapes = {"map%d" % i: (SSD_BATCH, 1, s, s)
              for i, (s, _, _) in enumerate(SSD_MAPS)}
    feeds = {"label": label, "cls_pred": logits, "cls_prob": prob,
             "loc_pred": loc}
    shapes.update({k: tuple(v.shape) for k, v in feeds.items()})
    cls, deltas, info = rpn_inputs(gen)
    fmap = torch.relu(torch.randn((1, ROI_CHANNELS) + RCNN_MAP,
                                  generator=gen, device="cuda"))
    rois = sym._contrib_Proposal(
        sym.Variable("rpn_cls_prob"), sym.Variable("rpn_bbox_pred"),
        sym.Variable("im_info"), feature_stride=RCNN_STRIDE,
        scales=RCNN_SCALES, ratios=RCNN_RATIOS, rpn_pre_nms_top_n=RCNN_PRE,
        rpn_post_nms_top_n=RCNN_POST, threshold=RCNN_NMS)
    feat = sym.Variable("feat")
    pool = dict(pooled_size=ROI_POOLED, spatial_scale=ROI_SCALE)
    pooled = sym.ROIPooling(feat, rois, **pool)
    trained = sym.ROIPooling(feat, sym.slice_axis(rois, axis=0, begin=0,
                                                  end=ROI_BWD_ROIS), **pool)
    rcnn = sym.Group([sym.BlockGrad(rois), sym.BlockGrad(pooled),
                      sym.MakeLoss(sym.sum(trained))])
    rfeeds = {"rpn_cls_prob": cls, "rpn_bbox_pred": deltas,
              "im_info": info, "feat": fmap}
    vision_zero(K, C, R)
    t0 = time.time()
    ex = ssd.simple_bind(ctx, grad_req="null", **shapes)
    for k, v in feeds.items():
        ex.arg_dict[k][:] = v.cpu().numpy()
    cls_t, dets = [o.asnumpy() for o in ex.forward(is_train=False)]
    ex = rcnn.simple_bind(ctx, grad_req={"feat": "write"},
                          **{k: tuple(v.shape) for k, v in rfeeds.items()})
    for k, v in rfeeds.items():
        ex.arg_dict[k][:] = v.cpu().numpy()
    out_rois, out_pooled, _ = [o.asnumpy() for o in
                               ex.forward(is_train=True)]
    ex.backward()
    grad = ex.grad_dict["feat"].asnumpy()
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = vision_counts(K, C, R)
    kept = (dets[..., 0] >= 0).sum(1)
    gates = {
        "ssd_shapes": dets.shape == (SSD_BATCH, SSD_ANCHORS, 6)
        and cls_t.shape == (SSD_BATCH, SSD_ANCHORS),
        "ssd_positives": bool(((cls_t > 0).sum(1) > 0).all()),
        "ssd_kept": bool((kept > 0).all()),
        "rcnn_rois": out_rois.shape == (RCNN_POST, 5)
        and bool((out_rois[:, 0] == 0).all()),
        "rcnn_pooled": out_pooled.shape == (RCNN_POST, ROI_CHANNELS)
        + ROI_POOLED and bool(np.isfinite(out_pooled).all()),
        "rcnn_grad": bool(np.isfinite(grad).all() and grad.sum() > 0),
        "launched": all(launches[k] >= 1 for k in (
            "nms_mask", "nms_scan", "roi_pool_fwd", "roi_pool_bwd")),
        "no_bn_copy_rtc": not any(launches[k] for k in
                                  ("bn_fwd", "bn_bwd", "copy", "rtc"))}
    emit({"phase": "vision_graphs", "seconds": seconds,
          "ssd_kept_per_image_min_max": [int(kept.min()), int(kept.max())],
          "ssd_positives_per_image_min": int((cls_t > 0).sum(1).min()),
          "rois": list(out_rois.shape), "launches": launches,
          "gates": gates, "ok": all(gates.values()), "card": card})
    failed = [] if all(gates.values()) else ["full-width graphs %s" % gates]
    return failed, launches


def vision_phase(mx, K, C, R, card):
    """Phase 16 (module docstring). Returns (the four kernels' entries,
    every kernel's launches over the phase's main path: the full-width
    graphs and the twins)."""
    NM, RP = vision_kernels()
    # SSD300's batch: the kernels are checked on MultiBoxDetection's
    # boxes of it, the full-width graph runs it, the kernels are timed on it
    ssd = ssd_inputs(vision_gen(160))
    failed, worst, bwd_rel, nms_plain_ms = vision_checks(
        NM, RP, card, ssd_sorted_boxes(ssd[3], ssd[4], ssd[0]))
    f, graph_launches = vision_graphs(mx, K, C, R, card, ssd)
    failed += f
    f, rows, twin_launches = vision_twins(mx, K, C, R, card)
    failed += f
    launches = {k: v + twin_launches[k] for k, v in graph_launches.items()}
    entries = vision_full_width(mx, NM, RP, card, worst, bwd_rel, ssd,
                                nms_plain_ms)
    failed += vision_card_vs_cpu(mx, card)
    for e in entries:
        e["launches"] = launches[e["name"]]
        e["launches_graphs"] = graph_launches[e["name"]]
    emit({"phase": "vision_kernels", "launches": launches,
          "launches_graphs": graph_launches,
          "launches_twins": twin_launches,
          "twins_seconds": sum(r["seconds"] for r in rows),
          "ok": not failed})
    if failed:
        raise RuntimeError("vision phase failed: %s" % "; ".join(failed))
    return entries, launches


# ---------------------------------------------------------------------------
# phase 17: the guardian, fault injection and training telemetry
# ---------------------------------------------------------------------------
GUARD_DEVICE = "cuda"
GUARD_NETWORK = "resnet-20"       # the CIFAR twin at its published width
GUARD_BATCH = 128
GUARD_BATCHES = 16                # a 3-epoch run of 16 batches
GUARD_EPOCHS = 3
GUARD_BN = 20                     # BatchNorms in resnet-20 (each kernel)
GUARD_PROBE = 3                   # the SDC probe's period in (a)
GUARD_SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
# (b) resnet-20's data BatchNorm normalises a positive scale away, so the
# default loss_spike (×1000) leaves its loss unchanged, and a finite
# poison (a sign flip) lands inside the early epochs' loss spread the
# spike judge's baseline holds: value=inf makes the poisoned step's
# statistics non-finite, a verdict the phase can count on
GUARD_PLAN_B = ("module.step:grad_nonfinite@epoch=1,nbatch=2; "
                "module.step:loss_spike@epoch=2,nbatch=1,value=inf")
GUARD_PLAN_C_RESTORE = ("checkpoint.params:param_bitflip@nth=1; "
                        "module.step:grad_nonfinite@epoch=2,nbatch=1")
GUARD_PLAN_C_SDC = "guardian.sdc:value@nth=2,value=0.25"
GUARD_PLAN_D = ("checkpoint.commit:transient@step=0; "
                "data.device_put:transient@nth=5; "
                "checkpoint.shard:bitflip@step=2")
# the README's chaos recipe: the twin rolls back onto its committed entry
GUARD_TWIN_ARGS = ["--gpus", "0"]
GUARD_TWIN_PLAN = "module.step:grad_nonfinite@epoch=2,nbatch=1"
GUARD_R50_BATCHES = 3             # ResNet-50: 2 epochs of 3 = 6 steps
GUARD_FLOPS_REL = 0.05            # counted FLOPs against 2·MACs·3
GUARD_WORD_REPS = 20


def guard_ctx(mx):
    return mx.cpu() if GUARD_DEVICE == "cpu" else mx.gpu(0)


def guard_sync():
    import torch
    if GUARD_DEVICE != "cpu":
        torch.cuda.synchronize()


def guard_skipping_iter(mx, source, skips):
    """``source`` with the (epoch, nbatch) coordinates ``skips`` dropped:
    the clean stream a rollback-and-skip must land on."""

    class Skipping(mx.io.DataIter):
        def __init__(self):
            super().__init__(source.batch_size)
            self.provide_data = source.provide_data
            self.provide_label = source.provide_label
            self.epoch, self.nbatch = 0, -1

        def set_epoch(self, epoch):
            self.epoch = int(epoch)

        def reset(self):
            self.nbatch = -1
            source.reset()

        def next(self):
            while True:
                batch = source.next()
                self.nbatch += 1
                if (self.epoch, self.nbatch) not in skips:
                    return batch

    return Skipping()


def guard_digest(mod):
    import hashlib
    h = hashlib.sha256()
    for k, v in sorted(host_params(mod).items()):
        h.update(k.encode())
        h.update(v.tobytes())
    return h.hexdigest()


def guard_run(mx, K, net, data, epochs, guard=None, plan=None, skips=(),
              checkpoint=False, prefetch=None, sync=False):
    """One seeded ``fit`` of ``net`` on ``data`` (x, y, batch): the
    guardian (a Guardian or None), a fault plan armed for the run, the
    coordinates ``skips`` dropped from the stream, a checkpoint per epoch
    into the guardian's manager, ``prefetch_to_device``. ``sync`` makes
    every batch end wait for the card (the timeline's clocks are then the
    device's). Returns the row and the module."""
    import numpy as np
    from mxnet_tpu_torch import faults, telemetry
    x, y, batch = data
    ctx = guard_ctx(mx)
    np.random.seed(7)
    mx.random.seed(7)
    mod = mx.mod.Module(net, context=ctx)
    it = mx.io.NDArrayIter(x, y, batch_size=batch)
    if skips:
        it = guard_skipping_iter(mx, it, set(skips))
    steps = [0]

    def count(param):
        steps[0] += 1
        if sync:
            guard_sync()

    cb = mx.callback.module_checkpoint(
        mod, save_optimizer_states=True, manager=guard.manager) \
        if checkpoint else None
    watch = telemetry.compile_watch()
    reg = telemetry.registry()
    c0 = {k: reg.counter(k).value for k in (
        "compile.post_warmup_retraces", "checkpoint.restore_fallbacks",
        "faults.retries")}
    telemetry.timeline().clear()
    telemetry.flight_recorder().clear()
    fired = faults.arm(plan, seed=7) if plan else None
    b0 = (K.bn_fwd.launches, K.bn_bwd.launches)
    guard_sync()
    t0 = time.perf_counter()
    try:
        mod.fit(it, num_epoch=epochs, optimizer="sgd",
                optimizer_params=GUARD_SGD, batch_end_callback=count,
                epoch_end_callback=cb, guardian=guard,
                initializer=mx.init.Xavier(factor_type="in",
                                           magnitude=2.34),
                prefetch_to_device=prefetch)
        guard_sync()
        if guard is not None:
            # the last epoch's async commit still evaluates its seams
            guard.manager.wait_until_finished()
    finally:
        faults.disarm()
    seconds = time.perf_counter() - t0
    events = [e for e in telemetry.flight_recorder().snapshot("phase 17")
              ["events"] if e["kind"] == "guardian_rollback"]
    row = {"steps": steps[0], "seconds": seconds,
           "launches": {"bn_fwd": K.bn_fwd.launches - b0[0],
                        "bn_bwd": K.bn_bwd.launches - b0[1]},
           "post_warmup_compiles":
               reg.counter("compile.post_warmup_retraces").value
               - c0["compile.post_warmup_retraces"],
           "restore_fallbacks":
               reg.counter("checkpoint.restore_fallbacks").value
               - c0["checkpoint.restore_fallbacks"],
           "retries": reg.counter("faults.retries").value
               - c0["faults.retries"],
           "compiles": watch.count, "digest": guard_digest(mod),
           "rollback_events": [
               {k: e[k] for k in ("verdict_kind", "epoch", "nbatch",
                                  "flags", "restore_step")}
               for e in events]}
    if guard is not None:
        row["guardian"] = guard.stats()
    if fired is not None:
        row["plan"] = fired.describe()["rules"]
        row["unfired"] = fired.unfired()
        row["incidents"] = [
            {"site": i["site"], "kind": i["kind"], "ctx": i["ctx"]}
            for i in fired.incidents()]
    return row, mod


def guard_timeline_roofline():
    """The live roofline of the newest run: medians of the records that
    carry it (every epoch after the first)."""
    from mxnet_tpu_torch import telemetry
    recs = [r for r in telemetry.timeline().records() if "mfu" in r]
    if not recs:
        return {"records": 0}
    med = statistics.median
    return {"records": len(recs),
            "mfu": med(r["mfu"] for r in recs),
            "achieved_tflops": med(r["achieved_tflops"] for r in recs),
            "achieved_hbm_gbps": med(r["achieved_hbm_gbps"] for r in recs),
            "total_ms": med(r["total_ms"] for r in recs),
            "bound_by": sorted({r["bound_by"] for r in recs})}


def guard_model_flops(net, shapes):
    """The independent count: 2·MACs of every convolution and fully
    connected layer (from the symbol's inferred shapes), ×3 for the
    forward and the backward."""
    import numpy as np
    internals = net.get_internals()
    arg, out, _ = internals.infer_shape(**shapes)
    args = dict(zip(internals.list_arguments(), arg))
    outs = dict(zip(internals.list_outputs(), out))
    macs = 0
    for node in net._topo():
        if node.op is not None and node.op.name in ("Convolution",
                                                    "FullyConnected"):
            w = args[node.name + "_weight"]
            macs += int(np.prod(outs[node.name + "_output"])) * \
                int(np.prod(w[1:]))
    return 2 * 3 * macs


def guard_roofline_row(mx, mod, net, shapes, name, card):
    """(g): the counted FLOPs of the step beside the independent count,
    and the live roofline the run's records carry."""
    basis = mod._exec_group.roofline_basis()
    want = guard_model_flops(net, shapes)
    row = {"phase": "guardian_roofline", "model": name, "card": card,
           "counted_flops_per_step": basis["flops_per_step"],
           "counted_bytes_per_step": basis["bytes_per_step"],
           "independent_flops_per_step": want,
           "counted_over_independent": basis["flops_per_step"] / want,
           "peak_tflops": basis["peak_tflops"],
           "peak_hbm_gbps": basis["peak_hbm_gbps"],
           **guard_timeline_roofline()}
    emit(row)
    return abs(row["counted_over_independent"] - 1.0) <= GUARD_FLOPS_REL \
        and row["records"] > 0


def guard_word_cost(mx, mod):
    """The health word's device cost: ``_health_update`` on the module's
    own outputs, gradients and parameters, CUDA events around
    ``GUARD_WORD_REPS`` calls (host ms, synchronised, on the CPU)."""
    import torch
    from mxnet_tpu_torch.module import mesh_executor_group as meg
    grp = mod._exec_group
    cfg = {"window": 32, "stat": mx.metric.create("ce").fused_stat()}
    inputs = grp._inputs_now()
    outs = tuple(o._read() for o in grp.execs[0].outputs)
    grads = {n: grp._grad_dict[n]._read() for n in grp._grad_names}
    params = grp._params_now()
    dev = grp.contexts[0].torch_device()
    health = (torch.zeros((), dtype=torch.int32, device=dev),
              torch.full((), -1, dtype=torch.int32, device=dev),
              torch.zeros((), dtype=torch.int32, device=dev),
              torch.full((32,), float("nan"), device=dev))

    def run():
        h = health
        for _ in range(GUARD_WORD_REPS):
            h = meg._health_update(cfg, h, inputs, outs, grads, params,
                                   grp._grad_names, grp._label_names)
        return h

    run()
    if GUARD_DEVICE == "cpu":
        t0 = time.perf_counter()
        run()
        return 1e3 * (time.perf_counter() - t0) / GUARD_WORD_REPS
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / GUARD_WORD_REPS


def guard_twin(root, card):
    """The chaos recipe the README gives: the CIFAR twin with ``--seed
    --guardian --fault-plan`` and a checkpoint per epoch rolls back onto
    the entry its last healthy epoch committed (step 1) and finishes
    above the twin's accuracy gate. Returns the failed gates."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.examples import train_cifar10
    telemetry.flight_recorder().clear()
    t0 = time.time()
    res = train_cifar10.main(GUARD_TWIN_ARGS + [
        "--seed", "7", "--num-epochs", str(GUARD_EPOCHS), "--guardian",
        "--fault-plan", GUARD_TWIN_PLAN, "--min-accuracy",
        str(TWIN_MIN_ACCURACY), "--checkpoint-dir",
        os.path.join(root, "twin")])
    events = [e for e in telemetry.flight_recorder().snapshot("twin")
              ["events"] if e["kind"] == "guardian_rollback"]
    gates = {"one_rollback": res["guardian"]["rollbacks"] == 1,
             "onto_committed_entry": [e["restore_step"] for e in events]
             == [GUARD_EPOCHS - 2],
             "planned_incident": [(i["site"], i["kind"]) for i in
                                  res["incidents"]]
             == [("module.step", "grad_nonfinite")]}
    emit({"phase": "guardian_twin", "plan": GUARD_TWIN_PLAN,
          "seconds": time.time() - t0, "accuracy": res["accuracy"],
          "guardian": res["guardian"], "gates": gates, "card": card})
    return ["(b) twin " + k for k, ok in gates.items() if not ok]


def guardian_phase(mx, K, C, R, card):
    """Phase 17 (module docstring). Returns every kernel's launches over
    the phase's runs, zeroed just before them."""
    import shutil
    import tempfile
    import numpy as np
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.examples.train_cifar10 import synthetic_cifar
    from mxnet_tpu_torch.guardian import Guardian
    from mxnet_tpu_torch.module.mesh_executor_group import \
        HEALTH_SDC_MISMATCH
    n = GUARD_BATCH * GUARD_BATCHES
    x, y = synthetic_cifar(np.random.RandomState(0), n)
    data = (x, y, GUARD_BATCH)
    net = mx.models.get_symbol(GUARD_NETWORK, num_classes=10,
                               image_shape=TWIN_IMAGE)
    root = tempfile.mkdtemp(prefix="guardian_phase_")
    dirs = iter(range(1000))

    def guard(**kw):
        return Guardian(os.path.join(root, "g%d" % next(dirs)), **kw)

    per_step = GUARD_BN * GUARD_EPOCHS * GUARD_BATCHES
    failed = []
    vision_zero(K, C, R)
    telemetry.enable()
    try:
        with deterministic_cudnn():
            # (a) + (e) + (g): off, armed clean, armed with the probe
            off, _ = guard_run(mx, K, net, data, GUARD_EPOCHS)
            clean, mod = guard_run(mx, K, net, data, GUARD_EPOCHS, guard(),
                                   sync=True)
            roof_ok = guard_roofline_row(
                mx, mod, net, {"data": (GUARD_BATCH,) + TWIN_IMAGE,
                               "softmax_label": (GUARD_BATCH,)},
                GUARD_NETWORK, card)
            probe, _ = guard_run(mx, K, net, data, GUARD_EPOCHS,
                                 guard(sdc_probe_period=GUARD_PROBE))
            probed = probe["guardian"]["sdc_checks"]
            gates = {
                "bitwise": off["digest"] == clean["digest"]
                == probe["digest"],
                "post_warmup_compiles_0": all(
                    r["post_warmup_compiles"] == 0
                    for r in (off, clean, probe)),
                "sdc_checks": probed == GUARD_EPOCHS * GUARD_BATCHES
                // GUARD_PROBE,
                "sdc_mismatches_0": probe["guardian"]["sdc_mismatches"] == 0,
                "bn_launches": off["launches"] == clean["launches"] == {
                    "bn_fwd": per_step, "bn_bwd": per_step} and
                probe["launches"]["bn_fwd"] == probe["launches"]["bn_bwd"]
                == per_step + GUARD_BN * probed,
                "roofline_flops": roof_ok}
            emit({"phase": "guardian_off_armed_probe", "off": off,
                  "clean": clean, "probe": probe, "gates": gates,
                  "card": card})
            failed += ["(a) " + k for k, ok in gates.items() if not ok]

            # (b): two numeric faults healed by rollback-and-skip
            fault_b, _ = guard_run(mx, K, net, data, GUARD_EPOCHS, guard(),
                                   plan=GUARD_PLAN_B, checkpoint=True)
            ref_b, _ = guard_run(mx, K, net, data, GUARD_EPOCHS, guard(),
                                 skips={(1, 2), (2, 1)}, checkpoint=True)
            gates = {
                "bitwise_vs_excluded": fault_b["digest"] == ref_b["digest"],
                "incidents_as_planned": [
                    (i["kind"], i["ctx"]["epoch"], i["ctx"]["nbatch"])
                    for i in fault_b["incidents"]] == [
                        ("grad_nonfinite", 1, 2), ("loss_spike", 2, 1)],
                "unfired_none": fault_b["unfired"] == [],
                "one_event_per_fault": [
                    (e["epoch"], e["nbatch"])
                    for e in fault_b["rollback_events"]] == [(1, 2), (2, 1)],
                "onto_committed_entries": [
                    e["restore_step"] for e in fault_b["rollback_events"]]
                == [0, 1],
                "bn_launches": all(
                    r["launches"] == {"bn_fwd": GUARD_BN * r["steps"],
                                      "bn_bwd": GUARD_BN * r["steps"]}
                    for r in (fault_b, ref_b)),
                "post_warmup_compiles_0":
                    fault_b["post_warmup_compiles"] == 0}
            emit({"phase": "guardian_rollback", "plan": GUARD_PLAN_B,
                  "fault": fault_b, "reference": ref_b,
                  "replayed_steps": fault_b["steps"] - ref_b["steps"],
                  "gates": gates, "card": card})
            failed += ["(b) " + k for k, ok in gates.items() if not ok]
            failed += guard_twin(root, card)

            # (c): a read-path SDC at restore, a forced probe mismatch
            fault_c, _ = guard_run(mx, K, net, data, GUARD_EPOCHS, guard(),
                                   plan=GUARD_PLAN_C_RESTORE,
                                   checkpoint=True)
            ref_c, _ = guard_run(mx, K, net, data, GUARD_EPOCHS, guard(),
                                 skips={(2, 1)}, checkpoint=True)
            sdc, _ = guard_run(mx, K, net, data, GUARD_EPOCHS,
                               guard(sdc_probe_period=GUARD_PROBE),
                               plan=GUARD_PLAN_C_SDC)
            skipped = {tuple(c) for c in sdc["guardian"]["skipped"]}
            ref_sdc, _ = guard_run(mx, K, net, data, GUARD_EPOCHS,
                                   guard(sdc_probe_period=GUARD_PROBE),
                                   skips=skipped)
            gates = {
                "restore_walks_back": fault_c["restore_fallbacks"] >= 1 and
                [e["restore_step"] for e in fault_c["rollback_events"]]
                == [0],
                "restore_bitwise_vs_excluded":
                    fault_c["digest"] == ref_c["digest"],
                "sdc_flag": [e["flags"] for e in sdc["rollback_events"]]
                == [HEALTH_SDC_MISMATCH],
                "sdc_rolled_back": sdc["guardian"]["rollbacks"] == 1 and
                skipped == {(0, GUARD_PROBE)},
                "sdc_bitwise_vs_excluded":
                    sdc["digest"] == ref_sdc["digest"],
                "unfired_none": fault_c["unfired"] == sdc["unfired"] == []}
            emit({"phase": "guardian_sdc", "restore": fault_c,
                  "restore_reference": ref_c, "probe": sdc,
                  "probe_reference": ref_sdc, "gates": gates,
                  "card": card})
            failed += ["(c) " + k for k, ok in gates.items() if not ok]

            # (d): transients heal to the fault-free digest; a corrupted
            # shard falls back to the previous entry
            g_d = guard()
            fault_d, _ = guard_run(mx, K, net, data, GUARD_EPOCHS, g_d,
                                   plan=GUARD_PLAN_D, checkpoint=True,
                                   prefetch=2)
            ref_d, _ = guard_run(mx, K, net, data, GUARD_EPOCHS, guard(),
                                 checkpoint=True, prefetch=2)
            restored = g_d.manager.restore().step
            gates = {
                "healed_bitwise": fault_d["digest"] == ref_d["digest"]
                == clean["digest"],
                "retried": fault_d["retries"] >= 2,
                "shard_fallback": restored == GUARD_EPOCHS - 2,
                "unfired_none": fault_d["unfired"] == []}
            emit({"phase": "guardian_transients", "plan": GUARD_PLAN_D,
                  "fault": fault_d, "reference": ref_d,
                  "restored_step": restored, "gates": gates, "card": card})
            failed += ["(d) " + k for k, ok in gates.items() if not ok]

            # (f) + (g): ResNet-50 f32, 6 steps, armed against unarmed
            r50 = mx.models.get_symbol("resnet-50", num_classes=1000,
                                       image_shape=IMAGE)
            rs = np.random.RandomState(17)
            rows = GUARD_R50_BATCHES * BATCH
            r50_data = (rs.randn(rows, *IMAGE).astype(np.float32),
                        rs.randint(0, 1000, rows).astype(np.float32), BATCH)
            un, _ = guard_run(mx, K, r50, r50_data, 2, sync=True)
            un_roof = guard_timeline_roofline()
            armed, mod50 = guard_run(mx, K, r50, r50_data, 2, guard(),
                                     sync=True)
            r50_ok = guard_roofline_row(
                mx, mod50, r50, {"data": (BATCH,) + IMAGE,
                                 "softmax_label": (BATCH,)},
                "resnet-50", card)
            word_ms = guard_word_cost(mx, mod50)
            steps50 = 2 * GUARD_R50_BATCHES
            gates = {"bitwise": un["digest"] == armed["digest"],
                     "bn_launches": un["launches"] == armed["launches"] == {
                         "bn_fwd": BN_PER_STEP * steps50,
                         "bn_bwd": BN_PER_STEP * steps50},
                     "roofline_flops": r50_ok}
            emit({"phase": "guardian_resnet50", "batch": BATCH,
                  "dtype": "float32", "steps": steps50, "unarmed": un,
                  "armed": armed,
                  "ms_per_step_unarmed": un_roof.get("total_ms"),
                  "ms_per_step_armed":
                      guard_timeline_roofline().get("total_ms"),
                  "word_device_ms": word_ms, "gates": gates,
                  "card": card})
            failed += ["(f) " + k for k, ok in gates.items() if not ok]
    finally:
        telemetry.disable()
        shutil.rmtree(root, ignore_errors=True)
    launches = vision_counts(K, C, R)
    emit({"phase": "guardian_kernels", "launches": launches,
          "ok": not failed, "failed": failed})
    if failed:
        raise RuntimeError("guardian phase failed: %s" % "; ".join(failed))
    return launches


# ---------------------------------------------------------------------------
# phase 18: serving's executable cache and replica warm start
# ---------------------------------------------------------------------------
SC_DEVICE = "cuda"
SC_TWIN_ARGS = ["--gpus", "0"]
SC_NETWORK = "resnet-8"           # the serve twin's net, 28² CIFAR crops
SC_BATCH = 128
SC_STEPS = 2 * 4096 // SC_BATCH   # the twin's 2 epochs of 4,096 images
SC_MAX_BATCH = 32                 # buckets 2, 4, 8, 16, 32
SC_TIME_BUCKETS = (2, 32)
SC_ROWS = (1, 3, 8, 17, 32, 45)   # pad, exact, chunked requests
SC_CALIB_MAX_BATCH = 4            # the calibration check's buckets: 2, 4
SC_DAMAGE_MAX_BATCH = 4           # the damaged-entry checks' buckets: 2, 4
SC_DAMAGE_ROWS = (1, 3, 4, 7)     # pad, exact, chunked over bucket 4
SC_DEMO_ITERS = 20
SC_DEMO_ARGS = ["--gpus", "0", "--iter-num", str(SC_DEMO_ITERS), "--size",
                "512"]
SC_HOWTO_ARGS = ["--gpus", "0"]


def sc_ctx(mx):
    return mx.cpu() if SC_DEVICE == "cpu" else mx.gpu(0)


def sc_sync():
    import torch
    if SC_DEVICE != "cpu":
        torch.cuda.synchronize()


def serve_twin(args, cwd):
    """The serve twin in a process of its own, as a user runs it: (exit
    code, its SERVE_CIFAR10 numbers or None, seconds, output tail)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("MXNET_COMPILE_CACHE_DIR", None)
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.examples.serve_cifar10"]
        + SC_TWIN_ARGS + args, capture_output=True, text=True, timeout=600,
        cwd=cwd, env=env)
    lines = [ln for ln in res.stdout.splitlines()
             if ln.startswith("SERVE_CIFAR10 ")]
    out = json.loads(lines[-1][len("SERVE_CIFAR10 "):]) if lines else None
    return (res.returncode, out, time.time() - t0,
            res.stdout[-1500:] + res.stderr[-3000:])


def sc_cold(mx, work, card, check):
    """(a) the cold replica (trains, checkpoints, serves, commits) in a
    process of its own. Returns its numbers and the checkpoint
    directory."""
    per_step = sum(model_bn_shapes(mx, SC_NETWORK, (3, 28, 28), 10,
                                   SC_BATCH).values())
    ck, cache = os.path.join(work, "ck"), os.path.join(work, "cache")
    on_card = SC_DEVICE != "cpu"   # the CPU runs plain BN and no nvcc
    rc, cold, sec, tail = serve_twin(
        ["--checkpoint-dir", ck, "--cache-dir", cache, "--slo-report",
         "--digest-out", os.path.join(work, "cold.sha")], work)
    cold = cold or {}
    want_bn = per_step * SC_STEPS if on_card else 0
    buckets = sorted(cold.get("warmup", {}), key=int)
    check("cold replica", rc == 0 and cold.get("train_steps") == SC_STEPS
          and cold.get("bn_fwd_launches") == want_bn
          and cold.get("bn_bwd_launches") == want_bn
          and cold.get("nvcc_builds") == int(on_card)
          and cold.get("traces") == len(buckets) == 5
          and {r["source"] for r in cold["warmup"].values()} == {"compiled"},
          {"phase": "serve_cache_cold", "exit_code": rc, "seconds": sec,
           "bn_per_step": per_step, "bn_want": want_bn,
           "numbers": cold, "tail": None if rc == 0 else tail,
           "card": card})
    return cold, ck


def sc_warm(work, card, check, cold):
    """(b) the warm replica, in another process on the cold one's
    checkpoint and cache directory."""
    ck, cache = os.path.join(work, "ck"), os.path.join(work, "cache")
    buckets = sorted(cold.get("warmup", {}), key=int)
    rc, warm, sec, tail = serve_twin(
        ["--checkpoint-dir", ck, "--cache-dir", cache, "--expect-warm",
         "--digest-out", os.path.join(work, "warm.sha")], work)
    warm = warm or {}
    check("warm replica", rc == 0 and warm.get("nvcc_builds") == 0
          and warm.get("traces") == 0 and warm.get("compiles") == 0
          and warm.get("warmup_compiles") == 0
          and warm.get("bn_fwd_launches") == 0
          and warm.get("bn_bwd_launches") == 0
          and warm.get("train_steps") == 0
          and {r["source"] for r in warm.get("warmup", {}).values()} ==
          {"deserialized"}
          and warm.get("digest") == cold.get("digest") is not None,
          {"phase": "serve_cache_warm", "exit_code": rc, "seconds": sec,
           "numbers": warm, "digest_equal":
               warm.get("digest") == cold.get("digest"),
           "tail": None if rc == 0 else tail, "card": card})
    emit({"phase": "serve_cache_warmup_ms", "card": card, "buckets": {
        b: {"cold_ms": cold["warmup"][b]["warmup_ms"],
            "warm_ms": warm.get("warmup", {}).get(b, {}).get("warmup_ms")}
        for b in buckets}})


def sc_predictor(mx, mod, cache=None, top=SC_MAX_BATCH):
    from mxnet_tpu_torch.serving import Predictor
    pred = Predictor(mod, data_shapes=[("data", (SC_BATCH, 3, 28, 28))],
                     max_batch_size=top)
    pred.warmup(cache_dir=cache)
    return pred


def sc_sources(pred):
    return sorted(r["source"] for r in pred.warmup_report().values())


def sc_damaged_entries(mx, mod, X, cache, check):
    """(c) a tampered, a truncated and a ``.tmp-*`` entry of the cold
    twin's cache, each under a replica of buckets 2 and 4: it re-traces
    exactly the damaged bucket and serves a cache-less replica's rows
    bit for bit; the replica after the three loads both again."""
    import glob
    import numpy as np
    from mxnet_tpu_torch.serving.cache import ExecutableCache
    aot = os.path.join(cache, "aot")
    store = ExecutableCache(aot)
    eager = sc_predictor(mx, mod, top=SC_DAMAGE_MAX_BATCH)
    want = {n: eager.predict(X[:n]) for n in SC_DAMAGE_ROWS}
    paths = {b: store.path_for(eager._bucket_cache_key(
        eager._modules[b]._exec_group, b)) for b in eager.buckets}
    eager.release()

    def flip(path):
        blob = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(blob[:-10] + bytes([blob[-10] ^ 0xFF]) + blob[-9:])

    def truncate(path):
        blob = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(blob[:len(blob) // 2])

    def partial(path):
        os.rename(path, os.path.join(aot, ".tmp-%s-deadbeef"
                                     % os.path.basename(path)))

    for b, name, damage in ((2, "tampered", flip), (4, "truncated", truncate),
                            (2, "tmp_partial", partial)):
        damage(paths[b])
        pred = sc_predictor(mx, mod, cache, top=SC_DAMAGE_MAX_BATCH)
        same = all(np.array_equal(pred.predict(X[:n]), want[n])
                   for n in SC_DAMAGE_ROWS)
        rep = pred.warmup_report()
        pred.release()
        check("%s entry" % name,
              rep[b]["source"] == "compiled" and all(
                  r["source"] == "deserialized" for k, r in rep.items()
                  if k != b) and same,
              {"phase": "serve_cache_%s" % name, "bucket": b,
               "sources": {k: r["source"] for k, r in rep.items()},
               "rows_bitwise": same,
               "tmp_files": len(glob.glob(os.path.join(aot, ".tmp-*")))})
    healed = sc_predictor(mx, mod, cache, top=SC_DAMAGE_MAX_BATCH)
    srcs = sc_sources(healed)
    healed.release()
    check("healed entries", set(srcs) == {"deserialized"},
          {"phase": "serve_cache_healed", "sources": srcs})


def sc_calibration(mx, mod, X, work, check):
    """(c) two calibrations of one net under ``int8_serve``: the replica
    warmed from the second table serves its own scales: rows that differ
    from the first table's and equal a cache-less predictor's bit for
    bit."""
    import numpy as np
    from mxnet_tpu_torch.precision import quant
    from mxnet_tpu_torch.serving import Predictor
    arg, aux = mod._arg_params, mod._aux_params    # the restored entry
    shapes = [("data", (SC_MAX_BATCH, 3, 28, 28))]
    top = SC_CALIB_MAX_BATCH

    def module(precision):
        m = mx.mod.Module(mod.symbol, context=sc_ctx(mx), precision=precision)
        m.bind(data_shapes=shapes, for_training=False)
        m.init_params(arg_params=arg, aux_params=aux)
        return m

    rs = np.random.RandomState(5)
    tables = []
    for scale in (1.0, 4.0):
        xs = (rs.rand(4 * SC_MAX_BATCH, 3, 28, 28) * scale).astype(
            np.float32)
        tables.append(quant.calibrate(module(None), mx.io.NDArrayIter(
            xs, None, batch_size=SC_MAX_BATCH), num_batches=4))
    cache = os.path.join(work, "calib")
    preds = []
    for t in tables:
        p = Predictor(module("int8_serve"), max_batch_size=top,
                      calibration=t)
        p.warmup(cache_dir=cache)
        preds.append(p)
    plain = Predictor(module("int8_serve"), max_batch_size=top,
                      calibration=tables[1])
    plain.warmup()
    x = X[:top]
    ra, rb, rp = preds[0].predict(x), preds[1].predict(x), plain.predict(x)
    srcs = [sc_sources(p) for p in preds]
    for p in preds + [plain]:
        p.release()
    check("calibrations apart",
          tables[0].digest() != tables[1].digest()
          and set(srcs[1]) == {"compiled"} and not np.array_equal(ra, rb)
          and np.array_equal(rb, rp),
          {"phase": "serve_cache_calibration", "sources": srcs,
           "rows_differ": not np.array_equal(ra, rb),
           "rows_equal_cacheless": bool(np.array_equal(rb, rp)),
           "max_abs_diff_a_b": float(np.abs(ra - rb).max())})


def sc_decode(mx, work, check):
    """(c) DecodeEngine cold → warm through the cache: streams bit for bit
    with the eager engine's, no trace on the warm side."""
    from mxnet_tpu_torch.serving import cache as serving_cache
    # prefill buckets up to 4 (longer prompts chunk): state init, the
    # step and one prefill program
    cfg = dict(DECODE_LSTM, requests=8, new_tokens=32, max_prefill_len=4)
    model = decode_model(cfg)
    params = model.init_params(seed=cfg["seed"])
    prompts = decode_prompts(cfg)
    runs = []
    for cache in (None, os.path.join(work, "decode"),
                  os.path.join(work, "decode")):
        eng = decode_engine(mx, cfg, model, params, sc_ctx(mx), 0.8)
        t0, traces0 = time.perf_counter(), serving_cache.traces
        rep = eng.warmup(cache_dir=cache)
        warm_s = time.perf_counter() - t0
        reqs = [eng.submit(p, max_new_tokens=cfg["new_tokens"], seed=i)
                for i, p in enumerate(prompts)]
        eng.start()
        streams = [r.result(timeout=600) for r in reqs]
        eng.shutdown(drain=True)
        runs.append({"sources": sorted({r["source"] for r in rep.values()}),
                     "traces": serving_cache.traces - traces0,
                     "compiles": eng.stats()["compiles"],
                     "warmup_s": warm_s, "streams": streams})
        eng.release()
    eager, cold, warm = runs
    check("decode cold/warm",
          cold["sources"] == ["compiled"] and warm["sources"] ==
          ["deserialized"] and warm["traces"] == 0 and
          warm["compiles"] == 0 and
          eager["streams"] == cold["streams"] == warm["streams"],
          {"phase": "serve_cache_decode",
           "runs": [{k: v for k, v in r.items() if k != "streams"}
                    for r in runs],
           "streams_bitwise": eager["streams"] == cold["streams"] ==
           warm["streams"]})


def sc_times(mx, eager, cached, X, card):
    """(d) at buckets 2 and 32: the exported program against the eager
    executor, as phase 8 times the bucket forward (CUDA events around one
    call, median of 10 after 3; host enqueue) and ``Predictor.predict``
    on exactly ``b`` rows (median of 10)."""
    import torch
    from mxnet_tpu_torch.tools.bn_probe import cuda_time, enqueue_us
    rows = []
    for b in SC_TIME_BUCKETS:
        x = X[:b]
        grp = cached._modules[b]._exec_group
        dev = grp.contexts[0].torch_device()
        args = cached._program_args(grp, {"data": torch.from_numpy(x).to(
            dev)})
        program = cached._programs[b]
        eager.predict(x)          # the bound data holds the request
        ex = eager._modules[b]._exec_group.execs[0]

        def eager_fwd():
            ex.forward(is_train=False)

        def program_fwd():
            with torch.no_grad():
                program(*args)

        row = {"bucket": b, "card": card}
        for name, fn in (("eager", eager_fwd), ("exported", program_fwd)):
            row[name + "_forward_event_ms"] = cuda_time(fn, reps=10, warm=3)
            row[name + "_forward_enqueue_ms"] = enqueue_us(fn, 10) / 1e3
        for name, pred in (("eager", eager), ("exported", cached)):
            for _ in range(3):
                pred.predict(x)
            calls = []
            for _ in range(10):
                t0 = time.perf_counter()
                pred.predict(x)
                calls.append(1e3 * (time.perf_counter() - t0))
            row[name + "_call_ms"] = statistics.median(calls)
        rows.append(row)
        emit(dict(row, phase="serve_cache_times"))
    return rows


def sc_howtos(work, card, check):
    """(d) the profiler twin's dump on the card, and the debug_conv and
    memcost twins with their scripts' asserts."""
    from mxnet_tpu_torch.examples import debug_conv, memcost, profiler_demo
    out = os.path.join(work, "profile_matmul.json")
    t0 = time.time()
    res = profiler_demo.main(SC_DEMO_ARGS + ["--output", out])
    cats = {}
    for e in res["events"]:
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
    kernels = sorted({e["name"] for e in res["events"]
                      if e.get("cat") == "kernel"})
    check("profiler demo", {e["name"] for e in res["events"]} >=
          {"matmul_%d" % i for i in range(SC_DEMO_ITERS)},
          {"phase": "serve_cache_profiler_demo", "events": len(res["events"]),
           "by_cat": cats, "kernel_names": kernels[:8],
           "bytes": os.path.getsize(out), "seconds": time.time() - t0,
           "card": card})
    res = debug_conv.main(SC_HOWTO_ARGS)
    check("debug_conv", any("conv1" in k for k in res["taps"]),
          {"phase": "serve_cache_debug_conv", "taps": sorted(res["taps"])})
    t0 = time.time()
    res = memcost.main(SC_HOWTO_ARGS)
    held_p, held_s, mem_p, mem_s, fl_p, fl_s = res["evaluator"]
    held_n, held_f, mm_none, mm_full, fl_none, fl_full = res["module"]

    def mib(*bs):
        return [None if b is None else b / 2**20 for b in bs]

    check("memcost", True,
          {"phase": "serve_cache_memcost", "card": card,
           "evaluator_held_mib": mib(held_p, held_s),
           "evaluator_peak_mib": mib(mem_p, mem_s),
           "evaluator_flops": [fl_p, fl_s],
           "module_step_held_mib": mib(held_n, held_f),
           "module_step_peak_mib": mib(mm_none, mm_full),
           "module_step_flops": [fl_none, fl_full],
           "seconds": time.time() - t0})


def serve_cache_phase(mx, K, C, R, card):
    """Phase 18 (module docstring). Returns the kernels' launches: the BN
    pair's from the cold replica's training, every in-process count 0."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    failed = []

    def check(name, ok, row):
        emit(dict(row, ok=bool(ok)))
        if not ok:
            failed.append(name)

    vision_zero(K, C, R)
    work = tempfile.mkdtemp(prefix="serve_cache_", dir=os.path.join(
        ROOT, "build"))
    try:
        cold, ck = sc_cold(mx, work, card, check)
        mod = mx.mod.Module.load(ck, context=sc_ctx(mx))
        X = np.random.RandomState(3).rand(
            max(SC_ROWS), 3, 28, 28).astype(np.float32)
        # the warm replica's process reads only the cold one's checkpoint
        # and cache, which nothing here writes until it is done: the
        # checks on directories of their own run beside it
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(1) as runner:
            warm = runner.submit(sc_warm, work, card, check, cold)
            sc_calibration(mx, mod, X, work, check)
            sc_decode(mx, work, check)
            sc_howtos(work, card, check)
            warm.result()
        eager = sc_predictor(mx, mod)
        want = {n: eager.predict(X[:n]) for n in SC_ROWS}
        # this process loads what the cold twin's process committed
        cache = os.path.join(work, "cache")
        cached = sc_predictor(mx, mod, cache)
        same = all(np.array_equal(cached.predict(X[:n]), want[n])
                   for n in SC_ROWS)
        check("exported rows", same and set(sc_sources(cached)) ==
              {"deserialized"},
              {"phase": "serve_cache_rows", "rows": list(SC_ROWS),
               "sources": sc_sources(cached), "bitwise_vs_eager": same})
        sc_times(mx, eager, cached, X, card)
        eager.release()
        cached.release()
        sc_damaged_entries(mx, mod, X, cache, check)
        sc_sync()
        inproc = vision_counts(K, C, R)
        check("kernels in process", not any(inproc.values()),
              {"phase": "serve_cache_kernels", "in_process": inproc,
               "cold_replica_bn": [cold.get("bn_fwd_launches"),
                                   cold.get("bn_bwd_launches")]})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if failed:
        raise RuntimeError("serve_cache phase failed: %s" % "; ".join(failed))
    return dict(inproc, bn_fwd=cold["bn_fwd_launches"],
                bn_bwd=cold["bn_bwd_launches"])


# ---------------------------------------------------------------------------
# phase 19: dist (multi-process data parallelism)
# ---------------------------------------------------------------------------
DIST_DEVICE = "cuda"
DIST_ONE_BACKEND = "nccl"          # (b)
DIST_TIME_DTYPES = ("float32", "bfloat16")
DIST_FIT_NETWORK = "resnet-20"     # (b): the CIFAR twin's net and shapes
DIST_FIT_BATCH = 128
DIST_FIT_BATCHES = 4
DIST_RANKS = 2                     # (c): ranks on the one card, over gloo
DIST_RANK_BATCH = 32
DIST_STEPS = 3                     # (c): one epoch of 3 global batches
DIST_NETWORK = "resnet-50"
DIST_LR = 0.01                     # (c): 3 steps from random init stay sane
DIST_PUSH_RANKS = 3                # (d)
DIST_TWIN_ARGS = ["--gpus", "0"]
DIST_ELASTIC_ARGS = ["--gpus", "0", "--network", "resnet-20"]
DIST_SPREAD_FACTOR = 4.0           # (c): tolerance over the exact spread
DIST_REL_FLOOR = 1e-4


def dist_ctx(mx):
    return mx.cpu() if DIST_DEVICE == "cpu" else mx.gpu(0)


def free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def dist_split_case(K, inputs, dtype, relu, fix_gamma, exact, need_dx):
    """The four split entry points against their plain versions, and two
    half-batches' partials summed and applied against K1's one-call pair
    on the whole batch (the sum standing for the all-reduce of two
    ranks). Returns (row fields, ok, worst abs err per entry point)."""
    import torch
    x, gamma, beta, c, du = inputs
    n = float(x.numel() // x.shape[1])
    centre = c.float()
    worst = dict.fromkeys(K.SPLIT_KERNELS, 0.0)
    reds, outs = [], []
    if exact:
        s0 = K.bn_fwd_partials(x, None)
        reds.append(reduction_error(s0, K.bn_fwd_partials_plain(x, None)))
        centre = s0[:, 0] / n
    s = K.bn_fwd_partials(x, centre)
    sp = K.bn_fwd_partials_plain(x, centre)
    reds.append(reduction_error(s, sp))
    f = K.bn_fwd_apply(x, sp, centre, gamma, beta, EPS, n, fix_gamma, relu,
                       exact)
    fp = K.bn_fwd_apply_plain(x, sp, centre, gamma, beta, EPS, n,
                              fix_gamma, relu, exact)
    _, mean, _, rstd, scale, shift = fp
    g = K.bn_bwd_partials(du, x, mean, rstd, scale, shift, relu)
    gp = K.bn_bwd_partials_plain(du, x, mean, rstd, scale, shift, relu)
    reds.append(reduction_error(g, gp))
    dx = K.bn_bwd_dx(du, x, mean, rstd, scale, shift, gp, n, relu)
    dxp = K.bn_bwd_dx_plain(du, x, mean, rstd, scale, shift, gp, n, relu)
    torch.cuda.synchronize()
    y_err, y_bad = compare_outputs(f[0], fp[0], dtype)
    dx_err, dx_bad = compare_outputs(dx, dxp, dtype)
    reds += [reduction_error(a, b) for a, b in zip(f[1:], fp[1:])]
    worst["bn_fwd_partials"] = float((s - sp).abs().max())
    worst["bn_fwd_apply"] = y_err
    worst["bn_bwd_partials"] = float((g - gp).abs().max())
    worst["bn_bwd_dx"] = dx_err
    # two ranks: each half's partials, summed, applied on each half
    halves = [t.contiguous() for t in x.chunk(2)]
    dhalves = [t.contiguous() for t in du.chunk(2)]

    def reduce_sum(parts):
        tot = parts[0] + parts[1]
        return [tot, tot.clone()]

    if exact:
        tot = reduce_sum([K.bn_fwd_partials(h, None) for h in halves])[0]
        hcentre = tot[:, 0] / n
    else:
        hcentre = c.float()
    sums = reduce_sum([K.bn_fwd_partials(h, hcentre) for h in halves])
    hf = [K.bn_fwd_apply(h, s_, hcentre, gamma, beta, EPS, n, fix_gamma,
                         relu, exact) for h, s_ in zip(halves, sums)]
    one = K.bn_fwd(x, gamma, beta, c, EPS, fix_gamma, relu, exact)
    _, m1, _, r1, sc1, sh1 = one
    bsums = reduce_sum([K.bn_bwd_partials(d, h, m1, r1, sc1, sh1, relu)
                        for d, h in zip(dhalves, halves)])
    ob = K.bn_bwd(du, x, r1, m1, sc1, sh1, relu, need_dx=True)
    hdx = [K.bn_bwd_dx(d, h, m1, r1, sc1, sh1, s_, n, relu)
           for d, h, s_ in zip(dhalves, halves, bsums)]
    torch.cuda.synchronize()
    sy_err, sy_bad = compare_outputs(torch.cat([h[0] for h in hf]), one[0],
                                     dtype)
    sdx_err, sdx_bad = compare_outputs(torch.cat(hdx), ob[0], dtype)
    sred = max([reduction_error(a, b) for a, b in zip(hf[0][1:], one[1:])]
               + [reduction_error(bsums[0][:, 0], ob[1]),
                  reduction_error(bsums[0][:, 1], ob[2])])
    allowed = int(TOL["flip_fraction"] * x.numel())
    fields = {"y_max_abs_err": y_err, "y_outside": y_bad,
              "dx_max_abs_err": dx_err, "dx_outside": dx_bad,
              "reduction_rel_err": max(reds),
              "halves_vs_one_call": {
                  "y_max_abs_err": sy_err, "y_outside": sy_bad,
                  "dx_max_abs_err": sdx_err, "dx_outside": sdx_bad,
                  "reduction_rel_err": sred}}
    ok = (max(y_bad, dx_bad, sy_bad, sdx_bad) <= allowed
          and max(max(reds), sred) <= TOL["reduction"])
    del need_dx
    return fields, ok, worst


def dist_split_times(K, shape, dtype, relu, fix_gamma, need_dx, gen):
    """Each entry point's call ms (one CUDA-event pair), device ms (a
    CUDA graph of ``GRAPH_CALLS`` calls on their own input copies) and
    enqueue µs at one shape, its plain version's ms, its byte bound, and
    the SyncBatchNorm primitive that computes the same function
    (``batch_norm_stats``; ``batch_norm_gather_stats_with_counts`` +
    ``batch_norm_elemt``; ``batch_norm_backward_reduce``;
    ``batch_norm_backward_elemt``), which the port never calls."""
    import torch
    from mxnet_tpu_torch.tools.bn_probe import (GRAPH_CALLS, cuda_time,
                                                enqueue_us, graph_ms)
    x, gamma, beta, c, du = bn_inputs(shape, dtype, gen)
    es = x.element_size()
    numel = x.numel()
    n = float(numel // shape[1])
    centre = c.float()
    xs = [x] + [x.clone() for _ in range(GRAPH_CALLS - 1)]
    dus = [du] + [du.clone() for _ in range(GRAPH_CALLS - 1)]
    sums = K.bn_fwd_partials(x, centre)
    f = K.bn_fwd_apply(x, sums, centre, gamma, beta, EPS, n, fix_gamma,
                       relu, False)
    _, mean, _, rstd, scale, shift = f
    gsums = K.bn_bwd_partials(du, x, mean, rstd, scale, shift, relu)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    # the SyncBatchNorm primitives' inputs (a yardstick: where they do not
    # run, library_ms is None with the reason)
    lib_error = None
    try:
        smean, sinv = torch.batch_norm_stats(x, EPS)
        counts = torch.full((1,), n, device=x.device, dtype=x.dtype)
        sdy, sdyx, _, _ = torch.batch_norm_backward_reduce(
            du, x, smean, sinv, g, True, True, True)
        cnt = torch.full((1,), int(n), device=x.device, dtype=torch.int32)
    except (RuntimeError, NotImplementedError) as e:
        lib_error = str(e)[:300]
    ents = {
        "bn_fwd_partials": (
            lambda i: K.bn_fwd_partials(xs[i], centre),
            lambda: K.bn_fwd_partials_plain(x, centre),
            lambda i: torch.batch_norm_stats(xs[i], EPS), 1),
        "bn_fwd_apply": (
            lambda i: K.bn_fwd_apply(xs[i], sums, centre, gamma, beta, EPS,
                                     n, fix_gamma, relu, False),
            lambda: K.bn_fwd_apply_plain(x, sums, centre, gamma, beta, EPS,
                                         n, fix_gamma, relu, False),
            lambda i: torch.batch_norm_elemt(
                xs[i], g, beta, *torch.batch_norm_gather_stats_with_counts(
                    xs[i], smean[None], sinv[None], None, None, 0.1, EPS,
                    counts), EPS), 2),
        "bn_bwd_partials": (
            lambda i: K.bn_bwd_partials(dus[i], xs[i], mean, rstd, scale,
                                        shift, relu),
            lambda: K.bn_bwd_partials_plain(du, x, mean, rstd, scale, shift,
                                            relu),
            lambda i: torch.batch_norm_backward_reduce(
                dus[i], xs[i], smean, sinv, g, True, True, True), 2),
        "bn_bwd_dx": (
            lambda i: K.bn_bwd_dx(dus[i], xs[i], mean, rstd, scale, shift,
                                  gsums, n, relu),
            lambda: K.bn_bwd_dx_plain(du, x, mean, rstd, scale, shift,
                                      gsums, n, relu),
            lambda i: torch.batch_norm_backward_elemt(
                dus[i], xs[i], smean, sinv, g, sdy, sdyx, cnt), 3),
    }
    out = {}
    for name, (kern, plain, lib, sweeps) in ents.items():
        if name == "bn_bwd_dx" and not need_dx:
            continue
        dev, method = graph_ms([functools.partial(kern, i)
                                for i in range(GRAPH_CALLS)])
        row = {
            "ms": cuda_time(lambda: kern(0)), "device_ms": dev,
            "device_ms_by": method,
            "enqueue_us": enqueue_us(lambda: kern(0)),
            "plain_ms": cuda_time(plain, reps=5),
            "bound_ms": 1e3 * sweeps * numel * es / HBM_BYTES_PER_S}
        try:
            if lib_error is not None:
                raise RuntimeError(lib_error)
            row["library_ms"] = cuda_time(lambda: lib(0))
            row["library_device_ms"] = graph_ms(
                [functools.partial(lib, i) for i in range(GRAPH_CALLS)])[0]
        except (RuntimeError, NotImplementedError) as e:
            row["library_ms"] = row["library_device_ms"] = None
            row["library_error"] = str(e)[:300]
        out[name] = row
    del xs, dus
    return out


def dist_kernels(mx, K, card):
    """(a) At every ResNet-50 BatchNorm shape (batch 32, the main path's
    flags), in float32 and bfloat16: the four entry points against their
    plain versions, two halves against the one-call pair, exact
    statistics at two shapes, and each entry point's times. Returns the
    per-step time sums by dtype and the worst errors."""
    import torch
    gen = torch.Generator(device=DIST_DEVICE).manual_seed(19)
    r50 = model_bn_shapes(mx, DIST_NETWORK, IMAGE, 1000, BATCH)
    keys = ("ms", "device_ms", "enqueue_us", "plain_ms", "library_ms",
            "library_device_ms", "bound_ms")
    totals, worst, failures = {}, {}, []
    for dname in DIST_TIME_DTYPES:
        dtype = getattr(torch, dname)
        tot = {k: dict.fromkeys(keys, 0.0) for k in K.SPLIT_KERNELS}
        wst = dict.fromkeys(K.SPLIT_KERNELS, 0.0)
        for (shape, fix_gamma, relu, need_dx), n in sorted(r50.items()):
            exacts = (False, True) if shape[1] in (64, 2048) else (False,)
            for exact in exacts:
                fields, ok, w = dist_split_case(
                    K, bn_inputs(shape, dtype, gen), dtype, relu, fix_gamma,
                    exact, need_dx)
                row = {"phase": "dist_kernels", "shape": list(shape),
                       "dtype": dname, "relu": relu, "fix_gamma": fix_gamma,
                       "exact": exact, "per_step": n, **fields, "ok": ok}
                emit(row)
                if not ok:
                    failures.append(row)
                for k in wst:
                    wst[k] = max(wst[k], w[k])
            times = dist_split_times(K, shape, dtype, relu, fix_gamma,
                                     need_dx, gen)
            emit({"phase": "dist_kernel_times", "shape": list(shape),
                  "dtype": dname, "per_step": n, "card": card, **times})
            for name, t in times.items():
                for key in keys:
                    if tot[name][key] is None or t[key] is None:
                        tot[name][key] = None
                    else:
                        tot[name][key] += n * t[key]
        totals[dname] = tot
        worst[dname] = wst
        emit({"phase": "dist_kernel_times_per_step", "dtype": dname,
              "batch": BATCH, "card": card, **tot})
    if failures:
        raise RuntimeError("dist kernel check failed at %d case(s)"
                           % len(failures))
    return totals, worst


def dist_fit_digest(mod):
    import hashlib
    h = hashlib.sha256()
    args, auxs = mod.get_params()
    for k in sorted(args):
        h.update(args[k].asnumpy().tobytes())
    for k in sorted(auxs):
        h.update(auxs[k].asnumpy().tobytes())
    return h.hexdigest()


def dist_world_of_one(mx, card):
    """(b) A process group of one on nccl: bootstrap (telemetry), an
    all-reduce and a barrier; then resnet-20 ``fit`` with
    ``kvstore="dist_sync"`` against a plain ``fit``, bit for bit."""
    import numpy as np
    import torch
    from mxnet_tpu_torch import dist
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dist.reset_runtime()
    t0 = time.time()
    rt = dist.initialize(coordinator_address="127.0.0.1:%d" % free_port(),
                         num_processes=1, process_id=0,
                         backend=DIST_ONE_BACKEND)
    try:
        boot_s = time.time() - t0
        t = torch.arange(1024, device=DIST_DEVICE, dtype=torch.float32)
        rt.allreduce_(t)
        reduced_ok = bool(torch.equal(t, torch.arange(
            1024, device=DIST_DEVICE, dtype=torch.float32)))
        barrier_ms = rt.barrier()
        rng = np.random.RandomState(0)
        n = DIST_FIT_BATCH * DIST_FIT_BATCHES
        x = rng.rand(n, 3, 28, 28).astype(np.float32)
        y = rng.randint(0, 10, n).astype(np.float32)
        net = mx.models.get_symbol(DIST_FIT_NETWORK, num_classes=10,
                                   image_shape=(3, 28, 28))
        digests = {}
        for kv in ("local", "dist_sync"):
            mx.random.seed(7)
            mod = mx.mod.Module(net, context=dist_ctx(mx))
            mod.fit(mx.io.NDArrayIter(x, y, batch_size=DIST_FIT_BATCH),
                    num_epoch=2, kvstore=kv, optimizer="sgd",
                    optimizer_params={"learning_rate": 0.05,
                                      "momentum": 0.9},
                    initializer=mx.init.Xavier())
            digests[kv] = dist_fit_digest(mod)
        snap = mx.telemetry.registry().snapshot()
        row = {"phase": "dist_world_of_one", "backend": rt.backend,
               "rank": rt.rank, "size": rt.size, "bootstrap_s": boot_s,
               "bootstrap_ms_counter": snap["counters"].get(
                   "dist.bootstrap_ms"),
               "allreduce_identity": reduced_ok, "barrier_ms": barrier_ms,
               "fit_dist_sync_equals_plain": digests["local"]
               == digests["dist_sync"], "card": card}
        emit(row)
    finally:
        rt.shutdown()
        dist.reset_runtime()
    if not (reduced_ok and row["fit_dist_sync_equals_plain"]
            and rt.backend == DIST_ONE_BACKEND):
        raise RuntimeError("dist world of one failed: %s" % row)


def dist_twin_cmd(pack, out, batch, extra=()):
    return [sys.executable, "-m", "mxnet_tpu_torch.examples.train_imagenet",
            *DIST_TWIN_ARGS, "--network", DIST_NETWORK, "--image-shape",
            ",".join(map(str, IMAGE)), "--lr", str(DIST_LR),
            "--batch-size", str(batch),
            "--data-train", pack, "--num-epochs", "1", "--seed", "7",
            "--save-params", out, *extra]


def dist_run(cmd, cwd, env=None, timeout=600):
    res = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=timeout, cwd=cwd,
                         env=dict(os.environ, PYTHONPATH=ROOT, **(env or {})))
    if res.returncode:
        raise RuntimeError("%s exited %d:\n%s" % (
            " ".join(cmd[:6]), res.returncode,
            res.stdout[-2000:] + res.stderr[-4000:]))
    return res


def dist_loss(mx, params, x, y):
    """Softmax cross-entropy of a ResNet-50 with ``params`` on one batch,
    on the card: a training forward (batch statistics, as the steps
    computed it; the moving statistics of 3 steps are still far from
    them)."""
    import numpy as np
    sym = mx.models.get_symbol(DIST_NETWORK, num_classes=1000,
                               image_shape=IMAGE)
    mod = mx.mod.Module(sym, context=dist_ctx(mx))
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    args = {k[4:]: mx.nd.array(v, ctx=mx.cpu()) for k, v in params.items()
            if k.startswith("arg:")}
    auxs = {k[4:]: mx.nd.array(v, ctx=mx.cpu()) for k, v in params.items()
            if k.startswith("aux:")}
    mod.init_params(arg_params=args, aux_params=auxs)
    mod.forward(mx.io.DataBatch([mx.nd.array(x, ctx=dist_ctx(mx))],
                                [mx.nd.array(y, ctx=dist_ctx(mx))]),
                is_train=True)
    p = mod.get_outputs()[0].asnumpy()
    return float(-np.log(np.maximum(
        p[np.arange(len(y)), y.astype(int)], 1e-30)).mean())


def dist_two_ranks(mx, K, card, work, beside=None):
    """(c) ResNet-50 trained by two ranks on the one card over gloo,
    launched by tools/launch.py through the ImageNet twin with
    ``--kv-store dist_sync`` (32 rows a rank, ``DIST_STEPS`` steps),
    against one process at batch 64 from the same seed and stream: the
    parameters' relative L2 and the loss on a fixed batch within
    max(``DIST_REL_FLOOR``, ``DIST_SPREAD_FACTOR`` × the one-process run's
    own spread between the one-pass and the exact statistics). Every
    rank's launch counts: each split entry point 51 a step (the data's
    BatchNorm has no dx: 50 for ``bn_bwd_dx``), the one-call pair 0."""
    import numpy as np
    glob_batch = DIST_RANKS * DIST_RANK_BATCH
    pack = os.path.join(work, "dist.rec")
    write_pack(pack, glob_batch * DIST_STEPS, IMAGE, 8)
    outs = {k: os.path.join(work, k + ".npz")
            for k in ("dist", "one", "one_exact")}
    t0 = time.time()
    res = dist_run([sys.executable, os.path.join(ROOT, "tools", "launch.py"),
                    "-n", str(DIST_RANKS), "--launcher", "local"]
                   + dist_twin_cmd(pack, outs["dist"], DIST_RANK_BATCH,
                                   ["--kv-store", "dist_sync"]),
                   work, env={"MXNET_DIST_BACKEND": "gloo"})
    dist_s = time.time() - t0
    ranks = [json.loads(ln.split("DIST_TWIN ", 1)[1])
             for ln in res.stdout.splitlines() if ln.startswith("DIST_TWIN ")]
    # the two single processes at the global batch are independent: at
    # once, and ``beside`` (a check of processes of its own) with them
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.time()
    with ThreadPoolExecutor(3) as runner:
        singles = [runner.submit(dist_run, dist_twin_cmd(
            pack, outs["one"], glob_batch), work),
            runner.submit(dist_run, dist_twin_cmd(
                pack, outs["one_exact"], glob_batch), work,
                {"MXNET_BN_EXACT_STATS": "1"})]
        if beside is not None:
            singles.append(runner.submit(beside))
        for f in singles:
            f.result()
    one_s = time.time() - t0
    p = {k: dict(np.load(v)) for k, v in outs.items()}
    names = sorted(n for n in p["one"] if n.startswith("arg:"))

    def flat(d):
        return np.concatenate([d[n].ravel() for n in names])

    # the parameters as one vector: a key of a tiny norm (a β near 0) would
    # make a per-key ratio meaningless
    spread = rel_l2(flat(p["one_exact"]), flat(p["one"]))
    tol = max(DIST_REL_FLOOR, DIST_SPREAD_FACTOR * spread)
    params_rel = rel_l2(flat(p["dist"]), flat(p["one"]))
    worst_key = max(names, key=lambda n: float(np.linalg.norm(
        p["dist"][n] - p["one"][n])))
    rs = np.random.RandomState(5)
    xb = rs.randn(glob_batch, *IMAGE).astype(np.float32)
    yb = rs.randint(0, 8, glob_batch).astype(np.float32)
    loss = {k: dist_loss(mx, p[k], xb, yb) for k in ("dist", "one")}
    loss_rel = abs(loss["dist"] - loss["one"]) / max(abs(loss["one"]), 1e-30)
    bns = model_bn_shapes(mx, DIST_NETWORK, IMAGE, 1000, DIST_RANK_BATCH)
    n_bn = sum(bns.values())
    want = {n: DIST_STEPS * n_bn for n in K.SPLIT_KERNELS}
    want["bn_bwd_dx"] = DIST_STEPS * sum(v for k, v in bns.items() if k[3])
    if DIST_DEVICE == "cpu":    # a rehearsal: plain versions, no launches
        want = dict.fromkeys(want, 0)
    counts_ok = len(ranks) == DIST_RANKS and all(
        r["steps"] == DIST_STEPS
        and all(r["launches"][n] == want[n] for n in K.SPLIT_KERNELS)
        and r["launches"]["bn_fwd"] == 0 and r["launches"]["bn_bwd"] == 0
        for r in ranks)
    row = {"phase": "dist_two_ranks", "network": DIST_NETWORK,
           "ranks": DIST_RANKS, "rank_batch": DIST_RANK_BATCH,
           "steps": DIST_STEPS, "backend": "gloo", "card": card,
           "per_rank": ranks, "two_rank_s": dist_s,
           "one_process_pair_s": one_s,
           "params_rel_l2": params_rel, "largest_diff_param": worst_key,
           "loss": loss, "loss_rel": loss_rel,
           "exact_spread_rel_l2": spread, "tolerance": tol,
           "expected_launches_per_rank": want, "launches_ok": counts_ok}
    emit(row)
    if not (counts_ok and params_rel <= tol and loss_rel <= tol
            and tol < 0.5):
        raise RuntimeError("two-rank ResNet-50 check failed: %s"
                           % json.dumps(row))
    total = {}
    for r in ranks:
        for name, v in r["launches"].items():
            total[name] = total.get(name, 0) + v
    return total, [r["launches"] for r in ranks]


def dist_push_pull(work, card):
    """(d) Three ranks' push/pull of card tensors over gloo
    (``mxnet_tpu_torch.tools.dist_worker sync`` with ``DIST_CTX=gpu``):
    the exact sums of dist_sync, and dist_async one push late."""
    rows = []
    for kind in ("dist_sync", "dist_async"):
        port = free_port()
        procs = []
        for rank in range(DIST_PUSH_RANKS):
            env = dict(os.environ, PYTHONPATH=ROOT,
                       DIST_CTX="cpu" if DIST_DEVICE == "cpu" else "gpu",
                       DIST_KV_TYPE=kind, MXNET_DIST_BACKEND="gloo",
                       DMLC_NUM_WORKER=str(DIST_PUSH_RANKS),
                       DMLC_WORKER_ID=str(rank), DMLC_ROLE="worker",
                       DMLC_PS_ROOT_URI="127.0.0.1",
                       DMLC_PS_ROOT_PORT=str(port))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "mxnet_tpu_torch.tools.dist_worker",
                 "sync"], env=env, cwd=work, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = []
        try:
            for p in procs:
                outs.append((p.communicate(timeout=300)[0], p.returncode))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        ok = all(rc == 0 and "DIST_WORKER_OK" in out for out, rc in outs)
        row = {"phase": "dist_push_pull", "kind": kind,
               "ranks": DIST_PUSH_RANKS, "device": DIST_DEVICE, "ok": ok,
               "card": card}
        emit(row)
        if not ok:
            raise RuntimeError("%s push/pull failed:\n%s" % (
                kind, "\n".join(out[-1500:] for out, _ in outs)))
        rows.append(row)
    return rows


def dist_elastic(mx, K, card):
    """(e) The elastic twin on the card: 4 virtual hosts → 2, the resume
    bit for bit equal to the continuous width-2 run (its own assert), at
    resnet-20 width and with the JAX script's MLP (and its accuracy
    assert)."""
    from mxnet_tpu_torch.examples import elastic_virtual_hosts
    rows = []
    for args in (DIST_ELASTIC_ARGS, DIST_TWIN_ARGS):
        t0 = time.time()
        res = elastic_virtual_hosts.main(list(args))
        row = {"phase": "dist_elastic", "args": list(args),
               "seconds": time.time() - t0, "accuracy": res["accuracy"],
               "resume_step": res["resume_step"],
               "num_update": res["num_update"],
               "widths": [e["dp_width"] for e in res["transcript"]],
               "card": card}
        emit(row)
        rows.append(row)
    return rows


def dist_phase(mx, K, C, R, card):
    """Phase 19: (a) the split BatchNorm entry points, (b) a world of one
    on nccl, (c) two ranks of ResNet-50 through tools/launch.py, (d)
    three ranks' push/pull, (e) the elastic twin. Returns the launch
    counts of (c) (summed over the ranks) and per rank, and (a)'s times
    and errors."""
    import shutil
    import tempfile
    import torch
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    t = {}
    t0 = time.time()
    totals, worst = dist_kernels(mx, K, card)
    t["a"] = time.time() - t0
    t0 = time.time()
    dist_world_of_one(mx, card)
    t["b"] = time.time() - t0
    work = tempfile.mkdtemp(prefix="dist_phase_", dir=os.path.join(
        ROOT, "build"))
    try:
        t0 = time.time()
        # (d) runs beside (c)'s two single processes
        launches, by_rank = dist_two_ranks(
            mx, K, card, work, beside=lambda: dist_push_pull(work, card))
        t["c_and_d"] = time.time() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    t0 = time.time()
    dist_elastic(mx, K, card)
    t["e"] = time.time() - t0
    emit({"phase": "dist_seconds", **t})
    return launches, by_rank, totals, worst


# ---------------------------------------------------------------------------
# phase 20: the network serving plane (gateway, autopilot, scenarios)
# ---------------------------------------------------------------------------
GW_DEVICE = "cuda"
GW_NETWORK = "resnet-50"
GW_IMAGE = (3, 224, 224)
GW_CLASSES = 1000
GW_MAX_BATCH = 32                 # buckets 2, 4, 8, 16, 32 (phase 18's)
GW_CANARY_BUCKETS = [2, 8]        # (b)'s stable and canary Predictors
GW_REQUESTS = 64
GW_CLIENTS = 8
GW_REQUEST_ROWS = (1,)            # cycled over the requests: the JSON of
#                                   one 224² row is ~3 MB a way
GW_TIME_ROWS = 8                  # bucket 8
GW_TIME_REPS = 5
GW_DIRECT_REPS = 20
GW_DRAIN_ROWS = 8
GW_STREAMS = 8
GW_HAMMER_THREADS = 4
GW_TICK_S = 0.2                   # between (b)'s ticks: the hammer threads
#                                   serve across every change of the pool
GW_PEER_NETWORK = "resnet-20"     # the CIFAR twin's net and crops
GW_PEER_IMAGE = (3, 28, 28)
GW_PEER_ROWS, GW_PEER_BATCH, GW_PEER_EPOCHS = 256, 32, 2   # 16 steps
GW_PEER_EVERY = 2                 # a commit (and a capture) every 2 steps
GW_PEER_FAULT = (6, (1, 3))       # hosts 1 and 3 lost at update 6
GW_PEER_BN = 20                   # BatchNorms of resnet-20, each kernel


def gw_ctx(mx):
    return mx.cpu() if GW_DEVICE == "cpu" else mx.gpu(0)


def gw_counts(K, C, R):
    """Every kernel's launch count: phase 16's and the split entry
    points."""
    return dict(vision_counts(K, C, R),
                **{k: getattr(K, k).launches for k in K.SPLIT_KERNELS})


def gw_zero(K, C, R):
    vision_zero(K, C, R)
    for k in K.SPLIT_KERNELS:
        getattr(K, k).launches = 0


def gw_pct(values, p):
    vals = sorted(values)
    return vals[min(len(vals) - 1, int(round(p / 100.0 * (len(vals) - 1))))]


def gw_thread(target, name):
    import threading
    t = threading.Thread(target=target, name=name, daemon=True)
    t.start()
    return t


def gw_source(mx):
    """The served net at full width: an inference module, Xavier weights
    from ``mx.random`` seed 0, bound at the top bucket."""
    ctx = gw_ctx(mx)
    mx.random.seed(0)
    sym = mx.models.get_symbol(GW_NETWORK, num_classes=GW_CLASSES,
                               image_shape=GW_IMAGE)
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=[("data", (GW_MAX_BATCH,) + GW_IMAGE)],
             for_training=False)
    mod.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2))
    return mod


def gw_pool(src, violations):
    """A ReplicaPool of Predictors over ``src`` (1 to 2 replicas) whose
    replicas record any request that enters one after its release."""
    from mxnet_tpu_torch.autopilot import ReplicaPool
    from mxnet_tpu_torch.serving import Predictor

    class Guarded(Predictor):
        closed = False

        def predict(self, data):
            if self.closed:
                violations.append("entered a closed replica")
            out = super().predict(data)
            if self.closed:
                violations.append("closed during predict")
            return out

        def release(self):
            self.closed = True
            super().release()

    return ReplicaPool(lambda: Guarded(src, max_batch_size=GW_MAX_BATCH),
                       min_replicas=1, max_replicas=2, start=False)


def gw_raw_generate(port, prompt, n, seed):
    """The bytes of one ``/v1/generate`` stream as the wire carries
    them, and the seconds to its first token line."""
    from http.client import HTTPConnection
    body = json.dumps({"prompt": prompt, "max_new_tokens": n,
                       "seed": seed}).encode()
    conn = HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/v1/generate", body,
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        first = r.readline()
        ttft = time.perf_counter() - t0
        rest = r.read()
        return r.status, first + rest, ttft
    finally:
        conn.close()


def gw_front_door(mx, card, pool, check):
    """(a) The gateway over the pool (two replicas) and the decode
    engine of phase 10 (a)."""
    import numpy as np
    from mxnet_tpu_torch import faults
    from mxnet_tpu_torch.gateway import (GatewayClient, GatewayError,
                                         GatewayServer)
    from mxnet_tpu_torch.serving.decode import DecodeEngine
    ctx = gw_ctx(mx)
    cfg = DECODE_LSTM
    model = decode_model(cfg)
    eng = DecodeEngine(model, model.init_params(seed=cfg["seed"]),
                       slots=cfg["slots"],
                       max_prefill_len=cfg["max_prefill_len"], context=ctx)
    srv = None
    try:
        eng.warmup()
        srv = GatewayServer(predict_backend=pool, decode_backend=eng,
                            host="127.0.0.1", port=0, drain_timeout_s=120)
        cli = GatewayClient("127.0.0.1", srv.port, timeout=600)
        ref_rep = pool.replicas[0]
        rs = np.random.RandomState(20)
        sizes = [GW_REQUEST_ROWS[i % len(GW_REQUEST_ROWS)]
                 for i in range(GW_REQUESTS)]
        xs = [rs.randn(n, *GW_IMAGE).astype(np.float32) for n in sizes]
        refs = [ref_rep.predict(x) for x in xs]
        got = [None] * GW_REQUESTS
        errors = []

        def client(k):
            c = GatewayClient("127.0.0.1", srv.port, timeout=600)
            for i in range(k, GW_REQUESTS, GW_CLIENTS):
                try:
                    got[i] = c.predict(xs[i])
                except Exception as e:  # noqa: BLE001 - gated below
                    errors.append(repr(e))

        t0 = time.perf_counter()
        threads = [gw_thread(lambda k=k: client(k), "gw-smoke-client-%d" % k)
                   for k in range(GW_CLIENTS)]
        for t in threads:
            t.join(900)
        wall = time.perf_counter() - t0
        same = not errors and all(
            g is not None and g.dtype == r.dtype and g.tobytes() == r.tobytes()
            for g, r in zip(got, refs))
        finite = all(np.isfinite(r).all() for r in refs)
        outstanding = [pool.outstanding(r) for r in pool.replicas]
        check("gateway predict parity", same and finite and not any(
            t.is_alive() for t in threads),
            {"phase": "gateway_predict", "requests": GW_REQUESTS,
             "clients": GW_CLIENTS, "rows": sum(sizes),
             "request_rows": list(GW_REQUEST_ROWS), "wall_s": wall,
             "requests_per_s": GW_REQUESTS / wall,
             "bitwise_vs_direct": same, "finite": finite,
             "errors": errors[:3], "replicas": pool.size,
             "outstanding_after": outstanding, "card": card})

        # p50/p95 at bucket 8: through the gateway and direct
        x8 = rs.randn(GW_TIME_ROWS, *GW_IMAGE).astype(np.float32)
        gw_ms, direct_ms, enc_ms, dec_ms = [], [], [], []
        ref8 = ref_rep.predict(x8)
        same8 = True
        for _ in range(GW_TIME_REPS):
            t0 = time.perf_counter()
            out = cli.predict(x8)
            gw_ms.append(1e3 * (time.perf_counter() - t0))
            same8 = same8 and out.tobytes() == ref8.tobytes()
        for _ in range(3):
            t0 = time.perf_counter()
            body = json.dumps({"rows": x8.tolist()}).encode()
            t1 = time.perf_counter()
            np.asarray(json.loads(body)["rows"], dtype=np.float32)
            enc_ms.append(1e3 * (t1 - t0))
            dec_ms.append(1e3 * (time.perf_counter() - t1))
        for _ in range(GW_DIRECT_REPS):
            t0 = time.perf_counter()
            ref_rep.predict(x8)
            direct_ms.append(1e3 * (time.perf_counter() - t0))
        check("gateway bucket-8 rows", same8, {
              "phase": "gateway_latency", "rows": GW_TIME_ROWS,
              "bucket": ref_rep.bucket_for(GW_TIME_ROWS),
              "gateway_ms_p50": gw_pct(gw_ms, 50),
              "gateway_ms_p95": gw_pct(gw_ms, 95),
              "direct_ms_p50": gw_pct(direct_ms, 50),
              "direct_ms_p95": gw_pct(direct_ms, 95),
              "json_encode_ms": statistics.median(enc_ms),
              "json_decode_ms": statistics.median(dec_ms),
              "request_mb": len(body) / 1e6,
              "gateway_reps": GW_TIME_REPS, "direct_reps": GW_DIRECT_REPS,
              "bitwise_vs_direct": same8, "card": card})

        # streams: every generation byte for byte the engine's own
        prompts = decode_prompts(cfg)[:GW_STREAMS]
        n_new = cfg["new_tokens"]
        direct, direct_ttft = [], []
        for i, p in enumerate(prompts):
            req = eng.submit(p, max_new_tokens=n_new, seed=i)
            direct.append(req.result(timeout=600))
            direct_ttft.append(req.ttft_ms)
        res = [None] * len(prompts)

        def stream(i):
            res[i] = gw_raw_generate(srv.port, prompts[i], n_new, i)

        threads = [gw_thread(lambda i=i: stream(i), "gw-smoke-stream-%d" % i)
                   for i in range(len(prompts))]
        for t in threads:
            t.join(600)
        want = [b"".join(b"%d\n" % t for t in d) for d in direct]
        same = all(r is not None and r[0] == 200 and r[1] == w
                   for r, w in zip(res, want))
        seq_ttft = [1e3 * gw_raw_generate(srv.port, p, n_new, i)[2]
                    for i, p in enumerate(prompts)]
        check("gateway streams", same,
              {"phase": "gateway_streams", "streams": len(prompts),
               "new_tokens": n_new, "byte_identical": same,
               "ttft_ms_p50_gateway": statistics.median(seq_ttft),
               "ttft_ms_p50_direct": statistics.median(direct_ttft),
               "card": card})

        # the three gateway seams fire and heal
        x1 = xs[0]
        try:
            plan = faults.arm("gateway.accept:flood@nth=1", seed=5)
            out = GatewayClient("127.0.0.1", srv.port, retries=2,
                                backoff_s=0.001, sleep=lambda s: None,
                                timeout=600).predict(x1)
            accept_ok = out.tobytes() == refs[0].tobytes() and \
                [i["site"] for i in plan.incidents()] == ["gateway.accept"]
            plan = faults.arm("gateway.route:error@nth=1", seed=5)
            cli0 = GatewayClient("127.0.0.1", srv.port, retries=0,
                                 timeout=600)
            try:
                cli0.predict(x1)
                status = 200
            except GatewayError as e:
                status = e.status
            healed = cli0.predict(x1).tobytes() == refs[0].tobytes()
            route_ok = status == 503 and healed and \
                [i["site"] for i in plan.incidents()] == ["gateway.route"]
            plan = faults.arm("gateway.stream:transient@nth=3", seed=9)
            toks = list(cli.generate(prompts[0], max_new_tokens=n_new,
                                     seed=0))
            stream_ok = toks == direct[0] and plan.unfired() == [] and \
                [i["site"] for i in plan.incidents()] == ["gateway.stream"]
        finally:
            faults.disarm()
        check("gateway seams", accept_ok and route_ok and stream_ok,
              {"phase": "gateway_seams", "accept_flood_healed": accept_ok,
               "route_error_503_then_served": route_ok,
               "stream_transient_exact": stream_ok})

        # drain: readiness flips while the request in flight completes
        xd = rs.randn(GW_DRAIN_ROWS, *GW_IMAGE).astype(np.float32)
        refd = ref_rep.predict(xd)
        outd = []
        t = gw_thread(lambda: outd.append(GatewayClient(
            "127.0.0.1", srv.port, retries=0, timeout=600).predict(xd)),
            "gw-smoke-drain-request")
        deadline = time.time() + 120
        while srv.inflight() < 1 and time.time() < deadline:
            time.sleep(0.001)
        ready_before = cli.ready()
        dt = gw_thread(srv.drain, "gw-smoke-drainer")
        while not srv.draining and time.time() < deadline:
            time.sleep(0.001)
        inflight = srv.inflight()      # admitted, its JSON still parsing
        ready_during, healthy = cli.ready(), cli.healthy()
        dt.join(300)
        t.join(300)
        completed = len(outd) == 1 and outd[0].tobytes() == refd.tobytes()
        try:
            cli0.predict(x1)
            after = 200
        except GatewayError as e:
            after = e.status
        check("gateway drain", (inflight >= 1 or GW_DEVICE == "cpu") and
              ready_before and not ready_during and healthy and completed
              and after == 503 and not dt.is_alive() and not t.is_alive(),
              {"phase": "gateway_drain", "inflight_when_draining": inflight,
               "ready_before": ready_before, "ready_during": ready_during,
               "healthy": healthy, "inflight_completed_bitwise": completed,
               "status_after": after, "stats": srv.stats()})
    finally:
        if srv is not None:
            srv.shutdown(drain=False)
        eng.shutdown(drain=True)
        eng.release()


def gw_autoscale(mx, pool, violations, check):
    """(b) The pool from 1 to 2 to 1 replica under the autopilot, the
    ``autopilot.scale`` seam failing the first spin-up, while hammer
    threads serve through the pool."""
    import threading
    import numpy as np
    from mxnet_tpu_torch import autopilot, faults
    pool.scale_to(1)
    x = np.random.RandomState(21).randn(2, *GW_IMAGE).astype(np.float32)
    ref = pool.replicas[0].predict(x)
    stop, errors, served = threading.Event(), [], [0]

    def hammer():
        while not stop.is_set():
            try:
                out = pool.predict(x)
                if out.tobytes() != ref.tobytes():
                    errors.append("rows differ")
                served[0] += 1
            except Exception as e:  # noqa: BLE001 - gated below
                errors.append(repr(e))

    slo = mx.telemetry.SLOTracker("gateway_phase.pool", error_rate=1e-3,
                                  fast_window_s=0.5, slow_window_s=0.5,
                                  refresh_s=0.0)
    ap = autopilot.Autopilot(
        config=autopilot.AutopilotConfig(min_replicas=1, max_replicas=2,
                                         cooldown_ticks=1, idle_ticks=2),
        slo=slo, pool=pool)
    threads = [gw_thread(hammer, "gw-smoke-hammer-%d" % i)
               for i in range(GW_HAMMER_THREADS)]
    sizes = []
    try:
        for _ in range(50):
            slo.record(outcome="error")
        plan = faults.arm("autopilot.scale:error@nth=1", seed=0)
        try:
            ap.step()                    # the spin-up seam fires
            sizes.append(pool.size)
            time.sleep(GW_TICK_S)
            ap.step()                    # cooldown
            time.sleep(GW_TICK_S)
            ap.step()                    # the retry comes up
            sizes.append(pool.size)
            incidents = [i["site"] for i in plan.incidents()]
        finally:
            faults.disarm()
        deadline = time.time() + 30
        while slo.burn_state()["n_fast"] and time.time() < deadline:
            time.sleep(0.05)             # the errors age out
        for _ in range(4):
            time.sleep(GW_TICK_S)
            ap.step()
        time.sleep(GW_TICK_S)            # traffic on the one left
        sizes.append(pool.size)
    finally:
        stop.set()
        for t in threads:
            t.join(120)
        ap.stop()
    acts = [(e["decision"]["action"], "actuate_error" in e)
            for e in ap.transcript if "decision" in e]
    check("autoscale", sizes == [1, 2, 1] and incidents ==
          ["autopilot.scale"] and ap.replay() == [] and not violations
          and not errors and served[0] > 0
          and not any(t.is_alive() for t in threads),
          {"phase": "gateway_autoscale", "sizes": sizes,
           "transcript": acts, "incidents": incidents,
           "replay_divergences": len(ap.replay()),
           "hammer_requests": served[0], "violations": violations[:3],
           "errors": errors[:3],
           "spinups": [dict(r) for r in pool.spinup_reports]})


def gw_canary(mx, src, work, check):
    """(b) A NaN-poisoned generation admitted as a canary is rolled back;
    the stable route keeps serving its rows."""
    import hashlib
    import numpy as np
    from mxnet_tpu_torch.autopilot import (AutopilotConfig,
                                           CanaryController, decide_canary)
    from mxnet_tpu_torch.checkpoint import CheckpointManager, params_digest
    from mxnet_tpu_torch.serving import DynamicBatcher, Predictor, Tenant
    ctx = gw_ctx(mx)
    mgr = CheckpointManager(os.path.join(work, "canary"))
    src.save_checkpoint(None, 1, manager=mgr, async_save=False)
    base = mgr.restore(1)
    arrays = {k: np.array(v) for k, v in base.params.items()}
    name = sorted(arrays)[0]
    arrays[name].reshape(-1)[0] = np.nan
    extra = dict(mgr.step_metadata(1), epoch=2,
                 params_digest=params_digest(src.symbol.tojson(), arrays))
    mgr.save(2, arrays, extra=extra, async_save=False)
    shapes = [("data", (GW_CANARY_BUCKETS[-1],) + GW_IMAGE)]

    def load(step):
        pred = Predictor.load(mgr, step, data_shapes=shapes, context=ctx,
                              buckets=GW_CANARY_BUCKETS)
        pred.warmup()
        return pred

    stable = load(1)
    srv = DynamicBatcher(tenants={"stable": Tenant(
        "stable", stable, priority=1, protected=True)}, max_wait_ms=2)
    try:
        x = np.random.RandomState(22).randn(3, *GW_IMAGE).astype(np.float32)
        before = srv.predict(x, timeout=600, tenant="stable")
        ctrl = CanaryController(mgr, srv, stable_step=1,
                                predictor_factory=load, context=ctx)
        cfg = AutopilotConfig(canary_soak_ticks=2)
        acts = []
        for tick in range(3):
            obs = ctrl.observe(tick=tick)
            decision = decide_canary(cfg, obs)
            ctrl.apply(decision, tick=tick)
            acts.append(decision["action"] + ":" + decision["reason"])
        after = srv.predict(x, timeout=600, tenant="stable")
        same = after.tobytes() == before.tobytes() and \
            bool(np.isfinite(after).all())
        check("canary rollback", acts[:2] == ["admit:new_generation",
                                              "rollback:probe_failed"]
              and acts[2].startswith("hold") and same
              and ctrl.rejected_steps == [2] and ctrl.stable_step == 1
              and srv.tenants() == ["stable"],
              {"phase": "gateway_canary", "decisions": acts,
               "rejected": ctrl.rejected_steps,
               "stable_step": ctrl.stable_step,
               "stable_rows_bitwise": same,
               "stable_digest": stable.params_digest[:16],
               "stable_rows_sha256":
                   hashlib.sha256(after.tobytes()).hexdigest()[:16]})
    finally:
        srv.shutdown()
        srv.tenant("stable").predictor.release()


def gw_peer(mx, K, work, check):
    """(b) ElasticTrainer over 4 virtual hosts with a PeerCheckpointStore:
    hosts 1 and 3 die, the resume comes from peer memory, lands on the
    disk resume's parameters bit for bit, and the store's newest capture
    restores the manager's entry bit for bit."""
    import numpy as np
    from mxnet_tpu_torch.autopilot import PeerCheckpointStore
    from mxnet_tpu_torch.dist import ElasticTrainer, VirtualCluster
    ctx = gw_ctx(mx)
    rs = np.random.RandomState(3)
    X = rs.rand(GW_PEER_ROWS, *GW_PEER_IMAGE).astype(np.float32)
    y = rs.randint(0, 10, GW_PEER_ROWS).astype(np.float32)
    net = mx.models.get_symbol(GW_PEER_NETWORK, num_classes=10,
                               image_shape=GW_PEER_IMAGE)

    def run(name, store):
        mx.random.seed(3)
        np.random.seed(3)
        b0 = (K.bn_fwd.launches, K.bn_bwd.launches)
        tr = ElasticTrainer(
            VirtualCluster(4, context=ctx),
            lambda w: mx.mod.Module(net, context=w.contexts()),
            lambda w: w.feed(mx.io.NDArrayIter(X, y,
                                               batch_size=GW_PEER_BATCH)),
            os.path.join(work, name), checkpoint_every_steps=GW_PEER_EVERY,
            peer_store=store)
        mod = tr.fit(num_epoch=GW_PEER_EPOCHS, inject_fault=GW_PEER_FAULT,
                     optimizer="sgd",
                     optimizer_params={"learning_rate": 0.05,
                                       "momentum": 0.9},
                     initializer=mx.init.Xavier(factor_type="in",
                                                magnitude=2.34))
        tr.manager.wait_until_finished()
        steps = sum(e.get("at_num_update", e.get("final_num_update", 0))
                    - (e["resume_step"] or 0) for e in tr.transcript)
        launches = (K.bn_fwd.launches - b0[0], K.bn_bwd.launches - b0[1])
        return tr, mod, steps, launches

    from mxnet_tpu_torch import telemetry
    try:
        store = PeerCheckpointStore(4)
        tr, mod, steps, launches = run("peer", store)
        tr_d, mod_d, steps_d, launches_d = run("disk", None)
    finally:
        telemetry.flight_recorder().disarm()
        telemetry.flight_recorder().pop_last_dump()
    done = [e for e in tr.transcript if e["event"] == "finished"]
    last = store.latest()
    peer, disk = store.restore(last), tr.manager.restore(last)
    restored = set(peer.params) == set(disk.params) and all(
        np.asarray(peer.params[k]).tobytes() ==
        np.asarray(disk.params[k]).tobytes() for k in disk.params) and \
        peer.optimizer_state == disk.optimizer_state
    same = all(a.tobytes() == b.tobytes() for a, b in zip(
        [v for _, v in sorted(host_params(mod).items())],
        [v for _, v in sorted(host_params(mod_d).items())]))
    want = GW_PEER_BN * steps
    bn_ok = GW_DEVICE == "cpu" or (launches == (want, want) and
                                   launches_d == (GW_PEER_BN * steps_d,) * 2)
    check("peer store", bool(done) and done[0]["resume_source"] == "peer"
          and [e["decision"]["action"] for e in store.transcript]
          == ["peer_restore"] and restored and same and bn_ok,
          {"phase": "gateway_peer", "network": GW_PEER_NETWORK,
           "resume_source": done[0]["resume_source"] if done else None,
           "resume_step": done[0]["resume_step"] if done else None,
           "final_num_update": done[0]["final_num_update"] if done else None,
           "peer_decisions": [e["decision"] for e in store.transcript],
           "latest_capture": last, "restore_bitwise_vs_disk": restored,
           "params_bitwise_vs_disk_resume": same,
           "bn_launches": launches, "bn_launches_disk_run": launches_d,
           "steps_run": [steps, steps_d], "store": store.stats()})


def gw_scenarios(mx, check):
    """(c) The scenario matrix on the card, and the chaos sweep of
    ``nce_loss``."""
    from mxnet_tpu_torch import scenarios
    with gw_ctx(mx):
        t0 = time.time()
        report = scenarios.run_matrix()
        matrix_s = time.time() - t0
        for name, row in report["scenarios"].items():
            bad = {c: v["detail"] for c, v in row["contracts"].items()
                   if not v["ok"]}
            check("scenario %s" % name, row["green"] and
                  row["post_warmup_retraces"] == 0,
                  {"phase": "gateway_scenario", "name": name,
                   "green": row["green"],
                   "post_warmup_retraces": row["post_warmup_retraces"],
                   "accuracy": row["accuracy"], "floor": row["floor"],
                   "floor_mode": row["floor_mode"],
                   "fit_seconds": row["fit_seconds"],
                   "digest": row["digest"], "failed": bad,
                   "serving": row.get("serving")})
        t0 = time.time()
        ch = scenarios.chaos_sweep(scenarios.get("nce_loss"))
        chaos_s = time.time() - t0
    check("chaos sweep", ch["digest"] == ch["reference"] and
          ch["incidents"] >= 1 and not ch["unfired"] and
          ch["reference"][:16] == report["scenarios"]["nce_loss"]["digest"],
          {"phase": "gateway_chaos", "scenario": "nce_loss",
           "digest": ch["digest"][:16], "reference": ch["reference"][:16],
           "incidents": ch["incidents"], "unfired": ch["unfired"],
           "rules": ch["rules"], "matrix_s": matrix_s, "chaos_s": chaos_s})


def gateway_phase(mx, K, C, R, card):
    """Phase 20 (module docstring). Returns every kernel's launches over
    (a)-(c)."""
    import shutil
    import tempfile
    import torch
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    failed = []

    def check(name, ok, row):
        emit(dict(row, ok=bool(ok)))
        if not ok:
            failed.append(name)

    t, parts = {}, {}
    violations = []
    src = gw_source(mx)
    pool = gw_pool(src, violations)
    work = tempfile.mkdtemp(prefix="gateway_phase_", dir=os.path.join(
        ROOT, "build"))
    try:
        t0 = time.time()
        pool.scale_to(2)
        gw_zero(K, C, R)
        gw_front_door(mx, card, pool, check)
        parts["a"] = gw_counts(K, C, R)
        t["a"] = time.time() - t0
        check("no kernel on the front door", not any(parts["a"].values()),
              {"phase": "gateway_kernels_a", "launches": parts["a"]})
        t0 = time.time()
        gw_zero(K, C, R)
        gw_autoscale(mx, pool, violations, check)
        pool.close()
        gw_canary(mx, src, work, check)
        gw_peer(mx, K, work, check)
        parts["b"] = gw_counts(K, C, R)
        t["b"] = time.time() - t0
    finally:
        pool.close()
        shutil.rmtree(work, ignore_errors=True)
    del src
    t0 = time.time()
    gw_zero(K, C, R)
    gw_scenarios(mx, check)
    parts["c"] = gw_counts(K, C, R)
    t["c"] = time.time() - t0
    on_card = GW_DEVICE != "cpu"
    check("nms kernels in the matrix", not on_card or (
        parts["c"]["nms_mask"] > 0 and parts["c"]["nms_scan"] > 0),
        {"phase": "gateway_kernels_c", "launches": parts["c"]})
    emit({"phase": "gateway_seconds", **t})
    if failed:
        raise RuntimeError("gateway phase failed: %s" % "; ".join(failed))
    return {k: sum(p[k] for p in parts.values()) for k in parts["a"]}


def build_kernels(builds):
    """Build the CUDA libraries at once (one nvcc each); seconds taken."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.time()
    with ThreadPoolExecutor(max(1, len(builds))) as pool:
        for f in [pool.submit(b) for b in builds]:
            f.result()
    return time.time() - t0


def main():
    t_start = time.time()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch.kernels import batchnorm as K
        from mxnet_tpu_torch.kernels import copy as C
        from mxnet_tpu_torch.kernels import rtc as R
        from mxnet_tpu_torch.kernels import nms as NM
        from mxnet_tpu_torch.kernels import roi_pooling as RP
    except ImportError as e:
        print("chip_smoke: run from a checkout of the repository (%s)" % e,
              file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    card = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    # one nvcc per source, all at once: BatchNorm, copy, NMS, ROI pooling,
    # each rtc body
    builds = [K._library, C._library, NM._library, RP._library] + [
        functools.partial(R._library, ck) for ck in rtc_checked(mx)]
    emit({"phase": "build", "libraries": len(builds),
          "seconds": build_kernels(builds)})

    seconds = {}

    def timed(name, fn, *a):
        t0 = time.time()
        try:
            return fn(*a)
        finally:
            seconds[name] = time.time() - t0

    copy_entry, copy_rate = timed("copy", copy_phase, C, card)
    worst = timed("kernels", check_kernels, K)
    r50 = model_bn_shapes(mx, "resnet-50", (3, 224, 224), 1000, BATCH)
    totals, at_copy, worst_step = timed("kernel_times", time_kernels, K,
                                        r50, copy_rate)
    worst = {k: max(worst[k], worst_step[k]) for k in worst}
    emit({"phase": "kernel_times_per_step", "batch": BATCH,
          "dtype": "float32", "card": card, **totals,
          "bound_ms_at_measured_copy": at_copy,
          "measured_copy_gb_per_s": copy_rate / 1e9})
    totals16, at_copy16, worst16 = timed(
        "kernel_times_bf16", time_kernels, K, r50, copy_rate, "resnet-50",
        torch.bfloat16)
    emit({"phase": "kernel_times_per_step", "batch": BATCH,
          "dtype": "bfloat16", "card": card, **totals16,
          "bound_ms_at_measured_copy": at_copy16, "worst_abs_err": worst16,
          "measured_copy_gb_per_s": copy_rate / 1e9})
    launches, hand_img_per_s = timed("main_path", main_path, mx, K, card)
    timed("main_path_routes", fused_vs_classic, mx, card)
    timed("card_vs_cpu", card_vs_cpu, mx, K)
    rtc_entry = timed("rtc", rtc_phase, mx, R, card, copy_rate)
    trained = timed("fit", fit_phase, mx, K, card, hand_img_per_s)
    timed("serving", serving_phase, mx, K, card, trained)
    del trained
    launches16 = timed("precision", precision_phase, mx, K, card)
    twin_launches = timed("cifar_twin", cifar_twin_phase, mx, K, card,
                          copy_rate)
    decode_launches = timed("decode", decode_phase, mx, K, C, R, card)
    imnet_launches = timed("imagenet_twin", imagenet_twin_phase, mx, K,
                           card, hand_img_per_s)
    zoo_launches, zoo_v3, zoo_worst = timed("zoo", zoo_phase, mx, K, card,
                                            copy_rate)
    rnn_launches = timed("rnn", rnn_phase, mx, K, C, R, card)
    api_launches = timed("api", api_phase, mx, K, C, R, card)
    quant_launches = timed("quant", quant_phase, mx, K, C, R, card)
    vision_entries, vision_launches = timed("vision", vision_phase, mx, K, C,
                                            R, card)
    guard_launches = timed("guardian", guardian_phase, mx, K, C, R, card)
    cache_launches = timed("serve_cache", serve_cache_phase, mx, K, C, R,
                           card)
    dist_launches, dist_by_rank, dist_times, dist_worst = timed(
        "dist", dist_phase, mx, K, C, R, card)
    gateway_launches = timed("gateway", gateway_phase, mx, K, C, R, card)

    replaces = {"bn_fwd": "mxnet_tpu/ops/nn.py:460",
                "bn_bwd": "tools/bn_pallas_probe.py:76"}
    kernels = [dict(name=k, route="cuda",
                    source="mxnet_tpu_torch/kernels/csrc/batchnorm.cu",
                    replaces=replaces[k], launches=launches[k],
                    launches_cifar_twin=twin_launches[k],
                    launches_decode=decode_launches[k],
                    launches_imagenet_twin=imnet_launches[k],
                    launches_zoo=zoo_launches[k],
                    launches_rnn=rnn_launches[k],
                    launches_api=api_launches[k],
                    launches_quant=quant_launches[k],
                    launches_vision=vision_launches[k],
                    launches_guardian=guard_launches[k],
                    launches_serve_cache=cache_launches[k],
                    launches_bf16=launches16[k],
                    max_abs_err=worst[k], bound_by="bytes",
                    max_abs_err_bf16=worst16[k],
                    **{key: totals[k][key] for key in
                       ("ms", "plain_ms", "bound_ms", "library_ms")},
                    **{key + "_bf16": totals16[k][key] for key in
                       ("ms", "device_ms", "plain_ms", "bound_ms",
                        "library_ms")},
                    max_abs_err_zoo={d: zoo_worst[d][k] for d in zoo_worst},
                    inception_v3_step={
                        d: {key: zoo_v3[d][k][key] for key in
                            ("ms", "device_ms", "plain_ms", "bound_ms",
                             "library_ms", "library_device_ms")}
                        for d in zoo_v3})
               for k in ("bn_fwd", "bn_bwd")] + [
        dict(rtc_entry, launches_decode=decode_launches["rtc"],
             launches_rnn=rnn_launches["rtc"],
             launches_api=api_launches["rtc"],
             launches_quant=quant_launches["rtc"],
             launches_vision=vision_launches["rtc"],
             launches_guardian=guard_launches["rtc"],
             launches_serve_cache=cache_launches["rtc"]),
        dict(copy_entry, launches_decode=decode_launches["copy"],
             launches_rnn=rnn_launches["copy"],
             launches_api=api_launches["copy"],
             launches_quant=quant_launches["copy"],
             launches_vision=vision_launches["copy"],
             launches_guardian=guard_launches["copy"],
             launches_serve_cache=cache_launches["copy"])] + [
        dict(e, launches_guardian=guard_launches[e["name"]],
             launches_serve_cache=cache_launches[e["name"]])
        for e in vision_entries]
    for e in kernels:
        e["launches_dist"] = dist_launches[e["name"]]
    split_replaces = {"bn_fwd_partials": "mxnet_tpu/ops/nn.py:460",
                      "bn_fwd_apply": "mxnet_tpu/ops/nn.py:460",
                      "bn_bwd_partials": "tools/bn_pallas_probe.py:76",
                      "bn_bwd_dx": "tools/bn_pallas_probe.py:76"}
    for k in K.SPLIT_KERNELS:
        f32, bf16 = dist_times["float32"][k], dist_times["bfloat16"][k]
        kernels.append(dict(
            name=k, route="cuda",
            source="mxnet_tpu_torch/kernels/csrc/batchnorm.cu",
            replaces=split_replaces[k], launches=dist_launches[k],
            launches_dist=dist_launches[k],
            launches_by_rank=[r[k] for r in dist_by_rank],
            max_abs_err=dist_worst["float32"][k], bound_by="bytes",
            max_abs_err_bf16=dist_worst["bfloat16"][k],
            **{key: f32[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "library_ms")},
            **{key + "_bf16": bf16[key] for key in (
                "ms", "device_ms", "plain_ms", "bound_ms", "library_ms")},
            device_ms=f32["device_ms"]))
    for e in kernels:
        e["launches_gateway"] = gateway_launches[e["name"]]
    emit({"phase": "done", "seconds": time.time() - t_start,
          "phase_seconds": seconds})
    print(card)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
