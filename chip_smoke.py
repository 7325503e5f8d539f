#!/usr/bin/env python3
"""Run the PyTorch / H100 port once on the card, end to end.

    python3 chip_smoke.py [--seed N]

1. Builds the hand-written CUDA kernels from ``mxnet_tpu_torch/csrc``.
2. Holds each kernel of the int8 serving paths (K3 int8 GEMV, K5 one-launch block
   decode, K8 fused LM-head sampler, K6 and K7 one-launch paged block
   decode, gathered and streamed) against its plain PyTorch version at
   GPT-2-small shapes and times kernel, plain version and a library
   yardstick with CUDA events (L2 flushed before every timed launch). K3
   (and K4 below) run at 1, 8, 9, 16 and 64 rows: the warp route up to 8
   rows, the tensor-core tile route above, whose rows must give the same
   bits at 9, 16 and 64 rows and on a second launch; the warp route is also
   held at every M from 1 to 8 (each row the same bits as in the 8-row call
   and on a second launch, bf16 x the f32 lane on x.float()), and its tied
   head (50304 x 768) at 1 and 8 rows is reported on its own. K8's
   grammar-mask lane and bf16 lane (no public API of either package
   reaches them; phase 9 (d) reaches the bf16 lane from a Llama engine
   through the private ``_quantize_tied_lm_head``) are driven by direct
   calls and held against the plain version and the head GEMV + argmax. K6
   and K7 run on scattered block tables of a 600-page pool; K7's copies
   started and waited are held against the ``record_dma`` ledger, and K5, K6
   and K7 must give one input the same bits.
2b. Draws JAX's sampling stream on the card (``_prng`` threefry bits, a
   split-chain ``categorical`` and keyed ``sample_tokens`` with greedy,
   plain, top-k and top-p rows over GPT-2's vocab) and on the same inputs
   on the CPU: the bits and the tokens must be equal.
3. Serves 12 concurrent requests with a contiguous ``InferenceEngine``
   over int8 GPT-2 small (12 layers, D 768, vocab 50257, random weights
   from ``--seed``) and checks the tokens against ``generate()`` on the
   card and against the plain path on the CPU, and that every kernel of
   the path launched (each GEMV route, warp and tile, counted by
   ``gemv_routes()`` over the serving phases). The 8 greedy requests are
   then served once more under ``torch.profiler`` to split the window into
   device time per kernel and idle time. Two top-k/top-p requests follow,
   twice with the same seeds: their tokens must repeat. The same 12
   requests then go through a ``multi_token=1`` engine (the engine's
   default): every substep's head and every token 0 on K3's warp route at
   B <= 8, greedy tokens equal to the multi_token=4 engine's and
   ``generate()``'s, sampled ones repeating per seed, and a traced window
   beside the K=4 one.
3b. Serves the same model from the paged KV pool
   (``InferenceEngine(paged=True)``): phase A, 16 requests sharing a
   system prompt on a 128-page pool at max_len 256, every decode substep
   through K6, with prefix hits and copy-on-write forks; phase B, 8
   requests of 300-700-token prompts at max_len 1024 on a pool small
   enough to preempt, every decode substep through K7. Greedy tokens are
   held against the engine's arithmetic on the contiguous layout and
   against ``generate()``; sampled ones (and phase A's two top-k/top-p
   requests) repeat per seed; the page ledger drains to zero.
3c. Serves int4 weight-only GPT-2 small (``quantize_net(bits=4,
   fused_decode=True)``, the same weights): K4 (int4 GEMV) and the int4
   weight lanes of K5, K6, K7 and K8 against their plain versions (K4 +
   argmax equal to K8's greedy rows, K5/K6/K7 the same bits), then the
   contiguous phase's 12 requests (held against ``generate()`` and, over
   32 tokens of two requests, the CPU), paged phase A (K6) and phase C (4
   requests of 300-700-token prompts at max_len 1024 without preemption,
   K7), with int4 launch kinds only; prints the weight bytes of both
   models and each int4 phase's peak device memory.
3d. Serves bf16 GPT-2 small, the configuration of ``bench.py``'s quantized
   decode headlines: int8 with ``calib_mode='naive'`` on two seeded [8, 32]
   batches, then int4. The bf16 lanes of K3, K4 (bf16 x: bit for bit the
   f32 lane on x.float(), on both routes) and of K5, K6, K7 (bf16 x and
   bf16 caches and pools, also f32 x; K5 = K6 = K7 bitwise) against their
   plain versions; ``generate()`` at B 8, P 32, 128 new tokens,
   ``multi_token=8``; the contiguous phase, its multi_token=1 engine, paged
   A (K6) and paged B (K7, preemption) over the int8 model, ``generate()``
   and the contiguous phase over the int4 one, with each element-type lane's launches
   (``dtype_lanes()``) and the KV bytes beside the f32 phases'.
3e. Every engine phase above calls ``warmup()`` after ``start()``: each
   decode step of its bucket ladder (batch bucket x substeps x sampling
   branch) and each paged prefill chunk bucket is captured as a CUDA graph,
   and serving, with decode lookahead on (the default), replays them; the
   phase fails if it captures anything after its warm-up. Each phase's
   gates hold under replay (launch counts are added per replay). After the
   phase one decode step per layout (and, paged, the full and the final
   chunk bucket) is replayed and run eagerly from the same random inputs
   and pool state: outputs, last tokens and whole pools must be equal bit
   for bit. The contiguous window and paged phase B are then served in
   three modes (eager dispatch, captured, captured with lookahead): ms per
   substep, tokens/s over 3 trials and the idle share of each; the
   contiguous window's tokens must be equal in all three.
3f. ``constrained_spec``: grammar-constrained and self-speculative
   serving of the f32 int8 model, ``bench.py``'s grammar and speculation
   duels over GPT-2's vocab (8 structured prompts, one in flight, a paged
   ``speculate=4`` engine): the pass-through grammar ``.*`` must give the
   free engine's tokens with an acceptance no lower, every completion
   under a JSON schema must replay through the automaton, ``speculate=4``
   greedy tokens must equal ``speculate=0``'s (K6) or diverge where the
   CPU twin's top-2 gap is below ``gap_limit``, and a contiguous grammar
   engine's free rows (K5, K=1) must equal a plain engine's; a grammar
   step and a verify step replay their eager runs bit for bit. Prints
   tokens/s per sweep, ``cost_pct``, ``speedup``, acceptance, the compile
   seconds at vocab 50257 and the idle share of a profiled sweep.
3g. ``http_serve``: the HTTP frontend (``serve.HTTPFrontend`` on 127.0.0.1,
   port 0) over the same f32 int8 model. (a) A paged fused engine
   (``max_batch_size=8, max_len=256, multi_token=4``: K6 and K8), after
   ``warmup()`` and ``warmup_score()``, takes 8 greedy prompts of 8-48
   tokens and 2 sampled ones from 8 client threads: tokens equal to the
   same engine's in-process ``generate()``, SSE streams equal to the JSON
   replies frame for frame, nothing captured; requests/s and tokens/s
   through HTTP against in-process (median [min, max] of 3 trials) and
   the idle share of a profiled HTTP window. (b) ``/score`` of 4
   sequences of 5-64 tokens: bit for bit the eager scores on the card,
   within 1e-3 of the CPU twin's, ``logprob`` their sum, K3 on both
   routes, the same bits when posted during (a)'s decode; ms per score
   bucket. (c) ``/metrics``: requests, tokens and each built step's
   launch sites; ``/healthz`` 200 with models ``{"default": 0}``. (d) An
   unfused int8 engine (``multi_token=1``) deploys net B's published
   weights by ``POST /weights`` while a request decodes: the request
   completes, later tokens equal a fresh engine on net B, nothing is
   captured, ``/healthz`` shows version 1, the swap's apply time; a swap
   on (a)'s fused engine raises the JAX refusal. (e) ``POST /drain``:
   ``/healthz`` 503 and draining, new requests 503, in-flight ones ok.
4. Holds K1 (flash-attention forward) and K2 (its backward) against their
   plain versions, every output row to its own size, at the training
   shape, at head dim 128 and at ragged, end-aligned and padded-head-dim
   shapes, in bf16 and f32; requires K2 to give the same bits on a second
   run at every shape; shows that three planted faults fail that check;
   and times the kernels beside the plain versions and
   ``scaled_dot_product_attention``.
5. Trains bf16 GPT-2 small (12 layers, D 768, B 16, T 1024) through
   ``TrainStep`` at ``GPTConfig()``'s dropout 0.1 (25 sites, masks from
   the counter-hash stream under step t's ``KeySupply(key(t))``), Adam at
   lr 1e-4 on a cosine schedule with linear warmup: 1 warm-up step, then
   10 timed steps on one fixed batch, each with 12 K1 and 12 K2 launches;
   3 more steps under ``torch.profiler`` split the device time by kernel,
   and one more attributes the dropout sites' device time (mask and
   scale, and their backward). Then the same at dropout 0 and a constant
   lr 1e-4.
6. Trains the same model in f32 at B 2 for 2 SGD steps on the card and on
   the CPU (plain versions) from the same weights, batch and step keys,
   at dropout 0.1 and at 0, and compares losses, each step's gradients
   leaf by leaf and the parameters after; shows that a K2 with outputs 1%
   too large, and at dropout 0.1 a key stream that hands site k the key of
   site k + 1, fail that gradient check; requires one site's keep mask
   (and the keep bits past 2**31, with and without the high word) to be
   the same bits on the card and the CPU; and holds the bf16 model's
   step-1 gradients against the f32 model's.
7. Resumes bf16 GPT-2 small at dropout 0.1 from checkpoints on the card:
   ``TrainStep`` with an asynchronous sharded ``CheckpointManager`` save,
   and the eager ``Trainer`` path through the local layout; the resumed
   steps' losses, parameters and optimizer states must be the same bits
   as the first run's. Prints the checkpoint bytes, the training thread's
   stall in ``save``, the background write's and the restore's seconds.
8. ``gluon_substrate``: (a) the README's first program at its own widths
   (``HybridSequential(Dense(128, relu), Dense(10))`` on 784-wide inputs,
   B 128, Xavier, softmax cross-entropy, Adam 1e-3, 20 steps) eagerly and
   hybridized with ``static_alloc=True`` on the card: losses and
   parameters the same bits; the same program on the CPU port from the
   same weights within 1e-5 relative; a hybridized predict call after
   warm-up adds no cache entry, counts a cache hit and replays its CUDA
   graph, with the eager call's bits. (b) A user ``HybridBlock`` at GPT-2
   small's width (LayerNorm, Dense 3x768, ``mx.ops.attention`` causal with
   12 heads of 64, Dense 768, residual) at B 4, T 1024 inside
   ``autograd.record()`` then ``backward()``, in f32 and bf16: K1 and K2
   launch from the tape, gradients within K1/K2's gates of the same block
   with the plain attention called directly (in bf16 the parameters'
   gradients; the input's passes the bf16 LayerNorm backward, which alone
   puts it about 0.17 in row error from f32 with either attention, so it
   is reported), and the f32 gradients at B 1 within 1e-4 of the CPU
   port's. Records ms per step of (a) eager and
   hybridized, predict ms eager and replayed, (b)'s forward + backward ms
   and K1/K2's share of its device time.
9. ``llama_serve``: first the kernels of the Llama path at Llama-3-8B's
   widths against their plain versions (``kernel_llama_widths``): K3 and K4
   at 4096 x 4096, 1024 x 4096, 14336 x 4096, 4096 x 14336 and the head
   128256 x 4096, bf16 and f32 x, at 1 and 8 rows (warp route) and 9 and 64
   (tile route); K8 over the 128256 x 4096 head in both codecs and lanes and
   over a vocab of 128003 (pad lanes); K1 at B 1, 32 heads of 128, T 1024.
   Then LLAMA3_8B at full width and depth (32 layers, 32 query and 8 KV
   heads, vocab 128256, untied head, bf16), weights drawn on the card from
   ``--seed``: (a) the cache-free forward at T 1024, 32 K1 launches, its
   logits (relative L2) within LLAMA_K1_SPREAD times the distance that
   keeping p in f32 puts between two plain attentions, of the same forward
   with K1's plain version; (c) a 2-layer twin with the card model's embedding,
   first layers, norm and head, int8, greedy on the card and the CPU, held
   by the card's rule (equal, or a top-2 gap below ``gap_limit`` at the
   first divergence), then its activation-quantized products past 64 rows
   (128 rows through every layer and the head) on the card's inputs: each
   the CPU's bit for bit at the card's activation scale, that scale within
   one ulp of the CPU's; (d) the tied head at full width, 2 layers, int8
   then int4, in ``multi_token=4`` engines: the per-layer decoder hands K8
   f32 hidden states, the stacked decoder with only its head quantized (by
   the private ``_quantize_tied_lm_head``: no public API reaches this
   lane) hands it bf16 ones (its bf16 lane), each held against
   ``multi_token=1``; (e)
   int8 and int4 ``generate`` at 2 layers: K3 and K4 at every Llama width
   on both routes, against their plain versions; (f) the stacked decoder
   against the per-layer one, unquantized bf16, in both layouts; (b) int8
   (``quantize_net``) through the paged engine (S 8, max_len 1024, 64-token
   prefill chunks) after ``warmup()``: 16 greedy requests of 64-512-token
   prompts, 64 new tokens each; replay equals eager; the contiguous engine
   gives the 64-token prompts the same tokens and the longer ones hold to
   the paged arithmetic on the contiguous layout; tokens/s, ms a decode
   step, the idle share of a profiled window, K3's launches by route and
   width.

10. ``llama_train``: Llama trains on the card through ``parallel.TrainStep``
   (``TrainStep(net, SoftmaxCrossEntropyLoss(axis=-1), Adam, [ids])``).
   First K1 and K2 at the path's attention shape (B 2, 32 heads of 128
   after the GQA repeat, T 2048, causal bf16) against their plain versions,
   timed beside SDPA. (a) LLAMA3_8B at 4 of its 32 layers (untied, bf16,
   1.92 B parameters), B 2, T 2048, 5 Adam steps at lr 3e-4 on one batch
   from ``--seed``: every loss finite, the last below the first, K1 and K2
   each launched once per layer per step (counts zeroed just before, read
   just after) and the plain attention never; ms a step (median after
   the first), tokens/s, MFU against the bf16 peak, peak memory, and one
   profiled step split into K1, K2, GEMMs, the loss and the optimizer.
   The phase starts only if the earlier phases' models and engines were
   freed (at most LT_HELD_GB still allocated). (b) The stacked decoder at
   2 layers from (a)'s trained weights: its step-1 gradients against the
   per-layer decoder's within LT_STACKED_GRAD_TOL, the losses within one
   bf16 step. (c) Mixtral-8x7B's widths (D 4096, F 14336, 32 + 8
   heads, vocab 32000, 8 experts, top 2, rope theta 1e6) at 2 of its 32
   layers, the same gates plus the share of (token, choice) pairs dropped
   by capacity (below 1), and one forward and backward of MoE layer 0 on
   its main-path input timed op by op: its f32 products (the dispatch and
   combine einsums), its products in the weights' dtype (the experts)
   and the rest (routing, SwiGLU, casts). (d) A small MoE Llama
   (D 512, heads of 128, 4 experts on layer 0) in f32, 2 SGD steps on the
   card and on the CPU from the same weights: every pair's expert and slot
   equal, gradients leaf by leaf within CARD_CPU_GRAD_TOL, parameters
   within CARD_CPU_PARAM_TOL (the CPU's smallest top-k gate margin and the
   largest router-logit difference printed), a bf16 twin's step-1
   gradients within BF16_GRAD_TOL of the f32 ones. (e) ``remat=True`` on
   (d)'s model: the same losses and parameters bit for bit; at (a)'s shape
   the peak memory of a step with and without remat.

11. ``vision_train``: the conv path. (a) ResNet-50 v1 in ``bench.py``'s
   ``bench_resnet50`` configuration: ``get_model("resnet50_v1",
   classes=1000, layout="NHWC")``, ``Xavier()``,
   ``amp.convert_hybrid_block(net, "bfloat16")``, B 128 bf16 images of
   224 x 224 and labels from ``--seed``, ``TrainStep(net,
   SoftmaxCrossEntropyLoss(), SGD(learning_rate=0.05, momentum=0.9),
   [images])``, 10 steps: finite losses, the last below the first, each
   of the 16 bottleneck blocks one ``npx.fused_resnet_block`` and the stem
   one space-to-depth rewrite every step, every running mean moved; ms a
   step (median after the first), images/s, MFU against the bf16 peak
   (FLOPs from the built model's conv and dense shapes), peak memory and
   one profiled step split into conv fprop, dgrad and wgrad, BN / ReLU
   elementwise work, the SGD update and the rest. (b) That net in
   inference, eager and hybridized with ``static_alloc=True``: replayed
   logits equal the eager ones within one bf16 step at the largest, images/s
   of each. (c) Thumbnail ResNet-18 in f32, NHWC and its NCHW twin from the
   same weights, 2 SGD steps on the card and on the CPU: gradients leaf
   by leaf within VT_CARD_CPU_GRAD_TOL, parameters and running statistics
   within VT_CARD_CPU_PARAM_TOL, NHWC against NCHW within the same. (d) ViT-B/16 at 384 (T 577), bf16 through AMP, B 32,
   5 Adam steps: K1 and K2 first timed at its attention shape against
   their plain versions and SDPA; finite falling losses, K1 and K2 each 12
   times a step and the plain attention never. The phase starts only with
   at most LT_HELD_GB still allocated.

12. ``nlp_train``: BERT and T5 train on the card. (a) ``bench.py``'s
   ``bench_bert_base_ft`` configuration: ``BertForSequenceClassification(
   BertConfig(), num_classes=2)``, ``random.seed(0)``, ``initialize()``,
   ``amp.convert_hybrid_block(net, "bfloat16")``, B 32 ids of T 128 from
   ``--seed``, zero token types, labels in {0, 1}, ``TrainStep`` with Adam
   at 2e-5, one warm ``run(steps=20)`` and three timed ones: finite
   losses, the classifier moved, K1/K2 never launched (T 128 with
   attention dropout takes the einsum route), the attention dropout drawn
   once a layer every step; ms a step (median and spread of the trials),
   examples/s, MFU by ``bench.py``'s analytic formula, peak memory and one
   profiled step split into GEMMs, the attention einsums and softmax, the
   dropout mask hashing, LayerNorm and GELU, Adam and the rest; the
   trained net's Accuracy, F1 and MCC from CUDA tensors equal to those
   from host copies. (b) ``BertForPretraining(BertConfig(
   attention_dropout=0.0))``, bf16 through AMP over f32 master weights, B
   8, T 512, MLM + NSP,
   LAMB at 1e-3, 8 steps, K1 and K2 first timed at its attention shape (B
   8, 12 heads of 64, T 512) against their plain versions and SDPA:
   finite losses, the last below the first, K1 and K2 each 12 times a
   step and the plain attention never; an inference forward at attention
   dropout 0.1 launches K1 12 times and K2 never; a right-padded
   key-masked batch launches neither and, on the f32 master weights, its
   valid prefix equals the truncated batch's within one bf16 step and
   BERT_MASK_ROW_TOL at every position, a planted ignored mask not. (c) f32,
   the card against the CPU from the same weights and step keys, 2 SGD
   steps: a narrow BERT (hidden 128, 2 heads of 64, 2 layers) on the
   einsum route with a key mask and both dropouts (T 288), on K1/K2 (T
   288), on the chunked route (T 640, key mask, attention dropout), and
   T5_TINY: gradients leaf by leaf within CARD_CPU_GRAD_TOL, parameters
   within CARD_CPU_PARAM_TOL. (d) T5-small (``T5Config()``), bf16 through
   AMP, B 16, sources of 512 and targets of 128 tokens, Adam at 1e-4, 5
   steps: finite falling losses, no K1/K2 launch. (e) Every registered
   optimizer, 3 updates of an f32 and a bf16 tensor, card against CPU;
   SGLD's noise bit for bit. The phase starts only with at most
   LT_HELD_GB still allocated.

13. ``fleet_serve``: the serving fleet over paged replicas of int8 GPT-2
   small (``multi_token=4``, fused, page 16), each behind its own
   ``HTTPFrontend`` in this process, sharing one model. (a) Two replicas
   (max_len 384: K6) behind ``Router(affinity=True)`` and a
   ``RouterFrontend``: 4 prompt families of 3 requests (a 32-token prefix
   and 8-32 own tokens), greedy and T 0.8, JSON and SSE; tokens against a
   reference engine of the same configuration request by request (equal
   for prompts of up to 64 tokens, past that greedy with a top-2 gap
   below ``gap_limit`` at the first divergence; sampled equal), affinity
   hit tokens > 0, K6 and K8 on both replicas; router tokens/s, and, the
   router stopped, one replica's HTTP against in process at the router
   burst's shape and at ``http_serve``'s. (b)
   ``migrate_prefix`` over HTTP of a 256-token prompt between (a)'s
   replicas and of a 640-token one between max_len-1024 replicas (K7):
   every shipped page adopted, the target's prefill only the tail, its
   tokens against the source's, K6 / K7 on the target, its captures
   unchanged; a doc with one wrong chain key and one wrong shape: both
   counted, neither written. (c) (b) at 256 on bf16 pools (bf16 on the
   wire, K6's bf16 lane). (d) Preemption rescue from a 24-page replica to
   a peer. (e) ``PrefillDecodePipeline`` over the two replicas. (f) A
   ``FleetController`` over an ``InProcessSpawner``: 1 -> 2 -> 1 under
   bursts, drain-bounced requests replayed, no token twice. (g) Tenants
   3:1 and a quota's 429s. The kernels line's ``launches_fleet`` counts
   the fleet replicas' launches over the parts' fleet traffic only.
   Printed with the card's name and power limit:
   router tokens/s, ms and wire bytes per migrated page, prefill ms
   saved, spawn and drain seconds.

14. ``data_train``: the input path (``gluon.data``, ``pipeline``,
   ``io.recordio``, the vision transforms, ``gluon.contrib.estimator``).
   (a) The prefetcher's stream contract with copies slow against the
   consumer (a spin on the prefetcher's stream before each copy, then on
   the consumer's before each read): every batch equals its source. Then
   phase 5's bf16 GPT-2 small (B 16, T 1024, Adam, dropout 0.1 at
   ``headline_schedule()``) fed from a token corpus of 8 batches through
   ``DataLoader(shuffle, 2 forked workers, pin_memory)`` ->
   ``as_device_iterator(step.input_shardings(), depth=2)`` ->
   ``TrainStep.step(block_every=2)`` -> ``drain()``: finite losses, the
   sampler's batches, K1 and K2 12 times a step each and the plain
   attention never, the losses, parameters and Adam state bit for bit a
   twin's fed the same batches by hand as CUDA tensors; ms a step,
   tokens/s, the input waits, the idle share of step 6 profiled inside
   the fed loop and of the cold first step of a fresh iterator (its fork
   read on its own). (b) The input-bound run: a producer
   sleeping one measured device step, directly and through the
   prefetcher (speedup beside the 2.0x ideal), and H2D GB/s of a batch
   from pinned and pageable memory (printed, not gated). (c) ResNet-50 v1
   in phase 11 (a)'s configuration fed from a .npy RecordIO of 6 x 128
   images (``ImageRecordDataset``, RandomCrop(pad 4), flips, ToTensor,
   Normalize, 4 forked workers, pin_memory): 5 TrainSteps and one
   ``Estimator.fit`` epoch of 2 batches, finite losses, every running
   mean moved; images/s from files beside phase 11 (a)'s. (d)
   ``examples/train_mnist_gluon.py``'s synthetic program, 3 epochs on the
   card with 0 and 2 workers: the loss falls, the accuracy rises, each
   epoch's loss within 1e-5 of the CPU port's. The phase starts only
   with at most LT_HELD_GB still allocated.

15. ``rnn_detect``: ``gluon.rnn`` and the detection ops. (a) An LSTM
   language model at Zaremba et al.'s "medium" width (MXNet's
   word-language-model example): ``Embedding(10000, 650)`` ->
   ``rnn.LSTM(650, num_layers=2, dropout=0.5)`` (cuDNN's fused RNN a
   layer, JAX's dropout masks between) -> ``Dense(10000)``, B 20, bptt
   35, SGD through ``gluon.Trainer`` with ``clip_global_norm`` at 0.25 and
   the hidden state detached between batches, on synthetic tokens from
   ``--seed``: at dropout 0 the card's losses at steps 1-3 within 1e-4 of
   the CPU port's; at 0.5 the dropout masks of one step bit for bit the
   CPU's and the loss falling over 20 steps on a repeated batch; ms a
   step, tokens/s, peak GB, the idle share and device ops of one profiled
   step. A bidirectional GRU at the same width, card against CPU forward
   and backward. (b) SSD-300 post-processing on the 8732 standard anchors,
   B 32, 21 VOC classes, up to 8 boxes an image: ``multibox_target``,
   ``multibox_detection`` (threshold 0.01, NMS 0.45, top 400) and
   ``box_nms`` over one image's [8732, 6] rows, card against CPU (targets,
   masks, kept rows and their order equal; floats within 1e-6); the NMS
   sweep kernel (``csrc/nms_sweep.cu``) bit for bit its plain loop on
   every image, timed beside it. (c) ``roi_align`` (128 RoIs an image on
   [4, 256, 38, 38]) and ``deformable_convolution`` ([8, 256, 28, 28],
   3x3, 256 filters) forward and backward, card against CPU, timed.

16. ``sparse_frontend``: row-sparse gradients and the rest of the
   single-device surface. (a) Phase 15's LSTM LM with
   ``Embedding(10000, 650, sparse_grad=True)``, dropout 0, no clipping:
   3 SGD steps against the dense-gradient model on the card (losses and
   table within 1e-6 relative each step), 3 lazy Adam steps against the
   CPU port (losses within 1e-4; rows no batch touched keep weights and
   both moments bit for bit), ms a step of sparse and dense Adam. (b)
   ``Embedding(793471, 512, sparse_grad=True)`` (the One Billion Word
   Benchmark's vocabulary, MXNet's ``example/rnn/large_word_lm``), lazy
   Adam through ``gluon.Trainer``, 5 steps of 128 x 20 synthetic ids: no
   step peaks above table + moments + 0.5 GB over the memory held before
   the table (no [V, D] gradient or temporary), untouched rows and
   moments bit for bit, touched rows within 1e-5 of the CPU port's; ms
   and peak GB beside the same table with a dense gradient and Adam step.
   (c) The 9 rejection samplers with ``device=`` the card: the CPU port's
   bits, and a KS or chi-square test against ``scipy.stats`` at 20000
   draws, p > 1e-3; ms a call. (d) ``tests/ext/myops.cc`` built into
   ``build/ext`` with g++ and loaded by ``library.load``, and a registered
   ``CustomOp``, forward and backward on the card equal to the CPU;
   ``mx.nd`` arithmetic, reductions and save/load on the card;
   ``test_utils.check_consistency`` CPU against card on three ops;
   NaiveEngine leaves no work pending on the stream; ``runtime.Features()``
   names CUDA; ``print_summary`` of (a)'s model. It starts only with at
   most LT_HELD_GB still allocated.

Informational JSON lines come first; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero without that line. It needs one CUDA card and refuses to
run without one. It imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
LAYERS = 12
TRAIN_B, TRAIN_T, TRAIN_STEPS, TRAIN_LR = 16, 1024, 10, 1e-4
PROFILE_STEPS = 3
# GPTConfig()'s dropout: the training headline's
DEFAULT_DROPOUT = 0.1
# card against CPU (f32, SGD with momentum 0.9 at SGD_LR): each step's
# gradients leaf by leaf (relative L2) and the parameters after 2 steps
# (max abs), about 10x the H100's readings (3.1e-6 and 1.19e-7, one ulp
# of a LayerNorm gain); the bf16 model's step-1 gradients against the f32
# model's, about 2x the worst leaf read there (4.5e-2; a K2 whose outputs
# are all 1% too large moves the f32 gradients by 2.6e-2)
SGD_LR = 0.1
CARD_CPU_GRAD_TOL = 3e-5
CARD_CPU_PARAM_TOL = 1e-6
BF16_GRAD_TOL = 0.1
# phase B's pool: about half of what its 8 requests need together (about
# 300 pages), so requests must be preempted
PAGED_B_PAGES = 160
# the int4 contiguous phase holds the first INT4_CPU_TOKENS tokens of two
# requests against the plain path on the CPU, which dequantizes every int4
# table on every call (about 0.3 s a token at GPT-2 small)
INT4_CPU_TOKENS = 32
# the bf16 stage's CPU comparisons (its int4 model's plain path is the
# slow one above)
BF16_CPU_TOKENS, BF16_INT4_CPU_TOKENS = 32, 16
# bench.py's calibration for its int8 decode headlines: calib_mode 'naive'
# on two batches of [8, 32] tokens
CALIB_BATCHES, CALIB_SHAPE = 2, (8, 32)
# clock cycles the card spins before each timed call (about 0.5 ms at the
# H100's 1.98 GHz): the host enqueues the call while the card is busy, so
# host time (a Python wrapper, a contended CPU) stays outside the events
TIMER_COVER_CYCLES = 1_000_000


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound(nbytes, flops, flop_rate=F32_FLOP_PER_S):
    """(bound_ms, bound_by): the larger of the byte time at HBM rate and
    the operation time at ``flop_rate`` (default: the f32 CUDA-core peak,
    for kernels that run f32 FMAs)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = flops / flop_rate * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


class Timer:
    """Median CUDA-event time of one call, with the 50 MB L2 flushed
    before every timed launch (decode streams each weight once per step,
    so the real caller finds it cold) and the card held busy for
    TIMER_COVER_CYCLES while the host enqueues the call."""

    def __init__(self, torch, iters=15, warmup=3):
        self.torch = torch
        self.iters, self.warmup = iters, warmup
        self.flush = torch.empty(64 * 1024 * 1024, device="cuda")  # 256 MB

    def __call__(self, fn):
        torch = self.torch
        for _ in range(self.warmup):
            fn()
        times = []
        for _ in range(self.iters):
            self.flush.zero_()
            torch.cuda._sleep(TIMER_COVER_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


GEMV_ROWS = (1, 8, 9, 16, 64)
# one block's four GEMVs (qkv, out, fc, proj) and the tied head
GEMV_SHAPES = ((2304, 768), (768, 768), (3072, 768), (768, 3072), (50304, 768))
# Llama-3-8B's: q and o (4096 x 4096), k and v (1024 x 4096), gate and up
# (14336 x 4096), down (4096 x 14336), each with its count in one layer,
# then the head (128256 x 4096); decode rows (warp route) and prefill rows
# (tile route)
LLAMA_LAYER = {(4096, 4096): 2, (1024, 4096): 2, (14336, 4096): 2, (4096, 14336): 1}
LLAMA_GEMV_SHAPES = tuple(LLAMA_LAYER) + ((128256, 4096),)
LLAMA_GEMV_ROWS = (1, 8, 9, 64)


def dequant(torch, w_q, w_scale):
    """The f32 weight a quantized table stands for (int8 or int4 lane)."""
    from mxnet_tpu_torch.ops.int8_gemv import dequantize_int4_table
    if w_q.dtype != torch.uint8:
        return w_q.float() * w_scale[:, None]
    return dequantize_int4_table(w_q, w_scale)


def table_bytes(*tables):
    return sum(t.numel() * t.element_size() for t in tables)


def kernel_gemv(torch, timer, gen, bits, bf16=False, shapes=GEMV_SHAPES, m_rows=GEMV_ROWS,
                layer=None, tag=""):
    """K3 (``bits`` 8) or K4 (4) at every (N, K) of ``shapes`` the serving
    path gives it (GPT-2 small's by default; the last is the head), at each
    row count of ``m_rows``: the warp route at 1 and 8 rows, the tile route
    at 9, 16 and 64. ``layer`` maps each block shape to its count in one
    layer (default: once each); ``tag`` suffixes the emitted names. Every
    call within 1e-4 x max(1, |plain|); the first 9 rows of the tile route
    give the same bits at every tile M, and two launches at the most rows
    the same bits. ``bf16``: the bf16 x lane (block 0 of a bf16 model),
    which must also give the f32 lane's result on x.float() bit for bit on
    both routes; its library yardstick is ``torch.matmul`` of bf16 x on the
    dequantized bf16 weight. The bound of every call is the larger of its
    bytes and its operations at the bf16 tensor rate, whichever route runs
    it. Returns {"warp": one layer's GEMVs at 8 rows, summed, "mma": the
    same at 64 rows, with the 16-row sums under "m16" (None where 16 is
    not a row count); the 1-row sums under "m1" of "warp"; "rows": every
    call's row}."""
    from mxnet_tpu_torch.contrib.quantization import _quantize_int4
    from mxnet_tpu_torch.ops import int8_gemv
    name = ("K3" if bits == 8 else "K4") + ("_bf16" if bf16 else "") + tag
    head_n = shapes[-1][0]
    layer = layer or {shape: 1 for shape in shapes[:-1]}
    xsize = 2 if bf16 else 4
    fn = int8_gemv.int8_weight_matmul if bits == 8 else int8_gemv.int4_weight_matmul
    plain = int8_gemv._reference_int8_matmul if bits == 8 else int8_gemv._reference_int4_matmul
    rows, same_bits = [], []
    for N, K in shapes:
        x64 = torch.randn(max(m_rows), K, device="cuda", generator=gen)
        if bf16:
            x64 = x64.bfloat16()
        if bits == 8:
            w = torch.randint(-127, 128, (N, K), device="cuda", generator=gen, dtype=torch.int8)
            s = torch.rand(N, device="cuda", generator=gen) * 0.02 + 1e-3
        else:
            w, s = _quantize_int4(torch.randn(N, K, device="cuda", generator=gen))
        wdeq = dequant(torch, w, s)
        if bf16:
            wdeq = wdeq.bfloat16()
        outs = {}
        for M in m_rows:
            x = x64[:M].contiguous()
            got = fn(x, w, s)
            want = plain(x, w, s)
            if bf16:
                wide = fn(x.float(), w, s)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            tol = 1e-4 * max(1.0, want.abs().max().item())
            check(err <= tol, f"{name} M={M} N={N} K={K}: max abs err {err} > {tol}")
            if bf16:
                check(torch.equal(got.view(torch.int32), wide.view(torch.int32)),
                      f"{name} M={M} N={N} K={K}: the bf16 lane is not the f32 lane on "
                      f"x.float() bit for bit (max abs {(got - wide).abs().max().item()})")
            outs[M] = got
            # the products, and for int4 one block-scale multiply per partial sum
            b_ms, b_by = bound(xsize * M * K + table_bytes(w, s) + 4 * M * N,
                               2 * M * N * K + (M * s.numel() if bits == 4 else 0),
                               BF16_FLOP_PER_S)
            rows.append({
                "M": M, "N": N, "K": K, "route": int8_gemv.gemv_route(M),
                "max_abs_err": err, "tol": tol,
                "ms": timer(lambda: fn(x, w, s)),
                "plain_ms": timer(lambda: plain(x, w, s)),
                "library_ms": timer(lambda: torch.matmul(x, wdeq.T)),
                "bound_ms": b_ms, "bound_by": b_by,
                "bytes": xsize * M * K + table_bytes(w, s) + 4 * M * N})
        tile = [M for M in m_rows if int8_gemv.gemv_route(M) == "mma"]
        lo = min(tile)
        again = fn(x64, w, s)
        torch.cuda.synchronize()
        row = {"N": N, "K": K,
               "rows_equal_across_M": all(torch.equal(outs[M][:lo], outs[lo]) for M in tile),
               "repeat_equal": torch.equal(again, outs[max(tile)])}
        check(row["rows_equal_across_M"] and row["repeat_equal"],
              f"{name} tile route N={N} K={K}: bits differ across M {tile} or launches: {row}")
        row["warp_max_abs_err"] = warp_rows(torch, name, fn, plain, x64, w, s, outs[8], bf16)
        same_bits.append(row)
    emit({name.lower() + "_shapes": rows, name.lower() + "_tile_same_bits": same_bits})

    def layer_sums(M):
        # the serving path's work: one layer's block GEMVs at M rows
        mine = [(r, layer[r["N"], r["K"]]) for r in rows
                if r["M"] == M and (r["N"], r["K"]) in layer]
        if not mine:
            return None
        out = {k: sum(n * r[k] for r, n in mine) for k in ("ms", "plain_ms", "library_ms")}
        out["bound_ms"], out["bound_by"] = bound(
            sum(n * r["bytes"] for r, n in mine),
            sum(n * (2 * M * r["N"] * r["K"] + (M * r["N"] * r["K"] // 128 if bits == 4
                                                 else 0)) for r, n in mine),
            BF16_FLOP_PER_S)
        return out

    warp = layer_sums(8)
    warp["max_abs_err"] = max(max(r["max_abs_err"] for r in rows if r["route"] == "warp"),
                              max(r["warp_max_abs_err"] for r in same_bits))
    warp["m1"] = layer_sums(1)
    mma = layer_sums(64)
    mma["max_abs_err"] = max(r["max_abs_err"] for r in rows if r["route"] == "mma")
    mma["m16"] = layer_sums(16)
    # the tied head on the warp route (token 0, and every decode substep of a
    # multi_token=1 engine)
    head = {f"m{M}": next(r for r in rows if r["N"] == head_n and r["M"] == M) for M in (1, 8)}
    head["max_abs_err"] = max(head["m1"]["max_abs_err"], head["m8"]["max_abs_err"],
                              next(r["warp_max_abs_err"] for r in same_bits if r["N"] == head_n))
    return {"warp": warp, "mma": mma, "head": head, "rows": rows}


def warp_rows(torch, name, fn, plain, x64, w, s, full, bf16):
    """The warp route at every decode row count M = 1..8: within 1e-4 x
    max(1, |plain|), row r the same bits as in the 8-row call ``full`` and
    on a second launch, and (``bf16``) the f32 lane's bits on x.float().
    Returns the largest error."""
    N, K = w.shape[0], x64.shape[1]
    worst = 0.0
    for M in range(1, 9):
        x = x64[:M].contiguous()
        got, again, want = fn(x, w, s), fn(x, w, s), plain(x, w, s)
        wide = fn(x.float(), w, s) if bf16 else got
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = 1e-4 * max(1.0, want.abs().max().item())
        check(err <= tol, f"{name} warp route M={M} N={N} K={K}: max abs err {err} > {tol}")
        check(torch.equal(got.view(torch.int32), full[:M].view(torch.int32))
              and torch.equal(got.view(torch.int32), again.view(torch.int32)),
              f"{name} warp route N={N} K={K}: rows at M={M} differ from the 8-row call's "
              "or from a second launch")
        check(torch.equal(got.view(torch.int32), wide.view(torch.int32)),
              f"{name} warp route M={M} N={N} K={K}: the bf16 lane is not the f32 lane on "
              "x.float() bit for bit")
        worst = max(worst, err)
    return worst


def pack_bytes(pack):
    """Bytes of a block pack's weights, scales, biases and LayerNorms."""
    D = pack["ln1"][0].shape[0]
    return sum(table_bytes(*pack[k]) for k in ("qkv", "out", "fc", "proj")) + 4 * 4 * D


def pack_ops(pack, B):
    """Operations of a block step's four GEMVs at B rows: the products, and
    for an int4 pack one block-scale multiply per partial sum."""
    D = pack["ln1"][0].shape[0]
    scales = sum(pack[k][1].numel() for k in ("qkv", "out", "fc", "proj"))
    return 2 * B * 12 * D * D + (B * scales if pack["blocks"] else 0)


# bf16 lanes of K5-K7 against their plain versions: the output within one
# bf16 rounding of its scale (a LayerNorm value of a bf16 row one ulp apart,
# its statistics summed in another order, moves the output by about that),
# and written bf16 cache rows within one bf16 ulp of the plain version's
BF16_ROUND = 2.0 ** -8


def bf16_ulp(torch, t):
    """One bf16 ulp of each value of ``t`` (2**-7 of its binade)."""
    a = t.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def hold_block(torch, name, out, plain, news, refs, olds, written, compared=None):
    """A block kernel's step against its plain version: cache or pool rows
    outside ``written`` bitwise unchanged in both; the output and the
    ``compared`` rows (default: the written ones) within 1e-4 x max(1,
    |plain|) for f32 caches (f32 sums in another order). For bf16 caches
    the output within BF16_ROUND x max(1, |plain|), and each compared row,
    the f32 value of the kernel or the plain version rounded once to bf16,
    within that f32 rule plus one bf16 ulp of the plain row (two values
    that close round to neighbouring bf16 values at most). Returns (max
    abs error, output tolerance)."""
    compared = written if compared is None else compared
    bf16 = news[0].dtype == torch.bfloat16
    for new, ref, old in zip(news, refs, olds):
        check(torch.equal(new[~written], old[~written])
              and torch.equal(ref[~written], old[~written]),
              f"{name} touched cache rows other than the new rows")
    f32_tol = 1e-4 * max(1.0, plain.abs().max().item())
    tol = BF16_ROUND * max(1.0, plain.abs().max().item()) if bf16 else f32_tol
    out_err = (out - plain).abs().max().item()
    check(out_err <= tol, f"{name}: output max abs err {out_err} > {tol}")
    row_err = 0.0
    for new, ref in zip(news, refs):
        d = (new[compared].float() - ref[compared].float()).abs()
        row_err = max(row_err, d.max().item())
        lim = f32_tol + (bf16_ulp(torch, ref[compared]) if bf16 else 0.0)
        check(bool((d <= lim).all()),
              f"{name}: written rows differ from the plain ones by {row_err}")
    return max(out_err, row_err), tol


def kernel_k5(torch, timer, gen, pack, bf16=False):
    """K5 at B=8, D=768, H=12, L=1024 with mixed per-row positions. ``bf16``:
    bf16 caches, timed at bf16 x (block 0 of a bf16 model) and also checked
    at f32 x (every later block)."""
    from mxnet_tpu_torch.ops import fused_block_gemv as fb
    B, D, H, L = 8, 768, 12, 1024
    hd = D // H
    dt = torch.bfloat16 if bf16 else torch.float32
    name = "K5" + ("_bf16" if bf16 else "")
    pos = torch.tensor([1000, 3, 517, 64, 999, 250, 0, 777], dtype=torch.int32,
                       device="cuda")
    x = torch.randn(B, 1, D, device="cuda", generator=gen).to(dt)
    kc = (torch.randn(B, H, L, hd, device="cuda", generator=gen) * 0.1).to(dt)
    vc = (torch.randn(B, H, L, hd, device="cuda", generator=gen) * 0.1).to(dt)
    written = torch.zeros(B, H, L, dtype=torch.bool, device="cuda")
    written[torch.arange(B, device="cuda"), :, pos.long()] = True
    err, tol = 0.0, 0.0
    for xin in ((x, x.float()) if bf16 else (x,)):
        k1, v1, k2, v2 = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        out, _, _ = fb.fused_block_decode(xin, pos, k1, v1, pack)
        plain, _, _ = fb._reference_block_decode(xin, pos, k2, v2, pack)
        torch.cuda.synchronize()
        e, tol = hold_block(torch, f"{name} (x {xin.dtype})", out, plain, (k1, v1), (k2, v2),
                            (kc, vc), written)
        err = max(err, e)
    attended = int((pos.long() + 1).sum().item()) * H
    isz = 2 if bf16 else 4
    nbytes = (pack_bytes(pack)                             # weights, scales, biases, LN
              + isz * B * D + 4 * B * D + 4 * B            # x, out, pos
              + attended * hd * isz * 2                    # K/V rows read
              + B * H * hd * isz * 2)                      # new rows written
    flops = pack_ops(pack, B) + attended * hd * 4
    b_ms, b_by = bound(nbytes, flops)
    # every row at position 64, the smoke traffic's range: the step is
    # then almost all weight GEMVs, which splits K5's time into its phases
    pos64 = torch.full((B,), 64, dtype=torch.int32, device="cuda")
    return {"max_abs_err": err, "tol": tol,
            "ms_pos64": timer(lambda: fb.fused_block_decode(x, pos64, k1, v1, pack)),
            "ms": timer(lambda: fb.fused_block_decode(x, pos, k1, v1, pack)),
            "plain_ms": timer(lambda: fb._reference_block_decode(x, pos, k2, v2, pack)),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "shape": {"B": B, "D": D, "H": H, "L": L, "pos": pos.tolist(),
                      "x": str(x.dtype), "cache": str(kc.dtype)}}


def paged_inputs(torch, gen, D, H, B, ps, maxp, pool, pos, dtype=None):
    """Seeded paged decode inputs on the card: x, positions, block tables
    over a ``pool``-page pool + sink with scattered pages (each active row
    leases the pages that cover its position; rows 0 and 1 share their
    first two pages, below both positions; the last row is inactive: table
    all sink, position 0) and N(0, 0.1) pools; x and the pools in
    ``dtype`` (default f32)."""
    hd = D // H
    cpu = torch.Generator().manual_seed(int(gen.initial_seed()))
    perm = torch.randperm(pool, generator=cpu).tolist()
    table = torch.full((B, maxp), pool, dtype=torch.int32)
    for b in range(B - 1):
        need = min(pos[b], ps * maxp - 1) // ps + 1
        for i in range(need):
            table[b, i] = table[0, i] if b == 1 and i < 2 else perm.pop()
    assert pos[B - 1] == 0 and min(pos[0], pos[1]) >= 2 * ps
    dev = gen.device
    dt = torch.float32 if dtype is None else dtype
    x = torch.randn(B, 1, D, device=dev, generator=gen).to(dt)
    kp = (torch.randn(pool + 1, H, ps, hd, device=dev, generator=gen) * 0.1).to(dt)
    vp = (torch.randn(pool + 1, H, ps, hd, device=dev, generator=gen) * 0.1).to(dt)
    posv = torch.tensor(pos, dtype=torch.int32, device=dev)
    return x, posv, table.to(dev), kp, vp


def paged_written(torch, posv, table, pool, ps):
    """[pool + 1, ps] bool: the (page, row) each row's new K/V lands in,
    plus the whole sink page (written by inactive rows, never compared)."""
    L = table.shape[1] * ps
    mask = torch.zeros(pool + 1, ps, dtype=torch.bool, device=posv.device)
    for b, p in enumerate(posv.tolist()):
        if p < L:
            mask[table[b, p // ps], p % ps] = True
    mask[pool] = True
    return mask


def check_paged(torch, fb, name, inputs, pack, streamed, pool, ps):
    """Run K6 or K7 and its plain version on copies of ``inputs``: every
    pool entry outside the written rows and the sink page bitwise
    unchanged in both, written rows and the output by ``hold_block``'s rule
    for the pools' dtype. K7 also counts its copies into device counters,
    which must equal each other and the ``record_dma`` ledger. Returns the
    row."""
    from mxnet_tpu_torch.ops.int8_gemv import dma_ledger, launches, reset_launches
    x, posv, table, kp, vp = inputs
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    counters = torch.zeros(2, dtype=torch.int32, device=x.device)
    reset_launches()
    out, _, _ = fb.fused_block_decode_paged(x, posv, table, k1, v1, pack,
                                            dma_counters=counters)
    kind = launches()
    ledger = dma_ledger()
    plain, _, _ = fb._reference_block_decode_paged(x, posv, table, k2, v2, pack)
    sync(torch, x.device)
    want = ("fused_block_paged_dma" if streamed else "fused_block_paged") + fb._kind_suffix(pack)
    check(kind == {want: 1}, f"{name}: routed to {kind}, expected {want}")
    written = paged_written(torch, posv, table, pool, ps)[:, None, :].expand(-1, kp.shape[1], -1)
    nonsink = written.clone()
    nonsink[pool] = False
    err, tol = hold_block(torch, name, out, plain, (k1, v1), (k2, v2), (kp, vp), written,
                          nonsink)
    row = {"max_abs_err": err, "tol": tol}
    H, hd = kp.shape[1], kp.shape[3]
    L = table.shape[1] * ps
    pages = sum(min(p, L - 1) // ps + 1 for p in posv.tolist())
    if streamed:
        # the plain version on the CPU counts no copies of its own
        got = counters.tolist() if x.is_cuda else [ledger["copies"]] * 2
        check(got[0] == got[1] == ledger["copies"] == ledger["waits"] == 2 * H * pages
              and ledger["bytes"] == ledger["copies"] * ps * hd * kp.element_size(),
              f"{name}: copies started/waited {got}, ledger {ledger}, "
              f"expected {2 * H * pages}")
        row["copies_started_waited"] = got
        row["dma_ledger"] = ledger
    else:
        check(counters.tolist() == [0, 0] and ledger["copies"] == 0,
              f"{name}: K6 recorded copies {ledger}")
    return row


def paged_bound(x, posv, table, kp, ps, pack):
    """(bound_ms, bound_by) of one paged block step: weights, scales,
    biases, LN, x, out, positions and table, the attended K/V rows, the new
    rows."""
    B, _, D = x.shape
    H, hd = kp.shape[1], kp.shape[3]
    L = table.shape[1] * ps
    isz = kp.element_size()
    attended = sum(min(p, L - 1) + 1 for p in posv.tolist()) * H
    nbytes = (pack_bytes(pack) + x.element_size() * B * D + 4 * B * D + 4 * B
              + 4 * table.numel() + attended * hd * isz * 2 + B * H * hd * isz * 2)
    return bound(nbytes, pack_ops(pack, B) + attended * hd * 4)


def kernel_k6_k7(torch, timer, gen, pack, pool=600, ps=16, dtype=None):
    """K6 at B 16, L 256 and K7 at B 8, L 1024, each against its plain
    version; K7 at L 256 against K6 (and K6 against K5 on the gathered
    contiguous view): same bits. K6 is also timed at B 8 (``ms_b8``: its
    first 7 positions and an inactive row). ``dtype`` bf16: x and pools
    bf16 (block 0 of a bf16 model), also checked at f32 x (its later
    blocks)."""
    from mxnet_tpu_torch.ops import fused_block_gemv as fb
    D, H = pack["ln1"][0].shape[0], pack["heads"]
    rng = __import__("numpy").random.RandomState(int(gen.initial_seed()) + 6)
    pos6 = [200, 255, 33] + rng.randint(0, 256, 12).tolist() + [0]
    pos7 = [1023, 517, 64, 999, 250, 777, 3, 0]
    out = {}
    for name, B, maxp, pos, streamed in (("K6", 16, 16, pos6, False),
                                         ("K7", 8, 64, pos7, True)):
        inputs = paged_inputs(torch, gen, D, H, B, ps, maxp, pool, pos, dtype)
        row = check_paged(torch, fb, name, inputs, pack, streamed, pool, ps)
        if dtype is not None and dtype != torch.float32:
            wide = (inputs[0].float(),) + inputs[1:]
            e = check_paged(torch, fb, name + " (x f32)", wide, pack, streamed, pool, ps)
            row["max_abs_err"] = max(row["max_abs_err"], e["max_abs_err"])
        x, posv, table, kp, vp = inputs
        row["bound_ms"], row["bound_by"] = paged_bound(x, posv, table, kp, ps, pack)
        row["ms"] = timer(lambda: fb.fused_block_decode_paged(x, posv, table, kp, vp, pack))
        k2, v2 = kp.clone(), vp.clone()
        row["plain_ms"] = timer(lambda: fb._reference_block_decode_paged(x, posv, table, k2,
                                                                         v2, pack))
        row["library_ms"] = None
        row["shape"] = {"B": B, "D": D, "H": H, "ps": ps, "L": maxp * ps,
                        "pool_pages": pool, "pos": pos}
        if name == "K6":
            # beside B 16: the first 7 rows and the inactive one, one row tile
            x8, p8, t8, kp8, vp8 = paged_inputs(torch, gen, D, H, 8, ps, maxp, pool,
                                                pos[:7] + [0], dtype)
            row["ms_b8"] = timer(lambda: fb.fused_block_decode_paged(x8, p8, t8, kp8, vp8,
                                                                     pack))
            row["bound_ms_b8"] = paged_bound(x8, p8, t8, kp8, ps, pack)[0]
        out[name] = row
    out["K7_vs_K6_L256"] = same_bits_k5_k6_k7(torch, fb, gen, pack, pool, ps, pos6,
                                              dtype=dtype)
    return out


def same_bits_k5_k6_k7(torch, fb, gen, pack, pool, ps, pos, maxp=16, dtype=None):
    """K6 and K7 on one input at L 256 give the same output and pools bit
    for bit, and K5 on the gathered contiguous view gives K6's output (x
    and pools in ``dtype``, default f32)."""
    D, H = pack["ln1"][0].shape[0], pack["heads"]
    x, posv, table, kp, vp = paged_inputs(torch, gen, D, H, len(pos), ps, maxp, pool, pos,
                                          dtype)
    B = len(pos)
    view = [p[table.long()].transpose(1, 2).reshape(B, H, maxp * ps, -1).contiguous()
            for p in (kp, vp)]
    k6, v6, k7, v7 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    # the kernels called directly: at L 256 both gates accept, routing takes K6
    o6, _, _ = fb._cuda_block_decode_paged(x, posv, table, k6, v6, pack, False, None)
    o7, _, _ = fb._cuda_block_decode_paged(x, posv, table, k7, v7, pack, True, None)
    o5, _, _ = fb.fused_block_decode(x, posv, view[0], view[1], pack)
    torch.cuda.synchronize()
    row = {"k7_equal_k6": bool(torch.equal(o6, o7) and torch.equal(k6, k7)
                               and torch.equal(v6, v7)),
           "k6_equal_k5": bool(torch.equal(o5, o6)),
           "max_abs_k7_k6": (o7 - o6).abs().max().item(),
           "max_abs_k6_k5": (o6 - o5).abs().max().item()}
    check(row["k7_equal_k6"] and row["k6_equal_k5"], f"K5/K6/K7 bits differ: {row}")
    return row


def kernel_k8(torch, timer, gen, head):
    """K8 at B=8 over the padded GPT-2 table (int8, or the int4 lane for a
    uint8 table), 4 greedy and 4 T=0.8 rows; then all 8 rows greedy against
    the argmax of the head GEMV (K3 or K4), bit for bit; and at B=16 (paged
    A's batch: two row tiles), [B, 2] keys, against the plain version. Times
    the warp-route head GEMV + ``argmax`` beside it (``warp_head_argmax_ms``:
    the selection K8 fuses, in two launches). The bound counts the
    operations at the bf16 tensor rate, as kernel_gemv's does."""
    import numpy as np

    from mxnet_tpu_torch.models.generation import _key_bits
    from mxnet_tpu_torch.ops import fused_block_gemv as fb
    from mxnet_tpu_torch.ops import int8_gemv
    w_q, scale, vocab = head
    int4 = w_q.dtype == torch.uint8
    B, D = 8, w_q.shape[1] * (2 if int4 else 1)
    Vp = w_q.shape[0]
    h = torch.randn(B, D, device="cuda", generator=gen)
    temps = torch.tensor([0.0] * 4 + [0.8] * 4, device="cuda")
    kb = torch.from_numpy(_key_bits(np.arange(B) + 100, np.arange(B))).cuda()
    got = fb.fused_lm_head_sample(h, w_q, scale, vocab, kb, temps)
    plain = fb._reference_head_sample(h, w_q, scale, vocab, temps, kb)
    greedy = fb.fused_lm_head_sample(h, w_q, scale, vocab, kb, torch.zeros(B, device="cuda"))
    argmax = int8_gemv.weight_matmul(h, w_q, scale)[:, :vocab].argmax(-1)
    torch.cuda.synchronize()
    check(torch.equal(got, plain), f"K8 tokens {got.tolist()} != {plain.tolist()}")
    check(torch.equal(greedy.long(), argmax),
          f"K8 greedy {greedy.tolist()} != head GEMV + argmax {argmax.tolist()}")
    h16 = torch.randn(16, D, device="cuda", generator=gen)
    keys16 = torch.from_numpy(np.stack(
        [np.arange(16) * 7919 + 1, _key_bits(np.arange(16) + 300, np.arange(16))], -1)).cuda()
    temps16 = torch.tensor([0.0, 0.8] * 8, device="cuda")
    got16 = fb.fused_lm_head_sample(h16, w_q, scale, vocab, keys16, temps16)
    plain16 = fb._reference_head_sample(h16, w_q, scale, vocab, temps16,
                                        keys16[:, 0] ^ keys16[:, 1])
    torch.cuda.synchronize()
    check(torch.equal(got16, plain16), f"K8 at 16 rows: tokens {got16.tolist()} != plain "
          f"{plain16.tolist()}")
    wdeq = dequant(torch, w_q, scale)
    b_ms, b_by = bound(table_bytes(w_q, scale) + 4 * B * D + 12 * B,
                       2 * B * Vp * D + (B * scale.numel() if int4 else 0), BF16_FLOP_PER_S)
    return {"max_abs_err": 0.0, "tokens": got.tolist(), "greedy_equal_gemv_argmax": True,
            "ms": timer(lambda: fb.fused_lm_head_sample(h, w_q, scale, vocab, kb, temps)),
            "plain_ms": timer(lambda: fb._reference_head_sample(h, w_q, scale, vocab,
                                                                temps, kb)),
            "library_ms": timer(lambda: torch.argmax(torch.matmul(h, wdeq.T), -1)),
            "warp_head_argmax_ms": timer(lambda: torch.argmax(
                int8_gemv.weight_matmul(h, w_q, scale)[:, :vocab], -1)),
            "bound_ms": b_ms, "bound_by": b_by}


# direct calls of K8's mask and bf16 lanes in their launch-counting phase
K8_LANE_CALLS = 16
# how phase 9 (d) reaches K8's bf16 lane: off every public path
K8_BF16_LLAMA_PATH = ("from a Llama engine only through the private "
                      "_quantize_tied_lm_head on a stacked bf16 Llama")


def kernel_k8_lanes(torch, timer, gen, head):
    """K8's grammar-mask lane (f32 h) and bf16 lane (bf16 h, logits rounded
    through bf16) at B=8 over the padded GPT-2 table, 4 greedy and 4 T=0.8
    rows. No path of the JAX package hands K8 a mask or bf16 h, so the lanes
    are driven by K8_LANE_CALLS direct calls each, counted from 0 (the
    rows' launches). Then, outside the count: tokens equal the plain
    version's; masked tokens are allowed lanes and greedy ones the masked
    head GEMV + argmax; bf16 h gives h.float()'s tokens and greedy rows the
    argmax of the head GEMV's logits rounded to bf16; all bit for bit.
    Library yardsticks: ``matmul`` + masked ``argmax``; bf16 ``matmul`` +
    ``argmax``. Bounds as kernel_k8's. Returns {"mask": row, "bf16": row}."""
    import numpy as np

    from mxnet_tpu_torch.models.generation import _key_bits
    from mxnet_tpu_torch.ops import fused_block_gemv as fb
    from mxnet_tpu_torch.ops import int8_gemv
    w_q, scale, vocab = head
    int4 = w_q.dtype == torch.uint8
    sfx = "_int4" if int4 else ""
    B, D = 8, w_q.shape[1] * (2 if int4 else 1)
    Vp = w_q.shape[0]
    bf16 = torch.bfloat16
    h = torch.randn(B, D, device="cuda", generator=gen)
    hb = h.to(bf16)
    temps = torch.tensor([0.0] * 4 + [0.8] * 4, device="cuda")
    zeros = torch.zeros(B, device="cuda")
    kb = torch.from_numpy(_key_bits(np.arange(B) + 200, np.arange(B))).cuda()
    masks = [torch.rand(B, vocab, device="cuda", generator=gen) < 0.3
             for _ in range(K8_LANE_CALLS)]
    int8_gemv.reset_launches()
    for m in masks:
        fb.fused_lm_head_sample(h, w_q, scale, vocab, kb, temps, mask=m)
    for _ in range(K8_LANE_CALLS):
        fb.fused_lm_head_sample(hb, w_q, scale, vocab, kb, temps, out_dtype=bf16)
    torch.cuda.synchronize()
    lanes = int8_gemv.dtype_lanes()
    n_mask = lanes.get(f"fused_head{sfx}:h_f32:mask", 0)
    n_bf16 = lanes.get(f"fused_head{sfx}:h_bf16:bf16_logits", 0)

    mask = masks[0]
    mask_p = torch.zeros(B, Vp, dtype=torch.bool, device="cuda")
    mask_p[:, :vocab] = mask
    got = fb.fused_lm_head_sample(h, w_q, scale, vocab, kb, temps, mask=mask)
    plain = fb._reference_head_sample(h, w_q, scale, vocab, temps, kb, mask=mask_p)
    greedy = fb.fused_lm_head_sample(h, w_q, scale, vocab, kb, zeros, mask=mask)
    logits = int8_gemv.weight_matmul(h, w_q, scale)[:, :vocab]
    masked_argmax = logits.masked_fill(~mask, float("-inf")).argmax(-1)
    gb = fb.fused_lm_head_sample(hb, w_q, scale, vocab, kb, temps, out_dtype=bf16)
    gw = fb.fused_lm_head_sample(hb.float(), w_q, scale, vocab, kb, temps, out_dtype=bf16)
    pb = fb._reference_head_sample(hb.float(), w_q, scale, vocab, temps, kb, out_dtype=bf16)
    greedy_b = fb.fused_lm_head_sample(hb, w_q, scale, vocab, kb, zeros, out_dtype=bf16)
    argmax_b = int8_gemv.weight_matmul(hb, w_q, scale)[:, :vocab].to(bf16).float().argmax(-1)
    torch.cuda.synchronize()
    check(torch.equal(got, plain), f"K8{sfx} mask lane: tokens {got.tolist()} != plain "
          f"{plain.tolist()}")
    check(bool(mask.gather(1, got.long()[:, None]).all())
          and bool(mask.gather(1, greedy.long()[:, None]).all()),
          f"K8{sfx} mask lane: a token on a forbidden lane")
    check(torch.equal(greedy.long(), masked_argmax),
          f"K8{sfx} mask lane: greedy {greedy.tolist()} != masked head GEMV + argmax "
          f"{masked_argmax.tolist()}")
    check(torch.equal(gb, pb) and torch.equal(gb, gw),
          f"K8{sfx} bf16 lane: tokens {gb.tolist()}, on h.float() {gw.tolist()}, plain "
          f"{pb.tolist()}")
    check(torch.equal(greedy_b.long(), argmax_b),
          f"K8{sfx} bf16 lane: greedy {greedy_b.tolist()} != head GEMV + bf16 + argmax "
          f"{argmax_b.tolist()}")
    wdeq = dequant(torch, w_q, scale)
    wdeq_b = wdeq.to(bf16)
    ops = 2 * B * Vp * D + (B * scale.numel() if int4 else 0)
    ninf = torch.tensor(float("-inf"), device="cuda")
    rows = {}
    for lane_name, n, xsize, extra, fn, plain_fn, lib in (
            ("mask", n_mask, 4, B * Vp,
             lambda: fb.fused_lm_head_sample(h, w_q, scale, vocab, kb, temps, mask=mask),
             lambda: fb._reference_head_sample(h, w_q, scale, vocab, temps, kb, mask=mask_p),
             lambda: torch.argmax(torch.where(mask, torch.matmul(h, wdeq.T)[:, :vocab], ninf),
                                  -1)),
            ("bf16", n_bf16, 2, 0,
             lambda: fb.fused_lm_head_sample(hb, w_q, scale, vocab, kb, temps, out_dtype=bf16),
             lambda: fb._reference_head_sample(hb.float(), w_q, scale, vocab, temps, kb,
                                               out_dtype=bf16),
             lambda: torch.argmax(torch.matmul(hb, wdeq_b.T), -1))):
        b_ms, b_by = bound(table_bytes(w_q, scale) + xsize * B * D + extra + 12 * B, ops,
                           BF16_FLOP_PER_S)
        rows[lane_name] = {"launches": n, "max_abs_err": 0.0, "tokens_equal_plain": True,
                           "ms": timer(fn), "plain_ms": timer(plain_fn),
                           "library_ms": timer(lib), "bound_ms": b_ms, "bound_by": b_by}
    return rows


def nucleus_away_from_edges(np, logits, temps, topks, rows):
    """top_p per row: 1 outside ``rows``; in them halfway between two
    exclusive prefix sums (1e-4 or more apart) of the row's sorted,
    temperature-scaled, top-k-filtered probabilities, so that no cumsum
    rounding of either device moves the nucleus cut."""
    topps = np.ones(len(temps), np.float32)
    for b in rows:
        z = np.sort(logits[b].astype(np.float64) / (temps[b] if temps[b] > 0 else 1.0))[::-1]
        z = z[:topks[b]] if topks[b] > 0 else z
        pr = np.exp(z - z.max())
        excl = np.concatenate([[0.0], np.cumsum(pr / pr.sum())[:-1]])
        wide = [j for j in range(len(excl) - 1) if excl[j + 1] - excl[j] > 1e-4]
        j = wide[len(wide) // 2]
        topps[b] = (excl[j] + excl[j + 1]) / 2
    return topps


def sampling_card(torch, args, timer):
    """JAX's sampling stream on the card: ``_prng`` bits, a split-chain
    ``categorical`` and keyed ``sample_tokens`` (greedy, plain, top-k and
    top-p rows over GPT-2's vocab) on device logits, against the same calls
    on their CPU copies: bits equal, tokens equal."""
    import numpy as np

    from mxnet_tpu_torch import _prng
    from mxnet_tpu_torch.models.generation import sample_tokens
    rng = np.random.RandomState(args.seed + 7)
    B, V = 8, 50257
    logits = (rng.randn(B, V) * 3).astype(np.float32)
    temps = np.array([0.0, 0.8, 1.0, 0.7, 1.3, 0.0, 0.9, 1.1], np.float32)
    topks = np.array([0, 0, 40, 0, 200, 5, 0, 1000])
    topps = nucleus_away_from_edges(np, logits, temps, topks, (3, 4, 7))
    seeds, counters = np.arange(B) * 7919 + args.seed, np.arange(B) * 3
    kc = _prng.fold_keys(seeds, counters)
    kd = _prng.fold_keys(seeds, counters, "cuda")
    bits_equal = bool(torch.equal(_prng.random_bits(kd, (V,)).cpu(), _prng.random_bits(kc, (V,))))
    check(bits_equal, "threefry bits on the card differ from the CPU's")
    lc, ld = torch.from_numpy(logits), torch.from_numpy(logits).cuda()
    want = sample_tokens(lc, kc, temps, topks, topps)
    got = sample_tokens(ld, kd, temps, topks, topps).cpu()
    check(torch.equal(got, want), f"sample_tokens on the card {got.tolist()} != CPU "
          f"{want.tolist()}")
    key = _prng.split(_prng.key(args.seed))[1]
    one_c = _prng.categorical(key, lc)
    one_d = _prng.categorical(key.cuda(), ld).cpu()
    check(torch.equal(one_c, one_d), "split-chain categorical on the card differs from the CPU's")
    return {"B": B, "V": V, "bits_equal": bits_equal, "tokens": got.tolist(),
            "tokens_equal_cpu": True, "split_chain_equal_cpu": True,
            "sample_tokens_ms": timer(lambda: sample_tokens(ld, kd, temps, topks, topps))}


def first_divergence(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None


def top2_gap(torch, net, tokens):
    """(top-1 minus top-2 logit, top-1 logit) of ``net`` after ``tokens``
    (plain path)."""
    ids = torch.tensor([tokens], dtype=torch.int32, device=net.device)
    caches = net.new_caches(1, len(tokens))
    with torch.no_grad():
        logits = net.forward_cached(ids, 0, *caches)[0][0, -1]
    top = torch.topk(logits.float(), 2).values
    return (top[0] - top[1]).item(), top[0].item()


def gap_limit(torch, net, top):
    """The top-2 gap below which the card and the CPU may pick different
    greedy tokens: 1e-3 for f32 models; for bf16 ones also two bf16
    roundings of the top logit (the kernels' bf16 LayerNorm of block 0
    sums its statistics in another order than the CPU, which can move a
    normalised value by one bf16 ulp)."""
    if net.cfg.dtype == torch.bfloat16:
        return max(1e-3, 2 * BF16_ROUND * abs(top))
    return 1e-3


# a chrome trace's categories of device work
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_spans(prof, trace=None):
    """The device's kernel, copy and memset intervals of a finished
    ``torch.profiler`` run (CUDA activity only, so every device event is
    one of them), sorted, as (start us, end us, name), read from the
    profiler's own events: a chrome trace of a paged window holds 300k
    device spans, which cost seconds to write and parse. With ``trace`` (a
    file name under build/profile/) the chrome trace is also written, and
    its DEVICE_CATEGORIES events must give the same names and the same
    busy time."""
    from torch._C._autograd import DeviceType
    ns = [(e.start_ns(), e.duration_ns(), e.name()) for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA]
    t0 = min((a for a, _, _ in ns), default=0)      # us since the first, in float64
    spans = sorted(((a - t0) / 1e3, (a - t0 + d) / 1e3, name) for a, d, name in ns)
    if trace is not None:
        from mxnet_tpu_torch import _build
        path = _build.BUILD_DIR.parent / "profile" / trace
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        traced = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES)
        check(sorted(n for _, _, n in traced) == sorted(n for _, _, n in spans)
              and abs(busy_us(traced) - busy_us(spans)) <= 1e-3 * (len(spans) + 1),
              f"profiler events ({len(spans)} device spans, {busy_us(spans)} us busy) "
              f"differ from the chrome trace ({len(traced)}, {busy_us(traced)} us)")
    return spans


def busy_us(spans):
    """The union of sorted device intervals, in us."""
    busy, end = 0.0, float("-inf")
    for a, b, _ in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


# the launch kinds and kernel-name parts device_share holds the trace to:
# GPT's decode kernels (K5/K6/K7 and K8), and Llama's GEMVs (K3/K4) and K8
BLOCK_AND_HEAD = (("fused_block", "fused_head"), ("fused_block_decode", "head_kernel"))
GEMV_AND_HEAD = (("gemv", "fused_head"), ("_gemv_", "head_kernel"))


def device_share(torch, eng, prompts, new, trace=None, run=None, counted_as=BLOCK_AND_HEAD):
    """Serve ``prompts`` (greedy; or call ``run()``, which serves them its
    own way and returns their results) once more under ``torch.profiler`` and
    split the window's host wall time into device kernel time per kernel
    and idle time. Returns None where the trace holds no device kernel.
    The trace must hold one span per launch of the kernels ``counted_as``
    names (launch kinds, and the parts of their kernels' names; by default
    the block kernels K5/K6/K7 and K8) that the window counted
    (``launches()``, which counts every graph replay's launches): where it
    holds fewer, the profiler dropped kernels (as it may inside replayed
    CUDA graphs), and the window's idle share is reported as not measured.
    ``trace``: see device_spans; ``trace_s`` is the time taken to read the
    spans."""
    from mxnet_tpu_torch.ops.int8_gemv import launches
    from torch.profiler import ProfilerActivity, profile
    before = eng.stats()
    counted0 = launches()
    # device activity only: recording every host op would stretch the
    # host-bound window that is being measured
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if run is None:
            handles = [eng.submit(p, new) for p in prompts]
            results = [h.result(timeout=600) for h in handles]
        else:
            results = run()
        wall = time.perf_counter() - t0
    after = eng.stats()
    counted = {k: n - counted0.get(k, 0) for k, n in launches().items()}
    for i, r in enumerate(results):
        check(r.ok, f"profiled request {i}: {r.status} {r.error}")
    t_trace = time.perf_counter()
    spans = device_spans(prof, trace)
    if not spans:
        return None
    busy = busy_us(spans)
    by_kernel = {}
    for a, b, name in spans:
        key = next((k for k in ("fused_block_decode_paged_dma", "fused_block_decode_paged",
                                "fused_block_decode", "head_kernel",
                                "int8_gemv_mma", "int4_gemv_mma", "int8_gemv", "int4_gemv")
                    if k in name), "other")
        by_kernel[key] = by_kernel.get(key, 0.0) + (b - a) / 1e3
    substeps = after["decode_substeps"] - before["decode_substeps"]
    kinds, names = counted_as
    launched = sum(n for k, n in counted.items() if k.startswith(kinds))
    traced = sum(1 for _, _, name in spans if any(part in name for part in names))
    out = {"wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
           "idle_share": 1.0 - busy / 1e3 / (wall * 1e3),
           "kernel_ms": by_kernel, "device_ops": len(spans),
           "decode_substeps": substeps, "block_and_head_launches": launched,
           "block_and_head_spans": traced,
           "ms_per_decode_step": (after["decode_s"] - before["decode_s"])
           / substeps * 1e3, "trace_s": time.perf_counter() - t_trace}
    if traced < launched:
        out.update(idle_share="not measured: the trace dropped kernels",
                   device_busy_ms="not measured")
    return out


def warm(eng):
    """``eng.warmup()``: every decode step (batch bucket x substeps x
    branch) and every paged prefill chunk of the ladder captured as a CUDA
    graph. Returns what the phase must leave unchanged, with the warm-up's
    seconds."""
    eng.warmup()
    st = eng.stats()
    built = st["compiled_buckets"]["decode"] or st["compiled_buckets"].get("spec")
    check(st["captures"] > 0 and built, f"warmup captured nothing: {st['compiled_buckets']}")
    return {"captures": st["captures"], "compiled_buckets": st["compiled_buckets"],
            "last_warmup_s": st["last_warmup_s"]}


def no_capture_since(eng, warmed, what):
    """Fail if the engine captured anything after its warm-up (the port's
    zero-recompile contract)."""
    st = eng.stats()
    check(st["captures"] == warmed["captures"]
          and st["compiled_buckets"] == warmed["compiled_buckets"],
          f"{what}: captured after warmup ({warmed['captures']} -> {st['captures']} "
          f"captures)")


def replay_equals_eager(torch, eng, gen, seed, sb=None, steps=None, branch=None, pb=None,
                        verify=False):
    """A captured step replayed against its function run eagerly, from the
    same inputs and the same pool (cache) state, both on the card: a
    decode step of bucket ``sb`` (``steps`` substeps, ``branch``), with
    ``pb`` the paged prefill chunk of that bucket, or with ``verify`` the
    speculative verify step of bucket ``sb`` and ``branch``. Inputs and the
    pools are random (rows on distinct pages, as the page ledger leases
    them; half the rows at T 0.8); a grammar engine's tables hold a real
    automaton and its rows random states of it. The replay's output, the
    last tokens (and automaton states) a decode step writes back into its
    inputs and the whole pools must equal the eager run's bit for bit.
    Returns the compared counts."""
    import numpy as np

    from mxnet_tpu_torch import _prng
    from mxnet_tpu_torch.serve.grammar import compile_grammar
    rng = np.random.RandomState(seed)
    K, vocab, paged = eng.K, eng._vocab, eng._paged
    span = pb or (eng.spec if verify else K)
    if pb:
        step, io = eng._get_chunk(pb), eng._chunk_io
    elif verify:
        step, io = eng._get_spec(sb, branch), eng._spec_io[sb]
    else:
        step, io = eng._get_step(sb, steps, branch), eng._io[sb]
    check(step.graph is not None, "replay_equals_eager: the step was not captured")
    if eng._grammar:
        g = compile_grammar(r"[a-z]{1,3}(?: [a-z]{1,3}){0,3}\.", vocab)
        eng._gcls[:], eng._gnxt[:], eng._gacc[:] = g.padded_tables(eng._gmax, eng._gmax)
        eng._gdirty = True
        eng._sync_gtab()
    h = io.host()
    h_rows = 1 if pb else sb
    if paged:
        ps = eng.page_size
        per_row = eng._pages.num_pages // h_rows
        top = per_row * ps - span
        pos = rng.randint(0, max(1, min(top, eng.L - span)), h_rows)
        pages = rng.permutation(eng._pages.num_pages)
        h["table"][:] = eng._pages.sink
        used = 0
        for r in range(h_rows):
            n = (int(pos[r]) + span - 1) // ps + 1
            h["table"][r, :n] = pages[used:used + n]
            used += n
    else:
        pos = rng.randint(0, eng.L - span, h_rows)
    if pb:
        h["ids"][:] = 0
        h["ids"][:pb] = rng.randint(0, vocab, pb)
        h["pos"][0] = pos[0]
    else:
        h["inputs" if verify else "tokens"][:] = rng.randint(0, vocab, (sb, span) if verify
                                                             else sb)
        h["pos"][:] = pos
        h["temps"][:] = np.where(np.arange(sb) % 2, 0.8, 0.0)
        h["topks"][:] = 40 if branch.startswith("filtered") else 0
        h["topps"][:] = 1.0
        if eng._grammar:
            states = rng.randint(0, g.n_states, (sb, span) if verify else sb)
            h["gstates" if verify else "gstate"][:] = states
            h["eos"][:] = 0
        keys = _prng.step_keys(rng.randint(0, 2**32, sb), rng.randint(0, 1000, sb), span)
        if verify:
            h["keys"][:] = keys.transpose(1, 0, 2)
        else:
            h["eos"][:] = 0 if eng._grammar else -1
            h["rem"][:] = K
            h["keys"][:] = keys
    io.upload(0, io.nbytes)
    with torch.no_grad():
        for pool in eng._pools:
            pool.copy_(torch.randn(pool.shape, generator=gen, device=pool.device))
        pools0 = [pool.clone() for pool in eng._pools]
        inputs0 = io.dev.clone()
        out_r = step().clone()
        inputs_r = io.dev.clone()
        pools_r = [pool.clone() for pool in eng._pools]
        for pool, p0 in zip(eng._pools, pools0):
            pool.copy_(p0)
        io.dev.copy_(inputs0)
        out_e = step.fn()
        torch.cuda.synchronize()
        same_out = torch.equal(out_r, out_e)
        # a decode step writes its last tokens (and automaton states) back
        same_last = torch.equal(inputs_r, io.dev)
        same_pools = all(torch.equal(a, b) for a, b in zip(pools_r, eng._pools))
        written = sum(int(not torch.equal(a, b)) for a, b in zip(pools_r, pools0))
    what = (f"chunk bucket {pb}" if pb else f"verify bucket {sb} ({branch})" if verify
            else f"decode bucket {sb} ({steps} substeps, {branch})")
    check(same_out and same_last and same_pools,
          f"{what}: replay != eager (output {same_out}, inputs written back {same_last}, "
          f"pools {same_pools})")
    check(written == len(eng._pools), f"{what}: {written} of {len(eng._pools)} pools written")
    return {"step": what, "pools_written": written, "equal": True,
            "grammar": eng._grammar}


# the engine phases' top-k / top-p requests: (temperature, top_k, top_p)
FILTERED = ((0.9, 40, 1.0), (0.7, 0, 0.9))


def filtered_requests(eng, prompts, vocab, new, seed):
    """Two top-k/top-p requests, submitted together and then once more with
    the same seeds: every decode batch they share takes ``sample_tokens`` on
    the head GEMV's logits. Their tokens must lie in the vocab and repeat."""
    runs = []
    for _ in range(2):
        hs = [eng.submit(prompts[i], new, temperature=t, top_k=k, top_p=p, seed=seed + i)
              for i, (t, k, p) in enumerate(FILTERED)]
        runs.append([h.result(timeout=600) for h in hs])
    for i, (a, b) in enumerate(zip(*runs)):
        check(a.ok and b.ok and len(a.generated_ids) == new,
              f"filtered request {i}: {a.status} {b.status} {a.error} {b.error}")
        check(all(0 <= t < vocab for t in a.generated_ids),
              f"filtered request {i}: token outside vocab")
        check(a.generated_ids == b.generated_ids, f"filtered request {i}: same seed, "
              "another sample")
    return {"requests": [list(r) for r in FILTERED], "new_tokens_each": new,
            "repeat_on_resubmit": True}


def lane(torch, net):
    """(tag, kinds, forbidden) of a quantized model: the tag of its lines
    ("", "int4_", "bf16_", "bf16_int4_"), the launch kinds its GEMV, block
    kernels and head record, and the int8 kinds that an int4 model must
    never record."""
    int4 = net.blocks[0].attn_qkv.w_q.dtype == torch.uint8
    bf16 = "bf16_" if net.cfg.dtype == torch.bfloat16 else ""
    sfx = "_int4" if int4 else ""
    kinds = {"gemv": "gemv" + sfx, "block": "fused_block" + sfx,
             "paged": "fused_block_paged" + sfx, "dma": "fused_block_paged_dma" + sfx,
             "head": "fused_head" + sfx}
    int8_kinds = ("gemv", "fused_block", "fused_block_paged", "fused_block_paged_dma",
                  "fused_head")
    return bf16 + ("int4_" if int4 else ""), kinds, (int8_kinds if int4 else ())


def serve(torch, args, net, cpu_net, cpu_tokens=64):
    """The contiguous serving phase: 12 requests (8 greedy, 4 at T 0.8, 64
    new tokens each) through ``InferenceEngine(max_batch_size=8, max_len=512,
    multi_token=4, paged=False)``, held against ``generate()`` on the card
    and, over the first ``cpu_tokens`` tokens of two requests, against the
    plain path on the CPU. A bf16 model's greedy request 7 is cut to 5
    tokens, so that one prefill takes the warp route with bf16 rows.
    Returns the launch counts of the window, with the requests' tokens and
    the generate() references under "k4" (for serve_k1)."""
    from mxnet_tpu_torch.models import generate
    from mxnet_tpu_torch.ops.int8_gemv import (dtype_lanes, gemv_routes, gemv_widths,
                                               launches, reset_launches)
    from mxnet_tpu_torch.serve import InferenceEngine
    tag, kinds, forbidden = lane(torch, net)
    vocab = net.cfg.vocab_size
    prompts, temps, new = contiguous_requests(torch, args, net)
    eng = InferenceEngine(net, max_batch_size=8, max_len=512, multi_token=4,
                          fused=True, paged=False).start()
    try:
        warmed = warm(eng)
        first = eng.generate(prompts[0][:8], 8, timeout=600)
        check(first.ok, f"warm-up request failed: {first.error}")
        before = eng.stats()
        reset_launches()
        t0 = time.perf_counter()
        handles = [eng.submit(p, new, temperature=t, seed=1000 + i)
                   for i, (p, t) in enumerate(zip(prompts, temps))]
        results = [h.result(timeout=600) for h in handles]
        wall = time.perf_counter() - t0
        counts = launches()
        counts["routes"] = gemv_routes()
        counts["widths"] = gemv_widths()
        counts["lanes"] = dtype_lanes()
        after = eng.stats()
        counts["kv_bytes"] = after["kv_bytes"]
        again = [eng.submit(prompts[i], new, temperature=0.8, seed=1000 + i)
                 for i in range(8, 12)]
        again = [h.result(timeout=600) for h in again]
        filtered = filtered_requests(eng, prompts, vocab, new, 1100)
        profiled = device_share(torch, eng, prompts[:8], new, trace=tag + "decode_trace.json")
        no_capture_since(eng, warmed, tag + "contiguous phase")
    finally:
        eng.shutdown(drain=True, timeout=600)
    replay = (replay_equals_eager(torch, eng, torch.Generator(device="cuda").manual_seed(
        args.seed), args.seed, sb=8, steps=4, branch="fused")
        if net.device.type == "cuda" else None)
    for i, r in enumerate(results):
        check(r.ok and len(r.generated_ids) == new, f"request {i}: {r.status} "
              f"{len(r.generated_ids)} tokens {r.error}")
    substeps = after["decode_substeps"] - before["decode_substeps"]
    prefills = after["prefills"] - before["prefills"]
    check(counts.get(kinds["block"], 0) == LAYERS * substeps,
          f"K5 launches {counts.get(kinds['block'])} != 12 x {substeps} decode steps")
    # one head launch per decode substep; each request's token 0 is drawn
    # from the head GEMV's logits of its last prompt row (K3/K4, warp route)
    check(counts.get(kinds["head"], 0) == substeps,
          f"K8 launches {counts.get(kinds['head'])} != {substeps} substeps")
    check(counts["routes"]["warp"] >= prefills,
          f"{counts['routes']['warp']} warp-route GEMVs < {prefills} prefills' token 0")
    check(counts.get(kinds["gemv"], 0) > 0, "the head/prefill GEMV never launched")
    check(not any(counts.get(k) for k in forbidden), f"an int8 kind launched: {counts}")
    for i in range(8, 12):
        toks = results[i].generated_ids
        check(all(0 <= t < vocab for t in toks), f"request {i}: token outside vocab")
        check(again[i - 8].generated_ids == toks,
              f"request {i}: same seed gave another sample")
    gen_match, gen_refs = [], {}
    for i in range(8):
        p = torch.tensor([prompts[i]], dtype=torch.int32)
        for mt in (4, 1):
            ref = generate(net, p, new, multi_token=mt)[0, len(prompts[i]):].tolist()
            check(ref == results[i].generated_ids,
                  f"request {i}: engine tokens != generate(multi_token={mt}) on the card "
                  f"(first divergence {first_divergence(ref, results[i].generated_ids)})")
            gen_refs[f"{i}:{mt}"] = ref
        gen_match.append(i)
    cpu_rows = []
    t_cpu = time.perf_counter()
    for i in range(2):
        p = torch.tensor([prompts[i]], dtype=torch.int32)
        ref = generate(cpu_net, p, cpu_tokens)[0, len(prompts[i]):].tolist()
        got = results[i].generated_ids[:cpu_tokens]
        d = first_divergence(ref, got)
        row = {"request": i, "equal": d is None, "first_divergence": d}
        if d is not None:
            row["top2_gap"], top = top2_gap(torch, cpu_net, prompts[i] + ref[:d])
            row["gap_limit"] = gap_limit(torch, cpu_net, top)
            check(row["top2_gap"] < row["gap_limit"],
                  f"request {i}: card and CPU diverge at {d} with top-2 gap "
                  f"{row['top2_gap']}")
        cpu_rows.append(row)
    emit({tag + "cpu_compare": cpu_rows, "cpu_tokens": cpu_tokens,
          "cpu_s": time.perf_counter() - t_cpu})
    tokens = sum(len(r.generated_ids) for r in results)
    dsteps = after["decode_substeps"] - before["decode_substeps"]
    dsec = after["decode_s"] - before["decode_s"]
    emit({tag + "engine": {"requests": len(results), "greedy": 8, "sampled": 4,
                     "filtered_requests": filtered,
                     "new_tokens_each": new, "wall_s": wall,
                     "tokens_per_s": tokens / wall,
                     "decode_substeps": dsteps,
                     "decode_dispatches": after["decode_dispatches"]
                     - before["decode_dispatches"],
                     "ms_per_decode_step": dsec / dsteps * 1e3,
                     "prefills": after["prefills"] - before["prefills"],
                     "prefill_s": after["prefill_s"] - before["prefill_s"],
                     "kv_bytes": after["kv_bytes"], "launches": counts,
                     "warmup": warmed, "replay_equals_eager": replay,
                     "greedy_equal_generate_mt4_and_mt1": gen_match}})
    # the 8 greedy requests again, traced: device time against host wall
    emit({tag + "profiled_window": profiled if profiled is not None else "not measured"})
    # for the multi_token=1 phase (serve_k1): this engine's tokens, the
    # generate() references and the window's numbers
    counts["k4"] = {"tokens": [r.generated_ids for r in results], "generate": gen_refs,
                    "ms_per_decode_step": dsec / dsteps * 1e3, "tokens_per_s": tokens / wall,
                    "profiled": profiled}
    return counts


def contiguous_requests(torch, args, net):
    """The contiguous phases' 12 requests: (prompts of 8-48 tokens from
    ``--seed``, temperatures: 8 greedy then 4 at T 0.8, new tokens each). A
    bf16 model's greedy request 7 is cut to 5 tokens, so that one prefill
    takes the warp route with bf16 rows."""
    import numpy as np
    rng = np.random.RandomState(args.seed)
    vocab = net.cfg.vocab_size
    prompts = [rng.randint(0, vocab, int(n)).tolist()
               for n in rng.randint(8, 49, 12)]
    if net.cfg.dtype == torch.bfloat16:
        prompts[7] = prompts[7][:5]
    return prompts, [0.0] * 8 + [0.8] * 4, 64


def serve_k1(torch, args, net, k4):
    """The contiguous phase's 12 requests through a ``multi_token=1``
    engine (the engine's default; ``InferenceEngine(max_batch_size=8,
    max_len=512, multi_token=1, paged=False)``): every decode substep
    computes the tied head's logits at B <= 8 rows on the warp route of K3
    (or K4) and selects with ``sample_tokens``, as JAX's K=1 step does, and
    so does every request's token 0. Greedy tokens must equal the
    multi_token=4 engine's (K8) and ``generate()``'s on the card (``k4``:
    serve()'s record of the same requests); sampled ones lie in the vocab
    and repeat per seed; the warp route launches at least once per substep
    and prefill, K8 never. The 8 greedy requests are then traced. Returns
    the launch counts of the window."""
    from mxnet_tpu_torch.ops.int8_gemv import (dtype_lanes, gemv_routes, gemv_widths,
                                               launches, reset_launches)
    from mxnet_tpu_torch.serve import InferenceEngine
    tag, kinds, forbidden = lane(torch, net)
    vocab = net.cfg.vocab_size
    prompts, temps, new = contiguous_requests(torch, args, net)
    eng = InferenceEngine(net, max_batch_size=8, max_len=512, multi_token=1,
                          fused=True, paged=False).start()
    try:
        warmed = warm(eng)
        first = eng.generate(prompts[0][:8], 8, timeout=600)
        check(first.ok, f"K=1 warm-up request failed: {first.error}")
        before = eng.stats()
        reset_launches()
        t0 = time.perf_counter()
        handles = [eng.submit(p, new, temperature=t, seed=1000 + i)
                   for i, (p, t) in enumerate(zip(prompts, temps))]
        results = [h.result(timeout=600) for h in handles]
        wall = time.perf_counter() - t0
        counts = launches()
        counts["routes"] = gemv_routes()
        counts["widths"] = gemv_widths()
        counts["lanes"] = dtype_lanes()
        after = eng.stats()
        again = [eng.submit(prompts[i], new, temperature=0.8, seed=1000 + i)
                 for i in range(8, 12)]
        again = [h.result(timeout=600) for h in again]
        profiled = device_share(torch, eng, prompts[:8], new)
        no_capture_since(eng, warmed, tag + "K=1 phase")
    finally:
        eng.shutdown(drain=True, timeout=600)
    for i, r in enumerate(results):
        check(r.ok and len(r.generated_ids) == new, f"K=1 request {i}: {r.status} "
              f"{len(r.generated_ids)} tokens {r.error}")
    substeps = after["decode_substeps"] - before["decode_substeps"]
    prefills = after["prefills"] - before["prefills"]
    check(counts.get(kinds["block"], 0) == LAYERS * substeps,
          f"K=1: K5 launches {counts.get(kinds['block'])} != 12 x {substeps} substeps")
    check(counts.get(kinds["head"], 0) == 0, f"K=1: the fused head launched: {counts}")
    check(counts["routes"]["warp"] >= substeps + prefills,
          f"K=1: {counts['routes']['warp']} warp-route GEMVs < {substeps} substeps + "
          f"{prefills} prefills")
    head = counts["widths"].get("warp:50304", 0)
    check(head >= substeps + prefills, f"K=1: {head} tied-head GEMVs on the warp route < "
          f"{substeps} substeps + {prefills} prefills")
    check(not any(counts.get(k) for k in forbidden), f"K=1: an int8 kind launched: {counts}")
    for i in range(8):
        got = results[i].generated_ids
        for what, ref in (("the multi_token=4 engine's", k4["tokens"][i]),
                          ("generate(multi_token=1)'s", k4["generate"][f"{i}:1"]),
                          ("generate(multi_token=4)'s", k4["generate"][f"{i}:4"])):
            check(got == ref, f"K=1 request {i}: greedy tokens != {what} (first divergence "
                  f"{first_divergence(got, ref)})")
    for i in range(8, 12):
        toks = results[i].generated_ids
        check(all(0 <= t < vocab for t in toks), f"K=1 request {i}: token outside vocab")
        check(again[i - 8].generated_ids == toks, f"K=1 request {i}: same seed gave "
              "another sample")
    tokens = sum(len(r.generated_ids) for r in results)
    dsec = after["decode_s"] - before["decode_s"]
    k4p = k4["profiled"] or {}
    emit({tag + "engine_k1": {
        "requests": len(results), "greedy": 8, "sampled": 4, "new_tokens_each": new,
        "wall_s": wall, "tokens_per_s": tokens / wall, "decode_substeps": substeps,
        "prefills": prefills, "ms_per_decode_step": dsec / substeps * 1e3,
        "head_gemvs_warp": head, "launches": counts, "warmup": warmed,
        "greedy_equal_k4_engine_and_generate": list(range(8)),
        "k4_window": {"ms_per_decode_step": k4["ms_per_decode_step"],
                      "tokens_per_s": k4["tokens_per_s"],
                      "idle_share": k4p.get("idle_share"),
                      "kernel_ms": k4p.get("kernel_ms")}}})
    emit({tag + "profiled_window_k1": profiled if profiled is not None else "not measured"})
    return counts


def prefill_chunks(torch, net, ids, chunk, caches):
    """Prefill ``ids`` into contiguous ``caches`` in ``chunk``-token chunks
    as the paged engine does (the final chunk zero-padded to the engine's
    prompt bucket); returns (hidden of the final chunk, row of the last
    token)."""
    import numpy as np

    from mxnet_tpu_torch.models import generation as gen
    from mxnet_tpu_torch.serve.bucketing import bucket_for
    cursor, P = 0, len(ids)
    while True:
        end = min(cursor + chunk, P)
        n = end - cursor
        pb = n if end < P else bucket_for(n, 8, chunk)
        x = np.zeros((1, pb), np.int32)
        x[0, :n] = ids[cursor:end]
        hidden, caches = gen.decode_step_hidden(net, torch.from_numpy(x).to(net.device),
                                                cursor, caches)
        if end == P:
            return hidden, n - 1
        cursor = end


def chunked_reference(torch, net, prompt, new, chunk, max_len, K=4):
    """Greedy tokens of the paged engine's arithmetic on the contiguous
    layout: ``prompt`` prefilled in ``chunk``-token chunks (K3), token 0
    from the fused head (K8), then K-token decode dispatches (K5, which
    gives a row K6's and K7's bits)."""
    from mxnet_tpu_torch.models import generation as gen
    from mxnet_tpu_torch.ops.fused_block_gemv import fused_lm_head_sample
    dev = net.device
    caches = net.new_caches(1, max_len)
    head = net.head_weights()
    with torch.no_grad():
        hidden, last = prefill_chunks(torch, net, prompt, chunk, caches)
        tok = fused_lm_head_sample(hidden[:, last], *head,
                                   torch.zeros(1, dtype=torch.int64, device=dev),
                                   torch.zeros(1, device=dev))
        out = [int(tok[0])]
        while len(out) < new:
            toks, tok, steps, _, caches = gen.decode_multi_tokens(
                net, tok, len(prompt) + len(out) - 1, caches, K, [0.0], [0], [len(out)],
                remaining=[new - len(out)], head=head)
            out += toks[0, :steps].tolist()
    return out[:new]


def chunked_gap(torch, net, tokens, chunk, max_len):
    """Top-1 minus top-2 logit after ``tokens``, prefilled in chunks as the
    paged engine prefills them (K3 head at the last row)."""
    with torch.no_grad():
        hidden, last = prefill_chunks(torch, net, tokens, chunk, net.new_caches(1, max_len))
        top = torch.topk(net._lm_head(hidden)[0, last].float(), 2).values
    return (top[0] - top[1]).item()


def greedy_rows(torch, net, prompts, results, new, chunk, max_len):
    """Each greedy request against the engine's arithmetic on the
    contiguous layout (``chunked_reference``) and against
    ``generate(multi_token=4)``: equal, or a first divergence at a top-2
    gap below 1e-3. ``generate()`` prefills a prompt in one forward, which
    past ``gemv_max_m()`` (64) rows takes the activation-quantized int8
    product instead of K3, so it is held to that rule only for prompts of
    at most 64 tokens and reported for the others."""
    from mxnet_tpu_torch.models import generate
    from mxnet_tpu_torch.ops.int8_gemv import gemv_max_m
    rows = []
    for i, (prompt, got) in enumerate(zip(prompts, results)):
        row = {"request": i, "prompt": len(prompt)}
        for name, ref in (
                ("chunked_reference", chunked_reference(torch, net, prompt, new, chunk,
                                                        max_len)),
                ("generate_mt4", generate(net, torch.tensor([prompt], dtype=torch.int32),
                                          new, multi_token=4)[0, len(prompt):].tolist())):
            d = first_divergence(ref, got)
            row[name] = {"equal": d is None, "first_divergence": d}
            held = name == "chunked_reference" or len(prompt) <= gemv_max_m()
            if d is not None:
                gap = chunked_gap(torch, net, prompt + ref[:d], chunk, max_len)
                row[name]["top2_gap"] = gap
                check(not held or gap < 1e-3,
                      f"request {i}: engine tokens != {name} at {d}, top-2 gap {gap}")
            row[name]["held"] = held
        rows.append(row)
    return rows


def serve_paged(torch, args, net, phase):
    """A paged serving phase of quantized GPT-2 small through
    ``InferenceEngine(paged=True, fused=True, multi_token=4)``.

    A (K6): 16 slots, max_len 256, a 128-page pool (the contiguous bytes of
    8 slots); 16 requests sharing a 40-token system prompt plus 8-40 own
    tokens, 64 new tokens each, 12 greedy and 4 at T 0.8; the first served
    alone publishes the prefix, the other 15 are submitted together.
    B (K7): 8 slots, max_len 1024, no prefix cache; 8 greedy requests of
    300-700-token prompts prefilled in 16-token chunks, 128 new tokens
    each, submitted together, on a pool of PAGED_B_PAGES, about half of
    what they need together, so requests are preempted and resumed.
    C (K7, no preemption): 4 slots, max_len 1024, no prefix cache; 4 greedy
    requests of 300-700-token prompts, 32 new tokens each, submitted
    together, on the default pool (the contiguous bytes of the 4 slots).
    Returns the launch counts of the concurrent window."""
    import numpy as np

    from mxnet_tpu_torch.ops.int8_gemv import (dma_ledger, dtype_lanes, gemv_routes,
                                               gemv_widths, launches, reset_launches)
    from mxnet_tpu_torch.serve import InferenceEngine
    from mxnet_tpu_torch.serve.paging import pages_for
    tag, kinds, forbidden = lane(torch, net)
    rng = np.random.RandomState(args.seed + {"A": 1, "B": 2, "C": 3}[phase])
    vocab = net.cfg.vocab_size
    if phase == "A":
        system = rng.randint(0, vocab, 40).tolist()
        prompts = [system + rng.randint(0, vocab, int(n)).tolist()
                   for n in rng.randint(8, 41, 16)]
        temps = [0.0] * 12 + [0.8] * 4
        new, kernel, other = 64, kinds["paged"], kinds["dma"]
        kw = dict(max_batch_size=16, max_len=256, num_pages=128)
    else:
        n_req = 8 if phase == "B" else 4
        prompts = [rng.randint(0, vocab, int(n)).tolist()
                   for n in rng.randint(300, 701, n_req)]
        temps = [0.0] * n_req
        new, kernel, other = (128 if phase == "B" else 32), kinds["dma"], kinds["paged"]
        kw = (dict(max_batch_size=8, max_len=1024, num_pages=PAGED_B_PAGES, prefix_cache=False)
              if phase == "B" else dict(max_batch_size=4, max_len=1024, prefix_cache=False))
    eng = InferenceEngine(net, multi_token=4, fused=True, paged=True, page_size=16,
                          **kw).start()
    try:
        warmed = warm(eng)
        first = []
        if phase == "A":
            r0 = eng.generate(prompts[0], new, timeout=600)
            check(r0.ok, f"phase A request 0: {r0.status} {r0.error}")
            first = [r0]
        before = eng.stats()
        reset_launches()
        t0 = time.perf_counter()
        handles = [eng.submit(p, new, temperature=t, seed=2000 + i)
                   for i, (p, t) in enumerate(zip(prompts, temps)) if i >= len(first)]
        results = first + [h.result(timeout=900) for h in handles]
        wall = time.perf_counter() - t0
        counts, ledger = launches(), dma_ledger()
        counts["routes"] = gemv_routes()
        counts["widths"] = gemv_widths()
        counts["lanes"] = dtype_lanes()
        after = eng.stats()
        counts["kv_bytes"] = after["kv_bytes"]
        sampled = [i for i, t in enumerate(temps) if t > 0]
        again = [eng.submit(prompts[i], new, temperature=0.8, seed=2000 + i) for i in sampled]
        again = [h.result(timeout=600) for h in again]
        filtered = (filtered_requests(eng, prompts, vocab, min(new, 64), 2100)
                    if phase == "A" else None)
        greedy = [i for i, t in enumerate(temps) if t == 0]
        profiled = (device_share(torch, eng, [prompts[i] for i in greedy], new)
                    if net.device.type == "cuda" else None)
        no_capture_since(eng, warmed, f"{tag}paged phase {phase}")
    finally:
        eng.shutdown(drain=True, timeout=900)
    replay = None
    if net.device.type == "cuda":
        g = torch.Generator(device="cuda").manual_seed(args.seed)
        replay = [replay_equals_eager(torch, eng, g, args.seed, sb=kw["max_batch_size"],
                                      steps=4, branch="fused")]
        replay += [replay_equals_eager(torch, eng, g, args.seed + pb, pb=pb) for pb in (16, 8)]
    for i, r in enumerate(results):
        check(r.ok and len(r.generated_ids) == new,
              f"phase {phase} request {i}: {r.status} {len(r.generated_ids)} tokens {r.error}")
    substeps = after["decode_substeps"] - before["decode_substeps"]
    check(counts.get(kernel, 0) == LAYERS * substeps,
          f"phase {phase}: {kernel} launches {counts.get(kernel)} != 12 x {substeps}")
    check(not counts.get(other) and not counts.get(kinds["block"]),
          f"phase {phase}: other block kernels launched: {counts}")
    check(not any(counts.get(k) for k in forbidden), f"phase {phase}: an int8 kind launched: "
          f"{counts}")
    check(ledger["copies"] == ledger["waits"], f"phase {phase}: DMA ledger {ledger}")
    pages = after["pages"]
    if phase == "A":
        check(after["max_active"] > 8, f"phase A: max_active {after['max_active']} <= 8")
        check(pages["prefix_hits"] >= 15 and pages["cow_forks"] > 0,
              f"phase A: prefix hits {pages['prefix_hits']}, forks {pages['cow_forks']}")
    elif phase == "B":
        check(after["preemptions"] > 0, "phase B: no preemption")
    else:
        check(after["preemptions"] == 0, f"phase C: {after['preemptions']} preemptions")
    for i, r in zip(sampled, again):
        toks = results[i].generated_ids
        check(all(0 <= t < vocab for t in toks), f"phase {phase} request {i}: token outside vocab")
        check(r.generated_ids == toks, f"phase {phase} request {i}: same seed, another sample")
    eng._pages.clear_prefix_cache()
    eng._pages.check_consistent()
    check(eng._pages.pages_in_use() == 0,
          f"phase {phase}: {eng._pages.pages_in_use()} pages held after the drain")
    t_ref = time.perf_counter()
    rows = greedy_rows(torch, net, [prompts[i] for i in greedy],
                       [results[i].generated_ids for i in greedy], new, 16, kw["max_len"])
    tokens = sum(len(r.generated_ids) for r in results[len(first):])
    dsec = after["decode_s"] - before["decode_s"]
    emit({f"{tag}paged_{phase}": {
        "kernel": kernel, "requests": len(prompts), "new_tokens_each": new,
        "prompt_tokens": [len(p) for p in prompts], **kw,
        "pages_needed": sum(pages_for(len(p) + new + 3, 16) for p in prompts),
        "concurrent_requests": len(handles), "wall_s": wall, "tokens_per_s": tokens / wall,
        "decode_substeps": substeps,
        "decode_dispatches": after["decode_dispatches"] - before["decode_dispatches"],
        "ms_per_decode_step": dsec / substeps * 1e3,
        "prefills": after["prefills"] - before["prefills"],
        "prefill_chunks": after["prefill_chunks"] - before["prefill_chunks"],
        "prefill_s": after["prefill_s"] - before["prefill_s"],
        "max_active": after["max_active"], "preemptions": after["preemptions"],
        "resumed_tokens": after["resumed_tokens"],
        "pages": pages, "kv_bytes": after["kv_bytes"], "launches": counts,
        "dma_ledger": ledger, "greedy": rows, "reference_s": time.perf_counter() - t_ref,
        "warmup": warmed, "replay_equals_eager": replay,
        "filtered_requests": filtered,
        "greedy_identical_chunked_reference": all(r["chunked_reference"]["equal"]
                                                  for r in rows),
        "greedy_identical_generate_mt4": all(r["generate_mt4"]["equal"] for r in rows),
        "profiled_window": profiled if profiled is not None else "not measured"}})
    return counts


def structured_prompts(n, vocab, seed=0, boiler_run=16, n_keys=3, max_tokens=None):
    """Templated JSON-like prompts: runs of one boilerplate token around a
    few key tokens with per-request values, the repetitive traffic that
    self-speculation drafts well (a copy of ``tools/serve_loadgen.py``'s
    ``structured_prompts``, the traffic of ``bench.py``'s speculation and
    grammar duels)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    boiler = int(rng.randint(1, vocab - 1))
    keys = rng.randint(1, vocab - 1, size=n_keys)
    prompts = []
    for _ in range(n):
        body = []
        for k in keys:
            body.extend([boiler] * boiler_run)
            body.append(int(k))
            body.append(int(rng.randint(1, vocab - 1)))
        if max_tokens is not None:
            body = body[:max_tokens]
        prompts.append(body)
    return prompts


# bench.py's conformance schema (bench_grammar_decode): bounded productions
CS_SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"}, "mode": {"enum": ["fast", "safe", "off"]},
    "n": {"enum": [0, 1, 2]}}}
CS_EOS = 0
CS_TRIALS = 3                  # timed trials per sweep, after one warm discard
CS_SPEC = 4


def cs_sweep(torch, eng, run, name):
    """One sweep of the constrained_spec phase: a warm discard of ``run()``
    (the engine already warmed up), then CS_TRIALS timed trials with the
    launch counts set to 0 just before them and read just after. Each trial
    must give the discard's tokens. Returns (results of the last trial, the
    sweep's record)."""
    from mxnet_tpu_torch.ops.int8_gemv import gemv_routes, launches, reset_launches
    ref = run()
    for i, r in enumerate(ref):
        check(r.ok, f"constrained_spec {name}: request {i}: {r.status} {r.error}")
    before = eng.stats()
    reset_launches()
    rates = []
    for _ in range(CS_TRIALS):
        t0 = time.perf_counter()
        res = run()
        wall = time.perf_counter() - t0
        check([r.generated_ids for r in res] == [r.generated_ids for r in ref],
              f"constrained_spec {name}: a trial gave other tokens than the warm discard")
        rates.append(sum(len(r.generated_ids) for r in res) / wall)
    counts = launches()
    counts["routes"] = gemv_routes()
    after = eng.stats()
    check(all(counts["routes"].get(r, 0) > 0 for r in ("warp", "mma")),
          f"constrained_spec {name}: K3 routes {counts['routes']}")
    rec = {"tokens_per_s": {"median": statistics.median(rates), "min": min(rates),
                            "max": max(rates)},
           "decode_dispatches": after["decode_dispatches"] - before["decode_dispatches"],
           "decode_tokens": after["decode_tokens"] - before["decode_tokens"],
           "launches": counts}
    if "spec" in after:
        rec["spec"] = after["spec"]
        rec["rounds"] = after["spec"]["rounds"] - before["spec"]["rounds"]
    return res, rec


def constrained_spec(torch, args, net, cpu_net):
    """Grammar-constrained and self-speculative serving of int8 GPT-2 small,
    ``bench.py``'s grammar and speculation duels on GPT-2's vocab: 8
    structured prompts, one request in flight at a time, greedy, seed 0,
    EOS 0, through ``InferenceEngine(max_batch_size=2, max_len=128,
    paged=True, page_size=16, speculate=4)``; each sweep after ``warmup()``,
    a warm discard and CS_TRIALS timed trials (``cs_sweep``).

    (a) free against pass-through: a speculative engine without grammar and
        one with ``grammar=True`` serving ``grammar=".*"``, 64 new tokens:
        the same tokens, and the constrained acceptance no lower. One sweep
        of the constrained engine is profiled (idle share).
    (b) conformance: ``CS_SCHEMA`` on a grammar engine, seed i per prompt:
        every completion ends ok and replays through the automaton.
    (c) speculation against none: ``speculate=4`` against ``speculate=0``
        (K6), 80 new tokens on prompts cut to 40 tokens (``bench.py``'s
        speculation duel: 128 - 80 - 8): greedy tokens equal, or at the
        first divergence the CPU twin's top-2 gap below ``gap_limit``; then
        2 sampled requests (T 0.8, top-k 40) on each, equality reported.
    (d) contiguous grammar at K=1: ``InferenceEngine(max_batch_size=8,
        max_len=512, paged=False, grammar=True)`` (K5) with 8 requests at
        once, 4 under the schema: the 4 free rows equal a plain K=1
        contiguous engine's tokens, the 4 constrained ones replay.

    In every sweep nothing is captured after ``warmup()`` and K3 launches on
    both routes. Returns the launch counts of the sweeps by name."""
    from mxnet_tpu_torch.serve import InferenceEngine, compile_grammar
    from mxnet_tpu_torch.serve.grammar import clear_grammar_cache
    tag, kinds, _ = lane(torch, net)
    vocab = net.cfg.vocab_size
    t_phase = time.perf_counter()
    clear_grammar_cache()
    compile_s = {}
    for name, src in (("dotstar", ".*"), ("schema", CS_SCHEMA)):
        t0 = time.perf_counter()
        g = compile_grammar(src, vocab, cache=False)
        compile_s[name] = {"s": time.perf_counter() - t0, "states": g.n_states,
                           "classes": g.n_classes}
    schema = compile_grammar(CS_SCHEMA, vocab)
    prompts = structured_prompts(8, vocab, seed=0, max_tokens=56)
    short = structured_prompts(8, vocab, seed=0, max_tokens=128 - 80 - 8)
    paged_kw = dict(max_batch_size=2, max_len=128, paged=True, page_size=16, fused=True)
    out, counts = {"compile": compile_s}, {}

    def one_at_a_time(eng, ps, new, **kw):
        def run():
            return [eng.generate(p, new, timeout=600, **{k: (v(i) if callable(v) else v)
                                                        for k, v in kw.items()})
                    for i, p in enumerate(ps)]
        return run

    def engine(**kw):
        eng = InferenceEngine(net, **kw).start()
        return eng, warm(eng)

    cuda = net.device.type == "cuda"
    gen = torch.Generator(device=net.device).manual_seed(args.seed)

    # (a) free against pass-through
    sweeps = {}
    for name, gram in (("free", None), ("dotstar", ".*")):
        eng, warmed = engine(speculate=CS_SPEC, grammar=gram is not None, **paged_kw)
        try:
            extra = {"grammar": gram} if gram else {}
            run = one_at_a_time(eng, prompts, 64, seed=0, eos_token_id=CS_EOS, **extra)
            res, rec = cs_sweep(torch, eng, run, f"(a) {name}")
            if gram and cuda:
                rec["profiled_window"] = device_share(torch, eng, prompts, 64, run=run)
            no_capture_since(eng, warmed, f"constrained_spec (a) {name}")
        finally:
            eng.shutdown(drain=True, timeout=600)
        rec["warmup"] = warmed
        sweeps[name] = (res, rec)
        counts["a_" + name] = rec["launches"]
    free, cons = sweeps["free"], sweeps["dotstar"]
    check([r.generated_ids for r in free[0]] == [r.generated_ids for r in cons[0]],
          "constrained_spec (a): the pass-through grammar changed the tokens")
    acc_free = free[1]["spec"]["acceptance_rate"] or 0.0
    acc_cons = cons[1]["spec"]["acceptance_rate"] or 0.0
    check(acc_cons + 1e-9 >= acc_free, f"constrained_spec (a): acceptance {acc_cons} < the "
          f"free engine's {acc_free}")
    out["a"] = {"free": free[1], "dotstar": cons[1], "identical": True,
                "cost_pct": (1 - cons[1]["tokens_per_s"]["median"]
                             / free[1]["tokens_per_s"]["median"]) * 100}

    # (b) conformance under the schema
    eng, warmed = engine(speculate=CS_SPEC, grammar=True, **paged_kw)
    try:
        run = one_at_a_time(eng, prompts, 64, seed=lambda i: i, eos_token_id=CS_EOS,
                            grammar=schema)
        res, rec = cs_sweep(torch, eng, run, "(b)")
        no_capture_since(eng, warmed, "constrained_spec (b)")
    finally:
        eng.shutdown(drain=True, timeout=600)
    if cuda:        # a grammar engine's verify step: replay against eager
        rec["replay_equals_eager"] = [
            replay_equals_eager(torch, eng, gen, args.seed + i, sb=2, branch=branch,
                                verify=True)
            for i, branch in enumerate(("greedy", "sampled"))]
    bad = [i for i, r in enumerate(res)
           if not (r.ok and schema.matches(r.generated_ids, eos_token_id=CS_EOS))]
    check(not bad, f"constrained_spec (b): completions {bad} do not replay through the schema")
    rec.update(warmup=warmed, conformant=len(res),
               completion_0="".join(chr(t) for t in res[0].generated_ids[:-1]))
    out["b"] = rec
    counts["b"] = rec["launches"]

    # (c) speculation against none
    runs = {}
    for name, spec in (("spec", CS_SPEC), ("base", 0)):
        eng, warmed = engine(speculate=spec, **paged_kw)
        try:
            res, rec = cs_sweep(torch, eng, one_at_a_time(eng, short, 80, seed=0),
                                f"(c) {name}")
            sampled = [eng.generate(short[i], 80, temperature=0.8, top_k=40, seed=3000 + i,
                                    timeout=600) for i in range(2)]
            no_capture_since(eng, warmed, f"constrained_spec (c) {name}")
        finally:
            eng.shutdown(drain=True, timeout=600)
        check(all(r.ok for r in sampled), f"constrained_spec (c) {name}: sampled requests")
        rec["warmup"] = warmed
        runs[name] = (res, rec, sampled)
        counts["c_" + name] = rec["launches"]
    check(runs["base"][1]["launches"].get(kinds["paged"], 0) > 0,
          f"constrained_spec (c): K6 never launched in the baseline "
          f"{runs['base'][1]['launches']}")
    rows = []
    for i, (a, b) in enumerate(zip(runs["spec"][0], runs["base"][0])):
        d = first_divergence(a.generated_ids, b.generated_ids)
        row = {"request": i, "equal": d is None and len(a.generated_ids) == len(b.generated_ids),
               "first_divergence": d}
        if d is not None:
            row["top2_gap"], top = top2_gap(torch, cpu_net,
                                            short[i] + b.generated_ids[:d])
            row["gap_limit"] = gap_limit(torch, cpu_net, top)
            check(row["top2_gap"] < row["gap_limit"],
                  f"constrained_spec (c): request {i}: speculative and non-speculative "
                  f"greedy tokens diverge at {d} with top-2 gap {row['top2_gap']}")
        rows.append(row)
    out["c"] = {"spec": runs["spec"][1], "base": runs["base"][1], "greedy": rows,
                "identical": sum(r["equal"] for r in rows),
                "speedup": runs["spec"][1]["tokens_per_s"]["median"]
                / runs["base"][1]["tokens_per_s"]["median"],
                "sampled_equal": [a.generated_ids == b.generated_ids
                                  for a, b in zip(runs["spec"][2], runs["base"][2])]}

    # (d) contiguous grammar at K=1 against the plain K=1 engine
    toks = {}
    for name, gram in (("grammar", True), ("plain", False)):
        eng, warmed = engine(max_batch_size=8, max_len=512, paged=False, fused=True,
                             grammar=gram)

        def run(eng=eng, gram=gram):
            hs = [eng.submit(p, 64, seed=i, eos_token_id=CS_EOS,
                             **({"grammar": schema} if gram and i % 2 == 0 else {}))
                  for i, p in enumerate(prompts)]
            return [h.result(timeout=600) for h in hs]

        try:
            res, rec = cs_sweep(torch, eng, run, f"(d) {name}")
            no_capture_since(eng, warmed, f"constrained_spec (d) {name}")
        finally:
            eng.shutdown(drain=True, timeout=600)
        check(rec["launches"].get(kinds["block"], 0) > 0,
              f"constrained_spec (d) {name}: K5 never launched {rec['launches']}")
        rec["warmup"] = warmed
        if cuda and gram:   # a grammar T = 1 step: replay against eager
            rec["replay_equals_eager"] = [
                replay_equals_eager(torch, eng, gen, args.seed + 7, sb=8, steps=1,
                                    branch=branch) for branch in ("greedy", "sampled")]
        toks[name] = res
        out["d_" + name] = rec
        counts["d_" + name] = rec["launches"]
    for i in range(1, 8, 2):
        check(toks["grammar"][i].generated_ids == toks["plain"][i].generated_ids,
              f"constrained_spec (d): free request {i} on the grammar engine != the plain "
              f"engine's (first divergence "
              f"{first_divergence(toks['grammar'][i].generated_ids, toks['plain'][i].generated_ids)})")
    for i in range(0, 8, 2):
        check(schema.matches(toks["grammar"][i].generated_ids, eos_token_id=CS_EOS),
              f"constrained_spec (d): constrained request {i} does not replay")
    out["d"] = {"free_rows_equal_plain": 4, "constrained_rows_conformant": 4}
    out["phase_s"] = time.perf_counter() - t_phase
    emit({tag + "constrained_spec": out})
    return counts


HTTP_TRIALS = 3                # timed trials of (a), HTTP and in-process each
HTTP_NEW = 48                  # new tokens of each (a) request
# (a)'s 10 requests are served this many times a trial (and the profiled
# window's 8 greedy ones likewise), so that a window lasts over a second
HTTP_ROUNDS = 12
SCORE_TOL = 1e-3               # card score against the CPU twin's


class _Reply:
    """A /generate JSON document as a result ``device_share`` reads."""

    def __init__(self, doc):
        self.doc = doc
        self.status, self.error = doc["status"], doc.get("error")
        self.ok = self.status == "ok"
        self.generated_ids = doc["generated_ids"]


def http_json(url, path, doc=None, timeout=600):
    """(status, JSON body) of a GET (``doc`` None) or POST; an HTTP error
    status is an answer, not an exception."""
    import urllib.error
    import urllib.request
    data = None if doc is None else json.dumps(doc).encode()
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def http_sse(url, payload, timeout=600):
    """The token ids and the done document of one SSE /generate."""
    import urllib.request
    req = urllib.request.Request(url + "/generate", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    toks, done, kind = [], None, None
    with urllib.request.urlopen(req, timeout=timeout) as r:
        for line in r:
            line = line.rstrip(b"\n")
            if line.startswith(b"event: "):
                kind = line[7:].decode()
            elif line.startswith(b"data: ") and kind == "token":
                toks.append(json.loads(line[6:])["token"])
            elif line.startswith(b"data: ") and kind == "done":
                done = json.loads(line[6:])
                break
    return toks, done


def http_post_all(url, payloads, pool):
    """POST every payload to /generate from the client threads of ``pool``
    (a ThreadPoolExecutor); returns the (status, document) pairs in payload
    order."""
    return list(pool.map(lambda p: http_json(url, "/generate", p), payloads))


def metric_values(text, names):
    """{sample name with labels: value} of Prometheus text for the sample
    names (exposition names, labels included) starting with ``names``."""
    out = {}
    for ln in text.splitlines():
        if ln.startswith(names):
            key, val = ln.rsplit(" ", 1)
            out[key] = float(val)
    return out


def median_span(xs):
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def http_serve(torch, args, net, cpu_net):
    """Phase http_serve: the HTTP frontend over int8 GPT-2 small (f32,
    fused decode, the main model) on 127.0.0.1, port 0.

    (a) A paged engine (``max_batch_size=8, max_len=256, multi_token=4``:
    K6 and K8) after ``warmup()`` and ``warmup_score()``: 8 greedy prompts
    of 8-48 tokens and 2 at T 0.8 posted from 8 client threads (a pool
    made outside the timers), HTTP_ROUNDS times a trial, their tokens
    equal to the same engine's in-process ``generate()`` from the same
    threads in every round, their SSE streams equal to the JSON replies,
    nothing captured after the warm-up; requests/s and tokens/s through
    HTTP against in-process over HTTP_TRIALS trials each, and the idle
    share of a profiled HTTP window of the 8 greedy prompts HTTP_ROUNDS
    times. (b) ``/score`` of 4
    sequences of 5-64 tokens: bit for bit the same scores run eagerly on
    the card, within SCORE_TOL of the CPU twin, ``logprob`` their sum, K3
    launched on both routes by these scores alone, and the same bits when
    posted while (a)'s requests decode; ms per score bucket. (c)
    ``/metrics`` after (a): requests and generated tokens against the
    replies the smoke received, and the launch sites of the built steps;
    ``/healthz`` 200 with models ``{"default": 0}``.
    (d) An unfused int8 engine (``multi_token=1``, every layer on K3): net
    B's weights published with ``publish_weights`` and deployed by ``POST
    /weights`` while a request decodes; the request completes, later
    requests equal a fresh engine on net B, nothing is captured,
    ``/healthz`` shows version 1; a swap on (a)'s fused engine raises the
    JAX refusal. (e) ``POST /drain`` with requests in flight: ``/healthz``
    503 and draining, new requests 503, the in-flight ones finish ok.
    Returns the launch counts of the phase."""
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from mxnet_tpu_torch import metrics as tmetrics
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops.int8_gemv import gemv_routes, launches, reset_launches
    from mxnet_tpu_torch.serve import HTTPFrontend, InferenceEngine
    rng = np.random.RandomState(args.seed + 14)
    vocab = net.cfg.vocab_size
    tmetrics.enable()
    tmetrics.reset()
    prompts = [rng.randint(0, vocab, int(n)).tolist() for n in rng.randint(8, 49, 10)]
    payloads = [{"input_ids": p, "max_new_tokens": HTTP_NEW,
                 **({"temperature": 0.8, "seed": 1400 + i} if i >= 8 else {})}
                for i, p in enumerate(prompts)]

    rounds = payloads * HTTP_ROUNDS
    received = []           # (status, generated tokens) of each reply from eng

    def in_process(eng):
        # from the client pool, as HTTP posts them: each thread submits a
        # request and waits for its result before the next
        return list(client.map(lambda p: eng.submit(
            p["input_ids"], HTTP_NEW, temperature=p.get("temperature", 0.0),
            seed=p.get("seed", 0)).result(timeout=600), rounds))

    def post(batch):
        got = http_post_all(fe.url, batch, client)
        received.extend((d.get("status"), len(d.get("generated_ids", ()))) for _, d in got)
        return got

    eng = InferenceEngine(net, max_batch_size=8, max_len=256, multi_token=4, paged=True,
                          page_size=16).start()
    fe = HTTPFrontend(eng, host="127.0.0.1", port=0).start()
    client = ThreadPoolExecutor(8)
    out = {}
    try:
        t0 = time.perf_counter()
        warmed = warm(eng)
        eng.warmup_score()
        warmed = dict(warmed, **{k: eng.stats()[k] for k in ("captures", "compiled_buckets")})
        out["warmup_s"] = time.perf_counter() - t0
        reset_launches()
        # (a) through HTTP, and the same requests in-process, trial by trial
        seqs = [rng.randint(0, vocab, int(n)).tolist() for n in (5, 8, 23, 64)]
        # (b) K3's routes read around these scores alone: nothing else is
        # in flight, so every launch they count is a score's
        routes0 = gemv_routes()
        alone = [http_json(fe.url, "/score", {"input_ids": s}) for s in seqs]
        out["score_routes"] = {k: n - routes0.get(k, 0) for k, n in gemv_routes().items()}
        check(all(c == 200 for c, _ in alone), f"/score: {[c for c, _ in alone]}")
        check(out["score_routes"].get("warp", 0) > 0 and out["score_routes"].get("mma", 0) > 0,
              f"(b) /score of {[len(s) for s in seqs]} tokens: K3 routes "
              f"{out['score_routes']}")
        alone = [d for _, d in alone]
        trials = {"http": [], "in_process": []}
        replies = None
        for trial in range(HTTP_TRIALS):
            t0 = time.perf_counter()
            got = post(rounds)
            wall = time.perf_counter() - t0
            check(all(c == 200 and d["status"] == "ok" for c, d in got),
                  f"(a) trial {trial}: {[(c, d.get('status'), d.get('error')) for c, d in got]}")
            replies = replies or [d for _, d in got[:len(payloads)]]
            check([d["generated_ids"] for _, d in got]
                  == [d["generated_ids"] for d in replies] * HTTP_ROUNDS,
                  f"(a) trial {trial}: the tokens moved between rounds or trials")
            trials["http"].append((wall, sum(len(d["generated_ids"]) for _, d in got)))
            t0 = time.perf_counter()
            res = in_process(eng)
            wall = time.perf_counter() - t0
            received.extend((r.status, len(r.generated_ids)) for r in res)
            check(all(r.ok for r in res), f"(a) in-process trial {trial}")
            check([r.generated_ids for r in res]
                  == [d["generated_ids"] for d in replies] * HTTP_ROUNDS,
                  f"(a) trial {trial}: HTTP tokens differ from in-process generate()")
            trials["in_process"].append((wall, sum(len(r.generated_ids) for r in res)))
        for mode, rows in trials.items():
            out[mode] = {"requests_per_s": median_span([len(rounds) / w for w, _ in rows]),
                         "tokens_per_s": median_span([n / w for w, n in rows]),
                         "wall_s": [w for w, _ in rows]}
        # SSE: frame for frame the JSON replies
        for p, d in zip(payloads, replies):
            toks, done = http_sse(fe.url, dict(p, stream=True))
            check(toks == d["generated_ids"] and done is not None
                  and done["generated_ids"] == toks and done["status"] == "ok",
                  f"SSE stream differs from the JSON reply for prompt {p['input_ids'][:4]}")
            received.append((done["status"], len(toks)))
        # (b) scores posted while (a)'s requests decode: the same bits
        with ThreadPoolExecutor(1) as pool:
            busy = pool.submit(post, payloads)
            during = []
            while not busy.done() or not during:
                during.append([http_json(fe.url, "/score", {"input_ids": s})[1] for s in seqs])
            check(all(c == 200 for c, _ in busy.result()), "(b) decode window failed")
        check(all(d == alone for d in during),
              "(b) a score posted during decode differs from one posted alone")
        out["scores_during_decode"] = len(during)
        for s, d in zip(seqs, alone):
            check(d["tokens"] == len(s) - 1 and d["logprob"] == sum(d["token_logprobs"]),
                  f"(b) /score doc of {len(s)} tokens: tokens {d['tokens']}, logprob "
                  f"{d['logprob']} != the sum of its token_logprobs")
        # score ms per bucket, in-process through the graphs
        score_ms = {}
        for pb in warmed["compiled_buckets"]["score"]:
            ids = rng.randint(0, vocab, pb).tolist()
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                eng.score(ids)
                times.append((time.perf_counter() - t0) * 1e3)
            score_ms[pb] = statistics.median(times)
        out["score_ms_per_bucket"] = score_ms
        greedy = [{"input_ids": p["input_ids"], "max_new_tokens": HTTP_NEW}
                  for p in payloads[:8]] * HTTP_ROUNDS
        out["profiled_window"] = device_share(
            torch, eng, None, HTTP_NEW,
            run=lambda: [_Reply(d) for _, d in post(greedy)]) or "not measured"
        no_capture_since(eng, warmed, "http_serve (a)")
        # (c) /metrics: the counters the requests alone fix, against the
        # replies received, and the launch sites of every step the engine
        # built
        with urllib.request.urlopen(fe.url + "/metrics", timeout=60) as r:
            text = r.read().decode()
        vals = metric_values(text, ("mxnet_serve_requests_total", "mxnet_serve_tokens_total",
                                    "mxnet_decode_launches_total"))
        served = sum(1 for status, _ in received if status == "ok")
        tokens = sum(n for _, n in received)
        check(vals.get('mxnet_serve_requests_total{status="ok"}') == served,
              f"(c) requests_total ok {vals.get('mxnet_serve_requests_total{status=\"ok\"}')} "
              f"!= {served} replies received ok")
        check(vals.get("mxnet_serve_tokens_total") == tokens,
              f"(c) tokens_total {vals.get('mxnet_serve_tokens_total')} != {tokens} tokens "
              "received")
        sites = {}
        for step in (list(eng._steps.values()) + list(eng._chunks.values())
                     + list(eng._score_steps.values())):
            for kind, n in step.tally.kinds.items():
                sites[kind] = sites.get(kind, 0) + n
        got_sites = {k[len('mxnet_decode_launches_total{kind="'):-2]: v for k, v in vals.items()
                     if k.startswith("mxnet_decode_launches_total{")}
        check(got_sites == sites, f"(c) decode_launches_total {got_sites} != built {sites}")
        code, hz = http_json(fe.url, "/healthz")
        check(code == 200 and hz["models"] == {"default": 0} and hz["ok"],
              f"(c) /healthz {code} {hz}")
        out["metrics"] = {"requests_ok": served, "tokens": tokens,
                          "decode_launch_sites": sites}
        # (d) a swap on the fused engine raises the JAX refusal
        try:
            eng.swap_weights({})
            check(False, "(d) a swap on a fused engine did not raise")
        except MXNetError as e:
            check("serves fused int8 decode" in str(e), f"(d) refusal: {e}")
        out["swap"] = swap_deploy(torch, args, rng, net)
        # (e) drain with 4 long requests in flight
        long = [dict(p, max_new_tokens=200) for p in payloads[:4]]
        with ThreadPoolExecutor(4) as pool:
            inflight = [pool.submit(http_json, fe.url, "/generate", p) for p in long]
            deadline = time.monotonic() + 120
            while eng.stats()["slots_in_use"] < len(long):
                check(time.monotonic() < deadline, "(e) the requests were never admitted")
                time.sleep(0.001)
            code, doc = http_json(fe.url, "/drain", {})
            check(code == 200 and doc == {"ok": True, "draining": True}, f"(e) /drain {code}")
            code, hz = http_json(fe.url, "/healthz")
            check(code == 503 and hz["draining"] is True, f"(e) /healthz {code} {hz}")
            code, doc = http_json(fe.url, "/generate", payloads[0])
            check(code == 503, f"(e) /generate after /drain: {code} {doc}")
            finished = [f.result() for f in inflight]
        check(all(c == 200 and d["status"] == "ok" and len(d["generated_ids"]) == 200
                  for c, d in finished),
              f"(e) in-flight requests: {[(c, d.get('status')) for c, d in finished]}")
        out["drain"] = [d["status"] for _, d in finished]
        counts = launches()
        counts["routes"] = gemv_routes()
    finally:
        client.shutdown()
        fe.stop()
        eng.shutdown(drain=False, timeout=300)
        tmetrics.disable()
    for kind in ("fused_block_paged", "fused_head"):
        check(counts.get(kind, 0) > 0, f"http_serve: {kind} never launched")
    check(counts["routes"]["warp"] > 0 and counts["routes"]["mma"] > 0,
          f"http_serve: K3 routes {counts['routes']}")
    # (b) against eager scores on the card and the CPU twin's scores
    eager = InferenceEngine(net, max_batch_size=1, max_len=256, paged=False)
    eager._eager = True
    cpu = InferenceEngine(cpu_net, max_batch_size=1, max_len=256, paged=False)
    worst = 0.0
    for s, d in zip(seqs, alone):
        e = eager.score(s)
        check(d["token_logprobs"] == e["token_logprobs"],
              f"(b) graph score of {len(s)} tokens != the eager score on the card")
        c = cpu.score(s)["token_logprobs"]
        err = max(abs(a - b) for a, b in zip(d["token_logprobs"], c))
        worst = max(worst, err)
        check(err <= SCORE_TOL, f"(b) score of {len(s)} tokens: {err} from the CPU twin")
    out["score_vs_cpu_max_abs"] = worst
    out["launches"] = counts
    emit({"http_serve": out})
    return counts


def swap_deploy(torch, args, rng, net):
    """(d): an unfused int8 engine (``multi_token=1``) over two fresh
    models of ``net``'s config behind its own frontend; net B's weights
    published and deployed by ``POST /weights`` while a request decodes.
    Returns the deploy's numbers."""
    import shutil

    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.contrib.quantization import quantize_net
    from mxnet_tpu_torch.models import GPTModel
    from mxnet_tpu_torch.serve import (HTTPFrontend, InferenceEngine, publish_weights,
                                       snapshot_params)
    pub = _build.BUILD_DIR.parent / "http_serve_weights"
    shutil.rmtree(pub, ignore_errors=True)
    vocab = net.cfg.vocab_size
    net_a = quantize_net(GPTModel(net.cfg, device=net.device).init_weights(args.seed + 20))
    net_b = quantize_net(GPTModel(net.cfg, device=net.device).init_weights(args.seed + 21))
    publish_weights(str(pub), snapshot_params(net_b))
    prompts = [rng.randint(0, vocab, int(n)).tolist() for n in rng.randint(8, 33, 4)]
    kw = dict(max_batch_size=8, max_len=256, multi_token=1)
    eng = InferenceEngine(net_a, **kw).start()
    fe = HTTPFrontend(eng, host="127.0.0.1", port=0).start()
    applied = []
    copy = eng._copy_weights

    def timed_copy(staged):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        copy(staged)
        torch.cuda.synchronize()
        applied.append((time.perf_counter() - t0) * 1e3)

    eng._copy_weights = timed_copy
    try:
        warmed = warm(eng)
        before = [eng.generate(p, 16).generated_ids for p in prompts]
        eng._step_delay = 0.05      # the request outlasts the weights' read
        h = eng.submit(prompts[0], 200)
        while h.status == "queued":
            time.sleep(0.001)
        t0 = time.perf_counter()
        code, doc = http_json(fe.url, "/weights", {"dir": str(pub)})
        deploy_s = time.perf_counter() - t0
        check(code == 200 and doc == {"ok": True, "model": "default", "version": 1},
              f"(d) POST /weights: {code} {doc}")
        check(not h.done(), "(d) the request finished before the swap landed")
        r = h.result(timeout=600)
        eng._step_delay = 0.0
        check(r.ok and len(r.generated_ids) == 200,
              f"(d) the request in flight: {r.status} {len(r.generated_ids)} tokens")
        after = [eng.generate(p, 16).generated_ids for p in prompts]
        no_capture_since(eng, warmed, "http_serve (d) swap")
        code, hz = http_json(fe.url, "/healthz")
        check(code == 200 and hz["models"] == {"default": 1}, f"(d) /healthz {code} {hz}")
    finally:
        fe.stop()
        eng.shutdown(drain=False, timeout=300)
    ref = InferenceEngine(net_b, **kw).start()
    try:
        warm(ref)
        want = [ref.generate(p, 16).generated_ids for p in prompts]
    finally:
        ref.shutdown()
    check(after == want, "(d) after the swap the tokens differ from a fresh engine on net B")
    check(after != before, "(d) the swap changed no token")
    shutil.rmtree(pub, ignore_errors=True)
    return {"deploy_s": deploy_s, "apply_ms": applied, "swapped_request_tokens": 200,
            "captures": warmed["captures"]}


# the three dispatch modes of the capture comparison: (name, eager, lookahead)
DISPATCH_MODES = (("eager", True, False), ("captured", False, False),
                  ("captured+lookahead", False, True))
# trials per mode (tokens/s: median, min and max); paged B eager, several
# seconds a trial, takes one
MODE_TRIALS = 3
# the contiguous window's 12 requests are submitted this many times a trial,
# so that a trial lasts seconds and not a fraction of one
CONTIGUOUS_ROUNDS = 5


def dispatch_modes(torch, args, net, window):
    """One serving window three ways in one call: eager dispatch without
    lookahead (``engine._eager``, the port before graphs), captured graphs
    without lookahead, and captured graphs with lookahead (the default).
    ``window`` is ``"contiguous"`` (serve()'s 12 requests on its engine,
    CONTIGUOUS_ROUNDS times over) or ``"paged_B"`` (serve_paged's phase B:
    8 greedy long prompts, 160 pages, preemption). Per mode: ms per decode
    substep and tokens/s (median, min and max of MODE_TRIALS trials; one
    for paged B eager), and the greedy requests once more under the
    profiler (idle share, unless the trace dropped kernels). Every mode
    warms up first and captures nothing while serving; the contiguous
    window's tokens are equal in all modes (paged B's resumes re-prefill
    at other points when the timing moves, so its tokens are reported)."""
    import numpy as np

    from mxnet_tpu_torch.serve import InferenceEngine
    if window == "contiguous":
        prompts, temps, new = contiguous_requests(torch, args, net)
        seeds = [1000 + i for i in range(len(prompts))] * CONTIGUOUS_ROUNDS
        prompts, temps = prompts * CONTIGUOUS_ROUNDS, temps * CONTIGUOUS_ROUNDS
        kw = dict(max_batch_size=8, max_len=512, paged=False)
    else:
        rng = np.random.RandomState(args.seed + 2)
        prompts = [rng.randint(0, net.cfg.vocab_size, int(n)).tolist()
                   for n in rng.randint(300, 701, 8)]
        temps, new, seeds = [0.0] * 8, 128, list(range(2000, 2008))
        kw = dict(max_batch_size=8, max_len=1024, num_pages=PAGED_B_PAGES,
                  prefix_cache=False, paged=True, page_size=16)
    greedy = [p for p, t in zip(prompts, temps) if t == 0]
    rows, tokens = {}, {}
    for name, eager, lookahead in DISPATCH_MODES:
        t_mode = time.perf_counter()
        eng = InferenceEngine(net, multi_token=4, fused=True, lookahead=lookahead, **kw)
        eng._eager = eager
        eng.start()
        try:
            warmed = warm(eng)
            trials = []
            for _ in range(1 if window == "paged_B" and eager else MODE_TRIALS):
                before = eng.stats()
                t0 = time.perf_counter()
                hs = [eng.submit(p, new, temperature=t, seed=sd)
                      for p, t, sd in zip(prompts, temps, seeds)]
                res = [h.result(timeout=900) for h in hs]
                wall = time.perf_counter() - t0
                after = eng.stats()
                check(all(r.ok and len(r.generated_ids) == new for r in res),
                      f"{window} {name}: a request failed")
                subs = after["decode_substeps"] - before["decode_substeps"]
                trials.append({"tokens_per_s": sum(len(r.generated_ids) for r in res) / wall,
                               "ms_per_substep": (after["decode_s"] - before["decode_s"])
                               / subs * 1e3, "wall_s": wall,
                               "preemptions": after.get("preemptions", 0)
                               - before.get("preemptions", 0)})
                tokens.setdefault(name, [r.generated_ids for r in res])
            profiled = device_share(torch, eng, greedy, new)
            no_capture_since(eng, warmed, f"{window} {name}")
        finally:
            eng.shutdown(drain=True, timeout=900)
        tps = sorted(t["tokens_per_s"] for t in trials)
        rows[name] = {
            "tokens_per_s": statistics.median(tps), "tokens_per_s_min": tps[0],
            "tokens_per_s_max": tps[-1],
            "ms_per_substep": statistics.median(t["ms_per_substep"] for t in trials),
            "trials": trials, "warmup_s": warmed["last_warmup_s"],
            "captures": warmed["captures"],
            "idle_share": (profiled or {}).get("idle_share", "not measured"),
            "profiled": profiled, "mode_s": time.perf_counter() - t_mode}
    same = [tokens[name] == tokens["eager"] for name, _, _ in DISPATCH_MODES]
    if window == "contiguous":
        check(all(same), f"{window}: tokens differ between dispatch modes")
    emit({f"dispatch_modes_{window}": {"modes": rows, "tokens_equal_to_eager": same,
                                        "requests": len(prompts), "new_tokens_each": new,
                                        "trials": MODE_TRIALS, **kw}})
    return rows


def quant_bytes(torch, net):
    """Bytes of a quantized model's weight tables and scales: the blocks'
    QuantizedDense layers (an untied head's among them) and the tied
    head."""
    from mxnet_tpu_torch.contrib.quantization import QuantizedDense
    blocks = sum(table_bytes(m.w_q, m.w_scale) for m in net.modules()
                 if isinstance(m, QuantizedDense))
    head = net.head_weights()
    head = table_bytes(*head[:2]) if head is not None else 0
    return {"blocks": blocks, "head": head, "total": blocks + head}


def int4_stage(torch, args, timer, gen, int8_bytes):
    """The int4 serving path: GPT-2 small from the same ``--seed`` under
    ``quantize_net(bits=4, fused_decode=True)``. K4 and the int4 lanes of
    K5, K6, K7 and K8 against their plain versions, then the contiguous
    phase, paged phase A (K6) and paged phase C (K7), each with its peak
    device memory. Returns ({phase: launch counts}, {kernel: row})."""
    from mxnet_tpu_torch.contrib.quantization import quantize_net
    from mxnet_tpu_torch.models import GPT2_SMALL, GPTModel
    from mxnet_tpu_torch.ops.fused_block_gemv import pack_gpt_block
    with torch.no_grad():
        net = GPTModel(GPT2_SMALL, device="cuda").init_weights(args.seed)
        quantize_net(net, bits=4, fused_decode=True)
        check(all(blk._fused_pack is not None and blk._fused_pack["blocks"] == (128,) * 4
                  for blk in net.blocks), "int4 GPT-2 small: a block is not packed int4")
        pack = pack_gpt_block(net.blocks[0], eps=net.cfg.layer_norm_eps)
        rows = {"K4": kernel_gemv(torch, timer, gen, 4), "K5": kernel_k5(torch, timer, gen, pack),
                "K8": kernel_k8(torch, timer, gen, net.head_weights()),
                "K8_lanes": kernel_k8_lanes(torch, timer, gen, net.head_weights())}
        k67 = kernel_k6_k7(torch, timer, gen, pack)
        rows["K6"], rows["K7"] = k67["K6"], k67["K7"]
        cpu_net = GPTModel(GPT2_SMALL, device="cpu").init_weights(args.seed)
        quantize_net(cpu_net, bits=4, fused_decode=True)
    emit({"int4_kernels": {"k4": rows["K4"], "k5": rows["K5"], "k8": rows["K8"],
                           "k8_lanes": rows["K8_lanes"], "k6_k7": k67}})
    emit({"quantized_weight_bytes": {"int8": int8_bytes, "int4": quant_bytes(torch, net)}})
    counts, mem = {}, {}
    torch.cuda.reset_peak_memory_stats()
    counts["contiguous"] = serve(torch, args, net, cpu_net, cpu_tokens=INT4_CPU_TOKENS)
    mem["contiguous"] = torch.cuda.max_memory_allocated() / 1e9
    del cpu_net
    for phase in "AC":
        torch.cuda.reset_peak_memory_stats()
        counts[phase] = serve_paged(torch, args, net, phase)
        mem[phase] = torch.cuda.max_memory_allocated() / 1e9
    emit({"int4_peak_mem_gb": mem})
    return counts, rows


def gpt2_bf16(torch, args, device, bits):
    """bf16 GPT-2 small from ``--seed`` (dropout 0), quantized as
    ``bench.py``'s decode headlines quantize it: int8 with
    ``calib_mode='naive'`` on CALIB_BATCHES seeded batches of CALIB_SHAPE
    tokens, or (``bits`` 4) int4 with dynamic scales; fused decode."""
    import dataclasses

    import numpy as np

    from mxnet_tpu_torch.contrib.quantization import quantize_net
    from mxnet_tpu_torch.models import GPT2_SMALL, GPTModel
    cfg = dataclasses.replace(GPT2_SMALL, dtype=torch.bfloat16, dropout=0.0)
    with torch.no_grad():
        net = GPTModel(cfg, device=device).init_weights(args.seed)
    if bits == 4:
        return quantize_net(net, bits=4, fused_decode=True)
    rng = np.random.RandomState(args.seed + 11)
    calib = [rng.randint(0, cfg.vocab_size, CALIB_SHAPE).astype(np.int32)
             for _ in range(CALIB_BATCHES)]
    return quantize_net(net, calib_mode="naive", calib_data=calib, fused_decode=True)


def generate_headline(torch, args, net):
    """``bench.py``'s decode headline on the card: greedy ``generate()`` of
    8 prompts of 32 tokens, 128 new tokens, ``multi_token=8`` (the 256-row
    prefill takes the activation-quantized product at the calibrated
    scales for int8, the dequantized table for int4; every decode substep
    12 block launches and one fused head). Tokens in the vocab, the same
    on a second call, the launch counts of the path. Returns the counts."""
    import numpy as np

    from mxnet_tpu_torch.models import generate
    from mxnet_tpu_torch.ops.int8_gemv import dtype_lanes, launches, reset_launches
    tag, kinds, forbidden = lane(torch, net)
    B, P, new, K = 8, 32, 128, 8
    ids = torch.from_numpy(np.random.RandomState(args.seed + 12)
                           .randint(0, net.cfg.vocab_size, (B, P)).astype(np.int32))
    generate(net, ids[:, :8], 9, multi_token=K)               # warm-up
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(net, ids, new, multi_token=K)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    counts["lanes"] = dtype_lanes()
    again = generate(net, ids, new, multi_token=K)
    substeps = -(-(new - 1) // K) * K
    check(tuple(out.shape) == (B, P + new), f"{tag}generate: shape {tuple(out.shape)}")
    check(bool(((out >= 0) & (out < net.cfg.vocab_size)).all()),
          f"{tag}generate: token outside the vocab")
    check(torch.equal(out, again), f"{tag}generate: a second call gave other tokens")
    check(counts.get(kinds["block"], 0) == LAYERS * substeps,
          f"{tag}generate: {counts.get(kinds['block'])} block launches != 12 x {substeps}")
    check(counts.get(kinds["head"], 0) == substeps + 1,
          f"{tag}generate: {counts.get(kinds['head'])} head launches != {substeps} + token 0")
    check(not any(counts.get(k) for k in forbidden), f"an int8 kind launched: {counts}")
    L = P + 1 + substeps
    kv = 2 * LAYERS * B * L * net.cfg.hidden_size * torch.finfo(net.cfg.dtype).bits // 8
    emit({tag + "generate": {"B": B, "prompt": P, "new_tokens": new, "multi_token": K,
                             "wall_s": wall, "tokens_per_s": B * new / wall,
                             "ms_per_substep": wall / (substeps + 1) * 1e3,
                             "kv_bytes": kv, "launches": counts}})
    return counts


def bf16_stage(torch, args, timer, gen):
    """The bf16 serving path of ``bench.py``'s decode headlines: bf16 GPT-2
    small from the same ``--seed``, int8 with naive calibration, then int4.
    The bf16 lanes of K3, K5, K6 and K7 (and of K4 and the int4 K5, K6, K7)
    against their plain versions (K3/K4's bf16 lane the f32 lane on
    x.float() bit for bit, K5 = K6 = K7 bitwise in bf16); then, int8: the
    ``generate()`` headline, the contiguous phase, paged A (K6) and paged B
    (K7 at L 1024 with preemption); int4: the ``generate()`` headline and
    the contiguous phase. Returns ({phase: launch counts}, {kernel: row})."""
    from mxnet_tpu_torch.ops.fused_block_gemv import pack_gpt_block
    bf16 = torch.bfloat16
    counts, rows = {}, {}
    net = gpt2_bf16(torch, args, "cuda", 8)
    eps = net.cfg.layer_norm_eps
    check(all(blk._fused_pack is not None for blk in net.blocks),
          "bf16 int8 GPT-2 small: a block is not packed")
    pack = pack_gpt_block(net.blocks[0], eps=eps)
    with torch.no_grad():
        rows["K3"] = kernel_gemv(torch, timer, gen, 8, bf16=True)
        rows["K5"] = kernel_k5(torch, timer, gen, pack, bf16=True)
        k67 = kernel_k6_k7(torch, timer, gen, pack, dtype=bf16)
    rows["K6"], rows["K7"] = k67["K6"], k67["K7"]
    emit({"bf16_kernels": {"k5": rows["K5"], "k6_k7": k67}})
    cpu_net = gpt2_bf16(torch, args, "cpu", 8)
    counts["generate"] = generate_headline(torch, args, net)
    counts["contiguous"] = serve(torch, args, net, cpu_net, cpu_tokens=BF16_CPU_TOKENS)
    del cpu_net
    counts["k1"] = serve_k1(torch, args, net, counts["contiguous"]["k4"])
    for phase in "AB":
        counts[phase] = serve_paged(torch, args, net, phase)
    del net
    torch.cuda.empty_cache()
    net = gpt2_bf16(torch, args, "cuda", 4)
    pack = pack_gpt_block(net.blocks[0], eps=eps)
    check(pack is not None and pack["blocks"] == (128,) * 4,
          "bf16 int4 GPT-2 small: block 0 is not packed int4")
    with torch.no_grad():
        rows["K4"] = kernel_gemv(torch, timer, gen, 4, bf16=True)
        rows["K5_int4"] = kernel_k5(torch, timer, gen, pack, bf16=True)
        k67 = kernel_k6_k7(torch, timer, gen, pack, dtype=bf16)
    emit({"bf16_int4_kernels": {"k5": rows["K5_int4"], "k6_k7": k67}})
    cpu_net = gpt2_bf16(torch, args, "cpu", 4)
    counts["int4_generate"] = generate_headline(torch, args, net)
    counts["int4_contiguous"] = serve(torch, args, net, cpu_net,
                                      cpu_tokens=BF16_INT4_CPU_TOKENS)
    del cpu_net, net
    torch.cuda.empty_cache()
    return counts, rows


def visible_pairs(T, S, causal):
    """(query, key) pairs attention computes: all T*S, or under the
    end-aligned causal mask sum_i min(S, i + S - T + 1)."""
    if not causal:
        return T * S
    return sum(min(S, max(0, i + S - T + 1)) for i in range(T))


# K1/K2 against their plain versions, per storage type: (max abs error
# over max(1, max |plain|), worst row error). A row is one (b, h, query or
# key) vector of o, dq, dk or dv, or one lse entry; see flash_errors. The
# H100 read at most 4.8e-3 in bf16; in f32 5.6e-5, at a causal query 0,
# whose dq is 0 in exact arithmetic and rounding noise in both versions,
# and 1.5e-6 elsewhere.
FLASH_TOL = {"float32": (1e-4, 3e-4), "bfloat16": (2e-2, 1e-2)}
ROW_FLOOR = 0.05
FLASH_TILE = 64


def flash_errors(got, want):
    """(max abs error, max abs error limit scale, worst row error) of
    ``got`` against ``want``. Row error: |got - want|_2 / (|want|_2 +
    ROW_FLOOR * rms), rms the root mean square of the rows' norms, so each
    row is held to its own size (the late rows and keys of a causal shape
    are an order of magnitude smaller than the first ones) and a row near 0
    to a small share of the typical one."""
    want = want.float()
    d = got.float() - want
    if want.dim() == 3:                      # lse (B, H, T): rows are entries
        d, want = d[..., None], want[..., None]
    size = want.norm(dim=-1)
    floor = ROW_FLOOR * size.pow(2).mean().sqrt()
    row = (d.norm(dim=-1) / (size + floor)).max().item()
    return d.abs().max().item(), max(1.0, want.abs().max().item()), row


def flash_within(got, want, dtype_name):
    err, scale, row = flash_errors(got, want)
    abs_tol, row_tol = FLASH_TOL[dtype_name]
    return err <= abs_tol * scale and row <= row_tol


def plain_forward_without(torch, fa, q, k, v, causal, scale, lo, hi):
    """The plain K1 with keys [lo, hi) masked for every query: what a K1
    that skipped that key tile would compute."""
    s, valid = fa._scores(q, k, causal, scale)
    s[..., lo:hi] = torch.finfo(torch.float32).min
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)


def planted_faults(torch, fa, f, o, lse, causal, scale, want, dtype):
    """Three kernels with a planted fault, emulated from the plain versions
    on the same inputs and rounded to the storage type: K1 skipping one key
    tile, K2's dk/dv kernel skipping the last query tile, K2 leaving the
    scale out of ds. Each must fail the check; returns, for each, its row
    errors and whether the max-abs limit alone would have caught it."""
    q, k, v, do = f
    T, S = q.shape[2], k.shape[2]
    name = str(dtype).replace("torch.", "")
    lo = (S // 2) // FLASH_TILE * FLASH_TILE
    faults = {"k1_key_tile_skipped": {"o": plain_forward_without(
        torch, fa, q, k, v, causal, scale, lo, lo + FLASH_TILE)}}
    cut = do.clone()
    cut[:, :, (T - 1) // FLASH_TILE * FLASH_TILE:] = 0
    _, fdk, fdv = fa._reference_flash_backward(q, k, v, o.float(), lse, cut, causal, scale)
    faults["k2_last_query_tile_skipped"] = {"dk": fdk, "dv": fdv}
    faults["k2_ds_unscaled"] = {"dq": want["dq"] / scale, "dk": want["dk"] / scale}
    out = {}
    abs_tol = FLASH_TOL[name][0]
    for fault, outs in faults.items():
        rows, caught, by_abs = {}, False, False
        for key, bad in outs.items():
            bad = bad.to(dtype)
            err, size, rows[key] = flash_errors(bad, want[key])
            caught = caught or not flash_within(bad, want[key], name)
            by_abs = by_abs or err > abs_tol * size
        check(caught, f"planted fault {fault} passes the {name} check: {rows}")
        out[fault] = {"row_err": rows, "max_abs_alone_catches": by_abs}
    return out


def flash_case(torch, timer, gen, B, H, T, S, D, causal, dtype, timed, faults=False):
    """K1 and K2 at one shape against their plain versions (run in f32 on
    the same inputs; K2's plain version gets K1's own o and lse, so each
    kernel is held alone). Returns the case row."""
    from mxnet_tpu_torch.ops import attention as fa
    q, do = (torch.randn(B, H, T, D, device="cuda", generator=gen).to(dtype) for _ in range(2))
    k, v = (torch.randn(B, H, S, D, device="cuda", generator=gen).to(dtype) for _ in range(2))
    scale = D ** -0.5
    o, lse = fa.flash_forward(q, k, v, causal, scale)
    dq, dk, dv = fa.flash_backward(q, k, v, o, lse, do, causal, scale)
    again = fa.flash_backward(q, k, v, o, lse, do, causal, scale)
    torch.cuda.synchronize()
    repeat = all(bool(torch.equal(a, b)) for a, b in zip((dq, dk, dv), again))
    check(repeat, f"K2 at {(B, H, T, S, D, causal, dtype)} gave other bits on a second run")
    del again
    f = [t.float() for t in (q, k, v, do)]
    po, plse = fa._reference_flash_forward(f[0], f[1], f[2], causal, scale)
    pdq, pdk, pdv = fa._reference_flash_backward(f[0], f[1], f[2], o.float(), lse, f[3],
                                                 causal, scale)
    name = str(dtype).replace("torch.", "")
    abs_tol, row_tol = FLASH_TOL[name]
    want = {"o": po, "lse": plse, "dq": pdq, "dk": pdk, "dv": pdv}
    errs, row_errs = {}, {}
    for key, got in (("o", o), ("lse", lse), ("dq", dq), ("dk", dk), ("dv", dv)):
        where = f"flash {key} at {(B, H, T, S, D, causal, name)}"
        check(bool(torch.isfinite(got).all()), f"{where} not finite")
        err, size, row = flash_errors(got, want[key])
        check(err <= abs_tol * size, f"{where}: max abs err {err} > {abs_tol * size}")
        check(row <= row_tol, f"{where}: row error {row} > {row_tol}")
        errs[key], row_errs[key] = err, row
    row = {"B": B, "H": H, "T": T, "S": S, "D": D, "causal": causal,
           "dtype": name, "max_abs_err": errs, "row_err": row_errs,
           "tol": {"max_abs_over_max_plain": abs_tol, "row": row_tol},
           "k2_repeat_bitwise": repeat,
           "k1_max_abs_err": max(errs["o"], errs["lse"]),
           "k2_max_abs_err": max(errs["dq"], errs["dk"], errs["dv"])}
    if faults:
        row["planted_faults_row_err"] = planted_faults(torch, fa, f, o, lse, causal, scale,
                                                       want, dtype)
    del po, plse, pdq, pdk, pdv, f, want
    if not timed:
        return row
    isz = q.element_size()
    pairs = B * H * visible_pairs(T, S, causal)
    rate = F32_FLOP_PER_S if dtype == torch.float32 else BF16_FLOP_PER_S
    qo = B * H * T * D * isz
    kv = B * H * S * D * isz
    row["k1_bound_ms"], row["k1_bound_by"] = bound(2 * qo + 2 * kv + 4 * B * H * T,
                                                   4 * D * pairs, rate)
    row["k2_bound_ms"], row["k2_bound_by"] = bound(4 * qo + 4 * kv + 4 * B * H * T,
                                                   10 * D * pairs, rate)
    row["k1_ms"] = timer(lambda: fa.flash_forward(q, k, v, causal, scale))
    row["k1_plain_ms"] = timer(lambda: fa._reference_flash_forward(q, k, v, causal, scale))
    row["k2_ms"] = timer(lambda: fa.flash_backward(q, k, v, o, lse, do, causal, scale))
    row["k2_plain_ms"] = timer(lambda: fa._reference_flash_backward(q, k, v, o, lse, do,
                                                                    causal, scale))
    row["k1_library_ms"] = row["k2_library_ms"] = None
    if T == S:
        # yardstick only, never called by the port: PyTorch's SDPA, its
        # flash backend in bf16 and its memory-efficient one in f32 (the
        # flash backend takes 16-bit types only)
        from torch.nn.attention import SDPBackend, sdpa_kernel
        sdpa = torch.nn.functional.scaled_dot_product_attention
        backend = (SDPBackend.FLASH_ATTENTION if dtype == torch.bfloat16
                   else SDPBackend.EFFICIENT_ATTENTION)
        row["library"] = f"scaled_dot_product_attention ({backend.name})"
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

        def fwd():
            with torch.no_grad():
                return sdpa(q, k, v, is_causal=causal, scale=scale)

        def fwd_bwd():
            out = sdpa(*leaves, is_causal=causal, scale=scale)
            out.backward(do)
        try:
            with sdpa_kernel(backend), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                row["k1_library_ms"] = timer(fwd)
                row["k2_library_ms"] = timer(fwd_bwd) - row["k1_library_ms"]
        except RuntimeError as e:
            row["library_error"] = str(e)[:300]
    return row


def kernel_flash(torch, timer, gen):
    """K1/K2 at the training shape (timed), at head dim 128 (Llama's: 32
    heads, timed in bf16) and at the edge shapes; K2 must repeat bit for bit
    at every one."""
    rows = [flash_case(torch, timer, gen, TRAIN_B, 12, TRAIN_T, TRAIN_T, 64, True,
                       torch.bfloat16, timed=True, faults=True),
            flash_case(torch, timer, gen, 2, 12, TRAIN_T, TRAIN_T, 64, True,
                       torch.float32, timed=True),
            flash_case(torch, timer, gen, 4, 32, TRAIN_T, TRAIN_T, 128, True,
                       torch.bfloat16, timed=True)]
    for dtype in (torch.bfloat16, torch.float32):
        for B, H, T, S, D, causal in ((2, 12, 1000, 1000, 64, True),   # ragged
                                      (2, 12, 256, 512, 64, True),     # end-aligned
                                      (2, 12, 1024, 1024, 40, False),  # padded head dim
                                      (1, 8, 1024, 1024, 128, True)):  # head dim 128
            rows.append(flash_case(torch, timer, gen, B, H, T, S, D, causal, dtype,
                                   timed=False))
    emit({"flash_cases": rows})
    main = rows[0]
    err1 = max(r["k1_max_abs_err"] for r in rows)
    err2 = max(r["k2_max_abs_err"] for r in rows)
    k1 = {"max_abs_err": err1, "ms": main["k1_ms"], "plain_ms": main["k1_plain_ms"],
          "bound_ms": main["k1_bound_ms"], "bound_by": main["k1_bound_by"],
          "library_ms": main["k1_library_ms"]}
    k2 = {"max_abs_err": err2, "ms": main["k2_ms"], "plain_ms": main["k2_plain_ms"],
          "bound_ms": main["k2_bound_ms"], "bound_by": main["k2_bound_by"],
          "library_ms": main["k2_library_ms"]}
    return k1, k2


def train_batch(args, vocab, B, T):
    import numpy as np
    rng = np.random.RandomState(args.seed)
    ids = rng.randint(0, vocab, (B, T)).astype(np.int32)
    labels = rng.randint(0, vocab, (B, T)).astype(np.int32)
    return ids, labels


def gpt2_train_config(dtype, dropout):
    """GPT-2 small in ``dtype`` at ``dropout`` (DEFAULT_DROPOUT is
    ``GPTConfig()``'s own)."""
    from mxnet_tpu_torch.models import GPTConfig
    return GPTConfig(dropout=dropout, dtype=dtype)


def headline_schedule():
    """The dropout-0.1 headline's learning rate: linear warmup from
    TRAIN_LR / 10 over 2 updates, then cosine down to TRAIN_LR / 10 at the
    last profiled step."""
    from mxnet_tpu_torch.lr_scheduler import CosineScheduler
    return CosineScheduler(max_update=1 + TRAIN_STEPS + PROFILE_STEPS, base_lr=TRAIN_LR,
                           warmup_steps=2, warmup_begin_lr=TRAIN_LR / 10,
                           final_lr=TRAIN_LR / 10)


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def dropout_device_ms(torch, step, ids, labels):
    """One more step under ``torch.profiler`` with host and device
    activity, every ``npx.dropout`` call inside a ``record_function``
    range: the device time of the kernels launched by the forward sites
    (mask and scale) and by their backward nodes (``_DropoutBackward``),
    in ms, or None when the profiler attributes no device time to them."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from mxnet_tpu_torch import numpy_extension as npx
    real = npx.dropout

    def ranged(*a, **k):
        with record_function("mx_dropout"):
            return real(*a, **k)
    torch.cuda.synchronize()
    npx.dropout = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(ids, labels)
            torch.cuda.synchronize()
    finally:
        npx.dropout = real
    from torch.autograd import DeviceType
    fwd = bwd = 0.0
    nf = nb = 0
    # host-side ranges only: each range also shows as a device annotation
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        if e.name == "mx_dropout":
            fwd += e.device_time_total
            nf += 1
        elif e.name.startswith("autograd::engine::evaluate_function: _DropoutBackward"):
            bwd += e.device_time_total
            nb += 1
    if fwd + bwd <= 0:
        return None
    return {"sites": nf, "backward_nodes": nb, "forward_ms": fwd / 1e3,
            "backward_ms": bwd / 1e3, "total_ms": (fwd + bwd) / 1e3}


def kernel_class(name):
    """A training kernel's class by its name: K1 (``flash_fwd``), K2
    (``flash_bwd``: its prep, sweep and cast kernels), a library GEMM, or
    ``other``."""
    low = name.lower()
    if "flash_fwd_" in name:
        return "flash_fwd"
    if any(k in name for k in ("flash_dkdv_", "flash_dq_", "flash_bwd_", "bwd_prep", "bwd_cast")):
        return "flash_bwd"
    if any(w in low for w in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "gemm"
    return "other"


def train_profile(torch, step, ids, labels, device, steps=PROFILE_STEPS):
    """``steps`` training steps under ``torch.profiler`` (device activity
    only): device busy time against host wall time, and device time by
    kernel (flash_fwd, flash_bwd, GEMM, other)."""
    from torch.profiler import ProfilerActivity, profile
    sync(torch, device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(ids, labels)
        sync(torch, device)
        wall = time.perf_counter() - t0
    spans = device_spans(prof)
    if not spans:
        return None
    busy = busy_us(spans)
    by_kernel, by_name = {}, {}
    for a, b, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
        key = kernel_class(name)
        by_kernel[key] = by_kernel.get(key, 0.0) + (b - a) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"steps": steps, "wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / 1e3 / (wall * 1e3), "kernel_ms": by_kernel,
            "device_ops": len(spans),
            "top_kernels_ms": [[name[:120], ms] for name, ms in top]}


def train(torch, args, dropout, device="cuda"):
    """The training main path: bf16 GPT-2 small through ``TrainStep`` at
    ``dropout`` (``device='cpu'`` rehearses it with the plain versions).
    At dropout above 0 the rate follows ``headline_schedule()`` and the
    profile gets a ``dropout`` entry (the sites' device time in a step)."""
    from mxnet_tpu_torch import optimizer, parallel
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import GPTModel
    from mxnet_tpu_torch.ops.int8_gemv import launches, reset_launches
    cfg = gpt2_train_config(torch.bfloat16, dropout)
    B, T = TRAIN_B, TRAIN_T
    net = GPTModel(cfg, device=device).init_weights(args.seed)
    ids, labels = train_batch(args, cfg.vocab_size, B, T)
    ids, labels = torch.from_numpy(ids).to(device), torch.from_numpy(labels).to(device)
    sched = headline_schedule() if dropout > 0 else None
    step = parallel.TrainStep(net, SoftmaxCrossEntropyLoss(),
                              optimizer.Adam(learning_rate=TRAIN_LR, lr_scheduler=sched),
                              example_inputs=[ids])
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = step(ids, labels).float().item()           # warm-up step
    warm_s = time.perf_counter() - t0
    reset_launches()
    sync(torch, device)
    t0 = time.perf_counter()
    losses = [step(ids, labels) for _ in range(TRAIN_STEPS)]
    sync(torch, device)
    dt = time.perf_counter() - t0
    counts = launches()
    lrs = [sched(n) for n in range(1, 2 + TRAIN_STEPS)] if sched else [TRAIN_LR]
    losses = [first] + [x.float().item() for x in losses]
    check(all(math.isfinite(x) for x in losses), f"non-finite training loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for kind in ("flash_fwd", "flash_bwd"):
        check(counts.get(kind, 0) == LAYERS * TRAIN_STEPS,
              f"{kind} launches {counts.get(kind)} != {LAYERS} x {TRAIN_STEPS} steps")
    L, D, V = cfg.num_layers, cfg.hidden_size, cfg.vocab_size
    analytic = 3 * (L * (24 * B * T * D * D + 2 * B * T * T * D) + 2 * B * T * D * V)
    ms = dt / TRAIN_STEPS * 1e3
    if dropout == DEFAULT_DROPOUT:
        FIGURES["gpt2_fixed_ms"] = ms
    peak = torch.cuda.max_memory_allocated() / 1e9 if on_card else None
    profiled = train_profile(torch, step, ids, labels, device) if on_card else None
    if profiled is not None and dropout > 0:
        profiled["dropout"] = dropout_device_ms(torch, step, ids, labels) or "not measured"
    emit({"train": {"model": "gpt2-small", "dtype": "bfloat16", "B": B, "T": T,
                    "dropout": dropout, "optimizer": "adam",
                    "lr_scheduler": "cosine, linear warmup" if sched else None,
                    "lr": lrs, "steps": TRAIN_STEPS,
                    "warmup_s": warm_s, "ms_per_step": ms,
                    "tokens_per_s": B * T * TRAIN_STEPS / dt,
                    "mfu_analytic": analytic / (dt / TRAIN_STEPS) / BF16_FLOP_PER_S,
                    "losses": losses, "launches": counts, "peak_mem_gb": peak}})
    emit({"train_profiled_window": {"rate": dropout, **profiled}
          if profiled is not None else "not measured"})
    return counts


def named_grads(torch, net):
    """{name: f32 CPU copy of the gradient} of ``net``'s parameters."""
    return {n: p.grad.detach().float().cpu() for n, p in net.named_parameters()}


def leaf_errors(got, want):
    """{name: |got - want|_2 / |want|_2}, leaf by leaf."""
    return {n: float((got[n] - w).norm() / w.norm().clamp_min(1e-30)) for n, w in want.items()}


def worst(errs):
    name = max(errs, key=errs.get)
    return {"leaf": name, "rel_l2": errs[name]}


def sgd_steps(torch, args, device, dtype, steps, B, T, dropout):
    """``steps`` f32/bf16 GPT-2-small TrainSteps with SGD (momentum 0.9)
    from ``--seed`` at ``dropout`` (step t's masks from key(t) on
    ``device``): (losses, gradients of each step, parameters after)."""
    from mxnet_tpu_torch import optimizer, parallel
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.interop import params_to_numpy
    from mxnet_tpu_torch.models import GPTModel
    cfg = gpt2_train_config(dtype, dropout)
    net = GPTModel(cfg, device=device).init_weights(args.seed)
    ids, labels = train_batch(args, cfg.vocab_size, B, T)
    step = parallel.TrainStep(net, SoftmaxCrossEntropyLoss(),
                              optimizer.SGD(learning_rate=SGD_LR, momentum=0.9),
                              example_inputs=[ids])
    losses, grads = [], []
    for _ in range(steps):
        losses.append(step(ids, labels).float().item())
        grads.append(named_grads(torch, net))   # a step leaves its gradients set
    return losses, grads, params_to_numpy(net)


def mask_bits_card_vs_cpu(torch, card, B, T, D):
    """Keep masks drawn on the card and on the CPU: one GPT-2 site at
    [B, T, D] under step 1's key of site 3 (a device key and a host key),
    and ``_keep_bits_at`` over
    positions just past 2**31 and below 2**32 with and without a random
    high word. Returns the count of positions compared; raises on one
    differing bit."""
    from mxnet_tpu_torch import _prng
    from mxnet_tpu_torch import numpy_extension as npx
    key = _prng.fold_in(_prng.key(1), 3)
    want = npx._cheap_keep_mask(key, (B, T, D), 0.9)
    # the key on the card, and the host key's words as kernel scalars (TrainStep's)
    for k in (key.to(card), key):
        got = npx._cheap_keep_mask(k, (B, T, D), 0.9, device=card).cpu()
        check(torch.equal(got, want), f"site keep masks differ between {card} "
              f"(key on {k.device}) and the CPU")
    n = want.numel()
    g = torch.Generator().manual_seed(5)
    for lo in (2 ** 31, 2 ** 32 - 2 ** 20):
        idx = lo + torch.arange(2 ** 20, dtype=torch.int64)
        hi = torch.randint(0, 2 ** 32, idx.shape, generator=g, dtype=torch.int64)
        for h in (None, hi):
            got = npx._keep_bits_at(key.to(card), idx.to(card), 0.9,
                                    None if h is None else h.to(card)).cpu()
            check(torch.equal(got, npx._keep_bits_at(key, idx, 0.9, h)),
                  f"keep bits at {lo}+ (high word: {h is not None}) differ on {card}")
            n += idx.numel()
    return n


def shifted_stream(_prng):
    """A planted fault: ``KeySupply`` handing site k the key of site k + 1."""
    def next_key(self):
        k = _prng.fold_in(self.base_key, self.counter + 1)
        self.counter += 1
        return k
    return next_key


def train_card_vs_cpu(torch, args, dropout, card="cuda"):
    """f32 GPT-2 small at B 2 and ``dropout``: 2 TrainSteps with SGD
    (momentum 0.9) on the card (kernels) and on the CPU (plain versions)
    from the same weights, batch and step keys, compared on losses, each
    step's gradients leaf by leaf and the parameters after; a K2 whose
    outputs are 1% too large must fail the gradient check, and at dropout
    above 0 so must a key stream that hands site k the key of site k + 1,
    and the keep masks of one site (and at positions past 2**31) must be
    the same bits on both. Then the bf16 and f32 models' step-1 gradients
    on the card, leaf by leaf. Prints the readings, then checks them."""
    from mxnet_tpu_torch import _prng, _random
    from mxnet_tpu_torch.ops import attention as fa
    B, T, steps = 2, TRAIN_T, 2
    out, runs = {"dropout": dropout}, {}
    for dev in (card, "cpu"):
        t0 = time.perf_counter()
        runs[dev] = sgd_steps(torch, args, dev, torch.float32, steps, B, T, dropout)
        out[f"{dev}_s"] = time.perf_counter() - t0
    (lc, gc, pc), (lh, gh, ph) = runs[card], runs["cpu"]
    grad_errs = [worst(leaf_errors(a, b)) for a, b in zip(gc, gh)]
    pdiff = max(float(abs(pc[n] - ph[n]).max()) for n in ph)

    real = fa.flash_backward

    def too_large(*a):
        return tuple(t * 1.01 for t in real(*a))
    fa.flash_backward = too_large
    try:
        _, (fault,), _ = sgd_steps(torch, args, card, torch.float32, 1, B, T, dropout)
    finally:
        fa.flash_backward = real
    fault_err = worst(leaf_errors(fault, gh[0]))
    stream_err = None
    if dropout > 0:
        real_next = _random.KeySupply.next
        _random.KeySupply.next = shifted_stream(_prng)
        try:
            (ls,), (shifted,), _ = sgd_steps(torch, args, card, torch.float32, 1, B, T, dropout)
        finally:
            _random.KeySupply.next = real_next
        stream_err = worst(leaf_errors(shifted, gh[0]))
        out.update({"planted_shifted_stream_grad_rel_l2": stream_err,
                    "planted_shifted_stream_loss": ls,
                    "mask_positions_equal": mask_bits_card_vs_cpu(torch, card, TRAIN_B, T, 768)})

    (l16,), (g16,), _ = sgd_steps(torch, args, card, torch.bfloat16, 1, B, T, dropout)
    bf16_err = leaf_errors(g16, gc[0])
    out.update({"B": B, "T": T, "steps": steps, "optimizer": "sgd", "lr": SGD_LR,
                "momentum": 0.9, "losses": {card: lc, "cpu": lh},
                "grad_rel_l2_worst_leaf": grad_errs, "grad_tol": CARD_CPU_GRAD_TOL,
                "max_param_diff": pdiff, "param_tol": CARD_CPU_PARAM_TOL,
                "planted_k2_1pct_grad_rel_l2": fault_err,
                "step1_loss_by_dtype": {"float32": lc[0], "bfloat16": l16},
                "bf16_vs_f32_grad_rel_l2": worst(bf16_err), "bf16_grad_tol": BF16_GRAD_TOL,
                "bf16_vs_f32_grad_rel_l2_median": statistics.median(bf16_err.values())})
    emit({"train_card_vs_cpu": out})
    for a, b in zip(lc, lh):
        check(abs(a - b) <= 1e-4 * abs(b), f"card/CPU f32 losses {lc} {lh}")
    for i, e in enumerate(grad_errs):
        check(e["rel_l2"] <= CARD_CPU_GRAD_TOL,
              f"card/CPU f32 step-{i + 1} gradients differ: {e} > {CARD_CPU_GRAD_TOL}")
    check(pdiff <= CARD_CPU_PARAM_TOL,
          f"card/CPU parameters after {steps} steps differ by {pdiff} > {CARD_CPU_PARAM_TOL}")
    check(fault_err["rel_l2"] > CARD_CPU_GRAD_TOL,
          f"a K2 with outputs 1% too large passes the card/CPU gradient check: {fault_err}")
    check(stream_err is None or stream_err["rel_l2"] > CARD_CPU_GRAD_TOL,
          f"a key stream shifted by one site passes the card/CPU gradient check: {stream_err}")
    check(abs(l16 - lc[0]) <= 2e-2 * abs(lc[0]), f"bf16/f32 step-1 losses {l16} {lc[0]}")
    check(max(bf16_err.values()) <= BF16_GRAD_TOL,
          f"bf16/f32 step-1 gradients differ: {worst(bf16_err)} > {BF16_GRAD_TOL}")


def timed_writes(mgr):
    """Wrap ``mgr``'s file writer (the background thread's work) to record
    each write's seconds in the returned list."""
    real, secs = mgr._write_snapshot, []

    def write(*a, **k):
        t0 = time.perf_counter()
        try:
            return real(*a, **k)
        finally:
            secs.append(time.perf_counter() - t0)
    mgr._write_snapshot = write
    return secs


def dir_bytes(path):
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def resume_run(torch, mgr, run, snapshot, steps=2):
    """Save asynchronously, run ``steps`` steps, restore, run them again:
    (readings, first losses, second losses, state before, state after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = mgr.save(0)
    stall = time.perf_counter() - t0
    first = [run() for _ in range(steps)]
    before = snapshot()
    t0 = time.perf_counter()
    mgr.restore()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    second = [run() for _ in range(steps)]
    torch.cuda.synchronize()
    return ({"stall_s": stall, "restore_s": restore_s, "bytes": None, "path": path},
            first, second, before, snapshot())


def checkpoint_resume(torch, args, device="cuda"):
    """Checkpoint resume on the card, bf16 GPT-2 small at the default
    dropout, B 16, T 1024, Adam: ``TrainStep`` runs 2 steps, saves
    asynchronously in the sharded layout (``state_arrays``, the step count
    in ``extra_state``), runs 2 more, restores and runs those 2 again; then
    the eager ``Trainer`` path (masks from the global key, restored from the
    manifest) through the local layout. Losses, parameters and optimizer
    states must be the same bits; prints the checkpoint bytes, the stall
    of the training thread in ``save``, the background write's seconds and
    the restore's."""
    import shutil
    from mxnet_tpu_torch import _build, optimizer, parallel, random
    from mxnet_tpu_torch.checkpoint import CheckpointManager
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import GPTModel
    root = _build.BUILD_DIR.parent / "checkpoint_resume"
    shutil.rmtree(root, ignore_errors=True)
    cfg = gpt2_train_config(torch.bfloat16, DEFAULT_DROPOUT)
    B, T = TRAIN_B, TRAIN_T
    ids, labels = train_batch(args, cfg.vocab_size, B, T)
    ids, labels = torch.from_numpy(ids).to(device), torch.from_numpy(labels).to(device)
    ce = SoftmaxCrossEntropyLoss()
    out = {}

    net = GPTModel(cfg, device=device).init_weights(args.seed)
    step = parallel.TrainStep(net, ce, optimizer.Adam(learning_rate=TRAIN_LR),
                              example_inputs=[ids])
    mgr = CheckpointManager(str(root / "sharded"), net=net, sharded=True, blocking=False,
                            state_arrays=step.state_arrays,
                            write_state_arrays=step.write_state_arrays,
                            extra_state=lambda: {"step": step._step},
                            restore_extra=lambda e: setattr(step, "_step", e["step"]))
    writes = timed_writes(mgr)
    for _ in range(2):
        step(ids, labels)

    def step_state():
        return ([p.detach().clone() for p in net.parameters()],
                [t.clone() for t in step.state_arrays().values()])
    read, first, second, before, after = resume_run(
        torch, mgr, lambda: step(ids, labels), step_state)
    read.update(bytes=dir_bytes(root / "sharded"), write_s=writes, step=step._step)
    out["train_step_sharded"] = (read, first, second, before, after)
    del net, step, mgr, before, after
    torch.cuda.empty_cache()

    net = GPTModel(cfg, device=device).init_weights(args.seed).train()
    trainer = Trainer(dict(net.named_parameters()), "adam", {"learning_rate": TRAIN_LR})
    mgr = CheckpointManager(str(root / "local"), net=net, trainer=trainer, blocking=False)
    writes = timed_writes(mgr)
    random.seed(args.seed)

    def eager():
        loss = ce(net(ids), labels)
        loss.backward(torch.ones_like(loss))
        trainer.step(B)
        return loss.detach().mean()

    def trainer_state():
        return ([p.detach().clone() for p in net.parameters()],
                [t.clone() for i in sorted(trainer._states) for t in trainer._states[i]])
    for _ in range(2):
        eager()
    read, first, second, before, after = resume_run(torch, mgr, eager, trainer_state)
    read.update(bytes=dir_bytes(root / "local"), write_s=writes)
    out["trainer_local"] = (read, first, second, before, after)
    del net, trainer, mgr

    report = {}
    for name, (read, first, second, before, after) in out.items():
        same = (all(torch.equal(a, b) for a, b in zip(first, second)),
                all(torch.equal(a, b) for a, b in zip(before[0], after[0])),
                all(torch.equal(a, b) for a, b in zip(before[1], after[1])))
        report[name] = {**read, "losses": [float(x) for x in first],
                        "losses_again": [float(x) for x in second],
                        "same_bits": {"losses": same[0], "parameters": same[1],
                                      "optimizer_states": same[2]},
                        "state_tensors": len(before[1])}
    emit({"checkpoint_resume": {"model": "gpt2-small", "dtype": "bfloat16", "B": B, "T": T,
                                "dropout": DEFAULT_DROPOUT, **report}})
    shutil.rmtree(root, ignore_errors=True)
    for name, r in report.items():
        check(all(r["same_bits"].values()),
              f"{name}: resume is not the same bits as the run: {r['same_bits']}")
        check(r["write_s"] and r["bytes"] > 0, f"{name}: no checkpoint was written")


GLUON_B, GLUON_STEPS, GLUON_LR = 128, 20, 1e-3
GLUON_CPU_TOL = 1e-5          # README losses, card against the CPU port (relative)
ATTN_B, ATTN_T, ATTN_D, ATTN_HEADS = 4, 1024, 768, 12
ATTN_CPU_TOL = 1e-4           # f32 gradients at B 1, card against the CPU port (rel L2)


def host_ms(torch, fn, device, iters=10):
    """Mean ms of ``fn()`` on the host clock around synchronised work."""
    fn()
    sync(torch, device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync(torch, device)
    return (time.perf_counter() - t0) / iters * 1e3


def readme_train(torch, args, device, hybridize, follow=None):
    """The README's first program at its own widths on ``device``. With
    ``follow`` (another run's ``snaps``) each step first loads that run's
    weights, so each loss is computed from the same weights. Returns
    {losses, snaps (the weights before each step), params, first_s, ms
    (per later step), net, x}."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import Trainer, nn
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    rng = np.random.RandomState(args.seed)
    X = rng.rand(GLUON_B, 784).astype("float32")
    Y = rng.randint(0, 10, GLUON_B).astype("int32")
    with mx.Device(torch.device(device)):
        mx.random.seed(args.seed)
        net = nn.HybridSequential()
        net.add(nn.Dense(128, activation="relu"), nn.Dense(10))
        net.initialize(mx.init.Xavier())
        if hybridize:
            net.hybridize(static_alloc=True)
        trainer = Trainer(net.collect_params(), "adam", {"learning_rate": GLUON_LR})
        loss_fn = SoftmaxCrossEntropyLoss()
        x, y = mx.np.array(X), mx.np.array(Y)
        losses, marks, snaps = [], [], []
        sync(torch, device)
        t0 = time.perf_counter()
        for i in range(GLUON_STEPS):
            if follow is not None:
                net.load_dict(follow[i])
            with autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            snaps.append({k: p.data().copy() for k, p in net.collect_params().items()})
            trainer.step(GLUON_B)
            losses.append(loss)
            sync(torch, device)
            marks.append(time.perf_counter())
        return {"losses": [l.asnumpy() for l in losses],
                "snaps": [{k: v.asnumpy() for k, v in snap.items()} for snap in snaps],
                "params": {k: p.data().asnumpy() for k, p in net.collect_params().items()},
                "first_s": marks[0] - t0,
                "ms": (marks[-1] - marks[0]) / (GLUON_STEPS - 1) * 1e3, "net": net, "x": x}


def attention_block(plain):
    """A user HybridBlock at GPT-2 small's width: LayerNorm, Dense 3 x D,
    causal attention over ATTN_HEADS heads, Dense D, residual. With
    ``plain`` the attention is the plain version, called directly."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import HybridBlock, nn
    from mxnet_tpu_torch.ndarray import apply
    from mxnet_tpu_torch.ops import attention as fa

    class AttentionBlock(HybridBlock):
        def __init__(self):
            super().__init__()
            self.ln = nn.LayerNorm(in_channels=ATTN_D)
            self.qkv = nn.Dense(3 * ATTN_D, flatten=False, in_units=ATTN_D)
            self.proj = nn.Dense(ATTN_D, flatten=False, in_units=ATTN_D)

        def forward(self, x):
            B, T, D = x.shape
            hd = D // ATTN_HEADS
            qkv = self.qkv(self.ln(x)).reshape(B, T, 3, ATTN_HEADS, hd).transpose(2, 0, 3, 1, 4)
            q, k, v = qkv[0], qkv[1], qkv[2]
            if plain:
                o = apply(lambda a, b, c: fa._reference_flash_forward(
                    a.float(), b.float(), c.float(), True, hd ** -0.5)[0].to(a.dtype), q, k, v)
            else:
                o = mx.ops.attention(q, k, v, causal=True)
            return x + self.proj(o.transpose(0, 2, 1, 3).reshape(B, T, D))

    return AttentionBlock()


def attention_step(torch, args, device, dtype, B, plain=False):
    """One recorded forward and backward of the attention block: returns
    ({leaf: f32 CPU gradient}, launches, ms, (forward + backward callable))."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.ops.int8_gemv import launches, reset_launches
    rng = np.random.RandomState(args.seed + 1)
    X = rng.randn(B, ATTN_T, ATTN_D).astype("float32")
    DY = rng.randn(B, ATTN_T, ATTN_D).astype("float32")
    with mx.Device(torch.device(device)):
        mx.random.seed(args.seed)
        net = attention_block(plain)
        net.initialize(mx.init.Xavier())
        if dtype == "bfloat16":
            net.cast("bfloat16")
        net.hybridize(static_alloc=True)
        x = mx.np.array(X).astype(dtype)
        dy = mx.np.array(DY).astype(dtype)

        def step():
            x.attach_grad()
            with autograd.record():
                loss = (net(x) * dy).astype("float32").sum()
            loss.backward()

        sync(torch, device)
        reset_launches()
        t0 = time.perf_counter()
        step()
        sync(torch, device)
        ms = (time.perf_counter() - t0) * 1e3
        counts = launches()
        grads = {n: p.grad()._data.detach().float().cpu()
                 for n, p in net.collect_params().items()}
        grads["x"] = x.grad._data.detach().float().cpu()
    return grads, counts, ms, step


def gluon_substrate(torch, args, device="cuda"):
    """Phase 8 (module docstring). ``device='cpu'`` rehearses it with the
    CPU as both sides."""
    import numpy as np
    from mxnet_tpu_torch import metrics
    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    # (a) the README program
    eager = readme_train(torch, args, device, False)
    hyb = readme_train(torch, args, device, True)
    e_loss, e_net, h_net, x = eager["losses"], eager["net"], hyb["net"], eager["x"]
    check(all(np.array_equal(a, b) for a, b in zip(e_loss, hyb["losses"]))
          and all(np.array_equal(eager["params"][k], hyb["params"][k]) for k in hyb["params"]),
          "README program: hybridized losses or parameters differ from eager")

    def rel_err(losses):
        return [float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(e_loss, losses)]
    # each CPU step from the card's weights before that step; the free run
    # drifts (Adam's first steps move a weight by lr x sign(g), so a
    # gradient near 0 whose sign the card and the CPU round apart moves it
    # by 2 lr), and is recorded
    rel = max(rel_err(readme_train(torch, args, "cpu", False, follow=eager["snaps"])["losses"]))
    check(rel <= GLUON_CPU_TOL, f"README program: card losses {rel} from the CPU port's")
    free = rel_err(readme_train(torch, args, "cpu", False)["losses"])
    check(e_loss[-1].mean() < e_loss[0].mean(), "README program: the loss did not fall")
    op = h_net._cached_op
    want = e_net(x).asnumpy()
    h_net(x)
    h_net(x)                           # eager warm-up, then capture
    was = metrics.enabled()
    metrics.enable()
    try:
        def counters():
            lab = {"block": "HybridSequential"}
            return (sum(metrics.get_sample_value("mxnet_recompilations_total",
                                                 dict(lab, kind=k)) or 0
                        for k in ("initial", "retrace")),
                    metrics.get_sample_value("mxnet_cachedop_cache_hits_total", lab) or 0)
        before, entries, replays = counters(), op.cache_size, op.replays
        got = h_net(x).asnumpy()
        after = counters()
    finally:
        (metrics.enable if was else metrics.disable)()
    check(after[0] == before[0] and after[1] == before[1] + 1 and op.cache_size == entries,
          f"predict after warm-up: recompilations/cache hits {before} -> {after}")
    check(op.replays == replays + (1 if on_card else 0),
          f"predict after warm-up replayed {op.replays - replays} graphs")
    check(np.array_equal(got, want), "predict replay differs from the eager forward")
    predict = {"eager_ms": host_ms(torch, lambda: e_net(x), device),
               "replay_ms": host_ms(torch, lambda: h_net(x), device)}
    # (b) the attention block
    rows = {}
    for dtype in ("float32", "bfloat16"):
        got, counts, ms, step = attention_step(torch, args, device, dtype, ATTN_B)
        want = attention_step(torch, args, device, dtype, ATTN_B, plain=True)[0]
        for kind in ("flash_fwd", "flash_bwd"):
            check(counts.get(kind, 0) > 0, f"attention block {dtype}: {kind} never launched "
                  "from the tape")
        errs = {n: flash_errors(got[n], want[n]) for n in want}
        gated = [n for n in want if dtype == "float32" or n != "x"]
        bad = [n for n in gated if not flash_within(got[n], want[n], dtype)]
        check(not bad, f"attention block {dtype}: gradients past K1/K2's gates: "
              f"{ {n: errs[n] for n in bad} }")
        prof = train_profile(torch, lambda *_: step(), None, None, device) if on_card else None
        share = None if prof is None else \
            (prof["kernel_ms"].get("flash_fwd", 0) + prof["kernel_ms"].get("flash_bwd", 0)) \
            / prof["device_busy_ms"]
        rows[dtype] = {"launches": {k: counts.get(k, 0) for k in ("flash_fwd", "flash_bwd")},
                       "first_fwd_bwd_ms": ms,
                       "fwd_bwd_ms": host_ms(torch, step, device, iters=3),
                       "k1_k2_device_share": share if share is not None else "not measured",
                       "worst_row_err": max(errs[n][2] for n in gated),
                       "input_grad_row_err": errs["x"][2]}
    card1 = attention_step(torch, args, device, "float32", 1)[0]
    cpu1 = attention_step(torch, args, "cpu", "float32", 1)[0]
    errs = leaf_errors(card1, cpu1)
    check(max(errs.values()) <= ATTN_CPU_TOL,
          f"attention block: f32 gradients at B 1 {worst(errs)} from the CPU port's")
    out = {"readme": {"B": GLUON_B, "steps": GLUON_STEPS, "losses_first_last":
                      [float(e_loss[0].mean()), float(e_loss[-1].mean())],
                      "card_vs_cpu_rel": rel, "free_running_cpu_rel_by_step": free,
                      "eager_ms_per_step": eager["ms"], "hybridized_ms_per_step": hyb["ms"],
                      "eager_first_step_s": eager["first_s"],
                      "hybridized_first_step_s": hyb["first_s"], "predict": predict},
           "attention_block": {"B": ATTN_B, "T": ATTN_T, "D": ATTN_D, "heads": ATTN_HEADS,
                               **rows, "card_vs_cpu_B1": worst(errs)},
           "phase_s": time.perf_counter() - t_phase}
    emit({"gluon_substrate": out})
    return {k: sum(r["launches"][k] for r in rows.values()) for k in ("flash_fwd", "flash_bwd")}


LLAMA_VOCAB, LLAMA_D = 128256, 4096
# a vocab that is not a multiple of 128: K8's pad lanes at Llama's width
ODD_VOCAB = 128003


def tied_head(torch, gen, vocab, D, bits):
    """The quantized tied head ``quantize_net`` derives from an N(0, 0.02)
    bf16 embedding [vocab, D]: (table, scales, vocab), padded to
    ``pad_vocab(vocab)`` rows."""
    from types import SimpleNamespace

    from mxnet_tpu_torch.contrib.quantization import _quantize_tied_lm_head
    emb = (torch.randn(vocab, D, device="cuda", generator=gen) * 0.02).bfloat16()
    holder = SimpleNamespace(wte=SimpleNamespace(weight=emb))
    _quantize_tied_lm_head(holder, bits)
    return holder._q_lm_head


def kernel_llama_widths(torch, timer, gen):
    """The kernels of the Llama serving path at Llama-3-8B's widths against
    their plain versions: K3 and K4 at every (N, K) of LLAMA_GEMV_SHAPES,
    at 1 and 8 rows (warp route) and 9 and 64 (tile route), with bf16 x
    (block inputs of an unquantized-width layer 0) and f32 x (every later
    input of a quantized model: its layers' outputs are f32); K8 over the
    128256 x 4096 tied head in both codecs, its mask and bf16 lanes, and
    over a vocab of ODD_VOCAB (pad lanes); K1 at B 1, 32 heads of 128, T
    1024, causal bf16 (the cache-free forward's shape, K/V repeated from 8
    heads). Returns {"K3"|"K4": {"bf16"|"f32": kernel_gemv's result},
    "K8": {"int8"|"int4": {"main", "lanes"}, "odd_vocab"}, "K1": row}."""
    out = {}
    for name, bits in (("K3", 8), ("K4", 4)):
        out[name] = {
            lane: kernel_gemv(torch, timer, gen, bits, bf16=lane == "bf16",
                              shapes=LLAMA_GEMV_SHAPES, m_rows=LLAMA_GEMV_ROWS,
                              layer=LLAMA_LAYER, tag="_llama")
            for lane in ("bf16", "f32")}
        torch.cuda.empty_cache()
    out["K8"] = {}
    for codec, bits in (("int8", 8), ("int4", 4)):
        head = tied_head(torch, gen, LLAMA_VOCAB, LLAMA_D, bits)
        out["K8"][codec] = {"main": kernel_k8(torch, timer, gen, head),
                            "lanes": kernel_k8_lanes(torch, timer, gen, head)}
        del head
    odd = tied_head(torch, gen, ODD_VOCAB, LLAMA_D, 8)
    check(odd[0].shape[0] % 128 == 0 and odd[0].shape[0] > ODD_VOCAB,
          f"vocab {ODD_VOCAB}: the head table has {odd[0].shape[0]} rows, no pad lanes")
    out["K8"]["odd_vocab"] = kernel_k8(torch, timer, gen, odd)
    del odd
    torch.cuda.empty_cache()
    out["K1"] = flash_case(torch, timer, gen, 1, 32, 1024, 1024, 128, True, torch.bfloat16,
                           timed=True)
    emit({"llama_width_kernels": {
        "K3": {lane: {k: r[k] for k in ("warp", "mma", "head")} for lane, r in out["K3"].items()},
        "K4": {lane: {k: r[k] for k in ("warp", "mma", "head")} for lane, r in out["K4"].items()},
        "K8": out["K8"], "K1": out["K1"]}})
    return out


# ---------------------------------------------------------------------------
# Phase 9, llama_serve: Llama-3-8B served by the port on the card
# ---------------------------------------------------------------------------
LLAMA_S, LLAMA_L = 8, 1024        # engine slots and max_len
LLAMA_REQUESTS, LLAMA_NEW = 16, 64
LLAMA_SHORT = 4                   # requests with 64-token prompts, the rest 65-512
LLAMA_CHUNK = 64                  # paged prefill chunk: a 64-token prompt is one chunk,
#                                   the contiguous engine's one prefill of 64 rows
LLAMA_T = 1024                    # (a) the cache-free forward at B 1
# (a) K1 against its plain version over the same bf16 model, by the
# relative L2 distance of the logits: at most LLAMA_K1_SPREAD times the
# distance between that plain version (which rounds p to bf16 before p v,
# as K1 does) and the same attention with p kept in f32. Each layer
# rounds its attention output to bf16, and 32 layers carry one element's
# other rounding into every later one, so that floor is a few percent of
# the logits, set by the model rather than the kernel; K1 is held to
# 1e-2 per element at this shape by kernel_llama_widths.
LLAMA_K1_SPREAD = 2.0
LLAMA_SMALL_LAYERS = 2            # the 2-layer variants of (c)-(f)
# (c) CPU twin: prompts, prompt tokens, new tokens; the 4 x 16 prefill rows
# stay on the GEMV path (past 64 rows each device takes the per-tensor int8
# activation scale from its own input, and a token check would hold two
# quantizations to each other: LLAMA_WIDE holds those products on a
# shared input)
LLAMA_TWIN = (4, 16, 12)
# (c) the same twin's activation-quantized products past 64 rows: a
# cache-free forward of [prompts, tokens] (128 rows through every layer)
LLAMA_WIDE = (4, 32)
LLAMA_SMALL = (8, 48, 32)         # (d)-(f): prompts, longest prompt, new tokens


def llama_config(torch, layers=None, **kw):
    import dataclasses

    from mxnet_tpu_torch.models import LLAMA3_8B
    return dataclasses.replace(LLAMA3_8B, num_layers=layers or LLAMA3_8B.num_layers, **kw)


def copy_llama(torch, src, dst):
    """Copy every parameter of ``dst`` from the parameter of ``src`` with
    the same name (a shallower ``dst`` takes ``src``'s first layers)."""
    have = dict(src.named_parameters())
    with torch.no_grad():
        for name, p in dst.named_parameters():
            p.copy_(have[name])
    return dst


# the stacked decoder's [layers, ...] parameters and the per-layer
# decoder's parameter each stacks
STACKED_PARTS = {"ln1": "input_layernorm.gamma", "ln2": "post_attention_layernorm.gamma",
                 "wq": "self_attn.q_proj.weight", "wk": "self_attn.k_proj.weight",
                 "wv": "self_attn.v_proj.weight", "wo": "self_attn.o_proj.weight",
                 "wg": "mlp.gate_proj.weight", "wu": "mlp.up_proj.weight",
                 "wd": "mlp.down_proj.weight"}


def stack_llama(torch, net):
    """The stacked decoder of ``net``'s config holding its weights."""
    import dataclasses

    from mxnet_tpu_torch.models import LlamaForCausalLM
    out = LlamaForCausalLM(dataclasses.replace(net.cfg, stacked=True), device=net.device)
    layers = list(net.model.layers)
    with torch.no_grad():
        for name, path in STACKED_PARTS.items():
            getattr(out.model.layers, name).copy_(torch.stack(
                [dict(layer.named_parameters())[path] for layer in layers]))
        out.model.embed_tokens.weight.copy_(net.model.embed_tokens.weight)
        out.model.norm.gamma.copy_(net.model.norm.gamma)
        if net.lm_head is not None:
            out.lm_head.weight.copy_(net.lm_head.weight)
    return out


def serve_all(eng, prompts, new):
    """Every prompt greedy through ``eng`` at once; the generated ids."""
    handles = [eng.submit(p, new) for p in prompts]
    out = []
    for i, h in enumerate(handles):
        r = h.result(timeout=900)
        check(r.ok and len(r.generated_ids) == new,
              f"request {i}: {r.status} {len(r.generated_ids)} tokens {r.error}")
        out.append(r.generated_ids)
    return out


def hold_greedy(torch, ref, prompts, got, want, what):
    """The card's rule for two greedy runs: each row's tokens equal, or a
    first divergence where ``ref``'s top-2 gap after the common tokens is
    below ``gap_limit``. Returns the rows."""
    rows = []
    for i, (p, a, b) in enumerate(zip(prompts, got, want)):
        d = first_divergence(a, b)
        row = {"request": i, "prompt": len(p), "equal": d is None, "first_divergence": d}
        if d is not None:
            row["top2_gap"], top = top2_gap(torch, ref, list(p) + list(b[:d]))
            row["gap_limit"] = gap_limit(torch, ref, top)
            check(row["top2_gap"] < row["gap_limit"],
                  f"{what}: request {i} diverges at {d} with top-2 gap {row['top2_gap']}")
        rows.append(row)
    return rows


def llama_prompts(args, n, lo, hi, vocab, salt):
    import numpy as np
    rng = np.random.RandomState(args.seed + salt)
    return [rng.randint(0, vocab, int(rng.randint(lo, hi + 1))).tolist() for _ in range(n)]


def llama_k1_forward(torch, args, net, k1_row):
    """(a) The cache-free forward of the bf16 model at B 1, T LLAMA_T: K1
    launches once a layer at head dim 128 (32 heads after the GQA repeat);
    its logits against the same forward with K1's plain version on the
    card, relative L2 within LLAMA_K1_SPREAD times the distance between
    that forward and one whose plain attention keeps p in f32. Returns the
    phase's numbers."""
    import numpy as np

    from mxnet_tpu_torch.models import llama as llama_mod
    from mxnet_tpu_torch.ops import attention as fa
    from mxnet_tpu_torch.ops.int8_gemv import launches, reset_launches
    cfg = net.cfg
    ids = torch.from_numpy(np.random.RandomState(args.seed + 40).randint(
        0, cfg.vocab_size, (1, LLAMA_T)).astype(np.int32)).cuda()

    def plain(q, k, v, causal, scale):
        s = scale if scale is not None else q.shape[-1] ** -0.5
        return fa._reference_flash_forward(q, k, v, causal, s)[0]

    def plain_f32_p(q, k, v, causal, scale):
        return plain(q.float(), k.float(), v.float(), causal, scale).to(q.dtype)

    with torch.no_grad():
        net(ids[:, :256])                                  # warm-up
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = net(ids)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_k1 = launches().get("flash_fwd", 0)
        kernel_fa = llama_mod.flash_attention
        try:
            llama_mod.flash_attention = plain
            want = net(ids)
            llama_mod.flash_attention = plain_f32_p
            other = net(ids)
        finally:
            llama_mod.flash_attention = kernel_fa
    check(n_k1 == cfg.num_layers, f"K1 launched {n_k1} times, not once a layer "
          f"({cfg.num_layers})")
    check(tuple(logits.shape) == (1, LLAMA_T, cfg.vocab_size) and logits.dtype == cfg.dtype,
          f"logits {tuple(logits.shape)} {logits.dtype}")
    a, b = logits.float(), want.float()
    check(bool(torch.isfinite(a).all()), "cache-free logits not finite")
    rel = ((a - b).norm() / b.norm()).item()
    floor = ((other.float() - b).norm() / b.norm()).item()
    out = {"B": 1, "T": LLAMA_T, "layers": cfg.num_layers, "k1_launches": n_k1,
           "wall_ms": wall * 1e3, "rel_l2_vs_plain": rel, "rel_l2_plain_vs_f32_p": floor,
           "gate": LLAMA_K1_SPREAD * floor, "max_abs_err": (a - b).abs().max().item(),
           "argmax_agreement": (a.argmax(-1) == b.argmax(-1)).float().mean().item(),
           "k1_at_this_shape": {k: k1_row[k] for k in (
               "k1_ms", "k1_plain_ms", "k1_library_ms", "k1_bound_ms", "k1_bound_by",
               "k1_max_abs_err", "library") if k in k1_row}}
    check(rel <= LLAMA_K1_SPREAD * floor,
          f"K1 forward: logits {rel} from its plain version's (relative L2) > "
          f"{LLAMA_K1_SPREAD} x {floor}, the plain version's distance with p in f32")
    return out


def catch_quantized(torch, model):
    """Forward hooks on every QuantizedDense of ``model``, each keeping its
    last (input, output) under the module's name. Returns (that dict, the
    hook handles)."""
    from mxnet_tpu_torch.contrib.quantization import QuantizedDense
    seen = {}

    def keep(name):
        def hook(mod, inp, out):
            seen[name] = (inp[0].detach(), out.detach())
        return hook
    hooks = [m.register_forward_hook(keep(name)) for name, m in model.named_modules()
             if isinstance(m, QuantizedDense)]
    return seen, hooks


def llama_wide_products(torch, args, card, cpu):
    """(c) past ``gemv_max_m()`` rows: the cache-free forward of LLAMA_WIDE
    ids on the card and on the CPU twin catches every QuantizedDense's input
    and output (14 layers' products and the 128256-wide head, 128 rows
    each: the activation-quantized int8 x int8 product). Gates, per layer:
    the per-tensor activation scale the card takes from its input is within
    one ulp of x's dtype of the scale the CPU takes from the same input
    (the card may divide by 127 as a multiply by its reciprocal), and the
    card's output is, bit for bit, the CPU layer's on that input at the
    card's scale (an exact integer product). Beside them, not gated, the
    witness of how the two devices part without a shared input: per layer
    the CPU twin's own input against the card's (max abs difference), the
    two scales, and the share of int8 inputs that differ; and per prompt
    the top-2 gap and agreement of the last row's logits."""
    import numpy as np

    from mxnet_tpu_torch.ops.int8_gemv import gemv_max_m
    n, t = LLAMA_WIDE
    ids = torch.from_numpy(np.random.RandomState(args.seed + 47).randint(
        0, card.cfg.vocab_size, (n, t)).astype(np.int32))
    with torch.no_grad():
        seen_card, hooks = catch_quantized(torch, card)
        logits_card = card(ids.cuda())[:, -1].float().cpu()
        seen_cpu, hooks_cpu = catch_quantized(torch, cpu)
        logits_cpu = cpu(ids)[:, -1].float()
        for h in hooks + hooks_cpu:
            h.remove()
        card_mods, cpu_mods = dict(card.named_modules()), dict(cpu.named_modules())

        def q(v, scale):
            return torch.clamp(torch.round(v.float() / scale), -127, 127)
        layers = []
        for name, (x, y) in seen_card.items():
            rows = x.numel() // x.shape[-1]
            check(rows > gemv_max_m(), f"{name}: {rows} rows, not past {gemv_max_m()}")
            xc = x.cpu()
            s_card = card_mods[name]._input_qscale(x).item()
            s_cpu = cpu_mods[name]._input_qscale(xc).item()
            ulp = torch.finfo(x.dtype).eps * s_cpu
            mod = cpu_mods[name]
            try:
                mod._act_scale = s_card
                want = mod(xc)
            finally:
                mod._act_scale = None
            got = y.cpu()
            own = seen_cpu[name][0]
            layers.append({
                "layer": name, "rows": rows, "N": y.shape[-1], "K": x.shape[-1],
                "x_dtype": str(x.dtype).replace("torch.", ""),
                "scale_card": s_card, "scale_cpu": s_cpu,
                "scale_ulps": abs(s_card - s_cpu) / ulp,
                "equal_at_card_scale": bool(torch.equal(got, want)),
                "max_abs_err": (got - want).abs().max().item(),
                "witness_max_abs_x": (own.float() - xc.float()).abs().max().item(),
                "witness_scale_cpu_own": mod._input_qscale(own).item(),
                "witness_xq_differ": (q(own, mod._input_qscale(own))
                                      != q(xc, s_card)).float().mean().item()})
            check(abs(s_card - s_cpu) <= ulp,
                  f"{name}: activation scale {s_card} on the card, {s_cpu} on the CPU")
            check(layers[-1]["equal_at_card_scale"],
                  f"{name}: {rows} rows: the card's product is not the CPU's at the card's "
                  f"scale (max abs {layers[-1]['max_abs_err']})")
    check(len(layers) == 7 * LLAMA_SMALL_LAYERS + 1,
          f"caught {len(layers)} quantized layers: {[r['layer'] for r in layers]}")
    top = torch.topk(logits_cpu, 2).values
    return {"prompts": n, "tokens": t, "layers": layers,
            "witness_top1_equal": (logits_card.argmax(-1) == logits_cpu.argmax(-1)).tolist(),
            "witness_cpu_top2_gap": (top[:, 0] - top[:, 1]).tolist(),
            "witness_logits_max_abs": (logits_card - logits_cpu).abs().max().item()}


def llama_card_vs_cpu(torch, args, net):
    """(c) A 2-layer twin at full width holding the card model's embedding,
    first layers, norm and head, int8 on the card and on the CPU (plain
    versions): greedy ``generate`` of LLAMA_TWIN prompts, held by the card's
    rule (the CPU twin's top-2 gap); then its products past 64 rows
    (llama_wide_products)."""
    import numpy as np

    from mxnet_tpu_torch.contrib.quantization import quantize_net
    from mxnet_tpu_torch.models import LlamaForCausalLM, generate
    n, plen, new = LLAMA_TWIN
    cfg = llama_config(torch, LLAMA_SMALL_LAYERS)
    card = copy_llama(torch, net, LlamaForCausalLM(cfg, device="cuda"))
    cpu = copy_llama(torch, net, LlamaForCausalLM(cfg, device="cpu"))
    quantize_net(card)
    quantize_net(cpu)
    ids = np.random.RandomState(args.seed + 41).randint(0, cfg.vocab_size, (n, plen))
    ids = torch.from_numpy(ids.astype(np.int32))
    got = generate(card, ids, new)[:, plen:].tolist()
    t0 = time.perf_counter()
    want = generate(cpu, ids, new)[:, plen:].tolist()
    cpu_s = time.perf_counter() - t0
    rows = hold_greedy(torch, cpu, ids.tolist(), got, want, "card vs CPU")
    t0 = time.perf_counter()
    wide = llama_wide_products(torch, args, card, cpu)
    wide["s"] = time.perf_counter() - t0
    return {"layers": LLAMA_SMALL_LAYERS, "prompts": n, "prompt_tokens": plen,
            "new_tokens": new, "rows": rows, "cpu_s": cpu_s, "past_64_rows": wide}


def llama_serving(torch, args, net):
    """(b) The int8 model through ``InferenceEngine(max_batch_size=8,
    max_len=1024)``, paged (the card's default) with LLAMA_CHUNK-token
    prefill chunks, after ``warmup()``: LLAMA_REQUESTS greedy requests of
    64-512-token prompts, LLAMA_NEW new tokens each. Gates: nothing captured
    after warm-up; a decode step and a prefill chunk replay their eager runs
    bit for bit; a contiguous engine gives the 64-token prompts the same
    tokens; the longer ones hold to the paged engine's arithmetic on the
    contiguous layout (``prefill_chunks``, then one-token decode steps) by
    the card's rule. Returns the launch counts and the numbers."""
    from mxnet_tpu_torch.models import generation as gen
    from mxnet_tpu_torch.ops.int8_gemv import (dtype_lanes, gemv_routes, gemv_widths,
                                               launches, reset_launches)
    from mxnet_tpu_torch.serve import InferenceEngine
    vocab = net.cfg.vocab_size
    prompts = (llama_prompts(args, LLAMA_SHORT, 64, 64, vocab, 42)
               + llama_prompts(args, LLAMA_REQUESTS - LLAMA_SHORT, 65, 512, vocab, 43))
    eng = InferenceEngine(net, max_batch_size=LLAMA_S, max_len=LLAMA_L,
                          prefill_chunk=LLAMA_CHUNK).start()
    try:
        check(eng._paged, "the card's default engine is not paged")
        warmed = warm(eng)
        before = eng.stats()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = serve_all(eng, prompts, LLAMA_NEW)
        wall = time.perf_counter() - t0
        counts = launches()
        counts.update(routes=gemv_routes(), widths=gemv_widths(), lanes=dtype_lanes())
        after = eng.stats()
        profiled = device_share(torch, eng, prompts[:LLAMA_S], LLAMA_NEW,
                                trace="llama_decode_trace.json", counted_as=GEMV_AND_HEAD)
        no_capture_since(eng, warmed, "llama paged phase")
    finally:
        eng.shutdown(drain=True, timeout=600)
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    replay = [replay_equals_eager(torch, eng, g, args.seed, sb=LLAMA_S, steps=1,
                                  branch="greedy"),
              replay_equals_eager(torch, eng, g, args.seed, pb=LLAMA_CHUNK)]
    del eng
    check(counts.get("gemv", 0) > 0 and counts["routes"]["warp"] > 0
          and counts["routes"]["mma"] > 0, f"K3 did not run on both routes: {counts}")
    contiguous = InferenceEngine(net, max_batch_size=LLAMA_S, max_len=LLAMA_L,
                                 paged=False).start()
    try:
        short = serve_all(contiguous, prompts[:LLAMA_SHORT], LLAMA_NEW)
    finally:
        contiguous.shutdown(drain=True, timeout=600)
    del contiguous
    for i in range(LLAMA_SHORT):
        check(short[i] == results[i], f"64-token prompt {i}: contiguous tokens != paged "
              f"(first divergence {first_divergence(short[i], results[i])})")
    refs = []
    with torch.no_grad():
        for p in prompts[LLAMA_SHORT:]:
            caches = net.new_caches(1, LLAMA_L)
            hidden, last = prefill_chunks(torch, net, p, LLAMA_CHUNK, caches)
            tok = int(net._lm_head(hidden[:, last]).float().argmax(-1)[0])
            out = [tok]
            while len(out) < LLAMA_NEW:
                pos = torch.full((1,), len(p) + len(out) - 1, dtype=torch.int32,
                                 device="cuda")
                ids = torch.full((1, 1), out[-1], dtype=torch.int32, device="cuda")
                logits, caches = gen.decode_step(net, ids, pos, caches)
                out.append(int(logits[0, -1].float().argmax()))
            refs.append(out)
    rows = hold_greedy(torch, net, prompts[LLAMA_SHORT:], results[LLAMA_SHORT:], refs,
                       "paged engine vs its arithmetic on the contiguous layout")
    tokens = sum(len(r) for r in results)
    dsteps = after["decode_substeps"] - before["decode_substeps"]
    dsec = after["decode_s"] - before["decode_s"]
    numbers = {"requests": len(prompts), "prompt_tokens": [len(p) for p in prompts],
               "new_tokens_each": LLAMA_NEW, "wall_s": wall, "tokens_per_s": tokens / wall,
               "decode_substeps": dsteps, "ms_per_decode_step": dsec / dsteps * 1e3,
               "prefill_chunks": after.get("prefill_chunks", 0) - before.get(
                   "prefill_chunks", 0),
               "prefill_s": after["prefill_s"] - before["prefill_s"],
               "kv_bytes": after["kv_bytes"], "warmup": warmed,
               "replay_equals_eager": replay, "contiguous_equal_64_token_prompts": LLAMA_SHORT,
               "chunked_reference": rows, "launches": counts,
               "device_share": profiled if profiled is not None else "not measured"}
    return counts, numbers


def llama_tied(torch, args, net):
    """(d) The tied head at full width, 2 layers, bf16, through engines with
    ``multi_token=4``, int8 then int4: K8 selects every decode token. The
    per-layer decoder under ``quantize_net`` hands K8 f32 hidden states (its
    quantized layers return f32, as in the JAX package); the stacked decoder,
    which ``quantize_net`` returns unchanged, tied head included (as the JAX
    package does), with only its tied head quantized by the private
    ``_quantize_tied_lm_head``, hands K8 bf16 hidden states and takes its
    bf16 lane: no public API of either package reaches that lane. Each
    engine's tokens are held against the same model's ``multi_token=1``
    engine (K3/K4 head + argmax) by the card's rule. Returns {codec:
    {decoder: counts}}."""
    from mxnet_tpu_torch.contrib.quantization import _quantize_tied_lm_head, quantize_net
    from mxnet_tpu_torch.models import LlamaForCausalLM
    from mxnet_tpu_torch.ops.int8_gemv import dtype_lanes, launches, reset_launches
    from mxnet_tpu_torch.serve import InferenceEngine
    n, hi, new = LLAMA_SMALL
    cfg = llama_config(torch, LLAMA_SMALL_LAYERS, tie_embeddings=True)
    prompts = llama_prompts(args, n, 16, hi, cfg.vocab_size, 44)
    out = {}
    for codec, bits in (("int8", 8), ("int4", 4)):
        base = copy_llama(torch, net, LlamaForCausalLM(cfg, device="cuda"))
        stacked = stack_llama(torch, base)
        _quantize_tied_lm_head(stacked, bits)
        per_layer = quantize_net(base, bits=bits)
        out[codec] = {}
        for decoder, model, lane_key in (
                ("per_layer", per_layer, "h_f32"), ("stacked", stacked, "h_bf16:bf16_logits")):
            sfx = "_int4" if bits == 4 else ""
            eng = InferenceEngine(model, max_batch_size=LLAMA_S, max_len=256,
                                  multi_token=4).start()
            try:
                warm(eng)
                reset_launches()
                got = serve_all(eng, prompts, new)
                counts = launches()
                counts["lanes"] = dtype_lanes()
            finally:
                eng.shutdown(drain=True, timeout=600)
            eng1 = InferenceEngine(model, max_batch_size=LLAMA_S, max_len=256).start()
            try:
                want = serve_all(eng1, prompts, new)
            finally:
                eng1.shutdown(drain=True, timeout=600)
            lane = counts["lanes"].get(f"fused_head{sfx}:{lane_key}", 0)
            check(lane > 0, f"tied {codec} {decoder}: K8's {lane_key} lane never launched "
                  f"from the engine ({counts['lanes']})")
            rows = hold_greedy(torch, model, prompts, got, want,
                               f"tied {codec} {decoder}: multi_token=4 vs 1")
            counts["rows"] = rows
            counts["k8_lane"] = {"key": f"fused_head{sfx}:{lane_key}", "launches": lane}
            out[codec][decoder] = counts
        del per_layer, stacked, base
        torch.cuda.empty_cache()
    return out


def llama_codec(torch, args, net, bits):
    """(e) ``quantize_net(bits=bits)`` at full width, 2 layers: ``generate``
    of 2 prompts of 32 tokens (64 prefill rows, the head's too: the tile
    route; decode: the warp route) launches K3 (int8) or K4 (int4) at every
    Llama width on both routes; its tokens are held by the card's rule
    against the same ``generate`` with the kernel's plain version in its
    place."""
    import numpy as np

    from mxnet_tpu_torch.contrib import quantization as quant
    from mxnet_tpu_torch.models import LlamaForCausalLM, generate
    from mxnet_tpu_torch.ops import int8_gemv
    kind = "gemv" if bits == 8 else "gemv_int4"
    cfg = llama_config(torch, LLAMA_SMALL_LAYERS)
    model = quant.quantize_net(copy_llama(torch, net, LlamaForCausalLM(cfg, device="cuda")),
                               bits=bits)
    ids = torch.from_numpy(np.random.RandomState(args.seed + 45).randint(
        0, cfg.vocab_size, (2, 32)).astype(np.int32))
    new = LLAMA_SMALL[2]
    int8_gemv.reset_launches()
    got = generate(model, ids, new)[:, 32:].tolist()
    counts = int8_gemv.launches()
    counts.update(routes=int8_gemv.gemv_routes(), widths=int8_gemv.gemv_widths(),
                  lanes=int8_gemv.dtype_lanes())
    kernel_wm = quant.weight_matmul
    quant.weight_matmul = int8_gemv._deq_matmul
    try:
        want = generate(model, ids, new)[:, 32:].tolist()
    finally:
        quant.weight_matmul = kernel_wm
    check(int8_gemv.launches().get(kind, 0) == counts.get(kind, 0),
          f"the plain run launched {kind}")
    for N in sorted({N for N, _ in LLAMA_GEMV_SHAPES}):
        for route in ("warp", "mma"):
            check(counts["widths"].get(f"{route}:{N}", 0) > 0,
                  f"{kind} never ran at N={N} on the {route} route ({counts['widths']})")
    counts["rows"] = hold_greedy(torch, model, ids.tolist(), got, want,
                                 f"{kind}: kernel vs plain version")
    return counts


def llama_stacked(torch, args, net):
    """(f) The stacked decoder at full width, 2 layers, unquantized bf16,
    holding the per-layer model's weights: both through the engine in both
    layouts; the stacked tokens held against the per-layer model's by the
    card's rule."""
    from mxnet_tpu_torch.models import LlamaForCausalLM
    from mxnet_tpu_torch.serve import InferenceEngine
    n, hi, new = LLAMA_SMALL
    cfg = llama_config(torch, LLAMA_SMALL_LAYERS)
    per_layer = copy_llama(torch, net, LlamaForCausalLM(cfg, device="cuda"))
    stacked = stack_llama(torch, per_layer)
    prompts = llama_prompts(args, n, 16, hi, cfg.vocab_size, 46)
    out = {}
    for paged in (False, True):
        toks = {}
        for name, model in (("per_layer", per_layer), ("stacked", stacked)):
            eng = InferenceEngine(model, max_batch_size=LLAMA_S, max_len=256,
                                  paged=paged).start()
            try:
                toks[name] = serve_all(eng, prompts, new)
            finally:
                eng.shutdown(drain=True, timeout=600)
        out["paged" if paged else "contiguous"] = hold_greedy(
            torch, per_layer, prompts, toks["stacked"], toks["per_layer"],
            f"stacked vs per-layer ({'paged' if paged else 'contiguous'})")
    return out


def llama_serve(torch, args, kernels):
    """Phase 9: Llama-3-8B (LLAMA3_8B: hidden 4096, 32 layers, 32 query and
    8 KV heads of 128, intermediate 14336, vocab 128256, untied head, bf16,
    rope theta 500000) at full width and depth, weights drawn on the card
    from ``--seed``. (a) the cache-free forward (K1); (c) a CPU twin; (b)
    int8 serving through the paged engine; (d) the tied head (K8); (e) int4
    (K4); (f) the stacked decoder. ``kernels``: kernel_llama_widths' rows
    (K1 at this phase's shape). Returns the launch counts of each part."""
    from mxnet_tpu_torch.contrib.quantization import quantize_net
    from mxnet_tpu_torch.models import LlamaForCausalLM
    t_phase = time.perf_counter()
    out, counts = {}, {}
    with torch.no_grad():
        t0 = time.perf_counter()
        net = LlamaForCausalLM(llama_config(torch), device="cuda").init_weights(args.seed)
        torch.cuda.synchronize()
        out["init_s"] = time.perf_counter() - t0
        out["params"] = sum(p.numel() for p in net.parameters())
    out["k1_forward"] = llama_k1_forward(torch, args, net, kernels["K1"])
    counts["k1"] = out["k1_forward"]["k1_launches"]
    out["card_vs_cpu"] = llama_card_vs_cpu(torch, args, net)
    counts["tied"] = llama_tied(torch, args, net)
    out["tied"] = {c: {d: {"rows": r["rows"], "k8_lane": r["k8_lane"]} for d, r in v.items()}
                   for c, v in counts["tied"].items()}
    for codec, bits in (("int8", 8), ("int4", 4)):
        counts[codec] = llama_codec(torch, args, net, bits)
        out[codec + "_generate"] = counts[codec]
    out["stacked"] = llama_stacked(torch, args, net)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with torch.no_grad():
        quantize_net(net)
    torch.cuda.synchronize()
    out["quantize_s"] = time.perf_counter() - t0
    out["weight_bytes"] = {"bf16": sum(p.numel() * p.element_size() for p in net.parameters()),
                           "int8_tables": quant_bytes(torch, net)["total"]}
    counts["serve"], out["serve"] = llama_serving(torch, args, net)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del net
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    emit({"llama_serve": out})
    return counts


# ---------------------------------------------------------------------------
# Phase 10, llama_train: Llama trains on the card through TrainStep
# ---------------------------------------------------------------------------
# (a) LLAMA3_8B cut from 32 layers to LT_LAYERS (Adam's state and the
# smoke's time), B x T tokens a step, LT_STEPS Adam steps on one batch
LT_LAYERS, LT_B, LT_T, LT_STEPS, LT_LR = 4, 2, 2048, 5, 3e-4
LT_STACKED_LAYERS = 2             # (b) the stacked decoder against the per-layer one
MIXTRAL_LAYERS = 2                # (c) Mixtral-8x7B's 32 layers cut to 2
# (d)/(e): card against CPU in f32, small, head dim 128 (K1/K2's lane at
# Llama's head dim), one MoE layer (layer 0) and one dense
LT_SMALL = dict(vocab_size=512, hidden_size=512, intermediate_size=1024, num_layers=2,
                num_heads=4, num_kv_heads=2, num_experts=4, num_experts_per_tok=2,
                moe_every=2)
LT_SMALL_T = 256
# device memory still allocated as phase 10 starts: the kernels' and earlier
# phases' small state (0.81-1.41 GB on the H100); a model left over from an
# earlier phase (Llama-3-8B's bf16 weights alone are 16 GB) exceeds it
LT_HELD_GB = 4.0
# (b) stacked against per-layer from the same bf16 weights: the step-1
# losses differed by 0 and the worst leaf's gradient by 0.0091 relative L2
# (model.embed_tokens.weight) on the H100; the losses may differ by one
# bf16 step at their value, the gradients by 3.3x the reading
LT_STACKED_GRAD_TOL = 0.03


def mixtral_config(torch, layers):
    """Mixtral-8x7B's widths (mistralai/Mixtral-8x7B-v0.1 config.json: D
    4096, F 14336, 32 query and 8 KV heads, vocab 32000, rope theta 1e6,
    RMS eps 1e-5, 8 experts, top 2, untied) at ``layers`` layers, bf16,
    with the JAX package's capacity factor 1.25 and an MoE every layer."""
    from mxnet_tpu_torch.models import LlamaConfig
    return LlamaConfig(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                       num_layers=layers, num_heads=32, num_kv_heads=8, rope_theta=1e6,
                       rms_eps=1e-5, dtype=torch.bfloat16, tie_embeddings=False,
                       num_experts=8, num_experts_per_tok=2, moe_capacity_factor=1.25,
                       moe_every=1)


def llama_train_flops(cfg, B, T):
    """Analytic FLOPs of one training step (3x the forward): 2 per
    multiply-add of every matrix (router and the k experts each token
    takes, at their capacity-free count) and the head, plus causal
    attention (q k and p v over the visible half of T x T)."""
    D, F, V, hd = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.hd
    attn_w = D * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    per_layer = []
    for i in range(cfg.num_layers):
        moe = cfg.num_experts > 0 and i % cfg.moe_every == 0
        mlp = (cfg.num_experts * D + cfg.num_experts_per_tok * 3 * D * F) if moe else 3 * D * F
        per_layer.append(2 * B * T * (attn_w + mlp) + 2 * B * cfg.num_heads * T * T * hd)
    return 3 * (sum(per_layer) + 2 * B * T * D * V)


def moe_routes(torch, net, fn):
    """Runs ``fn()`` with every MoE router's logits caught; returns fn's
    result and, per MoE layer and call, (logits, moe_route's result)."""
    from mxnet_tpu_torch.models import llama as TL
    caught, hooks = [], []
    for layer in net.model.layers:
        if isinstance(layer.mlp, TL.LlamaMoE):
            hooks.append(layer.mlp.router.register_forward_hook(
                lambda m, i, o: caught.append(o.detach().float())))
    try:
        out = fn()
    finally:
        for h in hooks:
            h.remove()
    cfg, routes = net.cfg, []
    for logits in caught:
        n = logits.numel() // cfg.num_experts
        logits = logits.reshape(n, cfg.num_experts)
        routes.append((logits, TL.moe_route(logits, cfg.num_experts_per_tok,
                                            TL.moe_capacity(cfg, n))))
    return out, routes


def train_split(torch, step, ids, labels):
    """One step under ``torch.profiler`` (device activity): device ms of K1
    and K2 and of the GEMMs (by kernel name), and, between CUDA events, of
    the loss (its forward, and its backward from the loss's gradient to the
    logits') and of the optimizer's update (``apply_updates``); ``other`` is
    the rest of the busy time."""
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.parallel import train as tr
    ev = {k: torch.cuda.Event(enable_timing=True)
          for k in ("loss0", "loss1", "back0", "back1", "opt0", "opt1")}
    real_loss, real_apply = step.loss_fn, tr.apply_updates

    def loss_fn(outs, *lab):
        ev["loss0"].record()
        out = real_loss(outs, *lab)
        ev["loss1"].record()
        out.register_hook(lambda g: ev["back0"].record())
        outs.register_hook(lambda g: ev["back1"].record())
        return out

    def apply_updates(*a, **k):
        ev["opt0"].record()
        real_apply(*a, **k)
        ev["opt1"].record()
    torch.cuda.synchronize()
    step.loss_fn, tr.apply_updates = loss_fn, apply_updates
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(ids, labels)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        step.loss_fn, tr.apply_updates = real_loss, real_apply
    spans = device_spans(prof)
    if not spans:
        return "not measured"
    ms = {"flash_fwd": 0.0, "flash_bwd": 0.0, "gemm": 0.0}
    for a, b, name in spans:
        key = kernel_class(name)
        if key in ms:
            ms[key] += (b - a) / 1e3
    ms["loss"] = (ev["loss0"].elapsed_time(ev["loss1"])
                  + ev["back0"].elapsed_time(ev["back1"]))
    ms["optimizer"] = ev["opt0"].elapsed_time(ev["opt1"])
    busy = busy_us(spans) / 1e3
    ms["other"] = busy - sum(ms.values())
    return {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall,
            "device_ms": ms, "device_ops": len(spans)}


def event_ms(torch, fn, reps=5):
    """Median CUDA-event ms of ``fn()`` after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def moe_split(torch, net, ids):
    """One forward and backward of MoE layer 0 (the real ``LlamaMoE``) on
    its input of the main path (the normed hidden state of ``ids``), each
    aten op it runs timed between CUDA events by a dispatch mode and summed
    by kind: products in f32 (the dispatch and combine einsums), products
    in the weights' dtype (the three expert products and the router's) and
    every other op (the routing loop, softmax, SwiGLU, casts). Beside them
    the layer's forward and backward timed whole (median of 5)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from mxnet_tpu_torch.models import llama as TL
    layer = net.model.layers[0]
    moe, cfg = layer.mlp, net.cfg
    caught = {}
    hook = layer.post_attention_layernorm.register_forward_hook(
        lambda m, i, o: caught.setdefault("x", o.detach()))
    with torch.no_grad():
        net.model(ids)
    hook.remove()
    x = caught["x"]
    B, T, d = x.shape
    N, E, k = B * T, cfg.num_experts, cfg.num_experts_per_tok
    C = TL.moe_capacity(cfg, N)
    products = {"mm", "bmm", "addmm", "baddbmm"}
    spans = []

    class Timed(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = func(*args, **(kwargs or {}))
            b.record()
            kind = "other"
            if func.overloadpacket.__name__ in products:
                f32 = args[0].dtype == torch.float32
                kind = "f32_products" if f32 else "weight_dtype_products"
            spans.append((kind, a, b))
            return out

    def whole():
        xi = x.detach().clone().requires_grad_(True)
        torch.autograd.grad(moe(xi).float().sum(), (xi,) + tuple(moe.parameters()))
    whole()
    torch.cuda.synchronize()
    with Timed():
        whole()
    torch.cuda.synchronize()
    ms = {"f32_products": 0.0, "weight_dtype_products": 0.0, "other": 0.0}
    ops = dict.fromkeys(ms, 0)
    for kind, a, b in spans:
        ms[kind] += a.elapsed_time(b)
        ops[kind] += 1
    return {"N": N, "E": E, "C": C, "k": k, "device_ms": ms, "ops": ops,
            "layer_ms": event_ms(torch, whole),
            # forward: dispatch and combine; backward: x's gradient through
            # the dispatch, the combine weights' and the expert outputs'
            "f32_product_flop": 5 * 2 * N * E * C * d,
            # the experts' three products and the router's, each forward
            # and two backward
            "weight_dtype_product_flop": 3 * 2 * (3 * E * C * d * cfg.intermediate_size
                                                  + N * d * E)}


def llama_train_run(torch, args, net, B, T, steps, label, moe=False):
    """``steps`` Adam steps (lr LT_LR) of ``net`` on one batch drawn from
    ``--seed`` through ``TrainStep(net, SoftmaxCrossEntropyLoss(axis=-1),
    Adam, [ids])``, each synchronised and timed, with the launch counts
    zeroed just before and read just after, and with the plain attention
    route (``_fallback``) counted; then one profiled step (``train_split``).
    Gates: every loss finite and the last below the first; K1 and K2 each
    launched once per layer per step; the plain route never taken."""
    from mxnet_tpu_torch import optimizer, parallel
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.ops import attention as fa
    from mxnet_tpu_torch.ops.int8_gemv import launches, reset_launches
    cfg = net.cfg
    ids, labels = train_batch(args, cfg.vocab_size, B, T)
    ids, labels = torch.from_numpy(ids).to("cuda"), torch.from_numpy(labels).to("cuda")
    step = parallel.TrainStep(net, SoftmaxCrossEntropyLoss(axis=-1),
                              optimizer.Adam(learning_rate=LT_LR), [ids])
    plain = [0]
    real_fallback = fa._fallback

    def counted_fallback(*a, **k):
        plain[0] += 1
        return real_fallback(*a, **k)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times, routes = [], [], None
    fa._fallback = counted_fallback
    reset_launches()
    try:
        for i in range(steps):
            t0 = time.perf_counter()
            if moe and i == 0:
                loss, routes = moe_routes(torch, net, lambda: step(ids, labels))
            else:
                loss = step(ids, labels)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss.float().item())
    finally:
        fa._fallback = real_fallback
    counts = launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = statistics.median(times[1:])
    flops = llama_train_flops(cfg, B, T)
    out = {"model": label, "layers": cfg.num_layers, "dtype": str(cfg.dtype).split(".")[-1],
           "B": B, "T": T, "steps": steps, "optimizer": "adam", "lr": LT_LR,
           "params": sum(p.numel() for p in net.parameters()), "losses": losses,
           "step_ms": times, "ms_per_step": ms, "tokens_per_s": B * T / ms * 1e3,
           "flop_per_step": flops, "mfu": flops / (ms / 1e3) / BF16_FLOP_PER_S,
           "peak_mem_gb": peak, "launches": counts, "plain_attention_calls": plain[0]}
    if routes:
        keep = torch.cat([r[1][4].reshape(-1) for r in routes])
        out["dropped_share"] = 1.0 - keep.float().mean().item()
        out["capacity"] = routes[0][1][0].shape[2]
    out["profiled_step"] = train_split(torch, step, ids, labels)
    emit({"llama_train": out})
    check(all(math.isfinite(v) for v in losses), f"{label}: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
    for kind in ("flash_fwd", "flash_bwd"):
        check(counts.get(kind, 0) == cfg.num_layers * steps,
              f"{label}: {kind} launches {counts.get(kind, 0)} != "
              f"{cfg.num_layers} layers x {steps} steps")
    check(plain[0] == 0, f"{label}: the plain attention ran {plain[0]} times")
    if routes:
        check(out["dropped_share"] < 1.0, f"{label}: every (token, choice) pair was dropped")
    return out


def small_llama_pair(torch, args, dtype=None):
    """(d)'s model (LT_SMALL, f32 unless ``dtype``) on the CPU from
    ``--seed`` and its copy on the card (``interop``)."""
    import dataclasses

    from mxnet_tpu_torch.interop import params_from_numpy, params_to_numpy
    from mxnet_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig(dtype=torch.float32, **LT_SMALL)
    cpu = LlamaForCausalLM(cfg, device="cpu").init_weights(args.seed)
    card_cfg = cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)
    card = params_from_numpy(LlamaForCausalLM(card_cfg, device="cuda"), params_to_numpy(cpu))
    return cpu, card


def small_sgd_steps(torch, args, net, steps, remat=False):
    """``steps`` TrainSteps of ``net`` with SGD (momentum 0.9, SGD_LR) on a
    [2, LT_SMALL_T] batch from ``--seed``: (losses, each step's gradients,
    each step's routes (moe_routes), parameters after)."""
    from mxnet_tpu_torch import optimizer, parallel
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.interop import params_to_numpy
    ids, labels = train_batch(args, net.cfg.vocab_size, 2, LT_SMALL_T)
    step = parallel.TrainStep(net, SoftmaxCrossEntropyLoss(axis=-1),
                              optimizer.SGD(learning_rate=SGD_LR, momentum=0.9), [ids],
                              remat=remat)
    losses, grads, routes = [], [], []
    for _ in range(steps):
        loss, r = moe_routes(torch, net, lambda: step(ids, labels))
        losses.append(loss.float().item())
        grads.append(named_grads(torch, net))
        routes.append(r)
    return losses, grads, routes, params_to_numpy(net)


def route_diffs(torch, got, want):
    """(pairs whose expert or slot or keep differs, largest router-logit
    difference, smallest top-k gate margin of ``want``) over matching
    (step, layer) routes."""
    bad, logit_diff, margin = 0, 0.0, float("inf")
    for g_step, w_step in zip(got, want):
        for (gl, (_, _, gi, gs, gk)), (wl, (_, _, wi, ws, wk)) in zip(g_step, w_step):
            bad += int(((gi.cpu() != wi.cpu()) | (gs.cpu() != ws.cpu())
                        | (gk.cpu() != wk.cpu())).sum())
            logit_diff = max(logit_diff, float((gl.cpu() - wl.cpu()).abs().max()))
            k = wi.shape[0]
            top = torch.softmax(wl.cpu(), dim=-1).sort(dim=-1, descending=True).values
            margin = min(margin, float((top[:, :k] - top[:, 1:k + 1]).min()))
    return bad, logit_diff, margin


def llama_card_vs_cpu_train(torch, args):
    """(d) and (e) on LT_SMALL: 2 f32 SGD steps on the card and on the CPU
    from the same weights: routing (expert and slot of every pair) equal,
    each step's gradients leaf by leaf within CARD_CPU_GRAD_TOL, the
    parameters after within CARD_CPU_PARAM_TOL; a bf16 twin's step-1
    gradients within BF16_GRAD_TOL of the f32 card's; ``remat=True`` on
    the card the same losses and parameters as ``remat=False``, bit for
    bit. Prints the readings (the CPU's smallest top-k gate margin beside
    the largest router-logit difference), then checks them."""
    from mxnet_tpu_torch.ops.int8_gemv import launches, reset_launches
    cpu, card = small_llama_pair(torch, args)
    reset_launches()
    lc, gc, rc, pc = small_sgd_steps(torch, args, card, 2)
    card_launches = launches()
    lh, gh, rh, ph = small_sgd_steps(torch, args, cpu, 2)
    grad_errs = [worst(leaf_errors(a, b)) for a, b in zip(gc, gh)]
    pdiff = max(float(abs(pc[n] - ph[n]).max()) for n in ph)
    bad, logit_diff, margin = route_diffs(torch, rc, rh)
    _, twin = small_llama_pair(torch, args, torch.bfloat16)
    (l16,), (g16,), r16, _ = small_sgd_steps(torch, args, twin, 1)
    bf16_err = leaf_errors(g16, gc[0])
    bf16_flips, _, _ = route_diffs(torch, r16, rc[:1])
    del twin
    _, card_r = small_llama_pair(torch, args)
    lr_, _, _, pr = small_sgd_steps(torch, args, card_r, 2, remat=True)
    remat_same = lr_ == lc and all(bool((pr[n] == pc[n]).all()) for n in pc)
    out = {"config": LT_SMALL, "B": 2, "T": LT_SMALL_T, "steps": 2, "optimizer": "sgd",
           "lr": SGD_LR, "losses": {"cuda": lc, "cpu": lh}, "card_launches": card_launches,
           "route_pairs_differing": bad, "cpu_min_topk_gate_margin": margin,
           "max_router_logit_diff": logit_diff,
           "grad_rel_l2_worst_leaf": grad_errs, "grad_tol": CARD_CPU_GRAD_TOL,
           "max_param_diff": pdiff, "param_tol": CARD_CPU_PARAM_TOL,
           "bf16_step1_loss": l16, "bf16_vs_f32_grad_rel_l2": worst(bf16_err),
           "bf16_grad_tol": BF16_GRAD_TOL, "bf16_route_pairs_differing": bf16_flips,
           "remat_losses": lr_, "remat_equal_bitwise": remat_same}
    emit({"llama_train_card_vs_cpu": out})
    check(bad == 0, f"routing differs between the card and the CPU at {bad} pairs "
          f"(smallest CPU gate margin {margin}, largest logit difference {logit_diff})")
    for i, e in enumerate(grad_errs):
        check(e["rel_l2"] <= CARD_CPU_GRAD_TOL,
              f"Llama card/CPU step-{i + 1} gradients differ: {e} > {CARD_CPU_GRAD_TOL}")
    check(pdiff <= CARD_CPU_PARAM_TOL,
          f"Llama card/CPU parameters after 2 steps differ by {pdiff} > {CARD_CPU_PARAM_TOL}")
    check(max(bf16_err.values()) <= BF16_GRAD_TOL,
          f"Llama bf16/f32 step-1 gradients differ: {worst(bf16_err)} > {BF16_GRAD_TOL}")
    for kind in ("flash_fwd", "flash_bwd"):
        check(card_launches.get(kind, 0) == 2 * LT_SMALL["num_layers"],
              f"small Llama on the card: {kind} launches {card_launches.get(kind, 0)}")
    check(remat_same, f"remat=True on the card: losses {lr_} against {lc}, or parameters, "
          "differ from remat=False")
    return out


def remat_peak_memory(torch, args):
    """(e) at (a)'s shape (LT_LAYERS layers of LLAMA3_8B, B 2, T 2048, the
    same weights): one Adam step with ``remat=False`` and with
    ``remat=True``, each with its peak device memory through the forward
    and backward (read as ``apply_updates`` starts) and over the whole
    step."""
    from mxnet_tpu_torch import optimizer, parallel
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import LlamaForCausalLM
    from mxnet_tpu_torch.parallel import train as tr
    cfg = llama_config(torch, LT_LAYERS)
    ids, labels = train_batch(args, cfg.vocab_size, LT_B, LT_T)
    ids, labels = torch.from_numpy(ids).to("cuda"), torch.from_numpy(labels).to("cuda")
    out = {"layers": LT_LAYERS, "B": LT_B, "T": LT_T}
    real_apply, seen = tr.apply_updates, {}

    def apply_updates(*a, **k):
        seen["fwd_bwd"] = torch.cuda.max_memory_allocated()
        return real_apply(*a, **k)
    for remat in (False, True):
        net = LlamaForCausalLM(cfg, device="cuda").init_weights(args.seed)
        step = parallel.TrainStep(net, SoftmaxCrossEntropyLoss(axis=-1),
                                  optimizer.Adam(learning_rate=LT_LR), [ids], remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tr.apply_updates = apply_updates
        try:
            loss = step(ids, labels).float().item()
        finally:
            tr.apply_updates = real_apply
        torch.cuda.synchronize()
        out["remat" if remat else "plain"] = {
            "loss": loss, "fwd_bwd_peak_gb": seen["fwd_bwd"] / 1e9,
            "step_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del net, step
        torch.cuda.empty_cache()
    return out


def llama_train(torch, args, timer, gen):
    """Phase 10: Llama trains on the card through ``parallel.TrainStep``.
    K1/K2 at the main path's attention shape (B 2, 32 heads of 128, T 2048,
    causal bf16) against their plain versions first; (a) LLAMA3_8B at
    LT_LAYERS layers, (b) the stacked decoder against the per-layer one at
    2 layers, (c) Mixtral-8x7B's widths at 2 MoE layers, (d) card against
    CPU in f32 on a small MoE Llama and its bf16 twin, (e) remat. Returns
    {"k1": row, "k2": row}: the kernels-line rows of K1 and K2 at head dim
    128 with their launches in (a) and (c)."""
    from mxnet_tpu_torch.models import LlamaForCausalLM
    t_phase = time.perf_counter()
    # (c) needs about 55 GB: the earlier phases' models and engines must be
    # freed once dropped, by reference counting alone
    held = torch.cuda.memory_allocated() / 1e9
    emit({"llama_train_allocated_gb_at_start": held})
    check(held <= LT_HELD_GB, f"{held} GB of device memory still allocated as phase 10 "
          f"starts (> {LT_HELD_GB}): an earlier phase's model or engine was not freed")
    kern = flash_case(torch, timer, gen, LT_B, 32, LT_T, LT_T, 128, True, torch.bfloat16,
                      timed=True)
    emit({"llama_train_flash_case": kern})
    torch.cuda.empty_cache()
    net = LlamaForCausalLM(llama_config(torch, LT_LAYERS),
                           device="cuda").init_weights(args.seed)
    dense = llama_train_run(torch, args, net, LT_B, LT_T, LT_STEPS, "llama3-8b")
    torch.cuda.empty_cache()
    stacked = llama_train_stacked(torch, args, net)
    del net
    torch.cuda.empty_cache()
    net = LlamaForCausalLM(mixtral_config(torch, MIXTRAL_LAYERS),
                           device="cuda").init_weights(args.seed)
    moe = llama_train_run(torch, args, net, LT_B, LT_T, LT_STEPS, "mixtral-8x7b", moe=True)
    torch.cuda.empty_cache()
    ids, _ = train_batch(args, net.cfg.vocab_size, LT_B, LT_T)
    moe["moe_layer_split"] = split = moe_split(torch, net, torch.from_numpy(ids).to("cuda"))
    emit({"llama_train_moe_split": split})
    del net
    torch.cuda.empty_cache()
    small = llama_card_vs_cpu_train(torch, args)
    torch.cuda.empty_cache()
    peaks = remat_peak_memory(torch, args)
    emit({"llama_train_remat_peak": peaks})
    emit({"llama_train_s": time.perf_counter() - t_phase})
    rows = {}
    for key, kind, pre in (("k1", "flash_fwd", "k1_"), ("k2", "flash_bwd", "k2_")):
        rows[key] = {"max_abs_err": kern[pre + "max_abs_err"], "ms": kern[pre + "ms"],
                     "plain_ms": kern[pre + "plain_ms"], "bound_ms": kern[pre + "bound_ms"],
                     "bound_by": kern[pre + "bound_by"], "library_ms": kern[pre + "library_ms"],
                     "launches": dense["launches"].get(kind, 0) + moe["launches"].get(kind, 0),
                     "launches_by": {"llama3-8b": dense["launches"].get(kind, 0),
                                     "mixtral-8x7b": moe["launches"].get(kind, 0)}}
    return rows


# ---------------------------------------------------------------------------
# Phase 11: the conv path (ResNet-50 training, hybridized inference, card
# against CPU) and ViT-B/16 at 384 through K1/K2
# ---------------------------------------------------------------------------

# (a) bench.py's bench_resnet50: resnet50_v1, NHWC, bf16 through AMP, B 128
# at 224 x 224, SGD lr 0.05 momentum 0.9
VT_B, VT_HW, VT_STEPS, VT_LR, VT_MOMENTUM = 128, 224, 10, 0.05, 0.9
# (c) card against CPU in f32: thumbnail ResNet-18, 10 classes, 32 x 32,
# two SGD-momentum steps at VT_CPU_LR (at 1e-4 one step takes the loss
# from 2.40 to 0.22 and the second step's gradients sit 0.08 apart, card
# against CPU; at 1e-5 to 1.95). BatchNorm's f32 E[y^2] - mean^2 alone
# puts the CPU's step-1 gradients up to 1.3e-2 (relative L2, a leaf) from
# an f64 two-pass reference. The H100 read 1.27e-2 and 2.53e-2 (steps 1
# and 2, card against CPU), parameters 1.12e-6 (max abs), and NHWC
# against NCHW on the card 3.6e-3 and 1.8e-7. Tolerances about 10x the
# card against the CPU, for all three pairs
VT_CPU_B, VT_CPU_HW, VT_CPU_STEPS, VT_CPU_LR = 8, 32, 2, 1e-5
VT_CARD_CPU_GRAD_TOL = 0.25
VT_CARD_CPU_PARAM_TOL = 1e-5
# (d) ViT-B/16 at 384 (T 577), bf16 through AMP, B 32, Adam
VIT_B, VIT_HW, VIT_STEPS, VIT_LR = 32, 384, 5, 1e-4
VT_SPLIT = ("conv_fprop", "conv_dgrad", "conv_wgrad", "bn_relu_elementwise", "sgd_update",
            "other")


def conv_class(name):
    """A ResNet training kernel's class by its name: a convolution's
    forward, data-gradient or weight-gradient kernel (cuDNN's names), the
    elementwise and reduction kernels (BN statistics, normalize, ReLU,
    residual adds, BN's backward), or ``other``."""
    low = name.lower()
    if "wgrad" in low:
        return "conv_wgrad"
    if "dgrad" in low:
        return "conv_dgrad"
    if any(w in low for w in ("fprop", "conv", "implicit_gemm", "xmma", "cutlass")):
        return "conv_fprop"
    if any(w in low for w in ("elementwise", "reduce", "batch_norm")):
        return "bn_relu_elementwise"
    return "other"


def resnet_flops(net, hw, batch):
    """Training FLOPs of one step of a ResNet V1 from its built shapes: 2 x
    kh x kw x C_in / groups x C_out x H_out x W_out per conv (the stem
    counted as its 7 x 7 / 2 conv, whatever route runs it) and 2 x in x out
    per dense, per image, x 3 for forward and backward."""
    from mxnet_tpu_torch.gluon import nn

    def conv(c, h):
        (kh, kw), (sh, sw), (ph, pw) = c._kernel, c._strides, c._padding
        ho, wo = (h[0] + 2 * ph - kh) // sh + 1, (h[1] + 2 * pw - kw) // sw + 1
        cin = c.weight.shape[-1] * c._groups
        return 2 * kh * kw * cin // c._groups * c._channels * ho * wo, (ho, wo)

    total, h = 0, (hw, hw)
    for child in net.features:
        if isinstance(child, nn.Conv2D):
            f, h = conv(child, h)
            total += f
        elif isinstance(child, nn.MaxPool2D):
            k, s, p = child._size[0], child._strides[0], child._padding[0]
            h = ((h[0] + 2 * p - k) // s + 1, (h[1] + 2 * p - k) // s + 1)
        elif isinstance(child, nn.HybridSequential):
            for block in child:
                body = [c for c in block.body if isinstance(c, nn.Conv2D)]
                hb = h
                for c in body:
                    f, hb = conv(c, hb)
                    total += f
                if block.downsample is not None:
                    total += conv(block.downsample[0], h)[0]
                h = hb
    w = net.output.weight.shape
    total += 2 * w[0] * w[1]
    return 3 * batch * total


def resnet_split(torch, step, images, labels):
    """One step under ``torch.profiler`` (device activity): device ms of
    the convolutions' forward, data-gradient and weight-gradient kernels
    (by kernel name), of the SGD update (``apply_updates``, between CUDA
    events), of the BN / ReLU elementwise and reduction kernels (by name,
    less the update's, which are elementwise too) and of the rest."""
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.parallel import train as tr
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    real_apply = tr.apply_updates

    def apply_updates(*a, **k):
        ev[0].record()
        real_apply(*a, **k)
        ev[1].record()
    torch.cuda.synchronize()
    tr.apply_updates = apply_updates
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(images, labels)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        tr.apply_updates = real_apply
    spans = device_spans(prof)
    if not spans:
        return "not measured"
    ms = dict.fromkeys(VT_SPLIT, 0.0)
    for a, b, name in spans:
        ms[conv_class(name)] += (b - a) / 1e3
    ms["sgd_update"] = ev[0].elapsed_time(ev[1])
    ms["bn_relu_elementwise"] -= ms["sgd_update"]
    busy = busy_us(spans) / 1e3
    by_name = {}
    for a, b, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    by_class = {c: [[n[:100], t] for n, t in top if conv_class(n) == c][:3] for c in VT_SPLIT}
    return {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall,
            "device_ms": ms, "device_ops": len(spans),
            "top_kernels_ms": [[name[:120], t] for name, t in top[:12]],
            "top_kernels_by_class": by_class}


def resnet_train(torch, args):
    """(a) ResNet-50 v1 in bench_resnet50's configuration: 10 SGD steps on
    one batch from ``--seed``. Gates: finite losses, the last below the
    first, the fused route every step (each bottleneck block one
    ``npx.fused_resnet_block``, the stem one s2d rewrite), the running
    statistics moved. Returns (net, images, report)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, npx, optimizer, parallel
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import get_model
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    mx.random.seed(args.seed)
    t0 = time.perf_counter()
    net = get_model("resnet50_v1", classes=1000, layout="NHWC")
    net.initialize(mx.init.Xavier())
    amp.convert_hybrid_block(net, "bfloat16")
    rng = np.random.RandomState(args.seed)
    images = torch.from_numpy(rng.rand(VT_B, VT_HW, VT_HW, 3).astype(np.float32))
    images = images.to("cuda").bfloat16()
    labels = torch.from_numpy(rng.randint(0, 1000, VT_B).astype(np.int32)).to("cuda")
    step = parallel.TrainStep(net, SoftmaxCrossEntropyLoss(),
                              optimizer.SGD(learning_rate=VT_LR, momentum=VT_MOMENTUM),
                              [images])
    build_s = time.perf_counter() - t0
    n_blocks = sum(isinstance(b, resnet.BottleneckV1) for stage in net.features
                   if hasattr(stage, "__iter__") for b in stage)
    stats = {k: p for k, p in net.collect_params().items() if k.endswith("running_mean")}
    before = {k: p.data()._data.clone() for k, p in stats.items()}
    calls = {"block": 0, "stem": 0}
    real_block, real_stem = npx.fused_resnet_block, resnet._stem_s2d

    def block(*a, **k):
        calls["block"] += 1
        return real_block(*a, **k)

    def stem(*a, **k):
        calls["stem"] += 1
        return real_stem(*a, **k)
    npx.fused_resnet_block, resnet._stem_s2d = block, stem
    torch.cuda.reset_peak_memory_stats()
    losses, times, per_step = [], [], []
    try:
        for _ in range(VT_STEPS):
            calls.update(block=0, stem=0)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            loss = step(images, labels)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
            losses.append(loss.float().item())
            per_step.append(dict(calls))
    finally:
        npx.fused_resnet_block, resnet._stem_s2d = real_block, real_stem
    peak = torch.cuda.max_memory_allocated() / 1e9
    ms = statistics.median(times[1:])
    flops = resnet_flops(net, VT_HW, VT_B)
    moved = sum(not torch.equal(before[k], p.data()._data) for k, p in stats.items())
    split = resnet_split(torch, step, images, labels)
    report = {"model": "resnet50_v1", "layout": "NHWC", "dtype": "bfloat16", "B": VT_B,
              "hw": VT_HW, "optimizer": f"sgd lr {VT_LR} momentum {VT_MOMENTUM}",
              "steps": VT_STEPS, "build_s": build_s, "losses": losses,
              "step_ms": times, "ms_per_step": ms, "images_per_s": VT_B / ms * 1e3,
              "flops_per_step": flops, "mfu": flops / (ms / 1e3) / BF16_FLOP_PER_S,
              "peak_mem_gb": peak, "fused_calls_per_step": per_step,
              "bottleneck_blocks": n_blocks, "running_means_moved": moved,
              "running_means": len(stats), "profiled_step": split}
    emit({"vision_train_resnet50": report})
    check(all(math.isfinite(x) for x in losses), f"non-finite ResNet-50 loss: {losses}")
    check(losses[-1] < losses[0], f"ResNet-50 loss did not fall: {losses}")
    check(all(c == {"block": n_blocks, "stem": 1} for c in per_step),
          f"the fused route was not taken every step: {per_step} ({n_blocks} blocks)")
    check(moved == len(stats), f"{len(stats) - moved} running means did not move")
    check(all(bool(torch.isfinite(p.data()._data).all()) for p in stats.values()),
          "non-finite running statistics")
    del step
    return net, images, report


def resnet_infer(torch, net, images):
    """(b) (a)'s net in inference, eager and hybridized with
    ``static_alloc=True`` (CUDA-graph replay from the second call): the
    replayed logits equal the eager ones within the bf16 rounding of the
    logits (one bf16 step at the largest logit), bitwise or not printed;
    images/s of each."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.ndarray import NDArray
    x = NDArray._new(images)
    with autograd.predict_mode():
        eager = net(x)._data.float()
        eager_ms = event_ms(torch, lambda: net(x))
        net.hybridize(static_alloc=True)
        net(x)
        replay = net(x)._data.float()
        replay_ms = event_ms(torch, lambda: net(x))
        replays = net._cached_op.replays
        net.hybridize(active=False)
    gap = (replay - eager).abs().max().item()
    top = eager.abs().max().item()
    tol = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    out = {"B": images.shape[0], "eager_ms": eager_ms, "replay_ms": replay_ms,
           "eager_images_per_s": images.shape[0] / eager_ms * 1e3,
           "replay_images_per_s": images.shape[0] / replay_ms * 1e3,
           "replays": replays, "max_abs_gap": gap, "bf16_step_at_max": tol,
           "bitwise": bool(torch.equal(replay, eager)),
           "finite": bool(torch.isfinite(eager).all())}
    emit({"vision_infer_resnet50": out})
    check(out["finite"] and replays > 0, f"hybridized inference did not replay: {out}")
    check(gap <= tol, f"replayed logits differ from eager beyond bf16 rounding: {out}")
    return out


def resnet_grads(torch, net, x, y):
    """VT_CPU_STEPS SGD-momentum ``TrainStep``s of ``net``: (losses, each
    step's gradients {name: f32 host tensor}, the parameters and running
    statistics after the steps {name: f32 host tensor})."""
    from mxnet_tpu_torch import optimizer, parallel
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    step = parallel.TrainStep(net, SoftmaxCrossEntropyLoss(),
                              optimizer.SGD(learning_rate=VT_CPU_LR, momentum=VT_MOMENTUM),
                              [x])
    losses, grads = [], []
    for _ in range(VT_CPU_STEPS):
        losses.append(step(x, y).float().item())
        grads.append({n: p.grad.detach().float().cpu() for n, p in step._params})
    params = {k: p.data()._data.detach().float().cpu() for k, p in net.collect_params().items()}
    return losses, grads, params


def resnet_card_vs_cpu(torch, args):
    """(c) Thumbnail ResNet-18 (10 classes, 32 x 32) in f32, NHWC (the
    fused route) and its NCHW twin from the same weights, 2 SGD-momentum
    steps on the card and on the CPU: gradients leaf by leaf (relative L2)
    within VT_CARD_CPU_GRAD_TOL, parameters and running statistics (max
    abs) within VT_CARD_CPU_PARAM_TOL; NHWC against NCHW on the card within
    the same tolerances."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import get_model
    rng = np.random.RandomState(args.seed)
    x = rng.rand(VT_CPU_B, VT_CPU_HW, VT_CPU_HW, 3).astype(np.float32)
    y = rng.randint(0, 10, VT_CPU_B).astype(np.int32)
    with mx.cpu():
        mx.random.seed(args.seed)
        ref = get_model("resnet18_v1", classes=10, thumbnail=True, layout="NHWC")
        ref.initialize(mx.init.Xavier())
        ref.infer_shape(x)
        named = {k: p.data().asnumpy() for k, p in ref.collect_params().items()}
    del ref
    nchw = {k: v.transpose(0, 3, 1, 2) if v.ndim == 4 else v for k, v in named.items()}
    runs = {}
    for layout, weights, xi in (("NHWC", named, x), (None, nchw, x.transpose(0, 3, 1, 2))):
        for dev in ("cuda", "cpu"):
            with mx.Device(dev):
                net = get_model("resnet18_v1", classes=10, thumbnail=True, layout=layout)
                net.load_dict(weights)
                xt = torch.from_numpy(np.ascontiguousarray(xi)).to(dev)
                runs[(layout, dev)] = resnet_grads(torch, net, xt, torch.from_numpy(y).to(dev))
            del net

    def compare(a, b, to_nchw=False):
        la, ga, pa = a
        lb, gb, pb = b
        fix = (lambda t: t.permute(0, 3, 1, 2) if t.dim() == 4 else t) if to_nchw \
            else (lambda t: t)
        per_step = [leaf_errors({k: fix(v) for k, v in sa.items()}, sb)
                    for sa, sb in zip(ga, gb)]
        p = {k: (fix(pa[k]) - pb[k]).abs().max().item() for k in pb}
        return {"losses": [la, lb], "grad_rel_l2": max(max(e.values()) for e in per_step),
                "grad_rel_l2_by_step": [worst(e) for e in per_step],
                "param_max_abs": max(p.values()), "param_worst": max(p, key=p.get)}
    out = {"B": VT_CPU_B, "hw": VT_CPU_HW, "steps": VT_CPU_STEPS,
           "nhwc_card_vs_cpu": compare(runs[("NHWC", "cuda")], runs[("NHWC", "cpu")]),
           "nchw_card_vs_cpu": compare(runs[(None, "cuda")], runs[(None, "cpu")]),
           "nhwc_vs_nchw_card": compare(runs[("NHWC", "cuda")], runs[(None, "cuda")],
                                        to_nchw=True),
           "lr": VT_CPU_LR,
           "tol": {"grad": VT_CARD_CPU_GRAD_TOL, "param": VT_CARD_CPU_PARAM_TOL}}
    emit({"vision_card_vs_cpu": out})
    for key in ("nhwc_card_vs_cpu", "nchw_card_vs_cpu", "nhwc_vs_nchw_card"):
        r = out[key]
        check(r["grad_rel_l2"] <= VT_CARD_CPU_GRAD_TOL,
              f"{key}: gradients {r['grad_rel_l2']} > {VT_CARD_CPU_GRAD_TOL}")
        check(r["param_max_abs"] <= VT_CARD_CPU_PARAM_TOL,
              f"{key}: parameters {r['param_max_abs']} > {VT_CARD_CPU_PARAM_TOL}")
    return out


def vit_train(torch, args, timer, gen):
    """(d) ViT-B/16 at 384 (T 577), bf16 through AMP, B 32, 5 Adam steps:
    K1 and K2 first timed at its attention shape (B 32, 12 heads of 64, T
    577, not causal, bf16) against their plain versions and beside SDPA;
    then finite falling losses, K1 and K2 each launched 12 times a step
    (counts zeroed just before the step, read just after) and the plain
    attention never. Returns (kernel row, launches)."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, optimizer, parallel
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import ViTConfig, ViTModel
    from mxnet_tpu_torch.ops import attention as fa
    from mxnet_tpu_torch.ops.int8_gemv import launches, reset_launches
    cfg = ViTConfig(image_size=VIT_HW)
    T = cfg.num_patches + 1
    kern = flash_case(torch, timer, gen, VIT_B, cfg.num_heads, T, T,
                      cfg.hidden_size // cfg.num_heads, False, torch.bfloat16, timed=True)
    emit({"vision_vit_flash_case": kern})
    torch.cuda.empty_cache()
    mx.random.seed(args.seed)
    net = ViTModel(cfg)
    net.initialize()
    amp.convert_hybrid_block(net, "bfloat16")
    rng = np.random.RandomState(args.seed)
    x = torch.from_numpy(rng.rand(VIT_B, 3, VIT_HW, VIT_HW).astype(np.float32))
    x = x.to("cuda").bfloat16()
    y = torch.from_numpy(rng.randint(0, cfg.num_classes, VIT_B).astype(np.int32)).to("cuda")
    step = parallel.TrainStep(net, SoftmaxCrossEntropyLoss(),
                              optimizer.Adam(learning_rate=VIT_LR), [x])
    plain = {"calls": 0}
    real_fallback = fa._fallback

    def counted_fallback(*a, **k):
        plain["calls"] += 1
        return real_fallback(*a, **k)
    fa._fallback = counted_fallback
    torch.cuda.reset_peak_memory_stats()
    losses, times, counts = [], [], []
    try:
        for _ in range(VIT_STEPS):
            torch.cuda.synchronize()
            reset_launches()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            loss = step(x, y)
            b.record()
            b.synchronize()
            c = launches()
            counts.append({k: c.get(k, 0) for k in ("flash_fwd", "flash_bwd")})
            times.append(a.elapsed_time(b))
            losses.append(loss.float().item())
    finally:
        fa._fallback = real_fallback
    ms = statistics.median(times[1:])
    d, L = cfg.hidden_size, cfg.num_layers
    n_tok = VIT_B * T
    flops = 3 * (L * (2 * n_tok * 12 * d * d + 4 * VIT_B * T * T * d)
                 + 2 * VIT_B * cfg.num_patches * 3 * cfg.patch_size ** 2 * d
                 + 2 * VIT_B * d * cfg.num_classes)
    report = {"model": "vit-b16", "image": VIT_HW, "T": T, "dtype": "bfloat16", "B": VIT_B,
              "optimizer": f"adam lr {VIT_LR}", "steps": VIT_STEPS, "losses": losses,
              "step_ms": times, "ms_per_step": ms, "images_per_s": VIT_B / ms * 1e3,
              "mfu_analytic": flops / (ms / 1e3) / BF16_FLOP_PER_S,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "launches_per_step": counts, "plain_attention_calls": plain["calls"]}
    emit({"vision_train_vit": report})
    check(all(math.isfinite(v) for v in losses), f"non-finite ViT loss: {losses}")
    check(losses[-1] < losses[0], f"ViT loss did not fall: {losses}")
    check(all(c == {"flash_fwd": L, "flash_bwd": L} for c in counts),
          f"K1/K2 not launched {L} times a step: {counts}")
    check(plain["calls"] == 0, f"the plain attention ran {plain['calls']} times")
    del step, net
    return kern, sum(c["flash_fwd"] for c in counts), sum(c["flash_bwd"] for c in counts)


def vision_train(torch, args, timer, gen):
    """Phase 11: the conv path. (a) ResNet-50 v1 trains in bench_resnet50's
    configuration, (b) its hybridized inference replays, (c) a ResNet-18
    card against the CPU, (d) ViT-B/16 at 384 through K1/K2. Starts only
    with at most LT_HELD_GB still allocated. Returns {"k1": row, "k2":
    row}: the kernels-line rows of K1/K2 at ViT's shape with their
    launches in (d)."""
    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated() / 1e9
    emit({"vision_train_allocated_gb_at_start": held})
    check(held <= LT_HELD_GB, f"{held} GB of device memory still allocated as phase 11 "
          f"starts (> {LT_HELD_GB}): an earlier phase's model or engine was not freed")
    net, images, report = resnet_train(torch, args)
    FIGURES["resnet50_fixed_images_per_s"] = report["images_per_s"]
    resnet_infer(torch, net, images)
    del net, images
    torch.cuda.empty_cache()
    resnet_card_vs_cpu(torch, args)
    torch.cuda.empty_cache()
    kern, n1, n2 = vit_train(torch, args, timer, gen)
    torch.cuda.empty_cache()
    emit({"vision_train_s": time.perf_counter() - t_phase})
    rows = {}
    for key, pre, n in (("k1", "k1_", n1), ("k2", "k2_", n2)):
        rows[key] = {"max_abs_err": kern[pre + "max_abs_err"], "ms": kern[pre + "ms"],
                     "plain_ms": kern[pre + "plain_ms"], "bound_ms": kern[pre + "bound_ms"],
                     "bound_by": kern[pre + "bound_by"],
                     "library_ms": kern[pre + "library_ms"], "launches": n}
    return rows


# phase 12 (nlp_train). (a) bench_bert_base_ft's configuration (bench.py:131-175)
BERT_FT_B, BERT_FT_T, BERT_FT_STEPS, BERT_FT_TRIALS, BERT_FT_LR = 32, 128, 20, 3, 2e-5
# (b) BERT-base pretraining at full length: B 8, T 512, LAMB, 8 steps (the
# first two steps of the post-LN BERT at initialization raise its loss: on
# the H100 11.58, 12.15, 12.80, then 11.90, 11.61, 11.31), and the valid
# prefix of a batch masked from position 384 on
BERT_PT_B, BERT_PT_T, BERT_PT_STEPS, BERT_PT_LR, BERT_PT_VALID = 8, 512, 8, 1e-3, 384
# the masked batch's valid prefix against the truncated batch on the f32
# master weights, per position: |diff|_2 / |truncated|_2 (the H100 read
# 1.1e-6). In bf16 the two runs' GEMMs, of other row counts, round apart by
# 0.72% at the worst position, more than an ignored mask moves the median
# one (0.66%) after (b)'s steps, so the bf16 run is reported, not gated.
# The same f32 run with the mask ignored must read above it at most rows
BERT_MASK_ROW_TOL = 1e-4
# (c) card against CPU: a narrow BERT (2 heads of 64) at B 2, and T5_TINY
NLP_NARROW = dict(hidden_size=128, num_layers=2, num_heads=2, intermediate_size=512)
NLP_CPU_B, NLP_CPU_STEPS = 2, 2
# a leaf's gradient error is taken against at least this share of the whole
# step's gradient norm (the H100 read the key biases' gradients, 0 in exact
# arithmetic, 1.7 apart relative to their own size)
NLP_GRAD_FLOOR = 1e-4
# (d) T5-small at T5's fine-tuning lengths, Adam (the JAX package has no Adafactor)
T5_B, T5_SRC, T5_TGT, T5_STEPS, T5_LR = 16, 512, 128, 5, 1e-4
# (e) each registered optimizer: 3 update steps of an f32 and a bf16 tensor
OPT_SHAPE, OPT_STEPS = (256, 384), 3
OPT_KW = dict(learning_rate=0.05, wd=0.01, clip_gradient=1.5, rescale_grad=0.5)
NLP_SPLIT = ("gemm", "attention", "dropout_mask", "layernorm_gelu", "optimizer", "other")
# the ops that launch the dense layers' GEMMs, forward and backward
GEMM_OPS = ("aten::addmm", "aten::mm", "aten::bmm", "aten::baddbmm")
EVAL_FN = "autograd::engine::evaluate_function: "


def bert_flops(cfg, B, T, mlm=False):
    """bench.py's analytic training FLOPs (3 x forward): per layer 24 B T D^2
    (q, k, v, out and the 4D MLP) + 4 B T^2 D (attention), the pooler and
    the classifier; with ``mlm`` the pretraining heads (transform D x D and
    the vocab decoder) in place of the classifier."""
    L, D = cfg.num_layers, cfg.hidden_size
    body = L * (24 * B * T * D * D + 4 * B * T * T * D) + 2 * B * D * D
    heads = (2 * B * T * D * D + 2 * B * T * D * cfg.vocab_size + 2 * B * D * 2) if mlm \
        else 2 * B * D * 2
    return 3 * (body + heads)


def t5_flops(cfg, B, S, T):
    """Analytic training FLOPs (3 x forward) of T5 over sources of S and
    targets of T: the projections, MLPs and attention products of both
    stacks, the cross-attention and the tied head."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    enc = 8 * B * S * d * d + 4 * B * S * d * f + 4 * B * S * S * d
    dec = (8 * B * T * d * d + 4 * B * T * d * d + 4 * B * S * d * d + 4 * B * T * d * f
           + 4 * B * T * T * d + 4 * B * T * S * d)
    return 3 * (L * (enc + dec) + 2 * B * T * d * cfg.vocab_size)


def on(device):
    """The port's device scope for ``device`` ("cpu" or "cuda")."""
    import mxnet_tpu_torch as mx
    return mx.cpu() if device == "cpu" else mx.gpu(0)


class Counting:
    """Count the calls of module attributes while inside: ``targets`` is
    {label: (module, name)}; ``.counts`` holds the calls per label."""

    def __init__(self, targets):
        self.targets = targets
        self.counts = dict.fromkeys(targets, 0)
        self._real = {}

    def __enter__(self):
        for label, (mod, name) in self.targets.items():
            real = self._real[label] = getattr(mod, name)

            def counted(*a, _real=real, _label=label, **k):
                self.counts[_label] += 1
                return _real(*a, **k)
            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for label, (mod, name) in self.targets.items():
            setattr(mod, name, self._real[label])

    def reset(self):
        self.counts = dict.fromkeys(self.targets, 0)


def plain_attention_targets():
    """The non-kernel routes of ``flash_attention_bthd`` and ``flash_attention``."""
    from mxnet_tpu_torch.ops import attention as fa
    return {"einsum": (fa, "_xla_attention"), "chunked": (fa, "_chunked_reference"),
            "fallback": (fa, "_fallback")}


def split_ranges():
    """(category, module, function) whose calls one profiled NLP step puts
    in ``record_function`` ranges."""
    from mxnet_tpu_torch import numpy_extension as npx
    from mxnet_tpu_torch.ops import attention as fa
    from mxnet_tpu_torch.parallel import train as tr
    return (("attention", fa, "_xla_attention"), ("attention", fa, "_chunked_reference"),
            ("dropout_mask", npx, "_cheap_keep_mask"), ("layernorm_gelu", npx, "layer_norm"),
            ("layernorm_gelu", npx, "gelu"), ("optimizer", tr, "apply_updates"))


def node_seq(torch):
    """The sequence number the next autograd node made on this thread
    takes (a probe node's own number, plus one)."""
    return torch.empty(0, requires_grad=True).view(0).grad_fn._sequence_nr() + 1


def attribute(events, self_time, spans_of):
    """Time of one profiled step by category from the profiler's host
    events, each op's own time (``self_time(e)``: the device time of the
    kernels it launched on the card, its host time in a CPU rehearsal)
    counted once: an op inside a ``split_ranges`` range (forward) goes to
    the innermost range's category; an op inside an autograd node
    (``evaluate_function``) to the category whose range made that node
    (``spans_of``: category -> the [first, last) node sequence numbers
    each call made); the remaining GEMM ops (``aten::mm``, ``addmm``,
    ``bmm``) to GEMMs; the rest to ``other``."""
    from torch.autograd import DeviceType
    out = dict.fromkeys(NLP_SPLIT, 0.0)
    by_op = {}

    def made_by(seq):
        return next((cat for cat, spans in spans_of.items()
                     if any(lo <= seq < hi for lo, hi in spans)), None)
    for e in events:
        if e.device_type != DeviceType.CPU or e.name.startswith("mx_split:"):
            continue                    # kernels count with their op; a range's own
            # time is its device window
        cat = node = None
        p = e.cpu_parent
        while p is not None and cat is None:
            if p.name.startswith("mx_split:"):
                cat = p.name[len("mx_split:"):]
            elif node is None and p.name.startswith(EVAL_FN):
                node = p
            p = p.cpu_parent
        if cat is None and node is not None:
            cat = made_by(node.sequence_nr)
        if cat is None:
            cat = "gemm" if e.name in GEMM_OPS else "other"
        t = self_time(e)
        out[cat] += t
        key = f"{cat}:{e.name}"
        by_op[key] = by_op.get(key, 0.0) + t
    return out, by_op


def nlp_split(torch, step, inputs, labels, device="cuda"):
    """One training step under ``torch.profiler`` (host and device
    activity): device ms by category (``attribute``: GEMMs, the attention
    einsums and softmax, the dropout mask hashing, LayerNorm and GELU, the
    optimizer's update, other) against the device's busy time and the
    step's wall time. ``device='cpu'`` rehearses the attribution with host
    times."""
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = device == "cuda"
    real = [(mod, name, getattr(mod, name)) for _, mod, name in split_ranges()]
    spans_of = {cat: [] for cat, _, _ in split_ranges()}
    for (cat, mod, name), (_, _, fn) in zip(split_ranges(), real):
        def ranged(*a, _fn=fn, _cat=cat, **k):
            lo = node_seq(torch)
            with record_function("mx_split:" + _cat):
                out = _fn(*a, **k)
            spans_of[_cat].append((lo, node_seq(torch)))
            return out
        setattr(mod, name, ranged)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    try:
        sync(torch, device)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            step(inputs, labels)
            sync(torch, device)
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, name, fn in real:
            setattr(mod, name, fn)
    events = prof.events()
    if cuda:
        # the ranges show on the device's timeline too, as annotations
        spans = [sp for sp in device_spans(prof) if not sp[2].startswith("mx_split:")]
        if not spans:
            return "not measured"
        busy = busy_us(spans) / 1e3
        ms, by_op = attribute(events, lambda e: e.self_device_time_total, spans_of)
    else:
        busy = wall
        ms, by_op = attribute(events, lambda e: e.self_cpu_time_total, spans_of)
    ms = {k: v / 1e3 for k, v in ms.items()}
    counted = sum(ms.values())
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:12]
    out = {"wall_ms": wall, "busy_ms": busy, "idle_share": 1.0 - busy / wall, "ms": ms,
           "attributed_ms": counted, "share": {k: v / counted for k, v in ms.items()},
           "top_ops_ms": [[k[:100], v / 1e3] for k, v in top],
           "clock": "device" if cuda else "host"}
    if cuda:
        by_name = {}
        for a, b, n in spans:
            by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e3
        out["device_ops"] = len(spans)
        out["gemm_kernels_by_name_ms"] = sum(t for n, t in by_name.items()
                                             if kernel_class(n) == "gemm")
        out["top_kernels_ms"] = [[n[:120], t] for n, t in
                                 sorted(by_name.items(), key=lambda kv: -kv[1])[:12]]
    return out


def bert_ft(torch, args, device="cuda", steps=BERT_FT_STEPS, trials=BERT_FT_TRIALS, cfg=None):
    """(a) ``bench_bert_base_ft``'s configuration: BertForSequenceClassification
    (BertConfig(), 2 classes), ``random.seed(0)``, ``initialize()``, bf16
    through ``amp.convert_hybrid_block``; B 32 ids of T 128 from
    ``--seed``, zero token types, labels in {0, 1}; ``TrainStep`` with
    Adam at 2e-5; one warm ``run(steps=20)``, then ``trials`` timed runs.
    Gates: finite losses, parameters moved, K1/K2 never launched (T 128
    with attention dropout takes the einsum route), the attention dropout
    drawn once a layer every step. Then the trained net's predictions
    scored with Accuracy, F1 and MCC from CUDA tensors equal the scores
    from host copies. ``device='cpu'`` (a narrow ``cfg``) rehearses it."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, autograd, optimizer, parallel
    from mxnet_tpu_torch.gluon import metric
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import BertConfig, BertForSequenceClassification
    from mxnet_tpu_torch.ops import attention as fa
    from mxnet_tpu_torch.ops.int8_gemv import launches, reset_launches
    cfg = cfg or BertConfig()
    B, T = BERT_FT_B, BERT_FT_T
    with on(device):
        mx.random.seed(0)
        net = BertForSequenceClassification(cfg, num_classes=2)
        net.initialize()
    amp.convert_hybrid_block(net, "bfloat16")
    rng = np.random.RandomState(args.seed)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)).to(device)
    types = torch.zeros(B, T, dtype=torch.int32, device=device)
    labels = torch.from_numpy(rng.randint(0, 2, B).astype(np.int32)).to(device)
    step = parallel.TrainStep(net, SoftmaxCrossEntropyLoss(), optimizer.Adam(
        learning_rate=BERT_FT_LR), example_inputs=[ids, types])
    probe = dict(step._params)["classifier.weight"]
    before = probe.detach().clone()
    draws = Counting({"mask": (fa, "_dropout_keep")})
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with draws:
        reset_launches()
        warm = step.run((ids, types), labels, steps=steps).item()
        times, losses = [], [warm]
        for _ in range(trials):
            sync(torch, device)
            t0 = time.perf_counter()
            losses.append(step.run((ids, types), labels, steps=steps).item())
            sync(torch, device)
            times.append((time.perf_counter() - t0) * 1e3 / steps)
        counts = launches()
    peak = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else None
    split = nlp_split(torch, step, (ids, types), labels, device)
    moved = float((probe.detach().float() - before.float()).abs().max())
    with autograd.predict_mode(), torch.no_grad():
        logits = net(ids, types)
    scores = {}
    for name in ("Accuracy", "F1", "MCC"):
        on_card, on_host = getattr(metric, name)(), getattr(metric, name)()
        on_card.update([labels], [logits])
        on_host.update([labels.cpu().numpy()], [logits.float().cpu().numpy()])
        scores[name] = {"card": on_card.get()[1], "host": on_host.get()[1]}
    ms = statistics.median(times)
    flops = bert_flops(cfg, B, T)
    run_steps = steps * (trials + 1)           # the warm run and the trials
    report = {"model": "bert-base", "config": "bench_bert_base_ft", "B": B, "T": T,
              "dtype": "bfloat16", "optimizer": f"adam lr {BERT_FT_LR}",
              "steps_per_run": steps, "trials": trials, "losses_per_run": losses,
              "ms_per_step_trials": times, "ms_per_step": ms,
              "spread": (max(times) - min(times)) / min(times),
              "examples_per_s": B / ms * 1e3, "flops_per_step": flops,
              "mfu": flops / (ms / 1e3) / BF16_FLOP_PER_S, "peak_mem_gb": peak,
              "launches": counts, "attention_mask_draws": draws.counts["mask"],
              "steps_counted": run_steps, "classifier_moved": moved,
              "scores": scores, "profiled_step": split, "device": device}
    emit({"nlp_train_bert_ft": report})
    check(all(math.isfinite(x) for x in losses), f"non-finite BERT fine-tune loss: {losses}")
    check(moved > 0, "the classifier did not move")
    check(counts.get("flash_fwd", 0) == 0 and counts.get("flash_bwd", 0) == 0,
          f"K1/K2 launched at T {T} with attention dropout: {counts}")
    check(draws.counts["mask"] == cfg.num_layers * run_steps,
          f"attention dropout drawn {draws.counts['mask']} times in {run_steps} steps "
          f"of {cfg.num_layers} layers")
    for name, s in scores.items():
        check(s["card"] == s["host"], f"{name} from card tensors {s['card']} != host {s['host']}")
    del step, net
    return report


def pretraining_loss():
    """BERT pretraining's loss per example: MLM cross-entropy over every
    position plus NSP cross-entropy, on f32 logits (a bf16 loss of about 11
    moves in steps of 1/16)."""
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    mlm, nsp = SoftmaxCrossEntropyLoss(axis=-1), SoftmaxCrossEntropyLoss()

    def loss(outs, mlm_labels, nsp_labels):
        return mlm(outs[0].float(), mlm_labels) + nsp(outs[1].float(), nsp_labels)
    return loss


def pretraining_batch(torch, args, cfg, B, T, device):
    """Ids, token types (sentence A then B), MLM labels at every position
    (the input tokens, which MLM recovers) and NSP labels, from
    ``--seed``."""
    import numpy as np
    rng = np.random.RandomState(args.seed + 1)
    ids = rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)
    types = (np.arange(T)[None, :] >= T // 2).repeat(B, 0).astype(np.int32)
    mlm = ids.copy()
    nsp = rng.randint(0, 2, B).astype(np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (ids, types, mlm, nsp))


def masked_prefix(torch, net, ids, types, mask, valid):
    """The encoder's output on ``ids`` under a key mask of ``valid``
    leading keys against its output on the first ``valid`` tokens alone:
    the largest difference, one bf16 step at the largest value, the worst
    position's relative error |diff|_2 / |truncated|_2, and the median
    position's with the mask ignored (a planted fault); and the kernel
    launches of the masked run."""
    from mxnet_tpu_torch.ops.int8_gemv import launches, reset_launches
    reset_launches()
    masked, _ = net.bert(ids, types, mask)
    launched = {k: launches().get(k, 0) for k in ("flash_fwd", "flash_bwd")}
    trunc, _ = net.bert(ids[:, :valid], types[:, :valid])
    unmasked, _ = net.bert(ids, types)
    ref = trunc.float()

    def rows(out):
        d = out[:, :valid].float() - ref
        return d, d.norm(dim=-1) / ref.norm(dim=-1)
    diff, err = rows(masked)
    return {"max_abs": float(diff.abs().max()),
            "one_bf16_step_at_max": 2.0 ** (math.floor(math.log2(float(ref.abs().max()))) - 7),
            "row": float(err.max()), "ignored_median_row": float(rows(unmasked)[1].median()),
            "masked_launches": launched}


def bert_pretrain(torch, args, timer, gen, device="cuda", cfg=None, B=BERT_PT_B, T=BERT_PT_T,
                  valid=BERT_PT_VALID):
    """(b) BertForPretraining(BertConfig(attention_dropout=0.0)), bf16
    through AMP over f32 master weights (``cast_params=False``), B 8, T
    512, no key mask, LAMB at 1e-3 through ``TrainStep``, BERT_PT_STEPS
    steps. First K1 and K2 at its attention shape (B 8, 12 heads of 64, T
    512, not causal, bf16) against their plain versions and beside SDPA.
    Gates: finite losses, the last below the first; K1 and K2 each once a
    layer every step and the plain attention never; an inference forward
    at attention dropout 0.1 launches K1 once a layer and K2 never; a
    right-padded key-masked batch launches neither, and on the f32
    master weights its valid prefix's sequence output equals the truncated
    batch's within one bf16 step at the largest value and BERT_MASK_ROW_TOL
    at every position, while with the mask ignored it does not at most
    positions (``masked_prefix``; the bf16 run is reported). Returns (kernel case, K1 and K2 launches over the steps).
    ``device='cpu'`` (a narrow ``cfg``, no timer) rehearses it."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, autograd, optimizer, parallel
    from mxnet_tpu_torch.models import BertConfig, BertForPretraining
    from mxnet_tpu_torch.ops.int8_gemv import launches, reset_launches
    cfg = cfg or BertConfig(attention_dropout=0.0)
    H, D = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    kern = None
    if timer is not None:
        kern = flash_case(torch, timer, gen, B, H, T, T, D, False, torch.bfloat16, timed=True)
        emit({"nlp_train_bert_flash_case": kern})
        torch.cuda.empty_cache()
    with on(device):
        mx.random.seed(args.seed)
        net = BertForPretraining(cfg)
        net.initialize()
    # bf16 compute over f32 master weights: LAMB's steps (lr 1e-3 of a
    # tensor's norm) are below half a bf16 step of most weights
    amp.convert_hybrid_block(net, "bfloat16", cast_params=False)
    ids, types, mlm, nsp = pretraining_batch(torch, args, cfg, B, T, device)
    step = parallel.TrainStep(net, pretraining_loss(),
                              optimizer.LAMB(learning_rate=BERT_PT_LR), [ids, types])
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, times, counts = [], [], []
    with Counting(plain_attention_targets()) as plain:
        for _ in range(BERT_PT_STEPS):
            sync(torch, device)
            reset_launches()
            t0 = time.perf_counter()
            loss = step((ids, types), (mlm, nsp))
            losses.append(loss.float().item())
            times.append((time.perf_counter() - t0) * 1e3)
            c = launches()
            counts.append({k: c.get(k, 0) for k in ("flash_fwd", "flash_bwd")})
        train_plain = dict(plain.counts)
        peak = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else None
        # inference at the default attention dropout: K1 only
        plain.reset()
        cfg.attention_dropout = 0.1
        reset_launches()
        with autograd.predict_mode(), torch.no_grad():
            net(ids, types)
            infer = {k: launches().get(k, 0) for k in ("flash_fwd", "flash_bwd")}
            infer_plain = dict(plain.counts)
            # a right-padded key mask against the truncated batch: the
            # encoder alone on the f32 master weights (gated), and in bf16
            mask = torch.zeros(B, T, device=device)
            mask[:, :valid] = 1.0
            prefix = {"f32": masked_prefix(torch, net, ids, types, mask, valid)}
            with amp.autocast("bfloat16"):
                prefix["bf16"] = masked_prefix(torch, net, ids, types, mask, valid)
        cfg.attention_dropout = 0.0
    f32 = prefix["f32"]
    ms = statistics.median(times[1:])
    flops = bert_flops(cfg, B, T, mlm=True)
    L = cfg.num_layers
    report = {"model": "bert-base pretraining (MLM + NSP)", "B": B, "T": T,
              "dtype": "bfloat16 compute, f32 master weights", "attention_dropout": 0.0,
              "hidden_dropout": cfg.hidden_dropout, "optimizer": f"lamb lr {BERT_PT_LR}",
              "steps": BERT_PT_STEPS, "losses": losses, "step_ms": times, "ms_per_step": ms,
              "tokens_per_s": B * T / ms * 1e3, "flops_per_step": flops,
              "mfu": flops / (ms / 1e3) / BF16_FLOP_PER_S, "peak_mem_gb": peak,
              "launches_per_step": counts, "plain_attention_calls": train_plain,
              "inference_dropout_0.1_launches": infer,
              "inference_plain_attention_calls": infer_plain,
              "masked_valid": valid, "masked_prefix": prefix, "masked_row_tol": BERT_MASK_ROW_TOL, "device": device}
    emit({"nlp_train_bert_pretrain": report})
    check(all(math.isfinite(x) for x in losses), f"non-finite BERT pretraining loss: {losses}")
    check(losses[-1] < losses[0], f"BERT pretraining loss did not fall: {losses}")
    check(all(c == {"flash_fwd": L, "flash_bwd": L} for c in counts),
          f"K1/K2 not launched {L} times a step: {counts}")
    check(not any(train_plain.values()), f"the plain attention ran: {train_plain}")
    check(infer == {"flash_fwd": L, "flash_bwd": 0} and not any(infer_plain.values()),
          f"inference at attention dropout 0.1: {infer}, plain {infer_plain}")
    for dt, r in prefix.items():
        check(r["masked_launches"] == {"flash_fwd": 0, "flash_bwd": 0},
              f"the key-masked batch launched {r['masked_launches']} ({dt})")
    check(f32["max_abs"] <= f32["one_bf16_step_at_max"] and f32["row"] <= BERT_MASK_ROW_TOL,
          f"masked prefix against the truncated batch (f32): {f32}")
    check(f32["ignored_median_row"] > BERT_MASK_ROW_TOL,
          f"an ignored mask passes the masked-prefix gate at most rows: {f32}")
    del step, net
    return kern, sum(c["flash_fwd"] for c in counts), sum(c["flash_bwd"] for c in counts)


def nlp_pair(torch, args, build, card="cuda"):
    """``build()`` on the CPU from ``--seed`` and its copy on ``card`` (the
    same weights)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.interop import params_from_numpy
    with mx.cpu():
        mx.random.seed(args.seed)
        cpu = build()
        cpu.initialize()
    with on(card):
        net = build()
        net.initialize()
    params_from_numpy(net, {k: p.data().asnumpy() for k, p in cpu.collect_params().items()})
    where = {t.device.type for _, t in net.named_parameters()}
    check(where == {torch.device(card).type}, f"the {card} copy's parameters are on {where}")
    return cpu, net


def nlp_sgd_steps(torch, net, inputs, labels, loss_fn, device):
    """NLP_CPU_STEPS f32 SGD steps (momentum 0.9, SGD_LR) of ``net`` on
    ``device``: (losses, each step's gradients, parameters after, launches)."""
    from mxnet_tpu_torch import optimizer, parallel
    from mxnet_tpu_torch.interop import params_to_numpy
    from mxnet_tpu_torch.ops.int8_gemv import launches, reset_launches
    ins = [torch.from_numpy(a).to(device) for a in inputs]
    lab = [torch.from_numpy(a).to(device) for a in labels]
    losses, grads = [], []
    with on(device):
        step = parallel.TrainStep(net, loss_fn,
                                  optimizer.SGD(learning_rate=SGD_LR, momentum=0.9), ins)
        reset_launches()
        for _ in range(NLP_CPU_STEPS):
            losses.append(step(ins, lab).float().item())
            grads.append(named_grads(torch, net))
        c = launches()
    return losses, grads, params_to_numpy(net), {k: c.get(k, 0) for k in ("flash_fwd",
                                                                        "flash_bwd")}


def nlp_cases(args):
    """(c)'s configurations: (name, builder, inputs, labels, loss, the
    attention route, the launches each step must make)."""
    import numpy as np
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import (T5_TINY, BertConfig, BertForSequenceClassification,
                                        T5Model)
    rng = np.random.RandomState(args.seed + 2)
    B = NLP_CPU_B

    def bert(T, mask, **kw):
        cfg = BertConfig(max_position_embeddings=max(512, T), hidden_dropout=0.1, **NLP_NARROW,
                         **kw)
        ids = rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)
        types = (np.arange(T)[None, :] >= T // 2).repeat(B, 0).astype(np.int32)
        ins = [ids, types]
        if mask:
            m = np.ones((B, T), np.float32)
            m[1, T - T // 3:] = 0.0
            ins.append(m)
        y = rng.randint(0, 2, B).astype(np.int32)
        return lambda: BertForSequenceClassification(cfg, num_classes=2), ins, [y]

    src = rng.randint(2, T5_TINY.vocab_size, (B, 24)).astype(np.int32)
    tgt = src[:, :16]
    dec = np.concatenate([np.zeros((B, 1), np.int32), tgt[:, :-1]], 1)
    L = NLP_NARROW["num_layers"]
    return [("bert_einsum_T288", *bert(288, True, attention_dropout=0.1),
             SoftmaxCrossEntropyLoss(), "einsum, key mask, attention dropout", 0),
            ("bert_kernels_T288", *bert(288, False, attention_dropout=0.0),
             SoftmaxCrossEntropyLoss(), "K1/K2", L),
            ("bert_chunked_T640", *bert(640, True, attention_dropout=0.1),
             SoftmaxCrossEntropyLoss(), "chunked, key mask, attention dropout", 0),
            ("t5_tiny", lambda: T5Model(T5_TINY), [src, dec], [tgt],
             SoftmaxCrossEntropyLoss(axis=-1), "t5 einsums", 0)]


def floored_errors(got, want):
    """{name: |got - want|_2 / max(|want|_2, NLP_GRAD_FLOOR x |all of want|_2)},
    leaf by leaf: the key projection's bias has a gradient of 0 in exact
    arithmetic (a softmax ignores a constant added to a query's scores),
    so both devices' values are rounding noise, which the whole step's
    gradient norm scales."""
    total = math.sqrt(sum(float(w.norm()) ** 2 for w in want.values()))
    return {n: float((got[n] - w).norm()) / max(float(w.norm()), NLP_GRAD_FLOOR * total)
            for n, w in want.items()}


def nlp_card_vs_cpu(torch, args, card="cuda"):
    """(c) f32, card against CPU from the same weights, batch and step keys,
    2 SGD steps each: the narrow BERT on the einsum route with a key mask
    and both dropouts at 0.1 (T 288), on K1/K2 (T 288, no mask, attention
    dropout 0), on the chunked route (T 640, key mask, attention dropout
    0.1), and T5_TINY. Gates: each step's gradients leaf by leaf within
    CARD_CPU_GRAD_TOL (``floored_errors``), the parameters after within
    CARD_CPU_PARAM_TOL, K1
    and K2 launched on the card once a layer a step on the kernel case and
    never on the others."""
    out = {}
    for name, build, inputs, labels, loss_fn, route, per_step in nlp_cases(args):
        cpu, net = nlp_pair(torch, args, build, card)
        lc, gc, pc, nc = nlp_sgd_steps(torch, net, inputs, labels, loss_fn, card)
        lh, gh, ph, _ = nlp_sgd_steps(torch, cpu, inputs, labels, loss_fn, "cpu")
        errs = [worst(floored_errors(a, b)) for a, b in zip(gc, gh)]
        raw = [worst(leaf_errors(a, b)) for a, b in zip(gc, gh)]
        pdiff = max(float(abs(pc[n] - ph[n]).max()) for n in ph)
        out[name] = {"route": route, "T": int(inputs[0].shape[1]),
                     "losses": {"card": lc, "cpu": lh}, "grad_rel_l2_worst_leaf": errs,
                     "grad_rel_l2_unfloored": raw,
                     "max_param_diff": pdiff, "card_launches": nc,
                     "card_launches_want": per_step * NLP_CPU_STEPS}
        del cpu, net
    emit({"nlp_train_card_vs_cpu": {"cases": out, "steps": NLP_CPU_STEPS, "B": NLP_CPU_B,
                                    "narrow_bert": NLP_NARROW,
                                    "tol": {"grad": CARD_CPU_GRAD_TOL,
                                            "param": CARD_CPU_PARAM_TOL}}})
    for name, r in out.items():
        for i, e in enumerate(r["grad_rel_l2_worst_leaf"]):
            check(e["rel_l2"] <= CARD_CPU_GRAD_TOL,
                  f"{name}: card/CPU step-{i + 1} gradients {e} > {CARD_CPU_GRAD_TOL}")
        check(r["max_param_diff"] <= CARD_CPU_PARAM_TOL,
              f"{name}: card/CPU parameters differ by {r['max_param_diff']}")
        want = r["card_launches_want"]
        check(r["card_launches"] == {"flash_fwd": want, "flash_bwd": want},
              f"{name}: card launches {r['card_launches']}, want {want} each")
    return out


def t5_train(torch, args, device="cuda", cfg=None, B=T5_B, S=T5_SRC, T=T5_TGT):
    """(d) T5-small at full width (``T5Config()``), bf16 through AMP, B 16,
    sources of 512 and targets of 128 tokens (a copy batch from
    ``--seed``), Adam at 1e-4 through ``TrainStep``, 5 steps. Gates:
    finite falling losses (cross-entropy over every target position, on
    f32 logits), no K1/K2 launch. ``device='cpu'`` (``T5_TINY``)
    rehearses it."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, optimizer, parallel
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import T5Config, T5Model
    from mxnet_tpu_torch.ops.int8_gemv import launches, reset_launches
    cfg = cfg or T5Config()
    with on(device):
        mx.random.seed(args.seed)
        net = T5Model(cfg)
        net.initialize()
    amp.convert_hybrid_block(net, "bfloat16")
    rng = np.random.RandomState(args.seed + 3)
    src = rng.randint(2, cfg.vocab_size, (B, S)).astype(np.int32)
    tgt = src[:, :T]
    dec = np.concatenate([np.zeros((B, 1), np.int32), tgt[:, :-1]], 1)
    src, dec, tgt = (torch.from_numpy(a).to(device) for a in (src, dec, tgt))
    ce = SoftmaxCrossEntropyLoss(axis=-1)
    step = parallel.TrainStep(net, lambda out, y: ce(out.float(), y),
                              optimizer.Adam(learning_rate=T5_LR), [src, dec])
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, times, counts = [], [], []
    for _ in range(T5_STEPS):
        sync(torch, device)
        reset_launches()
        t0 = time.perf_counter()
        losses.append(step((src, dec), tgt).float().item())
        times.append((time.perf_counter() - t0) * 1e3)
        c = launches()
        counts.append(c.get("flash_fwd", 0) + c.get("flash_bwd", 0))
    ms = statistics.median(times[1:])
    flops = t5_flops(cfg, B, S, T)
    report = {"model": "t5-small" if cfg.d_model == 512 else "t5", "B": B, "source": S,
              "target": T, "dtype": "bfloat16", "optimizer": f"adam lr {T5_LR}",
              "steps": T5_STEPS, "losses": losses, "step_ms": times, "ms_per_step": ms,
              "tokens_per_s": B * (S + T) / ms * 1e3, "flops_per_step": flops,
              "mfu": flops / (ms / 1e3) / BF16_FLOP_PER_S,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9 if device == "cuda"
              else None, "flash_launches_per_step": counts, "device": device}
    emit({"nlp_train_t5": report})
    check(all(math.isfinite(x) for x in losses), f"non-finite T5 loss: {losses}")
    check(losses[-1] < losses[0], f"T5 loss did not fall: {losses}")
    check(not any(counts), f"T5 launched K1/K2: {counts}")
    del step, net
    return report


def optimizers_card_vs_cpu(torch, card="cuda"):
    """(e) Every registered optimizer: 3 eager updates (``Optimizer.update``,
    wd, ``clip_gradient``, ``rescale_grad`` and an lr_mult of 0.5) of one
    f32 and one bf16 tensor on the card and on the CPU from the same
    weights, gradients and seed. Gates: f32 weights and states within
    CARD_CPU_PARAM_TOL of max(1, |CPU value|); bf16 ones within that or
    one bf16 step of the CPU's value (the f32 update rounds once at the
    write-back, and an ulp of f32 difference can cross a bf16 rounding
    boundary);
    SGLD's noise (a zero weight and gradient) bit for bit."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import optimizer as opt_mod
    g = torch.Generator().manual_seed(7)
    w0 = torch.randn(OPT_SHAPE, generator=g)
    grads = [torch.randn(OPT_SHAPE, generator=g) * 2 for _ in range(OPT_STEPS)]
    out = {}
    for name in sorted(opt_mod._REGISTRY):
        row = {}
        for dtype in (torch.float32, torch.bfloat16):
            res = {}
            for dev in (card, "cpu"):
                mx.random.seed(3)
                opt = opt_mod.create(name, **OPT_KW)
                opt.set_lr_mult({0: 0.5})
                w = w0.to(dev, dtype)
                state = opt.create_state(0, w)
                for gr in grads:
                    state = opt.update(0, w, gr.to(dev, dtype), state)
                res[dev] = [w.cpu()] + [s.cpu() for s in state]
            worst_abs, over = 0.0, 0
            for a, b in zip(res[card], res["cpu"]):
                if not a.is_floating_point():
                    over += int((a != b).sum())
                    continue
                d = (a.float() - b.float()).abs()
                worst_abs = max(worst_abs, float(d.max()))
                # relative to max(1, |CPU value|): Ftrl's z state grows to
                # hundreds, where one f32 ulp is 3e-5
                tol = CARD_CPU_PARAM_TOL * b.float().abs().clamp_min(1.0)
                if dtype == torch.bfloat16:
                    # one bf16 step at the CPU's value
                    ulp = torch.exp2(torch.floor(torch.log2(b.float().abs().clamp_min(1e-30)))
                                     - 7)
                    over += int(((d > tol) & (d > ulp)).sum())
                else:
                    over += int((d > tol).sum())
            row[str(dtype).replace("torch.", "")] = {"max_abs": worst_abs, "over_tol": over}
        out[name] = row
    # SGLD's noise alone: a zero weight and gradient step to the noise
    noise = {}
    for dev in (card, "cpu"):
        mx.random.seed(5)
        opt = opt_mod.SGLD(learning_rate=0.01)
        w = torch.zeros(OPT_SHAPE, device=dev)
        state = opt.create_state(0, w)
        opt.update(0, w, torch.zeros_like(w), state)
        noise[dev] = w.cpu()
    out["sgld_noise_bitwise"] = bool(torch.equal(noise[card], noise["cpu"]))
    out["sgld_noise_std"] = float(noise["cpu"].std())
    out["tol"] = {"f32": f"{CARD_CPU_PARAM_TOL} x max(1, |cpu|)",
                  "bf16": "the f32 rule or one bf16 step"}
    emit({"nlp_train_optimizers_card_vs_cpu": out})
    for name in sorted(opt_mod._REGISTRY):
        for dt, r in out[name].items():
            check(r["over_tol"] == 0, f"{name} {dt}: card/CPU differ beyond tolerance: {r}")
    check(out["sgld_noise_bitwise"], "SGLD's noise differs between the card and the CPU")
    return out


def nlp_train(torch, args, timer, gen):
    """Phase 12: BERT and T5 train on the card. (a) bench_bert_base_ft's
    configuration, (b) BERT-base pretraining with LAMB at T 512 through
    K1/K2, (c) card against CPU on every attention route and T5_TINY, (d)
    T5-small, (e) the optimizers card against CPU. Starts only with at
    most LT_HELD_GB still allocated. Returns {"k1": row, "k2": row}: the
    kernels-line rows of K1/K2 at (b)'s shape with their launches in (b)."""
    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated() / 1e9
    emit({"nlp_train_allocated_gb_at_start": held})
    check(held <= LT_HELD_GB, f"{held} GB of device memory still allocated as phase 12 "
          f"starts (> {LT_HELD_GB}): an earlier phase's model or engine was not freed")
    parts = {}

    def part(name, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.empty_cache()
        parts[name] = time.perf_counter() - t
        return out
    part("a", lambda: bert_ft(torch, args))
    kern, n1, n2 = part("b", lambda: bert_pretrain(torch, args, timer, gen))
    part("c", lambda: nlp_card_vs_cpu(torch, args))
    part("d", lambda: t5_train(torch, args))
    part("e", lambda: optimizers_card_vs_cpu(torch))
    emit({"nlp_train_s": time.perf_counter() - t_phase, "parts_s": parts})
    rows = {}
    for key, pre, n in (("k1", "k1_", n1), ("k2", "k2_", n2)):
        rows[key] = {"max_abs_err": kern[pre + "max_abs_err"], "ms": kern[pre + "ms"],
                     "plain_ms": kern[pre + "plain_ms"], "bound_ms": kern[pre + "bound_ms"],
                     "bound_by": kern[pre + "bound_by"],
                     "library_ms": kern[pre + "library_ms"], "launches": n}
    return rows


def llama_train_stacked(torch, args, net):
    """(b) The stacked decoder at the same width and LT_STACKED_LAYERS
    layers from the same weights (``net``'s first layers, embedding, norm
    and head) against the per-layer decoder: step-1 loss and gradients,
    leaf by leaf (the stacked [layers, ...] gradients against the per-layer
    ones stacked), within LT_STACKED_GRAD_TOL; the losses within one bf16
    step. ``net`` has taken (a)'s 6 Adam steps, so the loss is far from
    ln(vocab)."""
    from mxnet_tpu_torch import optimizer, parallel
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import LlamaForCausalLM
    per_layer = copy_llama(torch, net, LlamaForCausalLM(
        llama_config(torch, LT_STACKED_LAYERS), device="cuda"))
    stacked = stack_llama(torch, per_layer)
    ids, labels = train_batch(args, net.cfg.vocab_size, LT_B, LT_T)
    ids, labels = torch.from_numpy(ids).to("cuda"), torch.from_numpy(labels).to("cuda")
    out, grads = {}, {}
    for name, model in (("per_layer", per_layer), ("stacked", stacked)):
        step = parallel.TrainStep(model, SoftmaxCrossEntropyLoss(axis=-1),
                                  optimizer.SGD(learning_rate=0.0), [ids])
        out[name + "_loss"] = step(ids, labels).float().item()
        grads[name] = named_grads(torch, model)
        del step
    g = grads["per_layer"]
    want = {f"model.layers.{n}": torch.stack([g[f"model.layers.{i}.{path}"]
                                              for i in range(LT_STACKED_LAYERS)])
            for n, path in STACKED_PARTS.items()}
    want.update({n: g[n] for n in ("model.embed_tokens.weight", "model.norm.gamma",
                                   "lm_head.weight")})
    errs = leaf_errors(grads["stacked"], want)
    # one bf16 step at the loss's value: the smallest gap its dtype shows
    ulp = 2.0 ** (math.floor(math.log2(abs(out["per_layer_loss"]))) - 7)
    out.update({"layers": LT_STACKED_LAYERS, "loss_gap": abs(out["stacked_loss"]
                                                             - out["per_layer_loss"]),
                "loss_tol": ulp, "grad_rel_l2": worst(errs), "grad_tol": LT_STACKED_GRAD_TOL})
    emit({"llama_train_stacked": out})
    check(out["loss_gap"] <= ulp, f"stacked / per-layer step-1 losses {out}")
    check(errs[max(errs, key=errs.get)] <= LT_STACKED_GRAD_TOL, "stacked / per-layer step-1 "
          f"gradients differ: {worst(errs)} > {LT_STACKED_GRAD_TOL}")
    return out


# ------------------------------------------------------------ phase 13: fleet
FLEET_SLOTS = 4                   # slots of every replica of the phase
FLEET_MAX_LEN = 384               # K6: f32 pools at head dim 64, page 16 (K6 takes L <= 432)
FLEET_LONG_LEN = 1024             # K7
FLEET_NEW = 32                    # new tokens of (a), (b), (c) and (e)
FLEET_PREFIX = 32                 # (a): each family's shared prefix (two pages)
FLEET_FAMILIES = 4                # (a): prompt families of three requests each
FLEET_MIGRATE = (256, 640)        # (b): prompt lengths, on K6 and on K7 replicas
FLEET_RESCUE = dict(pages=24, prompts=4, prompt_len=100, new=64)   # (d)
FLEET_BURST = 8                   # (f): requests of each burst; (g): 3x per tenant
FLEET_AFFINITY_LOAD = 4.0         # the router's affinity load bound (a replica's slots)
FLEET_EXACT_LEN = 64              # the paged gate: tokens equal up to this prompt length
FLEET_HOP_ROUNDS = 3              # (a): rounds of http_serve's request shape, each side
FLEET_DEADLINE = 600.0


def card_tag(torch):
    """``name, power limit`` of the card as nvidia-smi gives them (every
    fleet number carries it); "cpu" for a CPU rehearsal."""
    if not torch.cuda.is_available():
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def fleet_engine(net, max_len=FLEET_MAX_LEN, slots=FLEET_SLOTS, **kw):
    """A started, warmed fleet replica: the paged int8 engine with fused
    decode (K6 or K7 by ``max_len``, K8 for every decode token at
    ``multi_token=4``) and an advert wide enough for the phase."""
    from mxnet_tpu_torch.serve import InferenceEngine
    eng = InferenceEngine(net, max_batch_size=slots, max_len=max_len, multi_token=4,
                          fused=True, paged=True, page_size=16, prefix_advert=64, **kw)
    eng.start()
    warm(eng)
    return eng


def engine_launches(eng):
    """This engine's launches so far ({"kinds", "lanes", "routes"}): every
    built step's calls times its launch records (the process-wide counters
    mix every replica of the process)."""
    out = {"kinds": {}, "lanes": {}, "routes": {}}
    for step in list(eng._steps.values()) + list(eng._chunks.values()):
        for key in out:
            for k, n in getattr(step.tally, key).items():
                out[key][k] = out[key].get(k, 0) + n * step.calls
    return out


def launches_since(eng, before):
    now = engine_launches(eng)
    return {key: {k: n - before[key].get(k, 0) for k, n in now[key].items()
                  if n - before[key].get(k, 0)} for key in now}


def merge_launches(*windows):
    """The sum of launch windows (``launches_since`` dicts)."""
    out = {"kinds": {}, "lanes": {}, "routes": {}}
    for w in windows:
        for key in out:
            for k, n in w[key].items():
                out[key][k] = out[key].get(k, 0) + n
    return out


def chunked_top2(torch, net, tokens, max_len):
    """(top-1 minus top-2 logit, top-1 logit) after ``tokens`` prefilled in
    16-token chunks as the paged engine prefills them."""
    with torch.no_grad():
        hidden, last = prefill_chunks(torch, net, tokens, 16, net.new_caches(1, max_len))
        top = torch.topk(net._lm_head(hidden)[0, last].float(), 2).values
    return (top[0] - top[1]).item(), top[0].item()


def fleet_hold(torch, net, prompt, got, want, what, sampled, max_len):
    """The paged gate of a fleet request against its reference: the same
    tokens, or, for a greedy request of a prompt longer than
    FLEET_EXACT_LEN, a first divergence at a top-2 gap below ``gap_limit``
    (1e-3 for f32) after the reference's tokens; a sampled request must be
    equal (stateless sampling on batch-invariant kernels)."""
    d = first_divergence(want, got)
    row = {"prompt": len(prompt), "sampled": sampled, "equal": d is None}
    check(len(got) == len(want), f"{what}: {len(got)} tokens, the reference {len(want)}")
    if d is not None:
        check(not sampled, f"{what}: sampled tokens differ from the reference at {d}")
        check(len(prompt) > FLEET_EXACT_LEN,
              f"{what}: tokens of a {len(prompt)}-token prompt differ from the reference at {d}")
        gap, top = chunked_top2(torch, net, list(prompt) + list(want[:d]), max_len)
        limit = gap_limit(torch, net, top)
        row.update(first_divergence=d, top2_gap=gap, gap_limit=limit)
        check(gap < limit, f"{what}: tokens differ from the reference at {d}, top-2 gap {gap}")
    return row


def fleet_reference(ref, prompts, new, temps, seeds):
    """The reference engine's tokens, one request at a time."""
    out = []
    for p, t, s in zip(prompts, temps, seeds):
        r = ref.submit(p, new, temperature=t, seed=s).result(FLEET_DEADLINE)
        check(r.ok, f"fleet reference: {r.status} {r.error}")
        out.append(r.generated_ids)
    return out


def wait_root(router, prompt, timeout=30.0):
    """Wait until some backend's advert, as the router sees it, holds a root
    of ``prompt``."""
    from mxnet_tpu_torch.serve.paging import prefix_key
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for b in list(router._backends.values()):
            for key, ln in (b.prefix_summary or ()):
                if ln <= len(prompt) and prefix_key(prompt[:ln]) == key:
                    return b.url
        time.sleep(0.02)
    raise SmokeFailure("fleet: a prefix advert never reached the router")


def metric(name, labels=None):
    from mxnet_tpu_torch import metrics
    return metrics.get_sample_value(name, labels) or 0.0


def fleet_hop(eng, front, payloads, client):
    """Seconds of ``payloads`` posted to ``front`` (the engine's own
    frontend) from the threads of ``client`` and submitted to ``eng`` in
    process from the same threads, each thread waiting for its request
    before the next (as ``http_serve`` times them): one untimed HTTP round
    first, which leaves both sides the same prefix cache, then in process,
    HTTP, HTTP, in process. Every request must succeed."""
    def http():
        docs = http_post_all(front.url, payloads, client)
        check(all(c == 200 and d["status"] == "ok" for c, d in docs),
              "fleet (a): a replica HTTP request failed")

    def in_process():
        res = list(client.map(lambda p: eng.submit(
            p["input_ids"], p["max_new_tokens"], temperature=p.get("temperature", 0.0),
            seed=p.get("seed", 0)).result(FLEET_DEADLINE), payloads))
        check(all(r.ok for r in res), "fleet (a): an in-process request failed")

    http()
    out = {"http_s": [], "in_process_s": []}
    for key, fn in (("in_process_s", in_process), ("http_s", http), ("http_s", http),
                    ("in_process_s", in_process)):
        t0 = time.perf_counter()
        fn()
        out[key].append(time.perf_counter() - t0)
    tokens = sum(p["max_new_tokens"] for p in payloads)
    out.update(requests=len(payloads), tokens=tokens,
               http_tokens_per_s=[tokens / t for t in out["http_s"]],
               in_process_tokens_per_s=[tokens / t for t in out["in_process_s"]],
               http_over_in_process=sum(out["in_process_s"]) / sum(out["http_s"]))
    return out


def frontend_with_backlog(eng, backlog):
    """A started ``HTTPFrontend`` of ``eng`` whose socket listens with
    ``backlog`` (the port's frontends listen with
    ``BurstHTTPServer.request_queue_size``)."""
    from mxnet_tpu_torch.serve import http
    was = http.BurstHTTPServer.request_queue_size
    http.BurstHTTPServer.request_queue_size = backlog
    try:
        return http.HTTPFrontend(eng, port=0).start()
    finally:
        http.BurstHTTPServer.request_queue_size = was


def backlog_probe(url, payloads, client, in_process_s):
    """A measurement of a listen backlog, not a gate: ``payloads`` posted
    to ``url`` from the threads of ``client``, twice; per run its seconds
    and the requests that failed at the transport (a backlog that
    overflows drops handshakes and may reset connections); tokens/s over
    the requests answered, and their ratio to ``in_process_s`` (seconds of
    the same requests in process)."""
    def post(p):
        try:
            code, doc = http_json(url, "/generate", p)
        except OSError:
            return 0
        return len(doc["generated_ids"]) if code == 200 else 0

    out = {"http_s": [], "failed": [], "http_tokens_per_s": []}
    for _ in range(2):
        t0 = time.perf_counter()
        got = list(client.map(post, payloads))
        out["http_s"].append(time.perf_counter() - t0)
        out["failed"].append(sum(1 for n, p in zip(got, payloads)
                                 if n != p["max_new_tokens"]))
        out["http_tokens_per_s"].append(sum(got) / out["http_s"][-1])
    out["http_over_in_process"] = (sum(in_process_s) / len(in_process_s)
                                   / (sum(out["http_s"]) / len(out["http_s"])))
    return out


def fleet_affinity(torch, args, net, ref, reps, fronts, pool):
    """(a) Two replicas behind a ``Router(affinity=True)`` and its
    ``RouterFrontend``: FLEET_FAMILIES prompt families (a FLEET_PREFIX-token
    prefix and 8-32 own tokens, at most 64 tokens), three requests each,
    greedy and at T 0.8, alternately over JSON ``/generate`` and SSE; each
    family's first request alone, the other two concurrently once an advert
    holds the prefix; then the same requests and 4 more at once through the
    router (its tokens/s). Every request holds ``fleet_hold`` against the
    reference engine; affinity hit tokens > 0; K6 and K8 launched on both
    replicas in this window (the part's fleet launches); no request failed.
    Then, the router stopped (no ``/healthz`` polls), ``fleet_hop`` on
    replica A at the router burst's shape and at ``http_serve``'s
    (FLEET_HOP_ROUNDS rounds of 10 prompts of 8-48 tokens, 8 greedy and 2
    at T 0.8, HTTP_NEW new tokens, from 8 threads), and at the burst's
    shape once more through a frontend of A that listens with the
    standard library's backlog of 5 (``backlog_probe``)."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor

    from mxnet_tpu_torch.serve import Router, RouterFrontend
    rng = np.random.RandomState(args.seed + 31)
    vocab = net.cfg.vocab_size
    fams = [rng.randint(0, vocab, FLEET_PREFIX).tolist() for _ in range(FLEET_FAMILIES)]
    reqs = []
    for j in range(3):
        for f, pre in enumerate(fams):
            i = len(reqs)
            reqs.append({"input_ids": pre + rng.randint(0, vocab, int(rng.randint(8, 33))).tolist(),
                         "max_new_tokens": FLEET_NEW, "temperature": 0.8 if i % 2 else 0.0,
                         "seed": 3000 + i, "stream": i % 3 == 1, "round": j})
    want = fleet_reference(ref, [r["input_ids"] for r in reqs], FLEET_NEW,
                           [r["temperature"] for r in reqs], [r["seed"] for r in reqs])
    router = Router([f.url for f in fronts], health_interval=0.05, affinity=True,
                    affinity_max_load=FLEET_AFFINITY_LOAD).start()
    rf = RouterFrontend(router, port=0).start()
    before = [engine_launches(e) for e in reps]
    hits0 = metric("mxnet_cache_affinity_hit_tokens_total")

    def send(r):
        payload = {k: v for k, v in r.items() if k not in ("stream", "round")}
        if r["stream"]:
            toks, done = http_sse(rf.url, dict(payload, stream=True))
            check(done is not None and done.get("status") == "ok",
                  f"fleet (a): SSE request ended {done}")
            check(toks == done["generated_ids"], "fleet (a): SSE frames != the done document")
            return toks
        code, doc = http_json(rf.url, "/generate", payload)
        check(code == 200 and doc.get("status") == "ok", f"fleet (a): {code} {doc}")
        return doc["generated_ids"]

    burst = [{k: v for k, v in r.items() if k not in ("stream", "round")}
             for r in reqs + reqs[:4]]
    try:
        got = [None] * len(reqs)
        for i, r in enumerate(reqs[:FLEET_FAMILIES]):
            got[i] = send(r)
        for r in reqs[:FLEET_FAMILIES]:
            wait_root(router, r["input_ids"])
        rest = list(range(FLEET_FAMILIES, len(reqs)))
        for i, toks in zip(rest, pool.map(lambda i: send(reqs[i]), rest)):
            got[i] = toks
        stats = router.stats()
        t0 = time.perf_counter()
        docs = http_post_all(rf.url, burst, pool)
        t_router = time.perf_counter() - t0
        check(all(c == 200 and d["status"] == "ok" for c, d in docs),
              "fleet (a): a router burst request failed")
        per = [launches_since(e, b) for e, b in zip(reps, before)]
    finally:
        rf.stop()
        router.stop()
    hop_burst = fleet_hop(reps[0], fronts[0], burst, pool)
    front5 = frontend_with_backlog(reps[0], 5)
    try:
        hop_backlog5 = backlog_probe(front5.url, burst, pool, hop_burst["in_process_s"])
    finally:
        front5.stop()
    prompts = [rng.randint(0, vocab, int(n)).tolist() for n in rng.randint(8, 49, 10)]
    shape14 = [{"input_ids": p, "max_new_tokens": HTTP_NEW,
                **({"temperature": 0.8, "seed": 1400 + i} if i >= 8 else {})}
               for i, p in enumerate(prompts)] * FLEET_HOP_ROUNDS
    with ThreadPoolExecutor(max_workers=8) as client:
        hop14 = fleet_hop(reps[0], fronts[0], shape14, client)
    rows = [fleet_hold(torch, net, r["input_ids"], g, w, f"fleet (a) request {i}",
                       r["temperature"] > 0, FLEET_MAX_LEN)
            for i, (r, g, w) in enumerate(zip(reqs, got, want))]
    for n, p in zip("AB", per):
        for kind in ("fused_block_paged", "fused_head"):
            check(p["kinds"].get(kind, 0) > 0, f"fleet (a): {kind} never launched on replica {n}")
    hit_tokens = metric("mxnet_cache_affinity_hit_tokens_total") - hits0
    check(hit_tokens > 0, "fleet (a): no affinity hit")
    tokens = FLEET_NEW * len(burst)
    out = {"requests": len(reqs), "prompt_tokens": [len(r["input_ids"]) for r in reqs],
           "new_tokens_each": FLEET_NEW, "affinity_hit_tokens": hit_tokens,
           "affinity_outcomes": {o: metric("mxnet_cache_affinity_dispatch_total",
                                           {"outcome": o}) for o in ("hit", "load_bounded",
                                                                     "cold")},
           "router": {k: stats[k] for k in ("dispatches", "retries", "ejects", "rebalances")},
           "per_replica_submitted": {n: e.stats()["submitted"] for n, e in zip("AB", reps)},
           "launches_per_replica": {n: p["kinds"] for n, p in zip("AB", per)},
           "rows": rows, "all_equal": all(r["equal"] for r in rows),
           "burst_requests": len(burst), "router_tokens_per_s": tokens / t_router,
           "router_over_in_process": (sum(hop_burst["in_process_s"])
                                      / len(hop_burst["in_process_s"]) / t_router),
           "hop_burst": hop_burst, "hop_burst_backlog5": hop_backlog5,
           "hop_http_serve_shape": hop14,
           "fleet_launches": merge_launches(*per)}
    emit({"fleet_a": {k: v for k, v in out.items() if k != "fleet_launches"}})
    return out


def tamper(doc, key_page, shape_page):
    """A copy of a wire doc with one page's chain key flipped and another
    page's first payload cut to half its rows (a consistent doc of the wrong
    shape)."""
    import base64
    import copy
    bad = copy.deepcopy(doc)
    bad["pages"][key_page]["key"] ^= 1
    arr = bad["pages"][shape_page]["payload"][0]
    raw = base64.b64decode(arr["data"])
    arr["data"] = base64.b64encode(raw[:len(raw) // 2]).decode()
    arr["shape"] = arr["shape"][:2] + [arr["shape"][2] // 2] + arr["shape"][3:]
    return bad


def fleet_migrate(torch, args, net, src, dst, fsrc, fdst, label, prompt_len, max_len,
                  tampered=False):
    """One migration: ``src`` serves a fresh prompt of ``prompt_len`` tokens
    (its tokens are the reference), ``migrate_prefix`` ships its cached full
    pages over HTTP to ``dst``, which then serves the prompt. Gates: every
    shipped page adopted, ``dst``'s prefill only the unadopted tail, the
    tokens within ``fleet_hold``, the block kernel (K6, or K7 past its gate)
    launched on ``dst`` over the imported pages, ``dst``'s captures
    unchanged. The part's fleet launches are ``dst``'s over the import and
    its request (the source's own prefill and decode are not counted).
    ``tampered``: a doc with one wrong chain key and one wrong
    shape, into ``dst`` with its prefix cache emptied: both counted in
    ``mxnet_migrate_verify_failures_total``, neither written."""
    import numpy as np

    from mxnet_tpu_torch.serve import migrate_prefix
    rng = np.random.RandomState(args.seed + 41 + prompt_len)
    prompt = rng.randint(0, net.cfg.vocab_size, prompt_len).tolist()
    kind = "fused_block_paged_dma" if max_len > 432 else "fused_block_paged"
    s0 = src.stats()
    ra = src.submit(prompt, FLEET_NEW, seed=7).result(FLEET_DEADLINE)
    s1 = src.stats()
    check(ra.ok, f"fleet {label}: source request {ra.status} {ra.error}")
    d0, l0 = dst.stats(), engine_launches(dst)
    t0 = time.perf_counter()
    summary = migrate_prefix(fsrc.url, fdst.url, prompt)
    t_mig = time.perf_counter() - t0
    doc = src.export_pages(prompt)
    n = len(doc["pages"])
    check(n == (prompt_len - 1) // 16, f"fleet {label}: {n} pages shipped")
    check(summary["received"] == summary["adopted"] == n and not summary["verify_failures"],
          f"fleet {label}: import {summary}")
    d1 = dst.stats()
    rb = dst.submit(prompt, FLEET_NEW, seed=7).result(FLEET_DEADLINE)
    d2 = dst.stats()
    check(rb.ok, f"fleet {label}: migrated request {rb.status} {rb.error}")
    saved = d2["pages"]["prefix_tokens_saved"] - d1["pages"]["prefix_tokens_saved"]
    chunks = d2["prefill_chunks"] - d1["prefill_chunks"]
    check(saved == 16 * n and chunks == -(-(prompt_len - 16 * n) // 16),
          f"fleet {label}: prefill of {chunks} chunks after {saved} tokens mapped")
    row = fleet_hold(torch, net, prompt, rb.generated_ids, ra.generated_ids,
                     f"fleet {label}", False, max_len)
    per = launches_since(dst, l0)
    check(per["kinds"].get(kind, 0) > 0, f"fleet {label}: {kind} never launched on the target")
    check(d2["captures"] == d0["captures"],
          f"fleet {label}: captures {d0['captures']} -> {d2['captures']} across the import")
    dtypes = sorted({a["dtype"] for p in doc["pages"] for a in p["payload"]})
    out = {"prompt": prompt_len, "max_len": max_len, "kernel": kind, "pages": n,
           "import": summary, "wire_dtypes": dtypes,
           "wire_bytes_per_page": len(json.dumps(doc)) / n,
           "payload_bytes_per_page": sum(p.numel() * p.element_size() for p in src._pools)
           // src._pools[0].shape[src._paxes[0]],
           "ms_per_migrated_page": t_mig / n * 1e3, "migrate_s": t_mig,
           "source_prefill_ms": (s1["prefill_s"] - s0["prefill_s"]) * 1e3,
           "target_prefill_ms": (d2["prefill_s"] - d1["prefill_s"]) * 1e3,
           "target_prefill_chunks": chunks, "prefix_tokens_mapped": saved,
           "fleet_launches": per, "captures": [d0["captures"], d2["captures"]], **row}
    out["prefill_ms_saved"] = out["source_prefill_ms"] - out["target_prefill_ms"]
    if tampered:
        bad = tamper(doc, 2, 5)
        dst._pages.clear_prefix_cache()
        f0 = metric("mxnet_migrate_verify_failures_total")
        res = dst.import_pages(bad)
        failures = metric("mxnet_migrate_verify_failures_total") - f0
        held = dst.stats()["pages"]["pages_cached_only"]
        check(res["verify_failures"] == 2 and failures == 2 and res["adopted"] == n - 2
              and held == n - 2,
              f"fleet {label}: tampered import {res}, {failures} counted, {held} pages held")
        out["tampered"] = {"import": res, "counted": failures, "pages_held": held}
    return out


def fleet_rescue(torch, args, net, ref, peer):
    """(d) Preemption rescue: a replica with a FLEET_RESCUE["pages"]-page
    pool and no prefix cache takes FLEET_RESCUE["prompts"] greedy requests
    that need more, with ``install_preempt_rescue`` pointing at ``peer``:
    preemptions ship the victims' pages and resume them there. Every output
    holds ``fleet_hold`` against the reference engine, and
    ``mxnet_migrate_rescues_total{outcome=resumed}`` grows. The part's
    fleet launches: the victim's after its warm-up and the peer's over the
    rescue."""
    import numpy as np

    from mxnet_tpu_torch.serve import install_preempt_rescue
    c = FLEET_RESCUE
    rng = np.random.RandomState(args.seed + 51)
    prompts = [rng.randint(0, net.cfg.vocab_size, c["prompt_len"]).tolist()
               for _ in range(c["prompts"])]
    want = fleet_reference(ref, prompts, c["new"], [0.0] * len(prompts),
                           range(len(prompts)))
    victim = fleet_engine(net, num_pages=c["pages"], prefix_cache=False)
    install_preempt_rescue(victim, [peer])
    r0 = metric("mxnet_migrate_rescues_total", {"outcome": "resumed"})
    p0 = peer.stats()["submitted"]
    before = [engine_launches(e) for e in (victim, peer)]
    try:
        hs = [victim.submit(p, c["new"], seed=i) for i, p in enumerate(prompts)]
        res = [h.result(FLEET_DEADLINE) for h in hs]
        vst = victim.stats()
        window = merge_launches(*[launches_since(e, b)
                                  for e, b in zip((victim, peer), before)])
    finally:
        victim.shutdown(drain=True, timeout=FLEET_DEADLINE)
    rescued = metric("mxnet_migrate_rescues_total", {"outcome": "resumed"}) - r0
    for i, r in enumerate(res):
        check(r.ok, f"fleet (d) request {i}: {r.status} {r.error}")
    check(vst["preemptions"] > 0 and rescued > 0,
          f"fleet (d): {vst['preemptions']} preemptions, {rescued} rescues")
    rows = [fleet_hold(torch, net, p, r.generated_ids, w, f"fleet (d) request {i}", False,
                       FLEET_MAX_LEN)
            for i, (p, r, w) in enumerate(zip(prompts, res, want))]
    out = {**c, "preemptions": vst["preemptions"], "rescued": rescued,
           "peer_requests": peer.stats()["submitted"] - p0,
           "failed_rescues": metric("mxnet_migrate_rescues_total", {"outcome": "failed"}),
           "rows": rows}
    emit({"fleet_d": out})
    return dict(out, fleet_launches=window)


def fleet_tiers(torch, args, net, ref, reps, fronts):
    """(e) ``PrefillDecodePipeline`` over the prefill replica (A) and the
    decode replica (B) by URL: 3 greedy requests of 100-200 tokens, each
    prefilled on A, its pages streamed to B, decoded on B; the tokens hold
    ``fleet_hold`` against the reference engine, pages streamed, B's prefix
    hits grow. The part's fleet launches: A's and B's over the pipeline."""
    import numpy as np

    from mxnet_tpu_torch.serve import PrefillDecodePipeline
    rng = np.random.RandomState(args.seed + 61)
    prompts = [rng.randint(0, net.cfg.vocab_size, int(n)).tolist()
               for n in rng.randint(100, 201, 3)]
    want = fleet_reference(ref, prompts, FLEET_NEW, [0.0] * 3, range(3))
    pipe = PrefillDecodePipeline([fronts[0].url], [fronts[1].url], timeout=FLEET_DEADLINE)
    h0 = reps[1].stats()["pages"]["prefix_hits"]
    before = [engine_launches(e) for e in reps]
    t0 = time.perf_counter()
    docs = [pipe.generate({"input_ids": p, "max_new_tokens": FLEET_NEW, "seed": i})
            for i, p in enumerate(prompts)]
    wall = time.perf_counter() - t0
    window = merge_launches(*[launches_since(e, b) for e, b in zip(reps, before)])
    for i, d in enumerate(docs):
        check(d.get("status") == "ok", f"fleet (e) request {i}: {d}")
    st = pipe.stats()
    hits = reps[1].stats()["pages"]["prefix_hits"] - h0
    check(st["pages_streamed"] > 0 and hits >= len(prompts),
          f"fleet (e): {st['pages_streamed']} pages streamed, {hits} prefix hits")
    rows = [fleet_hold(torch, net, p, d["generated_ids"], w, f"fleet (e) request {i}", False,
                       FLEET_MAX_LEN) for i, (p, d, w) in enumerate(zip(prompts, docs, want))]
    out = {"prompts": [len(p) for p in prompts], "pages_streamed": st["pages_streamed"],
           "decode_prefix_hits": hits, "wall_s": wall, "rows": rows}
    emit({"fleet_e": out})
    return dict(out, fleet_launches=window)


def fleet_autoscale(torch, args, net, ref, pool):
    """(f) A ``FleetController`` over an ``InProcessSpawner`` of 2-slot
    replicas (each warmed as it spawns, while the others serve) behind a
    ``Router``: a burst of FLEET_BURST requests scales the fleet 1 -> 2; a
    second burst, JSON and SSE, is in the replicas' queues when the
    controller (its policy swapped for one that wants fewer replicas)
    drains one: the drain-bounced requests replay on the survivor, the
    drained replica retires, 2 -> 1. Zero failed requests, every output
    holds ``fleet_hold`` against the reference engine, every SSE stream
    delivers each token index once, and at least one request bounced. The
    part's fleet launches: each replica's after its warm-up."""
    import numpy as np

    from mxnet_tpu_torch.serve import (AutoscalePolicy, FleetController, InProcessSpawner,
                                       Router)
    rng = np.random.RandomState(args.seed + 71)
    new = 2 * FLEET_NEW
    prompts = [rng.randint(0, net.cfg.vocab_size, int(n)).tolist()
               for n in rng.randint(16, 65, 2 * FLEET_BURST)]
    want = fleet_reference(ref, prompts, new, [0.0] * len(prompts), range(len(prompts)))
    warmed = []             # (replica, its launches at the end of its warm-up)

    def build():
        eng = fleet_engine_unstarted(net)
        warmup = eng.warmup

        def warm_and_mark():
            warmup()
            warmed.append((eng, engine_launches(eng)))
        eng.warmup = warm_and_mark
        return eng

    spawner = InProcessSpawner(build, warmup=True)
    router = Router([spawner.spawn()], health_interval=0.05).start()
    up = AutoscalePolicy(scale_up_load=0.6, scale_down_load=0.1, up_after=1, down_after=1,
                         cooldown_s=0.0, min_replicas=1, max_replicas=2,
                         drain_grace_s=FLEET_DEADLINE, refresh_slo=False)
    ctl = FleetController(router, spawner, policy=up)
    engines = lambda: {u: spawner._replicas[u][0] for u in spawner.urls()}  # noqa: E731

    def run(i, stream):
        payload = {"input_ids": prompts[i], "max_new_tokens": new, "seed": i}
        if stream:
            frames = list(router.generate_stream(payload))
            toks = [json.loads(f.split(b"data: ", 1)[1])["token"] for f in frames
                    if f.startswith(b"event: token")]
            idx = [json.loads(f.split(b"data: ", 1)[1])["index"] for f in frames
                   if f.startswith(b"event: token")]
            done = json.loads(frames[-1].split(b"data: ", 1)[1])
            check(idx == list(range(len(toks))), f"fleet (f) stream {i}: token indices {idx}")
            return done.get("status"), toks
        doc = router.generate(payload)
        return doc.get("status"), doc.get("generated_ids")

    sizes, events = [len(spawner.urls())], []
    try:
        futs = [pool.submit(run, i, False) for i in range(FLEET_BURST)]
        deadline = time.monotonic() + FLEET_DEADLINE
        while not events and time.monotonic() < deadline:
            ev = ctl.tick()
            if ev is not None:
                events.append(ev)
            time.sleep(0.02)
        check(events and events[0]["direction"] == "up", f"fleet (f): no scale-up: {events}")
        got = [f.result(FLEET_DEADLINE) for f in futs]
        sizes.append(len(spawner.urls()))
        deadline = time.monotonic() + 30
        while router.stats()["healthy"] < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        retries0, bounced0 = router.stats()["retries"], metric_sum(
            "mxnet_router_ejects_total", "draining")
        futs = [pool.submit(run, i, i % 2 == 1) for i in range(FLEET_BURST, 2 * FLEET_BURST)]
        # drain once both replicas hold queued requests (or the burst ended:
        # then the bounce gate below fails)
        deadline = time.monotonic() + 60
        while (time.monotonic() < deadline and not all(f.done() for f in futs) and not
               all(e.stats()["queue_depth"] > 0 for e in engines().values())):
            time.sleep(0.002)
        ctl.policy = AutoscalePolicy(scale_up_load=100.0, scale_down_load=50.0, up_after=1,
                                     down_after=1, cooldown_s=0.0, min_replicas=1,
                                     max_replicas=2, drain_grace_s=FLEET_DEADLINE,
                                     refresh_slo=False)
        t_drain = time.perf_counter()
        ev = ctl.tick()
        check(ev is not None and ev["direction"] == "down", f"fleet (f): no scale-down: {ev}")
        events.append(ev)
        got += [f.result(FLEET_DEADLINE) for f in futs]
        deadline = time.monotonic() + FLEET_DEADLINE
        while ctl.stats()["retiring"] and time.monotonic() < deadline:
            ctl.tick()
            time.sleep(0.02)
        drain_s = time.perf_counter() - t_drain
        sizes.append(len(spawner.urls()))
        st = router.stats()
        bounced = metric_sum("mxnet_router_ejects_total", "draining") - bounced0
    finally:
        ctl.stop()
        router.stop()
        spawner.stop_all()
    check(sizes == [1, 2, 1], f"fleet (f): replicas {sizes}")
    check(all(s == "ok" for s, _ in got), f"fleet (f): statuses {[s for s, _ in got]}")
    check(st["retries"] > retries0, "fleet (f): no request bounced off the drained replica")
    rows = [fleet_hold(torch, net, p, toks, w, f"fleet (f) request {i}", False, FLEET_MAX_LEN)
            for i, (p, (_, toks), w) in enumerate(zip(prompts, got, want))]
    out = {"requests": len(prompts), "new_tokens_each": new, "replicas": sizes,
           "events": [{k: e[k] for k in ("direction", "reason", "replicas")} for e in events],
           "spawn_s": events[0]["spawn_s"], "drain_s": drain_s,
           "bounced_replays": st["retries"] - retries0, "drain_ejects": bounced,
           "rows": rows}
    emit({"fleet_f": out})
    return dict(out, fleet_launches=merge_launches(*[launches_since(e, b)
                                                     for e, b in warmed]))


def fleet_engine_unstarted(net):
    """An autoscale replica: 2 slots, otherwise a fleet replica; the spawner
    starts and warms it."""
    from mxnet_tpu_torch.serve import InferenceEngine
    return InferenceEngine(net, max_batch_size=2, max_len=FLEET_MAX_LEN, multi_token=4,
                           fused=True, paged=True, page_size=16)


def metric_sum(name, label_value):
    """Sum of a family's samples whose label values include ``label_value``."""
    from mxnet_tpu_torch import metrics
    fam = metrics.REGISTRY.get(name)
    return sum(metrics.get_sample_value(name, dict(zip(fam.labelnames, lv))) or 0.0
               for lv in list(fam._children) if label_value in lv)


def fleet_tenants(torch, args, net, reps, fronts, pool):
    """(g) Tenants. A ``Router`` over both replicas with tenants weighted 3
    (gold) : 1 (bronze) and 3 x FLEET_BURST requests each, interleaved: once
    half the requests are admitted, gold holds the larger share. A second
    router with a tenant capped at one request in flight and a 0.2 s
    admission timeout, behind a ``RouterFrontend``: of FLEET_BURST
    concurrent requests some answer 429 and exactly those are counted in
    ``mxnet_fleet_tenant_rejected_total``; the others succeed. The part's
    fleet launches: both replicas' over both routers' requests."""
    import numpy as np

    from mxnet_tpu_torch.serve import Router, RouterFrontend, TenantPolicy
    rng = np.random.RandomState(args.seed + 81)
    n = 3 * FLEET_BURST
    payloads = [{"input_ids": rng.randint(0, net.cfg.vocab_size, 16).tolist(),
                 "max_new_tokens": FLEET_NEW, "seed": i,
                 "tenant": "gold" if i % 2 == 0 else "bronze"} for i in range(2 * n)]
    before = [engine_launches(e) for e in reps]
    router = Router([f.url for f in fronts], health_interval=0.05,
                    tenants={"gold": TenantPolicy(weight=3.0),
                             "bronze": TenantPolicy(weight=1.0)}).start()
    try:
        deadline = time.monotonic() + 30
        while router.stats()["healthy"] < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        futs = [pool.submit(router.generate, p) for p in payloads]
        mid, deadline = None, time.monotonic() + FLEET_DEADLINE
        while mid is None and time.monotonic() < deadline:
            st = router._tenants.stats()
            if sum(t["dispatched"] for t in st.values()) >= n:
                mid = {t: s["dispatched"] for t, s in st.items()}
            time.sleep(0.001)
        docs = [f.result(FLEET_DEADLINE) for f in futs]
        final = router.stats()["tenants"]
    finally:
        router.stop()
    check(all(d.get("status") == "ok" for d in docs), "fleet (g): a tenant request failed")
    check(mid is not None and mid["gold"] > mid["bronze"],
          f"fleet (g): dispatch shares at half {mid}")
    capped = Router([fronts[0].url], health_interval=0.05,
                    tenants={"capped": TenantPolicy(max_inflight=1)}, tenant_timeout=0.2).start()
    rf = RouterFrontend(capped, port=0).start()
    r0 = metric("mxnet_fleet_tenant_rejected_total", {"tenant": "capped"})
    try:
        deadline = time.monotonic() + 30
        while capped.stats()["healthy"] < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        burst = [dict(p, tenant="capped", max_new_tokens=4 * FLEET_NEW)
                 for p in payloads[:FLEET_BURST]]
        answers = list(pool.map(lambda p: http_json(rf.url, "/generate", p), burst))
    finally:
        rf.stop()
        capped.stop()
    codes = [c for c, _ in answers]
    rejected = metric("mxnet_fleet_tenant_rejected_total", {"tenant": "capped"}) - r0
    check(codes.count(429) > 0 and rejected == codes.count(429)
          and codes.count(200) == len(codes) - codes.count(429),
          f"fleet (g): quota answers {codes}, {rejected} counted")
    out = {"weights": {"gold": 3.0, "bronze": 1.0}, "requests_per_tenant": n,
           "dispatched_at_half": mid, "gold_share_at_half": mid["gold"] / sum(mid.values()),
           "final": {t: s["dispatched"] for t, s in final.items()},
           "quota": {"max_inflight": 1, "timeout_s": 0.2, "codes": codes,
                     "rejected_counted": rejected}}
    emit({"fleet_g": out})
    return dict(out, fleet_launches=merge_launches(*[launches_since(e, b)
                                                     for e, b in zip(reps, before)]))


def fleet_serve(torch, args, net, bf16_net):
    """Phase 13, the serving fleet over paged replicas of int8 GPT-2 small
    (``net``; ``bf16_net`` its bf16 twin for (c)), each behind its own
    ``HTTPFrontend`` in this process, the replicas of a part sharing one
    model. (a) router with prefix affinity, (b) KV-page migration on K6
    and K7 replicas with a tampered doc, (c) (b) on bf16 pools, (d)
    preemption rescue, (e) prefill / decode tiers, (f) autoscale 1 -> 2 ->
    1 with drain-bounce replay, (g) tenants: see each part. The fleet
    path's launches (the kernels line's ``launches_fleet``) are the sum of
    the parts' per-replica windows: the fleet replicas over the parts'
    fleet traffic, without the reference engine, the in-process and direct
    HTTP timings, the migration sources or any warm-up. Returns them as
    {kind: n, "lanes": {...}, "routes": {...}}; ``fleet_numbers`` also
    prints the process-wide counters of the phase (zeroed at its start),
    which hold all of those."""
    from concurrent.futures import ThreadPoolExecutor

    from mxnet_tpu_torch import metrics
    from mxnet_tpu_torch.ops.int8_gemv import dtype_lanes, gemv_routes, launches, reset_launches
    from mxnet_tpu_torch.serve import HTTPFrontend
    t_phase = time.perf_counter()
    tag = card_tag(torch)
    was = metrics.enabled()
    metrics.enable()
    reset_launches()
    ref = fleet_engine(net)
    reps = [fleet_engine(net, tier=t) for t in ("prefill", "decode")]
    fronts = [HTTPFrontend(e, port=0).start() for e in reps]
    pool = ThreadPoolExecutor(max_workers=4 * FLEET_BURST)
    extra = []
    try:
        a = fleet_affinity(torch, args, net, ref, reps, fronts, pool)
        b = {"k6": fleet_migrate(torch, args, net, reps[0], reps[1], fronts[0], fronts[1],
                                 "(b) K6", FLEET_MIGRATE[0], FLEET_MAX_LEN, tampered=True)}
        pair = [fleet_engine(net, max_len=FLEET_LONG_LEN) for _ in range(2)]
        extra += pair
        pf = [HTTPFrontend(e, port=0).start() for e in pair]
        try:
            b["k7"] = fleet_migrate(torch, args, net, pair[0], pair[1], pf[0], pf[1], "(b) K7",
                                    FLEET_MIGRATE[1], FLEET_LONG_LEN)
        finally:
            for f in pf:
                f.stop()
        emit({"fleet_b": b})
        pair16 = [fleet_engine(bf16_net) for _ in range(2)]
        extra += pair16
        pf = [HTTPFrontend(e, port=0).start() for e in pair16]
        try:
            c = fleet_migrate(torch, args, bf16_net, pair16[0], pair16[1], pf[0], pf[1],
                              "(c) bf16", FLEET_MIGRATE[0], FLEET_MAX_LEN)
        finally:
            for f in pf:
                f.stop()
        check(c["wire_dtypes"] == ["bfloat16"], f"fleet (c): wire dtypes {c['wire_dtypes']}")
        if torch.cuda.is_available():
            lanes = c["fleet_launches"]["lanes"]
            bf16_lanes = sum(n for k, n in lanes.items()
                             if k.startswith("fused_block_paged:") and k.endswith("kv_bf16"))
            check(bf16_lanes > 0, f"fleet (c): K6's bf16 lane never ran: {lanes}")
        emit({"fleet_c": c})
        d = fleet_rescue(torch, args, net, ref, reps[1])
        e = fleet_tiers(torch, args, net, ref, reps, fronts)
        f = fleet_autoscale(torch, args, net, ref, pool)
        g = fleet_tenants(torch, args, net, reps, fronts, pool)
    finally:
        pool.shutdown(wait=True)
        for fr in fronts:
            fr.stop()
        for eng in [ref] + reps + extra:
            eng.shutdown(drain=True, timeout=FLEET_DEADLINE)
        if not was:
            metrics.disable()
    fleet = merge_launches(*[part["fleet_launches"]
                             for part in (a, b["k6"], b["k7"], c, d, e, f, g)])
    counts = dict(fleet["kinds"], lanes=fleet["lanes"], routes=fleet["routes"])
    process = dict(launches(), lanes=dtype_lanes(), routes=gemv_routes())
    wall = time.perf_counter() - t_phase
    hop, hop14 = a["hop_burst"], a["hop_http_serve_shape"]
    emit({"fleet_numbers": {
        "card": tag, "phase_s": wall,
        "router_tokens_per_s": a["router_tokens_per_s"],
        "replica_http_tokens_per_s": hop["http_tokens_per_s"],
        "in_process_tokens_per_s": hop["in_process_tokens_per_s"],
        "router_over_in_process": a["router_over_in_process"],
        "replica_http_over_in_process": hop["http_over_in_process"],
        "backlog5": {"replica_http_tokens_per_s": a["hop_burst_backlog5"]["http_tokens_per_s"],
                     "replica_http_over_in_process":
                         a["hop_burst_backlog5"]["http_over_in_process"],
                     "failed_requests": a["hop_burst_backlog5"]["failed"]},
        "http_serve_shape": {"replica_http_tokens_per_s": hop14["http_tokens_per_s"],
                             "in_process_tokens_per_s": hop14["in_process_tokens_per_s"],
                             "replica_http_over_in_process": hop14["http_over_in_process"]},
        "ms_per_migrated_page": {"k6_f32": b["k6"]["ms_per_migrated_page"],
                                 "k7_f32": b["k7"]["ms_per_migrated_page"],
                                 "k6_bf16": c["ms_per_migrated_page"]},
        "wire_bytes_per_page": {"f32": b["k6"]["wire_bytes_per_page"],
                                "bf16": c["wire_bytes_per_page"]},
        "prefill_ms_saved": {"k6_f32": b["k6"]["prefill_ms_saved"],
                             "k7_f32": b["k7"]["prefill_ms_saved"],
                             "k6_bf16": c["prefill_ms_saved"]},
        "spawn_s": f["spawn_s"], "drain_s": f["drain_s"],
        "rescued": d["rescued"], "tiers_pages_streamed": e["pages_streamed"],
        "gold_share_at_half": g["gold_share_at_half"], "launches": counts,
        "process_launches": process}})
    return counts


def llama_kernel_rows(kl, llama):
    """The kernels-line rows of the Llama path at Llama-3-8B's widths
    (kernel_llama_widths' numbers): K3 and K4 per (N, K), x lane (bf16,
    f32) and M (1, 8: warp route; 64: tile route), with the launches of that
    kernel at that route and N in phase 9; K8 over the 128256 x 4096 tied
    head, f32 h and the bf16 lane, int8 and int4, with the launches of each
    lane from phase 9's tied engines. Every row must have launched there."""
    srcs = {"K3": ("int8_gemv", "mxnet_tpu_torch/csrc/int8_gemv.cu",
                   "mxnet_tpu/ops/int8_gemv.py:113", ("serve", "int8")),
            "K4": ("int4_gemv", "mxnet_tpu_torch/csrc/int4_gemv.cu",
                   "mxnet_tpu/ops/int8_gemv.py:186", ("int4",))}
    rows = []
    for kern, (base, src, replaces, parts) in srcs.items():
        for lane_name, res in kl[kern].items():
            for r in res["rows"]:
                if r["M"] not in (1, 8, 64):
                    continue
                key = f"{r['route']}:{r['N']}"
                rows.append({
                    "name": f"{base}_llama_{r['N']}x{r['K']}_{lane_name}_m{r['M']}",
                    "route": "cuda", "source": src, "replaces": replaces,
                    "launches": sum(llama[p]["widths"].get(key, 0) for p in parts),
                    "launches_by": key, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    head_src = "mxnet_tpu_torch/csrc/lm_head_sample.cu"
    for codec, sfx in (("int8", ""), ("int4", "_int4")):
        k8 = kl["K8"][codec]
        for name, r, decoder in ((f"lm_head_sample{sfx}_llama", k8["main"], "per_layer"),
                                 (f"lm_head_sample{sfx}_bf16_llama", k8["lanes"]["bf16"],
                                  "stacked")):
            rows.append({"name": name, "route": "cuda", "source": head_src,
                         "replaces": "mxnet_tpu/ops/fused_block_gemv.py:1218",
                         "launches": llama["tied"][codec][decoder]["k8_lane"]["launches"],
                         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                         "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                         **({"path": K8_BF16_LLAMA_PATH} if decoder == "stacked"
                            else {})})
    for row in rows:
        check(row["launches"] > 0, f"{row['name']} never launched on the Llama path")
    return rows


def head_row(head):
    """A kernels-line row of the tied head on the warp route: its 8-row
    numbers (the decode batch of a multi_token=1 engine), the 1-row time
    (token 0) beside them."""
    m8 = head["m8"]
    return {"max_abs_err": head["max_abs_err"], "ms": m8["ms"], "plain_ms": m8["plain_ms"],
            "bound_ms": m8["bound_ms"], "bound_by": m8["bound_by"],
            "library_ms": m8["library_ms"]}


# ---------------------------------------------------------------------------
# Phase 14: the input path (gluon.data, DevicePrefetcher, RecordIO, vision
# transforms, Estimator) feeding GPT-2 small through K1/K2, ResNet-50 from
# files and the MNIST example program
# ---------------------------------------------------------------------------

# (a) phase 5's configuration fed by DataLoader(num_workers=2, processes,
# pinned) -> as_device_iterator(depth=2) -> TrainStep.step(block_every=2)
DT_BATCHES = 8
DT_WORKERS = 2
# the fed step profiled inside that loop once the pipeline is full (step 6
# of 8), beside the first step of a fresh iterator (the cold step)
DT_PROFILED = 5
# the prefetcher's stream contract under slow copies: batches of (a)'s
# shape, each behind a spin of DT_HOLD_SPIN_MS on one of the two streams
DT_HOLD_BATCHES, DT_HOLD_SPIN_MS = 8, 20.0
# (b) input-bound: steps timed each way (a producer sleeping one device step)
DT_BOUND_STEPS = 6
# (c) ResNet-50 (phase 11 (a)'s configuration) from a .npy RecordIO of
# DT_RN_BATCHES batches through DT_RN_WORKERS forked workers: DT_RN_STEPS
# TrainSteps, then one Estimator epoch of DT_RN_FIT_BATCHES batches
DT_RN_BATCHES, DT_RN_WORKERS, DT_RN_STEPS, DT_RN_FIT_BATCHES = 6, 4, 5, 2
DT_RN_PAD = 4
DT_RN_MEAN, DT_RN_STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
# (d) examples/train_mnist_gluon.py: 4096 synthetic samples, 3 epochs, card
# against the CPU port per epoch (relative)
DT_MNIST_N, DT_MNIST_EPOCHS, DT_MNIST_TOL = 4096, 3, 1e-5
# numbers of earlier phases printed beside phase 14's: phase 5's fixed-batch
# ms a step, phase 11 (a)'s fixed-batch images/s
FIGURES = {}


def token_windows(args, vocab, B, T, batches):
    """A corpus of token ids from ``--seed`` cut into B * batches windows of
    T tokens, and the windows shifted by one as their labels."""
    import numpy as np
    n = B * batches
    corpus = np.random.RandomState(args.seed + 14).randint(0, vocab, n * T + 1).astype(np.int32)
    return corpus[:n * T].reshape(n, T), corpus[1:].reshape(n, T)


def h2d_gbps(torch, arrays, reps=5):
    """Host-to-card GB/s of one batch (``arrays``), median of ``reps`` CUDA-
    event timed copies from page-locked memory (``non_blocking``) and from
    pageable memory."""
    srcs = [torch.from_numpy(a) for a in arrays]
    pinned = [s.pin_memory() for s in srcs]
    nbytes = sum(s.numel() * s.element_size() for s in srcs)
    out = {}
    for name, xs, nb in (("pinned", pinned, True), ("pageable", srcs, False)):
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            for s in xs:
                s.to("cuda", non_blocking=nb)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        out[name] = nbytes / (statistics.median(times) / 1e3) / 1e9
    out["bytes"] = nbytes
    return out


def profiled_fed_step(torch, step, it):
    """From an idle card, ``next(it)`` and one ``step.step`` on that batch
    under ``torch.profiler`` (device activity). Returns the reading (the
    input wait; the step's wall time from its dispatch to the card's
    finish, the kernels' busy time in it and the idle share), the batch and
    its loss."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        x, y = next(it)
        t1 = time.perf_counter()
        loss = step.step(x, y)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    spans = device_spans(prof)
    reading = {"input_wait_ms": (t1 - t0) * 1e3, "step_wall_ms": (t2 - t1) * 1e3}
    if spans:
        busy = busy_us(spans) / 1e3
        reading.update(device_busy_ms=busy, idle_share=1.0 - busy / reading["step_wall_ms"])
    else:
        reading.update(device_busy_ms="not measured", idle_share="not measured")
    return reading, (x, y), loss


def spin_cycles(torch, ms):
    """The ``torch.cuda._sleep`` cycles that spin the card for about ``ms``."""
    n = 1 << 22
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(n)
    b.record()
    b.synchronize()
    return int(n * ms / a.elapsed_time(b))


def stream_hold(torch, args):
    """The prefetcher's stream contract on the card with copies that are
    slow against the step, where leaving out either half of it gives wrong
    batches: (wait) the producer spins the prefetcher's stream before each
    batch's copy and the consumer reads every batch at once, so without
    its ``wait_event`` it reads the memory before the copy lands;
    (reuse) the consumer spins its own stream before reading each batch
    and drops it, so without ``record_stream`` the allocator hands the
    block to a later batch whose copy lands first. Gate: every batch read
    equals its host source bit for bit, both ways."""
    import numpy as np
    from mxnet_tpu_torch.pipeline import DevicePrefetcher
    rng = np.random.RandomState(args.seed + 141)
    src = [rng.randint(-2 ** 31, 2 ** 31 - 1, (TRAIN_B, TRAIN_T), dtype=np.int32)
           for _ in range(DT_HOLD_BATCHES)]
    cycles = spin_cycles(torch, DT_HOLD_SPIN_MS)

    def slow_copies():
        for a in src:
            # the worker iterates the source on the prefetcher's stream
            check(torch.cuda.current_stream() != torch.cuda.default_stream(),
                  "the prefetcher's worker copies on the default stream")
            torch.cuda._sleep(cycles)
            yield a
    report = {"batches": DT_HOLD_BATCHES, "spin_ms": DT_HOLD_SPIN_MS}
    with DevicePrefetcher(slow_copies(), sharding="cuda", depth=2) as it:
        got = [x.clone() for x in it]
    report["wait"] = [bool(np.array_equal(g.cpu().numpy(), a)) for g, a in zip(got, src)]
    got = []
    with DevicePrefetcher(iter(src), sharding="cuda", depth=2) as it:
        for x in it:
            torch.cuda._sleep(cycles)
            got.append(x.clone())
            del x
    report["reuse"] = [bool(np.array_equal(g.cpu().numpy(), a)) for g, a in zip(got, src)]
    emit({"data_train_stream_hold": report})
    for half in ("wait", "reuse"):
        check(len(report[half]) == DT_HOLD_BATCHES and all(report[half]),
              f"prefetched batches differ from their sources with slow copies ({half}): "
              f"{report[half]}")
    return report


def train_state(step):
    """Copies of a TrainStep's parameters and optimizer state."""
    return ([p.detach().clone() for _, p in step._params],
            [tuple(s.clone() for s in st) for st in step._states])


def same_bits(torch, a, b):
    """Whether two lists of tensors (or of tuples of them) hold the same
    bits: floats compared as integers of their width."""
    def bits(t):
        if t.is_floating_point():
            return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
        return t
    flat_a = [t for x in a for t in (x if isinstance(x, tuple) else (x,))]
    flat_b = [t for x in b for t in (x if isinstance(x, tuple) else (x,))]
    return len(flat_a) == len(flat_b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(bits(x), bits(y))
        for x, y in zip(flat_a, flat_b))


def input_bound(torch, step, X, Y, B, device):
    """(b) the JAX README's input-bound run: a producer that sleeps one
    measured device step per batch, fed to the step directly (a host sync
    per step) and through the prefetcher (block_every's window); the
    speedup against the ideal 2.0x. Printed, not gated."""
    import numpy as np
    from mxnet_tpu_torch.pipeline import DevicePrefetcher
    ids, lab = torch.from_numpy(X[:B]).to(device), torch.from_numpy(Y[:B]).to(device)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    step(ids, lab)
    b.record()
    b.synchronize()
    delay = a.elapsed_time(b) / 1e3
    rng = np.random.RandomState(0)
    idx = [rng.randint(0, len(X), B) for _ in range(DT_BOUND_STEPS)]

    def producer():
        for i in idx:
            time.sleep(delay)
            yield X[i], Y[i]
    t0 = time.perf_counter()
    for x, y in producer():
        step(torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)).item()
    direct = time.perf_counter() - t0
    t0 = time.perf_counter()
    with DevicePrefetcher(producer(), sharding=step.input_shardings(), depth=2) as it:
        for x, y in it:
            step.step(x, y)
        step.drain()
    fed = time.perf_counter() - t0
    return {"producer_delay_ms": delay * 1e3, "steps": DT_BOUND_STEPS,
            "direct_s": direct, "prefetched_s": fed, "speedup": direct / fed, "ideal": 2.0,
            "h2d_gbps_batch": h2d_gbps(torch, [X[:B], Y[:B]])}


def gpt2_from_loader(torch, args, device="cuda"):
    """(a) and (b): bf16 GPT-2 small in phase 5's configuration (B 16, T
    1024, Adam, dropout 0.1 at headline_schedule()) fed from token windows
    through DataLoader(shuffle, 2 forked workers, pin_memory) ->
    as_device_iterator(step.input_shardings(), depth 2) ->
    TrainStep.step(block_every=2) -> drain(); ms a step over the steps
    after the first, fed and hand-fed. On the card, step DT_PROFILED + 1
    runs under the profiler once the pipeline is full (the steady idle
    share), and after the loop the first step of a fresh iterator (the
    cold one, its fork and first batch read on their own). Gates: finite
    losses; K1 and K2 launched LAYERS times a step each and the plain
    attention never; the batches are the sampler's; the losses, the
    parameters and the optimizer state after the last step bit for bit
    those of a twin TrainStep from the same weights fed the same batches
    by hand as CUDA tensors. Returns the launch counts of the fed run."""
    import numpy as np
    from mxnet_tpu_torch import metrics, optimizer, parallel
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import GPTModel
    from mxnet_tpu_torch.ops import attention as fa
    from mxnet_tpu_torch.ops.int8_gemv import launches, reset_launches
    cfg = gpt2_train_config(torch.bfloat16, DEFAULT_DROPOUT)
    B, T = TRAIN_B, TRAIN_T
    X, Y = token_windows(args, cfg.vocab_size, B, T, DT_BATCHES)

    def make_step():
        net = GPTModel(cfg, device=device).init_weights(args.seed)
        return parallel.TrainStep(net, SoftmaxCrossEntropyLoss(),
                                  optimizer.Adam(learning_rate=TRAIN_LR,
                                                 lr_scheduler=headline_schedule()),
                                  example_inputs=[torch.from_numpy(X[:B]).to(device)],
                                  block_every=2)
    loader = DataLoader(ArrayDataset(X, Y), batch_size=B, shuffle=True, num_workers=DT_WORKERS,
                        thread_pool=False, pin_memory=True)
    np.random.seed(args.seed + 14)
    order = np.random.permutation(len(X)).reshape(DT_BATCHES, B)   # what the sampler draws
    step = make_step()
    plain = {"calls": 0}
    real_plain = fa._fallback

    def counted(*a, **k):
        plain["calls"] += 1
        return real_plain(*a, **k)
    was = metrics.enabled()
    metrics.reset()
    metrics.enable()
    fa._fallback = counted
    np.random.seed(args.seed + 14)
    reset_launches()
    sync(torch, device)
    cuda = torch.device(device).type == "cuda"
    waits, losses, fed = [], [], []
    steady = "not measured"                 # card-only measurement
    timed, n_timed, t_mark = 0.0, 0, None   # the steps after the first, unprofiled
    try:
        it = loader.as_device_iterator(sharding=step.input_shardings(), depth=2)
        while True:
            if cuda and len(fed) == DT_PROFILED < DT_BATCHES:
                sync(torch, device)
                timed += time.perf_counter() - t_mark
                steady, batch, loss = profiled_fed_step(torch, step, it)
                waits.append(steady["input_wait_ms"] / 1e3)
                fed.append(batch)
                losses.append(loss)
                t_mark = time.perf_counter()
                continue
            tw = time.perf_counter()
            try:
                x, y = next(it)
            except StopIteration:
                break
            waits.append(time.perf_counter() - tw)
            fed.append((x, y))
            losses.append(step.step(x, y))
            if t_mark is None:
                sync(torch, device)
                t_mark = time.perf_counter()
            else:
                n_timed += 1
        step.drain()
        timed += time.perf_counter() - t_mark
    finally:
        fa._fallback = real_plain
    counts = launches()
    fed_state = train_state(step)
    wait_metric = (metrics.get_sample_value("mxnet_input_wait_seconds_count", {"path": "train"}),
                   metrics.get_sample_value("mxnet_input_wait_seconds_sum", {"path": "train"}))
    metrics.reset()
    (metrics.enable if was else metrics.disable)()
    losses = torch.stack(losses).float().cpu()
    check(len(fed) == DT_BATCHES, f"the loader gave {len(fed)} batches, not {DT_BATCHES}")
    for k, (x, y) in enumerate(fed):
        check(x._data.device.type == torch.device(device).type
              and np.array_equal(x.asnumpy(), X[order[k]])
              and np.array_equal(y.asnumpy(), Y[order[k]]),
              f"batch {k} is not the sampler's batch {k}")
    check(bool(torch.isfinite(losses).all()), f"non-finite loss fed from the loader: {losses}")
    for kind in ("flash_fwd", "flash_bwd"):
        check(counts.get(kind, 0) == LAYERS * DT_BATCHES,
              f"{kind} launches {counts.get(kind)} != {LAYERS} x {DT_BATCHES} steps")
    check(plain["calls"] == 0, f"the plain attention ran {plain['calls']} times")
    ms = timed / n_timed * 1e3
    cold = bound = "not measured"          # card-only measurements
    if cuda:
        it2 = loader.as_device_iterator(sharding=step.input_shardings(), depth=2)
        try:
            cold = profiled_fed_step(torch, step, it2)[0]
        finally:
            it2.close()
        step.drain()
        bound = input_bound(torch, step, X, Y, B, device)
    del step, fed, it
    torch.cuda.empty_cache()
    twin = make_step()
    twin_losses = []
    for k, o in enumerate(order):
        twin_losses.append(twin.step(torch.from_numpy(X[o]).to(device),
                                     torch.from_numpy(Y[o]).to(device)))
        if k == 0:
            sync(torch, device)
            t_twin = time.perf_counter()
    twin.drain()
    twin_ms = (time.perf_counter() - t_twin) / (DT_BATCHES - 1) * 1e3
    twin_losses = torch.stack(twin_losses).float().cpu()
    equal = bool(torch.equal(losses, twin_losses))
    twin_state = train_state(twin)
    params_equal = same_bits(torch, fed_state[0], twin_state[0])
    state_equal = same_bits(torch, fed_state[1], twin_state[1])
    del fed_state, twin_state
    report = {"model": "gpt2-small", "dtype": "bfloat16", "B": B, "T": T,
              "dropout": DEFAULT_DROPOUT, "loader": {"workers": DT_WORKERS, "processes": True,
                                                     "pin_memory": True, "depth": 2,
                                                     "block_every": 2},
              "batches": DT_BATCHES, "losses": losses.tolist(),
              "twin_losses": twin_losses.tolist(), "bitwise_twin": equal,
              "bitwise_twin_params": params_equal, "bitwise_twin_optimizer_state": state_equal,
              "ms_per_step": ms, "tokens_per_s": B * T / (ms / 1e3),
              "hand_fed_twin_ms_per_step": twin_ms,
              "fixed_batch_ms_per_step": FIGURES.get("gpt2_fixed_ms", "not measured"),
              "input_wait_ms": {"median": statistics.median(waits) * 1e3,
                                "max": max(waits) * 1e3, "first": waits[0] * 1e3,
                                "median_after_first": statistics.median(waits[1:]) * 1e3},
              "mxnet_input_wait_seconds": {"count": wait_metric[0], "sum": wait_metric[1]},
              "launches": {k: counts.get(k, 0) for k in ("flash_fwd", "flash_bwd")},
              "plain_attention_calls": plain["calls"],
              "profiled_fed_step": {"steady": steady, "steady_step": DT_PROFILED + 1,
                                    "cold": cold},
              "input_bound": bound}
    emit({"data_train_gpt2": report})
    check(equal, f"losses fed from the loader {losses.tolist()} differ from the hand-fed "
          f"twin's {twin_losses.tolist()}")
    check(params_equal and state_equal,
          f"after {DT_BATCHES} steps fed from the loader the parameters (bitwise "
          f"{params_equal}) or the optimizer state (bitwise {state_equal}) differ from "
          f"the hand-fed twin's")
    del twin
    return counts


def npy_record_file(args, path, n, hw, classes):
    """``n`` uint8 hw x hw x 3 images from ``--seed`` with labels in [0,
    classes), written as a .npy RecordIO by the port's pack_img."""
    import numpy as np
    from mxnet_tpu_torch.io import recordio
    rng = np.random.RandomState(args.seed + 141)
    w = recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    for i in range(n):
        img = rng.randint(0, 256, (hw, hw, 3)).astype(np.uint8)
        w.write_idx(i, recordio.pack_img(recordio.IRHeader(0, float(rng.randint(0, classes)), i, 0),
                                         img, img_fmt=".npy"))
    w.close()


def nhwc_batches(torch, it):
    """The NCHW f32 batches ToTensor/Normalize make, as the NHWC bf16 images
    and int32 labels phase 11's ResNet-50 takes (one permute and cast on
    the card, on the consumer's stream)."""
    from mxnet_tpu_torch.ndarray import NDArray
    for x, y in it:
        yield (NDArray(x._data.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()),
               NDArray(y._data.to(torch.int32)))


def resnet_from_files(torch, args, device="cuda", hw=VT_HW, B=VT_B, classes=1000):
    """(c) ResNet-50 v1 in phase 11 (a)'s configuration (NHWC, AMP bf16,
    SGD 0.05 momentum 0.9) fed from a .npy RecordIO of DT_RN_BATCHES x B
    images: ImageRecordDataset with RandomCrop(pad 4), RandomFlipLeftRight,
    ToTensor and Normalize on the images, DT_RN_WORKERS forked workers,
    pin_memory, as_device_iterator. DT_RN_STEPS TrainSteps, then one
    Estimator.fit epoch of DT_RN_FIT_BATCHES batches. Gates: finite losses,
    every running mean moved."""
    import shutil
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, optimizer, parallel
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon import metric as gmetric
    from mxnet_tpu_torch.gluon.contrib import estimator
    from mxnet_tpu_torch.gluon.data import DataLoader
    from mxnet_tpu_torch.gluon.data.vision import ImageRecordDataset, transforms
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.gluon.model_zoo import get_model
    tmp = tempfile.mkdtemp(prefix="mxdata_")
    try:
        rec = f"{tmp}/images.rec"
        t0 = time.perf_counter()
        npy_record_file(args, rec, DT_RN_BATCHES * B, hw, classes)
        write_s = time.perf_counter() - t0
        tf = transforms.Compose([transforms.RandomCrop(hw, pad=DT_RN_PAD),
                                 transforms.RandomFlipLeftRight(), transforms.ToTensor(),
                                 transforms.Normalize(DT_RN_MEAN, DT_RN_STD)])
        ds = ImageRecordDataset(rec).transform_first(tf)

        def loader(dataset):
            return DataLoader(dataset, batch_size=B, shuffle=True, num_workers=DT_RN_WORKERS,
                              thread_pool=False, pin_memory=True)
        mx.random.seed(args.seed)
        net = get_model("resnet50_v1", classes=classes, layout="NHWC")
        net.initialize(mx.init.Xavier())
        amp.convert_hybrid_block(net, "bfloat16")
        example = torch.zeros(B, hw, hw, 3, dtype=torch.bfloat16, device=device)
        step = parallel.TrainStep(net, SoftmaxCrossEntropyLoss(),
                                  optimizer.SGD(learning_rate=VT_LR, momentum=VT_MOMENTUM),
                                  [example])
        stats = {k: p for k, p in net.collect_params().items() if k.endswith("running_mean")}
        before = {k: p.data()._data.clone() for k, p in stats.items()}
        losses, t_first = [], None
        it = loader(ds).as_device_iterator(sharding=step.input_shardings(), depth=2)
        t0 = time.perf_counter()
        try:
            for k, (x, y) in enumerate(nhwc_batches(torch, it)):
                losses.append(step(x, y))
                if k == 0:
                    sync(torch, device)
                    t_first = time.perf_counter()
                if k + 1 == DT_RN_STEPS:
                    break
            sync(torch, device)
            t_end = time.perf_counter()
        finally:
            it.close()
        losses = [float(v) for v in torch.stack(losses).float().cpu()]
        moved = sum(not torch.equal(before[k], p.data()._data) for k, p in stats.items())
        fed_ips = (DT_RN_STEPS - 1) * B / (t_end - t_first)
        # one Estimator epoch over the first DT_RN_FIT_BATCHES batches' worth
        fit_ds = ds.shard(DT_RN_BATCHES // DT_RN_FIT_BATCHES, 0)
        est = estimator.Estimator(net, SoftmaxCrossEntropyLoss(),
                                  train_metrics=[gmetric.Accuracy()],
                                  trainer=Trainer(net.collect_params(), "sgd",
                                                  {"learning_rate": VT_LR,
                                                   "momentum": VT_MOMENTUM}))
        fit_losses = []

        class Record(estimator.BatchEnd):
            def batch_end(self, est_, *a, loss=None, **kw):
                fit_losses.append(float(loss.mean().item()))
        before_fit = {k: p.data()._data.clone() for k, p in stats.items()}
        fit_it = loader(fit_ds).as_device_iterator(depth=2)
        t0 = time.perf_counter()
        try:
            est.fit(nhwc_batches(torch, fit_it), epochs=1, event_handlers=[Record()])
        finally:
            fit_it.close()
        fit_s = time.perf_counter() - t0
        moved_fit = sum(not torch.equal(before_fit[k], p.data()._data) for k, p in stats.items())
        x0 = torch.zeros(B, 3, hw, hw).numpy()
        report = {"model": "resnet50_v1", "layout": "NHWC", "dtype": "bfloat16", "B": B,
                  "hw": hw, "records": DT_RN_BATCHES * B, "record_write_s": write_s,
                  "workers": DT_RN_WORKERS, "transforms": "RandomCrop(pad 4), "
                  "RandomFlipLeftRight, ToTensor, Normalize", "steps": DT_RN_STEPS,
                  "losses": losses, "images_per_s_from_files": fed_ips,
                  "fixed_batch_images_per_s": FIGURES.get("resnet50_fixed_images_per_s",
                                                          "not measured"),
                  "running_means_moved": moved, "running_means": len(stats),
                  "estimator": {"batches": len(fit_losses), "losses": fit_losses,
                                "train_metrics": [m.get() for m in est.train_metrics],
                                "wall_s": fit_s, "running_means_moved": moved_fit},
                  "h2d_gbps_batch": h2d_gbps(torch, [x0])
                  if torch.device(device).type == "cuda" else "not measured"}
        emit({"data_train_resnet50": report})
        check(all(math.isfinite(v) for v in losses + fit_losses),
              f"non-finite ResNet-50 loss fed from files: {losses} {fit_losses}")
        check(len(losses) == DT_RN_STEPS and len(fit_losses) == DT_RN_FIT_BATCHES,
              f"{len(losses)} steps and {len(fit_losses)} Estimator batches")
        check(moved == len(stats) and moved_fit == len(stats),
              f"running means moved: {moved} and {moved_fit} of {len(stats)}")
        del step, est, net
        return report
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def mnist_program(torch, args, device, workers):
    """examples/train_mnist_gluon.py's synthetic-data program on the port
    (its data, net, Xavier init, hybridize, Trainer("adam", 1e-3),
    DataLoader(ArrayDataset(X, Y), 128, shuffle=True, num_workers=workers,
    thread_pool=workers == 0), Accuracy), DT_MNIST_EPOCHS epochs on
    ``device``, numpy's global RNG seeded for the sampler. Returns the
    per-epoch mean losses, accuracies and wall seconds."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import Trainer, metric, nn
    from mxnet_tpu_torch.gluon.data import ArrayDataset, DataLoader
    from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
    with (mx.gpu(0) if torch.device(device).type == "cuda" else mx.cpu()):
        mx.random.seed(42)
        np.random.seed(args.seed)
        rs = np.random.RandomState(0)
        X = rs.rand(DT_MNIST_N, 784).astype("float32")
        W = rs.randn(784, 10).astype("float32")
        Y = (X @ W).argmax(1).astype("int32")
        loader = DataLoader(ArrayDataset(X, Y), batch_size=128, shuffle=True,
                            num_workers=workers, thread_pool=workers == 0)
        net = nn.HybridSequential()
        net.add(nn.Dense(128, activation="relu"), nn.Dense(64, activation="relu"), nn.Dense(10))
        net.initialize(mx.init.Xavier())
        net.hybridize()
        trainer = Trainer(net.collect_params(), "adam", {"learning_rate": 1e-3})
        loss_fn = SoftmaxCrossEntropyLoss()
        acc = metric.Accuracy()
        losses, accs = [], []
        t0 = time.perf_counter()
        for _ in range(DT_MNIST_EPOCHS):
            acc.reset()
            total = 0.0
            for data, label in loader:
                with autograd.record():
                    out = net(data)
                    loss = loss_fn(out, label)
                loss.backward()
                trainer.step(data.shape[0])
                acc.update(label, out)
                total += float(loss.mean().item())
            losses.append(total / len(loader))
            accs.append(acc.get()[1])
        return {"losses": losses, "accuracy": accs, "wall_s": time.perf_counter() - t0}


def mnist_card_vs_cpu(torch, args, card="cuda"):
    """(d) the MNIST program on the card with 0 and 2 workers against the
    CPU port: the loss falls, the accuracy rises, each epoch's loss within
    DT_MNIST_TOL of the CPU's (relative)."""
    cpu = mnist_program(torch, args, "cpu", 0)
    runs = {w: mnist_program(torch, args, card, w) for w in (0, 2)}
    report = {"cpu": cpu, **{f"card_workers_{w}": r for w, r in runs.items()}}
    for w, r in runs.items():
        report[f"card_workers_{w}"]["max_rel_to_cpu"] = max(
            abs(a - b) / max(abs(b), 1e-12) for a, b in zip(r["losses"], cpu["losses"]))
    emit({"data_train_mnist": report})
    for w, r in runs.items():
        check(r["losses"][-1] < r["losses"][0] and r["accuracy"][-1] > r["accuracy"][0],
              f"MNIST with {w} workers: loss {r['losses']} accuracy {r['accuracy']}")
        check(r["max_rel_to_cpu"] <= DT_MNIST_TOL,
              f"MNIST with {w} workers: epoch losses {r['losses']} vs the CPU's "
              f"{cpu['losses']} (> {DT_MNIST_TOL})")
    return report


def data_train(torch, args):
    """Phase 14: the input path. (a) the prefetcher's stream contract
    under slow copies, then GPT-2 small fed through the loader and the
    prefetcher, bit for bit its hand-fed twin, K1/K2 on its path, (b)
    the input-bound run, (c) ResNet-50 from a RecordIO through forked
    workers and the Estimator, (d) the MNIST program card against CPU.
    Starts only with at most LT_HELD_GB still allocated. Returns (a)'s
    launch counts."""
    t_phase = time.perf_counter()
    held = torch.cuda.memory_allocated() / 1e9
    emit({"data_train_allocated_gb_at_start": held})
    check(held <= LT_HELD_GB, f"{held} GB of device memory still allocated as phase 14 "
          f"starts (> {LT_HELD_GB}): an earlier phase's model or engine was not freed")
    parts = {}
    t0 = time.perf_counter()
    stream_hold(torch, args)
    parts["stream_hold"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts = gpt2_from_loader(torch, args)
    torch.cuda.empty_cache()
    parts["gpt2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    resnet_from_files(torch, args)
    torch.cuda.empty_cache()
    parts["resnet50"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mnist_card_vs_cpu(torch, args)
    parts["mnist"] = time.perf_counter() - t0
    emit({"data_train_s": time.perf_counter() - t_phase, "parts_s": parts})
    return counts


# phase 15 (a): the LSTM language model (Zaremba et al. 2014 "medium", the
# width of MXNet's word-language-model example)
LM_VOCAB, LM_WIDTH, LM_LAYERS, LM_B, LM_T = 10000, 650, 2, 20, 35
LM_STEPS = 20                     # the timed run on one repeated batch
LM_LR, LM_CLIP = 1.0, 0.25
LM_CPU_STEPS = 3
LM_CPU_TOL = 1e-4                 # card losses against the CPU port's (relative)
GRU_CPU_TOL = 1e-4                # bidirectional GRU outputs (max abs / max |out|)
GRU_GRAD_TOL = 1e-3               # its gradients (relative L2)
# phase 15 (b): SSD-300 post-processing
SSD_B, SSD_CLASSES, SSD_MAX_GT = 32, 21, 8
SSD_TOL = 1e-6
# phase 15 (c): the detection ops with gradients
ROI_B, ROI_C, ROI_HW, ROI_PER_IMAGE = 4, 256, 38, 128
ROI_TOL = 1e-5
DCN_SHAPE, DCN_FILTERS = (8, 256, 28, 28), 256
DCN_TOL = 1e-4


def lstm_lm(dropout, vocab=LM_VOCAB, width=LM_WIDTH, layers=LM_LAYERS, sparse_grad=False):
    """Embedding -> LSTM -> Dense, built from gluon.nn and gluon.rnn."""
    from mxnet_tpu_torch.gluon import HybridBlock, nn, rnn

    class LanguageModel(HybridBlock):
        def __init__(self):
            super().__init__()
            self.embedding = nn.Embedding(vocab, width, sparse_grad=sparse_grad)
            self.rnn = rnn.LSTM(width, num_layers=layers, dropout=dropout, input_size=width)
            self.decoder = nn.Dense(vocab, flatten=False, in_units=width)

        def forward(self, x, states):
            out, states = self.rnn(self.embedding(x), states)
            return self.decoder(out), states
    return LanguageModel()


def lm_model(torch, args, dropout, device, optimizer=("sgd", {"learning_rate": LM_LR}),
             sparse_grad=False, **kw):
    """(net, trainer, loss) of the language model on ``device``, its
    weights drawn on the host from ``--seed`` (the same on every device)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    mx.random.seed(args.seed)
    net = lstm_lm(dropout, sparse_grad=sparse_grad,
                  **{k: kw[k] for k in ("vocab", "width", "layers") if k in kw})
    net.initialize(mx.init.Uniform(0.1), device=mx.Device(device))
    trainer = gluon.Trainer(net.collect_params(), optimizer[0], dict(optimizer[1]))
    return net, trainer, gluon.loss.SoftmaxCrossEntropyLoss()


def lm_batch(args, vocab=LM_VOCAB, B=LM_B, T=LM_T, salt=0):
    import numpy as np
    rng = np.random.RandomState(args.seed + 15 + salt)
    tokens = rng.randint(0, vocab, (T + 1, B)).astype("int32")
    return tokens[:-1], tokens[1:]


def lm_step(torch, net, trainer, loss_fn, x, y, states):
    """One bptt step: states detached, forward and loss recorded, the
    gradients clipped to a global norm of LM_CLIP, an SGD step. Returns
    (loss, states)."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import utils
    states = [s.detach() for s in states]
    with autograd.record():
        out, states = net(x, states)
        loss = loss_fn(out, y).mean()
    loss.backward()
    utils.clip_global_norm([p.grad() for p in net.collect_params().values()], LM_CLIP)
    trainer.step(1)
    return loss, states


def lm_losses(torch, args, dropout, device, steps, **kw):
    """Losses of ``steps`` steps over fresh batches on ``device``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import np as mnp
    net, trainer, loss_fn = lm_model(torch, args, dropout, device, **kw)
    dev = mx.Device(device)
    B = kw.get("B", LM_B)
    states = net.rnn.begin_state(B, device=torch.device(device))
    losses = []
    for k in range(steps):
        x, y = lm_batch(args, kw.get("vocab", LM_VOCAB), B, kw.get("T", LM_T), salt=k)
        loss, states = lm_step(torch, net, trainer, loss_fn, mnp.array(x, device=dev),
                               mnp.array(y, device=dev), states)
        losses.append(float(loss.item()))
    return losses


def lm_masks(torch, args, device, **kw):
    """The inter-layer dropout masks of one training step at dropout 0.5,
    recorded from ``gluon.rnn``'s draw."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import np as mnp
    from mxnet_tpu_torch.gluon import rnn as rnn_mod
    net, trainer, loss_fn = lm_model(torch, args, 0.5, device, **kw)
    dev = mx.Device(device)
    seen, draw = [], rnn_mod._keep_mask

    def spy(*a, **k):
        m = draw(*a, **k)
        seen.append(m.detach().cpu())
        return m
    rnn_mod._keep_mask = spy
    try:
        B = kw.get("B", LM_B)
        x, y = lm_batch(args, kw.get("vocab", LM_VOCAB), B, kw.get("T", LM_T))
        mx.random.seed(args.seed + 1)
        lm_step(torch, net, trainer, loss_fn, mnp.array(x, device=dev), mnp.array(y, device=dev),
                net.rnn.begin_state(B, device=torch.device(device)))
    finally:
        rnn_mod._keep_mask = draw
    return seen


def lm_train(torch, args, card="cuda", steps=LM_STEPS, **kw):
    """(a)'s headline: ``steps`` steps at dropout 0.5 on one repeated batch
    on the card, then one profiled step."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import np as mnp
    from torch.profiler import ProfilerActivity, profile
    net, trainer, loss_fn = lm_model(torch, args, 0.5, card, **kw)
    dev = mx.Device(card)
    B, T = kw.get("B", LM_B), kw.get("T", LM_T)
    x, y = lm_batch(args, kw.get("vocab", LM_VOCAB), B, T)
    x, y = mnp.array(x, device=dev), mnp.array(y, device=dev)
    states = net.rnn.begin_state(B, device=torch.device(card))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, states = lm_step(torch, net, trainer, loss_fn, x, y, states)
        losses.append(float(loss.item()))
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.synchronize()
    activity = ProfilerActivity.CUDA if card == "cuda" else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        t0 = time.perf_counter()
        loss, states = lm_step(torch, net, trainer, loss_fn, x, y, states)
        loss.item()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = device_spans(prof)
    busy = busy_us(spans) / 1e3
    step_ms = statistics.median(ms[2:])
    return {"losses": losses, "ms_step": step_ms, "tokens_per_s": B * T / step_ms * 1e3,
            "peak_gb": peak, "profiled_wall_ms": wall, "profiled_busy_ms": busy,
            "idle_share": 1.0 - busy / wall if wall else None, "device_ops_step": len(spans)}


def rel_err(got, want):
    """max |got - want| / max |want|, in f64 on the host."""
    g, w = got.detach().double().cpu(), want.detach().double().cpu()
    return float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))


def rel_l2(got, want):
    g, w = got.detach().double().cpu(), want.detach().double().cpu()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def gru_card_vs_cpu(torch, args, card="cuda", width=LM_WIDTH, B=LM_B, T=LM_T):
    """A bidirectional GRU at the language model's width, card against
    CPU: outputs, final states, and the gradients of the input and every
    weight."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import rnn
    g = torch.Generator().manual_seed(args.seed)
    x = torch.randn(T, B, width, generator=g)
    h0 = torch.randn(2, B, width, generator=g) * 0.5
    wsum = torch.randn(T, B, 2 * width, generator=g)
    res = {}
    for dev in ("cpu", card):
        mx.random.seed(args.seed)
        net = rnn.GRU(width, bidirectional=True, input_size=width)
        net.initialize(device=mx.Device(dev))
        xd = x.detach().to(dev, copy=True).requires_grad_()
        out, (hn,) = net(xd, [h0.to(dev)])
        ((out * wsum.to(dev)).sum() + (hn * hn).sum()).backward()
        res[dev] = [out, hn, xd.grad] + [t.grad for _, t in net.named_parameters()]
    cpu, got = res["cpu"], res[card]
    errs = {"out": rel_err(got[0], cpu[0]), "state": rel_err(got[1], cpu[1]),
            "grads_rel_l2": max(rel_l2(a, b) for a, b in zip(got[2:], cpu[2:]))}
    emit({"rnn_detect_gru_card_vs_cpu": errs})
    check(errs["out"] <= GRU_CPU_TOL and errs["state"] <= GRU_CPU_TOL,
          f"bidirectional GRU card outputs off the CPU port's: {errs}")
    check(errs["grads_rel_l2"] <= GRU_GRAD_TOL,
          f"bidirectional GRU card gradients off the CPU port's: {errs}")
    return errs


def ssd300_anchors(np):
    """The 8732 standard SSD300 anchors, corners clipped to [0, 1]:
    feature maps 38/19/10/5/3/1 at strides 8/16/32/64/100/300, sizes 30 to
    315, aspect ratios {2} or {2, 3} (4 or 6 boxes a location)."""
    fmaps, steps = (38, 19, 10, 5, 3, 1), (8, 16, 32, 64, 100, 300)
    sizes = (30, 60, 111, 162, 213, 264, 315)
    ratios = ((2,), (2, 3), (2, 3), (2, 3), (2,), (2,))
    out = []
    for k, f in enumerate(fmaps):
        c = (np.arange(f) + 0.5) * steps[k] / 300.0
        cy, cx = np.meshgrid(c, c, indexing="ij")
        s, s2 = sizes[k] / 300.0, np.sqrt(sizes[k] * sizes[k + 1]) / 300.0
        wh = [(s, s), (s2, s2)]
        for r in ratios[k]:
            wh += [(s * np.sqrt(r), s / np.sqrt(r)), (s / np.sqrt(r), s * np.sqrt(r))]
        per = [np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1) for w, h in wh]
        out.append(np.stack(per, 2).reshape(-1, 4))
    return np.clip(np.concatenate(out), 0.0, 1.0).astype("float32")[None]


def ssd_inputs(args, A, B=SSD_B, classes=SSD_CLASSES, max_gt=SSD_MAX_GT):
    """Labels [B, max_gt, 5] (class, corners; padded with -1), class
    logits [B, classes, A] and box offsets [B, A * 4] from ``--seed``."""
    import numpy as np
    rng = np.random.RandomState(args.seed + 300)
    labels = -np.ones((B, max_gt, 5), "float32")
    for b in range(B):
        m = rng.randint(1, max_gt + 1)
        lo = rng.uniform(0.0, 0.7, (m, 2))
        labels[b, :m, 0] = rng.randint(0, classes - 1, m)
        labels[b, :m, 1:3] = lo
        labels[b, :m, 3:5] = lo + rng.uniform(0.08, 0.3, (m, 2))
    logits = rng.randn(B, classes, A).astype("float32") * 2.0
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs = (probs / probs.sum(1, keepdims=True)).astype("float32")
    loc = (rng.randn(B, A * 4) * 0.5).astype("float32")
    return labels, probs, loc


def ssd_post(torch, npx, anchors, labels, probs, loc, rows, device):
    """(b)'s main path on ``device`` (tensors in, tensors out)."""
    def on(a):
        return torch.from_numpy(a).to(device)
    loc_t, loc_m, cls_t = npx.multibox_target(on(anchors), on(labels),
                                              torch.zeros(labels.shape[0], SSD_CLASSES,
                                                          anchors.shape[1], device=device))
    det = npx.multibox_detection(on(probs), on(loc), on(anchors), threshold=0.01,
                                 nms_threshold=0.45, nms_topk=400)
    kept = npx.box_nms(on(rows), overlap_thresh=0.45, valid_thresh=0.01, id_index=0)
    return {"loc_target": loc_t, "loc_mask": loc_m, "cls_target": cls_t, "detection": det,
            "box_nms": kept}


SSD_ANCHORS = 8732


def ssd_detect(torch, args, timer, card="cuda"):
    """(b): SSD-300 post-processing card against CPU; the NMS sweep kernel
    bit for bit its plain loop on every image, and timed beside it."""
    import numpy as np
    from mxnet_tpu_torch import numpy_extension as npx
    from mxnet_tpu_torch.ops import contrib, int8_gemv
    anchors = ssd300_anchors(np)
    A = anchors.shape[1]
    check(A == SSD_ANCHORS, f"SSD300 has {SSD_ANCHORS} anchors, made {A}")
    labels, probs, loc = ssd_inputs(args, A)
    # one image's decoded rows (class, score, corners) for box_nms
    rng = np.random.RandomState(args.seed + 301)
    rows = np.concatenate([probs[0, 1:].argmax(0)[:, None].astype("float32"),
                           probs[0, 1:].max(0)[:, None],
                           np.clip(anchors[0] + rng.randn(A, 4).astype("float32") * 0.01,
                                   0, 1)], 1)
    seen, sweep = [], contrib.nms_sweep

    def spy(dec, valid):
        keep = sweep(dec, valid)
        seen.append((dec, valid, keep))
        return keep
    contrib.nms_sweep = spy
    try:
        t0 = time.perf_counter()
        cpu = ssd_post(torch, npx, anchors, labels, probs, loc, rows, "cpu")
        cpu_s = time.perf_counter() - t0
        seen.clear()
        torch.cuda.synchronize()
        int8_gemv.reset_launches()
        t0 = time.perf_counter()
        got = ssd_post(torch, npx, anchors, labels, probs, loc, rows, card)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        launches = int8_gemv.launches().get("nms_sweep", 0)
    finally:
        contrib.nms_sweep = sweep
    for k in ("cls_target", "loc_mask"):
        check(torch.equal(got[k].cpu(), cpu[k]), f"SSD {k} differs between card and CPU")
    for k in ("detection", "box_nms"):
        check(torch.equal(got[k][..., 0].cpu() == -1, cpu[k][..., 0] == -1)
              and torch.equal(got[k][..., :2].cpu(), cpu[k][..., :2]),
              f"SSD {k}: kept rows or their order differ between card and CPU")
    float_err = {k: float((got[k].cpu() - cpu[k]).abs().max()) for k in
                 ("loc_target", "detection", "box_nms")}
    check(max(float_err.values()) <= SSD_TOL, f"SSD floats card against CPU: {float_err}")
    check(len(seen) == 2 and launches == (2 if card == "cuda" else 0),
          f"the NMS sweep kernel launched {launches} times on the SSD path (want 2)")
    # the kernel against its plain loop on every image of both calls
    mism, kept = 0, 0
    for dec, valid, keep in seen:
        plain = contrib.nms_sweep_plain(dec, valid)
        mism += int((plain != keep).sum())
        kept += int(keep.sum())
    check(mism == 0, f"the NMS sweep kernel differs from its plain loop in {mism} rows")
    rep = {}
    for name, (dec, valid, keep) in zip(("detection", "box_nms"), seen):
        B, m, n = dec.shape
        # bytes the sweep needs: each kept row's decisions after it, valid, keep
        idx = torch.arange(n, device=keep.device)
        done = keep[:, :m] & valid[:, :m]
        nbytes = float(((n - 1 - idx[:m]) * done).sum()) + 2 * B * n
        ms = timer(lambda: contrib.nms_sweep(dec, valid))
        plain_ms = Timer(torch, iters=3, warmup=1)(lambda: contrib.nms_sweep_plain(dec, valid))
        b_ms, b_by = bound(nbytes, 0)
        rep[name] = {"B": B, "rows": m, "n": n, "kept": int(keep.sum()), "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}
    out = {"cpu_s": cpu_s, "card_s": card_s, "float_err": float_err, "launches": launches,
           "kept_rows": kept, "sweeps": rep}
    emit({"rnn_detect_ssd": out})
    return out


def detection_grads(torch, args, timer, card="cuda"):
    """(c): roi_align and deformable_convolution forward and backward,
    card against CPU, and timed on the card."""
    from mxnet_tpu_torch import numpy_extension as npx
    g = torch.Generator().manual_seed(args.seed + 400)
    feat = torch.randn(ROI_B, ROI_C, ROI_HW, ROI_HW, generator=g)
    n = ROI_B * ROI_PER_IMAGE
    img = ROI_HW * 8
    xy = torch.rand(n, 2, generator=g) * img * 0.8
    wh = 16 + torch.rand(n, 2, generator=g) * 112
    rois = torch.cat([torch.arange(ROI_B).repeat_interleave(ROI_PER_IMAGE)[:, None].float(),
                      xy, xy + wh], 1)
    x = torch.randn(*DCN_SHAPE, generator=g)
    off = torch.randn(DCN_SHAPE[0], 18, DCN_SHAPE[2], DCN_SHAPE[3], generator=g) * 0.5
    w = torch.randn(DCN_FILTERS, DCN_SHAPE[1], 3, 3, generator=g) * 0.02

    def roi(dev, xs):
        return npx.roi_align(xs, rois.to(dev), (7, 7), spatial_scale=1 / 8, sample_ratio=2)

    def dcn(dev, xs, os_, ws):
        return npx.deformable_convolution(xs, os_, ws, kernel=(3, 3), pad=(1, 1),
                                          num_filter=DCN_FILTERS, no_bias=True)

    res = {}
    for dev in ("cpu", card):
        fd = feat.detach().to(dev, copy=True).requires_grad_()
        out = roi(dev, fd)
        (out * out).sum().backward()
        xd, od, wd = (t.detach().to(dev, copy=True).requires_grad_() for t in (x, off, w))
        y = dcn(dev, xd, od, wd)
        (y * y).sum().backward()
        res[dev] = {"roi": (out, fd.grad), "dcn": (y, xd.grad, od.grad, wd.grad)}
    errs = {"roi_align": [rel_err(a, b) for a, b in zip(res[card]["roi"], res["cpu"]["roi"])],
            "deformable_convolution": [rel_err(a, b) for a, b in
                                       zip(res[card]["dcn"], res["cpu"]["dcn"])]}
    fc = feat.detach().to(card, copy=True).requires_grad_()
    xc, oc, wc = (t.detach().to(card, copy=True).requires_grad_() for t in (x, off, w))
    ms = {"roi_align_fwd": event_ms(torch, lambda: roi(card, fc.detach())),
          "roi_align_fwd_bwd": event_ms(torch, lambda: roi(card, fc).sum().backward()),
          "deformable_fwd": event_ms(torch, lambda: dcn(card, xc.detach(), oc.detach(),
                                                        wc.detach())),
          "deformable_fwd_bwd": event_ms(torch, lambda: dcn(card, xc, oc, wc).sum()
                                         .backward())}
    out = {"max_rel_err": errs, "ms": ms, "rois": n}
    emit({"rnn_detect_ops": out})
    check(max(errs["roi_align"]) <= ROI_TOL, f"roi_align card against CPU: {errs}")
    check(max(errs["deformable_convolution"]) <= DCN_TOL,
          f"deformable_convolution card against CPU: {errs}")
    return out


def rnn_detect(torch, args, timer, card="cuda", lm_kw=None, gru_kw=None):
    """Phase 15: (a) the LSTM language model and a bidirectional GRU, (b)
    SSD-300 post-processing through the NMS sweep kernel, (c) roi_align and
    deformable convolution with gradients. Returns (b)'s sweep row.
    ``card``, ``lm_kw`` and ``gru_kw`` cut it down for a CPU rehearsal."""
    lm_kw, gru_kw = lm_kw or {}, gru_kw or {}
    t_phase = time.perf_counter()
    parts = {}
    t0 = time.perf_counter()
    cpu = lm_losses(torch, args, 0.0, "cpu", LM_CPU_STEPS, **lm_kw)
    got = lm_losses(torch, args, 0.0, card, LM_CPU_STEPS, **lm_kw)
    lm_err = max(abs(a - b) / abs(b) for a, b in zip(got, cpu))
    masks_cpu, masks_card = lm_masks(torch, args, "cpu", **lm_kw), \
        lm_masks(torch, args, card, **lm_kw)
    check(len(masks_card) == LM_LAYERS - 1 == len(masks_cpu)
          and all(torch.equal(a, b) for a, b in zip(masks_card, masks_cpu)),
          "the LSTM's dropout masks differ between card and CPU")
    lm = lm_train(torch, args, card, **lm_kw)
    emit({"rnn_detect_lm": dict(lm, card_vs_cpu_losses=[got, cpu], card_vs_cpu_rel=lm_err,
                                mask_keep_share=float(masks_card[0].float().mean()))})
    check(lm_err <= LM_CPU_TOL, f"LSTM LM card losses {got} off the CPU port's {cpu}")
    check(all(math.isfinite(v) for v in lm["losses"]) and lm["losses"][-1] < lm["losses"][0],
          f"the LSTM LM's loss did not fall on a repeated batch: {lm['losses']}")
    gru = gru_card_vs_cpu(torch, args, card, **gru_kw)
    parts["lstm_gru"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ssd = ssd_detect(torch, args, timer, card)
    parts["ssd"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ops = detection_grads(torch, args, timer, card)
    parts["detection_ops"] = time.perf_counter() - t0
    emit({"rnn_detect_s": time.perf_counter() - t_phase, "parts_s": parts,
          "lm": {k: lm[k] for k in ("ms_step", "tokens_per_s", "peak_gb", "idle_share",
                                    "device_ops_step")}, "gru": gru,
          "ssd_ms": {k: v["ms"] for k, v in ssd["sweeps"].items()}, "ops_ms": ops["ms"]})
    sw = ssd["sweeps"]["detection"]
    return {"name": "nms_sweep", "route": "cuda", "source": "mxnet_tpu_torch/csrc/nms_sweep.cu",
            "replaces": "mxnet_tpu/ops/contrib.py:386 (lax.fori_loop; no TPU kernel)",
            "launches": ssd["launches"], "max_abs_err": 0.0, "ms": sw["ms"],
            "plain_ms": sw["plain_ms"], "bound_ms": sw["bound_ms"], "bound_by": sw["bound_by"],
            "library_ms": None, "box_nms": ssd["sweeps"]["box_nms"],
            "path": "rnn_detect (b): multibox_detection B 32 and box_nms"}


# phase 16: row-sparse storage and lazy sparse training, the rejection
# samplers, and the rest of the single-device user surface
SP_STEPS = 3                       # (a): steps of each LM comparison
SP_DENSE_TOL = 1e-6                # (a): sparse SGD against dense (relative)
SP_CPU_TOL = LM_CPU_TOL            # (a): card Adam losses against the CPU port's
# (b): the One Billion Word Benchmark's vocabulary (Chelba et al., 2013),
# the table MXNet's example/rnn/large_word_lm trains with sparse gradients
OBW_VOCAB, OBW_DIM, OBW_B, OBW_T, OBW_STEPS = 793471, 512, 128, 20, 5
OBW_LR = 0.01
OBW_SLACK_GB = 0.5                 # peak over table + moments a sparse step may add
OBW_CPU_TOL = 1e-5                 # touched rows against the CPU port's
SAMPLER_DRAWS, SAMPLER_P_MIN = 20000, 1e-3
NAIVE_N = 4096                     # (d): the matmul NaiveEngine must have finished


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _sync(torch, card):
    if card != "cpu":
        torch.cuda.synchronize()


def sparse_lm(torch, args, card="cuda", **kw):
    """(a): the phase 15 LM with ``Embedding(sparse_grad=True)`` at dropout
    0, no clipping. SGD: sparse against dense on the card, losses and the
    table each step. Adam (lazy): card losses against the CPU port's, rows
    no batch touched keep weights and both moments bit for bit; ms a step
    of sparse and dense Adam."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch import np as mnp
    from mxnet_tpu_torch.sparse import RowSparseNDArray
    B, T, vocab = kw.get("B", LM_B), kw.get("T", LM_T), kw.get("vocab", LM_VOCAB)
    batches = [lm_batch(args, vocab, B, T, salt=100 + k) for k in range(SP_STEPS)]

    def run(device, sparse, optimizer, record_ms=False):
        net, trainer, loss_fn = lm_model(torch, args, 0.0, device, optimizer=optimizer,
                                         sparse_grad=sparse, **kw)
        dev = mx.Device(device)
        states = net.rnn.begin_state(B, device=torch.device(device))
        table0 = net.embedding.weight.data()._data.detach().clone()
        losses, tables, ms = [], [], []
        for x, y in batches:
            states = [s.detach() for s in states]
            _sync(torch, device)
            t0 = time.perf_counter()
            with autograd.record():
                out, states = net(mnp.array(x, device=dev), states)
                loss = loss_fn(out, mnp.array(y, device=dev)).mean()
            loss.backward()
            g = net.embedding.weight.grad()
            check(isinstance(g, RowSparseNDArray) == sparse,
                  f"the embedding's gradient is {type(g).__name__} with sparse_grad={sparse}")
            _sync(torch, device)
            t1 = time.perf_counter()
            trainer.step(1)
            _sync(torch, device)
            t2 = time.perf_counter()
            ms.append(((t2 - t0) * 1e3, (t2 - t1) * 1e3))
            losses.append(float(loss.item()))
            tables.append(net.embedding.weight.data()._data.detach().clone())
        return {"net": net, "trainer": trainer, "losses": losses, "tables": tables,
                "table0": table0, "ms": ms}

    sgd = ("sgd", {"learning_rate": LM_LR})
    s, d = run(card, True, sgd), run(card, False, sgd)
    sgd_loss_rel = max(abs(a - b) / abs(b) for a, b in zip(s["losses"], d["losses"]))
    sgd_table_rel = max(_rel(a, b) for a, b in zip(s["tables"], d["tables"]))
    del s, d
    adam = ("adam", {"learning_rate": 1e-3})
    sa = run(card, True, adam)
    cpu = run("cpu", True, adam)
    da = run(card, False, adam)
    adam_cpu_rel = max(abs(a - b) / abs(b) for a, b in zip(sa["losses"], cpu["losses"]))
    touched = torch.zeros(vocab, dtype=torch.bool, device=sa["table0"].device)
    for x, _ in batches:
        touched[torch.as_tensor(x.reshape(-1), dtype=torch.long, device=touched.device)] = True
    w = sa["tables"][-1]
    slot = next(i for i, (_, p) in enumerate(sa["trainer"]._params)
                if p is sa["net"].embedding.weight)
    m, v = sa["trainer"]._states[slot]
    untouched_same = bool(torch.equal(w[~touched], sa["table0"][~touched]))
    moments_zero = bool((m[~touched] == 0).all()) and bool((v[~touched] == 0).all())
    touched_moved = bool((w[touched] != sa["table0"][touched]).any())
    out = {"sgd_sparse_vs_dense": {"loss_rel": sgd_loss_rel, "table_rel": sgd_table_rel},
           "adam_card_vs_cpu_rel": adam_cpu_rel, "adam_losses": sa["losses"],
           "adam_cpu_losses": cpu["losses"], "rows_touched": int(touched.sum()),
           "untouched_rows_equal": untouched_same, "untouched_moments_zero": moments_zero,
           "ms_step_sparse_adam": statistics.median(r[0] for r in sa["ms"][1:]),
           "ms_update_sparse_adam": statistics.median(r[1] for r in sa["ms"][1:]),
           "ms_step_dense_adam": statistics.median(r[0] for r in da["ms"][1:]),
           "ms_update_dense_adam": statistics.median(r[1] for r in da["ms"][1:])}
    summary_net = sa["net"]
    del sa, cpu, da
    check(sgd_loss_rel <= SP_DENSE_TOL and sgd_table_rel <= SP_DENSE_TOL,
          f"sparse SGD off the dense model: {out['sgd_sparse_vs_dense']}")
    check(adam_cpu_rel <= SP_CPU_TOL, f"lazy Adam card losses off the CPU port's: {out}")
    check(untouched_same and moments_zero and touched_moved,
          f"lazy Adam moved rows no batch touched (or none it touched): {out}")
    return out, summary_net


def obw_table(torch, args, card="cuda", vocab=OBW_VOCAB, dim=OBW_DIM, B=OBW_B, T=OBW_T,
              steps=OBW_STEPS):
    """(b): ``Embedding(793471, 512, sparse_grad=True)`` with lazy Adam
    through ``gluon.Trainer``, 5 steps of B x T ids: the peak of every
    sparse step below table + moments + OBW_SLACK_GB over what was
    allocated before the table; untouched rows and moments bit for bit,
    touched rows against the CPU port fed the same ids; ms a step and
    peak GB beside the same table with a dense gradient and Adam step."""
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch import np as mnp
    from mxnet_tpu_torch.sparse import RowSparseNDArray
    on_card = card != "cpu"
    rng = np.random.RandomState(args.seed + 16)
    ids = [rng.randint(0, vocab, (B, T)).astype("int32") for _ in range(steps)]
    gen = torch.Generator(device=card).manual_seed(args.seed + 16)
    table_gb = vocab * dim * 4 / 1e9

    def build(device, sparse, init):
        net = gluon.nn.Embedding(vocab, dim, sparse_grad=sparse, weight_initializer="zeros")
        net.initialize(device=mx.Device(device))
        net.weight.set_data(init.to(device))
        return net, gluon.Trainer(net.collect_params(), "adam", {"learning_rate": OBW_LR})

    def train(device, sparse, init):
        base = torch.cuda.memory_allocated() if device != "cpu" else 0
        net, trainer = build(device, sparse, init)
        dev = mx.Device(device)
        peaks, ms = [], []
        for x in ids:
            xd = mnp.array(x, device=dev)
            if device != "cpu":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with autograd.record():
                loss = (net(xd) ** 2).mean()
            loss.backward()
            check(isinstance(net.weight.grad(), RowSparseNDArray) == sparse,
                  f"the {vocab}-row table's gradient with sparse_grad={sparse}")
            _sync(torch, device)
            t1 = time.perf_counter()
            trainer.step(1)
            _sync(torch, device)
            if device != "cpu":
                peaks.append((torch.cuda.max_memory_allocated() - base) / 1e9)
            t2 = time.perf_counter()
            ms.append(((t2 - t0) * 1e3, (t2 - t1) * 1e3))
        return net, trainer, peaks, ms

    init = torch.rand(vocab, dim, generator=gen, device=card) * 0.2 - 0.1
    init_host = init.cpu()
    net, trainer, peaks, ms = train(card, True, init)
    w = net.weight.data()._data
    m, v = trainer._states[0]
    touched = torch.zeros(vocab, dtype=torch.bool, device=w.device)
    for x in ids:
        touched[torch.as_tensor(x.reshape(-1), dtype=torch.long, device=w.device)] = True
    untouched_same = bool(torch.equal(w[~touched], init[~touched]))
    moments_zero = bool((m[~touched] == 0).all()) and bool((v[~touched] == 0).all())
    tw, tm, tv = (t[touched].cpu() for t in (w, m, v))
    del net, trainer, w, m, v, init
    if on_card:
        torch.cuda.empty_cache()
    cnet, ctrainer, _, cpu_ms = train("cpu", True, init_host)
    cw = cnet.weight.data()._data
    cm, cv = ctrainer._states[0]
    tc = touched.cpu()
    cpu_rel = max(_rel(tw, cw[tc]), _rel(tm, cm[tc]), _rel(tv, cv[tc]))
    del cnet, ctrainer, cw, cm, cv
    dnet, dtrainer, dpeaks, dms = train(card, False, init_host)
    del dnet, dtrainer
    if on_card:
        torch.cuda.empty_cache()
    limit = table_gb * 3 + OBW_SLACK_GB
    def med(rows, k):
        return statistics.median(r[k] for r in rows[1:])
    out = {"table_gb": table_gb, "moments_gb": 2 * table_gb, "rows_touched": int(touched.sum()),
           "peak_gb_steps": peaks, "peak_limit_gb": limit,
           "ms_step": med(ms, 0), "ms_update": med(ms, 1), "ms_steps": [r[0] for r in ms],
           "update_share": med(ms, 1) / med(ms, 0),
           "dense_peak_gb_steps": dpeaks, "dense_ms_step": med(dms, 0),
           "dense_ms_update": med(dms, 1), "cpu_ms_step": med(cpu_ms, 0),
           "touched_vs_cpu_rel": cpu_rel, "untouched_rows_equal": untouched_same,
           "untouched_moments_zero": moments_zero}
    if on_card:
        check(max(peaks) < limit, f"a sparse step on the {vocab} x {dim} table peaked at "
              f"{max(peaks):.3f} GB over the phase's start (table + moments + {OBW_SLACK_GB} "
              f"= {limit:.3f}): a table-shaped gradient or temporary")
    check(untouched_same and moments_zero, f"lazy Adam moved untouched rows: {out}")
    check(cpu_rel <= OBW_CPU_TOL, f"touched rows off the CPU port's: {cpu_rel}")
    return out


def _chi2_p(observed, probs):
    """Pearson's chi-square p-value of ``observed`` counts against
    ``probs`` (bins with an expected count below 5 pooled into the last)."""
    import numpy as np
    from scipy import stats
    n = observed.sum()
    exp = probs * n
    keep = exp >= 5
    obs = np.append(observed[keep], observed[~keep].sum())
    ex = np.append(exp[keep], exp[~keep].sum())
    if ex[-1] == 0:
        obs, ex = obs[:-1], ex[:-1]
    ex = ex * obs.sum() / ex.sum()
    return float(stats.chisquare(obs, ex).pvalue)


def sampler_checks(torch, args, card="cuda", draws=SAMPLER_DRAWS):
    """(c): each rejection sampler drawn with ``device=`` the card equals
    the CPU port's draw bit for bit, and passes a KS (continuous) or
    chi-square (discrete) test against scipy.stats at ``draws`` draws."""
    import numpy as np
    from scipy import stats
    import mxnet_tpu_torch as mx
    r = mx.np.random
    mean, cov = np.array([0.5, -1.0], "float32"), np.array([[2.0, 0.6], [0.6, 1.0]], "float32")
    p4 = np.array([0.1, 0.2, 0.3, 0.4], "float32")
    n = draws
    cases = {
        "gamma": lambda dev: r.gamma(2.5, 2.0, size=(n,), device=dev),
        "beta": lambda dev: r.beta(2.0, 3.0, size=(n,), device=dev),
        "chisquare": lambda dev: r.chisquare(3.0, size=(n,), device=dev),
        "f": lambda dev: r.f(3.0, 5.0, size=(n,), device=dev),
        "binomial": lambda dev: r.binomial(20, 0.3, size=(n,), device=dev),
        "poisson": lambda dev: r.poisson(4.0, size=(n,), device=dev),
        "poisson_rejection": lambda dev: r.poisson(30.0, size=(n,), device=dev),
        "multinomial": lambda dev: r.multinomial(10, [0.2, 0.3, 0.5], size=(n, 3), device=dev),
        "multivariate_normal": lambda dev: r.multivariate_normal(
            mx.np.array(mean, device=dev), mx.np.array(cov, device=dev), size=(n // 2,),
            device=dev),
        "choice_noreplace": lambda dev: r.choice(n * 2, size=(n,), replace=False,
                                                 p=mx.np.array(np.full(n * 2, 1.0 / (n * 2),
                                                                       "float32"), device=dev),
                                                 device=dev),
    }
    chol_inv = np.linalg.inv(np.linalg.cholesky(cov.astype(np.float64)))

    def pvalue(name, x):
        if name == "gamma":
            return stats.kstest(x, stats.gamma(2.5, scale=2.0).cdf).pvalue
        if name == "beta":
            return stats.kstest(x, stats.beta(2.0, 3.0).cdf).pvalue
        if name == "chisquare":
            return stats.kstest(x, stats.chi2(3.0).cdf).pvalue
        if name == "f":
            return stats.kstest(x, stats.f(3.0, 5.0).cdf).pvalue
        if name == "multivariate_normal":
            z = (x.astype(np.float64) - mean) @ chol_inv.T
            return stats.kstest(z.reshape(-1), stats.norm().cdf).pvalue
        if name == "choice_noreplace":
            # uniform p: every item of the population equally likely
            return _chi2_p(np.bincount(x // 200, minlength=2 * n // 200).astype(float),
                           np.full(2 * n // 200, 1.0 / (2 * n // 200)))
        k = np.arange(0, 80)
        dist = {"binomial": stats.binom(20, 0.3), "poisson": stats.poisson(4.0),
                "poisson_rejection": stats.poisson(30.0), "multinomial": stats.binom(10, 0.2)}[name]
        col = x[:, 0] if name == "multinomial" else x
        return _chi2_p(np.bincount(col.astype(np.int64), minlength=80)[:80].astype(float),
                       dist.pmf(k))

    out = {}
    for name, fn in cases.items():
        mx.random.seed(args.seed + 16)
        on_cpu = fn("cpu").asnumpy()
        mx.random.seed(args.seed + 16)
        t0 = time.perf_counter()
        got = fn(card)
        _sync(torch, card)
        ms = (time.perf_counter() - t0) * 1e3
        check(got.device.device_type == ("cpu" if card == "cpu" else "gpu"),
              f"np.random.{name} did not land on {card}")
        got = got.asnumpy()
        same = got.dtype == on_cpu.dtype and np.array_equal(got, on_cpu)
        if name == "choice_noreplace":
            check(np.unique(got).size == got.size, "choice(replace=False) drew an item twice")
        p = float(pvalue(name, got))
        out[name] = {"ms": ms, "p": p, "same_bits_as_cpu": bool(same)}
        check(same, f"np.random.{name} on {card} differs from the CPU port's draw")
        check(p > SAMPLER_P_MIN, f"np.random.{name} fails its goodness-of-fit test: p = {p}")
    return out


def surface_checks(torch, args, card="cuda", lm_net=None, lm_x=None):
    """(d): a loaded extension library and a CustomOp on the card against
    the CPU (values and gradients), ``mx.nd`` ops and save/load on the
    card, ``check_consistency`` across CPU and card, NaiveEngine leaving no
    pending work, ``runtime.Features()`` and ``print_summary``."""
    import io
    import contextlib
    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, engine, library, operator, runtime, test_utils
    from mxnet_tpu_torch.visualization import print_summary
    out = {}
    root = Path(__file__).resolve().parent
    build_dir = root / "build" / "ext"
    build_dir.mkdir(parents=True, exist_ok=True)
    so = build_dir / "libmyops.so"
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(so),
                    str(root / "tests" / "ext" / "myops.cc")], check=True, timeout=300)
    lib = library.load(str(so))
    x_host = np.array([[1.0, -2.0, 0.5], [3.0, 0.25, -1.5]], "float32")
    res = {}
    for dev in ("cpu", card):
        x = mx.np.array(x_host, device=dev)
        x.attach_grad()
        with autograd.record():
            y = lib.ext_square(x)
            (y * 3.0).sum().backward()
        res[dev] = (y.asnumpy(), x.grad.asnumpy(), lib.ext_outer(
            mx.np.array(x_host[0], device=dev), mx.np.array(x_host[1], device=dev)).asnumpy())
        check(y._data.device.type == torch.device(dev).type, f"ext_square left {dev}")
    check(all(np.array_equal(a, b) for a, b in zip(res["cpu"], res[card])),
          "the extension library's forward or backward differs between card and CPU")

    @operator.register("smoke_cube")
    class CubeProp(operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            class Cube(operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], np.asarray(in_data[0]) ** 3)

                def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
                    in_grad[0][...] = 3 * np.asarray(in_data[0]) ** 2 * np.asarray(out_grad[0])
            return Cube()

    cres = {}
    for dev in ("cpu", card):
        x = mx.np.array(x_host, device=dev)
        x.attach_grad()
        with autograd.record():
            y = mx.npx.Custom(x, op_type="smoke_cube")
            y.sum().backward()
        cres[dev] = (y.asnumpy(), x.grad.asnumpy())
    check(all(np.array_equal(a, b) for a, b in zip(cres["cpu"], cres[card])),
          "the CustomOp differs between card and CPU")
    with mx.Device(card):
        a = mx.nd.array(x_host)
        b = mx.nd.broadcast_add(a, mx.nd.ones((1, 3)))
        red = [mx.nd.sum(b), mx.nd.max(b, axis=1), mx.nd.mean(b * b)]
        f = build_dir / "nd_roundtrip.params"
        mx.nd.save(str(f), {"a": a, "b": b})
        back = mx.nd.load(str(f))
        check(back["b"]._data.device.type == torch.device(card).type,
              "mx.nd.load did not land on the card")
        check(np.array_equal(back["b"].asnumpy(), b.asnumpy())
              and np.allclose(red[0].asnumpy(), (x_host + 1).sum())
              and np.allclose(red[1].asnumpy(), (x_host + 1).max(axis=1))
              and np.allclose(red[2].asnumpy(), ((x_host + 1) ** 2).mean()),
              "mx.nd arithmetic, reductions or save/load on the card")
    devices = [mx.cpu(), mx.Device(card)]
    xs = [np.random.RandomState(args.seed).randn(64, 48).astype("float32")]
    for fn in (lambda t: mx.np.tanh(t) * 2, lambda t: mx.nd.softmax(t, axis=-1),
               lambda t: mx.np.dot(t, t.T).sum(axis=0)):
        test_utils.check_consistency(fn, xs, devices=devices)
    if card != "cpu":
        big = torch.randn(NAIVE_N, NAIVE_N, device=card)
        bn = mx.NDArray(big)
        torch.cuda.synchronize()
        _ = bn @ bn
        threaded_idle = bool(torch.cuda.current_stream().query())
        engine.set_engine_type("NaiveEngine")
        try:
            _ = bn @ bn
            naive_idle = bool(torch.cuda.current_stream().query())
        finally:
            engine.set_engine_type("ThreadedEngine")
        out["naive_engine"] = {"stream_idle_after_op": naive_idle,
                               "threaded_stream_idle_after_op": threaded_idle}
        check(naive_idle, "NaiveEngine: an op returned with work pending on the stream")
    feats = runtime.Features()
    out["features"] = {k: f.enabled for k, f in feats.items()}
    check(feats.is_enabled("CUDA") == (card != "cpu"), f"runtime.Features(): {feats}")
    if lm_net is not None:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            table = print_summary(lm_net, lm_x, lm_net.rnn.begin_state(
                lm_x.shape[1], device=lm_x._data.device))
        check("Embedding" in table and "LSTM" in table and "Total params" in table,
              f"print_summary of the LM: {table}")
        out["summary_lines"] = len(table.splitlines())
    return out


def sparse_frontend(torch, args, card="cuda", lm_kw=None, obw_kw=None, draws=SAMPLER_DRAWS):
    """Phase 16: (a) the LSTM LM with a row-sparse embedding gradient, (b)
    lazy Adam on the One Billion Word vocabulary's table, (c) the rejection
    samplers on the card, (d) the extension library, CustomOp, ``mx.nd``,
    ``test_utils``, NaiveEngine, ``runtime`` and ``print_summary`` on the
    card. ``card``, ``lm_kw`` and ``obw_kw`` cut it down for a CPU
    rehearsal. Starts only with at most LT_HELD_GB still allocated."""
    import mxnet_tpu_torch as mx
    lm_kw, obw_kw = lm_kw or {}, obw_kw or {}
    t_phase = time.perf_counter()
    if card != "cpu":
        held = torch.cuda.memory_allocated() / 1e9
        emit({"sparse_frontend_allocated_gb_at_start": held})
        check(held <= LT_HELD_GB, f"{held} GB of device memory still allocated as phase 16 "
              f"starts (> {LT_HELD_GB}): an earlier phase's model or engine was not freed")
    parts = {}
    t0 = time.perf_counter()
    lm, lm_net = sparse_lm(torch, args, card, **lm_kw)
    emit({"sparse_frontend_lm": lm})
    parts["lm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    obw = obw_table(torch, args, card, **obw_kw)
    emit({"sparse_frontend_obw": obw})
    parts["obw_table"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    samplers = sampler_checks(torch, args, card, draws)
    emit({"sparse_frontend_samplers": samplers})
    parts["samplers"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, _ = lm_batch(args, lm_kw.get("vocab", LM_VOCAB), lm_kw.get("B", LM_B),
                    lm_kw.get("T", LM_T))
    surface = surface_checks(torch, args, card, lm_net, mx.np.array(x, device=mx.Device(card)))
    emit({"sparse_frontend_surface": surface})
    parts["surface"] = time.perf_counter() - t0
    del lm_net
    emit({"sparse_frontend_s": time.perf_counter() - t_phase, "parts_s": parts})
    return {"lm": lm, "obw": obw, "samplers": samplers}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: chip_smoke.py runs the port on an "
                           "NVIDIA GPU only")
    from mxnet_tpu_torch import _build
    from mxnet_tpu_torch.contrib.quantization import quantize_net
    from mxnet_tpu_torch.models import GPT2_SMALL, GPTModel
    from mxnet_tpu_torch.ops.fused_block_gemv import pack_gpt_block
    check(GPT2_SMALL.dropout == DEFAULT_DROPOUT,
          f"GPTConfig()'s dropout {GPT2_SMALL.dropout} != DEFAULT_DROPOUT {DEFAULT_DROPOUT}")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain/library in full f32
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    per_source = _build.build_all()
    # per kernel: its entry function, then its registers and spills
    logs = {n: [ln.strip() for ln in (_build.BUILD_DIR / f"{n}.log").read_text()
                .splitlines() if "entry function" in ln or "registers" in ln or "spill" in ln]
            for n in per_source}
    emit({"build_s": time.perf_counter() - t0, "per_source_s": per_source,
          "ptxas": logs})

    with torch.no_grad():
        net = GPTModel(GPT2_SMALL, device="cuda").init_weights(args.seed)
        quantize_net(net, fused_decode=True)
        cpu_net = GPTModel(GPT2_SMALL, device="cpu").init_weights(args.seed)
        quantize_net(cpu_net, fused_decode=True)

        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        timer = Timer(torch)
        k3 = kernel_gemv(torch, timer, gen, 8)
        k5 = kernel_k5(torch, timer, gen,
                       pack_gpt_block(net.blocks[0], eps=net.cfg.layer_norm_eps))
        k8 = kernel_k8(torch, timer, gen, net.head_weights())
        k8l = kernel_k8_lanes(torch, timer, gen, net.head_weights())
        k67 = kernel_k6_k7(torch, timer, gen,
                           pack_gpt_block(net.blocks[0], eps=net.cfg.layer_norm_eps))
        sampling = sampling_card(torch, args, timer)
    emit({"k3": k3, "k5": k5, "k8": k8, "k8_lanes": k8l, "k6_k7": k67})
    emit({"sampling": sampling})

    serve_counts = serve(torch, args, net, cpu_net)
    k1_counts = serve_k1(torch, args, net, serve_counts["k4"])
    paged_counts = {phase: serve_paged(torch, args, net, phase) for phase in "AB"}
    cs_counts = constrained_spec(torch, args, net, cpu_net)
    http_counts = http_serve(torch, args, net, cpu_net)
    del cpu_net
    fleet_bf16 = gpt2_bf16(torch, args, "cuda", 8)
    fleet_counts = fleet_serve(torch, args, net, fleet_bf16)
    del fleet_bf16
    torch.cuda.empty_cache()
    t_modes = time.perf_counter()
    for window in ("contiguous", "paged_B"):
        dispatch_modes(torch, args, net, window)
    emit({"dispatch_modes_s": time.perf_counter() - t_modes})
    int8_bytes = quant_bytes(torch, net)
    del net
    torch.cuda.empty_cache()

    int4_counts, r4k = int4_stage(torch, args, timer, gen, int8_bytes)
    torch.cuda.empty_cache()
    b16_counts, r16k = bf16_stage(torch, args, timer, gen)
    emit({"kv_bytes_f32_bf16": {
        "contiguous": [serve_counts["kv_bytes"], b16_counts["contiguous"]["kv_bytes"]],
        "paged_A": [paged_counts["A"]["kv_bytes"], b16_counts["A"]["kv_bytes"]],
        "paged_B": [paged_counts["B"]["kv_bytes"], b16_counts["B"]["kv_bytes"]]}})

    k1, k2 = kernel_flash(torch, timer, gen)
    torch.cuda.empty_cache()
    train_counts = train(torch, args, DEFAULT_DROPOUT)   # this slice's path
    torch.cuda.empty_cache()
    train(torch, args, 0.0)
    torch.cuda.empty_cache()
    for dropout in (DEFAULT_DROPOUT, 0.0):
        train_card_vs_cpu(torch, args, dropout)
    torch.cuda.empty_cache()
    checkpoint_resume(torch, args)
    torch.cuda.empty_cache()
    gluon_counts = gluon_substrate(torch, args)
    torch.cuda.empty_cache()
    with torch.no_grad():
        kl = kernel_llama_widths(torch, timer, gen)
    torch.cuda.empty_cache()
    llama = llama_serve(torch, args, kl)
    torch.cuda.empty_cache()
    llama_train_rows = llama_train(torch, args, timer, gen)
    torch.cuda.empty_cache()
    vision_rows = vision_train(torch, args, timer, gen)
    torch.cuda.empty_cache()
    nlp_rows = nlp_train(torch, args, timer, gen)
    torch.cuda.empty_cache()
    data_counts = data_train(torch, args)
    torch.cuda.empty_cache()
    nms_row = rnn_detect(torch, args, timer)
    torch.cuda.empty_cache()
    sparse_frontend(torch, args)

    def routes(*phases):
        return {r: sum(c["routes"][r] for c in phases) for r in ("warp", "mma")}

    r8 = routes(serve_counts, paged_counts["A"], paged_counts["B"], *cs_counts.values(),
                http_counts)

    def cs_launches(kind):
        return sum(c.get(kind, 0) for c in cs_counts.values())

    r4 = routes(int4_counts["contiguous"], int4_counts["A"], int4_counts["C"])
    emit({"gemv_routes": {"int8": r8, "int4": r4}})

    def lanes(keys, *phases):
        """Launches of the given dtype lanes over the given phases."""
        return sum(c["lanes"].get(k, 0) for c in phases for k in keys)

    b8 = [b16_counts[p] for p in ("generate", "contiguous", "A", "B")]
    b4 = [b16_counts[p] for p in ("int4_generate", "int4_contiguous")]
    emit({"bf16_lanes": {p: c["lanes"] for p, c in b16_counts.items()}})
    # block 0 takes bf16 x, blocks 1-11 f32 x; both lanes must run
    for key, phases in (("fused_block:x_bf16:kv_bf16", b8), ("fused_block:x_f32:kv_bf16", b8),
                        ("fused_block_int4:x_bf16:kv_bf16", b4),
                        ("fused_block_int4:x_f32:kv_bf16", b4)):
        check(lanes([key], *phases) > 0, f"the {key} lane never launched")
    kv16 = ("x_bf16:kv_bf16", "x_f32:kv_bf16")
    gemv8, gemv4 = "mxnet_tpu_torch/csrc/int8_gemv.cu", "mxnet_tpu_torch/csrc/int4_gemv.cu"
    head_src = "mxnet_tpu_torch/csrc/lm_head_sample.cu"
    emit({"gemv_heads_warp": {"int8": k3["head"], "int4": r4k["K4"]["head"],
                              "int8_bf16_x": r16k["K3"]["head"],
                              "int4_bf16_x": r16k["K4"]["head"]}})
    # the Llama path's launches (phase 9): K3 over the paged serving phase
    # and int8 generate, K4 over int4 generate, K8 per tied engine and lane
    l3 = [llama["serve"], llama["int8"]]
    l4 = [llama["int4"]]

    def llama_routes(route, parts, lane_keys=None):
        if lane_keys:
            return lanes(lane_keys, *parts)
        return sum(c["routes"][route] for c in parts)

    def llama_width(key, parts):
        return sum(c["widths"].get(key, 0) for c in parts)

    def k8_lane(codec, decoder):
        return llama["tied"][codec][decoder]["k8_lane"]["launches"]

    llama_launches = {
        "int8_gemv": llama_routes("warp", l3), "int8_gemv_mma": llama_routes("mma", l3),
        "int8_gemv_bf16": llama_routes(None, l3, ["gemv:warp:bf16"]),
        "int8_gemv_mma_bf16": llama_routes(None, l3, ["gemv:mma:bf16"]),
        "int4_gemv": llama_routes("warp", l4), "int4_gemv_mma": llama_routes("mma", l4),
        "int4_gemv_bf16": llama_routes(None, l4, ["gemv_int4:warp:bf16"]),
        "int4_gemv_mma_bf16": llama_routes(None, l4, ["gemv_int4:mma:bf16"]),
        "int8_gemv_head": llama_width("warp:128256", l3),
        "int4_gemv_head": llama_width("warp:128256", l4),
        "lm_head_sample": k8_lane("int8", "per_layer"),
        "lm_head_sample_int4": k8_lane("int4", "per_layer"),
        "lm_head_sample_bf16": k8_lane("int8", "stacked"),
        "lm_head_sample_int4_bf16": k8_lane("int4", "stacked"),
        "lm_head_sample_mask": 0, "lm_head_sample_int4_mask": 0,
        "flash_attention_fwd": llama["k1"], "flash_attention_bwd": 0}

    def fleet_lane(prefix, suffix=""):
        return sum(n for k, n in fleet_counts["lanes"].items()
                   if k.startswith(prefix) and k.endswith(suffix))

    # phase 13's launches (the fleet: K3's prefill chunks, K6 over f32 and
    # bf16 pools, K7 over imported pages, K8 for every decode token)
    fleet_launches = {
        "int8_gemv": fleet_lane("gemv:warp:f32"), "int8_gemv_mma": fleet_lane("gemv:mma:f32"),
        "int8_gemv_bf16": fleet_lane("gemv:warp:bf16"),
        "int8_gemv_mma_bf16": fleet_lane("gemv:mma:bf16"),
        "fused_block_decode_paged": fleet_lane("fused_block_paged:", "kv_f32"),
        "fused_block_decode_paged_bf16": fleet_lane("fused_block_paged:", "kv_bf16"),
        "fused_block_decode_paged_dma": fleet_lane("fused_block_paged_dma:", "kv_f32"),
        "lm_head_sample": fleet_counts.get("fused_head", 0)}
    rows = []
    for name, src, replaces, launched, r in (
            ("int8_gemv", gemv8, "mxnet_tpu/ops/int8_gemv.py:113", r8["warp"], k3["warp"]),
            ("int8_gemv_mma", gemv8, "mxnet_tpu/ops/int8_gemv.py:113", r8["mma"], k3["mma"]),
            ("fused_block_decode", "mxnet_tpu_torch/csrc/fused_block_decode.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:424",
             serve_counts.get("fused_block", 0) + cs_launches("fused_block"), k5),
            ("fused_block_decode_paged", "mxnet_tpu_torch/csrc/fused_block_decode_paged.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:601",
             paged_counts["A"].get("fused_block_paged", 0) + cs_launches("fused_block_paged")
             + http_counts.get("fused_block_paged", 0), k67["K6"]),
            ("fused_block_decode_paged_dma",
             "mxnet_tpu_torch/csrc/fused_block_decode_paged_dma.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:810",
             paged_counts["B"].get("fused_block_paged_dma", 0), k67["K7"]),
            ("lm_head_sample", "mxnet_tpu_torch/csrc/lm_head_sample.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:1218",
             serve_counts.get("fused_head", 0) + http_counts.get("fused_head", 0), k8),
            ("int4_gemv", gemv4, "mxnet_tpu/ops/int8_gemv.py:186", r4["warp"], r4k["K4"]["warp"]),
            ("int4_gemv_mma", gemv4, "mxnet_tpu/ops/int8_gemv.py:186", r4["mma"],
             r4k["K4"]["mma"]),
            ("fused_block_decode_int4", "mxnet_tpu_torch/csrc/fused_block_decode.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:424",
             int4_counts["contiguous"].get("fused_block_int4", 0), r4k["K5"]),
            ("fused_block_decode_paged_int4", "mxnet_tpu_torch/csrc/fused_block_decode_paged.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:601",
             int4_counts["A"].get("fused_block_paged_int4", 0), r4k["K6"]),
            ("fused_block_decode_paged_dma_int4",
             "mxnet_tpu_torch/csrc/fused_block_decode_paged_dma.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:810",
             int4_counts["C"].get("fused_block_paged_dma_int4", 0), r4k["K7"]),
            ("lm_head_sample_int4", "mxnet_tpu_torch/csrc/lm_head_sample.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:1218",
             int4_counts["contiguous"].get("fused_head_int4", 0), r4k["K8"]),
            ("int8_gemv_bf16", gemv8, "mxnet_tpu/ops/int8_gemv.py:113",
             lanes(["gemv:warp:bf16"], *b8), r16k["K3"]["warp"]),
            ("int8_gemv_mma_bf16", gemv8, "mxnet_tpu/ops/int8_gemv.py:113",
             lanes(["gemv:mma:bf16"], *b8), r16k["K3"]["mma"]),
            ("fused_block_decode_bf16", "mxnet_tpu_torch/csrc/fused_block_decode.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:424",
             lanes(["fused_block:" + k for k in kv16], *b8), r16k["K5"]),
            ("fused_block_decode_paged_bf16", "mxnet_tpu_torch/csrc/fused_block_decode_paged.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:601",
             lanes(["fused_block_paged:" + k for k in kv16], b16_counts["A"]), r16k["K6"]),
            ("fused_block_decode_paged_dma_bf16",
             "mxnet_tpu_torch/csrc/fused_block_decode_paged_dma.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:810",
             lanes(["fused_block_paged_dma:" + k for k in kv16], b16_counts["B"]), r16k["K7"]),
            ("int4_gemv_bf16", gemv4, "mxnet_tpu/ops/int8_gemv.py:186",
             lanes(["gemv_int4:warp:bf16"], *b4), r16k["K4"]["warp"]),
            ("int4_gemv_mma_bf16", gemv4, "mxnet_tpu/ops/int8_gemv.py:186",
             lanes(["gemv_int4:mma:bf16"], *b4), r16k["K4"]["mma"]),
            ("fused_block_decode_int4_bf16", "mxnet_tpu_torch/csrc/fused_block_decode.cu",
             "mxnet_tpu/ops/fused_block_gemv.py:424",
             lanes(["fused_block_int4:" + k for k in kv16], *b4), r16k["K5_int4"]),
            ("int8_gemv_head", gemv8, "mxnet_tpu/ops/int8_gemv.py:113",
             k1_counts["widths"].get("warp:50304", 0), head_row(k3["head"])),
            ("int4_gemv_head", gemv4, "mxnet_tpu/ops/int8_gemv.py:186",
             int4_counts["contiguous"]["widths"].get("warp:50304", 0),
             head_row(r4k["K4"]["head"])),
            ("flash_attention_fwd", "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
             "mxnet_tpu/ops/attention.py:286", train_counts.get("flash_fwd", 0), k1),
            ("flash_attention_bwd", "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
             "mxnet_tpu/ops/attention.py:383", train_counts.get("flash_bwd", 0), k2)):
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launched,
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                     # K5 with every row at position 64; K6 at B 8
                     **{k: r[k] for k in ("ms_pos64", "ms_b8", "bound_ms_b8") if k in r}})
        if name.startswith("flash_attention"):
            kind = "flash_fwd" if name.endswith("fwd") else "flash_bwd"
            # launched from the tape by the gluon_substrate phase's block
            rows[-1]["launches_gluon"] = gluon_counts[kind]
            # phase 14 (a): GPT-2 fed through the DataLoader and the prefetcher
            rows[-1]["launches_data"] = data_counts.get(kind, 0)
            check(rows[-1]["launches_data"] > 0, f"{name} never launched on the input path")
        if name in llama_launches:
            rows[-1]["launches_llama"] = llama_launches[name]
        if name in fleet_launches:
            rows[-1]["launches_fleet"] = fleet_launches[name]
        check(rows[-1]["launches"] > 0, f"{name} never launched on its main path")
    for name in ("int8_gemv", "int8_gemv_mma", "fused_block_decode_paged",
                 "fused_block_decode_paged_bf16", "fused_block_decode_paged_dma",
                 "lm_head_sample"):
        check(fleet_launches[name] > 0, f"{name} never launched on the fleet path")
    # K8's mask and bf16 lanes: no public API of either package hands K8 a
    # mask or bf16 h (a bf16 GPT's final LayerNorm returns f32, a quantized
    # per-layer Llama's layers return f32, and quantize_net leaves the
    # Dense-free stacked decoder and its tied head alone), so their
    # launches are the direct calls of kernel_k8_lanes' counted phase. A
    # stacked bf16 Llama whose tied head the private _quantize_tied_lm_head
    # quantized reaches the bf16 lane from the engine (launches_llama,
    # phase 9 (d))
    for name, r in (("lm_head_sample_mask", k8l["mask"]), ("lm_head_sample_bf16", k8l["bf16"]),
                    ("lm_head_sample_int4_mask", r4k["K8_lanes"]["mask"]),
                    ("lm_head_sample_int4_bf16", r4k["K8_lanes"]["bf16"])):
        rows.append({"name": name, "route": "cuda", "source": head_src,
                     "replaces": "mxnet_tpu/ops/fused_block_gemv.py:1218",
                     "launches": r["launches"], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                     "launches_llama": llama_launches[name],
                     "path": "direct calls (no public API reaches this lane)"
                     + ("; " + K8_BF16_LLAMA_PATH if name.endswith("bf16") else "")})
        check(rows[-1]["launches"] > 0, f"{name} never launched in its direct-call phase")
    rows += llama_kernel_rows(kl, llama)
    # K1 and K2 at head dim 128 on phase 10's training path (B 2, 32 heads,
    # T 2048, causal bf16): launches counted over (a) and (c)'s steps
    for name, src, replaces, r in (
            ("flash_attention_fwd_hd128", "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
             "mxnet_tpu/ops/attention.py:286", llama_train_rows["k1"]),
            ("flash_attention_bwd_hd128", "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
             "mxnet_tpu/ops/attention.py:383", llama_train_rows["k2"])):
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     **r, "path": "llama_train (a) and (c)"})
        check(r["launches"] > 0, f"{name} never launched on the Llama training path")
    # K1 and K2 at ViT-B/16's shape on phase 11's path (B 32, 12 heads of
    # 64, T 577, not causal, bf16): launches counted over (d)'s steps
    for name, src, replaces, r in (
            ("flash_attention_fwd_vit", "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
             "mxnet_tpu/ops/attention.py:286", vision_rows["k1"]),
            ("flash_attention_bwd_vit", "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
             "mxnet_tpu/ops/attention.py:383", vision_rows["k2"])):
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     **r, "path": "vision_train (d)"})
        check(r["launches"] > 0, f"{name} never launched on the ViT training path")
    # K1 and K2 at BERT-base pretraining's shape on phase 12's path (B 8,
    # 12 heads of 64, T 512, not causal, bf16): launches counted over (b)'s
    # steps
    for name, src, replaces, r in (
            ("flash_attention_fwd_bert", "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
             "mxnet_tpu/ops/attention.py:286", nlp_rows["k1"]),
            ("flash_attention_bwd_bert", "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
             "mxnet_tpu/ops/attention.py:383", nlp_rows["k2"])):
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     **r, "path": "nlp_train (b)"})
        check(r["launches"] > 0, f"{name} never launched on the BERT pretraining path")
    # a kernel the port adds (no TPU kernel): phase 15's greedy NMS sweep
    rows.append(nms_row)
    check(nms_row["launches"] > 0, "nms_sweep never launched on the SSD path")
    emit({"kernels": rows})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
