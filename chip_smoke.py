#!/usr/bin/env python3
"""Drive the PyTorch port (``ncnet_tpu_torch``) on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure (nothing is caught):

  1. the card's name and power limit (``nvidia-smi``); TF32 off for
     float32 matmuls and convolutions, so the plain versions are full f32;
  2. build every CUDA kernel from ``ncnet_tpu_torch/csrc`` with ``nvcc`` for
     ``sm_90a`` (one ``nvcc`` per source, all in parallel);
  3. every kernel against its plain PyTorch version on the card, at the
     shape the paths give it and at the thin test shapes, with CUDA-event
     times of both: the NC stack (B2, bf16, the tensor-core kernel; two
     launches bit-identical at every shape; timed at the coarse-to-fine
     fine tiles' folded (20000, 6⁴), its call on the paths that keep it,
     then stack and per-layer ms and TFLOP/s at the tracked tiles' (5000,
     6⁴) and the dense 800² request's 8 × 50⁴, and at 8 × 25⁴ beside the
     FFT tier's stack on the same volume, the route the chooser takes
     there) and its backward (B3: the dW/db partials on tensor cores, B7,
     their reduction, the transposed conv; timed at the training chunk's
     8 × 25⁴, each layer's dW/db with its FLOP, bound and TFLOP/s beside
     the first design's ms; also held at a 50 × 50 plane), the backward
     on the same saved activations as its twin; the small-C_out conv4d (B5,
     ``csrc/conv4d_small_cout.cu``, the tensor-core kernel for k = 3 and
     5, f32 as three bf16 products) at the fp32 800² path's (4, 50⁴, 16)
     → 1, the coarse-to-fine tiles' (20000, 6⁴, 16) → 1, a k = 3 10 → 1
     case and a bf16 2-channel case, two launches bit-identical, each shape
     timed beside the first design (the CUDA-core kernel) on the same
     inputs, with its bound, TFLOP/s and the cuDNN ``coutfold``
     formulation's time as context; the main shape again with all-positive
     inputs against the twin and the three products' emulation
     (``split_products_reference``);
  4. the serving path at full width: ``BatchMatchEngine`` with the
     PF-Pascal NCNet (ResNet-101 to layer3, NC kernels (5, 5, 5) with
     channels (16, 16, 1), bf16, 400×400 pairs, random weights from a
     seed) answers 3 requests of 4 pairs; the tier chooser sends the 25⁴
     stack to the FFT tier, as the JAX package does, so B2's counter,
     reset just before, must read 0; one request runs again, and the FFT
     stack is held against the plain direct stack on the exact volume the
     path hands it, and the filtered volume against the same forward with
     the plain stack;
  5. the training path at full width: ``create_train_state`` and
     ``make_train_step`` with the published PF-Pascal recipe (batch 16 of
     400² pairs, lr 5e-4, bf16 NC stack, fp32 frozen trunk, automatic
     volume chunks, NaN guard; random weights from a seed, the trunk's
     BatchNorm statistics set from one seeded batch, NC kernels
     centre-peaked with biases off zero; each target its source shifted
     by whole feature cells) take a warm-up step and 3 timed steps; the
     stack's forward takes the FFT tier (no B2 launch) and its backward
     B3, so the launch counters, reset just before, must read B3's
     per-step formula; on the last chunk's exact volume and cotangent the
     FFT stack is held against the plain direct stack and the backward
     kernels against their twin, and the step's loss and NC gradients
     against the same step with the twins routed in for both directions;
     a stage line splits a step's time;
  A. the coarse-to-fine gather kernel (B4, ``csrc/gather_tile_corr.cu``,
     the tensor-core kernel)
     against its plain twin on the card: the serving path's (4, 625, 4)
     tiles at C = 1024, patch 6; a halo-3 case (patch 8, origins off the
     factor's grid); a small odd-C case; two launches bit-identical; kernel,
     plain, bound and library (one cuBLAS product on pre-gathered patches)
     times;
  B. coarse-to-fine serving at full width: ``BatchMatchEngine`` with the
     PF-Pascal NCNet at ``sparse_topk=4`` (factor 2, halo 2), bf16, 800²
     pairs (a 50² grid; trunk BatchNorm calibrated, NC kernels centre-
     peaked, each target its source shifted by whole cells) answers a
     warm-up and 3 requests of 4 pairs; the coarse 25⁴ pass takes the FFT
     tier, so 6 NC (the fine tiles) and 2 B4 launches per request; B4, the
     fine NC stack and the coarse FFT stack against their plain versions
     on the exact inputs the path handed them, the fine pass against the
     plain fine pass on the kernel path's candidates; candidate agreement, recall and
     shift recovery (beside one dense 800² request) printed; a stage line;
  C. tracked serving: the request's tables become priors, 3 frames through
     ``dispatch_tracked`` (no coarse pass, sources memoized, 6 NC and 2 B4
     launches a frame), one frame's fine pass against the plain one;
  D. fp32 serving at full width: ``BatchMatchEngine`` with the PF-Pascal
     NCNet in fp32 (the JAX default) answers a warm-up and 3 requests of 4
     pairs at 400² (the FFT tier: no B2 or B5 launch; the FFT stack held
     against the plain direct stack on the path's volume) and at 800² (a
     50⁴ volume no tier takes: per layer tapfold, unroll and B5, the two
     symmetric passes one after the other, so 2 B5 launches per request,
     all on the tensor-core kernel; each B5 call held against its twin on
     the path's input, the filtered
     volume against the forward with the twin); a stage line and the peak
     memory;
  S. one serving process: ``MatchService`` with phase B's model and
     weights, the (800, 800) bucket warmed at batch 1, 2 and 4, max_batch
     4, 2 replicas (both on ``cuda:0`` on a one-card machine, one a card
     otherwise) and a feature store in a temporary directory, under an
     event log: 48 raw pairs of 640–800 px a side (each target its source
     rolled) from 2 client threads in groups of 4 submitted under the
     service's lock (one group, one batch) with a 2 s deadline, 6 B6 and 2
     B8 launches a batch (counted where only the worker dispatches); the
     same 48 again, all store hits, tables bitwise the first pass's; every
     group's batch through the engine directly, each result bit-equal to
     its row (the first group's B8 and B6 calls against their twins), and
     the first group's through
     ``Replica.dispatch`` under ``torch.cuda.set_sync_debug_mode("error")``;
     a burst of 40 over a queue of 16 (it must shed ``queue_full``) under
     ``torch.profiler`` (the device busy share) and a request with an
     expired deadline; rep1 failed on fetch until it goes DEAD (2
     failures), every request meanwhile served by rep0, then resurrected
     by a probe; a stream of 6 frames at 800² through ``stream_submit``;
     ``request_drain`` with 8 requests in flight; the outcome identity
     from the event log, request and batch walls, queue depth, store hit
     rate and ms a hit, frame walls, peak memory beside the ledger's
     predicted ladder bytes;
  N. (run right after phase S) the network plane: two backend processes
     on the card (``chip_smoke.py --pod-backend``), each a ``MatchService``
     with phase S's model and weights, written here as a native checkpoint
     and loaded through ``load_params``, and its introspection plane on an
     ephemeral port: A with 2 replicas and ``max_batch`` 4, B with 1
     replica and ``max_batch`` 1; the port's ``MatchRouter`` in this
     process with its own plane.  24 raw pairs of 640–800 px from 2
     ``MatchClient``s through the router (5 s deadline), each table finite
     with scores and quality in [0, 1], each pair B served bit-equal to a
     direct batch-1 dispatch here; B SIGKILLed under a stream (no request
     lost, the failover off-budget, B DEAD) and restarted at its port (the
     probes resurrect it); B SIGTERMed holding 12 admitted requests (the
     router demotes it before its drain completes, no edge error); three
     rollouts on A over ``POST /rollout`` under a stream: a seed-1
     candidate promoted to COMPLETE, the same weights as ``step_000002``
     with the canary quality shift armed rolled back by the PSI gate, and
     ``step_000003`` with a flipped payload refused before any replica;
     ``/metrics`` of the router and of A scraped under load (counters
     monotone, parsed); the router's outcome identity from its event log;
     each backend's launches, 6 B6 and 2 B8 a dispatch, read at its exit;
  T. (run right after phase A) the two probe tools' entry points, each
     with its counts set to 0 just before and read just after:
     ``tools.mosaic_probes.run()`` builds the toolchain
     probes (one source each in ``csrc/probes/``, all at once; every
     port source was built anew in step 2, whose build the port_kernels
     probe reads, else anew beside them), launches each on seeded inputs
     against its plain twin, and prints a ``probes`` line (any FAIL ends
     the run); ``tools.pallas_l2_probe.main`` runs T1 (``csrc/
     conv_l2_fused_lane.cu``, the 16→16 k = 5 layer at 25⁴ in the padded
     fused-lane frame) at B = 8 with bf16 and f32 Y terms (its check at
     B = 2, then ms per volume for the layout, the kernel and the cuDNN
     ``coutfold`` context).  Then T1 at B = 8 against its twin (1e-2
     normalized with bf16 Y, 2⁻⁷ with f32 Y), against relu(unroll conv4d +
     bias) (5 %, the JAX tool's check), two launches bit-identical, halo
     lanes zero, at least 99 % of the nonzero interior outputs bit-equal
     to the twin of its Y dtype and fewer to the other's (the Y rounding,
     which the tolerances cannot see), and kernel, plain, bound and
     ``coutfold`` times; each probe once more against its twin, timed;
  W. (run right after phase T) the NC kernels over the JAX kernels' whole
     shape class: the route's gate (``nc_fused_lane.layer_held``) against
     the libraries' own ``nc_conv4d_supported`` / ``nc_vjp_supported`` at
     every kernel size and width; each layer of ``W_WIDTHS`` at k = 1, 3,
     5, 7 and of ``W_PLANES`` (B6 forward and transposed within 1e-2
     normalized of the twin, B7's dW and db within 1e-2 relative L2, two
     launches bit-identical); then three paths, each with its counts set
     to 0 just before and read just after: (a) coarse-to-fine serving at
     800², B = 4, ``sparse_topk=4``, NC (3, 3, 3) / (32, 32, 1), 3
     requests, the coarse 25⁴ pass and the fine 6⁴ tiles both "resident"
     (9 B6 and 2 B4 launches a request), both stack calls against the
     twin, their stack and layer ms; (b) ``make_train_step`` at batch 16
     of 400² with NC (5, 5, 5) / (8, 8, 1), a warm-up and 3 timed steps,
     the forward on FFT and phase 5's launch formula for B7 and the
     transposed launches, B3 on a chunk against its twin and B7's ms a
     layer; (c) one training step of the IVD stack (3, 3) / (16, 1) on
     400×304 sources and 304×400 targets: the training gate takes the
     tap-swap chain, B7 at (3, 1, 32) and (3, 32, 2), the step's NC
     gradients within 1e-2 relative L2 of the twins' step;
  E. the PF-Pascal eval step at full width: ``make_eval_step`` with the
     PF-Pascal NCNet in bf16 (trunk BatchNorm calibrated, NC kernels
     centre-peaked) on a warm-up and 3 batches of 4 pairs at 400² (seeded
     images resized by ``resize_bilinear_align_corners_np`` and
     ``quantize_u8``, each target its source shifted by whole cells; 20
     keypoint slots, 8 to 20 valid, −1 padded), normalized on the card; the
     FFT tier, so no B2 launch; the ``(4, 6)`` tables checked, one batch's
     quality columns against ``quality_table`` on its own volume and its
     PCK against ``pck_metric`` on the CPU on that volume (at most one
     keypoint apart a sample); the phase runs under an ``EventLog`` with a
     span and an ``eval_batch`` metrics event a batch, and the replayed log
     must hold them; ms a batch and the PCK of the shifted pairs printed;
     the device resize ``resize_bilinear_align_corners`` on the card
     against the CPU's (full f32: within 1e-6 of the image's largest value);
  R. relocalized serving: ``BatchMatchEngine`` with the PF-Pascal NCNet in
     bf16 at ``relocalization_k_size=2`` and 1600² (a 100⁴ correlation
     pooled to 50⁴) answers a warm-up and 3 requests of 4 pairs; the 8 ×
     50⁴ stack takes B2 (the resident tier), 3 launches a request; one
     request's pooling bit-equal to the CPU pooling of the same volume, its
     B2 call against the twin and twice bit-identical; tables ``(4, 6,
     2500)`` on the 100-point fine grid; the point matcher on a pair equal
     to the engine on that pair, and to the request's row 0 wherever the
     batch-1 and batch-4 trunks agree: the batch-4 forward with the pair's
     batch-1 features gives the matcher's row and the other rows
     unchanged, bit for bit (the trunks' difference and the differing
     matches printed); a stage line and the peak memory;
  L. the PF-Pascal eval loop end to end: ``write_pf_pascal_like`` writes 12
     raw pairs at 300 × 500 (each target its source moved by (12, 20) px,
     about one feature cell of the 400² image) and phase E's weights are
     saved as a reference ``.pth.tar``; ``run_eval`` with that checkpoint
     in bf16 at 400², batch 4 (the FFT tier: no B2 launch), then with
     ``sparse_topk=4`` at 800² (each batch a coarse-to-fine request: 6 B2
     and 2 B4 launches), and dense at 800² (3 B2 launches a batch; the
     same pairs' PCK without the candidate selection), each under its
     event log, with no quarantine,
     retry or substitution, and its rows bit-equal to ``make_eval_step`` run
     directly on the batches the loop uploaded; the first batch's PCK
     against ``pck_metric`` on the CPU (one keypoint a sample, as phase E);
     the CLI (``cli/eval_pf_pascal.py``, its fp32 model) at 400², batch 1,
     printing the reference's lines, then the same CLI in a subprocess
     killed by an injected SIGKILL at its fifth journal append and resumed:
     the resumed journal's rows bit-equal to the uninterrupted run's; the
     perf store holds the runs' PCK; walls, the decode / dispatch / fetch
     split and PCK printed;
  F. training end to end: ``write_pair_dataset`` writes 32 train and 16 val
     raw pairs at 400² (each target its source shifted by (32, 48) px, as
     phase 5's), phase 5's start weights (calibrated trunk, centre-peaked
     NC kernels) are saved with ``save_params``, and ``fit`` runs the train
     CLI's configuration of the PF-Pascal recipe (bf16 NC stack, batch 16,
     lr 5e-4, automatic chunks, NaN guard) with ``model.checkpoint`` set to
     them: 2 epochs, a checkpoint every step with the newest 2 kept, steps
     [2, 4) traced by ``NCNET_TPU_PROFILE_STEPS``.  B3's counter must read
     64 a step (8 chunks × (3 dW/db + 3 reductions + 2 transposed)) and
     B2's 0; losses finite; the last two versions and ``best_`` left;
     ``load_params(root)`` bit-equal to the returned state and its payload
     sha verified; the event log's ``run_start``, 4 ``step``, 6
     ``checkpoint_commit``, 2 ``epoch_end`` and ``run_end``; the heartbeat
     at step 4; ``train_step_wall_s`` in the perf store; the trace on disk.
     Then a second ``fit``, one epoch of 64 new pairs without periodic
     checkpoints: its step 3 (mid-epoch, with ``fit``'s own per-step hook)
     must wait for the card once, the loss fetch
     (``torch.cuda.set_sync_debug_mode``), and a trace of the card's
     activity over that step gives the device's busy share; then the CLI in
     subprocesses, SIGTERMed after step 3 and SIGKILLed mid-save of version
     3 (two at a time), each resumed from its root and ending bit-equal
     (params, Adam state, step) to the in-process run, all with PyTorch's
     default TF32 settings; a NaN batch at step 2 skipped with version 2
     equal to version 1; one epoch with ``fe_finetune_params=1`` (the last
     layer3 block's trainable leaves and the NC stack move, every other
     trunk leaf stays bit-equal; 18 B3 launches a step, the whole-batch
     backward's) and one with ``finetune_cp_rank=4`` (the factors move,
     the dense kernels stay; the forced CP tier launches no kernel).  Step
     walls beside phase 5's, checkpoint save ms and bytes, host waits and
     the traced windows' device busy share printed;
  I. InLoc dense matching at the IVD model's full width (ResNet-101 to
     layer3, NC kernels (3, 3) with channels (16, 1), bf16 trunk and stack,
     relocalization k = 2, images to a longest side of 3200; random weights
     from a seed, the trunk's BatchNorm statistics from the query, NC
     kernels centre-peaked): the tap-swap chain's layers (3, 1, 32) and
     (3, 32, 2), then the chain, against the twin on the full pooled volume
     (1, 100, 75, 75, 100), two launches bit-identical, and the chain timed
     against the two-pass (16, 1) route on it; the pair matcher as
     ``bench.py`` builds it, one raw 4032 × 3024 query and 10 raw 1200 ×
     1600 cutouts (crops of it, made on the card) dispatched at depth 2:
     pair walls (mean, p50, p95), tier ``"resident"`` and 2 B2 launches a
     pair, finite tables, one pair's chain call against its twin and its
     filtered volume against the forward with the twins and with the
     two-pass form, a stage line; ``run_inloc_eval`` on 2 queries of 3
     cutouts (every ``.mat`` valid, no retry); the CLI from a reference
     checkpoint, once through, killed by an injected SIGKILL while
     committing its second ``.mat`` and resumed (its tables bit-equal to
     the uninterrupted run's), and with a device error injected at every
     attempt of its first query (quarantined, exit 2);
  P. InLoc localization (no kernel: B2's counter, reset just before, must
     read 0): ``run_localization`` at ``LocalizationConfig``'s defaults (top
     10, score > 0.75, 0.2 degrees, 10,000 samples, pose verification) on a
     synthetic room of known geometry written with numpy (a raw 4032 × 3024
     portrait query, 10 cutouts of 1200 × 1600 with their ``XYZcut`` maps,
     the true one second in the shortlist, 15,000 match rows a cutout, a
     scan of 2.5 M points): the true pose within 5 cm and 0.2 degrees,
     DensePE's top 1 the decoy, pose verification ranking the true cutout
     first, the "InLoc + NCNet" curve 1.0 at 0.25 m; per pair the sampling,
     ``p3p_solve``, scoring (CUDA events) and LO ms, per verification item
     the render, inpainting, ``dense_sift`` (CUDA events) and score ms, the
     stage and query walls; the scorer on the true pair's hypotheses with
     TF32 forced on against TF32 off (every decision) and the CPU (every
     decision more than 16 f32 ulps from the threshold, the best index);
     ``dense_sift`` on the query's 1/8 image under the default TF32
     settings within 1e-5 of the CPU; the first 2 pairs on the card, on the
     CPU (poses bit-equal where the masks agree) and with 2 workers on the
     card (the same ImgLists).  Then phase I's matches (2 queries × 3
     cutouts, crops of their query, so ``XYZcut`` maps of a wall give a
     known pose): ``run_localization`` (every ``.mat`` readable, one error
     line a query, the rate printed, not gated: the weights are random), and
     the CLI once through, again (its artifacts reloaded, the ImgLists
     bit-equal) and with one query's matches ``.mat`` corrupted (that query
     quarantined, exit 2);
  Q. sharded retrieval at InLoc's shortlist width, the IVD model as in
     phase I, written as a native checkpoint and loaded as the tool and the
     CLI load it (bf16 volume and NC stack, the f32 trunk under PyTorch's
     default TF32 settings, the tool's): two structured raw queries (hue
     levels and a stripe cadence of their own under a seeded texture: the
     raw extractor scores noise images all alike), each with a row of 100
     cutouts (the same 100 in both rows, in other orders): 10 crops of the
     query made on the card at the row's last ranks, the other query's 10
     before them, 80 structured distractors.  ``python -m
     ncnet_tpu_torch.tools.build_coarse_index`` builds the backbone index
     (factor 4, at 3200) as stripes 0 and 1 of 2, then stripe 0 again
     (nothing built), and the ``--raw`` index; one entry against the
     matcher's features here at batch 1 (bit-equal, or within 1e-5 of the
     largest value), the raw digests and entries against the images and
     the raw extractor here.  The port's ``build_feature_store`` (in this
     process) builds the dense store of the rows' first panos on the card,
     and a matcher over it reads each warm, the trunk's features here
     within 1e-5.  ``run_inloc_eval`` with ``retrieval_index``
     (top 10 of the 100, coverage 1.0 required) on the backbone and the raw
     index: 2 B6 launches a shortlisted pair (40, where the whole rows
     would take 400), each ``.mat``'s ``shortlist`` equal to
     ``local_shortlist`` here, a ``retrieval_shortlist`` event a query, the
     raw index's recall of a query's own crops at least 0.8 (the backbone
     index's printed: random weights); an index missing 20 of the row falls
     back to the ``.mat`` order (a ``retrieval_fallback`` event, reason
     ``coverage``, 40 launches).  ``run_localization`` on the raw run's
     matches (wall geometry for the shortlisted cutouts): each query's PnP
     top-N is its ``.mat``'s shortlist.  Three ``serve_shard`` processes
     at R = 2 over the backbone store (no CUDA context in them: no
     ``/dev/nvidia<N>`` open, not in ``nvidia-smi``'s compute apps; this
     process, which holds one, must show such files open) behind
     a ``RetrievalCoordinator`` here: 40 queries equal to ``local_shortlist``
     with the scores bit-equal; s1 SIGKILLed under a stream (every answer
     at coverage 1.0, none lost, s1 DEAD) and restarted at its port (the
     probes resurrect it); s2 slowed by 1 s (hedges, the same answers); the
     coordinator's own ``POST /retrieve``; ``/metrics`` of the coordinator
     and a shard parsed; the outcome identity from its event log.  Then one
     bit of a committed entry flipped: ``local_shortlist`` with the card's
     trunk as ``compute`` quarantines it, recomputes it and returns the same
     shortlist.  Index build ms a pano by stage, bytes an entry, retrieval
     plan ms, pair walls, retrieve walls, failover and resurrection times,
     the hedge share and the shards' startup printed beside the card;
     Phase O, the operator tools of ``ncnet_tpu_torch/tools`` on what the
     earlier phases left behind (their logs, heartbeat and perf stores
     copied aside as each phase ends): ``run_report`` (every section) and
     ``trace_export`` replay phase S's log, phase N's three (router,
     backends A and B), phase Q's coordinator log and phase F's
     ``events.jsonl``; N's federated (``--federate``) with every backend
     slice starting inside its router slice (its end, stamped after the
     backend answered, is printed), and ``run_report --pod``'s identity
     equal to what N counted live, 0 lost; ``stall_watchdog`` judges F's
     fresh heartbeat alive (exit 0, as F ends) and its stopped run stalled
     with ``--min-age 0`` (exit 3); while N's pod serves, ``serve_top
     --once`` on backend A and ``stall_watchdog --url`` on the router and A
     (N's rollouts go through ``tools/rollout.py``: ``post_rollout`` and
     ``watch``); ``perf_regress --check`` on the stores L and F filled,
     its findings those of ``check_regressions`` called here, and
     ``--seed`` of a missing artefact refused; ``quality_drift`` green on L's log against a
     reference ``--seed-ref`` wrote from it, red (exit 1) against one from
     a perturbed copy.  Then ``stream_probe`` at full width (ResNet-101,
     the (5, 5, 5) / (16, 16, 1) bf16 stack, ``sparse_topk=4``; 2 streams
     of 8 frames at 192²): the steady segment's coarse passes those of its
     fallback frames alone, its B8 and B6 launches as the tracked path's
     structure gives them (2 and 6 a tracked dispatch, a coarse dispatch's
     as its cold segment measured), the frame identity from its log;
     ``serve_probe`` on one 400² bucket with an injected device failure
     (nothing lost; the dense bf16 400² stack takes the FFT tier, so no
     kernel launches); ``cli/point_transfer_demo --synthetic --device
     cuda`` (its points and PCK as JSON);
  X. (after phase O) the ports of the root tools that had no counterpart
     before (``ncnet_tpu_torch/tools``), each through its ``main`` in this
     process with the kernels' counts set to 0 just before and read just
     after, each printing its summary on a line of its own, any non-zero
     exit ending the run: the kernel probes at full width
     (``nc_resident_probe`` and ``nc_fused_lane_probe`` at 8 × 25⁴: B6
     against the plain stack; ``nc_vjp_resident_probe`` for the PF-Pascal
     and the IVD stacks: B3/B7 against its twin on the same activations;
     ``sparse_corr_probe --tiny`` and at a 50² grid of 1024 channels for k
     = 1, 2, 4, 8 with walls: B8 and the 6⁴ B6 tiles; ``eval_faults_probe``
     at 25⁴: every tier within 0.1 of the plain stack and an injected device
     failure retried on the same tier, bit-equal), ``train_probe`` at batch
     16 of 400² bf16 (the ``base`` and ``fold`` combinations: the FFT
     forward and B3), ``inloc_stage_probe`` at the InLoc shapes (the
     tap-swap chain on B6), the formulation probes at the PF-Pascal shape
     at batch 4 and at the InLoc and sharded shapes (``filter_stage``,
     ``filter_combo``, ``xla_layer``, ``xla_conv``, ``inloc_filter``,
     ``sharded_variant``; B5 where the chooser's auto route reaches it),
     the gradient probes at their root tools' batch 8 of 25² features
     (400² images), bf16 (``vjp``, ``vjp_sweep``, ``nc_grad_split``,
     ``train_attr``), ``cp_fft_probe --tiny`` and its
     ranks 4–32 at 25⁴ with walls; their measured memory rows in a ledger
     of the phase; every timing cut to one differenced pair of 1 and 2
     steps (``PROBE_TIMING_CAP``); then ``make_goldens --check`` (the
     port's record against the committed goldens), ``parity_kit --all`` on
     a reference ``.pth.tar`` written in the phase (the PF-Pascal
     architecture, random weights; the reference twin on the CPU against
     the port's forward on the card, PCK on 3 synthetic pairs) and
     ``check_no_bare_print`` on the package;
  Z. (after phase X) the port's bench as a user runs it: ``python -m
     ncnet_tpu_torch.tools.bench --only forward,quality,stages,filter,
     memory,corr,sparse`` in a process of its own at full width, recording
     into a temporary perf store: exit 0, one JSON line whose envelope
     names this card, every metric finite, every roofline share at most
     100 %, the bf16 quality tier and the stage tier ``fft`` at 25⁴, B8 and
     B6 launched as the sparse section's counted calls give them (2 and 6
     a coarse-to-fine call, 3 B6 a dense 2× filter) and no kernel in the
     other sections; the whole bf16 forward's ``forward_bf16_tflops``,
     ``forward_bf16_mfu_pct`` and ``forward_bf16_mfu_executed_pct`` present
     with ``device_kind`` this card, and both shares at most 100 %; then
     ``perf_regress --seed`` of that line into the store (as many records
     as the run wrote) and ``--check`` exit 0; and in this process the
     executed count (``tools/_work.py``) of the bench's dense 2× filter
     (the folded 50⁴ pair, B6's route): the library ops a separate
     ``FlopCounterMode`` run counts plus ``stack_work`` times the stack
     calls its 3 launches make, and nothing spectral;
  6. a ``kernels`` JSON line, then the last line
     ``{"ok": true, "device": {...}}``.

Without CUDA, or without the package beside it, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import signal
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if not os.path.isdir(os.path.join(HERE, "ncnet_tpu_torch")):
    sys.exit("chip_smoke: run it from a checkout of the repository")
sys.path.insert(0, HERE)

from ncnet_tpu_torch.models.ncnet import calibrate_trunk  # noqa: E402

# the kernels' work and bounds: one copy, in the package
from ncnet_tpu_torch.observability.roofline import (  # noqa: E402
    PEAK_BF16_FLOPS,
    PEAK_F32_FLOPS,
    b5_work,
    bound,
    chain_work,
    dw_work,
    gather_work,
    l2_work,
    stack_work,
)

TOLERANCE = 1e-2          # max|kernel − plain| / max|plain|, bf16 outputs
# The filtered volume of the whole forward, kernel path vs plain path.  The
# two stacks sum in different orders, so a few bf16 outputs round one ulp
# apart (at most 2^-7 of the value: bf16 keeps 7 mantissa bits).  The
# bf16 symmetric sum and the final bf16 mutual matching x·(x/maxA)·(x/maxB)
# cube that relative change and add four roundings: up to ~7 ulps of a
# near-maximal cell.  The kernel itself is held to TOLERANCE on the exact
# volume the path hands it.
SERVE_TOLERANCE = 7 * 2.0 ** -7
# B5 against its twin (max|kernel − twin| / max|twin|): f32 sums in another
# order, 2e-4 as the JAX suite holds the TPU kernel (tests/test_ops_basic.py);
# in bf16 both round an f32 sum once, so at most one bf16 ulp, 2^-7
B5_TOLERANCE = {"float32": 2e-4, "bfloat16": 2.0 ** -7}
# the tensor-core B5 against split_products_reference, its rounding points
# emulated: the same three bf16 products summed in f32 in another order
B5_SPLIT_TOLERANCE = 1e-5
# an fp32 stack or filtered volume, FFT tier or B5 path vs the plain direct
# path: f32 round-off of the transforms (tests/test_torch_port_tiers.py)
FP32_TOLERANCE = 1e-4
# (name, volume (B, hA, wA, hB, wB), k, C_in, C_out, dtype)
B5_SHAPES = (
    # the fp32 800² path's launch: the 16→1 layer on one symmetric pass
    ("pf_pascal_800_fp32", (4, 50, 50, 50, 50), 5, 16, 1, "float32"),
    # the coarse-to-fine tiles' volume, had they run in fp32
    ("c2f_tiles_fp32", (20000, 6, 6, 6, 6), 5, 16, 1, "float32"),
    ("k3_10ch_fp32", (8, 25, 25, 25, 25), 3, 10, 1, "float32"),
    ("two_channel_bf16", (2, 9, 7, 11, 13), 5, 16, 2, "bfloat16"),
)
FP32_SIDES = (400, 800)

# (name, volume shape (B, hA, wA, hB, wB), kernel sizes, channels)
# B2's call on its paths: the coarse-to-fine and tracked fine tiles, 4 pairs
# x 625 coarse cells x 4 candidates, batch-folded with their transposes
# (the dense 25^4 stacks take the FFT tier)
B2_PATH_SHAPE = ("c2f_fine_tiles_20000x6^4", (20000, 6, 6, 6, 6), (5, 5, 5),
                 (16, 16, 1))
# B2's other path shapes, held against the twin and timed per layer beside
# B2_PATH_SHAPE: the tracked
# fine tiles (track_radius=0: one candidate, a quarter of the tiles) and the
# dense bf16 800² request's stack (4 pairs folded with their transposes)
B2_TIMED_SHAPES = (
    ("tracked_fine_tiles_5000x6^4", (5000, 6, 6, 6, 6), (5, 5, 5), (16, 16, 1)),
    ("dense_800_8x50^4", (8, 50, 50, 50, 50), (5, 5, 5), (16, 16, 1)),
)
# B2 at 25⁴, where the tier chooser takes FFT: timed beside the FFT stack
# (context; the route stays FFT)
B2_FFT_CONTEXT_SHAPE = (8, 25, 25, 25, 25)
# the first, CUDA-core designs' times (PR 5, run 4 of chip_smoke.py on an
# NVIDIA H100 80GB HBM3 at 700 W): the B2 stack on B2_PATH_SHAPE and B4 at
# GATHER_SHAPES[0]
FIRST_DESIGN_MS = {"nc_conv4d_bf16": 266.37, "gather_tile_corr_bf16": 3.015}
# the first, CUDA-core dW/db kernel of B3 (chip_smoke.py on an NVIDIA H100
# 80GB HBM3 at 700 W) per layer 0, 1, 2 on a training chunk (8 × 25⁴), and
# the chunk's backward (no dx) with it
FIRST_DESIGN_DW_MS = (13.18, 36.96, 11.28)
FIRST_DESIGN_BACKWARD_MS = 68.73
STACK_SHAPES = (
    # B3's call on the training path: a chunk of 4 pairs, batch-folded with
    # their transposes
    ("pf_pascal_25^4_B8", (8, 25, 25, 25, 25), (5, 5, 5), (16, 16, 1)),
    ("rectangular_3layer", (1, 6, 5, 7, 6), (3, 3, 3), (4, 4, 1)),
    ("two_channel_final", (2, 6, 7, 5, 8), (3, 3), (4, 2)),
    ("k3_single_layer", (1, 7, 7, 7, 7), (3,), (1,)),
)
# the backward (B3) also at a plane wider than 40 cells with the PF-Pascal
# stack, more than one block's shared memory holds at 16 → 16 (B7 tiles
# it in bands)
BACKWARD_SHAPES = STACK_SHAPES + (
    ("pf_pascal_wide_plane_50x50", (1, 4, 5, 50, 50), (5, 5, 5), (16, 16, 1)),
)
SERVE_BATCH, SERVE_REQUESTS, SERVE_SIDE = 4, 3, 400
TRAIN_STEPS = 3
# coarse-to-fine serving (phases B, C): the 800² side bench.py measures the
# coarse-to-fine path at (twice the dense 400²), top-4 candidates
C2F_SIDE, C2F_REQUESTS, C2F_TOPK, TRACK_FRAMES = 800, 3, 4, 3
# B4 against its twin (phase A): both sum in f32 and round once to bf16, so
# an output lands at most one bf16 ulp apart: 2^-7 of the largest output
GATHER_TOLERANCE = 2.0 ** -7
# (name, batch, fine side, channels, factor, halo, candidates)
GATHER_SHAPES = (
    ("pf_pascal_c2f_800", 4, 50, 1024, 2, 2, 4),
    ("halo3_patch8", 2, 16, 64, 2, 3, 3),
    ("odd_channels", 2, 10, 13, 2, 2, 2),
)
# phase T: T1 at the JAX tool's default batch (8 volumes of 25^4); against
# its twin with bf16 Y terms each of the 25 rounded terms may flip one bf16
# ulp where the f32 sums' order differs, then the output rounds once: 1e-2
# normalized, as for the NC kernels; with f32 Y only the output's rounding,
# one bf16 ulp (2^-7 normalized); against relu(unroll conv4d + bias) the
# JAX tool's 5 % relative
L2_BATCH = 8
L2_TOLERANCE = {"bf16": 1e-2, "f32": 2.0 ** -7}
L2_CONV_TOLERANCE = 0.05
# the Y rounding: the bf16-Y and f32-Y twins differ by ~6e-3 normalized,
# inside both tolerances above, so T1 must also keep this share of its
# nonzero interior outputs bit-equal to the twin of its Y dtype, and fewer
# to the other's (on the CPU, f32 sums in another order keep ~0.9999 of
# them, the other Y dtype ~0.58)
L2_BIT_EQUAL_SHARE = 0.99
# each training target is its source rolled by whole feature cells (16 px)
TRAIN_SHIFT = (32, 48)
# phase E: the PF-Pascal eval step at the dataset's eval size, batches of 4
# pairs (seeded images of EVAL_SOURCE_HW resized to EVAL_SIDE), 20 keypoint
# slots (the dataset's −1 padding), PCK at alpha 0.1; a warm-up and 3 batches
EVAL_SIDE, EVAL_BATCHES, EVAL_ALPHA = 400, 3, 0.1
EVAL_SOURCE_HW = (300, 500)
# the device resize on the card against the CPU's, max|Δ| / max|image|: two
# full-f32 contractions round a few ulps apart; a TF32 product keeps 10
# mantissa bits and would be off by about 1e-3
RESIZE_TOLERANCE = 1e-6
# phase R: relocalized dense serving, k = 2 at 1600² (a 100² grid pooled to
# 50²: the NC stack's call is the dense 800² request's 8 × 50⁴); a warm-up
# and 3 requests of SERVE_BATCH pairs
RELOC_SIDE, RELOC_K, RELOC_REQUESTS = 1600, 2, 3
# phase S: one serving process (MatchService) on the coarse-to-fine model of
# phase B: the (C2F_SIDE, C2F_SIDE) bucket, max_batch SERVICE_BATCH, 2
# replicas on the one card (one a card where there are more); SERVICE_REQUESTS
# raw pairs of SERVICE_SIDES px a side from SERVICE_CLIENTS clients in
# groups of SERVICE_BATCH (each group enters the queue at once, so it is
# one batch), each with a SERVICE_DEADLINE_S deadline, then again (store
# hits); a burst of SERVICE_BURST over a queue of SERVICE_MAX_QUEUE; a
# replica failed SERVICE_MAX_FAILURES times and resurrected; a stream of
# SERVICE_FRAMES frames; a drain with SERVICE_DRAIN requests in flight
SERVICE_REQUESTS, SERVICE_CLIENTS, SERVICE_BATCH = 48, 2, 4
SERVICE_SIDES, SERVICE_DEADLINE_S = (640, 800), 2.0
SERVICE_BURST, SERVICE_MAX_QUEUE, SERVICE_MAX_FAILURES = 40, 16, 2
SERVICE_FRAMES, SERVICE_DRAIN = 6, 8
# phase N: the network plane.  Backend A (POD_A_REPLICAS replicas, max_batch
# SERVICE_BATCH) takes the rollouts, backend B (1 replica, max_batch 1) the
# bitwise check; POD_REQUESTS raw pairs from POD_CLIENTS clients through the
# router with a POD_DEADLINE_S budget; POD_HELD requests held on B when it
# is SIGTERMed; the judged canary needs POD_CANARY_MIN results a version
POD_A_REPLICAS, POD_REQUESTS, POD_CLIENTS = 2, 24, 2
POD_DEADLINE_S, POD_HELD, POD_CANARY_MIN = 5.0, 12, 4
POD_SHIFT = 0.4  # the canary quality shift armed for step_000002
# phase L: the eval loop on a fixture of 12 raw pairs at EVAL_SOURCE_HW, each
# target its source moved by EVAL_LOOP_SHIFT px (about one 16-px feature
# cell of the EVAL_SIDE image in each axis); run_eval at batch 4, the CLI at
# batch 1, killed at its EVAL_LOOP_KILL_AT-th journal append once
EVAL_LOOP_PAIRS, EVAL_LOOP_BATCH, EVAL_LOOP_SHIFT = 12, 4, (12, 20)
EVAL_LOOP_WORKERS, EVAL_LOOP_KILL_AT = 4, 5
# phase F: fit at the PF-Pascal recipe on FIT_TRAIN_PAIRS train and
# FIT_VAL_PAIRS val pairs (2 steps an epoch), a checkpoint every step with
# the newest 2 kept, steps FIT_PROFILE_STEPS traced; the CP fine-tune at
# rank FIT_CP_RANK
FIT_TRAIN_PAIRS, FIT_VAL_PAIRS, FIT_BATCH, FIT_EPOCHS = 32, 16, 16, 2
FIT_WORKERS, FIT_PROFILE_STEPS, FIT_CP_RANK = 4, "2:4", 4
# the steady-state fit run: one epoch of FIT_STEADY_PAIRS train pairs (4
# steps), its window a step in mid-epoch (the first step of an epoch waits
# for the loader's second batch)
FIT_STEADY_PAIRS, FIT_STEADY_WINDOW = 64, (3, 4)
# phase I: InLoc at the IVD model's full width (the README's launchers,
# bench.py:1615-1650): images resized to a longest side of INLOC_SIDE,
# relocalization k = INLOC_K; a portrait iPhone query of INLOC_QUERY_HW
# against INLOC_PANOS landscape cutouts of INLOC_PANO_HW, dispatched at depth
# INLOC_DEPTH; the loop and the CLI on INLOC_LOOP_QUERIES queries of
# INLOC_LOOP_PANOS cutouts each
INLOC_SIDE, INLOC_K, INLOC_PANOS, INLOC_DEPTH = 3200, 2, 10, 2
INLOC_QUERY_HW, INLOC_PANO_HW = (4032, 3024), (1200, 1600)
INLOC_LOOP_QUERIES, INLOC_LOOP_PANOS = 2, 3
# phase P: the localization stage at LocalizationConfig's defaults (those of
# compute_densePE_NCNet.m: top 10, score threshold 0.75, 0.2 degrees, 10,000
# samples, pose verification on) on a synthetic textured wall of known
# geometry: a raw portrait query of INLOC_QUERY_HW seen from a known pose,
# LOC_CUTOUTS cutouts of INLOC_PANO_HW (the true one at LOC_TRUE_SLOT of the
# shortlist, not first), LOC_ROWS match rows a cutout (the InLoc table's
# capacity at 3200, match_capacity(3200, 2, True)) of which LOC_GOOD_ROWS on
# the true cutout come from the geometry with LOC_NOISE_PX of noise on the
# query side, and LOC_PAD_ROWS pad rows of score 0; a scan of about
# LOC_SCAN_POINTS points; the recovered pose within LOC_POSE_BOUND (metres,
# degrees) of the truth
LOC_CUTOUTS, LOC_TRUE_SLOT = 10, 1
LOC_ROWS, LOC_GOOD_ROWS, LOC_PAD_ROWS = 15000, 7000, 2000
LOC_NOISE_PX, LOC_SCAN_POINTS = 1.0, 2_500_000
LOC_POSE_BOUND = (0.05, 0.2)
# the scene is a textured room (a box: X, Y (down), Z bounds in metres; the
# cameras stand near its origin and look along +Z at the back wall), so the
# depth varies across every view and the pose has no planar ambiguity; its
# texture a random grid of LOC_TEXTURE_CELL metres; phase I's tree (part 2)
# faces a wall at LOC_TREE_DEPTH
LOC_ROOM = ((-2.0, 2.2), (-2.2, 2.0), (-1.0, 5.0))
LOC_TEXTURE_CELL, LOC_TREE_DEPTH = 0.05, 5.0
# phase Q: the retrieval tier at InLoc's shortlist width.  Two raw queries
# of INLOC_QUERY_HW, each with a DensePE-style row of RETR_ROW cutouts of
# INLOC_PANO_HW (densePE_top100's width; the same panos in both rows, in
# other orders): RETR_OWN crops of the row's query at its last ranks, the
# other query's RETR_OWN crops before them, the rest seeded distractors.
# Coarse volumes pooled by RETR_FACTOR; RETR_OWN cutouts shortlisted and
# matched a query; an index missing RETR_MISSING of the row; a pod of
# RETR_SHARDS shard processes at replication RETR_R answering
# RETR_POD_QUERIES queries; the raw index's recall of a query's own crops
# gated at RETR_MIN_RECALL
RETR_ROW, RETR_OWN, RETR_FACTOR, RETR_MISSING = 100, 10, 4, 20
RETR_SHARDS, RETR_R, RETR_POD_QUERIES, RETR_MIN_RECALL = 3, 2, 40, 0.8
# The training step, kernels vs twins in both directions (phase 5): the
# relative L2 distance of the step's NC gradients.  The kernels' step is the
# twins' arithmetic with the f32 sums in another order, so a bf16 activation
# or gradient here and there rounds one ulp (2^-8 relative) apart; a
# control step, the twins with the sums reordered, shows that spread on the
# spot.  A wrong sign, scale or a missing chunk moves the gradients by
# their own size.
STEP_TOLERANCE = 1e-2


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` warm calls, timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def stack_params(kernels, channels, seed: int, device):
    """Random NC stack (normal, 0.1 scale, the JAX kernel tests' recipe)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    params, c_in = [], 1
    for k, c_out in zip(kernels, channels):
        w = torch.randn((k,) * 4 + (c_in, c_out), generator=g) * 0.1
        b = torch.randn((c_out,), generator=g) * 0.1
        params.append({"w": w.to(device, torch.bfloat16),
                       "b": b.to(device, torch.bfloat16)})
        c_in = c_out
    return params


def normalized_err(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-12))


@contextlib.contextmanager
def routed(module, name, fn, calls=None):
    """Route ``module.name`` through ``fn`` and record each call's ``(args,
    kwargs, output)`` in ``calls`` (the comparison runs of phases B and C;
    the port itself never routes anything but its kernels)."""
    real = getattr(module, name)

    def wrapper(*args, **kw):
        y = fn(*args, **kw)
        if calls is not None:
            calls.append((args, kw, y))
        return y

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, real)


def layer_times(torch, nc_fused_lane, name, shape, kernels, channels,
                params, x, iters):
    """Print each layer's kernel ms and TFLOP/s (at in-volume taps) on
    ``x``; returns the per-layer ms."""
    times, v = [], x
    for li, layer in enumerate(params):
        ms = cuda_ms(lambda: nc_fused_lane.nc_conv4d_layer(
            v, layer["w"], layer["b"]), iters)
        f, _ = stack_work(shape, kernels[li:li + 1], channels[li:li + 1],
                          c_in=int(v.shape[-1]))
        print(f"{name} layer {li} {tuple(layer['w'].shape)}: {ms:.3f} ms, "
              f"{f / ms / 1e9:.2f} TFLOP/s", flush=True)
        times.append(ms)
        v = nc_fused_lane.nc_conv4d_layer(v, layer["w"], layer["b"])
    return times


def check_kernels(torch, nc_fused_lane, dev):
    """Phase 3: kernel vs plain twin at every shape, two launches
    bit-identical; B2's stack and layers timed at its path shapes
    (``B2_PATH_SHAPE``, ``B2_TIMED_SHAPES``) and at 25⁴ beside the FFT
    tier's stack on the same volume (context: the chooser routes 25⁴ to
    FFT).  Returns the numbers of ``B2_PATH_SHAPE``."""
    from ncnet_tpu_torch.ops.conv4d_fft import nc_stack_fft

    timed = [s for _, s, _, _ in B2_TIMED_SHAPES] + [B2_FFT_CONTEXT_SHAPE]
    main = None
    for name, shape, kernels, channels in ((B2_PATH_SHAPE,) + B2_TIMED_SHAPES
                                           + STACK_SHAPES):
        params = stack_params(kernels, channels, seed=1, device=dev)
        g = torch.Generator().manual_seed(2)
        x = (torch.randn(shape + (1,), generator=g) * 0.5).to(dev, torch.bfloat16)
        got = nc_fused_lane.nc_stack_resident(params, x)
        again = nc_fused_lane.nc_stack_resident(params, x)
        want = nc_fused_lane.nc_stack_reference(params, x)
        torch.cuda.synchronize()
        err = normalized_err(got, want)
        max_abs = float((got.float() - want.float()).abs().max())
        same = torch.equal(got, again)
        print(f"check {name}: shape {shape} kernels {kernels} channels "
              f"{channels} max_abs_err {max_abs:.6g} normalized {err:.3e} "
              f"(tolerance {TOLERANCE}); two launches bit-identical: {same}",
              flush=True)
        if not (err <= TOLERANCE and same and torch.isfinite(got.float()).all()):
            raise SystemExit(f"kernel disagrees with its plain twin at {name}")
        flops, nbytes = stack_work(shape, kernels, channels)
        if main is None:
            # in turns: kernel, plain, kernel, plain; the plain twin (~1.8
            # s a call) one call a turn
            iters, plain_iters = 3, 1
            ms_k = [cuda_ms(lambda: nc_fused_lane.nc_stack_resident(params, x), iters)]
            ms_p = [cuda_ms(lambda: nc_fused_lane.nc_stack_reference(params, x), plain_iters)]
            ms_k.append(cuda_ms(lambda: nc_fused_lane.nc_stack_resident(params, x), iters))
            ms_p.append(cuda_ms(lambda: nc_fused_lane.nc_stack_reference(params, x), plain_iters))
            layer_times(torch, nc_fused_lane, name, shape, kernels, channels,
                        params, x, iters)
            bound_ms, bound_by = bound(flops, nbytes)
            main = {
                "max_abs_err": max_abs, "normalized_err": err,
                "ms": sum(ms_k) / 2, "plain_ms": sum(ms_p) / 2,
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
            print(f"timing {name}: kernel {ms_k} ms, plain {ms_p} ms, "
                  f"{flops:.4g} FLOP, {nbytes:.4g} bytes, "
                  f"{flops / main['ms'] / 1e9:.2f} TFLOP/s (first design "
                  f"{FIRST_DESIGN_MS['nc_conv4d_bf16']} ms)", flush=True)
        elif shape in timed:
            ms = cuda_ms(lambda: nc_fused_lane.nc_stack_resident(params, x), 3)
            layers = layer_times(torch, nc_fused_lane, name, shape, kernels,
                                 channels, params, x, 3)
            line = (f"timing {name}: stack {ms:.3f} ms (layers "
                    f"{sum(layers):.3f}), {flops:.4g} FLOP, "
                    f"{flops / ms / 1e9:.2f} TFLOP/s")
            if shape == B2_FFT_CONTEXT_SHAPE:
                fft_ms = cuda_ms(lambda: nc_stack_fft(params, x), 3)
                line += (f"; the FFT tier's stack on the same volume "
                         f"{fft_ms:.3f} ms (context: the chooser routes 25⁴ "
                         "to FFT)")
            print(line, flush=True)
    return main


def grads_err(got, want):
    """(largest normalized error, largest absolute error) over the
    gradient tensors of two ``(d_params, dx)`` results."""
    (dp_a, dx_a), (dp_b, dx_b) = got, want
    pairs = [(a[k], b[k]) for a, b in zip(dp_a, dp_b) for k in ("w", "b")]
    if dx_b is not None:
        pairs.append((dx_a, dx_b))
    return (max(normalized_err(a, b) for a, b in pairs),
            max(float((a.float() - b.float()).abs().max()) for a, b in pairs))


def check_backward(torch, nc_fused_lane, vjp, dev):
    """Phase 3, B3: the backward kernels (B7's dW/db and their reduction,
    B6's transposed conv) against the twin on the same saved activations
    (so the ReLU masks are the same cells), ``dx`` included, at every shape
    of ``BACKWARD_SHAPES``; two kernel runs bit-identical.  Returns the
    training shape's numbers, timed as the training path runs it (no
    ``dx``), with each layer's dW/db time beside the first design's."""
    main = None
    for name, shape, kernels, channels in BACKWARD_SHAPES:
        params = stack_params(kernels, channels, seed=3, device=dev)
        g = torch.Generator().manual_seed(4)
        x = (torch.randn(shape + (1,), generator=g) * 0.5).to(dev, torch.bfloat16)
        acts = nc_fused_lane.stack_activations(params, x)
        cot = (torch.randn(tuple(acts[-1].shape), generator=g) * 0.5
               ).to(dev, torch.bfloat16)
        got = vjp.stack_vjp(params, acts, cot)
        again = vjp.stack_vjp(params, acts, cot)
        want = vjp.stack_vjp(params, acts, cot, twin=True)
        torch.cuda.synchronize()
        err, max_abs = grads_err(got, want)
        same = grads_err(got, again)[1] == 0.0
        finite = all(torch.isfinite(t.float()).all() for d in got[0]
                     for t in d.values()) and torch.isfinite(got[1].float()).all()
        print(f"check backward {name}: shape {shape} kernels {kernels} "
              f"channels {channels} dW, db, dx max_abs_err {max_abs:.6g} "
              f"normalized {err:.3e} (tolerance {TOLERANCE}); two runs "
              f"bit-identical: {same}", flush=True)
        if not (err <= TOLERANCE and same and finite):
            raise SystemExit(f"the backward kernels disagree with the twin at {name}")
        if main is None:
            iters = 3
            run_k = lambda: vjp.stack_vjp(params, acts, cot, need_dx=False)  # noqa: E731
            run_p = lambda: vjp.stack_vjp(params, acts, cot, need_dx=False,  # noqa: E731
                                          twin=True)
            # the twin (~0.8 s a call) one call a turn
            ms_k, ms_p = [cuda_ms(run_k, iters)], [cuda_ms(run_p, 1)]
            ms_k.append(cuda_ms(run_k, iters))
            ms_p.append(cuda_ms(run_p, 1))
            gamma, dw_ms = cot, [0.0] * len(params)
            for li in reversed(range(len(params))):
                w, k = params[li]["w"], int(params[li]["w"].shape[0])
                gz, part = vjp.nc_vjp_dw(acts[li], acts[li + 1], gamma, k)
                dw_ms[li] = cuda_ms(lambda: vjp.nc_vjp_dw(
                    acts[li], acts[li + 1], gamma, k), iters)
                red_ms = cuda_ms(lambda: vjp.nc_vjp_reduce(part), iters)
                f, nb = dw_work(shape, k, int(w.shape[4]), int(w.shape[5]))
                bound_ms, bound_by = bound(f, nb)
                line = (f"backward layer {li} {tuple(w.shape)}: dW/db "
                        f"{dw_ms[li]:.3f} ms ({f:.5g} FLOP, {nb:.4g} bytes, "
                        f"bound {bound_ms:.4f} ms by {bound_by}, "
                        f"{f / dw_ms[li] / 1e9:.2f} TFLOP/s; first design "
                        f"{FIRST_DESIGN_DW_MS[li]} ms), reduce {red_ms:.3f} ms")
                if li > 0:
                    t_ms = cuda_ms(lambda: vjp.nc_conv4d_transpose(gz, w), iters)
                    line += f", transposed conv {t_ms:.3f} ms"
                    gamma = vjp.nc_conv4d_transpose(gz, w)
                print(line, flush=True)
            flops, nbytes = stack_work(shape, kernels, channels, backward=True)
            bound_ms, bound_by = bound(flops, nbytes)
            main = {
                "max_abs_err": max_abs, "normalized_err": err,
                "ms": sum(ms_k) / 2, "plain_ms": sum(ms_p) / 2,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "dw_ms": dw_ms,
            }
            print(f"timing backward {name} (no dx): kernels {ms_k} ms, plain "
                  f"{ms_p} ms, {flops:.4g} FLOP, {nbytes:.4g} bytes, "
                  f"{flops / main['ms'] / 1e9:.2f} TFLOP/s (first design "
                  f"{FIRST_DESIGN_BACKWARD_MS} ms)", flush=True)
    return main


def b5_inputs(torch, shape, k, c_in, c_out, dtype, dev, positive=False):
    """Seeded B5 inputs.  ``positive``: every x and w just above a bf16
    rounding midpoint (``conv4d_pallas.near_bf16_midpoints``), where one
    bf16 product would miss the f32 sum by ~2e-3 of it and the three
    products do not."""
    import numpy as np

    from ncnet_tpu_torch.ops.conv4d_pallas import near_bf16_midpoints

    g = torch.Generator().manual_seed(6)
    if positive:
        rng = np.random.default_rng(6)
        x = torch.from_numpy(near_bf16_midpoints(rng, shape + (c_in,), 0))
        w = torch.from_numpy(near_bf16_midpoints(rng, (k,) * 4 + (c_in, c_out), -4))
    else:
        x = torch.randn(shape + (c_in,), generator=g)
        w = torch.randn((k,) * 4 + (c_in, c_out), generator=g) * 0.05
    return x.to(dev, getattr(torch, dtype)), w.to(dev)


def check_b5(torch, conv4d_pallas, dev):
    """Phase 3, B5: at every shape both kernels, the one the wrapper picks
    (the tensor-core one for k = 3 and 5) and the first design (the CUDA-
    core kernel, which takes every other odd k), against the twin, two
    launches of each bit-identical; then their times, the plain twin's and
    the cuDNN ``coutfold`` formulation's (context), the bound and TFLOP/s.
    At the main shape: an all-positive f32 volume against the twin and
    ``split_products_reference``, and the control of the f32 tolerance (one
    bf16 product a term, emulated, misses it).  Returns the main shape's
    numbers and every shape's times."""
    from ncnet_tpu_torch.ops.conv4d import conv4d

    main, by_shape = None, {}
    for name, shape, k, c_in, c_out, dtype in B5_SHAPES:
        x, w = b5_inputs(torch, shape, k, c_in, c_out, dtype, dev)
        want = conv4d_pallas.conv4d_small_cout_reference(x, w)
        tol = B5_TOLERANCE[dtype]
        errs = {}
        for kernel, launch in (
                ("kernel", lambda: conv4d_pallas.conv4d_small_cout_cuda(x, w)),
                ("first design", lambda: conv4d_pallas._launch(
                    x, w, tensor_core=False))):
            got, again = launch(), launch()
            torch.cuda.synchronize()
            errs[kernel] = (float((got.float() - want.float()).abs().max()),
                            normalized_err(got, want))
            same = torch.equal(got, again)
            print(f"check B5 {name} ({kernel}): x {tuple(x.shape)} {dtype}, k "
                  f"{k}, {c_in} -> {c_out}: max_abs_err {errs[kernel][0]:.6g} "
                  f"normalized {errs[kernel][1]:.3e} (tolerance {tol:.3e}); "
                  f"two launches bit-identical: {same}", flush=True)
            if not (errs[kernel][1] <= tol and same
                    and torch.isfinite(got.float()).all()):
                raise SystemExit(f"B5 ({kernel}) disagrees with its twin at {name}")
            del got, again
        del want
        iters = 5
        run_k = lambda: conv4d_pallas.conv4d_small_cout_cuda(x, w)  # noqa: E731
        run_c = lambda: conv4d_pallas._launch(x, w, tensor_core=False)  # noqa: E731
        run_p = lambda: conv4d_pallas.conv4d_small_cout_reference(x, w)  # noqa: E731
        # in turns: plain, kernel, first design, first design, kernel,
        # plain; the plain twin (cuDNN f32 unroll, ~0.8 s a call at the
        # main shape) one call a turn
        ms_p = [cuda_ms(run_p, 1)]
        ms_k = [cuda_ms(run_k, iters)]
        ms_c = [cuda_ms(run_c, iters), cuda_ms(run_c, iters)]
        ms_k.append(cuda_ms(run_k, iters))
        ms_p.append(cuda_ms(run_p, 1))
        w_x = w.to(x.dtype)
        fold_ms = cuda_ms(lambda: conv4d(x, w_x, variant="coutfold"), iters)
        flops, nbytes, products = b5_work(shape, k, c_in, c_out, dtype)
        bound_ms, bound_by = bound(flops, nbytes, products)
        numbers = {
            "max_abs_err": errs["kernel"][0], "normalized_err": errs["kernel"][1],
            "cuda_core_normalized_err": errs["first design"][1],
            "ms": sum(ms_k) / 2, "plain_ms": sum(ms_p) / 2,
            "cuda_core_ms": sum(ms_c) / 2,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "coutfold_ms": fold_ms,
        }
        # the FLOP at the CUDA cores' f32 peak: context, printed only
        cuda_core_bound_ms = bound(flops, nbytes,
                                   peak_flops=PEAK_F32_FLOPS)[0]
        print(f"timing B5 {name} (one launch): kernel {ms_k} ms, first design "
              f"(CUDA cores) {ms_c} ms, plain (unroll, cuDNN f32) {ms_p} ms, "
              f"context: the coutfold formulation (cuDNN f32) {fold_ms:.4f} "
              f"ms; {flops:.4g} FLOP as {products} bf16 product(s), "
              f"{nbytes:.4g} bytes, bound {numbers['bound_ms']:.4f} ms "
              f"({numbers['bound_by']}; on the CUDA cores "
              f"{cuda_core_bound_ms:.4f}); kernel "
              f"{flops / numbers['ms'] / 1e9:.2f} TFLOP/s, first design "
              f"{flops / numbers['cuda_core_ms'] / 1e9:.2f}", flush=True)
        by_shape[name] = {key: numbers[key] for key in (
            "ms", "cuda_core_ms", "plain_ms", "bound_ms")}
        if main is None:
            main = numbers

            def one_product_err(x, w, twin):
                # the control of the f32 tolerance: one bf16 product a term
                # (x and w rounded to bf16, f32 sums), what a kernel that
                # dropped the lo products computes, must miss it
                one = conv4d(x.to(torch.bfloat16).float(),
                             w.to(torch.bfloat16).float(), variant="unroll")
                err = normalized_err(one, twin)
                print(f"control B5 {name}: one bf16 product a term vs twin "
                      f"normalized {err:.3e} (must miss {tol:.1e})", flush=True)
                if not err > tol:
                    raise SystemExit(f"the f32 tolerance at {name} does not "
                                     "catch one bf16 product a term")
                return err

            err_one = one_product_err(
                x, w, conv4d_pallas.conv4d_small_cout_reference(x, w))
            # the main shape with all-positive inputs: the twin, and the
            # three products' emulation (the same terms, only the f32 sums'
            # order differs)
            x, w = b5_inputs(torch, shape, k, c_in, c_out, dtype, dev,
                             positive=True)
            got = conv4d_pallas.conv4d_small_cout_cuda(x, w)
            twin = conv4d_pallas.conv4d_small_cout_reference(x, w)
            err_twin = normalized_err(got, twin)
            err_split = normalized_err(
                got, conv4d_pallas.split_products_reference(x, w))
            print(f"check B5 {name}, all-positive inputs: kernel vs twin "
                  f"normalized {err_twin:.3e} (tolerance {tol:.3e}), vs the "
                  f"three-product emulation {err_split:.3e} (tolerance "
                  f"{B5_SPLIT_TOLERANCE:.1e})", flush=True)
            if not (err_twin <= tol and err_split <= B5_SPLIT_TOLERANCE):
                raise SystemExit(f"B5 disagrees on all-positive inputs at {name}")
            main.update(positive_normalized_err=err_twin,
                        positive_split_normalized_err=err_split,
                        one_product_normalized_err=err_one,
                        positive_one_product_normalized_err=one_product_err(
                            x, w, twin))
            del got, twin
        del x, w
    return main, by_shape


def plain_stack(params, x):
    """The plain direct NC stack on ``x``: B2's twin in bf16, the f32
    ``unroll`` formulation layer by layer otherwise."""
    import torch

    from ncnet_tpu_torch.ops import nc_fused_lane
    from ncnet_tpu_torch.ops.conv4d import conv4d

    if x.dtype == torch.bfloat16:
        return nc_fused_lane.nc_stack_reference(params, x)
    for layer in params:
        x = torch.relu(conv4d(x, layer["w"], layer["b"], variant="unroll"))
    return x


def check_fft_calls(calls, where):
    """Hold each recorded FFT-tier stack call ``((params, x), kw, y)``
    against the plain direct stack on the same volume."""
    import torch

    for i, ((params, x), _, y) in enumerate(calls):
        tol = TOLERANCE if x.dtype.itemsize == 2 else FP32_TOLERANCE
        with torch.no_grad():
            err = normalized_err(y, plain_stack(params, x))
        print(f"{where}: FFT stack call {i} on the path's volume "
              f"{tuple(x.shape)} {x.dtype}: FFT vs plain direct stack "
              f"normalized error {err:.3e} (tolerance {tol})", flush=True)
        if not err <= tol:
            raise SystemExit(f"{where}: the FFT stack disagrees with the plain "
                             "direct stack")


def check_tables(tables, n_cells, where):
    """Every fetched ``(B, 6, N)`` table finite, scores and quality signals
    in [0, 1]."""
    import numpy as np

    from ncnet_tpu_torch.observability.quality import split_quality_rows

    for table in tables:
        matches, quality = split_quality_rows(table)
        if table.shape != (SERVE_BATCH, 6, n_cells) or not np.isfinite(table).all():
            raise SystemExit(f"{where}: bad table {table.shape}")
        score = matches[:, 4]
        if score.min() < 0 or score.max() > 1:
            raise SystemExit(f"{where}: scores outside [0, 1]")
        for q in quality:
            if not all(0.0 <= v <= 1.0 for v in q.values()):
                raise SystemExit(f"{where}: quality signals outside [0, 1]: {q}")


def serve(torch, nc_fused_lane, dev):
    """Phase 4: the full-width bf16 serving path through BatchMatchEngine."""
    import numpy as np

    from ncnet_tpu_torch.config import ModelConfig
    from ncnet_tpu_torch.models import ncnet as ncnet_mod
    from ncnet_tpu_torch.models.ncnet import init_ncnet, ncnet_forward
    from ncnet_tpu_torch.ops.image import normalize_imagenet
    from ncnet_tpu_torch.serving.engine import BatchMatchEngine

    cfg = ModelConfig(backbone="resnet101", ncons_kernel_sizes=(5, 5, 5),
                      ncons_channels=(16, 16, 1), half_precision=True,
                      backbone_bf16=True)
    engine = BatchMatchEngine(cfg, init_ncnet(cfg, seed=0))
    rng = np.random.default_rng(0)
    shape = (SERVE_BATCH, SERVE_SIDE, SERVE_SIDE, 3)
    requests = [(rng.integers(0, 256, shape, dtype=np.uint8),
                 rng.integers(0, 256, shape, dtype=np.uint8))
                for _ in range(SERVE_REQUESTS + 1)]
    n_cells = (SERVE_SIDE // 16) ** 2

    engine.fetch(engine.dispatch(*requests[-1]))  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nc_fused_lane.launches = 0
    walls, tables = [], []
    for src, tgt in requests[:SERVE_REQUESTS]:
        t0 = time.perf_counter()
        tables.append(engine.fetch(engine.dispatch(src, tgt)))
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = nc_fused_lane.launches
    tier = nc_fused_lane.last_selected_tier()
    peak = torch.cuda.max_memory_allocated()
    print(f"serve: {SERVE_REQUESTS} requests of {SERVE_BATCH} pairs at "
          f"{SERVE_SIDE}x{SERVE_SIDE}, wall ms per request {walls}, peak "
          f"memory {peak} bytes, NC stack tier {tier!r}, B2 launches "
          f"{launches}", flush=True)
    check_tables(tables, n_cells, "serve")
    if launches != 0 or tier != "fft":
        raise SystemExit(f"serve: expected the fft tier and no B2 launch, got "
                         f"{tier!r} and {launches}")
    print(f"serve: tables ok; quality of pair 0: "
          f"{engine.split(tables[-1])[1][0]}", flush=True)

    # one request again, its NC stack through the FFT tier and then through
    # the plain direct stack: the FFT stack on the exact volume the path
    # hands it, and the filtered volume that comes out of each
    src, tgt = (normalize_imagenet(torch.as_tensor(a).to(dev))
                for a in requests[0])
    calls = []
    with torch.no_grad():
        with routed(ncnet_mod, "nc_stack_fft", ncnet_mod.nc_stack_fft, calls):
            got = ncnet_forward(cfg, engine._params, src, tgt).corr
        with routed(ncnet_mod, "nc_stack_fft", plain_stack):
            want = ncnet_forward(cfg, engine._params, src, tgt).corr
    torch.cuda.synchronize()
    check_fft_calls(calls, "serve")
    (_, x), _, _ = calls[0]
    err = normalized_err(got, want)
    print(f"serve: filtered volume {tuple(got.shape)} FFT path vs plain "
          f"path normalized error {err:.3e} (tolerance {SERVE_TOLERANCE})",
          flush=True)
    if not err <= SERVE_TOLERANCE:
        raise SystemExit("the served volume disagrees with the plain path")
    stage_breakdown(torch, nc_fused_lane, cfg, engine._params, src, tgt, x)
    return launches


def stage_breakdown(torch, nc_fused_lane, cfg, params, src, tgt, nc_input):
    """CUDA-event ms of each stage of one request's forward (warm, one
    stage at a time, so the sum is an upper bound on the device time)."""
    from ncnet_tpu_torch.models.ncnet import extract_features, ncnet_filter
    from ncnet_tpu_torch.observability.quality import append_quality_rows
    from ncnet_tpu_torch.ops.conv4d_fft import nc_stack_fft
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import corr_to_matches

    nc_bf16 = [{k: v.to(torch.bfloat16) for k, v in layer.items()}
               for layer in params["nc"]]

    def trunk():
        return (extract_features(cfg, params, src),
                extract_features(cfg, params, tgt))

    def tables(corr):
        m = corr_to_matches(corr, do_softmax=True)
        return append_quality_rows(
            torch.stack([v.to(torch.float32) for v in m], dim=1), corr)

    with torch.no_grad():
        fa, fb = (f.to(torch.bfloat16) for f in trunk())
        corr = correlation_4d(fa, fb)
        filtered = ncnet_filter(cfg, params, corr).corr
        stages = {
            "trunk, both sides": cuda_ms(trunk, 3),
            "correlation": cuda_ms(lambda: correlation_4d(fa, fb), 3),
            "filter (mutual, NC stack, mutual)": cuda_ms(
                lambda: ncnet_filter(cfg, params, corr), 3),
            "of which the NC stack (FFT tier)": cuda_ms(
                lambda: nc_stack_fft(nc_bf16, nc_input), 3),
            "matches and quality row": cuda_ms(lambda: tables(filtered), 3),
        }
    print("serve stages ms per request: " + json.dumps(stages), flush=True)


@contextlib.contextmanager
def routed_fused_stack(stack_fn, calls=None):
    """Route the training path's differentiable NC stack through
    ``stack_fn`` and record each call's ``(params, input, output,
    cotangent)`` in ``calls`` (the comparison runs of phase 5)."""
    from ncnet_tpu_torch.ops import nc_fused_lane

    real = nc_fused_lane.nc_stack_fused

    def routed(params, x):
        y = stack_fn(params, x)
        if calls is not None:
            record = [params, x, y, None]
            calls.append(record)
            y.register_hook(lambda g: record.__setitem__(3, g))
        return y

    nc_fused_lane.nc_stack_fused = routed
    try:
        yield
    finally:
        nc_fused_lane.nc_stack_fused = real


def reordered_layer(perm):
    """The forward twin of one layer on the volume with its four cell dims
    permuted by ``perm`` (the taps to match): the same arithmetic, its f32
    sums in another order (the twin loops over the first dim's taps)."""
    from ncnet_tpu_torch.ops import nc_fused_lane

    to = (0, *(1 + p for p in perm), 5)
    back = tuple(to.index(i) for i in range(6))

    def layer(x, w, b):
        y = nc_fused_lane.layer_reference(
            x.permute(to), w.permute(*perm, 4, 5), b)
        return y.permute(back).contiguous()

    return layer


def twin_stack_fused(params, x, layer=None):
    """The differentiable stack with the twins in both directions: the
    forward twin layer by layer (``layer``, default ``layer_reference``),
    the backward twin on its activations."""
    import torch

    from ncnet_tpu_torch.ops import nc_fused_lane, nc_fused_lane_vjp

    layer = layer or nc_fused_lane.layer_reference

    class TwinStack(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, *flat):
            ps = [{"w": flat[i], "b": flat[i + 1]} for i in range(0, len(flat), 2)]
            acts = [x]
            for p in ps:
                acts.append(layer(acts[-1], p["w"], p["b"]))
            ctx.save_for_backward(*acts, *flat)
            ctx.n = len(ps)
            return acts[-1]

        @staticmethod
        def backward(ctx, g):
            saved = ctx.saved_tensors
            acts, flat = saved[:ctx.n + 1], saved[ctx.n + 1:]
            ps = [{"w": flat[i], "b": flat[i + 1]} for i in range(0, len(flat), 2)]
            d, dx = nc_fused_lane_vjp.stack_vjp(
                ps, acts, g, need_dx=ctx.needs_input_grad[0], twin=True)
            return (dx, *(t for layer in d for t in (layer["w"], layer["b"])))

    return TwinStack.apply(x, *(t for p in params for t in (p["w"], p["b"])))


def pair_scores(mc, params, batch, chunks):
    """The 2B bf16 pair scores of the step's loss (positives, then the
    rolled negatives), through the kernels, ``chunks`` stack calls."""
    import torch

    from ncnet_tpu_torch.models.ncnet import extract_features, ncnet_filter
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.training import match_score_per_pair

    fa, fb = (extract_features(mc, params, batch[k]).to(torch.bfloat16)
              for k in ("source_image", "target_image"))
    fa2 = torch.cat([fa, torch.roll(fa, -1, dims=0)])
    fb2 = torch.cat([fb, fb])
    c = fa2.shape[0] // chunks
    return torch.cat([match_score_per_pair(ncnet_filter(
        mc, params, correlation_4d(fa2[i:i + c], fb2[i:i + c])).corr)
        for i in range(0, fa2.shape[0], c)])


def step_check(loss_k, grads_k, loss_t, grads_t, control, scores):
    """The step's loss and NC gradients, kernels vs twins (see
    STEP_TOLERANCE); ``control`` is the reordered twins' step."""
    import torch

    def flat(grads):
        return torch.cat([t.float().flatten() for layer in grads["nc"]
                          for t in (layer["w"], layer["b"])])

    def rel_l2(grads):
        ref = flat(grads_t)
        return float((flat(grads) - ref).norm() / ref.norm().clamp_min(1e-30))

    g_err, g_ctrl = rel_l2(grads_k), rel_l2(control[1])
    l_err = abs(float(loss_k) - float(loss_t))
    l_ctrl = abs(float(control[0]) - float(loss_t))
    # each pair score is bf16 (one ulp is at most 2^-7 of it) and the loss
    # weights 2B of them by 1/B: one ulp of every score moves it by at most
    # 2 * 2^-7 of the largest score
    s_max = float(scores.float().abs().max())
    l_tol = 2 * 2.0 ** -7 * s_max
    print(f"train: step loss kernels {float(loss_k):.9g} vs twins "
          f"{float(loss_t):.9g}: |diff| {l_err:.3e}, control {l_ctrl:.3e}, "
          f"pair scores: positives mean {float(scores[:len(scores) // 2].float().mean()):.6g}, "
          f"negatives mean {float(scores[len(scores) // 2:].float().mean()):.6g}, "
          f"largest {s_max:.6g}, tolerance {l_tol:.3e}; NC gradients "
          f"relative L2 error {g_err:.3e}, control {g_ctrl:.3e}, tolerance "
          f"{STEP_TOLERANCE}", flush=True)
    if not (l_err <= l_tol and g_err <= STEP_TOLERANCE):
        raise SystemExit("the training step disagrees with the twins' step")


def feature_contrast(mc, params, batch):
    """(mean, mean of the row maxima) of the cosine between a source cell's
    trunk feature and every target cell's of its pair."""
    import torch

    from ncnet_tpu_torch.models.ncnet import extract_features

    with torch.no_grad():
        fa, fb = (torch.nn.functional.normalize(extract_features(
            mc, params, batch[k]).flatten(1, 2).float(), dim=-1)
            for k in ("source_image", "target_image"))
        cos = torch.bmm(fa, fb.transpose(1, 2))
    return float(cos.mean()), float(cos.amax(dim=2).mean())


def train(torch, nc_fused_lane, vjp, dev, model=None, **train_kw):
    """Phase 5: the full-width bf16 training step (``model`` and
    ``train_kw`` override the recipe, for a rehearsal at a small size).
    Returns the launches, the weights the steps started from (calibrated
    trunk, peaked NC kernels) and the timed steps' walls."""
    import numpy as np

    from ncnet_tpu_torch.config import ModelConfig, TrainConfig
    from ncnet_tpu_torch.models.ncnet import tree_map
    from ncnet_tpu_torch.ops.conv4d_fft import fft_stack_activations
    from ncnet_tpu_torch.ops.image import normalize_imagenet
    from ncnet_tpu_torch.training import (
        auto_accum_chunks,
        create_train_state,
        make_train_step,
        weak_loss_and_grads,
    )

    cfg = TrainConfig(model=model or ModelConfig(
        backbone="resnet101", ncons_kernel_sizes=(5, 5, 5),
        ncons_channels=(16, 16, 1), half_precision=True), **train_kw)
    state, optimizer, mc, _ = create_train_state(cfg, seed=0)
    rng = np.random.default_rng(1)
    shape = (cfg.batch_size, cfg.image_size, cfg.image_size, 3)

    def pair():
        src = rng.integers(0, 256, shape, dtype=np.uint8)
        return {"source_image": src,
                "target_image": np.roll(src, TRAIN_SHIFT, axis=(1, 2))}

    batches = [{k: normalize_imagenet(torch.as_tensor(v).to(dev))
                for k, v in pair().items()} for _ in range(TRAIN_STEPS + 2)]
    contrast = [feature_contrast(mc, state.params, batches[0])]
    calibrate_trunk(mc, state.params, batches.pop()["source_image"])
    contrast.append(feature_contrast(mc, state.params, batches[0]))
    print("train: trunk features, cosine of a source cell with the target "
          "cells of its pair (mean, mean best): raw BatchNorm init "
          f"{contrast[0]}, calibrated {contrast[1]}", flush=True)
    # NC kernels centre-peaked (the CPU tests' peaked_params), so that the
    # filtered volume keeps the match peaks, and biases off zero: a
    # random-init stack on a mutual-matched volume otherwise sits at the
    # ReLU boundary
    for layer in state.params["nc"]:
        d = layer["w"].shape[0] // 2
        layer["w"][d, d, d, d] += 1.0 / layer["w"].shape[4]
        layer["b"] = layer["b"] + 0.05
    # phase F trains from these weights
    start = tree_map(torch.clone, state.params)
    step = make_train_step(mc, optimizer, stop_backbone_grad=True,
                           accum_chunks=cfg.accum_chunks,
                           nan_guard=cfg.nan_guard)
    chunks = auto_accum_chunks(cfg.batch_size)
    n_layers = len(mc.ncons_channels)

    state, loss = step(state, batches[-1])  # warm-up, not counted
    torch.cuda.synchronize()
    print(f"train: warm-up step loss {float(loss):.9g}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    nc_fused_lane.launches = 0
    for key in vjp.launches:
        vjp.launches[key] = 0
    walls = []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, batches[i])
        loss = float(loss)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        walls.append(round(wall, 2))
        peak = torch.cuda.max_memory_allocated()
        print(f"train step {i + 1}: loss {loss:.9g}, wall {wall:.1f} ms, "
              f"peak memory {peak} bytes", flush=True)
        if not np.isfinite(loss):
            raise SystemExit(f"train step {i + 1}: non-finite loss")
    launches = {"nc_conv4d_bf16": nc_fused_lane.launches, **vjp.launches}
    tier = nc_fused_lane.last_selected_tier()
    # per step: each chunk runs the folded stack once forward (the FFT
    # tier at 25⁴: no B2 launch) and once backward (dW/db and its
    # reduction per layer, the transposed conv for every layer but the
    # first: the volume needs no gradient)
    want = {"nc_conv4d_bf16": 0,
            "nc_vjp_dw": TRAIN_STEPS * chunks * n_layers,
            "nc_vjp_reduce": TRAIN_STEPS * chunks * n_layers,
            "nc_conv4d_transpose": TRAIN_STEPS * chunks * (n_layers - 1)}
    print(f"train: launches in {TRAIN_STEPS} steps {launches}, expected "
          f"{want} ({chunks} chunks of {2 * cfg.batch_size // chunks} "
          f"volumes a step); the forward's tier {tier!r}", flush=True)
    if launches != want or tier != "fft":
        raise SystemExit("the training path did not launch the kernels as expected")

    # the step's loss and NC gradients, kernels vs twins in both directions
    # (and a reordered twin as the control of the spread), and the kernels
    # vs the twin on the last chunk's exact volume and cotangent
    batch = batches[0]
    calls = []
    with routed_fused_stack(nc_fused_lane.nc_stack_fused, calls):
        loss_k, grads_k = weak_loss_and_grads(mc, state.params, batch)
    with routed_fused_stack(twin_stack_fused):
        loss_t, grads_t = weak_loss_and_grads(mc, state.params, batch)
    layer = reordered_layer((2, 3, 0, 1))
    with routed_fused_stack(lambda p, v: twin_stack_fused(p, v, layer)):
        control = weak_loss_and_grads(mc, state.params, batch)
    with torch.no_grad():
        scores = pair_scores(mc, state.params, batch, chunks)
    torch.cuda.synchronize()
    step_check(loss_k, grads_k, loss_t, grads_t, control, scores)
    params, x, y, g = calls[-1]
    params = [{k: v.detach() for k, v in p.items()} for p in params]
    check_fft_calls([((params, x), {}, y.detach())], "train")
    acts = fft_stack_activations(params, x.to(torch.bfloat16))
    err, max_abs = grads_err(vjp.stack_vjp(params, acts, g, need_dx=False),
                             vjp.stack_vjp(params, acts, g, need_dx=False,
                                           twin=True))
    print(f"train: B3 on the last chunk's volume {tuple(x.shape)}: kernels vs "
          f"twin max_abs_err {max_abs:.6g} normalized {err:.3e} (tolerance "
          f"{TOLERANCE})", flush=True)
    if not err <= TOLERANCE:
        raise SystemExit("the backward kernels disagree with the twin on the "
                         "training volume")
    train_stages(torch, nc_fused_lane, vjp, mc, state, optimizer, batch,
                 params, x, g, chunks)
    return launches, start, walls


def train_stages(torch, nc_fused_lane, vjp, mc, state, optimizer, batch,
                 params, x, g, chunks):
    """CUDA-event ms of a step's stages, each run alone and warm: the trunk
    (both sides), the NC stack forward and backward (one chunk's, times
    the chunks), the rest of a chunk's forward and backward (correlation,
    mutual matching, scores; times the chunks), and Adam with the NaN
    guard's check."""
    from ncnet_tpu_torch.models.ncnet import extract_features, ncnet_filter
    from ncnet_tpu_torch.ops.conv4d_fft import fft_stack_activations
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.training import match_score_per_pair
    from ncnet_tpu_torch.training.train import (
        apply_updates,
        tree_leaves,
        tree_map,
    )

    with torch.no_grad():
        fa = extract_features(mc, state.params, batch["source_image"]).to(torch.bfloat16)
        fb = extract_features(mc, state.params, batch["target_image"]).to(torch.bfloat16)
    c = x.shape[0] // 2  # pairs per chunk (the stack folds their transposes)
    acts = fft_stack_activations(params, x.to(torch.bfloat16))

    def chunk():
        leaves = [{k: v.detach().requires_grad_() for k, v in layer.items()}
                  for layer in state.params["nc"]]
        with torch.enable_grad():
            # the step's route: the training gate, as weak_loss sets it
            vol = ncnet_filter(mc, {**state.params, "nc": leaves},
                               correlation_4d(fa[:c], fb[:c]),
                               nc_pallas_vjp=True).corr
            val = match_score_per_pair(vol).sum()
        return torch.autograd.grad(val, [t for p in leaves for t in p.values()])

    def trunk():
        with torch.no_grad():
            return (extract_features(mc, state.params, batch["source_image"]),
                    extract_features(mc, state.params, batch["target_image"]))

    grads = {"backbone": tree_map(torch.zeros_like, state.params["backbone"]),
             "nc": tree_map(torch.ones_like, state.params["nc"])}

    def adam():
        updates, _ = optimizer.update(grads, state.opt_state, state.params)
        new = apply_updates(state.params, updates)
        ok = torch.ones((), dtype=torch.bool, device=x.device)
        for u in tree_leaves(updates):
            ok = ok & torch.isfinite(u).all()
        return new, ok

    nc_fwd = cuda_ms(lambda: fft_stack_activations(params, x.to(torch.bfloat16)), 3)
    nc_bwd = cuda_ms(lambda: vjp.stack_vjp(params, acts, g, need_dx=False), 3)
    chunk_ms = cuda_ms(chunk, 3)
    stages = {
        f"trunk, both sides, batch {batch['source_image'].shape[0]}":
            cuda_ms(trunk, 3),
        f"NC stack forward (FFT tier), {chunks} chunks": nc_fwd * chunks,
        f"NC stack backward (B3: B7 dW/db, B6 transposed), {chunks} chunks":
            nc_bwd * chunks,
        f"correlation, mutual matching, loss; forward and backward, {chunks} "
        "chunks": (chunk_ms - nc_fwd - nc_bwd) * chunks,
        "Adam and the NaN guard's check": cuda_ms(adam, 3),
    }
    print("train stages ms per step: " + json.dumps(stages), flush=True)


@contextlib.contextmanager
def plain_path():
    """The forward with the plain versions in place of the NC and B4
    kernels and of the FFT tier (the plain direct stack)."""
    from ncnet_tpu_torch.models import ncnet as ncnet_mod
    from ncnet_tpu_torch.ops import nc_fused_lane, sparse_corr

    with routed(nc_fused_lane, "nc_stack_resident",
                nc_fused_lane.nc_stack_reference), \
            routed(ncnet_mod, "nc_stack_fft", plain_stack), \
            routed(sparse_corr, "gather_tile_corr_pallas",
                   sparse_corr.gather_tile_corr_reference):
        yield


def gather_call(torch, sparse_corr, b, side, c, factor, halo, k, dev, seed):
    """Phase A's kernel call at one shape, captured from ``sparse_fine_corr``
    on unit-norm bf16 features and random candidates: ``(args, kwargs,
    twin output, tiles)``, the arguments as the serving path builds them."""
    g = torch.Generator().manual_seed(seed)
    fa, fb = (torch.nn.functional.normalize(
        torch.randn((b, side, side, c), generator=g), dim=-1).to(
            dev, torch.bfloat16) for _ in range(2))
    n_coarse = (side // factor) ** 2
    cand = torch.randint(0, n_coarse, (b, n_coarse, k), generator=g,
                         dtype=torch.int32).to(dev)
    calls = []
    with routed(sparse_corr, "gather_tile_corr_pallas",
                sparse_corr.gather_tile_corr_reference, calls):
        tiles = sparse_corr.sparse_fine_corr(fa, fb, cand, factor=factor,
                                             halo=halo)
    (args, kw, want), = calls
    return args, kw, want, tiles


def check_gather(torch, sparse_corr, dev):
    """Phase A: B4 against its twin at every shape, two launches
    bit-identical; the serving shape's times."""
    main = None
    for name, b, side, c, factor, halo, k in GATHER_SHAPES:
        args, kw, want, tiles = gather_call(torch, sparse_corr, b, side, c,
                                            factor, halo, k, dev, seed=5)
        got = sparse_corr.gather_tile_corr_pallas(*args, **kw)
        again = sparse_corr.gather_tile_corr_pallas(*args, **kw)
        torch.cuda.synchronize()
        err = normalized_err(got, want)
        max_abs = float((got.float() - want.float()).abs().max())
        same = torch.equal(got, again)
        print(f"check B4 {name}: tiles {tuple(got.shape)} from C={c}, patch "
              f"{kw['patch']}, halo {halo}: max_abs_err {max_abs:.6g} "
              f"normalized {err:.3e} (tolerance {GATHER_TOLERANCE:.3e}); two "
              f"launches bit-identical: {same}", flush=True)
        if not (err <= GATHER_TOLERANCE and same
                and torch.isfinite(got.float()).all()):
            raise SystemExit(f"the gather kernel disagrees with its twin at {name}")
        if main is None:
            iters = 10
            run_k = lambda: sparse_corr.gather_tile_corr_pallas(*args, **kw)  # noqa: E731
            run_p = lambda: sparse_corr.gather_tile_corr_reference(*args, **kw)  # noqa: E731
            ms_k, ms_p = [cuda_ms(run_k, iters)], [cuda_ms(run_p, iters)]
            ms_k.append(cuda_ms(run_k, iters))
            ms_p.append(cuda_ms(run_p, iters))
            # the library yardstick: one cuBLAS batched product (einsum) on
            # patches gathered beforehand, the gather not timed
            fa_p2, fb, rows, _ = args
            fb_p2 = sparse_corr.gather_target_patches(
                fb, tiles.ib, tiles.jb).reshape(got.shape[:4] + (c,))
            lib_ms = cuda_ms(lambda: torch.einsum("bnic,bnkjc->bnkij",
                                                  fa_p2, fb_p2), iters)
            flops, nbytes = gather_work(fa_p2, fb, rows, k)
            bound_ms, bound_by = bound(flops, nbytes)
            main = {
                "max_abs_err": max_abs, "normalized_err": err,
                "ms": sum(ms_k) / 2, "plain_ms": sum(ms_p) / 2,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms,
            }
            print(f"timing B4 {name} (one launch): kernel {ms_k} ms, plain "
                  f"{ms_p} ms, library (einsum on pre-gathered patches, "
                  f"cuBLAS) {lib_ms:.4f} ms, {flops:.4g} FLOP, {nbytes:.4g} "
                  f"bytes, bound {main['bound_ms']:.4f} ms "
                  f"({main['bound_by']}), {flops / main['ms'] / 1e9:.2f} "
                  f"TFLOP/s (first design "
                  f"{FIRST_DESIGN_MS['gather_tile_corr_bf16']} ms)", flush=True)
    return main


def probe_tools(torch, dev):
    """Phase T: the two tool entry points with their counts reset just
    before and read just after, then T1 at B = 8 against its twin and the
    unroll conv, and each probe once more against its twin; returns the
    ``kernels`` line's T1 and T2 numbers."""
    from ncnet_tpu_torch.ops.conv4d import conv4d
    from ncnet_tpu_torch.tools import mosaic_probes
    from ncnet_tpu_torch.tools import pallas_l2_probe as l2

    mosaic_probes.launches = 0
    t0 = time.perf_counter()
    results = mosaic_probes.run()
    probe_launches = mosaic_probes.launches
    mosaic_probes.report(results)
    print("probes " + json.dumps(results), flush=True)
    print(f"phase T: probe battery (built and run) in "
          f"{time.perf_counter() - t0:.1f} s, {probe_launches} launches",
          flush=True)
    failed = sorted(n for n, v in results.items() if v != "PASS")
    if failed:
        raise SystemExit(f"probes failed: {failed}")

    l2.launches = 0
    tool = {ydt: l2.main([str(L2_BATCH), ydt], device=dev)
            for ydt in ("bf16", "f32")}
    l2_launches = l2.launches
    print(f"phase T: pallas_l2_probe at B = {L2_BATCH}, {l2_launches} kernel "
          f"launches", flush=True)

    g = torch.Generator().manual_seed(8)
    x = (torch.randn((L2_BATCH,) + (l2.S,) * 4 + (l2.C,), generator=g) * 0.1
         ).to(dev, torch.bfloat16)
    w = (torch.randn((l2.K,) * 4 + (l2.C, l2.C), generator=g) * 0.05
         ).to(dev, torch.bfloat16)
    bias = (torch.randn((l2.C,), generator=g) * 0.1).to(dev, torch.bfloat16)
    args = (l2.to_fused_layout(x), l2.pack_weight(w), bias.reshape(1, l2.C, 1),
            l2.make_mask(dev))
    conv = torch.relu(conv4d(x, w, bias, variant="unroll"))
    twins = {name: l2.conv_l2_reference(*args, ydt=ydt)
             for name, ydt in l2.YDTS.items()}
    t1 = {}
    for ydt_name, ydt in l2.YDTS.items():
        got = l2.conv_l2_cuda(*args, ydt=ydt)
        again = l2.conv_l2_cuda(*args, ydt=ydt)
        want = twins[ydt_name]
        torch.cuda.synchronize()
        err = normalized_err(got, want)
        max_abs = float((got.float() - want.float()).abs().max())
        conv_err = normalized_err(l2.from_fused_layout(got), conv)
        same = torch.equal(got, again)
        halo_zero = not (got[..., :l2.LO].any() or got[..., l2.LO + l2.NT:].any())
        # the Y rounding: the two Y dtypes' twins lie within both
        # tolerances of each other, so hold the kernel to the share of its
        # nonzero interior outputs that are bit-equal to each twin
        share = l2.bit_equal_share(got, want)
        control = l2.bit_equal_share(
            got, twins["f32" if ydt_name == "bf16" else "bf16"])
        tol = L2_TOLERANCE[ydt_name]
        print(f"check T1 {ydt_name} Y: xp {tuple(args[0].shape)}: max_abs_err "
              f"{max_abs:.6g} normalized {err:.3e} (tolerance {tol:.3e}); vs "
              f"relu(unroll conv4d + bias) rel {conv_err:.3e} (tolerance "
              f"{L2_CONV_TOLERANCE}); two launches bit-identical: {same}; "
              f"halo lanes zero: {halo_zero}; bit-equal to the {ydt_name}-Y "
              f"twin {share:.6f} (at least {L2_BIT_EQUAL_SHARE}), to the "
              f"other Y dtype's {control:.6f} (control, below it)", flush=True)
        if not (err <= tol and conv_err < L2_CONV_TOLERANCE and same
                and halo_zero and torch.isfinite(got.float()).all()
                and share >= L2_BIT_EQUAL_SHARE and control < share):
            raise SystemExit(f"T1 disagrees with its twin or the conv ({ydt_name} Y)")
        iters = 3
        run_k = lambda: l2.conv_l2_cuda(*args, ydt=ydt)  # noqa: E731
        run_p = lambda: l2.conv_l2_reference(*args, ydt=ydt)  # noqa: E731
        ms_k, ms_p = [cuda_ms(run_k, iters)], [cuda_ms(run_p, 1)]
        ms_k.append(cuda_ms(run_k, iters))
        ms_p.append(cuda_ms(run_p, 1))
        t1[ydt_name] = {"max_abs_err": max_abs, "normalized_err": err,
                        "conv_rel_err": conv_err, "bit_equal_share": share,
                        "control_bit_equal_share": control, "ms": sum(ms_k) / 2,
                        "plain_ms": sum(ms_p) / 2, "kernel_ms_runs": ms_k,
                        "plain_ms_runs": ms_p}
    coutfold_ms = cuda_ms(
        lambda: torch.relu(conv4d(x, w, bias, variant="coutfold")), 3)
    flops, nbytes, gemm = l2_work(L2_BATCH)
    bound_ms, bound_by = bound(flops, nbytes)
    main = dict(t1["bf16"])
    main.update({
        "bound_ms": bound_ms, "bound_by": bound_by,
        "flops": flops, "bytes": nbytes, "gemm_flops": gemm,
        "gemm_bound_ms": gemm / PEAK_BF16_FLOPS * 1e3,
        "coutfold_ms": coutfold_ms, "f32_y": t1["f32"],
        "tool_ms_per_volume": {k: {m: v[m] for m in ("layout_ms", "kernel_ms",
                                                     "coutfold_ms")}
                               for k, v in tool.items()},
        "launches": l2_launches,
    })
    print(f"timing T1 (one launch, B = {L2_BATCH}): kernel bf16 Y "
          f"{t1['bf16']['kernel_ms_runs']} ms, f32 Y {t1['f32']['kernel_ms_runs']} "
          f"ms; plain {t1['bf16']['plain_ms_runs']} ms; context: coutfold + relu "
          f"(cuDNN bf16) {coutfold_ms:.4f} ms; {flops:.4g} FLOP at taps "
          f"inside the volume, {nbytes:.4g} bytes, bound {main['bound_ms']:.4f} "
          f"ms ({main['bound_by']}); GEMM formulation {gemm:.4g} FLOP "
          f"({main['gemm_bound_ms']:.4f} ms at peak); "
          f"{flops / main['ms'] / 1e9:.2f} TFLOP/s", flush=True)

    # T2: each probe once more against its twin, timed (host clock: the C
    # entry synchronises); these launches are not the path's
    ms_k = ms_p = max_abs = 0.0
    for name, probe in mosaic_probes.PROBES.items():
        if probe is None:
            continue
        xs = probe.inputs(torch.Generator().manual_seed(mosaic_probes.SEED))
        t0 = time.perf_counter()
        want = probe.twin(*xs)
        ms_p += (time.perf_counter() - t0) * 1e3
        ins = [x.to(dev).contiguous() for x in xs]
        out = torch.zeros(want.shape, dtype=want.dtype, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = mosaic_probes._launch(name, ins, out)
        ms_k += (time.perf_counter() - t0) * 1e3
        verdict = mosaic_probes._compare(out.cpu(), want, probe.exact)
        if rc != 0 or verdict != "PASS":
            raise SystemExit(f"probe {name} on its second launch: rc {rc}, {verdict}")
        max_abs = max(max_abs, float((out.cpu().double() - want.double()).abs().max()))
    spills = mosaic_probes.port_kernel_spills()
    print(f"phase T: every probe again vs its twin: max_abs_err {max_abs}; "
          f"launches {ms_k:.3f} ms in all (host clock, each synchronised), "
          f"twins {ms_p:.3f} ms (CPU); port sources' spills {spills}",
          flush=True)
    probes = {"max_abs_err": max_abs, "ms": ms_k, "plain_ms": ms_p,
              "launches": probe_launches, "results": results,
              "port_kernel_spills": spills}
    return main, probes


# Phase W: the NC kernels over the JAX kernels' whole shape class (any odd
# k <= 7, widths up to 32).  The layer shapes of the classes this brought
# in, each a forward, its transposed launch and B7's dW/db on a small
# volume against the twins: (C_in, C_out) at every kernel size
W_WIDTHS = ((1, 8), (8, 8), (8, 1), (1, 32), (32, 32), (32, 1), (32, 4),
            (3, 17), (24, 9))
W_VOLUME = (2, 5, 6, 7, 6)
# planes wider than one block's cells: row and column bands (B6, B7)
W_PLANES = (((1, 3, 4, 50, 50), 7, 32, 32), ((1, 3, 4, 50, 50), 5, 32, 4),
            ((1, 3, 3, 40, 40), 7, 1, 32))
# the paths: (a) coarse-to-fine serving with 32-channel layers, (b) the
# training step with 8-channel layers at k = 5, (c) one rectangular
# training step of the IVD stack, which takes its tap-swap chain
W_SERVE_NC = ((3, 3, 3), (32, 32, 1))
W_TRAIN_NC = ((5, 5, 5), (8, 8, 1))
W_RECT_NC = ((3, 3), (16, 1))
W_RECT_HW = ((400, 304), (304, 400))   # source, target (H, W)


def rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def check_layer_class(torch, nc_fused_lane, vjp, shape, k, c_in, c_out, gen,
                      dev):
    """One layer shape on ``shape``: B6's forward and transposed launches
    (normalized error) and B7's dW and db (relative L2) against the twins,
    each run twice bit-identical.  Returns (forward err, dx err, dW/db
    err, bit-identical)."""
    x = (torch.randn(shape + (c_in,), generator=gen) * 0.5).to(dev, torch.bfloat16)
    w = (torch.randn((k,) * 4 + (c_in, c_out), generator=gen) * 0.1
         ).to(dev, torch.bfloat16)
    b = (torch.randn((c_out,), generator=gen) * 0.1).to(dev, torch.bfloat16)
    y = nc_fused_lane.nc_conv4d_layer(x, w, b)
    y2 = nc_fused_lane.nc_conv4d_layer(x, w, b)
    g = (torch.randn(tuple(y.shape), generator=gen) * 0.5).to(dev, torch.bfloat16)
    got, again = (vjp.layer_vjp(x, y, g, w) for _ in range(2))
    twin = vjp.layer_vjp_reference(x, y, g, w)
    torch.cuda.synchronize()
    f_err = normalized_err(y, nc_fused_lane.layer_reference(x, w, b))
    dx_err = normalized_err(got[2], twin[2])
    d_err = max(rel_l2(got[0], twin[0]), rel_l2(got[1], twin[1]))
    same = torch.equal(y, y2) and all(torch.equal(a, c)
                                      for a, c in zip(got, again))
    return f_err, dx_err, d_err, same


def shape_class_checks(torch, nc_fused_lane, vjp, dev):
    """The gate against the libraries' own limits, then every class layer
    of ``W_WIDTHS`` (at each kernel size) and ``W_PLANES``."""
    mismatches = 0
    for k in nc_fused_lane.KERNEL_SIZES:
        fwd, bwd = nc_fused_lane._library(k), vjp._library(k)
        for c_in in range(0, nc_fused_lane.MAX_WIDTH + 2):
            for c_out in range(0, nc_fused_lane.MAX_WIDTH + 2):
                held = c_in > 0 and c_out > 0 and nc_fused_lane.layer_held(
                    k, c_in, c_out)
                mismatches += held != bool(
                    fwd.nc_conv4d_supported(k, c_in, c_out)
                    and bwd.nc_vjp_supported(k, c_in, c_out))
        mismatches += bool(fwd.nc_conv4d_supported(k + 2, 1, 1))
    print(f"W: the gate (nc_fused_lane.layer_held) against the libraries' "
          f"nc_conv4d_supported and nc_vjp_supported at k = "
          f"{nc_fused_lane.KERNEL_SIZES}, widths 0..{nc_fused_lane.MAX_WIDTH + 1}: "
          f"{mismatches} mismatches", flush=True)
    if mismatches:
        raise SystemExit("W: the route's gate and the kernels' limits differ")
    gen = torch.Generator().manual_seed(23)
    cases = [(W_VOLUME, k, c_in, c_out) for k in nc_fused_lane.KERNEL_SIZES
             for c_in, c_out in W_WIDTHS] + list(W_PLANES)
    worst = [0.0, 0.0, 0.0]
    for shape, k, c_in, c_out in cases:
        errs = check_layer_class(torch, nc_fused_lane, vjp, shape, k, c_in,
                                 c_out, gen, dev)
        ok = (errs[0] <= TOLERANCE and errs[1] <= TOLERANCE
              and errs[2] <= STEP_TOLERANCE and errs[3])
        worst = [max(a, e) for a, e in zip(worst, errs[:3])]
        if not ok or shape != W_VOLUME:
            print(f"W: class k={k} {c_in}->{c_out} on {shape}: forward "
                  f"{errs[0]:.3e}, transposed {errs[1]:.3e} (normalized, "
                  f"tolerance {TOLERANCE}), dW/db relative L2 {errs[2]:.3e} "
                  f"(tolerance {STEP_TOLERANCE}); two launches bit-identical: "
                  f"{errs[3]}", flush=True)
        if not ok:
            raise SystemExit(f"W: the kernels disagree with the twins at k={k} "
                             f"{c_in}->{c_out}")
    print(f"W: {len(cases)} class layers (forward, transposed, dW/db) within "
          f"tolerance, two launches bit-identical; largest errors forward "
          f"{worst[0]:.3e}, transposed {worst[1]:.3e}, dW/db relative L2 "
          f"{worst[2]:.3e}", flush=True)
    return {"layers_checked": len(cases), "forward_normalized_err": worst[0],
            "transposed_normalized_err": worst[1], "dw_db_rel_l2": worst[2]}


def w_serve(torch, nc_fused_lane, sparse_corr, dev):
    """Path (a): coarse-to-fine serving at 800², B = 4, ``sparse_topk`` 4,
    NC ``W_SERVE_NC``: the coarse 25⁴ pass and the fine 6⁴ tiles both on
    B6 (the FFT gate refuses both), 3 B6 launches a stack call."""
    from ncnet_tpu_torch.config import ModelConfig
    from ncnet_tpu_torch.serving.engine import BatchMatchEngine

    kernels, channels = W_SERVE_NC
    cfg = ModelConfig(backbone="resnet101", ncons_kernel_sizes=kernels,
                      ncons_channels=channels, half_precision=True,
                      backbone_bf16=True, sparse_topk=C2F_TOPK, sparse_factor=2)
    params = serving_params(torch, cfg, dev, C2F_SIDE)
    requests = c2f_requests(seed=2, shift=TRAIN_SHIFT)
    engine = BatchMatchEngine(cfg, params)
    engine.fetch(engine.dispatch(*requests[-1]))  # warm-up, not counted
    torch.cuda.synchronize()
    decisions = []
    walls, tables = [], []
    nc_fused_lane.launches = 0
    sparse_corr.launches = 0
    with routed(nc_fused_lane, "choose_fused_stack",
                nc_fused_lane.choose_fused_stack, decisions):
        for src, tgt in requests[:C2F_REQUESTS]:
            t0 = time.perf_counter()
            tables.append(engine.fetch(engine.dispatch(src, tgt)))
            walls.append(round((time.perf_counter() - t0) * 1e3, 2))
    launches = {"nc_conv4d_bf16": nc_fused_lane.launches,
                "gather_tile_corr_bf16": sparse_corr.launches}
    tiers = sorted({(a[:4], y) for a, _, y in decisions})
    check_tables(tables, (C2F_SIDE // 16) ** 2, "W serve")
    # a request: the coarse pass one stack call on [x, xᵀ] (3 launches),
    # the fine tiles two (6), B4 twice
    want = {"nc_conv4d_bf16": 9 * C2F_REQUESTS,
            "gather_tile_corr_bf16": 2 * C2F_REQUESTS}
    print(f"W serve (a): {C2F_REQUESTS} coarse-to-fine requests of "
          f"{SERVE_BATCH} pairs at {C2F_SIDE}x{C2F_SIDE}, NC {kernels}/"
          f"{channels}: walls {walls} ms, launches {launches} (expected "
          f"{want}), tier decisions {tiers}", flush=True)
    shapes = {s for s, _ in tiers}
    if (launches != want or {t for _, t in tiers} != {"resident"}
            or not {(25, 25, 25, 25), (6, 6, 6, 6)} <= shapes):
        raise SystemExit("W serve: the path did not run the kernels as expected")
    calls = []
    with routed(nc_fused_lane, "nc_stack_resident",
                nc_fused_lane.nc_stack_resident, calls):
        engine.fetch(engine.dispatch(*requests[0]))
    numbers = {"request_wall_ms": walls}
    for (nc, x), _, y in calls[:2]:
        part = slice(0, 512)   # the twin on the first 512 volumes of a call
        err = normalized_err(y[part], nc_fused_lane.nc_stack_reference(nc, x[part]))
        name = "coarse" if x.shape[1] == 25 else "fine"
        layers = layer_times(torch, nc_fused_lane, f"W serve {name}",
                             tuple(x.shape[:5]), kernels, channels, nc, x, 3)
        ms = cuda_ms(lambda: nc_fused_lane.nc_stack_resident(nc, x), 3)
        print(f"W serve: {name} stack call on {tuple(x.shape)}: kernel vs twin "
              f"normalized {err:.3e} (tolerance {TOLERANCE}); stack {ms:.3f} ms",
              flush=True)
        if not err <= TOLERANCE:
            raise SystemExit(f"W serve: the {name} NC stack disagrees with its twin")
        numbers[f"{name}_{tuple(x.shape[:5])}"] = {
            "stack_ms": round(ms, 4), "layer_ms": [round(v, 4) for v in layers],
            "normalized_err": err}
    return launches, numbers


def w_train_state(torch, nc, batch, dev):
    """A full-width bf16 training state with NC ``nc`` (kernels,
    channels): calibrated trunk on ``batch``'s sources, centre-peaked NC
    kernels, as phase 5; and its step."""
    from ncnet_tpu_torch.config import ModelConfig, TrainConfig
    from ncnet_tpu_torch.training import create_train_state, make_train_step

    cfg = TrainConfig(model=ModelConfig(
        backbone="resnet101", ncons_kernel_sizes=nc[0], ncons_channels=nc[1],
        half_precision=True))
    state, optimizer, mc, _ = create_train_state(cfg, seed=0)
    calibrate_trunk(mc, state.params, batch["source_image"])
    for layer in state.params["nc"]:
        d = layer["w"].shape[0] // 2
        layer["w"][d, d, d, d] += 1.0 / layer["w"].shape[4]
        layer["b"] = layer["b"] + 0.05
    step = make_train_step(mc, optimizer, stop_backbone_grad=True,
                           accum_chunks=cfg.accum_chunks,
                           nan_guard=cfg.nan_guard)
    return cfg, state, mc, step


def reset_counts(nc_fused_lane, vjp):
    nc_fused_lane.launches = 0
    for key in vjp.launches:
        vjp.launches[key] = 0


def b7_layer_times(torch, vjp, params, acts, g, where):
    """Each layer's dW/db, reduction and transposed launch (CUDA events)
    on a saved chunk, last layer first."""
    dw_ms, t_ms = [0.0] * len(params), [0.0] * len(params)
    gamma = g
    for li in reversed(range(len(params))):
        w, k = params[li]["w"], int(params[li]["w"].shape[0])
        gz, part = vjp.nc_vjp_dw(acts[li], acts[li + 1], gamma, k)
        dw_ms[li] = round(cuda_ms(lambda: vjp.nc_vjp_dw(
            acts[li], acts[li + 1], gamma, k), 3), 4)
        red = cuda_ms(lambda: vjp.nc_vjp_reduce(part, k), 3)
        line = (f"{where}: B7 layer {li} {tuple(w.shape)} on "
                f"{tuple(acts[li].shape)}: dW/db {dw_ms[li]:.3f} ms, reduce "
                f"{red:.3f} ms")
        if li > 0:
            t_ms[li] = round(cuda_ms(lambda: vjp.nc_conv4d_transpose(gz, w), 3), 4)
            line += f", transposed launch {t_ms[li]:.3f} ms"
            gamma = vjp.nc_conv4d_transpose(gz, w)
        print(line, flush=True)
    return dw_ms, t_ms[1:]


def w_train(torch, nc_fused_lane, vjp, dev):
    """Path (b): ``make_train_step`` at batch 16 of 400², NC ``W_TRAIN_NC``,
    3 steps: the forward on FFT, the backward on B7 and the transposed B6,
    the launches of phase 5's structure."""
    import numpy as np

    from ncnet_tpu_torch.ops.conv4d_fft import fft_stack_activations
    from ncnet_tpu_torch.ops.image import normalize_imagenet
    from ncnet_tpu_torch.training import auto_accum_chunks, weak_loss_and_grads

    rng = np.random.default_rng(1)

    def pair(n):
        src = rng.integers(0, 256, (n, 400, 400, 3), dtype=np.uint8)
        return {"source_image": src,
                "target_image": np.roll(src, TRAIN_SHIFT, axis=(1, 2))}

    cfg, state, mc, step = w_train_state(
        torch, W_TRAIN_NC, {k: normalize_imagenet(torch.as_tensor(v).to(dev))
                            for k, v in pair(16).items()}, dev)
    batches = [{k: normalize_imagenet(torch.as_tensor(v).to(dev))
                for k, v in pair(cfg.batch_size).items()}
               for _ in range(TRAIN_STEPS + 1)]
    chunks = auto_accum_chunks(cfg.batch_size)
    n_layers = len(W_TRAIN_NC[1])
    state, loss = step(state, batches[-1])  # warm-up, not counted
    torch.cuda.synchronize()
    reset_counts(nc_fused_lane, vjp)
    walls = []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, batches[i])
        loss = float(loss)
        torch.cuda.synchronize()
        walls.append(round((time.perf_counter() - t0) * 1e3, 2))
        if not np.isfinite(loss):
            raise SystemExit(f"W train: step {i + 1}: non-finite loss")
    launches = {"nc_conv4d_bf16": nc_fused_lane.launches, **vjp.launches}
    tier = nc_fused_lane.last_selected_tier()
    want = {"nc_conv4d_bf16": 0,
            "nc_vjp_dw": TRAIN_STEPS * chunks * n_layers,
            "nc_vjp_reduce": TRAIN_STEPS * chunks * n_layers,
            "nc_conv4d_transpose": TRAIN_STEPS * chunks * (n_layers - 1)}
    print(f"W train (b): {TRAIN_STEPS} steps at batch {cfg.batch_size} of "
          f"400², NC {W_TRAIN_NC}: walls {walls} ms, last loss {loss:.9g}, "
          f"launches {launches} (expected {want}), the forward's tier "
          f"{tier!r}", flush=True)
    if launches != want or tier != "fft":
        raise SystemExit("W train: the path did not launch the kernels as expected")
    calls = []
    with routed_fused_stack(nc_fused_lane.nc_stack_fused, calls):
        weak_loss_and_grads(mc, state.params, batches[0])
    params, x, _, g = calls[-1]
    params = [{k: v.detach() for k, v in p.items()} for p in params]
    acts = fft_stack_activations(params, x.to(torch.bfloat16))
    got = vjp.stack_vjp(params, acts, g, need_dx=False)
    twin = vjp.stack_vjp(params, acts, g, need_dx=False, twin=True)
    torch.cuda.synchronize()
    err = max(rel_l2(a[k], b[k]) for a, b in zip(got[0], twin[0])
              for k in ("w", "b"))
    print(f"W train: B3 on a chunk's volume {tuple(x.shape)}: NC gradients "
          f"relative L2 {err:.3e} (tolerance {STEP_TOLERANCE})", flush=True)
    if not err <= STEP_TOLERANCE:
        raise SystemExit("W train: B7 disagrees with its twin on the chunk")
    dw_ms, t_ms = b7_layer_times(torch, vjp, params, acts, g, "W train")
    return launches, {"step_wall_ms": walls, "dw_ms": dw_ms,
                      "transpose_ms": t_ms, "rel_l2": err}


def w_train_rect(torch, nc_fused_lane, vjp, dev):
    """Path (c): one rectangular training step of the IVD stack: the
    training gate takes its tap-swap chain, (3, 1, 32) and (3, 32, 2), on
    B6 forward and B7 with the transposed B6 backward; the step's NC
    gradients against the twins' step."""
    import numpy as np

    from ncnet_tpu_torch.ops.image import normalize_imagenet
    from ncnet_tpu_torch.training import auto_accum_chunks, weak_loss_and_grads

    rng = np.random.default_rng(4)
    (hs, ws), (ht, wt) = W_RECT_HW
    # two crops of one image, the target's shifted by whole cells, so the
    # positives match where they overlap and the rolled negatives do not
    base = rng.integers(0, 256, (16, max(hs, ht), max(ws, wt), 3),
                        dtype=np.uint8)
    src = base[:, :hs, :ws]
    tgt = np.roll(base, TRAIN_SHIFT, axis=(1, 2))[:, :ht, :wt]
    batch = {k: normalize_imagenet(torch.as_tensor(
        np.ascontiguousarray(v)).to(dev))
        for k, v in (("source_image", src), ("target_image", tgt))}
    cfg, state, mc, step = w_train_state(torch, W_RECT_NC, batch, dev)
    chunks = auto_accum_chunks(cfg.batch_size)
    dw_shapes = []
    reset_counts(nc_fused_lane, vjp)
    t0 = time.perf_counter()
    with routed(vjp, "nc_vjp_dw", vjp.nc_vjp_dw, dw_shapes):
        state, loss = step(state, batch)
        loss = float(loss)
    torch.cuda.synchronize()
    wall = round((time.perf_counter() - t0) * 1e3, 2)
    launches = {"nc_conv4d_bf16": nc_fused_lane.launches, **vjp.launches}
    tier = nc_fused_lane.last_selected_tier()
    layers = sorted({(a[3], int(a[0].shape[5]), int(a[1].shape[5]))
                     for a, _, _ in dw_shapes})
    # a chunk: the chain forward (2 launches), dW/db and the reduction a
    # layer, the transposed launch of its second layer (the volume needs
    # no gradient)
    want = {"nc_conv4d_bf16": 2 * chunks, "nc_vjp_dw": 2 * chunks,
            "nc_vjp_reduce": 2 * chunks, "nc_conv4d_transpose": chunks}
    print(f"W train rect (c): one step at batch {cfg.batch_size}, source "
          f"{hs}x{ws}, target {ht}x{wt}, NC {W_RECT_NC}: wall {wall} ms (its "
          f"first), loss {loss:.9g}, launches {launches} (expected {want}), "
          f"B7 layers {layers}, tier {tier!r}", flush=True)
    if (launches != want or layers != [(3, 1, 32), (3, 32, 2)]
            or tier != "resident" or not np.isfinite(loss)):
        raise SystemExit("W train rect: the step did not run the chain's kernels")
    calls = []
    with routed_fused_stack(nc_fused_lane.nc_stack_fused, calls):
        loss_k, grads_k = weak_loss_and_grads(mc, state.params, batch)
    with routed_fused_stack(twin_stack_fused):
        loss_t, grads_t = weak_loss_and_grads(mc, state.params, batch)
    torch.cuda.synchronize()
    flat = [torch.cat([t.float().flatten() for layer in g["nc"]
                       for t in (layer["w"], layer["b"])])
            for g in (grads_k, grads_t)]
    err = rel_l2(*flat)
    print(f"W train rect: NC gradients of the step, kernels vs twins, "
          f"relative L2 {err:.3e} (tolerance {STEP_TOLERANCE}); loss "
          f"{float(loss_k):.9g} vs {float(loss_t):.9g}", flush=True)
    if not err <= STEP_TOLERANCE:
        raise SystemExit("W train rect: the chain's gradients disagree with the twins'")
    params, x, _, g = calls[-1]
    params = [{k: v.detach() for k, v in p.items()} for p in params]
    acts = nc_fused_lane.stack_activations(params, x)
    dw_ms, t_ms = b7_layer_times(torch, vjp, params, acts, g, "W train rect")
    return launches, {"step_wall_ms": wall, "dw_ms": dw_ms,
                      "transpose_ms": t_ms, "rel_l2": err}


class FailingLibrary:
    """A kernel library whose every launch fails with ``code``."""

    def __init__(self, real, code):
        self.real, self.code = real, code

    def __getattr__(self, name):
        if name.endswith("_bf16") or name.endswith("_f32"):
            return lambda *args: self.code
        return getattr(self.real, name)


def w_forced_failures(torch, nc_fused_lane, vjp, dev):
    """A stack inside the gate whose build or launch fails raises, on the
    serving route and in the backward: nothing falls back to the
    formulations or to the CPU."""
    from ncnet_tpu_torch.models.ncnet import neigh_consensus

    params = stack_params((3, 3), (8, 1), seed=5, device=dev)
    corr = torch.rand((1, 6, 6, 6, 6), generator=torch.Generator().manual_seed(6)
                      ).to(dev, torch.bfloat16)

    def build_fails(k):
        raise RuntimeError("forced build failure")

    def launch_fails(module):
        real = module._library
        return lambda k: FailingLibrary(real(k), 719)

    for module, where in ((nc_fused_lane, "forward"), (vjp, "backward")):
        for how, fake in (("build", build_fails), ("launch", launch_fails(module))):
            leaves = [{k: v.clone().requires_grad_() for k, v in p.items()}
                      for p in params]
            real = module._library
            module._library = fake
            try:
                out = neigh_consensus(leaves, corr, require_vjp=True)
                out.float().sum().backward()
                torch.cuda.synchronize()
            except RuntimeError as err:
                print(f"W: a forced {how} failure of the {where} kernels on "
                      f"the held stack (3, 3) / (8, 1) raised: {err}", flush=True)
            else:
                raise SystemExit(f"W: a forced {how} failure of the {where} "
                                 "kernels did not raise")
            finally:
                module._library = real


def shape_class_phase(torch, nc_fused_lane, vjp, sparse_corr, dev):
    """Phase W: the gate, the class layers, and paths (a)-(c), each path
    read with its counts set to 0 just before it."""
    t0 = time.perf_counter()
    numbers = {"classes": shape_class_checks(torch, nc_fused_lane, vjp, dev)}
    w_forced_failures(torch, nc_fused_lane, vjp, dev)
    launches = {}
    launches["w_serve_c2f_32ch"], numbers["serve_c2f_32ch"] = w_serve(
        torch, nc_fused_lane, sparse_corr, dev)
    launches["w_train_8ch"], numbers["train_8ch"] = w_train(
        torch, nc_fused_lane, vjp, dev)
    launches["w_train_rect_ivd"], numbers["train_rect_ivd"] = w_train_rect(
        torch, nc_fused_lane, vjp, dev)
    numbers["seconds"] = round(time.perf_counter() - t0, 1)
    print(f"W: phase in {numbers['seconds']} s", flush=True)
    return numbers, launches


def check_path_calls(torch, nc_fused_lane, sparse_corr, forward, fft_stacks,
                     where):
    """Run ``forward()`` with every B4, NC-stack and FFT-stack call
    recorded: 2 B4 calls, 2 B2 stack calls on the fine tiles and
    ``fft_stacks`` FFT-tier calls (the coarse pass).  Hold each B4 call
    against its twin within ``GATHER_TOLERANCE``, each fine stack call
    against its twin within ``TOLERANCE`` and each FFT call against the
    plain direct stack, on the exact inputs the path handed them."""
    from ncnet_tpu_torch.models import ncnet as ncnet_mod

    g_calls, s_calls, f_calls = [], [], []
    with torch.no_grad(), \
            routed(sparse_corr, "gather_tile_corr_pallas",
                   sparse_corr.gather_tile_corr_pallas, g_calls), \
            routed(nc_fused_lane, "nc_stack_resident",
                   nc_fused_lane.nc_stack_resident, s_calls), \
            routed(ncnet_mod, "nc_stack_fft", ncnet_mod.nc_stack_fft, f_calls):
        forward()
        if (len(g_calls), len(s_calls), len(f_calls)) != (2, 2, fft_stacks):
            raise SystemExit(f"{where}: {len(g_calls)} B4, {len(s_calls)} NC "
                             f"stack and {len(f_calls)} FFT stack calls in one "
                             f"forward, expected 2, 2 and {fft_stacks}")
        check_fft_calls(f_calls, where)
        for i, (args, kw, y) in enumerate(g_calls):
            err = normalized_err(
                y, sparse_corr.gather_tile_corr_reference(*args, **kw))
            print(f"{where}: B4 launch {i} on the path's inputs, tiles "
                  f"{tuple(y.shape)}: kernel vs twin normalized error "
                  f"{err:.3e} (tolerance {GATHER_TOLERANCE:.3e})", flush=True)
            if not err <= GATHER_TOLERANCE:
                raise SystemExit(f"{where}: B4 disagrees with its twin on the path")
        for i, ((nc, x), _, y) in enumerate(s_calls[-2:]):
            err = normalized_err(y, nc_fused_lane.nc_stack_reference(nc, x))
            print(f"{where}: fine NC stack call {i} on the path's tiles "
                  f"{tuple(x.shape)}: kernel vs twin normalized error "
                  f"{err:.3e} (tolerance {TOLERANCE})", flush=True)
            if not err <= TOLERANCE:
                raise SystemExit(f"{where}: the NC kernel disagrees with its "
                                 "twin on the fine tiles")


def shift_recovery(table, side_cells, shift_cells) -> float:
    """Share of target cells whose matched source cell is the target cell
    moved back by the known circular shift (the trunk's zero padding breaks
    the shift near the borders, so 1.0 is not expected)."""
    import numpy as np

    cell = lambda v: np.rint((v + 1) * (side_cells - 1) / 2).astype(int)  # noqa: E731
    ia, ja, ib, jb = (cell(table[:, r]) for r in (1, 0, 3, 2))
    dy, dx = shift_cells
    ok = (ia == (ib - dy) % side_cells) & (ja == (jb - dx) % side_cells)
    return float(ok.mean())


def fine_pass_check(torch, cfg, params, fa, fb, cand_ab, cand_ba, where):
    """The fine pass on the kernel path's candidates: kernels vs the plain
    twins, within ``SERVE_TOLERANCE``."""
    from ncnet_tpu_torch.models.ncnet import _sparse_dual_refine
    from ncnet_tpu_torch.ops.sparse_topk import resolve_halo

    nc = [{k: v.to(torch.bfloat16) for k, v in layer.items()}
          for layer in params["nc"]]
    kw = dict(factor=cfg.sparse_factor,
              halo=resolve_halo(cfg.sparse_halo, cfg.sparse_factor))
    with torch.no_grad():
        got = _sparse_dual_refine(cfg, nc, fa, fb, cand_ab, cand_ba, **kw).corr
        with plain_path():
            want = _sparse_dual_refine(cfg, nc, fa, fb, cand_ab, cand_ba, **kw).corr
    torch.cuda.synchronize()
    err = normalized_err(got, want)
    print(f"{where}: fine pass {tuple(got.shape)} on the kernel path's "
          f"candidates, kernel path vs plain path normalized error {err:.3e} "
          f"(tolerance {SERVE_TOLERANCE}), {int((got != 0).sum())} nonzero "
          "cells", flush=True)
    if not err <= SERVE_TOLERANCE:
        raise SystemExit(f"{where}: the fine pass disagrees with the plain path")


def serving_params(torch, cfg, dev, side, seed=0):
    """The PF-Pascal model's parameters on ``dev`` for the served phases (B,
    E, R; phase N's candidate with ``seed`` 1): random from ``seed``, the
    trunk's BatchNorm statistics from one
    seeded batch at ``side`` through the f32 trunk (the bf16 trunk runs on
    a cast copy of the parameters), NC kernels centre-peaked with biases
    off zero, as in phase 5."""
    import numpy as np

    from ncnet_tpu_torch.models.ncnet import init_ncnet, params_to
    from ncnet_tpu_torch.ops.image import normalize_imagenet

    params = params_to(init_ncnet(cfg, seed=seed), dev)
    calib = np.random.default_rng(3).integers(
        0, 256, (SERVE_BATCH, side, side, 3), dtype=np.uint8)
    calibrate_trunk(cfg.replace(backbone_bf16=False), params,
                    normalize_imagenet(torch.as_tensor(calib).to(dev)))
    for layer in params["nc"]:
        d = layer["w"].shape[0] // 2
        layer["w"][d, d, d, d] += 1.0 / layer["w"].shape[4]
        layer["b"] = layer["b"] + 0.05
    return params


def c2f_requests(seed, shift, side=C2F_SIDE):
    """``C2F_REQUESTS + 1`` requests of uint8 pairs at ``side``, each
    target its source rolled by ``shift`` pixels."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shape = (SERVE_BATCH, side, side, 3)
    out = []
    for _ in range(C2F_REQUESTS + 1):
        src = rng.integers(0, 256, shape, dtype=np.uint8)
        out.append((src, np.roll(src, shift, axis=(1, 2))))
    return out


def serve_c2f(torch, nc_fused_lane, sparse_corr, dev):
    """Phase B: coarse-to-fine serving at full width, and one dense request
    beside it.  Returns the engine, its parameters, the requests, their
    tables, the coarse-to-fine launches and the dense request's B2
    launches."""
    import numpy as np

    from ncnet_tpu_torch.config import ModelConfig
    from ncnet_tpu_torch.models.ncnet import (
        coarse2fine_filter,
        extract_features,
        ncnet_filter,
    )
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.image import normalize_imagenet
    from ncnet_tpu_torch.ops.sparse_topk import (
        candidate_recall,
        pool_features,
        topk_candidates,
    )
    from ncnet_tpu_torch.serving.engine import BatchMatchEngine

    cfg = ModelConfig(backbone="resnet101", ncons_kernel_sizes=(5, 5, 5),
                      ncons_channels=(16, 16, 1), half_precision=True,
                      backbone_bf16=True, sparse_topk=C2F_TOPK, sparse_factor=2)
    params = serving_params(torch, cfg, dev, C2F_SIDE)
    requests = c2f_requests(seed=2, shift=TRAIN_SHIFT)
    engine = BatchMatchEngine(cfg, params)
    n_cells = (C2F_SIDE // 16) ** 2

    engine.fetch(engine.dispatch(*requests[-1]))  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    passes = engine.coarse_passes
    nc_fused_lane.launches = 0
    sparse_corr.launches = 0
    walls, tables = [], []
    for src, tgt in requests[:C2F_REQUESTS]:
        t0 = time.perf_counter()
        tables.append(engine.fetch(engine.dispatch(src, tgt)))
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = {"nc_conv4d_bf16": nc_fused_lane.launches,
                "gather_tile_corr_bf16": sparse_corr.launches}
    passes = engine.coarse_passes - passes
    peak = torch.cuda.max_memory_allocated()
    print(f"c2f serve: {C2F_REQUESTS} requests of {SERVE_BATCH} pairs at "
          f"{C2F_SIDE}x{C2F_SIDE}, sparse_topk {cfg.sparse_topk}, wall ms per "
          f"request {walls}, peak memory {peak} bytes, launches {launches}, "
          f"coarse passes {passes}", flush=True)
    check_tables(tables, n_cells, "c2f serve")
    # the coarse 25⁴ pass takes the FFT tier; the fine tiles 3 launches a
    # family
    want = {"nc_conv4d_bf16": 6 * C2F_REQUESTS,
            "gather_tile_corr_bf16": 2 * C2F_REQUESTS}
    if launches != want or passes != C2F_REQUESTS:
        raise SystemExit(f"c2f serve: expected launches {want} and "
                         f"{C2F_REQUESTS} coarse passes")
    print(f"c2f serve: tables ok; quality of pair 0: "
          f"{engine.split(tables[0])[1][0]}", flush=True)

    # one request again with every kernel call recorded: B4 and the fine NC
    # stack against their twins on the exact inputs the path handed them
    src, tgt = (normalize_imagenet(torch.as_tensor(a).to(dev))
                for a in requests[0])
    with torch.no_grad():
        fa, fb = (extract_features(cfg, params, x).to(torch.bfloat16)
                  for x in (src, tgt))
    check_path_calls(torch, nc_fused_lane, sparse_corr,
                     lambda: coarse2fine_filter(cfg, params, fa, fb), 1,
                     "c2f serve")

    # candidates: the kernel path's, the plain coarse pass's, the recall
    k = cfg.sparse_topk
    with torch.no_grad():
        fac, fbc = (pool_features(f, cfg.sparse_factor) for f in (fa, fb))
        coarse = ncnet_filter(cfg, params, correlation_4d(fac, fbc)).corr
        cand = [topk_candidates(v, k)
                for v in (coarse, coarse.permute(0, 3, 4, 1, 2))]
        with plain_path():
            coarse_p = ncnet_filter(cfg, params, correlation_4d(fac, fbc)).corr
        rows = zip(cand[0].reshape(-1, k).tolist(),
                   topk_candidates(coarse_p, k).reshape(-1, k).tolist())
        agree = float(np.mean([len(set(a) & set(p)) / k for a, p in rows]))
        recall = candidate_recall(cand[0], correlation_4d(fa, fb),
                                  cfg.sparse_factor)
    print(f"c2f serve: candidates, kernel vs plain coarse pass, share shared "
          f"{agree:.4f}; recall against the dense raw correlation "
          f"{recall:.4f} (printed, not gated)", flush=True)
    fine_pass_check(torch, cfg, params, fa, fb, cand[0], cand[1], "c2f serve")

    # the dense path at the same size: one request, its wall and recovery
    dense = BatchMatchEngine(cfg.replace(sparse_topk=0), params)
    dense.fetch(dense.dispatch(*requests[1]))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    calls = []
    nc_fused_lane.launches = 0
    with routed(nc_fused_lane, "nc_stack_resident",
                nc_fused_lane.nc_stack_resident, calls):
        t0 = time.perf_counter()
        dense_table = dense.fetch(dense.dispatch(*requests[0]))
        dense_wall = (time.perf_counter() - t0) * 1e3
    dense_launches = nc_fused_lane.launches
    peak = torch.cuda.max_memory_allocated()
    (dense_nc, dense_x), _, dense_y = calls[0]
    dense_err = normalized_err(
        dense_y, nc_fused_lane.nc_stack_reference(dense_nc, dense_x))
    print(f"c2f serve: dense request's NC stack on {tuple(dense_x.shape)} vs "
          f"its twin: normalized {dense_err:.3e} (tolerance {TOLERANCE}); "
          f"launches {dense_launches}", flush=True)
    if len(calls) != 1 or dense_launches != 3 or not dense_err <= TOLERANCE:
        raise SystemExit("c2f serve: the dense request's NC stack disagrees "
                         "with its twin or did not run one 3-layer B2 call")
    dense_nc_ms = cuda_ms(lambda: nc_fused_lane.nc_stack_resident(dense_nc, dense_x), 1)
    cells = (TRAIN_SHIFT[0] // 16, TRAIN_SHIFT[1] // 16)
    side_cells = C2F_SIDE // 16
    print(f"c2f serve: shift recovery (share of target cells matched to the "
          f"shifted source cell) sparse "
          f"{shift_recovery(tables[0], side_cells, cells):.4f}, dense "
          f"{shift_recovery(dense_table, side_cells, cells):.4f}; dense request "
          f"at {C2F_SIDE}x{C2F_SIDE}: wall {dense_wall:.1f} ms, peak memory "
          f"{peak} bytes, its NC stack on {tuple(dense_x.shape)} "
          f"{dense_nc_ms:.2f} ms", flush=True)
    c2f_stages(torch, sparse_corr, cfg, params, src, tgt)
    return engine, params, requests, tables, launches, dense_launches


def c2f_stages(torch, sparse_corr, cfg, params, src, tgt):
    """CUDA-event ms of each stage of one coarse-to-fine request (warm, one
    stage at a time, both candidate families where there are two)."""
    from ncnet_tpu_torch.models.ncnet import (
        extract_features,
        ncnet_filter,
        neigh_consensus,
    )
    from ncnet_tpu_torch.observability.quality import append_quality_rows
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import corr_to_matches, scatter_sparse_scores
    from ncnet_tpu_torch.ops.sparse_topk import (
        patch_side,
        pool_features,
        resolve_halo,
        topk_candidates,
    )

    factor = cfg.sparse_factor
    halo = resolve_halo(cfg.sparse_halo, factor)
    patch = patch_side(factor, halo)
    nc = [{k: v.to(torch.bfloat16) for k, v in layer.items()}
          for layer in params["nc"]]

    def trunk():
        return (extract_features(cfg, params, src).to(torch.bfloat16),
                extract_features(cfg, params, tgt).to(torch.bfloat16))

    def coarse_pass():
        fac, fbc = (pool_features(f, factor) for f in (fa, fb))
        return ncnet_filter(cfg, params, correlation_4d(fac, fbc)).corr

    def topk():
        return (topk_candidates(coarse, cfg.sparse_topk),
                topk_candidates(coarse.permute(0, 3, 4, 1, 2), cfg.sparse_topk))

    def tiles():
        return [sparse_corr.sparse_fine_corr(x, y, c, factor=factor, halo=halo)
                for x, y, c in fams]

    def gate(ts):
        return [sparse_corr.sparse_mutual_matching(
            t, grid_a=x.shape[1:3], grid_b=y.shape[1:3])
            for t, (x, y, _) in zip(ts, fams)]

    def fine_stack():
        return [neigh_consensus(nc, t.values.reshape(-1, *(patch,) * 4))
                for t in gated]

    def readout():
        vols = []
        for t, f, (x, y, c) in zip(raw, filtered, fams):
            v = f.reshape(t.values.shape) * sparse_corr.core_mask(
                t, c, y.shape[2] // factor, x.shape[2] // factor,
                factor).to(f.dtype)
            t = sparse_corr.sparse_mutual_matching(
                t._replace(values=v), grid_a=x.shape[1:3], grid_b=y.shape[1:3])
            vols.append(scatter_sparse_scores(
                t.values, t.ia, t.ja, t.ib, t.jb,
                tuple(x.shape[1:3]) + tuple(y.shape[1:3])))
        return torch.maximum(vols[0], vols[1].permute(0, 3, 4, 1, 2))

    def tables():
        m = corr_to_matches(corr, do_softmax=True)
        return append_quality_rows(
            torch.stack([v.to(torch.float32) for v in m], dim=1), corr)

    with torch.no_grad():
        fa, fb = trunk()
        coarse = coarse_pass()
        cand_ab, cand_ba = topk()
        fams = [(fa, fb, cand_ab), (fb, fa, cand_ba)]
        raw = tiles()
        gated = gate(raw)
        filtered = fine_stack()
        corr = readout()
        stages = {
            "trunk, both sides": cuda_ms(trunk, 3),
            "coarse pass (pool, correlation, filter: FFT tier)": cuda_ms(coarse_pass, 3),
            "top-k, both families": cuda_ms(topk, 3),
            "tiles: source gathers, origins, B4 (2 launches)": cuda_ms(tiles, 3),
            "sparse gating before the stack, both families": cuda_ms(lambda: gate(raw), 3),
            "fine NC stack (6 NC launches)": cuda_ms(fine_stack, 1),
            "core readout, gating after the stack, scatter, merge": cuda_ms(readout, 3),
            "matches and quality row": cuda_ms(tables, 3),
        }
    print(f"c2f serve stages ms per request ({C2F_SIDE}x{C2F_SIDE}, "
          f"B={SERVE_BATCH}): " + json.dumps(stages), flush=True)


def serve_tracked(torch, nc_fused_lane, sparse_corr, engine, params,
                  requests, tables):
    """Phase C: tracked frames through ``dispatch_tracked``, each frame the
    request's sources against their targets rolled by one more cell."""
    import numpy as np

    from ncnet_tpu_torch.models.ncnet import (
        coarse2fine_tracked_filter,
        extract_features,
    )
    from ncnet_tpu_torch.ops.image import normalize_imagenet
    from ncnet_tpu_torch.ops.temporal import (
        prior_from_table,
        temporal_candidates,
        tracking_recall_proxy,
    )

    cfg = engine.config
    grid = (C2F_SIDE // 16,) * 2
    factor = cfg.sparse_factor
    if not engine.tracking_feasible((C2F_SIDE,) * 2, (C2F_SIDE,) * 2):
        raise SystemExit("tracked serve: the shape is not tracking-feasible")

    def priors(batch_table):
        pairs = [prior_from_table(t, grid, grid, factor) for t in batch_table]
        return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])

    src = requests[0][0]
    pab, pba = priors(tables[0])
    passes, feats = engine.coarse_passes, engine.feature_extractions
    nc_fused_lane.launches = 0
    sparse_corr.launches = 0
    walls, extractions, frames = [], [], []
    for f in range(1, TRACK_FRAMES + 1):
        shift = (TRAIN_SHIFT[0] + 16 * f, TRAIN_SHIFT[1] + 16 * f)
        frame = np.roll(src, shift, axis=(1, 2))
        t0 = time.perf_counter()
        table = engine.fetch(engine.dispatch_tracked(src, frame, pab, pba))
        walls.append((time.perf_counter() - t0) * 1e3)
        extractions.append(engine.feature_extractions - feats)
        frames.append((frame, pab, pba, table))
        proxy = [tracking_recall_proxy(p, t, grid, grid, factor, cfg.track_radius)
                 for p, t in zip(pab, table)]
        print(f"tracked frame {f}: wall {walls[-1]:.1f} ms, recall proxy per "
              f"pair {proxy}", flush=True)
        pab, pba = priors(table)
    launches = {"nc_conv4d_bf16": nc_fused_lane.launches,
                "gather_tile_corr_bf16": sparse_corr.launches}
    print(f"tracked serve: {TRACK_FRAMES} frames of {SERVE_BATCH} pairs at "
          f"{C2F_SIDE}x{C2F_SIDE}, track_radius {cfg.track_radius}, launches "
          f"{launches}, coarse passes {engine.coarse_passes - passes}, source "
          f"extractions after each frame {extractions}", flush=True)
    check_tables([t for *_, t in frames], grid[0] * grid[1], "tracked serve")
    want = {"nc_conv4d_bf16": 6 * TRACK_FRAMES,
            "gather_tile_corr_bf16": 2 * TRACK_FRAMES}
    if (launches != want or engine.coarse_passes != passes
            or extractions != [SERVE_BATCH] * TRACK_FRAMES):
        raise SystemExit(f"tracked serve: expected launches {want}, no coarse "
                         f"pass and {SERVE_BATCH} source extractions, once")

    # the first frame again with every kernel call recorded, each against
    # its twin; then its fine pass against the plain path, its candidates
    frame, pab, pba, _ = frames[0]
    with torch.no_grad():
        fa = torch.stack([engine._resolve_src_features(r, None) for r in src])
        fb = extract_features(cfg, params, normalize_imagenet(
            torch.as_tensor(frame).to(fa.device)))
        fa, fb = fa.to(torch.bfloat16), fb.to(torch.bfloat16)
    check_path_calls(
        torch, nc_fused_lane, sparse_corr,
        lambda: coarse2fine_tracked_filter(cfg, params, fa, fb, pab, pba), 0,
        "tracked serve")
    with torch.no_grad():
        hc = grid[0] // factor
        cand_ab, cand_ba = (temporal_candidates(
            torch.as_tensor(p).to(fa.device), hc, hc, cfg.track_radius)
            for p in (pab, pba))
    fine_pass_check(torch, cfg, params, fa, fb, cand_ab, cand_ba,
                    "tracked serve")
    return launches


def service_requests(seed, n):
    """``n`` raw uint8 pairs, each side drawn from ``SERVICE_SIDES``, each
    target its source rolled by ``TRAIN_SHIFT`` pixels."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h, w = (int(v) for v in rng.integers(SERVICE_SIDES[0],
                                             SERVICE_SIDES[1] + 1, 2))
        src = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        out.append((src, np.roll(src, TRAIN_SHIFT, axis=(0, 1))))
    return out


def submit_group(svc, group, client, deadline_s=None):
    """Submit one group of pairs under the service's lock, so the whole
    group enters the queue at once and the dispatcher takes it as one
    batch (its rows in submission order)."""
    with svc._cond:
        return [svc.submit(s, t, client=client, deadline_s=deadline_s)
                for s, t in group]


def percentile(values, q):
    import numpy as np

    return float(np.percentile(np.asarray(values, np.float64), q))


def service_outcomes(events):
    """The outcome identity's terms from an event log: the admitted count,
    the terminal events by kind (results, admitted deadlines, quarantines,
    admitted sheds) and the admitted ids that reached no outcome."""
    import collections

    admitted = {e["request"] for e in events if e["event"] == "serve_admit"}
    terminal = [e for e in events
                if e["event"] in ("serve_result", "serve_quarantine")
                or (e["event"] in ("serve_deadline", "serve_shed")
                    and e.get("admitted") is True)]
    n = collections.Counter(e["event"] for e in terminal)
    return len(admitted), n, sorted(admitted - {e["request"] for e in terminal})


def serve_service(torch, nc_fused_lane, sparse_corr, params, devices=None):
    """Phase S: one serving process end to end (``MatchService`` with two
    replicas, the feature store, stream sessions and the drain) on the
    coarse-to-fine PF-Pascal model of phase B with its weights.  Returns
    the launches of the cold pass and of the stream, each window read with
    the counts set to 0 just before it and with the worker the only thread
    that dispatches (no replica is dead, so no probe runs)."""
    import tempfile
    import threading

    import numpy as np

    from ncnet_tpu_torch.config import ModelConfig
    from ncnet_tpu_torch.observability import events as obs_events
    from ncnet_tpu_torch.observability import memory as obs_memory
    from ncnet_tpu_torch.serving import (
        DeadlineExceeded,
        MatchService,
        ServingConfig,
        pad_to_bucket,
    )
    from ncnet_tpu_torch.utils import faults

    cfg = ModelConfig(backbone="resnet101", ncons_kernel_sizes=(5, 5, 5),
                      ncons_channels=(16, 16, 1), half_precision=True,
                      backbone_bf16=True, sparse_topk=C2F_TOPK, sparse_factor=2)
    if devices is None:
        n_cards = torch.cuda.device_count()
        devices = ["cuda:0"] * 2 if n_cards < 2 else [f"cuda:{i}" for i in (0, 1)]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_service_")
    os.environ["NCNET_TPU_MEMORY_LEDGER"] = os.path.join(tmp, "ledger.json")
    obs_memory._reset_state()
    side = C2F_SIDE
    bucket = ((side, side), (side, side))
    serving = ServingConfig(
        buckets=((side, side),), warm_buckets=((side, side),),
        max_batch=SERVICE_BATCH, replicas=2, max_queue=SERVICE_MAX_QUEUE,
        max_in_flight_per_client=4 * SERVICE_BURST, retries=1,
        replica_max_failures=SERVICE_MAX_FAILURES, resurrect_after_s=1.0,
        max_image_side=side, feature_store_dir=os.path.join(tmp, "store"),
        quarantine_dir=os.path.join(tmp, "quarantine"))
    log_path = os.path.join(tmp, "events.jsonl")
    requests = service_requests(11, SERVICE_REQUESTS)
    per_client = SERVICE_REQUESTS // SERVICE_CLIENTS
    groups = {c: [requests[c * per_client + g:c * per_client + g + SERVICE_BATCH]
                  for g in range(0, per_client, SERVICE_BATCH)]
              for c in range(SERVICE_CLIENTS)}
    all_groups = [grp for c in range(SERVICE_CLIENTS) for grp in groups[c]]
    log = obs_events.EventLog(log_path)
    prev_sink = obs_events.set_global_sink(log)
    t_phase = time.perf_counter()
    svc = MatchService(cfg, params, serving, devices=devices).start()
    try:
        while svc.state == "STARTING":
            time.sleep(0.05)
        t_ready = time.perf_counter() - t_phase
        store = svc._store
        resolves = []
        real_resolve = store.resolve

        def timed_resolve(digest, compute):
            t0 = time.perf_counter()
            out = real_resolve(digest, compute)
            resolves.append((out[1], (time.perf_counter() - t0) * 1e3))
            return out

        store.resolve = timed_resolve
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        def run_pass(name):
            """Both clients' groups, each client closed-loop (its next group
            after its last one resolved); returns {(client, group, row):
            MatchResult}."""
            out, errors = {}, []

            def client(c):
                try:
                    for g, group in enumerate(groups[c]):
                        futs = submit_group(svc, group, f"client{c}",
                                            SERVICE_DEADLINE_S)
                        for r, f in enumerate(futs):
                            out[(c, g, r)] = f.result(timeout=120)
                except Exception as e:  # noqa: BLE001 — raised below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(SERVICE_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                raise SystemExit(f"service {name} pass: {errors[0]!r}")
            return out

        nc_fused_lane.launches = 0
        sparse_corr.launches = 0
        batches0 = svc.health()["activity"]["batches"]
        cold = run_pass("cold")
        launches = {"nc_conv4d_bf16": nc_fused_lane.launches,
                    "gather_tile_corr_bf16": sparse_corr.launches}
        cold_batches = svc.health()["activity"]["batches"] - batches0
        want = {"nc_conv4d_bf16": 6 * cold_batches,
                "gather_tile_corr_bf16": 2 * cold_batches}
        walls = [r.wall_s * 1e3 for r in cold.values()]
        print(f"service: ready after {t_ready:.1f} s (warm-up of the ladder "
              f"{svc._batch_ladder()} on {len(devices)} replicas); cold pass "
              f"{len(cold)} requests in {cold_batches} batches, request wall "
              f"ms p50 {percentile(walls, 50):.1f} p95 "
              f"{percentile(walls, 95):.1f}; launches {launches}", flush=True)
        if cold_batches != SERVICE_REQUESTS // SERVICE_BATCH or launches != want:
            raise SystemExit(f"service: expected {SERVICE_REQUESTS // SERVICE_BATCH}"
                             f" batches and launches {want}")
        n_miss = len(resolves)
        warm = run_pass("warm")
        hits = [ms for status, ms in resolves[n_miss:] if status == "hit"]
        misses = [ms for status, ms in resolves[:n_miss] if status == "miss"]
        same = all(np.array_equal(cold[k].table, warm[k].table) for k in cold)
        print(f"service: warm pass {len(warm)} requests, store hits "
              f"{len(hits)} of {len(resolves) - n_miss} resolves, hit rate "
              f"{store.hit_pct()} % over both passes; ms a hit "
              f"{np.mean(hits) if hits else float('nan'):.2f}, a miss (row "
              f"extraction and commit) {np.mean(misses) if misses else float('nan'):.2f}; "
              f"warm tables bitwise the cold ones: {same}", flush=True)
        if not same or len(hits) != SERVICE_REQUESTS:
            raise SystemExit("service: the warm pass is not bitwise the cold "
                             "pass, or missed the store")

        # one group's batch through the engine directly, every kernel call
        # recorded and held against its twin; its rows bit-equal to the
        # service's results for that group
        engine = svc._pool.replicas[0].engine
        src = pad_to_bucket([s for s, _ in groups[0][0]], bucket[0])
        tgt = pad_to_bucket([t for _, t in groups[0][0]], bucket[1])
        g_calls, s_calls = [], []
        with routed(sparse_corr, "gather_tile_corr_pallas",
                    sparse_corr.gather_tile_corr_pallas, g_calls), \
                routed(nc_fused_lane, "nc_stack_resident",
                       nc_fused_lane.nc_stack_resident, s_calls):
            direct = engine.split(engine.fetch(engine.dispatch(src, tgt)))[0]
        if (len(g_calls), len(s_calls)) != (2, 2):
            raise SystemExit(f"service: {len(g_calls)} B8 and {len(s_calls)} "
                             "B6 stack calls in one direct dispatch, expected 2 and 2")
        errs = []
        with torch.no_grad():
            for args, kw, y in g_calls:
                errs.append(("B8", normalized_err(
                    y, sparse_corr.gather_tile_corr_reference(*args, **kw)),
                    GATHER_TOLERANCE))
            for (nc, x), _, y in s_calls:
                errs.append(("B6", normalized_err(
                    y, nc_fused_lane.nc_stack_reference(nc, x)), TOLERANCE))
        print(f"service: direct dispatch of group 0's batch, kernels vs twins "
              f"on the path's inputs: {[(k, f'{e:.3e}') for k, e, _ in errs]}",
              flush=True)
        if not all(e <= tol for _, e, tol in errs):
            raise SystemExit("service: a kernel disagrees with its twin")
        # every group's batch through the engine directly: each result of
        # the service bit-equal to the direct dispatch's row
        unequal = []
        for c in range(SERVICE_CLIENTS):
            for g, group in enumerate(groups[c]):
                rows = direct if (c, g) == (0, 0) else engine.split(
                    engine.fetch(engine.dispatch(
                        pad_to_bucket([s for s, _ in group], bucket[0]),
                        pad_to_bucket([t for _, t in group], bucket[1]))))[0]
                unequal += [(c, g, r) for r in range(len(group))
                            if not np.array_equal(rows[r], cold[(c, g, r)].table)]
        print(f"service: each of the {len(cold)} results against the direct "
              f"dispatch of its batch: {len(cold) - len(unequal)} bit-equal",
              flush=True)
        if unequal:
            raise SystemExit(f"service: results {unequal} are not the direct "
                             "dispatch's on the same batch")
        # the same batch through Replica.dispatch with host waits forbidden
        rep = svc._pool.replicas[0]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            handle = rep.dispatch(src, tgt)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        again = engine.split(rep.fetch(handle))[0]
        print(f"service: Replica.dispatch under set_sync_debug_mode('error'): "
              f"no host wait; its table bit-equal to the service's: "
              f"{all(np.array_equal(again[r], direct[r]) for r in range(SERVICE_BATCH))}",
              flush=True)
        if not np.array_equal(again, direct):
            raise SystemExit("service: Replica.dispatch's table differs")

        # a burst over the queue bound under the profiler, and one request
        # whose budget is already spent
        burst_src, burst_tgt = groups[0][0][0]
        trace = os.path.join(tmp, "burst_trace.json")
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        t0 = time.perf_counter()
        futs, sheds = faults.queue_overflow_burst(
            lambda: svc.submit(burst_src, burst_tgt, client="burst"),
            SERVICE_BURST)
        burst = [f.result(timeout=120) for f in futs]
        burst_wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(trace)
        busy, window, n_dev = trace_busy_share(trace)
        reasons = sorted({s.reason for s in sheds})
        print(f"service: burst of {SERVICE_BURST} over max_queue "
              f"{SERVICE_MAX_QUEUE}: {len(burst)} admitted and served, "
              f"{len(sheds)} shed {reasons}, retry_after_s "
              f"{sorted({round(s.retry_after_s, 4) for s in sheds})[:3]}; wall "
              f"{burst_wall:.2f} s; device busy {busy:.3f} s of the traced "
              f"{window:.3f} s window ({n_dev} device events): busy share "
              f"{busy / window if window else float('nan'):.4f}", flush=True)
        if not sheds or reasons != ["queue_full"]:
            raise SystemExit("service: the burst did not shed queue_full")
        try:
            svc.submit(burst_src, burst_tgt, deadline_s=0)
            raise SystemExit("service: an expired deadline was admitted")
        except DeadlineExceeded as e:
            if e.where != "admission":
                raise SystemExit(f"service: deadline at {e.where}") from e

        # a replica fails until it goes DEAD, the other serves, a probe
        # resurrects it
        plan = faults.FaultPlan(dead_replica_ids=("rep1",))
        faults.install(plan)
        fault_futs = []
        try:
            t0 = time.perf_counter()
            g = 0
            while svc._pool.replicas[1].state != "DEAD":
                if time.perf_counter() - t0 > 60:
                    raise SystemExit("service: rep1 never went DEAD")
                # three groups at once: a failure doubles rep1's routing
                # cost, and one group at a time can always find rep0 idle
                # and cheaper; rep0's load makes rep1 the cheaper again
                for _ in range(3):
                    fault_futs += submit_group(
                        svc, all_groups[g % len(all_groups)], "fault")
                    g += 1
                for f in fault_futs[-3 * SERVICE_BATCH:]:
                    f.result(timeout=120)
        finally:
            faults.clear()
        degraded = svc.state
        t0 = time.perf_counter()
        while svc.health()["pool"]["ready"] != 2:
            if time.perf_counter() - t0 > 60:
                raise SystemExit("service: rep1 was not resurrected")
            time.sleep(0.05)
        rep1 = svc.health()["pool"]["replicas"][1]
        print(f"service: rep1 failed {SERVICE_MAX_FAILURES} times and went DEAD "
              f"(service {degraded}); {len(fault_futs)} requests meanwhile, all "
              f"{sorted({f.outcome for f in fault_futs})}; resurrected by a probe "
              f"after {time.perf_counter() - t0:.2f} s; rep1 failures "
              f"{rep1['failures']}, deaths {rep1['deaths']}; service "
              f"{svc.state}", flush=True)
        if degraded != "DEGRADED" or svc.state != "READY" or \
                any(f.outcome != "result" for f in fault_futs):
            raise SystemExit("service: the failover lost a request or the "
                             "health machine did not degrade and recover")

        # a stream of frames at the bucket's side
        stream_src = requests[0][0][:side, :side]
        nc_fused_lane.launches = 0
        sparse_corr.launches = 0
        batches0 = svc.health()["activity"]["batches"]
        frames = []
        for f in range(SERVICE_FRAMES):
            shift = (TRAIN_SHIFT[0] + 16 * f, TRAIN_SHIFT[1] + 16 * f)
            t0 = time.perf_counter()
            fr = svc.stream_submit("cam0", stream_src,
                                   np.roll(stream_src, shift, axis=(0, 1)))
            frames.append((fr, (time.perf_counter() - t0) * 1e3))
        stream_launches = {"nc_conv4d_bf16": nc_fused_lane.launches,
                           "gather_tile_corr_bf16": sparse_corr.launches}
        stream_batches = svc.health()["activity"]["batches"] - batches0
        kinds = ["tracked" if fr.tracked else "fallback" if fr.fallback
                 else "cold" for fr, _ in frames]
        print(f"service: stream of {SERVICE_FRAMES} frames at {side}x{side}: "
              f"{kinds}, frame wall ms {[round(w, 1) for _, w in frames]}, "
              f"recall proxy {[fr.recall for fr, _ in frames]}; "
              f"{stream_batches} batches, launches {stream_launches}",
              flush=True)
        want = {"nc_conv4d_bf16": 6 * stream_batches,
                "gather_tile_corr_bf16": 2 * stream_batches}
        if stream_launches != want or "tracked" not in kinds:
            raise SystemExit(f"service: the stream expected launches {want} "
                             "and a tracked frame")
        for fr, _ in frames:
            t = fr.table
            if t.shape != (5, (side // 16) ** 2) or not np.isfinite(t).all() \
                    or t[4].min() < 0 or t[4].max() > 1:
                raise SystemExit(f"service stream: bad frame table {t.shape}")

        mem = svc.health()["memory"]
        print(f"service: peak memory {torch.cuda.max_memory_allocated()} "
              f"bytes; the ladder's predicted bytes (ledger, temp + output of "
              f"{mem['ledger_programs']} programs) {mem['predicted_ladder_bytes']}; "
              f"rows {[(r['shape_class'], r['temp_bytes'], r['output_bytes']) for r in obs_memory.ledger_rows(program=obs_memory.SERVE_PROGRAM)]}",
              flush=True)

        # drain with work in flight
        drain_futs = []
        for group in all_groups[:SERVICE_DRAIN // SERVICE_BATCH]:
            drain_futs += submit_group(svc, group, "drain")
        svc.request_drain()
        drained = [f.result(timeout=120) for f in drain_futs]
        svc.stop(timeout=120)
    finally:
        faults.clear()
        if svc._worker is not None and svc._worker.is_alive():
            svc.stop(drain=False, timeout=30)
        obs_events.set_global_sink(prev_sink)
        log.close()
    _, events = obs_events.replay_events(log_path)
    admitted, n, lost = service_outcomes(events)
    drains = [e for e in events if e["event"] == "serve_drain"]
    batch_walls = [e["wall_s"] * 1e3 for e in events if e["event"] == "serve_batch"]
    depths = [e["queue_depth"] for e in events if e["event"] == "serve_batch"]
    print(f"service: drain with {len(drained)} requests in flight: "
          f"{drains[0] if drains else None}; event log: admitted {admitted} == "
          f"results {n['serve_result']} + deadlines {n['serve_deadline']} + "
          f"quarantines {n['serve_quarantine']} + admitted sheds "
          f"{n['serve_shed']}; lost {lost}; batch wall ms p50 "
          f"{percentile(batch_walls, 50):.1f} p95 {percentile(batch_walls, 95):.1f} "
          f"over {len(batch_walls)} batches; queue depth at a batch max "
          f"{max(depths)} mean {np.mean(depths):.2f}; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if (admitted != sum(n.values()) or lost or len(drains) != 1
            or not drains[0]["drained"] or drains[0]["leftover"]):
        raise SystemExit("service: the outcome identity failed, a request was "
                         "lost, or the drain was not clean")
    leave("S", events=log_path)
    shutil.rmtree(tmp)
    os.environ.pop("NCNET_TPU_MEMORY_LEDGER")
    return launches, stream_launches

def pod_model_config():
    """Phase S's coarse-to-fine PF-Pascal model, which phase N serves."""
    from ncnet_tpu_torch.config import ModelConfig

    return ModelConfig(backbone="resnet101", ncons_kernel_sizes=(5, 5, 5),
                       ncons_channels=(16, 16, 1), half_precision=True,
                       backbone_bf16=True, sparse_topk=C2F_TOPK,
                       sparse_factor=2)


def pod_backend(spec) -> int:
    """One of phase N's backend processes (``chip_smoke.py --pod-backend
    <spec>``): a ``MatchService`` on the card with the introspection plane
    on ``spec["port"]`` (0: ephemeral), serving the native checkpoint
    ``spec["checkpoint"]`` with ``spec["replicas"]`` replicas on ``cuda:0``
    and ``spec["max_batch"]``, under an event log at ``spec["events"]``.
    The kernel counts are set to 0 before the service is built, so they
    cover the process's whole path (its warm-up, the requests, the
    rollouts' re-warms); once READY it prints the ``{"url", "pid"}`` line;
    SIGTERM drains it, and at exit it prints its launches and engine
    dispatches as one JSON line.  Without a card it
    raises: a backend started for the card never serves on the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("pod backend: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ncnet_tpu_torch.models.checkpoint import load_params
    from ncnet_tpu_torch.observability import EventLog
    from ncnet_tpu_torch.observability import events as obs_events
    from ncnet_tpu_torch.ops import kernel_build, nc_fused_lane, sparse_corr
    from ncnet_tpu_torch.serving import (BatchMatchEngine, MatchService,
                                         ServingConfig)

    kernel_build.build()
    obs_events.set_global_sink(EventLog(spec["events"]))
    cfg, params = load_params(spec["checkpoint"], pod_model_config())
    dispatches = [0]
    dispatch = BatchMatchEngine.dispatch

    def counted(self, *args, **kw):
        dispatches[0] += 1
        return dispatch(self, *args, **kw)

    BatchMatchEngine.dispatch = counted
    nc_fused_lane.launches = 0
    sparse_corr.launches = 0
    side = C2F_SIDE
    svc = MatchService(cfg, params, ServingConfig(
        buckets=((side, side),), warm_buckets=((side, side),),
        max_image_side=side, max_batch=spec["max_batch"],
        replicas=spec["replicas"], max_queue=64, max_in_flight_per_client=64,
        retries=1, install_sigterm=True, introspect_port=spec["port"]),
        devices=["cuda:0"] * spec["replicas"]).start()
    while svc.state == "STARTING":
        time.sleep(0.05)
    if svc.introspect_url is None:
        svc.stop(drain=False)
        raise SystemExit(f"pod backend: port {spec['port']} did not bind")
    print(json.dumps({"url": svc.introspect_url, "pid": os.getpid()}),
          flush=True)
    while svc.state != "STOPPED":
        time.sleep(0.05)
        if svc.state == "DRAINING":
            svc.stop()
    print(json.dumps({"pod_backend": {
        "nc_conv4d_bf16": nc_fused_lane.launches,
        "gather_tile_corr_bf16": sparse_corr.launches,
        "dispatches": dispatches[0]}}), flush=True)
    return 0


class PodBackend:
    """A phase N backend process seen from the script: started at once,
    its URL read when it is READY, its counts read when it exits."""

    def __init__(self, name, tmp, checkpoint, replicas, max_batch, port=0,
                 faults=None):
        self.name, self.tmp = name, tmp
        self.events = os.path.join(tmp, f"{name}.jsonl")
        self.stderr_path = os.path.join(tmp, f"{name}.stderr")
        spec = {"checkpoint": checkpoint, "replicas": replicas,
                "max_batch": max_batch, "port": port, "events": self.events}
        env = dict(os.environ, NCNET_TPU_PERF_STORE="off",
                   NCNET_TPU_MEMORY_LEDGER=os.path.join(tmp, f"{name}.ledger"))
        if faults:
            env["NCNET_TPU_FAULTS"] = json.dumps(faults)
        self._err = open(self.stderr_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"),
             "--pod-backend", json.dumps(spec)],
            stdout=subprocess.PIPE, stderr=self._err, text=True, cwd=HERE,
            env=env)
        self.url = None
        self.counts = None

    def fail(self, msg):
        with open(self.stderr_path) as f:
            tail = f.read()[-3000:]
        raise SystemExit(f"pod: backend {self.name}: {msg}\n{tail}")

    def ready(self):
        line = self.proc.stdout.readline()
        if not line:
            self.fail(f"exited with {self.proc.wait()} before READY")
        self.url = json.loads(line)["url"]
        return self.url

    def finish(self, timeout=120):
        try:
            out, _ = self.proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            self.fail("did not exit after its drain")
        self._err.close()
        if self.proc.returncode != 0:
            self.fail(f"exit code {self.proc.returncode}")
        for line in out.splitlines():
            if line.startswith('{"pod_backend"'):
                self.counts = json.loads(line)["pod_backend"]
        if self.counts is None:
            self.fail("printed no counts")
        return self.counts

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self._err.close()


def healthz(url):
    """A backend's or the router's health document (503 while draining)."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            return json.load(r)
    except urllib.error.HTTPError as e:
        return json.load(e)


def get_json(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as r:
        return json.load(r)


def wait_for(pred, what, timeout=120.0):
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            raise SystemExit(f"pod: timed out waiting for {what}")
        time.sleep(0.02)
    return time.perf_counter() - t0


class PodStream:
    """Closed-loop clients through the router's wire until stopped: each
    a ``MatchClient`` sending ``pairs`` in turn with ``POD_DEADLINE_S``;
    every outcome kept (a result's table, or the exception)."""

    def __init__(self, url, pairs, clients=POD_CLIENTS, limit=None):
        import threading

        self.outcomes = []
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._threads = [threading.Thread(
            target=self._client, args=(url, pairs, c, limit), daemon=True)
            for c in range(clients)]
        for t in self._threads:
            t.start()

    def _client(self, url, pairs, c, limit):
        from ncnet_tpu_torch.serving import MatchClient

        client = MatchClient(url, timeout_s=60.0)
        i = c
        try:
            while not self._stop.is_set() and (limit is None or i < limit):
                src, tgt = pairs[i % len(pairs)]
                t0 = time.perf_counter()
                try:
                    r = client.match(src, tgt, client=f"client{c}",
                                     budget_s=POD_DEADLINE_S)
                    out = (i, r, (time.perf_counter() - t0) * 1e3)
                except Exception as e:  # noqa: BLE001 — counted as lost
                    out = (i, e, (time.perf_counter() - t0) * 1e3)
                with self._lock:
                    self.outcomes.append(out)
                i += len(self._threads)
        finally:
            client.close()

    def count(self):
        with self._lock:
            return len(self.outcomes)

    def stop(self, wait=False):
        """Stop the clients (``wait``: let each reach its ``limit`` first)
        and return ``(outcomes, errors)``."""
        if not wait:
            self._stop.set()
        for t in self._threads:
            t.join(300 if wait else 120)
        errors = [o for _, o, _ in self.outcomes if isinstance(o, Exception)]
        return self.outcomes, errors


def router_outcomes(events):
    """The router's outcome identity from its event log: admitted, the
    terminal events by kind, and the admitted ids with no outcome."""
    import collections

    admitted = {e["request"] for e in events if e["event"] == "route_admit"}
    terminal = [e for e in events
                if e["event"] in ("route_result", "route_quarantine")
                or (e["event"] in ("route_deadline", "route_shed")
                    and e.get("admitted") is True)]
    n = collections.Counter(e["event"] for e in terminal)
    return len(admitted), n, sorted(admitted - {e["request"] for e in terminal})


def check_pod_tables(results, n_cells, where):
    """Each result a finite ``(5, n_cells)`` table with scores in [0, 1]
    and its 5 quality signals in [0, 1] up to f32 rounding (the entropy is
    normalized by a logarithm: 1 + 1e-6 at a uniform distribution)."""
    import numpy as np

    for r in results:
        t = r.table
        q = np.asarray(list((r.quality or {}).values()), np.float64)
        if t.shape != (5, n_cells) or not np.isfinite(t).all() \
                or t[4].min() < 0 or t[4].max() > 1 or q.size != 5 \
                or not np.isfinite(q).all() or q.min() < 0 \
                or q.max() > 1 + 1e-6:
            raise SystemExit(f"pod {where}: bad table {t.shape} or quality "
                             f"{r.quality}")


def scrape(url):
    import urllib.request

    from ncnet_tpu_torch.observability.export import parse_prometheus

    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        return parse_prometheus(r.read().decode("utf-8"))


def monotone(f1, f2):
    """Counters of the first scrape that fell by the second."""
    bad = []
    for name, fam in f1.items():
        if fam["type"] != "counter":
            continue
        later = {(n, tuple(sorted(lb.items()))): v
                 for n, lb, v in f2.get(name, {}).get("samples", [])}
        for n, lb, v in fam["samples"]:
            key = (n, tuple(sorted(lb.items())))
            if later.get(key, v) < v:
                bad.append((key, v, later.get(key)))
    return bad


def rollout(url, candidate, **knobs):
    """A rollout through the port's operator tool (``tools/rollout.py``:
    ``post_rollout``, then ``watch`` to the terminal phase, which prints
    each transition); returns (status, wall s)."""
    from ncnet_tpu_torch.tools import rollout as tool

    t0 = time.perf_counter()
    code, doc = tool.post_rollout(url, candidate, knobs, timeout=30.0)
    if code != 202:
        raise SystemExit(f"pod: POST /rollout answered {code}: {doc}")
    st = tool.watch(url, 0.05, 180.0)
    if st is None or (st.get("phase") != "IDLE" and st.get(
            "new_version") != os.path.basename(candidate)):
        raise SystemExit(f"pod: rollout to {candidate} ended in {st}")
    return st, time.perf_counter() - t0


def pod_phase(torch, params):
    """Phase N: the network plane on the card.  Two backend processes with
    phase S's model and weights (written here as a native checkpoint and
    loaded through ``load_params``) behind the port's ``MatchRouter`` in
    this process: traffic over the wire, a bitwise check of backend B's
    pairs against a direct batch-1 dispatch here, a SIGKILL of B and its
    restart at the same port, a SIGTERM drain of B, three rollouts on A
    over ``POST /rollout`` (promoted, rolled back by the canary's quality
    gate, refused for a flipped payload), and ``/metrics`` scrapes.
    Returns the backends' launches (those of processes that exited after a
    drain; the SIGKILLed one cannot report)."""
    import tempfile

    import numpy as np

    from ncnet_tpu_torch.models.checkpoint import load_params, save_params
    from ncnet_tpu_torch.observability import EventLog
    from ncnet_tpu_torch.observability import events as obs_events
    from ncnet_tpu_torch.serving import (BatchMatchEngine, MatchRouter,
                                         RouterConfig, pad_to_bucket)
    from ncnet_tpu_torch.serving.introspect import scrape_wall_ms

    t_phase = time.perf_counter()
    cfg = pod_model_config()
    side = C2F_SIDE
    n_cells = (side // 16) ** 2
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pod_")
    base = os.path.join(tmp, "base")
    save_params(base, cfg, params)
    plan = {"canary_quality_shift": POD_SHIFT,
            "canary_shift_version": "step_000002",
            "corrupt_candidate_checkpoint": "step_000003"}
    backends = {"A": PodBackend("A", tmp, base, POD_A_REPLICAS,
                                SERVICE_BATCH, faults=plan),
                "B": PodBackend("B", tmp, base, 1, 1)}
    router = log = prev_sink = None
    streams = []
    try:
        # while the backends start: the candidates (seed-1 weights as
        # step_000001; step_000002 and step_000003 the same files) and
        # this process's engine for the bitwise check
        cands = os.path.join(tmp, "candidates")
        cand_params = serving_params(torch, cfg, torch.device("cuda", 0),
                                     side, seed=1)
        save_params(os.path.join(cands, "step_000001"), cfg, cand_params)
        del cand_params
        for v in ("step_000002", "step_000003"):
            shutil.copytree(os.path.join(cands, "step_000001"),
                            os.path.join(cands, v))
        engine = BatchMatchEngine(*load_params(base, cfg))
        for b in backends.values():
            b.ready()
        print(f"pod: backends ready after {time.perf_counter() - t_phase:.1f} s "
              f"(A: {POD_A_REPLICAS} replicas, max_batch {SERVICE_BATCH}; B: 1 "
              f"replica, max_batch 1; each warmed its ladder on the card); "
              f"{card_line()}", flush=True)

        router_log = os.path.join(tmp, "router.jsonl")
        log = EventLog(router_log)
        prev_sink = obs_events.set_global_sink(log)
        router = MatchRouter([backends["A"].url, backends["B"].url],
                             RouterConfig(
            introspect_port=0, probe_period_s=0.1, resurrect_after_s=0.5,
            backend_max_failures=2, retries=1, request_timeout_s=30.0,
            # one wire request in flight a backend: two clients keep both
            # backends busy, so B serves pairs and holds one when killed
            per_backend_depth=1, max_queue=256,
            max_in_flight_per_client=256)).start()
        rurl = router.introspect_url
        bid = {b.url: b.id for b in router.backends}
        id_a, id_b = bid[backends["A"].url], bid[backends["B"].url]

        # 2. 24 raw pairs from 2 clients through the router
        pairs = service_requests(23, POD_REQUESTS)
        outs, errors = PodStream(rurl, pairs, limit=POD_REQUESTS).stop(
            wait=True)
        if errors or len(outs) != POD_REQUESTS:
            raise SystemExit(f"pod: {len(errors)} of {len(outs)} requests "
                             f"failed: {errors[:3]!r}")
        results = {r.request_id: (i, r, ms) for i, r, ms in outs}
        check_pod_tables([r for _, r, _ in results.values()], n_cells,
                         "traffic")
        walls = [ms for _, _, ms in results.values()]
        _, ev = obs_events.replay_events(router_log)
        served = {e["request"]: e for e in ev if e["event"] == "route_result"}
        overhead = [e["wall_ms"] - e["backend_wall_ms"] for e in served.values()]
        on_b = [rid for rid, e in served.items()
                if rid in results and e["backend"] == id_b]
        print(f"pod: {POD_REQUESTS} pairs through the router: wire walls ms "
              f"p50 {percentile(walls, 50):.1f} p95 {percentile(walls, 95):.1f};"
              f" router overhead (route wall - backend serve wall) ms p50 "
              f"{percentile(overhead, 50):.2f} p95 {percentile(overhead, 95):.2f};"
              f" served by A {sum(e['backend'] == id_a for e in served.values())},"
              f" by B {len(on_b)}; {card_line()}", flush=True)
        if not on_b:
            raise SystemExit("pod: backend B served no pair")
        unequal = []
        for rid in on_b:
            i, r, _ = results[rid]
            src, tgt = pairs[i]
            direct = engine.split(engine.fetch(engine.dispatch(
                pad_to_bucket([src], (side, side)),
                pad_to_bucket([tgt], (side, side)))))[0][0]
            if not np.array_equal(direct, r.table):
                unequal.append((rid, float(np.abs(direct - r.table).max())))
        print(f"pod: B's {len(on_b)} pairs against a direct batch-1 dispatch "
              f"in this process: {len(on_b) - len(unequal)} bit-equal "
              f"{unequal[:4]}", flush=True)
        if unequal:
            raise SystemExit("pod: a pair B served differs from the direct "
                             "dispatch")
        del engine

        # 3. SIGKILL B mid-stream, restart it at the same port
        b_port = int(backends["B"].url.rsplit(":", 1)[1])
        victim = next(b for b in router.backends if b.id == id_b)
        s = PodStream(rurl, pairs)
        streams.append(s)
        wait_for(lambda: victim.inflight > 0, "B to hold requests")
        t_kill = obs_events.wall_now()
        backends["B"].kill()
        wait_for(lambda: victim.state == "DEAD", "B DEAD in the router")
        t_dead = obs_events.wall_now()
        backends["B2"] = PodBackend("B2", tmp, base, 1, 1, port=b_port)
        backends["B2"].ready()
        t_up = obs_events.wall_now()
        wait_for(lambda: victim.state == "READY", "B resurrected")
        t_back = obs_events.wall_now()
        n_before = s.count()
        wait_for(lambda: s.count() > n_before + 4, "traffic after B's return")
        streams.pop()
        outs, errors = s.stop()
        _, ev = obs_events.replay_events(router_log)
        reroutes = [e for e in ev if e["event"] == "retry"
                    and e.get("scope") == "router" and e.get("via") == "reroute"]
        moved = [e for e in ev if e["event"] == "route_backend"
                 and e.get("backend") == id_b]
        print(f"pod: SIGKILL of B under a stream: {len(outs)} requests, "
              f"{len(errors)} failed; {len(reroutes)} re-routed, on_budget "
              f"{sorted({e['on_budget'] for e in reroutes})}; B DEAD "
              f"{(t_dead - t_kill) * 1e3:.1f} ms after the kill; restarted at "
              f"port {b_port}, READY in its process "
              f"{t_up - t_kill:.1f} s after the kill, resurrected by the "
              f"router's probes {(t_back - t_up) * 1e3:.1f} ms after that; "
              f"B's states {[e['state'] for e in moved]}; {card_line()}",
              flush=True)
        if errors or not reroutes or any(e["on_budget"] for e in reroutes) \
                or [e["state"] for e in moved][-2:] != ["DEAD", "READY"]:
            raise SystemExit("pod: the failover lost a request, charged a "
                             "budget, or B was not DEAD then READY")

        # 4. SIGTERM B while it holds admitted work: demoted before its
        # drain completes, no edge error
        admitted0 = healthz(backends["B2"].url)["counters"]["admitted"]
        held = PodStream(backends["B2"].url, pairs[:POD_HELD],
                         clients=POD_HELD, limit=POD_HELD)
        wait_for(lambda: healthz(backends["B2"].url)["counters"]["admitted"]
                 >= admitted0 + POD_HELD, "B to admit the held requests")
        s = PodStream(rurl, pairs)
        streams.append(s)
        t_term = obs_events.wall_now()
        backends["B2"].proc.send_signal(signal.SIGTERM)
        b_counts = backends["B2"].finish()
        wait_for(lambda: victim.state == "DEAD", "B DEAD after its drain")
        held_outs, held_errors = held.stop(wait=True)
        streams.pop()
        outs, errors = s.stop()
        _, ev = obs_events.replay_events(router_log)
        _, bev = obs_events.replay_events(backends["B2"].events)
        drain_t = [e["t"] for e in bev if e["event"] == "serve_drain"]
        states = [(e["state"], e["t"]) for e in ev
                  if e["event"] == "route_backend" and e.get("backend") == id_b
                  and e["t"] >= t_term]
        demoted = [t for st, t in states if st == "DRAINING"]
        print(f"pod: SIGTERM of B with {POD_HELD} held requests: held "
              f"{len(held_outs) - len(held_errors)} results; router stream "
              f"{len(outs)} requests, {len(errors)} failed; B's states "
              f"{[st for st, _ in states]}, DRAINING "
              f"{(demoted[0] - t_term) * 1e3 if demoted else float('nan'):.1f} "
              f"ms after the signal, its drain done "
              f"{(drain_t[0] - t_term) * 1e3 if drain_t else float('nan'):.1f} "
              f"ms after it; B's launches {b_counts}", flush=True)
        if held_errors or len(held_outs) != POD_HELD or errors \
                or not demoted or not drain_t \
                or demoted[0] >= drain_t[0]:
            rel = lambda t: round((t - t_term) * 1e3, 1)  # noqa: E731
            print(f"pod: B's events after the signal, ms: router "
                  f"{[(e['event'], e.get('state'), e.get('ok'), rel(e['t'])) for e in ev if e.get('backend') == id_b and e['t'] >= t_term - 1]}"
                  f"; B {[(e['event'], e.get('state'), e.get('reason'), rel(e['t'])) for e in bev if e['event'] in ('serve_health', 'serve_drain', 'serve_start')]}",
                  flush=True)
            raise SystemExit("pod: the drain lost a request or B was not "
                             "demoted before its drain completed")

        # 5. three rollouts on A under a stream of one repeated pair, and 6.
        # scrapes of the router and A under that load
        aurl = backends["A"].url
        one = [pairs[0]]
        s = PodStream(rurl, one)
        streams.append(s)
        wait_for(lambda: s.count() >= 4, "the rollout stream")
        r1, a1 = scrape(rurl), scrape(aurl)
        v0 = healthz(aurl)["model_version"]
        st1, w1 = rollout(aurl, os.path.join(cands, "step_000001"),
                          canary_fraction=0.5, canary_min_results=0,
                          drain_timeout_s=60.0)
        v1 = healthz(aurl)["model_version"]
        a2 = scrape(aurl)
        st2, w2 = rollout(aurl, os.path.join(cands, "step_000002"),
                          canary_fraction=0.5,
                          canary_min_results=POD_CANARY_MIN,
                          canary_timeout_s=120.0, drain_timeout_s=60.0)
        st3, w3 = rollout(aurl, os.path.join(cands, "step_000003"))
        v3 = healthz(aurl)["model_version"]
        r2, a3 = scrape(rurl), scrape(aurl)
        router_scrape_ms = scrape_wall_ms(rurl, n=5)
        backend_scrape_ms = scrape_wall_ms(aurl, n=5)
        streams.pop()
        outs, errors = s.stop()
        check_pod_tables([r for _, r, _ in outs if not isinstance(r, Exception)],
                         n_cells, "rollout stream")
        ver_lat = {lb.get("model_version"): v for n, lb, v in
                   a3["ncnet_serve_version_latency_ms"]["samples"]
                   if n.endswith("_count")}
        bad = monotone(r1, r2) + monotone(a1, a2) + monotone(a2, a3)
        print(f"pod: rollouts on A under a stream of {len(outs)} requests "
              f"({len(errors)} failed): {v0} -> step_000001 "
              f"{st1['phase']} in {w1:.2f} s (/healthz model_version {v1}); "
              f"step_000002 {st2['phase']} ({st2['reason']}, psi "
              f"{(st2.get('verdict') or {}).get('psi')}) in {w2:.2f} s; "
              f"step_000003 {st3['phase']} ({st3['reason']}) in {w3:.2f} s; "
              f"model_version after {v3}; per-version latency counts on "
              f"/metrics {ver_lat}; {card_line()}", flush=True)
        print(f"pod: /metrics scrapes under load: router "
              f"{len(r2)} families, A {len(a3)}; counters that fell {bad}; "
              f"scrape_wall_ms router {router_scrape_ms:.2f}, A "
              f"{backend_scrape_ms:.2f}; {card_line()}", flush=True)
        if (errors or st1["phase"] != "COMPLETE" or v1 != "step_000001"
                or st2["phase"] != "ROLLED_BACK"
                or not (st2["reason"] or "").startswith("quality_drift")
                or st3["phase"] != "IDLE"
                or st3["reason"] != "refused:payload_sha_mismatch"
                or v3 != "step_000001" or bad
                or not {v0, "step_000001"} <= set(ver_lat)):
            raise SystemExit("pod: a rollout did not end as it should, lost "
                             "a request, or a scrape failed")

        # phase O's live half: serve_top and the watchdog on A's plane
        live_plane_tools(rurl, aurl)

        # the end: the router drains, A drains and reports
        router.request_drain("phase N done")
        wait_for(lambda: router.state == "STOPPED", "the router's drain")
        backends["A"].proc.send_signal(signal.SIGTERM)
        a_counts = backends["A"].finish()
    finally:
        for s in streams:
            s.stop()
        if router is not None:
            router.stop(drain=False)
        if log is not None:
            obs_events.set_global_sink(prev_sink)
            log.close()
        for b in backends.values():
            if b.proc.poll() is None:
                b.kill()
    _, ev = obs_events.replay_events(router_log)
    admitted, n, lost = router_outcomes(ev)
    _, aev = obs_events.replay_events(backends["A"].events)
    phases = [(e["phase"], e["t"]) for e in aev if e["event"] == "rollout_phase"]
    phase_walls = [(p, round((t2 - t1) * 1e3, 1)) for (p, t1), (_, t2)
                   in zip(phases, phases[1:]) if p not in ("COMPLETE",
                                                          "ROLLED_BACK")]
    swaps = [(e["replica"], e["version"], e.get("swap_ms"), e.get("warm_ms"))
             for e in aev if e["event"] == "rollout_swap"]
    launches = {k: a_counts[k] + b_counts[k]
                for k in ("nc_conv4d_bf16", "gather_tile_corr_bf16")}
    per = {name: c for name, c in (("A", a_counts), ("B", b_counts))}
    print(f"pod: router event log: admitted {admitted} == results "
          f"{n['route_result']} + deadlines {n['route_deadline']} + "
          f"quarantines {n['route_quarantine']} + admitted sheds "
          f"{n['route_shed']}; lost {lost}; A's rollout phases "
          f"{[p for p, _ in phases]}, phase walls ms {phase_walls}; swaps "
          f"(replica, version, swap ms, re-warm ms) {swaps}; launches {per}; "
          f"phase {time.perf_counter() - t_phase:.1f} s; {card_line()}",
          flush=True)
    if admitted != sum(n.values()) or lost or n["route_result"] != admitted:
        raise SystemExit("pod: the router's outcome identity failed")
    for name, c in per.items():
        if not c["dispatches"] or c["nc_conv4d_bf16"] != 6 * c["dispatches"] \
                or c["gather_tile_corr_bf16"] != 2 * c["dispatches"]:
            raise SystemExit(f"pod: backend {name}'s launches {c} are not 6 "
                             "B6 and 2 B8 a dispatch")
    leave("N", {"admitted": admitted, "results": n["route_result"],
                "terminals": sum(n.values()), "lost": len(lost)},
          router=router_log, A=backends["A"].events, B=backends["B"].events)
    shutil.rmtree(tmp)
    return launches


def serve_fp32(torch, nc_fused_lane, conv4d_pallas, dev):
    """Phase D: fp32 serving at full width, ``FP32_SIDES``: 400² (the FFT
    tier) and 800² (per layer: tapfold, unroll, B5, two sequential
    symmetric passes).
    Returns the B5 launches by side and the largest B5 error on the path."""
    import numpy as np

    from ncnet_tpu_torch.config import ModelConfig
    from ncnet_tpu_torch.models import ncnet as ncnet_mod
    from ncnet_tpu_torch.models.ncnet import init_ncnet, ncnet_forward, params_to
    from ncnet_tpu_torch.ops.image import normalize_imagenet
    from ncnet_tpu_torch.serving.engine import BatchMatchEngine

    cfg = ModelConfig(backbone="resnet101", ncons_kernel_sizes=(5, 5, 5),
                      ncons_channels=(16, 16, 1))
    params = params_to(init_ncnet(cfg, seed=0), dev)
    engine = BatchMatchEngine(cfg, params)
    rng = np.random.default_rng(4)
    b5_by_side, b5_err = {}, 0.0
    for side in FP32_SIDES:
        shape = (SERVE_BATCH, side, side, 3)
        requests = [(rng.integers(0, 256, shape, dtype=np.uint8),
                     rng.integers(0, 256, shape, dtype=np.uint8))
                    for _ in range(SERVE_REQUESTS + 1)]
        engine.fetch(engine.dispatch(*requests[-1]))  # warm-up, not counted
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        nc_fused_lane.launches = 0
        conv4d_pallas.launches_by_kernel.update(tensor_core=0, cuda_core=0)
        walls, tables = [], []
        for src, tgt in requests[:SERVE_REQUESTS]:
            t0 = time.perf_counter()
            tables.append(engine.fetch(engine.dispatch(src, tgt)))
            walls.append((time.perf_counter() - t0) * 1e3)
        launches = {"nc_conv4d_bf16": nc_fused_lane.launches,
                    "conv4d_small_cout": conv4d_pallas.launches}
        b5_kernels = dict(conv4d_pallas.launches_by_kernel)
        tier = nc_fused_lane.last_selected_tier()
        peak = torch.cuda.max_memory_allocated()
        where = f"fp32 serve {side}"
        print(f"{where}: {SERVE_REQUESTS} requests of {SERVE_BATCH} pairs at "
              f"{side}x{side}, wall ms per request {walls}, peak memory {peak} "
              f"bytes, NC stack tier {tier!r}, launches {launches}, B5 by "
              f"kernel {b5_kernels}", flush=True)
        check_tables(tables, (side // 16) ** 2, where)
        fft_side = side == FP32_SIDES[0]
        n_b5 = 0 if fft_side else 2 * SERVE_REQUESTS
        want_tier = "fft" if fft_side else "xla"
        if launches != {"nc_conv4d_bf16": 0, "conv4d_small_cout": n_b5} \
                or b5_kernels != {"tensor_core": n_b5, "cuda_core": 0} \
                or tier != want_tier:
            raise SystemExit(f"{where}: expected the {want_tier!r} tier, no B2 "
                             f"launch and {n_b5} B5 launches, all on the "
                             "tensor-core kernel")
        b5_by_side[f"serve_fp32_{side}"] = launches["conv4d_small_cout"]

        # one request again with its FFT or B5 calls recorded, each held
        # against its plain version; the filtered volume against the same
        # forward with the plain versions routed in
        src, tgt = (normalize_imagenet(torch.as_tensor(a).to(dev))
                    for a in requests[0])
        calls = []
        if fft_side:
            module, name, plain = ncnet_mod, "nc_stack_fft", plain_stack
        else:
            module, name = conv4d_pallas, "conv4d_small_cout_cuda"
            plain = conv4d_pallas.conv4d_small_cout_reference
        with torch.no_grad():
            with routed(module, name, getattr(module, name), calls):
                got = ncnet_forward(cfg, engine._params, src, tgt).corr
            with routed(module, name, plain):
                want = ncnet_forward(cfg, engine._params, src, tgt).corr
        torch.cuda.synchronize()
        if fft_side:
            check_fft_calls(calls, where)
        else:
            if len(calls) != 2:
                raise SystemExit(f"{where}: {len(calls)} B5 calls in one "
                                 "forward, expected 2")
            for i, ((x, w), _, y) in enumerate(calls):
                with torch.no_grad():
                    ref = conv4d_pallas.conv4d_small_cout_reference(x, w)
                err = normalized_err(y, ref)
                b5_err = max(b5_err, float((y - ref).abs().max()))
                print(f"{where}: B5 launch {i} on the path's input "
                      f"{tuple(x.shape)} {x.dtype}: kernel vs twin normalized "
                      f"error {err:.3e} (tolerance "
                      f"{B5_TOLERANCE['float32']:.1e})", flush=True)
                if not err <= B5_TOLERANCE["float32"]:
                    raise SystemExit(f"{where}: B5 disagrees with its twin on "
                                     "the path")
        err = normalized_err(got, want)
        print(f"{where}: filtered volume {tuple(got.shape)} vs the plain path "
              f"normalized error {err:.3e} (tolerance {FP32_TOLERANCE})",
              flush=True)
        if not err <= FP32_TOLERANCE:
            raise SystemExit(f"{where}: the filtered volume disagrees with the "
                             "plain path")
        if not fft_side:
            fp32_stages(torch, cfg, engine._params, src, tgt)
    return b5_by_side, b5_err


def fp32_stages(torch, cfg, params, src, tgt):
    """CUDA-event ms of each stage of one fp32 800² request, and of each NC
    layer of one symmetric pass (warm, one at a time)."""
    from ncnet_tpu_torch.models.ncnet import extract_features, ncnet_filter
    from ncnet_tpu_torch.observability.quality import append_quality_rows
    from ncnet_tpu_torch.ops.conv4d import conv4d
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import corr_to_matches, mutual_matching

    nc = params["nc"]

    def trunk():
        return (extract_features(cfg, params, src),
                extract_features(cfg, params, tgt))

    def tables(corr):
        m = corr_to_matches(corr, do_softmax=True)
        return append_quality_rows(
            torch.stack([v.to(torch.float32) for v in m], dim=1), corr)

    with torch.no_grad():
        fa, fb = trunk()
        corr = correlation_4d(fa, fb)
        filtered = ncnet_filter(cfg, params, corr).corr
        x = mutual_matching(corr)[..., None]
        h1 = torch.relu(conv4d(x, nc[0]["w"], nc[0]["b"]))
        h2 = torch.relu(conv4d(h1, nc[1]["w"], nc[1]["b"]))
        stages = {
            "trunk, both sides (fp32)": cuda_ms(trunk, 2),
            "correlation": cuda_ms(lambda: correlation_4d(fa, fb), 2),
            "filter (mutual, NC stack: 2 passes, mutual)": cuda_ms(
                lambda: ncnet_filter(cfg, params, corr), 1),
            "of which, per pass, layer 1 (1->16, tapfold)": cuda_ms(
                lambda: conv4d(x, nc[0]["w"], nc[0]["b"]), 2),
            "of which, per pass, layer 2 (16->16, unroll)": cuda_ms(
                lambda: conv4d(h1, nc[1]["w"], nc[1]["b"]), 1),
            "of which, per pass, layer 3 (16->1, B5)": cuda_ms(
                lambda: conv4d(h2, nc[2]["w"], nc[2]["b"]), 2),
            "matches and quality row": cuda_ms(lambda: tables(filtered), 2),
        }
    print(f"fp32 serve stages ms per request ({FP32_SIDES[-1]}x"
          f"{FP32_SIDES[-1]}, B={SERVE_BATCH}): " + json.dumps(stages),
          flush=True)


def eval_batches(seed, n, shift):
    """``n`` PF-Pascal-style batches at ``EVAL_SIDE``: seeded uint8 images
    of ``EVAL_SOURCE_HW`` through the host resize and ``quantize_u8``, each
    target its source rolled by ``shift`` (y, x) pixels; 20 keypoint slots,
    8 to 20 valid with the −1 padding a suffix, target points the source
    points plus the shift (inside the image); ``L_pck`` the longer side of
    the valid source points' bounding box (the dataset's 'pf' procedure)."""
    import numpy as np

    from ncnet_tpu_torch.ops.image import (
        quantize_u8,
        resize_bilinear_align_corners_np,
    )

    rng = np.random.default_rng(seed)
    dy, dx = shift
    out = []
    for _ in range(n):
        src = np.stack([quantize_u8(resize_bilinear_align_corners_np(
            rng.uniform(0, 255, EVAL_SOURCE_HW + (3,)).astype(np.float32),
            EVAL_SIDE, EVAL_SIDE)) for _ in range(SERVE_BATCH)])
        points = np.full((2, SERVE_BATCH, 2, 20), -1, np.float32)
        l_pck = np.ones((SERVE_BATCH, 1), np.float32)
        for i in range(SERVE_BATCH):
            n_valid = int(rng.integers(8, 21))
            x = rng.uniform(1, EVAL_SIDE - dx, n_valid).astype(np.float32)
            y = rng.uniform(1, EVAL_SIDE - dy, n_valid).astype(np.float32)
            points[0, i, :, :n_valid] = (x, y)
            points[1, i, :, :n_valid] = (x + dx, y + dy)
            l_pck[i, 0] = max(np.ptp(x), np.ptp(y))
        size = np.tile(np.float32([EVAL_SIDE, EVAL_SIDE, 3]), (SERVE_BATCH, 1))
        out.append({"source_image": src,
                    "target_image": np.roll(src, shift, axis=(1, 2)),
                    "source_points": points[0], "target_points": points[1],
                    "source_im_size": size, "target_im_size": size,
                    "L_pck": l_pck})
    return out


def eval_phase(torch, nc_fused_lane, dev):
    """Phase E: the PF-Pascal eval step (``make_eval_step``) at full width
    under the observability core; returns its B2 launches."""
    import tempfile

    import numpy as np

    from ncnet_tpu_torch.config import ModelConfig
    from ncnet_tpu_torch.evaluation import pf_pascal
    from ncnet_tpu_torch.evaluation.pck import pck_metric
    from ncnet_tpu_torch.models.ncnet import NCNet
    from ncnet_tpu_torch.observability import events, tracing
    from ncnet_tpu_torch.observability.metrics import MetricsRegistry
    from ncnet_tpu_torch.observability.quality import quality_table
    from ncnet_tpu_torch.ops.matching import corr_to_matches

    cfg = ModelConfig(backbone="resnet101", ncons_kernel_sizes=(5, 5, 5),
                      ncons_channels=(16, 16, 1), half_precision=True,
                      backbone_bf16=True)
    net = NCNet(cfg, serving_params(torch, cfg, dev, EVAL_SIDE), device=dev)
    step = pf_pascal.make_eval_step(net, EVAL_ALPHA, device_normalize=True)
    host = eval_batches(seed=4, n=EVAL_BATCHES + 1, shift=TRAIN_SHIFT)
    batches = [{k: torch.as_tensor(v).to(dev) for k, v in b.items()}
               for b in host]

    registry = MetricsRegistry(scope="eval_phase")
    timer = registry.timer("eval_batch")
    walls, tables = [], []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "events.jsonl")
        with events.EventLog(path) as log, events.bound(log):
            with tracing.span("eval_phase") as root:
                for i, batch in enumerate(batches):  # batch 0: the warm-up
                    if i == 1:
                        torch.cuda.synchronize()
                        nc_fused_lane.launches = 0
                    with tracing.span("eval_batch", batch=i), timer:
                        tables.append(step(net.params, batch).cpu())
                    walls.append(timer.last_s * 1e3)
                    registry.flush(event="eval_batch", batch=i)
        launches = nc_fused_lane.launches
        tier = nc_fused_lane.last_selected_tier()
        _, replayed = events.replay_events(path)
    spans = [e for e in replayed if e["event"] == "span"
             and e["name"] == "eval_batch"]
    begins = [e for e in spans if e["ph"] == "B"]
    batch_events = [e for e in replayed if e["event"] == "eval_batch"]
    print(f"eval: the PF-Pascal eval step, {EVAL_BATCHES} batches of "
          f"{SERVE_BATCH} pairs at {EVAL_SIDE}x{EVAL_SIDE} (after a warm-up), "
          f"wall ms per batch {walls[1:]} (warm-up {walls[0]:.1f}), NC stack "
          f"tier {tier!r}, B2 launches {launches}; the event log replays "
          f"{len(batch_events)} eval_batch events and {len(begins)} spans",
          flush=True)
    if launches != 0 or tier != "fft":
        raise SystemExit(f"eval: expected the fft tier and no B2 launch, got "
                         f"{tier!r} and {launches}")
    if (len(batch_events), len(begins), len(spans)) != (len(batches),) * 2 + (
            2 * len(batches),) or any(e["parent"] != root._id for e in begins):
        raise SystemExit("eval: the replayed log does not hold one event and "
                         "one closed span a batch under the phase's root span")
    if batch_events[-1]["metrics"]["eval_batch"]["count"] != len(batches):
        raise SystemExit("eval: the timer did not count every batch")
    for t in tables:
        if (t.shape != (SERVE_BATCH, len(pf_pascal.RESULT_COLUMNS))
                or not torch.isfinite(t).all()
                or t[:, 0].min() < 0 or t[:, 0].max() > 1):
            raise SystemExit(f"eval: bad table {tuple(t.shape)}: {t}")

    # the device resize on the card against the CPU's, on seeded images of
    # the eval batches' source size
    from ncnet_tpu_torch.ops.image import resize_bilinear_align_corners

    raw = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 255, (SERVE_BATCH,) + EVAL_SOURCE_HW + (3,)).astype(np.float32))
    want = resize_bilinear_align_corners(raw, EVAL_SIDE, EVAL_SIDE)
    got = resize_bilinear_align_corners(raw.to(dev), EVAL_SIDE, EVAL_SIDE)
    resize_err = float((got.cpu() - want).abs().max() / raw.abs().max())
    print(f"eval: resize_bilinear_align_corners {tuple(raw.shape)} -> "
          f"{EVAL_SIDE}x{EVAL_SIDE} on the card vs the CPU: max|diff| / "
          f"max|image| {resize_err:.3e} (tolerance {RESIZE_TOLERANCE})",
          flush=True)
    if got.dtype != torch.float32 or not resize_err <= RESIZE_TOLERANCE:
        raise SystemExit("eval: the device resize on the card is not full f32")

    # one batch again with the forward recorded: its quality columns against
    # quality_table on the same volume, and its PCK against pck_metric run
    # on the CPU on that volume copied to the host
    calls = []
    with routed(pf_pascal, "ncnet_forward", pf_pascal.ncnet_forward, calls):
        table = step(net.params, batches[1]).cpu()
    out = calls[0][2]
    with torch.no_grad():
        quality = quality_table(out.corr).cpu()
    corr = out.corr.cpu()
    cpu_batch = {k: torch.as_tensor(v) for k, v in host[1].items()}
    pck_cpu = pck_metric(cpu_batch, corr_to_matches(corr, do_softmax=True),
                         EVAL_ALPHA)
    n_valid = (cpu_batch["source_points"][:, 0] != -1).sum(dim=1)
    keypoints_off = ((table[:, 0] - pck_cpu).abs() * n_valid).round()
    print(f"eval: batch 1 again: PCK on the card {table[:, 0].tolist()}, "
          f"pck_metric on the CPU {pck_cpu.tolist()} (keypoints apart "
          f"{keypoints_off.tolist()} of {n_valid.tolist()}); quality columns "
          f"vs quality_table on the same volume: max difference "
          f"{float((table[:, 1:] - quality).abs().max()):.3e}", flush=True)
    if not torch.equal(table[:, 1:], quality):
        raise SystemExit("eval: the quality columns differ from quality_table "
                         "on the step's own volume")
    if keypoints_off.max() > 1:
        raise SystemExit("eval: PCK on the card and pck_metric on the CPU "
                         "differ by more than one keypoint")
    pck = torch.cat([t[:, 0] for t in tables[1:]])
    print(f"eval: PCK@{EVAL_ALPHA} on the shifted pairs (shift recovery; "
          f"printed, not gated): mean {float(pck.mean()):.4f}, per pair "
          f"{[round(v, 4) for v in pck.tolist()]}; ms per batch mean "
          f"{np.mean(walls[1:]):.2f}", flush=True)
    return launches


def serve_reloc(torch, nc_fused_lane, dev):
    """Phase R: relocalized dense serving at full width; returns its B2
    launches."""
    import numpy as np

    from ncnet_tpu_torch.config import ModelConfig
    from ncnet_tpu_torch.models import ncnet as ncnet_mod
    from ncnet_tpu_torch.models.ncnet import make_point_matcher, ncnet_forward
    from ncnet_tpu_torch.ops.image import normalize_imagenet
    from ncnet_tpu_torch.ops.matching import _grid
    from ncnet_tpu_torch.ops.pooling import maxpool4d_with_argmax
    from ncnet_tpu_torch.serving.engine import BatchMatchEngine

    cfg = ModelConfig(backbone="resnet101", ncons_kernel_sizes=(5, 5, 5),
                      ncons_channels=(16, 16, 1), half_precision=True,
                      backbone_bf16=True, relocalization_k_size=RELOC_K)
    params = serving_params(torch, cfg, dev, RELOC_SIDE)
    engine = BatchMatchEngine(cfg, params)
    requests = c2f_requests(seed=2, shift=TRAIN_SHIFT, side=RELOC_SIDE)
    fine_side = RELOC_SIDE // 16
    n_cells = (fine_side // RELOC_K) ** 2

    engine.fetch(engine.dispatch(*requests[-1]))  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nc_fused_lane.launches = 0
    walls, tables = [], []
    for src, tgt in requests[:RELOC_REQUESTS]:
        t0 = time.perf_counter()
        tables.append(engine.fetch(engine.dispatch(src, tgt)))
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = nc_fused_lane.launches
    tier = nc_fused_lane.last_selected_tier()
    peak = torch.cuda.max_memory_allocated()
    print(f"reloc serve: {RELOC_REQUESTS} requests of {SERVE_BATCH} pairs at "
          f"{RELOC_SIDE}x{RELOC_SIDE}, relocalization k={RELOC_K} ("
          f"{fine_side}^4 pooled to {fine_side // RELOC_K}^4), wall ms per "
          f"request {walls}, peak memory {peak} bytes, NC stack tier "
          f"{tier!r}, B2 launches {launches}", flush=True)
    check_tables(tables, n_cells, "reloc serve")
    if launches != 3 * RELOC_REQUESTS or tier != "resident":
        raise SystemExit(f"reloc serve: expected the resident tier and "
                         f"{3 * RELOC_REQUESTS} B2 launches")
    grid = _grid(-1.0, fine_side, "cpu").numpy()
    if not all(np.isin(t[:, :4], grid).all() for t in tables):
        raise SystemExit("reloc serve: match coordinates off the fine grid")

    # one request again with the pooling and the NC stack recorded: the
    # pooling against the CPU pooling on the same volume, bit for bit; B2
    # against its twin on the path's exact input, and twice bit-identical
    src, tgt = (normalize_imagenet(torch.as_tensor(a).to(dev))
                for a in requests[0])
    p_calls, s_calls = [], []
    with torch.no_grad(), \
            routed(ncnet_mod, "maxpool4d_with_argmax",
                   ncnet_mod.maxpool4d_with_argmax, p_calls), \
            routed(nc_fused_lane, "nc_stack_resident",
                   nc_fused_lane.nc_stack_resident, s_calls):
        ncnet_forward(cfg, engine._params, src, tgt)
    if (len(p_calls), len(s_calls)) != (1, 1):
        raise SystemExit(f"reloc serve: {len(p_calls)} poolings and "
                         f"{len(s_calls)} NC stack calls in one forward")
    (vol, k), _, (pooled, deltas) = p_calls[0]
    want, want_d = maxpool4d_with_argmax(vol.cpu(), k)
    pool_ok = torch.equal(pooled.cpu(), want) and all(
        torch.equal(d.cpu(), w) for d, w in zip(deltas, want_d))
    moved = sum(int(d.count_nonzero()) for d in deltas)
    (nc, x), _, y = s_calls[0]
    with torch.no_grad():
        err = normalized_err(y, nc_fused_lane.nc_stack_reference(nc, x))
        again = torch.equal(y, nc_fused_lane.nc_stack_resident(nc, x))
    print(f"reloc serve: pooling of the path's {vol.dtype} volume "
          f"{tuple(vol.shape)} vs maxpool4d_with_argmax on the CPU: "
          f"{'bit-equal' if pool_ok else 'DIFFERENT'}, {moved} nonzero "
          f"offsets; NC stack on {tuple(x.shape)} vs its twin: normalized "
          f"{err:.3e} (tolerance {TOLERANCE}), two launches bit-identical: "
          f"{again}", flush=True)
    if not pool_ok or moved == 0:
        raise SystemExit("reloc serve: the pooling differs from the CPU's or "
                         "moved no match off the pooled grid")
    if not err <= TOLERANCE or not again:
        raise SystemExit("reloc serve: the NC kernel disagrees with its twin "
                         "or is not deterministic")

    # the point matcher on the first pair, against the engine on that pair
    # alone (the same batch-1 program), then against row 0 of the request
    matcher = make_point_matcher(cfg, engine._params)
    m, q = matcher.match_with_quality(requests[0][0][:1], requests[0][1][:1])
    got = np.concatenate(m)
    single, single_q = engine.split(engine.fetch(engine.dispatch(
        requests[0][0][:1], requests[0][1][:1])))
    print(f"reloc serve: point matcher on pair 0 vs the engine on that pair "
          f"alone: {'equal' if np.array_equal(got, single[0]) else 'DIFFERENT'}"
          f"; quality {q}", flush=True)
    if not np.array_equal(got, single[0]) or q != single_q[0]:
        raise SystemExit("reloc serve: the point matcher's table differs from "
                         "the engine's")
    reloc_batch_check(torch, cfg, engine, src, tgt, got, tables[0])
    cells = (TRAIN_SHIFT[0] // 16, TRAIN_SHIFT[1] // 16)
    print(f"reloc serve: shift recovery on the {fine_side}-cell fine grid "
          f"{shift_recovery(tables[0], fine_side, cells):.4f} (printed, not "
          "gated)", flush=True)
    reloc_stages(torch, cfg, engine._params, src, tgt, nc, x)
    return launches


def reloc_batch_check(torch, cfg, engine, src, tgt, matcher_table,
                      request_table):
    """Phase R: the point matcher on pair 0 against row 0 of the 4-pair
    request.  The request's trunk runs at batch 4 and the matcher's at
    batch 1, so the two may round otherwise.  Checked bit for bit: the
    request's table from its own trunk features; the batch-4 forward with
    pair 0's batch-1 features in their place gives the matcher's table in
    row 0 and the request's other rows unchanged; and where the two trunks
    agree, the matcher gives row 0 itself.  Printed: how far the trunks
    differ, and how near a tie each differing match was."""
    import numpy as np

    from ncnet_tpu_torch.models.ncnet import (
        extract_features,
        ncnet_forward_from_feature_pair,
    )
    from ncnet_tpu_torch.ops.matching import _grid

    params = engine._params
    with torch.no_grad():
        f4 = [extract_features(cfg, params, x) for x in (src, tgt)]
        f1 = [extract_features(cfg, params, x[:1]) for x in (src, tgt)]
        trunk_equal = all(torch.equal(a[:1], b) for a, b in zip(f4, f1))
        trunk_err = max(float((a[:1] - b).abs().max() / b.abs().max())
                        for a, b in zip(f4, f1))
        trunk_share = sum(int((a[:1] != b).sum()) for a, b in zip(f4, f1)) / sum(
            b.numel() for b in f1)
        own_out = ncnet_forward_from_feature_pair(cfg, params, *f4)
        own = engine.fetch(engine._tables(own_out))
        mixed = engine.fetch(engine._tables(ncnet_forward_from_feature_pair(
            cfg, params, *(torch.cat([b, a[1:]]) for a, b in zip(f4, f1)))))
        n = own_out.corr.shape[1] * own_out.corr.shape[2]
        scores = torch.softmax(own_out.corr.reshape(len(own), n, -1),
                               dim=1)[0].float().cpu()

    # the matches that differ, by the coarse A cell each side chose: the
    # same cell (the pooling's box broke a tie otherwise) or another one
    # (the readout's argmax did), the second with the matcher's choice's
    # gap below the engine's in the engine's softmax, in bf16 ulps
    fine = RELOC_SIDE // 16
    grid = _grid(-1.0, fine, "cpu").numpy()
    row0 = request_table[0, :5]
    differ = np.flatnonzero(np.any(matcher_table[:4] != row0[:4], axis=0))

    def coarse_a(table):
        ia = np.searchsorted(grid, table[1, differ]) // RELOC_K
        ja = np.searchsorted(grid, table[0, differ]) // RELOC_K
        return ia * (fine // RELOC_K) + ja

    a_eng, a_mat = coarse_a(row0), coarse_a(matcher_table)
    other = a_eng != a_mat
    cols = torch.from_numpy(differ[other])
    s_eng = scores[torch.from_numpy(a_eng[other]), cols]
    s_mat = scores[torch.from_numpy(a_mat[other]), cols]
    ulps = ((s_eng - s_mat) / torch.exp2(torch.floor(torch.log2(s_eng)) - 7)
            ).numpy()
    gaps = (f"max {ulps.max():.2f}, median {np.median(ulps):.2f}, "
            f"{int((ulps == 0).sum())} at 0" if len(ulps) else "none")
    print(f"reloc serve: pair 0's trunk features at batch 1 vs batch 4: "
          f"{'bit-equal' if trunk_equal else 'DIFFERENT'}, max|diff| / max "
          f"{trunk_err:.3e}, share of values that differ {trunk_share:.4f}; "
          f"the matcher vs row 0 of the {len(own)}-pair request: "
          f"{len(differ)} of {row0.shape[1]} matches differ, "
          f"{int((~other).sum())} in the offset inside the same pooled cell, "
          f"{int(other.sum())} in the pooled cell, there the matcher's "
          f"choice below the engine's in the engine's softmax by bf16 ulps: "
          f"{gaps}", flush=True)
    if not np.array_equal(own, request_table):
        raise SystemExit("reloc serve: the request's table from its own trunk "
                         "features differs from the request's")
    if not (np.array_equal(mixed[0, :5], matcher_table)
            and np.array_equal(mixed[1:], request_table[1:])):
        raise SystemExit("reloc serve: with pair 0's batch-1 features the "
                         "batch-4 forward does not give the matcher's row 0 "
                         "and the request's other rows")
    if trunk_equal and len(differ):
        raise SystemExit("reloc serve: the trunks agree but the matcher "
                         "differs from row 0 of the request")


def reloc_stages(torch, cfg, params, src, tgt, nc, nc_input):
    """CUDA-event ms of each stage of one relocalized request's forward
    (warm, one stage at a time)."""
    from ncnet_tpu_torch.models.ncnet import extract_features, ncnet_filter
    from ncnet_tpu_torch.observability.quality import append_quality_rows
    from ncnet_tpu_torch.ops import nc_fused_lane
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.matching import corr_to_matches
    from ncnet_tpu_torch.ops.pooling import maxpool4d_with_argmax

    def trunk():
        return (extract_features(cfg, params, src),
                extract_features(cfg, params, tgt))

    def readout(out):
        m = corr_to_matches(out.corr, delta4d=out.delta4d, k_size=RELOC_K,
                            do_softmax=True)
        return append_quality_rows(
            torch.stack([v.to(torch.float32) for v in m], dim=1), out.corr)

    with torch.no_grad():
        fa, fb = (f.to(torch.bfloat16) for f in trunk())
        corr = correlation_4d(fa, fb)
        out = ncnet_filter(cfg, params, corr)
        stages = {
            "trunk, both sides": cuda_ms(trunk, 2),
            "correlation (f32 sums, bf16 out)": cuda_ms(
                lambda: correlation_4d(fa, fb), 2),
            "pooling (maxpool4d_with_argmax)": cuda_ms(
                lambda: maxpool4d_with_argmax(corr, RELOC_K), 2),
            "filter (pooling, mutual, NC stack, mutual)": cuda_ms(
                lambda: ncnet_filter(cfg, params, corr), 1),
            "of which the NC stack (B2)": cuda_ms(
                lambda: nc_fused_lane.nc_stack_resident(nc, nc_input), 1),
            "readout (matches with the offsets, quality row)": cuda_ms(
                lambda: readout(out), 2),
        }
    print(f"reloc serve stages ms per request ({RELOC_SIDE}x{RELOC_SIDE}, "
          f"B={SERVE_BATCH}): " + json.dumps(stages), flush=True)


def reference_checkpoint(torch, path, cfg, params) -> None:
    """Write ``params`` as a reference ``.pth.tar`` (``ImMatchNet`` key
    names and layouts, the run's ``args``), as the published PF-Pascal
    checkpoint is stored."""
    import argparse

    from ncnet_tpu_torch.models.checkpoint import reference_state_dict

    args = argparse.Namespace(
        ncons_kernel_sizes=list(cfg.ncons_kernel_sizes),
        ncons_channels=list(cfg.ncons_channels),
        feature_extraction_cnn=cfg.backbone)
    torch.save({"epoch": 0, "args": args,
                "state_dict": reference_state_dict(cfg, params)}, path)


def result_table(stats):
    """The ``(N, 6)`` rows of a ``run_eval`` result: PCK, then the quality
    columns."""
    import numpy as np

    from ncnet_tpu_torch.observability.quality import QUALITY_SIGNALS

    return np.column_stack([stats["per_pair"]]
                           + [stats["quality"][n] for n in QUALITY_SIGNALS])


def journal_rows(path):
    """Every journaled batch's rows of an eval journal, in batch order."""
    import numpy as np

    from ncnet_tpu_torch.evaluation.pf_pascal import RESULT_COLUMNS
    from ncnet_tpu_torch.evaluation.resilience import EvalJournal

    with open(path) as f:
        header = json.loads(f.readline())["header"]
    journal = EvalJournal(path, header)
    journal.close()
    return np.concatenate([journal.entries[i].reshape(-1, len(RESULT_COLUMNS))
                           for i in sorted(journal.entries)])


def eval_loop_run(torch, nc_fused_lane, sparse_corr, config, model_config,
                  batch_size, where):
    """One ``run_eval`` with every step call recorded; returns the stats,
    the launches, the recorded ``(net, step batch)`` pairs and the run's
    replayed events."""
    from ncnet_tpu_torch.evaluation import pf_pascal
    from ncnet_tpu_torch.evaluation.pf_pascal import run_eval
    from ncnet_tpu_torch.observability import events

    real_make = pf_pascal.make_eval_step
    calls = []

    def recording_make(net, alpha, device_normalize=False):
        step = real_make(net, alpha, device_normalize)

        def recorded(params, batch):
            calls.append((net, batch))
            return step(params, batch)
        return recorded

    torch.cuda.synchronize()
    nc_fused_lane.launches = 0
    sparse_corr.launches = 0
    t0 = time.perf_counter()
    with routed(pf_pascal, "make_eval_step", recording_make):
        stats = run_eval(config, model_config=model_config,
                         batch_size=batch_size, num_workers=EVAL_LOOP_WORKERS,
                         progress=False)
    wall = time.perf_counter() - t0
    launches = {"nc_conv4d_bf16": nc_fused_lane.launches,
                "gather_tile_corr_bf16": sparse_corr.launches}
    _, replayed = events.replay_events(
        os.path.join(config.telemetry_dir, "events.jsonl"))
    batch_events = [e for e in replayed if e["event"] == "eval_batch"]
    fetch_ms = [round(e["fetch_wall_s"] * 1e3, 3) for e in batch_events]
    # a batch's wall: from the previous batch's result to its own (the
    # first from the run's start: checkpoint load and first calls)
    stamps = [replayed[0]["t"]] + [e["t"] for e in batch_events]
    walls = [round((b - a) * 1e3, 2) for a, b in zip(stamps, stamps[1:])]
    retries = [e for e in replayed if e["event"] == "retry"]
    n_batches = len(fetch_ms)
    print(f"{where}: {stats['total']} pairs in {n_batches} batches of "
          f"{batch_size} at {config.image_size}x{config.image_size} in "
          f"{wall:.3f} s; batch walls ms {walls} (the first with set-up); "
          f"decode/dispatch/fetch s {json.dumps(stats['timing'])}; fetch ms "
          f"a batch {fetch_ms}; PCK@{config.pck_alpha} {stats['pck']:.4f} "
          f"({stats['valid']} valid); tier {stats['quality_tier']!r}; "
          f"launches {launches}; quarantined batches "
          f"{stats['quarantined_batches']}, retries {len(retries)}, "
          f"undecodable images {stats['decode_quarantined']}", flush=True)
    if stats["quarantined_batches"] or stats["decode_quarantined"] or retries \
            or stats["total"] != EVAL_LOOP_PAIRS:
        raise SystemExit(f"{where}: the run quarantined, retried or "
                         "substituted, or lost pairs")
    return stats, launches, calls, replayed


def eval_loop(torch, nc_fused_lane, sparse_corr, dev):
    """Phase L: the PF-Pascal eval loop end to end (``run_eval`` and the
    CLI) on a raw fixture with a reference checkpoint; returns the B2 and
    B4 launches by run."""
    import io
    import tempfile

    import numpy as np

    from ncnet_tpu_torch.cli import eval_pf_pascal as cli
    from ncnet_tpu_torch.config import EvalPFPascalConfig, ModelConfig
    from ncnet_tpu_torch.data.synthetic import write_pf_pascal_like
    from ncnet_tpu_torch.evaluation import pf_pascal
    from ncnet_tpu_torch.evaluation.pck import pck_metric
    from ncnet_tpu_torch.observability import perfstore
    from ncnet_tpu_torch.ops.matching import corr_to_matches

    tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_loop_")
    root = os.path.join(tmp, "pf-pascal")
    t0 = time.perf_counter()
    write_pf_pascal_like(root, n_pairs=EVAL_LOOP_PAIRS, image_hw=EVAL_SOURCE_HW,
                         shift=EVAL_LOOP_SHIFT, seed=11)
    fixture_s = time.perf_counter() - t0
    arch = ModelConfig(backbone="resnet101", ncons_kernel_sizes=(5, 5, 5),
                       ncons_channels=(16, 16, 1), half_precision=True,
                       backbone_bf16=True)
    ckpt = os.path.join(tmp, "ncnet_pfpascal.pth.tar")
    reference_checkpoint(torch, ckpt, arch,
                         serving_params(torch, arch, dev, EVAL_SIDE))
    print(f"eval loop: fixture of {EVAL_LOOP_PAIRS} raw pairs at "
          f"{EVAL_SOURCE_HW} (shift {EVAL_LOOP_SHIFT} px, about one 16-px "
          f"cell at {EVAL_SIDE}x{EVAL_SIDE}) written in {fixture_s:.2f} s; "
          f"reference checkpoint of phase E's weights "
          f"{os.path.getsize(ckpt)} bytes", flush=True)
    store = os.path.join(tmp, "perf_history.jsonl")
    os.environ[perfstore.STORE_ENV] = store
    bf16 = ModelConfig(half_precision=True, backbone_bf16=True)

    def config(side, name, **kw):
        return EvalPFPascalConfig(
            checkpoint=ckpt, image_size=side, eval_dataset_path=root,
            telemetry_dir=os.path.join(tmp, name), **kw)

    runs = {}
    # (name, side, options, B2 and B4 launches a batch, tier): the 400²
    # stack takes the FFT tier (no kernel); at 800² each coarse-to-fine
    # batch is a request of phase B, and the dense 800² run beside it (the
    # same pairs' PCK without the candidate selection) a dense request
    # there
    n_batches = EVAL_LOOP_PAIRS // EVAL_LOOP_BATCH
    for name, side, kw, per_batch, tier in (
            ("eval_loop_400", EVAL_SIDE, {}, (0, 0), "fft"),
            ("eval_loop_800", C2F_SIDE, {"sparse_topk": C2F_TOPK}, (6, 2),
             "coarse2fine"),
            ("eval_loop_800_dense", C2F_SIDE, {}, (3, 0), "resident")):
        where = name.replace("_", " ")
        stats, launches, calls, _ = eval_loop_run(
            torch, nc_fused_lane, sparse_corr, config(side, name, **kw), bf16,
            EVAL_LOOP_BATCH, where)
        want = {"nc_conv4d_bf16": per_batch[0] * n_batches,
                "gather_tile_corr_bf16": per_batch[1] * n_batches}
        if launches != want or stats["quality_tier"] != tier:
            raise SystemExit(f"{where}: expected launches {want} and "
                             f"tier {tier!r}")
        # the loop's rows against the step run directly on the batches the
        # loop uploaded (the same program: bit for bit)
        net = calls[0][0]
        step = pf_pascal.make_eval_step(net, 0.1, device_normalize=True)
        direct = np.concatenate([step(net.params, b).cpu().numpy()
                                 for _, b in calls])
        same = np.array_equal(direct, result_table(stats), equal_nan=True)
        print(f"{where}: rows vs make_eval_step run directly on the "
              f"{len(calls)} uploaded batches: "
              f"{'bit-equal' if same else 'DIFFERENT'}", flush=True)
        if not same or len(calls) != n_batches:
            raise SystemExit(f"{where}: the loop's rows differ from the "
                             "direct step's")
        runs[name] = (stats, launches, calls)

    # phase E's check on the loop's first batch: its PCK against
    # pck_metric on the CPU on the step's own volume
    stats, _, calls = runs["eval_loop_400"]
    net, batch = calls[0]
    step = pf_pascal.make_eval_step(net, 0.1, device_normalize=True)
    fwd = []
    with routed(pf_pascal, "ncnet_forward", pf_pascal.ncnet_forward, fwd):
        table = step(net.params, batch).cpu()
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    pck_cpu = pck_metric(cpu_batch, corr_to_matches(fwd[0][2].corr.cpu(),
                                                    do_softmax=True), 0.1)
    n_valid = (cpu_batch["source_points"][:, 0] != -1).sum(dim=1)
    off = ((table[:, 0] - pck_cpu).abs() * n_valid).round()
    print(f"eval loop {EVAL_SIDE}: batch 0's PCK {table[:, 0].tolist()} vs "
          f"pck_metric "
          f"on the CPU {pck_cpu.tolist()}: keypoints apart {off.tolist()} of "
          f"{n_valid.tolist()}", flush=True)
    if off.max() > 1:
        raise SystemExit("eval loop: the loop's PCK and pck_metric on the "
                         "CPU differ by more than one keypoint")

    # the CLI (its default fp32 model from the checkpoint), once through
    # and once killed mid-journal by an injected SIGKILL and resumed: the
    # resumed journal's rows equal the uninterrupted run's bit for bit.  The
    # killed run is a process of its own with PyTorch's default TF32
    # settings, which the in-process runs take for the CLI too
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    def cli_args(journal):
        return ["--checkpoint", ckpt, "--image_size", str(EVAL_SIDE),
                "--eval_dataset_path", root, "--batch_size", "1",
                "--num_workers", str(EVAL_LOOP_WORKERS),
                "--journal_dir", os.path.join(tmp, journal),
                "--telemetry_dir", os.path.join(tmp, journal + "_events")]

    def cli_run(journal):
        out = io.StringIO()
        nc_fused_lane.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(cli_args(journal))
        lines = [ln for ln in out.getvalue().splitlines()
                 if not ln.startswith("Batch: ")]
        return rc, lines, time.perf_counter() - t0, nc_fused_lane.launches

    rc, lines, wall, cli_launches = cli_run("cli")
    print(f"eval cli {EVAL_SIDE}: exit {rc} in {wall:.3f} s ({EVAL_LOOP_PAIRS} batches "
          f"of 1, fp32, PyTorch's default TF32 settings), B2 launches "
          f"{cli_launches}, printed {lines}", flush=True)
    if rc != 0 or lines[:3] != ["NCNet evaluation script - PF Pascal dataset",
                                f"Total: {EVAL_LOOP_PAIRS}",
                                f"Valid: {EVAL_LOOP_PAIRS}"] \
            or not lines[3].startswith("PCK: ") or len(lines) != 4:
        raise SystemExit("eval cli: expected exit 0 and the reference's lines")
    env = dict(os.environ, NCNET_TPU_FAULTS=json.dumps(
        {"kill_at_journal_append": EVAL_LOOP_KILL_AT}))
    t0 = time.perf_counter()
    killed = subprocess.run(
        [sys.executable, "-m", "ncnet_tpu_torch.cli.eval_pf_pascal"]
        + cli_args("cli_killed"), cwd=HERE, env=env, capture_output=True,
        text=True, timeout=600)
    kill_s = time.perf_counter() - t0
    rc2, lines2, wall2, _ = cli_run("cli_killed")
    full = journal_rows(os.path.join(tmp, "cli", "pck_journal.jsonl"))
    resumed = journal_rows(os.path.join(tmp, "cli_killed", "pck_journal.jsonl"))
    same = np.array_equal(full, resumed, equal_nan=True)
    print(f"eval cli {EVAL_SIDE}: a run killed at journal append "
          f"{EVAL_LOOP_KILL_AT} "
          f"(exit {killed.returncode} after {kill_s:.1f} s) resumed in "
          f"{wall2:.3f} s: exit {rc2}, printed {lines2}; its journaled rows vs "
          f"the uninterrupted run's: {'bit-equal' if same else 'DIFFERENT'}",
          flush=True)
    if killed.returncode != -9 or rc2 != 0 or lines2 != lines or not same \
            or len(resumed) != EVAL_LOOP_PAIRS:
        raise SystemExit("eval cli: the killed run did not resume to the "
                         "uninterrupted result" + killed.stderr[-2000:])
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    recorded = perfstore.PerfStore(store).records()
    print(f"eval loop: perf store {len(recorded)} records "
          f"({sorted({r['metric'] for r in recorded})[:4]} ...)", flush=True)
    if not any(r["metric"] == "pf_pascal_pck" for r in recorded):
        raise SystemExit("eval loop: the perf store holds no PCK record")
    del os.environ[perfstore.STORE_ENV]
    leave("L", store=store,
          events=os.path.join(tmp, "eval_loop_400", "events.jsonl"))
    shutil.rmtree(tmp)
    return ({name: launches for name, (_, launches, _) in runs.items()},
            cli_launches)


def trace_busy_share(path):
    """``(busy_s, window_s, device_events)`` of a profiler Chrome trace:
    the union of its device intervals (kernels, copies, fills) against the
    span of all its events."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    if not events:
        return 0.0, 0.0, 0
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e["dur"] for e in events)
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, None
    for a, b in device:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy * 1e-6, (hi - lo) * 1e-6, len(device)


def fit_cli_args(ckpt, root, out):
    """The train CLI's arguments for phase F's recipe."""
    return ["--checkpoint", ckpt, "--image_size", str(SERVE_SIDE),
            "--dataset_image_path", root,
            "--dataset_csv_path", os.path.join(root, "image_pairs"),
            "--num_epochs", str(FIT_EPOCHS), "--batch_size", str(FIT_BATCH),
            "--lr", "0.0005", "--half_precision",
            "--checkpoint_steps", "1", "--keep_checkpoints", "2",
            "--num_workers", str(FIT_WORKERS), "--result-model-dir", out]


def version_trees(version):
    """A committed version's params and opt trees (CPU tensors)."""
    from ncnet_tpu_torch.models.checkpoint import PARAMS_FILE, load_tree
    from ncnet_tpu_torch.training.train import OPT_FILE

    return load_tree(version, PARAMS_FILE), load_tree(version, OPT_FILE)


def trees_equal(torch, a, b) -> bool:
    """Two trees equal key for key and bit for bit."""
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(trees_equal(torch, a[k], b[k])
                                              for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(trees_equal(torch, x, y)
                                        for x, y in zip(a, b))
    if torch.is_tensor(a):
        return (torch.is_tensor(b) and a.dtype == b.dtype
                and torch.equal(a.cpu(), b.cpu()))
    return a == b


def run_root(out):
    """The one versioned root ``fit`` wrote under ``out``."""
    (name,) = [n for n in os.listdir(out) if not n.startswith("best_")]
    return os.path.join(out, name)


class SyncDebugWindow:
    """``fit``'s step tracer for phase F's steady-state run: over global
    steps ``[a, b)`` a profiler of the card's activity alone (no host-op
    records, so the steps keep their untraced walls) and
    ``torch.cuda.set_sync_debug_mode("warn")``, switched on after the
    profiler starts and off before it stops.  Duck-types
    ``StepWindowTracer`` (``enabled``, ``at_step``, ``close``)."""

    def __init__(self, torch, log_dir, window):
        self.torch, self.window = torch, window
        self.trace_path = os.path.join(log_dir, "trace_steps_%d-%d.json"
                                       % window)
        self.enabled, self._prof = True, None
        os.makedirs(log_dir, exist_ok=True)

    def at_step(self, global_step):
        a, b = self.window
        if self.enabled and self._prof is None and a <= global_step < b:
            torch = self.torch
            self._prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            self._prof.start()
            torch.cuda.set_sync_debug_mode("warn")
        elif global_step >= b:
            self.close()

    def close(self):
        self.torch.cuda.set_sync_debug_mode(0)
        if self._prof is not None:
            self.torch.cuda.synchronize()
            self._prof.stop()
            self._prof.export_chrome_trace(self.trace_path)
            self._prof = None
        self.enabled = False


def steady_state_fit(torch, fit, config, root, dev, out):
    """Host waits and device busy share of one steady-state step of
    ``fit`` itself: one epoch of FIT_STEADY_PAIRS pairs under ``root``
    with the telemetry on and no periodic checkpoint, under
    :class:`SyncDebugWindow` at steps FIT_STEADY_WINDOW (a step in
    mid-epoch: its dispatch, the staging of the next batch, the loss
    fetch, the step event and ``fit``'s own ``on_step`` with the
    heartbeat, the device monitor, the NaN streak and the checkpoint
    decision).  Returns ``(waits, (busy_s, window_s, n), step walls in
    ms)``."""
    import dataclasses
    import warnings

    from ncnet_tpu_torch.observability import events
    from ncnet_tpu_torch.training import train as train_mod

    window = SyncDebugWindow(torch, os.path.join(out, "trace"),
                             FIT_STEADY_WINDOW)
    saved = train_mod.StepWindowTracer
    train_mod.StepWindowTracer = lambda *a, **k: window
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = fit(dataclasses.replace(
                config, dataset_image_path=root,
                dataset_csv_path=os.path.join(root, "image_pairs"),
                num_epochs=1, checkpoint_steps=0, result_model_dir=out),
                progress=False, device=dev)
    finally:
        train_mod.StepWindowTracer = saved
        window.close()
    waits = [str(w.message).splitlines()[0] for w in caught
             if "called a synchronizing" in str(w.message)]
    _, replayed = events.replay_events(os.path.join(
        res["checkpoint"], "telemetry", "events.jsonl"))
    walls = [round(e["wall_s"] * 1e3, 2) for e in replayed
             if e["event"] == "step"]
    if res["state"].step != FIT_STEADY_PAIRS // FIT_BATCH \
            or not os.path.exists(window.trace_path):
        raise SystemExit("fit steady state: the run or its trace is missing")
    return waits, trace_busy_share(window.trace_path), walls


def fit_phase(torch, nc_fused_lane, vjp, dev, start, step5_walls,
              model=None, keep=None):
    """Phase F: ``fit`` end to end at the PF-Pascal recipe from phase 5's
    weights; resumes through the CLI in subprocesses; the NaN guard and the
    two fine-tune recipes (``model`` overrides the architecture, for a
    rehearsal at a small size).  Returns the B2/B3 launches by run.  With
    ``keep`` (a dict), the dataset, the CLI's configuration and run (a)'s
    root are left on disk for phases V and M and recorded there."""
    import dataclasses
    import tempfile

    import numpy as np

    from ncnet_tpu_torch.cli import train as cli
    from ncnet_tpu_torch.config import ModelConfig
    from ncnet_tpu_torch.data.synthetic import write_pair_dataset
    from ncnet_tpu_torch.models import backbone as bb
    from ncnet_tpu_torch.models import checkpoint as ckpt_io
    from ncnet_tpu_torch.models.ncnet import tree_leaves
    from ncnet_tpu_torch.observability import events, perfstore
    from ncnet_tpu_torch.observability.device import Heartbeat
    from ncnet_tpu_torch.training import create_train_state, fit
    from ncnet_tpu_torch.utils import faults, profiling

    tmp = tempfile.mkdtemp(prefix="chip_smoke_fit_")
    root = os.path.join(tmp, "pairs")
    t0 = time.perf_counter()
    write_pair_dataset(root, n_pairs=FIT_TRAIN_PAIRS,
                       image_hw=(SERVE_SIDE, SERVE_SIDE), shift=TRAIN_SHIFT,
                       seed=21, splits=("train",))
    write_pair_dataset(root, n_pairs=FIT_VAL_PAIRS,
                       image_hw=(SERVE_SIDE, SERVE_SIDE), shift=TRAIN_SHIFT,
                       seed=22, splits=("val",))
    mc = model or ModelConfig(backbone="resnet101", ncons_kernel_sizes=(5, 5, 5),
                              ncons_channels=(16, 16, 1), half_precision=True)
    start_dir = os.path.join(tmp, "start")
    ckpt_io.save_params(start_dir, mc, start)
    print(f"fit: fixture of {FIT_TRAIN_PAIRS} train and {FIT_VAL_PAIRS} val "
          f"raw pairs at {SERVE_SIDE}x{SERVE_SIDE} (shift {TRAIN_SHIFT} px) "
          f"and phase 5's start weights written in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    def reset():
        torch.cuda.synchronize()
        nc_fused_lane.launches = 0
        for key in vjp.launches:
            vjp.launches[key] = 0

    def read():
        torch.cuda.synchronize()
        return {"nc_conv4d_bf16": nc_fused_lane.launches, **vjp.launches}

    # (a): the CLI's configuration run in this process, with PyTorch's
    # default TF32 settings as the CLI subprocesses below have them, the
    # step window profiled and the perf store in the run's directory
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    store = os.path.join(tmp, "perf_history.jsonl")
    env_keys = {perfstore.STORE_ENV: store,
                profiling.PROFILE_DIR_ENV: os.path.join(tmp, "trace"),
                profiling.PROFILE_STEPS_ENV: FIT_PROFILE_STEPS}
    os.environ.update(env_keys)
    config = cli.config_from_args(cli.build_parser().parse_args(
        fit_cli_args(start_dir, root, os.path.join(tmp, "a"))))
    reset()
    t0 = time.perf_counter()
    res = fit(config, progress=False, device=dev)
    fit_wall = time.perf_counter() - t0
    launches = {"fit": read()}
    for key in env_keys:
        del os.environ[key]
    a_root = res["checkpoint"]
    chunks = 2 * FIT_BATCH // 4
    n_layers = len(mc.ncons_channels)
    steps = FIT_EPOCHS * (FIT_TRAIN_PAIRS // FIT_BATCH)
    # per step, each of the chunks runs the folded stack's forward on the
    # FFT tier (no B2) and its backward on B3: dW/db and its reduction a
    # layer, the transposed conv for every layer but the first (the volume
    # needs no gradient); the val passes run the forward only
    want = {"nc_conv4d_bf16": 0,
            "nc_vjp_dw": steps * chunks * n_layers,
            "nc_vjp_reduce": steps * chunks * n_layers,
            "nc_conv4d_transpose": steps * chunks * (n_layers - 1)}
    _, replayed = events.replay_events(os.path.join(a_root, "telemetry",
                                                    "events.jsonl"))
    names = [e["event"] for e in replayed]
    step_events = [e for e in replayed if e["event"] == "step"]
    commits = [e for e in replayed if e["event"] == "checkpoint_commit"]
    versions = [os.path.basename(p)
                for _, p in ckpt_io.list_checkpoint_versions(a_root)]
    best = os.path.join(os.path.dirname(a_root), "best_" + os.path.basename(a_root))
    cfg_back, params_back = ckpt_io.load_params(a_root)
    same = trees_equal(torch, params_back, ckpt_io.cpu_tree(res["state"].params))
    sha = ckpt_io.verify_checkpoint_payload(a_root, params_back)
    beat = Heartbeat.read(os.path.join(a_root, "telemetry", "heartbeat.json"))
    recorded = {r["metric"] for r in perfstore.PerfStore(store).records()}
    trace = os.path.join(tmp, "trace", "trace_steps_" +
                         FIT_PROFILE_STEPS.replace(":", "-") + ".json")
    busy, window, n_dev = trace_busy_share(trace) if os.path.exists(trace) \
        else (0.0, 0.0, 0)
    walls = [round(e["wall_s"] * 1e3, 2) for e in step_events]
    print(f"fit: {steps} steps of batch {FIT_BATCH} in {FIT_EPOCHS} epochs, "
          f"{fit_wall:.2f} s in all; train loss {res['train_loss'].tolist()}, "
          f"val loss {res['test_loss'].tolist()}; launches {launches['fit']}, "
          f"expected {want}; versions {versions}, best copy "
          f"{os.path.isdir(best)}; load_params(root) bit-equal to the "
          f"returned state: {same}, payload sha verified: {bool(sha)}; "
          f"heartbeat step {beat and beat.get('step')}; perf store holds "
          f"train_step_wall_s: {'train_step_wall_s' in recorded}", flush=True)
    print(f"fit: step walls ms {walls} (steps {FIT_PROFILE_STEPS} traced, "
          f"each with a checkpoint after it) beside phase 5's make_train_step "
          f"walls {step5_walls}; stage walls ms "
          f"{[round(e['stage_wall_s'] * 1e3, 3) for e in step_events]}; "
          f"checkpoint saves ms "
          f"{[round(e['save_wall_s'] * 1e3, 1) for e in commits]} of bytes "
          f"{sorted({e['bytes'] for e in commits})}", flush=True)
    print(f"fit: traced window {FIT_PROFILE_STEPS}: device busy "
          f"{busy * 1e3:.2f} ms of {window * 1e3:.2f} ms "
          f"({100 * busy / window if window else 0:.1f} %), {n_dev} device "
          f"intervals, trace {os.path.getsize(trace) if os.path.exists(trace) else 0}"
          f" bytes", flush=True)
    counts = {n: names.count(n) for n in ("run_start", "step",
                                          "checkpoint_commit", "epoch_end",
                                          "run_end")}
    if launches["fit"] != want or not np.isfinite(res["train_loss"]).all() \
            or not np.isfinite(res["test_loss"]).all() \
            or versions != ["step_%08d" % (steps - 1), "step_%08d" % steps] \
            or not os.path.isdir(best) or not same or not sha \
            or not beat or beat.get("step") != steps \
            or "train_step_wall_s" not in recorded \
            or not os.path.exists(trace) \
            or counts != {"run_start": 1, "step": steps,
                          "checkpoint_commit": steps + FIT_EPOCHS,
                          "epoch_end": FIT_EPOCHS, "run_end": 1}:
        raise SystemExit(f"fit: a check failed (events {counts})")
    telemetry = os.path.join(a_root, "telemetry")
    fresh_heartbeat(os.path.join(telemetry, "heartbeat.json"),
                    os.path.join(telemetry, "events.jsonl"))
    leave("F", store=store,
          events=os.path.join(telemetry, "events.jsonl"),
          heartbeat=os.path.join(telemetry, "heartbeat.json"))

    # the steady state without checkpoints: host waits of one step of fit,
    # and the device's busy share over it
    steady_root = os.path.join(tmp, "steady_pairs")
    write_pair_dataset(steady_root, n_pairs=FIT_STEADY_PAIRS,
                       image_hw=(SERVE_SIDE, SERVE_SIDE), shift=TRAIN_SHIFT,
                       seed=23, splits=("train",))
    write_pair_dataset(steady_root, n_pairs=FIT_BATCH,
                       image_hw=(SERVE_SIDE, SERVE_SIDE), shift=TRAIN_SHIFT,
                       seed=24, splits=("val",))
    os.environ[perfstore.STORE_ENV] = "off"
    try:
        waits, (sbusy, swindow, sn), swalls = steady_state_fit(
            torch, fit, config, steady_root, dev, os.path.join(tmp, "steady"))
    finally:
        del os.environ[perfstore.STORE_ENV]
    print(f"fit steady state (batch {FIT_BATCH}, no periodic checkpoints): "
          f"host waits in step {FIT_STEADY_WINDOW[0]} {len(waits)} {waits}; "
          f"step walls ms {swalls} (step {FIT_STEADY_WINDOW[0]} traced, the "
          f"card's activity only); traced step: device busy "
          f"{sbusy * 1e3:.2f} ms of {swindow * 1e3:.2f} ms "
          f"({100 * sbusy / swindow if swindow else 0:.1f} %), {sn} device "
          f"intervals", flush=True)
    if len(waits) != 1:
        raise SystemExit("fit: a steady-state step must wait for the card "
                         "once (its loss fetch)")

    # (b) SIGTERM after step 3 and (c) SIGKILL mid-save of version 3, each
    # through the CLI in a subprocess, both running at once; then both
    # resumed from their roots at once; each ends bit-equal to (a)
    env = dict(os.environ, NCNET_TPU_PERF_STORE="off")

    def cli_procs(runs):
        procs = []
        for args, plan in runs:
            e = dict(env, NCNET_TPU_FAULTS=json.dumps(plan)) if plan else env
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "ncnet_tpu_torch.cli.train"] + args,
                cwd=HERE, env=e, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        return [(p.wait(timeout=600), p.communicate()) for p in procs]

    t0 = time.perf_counter()
    cut = cli_procs([
        (fit_cli_args(start_dir, root, os.path.join(tmp, "b")),
         {"sigterm_at_step": 3}),
        (fit_cli_args(start_dir, root, os.path.join(tmp, "c")),
         {"kill_at_version": 3})])
    cut_s = time.perf_counter() - t0
    b_root, c_root = run_root(os.path.join(tmp, "b")), run_root(
        os.path.join(tmp, "c"))
    b_listing, c_listing = sorted(os.listdir(b_root)), sorted(os.listdir(c_root))
    t0 = time.perf_counter()
    resumed = cli_procs([(fit_cli_args(b_root, root, os.path.join(tmp, "x")),
                          None),
                         (fit_cli_args(c_root, root, os.path.join(tmp, "y")),
                          None)])
    resume_s = time.perf_counter() - t0
    final = "step_%08d" % steps
    a_trees = version_trees(os.path.join(a_root, final))
    same_b = trees_equal(torch, version_trees(os.path.join(b_root, final)),
                         a_trees)
    same_c = trees_equal(torch, version_trees(os.path.join(c_root, final)),
                         a_trees)
    print(f"fit resume: SIGTERM at step 3 exit {cut[0][0]}, its root "
          f"{b_listing}; SIGKILL mid-save of version 3 exit {cut[1][0]}, its "
          f"root {c_listing} ({cut_s:.1f} s, both at once); resumed exits "
          f"{[r[0] for r in resumed]} ({resume_s:.1f} s); version {final} "
          f"(params, Adam state, step) vs the uninterrupted run's: SIGTERM "
          f"{'bit-equal' if same_b else 'DIFFERENT'}, kill mid-save "
          f"{'bit-equal' if same_c else 'DIFFERENT'}", flush=True)
    if cut[0][0] != 0 or cut[1][0] != -9 \
            or c_listing != ["step_00000001", "step_00000002",
                             "step_00000003.tmp", "telemetry"] \
            or "step_00000003" not in b_listing \
            or any(r[0] != 0 for r in resumed) or not same_b or not same_c:
        raise SystemExit("fit resume: the interrupted runs did not resume "
                         "bit-equal" + "".join(e[-1500:] for _, (_, e) in
                                               cut + resumed))
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    # the NaN guard: a NaN batch at step 2 is skipped, version 2 keeps
    # version 1's params and Adam state
    short = dict(num_epochs=1, checkpoint_steps=1, keep_checkpoints=0,
                 telemetry=False)
    with faults.injected(faults.FaultPlan(nan_loss_steps=(2,))):
        nan_res = fit(dataclasses.replace(config, result_model_dir=os.path.join(tmp, "nan"),
                                     **short), progress=False, device=dev)
    v = [p for _, p in ckpt_io.list_checkpoint_versions(nan_res["checkpoint"])]
    (p1, o1), (p2, o2) = version_trees(v[0]), version_trees(v[1])
    kept = trees_equal(torch, p2, p1) and trees_equal(
        torch, o2["opt_state"], o1["opt_state"])
    print(f"fit NaN guard: NaN batch at step 2, {nan_res['nan_steps_skipped']} "
          f"step skipped, train loss {nan_res['train_loss'].tolist()}; "
          f"version 2 equals version 1 (params, Adam state): {kept}",
          flush=True)
    if nan_res["nan_steps_skipped"] != 1 or not kept:
        raise SystemExit("fit NaN guard: the NaN step was not skipped")

    # the two fine-tune recipes, one epoch each
    fe = dataclasses.replace(config, result_model_dir=os.path.join(tmp, "fe"),
                        fe_finetune_params=1, **dict(short, checkpoint_steps=0))
    reset()
    fe_res = fit(fe, progress=False, device=dev)
    launches["fit_fe_finetune"] = read()
    got, ref = fe_res["state"].params["backbone"], start["backbone"]
    labels = bb.finetune_labels(mc.backbone, ref, 1)["layer3"][-1]
    # the last layer3 block: every trainable leaf moved; every other trunk
    # leaf (earlier blocks, BatchNorm statistics) bit-unchanged
    last = [(a, b, lab) for a, b, lab in zip(
        tree_leaves(got["layer3"][-1]), tree_leaves(ref["layer3"][-1]),
        tree_leaves(labels))]
    n_trainable = sum(lab == "trainable" for _, _, lab in last)
    changed_last = sum(lab == "trainable" and not torch.equal(a, b)
                       for a, b, lab in last)
    frozen_ok = all(torch.equal(a, b) for a, b, lab in last
                    if lab == "frozen") and all(
        torch.equal(a, b) for a, b in zip(
            tree_leaves({k: v for k, v in got.items() if k != "layer3"})
            + tree_leaves(got["layer3"][:-1]),
            tree_leaves({k: v for k, v in ref.items() if k != "layer3"})
            + tree_leaves(ref["layer3"][:-1])))
    nc_moved = not all(torch.equal(a, b) for a, b in zip(
        tree_leaves(fe_res["state"].params["nc"]), tree_leaves(start["nc"])))
    fe_steps = FIT_TRAIN_PAIRS // FIT_BATCH
    # the whole-batch step: two filter calls (positives, negatives), each
    # the folded stack once; its input needs a gradient, so every layer
    # runs the transposed conv
    fe_want = {"nc_conv4d_bf16": 0,
               "nc_vjp_dw": fe_steps * 2 * n_layers,
               "nc_vjp_reduce": fe_steps * 2 * n_layers,
               "nc_conv4d_transpose": fe_steps * 2 * n_layers}
    print(f"fit fe_finetune_params=1: {fe_steps} steps, train loss "
          f"{fe_res['train_loss'].tolist()}; trainable leaves of layer3[-1] "
          f"changed {changed_last} of {n_trainable}; every frozen trunk "
          f"leaf (earlier blocks, BatchNorm statistics) bit-unchanged: "
          f"{frozen_ok}; NC stack changed: {nc_moved}; launches "
          f"{launches['fit_fe_finetune']}, expected {fe_want}", flush=True)
    if changed_last != n_trainable or not frozen_ok or not nc_moved \
            or launches["fit_fe_finetune"] != fe_want \
            or not np.isfinite(fe_res["train_loss"]).all():
        raise SystemExit("fit fe_finetune_params: a check failed")
    cp = dataclasses.replace(config, result_model_dir=os.path.join(tmp, "cp"),
                        finetune_cp_rank=FIT_CP_RANK,
                        **dict(short, checkpoint_steps=0))
    cp_start = create_train_state(cp, device=dev)[0].params["nc"]
    reset()
    cp_res = fit(cp, progress=False, device=dev)
    launches["fit_cp"] = read()
    got = cp_res["state"].params["nc"]
    factors_moved = all(not torch.equal(layer["cp"][k], old["cp"][k])
                        for layer, old in zip(got, cp_start)
                        for k in ("cin", "cout"))
    # the biases train with the factors (the CP chain adds them)
    dense_same = all(torch.equal(layer["w"], old["w"])
                     for layer, old in zip(got, start["nc"]))
    # the forced CP tier carries both directions (plain PyTorch): no kernel
    cp_want = {"nc_conv4d_bf16": 0, "nc_vjp_dw": 0, "nc_vjp_reduce": 0,
               "nc_conv4d_transpose": 0}
    print(f"fit finetune_cp_rank={FIT_CP_RANK}: tier "
          f"{cp_res['model_config'].nc_tier!r}, train loss "
          f"{cp_res['train_loss'].tolist()}; every layer's factors changed: "
          f"{factors_moved}; dense kernels bit-unchanged: "
          f"{dense_same}; launches {launches['fit_cp']}, "
          f"expected {cp_want}", flush=True)
    if not dense_same or launches["fit_cp"] != cp_want or not factors_moved \
            or cp_res["model_config"].nc_tier != "cp" \
            or not np.isfinite(cp_res["train_loss"]).all():
        raise SystemExit("fit finetune_cp_rank: a check failed")
    if keep is None:
        shutil.rmtree(tmp)
    else:
        keep.update(tmp=tmp, root=root, config=config, a_root=a_root,
                    final="step_%08d" % steps)
    return launches


# ---------------------------------------------------------------------------
# phase I: InLoc dense matching at the IVD model's full width
# ---------------------------------------------------------------------------


def inloc_config():
    """The IVD model of the InLoc launchers (``bench.py:1615-1619``):
    ResNet-101 to layer3, NC kernels (3, 3) with channels (16, 1), bf16
    volume, trunk and NC stack, relocalization k = 2."""
    from ncnet_tpu_torch.config import ModelConfig

    return ModelConfig(backbone="resnet101", ncons_kernel_sizes=(3, 3),
                       ncons_channels=(16, 1), half_precision=True,
                       backbone_bf16=True, relocalization_k_size=INLOC_K)


def inloc_images(torch, dev, hw, n, seed, source=None, origins=None):
    """``n`` uint8 ``(H, W, 3)`` images made on the card: a smooth random
    texture (low-resolution noise upsampled bilinearly, plus noise), or,
    with ``source``, crops of it of size ``hw`` at seeded origins (a
    cutout showing part of its query; each origin ``(y0, x0)`` appended to
    ``origins`` when given)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h, w = hw
    out = []
    for _ in range(n):
        if source is None:
            low = torch.rand((1, 3, h // 8, w // 8), generator=g, device=dev)
            img = torch.nn.functional.interpolate(
                low * 255, size=(h, w), mode="bilinear", align_corners=False)
            img = img + (torch.rand((1, 3, h, w), generator=g, device=dev)
                         - 0.5) * 24
            img = img.clamp(0, 255).to(torch.uint8)[0].permute(1, 2, 0)
        else:
            y0 = int(torch.randint(0, source.shape[0] - h + 1, (1,),
                                   generator=g, device=dev))
            x0 = int(torch.randint(0, source.shape[1] - w + 1, (1,),
                                   generator=g, device=dev))
            img = torch.as_tensor(source[y0:y0 + h, x0:x0 + w])
            if origins is not None:
                origins.append((y0, x0))
        out.append(img.contiguous().cpu().numpy())
    return out


def inloc_params(torch, cfg, dev, calib_u8):
    """The IVD model's parameters on ``dev``: random from seed 0, the
    trunk's BatchNorm statistics from ``calib_u8`` (one raw image, resized
    as the matcher does, through the f32 trunk), NC kernels centre-peaked
    with biases off zero, as in the served phases."""
    from ncnet_tpu_torch.evaluation.inloc import device_preprocess
    from ncnet_tpu_torch.models.ncnet import init_ncnet, params_to

    params = params_to(init_ncnet(cfg, seed=0), dev)
    x = device_preprocess(torch.as_tensor(calib_u8[None]).to(dev), INLOC_SIDE,
                          INLOC_K)
    calibrate_trunk(cfg.replace(backbone_bf16=False), params, x)
    for layer in params["nc"]:
        d = layer["w"].shape[0] // 2
        layer["w"][d, d, d, d] += 1.0 / layer["w"].shape[4]
        layer["b"] = layer["b"] + 0.05
    return params


def inloc_volume(query_hw, pano_hw):
    """The pooled volume ``(1, hA, wA, hB, wB)`` of a query and a cutout
    at ``INLOC_SIDE`` and ``INLOC_K``."""
    from ncnet_tpu_torch.evaluation.inloc import (
        FEATURE_STRIDE,
        quantized_resize_shape,
    )

    cells = FEATURE_STRIDE * INLOC_K
    (qh, qw), (ph, pw) = (quantized_resize_shape(*hw, INLOC_SIDE, INLOC_K)
                          for hw in (query_hw, pano_hw))
    return (1, qh // cells, qw // cells, ph // cells, pw // cells)


def check_chain(torch, nc_fused_lane, dev):
    """Phase I, B6 on the tap-swap chain: each chain layer (3, 1, 32) and
    (3, 32, 2), then the chain, against the twin on the InLoc volume, two
    launches bit-identical; the chain timed against the two-pass route the
    port took before (two (16, 1) stacks and two transposes) on the same
    volume.  Returns the chain's numbers for the kernels line."""
    from ncnet_tpu_torch.models.ncnet import tap_swap_chain

    shape = inloc_volume(INLOC_QUERY_HW, INLOC_PANO_HW)
    params = stack_params((3, 3), (16, 1), seed=1, device=dev)
    chain = tap_swap_chain(params)
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.rand(shape + (1,), generator=g, device=dev).to(torch.bfloat16)
    v = x
    for layer in chain:
        got = nc_fused_lane.nc_conv4d_layer(v, layer["w"], layer["b"])
        again = nc_fused_lane.nc_conv4d_layer(v, layer["w"], layer["b"])
        want = nc_fused_lane.layer_reference(v, layer["w"], layer["b"])
        torch.cuda.synchronize()
        err, same = normalized_err(got, want), torch.equal(got, again)
        print(f"inloc chain: layer {tuple(layer['w'].shape)} on {shape} vs "
              f"its twin: normalized {err:.3e} (tolerance {TOLERANCE}); two "
              f"launches bit-identical: {same}", flush=True)
        if not (err <= TOLERANCE and same):
            raise SystemExit("inloc chain: a chain layer disagrees with its "
                             "twin or is not deterministic")
        del want, again
        v = got
    del v, got
    torch.cuda.empty_cache()

    def two_pass():
        y = nc_fused_lane.nc_stack_resident(params, x)
        yt = nc_fused_lane.nc_stack_resident(
            params, x.permute(0, 3, 4, 1, 2, 5).contiguous())
        return y + yt.permute(0, 3, 4, 1, 2, 5)

    y2 = nc_fused_lane.nc_stack_resident(chain, x)
    t0 = time.perf_counter()
    want = nc_fused_lane.nc_stack_reference(chain, x)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = normalized_err(y2, want)
    max_abs = float((y2.float() - want.float()).abs().max())
    del want
    torch.cuda.empty_cache()
    vs_two = normalized_err(y2[..., :1] + y2[..., 1:], two_pass())
    same = torch.equal(y2, nc_fused_lane.nc_stack_resident(chain, x))
    # in turns: chain, two-pass, chain, two-pass
    ms_c, ms_t = [], []
    for _ in range(2):
        ms_c.append(cuda_ms(lambda: nc_fused_lane.nc_stack_resident(chain, x), 3))
        ms_t.append(cuda_ms(two_pass, 3))
    ms_p = cuda_ms(lambda: nc_fused_lane.nc_stack_reference(chain, x), 1)
    layers = layer_times(torch, nc_fused_lane, "inloc chain", shape, (3, 3),
                         (32, 2), chain, x, 3)
    flops, nbytes = chain_work(shape, 3, 16)
    # what the kernel computes: the block-diagonal layer's zero blocks too
    padded = stack_work(shape, (3, 3), (32, 2))[0]
    bound_ms, bound_by = bound(flops, nbytes)
    numbers = {
        "shape": list(shape), "max_abs_err": max_abs, "normalized_err": err,
        "ms": sum(ms_c) / 2, "plain_ms": ms_p,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "two_pass_ms": sum(ms_t) / 2, "layer_ms": layers,
    }
    print(f"inloc chain: the chain on {shape} vs its twin: max_abs_err "
          f"{max_abs:.6g} normalized {err:.3e} (tolerance {TOLERANCE}; the "
          f"twin {plain_s:.2f} s with its first call); its two channels "
          f"summed vs the two-pass (16, 1) route: normalized {vs_two:.3e}; "
          f"two launches bit-identical: {same}; chain {ms_c} ms, two-pass "
          f"route {ms_t} ms, plain {ms_p:.1f} ms, {flops:.4g} FLOP "
          f"needed ({padded:.4g} computed with the zero blocks), "
          f"{nbytes:.4g} bytes, bound {numbers['bound_ms']:.4f} ms "
          f"({numbers['bound_by']}), {flops / numbers['ms'] / 1e9:.2f} "
          "TFLOP/s needed", flush=True)
    if not (err <= TOLERANCE and vs_two <= TOLERANCE and same):
        raise SystemExit("inloc chain: the chain disagrees with its twin or "
                         "the two-pass route, or is not deterministic")
    return numbers


def check_unfused(torch, dev):
    """Phase I, the unfused tap-swap form, which runs where no kernel tier
    takes the stack (fp32): ``neigh_consensus`` of the (16, 1) stack on
    the InLoc volume in fp32 (the fused 1 → 32 layer through ``tapfold``,
    the second layer and its tap-swapped twin through B5 on the two
    halves) against the two-pass form (two (16, 1) stacks through the same
    formulations, and two transposes), within ``FP32_TOLERANCE``, timed in
    turns.  Returns their ms."""
    from ncnet_tpu_torch.models import ncnet as ncnet_mod

    shape = inloc_volume(INLOC_QUERY_HW, INLOC_PANO_HW)
    params = [{k: v.float() for k, v in layer.items()}
              for layer in stack_params((3, 3), (16, 1), seed=1, device=dev)]
    g = torch.Generator(device=dev).manual_seed(5)
    corr = torch.rand(shape, generator=g, device=dev)

    def run():
        return ncnet_mod.neigh_consensus(params, corr)

    swaps = []
    with torch.no_grad():
        with routed(ncnet_mod, "_swap_ab", ncnet_mod._swap_ab, swaps):
            got = run()
        with routed(ncnet_mod, "tap_swap_fusable", lambda p: False):
            want = run()
            torch.cuda.synchronize()
        err = normalized_err(got, want)
        del got, want
        ms_u, ms_t = [], []
        for _ in range(2):  # in turns: unfused, two-pass
            ms_u.append(cuda_ms(run, 1))
            with routed(ncnet_mod, "tap_swap_fusable", lambda p: False):
                ms_t.append(cuda_ms(run, 1))
    torch.cuda.empty_cache()
    print(f"inloc unfused: fp32 (16, 1) stack on {shape}: the unfused "
          f"tap-swap form ({len(swaps)} transposes) vs the two-pass form: "
          f"normalized {err:.3e} (tolerance {FP32_TOLERANCE}); unfused "
          f"{ms_u} ms, two-pass {ms_t} ms", flush=True)
    if swaps or err > FP32_TOLERANCE:
        raise SystemExit("inloc unfused: the fp32 rectangular pass did not "
                         "take the unfused form, or disagrees with two passes")
    return {"unfused_fp32_ms": sum(ms_u) / 2, "two_pass_fp32_ms": sum(ms_t) / 2}


def write_inloc_tree(torch, dev, root, n_queries, n_panos, seed,
                     origins=None):
    """An InLoc tree of raw images (``write_inloc_like``'s layout and
    names): ``n_queries`` portrait queries of ``INLOC_QUERY_HW`` and
    ``n_panos`` landscape cutouts of ``INLOC_PANO_HW`` each, cut from its
    query (each cutout's origin in its query put in ``origins`` under its
    name, when given); returns the shortlist's path."""
    import numpy as np
    from scipy.io import savemat

    from ncnet_tpu_torch.data.datasets import raw_path

    os.makedirs(os.path.join(root, "query", "iphone7"), exist_ok=True)
    os.makedirs(os.path.join(root, "pano", "DUC1"), exist_ok=True)
    entries = np.zeros((1, n_queries), dtype=np.dtype(
        [("queryname", object), ("topNname", object)]))
    for q in range(n_queries):
        (query,) = inloc_images(torch, dev, INLOC_QUERY_HW, 1, seed + q)
        qfn = f"query_{q}.jpg"
        np.save(raw_path(os.path.join(root, "query", "iphone7", qfn)), query)
        panos, corners = [], []
        for p, img in enumerate(inloc_images(torch, dev, INLOC_PANO_HW,
                                             n_panos, seed + 100 + q, query,
                                             corners)):
            pfn = f"DUC1/DUC_cutout_{q:03d}_{p * 30}_0.jpg"
            np.save(raw_path(os.path.join(root, "pano", pfn)), img)
            panos.append(pfn)
        if origins is not None:
            origins.update(zip(panos, corners))
        entries[0, q] = (np.array([qfn]), np.array(panos, dtype=object)[:, None])
    shortlist = os.path.join(root, "shortlist.mat")
    savemat(shortlist, {"ImgList": entries})
    return shortlist


def inloc_matcher(torch, nc_fused_lane, conv4d_pallas, dev):
    """Phase I, the full-width matcher as ``bench.py:1615-1650`` builds it:
    one raw portrait query and ``INLOC_PANOS`` raw landscape cutouts at
    ``INLOC_SIDE``, dispatched at depth ``INLOC_DEPTH``; returns its B2
    launches, its config and its parameters."""
    import numpy as np

    from ncnet_tpu_torch.evaluation.inloc import (
        device_preprocess,
        make_pair_matcher,
    )
    from ncnet_tpu_torch.models import ncnet as ncnet_mod
    from ncnet_tpu_torch.models.ncnet import ncnet_forward_from_features

    cfg = inloc_config()
    (query,) = inloc_images(torch, dev, INLOC_QUERY_HW, 1, seed=21)
    panos = inloc_images(torch, dev, INLOC_PANO_HW, INLOC_PANOS + 1, seed=22,
                         source=query)
    params = inloc_params(torch, cfg, dev, query)
    matcher = make_pair_matcher(cfg, params, do_softmax=True,
                                both_directions=True, flip_direction=False,
                                preprocess_image_size=INLOC_SIDE)
    src = matcher.preprocess(query[None])
    for _ in range(2):  # warm-up on the extra cutout, not counted
        matcher(src, panos[-1][None])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nc_fused_lane.launches = 0
    # B5's count is read through the module's ``launches`` (a sum): reset
    # the kernels' counts, not that name, which would hide them
    conv4d_pallas.launches_by_kernel.update(tensor_core=0, cuda_core=0)
    # the eval loop's depth-2 pipeline: pair i+1 dispatched before pair i
    # is fetched; a pair's wall is the time between two fetches
    t0 = time.perf_counter()
    ticks, in_flight, tables = [], [], []
    for img in panos[:INLOC_PANOS]:
        in_flight.append(matcher.dispatch(src, img[None]))
        if len(in_flight) >= INLOC_DEPTH:
            tables.append(matcher.fetch(in_flight.pop(0)))
            ticks.append(time.perf_counter())
    while in_flight:
        tables.append(matcher.fetch(in_flight.pop(0)))
        ticks.append(time.perf_counter())
    launches, b5 = nc_fused_lane.launches, conv4d_pallas.launches
    tier = nc_fused_lane.last_selected_tier()
    peak = torch.cuda.max_memory_allocated()
    walls = np.diff(np.asarray([t0] + ticks)) * 1e3
    vol = inloc_volume(INLOC_QUERY_HW, INLOC_PANO_HW)
    n_rows = 2 * vol[3] * vol[4]
    print(f"inloc matcher: 1 query {INLOC_QUERY_HW} and {INLOC_PANOS} "
          f"cutouts {INLOC_PANO_HW} at {INLOC_SIDE} (pooled volume {vol}), "
          f"depth {INLOC_DEPTH}: pair walls ms {walls.round(2).tolist()}"
          f", mean {walls.mean():.2f}, p50 {np.percentile(walls, 50):.2f}, "
          f"p95 {np.percentile(walls, 95):.2f}; tier {tier!r}, B2 launches "
          f"{launches}, B5 launches {b5}; peak memory {peak} bytes", flush=True)
    bad = [i for i, t in enumerate(tables)
           if len(t[0]) != n_rows or not all(np.isfinite(c).all() for c in t)
           or not ((t[4] >= 0) & (t[4] <= 1)).all()
           or not all(((c > 0) & (c < 1)).all() for c in t[:4])]
    if tier != "resident" or launches != 2 * INLOC_PANOS or b5 or bad:
        raise SystemExit(f"inloc matcher: expected the resident tier, "
                         f"{2 * INLOC_PANOS} B2 launches (2 a pair), no B5, "
                         f"and {n_rows}-row finite tables in (0, 1); bad "
                         f"tables {bad}")

    # one pair again with the NC stack recorded: its chain call against the
    # same chain through the twins; the filtered volume against the forward
    # with the twins and against the two-pass form (the tap-swap class
    # refused)
    tgt = panos[0][None]
    calls = []
    with torch.no_grad():
        timg = device_preprocess(torch.as_tensor(tgt).to(dev), INLOC_SIDE,
                                 INLOC_K)
        with routed(nc_fused_lane, "nc_stack_resident",
                    nc_fused_lane.nc_stack_resident, calls):
            out = ncnet_forward_from_features(cfg, params, src.features, timg)
        (chain, x), _, y = calls[0]
        stack_err = normalized_err(y, nc_fused_lane.nc_stack_reference(chain, x))
        with routed(nc_fused_lane, "nc_stack_resident",
                    lambda p, v: nc_fused_lane.nc_stack_reference(p, v)):
            twin = ncnet_forward_from_features(cfg, params, src.features, timg)
        vol_twin = normalized_err(out.corr, twin.corr)
        del twin
        n_before = nc_fused_lane.launches
        with routed(ncnet_mod, "tap_swap_fusable", lambda p: False):
            two = ncnet_forward_from_features(cfg, params, src.features, timg)
        two_launches = nc_fused_lane.launches - n_before
        vol_two = normalized_err(out.corr, two.corr)
        del two
    chain_shape = [tuple(int(layer["w"].shape[5]) for layer in chain)]
    print(f"inloc matcher: pair 0's NC call {len(calls)} stack on "
          f"{tuple(x.shape)} with channels {chain_shape} vs its twin: "
          f"normalized {stack_err:.3e} (tolerance {TOLERANCE}); the filtered "
          f"volume vs the forward with the twins {vol_twin:.3e}, vs the "
          f"two-pass form ({two_launches} B2 launches) {vol_two:.3e} "
          f"(tolerance {SERVE_TOLERANCE:.4f})", flush=True)
    if len(calls) != 1 or chain_shape != [(32, 2)] or stack_err > TOLERANCE \
            or vol_twin > SERVE_TOLERANCE or vol_two > SERVE_TOLERANCE \
            or two_launches != 4:
        raise SystemExit("inloc matcher: the chain call, its twin or the "
                         "two-pass form disagree")
    inloc_stages(torch, cfg, params, src, torch.as_tensor(tgt).to(dev), timg,
                 chain, x, tables[0])
    return launches, cfg, params


def inloc_stages(torch, cfg, params, src, raw, timg, chain, x, table):
    """CUDA-event ms of each device stage of one pair (warm, one stage at
    a time; the query's trunk runs once for all its pairs) and host ms of
    the sort/dedup and of one query's savemat."""
    import tempfile

    import numpy as np

    from ncnet_tpu_torch.evaluation.inloc import (
        device_preprocess,
        extract_match_table,
        match_capacity,
        sort_and_dedup,
    )
    from ncnet_tpu_torch.models.ncnet import extract_features, ncnet_filter
    from ncnet_tpu_torch.observability.quality import append_quality_row
    from ncnet_tpu_torch.ops import nc_fused_lane
    from ncnet_tpu_torch.ops.correlation import correlation_4d
    from ncnet_tpu_torch.ops.pooling import maxpool4d_with_argmax
    from ncnet_tpu_torch.utils.io import atomic_savemat

    def readout(out):
        return append_quality_row(extract_match_table(
            out, k_size=INLOC_K, do_softmax=True, both_directions=True),
            out.corr)

    with torch.no_grad():
        fb = extract_features(cfg, params, timg)
        fa, fbb = src.features.to(torch.bfloat16), fb.to(torch.bfloat16)
        corr = correlation_4d(fa, fbb)
        out = ncnet_filter(cfg, params, corr)
        stages = {
            "cutout preprocess (normalize, resize)": cuda_ms(
                lambda: device_preprocess(raw, INLOC_SIDE, INLOC_K), 2),
            "cutout trunk": cuda_ms(
                lambda: extract_features(cfg, params, timg), 2),
            "correlation (f32 sums, bf16 out)": cuda_ms(
                lambda: correlation_4d(fa, fbb), 2),
            "pooling (maxpool4d_with_argmax)": cuda_ms(
                lambda: maxpool4d_with_argmax(corr, INLOC_K), 2),
            "filter (pooling, mutual, NC chain, mutual)": cuda_ms(
                lambda: ncnet_filter(cfg, params, corr), 2),
            "of which the NC chain (B2)": cuda_ms(
                lambda: nc_fused_lane.nc_stack_resident(chain, x), 2),
            "readout (both directions, recentring, quality row)": cuda_ms(
                lambda: readout(out), 2),
        }
    t0 = time.perf_counter()
    for _ in range(3):
        sort_and_dedup(*table)
    stages["host sort/dedup"] = (time.perf_counter() - t0) / 3 * 1e3
    n_cap = match_capacity(INLOC_SIDE, INLOC_K, True)
    matches = np.zeros((1, INLOC_PANOS, n_cap, 5))
    rows = sort_and_dedup(*table)
    for i in range(INLOC_PANOS):
        for c, v in enumerate(rows):
            matches[0, i, :len(v), c] = v[:n_cap]
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_inloc_mat_"),
                        "1.mat")
    payload = {"matches": matches, "query_fn": "query_0.jpg",
               "pano_fn": np.array([["x"]] * INLOC_PANOS, dtype=object)}
    atomic_savemat(path, payload, do_compression=True)  # warm-up
    t0 = time.perf_counter()
    atomic_savemat(path, payload, do_compression=True)
    stages[f"savemat of a query ({INLOC_PANOS} cutouts, "
           f"{os.path.getsize(path)} bytes)"] = (time.perf_counter() - t0) * 1e3
    shutil.rmtree(os.path.dirname(path))
    with torch.no_grad():
        stages["query trunk, once a query"] = cuda_ms(
            lambda: extract_features(cfg, params, src.image), 2)
    print("inloc matcher stages ms per pair: " + json.dumps(stages),
          flush=True)


def inloc_mats(out_dir, n_queries):
    """Each query's ``.mat`` content: the table and the names."""
    from scipy.io import loadmat

    return [{k: v for k, v in loadmat(os.path.join(out_dir, f"{q + 1}.mat"))
             .items() if not k.startswith("__")} for q in range(n_queries)]


def mats_equal(a, b) -> bool:
    import numpy as np

    return all(sorted(x) == sorted(y) and all(
        np.array_equal(x[k], y[k]) for k in x) for x, y in zip(a, b))


def inloc_eval(torch, nc_fused_lane, dev, cfg, params):
    """Phase I, the loop and the CLI: ``run_inloc_eval`` on a raw tree of
    ``INLOC_LOOP_QUERIES`` portrait queries and ``INLOC_LOOP_PANOS``
    landscape cutouts each; the CLI once through, killed after its first
    ``.mat`` and resumed, and run with an injected device error that
    exhausts the retry budget.  Returns the B2 launches by run and the
    tree with the loop's matches (phase P localizes them; it removes the
    tree)."""
    import io
    import tempfile

    from ncnet_tpu_torch.cli import eval_inloc as cli
    from ncnet_tpu_torch.config import EvalInLocConfig
    from ncnet_tpu_torch.evaluation.inloc import (
        match_capacity,
        run_inloc_eval,
        validate_matches_mat,
    )
    from ncnet_tpu_torch.evaluation.resilience import RunManifest
    from ncnet_tpu_torch.observability import events
    from ncnet_tpu_torch.utils import faults

    tmp = tempfile.mkdtemp(prefix="chip_smoke_inloc_")
    t0 = time.perf_counter()
    origins = {}
    shortlist = write_inloc_tree(torch, dev, tmp, INLOC_LOOP_QUERIES,
                                 INLOC_LOOP_PANOS, seed=31, origins=origins)
    fixture_s = time.perf_counter() - t0
    n_pairs = INLOC_LOOP_QUERIES * INLOC_LOOP_PANOS
    n_cap = match_capacity(INLOC_SIDE, INLOC_K, True)
    tree = dict(inloc_shortlist=shortlist, k_size=INLOC_K,
                image_size=INLOC_SIDE, n_queries=INLOC_LOOP_QUERIES,
                n_panos=INLOC_LOOP_PANOS,
                pano_path=os.path.join(tmp, "pano"),
                query_path=os.path.join(tmp, "query", "iphone7"))
    config = EvalInLocConfig(output_root=os.path.join(tmp, "loop"),
                             telemetry_dir=os.path.join(tmp, "loop_events"),
                             **tree)
    torch.cuda.synchronize()
    nc_fused_lane.launches = 0
    t0 = time.perf_counter()
    out_dir = run_inloc_eval(config, model_config=cfg, params=params,
                             progress=False)
    wall = time.perf_counter() - t0
    runs = {"inloc_eval": nc_fused_lane.launches}
    _, replayed = events.replay_events(
        os.path.join(config.telemetry_dir, "events.jsonl"))
    q_walls = [round(e["wall_s"], 3) for e in replayed
               if e["event"] == "eval_query"]
    valid = [validate_matches_mat(os.path.join(out_dir, f"{q + 1}.mat"),
                                  INLOC_LOOP_PANOS, n_cap)
             for q in range(INLOC_LOOP_QUERIES)]
    manifest = RunManifest(os.path.join(out_dir, "manifest.json"))
    retries = [e for e in replayed if e["event"] == "retry"]
    print(f"inloc eval: fixture of {INLOC_LOOP_QUERIES} queries "
          f"{INLOC_QUERY_HW} x {INLOC_LOOP_PANOS} cutouts {INLOC_PANO_HW} "
          f"written in {fixture_s:.2f} s; run_inloc_eval at {INLOC_SIDE} in "
          f"{wall:.3f} s ({n_pairs} pairs), query walls s {q_walls}; B2 "
          f"launches {runs['inloc_eval']}; every .mat valid: {valid}; "
          f"quarantined {list(manifest.quarantined_ids)}, retries "
          f"{len(retries)}", flush=True)
    if runs["inloc_eval"] != 2 * n_pairs or not all(valid) \
            or manifest.quarantined_ids or retries:
        raise SystemExit("inloc eval: expected 2 B2 launches a pair, valid "
                         "tables, no retry and no quarantine")

    # the CLI (its model from a reference checkpoint of the same weights:
    # bf16 volume and NC stack, the trunk in f32 as the reference runs it),
    # once through, then killed by an injected SIGKILL while committing its
    # second .mat and resumed: the tables equal the uninterrupted run's bit
    # for bit.  The killed run is a process of its own with PyTorch's
    # default TF32 settings, which the in-process runs take too
    ckpt = os.path.join(tmp, "ncnet_ivd.pth.tar")
    reference_checkpoint(torch, ckpt, cfg, params)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True

    def cli_args(name):
        return ["--checkpoint", ckpt, "--inloc_shortlist", shortlist,
                "--image_size", str(INLOC_SIDE),
                "--n_queries", str(INLOC_LOOP_QUERIES),
                "--n_panos", str(INLOC_LOOP_PANOS),
                "--pano_path", tree["pano_path"],
                "--query_path", tree["query_path"],
                "--retry_backoff_s", "0",
                "--output_root", os.path.join(tmp, name)]

    def cli_run(name):
        out = io.StringIO()
        nc_fused_lane.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(cli_args(name))
        return rc, out.getvalue(), time.perf_counter() - t0, \
            nc_fused_lane.launches

    rc, printed, wall, runs["inloc_cli"] = cli_run("cli")
    cli_dir = printed.split("Wrote matches to ")[-1].strip()
    full = inloc_mats(cli_dir, INLOC_LOOP_QUERIES)
    print(f"inloc cli: exit {rc} in {wall:.3f} s, B2 launches "
          f"{runs['inloc_cli']}, wrote {cli_dir}", flush=True)
    if rc != 0 or runs["inloc_cli"] != 2 * n_pairs:
        raise SystemExit("inloc cli: expected exit 0 and 2 B2 launches a pair")
    env = dict(os.environ, NCNET_TPU_FAULTS=json.dumps(
        {"kill_in_savemat_substring": f"{os.sep}2.mat"}))
    t0 = time.perf_counter()
    killed = subprocess.run(
        [sys.executable, "-m", "ncnet_tpu_torch.cli.eval_inloc"]
        + cli_args("cli_killed"), cwd=HERE, env=env, capture_output=True,
        text=True, timeout=600)
    kill_s = time.perf_counter() - t0
    killed_dir = os.path.join(tmp, "cli_killed", os.path.basename(cli_dir))
    left = sorted(os.listdir(killed_dir))
    rc2, _, wall2, runs["inloc_cli_resumed"] = cli_run("cli_killed")
    same = mats_equal(inloc_mats(killed_dir, INLOC_LOOP_QUERIES), full)
    print(f"inloc cli: a run killed while committing 2.mat (exit "
          f"{killed.returncode} after {kill_s:.1f} s, left {left}) resumed "
          f"in {wall2:.3f} s: exit {rc2}, B2 launches "
          f"{runs['inloc_cli_resumed']}; its tables vs the uninterrupted "
          f"run's: {'bit-equal' if same else 'DIFFERENT'}", flush=True)
    if killed.returncode != -9 or "1.mat" not in left or "2.mat" in left \
            or rc2 != 0 or not same \
            or runs["inloc_cli_resumed"] != 2 * INLOC_LOOP_PANOS:
        raise SystemExit("inloc cli: the killed run did not resume to the "
                         "uninterrupted result" + killed.stderr[-2000:])

    # an injected device error on every attempt at the first query's pairs
    # (three: the first try and two retries) quarantines it; the run goes
    # on and the CLI exits 2
    faults.install(faults.FaultPlan(device_fail_calls=(1, 2, 3)))
    try:
        rc3, _, wall3, runs["inloc_cli_degraded"] = cli_run("cli_degraded")
    finally:
        faults.clear()
    deg_dir = os.path.join(tmp, "cli_degraded", os.path.basename(cli_dir))
    deg = RunManifest(os.path.join(deg_dir, "manifest.json"))
    print(f"inloc cli: with a device error injected at dispatches 1-3: exit "
          f"{rc3} in {wall3:.3f} s, quarantined {list(deg.quarantined_ids)} "
          f"({deg.data['quarantined']}), B2 launches "
          f"{runs['inloc_cli_degraded']}, files {sorted(os.listdir(deg_dir))}",
          flush=True)
    if rc3 != 2 or deg.quarantined_ids != ("query_1",) \
            or not deg.is_completed("query_2") \
            or runs["inloc_cli_degraded"] != 2 * INLOC_LOOP_PANOS:
        raise SystemExit("inloc cli: the exhausted device error did not "
                         "quarantine its query or the CLI did not exit 2")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    tree = {"root": tmp, "matches_dir": out_dir, "shortlist": shortlist,
            "origins": origins, "query_path": tree["query_path"],
            "pano_path": tree["pano_path"]}
    return runs, tree


def inloc_phase(torch, nc_fused_lane, conv4d_pallas, dev):
    """Phase I; returns the chain's numbers, the B2 launches by path and
    the loop's tree of matches."""
    chain = {**check_chain(torch, nc_fused_lane, dev), **check_unfused(torch, dev)}
    launches, cfg, params = inloc_matcher(torch, nc_fused_lane, conv4d_pallas,
                                          dev)
    runs, tree = inloc_eval(torch, nc_fused_lane, dev, cfg, params)
    del params
    torch.cuda.empty_cache()
    return chain, {"inloc_matcher": launches, **runs}, tree


# ---------------------------------------------------------------------------
# phase P: InLoc localization (PnP, pose verification, curves, the CLI)
# ---------------------------------------------------------------------------


def room_texture(rng):
    """A smooth random RGB texture on the room's faces: each face's two
    in-plane coordinates, moved apart face by face, index a random grid of
    ``LOC_TEXTURE_CELL`` metres interpolated bilinearly.  Returns the
    lookup ``(…, 3) points -> (…, 3) uint8 RGB``."""
    import numpy as np

    span = max(hi - lo for lo, hi in LOC_ROOM) + 1.0
    nx = int(np.ceil(6 * span / LOC_TEXTURE_CELL)) + 2
    ny = int(np.ceil(span / LOC_TEXTURE_CELL)) + 2
    grid = (rng.random((ny, nx, 3)) * 255).astype(np.float32)
    lo, hi = np.array(LOC_ROOM).T
    # a face's in-plane axes, by its normal's axis: side walls (Z, Y),
    # floor and ceiling (X, Z), back and front walls (X, Y)
    first, second = np.array([2, 0, 0]), np.array([1, 2, 1])

    def lookup(X):
        axis = np.argmin(np.minimum(np.abs(X - lo), np.abs(X - hi)), axis=-1)
        face = 2 * axis + np.take_along_axis(
            np.abs(X - hi) < np.abs(X - lo), axis[..., None], -1)[..., 0]
        rel = X - lo
        a = np.take_along_axis(rel, first[axis][..., None], -1)[..., 0]
        b = np.take_along_axis(rel, second[axis][..., None], -1)[..., 0]
        gx = np.clip((a + face * span) / LOC_TEXTURE_CELL, 0, nx - 1.001)
        gy = np.clip(b / LOC_TEXTURE_CELL, 0, ny - 1.001)
        ix, iy = gx.astype(np.int64), gy.astype(np.int64)
        fx = (gx - ix).astype(np.float32)[..., None]
        fy = (gy - iy).astype(np.float32)[..., None]
        top = grid[iy, ix] * (1 - fx) + grid[iy, ix + 1] * fx
        bottom = grid[iy + 1, ix] * (1 - fx) + grid[iy + 1, ix + 1] * fx
        return np.round(top * (1 - fy) + bottom * fy).astype(np.uint8)

    return lookup


def room_points(P, K, hw, rows=None):
    """The room's surface points seen at the pixel centres (integer
    coordinates) of camera ``K [R | t]`` of size ``hw`` (a camera inside
    the box sees, along each ray, the nearest face crossing), ``(H, W, 3)``
    float64; ``rows``: a range of pixel rows only."""
    import numpy as np

    h, w = hw
    rows = range(h) if rows is None else rows
    R, t = P[:, :3], P[:, 3]
    C = -R.T @ t
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.asarray(rows, dtype=np.float64), indexing="xy")
    d = np.stack([u, v, np.ones_like(u)], axis=-1) @ np.linalg.inv(K).T @ R
    lam = np.full(d.shape[:-1], np.inf)
    with np.errstate(divide="ignore", invalid="ignore"):
        for a, bounds in enumerate(LOC_ROOM):
            for bound in bounds:
                hit = (bound - C[a]) / d[..., a]
                lam = np.where((hit > 0) & (hit < lam), hit, lam)
    return C + lam[..., None] * d


def camera(yaw_deg, centre, pitch_deg=0.0, roll_deg=0.0):
    """World→camera pose ``[R | t]`` of a camera at ``centre`` looking
    along +Z turned by ``yaw`` (about Y), ``pitch`` (about X) and ``roll``
    (about Z), in degrees."""
    import numpy as np

    a, b, c = np.deg2rad([yaw_deg, pitch_deg, roll_deg])
    ry = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                   [-np.sin(a), 0, np.cos(a)]])
    rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)],
                   [0, np.sin(b), np.cos(b)]])
    rz = np.array([[np.cos(c), -np.sin(c), 0], [np.sin(c), np.cos(c), 0],
                   [0, 0, 1]])
    R = (ry @ rx @ rz).T
    return np.concatenate([R, (-R @ np.asarray(centre))[:, None]], axis=1)


def write_transformation(path, P_after):
    """A WUSTL-style transformation text file whose last 4 × 4 block is
    ``P_after`` (scan-local → global)."""
    import numpy as np

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for title, m in (("P_before", np.linalg.inv(P_after)),
                         ("P_after", P_after)):
            f.write(f"{title}\n")
            for row in m:
                f.write(" ".join(f"{v:.15f}" for v in row) + "\n")


def write_scan(path, xyz_local, rgb):
    """A ``*_scan_*.ptx.mat``: the cell row ``A`` = {X, Y, Z, intensity,
    R, G, B} of columns, as the reference's scans store it."""
    import numpy as np
    from scipy.io import savemat

    A = np.empty((1, 7), dtype=object)
    cols = [xyz_local[:, 0], xyz_local[:, 1], xyz_local[:, 2],
            np.ones(len(rgb), np.uint8), rgb[:, 0], rgb[:, 1], rgb[:, 2]]
    for i, col in enumerate(cols):
        A[0, i] = np.ascontiguousarray(col).reshape(-1, 1)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    savemat(path, {"A": A})


def write_refposes(path, poses):
    """``DUC_refposes_all.mat``'s layout: the ``DUC1_RefList`` of
    ``{queryname: P}`` and an empty ``DUC2_RefList``."""
    import numpy as np
    from scipy.io import savemat

    ref = np.empty((len(poses),), dtype=[("queryname", object), ("P", object)])
    for i, (name, P) in enumerate(poses.items()):
        ref["queryname"][i] = name
        ref["P"][i] = P
    savemat(path, {"DUC1_RefList": ref.reshape(1, -1),
                   "DUC2_RefList": ref[:0].reshape(1, -1)})


def write_localization_scene(root, seed=41):
    """An InLoc localization scene of known geometry, written with numpy:
    a textured room (``LOC_ROOM``); a raw portrait query of ``INLOC_QUERY_HW`` seen from a
    known pose (its focal the iPhone 7 default, so ``query_focal_length=0``
    applies); ``LOC_CUTOUTS`` cutouts of ``INLOC_PANO_HW`` of one scan with
    their ``XYZcut`` maps in scan-local coordinates and the scan's WUSTL
    transformation; the scan's point cloud (about ``LOC_SCAN_POINTS``, on
    the faces over the query's view); a shortlist with the true cutout at
    ``LOC_TRUE_SLOT``; one matches ``.mat`` (``LOC_ROWS`` rows a cutout:
    the true cutout ``LOC_GOOD_ROWS`` from the geometry with
    ``LOC_NOISE_PX`` of Gaussian noise on the query side at score 0.9, then
    junk rows at uniform scores, the decoys only junk, every cutout
    ``LOC_PAD_ROWS`` rows of zeros); the reference poses.  Returns
    ``LocalizationConfig`` keyword arguments, the true pose and the scan's
    point count."""
    import numpy as np
    from scipy.io import savemat

    from ncnet_tpu_torch.data.datasets import raw_path
    from ncnet_tpu_torch.localization import geometry

    query_hw, cutout_hw, n_cutouts = INLOC_QUERY_HW, INLOC_PANO_HW, LOC_CUTOUTS
    rows, good_rows, pad_rows = LOC_ROWS, LOC_GOOD_ROWS, LOC_PAD_ROWS
    rng = np.random.default_rng(seed)
    qh, qw = query_hw
    Kq = geometry.intrinsics(geometry.iphone7_focal(qh, qw), qh, qw)
    P_q = camera(4.0, (0.3, -0.2, 0.4), pitch_deg=-2.0, roll_deg=1.0)
    texture = room_texture(rng)
    P_after = np.eye(4)
    P_after[:3] = camera(23.0, (0.3, -0.2, 0.1))
    to_local = np.linalg.inv(P_after)

    # the query, band by band (a 4032 × 3024 image is 12 M rays)
    query = np.zeros((qh, qw, 3), np.uint8)
    for r0 in range(0, qh, 512):
        query[r0:r0 + 512] = texture(room_points(
            P_q, Kq, query_hw, range(r0, min(qh, r0 + 512))))
    qdir = os.path.join(root, "query")
    os.makedirs(qdir, exist_ok=True)
    np.save(raw_path(os.path.join(qdir, "query_0.jpg")), query)

    # the scan: a regular grid on each face over the part the query sees
    # (a coarse cast, 0.2 m of margin), in scan-local coordinates
    seen = room_points(P_q, Kq, query_hw, range(0, qh, 16))[:, ::16]
    seen = seen.reshape(-1, 3)
    boxes = []
    for a, bounds in enumerate(LOC_ROOM):
        for bound in bounds:
            on = seen[np.abs(seen[:, a] - bound) < 1e-9]
            if len(on):
                lo = np.maximum(on.min(0) - 0.2, [b[0] for b in LOC_ROOM])
                hi = np.minimum(on.max(0) + 0.2, [b[1] for b in LOC_ROOM])
                boxes.append((a, bound, lo, hi))
    area = sum(np.prod(np.delete(hi - lo, a)) for a, _, lo, hi in boxes)
    step = np.sqrt(area / LOC_SCAN_POINTS)
    faces = []
    for a, bound, lo, hi in boxes:
        i, j = [k for k in range(3) if k != a]
        gi, gj = np.meshgrid(np.arange(lo[i], hi[i], step),
                             np.arange(lo[j], hi[j], step), indexing="xy")
        f = np.empty((gi.size, 3))
        f[:, a], f[:, i], f[:, j] = bound, gi.ravel(), gj.ravel()
        faces.append(f)
    pts = np.concatenate(faces)
    write_scan(os.path.join(root, "scans", "DUC1", "DUC_scan_001.ptx.mat"),
               pts @ to_local[:3, :3].T + to_local[:3, 3], texture(pts))
    write_transformation(os.path.join(root, "DUC1", "transformations",
                                      "DUC_trans_001.txt"), P_after)

    # cutouts: the true one looks where the query looks, the decoys aside
    ch, cw = cutout_hw
    Kdb = geometry.intrinsics(0.625 * cw, ch, cw)  # 77 degrees wide
    yaws = [3.0] + [(-1) ** i * (10.0 + 4.0 * i) for i in range(n_cutouts - 1)]
    names = [f"DUC1/DUC_cutout_001_{30 * i}_0.jpg" for i in range(n_cutouts)]
    order = list(range(1, n_cutouts))
    order.insert(LOC_TRUE_SLOT, 0)
    table = np.zeros((1, n_cutouts, rows, 5))
    for slot, i in enumerate(order):
        xyz = room_points(camera(yaws[i], (-0.2, 0.1, 0.0)), Kdb, cutout_hw)
        local = xyz @ to_local[:3, :3].T + to_local[:3, 3]
        os.makedirs(os.path.join(root, "cutouts", "DUC1"), exist_ok=True)
        savemat(os.path.join(root, "cutouts", names[i] + ".mat"),
                {"XYZcut": local})
        n_good = 0
        if i == 0:
            pick = rng.choice(ch * cw, size=3 * good_rows, replace=False)
            r, c = pick // cw, pick % cw
            xy, depth = geometry.project_points(P_q, Kq, xyz[r, c])
            xy = xy + rng.normal(0.0, LOC_NOISE_PX, xy.shape)
            ok = ((depth > 0) & (xy[:, 0] >= 0) & (xy[:, 0] < qw)
                  & (xy[:, 1] >= 0) & (xy[:, 1] < qh))
            sel = np.flatnonzero(ok)[:good_rows]
            n_good = len(sel)
            good = table[0, slot, :n_good]
            good[:, 0] = xy[sel, 0] / qw
            good[:, 1] = xy[sel, 1] / qh
            good[:, 2] = (c[sel] + 1.5) / cw  # gathers back to (r, c)
            good[:, 3] = (r[sel] + 1.5) / ch
            good[:, 4] = 0.9
        junk = table[0, slot, n_good:rows - pad_rows]
        junk[:] = rng.random(junk.shape)
    os.makedirs(os.path.join(root, "matches"), exist_ok=True)
    savemat(os.path.join(root, "matches", "1.mat"), {"matches": table})
    entries = np.zeros((1, 1), dtype=np.dtype(
        [("queryname", object), ("topNname", object)]))
    entries[0, 0] = (np.array(["query_0.jpg"]),
                     np.array([names[i] for i in order], dtype=object)[:, None])
    savemat(os.path.join(root, "shortlist.mat"), {"ImgList": entries})
    write_refposes(os.path.join(root, "refposes.mat"), {"query_0.jpg": P_q})
    return dict(matches_dir=os.path.join(root, "matches"),
                shortlist=os.path.join(root, "shortlist.mat"),
                query_path=qdir, cutout_path=os.path.join(root, "cutouts"),
                scan_path=os.path.join(root, "scans"),
                transformation_path=root,
                refposes=os.path.join(root, "refposes.mat"),
                progress=False), P_q, len(pts)


class StageClock:
    """Per-call times of the localization stage's functions for one run,
    each wrapped in its module: a call of a *unit* function (one pair's
    RANSAC, one verification item) opens a record, and the calls of its
    *parts* inside add their ms to it, on the host clock or, for the device
    stages, as CUDA events read after the run."""

    def __init__(self, torch):
        self.torch = torch
        self.units = {}
        self.walls = {}
        self._saved = []

    def _wrap(self, module, name, fn):
        self._saved.append((module, name, getattr(module, name)))
        setattr(module, name, fn(getattr(module, name)))

    def unit(self, module, name, kind, describe=None):
        def make(orig):
            def run(*args, **kwargs):
                rec = dict(describe(*args) if describe else {})
                self.units.setdefault(kind, []).append(rec)
                t0 = time.perf_counter()
                out = orig(*args, **kwargs)
                rec["wall"] = (time.perf_counter() - t0) * 1e3
                return out
            return run
        self._wrap(module, name, make)

    def part(self, module, name, kind, key, events=False):
        torch = self.torch

        def make(orig):
            def run(*args, **kwargs):
                rec = self.units[kind][-1]
                if events:
                    start, end = (torch.cuda.Event(enable_timing=True)
                                  for _ in range(2))
                    start.record()
                    out = orig(*args, **kwargs)
                    end.record()
                    rec.setdefault(key, []).append((start, end))
                else:
                    t0 = time.perf_counter()
                    out = orig(*args, **kwargs)
                    rec.setdefault(key, []).append(
                        (time.perf_counter() - t0) * 1e3)
                return out
            return run
        self._wrap(module, name, make)

    def wall(self, module, name, key):
        def make(orig):
            def run(*args, **kwargs):
                t0 = time.perf_counter()
                out = orig(*args, **kwargs)
                self.walls.setdefault(key, []).append(
                    (time.perf_counter() - t0) * 1e3)
                return out
            return run
        self._wrap(module, name, make)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for module, name, orig in reversed(self._saved):
            setattr(module, name, orig)
        self.torch.cuda.synchronize()
        for recs in self.units.values():
            for rec in recs:
                for key, vals in rec.items():
                    if isinstance(vals, list):
                        rec[key] = [v if isinstance(v, float)
                                    else v[0].elapsed_time(v[1]) for v in vals]


def localization_clock(torch):
    """The stage clock over the localization modules: a pair's sampling,
    ``p3p_solve``, scoring (CUDA events; the first call, the later ones are
    the LO's re-scoring) and LO refinement; an item's render, inpainting,
    dense SIFT (CUDA events, the query's and the render's) and score; the
    stage and query walls."""
    from ncnet_tpu_torch.localization import (
        driver,
        dsift,
        p3p,
        pnp,
        verification,
    )

    clock = StageClock(torch)
    clock.unit(pnp, "lo_ransac_p3p", "pair", lambda rays, X, *a: {
        "tentatives": len(rays)})
    clock.part(p3p, "sample_triples", "pair", "sampling")
    clock.part(p3p, "p3p_solve", "pair", "p3p_solve")
    clock.part(p3p, "_score_hypotheses", "pair", "scoring", events=True)
    clock.part(p3p, "refine_pose_object_space", "pair", "lo_refine")
    clock.unit(verification, "verify_pose_downsampled", "item")
    clock.part(verification, "render_points_perspective", "item", "render")
    clock.part(dsift, "inpaint_nans", "item", "inpaint")
    clock.part(dsift, "dense_sift", "item", "dense_sift", events=True)
    clock.part(verification, "pose_verification_score", "item", "score")
    clock.wall(driver, "run_pnp_stage", "pnp_stage")
    clock.wall(driver, "run_pv_stage", "pv_stage")
    clock.wall(driver, "_pnp_one_query", "query")
    return clock


def clock_lines(clock):
    """The stage clock's records as printable lists of ms."""
    r = lambda xs: [round(x, 2) for x in xs]  # noqa: E731
    pairs = clock.units.get("pair", [])
    items = clock.units.get("item", [])
    return {
        "pairs": {
            "tentatives": [p["tentatives"] for p in pairs],
            "sampling": r(sum(p.get("sampling", [])) for p in pairs),
            "p3p_solve": r(sum(p.get("p3p_solve", [])) for p in pairs),
            "scoring": r(p["scoring"][0] if p.get("scoring") else 0.0
                         for p in pairs),
            "lo": r(sum(p.get("lo_refine", [])) + sum(p.get("scoring", [])[1:])
                    for p in pairs),
            "wall": r(p["wall"] for p in pairs)},
        "items": {key: r(sum(it.get(key, [])) for it in items)
                  for key in ("render", "inpaint", "dense_sift", "score")}
        | {"wall": r(it["wall"] for it in items)},
        "walls": {k: r(v) for k, v in clock.walls.items()}}


def imglists_equal(a, b) -> bool:
    """Two ImgLists equal bit for bit: names, scores, poses."""
    import numpy as np

    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if (x["queryname"] != y["queryname"] or x["topNname"] != y["topNname"]
                or len(x["P"]) != len(y["P"])
                or not np.array_equal(x["topNscore"], y["topNscore"])):
            return False
        if not all(np.array_equal(p, q, equal_nan=True)
                   for p, q in zip(x["P"], y["P"])):
            return False
    return True


def stage_imglists(config):
    """The PnP and pose-verification ImgLists a run left on disk."""
    from ncnet_tpu_torch.localization import driver

    out = config.output_dir
    return (driver._load_imglist(os.path.join(out, driver._pnp_matname(config))),
            driver._load_imglist(os.path.join(out, driver._pv_matname(config))))


def check_scorer(torch, dev, config, pair_dir, name):
    """Phase P: the scorer on one pair's own hypotheses (the run's seed
    redrawn and solved again from the pair's tentatives) on the card with
    TF32 forced on for matmuls and convolutions, against TF32 off (equal,
    every decision) and the CPU: every decision equal where the float64
    cosine (computed on the card) lies more than 16 f32 ulps from the
    threshold, counts equal for hypotheses without such a point, and the
    best index equal."""
    import numpy as np
    from scipy.io import loadmat

    from ncnet_tpu_torch.localization import p3p
    from ncnet_tpu_torch.localization.pnp import artifact_stem

    t3d = loadmat(os.path.join(pair_dir, artifact_stem(name)
                               + ".pnp_nc4d_inlier.mat"))["tentatives_3d"]
    rays, X = t3d[:3].T, t3d[3:].T
    rng = np.random.default_rng(config.seed)
    pri = p3p.sample_triples(rng, config.ransac_iters, len(rays))
    poses = p3p.p3p_solve(rays[pri], X[pri]).reshape(-1, 3, 4)
    poses = poses[np.isfinite(poses[:, 0, 0])]
    thr = np.deg2rad(config.pnp_inlier_thr_deg)
    cos_thr = np.float32(np.cos(thr))
    ulp = float(np.spacing(cos_thr))
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, torch.get_float32_matmul_precision())

    def set_tf32(on):
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        torch.set_float32_matmul_precision("high" if on else "highest")

    def masks(P, device):
        Pt = torch.from_numpy(P.astype(np.float32)).to(device)
        return p3p._inlier_mask(
            Pt[:, :, :3], Pt[:, :, 3],
            torch.from_numpy(rays.astype(np.float32)).to(device),
            torch.from_numpy(X.astype(np.float32)).to(device),
            torch.ones(len(rays), dtype=torch.bool, device=device),
            torch.tensor(cos_thr, device=device)).to(dev)

    rays64, X64 = (torch.from_numpy(a).to(dev) for a in (rays, X))
    band_points = band_hyps = diff_counts = 0
    for lo in range(0, len(poses), 2048):
        P = poses[lo:lo + 2048]
        set_tf32(True)
        on = masks(P, dev)
        set_tf32(False)
        off = masks(P, dev)
        cpu = masks(P, "cpu")
        P64 = torch.from_numpy(P).to(dev)
        xc = torch.einsum("hij,nj->hni", P64[:, :, :3], X64) \
            + P64[:, None, :, 3]
        cos = torch.einsum("hni,ni->hn", xc, rays64) / xc.norm(dim=-1)
        band = (cos - float(cos_thr)).abs() <= 16 * ulp
        if not torch.equal(on, off) or not torch.equal(
                on[~band], cpu[~band]) or not torch.equal(
                on[~band], (cos > float(cos_thr))[~band]):
            raise SystemExit("localization: the scorer's decisions changed "
                             "with TF32 or off the card outside the band")
        counts_on, counts_cpu = on.sum(1), cpu.sum(1)
        clean = band.sum(1) == 0
        if not torch.equal(counts_on[clean], counts_cpu[clean]):
            raise SystemExit("localization: card and CPU counts differ")
        band_points += int(band.sum())
        band_hyps += int((~clean).sum())
        diff_counts += int((counts_on != counts_cpu).sum())
    set_tf32(True)
    best_on = p3p._score_hypotheses(poses, rays, X, thr, device=dev)
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     precision) = tf32
    torch.set_float32_matmul_precision(precision)
    best_cpu = p3p._score_hypotheses(poses, rays, X, thr, device="cpu")
    print(f"localization scorer: {len(poses)} hypotheses x {len(rays)} "
          f"tentatives of the true pair; TF32 forced on == off on the card "
          f"(every decision); {band_points} cosines of {band_hyps} hypotheses "
          f"within 16 f32 ulps of the threshold, {diff_counts} counts differ "
          f"card vs CPU (each within its band); best (index, count) card "
          f"{best_on[:2]} CPU {best_cpu[:2]}", flush=True)
    if best_on[:2] != best_cpu[:2] or not np.array_equal(best_on[2],
                                                          best_cpu[2]):
        raise SystemExit("localization: the best hypothesis differs between "
                         "the card and the CPU")


def check_dense_sift(torch, dev, query):
    """Phase P: ``dense_sift`` on the query's 1/8 gray image on the card
    under PyTorch's default TF32 settings (cuDNN's on) against the CPU,
    within 1e-5."""
    import numpy as np

    from ncnet_tpu_torch.localization.dsift import dense_sift, rgb_to_gray
    from ncnet_tpu_torch.localization.verification import downsample_image

    gray = rgb_to_gray(downsample_image(query))
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    got = dense_sift(gray, device=dev)
    ms = cuda_ms(lambda: dense_sift(gray, device=dev), 5)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    t0 = time.perf_counter()
    want = dense_sift(gray, device="cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    err = float(np.abs(got - want).max())
    print(f"localization dense_sift: query at 1/8 {gray.shape} -> "
          f"{got.shape} on the card (default TF32 settings) {ms:.3f} ms a "
          f"call with its copies, CPU {cpu_ms:.1f} ms; max abs err vs the "
          f"CPU {err:.3g} (tolerance 1e-5)", flush=True)
    if got.shape != want.shape or not err <= 1e-5:
        raise SystemExit("localization: dense_sift on the card disagrees "
                         "with the CPU")


def localization_scene_run(torch, dev):
    """Phase P, part 1: the stage at ``LocalizationConfig``'s defaults on
    the synthetic wall (``write_localization_scene``)."""
    import dataclasses
    import tempfile

    import numpy as np
    from scipy.io import loadmat

    from ncnet_tpu_torch.config import LocalizationConfig
    from ncnet_tpu_torch.data.datasets import load_image
    from ncnet_tpu_torch.localization import driver, geometry
    from ncnet_tpu_torch.localization.curves import ERROR_THRESHOLDS
    from ncnet_tpu_torch.localization.pnp import artifact_stem

    tmp = tempfile.mkdtemp(prefix="chip_smoke_loc_")
    t0 = time.perf_counter()
    kw, P_true, n_points = write_localization_scene(tmp)
    scene_s = time.perf_counter() - t0
    config = LocalizationConfig(output_dir=os.path.join(tmp, "out"), **kw)
    print(f"localization scene: a room seen by a {INLOC_QUERY_HW} query, "
          f"{LOC_CUTOUTS} cutouts {INLOC_PANO_HW} (the true one at shortlist "
          f"slot {LOC_TRUE_SLOT}), {LOC_ROWS} match rows a cutout "
          f"({LOC_GOOD_ROWS} from the geometry on the true one, "
          f"{LOC_NOISE_PX} px noise), a scan of {n_points} points; written "
          f"in {scene_s:.2f} s; config: top {config.pnp_topN}, score > "
          f"{config.match_score_thr}, {config.pnp_inlier_thr_deg} deg, "
          f"{config.ransac_iters} samples, pose verification "
          f"{config.do_pose_verification}", flush=True)

    torch.cuda.synchronize()
    with localization_clock(torch) as clock:
        t0 = time.perf_counter()
        curves = driver.run_localization(config)
        wall = time.perf_counter() - t0
    lines = clock_lines(clock)
    pe, pv = stage_imglists(config)
    true_name = "DUC1/DUC_cutout_001_0_0.jpg"
    i25 = int(np.flatnonzero(ERROR_THRESHOLDS == 0.25)[0])
    rates = {k: float(v[i25]) for k, v in curves.items()}
    k = pe[0]["topNname"].index(true_name)
    dp, do = geometry.pose_distance(P_true, pe[0]["P"][k])
    print(f"localization run (card, workers 0): {wall:.3f} s; per pair "
          f"{lines['pairs']}; per verification item {lines['items']}; stage "
          f"and query walls {lines['walls']}", flush=True)
    print(f"localization: DensePE top 1 {pe[0]['topNname'][0]}, the true "
          f"cutout's pose {dp * 100:.3f} cm / {np.rad2deg(do):.4f} deg from "
          f"the truth; pose verification's order {pv[0]['topNname'][:3]} "
          f"scores {np.round(pv[0]['topNscore'][:3], 4).tolist()}; localized "
          f"@0.25 m {rates}", flush=True)
    if pe[0]["topNname"][0] == true_name or k != LOC_TRUE_SLOT \
            or not (dp < LOC_POSE_BOUND[0]
                    and np.rad2deg(do) < LOC_POSE_BOUND[1]) \
            or pv[0]["topNname"][0] != true_name \
            or rates["InLoc + NCNet"] != 1.0:
        raise SystemExit("localization: the true pose was not recovered or "
                         "not verified first")

    pair_dir = os.path.join(config.output_dir, driver._pnp_dirname(config),
                            "query_0.jpg")
    check_scorer(torch, dev, config, pair_dir, true_name)
    check_dense_sift(torch, dev, load_image(os.path.join(
        config.query_path, "query_0.jpg")))

    # the first two pairs (the decoy and the true cutout) on the card, on
    # the CPU (where the inlier masks agree the poses are bit-equal) and
    # with 2 workers on the card (the same ImgLists)
    def two_pairs(name, **kw):
        c = dataclasses.replace(config, pnp_topN=2,
                                output_dir=os.path.join(tmp, name), **kw)
        t0 = time.perf_counter()
        driver.run_localization(c, device="cpu" if name == "cpu" else None)
        return c, time.perf_counter() - t0

    card2, card_s = two_pairs("card_2")
    cpu2, cpu_s = two_pairs("cpu")
    w2, w_s = two_pairs("workers_2", num_workers=2)
    dirs = [os.path.join(c.output_dir, driver._pnp_dirname(c), "query_0.jpg")
            for c in (card2, cpu2)]
    (card_pe, _), (cpu_pe, _) = stage_imglists(card2), stage_imglists(cpu2)
    agree = []
    for j, name in enumerate(card_pe[0]["topNname"]):
        art = artifact_stem(name) + ".pnp_nc4d_inlier.mat"
        same_mask = np.array_equal(*(loadmat(os.path.join(d, art))["inls"]
                                     for d in dirs))
        same_pose = np.array_equal(card_pe[0]["P"][j], cpu_pe[0]["P"][j],
                                   equal_nan=True)
        agree.append((same_mask, same_pose))
        if same_mask and not same_pose:
            raise SystemExit(f"localization: {name}: the masks agree, the "
                             "poses differ between the card and the CPU")
    same = [imglists_equal(a, b)
            for a, b in zip(stage_imglists(w2), stage_imglists(card2))]
    print(f"localization, the first 2 pairs: the card {card_s:.2f} s, the "
          f"CPU {cpu_s:.2f} s ((mask equal, pose bit-equal) by pair "
          f"{agree}), 2 workers on the card {w_s:.2f} s (ImgLists (PnP, pose "
          f"verification) equal to the in-process run's: {same})", flush=True)
    if not all(same):
        raise SystemExit("localization: the pooled run's ImgLists differ")
    shutil.rmtree(tmp)
    return {"wall_s": wall, "two_pairs_s": [card_s, cpu_s, w_s], **lines}


def write_tree_geometry(tree):
    """Phase P, part 2: geometry for phase I's tree, whose cutouts are
    crops of their query at known origins: the query camera at the
    identity pose with the iPhone 7 focal, facing the wall ``Z =
    LOC_TREE_DEPTH``.  Each cutout's ``XYZcut`` holds the wall point the
    reference's floor-gather reads at its pixel, each query's scan the
    query's pixels every 4 px, the transformations are identities and the
    reference poses ``[I | 0]``.  Returns ``LocalizationConfig`` keyword
    arguments."""
    import numpy as np
    from scipy.io import savemat

    from ncnet_tpu_torch.data.datasets import load_image
    from ncnet_tpu_torch.localization import geometry
    from ncnet_tpu_torch.localization.scan import parse_cutout_name

    root = tree["root"]
    qh, qw = INLOC_QUERY_HW
    Kinv = np.linalg.inv(geometry.intrinsics(geometry.iphone7_focal(qh, qw),
                                             qh, qw))
    ch, cw = INLOC_PANO_HW
    for name, (y0, x0) in tree["origins"].items():
        # the gather reads pixel floor(W x) - 1 at normalized x: the cell
        # whose continuous coordinate is c + 1.5
        u, v = np.meshgrid(x0 + np.arange(cw) + 1.5, y0 + np.arange(ch) + 1.5,
                           indexing="xy")
        xyz = np.stack([u, v, np.ones_like(u)], -1) @ Kinv.T * LOC_TREE_DEPTH
        savemat(os.path.join(tree["pano_path"], name + ".mat"),
                {"XYZcut": xyz})
    scans = sorted({parse_cutout_name(n).scan_id for n in tree["origins"]})
    P0 = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
    for q, scan in enumerate(scans):
        query = load_image(os.path.join(tree["query_path"], f"query_{q}.jpg"))
        u, v = np.meshgrid(np.arange(0, qw, 4.0), np.arange(0, qh, 4.0),
                           indexing="xy")
        xyz = np.stack([u, v, np.ones_like(u)], -1) @ Kinv.T * LOC_TREE_DEPTH
        write_scan(os.path.join(root, "scans", "DUC1",
                                f"DUC_scan_{scan}.ptx.mat"),
                   xyz.reshape(-1, 3), query[::4, ::4].reshape(-1, 3))
        write_transformation(os.path.join(root, "DUC1", "transformations",
                                          f"DUC_trans_{scan}.txt"), np.eye(4))
    write_refposes(os.path.join(root, "refposes.mat"),
                   {f"query_{q}.jpg": P0 for q in range(len(scans))})
    return dict(matches_dir=tree["matches_dir"], shortlist=tree["shortlist"],
                query_path=tree["query_path"], cutout_path=tree["pano_path"],
                scan_path=os.path.join(root, "scans"),
                transformation_path=root,
                refposes=os.path.join(root, "refposes.mat"))


def localization_composition(torch, tree):
    """Phase P, part 2: the stage on the matches phase I's
    ``run_inloc_eval`` wrote (random weights: the rate is printed, not
    gated), then the CLI once through, again (its artifacts reloaded, the
    ImgLists bit-equal) and with one query's matches ``.mat`` corrupted
    (that query quarantined, exit 2)."""
    import io

    import numpy as np
    from scipy.io import loadmat

    from ncnet_tpu_torch.cli import compute_localization as cli
    from ncnet_tpu_torch.config import LocalizationConfig
    from ncnet_tpu_torch.evaluation.resilience import RunManifest
    from ncnet_tpu_torch.localization import driver
    from ncnet_tpu_torch.localization.curves import ERROR_THRESHOLDS

    t0 = time.perf_counter()
    kw = write_tree_geometry(tree)
    geo_s = time.perf_counter() - t0
    root = tree["root"]
    config = LocalizationConfig(output_dir=os.path.join(root, "loc"),
                                progress=False, **kw)
    t0 = time.perf_counter()
    curves = driver.run_localization(config)
    wall = time.perf_counter() - t0
    mats = [os.path.join(d, f) for d, _, fs in os.walk(config.output_dir)
            for f in fs if f.endswith(".mat")]
    for path in mats:
        loadmat(path)
    errors = {f: len(open(os.path.join(config.output_dir, f)).readlines())
              for f in os.listdir(config.output_dir) if f.startswith("error_")}
    i = {d: int(np.flatnonzero(ERROR_THRESHOLDS == d)[0])
         for d in (0.25, 0.5, 1.0)}
    rates = {k: [float(v[j]) for j in i.values()] for k, v in curves.items()}
    pe, _ = stage_imglists(config)
    print(f"localization of phase I's matches ({INLOC_LOOP_QUERIES} queries x "
          f"{INLOC_LOOP_PANOS} cutouts, random weights): geometry written in "
          f"{geo_s:.2f} s, run_localization {wall:.3f} s; {len(mats)} .mat "
          f"files all readable; error lines {errors}; localized @0.25/0.5/1 m "
          f"{rates} (printed, not gated); finite poses "
          f"{[int(np.isfinite(np.stack(e['P'])).all(axis=(1, 2)).sum()) for e in pe]}",
          flush=True)
    if set(errors.values()) != {INLOC_LOOP_QUERIES} or len(errors) != 2:
        raise SystemExit("localization: expected two error files of one "
                         "line a query")

    args = ["--matches_dir", kw["matches_dir"], "--shortlist", kw["shortlist"],
            "--query_path", kw["query_path"], "--cutout_path",
            kw["cutout_path"], "--scan_path", kw["scan_path"],
            "--transformation_path", root, "--refposes", kw["refposes"],
            "--retry_backoff_s", "0"]

    def cli_run(out_dir, matches=None):
        argv = list(args) + ["--output_dir", out_dir]
        if matches:
            argv[1] = matches
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        return rc, out.getvalue(), time.perf_counter() - t0

    cli_dir = os.path.join(root, "loc_cli")
    cli_config = LocalizationConfig(output_dir=cli_dir, **kw)
    rc1, out1, s1 = cli_run(cli_dir)
    first = stage_imglists(cli_config)
    stamps = {f: os.path.getmtime(os.path.join(cli_dir, f))
              for f in os.listdir(cli_dir) if f.endswith(".mat")}
    rc2, out2, s2 = cli_run(cli_dir)
    same = all(imglists_equal(a, b)
               for a, b in zip(stage_imglists(cli_config), first))
    kept = stamps == {f: os.path.getmtime(os.path.join(cli_dir, f))
                      for f in stamps}
    rates1 = [ln for ln in out1.splitlines() if "localized @" in ln]
    rates2 = [ln for ln in out2.splitlines() if "localized @" in ln]
    bad = os.path.join(root, "matches_corrupted")
    shutil.copytree(kw["matches_dir"], bad)
    with open(os.path.join(bad, "1.mat"), "wb") as f:
        f.write(b"not a .mat file")
    bad_dir = os.path.join(root, "loc_cli_bad")
    rc3, out3, s3 = cli_run(bad_dir, matches=bad)
    manifest = RunManifest(os.path.join(
        bad_dir, driver._pnp_dirname(cli_config), "manifest.json"))
    print(f"localization cli: exit {rc1} in {s1:.3f} s {rates1}; again "
          f"(reloading) exit {rc2} in {s2:.3f} s, stage .mat files untouched "
          f"{kept}, ImgLists bit-equal {same}, same lines {rates1 == rates2}; "
          f"with 1.mat corrupted exit {rc3} in {s3:.3f} s, quarantined "
          f"{list(manifest.quarantined_ids)}", flush=True)
    if rc1 != 0 or rc2 != 0 or not same or not kept or rates1 != rates2 \
            or rc3 != 2 or manifest.quarantined_ids != ("query_0.jpg",) \
            or not manifest.is_completed("query_1.jpg"):
        raise SystemExit("localization cli: expected exit 0, a reloading "
                         "rerun with the same ImgLists, and a corrupted "
                         "query quarantined with exit 2")
    return {"wall_s": wall, "cli_s": [s1, s2, s3]}


def localization_phase(torch, dev, tree):
    """Phase P: the localization stage on the synthetic wall at its
    published settings, then on phase I's matches and through its CLI;
    removes phase I's tree."""
    t0 = time.perf_counter()
    scene = localization_scene_run(torch, dev)
    composed = localization_composition(torch, tree)
    shutil.rmtree(tree["root"])
    print(f"localization: phase P in {time.perf_counter() - t0:.1f} s on "
          f"{card_line()}", flush=True)
    return {"scene": scene, "composition": composed}

# ---------------------------------------------------------------------------
# phase Q: sharded retrieval (the coarse index built on the card, the shard
# hosts and the coordinator, the InLoc in-system shortlist feeding B6)
# ---------------------------------------------------------------------------


def retrieval_hue(i):
    """The two hue levels of structure ``i`` (``retrieval_image``)."""
    return (37 * i + 20) % 256, (91 * i + 13) % 256


def retrieval_distractor_ids(n):
    """``n`` structure indices whose hue levels lie at least 40 levels
    (L1 over the two hue channels) from both queries' (indices 0 and 1)."""
    out, i = [], 2
    while len(out) < n:
        if all(sum(abs(a - b) for a, b in zip(retrieval_hue(i),
                                               retrieval_hue(q))) >= 40
               for q in (0, 1)):
            out.append(i)
        i += 1
    return out


def retrieval_image(torch, dev, hw, i, seed):
    """A structured uint8 ``(H, W, 3)`` image made on the card: the hue
    levels and stripe cadence of structure ``i`` under a seeded smooth
    texture (phase I's) at 0.4.  The raw extractor scores pure noise images
    all alike (cosine ~0.9999), so a noise tree could show no ranking."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h, w = hw
    base = torch.zeros((3, h, w), device=dev)
    base[0], base[1] = retrieval_hue(i)
    base[2, :: (i % 5) + 2, :] = 255
    low = torch.rand((1, 3, h // 8, w // 8), generator=g, device=dev)
    tex = torch.nn.functional.interpolate(
        low * 255, size=(h, w), mode="bilinear", align_corners=False)[0]
    tex = tex + (torch.rand((3, h, w), generator=g, device=dev) - 0.5) * 24
    img = (0.6 * base + 0.4 * tex).clamp(0, 255).to(torch.uint8)
    return img.permute(1, 2, 0).contiguous().cpu().numpy()


def write_retrieval_tree(torch, dev, root, seed=61):
    """Phase Q's InLoc tree of raw images (``write_inloc_like``'s layout):
    two structured portrait queries, ``RETR_OWN`` crops of each (made on
    the card, ``inloc_images``) and ``RETR_ROW - 2 RETR_OWN`` structured
    distractors; row ``q`` holds the distractors in a seeded order, then
    the other query's crops, then its own at the last ranks.  Returns the
    shortlist's path, ``{q: own crop names}``, every cutout's origin in its
    query (``(0, 0)`` for a distractor, for the wall geometry of
    ``write_tree_geometry``) and the rows."""
    import numpy as np
    from scipy.io import savemat

    from ncnet_tpu_torch.data.datasets import raw_path

    qdir = os.path.join(root, "query", "iphone7")
    os.makedirs(qdir, exist_ok=True)
    os.makedirs(os.path.join(root, "pano", "DUC1"), exist_ok=True)
    own, origins = {}, {}
    for q in range(2):
        query = retrieval_image(torch, dev, INLOC_QUERY_HW, q, seed + q)
        np.save(raw_path(os.path.join(qdir, f"query_{q}.jpg")), query)
        corners = []
        crops = inloc_images(torch, dev, INLOC_PANO_HW, RETR_OWN,
                             seed + 10 + q, query, corners)
        own[q] = []
        for p, (img, corner) in enumerate(zip(crops, corners)):
            name = f"DUC1/DUC_cutout_{q:03d}_{p * 30}_0.jpg"
            np.save(raw_path(os.path.join(root, "pano", name)), img)
            own[q].append(name)
            origins[name] = corner
    n_d = RETR_ROW - 2 * RETR_OWN
    distractors = []
    for d, i in enumerate(retrieval_distractor_ids(n_d)):
        # the scan ids of the queries' crops, so the wall geometry has one
        # scan a query
        name = f"DUC1/DUC_cutout_{d % 2:03d}_{d // 2 * 30}_30.jpg"
        np.save(raw_path(os.path.join(root, "pano", name)),
                retrieval_image(torch, dev, INLOC_PANO_HW, i, seed + 100 + d))
        distractors.append(name)
        origins[name] = (0, 0)
    rng = np.random.default_rng(seed)
    rows = [[distractors[j] for j in rng.permutation(n_d)] + own[1 - q]
            + own[q] for q in range(2)]
    entries = np.zeros((1, 2), dtype=np.dtype(
        [("queryname", object), ("topNname", object)]))
    for q in range(2):
        entries[0, q] = (np.array([f"query_{q}.jpg"]),
                         np.array(rows[q], dtype=object)[:, None])
    shortlist = os.path.join(root, "shortlist.mat")
    savemat(shortlist, {"ImgList": entries})
    return shortlist, own, origins, rows


def compute_app_pids():
    """The pids ``nvidia-smi`` lists with a compute context on the card."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return {int(t) for t in out.stdout.split() if t.strip().isdigit()}


def card_files_open(pid):
    """The card device files (``/dev/nvidia<N>``, which a CUDA context
    opens) process ``pid`` holds open."""
    fds = os.path.join("/proc", str(pid), "fd")
    out = []
    for f in os.listdir(fds):
        try:
            target = os.readlink(os.path.join(fds, f))
        except OSError:
            continue
        if target.startswith("/dev/nvidia") and target[11:].isdigit():
            out.append(target)
    return out


def retrieval_outcomes(events):
    """The coordinator's outcome identity from its event log: admitted, the
    terminal events by kind, and the admitted ids with no outcome."""
    import collections

    admitted = {e["request"] for e in events if e["event"] == "retrieve_admit"}
    terminal = [e for e in events if e["event"] in (
        "retrieve_result", "retrieve_deadline", "retrieve_shed")]
    n = collections.Counter(e["event"] for e in terminal)
    return len(admitted), n, sorted(admitted - {e["request"] for e in terminal})


class CachedStore:
    """A store's verified reads, each entry read once (the reference
    shortlists of phase Q score the same 100 entries many times)."""

    def __init__(self, store):
        self.store, self._hits = store, {}

    def get(self, digest):
        if digest not in self._hits:
            self._hits[digest] = self.store.get(digest)
        return self._hits[digest]


def row_index(index, row):
    """``index`` restricted to the panos of one shortlist row, as
    ``run_inloc_eval``'s retrieval plan scores them."""
    return {**index, "panos": {n: index["panos"][n] for n in row
                               if n in index["panos"]}}


def retrieval_phase(torch, nc_fused_lane, dev):
    """Phase Q: the retrieval tier end to end (see the module docstring).
    Returns B6's launches by path."""
    import io
    import tempfile
    import threading

    import numpy as np
    from scipy.io import loadmat

    from ncnet_tpu_torch.config import EvalInLocConfig, LocalizationConfig
    from ncnet_tpu_torch.data.datasets import load_image
    from ncnet_tpu_torch.evaluation.inloc import (
        _as_str,
        make_pair_matcher,
        run_inloc_eval,
    )
    from ncnet_tpu_torch.localization import driver
    from ncnet_tpu_torch.models.checkpoint import load_params, save_params
    from ncnet_tpu_torch.observability import EventLog, events
    from ncnet_tpu_torch.retrieval import (
        RetrievalConfig,
        RetrievalCoordinator,
        RetrieveClient,
        coarse_volume_from_features,
        load_index_manifests,
        local_shortlist,
        pooled_descriptor,
        raw_coarse_volume,
        write_index_manifest,
    )
    from ncnet_tpu_torch.store import (
        FeatureStore,
        backbone_fingerprint,
        content_digest,
    )
    from ncnet_tpu_torch.tools import build_feature_store
    from ncnet_tpu_torch.utils import faults

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_retrieval_")
    pano = os.path.join(tmp, "pano")
    qpath = os.path.join(tmp, "query", "iphone7")
    runs = {}
    # the index tool is a process of its own with PyTorch's default TF32
    # settings (its f32 trunk's convolutions in TF32); the phase takes them
    # too, so its trunk computes the tool's bytes
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    try:
        # 1. the tree
        t0 = time.perf_counter()
        shortlist, own, origins, rows = write_retrieval_tree(torch, dev, tmp)
        tree_s = time.perf_counter() - t0
        queries = [load_image(os.path.join(qpath, f"query_{q}.jpg"))
                   for q in range(2)]

        # 2. the weights, written as a native checkpoint and loaded back;
        # the index built by the tool in subprocesses, stripes 0 and 1,
        # then stripe 0 again (it builds nothing)
        cfg = inloc_config()
        params = inloc_params(torch, cfg, dev, queries[0])
        ckpt = os.path.join(tmp, "ivd")
        save_params(ckpt, cfg, params)
        del params
        # loaded as the tool and the CLI load it: bf16 volume and NC stack
        # at k = INLOC_K, the trunk in f32 (the reference's)
        cfg, params = load_params(ckpt)
        cfg = cfg.replace(half_precision=True, relocalization_k_size=INLOC_K)
        bstore, rstore = os.path.join(tmp, "backbone"), os.path.join(tmp, "raw")
        bglob = os.path.join(bstore, "coarse_index.*.json")
        rglob = os.path.join(rstore, "coarse_index.*.json")
        common = ["--inloc_shortlist", shortlist, "--pano_path", pano,
                  "--n_panos", str(RETR_ROW), "--factor", str(RETR_FACTOR)]

        def build(*argv):
            """Start the tool: a ``finish()`` that waits for it and returns
            its summary line and its wall."""
            t0 = time.perf_counter()
            err = tempfile.TemporaryFile("w+", dir=tmp)
            proc = subprocess.Popen(
                [sys.executable, "-m", "ncnet_tpu_torch.tools.build_coarse_index",
                 *common, *argv], cwd=HERE, stdout=subprocess.PIPE,
                stderr=err, text=True)

            def finish():
                out, _ = proc.communicate(timeout=900)
                wall = time.perf_counter() - t0
                err.seek(0)
                tail = err.read()[-3000:]
                err.close()
                if proc.returncode != 0:
                    raise SystemExit(f"retrieval: build_coarse_index {argv} "
                                     f"exited {proc.returncode}: {tail}")
                return json.loads(out.strip().splitlines()[-1]), wall
            return finish

        backbone = ["--store_dir", bstore, "--image_size", str(INLOC_SIDE),
                    "--k_size", str(INLOC_K), "--checkpoint", ckpt]
        # the raw index (numpy, on the host) and the two backbone stripes
        # build side by side; stripe 0 again once it is done, beside the
        # rest of stripe 1 and the in-system shortlist runs (step 3), read
        # before step 4
        raw_build = build("--store_dir", rstore, "--raw")
        first = build(*backbone, "--shard_index", "0", "--shard_count", "2")
        second = build(*backbone, "--shard_index", "1", "--shard_count", "2")
        stripes = [first()]
        again_run = build(*backbone, "--shard_index", "0",
                          "--shard_count", "2")
        stripes.append(second())
        docs = [d for d, _ in stripes]
        built = sum(d["built"] for d in docs)
        bfp = docs[0]["fingerprint"]
        stage = {k: sum(d["stage_ms"][k] for d in docs) / max(1, built)
                 for k in docs[0]["stage_ms"]}
        bindex = load_index_manifests(bglob)
        some = next(iter(bindex["panos"].values()))
        entry_bytes = os.path.getsize(os.path.join(bstore, bfp,
                                                   some + ".feat"))
        print(f"retrieval: tree of 2 queries {INLOC_QUERY_HW} and "
              f"{RETR_ROW} cutouts {INLOC_PANO_HW} written in {tree_s:.2f} s; "
              f"backbone index by build_coarse_index in 2 stripes: built "
              f"{[d['built'] for d in docs]} panos, tool walls "
              f"{[round(w, 2) for _, w in stripes]} s (process start, model "
              f"load and {RETR_ROW // 2} panos each), ms a pano by stage "
              f"{stage}, "
              f"{entry_bytes} bytes an entry, fingerprint {bfp}; on "
              f"{card_line()}", flush=True)
        if built != RETR_ROW or len(bindex["panos"]) != RETR_ROW \
                or any(d["quarantined"] for d in docs) \
                or docs[1]["fingerprint"] != bfp \
                or not bfp.endswith(f"-bf16-torch.{dev.type}-c{RETR_FACTOR}"):
            raise SystemExit("retrieval: the backbone index did not build "
                             "every pano once under the port's fingerprint")

        # the shard hosts start now, beside the runs below; the pod reads
        # their startup lines (each one's arrival time kept) in step 5
        shard_ids = [f"s{i}" for i in range(RETR_SHARDS)]
        procs, urls, startup = {}, {}, {}

        def spawn(sids, ports=None):
            """Start shard processes: a ``ready()`` that waits for their
            startup lines (the wall from the start to each kept)."""
            t0 = time.perf_counter()
            started, lines = {}, {}
            for sid in sids:
                started[sid] = subprocess.Popen(
                    [sys.executable, "-m", "ncnet_tpu_torch.tools.serve_shard",
                     "--shard-id", sid, "--shards", ",".join(shard_ids),
                     "--store", bstore, "--index", bglob, "--replication",
                     str(RETR_R), "--topk", str(RETR_OWN), "--port",
                     str((ports or {}).get(sid, 0))],
                    cwd=HERE, stdout=subprocess.PIPE, text=True,
                    stderr=open(os.path.join(tmp, f"{sid}.stderr"), "ab"))

            def read(sid, proc):
                line = proc.stdout.readline()
                lines[sid] = (line, time.perf_counter() - t0)

            readers = [threading.Thread(target=read, args=item, daemon=True)
                       for item in started.items()]
            for th in readers:
                th.start()

            def ready():
                for th in readers:
                    th.join(timeout=300)
                for sid, proc in started.items():
                    line, wall = lines.get(sid, ("", None))
                    doc = json.loads(line) if line.strip() else {}
                    procs[sid] = proc
                    if "url" not in doc:
                        raise SystemExit(f"retrieval: shard {sid} did not "
                                         f"start: {doc}")
                    urls[sid], startup[sid] = doc["url"], round(wall, 3)
            return ready

        shards_ready = spawn(shard_ids)

        raw_doc, raw_s = raw_build()
        rindex = load_index_manifests(rglob)
        rstore_obj = FeatureStore(rstore, rindex["fingerprint"],
                                  scope="chip_smoke_raw")
        try:
            digests_ok = all(
                content_digest(load_image(os.path.join(pano, n))) == d
                for n, d in rindex["panos"].items())
            held = own[0][:2] + rows[0][:2]
            volumes_ok = all(np.array_equal(
                rstore_obj.get(rindex["panos"][n]),
                raw_coarse_volume(load_image(os.path.join(pano, n)),
                                  RETR_FACTOR)) for n in held)
        finally:
            rstore_obj.close()
        print(f"retrieval: raw index built by the tool beside the backbone "
              f"stripes: its loop {raw_doc['wall_s']} s, the process done "
              f"{raw_s:.2f} s after its start ({raw_doc['built']} "
              f"panos, fingerprint {raw_doc['fingerprint']}); its digests "
              f"equal the images' content digests: {digests_ok}; the entries "
              f"of {len(held)} panos bit-equal to raw_coarse_volume computed "
              f"here: {volumes_ok}", flush=True)
        if raw_doc["built"] != RETR_ROW or not digests_ok \
                or not volumes_ok or set(rindex["panos"]) != set(bindex["panos"]):
            raise SystemExit("retrieval: the raw index differs from the raw "
                             "extractor run here")

        # one pano's entry against the matcher's features at batch 1 here
        matcher = make_pair_matcher(
            cfg, params, do_softmax=True, both_directions=True,
            flip_direction=False, preprocess_image_size=INLOC_SIDE)

        def volume_of(img):
            feats = matcher.preprocess(img[None]).features
            return coarse_volume_from_features(feats.float().cpu().numpy(),
                                               RETR_FACTOR)

        bstore_obj = FeatureStore(bstore, bfp, scope="chip_smoke_backbone")
        cached = CachedStore(bstore_obj)
        probe = own[0][0]
        here = volume_of(load_image(os.path.join(pano, probe)))
        entry = cached.get(bindex["panos"][probe])
        entry_diff = float(np.abs(here - entry).max())
        print(f"retrieval: the tool's entry of {probe} {entry.shape} vs the "
              f"coarse volume of the matcher's features here at batch 1: "
              f"{'bit-equal' if np.array_equal(here, entry) else 'differ'}, "
              f"max difference {entry_diff:.3e} of the largest "
              f"{float(np.abs(entry).max()):.3e}", flush=True)
        if entry.shape != here.shape or \
                entry_diff > 1e-5 * float(np.abs(entry).max()):
            raise SystemExit("retrieval: the tool's entry differs from the "
                             "card's trunk here")
        descs = [pooled_descriptor(volume_of(img)) for img in queries]
        raw_descs = [pooled_descriptor(raw_coarse_volume(img, RETR_FACTOR))
                     for img in queries]

        # the dense feature store of the rows' first panos, built on the
        # card by the port's build_feature_store (in this process: the
        # tool's process start is phase Q's index build's); a matcher over
        # it reads each one warm, the features the trunk computes here
        fdir = os.path.join(tmp, "fstore")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as said:
            frc = build_feature_store.main([
                "--store_dir", fdir, "--inloc_shortlist", shortlist,
                "--pano_path", pano, "--checkpoint", ckpt, "--image_size",
                str(INLOC_SIDE), "--k_size", str(INLOC_K), "--n_panos", "1"])
        fs_s = time.perf_counter() - t0
        fdoc = json.loads(said.getvalue().strip().splitlines()[-1])
        ffp = backbone_fingerprint(params, image_size=INLOC_SIDE,
                                   k_size=INLOC_K, dtype="bf16", device=dev)
        fstore = FeatureStore(fdir, ffp, scope="chip_smoke_dense")
        try:
            warm = make_pair_matcher(
                cfg, params, do_softmax=True, both_directions=True,
                flip_direction=False, preprocess_image_size=INLOC_SIDE,
                store=fstore)
            firsts = list(dict.fromkeys(r[0] for r in rows))
            fdiff, fstatus = [], []
            for n in firsts:
                img = load_image(os.path.join(pano, n))[None]
                got = warm.prepare_db(img)
                fstatus.append(got.status)
                want = matcher.preprocess(img).features.float()
                fdiff.append(float((got.features - want).abs().max()
                                   / want.abs().max()))
        finally:
            fstore.close()
        print(f"retrieval: build_feature_store on the card over the rows' "
              f"first panos: exit {frc}, built {fdoc['built']} of "
              f"{fdoc['stripe_panos']} in {fs_s:.2f} s (checkpoint load "
              f"included; its loop {fdoc['wall_s']} s), fingerprint "
              f"{fdoc['fingerprint']}; a matcher over the store reads "
              f"{fstatus} with {warm.feature_extractions} trunk runs, the "
              f"features within {max(fdiff):.3e} of the largest of the "
              f"trunk's here; on {card_line()}", flush=True)
        if frc != 0 or fdoc["built"] != len(firsts) \
                or fdoc["fingerprint"] != ffp \
                or fstatus != ["hit"] * len(firsts) \
                or warm.feature_extractions or max(fdiff) > 1e-5:
            raise SystemExit("retrieval: build_feature_store's store was "
                             "not read warm with the trunk's features")

        # 3. the in-system shortlist
        def eval_run(name, index, **kw):
            config = EvalInLocConfig(
                output_root=os.path.join(tmp, name),
                telemetry_dir=os.path.join(tmp, name + "_events"),
                inloc_shortlist=shortlist, k_size=INLOC_K,
                image_size=INLOC_SIDE, n_queries=2, n_panos=RETR_OWN,
                pano_path=pano, query_path=qpath, retrieval_index=index,
                retrieval_topk=RETR_OWN, retrieval_min_coverage=1.0, **kw)
            torch.cuda.synchronize()
            nc_fused_lane.launches = 0
            t0 = time.perf_counter()
            out_dir = run_inloc_eval(config, model_config=cfg, params=params,
                                     progress=False)
            wall = time.perf_counter() - t0
            runs[name] = nc_fused_lane.launches
            _, ev = events.replay_events(
                os.path.join(config.telemetry_dir, "events.jsonl"))
            mats = [loadmat(os.path.join(out_dir, f"{q + 1}.mat"))
                    for q in range(2)]
            plan_ms = [round(e["dur_s"] * 1e3, 3) for e in ev
                       if e["event"] == "span" and e.get("ph") == "E"
                       and e["name"] == "retrieval_plan"]
            q_walls = [e["wall_s"] for e in ev if e["event"] == "eval_query"]
            kinds = [(e["event"], e["query"], e.get("reason"))
                     for e in ev if e["event"] in ("retrieval_shortlist",
                                                   "retrieval_fallback")]
            return out_dir, mats, wall, plan_ms, q_walls, kinds

        def names_of(mat):
            return ([_as_str(n) for n in mat["shortlist"].ravel()]
                    if "shortlist" in mat else None)

        pairs = 2 * RETR_OWN
        recalls = {}
        for name, index, store, ds in (
                ("inloc_retrieval", bglob, cached, descs),
                ("inloc_retrieval_raw", rglob, None, raw_descs)):
            out_dir, mats, wall, plan_ms, q_walls, kinds = eval_run(name, index)
            if store is None:
                store = FeatureStore(rstore, rindex["fingerprint"],
                                     scope="chip_smoke_raw")
            try:
                idx = bindex if index == bglob else rindex
                refs = [[p for p, _ in local_shortlist(
                    store, row_index(idx, rows[q]), ds[q],
                    topk=RETR_OWN)["scores"]] for q in range(2)]
            finally:
                if store is not cached:
                    store.close()
            got = [names_of(m) for m in mats]
            cover = [float(np.ravel(m["retrieval_coverage"])[0]) for m in mats]
            recalls[name] = [len(set(got[q]) & set(own[q])) / RETR_OWN
                             for q in range(2)]
            # the pair walls: a query's wall less its retrieval plan
            pair_ms = [round((w - p / 1e3) / RETR_OWN * 1e3, 3)
                       for w, p in zip(q_walls, plan_ms)]
            in_mat_top = [len(set(got[q]) & set(rows[q][:RETR_OWN]))
                          for q in range(2)]
            print(f"retrieval: run_inloc_eval on the {name} index "
                  f"({RETR_ROW}-wide rows, top {RETR_OWN}): {wall:.3f} s, B6 "
                  f"launches {runs[name]} (matching the whole rows would take "
                  f"{2 * 2 * RETR_ROW}); retrieval_plan ms a query {plan_ms} "
                  f"(descriptor and scoring), mean pair wall ms a query "
                  f"{pair_ms}; shortlists equal local_shortlist here: "
                  f"{got == refs}; coverage {cover}; recall of the query's "
                  f"own crops {recalls[name]}; of the .mat order's top "
                  f"{RETR_OWN}, {in_mat_top} shortlisted; events {kinds}; on "
                  f"{card_line()}", flush=True)
            if runs[name] != 2 * pairs or got != refs or cover != [1.0, 1.0] \
                    or kinds != [("retrieval_shortlist", 1, None),
                                 ("retrieval_shortlist", 2, None)]:
                raise SystemExit(f"retrieval: the {name} run did not match "
                                 "the shortlist at 2 B6 launches a pair")
            if name == "inloc_retrieval":
                b_names = got
            else:
                raw_dir, raw_names = out_dir, got
        if min(recalls["inloc_retrieval_raw"]) < RETR_MIN_RECALL:
            raise SystemExit("retrieval: the raw index's recall of the "
                             "queries' own crops is below "
                             f"{RETR_MIN_RECALL}")

        # an index missing RETR_MISSING of the row: each query falls back to
        # the .mat order
        partial = os.path.join(bstore, "partial.json")
        dropped = set(rows[0][:RETR_MISSING])
        write_index_manifest(partial, fingerprint=bfp, factor=RETR_FACTOR,
                             extractor="backbone",
                             panos={n: d for n, d in bindex["panos"].items()
                                    if n not in dropped})
        name = "inloc_retrieval_fallback"
        _, mats, wall, _, _, kinds = eval_run(name, partial)
        print(f"retrieval: an index missing {RETR_MISSING} of the row: "
              f"{wall:.3f} s, B6 launches {runs[name]}, events {kinds}, "
              f"shortlist keys {['shortlist' in m for m in mats]}", flush=True)
        if runs[name] != 2 * pairs or any("shortlist" in m for m in mats) \
                or kinds != [("retrieval_fallback", 1, "coverage"),
                             ("retrieval_fallback", 2, "coverage")]:
            raise SystemExit("retrieval: the coverage fallback did not match "
                             "the .mat order")

        # stripe 0 again (started when it was done): it builds nothing
        again, again_s = again_run()
        print(f"retrieval: stripe 0 of the backbone index again: built "
              f"{again['built']}, skipped {again['skipped_indexed']} in "
              f"{again_s:.2f} s (beside stripe 1 and step 3)", flush=True)
        if again["built"] != 0 \
                or again["skipped_indexed"] != docs[0]["stripe_panos"]:
            raise SystemExit("retrieval: stripe 0's rerun built a pano")

        # 4. localization on the raw index's run: wall geometry for the
        # cutouts each query shortlisted; the PnP pairs each .mat row with
        # the shortlist's name, not the DensePE row's
        t0 = time.perf_counter()
        kw = write_tree_geometry({
            "root": tmp, "matches_dir": raw_dir, "shortlist": shortlist,
            "origins": {n: origins[n] for q in range(2) for n in raw_names[q]},
            "query_path": qpath, "pano_path": pano})
        loc = LocalizationConfig(output_dir=os.path.join(tmp, "loc"),
                                 progress=False, **kw)
        driver.run_localization(loc)
        loc_s = time.perf_counter() - t0
        readable = 0
        for d, _, fs in os.walk(loc.output_dir):
            for f in fs:
                if f.endswith(".mat"):
                    loadmat(os.path.join(d, f))
                    readable += 1
        pe, _ = stage_imglists(loc)
        top = {e["queryname"]: list(e["topNname"]) for e in pe}
        print(f"retrieval: run_localization on the raw run's matches in "
              f"{loc_s:.2f} s (geometry included): {readable} .mat files "
              f"readable; each query's PnP top-N is its .mat's shortlist: "
              f"{[top.get(f'query_{q}.jpg') == raw_names[q] for q in range(2)]}"
              f", not the DensePE row's first {RETR_OWN}: "
              f"{[top.get(f'query_{q}.jpg') != rows[q][:RETR_OWN] for q in range(2)]}",
              flush=True)
        if any(top.get(f"query_{q}.jpg") != raw_names[q]
               or raw_names[q] == rows[q][:RETR_OWN] for q in range(2)):
            raise SystemExit("retrieval: localization did not pair the "
                             "retrieval-ordered rows with their cutouts")

        # 5. a shard pod over the backbone index's store
        rng = np.random.default_rng(71)
        dim = descs[0].shape[0]
        pod_descs = list(descs) + [
            (v / np.linalg.norm(v)).astype(np.float32)
            for v in rng.normal(size=(RETR_POD_QUERIES - 2, dim))]
        refs = [[[p, s] for p, s in local_shortlist(
            cached, bindex, d, topk=RETR_OWN)["scores"]] for d in pod_descs]
        log_path = os.path.join(tmp, "coordinator_events.jsonl")
        sink = EventLog(log_path)
        coord = None
        try:
            shards_ready()
            # the shards do numpy work only: no CUDA context in them
            apps = compute_app_pids()
            ctx = {sid: [procs[sid].pid in apps, card_files_open(procs[sid].pid)]
                   for sid in shard_ids}
            self_listed = os.getpid() in apps
            # the control: this process holds a context, so the check must
            # find its card files, or it cannot see a shard's either
            own_files = len(card_files_open(os.getpid()))
            with events.bound(sink):
                coord = RetrievalCoordinator(
                    urls, list(bindex["panos"]), RetrievalConfig(
                        replication=RETR_R, topk=RETR_OWN, probe_period_s=0.2,
                        resurrect_after_s=0.3, max_failures=2,
                        introspect_port=0)).start()
                walls, bad = [], []
                for i, d in enumerate(pod_descs):
                    t0 = time.perf_counter()
                    ans = coord.retrieve(d, budget_s=60.0,
                                         request_id=f"steady-{i}")
                    walls.append((time.perf_counter() - t0) * 1e3)
                    if ans["coverage"] != 1.0 or ans["scores"] != refs[i]:
                        bad.append(i)
                # SIGKILL s1 under a stream of queries
                stream, errors, stop = [], [], threading.Event()

                def pump():
                    i = 0
                    while not stop.is_set():
                        k = i % len(pod_descs)
                        try:
                            a = coord.retrieve(pod_descs[k], budget_s=60.0,
                                               request_id=f"stream-{i}")
                            stream.append((k, a))
                        except Exception as e:  # noqa: BLE001 — counted
                            errors.append(repr(e))
                        i += 1

                th = threading.Thread(target=pump, daemon=True)
                th.start()
                wait_for(lambda: len(stream) >= 5, "the stream's first answers")
                t_kill = time.monotonic()
                procs["s1"].kill()
                wait_for(lambda: coord._backends["s1"].state == "DEAD",
                         "s1 DEAD")
                failover_s = time.monotonic() - t_kill
                n_dead = len(stream)
                wait_for(lambda: len(stream) >= n_dead + 5,
                         "answers with s1 dead")
                stop.set()
                th.join(timeout=120)
                procs["s1"].wait(timeout=30)
                procs["s1"].stdout.close()
                port = int(urls["s1"].rsplit(":", 1)[1])
                t_restart = time.monotonic()
                spawn(["s1"], ports={"s1": port})()
                wait_for(lambda: coord._backends["s1"].state == "READY",
                         "s1 READY again")
                resurrect_s = time.monotonic() - t_restart
                wait_for(lambda: coord.state == "READY", "the pod READY")
                stream_bad = [k for k, a in stream if a["coverage"] != 1.0
                              or a["scores"] != refs[k]]
                # a straggler: s2's sends slowed past hedge_after_s
                hedges0 = coord.counters()["hedges"]
                faults.install(faults.FaultPlan(
                    slow_shard_urls=(urls["s2"].replace("http://", ""),),
                    slow_shard_seconds=1.0))
                try:
                    slow = [coord.retrieve(pod_descs[i], budget_s=60.0,
                                           request_id=f"slow-{i}")
                            for i in range(8)]
                finally:
                    faults.clear()
                hedged = coord.counters()["hedges"] - hedges0
                slow_bad = [i for i, a in enumerate(slow)
                            if a["coverage"] != 1.0 or a["scores"] != refs[i]]
                hedge_share = sum(a["hedges"] > 0 for a in slow) / len(slow)
                # the coordinator's own POST /retrieve
                with RetrieveClient(coord.introspect_url) as client:
                    via_wire = client.retrieve(pod_descs[0], budget_s=60.0,
                                               request_id="wire-0")
                fams = (scrape(coord.introspect_url), scrape(urls["s0"]))
                doc = coord.health()
                coord.stop()
                coord = None
        finally:
            if coord is not None:
                coord.stop()
            sink.close()
            for proc in procs.values():
                if proc.poll() is None:
                    proc.terminate()
            for proc in procs.values():
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                if proc.stdout is not None and not proc.stdout.closed:
                    proc.stdout.close()
        _, ev = events.replay_events(log_path)
        admitted, n, lost = retrieval_outcomes(ev)
        exits = {sid: procs[sid].returncode for sid in shard_ids}
        print(f"retrieval pod: {RETR_SHARDS} serve_shard processes at R = "
              f"{RETR_R} over the backbone store, startup to READY s "
              f"{startup}; card context (nvidia-smi lists the pid, card "
              f"files open) {ctx} (nvidia-smi lists this process: "
              f"{self_listed}; this process, which holds a context, holds "
              f"{own_files} card files); {len(pod_descs)} queries: walls ms p50 "
              f"{percentile(walls, 50):.3f} p95 {percentile(walls, 95):.3f}, "
              f"answers unequal to local_shortlist {bad}; SIGKILL of s1 under "
              f"a stream: {len(stream)} answers, errors {errors}, answers "
              f"unequal or below full coverage {stream_bad}, DEAD after "
              f"{failover_s:.3f} s, restarted at its port READY after "
              f"{resurrect_s:.3f} s; s2 slowed by 1 s: {hedged} hedges, "
              f"hedge share {hedge_share}, answers unequal {slow_bad}; POST "
              f"/retrieve of the coordinator equal: "
              f"{via_wire['scores'] == refs[0]}; /metrics parsed: "
              f"{len(fams[0])} coordinator and {len(fams[1])} shard "
              f"families; outcome identity admitted {admitted} = {dict(n)}, "
              f"lost {lost}; shard exits {exits}; on {card_line()}",
              flush=True)
        if bad or errors or stream_bad or slow_bad or hedged < 1 \
                or via_wire["scores"] != refs[0] \
                or any(a or f for a, f in ctx.values()) or not own_files \
                or "ncnet_retrieve_requests_total" not in fams[0] \
                or "ncnet_retrieve_shard_up" not in fams[1] \
                or lost or admitted != n["retrieve_result"] \
                or doc["state"] not in ("READY", "STOPPED", "DEGRADED"):
            raise SystemExit("retrieval pod: an answer differed, a query was "
                             "lost, a shard held a CUDA context (or this "
                             "process's own went unseen) or no hedge fired")

        # 6. a bit flip of one committed entry: quarantined, recomputed on
        # the card, the same shortlist
        victim = b_names[0][0]
        digest = bindex["panos"][victim]
        path = os.path.join(bstore, bfp, digest + ".feat")
        with open(path, "r+b") as f:
            f.seek(-1, os.SEEK_END)
            byte = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([byte[0] ^ 0x01]))
        recomputed = []

        def compute(name):
            recomputed.append(name)
            return volume_of(load_image(os.path.join(pano, name)))

        corrupt0 = bstore_obj.counters["corrupt"]
        t0 = time.perf_counter()
        res = local_shortlist(bstore_obj, row_index(bindex, rows[0]),
                              descs[0], topk=RETR_OWN, compute=compute)
        flip_s = time.perf_counter() - t0
        names = [p for p, _ in res["scores"]]
        print(f"retrieval: one bit of {victim}'s committed entry flipped: "
              f"corrupt reads {bstore_obj.counters['corrupt'] - corrupt0}, "
              f"recomputed on the card {recomputed}, the shortlist the same: "
              f"{names == b_names[0]}, coverage {res['coverage']}, "
              f"{flip_s:.2f} s", flush=True)
        bstore_obj.close()
        if bstore_obj.counters["corrupt"] - corrupt0 != 1 \
                or recomputed != [victim] or names != b_names[0] \
                or res["coverage"] != 1.0:
            raise SystemExit("retrieval: the flipped entry was not "
                             "quarantined and recomputed to the same "
                             "shortlist")
        leave("Q", coordinator=log_path)
        print(f"retrieval: phase Q in {time.perf_counter() - t_phase:.1f} s "
              f"on {card_line()}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    return runs


# ---------------------------------------------------------------------------
# phase V: the VGG-16 and DenseNet-201 trunks at full width
# ---------------------------------------------------------------------------


def torchvision_features(ref_sd):
    """A torchvision ``vgg16`` / ``densenet201`` state dict (the trunk under
    ``features.``) from a reference one: the reference nests the same names
    under ``FeatureExtraction.model.``."""
    root = "FeatureExtraction.model."
    return {"features." + k[len(root):]: v for k, v in ref_sd.items()
            if k.startswith(root)}


def trunk_model(torch, name, dev, tmp):
    """Phase V's PF-Pascal model with the ``name`` trunk (VGG-16 to pool4,
    DenseNet-201 to transition2): random from seed 0, the trunk's
    BatchNorm statistics from one seeded 400² batch, NC kernels
    centre-peaked with biases off zero; written as a torchvision state
    dict and as a reference ``.pth.tar``, and read back through
    ``ModelConfig.backbone_weights`` and ``ModelConfig.checkpoint``, both
    bit-equal to what was written.  Returns the bf16 serving config, the
    loaded parameters on ``dev`` and the ``.pth.tar`` path."""
    import argparse
    import warnings

    import numpy as np

    from ncnet_tpu_torch.config import ModelConfig
    from ncnet_tpu_torch.models import checkpoint as ckpt_io
    from ncnet_tpu_torch.models.ncnet import init_ncnet, params_to, tree_leaves
    from ncnet_tpu_torch.ops.image import normalize_imagenet

    cfg = ModelConfig(backbone=name, ncons_kernel_sizes=(5, 5, 5),
                      ncons_channels=(16, 16, 1))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the random-trunk warning
        params = params_to(init_ncnet(cfg, seed=0), dev)
    calib = np.random.default_rng(3).integers(
        0, 256, (SERVE_BATCH, SERVE_SIDE, SERVE_SIDE, 3), dtype=np.uint8)
    calibrate_trunk(cfg, params, normalize_imagenet(torch.as_tensor(calib).to(dev)))
    for layer in params["nc"]:
        d = layer["w"].shape[0] // 2
        layer["w"][d, d, d, d] += 1.0 / layer["w"].shape[4]
        layer["b"] = layer["b"] + 0.05
    written = ckpt_io.cpu_tree(params)
    ref = ckpt_io.reference_state_dict(cfg, written)
    pth = os.path.join(tmp, f"{name}.pth")
    torch.save(torchvision_features(ref), pth)
    tar = os.path.join(tmp, f"{name}.pth.tar")
    torch.save({"epoch": 1, "state_dict": ref, "args": argparse.Namespace(
        feature_extraction_cnn=name, ncons_kernel_sizes=[5, 5, 5],
        ncons_channels=[16, 16, 1])}, tar)
    via_weights = init_ncnet(cfg.replace(backbone_weights=pth), seed=0)
    loaded_cfg, loaded = ckpt_io.load_params(tar, cfg)
    same_w = trees_equal(torch, via_weights["backbone"], written["backbone"])
    same_t = trees_equal(torch, loaded, written)
    print(f"trunks {name}: {sum(t.numel() for t in tree_leaves(written['backbone']))} "
          f"trunk parameters; backbone_weights ({os.path.getsize(pth)} bytes) "
          f"bit-equal: {same_w}; .pth.tar ({os.path.getsize(tar)} bytes, "
          f"args' trunk {loaded_cfg.backbone!r}) bit-equal: {same_t}",
          flush=True)
    if not (same_w and same_t and loaded_cfg.backbone == name):
        raise SystemExit(f"trunks {name}: the weights files do not load back")
    serve_cfg = loaded_cfg.replace(half_precision=True, backbone_bf16=True)
    return serve_cfg, params_to(loaded, dev), tar


def trunk_on_cpu(torch, name, cfg, params, dev):
    """The f32 trunk on the card (TF32 off) against the same trunk on the
    CPU, on one seeded 400² batch of 4 (cuDNN picks DenseNet's small convs
    by batch size): the normalized error."""
    import numpy as np

    from ncnet_tpu_torch.models.ncnet import extract_features, params_to
    from ncnet_tpu_torch.ops.image import normalize_imagenet

    f32 = cfg.replace(backbone_bf16=False)
    x = np.random.default_rng(7).integers(
        0, 256, (SERVE_BATCH, SERVE_SIDE, SERVE_SIDE, 3), dtype=np.uint8)
    img = normalize_imagenet(torch.as_tensor(x).to(dev))
    with torch.no_grad():
        card = extract_features(f32, params, img)
        cpu = extract_features(f32, params_to(params, "cpu"), img.cpu())
    return normalized_err(card, cpu.to(dev)), tuple(card.shape)


def gather_at_channels(torch, sparse_corr, c, dev):
    """B8 at the coarse-to-fine serving shape with ``c`` channels (a
    trunk's width): against its twin, two launches bit-identical, and the
    kernel, plain, library and bound times."""
    name, b, side, _, factor, halo, k = GATHER_SHAPES[0]
    args, kw, want, tiles = gather_call(torch, sparse_corr, b, side, c,
                                        factor, halo, k, dev, seed=6)
    got = sparse_corr.gather_tile_corr_pallas(*args, **kw)
    again = sparse_corr.gather_tile_corr_pallas(*args, **kw)
    torch.cuda.synchronize()
    err = normalized_err(got, want)
    if not (err <= GATHER_TOLERANCE and torch.equal(got, again)):
        raise SystemExit(f"the gather kernel disagrees with its twin at C={c}")
    run_k = lambda: sparse_corr.gather_tile_corr_pallas(*args, **kw)  # noqa: E731
    run_p = lambda: sparse_corr.gather_tile_corr_reference(*args, **kw)  # noqa: E731
    ms = [cuda_ms(run_k, 10), cuda_ms(run_k, 10)]
    plain = [cuda_ms(run_p, 10), cuda_ms(run_p, 10)]
    fa_p2, fb, rows, _ = args
    fb_p2 = sparse_corr.gather_target_patches(
        fb, tiles.ib, tiles.jb).reshape(got.shape[:4] + (c,))
    lib = cuda_ms(lambda: torch.einsum("bnic,bnkjc->bnkij", fa_p2, fb_p2), 10)
    flops, nbytes = gather_work(fa_p2, fb, rows, k)
    bound_ms, bound_by = bound(flops, nbytes)
    out = {"max_abs_err": float((got.float() - want.float()).abs().max()),
           "normalized_err": err, "ms": sum(ms) / 2, "plain_ms": sum(plain) / 2,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": lib}
    print(f"timing B4 {name} at C={c} (one launch): kernel {ms} ms, plain "
          f"{plain} ms, library (einsum on pre-gathered patches) {lib:.4f} "
          f"ms, bound {out['bound_ms']:.4f} ms ({out['bound_by']}); vs twin "
          f"normalized {err:.3e}", flush=True)
    return out


def trunk_serve(torch, nc_fused_lane, sparse_corr, name, cfg, params, dev):
    """A dense bf16 400² request of 4 pairs (the FFT tier: no B2 launch)
    and a coarse-to-fine 800² request (``sparse_topk=4``: 6 B2 and 2 B4
    launches), each after a warm-up; the c2f request's kernels against
    their twins on the path's inputs.  Returns the launches by path."""
    from ncnet_tpu_torch.models.ncnet import coarse2fine_filter, extract_features
    from ncnet_tpu_torch.ops.image import normalize_imagenet
    from ncnet_tpu_torch.serving.engine import BatchMatchEngine

    dense = BatchMatchEngine(cfg, params)
    reqs = c2f_requests(seed=8, shift=TRAIN_SHIFT, side=SERVE_SIDE)
    dense.fetch(dense.dispatch(*reqs[-1]))
    torch.cuda.synchronize()
    nc_fused_lane.launches = 0
    t0 = time.perf_counter()
    table = dense.fetch(dense.dispatch(*reqs[0]))
    wall = (time.perf_counter() - t0) * 1e3
    dense_launches = nc_fused_lane.launches
    check_tables([table], (SERVE_SIDE // 16) ** 2, f"trunks {name} 400")
    cells = (TRAIN_SHIFT[0] // 16, TRAIN_SHIFT[1] // 16)
    rec = shift_recovery(table, SERVE_SIDE // 16, cells)

    c2f_cfg = cfg.replace(sparse_topk=C2F_TOPK, sparse_factor=2)
    engine = BatchMatchEngine(c2f_cfg, params)
    reqs = c2f_requests(seed=9, shift=TRAIN_SHIFT, side=C2F_SIDE)
    engine.fetch(engine.dispatch(*reqs[-1]))
    torch.cuda.synchronize()
    nc_fused_lane.launches = 0
    sparse_corr.launches = 0
    t0 = time.perf_counter()
    c2f_table = engine.fetch(engine.dispatch(*reqs[0]))
    c2f_wall = (time.perf_counter() - t0) * 1e3
    c2f = {"nc_conv4d_bf16": nc_fused_lane.launches,
           "gather_tile_corr_bf16": sparse_corr.launches}
    check_tables([c2f_table], (C2F_SIDE // 16) ** 2, f"trunks {name} c2f")
    c2f_rec = shift_recovery(c2f_table, C2F_SIDE // 16, cells)
    print(f"trunks {name}: dense {SERVE_SIDE}x{SERVE_SIDE} request of "
          f"{SERVE_BATCH} pairs {wall:.1f} ms, B2 launches {dense_launches}, "
          f"shift recovery {rec:.4f}; c2f {C2F_SIDE}x{C2F_SIDE} request "
          f"(sparse_topk {C2F_TOPK}) "
          f"{c2f_wall:.1f} ms, launches {c2f}, shift recovery {c2f_rec:.4f}",
          flush=True)
    if dense_launches != 0 or c2f != {"nc_conv4d_bf16": 6,
                                      "gather_tile_corr_bf16": 2}:
        raise SystemExit(f"trunks {name}: expected 0 B2 launches in the "
                         "dense request and 6 B2 + 2 B4 in the c2f request")
    src, tgt = (normalize_imagenet(torch.as_tensor(a).to(dev)) for a in reqs[0])
    with torch.no_grad():
        fa, fb = (extract_features(c2f_cfg, params, x).to(torch.bfloat16)
                  for x in (src, tgt))
    check_path_calls(torch, nc_fused_lane, sparse_corr,
                     lambda: coarse2fine_filter(c2f_cfg, params, fa, fb), 1,
                     f"trunks {name} c2f")
    return {f"{name}_serve_400": dense_launches, f"{name}_c2f_800": c2f}


def trunk_fit(torch, nc_fused_lane, vjp, name, tar, f_run, dev):
    """2 ``fit`` steps with ``fe_finetune_params=1`` from the ``.pth.tar``
    on phase F's pairs (batch 16 at 400², bf16 NC stack): the last trunk
    unit's trainable leaves and the NC stack move, every other trunk leaf
    stays bit-equal, 18 B3 launches a step (the whole-batch backward's)."""
    import dataclasses

    import numpy as np

    from ncnet_tpu_torch.models import backbone as bb
    from ncnet_tpu_torch.models import checkpoint as ckpt_io
    from ncnet_tpu_torch.models.ncnet import tree_leaves
    from ncnet_tpu_torch.training import fit

    config = dataclasses.replace(
        f_run["config"], model=f_run["config"].model.replace(checkpoint=tar),
        fe_finetune_params=1, num_epochs=1, checkpoint_steps=0,
        telemetry=False, result_model_dir=os.path.join(f_run["tmp"], name))
    _, start = ckpt_io.load_params(tar, config.model)
    nc_fused_lane.launches = 0
    for key in vjp.launches:
        vjp.launches[key] = 0
    t0 = time.perf_counter()
    res = fit(config, progress=False, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"nc_conv4d_bf16": nc_fused_lane.launches, **vjp.launches}
    got = ckpt_io.cpu_tree(res["state"].params)
    labels = bb.finetune_labels(name, start["backbone"], 1)
    moved = [(lab, not torch.equal(a, b)) for a, b, lab in zip(
        tree_leaves(got["backbone"]), tree_leaves(start["backbone"]),
        tree_leaves(labels))]
    n_train = sum(lab == "trainable" for lab, _ in moved)
    ok_trunk = all(m == (lab == "trainable") for lab, m in moved)
    nc_moved = not trees_equal(torch, got["nc"], start["nc"])
    steps = FIT_TRAIN_PAIRS // FIT_BATCH
    want = {"nc_conv4d_bf16": 0, "nc_vjp_dw": steps * 2 * 3,
            "nc_vjp_reduce": steps * 2 * 3, "nc_conv4d_transpose": steps * 2 * 3}
    print(f"trunks {name} fit fe_finetune_params=1: {steps} steps of batch "
          f"{FIT_BATCH} in {wall:.2f} s, train loss "
          f"{res['train_loss'].tolist()}, val loss {res['test_loss'].tolist()}; "
          f"the {n_train} trainable trunk leaves moved and every other stayed "
          f"bit-equal: {ok_trunk}; NC stack moved: {nc_moved}; launches "
          f"{launches}, expected {want}", flush=True)
    if not ok_trunk or not n_train or not nc_moved or launches != want \
            or not np.isfinite(res["train_loss"]).all():
        raise SystemExit(f"trunks {name} fit: a check failed")
    return launches


def trunks_phase(torch, nc_fused_lane, vjp, sparse_corr, dev, f_run):
    """Phase V; returns the B2 launches, the B3 launches and the B4
    launches by path, and B8's numbers at each trunk's width."""
    import tempfile

    from ncnet_tpu_torch.models import backbone as bb

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trunks_")
    nc, b3, b4, gather = {}, {}, {}, {}
    for name in ("vgg", "densenet201"):
        cfg, params, tar = trunk_model(torch, name, dev, tmp)
        err, shape = trunk_on_cpu(torch, name, cfg, params, dev)
        print(f"trunks {name}: f32 trunk features {shape} on the card vs the "
              f"CPU: normalized {err:.3e} (tolerance {FP32_TOLERANCE})",
              flush=True)
        if not err <= FP32_TOLERANCE:
            raise SystemExit(f"trunks {name}: the card's trunk disagrees "
                             "with the CPU's")
        launches = trunk_serve(torch, nc_fused_lane, sparse_corr, name, cfg,
                               params, dev)
        nc[f"{name}_serve_400"] = launches[f"{name}_serve_400"]
        c2f = launches[f"{name}_c2f_800"]
        nc[f"{name}_c2f_800"] = c2f["nc_conv4d_bf16"]
        b4[f"{name}_c2f_800"] = c2f["gather_tile_corr_bf16"]
        c = bb.OUTPUT_CHANNELS[name]
        gather[f"C{c}"] = gather_at_channels(torch, sparse_corr, c, dev)
        del params
        torch.cuda.empty_cache()
        fit_launches = trunk_fit(torch, nc_fused_lane, vjp, name, tar, f_run,
                                 dev)
        nc[f"{name}_fit_fe_finetune"] = fit_launches["nc_conv4d_bf16"]
        b3[f"{name}_fit_fe_finetune"] = {k: fit_launches[k] for k in vjp.launches}
        torch.cuda.empty_cache()
    shutil.rmtree(tmp)
    print(f"trunks: phase V in {time.perf_counter() - t_phase:.1f} s on "
          f"{card_line()}", flush=True)
    return nc, b3, b4, gather


# ---------------------------------------------------------------------------
# phase M: multi-GPU execution (the hB-sharded InLoc forward, data-parallel
# fit over torch.distributed)
# ---------------------------------------------------------------------------


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sharded_forward_check(torch, nc_fused_lane, conv4d_pallas, cfg, params,
                          mesh, src, tgt):
    """``spatial_forward`` on ``mesh`` against the unsharded forward on the
    same preprocessed pair: the normalized error, the share of equal
    relocalization offsets, no B6 and no B5 launch, and both ms."""
    from ncnet_tpu_torch.models.ncnet import ncnet_forward
    from ncnet_tpu_torch.parallel import spatial_forward

    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        nc_fused_lane.launches = 0
        conv4d_pallas.launches_by_kernel.update(tensor_core=0, cuda_core=0)
        sharded = spatial_forward(cfg, params, src, tgt, mesh)
        torch.cuda.synchronize()
        launches = {"nc_conv4d_bf16": nc_fused_lane.launches,
                    "conv4d_small_cout": conv4d_pallas.launches}
        peak = torch.cuda.max_memory_allocated()
        plain = ncnet_forward(cfg, params, src, tgt)
        err = normalized_err(sharded.corr, plain.corr)
        same = float(sum((a == b).float().mean() for a, b in zip(
            sharded.delta4d, plain.delta4d)) / 4)
        shard_ms = cuda_ms(lambda: spatial_forward(cfg, params, src, tgt, mesh), 1)
        plain_ms = cuda_ms(lambda: ncnet_forward(cfg, params, src, tgt), 1)
    return {"normalized_err": err, "delta_equal_share": same,
            "launches": launches, "shape": tuple(sharded.corr.shape),
            "ms": shard_ms, "plain_ms": plain_ms, "peak_bytes": peak}


def table_agreement(got, want, grid):
    """(share of ``want``'s matches in ``got``, max score difference over
    the shared ones) of two matcher tables, matches compared by their fine
    cells."""
    import numpy as np

    (ha, wa, hb, wb), k = grid
    sizes = np.asarray([wa, ha, wb, hb], dtype=np.float64) * k
    tabs = []
    for t in (got, want):
        t = np.stack(t, -1)
        t = t[t[:, 4] > 0]
        cells = np.rint(t[:, :4].astype(np.float64) * sizes - 0.5).astype(np.int64)
        tabs.append({tuple(c): float(s) for c, s in zip(cells, t[:, 4])})
    common = tabs[0].keys() & tabs[1].keys()
    diff = max((abs(tabs[0][c] - tabs[1][c]) for c in common), default=0.0)
    return len(common) / max(1, len(tabs[1])), diff


def dp_fit_world1(torch, f_run, dev):
    """``fit`` with ``distributed=True`` in a world-1 NCCL group (its
    collectives run: the roll's all_gather, the gradients' all_reduce, the
    val loss's, the stop agreement's) on phase F's run (a): the final
    version (params, Adam state, step) bit-equal to (a)'s."""
    import dataclasses

    from ncnet_tpu_torch.parallel import distributed as pdist
    from ncnet_tpu_torch.training import fit

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    # run (a)'s settings: the CLI's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    pdist.initialize_distributed(
        device=dev, init_method=f"tcp://localhost:{free_port()}",
        world_size=1, rank=0, timeout_s=300)
    try:
        backend = torch.distributed.get_backend()
        t0 = time.perf_counter()
        res = fit(dataclasses.replace(
            f_run["config"], distributed=True, telemetry=False,
            result_model_dir=os.path.join(f_run["tmp"], "world1")),
            progress=False, device=dev)
        wall = time.perf_counter() - t0
    finally:
        pdist.shutdown_distributed()
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    final = f_run["final"]
    same = trees_equal(torch, version_trees(os.path.join(res["checkpoint"], final)),
                       version_trees(os.path.join(f_run["a_root"], final)))
    print(f"multi-gpu fit: world 1 over {backend}, {int(res['state'].step)} "
          f"steps in {wall:.2f} s, train loss {res['train_loss'].tolist()}; "
          f"version {final} (params, Adam state, step) vs phase F's "
          f"non-distributed run: {'bit-equal' if same else 'DIFFERENT'}",
          flush=True)
    if backend != "nccl" or not same:
        raise SystemExit("multi-gpu fit: the world-1 NCCL run is not "
                         "bit-equal to phase F's")


def _dp_rank(rank, world, port, config, out):
    """One rank of phase M's world-2 ``fit`` (a process of its own, on
    ``cuda:<rank>``)."""
    import torch

    from ncnet_tpu_torch.models import checkpoint as ckpt_io
    from ncnet_tpu_torch.parallel import distributed as pdist
    from ncnet_tpu_torch.training import fit

    pdist.initialize_distributed(
        device=f"cuda:{rank}", init_method=f"tcp://localhost:{port}",
        world_size=world, rank=rank, timeout_s=300)
    res = fit(config, progress=False, device=f"cuda:{rank}")
    torch.save({"params": ckpt_io.cpu_tree(res["state"].params),
                "train_loss": res["train_loss"].tolist(),
                "step": int(res["state"].step)},
               os.path.join(out, f"rank{rank}.pt"))
    pdist.shutdown_distributed()


def dp_fit_world2(torch, f_run):
    """``fit`` at world 2 over NCCL, a card a rank (two processes): both
    ranks end on the same parameters, bit for bit, with finite losses."""
    import dataclasses

    import numpy as np
    import torch.multiprocessing as mp

    out = os.path.join(f_run["tmp"], "world2")
    os.makedirs(out, exist_ok=True)
    config = dataclasses.replace(f_run["config"], telemetry=False,
                                 result_model_dir=os.path.join(out, "ckpt"))
    t0 = time.perf_counter()
    mp.spawn(_dp_rank, args=(2, free_port(), config, out), nprocs=2, join=True)
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=True)
             for r in range(2)]
    same = trees_equal(torch, ranks[0]["params"], ranks[1]["params"])
    print(f"multi-gpu fit: world 2 over nccl on cuda:0 and cuda:1, "
          f"{ranks[0]['step']} steps in {wall:.2f} s, train loss "
          f"{ranks[0]['train_loss']}; the ranks' params bit-equal: {same}",
          flush=True)
    if not same or not np.isfinite(ranks[0]["train_loss"]).all():
        raise SystemExit("multi-gpu fit: the world-2 ranks disagree")


def multi_gpu_phase(torch, nc_fused_lane, conv4d_pallas, dev, f_run):
    """Phase M; returns the sharded forward's numbers."""
    from ncnet_tpu_torch.evaluation.inloc import (
        device_preprocess,
        make_pair_matcher,
    )
    from ncnet_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    n_gpu = torch.cuda.device_count()
    devices = ["cuda:0", "cuda:1"] if n_gpu >= 2 else ["cuda:0", "cuda:0"]
    mesh = make_mesh(data=1, spatial=2, devices=devices)
    print(f"multi-gpu: {n_gpu} CUDA device(s) visible; the sharded forward on "
          f"{devices}; the data-parallel check: world 1 over NCCL"
          + (" and world 2 over NCCL, a card a rank" if n_gpu >= 2 else
             " (world 2 needs a second card: NCCL refuses two ranks on "
             "one device)"), flush=True)
    cfg = inloc_config()
    (query,) = inloc_images(torch, dev, INLOC_QUERY_HW, 1, seed=21)
    panos = inloc_images(torch, dev, INLOC_PANO_HW, 2, seed=22, source=query)
    params = inloc_params(torch, cfg, dev, query)
    src, tgt = (device_preprocess(torch.as_tensor(a[None]).to(dev), INLOC_SIDE,
                                  INLOC_K) for a in (query, panos[0]))
    fine_hb = tgt.shape[1] // 16
    numbers = sharded_forward_check(torch, nc_fused_lane, conv4d_pallas, cfg,
                                    params, mesh, src, tgt)
    print(f"multi-gpu spatial_forward: the IVD model (bf16, k {INLOC_K}) on "
          f"the pair {tuple(src.shape)} x {tuple(tgt.shape)} (fine hB "
          f"{fine_hb}, padded to the shardable {fine_hb + (-fine_hb) % (2 * INLOC_K)}), "
          f"2 shards: volume {numbers['shape']}, vs the unsharded forward "
          f"normalized {numbers['normalized_err']:.3e} (tolerance "
          f"{SERVE_TOLERANCE:.4f}), relocalization offsets equal "
          f"{numbers['delta_equal_share']:.5f}; launches "
          f"{numbers['launches']}; {numbers['ms']:.1f} ms (unsharded "
          f"{numbers['plain_ms']:.1f} ms), peak memory "
          f"{numbers['peak_bytes']} bytes", flush=True)
    if numbers["normalized_err"] > SERVE_TOLERANCE or any(
            numbers["launches"].values()):
        raise SystemExit("multi-gpu spatial_forward: disagrees with the "
                         "unsharded forward or launched B6/B5")

    kw = dict(do_softmax=True, both_directions=True, flip_direction=False,
              preprocess_image_size=INLOC_SIDE)
    plain = make_pair_matcher(cfg, params, **kw)
    sharded = make_pair_matcher(cfg, params, mesh=mesh, **kw)
    vol = inloc_volume(INLOC_QUERY_HW, INLOC_PANO_HW)
    shares = []
    for img in panos:
        want = plain(plain.preprocess(query[None]), img[None])
        got = sharded(sharded.preprocess(query[None]), img[None])
        shares.append(table_agreement(got, want, (vol[1:], INLOC_K)))
    print(f"multi-gpu matcher: make_pair_matcher(mesh=) tables vs the "
          f"unsharded matcher's on {len(panos)} cutouts: (share of matches "
          f"shared, max score difference) {shares}", flush=True)
    if any(s < 0.9 or d > 2e-2 for s, d in shares):
        raise SystemExit("multi-gpu matcher: the sharded tables disagree")
    del params, plain, sharded
    torch.cuda.empty_cache()
    dp_fit_world1(torch, f_run, dev)
    if n_gpu >= 2:
        dp_fit_world2(torch, f_run)
    print(f"multi-gpu: phase M in {time.perf_counter() - t_phase:.1f} s on "
          f"{card_line()}", flush=True)
    return numbers


# ---------------------------------------------------------------------------
# phase O: the operator tools (ncnet_tpu_torch/tools, cli/point_transfer_demo)
# on what the earlier phases left behind, and the probes at full width
# ---------------------------------------------------------------------------

# phase -> {name: path kept for phase O, "facts": what the phase counted}
LEFT = {}
STREAM_PROBE = dict(streams=2, frames=8, side=192)
SERVE_PROBE_SIDE, SERVE_PROBE_PAIRS = 400, 8


def leave(phase, facts=None, **files):
    """Copy a phase's ``files`` (name -> path; mtimes kept) into phase O's
    directory, beside what the phase counted (``facts``)."""
    import tempfile

    if "dir" not in LEFT:
        LEFT["dir"] = tempfile.mkdtemp(prefix="chip_smoke_left_")
    os.makedirs(os.path.join(LEFT["dir"], phase), exist_ok=True)
    kept = LEFT.setdefault(phase, {"facts": facts or {}})
    for name, path in files.items():
        kept[name] = os.path.join(LEFT["dir"], phase, name + ".jsonl")
        shutil.copy2(path, kept[name])


def tool_run(module, argv):
    """A tool's ``main(argv)`` in this process: (exit code, what it wrote
    to stdout), through its ``_out`` writer too where it binds one."""
    import io

    out = io.StringIO()
    saved = getattr(module, "_out", None)
    if saved is not None:
        module._out = out.write
    try:
        with contextlib.redirect_stdout(out):
            rc = module.main(list(argv))
    finally:
        if saved is not None:
            module._out = saved
    return rc, out.getvalue()


def fresh_heartbeat(heartbeat, events):
    """Phase O, at the end of phase F's fit: the port's ``stall_watchdog``
    judges the fresh heartbeat alive (exit 0)."""
    from ncnet_tpu_torch.tools import stall_watchdog

    rc, out = tool_run(stall_watchdog, [heartbeat, "--events", events,
                                        "--json"])
    v = json.loads(out)
    print(f"tools: stall_watchdog on fit's fresh heartbeat: exit {rc}, "
          f"{v['status']} (age {v.get('age_s')} s against "
          f"{v.get('threshold_s')} s, median step wall "
          f"{v.get('median_step_wall_s')} s)", flush=True)
    if rc != 0 or v["status"] != "alive":
        raise SystemExit("tools: the watchdog did not judge fit alive")


def live_plane_tools(rurl, aurl):
    """Phase O, inside phase N while its pod serves: ``serve_top --once``
    on backend A and ``stall_watchdog --url`` on the router and A."""
    from ncnet_tpu_torch.tools import serve_top, stall_watchdog

    t0 = time.perf_counter()
    rc_top, frame = tool_run(serve_top, [aurl, "--once"])
    rc_wd, out = tool_run(stall_watchdog, ["--url", rurl, "--url", aurl,
                                           "--json"])
    pod = json.loads(out)
    states = {u: (v["status"], v.get("state"), v.get("role"))
              for u, v in pod["targets"].items()}
    print(f"tools: serve_top --once on backend A: exit {rc_top}, "
          f"{len(frame.splitlines())} lines, '{frame.splitlines()[1]}'; "
          f"stall_watchdog --url router --url A: exit {rc_wd}, {states} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    if rc_top != 0 or "state: READY" not in frame or rc_wd != 0 \
            or pod["status"] != "alive":
        raise SystemExit("tools: the live plane's tools did not see a "
                         "serving pod")


def federation_nests(doc, eps_us=10_000.0):
    """(backend slices, the traces of those not nested in their router
    slice, the largest overhang of a slice's end past its router slice's in
    ms, flow starts) of a federated trace document.  A backend admits a
    request after the router sent it and ends its slice where it settled
    the request, before the reply leaves, so on aligned clocks each slice
    lies inside its router slice within ``eps_us`` at both ends (the pod
    test's bound)."""
    route = {}
    for e in doc["traceEvents"]:
        if e.get("cat") == "route_request" and e["ph"] == "X" \
                and e["args"].get("trace"):
            route[e["args"]["trace"]] = (e["ts"], e["ts"] + e["dur"])
    slices, loose, over = 0, [], 0.0
    for e in doc["traceEvents"]:
        if e.get("cat") == "serve_request" and e["ph"] == "X":
            slices += 1
            r = route.get(e["args"].get("trace"))
            end = e["ts"] + e["dur"]
            if r:
                over = max(over, end - r[1])
            if not (r and e["ts"] >= r[0] - eps_us and end <= r[1] + eps_us):
                loose.append(e["args"].get("trace"))
    return slices, loose, over / 1e3, sum(1 for e in doc["traceEvents"]
                                          if e["ph"] == "s")


def settle_leads_ms(events):
    """For each result of a backend log, how long after the settle that
    ends its ``request_timeline`` slice its ``serve_result`` was stamped,
    in ms: (count, least, largest).  The largest is what the slice would
    have outlasted its reply by, had it ended at the timeline's own
    append."""
    ends, stamps = {}, {}
    for e in events:
        key = (e.get("run"), e.get("request"))
        if e.get("event") == "request_timeline" \
                and e.get("outcome") == "result":
            ends[key] = e["t0"] + e["total_ms"] * 1e-3
        elif e.get("event") == "serve_result":
            stamps[key] = e["t"]
    leads = [(stamps[k] - t) * 1e3 for k, t in ends.items() if k in stamps]
    return len(leads), min(leads, default=0.0), max(leads, default=0.0)


def tools_phase(torch, nc_fused_lane, sparse_corr, dev):
    """Phase O: the port's operator tools replay phases S, N, Q and F
    (``run_report``, ``trace_export``, ``--federate`` and ``--pod`` on N's
    three logs against what N counted live), judge F's stopped run stalled,
    gate the perf store of L and F and L's quality log, then the probes at
    full width (``stream_probe``: B8 and B6 in its steady segment, no
    coarse pass for a tracked frame; ``serve_probe`` with an injected
    device failure, nothing lost) and the point-transfer demo.  Returns
    the kernels' launches by the probes."""
    import collections
    import tempfile

    import numpy as np

    from ncnet_tpu_torch.cli import point_transfer_demo
    from ncnet_tpu_torch.observability import perfstore
    from ncnet_tpu_torch.observability.events import replay_events
    from ncnet_tpu_torch.tools import (
        perf_regress,
        quality_drift,
        run_report,
        serve_probe,
        stall_watchdog,
        stream_probe,
        trace_export,
    )

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tools_")

    # 1. replays: every kept log through run_report (all sections) and
    # trace_export
    t0 = time.perf_counter()
    replayed = {}
    for phase, names in (("S", ("events",)), ("N", ("router", "A", "B")),
                         ("Q", ("coordinator",)), ("F", ("events",))):
        for name in names:
            path = LEFT[phase][name]
            rc, text = tool_run(run_report, [
                path, "--spans", "--serving", "--rollout", "--memory",
                "--slo", "--retrieval", "--store", "--pod"])
            out = os.path.join(tmp, f"{phase}_{name}.trace.json")
            rc2, _ = tool_run(trace_export, [path, "-o", out])
            with open(out) as f:
                n_events = len(json.load(f)["traceEvents"])
            if rc or rc2 or not n_events:
                raise SystemExit(f"tools: replaying {phase}'s {name} log "
                                 f"failed ({rc}, {rc2}, {n_events} events)")
            replayed[f"{phase}:{name}"] = (len(text.splitlines()), n_events)
    s_rep = run_report.build_report([LEFT["S"]["events"]])["serving"]
    q_rep = run_report.build_report([LEFT["Q"]["coordinator"]])["retrieval"]
    f_rep = run_report.build_report([LEFT["F"]["events"]])
    n_logs = [LEFT["N"][k] for k in ("router", "A", "B")]
    warns = []
    fed = trace_export.build_federated_trace(n_logs, warn=warns.append)
    out = os.path.join(tmp, "pod.trace.json")
    rc_fed, _ = tool_run(trace_export, n_logs + ["--federate", "-o", out])
    slices, loose, over_ms, flows = federation_nests(fed)
    events = []
    for path in n_logs:
        events += replay_events(path)[1]
    pod = run_report.build_pod_section(events)
    rc_pod, _ = tool_run(run_report, n_logs + ["--pod"])
    n_leads, lead_lo, lead_hi = settle_leads_ms(events)
    live = LEFT["N"]["facts"]
    po = pod["outcomes"]
    runs = fed["otherData"]["federation"]["runs"]
    print(f"tools: run_report and trace_export replayed {len(replayed)} logs "
          f"(text lines, trace events) {replayed} in "
          f"{time.perf_counter() - t0:.2f} s; S: admitted "
          f"{s_rep['outcomes']['admitted']} = terminals "
          f"{s_rep['outcomes']['terminals']}, lost "
          f"{len(s_rep['lost_requests'])}; Q: admitted "
          f"{q_rep['outcomes']['admitted']} = terminals "
          f"{q_rep['outcomes']['terminals']}, lost "
          f"{len(q_rep['lost_requests'])}; F: {f_rep['counts']['steps']} "
          f"steps, {f_rep['counts']['checkpoint_commits']} commits, step "
          f"wall p50 {f_rep['step_wall_s'].get('p50')} s", flush=True)
    print(f"tools: N federated (exit {rc_fed}): {slices} backend slices, "
          f"{slices - len(loose)} nested in their router slice at both "
          f"ends within 10 ms (others {loose}; the largest overhang of an "
          f"end {over_ms:.3f} ms; of {n_leads} results, serve_result "
          f"stamped {lead_lo:.3f} to {lead_hi:.3f} ms after the settle "
          f"that ends its slice), {flows} flows, "
          f"corrections s {[r.get('correction_s') for r in runs.values()]}, "
          f"warnings {warns}; run_report --pod (exit {rc_pod}): admitted "
          f"{po['admitted']}, results {po['results']}, terminals "
          f"{po['terminals']}, lost {len(pod['lost_requests'])}, against "
          f"N's live count {live}", flush=True)
    if (s_rep["outcomes"]["unresolved"] or s_rep["lost_requests"]
            or q_rep["outcomes"]["unresolved"] or q_rep["lost_requests"]
            or not f_rep["counts"]["steps"] or rc_fed or rc_pod
            or not slices or loose or not flows or not n_leads
            or lead_lo < -0.002
            or (po["admitted"], po["results"], po["terminals"],
                len(pod["lost_requests"]))
            != (live["admitted"], live["results"], live["terminals"],
                live["lost"])):
        raise SystemExit("tools: a replay disagrees with what its phase "
                         "counted")

    # 2. the watchdog on F's stopped run: stalled once its floor is 0
    hb, f_events = LEFT["F"]["heartbeat"], LEFT["F"]["events"]
    rc_st, text = tool_run(stall_watchdog, [hb, "--events", f_events,
                                            "--min-age", "0", "--json"])
    v = json.loads(text)
    print(f"tools: stall_watchdog --min-age 0 on fit's stopped run: exit "
          f"{rc_st}, {v['status']} (age {v['age_s']} s against "
          f"{v['threshold_s']} s)", flush=True)
    if rc_st != 3 or v["status"] != "stalled":
        raise SystemExit("tools: the watchdog did not judge the stopped "
                         "run stalled")

    # 3. the gates: perf_regress --check on L's and F's store, its findings
    # check_regressions' own; quality_drift green on a reference seeded
    # from L's log, red on one seeded from a perturbed copy
    store = os.path.join(tmp, "perf_history.jsonl")
    with open(store, "w") as g:
        for phase in ("L", "F"):
            with open(LEFT[phase]["store"]) as f:
                g.write(f.read())
    records = perfstore.PerfStore(store).records()
    rc_pr, text = tool_run(perf_regress, ["--check", "--store", store,
                                          "--json"])
    found = json.loads(text)["findings"]
    direct = json.loads(json.dumps(perfstore.check_regressions(records)))
    rc_seed, _ = tool_run(perf_regress, [
        "--seed", os.path.join(tmp, "BENCH_missing.json"), "--store", store])
    log = LEFT["L"]["events"]
    green, red = (os.path.join(tmp, f"ref_{n}.jsonl") for n in ("green", "red"))
    bad = os.path.join(tmp, "perturbed.jsonl")
    quality_drift.perturbed_log(log, bad)
    rc_g1, _ = tool_run(quality_drift, ["--seed-ref", log, "--ref", green])
    rc_g2, _ = tool_run(quality_drift, ["--check", log, "--ref", green])
    rc_r1, _ = tool_run(quality_drift, ["--seed-ref", bad, "--ref", red])
    rc_r2, _ = tool_run(quality_drift, ["--check", log, "--ref", red])
    print(f"tools: perf_regress --check on {len(records)} records of "
          f"phases L and F: exit {rc_pr}, {len(found)} findings "
          f"({sorted({f['status'] for f in found})}), equal to "
          f"check_regressions: {found == direct}; --seed of a missing "
          f"artefact refused with exit {rc_seed}; quality_drift on L's "
          f"log: seeded {rc_g1}, checked {rc_g2} (green), against a "
          f"perturbed copy's reference "
          f"{rc_r2} (red)", flush=True)
    if rc_pr not in (0, 1) or found != direct or rc_seed != 2 \
            or (rc_g1, rc_g2, rc_r1, rc_r2) != (0, 0, 0, 1):
        raise SystemExit("tools: a gate did not answer as it should")

    # 4. the probes at full width, and the demo
    def counts():
        return {"nc_conv4d_bf16": nc_fused_lane.launches,
                "gather_tile_corr_bf16": sparse_corr.launches}

    nc_fused_lane.launches = sparse_corr.launches = 0
    t0 = time.perf_counter()
    sd = stream_probe.probe(**STREAM_PROBE, device=dev,
                            events_path=os.path.join(tmp, "stream.jsonl"))
    stream_launches = counts()
    stream_s = time.perf_counter() - t0
    kinds = [e.get("kind") for e in replay_events(sd["events_path"])[1]
             if e.get("event") == "stream_frame"]
    doc = sd["streams_doc"]
    steady, cold = sd["launches_steady"], sd["launches_cold"]
    want = sd["launches_steady_expected"]
    print(f"tools: stream_probe at full width ({STREAM_PROBE}) in "
          f"{stream_s:.1f} s: steady frame walls ms {sd['steady_wall_ms']}, "
          f"cut recovery ms {sd['cut_recovery_ms']}, per-frame "
          f"coarse-to-fine ms {sd['c2f_frame_ms']}; frames {doc}; coarse "
          f"passes in the steady segment {sd['coarse_passes_steady_delta']} "
          f"for {sd['expected_coarse_passes']} fallback frames, tracked "
          f"dispatches {sd['tracked_dispatches_steady']}; launches cold "
          f"{cold} ({sd['coarse_passes_cold']} dispatches), steady {steady} "
          f"(the structure gives {want}), all {stream_launches}; frame "
          f"kinds from its log {dict(collections.Counter(kinds))}; "
          f"{card_line()}",
          flush=True)
    if (not sd["tracking_feasible"] or not doc["tracked_frames"]
            or sd["coarse_passes_steady_delta"] != sd["expected_coarse_passes"]
            or steady != want or not all(steady.values())
            or len(kinds) != doc["frames"]
            or doc["frames"] != doc["tracked_frames"] + doc["fallback_frames"]
            + doc["cold_frames"]
            or not sd["replay_outcome_identity_ok"]
            or not sd["replay_ordering_ok"]):
        raise SystemExit("tools: the stream probe's tracked frames did not "
                         "run as the path's structure says")

    nc_fused_lane.launches = sparse_corr.launches = 0
    t0 = time.perf_counter()
    vd = serve_probe.probe([SERVE_PROBE_SIDE], SERVE_PROBE_PAIRS, False,
                           True, 1.5, device=dev)
    serve_launches = counts()
    bucket = vd["buckets"][f"{SERVE_PROBE_SIDE}x{SERVE_PROBE_SIDE}"]
    print(f"tools: serve_probe at {SERVE_PROBE_SIDE}x{SERVE_PROBE_SIDE}, "
          f"{SERVE_PROBE_PAIRS} pairs, in {time.perf_counter() - t0:.1f} s: "
          f"request ms {bucket['latency_ms']}, {bucket['qps']} qps, batch "
          f"p50 {bucket['batch_wall_p50_ms']} ms; injected device failure: "
          f"{vd['demotion']}; burst {vd['burst']}; scrape "
          f"{vd.get('scrape_wall_ms')} ms; launches {serve_launches} (the "
          f"dense bf16 400² stack takes the FFT tier); {card_line()}",
          flush=True)
    if vd["demotion"]["replica_failures"] < 1 or vd["demotion"]["lost"] \
            or vd["demotion"]["outcomes"]["other"] \
            or bucket["latency_ms"]["n"] != SERVE_PROBE_PAIRS \
            or any(serve_launches.values()):
        raise SystemExit("tools: the service probe's device failure did not "
                         "fire, it lost a request, or it launched a kernel "
                         "at the FFT tier's shape")

    t0 = time.perf_counter()
    demo = os.path.join(tmp, "demo.png")
    rc_demo, text = tool_run(point_transfer_demo, [
        "--synthetic", "--device", "cuda", "--out", demo])
    with open(os.path.join(tmp, "demo.json")) as f:
        dj = json.load(f)
    pts = np.asarray(dj["transferred_points"])
    print(f"tools: point_transfer_demo --synthetic --device cuda: exit "
          f"{rc_demo} in {time.perf_counter() - t0:.1f} s, "
          f"{text.strip()}; {dj['n_valid']} points, PCK@{dj['alpha']} "
          f"{dj['pck']} (random weights)", flush=True)
    if rc_demo or pts.shape != (2, dj["n_valid"]) or not dj["n_valid"] \
            or not np.isfinite(pts).all() or not 0 <= dj["pck"] <= 1:
        raise SystemExit("tools: the demo did not transfer its points")
    shutil.rmtree(tmp)
    shutil.rmtree(LEFT.pop("dir"))
    print(f"tools: phase O in {time.perf_counter() - t_phase:.1f} s on "
          f"{card_line()}", flush=True)
    return {"stream_probe": stream_launches, "serve_probe": serve_launches}


# ---------------------------------------------------------------------------
# phase X: the tier and stage probes, the goldens, the parity kit and the
# print checker (ncnet_tpu_torch/tools, the root tools' counterparts)
# ---------------------------------------------------------------------------

# (n_long, reps) for every probe's differenced timing in phase X: the
# probes' own (up to 8 and 3) would not fit the script's time
PROBE_TIMING_CAP = (2, 1)
# the training step's probe at the recipe's batch; the gradient probes at
# their root tools' default batch (16 would not fit the script's time)
TRAIN_BATCH_PROBES, GRAD_BATCH_PROBES = 16, 8
# (module, argv, expected kernels: every one of them must launch)
PROBE_RUNS = (
    ("nc_resident_probe", ["8"], ("nc_conv4d_bf16",)),
    ("nc_fused_lane_probe", ["8"], ("nc_conv4d_bf16",)),
    ("nc_vjp_resident_probe", ["8", "pf"], ("nc_vjp",)),
    ("nc_vjp_resident_probe", ["8", "ivd"], ("nc_vjp",)),
    ("sparse_corr_probe", ["--tiny"], ("gather_tile_corr_bf16",)),
    ("sparse_corr_probe", ["--k", "1,2,4,8", "--size", "50", "--c", "1024",
                           "--time"],
     ("gather_tile_corr_bf16", "nc_conv4d_bf16")),
    ("eval_faults_probe", ["25"], ("nc_conv4d_bf16",)),
    ("train_probe", [str(TRAIN_BATCH_PROBES), "bf16", "base=n,y,n,n",
                     "fold=y,y,n,n"], ("nc_vjp",)),
    ("inloc_stage_probe", [], ("nc_conv4d_bf16",)),
    ("filter_stage_probe", ["4"], ()),
    ("filter_combo_probe", ["4"], ()),
    ("xla_layer_probe", ["4"], ()),
    ("xla_conv_probe", ["4"], ()),
    ("inloc_filter_probe", [], ("conv4d_small_cout",)),
    ("sharded_variant_probe", [], ()),
    ("vjp_probe", [str(GRAD_BATCH_PROBES), "bf16"], ()),
    ("vjp_sweep_probe", [str(GRAD_BATCH_PROBES), "bf16"], ()),
    ("nc_grad_split_probe", [str(GRAD_BATCH_PROBES), "bf16"], ()),
    ("train_attr_probe", [str(GRAD_BATCH_PROBES), "bf16", "y"], ()),
    ("cp_fft_probe", ["--tiny"], ()),
    ("cp_fft_probe", ["--ranks", "4,8,16,32", "--size", "25", "--time"], ()),
)


def launch_total(n):
    """A kernel's launches in a probe's counts (B3's: its three kernels)."""
    return sum(n.values()) if isinstance(n, dict) else n


def tool_summary(text):
    """The ``summary {json}`` line a probe prints, or its one-line JSON
    report."""
    for line in reversed(text.splitlines()):
        if line.startswith("summary "):
            return json.loads(line[len("summary "):])
        if line.startswith("{"):
            return json.loads(line)
    return None


def probes_phase(torch, nc_fused_lane, vjp, sparse_corr, conv4d_pallas, dev):
    """Phase X: every port of a root tool without a counterpart before
    this slice, through its ``main`` at full width, its counts set to 0
    just before and read just after; returns the kernels' launches by
    tool."""
    import importlib
    import tempfile

    from ncnet_tpu_torch.config import ModelConfig
    from ncnet_tpu_torch.data.synthetic import write_pf_pascal_like
    from ncnet_tpu_torch.models.ncnet import init_ncnet
    from ncnet_tpu_torch.observability import memory as obs_memory
    from ncnet_tpu_torch.tools import _probe

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_probes_")
    os.environ["NCNET_TPU_MEMORY_LEDGER"] = os.path.join(tmp, "ledger.json")
    saved_store = os.environ.get("NCNET_TPU_PERF_STORE")
    os.environ["NCNET_TPU_PERF_STORE"] = "off"  # the parity kit's PCK run
    _probe.TIMING_CAP = PROBE_TIMING_CAP

    def counts():
        return {"nc_conv4d_bf16": nc_fused_lane.launches,
                "nc_vjp": dict(vjp.launches),
                "gather_tile_corr_bf16": sparse_corr.launches,
                "conv4d_small_cout": conv4d_pallas.launches}

    def reset():
        nc_fused_lane.launches = sparse_corr.launches = 0
        for k in vjp.launches:
            vjp.launches[k] = 0
        for k in conv4d_pallas.launches_by_kernel:
            conv4d_pallas.launches_by_kernel[k] = 0

    # the parity kit's synthetic reference checkpoint (the PF-Pascal
    # architecture, random weights from a seed) and a PF-Pascal-like split
    kit_cfg = ModelConfig(backbone="resnet101", ncons_kernel_sizes=(5, 5, 5),
                          ncons_channels=(16, 16, 1))
    ckpt = os.path.join(tmp, "synthetic_ncnet.pth.tar")
    reference_checkpoint(torch, ckpt, kit_cfg, init_ncnet(kit_cfg, 5))
    pf_root = os.path.join(tmp, "pf")
    write_pf_pascal_like(pf_root, n_pairs=3, image_hw=(96, 96),
                         shift=(16, 16))
    runs = PROBE_RUNS + (
        ("make_goldens", ["--check"], ()),
        ("parity_kit", ["--all", "--pfpascal_checkpoint", ckpt,
                        "--ivd_checkpoint", "", "--dataset", pf_root,
                        "--image_size", "64", "--quiet"], ()),
        ("check_no_bare_print", [], ()),
    )
    launches = {}
    for name, argv, expected in runs:
        module = importlib.import_module(f"ncnet_tpu_torch.tools.{name}")
        key = (name if name not in launches
               else f"{name}:{argv[-1].lstrip('-')}")
        reset()
        t0 = time.perf_counter()
        rc, text = tool_run(module, argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = launches[key] = counts()
        summary = tool_summary(text)
        print(f"probes: {key} {' '.join(argv)}: exit {rc} in {secs:.1f} s, "
              f"launches {got}", flush=True)
        if summary is None:  # the tiny modes and the repo tools
            for line in text.strip().splitlines()[-12:]:
                print(f"probes: {key}: {line}", flush=True)
        else:
            print("probes: " + key + " summary " + json.dumps(
                summary, sort_keys=True, default=str), flush=True)
        missing = [k for k in expected if not launch_total(got[k])]
        if rc or missing:
            print(text, flush=True)
            raise SystemExit(f"probes: {key} exited {rc} or launched none of "
                             f"{missing}")
    rows = {r["program"]: r for r in obs_memory.ledger_rows()
            if r["program"] in ("nc_vjp_resident_probe", "nc_vjp_xla_ad",
                                "sparse_corr_probe", "cp_fft_probe")}
    print(f"probes: measured memory rows {sorted(rows)} in the ledger",
          flush=True)
    if len(rows) != 4:
        raise SystemExit("probes: a probe recorded no measured memory row")
    _probe.TIMING_CAP = None
    os.environ.pop("NCNET_TPU_MEMORY_LEDGER")
    if saved_store is None:
        os.environ.pop("NCNET_TPU_PERF_STORE")
    else:
        os.environ["NCNET_TPU_PERF_STORE"] = saved_store
    shutil.rmtree(tmp)
    print(f"probes: phase X in {time.perf_counter() - t_phase:.1f} s on "
          f"{card_line()}", flush=True)
    return launches


# phase Z: the bench's sections whose metrics it checks (the quality
# section gives the bf16 tier, the stage section the stack's, the memory
# section the D9 rows)
BENCH_SECTIONS = ("forward", "quality", "stages", "filter", "memory",
                  "corr", "sparse")
# the roofline shares a bench line may not exceed 100 % of
BENCH_SHARES = ("roofline_filter_pct_of_tensor_core_bound",
                "filter_bf16_mfu_algorithmic_pct",
                "forward_bf16_mfu_algorithmic_pct",
                "forward_bf16_mfu_pct", "forward_bf16_mfu_executed_pct")


def executed_check(torch) -> int:
    """Phase Z's executed count on a route that launches B6: the bench's
    dense bf16 filter at the 2× feature grid (800² images, the folded 50⁴
    pair), warm.  Its count (``tools/_work.py``) must be the library ops
    that a separate ``FlopCounterMode`` run of the same call counts, plus
    ``stack_work`` of the folded pair times the stack calls its launches
    make, and nothing spectral.  Returns B6's launches."""
    import math

    from torch.utils.flop_counter import FlopCounterMode

    from ncnet_tpu_torch.ops import nc_fused_lane
    from ncnet_tpu_torch.tools import _work, bench

    t0 = time.perf_counter()
    bx = bench.Bench(dev=torch.device("cuda", 0), sizes=bench.Sizes())
    s2 = 2 * bx.feat_side
    fa, fb = bench.feature_pair_input((1, s2, s2, bx.feat_channels), 0.05,
                                      bx.dev)(
        torch.Generator(device=bx.dev).manual_seed(3))
    filt = bench.filter_fn(bx)
    with torch.no_grad():
        filt(fa, fb)
        with FlopCounterMode(display=False) as fc:
            filt(fa, fb)
        nc_fused_lane.launches = 0
        _, ex = _work.executed_work(lambda: filt(fa, fb))
        torch.cuda.synchronize()
    launches = nc_fused_lane.launches
    layers = len(bench.KERNELS)
    stack = stack_work((2,) + (s2,) * 4, bench.KERNELS, bench.CHANNELS)[0]
    want = fc.get_total_flops() + stack * launches / layers
    print(f"bench: executed count of the dense 2x filter (2 x {s2}^4, B6): "
          f"{ex.total / 1e9:.4f} GFLOP (library {ex.library / 1e9:.4f}, "
          f"spectral {ex.spectral / 1e9:.4f}, kernels "
          f"{ {k: v / 1e9 for k, v in ex.kernels.items()} }, launches "
          f"{ex.launches}); stack_work x {launches}/{layers} + the library "
          f"ops: {want / 1e9:.4f} GFLOP; {time.perf_counter() - t0:.1f} s",
          flush=True)
    if (launches != layers or ex.launches["nc_conv4d_bf16"] != launches
            or sum(ex.launches.values()) != launches or ex.spectral != 0
            or not math.isclose(ex.total, want, rel_tol=1e-12)):
        raise SystemExit("bench: the executed count is not the kernels' "
                         "roofline work plus the library ops")
    return launches


def bench_phase(torch):
    """Phase Z: ``python -m ncnet_tpu_torch.tools.bench`` at full width as a
    user runs it, on ``BENCH_SECTIONS``, recording into a temporary store;
    then ``perf_regress --seed`` of its line into that store and
    ``--check``; then :func:`executed_check`.  Returns the sparse section's
    kernel launches and the executed check's B6 launches."""
    import math
    import tempfile

    from ncnet_tpu_torch.observability import perfstore
    from ncnet_tpu_torch.tools import perf_regress

    tmp = tempfile.mkdtemp(prefix="chip_smoke_bench_")
    store = os.path.join(tmp, "store.jsonl")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ncnet_tpu_torch.tools.bench", "--only",
         ",".join(BENCH_SECTIONS), "--store", store],
        cwd=HERE, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        if line.startswith("bench:"):
            print(line, flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr, flush=True)
        raise SystemExit(f"bench: exit {proc.returncode}")
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    artefact = os.path.join(tmp, "bench.json")
    with open(artefact, "w") as f:
        json.dump(doc, f)
    extra, sections = doc["extra"], doc["sections"]
    numbers = {k: v for k, v in extra.items() if not isinstance(v, str)}
    finite = (isinstance(doc["value"], float) and math.isfinite(doc["value"])
              and all(isinstance(v, (int, float)) and math.isfinite(v)
                      for v in numbers.values()))
    shares = {k: extra.get(k) for k in BENCH_SHARES}
    tiers = (extra.get("quality_tier_bf16"), extra.get("filter_stage_tier"))
    # the sparse section's structure: the coarse selection's 25⁴ volume
    # takes FFT (no kernel); a coarse-to-fine call gathers each family's
    # tiles (2 B8) and runs the 3-layer stack on both (6 B6); the dense 2×
    # filter runs the stack once on the folded 50⁴ pair (3 B6); every other
    # section's 25⁴ volumes take FFT
    sp = sections["sparse"]
    calls = sp["calls"]
    want_sparse = {"nc_conv4d_bf16": 6 * calls["coarse2fine"]
                   + 3 * calls["dense"],
                   "gather_tile_corr_bf16": 2 * calls["coarse2fine"],
                   "conv4d_small_cout": 0, "nc_vjp": 0}
    others = {k: v["launches"] for k, v in sections.items() if k != "sparse"}
    print(f"bench: {proc.stdout.count(chr(10))} stdout line, exit "
          f"{proc.returncode} in {wall:.1f} s; device_kind "
          f"{doc['envelope'].get('device_kind')!r}; headline "
          f"{doc['value']} ms a pair; {len(numbers)} numbers all finite: "
          f"{finite}; shares {shares}; tiers (quality bf16, stages) {tiers}; "
          f"sparse calls {calls} launches {sp['launches']} (structure "
          f"{want_sparse}); the other sections' launches {others}",
          flush=True)
    if set(sections) != set(BENCH_SECTIONS) or doc.get("failed"):
        raise SystemExit(f"bench: sections {sorted(sections)}, failed "
                         f"{doc.get('failed')}")
    if doc["envelope"].get("device_kind") != torch.cuda.get_device_name(0):
        raise SystemExit("bench: the envelope names another device")
    if not finite:
        raise SystemExit("bench: a metric is not finite")
    print(f"bench: the whole bf16 forward: forward_bf16_tflops "
          f"{extra.get('forward_bf16_tflops')}, forward_bf16_mfu_pct "
          f"{extra.get('forward_bf16_mfu_pct')}, "
          f"forward_bf16_mfu_executed_pct "
          f"{extra.get('forward_bf16_mfu_executed_pct')} (device_kind "
          f"{extra.get('device_kind')!r}) on {card_line()}", flush=True)
    if not all(isinstance(v, float) and 0 < v <= 100 for v in shares.values()):
        raise SystemExit("bench: a roofline share is missing or above 100 %")
    if not (isinstance(extra.get("forward_bf16_tflops"), float)
            and extra["forward_bf16_tflops"] > 0
            and extra.get("device_kind") == torch.cuda.get_device_name(0)):
        raise SystemExit("bench: the whole forward's rate or the card's "
                         "name is missing")
    if tiers != ("fft", "fft"):
        raise SystemExit("bench: the 25⁴ stack did not take the FFT tier")
    if sp["launches"] != want_sparse or not calls["coarse2fine"] or any(
            n for v in others.values() for n in v.values()):
        raise SystemExit("bench: the kernels did not launch as the "
                         "sections' structure says")
    recorded = len(perfstore.PerfStore(store).records())
    rc_seed, _ = tool_run(perf_regress, ["--seed", artefact, "--store", store])
    seeded = len(perfstore.PerfStore(store).records()) - recorded
    rc_check, text = tool_run(perf_regress, ["--check", "--store", store,
                                             "--json"])
    found = json.loads(text)["findings"]
    print(f"bench: the run recorded {recorded} perf records; perf_regress "
          f"--seed of its line exit {rc_seed} (+{seeded}), --check exit "
          f"{rc_check} ({len(found)} findings: "
          f"{sorted({f['status'] for f in found})})", flush=True)
    if rc_seed != 0 or seeded != recorded or rc_check != 0:
        raise SystemExit("bench: perf_regress did not seed and pass the "
                         "bench's line")
    shutil.rmtree(tmp)
    return sp["launches"], executed_check(torch)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from ncnet_tpu_torch.ops import (
        conv4d_pallas,
        kernel_build,
        nc_fused_lane,
        nc_fused_lane_vjp,
        sparse_corr,
    )

    print(card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: torch.backends.cuda.matmul.allow_tf32=False, "
          "torch.backends.cudnn.allow_tf32=False", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t_start = time.perf_counter()

    def mark(phase):
        print(f"phase {phase} done at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    t0 = time.perf_counter()
    logs = kernel_build.build()
    print(f"build: {sorted(logs) or 'cached'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for src, log in logs.items():
        spills = [ln for ln in log.splitlines()
                  if "spill" in ln and not ln.strip().endswith(
                      "0 bytes spill stores, 0 bytes spill loads")]
        regs = [ln.split("Used", 1)[1].strip() for ln in log.splitlines()
                if "Used" in ln and "registers" in ln]
        print(f"build {src}: {len(regs)} kernels; registers/smem: {regs}; "
              f"spilling: {spills or 'none'}", flush=True)

    if set(logs) == set(kernel_build.SOURCES):
        # every port source was just built anew by this toolchain: phase T's
        # port_kernels probe reads this build instead of repeating it
        from ncnet_tpu_torch.tools import mosaic_probes

        mosaic_probes._port_build = (True, "\n".join(
            f"== {src}\n{log}" for src, log in logs.items()))
    dev = torch.device("cuda", 0)
    main_numbers = check_kernels(torch, nc_fused_lane, dev)
    backward_numbers = check_backward(torch, nc_fused_lane, nc_fused_lane_vjp, dev)
    b5_numbers, b5_by_shape = check_b5(torch, conv4d_pallas, dev)
    mark("3")
    gather_numbers = check_gather(torch, sparse_corr, dev)
    l2_numbers, probe_numbers = probe_tools(torch, dev)
    mark("A, T")
    w_numbers, w_launches = shape_class_phase(
        torch, nc_fused_lane, nc_fused_lane_vjp, sparse_corr, dev)
    mark("W")
    serve_launches = serve(torch, nc_fused_lane, dev)
    train_launches, train_start, train_walls = train(
        torch, nc_fused_lane, nc_fused_lane_vjp, dev)
    mark("4, 5")
    engine, params, requests, tables, c2f_launches, dense_launches = serve_c2f(
        torch, nc_fused_lane, sparse_corr, dev)
    tracked_launches = serve_tracked(torch, nc_fused_lane, sparse_corr, engine,
                                     params, requests, tables)
    b5_by_path, b5_path_err = serve_fp32(torch, nc_fused_lane, conv4d_pallas, dev)
    mark("B, C, D")
    service_launches, stream_launches = serve_service(
        torch, nc_fused_lane, sparse_corr, params)
    mark("S")
    pod_launches = pod_phase(torch, params)
    del engine, params
    mark("N")
    eval_launches = eval_phase(torch, nc_fused_lane, dev)
    reloc_launches = serve_reloc(torch, nc_fused_lane, dev)
    loop_launches, cli_launches = eval_loop(torch, nc_fused_lane, sparse_corr,
                                            dev)
    mark("E, R, L")
    f_run = {}
    fit_launches = fit_phase(torch, nc_fused_lane, nc_fused_lane_vjp, dev,
                             train_start, train_walls, keep=f_run)
    del train_start
    mark("F")
    chain_numbers, inloc_launches, inloc_tree = inloc_phase(
        torch, nc_fused_lane, conv4d_pallas, dev)
    nc_fused_lane.launches = 0
    localization_phase(torch, dev, inloc_tree)
    if nc_fused_lane.launches:
        raise SystemExit("localization: phase P launched an NC kernel")
    mark("P")
    retrieval_launches = retrieval_phase(torch, nc_fused_lane, dev)
    mark("Q")
    trunk_nc, trunk_b3, trunk_b4, trunk_gather = trunks_phase(
        torch, nc_fused_lane, nc_fused_lane_vjp, sparse_corr, dev, f_run)
    mark("V")
    sharded_numbers = multi_gpu_phase(torch, nc_fused_lane, conv4d_pallas,
                                      dev, f_run)
    shutil.rmtree(f_run["tmp"])
    mark("M")
    probe_launches = tools_phase(torch, nc_fused_lane, sparse_corr, dev)
    mark("O")
    x_launches = probes_phase(torch, nc_fused_lane, nc_fused_lane_vjp,
                              sparse_corr, conv4d_pallas, dev)
    mark("X")
    bench_launches, executed_launches = bench_phase(torch)
    mark("Z")

    def x_paths(kernel):
        # phase X: each probe that launched the kernel, read with its counts
        # set to 0 just before it
        return {f"probe:{k}": v[kernel] for k, v in x_launches.items()
                if launch_total(v[kernel])}
    nc_by_path = {**{k: v["nc_conv4d_bf16"] for k, v in w_launches.items()},
                  "serve": serve_launches,
                  "train": train_launches["nc_conv4d_bf16"],
                  "serve_coarse2fine": c2f_launches["nc_conv4d_bf16"],
                  "serve_tracked": tracked_launches["nc_conv4d_bf16"],
                  "serve_service": service_launches["nc_conv4d_bf16"],
                  "serve_stream": stream_launches["nc_conv4d_bf16"],
                  # phase N: the backends' launches, each backend process
                  # counting from its READY to its exit
                  "serve_pod": pod_launches["nc_conv4d_bf16"],
                  "dense_800": dense_launches,
                  "eval_400": eval_launches,
                  "reloc_1600": reloc_launches,
                  **{k: v["nc_conv4d_bf16"] for k, v in loop_launches.items()},
                  "eval_cli_400": cli_launches,
                  **inloc_launches,
                  # phase Q: the retrieval shortlist's runs (backbone and
                  # raw index) and the coverage fallback to the .mat order
                  **retrieval_launches,
                  **{k: v["nc_conv4d_bf16"] for k, v in fit_launches.items()},
                  **trunk_nc,
                  # the hB-sharded InLoc forward runs the conv4d formulations
                  "inloc_sharded": sharded_numbers["launches"]["nc_conv4d_bf16"],
                  # phase O: the operator tools' probes at full width
                  **{k: v["nc_conv4d_bf16"] for k, v in probe_launches.items()},
                  **x_paths("nc_conv4d_bf16"),
                  # phase Z: the bench's sparse section, in its own process
                  "bench:sparse": bench_launches["nc_conv4d_bf16"],
                  "bench:executed_dense_800": executed_launches}
    b3_by_path = {**{k: {n: v[n] for n in nc_fused_lane_vjp.launches}
                     for k, v in w_launches.items()
                     if "nc_vjp_dw" in v},
                  "train": {k: train_launches[k]
                            for k in nc_fused_lane_vjp.launches},
                  **{k: {n: v[n] for n in nc_fused_lane_vjp.launches}
                     for k, v in fit_launches.items()},
                  **trunk_b3, **x_paths("nc_vjp")}
    gather_by_path = {"w_serve_c2f_32ch": w_launches["w_serve_c2f_32ch"][
                          "gather_tile_corr_bf16"],
                      "serve_coarse2fine": c2f_launches["gather_tile_corr_bf16"],
                      "serve_tracked": tracked_launches["gather_tile_corr_bf16"],
                      "serve_service": service_launches["gather_tile_corr_bf16"],
                      "serve_stream": stream_launches["gather_tile_corr_bf16"],
                      "serve_pod": pod_launches["gather_tile_corr_bf16"],
                      **{k: v["gather_tile_corr_bf16"]
                         for k, v in loop_launches.items()},
                      **trunk_b4,
                      **{k: v["gather_tile_corr_bf16"]
                         for k, v in probe_launches.items()},
                      **x_paths("gather_tile_corr_bf16"),
                      "bench:sparse": bench_launches["gather_tile_corr_bf16"]}

    kernels = [{
        "name": "nc_conv4d_bf16",
        "route": "cuda",
        "source": "ncnet_tpu_torch/csrc/nc_conv4d.cuh",
        # nc_stack_resident, the whole-stack kernel the bf16 path takes; the
        # per-layer _conv_fused_lane is one launch of the same kernel
        "replaces": "ncnet_tpu/ops/nc_fused_lane.py:606",
        "also_replaces": "ncnet_tpu/ops/nc_fused_lane.py:121",
        # each path read with its counts set to 0 just before it
        "launches": sum(nc_by_path.values()),
        "launches_by_path": nc_by_path,
        "design": "tensor-core, PR 6",
        **main_numbers,
        # the InLoc tap-swap chain (3, 1, 32), (3, 32, 2) on the full pooled
        # volume (phase I), beside the two-pass (16, 1) route on it
        "inloc_chain": chain_numbers,
        # phase W: the gate against the libraries, the class layers' largest
        # errors, and path (a)'s request walls and stack and layer ms
        "shape_class": {"classes": w_numbers["classes"],
                        "serve_c2f_32ch": w_numbers["serve_c2f_32ch"]},
        # no single PyTorch call computes a 4D convolution
        "library_ms": None,
    }, {
        "name": "nc_vjp (nc_vjp_dw_bf16, nc_vjp_reduce_f32, nc_conv4d_transpose_bf16)",
        "route": "cuda",
        "source": "ncnet_tpu_torch/csrc/nc_conv4d_vjp.cuh",
        "also_source": "ncnet_tpu_torch/csrc/nc_conv4d.cuh",
        "replaces": "ncnet_tpu/ops/nc_fused_lane_vjp.py:490",
        # the three kernels' launches in the timed training steps (phase
        # 5) and in phase F's fit runs, each path read with its counts set
        # to 0 just before it
        "launches": sum(sum(v.values()) for v in b3_by_path.values()),
        "launches_by_path": {k: sum(v.values()) for k, v in b3_by_path.items()},
        "launches_by_kernel": {k: sum(v[k] for v in b3_by_path.values())
                               for k in nc_fused_lane_vjp.launches},
        # dW/db (nc_vjp_dw_bf16) redesigned as B7; the transposed conv is
        # B6's kernel
        "design": "tensor-core, PR 7",
        **backward_numbers,
        # phase W: paths (b) and (c), their step walls and B7's ms a layer
        "shape_class": {"train_8ch": w_numbers["train_8ch"],
                        "train_rect_ivd": w_numbers["train_rect_ivd"]},
        # no single PyTorch call computes a conv4d backward
        "library_ms": None,
    }, {
        "name": "gather_tile_corr_bf16",
        "route": "cuda",
        "source": "ncnet_tpu_torch/csrc/gather_tile_corr.cu",
        "replaces": "ncnet_tpu/ops/sparse_corr.py:196",
        "launches": sum(gather_by_path.values()),
        "launches_by_path": gather_by_path,
        "design": "tensor-core, PR 6",
        # one launch at the serving shape; library_ms is one cuBLAS batched
        # product (einsum) on target patches gathered beforehand
        **gather_numbers,
        # the same at the VGG-16 (512) and DenseNet-201 (256) widths
        "by_channels": trunk_gather,
    }, {
        "name": "conv4d_small_cout",
        "route": "cuda",
        "source": "ncnet_tpu_torch/csrc/conv4d_small_cout.cu",
        # _fwd_impl, the pallas_call behind conv4d_small_cout (:133)
        "replaces": "ncnet_tpu/ops/conv4d_pallas.py:146",
        "launches": sum(b5_by_path.values())
        + sum(x_paths("conv4d_small_cout").values()),
        # the hB-sharded InLoc forward convolves valid along hB: never B5;
        # phase X's probes where the chooser's auto route reaches it
        "launches_by_path": {**b5_by_path, "inloc_sharded": sharded_numbers[
            "launches"]["conv4d_small_cout"],
            **x_paths("conv4d_small_cout")},
        # k = 3, 5 on the tensor cores (f32 as three bf16 products)
        "design": "tensor-core, PR 8",
        # one launch at the fp32 800² path's shape (4, 50⁴, 16) -> 1 (its
        # cuda_core_ms and cuda_core_normalized_err: the first design on the
        # same inputs); the largest error of the path's own launches beside it
        **b5_numbers,
        "path_max_abs_err": b5_path_err,
        "ms_by_shape": b5_by_shape,
        # no single PyTorch call computes a conv4d; coutfold_ms (above) is
        # the cuDNN formulation's time, context only
        "library_ms": None,
    }, {
        "name": "conv_l2_fused_lane",
        "route": "cuda",
        "source": "ncnet_tpu_torch/csrc/conv_l2_fused_lane.cu",
        # conv_l2_pallas, whose pallas_call is at :114
        "replaces": "tools/pallas_l2_probe.py:101",
        "launches_by_path": {"l2_probe": l2_numbers["launches"]},
        "design": "tensor-core, PR 9",
        # one launch at B = 8 with bf16 Y terms (f32_y: the f32 ones), its
        # pre-pass and weight packing included; coutfold_ms is the cuDNN
        # formulation + relu, context only
        **l2_numbers,
        "library_ms": None,
    }, {
        "name": "mosaic_probes",
        "route": "cuda",
        "source": "ncnet_tpu_torch/csrc/probes/",
        # _compile, whose pallas_call is at :28
        "replaces": "tools/mosaic_probes.py:26",
        "launches_by_path": {"mosaic_probes": probe_numbers["launches"]},
        # a toolchain probe carries no workload: no bound, no library call;
        # ms and plain_ms are the probes' launches and twins summed
        **probe_numbers,
        "bound_ms": None,
        "bound_by": None,
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--pod-backend":
        sys.exit(pod_backend(json.loads(sys.argv[2])))
    sys.exit(main())
