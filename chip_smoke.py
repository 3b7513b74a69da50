#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: build, check and drive it on one card.

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper, sm_90a) and ``nvcc``; imports no JAX. Inputs
come from ``np.random.default_rng(0)`` (the wideband stream's noise from
PyTorch's generator on the card, seed 0). Every phase prints a line, and any
failure exits non-zero:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: the kernels compiled from ``digital_signal_processsing_tpu_torch/csrc``, and
   B19's and B20's registers, local bytes, shared bytes, blocks an SM and
   threads by plan (``channelizer.pfb_kernel_attrs``), B12's and B13's by
   sections (``iir.cascade_kernel_attrs``), B1's by channels
   (``pallas_scan.windowed_kernel_attrs``) and B5's by window and channels
   (``pallas_direct.direct_kernel_attrs``);
3. corners: each kernel (B1 windowed, B2 packed, B3 scan in its three
   variants, B4 cumsum and the two-pass route, B5 direct) against its plain
   PyTorch version on the card, bit-exact, over k in {1, 16, 1024, 65535}
   (B5: {1, 16, 64, 256}), C in {1, 2, 3, 16} (the tensor-core B3 refuses
   C=3, which is checked), frames in {1, 127, 129, 2^20+C}, all-INT16_MIN
   input, seeded calls, an int32 wrap, B3 with windows across span
   boundaries and at the largest halo it takes, and at all-INT16_MAX input at k = 1 and that halo;
   B4 at C in {1, 3, 16, 4099, the largest it takes}, on views 2 to 14 bytes off the
   16-byte grid, over streams of many more tiles than resident blocks (up to
   2^24 samples), three calls bit-identical, and wrapping at C = 16;
   B1 also against the NumPy golden model on a slice, on views 2 to 14 bytes
   off the 16-byte grid (seeded too), with its range entry split into two
   launches at every tile boundary of a 9-tile stream (seeded and not), in
   spans of one tile, at C in {1, 2, 3, 5, 16} for k = 1, a halo past a
   tile and the largest halo it takes, and at INT16_MIN and INT16_MAX there;
   B2 (B1's launch on the pair words' int16 view) at C in {1, 2, 3, 16} for
   k = 1, a halo past a tile and the two largest windows of its bound, unseeded
   and seeded (odd k*C: a seed of k + 1 frames), at INT16_MIN and INT16_MAX,
   and on views 4, 8 and 12 bytes off the 16-byte grid, each call one B2
   launch and no B1 launch;
   then B8 and B9 (the fused overlap-save FIR) against their plain versions
   (within 1e-5 of max|y|) and a float64 FIR on a slice (1e-4) over taps
   {1, 2, 63, 257, the crossover +- 1, the largest B8 takes, the first B9
   takes, 65537, the largest B9 takes}, C in {1, 3, 16} and five lengths;
   B9 at every nfft it takes (2^15 to 2^20) and at its wave boundaries (one
   wave exactly full, one pair over, and at a scratch of one and two pairs,
   waves of one pair); impulses across segment edges, zeros exact; conv1d's
   error in IEEE fp32;
   then the IIR kernels B10, B12 (seeded and not), B13 and B15 against their
   plain versions (1e-5 of max|y|) and scipy's float64 filter (1e-4) over
   sections {1, 2, 4, 8}, C {1, 3, 16}, T {1, 4095, 4096, 4097, odd, 100003}
   and 16 x 2^22, first-order a {0.5, -0.3, 0.99, 0.9999}; seeded chunks
   whose end states match the float64 state at their last sample, impulses
   across sub-tile edges, zeros exact, B13 at every instance (1 to 8
   sections) bit-identical over two calls; past the largest instances
   (the wrappers chain groups) B13 at 9 and 17 sections, ``sosfilt``,
   ``sosfilt_chunk``, ``sosfiltfilt`` and B14 at 17; B12's
   look-back at sections {1, 4, 8, 16} over tile counts one below, at, one
   above and past three times its depth, seeded and not, ragged, with tiles
   longer than a block holds, and impulses at tile edges; then the PFB
   kernels B19 (raw stream) and B20 (commutated tensor) against their plain
   versions and a float64 FFT of the formula (1e-5 of max|Y|) over n in {32,
   48, 64, 96, 128, 256, 512, 1024} (B19 inside its envelope), P {2, 8, 16},
   dilation {1, 2}, sign -1, whole and ragged steps, streams shorter than
   the look-back, every output layout, zeros and impulses at a step edge;
   B20 at every plan (n = 2..8192, 3 * 2^a up to 6144, the direct DFT's 1
   and 7) at 16 taps and dilation 2 (look-backs longer than a step, cut to
   fit at the largest n), and runs of several steps a block (B19 n=64, 1024;
   B20 n=48, 64) with impulses at step and run edges;
   B21 (segmented Farrow) against plain and float64 (2e-5) over six rates, C
   {1, 2, 16} and T {4, 5, 100, 2^20}; the Farrow matmul and the composed
   bank against float64 with TF32 turned on by the caller (their IEEE float32
   pin); then the time-varying kernels B16 (every section, S in {1, 2, 4, 6,
   16, 17}), B17 (one section) and B18 (a row a frame, frame_len {100, 256,
   768, 1000, 1024, 65536}: both sides of its state route's condition, the
   route each corner took printed) against their plain versions and a float64
   sample loop (1e-5 of max|y|) over C {1, 3, 5, 64}, T {1, below a
   sub-tile, ragged, 100003, 3 x 65536 + 99}, shared and per-channel rows
   with a0 != 1, seeded, unseeded and zero-seeded (bit for bit), the expand
   route at frame_len 100,
   impulses at tile edges, zeros exact; B22 (the LPC recurrence) at p {1, 2,
   12, 32, 40}, L {8, 33, 100, 256} and ragged frame counts, its full and
   state-only entries bit for bit against plain and within 1e-5 of float64; then the anchors B11 (first order, per-sample
   affine maps) at a {0.5, -0.3, 0.99, 0.9999} and B14 (the cascade with its
   lane pass on the FP64 tensor cores) at sections {1, 2, 4, 8, 16} and on
   butter, cheby2 and elliptic designs of ``iir_design``, both row passes,
   against their plain versions (1e-5 of max|y|) and float64 (1e-4) over C
   {1, 3, 16}, T {1, 4095, 4096, 4097, 100003} and 16 x 2^22; impulses at
   segment, sub-tile and tile edges, zeros exact, their refusals; and the
   high-Q end, 16 sections of butter(32, 0.1), where B12 is held to float64
   within HIGHQ_FACTOR x plain's own error;
4. main path, through the entry points a user calls, with the kernels'
   launch counts reset just before and read just after:
   ``moving_average`` on a 64M-sample stereo stream at k=1024 (B1), the same
   stream as 16 channels at k=65535 (two-pass, B4), its int32 pair view
   (B2), the methods ``scan``, ``scan_hillis`` and ``scan_mxu`` at k=1024
   (B3), ``direct`` at k=64 and k=256 (B5), ``xla_scan`` and ``xla_direct``,
   ``stream_moving_average`` over two WAVs (~16M samples, the second of odd
   frame count) and the CLI; every route name asserted and every output
   bit-exact against its plain version, B1 or the one-shot result; then
   ``harness.sweep.run_suite`` over the ``--smoke`` grid and a 64M row at
   k=1024 for the scan variants, with 0 failures; then, counts reset again,
   the receiver chain on 16 x 2^22 samples: the flagship ``DspChain``
   (16 channels, decimation 8), the same with 8193 channel taps (B8), the
   fused frontend, ``fir_filter`` at 8193 (B8) and 8194 taps (B9), and the
   flagship streamed in 8 chunks; routes asserted, B8 and B9 launched, each
   chain against the chain on the CPU over the first 2^16 samples, the
   stream against one shot; then, counts reset again, the IIR family on
   16 x 2^22 float32 through butter(8, 0.1): ``sosfilt`` auto (B12), method
   ``pallas`` (B15), ``unroll_sections=True`` (B13), ``dc_block`` and ``agc``
   (B10), ``sosfiltfilt`` and ``decimate(..., ftype="iir")`` on one channel,
   and ``stream_sosfilt`` over the two WAVs above in chunks of 2^20; routes
   asserted, the four kernels launched, outputs against their plain versions
   and float64, the served stream within 1 LSB of one shot on < 0.2%; then,
   counts reset again, the wideband receiver (``WidebandFmReceiver``, 64
   channels, 8 taps a phase) on 2^26 samples of FM tones against the same
   receiver on the CPU (B19), the same at 1024 channels, ``pfb_channelize``
   one shot and in 8 chunks, ``pfb_analyze_os`` (B20, dilation 2) and its
   synthesis, the ``fused`` route at n=48 (B20), the chain locked to 441/2560
   by the Farrow stage (B21 on the card), and ``resample_farrow`` at
   46337/65521 on 16 x 2^22 (B21); B19, B20 and B21 each launched; then,
   counts reset again, the time-varying family on 16 x 2^22 float32 with 4
   sections of swept per-sample rows shared by the channels: ``sosfilt_tv``
   auto (B16) and ``method="scan"`` (B17 a section), ``sosfilt_tv_chunk`` in
   8 chunks of any length, one sample and ragged ones among them (B17 seeded
   on each whole chunk), ``sosfilt_tv_frames`` at frame_len 1024 and 65536
   (B18; 65536 is a frame over many tiles) and ``sosfilt_tv_frames_chunk`` in
   8 such chunks, ``tracking_notch`` on 16 x 2^22 swept tones in noise (B18;
   the reference's rules: frequency error, 15 dB suppression, noise
   correlation, and the CPU's result on a prefix), ``lpc_vocoder`` on 128
   streams x 512 frames x 256 at p = 12 (``refine``, B22 x 3) with
   ``method="pallas"`` (B22 x 2) and ``"scan"`` against the float64 golden
   on every stream, and ``lpc_synthesis`` auto on frame-constant sets at pole
   radius 0.95-0.999 (``factored``, B18) within 64x the sequential float32
   error; every launch count asserted; then, outside the counts, B22 (full and
   state-only) bit for bit against plain on the vocoder's 65536 frames, from rest and seeded, and
   high Q: B16 and the scan route (B17 a section) on the swept rows at pole
   radius up to 0.95 and B18 on the notch's rows, each kernel and plain
   against float64; then, counts reset
   again, the filter-design path on 16 x 2^22 float32: an elliptic lowpass
   of ``ellipord``'s order by ``iirdesign`` through ``sosfilt`` (B12) and
   ``sosfilt_pallas_fused(lane_pass="mxu")`` in both row passes (B14),
   ``iir_first_order_pallas(kernel="tile")`` at a = 0.995 (B11),
   ``cic_decimate`` at rate 8, 4 stages (B8) and its ``design_cic_compensator``
   FIR (B8), ``cic_interpolate`` on 16 x 2^19, a 201-tap ``design_remez``
   filter by ``fir_chunk`` in 8 chunks (one of one sample), ``resample_fft``,
   ``upfirdn`` and ``savgol_filter``, ``cspline1d`` and ``qspline1d`` on
   16 x 2^20 (B12 seeded); every route and launch count asserted, B11 and B14
   against their plain versions, B11 against B10, every output against
   float64;
5. times: each kernel against its plain version at the main path's shapes
   (CUDA events between back-to-back calls, median of 10 after 5 warm-ups,
   in turns plain, kernel, kernel, plain), with a device-to-device copy of
   the same bytes; B4 at C = 16 and C = 1 (median, min and max of 20) beside
   ``torch.cumsum`` of the same samples (the library call: the 1-D stream at
   C = 1, the outer-dimension scan of the (4M, 16) view at C = 16), its time
   before its redesign, its prediction, bound and registers, local bytes,
   shared bytes and blocks an SM (``pallas_scan.cumsum_kernel_attrs``), and at
   C = 3 (the generic kernel); then B1, B2 and B3
   against the two-pass route at halos on both sides of two blocks an SM
   (``TWO_BLOCKS_SMEM_MAX``) up to the largest ring that fits (B2 at its
   former bound, k = 10118 and 10119 at C = 2, 1070 and 1071 at C = 16, and
   B1's largest window; B3 also at C = 3, the generic kernel);
   each B3 variant at k=1024, C=2 (median, min and max of 20) beside its time
   before its redesign, its bound and its registers, local bytes,
   shared bytes and blocks an SM (``pallas_scan.scan_kernel_attrs``); B1 the
   same beside its time before its redesign and its prediction, in spans of
   one wave and of one tile (the two halo sources), and at C=3; B2 beside B1
   in the same call (in turns, median, min and max of 40 and 40) with its
   time before its redesign and its prediction;
   B8 (at 257 and 8193 taps, beside its times at its redesign) and B9 (beside
   its time before its redesign) at phase 4's
   shapes (median, min and max) against their plain versions, bounds, their
   designs' shared-memory and shuffle
   limits and one IEEE-fp32 ``conv1d`` (the library call), B8's registers,
   local bytes, shared bytes and blocks an SM at every plan and B9's at each
   launch, both kernels' time by launch, and the crossover table of ``conv1d`` against B8 by taps;
   B5 at k=64 and 256 (median, min and max of 20) beside its first port's
   time; B10, B12, B13 and B15 at the IIR main
   path's shape against their plain versions and bounds, the library call
   where ``torchaudio`` exists, B12 and B12 seeded against B13 and B15 in
   turns (median, min and max of 20) beside their times before B13's
   redesign and B13's prediction, B12 and B13 by launch, and the
   kernel-against-plain table by T that
   sets ``ops.iir.PALLAS_IIR_MIN_T``; B19 (64 channels in both layouts the
   main path writes, 1024 channels twice) and B20 at the wideband main path's
   shapes (median, min and max of 20) beside the first port's times, against their
   plain versions and bounds, with their launch geometry and
   ``torch.fft.fft`` of the same rows as a yardstick, B19 by taps a phase
   (1 to 16) at 64 and 1024 channels, and B21 against the ``matmul`` route
   at 441/2560, 160/147 and 3/2, the table that sets
   ``ops.farrow.MATMUL_MAX_PRODUCT_CUDA``; B16, B17, B18 and B22 (its full
   and state-only entries) at the
   time-varying main path's shapes (median, min and max of 20) against their
   plain versions, bounds and B12's time in the same call, B22 beside its
   time before its redesign and its predictions, ``refine``'s three B22
   passes, B22's attributes by order (``lpc.lpc_kernel_attrs``), the tile kernels'
   registers, local bytes, shared bytes, blocks an SM and columns a block,
   B16's, B17's and B18's time by launch, the
   transpose B22 skips, and frames (B18) against expand (B16) against
   per-sample scan (B17) at frame_len 1024; B11 and B14 at the design path's
   shape (median, min and max of 20) against their plain versions, B10 and
   B12, and the bound, with B14's own FP64 operation count (the blocks of
   T it multiplies), its registers, local bytes, shared bytes and blocks an
   SM by sections, its time by sections and both anchors' time by launch;
6. serving loops: wall time of three ``stream_moving_average`` runs over
   phase 4's WAVs and of decoding them alone, and the device time of one
   run under ``torch.profiler``, by kernel and copy; the same for
   ``stream_sosfilt``;
7. the flagship chain's wall time, and its device time under
   ``torch.profiler``, whole and by stage (LO bank, mix, channel FIR,
   decimate, FM demod, audio FIR), with the device's idle share; the same for
   the wideband receiver (channelize, FM demod, audio FIR, squelch); each
   profiled call after lead kernels that take the profiler's loss of a
   profile's first records (how many it lost is printed; a profile that lost
   them all is taken again with more), and a stage that launched one of the
   package's kernels but recorded none of their device time fails the run;
8. the sharded path (``parallel/``): four processes on the one card form a
   ring over gloo (``torch.multiprocessing`` spawn, a ``FileStore``), each
   holding a quarter of phase 4's 64M stream; with the counts reset around,
   ``ring_shift_right_shard`` (B6) and ``sharded_moving_average`` with
   ``halo_impl="pallas_ring"`` (B6 halos into B1) and ``"fused_ring"`` (B7);
   every rank holds B6 and B7 against their plain version (the ``ppermute``
   spelling over gloo), the parent holds the concatenated shards bit for bit
   against B1 over the whole stream, then the same over k in {1, 16, 1024} x
   C in {1, 2, 16}, a shard of exactly one halo, one shorter than a tile,
   and calls back to back with new data around another key; each rank's
   device time a call (the contexts time-slice the card: printed as it is)
   beside ``host_barrier`` alone and B6's and B7's times before their
   redesign, B7 by launch under ``torch.profiler``, and the host steps
   (barriers, object gathers, synchronisations) of calls back to back after
   a key's first, asserted 0 on every rank; the packed sharded path (B6's
   halo of pair words into B2 seeded) on the 64M stream and four corners (odd
   and even k*C) against B1; B6's put on every rank but the
   last, whose right neighbour (rank 0) receives zeros, asserted exactly;
   then world size 1 over NCCL in this process, counts reset around: the
   averager at 64M by every ``halo_impl``, ``scan`` by both ``carry_impl``s
   and the ring, the packed view (B2 seeded), ``sharded_cumsum`` (B4),
   ``sharded_fir_filter`` at 257 and 8193 taps on 16 x 2^22 (B8),
   ``sharded_chain_planar`` on the flagship, ``pipelined_fir_cascade``,
   ``sharded_sosfilt_tv`` (B16) and ``sharded_lpc_synthesis`` (B22) against
   the one-card entry points (B6 puts nothing in a world of one, asserted);
   B6, B7 (beside B1 and its time before), the put alone into a local
   buffer (beside ``copy_``) and B7's kernel attributes on the ring's shard.
9. the spectral and correlation slice, through its entry points at full size,
   counts reset around: ``stft``/``istft`` (nfft 1024, hop 512, sqrt-hann) on
   8 x 2^21 float32, ``welch``, ``csd`` and ``coherence`` on it, ``mfcc`` (nfft
   512, hop 256, 40 mels, 13 coefficients), ``czt`` by its chirp-matrix product
   (16 x 4096, m = 2048) and ``tone_power`` with TF32 turned on by the caller
   (their IEEE float32 pin), ``czt`` by Bluestein (16 x 2^20, m = 4096),
   ``hilbert`` by FFT and by FIR (B8) on 16 x 2^22 and by FFT on one 2^26
   stream, ``oaconvolve`` at 257 (B8) and 8194 taps (B9) on 16 x 2^22, the
   radar matched filter (``correlate_complex`` valid, 64 x 2^20 against a
   128-sample chirp) by ``auto`` (``direct``), ``direct_gauss`` and the FFT,
   and ``pitch_shift`` by 2^(3/12) on 2 x 2^22 tones (B21); every route
   asserted, B8, B9 and B21 launched, each output against float64 on a slice
   (1e-5 of max|want|, 1e-4 for the FIRs and the phase vocoder); then
   ``stream_mfcc`` and ``stream_time_stretch`` (rate 1.25, nfft 2048) over
   phase 4's two WAVs against one shot (the vocoder by its magnitude
   spectrogram against float64, within twice the one shot's), their wall ms
   and device ms and idle share; and each call's wall ms and device ms;
10. the model families at the reference's family-row shapes, with TF32
   turned on by the caller (the families' products and convolutions pin
   IEEE float32) and the counts reset around: radar ``detect`` on one CPI of
   64 x 2^20, pulse 128, its noise from PyTorch's generator on the card,
   seed 0 (every target detected at its cell); ``track_detections`` over 16
   CPIs of 64 x 16384 (the 3 tracks within 0.5 bin); the 16QAM modem's
   ``receive`` on 65536 payload symbols, sps 8, delay 37, cfo 2.4e-4, 22 dB
   with both trackers (BER under 1e-3; B8 twice a call); ``OfdmReceiver`` on
   8 bursts at nfft 1024, cp 64, 512 symbols, 768 active, 25 dB in one call
   (BER under 1e-3; B8 once); ``spectrum_batch`` MVDR at M=16 (64 x 16384)
   and MVDR and MUSIC at M=64 (16 x 16384) (DOA error within a grid step);
   no other kernel launched; then the port on the CPU: tracking and its
   detection cut to the first 4 CPIs (detections equal outside 1e-4 of the
   threshold, ids, flags and hits equal), the modem, OFDM and beamform at
   full size (bits and integer diagnostics equal; 1e-5 of max|want|, MUSIC
   2e-4); and each call's wall ms and device ms, the modem's DD loop alone.
11. the training path at full width, with TF32 turned on by the caller (the
   trainer's ``conv1d`` and the designer's products pin IEEE float32) and the
   counts reset around: ``identify_system`` of a 256-tap decaying random echo
   path on (64, 16384) batches, 200 steps (the path recovered within 1e-3 in
   norm; its first 20 steps against the port on the CPU within 1e-4 of
   max|h|); ``design_pr_prototype`` at n = 8 (the reference's 600 steps)
   and 64 (200 steps, a depth cut), P = 8, B20 launched once a step (asserted), step 0's gradient through B20 against
   autograd through the plain route on the card (1e-4 of max|g|), 50 steps
   against the CPU (1e-5 of max|h|), the reconstruction SNR and stopband (at
   n = 8 above 45 dB and below -25 dB); ``nlms`` (S1) at p = 256 on 64 x
   65536 and ``rls`` (S2) at p = 32 on 64 x 32768 (the warp route) and at
   p = 240 on 2 x 4096 (the block route, P's triangle in shared memory), one
   launch each (asserted), each against its plain loop on the card over the
   first 2048 samples (1e-5 of max|d|, of max|w| for the taps), with S1 on an
   AR(1) input (x_t = 0.95 x_{t-1} + white) at p = 256 on 64 x 2048 and S2 at
   p = 400 on 2 x 1024 (the triangle in device memory) outside the counted run,
   and over the whole run against the reference's anchors (NLMS within 0.05 of
   the true taps, RLS within 5e-3); the sharded step at world size 1 over NCCL
   bit for bit the single step; S1 and S2 beside their plain loops, the previous
   designs' times, their bounds, per-sample chain floors and routes' chains, B20
   in the designer; and each call's wall ms and device ms.
12. the rest of the op surface and the scipy.signal facade (``compat``), TF32
   turned on by the caller and the counts reset around, in at most 60 s: on 16 x
   2^22 float32 ``sosfilt``, ``lfilter``, ``sosfiltfilt``, ``filtfilt`` and
   ``decimate(q=4, ftype="iir")`` with butter(8, 0.1) (B12), ``oaconvolve`` and
   ``convolve(method="fft")`` at 257 taps (B8), ``hilbert`` (B8 by ``auto``'s FIR
   at 2^22), ``resample_poly(3, 2)`` and ``savgol_filter(31, 3)``, each against
   scipy's float64 on channel 0 (1e-4 of max|want|; the hilbert FIR against the
   FIR in float64); ``medfilt``, ``rank_filter`` and ``wiener`` (k = 5) against the
   port on the CPU over channel 0 (the rank filters equal, wiener 1e-5 of max|y|);
   ``cwt`` (ricker, widths 1..32, 4 x 2^20) and ``lombscargle`` (16384 uneven
   samples x 4096 frequencies) against float64 NumPy on a slice; ``find_peaks``
   with height, prominence and width on a 2^22 stream equal to scipy's, and
   ``find_peaks_cwt`` on 2^16 finding every pulse; ``convolve2d`` (same, symm,
   5 x 5) and ``medfilt2d`` (5 x 5) on 4096 x 4096 and ``spline_filter`` on 1024 x
   1024 against scipy on a crop; mu-law and A-law round trips of phase 4's 64M
   int16 stream, the card bit for bit the CPU over every int16 value and code,
   every code back through encode(decode(c)); ``tone_metrics`` of a tone
   through ``sosfilt``, a mild cubic distortion and int16 quantisation, against
   the CPU (1e-3 dB); ``lsim``
   of an 8-state system over 2^20 steps and ``dlsim`` at n = 8 (S3's warp
   route) and n = 300 (a cluster of CTAs) over 65536 steps, one S3 launch
   each, and outside the counted run at n = 1100 over 2048 steps (M read from
   device memory), against S3's plain loop on the card over 2048 steps (1e-5 of
   max|y|) and scipy's float64 ``dlsim`` over 4096 (1e-4); S3 by CUDA events
   beside its plain loop, the previous design's time, its bound and chain floor
   (and the sequential order's), each route's registers, local and shared bytes; F3: each
   float kernel wrapper (B8-B19 but B20, B21, B22,
   S1-S3) refuses a requires_grad input in grad mode on the card and runs under
   ``torch.no_grad()``; and each call's wall ms and device ms.
13. the rest of the surface, counts reset around its main path: the native
   library built from ``native/dsp_native.cpp`` (its path, the compiler's
   version); ``stream_moving_average(use_native=True)`` over phase 4's two WAVs
   (the native decode ring and encode thread, B1 on the card) and the Python
   branch, both byte-identical to one-shot B1; ``device_chunks`` over phase 4's
   loader, each chunk the loader's and on the card; B20's gradients with
   respect to its input and its taps at the designer's (512, 8) and n = 48's
   (2^20, 48) in the three layouts, within 1e-5 of max|g| of autograd through
   ``branch_fir`` + ``dft_matmul`` on the card, one B20 launch a call; the
   twelve examples (``digital_signal_processsing_tpu_torch/examples``) on the
   card, each exit 0 with no ``MISS``, with their wall seconds; then, outside
   the counted run, both loops' wall ms (median of 3, in turns) and the native
   loop's device ms and idle share under ``torch.profiler``, the
   ``device_chunks`` loop's wall, a ``trace`` of one B1 call naming B1's
   kernel, and ``moving_average_native`` (the reference's serial C++ averager,
   one host core) on the 64M stream at k=1024, bit-exact with B1, beside B1's
   time and the host CPU's model name.
14. the multi-card surface on the one card: four processes over gloo (phase 8's
   spawn and ``FileStore``), each part's counts reset around it:
   ``radar.detect_batch(mesh=)`` on phase 10's 16 tracking CPIs of 64 x 16384
   over a 4x1 and a 2x2 (channel x time) mesh, ``beamform.spectrum_batch(mesh=)``
   by MVDR and MUSIC on phase 10's 64 blocks of 16 x 16384, ``sharded_wideband``
   on phase 7's 2^26-sample 64-channel stream (2^24 samples a rank plus its halo,
   B19), the sharded averager at 64M k=1024 (B1), ``time_phases(sharding=)`` of
   it and ``device_chunks(sharding=)`` over phase 4's WAVs; the parent holds each
   gathered output against the one-card call (detections outside the 1e-4
   margin, power and threshold within 1e-5 of max; MVDR rtol 1e-4 / atol 1e-6,
   MUSIC 1e-3 / 1e-5; the wideband audio rtol 1e-4 / atol 1e-5 with the same
   squelch gates; the averager and the chunks bit for bit) and prints each rank's
   device and wall ms as time-sliced figures; then ``graft_entry.dryrun_multichip(4)``
   and ``dryrun_multiprocess(4)`` on the card. Phase 8's world of one runs the
   same entry points bit for bit against their one-card calls.

15. parity with the JAX package, the counts reset around its main path:
   ``time_phases(chain=16)`` of ``moving_average`` on the 64M stream at k=1024,
   resident (B1; the reference's K-differential of chains of 16 and 4 calls, each on
   the last one's output, a cross-check), the same chains with each call on the
   stream itself, and ``chain=1``, beside phase 5's event median, each finite and
   positive and B1's launches exactly the chains'; the reference's planar
   DFT functions at its own shapes (``rfft_dense_framed`` on 8 x 2^21 at nfft 512 and
   4096, hop nfft / 4, hann; ``dft_factored`` on 8 rows of 32768; ``fft_large`` on
   one row of 2^22 and its inverse), each within 1e-4 of max|X| of float64 NumPy on
   a slice, with its device ms; ``causal_conv`` (strides 1 and 4) and
   ``interp_conv`` (up 2) on 16 x 2^22 at 257 taps against ``fir_filter``'s B8
   route, within 1e-4 of max|y|, and their times beside B8's; F6 (``convolve2d`` and
   ``correlate2d`` valid with a kernel larger than the image), F7 (``chirp`` of 0
   samples) and F8 (``levinson`` of a NumPy array) on the card; then ``python -m
   digital_signal_processsing_tpu_torch.harness.sweep --smoke --chain 4`` in a
   process of its own, exit 0 and 35 rows of 14 columns.

Each phase prints its seconds. The last two lines are the kernels' JSON
record (B1-B22, S1, S2 and S3, each with
its launches on the main paths, phases 13's to 15's added, max abs error, device ms, plain ms,
bound ms and library ms) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib
import io
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import scipy.signal as sps
import torch

from digital_signal_processsing_tpu_torch import _build
from digital_signal_processsing_tpu_torch.__main__ import main as cli_main
from digital_signal_processsing_tpu_torch.golden import moving_average_golden
from digital_signal_processsing_tpu_torch.harness import CSV_COLUMNS, sweep
from digital_signal_processsing_tpu_torch.io import WavChunkLoader, read_wav, write_wav
from digital_signal_processsing_tpu_torch.models import adaptive
from digital_signal_processsing_tpu_torch.models import (
    ChainConfig,
    DspChain,
    WidebandConfig,
    WidebandFmReceiver,
    beamform,
    chain_stream_chunk,
    chain_stream_init,
    modem,
    notch_rows,
    ofdm,
    radar,
    tracking,
    tracking_notch,
)
from digital_signal_processsing_tpu_torch.ops import (
    launch_counts,
    moving_average,
    pfb_analyze_os,
    pfb_channelize,
    pfb_channelize_chunk,
    pfb_stream_init,
    pfb_synthesize_os,
    reset_launch_counts,
)
from digital_signal_processsing_tpu_torch.ops import channelizer as chz
from digital_signal_processsing_tpu_torch.ops import farrow as fw
from digital_signal_processsing_tpu_torch.ops import fft_mxu as fm
from digital_signal_processsing_tpu_torch.ops import cic, fir, gain, iir, iir_design, lpc
from digital_signal_processsing_tpu_torch.ops import correlate as cor
from digital_signal_processsing_tpu_torch.ops import fft as spec
from digital_signal_processsing_tpu_torch.ops import mel
from digital_signal_processsing_tpu_torch.ops import pfb_os
from digital_signal_processsing_tpu_torch.ops import phase_vocoder as pv
from digital_signal_processsing_tpu_torch.ops import resample, splines, streaming
from digital_signal_processsing_tpu_torch.ops import pallas_direct as pd
from digital_signal_processsing_tpu_torch.ops import pallas_scan as ps
from digital_signal_processsing_tpu_torch.ops.demod import fm_demodulate, oscillator_bank
from digital_signal_processsing_tpu_torch.ops.direct_xla import moving_average_reduce_window
from digital_signal_processsing_tpu_torch.ops.resample import decimate
from digital_signal_processsing_tpu_torch.ops.scan_xla import cumsum_ref, moving_average_xla
from digital_signal_processsing_tpu_torch.serve import (
    stream_mfcc,
    stream_moving_average,
    stream_sosfilt,
    stream_time_stretch,
)
from digital_signal_processsing_tpu_torch.utils import last_choice
from digital_signal_processsing_tpu_torch import examples as port_examples
from digital_signal_processsing_tpu_torch import graft_entry
from digital_signal_processsing_tpu_torch.harness import trace
from digital_signal_processsing_tpu_torch.io import device_chunks, native

MAIN_SAMPLES = 64 * 2**20  # bench.py's headline stream: 64M stereo int16 samples
MAIN_WINDOW = 1024
TWO_PASS_WINDOW, TWO_PASS_CHANNELS = 65535, 16
DIRECT_WINDOWS = (64, 256)
SCAN_METHODS = {"scan": "blelloch", "scan_hillis": "hillis_steele", "scan_mxu": "mxu"}
VARIANTS = tuple(SCAN_METHODS.values())
AVERAGER_KERNELS = ("B1", "B2", *(f"B3/{v}" for v in VARIANTS), "B4", "B5")
IIR_KERNELS = ("B10", "B12", "B13", "B15")
PFB_KERNELS = ("B19", "B20", "B21")
TV_KERNELS = ("B16", "B17", "B18", "B22")
ANCHOR_KERNELS = ("B11", "B14")
RING_KERNELS = ("B6", "B7")
ADAPTIVE_KERNELS = ("S1", "S2")
SURFACE_KERNELS = ("S3",)
KERNELS = (*AVERAGER_KERNELS, "B8", "B9", *IIR_KERNELS, *PFB_KERNELS, *TV_KERNELS,
           *ANCHOR_KERNELS, *RING_KERNELS, *ADAPTIVE_KERNELS, *SURFACE_KERNELS)
SOURCE = "digital_signal_processsing_tpu_torch/csrc/"
REPLACES = "digital_signal_processsing_tpu/ops/pallas_scan.py:"
REPLACES_DIRECT = "digital_signal_processsing_tpu/ops/pallas_direct.py:"
REPLACES_FFT = "digital_signal_processsing_tpu/ops/fft_mxu.py:"
REPLACES_IIR = "digital_signal_processsing_tpu/ops/iir.py:"
REPLACES_PFB = "digital_signal_processsing_tpu/ops/channelizer.py:"
REPLACES_FARROW = "digital_signal_processsing_tpu/ops/farrow.py:"
REPLACES_LPC = "digital_signal_processsing_tpu/ops/lpc.py:"
REPLACES_RING = "digital_signal_processsing_tpu/parallel/ring_pallas.py:"
# The receiver chain's main path: the flagship of __graft_entry__.py (16
# channels, decimation 8) on 2^22 samples a channel, the 16ch x 4.2M point of
# the reference's benchmark notes.
CHAIN_T = 1 << 22
LAST_B8 = fm.FUSED_MAX_NFFT // 2 + 1  # the longest taps B8 takes under fir_filter
LAST_B9 = fm.FUSED3_MAX_NFFT // 2 + 1
CROSSOVER_TAPS = (1, 3, 5, 7, 9, 13, 17, 25, 33, 65, 129, 257, 513, 1025, 2049, 4097, 8193)
# Taps that put B8 on its other plans (nfft 1024, 2048, 8192). With one
# sample a channel the output is h[0] x[0], far below the FFT's rounding of
# the whole spectrum, and torch.fft itself lies up to about 2e-5 of max|y|
# from float64 there (k=600): at these taps B8 is held to plain within
# FIR_RTOL plus plain's own error against float64 (the rule B14 follows at
# high Q), and to float64 within FIR64_RTOL as everywhere.
PLAN_TAPS = (100, 200, 600)
# Against the plain version on the same segments: the JAX package's bound
# between its fused and composed overlap-save (tests/test_fft_mxu.py:97);
# against a float64 direct FIR, its bound against direct (:42). Relative to
# max|y|.
FIR_RTOL, FIR64_RTOL = 1e-5, 1e-4
# The IIR main path: the JAX package's benchmark point (BENCH_NOTES.md:149,
# :223-224), 16 channels x 2^22 float32 through butter(8, 0.1), 4 sections.
# Each kernel within 1e-5 of max|y| of its plain version and 1e-4 of scipy's
# float64 filter with the same float32 coefficients.
IIR_T = 1 << 22
IIR_SOS = iir.design_butterworth(8, 0.1)
IIR_RTOL, IIR64_RTOL = 1e-5, 1e-4
IIR_POLES = (0.5, -0.3, 0.99, 0.9999)  # first-order a at the corners
# T of the crossover table that sets iir.PALLAS_IIR_MIN_T
IIR_CROSSOVER_T = (1, 64, 512, 4096, 16384, 65536, 262144, 1 << 20, 1 << 22)
# The wideband receiver's main path: the JAX package's channelizer benchmark
# point (64 channels, 64M samples, channelizer.py:410-414), FM tones on four
# channels. Tolerances relative to max|y|: the JAX package's bounds for its
# fused PFB (tests/test_channelizer.py:176-177) and its segment Farrow
# kernel (tests/test_farrow.py:208-209).
WIDE_T = 1 << 26
WIDE_TONES = (5, 12, 20, 37)
PFB_RTOL, FARROW_RTOL = 1e-5, 2e-5
# B21's corners: two primes past the phase-matrix envelope and their
# neighbours (tests/test_farrow.py:235), small and audio ratios, pi/3 snapped
FARROW_RATES = ((46337, 65521), (46349, 65521), (46351, 65537), (3, 7), (48000, 44100), np.pi / 3)
FARROW_MAIN_RATE = (46337, 65521)
CHAIN_RATE = (441, 2560)  # 44.1 kHz from the chain's 256 kHz audio (tests/test_models.py:188)
FARROW_AB_RATES = (CHAIN_RATE, (160, 147), (3, 2))  # B21 against the matmul route at these
PFB_SWEEP_TAPS = (1, 2, 4, 8, 16)  # B19's time by taps a phase, on the 2^26 stream
# B19/B20 as first ported and B8 as first redesigned, printed beside this call's times
# (PERF.md §6; NVIDIA H100 80GB HBM3, 700.00 W)
PFB_FIRST_MS = {"B19 n=64": 1.3260, "B19 n=1024": 1.5717, "B20 os": 2.3220, "B20 n=48": 1.7805}
B8_REDESIGN_MS = {"B8 257": 0.2616, "B8": 0.7144}
# B9 and B3 before their redesign (PERF.md §6's table; NVIDIA H100 80GB HBM3, 700.00 W)
B9_B3_EARLIER_MS = {"B9": 2.4631, "B3/blelloch": 0.6508, "B3/hillis_steele": 0.8660,
                    "B3/mxu": 0.7732}
# B12, B13 and B15 before B13's redesign, and B5 as first ported, printed beside
# this call's times (PERF.md §6's table; NVIDIA H100 80GB HBM3, 700.00 W)
IIR_EARLIER_MS = {"B12": 0.4165, "B12 seeded": 0.4169, "B13": 0.7091, "B15": 1.2322}
DIRECT_FIRST_MS = {64: 0.6232, 256: 2.1516}
# B1 and B7 before B1's redesign (PERF.md §6), and the predictions written in PERF.md
# before the redesigns' first chip call
B1_EARLIER_MS = {"B1": 0.3418, "B7": 0.1363}
# B2 before it became B1's launch on the pair words' int16 view (PERF.md §6), and the
# prediction written in PERF.md: its ms, and B2 / B1 in the same call at most 1.05
B2_EARLIER_MS = 0.2253
B2_PREDICTED = (0.11, 0.13, 1.05)
# B4 (C = 16) and B22 (a pass at the vocoder's shape) before their redesign (PERF.md §6)
B4_B22_EARLIER_MS = {"B4": 0.6456, "B22": 0.1087}
PREDICTED_MS = {"B1": (0.09, 0.14), "B13": (0.30, 0.42), "B4": (0.14, 0.20), "B22": (0.05, 0.08),
                "B22 state": (0.03, 0.05), "B22 refine": (0.12, 0.18)}
# B20's plans: every power of two 2..8192, 3 * 2^a up to 6144 (the radix-3 route), and
# the direct DFT's 1 and 7
PFB_PLAN_NS = (*(1 << e for e in range(1, 14)), *(3 << e for e in range(12)), 1, 7)
# The time-varying IIR family's main path: the JAX package's benchmark point
# for sosfilt_tv (BENCH_NOTES.md:452, :499), 4 sections of swept per-sample
# rows shared by 16 channels of 2^22 float32 samples, and its frames kernel at
# frame_len 1024 and 65536 (a frame over many tiles, which Mosaic could not
# lower: ROADMAP's H1). Within 1e-5 of max|y| of plain and float64, the JAX
# package's bound for these kernels (tests/test_iir_tv.py).
TV_C, TV_T, TV_S = 16, 1 << 22, 4
TV_FRAMES = (1024, 65536)
TV_RTOL = 1e-5
# LPC's benchmark point (BENCH_NOTES.md:500): p = 12 on 128 streams x 512
# frames x 256 samples; every method within 5e-3 of the float64 golden (the
# JAX package's bound, tests/test_lpc.py). The resonant sets of its factored
# contract (tests/test_lpc.py:227-277): frames of 128 samples, radii below.
LPC_STREAMS, LPC_FRAMES, LPC_L, LPC_P = 128, 512, 256, 12
LPC_RTOL = 5e-3
LPC_RADII = (0.95, 0.98, 0.995, 0.999)
RES_L = 128
# The tracking notch against itself on the CPU: the same float32 rfft peak
# refined apart (frequencies within 1e-5 Nyquist units), the output within 1e-4
# of max|y| (tests/test_torch_adaptive.py)
NOTCH_W_TOL, NOTCH_RTOL = 1e-5, 1e-4
# High Q (the swept schedule at pole radius up to 0.95, the notch's rows at
# q = 30): a kernel's error against float64 may be at most this many times the
# plain version's own error there
HIGHQ_FACTOR = 2.0
# The filter-design path's main path on 16 x 2^22 float32: an elliptic lowpass
# of ellipord's order (0.2 passband edge, 0.25 stopband edge, 0.1 dB ripple,
# 80 dB: order 9, 5 sections, poles at radius up to 0.983), B11 at a = 0.995,
# a CIC of rate 8 and 4 stages with a 63-tap compensator, a 201-tap Remez
# lowpass streamed in 8 chunks, and the splines on 16 x 2^20. B11 and B14
# within 1e-5 of max|y| of plain and 1e-4 of float64 (the IIR kernels' bounds);
# the FIR routes within 1e-4 of float64 (FIR64_RTOL), the splines too.
DESIGN_SPEC = (0.2, 0.25, 0.1, 80.0)
ANCHOR_POLE = 0.995
CIC_RATE, CIC_STAGES, CIC_COMP_TAPS = 8, 4, 63
CIC_INTERP_T = 1 << 19
SPLINE_T = 1 << 20
PREFIX = 1 << 16  # samples of channel 0 held against a float64 FIR on the host
# B14's own operations: a segment of MXU_SEG samples times the blocks of its
# section's T that are not zero (MXU_MACS multiply-adds), in each of its two
# tile launches; FP64 tensor-core peak of the H100 SXM (NVIDIA's data sheet:
# 67 TFLOP/s).
FP64_TC_FLOPS_PER_S = 67e12
# The H100 SXM's memory rate, and its peak rate of int32 adds outside the
# tensor cores: a clock of an SM issues 64 lanes of IADD3, two adds each
# (three operands), and 64 lanes of IMAD on the FMA pipe, one add each
# (a * 1 + c); 132 SMs at 1.98 GHz (NVIDIA's data sheet, the Hopper
# architecture white paper, and the CUDA programming guide's throughput
# table for compute capability 9.0). Other int32 operations are counted at
# this rate too, so the bound stays a least time.
HBM_BYTES_PER_S = 3.35e12
INT32_ADDS_PER_S = 132 * (64 * 2 + 64) * 1.98e9
# float32 operations outside the tensor cores: 132 SMs x 128 lanes x 2 (FMA)
# x 1.98 GHz (NVIDIA's data sheet: 67 TFLOP/s fp32 outside the tensor cores).
FP32_FLOPS_PER_S = 132 * 128 * 2 * 1.98e9


class Checker:
    """Bit-exact comparisons on the card, keeping the largest error per kernel."""

    def __init__(self) -> None:
        self.max_err = dict.fromkeys(KERNELS, 0)
        self.count = dict.fromkeys(KERNELS, 0)

    def close(self, kernel: str, got: torch.Tensor, want: torch.Tensor, what: str,
              rtol: float = FIR_RTOL, scale_of: torch.Tensor | None = None) -> None:
        """Float comparison: max|got - want| <= rtol * max|want| (exact zeros stay zero).

        ``scale_of``: take the scale from this tensor instead (a filter's end
        state against the size of its output).
        """
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(
                f"{what}: got {got.dtype}{tuple(got.shape)}, want {want.dtype}{tuple(want.shape)}"
            )
        err = scale = 0.0
        if got.numel():
            err = (got.double() - want.double()).abs().max().item()
            scale = (want if scale_of is None else scale_of).abs().max().item()
        self.max_err[kernel] = max(self.max_err[kernel], err)
        self.count[kernel] += 1
        if not err <= rtol * scale:  # also fails on NaN
            raise AssertionError(f"{what}: max abs error {err:.3e} > {rtol} x max|want| {scale:.3e}")

    def same(self, kernel: str, got: torch.Tensor, want: torch.Tensor, what: str) -> None:
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(
                f"{what}: got {got.dtype}{tuple(got.shape)}, want {want.dtype}{tuple(want.shape)}"
            )
        err = 0
        if got.numel():
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
        self.max_err[kernel] = max(self.max_err[kernel], err)
        self.count[kernel] += 1
        if err != 0:
            raise AssertionError(f"{what}: max abs error {err}, want 0 (bit-exact)")


def device_ms(fn, warmup: int, reps: int, lead: float = 0.0) -> list[float]:
    """Device ms of each of ``reps`` calls queued back to back after ``warmup``.

    An event after each call, so an interval is the card's time for one call
    and not the host's time to issue it. ``lead``: a sleep kernel of about
    ``lead`` ms a call first, during which the host queues the calls, so that
    a call shorter than the host's time to issue it is timed without the gaps
    between them.
    """
    for _ in range(warmup):
        fn()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    if lead:
        torch.cuda._sleep(int(2e6 * lead * reps))  # cycles, at about 2 GHz
    events[0].record()
    for ev in events[1:]:
        fn()
        ev.record()
    events[-1].synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def time_pair(kernel_fn, plain_fn, warmup: int = 5, reps: int = 10) -> tuple[float, float]:
    """Median device ms of each, timed in turns plain, kernel, kernel, plain."""
    plain = device_ms(plain_fn, warmup, reps)
    kernel = device_ms(kernel_fn, warmup, reps) + device_ms(kernel_fn, warmup, reps)
    plain += device_ms(plain_fn, warmup, reps)
    return statistics.median(kernel), statistics.median(plain)


def bound(bytes_moved: float, ops: float, ops_per_s: float = INT32_ADDS_PER_S) -> tuple[float, str]:
    """Least ms the card could take: the larger of bytes and operations over their peaks."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def device_rows(prof) -> list[tuple[str, int, float]]:
    """(name, count, device ms) of each kernel and copy a ``torch.profiler`` run saw,
    longest first; device-side events only, as the host ops that launch them
    repeat their time."""
    rows = [
        (e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation
    ]
    return sorted(rows, key=lambda r: -r[2])


PROFILE_ACTIVITIES = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
# the package's kernels in a profile: templates demangle with their return type, plain
# functions (S2's rls_kernel) without
OURS = ("void dsp::", "dsp::")


# Lead kernels each profiled call launches inside the profiler's window before it
# starts: late in a long process a torch.profiler profile loses the first device records
# it collects, whatever the time between its start and the first kernel (on the H100
# runs PERF.md records, 2 or 3 records in most profiles, 16 or more in one; a fresh
# process none). An earlier wideband profile so lost its whole channelize stage (a copy
# and B19), the chain's mix and one of the channel FIR's two B8 launches, and one that
# lost 15 of 16 leads lost the chain's channel FIR stage after them too. The lead
# kernels take the loss and are left out of the rows; a profile that lost more than half
# of them is taken again with more, after a pause.
PROFILE_LEADS = ((16, 0.0), (64, 0.05), (256, 0.2), (1024, 1.0))  # (kernels, seconds before)
LEAD_KERNEL = "spin_kernel"  # torch.cuda._sleep's


def profiled(fn) -> tuple[float, float, list]:
    """(wall ms, device ms, device rows) of one call of ``fn`` under torch.profiler,
    after lead kernels that take the profile's lost records (left out of the rows)."""
    for kernels, pause in PROFILE_LEADS:
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=PROFILE_ACTIVITIES) as prof:
            time.sleep(pause)
            for _ in range(kernels):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = device_rows(prof)
        lost = kernels - sum(r[1] for r in rows if LEAD_KERNEL in r[0])
        if lost <= kernels // 2:
            profiled.last = f"{lost} of {kernels}"
            profiled.lost = max(profiled.lost, lost)
            rows = [r for r in rows if LEAD_KERNEL not in r[0]]
            return wall, sum(r[2] for r in rows), rows
    raise AssertionError(f"the profiler lost {lost} of {kernels} lead kernels: the call's own "
                         "records may be lost")


profiled.lost = 0  # the most lead records a profiled call lost


def profile_stages(stages: dict, what: str) -> None:
    """Each stage's device time under torch.profiler, the package's kernels it launched
    counted around the profiled calls; fails where a stage launched one of them and the
    profiler recorded none of the package's kernels' time."""
    for name, fn in stages.items():
        fn()
        before = launch_counts()
        _, dev_ms, stage_rows = profiled(fn)  # one call
        launched = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
        top = max(stage_rows, key=lambda r: r[2]) if stage_rows else ("none", 0, 0.0)
        ours = sum(r[2] for r in stage_rows if r[0].startswith(OURS))
        print(
            f"  {name:12s} device {dev_ms:8.3f} ms in {sum(r[1] for r in stage_rows):3d} "
            f"kernels ({ours:.3f} ms in the package's, launched {launched or 'none'}; lead "
            f"records lost {profiled.last}); largest {top[2]:.3f} ms {top[0][:60]}"
        )
        if launched and not ours > 0:
            raise AssertionError(f"{what} {name}: launched {launched} but the profiler recorded "
                                 "no device time of the package's kernels")


def largest_window(fits) -> int:
    """Largest window in [1, 65535] for which ``fits(window)`` holds, by bisection."""
    lo, hi = 0, 65535
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return lo


def phase_corners(rng, dev, check: Checker) -> None:
    def stream(frames: int, channels: int) -> torch.Tensor:
        n = frames * channels
        return torch.from_numpy(rng.integers(-32768, 32768, size=n, dtype=np.int16)).to(dev)

    def averagers(x: torch.Tensor, k: int, c: int, label: str) -> None:
        want = moving_average_xla(x, k, c)
        if ps.windowed_supported(k, c):
            check.same("B1", ps.windowed_averager(x, k, c), want, f"B1 {label}")
        else:
            check.same("B4", ps.moving_average_two_pass(x, k, c), want, f"two-pass {label}")
        xp = x if x.numel() % 2 == 0 else x[: x.numel() - c]  # whole frames, whole words
        if xp.numel() and ps.packed_supported(k, c):
            got = ps.windowed_averager_packed(xp.view(torch.int32), k, c).view(torch.int16)
            check.same("B2", got, moving_average_xla(xp, k, c), f"B2 {label}")
        for v in VARIANTS:
            if (v != "mxu" or ps.TC_ROW % c == 0) and ps.scan_supported(k, c, v):
                got = ps.scan_averager(x, k, c, variant=v)
                check.same(f"B3/{v}", got, want, f"B3 {v} {label}")

    def direct(x: torch.Tensor, k: int, c: int, label: str) -> None:
        got = pd.direct_averager(x, k, c)
        check.same("B5", got, moving_average_reduce_window(x, k, c), f"B5 {label}")

    for c in (1, 2, 3, 16):
        for frames in (1, 127, 129, 2**20 + c):
            x = stream(frames, c)
            check.same("B4", ps.cumsum(x, c), cumsum_ref(x, c), f"cumsum C={c} frames={frames}")
            for k in (1, 16, 1024, 65535):
                averagers(x, k, c, f"k={k} C={c} frames={frames}")
            for k in (1, 16, 64, 256):
                direct(x, k, c, f"k={k} C={c} frames={frames}")
    for k, c in ((65535, 1), (1024, 16), (16, 3), (1, 2)):
        x = torch.full(((2**17 + 1) * c,), -32768, dtype=torch.int16, device=dev)
        averagers(x, k, c, f"INT16_MIN k={k} C={c}")
        direct(x, min(k, pd.MAX_DIRECT_WINDOW), c, f"INT16_MIN k={min(k, 256)} C={c}")
        check.same("B4", ps.cumsum(x, c), cumsum_ref(x, c), f"cumsum INT16_MIN C={c}")
    for k, c, frames in ((1024, 2, 129), (1024, 2, 2**20 + 2), (1024, 16, 4099), (7, 3, 1)):
        x, seed = stream(frames, c), stream(k, c)
        want = moving_average_xla(torch.cat([seed, x]), k, c)[k * c :]
        check.same("B1", ps.windowed_averager(x, k, c, seed=seed), want, f"B1 seeded k={k} C={c}")
    x = torch.full((2**21,), 32767, dtype=torch.int16, device=dev)  # sum reaches 2^36: wraps
    got = ps.cumsum(x, 1)
    check.same("B4", got, cumsum_ref(x, 1), "cumsum int32 wrap")
    wrapped = (np.arange(1, 2**21 + 1, dtype=np.int64) * 32767).astype(np.int32)  # mod 2^32
    if not np.array_equal(got.cpu().numpy(), wrapped):
        raise AssertionError("cumsum int32 wrap disagrees with NumPy's modular sum")
    try:
        ps.scan_averager(stream(100, 3), 4, 3, variant="mxu")
    except ValueError:
        pass
    else:
        raise AssertionError("the tensor-core B3 took C=3, which does not divide its rows")
    # spans of several tiles (5 at 20M samples on 132 SMs), so windows cross
    # span boundaries; then each variant at the largest halo it takes, C=2 and 16
    x = stream(10_000_003, 2)
    want = moving_average_xla(x, 255, 2)
    for v in VARIANTS:
        got = ps.scan_averager(x, 255, 2, variant=v)
        check.same(f"B3/{v}", got, want, f"B3 {v} span boundaries k=255 C=2 20M samples")
    largest = {}
    for v in VARIANTS:
        for c in (2, 3, 16) if v != "mxu" else (2, 16):  # C=3: the generic kernel
            k = largest[v, c] = largest_window(lambda w, c=c, v=v: ps.scan_supported(w, c, v))
            x = stream(2**18 + 1, c)
            got = ps.scan_averager(x, k, c, variant=v)
            check.same(f"B3/{v}", got, moving_average_xla(x, k, c), f"B3 {v} largest k={k} C={c}")
    # int16 max (every window sum at its most positive) at k = 1 and each variant's largest
    for v in VARIANTS:
        for c in (2, 3, 16) if v != "mxu" else (2, 16):
            x = torch.full(((2**17 + 3) * c,), 32767, dtype=torch.int16, device=dev)
            for k in (1, largest[v, c]):
                got = ps.scan_averager(x, k, c, variant=v)
                check.same(f"B3/{v}", got, moving_average_xla(x, k, c), f"B3 {v} INT16_MAX k={k} C={c}")
    x = stream(2**20 + 2, 2)
    got = ps.windowed_averager(x, 1024, 2)[: 1 << 18].cpu().numpy()
    want = moving_average_golden(x[: 1 << 18].cpu().numpy(), 1024, 2)
    if not np.array_equal(got, want):
        raise AssertionError("B1 disagrees with the NumPy golden model")
    b1_largest = b1_corners(stream, dev, check)
    b2_largest = b2_corners(stream, dev, check)
    b4_largest = b4_corners(stream, dev, check)
    print(
        "[3 corners] bit-exact: "
        + ", ".join(f"{k} {check.count[k]} checks" for k in AVERAGER_KERNELS)
        + "; B1 against golden on 262144 samples; tensor-core B3 refused C=3; B3's largest "
        + "windows: " + ", ".join(f"{v} C={c} k={k}" for (v, c), k in largest.items())
        + "; B1's: " + ", ".join(f"C={c} k={k}" for c, k in b1_largest.items())
        + "; B2's (one B2 launch and no B1 launch a call): "
        + ", ".join(f"C={c} k={k}" for c, k in b2_largest.items())
        + f"; B4's largest C {b4_largest}"
    )


def b1_corners(stream, dev, check: Checker) -> dict:
    """B1's redesign at its corners, bit-exact against plain: views 2 to 14 bytes off
    the 16-byte grid (a streaming tail's), the range entry split at every tile
    boundary of a 9-tile stream into two launches, seeded and not, spans of one
    tile, C = 3, 5 and 16, k = 1, a halo longer than a tile, the largest halo it
    takes at each C, and int16 min and max there. Returns the largest windows."""
    for c, k, frames in ((2, 1024, 2**18 + 5), (3, 100, 30001), (1, 1, 65537)):
        base = stream(frames + 8, c)
        for off in (1, 3, 7):  # a view `off` samples past an aligned start
            x = base[off * c : off * c + frames * c]
            check.same("B1", ps.windowed_averager(x, k, c), moving_average_xla(x, k, c),
                       f"B1 view {2 * off * c} bytes off k={k} C={c}")
        seed, x = stream(k, c), base[c : c + frames * c]
        want = moving_average_xla(torch.cat([seed, x]), k, c)[k * c :]
        check.same("B1", ps.windowed_averager(x, k, c, seed=seed), want,
                   f"B1 seeded, a view {2 * c} bytes off, k={k} C={c}")
    for c, k in ((2, 1024), (3, 4000), (16, 700)):
        x = stream(9 * 8192 // c - 5, c)  # 9 tiles, the last ragged
        tiles = ps.windowed_geometry(k, c).tiles(x.numel())
        for seed in (None, stream(k, c)):
            full = ps.windowed_averager(x, k, c, seed=seed)
            ext = x if seed is None else torch.cat([seed, x])
            check.same("B1", full, moving_average_xla(ext, k, c)[ext.numel() - x.numel() :],
                       f"B1 k={k} C={c} seeded={seed is not None}")
            for b in range(1, tiles):
                y = torch.empty_like(x)
                for lo, hi in ((b, tiles), (0, b)):
                    err = ps.launch_windowed_range(
                        x, y, k, c, None if seed is None else seed.data_ptr(), lo, hi,
                        torch.cuda.current_stream().cuda_stream)
                    _build.check(err, "B1 range")
                check.same("B1", y, full, f"B1 range split at tile {b} k={k} C={c} "
                           f"seeded={seed is not None}")
            check.same("B1", ps.launch_windowed(x, k, c, seed, span_tiles=1), full,
                       f"B1 spans of one tile k={k} C={c}")
    largest = {}
    for c in (1, 2, 3, 5, 16):
        largest[c] = largest_window(lambda w, c=c: ps.windowed_supported(w, c))
        for k in (1, 8192 // c + 3, largest[c]):  # k = 1, a halo past a tile, the largest
            x = stream(2 * k + 50_001, c)
            check.same("B1", ps.windowed_averager(x, k, c), moving_average_xla(x, k, c),
                       f"B1 k={k} C={c}")
        for v in (-32768, 32767):
            x = torch.full(((3 * largest[c] + 7) * c,), v, dtype=torch.int16, device=dev)
            check.same("B1", ps.windowed_averager(x, largest[c], c),
                       moving_average_xla(x, largest[c], c), f"B1 {v} k={largest[c]} C={c}")
    return largest


def b2_corners(stream, dev, check: Checker) -> dict:
    """B2 (B1's launch on the pair words' int16 view) at B1's corners, bit-exact against
    plain, every call one B2 launch and no B1 launch: C = 1, 2, 3 and 16 at k = 1, a halo
    past a tile, the largest window of its bound and one below it (odd k*C at odd C),
    unseeded and seeded (a seed of k + 1 frames where k*C is odd, its first frame
    skipped), int16 min and max at the largest; views 4, 8 and 12 bytes off the 16-byte
    grid, seeded too. Returns the largest windows."""
    def packed(x32, k, c, seed=None):
        before = launch_counts()
        got = ps.windowed_averager_packed(x32, k, c, seed=seed)
        after = launch_counts()
        if after["B2"] != before["B2"] + 1 or after["B1"] != before["B1"]:
            raise AssertionError(f"B2 k={k} C={c}: launches B2 {after['B2'] - before['B2']}, "
                                 f"B1 {after['B1'] - before['B1']}; want 1 and 0")
        return got.view(torch.int16)

    def seeded(x, k, c, label):
        words = ps.packed_seed_words(k, c)
        sx = stream(2 * words // c, c)
        want = moving_average_xla(torch.cat([sx, x]), k, c)[2 * words :]
        check.same("B2", packed(x.view(torch.int32), k, c, sx.view(torch.int32)), want,
                   f"B2 seeded ({words} words, k*C {'odd' if k * c % 2 else 'even'}) {label}")

    largest = {}
    for c in (1, 2, 3, 16):
        largest[c] = largest_window(lambda w, c=c: ps.packed_supported(w, c))
        for k in (1, 8192 // c + 3, largest[c] - 1, largest[c]):
            x = stream(2 * (k + 25_001), c)  # whole frames, whole words
            check.same("B2", packed(x.view(torch.int32), k, c), moving_average_xla(x, k, c),
                       f"B2 k={k} C={c}")
            seeded(x, k, c, f"k={k} C={c}")
        for v in (-32768, 32767):
            x = torch.full((2 * (largest[c] + 7) * c,), v, dtype=torch.int16, device=dev)
            check.same("B2", packed(x.view(torch.int32), largest[c], c),
                       moving_average_xla(x, largest[c], c), f"B2 {v} k={largest[c]} C={c}")
    for c, k, frames in ((2, 1024, 2**18 + 6), (3, 101, 30002), (1, 15, 65538), (16, 7, 4100)):
        base = stream(frames + 8, c).view(torch.int32)
        for off in (1, 2, 3):  # a view `off` words past an aligned start
            x32 = base[off : off + frames * c // 2]
            x = x32.view(torch.int16)
            check.same("B2", packed(x32, k, c), moving_average_xla(x, k, c),
                       f"B2 view {4 * off} bytes off k={k} C={c}")
            seeded(x, k, c, f"a view {4 * off} bytes off k={k} C={c}")
    return largest


def b4_corners(stream, dev, check: Checker) -> int:
    """B4's redesign at its corners, bit-exact against plain: C = 1, 3, 16, a large C
    and the largest it takes (the generic kernel's tile of one frame); views 2 to 14
    bytes off the 16-byte grid; streams of many more tiles than resident blocks,
    called three times bit-identical; int32 wraparound at C = 16. Returns the
    largest C."""
    largest = 4096
    while ps.cumsum_supported(largest * 2):
        largest *= 2
    lo, hi = largest, largest * 2  # cumsum_supported(lo), not hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if ps.cumsum_supported(mid) else (lo, mid)
    largest = lo
    for c, frames in ((1, 2**24 + 5), (3, 2**22 + 1), (16, 2**20 + 3), (4099, 1001),
                      (largest, 41)):
        base = stream(frames + 8, c)
        for off in (1, 3, 7, 0):  # a view `off` samples past an aligned start, then aligned
            x = base[off : off + frames * c]
            check.same("B4", ps.cumsum(x, c), cumsum_ref(x, c), f"B4 view {2 * off} bytes off C={c}")
        first = ps.cumsum(x, c)
        for _ in range(2):
            check.same("B4", ps.cumsum(x, c), first, f"B4 repeated C={c} frames={frames}")
    x = torch.full((16 * 2**17,), 32767, dtype=torch.int16, device=dev)  # wraps at C = 16
    check.same("B4", ps.cumsum(x, 16), cumsum_ref(x, 16), "B4 int32 wrap C=16")
    return largest


def phase_b4_times(x: torch.Tensor, bk: tuple[float, str]) -> float:
    """B4 redesigned on the 64M stream: at C = 16 (the two-pass averager's) and C = 1,
    median (min-max) of 20 after 5 warm-ups, beside ``torch.cumsum`` of the same samples
    (at C = 1 the 1-D stream, CUB's single-pass device scan, 20 calls; at C = 16 the
    outer-dimension scan of ``x.view(-1, 16)``, which walks 4M rows, 3 calls after one),
    its time before its redesign, the prediction, the bound and its attributes; and
    the generic kernel at C = 3. Returns torch.cumsum's median at C = 16."""
    n = x.numel()
    library = {}
    for c in (TWO_PASS_CHANNELS, 1):
        d = device_ms(lambda c=c: ps.cumsum(x, c), 5, 20)
        if c == 1:
            lib = device_ms(lambda: torch.cumsum(x, 0, dtype=torch.int32), 5, 20)
        else:
            lib = device_ms(lambda: torch.cumsum(x.view(-1, c), dim=0, dtype=torch.int32), 1, 3)
        med, library[c] = statistics.median(d), statistics.median(lib)
        was = f"before its redesign {B4_B22_EARLIER_MS['B4']:.4f} " \
              f"({B4_B22_EARLIER_MS['B4'] / med:.2f}x); " if c == TWO_PASS_CHANNELS else ""
        print(f"  B4 cumsum C={c} {med:.4f} ms ({min(d):.4f}-{max(d):.4f}) median (min-max) of 20; "
              f"{was}predicted {PREDICTED_MS['B4'][0]}-{PREDICTED_MS['B4'][1]}; bound {bk[0]:.4f} "
              f"({bk[1]}), kernel/bound {med / bk[0]:.2f}; torch.cumsum {library[c]:.4f} "
              f"({min(lib):.4f}-{max(lib):.4f}, {len(lib)} calls; "
              f"{'the 1-D stream' if c == 1 else 'the outer-dimension scan'}), kernel/library "
              f"{med / library[c]:.3f}; attrs (registers, local bytes, shared bytes, blocks an SM) "
              f"{ps.cumsum_kernel_attrs(c)}")
    x3 = x[: n // 3 * 3]
    d = device_ms(lambda: ps.cumsum(x3, 3), 5, 20)
    print(f"  B4 cumsum C=3 (generic) {statistics.median(d):.4f} ms ({min(d):.4f}-{max(d):.4f}); "
          f"attrs {ps.cumsum_kernel_attrs(3)}")
    return library[TWO_PASS_CHANNELS]


def phase_halo_bound(x: torch.Tensor, check: Checker) -> None:
    """B1, B2 and B3 against the two-pass route on both sides of their bounds, at 64M."""
    print(
        "[5 halo bound] B1 vs two-pass, 64M samples; `windowed` takes B1 while its ring is "
        f"<= {ps.WINDOWED_SMEM_MAX} bytes (two blocks an SM up to {ps.TWO_BLOCKS_SMEM_MAX}):"
    )
    for c in (2, 16):
        two = largest_window(
            lambda w, c=c: ps.windowed_geometry(w, c).smem_bytes <= ps.TWO_BLOCKS_SMEM_MAX)
        inside = largest_window(lambda w, c=c: ps.windowed_supported(w, c))
        for k in sorted({two // 2, two, two + 1, (two + inside) // 2, inside}):
            g = ps.windowed_geometry(k, c)
            check.same(
                "B1", ps.launch_windowed(x, k, c), moving_average_xla(x, k, c),
                f"B1 halo {k * c} k={k} C={c}",
            )
            b1, tp = time_pair(
                lambda: ps.launch_windowed(x, k, c),
                lambda: ps.moving_average_two_pass(x, k, c),
            )
            side = "inside" if ps.windowed_supported(k, c) else "beyond"
            print(
                f"  k={k} C={c} halo {k * c} ({side}, {g.smem_bytes} B, "
                f"{ps.windowed_kernel_attrs(k, c)[3]} blocks an SM): B1 {b1:.4f} ms, two-pass "
                f"{tp:.4f} ms, B1/two-pass {b1 / tp:.3f}"
            )
    # B2 on the int32 pair view: its former bound (two blocks an SM of its own block
    # buffer: k = 10118 at C = 2, 1070 at C = 16), one past it, and B1's largest window
    x32 = x.view(torch.int32)
    print("[5 halo bound] B2 vs two-pass on the int32 view, 64M samples; the packed route takes "
          "B2 while B1's ring fits (before: k <= 10118 at C=2, 1070 at C=16):")
    for c, ks in ((2, (10118, 10119, largest_window(lambda w: ps.packed_supported(w, 2)))),
                  (16, (1070, 1071, largest_window(lambda w: ps.packed_supported(w, 16))))):
        for k in ks:
            check.same("B2", ps.windowed_averager_packed(x32, k, c).view(torch.int16),
                       moving_average_xla(x, k, c), f"B2 halo {k * c} k={k} C={c}")
            b2, tp = time_pair(
                lambda: ps.windowed_averager_packed(x32, k, c),
                lambda: ps.moving_average_two_pass(x, k, c),
            )
            side = "inside" if ps.packed_supported(k, c) else "beyond"
            print(f"  k={k} C={c} halo {k * c} ({side}): B2 {b2:.4f} ms, two-pass {tp:.4f} ms, "
                  f"B2/two-pass {b2 / tp:.3f}")
    print(
        "[5 halo bound] B3 vs two-pass, 64M samples, at half and at the largest window whose "
        f"ring leaves two blocks an SM (<= {ps.TWO_BLOCKS_SMEM_MAX} bytes), one past it, and "
        f"the largest that fits ({ps.SMEM_MAX} bytes); `scan*` take B3 while its ring is "
        f"<= {ps.WINDOWED_SMEM_MAX} bytes (before: {ps.TWO_BLOCKS_SMEM_MAX}):"
    )
    for v in VARIANTS:
        for c in (2, 16) if v == "mxu" else (2, 3, 16):  # C = 3: the generic kernel
            two = largest_window(
                lambda w, c=c, v=v: ps.scan_geometry(w, c, v).smem_bytes <= ps.TWO_BLOCKS_SMEM_MAX
            )
            launchable = largest_window(
                lambda w, c=c, v=v: ps.scan_geometry(w, c, v).smem_bytes <= ps.SMEM_MAX
            )
            xc = x[: x.numel() // c * c]  # whole frames
            for k in sorted({two // 2, two, two + 1, launchable}):
                g = ps.scan_geometry(k, c, v)
                check.same(
                    f"B3/{v}", ps.launch_scan(xc, k, c, v), moving_average_xla(xc, k, c),
                    f"B3 {v} halo {k * c} k={k} C={c}",
                )
                b3, two_pass = time_pair(
                    lambda: ps.launch_scan(xc, k, c, v),
                    lambda: ps.moving_average_two_pass(xc, k, c),
                )
                side = "inside" if ps.scan_supported(k, c, v) else "beyond"
                print(
                    f"  {v} k={k} C={c} halo {k * c} ({side}, {g.smem_bytes} B, "
                    f"{ps.scan_kernel_attrs(k, c, v)[3]} blocks an SM): B3 {b3:.4f} ms, "
                    f"two-pass {two_pass:.4f} ms, B3/two-pass {b3 / two_pass:.3f}"
                )


def phase_serve_profile(wav: np.ndarray, split: int) -> None:
    """Wall time of the serving loop over phase 4's two WAVs, and where its device time goes."""
    with tempfile.TemporaryDirectory() as tmp:
        paths = [Path(tmp) / "a.wav", Path(tmp) / "b.wav"]
        write_wav(paths[0], wav[:split], 48000, 2)
        write_wav(paths[1], wav[split:], 48000, 2)

        def serve() -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stream_moving_average(
                paths, Path(tmp) / "out.wav", MAIN_WINDOW, chunk_samples=1 << 20,
                use_native=False, device="cuda",
            )
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        t0 = time.perf_counter()
        chunks = sum(1 for _ in WavChunkLoader(paths, 1 << 20))
        decode_ms = (time.perf_counter() - t0) * 1e3
        walls = [serve() for _ in range(3)]
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            profiled_ms = serve()
    rows = device_rows(prof)
    device_ms_total = sum(r[2] for r in rows)
    print(
        f"[6 serve] {wav.size} samples in {chunks} chunks of 2^20, k={MAIN_WINDOW}: wall "
        + ", ".join(f"{w:.1f}" for w in walls)
        + f" ms; decode alone {decode_ms:.1f} ms"
    )
    if not rows:
        print("  profiler saw no device time: device split not measured")
        return
    print(
        f"  profiled: wall {profiled_ms:.1f} ms, device {device_ms_total:.3f} ms, "
        f"device idle {1 - device_ms_total / profiled_ms:.3f} of the wall time"
    )
    for key, count, ms in rows:
        print(f"  {ms:9.3f} ms  {count:4d} x  {key[:80]}")


def phase_sweep(tmp: Path) -> None:
    """The sweep entry point on the card: the --smoke grid, then 64M at k=1024 for B3."""
    csv = tmp / "sweep.csv"
    reset_launch_counts()
    smoke = [v for v in sweep.VARIANTS if v != "golden_cpu"] + ["golden_cpu"]
    failures = sweep.run_suite([100_000], [1, 16, 128], smoke, [None], str(csv), verbose=False)
    failures += sweep.run_suite(
        [MAIN_SAMPLES], [MAIN_WINDOW], list(SCAN_METHODS), [None], str(csv), verbose=False
    )
    torch.cuda.synchronize()
    launches = launch_counts()
    lines = csv.read_text().splitlines()
    rows = [r.split(",") for r in lines]
    if failures:
        raise AssertionError(f"sweep: {failures} failed configs")
    # smoke: 6 timed variants at k=1 and 16, 4 at k=128 (direct and xla_direct
    # stop at 64), staged and resident, and 3 golden rows; 64M: 3 x 2 rows
    want = 1 + (6 + 6 + 4) * 2 + 3 + 3 * 2
    if lines[0] != CSV_COLUMNS or any(len(r) != 14 for r in rows) or len(rows) != want:
        raise AssertionError(f"sweep CSV has {len(rows)} lines, want {want} of 14 columns")
    for n in ("B1", "B3/blelloch", "B3/hillis_steele", "B3/mxu", "B5"):
        if launches[n] < 1:
            raise AssertionError(f"the sweep never launched {n}: {launches}")
    print(f"[4 sweep] run_suite: {len(rows) - 1} CSV rows, 0 failures; launches {launches}")
    for r in rows[1:]:
        if r[2] == str(MAIN_SAMPLES):
            print(
                f"  {r[0]:12s} {r[1]:8s} 64M k={r[3]}: h2d {r[5]} ms, compute {r[6]} ms, "
                f"d2h {r[7]} ms"
            )


def fir64_tail(x: torch.Tensor, h: np.ndarray, outputs: int) -> np.ndarray:
    """The last ``outputs`` samples of each channel's causal FIR, in float64 on the host."""
    k = h.size
    xs = x[:, max(0, x.shape[1] - outputs - k + 1):].double().cpu().numpy()
    xs = np.pad(xs, ((0, 0), (max(0, outputs + k - 1 - xs.shape[1]), 0)))
    return np.stack([np.convolve(row, h.astype(np.float64), "valid") for row in xs])


def fused_case(rng, dev, k: int, channels: int, t: int):
    x = torch.from_numpy(rng.standard_normal((channels, t), dtype=np.float32)).to(dev)
    h = (rng.standard_normal(k) / np.sqrt(k)).astype(np.float32)
    g = fm.fused_geometry(k, fm.pick_fused_block(k))
    return x, h, fm.tap_response(h, g, dev)


def fused_call(x: torch.Tensor, r: fm.TapResponse) -> torch.Tensor:
    return (fm.fused_fir if r.geometry.kernel == "B8" else fm.fused_fir3)(x, r)


def phase_fir_corners(rng, dev, check: Checker) -> None:
    """B8 and B9 against their plain versions and a float64 FIR at their corners."""
    xo = fir.FIR_FFT_CROSSOVER
    taps = sorted({1, 2, 63, *PLAN_TAPS, 257, max(1, xo - 1), xo + 1, LAST_B8, LAST_B8 + 1,
                   65537, LAST_B9})
    plain_err = 0.0
    for k in taps:
        block = fm.pick_fused_block(k)
        kernel = fm.fused_geometry(k, block).kernel
        for c in (1, 3, 16):
            for t in sorted({1, max(1, k - 1), block, block + 1, 3 * block // 2 + 1}):
                x, h, r = fused_case(rng, dev, k, c, t)
                y = fused_call(x, r)
                plain = fm.overlap_save_plain(x, r)
                label = f"{kernel} k={k} C={c} T={t}"
                rtol = FIR_RTOL
                if k in PLAN_TAPS:  # plus plain's own error against float64 on every channel's tail
                    tail = torch.from_numpy(fir64_tail(x, h, min(t, 64))).to(dev)
                    e = ((plain[:, t - tail.shape[1]:].double() - tail).abs().max()
                         / tail.abs().max()).item()
                    plain_err = max(plain_err, e)
                    rtol += e
                check.close(kernel, y, plain, f"{label} against plain", rtol)
                n = min(t, 64)
                want = torch.from_numpy(fir64_tail(x[-1:], h, n)).float().to(dev)
                check.close(kernel, y[-1:, t - n:], want, f"{label} against float64", FIR64_RTOL)
    # B9 at every nfft it takes (every line plan), and its waves: one wave exactly full,
    # one pair over it (two waves of about half), two waves and a pair over; at a
    # scratch of one pair, three waves of one pair; at two, 5 pairs as waves of 1, 2, 2
    for log2n in range(15, 21):
        nfft = 1 << log2n
        k = nfft // 4
        r = fm.tap_response((rng.standard_normal(k) / np.sqrt(k)).astype(np.float32),
                            fm.fused_geometry(k, (nfft - k + 1) // 128 * 128), dev)
        x = torch.from_numpy(rng.standard_normal((3, 2 * nfft + 17), dtype=np.float32)).to(dev)
        check.close("B9", fm.fused_fir3(x, r), fm.overlap_save_plain(x, r), f"B9 nfft {nfft} C=3")
    _, h, r = fused_case(rng, dev, LAST_B8 + 1, 1, 1)
    g = r.geometry
    saved = fm.FUSED3_SCRATCH_BYTES
    waves = []
    try:
        for scratch_pairs, pairs in ((None, g.wave_pairs), (None, g.wave_pairs + 1),
                                     (None, 2 * g.wave_pairs + 1), (1, 3), (2, 5)):
            if scratch_pairs is not None:
                fm.FUSED3_SCRATCH_BYTES = scratch_pairs * 8 * g.nfft
            c = 3 if pairs % 3 == 0 else 1
            t = (2 * pairs // c) * g.block - 5  # rows = 2 * pairs, the last one ragged
            x = torch.from_numpy(rng.standard_normal((c, t), dtype=np.float32)).to(dev)
            assert g.pairs(c, t) == pairs
            y = fm.fused_fir3(x, r)
            check.close("B9", y, fm.overlap_save_plain(x, r), f"B9 {pairs} pairs, waves of {g.wave(pairs)}")
            want = torch.from_numpy(fir64_tail(x[-1:], h, 64)).float().to(dev)
            check.close("B9", y[-1:, -64:], want, f"B9 {pairs} pairs against float64", FIR64_RTOL)
            waves.append(f"{pairs} pairs in waves of {g.wave(pairs)} (at most {g.wave_pairs})")
    finally:
        fm.FUSED3_SCRATCH_BYTES = saved
    print(f"[3 FIR corners] B9 at nfft 2^15..2^20; waves: {'; '.join(waves)}")
    # B8's smallest plan, nfft 128, which only a block of 128 at one tap reaches
    for c, t in ((1, 1), (3, 100_003)):
        x = torch.from_numpy(rng.standard_normal((c, t), dtype=np.float32)).to(dev)
        h = rng.standard_normal(1).astype(np.float32)
        r = fm.tap_response(h, fm.fused_geometry(1, 128), dev)
        check.close("B8", fm.fused_fir(x, r), fm.overlap_save_plain(x, r), f"B8 nfft 128 C={c} T={t}")
    # impulses (alignment across segment edges) and zeros (exactly zero out)
    for k in (257, LAST_B8, LAST_B8 + 1, 65537):
        _, h, r = fused_case(rng, dev, k, 1, 1)
        block = r.geometry.block
        t = 3 * block + 5
        starts = (0, block - 1, block, t - k // 2 - 1)
        x = torch.zeros(len(starts), t, device=dev)
        want = torch.zeros_like(x)
        for c, p in enumerate(starts):
            x[c, p] = 1.0
            n = min(k, t - p)
            want[c, p : p + n] = torch.from_numpy(h[:n]).to(dev)
        check.close(r.geometry.kernel, fused_call(x, r), want, f"impulse k={k}")
        zero = fused_call(torch.zeros_like(x), r)
        torch.cuda.synchronize()
        if torch.count_nonzero(zero).item():
            raise AssertionError(f"zero input gave a nonzero output at k={k}")
    # the direct route's conv1d runs in IEEE float32: its error against float64
    # is far below TF32's (10 mantissa bits); cuDNN's default shown beside it
    x, h, _ = fused_case(rng, dev, 257, 16, 1 << 16)
    want = fir64_tail(x, h, 4096)
    got = fir.fir_direct(x, h)[:, -4096:].double().cpu().numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    w = torch.from_numpy(h.copy()).to(dev).flip(0).view(1, 1, -1)
    default = torch.nn.functional.conv1d(torch.nn.functional.pad(x[:, None], (256, 0)), w)
    derr = np.abs(default[:, 0, -4096:].double().cpu().numpy() - want).max() / np.abs(want).max()
    if not err < 1e-5:
        raise AssertionError(f"fir_direct's conv1d is not IEEE float32: relative error {err:.2e}")
    print(
        f"[3 FIR corners] taps {taps}: B8 {check.count['B8']} and B9 {check.count['B9']} "
        f"checks within {FIR_RTOL} of plain and {FIR64_RTOL} of float64 (x max|y|), impulses "
        f"at segment edges, zeros exact; taps {PLAN_TAPS} (B8's plans at nfft 1024, 2048 and "
        f"8192) within {FIR_RTOL} of plain plus plain's own error against float64, at most "
        f"{plain_err:.3e}; max abs error B8 {check.max_err['B8']:.3e}, "
        f"B9 {check.max_err['B9']:.3e}; conv1d relative error against float64 {err:.2e} "
        f"(cuDNN's default setting {derr:.2e})"
    )


def fm_tones(rng, dev) -> tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """I and Q of 16 channels, each an FM tone at its LO frequency plus noise.

    Channel c carries a sine message of 0.0005 * (c + 1) cycles a sample at
    deviation 0.05 rad a sample (the reference's tone test, test_models.py:
    50-79, on every channel), with Gaussian noise of 0.01 from ``rng``. Its
    phasors stay away from zero, where the discriminator's atan2 would turn
    float rounding into jumps of 2*pi.
    """
    lo = torch.from_numpy(ChainConfig().lo_frequencies().astype(np.float64)).to(dev)[:, None]
    msg_f = 0.0005 * (1 + np.arange(16))
    n = torch.arange(CHAIN_T, dtype=torch.float64, device=dev)
    msg = torch.sin(2 * np.pi * torch.from_numpy(msg_f).to(dev)[:, None] * n)
    phase = 2 * np.pi * torch.remainder(lo * n, 1.0) + 0.05 * torch.cumsum(msg, dim=1)
    noise = torch.from_numpy(rng.standard_normal((2, 16, CHAIN_T), dtype=np.float32)).to(dev)
    i = torch.cos(phase).float() + 0.01 * noise[0]
    q = torch.sin(phase).float() + 0.01 * noise[1]
    return i, q, msg_f


def phase_chain_main(rng, dev, check: Checker) -> tuple[dict, dict]:
    """The chain and the FIR through their entry points at full width, counts reset around."""
    i, q, msg_f = fm_tones(rng, dev)
    h8 = (rng.standard_normal(LAST_B8) / np.sqrt(LAST_B8)).astype(np.float32)
    h9 = (rng.standard_normal(LAST_B8 + 1) / np.sqrt(LAST_B8)).astype(np.float32)
    configs = {
        "flagship": ChainConfig(channels=16, decimation=8),
        "long_taps": ChainConfig(channels=16, decimation=8, channel_taps=LAST_B8),  # nfft 16384
        "fused_frontend": ChainConfig(channels=16, decimation=8, fused_frontend=True),
    }
    chains = {name: DspChain(cfg, device=dev) for name, cfg in configs.items()}
    torch.cuda.synchronize()
    routes, ys = {}, {}
    reset_launch_counts()
    for name, chain in chains.items():
        ys[name] = chain.forward_planar(i, q)
        # the fused frontend's one decimating conv1d calls no fir_filter
        routes[name] = "decimate" if chain.config.fused_frontend else last_choice("fir_filter")
    ys["fir_b8"] = fir.fir_filter(i, h8)
    routes["fir_b8"] = last_choice("fir_filter")
    ys["fir_b9"] = fir.fir_filter(i, h9)
    routes["fir_b9"] = last_choice("fir_filter")
    state = chain_stream_init(chains["flagship"])
    chunks = []
    for part in range(8):
        sl = slice(part * CHAIN_T // 8, (part + 1) * CHAIN_T // 8)
        state, y = chain_stream_chunk(chains["flagship"], state, i[:, sl], q[:, sl])
        chunks.append(y)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"[4 chain] routes {routes}; launches {launches}")

    flagship_route = "direct" if 257 <= fir.FIR_FFT_CROSSOVER else "overlap_save_fused"
    want_routes = {
        "flagship": flagship_route, "long_taps": "overlap_save_fused",
        "fused_frontend": "decimate",
        "fir_b8": "overlap_save_fused", "fir_b9": "overlap_save_fused",
    }
    if routes != want_routes:
        raise AssertionError(f"routes {routes}; want {want_routes}")
    if launches["B8"] < 1 or launches["B9"] < 1:
        raise AssertionError(f"the chain's main path never launched B8 or B9: {launches}")
    for name in configs:
        y = ys[name]
        if y.shape != (16, CHAIN_T // 8) or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{name}: shape {tuple(y.shape)} or non-finite output")
    # causal: the first 2^16 input samples fix the first 2^13 outputs; the
    # same prefix through the chain on the CPU (its plain versions)
    prefix = 1 << 16
    for name, cfg in configs.items():
        cpu = DspChain(cfg, device="cpu").forward_planar(i[:, :prefix].cpu(), q[:, :prefix].cpu())
        ramp = (cfg.channel_taps + 8 * cfg.decimation) // cfg.decimation + cfg.audio_taps
        got = ys[name][:, ramp : prefix // 8].cpu().numpy()
        np.testing.assert_allclose(got, cpu[:, ramp:].numpy(), rtol=1e-3, atol=1e-4)
    streamed = torch.cat(chunks, dim=-1)
    ramp = (257 + 64) // 8 + 63
    np.testing.assert_allclose(
        streamed[:, ramp:].cpu().numpy(), ys["flagship"][:, ramp:].cpu().numpy(),
        rtol=1e-3, atol=1e-4,
    )
    for name, h in (("fir_b8", h8), ("fir_b9", h9)):
        g = fm.fused_geometry(h.size, fm.pick_fused_block(h.size))
        kernel = g.kernel
        plain = fm.overlap_save_plain(i, fm.tap_response(h, g, dev))
        check.close(kernel, ys[name], plain, f"{name} 16x2^22 against plain")
        want = torch.from_numpy(fir64_tail(i, h, 256)).float().to(dev)
        check.close(kernel, ys[name][:, -256:], want, f"{name} against float64", FIR64_RTOL)
    # each channel demodulates its own message: the audio's spectral peak
    audio = ys["flagship"][:, ramp:]
    spec = torch.fft.rfft(audio - audio.mean(dim=1, keepdim=True), dim=1).abs()
    peaks = spec.argmax(dim=1).cpu().numpy()
    want = np.round(msg_f * 8 * audio.shape[1]).astype(np.int64)  # 8: the decimation
    if np.abs(peaks - want).max() > 3:
        raise AssertionError(f"message tones at bins {peaks.tolist()}, want {want.tolist()}")
    print(
        "[4 chain] 16 x 2^22 FM tones: flagship, long taps and fused frontend finite and "
        "within rtol 1e-3 / atol 1e-4 of the chain on the CPU over the first 2^16 samples; "
        "8 chunks within the same of one shot; every channel's message tone at its bin; "
        f"fir_filter at k={LAST_B8} (B8) and k={LAST_B8 + 1} (B9) within {FIR_RTOL} of "
        f"plain and {FIR64_RTOL} of float64"
    )
    return launches, {"i": i, "q": q, "h8": h8, "h9": h9, "chain": chains["flagship"]}


def fused_limit(g: fm.FusedGeometry, pairs: int) -> float:
    """ms of the shared-memory and shuffle traffic of B8's or B9's design for
    ``pairs`` pairs, at 128 bytes a clock an SM (a warp's shuffle of a float
    moves as many): a sweep writes and reads every point once, 16 bytes. B8:
    its exchanges between Stockham passes, len(radices) - 1 a transform,
    forward and inverse. B9: the column and output launches' staging in and
    out (4 sweeps), each n1-point line's exchanges (a warp plan's shuffle
    transpose counts one) in both, and each n2-point row's in its two
    transforms."""
    def exchanges(m: int) -> int:
        return len(fm.B9_LINE_PLANS[m.bit_length() - 1][1]) - 1

    if g.kernel == "B8":
        sweeps = 2 * (len(g.radices) - 1)
    else:
        sweeps = 4 + 2 * exchanges(g.n1) + 2 * exchanges(g.n2)
    return pairs * sweeps * g.nfft * 16 / (132 * 128 * 1.98e9) * 1e3


def phase_fir_times(main: dict) -> dict:
    """B8 and B9 against plain, bound and conv1d at the main path's shapes; the crossover."""
    x = main["i"]
    dev = x.device
    c, t = x.shape
    out = {}
    flagship = main["chain"].channel_taps.detach().cpu().numpy().copy()  # 257 taps, nfft 4096
    for kernel, h in (("B8 257", flagship), ("B8", main["h8"]), ("B9", main["h9"])):
        g = fm.fused_geometry(h.size, fm.pick_fused_block(h.size))
        r = fm.tap_response(h, g, dev)
        hd = torch.from_numpy(h).to(dev)
        plain = device_ms(lambda r=r: fm.overlap_save_plain(x, r), 3, 5)
        runs = device_ms(lambda r=r: fused_call(x, r), 5, 20)
        plain += device_ms(lambda r=r: fm.overlap_save_plain(x, r), 3, 5)
        library = statistics.median(device_ms(lambda hd=hd: fir.fir_direct(x, hd), 1, 3))
        pairs = g.pairs(c, t)
        n = g.nfft
        flops = pairs * (2 * 5 * n * np.log2(n) + 6 * n)  # two complex FFTs and the product a pair
        b = bound(8 * c * t, flops, FP32_FLOPS_PER_S)
        out[kernel] = {"ms": statistics.median(runs), "lo": min(runs), "hi": max(runs),
                       "plain": statistics.median(plain), "library": library, "bound": b,
                       "smem": fused_limit(g, pairs), "k": h.size, "nfft": n, "block": g.block,
                       "geometry": g, "response": r}
    print(f"[5 FIR times] 16 x 2^22 float32, kernels median (min-max) of 20 after 5 warm-ups, "
          f"plain median of 10, conv1d of 3 after 1:")
    for kernel, v in out.items():
        g = v["geometry"]
        design = (f"Stockham passes {g.radices}, {g.points} points a thread, "
                  f"{len(g.radices) - 1} exchanges a transform" if g.kernel == "B8"
                  else f"lines of {g.n1} and {g.n2} points in registers, {g.g1} columns and "
                  f"{g.g2} rows a block, staging through shared memory, waves of "
                  f"{g.wave(g.pairs(c, t))} pairs")
        redesign = B8_REDESIGN_MS.get(kernel)
        was = f"; at its redesign {redesign:.4f}" if redesign else ""
        if kernel in B9_B3_EARLIER_MS:
            was = (f"; before its redesign {B9_B3_EARLIER_MS[kernel]:.4f} "
                   f"({B9_B3_EARLIER_MS[kernel] / v['ms']:.2f}x)")
        print(
            f"  {kernel} k={v['k']} nfft {v['nfft']} block {v['block']}: {v['ms']:.4f} ms "
            f"({v['lo']:.4f}-{v['hi']:.4f}){was}; plain {v['plain']:.4f}; bound {v['bound'][0]:.4f} "
            f"({v['bound'][1]}); shared-memory limit of the design ({design}) {v['smem']:.4f}; "
            f"library conv1d (IEEE fp32) {v['library']:.4f}"
        )
    print("  B8 by plan (registers, local bytes, shared bytes, blocks an SM, threads a block): "
          + "; ".join(f"nfft {1 << lg} {fm.fused_kernel_attrs(lg)}" for lg in sorted(fm.B8_PLANS)))
    print("  B9's launches at nfft 131072 (registers, local bytes, shared bytes, blocks an SM, "
          "threads a block): "
          + "; ".join(f"{k} {v}" for k, v in fm.fused3_kernel_attrs(out["B9"]["geometry"]).items()))
    for kernel in out:
        fn = (lambda v=out[kernel]: fused_call(x, v["response"]))
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        print(f"  {kernel} by launch (torch.profiler, 3 calls): "
              + "; ".join(f"{k[:48]} x{c} {ms / c:.4f} ms a launch" for k, c, ms in device_rows(prof)))
    # crossover: conv1d (the direct route) against B8 (the fused route) by taps
    print("[5 crossover] conv1d (IEEE fp32) against B8 on 16 x 2^22, ms:")
    faster_direct = []
    for k in CROSSOVER_TAPS:
        rng = np.random.default_rng(k)
        h = (rng.standard_normal(k) / np.sqrt(k)).astype(np.float32)
        hd = torch.from_numpy(h).to(dev)
        g = fm.fused_geometry(k, fm.pick_fused_block(k))
        r = fm.tap_response(h, g, dev)
        b8 = statistics.median(device_ms(lambda r=r: fm.fused_fir(x, r), 3, 5))
        reps = (2, 5) if k <= 513 else (1, 2)  # conv1d grows with k: fewer repetitions
        direct = statistics.median(device_ms(lambda hd=hd: fir.fir_direct(x, hd), *reps))
        if direct < b8:
            faster_direct.append(k)
        print(f"  k={k:5d} nfft {g.nfft:5d}: conv1d {direct:10.4f}  B8 {b8:8.4f}  conv1d/B8 {direct / b8:8.3f}")
    print(
        f"  conv1d faster at k in {faster_direct}; FIR_FFT_CROSSOVER = {fir.FIR_FFT_CROSSOVER} "
        f"(conv1d repetitions: 5 after 2 up to k=513, 2 after 1 beyond)"
    )
    return out


def phase_chain_profile(main: dict) -> None:
    """The flagship's wall time, and its device time by stage under torch.profiler."""
    chain, i, q = main["chain"], main["i"], main["q"]
    cfg = chain.config

    def forward() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chain.forward_planar(i, q)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    forward()
    walls = [forward() for _ in range(3)]
    wall, device, rows = profiled(lambda: chain.forward_planar(i, q))
    print(
        f"[7 chain] flagship 16 x 2^22: wall {', '.join(f'{w:.2f}' for w in walls)} ms; profiled "
        f"wall {wall:.2f} ms, device {device:.3f} ms, device idle {1 - device / wall:.3f}"
    )
    # each stage alone, on the inputs the forward gives it
    iq = torch.complex(i, q)
    lo_c, lo_s = oscillator_bank(chain.lo, CHAIN_T, 0)
    mixed = iq * torch.complex(lo_c, lo_s)
    response = chain.channel_response()
    fi = fir.fir_filter(mixed.real, chain.channel_taps, response=response)
    fq = fir.fir_filter(mixed.imag, chain.channel_taps, response=response)
    di = decimate(fi, cfg.decimation, taps=chain.decimation_taps)
    dq = decimate(fq, cfg.decimation, taps=chain.decimation_taps)
    audio = fm_demodulate(torch.complex(di, dq), gain=cfg.fm_gain)
    stages = {
        "LO bank": lambda: oscillator_bank(chain.lo, CHAIN_T, 0),
        "mix": lambda: iq * torch.complex(lo_c, lo_s),
        "channel FIR": lambda: (
            fir.fir_filter(mixed.real, chain.channel_taps, response=response),
            fir.fir_filter(mixed.imag, chain.channel_taps, response=response),
        ),
        "decimate": lambda: (
            decimate(fi, cfg.decimation, taps=chain.decimation_taps),
            decimate(fq, cfg.decimation, taps=chain.decimation_taps),
        ),
        "FM demod": lambda: fm_demodulate(torch.complex(di, dq), gain=cfg.fm_gain),
        "audio FIR": lambda: fir.fir_direct(audio, chain.audio_taps),
    }
    profile_stages(stages, "chain")
    for key, count, ms in rows[:8]:
        print(f"  {ms:9.3f} ms  {count:4d} x  {key[:80]}")


def sos64(sos, x: torch.Tensor, zi: torch.Tensor | None = None):
    """scipy's float64 cascade of (C, T), with the float32 coefficients, on the host:
    (y float32 on x's device, end state float32 on x's device or None)."""
    s64 = np.asarray(sos, np.float32).astype(np.float64)
    x64 = x.double().cpu().numpy()
    if zi is None:
        return torch.from_numpy(sps.sosfilt(s64, x64, axis=-1)).float().to(x.device), None
    y, zf = sps.sosfilt(s64, x64, axis=-1, zi=zi.double().cpu().numpy())
    return torch.from_numpy(y).float().to(x.device), torch.from_numpy(zf).float().to(x.device)


def iir1_64(x: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """y = a*y + b*x in float64 on the host, with the float32 coefficients."""
    a32, b32 = float(np.float32(a)), float(np.float32(b))
    y = sps.lfilter([b32], [1.0, -a32], x.double().cpu().numpy(), axis=-1)
    return torch.from_numpy(y).float().to(x.device)


def phase_iir_corners(rng, dev, check: Checker) -> None:
    """B10, B12 (seeded and not), B13 and B15 against their plain versions and float64."""
    sub = iir.SUB_TILE
    lengths = (1, sub - 1, sub, sub + 1, 3 * sub + 77, 100_003)

    def sig(c: int, t: int) -> torch.Tensor:
        return torch.from_numpy(rng.standard_normal((c, t), dtype=np.float32)).to(dev)

    def cascade(x, sos, st, label, ref64: bool) -> None:
        y12, _ = iir.sos_cascade(x, sos)
        y13 = iir.sos_cascade_unrolled(x, sos)
        plain, _ = iir._sos_plain(x, sos, None)
        check.close("B12", y12, plain, f"B12 {label} against plain", IIR_RTOL)
        check.close("B13", y13, plain, f"B13 {label} against plain", IIR_RTOL)
        ys, end = iir.sos_cascade(x, sos, st)
        ys_plain, end_plain = iir._sos_plain(x, sos, st)
        check.close("B12", ys, ys_plain, f"B12 seeded {label}", IIR_RTOL)
        check.close("B12", end, end_plain, f"B12 end state {label}", IIR_RTOL, ys_plain)
        y15, e15 = iir.sos_sections(x, sos, st)
        y15_plain, e15_plain = iir._sections_plain(x, sos, st)
        check.close("B15", y15, y15_plain, f"B15 seeded {label}", IIR_RTOL)
        check.close("B15", e15, e15_plain, f"B15 end state {label}", IIR_RTOL, y15_plain)
        # float64: every channel, or the first where the stream is long
        c = x.shape[0] if ref64 else 1
        want, zf = sos64(sos, x[:c], st[:, :c].contiguous())
        check.close("B12", ys[:c], want, f"B12 {label} against float64", IIR64_RTOL)
        check.close("B12", end[:, :c], zf, f"B12 end {label} against float64", IIR64_RTOL, want)
        check.close("B15", y15[:c], want, f"B15 {label} against float64", IIR64_RTOL)
        want0, _ = sos64(sos, x[:c])
        check.close("B12", y12[:c], want0, f"B12 unseeded {label} against float64", IIR64_RTOL)
        check.close("B13", y13[:c], want0, f"B13 {label} against float64", IIR64_RTOL)
        again = iir.sos_cascade_unrolled(x, sos)
        torch.cuda.synchronize()
        if not torch.equal(again, y13):
            raise AssertionError(f"B13 {label}: two calls differ")

    for s in (3, 5, 6, 7):  # B13's other instances
        sos = iir.design_butterworth(2 * s, 0.1)
        st = torch.from_numpy((0.3 * rng.standard_normal((s, 3, 2))).astype(np.float32)).to(dev)
        cascade(sig(3, 100_003), sos, st, f"S={s} C=3 T=100003", True)
    for s in (1, 2, 4, 8):
        sos = iir.design_butterworth(2 * s, 0.1)
        cases = [(c, t) for c in (1, 3, 16) for t in lengths] + [(16, IIR_T)]
        for c, t in cases:
            st = torch.from_numpy((0.3 * rng.standard_normal((s, c, 2))).astype(np.float32)).to(dev)
            cascade(sig(c, t), sos, st, f"S={s} C={c} T={t}", t < IIR_T)
    for a in IIR_POLES:
        for c, t in [(c, t) for c in (1, 3, 16) for t in lengths] + [(16, IIR_T)]:
            x = sig(c, t)
            y = iir.iir1_block_scan(x, a, 0.7)
            label = f"a={a} C={c} T={t}"
            check.close("B10", y, iir._iir1_plain(x, a, 0.7), f"B10 {label} against plain", IIR_RTOL)
            k = c if t < IIR_T else 1
            check.close("B10", y[:k], iir1_64(x[:k], a, 0.7), f"B10 {label} against float64",
                        IIR64_RTOL)
    # B12's look-back: tiles of one sub-tile (tile_rows=32) numbering one below,
    # at, one above and past three times its depth L, seeded, ragged; tiles of
    # five sub-tiles (160), one more than a block holds (the fifth streamed and
    # read twice); 16 sections as four of the main path's filters in a row
    lb_cases = 0
    for sos in (iir.design_butterworth(2, 0.1), IIR_SOS, iir.design_butterworth(16, 0.1),
                np.tile(IIR_SOS, (4, 1))):
        s = sos.shape[0]
        depth = iir.lookback_depth(s)
        for ntiles, tile_rows in ((depth - 1, 32), (depth, 32), (depth + 1, 32),
                                  (3 * depth + 2, 32), (3, 160)):
            t = ntiles * iir.lookback_tile(1, 1, tile_rows) - 37
            x = sig(3, t)
            st = torch.from_numpy((0.3 * rng.standard_normal((s, 3, 2))).astype(np.float32)).to(dev)
            label = f"S={s} {ntiles} tiles of tile_rows={tile_rows} T={t}"
            for state in (None, st):
                y, end = iir.sos_cascade(x, sos, state, tile_rows=tile_rows)
                want, want_end = iir._sos_plain(x, sos, state)
                check.close("B12", y, want, f"B12 look-back {label} against plain", IIR_RTOL)
                y64, zf = sos64(sos, x, None if state is None else state)
                check.close("B12", y, y64, f"B12 look-back {label} against float64", IIR64_RTOL)
                if state is not None:
                    check.close("B12", end, want_end, f"B12 look-back end {label}", IIR_RTOL, want)
                    check.close("B12", end, zf, f"B12 look-back end {label} against float64",
                                IIR64_RTOL, y64)
                lb_cases += 1
    # impulses at tile edges (tile_rows=32: tiles of 4096) and around the depth
    t = 10 * sub + 5
    x = torch.zeros(5, t, device=dev)
    for c, p in enumerate((0, sub - 1, sub, 8 * sub - 1, 8 * sub)):
        x[c, p] = 1.0
    want, _ = sos64(IIR_SOS, x)
    check.close("B12", iir.sos_cascade(x, IIR_SOS, tile_rows=32)[0], want,
                "B12 impulses at tile edges", IIR_RTOL)
    # seeded chunks: the state after each chunk is the one-shot state at that sample
    sos = IIR_SOS
    x = sig(16, 1 << 20)
    st = torch.zeros(4, 16, 2, device=dev)
    cuts = (0, 1, sub + 3, 500_001, 1 << 20)
    outs = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        st, y = iir.sosfilt_chunk_pallas_fused(st, sos, x[:, a:b])
        outs.append(y)
        want, zf = sos64(sos, x[:, :b], torch.zeros(4, 16, 2))
        scale = torch.cat([zf.flatten(), want.flatten()])
        check.close("B12", st, zf, f"B12 state after sample {b - 1}", IIR64_RTOL, scale)
    want, _ = sos64(sos, x)
    check.close("B12", torch.cat(outs, 1), want, "B12 chunks against float64 one shot", IIR64_RTOL)
    # impulses across sub-tile edges give the filter's impulse response; zeros stay zero
    t = 3 * sub + 5
    x = torch.zeros(4, t, device=dev)
    for c, p in enumerate((0, sub - 1, sub, t - 100)):
        x[c, p] = 1.0
    want, _ = sos64(sos, x)
    check.close("B12", iir.sos_cascade(x, sos)[0], want, "B12 impulses", IIR_RTOL)
    check.close("B13", iir.sos_cascade_unrolled(x, sos), want, "B13 impulses", IIR_RTOL)
    check.close("B15", iir.sos_sections(x, sos)[0], want, "B15 impulses", IIR_RTOL)
    check.close("B10", iir.iir1_block_scan(x, 0.99), iir1_64(x, 0.99, 1.0), "B10 impulses", IIR_RTOL)
    zero = torch.zeros_like(x)
    outs = (iir.sos_cascade(zero, sos)[0], iir.sos_cascade_unrolled(zero, sos),
            iir.sos_sections(zero, sos)[0], iir.iir1_block_scan(zero, 0.9999),
            iir.sos_cascade(zero, sos, torch.zeros(4, 4, 2, device=dev))[1])
    torch.cuda.synchronize()
    if any(torch.count_nonzero(o).item() for o in outs):
        raise AssertionError("a zero input gave a nonzero IIR output or state")
    high = iir_high_order_corners(sig, rng, dev, check)
    print(
        f"[3 IIR corners] sections {{1, 2, 4, 8}}, C {{1, 3, 16}}, T {{1, {sub - 1}, {sub}, "
        f"{sub + 1}, {3 * sub + 77}, 100003}} and 16 x 2^22, a {IIR_POLES}: "
        + ", ".join(f"{k} {check.count[k]} checks" for k in IIR_KERNELS)
        + f" within {IIR_RTOL} of plain and {IIR64_RTOL} of float64 (x max|y|), seeded chunk "
        f"states against the float64 state at their last sample, B12's look-back in {lb_cases} "
        "calls (sections 1, 4, 8, 16; tiles around its depth, streamed tiles, seeded and not, "
        "ragged), impulses at sub-tile and tile edges, zeros exact, B13 bit-identical over calls; "
        + high + "; max abs error "
        + ", ".join(f"{k} {check.max_err[k]:.3e}" for k in IIR_KERNELS)
    )


def iir_high_order_corners(sig, rng, dev, check: Checker) -> str:
    """Past the kernels' largest instances (the wrappers chain groups: B12 and B14 of
    16 sections, B13 of 8): B13 at 9 and 17 sections, B12 (sosfilt, seeded chunks,
    sosfiltfilt) and B14 at 17, against plain and float64. Where float32 itself
    lies further than IIR_RTOL from float64 (17 sections of butter(34, 0.1)), a
    kernel is held to plain within HIGHQ_FACTOR x plain's own float64 error."""
    def near_plain(kernel, got, plain, want, what):
        own = (plain.double() - want.double()).abs().max().item() / want.abs().max().item()
        check.close(kernel, got, plain, f"{what} against plain", max(IIR_RTOL, HIGHQ_FACTOR * own))
        check.close(kernel, got, want, f"{what} against float64", IIR64_RTOL)

    launches = {}
    for s in (9, 17):
        sos = iir.design_butterworth(2 * s, 0.1)
        for c, t in ((3, 100_003), (16, 1 << 20)):
            x = sig(c, t)
            plain, _ = iir._sos_plain(x, sos, None)
            want, _ = sos64(sos, x)
            before = iir.sos_cascade_unrolled.launches
            y13 = iir.sos_cascade_unrolled(x, sos)
            launches[f"B13 S={s}"] = iir.sos_cascade_unrolled.launches - before
            near_plain("B13", y13, plain, want, f"B13 S={s} C={c} T={t}")
            if s == 17:
                near_plain("B12", iir.sosfilt(sos, x), plain, want, f"sosfilt S=17 C={c} T={t}")
                near_plain("B14", iir.sosfilt_pallas_fused(sos, x, lane_pass="mxu"), plain, want,
                           f"B14 S=17 C={c} T={t}")
    sos = iir.design_butterworth(34, 0.1)
    x = sig(4, 300_001)
    st = torch.zeros(17, 4, 2, device=dev)
    outs = []
    for a, b in ((0, 1), (1, 100_000), (100_000, 300_001)):
        st, y = iir.sosfilt_chunk(st, sos, x[:, a:b])
        outs.append(y)
    want, zf = sos64(sos, x, torch.zeros(17, 4, 2))
    near_plain("B12", torch.cat(outs, 1), iir._sos_plain(x, sos, None)[0], want,
               "sosfilt_chunk S=17 in 3 chunks")
    check.close("B12", st, zf, "sosfilt_chunk S=17 end state against float64", IIR64_RTOL, want)
    y = iir.sosfiltfilt(sos, x)
    x64 = x.double().cpu().numpy()
    want = torch.from_numpy(np.ascontiguousarray(sps.sosfiltfilt(sos.astype(np.float64), x64)))
    want = want.float().to(dev)
    plain = iir.sosfiltfilt(sos, x.cpu()).to(dev)
    near_plain("B12", y, plain, want, "sosfiltfilt S=17")
    if launches != {"B13 S=9": 2, "B13 S=17": 3}:
        raise AssertionError(f"B13's groups: launches {launches}")
    return ("9 and 17 sections (B13 in 2 and 3 launches, B12, sosfilt_chunk, sosfiltfilt and B14 "
            "at 17) against plain and float64")


def phase_iir_main(rng, dev, check: Checker, wav: np.ndarray, split: int) -> tuple[dict, dict]:
    """The IIR serving path through its entry points at 16 x 2^22, counts reset around."""
    x = torch.from_numpy(rng.standard_normal((16, IIR_T), dtype=np.float32)).to(dev)
    sos = IIR_SOS
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        paths = [tmp / "a.wav", tmp / "b.wav"]
        write_wav(paths[0], wav[:split], 48000, 2)
        write_wav(paths[1], wav[split:], 48000, 2)
        torch.cuda.synchronize()
        ys, routes = {}, {}
        reset_launch_counts()
        ys["auto"] = iir.sosfilt(sos, x)
        routes["sosfilt"] = last_choice("sosfilt")
        ys["pallas"] = iir.sosfilt(sos, x, method="pallas")
        routes["sosfilt pallas"] = last_choice("sosfilt")
        ys["unrolled"] = iir.sosfilt_pallas_fused(sos, x, unroll_sections=True)
        ys["dc_block"] = gain.dc_block(x)
        routes["dc_block"] = last_choice("iir_first_order")
        ys["agc"] = gain.agc(x)
        routes["agc"] = last_choice("iir_first_order")
        ys["sosfiltfilt"] = iir.sosfiltfilt(sos, x[0])
        routes["sosfiltfilt"] = last_choice("sosfilt_chunk")
        ys["decimate"] = decimate(x[0], 8, ftype="iir")
        routes["decimate iir"] = last_choice("sosfilt_chunk")
        written = stream_sosfilt(paths, tmp / "served.wav", sos, chunk_samples=1 << 20, device="cuda")
        routes["stream_sosfilt"] = last_choice("sosfilt_chunk")
        torch.cuda.synchronize()
        launches = launch_counts()
        served = read_wav(tmp / "served.wav")[1]
    print(f"[4 IIR] routes {routes}; launches {launches}")
    want_routes = {
        "sosfilt": "pallas_fused", "sosfilt pallas": "pallas", "dc_block": "pallas",
        "agc": "pallas", "sosfiltfilt": "pallas_fused", "decimate iir": "pallas_fused",
        "stream_sosfilt": "pallas_fused",
    }
    if routes != want_routes:
        raise AssertionError(f"routes {routes}; want {want_routes}")
    if min(launches[k] for k in IIR_KERNELS) < 1:
        raise AssertionError(f"the IIR main path never launched one of {IIR_KERNELS}: {launches}")
    plain, _ = iir._sos_plain(x, sos, None)
    check.close("B12", ys["auto"], plain, "sosfilt 16x2^22 against plain", IIR_RTOL)
    check.close("B13", ys["unrolled"], plain, "unrolled 16x2^22 against plain", IIR_RTOL)
    check.close("B15", ys["pallas"], iir._sections_plain(x, sos, None)[0],
                "sosfilt pallas 16x2^22 against plain", IIR_RTOL)
    want, _ = sos64(sos, x[:1])
    for kernel, key in (("B12", "auto"), ("B13", "unrolled"), ("B15", "pallas")):
        check.close(kernel, ys[key][:1], want, f"{key} channel 0 against float64", IIR64_RTOL)
    xc = x[:2].cpu()
    check.close("B10", ys["dc_block"][:2], gain.dc_block(xc).to(dev), "dc_block against the CPU",
                IIR_RTOL)
    check.close("B10", ys["agc"][:2], gain.agc(xc).to(dev), "agc against the CPU", IIR_RTOL)
    x0 = x[0].double().cpu().numpy()
    s64 = sos.astype(np.float64)
    want = torch.from_numpy(np.ascontiguousarray(sps.sosfiltfilt(s64, x0))).float().to(dev)
    check.close("B12", ys["sosfiltfilt"], want, "sosfiltfilt against float64", IIR64_RTOL)
    want = torch.from_numpy(np.ascontiguousarray(sps.decimate(x0, 8))).float().to(dev)
    check.close("B12", ys["decimate"], want, "decimate(ftype='iir') against float64", IIR64_RTOL)
    for key in ("auto", "dc_block", "agc", "sosfiltfilt", "decimate"):
        if not bool(torch.isfinite(ys[key]).all()):
            raise AssertionError(f"{key}: non-finite output")
    # the served stream against one-shot sosfilt of the concatenated stream
    planar = torch.from_numpy(wav.reshape(-1, 2).T.astype(np.float32)).to(dev)
    one = torch.round(iir.sosfilt(sos, planar).T.reshape(-1)).clamp_(-32768, 32767)
    diff = np.abs(served.astype(np.int64) - one.to(torch.int16).cpu().numpy().astype(np.int64))
    if written != wav.size or diff.max() > 1 or (diff > 0).mean() >= 2e-3:
        raise AssertionError(
            f"served {written} of {wav.size} samples; max diff {diff.max()} LSB on "
            f"{(diff > 0).mean():.2e} of samples (rule: 1 LSB on < 0.2%)"
        )
    print(
        f"[4 IIR] 16 x 2^22, butter(8, 0.1): sosfilt (B12), pallas (B15), unrolled (B13) within "
        f"{IIR_RTOL} of plain and {IIR64_RTOL} of float64 on channel 0; dc_block and agc (B10) "
        f"within {IIR_RTOL} of the CPU; sosfiltfilt and decimate(8, 'iir') within {IIR64_RTOL} "
        f"of scipy float64; stream_sosfilt {written} samples, {int((diff > 0).sum())} off by "
        "1 LSB from one shot"
    )
    return launches, {"x": x, "paths_wav": (wav, split)}


LFILTER_NONE = "none: no PyTorch call computes an IIR (torchaudio is not installed)"


def lfilter_ms(x: torch.Tensor, b, a) -> float | None:
    """Median device ms of torchaudio's ``lfilter`` (b, a) over x, None where it is not
    installed: the one PyTorch call that computes an IIR, timed as a yardstick only."""
    try:
        import torchaudio.functional as taf
    except ImportError:
        return None
    bt, at = (torch.tensor(np.asarray(v, np.float32), device=x.device) for v in (b, a))
    return statistics.median(device_ms(lambda: taf.lfilter(x, at, bt, clamp=False), 1, 3))


def time_iir(kernel_fn, plain_fn) -> tuple[float, float]:
    """Median device ms: the kernel of 10 after 5 warm-ups, the plain version (thousands
    of small launches) of 3 after 1, in turns plain, kernel, kernel, plain."""
    plain = device_ms(plain_fn, 1, 3)
    kernel = device_ms(kernel_fn, 5, 10) + device_ms(kernel_fn, 5, 10)
    plain += device_ms(plain_fn, 1, 3)
    return statistics.median(kernel), statistics.median(plain)


def phase_iir_times(main: dict) -> dict:
    """The IIR kernels at the main path's shapes, bounds, library call, and the crossover."""
    x = main["x"]
    n = x.numel()
    rows = iir._sos_rows(IIR_SOS)
    s = rows.shape[0]
    st = torch.zeros(s, x.shape[0], 2, device=x.device)
    out = {
        "B10": time_iir(lambda: iir.iir1_block_scan(x, 0.995), lambda: iir._iir1_plain(x, 0.995, 1.0)),
        "B12": time_iir(lambda: iir.sos_cascade(x, rows), lambda: iir._sos_plain(x, rows, None)),
        "B12 seeded": time_iir(lambda: iir.sos_cascade(x, rows, st),
                               lambda: iir._sos_plain(x, rows, st)),
        "B13": time_iir(lambda: iir.sos_cascade_unrolled(x, rows),
                        lambda: iir._sos_plain(x, rows, None)),
        "B15": time_iir(lambda: iir.sos_sections(x, rows), lambda: iir._sections_plain(x, rows, None)),
    }
    copy_dst = torch.empty_like(x)
    copy_ms = statistics.median(device_ms(lambda: copy_dst.copy_(x), 5, 10))
    # bounds: x read once and y written once (B15: once a section); each
    # section's five FMAs a sample, B10's product and FMA
    bounds = {
        "B10": bound(8 * n, 3 * n, FP32_FLOPS_PER_S),
        "B12": bound(8 * n, s * 10 * n, FP32_FLOPS_PER_S),
        "B13": bound(8 * n, s * 10 * n, FP32_FLOPS_PER_S),
        "B15": bound(s * 8 * n, s * 10 * n, FP32_FLOPS_PER_S),
    }
    ms = lfilter_ms(x, *sps.sos2tf(rows.astype(np.float64)))
    library = {"B10": lfilter_ms(x, [1.0, 0.0], [1.0, -0.995]), "B12": ms, "B13": ms, "B15": ms}
    library_note = (LFILTER_NONE if ms is None
                    else f"torchaudio.functional.lfilter (order {s * 2} transfer function)")
    print(f"[5 IIR times] 16 x 2^22 float32, butter(8, 0.1); kernels median of 10 after 5 "
          f"warm-ups, plain 3 after 1; copy of the same bytes {copy_ms:.4f} ms:")
    for name, (ms, plain) in out.items():
        key = name.split()[0]
        b, by = bounds[key]
        print(f"  {name:10s} {ms:.4f} ms = {n / ms / 1e6:.2f} GS/s; plain {plain:.4f} ms; "
              f"bound {b:.4f} ({by}); kernel/bound {ms / b:.2f}")
    print(f"  library: {library_note}"
          + ("" if library["B12"] is None else f": cascade {library['B12']:.4f} ms, "
             f"first order {library['B10']:.4f} ms"))
    # B12 (runtime sections) against B13 (the same pass, sections fixed) and B15, in
    # turns, median (min-max) of 20 after 5 warm-ups, beside their times before B13's
    # redesign and B13's prediction
    runs = {"B12": lambda: iir.sos_cascade(x, rows),
            "B12 seeded": lambda: iir.sos_cascade(x, rows, st),
            "B13": lambda: iir.sos_cascade_unrolled(x, rows),
            "B15": lambda: iir.sos_sections(x, rows)}
    spread = {name: [] for name in runs}
    for name in (*runs, *reversed(runs)):
        spread[name] += device_ms(runs[name], 5, 10)
    for name, d in spread.items():
        med, was = statistics.median(d), IIR_EARLIER_MS[name]
        b = bounds[name.split()[0]][0]
        pred = PREDICTED_MS.get(name)
        print(f"  {name:10s} {med:.4f} ms ({min(d):.4f}-{max(d):.4f}) median (min-max) of 20; "
              f"before {was:.4f} (now/before {med / was:.3f}); kernel/bound {med / b:.2f}"
              + ("" if pred is None else f"; predicted {pred[0]}-{pred[1]}"))
    print(f"  B12 attrs at {iir.lookback_tile(16, IIR_T)}-sample tiles (registers, local bytes, "
          f"shared bytes, blocks an SM): {iir.cascade_kernel_attrs(s)}; B13's "
          f"{iir.cascade_kernel_attrs(s, unrolled=True)}; look-back depth {iir.lookback_depth(s)}")
    # where a call's device time goes: its launches one by one
    for name, fn in (("B12", lambda: iir.sos_cascade(x, rows)),
                     ("B13", lambda: iir.sos_cascade_unrolled(x, rows)),
                     ("B10", lambda: iir.iir1_block_scan(x, 0.995))):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        split = device_rows(prof)
        print(f"  {name} by launch (torch.profiler): "
              + "; ".join(f"{k[:48]} x{c} {ms:.4f} ms" for k, c, ms in split))
    # crossover: the kernels against their plain versions by T, C = 16
    print("[5 IIR crossover] kernel against plain by T, 16 channels, ms (kernel median of 5 "
          "after 2, plain 3 after 1):")
    faster = {"B12": [], "B10": []}
    for t in IIR_CROSSOVER_T:
        xt = x[:, :t].contiguous()
        k12 = statistics.median(device_ms(lambda: iir.sos_cascade(xt, rows), 2, 5))
        p12 = statistics.median(device_ms(lambda: iir._sos_plain(xt, rows, None), 1, 3))
        k10 = statistics.median(device_ms(lambda: iir.iir1_block_scan(xt, 0.995), 2, 5))
        p10 = statistics.median(device_ms(lambda: iir._iir1_plain(xt, 0.995, 1.0), 1, 3))
        faster["B12"].append(k12 < p12)
        faster["B10"].append(k10 < p10)
        print(f"  T={t:8d}: B12 {k12:9.4f} plain {p12:10.4f} ({p12 / k12:8.1f}x); "
              f"B10 {k10:9.4f} plain {p10:10.4f} ({p10 / k10:8.1f}x)")
    for k, fast in faster.items():
        from_t = next((t for i, t in enumerate(IIR_CROSSOVER_T) if all(fast[i:])), None)
        print(f"  {k} faster than plain from T={from_t} on; PALLAS_IIR_MIN_T = {iir.PALLAS_IIR_MIN_T}")
    return {"times": out, "bounds": bounds, "library": library}


def phase_iir_serve(wav: np.ndarray, split: int) -> None:
    """Wall time of stream_sosfilt over phase 4's two WAVs, and its device time by kernel."""
    with tempfile.TemporaryDirectory() as tmp:
        paths = [Path(tmp) / "a.wav", Path(tmp) / "b.wav"]
        write_wav(paths[0], wav[:split], 48000, 2)
        write_wav(paths[1], wav[split:], 48000, 2)

        def serve() -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stream_sosfilt(paths, Path(tmp) / "out.wav", IIR_SOS, chunk_samples=1 << 20,
                           device="cuda")
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        walls = [serve() for _ in range(3)]
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            profiled_ms = serve()
    rows = device_rows(prof)
    device = sum(r[2] for r in rows)
    print(f"[6 IIR serve] stream_sosfilt, {wav.size} samples in chunks of 2^20, butter(8, 0.1): "
          f"wall {', '.join(f'{w:.1f}' for w in walls)} ms; profiled wall {profiled_ms:.1f} ms, "
          f"device {device:.3f} ms, device idle {1 - device / profiled_ms:.3f}")
    for key, count, ms in rows[:8]:
        print(f"  {ms:9.3f} ms  {count:4d} x  {key[:80]}")


def pfb64(src: np.ndarray, raw: bool, n: int, hq: np.ndarray, sign: int, d: int):
    """B19's (raw) and B20's formula in float64 on the host: (re, im), each (M, N)."""
    m = src.size // n if raw else src.shape[0]
    mm, qq = np.meshgrid(np.arange(m), np.arange(n), indexing="ij")
    s64 = src.astype(np.float64)
    v = np.zeros((m, n))
    for r in range(hq.shape[0]):
        mr = mm - d * r
        if raw:
            idx = mr * n - qq
            val = np.where(idx >= 0, s64[np.clip(idx, 0, None)], 0.0)
        else:
            val = np.where(mr >= 0, s64[np.clip(mr, 0, None), qq], 0.0)
        v += hq[r].astype(np.float64) * val
    y = np.fft.fft(v, axis=1)
    return y.real, -sign * y.imag


def pfb_plain(src: torch.Tensor, raw: bool, n: int, hq: torch.Tensor, sign: int, d: int,
              layout: str = "rows"):
    """The plain version of B19 (raw) or B20 on the same inputs, in ``layout``."""
    out = chz._pfb_plain(chz.commutate(src, n) if raw else src, hq, sign, d, layout)
    return out if layout == "complex" else tuple(o.contiguous() for o in out)


def farrow64(x: torch.Tensor, up: int, down: int, m_out: int) -> np.ndarray:
    """The exact schedule and the cubic Lagrange stencil in float64 on the host."""
    x64 = x.double().cpu().numpy()
    ext = np.concatenate([np.zeros((x64.shape[0], 4)), x64], axis=1)
    num = 4 * up + np.arange(m_out, dtype=np.int64) * down
    n = num // up
    mu = (num % up).astype(np.float64) / up
    g = [ext[:, n - 1 + j] for j in range(4)]
    return (-mu * (mu - 1) * (mu - 2) / 6 * g[0] + (mu - 1) * (mu + 1) * (mu - 2) / 2 * g[1]
            - mu * (mu + 1) * (mu - 2) / 2 * g[2] + mu * (mu + 1) * (mu - 1) / 6 * g[3])


def pfb_geometry_line(g) -> str:
    return (f"{g.rows}, {g.lookback}, {g.prefetch}, {int(g.interleave)}, {g.steps}, {g.blocks}, "
            f"{g.smem_bytes}")


def lookback_direct_attrs_lines() -> list[str]:
    """B12's and B13's compiler record by sections at the IIR main path's tile, B5's by
    window, and B1's by channels at k=1024 and at the largest window it takes."""
    tile = iir.lookback_tile(16, IIR_T)
    lines = [f"  B12 sos_lookback_kernel, tile {tile} (registers, local bytes, shared bytes, "
             "blocks an SM) by sections: " + ", ".join(
                 f"S={s} {iir.cascade_kernel_attrs(s, tile)}" for s in (1, 4, 5, 8, 16))]
    lines.append("  B13 sos_lookback_kernel<NS> (the same four) by sections: " + ", ".join(
        f"S={s} {iir.cascade_kernel_attrs(s, tile, unrolled=True)}"
        for s in range(1, iir.MAX_UNROLLED + 1)))
    lines.append("  B1 (the same four) by channels: " + ", ".join(
        f"C={c} k=1024 {ps.windowed_kernel_attrs(1024, c)} k={k} {ps.windowed_kernel_attrs(k, c)}"
        for c in (1, 2, 3, 16)
        for k in (largest_window(lambda w, c=c: ps.windowed_supported(w, c)),)))
    lines.append("  B5 direct_kernel (the same four) by window and channels: " + ", ".join(
        f"k={k} C={c} {pd.direct_kernel_attrs(k, c)}" for k in (1, 15, 64, 256) for c in (1, 2, 3)))
    return lines


def pfb_attrs_lines() -> list[str]:
    """B19's and B20's compiler record by plan (8 taps a phase at dilation 1)."""
    b19 = "; ".join(f"n={n} {chz.pfb_kernel_attrs('B19', n)}" for n in (32, 64, 128, 256, 512, 1024))
    b20 = "; ".join(f"n={n} {chz.pfb_kernel_attrs('B20', n)}" for n in PFB_PLAN_NS)
    return [f"  B19 by plan (registers, local bytes, shared bytes, blocks an SM, threads): {b19}",
            f"  B20 by plan (the same): {b20}"]


def phase_pfb_corners(rng, dev, check: Checker) -> None:
    """B19, B20 and B21 against their plain versions and float64 at their corners."""
    def planes(kernel: str, got, want, want64, label: str) -> None:
        scale = torch.tensor([max(w.abs().max().item() for w in want)])
        for g, w, w64 in zip(got, want, want64):
            check.close(kernel, g, w, f"{label} against plain", PFB_RTOL, scale)
            w64t = torch.from_numpy(w64).float().to(dev)
            check.close(kernel, g, w64t, f"{label} against float64", PFB_RTOL, scale)

    def pair(kernel: str, src: np.ndarray, n: int, hq: np.ndarray, sign: int, d: int, label: str):
        raw = kernel == "B19"
        s, h = torch.from_numpy(src).to(dev), torch.from_numpy(hq).to(dev)
        if raw:
            got = chz.fused_pfb_raw(s, n, h, dilation=d)
        else:
            got = chz.fused_branch_dft(s, h, sign=sign, dilation=d)
        planes(kernel, got, pfb_plain(s, raw, n, h, sign, d), pfb64(src, raw, n, hq, sign, d), label)
        layout = "complex" if raw else "channels"
        fn = chz.fused_pfb_raw if raw else chz.fused_branch_dft
        args = (s, n, h) if raw else (s, h)
        got = fn(*args, sign=sign, dilation=d, layout=layout)
        want = pfb_plain(s, raw, n, h, sign, d, layout)
        if raw:
            got, want = (torch.view_as_real(got),), (torch.view_as_real(want),)
        scale = torch.tensor([max(w.abs().max().item() for w in want)])
        for g, w in zip(got, want):  # both planes, against the larger of them
            check.close(kernel, g, w, f"{label} {layout}", PFB_RTOL, scale)

    for n in (32, 48, 64, 96, 128, 256, 512, 1024):
        rows, step = chz.pfb_rows(n), max(1, 128 // n)
        for p, d in ((2, 1), (2, 2), (8, 1), (8, 2), (16, 1), (16, 2)):
            hq = (rng.standard_normal((p, n)) / np.sqrt(p)).astype(np.float32)
            sign = 1 if d == 1 else -1
            # whole blocks, a ragged last block, a stream shorter than the look-back
            for m in sorted({2 * rows, 2 * rows + step, step}):
                if chz.raw_envelope(m * n, n):
                    x = rng.standard_normal(m * n, dtype=np.float32)
                    pair("B19", x, n, hq, 1, d, f"B19 n={n} P={p} d={d} M={m}")
                u = rng.standard_normal((m, n), dtype=np.float32)
                pair("B20", u, n, hq, sign, d, f"B20 n={n} P={p} d={d} sign={sign} M={m}")
    # every plan of B20 (and the direct DFT's 1 and 7) at 16 taps and dilation 2, a
    # look-back of 30 rows (longer than a step from n = 512 on, and cut to fit shared
    # memory at the largest n), a ragged last step, an impulse at a step edge
    for n in PFB_PLAN_NS:
        rows = chz.pfb_rows(n)
        hq = (rng.standard_normal((16, n)) / 4).astype(np.float32)
        u = rng.standard_normal((2 * rows + 3, n), dtype=np.float32)
        u[rows - 1, n // 2] = 30.0
        pair("B20", u, n, hq, -1, 2, f"B20 plan n={n} P=16 d=2 M={2 * rows + 3}")
    # runs of several steps a block: impulses on both sides of a step edge and of a run
    # edge, against plain and float64
    for kernel, n, d in (("B19", 64, 1), ("B19", 1024, 1), ("B20", 48, 1), ("B20", 64, 2)):
        g = chz.pfb_geometry(n, 8, d, kernel == "B19", 1)
        m = (chz.PFB_BLOCKS + 1) * g.rows + 2  # B19's stream a multiple of 128 samples
        g = chz.pfb_geometry(n, 8, d, kernel == "B19", m)
        run = g.steps * g.rows
        hq = (rng.standard_normal((8, n)) / np.sqrt(8)).astype(np.float32)
        if kernel == "B19":
            x = rng.standard_normal(m * n, dtype=np.float32)
            for edge in (g.rows, run, 2 * run + g.rows):
                x[edge * n - 1] = x[edge * n] = 25.0
            pair("B19", x, n, hq, 1, d,
                 f"B19 run n={n} M={m} ({g.steps} steps of {g.rows} rows a block)")
        else:
            u = rng.standard_normal((m, n), dtype=np.float32)
            for edge in (g.rows, run, 2 * run + g.rows):
                u[edge - 1 : edge + 1, n // 3] = 25.0
            pair("B20", u, n, hq, 1, d,
                 f"B20 run n={n} d={d} M={m} ({g.steps} steps of {g.rows} rows a block)")
    # zeros stay zero; impulses on both sides of a block edge
    n, rows = 64, chz.pfb_rows(64)
    hq = rng.standard_normal((8, n), dtype=np.float32)
    zero = chz.fused_pfb_raw(torch.zeros(n * 4 * rows, device=dev), n, torch.from_numpy(hq).to(dev))
    zb = chz.fused_branch_dft(torch.zeros(4 * rows, 48, device=dev), torch.ones(8, 48, device=dev))
    torch.cuda.synchronize()
    if any(torch.count_nonzero(z).item() for z in (*zero, *zb)):
        raise AssertionError("a zero input gave a nonzero PFB output")
    for edge in (rows * n - 1, rows * n):
        x = np.zeros(n * 4 * rows, np.float32)
        x[edge] = 1.0
        pair("B19", x, n, hq, 1, 1, f"B19 impulse at sample {edge}")
    # B21 over the rates, channels and lengths
    for rate in FARROW_RATES:
        up, down = fw.as_rational_rate(rate)
        for c in (1, 2, 16):
            for t in (4, 5, 100, 1 << 20):
                x = torch.from_numpy(rng.standard_normal((c, t), dtype=np.float32)).to(dev)
                m_out = fw.farrow_output_len(t, (up, down))
                y = fw.resample_farrow_segmented(x, (up, down))
                label = f"B21 {up}/{down} C={c} T={t}"
                check.close("B21", y, fw.segmented_plain(x, up, down, m_out), f"{label} against plain",
                            FARROW_RTOL)
                k = c if t < (1 << 20) else 1  # float64: every channel, or the first on long streams
                want = torch.from_numpy(farrow64(x[:k], up, down, m_out)).float().to(dev)
                check.close("B21", y[:k], want, f"{label} against float64", FARROW_RTOL)
    # the matmul spellings (Farrow's phase matrix, the composed bank's DFT) stay IEEE
    # float32 when the caller has turned TF32 on: their error against float64 stays
    # far below TF32's 10 mantissa bits
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        x = torch.from_numpy(rng.standard_normal((16, 1 << 16), dtype=np.float32)).to(dev)
        up, down = CHAIN_RATE
        y = fw.resample_farrow(x, CHAIN_RATE, method="matmul")
        want = farrow64(x, up, down, y.shape[1])
        ferr = np.abs(y.double().cpu().numpy() - want).max() / np.abs(want).max()
        s = rng.standard_normal(64 * 4096, dtype=np.float32)
        hq = chz.design_prototype(64, 8).reshape(8, 64)
        got = pfb_channelize(torch.from_numpy(s).to(dev), 64, method="composed")
        re, im = pfb64(s, True, 64, hq, 1, 1)
        want = (re + 1j * im).T
        perr = np.abs(got.cpu().numpy() - want).max() / np.abs(want).max()
    finally:
        torch.set_float32_matmul_precision(saved)
    if not (ferr < FARROW_RTOL and perr < PFB_RTOL):
        raise AssertionError(f"a matmul spelling ran in TF32: Farrow {ferr:.2e}, PFB {perr:.2e}")
    print(
        "[3 PFB/Farrow corners] n {32, 48, 64, 96, 128, 256, 512, 1024} (B19 inside its envelope), "
        "P {2, 8, 16}, d {1, 2} (B20 sign -1 at d=2), whole and ragged steps and streams shorter "
        "than the look-back, the three layouts, zeros exact, impulses at a step edge; B20 at every "
        "plan (n = 2..8192, 3..6144, and the direct DFT's 1 and 7) at P=16, d=2; runs of several "
        "steps a block (B19 n=64, 1024; B20 n=48, 64 d=2) with impulses at step and run edges: B19 "
        f"{check.count['B19']} and B20 {check.count['B20']} checks within {PFB_RTOL} of plain and "
        f"float64 (x max|Y|); B21 rates {[fw.as_rational_rate(r) for r in FARROW_RATES]}, C {{1, 2, "
        f"16}}, T {{4, 5, 100, 2^20}}: {check.count['B21']} checks within {FARROW_RTOL} of plain and "
        "float64; max abs error " + ", ".join(f"{k} {check.max_err[k]:.3e}" for k in PFB_KERNELS)
        + f"; with TF32 turned on by the caller the Farrow matmul's relative error against float64 "
        f"{ferr:.2e} and the composed bank's {perr:.2e} (IEEE float32)"
    )


def fm_wideband(dev, t: int, n: int) -> torch.Tensor:
    """A real wideband stream: FM tones centred on channels WIDE_TONES of an n-channel
    bank (message 0.002 * (1 + j/4) cycles a sample, deviation 0.1/n cycles a sample,
    tests/test_wideband.py's tone), plus Gaussian noise of 0.01 drawn on the card from
    seed 0."""
    idx = torch.arange(t, dtype=torch.float64, device=dev)
    x = torch.zeros(t, dtype=torch.float64, device=dev)
    for j, k in enumerate(WIDE_TONES):
        msg = torch.sin(2 * np.pi * 0.002 * (1 + j / 4) * idx)
        dphi = (0.1 / n) * 2 * np.pi * torch.cumsum(msg, 0)
        x += torch.cos(2 * np.pi * torch.remainder(k / n * idx, 1.0) + dphi)
    gen = torch.Generator(device=dev).manual_seed(0)
    return (x / len(WIDE_TONES)).float() + 0.01 * torch.randn(t, device=dev, generator=gen)


def farrow_route(up: int, down: int) -> str:
    """The route ``resample_farrow``'s ``auto`` takes on the card."""
    return "matmul" if up * down <= fw.MATMUL_MAX_PRODUCT_CUDA else "segmented"


def phase_wideband_main(dev, check: Checker, chain_main: dict) -> tuple[dict, dict]:
    """The wideband receiver, the oversampled bank and the Farrow stage through their
    entry points at full size, counts reset around."""
    x = fm_wideband(dev, WIDE_T, 64)
    x48 = x[: 48 * (WIDE_T // 64)]
    proto = chz.design_prototype(64, 8)
    i, q = chain_main["i"], chain_main["q"]
    rx64 = WidebandFmReceiver(WidebandConfig(), device=dev)
    rx1024 = WidebandFmReceiver(WidebandConfig(n_channels=1024), device=dev)
    locked = DspChain(ChainConfig(channels=16, decimation=8, audio_resample=CHAIN_RATE), device=dev)
    torch.cuda.synchronize()
    routes, ys = {}, {}
    reset_launch_counts()
    ys["rx64"] = rx64(x)
    routes["rx64"] = last_choice("pfb_channelize")
    ys["rx1024"] = rx1024(x)
    routes["rx1024"] = last_choice("pfb_channelize")
    ys["planes1024"] = rx1024.channelize(x)
    ys["one_shot"] = pfb_channelize(x, 64)
    state, chunks = pfb_stream_init(64, device=dev), []
    for part in range(8):
        state, y = pfb_channelize_chunk(state, x[part * WIDE_T // 8 : (part + 1) * WIDE_T // 8], 64)
        chunks.append(y)
    routes["chunks"] = last_choice("pfb_channelize")
    ys["os"] = pfb_analyze_os(x, 64, proto)
    ys["os_synth"] = pfb_synthesize_os(*ys["os"], 64, proto * 32)
    ys["fused48"] = pfb_channelize(x48, 48, method="fused")
    routes["fused48"] = last_choice("pfb_channelize")
    ys["locked"] = locked.forward_planar(i, q)
    routes["locked"] = last_choice("resample_farrow")
    ys["farrow"] = fw.resample_farrow(i, FARROW_MAIN_RATE)
    routes["farrow"] = last_choice("resample_farrow")
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"[4 wideband] routes {routes}; launches {launches}")
    want_routes = {"rx64": "fused_raw", "rx1024": "fused_raw", "chunks": "fused_raw",
                   "fused48": "fused", "locked": farrow_route(*CHAIN_RATE),
                   "farrow": farrow_route(*FARROW_MAIN_RATE)}
    if routes != want_routes:
        raise AssertionError(f"routes {routes}; want {want_routes}")
    if min(launches[k] for k in PFB_KERNELS) < 1:
        raise AssertionError(f"the wideband main path never launched one of {PFB_KERNELS}: {launches}")
    # the receivers against the same receivers on the CPU, on the whole stream
    xc = x.cpu()
    cpu64 = WidebandFmReceiver(WidebandConfig(), device="cpu")
    want = cpu64(xc).numpy()
    got = ys["rx64"].cpu().numpy()
    if got.shape != (64, WIDE_T // 64) or not np.isfinite(got).all():
        raise AssertionError(f"receiver: shape {got.shape} or non-finite output")
    r = cpu64.config.taps_per_phase + cpu64.config.audio_taps
    live = np.flatnonzero(np.abs(want[:, r:]).max(axis=1) > 0)
    tones = {k for k in WIDE_TONES} | {64 - k for k in WIDE_TONES}
    if not np.array_equal(live, np.flatnonzero(np.abs(got[:, r:]).max(axis=1) > 0)):
        raise AssertionError("the receiver's squelch gates differ from the CPU's")
    if set(live.tolist()) != tones:
        raise AssertionError(f"live channels {live.tolist()}, want the tones {sorted(tones)}")
    np.testing.assert_allclose(got[:, r:], want[:, r:], rtol=1e-3, atol=1e-4)
    wide = ys["rx1024"]
    if wide.shape != (1024, WIDE_T // 1024) or not bool(torch.isfinite(wide).all()):
        raise AssertionError(f"1024 channels: shape {tuple(wide.shape)} or non-finite output")
    ci, cq = WidebandFmReceiver(WidebandConfig(n_channels=1024), device="cpu").channelize(xc)
    check.close("B19", ys["planes1024"][0].cpu(), ci, "1024-channel I against the CPU")
    check.close("B19", ys["planes1024"][1].cpu(), cq, "1024-channel Q against the CPU")
    # the one shot against its plain version; the chunks against one shot
    hq = rx64.prototype.view(8, 64)
    check.close("B19", torch.view_as_real(ys["one_shot"]),
                torch.view_as_real(pfb_plain(x, True, 64, hq, 1, 1, "complex")), "one shot 2^26 against plain")
    check.close("B19", torch.view_as_real(torch.cat(chunks, 1)), torch.view_as_real(ys["one_shot"]),
                "8 chunks against one shot")
    # the oversampled bank is causal: its first columns are the CPU's on a prefix
    pre = 1 << 16
    yi, yq = pfb_analyze_os(xc[:pre], 64, proto)
    s = pre // 32
    check.close("B20", ys["os"][0][:, :s].cpu(), yi, "pfb_analyze_os I against the CPU on 2^16")
    check.close("B20", ys["os"][1][:, :s].cpu(), yq, "pfb_analyze_os Q against the CPU on 2^16")
    syn = pfb_synthesize_os(yi, yq, 64, proto * 32)
    err = (ys["os_synth"][:pre].cpu() - syn).abs().max().item()
    if ys["os_synth"].shape != (WIDE_T,) or not err <= 1e-4 * syn.abs().max().item():
        raise AssertionError(f"pfb_synthesize_os: shape {tuple(ys['os_synth'].shape)}, error {err:.3e}")
    hq48 = chz._phase_taps(None, 48, dev)
    check.close("B20", torch.view_as_real(ys["fused48"]),
                torch.view_as_real(pfb_plain(chz.commutate(x48, 48), False, 48, hq48, 1, 1, "complex")),
                "fused n=48 on 48 x 2^20 against plain")
    # the locked chain against the CPU over the first 2^16 samples; B21 at 16 x 2^22
    cpu = DspChain(locked.config, device="cpu").forward_planar(i[:, :pre].cpu(), q[:, :pre].cpu())
    r = (257 + 64) // 8 + 63
    np.testing.assert_allclose(ys["locked"][:, r : cpu.shape[1]].cpu().numpy(), cpu[:, r:].numpy(),
                               rtol=1e-3, atol=1e-4)
    if ys["locked"].shape != (16, fw.farrow_output_len(CHAIN_T // 8, CHAIN_RATE)):
        raise AssertionError(f"locked chain: shape {tuple(ys['locked'].shape)}")
    up, down = FARROW_MAIN_RATE
    m_out = fw.farrow_output_len(CHAIN_T, FARROW_MAIN_RATE)
    check.close("B21", ys["farrow"], fw.segmented_plain(i, up, down, m_out), "16 x 2^22 against plain",
                FARROW_RTOL)
    want = torch.from_numpy(farrow64(i[:1, :8192], up, down, 4096)).float().to(dev)
    check.close("B21", ys["farrow"][:1, :4096], want, "16 x 2^22 against float64", FARROW_RTOL)
    print(
        f"[4 wideband] 2^26 samples, FM tones on channels {WIDE_TONES} of 64: the receiver within "
        "rtol 1e-3 / atol 1e-4 of the receiver on the CPU, the same squelch gates (the tones and "
        f"their images live); at 1024 channels finite, its planes within {PFB_RTOL} of the CPU's; "
        f"one shot within {PFB_RTOL} of plain and 8 chunks of one shot; pfb_analyze_os (B20, d=2) "
        "and its synthesis against the CPU on 2^16; n=48 fused (B20) against plain; the chain "
        f"locked to {CHAIN_RATE} on 16 x 2^22 within rtol 1e-3 of the CPU's; resample_farrow "
        f"{FARROW_MAIN_RATE} on 16 x 2^22 (B21) within {FARROW_RTOL} of plain and float64"
    )
    return launches, {"x": x, "x48": x48, "rx64": rx64, "rx1024": rx1024, "i": i}


def phase_wideband_times(main: dict) -> dict:
    """B19, B20 and B21 at the main path's shapes, and B21 against the matmul route."""
    x, dev = main["x"], main["x"].device
    t = x.numel()

    def fft_flops(rows: int, n: int) -> float:
        return rows * 5 * n * np.log2(n)  # a complex n-point FFT's nominal count

    out = {}
    # 1024 channels twice: the first port's time there moved 28% between two calls
    for key, n, rx, layout in (("B19 n=64", 64, main["rx64"], "channels"),
                               ("B19 n=64 complex", 64, main["rx64"], "complex"),
                               ("B19 n=1024", 1024, main["rx1024"], "channels"),
                               ("B19 n=1024 again", 1024, main["rx1024"], "channels")):
        hq = rx.prototype.view(-1, n)
        ms, lo, hi, plain = time_spread(lambda: chz.fused_pfb_raw(x, n, hq, layout=layout),
                                        lambda: pfb_plain(x, True, n, hq, 1, 1, layout))
        v = torch.randn(t // n, n, device=dev)
        fft = statistics.median(device_ms(lambda: torch.fft.fft(v), 2, 5))
        flops = fft_flops(t // n, n) + 2 * hq.shape[0] * t
        out[key] = {"ms": ms, "lo": lo, "hi": hi, "plain": plain, "fft": fft,
                    "bound": bound(12 * t, flops, FP32_FLOPS_PER_S)}
    # B19 by taps a phase at both widths: what each look-back row costs
    by_taps = {}
    for n in (64, 1024):
        for p in PFB_SWEEP_TAPS:
            hq = torch.randn(p, n, device=dev)
            by_taps[n, p] = statistics.median(
                device_ms(lambda: chz.fused_pfb_raw(x, n, hq, layout="channels"), 5, 10))
    # B20: pfb_analyze_os's commutated (2^21, 64) tensor at dilation 2; the n=48 fused route
    hq = torch.from_numpy(chz.design_prototype(64, 8)).to(dev).view(8, 64)
    w = torch.randn(t // 32, 64, device=dev)
    ms, lo, hi, plain = time_spread(lambda: chz.fused_branch_dft(w, hq, dilation=2, layout="channels"),
                                    lambda: pfb_plain(w, False, 64, hq, 1, 2, "channels"))
    out["B20 os"] = {"ms": ms, "lo": lo, "hi": hi, "plain": plain, "bound": bound(
        12 * w.numel(), fft_flops(t // 32, 64) + 16 * w.numel(), FP32_FLOPS_PER_S)}
    u48 = chz.commutate(main["x48"], 48)
    hq48 = chz._phase_taps(None, 48, dev)
    ms, lo, hi, plain = time_spread(lambda: chz.fused_branch_dft(u48, hq48, layout="complex"),
                                    lambda: pfb_plain(u48, False, 48, hq48, 1, 1, "complex"))
    out["B20 n=48"] = {"ms": ms, "lo": lo, "hi": hi, "plain": plain, "bound": bound(
        12 * u48.numel(), fft_flops(u48.shape[0], 48) + 16 * u48.numel(), FP32_FLOPS_PER_S)}
    # B21 beyond the matrix envelope at 16 x 2^22: x read once, y written once
    xi = main["i"]
    up, down = FARROW_MAIN_RATE
    m_out = fw.farrow_output_len(CHAIN_T, FARROW_MAIN_RATE)
    ms, plain = time_pair(lambda: fw.resample_farrow_segmented(xi, FARROW_MAIN_RATE),
                          lambda: fw.segmented_plain(xi, up, down, m_out))
    out["B21"] = {"ms": ms, "plain": plain,
                  "bound": bound(4 * xi.numel() + 4 * 16 * m_out, 20 * 16 * m_out, FP32_FLOPS_PER_S)}
    print("[5 wideband times] device ms: B19/B20 median (min-max) of 20 after 5 warm-ups, plain "
          "median of 6; B21 median of 20 (plain 20); torch.fft.fft median of 5 after 2:")
    for name, v in out.items():
        extra = f"; torch.fft.fft of the (M, N) rows alone {v['fft']:.4f}" if "fft" in v else ""
        spread = f" ({v['lo']:.4f}-{v['hi']:.4f})" if "lo" in v else ""
        first = PFB_FIRST_MS.get(name.replace(" again", ""))
        was = f"; first port {first:.4f}" if first else ""
        print(f"  {name:16s} {v['ms']:.4f} ms{spread}{was}; plain {v['plain']:.4f}; bound "
              f"{v['bound'][0]:.4f} ({v['bound'][1]}); kernel/bound {v['ms'] / v['bound'][0]:.2f}{extra}")
    print("  B19/B20 geometry (rows a step, look-back rows, prefetch, interleaved, steps a block, "
          "blocks, shared bytes): " + "; ".join(
              f"{k} {pfb_geometry_line(g)}" for k, g in (
                  ("B19 n=64", chz.pfb_geometry(64, 8, 1, True, t // 64, "channels")),
                  ("B19 n=64 complex", chz.pfb_geometry(64, 8, 1, True, t // 64, "complex")),
                  ("B19 n=1024", chz.pfb_geometry(1024, 8, 1, True, t // 1024, "channels")),
                  ("B20 os", chz.pfb_geometry(64, 8, 2, False, t // 32, "channels")),
                  ("B20 n=48", chz.pfb_geometry(48, 8, 1, False, u48.shape[0], "complex")))))
    for n in (64, 1024):
        print(f"  B19 n={n} by taps a phase: " + ", ".join(
            f"P={p} {by_taps[n, p]:.4f} ms" for p in PFB_SWEEP_TAPS))
    # B21 against the matmul route at the chain's audio shape and at 16 x 2^22
    print("[5 Farrow routes] B21 (segmented) against matmul, device ms (median of 10 after 5):")
    faster = []
    for rate in FARROW_AB_RATES:
        for cols in (CHAIN_T // 8, CHAIN_T):
            xs = xi[:, :cols].contiguous()
            seg, mat = time_pair(lambda: fw.resample_farrow(xs, rate, method="segmented"),
                                 lambda: fw.resample_farrow(xs, rate, method="matmul"))
            if seg < mat:
                faster.append((rate, cols))
            print(f"  {rate[0]}/{rate[1]} 16 x {cols}: segmented {seg:.4f}, matmul {mat:.4f}, "
                  f"matmul/segmented {mat / seg:.2f}")
    print(f"  segmented faster at {faster}; on the card auto takes matmul while up*down <= "
          f"{fw.MATMUL_MAX_PRODUCT_CUDA} (MATMUL_MAX_PRODUCT_CUDA), else segmented")
    return out


def phase_wideband_profile(main: dict) -> None:
    """The wideband receiver's wall time, and its device time by stage under torch.profiler."""
    rx, x = main["rx64"], main["x"]
    cfg = rx.config

    def forward() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rx(x)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    forward()
    walls = [forward() for _ in range(3)]
    wall, device, rows = profiled(lambda: rx(x))
    print(
        f"[7 wideband] 64 channels, 2^26 samples: wall {', '.join(f'{w:.2f}' for w in walls)} ms; "
        f"profiled wall {wall:.2f} ms, device {device:.3f} ms, device idle {1 - device / wall:.3f}"
    )
    i, q = rx.channelize(x)
    audio = fm_demodulate(torch.complex(i, q), gain=cfg.fm_gain)
    filtered = fir.fir_direct(audio, rx.audio_taps)
    stages = {
        "channelize": lambda: rx.channelize(x),
        "FM demod": lambda: fm_demodulate(torch.complex(i, q), gain=cfg.fm_gain),
        "audio FIR": lambda: fir.fir_direct(audio, rx.audio_taps),
        "squelch": lambda: rx.squelch(filtered, i, q),
    }
    profile_stages(stages, "wideband")
    if not any(r[0].startswith("void dsp::pfb::") for r in rows):
        raise AssertionError("the wideband receiver's profile recorded no PFB kernel")
    for key, count, ms in rows[:8]:
        print(f"  {ms:9.3f} ms  {count:4d} x  {key[:80]}")
    print(f"  the profiler lost at most {profiled.lost} lead records a profile in phase 7 "
          f"(leads tried: {PROFILE_LEADS[0][0]} kernels, then more after a pause)")


def tv_schedule(rng, sections: int, coef_channels: int, rows: int, a0: float = 1.25) -> np.ndarray:
    """Swept resonators (S, Cc, rows, 6) float32: poles of radius 0.1-0.9, zeros near
    DC and Nyquist, a peak gain about 1 (b = (1 - r^2)/2), every row scaled by a0 != 1."""
    f = np.linspace(0, 3, rows)
    out = np.empty((sections, coef_channels, rows, 6), np.float32)
    for k in range(sections):
        for c in range(coef_channels):
            ph = rng.uniform(0, 6)
            r = 0.5 + 0.4 * np.sin(f + ph)
            th = 0.3 + 0.2 * np.cos(2 * f + ph)
            g = (1 - r * r) / 2
            out[k, c] = np.stack([g, 0.2 * g * np.sin(5 * f + ph), -g, np.ones(rows),
                                  -2 * r * np.cos(th), r * r], -1) * a0
    return out


def swept_rows(dev, sections: int, t: int, depth: float = 0.4) -> torch.Tensor:
    """The main path's per-sample rows (S, 1, T, 6) on the card, made there: the JAX
    package's swept schedule (tests/test_iir_tv.py: radius 0.5 -/+ depth, 0.1-0.9 at
    its 0.4; angle 0.1-0.5), its resonators scaled to a peak gain about 1
    (b = (1 - r^2)/2), a0 = 1.25."""
    u = torch.linspace(0, 3, t, device=dev, dtype=torch.float64)
    rows = []
    for k in range(sections):
        r = 0.5 + depth * torch.sin(u + 1.5 * k)
        th = 0.3 + 0.2 * torch.cos(2 * u + 1.5 * k)
        g = (1 - r * r) / 2
        rows.append(1.25 * torch.stack(
            [g, 0.2 * g * torch.sin(5 * u + k), -g, torch.ones_like(u), -2 * r * torch.cos(th),
             r * r], -1,
        ))
    return torch.stack(rows)[:, None].float().contiguous()


def tv64(x: torch.Tensor, rows4: torch.Tensor, frame_len: int = 1,
         state: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The time-varying cascade in float64 on the host, one sample a step: (y, end state
    (S, C, 2)), float32 on x's device. The rows are divided by their a0 in float32 as
    the kernels divide them (a reciprocal, then products), so the comparison holds the
    recurrence and not the rounding of the coefficients, which moves a resonant
    section's output by more than the recurrence does."""
    xs = x.double().cpu().numpy()
    r = rows4.float().cpu().numpy()
    r = (r[..., [0, 1, 2, 4, 5]] * (np.float32(1) / r[..., 3:4])).astype(np.float64)
    c, t = xs.shape
    s = r.shape[0]
    st = np.zeros((s, c, 2)) if state is None else state.double().cpu().numpy().copy()
    y = np.empty_like(xs)
    for j in range(t):
        u = xs[:, j]
        f = j // frame_len
        for k in range(s):
            b0, b1, b2, a1, a2 = r[k, :, f].T
            yo = b0 * u + st[k, :, 0]
            st[k, :, 0], st[k, :, 1] = b1 * u - a1 * yo + st[k, :, 1], b2 * u - a2 * yo
            u = yo
        y[:, j] = u
    return torch.from_numpy(y).float().to(x.device), torch.from_numpy(st).float().to(x.device)


def lpc64(a_f: torch.Tensor, s0: torch.Tensor, e: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """B22's recurrence in float64 on the host, vectorised over frames: (y, end state)."""
    a = a_f.double().cpu().numpy()
    h = s0.double().cpu().numpy().copy()
    ev = e.double().cpu().numpy()
    y = np.empty_like(ev)
    for t in range(ev.shape[1]):
        v = ev[:, t] - np.sum(a * h, 1)
        h = np.concatenate([v[:, None], h[:, :-1]], 1)
        y[:, t] = v
    return torch.from_numpy(y).float().to(e.device), torch.from_numpy(h).float().to(e.device)


def phase_tv_corners(rng, dev, check: Checker) -> None:
    """B16, B17, B18 and B22 against their plain versions on the card and float64 sample loops."""
    sub = iir.THREADS * iir.TV_SEG  # a TV kernel block's sub-tile
    tile = iir.pick_tile(64, 100_003)  # the kernel tile at every corner below
    prefix = tile + 77  # float64 over a prefix that crosses the first tile edge (causal)
    ragged = 3 * tile + 77

    def sig(c: int, t: int) -> torch.Tensor:
        return torch.from_numpy(rng.standard_normal((c, t), dtype=np.float32)).to(dev)

    routes = []  # (frame_len, the route B18 took) at each B18 corner

    def hold(kernel: str, fn, c: int, t: int, s: int, shared: bool, frame_len: int = 1) -> None:
        label = f"{kernel} S={s} C={c} T={t} {'shared' if shared else 'per-channel'} rows"
        if kernel == "B18":
            label += f", frame_len {frame_len}"
            iir.tv_frames_cascade.route = None
        x = sig(c, t)
        rows = torch.from_numpy(tv_schedule(rng, s, 1 if shared else c, -(-t // frame_len))).to(dev)
        st = torch.from_numpy((0.3 * rng.standard_normal((s, c, 2))).astype(np.float32)).to(dev)
        y0, none = fn(x, rows, None)
        y, end = fn(x, rows, st)
        yz, _ = fn(x, rows, torch.zeros_like(st))
        if none is not None:
            raise AssertionError(f"{label}: an unseeded call returned an end state")
        if kernel == "B18":
            route = iir.tv_frames_cascade.route
            if route != iir.tv_frames_route(frame_len):
                raise AssertionError(f"{label}: took the {route} route, want "
                                     f"{iir.tv_frames_route(frame_len)}")
            routes.append((frame_len, route))
        # the unseeded launch is the seeded one from zero, bit for bit
        check.close(kernel, y0, yz, f"{label}, unseeded against a zero seed", 0.0)
        yp, endp = iir._tv_plain(x, rows, frame_len, st)
        check.close(kernel, y, yp, f"{label}, seeded, against plain", TV_RTOL)
        check.close(kernel, end, endp, f"{label}, end state against plain", TV_RTOL, yp)
        m = min(t, max(prefix, frame_len + 77 if t > frame_len else 0))
        want, zf = tv64(x[:, :m], rows[:, :, : -(-m // frame_len)], frame_len, st)
        check.close(kernel, y[:, :m], want, f"{label}, seeded, first {m} against float64", TV_RTOL)
        if m == t:
            check.close(kernel, end, zf, f"{label}, end state against float64", TV_RTOL, want)

    b16 = lambda x, r, s: iir.tv_cascade(x, r, s)  # noqa: E731
    for s in (1, 2, 4, 6):
        for c, t, shared in ((1, 1, True), (1, sub - 1, False), (64, ragged, True),
                             (64, 100_003, False)):
            hold("B16", b16, c, t, s, shared)
    for s in (16, 17):  # 17: a group of 16 sections, then one, through device memory
        for c, t, shared in ((1, ragged, True), (64, ragged, False)):
            hold("B16", b16, c, t, s, shared)
    for i, (c, t) in enumerate((c, t) for c in (1, 64) for t in (1, sub - 1, ragged, 100_003)):
        hold("B17", lambda x, r, s: iir.tv_section(x, r, s), c, t, 1, i % 2 == 0)
    # B18 at any frame_len: many frames a sub-tile (100), frames nesting in
    # tiles (256, 1024), a frame over many tiles (65536, H1); on both sides of
    # the state route's condition (a multiple of a warp's span, iir.TV_SPAN):
    # 768 (a multiple of the span and not of a sub-tile, so frame edges fall
    # inside sub-tiles) and 1000 (off it, beside the main path's 1024)
    span = iir.TV_SPAN
    for fl, c, t, s, shared in (
        (100, 1, ragged, 4, True), (100, 64, 2 * tile + 5, 17, False),
        (256, 64, ragged, 2, True), (256, 1, sub - 1, 6, False),
        (3 * span, 64, ragged, 4, True), (3 * span, 5, 2 * tile + 5, 3, False),
        (1000, 64, ragged, 4, True), (1000, 5, 2 * tile + 5, 3, False),
        (1024, 1, 100_003, 4, True), (1024, 64, 1, 1, False),
        (65536, 3, 3 * 65536 + 99, 4, True), (65536, 1, 2 * tile + 5, 16, False),
    ):
        hold("B18", lambda x, r, st, fl=fl: iir.tv_frames_cascade(x, r, fl, st), c, t, s, shared, fl)
    print("[3 TV routes] B18's route at each corner (frame_len: route): "
          + ", ".join(f"{fl}: {route}" for fl, route in routes))
    # frame_len 100 is outside the reference's frames envelope: sosfilt_tv_frames expands (B16)
    x = sig(8, ragged)
    fr = torch.from_numpy(tv_schedule(rng, 3, 1, -(-ragged // 100))[:, 0]).to(dev)
    y = iir.sosfilt_tv_frames(fr, x, 100)
    if last_choice("sosfilt_tv_frames") != "expand":
        raise AssertionError(f"frame_len 100 took {last_choice('sosfilt_tv_frames')}, want expand")
    check.close("B16", y, iir.tv_frames_cascade(x, fr[:, None], 100)[0],
                "sosfilt_tv_frames(frame_len=100) expand against B18", TV_RTOL)
    check.close("B16", y[:, :prefix], tv64(x[:, :prefix], fr[:, None], 100)[0],
                "sosfilt_tv_frames(frame_len=100) against float64", TV_RTOL)
    # impulses across sub-tile and tile edges give the impulse response; zeros stay zero
    t = 2 * tile + 11
    rows = torch.from_numpy(tv_schedule(rng, 4, 1, t)).to(dev)
    x = torch.zeros(4, t, device=dev)
    for c, p in enumerate((0, sub - 1, tile, t - 100)):
        x[c, p] = 1.0
    check.close("B16", iir.tv_cascade(x, rows)[0], tv64(x, rows)[0], "B16 impulses", TV_RTOL)
    zero = torch.zeros_like(x)
    outs = (*iir.tv_cascade(zero, rows, torch.zeros(4, 4, 2, device=dev)),
            iir.tv_section(zero, rows[:1])[0], iir.tv_frames_cascade(zero, rows, 1)[0])
    torch.cuda.synchronize()
    if any(torch.count_nonzero(o).item() for o in outs):
        raise AssertionError("a zero input gave a nonzero time-varying output or state")
    # B22: a thread a frame; bit for bit against its plain version, 1e-5 of float64
    for p in (1, 2, 12, 32, 40):  # 40: past the register instantiations (1..32)
        for length in (8, 33, 100, 256):  # 33: rows off the 16-byte grid; 100: a ragged chunk
            for frames in (129, 1000):
                label = f"B22 p={p} L={length} frames={frames}"
                # sum |a_i| <= 0.9: a stable recurrence whatever the signs
                a_f = torch.from_numpy((0.9 / p * rng.uniform(-1, 1, (frames, p))).astype(np.float32))
                s0 = torch.from_numpy(rng.standard_normal((frames, p), dtype=np.float32))
                e = torch.from_numpy(rng.standard_normal((frames, length), dtype=np.float32))
                a_f, s0, e = a_f.to(dev), s0.to(dev), e.to(dev)
                y, z = lpc.lpc_synth_pass(a_f, s0, e)
                yp, zp = lpc._lpc_pass_plain(a_f, s0, e)
                check.close("B22", y, yp, f"{label} against plain", 0.0)
                check.close("B22", z, zp, f"{label} end state against plain", 0.0)
                check.close("B22", lpc.lpc_synth_state(a_f, s0, e), zp,
                            f"{label} state-only entry against plain", 0.0)
                want, zf = lpc64(a_f, s0, e)
                check.close("B22", y, want, f"{label} against float64", TV_RTOL)
                check.close("B22", z, zf, f"{label} end state against float64", TV_RTOL, want)
    print(
        f"[3 TV/LPC corners] B16 S {{1, 2, 4, 6, 16, 17}}, B17, B18 at frame_len {{100, 256, "
        f"{3 * span}, 1000, 1024, 65536}}; C {{1, 3, 5, 64}}, T {{1, {sub - 1}, {ragged}, "
        f"{2 * tile + 5}, 100003, {3 * 65536 + 99}}}, shared "
        f"and per-channel rows with a0 = 1.25, seeded, unseeded and zero-seeded: "
        + ", ".join(f"{k} {check.count[k]} checks" for k in TV_KERNELS)
        + f" within {TV_RTOL} of plain and of float64 (x max|y|; float64 over the first {prefix} "
        "samples or past the first frame edge); the expand route at frame_len 100, impulses at "
        "sub-tile and tile edges, zeros exact; B22 at p {1, 2, 12, 32, 40}, L {8, 33, 100, 256}, "
        "frames {129, 1000}, full and state-only, bit for bit against plain; max abs error "
        + ", ".join(f"{k} {check.max_err[k]:.3e}" for k in TV_KERNELS)
    )


def colored_noise(rng, streams: int, t: int) -> np.ndarray:
    """AR(2) noise (poles at radius 0.84), the reference's LPC test signal, float32."""
    return sps.lfilter([1.0], [1, -1.2, 0.7], rng.standard_normal((streams, t)), axis=-1).astype(
        np.float32)


def seq_f32(a: np.ndarray, gain: np.ndarray, e: np.ndarray, frame_len: int) -> np.ndarray:
    """The sequential float32 recurrence of one stream (the reference's floor, tests/test_lpc.py)."""
    a, g, e = (np.asarray(v, np.float32) for v in (a, gain, e))
    p = a.shape[-1] - 1
    y = np.zeros(a.shape[0] * frame_len, np.float32)
    hist = np.zeros(p, np.float32)
    for f in range(a.shape[0]):
        for t in range(frame_len):
            i = f * frame_len + t
            v = np.float32(g[f] * e[i] - np.dot(a[f, 1:], hist))
            hist = np.concatenate([[v], hist[:-1]]).astype(np.float32)
            y[i] = v
    return y


def lpc_golden(a: torch.Tensor, gain: torch.Tensor, e: torch.Tensor, frame_len: int) -> np.ndarray:
    """``lpc.lpc_synthesis_ref`` on every stream at once: the sequential recurrence in
    float64 on the host, (B, F * L) from a (B, F, p+1), gain (B, F), e (B, F * L)."""
    a, g, ev = (v.double().cpu().numpy() for v in (a, gain, e))
    b, nf, p1 = a.shape
    y = np.empty((b, nf * frame_len))
    hist = np.zeros((b, p1 - 1))
    for f in range(nf):
        af = a[:, f, 1:]
        ge = g[:, f : f + 1] * ev[:, f * frame_len : (f + 1) * frame_len]
        for j in range(frame_len):
            v = ge[:, j] - (af * hist).sum(1)
            hist[:, 1:] = hist[:, :-1].copy()
            hist[:, 0] = v
            y[:, f * frame_len + j] = v
    return y


def rel64(got: torch.Tensor, want64: torch.Tensor) -> float:
    """max|got - want| / max|want| in float64 on the card."""
    return ((got.double() - want64).abs().max() / want64.abs().max()).item()


def phase_tv_main(rng, dev, check: Checker) -> tuple[dict, dict]:
    """The time-varying IIR family, LPC and the tracking notch through their entry points
    at full size, counts reset around."""
    c, t, s = TV_C, TV_T, TV_S
    x = torch.randn(c, t, device=dev, generator=torch.Generator(dev).manual_seed(1))
    rows = swept_rows(dev, s, t)  # (S, 1, T, 6): 403 MB of per-sample rows
    sos_t = rows[:, 0]  # (S, T, 6), the user's spelling: shared by every channel
    fr = {fl: rows[:, :, fl // 2 :: fl].contiguous() for fl in TV_FRAMES}  # (S, 1, F, 6)
    # eight chunks of any length: one sample, under one reference tile (32768
    # samples), ragged ones; the frame chunks start on frame edges (edges in frames)
    chunk, per = t // 8, t // 8 // 1024
    edges = (0, 1, 1000, chunk + 77, 3 * chunk, 4 * chunk - 5, 5 * chunk, 6 * chunk + 12345, t)
    frame_edges = (0, 1, 30, per + 5, 3 * per, 4 * per - 1, 5 * per, 6 * per + 13, t // 1024)
    # the tracking notch: a swept tone on each channel in white noise
    noise = torch.randn(c, t, device=dev, generator=torch.Generator(dev).manual_seed(2),
                        dtype=torch.float64)
    lo = 0.1 + 0.005 * torch.arange(c, device=dev, dtype=torch.float64)[:, None]
    f_inst = lo + 0.25 * torch.arange(t, device=dev, dtype=torch.float64) / t
    tone = 10.0 * torch.sin(torch.cumsum(np.pi * f_inst, 1))
    xn = (tone + noise).float()
    # LPC: AR(2) noise through the vocoder with an explicit excitation
    nl = LPC_FRAMES * LPC_L
    xv = torch.from_numpy(colored_noise(rng, LPC_STREAMS, nl)).to(dev)
    ev = torch.from_numpy(rng.standard_normal((LPC_STREAMS, nl), dtype=np.float32)).to(dev)
    # resonant frame-constant sets: 4 streams x 64 frames x 128 samples, p = 6
    res = {}
    for radius in LPC_RADII:
        poles = radius * np.exp(1j * np.array([0.4, 1.3, 2.2]))
        row = np.poly(np.concatenate([poles, poles.conj()])).real
        res[radius] = torch.from_numpy(np.tile(row, (4, 64, 1)).astype(np.float32)).to(dev)
    e_res = torch.from_numpy(rng.standard_normal((4, 64 * RES_L), dtype=np.float32)).to(dev)
    g_res = torch.ones(4, 64, device=dev)
    torch.cuda.synchronize()

    ys, routes = {}, {}
    reset_launch_counts()
    ys["auto"] = iir.sosfilt_tv(sos_t, x)
    routes["sosfilt_tv"] = last_choice("sosfilt_tv")
    ys["scan"] = iir.sosfilt_tv(sos_t, x, method="scan")
    routes["sosfilt_tv scan"] = last_choice("sosfilt_tv")
    st = torch.zeros(s, c, 2, device=dev)
    parts = []
    for lo, hi in zip(edges, edges[1:]):
        st, yk = iir.sosfilt_tv_chunk(st, sos_t[:, lo:hi], x[:, lo:hi])
        parts.append(yk)
    ys["chunks"] = torch.cat(parts, 1)
    for fl in TV_FRAMES:
        ys[f"frames{fl}"] = iir.sosfilt_tv_frames(fr[fl][:, 0], x, fl)
        routes[f"sosfilt_tv_frames {fl}"] = last_choice("sosfilt_tv_frames")
    st = torch.zeros(s, c, 2, device=dev)
    parts = []
    for lo, hi in zip(frame_edges, frame_edges[1:]):
        st, yk = iir.sosfilt_tv_frames_chunk(st, fr[1024][:, 0, lo:], x[:, lo * 1024 : hi * 1024],
                                             1024)
        parts.append(yk)
    ys["frames chunks"] = torch.cat(parts, 1)
    ys["notch"], w0 = tracking_notch(xn, 1024, q=30.0)
    routes["tracking_notch"] = last_choice("sosfilt_tv_frames")
    ys["vocoder"] = lpc.lpc_vocoder(xv, LPC_P, LPC_L, excitation=ev)
    routes["lpc_vocoder B22 passes"] = launch_counts()["B22"]  # refine records no choice
    a, gain = lpc.lpc(xv, LPC_P, LPC_L)
    for method in ("pallas", "scan"):
        ys[f"lpc {method}"] = lpc.lpc_synthesis(a, gain, ev, LPC_L, method=method)
    for radius in LPC_RADII:
        ys[f"resonant {radius}"] = lpc.lpc_synthesis(res[radius], g_res, e_res, RES_L)
        routes[f"lpc_synthesis r={radius}"] = last_choice("lpc_synthesis")
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"[4 TV/LPC] routes {routes}; launches {launches}")
    want_routes = {
        "sosfilt_tv": "fused", "sosfilt_tv scan": "scan",
        **{f"sosfilt_tv_frames {fl}": "frames" for fl in TV_FRAMES},
        "tracking_notch": "frames", "lpc_vocoder B22 passes": 3,
        **{f"lpc_synthesis r={radius}": "factored" for radius in LPC_RADII},
    }
    if routes != want_routes:
        raise AssertionError(f"routes {routes}; want {want_routes}")
    # B16 once; B17 a section, then a section a chunk; B18 twice, a chunk, the
    # notch and a resonant set each; B22 three passes (refine) and two (pallas)
    want = {"B16": 1, "B17": s + 8 * s, "B18": len(TV_FRAMES) + 8 + 1 + len(LPC_RADII), "B22": 5}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"TV/LPC main path launches {got}; want {want}")

    # the cascade against plain and against the plain version run in float64 on
    # the same rows (the whole stream); the scan route and the chunks against one shot
    x64 = x.double()
    plain = iir._tv_plain(x, rows, 1, None)[0]
    want64 = iir._tv_plain(x64, rows, 1, None)[0].float()
    rel = {"plain": (plain - want64).abs().max().item() / want64.abs().max().item()}
    check.close("B16", ys["auto"], plain, "sosfilt_tv 16x2^22 against plain", TV_RTOL)
    check.close("B16", ys["auto"], want64, "sosfilt_tv 16x2^22 against float64", TV_RTOL)
    check.close("B17", ys["scan"], want64, "sosfilt_tv scan against float64", TV_RTOL)
    check.close("B17", ys["chunks"], ys["auto"], "sosfilt_tv_chunk x8 (ragged) against one shot",
                TV_RTOL)
    for fl in TV_FRAMES:
        yf = ys[f"frames{fl}"]
        plain = iir._tv_plain(x, fr[fl], fl, None)[0]
        want64 = iir._tv_plain(x64, fr[fl], fl, None)[0].float()
        rel[f"plain {fl}"] = (plain - want64).abs().max().item() / want64.abs().max().item()
        check.close("B18", yf, plain, f"sosfilt_tv_frames({fl}) against plain", TV_RTOL)
        check.close("B18", yf, want64, f"sosfilt_tv_frames({fl}) against float64", TV_RTOL)
    check.close("B18", ys["frames chunks"], ys["frames1024"],
                "sosfilt_tv_frames_chunk x8 (ragged) against one shot", TV_RTOL)
    # high Q: the swept schedule at pole radius up to 0.95 through B16 and through
    # the scan route (B17 a section), and the notch's own rows (q = 30, poles near
    # radius 0.995) through B18, the kernel and plain each against float64 on the
    # same rows. The kernel may not be worse than HIGHQ_FACTOR x plain's own error
    # there (nor than TV_RTOL)
    rows95 = swept_rows(dev, s, t, depth=0.45)
    notch4 = notch_rows(w0, 30.0)[None]  # (1, C, F, 6): t is whole frames
    highq = {}
    for xin, r4, fl, runs in (
        (x, rows95, 1, (("B16 swept r<=0.95", "B16", lambda: iir.tv_cascade(x, rows95)[0]),
                        ("B17 swept r<=0.95 (scan)", "B17",
                         lambda: iir.sosfilt_tv(rows95[:, 0], x, method="scan")))),
        (xn, notch4, 1024, (("B18 notch q=30", "B18", lambda: ys["notch"]),)),
    ):
        want64 = iir._tv_plain(xin.double(), r4, fl, None)[0]
        err_p = rel64(iir._tv_plain(xin, r4, fl, None)[0], want64)
        for key, kernel, run in runs:
            highq[key] = (kernel, rel64(run(), want64), err_p, want64.abs().max().item())
    print("[4 TV high Q] of max|y| from float64: " + "; ".join(
        f"{key}: kernel {k:.3e}, plain {p:.3e}" for key, (_, k, p, _) in highq.items()))
    for key, (kernel, err_k, err_p, scale) in highq.items():
        check.max_err[kernel] = max(check.max_err[kernel], err_k * scale)
        check.count[kernel] += 1
        if not err_k <= max(TV_RTOL, HIGHQ_FACTOR * err_p):
            raise AssertionError(f"{key}: kernel {err_k:.3e} from float64, over {HIGHQ_FACTOR} x "
                                 f"plain's {err_p:.3e} (and {TV_RTOL})")
    del x64, plain, want64, rows95
    # the notch: the reference's rules on every channel, and the CPU on a prefix
    fl = 1024
    centers = f_inst[:, fl // 2 :: fl][:, : w0.shape[1]]
    w_err = (w0.double() - centers).abs().mean(1)
    resid = ((ys["notch"].double() - noise)[:, 2 * fl :] ** 2).mean(1) / (tone**2).mean(1)
    yc = ys["notch"][:, 2 * fl :].double()
    nc = noise[:, 2 * fl :]
    yc, nc = yc - yc.mean(1, keepdim=True), nc - nc.mean(1, keepdim=True)
    corr = (yc * nc).sum(1) / torch.sqrt((yc * yc).sum(1) * (nc * nc).sum(1))
    if not (w_err.max() < 0.004 and resid.max() < 0.05 and corr.min() > 0.8):
        raise AssertionError(f"tracking notch: frequency error {w_err.max().item():.2e} (< 0.004), "
                             f"residual tone {resid.max().item():.3e} (< 0.05), noise correlation "
                             f"{corr.min().item():.3f} (> 0.8)")
    y_cpu, w_cpu = tracking_notch(xn[:2, : 1 << 16].cpu(), fl, q=30.0)
    if not (w0[:2, : w_cpu.shape[1]].cpu() - w_cpu).abs().max().item() < NOTCH_W_TOL:
        raise AssertionError("tracking notch: the card's frequencies differ from the CPU's")
    check.close("B18", ys["notch"][:2, : 1 << 16], y_cpu.to(dev), "tracking_notch against the CPU",
                NOTCH_RTOL)
    # B22 at the main path's shapes, bit for bit against plain: from rest (the
    # first pass of refine and pallas) and seeded with the previous frame's end
    # state (refine's later passes)
    a_f = a[..., 1:].reshape(-1, LPC_P).contiguous()
    e_f = (ev.view(LPC_STREAMS, LPC_FRAMES, LPC_L) * gain[..., None]).reshape(-1, LPC_L).contiguous()
    s0 = torch.zeros_like(a_f)
    for label in ("from rest", "seeded"):
        y, z = lpc.lpc_synth_pass(a_f, s0, e_f)
        yp, zp = lpc._lpc_pass_plain(a_f, s0, e_f)
        what = f"B22 {a_f.shape[0]} frames x {LPC_L}, p {LPC_P}, {label}"
        check.close("B22", y, yp, f"{what}, against plain", 0.0)
        check.close("B22", z, zp, f"{what}, end state against plain", 0.0)
        check.close("B22", lpc.lpc_synth_state(a_f, s0, e_f), zp,
                    f"{what}, state-only entry against plain", 0.0)
        z3 = z.view(LPC_STREAMS, LPC_FRAMES, LPC_P)
        s0 = torch.cat([torch.zeros_like(z3[:, :1]), z3[:, :-1]], 1).reshape(-1, LPC_P)
    del y, yp, z, zp, z3, s0
    # LPC: each method against the float64 golden on every stream
    ref = lpc_golden(a, gain, ev, LPC_L)
    scale = np.abs(ref).max(1)
    lpc_err = {}
    for key in ("vocoder", "lpc pallas", "lpc scan"):
        err = np.abs(ys[key].double().cpu().numpy() - ref).max(1) / scale
        lpc_err[key] = err.max()
    for key in lpc_err:
        if not lpc_err[key] < LPC_RTOL:
            raise AssertionError(f"{key}: error {lpc_err[key]:.3e} against float64 (< {LPC_RTOL})")
    # resonant sets: the factored engine within 64 x the sequential float32 floor
    res_err = {}
    for radius in LPC_RADII:
        y_ref = lpc.lpc_synthesis(res[radius], g_res, e_res, RES_L, method="refine")
        errs = []
        for i in (0, 3):
            a_i, e_i = res[radius][i].cpu().numpy(), e_res[i].cpu().numpy()
            ref = lpc.lpc_synthesis_ref(a_i, np.ones(64), e_i, RES_L)
            scale = np.abs(ref).max()
            fact = np.abs(ys[f"resonant {radius}"][i].double().cpu().numpy() - ref).max() / scale
            seq = np.abs(seq_f32(a_i, np.ones(64), e_i, RES_L) - ref).max() / scale
            refine = np.abs(y_ref[i].double().cpu().numpy() - ref).max() / scale
            errs.append((fact, seq, refine))
            if not fact < max(64 * seq, 1e-5):
                raise AssertionError(f"factored at radius {radius}: error {fact:.3e}, sequential "
                                     f"float32 {seq:.3e} (want < max(64 x, 1e-5))")
            if radius >= 0.98 and not fact < refine / 100:
                raise AssertionError(f"factored at radius {radius}: {fact:.3e}, not 100x under "
                                     f"refine's {refine:.3e}")
        res_err[radius] = max(errs)
    for key, v in ys.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{key}: non-finite output")
    print(
        f"[4 TV/LPC] {c} x 2^{t.bit_length() - 1}, {s} sections of swept per-sample rows shared by "
        f"the channels: sosfilt_tv (B16) and scan (B17 x{s}) within {TV_RTOL} of plain and of "
        f"float64 (the plain version's own error against float64: "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
        + f"), 8 seeded chunks within {TV_RTOL} of one shot; sosfilt_tv_frames (B18) at frame_len "
        f"{TV_FRAMES} within {TV_RTOL} of plain and float64, 8 frame chunks of one shot; "
        f"tracking_notch, frame_len 1024, q 30: frequency error {w_err.max().item():.2e}, residual "
        f"tone {resid.max().item():.2e} of its power, noise correlation {corr.min().item():.3f}, "
        f"the CPU's on a prefix; lpc_vocoder {LPC_STREAMS} x {LPC_FRAMES} x {LPC_L}, p {LPC_P} "
        "(refine, B22 x3), pallas (B22 x2) and scan against float64 on every stream: "
        + ", ".join(f"{k} {v:.2e}" for k, v in lpc_err.items())
        + f" (< {LPC_RTOL}); resonant sets by radius (factored, sequential f32, refine): "
        + "; ".join(f"{r}: {f:.2e}, {q:.2e}, {g:.2e}" for r, (f, q, g) in res_err.items())
    )
    main = {"x": x, "rows": rows, "fr": fr, "a_f": a_f, "e_f": e_f, "a": a, "gain": gain, "ev": ev}
    return launches, main


def time_spread(kernel_fn, plain_fn, lead: float = 0.0) -> tuple[float, float, float, float]:
    """(median, min, max) device ms of the kernel, 10 after 5 warm-ups twice (``lead``:
    behind a sleep kernel, as ``device_ms``), and the plain version's median (3 after
    1 twice), in turns plain, kernel, kernel, plain."""
    plain = device_ms(plain_fn, 1, 3)
    kernel = device_ms(kernel_fn, 5, 10, lead) + device_ms(kernel_fn, 5, 10, lead)
    plain += device_ms(plain_fn, 1, 3)
    return statistics.median(kernel), min(kernel), max(kernel), statistics.median(plain)


def phase_tv_times(main: dict, b12_ms: float) -> dict:
    """B16, B17, B18 and B22 at the main path's shapes, beside B12's time in the same call
    (``b12_ms``); the tile kernels' registers and occupancy; frames against expand against
    scan."""
    x, rows, fr = main["x"], main["rows"], main["fr"][1024]
    c, t = x.shape
    s = rows.shape[0]
    n = c * t
    a_f, e_f = main["a_f"], main["e_f"]
    p = a_f.shape[1]
    s0 = torch.zeros_like(a_f)
    samples = e_f.numel()
    out = {
        "B16": time_spread(lambda: iir.tv_cascade(x, rows), lambda: iir._tv_plain(x, rows, 1, None)),
        "B17": time_spread(lambda: iir.tv_section(x, rows[:1]),
                           lambda: iir._tv_plain(x, rows[:1], 1, None)),
        "B18": time_spread(lambda: iir.tv_frames_cascade(x, fr, 1024),
                           lambda: iir._tv_plain(x, fr, 1024, None)),
        # B22's passes are about as short as the host's time to issue one: behind a lead
        "B22": time_spread(lambda: lpc.lpc_synth_pass(a_f, s0, e_f),
                           lambda: lpc._lpc_pass_plain(a_f, s0, e_f), lead=0.1),
        "B22 state": time_spread(lambda: lpc.lpc_synth_state(a_f, s0, e_f),
                                 lambda: lpc._lpc_pass_plain(a_f, s0, e_f), lead=0.1),
    }
    # bounds: x read once and y written once, each row read once; a section's
    # five FMAs a sample and channel; B22: e read, y written, a, s0 and z once,
    # p FMAs a sample
    bounds = {
        "B16": bound(8 * n + 24 * s * t, 10 * s * n, FP32_FLOPS_PER_S),
        "B17": bound(8 * n + 24 * t, 10 * n, FP32_FLOPS_PER_S),
        "B18": bound(8 * n + 24 * s * fr.shape[2], 10 * s * n, FP32_FLOPS_PER_S),
        "B22": bound(8 * samples + 12 * a_f.numel(), 2 * p * samples, FP32_FLOPS_PER_S),
        "B22 state": bound(4 * samples + 12 * a_f.numel(), 2 * p * samples, FP32_FLOPS_PER_S),
    }
    copy_dst = torch.empty_like(x)
    copy_ms = statistics.median(device_ms(lambda: copy_dst.copy_(x), 5, 10))
    transpose = statistics.median(device_ms(lambda: e_f.t().contiguous(), 5, 10))
    print(f"[5 TV/LPC times] {c} x 2^{t.bit_length() - 1} float32, {s} shared sections (B17 one); "
          f"B22 {a_f.shape[0]} frames x {LPC_L}, p {p}; kernels median (min-max) of 20 after "
          f"warm-ups, plain median of 6; copy of x {copy_ms:.4f} ms:")
    for name, (ms, lo, hi, plain) in out.items():
        b, by = bounds[name]
        print(f"  {name} {ms:.4f} ms ({lo:.4f}-{hi:.4f}); plain {plain:.4f} ms; bound {b:.4f} ms "
              f"({by}); kernel/bound {ms / b:.2f}; kernel/B12 {ms / b12_ms:.2f}")
    print(f"  B12 in this call (phase 5 IIR times, butter(8, 0.1) on the same shape): "
          f"{b12_ms:.4f} ms")
    # B22 redesigned: beside its time before, the predictions and its attributes; refine's
    # three passes (two state-only, one full) as lpc_synthesis runs them
    was = B4_B22_EARLIER_MS["B22"]
    for name in ("B22", "B22 state"):
        lo_p, hi_p = PREDICTED_MS[name]
        print(f"  {name}: before its redesign {was:.4f} ms ({was / out[name][0]:.2f}x); predicted "
              f"{lo_p}-{hi_p}")
    refine = device_ms(lambda: (lpc.lpc_synth_state(a_f, s0, e_f), lpc.lpc_synth_state(a_f, s0, e_f),
                                lpc.lpc_synth_pass(a_f, s0, e_f)), 5, 20, lead=0.3)
    print(f"  refine's three B22 passes {statistics.median(refine):.4f} ms ({min(refine):.4f}-"
          f"{max(refine):.4f}) median (min-max) of 20; before its redesign about {3 * was:.4f}; "
          f"predicted {PREDICTED_MS['B22 refine'][0]}-{PREDICTED_MS['B22 refine'][1]}; B22 attrs "
          f"(registers, local bytes, shared bytes, blocks an SM) by p: "
          + "; ".join(f"p={q} {lpc.lpc_kernel_attrs(q)}" for q in (1, 2, 12, 32, 40)))
    # what the compiler gave each tile kernel of csrc/iir_tv.cu (cudaFuncGetAttributes,
    # cudaOccupancyMaxActiveBlocksPerMultiprocessor at the launch's shared memory)
    for shared in (True, False):
        attrs = iir.tv_kernel_attrs(s, shared)
        print(f"  tile kernels, {s} sections of {'shared' if shared else 'per-channel'} rows "
              "(registers, local bytes a thread, shared bytes a block, blocks an SM, columns a "
              "block): " + "; ".join(f"{k} {v[0]}, {v[1]}, {v[2]}, {v[3]}, {v[4]}"
                                     for k, v in attrs.items()))
    print(f"  B22's frames stay in their (frames, L) layout; the transpose to the reference's "
          f"(L, frames) lanes it skips: {transpose:.4f} ms each way")
    print("  library: none; no PyTorch call computes a time-varying SOS cascade or an LPC "
          "synthesis (torchaudio's lfilter takes fixed coefficients)")
    # where a call's device time goes: its launches one by one (three calls
    # under the profiler, whose first records of a session can go missing)
    for name, fn in (("B16", lambda: iir.tv_cascade(x, rows)),
                     ("B17", lambda: iir.tv_section(x, rows[:1])),
                     ("B18", lambda: iir.tv_frames_cascade(x, fr, 1024))):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        print(f"  {name} by launch (torch.profiler, 3 calls): "
              + "; ".join(f"{k[:48]} x{n_} {ms:.4f} ms" for k, n_, ms in device_rows(prof)))
    # the frames A/B (the reference read frames 1.50x over expand on its TPU):
    # B18 on frame rows, the expand route, B16 alone on expanded rows, B17 a section
    expanded = fr.repeat_interleave(1024, dim=2)[:, :, :t].contiguous()
    ab = {
        "frames (B18)": lambda: iir.sosfilt_tv_frames(fr[:, 0], x, 1024),
        "expand (rows + B16)": lambda: iir.sosfilt_tv_frames(fr[:, 0], x, 1024, method="expand"),
        "B16 on expanded rows": lambda: iir.tv_cascade(x, expanded),
        "scan (B17 x S)": lambda: [iir.tv_section(x, expanded[k : k + 1]) for k in range(s)],
    }
    ab_ms = {k: statistics.median(device_ms(fn, 2, 5) + device_ms(fn, 2, 5)) for k, fn in ab.items()}
    base = ab_ms["frames (B18)"]
    print(f"[5 TV frames A/B] frame_len 1024, {c} x 2^{t.bit_length() - 1}, {s} sections, median "
          "of 10 after warm-ups: " + "; ".join(f"{k} {v:.4f} ms ({v / base:.2f}x)"
                                               for k, v in ab_ms.items()))
    return {"times": out, "bounds": bounds}


def design_set() -> dict:
    """Butterworth, Chebyshev II and the main path's elliptic design, from ``iir_design``."""
    return {
        "butter": iir_design.iirfilter(8, 0.1).astype(np.float32),
        "cheby2": iir_design.iirfilter(6, 0.2, ftype="cheby2", rs=50.0).astype(np.float32),
        "ellip": iir_design.iirdesign(*DESIGN_SPEC, ftype="ellip").astype(np.float32),
    }


def phase_anchor_corners(rng, dev, check: Checker) -> None:
    """B11 and B14 against their plain versions and float64; B14's refusals."""
    sub = iir.SUB_TILE
    lengths = (1, sub - 1, sub, sub + 1, 100_003)
    cases = [(c, t) for c in (1, 3, 16) for t in lengths] + [(16, IIR_T)]

    def sig(c: int, t: int) -> torch.Tensor:
        return torch.from_numpy(rng.standard_normal((c, t), dtype=np.float32)).to(dev)

    for a in IIR_POLES:
        for c, t in cases:
            x = sig(c, t)
            y = iir.iir1_affine_scan(x, a, 0.7)
            label = f"a={a} C={c} T={t}"
            check.close("B11", y, iir._iir1_plain(x, a, 0.7), f"B11 {label} against plain", IIR_RTOL)
            k = c if t < IIR_T else 1
            check.close("B11", y[:k], iir1_64(x[:k], a, 0.7), f"B11 {label} against float64",
                        IIR64_RTOL)

    def mxu(x, sos, label: str) -> float:
        """B14 in both row passes against plain and float64; plain's own error.

        Past the float32 recurrence's reach (16 sections of butter(32, 0.1),
        poles at radius 0.985) plain itself lies 1e-5 or more from float64,
        and B14, whose lane pass is float64, nearer: there B14 is held to
        plain within 1e-5 plus plain's own error, and to float64 within the
        larger of 1e-5 and plain's error (never farther from float64 than
        plain, to 1%, so that equal errors pass), as well as within 1e-4.
        """
        plain = iir._sos_plain(x, sos, None)[0]
        k = x.shape[0] if x.shape[1] < IIR_T else 1
        want, _ = sos64(sos, x[:k])
        e_plain = rel64(plain[:k], want.double()) if x.shape[1] else 0.0
        for row_pass in ("bcast", "compact"):
            y = iir.sosfilt_pallas_fused(sos, x, lane_pass="mxu", row_pass=row_pass)
            check.close("B14", y, plain, f"B14 {row_pass} {label} against plain",
                        IIR_RTOL + e_plain)
            check.close("B14", y[:k], want, f"B14 {row_pass} {label} against float64",
                        min(IIR64_RTOL, max(IIR_RTOL, 1.01 * e_plain)))
        return e_plain

    plain_err = {}

    for s in (1, 2, 4, 8, iir.MAX_SECTIONS):
        sos = iir.design_butterworth(2 * s, 0.1)
        for c, t in cases:
            plain_err[f"S={s}"] = max(plain_err.get(f"S={s}", 0.0),
                                      mxu(sig(c, t), sos, f"S={s} C={c} T={t}"))
    for name, sos in design_set().items():
        for c, t in [(c, 100_003) for c in (1, 3, 16)] + [(16, IIR_T)]:
            plain_err[name] = max(plain_err.get(name, 0.0),
                                  mxu(sig(c, t), sos, f"{name} ({sos.shape[0]} sections) C={c} T={t}"))
    # the high-Q end, 16 sections of butter(32, 0.1) (poles at radius up to
    # 0.985), each spelling of the cascade against float64: past the float32
    # recurrence's reach plain itself lies 1e-5 or more from float64, so B12 is
    # held there within HIGHQ_FACTOR x plain's own error (the rule of the
    # time-varying kernels, phase 4), and within IIR_RTOL where plain is nearer
    sos = iir.design_butterworth(2 * iir.MAX_SECTIONS, 0.1)
    x = sig(3, 100_003)
    want = sos64(sos, x)[0].double()
    y12 = iir.sos_cascade(x, sos)[0]
    high_q = {
        "plain": rel64(iir._sos_plain(x, sos, None)[0], want),
        "B12": rel64(y12, want),
        "B14": rel64(iir.sos_cascade_mxu(x, sos), want),
    }
    check.max_err["B12"] = max(check.max_err["B12"], high_q["B12"] * want.abs().max().item())
    check.count["B12"] += 1
    if not high_q["B12"] <= max(IIR_RTOL, HIGHQ_FACTOR * high_q["plain"]):
        raise AssertionError(f"B12 at 16 high-Q sections: {high_q['B12']:.3e} from float64, over "
                             f"{HIGHQ_FACTOR} x plain's {high_q['plain']:.3e} (and {IIR_RTOL})")
    # impulses across segment, sub-tile and tile edges (tile_rows=32: a tile of
    # 4096) give the impulse response; zeros stay zero
    sos = design_set()["ellip"]
    t = 3 * sub + 5
    x = torch.zeros(6, t, device=dev)
    for c, p in enumerate((0, iir.MXU_SEG - 1, iir.MXU_SEG, iir.MXU_SUB, sub, t - 100)):
        x[c, p] = 1.0
    want, _ = sos64(sos, x)
    check.close("B14", iir.sos_cascade_mxu(x, sos, tile_rows=32), want, "B14 impulses", IIR_RTOL)
    check.close("B11", iir.iir1_affine_scan(x, 0.99, tile_rows=32), iir1_64(x, 0.99, 1.0),
                "B11 impulses", IIR_RTOL)
    zero = torch.zeros_like(x)
    outs = (iir.sos_cascade_mxu(zero, sos), iir.iir1_affine_scan(zero, 0.9999))
    torch.cuda.synchronize()
    if any(torch.count_nonzero(o).item() for o in outs):
        raise AssertionError("a zero input gave a nonzero B11 or B14 output")
    refusals = {
        "no section": lambda: iir.sosfilt_pallas_fused(
            np.zeros((0, 6), np.float32), x, lane_pass="mxu"),
        "tile_rows=8": lambda: iir.sosfilt_pallas_fused(sos, x, lane_pass="mxu", tile_rows=8),
        "compact at tile_rows=64": lambda: iir.sosfilt_pallas_fused(
            sos, x, lane_pass="mxu", row_pass="compact", tile_rows=64),
        "lane_pass='tpu'": lambda: iir.sosfilt_pallas_fused(sos, x, lane_pass="tpu"),
        "kernel='tile' compact": lambda: iir.iir_first_order_pallas(
            x, 0.9, kernel="tile", row_pass="compact"),
    }
    for what, call in refusals.items():
        try:
            call()
        except ValueError:
            continue
        raise AssertionError(f"B11/B14 took {what}")
    print(
        f"[3 anchor corners] B11 at a {IIR_POLES}, B14 at sections {{1, 2, 4, 8, "
        f"{iir.MAX_SECTIONS}}} and on butter, cheby2 and ellip from iir_design, both row passes; "
        f"C {{1, 3, 16}}, T {{1, {sub - 1}, {sub}, {sub + 1}, 100003}} and 16 x 2^22: "
        + ", ".join(f"{k} {check.count[k]} checks" for k in ANCHOR_KERNELS)
        + f" within {IIR_RTOL} of plain and of float64 (x max|y|; plus plain's own error against "
        f"float64 where that is larger, at most {IIR64_RTOL}), impulses at "
        "segment, sub-tile and tile edges, zeros exact, refused: " + ", ".join(refusals)
        + "; max abs error " + ", ".join(f"{k} {check.max_err[k]:.3e}" for k in ANCHOR_KERNELS)
        + "; plain's own largest error against float64 (x max|y|): "
        + ", ".join(f"{k} {v:.3e}" for k, v in plain_err.items())
        + "; 16 sections of butter(32, 0.1) on 3 x 100003 against float64 (B12 held within "
        f"{HIGHQ_FACTOR} x plain's): " + ", ".join(f"{k} {v:.3e}" for k, v in high_q.items())
    )


def close64(got: torch.Tensor, want: np.ndarray, what: str, rtol: float = FIR64_RTOL) -> float:
    """max|got - want| <= rtol * max|want| for a float64 host reference; the ratio."""
    torch.cuda.synchronize()
    g = got.double().cpu().numpy()
    if g.shape != want.shape:
        raise AssertionError(f"{what}: shape {g.shape}, want {want.shape}")
    err = float(np.abs(g - want).max() / np.abs(want).max())
    if not err <= rtol:
        raise AssertionError(f"{what}: {err:.3e} of max|want| > {rtol}")
    return err


def phase_design_main(rng, dev, check: Checker) -> tuple[dict, dict]:
    """The filter-design path through its entry points at 16 x 2^22, counts reset around."""
    x = torch.from_numpy(rng.standard_normal((16, IIR_T), dtype=np.float32)).to(dev)
    order, wn = iir_design.ellipord(*DESIGN_SPEC)
    sos = iir_design.iirdesign(*DESIGN_SPEC, ftype="ellip")
    comp = cic.design_cic_compensator(CIC_COMP_TAPS, CIC_RATE, n_stages=CIC_STAGES)
    taps = fir.design_remez(201, [0.0, 0.1, 0.15, 1.0], [1.0, 0.0])
    h_up = fir.design_lowpass(48, 1.0 / 3.0) * 3.0
    # eight chunks of any length, one of them a single sample
    t = IIR_T
    cuts = (0, 1, 2, t // 40, t // 4, t // 2 + 7, 3 * t // 4, t - 1000, t)
    xs = x[:, :SPLINE_T]
    torch.cuda.synchronize()
    ys, routes = {}, {}
    reset_launch_counts()
    ys["sosfilt"] = iir.sosfilt(sos, x)
    routes["sosfilt"] = last_choice("sosfilt")
    for row_pass in ("bcast", "compact"):
        ys[f"mxu {row_pass}"] = iir.sosfilt_pallas_fused(sos, x, lane_pass="mxu", row_pass=row_pass)
    ys["tile"] = iir.iir_first_order_pallas(x, ANCHOR_POLE, kernel="tile")
    ys["cic"] = cic.cic_decimate(x, CIC_RATE, n_stages=CIC_STAGES)
    routes["cic_decimate"] = last_choice("fir_filter")
    ys["comp"] = fir.fir_filter(ys["cic"], comp)
    routes["compensator"] = last_choice("fir_filter")
    ys["cic_up"] = cic.cic_interpolate(x[:, :CIC_INTERP_T], CIC_RATE, n_stages=CIC_STAGES)
    state = streaming.fir_init(taps.size, 16, device=dev)
    outs = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        state, y = streaming.fir_chunk(state, x[:, a:b], taps)
        outs.append(y)
    ys["fir_chunk"] = torch.cat(outs, 1)
    ys["resample_fft"] = resample.resample_fft(x, 3 * t // 4)
    ys["upfirdn"] = resample.upfirdn(h_up, x, 3, 2)
    ys["savgol"] = fir.savgol_filter(x, 31, 4)
    ys["cspline"] = splines.cspline1d(xs)
    routes["cspline1d"] = last_choice("sosfilt_chunk")
    ys["qspline"] = splines.qspline1d(xs)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"[4 design] ellipord {order}, {wn} -> {sos.shape[0]} sections; routes {routes}; "
          f"launches {launches}")
    want_routes = {"sosfilt": "pallas_fused", "cic_decimate": "overlap_save_fused",
                   "compensator": "overlap_save_fused", "cspline1d": "pallas_fused"}
    if routes != want_routes:
        raise AssertionError(f"routes {routes}; want {want_routes}")
    want_launches = dict.fromkeys(launches, 0)
    want_launches.update({"B8": 2, "B11": 1, "B12": 5, "B14": 2})
    if launches != want_launches:
        raise AssertionError(f"launches {launches}; want {want_launches}")
    for key, y in ys.items():
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{key}: non-finite output")
    # the IIR kernels against their plain versions and float64 on channel 0
    plain = iir._sos_plain(x, iir._sos_rows(sos), None)[0]
    want, _ = sos64(sos, x[:1])
    iir_errs = {"plain": rel64(plain[:1], want.double())}
    for kernel, key in (("B12", "sosfilt"), ("B14", "mxu bcast"), ("B14", "mxu compact")):
        check.close(kernel, ys[key], plain, f"{key} 16x2^22 against plain", IIR_RTOL)
        check.close(kernel, ys[key][:1], want, f"{key} channel 0 against float64", IIR64_RTOL)
        iir_errs[key] = rel64(ys[key][:1], want.double())
    plain1 = iir._iir1_plain(x, ANCHOR_POLE, 1.0)
    want1 = iir1_64(x[:1], ANCHOR_POLE, 1.0)
    check.close("B11", ys["tile"], plain1, "B11 16x2^22 against plain", IIR_RTOL)
    check.close("B11", ys["tile"], iir.iir1_block_scan(x, ANCHOR_POLE), "B11 against B10", IIR_RTOL)
    check.close("B11", ys["tile"][:1], want1, "B11 channel 0 against float64", IIR64_RTOL)
    iir_errs["tile"] = rel64(ys["tile"][:1], want1.double())
    iir_errs["first-order plain"] = rel64(plain1[:1], want1.double())
    # the FIR routes against float64 on a prefix of channel 0
    x0 = x[0, :PREFIX].double().cpu().numpy()
    h_cic = cic.cic_taps(CIC_RATE, CIC_STAGES).astype(np.float64) / cic.cic_gain(CIC_RATE, CIC_STAGES)
    cic64 = np.convolve(x0, h_cic.astype(np.float32))[:PREFIX][::CIC_RATE]
    m = PREFIX // CIC_RATE
    errs = {
        "cic_decimate": close64(ys["cic"][0, :m], cic64, "cic_decimate against float64"),
        "compensator": close64(ys["comp"][0, :m], np.convolve(cic64, comp)[:m],
                               "compensator FIR against float64"),
        "cic_interpolate": close64(
            ys["cic_up"][0, : PREFIX * CIC_RATE],
            sps.upfirdn((h_cic * CIC_RATE).astype(np.float32), x0, CIC_RATE)[: PREFIX * CIC_RATE],
            "cic_interpolate against float64"),
        "upfirdn": close64(ys["upfirdn"][0, :PREFIX],
                           sps.upfirdn(h_up.astype(np.float32), x0, 3, 2)[:PREFIX],
                           "upfirdn against float64"),
        "fir_chunk": close64(ys["fir_chunk"][0, :PREFIX],
                             np.convolve(x0, taps.astype(np.float64))[:PREFIX],
                             "fir_chunk against float64"),
    }
    errs["fir_chunk one shot"] = close64(ys["fir_chunk"], fir.fir_direct(x, taps).double().cpu().numpy(),
                                         "fir_chunk against one shot", FIR_RTOL)
    xa = x[0].double().cpu().numpy()
    errs["resample_fft"] = close64(ys["resample_fft"][0], sps.resample(xa, 3 * t // 4),
                                   "resample_fft against float64")
    errs["savgol"] = close64(ys["savgol"][0], sps.savgol_filter(xa, 31, 4),
                             "savgol_filter against float64")
    xs0 = xs[0].double().cpu().numpy()
    errs["cspline1d"] = close64(ys["cspline"][0], sps.cspline1d(xs0), "cspline1d against float64")
    errs["qspline1d"] = close64(ys["qspline"][0], sps.qspline1d(xs0), "qspline1d against float64")
    print(
        f"[4 design] 16 x 2^22: sosfilt (B12) and lane_pass='mxu' in both row passes (B14) within "
        f"{IIR_RTOL} of plain and {IIR64_RTOL} of float64 on channel 0; kernel='tile' (B11) at "
        f"a={ANCHOR_POLE} within {IIR_RTOL} of plain and of B10; cic_decimate at rate {CIC_RATE}, "
        f"{CIC_STAGES} stages (B8) and its {CIC_COMP_TAPS}-tap compensator (B8), cic_interpolate on "
        f"16 x 2^19, a 201-tap Remez filter by fir_chunk in 8 chunks (one of one sample), "
        f"resample_fft to 3/4 of the length, upfirdn 3/2, savgol_filter(31, 4), cspline1d and qspline1d on "
        "16 x 2^20 (B12 seeded), against float64 (x max|y|): "
        + ", ".join(f"{k} {v:.3e}" for k, v in {**iir_errs, **errs}.items())
    )
    return launches, {"x": x, "sos": iir._sos_rows(sos)}


def phase_anchor_times(main: dict) -> dict:
    """B11 and B14 at the design path's shape against their plain versions, B10 and B12."""
    x, rows = main["x"], main["sos"]
    s = rows.shape[0]
    n = x.numel()
    out = {
        "B11": time_spread(lambda: iir.iir1_affine_scan(x, ANCHOR_POLE),
                           lambda: iir._iir1_plain(x, ANCHOR_POLE, 1.0)),
        "B10": time_spread(lambda: iir.iir1_block_scan(x, ANCHOR_POLE),
                           lambda: iir._iir1_plain(x, ANCHOR_POLE, 1.0)),
        "B14": time_spread(lambda: iir.sos_cascade_mxu(x, rows),
                           lambda: iir._sos_plain(x, rows, None)),
        "B12": time_spread(lambda: iir.sos_cascade(x, rows), lambda: iir._sos_plain(x, rows, None)),
    }
    # bounds: x read once and y written once; the function's operations, five
    # FMAs a sample and section (B10, B11: a product and an FMA)
    bounds = {
        "B10": bound(8 * n, 3 * n, FP32_FLOPS_PER_S),
        "B11": bound(8 * n, 3 * n, FP32_FLOPS_PER_S),
        "B12": bound(8 * n, s * 10 * n, FP32_FLOPS_PER_S),
        "B14": bound(8 * n, s * 10 * n, FP32_FLOPS_PER_S),
    }
    # segments B14 multiplies: launch 1 runs every tile but the last, launch 3
    # every tile, the last one's samples rounded up to whole sub-tiles
    tile = iir.pick_tile(*x.shape)
    full = (x.shape[1] - 1) // tile
    last = iir.cdiv(x.shape[1] - full * tile, iir.MXU_SUB) * iir.MXU_SUB
    segments = x.shape[0] * (2 * full * tile + last) // iir.MXU_SEG
    # a segment's kept blocks of T: MXU_MACS multiply-adds a section (the
    # zero blocks it skips are not counted)
    b14_flops = 2.0 * s * segments * iir.MXU_MACS
    library = {"B11": lfilter_ms(x, [1.0, 0.0], [1.0, -ANCHOR_POLE]),
               "B14": lfilter_ms(x, *sps.sos2tf(rows.astype(np.float64)))}
    library_note = LFILTER_NONE if library["B14"] is None else (
        f"torchaudio.functional.lfilter: cascade {library['B14']:.4f} ms, first order "
        f"{library['B11']:.4f} ms")
    print(f"[5 anchor times] 16 x 2^22 float32, the design path's {s}-section ellip and "
          f"a = {ANCHOR_POLE}; kernels median (min-max) of 20 after warm-ups, plain median of 6:")
    for name, (ms, lo, hi, plain) in out.items():
        b, by = bounds[name]
        print(f"  {name} {ms:.4f} ms ({lo:.4f}-{hi:.4f}) = {n / ms / 1e6:.2f} GS/s; plain "
              f"{plain:.4f} ms; bound {b:.4f} ms ({by}); kernel/bound {ms / b:.2f}")
    print(f"  B11/B10 {out['B11'][0] / out['B10'][0]:.3f}; B14/B12 {out['B14'][0] / out['B12'][0]:.3f}")
    print(f"  B14's own operations: {b14_flops:.4e} FP64 tensor-core flops "
          f"({s} sections x {segments} segments x {iir.MXU_MACS} multiply-adds, the "
          f"{len(iir.MXU_BLOCKS)} blocks of 4 x 8 of T that are not zero), "
          f"{b14_flops / FP64_TC_FLOPS_PER_S * 1e3:.4f} ms at 67 TFLOP/s, "
          f"{b14_flops / FP64_TC_FLOPS_PER_S * 1e3 / bounds['B14'][0]:.2f}x the function's bound")
    print(f"  library: {library_note}")
    # B14 by sections, and where a call's device time goes
    by_s = {}
    for k in (1, 2, 4, 8, iir.MAX_SECTIONS):
        sk = iir.design_butterworth(2 * k, 0.1)
        by_s[k] = statistics.median(device_ms(lambda sk=sk: iir.sos_cascade_mxu(x, sk), 2, 5))
    print("  B14 by sections (median of 5): " + ", ".join(f"S={k} {v:.4f} ms" for k, v in by_s.items())
          + f"; {(by_s[iir.MAX_SECTIONS] - by_s[1]) / (iir.MAX_SECTIONS - 1):.4f} ms a section")
    print("  B14's tile kernel by sections (registers, local bytes, shared bytes, blocks an SM, "
          "warps a block): " + "; ".join(f"S={k} {iir.mxu_kernel_attrs(k)}" for k in by_s))
    for name, fn in (("B14", lambda: iir.sos_cascade_mxu(x, rows)),
                     ("B11", lambda: iir.iir1_affine_scan(x, ANCHOR_POLE))):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        print(f"  {name} by launch (torch.profiler, 3 calls): "
              + "; ".join(f"{k[:48]} x{c} {ms:.4f} ms" for k, c, ms in device_rows(prof)))
    return {"times": out, "bounds": bounds, "library": library}


# 8. The sharded path (parallel/): a ring of RING_WORLD processes on the one
# card (gloo coordinates the hosts at a key's first call; the halos move by
# B6's put through CUDA IPC mappings of the neighbours' receive buffers,
# ordered by counters there on the device), each rank on a quarter of
# the main stream, then every sharded entry point at world size 1 over NCCL
# at full width against the one-card entry point.
RING_WORLD = 4
RING_REPS = 10
# k x C corners of the ring, each shard k + 777 frames; then a shard of
# exactly one halo (k*C samples) and one shorter than a tile
RING_CORNERS = [(k, c, k + 777) for k in (1, 16, 1024) for c in (1, 2, 16)] + [
    (1024, 2, 1024), (16, 2, 100),
]
# calls of one ring key back to back with new data, and another key between
RING_SEQ = [(16, 2), (1000, 1), (16, 2), (16, 2)]
# k x C x frames a shard of the packed sharded path (B2 seeded with the pair words
# before the shard) beside the main stream's: odd k*C (a seed of k + 1 frames) and even
RING_PACKED = [(5, 3, 8192), (1023, 1, 8192), (16, 16, 1000), (1, 2, 4096)]
# B6 and B7 before the ring's ordering moved onto the device (PERF.md §6: in the ring
# of four, and B7 alone at world size 1; NVIDIA H100 80GB HBM3, 700.00 W)
RING_EARLIER_MS = {"B6": 1.4376, "B7": 1.7347, "B7 alone": 0.1124}
RING_B2B = 10  # calls of each key back to back whose host steps are counted
SHARDED_FIR_TAPS = (257, 8193)
CASCADE_MICRO = 8


def ring_stream(seed: int, samples: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(-32768, 32768, size=samples, dtype=np.int16)


def ring_timed(fn, mesh, reps: int = RING_REPS) -> tuple[list[float], list[float]]:
    """Device ms (events on this rank's stream) and host ms of ``reps`` calls,
    each started together on every rank (a host barrier) after one warm-up."""
    from digital_signal_processsing_tpu_torch.parallel.mesh import host_barrier

    fn()
    dev_ms, wall_ms = [], []
    for _ in range(reps):
        host_barrier(mesh)
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(e0.elapsed_time(e1))
    return dev_ms, wall_ms


def kernel_ms_by_launch(fn, name: str, calls: int) -> list[float]:
    """Device ms of each launch of kernel ``name`` in ``calls`` calls of ``fn``
    (torch.profiler), in launch order; empty where the profiler saw none."""
    with torch.profiler.profile(activities=PROFILE_ACTIVITIES) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e.time_range.elapsed_us() / 1e3 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]


def ring_worker(rank: int, tmp: str) -> None:
    """One rank of the one-card ring: its quarter of the main stream, then the corners."""
    import torch.distributed as dist

    from digital_signal_processsing_tpu_torch import parallel as par
    from digital_signal_processsing_tpu_torch.parallel.mesh import host_barrier, shift_right

    torch.cuda.set_device(0)
    par.initialize_multihost(f"file://{tmp}/ring.store", RING_WORLD, rank, backend="gloo")
    mesh = par.make_time_mesh(device="cuda")
    dev, flat = mesh.device, par.time_sharding(mesh)
    n_loc, halo = MAIN_SAMPLES // RING_WORLD, MAIN_WINDOW * 2
    xs = torch.from_numpy(np.load(f"{tmp}/x.npy", mmap_mode="r")[rank * n_loc : (rank + 1) * n_loc]
                          .copy()).to(dev)
    torch.cuda.synchronize()
    out, info = {}, {}

    # the main path: counts reset just before, read just after
    reset_launch_counts()
    out["shift"] = par.ring_shift_right_shard(xs, mesh)
    out["pallas_ring"] = par.sharded_moving_average(xs, MAIN_WINDOW, 2, mesh=mesh,
                                                    halo_impl="pallas_ring")
    out["fused_ring"] = par.sharded_moving_average(xs, MAIN_WINDOW, 2, mesh=mesh,
                                                   halo_impl="fused_ring")
    torch.cuda.synchronize()
    info["launches"] = launch_counts()

    # each kernel against its plain version (the ppermute spelling) on the same shards
    def plain_fused():
        left = shift_right(xs[n_loc - halo :], mesh)
        return moving_average_xla(torch.cat([left, xs]), MAIN_WINDOW, 2)[halo:]

    err = {
        "B6": int((out["shift"].long() - shift_right(xs, mesh).long()).abs().max().item()),
        "B7": int((out["fused_ring"].long() - plain_fused().long()).abs().max().item()),
    }
    info["err"] = err
    info["times"] = {
        "host_barrier": ring_timed(lambda: host_barrier(mesh), mesh),
        "B6": ring_timed(lambda: par.ring_shift_right_shard(xs, mesh), mesh),
        "B6 plain": ring_timed(lambda: shift_right(xs, mesh), mesh, 3),
        "B7": ring_timed(lambda: par.fused_ring_windowed_shard(xs, MAIN_WINDOW, 2, mesh), mesh),
        "B7 plain": ring_timed(plain_fused, mesh, 3),
        "pallas_ring": ring_timed(lambda: par.sharded_moving_average(
            xs, MAIN_WINDOW, 2, mesh=mesh, halo_impl="pallas_ring"), mesh),
    }
    # B7 by launch (the put and the interior, then the head behind the wait)
    info["B7 by launch"] = kernel_ms_by_launch(
        lambda: par.fused_ring_windowed_shard(xs, MAIN_WINDOW, 2, mesh), "ring_windowed_kernel",
        RING_REPS)

    # after a key's first call, a call takes no host step: calls back to back
    with par.HostSteps() as steps:
        for _ in range(RING_B2B):
            par.ring_shift_right_shard(xs, mesh)
            par.fused_ring_windowed_shard(xs, MAIN_WINDOW, 2, mesh)
    info["host steps"] = steps.counts
    flush = ctypes.c_int64()
    _build.check(_build.library().dsp_ring_can_flush(ctypes.byref(flush)), "dsp_ring_can_flush")
    info["can flush"] = flush.value

    # corners, back-to-back calls of one key and two keys interleaved
    for i, (w, c, frames) in enumerate(RING_CORNERS):
        xi = flat.shard(torch.from_numpy(ring_stream(300 + i, RING_WORLD * frames * c)).to(dev))
        for h in ("pallas_ring", "fused_ring"):
            out[f"corner {i} {h}"] = par.sharded_moving_average(xi, w, c, mesh=mesh, halo_impl=h)
    for i, (w, c) in enumerate(RING_SEQ):
        xi = flat.shard(torch.from_numpy(ring_stream(400 + i, RING_WORLD * 8192)).to(dev))
        out[f"seq {i}"] = par.sharded_moving_average(xi, w, c, mesh=mesh, halo_impl="fused_ring")
    # the packed sharded path: B6's halo of pair words into B2 seeded
    out["packed"] = par.sharded_moving_average(xs.view(torch.int32), MAIN_WINDOW, 2, mesh=mesh,
                                               halo_impl="pallas_ring").view(torch.int16)
    for i, (w, c, frames) in enumerate(RING_PACKED):
        xi = flat.shard(torch.from_numpy(ring_stream(500 + i, RING_WORLD * frames * c)).to(dev))
        out[f"packed {i}"] = par.sharded_moving_average(
            xi.view(torch.int32), w, c, mesh=mesh, halo_impl="pallas_ring").view(torch.int16)
    torch.cuda.synchronize()
    np.savez(f"{tmp}/rank{rank}.npz", **{k: v.cpu().numpy() for k, v in out.items()})
    Path(f"{tmp}/rank{rank}.json").write_text(json.dumps(info))
    mesh.close()
    dist.destroy_process_group()


def phase_sharded_ring(x: torch.Tensor, y_main: torch.Tensor, check: Checker) -> dict:
    """The ring of RING_WORLD processes on the one card, against B1 over whole streams."""
    dev, n_loc = x.device, MAIN_SAMPLES // RING_WORLD
    with tempfile.TemporaryDirectory() as tmp:
        np.save(f"{tmp}/x.npy", x.cpu().numpy())
        t0 = time.perf_counter()
        torch.multiprocessing.spawn(ring_worker, args=(tmp,), nprocs=RING_WORLD, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [np.load(f"{tmp}/rank{r}.npz") for r in range(RING_WORLD)]
        infos = [json.loads(Path(f"{tmp}/rank{r}.json").read_text()) for r in range(RING_WORLD)]

        def whole(key: str) -> torch.Tensor:
            return torch.from_numpy(np.concatenate([r[key] for r in ranks])).to(dev)

        shifted = torch.cat([torch.zeros(n_loc, dtype=x.dtype, device=dev), x[:-n_loc]])
        check.same("B6", whole("shift"), shifted, "ring of 4: ring_shift_right_shard, 64M")
        check.same("B6", whole("pallas_ring"), y_main, "ring of 4: pallas_ring 64M k=1024 C=2 vs B1")
        check.same("B7", whole("fused_ring"), y_main, "ring of 4: fused_ring 64M k=1024 C=2 vs B1")
        for i, (w, c, frames) in enumerate(RING_CORNERS):
            xi = torch.from_numpy(ring_stream(300 + i, RING_WORLD * frames * c)).to(dev)
            want = ps.windowed_averager(xi, w, c)
            check.same("B6", whole(f"corner {i} pallas_ring"), want, f"ring corner k={w} C={c}")
            check.same("B7", whole(f"corner {i} fused_ring"), want, f"ring corner k={w} C={c}")
        for i, (w, c) in enumerate(RING_SEQ):
            xi = torch.from_numpy(ring_stream(400 + i, RING_WORLD * 8192)).to(dev)
            check.same("B7", whole(f"seq {i}"), ps.windowed_averager(xi, w, c), f"ring call {i}")
        check.same("B2", whole("packed"), y_main, "ring of 4: packed 64M k=1024 C=2 vs B1")
        for i, (w, c, frames) in enumerate(RING_PACKED):
            xi = torch.from_numpy(ring_stream(500 + i, RING_WORLD * frames * c)).to(dev)
            check.same("B2", whole(f"packed {i}"), ps.windowed_averager(xi, w, c),
                       f"ring packed k={w} C={c} (seed of {ps.packed_seed_words(w, c)} words)")
    for r, info in enumerate(infos):
        # B6's put: ring_shift_right_shard and pallas_ring's halo on every rank but the
        # last, whose right neighbour (rank 0) receives zeros; B7 on every rank
        b6 = 2 if r < RING_WORLD - 1 else 0
        if info["launches"]["B6"] != b6 or info["launches"]["B7"] != 1 or any(info["err"].values()):
            raise AssertionError(f"ring rank {r}: launches {info['launches']}, errors {info['err']}")
        if any(info["host steps"].values()):
            raise AssertionError(f"ring rank {r}: host steps in {RING_B2B} calls back to back "
                                 f"after a key's first: {info['host steps']}")
    launches = {k: sum(info["launches"][k] for info in infos) for k in ("B1", "B6", "B7")}

    def per_rank(key: str, i: int) -> list[float]:
        return [statistics.median(info["times"][key][i]) for info in infos]

    times = {}
    print(f"[8 ring] {RING_WORLD} processes on one card ({spawn_s:.1f} s with the spawn), "
          f"{n_loc} samples a rank: B6 and B7 bit-exact against plain on every rank and against "
          f"B1 over the whole 64M stream, {len(RING_CORNERS)} corners, {len(RING_SEQ)} calls back "
          f"to back; the packed path (B2 seeded) on the 64M stream and {len(RING_PACKED)} corners "
          f"bit-exact against B1; launches (all ranks) {launches}; host steps (barriers, object gathers, "
          f"synchronisations) in {RING_B2B} calls of B6 and B7 back to back after each key's "
          f"first call: 0 on every rank; the card flushes remote writes after a stream wait "
          f"(CU_DEVICE_ATTRIBUTE_CAN_FLUSH_REMOTE_WRITES): {bool(infos[0]['can flush'])}. "
          "Device ms a call on each rank's stream (the four "
          "contexts time-slice the card and the call waits for its neighbours: not a kernel's "
          f"time alone, not a scaling number), median of {RING_REPS} (plain: 3) after a warm-up, "
          "by rank; whole ring: the slowest rank's host ms; before: with a host barrier a call:")
    for key in ("host_barrier", "B6", "B6 plain", "B7", "B7 plain", "pallas_ring"):
        dev_ms, wall = per_rank(key, 0), per_rank(key, 1)
        all_dev = [v for info in infos for v in info["times"][key][0]]
        times[key] = (statistics.median(all_dev), min(all_dev), max(all_dev))
        was = f"; before {RING_EARLIER_MS[key]:.4f}" if key in ("B6", "B7") else ""
        print(f"  {key:12s} device {', '.join(f'{v:.4f}' for v in dev_ms)} "
              f"(all ranks: median {times[key][0]:.4f}, min {times[key][1]:.4f}, max "
              f"{times[key][2]:.4f}); whole ring {max(wall):.4f}, host ms by rank "
              f"{', '.join(f'{v:.4f}' for v in wall)}{was}")
    for r, info in enumerate(infos):
        put = "the put and " if r < RING_WORLD - 1 else ""
        parts = ([f"{put}the interior", "the head behind the wait"] if r > 0 else
                 ["the put, the interior and the head: rank 0 receives no halo"])
        by, per_call = info["B7 by launch"], len(parts)
        if len(by) != per_call * RING_REPS:
            print(f"  B7 by launch, rank {r}: not measured (the profiler saw {len(by)} of "
                  f"{per_call * RING_REPS} launches)")
            continue
        cols = [statistics.median(by[i::per_call]) for i in range(per_call)]
        print(f"  B7 by launch, rank {r} (device ms, median of {RING_REPS} under torch.profiler): "
              + ", ".join(f"{v:.4f} ({part})" for v, part in zip(cols, parts)))
    return {"launches": launches, "times": times}


def phase_sharded_world1(x, y_main, chain_main: dict, tv_main: dict, wide_main: dict,
                         wav: np.ndarray, split: int, check: Checker, tmp: str) -> dict:
    """Every sharded entry point at world size 1 over NCCL, at full width."""
    import torch.distributed as dist

    from digital_signal_processsing_tpu_torch import parallel as par
    from digital_signal_processsing_tpu_torch.parallel import ring_pallas
    from digital_signal_processsing_tpu_torch.parallel.mesh import shift_right

    dev = x.device
    topo = par.initialize_multihost(f"file://{tmp}/nccl.store", 1, 0, backend="nccl")
    if topo["platform"] != "gpu" or topo["process_count"] != 1:
        raise AssertionError(f"topology {topo}")
    par.assert_same_across_hosts(1.0)
    mesh = par.make_mesh(device="cuda")
    g = torch.Generator(dev).manual_seed(8)
    xf = torch.randn(16, CHAIN_T, device=dev, generator=g)
    taps = {k: fir.design_lowpass(k, 0.1) for k in SHARDED_FIR_TAPS}
    chain, i, q = chain_main["chain"], chain_main["i"], chain_main["q"]
    sos_t = tv_main["rows"][:, 0]
    torch.cuda.synchronize()

    ys = {}
    reset_launch_counts()
    for h in ("ppermute", "pallas_ring", "fused_ring"):
        ys[f"windowed {h}"] = par.sharded_moving_average(x, MAIN_WINDOW, 2, mesh=mesh, halo_impl=h)
    for ci in ("ladder", "allgather"):
        ys[f"scan {ci}"] = par.sharded_moving_average(x, MAIN_WINDOW, 2, mesh=mesh, method="scan",
                                                      carry_impl=ci)
    for h in ("pallas_ring", "fused_ring"):
        ys[f"scan {h}"] = par.sharded_moving_average(x, MAIN_WINDOW, 2, mesh=mesh, method="scan",
                                                     halo_impl=h)
    ys["packed"] = par.sharded_moving_average(x.view(torch.int32), MAIN_WINDOW, 2, mesh=mesh,
                                              halo_impl="pallas_ring")
    ys["cumsum"] = par.sharded_cumsum(x, TWO_PASS_CHANNELS, mesh=mesh)
    for k, h in taps.items():
        ys[f"fir {k}"] = par.sharded_fir_filter(xf, h, mesh=mesh)
    ys["chain"] = par.sharded_chain_planar(chain, i, q, mesh)
    chunks = xf.view(16, CASCADE_MICRO, -1).transpose(0, 1).contiguous()
    ys["cascade"] = par.pipelined_fir_cascade(chunks, taps[257][None], mesh=mesh)
    ys["tv"] = par.sharded_sosfilt_tv(sos_t, tv_main["x"], mesh=mesh)
    ys["lpc"] = par.sharded_lpc_synthesis(tv_main["a"], tv_main["gain"], tv_main["ev"], LPC_L,
                                          mesh=mesh)
    torch.cuda.synchronize()
    launches = launch_counts()
    # B6 puts nothing in a world of one (its one rank receives zeros and sends to none);
    # the ring of four launches it
    path = ("B1", "B2", "B4", "B7", "B8", "B16", "B22")
    print(f"[8 world 1] topology {topo}; launches {launches}")
    if min(launches[k] for k in path) < 1 or launches["B6"] != 0:
        raise AssertionError(f"a kernel of the sharded path was never launched, or B6 put in a "
                             f"world of one: {launches}")

    for h, kernel in (("ppermute", "B1"), ("pallas_ring", "B6"), ("fused_ring", "B7")):
        check.same(kernel, ys[f"windowed {h}"], y_main, f"world 1 windowed {h} 64M against B1")
    for key in ("scan ladder", "scan allgather", "scan pallas_ring", "scan fused_ring"):
        check.same("B4", ys[key], y_main, f"world 1 {key} 64M against B1")
    check.same("B2", ys["packed"].view(torch.int16), y_main, "world 1 packed 64M against B1")
    check.same("B4", ys["cumsum"], ps.cumsum(x, TWO_PASS_CHANNELS), "world 1 cumsum C=16")
    for k, h in taps.items():
        check.close("B8", ys[f"fir {k}"], fir.fir_filter(xf, h), f"world 1 fir k={k} 16x2^22")
    one = chain.forward_planar(i, q)
    ramp = (257 + 64) // 8 + 63
    np.testing.assert_allclose(ys["chain"][:, ramp:].cpu().numpy(), one[:, ramp:].cpu().numpy(),
                               rtol=1e-3, atol=1e-4)
    got = ys["cascade"].transpose(0, 1).reshape(16, -1)
    want = fir.fir_direct(xf, taps[257])
    err = (got - want).abs().max().item()
    if not err <= FIR_RTOL * want.abs().max().item():
        raise AssertionError(f"world 1 cascade: max abs error {err:.3e} against fir_direct")
    check.close("B16", ys["tv"], iir.sosfilt_tv(sos_t, tv_main["x"]), "world 1 sosfilt_tv", 0.0)
    check.close("B22", ys["lpc"], lpc.lpc_synthesis(tv_main["a"], tv_main["gain"], tv_main["ev"],
                                                    LPC_L), "world 1 lpc_synthesis", 0.0)
    print(
        "[8 world 1] NCCL, one rank: the averager at 64M k=1024 C=2 (windowed by every halo_impl, "
        "scan by both carry_impls and the ring, packed) and sharded_cumsum C=16 bit-exact against "
        f"B1 and B4; sharded_fir_filter at {SHARDED_FIR_TAPS} taps on 16 x 2^22 within {FIR_RTOL} "
        "of fir_filter; sharded_chain_planar on the flagship within rtol 1e-3 / atol 1e-4 of the "
        "chain; pipelined_fir_cascade within the same of fir_direct; sharded_sosfilt_tv and "
        "sharded_lpc_synthesis bit for bit with sosfilt_tv and lpc_synthesis"
    )
    multicard_world1(mesh, x, y_main, wide_main, wav, split, tmp)

    # B6 and B7 alone (no other process on the card) on the ring's shard
    n_loc = MAIN_SAMPLES // RING_WORLD
    xs = x[:n_loc]
    dst = torch.empty_like(xs)
    halo = MAIN_WINDOW * 2

    def plain_fused():
        left = shift_right(xs[n_loc - halo :], mesh)
        return moving_average_xla(torch.cat([left, xs]), MAIN_WINDOW, 2)[halo:]

    lib = _build.library()

    def put_alone():  # B6's put kernel into a local buffer, no counter
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.dsp_ring_put(xs.data_ptr(), dst.data_ptr(), 2 * n_loc, None, 0, None,
                                      stream), "dsp_ring_put")

    put_alone()
    check.same("B6", dst, xs, "the put alone into a local buffer, 32 MB")

    def b7():
        return par.fused_ring_windowed_shard(xs, MAIN_WINDOW, 2, mesh)

    def b1():
        return ps.windowed_averager(xs, MAIN_WINDOW, 2)

    # behind a lead sleep kernel (the card's time for a call), and without it (where
    # the host's time to issue a call is the longer)
    alone = {
        "B6 (a zero fill: nothing to put)": device_ms(
            lambda: par.ring_shift_right_shard(xs, mesh), 5, 20, lead=0.3),
        "the put alone (dsp_ring_put, local)": device_ms(put_alone, 5, 20, lead=0.3),
        "copy of the shard (yardstick)": device_ms(lambda: dst.copy_(xs), 5, 20, lead=0.3),
        "B7": device_ms(b7, 5, 20, lead=0.3),
        "B1": device_ms(b1, 5, 20, lead=0.3),
        "B7 host-paced": device_ms(b7, 5, 20),
        "B1 host-paced": device_ms(b1, 5, 20),
        "B7 plain": device_ms(plain_fused, 1, 5),
    }
    stats = {k: (statistics.median(v), min(v), max(v)) for k, v in alone.items()}
    put_ms, copy_ms = stats["the put alone (dsp_ring_put, local)"][0], stats[
        "copy of the shard (yardstick)"][0]
    print(f"[8 world 1] alone on the card, {n_loc} samples (the ring's shard), device ms median "
          "(min-max) of 20 after 5 warm-ups, behind a sleep kernel while the host queues them, "
          "or host-paced without it (B7 plain: 5 after 1): "
          + "; ".join(f"{k} {m:.4f} ({lo:.4f}-{hi:.4f})" for k, (m, lo, hi) in stats.items())
          + f"; B7/B1 {stats['B7'][0] / stats['B1'][0]:.3f} (before: "
          f"{RING_EARLIER_MS['B7 alone']:.4f} ms; before B1's redesign {B1_EARLIER_MS['B7']:.4f}); "
          f"the put/copy_ {put_ms / copy_ms:.3f}; B7's kernel "
          f"{ring_pallas.fused_ring_kernel_attrs(MAIN_WINDOW, 2)} (registers, local bytes, "
          f"shared bytes, blocks an SM; B1's "
          f"{ps.windowed_kernel_attrs(MAIN_WINDOW, 2)})")
    mesh.close()
    dist.destroy_process_group()
    return {"launches": launches, "alone": stats}


SPEC_C, SPEC_T = 8, 1 << 21  # the STFT and MFCC rows' shape (8 x 2^21 float32)
SPEC_NFFT, SPEC_HOP = 1024, 512
MFCC_NFFT, MFCC_HOP, MFCC_MELS, MFCC_COEFS, MFCC_RATE = 512, 256, 40, 13, 16000.0
HILB_C, HILB_T, HILB_LONG = 16, 1 << 22, 1 << 26
OA_TAPS = (257, 8194)  # B8's and B9's
RADAR_PULSES, RADAR_RANGE, RADAR_PULSE_LEN = 64, 1 << 20, 128  # RadarConfig's matched filter
CZT_MATMUL = (16, 4096, 2048)  # channels, t, m: t*m = 2^23, the dense product's bound
CZT_BLUESTEIN = (16, 1 << 20, 4096)
PITCH_C, PITCH_T, PITCH_FACTOR, PITCH_PREFIX = 2, 1 << 22, 2 ** (3 / 12), 1 << 18
STRETCH_RATE, STRETCH_NFFT = 1.25, 2048
SPEC_RTOL = 1e-5  # float32 transforms and products against float64, x max|want|
# The phase vocoder against float64: its float32 analysis leaves each weak bin's phase
# increment a few ulp off, a random walk through the (float64) synthesis phase of about
# 1e-5 of max|y| over 150 frames (the CPU 8.8e-6, an H100 3.1e-5 on phase 9's tones); the
# reference's float32 running phase errs 2.2e-3 over 254 such frames (ROADMAP H11)
PITCH_RTOL = 1e-4


def ts64(x: np.ndarray, rate: float, nfft: int) -> np.ndarray:
    """The phase vocoder's time stretch in float64 on the host (its algorithm, sample
    for sample: sqrt-hann frames at the analysis hop, wrapped phase increments, the
    running synthesis phase, WOLA at nfft/4)."""
    x = np.asarray(x, np.float64)
    hs = nfft // 4
    ha = max(1, int(round(hs * rate)))
    k = np.arange(nfft)
    w = np.sqrt(0.5 - 0.5 * np.cos(2 * np.pi * k / nfft))
    frames = (x.shape[-1] - nfft) // ha + 1
    s = np.fft.rfft(x[..., np.arange(frames)[:, None] * ha + k] * w, axis=-1)
    mag, ph = np.abs(s), np.angle(s)
    del s
    wk = 2 * np.pi * np.arange(nfft // 2 + 1) / nfft
    dph = ph[..., 1:, :] - ph[..., :-1, :] - wk * ha
    inst = wk + (dph - 2 * np.pi * np.round(dph / (2 * np.pi))) / ha
    phs = np.concatenate([ph[..., :1, :], ph[..., :1, :] + np.cumsum(hs * inst, axis=-2)], axis=-2)
    seg = np.fft.irfft(mag * np.exp(1j * phs), n=nfft, axis=-1) * w
    r = nfft // hs
    y = np.zeros(x.shape[:-1] + (frames + r - 1, hs))
    parts = seg.reshape(x.shape[:-1] + (frames, r, hs))
    for i in range(r):
        y[..., i : i + frames, :] += parts[..., i, :]
    return y.reshape(x.shape[:-1] + (-1,)) * (2.0 * hs / nfft)


def bin_tones(channels: int, t: int, nfft: int) -> np.ndarray:
    """Two tones a channel on bin centres of ``nfft`` (the phase vocoder's wraps stay
    away from a half there)."""
    n = np.arange(t, dtype=np.float64)
    return np.stack([0.4 * np.sin(2 * np.pi * (37 + 16 * c) * n / nfft)
                     + 0.3 * np.cos(2 * np.pi * (211 + 9 * c) * n / nfft)
                     for c in range(channels)]).astype(np.float32)


def stft64(x: np.ndarray, nfft: int, hop: int, w: np.ndarray, frames: int) -> np.ndarray:
    idx = np.arange(frames)[:, None] * hop + np.arange(nfft)[None, :]
    return np.fft.rfft(np.asarray(x, np.float64)[..., idx] * w, axis=-1)


def mag_frames(y: np.ndarray, nfft: int = 2048) -> np.ndarray:
    """|rfft| of the whole nfft-sample frames of each channel (the magnitude spectrogram)."""
    n = y.shape[-1] // nfft * nfft
    return np.abs(np.fft.rfft(y[..., :n].reshape(y.shape[:-1] + (-1, nfft)), axis=-1))


def mag_stft(y: np.ndarray, nfft: int = 2048, hop: int = 512) -> np.ndarray:
    """|STFT| of each channel in float64: periodic hann frames of nfft at hop."""
    frames = (y.shape[-1] - nfft) // hop + 1
    w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(nfft) / nfft)
    return np.abs(stft64(y, nfft, hop, w, frames))


def host_rel(got, want: np.ndarray) -> float:
    """max|got - want| / max|want|, complex or real, in float64 on the host."""
    g = got.cpu().resolve_conj().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    g = g.astype(np.complex128 if np.iscomplexobj(g) else np.float64)
    if g.shape != want.shape:
        raise AssertionError(f"shape {g.shape}, want {want.shape}")
    return float(np.abs(g - want).max() / np.abs(want).max())


def phase_spectral_main(rng, dev) -> dict:
    """The spectral and correlation slice through its entry points at full size,
    counts reset around; each output against float64 on the host, routes asserted."""
    routes, errs, calls = {}, {}, {}

    def close(name: str, got, want: np.ndarray, rtol: float = SPEC_RTOL) -> None:
        errs[name] = e = host_rel(got, want)
        if not e <= rtol:  # also fails on NaN
            raise AssertionError(f"[9 spectral] {name}: {e:.3e} of max|want| > {rtol}")

    x = torch.from_numpy(rng.standard_normal((SPEC_C, SPEC_T), dtype=np.float32)).to(dev)
    y = 0.6 * x + 0.8 * torch.from_numpy(rng.standard_normal((SPEC_C, SPEC_T), dtype=np.float32)).to(dev)
    x16 = torch.from_numpy(rng.standard_normal((HILB_C, HILB_T), dtype=np.float32)).to(dev)
    xl = torch.from_numpy(rng.standard_normal(HILB_LONG, dtype=np.float32)).to(dev)
    ar, ai = (torch.from_numpy(rng.standard_normal((RADAR_PULSES, RADAR_RANGE), dtype=np.float32)).to(dev)
              for _ in range(2))
    n = np.arange(RADAR_PULSE_LEN)
    chirp = np.exp(1j * np.pi * 0.5 * n * n / RADAR_PULSE_LEN)  # LFM over half the band
    vr, vi = (torch.from_numpy(p.astype(np.float32)).to(dev) for p in (chirp.real, chirp.imag))
    xp = torch.from_numpy(bin_tones(PITCH_C, PITCH_T, STRETCH_NFFT)).to(dev)
    torch.cuda.synchronize()

    reset_launch_counts()
    # STFT/ISTFT round trip, nfft 1024, hop 512, sqrt-hann (the WOLA pair)
    calls["stft"] = lambda: spec.stft(x, nfft=SPEC_NFFT, hop=SPEC_HOP, window="sqrt_hann")
    calls["istft"] = lambda: spec.istft(s, nfft=SPEC_NFFT, hop=SPEC_HOP, window="sqrt_hann")
    s = calls["stft"]()
    yr = calls["istft"]()
    # the PSD family on the same input
    calls["welch"] = lambda: spec.welch(x, nfft=SPEC_NFFT)
    calls["csd"] = lambda: spec.csd(x, y, nfft=SPEC_NFFT)
    calls["coherence"] = lambda: spec.coherence(x, y, nfft=SPEC_NFFT)
    pw, pc, ch = calls["welch"](), calls["csd"](), calls["coherence"]()
    # the products with TF32 turned on by the caller: mfcc's mel and DCT, czt's chirp
    # matrix and tone_power's bank are pinned to IEEE float32
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        calls["mfcc"] = lambda: mel.mfcc(x, sample_rate=MFCC_RATE, n_mfcc=MFCC_COEFS, nfft=MFCC_NFFT,
                                         hop=MFCC_HOP, n_mels=MFCC_MELS)
        cm = calls["mfcc"]()
        c_, t_, m_ = CZT_MATMUL
        xc = x16[:c_, :t_]
        zoom = (0.05, 0.15)  # a band of a tenth of the sampling rate, in m bins
        zw = complex(np.exp(-2j * np.pi * (zoom[1] - zoom[0]) / m_))
        za = complex(np.exp(2j * np.pi * zoom[0]))
        calls["czt matmul"] = lambda: spec.czt(xc, m_, zw, za)
        zc = calls["czt matmul"]()
        routes["czt matmul"] = last_choice("czt")
        freqs = np.array([0.01, 0.0123456, 0.1, 0.2, 0.25, 0.3, 0.4, 0.49], np.float32)
        calls["tone_power"] = lambda: spec.tone_power(x16, freqs)
        tp = calls["tone_power"]()
    finally:
        torch.set_float32_matmul_precision(saved)
    cb_, tb_, mb_ = CZT_BLUESTEIN
    xb = x16[:cb_, :tb_]
    zwb = complex(np.exp(-2j * np.pi * 0.1 / mb_))
    calls["czt bluestein"] = lambda: spec.czt(xb, mb_, zwb, za)
    zb = calls["czt bluestein"]()
    routes["czt bluestein"] = last_choice("czt")
    # the analytic signal: exact FFT and the FIR (B8) on 16 x 2^22, exact on one 2^26 stream
    calls["hilbert fft"] = lambda: spec.hilbert(x16, method="fft")
    zf = calls["hilbert fft"]()
    routes["hilbert fft"] = last_choice("hilbert")
    calls["hilbert fir"] = lambda: spec.hilbert(x16, method="fir")
    zr = calls["hilbert fir"]()
    routes["hilbert fir"] = last_choice("hilbert")
    calls["hilbert fft 2^26"] = lambda: spec.hilbert(xl, method="fft")
    zl = calls["hilbert fft 2^26"]()
    routes["hilbert fft 2^26"] = last_choice("hilbert")
    # overlap-save convolution: B8 at 257 taps, B9 at 8194
    taps = {k: (rng.standard_normal(k) / np.sqrt(k)).astype(np.float32) for k in OA_TAPS}
    oa = {}
    for k in OA_TAPS:
        calls[f"oaconvolve {k}"] = lambda k=k: cor.oaconvolve(x16, taps[k])
        oa[k] = calls[f"oaconvolve {k}"]()
        routes[f"oaconvolve {k}"] = last_choice("fir_filter")
    # the radar matched filter: complex correlation, valid mode, by each route
    radar = {}
    for route in ("auto", "direct_gauss", "xla"):
        calls[f"correlate_complex {route}"] = lambda route=route: cor.correlate_complex(
            ar, ai, vr, vi, "valid", method=route)
        radar[route] = calls[f"correlate_complex {route}"]()
        routes[f"correlate_complex {route}"] = last_choice("correlate_complex")
    # pitch shift on tones: the stretch, then the Farrow resampler (B21)
    calls["pitch_shift"] = lambda: pv.pitch_shift(xp, PITCH_FACTOR)
    ps_ = calls["pitch_shift"]()
    routes["pitch_shift"] = last_choice("resample_farrow")
    torch.cuda.synchronize()
    launches = launch_counts()

    want_routes = {
        "czt matmul": "matmul", "czt bluestein": "bluestein", "hilbert fft": "fft",
        "hilbert fir": "fir", "hilbert fft 2^26": "fft", "oaconvolve 257": "overlap_save_fused",
        "oaconvolve 8194": "overlap_save_fused", "correlate_complex auto": "direct",
        "correlate_complex direct_gauss": "direct_gauss", "correlate_complex xla": "fft",
        "pitch_shift": "segmented",
    }
    print(f"[9 spectral] routes {routes}; launches {launches}")
    if routes != want_routes:
        raise AssertionError(f"routes {routes}; want {want_routes}")
    if min(launches[k] for k in ("B8", "B9", "B21")) < 1:
        raise AssertionError(f"B8, B9 or B21 was not launched: {launches}")

    # checks against float64 on the host
    x0 = x[0].double().cpu().numpy()
    y0 = y[0].double().cpu().numpy()
    w = spec.spectral_window("sqrt_hann", SPEC_NFFT).astype(np.float64)
    close("stft (channel 0, 256 frames)", s[0, :256], stft64(x0, SPEC_NFFT, SPEC_HOP, w, 256))
    inner = slice(SPEC_NFFT, SPEC_T - SPEC_NFFT)
    close("istft(stft) interior", yr[:, inner], x[:, inner].double().cpu().numpy())
    kw = dict(nperseg=SPEC_NFFT, noverlap=SPEC_NFFT - SPEC_HOP, window="hann", detrend=False)
    close("welch (channel 0)", pw[0], sps.welch(x0, **kw)[1])
    csd64 = sps.csd(x0, y0, **kw)[1]
    close("csd real (channel 0)", pc[0].real, csd64.real)
    close("csd imag (channel 0)", pc[0].imag, csd64.imag, SPEC_RTOL * np.abs(csd64).max() / np.abs(csd64.imag).max())
    close("coherence (channel 0)", ch[0], sps.coherence(x0, y0, **kw)[1])
    hann = spec.spectral_window("hann", MFCC_NFFT).astype(np.float64)
    p64 = np.abs(stft64(x0, MFCC_NFFT, MFCC_HOP, hann, 512)) ** 2
    fb = mel.mel_filterbank(MFCC_MELS, MFCC_NFFT, MFCC_RATE).astype(np.float64)
    c64 = np.log(np.maximum(p64 @ fb.T, 1e-10)) @ mel.dct_matrix(MFCC_COEFS, MFCC_MELS).astype(np.float64).T
    close("mfcc (channel 0, 512 frames; TF32 on)", cm[0, :512], c64)
    zc64 = sps.czt(xc[0].double().cpu().numpy(), m_, zw, za)
    close("czt matmul real (channel 0; TF32 on)", zc[0].real, zc64.real)
    close("czt matmul imag (channel 0; TF32 on)", zc[0].imag, zc64.imag)
    zb64 = sps.czt(xb[0].double().cpu().numpy(), mb_, zwb, za)
    close("czt bluestein real (channel 0)", zb[0].real, zb64.real)
    close("czt bluestein imag (channel 0)", zb[0].imag, zb64.imag)
    x16_0 = x16[0].double().cpu().numpy()
    ph = 2 * np.pi * np.outer(freqs.astype(np.float64), np.arange(HILB_T))
    tp64 = 2 * ((x16_0 @ np.cos(ph).T / HILB_T) ** 2 + (x16_0 @ np.sin(ph).T / HILB_T) ** 2)
    del ph
    close("tone_power (channel 0; TF32 on)", tp[0], tp64)
    h64 = sps.hilbert(x16_0)
    close("hilbert fft real (channel 0)", zf[0].real, h64.real)
    close("hilbert fft imag (channel 0)", zf[0].imag, h64.imag)
    hf = spec.design_hilbert_fir(513).astype(np.float64)
    d, npre = 256, 1 << 16
    close("hilbert fir imag (channel 0, 2^16 samples)", zr[0, :npre].imag,
          np.convolve(x16_0[: npre + d], hf)[d : d + npre], FIR64_RTOL)
    if not torch.equal(zr.real, x16):
        raise AssertionError("hilbert fir: the real part is not the input")
    import scipy.fft as sfft

    xl64 = xl.double().cpu().numpy()
    spec64 = sfft.fft(xl64, workers=8)
    spec64[1 : HILB_LONG // 2] *= 2.0
    spec64[HILB_LONG // 2 + 1 :] = 0.0
    hl64 = sfft.ifft(spec64, workers=8)
    del spec64
    close("hilbert fft 2^26 real", zl.real, hl64.real)
    close("hilbert fft 2^26 imag", zl.imag, hl64.imag)
    del hl64, xl64
    for k in OA_TAPS:
        full64 = np.convolve(x16_0[:npre], taps[k].astype(np.float64))[:npre]
        close(f"oaconvolve {k} (channel 0, first 2^16)", oa[k][0, :npre], full64, FIR64_RTOL)
        tail64 = fir64_tail(torch.nn.functional.pad(x16[:1], (0, k - 1)), taps[k], 4096)
        close(f"oaconvolve {k} (channel 0, last 4096)", oa[k][:1, -4096:], tail64, FIR64_RTOL)
    a0 = ar[0].double().cpu().numpy()[: 1 << 14] + 1j * ai[0].double().cpu().numpy()[: 1 << 14]
    r64 = np.correlate(a0, chirp, "valid")
    for route, (rr, ri) in radar.items():
        close(f"correlate_complex {route} real (pulse 0)", rr[0, : r64.size], r64.real)
        close(f"correlate_complex {route} imag (pulse 0)", ri[0, : r64.size], r64.imag)
    # pitch shift: the card, and the CPU on a prefix, against float64 over the first
    # 2^16 outputs (about 150 frames), within PITCH_RTOL
    up, down = fw.as_rational_rate(1 / PITCH_FACTOR)
    pre = xp[:, :PITCH_PREFIX].cpu()
    st64 = torch.from_numpy(ts64(pre.numpy(), 1 / PITCH_FACTOR, STRETCH_NFFT))
    ps64 = farrow64(st64, up, down, npre)
    close("pitch_shift (first 2^16 outputs)", ps_[:, :npre], ps64, PITCH_RTOL)
    close("pitch_shift on the CPU (first 2^16 outputs)", pv.pitch_shift(pre, PITCH_FACTOR)[:, :npre],
          ps64, PITCH_RTOL)
    print(
        f"[9 spectral] stft/istft and welch/csd/coherence on {SPEC_C} x 2^21, mfcc ({MFCC_MELS} mels, "
        f"{MFCC_COEFS} coefficients), czt at {CZT_MATMUL} and {CZT_BLUESTEIN} (channels, t, m), "
        f"tone_power, hilbert fft and fir on {HILB_C} x 2^22 and fft on 2^26, oaconvolve at "
        f"{OA_TAPS} taps on {HILB_C} x 2^22, correlate_complex valid {RADAR_PULSES} x 2^20 with a "
        f"{RADAR_PULSE_LEN}-sample chirp by auto, direct_gauss and the FFT, pitch_shift by 2^(3/12) "
        f"on {PITCH_C} x 2^22 tones; against float64 (x max|want|; bound {SPEC_RTOL}, FIR "
        f"{FIR64_RTOL}, pitch_shift {PITCH_RTOL}): "
        + "; ".join(f"{k} {v:.2e}" for k, v in errs.items())
    )
    return calls


def call_times(label: str, calls: dict) -> None:
    """Each call of a main path: wall ms (synchronized, median of 3 after a warm-up)
    and device ms under torch.profiler (one call after lead kernels)."""
    print(f"[{label}] wall ms median of 3 after a warm-up; device ms of one profiled call:")
    for name, fn in calls.items():
        fn()
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        _, dev_ms, rows = profiled(fn)
        ours = sum(r[2] for r in rows if r[0].startswith(OURS))
        top = max(rows, key=lambda r: r[2]) if rows else ("none", 0, 0.0)
        print(f"  {name:32s} wall {statistics.median(walls):9.3f} ms; device {dev_ms:9.3f} ms in "
              f"{sum(r[1] for r in rows):4d} kernels ({ours:.3f} ms in the package's); largest "
              f"{top[2]:.3f} ms {top[0][:50]}")


def served_time_stretch(paths, out: Path) -> tuple[int, np.ndarray]:
    """``stream_time_stretch`` of the WAVs at phase 9's rate and nfft on the card:
    (frames written, the served WAV as (2, frames) float64 in [-1, 1))."""
    written = stream_time_stretch(paths, out, STRETCH_RATE, nfft=STRETCH_NFFT,
                                  chunk_samples=1 << 20, device="cuda")
    return written, read_wav(out)[1].reshape(-1, 2).T.astype(np.float64) / 32768.0


def loop_stream(wav: np.ndarray) -> np.ndarray:
    """The stream ``stream_time_stretch`` processes for an interleaved stereo ``wav``
    in chunks of 2^20: primed with nfft - ha zeros, the loader's zero-padded last
    chunk, the remainder zero-padded to a hop; (2, n) float32."""
    ha = round(STRETCH_NFFT // 4 * STRETCH_RATE)
    frames = -(-wav.size // (1 << 20)) * (1 << 20) // 2
    frames = -(-frames // ha) * ha
    seen = np.zeros((2, STRETCH_NFFT - ha + frames), np.float32)
    seen[:, STRETCH_NFFT - ha : STRETCH_NFFT - ha + wav.size // 2] = (
        wav.reshape(-1, 2).T.astype(np.float32) / 32768.0)
    return seen


def int16_scaled(y: np.ndarray) -> np.ndarray:
    """Float samples rounded to int16 and back, as the serving loop writes them."""
    return np.clip(np.rint(y.astype(np.float64) * 32768.0), -32768, 32767) / 32768.0


def phase_spectral_serve(wav: np.ndarray, split: int) -> None:
    """stream_mfcc and stream_time_stretch over phase 4's two stereo WAVs: wall ms (3
    runs) and the device time and idle share of a profiled run; the MFCC stream
    against one shot, and the time stretch against one shot on two WAVs of tones
    (on noise the phase wrap flips bins, whose later frames then differ by O(1))."""
    with tempfile.TemporaryDirectory() as tmp:
        paths = [Path(tmp) / "a.wav", Path(tmp) / "b.wav"]
        write_wav(paths[0], wav[:split], 48000, 2)
        write_wav(paths[1], wav[split:], 48000, 2)
        frames = wav.size // 2
        pcm = wav.reshape(-1, 2).T.astype(np.float32) / 32768.0
        reset_launch_counts()
        feats = stream_mfcc(paths, chunk_samples=1 << 20, device="cuda")
        hop = 256
        primed = np.pad(pcm, ((0, 0), (512 - hop, (-frames) % hop)))
        one = mel.mfcc(torch.from_numpy(primed).cuda(), sample_rate=48000.0, n_mfcc=13, nfft=512,
                       hop=hop, n_mels=40)
        e_mfcc = host_rel(torch.from_numpy(feats), one.double().cpu().numpy())
        if not (feats.shape == tuple(one.shape) and e_mfcc <= SPEC_RTOL):
            raise AssertionError(f"stream_mfcc: {feats.shape} against one shot {tuple(one.shape)}, "
                                 f"{e_mfcc:.3e}")
        out = Path(tmp) / "ts.wav"
        written, served = served_time_stretch(paths, out)
        seen = loop_stream(wav)
        want_frames = (seen.shape[1] - STRETCH_NFFT) // round(STRETCH_NFFT // 4 * STRETCH_RATE) * (
            STRETCH_NFFT // 4) + STRETCH_NFFT  # whole hops of the stream and a frame's tail
        if served.shape != (2, want_frames) or written != want_frames or not np.isfinite(served).all():
            raise AssertionError(f"stream_time_stretch: {served.shape}, {written}; want {want_frames}")
        one_ts = int16_scaled(pv.time_stretch(torch.from_numpy(seen).cuda(), STRETCH_RATE,
                                              nfft=STRETCH_NFFT).cpu().numpy())
        y64 = int16_scaled(ts64(seen, STRETCH_RATE, STRETCH_NFFT))
        m64 = mag_frames(y64)
        e_one, e_served = host_rel(mag_frames(one_ts), m64), host_rel(mag_frames(served), m64)
        # tones: the served stream and one shot against float64 by their magnitude
        # spectrograms, up to the fade-out. A bin's synthesis phase integrates its whole
        # history, so a wrap that two float32 evaluations round apart while the bin is
        # weak shifts that bin's phase for the rest of the stream, which the magnitudes
        # do not see; where weak bins grow strong (the fade-out), the wrap makes the
        # algorithm discontinuous in its input (on the CPU a 1e-7 relative change of the
        # input moved samples there by 15 LSB), so that span is not compared. A tone a
        # channel half a bin off the centres of nfft 2048 (no bin's increment at ha = 640
        # near the half turn while the tone dominates it), faded in and out by raised
        # cosines of 8192 samples; the second file of an odd frame count
        n = np.arange((1 << 21) - 1)
        fade = np.minimum(1.0, np.minimum(n, n.size - 1 - n) / 8192.0)
        fade = 0.5 - 0.5 * np.cos(np.pi * fade)
        tone_wav = np.stack([0.7 * fade * np.sin(2 * np.pi * (b + 0.5) * n / STRETCH_NFFT)
                             for b in (60, 131)])
        tone_wav = np.round(32768 * tone_wav).astype(np.int16).T.reshape(-1)
        tpaths = [Path(tmp) / "ta.wav", Path(tmp) / "tb.wav"]
        write_wav(tpaths[0], tone_wav[: 1 << 21], 48000, 2)
        write_wav(tpaths[1], tone_wav[1 << 21 :], 48000, 2)
        _, tserved = served_time_stretch(tpaths, Path(tmp) / "tts.wav")
        tseen = loop_stream(tone_wav)
        tone_one = int16_scaled(pv.time_stretch(torch.from_numpy(tseen).cuda(), STRETCH_RATE,
                                                nfft=STRETCH_NFFT).cpu().numpy())
        ha = round(STRETCH_NFFT // 4 * STRETCH_RATE)
        keep = int((STRETCH_NFFT - ha + n.size - 8192) / STRETCH_RATE) - 2 * STRETCH_NFFT
        t64 = mag_stft(int16_scaled(ts64(tseen, STRETCH_RATE, STRETCH_NFFT))[:, :keep])
        e_tone_served = host_rel(mag_stft(tserved[:, :keep]), t64)
        e_tone_one = host_rel(mag_stft(tone_one[:, :keep]), t64)
        if not (e_tone_served <= PITCH_RTOL and e_tone_one <= PITCH_RTOL):
            raise AssertionError(f"stream_time_stretch on tones: magnitude spectrogram {e_tone_served:.3e} "
                                 f"from float64, one shot {e_tone_one:.3e} (bound {PITCH_RTOL})")
        launches = {k: v for k, v in launch_counts().items() if v}
        print(f"[9 spectral serve] {wav.size} samples (stereo, 48 kHz) in chunks of 2^20: "
              f"stream_mfcc {feats.shape} within {e_mfcc:.2e} of one shot; stream_time_stretch "
              f"rate {STRETCH_RATE}, nfft {STRETCH_NFFT}: {written} frames, finite; magnitude "
              f"spectrogram (2048-sample frames) against float64: served {e_served:.3e}, one shot "
              f"{e_one:.3e} (noise: not bounded); on 2 x 2^21 tones up to the fade-out ({keep} of "
              f"{tserved.shape[1]} frames), by the magnitude spectrogram (hann, 2048, hop 512) "
              f"against float64: served {e_tone_served:.2e}, one shot "
              f"{e_tone_one:.2e} (bound {PITCH_RTOL}); package kernels launched {launches or 'none'}")

        loops = {
            "stream_mfcc": lambda: stream_mfcc(paths, chunk_samples=1 << 20, device="cuda"),
            "stream_time_stretch": lambda: served_time_stretch(paths, out),
        }
        for name, fn in loops.items():
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            wall, dev_ms, rows = profiled(fn)
            print(f"  {name}: wall " + ", ".join(f"{v:.1f}" for v in walls)
                  + f" ms; profiled wall {wall:.1f} ms, device {dev_ms:.3f} ms, device idle "
                  f"{1 - dev_ms / wall:.3f}; lead records lost {profiled.last}")
            for key, count, ms in rows[:8]:
                print(f"    {ms:9.3f} ms  {count:5d} x  {key[:80]}")


# Phase 10: the model families at the reference's family-row shapes
# (BENCH_NOTES.md:502, :758-763; benchmarks/r5_family_rows.py)
MODEL_RADAR = radar.RadarConfig(n_pulses=64, n_range=1 << 20, pulse_len=128)
MODEL_RADAR_TARGETS = ((100_000, 0.25, 1.0), (524_288, -0.125, 0.6), (900_001, 0.0625, 0.4))
MODEL_RADAR_NOISE = 0.05
MODEL_TRACK_CPIS = 16
MODEL_TRACK_CPU_CPIS = 4  # the CPU's cut: the first 4 of the 16 CPIs
MODEL_TRACK_RADAR = radar.RadarConfig(n_pulses=64, n_range=16384, pulse_len=128, guard=(2, 4),
                                      train=(4, 16))
MODEL_TRACKER = tracking.TrackerConfig(max_tracks=16, max_meas=4, vel_scale=64.0)
MODEL_MODEM_PAYLOAD = 65536
MODEL_OFDM = ofdm.OfdmConfig(n_fft=1024, cp=64, n_symbols=512, active=768)
MODEL_OFDM_BURSTS = 8
MODEL_BEAM_ROWS = ((16, 64, "mvdr"), (64, 16, "mvdr"), (64, 16, "music"))  # (M, blocks, method)
MODEL_BEAM_SNAPS = 16384
MODEL_BEAM_TRUTH = np.array([-12.0, 23.0])
MODEL_TOL = 1e-5  # card against the CPU: maps, spectra, symbols, positions, of max|want|
MODEL_MUSIC_TOL = 2e-4  # MUSIC: float32 eigenvectors from two solvers
MODEL_DET_MARGIN = radar.DETECTION_MARGIN  # detections compared outside this margin
MODEL_BER_CEILING = 1e-3


def radar_echo(cfg, targets, noise_power: float, gen, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """``radar.synthesize``'s echo built on the card: each target's chirp train added in
    place, then complex noise from PyTorch's generator ``gen``."""
    pr, pi_ = radar.lfm_pulse(cfg)
    pulse = pr.astype(np.float64) + 1j * pi_.astype(np.float64)
    i = torch.zeros(cfg.n_pulses, cfg.n_range, device=dev)
    q = torch.zeros_like(i)
    for rbin, fd, amp in targets:
        e = amp * np.outer(np.exp(2j * np.pi * fd * np.arange(cfg.n_pulses)), pulse)
        i[:, rbin : rbin + cfg.pulse_len] += torch.from_numpy(e.real.astype(np.float32)).to(dev)
        q[:, rbin : rbin + cfg.pulse_len] += torch.from_numpy(e.imag.astype(np.float32)).to(dev)
    sigma = float(np.sqrt(noise_power / 2.0))
    i += sigma * torch.randn(i.shape, generator=gen, device=dev)
    q += sigma * torch.randn(q.shape, generator=gen, device=dev)
    return i, q


def track_scene(n_cpis: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The tracking row's CPIs (r5_family_rows.py:279-300): three targets moving at
    their Doppler's velocity, noise 0.05, CPI c seeded c; and the truth at the last CPI."""
    cfg = MODEL_TRACK_RADAR
    i = np.empty((n_cpis, cfg.n_pulses, cfg.n_range), np.float32)
    q = np.empty_like(i)
    for c in range(n_cpis):
        targets = [(500 + round(1.28 * c), 0.02, 4.0), (1200 - round(1.92 * c), -0.03, 3.0),
                   (900, 0.0, 3.5)]
        i[c], q[c] = radar.synthesize(cfg, targets, noise_power=0.05, seed=c)
    last = n_cpis - 1
    return i, q, np.array([500 + round(1.28 * last), 1200 - round(1.92 * last), 900.0])


def ofdm_bursts() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The OFDM row's bursts (r5_family_rows.py:134-170): each delayed by 13 + b samples,
    turned by 1.1e-4 cycles/sample, at 25 dB, padded to one length."""
    cfg, batch = MODEL_OFDM, MODEL_OFDM_BURSTS
    rng = np.random.default_rng(7)
    bi, bq, bits_all = [], [], []
    for b in range(batch):
        bits = rng.integers(0, 2, 2 * cfg.active * cfg.n_symbols)
        ti, tq = ofdm.ofdm_modulate(cfg, bits)
        x = ti.astype(np.float64) + 1j * tq.astype(np.float64)
        x = np.concatenate([np.zeros(13 + b, complex), x, np.zeros(64, complex)])
        x = x * np.exp(1j * 2 * np.pi * 1.1e-4 * np.arange(x.size))
        noise = rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size)
        x = x + 10 ** (-25 / 20) * noise / np.sqrt(2)
        x = np.concatenate([x, np.zeros(batch - 1 - b, complex)])
        bi.append(x.real.astype(np.float32))
        bq.append(x.imag.astype(np.float32))
        bits_all.append(bits)
    return np.stack(bi), np.stack(bq), np.stack(bits_all)


def same_detections(det, power, thresh, want_det) -> int:
    """Detections equal to ``want_det`` outside MODEL_DET_MARGIN of the threshold
    (ROADMAP H5); returns the cells inside the margin."""
    inside = radar.near_threshold(power.cpu(), thresh.cpu(), MODEL_DET_MARGIN)
    if not torch.equal(det.cpu()[~inside], want_det.cpu()[~inside]):
        raise AssertionError("[10 models] detections differ outside the H5 margin")
    return int(inside.sum())


def phase_models_main(dev) -> dict:
    """The model families through their entry points at the family-row shapes, TF32 on,
    counts reset around: each against the reference's anchor and the port on the CPU."""
    errs, notes, calls = {}, [], {}

    def close(name: str, got, want, rtol: float = MODEL_TOL) -> None:
        g, w = got.detach().double().cpu(), want.detach().double().cpu()
        if g.shape != w.shape:
            raise AssertionError(f"[10 models] {name}: shape {tuple(g.shape)}, want {tuple(w.shape)}")
        errs[name] = e = float((g - w).abs().max() / w.abs().max())
        if not e <= rtol:  # also fails on NaN
            raise AssertionError(f"[10 models] {name}: {e:.3e} of max|want| > {rtol}")

    def launched(before: dict) -> dict:
        torch.cuda.synchronize()
        return {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ri, rq = radar_echo(MODEL_RADAR, MODEL_RADAR_TARGETS, MODEL_RADAR_NOISE, gen, dev)
    ti, tq, truth = track_scene(MODEL_TRACK_CPIS)
    ti_d, tq_d = torch.from_numpy(ti).to(dev), torch.from_numpy(tq).to(dev)
    mcfg = {t: modem.ModemConfig(bits_per_symbol=4, sps=8, tracker=t) for t in ("dd", "vv")}
    mbits = np.random.default_rng(5).integers(0, 2, MODEL_MODEM_PAYLOAD * 4)
    mi, mq = modem.channel(*modem.transmit(mcfg["dd"], mbits, device=dev), delay=37, cfo=2.4e-4,
                           phase=0.8, symbol_snr_db=22.0, seed=1)
    mi_d, mq_d = torch.from_numpy(mi).to(dev), torch.from_numpy(mq).to(dev)
    oi, oq, obits = ofdm_bursts()
    oi_d, oq_d = torch.from_numpy(oi).to(dev), torch.from_numpy(oq).to(dev)
    beams = []
    for m, blocks, method in MODEL_BEAM_ROWS:
        bcfg = beamform.ArrayConfig(n_sensors=m)
        snaps = [beamform.synthesize(bcfg, MODEL_BEAM_TRUTH, MODEL_BEAM_SNAPS, snr_db=10.0, seed=b)
                 for b in range(blocks)]
        beams.append((bcfg, method, np.stack([s[0] for s in snaps]), np.stack([s[1] for s in snaps])))
    torch.cuda.synchronize()

    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")  # TF32 on: the families' products pin IEEE float32
    try:
        reset_launch_counts()
        before = launch_counts()
        # radar: one CPI of 64 x 2^20, pulse 128 (BENCH_NOTES.md:502)
        calls["radar detect 64 x 2^20"] = lambda: radar.detect(MODEL_RADAR, ri, rq)
        det, power, thresh = calls["radar detect 64 x 2^20"]()
        for rbin, fd, _ in MODEL_RADAR_TARGETS:
            row = MODEL_RADAR.n_pulses // 2 + round(fd * MODEL_RADAR.n_pulses)
            if not bool(det[row, rbin]):
                raise AssertionError(f"[10 models] radar target at ({row}, {rbin}) not detected")
        if not bool(torch.isfinite(power).all() and torch.isfinite(thresh).all()):
            raise AssertionError("[10 models] radar power or threshold not finite")
        notes.append(f"radar: the 3 targets detected at their cells, {int(det.sum())} detections "
                     f"in {det.numel()} cells (pfa {MODEL_RADAR.pfa})")
        del det, power, thresh
        # tracking: 16 CPIs of 64 x 16384 (r5_family_rows.py:279-300)
        calls["track_detections 16 x 64 x 16384"] = lambda: tracking.track_detections(
            MODEL_TRACK_RADAR, MODEL_TRACKER, ti_d, tq_d)
        state, _ = calls["track_detections 16 x 64 x 16384"]()
        conf = (state.active & (state.hits >= MODEL_TRACKER.confirm_hits)).cpu().numpy()
        pos = state.x[:, 0].cpu().numpy()[conf]
        terr = [float(np.min(np.abs(pos - t))) if pos.size else np.inf for t in truth]
        if not max(terr) <= 0.5:
            raise AssertionError(f"[10 models] tracks off the targets: {terr} bins")
        notes.append(f"tracking: {int(conf.sum())} confirmed tracks, per-target error "
                     f"{np.round(terr, 4).tolist()} bins (bound 0.5)")
        radar_launches = launched(before)
        # modem: 16QAM, 65536 payload symbols, sps 8, delay 37, cfo 2.4e-4, 22 dB, both trackers
        before = launch_counts()
        rx_bits, rx_diag = {}, {}
        for t, cfg in mcfg.items():
            calls[f"modem receive {t}"] = lambda cfg=cfg: modem.receive(
                cfg, mi_d, mq_d, MODEL_MODEM_PAYLOAD)
            rx_bits[t], rx_diag[t] = calls[f"modem receive {t}"]()
        modem_launches = launched(before)
        ber = {t: float((b.cpu().numpy() != mbits).mean()) for t, b in rx_bits.items()}
        if not max(ber.values()) < MODEL_BER_CEILING:
            raise AssertionError(f"[10 models] modem BER {ber}")
        eq, pre_c, _ = modem._equalized(mcfg["dd"], mi_d, mq_d, MODEL_MODEM_PAYLOAD)
        known = modem._known(pre_c, MODEL_MODEM_PAYLOAD)
        calls["modem DD loop alone"] = lambda: modem._dd_phase_track(eq, *known, 4, 32)
        dd = rx_diag["dd"]
        notes.append(f"modem: BER dd {ber['dd']}, vv {ber['vv']} (ceiling {MODEL_BER_CEILING}); "
                     f"evm dd {float(dd['evm']):.4f}, frame start {int(dd['frame_start'])}, "
                     f"timing phase {int(dd['timing_phase'])}")
        # OFDM: 8 bursts, nfft 1024, cp 64, 512 symbols, 768 active, 25 dB, one call
        before = launch_counts()
        orx = ofdm.OfdmReceiver(MODEL_OFDM, device=dev)
        calls["ofdm 8 bursts"] = lambda: orx.demodulate(oi_d, oq_d, *orx.synchronize(oi_d, oq_d))
        o_d, o_cfo = orx.synchronize(oi_d, oq_d)
        o_er, o_ei = orx.demodulate(oi_d, oq_d, o_d, o_cfo)
        ofdm_launches = launched(before)
        sym = o_er.cpu().numpy() + 1j * o_ei.cpu().numpy()
        o_ber = float((ofdm.qpsk_demod(sym).reshape(obits.shape) != obits).mean())
        if not o_ber < MODEL_BER_CEILING:
            raise AssertionError(f"[10 models] OFDM BER {o_ber}")
        notes.append(f"ofdm: BER {o_ber} over {MODEL_OFDM_BURSTS} bursts, timing {o_d.tolist()}")
        # beamform: spectrum_batch MVDR M=16 (64 x 16384), MVDR and MUSIC M=64 (16 x 16384)
        before = launch_counts()
        spectra = []
        for bcfg, method, xi, xq in beams:
            xi_d, xq_d = torch.from_numpy(xi).to(dev), torch.from_numpy(xq).to(dev)
            key = f"spectrum_batch {method} M={bcfg.n_sensors} ({xi.shape[0]} x {MODEL_BEAM_SNAPS})"
            calls[key] = lambda bcfg=bcfg, method=method, xi_d=xi_d, xq_d=xq_d: beamform.spectrum_batch(
                bcfg, xi_d, xq_d, method=method, n_sources=2)
            spec_d = calls[key]()
            angles = beamform.scan_angles(bcfg)
            derr = max(float(np.abs(beamform._pick_peaks(angles, s, 2) - MODEL_BEAM_TRUTH).max())
                       for s in spec_d.cpu().numpy())
            step = float(angles[1] - angles[0])
            if not derr <= step:
                raise AssertionError(f"[10 models] {key}: DOA error {derr} deg > a grid step {step}")
            notes.append(f"{key}: DOA error {derr:.4f} deg over every block (grid step {step})")
            spectra.append(spec_d)
        beam_launches = launched(before)
    finally:
        torch.set_float32_matmul_precision(saved)

    print(f"[10 models] launches: radar and tracking {radar_launches or 'none'}, modem (dd and vv) "
          f"{modem_launches}, OFDM {ofdm_launches}, beamform {beam_launches or 'none'}")
    if radar_launches or beam_launches or set(modem_launches) != {"B8"} or set(ofdm_launches) != {"B8"}:
        raise AssertionError("[10 models] the families launched other kernels than B8 by the "
                             "modem and the OFDM receiver")
    if modem_launches["B8"] != 4 or ofdm_launches["B8"] != 1:
        raise AssertionError(f"[10 models] B8: modem {modem_launches['B8']} (want 2 a call), OFDM "
                             f"{ofdm_launches['B8']} (want 1)")

    # the port on the CPU: tracking (and its radar) cut to the first 4 of the 16 CPIs; the
    # modem, the OFDM bursts and the beamform rows at full size
    cut = MODEL_TRACK_CPU_CPIS
    cdet = radar.detect_batch(MODEL_TRACK_RADAR, torch.from_numpy(ti[:cut]), torch.from_numpy(tq[:cut]))
    gdet = radar.detect_batch(MODEL_TRACK_RADAR, ti_d[:cut], tq_d[:cut])
    close("radar detect power (4 CPIs of 64 x 16384)", gdet[1], cdet[1])
    close("radar detect threshold (4 CPIs of 64 x 16384)", gdet[2], cdet[2])
    inside = same_detections(gdet[0], cdet[1], cdet[2], cdet[0])
    cstate, _ = tracking.track_detections(MODEL_TRACK_RADAR, MODEL_TRACKER,
                                          torch.from_numpy(ti[:cut]), torch.from_numpy(tq[:cut]))
    gstate, _ = tracking.track_detections(MODEL_TRACK_RADAR, MODEL_TRACKER, ti_d[:cut], tq_d[:cut])
    for name in ("active", "hits", "misses", "tid", "next_id"):
        if not torch.equal(getattr(gstate, name).cpu(), getattr(cstate, name)):
            raise AssertionError(f"[10 models] tracker {name} differs from the CPU's")
    close("tracker positions (4 CPIs)", gstate.x, cstate.x)
    for t, cfg in mcfg.items():
        cbits, cdiag = modem.receive(cfg, mi, mq, MODEL_MODEM_PAYLOAD, device="cpu")
        if not torch.equal(rx_bits[t].cpu(), cbits):
            raise AssertionError(f"[10 models] modem {t}: bits differ from the CPU's")
        for key in ("timing_phase", "frame_start"):
            if int(rx_diag[t][key]) != int(cdiag[key]):
                raise AssertionError(f"[10 models] modem {t}: {key} differs from the CPU's")
        for key in ("cfo_coarse", "cfo_fine_per_symbol", "evm"):
            errs[f"modem {t} {key} (abs)"] = e = abs(float(rx_diag[t][key]) - float(cdiag[key]))
            if not e <= MODEL_TOL:
                raise AssertionError(f"[10 models] modem {t} {key}: {e:.3e} from the CPU's")
    crx = ofdm.OfdmReceiver(MODEL_OFDM, device="cpu")
    c_d, c_cfo = crx.synchronize(torch.from_numpy(oi), torch.from_numpy(oq))
    c_er, c_ei = crx.demodulate(torch.from_numpy(oi), torch.from_numpy(oq), c_d, c_cfo)
    if not torch.equal(o_d.cpu(), c_d):
        raise AssertionError("[10 models] OFDM timing differs from the CPU's")
    close("ofdm cfo", o_cfo, c_cfo)
    close("ofdm symbols real", o_er, c_er)
    close("ofdm symbols imag", o_ei, c_ei)
    for (bcfg, method, xi, xq), spec_d in zip(beams, spectra):
        want = beamform.spectrum_batch(bcfg, torch.from_numpy(xi), torch.from_numpy(xq), method=method,
                                       n_sources=2)
        close(f"spectrum_batch {method} M={bcfg.n_sensors}", spec_d, want,
              MODEL_MUSIC_TOL if method == "music" else MODEL_TOL)
    for line in notes:
        print(f"[10 models] {line}")
    print(f"[10 models] against the port on the CPU with TF32 on at the card (x max|want|; bound "
          f"{MODEL_TOL}, MUSIC {MODEL_MUSIC_TOL}): " + "; ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"; detections equal outside the {MODEL_DET_MARGIN} margin ({inside} cells inside it); "
          "tracker ids, flags and hits, modem bits and integer diagnostics, OFDM timing equal")
    return calls


# Phase 11: the training path (models/adaptive.py, utils/checkpoint.py, the designer of
# ops/pfb_os.py) at full width
TRAIN_TAPS = 256  # a decaying random echo path
TRAIN_BATCH = (64, 16384)
TRAIN_STEPS = 200
TRAIN_CPU_STEPS = 20  # the CPU's cut: the first 20 of the 200 steps
TRAIN_WORLD1_STEPS = 5
TRAIN_RTOL = 1e-4  # card against the CPU after 20 steps, of max|true taps|: the FIR's sums
TRAIN_REC_MAX = 1e-3  # ||taps - true|| / ||true|| after the 200 steps
NLMS_P, NLMS_SHAPE = 256, (64, 65536)
RLS_P, RLS_SHAPE = 32, (64, 32768)
RLS_BIG_P, RLS_BIG_SHAPE = 240, (2, 4096)  # S2's block route, P's triangle in shared memory
RLS_HUGE_P, RLS_HUGE_SHAPE = 400, (2, 1024)  # past the triangle's shared limit (332 taps)
# S1-S3 of the previous designs (S1 a warp a stream, commit b2bd615; S2 and S3 commit f68d781;
# PERF.md §6, NVIDIA H100 80GB HBM3, 700.00 W)
RECURSION_EARLIER_MS = {"S1": 13.3592, "S2": 86.0704, "S2 p=240": 515.4058, "S3 n=8": 39.7884,
                        "S3 n=300": 1630.2509}
ADAPT_PREFIX = 2048
# S1 and S2 against their plain loops on the prefix: y and e of max|d|, w of max|w| (the
# same operations summed in other orders; tests/test_torch_adaptive_scan.py's emulations
# hold the kernels' order to plain within 1e-5 on the CPU)
ADAPT_RTOL = 1e-5
NLMS_ANCHOR, RLS_ANCHOR = 0.05, 5e-3  # max|w - h|, tests/test_models.py:232, :262-272
DESIGN_P = 8
# steps at each width: the reference's 600 at n = 8, where its anchors hold; n = 64 cut to
# 200 (a depth cut: each step is a launch-bound loop of about 320 small kernels)
DESIGN_STEPS = {8: 600, 64: 200}
DESIGN_NS = tuple(DESIGN_STEPS)
DESIGN_CPU_STEPS = 50  # card against the CPU after these steps, of max|h|
DESIGN_RTOL = 1e-5
DESIGN_GRAD_RTOL = 1e-4  # step 0's gradient through B20 against the plain route, of max|g|
DESIGN_TIMED_STEPS = 20
SM_CLOCK_HZ = 1.98e9


def echo_path(rng, dev, p: int, shape: tuple, noise: float, decay: float):
    """(h, x, d): a decaying random p-tap path, white x, d = h * x + noise, d by a
    float64 causal FIR on the card."""
    h = (rng.standard_normal(p) * np.exp(-np.arange(p) / decay)).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    n = torch.from_numpy(rng.standard_normal(shape)).to(dev)
    h64 = torch.from_numpy(h.astype(np.float64)).to(dev)
    xp = torch.nn.functional.pad(x.double()[:, None, :], (p - 1, 0))
    d = torch.nn.functional.conv1d(xp, h64.flip(0)[None, None, :])[:, 0, :]
    return h, x, (d + noise * n).float()


def ar1_path(rng, dev, p: int, shape: tuple, rho: float, decay: float):
    """(x, d): x_t = rho x_{t-1} + white (S1's correlations far from diagonal), d through
    a decaying random p-tap path by a float64 causal FIR on the card."""
    w = rng.standard_normal(shape)
    x = np.zeros(shape)
    for t in range(shape[1]):
        x[:, t] = w[:, t] + (rho * x[:, t - 1] if t else 0.0)
    h = torch.from_numpy(rng.standard_normal(p) * np.exp(-np.arange(p) / decay)).to(dev)
    xt = torch.from_numpy(x.astype(np.float32)).to(dev)
    xp = torch.nn.functional.pad(xt.double()[:, None, :], (p - 1, 0))
    return xt, torch.nn.functional.conv1d(xp, h.flip(0)[None, None, :])[:, 0, :].float()


def adaptive_bounds(kind: str, p: int, b: int, n: int) -> dict:
    """S1's or S2's least time by bytes and float32 operations (the contract's bound:
    the function's own work, not the block recursion's extra correlations), and the
    floor of its per-sample chain in the sample-by-sample order: each sample needs the
    taps the previous one left, through at least the dependent operations counted
    here, each 4 cycles or more (a shuffle or a barrier takes more) at 1.98 GHz.
    ``route`` is the chain of the design that runs: S1's block recursion, a
    subtraction, the division (a product and four FMAs, ``nlms_div``), the step's
    product, the next row's product and sum a sample, and a block's barrier, start
    sum and shuffle over its L samples; S2's warp
    route's four partials, shuffles and division, or its block route's lane sums,
    butterflies and three barriers."""
    r = -(-p // 32)
    by = 16 * b * n + 4 * b * p  # x, d read; y, e written; the taps
    out = {}
    if kind == "S1":
        flops = 6 * p * b * n  # w.u, u.u, the update: a multiply and an add each
        deps = 1 + r + 10 + 1 + 2 + 1 + 2  # shift, lane sum, butterfly, e, norm, g, w
        out["route"] = n * (1 + 5 + 1 + 2 + 3 / adaptive.NLMS_BLOCK) * 4 / SM_CLOCK_HZ * 1e3
    else:
        flops = (6 * p * p + 7 * p) * b * n  # P u, the pair updates and symmetrisation
        deps = 2 * r + 10 + 6 + 2  # P u, u.pu's butterflies, k, P's update, 2 barriers
        if p <= adaptive.RLS_WARP_TAPS:  # 2 x (quarter sums + 2 + a product), 2 shuffles,
            route = 2 * (-(-p // 4) + 3) + 2 + 1 + 1 + 4  # denom, k, the pair update
        else:  # 2 x (lane sums + a product + the butterfly), denom, k, the update, 3 barriers
            route = 2 * (r + 1 + 10) + 1 + 1 + 4 + 3
        out["route"] = n * route * 4 / SM_CLOCK_HZ * 1e3
    return {"bound": bound(by, flops, FP32_FLOPS_PER_S),
            "chain": n * deps * 4 / SM_CLOCK_HZ * 1e3, **out}


def stopband_db(h: np.ndarray, n: int) -> float:
    w = np.fft.rfft(h, 4096)
    f = np.linspace(0, 1, w.size)
    return float(20 * np.log10(np.max(np.abs(w[f > 2.2 / n])) / np.max(np.abs(w))))


def roundtrip_snr_db(h: np.ndarray, n: int, dev) -> float:
    """Full-band reconstruction through the port's bank (tests/test_pfb_os.py:40-52)."""
    d = n // 2
    k = h.size
    x = np.random.default_rng(2).normal(size=d * 4096).astype(np.float32)
    xt = torch.from_numpy(x).to(dev)
    yi, yq = pfb_analyze_os(xt, n, torch.from_numpy(h).to(dev))
    rec = pfb_synthesize_os(yi, yq, n, torch.from_numpy(h * d).to(dev)).cpu().numpy()
    a, b = rec[k:], x[: rec.size - k]
    g = 2 * k
    err = a[g:-g] - b[g:-g]
    return float(10 * np.log10(np.sum(b[g:-g] ** 2) / np.sum(err ** 2)))


def phase_training_main(dev, tmp: str) -> dict:
    """The training path through its entry points with TF32 on and the counts reset
    around: identify_system, NLMS (S1), RLS (S2, both routes of P), the designer (B20
    forward and back every step); then the checks outside the counted run."""
    import torch.distributed as dist

    from digital_signal_processsing_tpu_torch import parallel as par

    rng = np.random.default_rng(11)
    check, notes, errs, calls = Checker(), [], {}, {}
    last = [time.perf_counter()]

    def tick(what: str) -> None:
        now = time.perf_counter()
        print(f"[11 training] {what}: {now - last[0]:.1f} s", flush=True)
        last[0] = now

    h_sys = (0.5 * rng.standard_normal(TRAIN_TAPS) * np.exp(-np.arange(TRAIN_TAPS) / 48.0)
             ).astype(np.float32)
    hN, xN, dN = echo_path(rng, dev, NLMS_P, NLMS_SHAPE, 0.01, 64.0)
    xA, dA = ar1_path(np.random.default_rng(12), dev, NLMS_P, (NLMS_SHAPE[0], ADAPT_PREFIX), 0.95,
                      64.0)
    hR, xR, dR = echo_path(rng, dev, RLS_P, RLS_SHAPE, 0.003, 8.0)
    hB, xB, dB = echo_path(rng, dev, RLS_BIG_P, RLS_BIG_SHAPE, 0.003, 48.0)
    _, xH, dH = echo_path(rng, dev, RLS_HUGE_P, RLS_HUGE_SHAPE, 0.003, 48.0)
    torch.cuda.synchronize()
    train_kw = dict(batch=TRAIN_BATCH, seed=3)
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")  # TF32 on: the port pins IEEE float32
    try:
        tick("inputs")
        reset_launch_counts()
        t0 = time.perf_counter()
        taps, loss = adaptive.identify_system(h_sys, steps=TRAIN_STEPS, **train_kw)
        train_wall = time.perf_counter() - t0
        tick("identify_system")
        designs, design_walls = {}, {}
        for n in DESIGN_NS:
            before = launch_counts()
            t0 = time.perf_counter()
            designs[n] = pfb_os.design_pr_prototype(n, DESIGN_P, steps=DESIGN_STEPS[n])
            design_walls[n] = time.perf_counter() - t0
            got = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
            if got != {"B20": DESIGN_STEPS[n]}:
                raise AssertionError(f"[11 training] design n={n}: launched {got}, want B20 "
                                     f"once a step ({DESIGN_STEPS[n]})")
        tick("design_pr_prototype")
        yN, eN, wN = adaptive.nlms(xN, dN, NLMS_P)
        yR, eR, wR = adaptive.rls(xR, dR, RLS_P, forget=0.999)
        yB, eB, wB = adaptive.rls(xB, dB, RLS_BIG_P, forget=0.999)
        torch.cuda.synchronize()
        launches = launch_counts()
    finally:
        torch.set_float32_matmul_precision(saved)
    print(f"[11 training] launches {{{', '.join(f'{k}: {v}' for k, v in launches.items() if v)}}}")
    want = {"B20": sum(DESIGN_STEPS.values()), "S1": 1, "S2": 2}
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"[11 training] launches {launches}, want {want}")

    # the echo path identified; the first 20 steps against the port on the CPU
    rec = float(np.linalg.norm(taps - h_sys) / np.linalg.norm(h_sys))
    notes.append(f"identify_system {TRAIN_TAPS} taps, {TRAIN_BATCH[0]} x {TRAIN_BATCH[1]}, "
                 f"{TRAIN_STEPS} steps: wall {train_wall:.2f} s, loss {loss:.3e}, max|taps - h| "
                 f"{np.abs(taps - h_sys).max():.3e}, ||taps - h|| / ||h|| {rec:.3e} (bound "
                 f"{TRAIN_REC_MAX})")
    if not rec <= TRAIN_REC_MAX:
        raise AssertionError(f"[11 training] echo path not identified: {rec:.3e}")
    tick("nlms and rls")
    cuda20, _ = adaptive.identify_system(h_sys, steps=TRAIN_CPU_STEPS, **train_kw)
    cpu20, _ = adaptive.identify_system(h_sys, steps=TRAIN_CPU_STEPS, device="cpu", **train_kw)
    tick("identify_system 20 steps on the card and the CPU")
    errs["identify_system 20 steps, card against the CPU (of max|h|)"] = e = float(
        np.abs(cuda20 - cpu20).max() / np.abs(h_sys).max())
    if not e <= TRAIN_RTOL:
        raise AssertionError(f"[11 training] 20 steps: card {e:.3e} of max|h| from the CPU")

    # the sharded step at world size 1 over NCCL: bit for bit the single step
    par.initialize_multihost(f"file://{tmp}/train.store", 1, 0, backend="nccl")
    try:
        step = adaptive.make_sharded_train_step(par.make_mesh(device="cuda"))
        sh = adaptive.identify_system(h_sys, steps=TRAIN_WORLD1_STEPS, train_step=step, **train_kw)
    finally:
        dist.destroy_process_group()
    one = adaptive.identify_system(h_sys, steps=TRAIN_WORLD1_STEPS, **train_kw)
    if not (np.array_equal(sh[0], one[0]) and sh[1] == one[1]):
        raise AssertionError("[11 training] the sharded step at world size 1 differs from the "
                             f"single step: {np.abs(sh[0] - one[0]).max():.3e}")
    notes.append(f"make_sharded_train_step at world size 1 (NCCL), {TRAIN_WORLD1_STEPS} steps: "
                 "taps and loss bit for bit the single step's")
    tick("world size 1")

    # S1 and S2 against their plain loops on the card over the prefix; the anchors
    pre = slice(0, ADAPT_PREFIX)
    for kernel, scan, plain, x, d, p, kw in (
        ("S1", adaptive.nlms_scan, adaptive._nlms_plain, xN, dN, NLMS_P, (0.5, 1e-6)),
        ("S1", adaptive.nlms_scan, adaptive._nlms_plain, xA, dA, NLMS_P, (0.5, 1e-6)),
        ("S2", adaptive.rls_scan, adaptive._rls_plain, xR, dR, RLS_P, (0.999, 1e2)),
        ("S2", adaptive.rls_scan, adaptive._rls_plain, xB, dB, RLS_BIG_P, (0.999, 1e2)),
        ("S2", adaptive.rls_scan, adaptive._rls_plain, xH, dH, RLS_HUGE_P, (0.999, 1e2)),
    ):
        xs, ds = x[:, pre].contiguous(), d[:, pre].contiguous()
        got, want = scan(xs, ds, p, *kw), plain(xs, ds, p, *kw)
        what = (f"{kernel} p={p} {x.shape[0]} x {ADAPT_PREFIX}"
                + (" AR(1)" if x is xA else "") + " against plain")
        check.close(kernel, got[0], want[0], what + " y", ADAPT_RTOL, scale_of=ds)
        check.close(kernel, got[1], want[1], what + " e", ADAPT_RTOL, scale_of=ds)
        check.close(kernel, got[2], want[2], what + " w", ADAPT_RTOL)
    for name, w, h, bound_ in (("nlms", wN, hN, NLMS_ANCHOR), ("rls p=32", wR, hR, RLS_ANCHOR),
                               ("rls p=240", wB, hB, RLS_ANCHOR)):
        errs[f"{name} max|w - h|"] = e = float((w.cpu() - torch.from_numpy(h)).abs().max())
        if not e < bound_:
            raise AssertionError(f"[11 training] {name}: max|w - h| {e:.3e} >= {bound_}")
    for name, y, e in (("nlms", yN, eN), ("rls p=32", yR, eR), ("rls p=240", yB, eB)):
        if not bool(torch.isfinite(y).all() and torch.isfinite(e).all()):
            raise AssertionError(f"[11 training] {name}: output not finite")

    tick("S1 and S2 against plain on the prefix")
    # the designer: step 0's gradient through B20 against autograd through the plain
    # route on the card; the card against the CPU; the reference's anchors at n=8
    for n in DESIGN_NS:
        x, m_cos, m_sin, h0 = pfb_os._design_setup(n, DESIGN_P, 0, dev)
        grads = []
        for fused in (True, False):
            h = h0.clone().requires_grad_()
            pfb_os._design_loss(h, x, n, m_cos, m_sin, 0.05, fused=fused).backward()
            grads.append(h.grad)
        check.close("B20", grads[0], grads[1], f"design n={n} step 0: the gradient through B20 "
                    "against the plain route", DESIGN_GRAD_RTOL)
        errs[f"design n={n} step-0 gradient, B20 against plain (of max|g|)"] = float(
            (grads[0] - grads[1]).abs().max() / grads[1].abs().max())
        snr, sb = roundtrip_snr_db(designs[n], n, dev), stopband_db(designs[n], n)
        notes.append(f"design_pr_prototype n={n}, P={DESIGN_P}, {DESIGN_STEPS[n]} steps: wall "
                     f"{design_walls[n]:.2f} s, reconstruction {snr:.2f} dB, stopband {sb:.2f} dB")
        if n == DESIGN_NS[0] and not (snr > 45 and sb < -25):
            raise AssertionError(f"[11 training] design n={n}: {snr:.2f} dB, stopband {sb:.2f} dB")
        if not np.isfinite(designs[n]).all():
            raise AssertionError(f"[11 training] design n={n}: taps not finite")
    hc = pfb_os.design_pr_prototype(DESIGN_NS[0], DESIGN_P, steps=DESIGN_CPU_STEPS)
    hh = pfb_os.design_pr_prototype(DESIGN_NS[0], DESIGN_P, steps=DESIGN_CPU_STEPS, device="cpu")
    errs[f"design n=8 {DESIGN_CPU_STEPS} steps, card against the CPU (of max|h|)"] = e = float(
        np.abs(hc - hh).max() / np.abs(hh).max())
    if not e <= DESIGN_RTOL:
        raise AssertionError(f"[11 training] design: card {e:.3e} of max|h| from the CPU")

    tick("the designer's checks")
    for line in notes:
        print(f"[11 training] {line}")
    print("[11 training] " + "; ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + "; S1/S2 against plain (max abs): " + ", ".join(
              f"{k} {check.max_err[k]:.3e}" for k in ADAPTIVE_KERNELS)
          + f"; B20's gradient {check.max_err['B20']:.3e}")

    # times: the kernels (median of 3 after a warm-up) beside their plain loops on the same
    # inputs (one call each: the loops launch about ten kernels a sample), bounds and chains
    fx = {
        "S1": (lambda: adaptive.nlms_scan(xN, dN, NLMS_P),
               lambda: adaptive._nlms_plain(xN, dN, NLMS_P, 0.5, 1e-6), NLMS_P, NLMS_SHAPE),
        "S2": (lambda: adaptive.rls_scan(xR, dR, RLS_P, 0.999),
               lambda: adaptive._rls_plain(xR, dR, RLS_P, 0.999, 1e2), RLS_P, RLS_SHAPE),
        "S2 p=240": (lambda: adaptive.rls_scan(xB, dB, RLS_BIG_P, 0.999),
                     lambda: adaptive._rls_plain(xB, dB, RLS_BIG_P, 0.999, 1e2), RLS_BIG_P,
                     RLS_BIG_SHAPE),
        "S2 p=400": (lambda: adaptive.rls_scan(xH, dH, RLS_HUGE_P, 0.999),
                     lambda: adaptive._rls_plain(xH, dH, RLS_HUGE_P, 0.999, 1e2), RLS_HUGE_P,
                     RLS_HUGE_SHAPE),
    }
    times = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"[11 training] times on {torch.cuda.get_device_name(0)}: device ms, median of 3 "
          "after a warm-up; plain one call; before: the previous design (PERF.md):")
    for key, (kfn, pfn, p, (b, n)) in fx.items():
        k_ms = statistics.median(device_ms(kfn, 1, 3))
        p_ms = device_ms(pfn, 0, 1)[0]
        bk = adaptive_bounds(key[:2], p, b, n)
        if key.startswith("S2"):
            g = adaptive.rls_geometry(p, b, sms)
            geo = f"route {g.name}, {g.threads} threads a block, {g.smem_bytes} shared bytes"
        else:
            g = adaptive.nlms_geometry(p, b)
            geo = (f"block length {adaptive.NLMS_BLOCK}, {g.ctas} CTAs of "
                   f"{adaptive.NLMS_THREADS} threads, "
                   f"{g.smem_bytes} shared bytes, ring {g.ring} and taps in "
                   f"{'shared' if g.shared else 'device'} memory")
        times[key] = {"ms": k_ms, "plain": p_ms, **bk}
        before = RECURSION_EARLIER_MS.get(key)
        print(f"  {key[:2]} p={p} {b} x {n}: {k_ms:.4f} ms"
              + (f" (before {before:.4f}, {before / k_ms:.1f}x)" if before else "")
              + f"; plain {p_ms:.2f} ms ({p_ms / k_ms:.0f}x); bound {bk['bound'][0]:.4f} "
              f"({bk['bound'][1]}); chain floor (sample by sample) {bk['chain']:.4f}, "
              f"kernel/chain {k_ms / bk['chain']:.2f}; the design's own chain "
              f"{bk['route']:.4f}, kernel/its chain {k_ms / bk['route']:.2f}"
              + f"; attrs (registers, local bytes, static shared, S1's block or S2's slots) "
              f"{adaptive.adaptive_kernel_attrs(key[:2], p)}; {geo}")
    b20 = {}
    for n in DESIGN_NS:
        x, m_cos, m_sin, h0 = pfb_os._design_setup(n, DESIGN_P, 0, dev)
        h = h0.clone().requires_grad_()
        hq = chz._phase_taps(h, n, x.device)
        w_lo = chz.commutate(x, n // 2)
        u = torch.cat([w_lo, torch.nn.functional.pad(w_lo[:-1], (0, 0, 1, 0))], 1).contiguous()
        with torch.no_grad():
            b20[n] = statistics.median(device_ms(
                lambda: chz.fused_branch_dft(u, hq.detach(), dilation=2, layout="channels"), 3, 10))
        print(f"  B20 in the designer n={n} ({u.shape[0]} x {n}, dilation 2): {b20[n]:.4f} ms")

    tick("times")
    fir_ = adaptive.AdaptiveFir.create(TRAIN_TAPS, device=dev)
    xb = torch.from_numpy(np.random.default_rng(4).normal(size=TRAIN_BATCH).astype(np.float32)).to(dev)
    db = adaptive._fir_batched(xb, torch.from_numpy(h_sys).to(dev)).detach()
    calls[f"lms_train_step {TRAIN_BATCH[0]} x {TRAIN_BATCH[1]}, {TRAIN_TAPS} taps"] = (
        lambda: adaptive.lms_train_step(fir_, xb, db))
    calls[f"nlms {NLMS_SHAPE[0]} x {NLMS_SHAPE[1]} p={NLMS_P}"] = fx["S1"][0]
    calls[f"rls {RLS_SHAPE[0]} x {RLS_SHAPE[1]} p={RLS_P}"] = fx["S2"][0]
    n = DESIGN_NS[0]  # the designer's steps are launch-bound alike at both widths
    calls[f"design_pr_prototype n={n} {DESIGN_TIMED_STEPS} steps"] = (
        lambda: pfb_os.design_pr_prototype(n, DESIGN_P, steps=DESIGN_TIMED_STEPS))
    return {"launches": launches, "check": check, "times": times, "calls": calls, "b20": b20}


# --- phase 12: the rest of the op surface and the scipy.signal facade -------------------

SURF_C, SURF_T = 16, 1 << 22  # the IIR benchmark point (BENCH_NOTES.md:149)
SURF_TAPS = 257
SURF_RTOL = 1e-4  # each facade output against scipy's float64 on channel 0, of max|want|
RANK_K = 5
WIENER_RTOL = 1e-5  # the card against the CPU, of max|y|
CWT_SHAPE, CWT_WIDTHS, CWT_SLICE = (4, 1 << 20), np.arange(1, 33), 4096
LOMB_N, LOMB_F, LOMB_CHECK = 16384, 4096, 256
PEAKS_T, PEAKS_PULSES, PEAKS_CWT_T, PEAKS_CWT_PULSES = 1 << 22, 64, 1 << 16, 40
TWOD_N, TWOD_CROP, SPLINE_N, SPLINE_EDGE = 4096, 256, 1024, 32
METRICS_T, METRICS_RTOL_DB = 1 << 20, 1e-3
METRICS_F0 = 12899 / METRICS_T  # on a bin: the window leaks nothing past the line
METRICS_CUBIC = 3e-3
LSIM_STATES, LSIM_T = 8, 1 << 20
DLSIM_CASES = ((8, 1, 1), (300, 2, 3))  # (n, p, q): S3's warp route; a cluster of CTAs
DLSIM_T, DLSIM_PLAIN, DLSIM_SCIPY = 65536, 2048, 4096
DLSIM_BIG, DLSIM_BIG_T = (1100, 1, 1), 2048  # past the cluster's shared memory: M from device memory
DLSIM_RTOL, DLSIM_SCIPY_RTOL = 1e-5, 1e-4
SURFACE_BUDGET_S = 60.0


def stable_system(rng, n: int, p: int, q: int, radius: float = 0.95):
    """A random discrete (A, B, C, D) in float64 with A's spectral radius ``radius``."""
    a = rng.standard_normal((n, n))
    a *= radius / np.max(np.abs(np.linalg.eigvals(a)))
    return (a, rng.standard_normal((n, p)) / np.sqrt(p), rng.standard_normal((q, n)) / np.sqrt(n),
            rng.standard_normal((q, p)))


def dlsim_bounds(n: int, p: int, q: int, t: int) -> dict:
    """S3's least time by bytes and float32 operations, and the floor of its step chain
    at 4 cycles a dependent operation, 1.98 GHz: the shorter of its two orders, the
    sequential row sum (n multiply-adds and the step's hand-over) and
    the split one (ceil(n / 32) lane sums, a product, the five-step butterfly, + bu,
    the hand-over to the peers and the wait on it); ``chain_before`` the sequential one's."""
    by = 4 * (t * (p + q + n) + n * n + n * p + q * n + q * p + n)
    flops = 2 * t * (n * n + n * p + q * n + q * p)
    before = t * (n + 1) * 4 / SM_CLOCK_HZ * 1e3
    split = t * (-(-n // 32) + 1 + 5 + 1 + 2) * 4 / SM_CLOCK_HZ * 1e3
    return {"bound": bound(by, flops, FP32_FLOPS_PER_S), "chain": min(before, split),
            "chain_before": before}


def f3_cases(dev) -> dict:
    """Each float kernel wrapper (B8-B19 but B20, B21, B22, S1-S3) as a function of
    one float input, the data, that the caller may mark as requiring a gradient."""
    from digital_signal_processsing_tpu_torch.ops import lti

    sos = iir.design_butterworth(4, 0.2)
    rows = torch.tensor([0.3, 0.1, 0.05, 1.25, -0.5, 0.2], device=dev)
    g5, g9 = (fm.fused_geometry(k, fm.pick_fused_block(k)) for k in (5, 8194))
    r5 = fm.tap_response(np.ones(5, np.float32), g5, dev)
    r9 = fm.tap_response(np.ones(8194, np.float32), g9, dev)
    hq = torch.ones(8, 64, device=dev)
    a_f, s0 = torch.full((4, 2), 0.1, device=dev), torch.zeros(4, 2, device=dev)
    m = (0.5 * torch.eye(3, device=dev), torch.ones(3, 1, device=dev), torch.ones(1, 3, device=dev),
         torch.ones(1, 1, device=dev))
    return {
        "B8": lambda x: fm.fused_fir(x, r5),
        "B9": lambda x: fm.fused_fir3(x, r9),
        "B10": lambda x: iir.iir1_block_scan(x, 0.5),
        "B11": lambda x: iir.iir1_affine_scan(x, 0.5),
        "B12": lambda x: iir.sos_cascade(x, sos),
        "B13": lambda x: iir.sos_cascade_unrolled(x, sos),
        "B14": lambda x: iir.sos_cascade_mxu(x, sos),
        "B15": lambda x: iir.sos_sections(x, sos),
        "B16": lambda x: iir.tv_cascade(x, rows.expand(1, 1, x.shape[1], 6).contiguous()),
        "B17": lambda x: iir.tv_section(x, rows.expand(1, 1, x.shape[1], 6).contiguous()),
        "B18": lambda x: iir.tv_frames_cascade(x, rows.expand(1, 1, x.shape[1] // 64, 6).contiguous(), 64),
        "B19": lambda x: chz.fused_pfb_raw(x.reshape(-1), 64, hq),
        "B21": lambda x: fw.resample_farrow_segmented(x, FARROW_MAIN_RATE),
        "B22": lambda x: lpc.lpc_synth_pass(a_f, s0, x.reshape(4, -1)),
        "S1": lambda x: adaptive.nlms_scan(x, x.detach(), 8),
        "S2": lambda x: adaptive.rls_scan(x, x.detach(), 8),
        "S3": lambda x: lti.dlsim_scan(*m, x.reshape(-1, 1), torch.zeros(3, device=dev)),
    }


def phase_surface_main(dev, stream: torch.Tensor) -> dict:
    """The rest of the op surface through its entry points (``compat`` and the new
    ops) at sizes their users call real, TF32 on and the counts reset around: the
    facade's filters (B12, B8), the rank filters, cwt and lombscargle, the peak
    finders, the 2-D filters and spline_filter, companding of ``stream`` (phase 4's
    64M int16 samples), the metrics, lsim and dlsim (S3); then S3's times and F3's
    refusals on the card. Returns the launches, the checker, S3's times and the calls."""
    from digital_signal_processsing_tpu_torch import compat
    from digital_signal_processsing_tpu_torch.ops import companding as cmp
    from digital_signal_processsing_tpu_torch.ops import lti, metrics, rank

    t_start = time.perf_counter()
    rng = np.random.default_rng(12)
    gen = torch.Generator(device=dev).manual_seed(12)
    check, errs, notes, calls = Checker(), {}, [], {}
    last = [t_start]

    def tick(what: str) -> None:
        now = time.perf_counter()
        print(f"[12 surface] {what}: {now - last[0]:.1f} s", flush=True)
        last[0] = now

    def close(name: str, got, want: np.ndarray, rtol: float = SURF_RTOL) -> None:
        errs[name] = e = host_rel(got, want)
        if not e <= rtol:  # also fails on NaN
            raise AssertionError(f"[12 surface] {name}: {e:.3e} of max|want| > {rtol}")

    # inputs: noise and tones on the card; the host streams of the peak finders
    n_idx = torch.arange(SURF_T, device=dev, dtype=torch.float32)
    x = 0.3 * torch.randn(SURF_C, SURF_T, generator=gen, device=dev)
    x += torch.sin(2 * np.pi * 0.013 * n_idx) + 0.5 * torch.sin(2 * np.pi * 0.31 * n_idx)
    sos = compat.butter(8, 0.1, output="sos")
    b_ba, a_ba = compat.butter(8, 0.1)
    h = compat.firwin(SURF_TAPS, 0.2)
    xc = x[: CWT_SHAPE[0], : CWT_SHAPE[1]].contiguous()
    tl = torch.sort(torch.rand(LOMB_N, generator=gen, device=dev) * 100.0).values
    yl = torch.sin(1.7 * tl) + 0.3 * torch.randn(LOMB_N, generator=gen, device=dev)
    fl = torch.linspace(0.01, 5.0, LOMB_F, device=dev)
    t_p = np.arange(PEAKS_T)
    xpk = 0.1 * rng.standard_normal(PEAKS_T)
    for p_, amp in zip(rng.choice(np.arange(200, PEAKS_T - 200), PEAKS_PULSES, replace=False),
                       rng.uniform(1.0, 3.0, PEAKS_PULSES)):
        xpk[p_ - 100 : p_ + 100] += amp * np.exp(-0.5 * ((t_p[p_ - 100 : p_ + 100] - p_) / 10.0) ** 2)
    pos_cwt = np.sort(rng.choice(np.arange(200, PEAKS_CWT_T - 200), PEAKS_CWT_PULSES, replace=False))
    t_c = np.arange(PEAKS_CWT_T)
    vcwt = 0.05 * rng.standard_normal(PEAKS_CWT_T)
    for p_ in pos_cwt:
        vcwt += np.exp(-0.5 * ((t_c - p_) / 8.0) ** 2)
    img = torch.randn(TWOD_N, TWOD_N, generator=gen, device=dev)
    k55 = rng.standard_normal((5, 5)).astype(np.float32)
    img_s = rng.standard_normal((SPLINE_N, SPLINE_N))
    A8 = -np.diag(np.linspace(0.5, 4.0, LSIM_STATES)) + 0.1 * rng.standard_normal((LSIM_STATES,) * 2)
    sys_c = (A8, rng.standard_normal((LSIM_STATES, 1)), rng.standard_normal((1, LSIM_STATES)),
             np.zeros((1, 1)))
    t_lsim = np.arange(LSIM_T) * 1e-3
    u_lsim = np.sin(2 * np.pi * 0.7 * t_lsim)
    dsys = {nq: stable_system(rng, *nq) for nq in (*DLSIM_CASES, DLSIM_BIG)}
    u_d = {nq: torch.randn(DLSIM_T if nq != DLSIM_BIG else DLSIM_BIG_T, nq[1], generator=gen,
                           device=dev) for nq in dsys}
    torch.cuda.synchronize()
    tick("inputs")

    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")  # TF32 on: the products pin IEEE float32
    try:
        reset_launch_counts()
        calls["sosfilt"] = lambda: compat.sosfilt(sos, x)
        calls["lfilter"] = lambda: compat.lfilter(b_ba, a_ba, x)
        calls["sosfiltfilt"] = lambda: compat.sosfiltfilt(sos, x)
        calls["filtfilt"] = lambda: compat.filtfilt(b_ba, a_ba, x)
        calls["decimate q=4 iir"] = lambda: compat.decimate(x, 4, ftype="iir")
        calls["oaconvolve 257"] = lambda: compat.oaconvolve(x, h)
        calls["convolve fft 257"] = lambda: compat.convolve(x, h, method="fft")
        calls["hilbert"] = lambda: compat.hilbert(x)
        calls["resample_poly 3/2"] = lambda: compat.resample_poly(x, 3, 2)
        calls["savgol_filter 31 3"] = lambda: compat.savgol_filter(x, 31, 3)
        out = {k: fn() for k, fn in calls.items()}
        facade = launch_counts()
        hilbert_route = last_choice("hilbert")
        calls["medfilt 5"] = lambda: compat.medfilt(x, RANK_K)
        calls["wiener 5"] = lambda: compat.wiener(x, RANK_K)
        calls["rank_filter 5 1"] = lambda: rank.rank_filter(x, RANK_K, 1)
        calls["cwt ricker 1..32"] = lambda: compat.cwt(xc, compat.ricker, CWT_WIDTHS)
        calls["lombscargle"] = lambda: compat.lombscargle(tl, yl, fl)
        calls["find_peaks 2^22"] = lambda: compat.find_peaks(xpk, height=0.8, prominence=0.5, width=3)
        calls["find_peaks_cwt 2^16"] = lambda: compat.find_peaks_cwt(vcwt, np.arange(4, 33, 2), device=dev)
        calls["convolve2d same symm"] = lambda: compat.convolve2d(img, k55, "same", "symm")
        calls["medfilt2d 5"] = lambda: compat.medfilt2d(img, 5)
        calls["spline_filter 1024"] = lambda: compat.spline_filter(img_s, device=dev)
        calls["mulaw round trip 64M"] = lambda: cmp.mulaw_decode(cmp.mulaw_encode(stream))
        calls["alaw round trip 64M"] = lambda: cmp.alaw_decode(cmp.alaw_encode(stream))
        for k in list(calls)[len(out):]:
            out[k] = calls[k]()
        torch.cuda.synchronize()
        tick("the facade and the new ops")
        # the metrics of an int16-quantised tone through the facade's sosfilt
        from digital_signal_processsing_tpu_torch.ops import signal as gen_ops

        tq = compat.sosfilt(compat.butter(4, 0.2, output="sos"),
                            gen_ops.tone(METRICS_F0, METRICS_T + 4096, amplitude=0.9, device=dev))
        tq = tq[4096:]  # past the filter's start-up
        # a converter's mild cubic distortion, so that THD and SFDR read harmonics above
        # the float32 FFT's floor, then int16 quantisation
        tq = torch.round((tq - METRICS_CUBIC * tq**3) * 32767.0) / 32767.0
        calls["tone_metrics 2^20"] = lambda: metrics.tone_metrics(tq)
        out["tone_metrics 2^20"] = calls["tone_metrics 2^20"]()
        # lsim (8 states, 2^20 steps) and dlsim (S3 one launch each)
        s3 = {}
        before = launch_counts()["S3"]
        out["lsim"] = compat.lsim(sys_c, u_lsim, t_lsim, device=dev)
        s3["lsim"] = launch_counts()["S3"] - before
        for nq in DLSIM_CASES:
            before = launch_counts()["S3"]
            out[f"dlsim n={nq[0]}"] = compat.dlsim(dsys[nq], u_d[nq])
            s3[f"dlsim n={nq[0]}"] = launch_counts()["S3"] - before
        torch.cuda.synchronize()
        launches = launch_counts()
    finally:
        torch.set_float32_matmul_precision(saved)
    tick("metrics, lsim and dlsim")
    print(f"[12 surface] launches {{{', '.join(f'{k}: {v}' for k, v in launches.items() if v)}}}; "
          f"the facade's filters {{{', '.join(f'{k}: {v}' for k, v in facade.items() if v)}}}")
    if not (facade["B12"] >= 1 and facade["B8"] >= 1):
        raise AssertionError(f"[12 surface] the facade's filters launched {facade}: want B12 and B8")
    if any(v != 1 for v in s3.values()):
        raise AssertionError(f"[12 surface] S3 launches by call {s3}: want one each")

    # the facade's outputs against scipy's float64 on channel 0
    x0 = x[0].double().cpu().numpy()
    sos64, (b64, a64) = np.asarray(sos, np.float64), (np.asarray(b_ba), np.asarray(a_ba))
    close("sosfilt", out["sosfilt"][0], sps.sosfilt(sos64, x0))
    close("lfilter", out["lfilter"][0], sps.lfilter(b64, a64, x0))
    close("sosfiltfilt", out["sosfiltfilt"][0], sps.sosfiltfilt(sos64, x0))
    close("filtfilt", out["filtfilt"][0], sps.filtfilt(b64, a64, x0))
    close("decimate q=4 iir", out["decimate q=4 iir"][0], sps.decimate(x0, 4, ftype="iir"))
    full64 = np.convolve(x0, h)
    close("oaconvolve 257", out["oaconvolve 257"][0], full64)
    close("convolve fft 257", out["convolve fft 257"][0], full64)
    del full64
    if hilbert_route == "fir":  # auto's route from HILBERT_BLOCKED_MIN_T: the FIR (B8)
        hf = spec.design_hilbert_fir(513).astype(np.float64)
        close("hilbert imag (the FIR in float64)", out["hilbert"][0].imag,
              np.convolve(np.pad(x0, (0, 256)), hf)[256 : 256 + SURF_T])
    else:
        close("hilbert imag", out["hilbert"][0].imag, sps.hilbert(x0).imag)
    close("resample_poly 3/2", out["resample_poly 3/2"][0], sps.resample_poly(x0, 3, 2))
    close("savgol_filter 31 3", out["savgol_filter 31 3"][0], sps.savgol_filter(x0, 31, 3))
    tick("the facade against scipy")
    # the rank filters against the port on the CPU over channel 0
    x0c = x[0].cpu()
    for name, fn, exact in (("medfilt 5", lambda v: rank.medfilt(v, RANK_K), True),
                            ("rank_filter 5 1", lambda v: rank.rank_filter(v, RANK_K, 1), True),
                            ("wiener 5", lambda v: rank.wiener(v, RANK_K), False)):
        got, want = out[name][0].cpu(), fn(x0c)
        errs[f"{name} card against the CPU"] = e = float((got - want).abs().max() / want.abs().max())
        if (exact and not torch.equal(got, want)) or not e <= WIENER_RTOL:
            raise AssertionError(f"[12 surface] {name}: the card {e:.3e} of max|y| from the CPU")
    tick("the rank filters against the CPU")
    # cwt and lombscargle against float64 NumPy on a slice
    xc0 = xc[0].double().cpu().numpy()
    s0_ = CWT_SHAPE[1] // 2
    for wi in (0, 7, 31):
        w_ = float(CWT_WIDTHS[wi])
        k = np.conj(compat.ricker(int(min(10 * w_, CWT_SHAPE[1])), w_))
        # output t correlates x[t - L // 2 : t - L // 2 + L] with the kernel
        seg = xc0[s0_ - k.size // 2 : s0_ + CWT_SLICE - k.size // 2 + k.size - 1]
        want = np.correlate(seg, k, "valid")
        close(f"cwt width {w_:g} (channel 0, {CWT_SLICE} samples)",
              out["cwt ricker 1..32"][0, wi, s0_ : s0_ + CWT_SLICE], want)
    t64, y64, f64 = (v.double().cpu().numpy() for v in (tl, yl, fl[:LOMB_CHECK]))
    arg = f64[:, None] * t64[None, :]
    tau = 0.5 * np.arctan2(np.sin(2 * arg).sum(-1), np.cos(2 * arg).sum(-1))
    c_, s_ = np.cos(arg - tau[:, None]), np.sin(arg - tau[:, None])
    close(f"lombscargle ({LOMB_CHECK} frequencies)", out["lombscargle"][:LOMB_CHECK],
          0.5 * ((c_ @ y64) ** 2 / (c_ * c_).sum(-1) + (s_ @ y64) ** 2 / (s_ * s_).sum(-1)))
    del arg, c_, s_
    tick("cwt and lombscargle against float64")
    # the peak finders: scipy's indices; the pulses under the wavelet peaks
    pk, props = out["find_peaks 2^22"]
    pk_s, props_s = sps.find_peaks(xpk, height=0.8, prominence=0.5, width=3)
    if not np.array_equal(pk, pk_s):
        raise AssertionError(f"[12 surface] find_peaks: {pk.size} peaks against scipy's {pk_s.size}")
    for key in ("prominences", "widths", "peak_heights"):
        if not np.allclose(props[key], props_s[key], rtol=1e-12, atol=1e-12):
            raise AssertionError(f"[12 surface] find_peaks: {key} differ from scipy's")
    got_cwt = out["find_peaks_cwt 2^16"]
    missed = [int(p_) for p_ in pos_cwt if np.min(np.abs(got_cwt - p_)) > 2]
    if missed:
        raise AssertionError(f"[12 surface] find_peaks_cwt missed the pulses at {missed}")
    notes.append(f"find_peaks 2^22: {pk.size} peaks, scipy's indices and properties; "
                 f"find_peaks_cwt 2^16: {got_cwt.size} peaks, every one of {PEAKS_CWT_PULSES} "
                 f"pulses within 2 samples (scipy's own: {sps.find_peaks_cwt(vcwt, np.arange(4, 33, 2)).size} peaks)")
    tick("the peak finders")
    # 2-D: scipy on a crop
    c0 = TWOD_N // 4
    crop, wide = slice(c0, c0 + TWOD_CROP), slice(c0 - 2, c0 + TWOD_CROP + 2)
    img64 = img[wide, wide].double().cpu().numpy()
    close("convolve2d same symm 5x5 (crop)", out["convolve2d same symm"][crop, crop],
          sps.convolve2d(img64, k55.astype(np.float64), "valid"))
    med = out["medfilt2d 5"][crop, crop].cpu()
    if not np.array_equal(med.numpy(), sps.medfilt2d(img[wide, wide].cpu().numpy(), 5)[2:-2, 2:-2]):
        raise AssertionError("[12 surface] medfilt2d 5x5 differs from scipy's on the crop")
    # the reference's mirror start-up differs from scipy's near the edges (both within
    # 5e-3, tests/test_splines.py:108): held on the interior, 32 samples in
    inner = slice(SPLINE_EDGE, SPLINE_N - SPLINE_EDGE)
    close("spline_filter 1024 (interior)", out["spline_filter 1024"][inner, inner],
          sps.spline_filter(img_s, 5.0)[inner, inner])
    tick("2-D against scipy")
    # companding: the card bit for bit the CPU over every int16 value and code
    all16 = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    codes = torch.arange(256, dtype=torch.int32).to(torch.uint8)
    for enc, dec in ((cmp.mulaw_encode, cmp.mulaw_decode), (cmp.alaw_encode, cmp.alaw_decode)):
        if not (torch.equal(enc(all16.to(dev)).cpu(), enc(all16)) and
                torch.equal(dec(codes.to(dev)).cpu(), dec(codes))):
            raise AssertionError(f"[12 surface] {enc.__name__}/{dec.__name__}: card differs from the CPU")
        back = enc(dec(codes.to(dev))).cpu()
        want = codes.clone()
        if enc is cmp.mulaw_encode:
            want[0x7F] = 0xFF  # mu-law's negative zero decodes to 0, encoded as 0xFF
        if not torch.equal(back, want):
            raise AssertionError(f"[12 surface] {enc.__name__}(decode(c)) loses codes")
    for name in ("mulaw round trip 64M", "alaw round trip 64M"):
        y_ = out[name]
        if y_.shape != stream.shape or y_.dtype != torch.int16:
            raise AssertionError(f"[12 surface] {name}: {y_.dtype}{tuple(y_.shape)}")
        errs[f"{name} max|y - x|"] = float((y_.int() - stream.int()).abs().max())
    # the metrics: card against the CPU
    mc, mh = out["tone_metrics 2^20"], metrics.tone_metrics(tq.cpu())
    for key in ("thd_db", "snr_db", "sinad_db", "sfdr_db", "enob"):
        errs[f"tone_metrics {key} card - CPU (dB)"] = e = abs(float(mc[key]) - float(mh[key]))
        if not e <= METRICS_RTOL_DB:
            raise AssertionError(f"[12 surface] tone_metrics {key}: card {e:.3e} dB from the CPU")
    notes.append(f"tone {METRICS_F0:.6f} through compat.sosfilt, cubic {METRICS_CUBIC}, int16: ENOB {float(mc['enob']):.3f}, "
                 f"SINAD {float(mc['sinad_db']):.2f} dB, THD {float(mc['thd_db']):.2f} dBc")
    tick("companding and metrics")
    # lsim and dlsim: S3 against its plain loop on the card, and scipy's float64 dlsim
    ad, bd, cd, dd, _ = lti.cont2discrete(sys_c, 1e-3, method="foh")
    cases = {"lsim": ((ad, bd, cd, dd), torch.from_numpy(u_lsim[:, None]).to(dev).float(),
                      out["lsim"][1][:, None])}
    for nq in DLSIM_CASES:
        cases[f"dlsim n={nq[0]}"] = (dsys[nq], u_d[nq], out[f"dlsim n={nq[0]}"][0])
    # past the cluster's capacity, outside the counted run: M read from device memory
    cases[f"dlsim n={DLSIM_BIG[0]}"] = (dsys[DLSIM_BIG], u_d[DLSIM_BIG],
                                        compat.dlsim(dsys[DLSIM_BIG], u_d[DLSIM_BIG])[0])
    for name, (sysd, u_, y_) in cases.items():
        mats = [torch.from_numpy(np.atleast_2d(m)).float().to(dev) for m in sysd]
        x0z = torch.zeros(mats[0].shape[0], device=dev)
        y_t = torch.as_tensor(y_, device=dev)
        plain_y, _ = lti._dlsim_plain(*mats, u_[:DLSIM_PLAIN], x0z)
        check.close("S3", y_t[:DLSIM_PLAIN], plain_y, f"{name} S3 against plain over {DLSIM_PLAIN} steps",
                    DLSIM_RTOL)
        # scipy in float64 on the float32 matrices S3 was given: the recursion's rounding
        # alone, not the matrices' (Ad within 5e-4 of I amplifies their rounding 2000x)
        sys32 = tuple(np.atleast_2d(m).astype(np.float32).astype(np.float64) for m in sysd)
        ts = min(DLSIM_SCIPY, u_.shape[0])
        _, want = sps.dlsim((*sys32, 1.0), u_[:ts].double().cpu().numpy())[:2]
        close(f"{name} against scipy's float64 dlsim ({ts} steps)", y_t[:ts],
              np.asarray(want).reshape(ts, -1), DLSIM_SCIPY_RTOL)
    tick("lsim and dlsim against plain and scipy")
    # S3's times: CUDA events beside its plain loop (one call), its bound and chain floor
    times = {}
    print(f"[12 surface] S3 on {torch.cuda.get_device_name(0)}: device ms, median of 3 after a "
          "warm-up; plain one call; before: the previous design (PERF.md); chain floor (the "
          "sequential order's)")
    for nq in (*DLSIM_CASES, DLSIM_BIG):
        n_, p_, q_ = nq
        t_ = u_d[nq].shape[0]
        mats = [torch.from_numpy(np.atleast_2d(m)).float().to(dev) for m in dsys[nq]]
        x0z = torch.zeros(n_, device=dev)
        k_ms = statistics.median(device_ms(lambda: lti.dlsim_scan(*mats, u_d[nq], x0z), 1, 3))
        p_ms = device_ms(lambda: lti._dlsim_plain(*mats, u_d[nq], x0z), 0, 1)[0]
        bk, g = dlsim_bounds(n_, p_, q_, t_), lti.dlsim_geometry(n_, p_, q_)
        times[f"S3 n={n_}"] = {"ms": k_ms, "plain": p_ms, **bk}
        before = RECURSION_EARLIER_MS.get(f"S3 n={n_}")
        print(f"  S3 n={n_} p={p_} q={q_} T={t_}: {k_ms:.4f} ms"
              + (f" (before {before:.4f}, {before / k_ms:.1f}x)" if before else "")
              + f"; plain {p_ms:.2f} ms ({p_ms / k_ms:.0f}x); bound {bk['bound'][0]:.4f} "
              f"({bk['bound'][1]}); chain floor {bk['chain']:.4f} ({bk['chain_before']:.4f}), "
              f"kernel/chain {k_ms / bk['chain']:.2f}; route {g.name}, cluster {g.cluster}, "
              f"{g.rows_cta} rows and {g.threads} threads a CTA, {g.smem_bytes} shared bytes; "
              "attrs (registers, local bytes, static shared, most threads) "
              f"{lti.dlsim_kernel_attrs(n_, p_, q_)}")
    tick("S3 times")
    # F3 on the card: a float input that requires a gradient is refused in grad mode
    for kernel, fn in f3_cases(dev).items():
        xg = torch.randn(2, 8192, generator=gen, device=dev).requires_grad_()
        if kernel == "B19":
            xg = torch.randn(1, 64 * 128, generator=gen, device=dev).requires_grad_()
        try:
            fn(xg)
        except NotImplementedError as exc:
            if "F3" not in str(exc):
                raise AssertionError(f"[12 surface] F3 {kernel}: refused without naming F3: {exc}")
        else:
            raise AssertionError(f"[12 surface] F3 {kernel}: a requires_grad input was not refused")
        with torch.no_grad():
            fn(xg)
    torch.cuda.synchronize()
    notes.append("F3: B8-B19 (not B20), B21, B22, S1, S2 and S3 refuse a requires_grad input "
                 "in grad mode and run under torch.no_grad()")
    tick("F3 refusals")
    for line in notes:
        print(f"[12 surface] {line}")
    print("[12 surface] " + "; ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; S3 against plain (max abs) {check.max_err['S3']:.3e}")
    seconds = time.perf_counter() - t_start
    print(f"[12 surface] phase 12 took {seconds:.1f} s (budget {SURFACE_BUDGET_S:.0f} s)")
    if seconds > SURFACE_BUDGET_S:
        raise AssertionError(f"[12 surface] {seconds:.1f} s past the phase's budget")
    del out
    return {"launches": launches, "check": check, "times": times, "calls": calls}


def surface_times(calls: dict) -> None:
    """Each call of phase 12: wall ms and device ms of one call under torch.profiler
    (after lead kernels), TF32 on as in the phase."""
    print("[12 surface times] wall and device ms of one profiled call:")
    for name, fn in calls.items():
        wall, dev_ms, rows = profiled(fn)
        ours = sum(r[2] for r in rows if r[0].startswith(OURS))
        print(f"  {name:24s} wall {wall:9.3f} ms; device {dev_ms:9.3f} ms in "
              f"{sum(r[1] for r in rows):5d} kernels ({ours:.3f} ms in the package's)")


# --- 13. the rest of the surface: the native serving path, device_chunks, trace, B20's
# input gradient and the twelve examples ----------------------------------------------

REST_CHUNK = 1 << 20
REST_GRAD_SHAPES = ((512, 8, 2), (1 << 20, 48, 1))  # (M, N, dilation): the designer's, n=48's
REST_GRAD_TAPS = 8
REST_GRAD_RTOL = 1e-5  # of max|g|, against autograd through the plain route on the card
REST_CPU_ROUNDS = 3
# the JSON record's entries by the kernel each one names (its launches on the main path)
ENTRY_KERNELS = {
    "windowed_averager": "B1", "windowed_averager_packed": "B2",
    **{f"scan_averager[{v}]": f"B3/{v}" for v in VARIANTS}, "cumsum": "B4",
    "direct_averager": "B5", "fused_fir": "B8", "fused_fir3": "B9", "iir1_block_scan": "B10",
    "sos_cascade": "B12", "sos_cascade_unrolled": "B13", "sos_sections": "B15",
    "fused_pfb_raw": "B19", "fused_branch_dft": "B20", "resample_farrow_segmented": "B21",
    "tv_cascade": "B16", "tv_section": "B17", "tv_frames_cascade": "B18",
    "lpc_synth_pass": "B22", "iir1_affine_scan": "B11", "sos_cascade_mxu": "B14",
    "ring_shift_right_shard": "B6", "fused_ring_windowed_shard": "B7", "nlms_scan": "S1",
    "rls_scan": "S2", "dlsim_scan": "S3",
}


def rest_gradient(dev, gen, m: int, n: int, dilation: int, layout: str) -> tuple[float, int]:
    """B20's gradients with respect to u and the taps on the card, one call, against
    autograd through ``branch_fir`` + ``dft_matmul`` on the card: (error of max|g|, B20
    launches in the call)."""
    u0 = torch.randn(m, n, generator=gen, device=dev)
    h0 = torch.randn(REST_GRAD_TAPS, n, generator=gen, device=dev)
    w = torch.randn(2, m, n, generator=gen, device=dev)

    def loss(re, im):
        return (w[0] * re).sum() + (w[1] * im * im).sum()

    u, h = u0.clone().requires_grad_(), h0.clone().requires_grad_()
    before = chz.fused_branch_dft.launches
    out = chz.fused_branch_dft(u, h, dilation=dilation, layout=layout)
    re, im = (out.real.T, out.imag.T) if layout == "complex" else (
        (out[0].T, out[1].T) if layout == "channels" else out)
    loss(re, im).backward()
    torch.cuda.synchronize()
    launched = chz.fused_branch_dft.launches - before
    ur, hr = u0.clone().requires_grad_(), h0.clone().requires_grad_()
    v = chz.branch_fir(ur[None], hr, dilation=dilation)[0]
    loss(*chz.dft_matmul(v, None, n)).backward()
    err = 0.0
    for got, want in ((u.grad, ur.grad), (h.grad, hr.grad)):
        err = max(err, ((got - want).abs().max() / want.abs().max()).item())
    return err, launched


def run_example(name: str) -> tuple[int, str, float]:
    """One of the port's examples on the card, in this process: (exit code, output, s)."""
    module = importlib.import_module(f"digital_signal_processsing_tpu_torch.examples.{name}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = module.main(["--device", "cuda"])
    torch.cuda.synchronize()
    return rc, buf.getvalue(), time.perf_counter() - t0


def phase_rest_main(dev, x: torch.Tensor, y_main: torch.Tensor, wav: np.ndarray,
                    split: int) -> dict:
    """The rest of the surface with the counts reset around its main path: the native
    executor's serving loop over phase 4's WAVs (B1) against the Python branch and one
    shot, ``device_chunks`` over phase 4's loader, B20's input gradient in the three
    layouts, the twelve examples; then, outside the counted run, the native serial
    averager on the 64M stream against B1, both loops' walls and the native loop's
    device split, the device_chunks loop's wall and a trace of one B1 call. Returns
    the launches."""
    t_start = time.perf_counter()
    t0 = time.perf_counter()
    so = native.build()
    native.load()
    print(f"[13 rest] native library {so.relative_to(Path(__file__).resolve().parent)} built "
          f"by {native.compiler_version()} ({' '.join(native.CXX_FLAGS)}) in "
          f"{time.perf_counter() - t0:.1f} s; host CPU {native.host_cpu_model()}")
    gen = torch.Generator(device=dev).manual_seed(13)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        paths = [tmp / "a.wav", tmp / "b.wav"]
        write_wav(paths[0], wav[:split], 48000, 2)
        write_wav(paths[1], wav[split:], 48000, 2)

        def serve(use_native: bool) -> float:
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = tmp / ("native.wav" if use_native else "python.wav")
            written = stream_moving_average(paths, out, MAIN_WINDOW, chunk_samples=REST_CHUNK,
                                            use_native=use_native, device="cuda")
            torch.cuda.synchronize()
            if written != wav.size:
                raise AssertionError(f"[13 rest] served {written} of {wav.size} samples")
            return (time.perf_counter() - t) * 1e3

        # the counted main path
        reset_launch_counts()
        serve(True)
        serve_launches = launch_counts()["B1"]
        serve(False)
        chunks = 0
        for got, want in zip(device_chunks(WavChunkLoader(paths, REST_CHUNK), device=dev),
                             WavChunkLoader(paths, REST_CHUNK), strict=True):
            if not got.is_cuda or not torch.equal(got.cpu(), torch.from_numpy(want)):
                raise AssertionError(f"[13 rest] device_chunks' chunk {chunks} differs")
            chunks += 1
        grads = {}
        for m, n, d in REST_GRAD_SHAPES:
            for layout in chz.LAYOUTS:
                err, launched = rest_gradient(dev, gen, m, n, d, layout)
                grads[(m, n, layout)] = err
                if not err <= REST_GRAD_RTOL or launched != 1:
                    raise AssertionError(
                        f"[13 rest] B20's gradients at ({m}, {n}) {layout}: {err:.3e} of "
                        f"max|g| (limit {REST_GRAD_RTOL}), {launched} B20 launches (want 1)")
        ran = {}
        saved_tmp = tempfile.tempdir
        tempfile.tempdir = str(tmp)  # where audio_timestretch writes its WAVs
        try:
            for name in port_examples.NAMES:
                rc, out, secs = run_example(name)
                ran[name] = secs
                last_line = out.strip().splitlines()[-1] if out.strip() else ""
                print(f"[13 rest] example {name}: exit {rc} in {secs:.2f} s; {last_line[:90]}")
                if rc != 0 or "MISS" in out:
                    raise AssertionError(f"[13 rest] example {name} missed:\n{out}")
        finally:
            tempfile.tempdir = saved_tmp
        torch.cuda.synchronize()
        launches = launch_counts()

        one_shot = moving_average(torch.from_numpy(wav).to(dev), MAIN_WINDOW, 2).cpu().numpy()
        write_wav(tmp / "one_shot.wav", one_shot, 48000, 2)
        want = (tmp / "one_shot.wav").read_bytes()
        if (tmp / "native.wav").read_bytes() != want or (tmp / "python.wav").read_bytes() != want:
            raise AssertionError("[13 rest] a served WAV differs from one-shot B1")
        print(f"[13 rest] launches {({k: v for k, v in launches.items() if v})}; served "
              f"{wav.size} samples by both branches byte-identical to one-shot B1 "
              f"({serve_launches} B1 launches in the native loop); device_chunks: {chunks} "
              f"chunks equal to the loader's, on the card; B20's gradients (u and taps) "
              + ", ".join(f"{m}x{n} {lay} {e:.2e}" for (m, n, lay), e in grads.items())
              + " of max|g|, one B20 launch a call; examples "
              + ", ".join(f"{k} {v:.2f} s" for k, v in ran.items()))
        if min(launches[k] for k in ("B1", "B20")) < 1:
            raise AssertionError(f"[13 rest] B1 or B20 never launched: {launches}")

        # outside the counted run: the two loops' walls, the native loop's device split
        walls = {True: [], False: []}
        for use_native in (True, False, False, True, True, False):
            walls[use_native].append(serve(use_native))
        wall, dev_ms, rows = profiled(lambda: serve(True))
        med = {k: statistics.median(v) for k, v in walls.items()}
        print(f"[13 rest] serving {wav.size} samples in chunks of 2^20, k={MAIN_WINDOW}, on "
              f"{torch.cuda.get_device_name(0)}: wall median of 3 native {med[True]:.1f} ms "
              f"({', '.join(f'{w:.1f}' for w in walls[True])}), Python {med[False]:.1f} ms "
              f"({', '.join(f'{w:.1f}' for w in walls[False])}); native profiled: wall "
              f"{wall:.1f} ms, device {dev_ms:.3f} ms, idle {1 - dev_ms / wall:.3f}")
        for key, count, ms in rows[:6]:
            print(f"  {ms:9.3f} ms  {count:4d} x  {key[:80]}")
        torch.cuda.synchronize()
        t = time.perf_counter()
        for got in device_chunks(WavChunkLoader(paths, REST_CHUNK), device=dev):
            pass
        torch.cuda.synchronize()
        print(f"[13 rest] device_chunks loop over {chunks} chunks: "
              f"{(time.perf_counter() - t) * 1e3:.1f} ms wall")
        for leads, pause in PROFILE_LEADS:  # lead kernels take a late profile's lost records

            def b1_call(leads=leads):
                for _ in range(leads):
                    torch.cuda._sleep(1)
                return ps.windowed_averager(x, MAIN_WINDOW, 2)

            time.sleep(pause)
            path = trace(b1_call, tmp / "trace")
            events = json.loads(path.read_text())["traceEvents"]
            kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
            ours = sorted(k for k in kernels if "dsp::" in k)
            if ours:
                break
        if not path.is_file() or not ours:
            raise AssertionError(f"[13 rest] the trace of B1 names no kernel of the package: "
                                 f"{sorted(kernels)[:5]}")
        print(f"[13 rest] trace {path.name} ({leads} lead kernels): {len(events)} events, "
              f"B1's kernel {ours}")

    # the paper's comparison: the serial C++ averager on one host core against B1
    host = x.cpu().numpy()
    y_cpu = native.moving_average_native(host, MAIN_WINDOW, 2)
    if not np.array_equal(y_cpu, y_main.cpu().numpy()):
        raise AssertionError("[13 rest] moving_average_native differs from B1 on the 64M stream")
    cpu_ms = native.bench_moving_average_native(host, MAIN_WINDOW, 2, warmup=1,
                                                rounds=REST_CPU_ROUNDS)
    b1 = device_ms(lambda: ps.windowed_averager(x, MAIN_WINDOW, 2), 5, 20)
    b1_ms = statistics.median(b1)
    print(f"[13 rest] 64M int16 stereo samples, k={MAIN_WINDOW}: moving_average_native "
          f"{cpu_ms:.1f} ms (mean of {REST_CPU_ROUNDS} after a warm-up, one core of "
          f"{native.host_cpu_model()}), bit-exact with B1; B1 {b1_ms:.4f} ms (median of 20, "
          f"{torch.cuda.get_device_name(0)}), {cpu_ms / b1_ms:.0f}x")
    print(f"[13 rest] phase 13 took {time.perf_counter() - t_start:.1f} s")
    return {"launches": launches}


# --- phase 14: the multi-card surface on the one card (ROADMAP queue 1 item 4) ----------
MC_WORLD = 4
MC_MESHES = {"4x1": (1, 4), "2x2": (2, 2)}  # (n_time, n_channel): the dp steps' batch over ch
MC_BEAM = beamform.ArrayConfig(n_sensors=16)  # phase 10's M = 16 row: 64 blocks of 16384
MC_BEAM_BLOCKS = 64
MC_TOL = {"mvdr": (1e-4, 1e-6), "music": (1e-3, 1e-5)}  # rtol, atol: the reference's bounds
MC_WIDE_TOL = (1e-4, 1e-5)
MC_REPS = 3
MC_ROUNDS = (1, 3)  # time_phases' warm-up and measured rounds
MC_BUDGET_S = 90.0
MC_WORLD1_CPIS, MC_WORLD1_BLOCKS = 4, 8  # the world of one's cut of the CPIs and the blocks


def beam_blocks(blocks: int) -> tuple[np.ndarray, np.ndarray]:
    """Phase 10's M = 16 row: blocks of 16384 snapshots at 10 dB, block b seeded b."""
    snaps = [beamform.synthesize(MC_BEAM, MODEL_BEAM_TRUTH, MODEL_BEAM_SNAPS, snr_db=10.0, seed=b)
             for b in range(blocks)]
    return np.stack([s[0] for s in snaps]), np.stack([s[1] for s in snaps])


def mc_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| / max|want|, in float64."""
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def mc_timed(fn, reps: int = MC_REPS) -> tuple[list[float], list[float]]:
    """This rank's device ms (events on its stream) and wall ms of ``reps`` calls,
    every rank started together by a barrier."""
    import torch.distributed as dist

    dev_ms, wall_ms = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        dist.barrier()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(e0.elapsed_time(e1))
    return dev_ms, wall_ms


def multicard_worker(rank: int, tmp: str) -> None:
    """One rank of phase 14: the dp steps, the wideband receiver, time_phases and
    device_chunks through their sharded entry points, every rank on cuda:0."""
    import dataclasses

    import torch.distributed as dist

    from digital_signal_processsing_tpu_torch import parallel as par
    from digital_signal_processsing_tpu_torch.harness.profile import time_phases

    torch.cuda.set_device(0)
    par.initialize_multihost(f"file://{tmp}/mc.store", MC_WORLD, rank, backend="gloo")
    meshes = {m: par.make_mesh(n_time=t, n_channel=c, device="cuda")
              for m, (t, c) in MC_MESHES.items()}
    tmesh = par.make_time_mesh(device="cuda")
    flat, dev = par.time_sharding(tmesh), tmesh.device

    def load(name: str) -> np.ndarray:
        return np.load(f"{tmp}/{name}.npy")

    ti, tq, bi, bq = (torch.from_numpy(load(k)).to(dev) for k in ("ti", "tq", "bi", "bq"))
    x_host = load("x")
    n_loc = WIDE_T // MC_WORLD
    xw = torch.from_numpy(load("wide")[rank * n_loc : (rank + 1) * n_loc]).to(dev)
    rx = WidebandFmReceiver(WidebandConfig(), device=dev)
    paths = [Path(tmp) / "a.wav", Path(tmp) / "b.wav"]
    xs = flat.shard(x_host).to(dev)

    calls = {}
    for m, mesh in meshes.items():
        calls[f"detect_batch {m}"] = lambda mesh=mesh: radar.detect_batch(
            MODEL_TRACK_RADAR, ti, tq, mesh=mesh)
        for method in MC_TOL:
            calls[f"spectrum_batch {method} {m}"] = lambda mesh=mesh, method=method: (
                beamform.spectrum_batch(MC_BEAM, bi, bq, method=method, n_sources=2, mesh=mesh))
    calls["sharded_wideband 1x4"] = lambda: par.sharded_wideband(rx, xw, tmesh)
    calls["sharded_moving_average 1x4"] = lambda: par.sharded_moving_average(
        xs, MAIN_WINDOW, 2, mesh=tmesh)
    torch.cuda.synchronize()

    # the main path: each part's counts reset just before it and read just after
    out, info = {}, {"launches": {}, "times": {}}
    for name, fn in calls.items():
        reset_launch_counts()
        y = fn()
        if name.startswith(("sharded_wideband", "sharded_moving_average")):
            y = flat.gather(y)
        torch.cuda.synchronize()
        info["launches"][name] = launch_counts()
        out[name] = y
    reset_launch_counts()
    res = time_phases(lambda v: par.sharded_moving_average(v, MAIN_WINDOW, 2, mesh=tmesh), x_host,
                      sharding=flat, warmup=MC_ROUNDS[0], rounds=MC_ROUNDS[1])
    torch.cuda.synchronize()
    info["launches"]["time_phases"] = launch_counts()
    info["time_phases"] = dataclasses.asdict(res)
    reset_launch_counts()
    chunks = 0
    for got, want in zip(device_chunks(WavChunkLoader(paths, REST_CHUNK), sharding=flat),
                         WavChunkLoader(paths, REST_CHUNK), strict=True):
        if got.device != dev or not torch.equal(got.cpu(), flat.shard(want)):
            raise AssertionError(f"[14 multi-card] rank {rank}: device_chunks' chunk {chunks} "
                                 "is not the loader's shard")
        chunks += 1
    torch.cuda.synchronize()
    info["launches"]["device_chunks"] = launch_counts()
    info["chunks"] = chunks

    # each call's time on each rank: the four contexts time-slice the one card
    for name, fn in calls.items():
        info["times"][name] = mc_timed(fn)
    if rank == 0:
        for name, y in out.items():
            for j, v in enumerate(y if isinstance(y, tuple) else (y,)):
                np.save(f"{tmp}/out {name} {j}.npy", v.cpu().numpy())
    Path(f"{tmp}/mc{rank}.json").write_text(json.dumps(info))
    tmesh.close()
    dist.destroy_process_group()


def phase_multicard(dev, x: torch.Tensor, y_main: torch.Tensor, wav: np.ndarray, split: int,
                    wide_main: dict, smi: str) -> dict:
    """Phase 14: four processes on the one card over gloo run the multi-card surface at
    full width, each gathered output held against the one-card call on the same input;
    then the port's dry runs on the card. Returns the main path's launches (all ranks)."""
    t_start = time.perf_counter()
    ti, tq, _ = track_scene(MODEL_TRACK_CPIS)
    bi, bq = beam_blocks(MC_BEAM_BLOCKS)
    xw = wide_main["x"]
    rx = wide_main["rx64"]
    with tempfile.TemporaryDirectory() as tmp:
        for name, v in (("ti", ti), ("tq", tq), ("bi", bi), ("bq", bq), ("x", x.cpu().numpy()),
                        ("wide", xw.cpu().numpy())):
            np.save(f"{tmp}/{name}.npy", v)
        write_wav(Path(tmp) / "a.wav", wav[:split], 48000, 2)
        write_wav(Path(tmp) / "b.wav", wav[split:], 48000, 2)
        t0 = time.perf_counter()
        torch.multiprocessing.spawn(multicard_worker, args=(tmp,), nprocs=MC_WORLD, join=True)
        spawn_s = time.perf_counter() - t0
        infos = [json.loads(Path(f"{tmp}/mc{r}.json").read_text()) for r in range(MC_WORLD)]

        def got(name: str, j: int = 0) -> torch.Tensor:
            return torch.from_numpy(np.load(f"{tmp}/out {name} {j}.npy"))

        # each gathered output against the one-card call on the same input
        ti_d, tq_d = torch.from_numpy(ti).to(dev), torch.from_numpy(tq).to(dev)
        det, power, thresh = (v.cpu() for v in radar.detect_batch(MODEL_TRACK_RADAR, ti_d, tq_d))
        errs = {}
        for m in MC_MESHES:
            name = f"detect_batch {m}"
            for j, (what, want) in enumerate((("power", power), ("threshold", thresh)), start=1):
                errs[f"{name} {what}"] = e = float((got(name, j) - want).abs().max()
                                                   / want.abs().max())
                if not e <= MODEL_TOL:
                    raise AssertionError(f"[14 multi-card] {name} {what}: {e:.3e} of max > {MODEL_TOL}")
            same_detections(got(name), power, thresh, det)
        bi_d, bq_d = torch.from_numpy(bi).to(dev), torch.from_numpy(bq).to(dev)
        for method, (rtol, atol) in MC_TOL.items():
            want = beamform.spectrum_batch(MC_BEAM, bi_d, bq_d, method=method, n_sources=2).cpu()
            for m in MC_MESHES:
                name = f"spectrum_batch {method} {m}"
                errs[name] = mc_rel_err(got(name), want)
                np.testing.assert_allclose(got(name).numpy(), want.numpy(), rtol=rtol, atol=atol)
        want = rx(xw).cpu().numpy()
        wide = got("sharded_wideband 1x4").numpy()
        errs["sharded_wideband 1x4"] = mc_rel_err(torch.from_numpy(wide), torch.from_numpy(want))
        np.testing.assert_allclose(wide, want, rtol=MC_WIDE_TOL[0], atol=MC_WIDE_TOL[1])
        live = np.flatnonzero(np.abs(want).max(axis=1) > 0)
        if not np.array_equal(live, np.flatnonzero(np.abs(wide).max(axis=1) > 0)):
            raise AssertionError("[14 multi-card] sharded_wideband's squelch gates differ")
        if not torch.equal(got("sharded_moving_average 1x4"), y_main.cpu()):
            raise AssertionError("[14 multi-card] the sharded averager differs from B1 on 64M")
    want_chunks = -(-wav.size // REST_CHUNK)
    if any(info["chunks"] != want_chunks for info in infos):
        raise AssertionError(f"[14 multi-card] device_chunks: {[i['chunks'] for i in infos]} chunks, "
                             f"want {want_chunks} on every rank")
    tp = [info["time_phases"] for info in infos]
    if any(t != tp[0] for t in tp):
        raise AssertionError(f"[14 multi-card] time_phases differs across ranks: {tp}")

    # the kernels of each part, summed over the ranks
    parts = {p: {k: sum(info["launches"][p][k] for info in infos) for k in KERNELS}
             for p in infos[0]["launches"]}
    wide_l, avg_l = parts["sharded_wideband 1x4"], parts["sharded_moving_average 1x4"]
    tp_l = parts["time_phases"]
    if wide_l["B19"] != MC_WORLD or avg_l["B1"] + avg_l["B7"] < MC_WORLD or tp_l["B1"] < MC_WORLD:
        raise AssertionError(f"[14 multi-card] B19 in the wideband part {wide_l['B19']} (want "
                             f"{MC_WORLD}), B1/B7 in the averager part {avg_l['B1']}/{avg_l['B7']}, "
                             f"B1 in time_phases {tp_l['B1']}")
    launches = {k: sum(p[k] for p in parts.values()) for k in KERNELS}
    print(f"[14 multi-card] {MC_WORLD} processes on one card over gloo ({spawn_s:.1f} s with the "
          f"spawn); detect_batch on {MODEL_TRACK_CPIS} CPIs of 64 x 16384 over a 4x1 and a 2x2 "
          f"mesh: power and threshold within {MODEL_TOL} of max|want| of the one-card call, "
          f"detections equal outside the {MODEL_DET_MARGIN} margin; spectrum_batch MVDR "
          f"(rtol/atol {MC_TOL['mvdr']}) and MUSIC ({MC_TOL['music']}) on {MC_BEAM_BLOCKS} blocks "
          f"of 16 x {MODEL_BEAM_SNAPS} over both meshes; sharded_wideband on the 2^26-sample "
          f"64-channel stream over a 1x4 mesh ({WIDE_T // MC_WORLD} samples a rank plus its "
          f"halo) within rtol/atol {MC_WIDE_TOL} of the receiver, the same squelch gates "
          f"({live.size} channels live); the sharded averager at 64M k={MAIN_WINDOW} bit-exact "
          f"against B1; device_chunks: {want_chunks} chunks, each rank's the loader's shard")
    print("[14 multi-card] max|got - want| / max|want| against the one-card call: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    print("[14 multi-card] launches by part (all ranks): " + "; ".join(
        f"{p} {({k: v for k, v in c.items() if v})}" for p, c in parts.items()))
    print(f"[14 multi-card] on {smi}: time-sliced figures, four processes sharing one card (not "
          f"a scaling number, not a kernel's time alone); device ms (events on each rank's "
          f"stream) and wall ms, median of {MC_REPS} after the counted call, by rank:")
    for name in infos[0]["times"]:
        dev_ms = [statistics.median(info["times"][name][0]) for info in infos]
        wall = [statistics.median(info["times"][name][1]) for info in infos]
        print(f"  {name:32s} device {', '.join(f'{v:.3f}' for v in dev_ms)}; wall "
              f"{', '.join(f'{v:.3f}' for v in wall)}")
    r = tp[0]
    n = r["rounds"]
    print(f"  time_phases(sharding=time_sharding(mesh)) of sharded_moving_average, 64M k="
          f"{MAIN_WINDOW}, {MC_ROUNDS[0]} warm-up and {n} rounds, the slowest rank's (the same on "
          f"every rank): init {r['initialization_ms']:.3f} ms, h2d {r['h2d_ms'] / n:.3f}, compute "
          f"{r['compute_ms'] / n:.3f}, d2h (with the gather) {r['d2h_ms'] / n:.3f}")

    # the dry runs on the card: one process a rank, gloo on the one card
    for run in (graft_entry.dryrun_multichip, graft_entry.dryrun_multiprocess):
        t0 = time.perf_counter()
        rec = run(4)
        dry = {k: sum(c[k] for c in rec["launches"]) for k in KERNELS}
        for k in KERNELS:
            launches[k] += dry[k]
        print(f"[14 multi-card] {run.__name__}(4) on the card ({rec['backend']}): "
              f"{time.perf_counter() - t0:.1f} s with the spawn, each rank's seconds "
              f"{', '.join(f'{s:.1f}' for s in rec['seconds'])}; launches (all ranks) "
              f"{({k: v for k, v in dry.items() if v})}")
    seconds = time.perf_counter() - t_start
    print(f"[14 multi-card] phase 14 took {seconds:.1f} s (budget {MC_BUDGET_S:.0f} s)")
    return {"launches": launches, "seconds": seconds}


def multicard_world1(mesh, x: torch.Tensor, y_main: torch.Tensor, wide_main: dict,
                     wav: np.ndarray, split: int, tmp: str) -> None:
    """Phase 14's entry points once more at world size 1 over NCCL (phase 8), each bit
    for bit against its one-card call."""
    from digital_signal_processsing_tpu_torch import parallel as par
    from digital_signal_processsing_tpu_torch.harness.profile import time_phases

    dev = x.device
    ti, tq, _ = track_scene(MC_WORLD1_CPIS)
    ti, tq = torch.from_numpy(ti).to(dev), torch.from_numpy(tq).to(dev)
    bi, bq = (torch.from_numpy(v).to(dev) for v in beam_blocks(MC_WORLD1_BLOCKS))
    flat = par.time_sharding(mesh)
    rx, xw = wide_main["rx64"], wide_main["x"]
    paths = [Path(tmp) / "a.wav", Path(tmp) / "b.wav"]
    write_wav(paths[0], wav[:split], 48000, 2)
    write_wav(paths[1], wav[split:], 48000, 2)
    pairs = {
        "detect_batch": (radar.detect_batch(MODEL_TRACK_RADAR, ti, tq, mesh=mesh),
                         radar.detect_batch(MODEL_TRACK_RADAR, ti, tq)),
        **{f"spectrum_batch {m}": (beamform.spectrum_batch(MC_BEAM, bi, bq, method=m, n_sources=2,
                                                            mesh=mesh),
                                    beamform.spectrum_batch(MC_BEAM, bi, bq, method=m, n_sources=2))
           for m in MC_TOL},
        "sharded_wideband": (par.sharded_wideband(rx, xw, mesh), rx(xw)),
        "device_chunks": (torch.cat(list(device_chunks(WavChunkLoader(paths, REST_CHUNK),
                                                       sharding=flat))),
                          torch.from_numpy(np.concatenate(list(WavChunkLoader(paths, REST_CHUNK))))
                          .to(dev)),
    }
    for name, (got, want) in pairs.items():
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            if not torch.equal(g, w):
                raise AssertionError(f"[8 world 1] {name} differs from its one-card call")
    res = time_phases(lambda v: par.sharded_moving_average(v, MAIN_WINDOW, 2, mesh=mesh),
                      x.cpu().numpy(), sharding=flat, warmup=MC_ROUNDS[0], rounds=MC_ROUNDS[1])
    if not res.compute_ms > 0:
        raise AssertionError(f"[8 world 1] time_phases(sharding=): {res}")
    print(f"[8 world 1] the multi-card surface: detect_batch ({MC_WORLD1_CPIS} CPIs of 64 x 16384) "
          f"and spectrum_batch MVDR and MUSIC ({MC_WORLD1_BLOCKS} blocks of 16 x "
          f"{MODEL_BEAM_SNAPS}) with the mesh, sharded_wideband on the 2^26 stream and "
          "device_chunks(sharding=) over phase 4's WAVs bit for bit their one-card calls; "
          f"time_phases(sharding=) of the averager at 64M: compute {res.compute_ms / res.rounds:.3f} "
          f"ms a round, d2h {res.d2h_ms / res.rounds:.3f} ms")


# --- phase 15: parity with the JAX package: the harness's K-differential timer, the planar DFT
# functions, the renamed convolutions and F6-F8 ------------------------------------------------
PARITY_CHAIN = 16  # time_phases(chain=) on B1: chains of 16 and 4 calls a round
PARITY_SWEEP_CHAIN = 4
PARITY_RTOL = 1e-4  # of max|X| (max|y|), against float64 NumPy on a slice (fir_filter's B8)
PARITY_STFT = (8, 1 << 21)  # the reference's stft point (its fft_mxu.py:120-125), hop nfft / 4
PARITY_NFFTS = (512, 4096)
PARITY_FACTORED = (8, 32768)
PARITY_LARGE_N = 1 << 22
PARITY_CONV = (16, 1 << 22, 257)  # channels, samples, taps
PARITY_SLICE = 64  # rows or frames held against float64


def parity_dft_cases(dev, gen) -> dict:
    """name -> (call, float64 reference of the first PARITY_SLICE rows of the first plane or
    channel, those rows of the call's output): the reference's planar DFT functions at its
    own shapes."""
    cases = {}
    xs = torch.randn(*PARITY_STFT, generator=gen, device=dev)
    for nfft in PARITY_NFFTS:
        hop = nfft // 4
        frames = (PARITY_STFT[1] - nfft) // hop + 1
        w = spec.spectral_window("hann", nfft)
        x0 = xs[0, : (PARITY_SLICE - 1) * hop + nfft].double().cpu().numpy()
        fr = np.stack([x0[i * hop : i * hop + nfft] for i in range(PARITY_SLICE)])
        cases[f"rfft_dense_framed nfft={nfft} (8, 2^21)"] = (
            lambda hop=hop, nfft=nfft, frames=frames, w=w: fm.rfft_dense_framed(
                xs, frames, hop, nfft, w),
            lambda fr=fr, w=w: np.fft.rfft(fr * w, axis=-1),
            lambda re, im: (re[0, :PARITY_SLICE], im[0, :PARITY_SLICE]),
        )
    xr, xi = (torch.randn(*PARITY_FACTORED, generator=gen, device=dev) for _ in range(2))
    cases["dft_factored (8, 32768)"] = (
        lambda: fm.dft_factored(xr, xi),
        lambda: np.fft.fft(xr[:2].double().cpu().numpy() + 1j * xi[:2].double().cpu().numpy()),
        lambda re, im: (re[:2], im[:2]),
    )
    zr, zi = (torch.randn(1, PARITY_LARGE_N, generator=gen, device=dev) for _ in range(2))
    z64 = zr.double().cpu().numpy() + 1j * zi.double().cpu().numpy()
    cases["fft_large (1, 2^22)"] = (
        lambda: fm.fft_large(zr, zi), lambda: np.fft.fft(z64), lambda re, im: (re, im))
    cases["fft_large inverse (1, 2^22)"] = (
        lambda: fm.fft_large(zr, zi, inverse=True), lambda: np.fft.ifft(z64),
        lambda re, im: (re, im))
    return cases


def phase_parity(dev, x: torch.Tensor, b1_ms: float, smi: str) -> dict:
    """Parity with the JAX package, its counts reset around its main path: ``time_phases(
    chain=16)`` (the reference's K-differential cross-check), the same with each call on the
    stream itself, and ``chain=1`` of the averager on the 64M stream at k=1024 (B1) beside
    phase 5's event median; the reference's planar
    DFT functions at its own shapes; ``causal_conv`` (strides 1 and 4) and ``interp_conv`` on
    16 x 2^22 at 257 taps against ``fir_filter``'s B8 route; F6, F7 and F8 on the card. Then,
    outside the counted run, the sweep's command line with ``--smoke --chain 4`` in a process
    of its own (14-column rows), and each DFT against float64 NumPy on a slice with its
    device ms."""
    from digital_signal_processsing_tpu_torch.harness import time_phases
    from digital_signal_processsing_tpu_torch.harness.profile import (
        MEASUREMENT_ROUNDS, WARMUP_ROUNDS,
    )
    from digital_signal_processsing_tpu_torch.ops import signal as gen_ops, twod

    t_start = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(15)
    host = x.cpu().numpy()
    dft = parity_dft_cases(dev, gen)
    c, t, k = PARITY_CONV
    xc = torch.randn(c, t, generator=gen, device=dev)
    h = torch.from_numpy(fir.design_lowpass(k, 0.2).astype(np.float32)).to(dev)
    stuffed = torch.zeros_like(xc)
    stuffed[:, ::2] = xc[:, : t // 2]
    convs = {  # name -> (the call, fir_filter's B8 route on the same input)
        "causal_conv": (lambda: fir.causal_conv(xc, h),
                        lambda: fir.fir_filter(xc, h, method="overlap_save_fused")),
        "interp_conv up=2": (lambda: fir.interp_conv(xc[:, : t // 2], h, up=2),
                             lambda: fir.fir_filter(stuffed, h, method="overlap_save_fused")),
    }

    reset_launch_counts()
    averager = lambda v: moving_average(v, MAIN_WINDOW, 2)  # noqa: E731
    kdiff = time_phases(averager, host, resident=True, chain=PARITY_CHAIN).averaged().compute_ms
    # the same chains with every call on the stream itself, as phase 5's events time it
    same = time_phases(lambda v: averager(x), host, resident=True,
                       chain=PARITY_CHAIN).averaged().compute_ms
    one = time_phases(averager, host, resident=True).averaged().compute_ms
    outs = {name: call() for name, (call, _, _) in dft.items()}
    ys = {name: (call(), b8()) for name, (call, b8) in convs.items()}
    ys["causal_conv stride=4"] = (fir.causal_conv(xc, h, stride=4), ys["causal_conv"][1][:, ::4])
    empties = {
        (3, 3, 4, 5): twod.convolve2d(torch.ones(3, 3, device=dev), torch.ones(4, 5, device=dev),
                                      "valid"),
        (2, 3, 6, 4, 2): twod.correlate2d(torch.ones(2, 3, 6, device=dev),
                                          torch.ones(4, 2, device=dev), "valid", "symm"),
        0: gen_ops.chirp(10.0, 100.0, 0),
    }
    lev = lpc.levinson(np.array([[4.0, 2.0, 1.0, 0.5]], np.float32))
    torch.cuda.synchronize()
    launches = launch_counts()

    small = max(PARITY_CHAIN // 4, 1)
    want_b1 = (2 * ((1 + WARMUP_ROUNDS) * PARITY_CHAIN + MEASUREMENT_ROUNDS * (PARITY_CHAIN + small))
               + 1 + WARMUP_ROUNDS + MEASUREMENT_ROUNDS)
    if launches["B1"] != want_b1 or launches["B8"] != len(convs):
        raise AssertionError(f"[15 parity] launches {launches}; want B1 {want_b1}, B8 {len(convs)}")
    if not all(np.isfinite(v) and v > 0 for v in (kdiff, same, one)):
        raise AssertionError(f"[15 parity] time_phases compute: chain={PARITY_CHAIN} {kdiff}, "
                             f"on the stream itself {same}, chain=1 {one}")
    print(f"[15 parity] B1 k={MAIN_WINDOW} on the 64M stream, resident, {smi}: time_phases("
          f"chain={PARITY_CHAIN}), the K-differential of {PARITY_CHAIN} and {small} calls a "
          f"round, each on the last one's output, {kdiff:.4f} ms; the same chains with each "
          f"call on the stream itself {same:.4f} ms; chain=1 (events around one call) "
          f"{one:.4f} ms; phase 5's event median {b1_ms:.4f} ms; K-differential / events "
          f"{kdiff / b1_ms:.3f}, on the stream itself {same / b1_ms:.3f}; launches "
          f"{({n: v for n, v in launches.items() if v})}")
    for name, (got, want) in ys.items():
        scale = want.abs().max().item()
        e = (got - want).abs().max().item() if got.shape == want.shape else float("inf")
        if not e <= PARITY_RTOL * scale:
            raise AssertionError(f"[15 parity] {name}: {tuple(got.shape)} against B8's "
                                 f"{tuple(want.shape)}, max error {e:.3e} of max|y| {scale:.3e}")
        print(f"[15 parity] {name} on {c} x 2^{t.bit_length() - 1} at {k} taps against "
              f"fir_filter's B8 route: max error {e / scale:.3e} of max|y|")
    shapes = {key: (str(v.device), v.dtype, tuple(v.shape)) for key, v in empties.items()}
    want = {(3, 3, 4, 5): (0, 0), (2, 3, 6, 4, 2): (2, 0, 5), 0: (0,)}
    if any(shapes[key][1:] != (torch.float32, want[key]) or not v.is_cuda
           for key, v in empties.items()) or not all(v.is_cuda for v in lev):
        raise AssertionError(f"[15 parity] F6/F7 on the card: {shapes}; F8: levinson of a "
                             f"NumPy array on {lev[0].device}")
    print(f"[15 parity] F6 convolve2d (3, 3) by (4, 5) valid {shapes[(3, 3, 4, 5)]}, "
          f"correlate2d (2, 3, 6) by (4, 2) valid {shapes[(2, 3, 6, 4, 2)]}; F7 chirp of 0 "
          f"samples {shapes[0]}; F8 levinson of a NumPy array on {lev[0].device}")

    # the DFT functions against float64 on a slice, and their device ms
    for name, (call, want64, part) in dft.items():
        re, im = part(*outs[name])
        got = re.double().cpu().numpy() + 1j * im.double().cpu().numpy()
        ref = want64()
        e = float(np.abs(got - ref).max() / np.abs(ref).max()) if got.shape == ref.shape else 1.0
        if not e <= PARITY_RTOL:
            raise AssertionError(f"[15 parity] {name}: {got.shape} against {ref.shape}, error "
                                 f"{e:.3e} of max|X|")
        ms = statistics.median(device_ms(call, 2, 5))
        print(f"[15 parity] {name}: {ms:.4f} ms (median of 5); output {tuple(outs[name][0].shape)}"
              f" x 2 planes; error {e:.3e} of max|X| against float64 NumPy on a slice")
    for name, (call, b8) in convs.items():
        ms, b8_ms = time_pair(call, b8, warmup=1, reps=3)
        print(f"[15 parity] {name} (conv1d, IEEE float32) {ms:.4f} ms; fir_filter's B8 route "
              f"{b8_ms:.4f} ms (medians of 6 and 6, in turns)")

    # the sweep's command line with --chain, in a process of its own
    with tempfile.TemporaryDirectory() as tmp:
        csv = Path(tmp) / "sweep.csv"
        t0 = time.perf_counter()
        done = subprocess.run(
            [sys.executable, "-m", "digital_signal_processsing_tpu_torch.harness.sweep", "--smoke",
             "--chain", str(PARITY_SWEEP_CHAIN), "--out", str(csv)],
            capture_output=True, text=True, timeout=300, cwd=Path(__file__).resolve().parent,
        )
        rows = csv.read_text().splitlines() if csv.is_file() else []
        want_rows = 1 + (6 + 6 + 4) * 2 + 3  # phase 4's smoke grid
        if done.returncode != 0 or len(rows) != want_rows or rows[0] != CSV_COLUMNS or any(
                len(r.split(",")) != 14 for r in rows):
            raise AssertionError(f"[15 parity] sweep --smoke --chain {PARITY_SWEEP_CHAIN}: exit "
                                 f"{done.returncode}, {len(rows)} lines (want {want_rows} of 14 "
                                 f"columns)\n{done.stderr[-2000:]}")
        resident = [r.split(",") for r in rows[1:] if ",resident,100000,128," in r]
        print(f"[15 parity] sweep --smoke --chain {PARITY_SWEEP_CHAIN}: exit 0 in "
              f"{time.perf_counter() - t0:.1f} s, {len(rows) - 1} rows of 14 columns; resident "
              f"k=128 compute ms {', '.join(f'{r[0]} {r[6]}' for r in resident)}")
    seconds = time.perf_counter() - t_start
    print(f"[15 parity] phase 15 took {seconds:.1f} s")
    return {"launches": launches, "seconds": seconds}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(
        f"[1 device] {kind}, count {torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}"
    )
    print(smi)

    start = last = time.perf_counter()

    def mark(phase: str) -> None:
        nonlocal last
        now = time.perf_counter()
        print(f"[time] {phase}: {now - last:.1f} s (total {now - start:.1f} s)")
        last = now

    # 2. build
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    print(f"[2 build] {so.name} in {time.perf_counter() - t0:.1f} s")
    entry = "?"
    for ln in so.with_suffix(".log").read_text().splitlines():  # each kernel's resources
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln
        elif "Used" in ln:
            print(f"  {entry[:72]}: {ln.split(':', 1)[-1].strip()}")
    for ln in pfb_attrs_lines():
        print(ln)
    for ln in lookback_direct_attrs_lines():
        print(ln)
    mark("1-2 device and build")

    # 3. corners
    check = Checker()
    phase_corners(rng, dev, check)
    phase_fir_corners(rng, dev, check)
    mark("3 corners")
    phase_iir_corners(rng, dev, check)
    mark("3 IIR corners")
    phase_pfb_corners(rng, dev, check)
    mark("3 PFB/Farrow corners")
    phase_tv_corners(rng, dev, check)
    mark("3 TV/LPC corners")
    phase_anchor_corners(rng, dev, check)
    mark("3 anchor corners")

    # 4. main path
    x = torch.from_numpy(rng.integers(-32768, 32768, size=MAIN_SAMPLES, dtype=np.int16)).to(dev)
    x32 = x.view(torch.int32)
    frames_a, frames_b = 4 * 2**20, 4 * 2**20 - 1  # the second file has an odd frame count
    wav = rng.integers(-32768, 32768, size=2 * (frames_a + frames_b), dtype=np.int16)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        write_wav(tmp / "a.wav", wav[: 2 * frames_a], 48000, 2)
        write_wav(tmp / "b.wav", wav[2 * frames_a :], 48000, 2)
        write_wav(tmp / "ab.wav", wav, 48000, 2)
        torch.cuda.synchronize()

        routes, ys = [], {}

        def call(label: str, *args, **kw) -> None:
            ys[label] = moving_average(*args, **kw)
            routes.append(last_choice("moving_average"))

        reset_launch_counts()
        call("main", x, MAIN_WINDOW, 2)
        call("two", x, TWO_PASS_WINDOW, TWO_PASS_CHANNELS)
        call("packed", x32, MAIN_WINDOW, 2)
        for method in SCAN_METHODS:
            call(method, x, MAIN_WINDOW, 2, method=method)
        for k in DIRECT_WINDOWS:
            call(f"direct{k}", x, k, 2, method="direct")
        call("xla_scan", x, MAIN_WINDOW, 2, method="xla_scan")
        call("xla_direct", x, DIRECT_WINDOWS[0], 2, method="xla_direct")
        written = stream_moving_average(
            [tmp / "a.wav", tmp / "b.wav"], tmp / "served.wav", MAIN_WINDOW,
            chunk_samples=1 << 20, use_native=False, device="cuda",
        )
        if cli_main([str(tmp / "ab.wav"), str(MAIN_WINDOW), "--out", str(tmp / "cli.wav")]) != 0:
            raise AssertionError("CLI exited non-zero")
        torch.cuda.synchronize()
        launches = launch_counts()

        print(f"[4 main path] routes {routes}; launches {launches}")
        want_routes = [
            "windowed", "windowed:two_pass_fallback", "windowed_packed", *SCAN_METHODS,
            "direct", "direct", "xla_scan", "xla_direct",
        ]
        if routes != want_routes:
            raise AssertionError(f"routes {routes}; want {want_routes}")
        if min(launches[n] for n in AVERAGER_KERNELS) < 1:
            raise AssertionError(f"a kernel of the main path was never launched: {launches}")
        y_main = ys["main"]
        check.same("B1", y_main, ys["xla_scan"], "main 64M k=1024 C=2 against xla_scan")
        check.same(
            "B4", ys["two"], moving_average_xla(x, TWO_PASS_WINDOW, TWO_PASS_CHANNELS),
            "two-pass 64M k=65535 C=16",
        )
        check.same("B2", ys["packed"].view(torch.int16), y_main, "packed 64M k=1024 C=2")
        for method, v in SCAN_METHODS.items():
            check.same(f"B3/{v}", ys[method], y_main, f"{method} 64M k=1024 C=2 against B1")
        for k in DIRECT_WINDOWS:  # xla_direct's output is the plain version at the first k
            plain = ys["xla_direct"]
            if k != DIRECT_WINDOWS[0]:
                plain = moving_average_reduce_window(x, k, 2)
            check.same("B5", ys[f"direct{k}"], plain, f"direct 64M k={k} C=2 against plain")
            b1 = ps.windowed_averager(x, k, 2)
            check.same("B1", b1, plain, f"B1 64M k={k} C=2 against plain")

        one_shot = moving_average(torch.from_numpy(wav).to(dev), MAIN_WINDOW, 2).cpu().numpy()
        write_wav(tmp / "one_shot.wav", one_shot, 48000, 2)
        expected = (tmp / "one_shot.wav").read_bytes()
        if written != wav.size or (tmp / "served.wav").read_bytes() != expected:
            raise AssertionError(f"served WAV differs from the one-shot result ({written} samples)")
        if (tmp / "cli.wav").read_bytes() != expected:
            raise AssertionError("CLI WAV differs from the one-shot result")
        print(
            "[4 main path] bit-exact: 64M k=1024 C=2 (B1, xla_scan, packed, scan, scan_hillis, "
            "scan_mxu), 64M k=65535 C=16 (two-pass), direct and B1 at k=64 and 256 against "
            f"the plain shifted adds (xla_direct at k=64); served {written} samples and the CLI "
            "WAV byte-identical to one shot"
        )
        phase_sweep(tmp)

    mark("4 averager main path and sweep")
    # 4. main path of the receiver chain and the FIR
    chain_launches, chain_main = phase_chain_main(rng, dev, check)
    mark("4 chain main path")
    # 4. main path of the IIR family: sosfilt, dc_block/agc, filtfilt, decimate, serving
    iir_launches, iir_main = phase_iir_main(rng, dev, check, wav, 2 * frames_a)
    mark("4 IIR main path")
    # 4. main path of the wideband receiver, the oversampled bank and the Farrow stage
    wide_launches, wide_main = phase_wideband_main(dev, check, chain_main)
    mark("4 wideband main path")
    # 4. main path of the time-varying IIR family, LPC and the tracking notch
    tv_launches, tv_main = phase_tv_main(rng, dev, check)
    mark("4 TV/LPC main path")
    # 4. main path of the filter-design path: designers, the anchors, CIC, streaming FIR, splines
    design_launches, design_main = phase_design_main(rng, dev, check)
    mark("4 design main path")

    # 5. times
    n = MAIN_SAMPLES
    copy_dst = torch.empty_like(x)
    copy_ms, _ = time_pair(lambda: copy_dst.copy_(x), lambda: copy_dst.copy_(x))
    plain_main = lambda: moving_average_xla(x, MAIN_WINDOW, 2)  # noqa: E731
    b1_ms, b1_plain = time_pair(lambda: ps.windowed_averager(x, MAIN_WINDOW, 2), plain_main)
    b2_ms, b2_plain = time_pair(
        lambda: ps.windowed_averager_packed(x32, MAIN_WINDOW, 2),
        lambda: moving_average_xla(x32.view(torch.int16), MAIN_WINDOW, 2).view(torch.int32),
    )
    b3 = {
        v: time_pair(lambda v=v: ps.scan_averager(x, MAIN_WINDOW, 2, variant=v), plain_main)
        for v in VARIANTS
    }
    b4_ms, b4_plain = time_pair(
        lambda: ps.cumsum(x, TWO_PASS_CHANNELS), lambda: cumsum_ref(x, TWO_PASS_CHANNELS)
    )
    tp_ms, tp_plain = time_pair(
        lambda: ps.moving_average_two_pass(x, TWO_PASS_WINDOW, TWO_PASS_CHANNELS),
        lambda: moving_average_xla(x, TWO_PASS_WINDOW, TWO_PASS_CHANNELS),
    )
    b5 = {
        k: time_pair(
            lambda k=k: pd.direct_averager(x, k, 2),
            lambda k=k: moving_average_reduce_window(x, k, 2),
        )
        for k in DIRECT_WINDOWS
    }

    # bounds: each input byte read once, each output byte written once; int32
    # operations a sample as the kernel does them (divisions counted as one)
    bounds = {
        "B1": bound(4 * n, 4 * n),  # two prefix adds, a subtract, a divide
        "B2": bound(4 * n, 4 * n),
        "B3/blelloch": bound(4 * n, 5 * n),  # up- and down-sweep, carry, subtract, divide
        "B3/hillis_steele": bound(4 * n, 5 * n),  # sequential in a run; the doubling a run total
        "B3/mxu": bound(4 * n, 5 * n),  # the products run on the tensor cores
        "B4": bound(6 * n, 3 * n),
        "B5": bound(4 * n, DIRECT_WINDOWS[-1] * n),  # k - 1 adds and a divide
    }
    b5_bound64 = bound(4 * n, DIRECT_WINDOWS[0] * n)

    def gss(ms: float) -> str:
        return f"{ms:.4f} ms = {n / ms / 1e6:.2f} GS/s"

    print(f"[5 times] on {smi}, 64M int16 samples, median of 10 after 5 warm-ups:")
    print(f"  copy d2d (same bytes)         {gss(copy_ms)}")
    print(f"  B1 windowed k=1024 C=2        {gss(b1_ms)}; plain {gss(b1_plain)}")
    print(f"  B2 packed k=1024 C=2          {gss(b2_ms)}; plain {gss(b2_plain)}")
    for v, (ms, plain) in b3.items():
        print(f"  B3 {v:13s} k=1024 C=2  {gss(ms)}; plain {gss(plain)}; /B1 {ms / b1_ms:.3f}")
    print(f"  B4 cumsum C=16                {gss(b4_ms)}; plain {gss(b4_plain)}")
    print(f"  two-pass k=65535 C=16         {gss(tp_ms)}; plain {gss(tp_plain)}")
    for k, (ms, plain) in b5.items():
        print(f"  B5 direct k={k:<3d} C=2          {gss(ms)}; plain {gss(plain)}")
    print(
        "  bounds (ms, by): "
        + ", ".join(f"{name} {b:.4f} {by}" for name, (b, by) in bounds.items())
        + f", B5 k=64 {b5_bound64[0]:.4f} {b5_bound64[1]}"
    )
    # B5 redesigned: median (min-max) of 20 after 5 warm-ups, beside PR 2's time
    for k, bk in ((DIRECT_WINDOWS[0], b5_bound64), (DIRECT_WINDOWS[-1], bounds["B5"])):
        d = device_ms(lambda k=k: pd.direct_averager(x, k, 2), 5, 20)
        med = statistics.median(d)
        print(f"  B5 k={k:<3d} C=2 {med:.4f} ms ({min(d):.4f}-{max(d):.4f}) median (min-max) of 20; "
              f"PR 2 {DIRECT_FIRST_MS[k]:.4f} ({DIRECT_FIRST_MS[k] / med:.2f}x); bound {bk[0]:.4f} "
              f"({bk[1]}), kernel/bound {med / bk[0]:.2f}; attrs (registers, local bytes, shared "
              f"bytes, blocks an SM) {pd.direct_kernel_attrs(k, 2)}")
    # B3 redesigned: median (min-max) of 20 after 5 warm-ups, beside its time before
    for v in VARIANTS:
        d = device_ms(lambda v=v: ps.scan_averager(x, MAIN_WINDOW, 2, variant=v), 5, 20)
        med, bk = statistics.median(d), bounds[f"B3/{v}"]
        was = B9_B3_EARLIER_MS[f"B3/{v}"]
        print(f"  B3 {v:13s} k={MAIN_WINDOW} C=2 {med:.4f} ms ({min(d):.4f}-{max(d):.4f}) median "
              f"(min-max) of 20; before its redesign {was:.4f} ({was / med:.2f}x); bound {bk[0]:.4f} ({bk[1]}), "
              f"kernel/bound {med / bk[0]:.2f}; /B1 {med / b1_ms:.3f}; attrs (registers, local "
              f"bytes, shared bytes, blocks an SM) {ps.scan_kernel_attrs(MAIN_WINDOW, 2, v)}")
    # B3's generic kernel (any C outside 1, 2, 4, 8, 16) at C=3, on the same stream
    x3 = x[: n // 3 * 3]
    for v in VARIANTS[:2]:
        d = device_ms(lambda v=v: ps.scan_averager(x3, MAIN_WINDOW, 3, variant=v), 5, 20)
        med = statistics.median(d)
        print(f"  B3 {v:13s} k={MAIN_WINDOW} C=3 (generic) {med:.4f} ms ({min(d):.4f}-{max(d):.4f}) "
              f"median (min-max) of 20; attrs {ps.scan_kernel_attrs(MAIN_WINDOW, 3, v)}")
    # B1 redesigned: median (min-max) of 20 after 5 warm-ups beside its time before and
    # the prediction; both halo sources: spans of one wave (the wrapper's) and of one tile
    for label, span in (("spans of one wave", None), ("spans of one tile", 1)):
        d = device_ms(lambda span=span: ps.launch_windowed(x, MAIN_WINDOW, 2, span_tiles=span), 5, 20)
        med, bk, was = statistics.median(d), bounds["B1"], B1_EARLIER_MS["B1"]
        print(f"  B1 k={MAIN_WINDOW} C=2 {label}: {med:.4f} ms ({min(d):.4f}-{max(d):.4f}) median "
              f"(min-max) of 20; before its redesign {was:.4f} ({was / med:.2f}x); predicted "
              f"{PREDICTED_MS['B1'][0]}-{PREDICTED_MS['B1'][1]}; bound {bk[0]:.4f} ({bk[1]}), "
              f"kernel/bound {med / bk[0]:.2f}; attrs (registers, local bytes, shared bytes, "
              f"blocks an SM) {ps.windowed_kernel_attrs(MAIN_WINDOW, 2)}")
    d = device_ms(lambda: ps.windowed_averager(x3, MAIN_WINDOW, 3), 5, 20)
    print(f"  B1 k={MAIN_WINDOW} C=3 (generic) {statistics.median(d):.4f} ms "
          f"({min(d):.4f}-{max(d):.4f}); attrs {ps.windowed_kernel_attrs(MAIN_WINDOW, 3)}")
    # B2 redesigned (B1's launch on the pair words' int16 view) beside B1 in the same
    # call: 20 after 5 warm-ups each, in turns B1, B2, B2, B1
    b1_fn = lambda: ps.windowed_averager(x, MAIN_WINDOW, 2)  # noqa: E731
    b2_fn = lambda: ps.windowed_averager_packed(x32, MAIN_WINDOW, 2)  # noqa: E731
    d1 = device_ms(b1_fn, 5, 20)
    d2 = device_ms(b2_fn, 5, 20) + device_ms(b2_fn, 5, 20)
    d1 += device_ms(b1_fn, 5, 20)
    m1, m2, bk = statistics.median(d1), statistics.median(d2), bounds["B2"]
    lo, hi, ratio = B2_PREDICTED
    met = lo <= m2 <= hi and m2 / m1 <= ratio and m2 < B2_EARLIER_MS
    print(f"  B2 k={MAIN_WINDOW} C=2 {m2:.4f} ms ({min(d2):.4f}-{max(d2):.4f}) median (min-max) "
          f"of 40; B1 in the same call {m1:.4f} ({min(d1):.4f}-{max(d1):.4f}); B2/B1 "
          f"{m2 / m1:.3f}; before its redesign {B2_EARLIER_MS:.4f} ({B2_EARLIER_MS / m2:.2f}x); "
          f"predicted {lo}-{hi} ms, B2/B1 <= {ratio} and below {B2_EARLIER_MS}: "
          f"{'met' if met else 'missed'}; bound {bk[0]:.4f} ({bk[1]}), kernel/bound "
          f"{m2 / bk[0]:.2f}; attrs (registers, local bytes, shared bytes, blocks an SM: B1's "
          f"kernel) {ps.windowed_kernel_attrs(MAIN_WINDOW, 2)}")
    b4_library = phase_b4_times(x, bounds["B4"])
    phase_halo_bound(x, check)
    fir_times = phase_fir_times(chain_main)
    mark("5 averager and FIR times")
    iir_times = phase_iir_times(iir_main)
    mark("5 IIR times")
    wide_times = phase_wideband_times(wide_main)
    mark("5 wideband times")
    tv_times = phase_tv_times(tv_main, iir_times["times"]["B12"][0])
    mark("5 TV/LPC times")
    anchor_times = phase_anchor_times(design_main)
    mark("5 anchor times")

    # 6. serving loops
    phase_serve_profile(wav, 2 * frames_a)
    phase_iir_serve(wav, 2 * frames_a)
    mark("6 serving")

    # 7. the receiver chain's wall and device time
    phase_chain_profile(chain_main)
    mark("7 chain profile")
    phase_wideband_profile(wide_main)
    mark("7 wideband profile")

    # 8. the sharded path: the ring of four on the card, then world size 1 over NCCL
    ring = phase_sharded_ring(x, y_main, check)
    mark("8 sharded ring")
    with tempfile.TemporaryDirectory() as tmp:
        world1 = phase_sharded_world1(x, y_main, chain_main, tv_main, wide_main, wav,
                                      2 * frames_a, check, tmp)
    mark("8 sharded world 1")

    # 9. the spectral and correlation slice, its serving loops, and their times
    spectral_calls = phase_spectral_main(rng, dev)
    mark("9 spectral main path")
    phase_spectral_serve(wav, 2 * frames_a)
    mark("9 spectral serving")
    call_times("9 spectral times", spectral_calls)
    del spectral_calls
    mark("9 spectral times")

    # 10. the model families at the reference's family-row shapes, and their times
    model_calls = phase_models_main(dev)
    mark("10 model families")
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        call_times("10 model times", model_calls)
    finally:
        torch.set_float32_matmul_precision(saved)
    del model_calls
    mark("10 model times")

    # 11. the training path, and its times
    with tempfile.TemporaryDirectory() as tmp:
        train = phase_training_main(dev, tmp)
    mark("11 training path")
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        call_times("11 training times", train["calls"])
    finally:
        torch.set_float32_matmul_precision(saved)
    mark("11 training times")
    n_loc = MAIN_SAMPLES // RING_WORLD
    ring_bounds = {"B6": bound(2 * 2 * n_loc, 0), "B7": bound(4 * n_loc, 4 * n_loc)}

    # 12. the rest of the op surface and the scipy.signal facade, and its times
    surface = phase_surface_main(dev, x)
    mark("12 surface")
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        surface_times(surface["calls"])
    finally:
        torch.set_float32_matmul_precision(saved)
    mark("12 surface times")
    print("  bounds (ms, by): " + ", ".join(f"{k} {b:.4f} {by}" for k, (b, by) in ring_bounds.items()))

    # 13. the rest of the surface: the native serving path, device_chunks, trace, B20's
    # input gradient and the twelve examples
    rest = phase_rest_main(dev, x, y_main, wav, 2 * frames_a)
    mark("13 rest of the surface")

    # 14. the multi-card surface: four processes on the one card, then the dry runs
    multicard = phase_multicard(dev, x, y_main, wav, 2 * frames_a, wide_main, smi)
    mark("14 multi-card surface")

    # 15. parity with the JAX package: the K-differential timer, the planar DFT functions,
    # the renamed convolutions and F6-F8
    parity = phase_parity(dev, x, b1_ms, smi)
    mark("15 parity")

    def entry(name, kernel, source, replaces, ms, plain_ms, library_ms=None):
        return {
            "name": name, "route": "cuda", "source": SOURCE + source, "replaces": replaces,
            "launches": launches[kernel], "max_abs_err": check.max_err[kernel], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bounds[kernel][0], "bound_by": bounds[kernel][1],
            "library_ms": library_ms,
        }

    record = {
        "kernels": [
            entry("windowed_averager", "B1", "windowed.cu", REPLACES + "492", b1_ms, b1_plain),
            {
                **entry("windowed_averager_packed", "B2", "windowed.cu", REPLACES + "530", b2_ms,
                        b2_plain),
                # B1's launch (dsp_windowed_i16_range) on the pair words' int16 view
                "kernel": "scan_kernel<1, 2, true> (run_tile.cuh), B1's span kernel",
                "registers": ps.windowed_kernel_attrs(MAIN_WINDOW, 2)[0],
            },
            *(
                entry(f"scan_averager[{v}]", f"B3/{v}", "scan.cu", REPLACES + "847", *b3[v])
                for v in VARIANTS
            ),
            entry("cumsum", "B4", "cumsum.cu", REPLACES + "971", b4_ms, b4_plain, b4_library),
            entry(
                "direct_averager", "B5", "direct.cu", REPLACES_DIRECT + "59",
                *b5[DIRECT_WINDOWS[-1]],
            ),
            *(
                {
                    "name": name, "route": "cuda", "source": SOURCE + source,
                    "replaces": REPLACES_FFT + line, "launches": chain_launches[kernel],
                    "max_abs_err": check.max_err[kernel], "ms": fir_times[kernel]["ms"],
                    "plain_ms": fir_times[kernel]["plain"],
                    "bound_ms": fir_times[kernel]["bound"][0],
                    "bound_by": fir_times[kernel]["bound"][1],
                    "library_ms": fir_times[kernel]["library"],
                }
                for name, kernel, source, line in (
                    ("fused_fir", "B8", "fused_fir.cu", "411"),
                    ("fused_fir3", "B9", "fused_fir3.cu", "537"),
                )
            ),
            *(
                {
                    "name": name, "route": "cuda", "source": SOURCE + "iir.cu",
                    "replaces": REPLACES_IIR + line, "launches": iir_launches[kernel],
                    "max_abs_err": check.max_err[kernel], "ms": iir_times["times"][kernel][0],
                    "plain_ms": iir_times["times"][kernel][1],
                    "bound_ms": iir_times["bounds"][kernel][0],
                    "bound_by": iir_times["bounds"][kernel][1],
                    "library_ms": iir_times["library"][kernel],
                }
                for name, kernel, line in (
                    ("iir1_block_scan", "B10", "608"),
                    ("sos_cascade", "B12", "1249"),
                    ("sos_cascade_unrolled", "B13", "1114"),
                    ("sos_sections", "B15", "761"),
                )
            ),
            *(
                {
                    "name": name, "route": "cuda", "source": SOURCE + source, "replaces": replaces,
                    # B20 also runs in every step of the designer (phase 11)
                    "launches": wide_launches[kernel] + train["launches"].get(kernel, 0),
                    "max_abs_err": max(check.max_err[kernel], train["check"].max_err[kernel]),
                    "ms": wide_times[key]["ms"], "plain_ms": wide_times[key]["plain"],
                    "bound_ms": wide_times[key]["bound"][0], "bound_by": wide_times[key]["bound"][1],
                    "library_ms": None,
                }
                for name, kernel, key, source, replaces in (
                    ("fused_pfb_raw", "B19", "B19 n=64", "pfb.cu", REPLACES_PFB + "191"),
                    ("fused_branch_dft", "B20", "B20 os", "pfb.cu", REPLACES_PFB + "78"),
                    ("resample_farrow_segmented", "B21", "B21", "farrow.cu", REPLACES_FARROW + "503"),
                )
            ),
            *(
                {
                    "name": name, "route": "cuda", "source": SOURCE + source, "replaces": replaces,
                    "launches": tv_launches[kernel], "max_abs_err": check.max_err[kernel],
                    "ms": tv_times["times"][kernel][0], "plain_ms": tv_times["times"][kernel][3],
                    "bound_ms": tv_times["bounds"][kernel][0],
                    "bound_by": tv_times["bounds"][kernel][1], "library_ms": None,
                }
                for name, kernel, source, replaces in (
                    ("tv_cascade", "B16", "iir_tv.cu", REPLACES_IIR + "2935"),
                    ("tv_section", "B17", "iir_tv.cu", REPLACES_IIR + "2181"),
                    ("tv_frames_cascade", "B18", "iir_tv.cu", REPLACES_IIR + "2472"),
                    ("lpc_synth_pass", "B22", "lpc.cu", REPLACES_LPC + "296"),
                )
            ),
            *(
                {
                    "name": name, "route": "cuda", "source": SOURCE + "iir.cu",
                    "replaces": REPLACES_IIR + line, "launches": design_launches[kernel],
                    "max_abs_err": check.max_err[kernel],
                    "ms": anchor_times["times"][kernel][0],
                    "plain_ms": anchor_times["times"][kernel][3],
                    "bound_ms": anchor_times["bounds"][kernel][0],
                    "bound_by": anchor_times["bounds"][kernel][1],
                    "library_ms": anchor_times["library"][kernel],
                }
                for name, kernel, line in (
                    ("iir1_affine_scan", "B11", "441"),
                    ("sos_cascade_mxu", "B14", "1390"),
                )
            ),
            *(
                {
                    "name": name, "route": "cuda", "source": SOURCE + "ring.cu",
                    "replaces": REPLACES_RING + line, "launches": ring["launches"][kernel],
                    "max_abs_err": check.max_err[kernel], "ms": ring["times"][kernel][0],
                    "plain_ms": ring["times"][f"{kernel} plain"][0],
                    "bound_ms": ring_bounds[kernel][0], "bound_by": ring_bounds[kernel][1],
                    "library_ms": library,
                }
                # no PyTorch call computes a cross-process ring shift on one card
                # (NCCL refuses two ranks on one device; B6's copy of the shard is a
                # yardstick of its bytes, printed in phase 8, not its function)
                for name, kernel, line, library in (
                    ("ring_shift_right_shard", "B6", "42", None),
                    ("fused_ring_windowed_shard", "B7", "174", None),
                )
            ),
            *(
                {
                    "name": name, "route": "cuda", "source": SOURCE + "adaptive.cu",
                    # no Pallas kernel: the reference runs the recursion as one lax.scan
                    "replaces": "digital_signal_processsing_tpu/models/adaptive.py:" + line,
                    "launches": train["launches"][kernel],
                    "max_abs_err": train["check"].max_err[kernel],
                    "ms": train["times"][kernel]["ms"], "plain_ms": train["times"][kernel]["plain"],
                    "bound_ms": train["times"][kernel]["bound"][0],
                    "bound_by": train["times"][kernel]["bound"][1],
                    # no PyTorch call runs an NLMS or RLS recursion
                    "library_ms": None,
                }
                for name, kernel, line in (("nlms_scan", "S1", "227"), ("rls_scan", "S2", "267"))
            ),
            {
                "name": "dlsim_scan", "route": "cuda", "source": SOURCE + "lti.cu",
                # no Pallas kernel: the reference runs dlsim as one lax.scan
                "replaces": "digital_signal_processsing_tpu/ops/lti.py:195",
                "launches": surface["launches"]["S3"],
                "max_abs_err": surface["check"].max_err["S3"],
                "ms": surface["times"]["S3 n=8"]["ms"], "plain_ms": surface["times"]["S3 n=8"]["plain"],
                "bound_ms": surface["times"]["S3 n=8"]["bound"][0],
                "bound_by": surface["times"]["S3 n=8"]["bound"][1],
                # no PyTorch call runs a state-space recursion
                "library_ms": None,
            },
        ]
    }
    for e in record["kernels"]:  # phases 13-15 launch kernels of earlier slices
        e["launches"] += sum(part["launches"][ENTRY_KERNELS[e["name"]]]
                             for part in (rest, multicard, parity))
    print(json.dumps(record))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
