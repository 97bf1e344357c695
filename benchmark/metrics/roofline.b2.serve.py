"""B2's share of its roofline in the serving step: the least time of
its launches in the trace (`work/b2.py` at the step's shapes: T = F
bins, both directions, one row a stream) over their device time. The
graph replay has no CPU range around each launch, so the launches are
found by the kernel's name."""

# the inference scan's kernel at each width (csrc/bilstm_scan.cu)
KERNELS = {64: ("bilstm_scan_kernel<64, false>",),
           128: ("bilstm_h128_mma_kernel<", ", false>")}


def read(ctx):
    tr, cell = ctx["trace"], ctx["cell"]
    mp = cell.config["model_params"]
    if tr is None or mp["H"] not in KERNELS:
        return None
    times = tr.matching(KERNELS[mp["H"]])
    if not times:
        return None
    f = (mp["stft_chunk_size"] + mp["stft_pad_size"]) // 2 + 1
    w = ctx["work"]
    flops, nbytes = w("b2").work(f, 2, ctx["rows_per_step"], mp["H"])
    least = ctx["least_s"](flops, nbytes)
    return 100.0 * len(times) * least * 1e6 / sum(times)
