"""B2's share of its roofline in the traced offline calls: the least
time of its launches (`work/b2.py`: each block's intra-frequency BiLSTM,
F-k+1 steps over every frame, and its inter-time BiLSTM, T-k+1 steps
over every bin, both directions, at each traced call's clip length and
batch) over their device time, found by the kernel's name."""

KERNEL = ("bilstm_scan_kernel<64, false>",)


def read(ctx):
    tr, cell = ctx["trace"], ctx["cell"]
    if tr is None:
        return None
    times = tr.matching(KERNEL)
    if not times:
        return None
    mp, w = cell.config["model_params"], ctx["work"]
    net = w("embed_forward")
    f, k, h = mp["n_fft"] // 2 + 1, net.KERNEL, net.HIDDEN
    rows = ctx["rows_per_step"]
    least, launches = 0.0, 0
    for n in ctx["traced_samples"]:
        t = net.frames(mp, n)
        for shape in ((f - k + 1, 2, t * rows, h),
                      (t - k + 1, 2, f * rows, h)):
            least += mp["num_blocks"] * ctx["least_s"](*w("b2").work(*shape))
            launches += mp["num_blocks"]
    # the mean least time a launch, over the launches the trace kept
    return 100.0 * least / launches * len(times) * 1e6 / sum(times)
