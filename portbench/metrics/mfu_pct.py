"""mfu_pct (host clock): the model FLOPs of the window's completed calls
(pb.counts.call_flops: encode, every denoiser evaluation that the mix's
sampler makes, decode) over the window's seconds times the float32 peak
(pb.counts.PEAK_F32_FLOPS). Cells whose calls all have one size."""

from pb import counts


def read(run):
    mix = run.traffic
    if "clouds_per_call" not in mix:
        return None
    evals = run.sampler().evaluations(mix["steps"]) if mix["entry"] == "ldm" else 0
    flops = counts.call_flops(run.config, mix["clouds_per_call"], mix["grasps"], evals)
    done = sum(c["error"] is None for c in run.calls)
    return 100.0 * done * flops / (run.window_s * counts.PEAK_F32_FLOPS)
