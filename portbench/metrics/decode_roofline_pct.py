"""decode_roofline_pct (device trace): the decoder core's least time
(pb.counts.decode_core at the call's rows) over the device time of its
kernels (stage_kernel launches and one final_kernel) per call."""

from pb import counts

KERNELS = ("stage_kernel", "final_kernel")


def read(run):
    mix = run.traffic
    if run.trace is None or "clouds_per_call" not in mix \
            or not run.trace.launches.get("final_kernel"):
        return None
    per_call = sum(run.trace.kernel_s.get(k, 0.0) for k in KERNELS) \
        / run.trace.launches["final_kernel"]
    flops, nbytes = counts.decode_core(run.config, mix["clouds_per_call"] * mix["grasps"])
    return 100.0 * counts.least_time_s(flops, nbytes) / per_call
