"""sampler_roofline_pct (device trace): the whole-trajectory sampler
kernel's least time (pb.counts.sampler_launch at the call's rows and the
evaluations that the mix's sampler makes) over its device time per
launch. The kernel is the mix's ``sampler_kernel``."""

from pb import counts


def read(run):
    mix = run.traffic
    kernel = mix.get("sampler_kernel")
    if run.trace is None or "clouds_per_call" not in mix or not run.trace.launches.get(kernel):
        return None
    per_launch = run.trace.kernel_s[kernel] / run.trace.launches[kernel]
    sampler = run.sampler()
    flops, nbytes = counts.sampler_launch(run.config, mix["clouds_per_call"] * mix["grasps"],
                                          sampler.evaluations(mix["steps"]),
                                          sampler.draws(run.config, mix["steps"]))
    return 100.0 * counts.least_time_s(flops, nbytes) / per_launch
