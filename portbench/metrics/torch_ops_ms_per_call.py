"""torch_ops_ms_per_call (device trace): device time per call of every
operation that is not one of the program's hand-written kernels (the
__global__ functions of its CUDA sources): PVCNN's cuDNN convolutions and
norms, normalisation, repeat_interleave, tmrp_to_H, copies and sets."""


def read(run):
    if run.trace is None:
        return None
    calls = sum(c["error"] is None for c in run.calls)
    if not calls:
        return None
    other = sum(t for name, t in run.trace.kernel_s.items() if name not in run.handwritten)
    return 1e3 * other / calls
