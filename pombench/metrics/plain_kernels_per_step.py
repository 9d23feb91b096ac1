"""Device kernels per internal step that are not the port's hand-written
kernels (``handwritten_kernels.txt``): the plain PyTorch kernels that the
host launches one by one, diagnostics and forcing included."""

from pombench.metrics import handwritten

LAYER = "step"
UNIT = "kernels/step"
MOVES = "gpts_per_s"
KERNELS = ()


def read(trace):
    if trace.steps <= 0 or not trace.ops:
        return None
    own = handwritten()
    n = sum(1 for o in trace.ops
            if o.kernel and not any(k in o.name for k in own))
    return n / trace.steps
