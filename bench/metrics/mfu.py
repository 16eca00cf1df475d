"""``mfu``: the window's model operations (``bench.flops.<family>``, one
step's, times the steps completed in it) over its seconds and over the
card's bfloat16 dense peak, in %."""


def read(ctx):
    if not ctx["steps"]:
        return None
    rate = ctx["flops_per_step"] * ctx["steps"] / ctx["window_s"]
    return 100.0 * rate / ctx["peaks"]["bf16_tensor_flops"]
