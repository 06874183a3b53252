"""Where the float32 3D patch train step's time goes, by cuDNN kernel, and
what cuDNN's own algorithm search (`torch.backends.cudnn.benchmark`) does
to it. Not part of the library: run it alone on the card, from the
repository root,

    python3 ctseg_tpu_torch/csrc/tools/probe_conv3d_fp32.py [--batch 128]
    python3 ctseg_tpu_torch/csrc/tools/probe_conv3d_fp32.py --sites

It builds chip_smoke.py's bench 3D configuration (the 3D UNet 64..1024, 2
residual units, CrossEntropy+Dice, patch mode, (128, 128, 16) patches from
4 synthetic 120x280x280 volumes) and prints the card's name and power
limit, then for cudnn.benchmark False, True, True, False in turns: the
float32 step time (host clock around 3 steps on one batch after 2 warm-ups,
which with benchmark on include its search), and the step's device time by
kernel name from torch.profiler (the ten largest). The same for bfloat16
once, as the yardstick. TF32 stays off, as in every entry point of the port.

With --sites it prints, for every distinct library conv of one float32
forward of that model (recorded at the call), the weight gradient alone
(`aten.convolution_backward` with only the weight's mask, CUDA events, mean
of 2 after a warm-up) with the input stored channels_last_3d, as the port
stores it, and stored contiguous (N, C, D... order), and the conv's
operations at that time.
"""

import argparse
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[3]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from ctseg_tpu_torch.ops import _build  # noqa: E402
from ctseg_tpu_torch.training.config import use_float32_convs  # noqa: E402
from ctseg_tpu_torch.volumetric.pipeline3d import PatchPipeline3D  # noqa: E402
from ctseg_tpu_torch.volumetric.trainer3d import make_trainer_3d  # noqa: E402

STEPS = 3


def by_kernel(step):
    """The ten largest kernels of one step, ms each (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    total = sum(r[0] for r in rows)
    return total, rows[:10]


def run(label, dtype, batch, data, benchmark):
    torch.backends.cudnn.benchmark = benchmark
    trainer = make_trainer_3d(chip_smoke._config_3d(dtype, batch), "patch",
                              chip_smoke.PATCH_3D, "cuda")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    pipe = PatchPipeline3D(data, batch, chip_smoke.PATCH_3D, 1, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    b = pipe.gather(pipe.draw(gen))
    draws = trainer.draw(gen, b[0])
    for _ in range(2):
        trainer.train_step(state, b, draws)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        trainer.train_step(state, b, draws)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / STEPS * 1e3
    total, rows = by_kernel(lambda: trainer.train_step(state, b, draws))
    print(f"[{label}] {dtype} batch {batch}, cudnn.benchmark={benchmark}: "
          f"{step_ms:.3f} ms/step (host clock, {STEPS} steps); kernels "
          f"{total:.3f} ms a step, the largest (ms, launches, name): "
          + "; ".join(f"{ms:.3f} x{n} {name[:90]}" for ms, n, name in rows),
          flush=True)
    del trainer, state, pipe, b
    torch.cuda.empty_cache()
    return step_ms


def sites(label, batch):
    """The weight gradient of each distinct conv of the 3D UNet alone."""
    import math

    from ctseg_tpu_torch.models import layers

    trainer = make_trainer_3d(chip_smoke._config_3d("float32", batch),
                              "patch", chip_smoke.PATCH_3D, "cuda")
    model = trainer.init_state(torch.Generator().manual_seed(0)).model
    seen = {}
    fns = {False: layers._CONV_FN[5], True: layers._CONV_T_FN[5]}

    def recorder(transposed):
        def call(x, w, b, stride, padding, *rest):
            y = fns[transposed](x, w, b, stride, padding, *rest)
            key = (transposed, tuple(x.shape), tuple(w.shape), tuple(stride),
                   tuple(padding), tuple(rest[0]) if rest else (0, 0, 0))
            seen[key] = seen.get(key, 0) + 1
            seen.setdefault(("out",) + key, tuple(y.shape))
            return y
        return call

    layers._CONV_FN[5], layers._CONV_T_FN[5] = recorder(False), recorder(True)
    try:
        with torch.no_grad():
            x = torch.randn((batch, 1) + chip_smoke.PATCH_3D, device="cuda")
            model(x.contiguous(memory_format=torch.channels_last_3d))
    finally:
        layers._CONV_FN[5], layers._CONV_T_FN[5] = fns[False], fns[True]
    del model, trainer
    torch.cuda.empty_cache()
    total = {"channels_last_3d": 0.0, "contiguous": 0.0}
    for key, count in seen.items():
        if key[0] == "out":
            continue
        transposed, xs, ws, stride, padding, out_pad = key
        ys = seen[("out",) + key]
        # a conv's products are its outputs times Cin k^3; a transposed
        # conv's its inputs times Cout k^3 (w is (Cin, Cout, k, k, k))
        ops = 2 * math.prod(xs if transposed else ys) * math.prod(ws[1:])
        times = {}
        for fmt, mf in (("channels_last_3d", torch.channels_last_3d),
                        ("contiguous", torch.contiguous_format)):
            x = torch.randn(xs, device="cuda").contiguous(memory_format=mf)
            g = torch.randn(ys, device="cuda").contiguous(memory_format=mf)
            w = torch.randn(ws, device="cuda")
            bias = [ws[1] if transposed else ws[0]]

            def wgrad():
                return torch.ops.aten.convolution_backward(
                    g, x, w, bias, list(stride), list(padding), [1, 1, 1],
                    transposed, list(out_pad), 1, [False, True, False])

            times[fmt] = chip_smoke.time_ms(wgrad, 2)
            total[fmt] += count * times[fmt]
            del x, g, w
            torch.cuda.empty_cache()
        print(f"[{label}] {'convT' if transposed else 'conv'} x {tuple(xs)} "
              f"w {tuple(ws)} stride {stride}: {count} a forward; weight "
              f"gradient {times['channels_last_3d']:.3f} ms channels_last_3d"
              f", {times['contiguous']:.3f} ms contiguous "
              f"({ops / times['channels_last_3d'] / 1e9:.2f} TFLOP/s)",
              flush=True)
    print(f"[{label}] weight gradients of one float32 step at batch {batch}: "
          f"{total['channels_last_3d']:.3f} ms channels_last_3d, "
          f"{total['contiguous']:.3f} ms contiguous")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=chip_smoke.TRAIN_BATCH)
    parser.add_argument("--sites", action="store_true")
    args = parser.parse_args()
    label = chip_smoke.card_label()
    print(label)
    use_float32_convs()
    _build.library()
    if args.sites:
        sites(label, args.batch)
        return
    data = chip_smoke._volumes_3d(0, 4)
    for benchmark in (False, True, True, False):
        run(label, "float32", args.batch, data, benchmark)
    run(label, "bfloat16", args.batch, data, False)


if __name__ == "__main__":
    main()
