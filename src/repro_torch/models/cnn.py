"""AlexNet (CIFAR variant) and ResNet20, the paper's own evaluation models
(counterpart of ``repro/models/cnn.py``).

The param and stats trees are the reference's: the same names and nesting,
conv kernels HWIO ``(kh, kw, cin, cout)``, FC weights ``(in, out)``, so the
controller's per-tensor paths and ``repro_torch.interop`` carry them as
they are. Images come in NHWC ``(B, 32, 32, 3)``, as the reference takes
them; inside, the forward computes in NCHW, PyTorch's layout for
``conv2d``, and goes back to the reference's (H, W, C) order where it
flattens.

The convolution is PyTorch's (cuDNN on the card), as the reference's is
``lax.conv_general_dilated`` outside any Pallas kernel. Three things keep
it the reference's f32 convolution:

- ``"SAME"`` padding is XLA's: total = (out − 1)·s + k − in, low =
  total // 2, so a 3×3 kernel at stride 2 on 32×32 pads 0 above and left
  and 1 below and right (``same_pads``); ``padding=1`` would shift every
  output;
- TF32 is off and cuDNN takes deterministic algorithms in the forward and
  in the backward (``_Conv2d``), whatever the caller's global flags say:
  two runs of a step on the card give the same bits;
- batch norm is written out (``batch_norm``) with the population variance
  and the reference's running-stats convention.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import fixed_point as fxp
from repro_torch.core import init as weight_init
from repro_torch.device import resolve_device


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _cudnn_flags():
    """f32 convolutions without TF32, deterministic algorithms, no
    autotuning (``benchmark``), for the call inside the context."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


class _Conv2d(torch.autograd.Function):
    """A pad-free NCHW convolution of ``x`` by the OIHW ``w``. The forward
    and the backward (dgrad and wgrad, where cuDNN's nondeterministic
    algorithms live) both run under ``_cudnn_flags``: the backward runs
    inside the step's ``autograd.grad``, outside any context the forward
    entered."""

    @staticmethod
    def forward(ctx, x, w, stride: int):
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        with _cudnn_flags():
            return F.conv2d(x, w, stride=stride)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        s = ctx.stride
        with _cudnn_flags():
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, [s, s], [0, 0], [1, 1], False, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw, None


def conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """``"SAME"`` convolution of NCHW ``x`` by the HWIO kernel ``w``, in
    x's dtype (``w.astype(x.dtype)`` as in the reference). The padding is
    an ``F.pad`` outside the convolution, so its backward is autograd's."""
    kh, kw = w.shape[0], w.shape[1]
    top, bottom = same_pads(x.shape[2], kh, stride)
    left, right = same_pads(x.shape[3], kw, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return _Conv2d.apply(x, w.to(x.dtype).permute(3, 2, 0, 1), stride)


def max_pool(x: torch.Tensor, size: int = 2, stride: int = 2) -> torch.Tensor:
    """``"VALID"`` max pooling of NCHW ``x``."""
    return F.max_pool2d(x, size, stride)


def batch_norm(x: torch.Tensor, p: Dict[str, torch.Tensor],
               stats: Dict[str, torch.Tensor], train: bool,
               momentum: float = 0.9, eps: float = 1e-5
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's batch norm of NCHW ``x`` per channel. ``train``:
    normalize by the batch's mean and population variance (``jnp.var``,
    ddof 0: ``F.batch_norm`` and ``torch.var`` default to the unbiased one)
    and return new stats momentum·old + (1 − momentum)·batch, without a
    graph; else normalize by ``stats`` and return them unchanged."""
    if train:
        mean = torch.mean(x, dim=(0, 2, 3))
        centered = x - mean.reshape(1, -1, 1, 1)
        var = torch.mean(centered * centered, dim=(0, 2, 3))
        new = {"mean": momentum * stats["mean"] + (1 - momentum) * mean.detach(),
               "var": momentum * stats["var"] + (1 - momentum) * var.detach()}
    else:
        mean, var = stats["mean"], stats["var"]
        new = stats

    def c(t):
        return t.reshape(1, -1, 1, 1)

    y = (x - c(mean)) * c(torch.rsqrt(var + eps)) * c(p["norm_scale"]) \
        + c(p["norm_bias"])
    return y, new


def _nchw(images: torch.Tensor) -> torch.Tensor:
    return images.permute(0, 3, 1, 2)


def _linear(h: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """h @ w + b, a bf16 container's leaves promoted to h's f32 as jnp
    promotes them."""
    return h @ p["w"].to(h.dtype) + p["b"].to(h.dtype)


def _conv_init(gen, kh, kw, cin, cout, device):
    return weight_init.tnvs(gen, (kh, kw, cin, cout), kind="conv",
                            device=device)


def _generator(seed: int, device) -> Tuple[torch.Generator, torch.device]:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return gen, dev


# ---------------------------------------------------------------------------
# AlexNet (CIFAR)


def init_alexnet(seed: int, num_classes: int = 10, width: float = 1.0, *,
                 device=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Fresh TNVS weights from the integer ``seed`` on ``device`` (default
    ``cuda``), the reference's shapes at ``width``; no stats."""
    gen, dev = _generator(seed, device)

    def w(c):
        return max(int(c * width), 8)

    def fc(n_in, n_out):
        return {"w": weight_init.tnvs(gen, (n_in, n_out), device=dev),
                "b": torch.zeros((n_out,), dtype=torch.float32, device=dev)}

    params = {
        "conv1": {"w": _conv_init(gen, 3, 3, 3, w(64), dev)},
        "conv2": {"w": _conv_init(gen, 3, 3, w(64), w(192), dev)},
        "conv3": {"w": _conv_init(gen, 3, 3, w(192), w(384), dev)},
        "conv4": {"w": _conv_init(gen, 3, 3, w(384), w(256), dev)},
        "conv5": {"w": _conv_init(gen, 3, 3, w(256), w(256), dev)},
        "fc1": fc(w(256) * 16, w(1024)),
        "fc2": fc(w(1024), w(1024)),
        "fc3": fc(w(1024), num_classes),
    }
    return params, {}


def alexnet_forward(params, stats, x: torch.Tensor, train: bool = True
                    ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 32, 32, 3) → logits (B, classes); the stats pass through."""
    h = torch.relu(conv(_nchw(x), params["conv1"]["w"]))
    h = max_pool(h)                                   # 16x16
    h = torch.relu(conv(h, params["conv2"]["w"]))
    h = max_pool(h)                                   # 8x8
    h = torch.relu(conv(h, params["conv3"]["w"]))
    h = torch.relu(conv(h, params["conv4"]["w"]))
    h = torch.relu(conv(h, params["conv5"]["w"]))
    h = max_pool(h)                                   # 4x4
    # fc1's rows are in the reference's NHWC flatten order (H, W, C)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = torch.relu(_linear(h, params["fc1"]))
    h = torch.relu(_linear(h, params["fc2"]))
    return _linear(h, params["fc3"]), stats


# ---------------------------------------------------------------------------
# ResNet20 (CIFAR)


def init_resnet20(seed: int, num_classes: int = 10, width: float = 1.0, *,
                  device=None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Fresh TNVS weights from the integer ``seed`` on ``device`` (default
    ``cuda``), the reference's shapes at ``width``; batch-norm stats of
    mean 0 and var 1. A block takes a 1×1 ``down`` conv where its stride
    or its width changes."""
    gen, dev = _generator(seed, device)

    def w(c):
        return max(int(c * width), 4)

    chans = [w(16), w(32), w(64)]
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def bn(c):
        return ({"norm_scale": torch.ones((c,), dtype=torch.float32,
                                          device=dev),
                 "norm_bias": torch.zeros((c,), dtype=torch.float32,
                                          device=dev)},
                {"mean": torch.zeros((c,), dtype=torch.float32, device=dev),
                 "var": torch.ones((c,), dtype=torch.float32, device=dev)})

    p, s = bn(chans[0])
    params["stem"] = {"w": _conv_init(gen, 3, 3, 3, chans[0], dev), **p}
    stats["stem"] = s
    cin = chans[0]
    for stage, cout in enumerate(chans):
        for block in range(3):
            name = f"s{stage}b{block}"
            stride = 2 if (stage > 0 and block == 0) else 1
            p1, s1 = bn(cout)
            p2, s2 = bn(cout)
            bp = {"conv1": {"w": _conv_init(gen, 3, 3, cin, cout, dev), **p1},
                  "conv2": {"w": _conv_init(gen, 3, 3, cout, cout, dev), **p2}}
            bs = {"conv1": s1, "conv2": s2}
            if stride != 1 or cin != cout:
                pd, sd = bn(cout)
                bp["down"] = {"w": _conv_init(gen, 1, 1, cin, cout, dev), **pd}
                bs["down"] = sd
            params[name] = bp
            stats[name] = bs
            cin = cout
    params["fc"] = {"w": weight_init.tnvs(gen, (chans[2], num_classes),
                                          device=dev),
                    "b": torch.zeros((num_classes,), dtype=torch.float32,
                                     device=dev)}
    return params, stats


def _basic_block(bp, bs, x, stride, train):
    h, n1 = batch_norm(conv(x, bp["conv1"]["w"], stride), bp["conv1"],
                       bs["conv1"], train)
    h = torch.relu(h)
    h, n2 = batch_norm(conv(h, bp["conv2"]["w"]), bp["conv2"], bs["conv2"],
                       train)
    new = {"conv1": n1, "conv2": n2}
    if "down" in bp:
        x, nd = batch_norm(conv(x, bp["down"]["w"], stride), bp["down"],
                           bs["down"], train)
        new["down"] = nd
    return torch.relu(x + h), new


def resnet20_forward(params, stats, x: torch.Tensor, train: bool = True
                     ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 32, 32, 3) → (logits (B, classes), new stats)."""
    new_stats: Dict[str, Any] = {}
    h, new_stats["stem"] = batch_norm(conv(_nchw(x), params["stem"]["w"]),
                                      params["stem"], stats["stem"], train)
    h = torch.relu(h)
    for stage in range(3):
        for block in range(3):
            name = f"s{stage}b{block}"
            stride = 2 if (stage > 0 and block == 0) else 1
            h, new_stats[name] = _basic_block(params[name], stats[name], h,
                                              stride, train)
    h = torch.mean(h, dim=(2, 3))                     # over H and W
    return _linear(h, params["fc"]), new_stats


MODELS: Dict[str, Tuple[Callable, Callable]] = {
    "alexnet": (init_alexnet, alexnet_forward),
    "resnet20": (init_resnet20, resnet20_forward),
}


def ce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the rows, in f32."""
    logp = F.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels.long()[:, None]))


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Share of rows whose first argmax is the label (f32; the mean of a
    0/1 mask, as the reference's bits: ``fixed_point.exact_mean``)."""
    hit = torch.argmax(logits, dim=-1) == labels.long()
    return fxp.exact_mean(hit.to(torch.float32))


def _sorted_leaves(tree, prefix: Tuple[str, ...] = ()):
    """(keys, leaf) in ``jax.tree_util``'s order: dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sorted_leaves(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def layer_madds(params, input_hw: int = 32) -> Dict[str, float]:
    """Per-tensor MAdds of one forward pass (the paper's perf model's
    inputs), in the reference's order: convs kh·kw·cin·cout·H_out·W_out,
    FC in·out. The spatial sizes are the reference's rule as it stands,
    by name: a name holding "conv2" or "s1" takes 16×16, one holding
    "conv3", "conv4", "conv5" or "s2" takes 8×8. So ResNet20's stage-0
    ``conv2`` layers take 16×16 where their outputs are 32×32
    (``repro/models/cnn.py:201-202``); the port keeps the rule, so that
    the perf model gives the reference's numbers."""
    out: Dict[str, float] = {}
    for keys, leaf in _sorted_leaves(params):
        if keys[-1] != "w" or leaf.ndim < 2:
            continue
        name = "/".join(keys)
        if leaf.ndim == 4:
            kh, kw, cin, cout = leaf.shape
            hw = input_hw
            if "conv2" in name or "s1" in name:
                hw = input_hw // 2
            if any(t in name for t in ("conv3", "conv4", "conv5", "s2")):
                hw = input_hw // 4
            out[name] = float(kh * kw * cin * cout * hw * hw)
        else:
            out[name] = float(leaf.shape[-2] * leaf.shape[-1])
    return out
