"""A functional restatement of the reference implementation's forward
(ImMatchNet, ``lib/model.py``), in plain PyTorch, for the parity kit.

``parity_kit`` drives it with a checkpoint's own weights and holds the
port's forward against it, so that an import error in either weight
layout, or a composition that differs from the reference's, shows as an
activation difference.  It states the reference semantics directly:

  * the ResNet-101 trunk to layer3 (torchvision layout, eval-mode
    BatchNorm) and featureL2Norm with the eps inside the square root
    (``model.py:14-17``);
  * the 4D correlation as a ``bmm`` (``model.py:106-115``);
  * MutualMatching with eps 1e-5 and the reference's parenthesization
    (``model.py:155-175``);
  * the stack-level symmetric NeighConsensus with the conv4d as a loop of
    conv3d over hA (``conv4d.py:39-48``);
  * ``maxpool4d`` (``model.py:177-191``) and ``corr_to_matches``
    (``point_tnf.py:12-80``).

Volumes here are the reference's ``(B, 1, hA, wA, hB, wB)``, features
NCHW, NC weights ``(C_out, C_in, kA, kWA, kB, kWB)``.  Nothing here
imports the rest of the port.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# the reference-default trunk cut: conv1 .. layer3
RESNET101_STAGES_L3 = {"layer1": 3, "layer2": 4, "layer3": 23}


def torch_resnet101_features(sd: Dict[str, np.ndarray],
                             x: torch.Tensor) -> torch.Tensor:
    """ResNet-101 to layer3 on NCHW ``x`` from a torchvision-named
    ``state_dict`` of numpy arrays."""
    t = {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}

    def bn(y, p):
        return F.batch_norm(
            y, t[p + ".running_mean"], t[p + ".running_var"],
            t[p + ".weight"], t[p + ".bias"], training=False, eps=1e-5)

    x = F.relu(bn(F.conv2d(x, t["conv1.weight"], stride=2, padding=3), "bn1"))
    x = F.max_pool2d(x, 3, 2, 1)
    for stage, n in RESNET101_STAGES_L3.items():
        for i in range(n):
            p = f"{stage}.{i}"
            stride = 2 if (i == 0 and stage != "layer1") else 1
            out = F.relu(bn(F.conv2d(x, t[p + ".conv1.weight"]), p + ".bn1"))
            out = F.relu(bn(F.conv2d(out, t[p + ".conv2.weight"],
                                     stride=stride, padding=1), p + ".bn2"))
            out = bn(F.conv2d(out, t[p + ".conv3.weight"]), p + ".bn3")
            if p + ".downsample.0.weight" in t:
                x = bn(F.conv2d(x, t[p + ".downsample.0.weight"],
                                stride=stride), p + ".downsample.1")
            x = F.relu(out + x)
    return x


def torch_l2norm(f: torch.Tensor) -> torch.Tensor:
    return f / torch.sqrt(torch.sum(f * f, dim=1, keepdim=True) + 1e-6)


def torch_mutual(c: torch.Tensor) -> torch.Tensor:
    b, _, ha, wa, hb, wb = c.shape
    c3_b = c.view(b, ha * wa, hb, wb)
    c3_a = c.view(b, ha, wa, hb * wb)
    max_a, _ = torch.max(c3_b, dim=1, keepdim=True)        # over A for each B
    max_b, _ = torch.max(c3_a, dim=3, keepdim=True)        # over B for each A
    eps = 1e-5
    c_a = c3_a / (max_b + eps)
    c_b = c3_b / (max_a + eps)
    return c * (c_a.view_as(c) * c_b.view_as(c))


def torch_conv4d_loop(x: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """The reference's conv4d: a loop over hA, a conv3d per kA tap, "same"
    zero padding on every spatial dim."""
    bsz, cin, ha, wa, hb, wb = x.shape
    cout, _, ka, kwa, kb, kwb = w.shape
    pad = ka // 2
    xp = F.pad(x, (0, 0, 0, 0, 0, 0, pad, pad))  # hA only; conv3d pads the rest
    out = x.new_zeros((bsz, cout, ha, wa, hb, wb))
    for i in range(ha):
        acc = None
        for p in range(ka):
            o = F.conv3d(xp[:, :, i + p], w[:, :, p], bias=None,
                         padding=kwa // 2)
            acc = o if acc is None else acc + o
        out[:, :, i] = acc + bias.view(1, -1, 1, 1, 1)
    return out


def torch_nc_symmetric(x: torch.Tensor,
                       layers: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                       ) -> torch.Tensor:
    """Stack-level symmetry: ``conv(x) + conv(xᵀ)ᵀ``
    (``model.py:144-150``)."""
    def stack(v):
        for w, b in layers:
            v = F.relu(torch_conv4d_loop(v, w, b))
        return v

    xt = x.permute(0, 1, 4, 5, 2, 3)
    return stack(x) + stack(xt).permute(0, 1, 4, 5, 2, 3)


def torch_full_forward(sd: Dict[str, np.ndarray],
                       nc_layers: List[Tuple[torch.Tensor, torch.Tensor]],
                       src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """The whole forward on NCHW images: ``(B, 1, hA, wA, hB, wB)``."""
    fa = torch_l2norm(torch_resnet101_features(sd, src))
    fb = torch_l2norm(torch_resnet101_features(sd, tgt))
    b, c, ha, wa = fa.shape
    hb, wb = fb.shape[2:]
    corr = torch.bmm(
        fa.view(b, c, ha * wa).transpose(1, 2), fb.view(b, c, hb * wb)
    ).view(b, 1, ha, wa, hb, wb)
    corr = torch_mutual(corr)
    corr = torch_nc_symmetric(corr, nc_layers)
    return torch_mutual(corr)


def torch_maxpool4d(corr4d_hres: torch.Tensor, k_size: int):
    """``lib/model.py:177-191``: the pooled volume and the offsets."""
    slices = []
    for i in range(k_size):
        for j in range(k_size):
            for k in range(k_size):
                for m in range(k_size):
                    slices.append(
                        corr4d_hres[:, 0, i::k_size, j::k_size, k::k_size,
                                    m::k_size].unsqueeze(0))
    slices = torch.cat(tuple(slices), dim=1)
    corr4d, max_idx = torch.max(slices, dim=1, keepdim=True)
    max_l = torch.fmod(max_idx, k_size)
    max_k = torch.fmod((max_idx - max_l) // k_size, k_size)
    max_j = torch.fmod(((max_idx - max_l) // k_size - max_k) // k_size, k_size)
    max_i = (((max_idx - max_l) // k_size - max_k) // k_size - max_j) // k_size
    return corr4d, max_i, max_j, max_k, max_l


def torch_corr_to_matches(corr4d: torch.Tensor, delta4d=None, k_size: int = 1,
                          do_softmax: bool = False, scale: str = "positive",
                          invert_matching_direction: bool = False):
    """``lib/point_tnf.py:12-80`` on the CPU: ``(xA, yA, xB, yB, score)``."""
    batch_size, _, fs1, fs2, fs3, fs4 = corr4d.size()
    lo = -1 if scale == "centered" else 0
    XA, YA = np.meshgrid(np.linspace(lo, 1, fs2 * k_size),
                         np.linspace(lo, 1, fs1 * k_size))
    XB, YB = np.meshgrid(np.linspace(lo, 1, fs4 * k_size),
                         np.linspace(lo, 1, fs3 * k_size))
    JA, IA = np.meshgrid(range(fs2), range(fs1))
    JB, IB = np.meshgrid(range(fs4), range(fs3))
    XA, YA = torch.FloatTensor(XA), torch.FloatTensor(YA)
    XB, YB = torch.FloatTensor(XB), torch.FloatTensor(YB)
    JA, IA = torch.LongTensor(JA).view(1, -1), torch.LongTensor(IA).view(1, -1)
    JB, IB = torch.LongTensor(JB).view(1, -1), torch.LongTensor(IB).view(1, -1)

    if invert_matching_direction:
        nc_A_Bvec = corr4d.view(batch_size, fs1, fs2, fs3 * fs4)
        if do_softmax:
            nc_A_Bvec = F.softmax(nc_A_Bvec, dim=3)
        match_A_vals, idx_A_Bvec = torch.max(nc_A_Bvec, dim=3)
        score = match_A_vals.view(batch_size, -1)
        iB = IB.view(-1)[idx_A_Bvec.view(-1)].view(batch_size, -1)
        jB = JB.view(-1)[idx_A_Bvec.view(-1)].view(batch_size, -1)
        iA = IA.expand_as(iB)
        jA = JA.expand_as(jB)
    else:
        nc_B_Avec = corr4d.view(batch_size, fs1 * fs2, fs3, fs4)
        if do_softmax:
            nc_B_Avec = F.softmax(nc_B_Avec, dim=1)
        match_B_vals, idx_B_Avec = torch.max(nc_B_Avec, dim=1)
        score = match_B_vals.view(batch_size, -1)
        iA = IA.view(-1)[idx_B_Avec.view(-1)].view(batch_size, -1)
        jA = JA.view(-1)[idx_B_Avec.view(-1)].view(batch_size, -1)
        iB = IB.expand_as(iA)
        jB = JB.expand_as(jA)

    if delta4d is not None:  # relocalization, point_tnf.py:60-71
        idx = (iA.view(-1), jA.view(-1), iB.view(-1), jB.view(-1))
        diA, djA, diB, djB = (d.squeeze(0).squeeze(0)[idx] for d in delta4d)
        iA = iA * k_size + diA.expand_as(iA)
        jA = jA * k_size + djA.expand_as(jA)
        iB = iB * k_size + diB.expand_as(iB)
        jB = jB * k_size + djB.expand_as(jB)

    xA = XA[iA.view(-1), jA.view(-1)].view(batch_size, -1)
    yA = YA[iA.view(-1), jA.view(-1)].view(batch_size, -1)
    xB = XB[iB.view(-1), jB.view(-1)].view(batch_size, -1)
    yB = YB[iB.view(-1), jB.view(-1)].view(batch_size, -1)
    return xA, yA, xB, yB, score
