"""Domain-specific BatchNorm (port of ust_run_tpu/models/dsbn.py;
reference networks/dsbn.py:4-34).

Upstream keeps one BatchNorm2d per domain and routes the whole batch
through `bns[domain_label[0]]`. The port keeps that layout
(`bns.{d}.weight`, `.bias`, `.running_mean`, `.running_var`,
`.num_batches_tracked`) but, like the JAX package, selects the domain with
a gather on the stacked tensors and folds the running statistics through
a one-hot blend, so the domain index never leaves the device.
"""

import torch
from torch import nn


class DomainSpecificBatchNorm2d(nn.Module):
    def __init__(self, num_features, num_domains, momentum=0.1, eps=1e-5):
        super().__init__()
        self.num_domains = num_domains
        self.momentum = momentum
        self.eps = eps
        self.bns = nn.ModuleList(nn.BatchNorm2d(num_features, eps, momentum)
                                 for _ in range(num_domains))

    def _stacked(self, name):
        return torch.stack([getattr(bn, name) for bn in self.bns])

    def forward(self, x, domain_label):
        """x: NCHW; domain_label: an integer tensor whose first element
        selects the domain (dsbn.py:26)."""
        idx = torch.as_tensor(domain_label, device=x.device) \
            .reshape(-1)[:1].to(torch.int64)
        w = self._stacked("weight").index_select(0, idx)[0]
        b = self._stacked("bias").index_select(0, idx)[0]
        xf = x.float()
        if not self.training:
            mean = self._stacked("running_mean").index_select(0, idx)[0]
            var = self._stacked("running_var").index_select(0, idx)[0]
            inv = torch.rsqrt(var + self.eps) * w
            y = (xf - mean[:, None, None]) * inv[:, None, None] \
                + b[:, None, None]
            return y.to(x.dtype)

        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp(torch.square(xf).mean(dim=(0, 2, 3))
                          - torch.square(mean), min=0.0)
        inv = torch.rsqrt(var + self.eps) * w
        y = (xf - mean[:, None, None]) * inv[:, None, None] + b[:, None, None]
        with torch.no_grad():
            n = x.shape[0] * x.shape[2] * x.shape[3]
            unbiased = var * (n / max(n - 1, 1))
            onehot = (torch.arange(self.num_domains, device=x.device)
                      == idx).to(torch.float32)[:, None]          # (d, 1)
            m = self.momentum
            for name, stat in (("running_mean", mean),
                               ("running_var", unbiased)):
                new = self._stacked(name) * (1 - m * onehot) \
                    + m * onehot * stat[None, :]
                for d, bn in enumerate(self.bns):
                    getattr(bn, name).copy_(new[d])
            for d, bn in enumerate(self.bns):
                bn.num_batches_tracked.add_(onehot[d, 0].to(torch.long))
        return y.to(x.dtype)
