"""High-level inference API mirroring the reference engine's methods (port
of phiseg_tpu/engine/inference.py:32-123).

One class wrapping a trained (cfg, model) with the method surface of the
reference `phiseg` class (phiseg/phiseg_model.py):

  predict                       (:337-353)  argmax of the mean softmax over N draws
  predict_segmentation_sample   (:356-364)  one prior draw
  predict_segmentation_sample_levels (:367-375) per-level logits of one draw
  sample_variance_map           (:378-430)  pixelwise variance of the softmax draws
  crossentropy_error_map        (:433-446)  mean xent map vs a GT
  mean_variance_and_error_maps  (:449-475)
  generate_prior_samples        (:325-334)  z draws (+ params)
  generate_posterior_samples    (:484-495)
  generate_samples_from_z       (:313-322)

Every method batches over images and runs in eval batch-norm mode without
autograd. Where the JAX methods take a key, these take a torch.Generator, or
the noise itself (`eps`, per latent level, as engine.train.make_sample_fn
and the SegVAE methods take it). Inputs may be numpy arrays or tensors; they
go to the model's device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from phiseg_tpu_torch.engine.train import _eval_mode, make_sample_fn, make_sample_levels_fn
from phiseg_tpu_torch.models.segvae import aggregate_levels
from phiseg_tpu_torch.nn.losses import one_hot

Eps = Optional[Sequence[torch.Tensor]]


class InferenceEngine:
    def __init__(self, cfg, model):
        self.cfg = cfg
        self.model = model
        self.device = next(model.parameters()).device
        self._samplers = {}

    @classmethod
    def from_logdir(cls, log_dir: str, tag: str = "latest", device="cuda"):
        """The engine of a trained log dir's `tag` checkpoint, on the card
        unless asked for the CPU."""
        from phiseg_tpu_torch.engine.loading import load_experiment

        cfg, model, _, _ = load_experiment(log_dir, tag, device)
        return cls(cfg, model)

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    def _sampler(self, n: int, levels: bool = False):
        key = (n, levels)
        if key not in self._samplers:
            fn = make_sample_levels_fn if levels else make_sample_fn
            self._samplers[key] = fn(self.model, n)
        return self._samplers[key]

    # -- prediction ----------------------------------------------------------

    def sample_probs(self, x, num_samples: int, generator=None, eps: Eps = None) -> torch.Tensor:
        """(S,B,H,W,C) softmax probabilities of prior draws."""
        return self._sampler(num_samples)(self._t(x, torch.float32), generator, eps)

    def predict(self, x, generator=None, num_samples: int = 50, return_softmax: bool = False,
                eps: Eps = None):
        """argmax of the mean softmax over draws (ref :337-353)."""
        mean = self.sample_probs(x, num_samples, generator, eps).mean(0)
        pred = mean.argmax(-1)
        return (pred, mean) if return_softmax else pred

    def predict_segmentation_sample(self, x, generator=None, return_softmax: bool = False,
                                    eps: Eps = None):
        probs = self.sample_probs(x, 1, generator, eps)[0]
        return probs if return_softmax else probs.argmax(-1)

    def predict_segmentation_sample_levels(self, x, generator=None, eps: Eps = None):
        """Per-level logits of one prior draw (ref :367-375)."""
        levels = self._sampler(1, levels=True)(self._t(x, torch.float32), generator, eps)
        return tuple(lv[0] for lv in levels)

    # -- uncertainty maps -----------------------------------------------------

    def sample_variance_map(self, x, generator=None, num_samples: int = 50,
                            eps: Eps = None) -> torch.Tensor:
        """Pixelwise sum over classes of the draws' softmax variance (ddof 0).

        The reference sums the EIGENVALUES of the per-pixel class covariance
        (:395-403), i.e. its trace, the sum of per-class variances; summed
        over all classes here rather than classes[:-1] (a factor of 2 for
        binary segmentation)."""
        probs = self.sample_probs(x, num_samples, generator, eps)
        return probs.var(0, correction=0).sum(-1)  # (B,H,W)

    def _xent_map(self, probs: torch.Tensor, s_gt) -> torch.Tensor:
        gt_oh = one_hot(self._t(s_gt), self.cfg.nlabels)
        return -(gt_oh[None] * torch.log(probs + 1e-8)).sum(-1).mean(0)  # (B,H,W)

    def crossentropy_error_map(self, x, s_gt, generator=None, num_samples: int = 100,
                               eps: Eps = None) -> torch.Tensor:
        """Mean pixel xent of the draws vs a GT mask (ref :433-446)."""
        return self._xent_map(self.sample_probs(x, num_samples, generator, eps), s_gt)

    def mean_variance_and_error_maps(self, x, s_gt, generator=None, num_samples: int = 100,
                                     eps: Eps = None):
        """(means, vars, errs) (ref :449-475); vars is the class mean of the
        draws' std (ddof 0)."""
        probs = self.sample_probs(x, num_samples, generator, eps)
        means = probs.mean(0).argmax(-1)
        vars_ = probs.std(0, correction=0).mean(-1)
        return means, vars_, self._xent_map(probs, s_gt)

    # -- latent access ---------------------------------------------------------

    def generate_prior_samples(self, x, generator=None, return_params: bool = False,
                               eps: Eps = None):
        with torch.no_grad(), _eval_mode(self.model):
            z, mu, sigma = self.model.prior_draw(self._t(x, torch.float32), eps, generator)
        return (z, mu, sigma) if return_params else z

    def generate_posterior_samples(self, x, s, generator=None, return_params: bool = False,
                                   eps: Eps = None):
        s_oh = one_hot(self._t(s), self.cfg.nlabels)
        with torch.no_grad(), _eval_mode(self.model):
            z, mu, sigma = self.model.posterior_draw(self._t(x, torch.float32), s_oh, eps,
                                                     generator)
        return (z, mu, sigma) if return_params else z

    def generate_samples_from_z(self, z, x, output_all_levels: bool = False):
        """Decode given latents with their images x (ref :313-322); the
        U-Net likelihoods read x, the PHiSeg one does not."""
        with torch.no_grad(), _eval_mode(self.model):
            levels = self.model.decode_z([self._t(t) for t in z], self._t(x, torch.float32))
        return levels if output_all_levels else aggregate_levels(levels)
