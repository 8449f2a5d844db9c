"""The VOD route for a head that reads each fighter's whole sequence: the
program's path is ``routes/vod.py``'s, unchanged (``VodAnalyzer.analyze``
on the native route, the checks, the limits); only the reference differs.

The window route's reference gathers each row's T-row window and calls the
family's ``head``.  Here each fighter's rows go in frame order, as one
sequence, to the family's ``sequence_head(seq, sd, config)`` (``[B, L,
D]`` -> ``[B, L, A]``), which labels row t from rows 0 to t.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import models as ref_models
from portbench.routes import vod


class Route(vod.Route):
    def reference_log_probs(self, mode="float32"):
        """A function ``vod -> [2, rows, A]``: the reference's float32
        log-probs of a VOD's rows under ``mode``, its two fighters' embedded
        rows (each scene's crops embedded once) run as two sequences."""
        c = self.config
        if self.weights is None:
            self.weights = self.family.weights(c, self.seed, self.device, self.root)
        with torch.no_grad(), ref_models.precision(mode):
            emb = self._scene_embeddings()  # [Q, 2, D]

        def log_probs(vod):
            scenes = self.schedule.scenes(vod, np.arange(self.rows) * self.stride)
            seq = emb[torch.as_tensor(scenes, device=self.device)].transpose(0, 1)  # [2, rows, D]
            with torch.no_grad(), ref_models.precision(mode):
                out = self.family.sequence_head(seq.contiguous(), self.weights["head"], c)
            return out.cpu().numpy()

        return log_probs
