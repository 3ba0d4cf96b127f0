"""What the two sensing drivers share: the sense function and weights from
the configuration, and the comparison of its outputs with the reference."""

from __future__ import annotations

import numpy as np
import torch

from crn_bench.reference.sense import decision_reference, sense_reference


def sense_function(config: dict, device: str):
    """``make_sense_fn`` of the configuration's sensing, and its MLP on ``device``."""
    from cognitive_radio_network_tpu_torch.models.sense import SenseConfig, make_sense_fn
    from cognitive_radio_network_tpu_torch.signal.bands import SensingBands
    from cognitive_radio_network_tpu_torch.signal.mlp import params_from_numpy

    s = config["sense"]
    bands = SensingBands(s["fft_length"], *(tuple(tuple(r) for r in s["bands"][k])
                                            for k in ("noise_floor", "ch1", "ch2", "ch3")))
    cfg = SenseConfig(fft_length=s["fft_length"], averaging=s["averaging"], threshold=s["threshold"],
                      bands=bands, channels_hz=tuple(s["channels_hz"]),
                      sample_rate_hz=s["sample_rate_hz"], center_hz=s["center_hz"],
                      sensing_delay_ms=s["sensing_delay_ms"])
    mlp = config["mlp"]
    params = params_from_numpy(*(np.asarray(mlp[k]) for k in ("w1", "b1", "w2", "b2")), device=device)
    return make_sense_fn(cfg, device=device), params


class SenseChecks:
    """Running maxima of the gaps between the program's outputs and the reference's."""

    def __init__(self, config: dict, limits: dict):
        self.sense, self.mlp, self.limits = config["sense"], config["mlp"], limits
        self.gaps = {"spectrum_gap": 0.0, "feature_gap": 0.0}
        self.output_gap = 0.0  # reported, not compared (see the traffic file's limits)
        self.decision_mismatch = 0

    def reference(self, xr: torch.Tensor, xi: torch.Tensor) -> dict:
        return sense_reference(xr, xi, self.sense, self.mlp)

    def decisions(self, dec, out, ref: dict, rows) -> int:
        """Count and record decisions that differ from the reference's where
        no reference output lies within the margin of the threshold, or (with
        the program's outputs ``out``) from the threshold applied to them."""
        thr = self.sense["threshold"]
        dec = torch.as_tensor(np.asarray(dec)).to(torch.int32)
        ro = ref["outputs"][rows].cpu()
        clear = ((ro - thr).abs() > self.limits["decision_margin"]).all(-1)
        wrong = (dec != ref["decision"][rows].cpu()) & clear
        if out is not None:
            out = torch.as_tensor(np.asarray(out))
            wrong |= dec != decision_reference(out.float(), np.float32(thr))
            self.output_gap = max(self.output_gap, float((out.double() - ro).abs().max()))
        n = int(wrong.sum())
        self.decision_mismatch += n
        return n

    def full(self, res: dict, ref: dict, rows) -> None:
        """Spectrum, features, outputs and decisions of one dispatch."""
        avg, feats = ref["avg_spectrum"][rows], ref["features"][rows]
        gap = (res["avg_spectrum"].double() - avg).abs() / avg.mean(-1, keepdim=True)
        self.gaps["spectrum_gap"] = max(self.gaps["spectrum_gap"], float(gap.max()))
        fgap = ((res["features"].double() - feats).abs() / feats).max()
        self.gaps["feature_gap"] = max(self.gaps["feature_gap"], float(fgap))
        self.decisions(res["decision"].cpu().numpy(), res["outputs"].cpu().numpy(), ref, rows)

    def result(self, extra: dict | None = None) -> dict[str, tuple[float, float]]:
        out = {k: (v, self.limits[k]) for k, v in self.gaps.items()}
        out["decision_mismatch"] = (float(self.decision_mismatch), 0.0)
        for k, v in (extra or {}).items():
            out[k] = (float(v), 0.0)
        return out
