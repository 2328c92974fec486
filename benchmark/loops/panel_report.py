"""The panel report loop: a closed loop of panel report jobs, one client.

A job fits the configuration's panel (``panel.series`` locations, each its
own series and Box-Cox transformation) in one ``fit_panel`` call over
locations x particles rows, then forecasts every location with
``forecast_with_nowcasts`` over its revised points' scenarios (the
shared-Cholesky branch).  The jobs come from a fixed pool of the mix's
``pool`` panels: entry i is the panel drawn from (``pool_seed``, i) and
the fit seed drawn from the same, so every run does the same work.  The
run's seed orders the pool (job k takes the k-th entry of its
permutation, cycling) and draws each location's nowcast scenarios and
forecast draws.  The unit of the end-to-end metric is the job.

While the run traces, a sink that hands the program's spans to the run's
``Spans`` is the program's span sink from ``install`` to ``release`` (a
program without ``utils.profiling.set_sink`` runs without one), so the
program's own spans (``panel/*``, ``mcmc/device_*``, ...) land in the
run's records; the sink also keeps the program's counts.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import panel as ref_panel
from ..reference import scoring
from . import common, report

NC_TAG, DRAW_TAG = 1000, 2000  # seed tags of a location's nowcasts, draws


class _Sink:
    """The program's span sink: spans into the run's ``Spans``, counts by
    name."""

    def __init__(self, spans):
        self.spans = spans
        self.counts: dict[str, int] = {}

    def span(self, name: str):
        return self.spans.span(name)

    def count(self, name: str, n: int) -> None:
        self.counts[name] = self.counts.get(name, 0) + int(n)


class Loop(report.Loop):
    unit = "job"

    def __init__(self, cell: dict, seed: int, device, ngp, spans):
        super().__init__(cell, seed, device, ngp, spans)
        self.sink = None

    def _job(self, k: int, entry: int, draw_seed: int, fit_overrides=None):
        """Fit pool entry ``entry``'s panel; each location's nowcasts and
        draws from (``draw_seed``, k, location)."""
        ngp, cfg = self.ngp, self.cfg
        s, f = cfg["series"], cfg["forecast"]
        dates, obs = common.series(cfg, self.pool_seed, entry)
        n0, nr, h = s["n_train"], s["n_revised"], s["horizon"]
        datasets, transforms = [], []
        for y in obs:
            fwd, inv = ngp.get_transformations(s["transform"], y[:n0])
            datasets.append(ngp.create_transformed_data(
                dates[:n0], y[:n0], transformation=fwd))
            transforms.append((fwd, inv))
        kw = common.fit_kwargs(ngp, cfg, self.device)
        kw.update(fit_overrides or {})
        with self.spans.span("fit", sync=True):
            models = ngp.fit_panel(
                datasets, seed=common.seed_int(self.pool_seed, entry, 3),
                **kw)
        f_dates = dates[n0 + nr:n0 + nr + h]
        ncs, fcs = [], []
        with self.spans.span("forecast"):
            for j, (model, (fwd, inv)) in enumerate(zip(models, transforms)):
                nc = common.nowcast_values(cfg, obs[j], draw_seed, k,
                                           NC_TAG + j)
                fcs.append(ngp.forecast_with_nowcasts(
                    model, ngp.create_nowcast_data(
                        list(nc), dates[n0:n0 + nr], transformation=fwd),
                    f_dates, f["draws_per_scenario"],
                    inv_transformation=inv, ess_threshold=f["ess_threshold"],
                    draw_seed=common.seed_int(draw_seed, k, DRAW_TAG + j)))
                ncs.append(nc)
        return {"k": k, "entry": entry, "dates": dates, "obs": obs,
                "nc": np.stack(ncs), "models": models,
                "fc": np.concatenate(fcs)}

    def install(self) -> None:
        from nowcastautogp_tpu_torch.inference import device_smc
        from nowcastautogp_tpu_torch.utils import profiling

        self.spans.wrap(device_smc, "run_hmc", "hmc")
        set_sink = getattr(profiling, "set_sink", None)
        if self.spans.on and set_sink is not None:
            self.sink = _Sink(self.spans)
            set_sink(self.sink)

    def arm(self) -> None:
        """Keep what HMC takes and hands on in each job from now on."""
        from nowcastautogp_tpu_torch.inference import device_smc

        self.hmc = common.HmcRecorder(device_smc)

    def run(self, k: int) -> dict:
        before = dict(self.sink.counts) if self.sink else {}
        rec = super().run(k)
        if self.sink:
            rec["counts"] = {n: v - before.get(n, 0)
                             for n, v in self.sink.counts.items()}
        return rec

    def release(self, recs) -> None:
        """Clear the program's sink; keep each location's fitted state on
        the host, and all of them as one state; count the rows each job's
        HMC moved; free the device; restore ``run_hmc``."""
        if self.sink is not None:
            from nowcastautogp_tpu_torch.utils import profiling

            profiling.set_sink(None)
            self.sink = None
        self.hmc.restore()
        for r in recs:
            r["states"] = [m.to_dict() for m in r.pop("models")]
            r["state"] = {key: np.concatenate([st[key]
                                               for st in r["states"]])
                          for key in ("node_types", "lml")}
            r["hmc_moved"] = sum(map(common.moved_rows, r.pop("hmc")))

    def hmc_rows(self) -> int:
        """The rows a job's HMC calls take, by the algorithm: one call of
        all locations' particles after each structure move of each step."""
        s, f = self.cfg["series"], self.cfg["fit"]
        steps = ref_panel.grid(s["n_train"], f["smc_data_proportion"])
        return (len(steps) * f["n_mcmc"] * f["n_particles"]
                * self.cfg["panel"]["series"] * (f["n_hmc"] > 0))

    def calls(self):
        """[(capacity, value calls, gradient calls), ...] of a panel fit
        by the device engine, by capacity segment of the shared grid: per
        step one reweight value, and one gradient to seed the sweep, then
        per move one for the proposal and one a leapfrog of each HMC
        trajectory, every call over all rows."""
        s, f = self.cfg["series"], self.cfg["fit"]
        grads = 1 + f["n_mcmc"] * (1 + f["n_hmc"] * f["n_leapfrog"])
        return [(cap, len(steps), len(steps) * grads)
                for cap, steps in ref_panel.segments(
                    s["n_train"], f["smc_data_proportion"],
                    [s["n_train"]])]

    def work(self, rec: dict) -> dict:
        from .. import costs

        return costs.work(rec["state"]["node_types"], self.calls())

    def shape(self):
        f, s = self.cfg["forecast"], self.cfg["series"]
        return (self.cfg["panel"]["series"] * s["horizon"],
                f["scenarios"] * f["draws_per_scenario"])

    def check(self, recs, device) -> tuple[dict, int]:
        """The report loop's numbers over every location of every job: the
        widest LML gap over all fitted particles in units of their float32
        sensitivity, the PIT distance of all draws, the least share of a
        job's HMC rows that HMC moved; a job fails where its draws are
        malformed or any location's log-CRPS passes the collapse bound.
        Beside them: the gap in nats, the worst location's log-CRPS and
        the series resampled a job where the program counted them."""
        h = self.cfg["series"]["horizon"]
        gaps, errs, pits, worst, failed = [], [], [], 0.0, 0
        for r in recs:
            j = self.judge(r, device)
            gaps.append(common.lml_gap(r["state"]["lml"], j["ref_lml"]))
            errs.append(common.lml_gap(r["state"]["lml"], j["ref_lml"],
                                       j["ref_sens"]))
            pits.append(common.pit(j, j["z"]))
            crps = [scoring.log_crps(r["fc"][i:i + h], j["truth"][i:i + h])
                    for i in range(0, len(j["truth"]), h)]
            worst = max(worst, max(crps))
            if (common.malformed(r["fc"], self.shape())
                    or max(crps) > self.limits["collapse_log_crps"]):
                failed += 1
        moved = min(r["hmc_moved"] for r in recs) / max(self.hmc_rows(), 1)
        beside = {"lml_gap_nats": max(gaps), "worst_log_crps": worst}
        counted = [r["counts"]["panel/resampled_series"] for r in recs
                   if "panel/resampled_series" in r.get("counts", {})]
        if counted:
            beside["resampled_series_a_job"] = float(np.mean(counted))
        return ({"lml_err": max(errs),
                 "pit_ks": scoring.ks_uniform(np.concatenate(pits)),
                 "hmc_moved": moved},
                failed, beside)

    def judge(self, rec, device, k_round=None) -> dict:
        """The report loop's view of each location in turn (its own data,
        transformation and normalisation, its fitted particles, its
        scenarios), the locations' rows and scenarios stacked in order."""
        h = self.cfg["series"]["horizon"]
        parts = [super(Loop, self).judge(
            {"dates": rec["dates"], "obs": rec["obs"][j], "state": st,
             "nc": rec["nc"][j], "fc": rec["fc"][j * h:(j + 1) * h]},
            device, k_round) for j, st in enumerate(rec["states"])]
        out = {}
        for key in parts[0]:
            vals = [p[key] for p in parts]
            out[key] = (torch.cat(vals) if torch.is_tensor(vals[0])
                        else np.concatenate(vals))
        return out
