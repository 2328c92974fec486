"""The report loop: a closed loop of report jobs, one client.

The jobs come from a fixed pool of the mix's ``pool`` entries: entry i is
the series drawn from (``pool_seed``, i) and the fit seed drawn from the
same, so every run fits the same series to the same trees and does the
same work.  The run's seed orders the pool (job k takes the k-th entry of
its permutation, cycling) and draws each job's nowcast scenarios and
forecast draws.  Job k fits the configuration's ensemble to its entry's
training window and forecasts: on a ``nowcast`` configuration
``forecast_with_nowcasts`` over the revised points' scenarios (the
shared-Cholesky branch: no refresh), on a ``plain`` one ``forecast``.
The unit of the end-to-end metric is the job.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..reference import gp, scoring
from . import common


class Loop:
    unit = "job"

    def __init__(self, cell: dict, seed: int, device, ngp, spans):
        self.cfg = cell["config"]
        self.limits = cell["limits"]
        self.seed = seed
        self.device = device
        self.ngp = ngp
        self.spans = spans
        t = cell["traffic"]
        self.pool_seed = t["pool_seed"]
        rng = np.random.default_rng(common.seed_seq(seed, 8))
        self.order = rng.permutation(t["pool"]).tolist()
        self.hmc = None

    def _job(self, k: int, entry: int, draw_seed: int, fit_overrides=None):
        """Fit pool entry ``entry``; nowcasts and draws from
        (``draw_seed``, k)."""
        ngp, cfg = self.ngp, self.cfg
        s, f = cfg["series"], cfg["forecast"]
        dates, obs = common.series(cfg, self.pool_seed, entry)
        n0, nr, h = s["n_train"], s["n_revised"], s["horizon"]
        train = obs[:n0]
        fwd, inv = ngp.get_transformations(s["transform"], train)
        data = ngp.create_transformed_data(dates[:n0], train,
                                           transformation=fwd)
        kw = common.fit_kwargs(ngp, cfg, self.device)
        kw.update(fit_overrides or {})
        with self.spans.span("fit", sync=True):
            model = ngp.make_and_fit_model(
                data, seed=common.seed_int(self.pool_seed, entry, 3), **kw)
        f_dates = dates[n0 + nr:n0 + nr + h]
        nc = None
        with self.spans.span("forecast"):
            if f["kind"] == "nowcast":
                nc = common.nowcast_values(cfg, obs, draw_seed, k, 2)
                ncs = ngp.create_nowcast_data(list(nc), dates[n0:n0 + nr],
                                              transformation=fwd)
                fc = ngp.forecast_with_nowcasts(
                    model, ncs, f_dates, f["draws_per_scenario"],
                    inv_transformation=inv,
                    ess_threshold=f["ess_threshold"],
                    draw_seed=common.seed_int(draw_seed, k, 5))
            else:
                # the model's documented draw stream, from the job's seed
                model.rng = np.random.default_rng(
                    common.seed_seq(draw_seed, k, 6))
                fc = ngp.forecast(model, f_dates, f["draws"],
                                  inv_transformation=inv)
        return {"k": k, "entry": entry, "dates": dates, "obs": obs,
                "nc": nc, "model": model, "fc": fc}

    def install(self) -> None:
        from nowcastautogp_tpu_torch.inference import structure_mcmc
        from nowcastautogp_tpu_torch.models import gp_model

        self.spans.wrap(structure_mcmc, "run_hmc", "hmc")
        self.spans.wrap(structure_mcmc, "propose_batch", "propose")
        self.spans.wrap(gp_model, "run_hmc", "hmc")
        self.spans.wrap(gp_model.GPModel, "reweight_to", "reweight")

    def setup(self) -> None:
        """Warm the cell's shapes: one SMC pass with one move over its
        capacities, then one forecast at its sizes, on the pool's own
        warm-up entry (-1), the same in every run."""
        self._job(-1, -1, self.pool_seed, {"n_mcmc": 1, "n_hmc": 1})
        self.arm()

    def arm(self) -> None:
        """Keep what HMC takes and hands on in each job from now on."""
        from nowcastautogp_tpu_torch.inference import structure_mcmc

        self.hmc = common.HmcRecorder(structure_mcmc)

    def run(self, k: int) -> dict:
        t0 = time.time_ns()
        self.hmc.kept = []
        rec = self._job(k, self.order[k % len(self.order)], self.seed)
        rec["t"] = (t0, time.time_ns())
        rec["hmc"], self.hmc.kept = self.hmc.kept, None
        return rec

    def release(self, recs) -> None:
        """Keep the fitted states on the host and count the rows each
        job's HMC moved; free the device; restore ``run_hmc``."""
        self.hmc.restore()
        for r in recs:
            r["state"] = r.pop("model").to_dict()
            r["hmc_moved"] = sum(map(common.moved_rows, r.pop("hmc")))

    def hmc_rows(self) -> int:
        """The rows a job's HMC calls take, by the algorithm: one call of
        all particles after each structure move of each SMC step."""
        from ..reference import data

        f = self.cfg["fit"]
        steps = len(data.linear_schedule(self.cfg["series"]["n_train"],
                                         f["smc_data_proportion"]))
        return steps * f["n_mcmc"] * f["n_particles"] * (f["n_hmc"] > 0)

    def work(self, rec: dict) -> dict:
        from .. import costs

        f = self.cfg["fit"]
        calls = costs.fit_calls(self.cfg["series"]["n_train"],
                                f["smc_data_proportion"], f["n_mcmc"],
                                f["n_hmc"], f["n_leapfrog"])
        return costs.work(rec["state"]["node_types"], calls)

    def shape(self):
        f, s = self.cfg["forecast"], self.cfg["series"]
        n = (f["scenarios"] * f["draws_per_scenario"]
             if f["kind"] == "nowcast" else f["draws"])
        return s["horizon"], n

    def check(self, recs, device) -> tuple[dict, int]:
        """The compared numbers: the widest LML gap over every job's
        particles in units of their float32 sensitivity, the PIT distance
        of every job's draws, the least share of a job's HMC rows that HMC
        moved; the jobs that failed; and the widest gap in nats, reported
        beside them."""
        gaps, errs, pits, failed = [], [], [], 0
        for r in recs:
            j = self.judge(r, device)
            gaps.append(common.lml_gap(r["state"]["lml"], j["ref_lml"]))
            errs.append(common.lml_gap(r["state"]["lml"], j["ref_lml"],
                                       j["ref_sens"]))
            pits.append(common.pit(j, j["z"]))
            if (common.malformed(r["fc"], self.shape())
                    or scoring.log_crps(r["fc"], j["truth"])
                    > self.limits["collapse_log_crps"]):
                failed += 1
        moved = min(r["hmc_moved"] for r in recs) / max(self.hmc_rows(), 1)
        return ({"lml_err": max(errs),
                 "pit_ks": scoring.ks_uniform(np.concatenate(pits)),
                 "hmc_moved": moved},
                failed, {"lml_gap_nats": max(gaps)})

    def judge(self, rec, device, k_round=None) -> dict:
        """The reference's view of one job: its LMLs of the fitted
        particles on the training data, the draws' mixture (per scenario
        log-weights, means and variances over the particles) and the
        draws on its scale.
        ``k_round`` adds the control's LMLs at that precision."""
        ref = common.RefView(self.cfg, rec["dates"], rec["obs"], device)
        st = rec["state"]
        types, params, log_noise = common.state_tensors(st, device)
        fit = gp.solve(types, params, log_noise, ref.x_train,
                       ref.y_train[:, None], sens=True)
        old = fit["lml"][:, 0]
        base_lw = torch.as_tensor(st["log_weight"], device=device)
        if rec["nc"] is not None:
            out = gp.solve(types, params, log_noise, ref.x_new,
                           ref.y_new(rec["nc"]), ref.xs)
            new = out["lml"]                                  # (P, S)
            bad = ~torch.isfinite(new) | ~torch.isfinite(old)[:, None]
            log_w = torch.where(bad, -1e10,
                                base_lw[:, None] + new - old[:, None]).T
        else:
            out = gp.solve(types, params, log_noise, ref.x_train,
                           ref.y_train[:, None], ref.xs)
            log_w = base_lw[None]
        S = log_w.shape[0]
        mu = out["mu"].permute(1, 0, 2)                       # (S, P, m)
        j = {"ref_lml": old.cpu().numpy(),
             "ref_sens": fit["sens"].cpu().numpy(), "log_w": log_w, "mu": mu,
             "var": out["var"][None].expand_as(mu),
             "z": ref.z(rec["fc"]).reshape(ref.h, S, -1).permute(1, 2, 0),
             "truth": ref.truth}
        if k_round is not None:
            j["control_lml"] = common.guarded(gp.solve(
                types, params, log_noise, ref.x_train, ref.y_train[:, None],
                k_round=k_round)["lml"][:, 0].cpu().numpy())
        return j
