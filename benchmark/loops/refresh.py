"""The refresh loop: a closed loop of nowcast-refresh requests, one
client, on the ensemble fitted at set-up.

Set-up fits the configuration's ensemble to the series of the mix's
``model_seed``, the same model in every run: the time of a request
follows the fitted trees, so a model drawn from the run's seed would
change the work from seed to seed.  Request r draws fresh nowcast
scenarios from (seed, r) and calls
``forecast_with_nowcasts`` with the mix's ``n_hmc`` (the batched branch:
the ensemble tiled to scenarios x particles rows, reweighted, resampled
per scenario below the ESS threshold, refreshed by HMC, then sampled).
The unit of the end-to-end metric is the request.

The request returns only its draws, so the benchmark keeps what the
refresh handed to HMC and what HMC handed on (``run_hmc``'s rows where
``nowcast`` binds it: their trees, the state in, the state and LMLs out)
to judge the rows' LMLs, the share of rows HMC moved and the draws'
mixture.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..reference import gp, scoring
from . import common

WARMUP = 1 << 40  # the request index of the set-up's warm-up request


class Loop:
    unit = "request"

    def __init__(self, cell: dict, seed: int, device, ngp, spans):
        self.cfg = cell["config"]
        self.traffic = cell["traffic"]
        self.limits = cell["limits"]
        self.seed = seed
        self.device = device
        self.ngp = ngp
        self.spans = spans
        self.hmc = None

    def install(self) -> None:
        from nowcastautogp_tpu_torch import nowcast

        self.spans.wrap(nowcast, "run_hmc", "hmc")

    def setup(self) -> None:
        """Fit the ensemble the requests refresh (set-up the traffic
        needs), then warm one request at the cell's sizes."""
        from nowcastautogp_tpu_torch import nowcast

        ngp, cfg, s = self.ngp, self.cfg, self.cfg["series"]
        model_seed = self.traffic["model_seed"]
        self.dates, self.obs = common.series(cfg, model_seed, 0)
        n0, nr, h = s["n_train"], s["n_revised"], s["horizon"]
        train = self.obs[:n0]
        self.fwd, self.inv = ngp.get_transformations(
            cfg["series"]["transform"], train)
        data = ngp.create_transformed_data(self.dates[:n0], train,
                                           transformation=self.fwd)
        self.model = ngp.make_and_fit_model(
            data, seed=common.seed_int(model_seed, 0, 3),
            **common.fit_kwargs(ngp, cfg, self.device))
        self.nc_dates = self.dates[n0:n0 + nr]
        self.f_dates = self.dates[n0 + nr:n0 + nr + h]
        self.hmc = common.HmcRecorder(nowcast)
        self._request(WARMUP)

    def _request(self, r: int):
        ngp, f = self.ngp, self.cfg["forecast"]
        nc = common.nowcast_values(self.cfg, self.obs, self.seed, r, 4)
        ncs = ngp.create_nowcast_data(list(nc), self.nc_dates,
                                      transformation=self.fwd)
        with self.spans.span("request"):
            fc = ngp.forecast_with_nowcasts(
                self.model, ncs, self.f_dates, f["draws_per_scenario"],
                inv_transformation=self.inv, n_hmc=self.traffic["n_hmc"],
                ess_threshold=f["ess_threshold"],
                draw_seed=common.seed_int(self.seed, r, 5))
        return nc, fc

    def run(self, r: int) -> dict:
        t0 = time.time_ns()
        self.hmc.kept = []
        nc, fc = self._request(r)
        rec = {"k": r, "nc": nc, "fc": fc, "kept": self.hmc.kept,
               "t": (t0, time.time_ns())}
        self.hmc.kept = None
        return rec

    def release(self, recs) -> None:
        """Keep the base state and the sampled requests' rows on the host;
        free the device; restore ``nowcast.run_hmc``."""
        self.hmc.restore()
        self.state = self.model.to_dict()
        del self.model
        rng = np.random.default_rng(common.seed_seq(self.seed, 7))
        n = min(self.traffic["checked_units"], len(recs))
        self.sample = sorted(rng.choice(len(recs), n, replace=False).tolist())
        for i, r in enumerate(recs):
            if i in self.sample:
                self.take(r)
            else:
                del r["kept"]

    @staticmethod
    def take(rec: dict) -> None:
        """Move what a request's HMC took and handed on to the host, and
        count the rows it moved."""
        kept = rec.pop("kept")
        if len(kept) != 1:
            raise RuntimeError(
                f"a request ran HMC {len(kept)} times, expected once")
        rec["hmc_moved"] = common.moved_rows(kept[0])
        rec["rows"] = {k: v.detach().cpu() for k, v in kept[0].items()}

    def work(self, rec: dict) -> dict:
        from .. import costs

        s, f = self.cfg["series"], self.cfg["fit"]
        st = self.state if hasattr(self, "state") else self.model.to_dict()
        types = np.tile(st["node_types"], (self.cfg["forecast"]["scenarios"],
                                           1))
        calls = costs.refresh_calls(s["n_train"] + s["n_revised"],
                                    self.traffic["n_hmc"], f["n_leapfrog"],
                                    common.ref_data.capacity(s["n_train"]))
        return costs.work(types, calls)

    def shape(self):
        f = self.cfg["forecast"]
        return self.cfg["series"]["horizon"], (f["scenarios"]
                                               * f["draws_per_scenario"])

    def check(self, recs, device) -> tuple[dict, int]:
        """As the report loop's, over the sampled requests' refreshed
        rows and their draws; ``hmc_moved`` is the least share of a
        sampled request's scenarios x particles rows that HMC moved."""
        truth = common.RefView(self.cfg, self.dates, self.obs, "cpu").truth
        failed = sum(
            common.malformed(r["fc"], self.shape())
            or scoring.log_crps(r["fc"], truth)
            > self.limits["collapse_log_crps"] for r in recs)
        gaps, errs, pits = [], [], []
        for i in self.sample:
            j = self.judge(recs[i], device)
            prog = recs[i]["rows"]["lml"].numpy()
            gaps.append(common.lml_gap(prog, j["ref_lml"]))
            errs.append(common.lml_gap(prog, j["ref_lml"], j["ref_sens"]))
            pits.append(common.pit(j, j["z"]))
        rows = self.cfg["forecast"]["scenarios"] * self.state[
            "node_types"].shape[0]
        moved = min(recs[i]["hmc_moved"] for i in self.sample) / rows
        return ({"lml_err": max(errs),
                 "pit_ks": scoring.ks_uniform(np.concatenate(pits)),
                 "hmc_moved": moved},
                failed, {"lml_gap_nats": max(gaps)})

    def judge(self, rec, device, k_round=None) -> dict:
        """The reference's view of one request: its LMLs of the refreshed
        rows on their scenarios' data, and the draws' mixture.  Each
        scenario's weights are its own float64 reweight of the base
        ensemble where the rows handed to HMC are the base particles in
        order, and uniform where the program resampled them."""
        ref = common.RefView(self.cfg, self.dates, self.obs, device)
        st = self.state
        types0, params0, ln0 = common.state_tensors(st, device)
        S = rec["nc"].shape[0]
        P = types0.shape[0]
        y_new = ref.y_new(rec["nc"])                          # (n_new, S)
        old = gp.solve(types0, params0, ln0, ref.x_train,
                       ref.y_train[:, None])["lml"][:, 0]
        new = gp.solve(types0, params0, ln0, ref.x_new, y_new)["lml"]
        bad = ~torch.isfinite(new) | ~torch.isfinite(old)[:, None]
        base_lw = torch.as_tensor(st["log_weight"], device=device)
        log_w = torch.where(bad, -1e10,
                            base_lw[:, None] + new - old[:, None]).T

        rows = rec["rows"]
        types_in, params_in = rows["types"], rows["params_in"]
        p_out, ln_out = rows["params"], rows["noise"]
        same = ((params_in.reshape(S, P, -1)
                 == torch.as_tensor(st["params"]).reshape(1, P, -1))
                .all(-1).all(-1)
                & (types_in.reshape(S, P, -1).long()
                   == torch.as_tensor(st["node_types"]).long()[None])
                .all(-1).all(-1))
        log_w = torch.where(same.to(device)[:, None], log_w, 0.0)

        t = types_in.to(device=device, dtype=torch.int64)
        p = p_out.to(device=device, dtype=torch.float64)
        ln = ln_out.to(device=device, dtype=torch.float64)
        y_rows = y_new.T.repeat_interleave(P, 0)[:, :, None]  # (R, n_new, 1)
        out = gp.solve(t, p, ln, ref.x_new, y_rows, ref.xs, sens=True)
        m = ref.h
        j = {"ref_lml": out["lml"][:, 0].cpu().numpy(),
             "ref_sens": out["sens"].cpu().numpy(), "log_w": log_w,
             "mu": out["mu"][:, 0].reshape(S, P, m),
             "var": out["var"].reshape(S, P, m),
             "z": ref.z(rec["fc"]).reshape(m, S, -1).permute(1, 2, 0),
             "truth": ref.truth}
        if k_round is not None:
            j["control_lml"] = common.guarded(gp.solve(
                t, p, ln, ref.x_new, y_rows, k_round=k_round
            )["lml"][:, 0].cpu().numpy())
        return j
