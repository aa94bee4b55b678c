"""CLI for the Gibbs warm-start sampler: `python -m vampomi_tpu.gibbs`.

Produces <out>.csv / <out>.bet / <out>.grm, directly consumable by
  python -m vampomi_tpu.scripts.conf_gibbs_init -csv <out>.csv -grm <out>.grm
  python -m vampomi_tpu.scripts.pip -bet <out>.bet -iterations a:b
completing the reference's documented warm-start workflow
(reference README.md:170-213) inside the framework.
"""

from __future__ import annotations

import argparse

import jax.numpy as jnp

from ..dataset import load_dataset
from .runner import run_gibbs

_DTYPES = {
    "float32": jnp.float32,
    "float64": jnp.float64,
    "bfloat16": jnp.bfloat16,
    "int8": jnp.int8,
}


def main(argv=None):
    p = argparse.ArgumentParser(description="Gibbs warm-start sampler")
    p.add_argument("--meth-file", required=True)
    p.add_argument("--phen-file", required=True)
    p.add_argument("--N", type=int, required=True)
    p.add_argument("--Mt", type=int, required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--out-name", default="gibbs")
    p.add_argument("--iterations", type=int, default=500)
    p.add_argument("--burnin", type=int, default=None)
    p.add_argument("--num-mix-comp", type=int, default=4,
                   help="mixture size L incl. the spike (decade ladder)")
    p.add_argument("--block", type=int, default=256)
    p.add_argument("--thin", type=int, default=1)  # thin>1 breaks reference pip.py normalization
    p.add_argument("--h2", type=float, default=0.5, help="h2 init guess")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--alpha-scale", type=float, default=1.0)
    p.add_argument("--compute-dtype", default="float32", choices=sorted(_DTYPES))
    a = p.parse_args(argv)

    ds = load_dataset(
        a.meth_file, a.phen_file, n=a.N, mt=a.Mt, model="linear",
        mesh=None, compute_dtype=_DTYPES[a.compute_dtype],
        alpha_scale=a.alpha_scale,
    )
    res = run_gibbs(
        ds.dm, ds.phen.y, iterations=a.iterations, burnin=a.burnin,
        l_comp=a.num_mix_comp, block=a.block, thin=a.thin, h2_init=a.h2,
        seed=a.seed, out_dir=a.out_dir, out_name=a.out_name,
    )
    print(f"[gibbs] done: h2={res.h2_mean:.4f} "
          f"sigma_g={res.sigma_g_mean:.4g} (file units) "
          f"lambda={1.0 - res.pi_mean[0]:.4g}")
    print(f"[gibbs] outputs: {res.csv_path} {res.bet_path} {res.grm_path}")


if __name__ == "__main__":
    main()
