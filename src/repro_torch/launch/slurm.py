"""Copy of ``repro.launch.slurm``; only the launched module differs
(``repro_torch.launch.train``).

SLURM launch-script generation (paper §3.1: "distributed processes
(workers) are launched by SLURM").

Generates sbatch scripts for the two launch styles in Table 2 (torchrun
for individual/parallel/fine-tuned models; SLURM multi-node for the
general model) translated to JAX distributed initialization.  On a TPU
cluster the same program uses jax.distributed.initialize with the
coordinator from SLURM env vars.

    PYTHONPATH=src python -m repro_torch.launch.slurm --nodes 4 --out run_general.sbatch

The port keeps the reference's behaviour: the template exports the
``JAX_*`` coordinator variables, which neither launcher reads, so every
``srun`` task runs the same single-controller program.
"""

from __future__ import annotations

import argparse

TEMPLATE = """#!/bin/bash
#SBATCH --job-name={job}
#SBATCH --nodes={nodes}
#SBATCH --ntasks-per-node={tasks_per_node}
#SBATCH --cpus-per-task={cpus}
#SBATCH --time={time}
#SBATCH --output=logs/%x_%j.out

# DA-MolDQN general-model training (paper Table 1: General row)
export COORD=$(scontrol show hostnames $SLURM_JOB_NODELIST | head -n 1)
export JAX_COORDINATOR_ADDRESS=$COORD:12345
export JAX_NUM_PROCESSES=$SLURM_NTASKS
export JAX_PROCESS_ID=$SLURM_PROCID

srun python -m repro_torch.launch.train --mode rl \\
    --workers {workers} --mols-per-worker {mols_per_worker} \\
    --episodes {episodes} --sync episode
"""


def render(*, job: str = "damoldqn-general", nodes: int = 4, tasks_per_node: int = 4,
           cpus: int = 8, time: str = "02:00:00", workers: int = 16,
           mols_per_worker: int = 4, episodes: int = 250) -> str:
    return TEMPLATE.format(job=job, nodes=nodes, tasks_per_node=tasks_per_node,
                           cpus=cpus, time=time, workers=workers,
                           mols_per_worker=mols_per_worker, episodes=episodes)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=4)       # Table 1: 4 nodes
    ap.add_argument("--episodes", type=int, default=250)  # Table 1
    ap.add_argument("--out", default="run_general.sbatch")
    args = ap.parse_args()
    script = render(nodes=args.nodes, episodes=args.episodes,
                    workers=args.nodes * 4)
    with open(args.out, "w") as f:
        f.write(script)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
