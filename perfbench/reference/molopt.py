"""One served optimization request followed step by step, in plain NumPy
and PyTorch: the start molecule parsed, every step's candidate actions
enumerated and fingerprinted (the frozen chemistry's materialise-then-
filter enumeration and full Morgan fingerprints, where the program runs
its delta enumeration and incremental fingerprints), the Q values of the
candidates computed by a plain MLP, the request's exploration draws
replayed, the chosen successor scored by the oracle under Eq. 1, and the
best molecule and reward kept.

The reference follows the actions the program took (as a served model's
reference follows the served tokens), and reports how far the program's
Q values lie from its own, how far below its best each greedy choice
lies, and every discrete disagreement."""

from __future__ import annotations

import zlib

import numpy as np
import torch

from perfbench.reference.chem.actions import enumerate_actions_ref
from perfbench.reference.chem.conformer import has_valid_conformer
from perfbench.reference.chem.fingerprint import morgan_fingerprint
from perfbench.reference.chem.molecule import ALLOWED_RING_SIZES
from perfbench.reference.chem.oracle import oracle_bde, oracle_ip
from perfbench.reference.chem.smiles import canonical_smiles, from_smiles


def reward(rc: dict, bde, ip, initial, current, steps_left: int) -> float:
    """Eq. 1 (DA-MolDQN section 3.4): min-max normalised BDE and IP, each
    decayed by its factor to the power of the steps left, and the relative
    shrinkage of atoms and bonds; no valid conformer or no O-H bond scores
    the invalid-conformer reward."""
    if ip is None or bde is None:
        return rc["invalid_conformer_reward"]
    nbde = (bde - rc["bde_min"]) / max(rc["bde_max"] - rc["bde_min"], 1e-9) \
        * (rc["bde_factor"] ** steps_left)
    nip = (ip - rc["ip_min"]) / max(rc["ip_max"] - rc["ip_min"], 1e-9) \
        * (rc["ip_factor"] ** steps_left)
    a0 = max(initial.num_atoms, 1)
    b0 = max(initial.num_bonds, 1)
    gamma = 0.5 * ((a0 - current.num_atoms) / a0
                   + (b0 - current.num_bonds) / b0)
    return -rc["bde_weight"] * nbde + rc["ip_weight"] * nip \
        + rc["gamma_weight"] * gamma


def q_values(weights, x: np.ndarray, device, tf32: bool = False) -> np.ndarray:
    """Plain f32 MLP (ReLU between layers) over rows ``x [N, in]``; TF32 is
    off unless ``tf32`` (the control)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with torch.no_grad():
            h = torch.from_numpy(x).to(device)
            for k, (w, b) in enumerate(weights):
                h = h @ w + b
                if k < len(weights) - 1:
                    h = torch.relu(h)
            return h[:, 0].cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def runner_up(q: np.ndarray) -> int | None:
    """The index of the best candidate whose Q lies strictly below the
    largest; None where every candidate ties."""
    below = np.flatnonzero(q < q.max())
    return None if below.size == 0 else int(below[np.argmax(q[below])])


def follow(req: dict, trajectory, result: dict, weights, serve: dict,
           rc: dict, serve_seed: int, device, controls: bool = False) -> dict:
    """``req``: smiles, budget, seed, request_id; ``trajectory``: the
    program's ``(q [n], chosen index)`` per step; ``result``: its
    ``best_smiles``, ``best_reward`` and ``steps_used``.  Returns the
    worst Q gap and greedy gap (how far below the reference's best Q the
    program's greedy choice lies; each as a share of the step's largest
    |Q|) and the count of discrete disagreements.  With ``controls``, also
    what the control reads (the reference's own Q in TF32 in the program's
    place: ``ctl_q_gap``, ``ctl_greedy_gap``) and what a wrong greedy pick
    reads (the runner-up candidate chosen at every greedy step:
    ``wrong_pick_greedy_gap``)."""
    max_steps = serve["max_steps"]
    mol = from_smiles(req["smiles"])
    initial = mol
    steps_left = max(1, min(int(req["budget"]), max_steps))
    rng = np.random.default_rng(
        [int(serve_seed), int(req["seed"]), zlib.crc32(req["request_id"].encode())])
    eps = serve["epsilon"]
    q_gap = greedy_gap = 0.0
    ctl_q_gap = ctl_greedy_gap = wrong_pick_gap = 0.0
    mismatches = []
    best = None
    for step, (q_prog, a) in enumerate(trajectory):
        acts = enumerate_actions_ref(
            mol, allow_removal=True, protect_oh=True,
            allowed_ring_sizes=ALLOWED_RING_SIZES, max_atoms=serve["max_atoms"])
        if len(acts) != len(q_prog):
            mismatches.append(f"step {step}: {len(q_prog)} candidates served, "
                              f"{len(acts)} in the reference")
            break
        x = np.zeros((len(acts), 2049), np.float32)
        for i, act in enumerate(acts):
            x[i, :2048] = morgan_fingerprint(act.result)
        x[:, 2048] = (steps_left - 1) / max_steps
        q = q_values(weights, x, device).astype(np.float64)
        scale = max(float(np.max(np.abs(q))), 1e-30)
        q_gap = max(q_gap, float(np.max(np.abs(np.asarray(q_prog, np.float64) - q))) / scale)
        explore = eps > 0.0 and rng.random() < eps
        if explore:
            drawn = int(rng.integers(0, len(acts)))
            if drawn != a:
                mismatches.append(f"step {step}: explored index {a}, the "
                                  f"request's draw is {drawn}")
        else:
            greedy_gap = max(greedy_gap, float(q.max() - q[a]) / scale)
        if controls:
            qc = q_values(weights, x, device, tf32=True).astype(np.float64)
            ctl_q_gap = max(ctl_q_gap, float(np.max(np.abs(qc - q))) / scale)
            if not explore:
                ctl_greedy_gap = max(ctl_greedy_gap,
                                     float(q.max() - q[int(np.argmax(qc))]) / scale)
                second = runner_up(q)
                if second is not None:
                    wrong_pick_gap = max(wrong_pick_gap,
                                         float(q.max() - q[second]) / scale)
        mol = acts[a].result
        steps_left -= 1
        bde = oracle_bde(mol)
        ip = oracle_ip(mol) if has_valid_conformer(mol) else None
        r = float(reward(rc, bde, ip, initial, mol, steps_left))
        if best is None or r > best[0]:
            best = (r, mol)
    if len(trajectory) != result["steps_used"]:
        mismatches.append(f"{len(trajectory)} Q choices for "
                          f"{result['steps_used']} steps used")
    if best is not None:
        if canonical_smiles(best[1]) != result["best_smiles"]:
            mismatches.append(f"best molecule {result['best_smiles']} served, "
                              f"{canonical_smiles(best[1])} in the reference")
        if best[0] != result["best_reward"]:
            mismatches.append(f"best reward {result['best_reward']!r} served, "
                              f"{best[0]!r} in the reference")
    out = {"q_gap": q_gap, "greedy_gap": greedy_gap, "mismatches": mismatches}
    if controls:
        out.update(ctl_q_gap=ctl_q_gap, ctl_greedy_gap=ctl_greedy_gap,
                   wrong_pick_greedy_gap=wrong_pick_gap)
    return out
