"""One trainer worker's first episode, in plain NumPy and PyTorch: its
start molecules parsed, every step's candidates enumerated and
fingerprinted with the frozen chemistry (materialise-then-filter
enumeration, full Morgan fingerprints), the candidates' Q values under the
initial weights, the worker's epsilon-greedy draws, the oracle's
properties and Eq. 1's reward, and the replay transitions in the order
the worker's buffer receives them (step by step, slot by slot; a
transition waits for its successor's candidates, and the last step's are
terminal)."""

from __future__ import annotations

import numpy as np

from perfbench.reference.chem.actions import enumerate_actions_ref
from perfbench.reference.chem.conformer import has_valid_conformer
from perfbench.reference.chem.fingerprint import morgan_fingerprint
from perfbench.reference.chem.molecule import ALLOWED_RING_SIZES
from perfbench.reference.chem.oracle import oracle_bde, oracle_ip
from perfbench.reference.chem.smiles import from_smiles
from perfbench.reference.molopt import q_values, reward


def reward_bounds(smiles: list[str]) -> dict:
    """Eq. 1's min-max bounds from a pool's oracle properties (section 3.4:
    the training set's minimum and maximum)."""
    mols = [from_smiles(s) for s in smiles]
    bde = np.array([oracle_bde(m) for m in mols], np.float64)
    ip = np.array([oracle_ip(m) for m in mols], np.float64)
    return {"bde_min": float(bde.min()), "bde_max": float(bde.max()),
            "ip_min": float(ip.min()), "ip_max": float(ip.max())}


def first_episode(smiles: list[str], seed: int, worker: int, weights,
                  cfg: dict, rc: dict, device, tf32_control: bool = False) -> dict:
    """The worker's first episode (epsilon starts at 1, so every action
    is the worker's own draw).  Returns the candidates' Q values step by
    step (concatenated over the worker's live slots, as one dispatch
    serves them), the control's (TF32) when asked, and the transitions."""
    max_steps, max_atoms = cfg["max_steps"], cfg["max_atoms"]
    eps = cfg["epsilon_initial"]
    rng = np.random.default_rng(int(seed) + 300 + worker)
    slots = [{"initial": m, "current": m, "left": max_steps, "pending": None}
             for m in (from_smiles(s) for s in smiles)]
    q_steps, ctl_steps, out = [], [], []
    for _ in range(max_steps):
        live = [s for s in slots if s["left"] > 0]
        if not live:
            break
        rows, per = [], []
        for s in live:
            acts = enumerate_actions_ref(
                s["current"], allow_removal=True, protect_oh=True,
                allowed_ring_sizes=ALLOWED_RING_SIZES, max_atoms=max_atoms)
            fps = np.stack([morgan_fingerprint(a.result) for a in acts])
            packed = np.packbits(fps.astype(np.uint8), axis=-1)
            if s["pending"] is not None:       # the successor's candidates
                t = s["pending"]
                t["next_fps"] = packed
                t["next_steps_left_frac"] = (s["left"] - 1) / max_steps
                out.append(t)
                s["pending"] = None
            x = np.zeros((len(acts), fps.shape[1] + 1), np.float32)
            x[:, :-1] = fps
            x[:, -1] = (s["left"] - 1) / max_steps
            rows.append(x)
            per.append((acts, packed))
        x = np.concatenate(rows)
        q = q_values(weights, x, device)
        q_steps.append(q)
        if tf32_control:
            ctl_steps.append(q_values(weights, x, device, tf32=True))
        off = 0
        for s, (acts, packed) in zip(live, per):
            n = len(acts)
            if rng.random() < eps:
                a = int(rng.integers(0, n))
            else:
                a = int(np.argmax(q[off:off + n]))
            off += n
            s["current"] = acts[a].result
            s["left"] -= 1
            mol = s["current"]
            bde = oracle_bde(mol)
            ip = oracle_ip(mol) if has_valid_conformer(mol) else None
            t = {"state_fp": packed[a], "steps_left_frac": s["left"] / max_steps,
                 "reward": float(reward(rc, bde, ip, s["initial"], mol, s["left"])),
                 "done": s["left"] <= 0,
                 "next_fps": np.zeros((0, packed.shape[1]), np.uint8),
                 "next_steps_left_frac": 0.0}
            if t["done"]:
                out.append(t)
            else:
                s["pending"] = t
    return {"q": q_steps, "control_q": ctl_steps, "transitions": out}


def transition_mismatches(prog: list[dict], ref: list[dict], candidates: int
                          ) -> list[str]:
    """Every field of every transition the program's buffer holds against
    the reference's, in order; next states compared up to the buffer's
    ``candidates`` bound."""
    out = []
    if len(prog) != len(ref):
        out.append(f"{len(prog)} transitions stored, {len(ref)} in the reference")
    for i, (p, r) in enumerate(zip(prog, ref)):
        k = min(r["next_fps"].shape[0], candidates)
        same = (np.array_equal(p["state_fp"], r["state_fp"])
                and p["steps_left_frac"] == np.float32(r["steps_left_frac"])
                and p["reward"] == np.float32(r["reward"])
                and bool(p["done"]) == r["done"]
                and p["next_fps"].shape[0] == k
                and np.array_equal(p["next_fps"], r["next_fps"][:k])
                and p["next_steps_left_frac"] == np.float32(r["next_steps_left_frac"]))
        if not same:
            out.append(f"transition {i} differs")
    return out
