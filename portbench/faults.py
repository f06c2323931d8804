"""Faults planted under the harness, after set-up: each breaks the
program's timed path the way a later change could, and a run with one
has to come out not correct (``portbench/tests/test_portbench_run.py``
on the CPU; ``calibrate.py --fault <name>`` reads one at a cell's own
size on the card).  Each takes the set-up ``Application``."""

import torch

# what advances in a step whose state stays unchanged: the counters and
# the Wang-Landau and histogram bookkeeping
_ADVANCING = ("att", "acc", "trans_per_mol", "hist", "weight", "uhist",
              "sumhist", "f", "invt_active", "firstcycle",
              "histogram_reset", "avg_energy", "min_dmu", "max_dmu",
              "dropped")


def unchanged(app):
    """A step that returns its configuration unchanged while its
    counters, histogram and weights advance."""
    eng = app.engine
    orig = eng.run_cycles

    def run_cycles(s, n):
        keep = s.clone()
        s, smp = orig(s, n)
        for name, v in vars(s).items():
            if isinstance(v, torch.Tensor) and name not in _ADVANCING:
                v.copy_(getattr(keep, name))
        return s, smp

    eng.run_cycles = run_cycles


def half(app):
    """Half of the batch left out: the second half of the walkers keeps
    its state through every step."""
    eng = app.engine
    orig = eng.run_cycles

    def run_cycles(s, n):
        keep = s.clone()
        s, smp = orig(s, n)
        W = s.r.shape[-1]
        for name, v in vars(s).items():
            if isinstance(v, torch.Tensor) and v.dim() and \
                    v.shape[-1] == W:
                v[..., W // 2:] = getattr(keep, name)[..., W // 2:]
        return s, smp

    eng.run_cycles = run_cycles


def altered(app):
    """An answer altered where it is produced: each step's energies off
    by 1e-3 Hartree."""
    eng = app.engine
    orig = eng.run_cycles

    def run_cycles(s, n):
        s, smp = orig(s, n)
        s.energy[:, 0] += 1e-3
        return s, smp

    eng.run_cycles = run_cycles


def _decide(u):
    """Every translation, volume move and lattice switch decided against
    the acceptance uniform ``u`` in the random stream that both the
    kernels and the plain paths read: +inf rejects every move, -inf
    accepts every one that the guards (finite energies, walls) let
    through."""
    def fault(app):
        eng = app.engine
        stream = eng.stream
        if hasattr(eng, "_split_uniforms"):
            # the cell engine: u_a [n, K*T, W] of each sub-step's trials
            split = eng._split_uniforms

            def split_uniforms(u_all):
                u_mv, u_a, u_z = split(u_all)
                return (u_mv, torch.full_like(u_a, u),
                        torch.full_like(u_z, u))

            eng._split_uniforms = split_uniforms
        else:
            # the dense engine at one trial a move: rows 5 (accept) and
            # 6 (switch) of each move's uniforms [7, W]
            draws = stream.cycle_draws

            def cycle_draws(*a, **k):
                codes, sched, cycle_u = draws(*a, **k)
                cycle_u = cycle_u.clone()
                cycle_u[:, 5:7] = u
                return codes, sched, cycle_u

            stream.cycle_draws = cycle_draws
        vol = stream.volume_draws

        def volume_draws(*a, **k):
            uv, zeta2 = vol(*a, **k)
            uv = uv.clone()
            uv[:, 3] = u
            return uv, torch.full_like(zeta2, u)

        stream.volume_draws = volume_draws

    return fault


reject_all = _decide(float("inf"))
accept_all = _decide(-float("inf"))

FAULTS = {"unchanged": unchanged, "half": half, "altered": altered,
          "reject_all": reject_all, "accept_all": accept_all}
