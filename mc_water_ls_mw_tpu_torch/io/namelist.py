"""Fortran-namelist config reader accepting the reference's ice.input.

Copy of ``mc_water_ls_mw_tpu/io/namelist.py`` (the port imports nothing
of the JAX package).  Parses the six namelists of the reference verbatim
(io.f90:84-102: potential, thermal, MonteCarlo, config, bookkeeping,
parallelisation) plus an optional &tpu namelist for TPU-native
extensions (walker count, dtype, windows...).  Applies the same
sanity checks, defaults-before-read overrides, unit conversions and
single-box overrides as io_read_input (io.f90:58-245).
"""

from __future__ import annotations

import dataclasses
import os
import re

from ..constants import ANG_TO_BOHR, AUP_TO_ATM
from ..mcmc.config import RunParams


def _strip_comment(line: str) -> str:
    out = []
    quote = None
    for ch in line:
        if quote:
            out.append(ch)
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            out.append(ch)
        elif ch == "!":
            break
        else:
            out.append(ch)
    return "".join(out)


def _parse_value(tok: str):
    tok = tok.strip()
    low = tok.lower()
    if low in (".true.", ".t.", "t", "true"):
        return True
    if low in (".false.", ".f.", "f", "false"):
        return False
    if tok[:1] in "'\"" and tok[-1:] == tok[:1]:
        return tok[1:-1]
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        # Fortran exponents like 1.0d-3
        return float(tok.replace("d", "e").replace("D", "E"))
    except ValueError:
        return tok


def parse_namelists(path: str) -> dict[str, dict]:
    """Parse all &group ... / blocks -> {group_lower: {key: value}}."""
    groups: dict[str, dict] = {}
    current = None
    with open(path) as fh:
        for raw in fh:
            line = _strip_comment(raw).strip()
            if not line:
                continue
            if line.startswith("&"):
                current = line[1:].split()[0].lower()
                groups.setdefault(current, {})
                line = line[len(current) + 1:].strip()
                if not line:
                    continue
            if current is None:
                continue
            if line == "/" or line.endswith("/") and "=" not in line:
                current = None
                continue
            if line.endswith("/"):
                line = line[:-1].strip()
                closing = True
            else:
                closing = False
            for part in re.split(r",(?=\s*\w+\s*=)", line):
                if "=" not in part:
                    continue
                key, val = part.split("=", 1)
                vals = [
                    _parse_value(v) for v in val.split(",") if v.strip()
                ]
                groups[current][key.strip().lower()] = (
                    vals[0] if len(vals) == 1 else tuple(vals)
                )
            if closing:
                current = None
    return groups


# namelist key -> RunParams field (identity unless noted)
_GROUPS = {
    "potential": ["model_type"],
    "thermal": ["temperature", "pressure"],
    "montecarlo": [
        "mc_ensemble", "mc_max_trans", "mc_dv_max", "mc_target_ratio",
        "wl_factor", "wl_schedule", "wl_flattol", "wl_minhist",
        "wl_useinvt", "wl_swetnam", "wl_alpha", "eta_interp",
        "samplerun", "nbins", "mu_max", "mu_min", "allow_switch",
        "allow_vol", "allow_trans", "mc_trans_prob", "mc_vol_prob",
        "mc_switch_prob", "mc_always_switch", "leshift",
        "input_ref_enthalpy",
    ],
    "config": ["nwater", "num_lattices", "method", "ls"],
    "bookkeeping": [
        "list_update_int", "traj_output_int", "file_output_int",
        "latt_sync_int", "mpi_sync_int", "chkpt_dump_int",
        "monitor_int", "flat_chk_int", "invt_dump_int", "eq_adjust_mc",
        "deltag_int", "max_mc_cycles", "eq_mc_cycles", "timer_qtime",
        "timer_closetime",
    ],
    "parallelisation": ["parallel_strategy", "window_overlap"],
    "tpu": [
        "n_walkers", "n_windows", "dd_seeding", "neighbour_capacity",
        "dtype",
        "seed", "therm_walkers", "minu", "tile",
        "largen", "largen_threshold", "cell_cap", "relabel", "stack",
        "nbr_table", "trans_wall", "fused", "cell_pallas",
        "cell_trials", "cell_chain",
    ],
}

_FIELD_ALIASES = {"deltag_int": "deltaG_int"}


def read_input(path: str, extra_overrides: dict | None = None) -> RunParams:
    """Read an ice.input file into RunParams, reference-faithfully.

    Replicates io_read_input's behaviour including its quirks:

    * pre-namelist defaults mc_switch_prob=0.1 and
      mc_vol_prob=1/nwater are applied with nwater still at its
      *compile-time default* (768), because the config namelist is
      read after MonteCarlo (io.f90:171-174 vs :191);
    * unit conversions: pressure atm->a.u. (io.f90:165), move sizes
      Angstrom->Bohr (io.f90:185-186);
    * num_lattices==1 force-disables all switching (io.f90:208-220).
    """
    groups = parse_namelists(path)
    fields = {}

    # the reference's pre-MonteCarlo-read overrides (io.f90:171-172)
    fields["mc_switch_prob"] = 0.1
    fields["mc_vol_prob"] = 1.0 / RunParams.nwater  # default 768!

    for gname, keys in _GROUPS.items():
        grp = groups.get(gname, {})
        unknown = set(grp) - set(keys)
        if unknown:
            # a Fortran namelist read errors on unknown entries;
            # silently dropping them hides typos (io.f90:84-102)
            raise ValueError(
                f"unknown key(s) in &{gname}: {sorted(unknown)}"
            )
        for key in keys:
            if key in grp:
                fields[_FIELD_ALIASES.get(key, key)] = grp[key]

    # seedname from the input filename (io.f90:127-132)
    base = os.path.basename(path)
    fields["seedname"] = base.rsplit(".", 1)[0] if "." in base else base

    if extra_overrides:
        fields.update(extra_overrides)

    if "input_ref_enthalpy" in fields and not isinstance(
        fields["input_ref_enthalpy"], tuple
    ):
        fields["input_ref_enthalpy"] = (
            float(fields["input_ref_enthalpy"]), 0.0
        )
    if "tile" in fields and not isinstance(fields["tile"], tuple):
        fields["tile"] = (int(fields["tile"]),) * 3
    if "stack" in fields and not isinstance(fields["stack"], tuple):
        raise ValueError("stack needs three values: nx, ny, bilayers")

    prm = RunParams(**fields)

    # sanity checks (io.f90:162-244)
    if prm.temperature < 0:
        raise ValueError("temperature must be positive")
    if prm.mc_ensemble not in ("nvt", "npt"):
        raise ValueError("unrecognised ensemble: choose npt or nvt")
    if prm.nwater < 1:
        raise ValueError("invalid number of waters")
    if prm.method.strip() not in ("xmol", "stack"):
        raise ValueError("use method='xmol' (reference) or 'stack' "
                         "(built-in polytype builder)")
    for name in ("list_update_int", "traj_output_int", "file_output_int",
                 "max_mc_cycles", "eq_mc_cycles"):
        if getattr(prm, name) < 1:
            raise ValueError(f"{name} must be > 0")

    # unit conversions to internal a.u.
    prm = dataclasses.replace(
        prm,
        pressure=prm.pressure / AUP_TO_ATM,
        mc_max_trans=prm.mc_max_trans * ANG_TO_BOHR,
        mc_dv_max=prm.mc_dv_max * ANG_TO_BOHR,
    )

    # single-box overrides (io.f90:208-220)
    if prm.num_lattices == 1:
        prm = dataclasses.replace(
            prm,
            allow_switch=False,
            mc_switch_prob=0.0,
            mc_always_switch=False,
            ls=1,
        )
    elif prm.num_lattices != 2:
        raise ValueError("num_lattices must equal 1 or 2")

    if prm.parallel_strategy not in ("mw", "dd"):
        raise ValueError("unknown parallel strategy")

    return prm
