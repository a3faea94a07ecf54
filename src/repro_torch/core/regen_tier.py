"""Beyond-paper extension: the REGENERATION tier (paper §3.1 O1's unused
design implication — "because the images can be reproduced by the model,
cold images could be regenerated on demand as long as the model remains
available").

LatentBox stores *every* latent durably.  But 69 % of images get <10
lifetime views and 15 % exactly one; for sufficiently cold objects even a
0.29 MB latent is wasted capacity, because the (prompt, seed, model-id)
tuple — a few hundred bytes — regenerates the latent bit-exactly on the
same stack.  This module adds a third durability class:

    image cache (hot)  >  latent store (warm)  >  RECIPE store (cold)

with an age/popularity demotion policy and a cost model that answers when
demotion pays: storing a latent costs S_lat * P_s3 per month forever;
regenerating costs ~4 s of GPU per miss.  With the O2 decay fit, an object
older than `a` months sees lambda(a) views/mo, so demote when

    S_lat * P_s3  >  lambda(a) * t_gen_hr * P_gpu

Evaluated in benchmarks/bench_regen.py: the recipe tier removes most of
the residual latent footprint at a bounded tail-latency budget.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Recipe:
    """The few hundred bytes that regenerate an object bit-exactly on the
    same stack: generation seed + output geometry + model/version pin.

    In production this is (prompt, sampler seed, model id); this repo's
    stand-in "diffusion" is a seeded Gaussian draw, so the recipe is exactly
    the reproducibility contract — same recipe, same image, same latent.
    """

    seed: int
    height: int
    width: int
    channels: int = 3
    scale: float = 1.0             # amplitude of the stand-in generator
    model: str = "demo"
    prompt: str = ""

    @property
    def nbytes(self) -> int:
        return 4 * 8 + len(self.model.encode()) + len(self.prompt.encode())

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Dict) -> "Recipe":
        return Recipe(**d)


def synthesize_image(recipe: Recipe) -> np.ndarray:
    """Deterministic stand-in for the diffusion pipeline: recipe -> pixels.

    Returns ``[1, H, W, C]`` float32.  Same recipe => bit-identical pixels,
    which is what makes recipe-only storage a durability class at all.
    """
    rng = np.random.default_rng(recipe.seed)
    img = rng.standard_normal(
        (1, recipe.height, recipe.width, recipe.channels)) * recipe.scale
    return img.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class RegenPolicy:
    s_lat_mb: float = 0.29
    p_s3_gb_mo: float = 0.023
    t_gen_s: float = 3.905            # full diffusion pipeline (paper 6.3.1)
    p_gpu_hr: float = 0.69            # RTX-5090-class decode fleet
    recipe_bytes: float = 512.0       # prompt + seed + model/version ids
    decay_a0_mo: float = 1.0          # O2 fit (trace-calibrated)
    decay_beta: float = 1.8
    views_mo_at_birth: float = 3.0

    def view_rate_per_month(self, age_mo: np.ndarray) -> np.ndarray:
        return self.views_mo_at_birth * (1.0 + age_mo / self.decay_a0_mo) \
            ** (-self.decay_beta)

    def regen_cost_per_month(self, age_mo: np.ndarray) -> np.ndarray:
        return self.view_rate_per_month(age_mo) * (self.t_gen_s / 3600.0) \
            * self.p_gpu_hr

    def storage_cost_per_month(self) -> float:
        return self.s_lat_mb / 1024.0 * self.p_s3_gb_mo

    def demotion_age_months(self) -> float:
        """Break-even age: demote latents older than this (no re-access
        since) to recipe-only storage."""
        ages = np.linspace(0.01, 240.0, 4096)
        regen = self.regen_cost_per_month(ages)
        idx = np.searchsorted(-regen, -self.storage_cost_per_month())
        return float(ages[min(idx, len(ages) - 1)])


class RegenTierStore:
    """Latent store wrapper with recipe-only demotion.

    demote(oid): drop the latent blob, keep the recipe (few hundred bytes).
    fetch on a demoted object reports needs_regen=True; the serving layer
    routes it to the generation fleet (simulated by the cluster's
    `generation_ms`) and re-admits the regenerated latent.
    """

    def __init__(self, policy: Optional[RegenPolicy] = None, journal=None):
        """``journal`` (optional) is the shared durable
        :class:`~repro.store.durable.log.SegmentLog`: every state mutation
        appends a full-state recipe record, so recipes and demotion flags
        ride the same crash-recoverable log as the latent blobs.  Access
        *touches* (``fetch``) are deliberately not journaled — they would
        turn every read into a write; last-access times persist as of the
        last mutation/checkpoint and recovery may see them slightly
        stale."""
        self.policy = policy or RegenPolicy()
        self.journal = journal
        self._latents: Dict[int, float] = {}     # oid -> bytes
        self._recipes: Dict[int, float] = {}
        self._recipe_payloads: Dict[int, Recipe] = {}
        self._last_access_mo: Dict[int, float] = {}
        self.n_regens = 0

    # -- durability ------------------------------------------------------------
    def state_of(self, oid: int) -> Optional[Dict]:
        """Full-state snapshot of one object in the journal's record format
        (None: unknown oid) — the unit the replication layer ships to peer
        shards and feeds back through :meth:`restore_state`."""
        if oid not in self._recipes:
            return None
        recipe = self._recipe_payloads.get(oid)
        return {
            "recipe": recipe.to_json() if recipe is not None else None,
            "recipe_nbytes": self._recipes[oid],
            "latent_bytes": self._latents.get(oid),   # None => demoted
            "last_access_mo": self._last_access_mo.get(oid, 0.0),
        }

    def forget(self, oid: int) -> None:
        """Drop one object *without* journaling a delete — applying a
        replicated deletion that is already durable in the shipped log."""
        self._latents.pop(oid, None)
        self._recipes.pop(oid, None)
        self._recipe_payloads.pop(oid, None)
        self._last_access_mo.pop(oid, None)

    def _journal_state(self, oid: int) -> None:
        if self.journal is None:
            return
        self.journal.put_recipe_state(oid, self.state_of(oid))

    def _journal_delete(self, oid: int) -> None:
        if self.journal is not None:
            self.journal.delete_recipe(oid)

    def restore_state(self, oid: int, state: Dict) -> None:
        """Apply one recovered/ingested full-state record without
        re-journaling it (it is already durable in the log)."""
        oid = int(oid)
        self._recipes[oid] = float(state["recipe_nbytes"])
        if state.get("recipe") is not None:
            self._recipe_payloads[oid] = Recipe.from_json(state["recipe"])
        else:
            self._recipe_payloads.pop(oid, None)
        if state.get("latent_bytes") is not None:
            self._latents[oid] = float(state["latent_bytes"])
        else:
            self._latents.pop(oid, None)
        self._last_access_mo[oid] = float(state.get("last_access_mo", 0.0))

    def put(self, oid: int, latent_bytes: float, now_mo: float = 0.0,
            recipe: Optional[Recipe] = None,
            recipe_nbytes: Optional[float] = None) -> None:
        self._latents[oid] = latent_bytes
        self._recipes[oid] = (
            float(recipe_nbytes) if recipe_nbytes is not None
            else float(recipe.nbytes) if recipe is not None
            else self.policy.recipe_bytes)
        if recipe is not None:
            self._recipe_payloads[oid] = recipe
        self._last_access_mo[oid] = now_mo
        self._journal_state(oid)

    def recipe_of(self, oid: int) -> Optional[Recipe]:
        return self._recipe_payloads.get(oid)

    def recipe_bytes_of(self, oid: int) -> Optional[float]:
        """Accounted recipe bytes for one object (None: not in this tier);
        shard migration uses this to move accounting losslessly even for
        entries registered without a :class:`Recipe` payload."""
        return self._recipes.get(oid)

    def last_access_mo_of(self, oid: int) -> Optional[float]:
        """Last recorded access (months); shard migration carries it over
        so :meth:`run_demotion` never sees a migrated object as
        maximally idle."""
        return self._last_access_mo.get(oid)

    def __contains__(self, oid: int) -> bool:
        return oid in self._recipes

    def is_demoted(self, oid: int) -> bool:
        return oid in self._recipes and oid not in self._latents

    def demote(self, oid: int) -> bool:
        """Demote one object to recipe-only storage; True if a latent was
        actually dropped (False: already demoted / unknown)."""
        if oid not in self._latents or oid not in self._recipes:
            return False
        del self._latents[oid]
        self._journal_state(oid)
        return True

    def delete(self, oid: int) -> bool:
        found = oid in self._recipes or oid in self._latents
        self._latents.pop(oid, None)
        self._recipes.pop(oid, None)
        self._recipe_payloads.pop(oid, None)
        self._last_access_mo.pop(oid, None)
        if found:
            self._journal_delete(oid)
        return found

    def fetch(self, oid: int, now_mo: float) -> Tuple[float, bool]:
        """Returns (bytes_to_transfer, needs_regen)."""
        self._last_access_mo[oid] = now_mo
        if oid in self._latents:
            return self._latents[oid], False
        if oid in self._recipes:
            self.n_regens += 1
            return self._recipes[oid], True
        raise KeyError(oid)

    def readmit(self, oid: int, latent_bytes: float, now_mo: float) -> None:
        """After regeneration the latent is durable again (it just got
        accessed, so it's warm by definition)."""
        self._latents[oid] = latent_bytes
        self._last_access_mo[oid] = now_mo
        if oid in self._recipes:
            self._journal_state(oid)

    def run_demotion(self, now_mo: float,
                     age_override_mo: Optional[float] = None) -> int:
        """Demote every latent idle past the break-even age (or an explicit
        sweep age, for tradeoff curves off the economic break-even)."""
        cutoff = (self.policy.demotion_age_months()
                  if age_override_mo is None else float(age_override_mo))
        victims = [oid for oid, t in self._last_access_mo.items()
                   if oid in self._latents and now_mo - t > cutoff]
        for oid in victims:
            del self._latents[oid]
            if oid in self._recipes:
                self._journal_state(oid)
        return len(victims)

    @property
    def latent_bytes(self) -> float:
        return float(sum(self._latents.values()))

    @property
    def recipe_bytes(self) -> float:
        return float(sum(self._recipes.values()))
