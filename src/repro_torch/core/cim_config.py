"""CIMConfig — how the GR-CIM technique is applied inside a model.

A copy of ``repro.core.cim_config`` (the port imports nothing of the JAX
package); a test holds the two field by field.

Modes
-----
off        plain f32 matmuls (digital baseline).
fakequant  inputs/weights quantized to the CIM formats with straight-through
           gradients; accumulation is exact.
grmac      full GR-MAC signal-chain simulation: per-K-block mantissa
           accumulation, ADC quantization at the configured ENOB, digital
           renormalization.

``granularity`` selects the normalization domain: "row", "unit", or "conv"
(the conventional CIM, no gain ranging); ``n_r`` is the CIM array depth,
the K-block over which one analog accumulation + one ADC conversion happens.

Per-site policy: every projection carries a **site** label (``SITES``).
``for_site`` resolves the design that runs there: ``site_overrides`` first
(``"off"`` or a ``SiteDesign`` whose non-None fields replace the base),
otherwise the site's family must be in ``apply_to``.

``backend`` picks the grmac execution path (see ``kernels.dispatch``):
"auto" (the CUDA kernel for a CUDA tensor, the plain version for a CPU
tensor) or "ref" (the plain version wherever the tensor lies). ``tile_m``
and ``tile_n`` are kept so configs round-trip with the JAX package; the
port's kernel picks its own tiles.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple, Union

from .formats import FP4_E2M1, FP6_E3M2, FPFormat, IntFormat, parse_format

__all__ = ["CIMConfig", "SiteDesign", "SITES", "site_family"]


SITES = (
    "attn_qkv",     # attention wq/wk/wv projections
    "attn_o",       # attention output projection
    "mlp",          # dense MLP (wi / wg / wo), incl. MoE dense residual
    "moe_router",   # MoE router logits
    "moe_expert",   # MoE expert stacks (wi / wg / wo)
    "rglru",        # RG-LRU in/gate/out projections
    "ssm",          # Mamba2 in/bc/dt/out projections
    "head",         # LM head (tied or untied)
)

_SITE_FAMILY = {
    "attn_qkv": "qkvo",
    "attn_o": "qkvo",
    "mlp": "ffn",
    "moe_router": "expert",
    "moe_expert": "expert",
    "rglru": "qkvo",
    "ssm": "qkvo",
    "head": "head",
    # legacy family names double as sites (identity mapping)
    "qkvo": "qkvo",
    "ffn": "ffn",
    "expert": "expert",
}


def site_family(site: str) -> str:
    """The coarse ``apply_to`` family a site belongs to."""
    return _SITE_FAMILY.get(site, site)


@dataclasses.dataclass(frozen=True)
class SiteDesign:
    """A per-site design override: non-None fields replace the base
    ``CIMConfig`` fields at that site (see ``CIMConfig.for_site``)."""

    mode: Optional[str] = None          # off | fakequant | grmac
    granularity: Optional[str] = None   # row | unit | conv
    fmt_x: Optional[Union[FPFormat, IntFormat]] = None
    fmt_w: Optional[FPFormat] = None
    n_r: Optional[int] = None
    enob: Optional[float] = None

    def as_kwargs(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}

    def as_dict(self) -> dict:
        """JSON-able dump (formats by name); inverse of ``from_dict``."""
        out = self.as_kwargs()
        for k in ("fmt_x", "fmt_w"):
            if k in out:
                out[k] = out[k].name
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "SiteDesign":
        kw = dict(d)
        for k in ("fmt_x", "fmt_w"):
            if isinstance(kw.get(k), str):
                kw[k] = parse_format(kw[k])
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class CIMConfig:
    mode: str = "off"                  # off | fakequant | grmac
    granularity: str = "row"           # row | unit | conv
    fmt_x: Union[FPFormat, IntFormat] = FP6_E3M2
    fmt_w: FPFormat = FP4_E2M1
    n_r: int = 32                      # CIM array rows == matmul K-block
    enob: Optional[float] = None       # None -> the data-invariant bound, 8
    backend: str = "auto"              # auto | ref
    tile_m: Optional[int] = None
    tile_n: Optional[int] = None
    # Per-tensor pre-scale: activations are scaled into [-1, 1] by their
    # absmax before quantization; the scale is folded back after the MAC.
    dynamic_prescale: bool = True
    # Legacy coarse policy: apply the CIM path to these matmul families.
    # Consulted only for sites without an entry in ``site_overrides``.
    apply_to: tuple = ("ffn", "qkvo", "expert", "head")
    # Per-site policy: ((site, "off" | SiteDesign), ...), wins over apply_to.
    site_overrides: Tuple[Tuple[str, Union[str, SiteDesign]], ...] = ()

    @property
    def enabled(self) -> bool:
        return self.mode != "off" or any(
            ov != "off" and ov.mode not in (None, "off")
            for _, ov in self.site_overrides)

    def resolved_enob(self) -> float:
        if self.enob is not None:
            return self.enob
        # The uniform distribution upper-bounds the GR-MAC ADC requirement,
        # so a static spec is safe for any input data: 8 bits covers
        # FP6_E3M2 inputs / FP4 weights at N_R = 32 with margin.
        return 8.0

    def for_site(self, site: Optional[str]) -> "CIMConfig":
        """Resolve the design that runs at ``site`` (a plain CIMConfig with
        ``site_overrides`` cleared); ``site=None`` means already resolved."""
        if site is None:
            return self
        return _resolve_site(self, site)

    def override_site(
        self, site: str, design: Union[str, SiteDesign]
    ) -> "CIMConfig":
        """Return a config with ``site`` overridden (replacing any existing
        entry for the same site). ``design`` is ``"off"`` or a SiteDesign."""
        if site not in _SITE_FAMILY:
            raise ValueError(
                f"unknown site {site!r}: expected one of {SITES} "
                "or a legacy family name ('qkvo'/'ffn'/'expert'/'head')")
        if design != "off" and not isinstance(design, SiteDesign):
            raise TypeError(f"override must be 'off' or SiteDesign, "
                            f"got {design!r}")
        kept = tuple((s, d) for s, d in self.site_overrides if s != site)
        return dataclasses.replace(
            self, site_overrides=kept + ((site, design),))

    def with_site_overrides(self, overrides) -> "CIMConfig":
        """Apply a whole ``{site: "off" | SiteDesign}`` mapping (or an
        iterable of pairs) at once, in iteration order."""
        items = overrides.items() if hasattr(overrides, "items") \
            else overrides
        cfg = self
        for site, design in items:
            cfg = cfg.override_site(site, design)
        return cfg

    def with_mode(self, mode: str) -> "CIMConfig":
        return dataclasses.replace(self, mode=mode)

    def with_backend(self, backend: str) -> "CIMConfig":
        return dataclasses.replace(self, backend=backend)

    def with_tiles(self, tile_m: Optional[int],
                   tile_n: Optional[int] = None) -> "CIMConfig":
        return dataclasses.replace(self, tile_m=tile_m, tile_n=tile_n)


@functools.lru_cache(maxsize=4096)
def _resolve_site(cfg: CIMConfig, site: str) -> CIMConfig:
    base = (dataclasses.replace(cfg, site_overrides=())
            if cfg.site_overrides else cfg)
    ov = next((d for s, d in cfg.site_overrides if s == site), None)
    if ov is not None:
        if ov == "off":
            return dataclasses.replace(base, mode="off")
        return dataclasses.replace(base, **ov.as_kwargs())
    if site_family(site) in cfg.apply_to:
        return base
    return dataclasses.replace(base, mode="off")
