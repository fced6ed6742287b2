"""The render engine: view state, navigation, algorithm resolution,
render orchestration and orbit persistence.  The port of
``fractalshark_tpu/engine/fractal.py``: the direct escapes (f32/f64,
HDR, double-float, quad-double and CpuHigh's host arbitrary precision),
the LAv2 families in every LA mode (2x32 and hdr2x32 without a valid LA
table through the HDR double-float render), the BLA and Scaled
perturbation families, the feature finder's entry points, the orbit
save/load/diff and the text and console outputs.  Every tensor lives on
the fractal's explicit ``device``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from fractalshark_tpu_torch.core.algorithms import (
    Family, RenderAlgorithm, auto_select, get_algorithm)
from fractalshark_tpu_torch.core.highprecision import HighPrecision
from fractalshark_tpu_torch.core.palette import FractalPalette
from fractalshark_tpu_torch.core.pointzoom import PointZoomBBConverter
from fractalshark_tpu_torch.core.precision import precision_from_view
from fractalshark_tpu_torch.core.views import get_view_preset
from fractalshark_tpu_torch.io.png import write_png
from fractalshark_tpu_torch.kernels import resolve_device
from fractalshark_tpu_torch.ops import dblflt, escape, hdr_escape, quadd
from fractalshark_tpu_torch.ops.coloring import (
    color_from_iters, iteration_stats, rgba16_to_numpy, rgba16_to_rgba8)


# the routes whose reference returns uint32 at any budget: the XLA
# perturbation-only loops (``ops/perturb.py:154,222``), B10
# (``ops/perturb_pallas.py:105``), the HDR and double-float escapes
# (``ops/hdr_escape.py:89``, ``ops/dblflt.py:193``), the quad-double
# escape (``ops/quadd.py:202``), BLA (``ops/bla_kernel.py:122``), Scaled
# (``ops/scaled.py:88``) and the HDR double-float render
# (``ops/hdr_df.py:226``), all of which count in int32
_ALWAYS_U32 = ("perturb-f32", "perturb-f64", "perturb-hdr64",
               "perturb-pallas", "escape-hdr32", "escape-hdr64",
               "escape-2x32", "escape-2x64", "escape-4x32", "escape-4x64",
               "bla-f32", "bla-f64", "scaled", "hdr-df")


def public_dtype(route: str | None, max_iter: int):
    """The numpy dtype of a grid at the public boundary, by the route that
    rendered it (``BenchmarkData.extra["kernel"]``), as each of the
    reference's routes returns it: the direct escapes uint32 below 2^32
    (``escape.py:69-70``); the LA renders and the streaming tails uint32
    below 2^31 (``la_kernel.py:515``, ``perturb_stream.py:100-109``);
    the routes of _ALWAYS_U32 uint32 always; CpuHigh uint64 always
    (``engine/fractal.py:210``); uint64 above those budgets."""
    if route in _ALWAYS_U32:
        return np.uint32
    if route == "cpu-high":
        return np.uint64
    cut = 1 << (32 if route == "escape" else 31)
    return np.uint64 if max_iter >= cut else np.uint32


@dataclass
class BenchmarkData:
    """Phase timers (reference BenchmarkData.h:28-46)."""
    overall_s: float = 0.0
    per_pixel_s: float = 0.0
    ref_orbit_s: float = 0.0
    la_generation_s: float = 0.0
    extra: dict = field(default_factory=dict)


class Fractal:
    def __init__(self, width: int = 1024, height: int = 1024,
                 view: int | PointZoomBBConverter = 0,
                 algorithm: str = "AUTO",
                 num_iterations: int | None = None,
                 antialiasing: int = 1,
                 device="cuda",
                 compression_error_exp: int = 20):
        self.width = width
        self.height = height
        self.antialiasing = antialiasing
        self.compression_error_exp = compression_error_exp
        # an AbortMonitor (utils/aux.py) or None: the chunked run loops
        # poll it between launches
        self.abort_monitor = None
        self.la_parameters = None
        self.palette = FractalPalette()
        self.device = resolve_device(device)
        self.algorithm_name = algorithm
        self.num_iterations = 256
        self.benchmark = BenchmarkData()
        self._iters_cache = None
        self._orbit_cache = None
        if isinstance(view, PointZoomBBConverter):
            self.ptz = view.square_aspect_ratio(width, height)
        else:
            self.set_view_preset(view)
        if num_iterations is not None:
            self.num_iterations = num_iterations

    @property
    def backend(self) -> str:
        return self.device.type

    def set_view_preset(self, index: int) -> None:
        preset = get_view_preset(index)
        self.ptz = preset.ptz.square_aspect_ratio(self.width, self.height)
        self.num_iterations = preset.num_iterations
        if preset.antialiasing > 1:
            self.antialiasing = preset.antialiasing
        self._iters_cache = None

    def set_view(self, ptz: PointZoomBBConverter,
                 square_aspect: bool = True) -> None:
        self.ptz = (ptz.square_aspect_ratio(self.width, self.height)
                    if square_aspect else ptz)
        self._iters_cache = None

    def zoom(self, scale: float) -> None:
        self.ptz = self.ptz.zoomed_at_center(scale)
        self._iters_cache = None

    def zoom_at(self, screen_x: float, screen_y: float, scale: float) -> None:
        cx = self.ptz.x_screen_to_calc(screen_x, self.width)
        cy = self.ptz.y_screen_to_calc(screen_y, self.height)
        self.ptz = self.ptz.zoomed_toward_point(cx, cy, scale)
        self._iters_cache = None

    def pan(self, dx_frac: float, dy_frac: float) -> None:
        """Pan by a fraction of the current extent."""
        ex = self.ptz.max_x - self.ptz.min_x
        ey = self.ptz.max_y - self.ptz.min_y
        self.ptz = self.ptz.panned(ex * HighPrecision(dx_frac),
                                   ey * HighPrecision(dy_frac))
        self._iters_cache = None

    def resize(self, width: int, height: int) -> None:
        self.width, self.height = width, height
        self.ptz = self.ptz.square_aspect_ratio(width, height)
        self._iters_cache = None

    # --------------------------------------------------------- feature find

    def try_find_periodic_point(self, max_period: int | None = None,
                                method: str = "newton",
                                checkpoint_path: str | None = None):
        """Find + refine a minibrot near the view center
        (Fractal::TryFindPeriodicPoint, Fractal.cpp:1847)."""
        from fractalshark_tpu_torch.engine.feature_finder import \
            find_periodic_point
        return find_periodic_point(
            self.ptz, max_period or min(self.num_iterations, 1_000_000),
            method=method, checkpoint_path=checkpoint_path)

    def zoom_to_feature(self, feature, frame_scale: float = 8.0) -> None:
        """Recenter on a found feature, framed a few× its size."""
        size = feature.size_estimate
        zoom = HighPrecision.from_mant_exp(
            int(frame_scale * 16), -size.e - 4, prec=64)
        self.set_view(PointZoomBBConverter(
            pt_x=feature.center_x, pt_y=feature.center_y,
            zoom_factor=zoom))

    # ------------------------------------------------------------ algorithm

    def resolve_algorithm(self) -> RenderAlgorithm:
        alg = get_algorithm(self.algorithm_name)
        if alg.family is Family.AUTO:
            radius_exp = abs(self.ptz.radius.exponent2())
            alg = auto_select(radius_exp,
                              has_accelerator=(self.device.type == "cuda"))
        return alg

    def required_precision(self, requires_reuse: bool = False) -> int:
        return precision_from_view(self.ptz, requires_reuse)

    def _render_dims(self) -> tuple[int, int]:
        return (self.width * self.antialiasing,
                self.height * self.antialiasing)

    def calc_fractal(self) -> torch.Tensor:
        """The int64 iteration grid [H*aa, W*aa] on the device."""
        alg = self.resolve_algorithm()
        t0 = time.perf_counter()
        if alg.family is Family.DIRECT:
            iters = self._calc_direct(alg)
        elif alg.is_perturbed:
            from fractalshark_tpu_torch.engine.renderers import calc_perturbed
            iters = calc_perturbed(self, alg)
        else:
            raise NotImplementedError(f"family {alg.family}")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.benchmark.per_pixel_s = time.perf_counter() - t0
        self._iters_cache = iters
        return iters

    def _calc_direct(self, alg: RenderAlgorithm) -> torch.Tensor:
        """The direct escapes (``engine/fractal.py:175-203``); the HDR,
        double-float and quad-double ones take the render's dimensions and
        split the view at antialiasing 1, as the reference calls them."""
        w, h = self._render_dims()
        n = self.num_iterations
        route = "escape" if alg.dtype in ("f32", "f64") else \
            "cpu-high" if alg.dtype == "hp" else f"escape-{alg.dtype}"
        self.benchmark.extra["kernel"] = route
        if alg.dtype == "hp":
            return self._calc_cpu_high()
        if alg.dtype in ("2x32", "2x64"):
            return dblflt.escape_df(self.ptz, w, h, n, variant=alg.dtype,
                                    device=self.device)
        if alg.dtype in ("4x32", "4x64"):
            return quadd.escape_qd(self.ptz, w, h, n, variant=alg.dtype,
                                   device=self.device)
        if alg.dtype in ("hdr32", "hdr64"):
            return hdr_escape.escape_hdr(
                self.ptz, w, h, n, device=self.device,
                sub_dtype=np.float32 if alg.dtype == "hdr32" else np.float64)
        params = escape.PlainParams.from_view(
            self.ptz, self.width, self.height, self.antialiasing)
        return escape.escape(params, w, h, n, dtype=alg.dtype,
                             device=self.device)

    def _calc_cpu_high(self) -> torch.Tensor:
        """CpuHigh: the iteration in arbitrary precision per pixel on the
        host (Python ints through ``HighPrecision``), the algorithm's own
        semantics (``engine/fractal.py:205-230``; tiny frames only); the
        grid goes to the fractal's device."""
        w, h = self._render_dims()
        prec = self.required_precision()
        out = np.zeros((h, w), np.int64)
        four = HighPrecision(4, prec=prec)
        dx = self.ptz.delta_x(self.width, self.antialiasing)
        dy = self.ptz.delta_y(self.height, self.antialiasing)
        n = self.num_iterations
        for y in range(h):
            cy = self.ptz.max_y - dy * HighPrecision(y)
            for x in range(w):
                cx = self.ptz.min_x + dx * HighPrecision(x)
                zx, zy = cx, cy
                i = 0
                while i < n:
                    zx2 = zx * zx
                    zy2 = zy * zy
                    if zx2 + zy2 > four:
                        break
                    zy = zx * zy * 2 + cy
                    zx = zx2 - zy2 + cx
                    i += 1
                out[y, x] = i
        return torch.from_numpy(out).to(self.device)

    def _iters(self, iters):
        if iters is not None:
            return iters
        return (self._iters_cache if self._iters_cache is not None
                else self.calc_fractal())

    def iters_numpy(self, iters=None) -> np.ndarray:
        """The grid as numpy, in the dtype the reference's route returns
        (``public_dtype`` of the route the last render took)."""
        a = self._iters(iters).cpu().numpy()
        return a.astype(public_dtype(self.benchmark.extra.get("kernel"),
                                     self.num_iterations))

    def color(self, iters=None) -> torch.Tensor:
        """RGBA16 [H, W, 4] on the device."""
        iters = self._iters(iters)
        pal = np.roll(self.palette.current(), -self.palette.rotation, axis=0)
        return color_from_iters(iters, pal, self.num_iterations,
                                self.palette.aux_depth,
                                antialiasing=self.antialiasing)

    def stats(self, iters=None) -> dict:
        return iteration_stats(self._iters(iters))

    def render(self) -> torch.Tensor:
        t0 = time.perf_counter()
        iters = self.calc_fractal()
        t1 = time.perf_counter()
        rgba = self.color(iters)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.benchmark.extra["color_s"] = time.perf_counter() - t1
        self.benchmark.overall_s = time.perf_counter() - t0
        return rgba

    def save_png(self, path: str, bit_depth: int = 8) -> None:
        rgba = self.render()
        t0 = time.perf_counter()
        if bit_depth == 8:
            write_png(path, rgba16_to_rgba8(rgba))
        else:
            write_png(path, rgba16_to_numpy(rgba))
        self.benchmark.extra["png_s"] = time.perf_counter() - t0

    # -------------------------------------------------------- orbit persist

    def save_ref_orbit(self, path: str, compression: str = "simple") -> None:
        """Persist the last-used reference orbit (Fractal::SaveRefOrbit,
        Fractal.h:231-240).  `compression`: "none" | "simple" | "max" (own
        format) | "imagina" (.im binary); the error exponent is
        ``compression_error_exp`` (CLI --compression-error-exp-low)."""
        from fractalshark_tpu_torch.engine.renderers import get_orbit_calc
        calc = get_orbit_calc(self)
        if not calc.cache:
            raise RuntimeError("no reference orbit computed yet")
        results = calc.cache[-1]
        if compression == "imagina":
            from fractalshark_tpu_torch.io.imagina import save_orbit_im
            save_orbit_im(path, results, comp=results.compress(
                self.compression_error_exp))
        else:
            results.save(path, compression=compression,
                         error_exp=self.compression_error_exp)

    def load_ref_orbit(self, path: str, imagina: bool | None = None):
        """Load an orbit into the orbit cache.  An .im file also sets the
        view and budget it was saved with, and, where the algorithm is
        AUTO, the algorithm its depth recommends (RecommendedSettings,
        RefOrbitCalc.cpp:3483); an explicit algorithm stays."""
        from fractalshark_tpu_torch.engine.renderers import get_orbit_calc
        if imagina is None:
            imagina = path.endswith(".im")
        if imagina:
            from fractalshark_tpu_torch.io.imagina import (
                OrbitParameterPack, load_orbit_im)
            f = load_orbit_im(path)
            results = f.results
            if results is None:
                raise ValueError("location-only .im file: no orbit data")
            pack = OrbitParameterPack(f)
            self.set_view(pack.view())
            self.num_iterations = min(f.iteration_limit, 1 << 62)
            if get_algorithm(self.algorithm_name).family is Family.AUTO:
                self.algorithm_name = pack.recommended_algorithm(
                    has_accelerator=(self.device.type == "cuda")).name
        else:
            from fractalshark_tpu_torch.engine.perturbation_results import \
                PerturbationResults
            results = PerturbationResults.load(path)
        calc = get_orbit_calc(self)
        with calc.lock:
            calc.cache.append(results)
        return results

    @staticmethod
    def diff_ref_orbits(a, b, count: int | None = None) -> dict:
        """Numeric comparison of two orbits (Fractal::DiffRefOrbits,
        Fractal.h:232-235)."""
        n = count or min(a.count_orbit_entries(), b.count_orbit_entries())
        dx = np.abs(a.orbit_x[:n] - b.orbit_x[:n])
        dy = np.abs(a.orbit_y[:n] - b.orbit_y[:n])
        differ = (dx > 0) | (dy > 0)
        return {
            "compared": n,
            "max_abs_dx": float(dx.max()) if n else 0.0,
            "max_abs_dy": float(dy.max()) if n else 0.0,
            "first_diff": int(np.argmax(differ)) if differ.any() else -1,
            "period_match": a.period == b.period,
        }

    # ------------------------------------------------------ text outputs

    def save_iters_as_text(self, path: str) -> None:
        """The iteration grid as text (Fractal::SaveItersAsText)."""
        np.savetxt(path, self.iters_numpy(), fmt="%d")

    def render_to_console(self, max_width: int = 100,
                          ansi: bool = True) -> str:
        """An ASCII or ANSI console render of a fresh grid (the reference's
        RenderToConsole.cpp)."""
        iters = self.iters_numpy(self.calc_fractal())
        step = max(1, iters.shape[1] // max_width)
        small = iters[::step * 2, ::step]  # characters are ~2x tall
        n = self.num_iterations
        glyphs = " .:-=+*#%@"
        lines = []
        for row in small:
            if ansi:
                lines.append("".join(
                    "\x1b[40m \x1b[0m" if v >= n
                    else f"\x1b[4{int(v) % 6 + 1}m \x1b[0m" for v in row))
            else:
                lines.append("".join(
                    glyphs[min(int(v) * (len(glyphs) - 1) // max(1, n),
                               len(glyphs) - 1)] if v < n else " "
                    for v in row))
        return "\n".join(lines)
