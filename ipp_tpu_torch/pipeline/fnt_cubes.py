"""FNT cube deconvolution on one GPU (port of ipp_tpu/pipeline/fnt_cubes.py:
process_cubes, build_parser, main — the fnt_cube_processor equivalent).

Every `.nrrd` cube under the input directory is read on the host (the
port's copy of the NRRD codec, `io/nrrd.py`), uploaded, optionally background-
subtracted (a number, or 'auto': the cube's 1st percentile), divided by
the contrast factor, gaussian-filtered, axially destriped (`--destripe`:
rot90 on (y, x), `filter_streaks` db9 sigma 1 bidirectional through the
DWT kernel K5, rot90 back; or a plain per-plane `--destripe-sigma`),
and deconvolved with `richardson_lucy` (the route its work shape picks);
with a gaussian and `-dgi N` the RL runs in N-iteration chunks with the
gaussian between them.  The PSF comes from the optics model sampled at
the cube's pitch (`--doubled_psf` stacks it twice along z), or from
`--psf-file`.  Results are rounded and clipped to an integer input dtype
and written with the input's space header; `--resume` skips cubes whose
output exists.  One cube's result streams back while the next is read
and processed (`utils.lagged.OneInFlight`).

The reference's persistent XLA compile cache has no counterpart here:
PyTorch runs eagerly and the kernels build once per process.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..io.nrrd import read_nrrd, write_nrrd
from ..ops.deconv import fft_shape_for, gauss3d, richardson_lucy
from ..ops.destripe import filter_streaks
from ..ops.psf import make_psf
from ..utils.device import resolve_device
from ..utils.lagged import OneInFlight
from ..utils.log import Logger
from ..utils.progress import ProgressReporter
from ..utils.transfer import HostArray, upload

__all__ = ["process_cubes", "build_parser", "main"]


def _load_psf(psf_file: Path, voxel_um, na, refractive_index, lambda_ex,
              lambda_em, fcyl, slitwidth, doubled_psf: bool,
              log: Logger) -> np.ndarray:
    """The (z, y, x) PSF: from `psf_file` (.npy or a multi-page TIFF), or
    from the optics model at the cube's own pitch."""
    if psf_file is not None:
        p = Path(psf_file)
        if p.suffix == ".npy":
            psf = np.load(p)
        else:
            from ..io.tiff import read_tiff_stack

            psf = read_tiff_stack(p)
        psf = np.asarray(psf, np.float32)
        psf /= psf.sum()
        log.info(f"custom PSF {psf.shape} from {p}")
        return psf
    # sampled at the data pitch: RL convolves the PSF on the data grid
    # (fnt_cube_processor.py:201-222 passes dxpsf apart from dxdata)
    psf, fwhm_xy, fwhm_z = make_psf(
        dxy=voxel_um[1] * 1000.0, dz=voxel_um[0] * 1000.0, NA=na,
        n=refractive_index, lambda_ex=lambda_ex, lambda_em=lambda_em,
        fcyl=fcyl, slitwidth=slitwidth, sample_at_data_pitch=True)
    psf = np.transpose(psf, (2, 1, 0))
    if doubled_psf:
        # the camera doubling artifact: the PSF twice along z, renormalised
        # (psf_generator.py:186-195)
        psf = np.concatenate([psf, psf], axis=0)
        psf /= psf.sum()
    log.info(f"PSF {psf.shape}, FWHM xy {fwhm_xy:.0f} nm z {fwhm_z:.0f} nm")
    return psf


def process_cubes(
    input_dir,
    output_dir,
    voxel_um: Tuple[float, float, float] = (1.0, 0.4, 0.4),
    na: float = 0.4,
    refractive_index: float = 1.42,
    lambda_ex: float = 488.0,
    lambda_em: float = 525.0,
    fcyl: float = 80000.0,
    slitwidth: float = 12000.0,
    niter: int = 10,
    destripe_sigma: float = 0.0,
    axial_destripe: bool = False,
    dark: Union[float, str] = 0.0,
    gaussian_sigma: float = 0.0,
    dg_iteration: int = 0,
    contrast_enhancement_factor: float = 1.0,
    deconvolve: bool = True,
    psf_file: Optional[Path] = None,
    doubled_psf: bool = False,
    resume: bool = False,
    log: Optional[Logger] = None,
    device=None,
) -> int:
    """Process every cube; returns the number written in this run."""
    dev = resolve_device(device)
    log = log or Logger()
    input_dir = Path(input_dir)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    cubes = sorted(input_dir.rglob("*.nrrd"))
    if not cubes:
        raise FileNotFoundError(f"no .nrrd cubes under {input_dir}")
    psf = None
    if deconvolve:
        psf = torch.from_numpy(np.ascontiguousarray(_load_psf(
            psf_file, voxel_um, na, refractive_index, lambda_ex, lambda_em,
            fcyl, slitwidth, doubled_psf, log), np.float32)).to(dev)
    prog = ProgressReporter(len(cubes), desc="cubes")
    done = 0
    lag = OneInFlight()   # cube k streams back while cube k+1 runs

    def finalize(item):
        nonlocal done
        out_path, header, in_dtype, dec = item
        dec = np.asarray(dec)
        if np.issubdtype(in_dtype, np.integer):
            info = np.iinfo(in_dtype)
            dec = np.clip(np.rint(dec), info.min, info.max)
        write_nrrd(out_path, dec.astype(in_dtype), extra_header={
            k: v for k, v in header.items()
            if k in ("space", "space directions", "space origin")})
        done += 1
        prog.step()

    for cube_path in cubes:
        out_path = output_dir / cube_path.relative_to(input_dir)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        if resume and out_path.exists():
            prog.step()
            continue
        vol, header = read_nrrd(cube_path)
        in_dtype = vol.dtype
        x = upload(vol, dev).to(torch.float32)
        dark_val = dark
        if isinstance(dark, str):   # 'auto': the cube's low end
            dark_val = float(np.percentile(vol, 1.0))
        if dark_val and dark_val > 0:
            x = torch.clamp(x - dark_val, min=0.0)
        if contrast_enhancement_factor and contrast_enhancement_factor != 1:
            x = x / contrast_enhancement_factor
        if gaussian_sigma > 0:
            x = gauss3d(x, gaussian_sigma)
        if axial_destripe:
            # rot90 on (y, x), per-plane db9 sigma (1, 1) bidirectional,
            # rot90 back (fnt_cube_processor.py:245-251)
            xr = torch.rot90(x, 1, (1, 2)).contiguous()
            xr = filter_streaks(xr, sigma=(1.0, 1.0), wavelet="db9",
                                bidirectional=True)
            x = torch.rot90(xr, -1, (1, 2)).contiguous()
        elif destripe_sigma > 0:
            x = filter_streaks(x, sigma=(destripe_sigma,) * 2)
        dec = x
        if deconvolve:
            fft_shape = fft_shape_for(x.shape, psf.shape, dev)
            if gaussian_sigma > 0 and 0 < dg_iteration < niter:
                # dg_iteration-long RL chunks with the user's gaussian
                # between them (fnt_cube_processor.py:202-251)
                remaining = niter
                while remaining > 0:
                    step_n = min(dg_iteration, remaining)
                    dec = richardson_lucy(dec, psf, niter=step_n,
                                          fft_shape=fft_shape)
                    remaining -= step_n
                    if remaining > 0:
                        dec = gauss3d(dec, gaussian_sigma)
            else:
                dec = richardson_lucy(x, psf, niter=niter,
                                      fft_shape=fft_shape)
        out = HostArray(dec.contiguous())
        prev = lag.put((out_path, header, in_dtype, out), out)
        if prev is not None:
            finalize(prev)
    for item in lag.flush():
        finalize(item)
    prog.close()
    return done


def build_parser() -> argparse.ArgumentParser:
    """The reference's flag set (ipp_tpu/pipeline/fnt_cubes.py
    build_parser)."""
    p = argparse.ArgumentParser(description="deconvolve FNT .nrrd cubes")
    p.add_argument("--input", "-i", required=True, type=Path)
    p.add_argument("--output", "-o", required=True, type=Path)
    p.add_argument("--voxel", type=float, nargs=3, default=(1.0, 0.4, 0.4),
                   metavar=("Z", "Y", "X"))
    p.add_argument("--dxy", "-dxy", type=float, default=None,
                   help="xy pitch in um (reference flag; overrides "
                        "--voxel y/x)")
    p.add_argument("--dz", "-dz", type=float, default=None,
                   help="z pitch in um (reference flag)")
    p.add_argument("--na", "-na", type=float, default=0.4)
    p.add_argument("--nimm", "-im", "--rf", dest="nimm", type=float,
                   default=1.42, help="immersion refractive index")
    p.add_argument("--wavelength-ex", "--wavelength_ex", "-ex", type=float,
                   default=488.0)
    p.add_argument("--wavelength-em", "--wavelength_em", "-em", type=float,
                   default=525.0)
    p.add_argument("--f-cylinder-lens", "--f_cylinder_lens", "-fc",
                   type=float, default=80000.0)
    p.add_argument("--slit-width", "--slit_width", "-dw", type=float,
                   default=12000.0)
    p.add_argument("--niter", "--n_iters", "-it", dest="niter", type=int,
                   default=10)
    p.add_argument("--dark", "--background", "-b", dest="dark",
                   default="0",
                   help="background to subtract (number, or 'auto')")
    p.add_argument("--gaussian", "-g", type=float, default=0.0,
                   help="3D gaussian sigma; 0 disables")
    p.add_argument("--dg-iteration", "--dg_interation", "-dgi",
                   dest="dg_iteration", type=int, default=0,
                   help="re-apply the gaussian every N RL iterations")
    p.add_argument("--contrast-enhancement-factor",
                   "--contrast_enhancement_factor", "-cef", type=float,
                   default=1.0)
    p.add_argument("--destripe", "-ds", default=False,
                   action=argparse.BooleanOptionalAction,
                   help="axial destripe (rot90 + db9 sigma 1, the "
                        "reference semantics; fnt_cube_processor.py:335)")
    p.add_argument("--destripe-sigma", type=float, default=0.0,
                   help="plain per-plane destripe at this sigma")
    p.add_argument("--deconvolution", "-d", default=True,
                   action=argparse.BooleanOptionalAction,
                   help="apply deconvolution (reference flag surface: "
                        "--deconvolution / --no-deconvolution, "
                        "fnt_cube_processor.py:337)")
    p.add_argument("--psf-file", type=Path, default=None,
                   help="custom PSF volume (.npy or multi-page .tif)")
    p.add_argument("--doubled_psf", "-dpsf", default=False,
                   action=argparse.BooleanOptionalAction,
                   help="z-doubled PSF for the camera doubling artifact "
                        "(reference fnt_cube_processor.py:385, "
                        "psf_generator.py:186-195)")
    p.add_argument("--resume", action="store_true")
    # accepted for reference compatibility and ignored: cubes stream
    # through one device with a lagged fetch instead of a GPU worker
    # pool (fnt_cube_processor.py:227-388)
    p.add_argument("--num_processes", "-n", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--threads_per_gpu", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--exclude_gpus", nargs="+", default=None,
                   help=argparse.SUPPRESS)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    voxel = list(args.voxel)
    if args.dz is not None:
        voxel[0] = args.dz
    if args.dxy is not None:
        voxel[1] = voxel[2] = args.dxy
    dark: Union[float, str] = args.dark
    if isinstance(dark, str) and dark.lower() != "auto":
        dark = float(dark)
    process_cubes(
        args.input, args.output, tuple(voxel), na=args.na,
        refractive_index=args.nimm, lambda_ex=args.wavelength_ex,
        lambda_em=args.wavelength_em, fcyl=args.f_cylinder_lens,
        slitwidth=args.slit_width, niter=args.niter, dark=dark,
        gaussian_sigma=args.gaussian, dg_iteration=args.dg_iteration,
        contrast_enhancement_factor=args.contrast_enhancement_factor,
        axial_destripe=args.destripe,
        destripe_sigma=args.destripe_sigma,
        deconvolve=args.deconvolution,
        psf_file=args.psf_file, doubled_psf=args.doubled_psf,
        resume=args.resume)
    return 0


if __name__ == "__main__":
    sys.exit(main())
