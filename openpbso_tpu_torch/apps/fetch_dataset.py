"""fetch_dataset — manifest-driven dataset staging + meta generation.

The port's copy of openpbso_tpu/apps/fetch_dataset.py (it touches no
device), bound to the port's io/meta.py. Like it, the equivalent of the
reference's dataset tooling:

- ``scripts/download.py`` (reference): reads ``ran_obj_mat.txt`` lines of
  ``<remote_path> <material>``, stages one ``<ID>_tetmesh`` directory per
  model (scp of ``<ID>_tetmesh.tet.obj``, ``modal_models/<mat>/
  <ID>_tetmesh_surf.modes``, ``radiation_models/<mat>/ffat_map-fdtd``) and
  copies ``materials/<mat>.txt`` in.
- ``scripts/prepare_meta.sh`` (reference): scans staged dirs and writes a
  4-line ``.meta`` descriptor per model whose FFAT dir is non-empty.

This tool does both in one pass. Sources are local directories by default
(a mounted dataset, an rsync'd mirror); ``scp:`` / ``http(s):`` sources
shell out to scp/curl and fail with a clear message on egress-less hosts.

    python -m openpbso_tpu_torch.apps.fetch_dataset \
        --manifest ran_obj_mat.txt --source /data/mirror \
        --materials-dir /data/mirror/materials \
        --out-root /data/10k --meta-dir assets/meta/10k
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys

from ..io.meta import ModelPaths, write_meta


def parse_manifest(path: str) -> list[tuple[str, str, str]]:
    """Manifest lines ``<path> <material>`` -> (id, path, material).

    The model ID is the last path component (reference scripts/download.py:
    ``ID = tokens[0].split('/')[-1]``). Blank lines and ``#`` comments are
    skipped.
    """
    out = []
    with open(path) as f:
        for ln in f:
            ln = ln.strip()
            if not ln or ln.startswith("#"):
                continue
            tokens = ln.split()
            if len(tokens) < 2:
                raise ValueError(f"manifest line needs '<path> <material>': "
                                 f"{ln!r}")
            model_path, mat = tokens[0], tokens[1]
            out.append((model_path.rstrip("/").rsplit("/", 1)[-1],
                        model_path, mat))
    return out


def _fetch(src: str, dst: str, is_dir: bool = False) -> None:
    """Copy one file/dir from a local path, scp: or http(s): source.

    Atomic at ``dst``: everything stages into ``dst + '.part'`` and is
    renamed on success, so an interrupted fetch never leaves a
    partial file/dir that a later skip_existing run would treat as
    complete (and that write_dataset_meta would index)."""
    part = dst + ".part"
    if os.path.isdir(part):
        shutil.rmtree(part)
    elif os.path.exists(part):
        os.remove(part)
    if src.startswith("scp:"):
        cmd = ["scp"] + (["-r"] if is_dir else []) + [src[4:], part]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"scp failed (no egress on this host?): "
                               f"{' '.join(cmd)}: {r.stderr.strip()}")
    elif src.startswith(("http://", "https://")):
        if is_dir:
            raise RuntimeError("http sources cannot fetch directories; "
                               "point --source at a mirror or archive")
        r = subprocess.run(["curl", "-fsSL", "-o", part, src],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"curl failed (no egress on this host?): "
                               f"{src}: {r.stderr.strip()}")
    elif is_dir:
        shutil.copytree(src, part)
    else:
        shutil.copy2(src, part)
    if os.path.isdir(dst):
        shutil.rmtree(dst)
    elif os.path.exists(dst):
        os.remove(dst)
    os.rename(part, dst)   # dst was removed above; rename covers both


def stage_model(source_root: str, model_path: str, model_id: str, mat: str,
                materials_dir: str, out_root: str,
                skip_existing: bool = True) -> str:
    """Stage one model into ``<out_root>/<ID>_tetmesh/`` (reference layout).

    Files staged (scripts/download.py commands, with the reference's
    remote-tree layout under ``model_path``):
      ``<ID>_tetmesh.tet.obj``
      ``<ID>_tetmesh_surf.modes``   (from modal_models/<mat>/)
      ``ffat_map-fdtd/``            (from radiation_models/<mat>/)
      ``<mat>.txt``                 (from the materials dir)
    Returns the staged directory.
    """
    name = f"{model_id}_tetmesh"
    outdir = os.path.join(out_root, name)
    join = lambda *p: "/".join(p)  # noqa: E731 — sources may be scp:/http:
    src_base = (join(source_root, model_path) if source_root
                else model_path)
    os.makedirs(outdir, exist_ok=True)
    jobs = [
        (join(src_base, f"{name}.tet.obj"),
         os.path.join(outdir, f"{name}.tet.obj"), False),
        (join(src_base, "modal_models", mat, f"{name}_surf.modes"),
         os.path.join(outdir, f"{name}_surf.modes"), False),
        (join(src_base, "radiation_models", mat, "ffat_map-fdtd"),
         os.path.join(outdir, "ffat_map-fdtd"), True),
        (join(materials_dir, f"{mat}.txt"),
         os.path.join(outdir, f"{mat}.txt"), False),
    ]
    for src, dst, is_dir in jobs:
        if skip_existing and os.path.exists(dst):
            continue
        _fetch(src, dst, is_dir=is_dir)
    return outdir


def write_dataset_meta(out_root: str, meta_dir: str) -> list[str]:
    """prepare_meta.sh parity: one 4-line .meta per staged model whose
    ffat_map-fdtd dir is non-empty (the shell script's emptiness guard)."""
    os.makedirs(meta_dir, exist_ok=True)
    written = []
    for name in sorted(os.listdir(out_root)):
        d = os.path.join(out_root, name)
        if not os.path.isdir(d):
            continue
        ffat = os.path.join(d, "ffat_map-fdtd")
        if not os.path.isdir(ffat) or not os.listdir(ffat):
            continue
        mats = [f for f in sorted(os.listdir(d))
                if f.endswith(".txt") and f != "freq_threshold.txt"]
        if not mats:
            continue
        paths = ModelPaths(
            obj_file=os.path.join(d, f"{name}.tet.obj"),
            modes_file=os.path.join(d, f"{name}_surf.modes"),
            material_file=os.path.join(d, mats[0]),
            ffat_dir=ffat,
        )
        meta_path = os.path.join(meta_dir, f"{name}.meta")
        write_meta(meta_path, paths)
        written.append(meta_path)
    return written


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--manifest", required=True,
                   help="lines of '<model_path> <material>' "
                        "(ran_obj_mat.txt format)")
    p.add_argument("--source", default="",
                   help="root prepended to manifest paths: a local mirror "
                        "dir, 'scp:host:/data', or an http(s) base URL")
    p.add_argument("--materials-dir", required=True,
                   help="directory of <material>.txt files")
    p.add_argument("--out-root", required=True)
    p.add_argument("--meta-dir", default=None,
                   help="also write 4-line .meta descriptors here "
                        "(prepare_meta.sh)")
    p.add_argument("--force", action="store_true",
                   help="re-fetch files that already exist")
    args = p.parse_args(argv)
    entries = parse_manifest(args.manifest)
    os.makedirs(args.out_root, exist_ok=True)
    staged = 0
    for model_id, model_path, mat in entries:
        try:
            outdir = stage_model(args.source, model_path, model_id, mat,
                                 args.materials_dir, args.out_root,
                                 skip_existing=not args.force)
            print(f"staged {outdir}")
            staged += 1
        except (OSError, RuntimeError) as e:
            print(f"SKIP {model_id}: {e}", file=sys.stderr)
    if args.meta_dir:
        metas = write_dataset_meta(args.out_root, args.meta_dir)
        print(f"wrote {len(metas)} meta files to {args.meta_dir}")
    print(f"{staged}/{len(entries)} models staged")
    return 0 if staged == len(entries) else 1


if __name__ == "__main__":
    raise SystemExit(main())
