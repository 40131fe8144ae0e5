"""COLMAP workspaces (counterpart of mirres_restir_nerf_mesh_tpu/data/colmap.py):
the binary and text model readers, pose centring and scaling, the
sparse-depth tables and per-view near / far from the tracks, and the dense
depth maps aligned to them.

The readers return what the JAX package's return, bit for bit; the points'
records and the keypoints' point ids are gathered with numpy instead of a
loop a point.  ``align_dense_depth`` fits the scale and bias by RANSAC in
numpy (the reference calls scikit-learn's ``RANSACRegressor``, which the
card machine lacks).  Images load through the port's PNG / JPEG decoders.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Tuple

import numpy as np

from .provider import FrameData, _load_image, compute_mvps, resize_bilinear_aa


def _read_next_bytes(f, num_bytes, fmt, endian="<"):
    return struct.unpack(endian + fmt, f.read(num_bytes))


# parameters of each camera model id (SIMPLE_PINHOLE ... THIN_PRISM_FISHEYE)
_MODEL_PARAMS = {0: 3, 1: 4, 2: 4, 3: 5, 4: 8, 5: 8, 6: 12, 7: 5, 8: 4, 9: 5, 10: 12}
_MODEL_IDS = {
    "SIMPLE_PINHOLE": 0, "PINHOLE": 1, "SIMPLE_RADIAL": 2, "RADIAL": 3,
    "OPENCV": 4, "OPENCV_FISHEYE": 5, "FULL_OPENCV": 6, "FOV": 7,
    "SIMPLE_RADIAL_FISHEYE": 8, "RADIAL_FISHEYE": 9, "THIN_PRISM_FISHEYE": 10,
}


def read_cameras_binary(path: str) -> Dict[int, dict]:
    """cameras.bin: id -> {model, width, height, params}."""
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read_next_bytes(f, 8, "Q")
        for _ in range(n):
            cid, model, w, h = _read_next_bytes(f, 24, "iiQQ")
            k = _MODEL_PARAMS[model]
            cams[cid] = dict(model=model, width=w, height=h,
                             params=np.array(_read_next_bytes(f, 8 * k, "d" * k)))
    return cams


def read_images_binary(path: str) -> Dict[int, dict]:
    """images.bin: id -> {qvec, tvec, camera_id, name, xys [M, 2],
    point3D_ids [M] (-1: untracked)}."""
    images = {}
    with open(path, "rb") as f:
        (n,) = _read_next_bytes(f, 8, "Q")
        for _ in range(n):
            iid = _read_next_bytes(f, 4, "i")[0]
            qvec = np.array(_read_next_bytes(f, 32, "dddd"))
            tvec = np.array(_read_next_bytes(f, 24, "ddd"))
            cam_id = _read_next_bytes(f, 4, "i")[0]
            name = bytearray()
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (n2d,) = _read_next_bytes(f, 8, "Q")
            data = f.read(24 * n2d)
            images[iid] = dict(
                qvec=qvec, tvec=tvec, camera_id=cam_id, name=name.decode(),
                xys=np.frombuffer(data, np.float64).reshape(n2d, 3)[:, :2],
                point3D_ids=np.frombuffer(data, np.int64).reshape(n2d, 3)[:, 2])
    return images


def read_points3d_binary(path: str) -> Tuple[np.ndarray, np.ndarray, Dict[int, int]]:
    """points3D.bin -> (xyz [P, 3] float32, err [P] float32, id -> row).

    A record is id (u64), xyz (3 f64), rgb (3 u8), error (f64), track
    length (u64) and the track (8 bytes an entry); only the walk over the
    track lengths is a loop, the fields are gathered at the record starts."""
    with open(path, "rb") as f:
        buf = f.read()
    (n,) = struct.unpack_from("<Q", buf, 0)
    starts = np.empty(n, np.int64)
    off, unpack = 8, struct.Struct("<Q").unpack_from
    for i in range(n):
        starts[i] = off
        off += 51 + 8 * unpack(buf, off + 43)[0]
    raw = np.frombuffer(buf, np.uint8)

    def field(at, size, dtype):
        idx = starts[:, None] + at + np.arange(size)
        return np.ascontiguousarray(raw[idx]).view(dtype)

    pids = field(0, 8, "<u8")[:, 0]
    xyz = field(8, 24, "<f8").astype(np.float32).reshape(n, 3)
    err = field(35, 8, "<f8")[:, 0].astype(np.float32)
    return xyz, err, dict(zip(pids.tolist(), range(n)))


def _text_lines(path: str):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path: str) -> Dict[int, dict]:
    """cameras.txt: ``CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]`` a line."""
    cams = {}
    for line in _text_lines(path):
        el = line.split()
        cams[int(el[0])] = dict(model=_MODEL_IDS[el[1]], width=int(el[2]), height=int(el[3]),
                                params=np.array([float(x) for x in el[4:]]))
    return cams


def read_images_text(path: str) -> Dict[int, dict]:
    """images.txt: two lines an image, ``IMAGE_ID QW QX QY QZ TX TY TZ
    CAMERA_ID NAME`` then ``X Y POINT3D_ID ...``.  The second line is read
    whatever it holds: an image with no keypoints has an empty one, which
    a blank-skipping reader would take the next image's header for."""
    images = {}
    with open(path) as f:
        it = iter(f)
        for line in it:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            el = line.split()
            xys = np.array([float(x) for x in next(it, "").split()], np.float64).reshape(-1, 3)
            images[int(el[0])] = dict(
                qvec=np.array([float(x) for x in el[1:5]]),
                tvec=np.array([float(x) for x in el[5:8]]), camera_id=int(el[8]), name=el[9],
                xys=xys[:, :2], point3D_ids=xys[:, 2].astype(np.int64))
    return images


def read_points3d_text(path: str) -> Tuple[np.ndarray, np.ndarray, Dict[int, int]]:
    """points3D.txt: ``POINT3D_ID X Y Z R G B ERROR TRACK[]`` -> (xyz [P, 3],
    err [P], id -> row)."""
    xyzs, errs, id_map = [], [], {}
    for i, line in enumerate(_text_lines(path)):
        el = line.split()
        id_map[int(el[0])] = i
        xyzs.append([float(el[1]), float(el[2]), float(el[3])])
        errs.append(float(el[7]))
    return np.array(xyzs, np.float32).reshape(-1, 3), np.array(errs, np.float32), id_map


def _read_model_file(sparse: str, name: str, bin_reader, text_reader):
    """<name>.bin if it exists, else <name>.txt."""
    bp = os.path.join(sparse, name + ".bin")
    if os.path.exists(bp):
        return bin_reader(bp)
    return text_reader(os.path.join(sparse, name + ".txt"))


def _rows_of(id_map: Dict[int, int], pids: np.ndarray) -> np.ndarray:
    """The row of each point id (-1 where the model has no such point)."""
    if not id_map:
        return np.full(len(pids), -1, np.int64)
    keys = np.fromiter(id_map.keys(), np.int64, len(id_map))
    rows = np.fromiter(id_map.values(), np.int64, len(id_map))
    order = np.argsort(keys)
    keys, rows = keys[order], rows[order]
    at = np.clip(np.searchsorted(keys, pids), 0, len(keys) - 1)
    return np.where(keys[at] == pids, rows[at], -1)


def extract_sparse_depth(images_meta: Dict[int, dict], keys, poses: np.ndarray,
                         pts3d: np.ndarray, ptserr: np.ndarray, id_map: Dict[int, int],
                         H: int, W: int, downscale: int = 1):
    """Sparse depth of every tracked keypoint: depth = (camera origin -
    point) . camera z (OpenGL's backward z), weight = 2 exp(-(err /
    mean err)^2).  Returns tables padded to the longest view (coords
    [F, M, 2] int32 (row, col), depth [F, M], weight [F, M], weight 0 =
    padding) and cam_near_far [F, 2] (the views' least and largest depth;
    0.05 / 1e9 for a view without points)."""
    mean_err = max(float(np.mean(ptserr)) if len(ptserr) else 1.0, 1e-8)
    per_view = []
    for i, k in enumerate(keys):
        im = images_meta[k]
        xys, pids = im["xys"], im["point3D_ids"]
        rc = np.stack([xys[:, 1], xys[:, 0]], axis=-1)        # (x, y) -> (row, col)
        mask = pids != -1
        if not mask.any():
            per_view.append((np.zeros((0, 2), np.int32), np.zeros(0), np.zeros(0)))
            continue
        rc = np.round(rc[mask] / downscale).astype(np.int32)
        rc[:, 0] = rc[:, 0].clip(0, H - 1)
        rc[:, 1] = rc[:, 1].clip(0, W - 1)
        ids = _rows_of(id_map, pids[mask])
        ok = ids >= 0
        rc, ids = rc[ok], ids[ok]
        P = poses[i]
        depth = (P[:3, 3][None] - pts3d[ids]) @ P[:3, 2]
        good = depth > 0
        weight = 2.0 * np.exp(-((ptserr[ids] / mean_err) ** 2))
        per_view.append((rc[good], depth[good], weight[good]))

    F = len(keys)
    M = max(max((len(d) for _, d, _ in per_view), default=1), 1)
    coords = np.zeros((F, M, 2), np.int32)
    depth = np.zeros((F, M), np.float32)
    weight = np.zeros((F, M), np.float32)
    near_far = np.tile(np.array([[0.05, 1e9]], np.float32), (F, 1))
    for i, (rc, d, w) in enumerate(per_view):
        m = len(d)
        if m:
            coords[i, :m], depth[i, :m], weight[i, :m] = rc, d, w
            near_far[i] = [float(d.min()), float(d.max())]
    return coords, depth, weight, near_far


RANSAC_TRIALS = 100                 # scikit-learn's max_trials


def _weighted_line(x, y, w) -> Tuple[float, float]:
    """Weighted least-squares line with intercept (scale 0 where x is
    constant, as the minimum-norm solution gives)."""
    xm, ym = np.average(x, weights=w), np.average(y, weights=w)
    den = float(np.sum(w * (x - xm) ** 2))
    a = float(np.sum(w * (x - xm) * (y - ym))) / den if den > 0 else 0.0
    return a, float(ym - a * xm)


def ransac_line(x: np.ndarray, y: np.ndarray, w: np.ndarray) -> Tuple[float, float]:
    """scikit-learn's ``RANSACRegressor()`` on one feature, at its defaults:
    RANSAC_TRIALS minimal samples of 2 points (drawn without replacement
    from ``default_rng(0)``, the same for every view), the line through
    each (slope 0 through two points of one x), inliers within the median absolute
    deviation of y; the sample with the most inliers wins, ties going to
    the higher R^2 on its inliers (scikit-learn's r2_score; the later
    sample on an equal R^2); then a line fitted to its inliers with the
    weights.  All the trials run (scikit-learn stops early once the
    consensus is likely found)."""
    rng = np.random.default_rng(0)
    pairs = np.stack([rng.choice(len(y), 2, replace=False) for _ in range(RANSAC_TRIALS)])
    x0, x1, y0, y1 = x[pairs[:, 0]], x[pairs[:, 1]], y[pairs[:, 0]], y[pairs[:, 1]]
    w0, w1 = w[pairs[:, 0]], w[pairs[:, 1]]
    dx = x1 - x0
    a = np.where(dx != 0, (y1 - y0) / np.where(dx != 0, dx, 1.0), 0.0)
    b = np.where(dx != 0, y0 - a * x0, (w0 * y0 + w1 * y1) / (w0 + w1))
    resid = y[None] - (a[:, None] * x[None] + b[:, None])
    inl = np.abs(resid) <= np.median(np.abs(y - np.median(y)))
    cnt = inl.sum(axis=1)
    k = np.maximum(cnt, 1)
    ym = np.sum(np.where(inl, y[None], 0.0), axis=1) / k
    res = np.sum(np.where(inl, resid, 0.0) ** 2, axis=1)
    tot = np.sum(np.where(inl, y[None] - ym[:, None], 0.0) ** 2, axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        r2 = np.where(tot > 0, 1.0 - res / tot, np.where(res == 0, 1.0, 0.0))
    if cnt.max() == 0:
        raise ValueError("RANSAC found no consensus set")
    top = np.nonzero(cnt == cnt.max())[0]
    best = top[np.nonzero(r2[top] == r2[top].max())[0][-1]]
    m = inl[best]
    return _weighted_line(x[m], y[m], w[m])


def align_dense_depth(dense: np.ndarray, coords: np.ndarray, sdepth: np.ndarray,
                      sweight: np.ndarray) -> np.ndarray:
    """A monocular depth map scaled and shifted onto one view's sparse
    depths (``ransac_line``), with the reference's two fallbacks for a
    negative scale: the line through the two heaviest points, then the
    heaviest point's ratio through the origin."""
    m = sweight > 0
    X = dense[coords[m, 0], coords[m, 1]].astype(np.float64)
    Y = sdepth[m].astype(np.float64)
    Wt = sweight[m].astype(np.float64)
    if len(Y) < 2:
        return dense
    scale, bias = ransac_line(X, Y, Wt)
    if scale < 0:
        idx = np.argsort(Wt)[::-1]
        x0, y0 = X[idx[0]], Y[idx[0]]
        x1, y1 = X[idx[1]], Y[idx[1]]
        if abs(x0 - x1) > 1e-12:
            scale = (y0 - y1) / (x0 - x1)
            bias = y0 - x0 * scale
        if scale < 0 and abs(x0) > 1e-12:
            scale = y0 / x0
            bias = 0.0
    return (dense * scale + bias).astype(np.float32)


def qvec2rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
    ])


def load_colmap(root: str, split: str = "train", downscale: int = 1, scale: float = -1.0,
                offset=(0, 0, 0), bound: float = 2.0, enable_cam_center: bool = False,
                with_images: bool = True, test_every: int = 8) -> FrameData:
    """A COLMAP workspace (``sparse/0`` or ``colmap_sparse/0``, ``images/``,
    optionally ``depths/<name>.npy``) as FrameData.

    Views sort by name; ``train`` drops every ``test_every``-th, ``val`` and
    ``test`` keep only those.  Poses go from COLMAP's world-to-camera
    (y down) to OpenGL camera-to-world, centred on the sparse points'
    mean (the cameras' with ``enable_cam_center`` or no points) and scaled
    so the 90th-percentile camera distance is 0.75 bound (unless ``scale``
    is given), then offset.  The first view's camera gives the intrinsics
    (distortion ignored).  Outside ``test``, the sparse-depth tables and
    cam_near_far come from the tracks; dense maps under ``depths/`` are
    resized to the frame (antialiased bilinear) and aligned to each view's
    sparse depths (or scaled, without them)."""
    sparse = os.path.join(root, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(root, "colmap_sparse", "0")
    cams = _read_model_file(sparse, "cameras", read_cameras_binary, read_cameras_text)
    images_meta = _read_model_file(sparse, "images", read_images_binary, read_images_text)
    pts3d, ptserr, id_map = _read_model_file(sparse, "points3D", read_points3d_binary,
                                             read_points3d_text)

    keys = sorted(images_meta.keys(), key=lambda k: images_meta[k]["name"])
    if split == "train":
        keys = [k for i, k in enumerate(keys) if i % test_every != 0]
    elif split in ("val", "test"):
        keys = [k for i, k in enumerate(keys) if i % test_every == 0]

    poses = []
    for k in keys:
        w2c = np.eye(4)
        w2c[:3, :3] = qvec2rotmat(images_meta[k]["qvec"])
        w2c[:3, 3] = images_meta[k]["tvec"]
        c2w = np.linalg.inv(w2c)
        c2w[:3, 1:3] *= -1            # OpenCV (y down, z forward) -> OpenGL
        poses.append(c2w.astype(np.float32))
    poses = np.stack(poses)

    if enable_cam_center or len(pts3d) == 0:
        center = poses[:, :3, 3].mean(axis=0)
    else:
        center = pts3d.mean(axis=0)
    poses[:, :3, 3] -= center
    pts3d = pts3d - center
    if scale == -1.0:
        scale = 0.75 * bound / np.percentile(np.linalg.norm(poses[:, :3, 3], axis=1), 90)
    poses[:, :3, 3] = poses[:, :3, 3] * scale + np.asarray(offset)
    pts3d = pts3d * scale + np.asarray(offset)

    cam = cams[images_meta[keys[0]]["camera_id"]]
    p = cam["params"]
    if cam["model"] == 1:                     # PINHOLE
        fx, fy, cx, cy = p[0], p[1], p[2], p[3]
    else:                                     # SIMPLE_PINHOLE, and f, cx, cy of the rest
        fx = fy = p[0]
        cx, cy = p[1], p[2]
    intrinsics = np.array([fx, fy, cx, cy], np.float32) / downscale
    H = int(cam["height"]) // downscale
    W = int(cam["width"]) // downscale

    if with_images:
        img_dir = os.path.join(root, "images")
        images = np.stack([_load_image(os.path.join(img_dir, images_meta[k]["name"]), downscale)
                           for k in keys])
    else:
        images = np.zeros((len(keys), H, W, 3), np.float32)
    mvps = compute_mvps(poses, intrinsics, H, W, bound)

    sparse_coords = sparse_depth = sparse_weight = cam_near_far = None
    if split != "test" and len(pts3d) > 0:
        sparse_coords, sparse_depth, sparse_weight, cam_near_far = extract_sparse_depth(
            images_meta, keys, poses, pts3d, ptserr, id_map, H, W, downscale)

    depths = None
    ddir = os.path.join(root, "depths")
    if with_images and os.path.isdir(ddir):
        maps = []
        for i, k in enumerate(keys):
            pth = os.path.join(ddir, os.path.splitext(images_meta[k]["name"])[0] + ".npy")
            if not os.path.exists(pth):
                maps = []
                break
            dm = np.load(pth).astype(np.float32)
            if dm.shape != (H, W):
                dm = resize_bilinear_aa(dm[..., None], H, W)[..., 0]
            if sparse_coords is not None:
                dm = align_dense_depth(dm, sparse_coords[i], sparse_depth[i], sparse_weight[i])
            else:
                dm = dm * scale
            maps.append(dm)
        if maps:
            depths = np.stack(maps)

    return FrameData(images=images, poses=poses, intrinsics=intrinsics, H=H, W=W, mvps=mvps,
                     depths=depths, sparse_coords=sparse_coords, sparse_depth=sparse_depth,
                     sparse_weight=sparse_weight, cam_near_far=cam_near_far, pts3d=pts3d)


def per_view_near_far(fd: FrameData) -> np.ndarray:
    """[N, 2] near / far of each view from the sparse points in front of
    it: (half the 1st percentile depth, at least 0.05; twice the 99th)."""
    pts = fd.pts3d
    if pts is None or len(pts) == 0:
        return np.tile(np.array([[0.05, 1e9]], np.float32), (fd.num_frames, 1))
    out = []
    for p in fd.poses:
        z = -((pts - p[:3, 3]) @ p[:3, :3])[:, 2]
        z = z[z > 0]
        if len(z) == 0:
            out.append([0.05, 1e9])
        else:
            out.append([max(np.percentile(z, 1) * 0.5, 0.05), np.percentile(z, 99) * 2.0])
    return np.array(out, np.float32)
