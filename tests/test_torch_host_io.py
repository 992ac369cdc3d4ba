"""The port's host I/O without OpenCV or PIL, with cv2 as the oracle: the PNG
reader and writer (`utils/png.py`), the JET colormap and the 2D panel
(`utils/vis.py`), the FileStorage XML reader and writer
(`utils/filestorage.py`), the exact 0.5x downscale and `read_images`
(`utils/image.py`)."""
import struct
import sys
import zlib

import numpy as np
import pytest

from s2m2_torch.utils import vis as V
from s2m2_torch.utils.filestorage import read_filestorage, write_filestorage
from s2m2_torch.utils.image import downscale_half, read_images
from s2m2_torch.utils.png import read_png, write_png

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

SIZES = [(1, 1), (5, 3), (13, 17), (37, 54)]


def _cv2_rgb(path):
    return cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1]


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode(path, raw, ctype, depth, filters, interlace=0):
    """A PNG of the unfiltered scanline bytes `raw` (h, rowbytes), each row
    filtered with its entry of `filters` (0 None .. 4 Paeth)."""
    h, rowbytes = raw.shape
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    bpp = max(1, ch * depth // 8)
    x = raw.astype(np.int32)
    out = []
    for y in range(h):
        cur = x[y]
        up = x[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        pred = [0, left, up, (left + up) >> 1, _paeth(left, up, upleft)][filters[y]]
        out.append(bytes([filters[y]]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    w = rowbytes // bpp if depth >= 8 else rowbytes * 8 // depth
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype,depth", [(0, 8), (2, 8), (4, 8), (6, 8), (2, 16), (6, 16),
                                         (0, 16)])
@pytest.mark.parametrize("filt", ["none", "sub", "up", "average", "paeth", "mixed"])
def test_png_filters_equal_cv2(tmp_path, ctype, depth, filt):
    """Every row filter (all rows one type, or a random type a row) at each
    colour type and depth, on an odd-sized smooth image."""
    g = np.random.default_rng(depth * 10 + ctype)
    h, w = 19, 23
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    smooth = np.cumsum(g.integers(0, 9, (h, w, ch)), axis=1) * (257 if depth == 16 else 1)
    samples = (smooth % (1 << depth)).astype(">u2" if depth == 16 else np.uint8)
    raw = np.frombuffer(samples.tobytes(), np.uint8).reshape(h, -1)
    names = ["none", "sub", "up", "average", "paeth"]
    filters = (g.integers(0, 5, h) if filt == "mixed" else np.full(h, names.index(filt)))
    path = tmp_path / "f.png"
    _encode(path, raw, ctype, depth, filters)
    np.testing.assert_array_equal(read_png(path), _cv2_rgb(path))


@pytest.mark.parametrize("h,w", SIZES)
def test_png_equals_cv2_on_cv2_and_pil_files(tmp_path, h, w):
    """Files cv2 and PIL write: gray, gray + alpha, RGB, RGBA, palette at 1,
    2, 4 and 8 bits (with and without transparency), 16-bit gray, RGB and
    RGBA, at odd and even sizes."""
    g = np.random.default_rng(h * 100 + w)
    files = {}
    for name, img in (("gray", g.integers(0, 256, (h, w), dtype=np.uint8)),
                      ("bgr", g.integers(0, 256, (h, w, 3), dtype=np.uint8)),
                      ("bgra", g.integers(0, 256, (h, w, 4), dtype=np.uint8)),
                      ("gray16", g.integers(0, 65536, (h, w), dtype=np.uint16)),
                      ("bgr16", g.integers(0, 65536, (h, w, 3), dtype=np.uint16)),
                      ("bgra16", g.integers(0, 65536, (h, w, 4), dtype=np.uint16))):
        files[f"cv2_{name}"] = tmp_path / f"cv2_{name}.png"
        assert cv2.imwrite(str(files[f"cv2_{name}"]), img)
    for mode, shape in (("L", (h, w)), ("LA", (h, w, 2)), ("RGB", (h, w, 3)),
                        ("RGBA", (h, w, 4))):
        files[f"pil_{mode}"] = tmp_path / f"pil_{mode}.png"
        Image.fromarray(g.integers(0, 256, shape, dtype=np.uint8), mode).save(
            files[f"pil_{mode}"])
    files["pil_I16"] = tmp_path / "pil_I16.png"
    Image.fromarray(g.integers(0, 65536, (h, w), dtype=np.uint16)).save(files["pil_I16"])
    for ncol in (2, 4, 16, 200):
        pal = Image.fromarray(g.integers(0, ncol, (h, w)).astype(np.uint8), "P")
        pal.putpalette(list(g.integers(0, 256, 3 * ncol)))
        for transparency in (None, 0):
            files[f"pil_P{ncol}_{transparency}"] = path = tmp_path / f"p{ncol}_{transparency}.png"
            pal.save(path, **({} if transparency is None else {"transparency": 0}))
    for name, path in files.items():
        got = read_png(path)
        assert got.dtype == np.uint8 and got.shape == (h, w, 3), name
        np.testing.assert_array_equal(got, _cv2_rgb(path), err_msg=name)


def test_png_unsupported_raises(tmp_path):
    raw = np.zeros((4, 12), np.uint8)
    path = tmp_path / "interlaced.png"
    _encode(path, raw, 2, 8, [0] * 4, interlace=1)
    with pytest.raises(ValueError, match="interlaced.png.*interlaced"):
        read_png(path)
    path = tmp_path / "gray1.png"
    _encode(path, np.zeros((4, 1), np.uint8), 0, 1, [0] * 4)
    with pytest.raises(ValueError, match="gray1.png.*bit depth 1"):
        read_png(path)
    (tmp_path / "not.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(tmp_path / "not.png")


@pytest.mark.parametrize("h,w", SIZES)
def test_png_writer_round_trips(tmp_path, h, w):
    g = np.random.default_rng(w)
    rgb = g.integers(0, 256, (h, w, 3), dtype=np.uint8)
    gray = g.integers(0, 256, (h, w), dtype=np.uint8)
    write_png(tmp_path / "rgb.png", rgb)
    write_png(tmp_path / "gray.png", gray)
    np.testing.assert_array_equal(read_png(tmp_path / "rgb.png"), rgb)
    np.testing.assert_array_equal(_cv2_rgb(tmp_path / "rgb.png"), rgb)
    np.testing.assert_array_equal(read_png(tmp_path / "gray.png"), np.stack([gray] * 3, -1))
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "gray.png"), cv2.IMREAD_UNCHANGED),
                                  gray)
    with pytest.raises(ValueError, match="uint8"):
        write_png(tmp_path / "bad.png", rgb.astype(np.float32))


def test_jet_equals_cv2():
    levels = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(V.JET, cv2.applyColorMap(levels[:, None],
                                                           cv2.COLORMAP_JET)[:, 0])
    g = np.random.default_rng(3)
    disp = g.uniform(0, 60, (31, 45)).astype(np.float32)
    norm = (np.clip(disp / disp.max(), 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(V.apply_colormap(disp),
                                  cv2.applyColorMap(norm, cv2.COLORMAP_JET))


def test_panel_equals_cv2():
    g = np.random.default_rng(4)
    left = g.integers(0, 256, (20, 28, 3), dtype=np.uint8)
    disp = g.uniform(0, 30, (20, 28)).astype(np.float32)
    occ, conf = g.uniform(0, 1, (2, 20, 28)).astype(np.float32)
    mask = (conf > 0.1) & (occ > 0.5)
    want = np.hstack([cv2.cvtColor(left, cv2.COLOR_RGB2BGR),
                      V.apply_colormap(np.where(mask, disp, 0)),
                      cv2.cvtColor((np.clip(conf, 0, 1) * 255).astype(np.uint8),
                                   cv2.COLOR_GRAY2BGR)])
    np.testing.assert_array_equal(V.render_results_2d(left, disp, occ, conf), want)


def test_filestorage_reader_equals_cv2(tmp_path):
    """The named matrices and numbers equal cv2's; a node not asked for is
    not parsed, and one asked for that is neither raises."""
    g = np.random.default_rng(5)
    nodes = {"proj_matL": np.array([[1234.5678, 0, 640.25], [0, 1234.5678, 480.125],
                                    [0, 0, 1]]),
             "f32": g.standard_normal((3, 4)).astype(np.float32),
             "i32": g.integers(-1000, 1000, (2, 5)).astype(np.int32),
             "u8c3": g.integers(0, 256, (2, 3, 3), dtype=np.uint8),
             "dist": g.standard_normal(5),
             "baselineLR": 0.1234567890123, "ndisp": 192}
    path = str(tmp_path / "cv2.xml")
    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_WRITE)
    for k, v in nodes.items():
        fs.write(k, v)
    fs.write("name", "booster")
    fs.startWriteStruct("imageSize", cv2.FileNode_SEQ)
    for v in (2432, 2048):
        fs.write("", v)
    fs.endWriteStruct()
    fs.release()
    got = read_filestorage(path, list(nodes) + ["absent"])
    assert sorted(got) == sorted(nodes)
    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
    for k in ("proj_matL", "f32", "i32", "u8c3", "dist"):
        want = fs.getNode(k).mat()
        assert got[k].dtype == want.dtype, k
        np.testing.assert_array_equal(got[k], want, err_msg=k)
    for k in ("baselineLR", "ndisp"):
        assert got[k] == fs.getNode(k).real(), k
    fs.release()
    for k in ("name", "imageSize"):
        with pytest.raises(ValueError, match=f"{k}: neither a matrix nor a number"):
            read_filestorage(path, ["proj_matL", k])


def test_filestorage_writer_read_by_cv2(tmp_path):
    g = np.random.default_rng(6)
    nodes = {"proj_matL": g.standard_normal((3, 3)) * 1000,
             "f32": g.standard_normal((2, 2)).astype(np.float32),
             "i32": g.integers(-9, 9, (1, 4)).astype(np.int32),
             "baselineLR": 120.000000001, "count": 7}
    path = str(tmp_path / "ours.xml")
    write_filestorage(path, nodes)
    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
    for k in ("proj_matL", "f32", "i32"):
        np.testing.assert_array_equal(fs.getNode(k).mat(), nodes[k], err_msg=k)
    assert fs.getNode("baselineLR").real() == nodes["baselineLR"]
    assert fs.getNode("count").real() == 7
    fs.release()
    back = read_filestorage(path, nodes)
    for k in ("proj_matL", "f32", "i32"):
        np.testing.assert_array_equal(back[k], nodes[k])
    assert back["baselineLR"] == nodes["baselineLR"]


@pytest.mark.parametrize("h,w,c", [(1024, 1216, 3), (2048, 2432, 3), (1023, 1217, 3),
                                   (777, 1001, 3), (5, 7, 3), (6, 9, None), (3, 2, 4),
                                   (2, 3, 1), (11, 13, 3)])
def test_downscale_half_equals_cv2(h, w, c):
    g = np.random.default_rng(h * w)
    img = g.integers(0, 256, (h, w) if c is None else (h, w, c), dtype=np.uint8)
    want = cv2.resize(img, (0, 0), fx=0.5, fy=0.5)
    got = downscale_half(img)
    assert got.size == want.size and got.dtype == np.uint8
    np.testing.assert_array_equal(got.reshape(want.shape), want)  # cv2 drops a single channel


def test_read_images(tmp_path, monkeypatch):
    """PNGs need neither cv2 nor PIL; another extension goes through cv2 and,
    with cv2 and PIL blocked, raises naming the extension."""
    g = np.random.default_rng(7)
    left = g.integers(0, 256, (9, 14, 3), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "l.png"), left[..., ::-1])
    cv2.imwrite(str(tmp_path / "l.bmp"), left[..., ::-1])
    got = read_images(tmp_path / "l.png", tmp_path / "l.bmp")
    np.testing.assert_array_equal(got[0], left)
    np.testing.assert_array_equal(got[1], left)
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(read_images(tmp_path / "l.png", tmp_path / "l.png")[0], left)
    with pytest.raises(ImportError, match=r"\.bmp image needs cv2 or PIL"):
        read_images(tmp_path / "l.png", tmp_path / "l.bmp")


def test_window_helpers_name_cv2_when_missing(monkeypatch):
    from s2m2_torch.calibration.visualize import show_calibration_comparison
    monkeypatch.setitem(sys.modules, "cv2", None)
    img = np.zeros((8, 8, 3), np.uint8)
    for call in (lambda: V.show_results_2d(img, img[..., 0], img[..., 0], img[..., 0]),
                 lambda: V.draw_epipolar_lines(img, img),
                 lambda: show_calibration_comparison(None, img, img, img, img)):
        with pytest.raises(ImportError, match=r"OpenCV \(cv2\)"):
            call()
