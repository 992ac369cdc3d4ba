"""OpenCV FileStorage XML in the standard library and numpy, so that the
calibration files OpenCV writes (Booster's calib.xml, stereo calibrations)
read and write without OpenCV.

`read_filestorage(path, names)` returns the named top-level nodes of an
`<opencv_storage>` document: an `opencv-matrix` node (rows, cols, dt, data)
as a numpy array of its dtype, (rows, cols) or (rows, cols, channels), an
`opencv-nd-matrix` (sizes, dt, data; OpenCV 5 writes 1-D arrays so) as one
of shape `sizes`, and a number as a float. Other nodes are not parsed.
`write_filestorage` writes numpy matrices and numbers in the form
`cv2.FileStorage` writes them. tests/test_torch_host_io.py holds both
against cv2.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

# FileStorage element codes (`dt`) <-> numpy dtypes
_DTYPES = {"u": np.uint8, "c": np.int8, "w": np.uint16, "s": np.int16, "i": np.int32,
           "f": np.float32, "d": np.float64, "h": np.float16}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _matrix(node, path):
    """An `opencv-matrix` (rows, cols) or `opencv-nd-matrix` (sizes) node."""
    if node.get("type_id") == "opencv-matrix":
        shape = (int(node.findtext("rows")), int(node.findtext("cols")))
    else:
        shape = tuple(int(s) for s in node.findtext("sizes").split())
    dt = node.findtext("dt").strip().strip('"')
    code = dt.lstrip("0123456789")
    if code not in _DTYPES or len(code) != 1:
        raise ValueError(f"{path}: {node.tag}: unsupported matrix element type {dt!r}")
    cn = int(dt[:-1] or 1)
    if cn > 1:
        shape += (cn,)
    data = np.array((node.findtext("data") or "").split(), np.float64)
    if data.size != np.prod(shape):
        raise ValueError(f"{path}: {node.tag}: {data.size} values for a matrix of shape "
                         f"{shape}")
    return data.astype(_DTYPES[code]).reshape(shape)


def _value(node, path):
    if node.get("type_id") in ("opencv-matrix", "opencv-nd-matrix"):
        return _matrix(node, path)
    if node.get("type_id") is None and not list(node):
        try:
            return float(node.text)
        except (TypeError, ValueError):
            pass
    raise ValueError(f"{path}: {node.tag}: neither a matrix nor a number")


def read_filestorage(path, names):
    """{name: value} of those top-level nodes of an OpenCV FileStorage XML
    file that are among `names` (see the module docstring); a node among
    them that is neither a matrix nor a number raises ValueError."""
    root = ET.parse(path).getroot()
    if root.tag != "opencv_storage":
        raise ValueError(f"{path}: not an OpenCV FileStorage XML file (root "
                         f"<{root.tag}>)")
    return {node.tag: _value(node, path) for node in root if node.tag in names}


def _text(x):
    return repr(float(x)) if np.issubdtype(type(x), np.floating) else str(int(x))


def write_filestorage(path, nodes):
    """Write {name: 2-D numpy array | number} as OpenCV FileStorage XML."""
    out = ['<?xml version="1.0"?>', "<opencv_storage>"]
    for name, val in nodes.items():
        if isinstance(val, np.ndarray):
            if val.ndim != 2 or val.dtype not in _CODES:
                raise ValueError(f"write_filestorage: {name}: needs a 2-D array of "
                                 f"{sorted(map(str, _CODES))}, got {val.dtype} {val.shape}")
            data = " ".join(_text(x) for x in val.ravel())
            out.append(f'<{name} type_id="opencv-matrix">\n  <rows>{val.shape[0]}</rows>\n'
                       f"  <cols>{val.shape[1]}</cols>\n  <dt>{_CODES[val.dtype]}</dt>\n"
                       f"  <data>\n    {data}</data></{name}>")
        else:
            out.append(f"<{name}>{_text(val)}</{name}>")
    out.append("</opencv_storage>\n")
    with open(path, "w") as f:
        f.write("\n".join(out))
