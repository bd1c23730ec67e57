"""Parsers for dataset metadata and ground-truth meshes.

Copy of the parsers of ``raynet_tpu/common/parse_input_data.py`` that the
port's scenes call:
- Restrepo ``scene_info.xml``: bbox attributes minx..maxz
- DTU ``ObsMask*.mat``: bounding box under key "BB"
- ascii PLY / OBJ ground-truth meshes -> (points, normals, face indices)
- binary PLY (DTU STL exports, and the port's own point clouds) -> point
  cloud, via a small header parser (``PLYHeader``)
"""
import os
import xml.etree.ElementTree as ET

import numpy as np


def parse_scene_info(scene_info_filename):
    """Restrepo scene bbox as a (1, 6) float32 [min_xyz, max_xyz]."""
    root = ET.parse(scene_info_filename).getroot()
    attrs = {child.tag: child.attrib for child in root}
    bbox = attrs["bbox"]
    return np.array(
        [
            [bbox["minx"], bbox["miny"], bbox["minz"]],
            [bbox["maxx"], bbox["maxy"], bbox["maxz"]],
        ],
        dtype=np.float32,
    ).reshape(1, -1)


def parse_scene_info_dtu_dataset(scene_file):
    """DTU ObsMask .mat bbox ("BB" key) as (1, 6) float32."""
    from scipy.io import loadmat

    scene_info = loadmat(scene_file, squeeze_me=True)
    return scene_info["BB"].astype(np.float32).reshape(1, -1)


def parse_gt_data_from_ply(gt_file):
    """Ascii PLY with vertex rows (x y z nx ny nz) and face index rows."""
    with open(gt_file, "r") as f:
        num_vertices = None
        while True:
            line = f.readline()
            if "element vertex" in line:
                num_vertices = int(line.strip().split(" ")[-1])
            if "end_header" in line:
                break
        rows = [x.strip().split() for x in f.readlines() if x.strip()]

    vertex_rows = np.array(rows[:num_vertices], dtype=np.float32)
    face_rows = np.array(
        [[int(v) for v in r] for r in rows[num_vertices:]], dtype=np.int64
    )[:, 1:]
    return vertex_rows[:, 0:3], vertex_rows[:, 3:], face_rows


def parse_gt_data_from_obj(gt_file):
    """Wavefront OBJ: v / vn / f records (f may use v//vn syntax)."""
    v, vn, faces = [], [], []
    with open(gt_file, "r") as f:
        for line in f:
            if line.startswith("v "):
                v.append([float(x) for x in line.split()[1:]])
            elif line.startswith("vn "):
                vn.append([float(x) for x in line.split()[1:]])
            elif line.startswith("f"):
                faces.append(
                    [int(tok.split("//")[0]) for tok in line.split()[1:]]
                )
    vertices = np.array(v, dtype=np.float32)
    normals = np.array(vn, dtype=np.float32)
    faces_idxs = np.array(faces, dtype=np.int64) - 1  # OBJ is 1-based
    return vertices, normals, faces_idxs


def parse_gt_data(input_directory):
    files = os.listdir(input_directory)
    if "gt_mesh.obj" in files:
        return parse_gt_data_from_obj(
            os.path.join(input_directory, "gt_mesh.obj")
        )
    return parse_gt_data_from_ply(
        os.path.join(input_directory, "gt_mesh.ply")
    )


def parse_gt_mesh(input_directory):
    """Ground-truth mesh as (T, 3, 3) triangles (vertex-major)."""
    points, _, faces = parse_gt_data(input_directory)
    return points[faces]  # (T, 3, 3)


_PLY_TYPE_BYTES = {
    "float": 4, "float32": 4, "uchar": 1, "uint8": 1, "int": 4, "int32": 4,
    "double": 8, "float64": 8, "short": 2, "ushort": 2,
}


class PLYHeader:
    """Minimal binary-PLY header reader (elements, properties, endianness)."""

    class Element:
        def __init__(self, name, count, properties):
            self.name = name
            self.count = count
            self.properties = properties

        @property
        def bytes(self):
            return sum(p.bytes for p in self.properties)

    class Property:
        def __init__(self, name, type_):
            self.name = name
            self.type = type_

        @property
        def bytes(self):
            return _PLY_TYPE_BYTES[self.type]

    def __init__(self, fileobj):
        magic = fileobj.readline().strip()
        if magic not in (b"ply", "ply"):
            raise ValueError("not a PLY file")

        lines = []
        while True:
            line = fileobj.readline()
            if isinstance(line, bytes):
                line = line.decode("ascii", "replace")
            if "end_header" in line:
                break
            lines.append(line.strip())

        _, fmt, version = lines[0].split()
        self.is_ascii = "ascii" in fmt
        self.little_endian = "little" in fmt
        self.version = float(version)
        self.comments = [
            x.split(" ", 1)[1] for x in lines if x.startswith("comment")
        ]

        lines = [l for l in lines if not l.startswith("comment")]
        elements = []
        i = 1
        while i < len(lines):
            _, name, count = lines[i].split()
            i += 1
            props = []
            while i < len(lines) and lines[i].startswith("property"):
                _, type_, pname = lines[i].split()
                props.append(self.Property(pname, type_))
                i += 1
            elements.append(self.Element(name, int(count), props))
        self.elements = elements


def parse_stl_file_to_pointcloud(stl_file):
    """Binary-PLY point export (DTU's stl*_total.ply) -> (N, 3) points."""
    with open(stl_file, "rb") as f:
        header = PLYHeader(f)
        el = header.elements[0]
        if not all(p.type.startswith("float") for p in el.properties[:3]):
            raise ValueError("%s: the first three vertex properties must be "
                             "floats" % (stl_file,))

        data = np.fromfile(f, dtype=np.uint8)[: el.count * el.bytes]
        data = data.reshape(-1, el.bytes)
        xyz_bytes = sum(p.bytes for p in el.properties[:3])
        data = np.ascontiguousarray(data[:, :xyz_bytes]).ravel()
        order = "<" if header.little_endian else ">"
        return np.frombuffer(data.tobytes(), dtype=order + "f4").reshape(-1, 3)
