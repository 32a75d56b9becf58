"""
A MeasurementSet v2 writer for tests and the card's smoke run, numpy
and stdlib only (no casacore): :func:`write_measurement_set` writes a
VZ dataset's columns (:func:`vz_columns`) in the casacore table format
that ``ska_sdp_cip_tpu_torch/io/casacore_tables.py`` reads, DATA in
TiledShapeStMan, FLAG, WEIGHT_SPECTRUM, WEIGHT and UVW in
TiledColumnStMan, TIME in IncrementalStMan and the subtables in
StandardStMan. :func:`bit_equal` compares two arrays' dtype, shape and
bytes.

It imports neither jax nor the JAX package (the port's no-jax test
scans it), so the card's machine can run it.
"""

import json
import struct
from pathlib import Path

import numpy as np

#: The MeasurementSet's main table: each tiled column in a manager of
#: its own (the reader maps one (type, group) to one ``table.f<seq>``),
#: DATA in TiledShapeStMan as the CASA filler binds it, TIME in
#: IncrementalStMan; (column, VZ file, manager, group, value type name).
MS_MAIN_COLUMNS = (
    ("UVW", "uvw", "TiledColumnStMan", "TiledUVW", "Double"),
    ("TIME", "time", "IncrementalStMan", "ISMData", "Double"),
    ("DATA", "data", "TiledShapeStMan", "TiledData", "Complex"),
    ("FLAG", "flag", "TiledColumnStMan", "TiledFlag", "Bool"),
    ("WEIGHT_SPECTRUM", "weight_spectrum", "TiledColumnStMan",
     "TiledWgtSpectrum", "Float"),
    ("WEIGHT", "weight", "TiledColumnStMan", "TiledWeight", "Float"),
)
#: Big-endian dtypes of the cells (AipsIO's canonical byte order).
MS_DTYPES = {"Double": ">f8", "Complex": ">c8", "Float": ">f4",
             "Int": ">i4", "Bool": "u1"}
#: casacore AipsIO's magic number before a top-level object.
AIPSIO_MAGIC = 0xBEBEBEBE


def _aipsio_string(text: str) -> bytes:
    raw = text.encode()
    return struct.pack(">I", len(raw)) + raw


def _aipsio_frame(typ: str, version: int, payload: bytes) -> bytes:
    """One AipsIO object: [uInt length][String type][uInt version]
    payload, the length counting everything after itself."""
    body = _aipsio_string(typ) + struct.pack(">I", version) + payload
    return struct.pack(">I", len(body)) + body


def _iposition(shape) -> bytes:
    return _aipsio_frame("IPosition", 2, struct.pack(
        f">I{len(shape)}q", len(shape), *shape))


def _column_desc(name, type_name, shape, dm_type, dm_group, *,
                 ndim=None) -> bytes:
    """A ColumnDesc frame: scalar when ``shape`` is None, a fixed-shape
    direct array for a shape (casacore order, fastest axis first), a
    variable-shape array of ``ndim`` axes when ``shape`` is ()."""
    from ska_sdp_cip_tpu_torch.io import casacore_tables as ct

    codes = {"Bool": ct.TP_BOOL, "Int": ct.TP_INT, "Float": ct.TP_FLOAT,
             "Double": ct.TP_DOUBLE, "Complex": ct.TP_COMPLEX}
    is_array = shape is not None
    if not is_array:
        options, ndim = 0, 0
    elif shape:
        options, ndim = ct.OPT_DIRECT | ct.OPT_FIXEDSHAPE, len(shape)
    else:
        options = 0
    payload = (_aipsio_string(
        f"{'Array' if is_array else 'Scalar'}ColumnDesc<{type_name}>")
        + struct.pack(">I", 1) + _aipsio_string(name) + _aipsio_string("")
        + _aipsio_string(dm_type) + _aipsio_string(dm_group)
        + struct.pack(">3i", codes[type_name], options, ndim))
    if is_array:
        payload += _iposition(shape)
    return _aipsio_frame("ColumnDesc", 1, payload)


def _write_table_dat(path: Path, num_rows: int, descs: list) -> None:
    path.mkdir(parents=True, exist_ok=True)
    table = _aipsio_frame("Table", 2, struct.pack(">2I", num_rows, 0)
                          + _aipsio_string(path.name)
                          + _aipsio_frame("TableDesc", 1, b"".join(descs)))
    (path / "table.dat").write_bytes(struct.pack(">I", AIPSIO_MAGIC) + table)


def _tile_cube(values: np.ndarray, tile: tuple, type_name: str) -> bytes:
    """The TSM hypercube of ``values`` (rows first, numpy order): a
    Fortran-ordered grid of Fortran-ordered tiles over cell + (rows,),
    ``tile`` in casacore order; Bool tiles bit-packed. Whole tiles at
    once: the grid is numpy's C order over the reversed axes."""
    rev = tuple(reversed(tile))
    counts = [-(-n // t) for n, t in zip(values.shape, rev)]
    padded = np.zeros([n * t for n, t in zip(counts, rev)],
                      MS_DTYPES[type_name])
    padded[tuple(slice(0, n) for n in values.shape)] = values
    split = padded.reshape([d for nt in zip(counts, rev) for d in nt])
    rank = len(rev)
    tiles = np.ascontiguousarray(split.transpose(
        [2 * a for a in range(rank)] + [2 * a + 1 for a in range(rank)]))
    if type_name == "Bool":
        return np.packbits(tiles.reshape(int(np.prod(counts)), -1), axis=1,
                           bitorder="little").tobytes()
    return tiles.tobytes()


def _write_tiled_column(path: Path, seq: int, dm_type: str,
                        values: np.ndarray, tile: tuple, type_name: str):
    """``table.f<seq>`` (the manager's header: TSSM holds the hypercube
    shape and then the tile shape, TSM the tile shape) and its cube file
    ``table.f<seq>_TSM0``."""
    cube = tuple(reversed(values.shape))
    shapes = (cube, tile) if dm_type == "TiledShapeStMan" else (tile,)
    header = _aipsio_frame(dm_type, 1, b"".join(_iposition(s)
                                                for s in shapes))
    (path / f"table.f{seq}").write_bytes(
        struct.pack(">I", AIPSIO_MAGIC) + header)
    (path / f"table.f{seq}_TSM0").write_bytes(
        _tile_cube(values, tile, type_name))


def _write_ism_column(path: Path, seq: int, values: np.ndarray) -> None:
    """One scalar Double column in IncrementalStMan: one bucket holding
    the value at each change point and its index, then the ISMIndex
    object (64-bit row boundaries)."""
    from ska_sdp_cip_tpu_torch.io import casacore_tables as ct

    starts = np.flatnonzero(np.r_[True, values[1:] != values[:-1]])
    n = len(starts)
    index_offset = 4 + 8 * n
    used = index_offset + 4 + 8 * n
    bucket_size = max(512, -(-used // 512) * 512)
    bucket = bytearray(bucket_size)
    bucket[:used] = (
        struct.pack(">I", index_offset)
        + values[starts].astype(">f8").tobytes() + struct.pack(">I", n)
        + starts.astype(">u4").tobytes()
        + (4 + 8 * np.arange(n)).astype(">u4").tobytes())
    header = _aipsio_frame("IncrementalStMan", 5, struct.pack(
        ">?4I", True, bucket_size, 1, 1, 0))
    index = _aipsio_frame("ISMIndex", 2, struct.pack(
        ">2I2qII", 1, 2, 0, len(values), 1, 0))
    head = struct.pack(">I", AIPSIO_MAGIC) + header
    (path / f"table.f{seq}").write_bytes(
        head + bytes(ct._SSM_HEADER_AREA - len(head)) + bytes(bucket)
        + index)


def _write_ssm_table(path: Path, columns: list) -> None:
    """A one-row subtable in one StandardStMan bucket: ``columns`` is
    (name, type name, value, indirect); an indirect array stores its
    Int64 offset into the aux file ``table.f0i``, whose cell is
    [uInt ndim][uInt dims][big-endian values]; an SSMIndex object in a
    second bucket maps the row to bucket 0."""
    from ska_sdp_cip_tpu_torch.io import casacore_tables as ct

    descs = [_column_desc(name, type_name, () if indirect else None,
                          "StandardStMan", "StandardStMan",
                          ndim=np.ndim(value) if indirect else None)
             for name, type_name, value, indirect in columns]
    _write_table_dat(path, 1, descs)
    widths = [8 if indirect else np.dtype(MS_DTYPES[type_name]).itemsize
              for _, type_name, _, indirect in columns]
    bucket_size = 512
    rows_per_bucket = bucket_size // sum(widths)
    bucket, aux = bytearray(bucket_size), bytearray(16)
    offset = 0
    for (_, type_name, value, indirect), width in zip(columns, widths):
        value = np.asarray(value, MS_DTYPES[type_name])
        if indirect:
            cell = struct.pack(f">{value.ndim + 1}I", value.ndim,
                               *reversed(value.shape)) + value.tobytes()
            raw = struct.pack(">q", len(aux))
            aux += cell
        else:
            raw = value.tobytes()
        bucket[offset:offset + len(raw)] = raw
        offset += width * rows_per_bucket
    index = _aipsio_frame("SSMIndex", 1, struct.pack(">3I", 1, 0, 0))
    header = _aipsio_frame("StandardStMan", 2, struct.pack(
        ">7i", bucket_size, 2, 1, 0, -1, 1, 1))
    head = struct.pack(">I", AIPSIO_MAGIC) + header
    (path / "table.f0").write_bytes(
        head + bytes(ct._SSM_HEADER_AREA - len(head)) + bytes(bucket)
        + index + bytes(bucket_size - len(index)))
    (path / "table.f0i").write_bytes(bytes(aux))


def ms_tile_shapes(columns: dict, tile_bytes: int) -> dict:
    """Each tiled column's tile shape (casacore order): every
    correlation, every channel (half of them for WEIGHT_SPECTRUM, so its
    tiles also form a grid along frequency), and as many rows as make
    about ``tile_bytes`` (at most the table's)."""
    shapes = {}
    for name, key, dm_type, _, type_name in MS_MAIN_COLUMNS:
        if dm_type == "IncrementalStMan" or key not in columns:
            continue
        cell = list(reversed(columns[key].shape[1:]))
        if name == "WEIGHT_SPECTRUM":
            cell[1] = -(-cell[1] // 2)
        bits = 1 if type_name == "Bool" else 8 * np.dtype(
            MS_DTYPES[type_name]).itemsize
        rows = max(1, 8 * tile_bytes // (bits * int(np.prod(cell))))
        shapes[name] = (*cell, min(rows, len(columns[key])))
    return shapes


def write_measurement_set(path: Path, columns: dict,
                          tile_bytes: int = 1 << 20) -> dict:
    """
    Write ``columns`` (VZ arrays: ``uvw``, ``time``, ``data``, ``flag``,
    ``weight_spectrum`` and/or ``weight``, ``chan_freq``, ``corr_types``)
    as a MeasurementSet v2 in the casacore table format that
    ``io/casacore_tables.py`` reads: the main table's columns bound as
    :data:`MS_MAIN_COLUMNS` says (TiledShapeStMan, TiledColumnStMan and
    IncrementalStMan), big-endian cells, and the subtables
    SPECTRAL_WINDOW (CHAN_FREQ, NUM_CHAN), POLARIZATION (CORR_TYPE,
    NUM_CORR) and FIELD as one-bucket StandardStMan tables with indirect
    array cells. Numpy and stdlib only; the big columns are written as
    whole tiles. Returns each tiled column's tile shape.
    """
    path = Path(path)
    num_rows = len(columns["uvw"])
    tiles = ms_tile_shapes(columns, tile_bytes)
    descs, bound = [], []
    for name, key, dm_type, group, type_name in MS_MAIN_COLUMNS:
        if key not in columns:
            continue
        cell = tuple(reversed(columns[key].shape[1:]))
        if dm_type == "TiledShapeStMan":
            descs.append(_column_desc(name, type_name, (), dm_type, group,
                                      ndim=len(cell)))
        else:
            descs.append(_column_desc(name, type_name, cell or None,
                                      dm_type, group))
        bound.append((key, dm_type, type_name, tiles.get(name)))
    _write_table_dat(path, num_rows, descs)
    for seq, (key, dm_type, type_name, tile) in enumerate(bound):
        values = np.asarray(columns[key])
        if dm_type == "IncrementalStMan":
            _write_ism_column(path, seq, values)
        else:
            _write_tiled_column(path, seq, dm_type, values, tile, type_name)
    freqs = np.asarray(columns["chan_freq"])
    corr = np.asarray(columns["corr_types"])
    _write_ssm_table(path / "SPECTRAL_WINDOW", [
        ("CHAN_FREQ", "Double", freqs, True),
        ("NUM_CHAN", "Int", len(freqs), False)])
    _write_ssm_table(path / "POLARIZATION", [
        ("CORR_TYPE", "Int", corr, True), ("NUM_CORR", "Int", len(corr),
                                           False)])
    _write_ssm_table(path / "FIELD", [
        ("PHASE_DIR", "Double", np.zeros((1, 2)), True),
        ("SOURCE_ID", "Int", 0, False)])
    return tiles


def vz_columns(path: Path) -> dict:
    """A VZ dataset's arrays by file stem, plus its ``corr_types``."""
    columns = {p.stem: np.load(p) for p in sorted(Path(path).glob("*.npy"))}
    meta = json.loads((Path(path) / "metadata.json").read_text())
    columns["corr_types"] = np.asarray(meta["corr_types"], np.int32)
    return columns


def bit_equal(a, b) -> bool:
    """Same dtype, shape and bytes."""
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.ascontiguousarray(a).tobytes()
            == np.ascontiguousarray(b).tobytes())
