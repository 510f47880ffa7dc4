"""Ogg/Vorbis decode + encode via ctypes over the system codec libraries (a
copy of saev_tpu/utils/vorbis.py, numpy and ctypes only).

The reference decodes BirdCLEF .ogg recordings through soundfile
(reference src/saev/data/datasets.py:717-755). Where soundfile and torchaudio
are not installed, the underlying codecs usually are: libvorbisfile (decode),
libvorbisenc/libvorbis/libogg (encode) ship with most distros. This module binds
them directly:

- `read_ogg(path)` -> (mono float32 waveform, sample_rate) via
  ov_fopen/ov_read_float — float PCM straight from the decoder.
- `write_ogg(path, waveform, sr, quality)` runs the full libvorbis VBR
  analysis + libogg page framing, so tests can round-trip hermetically and
  birdsong clips can ship as .ogg like the reference's.

Only the struct layouts the code must READ are declared (ogg_packet,
ogg_page, vorbis_info — all frozen public ABI); every state struct the
libraries manage internally is an oversized opaque buffer.

Everything degrades gracefully: `available()` is False when the shared
libraries are missing and callers fall back (datasets._load_audio).
"""

import ctypes
import ctypes.util
import functools
import pathlib

import numpy as np


class _OggPacket(ctypes.Structure):
    _fields_ = [
        ("packet", ctypes.POINTER(ctypes.c_ubyte)),
        ("bytes", ctypes.c_long),
        ("b_o_s", ctypes.c_long),
        ("e_o_s", ctypes.c_long),
        ("granulepos", ctypes.c_int64),
        ("packetno", ctypes.c_int64),
    ]


class _OggPage(ctypes.Structure):
    _fields_ = [
        ("header", ctypes.POINTER(ctypes.c_ubyte)),
        ("header_len", ctypes.c_long),
        ("body", ctypes.POINTER(ctypes.c_ubyte)),
        ("body_len", ctypes.c_long),
    ]


class _VorbisInfo(ctypes.Structure):
    _fields_ = [
        ("version", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("rate", ctypes.c_long),
        ("bitrate_upper", ctypes.c_long),
        ("bitrate_nominal", ctypes.c_long),
        ("bitrate_lower", ctypes.c_long),
        ("bitrate_window", ctypes.c_long),
        ("codec_setup", ctypes.c_void_p),
    ]


def _opaque(n: int = 4096):
    """Caller-allocated struct the library fills; oversized on purpose."""
    return ctypes.create_string_buffer(n)


@functools.cache
def _libs():
    """(vorbisfile, vorbis, vorbisenc, ogg) CDLLs, or None if unavailable."""
    def load(stem, vers):
        for name in [ctypes.util.find_library(stem), *vers]:
            if not name:
                continue
            try:
                return ctypes.CDLL(name)
            except OSError:
                continue
        return None

    vf = load("vorbisfile", ["libvorbisfile.so.3", "libvorbisfile.so"])
    vo = load("vorbis", ["libvorbis.so.0", "libvorbis.so"])
    ve = load("vorbisenc", ["libvorbisenc.so.2", "libvorbisenc.so"])
    og = load("ogg", ["libogg.so.0", "libogg.so"])
    if not all((vf, vo, ve, og)):
        return None

    vf.ov_fopen.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    vf.ov_fopen.restype = ctypes.c_int
    vf.ov_info.argtypes = [ctypes.c_void_p, ctypes.c_int]
    vf.ov_info.restype = ctypes.POINTER(_VorbisInfo)
    vf.ov_pcm_total.argtypes = [ctypes.c_void_p, ctypes.c_int]
    vf.ov_pcm_total.restype = ctypes.c_int64
    vf.ov_read_float.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.POINTER(ctypes.c_float))),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    vf.ov_read_float.restype = ctypes.c_long
    vf.ov_clear.argtypes = [ctypes.c_void_p]

    vo.vorbis_analysis_buffer.argtypes = [ctypes.c_void_p, ctypes.c_int]
    vo.vorbis_analysis_buffer.restype = ctypes.POINTER(
        ctypes.POINTER(ctypes.c_float)
    )
    return vf, vo, ve, og


def available() -> bool:
    return _libs() is not None


def read_ogg(fpath: pathlib.Path | str) -> tuple[np.ndarray, int]:
    """Decode an Ogg/Vorbis file to (mono float32 waveform, sample_rate)."""
    libs = _libs()
    if libs is None:
        raise ImportError("libvorbisfile not available")
    vf_lib, *_ = libs

    vf = _opaque(8192)
    rc = vf_lib.ov_fopen(str(fpath).encode(), vf)
    if rc != 0:
        raise ValueError(f"ov_fopen failed with rc={rc} for {fpath}")
    try:
        info = vf_lib.ov_info(vf, -1).contents
        channels, rate = int(info.channels), int(info.rate)
        total = int(vf_lib.ov_pcm_total(vf, -1))
        chunks = []
        pcm = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))()
        bitstream = ctypes.c_int(0)
        OV_HOLE = -3  # interruption in the data; the ONLY recoverable error
        while True:
            n = vf_lib.ov_read_float(
                vf, ctypes.byref(pcm), 4096, ctypes.byref(bitstream)
            )
            if n == 0:
                break
            if n == OV_HOLE:
                continue
            if n < 0:
                # OV_EBADLINK/OV_EINVAL etc. do not advance the stream;
                # retrying would spin forever.
                raise ValueError(f"ov_read_float failed with rc={n} for {fpath}")
            frame = np.zeros(n, dtype=np.float32)
            for c in range(channels):
                frame += np.ctypeslib.as_array(pcm[c], shape=(n,))
            chunks.append(frame / channels)
        wav = (
            np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
        )
        if total > 0:
            wav = wav[:total]
        return wav.astype(np.float32), rate
    finally:
        vf_lib.ov_clear(vf)


def write_ogg(
    fpath: pathlib.Path | str,
    waveform: np.ndarray,
    sample_rate: int,
    *,
    quality: float = 0.4,
) -> None:
    """Encode a mono float32 waveform (-1..1) as an Ogg/Vorbis file."""
    libs = _libs()
    if libs is None:
        raise ImportError("libvorbis/libvorbisenc/libogg not available")
    _, vo, ve, og = libs

    wav = np.ascontiguousarray(np.asarray(waveform, np.float32).reshape(-1))

    vi = _opaque()
    vo.vorbis_info_init(vi)
    rc = ve.vorbis_encode_init_vbr(
        vi, ctypes.c_long(1), ctypes.c_long(int(sample_rate)),
        ctypes.c_float(quality),
    )
    if rc != 0:
        # vi was already initialized above; clear it before raising so a
        # failed encode_init doesn't leak the native vorbis_info allocation.
        vo.vorbis_info_clear(vi)
        raise ValueError(f"vorbis_encode_init_vbr failed rc={rc}")
    vc, vd, vb, os_ = _opaque(), _opaque(), _opaque(), _opaque()
    vo.vorbis_comment_init(vc)
    vo.vorbis_analysis_init(vd, vi)
    vo.vorbis_block_init(vd, vb)
    og.ogg_stream_init(os_, ctypes.c_int(1))

    page = _OggPage()
    packet = _OggPacket()

    try:
        with open(fpath, "wb") as fd:

            def write_pages(flush: bool) -> None:
                fn = og.ogg_stream_flush if flush else og.ogg_stream_pageout
                while fn(os_, ctypes.byref(page)) != 0:
                    fd.write(ctypes.string_at(page.header, page.header_len))
                    fd.write(ctypes.string_at(page.body, page.body_len))

            # Three mandatory header packets on their own flushed page(s).
            h_id, h_comm, h_code = _OggPacket(), _OggPacket(), _OggPacket()
            vo.vorbis_analysis_headerout(
                vd, vc, ctypes.byref(h_id), ctypes.byref(h_comm),
                ctypes.byref(h_code),
            )
            for h in (h_id, h_comm, h_code):
                og.ogg_stream_packetin(os_, ctypes.byref(h))
            write_pages(flush=True)

            def drain() -> None:
                while vo.vorbis_analysis_blockout(vd, vb) == 1:
                    vo.vorbis_analysis(vb, None)
                    vo.vorbis_bitrate_addblock(vb)
                    while vo.vorbis_bitrate_flushpacket(vd, ctypes.byref(packet)):
                        og.ogg_stream_packetin(os_, ctypes.byref(packet))
                        write_pages(flush=False)

            block = 1024
            for start in range(0, len(wav), block):
                chunk = wav[start : start + block]
                buf = vo.vorbis_analysis_buffer(vd, len(chunk))
                ctypes.memmove(
                    buf[0], chunk.ctypes.data, chunk.nbytes
                )
                vo.vorbis_analysis_wrote(vd, len(chunk))
                drain()
            vo.vorbis_analysis_wrote(vd, 0)  # end of stream
            drain()
            write_pages(flush=True)
    finally:
        og.ogg_stream_clear(os_)
        vo.vorbis_block_clear(vb)
        vo.vorbis_dsp_clear(vd)
        vo.vorbis_comment_clear(vc)
        vo.vorbis_info_clear(vi)
