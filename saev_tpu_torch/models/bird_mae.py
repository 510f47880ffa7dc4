"""Bird-MAE audio ViT family: mel-spectrogram encoder + audio patch filtering
(the counterpart of saev_tpu/models/bird_mae.py).

Capability mirror of reference `src/saev/data/bird_mae.py` (Config :51, sincos
pos embeds :89-130, Block :281, PatchEmbed :339, Encoder :373, load :497,
transform :544, Transformer :593, filter_audio :698), on the shared torch
engine and a numpy Kaldi-compatible fbank (the reference uses
torchaudio.compliance.kaldi). Neither Pillow nor pandas is needed anywhere on
this family's path.

Key reproduced quirks:
- Residual taps record `block.norm2` *outputs*, not block outputs (the reference
  hooks norm2; bird_mae.py:608) — `Spec.tap_point="norm2"`.
- The fixed 2-D sincos positional table is computed over the (8 mel, 32 time)
  grid while patch tokens iterate (32 time, 8 mel) row-major — the upstream
  AudioMAE layout, reproduced verbatim for checkpoint parity
  (bird_mae.py:112-130, :365-369).
- Model output = [mean-pooled+fc_norm, norm(tokens)] (final_norm="patch-norm").
"""

import logging
import typing as tp
from collections.abc import Callable

import numpy as np

from ..data import models as base
from . import convert, vit

logger = logging.getLogger(__name__)

SR_HZ = 32_000
CLIP_SEC = 5
TARGET_T = 512
N_MELS = 128
MEAN = -7.2
STD = 4.43
FRAMES_PER_PATCH = 16
MELS_PER_PATCH = 16
N_TIME_PATCHES = TARGET_T // FRAMES_PER_PATCH  # 32
N_MEL_PATCHES = N_MELS // MELS_PER_PATCH  # 8
N_PATCHES = N_TIME_PATCHES * N_MEL_PATCHES  # 256
SAMPLES_PER_FRAME = 320  # 10 ms at 32 kHz
SAMPLES_PER_TIME_PATCH = FRAMES_PER_PATCH * SAMPLES_PER_FRAME
STFT_N_FFT = 1024
STFT_HOP_LENGTH = SAMPLES_PER_FRAME
STFT_WIN_LENGTH = 800  # 25 ms
STFT_LOW_FREQ_HZ = 20.0


def _spec(d, depth, heads) -> vit.Spec:
    return vit.Spec(
        d_model=d, n_layers=depth, n_heads=heads, patch_size=16,
        in_chans=1, cls_token=True, ln_eps=1e-6, pos_kind="learned",
        tap_point="norm2",
    )


PRETRAINED_SPECS: dict[str, vit.Spec] = {
    "Bird-MAE-Base": _spec(768, 12, 12),
    "Bird-MAE-Large": _spec(1024, 24, 16),
    "Bird-MAE-Huge": _spec(1280, 32, 16),
}


def pos_table(d_model: int) -> np.ndarray:
    """The fixed sincos table, zero row for CLS (reference bird_mae.py:112-130,
    grid_size = patch_hw = (8, 32))."""
    table = vit.sincos_2d(d_model, N_MEL_PATCHES, N_TIME_PATCHES)
    return np.concatenate([np.zeros((1, d_model), np.float32), table], axis=0)


# ---------------------------------------------------------------------------
# Kaldi-compatible fbank (numpy; replaces torchaudio.compliance.kaldi.fbank)
# ---------------------------------------------------------------------------


def _kaldi_mel(hz):
    return 1127.0 * np.log(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


def kaldi_fbank(
    waveform: np.ndarray,
    *,
    sample_rate: int = SR_HZ,
    num_mel_bins: int = N_MELS,
    frame_length_ms: float = 25.0,
    frame_shift_ms: float = 10.0,
    low_freq: float = 20.0,
    preemph: float = 0.97,
) -> np.ndarray:
    """Log-mel filterbank matching torchaudio.compliance.kaldi.fbank with
    htk_compat=True, use_energy=False, window_type="hanning", dither=0.

    Kaldi semantics: snip_edges framing, per-frame DC removal, pre-emphasis,
    Hann window, FFT padded to the next power of two, triangular mels on the
    Kaldi mel scale (1127·ln(1+f/700)), natural-log energies floored at eps.
    """
    wav = np.asarray(waveform, dtype=np.float64)
    assert wav.ndim == 1
    win = int(sample_rate * frame_length_ms / 1000)  # 800
    hop = int(sample_rate * frame_shift_ms / 1000)  # 320
    n_fft = 1 << (win - 1).bit_length()  # 1024
    n_frames = 1 + (len(wav) - win) // hop
    assert n_frames > 0, "Waveform shorter than one frame."

    idx = np.arange(win)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = wav[idx]
    # Per-frame DC offset removal (Kaldi remove_dc_offset=True).
    frames = frames - frames.mean(axis=1, keepdims=True)
    # Pre-emphasis with reflected first sample.
    frames = np.concatenate([frames[:, :1], frames], axis=1)
    frames = frames[:, 1:] - preemph * frames[:, :-1]
    # Hann window (Kaldi "hanning" = 0.5 - 0.5 cos, periodic over win).
    n = np.arange(win, dtype=np.float64)
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (win - 1))
    frames = frames * window

    spec = np.fft.rfft(frames, n=n_fft, axis=1)
    power = spec.real**2 + spec.imag**2  # (n_frames, n_fft//2+1)

    # Triangular mel bank on FFT bins (Kaldi mel-banks math).
    high_freq = sample_rate / 2.0
    mel_low = _kaldi_mel(low_freq)
    mel_high = _kaldi_mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_mel_bins + 1)
    fft_freqs = np.arange(n_fft // 2 + 1) * (sample_rate / n_fft)
    mel_fft = _kaldi_mel(fft_freqs)  # (n_bins_fft,)

    left = mel_low + np.arange(num_mel_bins) * mel_delta
    center = left + mel_delta
    right = center + mel_delta
    up = (mel_fft[None, :] - left[:, None]) / mel_delta
    down = (right[:, None] - mel_fft[None, :]) / mel_delta
    bank = np.maximum(0.0, np.minimum(up, down))  # (n_mels, n_bins_fft)
    # Kaldi excludes the Nyquist bin from the banks.
    bank[:, -1] = 0.0

    mel_energies = power @ bank.T
    mel_energies = np.log(np.maximum(mel_energies, np.finfo(np.float64).eps))
    return mel_energies.astype(np.float32)  # (n_frames, n_mels)


def transform(waveform: np.ndarray) -> np.ndarray:
    """Waveform → normalized (512, 128) log-mel patch input
    (reference bird_mae.py:544-591)."""
    wav = np.asarray(waveform, dtype=np.float32)
    (n_samples,) = wav.shape
    max_len = SR_HZ * CLIP_SEC
    if n_samples < max_len:
        wav = np.pad(wav, (0, max_len - n_samples))
    else:
        wav = wav[:max_len]
    wav = wav - wav.mean()

    fb = kaldi_fbank(wav)
    t = fb.shape[0]
    if t < TARGET_T:
        fb = np.pad(fb, ((0, TARGET_T - t), (0, 0)), constant_values=fb.min())
    elif t > TARGET_T:
        fb = fb[:TARGET_T]
    fb = (fb - MEAN) / (STD * 2.0)
    assert fb.shape == (TARGET_T, N_MELS), fb.shape
    return fb


def spectrogram_to_tokens(fb_tm: np.ndarray) -> np.ndarray:
    """(512, 128) spectrogram → (256, 256) patch tokens in conv row-major order
    (time patches outer, mel patches inner; reference PatchEmbed bird_mae.py:365)."""
    t, m = fb_tm.shape
    p = 16
    tp_, mp = t // p, m // p
    return (
        fb_tm.reshape(tp_, p, mp, p)
        .transpose(0, 2, 1, 3)
        .reshape(tp_ * mp, p * p)
        .astype(np.float32)
    )


class Transformer(base.Transformer):
    """Bird-MAE wrapper (reference bird_mae.py:593-637)."""

    family: str = "bird-mae"

    def __init__(
        self,
        ckpt: str,
        *,
        params: dict | None = None,
        device: str = "cuda",
        precision: str = "default",
    ):
        arch, _, fpath = ckpt.partition("=")
        if arch not in PRETRAINED_SPECS:
            raise ValueError(f"Checkpoint '{arch}' not in {list(PRETRAINED_SPECS)}.")
        self._ckpt = arch
        self.spec = PRETRAINED_SPECS[arch]
        self.precision = precision
        if params is not None:
            self.params = params
        else:
            from . import families

            sd = convert.load_state_dict(
                fpath if fpath else families.resolve_weights(self.family, arch)
            )
            self.params, pos = convert.from_timm(sd, self.spec)
            self._fc_norm = (
                convert._ln(sd, "fc_norm") if "fc_norm.weight" in sd else None
            )
            if pos is None:
                pos = pos_table(self.spec.d_model)
            self.params["pos"] = pos
        if "pos" not in self.params:
            self.params["pos"] = pos_table(self.spec.d_model)
        if not hasattr(self, "_fc_norm"):
            self._fc_norm = None
        self.params = vit.to_device(self.params, device)

    @property
    def ckpt(self) -> str:
        return self._ckpt

    @property
    def patch_size(self) -> int:
        return 16

    @property
    def d_model(self) -> int:
        return self.spec.d_model

    @property
    def n_layers(self) -> int:
        return self.spec.n_layers

    def get_token_i(self, content_tokens_per_example: int) -> slice:
        return slice(None, None, None)

    def forward_recorded(
        self, batch: np.ndarray, layers: tuple[int, ...], **kwargs
    ) -> tuple[np.ndarray, np.ndarray]:
        x = np.asarray(batch, dtype=np.float32)
        if x.ndim == 2:  # single (512, 128) spectrogram
            x = x[None]
        if x.ndim == 3 and x.shape[1:] == (TARGET_T, N_MELS):
            tokens = np.stack([spectrogram_to_tokens(fb) for fb in x])
        else:
            assert x.ndim == 3 and x.shape[1] == N_PATCHES, x.shape
            tokens = x
        return vit.run(
            self.spec, self.params, tokens, tuple(layers),
            (N_TIME_PATCHES, N_MEL_PATCHES), precision=self.precision,
        )

    @staticmethod
    def make_transforms(
        ckpt: str, content_tokens_per_example: int
    ) -> tuple[Callable, Callable | None]:
        assert content_tokens_per_example == N_PATCHES
        return transform, None

    @staticmethod
    def make_resize(
        ckpt: str,
        content_tokens_per_example: int = -1,
        *,
        scale: float = 1.0,
        resample=None,
    ) -> Callable:
        raise NotImplementedError("Bird-MAE uses audio spectrograms, not images.")


# ---------------------------------------------------------------------------
# Audio filtering from SAE patch activations (reference bird_mae.py:639-832)
# ---------------------------------------------------------------------------


def hz_to_mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


def mel_to_hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


def _stft(wav: np.ndarray, n_fft: int, hop: int, win_length: int) -> np.ndarray:
    """Center-padded STFT matching torch.stft(center=True, hann window).
    Returns (n_fft//2+1, n_frames) complex."""
    window = np.hanning(win_length + 1)[:-1]  # periodic hann, like torch
    pad_w = (n_fft - win_length) // 2
    window = np.pad(window, (pad_w, n_fft - win_length - pad_w))
    wav = np.pad(wav, (n_fft // 2, n_fft // 2), mode="reflect")
    n_frames = 1 + (len(wav) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = wav[idx] * window
    return np.fft.rfft(frames, axis=1).T


def _istft(stft: np.ndarray, n_fft: int, hop: int, win_length: int, length: int) -> np.ndarray:
    """Inverse of `_stft` via windowed overlap-add with window-square
    normalization (torch.istft semantics)."""
    window = np.hanning(win_length + 1)[:-1]
    pad_w = (n_fft - win_length) // 2
    window = np.pad(window, (pad_w, n_fft - win_length - pad_w))
    frames = np.fft.irfft(stft.T, n=n_fft, axis=1)  # (n_frames, n_fft)
    n_frames = frames.shape[0]
    total = n_fft + hop * (n_frames - 1)
    out = np.zeros(total)
    norm = np.zeros(total)
    for i in range(n_frames):
        s = i * hop
        out[s : s + n_fft] += frames[i] * window
        norm[s : s + n_fft] += window**2
    out = out / np.maximum(norm, 1e-11)
    out = out[n_fft // 2 : n_fft // 2 + length]
    return out


def filter_audio(
    waveform: np.ndarray,
    sample_rate: int,
    patches: np.ndarray,
    *,
    mode: tp.Literal["time", "time+freq"] = "time",
) -> np.ndarray:
    """Clip audio to the time (and optionally frequency) regions of activated
    spectrogram patches (reference bird_mae.py:698-832).

    Args:
        waveform: raw samples (1-D), 5 s at 32 kHz.
        sample_rate: must be 32000.
        patches: bool (256,) SAE activations per patch, row-major
            (time_patch = i // 8, mel_patch = i % 8).
        mode: "time" clips time segments; "time+freq" additionally zeroes
            non-activated frequency bands via STFT masking.
    """
    assert sample_rate == SR_HZ, f"Bird-MAE expects sample_rate={SR_HZ}, got {sample_rate}."
    patches = np.asarray(patches, dtype=bool)
    assert patches.shape == (N_PATCHES,)
    wav = np.asarray(waveform, dtype=np.float64)
    assert wav.ndim == 1

    max_len = SR_HZ * CLIP_SEC
    if len(wav) < max_len:
        wav = np.pad(wav, (0, max_len - len(wav)))
    else:
        wav = wav[:max_len]

    if mode == "time+freq":
        stft = _stft(wav, STFT_N_FFT, STFT_HOP_LENGTH, STFT_WIN_LENGTH)
        freqs = np.linspace(0, sample_rate / 2, stft.shape[0])
        mask = np.zeros(stft.shape, dtype=bool)

        min_mel = hz_to_mel(STFT_LOW_FREQ_HZ)
        max_mel = hz_to_mel(sample_rate / 2)
        mel_range = max_mel - min_mel

        for i in np.nonzero(patches)[0]:
            time_idx = i // N_MEL_PATCHES
            mel_idx = i % N_MEL_PATCHES
            t_start = time_idx * FRAMES_PER_PATCH
            t_end = min((time_idx + 1) * FRAMES_PER_PATCH, stft.shape[1])
            mel_lo = min_mel + (mel_idx * MELS_PER_PATCH / N_MELS) * mel_range
            mel_hi = min_mel + ((mel_idx + 1) * MELS_PER_PATCH / N_MELS) * mel_range
            freq_mask = (freqs >= mel_to_hz(mel_lo)) & (freqs < mel_to_hz(mel_hi))
            if t_start < t_end:
                mask[np.ix_(freq_mask, np.arange(t_start, t_end))] = True

        wav = _istft(
            stft * mask, STFT_N_FFT, STFT_HOP_LENGTH, STFT_WIN_LENGTH, len(wav)
        )

    segments = []
    for t in np.unique(np.nonzero(patches)[0] // N_MEL_PATCHES):
        start = int(t) * SAMPLES_PER_TIME_PATCH
        end = (int(t) + 1) * SAMPLES_PER_TIME_PATCH
        if start >= len(wav):
            continue
        segments.append(wav[start : min(end, len(wav))])

    if not segments:
        return wav[:0].astype(np.float32)
    return np.concatenate(segments).astype(np.float32)


base.register_family(Transformer)
