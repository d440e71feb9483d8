"""Audio feature extraction for material classification.

Python-3 re-design of the reference's offline ML sidecar
(scripts/features.py, scripts/util.py — Python 2 + pyAudioAnalysis). The
reference extracts 34 short-term features per frame (zero-crossing rate,
energy, entropy, spectral centroid/spread/entropy/flux/rolloff, 13 MFCCs,
12 chroma + deviation) and aggregates them per clip.

This module implements the same 34-feature layout in pure numpy (no
pyAudioAnalysis dependency) so the classification study reproduces on
synthesized audio from the engine itself, closing the loop the reference
needed an external simulator binary for (scripts/util.py:8-9). The port's
own copy of openpbso_tpu/ml/features.py.
"""
from __future__ import annotations

import numpy as np

from ..config import SAMPLE_RATE

FEATURE_NAMES = (
    ["zcr", "energy", "energy_entropy", "spectral_centroid",
     "spectral_spread", "spectral_entropy", "spectral_flux",
     "spectral_rolloff"]
    + [f"mfcc_{i+1}" for i in range(13)]
    + [f"chroma_{i+1}" for i in range(12)]
    + ["chroma_std"]
)
NUM_FEATURES = len(FEATURE_NAMES)  # 34, matching scripts/features.py:28-34


def _frame(signal: np.ndarray, frame_len: int, hop: int) -> np.ndarray:
    n = 1 + max(0, (len(signal) - frame_len)) // hop
    idx = np.arange(frame_len)[None, :] + hop * np.arange(n)[:, None]
    return signal[idx]


def _mel_filterbank(n_filters: int, n_fft: int, sr: int) -> np.ndarray:
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    mels = np.linspace(hz_to_mel(0), hz_to_mel(sr / 2), n_filters + 2)
    hz = mel_to_hz(mels)
    bins = np.floor((n_fft + 1) * hz / sr).astype(int)
    fb = np.zeros((n_filters, n_fft // 2 + 1))
    for i in range(n_filters):
        lo, ctr, hi = bins[i], bins[i + 1], bins[i + 2]
        for j in range(lo, ctr):
            if ctr > lo:
                fb[i, j] = (j - lo) / (ctr - lo)
        for j in range(ctr, hi):
            if hi > ctr:
                fb[i, j] = (hi - j) / (hi - ctr)
    return fb


def _chroma_map(n_fft: int, sr: int) -> np.ndarray:
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    cmap = np.zeros((12, len(freqs)))
    valid = freqs > 27.5
    pitch = np.zeros(len(freqs))
    pitch[valid] = np.mod(
        np.round(12 * np.log2(freqs[valid] / 440.0)) + 9, 12)
    for c in range(12):
        cmap[c, valid & (pitch == c)] = 1.0
    return cmap


def short_term_features(signal: np.ndarray, sr: int = SAMPLE_RATE,
                        frame_sec: float = 0.050,
                        hop_sec: float = 0.025) -> np.ndarray:
    """[n_frames, 34] feature matrix (layout per FEATURE_NAMES)."""
    signal = np.asarray(signal, np.float64).ravel()
    peak = np.abs(signal).max()
    if peak > 0:
        signal = signal / peak
    frame_len = int(frame_sec * sr)
    hop = int(hop_sec * sr)
    if len(signal) < frame_len:
        signal = np.pad(signal, (0, frame_len - len(signal)))
    frames = _frame(signal, frame_len, hop)
    n_fft = frame_len
    win = np.hamming(frame_len)
    spec = np.abs(np.fft.rfft(frames * win, axis=1))
    spec_n = spec / np.maximum(spec.sum(axis=1, keepdims=True), 1e-12)
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sr)

    zcr = np.mean(np.abs(np.diff(np.sign(frames), axis=1)) > 0, axis=1)
    energy = np.mean(frames ** 2, axis=1)
    # energy entropy over 10 sub-frames (trim to a multiple of 10)
    trim = (frame_len // 10) * 10
    sub = frames[:, :trim].reshape(frames.shape[0], 10, -1)
    sub_e = np.sum(sub ** 2, axis=2)
    sub_p = sub_e / np.maximum(sub_e.sum(axis=1, keepdims=True), 1e-12)
    energy_entropy = -np.sum(sub_p * np.log2(sub_p + 1e-12), axis=1)
    centroid = np.sum(freqs[None, :] * spec_n, axis=1)
    spread = np.sqrt(np.sum(((freqs[None, :] - centroid[:, None]) ** 2)
                            * spec_n, axis=1))
    spectral_entropy = -np.sum(spec_n * np.log2(spec_n + 1e-12), axis=1)
    flux = np.concatenate(
        [[0.0], np.sum(np.diff(spec_n, axis=0) ** 2, axis=1)])
    cum = np.cumsum(spec ** 2, axis=1)
    total = np.maximum(cum[:, -1:], 1e-12)
    rolloff_bin = np.argmax(cum >= 0.90 * total, axis=1)
    rolloff = freqs[rolloff_bin] / (sr / 2)

    fb = _mel_filterbank(26, n_fft, sr)
    mel_e = np.log(np.maximum(spec ** 2 @ fb.T, 1e-12))
    # 13 MFCCs via DCT-II of the log-mel energies
    k = np.arange(26)
    dct = np.cos(np.pi * np.outer(np.arange(13), (2 * k + 1)) / (2 * 26))
    mfcc = mel_e @ dct.T

    cmap = _chroma_map(n_fft, sr)
    chroma = (spec ** 2) @ cmap.T
    chroma = chroma / np.maximum(chroma.sum(axis=1, keepdims=True), 1e-12)
    chroma_std = chroma.std(axis=1)

    feats = np.column_stack([
        zcr, energy, energy_entropy, centroid / (sr / 2), spread / (sr / 2),
        spectral_entropy, flux, rolloff, mfcc, chroma, chroma_std])
    assert feats.shape[1] == NUM_FEATURES
    return feats


def clip_features(signal: np.ndarray, sr: int = SAMPLE_RATE) -> np.ndarray:
    """[68] per-clip vector: mean + std of each short-term feature
    (the reference aggregates clips the same way for SVM training)."""
    st = short_term_features(signal, sr)
    return np.concatenate([st.mean(axis=0), st.std(axis=0)])


def embed_features(x: np.ndarray, method: str = "pca",
                   n_components: int = 2, seed: int = 0) -> np.ndarray:
    """2-D embedding of clip feature vectors for visual inspection
    (the reference's t-SNE/PCA plots in scripts/features.py)."""
    x = np.asarray(x, np.float64)
    mu = x.mean(axis=0)
    sd = x.std(axis=0)
    sd[sd == 0] = 1.0
    xs = (x - mu) / sd
    if method == "pca":
        u, s, vt = np.linalg.svd(xs, full_matrices=False)
        return u[:, :n_components] * s[:n_components]
    if method == "tsne":
        try:
            from sklearn.manifold import TSNE
        except ImportError as e:
            raise RuntimeError("t-SNE needs scikit-learn") from e
        per = min(30.0, max(2.0, (len(xs) - 1) / 3))
        return TSNE(n_components=n_components, random_state=seed,
                    perplexity=per, init="pca").fit_transform(xs)
    raise ValueError(f"unknown embedding method {method!r}")
