"""Host-side audio preprocessing: kaldi-compatible log-mel fbank + the
BEATs eval-mode framing (the port's copy of
modelcompose_tpu/data/audio_processing.py, numpy path only: the C++ fbank
of the JAX package's native library is not carried over).

Rebuild of the reference's ``BeatsAudioProcessor`` (reference:
modelcompose/model/multimodal_encoder/beats/audio_processor.py:36-175),
which calls ``torchaudio.compliance.kaldi.fbank(num_mel_bins=128,
frame_length=25, frame_shift=10)``.  torchaudio is not in this image, so the
kaldi pipeline is implemented in numpy with the same defaults: snip-edges
framing, DC removal, preemphasis 0.97, povey window, power spectrum on a
512-point FFT, kaldi mel banks (low 20 Hz, high nyquist), log with eps
floor.  Normalization (x - 15.41663) / (2 * 6.55582) matches the reference
constants (audio_processor.py:12-22).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

FBANK_MEAN = 15.41663
FBANK_STD = 6.55582
SAMPLE_RATE = 16000


def _mel(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def kaldi_mel_banks(num_bins: int, fft_size: int, sample_rate: int,
                    low_freq: float = 20.0,
                    high_freq: float = 0.0) -> np.ndarray:
    """Kaldi-style triangular mel filters over FFT bins, [num_bins,
    fft_size // 2] (nyquist bin excluded, as torchaudio does)."""
    nyquist = sample_rate / 2.0
    if high_freq <= 0:
        high_freq = nyquist + high_freq
    num_fft_bins = fft_size // 2
    fft_bin_width = sample_rate / fft_size
    mel_low = _mel(low_freq)
    mel_high = _mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bins = np.zeros((num_bins, num_fft_bins), np.float32)
    fft_freqs = fft_bin_width * np.arange(num_fft_bins)
    mel_freqs = _mel(fft_freqs)
    for j in range(num_bins):
        left = mel_low + j * mel_delta
        center = mel_low + (j + 1) * mel_delta
        right = mel_low + (j + 2) * mel_delta
        up = (mel_freqs - left) / (center - left)
        down = (right - mel_freqs) / (right - center)
        bins[j] = np.maximum(0.0, np.minimum(up, down))
    return bins


def kaldi_fbank(waveform: np.ndarray, num_mel_bins: int = 128,
                sample_frequency: int = SAMPLE_RATE,
                frame_length_ms: float = 25.0,
                frame_shift_ms: float = 10.0,
                preemphasis: float = 0.97,
                remove_dc_offset: bool = True,
                window_type: str = "povey") -> np.ndarray:
    """waveform: [N] float (kaldi scale, i.e. x * 2**15) -> [T, bins]
    log-mel features in numpy.  window_type: 'povey' (BEATs) or 'hanning'
    (ImageBind, reference: data/data.py:30-40)."""
    win = int(sample_frequency * frame_length_ms / 1000)   # 400
    hop = int(sample_frequency * frame_shift_ms / 1000)    # 160
    n = len(waveform)
    if n < win:
        return np.zeros((0, num_mel_bins), np.float32)
    num_frames = 1 + (n - win) // hop
    idx = np.arange(win)[None, :] + hop * np.arange(num_frames)[:, None]
    frames = waveform[idx].astype(np.float64)

    if remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if preemphasis:
        shifted = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - preemphasis * shifted
    m = np.arange(win)
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * m / (win - 1))
    window = hann ** 0.85 if window_type == "povey" else hann
    frames = frames * window

    fft_size = 1 << (win - 1).bit_length()  # round up to power of two: 512
    spec = np.fft.rfft(frames, n=fft_size)
    power = (spec.real ** 2 + spec.imag ** 2)

    banks = kaldi_mel_banks(num_mel_bins, fft_size, sample_frequency)
    mel = power[:, :fft_size // 2] @ banks.T
    eps = np.finfo(np.float32).eps
    return np.log(np.maximum(mel, eps)).astype(np.float32)


class BeatsAudioProcessor:
    """Waveform/path -> (frames [n_windows*512, 128], padding_mask).

    Eval-mode framing (reference: audio_processor.py:160-175): pad the fbank
    to a multiple of 512 frames and emit every window; 30 s cap.
    """

    def __init__(self, sampling_rate: int = SAMPLE_RATE, n_frames: int = 2,
                 frame_length: int = 512, is_eval: bool = True,
                 num_mel_bins: int = 128):
        self.sampling_rate = sampling_rate
        self.n_frames = n_frames
        self.frame_length = frame_length
        self.num_mel_bins = num_mel_bins
        self.fbank_mean = FBANK_MEAN
        self.fbank_std = FBANK_STD
        self.is_eval = is_eval

    def _load_audio(self, path: str) -> np.ndarray:
        if isinstance(path, np.ndarray):
            return path
        if str(path).endswith(".npy"):
            return np.load(path).astype(np.float32)
        if str(path).endswith(".wav"):
            import wave
            with wave.open(str(path), "rb") as w:
                n = w.getnframes()
                sw = w.getsampwidth()
                data = w.readframes(n)
                dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[sw]
                arr = np.frombuffer(data, dtype=dtype).astype(np.float32)
                if sw == 1:
                    arr = arr - 128.0  # 8-bit PCM is UNSIGNED, midpoint 128
                if w.getnchannels() > 1:
                    arr = arr.reshape(-1, w.getnchannels()).mean(axis=1)
                arr = arr / float(1 << (8 * sw - 1))
                if w.getframerate() != self.sampling_rate:
                    # linear resample (host-side; ffmpeg path preferred
                    # for production)
                    src = w.getframerate()
                    t_new = np.arange(int(len(arr) * self.sampling_rate /
                                          src)) * (src / self.sampling_rate)
                    arr = np.interp(t_new, np.arange(len(arr)), arr)
                return arr.astype(np.float32)
        raise ValueError(f"unsupported audio input: {path!r}")

    def _empty(self) -> Tuple[np.ndarray, np.ndarray]:
        n = self.n_frames * self.frame_length
        return (np.zeros((n, self.num_mel_bins), np.float32),
                np.zeros((n,), bool))

    def process_one(self, au) -> Tuple[np.ndarray, np.ndarray]:
        try:
            waveform = self._load_audio(au)
        except Exception:
            return self._empty()
        if len(waveform) > 30 * self.sampling_rate:
            waveform = waveform[:30 * self.sampling_rate]
        fbank = kaldi_fbank(waveform * (2 ** 15),
                            num_mel_bins=self.num_mel_bins)
        if fbank.shape[0] == 0:
            return self._empty()
        fbank = (fbank - self.fbank_mean) / (2 * self.fbank_std)

        FL = self.frame_length
        if not self.is_eval:
            target = FL * self.n_frames
            if fbank.shape[0] < target:
                fbank = np.pad(fbank, ((0, target - fbank.shape[0]), (0, 0)))
            fbank = fbank[:target]
        else:
            extra = fbank.shape[0] % FL
            if extra > 0:
                fbank = np.pad(fbank, ((0, FL - extra), (0, 0)))
        padding_mask = np.zeros((fbank.shape[0],), bool)
        return fbank.astype(np.float32), padding_mask

    def __call__(self, aupaths: Union[str, np.ndarray, Sequence]
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Batch: pad to the longest clip; padded frames get mask=True
        (reference: audio_processor.py:97-110)."""
        if not isinstance(aupaths, (list, tuple)):
            aupaths = [aupaths]
        feats, masks = zip(*[self.process_one(a) for a in aupaths])
        max_len = max(f.shape[0] for f in feats)
        out_f = np.zeros((len(feats), max_len, self.num_mel_bins),
                         np.float32)
        out_m = np.ones((len(feats), max_len), bool)
        for i, (f, m) in enumerate(zip(feats, masks)):
            out_f[i, :f.shape[0]] = f
            out_m[i, :m.shape[0]] = m
        return out_f, out_m


def collate_audio_inputs(proc, items):
    """Normalize the two audio-processor protocols for the collate/serve
    paths (reference splits the same way: multimodal_arch.py:211-235 —
    ImageBind audio is stacked clips fed straight to the encoder, BEATs
    is (fbank, padding_mask) kwargs):

    - BEATs-style processors return ``(features, padding_mask)`` ->
      encode kwargs dict;
    - ImageBind-style processors return one stacked array -> passed as
      the positional encoder input.

    ``MultimodalLM.encode_modal_inputs`` dispatches on dict-vs-array, so
    this is the ONLY place the protocol split needs to live host-side.
    """
    out = proc(items)
    if isinstance(out, tuple):
        feats, mask = out
        return {"audio_inputs": feats, "audio_padding_mask": mask}
    return np.asarray(out)
