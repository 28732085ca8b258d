"""Figure builders: waveform / spectrogram / mask inspection montages.

Counterpart of `guided_vae_nmf_tpu/viz/figures.py`, itself the capability
of reference python/visualization.py:8-326 (display_waveplot,
display_spectrogram, display_power_spectro, display_wav_spectro_mask,
display_multiple_signals, display_multiple_spectro). `power_to_db` and
`_broadcast_mask` are copies. The builders take the same arguments, lay
out the same panels (waveform, dB spectrogram, mask; colour bars beside
the montage's images) with the same display conventions (magma colour
map, -40 / 20 dB limits in the montage builders, VAD rows broadcast to
all bins), and return a :class:`Figure`.

The JAX package draws with matplotlib; the port rasterises with numpy and
Pillow, so figures render where matplotlib is not installed (the GPU
machines the port runs on have Pillow and no matplotlib). A
:class:`Figure` is sized in inches like matplotlib's and rendered at
`savefig`'s dpi; its magma table is matplotlib's, to 8 bits.
"""

import numpy as np

FS = 16000

# matplotlib's "magma" colour map, 256 RGB entries (8 bits each)
_MAGMA_HEX = (
    "00000401000501010601010802010902020b02020d03030f030312040414050416060518"
    "06051a07061c08071e0907200a08220b09240c09260d0a290e0b2b100b2d110c2f120d31"
    "130d34140e36150e38160f3b180f3d19103f1a10421c10441d11471e114920114b21114e"
    "22115024125325125527125829115a2a115c2c115f2d11612f1163311165331067341069"
    "36106b38106c390f6e3b0f703d0f713f0f72400f74420f75440f76451077471078491078"
    "4a10794c117a4e117b4f127b51127c52137c54137d56147d57157e59157e5a167e5c167f"
    "5d177f5f187f601880621980641a80651a80671b80681c816a1c816b1d816d1d816e1e81"
    "701f81721f817320817521817621817822817922827b23827c23827e2482802582812581"
    "8326818426818627818827818928818b29818c29818e2a81902a81912b81932b80942c80"
    "962c80982d80992d809b2e7f9c2e7f9e2f7fa02f7fa1307ea3307ea5317ea6317da8327d"
    "aa337dab337cad347cae347bb0357bb2357bb3367ab5367ab73779b83779ba3878bc3978"
    "bd3977bf3a77c03a76c23b75c43c75c53c74c73d73c83e73ca3e72cc3f71cd4071cf4070"
    "d0416fd2426fd3436ed5446dd6456cd8456cd9466bdb476adc4869de4968df4a68e04c67"
    "e24d66e34e65e44f64e55064e75263e85362e95462ea5661eb5760ec5860ed5a5fee5b5e"
    "ef5d5ef05f5ef1605df2625df2645cf3655cf4675cf4695cf56b5cf66c5cf66e5cf7705c"
    "f7725cf8745cf8765cf9785df9795df97b5dfa7d5efa7f5efa815ffb835ffb8560fb8761"
    "fc8961fc8a62fc8c63fc8e64fc9065fd9266fd9467fd9668fd9869fd9a6afd9b6bfe9d6c"
    "fe9f6dfea16efea36ffea571fea772fea973feaa74feac76feae77feb078feb27afeb47b"
    "feb67cfeb77efeb97ffebb81febd82febf84fec185fec287fec488fec68afec88cfeca8d"
    "fecc8ffecd90fecf92fed194fed395fed597fed799fed89afdda9cfddc9efddea0fde0a1"
    "fde2a3fde3a5fde5a7fde7a9fde9aafdebacfcecaefceeb0fcf0b2fcf2b4fcf4b6fcf6b8"
    "fcf7b9fcf9bbfcfbbdfcfdbf"
)
MAGMA = np.frombuffer(bytes.fromhex("".join(_MAGMA_HEX)),
                      np.uint8).reshape(256, 3)
_BLACK, _WHITE, _LINE = (0, 0, 0), (255, 255, 255), (31, 119, 180)


def power_to_db(S, ref=1.0, amin=1e-10, top_db=80.0):
    """10*log10(S/ref) with amin flooring and top_db range limiting (the
    librosa.power_to_db convention the reference relies on)."""
    S = np.asarray(S)
    log_spec = 10.0 * np.log10(np.maximum(amin, S))
    log_spec -= 10.0 * np.log10(np.maximum(amin, ref))
    if top_db is not None:
        log_spec = np.maximum(log_spec, log_spec.max() - top_db)
    return log_spec


def _extent(n_frames, fs=FS, hop=256, n_bins=513):
    return [0, n_frames * hop / fs, 0, fs / 2 / 1000.0]  # sec x kHz


def _broadcast_mask(mask, n_bins=513):
    """VAD rows (1, frames) are broadcast to all bins for display
    (reference visualization.py:73-75)."""
    mask = np.asarray(mask)
    if mask.shape[0] == 1:
        mask = np.repeat(mask, n_bins, axis=0)
    return mask


def colorize(data, vmin, vmax):
    """(rows, cols) values -> (rows, cols, 3) uint8 through magma, clipped
    to [vmin, vmax]; NaN maps to vmin."""
    v = (np.asarray(data, np.float64) - vmin) / (vmax - vmin)
    v = np.nan_to_num(np.clip(v, 0.0, 1.0))
    return MAGMA[np.minimum((v * 256).astype(np.int64), 255)]


def grid(nrows, ncols, height_ratios=None, width_ratios=None, hspace=0.2,
         wspace=0.2, left=0.125, right=0.9, bottom=0.11, top=0.88):
    """Cell boxes (x0, y0, x1, y1), figure fractions from the top left, of
    a GridSpec-like layout (matplotlib's default margins); `cells[r][c]`."""
    hr = np.asarray(height_ratios or [1] * nrows, np.float64)
    wr = np.asarray(width_ratios or [1] * ncols, np.float64)

    def spans(ratios, lo, hi, space):
        n = len(ratios)
        cell = (hi - lo) / (n + space * (n - 1))
        sizes = cell * n * ratios / ratios.sum()
        gap = cell * space
        starts = lo + np.concatenate([[0.0], np.cumsum(sizes + gap)[:-1]])
        return list(zip(starts, starts + sizes))

    rows = spans(hr, 1.0 - top, 1.0 - bottom, hspace)
    cols = spans(wr, left, right, wspace)
    return [[(c0, r0, c1, r1) for c0, c1 in cols] for r0, r1 in rows]


class Figure:
    """A raster figure of panels: waveforms, images and colour bars in
    boxes given as figure fractions, with titles and axis labels. Sized in
    inches; :meth:`savefig` renders it at a dpi and writes any format
    Pillow writes (by the file's extension)."""

    def __init__(self, figsize=(6.4, 4.8), fontsize=10):
        self.figsize = figsize
        self.fontsize = fontsize
        self.panels = []
        self.title = None

    def suptitle(self, text):
        self.title = str(text)

    def wave(self, box, x, fs=FS, ylim=None, title=None, xlabel=None,
             ylabel=None):
        """A waveform over [0, len(x) / fs] s; y limits from the data
        unless `ylim`."""
        x = np.asarray(x, np.float64)
        if ylim is None:
            lo, hi = (float(x.min()), float(x.max())) if len(x) else (0, 1)
            pad = 0.05 * (hi - lo or 1.0)
            ylim = (lo - pad, hi + pad)
        self.panels.append(dict(kind="wave", box=box, x=x, ylim=ylim,
                                title=title, xlabel=xlabel, ylabel=ylabel,
                                xrange=(0.0, len(x) / fs)))

    def image(self, box, data, vmin, vmax, extent=None, title=None,
              xlabel=None, ylabel=None):
        """An image of `data` (rows, cols) with row 0 at the bottom (the
        frequency axis up), coloured by magma over [vmin, vmax]; `extent`
        [x0, x1, y0, y1] labels the axes."""
        self.panels.append(dict(kind="image", box=box,
                                rgb=colorize(data, vmin, vmax)[::-1],
                                extent=extent, title=title, xlabel=xlabel,
                                ylabel=ylabel))

    def colorbar(self, box, vmin, vmax):
        ramp = np.linspace(vmin, vmax, 256)[:, None]
        self.panels.append(dict(kind="image", box=box,
                                rgb=colorize(ramp, vmin, vmax)[::-1],
                                extent=[0, 1, vmin, vmax], title=None,
                                xlabel=None, ylabel=None, bar=True))

    def render(self, dpi=100):
        """The figure as an (H, W, 3) uint8 array."""
        from PIL import Image, ImageDraw, ImageFont

        W = max(1, int(round(self.figsize[0] * dpi)))
        H = max(1, int(round(self.figsize[1] * dpi)))
        img = Image.new("RGB", (W, H), _WHITE)
        draw = ImageDraw.Draw(img)
        font = ImageFont.load_default(
            size=max(8, round(self.fontsize * dpi / 72)))
        for p in self.panels:
            x0, y0, x1, y1 = (int(round(f * s)) for f, s in
                              zip(p["box"], (W, H, W, H)))
            w, h = max(1, x1 - x0), max(1, y1 - y0)
            if p["kind"] == "wave":
                img.paste(Image.fromarray(_wave_pixels(p["x"], p["ylim"],
                                                       w, h)), (x0, y0))
                xr, yr = p["xrange"], p["ylim"]
            else:
                img.paste(Image.fromarray(p["rgb"]).resize(
                    (w, h), Image.Resampling.BILINEAR), (x0, y0))
                e = p["extent"] or [0, p["rgb"].shape[1], 0,
                                    p["rgb"].shape[0]]
                xr, yr = e[:2], e[2:]
            draw.rectangle([x0 - 1, y0 - 1, x0 + w, y0 + h], outline=_BLACK)
            if p.get("bar"):
                draw.text((x0 + w + 3, y0), f"{yr[1]:g}", fill=_BLACK,
                          font=font, anchor="lt")
                draw.text((x0 + w + 3, y0 + h), f"{yr[0]:g}", fill=_BLACK,
                          font=font, anchor="lb")
                continue
            for v, anchor, xy in ((xr[0], "lt", (x0, y0 + h + 2)),
                                  (xr[1], "rt", (x0 + w, y0 + h + 2))):
                draw.text(xy, f"{v:.3g}", fill=_BLACK, font=font,
                          anchor=anchor)
            for v, anchor, xy in ((yr[0], "rb", (x0 - 3, y0 + h)),
                                  (yr[1], "rt", (x0 - 3, y0))):
                draw.text(xy, f"{v:.3g}", fill=_BLACK, font=font,
                          anchor=anchor)
            if p["title"]:
                draw.text((x0 + w // 2, y0 - 3), p["title"], fill=_BLACK,
                          font=font, anchor="mb")
            if p["xlabel"]:
                draw.text((x0 + w // 2, y0 + h + 2), p["xlabel"],
                          fill=_BLACK, font=font, anchor="mt")
            if p["ylabel"]:
                label = Image.new("RGB", (h, font.size + 4), _WHITE)
                ImageDraw.Draw(label).text((h // 2, 0), p["ylabel"],
                                           fill=_BLACK, font=font,
                                           anchor="mt")
                img.paste(label.rotate(90, expand=True),
                          (max(0, x0 - 3 * font.size - 8), y0))
        if self.title:
            draw.text((W // 2, 4), self.title, fill=_BLACK, font=font,
                      anchor="mt")
        return np.asarray(img)

    def savefig(self, path, dpi=100):
        from PIL import Image

        Image.fromarray(self.render(dpi)).save(path)


def _wave_pixels(x, ylim, w, h):
    """A waveform drawn as one vertical stroke a pixel column, from the
    column's lowest to its highest sample."""
    out = np.full((h, w, 3), 255, np.uint8)
    if len(x) == 0:
        return out
    edges = np.linspace(0, len(x), w + 1).astype(np.int64)
    cols = np.flatnonzero(edges[1:] > edges[:-1])
    starts = edges[cols]
    lo = np.minimum.reduceat(x, starts)
    hi = np.maximum.reduceat(x, starts)
    span = (ylim[1] - ylim[0]) or 1.0

    def row(v):
        return np.clip(((ylim[1] - v) / span * (h - 1)).round(), 0,
                       h - 1).astype(np.int64)

    top, bot = row(hi), row(lo)
    r = np.arange(h)[:, None]
    on = (r >= top[None, :]) & (r <= bot[None, :])
    sub = out[:, cols]
    sub[on] = _LINE
    out[:, cols] = sub
    return out


def _hop(wlen_sec, hop_percent, fs):
    return int(hop_percent * wlen_sec * fs)


def _single(fontsize):
    fig = Figure(fontsize=fontsize / 5)
    return fig, grid(1, 1)[0][0]


def display_waveplot(x, fs=FS, ymax=1.0, ymin=-1.0, xticks_sec=1.0,
                     fontsize=50):
    """Amplitude-vs-time waveform plot (reference visualization.py:8-42).
    `xticks_sec` is accepted for the reference's signature; the axes carry
    their end values."""
    fig, box = _single(fontsize)
    fig.wave(box, x, fs, ylim=(ymin, ymax), xlabel="Time (s)",
             ylabel="Amplitude")
    return fig


def display_spectrogram(complex_spec, convert_to_db=False, fs=FS, vmin=-60,
                        vmax=10, wlen_sec=64e-3, hop_percent=0.25,
                        xticks_sec=1.0, cmap="magma", fontsize=50):
    """Magnitude (optionally dB) spectrogram image (reference
    visualization.py:44-105). magma is the one colour map."""
    spec = np.abs(complex_spec)
    if convert_to_db:
        spec = power_to_db(spec**2)
    return display_power_spectro(spec, False, fs, vmin, vmax, wlen_sec,
                                 hop_percent, cmap, fontsize)


def display_power_spectro(psd, convert_to_db=False, fs=FS, vmin=-60, vmax=10,
                          wlen_sec=64e-3, hop_percent=0.25, cmap="magma",
                          fontsize=50):
    """Power spectrogram image (reference visualization.py:107-155)."""
    spec = np.asarray(psd)
    if convert_to_db:
        spec = power_to_db(spec)
    fig, box = _single(fontsize)
    fig.image(box, spec, vmin, vmax,
              extent=_extent(spec.shape[1], fs,
                             _hop(wlen_sec, hop_percent, fs), spec.shape[0]),
              xlabel="Time (s)", ylabel="Frequency (kHz)")
    return fig


def display_wav_spectro_mask(x, x_tf, x_ibm, fs=FS, vmin=-40, vmax=20,
                             wlen_sec=64e-3, hop_percent=0.25,
                             cmap="magma"):
    """3-row montage: waveform / dB spectrogram / mask, colour bars beside
    the two images (reference visualization.py:157-199)."""
    fig = Figure((20, 25), fontsize=24)
    cells = grid(3, 2, height_ratios=[3, 10, 10], width_ratios=[10, 0.5],
                 wspace=0.1, hspace=0.3)
    ext = _extent(x_tf.shape[1], fs, _hop(wlen_sec, hop_percent, fs))
    fig.wave(cells[0][0], x, fs, ylabel="Amplitude")
    fig.image(cells[1][0], power_to_db(np.abs(x_tf) ** 2), vmin, vmax,
              extent=ext, ylabel="Frequency (kHz)")
    fig.colorbar(cells[1][1], vmin, vmax)
    fig.image(cells[2][0], _broadcast_mask(x_ibm), 0, 1, extent=ext,
              ylabel="Frequency (kHz)", xlabel="Time (s)")
    fig.colorbar(cells[2][1], 0, 1)
    return fig


def display_multiple_signals(signal_list, fs=FS, vmin=-40, vmax=20,
                             wlen_sec=64e-3, hop_percent=0.25,
                             titles=None, cmap="magma"):
    """Side-by-side (waveform, spectrogram, mask) columns for several
    signals: the per-utterance metric figure (reference
    visualization.py:201-269; used by run_metrics_M2.py:174-200).

    signal_list: list of [x_time, x_tf, mask_or_None]."""
    nb = len(signal_list)
    fig = Figure((10 * nb, 15), fontsize=20)
    cells = grid(3, nb, hspace=0.3, wspace=0.2)
    hop = _hop(wlen_sec, hop_percent, fs)
    for i, (x_t, x_tf, mask) in enumerate(signal_list):
        ext = _extent(x_tf.shape[1], fs, hop)
        fig.wave(cells[0][i], x_t, fs, title=titles[i] if titles else None)
        fig.image(cells[1][i], power_to_db(np.abs(x_tf) ** 2), vmin, vmax,
                  extent=ext)
        if mask is not None:
            fig.image(cells[2][i], _broadcast_mask(mask), 0, 1, extent=ext)
    return fig


def display_multiple_spectro(signal_list, fs=FS, vmin=-40, vmax=20,
                             wlen_sec=64e-3, hop_percent=0.25,
                             titles=None, cmap="magma"):
    """Waveform + spectrogram rows only (reference
    visualization.py:271-326)."""
    nb = len(signal_list)
    fig = Figure((10 * nb, 10), fontsize=20)
    cells = grid(2, nb, hspace=0.3, wspace=0.2)
    hop = _hop(wlen_sec, hop_percent, fs)
    for i, (x_t, x_tf) in enumerate(signal_list):
        fig.wave(cells[0][i], x_t, fs, title=titles[i] if titles else None)
        fig.image(cells[1][i], power_to_db(np.abs(x_tf) ** 2), vmin, vmax,
                  extent=_extent(x_tf.shape[1], fs, hop))
    return fig
