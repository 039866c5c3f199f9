// adepth_io — native host-side data runtime of the PyTorch/CUDA port
// (a copy of the JAX package's native/adepth_io.cpp, kept in the port so
// that neither package reads the other's files).
//
// The training loop's host work is decode + resize + transport-encode. This
// library does the whole sample prep in C++ with the GIL released:
//   * RIFF/WAV PCM16 decode straight into the int16 transport form
//     (data/codec.py's exact dtype — no float detour),
//   * .npy depth decode (f4/f8/u2/i2) with mm→m, clip-to-max, negative→0,
//     cv2-exact INTER_NEAREST resize (src = floor(dst·in/out)), and uint16
//     fixed-point encode at scale 65535/max_units,
//   * a std::thread pool assembling whole batches in parallel.
//
// Interface is plain C (ctypes-friendly). data/native_io.py builds it at
// first use with
//   g++ -O3 -shared -fPIC -std=c++17 -o libadepth_io-<hash>.so adepth_io.cpp -lpthread
// into build/native/ at the root of the checkout, and raises if the build fails.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <cmath>
#include <string>
#include <vector>
#include <thread>
#include <atomic>

namespace {

// ---------------------------------------------------------------------------
// small file reader
// ---------------------------------------------------------------------------
struct FileBuf {
    std::vector<uint8_t> data;
    bool ok = false;
};

FileBuf read_file(const char* path) {
    FileBuf fb;
    FILE* f = std::fopen(path, "rb");
    if (!f) return fb;
    std::fseek(f, 0, SEEK_END);
    long n = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    if (n <= 0) { std::fclose(f); return fb; }
    fb.data.resize(static_cast<size_t>(n));
    fb.ok = std::fread(fb.data.data(), 1, static_cast<size_t>(n), f) ==
            static_cast<size_t>(n);
    std::fclose(f);
    return fb;
}

uint32_t rd_u32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}
uint16_t rd_u16(const uint8_t* p) {
    uint16_t v;
    std::memcpy(&v, p, 2);
    return v;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// WAV → int16 [channels, n_samples] (deinterleaved), cut/zero-padded to
// fixed_len per channel. Returns 0 on success.
//
// Formats (matching the reference's 4-backend decode-chain tolerance,
// BatvisionV2_Dataset.py:142-175, reduced to the int16 transport form):
//   PCM16            — exact copy
//   PCM24 / PCM32    — rounded to the top 16 bits ((v + half) >> shift),
//                      identical to round(float_sample * 32768) of the
//                      normalized float the python chain produces
//   IEEE float32     — clamp [-1, 1], round(f * 32768)
//   WAVE_FORMAT_EXTENSIBLE — resolved via the SubFormat GUID's format code
// ---------------------------------------------------------------------------
namespace {

inline int16_t clamp_i16(long v) {
    if (v > 32767) return 32767;
    if (v < -32768) return -32768;
    return static_cast<int16_t>(v);
}

}  // namespace

int adepth_decode_wav_i16(const char* path, int16_t* out, int64_t fixed_len,
                          int32_t* out_channels, int32_t* out_sr) {
    FileBuf fb = read_file(path);
    if (!fb.ok || fb.data.size() < 44) return 1;
    const uint8_t* p = fb.data.data();
    if (std::memcmp(p, "RIFF", 4) != 0 || std::memcmp(p + 8, "WAVE", 4) != 0)
        return 2;

    size_t off = 12;
    int channels = 0, sr = 0, bits = 0, fmt = 0;
    const uint8_t* pcm = nullptr;
    size_t pcm_bytes = 0;
    while (off + 8 <= fb.data.size()) {
        uint32_t sz = rd_u32(p + off + 4);
        if (std::memcmp(p + off, "fmt ", 4) == 0 && off + 8 + 16 <= fb.data.size()) {
            fmt = rd_u16(p + off + 8);
            channels = rd_u16(p + off + 10);
            sr = static_cast<int>(rd_u32(p + off + 12));
            bits = rd_u16(p + off + 22);
            // WAVE_FORMAT_EXTENSIBLE: the real format code is the first u16
            // of the SubFormat GUID (fmt struct offset 24)
            if (fmt == 0xFFFE && sz >= 40 && off + 8 + 26 <= fb.data.size())
                fmt = rd_u16(p + off + 8 + 24);
        } else if (std::memcmp(p + off, "data", 4) == 0) {
            pcm = p + off + 8;
            pcm_bytes = sz;
            if (off + 8 + pcm_bytes > fb.data.size())
                pcm_bytes = fb.data.size() - off - 8;
        }
        off += 8 + sz + (sz & 1);  // chunks are 2-byte aligned
    }
    if (!pcm || channels < 1) return 3;
    const bool pcm16 = (fmt == 1 && bits == 16);
    const bool pcm24 = (fmt == 1 && bits == 24);
    const bool pcm32 = (fmt == 1 && bits == 32);
    const bool f32 = (fmt == 3 && bits == 32);
    if (!pcm16 && !pcm24 && !pcm32 && !f32) return 3;
    const size_t bytes_per = static_cast<size_t>(bits) / 8;

    int64_t n = static_cast<int64_t>(pcm_bytes / (bytes_per * channels));
    int64_t m = n < fixed_len ? n : fixed_len;
    for (int c = 0; c < channels; ++c) {
        int16_t* dst = out + static_cast<int64_t>(c) * fixed_len;
        if (pcm16) {
            const int16_t* s = reinterpret_cast<const int16_t*>(pcm);
            for (int64_t i = 0; i < m; ++i) dst[i] = s[i * channels + c];
        } else if (pcm24) {
            for (int64_t i = 0; i < m; ++i) {
                const uint8_t* b = pcm + (i * channels + c) * 3;
                long v = static_cast<long>(
                    (static_cast<int32_t>(static_cast<int8_t>(b[2])) << 16) |
                    (b[1] << 8) | b[0]);
                dst[i] = clamp_i16((v + 128) >> 8);
            }
        } else if (pcm32) {
            const int32_t* s = reinterpret_cast<const int32_t*>(pcm);
            for (int64_t i = 0; i < m; ++i) {
                long v = static_cast<long>(s[i * channels + c]);
                dst[i] = clamp_i16((v + 32768) >> 16);
            }
        } else {  // IEEE float32
            const float* s = reinterpret_cast<const float*>(pcm);
            for (int64_t i = 0; i < m; ++i) {
                float v = s[i * channels + c];
                if (!std::isfinite(v)) v = 0.0f;
                if (v > 1.0f) v = 1.0f;
                if (v < -1.0f) v = -1.0f;
                dst[i] = clamp_i16(
                    static_cast<long>(std::nearbyint(v * 32768.0f)));
            }
        }
        for (int64_t i = m; i < fixed_len; ++i) dst[i] = 0;
    }
    *out_channels = channels;
    *out_sr = sr;
    return 0;
}

// ---------------------------------------------------------------------------
// .npy depth → uint16 fixed-point [out_h, out_w].
// Pipeline: value→float, NaN/Inf→0, /1000 (mm→m), clip [0, max_depth],
// optional /max_depth (depth_norm), nearest resize (src=floor(dst·in/out)),
// round(units · 65535/max_units).
// Supported descr: <f4 <f8 <u2 <i2 <i4 (C-order, 2-D).
// ---------------------------------------------------------------------------
int adepth_load_depth_u16(const char* path, uint16_t* out, int32_t out_h,
                          int32_t out_w, float max_depth, int32_t depth_norm) {
    FileBuf fb = read_file(path);
    if (!fb.ok || fb.data.size() < 10) return 1;
    const uint8_t* p = fb.data.data();
    if (p[0] != 0x93 || std::memcmp(p + 1, "NUMPY", 5) != 0) return 2;
    int major = p[6];
    size_t hlen, hoff;
    if (major == 1) {
        hlen = rd_u16(p + 8);
        hoff = 10;
    } else {
        hlen = rd_u32(p + 8);
        hoff = 12;
    }
    if (hoff + hlen > fb.data.size()) return 3;
    std::string hdr(reinterpret_cast<const char*>(p + hoff), hlen);

    auto find_val = [&](const char* key) -> std::string {
        size_t k = hdr.find(key);
        if (k == std::string::npos) return "";
        size_t c = hdr.find(':', k);
        return c == std::string::npos ? "" : hdr.substr(c + 1);
    };
    std::string descr = find_val("'descr'");
    size_t q1 = descr.find('\'');
    size_t q2 = descr.find('\'', q1 + 1);
    if (q1 == std::string::npos || q2 == std::string::npos) return 4;
    descr = descr.substr(q1 + 1, q2 - q1 - 1);
    if (hdr.find("'fortran_order': True") != std::string::npos) return 5;

    std::string shp = find_val("'shape'");
    size_t l = shp.find('(');
    size_t r = shp.find(')');
    if (l == std::string::npos || r == std::string::npos) return 6;
    shp = shp.substr(l + 1, r - l - 1);
    long in_h = 0, in_w = 0;
    if (std::sscanf(shp.c_str(), "%ld , %ld", &in_h, &in_w) != 2 &&
        std::sscanf(shp.c_str(), "%ld, %ld", &in_h, &in_w) != 2)
        return 7;
    if (in_h <= 0 || in_w <= 0) return 7;

    const uint8_t* body = p + hoff + hlen;
    size_t body_bytes = fb.data.size() - hoff - hlen;
    size_t count = static_cast<size_t>(in_h) * in_w;

    auto value_at = [&](size_t i) -> float {
        if (descr == "<f4") {
            float v;
            std::memcpy(&v, body + i * 4, 4);
            return v;
        } else if (descr == "<f8") {
            double v;
            std::memcpy(&v, body + i * 8, 8);
            return static_cast<float>(v);
        } else if (descr == "<u2") {
            uint16_t v;
            std::memcpy(&v, body + i * 2, 2);
            return static_cast<float>(v);
        } else if (descr == "<i2") {
            int16_t v;
            std::memcpy(&v, body + i * 2, 2);
            return static_cast<float>(v);
        } else if (descr == "<i4") {
            int32_t v;
            std::memcpy(&v, body + i * 4, 4);
            return static_cast<float>(v);
        }
        return 0.0f;
    };
    size_t isz = (descr == "<f8") ? 8 : (descr == "<f4" || descr == "<i4") ? 4 : 2;
    if (body_bytes < count * isz) return 8;

    float max_units = depth_norm ? 1.0f : max_depth;
    float scale = 65535.0f / max_units;
    for (int32_t yo = 0; yo < out_h; ++yo) {
        // cv2 INTER_NEAREST: src = floor(dst * in / out)
        long ys = static_cast<long>(std::floor(yo * (double)in_h / out_h));
        if (ys >= in_h) ys = in_h - 1;
        for (int32_t xo = 0; xo < out_w; ++xo) {
            long xs = static_cast<long>(std::floor(xo * (double)in_w / out_w));
            if (xs >= in_w) xs = in_w - 1;
            float v = value_at(static_cast<size_t>(ys) * in_w + xs);
            if (!std::isfinite(v)) v = 0.0f;
            v /= 1000.0f;                       // mm → m
            if (v > max_depth) v = max_depth;
            if (v < 0.0f) v = 0.0f;
            if (depth_norm) v /= max_depth;
            float enc = std::nearbyint(v * scale);
            if (enc < 0.0f) enc = 0.0f;
            if (enc > 65535.0f) enc = 65535.0f;
            out[static_cast<size_t>(yo) * out_w + xo] =
                static_cast<uint16_t>(enc);
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Thread-pooled batch assembly: decode B wavs and B depth npys in parallel.
// paths are '\n'-joined; returns 0 iff every item succeeded.
// ---------------------------------------------------------------------------
int adepth_assemble_batch(const char* wav_paths, const char* depth_paths,
                          int32_t batch, int64_t fixed_len, int32_t channels,
                          int32_t out_h, int32_t out_w, float max_depth,
                          int32_t depth_norm, int16_t* wav_out,
                          uint16_t* depth_out, int32_t n_threads) {
    std::vector<std::string> wavs, depths;
    {
        std::string s(wav_paths ? wav_paths : ""), item;
        size_t pos = 0, nl;
        while ((nl = s.find('\n', pos)) != std::string::npos) {
            wavs.push_back(s.substr(pos, nl - pos));
            pos = nl + 1;
        }
        if (pos < s.size()) wavs.push_back(s.substr(pos));
    }
    {
        std::string s(depth_paths ? depth_paths : ""), item;
        size_t pos = 0, nl;
        while ((nl = s.find('\n', pos)) != std::string::npos) {
            depths.push_back(s.substr(pos, nl - pos));
            pos = nl + 1;
        }
        if (pos < s.size()) depths.push_back(s.substr(pos));
    }
    bool do_wav = !wavs.empty();
    if ((do_wav && static_cast<int32_t>(wavs.size()) != batch) ||
        static_cast<int32_t>(depths.size()) != batch)
        return 1;

    std::atomic<int> next(0), failed(0);
    auto worker = [&]() {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= batch) return;
            if (do_wav) {
                int32_t ch = 0, sr = 0;
                if (adepth_decode_wav_i16(
                        wavs[i].c_str(),
                        wav_out + static_cast<int64_t>(i) * channels * fixed_len,
                        fixed_len, &ch, &sr) != 0 ||
                    ch != channels)
                    failed.fetch_add(1);
            }
            if (adepth_load_depth_u16(
                    depths[i].c_str(),
                    depth_out + static_cast<int64_t>(i) * out_h * out_w,
                    out_h, out_w, max_depth, depth_norm) != 0)
                failed.fetch_add(1);
        }
    };
    int nt = n_threads > 0 ? n_threads : 4;
    if (nt > batch) nt = batch;
    std::vector<std::thread> pool;
    for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    return failed.load() == 0 ? 0 : 2;
}

}  // extern "C"
