// Copy of whisper_tpu/native/audioio.cpp, unchanged below this header, so that
// whisper_tpu_torch builds its host library from its own tree.

// Native audio front door: WAV/FLAC decode, downmix to mono, resample.
//
// The reference shells out to the ffmpeg CLI to produce 16 kHz mono f32 PCM
// (reference whisper/audio.py:25-62).  This image has no ffmpeg, so decoding
// is native here: a self-contained FLAC decoder (CONSTANT/VERBATIM/FIXED/LPC
// subframes, Rice residuals, all channel assignments), a RIFF/WAV reader
// (PCM 8/16/24/32-bit and float32), mean-downmix, and a Kaiser-windowed-sinc
// polyphase resampler.  ffmpeg, when present on a host, is still preferred by
// the Python layer for exotic containers; this covers the common lossless
// formats without any subprocess.
//
// C ABI (ctypes):
//   audio_decode_file(path, target_sr, &out_len) -> malloc'd float mono PCM
//   audio_resample(in, n, sr_from, sr_to, &out_len) -> malloc'd float PCM
//   audio_free(ptr)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Bit reader (MSB-first, as used by FLAC)
// ---------------------------------------------------------------------------

struct BitReader {
    const uint8_t* data;
    size_t size;
    size_t byte_pos = 0;
    int bit_pos = 0;  // 0..7, MSB first
    bool error = false;

    BitReader(const uint8_t* d, size_t n) : data(d), size(n) {}

    bool eof() const { return byte_pos >= size; }

    uint32_t read_bit() {
        if (byte_pos >= size) {
            error = true;
            return 0;
        }
        uint32_t bit = (data[byte_pos] >> (7 - bit_pos)) & 1;
        if (++bit_pos == 8) {
            bit_pos = 0;
            ++byte_pos;
        }
        return bit;
    }

    uint64_t read_bits(int n) {
        uint64_t v = 0;
        for (int i = 0; i < n; ++i) v = (v << 1) | read_bit();
        return v;
    }

    int64_t read_signed(int n) {
        uint64_t v = read_bits(n);
        if (n > 0 && (v & (1ull << (n - 1)))) {
            return static_cast<int64_t>(v) - (1ll << n);
        }
        return static_cast<int64_t>(v);
    }

    uint32_t read_unary() {
        uint32_t q = 0;
        while (!error && read_bit() == 0) ++q;
        return q;
    }

    void align_to_byte() {
        if (bit_pos != 0) {
            bit_pos = 0;
            ++byte_pos;
        }
    }
};

// ---------------------------------------------------------------------------
// FLAC
// ---------------------------------------------------------------------------

struct FlacStream {
    uint32_t sample_rate = 0;
    int channels = 0;
    int bits_per_sample = 0;
    uint64_t total_samples = 0;
    std::vector<std::vector<int64_t>> pcm;  // [channel][sample]
};

const int kFlacBlockSizes[16] = {0,   192,  576,   1152,  2304, 4608, -1, -2,
                                 256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
const int kFlacSampleRates[16] = {0,     88200, 176400, 192000, 8000,  16000,
                                  22050, 24000, 32000,  44100,  48000, 96000,
                                  -1,    -2,    -3,     0};

// FLAC frame headers encode the frame index with a UTF-8-style varint.
bool read_utf8_coded(BitReader& br, uint64_t* out) {
    uint32_t b0 = static_cast<uint32_t>(br.read_bits(8));
    int extra;
    uint64_t v;
    if ((b0 & 0x80) == 0) {
        *out = b0;
        return true;
    } else if ((b0 & 0xE0) == 0xC0) {
        extra = 1;
        v = b0 & 0x1F;
    } else if ((b0 & 0xF0) == 0xE0) {
        extra = 2;
        v = b0 & 0x0F;
    } else if ((b0 & 0xF8) == 0xF0) {
        extra = 3;
        v = b0 & 0x07;
    } else if ((b0 & 0xFC) == 0xF8) {
        extra = 4;
        v = b0 & 0x03;
    } else if ((b0 & 0xFE) == 0xFC) {
        extra = 5;
        v = b0 & 0x01;
    } else if (b0 == 0xFE) {
        extra = 6;
        v = 0;
    } else {
        return false;
    }
    for (int i = 0; i < extra; ++i) {
        uint32_t b = static_cast<uint32_t>(br.read_bits(8));
        if ((b & 0xC0) != 0x80) return false;
        v = (v << 6) | (b & 0x3F);
    }
    *out = v;
    return true;
}

bool read_residual(BitReader& br, int block_size, int predictor_order,
                   std::vector<int64_t>& out) {
    int method = static_cast<int>(br.read_bits(2));
    if (method > 1) return false;
    int param_bits = method == 0 ? 4 : 5;
    int escape = method == 0 ? 15 : 31;
    int partition_order = static_cast<int>(br.read_bits(4));
    int partitions = 1 << partition_order;
    if (block_size % partitions != 0) return false;
    int samples_per_partition = block_size >> partition_order;
    int idx = predictor_order;
    for (int p = 0; p < partitions; ++p) {
        int count = samples_per_partition - (p == 0 ? predictor_order : 0);
        if (count < 0) return false;
        int param = static_cast<int>(br.read_bits(param_bits));
        if (param == escape) {
            int raw_bits = static_cast<int>(br.read_bits(5));
            for (int i = 0; i < count; ++i) out[idx++] = br.read_signed(raw_bits);
        } else {
            for (int i = 0; i < count; ++i) {
                uint32_t q = br.read_unary();
                uint64_t r = br.read_bits(param);
                uint64_t zigzag = (static_cast<uint64_t>(q) << param) | r;
                out[idx++] = static_cast<int64_t>(zigzag >> 1) ^
                             -static_cast<int64_t>(zigzag & 1);
            }
        }
        if (br.error) return false;
    }
    return true;
}

bool decode_subframe(BitReader& br, int block_size, int bps,
                     std::vector<int64_t>& out) {
    if (br.read_bit() != 0) return false;  // padding bit must be 0
    int type = static_cast<int>(br.read_bits(6));
    int wasted = 0;
    if (br.read_bit()) wasted = 1 + static_cast<int>(br.read_unary());
    bps -= wasted;

    out.assign(block_size, 0);
    if (type == 0) {  // CONSTANT
        int64_t v = br.read_signed(bps);
        for (int i = 0; i < block_size; ++i) out[i] = v;
    } else if (type == 1) {  // VERBATIM
        for (int i = 0; i < block_size; ++i) out[i] = br.read_signed(bps);
    } else if (type >= 8 && type <= 12) {  // FIXED, order 0-4
        int order = type - 8;
        for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
        if (!read_residual(br, block_size, order, out)) return false;
        // fixed polynomial predictors
        for (int i = order; i < block_size; ++i) {
            switch (order) {
                case 0: break;
                case 1: out[i] += out[i - 1]; break;
                case 2: out[i] += 2 * out[i - 1] - out[i - 2]; break;
                case 3:
                    out[i] += 3 * out[i - 1] - 3 * out[i - 2] + out[i - 3];
                    break;
                case 4:
                    out[i] += 4 * out[i - 1] - 6 * out[i - 2] + 4 * out[i - 3] -
                              out[i - 4];
                    break;
            }
        }
    } else if (type >= 32) {  // LPC, order 1-32
        int order = (type & 31) + 1;
        for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
        int precision = static_cast<int>(br.read_bits(4)) + 1;
        if (precision == 16) return false;  // 0b1111 is invalid
        int shift = static_cast<int>(br.read_signed(5));
        if (shift < 0) return false;
        std::vector<int64_t> coefs(order);
        for (int i = 0; i < order; ++i) coefs[i] = br.read_signed(precision);
        if (!read_residual(br, block_size, order, out)) return false;
        for (int i = order; i < block_size; ++i) {
            int64_t pred = 0;
            for (int j = 0; j < order; ++j) pred += coefs[j] * out[i - 1 - j];
            out[i] += pred >> shift;
        }
    } else {
        return false;  // reserved subframe type
    }

    if (wasted > 0) {
        for (int i = 0; i < block_size; ++i) out[i] <<= wasted;
    }
    return !br.error;
}

bool decode_flac(const uint8_t* data, size_t size, FlacStream* st) {
    if (size < 42 || memcmp(data, "fLaC", 4) != 0) return false;
    size_t pos = 4;
    bool last = false;
    bool have_streaminfo = false;
    while (!last && pos + 4 <= size) {
        last = (data[pos] & 0x80) != 0;
        int type = data[pos] & 0x7F;
        uint32_t len = (static_cast<uint32_t>(data[pos + 1]) << 16) |
                       (static_cast<uint32_t>(data[pos + 2]) << 8) |
                       data[pos + 3];
        pos += 4;
        if (type == 0 && len >= 34) {  // STREAMINFO
            const uint8_t* si = data + pos;
            st->sample_rate = (static_cast<uint32_t>(si[10]) << 12) |
                              (static_cast<uint32_t>(si[11]) << 4) |
                              (si[12] >> 4);
            st->channels = ((si[12] >> 1) & 0x7) + 1;
            st->bits_per_sample = (((si[12] & 1) << 4) | (si[13] >> 4)) + 1;
            st->total_samples =
                (static_cast<uint64_t>(si[13] & 0xF) << 32) |
                (static_cast<uint64_t>(si[14]) << 24) |
                (static_cast<uint64_t>(si[15]) << 16) |
                (static_cast<uint64_t>(si[16]) << 8) | si[17];
            have_streaminfo = true;
        }
        pos += len;
    }
    if (!have_streaminfo || st->sample_rate == 0 || st->channels < 1 ||
        st->channels > 8) {
        return false;
    }

    st->pcm.assign(st->channels, {});
    if (st->total_samples > 0) {
        for (auto& ch : st->pcm) ch.reserve(st->total_samples);
    }

    BitReader br(data, size);
    br.byte_pos = pos;

    std::vector<std::vector<int64_t>> chans(st->channels);
    while (br.byte_pos < size && !br.error) {
        // frame header
        uint32_t sync = static_cast<uint32_t>(br.read_bits(14));
        if (br.error) break;
        if (sync != 0x3FFE) return false;
        br.read_bit();  // reserved
        br.read_bit();  // blocking strategy
        int bs_code = static_cast<int>(br.read_bits(4));
        int sr_code = static_cast<int>(br.read_bits(4));
        int ch_assign = static_cast<int>(br.read_bits(4));
        int ss_code = static_cast<int>(br.read_bits(3));
        br.read_bit();  // reserved
        uint64_t frame_number;
        if (!read_utf8_coded(br, &frame_number)) return false;

        int block_size = kFlacBlockSizes[bs_code];
        if (block_size == -1) {
            block_size = static_cast<int>(br.read_bits(8)) + 1;
        } else if (block_size == -2) {
            block_size = static_cast<int>(br.read_bits(16)) + 1;
        } else if (block_size == 0) {
            return false;
        }
        int sr = kFlacSampleRates[sr_code];
        if (sr == -1) br.read_bits(8);
        else if (sr == -2) br.read_bits(16);
        else if (sr == -3) br.read_bits(16);
        br.read_bits(8);  // CRC-8 (not verified)

        int bps = st->bits_per_sample;
        static const int kSampleSizes[8] = {0, 8, 12, 0, 16, 20, 24, 32};
        if (ss_code != 0 && kSampleSizes[ss_code] != 0) bps = kSampleSizes[ss_code];

        int nch = st->channels;
        if (ch_assign <= 7) {
            nch = ch_assign + 1;
            if (nch != st->channels) return false;
            for (int c = 0; c < nch; ++c) {
                if (!decode_subframe(br, block_size, bps, chans[c])) return false;
            }
        } else if (ch_assign <= 10) {
            if (st->channels != 2) return false;
            // side channel carries one extra bit
            int bps0 = bps + (ch_assign == 9 ? 1 : 0);
            int bps1 = bps + (ch_assign != 9 ? 1 : 0);
            if (!decode_subframe(br, block_size, bps0, chans[0])) return false;
            if (!decode_subframe(br, block_size, bps1, chans[1])) return false;
            for (int i = 0; i < block_size; ++i) {
                int64_t a = chans[0][i], b = chans[1][i];
                if (ch_assign == 8) {  // left/side
                    chans[1][i] = a - b;
                } else if (ch_assign == 9) {  // right/side
                    chans[0][i] = a + b;
                } else {  // mid/side
                    int64_t mid = (a << 1) | (b & 1);
                    chans[0][i] = (mid + b) >> 1;
                    chans[1][i] = (mid - b) >> 1;
                }
            }
        } else {
            return false;
        }

        br.align_to_byte();
        br.read_bits(16);  // CRC-16 (not verified)
        if (br.error) return false;

        for (int c = 0; c < st->channels; ++c) {
            st->pcm[c].insert(st->pcm[c].end(), chans[c].begin(),
                              chans[c].begin() + block_size);
        }
        if (st->total_samples > 0 && st->pcm[0].size() >= st->total_samples) break;
    }

    if (st->total_samples > 0) {
        for (auto& ch : st->pcm) {
            if (ch.size() > st->total_samples) ch.resize(st->total_samples);
        }
    }
    return !st->pcm.empty() && !st->pcm[0].empty();
}

// ---------------------------------------------------------------------------
// WAV (RIFF PCM / IEEE float)
// ---------------------------------------------------------------------------

bool decode_wav(const uint8_t* data, size_t size, FlacStream* st) {
    if (size < 44 || memcmp(data, "RIFF", 4) != 0 || memcmp(data + 8, "WAVE", 4) != 0)
        return false;
    size_t pos = 12;
    uint16_t fmt = 0, channels = 0, bits = 0;
    uint32_t sr = 0;
    const uint8_t* pcm_data = nullptr;
    size_t pcm_size = 0;
    while (pos + 8 <= size) {
        uint32_t chunk_size;
        memcpy(&chunk_size, data + pos + 4, 4);
        if (memcmp(data + pos, "fmt ", 4) == 0 && chunk_size >= 16) {
            memcpy(&fmt, data + pos + 8, 2);
            memcpy(&channels, data + pos + 10, 2);
            memcpy(&sr, data + pos + 12, 4);
            memcpy(&bits, data + pos + 22, 2);
            if (fmt == 0xFFFE && chunk_size >= 40) {  // WAVE_FORMAT_EXTENSIBLE
                memcpy(&fmt, data + pos + 32, 2);
            }
        } else if (memcmp(data + pos, "data", 4) == 0) {
            pcm_data = data + pos + 8;
            pcm_size = std::min(static_cast<size_t>(chunk_size), size - pos - 8);
        }
        pos += 8 + chunk_size + (chunk_size & 1);
    }
    if (!pcm_data || channels == 0 || sr == 0) return false;

    st->sample_rate = sr;
    st->channels = channels;
    st->bits_per_sample = bits;
    int bytes_per = bits / 8;
    size_t n_frames = pcm_size / (bytes_per * channels);
    st->pcm.assign(channels, std::vector<int64_t>(n_frames));
    st->total_samples = n_frames;

    for (size_t i = 0; i < n_frames; ++i) {
        for (int c = 0; c < channels; ++c) {
            const uint8_t* p = pcm_data + (i * channels + c) * bytes_per;
            int64_t v = 0;
            if (fmt == 3 && bits == 32) {  // IEEE float: scale into 24-bit range
                float f;
                memcpy(&f, p, 4);
                v = static_cast<int64_t>(f * 8388608.0f);
                st->bits_per_sample = 24;
            } else if (bits == 8) {  // unsigned
                v = static_cast<int64_t>(p[0]) - 128;
            } else if (bits == 16) {
                int16_t s;
                memcpy(&s, p, 2);
                v = s;
            } else if (bits == 24) {
                v = p[0] | (p[1] << 8) | (p[2] << 16);
                if (v & 0x800000) v -= 0x1000000;
            } else if (bits == 32) {
                int32_t s;
                memcpy(&s, p, 4);
                v = s;
            } else {
                return false;
            }
            st->pcm[c][i] = v;
        }
    }
    if (fmt == 3) st->bits_per_sample = 24;
    return true;
}

// ---------------------------------------------------------------------------
// Resampler: Kaiser-windowed sinc, evaluated at fractional offsets
// ---------------------------------------------------------------------------

double bessel_i0(double x) {
    // series expansion; converges fast for the beta range used here
    double sum = 1.0, term = 1.0;
    double half_x = x / 2.0;
    for (int k = 1; k < 64; ++k) {
        term *= (half_x / k) * (half_x / k);
        sum += term;
        if (term < 1e-18 * sum) break;
    }
    return sum;
}

float* resample(const float* in, int64_t n, double sr_from, double sr_to,
                int64_t* out_len) {
    if (sr_from == sr_to) {
        float* out = static_cast<float*>(malloc(n * sizeof(float)));
        memcpy(out, in, n * sizeof(float));
        *out_len = n;
        return out;
    }
    double ratio = sr_to / sr_from;
    // cutoff slightly inside the smaller Nyquist, in cycles per input sample
    double fc = 0.5 * std::min(1.0, ratio) * 0.945;
    const double beta = 10.0;
    const int zero_crossings = 16;
    double half_width = zero_crossings / (2.0 * fc);
    int hw = static_cast<int>(std::ceil(half_width));
    double inv_i0_beta = 1.0 / bessel_i0(beta);

    int64_t m = static_cast<int64_t>(std::floor(n * ratio));
    float* out = static_cast<float*>(malloc(std::max<int64_t>(m, 1) * sizeof(float)));
    for (int64_t i = 0; i < m; ++i) {
        double center = i / ratio;
        int64_t k0 = static_cast<int64_t>(std::ceil(center - hw));
        int64_t k1 = static_cast<int64_t>(std::floor(center + hw));
        if (k0 < 0) k0 = 0;
        if (k1 >= n) k1 = n - 1;
        double acc = 0.0;
        for (int64_t k = k0; k <= k1; ++k) {
            double t = k - center;
            double x = 2.0 * fc * t;
            double sinc = (x == 0.0) ? 1.0 : std::sin(M_PI * x) / (M_PI * x);
            double u = t / half_width;
            double w = (std::fabs(u) <= 1.0)
                           ? bessel_i0(beta * std::sqrt(1.0 - u * u)) * inv_i0_beta
                           : 0.0;
            acc += in[k] * 2.0 * fc * sinc * w;
        }
        out[i] = static_cast<float>(acc);
    }
    *out_len = m;
    return out;
}

}  // namespace

extern "C" {

void audio_free(float* p) { free(p); }

float* audio_resample(const float* in, int64_t n, double sr_from, double sr_to,
                      int64_t* out_len) {
    return resample(in, n, sr_from, sr_to, out_len);
}

// Decode a WAV or FLAC file to mono float32 at target_sr (mean-downmix,
// normalized to [-1, 1) by the source bit depth).  Returns nullptr on failure;
// *out_len receives the sample count.
float* audio_decode_file(const char* path, int target_sr, int64_t* out_len) {
    *out_len = 0;
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    fseek(f, 0, SEEK_END);
    long fsize = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> data(fsize);
    if (fread(data.data(), 1, fsize, f) != static_cast<size_t>(fsize)) {
        fclose(f);
        return nullptr;
    }
    fclose(f);

    FlacStream st;
    bool ok = false;
    if (fsize >= 4 && memcmp(data.data(), "fLaC", 4) == 0) {
        ok = decode_flac(data.data(), data.size(), &st);
    } else if (fsize >= 4 && memcmp(data.data(), "RIFF", 4) == 0) {
        ok = decode_wav(data.data(), data.size(), &st);
    }
    if (!ok) return nullptr;

    int64_t n = static_cast<int64_t>(st.pcm[0].size());
    double scale = 1.0 / (1ll << (st.bits_per_sample - 1));
    std::vector<float> mono(n);
    for (int64_t i = 0; i < n; ++i) {
        double acc = 0.0;
        for (int c = 0; c < st.channels; ++c) acc += st.pcm[c][i];
        mono[i] = static_cast<float>(acc / st.channels * scale);
    }

    return resample(mono.data(), n, st.sample_rate, target_sr, out_len);
}

}  // extern "C"
