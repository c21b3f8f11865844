// Mastering limiter: look-ahead peak-hold compressor with automated knee,
// attack/release ballistics, make-up gain and clipping reduction, after
// Giannoulis, Massberg & Reiss, "Digital Dynamic Range Compressor Design —
// A Tutorial and Analysis" (JAES 2012) as deployed by the reference
// renderer's output stage (core/mastering.cpp behavioral spec; this is an
// independent implementation of that algorithm).
//
// The gain computer is an inherently sequential scalar recurrence
// (three coupled state variables with per-sample nonlinearities), so it
// runs on the host CPU: one call per rendered block, operating on the
// [frames x channels] interleaved float32 output after decode.
//
// C ABI for ctypes; no dependencies beyond libm.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kMaxBlock = 1024;

struct SlidingMax {
    // Sliding-window maximum over the last `length` samples (monotone
    // deque over a ring of the block size).
    float values[kMaxBlock];
    unsigned expiries[kMaxBlock];
    unsigned lower = 0, upper = 0;
    unsigned length = 0;

    float update(unsigned i, float in) {
        constexpr unsigned mask = kMaxBlock - 1;
        if (i >= expiries[upper])
            upper = (upper + 1) & mask;
        if (in >= values[upper]) {
            values[upper] = in;
            expiries[upper] = i + length;
            lower = upper;
        } else {
            while (in >= values[lower])
                lower = (lower - 1) & mask;
            lower = (lower + 1) & mask;
            values[lower] = in;
            expiries[lower] = i + length;
        }
        return values[upper];
    }

    void shift(unsigned n) {
        // Rebase expiries after a block of n samples.
        if (lower < upper) {
            for (unsigned k = 0; k <= lower; ++k) expiries[k] -= n;
            for (unsigned k = upper; k < kMaxBlock; ++k) expiries[k] -= n;
        } else {
            for (unsigned k = upper; k <= lower; ++k) expiries[k] -= n;
        }
    }
};

struct Limiter {
    int channels = 0;
    unsigned look_ahead = 0;
    unsigned hold = 0;
    float threshold = 0.0f;   // log domain (ln(10)/20 * dB)
    float slope = -1.0f;
    float attack = 1.0f;      // samples
    float release = 1.0f;
    float gain_estimate = 0.0f;
    float adapt_coeff = 0.0f;
    float crest_coeff = 0.0f;

    // States
    float last_peak_sq = 0.0f;
    float last_rms_sq = 0.0f;
    float last_release = 0.0f;
    float last_attack = 0.0f;
    float last_gain_dev = 0.0f;
    SlidingMax hold_win;
    std::vector<float> side_chain;    // look_ahead + kMaxBlock
    std::vector<float> crest_factor;  // kMaxBlock
    std::vector<float> delay;         // channels * look_ahead ring
};

inline float lerpf(float a, float b, float t) { return a + (b - a) * t; }

}  // namespace

extern "C" {

void* al_limiter_create(int channels, float sample_rate, float threshold_db) {
    auto* c = new Limiter();
    c->channels = channels;
    c->look_ahead = (unsigned)std::fmin(std::fmax(std::round(0.001f * sample_rate), 0.0f),
                                        (float)(kMaxBlock - 1));
    c->hold = (unsigned)std::fmin(std::fmax(std::round(0.002f * sample_rate), 0.0f),
                                  (float)(kMaxBlock - 1));
    const float log10_20 = (float)(std::log(10.0) / 20.0);
    c->threshold = log10_20 * threshold_db;
    c->slope = -1.0f;  // automated knee treats it as a limiter
    c->attack = std::fmax(1.0f, 0.02f * sample_rate);
    c->release = std::fmax(1.0f, 0.2f * sample_rate);
    c->gain_estimate = c->threshold * -0.5f * c->slope;
    c->adapt_coeff = std::exp(-1.0f / (2.0f * sample_rate));
    c->crest_coeff = std::exp(-1.0f / (0.2f * sample_rate));
    c->side_chain.assign(c->look_ahead + kMaxBlock, 0.0f);
    c->crest_factor.assign(kMaxBlock, 0.0f);
    c->delay.assign((size_t)channels * c->look_ahead, 0.0f);
    if (c->hold > 1) {
        c->hold_win.length = c->hold;
        c->hold_win.values[0] = -INFINITY;
        c->hold_win.expiries[0] = c->hold;
    }
    return c;
}

void al_limiter_destroy(void* h) { delete (Limiter*)h; }

unsigned al_limiter_lookahead(void* h) { return ((Limiter*)h)->look_ahead; }

// inout: interleaved [frames x channels] float32.
void al_limiter_process(void* h, float* inout, int frames) {
    auto* c = (Limiter*)h;
    const int nch = c->channels;
    const unsigned la = c->look_ahead;
    float* sc = c->side_chain.data();

    // Linked side chain: absolute maximum across channels.
    for (int i = 0; i < frames; ++i) {
        float m = 0.0f;
        for (int ch = 0; ch < nch; ++ch)
            m = std::fmax(m, std::fabs(inout[(size_t)i * nch + ch]));
        sc[la + i] = m;
    }

    // Squared crest factor with 200 ms release (auto attack/release).
    {
        float y2p = c->last_peak_sq, y2r = c->last_rms_sq;
        const float a = c->crest_coeff;
        for (int i = 0; i < frames; ++i) {
            const float xa = sc[la + i];
            float x2 = xa * xa;
            x2 = std::fmin(std::fmax(x2, 0.000001f), 1000000.0f);
            y2p = std::fmax(x2, lerpf(x2, y2p, a));
            y2r = lerpf(x2, y2r, a);
            c->crest_factor[i] = y2p / y2r;
        }
        c->last_peak_sq = y2p;
        c->last_rms_sq = y2r;
    }

    // Peak hold in the log domain.
    if (c->hold > 1) {
        for (int i = 0; i < frames; ++i) {
            const float xg = std::log(std::fmax(0.000001f, sc[la + i]));
            sc[la + i] = c->hold_win.update((unsigned)i, xg);
        }
        c->hold_win.shift((unsigned)frames);
    } else {
        for (int i = 0; i < frames; ++i)
            sc[la + i] = std::log(std::fmax(0.000001f, sc[la + i]));
    }

    // Gain computer with automated knee/ballistics/make-up/declip.
    {
        const float threshold = c->threshold, slope = c->slope;
        const float attack = c->attack, release = c->release;
        const float c_est = c->gain_estimate, a_adp = c->adapt_coeff;
        float y_1 = c->last_release, y_L = c->last_attack;
        float c_dev = c->last_gain_dev;
        float t_att = attack, t_rel = release - attack;
        float a_att = std::exp(-1.0f / t_att);
        float a_rel = std::exp(-1.0f / t_rel);
        for (int i = 0; i < frames; ++i) {
            const float input = sc[i];
            const float look = sc[la + i];

            const float knee = std::fmax(0.0f, 2.5f * (c_dev + c_est));
            const float knee_h = 0.5f * knee;
            const float x_over = look - threshold;
            const float y_G =
                (x_over <= -knee_h) ? 0.0f
                : (std::fabs(x_over) < knee_h)
                    ? (x_over + knee_h) * (x_over + knee_h) / (2.0f * knee)
                    : x_over;

            const float y2_crest = c->crest_factor[i];
            t_att = 2.0f * attack / y2_crest;
            a_att = std::exp(-1.0f / t_att);
            t_rel = 2.0f * release / y2_crest - t_att;
            a_rel = std::exp(-1.0f / t_rel);

            const float x_L = -slope * y_G;
            y_1 = std::fmax(x_L, lerpf(x_L, y_1, a_rel));
            y_L = lerpf(y_1, y_L, a_att);

            c_dev = lerpf(-(y_L + c_est), c_dev, a_adp);
            c_dev = std::fmax(c_dev, input - y_L - threshold - c_est);
            const float post_gain = -(c_dev + c_est);
            sc[i] = std::exp(post_gain - y_L);
        }
        c->last_release = y_1;
        c->last_attack = y_L;
        c->last_gain_dev = c_dev;
    }

    // Look-ahead delay per channel, then apply the gain envelope.
    if (la > 0) {
        for (int ch = 0; ch < nch; ++ch) {
            float* dl = c->delay.data() + (size_t)ch * la;
            for (int i = 0; i < frames; ++i) {
                float& s = inout[(size_t)i * nch + ch];
                const float d = dl[i % la];
                dl[i % la] = s;
                s = d;
            }
            // Rotate the ring so index 0 lines up for the next block.
            const unsigned r = (unsigned)(frames % (int)la);
            if (r) {
                std::vector<float> tmp(dl, dl + la);
                for (unsigned k = 0; k < la; ++k) dl[k] = tmp[(k + r) % la];
            }
        }
    }
    for (int i = 0; i < frames; ++i) {
        const float g = sc[i];
        for (int ch = 0; ch < nch; ++ch)
            inout[(size_t)i * nch + ch] *= g;
    }

    std::memmove(sc, sc + frames, la * sizeof(float));
}

}  // extern "C"
