// Scalar single-thread CPU baseline for benchmarking: the full gen-2 VHS
// chain per field, written the way the reference implements it (sequential
// per-sample double-precision IIRs, per-scanline loops; see SURVEY.md §2.2
// and ffmpeg_ntsc.cpp:1570-1921 for the stage list). This is an original
// re-implementation used only to measure the per-field CPU cost class that
// the reference's approach implies, since the FFmpeg-3.x reference cannot be
// built in this environment.
//
// Build: g++ -O2 -o scalar_baseline scalar_baseline.cpp
// Usage: ./scalar_baseline [n_fields] [width] [lines]

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <chrono>
#include <cmath>
#include <vector>

static const double RATE = (315000000.0 * 4) / 88;  // 4fsc

struct OnePole {
    double alpha, prev;
    OnePole(double hz, double reset) {
        double dt = 1.0 / RATE;
        double tau = 1.0 / (hz * 2.0 * M_PI);
        alpha = dt / (tau + dt);
        prev = reset;
    }
    inline double lp(double s) {
        prev = s * alpha + (prev - prev * alpha);
        return prev;
    }
    inline double hp(double s) { return s - lp(s); }
};

static inline int cdiv(int a, int b) { return a / b; }  // C trunc division

struct Field {
    int w, l;
    std::vector<int> y, i, q;
    Field(int w_, int l_) : w(w_), l(l_), y(w_ * l_), i(w_ * l_), q(w_ * l_) {}
};

static void lowpass_plane(std::vector<int>& p, int w, int l, double cutoff, int delay) {
    for (int li = 0; li < l; li++) {
        int* row = &p[li * w];
        OnePole f0(cutoff, 0), f1(cutoff, 0), f2(cutoff, 0);
        for (int x = 0; x < w; x++) {
            double s = row[x];
            s = f2.lp(f1.lp(f0.lp(s)));
            if (x >= delay) row[x - delay] = (int)s;
        }
    }
}

static const int UM[4] = {1, 0, -1, 0};
static const int VM[4] = {0, 1, 0, -1};

static void qam_encode(Field& f, int fieldno, int parity, int amp) {
    for (int li = 0; li < f.l; li++) {
        int yy = parity + 2 * li;
        int xi = (((fieldno + yy) & 2)) & 3;  // 180-degree phase mode
        int* Y = &f.y[li * f.w];
        int* I = &f.i[li * f.w];
        int* Q = &f.q[li * f.w];
        for (int x = 0; x < f.w; x++) {
            int sxi = (xi + x) & 3;
            int chroma = I[x] * amp * UM[sxi] + Q[x] * amp * VM[sxi];
            Y[x] += cdiv(chroma, 50);
            I[x] = 0;
            Q[x] = 0;
        }
    }
}

static void qam_decode(Field& f, int fieldno, int parity, int amp_back) {
    std::vector<int> chroma(f.w);
    for (int li = 0; li < f.l; li++) {
        int yy = parity + 2 * li;
        int xi = (((fieldno + yy) & 2)) & 3;
        int* Y = &f.y[li * f.w];
        int* I = &f.i[li * f.w];
        int* Q = &f.q[li * f.w];
        int d0 = 0, d1 = 0, d2 = Y[0], d3 = Y[1];
        int sum = d2 + d3;
        for (int x = 0; x < f.w; x++) {
            int c = (x + 2) < f.w ? Y[x + 2] : 0;
            sum -= d0;
            d0 = d1; d1 = d2; d2 = d3; d3 = c;
            sum += c;
            Y[x] = cdiv(sum, 4);
            chroma[x] = c - Y[x];
        }
        for (int x = (4 - xi) & 3; x + 3 < f.w; x += 4) {
            chroma[x + 2] = -chroma[x + 2];
            chroma[x + 3] = -chroma[x + 3];
        }
        for (int x = 0; x < f.w; x++) chroma[x] = cdiv(chroma[x] * 50, amp_back);
        int x = 0;
        for (; (x + xi + 1) < f.w; x += 2) {
            I[x] = -chroma[x + xi];
            Q[x] = -chroma[x + xi + 1];
        }
        for (; x < f.w; x += 2) { I[x] = 0; Q[x] = 0; }
        for (x = 0; (x + 2) < f.w; x += 2) {
            I[x + 1] = (I[x] + I[x + 2]) >> 1;
            Q[x + 1] = (Q[x] + Q[x + 2]) >> 1;
        }
        for (; x < f.w; x++) { I[x] = 0; Q[x] = 0; }
    }
}

static void video_noise(Field& f, int mag) {
    int noise = 0;
    for (int li = 0; li < f.l; li++) {
        int* Y = &f.y[li * f.w];
        for (int x = 0; x < f.w; x++) {
            Y[x] += noise;
            noise += (int)((unsigned)rand() % (2 * mag + 1)) - mag;
            noise /= 2;
        }
    }
}

static void chroma_noise(Field& f, int mag) {
    int nu = 0, nv = 0;
    for (int li = 0; li < f.l; li++) {
        int* I = &f.i[li * f.w];
        int* Q = &f.q[li * f.w];
        for (int x = 0; x < f.w; x++) {
            I[x] += nu;
            Q[x] += nv;
            nu += (int)((unsigned)rand() % (2 * mag + 1)) - mag;
            nu /= 2;
            nv += (int)((unsigned)rand() % (2 * mag + 1)) - mag;
            nv /= 2;
        }
    }
}

static void chroma_phase_noise(Field& f, int mag) {
    int noise = 0;
    for (int li = 0; li < f.l; li++) {
        noise += (int)((unsigned)rand() % (2 * mag + 1)) - mag;
        noise /= 2;
        double ang = noise * M_PI / 100.0;
        double sa = sin(ang), ca = cos(ang);
        int* I = &f.i[li * f.w];
        int* Q = &f.q[li * f.w];
        for (int x = 0; x < f.w; x++) {
            double u = I[x], v = Q[x];
            I[x] = (int)(u * ca - v * sa);
            Q[x] = (int)(u * sa + v * ca);
        }
    }
}

static void head_switch(Field& f, int parity, double point, double phase) {
    int tw = f.w + f.w / 10;
    double t = tw * 262.5;
    int p = (int)(fmod(point, 1.0) * t);
    int yy = (p / tw) * 2 + parity - (262 - 240) * 2;
    p = (int)(fmod(phase, 1.0) * t);
    int x = p % tw;
    int ishif = x >= tw / 2 ? x - tw : x;
    int shif = 0, shy = 0;
    std::vector<int> tmp(tw);
    while (yy < f.l * 2) {
        if (yy >= 0 && shif != 0) {
            int* Y = &f.y[((yy - parity) / 2) * f.w];
            std::fill(tmp.begin(), tmp.end(), 0);
            std::memcpy(tmp.data(), Y, f.w * sizeof(int));
            int x2 = (tw + shif) % tw;
            for (int k = 0; k < f.w; k++) {
                Y[k] = tmp[x2];
                if (++x2 == tw) x2 = 0;
            }
        }
        shif = (shy == 0) ? ishif : (shif * 7) / 8;
        yy += 2;
        shy++;
    }
}

static void vhs_luma(Field& f, double cut) {
    for (int li = 0; li < f.l; li++) {
        int* Y = &f.y[li * f.w];
        OnePole f0(cut, 16), f1(cut, 16), f2(cut, 16), pre(cut, 16);
        for (int x = 0; x < f.w; x++) {
            double s = Y[x];
            s = f2.lp(f1.lp(f0.lp(s)));
            s += pre.hp(s) * 1.6;
            Y[x] = (int)s;
        }
    }
}

static void vhs_sharpen(Field& f, double cut, double sharpen) {
    for (int li = 0; li < f.l; li++) {
        int* Y = &f.y[li * f.w];
        OnePole f0(cut * 4, 0), f1(cut * 4, 0), f2(cut * 4, 0);
        for (int x = 0; x < f.w; x++) {
            double s = Y[x];
            double ts = f2.lp(f1.lp(f0.lp(s)));
            Y[x] = (int)(s + (s - ts) * sharpen * 2);
        }
    }
}

static void vblend(Field& f) {
    std::vector<int> du(f.w, 0), dv(f.w, 0);
    for (int li = 1; li < f.l; li++) {
        int* I = &f.i[li * f.w];
        int* Q = &f.q[li * f.w];
        for (int x = 0; x < f.w; x++) {
            int ci = I[x], cq = Q[x];
            I[x] = (du[x] + ci + 1) >> 1;
            Q[x] = (dv[x] + cq + 1) >> 1;
            du[x] = ci;
            dv[x] = cq;
        }
    }
}

static void process_field_ep(Field& f, int fieldno, int parity) {
    // BASELINE.json config 3/4 core: full VHS EP chain (the headline config)
    const double luma_cut = 1400000, chroma_cut = 280000;
    const int chroma_delay = 14;

    lowpass_plane(f.i, f.w, f.l, 1300000, 2);
    lowpass_plane(f.q, f.w, f.l, 600000, 4);
    qam_encode(f, fieldno, parity, 50);
    video_noise(f, 6);
    head_switch(f, parity, 1.0 - 4.51 / 262.5, 0.99 / 262.5);
    qam_decode(f, fieldno, parity, 50);
    chroma_noise(f, 22);
    chroma_phase_noise(f, 6);
    vhs_luma(f, luma_cut);
    lowpass_plane(f.i, f.w, f.l, chroma_cut, chroma_delay);
    lowpass_plane(f.q, f.w, f.l, chroma_cut, chroma_delay);
    vblend(f);
    vhs_sharpen(f, luma_cut, 1.5);
    qam_encode(f, fieldno, parity, 50);
    qam_decode(f, fieldno, parity, 50);
    // chroma dropout: per line
    for (int li = 0; li < f.l; li++) {
        if ((unsigned)rand() % 100000 < 8) {
            std::memset(&f.i[li * f.w], 0, f.w * sizeof(int));
            std::memset(&f.q[li * f.w], 0, f.w * sizeof(int));
        }
    }
    lowpass_plane(f.i, f.w, f.l, 2600000, 1);  // out lowpass (tv)
    lowpass_plane(f.q, f.w, f.l, 2600000, 1);
}

static void process_field_composite(Field& f, int fieldno, int parity) {
    // BASELINE.json config 1: plain composite emulation — chroma lowpass,
    // QAM encode/decode, out lowpass; no noise, no VHS
    lowpass_plane(f.i, f.w, f.l, 1300000, 2);
    lowpass_plane(f.q, f.w, f.l, 600000, 4);
    qam_encode(f, fieldno, parity, 50);
    qam_decode(f, fieldno, parity, 50);
    lowpass_plane(f.i, f.w, f.l, 2600000, 1);
    lowpass_plane(f.q, f.w, f.l, 2600000, 1);
}

static void process_field_broadcast(Field& f, int fieldno, int parity) {
    // BASELINE.json config 2: composite + luma/chroma/phase noise
    // ("broadcast look"); same magnitudes as the device row
    lowpass_plane(f.i, f.w, f.l, 1300000, 2);
    lowpass_plane(f.q, f.w, f.l, 600000, 4);
    qam_encode(f, fieldno, parity, 50);
    video_noise(f, 6);
    qam_decode(f, fieldno, parity, 50);
    chroma_noise(f, 22);
    chroma_phase_noise(f, 6);
    lowpass_plane(f.i, f.w, f.l, 2600000, 1);
    lowpass_plane(f.q, f.w, f.l, 2600000, 1);
}

static void process_field(Field& f, int fieldno, int parity,
                          const char* config) {
    if (!strcmp(config, "composite")) {
        process_field_composite(f, fieldno, parity);
    } else if (!strcmp(config, "broadcast")) {
        process_field_broadcast(f, fieldno, parity);
    } else if (!strcmp(config, "dub2")) {
        // BASELINE.json config 4: 2-generation EP dub — the whole EP chain
        // applied twice (generation 2 re-records generation 1's output,
        // the re-encode pass; yc-recomb cost class
        // ffmpeg_to_composite.cpp:943-946)
        process_field_ep(f, fieldno, parity);
        process_field_ep(f, fieldno, parity);
    } else {
        process_field_ep(f, fieldno, parity);  // "ep" (default)
    }
}

int main(int argc, char** argv) {
    int n = argc > 1 ? atoi(argv[1]) : 60;
    int w = argc > 2 ? atoi(argv[2]) : 704;
    int l = argc > 3 ? atoi(argv[3]) : 240;
    const char* config = argc > 4 ? argv[4] : "ep";

    Field f(w, l);
    for (int k = 0; k < w * l; k++) {
        f.y[k] = (k * 2654435761u >> 16) % 65280;
        f.i[k] = (int)((k * 40503u >> 12) % 8000) - 4000;
        f.q[k] = (int)((k * 9973u >> 10) % 8000) - 4000;
    }

    auto t0 = std::chrono::steady_clock::now();
    long checksum = 0;
    for (int fi = 0; fi < n; fi++) {
        process_field(f, fi, fi & 1, config);
        checksum += f.y[fi % (w * l)];
    }
    auto t1 = std::chrono::steady_clock::now();
    double secs = std::chrono::duration<double>(t1 - t0).count();
    fprintf(stderr, "checksum %ld\n", checksum);
    printf("{\"fields\": %d, \"seconds\": %.4f, \"fields_per_sec\": %.3f}\n",
           n, secs, n / secs);
    return 0;
}
