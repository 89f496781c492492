// livo_native: native ingest runtime of the PyTorch/CUDA port
// (sr_livo_tpu_torch), a copy of the JAX package's native ingest library.
//
// C++ replacements for the reference's ROS-side ingest machinery
// (cloudProcessing.cpp point decoding / driver processing and the rosbag
// transport feeding it): a minimal ROS1 bag-v2.0 reader (none/bz2/lz4
// chunk compression via dlopen'd system libs) and vectorized point-cloud
// field decoders + per-vendor stream filters.  Exposed through a C ABI
// consumed by ctypes (sr_livo_tpu_torch/runtime/native.py).  Host code:
// it runs on the CPU, beside the GPU work.
//
// Build (at first use, by sr_livo_tpu_torch/kernels.py, into
// build/native/): g++ -O3 -shared -fPIC -std=c++17 -o lib.so livo_native.cpp -ldl

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <dlfcn.h>
#include <map>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Point decoding: PointCloud2 payload -> packed [x, y, z, t_rel_ms] floats
// ---------------------------------------------------------------------------

// t_dtype: 0 = absent, 1 = float32, 2 = float64, 3 = uint32
// Returns number of points written.
int livo_decode_xyzt(const uint8_t* data, long n_points, long point_step,
                     long off_x, long off_y, long off_z, long off_t,
                     int t_dtype, double time_unit_scale, double t_base,
                     float* out_xyzt) {
    // t_base is subtracted in DOUBLE before the f32 downcast: vendors
    // carrying absolute f64 stamps (robosense `timestamp`) would
    // otherwise quantize to ~0.125 ms at epoch-scale magnitudes
    for (long i = 0; i < n_points; i++) {
        const uint8_t* p = data + i * point_step;
        float x, y, z;
        memcpy(&x, p + off_x, 4);
        memcpy(&y, p + off_y, 4);
        memcpy(&z, p + off_z, 4);
        double t = 0.0;
        if (t_dtype == 1) {
            float tf; memcpy(&tf, p + off_t, 4); t = tf;
        } else if (t_dtype == 2) {
            double td; memcpy(&td, p + off_t, 8); t = td;
        } else if (t_dtype == 3) {
            uint32_t tu; memcpy(&tu, p + off_t, 4); t = (double)tu;
        }
        out_xyzt[i * 4 + 0] = x;
        out_xyzt[i * 4 + 1] = y;
        out_xyzt[i * 4 + 2] = z;
        out_xyzt[i * 4 + 3] = (float)((t - t_base) * time_unit_scale);  // ms
    }
    return (int)n_points;
}

// Decode u8/u16 ring field.
int livo_decode_ring(const uint8_t* data, long n_points, long point_step,
                     long off_ring, int ring_dtype /*1=u8,2=u16*/,
                     int32_t* out_ring) {
    for (long i = 0; i < n_points; i++) {
        const uint8_t* p = data + i * point_step + off_ring;
        out_ring[i] = ring_dtype == 1 ? (int32_t)(*p)
                                      : (int32_t)(*(const uint16_t*)p);
    }
    return (int)n_points;
}

// Spinning-LiDAR stream processing (ousterHandler/velodyneHandler/
// robosenseHandler, cloudProcessing.cpp:216-541): optional ring-based time
// synthesis when no per-point time, time sort, decimation, blind filter,
// monotonic last_end_time gate.  xyzt: (n, 4) with t in ms relative to
// header stamp; header_time seconds.  Returns count written to out (n, 4)
// with ABSOLUTE timestamps in seconds; *inout_last_end_time updated.
int livo_process_spinning(const float* xyzt, const int32_t* ring,
                          long n, int n_scans, int scan_rate,
                          int point_filter_num, double blind,
                          double header_time, int given_offset_time,
                          double* inout_last_end_time, double* out_xyzt) {
    std::vector<double> t_rel(n);
    if (!given_offset_time) {
        // yaw-based per-ring time synthesis (cloudProcessing.cpp:260-287)
        double omega = 0.361 * scan_rate;  // deg per ms
        std::vector<bool> is_first(n_scans, true);
        std::vector<double> yaw_first(n_scans, 0.0);
        for (long i = 0; i < n; i++) {
            int layer = ring ? ring[i] : 0;
            if (layer < 0 || layer >= n_scans) { t_rel[i] = 0.0; continue; }
            double yaw = atan2(xyzt[i * 4 + 1], xyzt[i * 4 + 0]) * 57.2957;
            if (is_first[layer]) {
                yaw_first[layer] = yaw;
                is_first[layer] = false;
                t_rel[i] = 0.0;
            } else if (yaw <= yaw_first[layer]) {
                t_rel[i] = (yaw_first[layer] - yaw) / omega;
            } else {
                t_rel[i] = (yaw_first[layer] - yaw + 360.0) / omega;
            }
        }
    } else {
        for (long i = 0; i < n; i++) t_rel[i] = xyzt[i * 4 + 3];
    }

    std::vector<long> order(n);
    for (long i = 0; i < n; i++) order[i] = i;
    std::stable_sort(order.begin(), order.end(),
                     [&](long a, long b) { return t_rel[a] < t_rel[b]; });

    double dt_last = n ? t_rel[order[n - 1]] : 0.0;
    double last_end = *inout_last_end_time;
    long m = 0;
    for (long k = 0; k < n; k++) {
        long i = order[k];
        if (point_filter_num > 1 && (k % point_filter_num) != 0) continue;
        double x = xyzt[i * 4 + 0], y = xyzt[i * 4 + 1], z = xyzt[i * 4 + 2];
        if (x * x + y * y + z * z <= blind * blind) continue;
        double ts = header_time + t_rel[i] / 1000.0;
        if (ts <= last_end) continue;
        out_xyzt[m * 4 + 0] = x;
        out_xyzt[m * 4 + 1] = y;
        out_xyzt[m * 4 + 2] = z;
        out_xyzt[m * 4 + 3] = ts;
        m++;
    }
    *inout_last_end_time = header_time + dt_last / 1000.0;
    return (int)m;
}

// Livox CustomMsg stream filter (livoxHandler, cloudProcessing.cpp:125-214):
// per-point records [x f32, y f32, z f32, reflectivity u8, tag u8, line u8,
// offset_time u32(ns)] packed as given by the caller.  Applies the r3live
// validity/tag/duplicate filters, time sort, decimation, blind filter.
int livo_process_livox(const float* xyz, const uint8_t* tag,
                       const uint8_t* line, const uint32_t* offset_ns,
                       long n, int n_scans, int point_filter_num,
                       double blind, double header_time,
                       double* inout_last_end_time, double* out_xyzt) {
    struct P { float x, y, z; double t_ms; };
    std::vector<P> pts;
    pts.reserve(n);
    for (long i = 1; i < n; i++) {
        float x = xyz[i * 3], y = xyz[i * 3 + 1], z = xyz[i * 3 + 2];
        if (line[i] >= n_scans) continue;
        if (fabsf(x) > 1e8f || fabsf(y) > 1e8f || fabsf(z) > 1e8f) continue;
        if (!(x > 0.7f)) continue;
        if (x > 2.0f && (((tag[i] & 0x03) != 0x00) || ((tag[i] & 0x0C) != 0x00)))
            continue;
        // duplicate-point rejection vs predecessor
        if (fabsf(x - xyz[(i - 1) * 3]) <= 1e-7f &&
            fabsf(y - xyz[(i - 1) * 3 + 1]) <= 1e-7f &&
            fabsf(z - xyz[(i - 1) * 3 + 2]) <= 1e-7f)
            continue;
        pts.push_back({x, y, z, offset_ns[i] * 1e-6});
    }
    std::stable_sort(pts.begin(), pts.end(),
                     [](const P& a, const P& b) { return a.t_ms < b.t_ms; });
    double dt_last = pts.empty() ? 0.0 : pts.back().t_ms;
    long m = 0;
    long num_valid = 0;
    for (size_t i = 0; i < pts.size(); i++) {
        num_valid++;
        if (point_filter_num > 1 && (num_valid % point_filter_num) != 0)
            continue;
        const P& p = pts[i];
        if ((double)p.x * p.x + (double)p.y * p.y + (double)p.z * p.z
            <= blind * blind)
            continue;
        out_xyzt[m * 4 + 0] = p.x;
        out_xyzt[m * 4 + 1] = p.y;
        out_xyzt[m * 4 + 2] = p.z;
        out_xyzt[m * 4 + 3] = header_time + p.t_ms / 1000.0;
        m++;
    }
    *inout_last_end_time = header_time + dt_last / 1000.0;
    return (int)m;
}

// Bilinear remap of an interleaved uint8 image by a precomputed float
// source-coordinate map (the cv::remap of imageProcessing.cpp:120, with the
// resize of :118 composed into the map).  Runs on the host CPU so the
// (gather-heavy, TPU-unfriendly) undistortion overlaps device compute.
// map_uv is (dh, dw, 2) float32 (u = src col, v = src row) in SOURCE pixels.
int livo_remap_u8(const uint8_t* src, long sh, long sw, long channels,
                  const float* map_uv, long dh, long dw, uint8_t* dst) {
    if (channels < 1 || channels > 4) return -1;
    const float max_u = (float)(sw - 1) - 1e-3f;
    const float max_v = (float)(sh - 1) - 1e-3f;
    for (long y = 0; y < dh; y++) {
        const float* mrow = map_uv + y * dw * 2;
        uint8_t* drow = dst + y * dw * channels;
        for (long x = 0; x < dw; x++) {
            float u = mrow[x * 2 + 0];
            float v = mrow[x * 2 + 1];
            u = u < 0.f ? 0.f : (u > max_u ? max_u : u);
            v = v < 0.f ? 0.f : (v > max_v ? max_v : v);
            long u0 = (long)u, v0 = (long)v;
            float fu = u - (float)u0, fv = v - (float)v0;
            const uint8_t* p00 = src + (v0 * sw + u0) * channels;
            const uint8_t* p01 = p00 + channels;
            const uint8_t* p10 = p00 + sw * channels;
            const uint8_t* p11 = p10 + channels;
            float w00 = (1.f - fv) * (1.f - fu), w01 = (1.f - fv) * fu;
            float w10 = fv * (1.f - fu), w11 = fv * fu;
            for (long c = 0; c < channels; c++) {
                float val = w00 * p00[c] + w01 * p01[c]
                          + w10 * p10[c] + w11 * p11[c];
                drow[x * channels + c] = (uint8_t)(val + 0.5f);
            }
        }
    }
    return 0;
}

// Fused sweep prepare + int16 wire pack (the hot host-side path of
// LivoPipeline._host_prepare_measurement): window the point stream to
// [begin, t_end], stride-decimate to max_points, compute the robust
// 99.9th-percentile |xyz| scale, and quantize straight to the int16 wire
// rows — skipping the padded float32 intermediate the numpy path builds.
// Heavy loops run with the GIL released (ctypes), so a feeder thread
// doing this work truly overlaps the dispatch thread.
// pts: (n, 4) float64 [x y z t_abs] in stream order.
// out_q: (max_points, 4) int16, padding rows are all -1.
// Returns the number of packed points; *out_scale = meters per quantum.
int livo_prepare_pack(const double* pts, long n, double begin, double t_end,
                      double duration, long max_points, int16_t* out_q,
                      double* out_scale) {
    if (max_points <= 0) return -1;
    // 1. contiguous window [begin, t_end] (stream is time-ordered;
    //    makePointTimestamp drop semantics, lioOptimization.cpp:786-819)
    std::vector<long> sel;
    sel.reserve((size_t)(n < max_points ? n : max_points));
    std::vector<long> win;
    win.reserve((size_t)n);
    for (long i = 0; i < n; i++) {
        double t = pts[i * 4 + 3];
        if (t >= begin && t <= t_end) win.push_back(i);
    }
    long m = (long)win.size();
    if (m > max_points) {
        // deterministic stride decimation (np.linspace(0, m-1, max) -> int).
        // The endpoint is pinned to m-1 and every index clamped: float
        // rounding in i*step is not guaranteed to hit the linspace
        // endpoint exactly, and max_points==1 would divide by zero.
        if (max_points == 1) {
            sel.push_back(win[0]);
        } else {
            double step = (double)(m - 1) / (double)(max_points - 1);
            for (long i = 0; i < max_points; i++) {
                long j = (i == max_points - 1) ? (m - 1)
                                               : (long)((double)i * step);
                if (j > m - 1) j = m - 1;
                sel.push_back(win[j]);
            }
        }
    } else {
        sel.swap(win);
    }
    long k = (long)sel.size();
    // 2. robust scale: 99.9th percentile (linear interpolation, matching
    //    np.percentile) of |xyz| as float32 values
    double max_abs = 1.0;
    if (k > 0) {
        std::vector<float> av;
        av.reserve((size_t)k * 3);
        for (long i = 0; i < k; i++) {
            const double* p = pts + sel[i] * 4;
            av.push_back(std::fabs((float)p[0]));
            av.push_back(std::fabs((float)p[1]));
            av.push_back(std::fabs((float)p[2]));
        }
        size_t mm = av.size();
        double pos = 0.999 * (double)(mm - 1);
        size_t lo = (size_t)pos;
        double frac = pos - (double)lo;
        std::nth_element(av.begin(), av.begin() + lo, av.end());
        double vlo = av[lo];
        double vhi = vlo;
        if (lo + 1 < mm) {
            vhi = *std::min_element(av.begin() + lo + 1, av.end());
        }
        max_abs = vlo + (vhi - vlo) * frac;
        if (max_abs <= 0.0) {
            double mx = 0.0;
            for (size_t i = 0; i < mm; i++) mx = std::max(mx, (double)av[i]);
            max_abs = mx;
        }
    }
    double scale = std::max(max_abs, 1e-6) / 32000.0;
    *out_scale = scale;
    // 3. quantize (f32 arithmetic + round-half-even, matching the numpy
    //    pack_sweep path: f32 array ops with value-cast scalars)
    double dur = std::max(duration, 1e-6);
    float fs = (float)scale;
    float fd = (float)dur;
    for (long i = 0; i < k; i++) {
        const double* p = pts + sel[i] * 4;
        for (int j = 0; j < 3; j++) {
            float q = nearbyintf((float)p[j] / fs);
            q = q < -32767.f ? -32767.f : (q > 32767.f ? 32767.f : q);
            out_q[i * 4 + j] = (int16_t)q;
        }
        float tr = (float)(p[3] - begin);
        float a = nearbyintf(tr / fd * 32000.0f);
        a = a < 0.f ? 0.f : (a > 32000.f ? 32000.f : a);
        out_q[i * 4 + 3] = (int16_t)a;
    }
    for (long i = k; i < max_points; i++)
        for (int j = 0; j < 4; j++) out_q[i * 4 + j] = -1;
    return (int)k;
}

}  // extern "C" (point decoders)

// ---------------------------------------------------------------------------
// Minimal ROS1 bag v2.0 reader (record/chunk framing; none|bz2|lz4)
// ---------------------------------------------------------------------------

typedef int (*bz2_decomp_fn)(char*, unsigned*, char*, unsigned, int, int);
typedef int (*lz4_decomp_fn)(const char*, char*, int, int);

static bz2_decomp_fn load_bz2() {
    static bz2_decomp_fn fn = nullptr;
    static bool tried = false;
    if (!tried) {
        tried = true;
        void* h = dlopen("libbz2.so.1.0", RTLD_NOW);
        if (!h) h = dlopen("libbz2.so.1", RTLD_NOW);
        if (h) fn = (bz2_decomp_fn)dlsym(h, "BZ2_bzBuffToBuffDecompress");
    }
    return fn;
}

static lz4_decomp_fn load_lz4() {
    static lz4_decomp_fn fn = nullptr;
    static bool tried = false;
    if (!tried) {
        tried = true;
        void* h = dlopen("liblz4.so.1", RTLD_NOW);
        if (h) fn = (lz4_decomp_fn)dlsym(h, "LZ4_decompress_safe");
    }
    return fn;
}

struct BagMessage {
    int32_t conn;
    double time;
    std::vector<uint8_t> data;
};

struct BagHandle {
    FILE* f = nullptr;
    std::map<int32_t, std::string> topics;
    std::map<int32_t, std::string> types;
    std::vector<BagMessage> pending;  // messages from the current chunk
    size_t pending_idx = 0;
    std::string error;
};

struct Record {
    std::map<std::string, std::vector<uint8_t>> header;
    std::vector<uint8_t> data;
    bool ok = false;
};

static bool read_exact(FILE* f, void* buf, size_t n) {
    return fread(buf, 1, n, f) == n;
}

static bool parse_header(const uint8_t* buf, size_t len,
                         std::map<std::string, std::vector<uint8_t>>& out) {
    size_t pos = 0;
    while (pos + 4 <= len) {
        uint32_t flen;
        memcpy(&flen, buf + pos, 4);
        pos += 4;
        if (pos + flen > len) return false;
        const uint8_t* field = buf + pos;
        const uint8_t* eq = (const uint8_t*)memchr(field, '=', flen);
        if (!eq) return false;
        std::string name((const char*)field, eq - field);
        out[name] = std::vector<uint8_t>(eq + 1, field + flen);
        pos += flen;
    }
    return pos == len;
}

// Framing sanity caps: a lying length field in a corrupt/malicious bag
// must produce a clean error, not a multi-GB allocation or bad_alloc
// crash.  ROS headers are tiny; record payloads are bounded by chunk
// sizes real writers produce.
static const uint32_t MAX_HEADER_LEN = 1u << 20;        // 1 MB
static const uint32_t MAX_RECORD_LEN = 1u << 29;        // 512 MB

static Record read_record(FILE* f) {
    Record r;
    uint32_t hlen;
    if (!read_exact(f, &hlen, 4)) return r;
    if (hlen > MAX_HEADER_LEN) return r;
    std::vector<uint8_t> hbuf(hlen);
    if (!read_exact(f, hbuf.data(), hlen)) return r;
    if (!parse_header(hbuf.data(), hlen, r.header)) return r;
    uint32_t dlen;
    if (!read_exact(f, &dlen, 4)) return r;
    if (dlen > MAX_RECORD_LEN) return r;
    r.data.resize(dlen);
    if (dlen && !read_exact(f, r.data.data(), dlen)) return r;
    r.ok = true;
    return r;
}

static Record read_record_mem(const uint8_t* buf, size_t len, size_t* pos) {
    Record r;
    if (*pos + 4 > len) return r;
    uint32_t hlen;
    memcpy(&hlen, buf + *pos, 4);
    *pos += 4;
    if (*pos + hlen > len) return r;
    if (!parse_header(buf + *pos, hlen, r.header)) return r;
    *pos += hlen;
    if (*pos + 4 > len) return r;
    uint32_t dlen;
    memcpy(&dlen, buf + *pos, 4);
    *pos += 4;
    if (*pos + dlen > len) return r;
    r.data.assign(buf + *pos, buf + *pos + dlen);
    *pos += dlen;
    r.ok = true;
    return r;
}

static uint8_t header_op(const Record& r) {
    auto it = r.header.find("op");
    if (it == r.header.end() || it->second.empty()) return 0xFF;
    return it->second[0];
}

template <typename T>
static T header_num(const Record& r, const char* name, T fallback = T()) {
    auto it = r.header.find(name);
    if (it == r.header.end() || it->second.size() < sizeof(T)) return fallback;
    T v;
    memcpy(&v, it->second.data(), sizeof(T));
    return v;
}

static void process_embedded(BagHandle* h, const uint8_t* buf, size_t len) {
    size_t pos = 0;
    while (pos < len) {
        Record r = read_record_mem(buf, len, &pos);
        if (!r.ok) break;
        uint8_t op = header_op(r);
        if (op == 0x07) {  // connection
            int32_t conn = header_num<int32_t>(r, "conn", -1);
            auto t = r.header.find("topic");
            if (t != r.header.end())
                h->topics[conn] = std::string(t->second.begin(),
                                              t->second.end());
            std::map<std::string, std::vector<uint8_t>> chdr;
            if (parse_header(r.data.data(), r.data.size(), chdr)) {
                auto ty = chdr.find("type");
                if (ty != chdr.end())
                    h->types[conn] = std::string(ty->second.begin(),
                                                 ty->second.end());
            }
        } else if (op == 0x02) {  // message data
            BagMessage m;
            m.conn = header_num<int32_t>(r, "conn", -1);
            uint64_t t = header_num<uint64_t>(r, "time", 0);
            uint32_t sec = (uint32_t)(t & 0xFFFFFFFFu);
            uint32_t nsec = (uint32_t)(t >> 32);
            m.time = (double)sec + (double)nsec * 1e-9;
            m.data = std::move(r.data);
            h->pending.push_back(std::move(m));
        }
    }
}

extern "C" {

void* livo_bag_open(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    char line[64];
    if (!fgets(line, sizeof(line), f) ||
        strncmp(line, "#ROSBAG V2.0", 12) != 0) {
        fclose(f);
        return nullptr;
    }
    BagHandle* h = new BagHandle();
    h->f = f;
    return h;
}

// Pulls the next message.  Returns 1 on success, 0 on EOF, -1 on error.
int livo_bag_next(void* handle, int32_t* out_conn, double* out_time,
                  const uint8_t** out_data, long* out_len) {
    BagHandle* h = (BagHandle*)handle;
    while (true) {
        if (h->pending_idx < h->pending.size()) {
            BagMessage& m = h->pending[h->pending_idx++];
            *out_conn = m.conn;
            *out_time = m.time;
            *out_data = m.data.data();
            *out_len = (long)m.data.size();
            return 1;
        }
        h->pending.clear();
        h->pending_idx = 0;
        Record r = read_record(h->f);
        if (!r.ok) {
            if (feof(h->f)) return 0;
            h->error = "malformed record framing (truncated record, "
                       "oversized length field, or bad header)";
            return -1;
        }
        uint8_t op = header_op(r);
        if (op == 0x07 || op == 0x02) {
            // unchunked connection/message at top level
            if (op == 0x07) {
                int32_t conn = header_num<int32_t>(r, "conn", -1);
                auto t = r.header.find("topic");
                if (t != r.header.end())
                    h->topics[conn] = std::string(t->second.begin(),
                                                  t->second.end());
                std::map<std::string, std::vector<uint8_t>> chdr;
                if (parse_header(r.data.data(), r.data.size(), chdr)) {
                    auto ty = chdr.find("type");
                    if (ty != chdr.end())
                        h->types[conn] = std::string(ty->second.begin(),
                                                     ty->second.end());
                }
            } else {
                BagMessage m;
                m.conn = header_num<int32_t>(r, "conn", -1);
                uint64_t t = header_num<uint64_t>(r, "time", 0);
                m.time = (double)(uint32_t)(t & 0xFFFFFFFFu)
                         + (double)(uint32_t)(t >> 32) * 1e-9;
                m.data = std::move(r.data);
                h->pending.push_back(std::move(m));
            }
        } else if (op == 0x05) {  // chunk
            std::string comp = "none";
            auto c = r.header.find("compression");
            if (c != r.header.end())
                comp = std::string(c->second.begin(), c->second.end());
            uint32_t raw_size = header_num<uint32_t>(r, "size",
                                                     (uint32_t)r.data.size());
            if (raw_size > MAX_RECORD_LEN) {
                h->error = "chunk size field exceeds sanity cap";
                return -1;
            }
            if (comp == "none") {
                process_embedded(h, r.data.data(), r.data.size());
            } else if (comp == "bz2") {
                bz2_decomp_fn fn = load_bz2();
                if (!fn) { h->error = "libbz2 unavailable"; return -1; }
                std::vector<uint8_t> out(raw_size);
                unsigned dest_len = raw_size;
                int rc = fn((char*)out.data(), &dest_len, (char*)r.data.data(),
                            (unsigned)r.data.size(), 0, 0);
                if (rc != 0) { h->error = "bz2 decompress failed"; return -1; }
                process_embedded(h, out.data(), dest_len);
            } else if (comp == "lz4") {
                lz4_decomp_fn fn = load_lz4();
                if (!fn) { h->error = "liblz4 unavailable"; return -1; }
                std::vector<uint8_t> out(raw_size);
                int rc = fn((const char*)r.data.data(), (char*)out.data(),
                            (int)r.data.size(), (int)raw_size);
                if (rc < 0) { h->error = "lz4 decompress failed"; return -1; }
                process_embedded(h, out.data(), (size_t)rc);
            } else {
                h->error = "unknown compression: " + comp;
                return -1;
            }
        }
        // other ops (index/chunk-info/bag-header) skipped
    }
}

const char* livo_bag_topic(void* handle, int32_t conn) {
    BagHandle* h = (BagHandle*)handle;
    auto it = h->topics.find(conn);
    return it == h->topics.end() ? "" : it->second.c_str();
}

const char* livo_bag_type(void* handle, int32_t conn) {
    BagHandle* h = (BagHandle*)handle;
    auto it = h->types.find(conn);
    return it == h->types.end() ? "" : it->second.c_str();
}

const char* livo_bag_error(void* handle) {
    return ((BagHandle*)handle)->error.c_str();
}

void livo_bag_close(void* handle) {
    BagHandle* h = (BagHandle*)handle;
    if (h->f) fclose(h->f);
    delete h;
}

}  // extern "C"
