// LSD, the line segment detector of Grompone von Gioi, Jakubowicz, Morel
// and Randall ("LSD: a Line Segment Detector", IPOL 2012), for the host.
//
// It follows what OpenCV's `createLineSegmentDetector(LSD_REFINE_ADV)`
// does on a uint8 grey image, with scale 0.8, sigma_scale 0.6, quant 2,
// ang_th 22.5, log_eps 0, density_th 0.7 and n_bins 1024:
//   - the image is blurred in fixed point, as OpenCV's bit-exact GaussianBlur
//     of a uint8 image with a 7x7 kernel of sigma sigma_scale / scale = 0.75
//     and reflect-101 borders, then resized by 0.8 as OpenCV's bit-exact
//     linear resize of uint8; both are bit-equal to cv2;
//   - the gradient angle is OpenCV's polynomial `fastAtan2` in degrees,
//     converted to [0, 2 pi), as are the region's running angle (summed in
//     float) and the rectangle's principal axis;
//   - pixels are visited in descending order of their gradient bin, row by
//     row within a bin (a stable sort);
//   - the rectangle's pixels for its NFA are those of OpenCV 5's scanline
//     walk (rows from the topmost corner down, each row from the ceiling of
//     its left edge to its right edge truncated), not the paper's column
//     iterator: the two differ by a row or a pixel on most rectangles.
// On the images of tests/test_torch_lsd.py the output is bit-equal to cv2
// 5.0's. Build with -ffp-contract=off: nothing here may be contracted into
// FMAs.
//
// C interface (ctypes): gf_lsd runs the detector; gf_lsd_scaled returns the
// blurred and resized image the detector works on, for tests.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstddef>
#include <cstring>
#include <vector>

namespace {

constexpr double kPi = 3.1415926535897932384626433832795;
constexpr double k2Pi = 2 * kPi;
constexpr double k3Pi2 = (3 * kPi) / 2;
constexpr double kDegToRad = kPi / 180;
constexpr double kNotDef = -1024.0;
constexpr double kScale = 0.8;
constexpr double kQuant = 2.0;
constexpr double kAngTh = 22.5;
constexpr double kLogEps = 0.0;
constexpr double kDensityTh = 0.7;
constexpr int kNBins = 1024;
constexpr double kRelativeErrorFactor = 100.0;
constexpr uint8_t kNotUsed = 0;
constexpr uint8_t kUsed = 1;

float fast_atan2(float y, float x) {
    static const float p1 = 0.9997878412794807f * (float)(180 / kPi);
    static const float p3 = -0.3258083974640975f * (float)(180 / kPi);
    static const float p5 = 0.1555786518463281f * (float)(180 / kPi);
    static const float p7 = -0.04432655554792128f * (float)(180 / kPi);
    float ax = std::fabs(x), ay = std::fabs(y);
    float a, c, c2;
    if (ax >= ay) {
        c = ay / (ax + (float)DBL_EPSILON);
        c2 = c * c;
        a = (((p7 * c2 + p5) * c2 + p3) * c2 + p1) * c;
    } else {
        c = ax / (ay + (float)DBL_EPSILON);
        c2 = c * c;
        a = 90.f - (((p7 * c2 + p5) * c2 + p3) * c2 + p1) * c;
    }
    if (x < 0) a = 180.f - a;
    if (y < 0) a = 360.f - a;
    return a;
}

int reflect101(int i, int n) {
    if (n == 1) return 0;
    while (i < 0 || i >= n) {
        if (i < 0) i = -i;
        if (i >= n) i = 2 * n - 2 - i;
    }
    return i;
}

// OpenCV's fixed-point Gaussian of a uint8 image (GaussianBlur's bit-exact
// path): taps in 1/256, error-diffused to sum to 256; the row pass is exact,
// the column pass rounds once at the end.
constexpr int kTaps[7] = {0, 4, 56, 136, 56, 4, 0};
std::vector<uint8_t> gaussian_blur(const uint8_t* src, int h, int w) {
    const int r = 3;
    std::vector<uint32_t> rows((size_t)(h + 2 * r) * w);
    for (int y = -r; y < h + r; ++y) {
        const uint8_t* s = &src[(size_t)reflect101(y, h) * w];
        uint32_t* o = &rows[(size_t)(y + r) * w];
        for (int x = 0; x < w; ++x) {
            uint32_t acc = 0;
            for (int k = 0; k < 7; ++k) acc += kTaps[k] * s[reflect101(x - r + k, w)];
            o[x] = acc;
        }
    }
    std::vector<uint8_t> dst((size_t)h * w);
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
            uint32_t acc = 0;
            for (int k = 0; k < 7; ++k) acc += kTaps[k] * rows[(size_t)(y + k) * w + x];
            dst[(size_t)y * w + x] = (uint8_t)std::min<uint32_t>((acc + (1u << 15)) >> 16, 255u);
        }
    return dst;
}

// OpenCV's bit-exact linear resize of a uint8 image by 0.8: weights in 1/256
// (the source positions (d + 0.5) * 1.25 - 0.5 are multiples of 1/8), the
// row pass exact, the column pass rounding once.
void resize_taps(int n_in, int n_out, std::vector<int>& idx, std::vector<uint32_t>& w1) {
    idx.resize(n_out);
    w1.resize(n_out);
    for (int d = 0; d < n_out; ++d) {
        double s = (d + 0.5) * (1.0 / kScale) - 0.5;
        int i = (int)std::floor(s);
        if (i < 0) {
            idx[d] = 0, w1[d] = 0;
        } else if (i >= n_in - 1) {
            idx[d] = n_in - 1, w1[d] = 0;
        } else {
            idx[d] = i, w1[d] = (uint32_t)std::lrint((s - i) * 256);
        }
    }
}

std::vector<double> resize08(const std::vector<uint8_t>& src, int h, int w, int& oh, int& ow) {
    ow = (int)std::lrint(w * kScale);
    oh = (int)std::lrint(h * kScale);
    std::vector<int> xi, yi;
    std::vector<uint32_t> xw, yw;
    resize_taps(w, ow, xi, xw);
    resize_taps(h, oh, yi, yw);
    std::vector<uint32_t> tmp((size_t)h * ow);
    for (int y = 0; y < h; ++y) {
        const uint8_t* s = &src[(size_t)y * w];
        for (int x = 0; x < ow; ++x)
            tmp[(size_t)y * ow + x] = (256 - xw[x]) * s[xi[x]] + xw[x] * s[std::min(xi[x] + 1, w - 1)];
    }
    std::vector<double> dst((size_t)oh * ow);
    for (int y = 0; y < oh; ++y) {
        const uint32_t* t0 = &tmp[(size_t)yi[y] * ow];
        const uint32_t* t1 = &tmp[(size_t)std::min(yi[y] + 1, h - 1) * ow];
        for (int x = 0; x < ow; ++x) {
            uint32_t v = (256 - yw[y]) * t0[x] + yw[y] * t1[x];
            dst[(size_t)y * ow + x] = (double)std::min<uint32_t>((v + (1u << 15)) >> 16, 255u);
        }
    }
    return dst;
}

inline bool double_equal(double a, double b) {
    if (a == b) return true;
    double abs_diff = std::fabs(a - b);
    double aa = std::fabs(a), bb = std::fabs(b);
    double abs_max = aa > bb ? aa : bb;
    if (abs_max < DBL_MIN) abs_max = DBL_MIN;
    return (abs_diff / abs_max) <= (kRelativeErrorFactor * DBL_EPSILON);
}

inline double angle_diff_signed(double a, double b) {
    double diff = a - b;
    while (diff <= -kPi) diff += k2Pi;
    while (diff > kPi) diff -= k2Pi;
    return diff;
}

inline double angle_diff(double a, double b) { return std::fabs(angle_diff_signed(a, b)); }

inline double dist(double x1, double y1, double x2, double y2) {
    return std::sqrt((x2 - x1) * (x2 - x1) + (y2 - y1) * (y2 - y1));
}

inline double dist_sq(double x1, double y1, double x2, double y2) {
    return (x2 - x1) * (x2 - x1) + (y2 - y1) * (y2 - y1);
}

inline double log_gamma_windschitl(double x) {
    return 0.918938533204673 + (x - 0.5) * std::log(x) - x +
           0.5 * x * std::log(x * std::sinh(1 / x) + 1 / (810.0 * std::pow(x, 6.0)));
}

inline double log_gamma_lanczos(double x) {
    static const double q[7] = {75122.6331530, 80916.6278952, 36308.2951477, 8687.24529705,
                                1168.92649479, 83.8676043424, 2.50662827511};
    double a = (x + 0.5) * std::log(x + 5.5) - (x + 5.5);
    double b = 0;
    for (int n = 0; n < 7; ++n) {
        a -= std::log(x + double(n));
        b += q[n] * std::pow(x, double(n));
    }
    return a + std::log(b);
}

inline double log_gamma(double x) { return x > 15.0 ? log_gamma_windschitl(x) : log_gamma_lanczos(x); }

struct RegionPoint {
    int x, y;
    uint8_t* used;
    double angle;
    double modgrad;
};

struct NormPoint {
    int x, y;
    int norm;
};

struct Rect {
    double x1, y1, x2, y2;
    double width;
    double x, y;
    double theta;
    double dx, dy;
    double prec;
    double p;
};

struct Segment {
    float x1, y1, x2, y2;
    double width, prec, nfa;
};

class Detector {
  public:
    std::vector<Segment> run(const uint8_t* img, int h, int w) {
        scaled_ = resize08(gaussian_blur(img, h, w), h, w, height_, width_);
        detect();
        return out_;
    }

    std::vector<double> scaled(const uint8_t* img, int h, int w, int& oh, int& ow) {
        return resize08(gaussian_blur(img, h, w), h, w, oh, ow);
    }

  private:
    std::vector<double> scaled_, angles_, modgrad_;
    std::vector<uint8_t> used_;
    std::vector<NormPoint> ordered_;
    std::vector<Segment> out_;
    int width_ = 0, height_ = 0;
    double log_nt_ = 0;

    double angle(int x, int y) const { return angles_[(size_t)y * width_ + x]; }

    void ll_angle(double threshold) {
        const int W = width_, H = height_;
        angles_.assign((size_t)W * H, 0.0);
        modgrad_.assign((size_t)W * H, 0.0);
        for (int x = 0; x < W; ++x) angles_[(size_t)(H - 1) * W + x] = kNotDef;
        for (int y = 0; y < H; ++y) angles_[(size_t)y * W + W - 1] = kNotDef;
        double max_grad = -1;
        for (int y = 0; y < H - 1; ++y) {
            const double* row = &scaled_[(size_t)y * W];
            const double* next = &scaled_[(size_t)(y + 1) * W];
            for (int x = 0; x < W - 1; ++x) {
                double DA = next[x + 1] - row[x];
                double BC = row[x + 1] - next[x];
                double gx = DA + BC;
                double gy = DA - BC;
                double norm = std::sqrt((gx * gx + gy * gy) / 4);
                modgrad_[(size_t)y * W + x] = norm;
                if (norm <= threshold) {
                    angles_[(size_t)y * W + x] = kNotDef;
                } else {
                    angles_[(size_t)y * W + x] = fast_atan2(float(gx), float(-gy)) * kDegToRad;
                    if (norm > max_grad) max_grad = norm;
                }
            }
        }
        double bin_coef = (max_grad > 0) ? double(kNBins - 1) / max_grad : 0;
        ordered_.clear();
        ordered_.reserve((size_t)(W - 1) * std::max(H - 1, 0));
        for (int y = 0; y < H - 1; ++y) {
            for (int x = 0; x < W - 1; ++x) {
                ordered_.push_back({x, y, int(modgrad_[(size_t)y * W + x] * bin_coef)});
            }
        }
        std::stable_sort(ordered_.begin(), ordered_.end(),
                         [](const NormPoint& a, const NormPoint& b) { return a.norm > b.norm; });
    }

    bool is_aligned(int x, int y, double theta, double prec) const {
        if (x < 0 || y < 0 || x >= width_ || y >= height_) return false;
        const double a = angle(x, y);
        if (a == kNotDef) return false;
        double n_theta = theta - a;
        if (n_theta < 0) n_theta = -n_theta;
        if (n_theta > k3Pi2) {
            n_theta -= k2Pi;
            if (n_theta < 0) n_theta = -n_theta;
        }
        return n_theta <= prec;
    }

    void region_grow(int sx, int sy, std::vector<RegionPoint>& reg, double& reg_angle, double prec) {
        reg.clear();
        RegionPoint seed;
        seed.x = sx;
        seed.y = sy;
        seed.used = &used_[(size_t)sy * width_ + sx];
        reg_angle = angle(sx, sy);
        seed.angle = reg_angle;
        seed.modgrad = modgrad_[(size_t)sy * width_ + sx];
        reg.push_back(seed);
        float sumdx = float(std::cos(reg_angle));
        float sumdy = float(std::sin(reg_angle));
        *seed.used = kUsed;
        for (size_t i = 0; i < reg.size(); ++i) {
            const int px = reg[i].x, py = reg[i].y;
            int xx_min = std::max(px - 1, 0), xx_max = std::min(px + 1, width_ - 1);
            int yy_min = std::max(py - 1, 0), yy_max = std::min(py + 1, height_ - 1);
            for (int yy = yy_min; yy <= yy_max; ++yy) {
                for (int xx = xx_min; xx <= xx_max; ++xx) {
                    uint8_t& is_used = used_[(size_t)yy * width_ + xx];
                    if (is_used != kUsed && is_aligned(xx, yy, reg_angle, prec)) {
                        const double a = angle(xx, yy);
                        is_used = kUsed;
                        RegionPoint rp;
                        rp.x = xx;
                        rp.y = yy;
                        rp.used = &is_used;
                        rp.modgrad = modgrad_[(size_t)yy * width_ + xx];
                        rp.angle = a;
                        reg.push_back(rp);
                        sumdx += std::cos(float(a));
                        sumdy += std::sin(float(a));
                        reg_angle = fast_atan2(sumdy, sumdx) * kDegToRad;
                    }
                }
            }
        }
    }

    double get_theta(const std::vector<RegionPoint>& reg, double x, double y, double reg_angle,
                     double prec) const {
        double Ixx = 0.0, Iyy = 0.0, Ixy = 0.0;
        for (const RegionPoint& p : reg) {
            const double regx = p.x, regy = p.y, weight = p.modgrad;
            double dx = regx - x, dy = regy - y;
            Ixx += dy * dy * weight;
            Iyy += dx * dx * weight;
            Ixy -= dx * dy * weight;
        }
        double lambda = 0.5 * (Ixx + Iyy - std::sqrt((Ixx - Iyy) * (Ixx - Iyy) + 4.0 * Ixy * Ixy));
        double theta = (std::fabs(Ixx) > std::fabs(Iyy)) ? double(fast_atan2(float(lambda - Ixx), float(Ixy)))
                                                         : double(fast_atan2(float(Ixy), float(lambda - Iyy)));
        theta *= kDegToRad;
        if (angle_diff(theta, reg_angle) > prec) theta += kPi;
        return theta;
    }

    void region2rect(const std::vector<RegionPoint>& reg, double reg_angle, double prec, double p,
                     Rect& rec) const {
        double x = 0, y = 0, sum = 0;
        for (const RegionPoint& pnt : reg) {
            const double weight = pnt.modgrad;
            x += double(pnt.x) * weight;
            y += double(pnt.y) * weight;
            sum += weight;
        }
        x /= sum;
        y /= sum;
        double theta = get_theta(reg, x, y, reg_angle, prec);
        double dx = std::cos(theta), dy = std::sin(theta);
        double l_min = 0, l_max = 0, w_min = 0, w_max = 0;
        for (const RegionPoint& pnt : reg) {
            double regdx = double(pnt.x) - x;
            double regdy = double(pnt.y) - y;
            double l = regdx * dx + regdy * dy;
            double wd = -regdx * dy + regdy * dx;
            if (l > l_max)
                l_max = l;
            else if (l < l_min)
                l_min = l;
            if (wd > w_max)
                w_max = wd;
            else if (wd < w_min)
                w_min = wd;
        }
        rec.x1 = x + l_min * dx;
        rec.y1 = y + l_min * dy;
        rec.x2 = x + l_max * dx;
        rec.y2 = y + l_max * dy;
        rec.width = w_max - w_min;
        rec.x = x;
        rec.y = y;
        rec.theta = theta;
        rec.dx = dx;
        rec.dy = dy;
        rec.prec = prec;
        rec.p = p;
        if (rec.width < 1.0) rec.width = 1.0;
    }

    bool reduce_region_radius(std::vector<RegionPoint>& reg, double reg_angle, double prec, double p,
                              Rect& rec, double density) {
        double xc = double(reg[0].x), yc = double(reg[0].y);
        double rad1 = dist_sq(xc, yc, rec.x1, rec.y1);
        double rad2 = dist_sq(xc, yc, rec.x2, rec.y2);
        double rad = rad1 > rad2 ? rad1 : rad2;
        while (density < kDensityTh) {
            rad *= 0.75 * 0.75;
            for (size_t i = 0; i < reg.size(); ++i) {
                if (dist_sq(xc, yc, double(reg[i].x), double(reg[i].y)) > rad) {
                    *(reg[i].used) = kNotUsed;
                    std::swap(reg[i], reg[reg.size() - 1]);
                    reg.pop_back();
                    --i;
                }
            }
            if (reg.size() < 2) return false;
            region2rect(reg, reg_angle, prec, p, rec);
            density = double(reg.size()) / (dist(rec.x1, rec.y1, rec.x2, rec.y2) * rec.width);
        }
        return true;
    }

    bool refine(std::vector<RegionPoint>& reg, double reg_angle, double prec, double p, Rect& rec) {
        double density = double(reg.size()) / (dist(rec.x1, rec.y1, rec.x2, rec.y2) * rec.width);
        if (density >= kDensityTh) return true;
        double xc = double(reg[0].x), yc = double(reg[0].y);
        const double ang_c = reg[0].angle;
        double sum = 0, s_sum = 0;
        int n = 0;
        for (RegionPoint& pnt : reg) {
            *(pnt.used) = kNotUsed;
            if (dist(xc, yc, pnt.x, pnt.y) < rec.width) {
                double ang_d = angle_diff_signed(pnt.angle, ang_c);
                sum += ang_d;
                s_sum += ang_d * ang_d;
                ++n;
            }
        }
        double mean_angle = sum / double(n);
        double tau = 2.0 * std::sqrt((s_sum - 2.0 * mean_angle * sum) / double(n) + mean_angle * mean_angle);
        region_grow(reg[0].x, reg[0].y, reg, reg_angle, tau);
        if (reg.size() < 2) return false;
        region2rect(reg, reg_angle, prec, p, rec);
        density = double(reg.size()) / (dist(rec.x1, rec.y1, rec.x2, rec.y2) * rec.width);
        if (density < kDensityTh) return reduce_region_radius(reg, reg_angle, prec, p, rec, density);
        return true;
    }

    double nfa(int n, int k, double p) const {
        if (n == 0 || k == 0) return -log_nt_;
        if (n == k) return -log_nt_ - double(n) * std::log10(p);
        double p_term = p / (1 - p);
        double log1term = log_gamma(double(n) + 1) - log_gamma(double(k) + 1) - log_gamma(double(n - k) + 1) +
                          double(k) * std::log(p) + double(n - k) * std::log(1.0 - p);
        double term = std::exp(log1term);
        if (double_equal(term, 0)) {
            if (k > n * p)
                return -log1term / M_LN10 - log_nt_;
            else
                return -log_nt_;
        }
        double bin_tail = term;
        double tolerance = 0.1;
        for (int i = k + 1; i <= n; ++i) {
            double bin_term = double(n - i + 1) / double(i);
            double mult_term = bin_term * p_term;
            term *= mult_term;
            bin_tail += term;
            if (bin_term < 1) {
                double err = term * ((1 - std::pow(mult_term, double(n - i + 1))) / (1 - mult_term) - 1);
                if (err < tolerance * std::fabs(-std::log10(bin_tail) - log_nt_) * bin_tail) break;
            }
        }
        return -std::log10(bin_tail) - log_nt_;
    }

    // -log10(NFA) of the rectangle. Its pixels are those of OpenCV 5's
    // scanline walk: the corners ordered from the topmost (least y, then
    // least x), rows ceil(top y) to ceil(bottom y), and in each row the
    // columns from ceil of the left edge to the right edge truncated to int.
    double rect_nfa(const Rect& r) const {
        const double hw = r.width * 0.5;
        const double dyhw = r.dy * hw, dxhw = r.dx * hw;
        const double cx[4] = {r.x1 - dyhw, r.x2 - dyhw, r.x2 + dyhw, r.x1 + dyhw};
        const double cy[4] = {r.y1 + dxhw, r.y2 + dxhw, r.y2 - dxhw, r.y1 - dxhw};
        int top = 0;
        for (int i = 1; i < 4; ++i)
            if (cy[i] < cy[top] || (cy[i] == cy[top] && cx[i] < cx[top])) top = i;
        double vx[4], vy[4];
        int iy[4];
        for (int i = 0; i < 4; ++i) {
            vx[i] = cx[(top + i) % 4];
            vy[i] = cy[(top + i) % 4];
            iy[i] = (int)std::ceil(vy[i]);
        }
        const double s01 = iy[1] != iy[0] ? (vx[1] - vx[0]) / (vy[1] - vy[0]) : 0.0;
        const double s12 = iy[2] != iy[1] ? (vx[2] - vx[1]) / (vy[2] - vy[1]) : 0.0;
        const double s03 = iy[3] != iy[0] ? (vx[3] - vx[0]) / (vy[3] - vy[0]) : 0.0;
        const double s32 = iy[3] != iy[2] ? (vx[2] - vx[3]) / (vy[2] - vy[3]) : 0.0;
        int pts = 0, alg = 0;
        for (int y = iy[0]; y <= iy[2]; ++y) {
            if (y < 0 || y >= height_) continue;
            const double left = y <= iy[1] ? (y - vy[0]) * s01 + vx[0] : (y - vy[1]) * s12 + vx[1];
            const double right = y < iy[3] ? (y - vy[0]) * s03 + vx[0] : (y - vy[3]) * s32 + vx[3];
            const int x_end = (int)right;
            for (int x = std::max((int)std::ceil(left), 0); x <= x_end && x < width_; ++x) {
                ++pts;
                if (is_aligned(x, y, r.theta, r.prec)) ++alg;
            }
        }
        return nfa(pts, alg, r.p);
    }

    double rect_improve(Rect& rec) const {
        const double delta = 0.5, delta_2 = delta / 2.0;
        double log_nfa = rect_nfa(rec);
        if (log_nfa > kLogEps) return log_nfa;
        Rect r = rec;
        for (int n = 0; n < 5; ++n) {
            r.p /= 2;
            r.prec = r.p * kPi;
            double v = rect_nfa(r);
            if (v > log_nfa) {
                log_nfa = v;
                rec = r;
            }
        }
        if (log_nfa > kLogEps) return log_nfa;
        r = rec;
        for (int n = 0; n < 5; ++n) {
            if ((r.width - delta) >= 0.5) {
                r.width -= delta;
                double v = rect_nfa(r);
                if (v > log_nfa) {
                    rec = r;
                    log_nfa = v;
                }
            }
        }
        if (log_nfa > kLogEps) return log_nfa;
        r = rec;
        for (int n = 0; n < 5; ++n) {
            if ((r.width - delta) >= 0.5) {
                r.x1 += -r.dy * delta_2;
                r.y1 += r.dx * delta_2;
                r.x2 += -r.dy * delta_2;
                r.y2 += r.dx * delta_2;
                r.width -= delta;
                double v = rect_nfa(r);
                if (v > log_nfa) {
                    rec = r;
                    log_nfa = v;
                }
            }
        }
        if (log_nfa > kLogEps) return log_nfa;
        r = rec;
        for (int n = 0; n < 5; ++n) {
            if ((r.width - delta) >= 0.5) {
                r.x1 -= -r.dy * delta_2;
                r.y1 -= r.dx * delta_2;
                r.x2 -= -r.dy * delta_2;
                r.y2 -= r.dx * delta_2;
                r.width -= delta;
                double v = rect_nfa(r);
                if (v > log_nfa) {
                    rec = r;
                    log_nfa = v;
                }
            }
        }
        if (log_nfa > kLogEps) return log_nfa;
        r = rec;
        for (int n = 0; n < 5; ++n) {
            if ((r.width - delta) >= 0.5) {
                r.p /= 2;
                r.prec = r.p * kPi;
                double v = rect_nfa(r);
                if (v > log_nfa) {
                    rec = r;
                    log_nfa = v;
                }
            }
        }
        return log_nfa;
    }

    void detect() {
        out_.clear();
        const double prec = kPi * kAngTh / 180;
        const double p = kAngTh / 180;
        const double rho = kQuant / std::sin(prec);
        ll_angle(rho);
        log_nt_ = 5 * (std::log10(double(width_)) + std::log10(double(height_))) / 2 + std::log10(11.0);
        const size_t min_reg_size = size_t(-log_nt_ / std::log10(p));
        used_.assign((size_t)width_ * height_, kNotUsed);
        std::vector<RegionPoint> reg;
        for (const NormPoint& pt : ordered_) {
            if (used_[(size_t)pt.y * width_ + pt.x] != kNotUsed || angle(pt.x, pt.y) == kNotDef) continue;
            double reg_angle;
            region_grow(pt.x, pt.y, reg, reg_angle, prec);
            if (reg.size() < min_reg_size) continue;
            Rect rec;
            region2rect(reg, reg_angle, prec, p, rec);
            if (!refine(reg, reg_angle, prec, p, rec)) continue;
            double log_nfa = rect_improve(rec);
            if (log_nfa <= kLogEps) continue;
            rec.x1 += 0.5;
            rec.y1 += 0.5;
            rec.x2 += 0.5;
            rec.y2 += 0.5;
            rec.x1 /= kScale;
            rec.y1 /= kScale;
            rec.x2 /= kScale;
            rec.y2 /= kScale;
            rec.width /= kScale;
            out_.push_back({float(rec.x1), float(rec.y1), float(rec.x2), float(rec.y2), rec.width, rec.p, log_nfa});
        }
    }
};

}  // namespace

extern "C" {

// Detects segments in the h x w uint8 image `img` (row-major). Writes at
// most `capacity` of them: segments (x1, y1, x2, y2) float32, and width,
// precision and -log10(NFA) as float64. Returns the number found, which
// may exceed `capacity` (call again with room for all), or -1 on an error.
int gf_lsd(const uint8_t* img, int h, int w, int capacity, float* segments, double* width, double* prec,
           double* nfa) {
    if (h < 1 || w < 1) return -1;
    try {
        Detector det;
        std::vector<Segment> segs = det.run(img, h, w);
        const int n = (int)segs.size();
        for (int i = 0; i < std::min(n, capacity); ++i) {
            segments[4 * i + 0] = segs[i].x1;
            segments[4 * i + 1] = segs[i].y1;
            segments[4 * i + 2] = segs[i].x2;
            segments[4 * i + 3] = segs[i].y2;
            width[i] = segs[i].width;
            prec[i] = segs[i].prec;
            nfa[i] = segs[i].nfa;
        }
        return n;
    } catch (...) {
        return -1;
    }
}

// The blurred and resized image the detector works on, round(h * 0.8) x
// round(w * 0.8) float64 into `out` (sized by the caller).
int gf_lsd_scaled(const uint8_t* img, int h, int w, double* out) {
    if (h < 1 || w < 1) return -1;
    try {
        Detector det;
        int oh, ow;
        std::vector<double> s = det.scaled(img, h, w, oh, ow);
        std::memcpy(out, s.data(), s.size() * sizeof(double));
        return 0;
    } catch (...) {
        return -1;
    }
}

}  // extern "C"
