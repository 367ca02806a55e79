// The progressive probabilistic Hough transform (Matas, Galambos and
// Kittler, "Robust detection of lines using the progressive probabilistic
// Hough transform", CVIU 2000), for the host.
//
// It follows what OpenCV's `HoughLinesP` does on a uint8 mask, so that its
// segments are OpenCV's, in OpenCV's order:
//   - the nonzero pixels are collected row by row; a pixel is drawn by
//     OpenCV's multiply-with-carry generator `RNG((uint64)-1)`
//     (`uniform(0, count)` is the next 32-bit value modulo count), replaced
//     by the last one still in the list, and skipped if a segment already
//     cleared it;
//   - rho and theta are floats; the table holds (float)(cos(n theta) / rho)
//     and (float)(sin(n theta) / rho) computed in double; a vote goes to
//     bin round(x * cos + y * sin) + (numrho - 1) / 2, the sum in float and
//     rounded half to even (cvRound);
//   - numangle is computeNumangle(0, pi, theta), numrho
//     round(((w + h) * 2 + 1) / rho);
//   - from a pixel whose best bin reaches the threshold, the line is walked
//     both ways in 16-bit fixed point until more than `line_gap` pixels in a
//     row are off; the segment is kept if |dx| or |dy| reaches
//     `min_length`, and then its pixels are cleared and their votes taken
//     back (a rejected segment's pixels are cleared without it).
// Build with -ffp-contract=off: the float sums must not become FMAs.
//
// C interface (ctypes): gf_hough_lines_p.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <vector>

namespace {

constexpr double kPi = 3.1415926535897932384626433832795;

struct Rng {
    uint64_t state;
    explicit Rng(uint64_t s) : state(s ? s : 0xffffffffu) {}
    unsigned next() {
        state = (uint64_t)(unsigned)state * 4164903690u + (unsigned)(state >> 32);
        return (unsigned)state;
    }
    int uniform(int a, int b) { return a == b ? a : (int)(next() % (unsigned)(b - a) + a); }
};

int round_half_even(float v) { return (int)std::lrintf(v); }
int round_half_even(double v) { return (int)std::lrint(v); }

int num_angles(double min_theta, double max_theta, double theta_step) {
    int n = (int)std::floor((max_theta - min_theta) / theta_step) + 1;
    if (n > 1 && std::fabs(kPi - (n - 1) * theta_step) < theta_step / 2) --n;
    return n;
}

struct Pt {
    int x, y;
};

void hough_lines_p(const uint8_t* image, int height, int width, float rho, float theta, int threshold,
                   int line_length, int line_gap, std::vector<int>& lines) {
    const float irho = 1 / rho;
    Rng rng((uint64_t)-1);
    const int numangle = num_angles(0.0, kPi, theta);
    const int numrho = round_half_even(((width + height) * 2 + 1) / rho);
    std::vector<int> accum((size_t)numangle * numrho, 0);
    std::vector<uint8_t> mask((size_t)height * width);
    std::vector<float> ttab((size_t)numangle * 2);
    for (int n = 0; n < numangle; ++n) {
        ttab[n * 2] = (float)(std::cos((double)n * theta) * irho);
        ttab[n * 2 + 1] = (float)(std::sin((double)n * theta) * irho);
    }
    std::vector<Pt> nzloc;
    for (int y = 0; y < height; ++y) {
        for (int x = 0; x < width; ++x) {
            const bool on = image[(size_t)y * width + x] != 0;
            mask[(size_t)y * width + x] = on;
            if (on) nzloc.push_back({x, y});
        }
    }
    uint8_t* mdata0 = mask.data();
    const int shift = 16;
    for (int count = (int)nzloc.size(); count > 0; --count) {
        const int idx = rng.uniform(0, count);
        int max_val = threshold - 1, max_n = 0;
        const Pt point = nzloc[idx];
        Pt line_end[2] = {{0, 0}, {0, 0}};
        const int i = point.y, j = point.x;
        int x0, y0, dx0, dy0, xflag;
        nzloc[idx] = nzloc[count - 1];
        if (!mdata0[(size_t)i * width + j]) continue;

        int* adata = accum.data();
        for (int n = 0; n < numangle; ++n, adata += numrho) {
            int r = round_half_even(j * ttab[n * 2] + i * ttab[n * 2 + 1]);
            r += (numrho - 1) / 2;
            const int val = ++adata[r];
            if (max_val < val) {
                max_val = val;
                max_n = n;
            }
        }
        if (max_val < threshold) continue;

        const float a = -ttab[max_n * 2 + 1];
        const float b = ttab[max_n * 2];
        x0 = j;
        y0 = i;
        if (std::fabs(a) > std::fabs(b)) {
            xflag = 1;
            dx0 = a > 0 ? 1 : -1;
            dy0 = round_half_even(b * (1 << shift) / std::fabs(a));
            y0 = (y0 << shift) + (1 << (shift - 1));
        } else {
            xflag = 0;
            dy0 = b > 0 ? 1 : -1;
            dx0 = round_half_even(a * (1 << shift) / std::fabs(b));
            x0 = (x0 << shift) + (1 << (shift - 1));
        }

        for (int k = 0; k < 2; ++k) {
            int gap = 0, x = x0, y = y0, dx = dx0, dy = dy0;
            if (k > 0) dx = -dx, dy = -dy;
            for (;; x += dx, y += dy) {
                int i1, j1;
                if (xflag) {
                    j1 = x;
                    i1 = y >> shift;
                } else {
                    j1 = x >> shift;
                    i1 = y;
                }
                if (j1 < 0 || j1 >= width || i1 < 0 || i1 >= height) break;
                if (mdata0[(size_t)i1 * width + j1]) {
                    gap = 0;
                    line_end[k].y = i1;
                    line_end[k].x = j1;
                } else if (++gap > line_gap) {
                    break;
                }
            }
        }

        const bool good_line = std::abs(line_end[1].x - line_end[0].x) >= line_length ||
                               std::abs(line_end[1].y - line_end[0].y) >= line_length;

        for (int k = 0; k < 2; ++k) {
            int x = x0, y = y0, dx = dx0, dy = dy0;
            if (k > 0) dx = -dx, dy = -dy;
            for (;; x += dx, y += dy) {
                int i1, j1;
                if (xflag) {
                    j1 = x;
                    i1 = y >> shift;
                } else {
                    j1 = x >> shift;
                    i1 = y;
                }
                uint8_t* mdata = mdata0 + (size_t)i1 * width + j1;
                if (*mdata) {
                    if (good_line) {
                        int* ad = accum.data();
                        for (int n = 0; n < numangle; ++n, ad += numrho) {
                            int r = round_half_even(j1 * ttab[n * 2] + i1 * ttab[n * 2 + 1]);
                            r += (numrho - 1) / 2;
                            ad[r]--;
                        }
                    }
                    *mdata = 0;
                }
                if (i1 == line_end[k].y && j1 == line_end[k].x) break;
            }
        }

        if (good_line) {
            lines.push_back(line_end[0].x);
            lines.push_back(line_end[0].y);
            lines.push_back(line_end[1].x);
            lines.push_back(line_end[1].y);
        }
    }
}

}  // namespace

extern "C" {

// Segments of the h x w uint8 mask `mask` (row-major, nonzero = on), as
// HoughLinesP(mask, rho, theta, threshold, min_length, max_gap) gives them:
// min_length and max_gap are rounded half to even first. Writes at most
// `capacity` segments (x1, y1, x2, y2) int32 to `out`. Returns the number
// found, which may exceed `capacity` (call again with room for all), or -1
// on an error.
int gf_hough_lines_p(const uint8_t* mask, int h, int w, double rho, double theta, int threshold,
                     double min_length, double max_gap, int capacity, int32_t* out) {
    if (h < 1 || w < 1 || !(rho > 0) || !(theta > 0)) return -1;
    try {
        std::vector<int> lines;
        hough_lines_p(mask, h, w, (float)rho, (float)theta, threshold, round_half_even(min_length),
                      round_half_even(max_gap), lines);
        const int n = (int)(lines.size() / 4);
        for (int s = 0; s < std::min(n, capacity) * 4; ++s) out[s] = lines[s];
        return n;
    } catch (...) {
        return -1;
    }
}

}  // extern "C"
