// Lossy WebP: the VP8 key frame of RFC 6386 decoded to Y'CbCr 4:2:0, then
// to RGBA as libwebp's RGBA output gives it (its fancy upsampler and its
// fixed-point conversion), which is what PIL's WebP plugin hands to
// convert("RGB").
//
// The decode follows the RFC: the boolean entropy decoder (9.2, 7), the
// frame header (9.2-9.11), the per-macroblock modes (11) and tokens (13),
// dequantisation (14.1), the inverse WHT and DCT (14.3-14.4), intra
// prediction from the unfiltered reconstruction (12), and the normal and
// simple loop filters applied over the whole frame in macroblock order
// (15).  The tables below are the RFC's (13.5, 13.4, 14.1, 11.5).
#include <algorithm>
#include <cstring>

#include "image.h"
#include "webp.h"

namespace uvcimg {
namespace {

const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};

const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
    28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39,
    40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68,
    70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92,
    94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116,
    119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193,
    197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245,
    249, 254, 259, 264, 269, 274, 279, 284,
};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11,
                             14, 15};
// coefficient position -> band; the 17th entry serves the position after
// the last
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130,
                         129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// 4x4 intra modes (and the 16x16 / chroma modes they share codes with)
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
enum { DC_PRED = B_DC, TM_PRED = B_TM, V_PRED = B_VE, H_PRED = B_HE };

// The boolean entropy decoder (RFC 6386, 7.3), reading zeros past the end
// of its partition; `eof` once a bit is read whose 8-bit window reaches
// past the end, where libwebp's reader stops.
struct BoolDecoder {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint32_t value = 0;
  uint32_t range = 255;
  int bit_count = 0;
  uint64_t shifts = 0, last_window = 0;  // the window's start, in bits
  bool eof = false;

  void init(const uint8_t* start, size_t n) {
    p = start;
    end = start + n;
    value = uint32_t(next()) << 8;
    value |= next();
    range = 255;
    bit_count = 0;
    shifts = 0;
    last_window = n ? 8 * (uint64_t(n) - 1) : 0;
    eof = n == 0;
  }
  int next() { return p < end ? *p++ : 0; }
  int get(int prob) {
    if (shifts > last_window) eof = true;
    const uint32_t split = 1 + (((range - 1) * uint32_t(prob)) >> 8);
    const uint32_t big = split << 8;
    int bit;
    if (value >= big) {
      bit = 1;
      range -= split;
      value -= big;
    } else {
      bit = 0;
      range = split;
    }
    while (range < 128) {
      value <<= 1;
      range <<= 1;
      ++shifts;
      if (++bit_count == 8) {
        bit_count = 0;
        value |= uint32_t(next());
      }
    }
    return bit;
  }
  int literal(int n) {
    int v = 0;
    while (n-- > 0) v = (v << 1) | get(128);
    return v;
  }
  int signed_literal(int n) {
    const int v = literal(n);
    return get(128) ? -v : v;
  }
};

struct QuantMatrix {
  int y1[2], y2[2], uv[2];
};

struct FilterInfo {
  uint8_t limit = 0, ilevel = 0, inner = 0, hev = 0;
};

struct MacroBlock {
  uint8_t segment = 0, skip = 0, is_i4x4 = 0, uvmode = 0;
  uint8_t imodes[16] = {};
};

inline uint8_t clip8(int v) {
  return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v);
}

// --- inverse transforms (14.3, 14.4) ----------------------------------------
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

constexpr int BPS = 32;  // stride of the work area

void transform_add(const int16_t* in, uint8_t* dst) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {  // vertical pass, column i
    const int a = in[i] + in[8 + i];
    const int b = in[i] - in[8 + i];
    const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
    const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
    tmp[4 * i + 0] = a + d;
    tmp[4 * i + 1] = b + c;
    tmp[4 * i + 2] = b - c;
    tmp[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; ++i) {  // horizontal pass, row i
    const int dc = tmp[i] + 4;
    const int a = dc + tmp[8 + i];
    const int b = dc - tmp[8 + i];
    const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
    const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
    uint8_t* row = dst + i * BPS;
    row[0] = clip8(row[0] + ((a + d) >> 3));
    row[1] = clip8(row[1] + ((b + c) >> 3));
    row[2] = clip8(row[2] + ((b - c) >> 3));
    row[3] = clip8(row[3] + ((a - d) >> 3));
  }
}

void inverse_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
    out += 64;
  }
}

// --- intra prediction (12.2, 12.3) into the work area -----------------------
inline uint8_t avg3(int a, int b, int c) {
  return uint8_t((a + 2 * b + c + 2) >> 2);
}
inline uint8_t avg2(int a, int b) { return uint8_t((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  for (int y = 0; y < size; ++y, dst += BPS)
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - top[-1]);
}

void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, v, size);
}

// 16x16 luma and 8x8 chroma: DC (with the edge variants), TM, V, H
void predict_block(uint8_t* dst, int size, int mode, bool has_top,
                   bool has_left) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case DC_PRED: {
      int dc = 0;
      if (has_top && has_left) {
        for (int i = 0; i < size; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
        fill(dst, size, (dc + size) >> (shift + 1));
      } else if (has_left) {
        for (int i = 0; i < size; ++i) dc += dst[-1 + i * BPS];
        fill(dst, size, (dc + size / 2) >> shift);
      } else if (has_top) {
        for (int i = 0; i < size; ++i) dc += dst[i - BPS];
        fill(dst, size, (dc + size / 2) >> shift);
      } else {
        fill(dst, size, 0x80);
      }
      break;
    }
    case TM_PRED: true_motion(dst, size); break;
    case V_PRED:
      for (int y = 0; y < size; ++y) std::memcpy(dst + y * BPS, dst - BPS, size);
      break;
    case H_PRED:
      for (int y = 0; y < size; ++y)
        std::memset(dst + y * BPS, dst[y * BPS - 1], size);
      break;
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]
void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
            L = dst[-1 + 3 * BPS], X = top[-1];
  const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4],
            F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      fill(dst, 4, dc >> 3);
      break;
    }
    case B_TM: true_motion(dst, 4); break;
    case B_VE: {
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D),
                            avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, v, 4);
      break;
    }
    case B_HE:
      std::memset(dst, avg3(X, I, J), 4);
      std::memset(dst + BPS, avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    case B_HU:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) =
          uint8_t(L);
      break;
  }
}
#undef DST

// --- the loop filters (15.2-15.4) -------------------------------------------
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// `hstride` across the edge, `vstride` along it
void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) filter2(p, hstride);
}

void normal_edge(uint8_t* p, int hstride, int vstride, int size, int thresh,
                 int ithresh, int hev_thresh, bool mb_edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_thresh))
      filter2(p, hstride);
    else if (mb_edge)
      filter6(p, hstride);
    else
      filter4(p, hstride);
  }
}

// --- the frame ----------------------------------------------------------------
struct Decoder {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolDecoder br;
  BoolDecoder parts[8];
  int num_parts = 1;
  // segment header
  bool use_segment = false, update_map = false, absolute_delta = false;
  int seg_quant[4] = {}, seg_filter[4] = {};
  uint8_t seg_proba[3] = {255, 255, 255};
  // filter header
  int filter_simple = 0, filter_level = 0, sharpness = 0, filter_type = 0;
  bool use_lf_delta = false;
  int ref_lf_delta[4] = {}, mode_lf_delta[4] = {};
  QuantMatrix dqm[4];
  uint8_t proba[4][8][3][11];
  bool use_skip_proba = false;
  int skip_p = 0;
  FilterInfo fstrengths[4][2];

  void parse_headers(const uint8_t* data, size_t n);
  void parse_quant();
  void parse_intra_mode(MacroBlock* mb, uint8_t* top, uint8_t* left);
  int get_coeffs(BoolDecoder& tb, int type, int ctx, const int* dq, int n,
                 int16_t* out);
  void precompute_filter_strengths();
};

void Decoder::parse_headers(const uint8_t* data, size_t n) {
  if (n < 10) throw ImageError("truncated VP8 frame header");
  const uint32_t bits = data[0] | data[1] << 8 | data[2] << 16;
  const bool key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const bool show = (bits >> 4) & 1;
  const uint32_t part0 = bits >> 5;
  if (!key_frame) throw ImageError("VP8 frame is not a key frame");
  if (profile > 3) throw ImageError("VP8 profile above 3");
  if (!show) throw ImageError("VP8 frame is not shown");
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a)
    throw ImageError("bad VP8 start code");
  width = (data[6] | data[7] << 8) & 0x3fff;
  height = (data[8] | data[9] << 8) & 0x3fff;
  if (width < 1 || height < 1) throw ImageError("VP8 frame of empty size");
  check_pixels(uint64_t(width), uint64_t(height), "VP8 frame");
  mb_w = (width + 15) >> 4;
  mb_h = (height + 15) >> 4;
  data += 10;
  n -= 10;
  if (part0 > n) throw ImageError("bad VP8 partition length");
  br.init(data, part0);
  br.get(128);  // colour space
  br.get(128);  // clamping type
  use_segment = br.get(128);
  if (use_segment) {
    update_map = br.get(128);
    if (br.get(128)) {  // update the segment data
      absolute_delta = br.get(128);
      for (int s = 0; s < 4; ++s)
        seg_quant[s] = br.get(128) ? br.signed_literal(7) : 0;
      for (int s = 0; s < 4; ++s)
        seg_filter[s] = br.get(128) ? br.signed_literal(6) : 0;
    }
    if (update_map)
      for (int s = 0; s < 3; ++s)
        seg_proba[s] = uint8_t(br.get(128) ? br.literal(8) : 255);
  }
  filter_simple = br.get(128);
  filter_level = br.literal(6);
  sharpness = br.literal(3);
  use_lf_delta = br.get(128);
  if (use_lf_delta && br.get(128)) {
    for (int i = 0; i < 4; ++i)
      if (br.get(128)) ref_lf_delta[i] = br.signed_literal(6);
    for (int i = 0; i < 4; ++i)
      if (br.get(128)) mode_lf_delta[i] = br.signed_literal(6);
  }
  filter_type = filter_level == 0 ? 0 : filter_simple ? 1 : 2;
  // the token partitions
  const uint8_t* buf = data + part0;
  size_t left = n - part0;
  num_parts = 1 << br.literal(2);
  const size_t last = size_t(num_parts - 1);
  if (left < 3 * last) throw ImageError("truncated VP8 partitions");
  const uint8_t* sz = buf;
  const uint8_t* start = buf + 3 * last;
  left -= 3 * last;
  for (size_t p = 0; p < last; ++p, sz += 3) {
    size_t psize = sz[0] | sz[1] << 8 | sz[2] << 16;
    psize = std::min(psize, left);
    parts[p].init(start, psize);
    start += psize;
    left -= psize;
  }
  if (left == 0) throw ImageError("truncated VP8 partitions");
  parts[last].init(start, left);
  parse_quant();
  br.get(128);  // refresh the entropy probabilities: ignored (one frame)
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          proba[t][b][c][p] = uint8_t(br.get(kCoeffsUpdateProba[t][b][c][p])
                                          ? br.literal(8)
                                          : kCoeffsProba0[t][b][c][p]);
  use_skip_proba = br.get(128);
  if (use_skip_proba) skip_p = br.literal(8);
  if (br.eof) throw ImageError("truncated VP8 frame header");
}

void Decoder::parse_quant() {
  const int base_q0 = br.literal(7);
  const int dqy1_dc = br.get(128) ? br.signed_literal(4) : 0;
  const int dqy2_dc = br.get(128) ? br.signed_literal(4) : 0;
  const int dqy2_ac = br.get(128) ? br.signed_literal(4) : 0;
  const int dquv_dc = br.get(128) ? br.signed_literal(4) : 0;
  const int dquv_ac = br.get(128) ? br.signed_literal(4) : 0;
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  for (int s = 0; s < 4; ++s) {
    int q;
    if (use_segment) {
      q = seg_quant[s] + (absolute_delta ? 0 : base_q0);
    } else if (s > 0) {
      dqm[s] = dqm[0];
      continue;
    } else {
      q = base_q0;
    }
    QuantMatrix& m = dqm[s];
    m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip(q, 127)];
    m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    // x * 155 / 100 for every x of the table
    m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
  }
}

void Decoder::parse_intra_mode(MacroBlock* mb, uint8_t* top, uint8_t* left) {
  if (update_map)
    mb->segment = uint8_t(!br.get(seg_proba[0]) ? br.get(seg_proba[1])
                                                : br.get(seg_proba[2]) + 2);
  else
    mb->segment = 0;
  if (use_skip_proba) mb->skip = uint8_t(br.get(skip_p));
  mb->is_i4x4 = !br.get(145);
  if (!mb->is_i4x4) {
    const int ymode = br.get(156) ? (br.get(128) ? TM_PRED : H_PRED)
                                  : (br.get(163) ? V_PRED : DC_PRED);
    mb->imodes[0] = uint8_t(ymode);
    std::memset(top, ymode, 4);
    std::memset(left, ymode, 4);
  } else {
    uint8_t* modes = mb->imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* prob = kBModesProba[top[x]][ymode];
        ymode = !br.get(prob[0])   ? B_DC
                : !br.get(prob[1]) ? B_TM
                : !br.get(prob[2]) ? B_VE
                : !br.get(prob[3])
                    ? (!br.get(prob[4]) ? B_HE
                                        : (!br.get(prob[5]) ? B_RD : B_VR))
                    : (!br.get(prob[6])
                           ? B_LD
                           : (!br.get(prob[7])
                                  ? B_VL
                                  : (!br.get(prob[8]) ? B_HD : B_HU)));
        top[x] = uint8_t(ymode);
      }
      std::memcpy(modes, top, 4);
      modes += 4;
      left[y] = uint8_t(ymode);
    }
  }
  mb->uvmode = uint8_t(!br.get(142)   ? DC_PRED
                       : !br.get(114) ? V_PRED
                       : br.get(183)  ? TM_PRED
                                      : H_PRED);
}

int large_value(BoolDecoder& b, const uint8_t* p) {
  int v;
  if (!b.get(p[3])) {
    v = !b.get(p[4]) ? 2 : 3 + b.get(p[5]);
  } else if (!b.get(p[6])) {
    if (!b.get(p[7])) {
      v = 5 + b.get(159);
    } else {
      v = 7 + 2 * b.get(165);
      v += b.get(145);
    }
  } else {
    const int bit1 = b.get(p[8]);
    const int bit0 = b.get(p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab)
      v += v + b.get(*tab);
    v += 3 + (8 << cat);
  }
  return v;
}

// The tokens of one block from position n (13.2-13.3); returns the
// position after the last one read (n when the block is empty).
int Decoder::get_coeffs(BoolDecoder& tb, int type, int ctx, const int* dq,
                        int n, int16_t* out) {
  const uint8_t* p = proba[type][kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!tb.get(p[0])) return n;  // end of block
    while (!tb.get(p[1])) {       // a zero
      p = proba[type][kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    if (!tb.get(p[2])) {
      v = 1;
      p = proba[type][kBands[n + 1]][1];
    } else {
      v = large_value(tb, p);
      p = proba[type][kBands[n + 1]][2];
    }
    const int s = tb.get(128) ? -v : v;
    out[kZigzag[n]] = int16_t(s * dq[n > 0]);
  }
  return 16;
}

void Decoder::precompute_filter_strengths() {
  if (filter_type == 0) return;
  for (int s = 0; s < 4; ++s) {
    int base = filter_level;
    if (use_segment) {
      base = seg_filter[s];
      if (!absolute_delta) base += filter_level;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FilterInfo& info = fstrengths[s][i4x4];
      int level = base;
      if (use_lf_delta) {
        level += ref_lf_delta[0];
        if (i4x4) level += mode_lf_delta[0];
      }
      level = level < 0 ? 0 : level > 63 ? 63 : level;
      if (level > 0) {
        int ilevel = level;
        if (sharpness > 0) {
          ilevel >>= sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = uint8_t(ilevel);
        info.limit = uint8_t(2 * level + ilevel);
        info.hev = uint8_t(level >= 40 ? 2 : level >= 15 ? 1 : 0);
      } else {
        info.limit = 0;
      }
      info.inner = uint8_t(i4x4);
    }
  }
}

// Work-area offsets: a border row above and a border column left of each
// plane, four pixels of the row above-right for the luma's 4x4 modes.
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;

}  // namespace

void vp8_frame_size(const uint8_t* data, size_t n, int* w, int* h) {
  if (n < 10 || data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a)
    throw ImageError("bad VP8 frame header");
  *w = (data[6] | data[7] << 8) & 0x3fff;
  *h = (data[8] | data[9] << 8) & 0x3fff;
}

void vp8_decode(const uint8_t* data, size_t n, Yuv420* out) {
  Decoder dec;
  dec.parse_headers(data, n);
  dec.precompute_filter_strengths();
  const int mb_w = dec.mb_w, mb_h = dec.mb_h;
  out->width = dec.width;
  out->height = dec.height;
  out->y_stride = mb_w * 16;
  out->uv_stride = mb_w * 8;
  // the planes grow a row of macroblocks at a time, so that a header that
  // claims more than its data holds allocates only what the data makes
  out->y.clear();
  out->u.clear();
  out->v.clear();

  std::vector<uint8_t> intra_t(size_t(4) * mb_w, B_DC);
  uint8_t intra_l[4];
  // non-zero flags: per column above and for the left neighbour, the
  // 4 luma, 2 + 2 chroma columns (rows) of blocks and the Y2 block
  struct Nz {
    uint8_t y[4], u[2], v[2], dc;
  };
  std::vector<Nz> nz_top(size_t(mb_w), Nz{});
  std::vector<FilterInfo> finfo(size_t(mb_w) * mb_h);
  // unfiltered samples above each macroblock: 16 luma, 8 + 8 chroma
  std::vector<uint8_t> top_y(size_t(mb_w) * 16), top_u(size_t(mb_w) * 8),
      top_v(size_t(mb_w) * 8);
  uint8_t work[YUV_SIZE];
  uint8_t* const ydst = work + Y_OFF;
  uint8_t* const udst = work + U_OFF;
  uint8_t* const vdst = work + V_OFF;
  alignas(16) int16_t coeffs[384];
  std::memset(work, 0, sizeof work);

  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    BoolDecoder& tb = dec.parts[mb_y & (dec.num_parts - 1)];
    std::memset(intra_l, B_DC, 4);
    Nz nz_left{};
    // the left border, and the top-left sample
    for (int j = 0; j < 16; ++j) ydst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) udst[j * BPS - 1] = vdst[j * BPS - 1] = 129;
    if (mb_y > 0) {
      ydst[-1 - BPS] = udst[-1 - BPS] = vdst[-1 - BPS] = 129;
    } else {
      std::memset(ydst - BPS - 1, 127, 16 + 4 + 1);
      std::memset(udst - BPS - 1, 127, 8 + 1);
      std::memset(vdst - BPS - 1, 127, 8 + 1);
    }
    out->y.resize(size_t(out->y_stride) * (mb_y + 1) * 16);
    out->u.resize(size_t(out->uv_stride) * (mb_y + 1) * 8);
    out->v.resize(size_t(out->uv_stride) * (mb_y + 1) * 8);
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MacroBlock mb;
      dec.parse_intra_mode(&mb, &intra_t[size_t(4) * mb_x], intra_l);
      if (dec.br.eof) throw ImageError("truncated VP8 first partition");
      // -- residuals
      Nz& top = nz_top[size_t(mb_x)];
      const QuantMatrix& q = dec.dqm[mb.segment];
      std::memset(coeffs, 0, sizeof coeffs);
      bool skip = dec.use_skip_proba && mb.skip;
      if (!skip) {
        bool any = false;
        int first;
        int type_y;
        if (!mb.is_i4x4) {
          int16_t dc[16] = {};
          const int ctx = top.dc + nz_left.dc;
          const int nz = dec.get_coeffs(tb, 1, ctx, q.y2, 0, dc);
          top.dc = nz_left.dc = nz > 0;
          inverse_wht(dc, coeffs);
          first = 1;
          type_y = 0;
        } else {
          first = 0;
          type_y = 3;
        }
        for (int y = 0; y < 4; ++y) {
          int l = nz_left.y[y];
          for (int x = 0; x < 4; ++x) {
            const int ctx = l + top.y[x];
            const int nz = dec.get_coeffs(tb, type_y, ctx, q.y1, first,
                                          coeffs + 16 * (4 * y + x));
            l = nz > first;
            top.y[x] = uint8_t(l);
            any |= nz > 1 || coeffs[16 * (4 * y + x)] != 0;
          }
          nz_left.y[y] = uint8_t(l);
        }
        for (int ch = 0; ch < 2; ++ch) {
          uint8_t* tnz = ch ? top.v : top.u;
          uint8_t* lnz = ch ? nz_left.v : nz_left.u;
          for (int y = 0; y < 2; ++y) {
            int l = lnz[y];
            for (int x = 0; x < 2; ++x) {
              const int ctx = l + tnz[x];
              int16_t* blk = coeffs + 16 * (16 + 4 * ch + 2 * y + x);
              const int nz = dec.get_coeffs(tb, 2, ctx, q.uv, 0, blk);
              l = nz > 0;
              tnz[x] = uint8_t(l);
              any |= nz > 1 || blk[0] != 0;
            }
            lnz[y] = uint8_t(l);
          }
        }
        skip = !any;
        if (tb.eof) throw ImageError("truncated VP8 token partition");
      } else {
        std::memset(top.y, 0, 4);
        std::memset(top.u, 0, 2);
        std::memset(top.v, 0, 2);
        std::memset(nz_left.y, 0, 4);
        std::memset(nz_left.u, 0, 2);
        std::memset(nz_left.v, 0, 2);
        if (!mb.is_i4x4) top.dc = nz_left.dc = 0;
      }
      if (dec.filter_type > 0) {
        FilterInfo f = dec.fstrengths[mb.segment][mb.is_i4x4];
        f.inner |= !skip;
        finfo[size_t(mb_y) * mb_w + mb_x] = f;
      }
      // -- reconstruction in the work area
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j)
          std::memcpy(ydst + j * BPS - 4, ydst + j * BPS + 12, 4);
        for (int j = -1; j < 8; ++j) {
          std::memcpy(udst + j * BPS - 4, udst + j * BPS + 4, 4);
          std::memcpy(vdst + j * BPS - 4, vdst + j * BPS + 4, 4);
        }
      }
      if (mb_y > 0) {
        std::memcpy(ydst - BPS, &top_y[size_t(16) * mb_x], 16);
        std::memcpy(udst - BPS, &top_u[size_t(8) * mb_x], 8);
        std::memcpy(vdst - BPS, &top_v[size_t(8) * mb_x], 8);
      }
      if (mb.is_i4x4) {
        uint8_t* top_right = ydst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w - 1)
            std::memset(top_right, top_y[size_t(16) * mb_x + 15], 4);
          else
            std::memcpy(top_right, &top_y[size_t(16) * (mb_x + 1)], 4);
        }
        for (int r = 1; r < 4; ++r)
          std::memcpy(top_right + 4 * r * BPS, top_right, 4);
        for (int k = 0; k < 16; ++k) {
          uint8_t* dst = ydst + (k & 3) * 4 + (k >> 2) * 4 * BPS;
          predict4(dst, mb.imodes[k]);
          transform_add(coeffs + 16 * k, dst);
        }
      } else {
        predict_block(ydst, 16, mb.imodes[0], mb_y > 0, mb_x > 0);
        for (int k = 0; k < 16; ++k)
          transform_add(coeffs + 16 * k,
                        ydst + (k & 3) * 4 + (k >> 2) * 4 * BPS);
      }
      predict_block(udst, 8, mb.uvmode, mb_y > 0, mb_x > 0);
      predict_block(vdst, 8, mb.uvmode, mb_y > 0, mb_x > 0);
      for (int k = 0; k < 4; ++k) {
        const int off = (k & 1) * 4 + (k >> 1) * 4 * BPS;
        transform_add(coeffs + 16 * (16 + k), udst + off);
        transform_add(coeffs + 16 * (20 + k), vdst + off);
      }
      if (mb_y < mb_h - 1) {
        std::memcpy(&top_y[size_t(16) * mb_x], ydst + 15 * BPS, 16);
        std::memcpy(&top_u[size_t(8) * mb_x], udst + 7 * BPS, 8);
        std::memcpy(&top_v[size_t(8) * mb_x], vdst + 7 * BPS, 8);
      }
      for (int j = 0; j < 16; ++j)
        std::memcpy(&out->y[size_t(mb_y * 16 + j) * out->y_stride + mb_x * 16],
                    ydst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        const size_t o = size_t(mb_y * 8 + j) * out->uv_stride + mb_x * 8;
        std::memcpy(&out->u[o], udst + j * BPS, 8);
        std::memcpy(&out->v[o], vdst + j * BPS, 8);
      }
    }
  }

  // -- the loop filter, macroblock by macroblock in raster order
  if (dec.filter_type == 0) return;
  const int ys = out->y_stride, uvs = out->uv_stride;
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const FilterInfo& f = finfo[size_t(mb_y) * mb_w + mb_x];
      const int limit = f.limit;
      if (limit == 0) continue;
      uint8_t* y = &out->y[size_t(mb_y * 16) * ys + mb_x * 16];
      if (dec.filter_type == 1) {
        if (mb_x > 0) simple_edge(y, 1, ys, limit + 4);
        if (f.inner)
          for (int k = 1; k < 4; ++k) simple_edge(y + 4 * k, 1, ys, limit);
        if (mb_y > 0) simple_edge(y, ys, 1, limit + 4);
        if (f.inner)
          for (int k = 1; k < 4; ++k)
            simple_edge(y + 4 * k * ys, ys, 1, limit);
        continue;
      }
      uint8_t* u = &out->u[size_t(mb_y * 8) * uvs + mb_x * 8];
      uint8_t* v = &out->v[size_t(mb_y * 8) * uvs + mb_x * 8];
      const int il = f.ilevel, ht = f.hev;
      if (mb_x > 0) {
        normal_edge(y, 1, ys, 16, limit + 4, il, ht, true);
        normal_edge(u, 1, uvs, 8, limit + 4, il, ht, true);
        normal_edge(v, 1, uvs, 8, limit + 4, il, ht, true);
      }
      if (f.inner) {
        for (int k = 1; k < 4; ++k)
          normal_edge(y + 4 * k, 1, ys, 16, limit, il, ht, false);
        normal_edge(u + 4, 1, uvs, 8, limit, il, ht, false);
        normal_edge(v + 4, 1, uvs, 8, limit, il, ht, false);
      }
      if (mb_y > 0) {
        normal_edge(y, ys, 1, 16, limit + 4, il, ht, true);
        normal_edge(u, uvs, 1, 8, limit + 4, il, ht, true);
        normal_edge(v, uvs, 1, 8, limit + 4, il, ht, true);
      }
      if (f.inner) {
        for (int k = 1; k < 4; ++k)
          normal_edge(y + 4 * k * ys, ys, 1, 16, limit, il, ht, false);
        normal_edge(u + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
        normal_edge(v + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
      }
    }
  }
}

// --- Y'CbCr 4:2:0 to RGBA as libwebp's output (its yuv.h and its fancy
// upsampler, upsampling.c) -----------------------------------------------------
namespace {

inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip(int v) {  // 6 fractional bits
  return uint8_t((v & ~16383) == 0 ? (v >> 6) : v < 0 ? 0 : 255);
}
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgba) {
  rgba[0] = yuv_clip(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgba[1] = yuv_clip(mult_hi(y, 19077) - mult_hi(u, 6419) -
                     mult_hi(v, 13320) + 8708);
  rgba[2] = yuv_clip(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// One pair of output rows: `top_y` (with chroma rows top_u/v above and
// cur_u/v below it) and `bottom_y` (or none); u and v are packed in one
// word as the reference does, each sum in its own 16 bits.
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y,
                   const uint8_t* top_u, const uint8_t* top_v,
                   const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  auto load = [](int u, int v) { return uint32_t(u) | uint32_t(v) << 16; };
  const int last_pair = (len - 1) >> 1;
  uint32_t tl_uv = load(top_u[0], top_v[0]);
  uint32_t l_uv = load(cur_u[0], cur_v[0]);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    yuv_to_rgb(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
  }
  if (bottom_y) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    yuv_to_rgb(bottom_y[0], uv0 & 0xff, uv0 >> 16, bottom_dst);
  }
  for (int x = 1; x <= last_pair; ++x) {
    const uint32_t t_uv = load(top_u[x], top_v[x]);
    const uint32_t uv = load(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1;
      const uint32_t uv1 = (diag_03 + t_uv) >> 1;
      yuv_to_rgb(top_y[2 * x - 1], uv0 & 0xff, uv0 >> 16,
                 top_dst + (2 * x - 1) * 4);
      yuv_to_rgb(top_y[2 * x], uv1 & 0xff, uv1 >> 16, top_dst + 2 * x * 4);
    }
    if (bottom_y) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1;
      const uint32_t uv1 = (diag_12 + uv) >> 1;
      yuv_to_rgb(bottom_y[2 * x - 1], uv0 & 0xff, uv0 >> 16,
                 bottom_dst + (2 * x - 1) * 4);
      yuv_to_rgb(bottom_y[2 * x], uv1 & 0xff, uv1 >> 16,
                 bottom_dst + 2 * x * 4);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      yuv_to_rgb(top_y[len - 1], uv0 & 0xff, uv0 >> 16,
                 top_dst + (len - 1) * 4);
    }
    if (bottom_y) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      yuv_to_rgb(bottom_y[len - 1], uv0 & 0xff, uv0 >> 16,
                 bottom_dst + (len - 1) * 4);
    }
  }
}

}  // namespace

void yuv420_to_rgba(const Yuv420& in, uint8_t* rgba, size_t stride) {
  const int w = in.width, h = in.height;
  const uint8_t* y = in.y.data();
  const uint8_t* u = in.u.data();
  const uint8_t* v = in.v.data();
  const int ys = in.y_stride, uvs = in.uv_stride;
  // the first row against its own chroma row, then pairs of rows between
  // two chroma rows, then the last row of an even height alone
  upsample_pair(y, nullptr, u, v, u, v, rgba, nullptr, w);
  int row = 1;
  for (; row + 1 < h; row += 2) {
    const int c = (row + 1) / 2;
    upsample_pair(y + size_t(row) * ys, y + size_t(row + 1) * ys,
                  u + size_t(c - 1) * uvs, v + size_t(c - 1) * uvs,
                  u + size_t(c) * uvs, v + size_t(c) * uvs,
                  rgba + size_t(row) * stride, rgba + size_t(row + 1) * stride,
                  w);
  }
  if (row < h) {
    const int c = (row - 1) / 2;
    upsample_pair(y + size_t(row) * ys, nullptr, u + size_t(c) * uvs,
                  v + size_t(c) * uvs, u + size_t(c) * uvs,
                  v + size_t(c) * uvs, rgba + size_t(row) * stride, nullptr, w);
  }
}

}  // namespace uvcimg
